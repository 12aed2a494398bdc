"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (H100).

    python3 chip_smoke.py
    python3 chip_smoke.py --nccl-ranks N     # a host of N >= 2 cards

The second form runs only phase 1, the build and phase 18's collectives
on NCCL, one rank a card: (a) and (d) with N ranks against one process,
and (b) with ``--nproc_per_node=N`` (batch 2N).

Phases (any failure raises and the script exits non-zero, printing no
result line):

Phases 4-9 pin the decoder at fine resolution (``fused_s2d=False``,
``fused_s2d_decoder=False``), so that their numbers stay comparable with
the earlier runs; phase 10 drives the s2d decoder, the entry points'
default, whose 3x3 convs launch the s2d conv on the card unless
``DBSR_FINE_PATCH_S2D=0`` (phases 10-15 count its launches: 8 per forward
of an s2d network, 16 per step). Phases 1-13 run float32: where an entry
point would take the banked checkpoints' recorded bf16 (``load_predictor``,
the eval entries, ``default_realworld``) or its bf16 default
(``default_synthetic``) they ask for float32 (``dtype=None``,
``compute_dtype="float32"``, or a float32 copy of the checkpoint,
``float32_copy``); phases 14 and 15 drive the bf16 defaults.

1. environment: torch / CUDA versions, the card's name and power limit;
   the predictor's forward runs its convs and matmuls with TF32 off
   (float32), which the script checks by leaving PyTorch's defaults on;
2. build the ten CUDA kernels (eight sources) from
   ``dbsr_tpu_torch/kernels/csrc`` (one ``nvcc`` per source, all started
   together);
3. each forward kernel against its plain PyTorch version on the card,
   float32, at the shapes the serving forward gives it (B=8, N=14) and at
   those the train step gives it (B=16, N=8), inputs from a fixed seed;
   times of the kernel, the plain version and, where there is one, a
   PyTorch library call as a yardstick (``F.grid_sample`` for the warp; for
   the s2d conv the structured-dense ``F.conv2d`` on the s2d tensor, and
   the fine-resolution ``F.conv2d`` on the unfolded tensor, which the
   kernel's device time is held against), by CUDA events around one call
   (``ms``: what a caller pays, the host's dispatch included), median of
   several runs after warm-up, and, for the wrapper and the yardsticks
   alike, the device time of all the call's device activity from
   ``torch.profiler`` (``device_ms``; the wrapper's kernels alone are
   ``kernel_device_ms``, the cost volume's also by level); the s2d conv
   also in its d_input orientation and against the fine-resolution conv,
   and its ``Function``'s backward against autograd of the plain version;
   then PWC-Net's forward shapes at r3d's serving batch (104 frames): the
   cost volume at its five levels ([104, s, s, C] for s = 1, 2, 4, 8, 16
   and C = 196, 128, 96, 64, 32; the 1x1 and 2x2 planes in the kernel's
   whole-plane tile, nearly every tap out of range) and the warp at its
   four backwarps (levels 5..2, the effective flow ``flow * S/(S-1)``),
   the whole ``backwarp`` (kernel and mask) also against the CPU's, timed
   and bounded as the rest (``pwc_shapes`` of each entry, with their sums
   ``pwc_*``); then the s2d conv, forward and d_input, at C in {3, 5, 33}
   and O in {1, 7, 70} on an odd plane, the affine resample at an odd
   width with C in {1, 4} (bit-identical to its plain version), and the
   cost volume on a ragged plane with C in {1, 3, 5, 33, 196}; then the
   warp at C % 4 != 0 (its 4-byte path): C in {1, 2, 3, 5} beside 24 on a
   ragged 13x22 plane, and C = 3 at SCA's shapes ([1, 640, 640, 3] and
   [1, 80, 80, 3] in BurstSR scoring, [12, 448, 448, 3] and
   [12, 56, 56, 3] in fine-tuning), each bit-identical to its plain
   version, SCA's shapes timed and bounded (``sca_shapes`` of the warp's
   entry, ``any_c`` the ragged rows);
4. serving: ``load_predictor`` on the banked flagship checkpoint (full
   width, batch 8, 14 frames, 48x48 -> 384x384) answers three requests
   (8 bursts, 3 bursts, one burst) with the launch counters reset just
   before and read just after; each kernel must have launched exactly as
   often as its call sites in three forwards ask;
5. the card's forward (kernels) against the CPU forward (plain versions) on
   one burst with the same parameters;
6. the training path's kernels against their plain versions on the card,
   float32, at the shapes the train step gives them (B=16, N=8): the
   affine resample (fused and strict synthesis), the warp's d_feat and
   d_flow (flows up to +-5 px, some on exact integers; also AlignLite's
   backwarp shapes), the cost volume's d_first and d_second (AlignLite's
   three levels, their device time also by level, and an odd shape; each
   called twice, bit-identical required; untimed, a ragged 13x22 plane at
   C in {1, 3, 5, 33, 196} and two shapes whose blocks take several
   channel chunks; then the ``Function`` on the card) and
   the merge backward, each also against ``torch.autograd.grad`` of the
   plain forward (the resample bit-identical to its plain version);
   d_feat called twice must give the same bits, with flows of +-5 px and
   with a pile-up of every source onto one 3x3 patch (also against the
   plain version, its time recorded), and a flow with every tap out of
   range must give zeros; d_feat also at C=12 on a ragged plane and on a
   96x96 plane (its CSR built outside shared memory), at C in {1, 2, 3, 5}
   beside 24 on the ragged plane and at C = 3 at the fine-tuning step's
   [12, 448, 448, 3] (each twice, bit-identical required, against plain and
   autograd; the latter timed: ``sca_shapes`` and ``any_c``); d_flow
   called twice must give the same bits, at the train step's shapes and at
   every lane width of its dispatch (``DFLOW_CHANNELS`` on 3 frames of
   13x21, a frame with every tap out of range giving zeros, in float32
   here and in bf16 beside 15a: ``lane_widths``); times
   as in phase 3 (the yardsticks ``F.grid_sample`` and its autograd: for
   d_feat with respect to the input alone, for d_flow with respect to
   both); the host's microseconds per call of the resample and of
   ``F.grid_sample`` at the fused shape, over a tight loop of calls; then
   PWC-Net's backward shapes at its pretraining batch (112 frames):
   d_first and d_second at the five levels, d_feat and d_flow at the four
   backwarps (each twice, the same bits), against plain and autograd,
   timed beside the same yardsticks (``pwc_shapes``);
7. training with the banked aligner, frozen: (a) one train step of the
   banked flagship at B=1, N=8 on the card against the same step on the
   CPU (loss and every gradient; as in 9 and 10c, on the first batch seed
   whose flow offsets the two sides do not wrap on the two sides of a whole
   pixel, the merge's floor-mod being a jump of the model); (b) ``run_training("dbsr",
   "default_synthetic", ...)`` for one epoch of 10 steps at B=16 (20 before
   the pretraining phases were added), then again for a second epoch,
   resumed from the first, with the launch counters reset just before each
   run and read just after: each kernel must have launched exactly as
   often per train step as the step asks; (c) 20 Adam steps on one fixed
   batch from a fresh network with the grafted aligner (the loss must
   fall), timed by CUDA events, with peak memory; (d) a ``torch.profiler``
   trace of three train steps, device time by group; (e) determinism: one
   step's loss and gradients twice on the card from the same parameters
   and batch, at B=1 and B=16, and cuDNN's conv backward alone twice (an
   encoder-like conv, and the conv of the differing gradient nearest the
   loss at its shape in the step), logged, not required;
8. pretraining the aligner: (a) one ``BurstAlignLite`` train step at B=16,
   N=8 on the card against the same step on the CPU from the same fresh
   parameters and batch (loss, all gradients, and each extractor tensor's
   gradient on its own: a gradient that stopped at the cost volumes would
   show there); (b) ``run_training("align_lite", "pretrain_synthetic",
   ...)`` for two epochs of 750 steps with a resume (the
   net leaves the zero-flow plateau after ~750 steps), the exact launches per
   step, ``Stat/epe`` falling and ending below the zero-flow EPE of the
   same batches; (c) step time, peak memory and a profile as in 7c-7d;
9. closing the loop: in the workspace of 8b, ``run_training("dbsr",
   "default_synthetic", ...)`` without ``pwc_checkpoint`` finds and grafts
   that checkpoint and takes 5 steps frozen, then 5 with
   ``train_alignment=True`` (exact launches per step; ``warp_dflow`` and
   the cost volume's backward now run inside DBSR's step); one unfrozen
   step's gradients against the CPU's at B=1; the unfrozen step's time and
   peak memory at B=16;
10. the s2d decoder: (a) ``load_predictor`` with its defaults answers the
    three requests of phase 4 with ``DBSR_FINE_PATCH_S2D=1`` (exactly 8
    ``conv_s2d`` launches per forward) and without it (the structured-dense
    conv, none), and the fine decoder again, each form's bursts/s and peak
    memory; (b) the card's forward with the kernel against the CPU's; (c)
    one ``default_synthetic`` step with ``fused_s2d_decoder=True`` and the
    switch at B=1 on the card against the CPU; (d) ``run_training`` for
    one epoch of 5 steps with the switch (8 + 8 ``conv_s2d`` launches per
    step on top of phase 7's); (e) the B=16 step's time and peak memory with
    the kernel and with the dense conv (the fine form's is 7c's); the
    switch set to 1 or 0 in each part;
11. the SyntheticBurstVal protocol: (a) ``python -m
    dbsr_tpu_torch.generate_synthetic_burst_val --procedural 150
    --num_bursts 300 --seed 20260817`` (its ``main``, in this process: the
    model zoo's val set, exactly one strict ``resample`` launch per burst),
    wall time; (b) ``compute_score`` of the flagship and of r4mix over the
    300 bursts at batch 8, MS-SSIM on, no LPIPS, the launch counters reset
    just before each and read just after (38 forwards: warp and correlation
    114, merge 38, the s2d conv 304, nothing else), scores logged beside the JAX package's
    bf16 ones of the same epochs (another val set: context, not a limit),
    ms per burst by part (the forward and the scoring by CUDA events, the
    reader thread, the wait on it, the transfer, the fetch) and peak
    memory; (c) the flagship's per-burst scores of the first 2 bursts on
    the card against the CPU's (5e-3 dB, 5e-5); (d) ``save_results``, then
    the saved predictions scored, equal to (b)'s within 1e-6; (e)
    ``run_evaluation synburst compute_score dbsr_default --no_lpips
    --max_bursts 16 --json`` (its ``main``) on phase 7b's workspace, the
    latest epoch and ``--all_epochs``, equal to the API's within 1e-6; (f)
    (b)'s flagship run with ``DBSR_FINE_PATCH_S2D=0`` (the structured-dense
    conv, no ``conv_s2d`` launch), scores within (c)'s limits. r3d, the
    zoo's PWC-Net model, is scored in (b) too (warp and correlation 190,
    merge 38, the s2d conv 304)
    and held card against CPU in (c);
12. PWC-Net: (b) ``load_predictor`` on r3d (PWC-Net, its own s2d decoder,
    full width) answers the three requests of phase 4 (warp 5, correlation
    5, merge 1 per forward), bursts/s and peak memory, its forward against
    the CPU's (1e-3); (c) the banked ``BurstFlowNet``
    (``pwcnet_synth_params.ckpt``) on the card against the CPU, flows within
    1e-3 px; (d) one PWC-Net pretraining step at B=16, N=8 on the card
    against the CPU from the same fresh parameters and batch (as 8a),
    ``run_training("pwcnet", "pretrain_synthetic", ...)`` for two epochs of
    50 steps with a resume (exact launches per step: resample 1, warp 4,
    correlation 5, d_first 5, d_second 5, d_feat 4, d_flow 4; finite
    losses; ``Stat/epe`` is not asked to fall: a fresh PWC-Net stays on the
    zero-flow plateau for thousands of steps), and 20 Adam steps on one
    fixed batch (the loss must fall), step time, peak memory, profile;
    (e) ``default_synthetic`` in (d)'s workspace, the ``pwcnet_synth``
    checkpoint found, grafted and frozen, 5 steps, and in a fresh one with
    no checkpoint, the fallback (PWC-Net trained end to end), 5 steps,
    exact launches per step for each, and each one's B=16 step time and
    peak memory; one unfrozen r3d step at B=1 against the CPU's;
13. the real-world path: (a) ``python -m
    dbsr_tpu_torch.data.make_synthetic_burstsr`` (its ``generate_dataset``,
    on the card) writes BurstSR-format val and train trees, 3 bursts each,
    14 frames of 96^2 packed RAW, ground truth 768^2, with the planted
    translation, colour transform and exposure; (b) SCA with the banked
    AlignLite, coarse to fine, on a perfect prediction of the first val
    burst: it must recover the misregistration under the JAX package's
    limits (aligned MSE < 0.3 x raw, valid > 0.5) and agree with the CPU
    (exact launches: warp 7, correlation 6); (c) ``compute_score`` of the
    flagship and r3d over the val tree (80-px crops, 640^2 ground truth,
    boundary 40) with exact launches per burst (warp 10, correlation 9,
    merge 1; r3d 11, 10, 1), ms per burst by part (forward, SCA, metrics,
    reader) and peak memory, the first 2 bursts' scores card vs CPU (5e-3
    dB, 5e-5); (d)
    ``save_results`` of the flagship, every PNG equal to the live
    quantised prediction; (e) ``run_training("dbsr", "default_realworld")``
    from the banked flagship placed as ``default_synthetic``'s checkpoint:
    one epoch of 5 steps at B=12, N=8, 56-px crops, then a resumed second
    (exact launches per step: warp 10, correlation 9, merge 1, d_feat 2,
    merge backward 1), the epoch-0 checkpoint equal to the flagship; one
    step at B=1 card vs CPU (loss, gradients; a batch whose offsets wrap
    on one side only, or whose SCA masks differ, is left for the next
    seed); the B=12 step's time, peak memory and profile.

14. bf16, the JAX package's serving and scoring dtype (the banked
    checkpoints record it): (a, run beside phase 3) the four kernels on
    bf16's path (warp,
    cost volume, merge, s2d conv) against their plain bf16 versions at the
    serving forward's shapes (AlignLite's, PWC-Net's 1x1-16x16 planes, the
    decoder's 8 x 192^2 x 128): at least 99.9% of the outputs bit-equal,
    none more than one bf16 ulp away (at the output's magnitude, floored at
    2^-8 of its terms': the same op on the inputs' absolute values), the
    same bits on a second call; timed and bounded at bf16 bytes, beside
    ``F.grid_sample`` and the structured-dense ``F.conv2d`` in bf16;
    (b) ``load_predictor`` with its bf16 default at batch 8: the flagship in
    its three decoder forms and r3d, three requests with exact launches
    (warp 3, correlation 3, merge 1; r3d 5, 5, 1; the s2d conv 8 with the
    switch), bursts/s, forward ms, peak memory, the card's forward against
    the CPU's bf16 one (relative L2 within 2e-2) and no farther from the
    card's float32 one than twice the CPU's bf16 forward is; every conv
    layer of the card's bf16 forward against the same layer on the CPU
    from the card's own input to it (bf16 out, at least 99% of the outputs
    bit-equal), and each stage (aligner, encoder, merge, decoder) likewise,
    beside the CPU's bf16-vs-float32 distance there (recorded); (c)
    ``compute_score`` of the zoo's three models at their recorded bf16 on
    phase 11's 300 bursts (exact launches, dB, SSIM, MS-SSIM, ms a burst)
    beside phase 11's float32 scores and the JAX package's bf16 ones, the
    first 2 bursts card vs CPU (0.05 dB, 5e-4), ``run_evaluation synburst
    compute_score dbsr_zoo --max_bursts 16 --json`` equal to the API
    within 1e-6; the flagship's BurstSR scoring at bf16 on phase 13's tree
    and ``run_evaluation burstsr compute_score dbsr_zoo --json`` (its
    ``main``, bf16) equal to the API within 1e-6.

15. bf16 training, the JAX package's default compute dtype: (a, run
    beside phase 3) the six bf16 backward kernels (d_feat, d_flow, the
    merge's, d_first, d_second, the s2d conv's d_input) against their plain
    bf16 versions at the train step's shapes (B=16, N=8: the encoder's
    warp, AlignLite's backwarps and cost volumes, the merge, one of the
    decoder's convs), at PWC-Net's and at an odd C: at least 99.9% of the
    outputs bit-equal and none more than one bf16 ulp off (d_flow, float32
    out: within 1e-5 of its terms' magnitude), the same bits twice; timed
    and bounded at bf16 bytes beside autograd of the bf16
    ``F.grid_sample``, autograd of the bf16 plain merge and
    ``torch.nn.grad.conv2d_input`` on the structured-dense bf16 kernel;
    (b) ``run_training("dbsr", "default_synthetic", ...)`` with its
    defaults (bf16, the s2d decoder and its kernel) at B=16 for one epoch
    of 5 steps with the banked AlignLite frozen, the banked PWC-Net
    frozen, and the fallback (a fresh PWC-Net trained end to end), exact
    launches per step (the s2d weight gradient kernel's 8 among them),
    each one's step time, busy share and peak memory; the AlignLite step
    timed again with ``cudnn.deterministic=True``, and run twice from one
    state and batch: how many gradients still differ; one bf16 step of the flagship at B=1 card vs CPU (loss within 2e-2, the
    card's bf16 gradients no farther from its float32 ones than twice the
    CPU's), every module's output gradient card vs CPU in float32 and
    bf16, the first to depart named; (c) ``default_realworld`` from (b)'s
    bf16 checkpoint: restored in bf16 (exact launches, its checkpoint
    records bf16), its B=12 step time, one step card vs CPU as in (b);
    (d, run beside phase 3) the s2d decoder's weight gradient kernel
    (``conv3x3_s2d_dweight``, bf16 operands, float32 out) at the training
    launch [16, 192, 192, 128] (signed and non-negative x) and at odd
    shapes: the same bits twice, its error against a float64 reference
    no larger than cuDNN's float32 weight gradient on the unfolded tensors
    (the float32 route) at the training launch, and within 1e-5 of the
    largest entry of the float64 reference and of the plain version
    everywhere; timed beside its bound, the plain version,
    ``conv2d_weight`` on the unfolded float32 tensors and the whole
    float32 route; ``Conv3x3S2D`` routing bf16 to it (one launch a
    backward, bit-equal) and float32 to cuDNN (none). Its launches are
    counted on every path, as every kernel's. (e, run beside phase 3) the
    dead-leaves composite (``dead_leaves_composite``, float32) at a chunk
    of the training pool [32, 432, 432] with 300 leaves and at odd shapes
    (H, W not multiples of its 16x16 tile; L = 1, 5, 300): its plain
    version's bits (compared as int32) and the same bits twice; timed at
    the chunk beside its bound (38 float32 operations a pixel a leaf, none
    fused, at half the FMA rate) and the plain version; a
    ``ProceduralImagePool`` round of 128 at 432^2: one launch a chunk of
    32, the uint8 pool of the same round rendered through the plain
    version, both rounds' wall time. Its launches are counted on every
    path, as every kernel's: none on a step or while serving; on each
    window that renders a procedural pool on the card (the training
    entries' epochs, 17's epochs, 18a's ranks, 11's val set), one a chunk
    of 32 dead-leaves images of each round (``check_counts``' renders).

16. training data beyond dead leaves: (d, run beside phase 3) the
    resample kernel through ``warp_affine`` at [8, 432, 432, 3] with
    rotation, shear and scale, bit-equal to its plain version, exactly one
    launch; (a) each generator of the mixed corpus (dead leaves, edges,
    gratings, noise, gradients) on the card against the CPU from the same
    draws (float image within 1e-5, uint8 >= 99.9% equal and <= 1 LSB
    apart), ms per image, and a ``mix='mixed'`` pool of 128 at 432^2 in two
    chunks of 64; (b) ``run_training dbsr default_synthetic --set
    mix=mixed`` (bf16, B=16, AlignLite frozen, pool 128, 5 steps), exact
    launches (15b's), its step's time, peak memory and busy share; (c) the
    host-fed path: a ``Trainer`` on ``CropBatcher`` over 16 PNGs of 512^2
    (``ImageFolder``, png16) with the prefetcher's pinned ``device_put``,
    the first batch on the card bit-equal to the CPU's, a timed epoch of 5
    steps (exact launches; ms per step, the worker's ms per batch, the wait
    on the queue); (e) ``run_training dbsr smoke_tiny`` (2 epochs, exact
    launches, checkpoints); (f) ``generate_synthetic_burst_val
    --source_dir`` on the PNG folder, 3 bursts read back; (g) 15c's
    ``default_realworld`` trainer timed through the prefetcher; and whether
    the machine has ``g++``, ``jpeglib.h`` and libjpeg (nothing decoded).

17. the serving daemon and the trainer's service layer: (a)
    ``make_server(load_predictor(flagship, batch_size=8))`` (bf16, the s2d
    conv kernel) on loopback, ``serve_forever`` on a thread: 64 bursts of
    a fixed seed posted from 8 client threads (a quarter as uint16 at
    2^14), each response within 1e-3 of a direct ``Predictor`` call on the
    same burst (the bit-equal share reported), the launches exactly 14b's
    per device call; a wrong shape and a body that is not ``.npy`` get
    400, unknown routes 404, a device call made to fail 503 for every
    request of its batch, the daemon serving on after it; ``/healthz``'s
    keys, ``/stats``'s counts exactly those sent, mean occupancy above 1;
    request ms (p50, p95), bursts/s through HTTP beside the direct
    forward's (14b's measurement, in this call); then the same bursts from
    a client process of their own at linger 5 and 20 ms and with
    TCP_NODELAY (bursts/s, occupancies; what sets the gap); (b) ``python -m
    dbsr_tpu_torch.run_serving --checkpoint <flagship> --port <free>`` as
    a subprocess: its "compiled" and "serving on" lines, one request
    (against (a)'s direct prediction) and ``/healthz``, then SIGINT and a
    clean exit; (c) ``run_training dbsr default_synthetic`` (bf16,
    AlignLite frozen, 15b's pool and batch, 5 steps) for one epoch, a
    params-only artifact of its checkpoint (``save_params_artifact``) in a
    fresh workspace, the trainer resumed from it: parameters bit-equal,
    Adam's moments zero and its count 0, ``step`` 5, then 10 after a
    timed second epoch (exact launches), the last update's rate the
    schedule's at its step, ``..._ep0002.ckpt`` written; (d) the same
    trainer with the asynchronous checkpoint writer for two epochs, each
    save also written synchronously elsewhere at the same moment, epoch
    1's write held until epoch 2 has stepped: the files byte-equal, the ms
    the epoch loop paid at each save both ways, the snapshot's bytes and
    ms; (e) with ``DBSR_TPU_TRACE_DIR`` set, a third epoch of (c)'s
    workspace at 10 steps: the Chrome trace of steps 5-9 names the port's
    kernels (at least five steps' launches of each); whether
    ``tensorboard`` imports, and what ``TensorboardWriter`` wrote.

18. data parallelism, multi-device serving, frame sharding, the PNG
    loaders: (a) two ranks on ``cuda:0`` over gloo (NCCL refuses two ranks
    on one card), spawned, each holding 8 rows of the node's B=16: one
    float32 ``default_synthetic`` step (the banked AlignLite frozen, the
    s2d decoder) against the same step in this process (loss within 1e-5
    relative, the all-reduced gradients within 1e-3 of their norm), five
    bf16 steps (losses within 2e-2, both ranks' parameters bit-equal after
    them, each rank's launches 15b's per step), ms a step a rank (two
    processes sharing one card: not a speed claim); (b) ``DBSR_TPU_DIST=1
    python -m torch.distributed.run --standalone --nproc_per_node=1 -m
    dbsr_tpu_torch.run_training dbsr smoke_tiny``: exit 0, the group on
    ``nccl``, rank 0's checkpoints of both epochs; (c)
    ``load_predictor(flagship, devices=["cuda:0", "cuda:0"])``, bf16,
    batch 8: within relative L2 2e-2 of one device, twice 14b's launches
    a call; (d) on (a)'s ranks, the flagship's forward with its 14 frames
    sharded over the two (``dbsr_apply_frame_sharded``), float32, against
    the dense forward (1e-3); (e) the native IO library built here (or
    why not), the path ``read_png`` takes, ``load_burst`` of 14 png16
    frames bit-equal to png16 and ms a burst by each path, BurstSR's
    reader ms a burst through ``read_png`` and through png16.

19. the last slice (LPIPS, visualize, the reference-checkpoint converter,
    ``load_trained_network``, ``ConvFlow``): (a) LPIPS with seeded random
    weights (an ``.npz``, as ``tests/test_torch_port_lpips.py`` makes them)
    on the flagship's bf16 predictions of 8 of phase 11's bursts against
    their ground truths at boundary 40, card against CPU on the same
    inputs (1e-4 relative), in one pass over the 8 (``reduce=False``), ms
    a burst; (b) ``synburst.compute_score`` of
    the flagship at its recorded bf16 with ``lpips_weights`` on 16 bursts
    of phase 11's set: exact launches, PSNR and SSIM against the same call
    without LPIPS within phase 11's limits, ms a burst by
    part (forward, metrics, LPIPS); the LPIPS mean of 2 bursts against a
    CPU ``compute_score`` of the same predictions (``save_results`` on the
    card, scored from the PNGs on the CPU; 1e-4 relative); (c) ``python -m
    dbsr_tpu_torch.run_evaluation synburst visualize dbsr_default`` (its
    ``main``) on 3 bursts, the workspace holding the banked flagship: four
    PNGs a burst and ``index.html``, exact launches, each prediction pane
    equal to a batch-1 ``load_predictor`` output through ``_postprocess``
    (>= 99.9% of pixels equal, none more than 1 LSB off), each panel's PSNR
    within 0.01 dB of ``compute_score``'s per-burst value at batch 1; (d)
    ``burstsr visualize`` on 2 bursts of phase 13's tree, exact launches,
    the aligned PSNRs within 0.01 dB of ``burstsr.compute_score``'s per
    burst; (e) ``convert_dbsr_state_dict`` of a seeded r3d-shaped reference
    state dict (``reference_state_dict`` of a seeded r3d network): its
    tensors, and its forward on the card, bit-equal to the same weights'
    through ``params_from_flax``; (f) a
    full-width ``flow_net='conv'`` DBSRNet's forward card vs CPU (1e-3),
    then three bf16 steps of ``default_synthetic`` with ``flow_net=conv``
    and no flow checkpoint (ConvFlow trained end to end) at B=16: finite
    losses, exact launches, ms a step; (g) ``load_trained_network`` on
    phase 7b's workspace: the path ``resolve_checkpoint`` gives and a
    forward bit-equal to ``load_network``'s.

The second-to-last line is ``{"kernels": [...]}`` (all twelve kernels;
``launches`` is the count on the entry's own ``path``, whose shapes its
times are summed over, except the s2d conv's, whose times are one launch's
and whose path launches it 8 times per forward, and the s2d weight
gradient's, bf16 alone, whose times are one launch's at the training shape
and whose path ``train_step_bf16`` launches it 8 times a step, and the
dead-leaves composite's, whose times are one launch's at a chunk of the
pool and whose path ``pool_round_128`` is 15e's round of 128 images;
``launches_by_path`` has
the counts on all forty paths (``eval``: phase 11's generation and
flagship scoring; ``eval_r3d``, ``serving_r3d_3_requests`` and the
``pwc_*_step`` paths: PWC-Net's; ``burstsr_eval`` and
``burstsr_eval_r3d``: phase 13c's scoring of 3 bursts; ``realworld_step``:
per ``default_realworld`` step; the ``*_bf16*`` paths: phase 14's
serving and scoring and phase 15's training steps; phase 16's:
``mixed_step_bf16``, ``host_fed_step_bf16``, ``smoke_tiny_step``,
``realworld_step_bf16_prefetched`` per step, ``val_source_dir`` its 3
bursts, ``warp_affine`` one call, whose row is the resample's last
``other_shapes`` entry; phase 17's: ``serving_daemon_bf16`` over its 64
posted bursts, ``resume_params_only_step_bf16`` and
``async_ckpt_step_bf16`` per step; phase 18's: ``dp_step_bf16_rank`` per
step of one rank, ``serving_2_replicas_bf16`` one call of two replicas,
``frame_sharded_forward_rank`` one rank's forward; phase 19's:
``eval_lpips_bf16`` its 16 bursts, ``visualize_synburst_bf16`` its 3,
``visualize_burstsr_bf16`` its 2, ``conv_flow_step_bf16`` per step;
``pool_round_128``: 15e's pool round; a path's count per step leaves out
the pool renders of its window, which are checked apart);
``device_ms``, ``kernel_device_ms`` and ``library_device_ms`` beside
``ms`` and ``library_ms``; the s2d conv's ``bound_ms`` is that of its own
math, 3xTF32 on the tensor cores, also given as ``tc_bound_ms``, and
``ffma_bound_ms`` is the same work's bound on the float32 FMA units;
``dtypes`` names the types the entry's checks covered, and the four with
a bf16 path carry its rows and sums under ``bf16``, with its launches on
``serving_bf16_3_requests``; the six with a bf16 backward under
``bf16_training``, with its launches on ``train_step_bf16`` or, where the
aligner trains, ``pwc_fallback_step_bf16``); the last line is ``{"ok": true, "device":
{...}}``.
"""

import contextlib
import dataclasses
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from collections import defaultdict

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
FP32_FLOPS_PER_S = 67e12    # H100 SXM float32 rate outside the tensor cores
# its rate of float32 operations that do not fuse into an FMA (an FMA
# counts two operations in FP32_FLOPS_PER_S)
FP32_OPS_PER_S = FP32_FLOPS_PER_S / 2
TF32_FLOPS_PER_S = 495e12   # H100 SXM TF32 tensor-core rate (dense)
BF16_FLOPS_PER_S = 989e12   # H100 SXM bf16 tensor-core rate (dense)
# the CUDA kernels each entry's wrapper launches, as the profiler names
# them (the bf16 merge and s2d conv are kernels of their own; the warp and
# the cost volume templates; warp_dfeat's call builds its CSR of the
# transposed taps, in one
# kernel or, for large planes, four, then gathers; its kernel_device_ms is
# them all summed; d_first and d_second are
# one template, correlation_bwd_kernel<T, kShifted, kVec>, told apart by a
# pattern on the profiler's name)
KERNEL_NAMES = {"warp": ("warp_kernel",),
                "correlation": ("correlation_kernel",),
                "merge": ("merge_kernel", "merge_bf16_kernel"),
                "resample": ("resample_kernel",),
                "warp_dfeat": ("dfeat_build_kernel", "csr_count_kernel",
                               "csr_scan_kernel", "csr_fill_kernel",
                               "csr_sort_kernel", "dfeat_gather_kernel",
                               "dfeat_gather_scalar_kernel"),
                "warp_dflow": ("dflow_kernel",),
                "merge_backward": ("merge_bwd_kernel", "merge_bwd_bf16_kernel"),
                "correlation_dfirst": ("correlation_bwd_kernel<[^,>]*, false",),
                "correlation_dsecond": ("correlation_bwd_kernel<[^,>]*, true",),
                "conv_s2d": ("conv_s2d_kernel", "conv_s2d_bf16_kernel"),
                "conv_s2d_dweight": ("s2d_dweight_kernel",
                                     "s2d_dweight_reduce_kernel"),
                "dead_leaves_composite": ("dead_leaves_composite_kernel",)}
CALL_GAP_S = 0.005  # idle time between the profiled calls of device_ms
HOST_CALLS = 200    # calls of the host-cost loop
B, N, HW = 8, 14, 48
# launches per forward of the fine decoder (or of the s2d decoder with
# DBSR_FINE_PATCH_S2D=0): warp serves the 512-channel feature warp and
# AlignLite's two backwarps; correlation runs at AlignLite's three levels
LAUNCHES_PER_FORWARD = {"warp": 3, "correlation": 3, "merge": 1}
# the s2d decoder's 4 post-shuffle ResBlocks x 2 convs: on the card they
# launch the s2d conv unless DBSR_FINE_PATCH_S2D=0 (the banked models, the
# entry points' default decoder)
LAUNCHES_S2D_PER_FORWARD = 8
LAUNCHES_PER_S2D_FORWARD = dict(LAUNCHES_PER_FORWARD,
                                conv_s2d=LAUNCHES_S2D_PER_FORWARD)
FRAMES = B * (N - 1)
KERNEL_RTOL, KERNEL_ATOL = 1e-5, 1e-6   # vs plain on the card: sum order only
# d_flow's channel counts: one for each (access width, lanes a pixel) its
# dispatch takes in either dtype (tests/test_torch_port_dflow_packed.py)
DFLOW_CHANNELS = (1, 2, 3, 4, 5, 8, 12, 13, 16, 20, 24, 32, 33, 36, 48, 96,
                  128, 196, 512)
CARD_VS_CPU_TOL = 1e-3                  # [0, 1] output, whole network

# training: default_synthetic's batch of 16 8-frame bursts, 48x48 packed
TRAIN_B, TRAIN_N = 16, 8
TRAIN_FRAMES = TRAIN_B * (TRAIN_N - 1)
# launches per train step: the forward's (resample for the synthesis), the
# warp's d_feat and the merge backward; d_flow never (the flow comes from
# the frozen aligner, without gradient); the dead-leaves composite never
# (it renders the pool, once a round: check_counts' renders)
LAUNCHES_PER_TRAIN_STEP = {"resample": 1, "warp": 3, "correlation": 3,
                           "merge": 1, "warp_dfeat": 1, "warp_dflow": 0,
                           "merge_backward": 1, "correlation_dfirst": 0,
                           "correlation_dsecond": 0, "conv_s2d": 0,
                           "conv_s2d_dweight": 0, "dead_leaves_composite": 0}
# launches per AlignLite pretraining step: the synthesis' resample; the three
# cost volumes with both gradients each (target and source features both
# train); the two backwarps with d_feat (the source features) and d_flow (the
# coarser level's flow); no merge
LAUNCHES_PER_PRETRAIN_STEP = {"resample": 1, "warp": 2, "correlation": 3,
                              "merge": 0, "warp_dfeat": 2, "warp_dflow": 2,
                              "merge_backward": 0, "correlation_dfirst": 3,
                              "correlation_dsecond": 3, "conv_s2d": 0,
                              "conv_s2d_dweight": 0,
                              "dead_leaves_composite": 0}
# launches per default_synthetic step with train_alignment=True: the frozen
# step's, and the backward now runs through the flow (the 512-channel warp's
# d_flow) and the aligner (its two backwarps and three cost volumes)
LAUNCHES_PER_UNFROZEN_STEP = {"resample": 1, "warp": 3, "correlation": 3,
                              "merge": 1, "warp_dfeat": 3, "warp_dflow": 3,
                              "merge_backward": 1, "correlation_dfirst": 3,
                              "correlation_dsecond": 3, "conv_s2d": 0,
                              "conv_s2d_dweight": 0,
                              "dead_leaves_composite": 0}
# launches per default_synthetic step with the s2d decoder and
# DBSR_FINE_PATCH_S2D=1: the frozen step's, and the decoder's 8 post-shuffle
# 3x3 convs launch the s2d conv in the forward and again as d_input (their
# float32 weight gradients are cuDNN's)
LAUNCHES_PER_S2D_STEP = dict(LAUNCHES_PER_TRAIN_STEP,
                             conv_s2d=2 * LAUNCHES_S2D_PER_FORWARD)
GRAD_TOL = 1e-3    # ||g_card - g_cpu||_2 <= GRAD_TOL ||g_cpu||_2, all grads
LOSS_RTOL = 1e-5   # card vs CPU loss of one train step
# the seeds of the B=1 batch of a train step's card-vs-CPU comparison, in
# order: the next is drawn only where the two sides' offsets fall on the two
# sides of a multiple of the merge's offset_modulo (grad_phase)
BATCH_SEEDS = (11, 12, 13)
# px: the most an offset that wraps on one side only may differ between the
# two sides, for its wrap to count as rounding rather than a fault
WRAP_DIFF_TOL = 1e-4
PRETRAIN_STEPS = 750  # per epoch of the smoke pretraining, two epochs
# run_training's cuts against default_synthetic (1000 steps x 100 epochs,
# a pool of 2048 sources; val every 5 epochs, so no val pass here)
SMOKE_SETTINGS = dict(steps_per_epoch=10, pool_size=128, print_interval=5,
                      fused_s2d_decoder=False, compute_dtype="float32")
# pretraining's cuts against align_lite/pretrain_synthetic (1000 steps x 15
# epochs, a pool of 2048 sources; val every 5 epochs, so no val pass here)
PRETRAIN_SETTINGS = dict(steps_per_epoch=PRETRAIN_STEPS, pool_size=128,
                         print_interval=150)
FINE_PATCH_ENV = "DBSR_FINE_PATCH_S2D"  # the fine-patch s2d conv's switch
# phase 11, the eval protocol: the model zoo's val set (README "Model zoo":
# 150 procedural sources, 300 bursts, the campaign seed), scored at batch 8
# with the protocol's boundary of 40 px
EVAL_PROCEDURAL, EVAL_BURSTS, EVAL_SEED = 150, 300, 20260817
EVAL_BATCH, EVAL_BOUNDARY = 8, 40
EVAL_CPU_BURSTS = 2      # bursts of the card-vs-CPU comparison (11c)
EVAL_CLI_BURSTS = 16     # bursts of each CLI run (11e, 14c)
EVAL_PSNR_TOL, EVAL_SSIM_TOL = 5e-3, 5e-5   # dB; SSIM and MS-SSIM
EVAL_SAVED_TOL = 1e-6    # saved vs live, CLI vs API: the same computation
R4MIX_CHECKPOINT = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "dbsr_tpu", "artifacts",
    "campaigns", "dbsr_campaign_r4mix_best_params.ckpt")
ALIGN_LITE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "dbsr_tpu", "artifacts", "align_lite_params.ckpt")
# PWC-Net: the banked model that runs it (epoch 100, s2d decoder) and the
# banked pretrained aligner (epoch 15)
R3D_CHECKPOINT = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "dbsr_tpu", "artifacts",
    "campaigns", "dbsr_campaign_r3d_best_params.ckpt")
PWC_SYNTH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "dbsr_tpu", "artifacts", "pwcnet_synth_params.ckpt")
# PWC-Net at 48x48 frames (resized to 64x64): pyramid levels 6..2 are 1x1,
# 2x2, 4x4, 8x8 and 16x16 planes of 196, 128, 96, 64 and 32 channels; the
# cost volume runs at all five, the backwarp at levels 5..2
PWC_LEVELS = ((1, 196), (2, 128), (4, 96), (8, 64), (16, 32))
# launches per forward of a PWC-Net DBSRNet (r3d, s2d decoder): the
# 512-channel warp and the four backwarps; the five cost volumes; the merge;
# the s2d conv
LAUNCHES_PER_PWC_FORWARD = {"warp": 5, "correlation": 5, "merge": 1,
                            "conv_s2d": LAUNCHES_S2D_PER_FORWARD}
# per PWC-Net pretraining step: the synthesis' resample; the five cost
# volumes with both gradients each; the four backwarps with d_feat (the
# second image's features) and d_flow (the up-convolved flow); no merge
LAUNCHES_PER_PWC_PRETRAIN_STEP = {"resample": 1, "warp": 4, "correlation": 5,
                                  "merge": 0, "warp_dfeat": 4, "warp_dflow": 4,
                                  "merge_backward": 0,
                                  "correlation_dfirst": 5,
                                  "correlation_dsecond": 5, "conv_s2d": 0,
                                  "conv_s2d_dweight": 0,
                                  "dead_leaves_composite": 0}
# per default_synthetic step with a frozen PWC-Net: the forward's, the
# 512-channel warp's d_feat and the merge backward
LAUNCHES_PER_PWC_FROZEN_STEP = dict(LAUNCHES_PER_TRAIN_STEP, warp=5,
                                    correlation=5)
# per step of default_synthetic's fallback (PWC-Net trained end to end):
# the frozen step's, and the backward through the 512-channel warp's flow
# and through the aligner (four backwarps, five cost volumes)
LAUNCHES_PER_PWC_UNFROZEN_STEP = dict(LAUNCHES_PER_PWC_FROZEN_STEP,
                                      warp_dfeat=5, warp_dflow=5,
                                      correlation_dfirst=5,
                                      correlation_dsecond=5)
PWC_FLOW_TOL = 1e-3  # px: BurstFlowNet's flows, card vs CPU
# PWC-Net pretraining's cuts against pwcnet/pretrain_synthetic (1000 steps x
# 15 epochs, a pool of 2048 sources; val every 5 epochs, so no val pass)
PWC_PRETRAIN_SETTINGS = dict(steps_per_epoch=50, pool_size=128,
                             print_interval=25)

# phase 13, the real-world path: BurstSR-format trees written by the port's
# generator (val and train, 3 bursts each, 14 frames of 96^2 packed RAW,
# ground truth 768^2), scored at the val protocol's 80-px crop (ground truth
# 640^2, boundary 40) and fine-tuned by default_realworld at its 56-px crops
# (ground truth 448^2), B=12, N=8
RW_BURSTS, RW_LR, RW_SEED = 3, 96, 20261017
RW_B, RW_N = 12, 8
RW_CPU_BURSTS = 2        # bursts of the card-vs-CPU scores (13c)
RW_STEPS = 5             # steps per epoch of the fine-tuning entry (13e)
# SCA with the banked AlignLite, coarse to fine: at 1/4 scale two backwarps
# and three cost volumes, the source's 3-channel backwarp, at full scale two
# and three again; then SCA's own two warps (the prediction, the base frame)
LAUNCHES_PER_SCA_LITE = {"warp": 7, "correlation": 6}
# with PWC-Net (r3d): its four backwarps and five cost volumes, SCA's two
LAUNCHES_PER_SCA_PWC = {"warp": 6, "correlation": 5}
# per scored BurstSR burst: the network's forward and SCA
LAUNCHES_PER_RW_LITE_BURST = {k: v + LAUNCHES_PER_SCA_LITE.get(k, 0)
                              for k, v in LAUNCHES_PER_S2D_FORWARD.items()}
LAUNCHES_PER_RW_PWC_BURST = {k: v + LAUNCHES_PER_SCA_PWC.get(k, 0)
                             for k, v in LAUNCHES_PER_PWC_FORWARD.items()}
# per default_realworld step of the flagship: a scored burst's forward and
# SCA, then d_feat of the encoder's warp and of SCA's warp of the
# prediction, the merge backward and the s2d conv's d_input; no synthesis,
# no d_flow
LAUNCHES_PER_RW_STEP = {**LAUNCHES_PER_TRAIN_STEP, "resample": 0,
                        **LAUNCHES_PER_RW_LITE_BURST, "warp_dfeat": 2,
                        "conv_s2d": 2 * LAUNCHES_S2D_PER_FORWARD}
RW_MASK_TOL = 1e-3       # share of pixels whose SCA mask may differ (13b)
# phase 14, bf16: a kernel against its plain bf16 version (the share of
# outputs bit-equal, the most bf16 ulps any other may be off); the card's
# bf16 forward against the CPU's (relative L2,
# util_scripts/tpu_parity_check.py's bf16 limit); bf16 scores per burst,
# card vs CPU (dB; SSIM and MS-SSIM: the limit of the port's bf16 against
# JAX's, tests/test_torch_port_bf16_scores.py)
BF16_BIT_EQUAL, BF16_MAX_ULPS = 0.999, 1.0
BF16_REL_L2 = 2e-2
# 14b, layer by layer: every conv layer of the bf16 forward run on the CPU
# from the card's own input to it, the share of its outputs bit-equal to
# the card's (the order of a float32 sum flips a rounding now and then:
# 99.89% the least measured; a conv that rounds at other points, as a bias
# added before the rounding does, under 90%: tests/test_torch_port_bf16.py);
# the stages, recorded
BF16_LAYER_BIT_EQUAL = 0.99
BF16_STAGES = ("encoder.alignment_net", "encoder.embed", "merging",
               "decoder")
BF16_PSNR_TOL, BF16_SSIM_TOL = 0.05, 5e-4
# phase 15, bf16 training: d_flow's bf16 kernel (float32 out, a sum over
# the channels) against its plain version, of the magnitude of its terms
# (tests/test_torch_port_bf16_backward.py); a bf16 step's loss card vs CPU
BF16_DFLOW_RTOL = 1e-5
BF16_STEP_LOSS_RTOL = 2e-2
BF16_STEPS = 5  # steps of each bf16 training entry run (15b)
# 15b, a module's output gradient card vs CPU past which it is named the
# first to depart (float32: the step's gradients sit 1e-4-2.4e-4 of their
# norm apart, phases 7a and 9; bf16: a flipped rounding cascades, 14b)
MODULE_DEPART = {"float32": 1e-4, "bfloat16": 1e-2}
# per bf16 default_synthetic step with its defaults: the s2d decoder, whose
# 8 3x3 convs launch the s2d conv on the card in the forward and as d_input,
# and the bf16 weight gradient kernel once each
LAUNCHES_PER_BF16_STEP = dict(LAUNCHES_PER_S2D_STEP,
                              conv_s2d_dweight=LAUNCHES_S2D_PER_FORWARD)
LAUNCHES_PER_BF16_PWC_FROZEN_STEP = dict(
    LAUNCHES_PER_PWC_FROZEN_STEP, conv_s2d=2 * LAUNCHES_S2D_PER_FORWARD,
    conv_s2d_dweight=LAUNCHES_S2D_PER_FORWARD)
LAUNCHES_PER_BF16_PWC_UNFROZEN_STEP = dict(
    LAUNCHES_PER_PWC_UNFROZEN_STEP, conv_s2d=2 * LAUNCHES_S2D_PER_FORWARD,
    conv_s2d_dweight=LAUNCHES_S2D_PER_FORWARD)
# per bf16 default_realworld step: the float32 one's and the weight
# gradient kernel of each of the decoder's 8 convs
LAUNCHES_PER_BF16_RW_STEP = dict(LAUNCHES_PER_RW_STEP,
                                 conv_s2d_dweight=LAUNCHES_S2D_PER_FORWARD)
# 15d, the s2d weight gradient: (B, H2, W2, C, O) of the decoder's training
# launch, then odd shapes (C, O % 8 != 0, more than 32, ragged strips, a
# one-pixel plane); its error against float64, and against the plain
# version, of the other's largest entry (sum order only)
DWEIGHT_TRAIN = (TRAIN_B, 192, 192, 32, 32)
DWEIGHT_ODD = ((2, 7, 11, 3, 5), (1, 5, 17, 5, 33), (2, 9, 13, 7, 7),
               (1, 6, 40, 33, 32), (3, 4, 16, 32, 32), (1, 1, 1, 32, 32),
               (2, 12, 24, 16, 48), (1, 3, 70, 64, 8))
DWEIGHT_RTOL = 1e-5
# 15e, the dead-leaves composite: (n, H, W, L) of a chunk of the training
# pool, then odd shapes (H, W not multiples of the 16x16 tile); a round of
# DEAD_LEAVES_POOL images; 38 float32 operations a pixel a leaf (2
# subtractions, 4 + 4 for the rotation, 5 for d, 4 for cover, 6 for shade,
# 1 for keep, 12 for the blend), none of which fuses into an FMA: its
# bound is at FP32_OPS_PER_S
DEAD_LEAVES_CHUNK = (32, 432, 432, 300)
DEAD_LEAVES_ODD = ((3, 13, 21, 1), (2, 37, 50, 5), (2, 19, 70, 300))
DEAD_LEAVES_POOL, DEAD_LEAVES_OPS = 128, 38
# a procedural pool renders its dead leaves in chunks of POOL_CHUNK images
# (ProceduralImagePool's), one launch of the composite a chunk, once a round
POOL_CHUNK = 32
# phase 16, the training data beyond dead leaves: a mixed pool of 128
# sources at 432^2 in two chunks of 64; each generator's card rendering of
# GEN_CHECK_N images against the CPU's from the same draws (float image
# within GEN_ATOL; uint8 at least GEN_U8_SHARE equal, at most 1 LSB off)
MIXED_POOL, MIXED_CHUNK, MIXED_SEED = 128, 64, 0
GEN_CHECK_N, GEN_ATOL, GEN_U8_SHARE = 2, 1e-5, 0.999
# the host-fed path: 16 PNGs of 512^2, B=16, five steps an epoch
HOST_PNGS, HOST_PNG_HW, HOST_STEPS = 16, 512, 5
WARP_AFFINE_SHAPE = (8, 432, 432, 3)
# per smoke_tiny step (float32, 2 epochs of 4 steps): the strict
# synthesis' resample; the tiny net's frozen PWC-Net (four backwarps, five
# cost volumes) and feature warp; the merge; d_feat and the merge backward;
# the fine decoder, no s2d conv
LAUNCHES_PER_SMOKE_TINY_STEP = LAUNCHES_PER_PWC_FROZEN_STEP
SMOKE_TINY_STEPS = 8
SOURCE_DIR_BURSTS = 3

# phase 19, the last slice: LPIPS card vs CPU (float32, TF32 off: sums in
# another order) on LPIPS_BURSTS flagship predictions; compute_score with
# LPIPS on LPIPS_EVAL_BURSTS bursts, its LPIPS mean against the CPU's on
# LPIPS_CPU_BURSTS; visualize on VIS_SYN_BURSTS and VIS_RW_BURSTS bursts, a
# pane against the predictor's output (the share of pixels equal, none more
# than 1 LSB off), a panel's two-decimal PSNR against the scoring's
LPIPS_RTOL = 1e-4
LPIPS_BURSTS, LPIPS_EVAL_BURSTS, LPIPS_CPU_BURSTS = 8, 16, 2
VIS_SYN_BURSTS, VIS_RW_BURSTS = 3, 2
VIS_EQUAL_SHARE, VIS_PSNR_DB = 0.999, 0.01
CONV_FLOW_STEPS = 3
# per bf16 default_synthetic step with flow_net='conv' and no flow
# checkpoint (ConvFlow, two convs, trained end to end): the synthesis'
# resample; the 512-channel feature warp (ConvFlow has no backwarp and no
# cost volume) with d_feat and d_flow; the merge and its backward; the s2d
# conv forward and as d_input, and its bf16 weight gradient
LAUNCHES_PER_CONV_FLOW_STEP = {"resample": 1, "warp": 1, "correlation": 0,
                               "merge": 1, "warp_dfeat": 1, "warp_dflow": 1,
                               "merge_backward": 1, "correlation_dfirst": 0,
                               "correlation_dsecond": 0,
                               "conv_s2d": 2 * LAUNCHES_S2D_PER_FORWARD,
                               "conv_s2d_dweight": LAUNCHES_S2D_PER_FORWARD,
                               "dead_leaves_composite": 0}


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, warmup=2, reps=10):
    """Median milliseconds of ``fn()`` on the card (CUDA events)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, kernels=None, reps=10):
    """Median device milliseconds of ``fn()`` from ``torch.profiler``'s CUDA
    activity: per call, the summed durations of all of it (kernels, memsets
    and copies: what the call costs the card); with ``kernels`` (names of
    kernels of the port, e.g. ``("resample_kernel",)``), also of the
    activity whose name holds one of them, summed. Returns ``(all, the
    kernels' or None)``. The calls, each
    followed by a synchronize and an idle gap, are told apart by that gap;
    a first step of calls that is traced and thrown away (the schedule's
    warm-up) takes CUPTI's start-up, and every one of the ``reps`` calls
    must then be seen."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
        prof.step()
        for _ in range(reps):
            time.sleep(CALL_GAP_S)
            fn()
            torch.cuda.synchronize()
        prof.step()
    pat = (re.compile(r"\b(" + "|".join(kernels) + r")\b") if kernels
           else None)
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)
                   and not e.name.startswith("ProfilerStep"))
    calls, last_end = [], None
    for start, end, name in spans:  # microseconds
        if last_end is None or start - last_end > CALL_GAP_S * 1e6 / 2:
            calls.append([0.0, 0.0])
        calls[-1][0] += end - start
        if pat is not None and pat.search(name):
            calls[-1][1] += end - start
        last_end = end if last_end is None else max(last_end, end)
    if len(calls) != reps or (pat is not None and not all(c[1] for c in calls)):
        raise AssertionError(
            f"device_ms({kernels}): {len(calls)} profiled calls of {reps}, "
            f"{sum(bool(c[1]) for c in calls)} with the kernel; (start us, "
            f"name) of the activity: {[(s, n) for s, _, n in spans]}")
    return (statistics.median(c[0] for c in calls) / 1e3,
            statistics.median(c[1] for c in calls) / 1e3 if pat else None)


def timings(name, kernel_fn, plain_fn, library_fn=None):
    """The times of one row: entry ``name``'s wrapper by CUDA events around
    one call (``ms``: what a caller pays, the host's dispatch included), by
    all the device activity of a call (``device_ms``: the kernels and the
    wrapper's other device work, such as a fill or a copy) and by its
    kernels' activity alone (``kernel_device_ms``, summed over the kernels
    of ``KERNEL_NAMES[name]``); the plain version by
    CUDA events; the library call, where there is one, by events and by all
    its device activity."""
    lib = library_fn is not None
    dev_ms, kernel_ms = device_ms(kernel_fn, KERNEL_NAMES[name])
    return dict(ms=cuda_ms(kernel_fn), device_ms=dev_ms,
                kernel_device_ms=kernel_ms,
                plain_ms=cuda_ms(plain_fn, 1, 3),
                library_ms=cuda_ms(library_fn) if lib else None,
                library_device_ms=device_ms(library_fn)[0] if lib else None)


def bound(nbytes, flops, flops_per_s=FP32_FLOPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_close(name, got, want):
    err = (got - want).abs().max().item()
    lim = KERNEL_RTOL * want.abs().max().item() + KERNEL_ATOL
    log(f"  {name}: max|kernel - plain| = {err:.3e} (limit {lim:.3e})")
    if not err <= lim:
        raise AssertionError(f"{name}: kernel disagrees with plain version: "
                             f"{err} > {lim}")
    return err


def check_exact(name, got, want):
    """``got`` must equal ``want`` bit for bit."""
    err = (got - want).abs().max().item()
    log(f"  {name}: max|kernel - plain| = {err:.3e} (bit-identical required)")
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: kernel not bit-identical to the plain "
                             f"version: {err}")
    return err


def host_us(fn, calls=HOST_CALLS):
    """Host microseconds per call of ``fn()``: ``calls`` calls in a tight
    loop after a synchronize, by ``time.perf_counter`` (the card keeps up,
    so the loop measures what the host spends to enqueue one call)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    per_call = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return per_call


def odd_shape_phase(dev, g):
    """Phase 3, the redesigned kernels off the main path's shapes: the s2d
    conv forward and d_input (the rotated weight) at C in {3, 5, 33} and O in
    {1, 7, 70} on an odd coarse plane (B=2, 13x22), against the plain
    version; the affine resample at an odd OW with C in {1, 4}, bit-equal to
    its plain version; the cost volume on a ragged plane (B=2, 13x22) at C
    in {1, 3, 5, 33, 196} (4-byte and 16-byte copies, a part-filled channel
    chunk, PWC-Net's widest level)."""
    from dbsr_tpu_torch.ops.conv_s2d import (conv3x3_s2d_forward,
                                             conv3x3_s2d_plain, rotate_weight)
    from dbsr_tpu_torch.ops.correlation import correlation_plain, cost_volume
    from dbsr_tpu_torch.ops.resample import (affine_resample,
                                             affine_resample_plain)
    from dbsr_tpu_torch.serving import float32_math

    rows = []
    for c in (1, 3, 5, 33, 196):
        a = torch.randn(2, 13, 22, c, generator=g, device=dev)
        b = torch.randn(2, 13, 22, c, generator=g, device=dev)
        err = check_close(f"correlation {list(a.shape)}", cost_volume(a, b),
                          correlation_plain(a, b))
        rows.append(dict(kernel="correlation", shape=list(a.shape),
                         max_abs_err=err))
    with float32_math():
        for c in (3, 5, 33):
            for o in (1, 7, 70):
                w0 = torch.randn(o, c, 3, 3, generator=g, device=dev) \
                    / math.sqrt(9 * c)
                for orient, w in (("forward", w0),
                                  ("d_input", rotate_weight(w0))):
                    x = torch.randn(2, 13, 22, 4 * w.shape[1], generator=g,
                                    device=dev)
                    err = check_close(
                        f"conv_s2d {orient} C={w.shape[1]} O={w.shape[0]} "
                        f"{list(x.shape)}", conv3x3_s2d_forward(x, w),
                        conv3x3_s2d_plain(x, w))
                    rows.append(dict(kernel="conv_s2d", orientation=orient,
                                     shape=list(x.shape), O=w.shape[0],
                                     max_abs_err=err))
    # rotations up to ~30 degrees and shifts of a few pixels: taps fall off
    # every border
    for c in (1, 4):
        images = torch.rand(2, 37, 41, c, generator=g, device=dev)
        a = (torch.rand(2, 3, generator=g, device=dev) - 0.5)
        t = (torch.rand(2, 3, 2, generator=g, device=dev) - 0.5) * 8
        invs = torch.stack([torch.stack([a.cos(), -a.sin(), t[..., 0]], -1),
                            torch.stack([a.sin(), a.cos(), t[..., 1]], -1)],
                           -2).contiguous()
        for out_hw, d, border in (((11, 23), 2, 1), ((37, 41), 1, 0)):
            args = (images, invs, out_hw, d, border)
            err = check_exact(f"resample C={c} {list(images.shape)} -> "
                              f"{list(out_hw)} d={d} border={border}",
                              affine_resample(*args),
                              affine_resample_plain(*args))
            rows.append(dict(kernel="resample", shape=list(images.shape),
                             out_hw=list(out_hw), d=d, max_abs_err=err))
    return rows


def _pwc_flow(g, dev, frames, s, amplitude=2.0):
    """A backwarp's flow at an ``s`` x ``s`` level: up to +-``amplitude``
    px, a seventh of the rows on exact pixel centres."""
    f = (torch.rand(frames, s, s, 2, generator=g, device=dev) * 2 - 1) \
        * amplitude
    f[:, ::7] = torch.round(f[:, ::7])
    return f.contiguous()


def pwc_forward_rows(dev, g, frames=FRAMES):
    """Phase 3, PWC-Net's forward shapes (r3d's serving forward, B=8, N=14):
    the cost volume at the five pyramid levels (1x1 and 2x2 planes take the
    kernel's whole-plane tile with 80 and 77 of 81 taps out of range), and
    the four backwarps (levels 5..2): the warp kernel at the backwarp's
    effective flow (``flow * S/(S-1)``, 2 at the 2x2 level) against its
    plain version, and the whole ``backwarp`` (kernel and mask) against the
    CPU's plain one, with the share of pixels its mask zeroes. Returns
    ``{entry name: rows}``, each row timed and bounded as in phase 3."""
    from dbsr_tpu_torch.ops.correlation import (NUM_OFFSETS,
                                                correlation_plain, cost_volume)
    from dbsr_tpu_torch.ops.interp import backwarp
    from dbsr_tpu_torch.ops.warp import base_grid, warp_feat, warp_feat_plain

    rows = {"correlation": [], "warp": []}
    for s, c in PWC_LEVELS:
        a = torch.randn(frames, s, s, c, generator=g, device=dev)
        b = torch.randn(frames, s, s, c, generator=g, device=dev)
        err = check_close(f"correlation {list(a.shape)} (PWC-Net)",
                          cost_volume(a, b), correlation_plain(a, b))
        bms, by = bound((2 * a.numel() + frames * s * s * NUM_OFFSETS) * 4,
                        2 * NUM_OFFSETS * a.numel())
        rows["correlation"].append(dict(
            shape=list(a.shape), max_abs_err=err, bound_ms=bms, bound_by=by,
            **timings("correlation", lambda: cost_volume(a, b),
                      lambda: correlation_plain(a, b))))
    for s, c in PWC_LEVELS[1:]:
        feat = torch.randn(frames, s, s, c, generator=g, device=dev)
        fl = _pwc_flow(g, dev, frames, s)
        got = backwarp(feat, fl)
        want = backwarp(feat.cpu(), fl.cpu())
        mask_err = check_close(f"backwarp {list(feat.shape)} vs the CPU's",
                               got.cpu(), want)
        zeroed = float((want == 0).all(-1).float().mean())
        eff = (fl * (s / (s - 1.0))).contiguous()
        err = check_close(f"warp {list(feat.shape)} (PWC-Net backwarp)",
                          warp_feat(feat, eff), warp_feat_plain(feat, eff))
        grid = _grid_sample_grid(base_grid(s, s, dev) + eff, s, s)
        nchw = feat.permute(0, 3, 1, 2)
        bms, by = bound((2 * feat.numel() + eff.numel()) * 4,
                        7 * feat.numel())
        log(f"  backwarp {list(feat.shape)}: the mask zeroes "
            f"{100 * zeroed:.1f}% of the pixels")
        rows["warp"].append(dict(
            shape=list(feat.shape), max_abs_err=max(err, mask_err),
            backwarp_zeroed_share=zeroed, bound_ms=bms, bound_by=by,
            **timings("warp", lambda: warp_feat(feat, eff),
                      lambda: warp_feat_plain(feat, eff),
                      lambda: F.grid_sample(nchw, grid, align_corners=False,
                                            padding_mode="zeros"))))
    return rows


def pwc_backward_rows(dev, g, frames=TRAIN_FRAMES):
    """Phase 6, PWC-Net's backward shapes (its pretraining and
    ``default_synthetic``'s fallback, B=16, N=8): d_first and d_second at
    the five levels, d_feat and d_flow at the four backwarps (d_feat's CSR
    has 4 entries a frame at level 5), each against its plain version and
    autograd of the plain forward, timed and bounded as in phase 6."""
    from dbsr_tpu_torch.ops.correlation import (NUM_OFFSETS,
                                                correlation_dfirst,
                                                correlation_dfirst_plain,
                                                correlation_dsecond,
                                                correlation_dsecond_plain,
                                                correlation_plain)
    from dbsr_tpu_torch.ops.warp import (base_grid, warp_dfeat,
                                         warp_dfeat_plain, warp_dflow,
                                         warp_dflow_plain, warp_feat_plain)

    rows = {k: [] for k in ("correlation_dfirst", "correlation_dsecond",
                            "warp_dfeat", "warp_dflow")}
    for s, c in PWC_LEVELS:
        first = torch.randn(frames, s, s, c, generator=g, device=dev)
        second = torch.randn(frames, s, s, c, generator=g, device=dev)
        gout = torch.randn(frames, s, s, NUM_OFFSETS, generator=g, device=dev)
        xs = (first.clone().requires_grad_(True),
              second.clone().requires_grad_(True))
        auto = torch.autograd.grad(correlation_plain(*xs), xs, gout)
        bms, by = bound((2 * first.numel() + gout.numel()) * 4,
                        2 * NUM_OFFSETS * first.numel())
        for name, fn, plain, operand, want_auto in (
                ("correlation_dfirst", correlation_dfirst,
                 correlation_dfirst_plain, second, auto[0]),
                ("correlation_dsecond", correlation_dsecond,
                 correlation_dsecond_plain, first, auto[1])):
            got = fn(operand, gout)
            errs = [check_close(f"{name} {list(first.shape)} (PWC-Net)", got,
                                plain(operand, gout)),
                    check_close(f"{name} {list(first.shape)} vs autograd",
                                got, want_auto)]
            rows[name].append(dict(
                shape=list(first.shape), max_abs_err=errs[0],
                err_vs_autograd=errs[1], bound_ms=bms, bound_by=by,
                **timings(name, lambda: fn(operand, gout),
                          lambda: plain(operand, gout))))
    for s, c in PWC_LEVELS[1:]:
        feat = torch.randn(frames, s, s, c, generator=g, device=dev)
        gout = torch.randn(frames, s, s, c, generator=g, device=dev)
        fl = (_pwc_flow(g, dev, frames, s) * (s / (s - 1.0))).contiguous()
        xs = (feat.clone().requires_grad_(True),
              fl.clone().requires_grad_(True))
        auto_df, auto_dfl = torch.autograd.grad(warp_feat_plain(*xs), xs,
                                                gout)
        # the yardsticks of phase 6: autograd through grid_sample, the
        # input's gradient for d_feat, both gradients for d_flow
        nchw = feat.permute(0, 3, 1, 2).detach().requires_grad_(True)
        grid = _grid_sample_grid(base_grid(s, s, dev) + fl, s, s)
        grid_req = grid.detach().requires_grad_(True)
        out_feat = F.grid_sample(nchw, grid, align_corners=False,
                                 padding_mode="zeros")
        out_both = F.grid_sample(nchw, grid_req, align_corners=False,
                                 padding_mode="zeros")
        g_nchw = gout.permute(0, 3, 1, 2)
        n, nf = feat.numel(), fl.numel()
        for name, fn, plain, lib, want_auto, nbytes, flops in (
                ("warp_dfeat", lambda: warp_dfeat(fl, gout),
                 lambda: warp_dfeat_plain(fl, gout),
                 lambda: torch.autograd.grad(out_feat, nchw, g_nchw,
                                             retain_graph=True),
                 auto_df, (2 * n + nf) * 4, 8 * n),
                ("warp_dflow", lambda: warp_dflow(feat, fl, gout),
                 lambda: warp_dflow_plain(feat, fl, gout),
                 lambda: torch.autograd.grad(out_both, (nchw, grid_req),
                                             g_nchw, retain_graph=True),
                 auto_dfl, (2 * n + 2 * nf) * 4, 20 * n)):
            got = check_repeat(f"{name} {list(feat.shape)} (PWC-Net)", fn)
            errs = [check_close(f"{name} {list(feat.shape)} (PWC-Net)", got,
                                plain()),
                    check_close(f"{name} {list(feat.shape)} vs autograd",
                                got, want_auto)]
            bms, by = bound(nbytes, flops)
            rows[name].append(dict(
                shape=list(feat.shape), max_abs_err=errs[0],
                err_vs_autograd=errs[1], bound_ms=bms, bound_by=by,
                **timings(name, fn, plain, lib)))
        del nchw, grid, grid_req, out_feat, out_both
    return rows


def add_pwc_rows(entries, rows, path):
    """Put PWC-Net's rows beside each entry's own: ``pwc_shapes`` and their
    sums (one pass of ``path``: a forward, or a step)."""
    for e in entries:
        r = rows.get(e["name"])
        if not r:
            continue
        e["pwc_path"] = path
        e["pwc_shapes"] = r
        for k in ("ms", "device_ms", "kernel_device_ms", "plain_ms",
                  "bound_ms"):
            e[f"pwc_{k}"] = sum(x[k] for x in r)
        e["max_abs_err"] = max(e["max_abs_err"],
                               max(x["max_abs_err"] for x in r))
        for x in r:
            log_row(f"{e['name']} (PWC-Net)", x)
        log(f"  {e['name']} at PWC-Net's shapes, summed over one pass of "
            f"{path}: device {e['pwc_device_ms']:.4f} ms, its kernels "
            f"{e['pwc_kernel_device_ms']:.4f}, bound {e['pwc_bound_ms']:.4f}")


def kernel_phase(dev, g):
    """Phase 3: the three forward kernels against their plain versions at the
    serving forward's shapes (B=8, N=14; the entry's rows, summed per
    forward) and at the train step's (B=16, N=8; listed apart)."""
    from dbsr_tpu_torch.ops.correlation import (NUM_OFFSETS,
                                                correlation_plain, cost_volume)
    from dbsr_tpu_torch.ops.merge import (fused_softmax_merge,
                                          fused_softmax_merge_plain)
    from dbsr_tpu_torch.ops.warp import base_grid, warp_feat, warp_feat_plain

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    def flow(frames, h, w):  # up to +-5 px: out-of-range taps at the borders
        f = (torch.rand(frames, h, w, 2, generator=g, device=dev) * 10 - 5)
        f[:, ::7] = torch.round(f[:, ::7])  # and taps on exact pixel centres
        return f.contiguous()

    def warp_rows(frames):
        # the 512-channel feature warp, then AlignLite's two backwarps
        rows = []
        for s in ((frames, HW, HW, 512), (frames, HW // 2, HW // 2, 48),
                  (frames, HW, HW, 24)):
            feat, fl = randn(*s), flow(*s[:3])
            err = check_close(f"warp {list(s)}", warp_feat(feat, fl),
                              warp_feat_plain(feat, fl))
            # yardstick: grid_sample with the grid equal to p + flow
            grid = _grid_sample_grid(base_grid(s[1], s[2], dev) + fl, s[1],
                                     s[2])
            nchw = feat.permute(0, 3, 1, 2)
            lib = F.grid_sample(nchw, grid, align_corners=False,
                                padding_mode="zeros").permute(0, 2, 3, 1)
            log(f"  warp {list(s)} grid_sample vs plain (info only): "
                f"{(lib - warp_feat_plain(feat, fl)).abs().max().item():.3e}")
            bms, by = bound((2 * feat.numel() + fl.numel()) * 4,
                            7 * feat.numel())
            rows.append(dict(
                shape=list(s), max_abs_err=err, bound_ms=bms, bound_by=by,
                **timings("warp", lambda: warp_feat(feat, fl),
                          lambda: warp_feat_plain(feat, fl),
                          lambda: F.grid_sample(nchw, grid,
                                                align_corners=False,
                                                padding_mode="zeros"))))
            del feat, fl, lib, grid, nchw
        return rows

    def correlation_rows(frames):
        # AlignLite's three levels
        rows = []
        for s in ((frames, HW // 4, HW // 4, 96),
                  (frames, HW // 2, HW // 2, 48), (frames, HW, HW, 24)):
            a, b = randn(*s), randn(*s)
            err = check_close(f"correlation {list(s)}", cost_volume(a, b),
                              correlation_plain(a, b))
            npix = s[0] * s[1] * s[2]
            bms, by = bound((2 * a.numel() + npix * NUM_OFFSETS) * 4,
                            2 * NUM_OFFSETS * a.numel())
            rows.append(dict(
                shape=list(s), max_abs_err=err, bound_ms=bms, bound_by=by,
                **timings("correlation", lambda: cost_volume(a, b),
                          lambda: correlation_plain(a, b))))
        return rows

    def merge_rows(b, n):
        s = (b, n, HW, HW, 512)
        feat, logits = randn(*s), randn(*s, scale=3.0)
        err = check_close(f"merge {list(s)}", fused_softmax_merge(feat, logits),
                          fused_softmax_merge_plain(feat, logits))
        bms, by = bound((2 * feat.numel() + feat.numel() // n) * 4,
                        6 * feat.numel())
        return [dict(
            shape=list(s), max_abs_err=err, bound_ms=bms, bound_by=by,
            **timings("merge", lambda: fused_softmax_merge(feat, logits),
                      lambda: fused_softmax_merge_plain(feat, logits)))]

    csrc = "dbsr_tpu_torch/kernels/csrc/"
    corr = _entry("correlation", csrc + "correlation.cu",
                  "dbsr_tpu/ops/correlation.py:90", correlation_rows(FRAMES),
                  correlation_rows(TRAIN_FRAMES))
    # AlignLite's three levels in one serving forward, each its own launch
    corr["device_ms_by_level"] = {
        f"{r['shape'][1]}x{r['shape'][2]}x{r['shape'][3]}": r["device_ms"]
        for r in corr["per_shape"]}
    log(f"  correlation device ms by level (serving): "
        f"{corr['device_ms_by_level']}, summed {corr['device_ms']:.4f}")
    return [
        _entry("warp", csrc + "warp.cu", "dbsr_tpu/ops/warp_pallas.py:125",
               warp_rows(FRAMES), warp_rows(TRAIN_FRAMES)),
        corr,
        _entry("merge", csrc + "merge.cu", "dbsr_tpu/ops/merge_pallas.py:84",
               merge_rows(B, N), merge_rows(TRAIN_B, TRAIN_N)),
        conv_s2d_entry(dev, g)]


def conv_s2d_entry(dev, g):
    """Phase 3, the s2d conv at the decoder's post-shuffle shape (x8: 48^2
    -> 384^2 fine, 192^2 coarse, C = O = 32): the forward at the serving
    batch (the entry's row) and at the train step's, and d_input at the
    train step's (the rotated weight), each against the plain version and
    against the fine-resolution conv of the unfolded input; then the
    ``Function``'s backward (dx by the kernel, dk by PyTorch's weight
    gradient) against ``torch.autograd.grad`` of the plain version. Times
    of one launch, TF32 off: the kernel, the plain version, the
    structured-dense ``F.conv2d`` on the s2d tensor with ``s2d_conv_kernel``
    weights (``library_ms``: the JAX package's default form, 4x the true
    work) and the fine-resolution ``F.conv2d`` on the unfolded tensor
    (``fine_conv_ms``, for context). The bound counts the true conv work,
    2*9*C*O operations per fine output pixel (the kernel skips the block
    weight's zero slots), three times over at the TF32 tensor-core rate
    (3xTF32: three TF32 products per multiply-add), and x and the output
    once; ``ffma_bound_ms`` is the same work once on the float32 FMA
    units."""
    from dbsr_tpu_torch.models.layers import (depth_to_space_phase_major,
                                              s2d_conv_kernel,
                                              space_to_depth_phase_major)
    from dbsr_tpu_torch.ops.conv_s2d import (conv3x3_s2d, conv3x3_s2d_forward,
                                             conv3x3_s2d_plain, rotate_weight)
    from dbsr_tpu_torch.serving import float32_math

    C = O = 32
    H2 = W2 = HW * 4
    rows = []
    with float32_math():
        w0 = torch.randn(O, C, 3, 3, generator=g, device=dev) / math.sqrt(
            9 * C)
        for b, orient in ((B, "forward"), (TRAIN_B, "forward"),
                          (TRAIN_B, "d_input")):
            w = rotate_weight(w0) if orient == "d_input" else w0
            x = torch.randn(b, H2, W2, 4 * C, generator=g, device=dev)
            got = conv3x3_s2d_forward(x, w)
            torch.cuda.synchronize()
            name = f"conv_s2d {orient} {[b, H2, W2, 4 * C]}"
            fine_in = depth_to_space_phase_major(x).permute(0, 3, 1, 2)
            fine = space_to_depth_phase_major(
                F.conv2d(fine_in, w, padding=1).permute(0, 2, 3, 1))
            errs = [check_close(name, got, conv3x3_s2d_plain(x, w)),
                    check_close(name + " vs the fine conv", got, fine)]
            del fine
            x_nchw, dense_w = x.permute(0, 3, 1, 2), s2d_conv_kernel(w)
            nbytes, flops = (x.numel() + got.numel()) * 4, 2 * 9 * O * x.numel()
            # the kernel's math: three TF32 products per multiply-add
            bms, by = bound(nbytes, 3 * flops, TF32_FLOPS_PER_S)
            row = dict(
                shape=[list(x.shape), list(got.shape)], orientation=orient,
                max_abs_err=errs[0], err_vs_fine_conv=errs[1],
                bound_ms=bms, bound_by=by, tc_bound_ms=bms,
                ffma_bound_ms=bound(nbytes, flops)[0],
                **timings("conv_s2d", lambda: conv3x3_s2d_forward(x, w),
                          lambda: conv3x3_s2d_plain(x, w),
                          lambda: F.conv2d(x_nchw, dense_w, padding=1)),
                fine_conv_ms=cuda_ms(lambda: F.conv2d(fine_in, w, padding=1)),
                fine_conv_device_ms=device_ms(
                    lambda: F.conv2d(fine_in, w, padding=1))[0])
            row["device_vs_fine_conv"] = (row["device_ms"]
                                          / row["fine_conv_device_ms"])
            log(f"  {name}: device {row['device_ms']:.4f} ms (the kernel "
                f"{row['kernel_device_ms']:.4f}), "
                f"{row['device_vs_fine_conv']:.3f}x the fine cuDNN conv's "
                f"{row['fine_conv_device_ms']:.4f} (target <= 0.6); bounds "
                f"{bms:.4f} (3xTF32 tensor cores), "
                f"{row['ffma_bound_ms']:.4f} (float32 FMA)")
            rows.append(row)
            del got, fine_in, x_nchw
        # the Function's backward at the train step's shape
        gout = torch.randn(x.shape, generator=g, device=dev)
        xs = (x.clone().requires_grad_(True), w0.clone().requires_grad_(True))
        want = torch.autograd.grad(conv3x3_s2d_plain(*xs), xs, gout)
        xk = x.clone().requires_grad_(True)
        wk = w0.clone().requires_grad_(True)
        before = conv3x3_s2d.launches
        conv3x3_s2d(xk, wk).backward(gout)
        torch.cuda.synchronize()
        if conv3x3_s2d.launches - before != 2:
            raise AssertionError("conv_s2d Function: forward and d_input "
                                 "launched "
                                 f"{conv3x3_s2d.launches - before} times")
        rows[-1]["err_vs_autograd"] = check_close(
            "conv_s2d Function dx vs autograd", xk.grad, want[0])
        rows[-1]["dk_err_vs_autograd"] = check_close(
            "conv_s2d Function dk (PyTorch's weight gradient) vs autograd",
            wk.grad, want[1])
    return _entry("conv_s2d", "dbsr_tpu_torch/kernels/csrc/conv_s2d.cu",
                  "dbsr_tpu/ops/conv_s2d_pallas.py:160", rows[:1], rows[1:],
                  path="serving_s2d_3_requests")


def log_row(name, r):
    lib = ("none" if r["library_ms"] is None else
           f"{r['library_ms']:.4f} ms (device {r['library_device_ms']:.4f})")
    log(f"  {name} {r['shape']}: kernel {r['ms']:.4f} ms (device "
        f"{r['device_ms']:.4f}, its kernels alone {r['kernel_device_ms']:.4f}"
        f"), plain {r['plain_ms']:.4f} ms, bound "
        f"{r['bound_ms']:.4f} ms ({r['bound_by']}), library {lib}")


def _entry(name, source, replaces, rows, other_rows=(),
           path="serving_3_requests"):
    """A kernel line entry from its rows at the shapes of one pass of its
    path (their sum: one forward's or one step's worth of each time) and
    its rows at other shapes (checked and timed, listed apart). ``path``
    names the driven path that ``launches`` is read from."""
    e = dict(name=name, route="cuda", source=source, replaces=replaces,
             path=path, shape=[r["shape"] for r in rows], per_shape=rows,
             kernel_device_ms_of=list(KERNEL_NAMES[name]))
    for k in ("ms", "device_ms", "kernel_device_ms", "plain_ms", "bound_ms",
              "tc_bound_ms", "ffma_bound_ms"):
        if k in rows[0]:
            e[k] = sum(r[k] for r in rows)
    for k in ("library_ms", "library_device_ms"):
        libs = [r[k] for r in rows]
        e[k] = sum(libs) if None not in libs else None
    e["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    if all("err_vs_autograd" in r for r in rows):
        e["max_err_vs_autograd"] = max(r["err_vs_autograd"] for r in rows)
    e["bound_by"] = ("bytes" if all(r["bound_by"] == "bytes" for r in rows)
                     else "operations")
    e["other_shapes"] = list(other_rows)
    return e


def _grid_sample_grid(coords, H, W):
    """Pixel (x, y) sampling positions -> ``F.grid_sample``'s normalised
    grid (``align_corners=False``: pixel centres at integers)."""
    return torch.stack([(2 * coords[..., 0] + 1) / W - 1,
                        (2 * coords[..., 1] + 1) / H - 1], dim=-1)


def resample_entry(dev, g):
    """Phase 6, the affine resample: fused (d=4, border 24; default_synthetic's
    path) and strict (d=1) synthesis of a batch, affines drawn as
    default_synthetic draws them, and strict synthesis of one eval burst as
    ``generate_synthetic_burst_val`` calls it (14 frames of 432^2, affines of
    the eval configuration), each bit-equal to the plain version;
    ``F.grid_sample`` at the same coordinates is the yardstick; at the fused
    shape, the host's microseconds per call of each."""
    from dbsr_tpu_torch.data.synthetic import (BurstConfig, burst_transforms,
                                               sample_draws)
    from dbsr_tpu_torch.generate_synthetic_burst_val import eval_burst_config
    from dbsr_tpu_torch.ops.interp import apply_affine_to_points, invert_2x3
    from dbsr_tpu_torch.ops.resample import (affine_resample,
                                             affine_resample_plain,
                                             fine_grid)

    def batch(cfg, b, gen):
        H, W = cfg.pre_crop_sz
        images = torch.rand(b, H, W, 3, generator=gen, device=dev)
        invs = invert_2x3(burst_transforms(sample_draws(gen, b, cfg), (H, W),
                                           cfg)).contiguous()
        return images, invs

    cfg = BurstConfig(fused_resample=True)
    train = batch(cfg, TRAIN_B, g)
    # its own generator: the draws of g that later phases take stay as they were
    eval_cfg = eval_burst_config()
    evals = batch(eval_cfg, 1, torch.Generator(device=dev).manual_seed(
        EVAL_SEED))
    d_lr = cfg.downsample_factor
    rows = []
    for (images, invs), out_hw, d, border in (
            (train, (cfg.crop_sz[0] // d_lr, cfg.crop_sz[1] // d_lr), d_lr,
             cfg.border_crop),
            (train, cfg.pre_crop_sz, 1, 0),
            (evals, eval_cfg.pre_crop_sz, 1, 0)):
        H, W = images.shape[1:3]
        args = (images, invs, out_hw, d, border)
        got = affine_resample(*args)
        err = check_exact(f"resample {list(images.shape)} x {invs.shape[1]} "
                          f"frames, d={d} border={border}", got,
                          affine_resample_plain(*args))
        coords = apply_affine_to_points(invs, fine_grid(out_hw, d, border,
                                                        dev))
        grid = _grid_sample_grid(coords, H, W).reshape(
            images.shape[0], invs.shape[1] * out_hw[0], out_hw[1], 2)
        nchw = images.permute(0, 3, 1, 2)
        lib = F.grid_sample(nchw, grid, align_corners=False,
                            padding_mode="zeros")
        log(f"  resample d={d} grid_sample vs plain (info only): "
            f"{(lib.permute(0, 2, 3, 1).reshape(got.shape) - got).abs().max().item():.3e}")
        nb = (images.numel() + invs.numel() + got.numel()) * 4
        bms, by = bound(nb, got.numel() // 3 * (20 + 8 * 3))
        rows.append(dict(
            shape=[list(images.shape), list(got.shape)], max_abs_err=err,
            bound_ms=bms, bound_by=by,
            **timings("resample", lambda: affine_resample(*args),
                      lambda: affine_resample_plain(*args),
                      lambda: F.grid_sample(nchw, grid, align_corners=False,
                                            padding_mode="zeros"))))
        if d == d_lr:
            # the host's cost of one call at the fused shape: the wrapper's
            # checks, the allocation, the bound C entry and the stream
            rows[-1]["host_us_per_call"] = host_us(
                lambda: affine_resample(*args))
            rows[-1]["library_host_us_per_call"] = host_us(
                lambda: F.grid_sample(nchw, grid, align_corners=False,
                                      padding_mode="zeros"))
            log(f"  resample d={d}: host {rows[-1]['host_us_per_call']:.2f} "
                f"us per call ({HOST_CALLS} calls; F.grid_sample "
                f"{rows[-1]['library_host_us_per_call']:.2f} us)")
        del got, lib, grid, coords
    return _entry("resample", "dbsr_tpu_torch/kernels/csrc/resample.cu",
                  "dbsr_tpu/ops/resample_pallas.py:132", rows[:1], rows[1:],
                  path="train_step")


def backward_kernel_phase(dev, g):
    """Phase 6: the training path's kernels against their plain versions
    (and autograd of the plain forward) at its shapes."""
    from dbsr_tpu_torch.ops.merge import (fused_softmax_merge_backward_plain,
                                          fused_softmax_merge_plain,
                                          merge_backward)
    from dbsr_tpu_torch.ops.warp import (base_grid, warp_dfeat,
                                         warp_dfeat_plain, warp_dflow,
                                         warp_dflow_plain, warp_feat,
                                         warp_feat_backward_plain,
                                         warp_feat_plain)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    results = [resample_entry(dev, g)]

    # warp backward: the encoder's 512-channel warp, then AlignLite's two
    # backwarp shapes (the aligner's own training, not this path)
    rows_dfeat, rows_dflow = [], []
    for s in ((TRAIN_FRAMES, 48, 48, 512), (TRAIN_FRAMES, 24, 24, 48),
              (TRAIN_FRAMES, 48, 48, 24)):
        feat, gout = randn(*s), randn(*s)
        fl = torch.rand(s[0], s[1], s[2], 2, generator=g, device=dev) * 10 - 5
        fl[:, ::5] = torch.round(fl[:, ::5])  # taps on exact pixel centres
        fl = fl.contiguous()
        want_df, want_dfl = warp_feat_backward_plain(feat, fl, gout)
        xs = (feat.clone().requires_grad_(True), fl.clone().requires_grad_(True))
        auto_df, auto_dfl = torch.autograd.grad(warp_feat_plain(*xs), xs, gout)
        got_df = warp_dfeat(fl, gout)
        got_dfl = check_repeat(f"warp d_flow {list(s)}",
                               lambda: warp_dflow(feat, fl, gout))
        errs = [check_close(f"warp d_feat {list(s)}", got_df, want_df),
                check_close(f"warp d_feat {list(s)} vs autograd", got_df,
                            auto_df),
                check_close(f"warp d_flow {list(s)}", got_dfl, want_dfl),
                check_close(f"warp d_flow {list(s)} vs autograd", got_dfl,
                            auto_dfl)]
        del want_df, want_dfl, auto_df, auto_dfl, xs
        # the library yardsticks, autograd through grid_sample: d_feat's
        # asks for the input's gradient alone (the grid needs none);
        # d_flow's, for both (the whole warp backward: PyTorch has no call
        # for the grid's gradient alone)
        nchw = feat.permute(0, 3, 1, 2).detach().requires_grad_(True)
        grid = _grid_sample_grid(base_grid(s[1], s[2], dev) + fl, s[1], s[2])
        grid_req = grid.detach().requires_grad_(True)
        out_feat = F.grid_sample(nchw, grid, align_corners=False,
                                 padding_mode="zeros")
        out_both = F.grid_sample(nchw, grid_req, align_corners=False,
                                 padding_mode="zeros")
        g_nchw = gout.permute(0, 3, 1, 2)
        n, nf = feat.numel(), fl.numel()
        bms, by = bound((2 * n + nf) * 4, 8 * n)
        rows_dfeat.append(dict(
            shape=list(s), max_abs_err=errs[0], err_vs_autograd=errs[1],
            bound_ms=bms, bound_by=by,
            **timings("warp_dfeat", lambda: warp_dfeat(fl, gout),
                      lambda: warp_dfeat_plain(fl, gout),
                      lambda: torch.autograd.grad(out_feat, nchw, g_nchw,
                                                  retain_graph=True))))
        bms, by = bound((2 * n + 2 * nf) * 4, 20 * n)
        rows_dflow.append(dict(
            shape=list(s), max_abs_err=errs[2], err_vs_autograd=errs[3],
            bound_ms=bms, bound_by=by,
            **timings("warp_dflow", lambda: warp_dflow(feat, fl, gout),
                      lambda: warp_dflow_plain(feat, fl, gout),
                      lambda: torch.autograd.grad(
                          out_both, (nchw, grid_req), g_nchw,
                          retain_graph=True))))
        del feat, gout, fl, nchw, grid, grid_req, out_feat, out_both
    # the encoder's warp alone is on the frozen train step; d_flow runs
    # where the aligner trains: all three shapes in a train_alignment step
    results.append(_entry("warp_dfeat", "dbsr_tpu_torch/kernels/csrc/warp_bwd.cu",
                          "dbsr_tpu/ops/warp_pallas.py:266", rows_dfeat[:1],
                          rows_dfeat[1:], path="train_step"))
    results[-1]["determinism"] = dfeat_determinism(dev, g)
    results.append(_entry("warp_dflow", "dbsr_tpu_torch/kernels/csrc/warp_bwd.cu",
                          "dbsr_tpu/ops/warp_pallas.py:281", rows_dflow,
                          path="train_alignment_step"))

    # the Function on the card: d_flow only when the flow needs a gradient
    feat = randn(TRAIN_B, 48, 48, 512).requires_grad_(True)
    fl = (torch.rand(TRAIN_B, 48, 48, 2, generator=g, device=dev)
          * 10 - 5)
    gout = randn(*feat.shape)
    for flow_grad in (False, True):
        feat.grad = None
        f = fl.clone().requires_grad_(flow_grad)
        before = warp_dflow.launches
        warp_feat(feat, f).backward(gout)
        torch.cuda.synchronize()
        if warp_dflow.launches - before != int(flow_grad):
            raise AssertionError(f"warp Function: d_flow launched "
                                 f"{warp_dflow.launches - before} times with "
                                 f"flow requires_grad={flow_grad}")
        want_df, want_dfl = warp_feat_backward_plain(feat.detach(), fl, gout)
        check_close(f"warp Function d_feat (flow grad {flow_grad})",
                    feat.grad, want_df)
        if flow_grad:
            check_close("warp Function d_flow", f.grad, want_dfl)
    del feat, fl, gout, f, want_df, want_dfl

    results += correlation_backward_entries(dev, g)

    # merge backward at the training merge's shape
    s = (TRAIN_B, TRAIN_N, 48, 48, 512)
    feat, logits = randn(*s), randn(*s, scale=3.0)
    gout = randn(TRAIN_B, 48, 48, 512)
    got_df, got_dl = merge_backward(feat, logits, gout)
    want_df, want_dl = fused_softmax_merge_backward_plain(feat, logits, gout)
    errs = [check_close(f"merge backward d_feat {list(s)}", got_df, want_df),
            check_close(f"merge backward d_logits {list(s)}", got_dl, want_dl)]
    del want_df, want_dl
    xs = (feat.clone().requires_grad_(True), logits.clone().requires_grad_(True))
    out = fused_softmax_merge_plain(*xs)
    auto_df, auto_dl = torch.autograd.grad(out, xs, gout, retain_graph=True)
    errs += [check_close("merge backward d_feat vs autograd", got_df, auto_df),
             check_close("merge backward d_logits vs autograd", got_dl,
                         auto_dl)]
    del got_df, got_dl, auto_df, auto_dl
    # yardstick: autograd of softmax + weighted sum in PyTorch's own ops
    n = feat.numel()
    bms, by = bound((4 * n + gout.numel()) * 4, 16 * n)
    results.append(_entry(
        "merge_backward", "dbsr_tpu_torch/kernels/csrc/merge_bwd.cu",
        "dbsr_tpu/ops/merge_pallas.py:114",
        [dict(shape=list(s), max_abs_err=max(errs[:2]),
              err_vs_autograd=max(errs[2:]), bound_ms=bms, bound_by=by,
              **timings("merge_backward",
                        lambda: merge_backward(feat, logits, gout),
                        lambda: fused_softmax_merge_backward_plain(
                            feat, logits, gout),
                        lambda: torch.autograd.grad(out, xs, gout,
                                                    retain_graph=True)))],
        path="train_step"))
    del feat, logits, gout, xs, out
    return results


def check_repeat(name, fn):
    """Two calls of ``fn()`` must give the same bits; returns the first."""
    a, b = fn(), fn()
    diff = (a - b).abs().max().item()
    log(f"  {name}: two calls, max|first - second| = {diff:.3e} "
        f"(bit-identical required)")
    if not torch.equal(a, b):
        raise AssertionError(f"{name}: two calls on the same inputs differ "
                             f"by up to {diff}")
    return a


def dfeat_determinism(dev, g):
    """Phase 6, ``warp_dfeat``'s determinism at the encoder's shape of the
    train step: two calls on the same inputs give the same bits, with
    flows of +-5 px (some on exact integers) and with a pile-up (every
    source of a frame pulled onto one 3x3 patch: buckets of ~1000 sources,
    the sort's heapsort), where it also agrees with the plain version
    (its device time recorded); a flow whose every tap is out of range
    gives zeros. Then two odd shapes, against the plain version and
    repeated: C=12 on a ragged 13x22 plane (one 4-channel group a thread,
    part-filled 4x8 target tiles) and a 96x96 plane, whose CSR is built
    in the scratch, not in shared memory."""
    from dbsr_tpu_torch.ops.warp import base_grid, warp_dfeat, warp_dfeat_plain

    s = (TRAIN_FRAMES, 48, 48, 512)
    gout = torch.randn(*s, generator=g, device=dev)
    fl = torch.rand(*s[:3], 2, generator=g, device=dev) * 10 - 5
    fl[:, ::5] = torch.round(fl[:, ::5])  # taps on exact pixel centres
    fl = fl.contiguous()
    check_repeat(f"warp d_feat {list(s)}, flows +-5 px",
                 lambda: warp_dfeat(fl, gout))
    # p + flow = (20.3, 17.6) + [0, 2)^2 px for every source p
    pile = (torch.tensor([20.3, 17.6], device=dev) - base_grid(48, 48, dev)
            + 2 * torch.rand(*s[:3], 2, generator=g, device=dev)).contiguous()
    got = check_repeat(f"warp d_feat {list(s)}, pile-up onto a 3x3 patch",
                       lambda: warp_dfeat(pile, gout))
    err = check_close(f"warp d_feat {list(s)}, pile-up", got,
                      warp_dfeat_plain(pile, gout))
    pile_ms = device_ms(lambda: warp_dfeat(pile, gout))[0]
    log(f"  warp d_feat pile-up: device {pile_ms:.4f} ms")
    out_of_range = torch.full((*s[:3], 2), 60.0, device=dev)
    zeros = warp_dfeat(out_of_range, gout)
    if not torch.equal(zeros, torch.zeros_like(zeros)):
        raise AssertionError("warp d_feat: a flow with every tap out of range "
                             "gave non-zeros")
    log("  warp d_feat, every tap out of range: all zeros")
    odd = []
    for shape in ((3, 13, 22, 12), (2, 96, 96, 8)):
        go = torch.randn(*shape, generator=g, device=dev)
        fo = (torch.rand(*shape[:3], 2, generator=g, device=dev) * 10
              - 5).contiguous()
        odd.append(dict(shape=list(shape), max_abs_err=check_close(
            f"warp d_feat {list(shape)}",
            check_repeat(f"warp d_feat {list(shape)}",
                         lambda: warp_dfeat(fo, go)),
            warp_dfeat_plain(fo, go))))
    return dict(repeat_identical=True, pile_up_identical=True,
                pile_up_max_abs_err=err, pile_up_device_ms=pile_ms,
                out_of_range_zeros=True, odd_shapes=odd)


def dflow_lane_rows(dev, g, dtype):
    """``warp_dflow`` at every lane width of its dispatch (DFLOW_CHANNELS)
    in ``dtype``, on 3 frames of 13x21 (the last warp part-filled at every
    width): flows of +-5 px, a fifth of the rows on exact pixel centres, in
    two frames, every tap out of range in the third (zeros required);
    against its plain version (float32: check_close; bf16:
    check_dflow_bf16), the same bits twice."""
    from dbsr_tpu_torch.ops.warp import warp_dflow, warp_dflow_plain

    fl = torch.rand(3, 13, 21, 2, generator=g, device=dev) * 10 - 5
    fl[:2, ::5] = torch.round(fl[:2, ::5])
    fl[2] = 40.0
    fl = fl.contiguous()
    rows = []
    for c in DFLOW_CHANNELS:
        feat, gout = (torch.randn(3, 13, 21, c, generator=g,
                                  device=dev).to(dtype) for _ in range(2))
        name = f"warp d_flow {str(dtype)[6:]} {[3, 13, 21, c]}"
        got = check_repeat(name, lambda: warp_dflow(feat, fl, gout))
        if dtype == torch.float32:
            row = dict(max_abs_err=check_close(
                name, got, warp_dflow_plain(feat, fl, gout)),
                repeat_equal=True)
        else:
            row = check_dflow_bf16(name, lambda: warp_dflow(feat, fl, gout),
                                   lambda: warp_dflow_plain(feat, fl, gout),
                                   dflow_terms(feat, fl, gout))
        if got[2].any():
            raise AssertionError(f"{name}: nonzero where every tap is out of "
                                 f"range")
        rows.append(dict(shape=[3, 13, 21, c], **row))
    return rows


def _wide_flow(g, dev, shape, amp):
    """Flows of ``shape[:3]`` up to +-``amp`` px, a seventh of the rows on
    exact pixel centres."""
    f = (torch.rand(*shape[:3], 2, generator=g, device=dev) * 2 - 1) * amp
    f[:, ::7] = torch.round(f[:, ::7])
    return f.contiguous()


# SCA's 3-channel warps: (shape, path): the prediction and the
# coarse-to-fine source at the eval's 640^2 and the fine-tuning's 448^2 x
# 12, the base frame at 80^2 and 56^2 x 12
SCA_WARP_SHAPES = (((1, 640, 640, 3), "burstsr_eval"),
                   ((1, 80, 80, 3), "burstsr_eval"),
                   ((RW_B, 448, 448, 3), "realworld_step"),
                   ((RW_B, 56, 56, 3), "realworld_step"))
ANY_C_SHAPES = tuple((3, 13, 22, c) for c in (1, 2, 3, 5, 24))


def warp_any_c_rows(dev, g):
    """Phase 3, the warp forward at C % 4 != 0 (4-byte accesses): C in {1,
    2, 3, 5} on a ragged 13x22 plane, beside C = 24 there (16-byte), then C
    = 3 at SCA's shapes (``SCA_WARP_SHAPES``, flows up to +-8 px), each
    bit-identical to its plain version; SCA's shapes timed and bounded as
    the rows above, ``F.grid_sample`` the yardstick. Returns ``(ragged
    rows, SCA rows)``."""
    from dbsr_tpu_torch.ops.warp import base_grid, warp_feat, warp_feat_plain

    ragged = []
    for s in ANY_C_SHAPES:
        feat = torch.randn(*s, generator=g, device=dev)
        fl = _wide_flow(g, dev, s, 5.0)
        ragged.append(dict(shape=list(s), max_abs_err=check_exact(
            f"warp {list(s)}", warp_feat(feat, fl), warp_feat_plain(feat, fl))))
    rows = []
    for s, path in SCA_WARP_SHAPES:
        feat = torch.rand(*s, generator=g, device=dev)
        fl = _wide_flow(g, dev, s, 8.0)
        err = check_exact(f"warp {list(s)} (SCA)", warp_feat(feat, fl),
                          warp_feat_plain(feat, fl))
        grid = _grid_sample_grid(base_grid(s[1], s[2], dev) + fl, s[1], s[2])
        nchw = feat.permute(0, 3, 1, 2)
        bms, by = bound((2 * feat.numel() + fl.numel()) * 4, 7 * feat.numel())
        rows.append(dict(
            shape=list(s), path=path, max_abs_err=err, bound_ms=bms,
            bound_by=by,
            **timings("warp", lambda: warp_feat(feat, fl),
                      lambda: warp_feat_plain(feat, fl),
                      lambda: F.grid_sample(nchw, grid, align_corners=False,
                                            padding_mode="zeros"))))
        del feat, fl, grid, nchw
    return ragged, rows


def dfeat_any_c_rows(dev, g):
    """Phase 6, ``warp_dfeat`` at C % 4 != 0 (4-byte accesses): C in {1, 2,
    3, 5} on the ragged 13x22 plane, beside C = 24 there, and C = 3 at the
    fine-tuning step's SCA warp of the prediction, [12, 448, 448, 3] (P =
    200704: the CSR is built in the scratch, not in shared memory); each
    called twice (bit-identical required) and held against the plain
    version and autograd of the plain forward; the SCA shape timed and
    bounded as phase 6's rows, autograd of ``F.grid_sample`` (the input's
    gradient) the yardstick. Returns ``(ragged rows, SCA rows)``."""
    from dbsr_tpu_torch.ops.warp import (_dfeat_scratch_words, base_grid,
                                         warp_dfeat, warp_dfeat_plain,
                                         warp_feat_plain)

    def held(s, amp):
        gout = torch.randn(*s, generator=g, device=dev)
        fl = _wide_flow(g, dev, s, amp)
        got = check_repeat(f"warp d_feat {list(s)}",
                           lambda: warp_dfeat(fl, gout))
        xs = torch.zeros(s, device=dev, requires_grad=True)
        auto = torch.autograd.grad(warp_feat_plain(xs, fl), xs, gout)[0]
        errs = (check_close(f"warp d_feat {list(s)}", got,
                            warp_dfeat_plain(fl, gout)),
                check_close(f"warp d_feat {list(s)} vs autograd", got, auto))
        return gout, fl, errs

    ragged = []
    for s in ANY_C_SHAPES:
        _, _, errs = held(s, 5.0)
        ragged.append(dict(shape=list(s), max_abs_err=errs[0],
                           err_vs_autograd=errs[1]))
    s = (RW_B, 448, 448, 3)
    words = _dfeat_scratch_words(s[0], s[1] * s[2])
    log(f"  warp d_feat {list(s)}: CSR scratch {words} int32 words "
        f"({words * 4 / 2 ** 20:.1f} MiB), below 2^31")
    gout, fl, errs = held(s, 8.0)
    nchw = torch.rand(s, generator=g, device=dev).permute(
        0, 3, 1, 2).requires_grad_(True)
    grid = _grid_sample_grid(base_grid(s[1], s[2], dev) + fl, s[1], s[2])
    out = F.grid_sample(nchw, grid, align_corners=False, padding_mode="zeros")
    g_nchw = gout.permute(0, 3, 1, 2)
    n, nf = gout.numel(), fl.numel()
    bms, by = bound((2 * n + nf) * 4, 8 * n)
    rows = [dict(shape=list(s), path="realworld_step", max_abs_err=errs[0],
                 err_vs_autograd=errs[1], scratch_words=words, bound_ms=bms,
                 bound_by=by,
                 **timings("warp_dfeat", lambda: warp_dfeat(fl, gout),
                           lambda: warp_dfeat_plain(fl, gout),
                           lambda: torch.autograd.grad(
                               out, nchw, g_nchw, retain_graph=True)))]
    return ragged, rows

def correlation_backward_entries(dev, g):
    """Phase 6, the cost volume's d_first and d_second: against their plain
    versions and ``torch.autograd.grad`` of ``correlation_plain``, and two
    calls bit-identical, at AlignLite's three training shapes (B=16, N=8;
    device time also by level) and at an odd one (H != W, neither a
    multiple of the 8x12 tile, C = 136 in 5 chunks split across blocks);
    untimed, on a ragged 13x22 plane at C in {1, 3, 5, 33, 196} (4-byte and
    16-byte copies, part-filled channel groups, PWC-Net's widest level) and
    at two shapes whose blocks take several chunks each, double-buffered
    (C = 100 with the chunks also split, C = 33 with 4-byte copies); then
    the ``Function`` on the card. ``library_ms`` is None: no single PyTorch
    call computes either; autograd of the plain version is ``plain_ms``."""
    from dbsr_tpu_torch.ops.correlation import (NUM_OFFSETS,
                                                correlation_dfirst,
                                                correlation_dfirst_plain,
                                                correlation_dsecond,
                                                correlation_dsecond_plain,
                                                correlation_plain, cost_volume)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    rows = {"dfirst": [], "dsecond": []}
    for s in ((TRAIN_FRAMES, 12, 12, 96), (TRAIN_FRAMES, 24, 24, 48),
              (TRAIN_FRAMES, 48, 48, 24), (5, 13, 22, 136)):
        first, second = randn(*s), randn(*s)
        gout = randn(*s[:3], NUM_OFFSETS)
        xs = (first.clone().requires_grad_(True),
              second.clone().requires_grad_(True))
        auto = torch.autograd.grad(correlation_plain(*xs), xs, gout)
        nbytes = (2 * first.numel() + gout.numel()) * 4
        bms, by = bound(nbytes, 2 * NUM_OFFSETS * first.numel())
        for name, fn, plain, operand, want_auto in (
                ("dfirst", correlation_dfirst, correlation_dfirst_plain,
                 second, auto[0]),
                ("dsecond", correlation_dsecond, correlation_dsecond_plain,
                 first, auto[1])):
            got = check_repeat(f"correlation {name} {list(s)}",
                               lambda: fn(operand, gout))
            torch.cuda.synchronize()
            errs = [check_close(f"correlation {name} {list(s)}", got,
                                plain(operand, gout)),
                    check_close(f"correlation {name} {list(s)} vs autograd",
                                got, want_auto)]
            rows[name].append(dict(
                shape=list(s), max_abs_err=errs[0], err_vs_autograd=errs[1],
                bound_ms=bms, bound_by=by,
                **timings(f"correlation_{name}", lambda: fn(operand, gout),
                          lambda: plain(operand, gout))))
        del first, second, gout, xs, auto

    odd = {"dfirst": [], "dsecond": []}
    for s in ((2, 13, 22, 1), (2, 13, 22, 3), (2, 13, 22, 5),
              (2, 13, 22, 33), (2, 13, 22, 196), (40, 48, 48, 100),
              (100, 48, 48, 33)):
        first, second = randn(*s), randn(*s)
        gout = randn(*s[:3], NUM_OFFSETS)
        xs = (first.clone().requires_grad_(True),
              second.clone().requires_grad_(True))
        auto = torch.autograd.grad(correlation_plain(*xs), xs, gout)
        for name, fn, plain, operand, want_auto in (
                ("dfirst", correlation_dfirst, correlation_dfirst_plain,
                 second, auto[0]),
                ("dsecond", correlation_dsecond, correlation_dsecond_plain,
                 first, auto[1])):
            got = check_repeat(f"correlation {name} {list(s)}",
                               lambda: fn(operand, gout))
            odd[name].append(dict(
                shape=list(s), repeat_identical=True,
                max_abs_err=check_close(f"correlation {name} {list(s)}", got,
                                        plain(operand, gout)),
                err_vs_autograd=check_close(
                    f"correlation {name} {list(s)} vs autograd", got,
                    want_auto)))
        del first, second, gout, xs, auto

    # the Function on the card: a volume that needs a gradient has a grad_fn
    # and its backward launches only the kernels whose input needs one;
    # under no_grad nothing is saved
    s = (TRAIN_B, 24, 24, 48)
    first, second, gout = randn(*s), randn(*s), randn(*s[:3], NUM_OFFSETS)
    for needs in ((True, True), (True, False), (False, True)):
        a = first.clone().requires_grad_(needs[0])
        b = second.clone().requires_grad_(needs[1])
        before = (correlation_dfirst.launches, correlation_dsecond.launches)
        out = cost_volume(a, b)
        if out.grad_fn is None:
            raise AssertionError("cost_volume on the card has no grad_fn")
        out.backward(gout)
        torch.cuda.synchronize()
        ran = (correlation_dfirst.launches - before[0],
               correlation_dsecond.launches - before[1])
        if ran != tuple(int(n) for n in needs):
            raise AssertionError(f"cost_volume Function: backward launched "
                                 f"(d_first, d_second) {ran} times with "
                                 f"requires_grad={needs}")
        if needs[0]:
            check_close(f"cost_volume Function d_first (needs {needs})",
                        a.grad, correlation_dfirst_plain(second, gout))
        if needs[1]:
            check_close(f"cost_volume Function d_second (needs {needs})",
                        b.grad, correlation_dsecond_plain(first, gout))
    with torch.no_grad():
        out = cost_volume(first.requires_grad_(True), second)
    if out.grad_fn is not None or out.requires_grad:
        raise AssertionError("cost_volume under no_grad kept a graph")

    csrc = "dbsr_tpu_torch/kernels/csrc/correlation_bwd.cu"
    entries = []
    for name, line in (("dfirst", 163), ("dsecond", 178)):
        e = _entry(f"correlation_{name}", csrc,
                   f"dbsr_tpu/ops/correlation.py:{line}", rows[name][:3],
                   rows[name][3:], path="pretrain_step")
        # AlignLite's three levels in one pretraining step, each a launch
        e["kernel_device_ms_by_level"] = {
            f"{r['shape'][1]}x{r['shape'][2]}x{r['shape'][3]}":
                r["kernel_device_ms"] for r in e["per_shape"]}
        e["repeat_identical"] = True
        e["odd_shapes"] = odd[name]
        log(f"  correlation_{name} kernel device ms by level (pretraining): "
            f"{e['kernel_device_ms_by_level']}, summed "
            f"{e['kernel_device_ms']:.4f}")
        entries.append(e)
    return entries


def _counters():
    from dbsr_tpu_torch.ops.conv_s2d import conv3x3_s2d, conv3x3_s2d_dweight
    from dbsr_tpu_torch.ops.correlation import (correlation_dfirst,
                                                correlation_dsecond,
                                                cost_volume)
    from dbsr_tpu_torch.ops.dead_leaves import dead_leaves_composite
    from dbsr_tpu_torch.ops.merge import fused_softmax_merge, merge_backward
    from dbsr_tpu_torch.ops.resample import affine_resample
    from dbsr_tpu_torch.ops.warp import warp_dfeat, warp_dflow, warp_feat
    return {"resample": affine_resample, "warp": warp_feat,
            "correlation": cost_volume, "merge": fused_softmax_merge,
            "warp_dfeat": warp_dfeat, "warp_dflow": warp_dflow,
            "merge_backward": merge_backward,
            "correlation_dfirst": correlation_dfirst,
            "correlation_dsecond": correlation_dsecond,
            "conv_s2d": conv3x3_s2d, "conv_s2d_dweight": conv3x3_s2d_dweight,
            "dead_leaves_composite": dead_leaves_composite}


def pool_round_launches(pool_size):
    """The dead-leaves composite's launches for one round of a dead-leaves
    pool of ``pool_size`` images: one a chunk."""
    return -(-pool_size // POOL_CHUNK)


def reset_counts():
    for w in _counters().values():
        w.launches = 0


def read_counts():
    return {k: w.launches for k, w in _counters().items()}


def check_counts(what, counts, steps, per_step=None, renders=0):
    """``counts`` must be ``steps`` times ``per_step`` and, beside them,
    ``renders`` launches of the dead-leaves composite (the pool rounds
    rendered in the same window, ``pool_round_launches`` each)."""
    per_step = per_step or LAUNCHES_PER_TRAIN_STEP
    want = {k: v * steps for k, v in per_step.items()}
    want["dead_leaves_composite"] += renders
    log(f"launches over {what} ({steps} train steps, {renders} launches of "
        f"pool renders): {counts}")
    if counts != want:
        raise AssertionError(f"{what}: launches {counts}, expected {want} "
                             f"({per_step} per train step, {renders} of "
                             f"pool renders)")


def per_step_of(counts, steps, renders=0):
    """The launches a step of a window of ``steps`` steps that also
    rendered ``renders`` (checked by ``check_counts``)."""
    return {k: (v - renders * (k == "dead_leaves_composite")) // steps
            for k, v in counts.items()}


def card_vs_cpu(what, out, prefix=None, each=True):
    """Compare one train step on the card with the same step on the CPU:
    ``out[device] = (loss, {name: grad}, seconds)``. The loss within
    LOSS_RTOL, all gradients together within GRAD_TOL of their norm; the
    tensors under ``prefix`` together within GRAD_TOL of their own norm and,
    with ``each``, every one of them within GRAD_TOL of its own norm."""
    (l_card, g_card, s_card), (l_cpu, g_cpu, s_cpu) = out["cuda"], out["cpu"]
    if set(g_card) != set(g_cpu):
        raise AssertionError(f"{what}: gradients of different tensors")
    rel_loss = abs(l_card - l_cpu) / abs(l_cpu)
    diff2 = sum(float(((g_card[k] - g_cpu[k]) ** 2).sum()) for k in g_cpu)
    norm2 = sum(float((g_cpu[k] ** 2).sum()) for k in g_cpu)
    rel_grad = math.sqrt(diff2 / norm2)

    def rel(k):
        return float((g_card[k] - g_cpu[k]).norm()) \
            / max(float(g_cpu[k].norm()), 1e-30)

    worst = max(g_cpu, key=rel)
    worst_rel = rel(worst)
    worst_share = float(g_cpu[worst].norm()) / math.sqrt(norm2)
    log(f"{what}, card vs CPU: loss {l_card:.8f} vs {l_cpu:.8f} (rel "
        f"{rel_loss:.2e}, limit {LOSS_RTOL}); all {len(g_cpu)} gradients "
        f"||diff||/||g|| {rel_grad:.2e} (limit {GRAD_TOL}); worst tensor "
        f"{worst}: ||diff||/||its g|| {worst_rel:.2e}, its ||g|| "
        f"{worst_share:.2e} of the whole (a tensor whose true gradient is ~0, "
        f"such as the bias of the merge's logits, to which the frame softmax "
        f"is blind, shows rounding noise here); step {s_card:.1f} s on the "
        f"card (first, with set-up), {s_cpu:.1f} s on the CPU")
    res = dict(loss_rel=rel_loss, grad_rel=rel_grad, worst_tensor=worst,
               worst_tensor_rel=worst_rel, worst_tensor_norm_share=worst_share)
    if not rel_loss <= LOSS_RTOL:
        raise AssertionError(f"{what}: card vs CPU loss: {rel_loss} > "
                             f"{LOSS_RTOL}")
    if not rel_grad <= GRAD_TOL:
        raise AssertionError(f"{what}: card vs CPU gradients: {rel_grad} > "
                             f"{GRAD_TOL}")
    if prefix is not None:
        own = {k: rel(k) for k in g_cpu if k.startswith(prefix)}
        if not own:
            raise AssertionError(f"{what}: no gradient under {prefix}")
        k_max = max(own, key=own.get)
        own_norm2 = sum(float((g_cpu[k] ** 2).sum()) for k in own)
        own_rel = math.sqrt(sum(float(((g_card[k] - g_cpu[k]) ** 2).sum())
                                for k in own) / own_norm2)
        log(f"  the {len(own)} tensors under {prefix}: together "
            f"||diff||/||their g|| {own_rel:.2e} (limit {GRAD_TOL}), their "
            f"||g|| {math.sqrt(own_norm2 / norm2):.2e} of the whole; worst "
            f"single tensor ||diff||/||its g|| {own[k_max]:.2e} ({k_max}"
            + (f"; limit {GRAD_TOL})" if each else "; reported only)"))
        if not own_rel <= GRAD_TOL:
            raise AssertionError(f"{what}: {prefix}: {own_rel} > {GRAD_TOL}")
        if each and not own[k_max] <= GRAD_TOL:
            raise AssertionError(f"{what}: {k_max}: {own[k_max]} > {GRAD_TOL}")
        res.update(prefix=prefix, prefix_rel=own_rel,
                   prefix_worst_tensor=k_max, prefix_worst_rel=own[k_max])
    return res


def _grads(net):
    return {k: p.grad.detach().cpu() for k, p in net.named_parameters()
            if p.requires_grad}


def grad_phase(train_alignment=False, flow_ckpt=None, s2d=False, ckpt=None):
    """Phases 7a, 9, 10c and 12e: one train step of the banked flagship (or
    of ``ckpt``; B=1, N=8) on the card and on the CPU from the same batch,
    synthesised on the CPU; the decoder at fine resolution, or with ``s2d`` in the s2d layout
    (under the caller's ``DBSR_FINE_PATCH_S2D``); with ``train_alignment``
    the aligner of ``flow_ckpt`` is grafted and
    trains too, and the aligner's gradients are also held together on their
    own (not tensor by tensor: the flow heads' two-element bias gradients
    are sums of d_flow over all pixels that largely cancel, and their
    relative error moved between 3.6e-4 and 7.0e-4 from run to run with
    the d_feat atomics' order and the freshly pretrained aligner).

    The merge embeds the flow offsets mod ``offset_modulo`` (1 px), as the
    JAX model and DBSR do: a jump of the model itself. An offset that sits
    within the two sides' rounding of a whole pixel wraps on one side and
    not on the other, and one such offset moves the flagship's loss by
    more than 1e-6 of itself (``tests/test_torch_port_offset_wrap.py``), so
    a few of them exceed LOSS_RTOL with no fault of the port. The offsets of
    both sides are therefore compared: where any of them fall on the two
    sides of a multiple of the modulo, each within WRAP_DIFF_TOL of its
    counterpart, that batch is logged and left, and the next seed of
    BATCH_SEEDS is drawn (the freshly pretrained aligner
    of phase 9 differs from run to run; the banked one of 7a and 10c is the
    same in every run)."""
    from dbsr_tpu_torch.configs.dbsr.default_synthetic import \
        graft_alignment_params
    from dbsr_tpu_torch.data.procedural import (dead_leaves_image,
                                                make_generator)
    from dbsr_tpu_torch.data.synthetic import BurstConfig, synthesize_batch
    from dbsr_tpu_torch.serving import FLAGSHIP_CHECKPOINT, float32_math
    from dbsr_tpu_torch.training.actors import make_synthetic_actor
    from dbsr_tpu_torch.training.checkpoint import load_network

    ckpt = ckpt or FLAGSHIP_CHECKPOINT
    what = (f"train step ({os.path.basename(ckpt)}, B=1, N=8"
            + (", the port's own aligner grafted" if flow_ckpt else "")
            + (", train_alignment=True" if train_alignment else "")
            + (f", s2d decoder, {FINE_PATCH_ENV}="
               f"{os.environ.get(FINE_PATCH_ENV)})" if s2d else ")"))
    cfg = BurstConfig(fused_resample=True)
    wrapped_by_seed = {}
    for seed in BATCH_SEEDS:
        gen = make_generator("cpu", seed)
        batch = synthesize_batch(
            gen, dead_leaves_image(gen, 1, cfg.pre_crop_sz), cfg)
        out, offsets = {}, {}
        for device in ("cuda", "cpu"):
            t0 = time.perf_counter()
            net, _ = load_network(ckpt, device=device, dtype=None,
                                  train_alignment=train_alignment,
                                  fused_s2d_decoder=s2d)
            if flow_ckpt is not None:
                graft_alignment_params(net, flow_ckpt)
            modulo = net.merging.offset_modulo
            hook = net.encoder.register_forward_hook(
                lambda m, i, o, d=device: offsets.__setitem__(
                    d, o["offsets"].detach().cpu()))
            b = {k: batch[k].to(device) for k in ("burst", "frame_gt")}
            reset_counts()
            with float32_math():
                loss, _ = make_synthetic_actor(net, boundary_ignore=40)(b)
                loss.backward()
            if device == "cuda":
                torch.cuda.synchronize()
                launches = read_counts()
            hook.remove()
            out[device] = (loss.item(), _grads(net),
                           time.perf_counter() - t0)
            del net
        o_card, o_cpu = offsets["cuda"], offsets["cpu"]
        if modulo is None:  # no floor-mod, no jump
            at, near = torch.zeros_like(o_card, dtype=torch.bool), math.nan
        else:
            at = torch.floor(o_card / modulo) != torch.floor(o_cpu / modulo)
            near = modulo * float((o_card / modulo
                                   - torch.round(o_card / modulo)).abs().min())
        wrapped = wrapped_by_seed[seed] = int(at.sum())
        log(f"{what}, batch seed {seed}: {o_card.numel()} offsets, card vs "
            f"CPU max |diff| {float((o_card - o_cpu).abs().max()):.3e} px, "
            f"the card's nearest to a multiple of offset_modulo {modulo} "
            f"{near:.3e} px away; {wrapped} on the two sides of one")
        if not wrapped:
            break
        wrap_diff = float((o_card - o_cpu)[at].abs().max())
        log(f"  batch seed {seed} left: the two sides take different "
            f"branches of the offsets' floor-mod at {wrapped} offsets, "
            f"which differ by at most {wrap_diff:.3e} px")
        if not wrap_diff <= WRAP_DIFF_TOL:
            raise AssertionError(f"{what}: offsets that wrap on one side "
                                 f"differ by {wrap_diff} > {WRAP_DIFF_TOL} px")
    else:
        raise AssertionError(f"{what}: offsets on the two sides of a "
                             f"multiple of {modulo} for every batch seed: "
                             f"{wrapped_by_seed}")
    log(f"{what}: launches on the card {launches}")
    res = card_vs_cpu(what, out, "encoder.alignment_net."
                      if train_alignment else None, each=False)
    res.update(launches=launches, batch_seed=seed,
               wrapped_offsets_by_seed=wrapped_by_seed)
    return res


def _repeat_step(actor, net, batch):
    """The loss and every gradient of one step (no optimizer step) of
    ``actor`` on ``batch``, twice from the same parameters."""
    from dbsr_tpu_torch.serving import float32_math

    runs = []
    for _ in range(2):
        net.zero_grad(set_to_none=True)
        with float32_math():
            loss, _ = actor(batch)
            loss.backward()
        torch.cuda.synchronize()
        runs.append((loss.detach().clone(),
                     {k: p.grad.detach().clone()
                      for k, p in net.named_parameters() if p.grad is not None}))
    return runs


def _compare_runs(what, net, runs):
    """Log whether two runs' loss and gradients are bit-identical; where
    not, the tensors that differ by module type, and the largest relative
    difference, with the tensor nearest the loss that differs (the backward
    reaches it first)."""
    (l1, g1), (l2, g2) = runs
    kinds = {name: type(m).__name__ for name, m in net.named_modules()}
    differ = [k for k in g1 if not torch.equal(g1[k], g2[k])]

    def rel(k):
        return float((g1[k] - g2[k]).norm()) / max(float(g1[k].norm()), 1e-30)

    by_kind = defaultdict(int)
    for k in differ:
        by_kind[kinds.get(k.rsplit(".", 1)[0], "?")] += 1
    res = dict(loss_identical=bool(torch.equal(l1, l2)),
               loss_abs_diff=float((l1 - l2).abs()), gradients=len(g1),
               gradients_differing=len(differ), differing=differ,
               differing_by_module_type=dict(by_kind),
               worst=max(differ, key=rel) if differ else None,
               worst_rel=max(map(rel, differ)) if differ else 0.0,
               nearest_loss=differ[-1] if differ else None)
    log(f"{what}, run twice on the card: loss bit-identical "
        f"{res['loss_identical']} (|diff| {res['loss_abs_diff']:.3e}); "
        f"{len(differ)} of {len(g1)} gradients differ, by module type "
        f"{res['differing_by_module_type']}; worst {res['worst']} "
        f"(||diff||/||g|| {res['worst_rel']:.2e}); the differing tensor "
        f"nearest the loss: {res['nearest_loss']}")
    return res


def _conv_backward_repeat(dev, what, conv, nchw):
    """cuDNN's float32 backward of ``conv`` alone, twice, on a random input
    of shape ``nchw`` handed as ``layers.conv_nhwc`` hands it (a
    channels-last view) and a random output gradient: whether d_input,
    d_weight and d_bias repeat bit for bit."""
    from dbsr_tpu_torch.serving import float32_math

    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    n, c, h, w = nchw
    x = torch.randn(n, h, w, c, generator=gen, device=dev)
    params = (conv.weight.detach(),
              None if conv.bias is None else conv.bias.detach())
    grads, gout = [], None
    for _ in range(2):
        xs = [x.clone().requires_grad_(True)] + [
            t.clone().requires_grad_(True) for t in params if t is not None]
        with float32_math():
            out = F.conv2d(xs[0].permute(0, 3, 1, 2), xs[1],
                           xs[2] if len(xs) > 2 else None, conv.stride,
                           conv.padding, conv.dilation, conv.groups)
            if gout is None:
                gout = torch.randn(out.shape, generator=gen, device=dev)
            grads.append(torch.autograd.grad(out, xs, gout))
    res = dict(conv=what, input_nchw=list(nchw),
               weight=list(conv.weight.shape),
               **{f"d_{k}_identical": bool(torch.equal(a, b))
                  for k, a, b in zip(("input", "weight", "bias"), *grads)})
    log(f"  cuDNN conv backward alone, twice: {res}")
    return res


def determinism_phase(dev, trainer):
    """Phase 7e: the card's training step against itself. One frozen
    ``default_synthetic`` step (loss and gradients, no optimizer step)
    twice from the same parameters and batch, at B=1 (the banked flagship
    and 7a's first batch, synthesised on the CPU) and at B=16 (``trainer``'s
    network, the batch synthesised on the card from one seed, twice, and
    compared too); then cuDNN's conv backward alone: an encoder-like conv,
    and the conv of the differing gradient nearest the loss at the shape
    the B=16 step gives it. Logged, not required:
    the port's kernels are deterministic, and what still varies is named
    here."""
    from dbsr_tpu_torch.data.procedural import (dead_leaves_image,
                                                make_generator)
    from dbsr_tpu_torch.data.synthetic import BurstConfig, synthesize_batch
    from dbsr_tpu_torch.serving import FLAGSHIP_CHECKPOINT, float32_math
    from dbsr_tpu_torch.training.actors import make_synthetic_actor
    from dbsr_tpu_torch.training.checkpoint import load_network

    out = {}
    cfg = BurstConfig(fused_resample=True)
    gen = make_generator("cpu", BATCH_SEEDS[0])
    batch = synthesize_batch(
        gen, dead_leaves_image(gen, 1, cfg.pre_crop_sz), cfg)
    net, _ = load_network(FLAGSHIP_CHECKPOINT, device="cuda", dtype=None,
                          fused_s2d_decoder=False)
    b = {k: batch[k].to(dev) for k in ("burst", "frame_gt")}
    out["b1"] = _compare_runs(
        "determinism, frozen step B=1 (banked flagship)", net,
        _repeat_step(make_synthetic_actor(net, boundary_ignore=40), net, b))
    del net, b
    pool = trainer.loaders[0].batcher.next_batch()
    with float32_math():
        b1 = trainer.prepare_fn(make_generator(dev, 7), pool)
        b2 = trainer.prepare_fn(make_generator(dev, 7), pool)
    out["b16_synthesis_identical"] = all(torch.equal(b1[k], b2[k])
                                         for k in ("burst", "frame_gt"))
    log(f"determinism, on-card synthesis of the B={TRAIN_B} batch twice from "
        f"one seed: bit-identical {out['b16_synthesis_identical']}")
    out["b16"] = _compare_runs(
        f"determinism, frozen step B={TRAIN_B}", trainer.net,
        _repeat_step(trainer.actor_fn, trainer.net, b1))
    # cuDNN's backward alone: the encoder's 3x3 64 -> 64 conv at the
    # step's 112 frames, and the conv of the differing gradient nearest
    # the loss at the shape the step gives it
    enc = torch.nn.Conv2d(64, 64, 3, padding=1).to(dev)
    out["conv_backward"] = [_conv_backward_repeat(
        dev, "encoder-like 3x3 64->64", enc, (TRAIN_FRAMES, 64, 48, 48))]
    if out["b16"]["nearest_loss"] is not None:
        name = out["b16"]["nearest_loss"].rsplit(".", 1)[0]
        conv, shapes = trainer.net.get_submodule(name), []
        # the conv's owner (a ConvBlock or PixShuffleUpsampler) hands it
        # its channels-last input as NCHW
        owner = trainer.net.get_submodule(name.rsplit(".", 1)[0])
        hook = owner.register_forward_hook(
            lambda m, i, o: shapes.append(tuple(i[0].permute(0, 3, 1, 2)
                                                .shape)))
        with torch.no_grad(), float32_math():
            trainer.actor_fn(b1)
        hook.remove()
        out["conv_backward"].append(
            _conv_backward_repeat(dev, name, conv, shapes[0]))
    return out


def pretrain_grad_phase(dev, pwc=False):
    """Phases 8a and 12d: one ``BurstAlignLite`` (with ``pwc``,
    ``BurstFlowNet``) train step at full width (B=16, N=8) on the card and
    on the CPU, from the same fresh parameters and the same batch
    (synthesised on the card, copied to the CPU). A gradient that stopped at
    the cost volumes would still be non-zero (the extractor also feeds the
    decoders directly), so each extractor tensor's gradient is held against
    the CPU's on its own."""
    from dbsr_tpu_torch.data.procedural import (dead_leaves_image,
                                                make_generator)
    from dbsr_tpu_torch.data.synthetic import BurstConfig, synthesize_batch
    from dbsr_tpu_torch.models.align_lite import BurstAlignLite
    from dbsr_tpu_torch.models.layers import init_params
    from dbsr_tpu_torch.models.pwcnet import BurstFlowNet
    from dbsr_tpu_torch.serving import float32_math
    from dbsr_tpu_torch.training.actors import (make_flow_actor,
                                                make_lite_flow_actor)

    net_cls, make_actor, per_step, extractor = (
        (BurstFlowNet, make_flow_actor, LAUNCHES_PER_PWC_PRETRAIN_STEP,
         "alignment_net.net.extractor.") if pwc else
        (BurstAlignLite, make_lite_flow_actor, LAUNCHES_PER_PRETRAIN_STEP,
         "alignment_net.extractor."))

    cfg = BurstConfig(fused_resample=True)
    gen = make_generator(dev, 21)
    with float32_math():
        batch = synthesize_batch(
            gen, dead_leaves_image(gen, TRAIN_B, cfg.pre_crop_sz), cfg)
    out = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        net = init_params(net_cls(), make_generator("cpu", 22))
        net = net.to(device)
        b = {k: batch[k].to(device) for k in ("burst", "flow")}
        reset_counts()
        with float32_math():
            loss, stats = make_actor(net)(b)
            loss.backward()
        if device == "cuda":
            torch.cuda.synchronize()
            counts = read_counts()
            want = dict(per_step, resample=0)
            if counts != want:
                raise AssertionError(f"pretrain step: launches {counts}, "
                                     f"expected {want}")
        out[device] = (loss.item(), _grads(net), time.perf_counter() - t0)
        del net
    return card_vs_cpu(f"pretrain step (fresh {net_cls.__name__}, "
                       f"B={TRAIN_B}, N={TRAIN_N})", out, extractor)


def entry_phase(module, config, kwargs, epochs_list, per_step_want,
                net_name, round_launches=0):
    """Drive ``run_training(module, config, ...)`` once for each entry of
    ``epochs_list`` (each run resumes from the one before), the launch
    counters reset just before each run and read just after: each kernel
    must have launched exactly ``per_step_want`` times per train step, and
    the dead-leaves composite besides ``round_launches`` times an epoch
    (the train pool's round; no val pass runs). Returns the launches per
    step (the renders apart), the logged running stats by name, the printed
    text and the checkpoint headers by epoch."""
    from dbsr_tpu_torch.run_training import run_training
    from dbsr_tpu_torch.training.checkpoint import (list_checkpoints,
                                                    read_header)

    steps = kwargs["steps_per_epoch"]
    logged, texts, per_step, done = defaultdict(list), [], None, 0
    for epochs in epochs_list:
        buf = io.StringIO()
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            state = run_training(module, config, epochs=epochs, **kwargs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        text = buf.getvalue()
        texts.append(text)
        for line in text.splitlines():
            log(f"  | {line}")
        ran = (epochs - done) * steps
        renders = (epochs - done) * round_launches
        check_counts(f"run_training {module} {config} epochs={epochs}",
                     counts, ran, per_step_want, renders)
        per_step = per_step_of(counts, ran, renders)
        if state.step != epochs * steps:
            raise AssertionError(f"step {state.step} after {epochs} epochs")
        if "Training crashed" in text or "ivergence" in text:
            raise AssertionError("run_training restarted an epoch")
        if done and not re.search(rf"resumed from \S+_ep{done:04d}\.ckpt "
                                  rf"\(epoch {done}", text):
            raise AssertionError(f"the run did not resume from epoch {done}")
        for name, v in re.findall(r"(\S+/\S+): (-?[\d.]+(?:e-?\d+)?|nan|inf)",
                                  text):
            logged[name].append(float(v))
        log(f"run_training {module} {config} epochs={epochs}: {wall:.1f} s "
            f"wall")
        done = epochs
    workspace = os.path.join(os.environ["DBSR_TPU_WORKSPACE_DIR"], module,
                             config)
    ckpts = list_checkpoints(workspace, net_name)
    log(f"checkpoints: {[os.path.basename(p) for _, p in ckpts]}")
    if not ckpts or ckpts[-1][0] != epochs_list[-1]:
        raise AssertionError(f"no epoch-{epochs_list[-1]} checkpoint")
    losses = logged["Loss/total"]
    if not losses or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"logged losses not all finite: {losses}")
    log(f"logged running losses: {losses}")
    return per_step, dict(logged), texts, {e: read_header(p)
                                           for e, p in ckpts}


def training_entry_phase():
    """Phase 7b: the training entry with the banked aligner, one epoch, then
    a second resumed from the first; the main path's exact launch counts per
    train step."""
    kwargs = dict(SMOKE_SETTINGS, pwc_checkpoint=ALIGN_LITE)
    log(f"run_training cuts against default_synthetic: steps_per_epoch "
        f"{kwargs['steps_per_epoch']} of 1000, epochs 2 of 100, pool_size "
        f"{kwargs['pool_size']} of 2048; no val pass (every 5 epochs); "
        f"full width, B={TRAIN_B}, N={TRAIN_N}, 384^2 crops")
    per_step, logged, _, _ = entry_phase(
        "dbsr", "default_synthetic", kwargs, (1, 2), LAUNCHES_PER_TRAIN_STEP,
        "dbsr_synthetic", pool_round_launches(kwargs["pool_size"]))
    return per_step, logged["Loss/total"]


def zero_flow_epe(dev, epoch):
    """The end-point error of the zero flow on the batches that epoch
    ``epoch`` of the smoke pretraining trained on: the mean norm of the
    target (the negated synthesis flow pooled to the packed grid), over the
    same pools, crops and draws, made again from the trainer's own stream."""
    from dbsr_tpu_torch.configs.align_lite import pretrain_synthetic
    from dbsr_tpu_torch.serving import float32_math
    from dbsr_tpu_torch.training.actors import (end_point_error,
                                                pack_flow_to)

    trainer = pretrain_synthetic.make_trainer(_settings(**PRETRAIN_SETTINGS),
                                              dev)
    trainer.epoch = epoch
    loader = trainer.loaders[0]
    gen = trainer.cycle_generator(loader)
    total = torch.zeros((), device=dev)
    with torch.no_grad(), float32_math():
        for _ in range(loader.num_batches()):
            batch = trainer.prepare_fn(gen, loader.batcher.next_batch())
            h, w = batch["burst"].shape[2:4]
            gt = pack_flow_to(-batch["flow"][:, 1:], (h, w))
            total += end_point_error(gt).mean()
    return float(total) / loader.num_batches()


def pretrain_entry_phase(dev):
    """Phase 8b: ``run_training("align_lite", "pretrain_synthetic")`` for
    one epoch, then a second resumed from the first; the exact launches per
    pretraining step; the epoch's mean ``Stat/epe`` must fall from the first
    epoch to the second and end below the zero-flow EPE of the second
    epoch's own batches."""
    log(f"run_training cuts against align_lite/pretrain_synthetic: "
        f"steps_per_epoch {PRETRAIN_STEPS} of 1000, epochs 2 of 15, pool_size "
        f"{PRETRAIN_SETTINGS['pool_size']} of 2048; no val pass (every 5 "
        f"epochs); full width, B={TRAIN_B}, N={TRAIN_N}, 384^2 crops")
    per_step, logged, _, headers = entry_phase(
        "align_lite", "pretrain_synthetic", dict(PRETRAIN_SETTINGS), (1, 2),
        LAUNCHES_PER_PRETRAIN_STEP, "align_lite",
        pool_round_launches(PRETRAIN_SETTINGS["pool_size"]))
    epe = {e: h["stats"]["train"]["Stat/epe"] for e, h in headers.items()}
    acc = {e: h["stats"]["train"]["Stat/acc_0.5px"]
           for e, h in headers.items()}
    zero = {e: zero_flow_epe(dev, e) for e in (1, 2)}
    log(f"pretraining, mean Stat/epe by epoch (packed px): {epe}; zero-flow "
        f"EPE of the same batches: {zero}; Stat/acc_0.5px: {acc}; running "
        f"Stat/epe as logged: {logged['Stat/epe']}")
    if headers[2]["net_spec"]["cls"] != "BurstAlignLite":
        raise AssertionError(f"checkpoint header: {headers[2]['net_spec']}")
    if not epe[2] < epe[1]:
        raise AssertionError(f"Stat/epe did not fall: {epe}")
    if not epe[2] < zero[2]:
        raise AssertionError(f"Stat/epe {epe[2]} of epoch 2 is not below the "
                             f"zero-flow EPE {zero[2]} of its batches")
    return per_step, dict(epe_by_epoch=epe, zero_flow_epe_by_epoch=zero,
                          acc_half_px_by_epoch=acc,
                          running_epe=logged["Stat/epe"])


def _step_part(evt):
    """The part of the train step whose host code launched a profiled
    operator: the labels the profile phase puts on synthesis and the
    forward, the autograd engine's nodes, torch.optim's own label."""
    while evt is not None:
        if evt.name in ("synthesis", "forward"):
            return evt.name
        if evt.name.startswith("autograd::engine::evaluate_function"):
            return "backward"
        if evt.name.startswith("Optimizer.step"):
            return "optimizer"
        evt = evt.cpu_parent
    return "other"


def _labelled(label, fn):
    def call(*args):
        with torch.profiler.record_function(label):
            return fn(*args)
    return call


def _settings(**kwargs):
    from dbsr_tpu_torch.environment import Settings

    settings = Settings()
    for k, v in kwargs.items():
        setattr(settings, k, v)
    return settings


def default_synthetic_trainer(dev, **kwargs):
    """``default_synthetic``'s trainer from a fresh network with the found
    or given aligner grafted (a fresh PWC-Net trained with the rest where
    there is none), on a pool of one batch."""
    from dbsr_tpu_torch.configs.dbsr.default_synthetic import (
        graft_alignment_params, make_trainer)

    with contextlib.redirect_stdout(io.StringIO()):
        trainer, flow_ckpt = make_trainer(
            _settings(**dict(SMOKE_SETTINGS, pool_size=TRAIN_B, **kwargs)),
            dev)
    state = trainer.init_state()
    if flow_ckpt is not None:
        graft_alignment_params(trainer.net, flow_ckpt)
    return trainer, state


def pretrain_trainer(dev, pwc=False):
    """``align_lite/pretrain_synthetic``'s (with ``pwc``,
    ``pwcnet/pretrain_synthetic``'s) trainer from a fresh network, on a pool
    of one batch."""
    from dbsr_tpu_torch.configs.align_lite import pretrain_synthetic
    from dbsr_tpu_torch.configs.pwcnet import pretrain_synthetic as pwc_config

    config, settings = ((pwc_config, PWC_PRETRAIN_SETTINGS) if pwc else
                        (pretrain_synthetic, PRETRAIN_SETTINGS))
    trainer = config.make_trainer(
        _settings(**dict(settings, pool_size=TRAIN_B)), dev)
    return trainer, trainer.init_state()


def step_phase(dev, what, trainer, state, per_step_want, n_steps=20,
               batch_size=TRAIN_B, loss_must_fall=True):
    """Phases 7c-7d, 8c, 9 and 13e: ``n_steps`` Adam steps of ``trainer`` on
    one fixed batch of ``batch_size`` (the generator is reseeded each step,
    so the crop draw and synthesis repeat), timed by CUDA events, the loss
    must fall (unless ``loss_must_fall`` is False: fine-tuning at 1e-5 from
    a trained network, where it is logged); then a profile of three train
    steps, its device time by part of the step (synthesis, or the real
    batch's copy to the device; forward, backward, optimizer) and by kernel
    group."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dbsr_tpu_torch.data.procedural import make_generator
    from dbsr_tpu_torch.profile_serving import kernel_group, kernel_us

    pool = trainer.loaders[0].batcher.next_batch()

    losses, times = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(n_steps):
        if i == 3:
            reset_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        stats = trainer.train_step(state, make_generator(dev, 7), pool)
        end.record()
        if i == 3:
            torch.cuda.synchronize()
            check_counts(f"one step, {what}", read_counts(), 1,
                         per_step_want)
        losses.append(stats["Loss/total"])
        times.append((start, end))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(v) for v in losses]
    step_ms = statistics.median(s.elapsed_time(e) for s, e in times[5:])
    log(f"{what}: fixed batch, {n_steps} Adam steps from a fresh network: "
        f"loss {losses[0]:.6f} -> {losses[-1]:.6f}; all: "
        + ", ".join(f"{v:.5f}" for v in losses))
    if loss_must_fall and not losses[-1] < losses[0]:
        raise AssertionError(f"{what}: the loss did not fall over {n_steps} "
                             f"steps on one batch")
    log(f"{what}: step at B={batch_size}: median {step_ms:.2f} ms (CUDA "
        f"events, steps 6-{n_steps}), {batch_size / step_ms * 1e3:.2f} "
        f"samples/s, peak memory {peak:.2f} GiB")
    gen = make_generator(dev, 8)
    synth_ms = cuda_ms(lambda: trainer.prepare_fn(gen, pool), 1, 5)

    gen = make_generator(dev, 9)
    trainer.prepare_fn = _labelled("synthesis", trainer.prepare_fn)
    trainer.actor_fn = _labelled("forward", trainer.actor_fn)
    for _ in range(2):
        trainer.train_step(state, gen, pool)
    torch.cuda.synchronize()
    steps = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            trainer.train_step(state, gen, pool)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [(e.key, kernel_us(e), e.count) for e in prof.key_averages()]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    busy_us = sum(r[1] for r in rows)
    if busy_us == 0:
        raise AssertionError("the profile holds no device time")
    groups = defaultdict(float)
    for name, us, _ in rows:
        groups[kernel_group(name)] += us
    log(f"{what}: profile of {steps} train steps: wall {wall_us / steps / 1e3:.2f} "
        f"ms/step, device busy {busy_us / steps / 1e3:.2f} ms/step "
        f"({100 * busy_us / wall_us:.1f}% of wall); synthesis (prepare "
        f"alone, CUDA events) {synth_ms:.2f} ms")
    for name, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"  {name}: {us / steps / 1e3:.3f} ms/step "
            f"({100 * us / busy_us:.1f}%)")
    log("  top kernels (ms/step, launches/step):")
    for name, us, n in rows[:12]:
        log(f"    {us / steps / 1e3:8.3f}  {n / steps:6.1f}  {name[:90]}")
    # each kernel in the part of the step whose host operator launched it;
    # what the profiler links to no operator (some of the kernels launched
    # through ctypes) is listed as not placed
    split = defaultdict(lambda: defaultdict(float))
    for evt in prof.events():
        if evt.device_type == DeviceType.CPU:
            for k in evt.kernels:
                split[_step_part(evt)][kernel_group(k.name)] += \
                    k.duration / steps / 1e3
    placed = sum(sum(g.values()) for g in split.values())
    for group, us in groups.items():
        rest = us / steps / 1e3 - sum(g.get(group, 0.0)
                                      for g in split.values())
        if rest > 5e-4:
            split["not placed"][group] = rest
    log(f"  by part of the step ({100 * placed * steps * 1e3 / busy_us:.1f}% "
        f"of the device time placed), ms/step:")
    for part, g in sorted(split.items(), key=lambda kv: -sum(kv[1].values())):
        log(f"    {part}: {sum(g.values()):.3f} (" + ", ".join(
            f"{k} {v:.3f}" for k, v in sorted(g.items(),
                                                key=lambda kv: -kv[1])) + ")")
    return dict(step_ms=step_ms, samples_per_s=batch_size / step_ms * 1e3,
                peak_mem_gib=peak, fixed_batch_losses=losses,
                synthesis_ms=synth_ms,
                profile_ms_per_step={k: v / steps / 1e3
                                     for k, v in groups.items()},
                profile_ms_per_step_by_part={p: dict(g)
                                             for p, g in split.items()},
                device_busy_share=busy_us / wall_us)


def closing_phase(dev):
    """Phase 9: in the workspace that the smoke pretraining wrote,
    ``default_synthetic`` with no ``pwc_checkpoint`` finds the port's own
    aligner checkpoint, grafts it and takes a few steps frozen; asking the
    same workspace for ``train_alignment=True`` is refused; from a fresh
    ``dbsr`` workspace it takes a few steps with the aligner unfrozen. Then
    one unfrozen step's gradients against the CPU's (B=1), and the unfrozen
    step's time and peak memory at B=16."""
    import shutil

    from dbsr_tpu_torch.run_training import run_training
    from dbsr_tpu_torch.training.checkpoint import resolve_checkpoint

    workspace = os.environ["DBSR_TPU_WORKSPACE_DIR"]
    flow_ckpt = resolve_checkpoint(os.path.join(
        workspace, "align_lite", "pretrain_synthetic"), "align_lite")
    out = {}
    for name, extra, want in (
            ("frozen", {}, LAUNCHES_PER_TRAIN_STEP),
            ("train_alignment", {"train_alignment": True},
             LAUNCHES_PER_UNFROZEN_STEP)):
        kwargs = dict(SMOKE_SETTINGS, steps_per_epoch=5, **extra)
        if extra:
            try:
                with contextlib.redirect_stdout(io.StringIO()):
                    run_training("dbsr", "default_synthetic", epochs=2,
                                 **kwargs)
            except ValueError as e:
                if "cross-restore" not in str(e):
                    raise
                log(f"resume of the frozen run's workspace with "
                    f"train_alignment=True refused: {e}")
            else:
                raise AssertionError("a masked workspace resumed unmasked")
            shutil.rmtree(os.path.join(workspace, "dbsr"))
        per_step, logged, texts, headers = entry_phase(
            "dbsr", "default_synthetic", kwargs, (1,), want, "dbsr_synthetic",
            pool_round_launches(kwargs["pool_size"]))
        if (f"using pretrained flow weights: {flow_ckpt} (flow_net=lite, "
                f"train_alignment={bool(extra)})") not in texts[0] \
                or "grafted pretrained flow weights" not in texts[0]:
            raise AssertionError(f"{name}: the port's own aligner checkpoint "
                                 f"{flow_ckpt} was not found and grafted")
        if headers[1]["settings"] != {"masked_adam": not extra}:
            raise AssertionError(f"{name}: header {headers[1]['settings']}")
        out[name] = dict(launches_per_step=per_step,
                         losses=logged["Loss/total"])
    torch.cuda.empty_cache()
    out["card_vs_cpu"] = grad_phase(train_alignment=True,
                                    flow_ckpt=flow_ckpt)
    torch.cuda.empty_cache()
    trainer, state = default_synthetic_trainer(dev, train_alignment=True)
    out["step"] = step_phase(dev, "default_synthetic, train_alignment=True",
                             trainer, state, LAUNCHES_PER_UNFROZEN_STEP,
                             n_steps=10)
    return out


def serve(what, pred, requests, per_forward):
    """Phases 4 and 10a: the three requests with the launch counters reset
    just before and read just after (each kernel exactly ``per_forward``
    times per forward, the rest never), outputs checked; then the median
    request at batch 8 (host clock: it ends in a copy to the host), the
    forward by CUDA events and the peak memory of the timed requests."""
    reset_counts()
    torch.cuda.synchronize()
    outs = [pred(r) for r in requests]
    torch.cuda.synchronize()
    launches = read_counts()
    log(f"{what}: launches over the three requests (3 forwards): {launches}")
    for r, o in zip(requests, outs):
        n = r.shape[0] if r.ndim == 5 else 1
        if o.shape != (n, HW * 8, HW * 8, 3):
            raise AssertionError(f"output shape {o.shape} for {n} bursts")
        if not np.isfinite(o).all() or o.min() < 0 or o.max() > 1:
            raise AssertionError("output not finite or outside [0, 1]")
    for k in launches:
        want = per_forward.get(k, 0)  # no backward here
        if launches[k] != want * len(requests):
            raise AssertionError(f"{what}: {k}: {launches[k]} launches in "
                                 f"{len(requests)} forwards, expected {want} "
                                 f"per forward")
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(2):
        pred(requests[0])
    for _ in range(5):
        t0 = time.perf_counter()
        pred(requests[0])  # ends in a copy to the host: synchronous
        times.append(time.perf_counter() - t0)
    req_s = statistics.median(times)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    x = torch.from_numpy(requests[0]).to(pred.device)
    fwd_ms = cuda_ms(lambda: pred.forward(x), 1, 5)
    log(f"{what}: request at batch {B}: median {req_s * 1e3:.1f} ms over 5 "
        f"({B / req_s:.2f} bursts/s), peak memory {peak:.2f} GiB; forward "
        f"{fwd_ms:.2f} ms (CUDA events)")
    return dict(bursts_per_s=B / req_s, request_ms=req_s * 1e3,
                forward_ms=fwd_ms, peak_mem_gib=peak, launches=launches)


def forward_vs_cpu(pred, burst, ckpt=None, **net_kwargs):
    """Phases 5, 10b and 12b: the card's forward of ``pred`` (kernels)
    against the CPU's (plain versions) of the banked flagship (or ``ckpt``)
    rebuilt with ``net_kwargs``, on one burst; the largest difference of the
    [0, 1] output, which must stay within CARD_VS_CPU_TOL."""
    from dbsr_tpu_torch.serving import FLAGSHIP_CHECKPOINT
    from dbsr_tpu_torch.training.checkpoint import load_network

    cpu_net, _ = load_network(ckpt or FLAGSHIP_CHECKPOINT, device="cpu",
                              dtype=None, **net_kwargs)
    on_card = pred.forward(torch.from_numpy(burst).to(pred.device))
    on_card = on_card.clamp(0, 1).cpu()
    with torch.inference_mode():
        t0 = time.perf_counter()
        on_cpu = cpu_net(torch.from_numpy(burst))[0].clamp(0, 1)
    cpu_s = time.perf_counter() - t0
    diff = (on_card - on_cpu).abs().max().item()
    log(f"card (kernels) vs CPU (plain) forward, 1 burst, "
        f"{os.path.basename(ckpt or FLAGSHIP_CHECKPOINT)} {net_kwargs}, "
        f"{FINE_PATCH_ENV}={os.environ.get(FINE_PATCH_ENV)}: max|diff| "
        f"{diff:.3e} (limit {CARD_VS_CPU_TOL}); CPU forward {cpu_s:.1f} s")
    if not diff <= CARD_VS_CPU_TOL:
        raise AssertionError(f"card vs CPU: {diff} > {CARD_VS_CPU_TOL}")
    return diff


@contextlib.contextmanager
def fine_patch(on):
    """``DBSR_FINE_PATCH_S2D`` set to 1 (``on``: the s2d conv kernel) or 0
    (the structured-dense conv) for the block, then as it was before."""
    saved = os.environ.pop(FINE_PATCH_ENV, None)
    os.environ[FINE_PATCH_ENV] = "1" if on else "0"
    try:
        yield
    finally:
        os.environ.pop(FINE_PATCH_ENV, None)
        if saved is not None:
            os.environ[FINE_PATCH_ENV] = saved


def s2d_phase(dev, requests):
    """Phase 10: the s2d decoder, the entry points' default, through the
    entry points: serving in the three decoder forms (10a-b), one train
    step's gradients against the CPU's (10c), ``run_training`` (10d) and
    the B=16 step (10e). Returns the launches of the three requests with
    the switch (``launches``) and per ``run_training`` step
    (``launches_per_step``) beside the measurements."""
    from dbsr_tpu_torch.serving import FLAGSHIP_CHECKPOINT, load_predictor

    out = {"serving_b8": {}, "step": {}}
    for form, on, kwargs in (("s2d_kernel", True, {}),
                             ("s2d_dense", False, {}),
                             ("fine", False, {"fused_s2d": False})):
        with fine_patch(on):
            pred = load_predictor(FLAGSHIP_CHECKPOINT, batch_size=B,
                                  burst_size=N, burst_hw=(HW, HW),
                                  device="cuda", dtype=None, **kwargs)
            if pred.net.decoder.s2d != (form != "fine"):
                raise AssertionError(f"{form}: decoder s2d "
                                     f"{pred.net.decoder.s2d}")
            res = serve(f"serving, {form} decoder", pred, requests,
                        dict(LAUNCHES_PER_FORWARD, conv_s2d=(
                            LAUNCHES_S2D_PER_FORWARD if on else 0)))
            if on:
                out["launches"] = res.pop("launches")
                res["card_vs_cpu_max_abs"] = forward_vs_cpu(pred,
                                                            requests[2][None])
            else:
                del res["launches"]
        out["serving_b8"][form] = res
        del pred
        torch.cuda.empty_cache()

    with fine_patch(True):
        out["card_vs_cpu"] = grad_phase(s2d=True)
        want = dict(LAUNCHES_PER_S2D_STEP, resample=0)  # CPU synthesis
        if out["card_vs_cpu"]["launches"] != want:
            raise AssertionError(f"s2d train step: launches "
                                 f"{out['card_vs_cpu']['launches']}, "
                                 f"expected {want}")
        torch.cuda.empty_cache()
        kwargs = dict(SMOKE_SETTINGS, steps_per_epoch=5,
                      pwc_checkpoint=ALIGN_LITE, fused_s2d_decoder=True)
        per_step, logged, _, headers = entry_phase(
            "dbsr", "default_synthetic", kwargs, (1,), LAUNCHES_PER_S2D_STEP,
            "dbsr_synthetic", pool_round_launches(kwargs["pool_size"]))
        if not headers[1]["net_spec"]["kwargs"]["fused_s2d_decoder"]:
            raise AssertionError(f"header: {headers[1]['net_spec']}")
        out["launches_per_step"] = per_step
        out["run_training_losses"] = logged["Loss/total"]
        torch.cuda.empty_cache()
    for form, on in (("s2d_kernel", True), ("s2d_dense", False)):
        with fine_patch(on):
            trainer, state = default_synthetic_trainer(
                dev, pwc_checkpoint=ALIGN_LITE, fused_s2d_decoder=True)
            out["step"][form] = step_phase(
                dev, f"default_synthetic, {form} decoder", trainer, state,
                LAUNCHES_PER_S2D_STEP if on else LAUNCHES_PER_TRAIN_STEP,
                n_steps=10)
        del trainer, state
        torch.cuda.empty_cache()
    return out



def _scored(what, nets, root, per_forward, n_forwards, **kwargs):
    """One ``compute_score`` of ``nets`` (MS-SSIM on, no LPIPS) on the card
    with the launch counters reset just before and read just after: each
    kernel exactly ``per_forward`` times per forward of each net, the rest
    never. Returns the scores and the run's numbers: wall seconds, the
    parts of its timing per network, peak memory, launches."""
    from dbsr_tpu_torch.evaluation import synburst

    buf = io.StringIO()
    timing = {}
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        scores = synburst.compute_score(nets, root, with_lpips=False,
                                        with_msssim=True, device="cuda",
                                        timing=timing, **kwargs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = read_counts()
    for line in buf.getvalue().splitlines():
        log(f"  | {line}")
    want = {k: per_forward.get(k, 0) * n_forwards * len(nets)
            for k in launches}
    log(f"{what}: launches {launches}; {wall:.2f} s wall, peak memory "
        f"{peak:.2f} GiB")
    if launches != want:
        raise AssertionError(f"{what}: launches {launches}, expected {want}")
    per_burst = {}
    for name, t in timing.items():
        n = t["bursts"]
        per_burst[name] = dict(
            bursts=n, ms_per_burst=t["wall_s"] * 1e3 / n,
            device_ms_per_burst=t["device_ms"] / n,
            reader_ms_per_burst=t["reader_s"] * 1e3 / n,
            waited_ms_per_burst=t["waited_s"] * 1e3 / n,
            transfer_ms_per_burst=t["transfer_s"] * 1e3 / n,
            fetch_ms=t["fetch_s"] * 1e3)
    if set(per_burst) != {n.get_display_name() for n in nets}:
        raise AssertionError(f"{what}: timing of {sorted(per_burst)}")
    return scores, dict(wall_s=wall, timing=per_burst, peak_mem_gib=peak,
                        launches=launches)


def _scores_close(what, got, want, db_tol, tol):
    """Every score of ``got`` against ``want``: PSNR within ``db_tol`` dB,
    SSIM and MS-SSIM within ``tol``. Returns the largest differences."""
    diffs = {}
    for m in want:
        for name, v in want[m].items():
            diffs[(m, name)] = abs(got[m][name] - v)
    worst = {m: max(d for (mm, _), d in diffs.items() if mm == m)
             for m in want}
    log(f"{what}: largest |difference| {worst} (limits {db_tol} dB, {tol})")
    for (m, name), d in diffs.items():
        if not d <= (db_tol if m == "psnr" else tol):
            raise AssertionError(f"{what}: {m} of {name}: {got[m][name]} vs "
                                 f"{want[m][name]}")
    return worst


def _banked_score(ckpt):
    """The JAX package's own score of a banked checkpoint's epoch, from the
    campaign's trajectory file beside it (bf16, its own val set): context,
    not a limit."""
    from dbsr_tpu_torch.training.checkpoint import read_header

    epoch = read_header(ckpt)["epoch"]
    path = ckpt.replace("_best_params.ckpt", "_trajectory.jsonl")
    found = None
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            if rec.get("epoch") == epoch:
                found = rec  # the last record of the epoch
    return epoch, found and (found["psnr"], found["ssim"])


def float32_copy(ckpt, workdir):
    """A copy of ``ckpt`` under ``workdir`` whose header records no compute
    dtype: the float32 net, which the eval entries build from it (they
    build the dtype a checkpoint records, bf16 for the banked ones)."""
    from dbsr_tpu_torch.training.checkpoint import (read_checkpoint,
                                                    write_checkpoint)

    path = os.path.join(workdir, "float32", os.path.basename(ckpt))
    if not os.path.exists(path):
        header, tree = read_checkpoint(ckpt)
        header["net_spec"]["kwargs"]["dtype"] = None
        write_checkpoint(path, header, tree)
    return path


def card_vs_cpu_scores(root, ckpt, n_bursts,
                       tols=(EVAL_PSNR_TOL, EVAL_SSIM_TOL)):
    """Phases 11c and 14c: the per-burst scores of the first ``n_bursts``
    bursts on the card (kernels) and on the CPU (plain versions), the same
    checkpoint (at the dtype it records) and the same fused
    forward-quantize-score function, within ``tols`` (dB; SSIM and
    MS-SSIM)."""
    from dbsr_tpu_torch.data.datasets import SyntheticBurstVal
    from dbsr_tpu_torch.evaluation import synburst
    from dbsr_tpu_torch.evaluation.network_param import NetworkParam
    from dbsr_tpu_torch.models.layers import compute_dtype_of

    ds = SyntheticBurstVal(root)
    bursts = synburst._host_u16(np.stack([ds[i][0] for i in range(n_bursts)]))
    gts = synburst._host_u16(np.stack([ds[i][1] for i in range(n_bursts)]))
    per_burst = {}
    for device in ("cuda", "cpu"):
        net, _ = NetworkParam(checkpoint_path=ckpt).load_net("", device)
        dtype = compute_dtype_of(net) or torch.float32
        fn = synburst._scored_forward_fn(
            net, synburst._make_score_batch(EVAL_BOUNDARY, True))
        s = fn(torch.from_numpy(bursts).to(device),
               torch.from_numpy(gts).to(device))
        per_burst[device] = {m: {str(i): float(v[i]) for i in
                                 range(n_bursts)} for m, v in s.items()}
        del net
    worst = _scores_close(f"card vs CPU, per burst, first {n_bursts} bursts"
                          f" ({str(dtype).replace('torch.', '')})",
                          per_burst["cuda"], per_burst["cpu"], *tols)
    return dict(per_burst=per_burst, max_abs=worst)


def eval_phase(workdir, train_workspace):
    """Phase 11, the SyntheticBurstVal protocol through the port's entry
    points: (a) the val set generated on the card; (b) ``compute_score`` of
    the flagship and r4mix over it; (c) per-burst scores, card vs CPU; (d)
    ``save_results`` rescored; (e) ``run_evaluation``'s CLI against the API
    on phase 7b's workspace; (f) the flagship with the structured-dense
    conv. Returns the numbers and the phase's launches (``eval``: the
    generation and the flagship's scoring)."""
    from dbsr_tpu_torch import generate_synthetic_burst_val as gen
    from dbsr_tpu_torch import run_evaluation
    from dbsr_tpu_torch.data.datasets import SyntheticBurstVal
    from dbsr_tpu_torch.evaluation import synburst
    from dbsr_tpu_torch.evaluation.network_param import NetworkParam
    from dbsr_tpu_torch.serving import FLAGSHIP_CHECKPOINT
    from dbsr_tpu_torch.training.checkpoint import list_checkpoints

    n_bursts = EVAL_BURSTS
    n_forwards = -(-n_bursts // EVAL_BATCH)
    out = {"bursts": n_bursts, "forwards_per_net": n_forwards}
    root = os.path.join(workdir, "synburst_val")

    # (a) the val set, through the generator's entry
    argv = ["--procedural", str(EVAL_PROCEDURAL), "--num_bursts",
            str(n_bursts),
            "--seed", str(EVAL_SEED), "--out_dir", root]
    buf = io.StringIO()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        gen.main(argv)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    gen_launches = read_counts()
    log(f"generate_synthetic_burst_val {' '.join(argv[:-2])}: {gen_s:.2f} s "
        f"({gen_s * 1e3 / n_bursts:.1f} ms per burst); launches "
        f"{gen_launches}; {buf.getvalue().splitlines()[-1]}")
    want = {k: 0 for k in gen_launches}
    want.update(resample=n_bursts,
                dead_leaves_composite=pool_round_launches(EVAL_PROCEDURAL))
    if gen_launches != want:
        raise AssertionError(f"generator: launches {gen_launches}, expected "
                             f"{want} (one strict resample per burst, one "
                             f"composite a chunk of the source pool)")
    ds = SyntheticBurstVal(root)
    burst, gt, meta = ds[n_bursts - 1]
    if (len(ds) != n_bursts or burst.shape != (N, HW, HW, 4)
            or gt.shape != (HW * 8, HW * 8, 3) or ds.cv2_channel_order
            or meta["burst_name"] != f"{n_bursts - 1:04d}"):
        raise AssertionError(f"val set: {len(ds)} bursts, {burst.shape}, "
                             f"{gt.shape}, {meta}")
    out["generate"] = dict(wall_s=gen_s, ms_per_burst=gen_s * 1e3 / n_bursts,
                           launches=gen_launches)

    # (b) the zoo's three networks, through the API, on float32 copies
    banked = {os.path.basename(c).replace("_best_params.ckpt", ""): c
              for c in (FLAGSHIP_CHECKPOINT, R4MIX_CHECKPOINT,
                        R3D_CHECKPOINT)}
    nets = [NetworkParam(checkpoint_path=float32_copy(c, workdir),
                         display_name=name) for name, c in banked.items()]
    flagship = nets[:1]
    with contextlib.redirect_stdout(io.StringIO()):  # cuDNN's first calls
        synburst.compute_score(flagship, root, with_lpips=False,
                               max_bursts=EVAL_BATCH, device="cuda")
    scores, runs = {}, {}
    for n in nets:
        name = n.get_display_name()
        pwc = banked[name] == R3D_CHECKPOINT
        s, runs[name] = _scored(f"compute_score {name}, {n_bursts} bursts, "
                                f"batch {EVAL_BATCH}", [n], root,
                                LAUNCHES_PER_PWC_FORWARD if pwc
                                else LAUNCHES_PER_S2D_FORWARD, n_forwards)
        for m, v in s.items():
            scores.setdefault(m, {}).update(v)
        if not all(math.isfinite(v[name]) for v in s.values()):
            raise AssertionError(f"{name}: scores not finite: {s}")
        epoch, jax_score = _banked_score(banked[name])
        log(f"{name} (epoch {epoch}, float32): PSNR {s['psnr'][name]:.4f} "
            f"dB, SSIM {s['ssim'][name]:.4f}, MS-SSIM "
            f"{s['msssim'][name]:.4f}; the JAX package's bf16 score of this "
            f"epoch on its own val set (context, not a limit): {jax_score}")
        torch.cuda.empty_cache()
    out["scores"] = scores
    out["runs"] = runs

    # (c) card against CPU, per burst
    out["card_vs_cpu"] = card_vs_cpu_scores(
        root, float32_copy(FLAGSHIP_CHECKPOINT, workdir), EVAL_CPU_BURSTS)
    out["card_vs_cpu_r3d"] = card_vs_cpu_scores(
        root, float32_copy(R3D_CHECKPOINT, workdir), EVAL_CPU_BURSTS)
    torch.cuda.empty_cache()

    # (d) saved predictions rescored
    saved_dir = os.path.join(workdir, "synburst_saved")
    t0 = time.perf_counter()
    synburst.save_results(flagship, root, saved_dir, device="cuda")
    save_s = time.perf_counter() - t0
    saved, saved_run = _scored("compute_score of the saved predictions",
                               flagship, root, {}, 0,
                               saved_results_root=saved_dir)
    flag_scores = {m: {k: v for k, v in d.items() if k in saved[m]}
                   for m, d in scores.items()}
    out["saved"] = dict(save_results_s=save_s, max_abs=_scores_close(
        "saved vs live", saved, flag_scores, EVAL_SAVED_TOL, EVAL_SAVED_TOL),
        run=saved_run)

    # (e) the CLI on phase 7b's workspace, against the API
    saved_env = {k: os.environ.get(k) for k in ("DBSR_TPU_WORKSPACE_DIR",
                                                "DBSR_TPU_SYNBURSTVAL_DIR")}
    os.environ["DBSR_TPU_WORKSPACE_DIR"] = train_workspace
    os.environ["DBSR_TPU_SYNBURSTVAL_DIR"] = root
    try:
        cli = {}
        for key, extra in (("latest", []), ("all_epochs", ["--all_epochs"])):
            path = os.path.join(workdir, f"cli_{key}.json")
            argv = ["synburst", "compute_score", "dbsr_default", "--no_lpips",
                    "--max_bursts", str(EVAL_CLI_BURSTS), "--json", path,
                    *extra]
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                run_evaluation.main(argv)
            log(f"run_evaluation {' '.join(argv)}: "
                f"{time.perf_counter() - t0:.2f} s")
            for line in buf.getvalue().splitlines():
                log(f"  | {line}")
            with open(path) as f:
                cli[key] = json.load(f)
        epochs = [e for e, _ in list_checkpoints(os.path.join(
            train_workspace, "dbsr", "default_synthetic"), "dbsr_synthetic")]
        api = {}
        for epoch in (None, *epochs):
            with contextlib.redirect_stdout(io.StringIO()):
                s = synburst.compute_score(
                    [NetworkParam(module="dbsr",
                                  parameter="default_synthetic",
                                  epoch=epoch)], root,
                    workspace_dir=train_workspace, with_lpips=False,
                    max_bursts=EVAL_CLI_BURSTS, device="cuda")
            for m, v in s.items():
                api.setdefault(m, {}).update(v)
        if sorted(cli["all_epochs"]["psnr"]) != [
                f"dbsr_default_synthetic_ep{e:04d}" for e in epochs]:
            raise AssertionError(f"--all_epochs scored {cli['all_epochs']}, "
                                 f"the workspace holds epochs {epochs}")
        cli_diff = {}
        for key, got in cli.items():
            want = {m: {n: api[m][n] for n in got[m]} for m in got}
            cli_diff[key] = _scores_close(f"CLI --json ({key}) vs API", got,
                                          want, EVAL_SAVED_TOL,
                                          EVAL_SAVED_TOL)
        out["cli"] = dict(scores=cli, max_abs=cli_diff)
    finally:
        for k, v in saved_env.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v

    # (f) the flagship with the structured-dense conv (the kernel is (b)'s)
    with fine_patch(False):
        dense_scores, dense_run = _scored(
            f"compute_score {flagship[0].get_display_name()} with "
            f"{FINE_PATCH_ENV}=0", flagship, root, LAUNCHES_PER_FORWARD,
            n_forwards)
    out["s2d_dense"] = dict(run=dense_run, max_abs=_scores_close(
        "structured-dense conv vs conv_s2d kernel", dense_scores,
        flag_scores, EVAL_PSNR_TOL, EVAL_SSIM_TOL))
    name = flagship[0].get_display_name()
    out["launches"] = {k: gen_launches[k] + runs[name]["launches"][k]
                       for k in gen_launches}
    out["launches_r3d"] = runs["dbsr_campaign_r3d"]["launches"]
    return out

def burst_flow_vs_cpu(dev):
    """Phase 12c: the banked ``BurstFlowNet`` (``pwcnet_synth_params.ckpt``)
    through ``load_network`` on the card and on the CPU, on one synthesised
    batch of B=16, N=8: flows within PWC_FLOW_TOL px."""
    from dbsr_tpu_torch.data.procedural import (dead_leaves_image,
                                                make_generator)
    from dbsr_tpu_torch.data.synthetic import BurstConfig, synthesize_batch
    from dbsr_tpu_torch.serving import float32_math
    from dbsr_tpu_torch.training.checkpoint import load_network

    cfg = BurstConfig(fused_resample=True)
    gen = make_generator(dev, 31)
    with float32_math():
        burst = synthesize_batch(
            gen, dead_leaves_image(gen, TRAIN_B, cfg.pre_crop_sz),
            cfg)["burst"]
    flows = {}
    for device in ("cuda", "cpu"):
        net, header = load_network(PWC_SYNTH, device=device)
        reset_counts()
        with torch.no_grad(), float32_math():
            flows[device] = net(burst.to(device)).cpu()
        if device == "cuda":
            torch.cuda.synchronize()
            counts = read_counts()
            want = {k: LAUNCHES_PER_PWC_FORWARD.get(k, 0) for k in counts}
            # the backwarps alone: no merge, no decoder
            want.update(warp=4, merge=0, conv_s2d=0)
            if counts != want:
                raise AssertionError(f"BurstFlowNet forward: launches "
                                     f"{counts}, expected {want}")
        del net
    diff = float((flows["cuda"] - flows["cpu"]).abs().max())
    mag = float(flows["cpu"].abs().max())
    log(f"BurstFlowNet (epoch {header['epoch']}) B={TRAIN_B}, N={TRAIN_N}, "
        f"card vs CPU: max|diff| {diff:.3e} px (limit {PWC_FLOW_TOL}); "
        f"largest flow {mag:.3f} px")
    if not diff <= PWC_FLOW_TOL:
        raise AssertionError(f"BurstFlowNet card vs CPU: {diff} > "
                             f"{PWC_FLOW_TOL} px")
    return dict(max_abs_px=diff, largest_flow_px=mag)


def pwc_pretrain_entry_phase():
    """Phase 12d: ``run_training("pwcnet", "pretrain_synthetic")`` for one
    epoch, then a second resumed from the first; the exact launches per
    step and finite losses. A fresh PWC-Net stays on the zero-flow plateau
    for thousands of steps (the banked epoch-15 checkpoint reads EPE 2.29
    against a zero-flow 2.31), so no fall of ``Stat/epe`` is asked here."""
    log(f"run_training cuts against pwcnet/pretrain_synthetic: "
        f"steps_per_epoch {PWC_PRETRAIN_SETTINGS['steps_per_epoch']} of 1000, "
        f"epochs 2 of 15, pool_size {PWC_PRETRAIN_SETTINGS['pool_size']} of "
        f"2048; no val pass (every 5 epochs); full width, B={TRAIN_B}, "
        f"N={TRAIN_N}, 384^2 crops")
    per_step, logged, _, headers = entry_phase(
        "pwcnet", "pretrain_synthetic", dict(PWC_PRETRAIN_SETTINGS), (1, 2),
        LAUNCHES_PER_PWC_PRETRAIN_STEP, "pwcnet_synth",
        pool_round_launches(PWC_PRETRAIN_SETTINGS["pool_size"]))
    if headers[2]["net_spec"]["cls"] != "BurstFlowNet":
        raise AssertionError(f"checkpoint header: {headers[2]['net_spec']}")
    epe = {e: h["stats"]["train"]["Stat/epe"] for e, h in headers.items()}
    log(f"PWC-Net pretraining, mean Stat/epe by epoch (packed px): {epe}; "
        f"running Stat/epe as logged: {logged['Stat/epe']}")
    return per_step, dict(epe_by_epoch=epe, losses=logged["Loss/total"])


def pwc_default_synthetic_phase(dev, workdir):
    """Phase 12e: ``default_synthetic`` through ``run_training`` with PWC-Net:
    in the workspace of 12d, the ``pwcnet_synth`` checkpoint found, grafted
    and frozen, 5 steps; in a fresh workspace, no checkpoint at all: the
    fallback (a fresh PWC-Net trained end to end), 5 steps; exact launches
    per step for each, and each one's B=16 step time and peak memory (10
    Adam steps on one fixed batch, the loss must fall). Then one unfrozen
    step of r3d (B=1) against the CPU's."""
    from dbsr_tpu_torch.training.checkpoint import resolve_checkpoint

    workspace = os.environ["DBSR_TPU_WORKSPACE_DIR"]
    flow_ckpt = resolve_checkpoint(os.path.join(
        workspace, "pwcnet", "pretrain_synthetic"), "pwcnet_synth")
    out = {}
    kwargs = dict(SMOKE_SETTINGS, steps_per_epoch=5)
    for name, ws, want, said in (
            ("frozen", workspace, LAUNCHES_PER_PWC_FROZEN_STEP,
             f"using pretrained flow weights: {flow_ckpt} (flow_net=pwc, "
             f"train_alignment=False)"),
            ("fallback", os.path.join(workdir, "pwc_fallback"),
             LAUNCHES_PER_PWC_UNFROZEN_STEP,
             "WARNING: no pretrained flow checkpoint found")):
        os.environ["DBSR_TPU_WORKSPACE_DIR"] = ws
        per_step, logged, texts, headers = entry_phase(
            "dbsr", "default_synthetic", kwargs, (1,), want, "dbsr_synthetic",
            pool_round_launches(kwargs["pool_size"]))
        spec = headers[1]["net_spec"]["kwargs"]
        if said not in texts[0] or spec["flow_net"] != "pwc" \
                or spec["train_alignment"] != (name == "fallback"):
            raise AssertionError(f"default_synthetic {name}: {spec}")
        torch.cuda.empty_cache()
        trainer, state = default_synthetic_trainer(dev)
        out[name] = dict(launches_per_step=per_step,
                         losses=logged["Loss/total"],
                         step=step_phase(dev, f"default_synthetic, PWC-Net "
                                         f"{name}", trainer, state, want,
                                         n_steps=10))
        del trainer, state
        torch.cuda.empty_cache()
    os.environ["DBSR_TPU_WORKSPACE_DIR"] = workspace
    out["card_vs_cpu"] = grad_phase(train_alignment=True, ckpt=R3D_CHECKPOINT)
    return out


def pwc_phase(dev, requests, workdir):
    """Phase 12, PWC-Net: (b) r3d served, (c) the banked ``BurstFlowNet``
    card vs CPU, (d) PWC-Net pretraining, (e) ``default_synthetic`` frozen
    and in its fallback. Returns the numbers and the launches of each
    path."""
    from dbsr_tpu_torch.models.pwcnet import PWCNet
    from dbsr_tpu_torch.serving import load_predictor

    out, paths = {}, {}
    t0 = time.perf_counter()
    pred = load_predictor(R3D_CHECKPOINT, batch_size=B, burst_size=N,
                          burst_hw=(HW, HW), device="cuda", dtype=None)
    if not (pred.net.decoder.s2d
            and isinstance(pred.net.encoder.alignment_net, PWCNet)):
        raise AssertionError("r3d was not rebuilt with PWC-Net and its s2d "
                             "decoder")
    log(f"r3d predictor loaded in {time.perf_counter() - t0:.1f} s")
    out["serving_r3d_b8"] = serve("serving r3d (PWC-Net, s2d decoder)", pred,
                                  requests, LAUNCHES_PER_PWC_FORWARD)
    paths["serving_r3d_3_requests"] = out["serving_r3d_b8"].pop("launches")
    out["serving_r3d_b8"]["card_vs_cpu_max_abs"] = forward_vs_cpu(
        pred, requests[2][None], ckpt=R3D_CHECKPOINT)
    del pred
    torch.cuda.empty_cache()

    out["burst_flow_net"] = burst_flow_vs_cpu(dev)
    torch.cuda.empty_cache()

    out["pretrain_card_vs_cpu"] = pretrain_grad_phase(dev, pwc=True)
    torch.cuda.empty_cache()
    paths["pwc_pretrain_step"], out["pretrain"] = pwc_pretrain_entry_phase()
    torch.cuda.empty_cache()
    trainer, state = pretrain_trainer(dev, pwc=True)
    out["pretrain"]["step"] = step_phase(dev, "PWC-Net pretraining", trainer,
                                         state,
                                         LAUNCHES_PER_PWC_PRETRAIN_STEP)
    del trainer, state
    torch.cuda.empty_cache()

    out["default_synthetic"] = pwc_default_synthetic_phase(dev, workdir)
    paths["pwc_frozen_step"] = \
        out["default_synthetic"]["frozen"]["launches_per_step"]
    paths["pwc_fallback_step"] = \
        out["default_synthetic"]["fallback"]["launches_per_step"]
    torch.cuda.empty_cache()
    return out, paths


def _banked_aligner(path, device):
    """The banked AlignLite's ``alignment_net`` on ``device``."""
    from dbsr_tpu_torch.models.align_lite import AlignLiteNet
    from dbsr_tpu_torch.training.checkpoint import read_checkpoint
    from dbsr_tpu_torch.utils.convert import params_from_flax

    _, tree = read_checkpoint(path)
    net = AlignLiteNet().eval()
    net.load_state_dict(params_from_flax(
        tree["params"]["params"]["alignment_net"]), strict=True)
    return net.to(device)


def sca_recovery_phase(root):
    """Phase 13b: SCA with the banked AlignLite (coarse to fine) on the
    first val burst, a perfect prediction (the stored clean scene at the
    val crop) against its misregistered ground truth, on the card and on
    the CPU. JAX's limits (``tests/test_synthetic_burstsr.py``): within a
    24-px margin, the aligned masked MSE below 0.3 x the raw MSE and more
    than half the pixels valid; card vs CPU: the outputs within
    CARD_VS_CPU_TOL where both are valid, the masks differing at no more
    than RW_MASK_TOL of the pixels; SCA's launches exact."""
    from dbsr_tpu_torch.data.burstsr import get_burstsr_val_set
    from dbsr_tpu_torch.evaluation.burstsr import _alignment_apply_from
    from dbsr_tpu_torch.models.sca import make_sca

    sampler = get_burstsr_val_set(root)
    sample = sampler[0]
    scene = np.load(os.path.join(root, "val", sampler.dataset.burst_list[0],
                                 "scene_linear.npy"))
    r = (RW_LR - 80) // 2
    pred = torch.from_numpy(np.ascontiguousarray(
        scene[8 * r:8 * r + 640, 8 * r:8 * r + 640][None]))
    gt = torch.from_numpy(sample["frame_gt"])[None]
    burst = torch.from_numpy(sample["burst"])[None]
    out = {}
    for device in ("cuda", "cpu"):
        sca = make_sca(_alignment_apply_from(
            _banked_aligner(ALIGN_LITE, device)), sr_factor=4)
        reset_counts()
        t0 = time.perf_counter()
        with torch.no_grad():
            pw, valid = sca(pred.to(device), gt.to(device), burst.to(device))
        if device == "cuda":
            torch.cuda.synchronize()
            launches = read_counts()
        out[device] = (pw.cpu(), valid.cpu(), time.perf_counter() - t0)
    want = {k: LAUNCHES_PER_SCA_LITE.get(k, 0) for k in launches}
    if launches != want:
        raise AssertionError(f"SCA: launches {launches}, expected {want}")
    pw, valid, secs = out["cuda"]
    m = 24
    crop = (slice(None), slice(m, -m), slice(m, -m))

    def masked_mse(a, b, v):
        d = ((a - b) ** 2 * v)[crop]
        return float(d.sum() / (v[crop].sum() * 3 + 1e-8))

    v = valid.float()
    err_aligned = masked_mse(pw, gt, v)
    err_raw = masked_mse(pred, gt, torch.ones_like(v))
    valid_share = float(v[crop].mean())
    both = valid & out["cpu"][1]
    diff = float(((pw - out["cpu"][0]).abs() * both).max())
    mask_diff = float((valid != out["cpu"][1]).float().mean())
    log(f"SCA (banked AlignLite, coarse to fine) on the planted "
        f"misregistration, 640^2: aligned MSE {err_aligned:.3e} vs raw "
        f"{err_raw:.3e} ({err_aligned / err_raw:.3f}, limit 0.3), valid "
        f"{valid_share:.3f} (limit 0.5); card vs CPU: max|diff| {diff:.3e} "
        f"where both valid (limit {CARD_VS_CPU_TOL}), masks differ at "
        f"{mask_diff:.2e} of the pixels (limit {RW_MASK_TOL}); launches "
        f"{launches}; {secs:.2f} s on the card (first call), "
        f"{out['cpu'][2]:.2f} s on the CPU")
    if not (err_aligned < 0.3 * err_raw and valid_share > 0.5):
        raise AssertionError("SCA did not recover the planted "
                             "misregistration")
    if not (diff <= CARD_VS_CPU_TOL and mask_diff <= RW_MASK_TOL):
        raise AssertionError("SCA: card and CPU disagree")
    return dict(aligned_mse=err_aligned, raw_mse=err_raw,
                ratio=err_aligned / err_raw, valid_share=valid_share,
                card_vs_cpu_max_abs=diff, mask_diff_share=mask_diff,
                launches=launches)


def burstsr_score_phase(root, nets):
    """Phases 13c and 14c: ``evaluation.burstsr.compute_score`` of each
    network of ``nets`` ((NetworkParam, per-burst launches)) over the val
    tree, the launch counters reset just before and read just after
    (exact), ms per burst by part, peak memory. Each network scores one
    burst first, untimed. Returns ``({name: numbers}, {name: launches},
    {metric: {name: score}})``."""
    from dbsr_tpu_torch.evaluation import burstsr as ev

    scores, out, paths = {}, {}, {}
    for n, per_burst in nets:
        name = n.get_display_name()
        buf, timing = io.StringIO(), {}
        # one burst first, untimed: cuDNN's first calls at these shapes
        with contextlib.redirect_stdout(buf):
            ev.compute_score([n], root, with_lpips=False, device="cuda",
                             max_bursts=1)
        buf = io.StringIO()
        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with contextlib.redirect_stdout(buf):
            s = ev.compute_score([n], root, with_lpips=False, device="cuda",
                                 timing=timing)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        launches = read_counts()
        for line in buf.getvalue().splitlines():
            log(f"  | {line}")
        t = timing[name]
        nb = t["bursts"]
        want = {k: per_burst.get(k, 0) * nb for k in launches}
        if nb != RW_BURSTS or launches != want:
            raise AssertionError(f"burstsr {name}: {nb} bursts, launches "
                                 f"{launches}, expected {want}")
        for m in s:
            scores.setdefault(m, {})[name] = s[m][name]
        out[name] = dict(
            psnr=s["psnr"][name], ssim=s["ssim"][name], bursts=nb,
            ms_per_burst=t["wall_s"] * 1e3 / nb,
            forward_ms_per_burst=t["forward_ms"] / nb,
            sca_ms_per_burst=t["sca_ms"] / nb,
            metrics_ms_per_burst=t["metrics_ms"] / nb,
            reader_ms_per_burst=t["reader_s"] * 1e3 / nb,
            transfer_ms_per_burst=t["transfer_s"] * 1e3 / nb,
            peak_mem_gib=peak, launches=launches)
        paths[name] = launches
        log(f"burstsr {name}: PSNR {s['psnr'][name]:.4f} dB, SSIM "
            f"{s['ssim'][name]:.4f}; per burst {out[name]['ms_per_burst']:.2f}"
            f" ms wall: forward {out[name]['forward_ms_per_burst']:.2f}, SCA "
            f"{out[name]['sca_ms_per_burst']:.2f}, metrics "
            f"{out[name]['metrics_ms_per_burst']:.2f} ms (CUDA events), "
            f"reader {out[name]['reader_ms_per_burst']:.2f} ms; peak "
            f"{peak:.2f} GiB; launches {launches}")
    return out, paths, scores


def burstsr_cli_vs_api(root, scores):
    """Phase 14c: ``run_evaluation burstsr compute_score dbsr_zoo`` (its
    ``main``, the zoo at the dtype its checkpoints record), equal to the
    API's ``scores`` of the same networks in the same call order within
    EVAL_SAVED_TOL."""
    from dbsr_tpu_torch import run_evaluation

    path = os.path.join(os.environ["DBSR_TPU_WORKSPACE_DIR"], "rw_cli.json")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        run_evaluation.main(["burstsr", "compute_score", "dbsr_zoo",
                             "--dataset_root", root, "--no_lpips", "--json",
                             path])
    for line in buf.getvalue().splitlines():
        log(f"  | {line}")
    with open(path) as f:
        cli = json.load(f)
    log(f"run_evaluation burstsr compute_score dbsr_zoo: "
        f"{time.perf_counter() - t0:.1f} s; {cli}")
    worst = _scores_close("burstsr CLI vs API", {m: {k: cli[m][k] for k in
                                                     scores[m]}
                                                 for m in scores},
                          scores, EVAL_SAVED_TOL, EVAL_SAVED_TOL)
    return dict(cli=cli, cli_vs_api=worst)


def burstsr_card_vs_cpu(root, nets):
    """Phase 13c: the per-burst scores of the first RW_CPU_BURSTS val
    bursts on the card (kernels) and on the CPU (plain versions), the same
    forward-SCA-metrics function, within EVAL_PSNR_TOL dB and
    EVAL_SSIM_TOL."""
    from dbsr_tpu_torch.data.burstsr import get_burstsr_val_set
    from dbsr_tpu_torch.evaluation import burstsr as ev
    from dbsr_tpu_torch.models.sca import make_sca

    sampler = get_burstsr_val_set(root)
    samples = [sampler[i] for i in range(RW_CPU_BURSTS)]
    res = {}
    for n in nets:
        name = n.get_display_name()
        per = {}
        for device in ("cuda", "cpu"):
            net, _ = n.load_net("", device=device)
            scored = ev._scored_fn(net, make_sca(ev._alignment_apply_from(
                net.encoder.alignment_net), sr_factor=4), EVAL_BOUNDARY)
            vals = [scored(torch.from_numpy(s["burst"]).to(device),
                           torch.from_numpy(s["frame_gt"]).to(device))
                    for s in samples]
            per[device] = {m: {str(i): float(v[m]) for i, v in
                               enumerate(vals)} for m in ("psnr", "ssim")}
            del net
        res[name] = dict(per_burst=per, max_abs=_scores_close(
            f"burstsr {name} card vs CPU, per burst, first "
            f"{RW_CPU_BURSTS} bursts", per["cuda"], per["cpu"],
            EVAL_PSNR_TOL, EVAL_SSIM_TOL))
    return res


def burstsr_saved_phase(root, n, out_dir):
    """Phase 13d: ``evaluation.burstsr.save_results`` of ``n``; every PNG
    equals the live prediction quantised at 2^14, bit for bit."""
    from dbsr_tpu_torch.data.burstsr import get_burstsr_val_set
    from dbsr_tpu_torch.evaluation import burstsr as ev
    from dbsr_tpu_torch.utils.png16 import read_png

    ev.save_results([n], root, out_dir, device="cuda")
    net, _ = n.load_net("", device="cuda")
    forward = ev._forward_fn(net)
    sampler = get_burstsr_val_set(root)  # save_results' draws, in order
    for i in range(len(sampler)):
        s = sampler[i]
        want = (forward(torch.from_numpy(s["burst"]).cuda()).cpu().numpy()
                * 2 ** 14).astype(np.uint16)
        got = read_png(os.path.join(out_dir, n.get_unique_name(),
                                    f"{s['burst_name']}.png"))
        if not np.array_equal(got, want):
            raise AssertionError(f"save_results {s['burst_name']}: the PNG "
                                 f"differs from the live prediction")
    log(f"save_results {n.get_display_name()}: {len(sampler)} PNGs equal "
        f"to the live quantised predictions")
    return len(sampler)


def realworld_grad_phase(root):
    """Phase 13e: one default_realworld step of the banked flagship at B=1
    (8 frames, 56-px crops of the train tree, 10 x masked L1 after SCA) on
    the card and on the CPU from the same batch: loss within LOSS_RTOL,
    every gradient together within GRAD_TOL of its norm. As in phase 7a,
    a batch whose merge offsets fall on the two sides of a whole pixel on
    the two devices (a jump of the model) is logged and left for the next
    sampler seed of BATCH_SEEDS; so is one whose SCA masks differ (a
    threshold of the protocol)."""
    import copy

    from dbsr_tpu_torch.data.burstsr import (BurstSRDataset,
                                             BurstSRProcessing,
                                             RandomBurstSampler)
    from dbsr_tpu_torch.evaluation.burstsr import _alignment_apply_from
    from dbsr_tpu_torch.models import sca as sca_mod
    from dbsr_tpu_torch.serving import FLAGSHIP_CHECKPOINT, float32_math
    from dbsr_tpu_torch.training.actors import make_realworld_actor
    from dbsr_tpu_torch.training.checkpoint import load_network

    what = "default_realworld step (flagship, B=1, N=8, 56-px crops)"
    left = {}
    for seed in BATCH_SEEDS:
        sampler = RandomBurstSampler(
            BurstSRDataset(root, split="train"), burst_size=RW_N,
            samples_per_epoch=1, seed=seed,
            processing=BurstSRProcessing(crop_sz=56,
                                         substract_black_level=True,
                                         random_flip=True))
        sample = sampler[0]
        out, offsets, masks = {}, {}, {}
        for device in ("cuda", "cpu"):
            t0 = time.perf_counter()
            net, _ = load_network(FLAGSHIP_CHECKPOINT, device=device,
                                  dtype=None)
            aligner = copy.deepcopy(net.encoder.alignment_net)
            sca = sca_mod.make_sca(_alignment_apply_from(aligner),
                                   sr_factor=4)

            def spied(pred, gt, burst, d=device, sca=sca):
                pw, valid = sca(pred, gt, burst)
                masks[d] = valid.cpu()
                return pw, valid

            hook = net.encoder.register_forward_hook(
                lambda m, i, o, d=device: offsets.__setitem__(
                    d, o["offsets"].detach().cpu()))
            batch = {k: torch.from_numpy(sample[k])[None].to(device)
                     for k in ("burst", "frame_gt")}
            reset_counts()
            with float32_math():
                loss, _ = make_realworld_actor(net, spied)(batch)
                loss.backward()
            if device == "cuda":
                torch.cuda.synchronize()
                launches = read_counts()
            hook.remove()
            out[device] = (loss.item(), _grads(net),
                           time.perf_counter() - t0)
            modulo = net.merging.offset_modulo
            del net, aligner
        o_card, o_cpu = offsets["cuda"], offsets["cpu"]
        wrapped = int((torch.floor(o_card / modulo)
                       != torch.floor(o_cpu / modulo)).sum())
        mask_diff = int((masks["cuda"] != masks["cpu"]).sum())
        log(f"{what}, sampler seed {seed}: offsets card vs CPU max|diff| "
            f"{float((o_card - o_cpu).abs().max()):.3e} px, {wrapped} on "
            f"the two sides of a whole pixel; SCA masks differ at "
            f"{mask_diff} of {masks['cpu'].numel()} pixels")
        if not wrapped and not mask_diff:
            break
        left[seed] = dict(wrapped_offsets=wrapped, mask_diff=mask_diff)
        if wrapped and float((o_card - o_cpu).abs().max()) > WRAP_DIFF_TOL:
            raise AssertionError(f"{what}: offsets differ by more than "
                                 f"{WRAP_DIFF_TOL} px")
    else:
        raise AssertionError(f"{what}: every sampler seed left: {left}")
    want = {k: LAUNCHES_PER_RW_STEP[k] for k in launches}
    log(f"{what}: launches on the card {launches}")
    if launches != want:
        raise AssertionError(f"{what}: launches {launches}, expected {want}")
    res = card_vs_cpu(what, out)
    res.update(launches=launches, sampler_seed=seed, left=left)
    return res


def realworld_phase(dev, workdir):
    """Phase 13, the real-world path on the card: (a) the port's generator
    writes val and train trees; (b) SCA recovers the planted
    misregistration, card vs CPU; (c) ``compute_score`` of the flagship and
    r3d, the CLI on the zoo, per-burst scores card vs CPU; (d)
    ``save_results``; (e) ``default_realworld`` from the banked flagship:
    ``run_training`` for one epoch of RW_STEPS steps at B=12, then a
    resumed second, one step at B=1 card vs CPU, the B=12 step's time and
    peak memory. Returns the numbers and the launches of its paths."""
    import shutil

    from dbsr_tpu_torch.configs.dbsr import default_realworld
    from dbsr_tpu_torch.data import make_synthetic_burstsr as gen
    from dbsr_tpu_torch.evaluation.experiments import dbsr_zoo
    from dbsr_tpu_torch.serving import FLAGSHIP_CHECKPOINT
    from dbsr_tpu_torch.training.checkpoint import (read_checkpoint,
                                                    resolve_checkpoint)
    from dbsr_tpu_torch.utils.convert import params_from_flax

    out, paths = {}, {}
    root = os.path.join(workdir, "burstsr")
    ws = os.path.join(workdir, "realworld")
    os.makedirs(ws, exist_ok=True)
    os.environ["DBSR_TPU_WORKSPACE_DIR"] = ws
    os.environ["DBSR_TPU_BURSTSR_DIR"] = root
    # (a) the trees
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        for i, split in enumerate(("val", "train")):
            gen.generate_dataset(root, bursts=RW_BURSTS, lr=RW_LR,
                                 n_frames=14, split=split, seed=RW_SEED + i,
                                 device="cuda")
    torch.cuda.synchronize()
    out["generate_s"] = time.perf_counter() - t0
    for line in buf.getvalue().splitlines():
        log(f"  | {line}")
    log(f"13a: {2 * RW_BURSTS} bursts written in {out['generate_s']:.1f} s")

    # (b) SCA on the planted misregistration
    out["sca_recovery"] = sca_recovery_phase(root)
    torch.cuda.empty_cache()

    # (c) scoring: the flagship (AlignLite) and r3d (PWC-Net), in float32
    zoo = {n.get_display_name(): dataclasses.replace(
        n, checkpoint_path=float32_copy(n.checkpoint_path, workdir))
        for n in dbsr_zoo.main()}
    nets = ((zoo["dbsr_campaign_r5"], LAUNCHES_PER_RW_LITE_BURST),
            (zoo["dbsr_campaign_r3d"], LAUNCHES_PER_RW_PWC_BURST))
    scored, by_net, _ = burstsr_score_phase(root, nets)
    out["scores"] = dict(nets=scored)
    paths["burstsr_eval"] = by_net["dbsr_campaign_r5"]
    paths["burstsr_eval_r3d"] = by_net["dbsr_campaign_r3d"]
    torch.cuda.empty_cache()
    out["card_vs_cpu"] = burstsr_card_vs_cpu(root, [n for n, _ in nets])
    torch.cuda.empty_cache()

    # (d) save_results
    out["saved_pngs"] = burstsr_saved_phase(
        root, zoo["dbsr_campaign_r5"], os.path.join(workdir, "rw_saved"))
    torch.cuda.empty_cache()

    # (e) default_realworld from the banked flagship
    syn = os.path.join(ws, "dbsr", "default_synthetic")
    os.makedirs(syn, exist_ok=True)
    # a float32 copy: default_realworld restores the dtype it records
    shutil.copy(float32_copy(FLAGSHIP_CHECKPOINT, workdir),
                os.path.join(syn, "dbsr_synthetic_ep0060.ckpt"))
    log(f"default_realworld cuts: steps_per_epoch {RW_STEPS} of 300, epochs "
        f"2 of 40, no val pass (every 4 epochs); full width, B={RW_B}, "
        f"N={RW_N}, 56-px crops, the banked flagship restored")
    per_step, logged, _, _ = entry_phase(
        "dbsr", "default_realworld",
        dict(steps_per_epoch=RW_STEPS, print_interval=RW_STEPS), (1, 2),
        LAUNCHES_PER_RW_STEP, "dbsr_realworld")
    paths["realworld_step"] = per_step
    rw = os.path.join(ws, "dbsr", "default_realworld")
    _, warm = read_checkpoint(resolve_checkpoint(rw, "dbsr_realworld", 0))
    _, banked = read_checkpoint(FLAGSHIP_CHECKPOINT)
    warm, banked = (params_from_flax(t["params"]) for t in (warm, banked))
    if set(warm) != set(banked) or not all(
            torch.equal(warm[k], banked[k].float()) for k in banked):
        raise AssertionError("default_realworld's epoch-0 checkpoint is not "
                             "the restored flagship")
    log("default_realworld: the epoch-0 checkpoint holds the banked "
        "flagship's parameters")
    out["run_training_losses"] = logged["Loss/total"]
    torch.cuda.empty_cache()
    out["card_vs_cpu_step"] = realworld_grad_phase(root)
    torch.cuda.empty_cache()
    with contextlib.redirect_stdout(io.StringIO()):
        trainer, restored = default_realworld.make_trainer(
            _settings(steps_per_epoch=RW_STEPS, print_interval=RW_STEPS), dev)
    state = trainer.init_state()
    trainer.net.load_state_dict(restored)
    out["step"] = step_phase(dev, "default_realworld", trainer, state,
                             LAUNCHES_PER_RW_STEP, n_steps=10,
                             batch_size=RW_B, loss_must_fall=False)
    del trainer, state
    torch.cuda.empty_cache()
    return out, paths

# ---------------------------------------------------------------------------
# phase 14: bf16


def bf16_ulps(got, want, scale):
    """|got - want| in bf16 ulps at max(|want|, 2^-8 |scale|): bf16's
    spacing at the output's magnitude, floored where cancellation leaves
    the last bits to the float32 sum's rounding (``scale``: the same op on
    the inputs' absolute values, the magnitude of the output's terms)."""
    mag = torch.maximum(want.float().abs(), scale.float().abs() * 2.0 ** -8)
    ulp = torch.exp2(torch.floor(torch.log2(mag.clamp_min(2.0 ** -126))) - 7)
    return (got.float() - want.float()).abs() / ulp


def check_bf16(name, fn, plain, scale_fn):
    """A bf16 kernel call ``fn()`` against its plain version ``plain()``:
    at least BF16_BIT_EQUAL of the outputs bit-equal, none more than
    BF16_MAX_ULPS off (``bf16_ulps``), the same bits from a second call."""
    got, again, want = fn(), fn(), plain()
    torch.cuda.synchronize()
    if got.dtype != torch.bfloat16 or got.shape != want.shape:
        raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)} vs "
                             f"{want.dtype} {tuple(want.shape)}")
    equal = (got == want).float().mean().item()
    ulps = bf16_ulps(got, want, scale_fn()).max().item()
    repeat = torch.equal(got, again)
    err = (got.float() - want.float()).abs().max().item()
    log(f"  {name}: bit-equal to plain {equal:.6f} (limit >= "
        f"{BF16_BIT_EQUAL}), max {ulps:.3f} bf16 ulps (limit "
        f"{BF16_MAX_ULPS}), max|diff| {err:.3e}; same bits on a second "
        f"call: {repeat}")
    if not (equal >= BF16_BIT_EQUAL and ulps <= BF16_MAX_ULPS and repeat):
        raise AssertionError(f"{name}: bf16 kernel vs plain: bit-equal "
                             f"{equal}, {ulps} ulps, repeat {repeat}")
    return dict(bit_equal_share=equal, max_ulps=ulps, max_abs_err=err,
                repeat_equal=repeat)


def bf16_kernel_phase(dev, g):
    """Phase 14a: the four kernels of the bf16 forward against their plain
    bf16 versions at the shapes of the serving forward (B=8, N=14): the
    warp at the encoder's 512 channels and AlignLite's two backwarps, the
    cost volume at AlignLite's three levels, the merge, the s2d conv's
    launch (``per_shape``: one forward's worth, except the s2d conv's one
    launch of 8), and the warp and cost volume at PWC-Net's 1x1-16x16
    planes (``pwc_shapes``). Times and bounds as phase 3's, the bytes at
    bf16 (the flow float32), the operations at the float32 rate (the
    math is float32), the s2d conv's at the bf16 tensor-core rate; the
    yardsticks ``F.grid_sample`` and the structured-dense ``F.conv2d`` in
    bf16 (the grid in bf16 too: its sampling positions rounded)."""
    from dbsr_tpu_torch.models.layers import s2d_conv_kernel
    from dbsr_tpu_torch.ops.conv_s2d import (conv3x3_s2d_forward,
                                             conv3x3_s2d_plain)
    from dbsr_tpu_torch.ops.correlation import (NUM_OFFSETS,
                                                correlation_forward,
                                                correlation_plain)
    from dbsr_tpu_torch.ops.merge import (fused_softmax_merge_plain,
                                          merge_forward)
    from dbsr_tpu_torch.ops.warp import (base_grid, warp_feat_plain,
                                         warp_forward)

    bf = torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(bf)

    def flow(frames, h, w):  # as phase 3's
        f = torch.rand(frames, h, w, 2, generator=g, device=dev) * 10 - 5
        f[:, ::7] = torch.round(f[:, ::7])
        return f.contiguous()

    def warp_row(feat, fl, what):
        row = check_bf16(f"warp bf16 {list(feat.shape)} ({what})",
                         lambda: warp_forward(feat, fl),
                         lambda: warp_feat_plain(feat, fl),
                         lambda: warp_feat_plain(feat.float().abs(), fl))
        H, W = feat.shape[1], feat.shape[2]
        grid = _grid_sample_grid(base_grid(H, W, dev) + fl, H, W).to(bf)
        nchw = feat.permute(0, 3, 1, 2)
        bms, by = bound(2 * feat.numel() * 2 + fl.numel() * 4,
                        7 * feat.numel())
        row.update(shape=list(feat.shape), bound_ms=bms, bound_by=by,
                   **timings("warp", lambda: warp_forward(feat, fl),
                             lambda: warp_feat_plain(feat, fl),
                             lambda: F.grid_sample(nchw, grid,
                                                   align_corners=False,
                                                   padding_mode="zeros")))
        return row

    def corr_row(a, b, what):
        row = check_bf16(f"correlation bf16 {list(a.shape)} ({what})",
                         lambda: correlation_forward(a, b),
                         lambda: correlation_plain(a, b),
                         lambda: correlation_plain(a.float().abs(),
                                                   b.float().abs()))
        npix = a.shape[0] * a.shape[1] * a.shape[2]
        bms, by = bound((2 * a.numel() + npix * NUM_OFFSETS) * 2,
                        2 * NUM_OFFSETS * a.numel())
        row.update(shape=list(a.shape), bound_ms=bms, bound_by=by,
                   **timings("correlation", lambda: correlation_forward(a, b),
                             lambda: correlation_plain(a, b)))
        return row

    rows = {"warp": {"per_shape": [], "pwc_shapes": []},
            "correlation": {"per_shape": [], "pwc_shapes": []}}
    for sh in ((FRAMES, HW, HW, 512), (FRAMES, HW // 2, HW // 2, 48),
               (FRAMES, HW, HW, 24)):
        rows["warp"]["per_shape"].append(
            warp_row(randn(*sh), flow(*sh[:3]), "serving"))
    for sh in ((FRAMES, HW // 4, HW // 4, 96), (FRAMES, HW // 2, HW // 2, 48),
               (FRAMES, HW, HW, 24)):
        rows["correlation"]["per_shape"].append(
            corr_row(randn(*sh), randn(*sh), "AlignLite"))
    for s_, c in PWC_LEVELS:
        rows["correlation"]["pwc_shapes"].append(corr_row(
            randn(FRAMES, s_, s_, c), randn(FRAMES, s_, s_, c), "PWC-Net"))
    for s_, c in PWC_LEVELS[1:]:
        fl = (_pwc_flow(g, dev, FRAMES, s_) * (s_ / (s_ - 1.0))).contiguous()
        rows["warp"]["pwc_shapes"].append(
            warp_row(randn(FRAMES, s_, s_, c), fl, "PWC-Net backwarp"))
    torch.cuda.empty_cache()

    sh = (B, N, HW, HW, 512)
    feat, logits = randn(*sh), randn(*sh, scale=3.0)
    row = check_bf16(f"merge bf16 {list(sh)}",
                     lambda: merge_forward(feat, logits),
                     lambda: fused_softmax_merge_plain(feat, logits),
                     lambda: fused_softmax_merge_plain(feat.float().abs(),
                                                       logits))
    bms, by = bound((2 * feat.numel() + feat.numel() // N) * 2,
                    6 * feat.numel())
    row.update(shape=list(sh), bound_ms=bms, bound_by=by,
               **timings("merge", lambda: merge_forward(feat, logits),
                         lambda: fused_softmax_merge_plain(feat, logits)))
    rows["merge"] = {"per_shape": [row]}
    del feat, logits
    torch.cuda.empty_cache()

    C = O = 32
    x = randn(B, HW * 4, HW * 4, 4 * C)
    w = torch.randn(O, C, 3, 3, generator=g, device=dev) / math.sqrt(9 * C)
    row = check_bf16(f"conv_s2d bf16 {list(x.shape)}",
                     lambda: conv3x3_s2d_forward(x, w),
                     lambda: conv3x3_s2d_plain(x, w),
                     lambda: conv3x3_s2d_plain(x.float().abs(),
                                               w.to(bf).float().abs()))
    x_nchw, dense_w = x.permute(0, 3, 1, 2), s2d_conv_kernel(w).to(bf)
    bms, by = bound((x.numel() + x.numel() // C * O) * 2,
                    2 * 9 * O * x.numel(), BF16_FLOPS_PER_S)
    row.update(shape=[list(x.shape), list(x.shape[:3]) + [4 * O]],
               bound_ms=bms, bound_by=by,
               **timings("conv_s2d", lambda: conv3x3_s2d_forward(x, w),
                         lambda: conv3x3_s2d_plain(x, w),
                         lambda: F.conv2d(x_nchw, dense_w, padding=1)))
    rows["conv_s2d"] = {"per_shape": [row]}
    del x, x_nchw
    torch.cuda.empty_cache()
    return rows


def add_bf16_rows(entries, rows):
    """Put each kernel's bf16 rows beside its float32 ones (``bf16``, with
    the sums over one pass of the bf16 forward, and over PWC-Net's shapes
    as ``pwc_*``)."""
    for e in entries:
        r = rows.get(e["name"])
        if not r:
            continue
        b = dict(dtype="bfloat16", **r)
        every = r["per_shape"] + r.get("pwc_shapes", [])
        for key, part in (("", r["per_shape"]),
                          ("pwc_", r.get("pwc_shapes", []))):
            if not part:
                continue
            for k in ("ms", "device_ms", "kernel_device_ms", "plain_ms",
                      "bound_ms"):
                b[key + k] = sum(x[k] for x in part)
            for k in ("library_ms", "library_device_ms"):
                libs = [x[k] for x in part]
                b[key + k] = sum(libs) if None not in libs else None
        b["bound_by"] = ("bytes" if all(x["bound_by"] == "bytes"
                                        for x in r["per_shape"])
                         else "operations")
        b["bit_equal_share"] = min(x["bit_equal_share"] for x in every)
        b["max_ulps"] = max(x["max_ulps"] for x in every)
        b["max_abs_err"] = max(x["max_abs_err"] for x in every)
        b["repeat_equal"] = all(x["repeat_equal"] for x in every)
        e["bf16"] = b
        for x in every:
            log_row(f"{e['name']} bf16", x)
        log(f"  {e['name']} bf16, one pass of the forward: device "
            f"{b['device_ms']:.4f} ms, bound {b['bound_ms']:.4f} "
            f"({b['bound_by']}), float32 device {e['device_ms']:.4f}")


def _rel_l2(a, b):
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm()).item()


def _map_tensors(fn, x):
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, dict):
        return {k: _map_tensors(fn, v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_map_tensors(fn, v) for v in x)
    return x


def bf16_forward_by_layer(pred, burst):
    """The card's bf16 forward of ``burst`` (clipped, on the CPU), each
    conv layer's input and output in it (``ConvBlock``,
    ``PixShuffleUpsampler``, ``TorchConvTranspose``) and each of
    BF16_STAGES' arguments and output, on the CPU."""
    from dbsr_tpu_torch.models.layers import (ConvBlock, PixShuffleUpsampler,
                                              TorchConvTranspose)

    layers, stages = {}, {}

    def keep(into, name):
        def hook(_m, args, kwargs, out):
            into[name] = _map_tensors(lambda t: t.detach().cpu(),
                                      (args, kwargs, out))
        return hook

    hooks = [pred.net.get_submodule(s).register_forward_hook(
        keep(stages, s), with_kwargs=True) for s in BF16_STAGES]
    hooks += [m.register_forward_hook(keep(layers, n), with_kwargs=True)
              for n, m in pred.net.named_modules()
              if isinstance(m, (ConvBlock, PixShuffleUpsampler,
                                TorchConvTranspose))]
    try:
        with torch.no_grad():
            card = pred.forward(burst.cuda()).clamp(0, 1).cpu()
    finally:
        for h in hooks:
            h.remove()
    return card, layers, stages


def bf16_layer_check(name, layers, cpu_bf16):
    """Phase 14b: each conv layer of the card's bf16 forward against the
    same layer on the CPU (plain versions, oneDNN's convs; the CPU tests
    hold them bit-equal to the JAX package's) from the card's own input to
    it: bf16 out on both, at least BF16_LAYER_BIT_EQUAL of the outputs
    bit-equal."""
    shares = {}
    for layer, (args, kwargs, card) in layers.items():
        with torch.inference_mode():
            cpu = cpu_bf16.get_submodule(layer)(*args, **kwargs)
        if card.dtype != torch.bfloat16 or cpu.dtype != torch.bfloat16:
            raise AssertionError(f"bf16 {name} {layer}: card {card.dtype}, "
                                 f"CPU {cpu.dtype}")
        shares[layer] = (card == cpu).double().mean().item()
    worst = min(shares, key=shares.get)
    out = dict(layers=len(shares), min_bit_equal=shares[worst],
               worst_layer=worst,
               mean_bit_equal=sum(shares.values()) / len(shares))
    log(f"bf16 {name}, {len(shares)} conv layers from the card's inputs: "
        f"bit-equal to the CPU's bf16 layer, least {shares[worst]:.6f} "
        f"({worst}; limit {BF16_LAYER_BIT_EQUAL}), mean "
        f"{out['mean_bit_equal']:.6f}")
    if not shares[worst] >= BF16_LAYER_BIT_EQUAL:
        raise AssertionError(f"bf16 {name}: {out}")
    return out


def bf16_stage_gaps(name, stages, cpu_bf16, cpu_f32):
    """Phase 14b, recorded: each stage of the card's bf16 forward against
    the same stage on the CPU from the card's own inputs to it, in bf16
    (``cpu_bf16``) and in float32 (``cpu_f32``, the inputs widened): how
    far the roundings a float32 sum's order flips spread through a stage,
    beside bf16's own distance to float32 there. The flow float32, the
    rest bf16, as the JAX package gives them."""
    widen = lambda t: t.float() if t.dtype == torch.bfloat16 else t  # noqa
    pick = lambda o: o["fused_enc"] if isinstance(o, dict) else o  # noqa
    out = {}
    for stage in BF16_STAGES:
        args, kwargs, card = stages[stage]
        with torch.inference_mode():
            b = pick(cpu_bf16.get_submodule(stage)(*args, **kwargs))
            f = pick(cpu_f32.get_submodule(stage)(
                *_map_tensors(widen, args), **_map_tensors(widen, kwargs)))
        card = pick(card)
        want = (torch.float32 if stage == "encoder.alignment_net"
                else torch.bfloat16)
        if card.dtype != want or b.dtype != want or f.dtype != torch.float32:
            raise AssertionError(f"bf16 {name} {stage}: card {card.dtype}, "
                                 f"CPU {b.dtype} / {f.dtype}, expected "
                                 f"{want}")
        r = dict(card_vs_cpu_rel_l2=_rel_l2(card, b),
                 bf16_vs_f32_rel_l2=_rel_l2(f, b),
                 bit_equal_share=(card == b).double().mean().item())
        log(f"bf16 {name}, {stage} from the card's inputs: card vs CPU "
            f"relative L2 {r['card_vs_cpu_rel_l2']:.3e} (the CPU's bf16 vs "
            f"float32 {r['bf16_vs_f32_rel_l2']:.3e}), bit-equal "
            f"{r['bit_equal_share']:.6f}")
        out[stage] = r
    return out


def bf16_serving_phase(requests):
    """Phase 14b: ``load_predictor`` with its bf16 default at batch 8, the
    flagship in its three decoder forms and r3d: phase 4's three requests
    with exact launches, the request and forward times, peak memory; the
    card's forward of one burst against the CPU's bf16 forward (plain
    versions; relative L2 within BF16_REL_L2) and no farther from the
    card's float32 forward than twice the CPU's bf16 one is; layer by layer
    against the CPU (``bf16_layer_check``); the stages, recorded
    (``bf16_stage_gaps``). Returns the numbers and each form's launches
    over its three requests."""
    from dbsr_tpu_torch.models.layers import compute_dtype_of
    from dbsr_tpu_torch.serving import FLAGSHIP_CHECKPOINT, load_predictor
    from dbsr_tpu_torch.training.checkpoint import load_network

    out, paths = {}, {}
    burst = torch.from_numpy(requests[2][None])
    kw = dict(batch_size=B, burst_size=N, burst_hw=(HW, HW), device="cuda")
    for name, ckpt, on, fused, per_forward in (
            ("flagship_s2d_kernel", FLAGSHIP_CHECKPOINT, True, True,
             LAUNCHES_PER_S2D_FORWARD),
            ("flagship_s2d_dense", FLAGSHIP_CHECKPOINT, False, True,
             LAUNCHES_PER_FORWARD),
            ("flagship_fine", FLAGSHIP_CHECKPOINT, False, False,
             LAUNCHES_PER_FORWARD),
            ("r3d", R3D_CHECKPOINT, True, True, LAUNCHES_PER_PWC_FORWARD)):
        with fine_patch(on):
            pred = load_predictor(ckpt, fused_s2d=fused, **kw)
            if compute_dtype_of(pred.net) != torch.bfloat16:
                raise AssertionError(f"{name}: load_predictor did not build "
                                     "a bf16 net by default")
            res = serve(f"bf16 serving, {name}", pred, requests, per_forward)
            paths[name] = res.pop("launches")
            card, layers, stages = bf16_forward_by_layer(pred, burst)
            del pred
            torch.cuda.empty_cache()
            f32 = load_predictor(ckpt, fused_s2d=fused, dtype=None, **kw)
            with torch.no_grad():
                card32 = f32.forward(burst.cuda()).clamp(0, 1).cpu()
            del f32
            torch.cuda.empty_cache()
            cpu_net, _ = load_network(ckpt, device="cpu",
                                      fused_s2d_decoder=fused)
            cpu_f32, _ = load_network(ckpt, device="cpu", dtype=None,
                                      fused_s2d_decoder=fused)
            with torch.inference_mode():
                t0 = time.perf_counter()
                cpu = cpu_net(burst)[0].clamp(0, 1)
                cpu_s = time.perf_counter() - t0
            res["layers"] = bf16_layer_check(name, layers, cpu_net)
            res["stages"] = bf16_stage_gaps(name, stages, cpu_net, cpu_f32)
            del cpu_net, cpu_f32, layers, stages
        res.update(card_vs_cpu_rel_l2=_rel_l2(card, cpu),
                   card_vs_cpu_max_abs=(card - cpu).abs().max().item(),
                   vs_card_f32_rel_l2=_rel_l2(card, card32),
                   vs_card_f32_max_abs=(card - card32).abs().max().item(),
                   cpu_vs_card_f32_rel_l2=_rel_l2(cpu, card32),
                   cpu_forward_s=cpu_s)
        log(f"bf16 {name}: card vs the CPU's bf16 forward, 1 burst: "
            f"relative L2 {res['card_vs_cpu_rel_l2']:.3e} (limit "
            f"{BF16_REL_L2}), max|diff| {res['card_vs_cpu_max_abs']:.3e}; vs "
            f"the card's float32 forward: relative L2 "
            f"{res['vs_card_f32_rel_l2']:.3e} (limit 2 x "
            f"{res['cpu_vs_card_f32_rel_l2']:.3e}, the CPU's bf16 forward's),"
            f" max|diff| {res['vs_card_f32_max_abs']:.3e}; CPU forward "
            f"{cpu_s:.1f} s")
        if not (res["card_vs_cpu_rel_l2"] <= BF16_REL_L2
                and res["vs_card_f32_rel_l2"]
                <= 2 * res["cpu_vs_card_f32_rel_l2"]):
            raise AssertionError(f"bf16 {name}: card vs CPU relative L2 "
                                 f"{res['card_vs_cpu_rel_l2']}, vs float32 "
                                 f"{res['vs_card_f32_rel_l2']} (the CPU's "
                                 f"{res['cpu_vs_card_f32_rel_l2']})")
        out[name] = res
    return out, paths


def bf16_eval_phase(workdir, f32_scores):
    """Phase 14c: the zoo's three models scored at their recorded bf16 on
    phase 11's val set (exact launches, scores, ms a burst), beside phase
    11's float32 scores and the JAX package's bf16 ones; the flagship's
    first bursts card vs CPU in bf16; ``run_evaluation synburst
    compute_score dbsr_zoo`` on the first EVAL_CLI_BURSTS bursts equal to
    the API's bf16 scores of the same bursts within EVAL_SAVED_TOL."""
    from dbsr_tpu_torch import run_evaluation
    from dbsr_tpu_torch.evaluation import synburst
    from dbsr_tpu_torch.evaluation.experiments import dbsr_zoo
    from dbsr_tpu_torch.evaluation.network_param import NetworkParam
    from dbsr_tpu_torch.models.layers import compute_dtype_of
    from dbsr_tpu_torch.serving import FLAGSHIP_CHECKPOINT

    root = os.path.join(workdir, "synburst_val")
    n_forwards = -(-EVAL_BURSTS // EVAL_BATCH)
    nets = [NetworkParam(checkpoint_path=c, display_name=os.path.basename(
        c).replace("_best_params.ckpt", ""))
        for c in (FLAGSHIP_CHECKPOINT, R4MIX_CHECKPOINT, R3D_CHECKPOINT)]
    if compute_dtype_of(nets[0].load_net("", "cpu")[0]) != torch.bfloat16:
        raise AssertionError("NetworkParam did not load the recorded bf16")
    with contextlib.redirect_stdout(io.StringIO()):  # cuDNN's first calls
        synburst.compute_score(nets[:1], root, with_lpips=False,
                               max_bursts=EVAL_BATCH, device="cuda")
    out = {"scores": {}, "runs": {}, "bf16_minus_f32_db": {}}
    for n in nets:
        name = n.get_display_name()
        pwc = n.checkpoint_path == R3D_CHECKPOINT
        s, out["runs"][name] = _scored(
            f"compute_score {name} (bf16), {EVAL_BURSTS} bursts, batch "
            f"{EVAL_BATCH}", [n], root,
            LAUNCHES_PER_PWC_FORWARD if pwc else LAUNCHES_PER_S2D_FORWARD,
            n_forwards)
        if not all(math.isfinite(v[name]) for v in s.values()):
            raise AssertionError(f"{name}: bf16 scores not finite: {s}")
        for m, v in s.items():
            out["scores"].setdefault(m, {}).update(v)
        out["bf16_minus_f32_db"][name] = (s["psnr"][name]
                                          - f32_scores["psnr"][name])
        epoch, banked = _banked_score(n.checkpoint_path)
        log(f"{name} (epoch {epoch}, bf16): PSNR {s['psnr'][name]:.4f} dB, "
            f"SSIM {s['ssim'][name]:.4f}, MS-SSIM {s['msssim'][name]:.4f}; "
            f"float32 (11b) PSNR {f32_scores['psnr'][name]:.4f} dB, SSIM "
            f"{f32_scores['ssim'][name]:.4f}; the JAX package's bf16 score "
            f"of this epoch on its own val set (context, not a limit): "
            f"{banked}")
        torch.cuda.empty_cache()
    out["card_vs_cpu"] = card_vs_cpu_scores(
        root, FLAGSHIP_CHECKPOINT, EVAL_CPU_BURSTS,
        tols=(BF16_PSNR_TOL, BF16_SSIM_TOL))

    # the CLI on the zoo, at the dtype its checkpoints record
    path = os.path.join(workdir, "bf16_zoo_cli.json")
    argv = ["synburst", "compute_score", "dbsr_zoo", "--dataset_root", root,
            "--no_lpips", "--max_bursts", str(EVAL_CLI_BURSTS), "--json",
            path]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        run_evaluation.main(argv)
    log(f"run_evaluation {' '.join(argv[:-2])}: "
        f"{time.perf_counter() - t0:.2f} s")
    for line in buf.getvalue().splitlines():
        log(f"  | {line}")
    with open(path) as f:
        cli = json.load(f)
    with contextlib.redirect_stdout(io.StringIO()):
        api = synburst.compute_score(dbsr_zoo.main(), root, with_lpips=False,
                                     max_bursts=EVAL_CLI_BURSTS,
                                     device="cuda")
    out["cli"] = dict(scores=cli, max_abs=_scores_close(
        "synburst CLI (dbsr_zoo, bf16) vs API",
        {m: {k: cli[m][k] for k in api[m]} for m in api}, api,
        EVAL_SAVED_TOL, EVAL_SAVED_TOL))
    return out


def bf16_burstsr_phase():
    """Phase 14c: the flagship's BurstSR scoring at its recorded bf16 on
    phase 13's val tree (SCA's aligner float32, as the JAX package builds
    it), exact launches per burst; then ``run_evaluation burstsr
    compute_score dbsr_zoo`` against the API scoring the zoo in one call,
    as the CLI does (the val sampler draws each burst's frame order from
    one generator, so a network's frames depend on the bursts drawn before
    it in the call: in bf16 that moves a score by ~1e-3 dB). Returns the
    numbers and the flagship's launches."""
    from dbsr_tpu_torch.evaluation import burstsr as ev
    from dbsr_tpu_torch.evaluation.experiments import dbsr_zoo

    root = os.environ["DBSR_TPU_BURSTSR_DIR"]
    zoo = dbsr_zoo.main()
    flagship = next(n for n in zoo
                    if n.get_display_name() == "dbsr_campaign_r5")
    nets, launches, _ = burstsr_score_phase(
        root, [(flagship, LAUNCHES_PER_RW_LITE_BURST)])
    with contextlib.redirect_stdout(io.StringIO()):
        api = ev.compute_score(zoo, root, with_lpips=False, device="cuda")
    return dict(nets=nets, zoo_in_one_call=api,
                **burstsr_cli_vs_api(root, api)), \
        launches["dbsr_campaign_r5"]


# ---------------------------------------------------------------------------
# phase 15: bf16 training


def dflow_terms(feat, flow, g):
    """The magnitude of d_flow's terms per output pixel ``[B, H, W, 1]``:
    ``sum_c |g| sum_tap (|dw/dx| + |dw/dy|) |feat[tap]|`` (a derivative
    weight is nonzero where the tap's weight is 0, at integer
    coordinates)."""
    from dbsr_tpu_torch.ops.warp import _gather, _taps, base_grid

    B, H, W, C = feat.shape
    coords = base_grid(H, W, feat.device) + flow
    flat = feat.float().abs().reshape(B, H * W, C)
    acc = None
    for idx, _, dx, dy in _taps(coords, H, W):
        v = _gather(flat, idx) * (dx.abs() + dy.abs())[..., None]
        acc = v if acc is None else acc + v
    return (acc * g.float().abs()).sum(-1, keepdim=True)


def check_dflow_bf16(name, fn, plain, scale):
    """d_flow's bf16 kernel ``fn()`` (float32 out, a sum over the channels)
    against its plain version: every element within BF16_DFLOW_RTOL of
    ``scale`` (the magnitude of its terms), the same bits twice."""
    got, again, want = fn(), fn(), plain()
    torch.cuda.synchronize()
    if got.dtype != torch.float32 or got.shape != want.shape:
        raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)}")
    diff = (got - want).abs()
    rel = (diff / scale.clamp_min(1e-30)).max().item()
    repeat = torch.equal(got, again)
    err = diff.max().item()
    log(f"  {name}: max |kernel - plain| / its terms' magnitude {rel:.3e} "
        f"(limit {BF16_DFLOW_RTOL}), max|diff| {err:.3e}; same bits on a "
        f"second call: {repeat}")
    if not (rel <= BF16_DFLOW_RTOL and repeat):
        raise AssertionError(f"{name}: bf16 d_flow vs plain: {rel}, repeat "
                             f"{repeat}")
    return dict(rel_to_terms=rel, max_abs_err=err, repeat_equal=repeat)


def bf16_backward_kernel_phase(dev, g):
    """Phase 15a: the six bf16 backward kernels against their plain bf16
    versions (check_bf16; d_flow, float32 out, check_dflow_bf16) at the
    train step's shapes (B=16, N=8: the encoder's warp and the merge; the
    aligner's backwarps and cost volumes, which train with
    ``train_alignment``; the decoder's d_input), at PWC-Net's
    (``pwc_shapes``) and at an odd C (``other_shapes``); timed and bounded as
    phase 6 (bf16 bytes, float32 operations; the s2d conv at the bf16
    tensor-core rate), beside the yardsticks: autograd of the bf16
    ``F.grid_sample`` (d_feat: the input's gradient; d_flow: both), autograd
    of the bf16 plain merge, ``torch.nn.grad.conv2d_input`` on the
    structured-dense bf16 kernel."""
    from dbsr_tpu_torch.models.layers import s2d_conv_kernel
    from dbsr_tpu_torch.ops.conv_s2d import (conv3x3_s2d_forward,
                                             conv3x3_s2d_plain,
                                             rotate_weight)
    from dbsr_tpu_torch.ops.correlation import (NUM_OFFSETS,
                                                correlation_dfirst,
                                                correlation_dfirst_plain,
                                                correlation_dsecond,
                                                correlation_dsecond_plain)
    from dbsr_tpu_torch.ops.merge import (fused_softmax_merge_backward_plain,
                                          fused_softmax_merge_plain,
                                          merge_backward)
    from dbsr_tpu_torch.ops.warp import (base_grid, warp_dfeat,
                                         warp_dfeat_plain, warp_dflow,
                                         warp_dflow_plain)

    bf = torch.bfloat16
    rows = {k: {"per_shape": [], "pwc_shapes": [], "other_shapes": []}
            for k in ("warp_dfeat", "warp_dflow", "merge_backward",
                      "correlation_dfirst", "correlation_dsecond",
                      "conv_s2d")}

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(bf)

    def flow(frames, h, w, amp=5.0):  # as phase 6's: some on exact centres
        f = (torch.rand(frames, h, w, 2, generator=g, device=dev) * 2 - 1) \
            * amp
        f[:, ::5] = torch.round(f[:, ::5])
        return f.contiguous()

    def warp_rows(s, fl, where, timed=True):
        feat, gout = randn(*s), randn(*s)
        row_df = check_bf16(f"warp d_feat bf16 {list(s)}",
                            lambda: warp_dfeat(fl, gout),
                            lambda: warp_dfeat_plain(fl, gout),
                            lambda: warp_dfeat_plain(fl, gout.float().abs()))
        row_dfl = check_dflow_bf16(f"warp d_flow bf16 {list(s)}",
                                   lambda: warp_dflow(feat, fl, gout),
                                   lambda: warp_dflow_plain(feat, fl, gout),
                                   dflow_terms(feat, fl, gout))
        n, nf = feat.numel(), fl.numel()
        row_df.update(shape=list(s))
        row_dfl.update(shape=list(s))
        if timed:
            H, W = s[1], s[2]
            nchw = feat.permute(0, 3, 1, 2).detach().requires_grad_(True)
            grid = _grid_sample_grid(base_grid(H, W, dev) + fl, H,
                                     W).to(bf)
            grid_req = grid.detach().requires_grad_(True)
            out_feat = F.grid_sample(nchw, grid, align_corners=False,
                                     padding_mode="zeros")
            out_both = F.grid_sample(nchw, grid_req, align_corners=False,
                                     padding_mode="zeros")
            g_nchw = gout.permute(0, 3, 1, 2)
            bms, by = bound(2 * n * 2 + nf * 4, 8 * n)
            row_df.update(bound_ms=bms, bound_by=by, **timings(
                "warp_dfeat", lambda: warp_dfeat(fl, gout),
                lambda: warp_dfeat_plain(fl, gout),
                lambda: torch.autograd.grad(out_feat, nchw, g_nchw,
                                            retain_graph=True)))
            bms, by = bound(2 * n * 2 + 2 * nf * 4, 20 * n)
            row_dfl.update(bound_ms=bms, bound_by=by, **timings(
                "warp_dflow", lambda: warp_dflow(feat, fl, gout),
                lambda: warp_dflow_plain(feat, fl, gout),
                lambda: torch.autograd.grad(out_both, (nchw, grid_req),
                                            g_nchw, retain_graph=True)))
        rows["warp_dfeat"][where[0]].append(row_df)
        rows["warp_dflow"][where[1]].append(row_dfl)

    # the encoder's warp (d_feat on the frozen step, d_flow when the
    # aligner trains), AlignLite's two backwarps, PWC-Net's four, an odd C
    warp_rows((TRAIN_FRAMES, 48, 48, 512), flow(TRAIN_FRAMES, 48, 48),
              ("per_shape", "per_shape"))
    for s in ((TRAIN_FRAMES, 24, 24, 48), (TRAIN_FRAMES, 48, 48, 24)):
        warp_rows(s, flow(*s[:3]), ("other_shapes", "per_shape"))
    for s_, c in PWC_LEVELS[1:]:
        fl = (_pwc_flow(g, dev, TRAIN_FRAMES, s_) * (s_ / (s_ - 1.0))
              ).contiguous()
        warp_rows((TRAIN_FRAMES, s_, s_, c), fl, ("pwc_shapes", "pwc_shapes"))
    warp_rows((3, 13, 22, 5), flow(3, 13, 22), ("other_shapes",
                                                 "other_shapes"), False)
    torch.cuda.empty_cache()

    # the cost volume's backward: AlignLite's three levels, PWC-Net's five,
    # an odd C on a ragged plane
    def corr_rows(s, where, timed=True):
        first, second = randn(*s), randn(*s)
        gout = randn(*s[:3], NUM_OFFSETS)
        for name, fn, plain, operand in (
                ("correlation_dfirst", correlation_dfirst,
                 correlation_dfirst_plain, second),
                ("correlation_dsecond", correlation_dsecond,
                 correlation_dsecond_plain, first)):
            row = check_bf16(f"{name} bf16 {list(s)}",
                             lambda: fn(operand, gout),
                             lambda: plain(operand, gout),
                             lambda: plain(operand.float().abs(),
                                           gout.float().abs()))
            row.update(shape=list(s))
            if timed:
                bms, by = bound((2 * first.numel() + gout.numel()) * 2,
                                2 * NUM_OFFSETS * first.numel())
                row.update(bound_ms=bms, bound_by=by, **timings(
                    name, lambda: fn(operand, gout),
                    lambda: plain(operand, gout)))
            rows[name][where].append(row)

    for s in ((TRAIN_FRAMES, 12, 12, 96), (TRAIN_FRAMES, 24, 24, 48),
              (TRAIN_FRAMES, 48, 48, 24)):
        corr_rows(s, "per_shape")
    for s_, c in PWC_LEVELS:
        corr_rows((TRAIN_FRAMES, s_, s_, c), "pwc_shapes")
    corr_rows((2, 13, 22, 5), "other_shapes", False)
    torch.cuda.empty_cache()

    # the merge backward at the training merge's shape, and at C = 12 on a
    # ragged plane
    for s, where in (((TRAIN_B, TRAIN_N, 48, 48, 512), "per_shape"),
                     ((2, 3, 13, 22, 12), "other_shapes")):
        feat, logits = randn(*s), randn(*s, scale=3.0)
        gout = randn(s[0], *s[2:])
        lf, ff, gf = logits.float(), feat.float(), gout.float()
        w = torch.softmax(lf, dim=1)
        wg = (w * gf[:, None]).abs()
        dl_scale = wg * (ff.abs() + (w * ff.abs()).sum(1, keepdim=True))
        del lf, ff, gf, w
        row = check_bf16(f"merge backward d_feat bf16 {list(s)}",
                         lambda: merge_backward(feat, logits, gout)[0],
                         lambda: fused_softmax_merge_backward_plain(
                             feat, logits, gout)[0], lambda: wg)
        row_dl = check_bf16(f"merge backward d_logits bf16 {list(s)}",
                            lambda: merge_backward(feat, logits, gout)[1],
                            lambda: fused_softmax_merge_backward_plain(
                                feat, logits, gout)[1], lambda: dl_scale)
        del wg, dl_scale
        row.update(shape=list(s),
                   bit_equal_share=min(row["bit_equal_share"],
                                       row_dl["bit_equal_share"]),
                   max_ulps=max(row["max_ulps"], row_dl["max_ulps"]),
                   max_abs_err=max(row["max_abs_err"],
                                   row_dl["max_abs_err"]))
        if where == "per_shape":
            xs = (feat.clone().requires_grad_(True),
                  logits.clone().requires_grad_(True))
            out = fused_softmax_merge_plain(*xs)
            n = feat.numel()
            bms, by = bound((4 * n + gout.numel()) * 2, 16 * n)
            row.update(bound_ms=bms, bound_by=by, **timings(
                "merge_backward", lambda: merge_backward(feat, logits, gout),
                lambda: fused_softmax_merge_backward_plain(feat, logits,
                                                           gout),
                lambda: torch.autograd.grad(out, xs, gout,
                                            retain_graph=True)))
            del xs, out
        rows["merge_backward"][where].append(row)
        del feat, logits, gout
    torch.cuda.empty_cache()

    # the s2d conv's d_input: the output gradient of one of the decoder's
    # 3x3 convs at B=16 (C = O = 32), and C = 5, O = 7 on a ragged plane
    for (b_, h, w_, C, O), where in (((TRAIN_B, HW * 4, HW * 4, 32, 32),
                                      "per_shape"),
                                     ((2, 13, 22, 5, 7), "other_shapes")):
        gout = randn(b_, h, w_, 4 * O)
        wt = torch.randn(O, C, 3, 3, generator=g, device=dev) \
            / math.sqrt(9 * C)
        rot = rotate_weight(wt)
        row = check_bf16(f"conv_s2d d_input bf16 {list(gout.shape)}",
                         lambda: conv3x3_s2d_forward(gout, rot),
                         lambda: conv3x3_s2d_plain(gout, rot),
                         lambda: conv3x3_s2d_plain(
                             gout.float().abs(), rot.to(bf).float().abs()))
        row.update(shape=[list(gout.shape), [b_, h, w_, 4 * C]])
        if where == "per_shape":
            dense = s2d_conv_kernel(wt).to(bf)
            g_nchw = gout.permute(0, 3, 1, 2)
            in_size = (b_, 4 * C, h, w_)
            bms, by = bound((gout.numel() + gout.numel() // O * C) * 2,
                            2 * 9 * C * gout.numel(), BF16_FLOPS_PER_S)
            row.update(bound_ms=bms, bound_by=by, **timings(
                "conv_s2d", lambda: conv3x3_s2d_forward(gout, rot),
                lambda: conv3x3_s2d_plain(gout, rot),
                lambda: torch.nn.grad.conv2d_input(in_size, dense, g_nchw,
                                                   padding=1)))
        rows["conv_s2d"][where].append(row)
        del gout
    torch.cuda.empty_cache()
    return rows


def add_bf16_training_rows(entries, rows):
    """Put each kernel's bf16 backward rows beside its other ones
    (``bf16_training``; the s2d conv's d_input rows): sums over one pass of
    its path, and over PWC-Net's shapes as ``pwc_*``."""
    for e in entries:
        r = rows.get(e["name"])
        if not r:
            continue
        b = dict(dtype="bfloat16", **r)
        every = r["per_shape"] + r["pwc_shapes"] + r["other_shapes"]
        for key, part in (("", r["per_shape"]), ("pwc_", r["pwc_shapes"])):
            if not part:
                continue
            for k in ("ms", "device_ms", "kernel_device_ms", "plain_ms",
                      "bound_ms"):
                b[key + k] = sum(x[k] for x in part)
            for k in ("library_ms", "library_device_ms"):
                libs = [x[k] for x in part]
                b[key + k] = sum(libs) if None not in libs else None
        b["bound_by"] = ("bytes" if all(x["bound_by"] == "bytes"
                                        for x in r["per_shape"])
                         else "operations")
        b["max_abs_err"] = max(x["max_abs_err"] for x in every)
        b["repeat_equal"] = all(x["repeat_equal"] for x in every)
        if e["name"] == "warp_dflow":
            b["max_rel_to_terms"] = max(x["rel_to_terms"] for x in every)
        else:
            b["bit_equal_share"] = min(x["bit_equal_share"] for x in every)
            b["max_ulps"] = max(x["max_ulps"] for x in every)
        e["bf16_training"] = b
        for x in r["per_shape"] + r["pwc_shapes"]:
            log_row(f"{e['name']} bf16 backward", x)
        log(f"  {e['name']} bf16 backward, one pass of its path: device "
            f"{b['device_ms']:.4f} ms, bound {b['bound_ms']:.4f} "
            f"({b['bound_by']})")


def bf16_step_vs_cpu(what, batch, run_step):
    """One train step at B=1 in bf16 and in float32, on the card and on the
    CPU, from one ``batch``: the card's bf16 loss within BF16_STEP_LOSS_RTOL
    of the CPU's, and the card's bf16 gradients (all together) no farther
    from the card's float32 ones than twice the CPU's bf16 from the CPU's
    float32. ``run_step(batch, device, dtype) -> (loss, grads, offsets,
    mask, module_grads)``; where ``module_grads`` (each module's output
    gradient, in the order the backward reached them) is given, each
    module's card-vs-CPU distance is recorded in float32 and in bf16 and
    the first module past MODULE_DEPART (by dtype) is named. The offsets that fall on the two sides of a whole pixel on the
    two devices (the merge's floor-mod, a jump of the model) are counted,
    not avoided: in bf16 the aligner's flow differs between the devices by
    ~1e-3 px, so that among the 32k offsets of a batch some always do (one
    moved a float32 loss by 3-6e-6, phase 7a), far below the loss limit;
    the gradient limit compares each device with itself. So are the
    pixels where SCA's masks differ (``mask``, the real-world step)."""
    runs = {}
    for device in ("cuda", "cpu"):
        for dtype in ("bfloat16", None):
            t0 = time.perf_counter()
            runs[device, dtype] = run_step(batch, device, dtype) + (
                time.perf_counter() - t0,)
    o_card, o_cpu = runs["cuda", "bfloat16"][2], runs["cpu", "bfloat16"][2]
    wrapped = int((torch.floor(o_card) != torch.floor(o_cpu)).sum())
    m_card, m_cpu = runs["cuda", "bfloat16"][3], runs["cpu", "bfloat16"][3]
    mask_diff = None if m_card is None else int((m_card != m_cpu).sum())

    def dist(a, b):
        d2 = sum(float(((a[k] - b[k]).double() ** 2).sum()) for k in b)
        n2 = sum(float((b[k].double() ** 2).sum()) for k in b)
        return math.sqrt(d2 / n2)

    l_card, g_card = runs["cuda", "bfloat16"][:2]
    l_cpu, g_cpu = runs["cpu", "bfloat16"][:2]
    loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
    card = dist(g_card, runs["cuda", None][1])
    cpu = dist(g_cpu, runs["cpu", None][1])
    modules = {}
    if runs["cpu", None][4] is not None:
        for dtype in (None, "bfloat16"):
            card_m, cpu_m = runs["cuda", dtype][4], runs["cpu", dtype][4]
            key = dtype or "float32"
            modules[key] = [(k, float((card_m[k] - cpu_m[k]).norm())
                             / max(float(cpu_m[k].norm()), 1e-30))
                            for k in cpu_m if k in card_m]
            first = next(((k, r) for k, r in modules[key]
                          if r > MODULE_DEPART[key]), None)
            log(f"{what}, {key}: each module's output gradient, card vs "
                f"CPU, in the order the backward reached them (the first "
                f"past {MODULE_DEPART[key]}: {first}):")
            for k, r in modules[key][:60]:
                log(f"    {r:.3e}  {k}")
            modules[key + "_first_past"] = first
    res = dict(loss_card=l_card, loss_cpu=l_cpu, loss_rel=loss_rel,
               loss_f32_card=runs["cuda", None][0],
               loss_f32_cpu=runs["cpu", None][0], card_bf16_vs_f32=card,
               cpu_bf16_vs_f32=cpu, card_vs_cpu_bf16=dist(g_card, g_cpu),
               offsets_card_vs_cpu_max_px=float((o_card - o_cpu).abs().max()),
               offsets_wrapped=wrapped, mask_pixels_differing=mask_diff,
               cpu_step_s=runs["cpu", "bfloat16"][5], modules=modules)
    log(f"{what}, card vs CPU in bf16: loss {l_card:.6f} vs {l_cpu:.6f} "
        f"(rel {loss_rel:.2e}, limit {BF16_STEP_LOSS_RTOL}; float32 "
        f"{res['loss_f32_card']:.6f} / {res['loss_f32_cpu']:.6f}); "
        f"gradients: the card's bf16 vs its float32 {card:.3e} (limit 2 x "
        f"{cpu:.3e}, the CPU's bf16 vs its float32); card vs CPU in bf16 "
        f"{res['card_vs_cpu_bf16']:.3e}; bf16 offsets max|diff| "
        f"{res['offsets_card_vs_cpu_max_px']:.3e} px, {wrapped} wrapped on "
        f"one side only; SCA masks differ at {mask_diff} pixels; CPU bf16 "
        f"step {res['cpu_step_s']:.1f} s")
    if not (loss_rel <= BF16_STEP_LOSS_RTOL and card <= 2 * cpu):
        raise AssertionError(f"{what}: bf16 card vs CPU: {res}")
    return res


def bf16_synthetic_grad_phase():
    """Phase 15b: one ``default_synthetic`` step of the banked flagship
    (AlignLite frozen, the s2d decoder, as the config builds it) at B=1,
    N=8, card vs CPU, bf16 vs float32 (``bf16_step_vs_cpu``), on the first
    batch seed of phase 7a."""
    from dbsr_tpu_torch.data.procedural import (dead_leaves_image,
                                                make_generator)
    from dbsr_tpu_torch.data.synthetic import BurstConfig, synthesize_batch
    from dbsr_tpu_torch.serving import FLAGSHIP_CHECKPOINT, float32_math
    from dbsr_tpu_torch.training.actors import make_synthetic_actor
    from dbsr_tpu_torch.training.checkpoint import load_network

    cfg = BurstConfig(fused_resample=True)

    gen = make_generator("cpu", BATCH_SEEDS[0])
    batch = synthesize_batch(gen, dead_leaves_image(gen, 1, cfg.pre_crop_sz),
                             cfg)

    def run_step(batch, device, dtype):
        net, _ = load_network(FLAGSHIP_CHECKPOINT, device=device,
                              dtype=dtype)
        seen, module_grads = {}, {}

        def keep(name):
            def fwd(m, i, o):
                if isinstance(o, torch.Tensor) and o.requires_grad:
                    o.register_hook(lambda gr: module_grads.__setitem__(
                        name, gr.detach().float().cpu()))
            return fwd

        hooks = [net.encoder.register_forward_hook(
            lambda m, i, o: seen.__setitem__("o", o["offsets"].detach()))]
        hooks += [m.register_forward_hook(keep(n))
                  for n, m in net.named_modules()
                  if n.count(".") <= 2 and n and not n.startswith(
                      "encoder.alignment_net")]
        b = {k: batch[k].to(device) for k in ("burst", "frame_gt")}
        with float32_math():
            loss, _ = make_synthetic_actor(net, boundary_ignore=40)(b)
            loss.backward()
        for h in hooks:
            h.remove()
        return (loss.item(), _grads(net), seen["o"].cpu(), None,
                module_grads)

    return bf16_step_vs_cpu("default_synthetic bf16 step (flagship, B=1, "
                            "N=8)", batch, run_step)


def bf16_realworld_grad_phase(root, ckpt):
    """Phase 15c: one ``default_realworld`` step of ``ckpt`` at B=1 (8
    frames, 56-px crops of the train tree) card vs CPU, bf16 vs float32
    (``bf16_step_vs_cpu``)."""
    import copy

    from dbsr_tpu_torch.data.burstsr import (BurstSRDataset,
                                             BurstSRProcessing,
                                             RandomBurstSampler)
    from dbsr_tpu_torch.evaluation.burstsr import _alignment_apply_from
    from dbsr_tpu_torch.models import sca as sca_mod
    from dbsr_tpu_torch.serving import float32_math
    from dbsr_tpu_torch.training.actors import make_realworld_actor
    from dbsr_tpu_torch.training.checkpoint import load_network

    sample = RandomBurstSampler(
        BurstSRDataset(root, split="train"), burst_size=RW_N,
        samples_per_epoch=1, seed=BATCH_SEEDS[0],
        processing=BurstSRProcessing(crop_sz=56, substract_black_level=True,
                                     random_flip=True))[0]

    def run_step(sample, device, dtype):
        net, _ = load_network(ckpt, device=device, dtype=dtype)
        sca = sca_mod.make_sca(_alignment_apply_from(
            copy.deepcopy(net.encoder.alignment_net)), sr_factor=4)
        seen = {}

        def spied(pred, gt, burst):
            pw, valid = sca(pred, gt, burst)
            seen["mask"] = valid.cpu()
            return pw, valid

        hook = net.encoder.register_forward_hook(
            lambda m, i, o: seen.__setitem__("o", o["offsets"].detach()))
        batch = {k: torch.from_numpy(sample[k])[None].to(device)
                 for k in ("burst", "frame_gt")}
        with float32_math():
            loss, _ = make_realworld_actor(net, spied)(batch)
            loss.backward()
        hook.remove()
        return (loss.item(), _grads(net), seen["o"].cpu(), seen["mask"],
                None)

    return bf16_step_vs_cpu(
        "default_realworld bf16 step (B=1, N=8, 56-px crops)", sample,
        run_step)


def bf16_training_phase(dev, workdir):
    """Phase 15b-c: ``run_training dbsr default_synthetic`` with its
    defaults (bf16, the s2d decoder, the s2d conv on the card) at full
    width, B=16: the banked AlignLite frozen, the banked PWC-Net frozen,
    and the fallback (a fresh PWC-Net trained end to end), one epoch each,
    exact launches per step, the step's ms, busy share and peak memory
    (step_phase); the first one's step again with
    ``torch.backends.cudnn.deterministic=True`` (timed, not kept on), and
    twice from one state and batch (which gradients differ, recorded);
    the flagship's bf16 step card vs CPU; then ``default_realworld`` from
    the AlignLite run's bf16 checkpoint: restored in bf16, one epoch with
    exact launches, its step's time, card vs CPU. Returns the numbers and
    the launches per step of each path."""
    from dbsr_tpu_torch.configs.dbsr import default_realworld
    from dbsr_tpu_torch.data.procedural import make_generator
    from dbsr_tpu_torch.models.layers import compute_dtype_of
    from dbsr_tpu_torch.serving import float32_math
    from dbsr_tpu_torch.training.checkpoint import (read_header,
                                                    resolve_checkpoint)

    out, paths = {}, {}
    kw = dict(steps_per_epoch=BF16_STEPS, pool_size=128,
              print_interval=BF16_STEPS)
    for name, path, extra, want in (
            ("train_step_bf16", "lite", dict(pwc_checkpoint=ALIGN_LITE),
             LAUNCHES_PER_BF16_STEP),
            ("pwc_frozen_step_bf16", "pwc", dict(pwc_checkpoint=PWC_SYNTH),
             LAUNCHES_PER_BF16_PWC_FROZEN_STEP),
            ("pwc_fallback_step_bf16", "fallback", {},
             LAUNCHES_PER_BF16_PWC_UNFROZEN_STEP)):
        ws = os.path.join(workdir, "bf16", path)
        os.environ["DBSR_TPU_WORKSPACE_DIR"] = ws
        per_step, logged, _, headers = entry_phase(
            "dbsr", "default_synthetic", dict(kw, **extra), (1,), want,
            "dbsr_synthetic", pool_round_launches(kw["pool_size"]))
        spec = headers[1]["net_spec"]["kwargs"]
        if spec["dtype"] != {"__dtype__": "bfloat16"} \
                or not spec["fused_s2d_decoder"]:
            raise AssertionError(f"{name}: header {spec}")
        paths[name] = per_step
        trainer, state = default_synthetic_trainer(
            dev, compute_dtype="bfloat16", fused_s2d_decoder=True, **extra)
        if compute_dtype_of(trainer.net) != torch.bfloat16:
            raise AssertionError(f"{name}: the trainer's net is not bf16")
        res = dict(losses=logged["Loss/total"], step=step_phase(
            dev, f"default_synthetic bf16 ({path})", trainer, state, want,
            n_steps=8))
        if path == "lite":
            cudnn = torch.backends.cudnn
            pool = trainer.loaders[0].batcher.next_batch()
            timed = {}
            for det in (True, False):
                cudnn.deterministic = det
                try:
                    timed[det] = cuda_ms(lambda: trainer.train_step(
                        state, make_generator(dev, 7), pool), 2, 5)
                finally:
                    cudnn.deterministic = False
            res["cudnn_deterministic_ms"] = timed[True]
            res["cudnn_default_ms"] = timed[False]
            log(f"default_synthetic bf16 step at B={TRAIN_B}: "
                f"{timed[False]:.2f} ms, {timed[True]:.2f} ms with "
                f"cudnn.deterministic=True (CUDA events, median of 5)")
            with float32_math():
                batch = trainer.prepare_fn(make_generator(dev, 7), pool)
            res["step_twice"] = _compare_runs(
                f"determinism, bf16 frozen step B={TRAIN_B} (s2d decoder)",
                trainer.net, _repeat_step(trainer.actor_fn, trainer.net,
                                          batch))
            del batch
        del trainer, state
        torch.cuda.empty_cache()
        out[path] = res
    out["card_vs_cpu"] = bf16_synthetic_grad_phase()
    torch.cuda.empty_cache()

    # (c) default_realworld from (b)'s bf16 AlignLite checkpoint
    ws = os.path.join(workdir, "bf16", "lite")
    os.environ["DBSR_TPU_WORKSPACE_DIR"] = ws
    syn = resolve_checkpoint(os.path.join(ws, "dbsr", "default_synthetic"),
                             "dbsr_synthetic")
    per_step, logged, texts, headers = entry_phase(
        "dbsr", "default_realworld",
        dict(steps_per_epoch=RW_STEPS, print_interval=RW_STEPS), (1,),
        LAUNCHES_PER_BF16_RW_STEP, "dbsr_realworld")
    if f"restored {syn}" not in texts[0] or headers[1]["net_spec"]["kwargs"][
            "dtype"] != {"__dtype__": "bfloat16"}:
        raise AssertionError(f"default_realworld did not restore {syn} in "
                             f"bf16: {headers[1]['net_spec']}")
    paths["realworld_step_bf16"] = per_step
    rw = dict(restored=syn, losses=logged["Loss/total"],
              restored_dtype=read_header(syn)["net_spec"]["kwargs"]["dtype"])
    with contextlib.redirect_stdout(io.StringIO()):
        trainer, restored = default_realworld.make_trainer(
            _settings(steps_per_epoch=RW_STEPS, print_interval=RW_STEPS), dev)
    if compute_dtype_of(trainer.net) != torch.bfloat16:
        raise AssertionError("default_realworld: the restored net is not "
                             "bf16")
    state = trainer.init_state()
    trainer.net.load_state_dict(restored)
    rw["step"] = step_phase(dev, "default_realworld bf16", trainer, state,
                            LAUNCHES_PER_BF16_RW_STEP, n_steps=8,
                            batch_size=RW_B,
                            loss_must_fall=False)
    del trainer, state
    torch.cuda.empty_cache()
    rw["card_vs_cpu"] = bf16_realworld_grad_phase(
        os.environ["DBSR_TPU_BURSTSR_DIR"], syn)
    out["realworld"] = rw
    return out, paths


# ---------------------------------------------------------------------------
def _dweight_errors(got, want):
    """``got``'s distance from the float64 ``want``: the largest over the
    largest entry, and the L2 norm's share."""
    d = got.double() - want
    return dict(max_rel=float(d.abs().max() / want.abs().max()),
                l2_rel=float(d.norm() / want.norm()))


def s2d_dweight_phase(dev, g):
    """Phase 15d: the s2d decoder's weight gradient kernel
    (``conv3x3_s2d_dweight``; bf16 operands, float32 out) against a float64
    reference on the same bf16-valued operands, beside cuDNN's float32
    weight gradient on the unfolded tensors (the float32 route of
    ``Conv3x3S2D``, TF32 off), and against the plain version; the same bits
    twice; timed at the training launch; the routing of ``Conv3x3S2D``.
    Returns the kernel's entry of the kernels line, its launches read on
    ``train_step_bf16`` (phase 15b's bf16 step counts them), with the
    routes."""
    from dbsr_tpu_torch.models.layers import depth_to_space_phase_major
    from dbsr_tpu_torch.ops.conv_s2d import (_unfold_nchw, conv3x3_s2d,
                                             conv3x3_s2d_dweight,
                                             conv3x3_s2d_dweight_plain)

    def float32_route(x, gg, wshape):
        cudnn = torch.backends.cudnn
        tf32, cudnn.allow_tf32 = cudnn.allow_tf32, False
        try:
            return torch.nn.grad.conv2d_weight(
                _unfold_nchw(x), wshape, _unfold_nchw(gg), padding=1)
        finally:
            cudnn.allow_tf32 = tf32

    def reference(x, gg, wshape):
        def nchw(t):
            return depth_to_space_phase_major(t.double(), 2).permute(
                0, 3, 1, 2)
        return torch.nn.grad.conv2d_weight(nchw(x), wshape, nchw(gg),
                                           padding=1)

    rows = []
    shapes = [(DWEIGHT_TRAIN, "signed"), (DWEIGHT_TRAIN, "relu")] + [
        (s, "signed") for s in DWEIGHT_ODD]
    for shape, kind in shapes:
        b, h2, w2, c, o = shape
        x = torch.randn(b, h2, w2, 4 * c, generator=g, device=dev)
        if kind == "relu":
            x = x.clamp_min(0)
        x = x.to(torch.bfloat16)
        gg = torch.randn(b, h2, w2, 4 * o, generator=g,
                         device=dev).to(torch.bfloat16)
        wshape = (o, c, 3, 3)
        n0 = conv3x3_s2d_dweight.launches
        got = conv3x3_s2d_dweight(x, gg, wshape)
        again = conv3x3_s2d_dweight(x, gg, wshape)
        torch.cuda.synchronize()
        if conv3x3_s2d_dweight.launches - n0 != 2:
            raise AssertionError(f"15d {shape}: "
                                 f"{conv3x3_s2d_dweight.launches - n0} "
                                 "launches counted for 2 calls")
        want = reference(x, gg, wshape)
        plain = conv3x3_s2d_dweight_plain(x, gg, wshape)
        row = dict(shape=list(shape), x=kind,
                   same_bits=bool(torch.equal(got, again)),
                   max_abs_err=float((got - plain).abs().max()),
                   kernel_vs_plain=_dweight_errors(got, plain.double()),
                   kernel=_dweight_errors(got, want),
                   cudnn_float32=_dweight_errors(
                       float32_route(x, gg, wshape), want),
                   plain=_dweight_errors(plain, want))
        log(f"  dweight {shape} x {kind}: same bits twice "
            f"{row['same_bits']}; vs float64, kernel {row['kernel']}, "
            f"cuDNN float32 {row['cudnn_float32']}, plain {row['plain']}; "
            f"kernel vs plain {row['kernel_vs_plain']} (limit "
            f"{DWEIGHT_RTOL} of the largest entry)")
        if not row["same_bits"]:
            raise AssertionError(f"15d {shape}: two calls differ")
        for ref in ("kernel", "kernel_vs_plain"):
            if not row[ref]["max_rel"] <= DWEIGHT_RTOL:
                raise AssertionError(f"15d {shape}: {ref} {row[ref]}")
        if shape == DWEIGHT_TRAIN:
            if any(row["kernel"][k] > row["cudnn_float32"][k]
                   for k in ("max_rel", "l2_rel")):
                raise AssertionError(f"15d {shape} x {kind}: the kernel's "
                                     f"error {row['kernel']} above cuDNN's "
                                     f"{row['cudnn_float32']}")
            if kind == "signed":
                xu, gu = _unfold_nchw(x), _unfold_nchw(gg)
                nbytes = (x.numel() + gg.numel()) * 2 + o * c * 9 * 4
                flops = 2 * b * 4 * h2 * w2 * 9 * c * o
                bound_ms, by = bound(nbytes, flops, BF16_FLOPS_PER_S)
                row.update(timings(
                    "conv_s2d_dweight",
                    lambda: conv3x3_s2d_dweight(x, gg, wshape),
                    lambda: conv3x3_s2d_dweight_plain(x, gg, wshape),
                    lambda: float32_route(x, gg, wshape)))
                row["library_unfolded_ms"] = cuda_ms(
                    lambda: torch.nn.grad.conv2d_weight(xu, wshape, gu,
                                                        padding=1))
                row.update(bound_ms=bound_ms, bound_by=by)
                log(f"  dweight {shape}: {row['ms']:.4f} ms a call (device "
                    f"{row['device_ms']:.4f}, kernels "
                    f"{row['kernel_device_ms']:.4f}); bound {bound_ms:.4f} "
                    f"({by}); plain {row['plain_ms']:.3f}; cuDNN float32 "
                    f"on the unfolded tensors {row['library_unfolded_ms']:.3f}"
                    f", with the unfold {row['library_ms']:.3f} (device "
                    f"{row['library_device_ms']:.3f})")
                del xu, gu
        rows.append(row)
        del x, gg, got, again, want, plain
        torch.cuda.empty_cache()

    # Conv3x3S2D: bf16 to the kernel, float32 to cuDNN
    w = torch.randn(32, 32, 3, 3, generator=g, device=dev) * 0.1
    xr = torch.randn(2, 24, 24, 128, generator=g, device=dev)
    gr = torch.randn(2, 24, 24, 128, generator=g, device=dev)
    routes = {}
    for dtype in (torch.bfloat16, torch.float32):
        xi = xr.to(dtype).requires_grad_(True)
        wi = w.clone().requires_grad_(True)
        n_conv, n_dw = conv3x3_s2d.launches, conv3x3_s2d_dweight.launches
        conv3x3_s2d(xi, wi).backward(gr.to(dtype))
        torch.cuda.synchronize()
        routes[str(dtype)] = dict(
            conv_launches=conv3x3_s2d.launches - n_conv,
            dweight_launches=conv3x3_s2d_dweight.launches - n_dw)
        if dtype == torch.bfloat16:
            same = torch.equal(wi.grad, conv3x3_s2d_dweight(
                xi.detach(), gr.to(dtype), tuple(w.shape)))
        else:
            want = float32_route(xi.detach(), gr, tuple(w.shape))
            same = bool(torch.allclose(wi.grad, want, rtol=1e-5, atol=1e-6))
        routes[str(dtype)]["weight_grad_as_its_route"] = bool(same)
    log(f"  Conv3x3S2D backward on the card: {routes}")
    if routes["torch.bfloat16"] != dict(conv_launches=2, dweight_launches=1,
                                        weight_grad_as_its_route=True) \
            or routes["torch.float32"] != dict(
                conv_launches=2, dweight_launches=0,
                weight_grad_as_its_route=True):
        raise AssertionError(f"15d: Conv3x3S2D's routes {routes}")
    # one launch's times at the training shape; train_step_bf16 launches
    # it once for each of the decoder's 8 convs
    e = _entry("conv_s2d_dweight",
               "dbsr_tpu_torch/kernels/csrc/conv_s2d_dweight.cu",
               "none: dbsr_tpu/ops/conv_s2d_pallas.py:202 leaves it to XLA",
               rows[:1], rows[1:], path="train_step_bf16")
    e.update(dtypes=["bfloat16"], routes=routes)
    torch.cuda.empty_cache()
    return e


def _bits_equal(a, b):
    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32),
                                              b.contiguous().view(torch.int32))


def dead_leaves_phase(dev):
    """Phase 15e: the dead-leaves composite kernel
    (``dead_leaves_composite``) against its plain version on the card at a
    chunk of the training pool and at odd shapes, the same bits (as int32)
    and the same bits twice; timed at the chunk beside its bound and the
    plain version; then a ``ProceduralImagePool`` round of 128 images at
    432^2: its launches (one a chunk of 32), its uint8 pool against the
    same round rendered through the plain version, both rounds' wall time
    (host clock to a synchronize, the draws, texture, blur and store
    included). Returns the kernel's entry of the kernels line, whose path
    is that round (``pool_round_128``), and every kernel's launches on it."""
    from dbsr_tpu_torch.data import procedural
    from dbsr_tpu_torch.ops.dead_leaves import (dead_leaves_composite,
                                                dead_leaves_composite_plain)

    rows = []
    for seed, shape in enumerate((DEAD_LEAVES_CHUNK,) + DEAD_LEAVES_ODD):
        n, h, w, L = shape
        draws = procedural.concat_draws([procedural.dead_leaves_draws(
            procedural.make_generator(dev, 15, seed, i), 1, num_leaves=L)
            for i in range(n)])
        bg, table = procedural.dead_leaves_table(draws, (h, w))
        reset_counts()
        got = dead_leaves_composite(bg, table, (h, w))
        again = dead_leaves_composite(bg, table, (h, w))
        torch.cuda.synchronize()
        counts = read_counts()
        if counts != {k: 2 * (k == "dead_leaves_composite") for k in counts}:
            raise AssertionError(f"15e {shape}: launches {counts} for 2 "
                                 "calls")
        plain = dead_leaves_composite_plain(bg, table, (h, w))
        row = dict(shape=list(shape),
                   same_bits_as_plain=_bits_equal(got, plain),
                   same_bits_twice=_bits_equal(got, again),
                   max_abs_err=float((got - plain).abs().max()))
        log(f"  dead leaves {shape}: the plain version's bits "
            f"{row['same_bits_as_plain']} (max |diff| "
            f"{row['max_abs_err']:.3e}), the same bits twice "
            f"{row['same_bits_twice']}")
        if not (row["same_bits_as_plain"] and row["same_bits_twice"]):
            raise AssertionError(f"15e {shape}: {row}")
        if shape == DEAD_LEAVES_CHUNK:
            nbytes = (got.numel() + table.numel() + bg.numel()) * 4
            bound_ms, by = bound(nbytes, DEAD_LEAVES_OPS * n * h * w * L,
                                 FP32_OPS_PER_S)
            row.update(timings(
                "dead_leaves_composite",
                lambda: dead_leaves_composite(bg, table, (h, w)),
                lambda: dead_leaves_composite_plain(bg, table, (h, w))))
            row.update(bound_ms=bound_ms, bound_by=by)
            log_row("dead_leaves_composite", row)
        rows.append(row)
        del draws, bg, table, got, again, plain
        torch.cuda.empty_cache()

    # a pool round through the kernel and through the plain version (the
    # render's composite swapped for it), each warmed up on round 0 first
    def round_s(pool, r):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pool.refresh(r)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    hw = DEAD_LEAVES_CHUNK[1:3]
    pool = procedural.ProceduralImagePool(DEAD_LEAVES_POOL, hw, seed=15,
                                          device=dev)
    round_s(pool, 0)
    reset_counts()
    got, kernel_s = round_s(pool, 1)
    counts = read_counts()
    launches = counts["dead_leaves_composite"]
    plain_pool = procedural.ProceduralImagePool(DEAD_LEAVES_POOL, hw,
                                                seed=15, device=dev)
    procedural.dead_leaves_composite = dead_leaves_composite_plain
    try:
        round_s(plain_pool, 0)
        want, plain_s = round_s(plain_pool, 1)
    finally:
        procedural.dead_leaves_composite = dead_leaves_composite
    pool_round = dict(images=DEAD_LEAVES_POOL, hw=list(hw),
                      launches=launches, same_pool=bool(torch.equal(got,
                                                                    want)),
                      kernel_round_s=kernel_s, plain_round_s=plain_s)
    log(f"  a pool round of {DEAD_LEAVES_POOL} at {hw}: {launches} launches, "
        f"the plain version's uint8 pool {pool_round['same_pool']}; "
        f"{kernel_s * 1e3:.1f} ms a round (the plain version's "
        f"{plain_s * 1e3:.1f})")
    want = {k: 0 for k in counts}
    want["dead_leaves_composite"] = pool_round_launches(DEAD_LEAVES_POOL)
    if counts != want or not pool_round["same_pool"]:
        raise AssertionError(f"15e: the pool round {pool_round}, launches "
                             f"{counts}, expected {want}")
    del pool, plain_pool, got, want
    torch.cuda.empty_cache()
    e = _entry("dead_leaves_composite",
               "dbsr_tpu_torch/kernels/csrc/dead_leaves.cu",
               "none: dbsr_tpu/data/procedural.py:109 (dead_leaves_image's "
               "leaf loop) leaves it to XLA", rows[:1], rows[1:],
               path="pool_round_128")
    e["pool_round"] = pool_round
    return e, counts


# phase 16: training data beyond dead leaves


def _to_cpu(draws):
    return {k: [t.cpu() for t in v] if isinstance(v, list) else v.cpu()
            for k, v in draws.items()}


def _u8(img):
    return (img * 255.0 + 0.5).to(torch.uint8)


def check_u8(what, got, want):
    """uint8 images: at least GEN_U8_SHARE of the values equal, none more
    than 1 LSB apart. Returns (share equal, most LSBs apart)."""
    diff = (got.int() - want.int()).abs()
    share = (diff == 0).float().mean().item()
    worst = int(diff.max().item())
    log(f"  {what}: uint8 {100 * share:.4f}% equal, at most {worst} LSB apart")
    if share < GEN_U8_SHARE or worst > 1:
        raise AssertionError(f"{what}: uint8 card vs CPU {share} equal, "
                             f"{worst} LSB apart")
    return share, worst


def mixed_pool_phase(dev):
    """Phase 16a: each generator of the mixed corpus rendered on the card
    and on the CPU from the same draws, its ms per image on the card (a
    chunk of 64, CUDA events); the mixed pool of 128 at 432^2 in two chunks
    of 64 (its plan, ms per image), the first image of each chunk against
    the CPU's rendering of its own stream."""
    from dbsr_tpu_torch.data import procedural as P

    hw = (432, 432)
    out = {"generators": {}}
    for k, (name, (draw, render)) in enumerate(P.GENERATORS.items()):
        draws = draw(P.make_generator(dev, 16, k), GEN_CHECK_N)
        card = render(draws, hw)
        cpu = render(_to_cpu(draws), hw)
        err = (card.cpu() - cpu).abs().max().item()
        log(f"  {name}: {GEN_CHECK_N} images of {hw}, max|card - cpu| = "
            f"{err:.3e} (limit {GEN_ATOL:.0e})")
        if not err <= GEN_ATOL:
            raise AssertionError(f"{name}: card vs CPU {err} > {GEN_ATOL}")
        share, worst = check_u8(name, _u8(card).cpu(), _u8(cpu))
        chunk = draw(P.make_generator(dev, 17, k), MIXED_CHUNK)
        ms = cuda_ms(lambda: render(chunk, hw), 1, 3) / MIXED_CHUNK
        log(f"  {name}: {ms:.4f} ms per image on the card (a chunk of "
            f"{MIXED_CHUNK})")
        out["generators"][name] = dict(max_abs_err=err, u8_equal_share=share,
                                       u8_max_lsb=worst, ms_per_image=ms)
        del draws, card, cpu, chunk
    torch.cuda.empty_cache()
    pool = P.ProceduralImagePool(MIXED_POOL, hw, seed=MIXED_SEED,
                                 chunk=MIXED_CHUNK, device=dev, mix="mixed")
    plan = pool.plan(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    images = pool.refresh(0)
    torch.cuda.synchronize()
    pool_s = time.perf_counter() - t0
    log(f"  mixed pool of {MIXED_POOL} at {hw}, chunks of {MIXED_CHUNK}: "
        f"plan {plan}, {pool_s * 1e3 / MIXED_POOL:.4f} ms per image")
    for c, name in enumerate(plan):
        i = c * MIXED_CHUNK
        draw, render = P.GENERATORS[name]
        cpu = render(_to_cpu(draw(P.make_generator(dev, MIXED_SEED, 0, i), 1)),
                     hw)
        check_u8(f"pool image {i} ({name})", images[i:i + 1].cpu(), _u8(cpu))
    out.update(plan=plan, pool_ms_per_image=pool_s * 1e3 / MIXED_POOL)
    del pool, images
    torch.cuda.empty_cache()
    return out


def warp_affine_phase(dev, g):
    """Phase 16d (run beside phase 3, as the other timed rows): the resample
    kernel through ``warp_affine`` at [8, 432, 432, 3] with rotation, shear
    and scale, bit-equal to the plain version at the same inverse affines
    (the resample's limit), timed and bounded as its rows, the launches of
    one call counted. Returns the row and the counts."""
    from dbsr_tpu_torch.ops.interp import (apply_affine_to_points,
                                           invert_2x3, warp_affine)
    from dbsr_tpu_torch.ops.resample import affine_resample_plain
    from dbsr_tpu_torch.ops.warp import base_grid

    B, H, W, C = WARP_AFFINE_SHAPE
    im = torch.rand(WARP_AFFINE_SHAPE, generator=g, device=dev)
    u = torch.rand((B, 5), generator=g, device=dev)
    th, shear, scale = (u[:, 0] - 0.5) * 0.4, (u[:, 1] - 0.5) * 0.3, \
        0.85 + 0.3 * u[:, 2]
    tmat = torch.stack([
        torch.stack([scale * th.cos(), shear - th.sin(), (u[:, 3] - 0.5) * 8],
                    -1),
        torch.stack([th.sin(), 1.1 * scale * th.cos(), (u[:, 4] - 0.5) * 8],
                    -1)], -2)
    invs = invert_2x3(tmat)[:, None].contiguous()
    reset_counts()
    got = warp_affine(im, tmat)
    torch.cuda.synchronize()
    counts = read_counts()
    want = {k: int(k == "resample") for k in counts}
    log(f"  warp_affine {list(im.shape)}: launches {counts}")
    if counts != want:
        raise AssertionError(f"warp_affine: launches {counts}, expected "
                             f"{want}")

    def plain():
        return affine_resample_plain(im, invs, (H, W), 1, 0)[:, 0]

    err = check_exact(f"warp_affine {list(im.shape)} (shear, scale)", got,
                      plain())
    grid = _grid_sample_grid(apply_affine_to_points(
        invs[:, 0], base_grid(H, W, dev)), H, W)
    nchw = im.permute(0, 3, 1, 2)
    nb = (im.numel() + tmat.numel() + got.numel()) * 4
    bms, by = bound(nb, got.numel() // C * (20 + 8 * C))
    row = dict(shape=[list(im.shape), list(got.shape)], path="warp_affine",
               max_abs_err=err, bound_ms=bms, bound_by=by,
               **timings("resample", lambda: warp_affine(im, tmat), plain,
                         lambda: F.grid_sample(nchw, grid,
                                               align_corners=False,
                                               padding_mode="zeros")))
    log_row("resample (warp_affine)", row)
    return row, counts


def _write_pngs(root):
    """HOST_PNGS 8-bit RGB PNGs of HOST_PNG_HW^2 (smooth fields with
    edges, from a fixed seed) written by the port's png16."""
    from dbsr_tpu_torch.utils.png16 import write_png

    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(16)
    n = HOST_PNG_HW
    for i in range(HOST_PNGS):
        low = rng.rand(n // 16, n // 16, 3)
        img = np.kron(low, np.ones((16, 16, 1))) * 0.7 \
            + 0.3 * rng.rand(n, n, 3)
        write_png(os.path.join(root, f"{i:02d}.png"),
                  (img * 255).astype(np.uint8))
    return root


def mixed_training_phase(dev, workdir):
    """Phase 16b: ``run_training dbsr default_synthetic --set mix=mixed``,
    bf16 by default, B=16, the banked AlignLite frozen, a pool of 128, one
    epoch of 5 steps, exact launches per step (15b's frozen bf16 step's)
    and one of the dead-leaves composite a dead-leaves chunk of the round;
    then its step's time, samples/s, peak memory and busy share on a fixed
    batch (step_phase)."""
    from dbsr_tpu_torch.data.procedural import ProceduralImagePool

    os.environ["DBSR_TPU_WORKSPACE_DIR"] = os.path.join(workdir, "mixed")
    kw = dict(steps_per_epoch=BF16_STEPS, pool_size=MIXED_POOL,
              print_interval=BF16_STEPS, pwc_checkpoint=ALIGN_LITE,
              mix="mixed")
    # the dead-leaves chunks of the round's plan alone launch the composite
    dead_chunks = ProceduralImagePool(MIXED_POOL, (1, 1), device="cpu",
                                      mix="mixed").plan(0).count("dead_leaves")
    per_step, logged, texts, headers = entry_phase(
        "dbsr", "default_synthetic", kw, (1,), LAUNCHES_PER_BF16_STEP,
        "dbsr_synthetic", dead_chunks)
    if "mix=mixed" not in texts[0] or headers[1]["net_spec"]["kwargs"][
            "dtype"] != {"__dtype__": "bfloat16"}:
        raise AssertionError("default_synthetic mix=mixed did not train the "
                             "mixed pool in bf16")
    trainer, state = default_synthetic_trainer(
        dev, compute_dtype="bfloat16", fused_s2d_decoder=True,
        pwc_checkpoint=ALIGN_LITE, mix="mixed")
    step = step_phase(dev, "default_synthetic bf16, mix=mixed", trainer,
                      state, LAUNCHES_PER_BF16_STEP, n_steps=8)
    del trainer, state
    torch.cuda.empty_cache()
    return per_step, dict(losses=logged["Loss/total"], step=step)


def _feed(trainer, steps):
    f = trainer.feed["train"]
    return dict(ms_per_step=f["cycle_s"] * 1e3 / steps,
                host_ms_per_batch=f["batch_s"] * 1e3 / steps,
                wait_ms_per_step=f["wait_s"] * 1e3 / steps)


def _timed_epoch(what, trainer, epoch, steps, per_step_want,
                 batch_size=TRAIN_B):
    """``trainer.train(epoch)`` resumed from epoch ``epoch - 1``, the counts
    reset just before and read just after: exact launches, the cycle's ms
    per step from the prefetcher's feed (the steps and the waits on the
    queue), the worker's ms per batch, peak memory; before it, the ms of
    one batch made (and put on the card) alone on this thread, median of
    three."""
    batcher, put = trainer.loaders[0].batcher, trainer.device_put or (
        lambda b: b)
    alone = []
    for _ in range(3):
        t0 = time.perf_counter()
        put(batcher.next_batch())
        torch.cuda.synchronize()
        alone.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        state = trainer.train(epoch)
    torch.cuda.synchronize()
    check_counts(what, read_counts(), steps, per_step_want)
    losses = [float(v) for v in re.findall(
        r"Loss/total: (-?[\d.]+(?:e-?\d+)?|nan|inf)", buf.getvalue())]
    if state.step != epoch * steps or not losses \
            or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{what}: step {state.step}, losses {losses}")
    res = dict(_feed(trainer, steps), losses=losses,
               host_alone_ms_per_batch=statistics.median(alone),
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    res["samples_per_s"] = batch_size / res["ms_per_step"] * 1e3
    log(f"{what}: {res['ms_per_step']:.2f} ms per step through the prefetcher "
        f"({res['samples_per_s']:.2f} samples/s), the step waited "
        f"{res['wait_ms_per_step']:.2f} ms on the queue, the worker "
        f"{res['host_ms_per_batch']:.2f} ms a batch (alone on this thread "
        f"{res['host_alone_ms_per_batch']:.2f}); peak "
        f"{res['peak_mem_gib']:.2f} GiB; losses {losses}")
    return res


def host_fed_phase(dev, workdir, png_dir):
    """Phase 16c: the host-fed path at full width, bf16, B=16: a ``Trainer``
    on ``CropBatcher(RandomImageSampler([ImageFolder(16 PNGs of 512^2)]))``
    with ``make_data``'s host ``prepare_fn`` and the prefetcher's pinned
    ``device_put``, the AlignLite checkpoint grafted and frozen; the first
    batch copied to the card bit-equal to the same batcher's on the CPU; an
    epoch of 5 steps to warm up, then one timed (exact launches, ms per
    step, the worker's ms per batch, the wait on the queue)."""
    from dbsr_tpu_torch.configs.dbsr.default_synthetic import (
        burst_config, graft_alignment_params, make_crop_prepare_fn)
    from dbsr_tpu_torch.data.datasets import ImageFolder
    from dbsr_tpu_torch.data.pipeline import (CropBatcher,
                                              RandomImageSampler,
                                              pinned_device_put)
    from dbsr_tpu_torch.training.checkpoint import save_checkpoint
    from dbsr_tpu_torch.training.trainer import LoaderSpec, Trainer

    cfg = burst_config(_settings())

    def batcher():
        return CropBatcher(RandomImageSampler(
            [ImageFolder(png_dir)], [1.0],
            samples_per_epoch=TRAIN_B * HOST_STEPS), TRAIN_B, cfg.pre_crop_sz,
            seed=MIXED_SEED)

    put = pinned_device_put(dev)
    first_card = put(batcher().next_batch())
    torch.cuda.synchronize()
    first_cpu = torch.from_numpy(batcher().next_batch())
    if first_card.device.type != "cuda" or not torch.equal(
            first_card.cpu(), first_cpu):
        raise AssertionError("the first host batch on the card differs from "
                             "the CPU's")
    log(f"  first host batch {list(first_cpu.shape)} {first_cpu.dtype}: on "
        f"the card bit-equal to the CPU's")
    base, _ = default_synthetic_trainer(dev, compute_dtype="bfloat16",
                                        fused_s2d_decoder=True,
                                        pwc_checkpoint=ALIGN_LITE)
    ws = os.path.join(workdir, "host_fed")
    trainer = Trainer(base.net, base.actor_fn, base.tx,
                      [LoaderSpec("train", batcher())],
                      make_crop_prepare_fn(cfg), ws,
                      net_name="dbsr_synthetic", print_interval=HOST_STEPS,
                      device=dev, device_put=put,
                      header_settings=base.header_settings)
    state = trainer.init_state()
    graft_alignment_params(trainer.net, ALIGN_LITE)
    save_checkpoint(ws, "dbsr_synthetic", 0, state,
                    settings=trainer.header_settings)
    with contextlib.redirect_stdout(io.StringIO()):
        trainer.train(1)
    res = _timed_epoch("host-fed default_synthetic bf16 (epoch 2)", trainer,
                       2, HOST_STEPS, LAUNCHES_PER_BF16_STEP)
    per_step = {k: v // HOST_STEPS for k, v in read_counts().items()}
    del trainer, base, state
    torch.cuda.empty_cache()
    return per_step, res


def smoke_tiny_phase(workdir):
    """Phase 16e: ``python -m dbsr_tpu_torch.run_training dbsr smoke_tiny``
    (its ``main``; the host-fed tiny config, float32, 2 epochs of 4 steps):
    exact launches, finite losses, both checkpoints written."""
    from dbsr_tpu_torch.run_training import main as run_training_cli
    from dbsr_tpu_torch.training.checkpoint import list_checkpoints

    ws = os.path.join(workdir, "smoke_tiny")
    os.environ["DBSR_TPU_WORKSPACE_DIR"] = ws
    reset_counts()
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        run_training_cli(["dbsr", "smoke_tiny"])
    torch.cuda.synchronize()
    text = buf.getvalue()
    for line in text.splitlines():
        log(f"  | {line}")
    counts = read_counts()
    check_counts("run_training dbsr smoke_tiny", counts, SMOKE_TINY_STEPS,
                 LAUNCHES_PER_SMOKE_TINY_STEP)
    losses = [float(v) for v in re.findall(
        r"Loss/total: (-?[\d.]+(?:e-?\d+)?|nan|inf)", text)]
    ckpts = [e for e, _ in list_checkpoints(
        os.path.join(ws, "dbsr", "smoke_tiny"), "smoke")]
    if ckpts != [1, 2] or "[train: 2, 4/4]" not in text or not losses \
            or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"smoke_tiny: checkpoints {ckpts}, losses "
                             f"{losses}")
    log(f"smoke_tiny: checkpoints of epochs {ckpts}, losses {losses}")
    return ({k: v // SMOKE_TINY_STEPS for k, v in counts.items()},
            dict(losses=losses))


def source_dir_phase(workdir, png_dir):
    """Phase 16f: ``generate_synthetic_burst_val --source_dir <the PNG
    folder> --num_bursts 3`` (its ``main``, on the card), one resample a
    burst, the set read back by the port's reader."""
    from dbsr_tpu_torch import generate_synthetic_burst_val as gen
    from dbsr_tpu_torch.data.datasets import SyntheticBurstVal

    out = os.path.join(workdir, "val_source_dir")
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        gen.main(["--source_dir", png_dir, "--num_bursts",
                  str(SOURCE_DIR_BURSTS), "--seed", "16", "--out_dir", out])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_counts()
    want = {k: SOURCE_DIR_BURSTS * int(k == "resample") for k in counts}
    if counts != want:
        raise AssertionError(f"--source_dir: launches {counts}, expected "
                             f"{want}")
    ds = SyntheticBurstVal(out)
    if len(ds) != SOURCE_DIR_BURSTS:
        raise AssertionError(f"--source_dir wrote {len(ds)} bursts")
    for i in range(len(ds)):
        burst, gt, meta = ds[i]
        if burst.shape != (N, HW, HW, 4) or gt.shape != (384, 384, 3) \
                or not (np.isfinite(burst).all() and np.isfinite(gt).all()):
            raise AssertionError(f"--source_dir burst {i}: {burst.shape}, "
                                 f"{gt.shape}")
    log(f"generate_synthetic_burst_val --source_dir: {SOURCE_DIR_BURSTS} "
        f"bursts in {secs:.2f} s, launches {counts}, read back")
    return counts, dict(seconds=secs, bursts=len(ds))


def prefetched_finetune_phase(dev, step_ms):
    """Phase 16g: phase 15c's bf16 ``default_realworld`` trainer through the
    prefetcher, resumed from 15c's checkpoint: an epoch of 5 steps to warm
    up, one timed (exact launches, ms per step, the BurstSR batcher's ms
    per batch on the worker, the wait on the queue), beside 15c's
    fixed-batch step (``step_ms``)."""
    from dbsr_tpu_torch.configs.dbsr import default_realworld

    with contextlib.redirect_stdout(io.StringIO()):
        trainer, _ = default_realworld.make_trainer(
            _settings(steps_per_epoch=RW_STEPS, print_interval=RW_STEPS), dev)
        trainer.train(2)
    res = _timed_epoch("default_realworld bf16 through the prefetcher "
                       "(epoch 3)", trainer, 3, RW_STEPS,
                       LAUNCHES_PER_BF16_RW_STEP, batch_size=RW_B)
    per_step = {k: v // RW_STEPS for k, v in read_counts().items()}
    log(f"default_realworld bf16: {res['ms_per_step']:.2f} ms per prefetched "
        f"step, {step_ms:.2f} ms per fixed-batch step (15c)")
    del trainer
    torch.cuda.empty_cache()
    return per_step, dict(res, fixed_batch_step_ms=step_ms)


def native_io_facts():
    """Whether this machine has what the port's native IO library builds
    with: ``g++``, zlib's and libjpeg's headers and libraries (nothing is
    built or decoded here; phase 18e builds it)."""
    import ctypes.util
    import shutil

    def found(header):
        return [p for p in (f"/usr/include/{header}",
                            f"/usr/local/include/{header}",
                            f"/usr/include/x86_64-linux-gnu/{header}")
                if os.path.exists(p)]

    heads, zheads = found("jpeglib.h"), found("zlib.h")
    facts = dict(gxx=shutil.which("g++"), jpeglib_h=heads,
                 libjpeg=ctypes.util.find_library("jpeg"), zlib_h=zheads,
                 libz=ctypes.util.find_library("z"))
    log(f"native IO build prerequisites on this machine: g++ "
        f"{facts['gxx'] or 'absent'}; jpeglib.h {heads or 'absent'}; "
        f"libjpeg {facts['libjpeg'] or 'absent'}; zlib.h "
        f"{zheads or 'absent'}; libz {facts['libz'] or 'absent'}")
    return facts


def data_phase(dev, workdir, finetune_step_ms):
    """Phase 16 a-c and e-g (d runs beside phase 3): the mixed corpus, the
    host-fed path, ``smoke_tiny``, ``--source_dir`` and the prefetched
    fine-tuning step, after phase 15 (16g resumes 15c's workspace).
    Returns the numbers and the launches of each path."""
    out, paths = {"native_io": native_io_facts()}, {}
    rw_ws = os.environ["DBSR_TPU_WORKSPACE_DIR"]
    log("phase 16a, the mixed corpus on the card against the CPU:")
    out["mixed_pool"] = mixed_pool_phase(dev)
    png_dir = _write_pngs(os.path.join(workdir, "pngs"))
    log("phase 16b, default_synthetic mix=mixed:")
    paths["mixed_step_bf16"], out["mixed_training"] = \
        mixed_training_phase(dev, workdir)
    log("phase 16c, the host-fed path:")
    paths["host_fed_step_bf16"], out["host_fed"] = host_fed_phase(
        dev, workdir, png_dir)
    log("phase 16e, smoke_tiny:")
    paths["smoke_tiny_step"], out["smoke_tiny"] = smoke_tiny_phase(workdir)
    log("phase 16f, --source_dir:")
    paths["val_source_dir"], out["source_dir"] = source_dir_phase(workdir,
                                                                  png_dir)
    log("phase 16g, the fine-tuning step through the prefetcher:")
    os.environ["DBSR_TPU_WORKSPACE_DIR"] = rw_ws
    paths["realworld_step_bf16_prefetched"], out["finetune_prefetched"] = \
        prefetched_finetune_phase(dev, finetune_step_ms)
    return out, paths


# ---------------------------------------------------------------------------
# phase 17: the serving daemon and run_serving; the trainer's service layer


DAEMON_BURSTS, DAEMON_CLIENTS, DAEMON_SEED = 64, 8, 17
DAEMON_LINGER_MS = 5.0
DAEMON_TOL = CARD_VS_CPU_TOL  # an HTTP response vs a direct Predictor call
HEALTHZ_KEYS = {"status", "input_shape", "compile_seconds", "flops_per_batch"}
CLI_TIMEOUT_S = 180  # run_serving's start (load, warm-up) and exit
SERVICE_STEPS, TRACE_STEPS = BF16_STEPS, 10  # steps an epoch (17c-d; 17e)
SERVICE_POOL = 128   # 17's pools, one round an epoch


def _http(port, path, body=None):
    """``(status, body bytes)`` of a GET (``body`` None) or a POST to the
    daemon on this machine."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _npy(arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def _from_npy(raw):
    return np.load(io.BytesIO(raw), allow_pickle=False)


# a client in a process of its own (numpy and the standard library only):
# DAEMON_CLIENTS threads post the bursts of an .npz, write the responses to
# an .npy and print the seconds from the first post to the last response;
# with nodelay, each connection sets TCP_NODELAY (no Nagle delay on the
# body's last segment)
CLIENT_CODE = r"""
import http.client, io, socket, sys, threading, time, urllib.request
import numpy as np
port, clients, inp, out, nodelay = int(sys.argv[1]), int(sys.argv[2]), \
    sys.argv[3], sys.argv[4], sys.argv[5] == "1"
with np.load(inp) as f:
    bursts = [f[f"arr_{i}"] for i in range(len(f.files))]
res = [None] * len(bursts)
def post(body):
    if not nodelay:
        req = urllib.request.Request(f"http://127.0.0.1:{port}/predict",
                                     data=body, method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.read()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.connect()
    conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    conn.request("POST", "/predict", body)
    r = conn.getresponse()
    assert r.status == 200, r.status
    raw = r.read()
    conn.close()
    return raw
def client(c):
    for i in range(c, len(bursts), clients):
        buf = io.BytesIO()
        np.save(buf, bursts[i])
        res[i] = np.load(io.BytesIO(post(buf.getvalue())))
threads = [threading.Thread(target=client, args=(c,)) for c in range(clients)]
t0 = time.perf_counter()
for t in threads:
    t.start()
for t in threads:
    t.join()
wall = time.perf_counter() - t0
np.save(out, np.stack(res))
print(wall)
"""


def _client_process(port, sent, workdir, nodelay=False):
    """``(seconds, responses)`` of ``sent`` posted by CLIENT_CODE's
    process."""
    inp = os.path.join(workdir, "daemon_in.npz")
    out = os.path.join(workdir, "daemon_out.npy")
    np.savez(inp, *sent)
    r = subprocess.run([sys.executable, "-c", CLIENT_CODE, str(port),
                        str(DAEMON_CLIENTS), inp, out, str(int(nodelay))],
                       capture_output=True, text=True, timeout=300,
                       check=True)
    return float(r.stdout.strip().splitlines()[-1]), np.load(out)


class _FailOnce:
    """The daemon's predictor, made to raise on its next call once."""

    def __init__(self, pred):
        self.pred, self.armed, self.failed_batch = pred, True, None

    def __getattr__(self, name):
        return getattr(self.pred, name)

    def __call__(self, burst):
        if self.armed:
            self.armed, self.failed_batch = False, len(burst)
            raise RuntimeError("injected device failure")
        return self.pred(burst)


def daemon_phase(dev, requests, workdir):
    """Phase 17a: ``make_server`` on the banked flagship at batch 8 in bf16
    (its default, the s2d conv kernel) on loopback: 64 bursts of a fixed
    seed (a quarter as uint16 at 2^14) from 8 client threads, each response
    against a direct ``Predictor`` call on the same burst (DAEMON_TOL; the
    bit-equal share reported), the launches exactly 14b's per device call;
    400, 404, and 503 for every request of a batch whose device call fails,
    the daemon serving on after it; ``/healthz``'s keys, ``/stats``'s counts,
    mean occupancy above 1; request ms (p50, p95), bursts/s through HTTP
    beside the direct forward's (14b's measurement, ``serve``). Then, to
    tell what sets the gap, the same 64 bursts from a client process of
    their own (CLIENT_CODE: the daemon's process then holds only its
    handler threads and the batcher) at the same linger and at 4x it."""
    import threading

    from dbsr_tpu_torch.serving import FLAGSHIP_CHECKPOINT, load_predictor
    from dbsr_tpu_torch.serving_daemon import make_server

    pred = load_predictor(FLAGSHIP_CHECKPOINT, batch_size=B, burst_size=N,
                          burst_hw=(HW, HW), device="cuda")
    direct = serve("phase 17a, the daemon's predictor called directly", pred,
                   requests, LAUNCHES_PER_S2D_FORWARD)
    direct_launches = direct.pop("launches")
    rng = np.random.RandomState(DAEMON_SEED)
    bursts = rng.rand(DAEMON_BURSTS, N, HW, HW, 4).astype(np.float32)
    u16 = np.zeros(DAEMON_BURSTS, bool)
    u16[::4] = True  # a quarter go as uint16 at 2^14
    sent = [np.rint(b * 2 ** 14).astype(np.uint16) if q else b
            for b, q in zip(bursts, u16)]
    seen = np.stack([s.astype(np.float32) / 2 ** 14 if q else s
                     for s, q in zip(sent, u16)])
    want = np.concatenate([pred(seen[i:i + B])
                           for i in range(0, DAEMON_BURSTS, B)])
    server = make_server(pred, port=0, linger_ms=DAEMON_LINGER_MS)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        outs, lat = [None] * DAEMON_BURSTS, [None] * DAEMON_BURSTS

        def client(c):
            for i in range(c, DAEMON_BURSTS, DAEMON_CLIENTS):
                t0 = time.perf_counter()
                code, raw = _http(port, "/predict", _npy(sent[i]))
                lat[i] = time.perf_counter() - t0
                outs[i] = (code, raw)

        torch.cuda.synchronize()
        reset_counts()
        calls0 = len(server.batcher.batch_occupancies)
        clients = [threading.Thread(target=client, args=(c,))
                   for c in range(DAEMON_CLIENTS)]
        t0 = time.perf_counter()
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=300)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = read_counts()
        occ = list(server.batcher.batch_occupancies)[calls0:]
        if any(t.is_alive() for t in clients):
            raise AssertionError("17a: a client did not finish")
        bad = [i for i, (code, _) in enumerate(outs) if code != 200]
        if bad:
            raise AssertionError(f"17a: requests {bad} got "
                                 f"{[outs[i][0] for i in bad]}")
        got = np.stack([_from_npy(raw) for _, raw in outs])
        if got.shape != (DAEMON_BURSTS, HW * 8, HW * 8, 3) \
                or not np.isfinite(got).all():
            raise AssertionError(f"17a: responses of shape {got.shape}")
        diff = np.abs(got - want).reshape(DAEMON_BURSTS, -1).max(1)
        bit_equal = float(np.mean([np.array_equal(a, b)
                                   for a, b in zip(got, want)]))
        per_call = {k: v // len(occ) for k, v in launches.items()}
        want_per_call = {k: LAUNCHES_PER_S2D_FORWARD.get(k, 0)
                         for k in launches}
        log(f"17a: {DAEMON_BURSTS} bursts from {DAEMON_CLIENTS} clients in "
            f"{wall:.3f} s ({DAEMON_BURSTS / wall:.2f} bursts/s through "
            f"HTTP); {len(occ)} device calls, occupancies {occ}; launches "
            f"{launches}; max |HTTP - direct| {diff.max():.3e} (limit "
            f"{DAEMON_TOL}), bit-equal {100 * bit_equal:.1f}% of responses")
        if diff.max() > DAEMON_TOL:
            raise AssertionError(f"17a: HTTP vs direct {diff.max()}")
        if any(launches[k] != want_per_call[k] * len(occ) for k in launches):
            raise AssertionError(f"17a: launches {launches} over {len(occ)} "
                                 f"device calls, expected {want_per_call} "
                                 "each (14b's per forward)")
        if sum(occ) != DAEMON_BURSTS or not np.mean(occ) > 1:
            raise AssertionError(f"17a: occupancies {occ}")

        # the client's faults, an unknown route, a failed device call
        codes = {"wrong_shape": _http(port, "/predict",
                                      _npy(bursts[0][:, :8]))[0],
                 "not_npy": _http(port, "/predict", b"not an npy")[0],
                 "unknown_get": _http(port, "/nowhere")[0],
                 "unknown_post": _http(port, "/other", _npy(sent[1]))[0]}
        failing = _FailOnce(pred)
        server.batcher.predictor = failing
        fail_codes = [None] * 4

        def fail_client(j):
            fail_codes[j] = _http(port, "/predict", _npy(sent[j + 1]))[0]

        fails = [threading.Thread(target=fail_client, args=(j,))
                 for j in range(4)]
        for t in fails:
            t.start()
        for t in fails:
            t.join(timeout=120)
        server.batcher.predictor = pred
        code, raw = _http(port, "/predict", _npy(sent[5]))
        after = np.abs(_from_npy(raw) - want[5]).max() if code == 200 \
            else None
        n503 = fail_codes.count(503)
        log(f"17a: wrong shape {codes['wrong_shape']}, not .npy "
            f"{codes['not_npy']}, unknown routes {codes['unknown_get']} / "
            f"{codes['unknown_post']}; a failed device call of "
            f"{failing.failed_batch} bursts: codes {fail_codes}; next request "
            f"{code} (max |diff| {after})")
        if codes != {"wrong_shape": 400, "not_npy": 400, "unknown_get": 404,
                     "unknown_post": 404} or n503 != failing.failed_batch \
                or fail_codes.count(200) != 4 - n503 or code != 200 \
                or after > DAEMON_TOL:
            raise AssertionError(f"17a: codes {codes}, {fail_codes} (failed "
                                 f"batch {failing.failed_batch}), then "
                                 f"{code}")
        code, raw = _http(port, "/healthz")
        health = json.loads(raw)
        code_s, raw_s = _http(port, "/stats")
        stats = json.loads(raw_s)
        # the gap's diagnosis: clients outside the daemon's process, at the
        # same linger, at 4x it, and with TCP_NODELAY on both ends
        apart = {}
        for name, linger, nodelay in (
                ("linger_5ms", DAEMON_LINGER_MS, False),
                ("linger_20ms", 4 * DAEMON_LINGER_MS, False),
                ("linger_5ms_nodelay", DAEMON_LINGER_MS, True)):
            srv = server if name == "linger_5ms" else make_server(
                pred, port=0, linger_ms=linger)
            # StreamRequestHandler's switch for TCP_NODELAY, on this
            # server's handler class alone
            srv.RequestHandlerClass.disable_nagle_algorithm = nodelay
            th = None
            if srv is not server:
                th = threading.Thread(target=srv.serve_forever, daemon=True)
                th.start()
            try:
                n0 = len(srv.batcher.batch_occupancies)
                secs, resp = _client_process(srv.server_address[1], sent,
                                             workdir, nodelay)
                o = list(srv.batcher.batch_occupancies)[n0:]
            finally:
                if th is not None:
                    srv.shutdown()
                    srv.server_close()
                    srv.batcher.close()
                    th.join(timeout=30)
            d = float(np.abs(resp - want).max())
            apart[name] = dict(bursts_per_s=DAEMON_BURSTS / secs,
                               occupancies=o, mean_occupancy=float(
                                   np.mean(o)), max_abs_vs_direct=d)
            log(f"17a, clients in a process of their own, linger {linger} "
                f"ms, TCP_NODELAY {nodelay}: {DAEMON_BURSTS / secs:.2f} "
                f"bursts/s, {len(o)} device calls, occupancies {o}, max "
                f"|diff| {d:.3e}")
            if d > DAEMON_TOL or sum(o) != DAEMON_BURSTS:
                raise AssertionError(f"17a, clients apart: {apart}")
        n_ok = DAEMON_BURSTS + fail_codes.count(200) + 1
        n_err = 2 + n503
        log(f"17a: /healthz {health}; /stats {stats}")
        if code != 200 or set(health) != HEALTHZ_KEYS \
                or health["input_shape"] != [B, N, HW, HW, 4] \
                or not health["compile_seconds"] > 0 \
                or not health["flops_per_batch"] > 0:
            raise AssertionError(f"17a: /healthz {code} {health}")
        if code_s != 200 or stats["requests"] != n_ok \
                or stats["errors"] != n_err \
                or not stats["mean_batch_occupancy"] > 1:
            raise AssertionError(f"17a: /stats {stats}, expected {n_ok} "
                                 f"requests and {n_err} errors")
    finally:
        server.shutdown()
        server.server_close()
        server.batcher.close()
        thread.join(timeout=30)
    lat_ms = sorted(1e3 * v for v in lat)
    res = dict(bursts_per_s_http=DAEMON_BURSTS / wall,
               bursts_per_s_direct=direct["bursts_per_s"],
               direct=direct, request_ms_p50=stats["latency_p50_ms"],
               request_ms_p95=stats["latency_p95_ms"],
               client_ms_p50=lat_ms[len(lat_ms) // 2],
               client_ms_p95=lat_ms[min(len(lat_ms) - 1,
                                        int(0.95 * len(lat_ms)))],
               device_calls=len(occ), occupancies=occ,
               mean_occupancy=float(np.mean(occ)),
               launches_per_device_call=per_call,
               max_abs_vs_direct=float(diff.max()),
               bit_equal_share=bit_equal, codes=codes,
               failed_batch=failing.failed_batch, fail_codes=fail_codes,
               healthz=health, stats=stats, clients_apart=apart,
               compile_seconds=pred.compile_seconds,
               flops_per_batch=pred.flops_per_batch)
    log(f"17a: request ms p50 {res['request_ms_p50']:.2f}, p95 "
        f"{res['request_ms_p95']:.2f} (the daemon's /stats; at the client "
        f"{res['client_ms_p50']:.2f}, {res['client_ms_p95']:.2f}); "
        f"{res['bursts_per_s_http']:.2f} bursts/s through HTTP against "
        f"{res['bursts_per_s_direct']:.2f} direct at batch {B}; "
        f"{len(occ)} device calls, {per_call} launches each; warm-up "
        f"{pred.compile_seconds:.3f} s, {pred.flops_per_batch / 1e9:.1f} "
        "GFLOP/batch (convs)")
    if direct_launches != {k: 3 * v for k, v in want_per_call.items()}:
        raise AssertionError(f"17a: direct launches {direct_launches}")
    del pred
    torch.cuda.empty_cache()
    return res, launches, want[:1], seen[:1]


def cli_serving_phase(burst, want):
    """Phase 17b: ``python -m dbsr_tpu_torch.run_serving --checkpoint
    <flagship> --port <free>`` as a subprocess: its two lines, one request
    (against 17a's direct prediction of the burst, DAEMON_TOL) and
    ``/healthz``, then SIGINT: it must exit with 0."""
    import queue
    import signal
    import socket
    import threading

    from dbsr_tpu_torch.serving import FLAGSHIP_CHECKPOINT

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "dbsr_tpu_torch.run_serving", "--checkpoint",
         FLAGSHIP_CHECKPOINT, "--port", str(port)], cwd=root, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines = queue.Queue()
    reader = threading.Thread(target=lambda: [lines.put(line) for line in
                                              proc.stdout], daemon=True)
    reader.start()
    text = []
    try:
        while not any(line.startswith("serving on") for line in text):
            try:
                text.append(lines.get(timeout=max(
                    1.0, CLI_TIMEOUT_S - (time.perf_counter() - t0))))
            except queue.Empty:
                raise AssertionError(f"17b: no 'serving on' line in "
                                     f"{CLI_TIMEOUT_S} s: {text}") from None
            log(f"  | {text[-1].rstrip()}")
            if proc.poll() is not None and lines.empty():
                raise AssertionError(f"17b: run_serving exited with "
                                     f"{proc.returncode}: {text}")
        start_s = time.perf_counter() - t0
        code, raw = _http(port, "/predict", _npy(burst))
        out = _from_npy(raw) if code == 200 else None
        hcode, hraw = _http(port, "/healthz")
        health = json.loads(hraw)
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    reader.join(timeout=10)
    while not lines.empty():
        log(f"  | {lines.get().rstrip()}")
    diff = float(np.abs(out - want).max()) if out is not None else None
    res = dict(start_s=start_s, returncode=rc, max_abs_vs_direct=diff,
               compile_seconds=health.get("compile_seconds"),
               flops_per_batch=health.get("flops_per_batch"),
               lines=[line.rstrip() for line in text])
    log(f"17b: run_serving served in {start_s:.1f} s (process start, load, "
        f"warm-up); request {code}, max |diff| vs 17a's direct {diff}; "
        f"/healthz compile_seconds {res['compile_seconds']}, "
        f"flops_per_batch {res['flops_per_batch']}; SIGINT -> exit {rc}")
    if code != 200 or out.shape != (HW * 8, HW * 8, 3) or diff > DAEMON_TOL \
            or hcode != 200 or set(health) != HEALTHZ_KEYS or rc != 0 \
            or not any(line.startswith("compiled") for line in text):
        raise AssertionError(f"17b: {res}")
    return res


def _service_trainer(dev, steps, **kwargs):
    """``default_synthetic``'s trainer (bf16, the banked AlignLite frozen,
    15b's pool and batch) in the workspace of ``DBSR_TPU_WORKSPACE_DIR``."""
    from dbsr_tpu_torch.configs.dbsr.default_synthetic import make_trainer

    with contextlib.redirect_stdout(io.StringIO()):
        trainer, _ = make_trainer(_settings(
            steps_per_epoch=steps, pool_size=SERVICE_POOL,
            print_interval=steps, pwc_checkpoint=ALIGN_LITE, **kwargs), dev)
    return trainer


def _leaf_bytes(tree, prefix=""):
    """``{path: bytes}`` of the arrays of a flax tree."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaf_bytes(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v).tobytes()
    return out


def _timed_steps(trainer):
    """Record CUDA events around each of ``trainer``'s train steps:
    ``{epoch: [(start, end), ...]}``."""
    events = defaultdict(list)
    step = trainer.train_step

    def timed(state, g, data):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = step(state, g, data)
        end.record()
        events[trainer.epoch].append((start, end))
        return out

    trainer.train_step = timed
    return events


def _step_ms(events):
    """Median ms of an epoch's steps after its first, which waits for the
    pool's rendering (once an epoch)."""
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events[1:])


def resume_phase(dev, workdir):
    """Phase 17c: ``run_training dbsr default_synthetic`` for one epoch of
    5 steps (bf16, AlignLite frozen, 15b's pool and batch), a params-only
    artifact of its epoch-1 checkpoint written by ``save_params_artifact``
    into a fresh workspace, and the trainer resumed from it there: the
    parameters bit-equal to the artifact's, Adam's moments zero and its
    count 0, ``step == 5`` at the resume, the learning rate the schedule's
    at ``step``; the second epoch timed (exact launches per step), ``step
    == 10`` at its end, ``..._ep0002.ckpt`` written."""
    from dbsr_tpu_torch.training.checkpoint import (read_checkpoint,
                                                    resolve_checkpoint,
                                                    save_params_artifact)
    from dbsr_tpu_torch.utils.convert import params_to_flax

    os.environ["DBSR_TPU_WORKSPACE_DIR"] = os.path.join(workdir, "svc_full")
    entry_phase("dbsr", "default_synthetic",
                dict(steps_per_epoch=SERVICE_STEPS, pool_size=SERVICE_POOL,
                     print_interval=SERVICE_STEPS, pwc_checkpoint=ALIGN_LITE),
                (1,), LAUNCHES_PER_BF16_STEP, "dbsr_synthetic",
                pool_round_launches(SERVICE_POOL))
    src = resolve_checkpoint(os.path.join(workdir, "svc_full", "dbsr",
                                          "default_synthetic"),
                             "dbsr_synthetic", 1)
    header, tree = read_checkpoint(src)
    ws = os.path.join(workdir, "svc_resume")
    art = save_params_artifact(
        os.path.join(ws, "dbsr", "default_synthetic",
                     "dbsr_synthetic_ep0001.ckpt"), header,
        {"params": tree["params"]})
    os.environ["DBSR_TPU_WORKSPACE_DIR"] = ws
    trainer = _service_trainer(dev, SERVICE_STEPS)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        state = trainer._load_latest(trainer.init_state())
    log(f"  | {buf.getvalue().strip()}")
    got = _leaf_bytes(params_to_flax(state.net.state_dict()))
    want = _leaf_bytes(read_checkpoint(art)[1]["params"]["params"])
    opt = state.opt_state()
    zero = all(not v.any() for d in (opt["mu"], opt["nu"])
               for v in d.values())
    lr = trainer.tx.schedule(state.step)
    log(f"17c: resumed at epoch {trainer.epoch}, step {state.step}, Adam "
        f"count {opt['count']}, moments zero {zero}, parameters bit-equal "
        f"{got == want} ({len(want)} arrays), lr {lr}")
    if not ("resumed PARAMS-ONLY" in buf.getvalue() and trainer.epoch == 1
            and state.step == SERVICE_STEPS and opt["count"] == 0 and zero
            and not state.optimizer.state and got == want):
        raise AssertionError("17c: the params-only resume")
    events = _timed_steps(trainer)
    torch.cuda.synchronize()
    reset_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        state = trainer.train(2)
    torch.cuda.synchronize()
    counts = read_counts()
    renders = pool_round_launches(SERVICE_POOL)
    check_counts("17c, the resumed epoch (epoch 2)", counts, SERVICE_STEPS,
                 LAUNCHES_PER_BF16_STEP, renders)
    per_step = per_step_of(counts, SERVICE_STEPS, renders)
    last_lr = state.optimizer.param_groups[0]["lr"]
    ep2 = resolve_checkpoint(os.path.join(ws, "dbsr", "default_synthetic"),
                             "dbsr_synthetic")
    res = dict(_feed(trainer, SERVICE_STEPS), resumed_step=SERVICE_STEPS,
               resumed_lr=lr, last_lr=last_lr, end_step=state.step)
    res["step_ms"] = _step_ms(events[2])
    log(f"17c: epoch 2 {res['ms_per_step']:.2f} ms per step through the "
        f"prefetcher, {res['wait_ms_per_step']:.2f} of it waiting on the "
        f"queue (the pool's rendering, once an epoch, over {SERVICE_STEPS} "
        f"steps); a step {res['step_ms']:.2f} ms (CUDA events, steps 2-"
        f"{SERVICE_STEPS}); step {state.step} at its end, the last update's "
        f"lr "
        f"{last_lr} (schedule at step {state.step - 1}: "
        f"{trainer.tx.schedule(state.step - 1)}); latest {ep2}")
    if state.step != 2 * SERVICE_STEPS or not ep2.endswith("_ep0002.ckpt") \
            or last_lr != trainer.tx.schedule(state.step - 1):
        raise AssertionError(f"17c: {res}, latest {ep2}")
    del trainer, state
    return res, per_step


def async_phase(dev, workdir):
    """Phase 17d: the 17c trainer with the asynchronous writer for two
    epochs in a fresh workspace; each save also written synchronously to
    another directory at the same moment; epoch 1's write held until epoch
    2 has stepped (updating the parameters and Adam's moments in place);
    each async file byte-equal to its synchronous copy; the ms the loop
    paid at each save, synchronously and through the writer, and the
    snapshot's bytes and ms."""
    import threading

    from dbsr_tpu_torch.training import checkpoint as ckpt

    ws = os.path.join(workdir, "svc_async")
    os.environ["DBSR_TPU_WORKSPACE_DIR"] = ws
    trainer = _service_trainer(dev, SERVICE_STEPS)
    trainer._ckpt_writer = ckpt.AsyncCheckpointWriter()
    copy_dir = os.path.join(workdir, "svc_sync_copy")
    gate, saves = threading.Event(), []
    submit, step, save = (trainer._ckpt_writer.submit, trainer.train_step,
                          trainer._save)

    def held_submit(fn):
        def late():
            if not gate.wait(300):
                raise TimeoutError("epoch 2 never stepped")
            fn()
        submit(late)

    def train_step(state, g, data):
        out = step(state, g, data)
        if trainer.epoch == 2:
            gate.set()
        return out

    def timed_save(state):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.save_checkpoint(copy_dir, trainer.net_name, trainer.epoch, state,
                             stats={n: s.averages()
                                    for n, s in trainer.stats.items()},
                             settings=trainer.header_settings)
        t1 = time.perf_counter()
        save(state)
        saves.append(dict(sync_ms=(t1 - t0) * 1e3,
                          async_ms=(time.perf_counter() - t1) * 1e3))

    trainer._ckpt_writer.submit, trainer.train_step = held_submit, train_step
    trainer._save = timed_save
    events = _timed_steps(trainer)
    torch.cuda.synchronize()
    reset_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        state = trainer.train(2)
    torch.cuda.synchronize()
    counts = read_counts()
    renders = 2 * pool_round_launches(SERVICE_POOL)
    check_counts("17d, two epochs with the async writer", counts,
                 2 * SERVICE_STEPS, LAUNCHES_PER_BF16_STEP, renders)
    per_step = per_step_of(counts, 2 * SERVICE_STEPS, renders)
    equal = {}
    for e in (1, 2):
        name = f"dbsr_synthetic_ep{e:04d}.ckpt"
        with open(os.path.join(ws, "dbsr", "default_synthetic", name),
                  "rb") as f_async, open(os.path.join(copy_dir, name),
                                         "rb") as f_sync:
            a, s = f_async.read(), f_sync.read()
        equal[e] = a == s
        if e == 1:
            first = a
    differ = first != a
    # the snapshot alone: what the loop pays before handing a save over
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        contents = ckpt.snapshot_train_state(state)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    nbytes = sum(t.numel() * t.element_size() for k in ("params", "mu", "nu")
                 for t in contents[k].values())
    del contents
    res = dict(_feed(trainer, SERVICE_STEPS), saves=saves,
               async_equals_sync=equal, epochs_differ=differ,
               snapshot_ms=statistics.median(times), snapshot_bytes=nbytes,
               file_bytes=len(a), step=state.step)
    res["step_ms_by_epoch"] = {e: _step_ms(events[e]) for e in (1, 2)}
    log(f"17d: saves (ms the epoch loop paid: synchronous copy, then "
        f"through the writer): {saves}; snapshot {res['snapshot_ms']:.2f} ms "
        f"for {nbytes / 2 ** 20:.1f} MiB of device clones (median of 3); "
        f"checkpoint {len(a) / 2 ** 20:.1f} MiB; async == sync byte for "
        f"byte {equal}, epochs 1 and 2 differ {differ}; a step (CUDA "
        f"events, steps 2-{SERVICE_STEPS}) {res['step_ms_by_epoch'][1]:.2f} "
        f"ms in epoch 1, {res['step_ms_by_epoch'][2]:.2f} in epoch 2 with "
        f"epoch 1's write beside it; epoch 2 {res['ms_per_step']:.2f} ms per "
        f"step through the prefetcher")
    if not (all(equal.values()) and differ and state.step
            == 2 * SERVICE_STEPS):
        raise AssertionError(f"17d: {res}")
    del trainer, state
    torch.cuda.empty_cache()
    return res, per_step


def trace_phase(dev, workdir):
    """Phase 17e: with ``DBSR_TPU_TRACE_DIR`` set, one more epoch (the
    third, 10 steps) of the 17c workspace: ``maybe_trace``'s steps 5-9
    leave a Chrome trace that names the port's kernels; whether
    ``tensorboard`` imports here, and what ``TensorboardWriter`` wrote."""
    trace_dir = os.path.join(workdir, "traces")
    os.environ["DBSR_TPU_WORKSPACE_DIR"] = os.path.join(workdir, "svc_resume")
    trainer = _service_trainer(dev, TRACE_STEPS)
    os.environ["DBSR_TPU_TRACE_DIR"] = trace_dir
    try:
        reset_counts()
        with contextlib.redirect_stdout(io.StringIO()):
            trainer.train(3)
        torch.cuda.synchronize()
    finally:
        os.environ.pop("DBSR_TPU_TRACE_DIR")
    check_counts("17e, a traced epoch", read_counts(), TRACE_STEPS,
                 LAUNCHES_PER_BF16_STEP, pool_round_launches(SERVICE_POOL))
    files = sorted(os.listdir(trace_dir))
    if len(files) != 1 or not files[0].startswith("trace_steps5-9_"):
        raise AssertionError(f"17e: trace files {files}")
    path = os.path.join(trace_dir, files[0])
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    found = {k: sum(bool(re.search(p, n)) for n in names for p in pats)
             for k, pats in KERNEL_NAMES.items()}
    wanted = [k for k, v in LAUNCHES_PER_BF16_STEP.items() if v]
    tb = trainer.tb
    tb_files = sorted(os.path.relpath(os.path.join(d, f), tb.directory)
                      for d, _, fs in os.walk(tb.directory) for f in fs) \
        if tb and os.path.isdir(tb.directory) else []
    res = dict(trace_mib=os.path.getsize(path) / 2 ** 20,
               kernel_events=len(names), port_kernels_in_trace=found,
               tensorboard_imports=bool(tb and tb.available),
               tensorboard_files=tb_files)
    log(f"17e: trace {files[0]} ({res['trace_mib']:.1f} MiB, "
        f"{len(names)} kernel events); the port's kernels in it: {found}; "
        f"tensorboard imports here: {res['tensorboard_imports']}; "
        f"TensorboardWriter wrote {tb_files or 'nothing (a no-op)'}")
    if any(found[k] < 5 * LAUNCHES_PER_BF16_STEP[k] for k in wanted):
        raise AssertionError(f"17e: kernels in the trace {found}, expected "
                             f"5 steps of {LAUNCHES_PER_BF16_STEP}")
    del trainer
    torch.cuda.empty_cache()
    return res


def service_phase(dev, workdir, requests):
    """Phase 17 a-e. Returns the numbers and the launches of each path."""
    out, paths = {}, {}
    log("phase 17a, the serving daemon:")
    out["daemon"], paths["serving_daemon_bf16"], want, burst = daemon_phase(
        dev, requests, workdir)
    log("phase 17b, run_serving:")
    out["cli"] = cli_serving_phase(burst[0], want[0])
    log("phase 17c, params-only resume:")
    out["resume"], paths["resume_params_only_step_bf16"] = resume_phase(
        dev, workdir)
    torch.cuda.empty_cache()
    log("phase 17d, the async checkpoint writer:")
    out["async"], paths["async_ckpt_step_bf16"] = async_phase(dev, workdir)
    log("phase 17e, step tracing and TensorBoard:")
    out["trace"] = trace_phase(dev, workdir)
    return out, paths


# ---------------------------------------------------------------------------
# phase 18: data parallelism, multi-device serving, frame sharding, the PNG
# loaders

DP_RANKS = 2          # gloo ranks on cuda:0: NCCL refuses two ranks on a card
DP_STEPS = 5          # bf16 steps of 18a
DP_LOSS_RTOL = LOSS_RTOL              # float32: 2 ranks vs 1 process, 1e-5
FS_B = 2              # bursts of the frame-sharded forward (18d)
FS_TOL = CARD_VS_CPU_TOL              # frame-sharded vs dense forward, 1e-3
PNG_SHAPES = ((N, HW, HW, 4), (N, 256, 256, 4))  # 18e's png16 bursts
PNG_REPS = 5


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dp_trainer(dev, compute_dtype):
    """``default_synthetic``'s trainer at full width with its s2d decoder,
    the banked AlignLite grafted and frozen, a pool of one node batch
    (B=16), in ``compute_dtype``."""
    from dbsr_tpu_torch.configs.dbsr.default_synthetic import (
        graft_alignment_params, make_trainer)

    with contextlib.redirect_stdout(io.StringIO()):
        trainer, flow = make_trainer(_settings(
            steps_per_epoch=DP_STEPS, pool_size=TRAIN_B, batch_size=TRAIN_B,
            print_interval=DP_STEPS, pwc_checkpoint=ALIGN_LITE,
            compute_dtype=compute_dtype), dev)
    state = trainer.init_state()
    graft_alignment_params(trainer.net, flow)
    return trainer, state


def _dp_steps(trainer, state, n):
    """``n`` train steps on the trainer's first pool batch and cycle stream:
    the losses (the ranks' mean, as the trainer reduces its stats) and the
    CUDA events of each step."""
    from dbsr_tpu_torch.parallel import multihost

    g = trainer.cycle_generator(trainer.loaders[0])
    pool = trainer.loaders[0].batcher.next_batch()
    losses, events = [], []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        stats = trainer.train_step(state, g, pool)
        end.record()
        loss = stats["Loss/total"].float().reshape(1).clone()
        multihost.all_reduce_mean_([loss])
        losses.append(loss.item())
        events.append((start, end))
    torch.cuda.synchronize()
    return losses, [s.elapsed_time(e) for s, e in events]


def _dp_rank(rank, port, workdir, world, backend):
    """One of 18a's and 18d's ``world`` ranks (spawned; over gloo all on
    ``cuda:0``, over NCCL one a card): a float32 step and five bf16 steps
    of ``default_synthetic`` at the node's B=16 (16 / ``world`` rows here),
    then the flagship's frame-sharded forward; what it saw goes to
    ``workdir``."""
    import torch.distributed as dist
    from dbsr_tpu_torch.parallel import multihost
    from dbsr_tpu_torch.parallel.frame_sharding import \
        dbsr_apply_frame_sharded
    from dbsr_tpu_torch.serving import FLAGSHIP_CHECKPOINT, float32_math
    from dbsr_tpu_torch.training.checkpoint import load_network

    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    multihost.maybe_initialize_distributed(
        init_method=f"tcp://127.0.0.1:{port}", world_size=world,
        rank=rank, backend=backend, local_rank=dev.index, device_type="cuda",
        timeout_s=300)
    out = {"backend": dist.get_backend(),
           "slice": multihost.process_local_batch_slice(TRAIN_B)}
    trainer, state = _dp_trainer(dev, "float32")
    out["f32_loss"], _ = _dp_steps(trainer, state, 1)
    if rank == 0:
        torch.save({k: p.grad.cpu() for k, p in state.trainable().items()},
                   os.path.join(workdir, "dp_f32_grads.pt"))
    del trainer, state
    torch.cuda.empty_cache()

    trainer, state = _dp_trainer(dev, "bfloat16")
    reset_counts()
    out["bf16_losses"], out["bf16_step_ms"] = _dp_steps(trainer, state,
                                                        DP_STEPS)
    out["counts"] = read_counts()
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.save({k: v.cpu() for k, v in trainer.net.state_dict().items()},
               os.path.join(workdir, f"dp_bf16_params{rank}.pt"))
    del trainer, state
    torch.cuda.empty_cache()

    net, _ = load_network(FLAGSHIP_CHECKPOINT, device=dev, dtype=None)
    burst = torch.from_numpy(np.random.RandomState(18).rand(
        FS_B, N, HW, HW, 4).astype(np.float32)).to(dev)
    with float32_math():
        reset_counts()
        pred = dbsr_apply_frame_sharded(net, burst)
        torch.cuda.synchronize()
        out["fs_counts"] = read_counts()
        out["fs_ms"] = cuda_ms(lambda: dbsr_apply_frame_sharded(net, burst),
                               1, 5)
    if rank == 0:
        torch.save(pred.cpu(), os.path.join(workdir, "fs_pred.pt"))
    torch.save(out, os.path.join(workdir, f"dp_rank{rank}.pt"))
    dist.destroy_process_group()


def _grad_gap(got, want):
    """``||got - want|| / ||want||`` over all the gradients, and the worst
    tensor's own."""
    num = sum(float((got[k].double() - want[k].double()).pow(2).sum())
              for k in want)
    den = sum(float(want[k].double().pow(2).sum()) for k in want)
    worst = max(want, key=lambda k: float(
        (got[k].double() - want[k].double()).norm()
        / (want[k].double().norm() + 1e-30)))
    rel = float((got[worst].double() - want[worst].double()).norm()
                / (want[worst].double().norm() + 1e-30))
    return math.sqrt(num / den), worst, rel


def dp_phase(dev, workdir, world=DP_RANKS, backend="gloo"):
    """18a and 18d: two gloo ranks on ``cuda:0`` (or ``world`` NCCL ranks,
    one a card), spawned, against the same work in this process. 18a: one float32 ``default_synthetic`` step at
    B=16 (the loss within 1e-5 relative, the reduced gradients within 1e-3
    of their norm), five bf16 steps (the losses within 2e-2, both ranks'
    parameters bit-equal, each rank's launches 15b's per step), the ms of a
    step on each rank (two processes sharing one card: not a speed claim).
    18d: the flagship's forward with its 14 frames over the 2 ranks,
    float32, against the dense forward (1e-3)."""
    from dbsr_tpu_torch.serving import FLAGSHIP_CHECKPOINT, float32_math
    from dbsr_tpu_torch.training.checkpoint import load_network

    root = os.path.join(workdir, "dp")
    os.makedirs(root, exist_ok=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    torch.multiprocessing.spawn(_dp_rank, args=(_free_port(), root, world,
                                                backend),
                                nprocs=world, join=True)
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(root, f"dp_rank{r}.pt"))
             for r in range(world)]
    shared = "two processes sharing one card over gloo" \
        if backend == "gloo" else "one card a rank over NCCL"
    log(f"18a: {world} ranks ({ranks[0]['backend']}, slices "
        f"{[r['slice'] for r in ranks]}) ran in {spawn_s:.1f} s")

    out = {"spawn_s": spawn_s, "backend": ranks[0]["backend"]}
    trainer, state = _dp_trainer(dev, "float32")
    (loss1,), _ = _dp_steps(trainer, state, 1)
    grads1 = {k: p.grad.cpu() for k, p in state.trainable().items()}
    del trainer, state
    torch.cuda.empty_cache()
    grads2 = torch.load(os.path.join(root, "dp_f32_grads.pt"))
    loss2 = ranks[0]["f32_loss"][0]
    gap, worst, worst_rel = _grad_gap(grads2, grads1)
    log(f"18a float32 step, B={TRAIN_B}: loss {loss2:.8f} on {world} "
        f"ranks vs {loss1:.8f} in one process; gradients {gap:.3e} of their "
        f"norm apart (worst tensor {worst}: {worst_rel:.3e})")
    if abs(loss2 - loss1) > DP_LOSS_RTOL * abs(loss1) or gap > GRAD_TOL \
            or any(r["f32_loss"] != ranks[0]["f32_loss"] for r in ranks):
        raise AssertionError("18a: the data-parallel float32 step departs")
    out["f32"] = dict(loss_ranks=loss2, loss_one=loss1, grad_rel=gap,
                      worst=worst, worst_rel=worst_rel)

    trainer, state = _dp_trainer(dev, "bfloat16")
    losses1, ms1 = _dp_steps(trainer, state, DP_STEPS)
    del trainer, state
    torch.cuda.empty_cache()
    p0, *others = (torch.load(os.path.join(root, f"dp_bf16_params{r}.pt"))
                   for r in range(world))
    unequal = [k for k in p0 if any(not torch.equal(p0[k], p[k])
                                    for p in others)]
    losses2 = ranks[0]["bf16_losses"]
    log(f"18a bf16, {DP_STEPS} steps: losses {losses2} on {world} ranks "
        f"vs {losses1} in one process; the ranks' parameters bit-equal: "
        f"{not unequal} ({len(p0)} tensors)")
    if unequal or any(abs(a - b) > BF16_STEP_LOSS_RTOL * abs(b)
                      for a, b in zip(losses2, losses1)):
        raise AssertionError(f"18a bf16: losses {losses2} vs {losses1}; "
                             f"unequal tensors {unequal[:5]}")
    # each rank renders its pool of one node batch in the counted window
    renders = pool_round_launches(TRAIN_B)
    for r, res in enumerate(ranks):
        check_counts(f"18a rank {r}", res["counts"], DP_STEPS,
                     LAUNCHES_PER_BF16_STEP, renders)
    step_ms = [statistics.median(r["bf16_step_ms"][1:]) for r in ranks]
    one_ms = statistics.median(ms1[1:])
    log(f"18a bf16 step, ms a step a rank (CUDA events, steps 2-{DP_STEPS}, "
        f"{shared}: not a speed claim): "
        f"{step_ms}; one process at B={TRAIN_B}: {one_ms:.2f}")
    out["bf16"] = dict(losses_ranks=losses2, losses_one=losses1,
                       step_ms_by_rank=step_ms, step_ms_one=one_ms,
                       peak_gib_by_rank=[r["peak_gib"] for r in ranks],
                       params_bit_equal=True)

    net, _ = load_network(FLAGSHIP_CHECKPOINT, device=dev, dtype=None)
    burst = torch.from_numpy(np.random.RandomState(18).rand(
        FS_B, N, HW, HW, 4).astype(np.float32)).to(dev)
    with float32_math(), torch.no_grad():
        dense = net(burst)[0]
        dense_ms = cuda_ms(lambda: net(burst), 1, 5)
    sharded = torch.load(os.path.join(root, "fs_pred.pt"))
    err = float((sharded - dense.cpu()).abs().max())
    log(f"18d frame-sharded forward, {N} frames over {world} ranks, "
        f"B={FS_B}, float32: max |sharded - dense| {err:.3e}; "
        f"{[r['fs_ms'] for r in ranks]} ms a forward a rank ({shared}, "
        f"three all-reduces) vs {dense_ms:.2f} dense; "
        f"launches a rank {ranks[0]['fs_counts']}")
    if not err <= FS_TOL or sharded.shape != dense.shape:
        raise AssertionError(f"18d: frame-sharded vs dense {err}")
    out["frame_sharded"] = dict(max_abs=err, ms_by_rank=[
        r["fs_ms"] for r in ranks], dense_ms=dense_ms)
    del net
    torch.cuda.empty_cache()
    paths = {"dp_step_bf16_rank": per_step_of(ranks[0]["counts"], DP_STEPS,
                                              renders),
             "frame_sharded_forward_rank": ranks[0]["fs_counts"]}
    return out, paths


def nccl_cli_phase(workdir, nproc=1):
    """18b: ``DBSR_TPU_DIST=1 python -m torch.distributed.run --standalone
    --nproc_per_node=1 -m dbsr_tpu_torch.run_training dbsr smoke_tiny``
    (with ``nproc`` ranks, ``--batch_size 2*nproc``): exit 0, the group on
    ``nccl``, rank 0's checkpoints written."""
    from dbsr_tpu_torch.training.checkpoint import list_checkpoints

    ws = os.path.join(workdir, "nccl_cli")
    env = dict(os.environ, DBSR_TPU_DIST="1", DBSR_TPU_WORKSPACE_DIR=ws)
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc_per_node={nproc}", "-m", "dbsr_tpu_torch.run_training",
         "dbsr", "smoke_tiny", "--batch_size", str(2 * nproc)], env=env,
        capture_output=True, text=True,
        timeout=CLI_TIMEOUT_S)
    wall = time.perf_counter() - t0
    for line in res.stdout.splitlines():
        log(f"  | {line}")
    ckpts = [e for e, _ in list_checkpoints(
        os.path.join(ws, "dbsr", "smoke_tiny"), "smoke")]
    log(f"18b: rc {res.returncode} in {wall:.1f} s; checkpoints {ckpts}")
    if res.returncode != 0 or f"process group: backend nccl, rank 0 of " \
            f"{nproc}" not in res.stdout or ckpts != [1, 2]:
        raise AssertionError(f"18b: rc {res.returncode}, checkpoints "
                             f"{ckpts}: {res.stderr[-2000:]}")
    return dict(rc=res.returncode, wall_s=wall, checkpoints=ckpts)


def multi_device_serving_phase(requests):
    """18c: ``load_predictor(flagship, devices=["cuda:0", "cuda:0"])`` in
    bf16 at batch 8 (two replicas of 4 bursts each) against the one-device
    predictor (relative L2 within bf16's 2e-2); each call twice 14b's
    launches per forward; bursts/s of both."""
    from dbsr_tpu_torch.serving import FLAGSHIP_CHECKPOINT, load_predictor

    kw = dict(batch_size=B, burst_size=N, burst_hw=(HW, HW))
    one = load_predictor(FLAGSHIP_CHECKPOINT, device="cuda", **kw)
    two = load_predictor(FLAGSHIP_CHECKPOINT, devices=["cuda:0", "cuda:0"],
                         **kw)
    want = one(requests[0])
    reset_counts()
    got = two(requests[0])
    torch.cuda.synchronize()
    counts = read_counts()
    rel = _rel_l2(torch.from_numpy(got), torch.from_numpy(want))
    expect = {k: 2 * LAUNCHES_PER_S2D_FORWARD.get(k, 0) for k in counts}
    times = {}
    for name, pred in (("one", one), ("two", two)):
        pred(requests[0])
        t = []
        for _ in range(5):
            t0 = time.perf_counter()
            pred(requests[0])
            t.append(time.perf_counter() - t0)
        times[name] = B / statistics.median(t)
    log(f"18c: 2 replicas on cuda:0, bf16, batch {B}: relative L2 {rel:.3e} "
        f"against one device; launches {counts}; bursts/s {times['two']:.2f} "
        f"(one device {times['one']:.2f})")
    if rel > BF16_REL_L2 or counts != expect or got.shape != want.shape:
        raise AssertionError(f"18c: rel L2 {rel}, launches {counts} vs "
                             f"{expect}")
    del one, two
    torch.cuda.empty_cache()
    return dict(rel_l2=rel, bursts_per_s=times["two"],
                bursts_per_s_one=times["one"]), counts


def png_phase(workdir):
    """18e: the native IO library built on this machine (or why not), the
    path ``read_png`` takes; ``load_burst`` of 14 png16 frames (the val
    set's [48, 48, 4] and [256, 256, 4], uint16) bit-equal to png16, ms a
    burst by each path; BurstSR's reader (phase 13's tree) ms a burst
    through ``read_png`` and through png16."""
    from dbsr_tpu_torch.data.burstsr import get_burstsr_val_set
    from dbsr_tpu_torch.utils import native_io, png16

    facts = dict(native=native_io.native_available(),
                 jpeg=native_io.jpeg_available(),
                 png_path=native_io.png_path(), error=native_io._error,
                 jpeg_error=(native_io._jpeg_error or "")[:300] or None)
    log(f"18e: native IO library {'built' if facts['native'] else 'absent'}"
        f" (JPEG half {'built' if facts['jpeg'] else 'absent'}); read_png "
        f"takes {facts['png_path']}; {facts['error'] or ''}"
        f"{facts['jpeg_error'] or ''}")
    out = dict(facts=facts, bursts={})
    rng = np.random.RandomState(18)
    for shape in PNG_SHAPES:
        d = os.path.join(workdir, "png18", f"{shape[1]}")
        os.makedirs(d, exist_ok=True)
        frames = rng.randint(0, 2 ** 14, shape).astype(np.uint16)
        paths = [os.path.join(d, f"im_raw_{i:02d}.png") for i in range(N)]
        for p, f in zip(paths, frames):
            png16.write_png(p, f)
        got = native_io.load_burst(paths)
        py = np.stack([png16.read_png(p) for p in paths])
        if not (np.array_equal(got, frames) and np.array_equal(py, frames)):
            raise AssertionError(f"18e: load_burst {shape} not bit-equal")

        def ms(fn):
            t = []
            for _ in range(PNG_REPS):
                t0 = time.perf_counter()
                fn()
                t.append((time.perf_counter() - t0) * 1e3)
            return statistics.median(t)

        row = dict(load_burst_ms=ms(lambda: native_io.load_burst(paths)),
                   png16_ms=ms(lambda: [png16.read_png(p) for p in paths]))
        log(f"18e: {N} png16 frames of {list(shape[1:])}: load_burst "
            f"({facts['png_path']}) {row['load_burst_ms']:.2f} ms a burst, "
            f"png16 {row['png16_ms']:.2f} ms")
        out["bursts"][str(list(shape[1:]))] = row
    val = get_burstsr_val_set(os.environ["DBSR_TPU_BURSTSR_DIR"])

    def reader_ms():
        t = []
        for i in range(len(val)):
            t0 = time.perf_counter()
            val[i]
            t.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(t)

    out["burstsr_reader_ms"] = reader_ms()
    saved = native_io._lib, native_io._error
    native_io._lib, native_io._error = None, "forced png16 (18e)"
    try:
        out["burstsr_reader_png16_ms"] = reader_ms()
    finally:
        native_io._lib, native_io._error = saved
    log(f"18e: BurstSR's reader, {len(val)} val bursts of phase 13's tree: "
        f"{out['burstsr_reader_ms']:.2f} ms a burst through read_png "
        f"({facts['png_path']}), {out['burstsr_reader_png16_ms']:.2f} "
        f"through png16")
    return out


def parallel_phase(dev, workdir, requests):
    """Phase 18: 18a and 18d (``dp_phase``), 18b, 18c, 18e."""
    t0 = time.perf_counter()
    out, paths = dp_phase(dev, workdir)
    out["nccl_cli"] = nccl_cli_phase(workdir)
    out["serving_2_replicas"], paths["serving_2_replicas_bf16"] = \
        multi_device_serving_phase(requests)
    out["png"] = png_phase(workdir)
    out["phase_s"] = time.perf_counter() - t0
    return out, paths


# ---------------------------------------------------------------------------
# phase 19: LPIPS, visualize, the converter, load_trained_network, ConvFlow


def lpips_npz(workdir):
    """Seeded random LPIPS weights in the ``.npz`` layout (the recipe of
    ``tests/test_torch_port_lpips.py``; no published weights are in the
    repository)."""
    from dbsr_tpu_torch.models.lpips import _ALEX_CONVS

    rng = np.random.RandomState(0)
    w, in_ch = {}, 3
    for i, (out_ch, k, _, _) in enumerate(_ALEX_CONVS):
        w[f"conv{i}_w"] = (0.1 * rng.randn(k, k, in_ch, out_ch)).astype(
            np.float32)
        w[f"conv{i}_b"] = (0.01 * rng.randn(out_ch)).astype(np.float32)
        in_ch = out_ch
    for i, (out_ch, _, _, _) in enumerate(_ALEX_CONVS):
        w[f"lin{i}_w"] = np.abs(rng.randn(1, 1, out_ch, 1)).astype(np.float32)
    path = os.path.join(workdir, "lpips_alex.npz")
    np.savez(path, **w)
    return path


def _rel(a, b):
    return abs(a - b) / abs(b)


def lpips_card_vs_cpu(root, npz):
    """19a: LPIPS of the flagship's (bf16, its recorded dtype) quantized
    predictions of the first LPIPS_BURSTS bursts against their ground
    truths at the protocol's boundary, in one per-sample pass over them,
    card against CPU on the same tensors, and its ms a burst on the
    card."""
    from dbsr_tpu_torch.data.datasets import SyntheticBurstVal
    from dbsr_tpu_torch.evaluation import synburst
    from dbsr_tpu_torch.evaluation.network_param import NetworkParam
    from dbsr_tpu_torch.models.lpips import load_lpips
    from dbsr_tpu_torch.serving import FLAGSHIP_CHECKPOINT

    ds = SyntheticBurstVal(root)
    bursts = np.stack([ds[i][0] for i in range(LPIPS_BURSTS)])
    gts = torch.from_numpy(np.stack([ds[i][1] for i in range(LPIPS_BURSTS)]))
    net, _ = NetworkParam(checkpoint_path=FLAGSHIP_CHECKPOINT).load_net(
        "", "cuda")
    preds = synburst.quantize(synburst._forward_fn(net)(
        torch.from_numpy(bursts).cuda()))
    del net
    fn = load_lpips(npz)
    gts_d = gts.cuda()

    def card():
        return fn(preds, gts_d, EVAL_BOUNDARY, reduce=False)

    got = card().cpu()
    want = fn(preds.cpu(), gts, EVAL_BOUNDARY, reduce=False)
    rel = float(((got - want).abs() / want.abs()).max())
    ms = cuda_ms(card, 2, 5) / LPIPS_BURSTS
    log(f"19a: LPIPS of {LPIPS_BURSTS} flagship predictions ({preds.shape[1]}"
        f"^2, boundary {EVAL_BOUNDARY}), card vs CPU: largest relative "
        f"difference {rel:.2e} (limit {LPIPS_RTOL}); values "
        + ", ".join(f"{v:.6f}" for v in got.tolist())
        + f"; {ms:.3f} ms a burst on the card (CUDA events, median of 5)")
    if not rel <= LPIPS_RTOL:
        raise AssertionError(f"19a: LPIPS card vs CPU {rel} > {LPIPS_RTOL}")
    return dict(bursts=LPIPS_BURSTS, max_rel=rel, values=got.tolist(),
                ms_per_burst=ms)


def lpips_scoring_phase(root, npz, workdir):
    """19b: ``compute_score`` of the flagship (bf16) with ``lpips_weights``
    on LPIPS_EVAL_BURSTS bursts (exact launches), its
    PSNR / SSIM against the same call without LPIPS, ms a burst by part;
    the LPIPS mean of LPIPS_CPU_BURSTS bursts against a CPU
    ``compute_score`` of the same predictions, saved by ``save_results``
    on the card."""
    from dbsr_tpu_torch.data.datasets import SyntheticBurstVal
    from dbsr_tpu_torch.evaluation import synburst
    from dbsr_tpu_torch.evaluation.network_param import NetworkParam
    from dbsr_tpu_torch.serving import FLAGSHIP_CHECKPOINT

    nets = [NetworkParam(checkpoint_path=FLAGSHIP_CHECKPOINT,
                         display_name="dbsr_campaign_r5")]
    name = nets[0].get_display_name()
    n_forwards = -(-LPIPS_EVAL_BURSTS // EVAL_BATCH)
    timing, per_burst = {}, {}
    buf = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        got = synburst.compute_score(
            nets, root, max_bursts=LPIPS_EVAL_BURSTS, lpips_weights=npz,
            device="cuda", timing=timing, per_burst=per_burst)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    for line in buf.getvalue().splitlines():
        log(f"  | {line}")
    want = {k: LAUNCHES_PER_S2D_FORWARD.get(k, 0) * n_forwards
            for k in launches}
    if launches != want:
        raise AssertionError(f"19b: launches {launches}, expected {want}")
    if list(got) != ["psnr", "ssim", "lpips"] or not all(
            math.isfinite(v[name]) for v in got.values()):
        raise AssertionError(f"19b: scores {got}")
    with contextlib.redirect_stdout(io.StringIO()):
        plain = synburst.compute_score(nets, root,
                                       max_bursts=LPIPS_EVAL_BURSTS,
                                       with_lpips=False, device="cuda")
    worst = _scores_close("19b: PSNR / SSIM with LPIPS vs without",
                          {m: got[m] for m in plain}, plain,
                          EVAL_PSNR_TOL, EVAL_SSIM_TOL)
    t = timing[name]
    parts = {k: t[k] / LPIPS_EVAL_BURSTS for k in
             ("forward_ms", "metrics_ms", "lpips_ms")}
    log(f"19b: flagship bf16 with LPIPS, {LPIPS_EVAL_BURSTS} bursts: PSNR "
        f"{got['psnr'][name]:.4f} dB, SSIM {got['ssim'][name]:.4f}, LPIPS "
        f"{got['lpips'][name]:.6f} (random weights); launches {launches}; "
        f"ms a burst on the device: " + ", ".join(
            f"{k[:-3]} {v:.3f}" for k, v in parts.items())
        + f"; wall {wall * 1e3 / LPIPS_EVAL_BURSTS:.2f} ms a burst")

    # the CPU's LPIPS of the same predictions: saved on the card, read back
    ds = SyntheticBurstVal(root, num_bursts=LPIPS_CPU_BURSTS)
    saved = os.path.join(workdir, "lpips_saved")
    card_per = {}
    with contextlib.redirect_stdout(io.StringIO()):
        synburst.save_results(nets, root, saved, dataset=ds, device="cuda")
        card = synburst.compute_score(nets, root, lpips_weights=npz,
                                      dataset=ds, device="cuda",
                                      per_burst=card_per)
        cpu = synburst.compute_score(nets, root, saved_results_root=saved,
                                     lpips_weights=npz, dataset=ds,
                                     device="cpu")
    rel = _rel(card["lpips"][name], cpu["lpips"][name])
    log(f"19b: LPIPS mean of {LPIPS_CPU_BURSTS} bursts, card (live) "
        f"{card['lpips'][name]:.7f} vs CPU (the card's saved predictions) "
        f"{cpu['lpips'][name]:.7f}: relative {rel:.2e} (limit {LPIPS_RTOL})")
    if not rel <= LPIPS_RTOL:
        raise AssertionError(f"19b: LPIPS card vs CPU {rel} > {LPIPS_RTOL}")
    return dict(scores=got, without_lpips_max_abs=worst, launches=launches,
                ms_per_burst=parts, wall_ms_per_burst=wall * 1e3
                / LPIPS_EVAL_BURSTS, cpu_lpips_rel=rel,
                per_burst_lpips=per_burst[name]["lpips"].tolist()), launches


def _read_u8(path):
    from dbsr_tpu_torch.utils.png16 import read_png

    return read_png(path).astype(np.int16)


def _panel_psnrs(d, tag):
    out = {}
    for f in os.listdir(d):
        m = re.fullmatch(rf"(.+)_{tag}(-?[\d.]+)\.png", f)
        if m:
            out[m.group(1)] = float(m.group(2))
    return out


def _cli_visualize(argv, per_burst_launches, n_bursts):
    """``run_evaluation.main(argv)`` with the counters reset just before and
    read just after: the launches exactly ``per_burst_launches`` a burst.
    Returns its seconds and launches."""
    from dbsr_tpu_torch import run_evaluation

    buf = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        run_evaluation.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_counts()
    want = {k: per_burst_launches.get(k, 0) * n_bursts for k in launches}
    log(f"run_evaluation {' '.join(argv)}: {secs:.2f} s, launches "
        f"{launches}")
    if launches != want:
        raise AssertionError(f"{argv[:2]}: launches {launches}, expected "
                             f"{want}")
    return secs, launches


def visualize_phase(workdir, syn_root, rw_root):
    """19c-d: ``run_evaluation {synburst,burstsr} visualize dbsr_default``
    with the banked flagship as the workspace's ``dbsr/default_synthetic``
    checkpoint (bf16, the s2d decoder)."""
    import shutil

    from dbsr_tpu_torch.data.datasets import SyntheticBurstVal
    from dbsr_tpu_torch.evaluation import burstsr as rw_eval
    from dbsr_tpu_torch.evaluation import synburst
    from dbsr_tpu_torch.evaluation.network_param import NetworkParam
    from dbsr_tpu_torch.evaluation.visualize import _postprocess, _to_u8
    from dbsr_tpu_torch.serving import FLAGSHIP_CHECKPOINT, load_predictor

    ws = os.path.join(workdir, "vis_ws")
    ckpt_dir = os.path.join(ws, "dbsr", "default_synthetic")
    os.makedirs(ckpt_dir, exist_ok=True)
    shutil.copy(FLAGSHIP_CHECKPOINT,
                os.path.join(ckpt_dir, "dbsr_synthetic_ep0060.ckpt"))
    os.environ["DBSR_TPU_WORKSPACE_DIR"] = ws
    name = "dbsr_default_synthetic"
    nets = [NetworkParam(module="dbsr", parameter="default_synthetic")]
    out, paths = {}, {}

    # (c) synburst
    vis = os.path.join(workdir, "synburst_vis")
    out["synburst_s"], paths["visualize_synburst_bf16"] = _cli_visualize(
        ["synburst", "visualize", "dbsr_default", "--dataset_root", syn_root,
         "--out_dir", vis, "--max_bursts", str(VIS_SYN_BURSTS)],
        LAUNCHES_PER_S2D_FORWARD, VIS_SYN_BURSTS)
    d = os.path.join(vis, name)
    files = sorted(os.listdir(d))
    if len(files) != 4 * VIS_SYN_BURSTS + 1 or "index.html" not in files:
        raise AssertionError(f"19c: {files}")
    pred = load_predictor(FLAGSHIP_CHECKPOINT, batch_size=1, device="cuda")
    ds = SyntheticBurstVal(syn_root)
    per = {}
    with contextlib.redirect_stdout(io.StringIO()):
        # at batch 1, as visualize runs: the bf16 forward's roundings
        # depend on the batch's cuDNN algorithms
        synburst.compute_score(nets, syn_root, workspace_dir=ws,
                               max_bursts=VIS_SYN_BURSTS, with_lpips=False,
                               batch_size=1, device="cuda", per_burst=per)
    named = _panel_psnrs(d, "psnr")
    equal, psnr_gap = [], []
    for i in range(VIS_SYN_BURSTS):
        burst, _, meta = ds[i]
        want = _to_u8(_postprocess(torch.from_numpy(pred(burst)[0]).cuda(),
                                   meta).cpu().numpy()).astype(np.int16)
        got = _read_u8(os.path.join(d, f"{meta['burst_name']}_"
                                       f"prediction.png"))
        diff = np.abs(got - want)
        equal.append(float((diff == 0).mean()))
        if diff.max() > 1 or equal[-1] < VIS_EQUAL_SHARE:
            raise AssertionError(f"19c: burst {i}'s prediction pane vs the "
                                 f"predictor: {equal[-1]} equal, max "
                                 f"{diff.max()}")
        psnr_gap.append(abs(named[meta["burst_name"]]
                            - float(per[name]["psnr"][i])))
    del pred
    log(f"19c: {VIS_SYN_BURSTS} bursts, 4 PNGs each and index.html; the "
        f"prediction panes vs load_predictor(batch 1) through _postprocess: "
        f"{min(equal):.6f} of pixels equal at least, none more than 1 LSB "
        f"off; panel PSNR vs compute_score per burst: largest gap "
        f"{max(psnr_gap):.4f} dB (limit {VIS_PSNR_DB})")
    if max(psnr_gap) > VIS_PSNR_DB:
        raise AssertionError(f"19c: PSNR in a panel's name {psnr_gap}")
    out["synburst"] = dict(pane_equal_share=equal, psnr_gap_db=psnr_gap)
    torch.cuda.empty_cache()

    # (d) burstsr on phase 13's tree
    vis = os.path.join(workdir, "burstsr_vis")
    out["burstsr_s"], paths["visualize_burstsr_bf16"] = _cli_visualize(
        ["burstsr", "visualize", "dbsr_default", "--dataset_root", rw_root,
         "--out_dir", vis, "--max_bursts", str(VIS_RW_BURSTS)],
        LAUNCHES_PER_RW_LITE_BURST, VIS_RW_BURSTS)
    d = os.path.join(vis, name)
    per = {}
    with contextlib.redirect_stdout(io.StringIO()):
        rw_eval.compute_score(nets, rw_root, workspace_dir=ws,
                              max_bursts=VIS_RW_BURSTS, with_lpips=False,
                              device="cuda", per_burst=per)
    named = _panel_psnrs(d, "apsnr")
    gaps = [abs(named[k] - float(v)) for k, v in
            zip(sorted(named), per[name]["psnr"])]
    if len(named) != VIS_RW_BURSTS or len(os.listdir(d)) != \
            4 * VIS_RW_BURSTS + 1 or max(gaps) > VIS_PSNR_DB:
        raise AssertionError(f"19d: {sorted(os.listdir(d))}, gaps {gaps}")
    log(f"19d: {VIS_RW_BURSTS} BurstSR bursts: aligned PSNRs "
        f"{sorted(named.items())}; vs compute_score per burst: largest gap "
        f"{max(gaps):.4f} dB (limit {VIS_PSNR_DB})")
    out["burstsr"] = dict(apsnr=named, psnr_gap_db=gaps)
    return out, paths


def convert_dbsr_phase(requests):
    """19e: a seeded reference state dict of r3d's shape converted by
    ``convert_dbsr_state_dict`` gives the tensors, and on the card the
    forward, of the same weights loaded through ``params_from_flax``
    (flax-layout names made by ``params_to_flax``), bit for bit; the two
    forwards with ``cudnn.deterministic`` (PWC-Net's transposed convs run
    cuDNN's backward-data algorithms, which may sum in any order)."""
    from dbsr_tpu_torch.data.procedural import make_generator
    from dbsr_tpu_torch.models.dbsr import DBSRNet
    from dbsr_tpu_torch.models.layers import init_params
    from dbsr_tpu_torch.serving import float32_math
    from dbsr_tpu_torch.training.checkpoint import read_header
    from dbsr_tpu_torch.utils.convert import params_from_flax, params_to_flax
    from dbsr_tpu_torch.utils.convert_dbsr import (convert_dbsr_state_dict,
                                                   reference_state_dict)

    kwargs = dict(read_header(R3D_CHECKPOINT)["net_spec"]["kwargs"],
                  dtype=None)
    src = init_params(DBSRNet(**kwargs), make_generator("cpu", 19))
    ref = reference_state_dict(src)
    burst = torch.from_numpy(requests[2][None]).cuda()
    sds = (convert_dbsr_state_dict(ref),
           params_from_flax(params_to_flax(src.state_dict())))
    if sds[0].keys() != sds[1].keys() or not all(
            torch.equal(sds[0][k], sds[1][k]) for k in sds[1]):
        raise AssertionError("19e: the converted reference tensors differ "
                             "from params_from_flax's")
    preds = []
    cudnn = torch.backends.cudnn
    for sd in sds:
        net = DBSRNet(**kwargs)
        net.load_state_dict(sd, strict=True)
        cudnn.deterministic = True
        try:
            with torch.no_grad(), float32_math():
                preds.append(net.cuda().eval()(burst)[0].cpu())
        finally:
            cudnn.deterministic = False
    if not torch.equal(*preds) or not torch.isfinite(preds[0]).all():
        raise AssertionError("19e: the converted reference weights' forward "
                             "differs from params_from_flax's")
    log(f"19e: convert_dbsr_state_dict of a seeded r3d-shaped reference "
        f"state dict ({len(ref)} tensors): the forward on the card "
        f"{tuple(preds[0].shape)} bit-equal to params_from_flax's")
    return dict(tensors=len(ref), bit_equal=True)


def conv_flow_phase(dev, workdir, requests):
    """19f: a full-width ``flow_net='conv'`` DBSRNet, card vs CPU (float32,
    seeded); three bf16 ``default_synthetic`` steps with ``flow_net=conv``
    and no flow checkpoint at B=16, exact launches."""
    from dbsr_tpu_torch.data.procedural import make_generator
    from dbsr_tpu_torch.models.dbsr import ConvFlow, dbsrnet_cvpr2021
    from dbsr_tpu_torch.models.layers import init_params
    from dbsr_tpu_torch.serving import float32_math

    net = init_params(dbsrnet_cvpr2021(flow_net="conv",
                                       fused_s2d_decoder=True),
                      make_generator("cpu", 19)).eval()
    burst = torch.from_numpy(requests[2][None])
    with torch.no_grad(), float32_math():
        cpu = net(burst)[0]
        card = net.cuda()(burst.cuda())[0].cpu()
    gap = float((card - cpu).abs().max())
    log(f"19f: ConvFlow DBSRNet (full width, float32), card vs CPU: max abs "
        f"{gap:.2e} (limit {CARD_VS_CPU_TOL}), output max {float(cpu.max()):.4f}")
    if not gap <= CARD_VS_CPU_TOL:
        raise AssertionError(f"19f: ConvFlow card vs CPU {gap}")
    del net

    os.environ["DBSR_TPU_WORKSPACE_DIR"] = os.path.join(workdir, "conv_flow")
    trainer, state = default_synthetic_trainer(
        dev, flow_net="conv", compute_dtype="bfloat16", fused_s2d_decoder=True)
    if not isinstance(trainer.net.encoder.alignment_net, ConvFlow) or not \
            trainer.net.encoder.train_alignment:
        raise AssertionError("19f: the trainer does not train a ConvFlow")
    pool = trainer.loaders[0].batcher.next_batch()
    trainer.train_step(state, make_generator(dev, 7), pool)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    events, losses = [], []
    for i in range(CONV_FLOW_STEPS):
        events.append((torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True)))
        events[-1][0].record()
        stats = trainer.train_step(state, make_generator(dev, 8 + i), pool)
        events[-1][1].record()
        losses.append(stats["Loss/total"])
    torch.cuda.synchronize()
    check_counts("19f, ConvFlow default_synthetic bf16", read_counts(),
                 CONV_FLOW_STEPS, LAUNCHES_PER_CONV_FLOW_STEP)
    losses = [float(v) for v in losses]
    step_ms = statistics.median(a.elapsed_time(b) for a, b in events)
    log(f"19f: {CONV_FLOW_STEPS} bf16 steps at B={TRAIN_B}, ConvFlow trained "
        f"end to end: losses {losses}, median {step_ms:.2f} ms a step (CUDA "
        f"events)")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"19f: losses {losses}")
    del trainer, state
    return dict(card_vs_cpu_max_abs=gap, losses=losses, step_ms=step_ms), \
        LAUNCHES_PER_CONV_FLOW_STEP


def loading_phase(train_workspace, requests):
    """19g: ``load_trained_network('dbsr', 'default_synthetic')`` on phase
    7b's workspace resolves ``resolve_checkpoint``'s path and gives
    ``load_network``'s forward."""
    from dbsr_tpu_torch.serving import float32_math
    from dbsr_tpu_torch.training.checkpoint import (load_network,
                                                    resolve_checkpoint)
    from dbsr_tpu_torch.utils.loading import load_trained_network

    path = resolve_checkpoint(os.path.join(train_workspace, "dbsr",
                                           "default_synthetic"),
                              "dbsr_synthetic")
    net, header = load_trained_network("dbsr", "default_synthetic",
                                       workspace_dir=train_workspace)
    ref, ref_header = load_network(path)
    burst = torch.from_numpy(requests[2][None]).cuda()
    with torch.no_grad(), float32_math():
        a, b = net(burst)[0], ref(burst)[0]
    if header != ref_header or not torch.equal(a, b):
        raise AssertionError("19g: load_trained_network differs from "
                             f"load_network({path})")
    log(f"19g: load_trained_network resolved {os.path.basename(path)} "
        f"(epoch {header['epoch']}), its forward bit-equal to load_network's")
    return dict(path=os.path.basename(path), epoch=header["epoch"])


def completion_phase(dev, workdir, requests):
    """Phase 19 (19a-19g). Returns its numbers and the launches of its
    paths."""
    t0 = time.perf_counter()
    syn_root = os.path.join(workdir, "synburst_val")
    rw_root = os.path.join(workdir, "burstsr")
    npz = lpips_npz(workdir)
    out, paths = {}, {}
    out["lpips"] = lpips_card_vs_cpu(syn_root, npz)
    torch.cuda.empty_cache()
    out["lpips_scoring"], paths["eval_lpips_bf16"] = lpips_scoring_phase(
        syn_root, npz, workdir)
    torch.cuda.empty_cache()
    vis, vis_paths = visualize_phase(workdir, syn_root, rw_root)
    out["visualize"] = vis
    paths.update(vis_paths)
    torch.cuda.empty_cache()
    out["convert_dbsr"] = convert_dbsr_phase(requests)
    torch.cuda.empty_cache()
    out["conv_flow"], paths["conv_flow_step_bf16"] = conv_flow_phase(
        dev, workdir, requests)
    torch.cuda.empty_cache()
    out["loading"] = loading_phase(os.path.join(workdir, "banked"), requests)
    out["phase_s"] = time.perf_counter() - t0
    return out, paths


def nccl_ranks_arg(argv):
    """N of ``--nccl-ranks N``; None without arguments."""
    if not argv:
        return None
    if len(argv) != 2 or argv[0] != "--nccl-ranks" or not argv[1].isdigit() \
            or int(argv[1]) < 2:
        raise SystemExit("usage: python3 chip_smoke.py [--nccl-ranks N], "
                         "N >= 2 cards")
    return int(argv[1])


def nccl_main(dev, n, smi, t_start):
    """Phase 18's collectives on NCCL, one rank a card over ``n`` cards:
    18a and 18d against one process, 18b through ``torch.distributed.run``
    with ``n`` ranks."""
    if torch.cuda.device_count() < n:
        raise AssertionError(f"--nccl-ranks {n} on "
                             f"{torch.cuda.device_count()} cards")
    with tempfile.TemporaryDirectory() as workdir:
        t0 = time.perf_counter()
        out, _ = dp_phase(dev, workdir, n, "nccl")
        out["nccl_cli"] = nccl_cli_phase(workdir, n)
        out["phase_s"] = time.perf_counter() - t0
    log(f"phase 18 on NCCL over {n} cards: {out['phase_s']:.1f} s")
    out.update(total_s=time.perf_counter() - t_start, card=smi)
    log("summary " + json.dumps(out))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main():
    nccl_ranks = nccl_ranks_arg(sys.argv[1:])
    if not torch.cuda.is_available():
        log("chip_smoke: CUDA is not available; nothing to measure")
        return 2
    from dbsr_tpu_torch import kernels
    from dbsr_tpu_torch.serving import FLAGSHIP_CHECKPOINT, load_predictor

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    os.environ.pop(FINE_PATCH_ENV, None)  # phase 10 sets it where it runs
    # 1. environment
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    log(f"device {torch.cuda.get_device_name(0)}; count "
        f"{torch.cuda.device_count()}")
    log(f"TF32 outside the predictor left at PyTorch's defaults (cudnn "
        f"{torch.backends.cudnn.allow_tf32}, matmul "
        f"{torch.backends.cuda.matmul.allow_tf32}); the predictor's forward "
        f"turns it off (float32 convs and matmuls)")

    # 2. build
    secs = kernels.build()
    log(f"kernels built in {secs:.1f} s into {kernels.build_dir()}")
    for name in kernels.SOURCES:
        for line in kernels.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    if nccl_ranks:
        return nccl_main(dev, nccl_ranks, smi, t_start)

    # 3. kernels against their plain versions
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    log("kernel vs plain (float32, serving and train-step shapes):")
    results = kernel_phase(dev, g)
    for e in results:
        for r in e["per_shape"] + e["other_shapes"]:
            log_row(e["name"], r)
    log("PWC-Net's forward shapes (r3d serving, B=8, N=14):")
    add_pwc_rows(results, pwc_forward_rows(dev, g), "serving_r3d_3_requests")
    torch.cuda.empty_cache()
    log("the s2d conv, the resample and the cost volume at odd shapes:")
    odd_shapes = odd_shape_phase(dev, g)
    torch.cuda.empty_cache()
    # a generator of their own: the draws of g that later phases take stay
    # as they were
    g13 = torch.Generator(device=dev)
    g13.manual_seed(13)
    log("the warp at C % 4 != 0 and at SCA's 3-channel shapes:")
    warp_e = next(e for e in results if e["name"] == "warp")
    warp_e["any_c"], warp_e["sca_shapes"] = warp_any_c_rows(dev, g13)
    for r in warp_e["sca_shapes"]:
        log_row("warp (SCA)", r)
    torch.cuda.empty_cache()
    # 14a runs here, beside phase 3: after the later phases' step profiles,
    # device_ms's scheduled profiler sessions recorded no device activity
    g14 = torch.Generator(device=dev)
    g14.manual_seed(14)
    log("phase 14a, the bf16 kernels vs plain (serving shapes, B=8, N=14):")
    add_bf16_rows(results, bf16_kernel_phase(dev, g14))
    torch.cuda.empty_cache()
    # 15a likewise; its rows join the backward kernels' entries of phase 6
    g15 = torch.Generator(device=dev)
    g15.manual_seed(15)
    log(f"phase 15a, the bf16 backward kernels vs plain (train-step shapes, "
        f"B={TRAIN_B}, N={TRAIN_N}; PWC-Net's; an odd C):")
    bf16_backward = bf16_backward_kernel_phase(dev, g15)
    torch.cuda.empty_cache()
    log("phase 15d, the s2d weight gradient kernel (bf16):")
    s2d_dweight = s2d_dweight_phase(dev, g15)
    log("phase 15e, the dead-leaves composite kernel (float32):")
    dead_leaves, pool_round_counts = dead_leaves_phase(dev)
    # 16d likewise: the resample kernel through warp_affine
    g16 = torch.Generator(device=dev)
    g16.manual_seed(16)
    log("phase 16d, warp_affine on the card vs plain:")
    warp_affine_row, warp_affine_counts = warp_affine_phase(dev, g16)
    torch.cuda.empty_cache()

    # 4-5. serving through the fine decoder, then card against CPU
    rng = np.random.RandomState(0)
    requests = [rng.rand(B, N, HW, HW, 4).astype(np.float32),
                rng.rand(3, N, HW, HW, 4).astype(np.float32),
                rng.rand(N, HW, HW, 4).astype(np.float32)]
    t0 = time.perf_counter()
    pred = load_predictor(FLAGSHIP_CHECKPOINT, batch_size=B, burst_size=N,
                          burst_hw=(HW, HW), device="cuda", dtype=None,
                          fused_s2d=False)
    log(f"predictor loaded in {time.perf_counter() - t0:.1f} s")
    serving = serve("serving, fine decoder", pred, requests,
                    LAUNCHES_PER_FORWARD)
    launches = serving.pop("launches")
    serving["card_vs_cpu_max_abs"] = forward_vs_cpu(
        pred, requests[2][None], fused_s2d_decoder=False)
    del pred
    torch.cuda.empty_cache()

    # 6. the training path's kernels against their plain versions
    log(f"training kernels vs plain (float32, train-step shapes, B={TRAIN_B}, "
        f"N={TRAIN_N}):")
    new = backward_kernel_phase(dev, g)
    for e in new:
        for r in e["per_shape"] + e["other_shapes"]:
            log_row(e["name"], r)
    log("warp d_feat at C % 4 != 0 and at SCA's 3-channel shape:")
    dfeat_e = next(e for e in new if e["name"] == "warp_dfeat")
    dfeat_e["any_c"], dfeat_e["sca_shapes"] = dfeat_any_c_rows(dev, g13)
    for r in dfeat_e["sca_shapes"]:
        log_row("warp_dfeat (SCA)", r)
    # a generator of its own, as g13; in float32 here, in bf16 beside 15a
    g_lanes = torch.Generator(device=dev)
    g_lanes.manual_seed(16)
    log("warp d_flow at every lane width of its dispatch:")
    next(e for e in new if e["name"] == "warp_dflow")["lane_widths"] = \
        dflow_lane_rows(dev, g_lanes, torch.float32)
    bf16_backward["warp_dflow"]["other_shapes"] += dflow_lane_rows(
        dev, g_lanes, torch.bfloat16)
    torch.cuda.empty_cache()
    log(f"PWC-Net's backward shapes (its pretraining, B={TRAIN_B}, "
        f"N={TRAIN_N}):")
    add_pwc_rows(new, pwc_backward_rows(dev, g), "pwc_pretrain_step")
    results += new
    add_bf16_training_rows(results, bf16_backward)
    results += [s2d_dweight, dead_leaves]
    next(e for e in results if e["name"] == "resample")[
        "other_shapes"].append(warp_affine_row)
    torch.cuda.empty_cache()

    # 7. training with the banked aligner, frozen
    grads = grad_phase()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as workdir:
        os.environ["DBSR_TPU_ENV"] = os.path.join(workdir, "env.json")
        os.environ["DBSR_TPU_WORKSPACE_DIR"] = os.path.join(workdir, "banked")
        os.environ.pop("DBSR_TPU_ZURICHRAW2RGB_DIR", None)
        per_step, run_losses = training_entry_phase()
        torch.cuda.empty_cache()
        trainer, state = default_synthetic_trainer(dev,
                                                   pwc_checkpoint=ALIGN_LITE)
        train = step_phase(dev, "default_synthetic", trainer, state,
                           LAUNCHES_PER_TRAIN_STEP)
        determinism = determinism_phase(dev, trainer)
        del trainer, state
        torch.cuda.empty_cache()

        # 8. pretraining the aligner; 9. default_synthetic from its checkpoint
        os.environ["DBSR_TPU_WORKSPACE_DIR"] = os.path.join(workdir, "own")
        pre_grads = pretrain_grad_phase(dev)
        torch.cuda.empty_cache()
        pre_per_step, pretrain = pretrain_entry_phase(dev)
        torch.cuda.empty_cache()
        trainer, state = pretrain_trainer(dev)
        pretrain["step"] = step_phase(dev, "align_lite pretraining", trainer,
                                      state, LAUNCHES_PER_PRETRAIN_STEP)
        del trainer, state
        torch.cuda.empty_cache()
        closing = closing_phase(dev)
        torch.cuda.empty_cache()

        # 10. the s2d decoder
        os.environ["DBSR_TPU_WORKSPACE_DIR"] = os.path.join(workdir, "s2d")
        s2d = s2d_phase(dev, requests)
        torch.cuda.empty_cache()

        # 11. the eval protocol, scoring phase 7b's run in 11e
        t0 = time.perf_counter()
        evaluation = eval_phase(workdir, os.path.join(workdir, "banked"))
        evaluation["phase_s"] = time.perf_counter() - t0
        log(f"phase 11: {evaluation['phase_s']:.1f} s")

        # 12. PWC-Net: r3d served, pretraining, default_synthetic's paths
        os.environ["DBSR_TPU_WORKSPACE_DIR"] = os.path.join(workdir, "pwc")
        t0 = time.perf_counter()
        pwc, pwc_paths = pwc_phase(dev, requests, workdir)
        pwc["phase_s"] = time.perf_counter() - t0
        log(f"phase 12: {pwc['phase_s']:.1f} s")
        torch.cuda.empty_cache()

        # 13. the real-world path: SCA, BurstSR scoring, default_realworld
        t0 = time.perf_counter()
        realworld, rw_paths = realworld_phase(dev, workdir)
        realworld["phase_s"] = time.perf_counter() - t0
        log(f"phase 13: {realworld['phase_s']:.1f} s")
        torch.cuda.empty_cache()

        # 14. bf16: serving and scoring (14a ran beside phase 3)
        t0 = time.perf_counter()
        bf16 = {}
        bf16["serving_b8"], bf16_paths = bf16_serving_phase(requests)
        torch.cuda.empty_cache()
        bf16["eval"] = bf16_eval_phase(workdir, evaluation["scores"])
        torch.cuda.empty_cache()
        bf16["burstsr"], bf16_paths["burstsr_eval"] = bf16_burstsr_phase()
        bf16["phase_s"] = time.perf_counter() - t0
        log(f"phase 14: {bf16['phase_s']:.1f} s")
        torch.cuda.empty_cache()

        # 15. bf16 training (15a ran beside phase 3)
        t0 = time.perf_counter()
        bf16_training, bf16_train_paths = bf16_training_phase(dev, workdir)
        bf16_training["phase_s"] = time.perf_counter() - t0
        log(f"phase 15b-c: {bf16_training['phase_s']:.1f} s")

        # 16. training data beyond dead leaves (16d ran beside phase 3)
        t0 = time.perf_counter()
        data, data_paths = data_phase(
            dev, workdir, bf16_training["realworld"]["step"]["step_ms"])
        data["phase_s"] = time.perf_counter() - t0
        log(f"phase 16: {data['phase_s']:.1f} s")
        torch.cuda.empty_cache()

        # 17. the serving daemon and run_serving; the trainer's service
        # layer (params-only resume, the async writer, tracing)
        t0 = time.perf_counter()
        service, service_paths = service_phase(dev, workdir, requests)
        service["phase_s"] = time.perf_counter() - t0
        log(f"phase 17: {service['phase_s']:.1f} s")

        # 18. data parallelism (two gloo ranks on the card; the CLI under
        # NCCL), multi-device serving, frame sharding, the PNG loaders
        parallel, parallel_paths = parallel_phase(dev, workdir, requests)
        log(f"phase 18: {parallel['phase_s']:.1f} s")
        torch.cuda.empty_cache()

        # 19. the last slice: LPIPS, visualize, the converter,
        # load_trained_network, ConvFlow
        completion, completion_paths = completion_phase(dev, workdir,
                                                        requests)
        log(f"phase 19: {completion['phase_s']:.1f} s")
    paths = {"train_step": per_step, "pretrain_step": pre_per_step,
             "train_alignment_step":
                 closing["train_alignment"]["launches_per_step"],
             "s2d_train_step": s2d.pop("launches_per_step"),
             **{k: v for k, v in pwc_paths.items() if k.endswith("_step")},
             "realworld_step": rw_paths["realworld_step"],
             **bf16_train_paths,
             **{k: v for k, v in data_paths.items()
                if k != "val_source_dir"},
             "resume_params_only_step_bf16":
                 service_paths["resume_params_only_step_bf16"],
             "async_ckpt_step_bf16": service_paths["async_ckpt_step_bf16"],
             "dp_step_bf16_rank": parallel_paths["dp_step_bf16_rank"],
             "conv_flow_step_bf16": completion_paths["conv_flow_step_bf16"],
             "pool_round_128": pool_round_counts}
    serving_launches = {"serving_3_requests": launches,
                        "serving_s2d_3_requests": s2d.pop("launches"),
                        "serving_r3d_3_requests":
                            pwc_paths["serving_r3d_3_requests"],
                        "eval": evaluation.pop("launches"),
                        "eval_r3d": evaluation.pop("launches_r3d"),
                        "burstsr_eval": rw_paths["burstsr_eval"],
                        "burstsr_eval_r3d": rw_paths["burstsr_eval_r3d"],
                        "serving_bf16_3_requests":
                            bf16_paths["flagship_s2d_kernel"],
                        "serving_bf16_r3d_3_requests": bf16_paths["r3d"],
                        "eval_bf16": bf16["eval"]["runs"][
                            "dbsr_campaign_r5"]["launches"],
                        "burstsr_eval_bf16": bf16_paths["burstsr_eval"],
                        "val_source_dir": data_paths["val_source_dir"],
                        "warp_affine": warp_affine_counts,
                        "serving_daemon_bf16":
                            service_paths["serving_daemon_bf16"],
                        "serving_2_replicas_bf16":
                            parallel_paths["serving_2_replicas_bf16"],
                        "frame_sharded_forward_rank":
                            parallel_paths["frame_sharded_forward_rank"],
                        **{k: completion_paths[k] for k in (
                            "eval_lpips_bf16", "visualize_synburst_bf16",
                            "visualize_burstsr_bf16")}}
    for e in results:
        # launches on each driven path: the three serving requests through
        # each decoder and of r3d, the eval protocol (the val set's
        # generation and the flagship's scoring; r3d's scoring), BurstSR's
        # aligned scoring (the flagship's; r3d's), then per step of the
        # eight training paths; `launches` is the count on the entry's own
        # path
        by_path = {k: v[e["name"]]
                   for k, v in {**serving_launches, **paths}.items()}
        e["launches_by_path"] = by_path
        e["launches"] = by_path[e["path"]]
        if not e["launches"]:
            raise AssertionError(f"{e['name']} was not launched on its path "
                                 f"{e['path']}")
        if "pwc_path" in e and not by_path[e["pwc_path"]]:
            raise AssertionError(f"{e['name']} was not launched on PWC-Net's "
                                 f"path {e['pwc_path']}")
        e.setdefault("dtypes", ["float32", "bfloat16"]
                     if "bf16" in e or "bf16_training" in e
                     else ["float32"])
        if "bf16_training" in e:
            # the encoder's warp, the merge and the decoder's d_input on the
            # frozen bf16 step; d_flow and the cost volume's backward where
            # the aligner trains, the fallback's PWC-Net
            t = e["bf16_training"]
            t["path"] = ("train_step_bf16" if e["name"] in (
                "warp_dfeat", "merge_backward", "conv_s2d")
                else "pwc_fallback_step_bf16")
            t["launches"] = by_path[t["path"]]
            if not t["launches"]:
                raise AssertionError(f"{e['name']} was not launched on the "
                                     f"bf16 training path {t['path']}")
        if "bf16" in e:
            # the bf16 forward with the s2d conv's switch (all four); PWC-Net's
            # in bf16 for the two it runs
            e["bf16"]["path"] = "serving_bf16_3_requests"
            e["bf16"]["launches"] = by_path["serving_bf16_3_requests"]
            if not e["bf16"]["launches"] or ("pwc_shapes" in e["bf16"] and not
                                             by_path["serving_bf16_r3d_3_"
                                                     "requests"]):
                raise AssertionError(f"{e['name']} was not launched on the "
                                     "bf16 serving paths")

    summary = dict(serving_b8=serving, train=train,
                   train_card_vs_cpu=grads, run_training_losses=run_losses,
                   determinism=determinism,
                   launches_per_train_step=per_step,
                   pretrain=pretrain, pretrain_card_vs_cpu=pre_grads,
                   launches_per_pretrain_step=pre_per_step,
                   closing_the_loop=closing, s2d_decoder=s2d,
                   eval=evaluation, pwc=pwc, realworld=realworld, bf16=bf16,
                   bf16_training=bf16_training,
                   training_data=data, service=service,
                   parallel=parallel, completion=completion,
                   odd_shapes=odd_shapes, build_s=secs,
                   total_s=time.perf_counter() - t_start, card=smi)
    log("summary " + json.dumps(summary))
    log(smi)
    log(json.dumps({"kernels": results}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
