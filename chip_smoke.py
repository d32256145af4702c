#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Phases, each printed as one JSON line; any failure raises and the script
exits non-zero. It needs one CUDA card and refuses to run without one.

1. The card (``nvidia-smi`` name and power limit), torch and CUDA versions,
   then the nvcc build of every kernel (``crnn_ocr_torch/kernels/csrc``),
   timed, with ptxas's register and spill report (per instance of the
   recurrences' resident design, ``resident_ptxas``, of K9's and K10's
   tiled kernel, ``stem_bwd_ptxas``, and of K1's and K8's kernels,
   ``stem_fwd_ptxas``).
2. Each kernel against its plain PyTorch version on the card, at the
   main-path shapes and on the main path's own tensors (``fonts-hard``,
   256 lines, bucket 256), with TF32 off: max error against the stated
   tolerance, and the median times of the kernel, the plain version and a
   PyTorch yardstick the port never calls, beside the kernel's bound. K2
   reports its design (``kernels/bigru.py::design_for``: cluster size and
   rows) and, on the same inputs, the streamed design's time (the design
   of bf16 shapes above 256 units, a yardstick held to the plain version
   and compared with the path's design bit for bit; in f32 the old
   ``"f32"`` design's), with the instance's
   shared memory, registers and the clusters the card holds at once. K1
   reports its design (``"mma"`` in bf16 with its plan,
   ``_stem_tiles.stem_plan``; ``"conv9"`` in f32) and its instance's
   ptxas report.
3. Golden texts: ``load_pretrained`` on the card against the JAX
   predictor's texts and scores in ``crnn_ocr_torch/testdata/
   greedy_goldens.npz`` (written by ``tools/gen_torch_goldens.py``).
4. The main path, counted: ``fonts-hard`` serving at full width, B = 256,
   bucket 256, bf16, from uint8 images to texts through
   ``Predictor.predict``. The kernels' launch counts, and the recurrences'
   launches per design, are set to 0 just before its timed calls and read
   just after: each call must launch K1 once (on the ``"mma"`` design) and
   K2 twice (one per BiGRU layer), every K2 on the resident design.
   Throughput, then a per-stage
   breakdown through the Predictor's own steps and a profiler trace.
5. Per kernel: its launches in phase 4's timed calls, error, times and
   bound.

Slice 2, training ``fonts-hard`` (bf16, B = 128, bucket 256: the 64 golden
lines repeated, labels padded to 32):

6. K3 (BiGRU forward with the gate stash), K6 and K7 (CTC alpha and beta)
   against their plain versions on the training path's own activations and
   log-probs, in bf16 and f32, TF32 off, with K2 timed on K3's inputs (the
   stash's cost) and ``nn.GRU`` / ``F.ctc_loss`` as yardsticks. K6 and K7
   run on the path's design (``ctc_loss.plan``: ``"pipelined"``) and on
   ``"block"`` (the first design), both held to the plain versions; each
   reports its ``design``, ``plan``, ``us_per_frame`` (device ms over the
   T - 1 or T dependent frames), ``block_ms`` and ``block_equal`` (the old
   design's device time on the same inputs, and its outputs bit for bit),
   its ``ptxas`` report, and ``kernel_ms`` (CUDA events, one call through
   the wrapper) beside ``kernel_ms_old_host_path`` (the same kernel through
   the wrapper's earlier host path). Then the GRU's backward kernel
   (``check_bigru_backward``) against its plain loop on a K3 stash at
   train-hard's shape (bf16, T 64, B 1024, H 256) and fonts-small's (f32,
   T 32, B 128, H 128): errors, two runs bit for bit, the kernel's and the
   whole function's device ms beside the bound, the plain loop's ms,
   ``nn.GRU``'s training backward as ``library_ms``, and each rows
   instance's time and capacity.
7. One f32 train step (dropout 0) through the kernels against the same
   step through the plain versions on the card (loss, grad_norm, every
   parameter's gradient and every updated parameter; the backbone's
   convolutions off cuDNN in both), and against the JAX package's step
   (``crnn_ocr_torch/testdata/train_goldens.npz``).
8. The training path, counted: 30 timed steps of ``produce_batch`` plus
   ``fit``'s train step (dropout 0.2, learning rate 1e-4) with the launch
   counts set to 0 just before and read just after: each step must launch
   K3 twice (on the resident design), the GRU's backward kernel twice (on
   ``BWD_PATH_DESIGN``, reported as ``backward_designs``), K6 and K7 once,
   the training stem's K8, K1 (on the ``"conv9"`` design), K9 and K10
   once, K2 never; the mean
   loss of the last 5 steps
   must be below the first
   step's. Then lines/s over the timed steps' whole time, the p50 step, a
   per-stage breakdown (the stem's forward a stage of its own, its
   backward a trace range), a profiler trace, and ``fit`` with an
   evaluation.

Slice 3, the STN front end (``fonts-warp-stn``: n_units 256, bf16, fixed
bucket 256; and ``fonts-stn``), on the 64 lines of each model's own task in
``crnn_ocr_torch/testdata/stn_goldens.npz``:

9. K11 (bilinear sampler) and K12 (its backward) against their plain
   versions on the path's own tensors: the frames and theta of
   ``fonts-warp-stn`` at B 256 (serving) and B 128 (training), bf16 and
   f32, TF32 off; ``d_img`` also through autograd with an image that
   requires a gradient. ``F.grid_sample`` (border, align_corners) and its
   backward are the yardsticks. K12 runs the path's design
   (``grid_sample.plan``: ``"cluster"``) and the first one (``"image"``)
   on the same inputs, held to each other (dx, dy bit for bit) and to the
   plain version; its row adds ``design``, ``plan``, ``ptxas``,
   ``image_ms`` (the first design's device time) and, for both designs,
   the device time with the L2 flushed before each launch (``cold_ms``,
   ``image_cold_ms``: a 128 MB buffer written first); K11's and K12's
   rows add ``kernel_ms_old_host_path`` (CUDA events through the
   wrappers' earlier host path: argtypes set per call, always a device
   switch) beside ``kernel_ms``.
10. Golden texts: ``fonts-stn`` and ``fonts-warp-stn`` in f32 equal to the
    JAX predictor's (scores rtol 1e-4); ``fonts-warp-stn`` as shipped
    (bf16) at most 1 line in 64 off the JAX bf16 golden, and the kernel
    run's texts equal the plain versions'.
11. Serving ``fonts-warp-stn`` counted, as phase 4: each ``predict`` must
    launch K11 once, K1 once (on ``"mma"``) and K2 twice; stages split
    into the STN's
    localization, the sampler and the rest.
12. One f32 ``fonts-warp-stn`` train step: kernels against plain versions,
    and against the JAX step (``stn_goldens.npz``, ``train/``).
13. Fine-tuning ``fonts-warp-stn`` counted, as phase 8 (bf16, B 128): each
    step must launch K11 and K12 once (every K12 on ``"cluster"``,
    ``SAMPLER_PATH_DESIGN``), K3 twice, K6 and K7 once, K1, K2 and K8-K10
    never (an STN model trains through the plain stem); the loss must
    fall.
14. Serving in turns: ``fonts-hard`` on its lines and on the STN task's,
    and ``fonts-warp-stn`` on its own, alternated within the call, so that
    the STN's cost and the lines' cost read apart from the host's drift.

Slice 4, the training stem (``fonts-small``: n_units 128, time_dense 64,
B 128, bucket 128, on its 64 golden lines repeated):

15. K8 (batch statistics), K9 and K10 (the stem backward's partial sums and
    weight gradient) against their plain versions on the training path's
    own image, weights and pooled gradient, at ``fonts-small``'s shape and
    at ``fonts-hard``'s (bucket 256), bf16 and f32, TF32 off; K1 in the
    training forward (on ``"conv9"``, fed the batch statistics) against
    its plain version at phase 2's tolerance, and its time; cuDNN's conv +
    ``torch.var_mean`` (K8), the plain stem's autograd backward (K9 +
    K10 as a pair) and cuDNN's conv + affine + ReLU + max-pool (K1's
    training call) as yardsticks. K8's, K9's and K10's rows add their
    ``design`` (``_stem_tiles.stem_plan`` and ``fused_stem_train.
    bwd_plan``: band rows, column tiles, tiles, CTAs, shared-memory bytes)
    and their instance's ``ptxas`` report.
16. One f32 ``fonts-small`` train step: kernels against plain versions,
    and against the JAX step (``train_goldens.npz``, ``small/``), which ran
    the JAX package's fused train stem; its two K3 launches must run on the
    resident design (its f32 instance).
17. Fine-tuning ``fonts-small`` counted, as phase 8 (bf16, dropout 0.2):
    each step must launch K8, K9, K10 and K1 (on ``"conv9"``) once, K3
    twice, K6 and K7 once, K2 never; the loss must fall.

Slice 5, the BiLSTM (``fonts-hard-lstm``: ``fonts-hard`` with its two BiGRU
layers replaced by seeded BiLSTM layers, ``crnn_ocr_torch/infer/
pretrained.py::VARIANTS``; full width and depth, bf16), on the 64 ``hard``
golden lines:

18. K4 (the BiLSTM recurrence) at B 256 and K5 (with the stash) at B 128
    against their plain versions on layer 0's own input projections, bf16
    and f32, TF32 off; K4 also timed on K5's inputs (the stash's cost);
    ``nn.LSTM`` (bidirectional, the weights carried over, the input
    projection included) as the yardstick; K4 and K5 with their designs
    and the same yardsticks as K2 in phase 2 (K3 with its own in phase 6):
    in f32 the resident design's 32-unit tile in clusters of 8, beside the
    old ``"f32"`` design on the same inputs.
19. Golden texts (``crnn_ocr_torch/testdata/lstm_goldens.npz``, written by
    ``tools/gen_torch_goldens.py --lstm``): the seeded layers' digest; f32
    texts equal to the JAX predictor's, scores within rtol 1e-4; bf16 texts
    equal to the JAX bf16 golden's (every frame's top class leads by at
    least 4 nats) and to the plain versions' on the card; the probabilities
    of 8 lines against JAX's (the texts are all empty: the seeded BiLSTM
    leaves ``fonts-hard``'s trained head on blank).
20. Serving ``fonts-hard-lstm`` counted, as phase 4: each ``predict`` must
    launch K1 once (on ``"mma"``) and K4 twice (on the resident design), K2
    never.
21. One f32 ``fonts-hard-lstm`` train step: kernels against plain versions
    (the stem's kernels kept in both steps: they are held to their plain
    versions in phases 15-17, and their ulp differences flip block1's
    max-pool near-ties behind this model's large gradients; the step
    against the all-plain one is reported beside it), and against the JAX
    step (``lstm_goldens.npz``, ``train/``); its two K5 launches must run
    on the resident design (its f32 instance).
22. Fine-tuning ``fonts-hard-lstm`` counted, as phase 8: each step must
    launch K5 twice (on the resident design), K6 and K7 once, K8, K1 (on
    ``"conv9"``), K9 and K10 once, K3 and K4 never; the loss must fall.

Slice 6, the f32 recurrences (``fonts-small`` as it ships, f32, n_units
128, bucket 128; then ``fonts-hard-lstm`` in f32):

23. K2 at its serving shape (B 256) and K3 at its training shape (B 128)
    on the path's own tensors against their plain versions, TF32 off, with
    the old ``"f32"`` design's time on the same inputs, ``nn.GRU`` in f32
    as the yardstick and the bound with its peak named; then ``fonts-small``
    served counted, as phase 4, at B 256, bucket 128: each ``predict`` must
    launch K1 once (on ``"conv9"``) and K2 twice, every K2 on the resident
    design (its f32 instance); lines/s, the p50, the stages and a trace.
24. ``fonts-hard-lstm`` served in f32 counted, as phase 4, at B 256, bucket
    256: each ``predict`` must launch K1 once (on ``"conv9"``) and K4
    twice, every K4 on the resident design (its f32 instance, clusters of
    8); lines/s, the p50, the stages and a trace (to compare with a parent,
    run this phase from a copy of this script in the parent's tree, its
    ``PATH_DESIGN["bilstm"]`` set to the parent's ``"f32"``).

25. Serving by beam (no kernel of its own): the TF-exact beam on the card
    (``ops/ctc_beam_device.py``; W 10, 3 paths, ``merge_repeated`` on and
    off) on the JAX f32 probabilities of ``fonts-hard``'s and
    ``fonts-small``'s 64 golden lines against JAX's labels (equal) and
    scores (rtol 1e-5, atol 1e-5), the C++ decoder's labels on the same
    (``exact_tf``), greedy alignment and forced alignment of the beam's
    top path against JAX's (frames equal, confidences rtol 1e-6), all from
    ``crnn_ocr_torch/testdata/beam_goldens.npz``; ``load_pretrained(
    "fonts-hard").predict(greedy=False)`` end to end: f32 texts equal to
    the JAX beam's, scores rtol 1e-4, spans (``alignments=True``) equal on
    every line whose text is equal, bf16 at most 1 line in 64 off; then
    ``fonts-hard`` counted as phase 4 (B 256, bucket 256, bf16, W 10, one
    path: each ``predict`` launches K1 once on ``"mma"`` and K2 twice on
    ``"resident"``), its lines/s, p50 and stages; the decode stage alone
    split into device and host ms with its host syncs (a profiler window
    read off the raw records), beside the exact tier run on every frame
    and both at B 16; the tier mix (``ctc_beam_tier_stats``); the C++
    decoder's time on the same probabilities; phase 4's greedy numbers.

26. The serving daemon, reference artifacts and the CLIs (no kernel of
    their own): (a) ``fonts-hard`` in f32 behind ``OCRServer(port=0,
    max_batch=32, max_wait_ms=20)``, the 64 golden lines posted as ``.npy``
    from 16 client threads at once, greedy, by beam (W 10, one path, the
    provenance-keyed merge) and greedy with alignments: each reply against
    JAX's output for its line on the canvas its batch gave it
    (``serve_goldens.npz``'s ``cond_*``, written by ``tools/
    gen_torch_goldens.py --serve``; a line whose height or width lies on
    the canvas ladder reads its batch's padding only when it is not the
    batch's tallest or widest, ``canvas_variants``), texts and spans equal,
    scores rtol 1e-4 / atol 1e-5, confidences within 1e-4; ``/healthz``,
    ``/stats`` (64 requests), ``/metrics`` and a garbage payload's 400;
    ``predict_many`` against JAX's ``predict_many``; (b) ``fonts-hard`` as
    shipped (bf16) behind ``OCRServer(max_batch=256, max_wait_ms=5)``
    after ``batcher.warmup()`` (timed), the launch counts set to 0, then
    the 64 lines 32 times from 64 client threads: K1 launches equal the
    batcher's batches (all on ``"mma"``) and K2 twice that (all
    ``"resident"``), every reply one of its line's texts alone through
    ``Predictor.predict`` on each canvas it can meet (at most one reply in
    64 off); req/s, client and server p50/p95, mean batch size, padded
    rows, launches by design and the device's idle share over a profiled
    window of 512 more requests; the same by beam (W 10, 8 times the
    lines, no trace); (c) ``init_predictor`` of ``tests/goldens/
    migration_autonamed{,_stn}`` on the card: the forward on ``io.npz``'s
    input (f32) against Keras's output at rtol 1e-4 / atol 2e-5, its
    launches (K1 once, K2 once, K11 once with the STN); (d) ``python -m
    crnn_ocr_torch.cli.serve --pretrained fonts-hard --port 0 --max_batch
    64`` as a subprocess, 512 requests from this process's threads,
    ``/metrics``, SIGTERM: rc 0, ``shutting down``, every reply 200, at
    most one line off (b)'s; its req/s; (e) where ``cv2`` imports,
    ``cli.predict.main`` on the lines as PNGs with ``--annotation`` and
    ``--validate`` (rows equal to ``predict_many``'s, at most one line off
    (a)'s f32 texts), else a ``{"phase": "predict_cli", "cv2": false}``
    line and ``predict_many`` alone.

27. Fine-tuning ``fonts-hard-lstm`` from image files (no kernel of its
    own; bf16, dropout 0.2, Adam at ``FILES_LR``), in a temporary
    directory outside the repo: (a) the 64 ``fonts-hard`` golden lines,
    each cropped by its height and width, written with ``cv2.imwrite`` as
    PNG under 16 names (1,024 files) with an ``annotation.txt``, read by
    ``Reader(ReaderConfig(batch_size=128, val_fraction=0.125, buckets=(64,
    128, 192, 256), max_label_len=32, pack_cache=True))`` with
    ``fonts-hard``'s codec; the reader's host ms a training batch with the
    pack cache cold (the first epoch) and warm, and each split's batches by
    bucket (bucket 64's lines never fill a training batch of 128, so they
    reach the evaluation only); (b) ``fit`` over ``device_batches(...,
    prefetch=2)`` for ``FILES_STEPS`` steps with ``checkpoint_dir``, an
    evaluation every ``FILES_EVAL_EVERY`` steps and ``profile_dir``,
    counted: each step must launch K5 twice (resident), K6, K7, K8, K1 (on
    ``"conv9"``), K9 and K10 once, and each evaluation batch K1 (on
    ``"mma"``) once, K4 twice and K6 once; the loss must fall, the
    evaluation CER must fall from the first evaluation to the best, the
    trace file must name the K5 kernel; one checkpoint's save and restore
    ms and its size; the files path timed as phase 22 (the next batch plus
    the train step, synchronized, 30 steps) with the prefetch thread, with
    the reader on the step's thread, and from the same epoch's host
    batches held in memory, beside phase 22's in-memory lines/s from this
    call; (c) fit to step 9 with
    ``checkpoint_dir``, restore into a fresh state (bit for bit: every
    parameter, BatchNorm statistic, optimizer slot and the step), fit to 18
    from ``run_generator(skip=9)`` against a straight 18-step run:
    ``bitwise: true``, else within rtol 2e-4 / atol 2e-5 with the largest
    difference printed and two straight runs compared; (d) ``init_predictor`` of the
    checkpoint directory: texts equal to a ``Predictor`` of the trained
    state in memory on the 64 golden lines, scores within 1e-5, its CER
    and sequence accuracy; ``python -m crnn_ocr_torch.cli.predict --model
    <checkpoint dir> --greedy`` as a subprocess: its rows equal
    ``predict_many``'s; (e) 3 counted steps each of sgd, rmsprop, adadelta
    and adamw on ``fonts-hard`` (bf16, B 128, bucket 256): finite losses,
    the slots filled, 2 K3 and one each of K6-K10 and K1 a step. To run it
    alone: ``phase_build(card)`` then ``phase_files(card, g)``.

28. Fine-tuning ``fonts-hard`` (bf16, dropout 0.2, Adam at ``TRAIN_LR``)
    with the augmentation (``ops/augment.py``: jitter, noise and an affine
    warp through K11), K = 4 steps a call, from phase 27's 1,024 PNGs held
    on the card (``DeviceResidentCorpus``, buckets 64-256, B 128), in a
    temporary directory outside the repo: (a) the corpus's stacks
    (``stacked_index_batches(4)``) gathered on the card against the host
    path's (``stack_host_batches`` of ``run_generator``) byte for byte over
    two epochs; one cached K = 4 call against 4 streamed single steps on
    the same batches in f32 (losses rtol 1e-5 / atol 1e-6, parameters rtol
    1e-3 / atol 1e-6, Adam's slots atol 2e-5, the largest differences
    printed); 8 steps over a corpus with half its pixel rows resident
    against full residency, bit for bit; the augmentation through K11
    against its CPU twin on the card's own draws (atol 1e-5), the draws in
    their ranges and the noise's mean and std within 3 standard errors;
    ``batched_levenshtein`` on 4,096 random pairs against the native
    ``editdistance``, equal; (b) ``fit`` with ``device_corpus``,
    ``steps_per_call=4``, ``augment``, ``on_device_cer``, a checkpoint and
    an evaluation every ``AUG_EVAL_EVERY`` steps, counted: each step 1
    K11, 1 K8, 1 K1 (``"conv9"``), 1 K9, 1 K10, 2 K3, 1 K6 and 1 K7, each
    evaluation batch 1 K1 (``"mma"``), 2 K2 and 1 K6; before each
    evaluation the same state is evaluated with the host's CER (its
    launches taken back out of the counts), and the two CERs must be
    equal; finite losses, the last CER at most the first's + 0.02; (c) 48
    steps of ``fit`` from the same state in five modes, in turns (1-5 then
    5-1): single streamed steps with and without augmentation, K = 4
    streamed stacks, the corpus at full and at half residency (all three
    augmented): lines/s and the host's p50 ms a call, a traced window of
    modes 2 and 4 (the device's idle share, K11's device ms a step), the
    corpus's bytes and ``torch.cuda.memory_allocated``, beside phase 22's
    in-memory lines/s; (d) one evaluation pass's CER sums on the card
    against the host's loop (ms, launches), and one ``batched_levenshtein``
    at B 128, La = Lb = 32; (e) on a single-bucket corpus (256), fit 8
    steps with a checkpoint, restore into a fresh state, fit to 16 from
    ``stacked_index_batches(4, skip=8)``, against a straight 16-step run:
    ``bitwise: true``, else the largest difference and two straight runs
    compared. To run it alone: ``phase_build(card)`` then ``phase_aug(card,
    g)``.

29. Data parallelism on the one card (``phase_dp``; no kernel of its own,
    no kernel changed). Two ranks are spawned on ``cuda:0`` over gloo
    (NCCL refuses two ranks on one card), after ``phase_build`` built the
    kernels, with a deadline on every collective and on the join; each
    writes its results to a temporary directory and any failed check
    fails its rank and the phase. (a) Each rank's backend (gloo),
    ``all_reduce`` and ``broadcast`` of CUDA tensors, the port's autograd
    ``all_reduce`` (value and gradient) and ``gather_rows``. (b)
    ``fonts-hard`` in f32, TF32 and the backbone's cuDNN off as in phase
    7: one DP step on the global batch of 128 (64 rows a rank) against
    the single-device step (``compare_steps``: loss rtol 2e-5, gradients,
    parameters and running statistics as phase 7); 120 lines padded to
    128 on the mesh against the 120 lines on one device, unpadded (the
    fused stem) and with an all-ones mask (the masked plain stem), its
    launches counted (no K8, K9, K10 or training K1); 3 steps with
    dropout 0.2, twice on the mesh (bitwise equal) and against one
    device; every rank holding one state. (c) 20 counted DP steps of
    ``fonts-hard`` in bf16, dropout 0.2 (``produce_batch`` on the global
    batch, the rank's rows, the DP step, synchronized): per rank and step
    2 K3, 1 each of K6-K10 and K1 (``"conv9"``), K2 never, every launch
    on its path's design; the loss falls; lines/s and the p50 step per
    rank beside phase 8's (two ranks sharing one card: the collectives'
    overhead, not a speed-up); then ``fit`` on the mesh, 8 steps with an
    evaluation and a checkpoint every 4 (rank 0 alone writes), and a
    fresh state restored at step 4 and fitted on to 8: bitwise. (d) A
    local mesh of ``cuda:0`` twice serving ``fonts-hard``: bf16 at B 255
    (a blank row pads it to 256) with texts equal to one device's and 1
    K1 (``"mma"``) and 2 K2 a shard; f32 texts and scores against
    ``greedy_goldens.npz`` at phase 3's tolerance. (e) ``python -m
    crnn_ocr_torch.cli.train --dataset synthetic --n_devices 1 --steps
    20`` (bf16 by ``--dtype auto``), ``cli.predict --model`` on its save
    path, and ``--n_devices 2``, which must exit non-zero with
    ``make_mesh``'s message.

30. Migration on the card (``phase_migration``; no kernel of its own, no
    kernel changed; the card machine has no ``h5py``, ``tf_keras``,
    ``orbax``, ``tensorstore`` or Python zstd). (a) ``fonts-hard``'s
    bundled weights saved as a port model directory, ``python -m
    crnn_ocr_torch.cli.migrate export`` of it (``model.h5`` by the port's
    HDF5 writer; ``model.json`` skipped without ``tf_keras``), the ``.h5``
    read back by the port's reader bit for bit, ``migrate import --device
    cuda`` of the exported directory, and the import served on the
    card: in bf16 (its config's dtype replaced, as ``fonts-hard`` ships)
    texts equal to ``load_pretrained("fonts-hard")``'s with 1 K1
    (``"mma"``) and 2 K2 (resident) a batch; through ``init_predictor``
    (f32, as saved) texts equal to the JAX goldens, scores rtol 1e-4 /
    atol 1e-5 (phase 3's gate); the export, read, import and
    ``init_predictor`` ms and the file's bytes. (b) The committed orbax
    fixture (``crnn_ocr_torch/testdata/orbax_small/``: the JAX package's
    ``CheckpointManager`` directory of a 64-filter-stem, one-BiGRU (H 128)
    model after 2 Adam steps, written by ``tools/gen_torch_goldens.py
    --orbax``) restored into an Adam train state on the card (its read
    ms), then one f32 step (TF32 and the backbone's cuDNN off, as phase 7)
    against JAX's third step in ``orbax_goldens.npz``: loss rtol 1e-4,
    every parameter rtol 2e-4 / atol 2e-5 but for elements whose JAX
    gradient is at the f32 noise of its sum (at most 0.1 % of a tensor,
    within 2 lr), the BatchNorm statistics likewise; the step launches
    1 each of K8, K1 (``"conv9"``), K9, K10, K6 and K7 (``"pipelined"``)
    and 1 K3 (resident); the fixture is left byte for byte unchanged.
    A line names the zstd decoder that ran (ctypes, ``libzstd.so.1``
    and its version). To run it alone: ``phase_build(card)`` then
    ``phase_migration(card, g)``.

31. The JAX package's public surface on the card (``phase_surface``; no
    kernel source changed). (d) Without JAX: every ``__all__`` of every
    port package resolves, every JAX module path imports in the port, and
    every counterpart ``crnn_ocr_torch/counterparts.py`` names resolves.
    Then, from ``surface_inputs``' seed (numpy ``RandomState``, rebuilt for
    JAX by ``tools/gen_torch_goldens.py --surface``), counted through
    ``crnn_ocr_torch.ops``: (a) ``fonts-hard``'s training CTC shape (B
    128, T 62, 62 classes and the blank, labels padded to 32 with the
    blank), ``ctc_forward_log_loss`` at blank 0 and
    ``ctc_loss_from_log_probs`` (blank 62), each with its backward; (b)
    B 256 one-channel 32x128 images warped by ``grid_sample_affine`` to
    32x256 and to 16x64, and 3-channel ones sampled by ``bilinear_sample``
    at their own size, each with its backward: 2 K6 and 2 K7 (all
    ``"pipelined"``), 3 K11 and 3 K12 (all ``"cluster"``). The same run
    through the plain versions and the JAX goldens
    (``crnn_ocr_torch/testdata/surface_goldens.npz``) hold it
    (``surface_against``; the CTC gradient at ``CTC_GRAD_TOL``, JAX's at
    ``CTC_GRAD_JAX_TOL``, each with its reading, and the readings of two
    lower-precision controls, ``surface_ctc_control``); K11 and K12 alone
    on each warp's folded planes against their plain versions (up and down
    also at B 128, on 2 CTAs an image), with K12's plan (design, cluster,
    span), each kernel's and plain version's CUDA-event ms, and the bound
    of the warp's function beside that of the folded operands the kernels
    move; what the 3-channel fold costs beside K11 and K12
    (``surface_fold_cost``: device records and ms, traced); K6 and K7
    alone at blank 0 and the blank-0 loss forward's ms beside the
    blank-last one's. (c)
    ``build_model(cfg)`` of ``fonts-hard`` on the card, its weights
    through ``params_from_jax``: bf16 texts equal to
    ``load_pretrained("fonts-hard")``'s on the 64 golden lines, its
    forward 1 K1 (``"mma"``) and 2 K2 (resident). To run it alone:
    ``phase_build(card)`` then ``phase_surface(card)``.

Every counted run (phases 4, 8, 11, 13, 17, 20, 22, 23, 24, 25) requires
each recurrence launch to have run on the design ``PATH_DESIGN`` names for its
kernel (the resident design in either dtype), one design (cluster and rows)
for all of them, and each K1 launch on the design ``STEM_PATH_DESIGN``
names for the path: ``"mma"`` serving bf16 (the conv on the tensor cores),
``"conv9"`` serving f32 and in the training forward (K9 and K10 recompute
its z bit for bit); every counted training run (phases 8, 13, 17, 22) also
requires each K6 and K7 launch on the design ``CTC_PATH_DESIGN`` names,
and phase 13 each K12 launch on ``SAMPLER_PATH_DESIGN``.

The last lines are the card's ``name, power.limit``, the kernels' JSON
line (K1 and K2 with phase 4's launches, K3, K6 and K7 with phase 8's, K11
with phase 11's, K12 with phase 13's, K8-K10 with phase 17's, K4 with
phase 20's and K5 with phase 22's) and
``{"ok": true, "device": {...}}``. In the kernels' line ``ms`` is the
kernel's device time per call (``device_ms``: torch.profiler's kernel
durations) and ``event_ms`` the CUDA-event time of one call, which also
counts the card waiting on the host's launch; ``plain_ms`` and
``library_ms`` are CUDA-event times, ``library_device_ms`` the yardstick's
device time. K8-K10 compute sums over the batch: their rows add
``max_err_over_scale``, the error over the sum of the terms' magnitudes,
and K9's and K10's ``library_ms`` is null (no single PyTorch call computes
either), their ``pair_library_ms`` the plain stem's autograd backward,
which computes both; K8's, K9's and K10's rows add their ``design`` and
``ptxas`` (phase 15), K1's its ``design`` and ``ptxas`` (phase 2) and
``design_launches`` (phase 4's launches by design), K6's and K7's their
``design``, ``design_launches`` (phase 8's launches by design) and phase
6's ``plan``, ``us_per_frame``, ``block_ms``, ``block_equal``, ``ptxas``
and ``kernel_ms_old_host_path``; K1's adds ``train_call`` (phase 15's
training call at ``fonts-small``'s shape, with phase 17's launches and
its cuDNN yardstick); K11's adds ``kernel_ms_old_host_path`` and
``cold_ms`` and ``augment_launches`` (phase 28's fine-tune), K12's
phase 9's ``design``, ``plan``, ``ptxas``,
``image_ms``, ``cold_ms``, ``image_cold_ms``, ``image_equal`` and
``kernel_ms_old_host_path`` and phase 13's ``design_launches``; K6's,
K7's, K11's and K12's rows add ``surface``: phase 31's launches, and its
kernels' CUDA-event ms, plain ms and bound at its shapes (the warp's
function's, with ``kernel_bound_ms`` of the folded operands beside; K12's
with its plan per warp and the 3-channel fold's ``c3_fold``). The
recurrences' rows
add ``design``, ``cluster`` and
``rows`` as the counted run launched them, ``design_launches`` (that run's
launches on that design) and ``ms_per_step`` (``ms`` over the T steps),
``streamed_ms`` (the streamed design's device time on the same inputs),
``streamed_equal`` (its outputs equal to the path design's bit for bit)
and ``resources``. Every recurrence row adds ``f32_path_shape`` (its f32
check at its own path's shape, phases 2, 6 and 18) and an ``f32`` entry:
K2's and K3's phase 23's check at ``fonts-small``'s shape, with the
launches of phase 23's counted run and of phase 16's step; K4's and K5's
phase 18's f32 check, with the launches of phase 24's counted run and of
phase 21's step. The GRU backward's row
(``bigru_backward``, no Pallas kernel: JAX's ``lax.scan``) is phase 6's
bf16 check at train-hard's shape with phase 8's launches by design, and
its ``function_device_ms``, ``row_designs`` and f32 check. Every bound
names its peak (``bound_peak``): bf16 MMA, or f32 FMA on the CUDA cores,
and for every f32 recurrence (K2-K5, whatever design runs it) 3 x TF32 on
the tensor cores, the fastest pipe that multiplies at f32's accuracy (the
GRU backward's f32 products of a bf16 U: 2 x TF32, U's lo part being 0).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
# dense bf16 MMA; f32 FMA on the CUDA cores; f32 as 3xTF32 on the tensor
# cores (three TF32 products each, 495e12 dense)
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12, "tf32x3": 495e12 / 3,
            "tf32x2": 495e12 / 2}
PEAK_TEXT = {"bfloat16": "bf16 MMA 989e12",
             "float32": "f32 FMA (CUDA cores) 67e12",
             "tf32x3": "3 x TF32 MMA: 3 x ops over 495e12",
             "tf32x2": "2 x TF32 MMA (f32 products of a bf16 operand): "
                       "2 x ops over 495e12"}
BATCH, BUCKET = 256, 256
TRAIN_GOLDENS = os.path.join(REPO, "crnn_ocr_torch", "testdata",
                             "train_goldens.npz")
LSTM_GOLDENS = os.path.join(REPO, "crnn_ocr_torch", "testdata",
                            "lstm_goldens.npz")


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def time_ms(fn, warmup: int = 3, reps: int = 25) -> float:
    """Median of ``reps`` single-call CUDA-event timings, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, reps: int = 20) -> float:
    """Device time of one call of ``fn``: the summed durations of the work
    it puts on the card (kernels, copies), from torch.profiler over ``reps``
    calls after a warm-up call. A CUDA-event timing of one call
    (``time_ms``) also counts the card waiting for the host to launch it,
    which for a kernel of tens of microseconds is most of the reading.

    The profiler has handed back windows that under-read the work (on the
    H100, 20 launches of a kernel read at 0.42 and at 0.57 of their time,
    once each in two calls), and, from phase 9 of a run on, windows that
    lack one or two of their records (K11 19 of 20, K4 18 of 20, in every
    window). So each window runs ``EDGE`` marker kernels
    (``torch.cuda._sleep``) before and after the ``reps`` calls, to take
    such losses at its edges, and it counts only when each other name's
    records are a multiple of ``reps`` (a library may run a call's kernels
    on several streams, in no fixed order). The reading is the median of 3
    such windows; a window that does not count is run again, at most 3
    more times, and with none the phase fails. Fewer than 3 windows, or
    windows more than 10 % apart, are reported as a ``profiler_windows``
    line."""
    import torch

    fn()

    def run():
        for _ in range(EDGE):
            torch.cuda._sleep(1000)
        for _ in range(reps):
            fn()
        for _ in range(EDGE):
            torch.cuda._sleep(1000)

    readings, partial, counts = [], 0, {}
    for _ in range(6):
        prof, _ = profiled(run)
        recs = device_work(prof)
        counts = collections.Counter(e.name for e in recs)
        work = [e for e in recs if "spin_kernel" not in e.name]
        if not work or any(n % reps for k, n in counts.items()
                           if "spin_kernel" not in k):
            partial += 1
            continue
        readings.append(sum(e.time_range.end - e.time_range.start
                            for e in work) / reps / 1e3)
        if len(readings) == 3:
            break
    if len(readings) < 3 or max(readings) > 1.1 * min(readings):
        emit("profiler_windows", ms=readings, partial_windows=partial)
    require(bool(readings), f"the profiler gave {partial} windows and none "
                            f"counted (last: {dict(counts)})")
    return statistics.median(readings)


EDGE = 4  # marker kernels on each side of device_ms's measured calls
FLUSH_BYTES = 128 << 20  # written before a launch to evict the 50 MB L2
_flush: list = []


def kernel_device_ms(fn, name: str, cold: bool = False,
                     reps: int = 20) -> float:
    """The device ms of one launch of the kernel whose name holds ``name``
    in a call of ``fn``: the mean over a torch.profiler window's records of
    that kernel (so a record the profiler drops does not skew it), median
    of three windows of ``reps`` calls after a warm-up call. With ``cold``
    a 128 MB buffer is written before each call, which evicts the inputs
    from the L2 (the kernel then reads them from device memory); the
    write's own kernel is not counted."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if cold and not _flush:
        _flush.append(torch.empty(FLUSH_BYTES // 4, dtype=torch.float32,
                                  device="cuda"))
    fn()
    out, empty = [], 0
    while len(out) < 3:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(reps):
                if cold:
                    _flush[0].fill_(i)
                fn()
            torch.cuda.synchronize()
        recs = [e.time_range.end - e.time_range.start for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and name in e.name]
        if recs:
            out.append(sum(recs) / len(recs) / 1e3)
        else:
            empty += 1
            require(empty < 6, f"the profiler saw no {name} kernel in 6 "
                               "windows")
    return statistics.median(out)


def profiled(run):
    """torch.profiler (host and card) over ``run()``, synchronized at both
    ends: (the profile, the window's wall time in µs). The profiler at times
    hands back a window with no device records at all (once in ~20 windows
    of one call on the H100; three in a row once, in phase 9 of another);
    such a window is run again after a pause, at most 7 times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(8):
        if attempt:
            time.sleep(0.2)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        if device_work(prof):
            return prof, wall_us
    raise RuntimeError("the profiler saw no work on the device in 8 windows")


def is_range_row(name: str, ranges) -> bool:
    """Whether a device-timeline record named ``name`` is a record_function
    range's and not a kernel's or a copy's. A range leaves a record of its
    own name there, from its first kernel's start to its last kernel's end,
    the gaps between them included: the port's ``crnn.*`` spans, the
    ``RANGES``, and any name in ``ranges`` (the host's user ranges)."""
    return name in ranges or name in RANGES or name.startswith("crnn.")


def device_work(prof) -> list:
    """The kernels and copies on the card in ``prof``'s window, without the
    rows that ranges leave on the device's timeline (``is_range_row``)."""
    import torch

    events = list(prof.events())
    ranges = {e.name for e in events if getattr(e, "is_user_annotation", False)}
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not is_range_row(e.name, ranges)]


def bound_ms(bytes_moved: float, ops: float, dtype: str):
    """The least time for the work: max(bytes over the HBM rate, operations
    over ``PEAK_OPS[dtype]``) in ms, and which of the two it is."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                      else "operations")


def rnn_bound(bytes_moved: float, ops: float, dtype_name: str):
    """A recurrence's bound (K2-K5), as :func:`bound_ms`, and its peak's
    text: in f32 the products can run as 3xTF32 on the tensor cores,
    whatever design runs them, so their peak is 495e12 / 3, not the CUDA
    cores' 67e12."""
    peak = "tf32x3" if dtype_name == "float32" else dtype_name
    return (*bound_ms(bytes_moved, ops, peak), PEAK_TEXT[peak])


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


@contextlib.contextmanager
def plain_kernels(stem: bool = True):
    """Run every kernel call site (K1-K12) through its plain version, on
    the card, for the comparison runs of phases 3, 7, 10, 12, 16, 19 and
    21, the GRU's backward kernel through its plain loop: the autograd
    Functions, the LSTM's backward and the CTC gradient assembly stay as
    they are. ``stem=False`` leaves the stem's kernels (K1, K8-K10) in
    place."""
    import torch
    import crnn_ocr_torch.models.crnn as crnn_mod
    from crnn_ocr_torch.kernels import bigru, ctc_loss, fused_stem
    from crnn_ocr_torch.kernels import fused_stem_train as fst
    from crnn_ocr_torch.kernels import grid_sample as gs

    def gru_train(xw, u, rec_bias, u_kernel=None):
        with torch.no_grad():
            return bigru.bigru_train_plain(xw, u, rec_bias)

    def lstm_train(xw, u, u_kernel=None):
        with torch.no_grad():
            return bigru.bilstm_train_plain(xw, u)

    stem_sites = [(crnn_mod, "fused_stem_serve", fused_stem.fused_stem_plain),
                  (fused_stem, "_forward",
                   lambda img, w, s, b, design: fused_stem.fused_stem_plain(
                       img, w, s, b)),
                  (fst, "stem_stats", fst.stem_stats_plain),
                  (fst, "stem_bwd_partials", fst.stem_bwd_partials_plain),
                  (fst, "stem_bwd_final", fst.stem_bwd_final_plain)]
    sites = [(bigru, "bigru_infer",
              lambda xw, u, rb, u_kernel=None: bigru.bigru_plain(xw, u, rb)),
             (bigru, "bigru_train", gru_train),
             (bigru, "bilstm_infer",
              lambda xw, u, u_kernel=None: bigru.bilstm_plain(xw, u)),
             (bigru, "bilstm_train", lstm_train),
             (bigru, "bigru_backward", bigru.bigru_backward_plain),
             (ctc_loss, "ctc_alphas", ctc_loss.ctc_alphas_plain),
             (ctc_loss, "ctc_betas", ctc_loss.ctc_betas_plain),
             (gs, "sample_pix", gs.sample_pix_plain),
             (gs, "sample_pix_bwd", gs.sample_pix_bwd_plain)]
    if stem:
        sites += stem_sites
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in sites]
    for mod, name, fn in sites:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def reset_launches() -> None:
    from crnn_ocr_torch.kernels import bigru, ctc_loss, fused_stem
    from crnn_ocr_torch.kernels import fused_stem_train as fst
    from crnn_ocr_torch.kernels import grid_sample as gs

    bigru.launches = bigru.train_launches = bigru.backward_launches = 0
    bigru.backward_design_launches.clear()
    fused_stem.design_launches.clear()
    bigru.lstm_launches = bigru.lstm_train_launches = 0
    bigru.design_launches.clear()
    ctc_loss.alpha_launches = ctc_loss.beta_launches = 0
    ctc_loss.design_launches.clear()
    gs.launches = gs.bwd_launches = 0
    gs.design_launches.clear()
    fst.stats_launches = fst.partials_launches = fst.final_launches = 0


def read_launches() -> dict:
    from crnn_ocr_torch.kernels import bigru, ctc_loss, fused_stem
    from crnn_ocr_torch.kernels import fused_stem_train as fst
    from crnn_ocr_torch.kernels import grid_sample as gs

    return {"fused_stem": fused_stem.launches, "bigru": bigru.launches,
            "bigru_train": bigru.train_launches,
            "bigru_backward": bigru.backward_launches,
            "bilstm": bigru.lstm_launches,
            "bilstm_train": bigru.lstm_train_launches,
            "ctc_alpha": ctc_loss.alpha_launches,
            "ctc_beta": ctc_loss.beta_launches,
            "grid_sample": gs.launches, "grid_sample_bwd": gs.bwd_launches,
            "stem_stats": fst.stats_launches,
            "stem_bwd_partials": fst.partials_launches,
            "stem_bwd_final": fst.final_launches}


def require_launches(counts: dict, want: dict, what: str) -> None:
    """Every kernel's count equal to ``want``'s (0 where it has none)."""
    bad = {k: v for k, v in counts.items() if v != want.get(k, 0)}
    require(not bad, f"{what} launched {counts}; expected {want}")


# the design each recurrence kernel runs on the counted paths (bf16, 256
# units, or 128 for fonts-small's K3), and on the f32 paths (fonts-small
# served as shipped, phase 23; its f32 train step, phase 16;
# fonts-hard-lstm served in f32, phase 24; its f32 train step, phase 21)
PATH_DESIGN = {"bigru": "resident", "bilstm_train": "resident",
               "bigru_train": "resident", "bilstm": "resident"}


def read_design(counts: dict, what: str):
    """The counted run's recurrence launches per design (``bigru.
    design_launches``, set to 0 by ``reset_launches``): all of them on one
    design, the one ``PATH_DESIGN`` names for the run's recurrence kernel.
    Returns ``(design, launches)``."""
    from crnn_ocr_torch.kernels import bigru

    ran = {d: n for d, n in bigru.design_launches.items() if n}
    kernels = [k for k in PATH_DESIGN if counts[k]]
    require(len(kernels) == 1 and len(ran) == 1,
            f"{what}: recurrence launches {kernels} on designs {ran}")
    (d, n), = ran.items()
    want = PATH_DESIGN[kernels[0]]
    require(d.name == want and n == counts[kernels[0]],
            f"{what}: {kernels[0]} launched {counts[kernels[0]]} times, "
            f"{n} on {d}; expected all on the {want} design")
    return d, n


def design_fields(design, n: int) -> dict:
    return dict(design=design.name, cluster=design.cluster, rows=design.rows,
                design_launches=n)


# the design of the GRU's backward in every counted GRU training run
BWD_PATH_DESIGN = "resident"


def read_backward_design(counts: dict, what: str) -> dict:
    """The counted run's GRU backward launches per design (``bigru.
    backward_design_launches``, set to 0 by ``reset_launches``): every one
    on ``BWD_PATH_DESIGN``, as many as ``counts["bigru_backward"]``.
    Returns ``{"name C R": n}``."""
    from crnn_ocr_torch.kernels import bigru

    ran = {d: n for d, n in bigru.backward_design_launches.items() if n}
    n = counts["bigru_backward"]
    require(sum(ran.values()) == n and all(
        d.name == BWD_PATH_DESIGN for d in ran),
        f"{what}: the GRU backward launched {n} times, by design {ran}; "
        f"expected all on {BWD_PATH_DESIGN}")
    return {f"{d.name} C{d.cluster} R{d.rows}": k for d, k in ran.items()}


# the design K6 and K7 run on in the counted training runs (ctc_loss.plan's
# at every shape it covers)
CTC_PATH_DESIGN = {"ctc_alpha": "pipelined", "ctc_beta": "pipelined"}


def read_ctc_design(counts: dict, what: str) -> dict:
    """The counted run's K6 and K7 launches per design (``ctc_loss.
    design_launches``, set to 0 by ``reset_launches``): every one on the
    design ``CTC_PATH_DESIGN`` names. Returns ``{kernel: {design: n}}``."""
    from crnn_ocr_torch.kernels import ctc_loss

    ran = {k: {d: n for (kk, d), n in ctc_loss.design_launches.items()
               if f"ctc_{kk}" == k and n} for k in CTC_PATH_DESIGN}
    want = {k: ({d: counts[k]} if counts[k] else {})
            for k, d in CTC_PATH_DESIGN.items()}
    require(ran == want, f"{what}: K6/K7 launched {ran} by design; expected "
                         f"{want}")
    return ran


# the design K12 runs on in the counted training runs (grid_sample.plan's
# at every shape it covers)
SAMPLER_PATH_DESIGN = "cluster"


def read_sampler_design(counts: dict, what: str) -> dict:
    """The counted run's K12 launches per design (``grid_sample.
    design_launches``, set to 0 by ``reset_launches``): every one on
    ``SAMPLER_PATH_DESIGN``. Returns them."""
    from crnn_ocr_torch.kernels import grid_sample as gs

    ran = {d: n for d, n in gs.design_launches.items() if n}
    n = counts["grid_sample_bwd"]
    want = {SAMPLER_PATH_DESIGN: n} if n else {}
    require(ran == want, f"{what}: K12 launched {ran} by design; expected "
                         f"{want}")
    return ran


# the design K1 runs on in the counted runs: bf16 serving on the tensor
# cores, f32 serving and the training forward on conv9 (K9 and K10
# recompute its z)
STEM_PATH_DESIGN = {"serve": "mma", "serve_f32": "conv9", "train": "conv9"}


def read_stem_design(counts: dict, path: str, what: str) -> dict:
    """The counted run's K1 launches per design (``fused_stem.
    design_launches``, set to 0 by ``reset_launches``): every one on the
    design ``STEM_PATH_DESIGN`` names for the path. Returns them."""
    from crnn_ocr_torch.kernels import fused_stem

    ran = {d: n for d, n in fused_stem.design_launches.items() if n}
    n = counts["fused_stem"]
    want = {STEM_PATH_DESIGN[path]: n} if n else {}
    require(ran == want, f"{what}: K1 launched {ran} by design; expected "
                         f"{want}")
    return ran


def golden_lines(g, key: str):
    c, hs, ws = g[f"{key}_canvas"], g[f"{key}_heights"], g[f"{key}_widths"]
    return [c[i, :h, :w] for i, (h, w) in enumerate(zip(hs, ws))]


RESIDENT_PTXAS: dict = {}  # phase 1's report per resident instance
STEM_BWD_PTXAS: dict = {}  # and per K9/K10 instance
STEM_FWD_PTXAS: dict = {}  # and per K1/K8 instance
CTC_PTXAS: dict = {}  # and per K6/K7 instance
SAMPLER_PTXAS: dict = {}  # and per K11/K12 instance
K1_TRAIN: dict = {}  # phase 15's K1 training-call rows by (dtype, path)


def ptxas_instances(report: str, key_of) -> dict:
    """ptxas's registers, stack, spills and static shared memory per kernel
    instance of ``nvcc -Xptxas -v``'s report, keyed by ``key_of(mangled
    entry name)`` (entries it maps to None are left out)."""
    import re

    out, cur = {}, None
    for ln in report.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", ln)
        if entry:
            cur = key_of(entry.group(1))
            if cur:
                out[cur] = {}
            continue
        if cur is None:
            continue
        for key, pat in (("registers", r"Used (\d+) registers"),
                         ("stack_bytes", r"(\d+) bytes stack frame"),
                         ("spill_store_bytes", r"(\d+) bytes spill stores"),
                         ("spill_load_bytes", r"(\d+) bytes spill loads"),
                         ("static_smem_bytes", r"(\d+) bytes smem")):
            m = re.search(pat, ln)
            if m:
                out[cur][key] = int(m.group(1))
    return out


def resident_ptxas(report: str) -> dict:
    """ptxas's report per instance of ``birnn_resident_kernel``, keyed by
    its wrapper's kernel and rows (:func:`ptxas_key`), from ``bigru.cu``'s
    build."""
    import re

    def key_of(name):
        k = re.search(r"birnn_resident_kernelI\S*?(Gru|Lstm)CellELi(\d+)"
                      r"ELb([01])E(?:NS_\d+(Res\w+?)E)?(?:Li(\d+)E)?", name)
        if not k:
            return None
        return ptxas_key(k.group(1).lower(), k.group(3) == "1",
                         int(k.group(2)),
                         "float32" if k.group(4) == "ResTf32" else "bfloat16",
                         int(k.group(5) or 64))

    return ptxas_instances(report, key_of)


def stem_bwd_ptxas(report: str) -> dict:
    """ptxas's report per instance of ``bwd_tile_kernel`` (K9 and K10, bf16
    and f32), keyed ``"stem_bwd_partials bfloat16"`` and so on, from
    ``fused_stem.cu``'s build."""
    import re

    def key_of(name):
        k = re.search(r"bwd_tile_kernelI(13__nv_bfloat16|f)Lb([01])E", name)
        if not k:
            return None
        kernel = "stem_bwd_final" if k.group(2) == "1" else "stem_bwd_partials"
        return f"{kernel} {'float32' if k.group(1) == 'f' else 'bfloat16'}"

    return ptxas_instances(report, key_of)


def stem_fwd_ptxas(report: str) -> dict:
    """ptxas's report per instance of K1's and K8's kernels, keyed by
    wrapper, dtype and, for K1, design: ``"fused_stem bfloat16 mma"``
    (``stem_mma_kernel``'s serving instance), ``"fused_stem float32
    conv9"`` (``stem_kernel``), ``"stem_stats bfloat16"`` (K8), and so on,
    from ``fused_stem.cu``'s build."""
    import re

    def key_of(name):
        dt = lambda k: "float32" if k == "f" else "bfloat16"  # noqa: E731
        k = re.search(r"stem_mma_kernelI(13__nv_bfloat16|f)Lb([01])E", name)
        if k:
            return (f"stem_stats {dt(k.group(1))}" if k.group(2) == "1"
                    else f"fused_stem {dt(k.group(1))} mma")
        k = re.search(r"stem_kernelI(13__nv_bfloat16|f)E", name)
        return f"fused_stem {dt(k.group(1))} conv9" if k else None

    return ptxas_instances(report, key_of)


def ptxas_key(cell: str, stash: bool, rows: int,
              dtype_name: str = "bfloat16", units: int = 64) -> str:
    """``"bigru R8"``, ``"bilstm_train R32"``, ``"bigru float32 R8"``,
    ``"bilstm float32 R16 U32"``: the kernel a resident instance serves
    (K2-K5 by cell and stash), its dtype when not bf16 (the f32 instances'
    operand policy is ``ResTf32``), its rows, and its tile when not 64
    units (the f32 LSTM's 32-unit tile, the kernel's last template
    argument)."""
    tag = "" if dtype_name == "bfloat16" else f" {dtype_name}"
    tile = "" if units == 64 else f" U{units}"
    return f"bi{cell}{'_train' if stash else ''}{tag} R{rows}{tile}"


def ctc_ptxas_key(name: str, plan) -> str:
    """``"ctc_alpha pipelined"``, ``"ctc_beta block"``: the kernel (K6
    alpha, K7 beta) and its design."""
    return f"ctc_{name} {plan.design}"


def ctc_ptxas(report: str) -> dict:
    """ptxas's report per kernel of ``ctc_loss.cu``, keyed by
    :func:`ctc_ptxas_key`."""
    import re

    def key_of(name):
        k = re.search(r"ctc_(alpha|beta)_(pipelined_)?kernel", name)
        if not k:
            return None
        return f"ctc_{k.group(1)} {'pipelined' if k.group(2) else 'block'}"

    return ptxas_instances(report, key_of)


def sampler_ptxas_key(plan, dtype_name: str) -> str:
    """``"grid_sample_bwd cluster bfloat16 tile staged"``,
    ``"grid_sample_bwd image float32"``: K12's kernel instance for a plan
    (its design, the image's dtype, and on the cluster designs the
    accumulator, a whole ``tile`` or a ``slice``, and whether the image is
    ``staged`` in shared memory or read through ``L1``)."""
    if plan.design == "image":
        return f"grid_sample_bwd image {dtype_name}"
    return (f"grid_sample_bwd cluster {dtype_name} "
            f"{'tile' if plan.tile else 'slice'} "
            f"{'staged' if plan.staged else 'L1'}")


def sampler_ptxas(report: str) -> dict:
    """ptxas's report per kernel instance of ``grid_sample.cu``: K11 as
    ``"grid_sample bfloat16"``, K12 by :func:`sampler_ptxas_key`."""
    import re

    def key_of(name):
        dt = lambda k: "float32" if k == "f" else "bfloat16"  # noqa: E731
        k = re.search(r"sample_bwd_clusterI(13__nv_bfloat16|f)Lb([01])ELb"
                      r"([01])E", name)
        if k:
            return (f"grid_sample_bwd cluster {dt(k.group(1))} "
                    f"{'tile' if k.group(3) == '1' else 'slice'} "
                    f"{'staged' if k.group(2) == '1' else 'L1'}")
        k = re.search(r"sample_bwd_imageI(13__nv_bfloat16|f)E", name)
        if k:
            return f"grid_sample_bwd image {dt(k.group(1))}"
        k = re.search(r"sample_fwdI(13__nv_bfloat16|f)E", name)
        return f"grid_sample {dt(k.group(1))}" if k else None

    return ptxas_instances(report, key_of)


def ctc_close(got, want):
    """K6's or K7's output against its plain version: (max error where a
    path exists, whether it is within 1e-4 + 1e-5 * |plain| there and
    exactly NEG where the plain version is NEG). f32 log-sum-exps in
    another order and precision (the MUFU's ex2/lg2 in log2 units, or
    CUDA's expf/logf for ``"block"``, against PyTorch's), over up to T
    dependent frames."""
    from crnn_ocr_torch.kernels import ctc_loss as cl

    live = want > cl.NEG / 2
    err, ok = (_close(got[live], want[live], 1e-4, 1e-5) if bool(live.any())
               else (0.0, True))
    return err, ok and bool((got[~live] == want[~live]).all())


def phase_build(card: str):
    import torch
    from crnn_ocr_torch.kernels import _build

    emit("card", nvidia_smi=card, torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         python=sys.version.split()[0])
    t0 = time.perf_counter()
    built = _build.build_all()
    secs = time.perf_counter() - t0
    ptxas = {
        name: [ln.strip() for ln in rep.splitlines()
               if "registers" in ln or "spill" in ln]
        for name, rep in _build.ptxas_reports.items()
    }
    RESIDENT_PTXAS.update(resident_ptxas(_build.ptxas_reports.get("bigru",
                                                                  "")))
    STEM_BWD_PTXAS.update(stem_bwd_ptxas(_build.ptxas_reports.get(
        "fused_stem", "")))
    STEM_FWD_PTXAS.update(stem_fwd_ptxas(_build.ptxas_reports.get(
        "fused_stem", "")))
    CTC_PTXAS.update(ctc_ptxas(_build.ptxas_reports.get("ctc_loss", "")))
    SAMPLER_PTXAS.update(sampler_ptxas(_build.ptxas_report("grid_sample")))
    require("fused_stem" not in built or len(STEM_BWD_PTXAS) == 4,
            f"ptxas reported {sorted(STEM_BWD_PTXAS)} of K9's and K10's 4 "
            f"instances")
    require("fused_stem" not in built or len(STEM_FWD_PTXAS) == 5,
            f"ptxas reported {sorted(STEM_FWD_PTXAS)} of K1's and K8's 5 "
            f"instances")
    emit("build", seconds=round(secs, 3), built=built, ptxas=ptxas,
         resident_ptxas=RESIDENT_PTXAS, stem_bwd_ptxas=STEM_BWD_PTXAS,
         stem_fwd_ptxas=STEM_FWD_PTXAS, ctc_ptxas=CTC_PTXAS,
         sampler_ptxas=SAMPLER_PTXAS)


def resident_resources(cell: str, stash: bool, H: int, design,
                       dtype_name: str = "bfloat16") -> dict:
    """A resident instance's resources on this card, launching nothing:
    its dynamic shared memory, the most clusters the card holds at once,
    its registers and local memory per thread (the runtime's view; phase 1
    has ptxas's)."""
    import ctypes

    import torch
    from crnn_ocr_torch.kernels import _build
    from crnn_ocr_torch.kernels import bigru as bg

    lib = _build.load("bigru")
    fn = lib.crnn_birnn_resident_info
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
    info = (ctypes.c_int * 4)()
    elem = 2 if dtype_name == "bfloat16" else 4  # picks the instance
    _build.check(lib, fn(int(cell == "lstm"), elem, int(stash), H,
                         design.cluster, design.rows,
                         ctypes.addressof(info)),
                 "resident info")
    return dict(smem_bytes=info[0], max_active_clusters=info[1],
                runtime_registers=info[2], local_bytes=info[3],
                ptxas=RESIDENT_PTXAS.get(ptxas_key(
                    cell, stash, design.rows, dtype_name, bg.resident_tile(
                        cell, H, getattr(torch, dtype_name))[0])))


def design_times(cell: str, xw, u, rb, uk, stash: bool, plain) -> dict:
    """Phases 2, 6, 18 and 23: the design the path's shape selects and, for
    a resident one, the device time of a yardstick design on the same
    inputs (launched here and nowhere on the path, like ``library_ms``):
    for bf16 the streamed design (the design of bf16 shapes above 256
    units), its hs held to the plain version's at 2e-2 and compared with
    the resident design's bit for bit (``streamed_*``); for f32 the old
    ``"f32"`` design (U read from L2 by the CUDA cores), its hs held to the
    plain version's at 1e-4 (``old_f32_*``); and the resident instance's
    resources."""
    import torch
    from crnn_ocr_torch.kernels import bigru as bg

    T, _, B, G = xw.shape
    H = G // bg.GATES[cell]
    d = bg.design_for(cell, stash, H, B, xw.dtype)
    out = dict(design=d.name, cluster=d.cluster, rows=d.rows)
    if d.name != "resident":
        return out
    bf16 = xw.dtype == torch.bfloat16
    key, tol, yard = (("streamed", 2e-2, bg.Design("streamed", 0, 16)) if bf16
                      else ("old_f32", 1e-4, bg.Design("f32")))

    def yardstick():  # the f32 design builds its own operand, U itself
        return bg._launch(cell, xw, u, rb, uk if key == "streamed" else None,
                          stash, yard)

    theirs, ours = yardstick(), bg._launch(cell, xw, u, rb, uk, stash, d)
    err = float((theirs[0].float() - plain.float()).abs().max())
    require(err <= tol, f"{cell} {yard.name} design: hs error {err}")
    out[f"{key}_max_abs_err"] = err
    if key == "streamed":
        out["streamed_equal"] = all(torch.equal(a, b) for a, b in
                                    zip(ours, theirs) if a is not None)
    out[f"{key}_ms"] = device_ms(yardstick)
    hp = bg._padded_units(H, xw.dtype)
    res = resident_resources(cell, stash, hp, d, str(xw.dtype)[6:])
    # one wave: the grid within the CTAs the card holds at once
    res["ctas"] = -(-B // d.rows) * 2 * d.cluster
    res["wave_ctas"] = res["max_active_clusters"] * d.cluster
    res["one_wave"] = res["ctas"] <= res["wave_ctas"]
    # every bf16 grid must fit; an f32 grid may take two waves only where
    # no instance's measured capacity (bigru.WAVE_CTAS) holds it in one (f32
    # at 256 units holds one CTA an SM: B 256 takes two waves on any rows)
    fits_one = any(
        -(-B // r) * 2 * d.cluster
        <= bg.WAVE_CTAS.get((xw.dtype, cell, stash, hp, r), 0)
        for r in bg.resident_rows(xw.dtype, cell))
    require(res["one_wave"] or not (bf16 or fits_one),
            f"{cell} {d}: {res['ctas']} CTAs, the card holds "
            f"{res['wave_ctas']} at once")
    out["resources"] = res
    return out


def stem_design_fields(img, C: int, design: str) -> dict:
    """K1's design and, for ``"mma"`` and K8's ``"stats"``, its launch's
    plan (``_stem_tiles.stem_plan``)."""
    from crnn_ocr_torch.kernels import _stem_tiles as tiles

    if design == "conv9":
        return dict(name=design)
    return dict(name=design, **dataclasses.asdict(
        tiles.stem_design(img, C, design == "stats")))


def stem_tolerance(want, bf16: bool):
    """K1's tolerance against its plain version's output ``want`` (f32):
    (per-element bound, its text)."""
    import torch

    if bf16:
        # one bf16 ulp of the output (ulp(x) <= |x| * 2^-7), plus 1e-6 for
        # values that the f32 sums' order puts on either side of the ReLU
        return (want.abs() * 2.0 ** -7 + 1e-6,
                "1 bf16 ulp of the output (+1e-6)")
    return torch.full_like(want, 1e-5), "1e-5 abs"


def check_stem(model, x_img, dtype_name: str):
    """K1 on the main path's stem input and the model's stem weights."""
    import torch
    from crnn_ocr_torch.kernels import fused_stem as fs

    bf16 = dtype_name == "bfloat16"
    dt = torch.bfloat16 if bf16 else torch.float32
    img = x_img.to(dt)[..., None].contiguous()
    bn = model.stem_bn
    scale, bias = fs.fold_bn(bn.weight, bn.bias, bn.running_mean,
                             bn.running_var, 1e-3)
    w = model.stem_conv.weight.permute(2, 3, 1, 0).contiguous()
    design = "mma" if bf16 else "conv9"
    before = dict(fs.design_launches)
    got = fs.fused_stem_serve(img, w, scale, bias)
    want = fs.fused_stem_plain(img, w, scale, bias)
    torch.cuda.synchronize()
    require(fs.design_launches - collections.Counter(before) == {design: 1},
            f"fused_stem {dtype_name}: not launched on the {design} design")
    g, p = got.float(), want.float()
    err = (g - p).abs()
    tol, tol_text = stem_tolerance(p, bf16)
    ok = bool((err <= tol).all())
    B, H, W, _ = img.shape
    C = w.shape[-1]
    bytes_moved = nbytes(img, got) + 11 * C * 4
    ops = 2 * 9 * B * H * W * C + 3 * B * H * W * C
    b_ms, b_by = bound_ms(bytes_moved, ops, dtype_name)
    x_nchw = img.permute(0, 3, 1, 2)
    w_nchw = w.permute(3, 2, 0, 1).to(dt)
    s4, b4 = scale.to(dt)[:, None, None], bias.to(dt)[:, None, None]

    def library():
        z = torch.nn.functional.conv2d(x_nchw, w_nchw, padding=1)
        return torch.nn.functional.max_pool2d(torch.relu(z * s4 + b4), 2)

    res = dict(
        kernel="fused_stem", dtype=dtype_name, shape=list(img.shape), C=C,
        max_abs_err=float(err.max()), tolerance=tol_text, ok=ok,
        kernel_ms=time_ms(lambda: fs.fused_stem_serve(img, w, scale, bias)),
        kernel_device_ms=device_ms(
            lambda: fs.fused_stem_serve(img, w, scale, bias)),
        plain_ms=time_ms(lambda: fs.fused_stem_plain(img, w, scale, bias)),
        library_ms=time_ms(library), library_device_ms=device_ms(library),
        library="cudnn conv2d + affine + relu + max_pool2d",
        bound_ms=b_ms, bound_by=b_by, bytes=bytes_moved, ops=ops,
        design=stem_design_fields(img, C, design),
        ptxas=STEM_FWD_PTXAS.get(f"fused_stem {dtype_name} {design}"),
    )
    emit("kernel_check", **res)
    require(ok, f"fused_stem {dtype_name}: max error {res['max_abs_err']} "
                f"beyond {tol_text}")
    return res


def torch_gru_from(rnn, dtype):
    """torch.nn.GRU (bidirectional, batch_first) with a BiRNN's weights,
    gates reordered from Keras z|r|h to PyTorch r|z|n."""
    import torch

    H = rnn.units
    F = rnn.kernel.shape[1]
    order = torch.cat([torch.arange(H, 2 * H), torch.arange(0, H),
                       torch.arange(2 * H, 3 * H)]).to(rnn.kernel.device)
    # made on the card in its dtype, so cuDNN lays the weights out in one
    # block once; copy_ writes into that block
    gru = torch.nn.GRU(F, H, batch_first=True, bidirectional=True,
                       device=rnn.kernel.device, dtype=dtype)
    with torch.no_grad():
        for d, sfx in ((0, "l0"), (1, "l0_reverse")):
            getattr(gru, f"weight_ih_{sfx}").copy_(rnn.kernel[d].T[order])
            getattr(gru, f"weight_hh_{sfx}").copy_(
                rnn.recurrent_kernel[d].T[order])
            getattr(gru, f"bias_ih_{sfx}").copy_(rnn.bias[d, 0][order])
            getattr(gru, f"bias_hh_{sfx}").copy_(rnn.bias[d, 1][order])
    return gru.eval()


def check_bigru(model, feat, dtype_name: str):
    """K2 on layer 0's input projections of a serving path (fonts-hard;
    fonts-small in phase 23)."""
    import torch
    from crnn_ocr_torch.kernels import bigru as bg

    rnn = model.birnn0
    dt = rnn.dtype
    xw = rnn.project(feat)
    u = rnn.recurrent_kernel.to(dt).contiguous()
    rb = rnn.bias[:, 1].contiguous()
    uk = rnn.u_kernel  # as the main path passes it

    def kernel():
        return bg.bigru(xw, u, rb, uk)

    got = kernel()
    want = bg.bigru_plain(xw, u, rb)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    tol = 2e-2 if dtype_name == "bfloat16" else 1e-4
    T, _, B, G = xw.shape
    H = G // 3
    bytes_moved = nbytes(xw, u, rb, got)
    ops = 2 * T * 2 * B * H * G + 12 * T * 2 * B * H
    designs = design_times("gru", xw, u, rb, uk, False, want)
    b_ms, b_by, peak_text = rnn_bound(bytes_moved, ops, dtype_name)
    res = dict(
        kernel="bigru", dtype=dtype_name, T=T, B=B, H=H, max_abs_err=err,
        tolerance=f"{tol} abs", ok=err <= tol,
        kernel_ms=time_ms(kernel), kernel_device_ms=device_ms(kernel),
        plain_ms=time_ms(lambda: bg.bigru_plain(xw, u, rb)),
        bound_ms=b_ms, bound_by=b_by, bound_peak=peak_text,
        bytes=bytes_moved, ops=ops,
        library="torch.nn.GRU bidirectional (cuDNN) on the layer input; "
                "its time includes the input projection",
        **designs,
    )
    # yardstick only: the port never calls torch.nn.GRU
    gru = torch_gru_from(rnn, dt)
    res["library_vs_port_max_abs"] = float(
        (gru(feat)[0].float() - rnn(feat).float()).abs().max())
    res["library_ms"] = time_ms(lambda: gru(feat))
    res["library_device_ms"] = device_ms(lambda: gru(feat))
    emit("kernel_check", **res)
    require(res["ok"], f"bigru {dtype_name}: max error {err} beyond {tol}")
    return res


def predict_golden(name, g, key, dtype=None):
    from crnn_ocr_torch import load_pretrained

    pred = load_pretrained(name, device="cuda", dtype=dtype)
    out = pred.predict(golden_lines(g, key))
    return [o.text for o in out], [o.score for o in out]


def phase_goldens(g, f32_models, bf16_model, bf16_max_off: int = 1):
    """Golden texts on the card: each ``(name, key)`` of ``f32_models`` in
    f32 against the JAX predictor's texts and scores in ``g``, and
    ``bf16_model`` as shipped (bf16) against the JAX bf16 golden (at most
    ``bf16_max_off`` lines off) and against the plain versions' run on the
    card."""
    import numpy as np

    results = {}
    # f32: every text equal, scores within rtol 1e-4 (atol 1e-5: a score is
    # a sum of ~60 log-probs, and near-certain lines score near 0)
    for name, key in f32_models:
        texts, scores = predict_golden(name, g, key, "float32")
        want_t = [str(t) for t in g[f"{key}_texts_f32"]]
        want_s = g[f"{key}_scores_f32"]
        bad = [(i, a, b) for i, (a, b) in enumerate(zip(texts, want_t))
               if a != b]
        rel = np.abs(np.array(scores) - want_s) / (np.abs(want_s) + 1e-30)
        score_ok = bool(np.allclose(scores, want_s, rtol=1e-4, atol=1e-5))
        results[f"{name}_f32"] = dict(lines=len(texts), text_mismatches=bad,
                                      max_score_rel_err=float(rel.max()),
                                      scores_ok=score_ok)
        emit("goldens", run=f"{name} float32", lines=len(texts),
             text_mismatches=bad, max_score_rel_err=float(rel.max()),
             scores_ok=score_ok)
        require(not bad and score_ok,
                f"{name} f32 differs from the JAX golden")
    # bf16 as shipped: at most bf16_max_off of 64 lines off the JAX bf16
    # golden, and the kernel run's texts equal the plain-version run's on
    # the card
    name, key = bf16_model
    texts, scores = predict_golden(name, g, key)
    want_t = [str(t) for t in g[f"{key}_texts_bf16"]]
    bad = [(i, a, b) for i, (a, b) in enumerate(zip(texts, want_t)) if a != b]
    with plain_kernels():
        plain_texts, _ = predict_golden(name, g, key)
    plain_bad = [(i, a, b) for i, (a, b) in enumerate(zip(texts, plain_texts))
                 if a != b]
    truth = [str(t) for t in g[f"{key}_truth"]]
    emit("goldens", run=f"{name} bfloat16", lines=len(texts),
         text_mismatches=bad, kernel_vs_plain_mismatches=plain_bad,
         line_accuracy_vs_truth=float(np.mean(
             [a == b for a, b in zip(texts, truth)])))
    require(len(bad) <= bf16_max_off,
            f"{name} bf16: {len(bad)} lines differ from the JAX bf16 golden "
            f"(at most {bf16_max_off} may)")
    require(not plain_bad, f"{name} bf16: kernel texts differ from the "
                           "plain versions' on the card")
    return results


def phase_throughput(card: str, name: str, lines, want: dict,
                     bucket: int = BUCKET, path: str = "serve",
                     dtype: str = None, decode_kw: dict = None,
                     reps: int = 20, stage_reps: int = 13,
                     trace_n: int = 5):
    """The main path, counted: ``REPS`` timed ``predict`` calls of ``name``
    (as shipped, or in ``dtype``) on ``lines`` at ``bucket`` with the
    launch counts set to 0 just before them and read just after; ``want``:
    each kernel's launches per call; ``path``: ``"serve"`` (bf16: K1 on
    ``"mma"``, the recurrences on ``PATH_DESIGN``'s designs) or
    ``"serve_f32"`` (K1 on ``"conv9"``, K2 or K4 on ``PATH_DESIGN``'s, its
    f32 instance); ``decode_kw``: ``predict``'s decode keywords (greedy
    when None); ``reps`` timed calls, ``stage_reps`` clocked ones (the
    first 3 not kept) and ``trace_n`` traced ones (0: none). Returns the
    counts, under ``"design"`` ``read_design``'s, and under
    ``"throughput"`` the emitted line."""
    import torch
    from crnn_ocr_torch import load_pretrained
    from crnn_ocr_torch.kernels import bigru, fused_stem

    decode_kw = decode_kw or {}
    pred = load_pretrained(name, device="cuda", dtype=dtype)
    for _ in range(3):
        pred.predict(lines, bucket=bucket, **decode_kw)
    torch.cuda.synchronize()
    batch_ms = []
    reset_launches()
    for _ in range(reps):
        t0 = time.perf_counter()
        out = pred.predict(lines, bucket=bucket, **decode_kw)
        batch_ms.append((time.perf_counter() - t0) * 1e3)
    counts = read_launches()
    emit("launches", model=name, predict_calls=reps, **counts,
         designs=[[*d, n] for d, n in bigru.design_launches.items()],
         stem_designs=dict(fused_stem.design_launches))
    require_launches(counts, {k: v * reps for k, v in want.items()},
                     f"{name}: {reps} predict calls")
    design = read_design(counts, f"{name}: {reps} predict calls")
    stem_design = read_stem_design(counts, path,
                                   f"{name}: {reps} predict calls")
    require(len(out) == BATCH and all(isinstance(o.text, str) for o in out),
            "throughput run returned malformed predictions")

    # per-stage breakdown through the Predictor's own steps, synchronized
    # after each stage (an STN model's front end split into its
    # localization net and the sampler)
    m = pred.model
    keys = ["preprocess", "stem", "backbone", "rnn_head", "decode"]
    if m.stn is not None:
        keys[1:1] = ["stn_localize", "sampler"]
    stages = {k: [] for k in keys}

    def clock(key, t0):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        stages[key].append((t1 - t0) * 1e3)
        return t1

    with torch.inference_mode():
        for _ in range(stage_reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            x, w_new = pred.preprocess(lines, bucket)
            t = clock("preprocess", t)
            if m.stn is not None:
                x, t = stn_stages(m, x, clock, t)
            s = m.stem(x)
            t = clock("stem", t)
            f = m.backbone(s)
            t = clock("backbone", t)
            logits = m.head(f)
            t = clock("rnn_head", t)
            pred.decode(*pred.probs(logits, w_new), **decode_kw)
            clock("decode", t)
    stage_ms = {k: statistics.median(v[3:]) for k, v in stages.items()}
    p50 = statistics.median(batch_ms)
    res = dict(model=name, dtype=str(m.dtype).split(".")[-1], batch=BATCH,
               bucket=bucket, lines_per_s=BATCH / (p50 / 1e3),
               p50_batch_ms=p50, min_batch_ms=min(batch_ms),
               max_batch_ms=max(batch_ms), stage_ms=stage_ms,
               card=card, **({"decode": decode_kw} if decode_kw else {}))
    emit("throughput", **res)
    if trace_n:
        emit("trace", model=name, **trace_predict(
            pred, lines, bucket, trace_n, decode_kw=decode_kw))
    return {**counts, "design": design, "stem_design": stem_design,
            "throughput": res}


def stn_stages(m, x, clock, t):
    """The STN's forward (``models/stn.py::STN.forward``) as two clocked
    stages: the localization net's theta, then the warp (K11 on the card).
    Returns the warped frames and the clock."""
    x = x.to(m.dtype)
    theta = m.stn.localize(x)
    t = clock("stn_localize", t)
    x = m.stn.warp(x, theta)
    return x, clock("sampler", t)


def trace_predict(pred, lines, bucket: int = BUCKET, n: int = 5,
                  decode_kw: dict = None) -> dict:
    """torch.profiler over ``n`` predict calls at ``bucket`` (with
    ``decode_kw``): the device's busy share of the wall time, and the ops
    that take the most device and host time."""
    def run():
        for _ in range(n):
            pred.predict(lines, bucket=bucket, **(decode_kw or {}))

    return _trace_summary(*profiled(run), n)


# ---- slice 2: training fonts-hard, B = 128, bucket 256 ----

TRAIN_BATCH, TRAIN_MAX_LABEL = 128, 32
TRAIN_LR = 1e-4  # fine-tuning rate for the counted run: a tenth of the
# training default, for a model that already reads these lines
TRAIN_STEPS, TRAIN_WARMUP = 30, 3


def train_setup(g, dtype: str, dropout: float, name: str = "fonts-hard",
                key: str = "hard", bucket: int = BUCKET,
                optimizer: str = "adam", mesh=None):
    """A train state of bundled model ``name`` on the card (its shipped
    weights, ``dtype`` and ``dropout``, ``optimizer`` at ``TRAIN_LR``; on a
    process ``mesh``: the rank's replica), its raw host batch (the 64
    golden ``key`` lines repeated to 128, labels padded to 32, at
    ``bucket``) and the device batch produced from it."""
    import dataclasses

    import numpy as np
    from crnn_ocr_torch.data.pipeline import produce_batch
    from crnn_ocr_torch.infer.pretrained import model_weights
    from crnn_ocr_torch.infer.weights import params_from_jax
    from crnn_ocr_torch.train.state import create_train_state

    cfg, params, stats, codec = model_weights(name, dtype)
    cfg = dataclasses.replace(cfg, dropout_rate=dropout)
    reps = TRAIN_BATCH // len(g[f"{key}_heights"])
    truth = [str(t) for t in g[f"{key}_truth"]] * reps
    labels, lab_len = codec.encode_batch(truth, TRAIN_MAX_LABEL)
    host = {"the_input": np.concatenate([g[f"{key}_canvas"]] * reps),
            "heights": np.concatenate([g[f"{key}_heights"]] * reps),
            "widths": np.concatenate([g[f"{key}_widths"]] * reps),
            "the_labels": labels, "label_length": lab_len,
            "bucket": bucket, "texts": truth}
    state = create_train_state(cfg, params_from_jax(params, stats),
                               device="cuda", optimizer=optimizer,
                               learning_rate=TRAIN_LR, mesh=mesh)
    return cfg, codec, state, host, produce_batch(dict(host), "cuda", cfg)


def _close(got, want, atol, rtol):
    """max |got - want| and whether every element is within
    ``atol + rtol * |want|``."""
    err = (got.float() - want.float()).abs()
    return float(err.max()), bool((err <= atol + rtol * want.float().abs())
                                  .all())


def check_bigru_train(state, batch, dtype_name: str):
    """K3 on layer 0's input projections of the training path, against
    its plain version; K2 on the same inputs, to price the stash."""
    import torch
    from crnn_ocr_torch.kernels import bigru as bg

    m = state.model
    rnn = m.birnn0
    with torch.no_grad():
        feat = m.frame_features(m.backbone(m.stem(batch["x"])))
        xw = rnn.project(feat)
    u = rnn.recurrent_kernel.detach().to(rnn.dtype).contiguous()
    rb = rnn.bias.detach()[:, 1].contiguous()
    uk = rnn.kernel_operand()
    hs, gates = bg.bigru_train(xw, u, rb, uk)
    with torch.no_grad():
        p_hs, p_gates = bg.bigru_train_plain(xw, u, rb)
    torch.cuda.synchronize()
    bf16 = dtype_name == "bfloat16"
    # bf16: hs as K2 (2e-2, outputs in (-1, 1)); the gates carry the same
    # state error through sums of 256 products, and rh is unbounded, so
    # 3e-2 plus 2 % of the value. f32: 1e-4, as K2.
    hs_err, hs_ok = _close(hs, p_hs, 2e-2 if bf16 else 1e-4, 0.0)
    g_err, g_ok = _close(gates, p_gates, 3e-2 if bf16 else 1e-4,
                         2e-2 if bf16 else 0.0)
    T, _, B, G = xw.shape
    H = G // 3
    bytes_moved = nbytes(xw, u, rb, hs, gates)
    ops = 2 * T * 2 * B * H * G + 14 * T * 2 * B * H
    designs = design_times("gru", xw, u, rb, uk, True, p_hs)
    b_ms, b_by, peak_text = rnn_bound(bytes_moved, ops, dtype_name)
    # yardstick only: the port never calls torch.nn.GRU
    gru = torch_gru_from(rnn, rnn.dtype).train()
    feat_g = feat.detach().to(rnn.dtype).requires_grad_(True)
    res = dict(
        kernel="bigru_train", dtype=dtype_name, T=T, B=B, H=H,
        max_abs_err=max(hs_err, g_err), hs_max_abs_err=hs_err,
        gates_max_abs_err=g_err, ok=hs_ok and g_ok,
        tolerance=("hs 2e-2 abs; gates 3e-2 + 2e-2 * |plain|" if bf16
                   else "hs and gates 1e-4 abs"),
        kernel_ms=time_ms(lambda: bg.bigru_train(xw, u, rb, uk)),
        kernel_device_ms=device_ms(lambda: bg.bigru_train(xw, u, rb, uk)),
        k2_same_inputs_ms=time_ms(lambda: bg.bigru_infer(xw, u, rb, uk)),
        plain_ms=time_ms(lambda: bg.bigru_train_plain(xw, u, rb), reps=5),
        library_ms=time_ms(lambda: gru(feat_g)),
        library_device_ms=device_ms(lambda: gru(feat_g)),
        library="torch.nn.GRU bidirectional (cuDNN), training-mode forward "
                "on the layer input; includes the input projection",
        bound_ms=b_ms, bound_by=b_by, bound_peak=peak_text,
        bytes=bytes_moved, ops=ops, **designs,
    )
    emit("kernel_check", **res)
    require(res["ok"], f"bigru_train {dtype_name}: hs error {hs_err}, "
                       f"gates error {g_err} beyond {res['tolerance']}")
    return res


# the GRU's backward checked and timed at train-hard's shape (bf16, fonts-
# hard's layer-0 U) and at fonts-small's training shape (f32): T, B, H, model
BWD_SHAPES = {"bfloat16": (64, 1024, 256, "fonts-hard"),
              "float32": (32, 128, 128, "fonts-small")}


def backward_resources(H: int, design, dtype_name: str) -> dict:
    """The backward kernel's instance on this card, launching nothing: its
    dynamic shared memory, the clusters the card holds at once (times the
    cluster: ``bigru.BWD_WAVE_CTAS``), its registers and local memory per
    thread."""
    import ctypes

    from crnn_ocr_torch.kernels import _build

    lib = _build.load("bigru")
    fn = lib.crnn_bigru_bwd_info
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    info = (ctypes.c_int * 4)()
    elem = 2 if dtype_name == "bfloat16" else 4
    _build.check(lib, fn(elem, H, design.cluster, design.rows,
                         ctypes.addressof(info)), "backward info")
    return dict(smem_bytes=info[0], max_active_clusters=info[1],
                wave_ctas=info[1] * design.cluster,
                runtime_registers=info[2], local_bytes=info[3])


def check_bigru_backward(dtype_name: str):
    """Phase 6: the GRU's backward kernel (``csrc/bigru.cu::
    bigru_bwd_kernel`` and its matmul, ``bigru.bigru_backward``) against
    its plain loop (``bigru_backward_plain``) on the same K3 stash, at
    ``BWD_SHAPES[dtype_name]`` on seeded inputs with the model's layer-0
    U: dxw, du and db within tolerance; two runs bit for bit equal; the
    kernel's device ms (``kernel_device_ms``), the whole function's
    (``function_device_ms``: the kernel, dU's matmul, db's sum) and its
    CUDA-event ms beside the kernel's bound, the plain loop's ms and
    ``torch.nn.GRU``'s training backward (cuDNN, the same shape) as the
    yardstick; then each rows instance of the path's cluster on the same
    inputs, its device ms, its resources and whether it equals the path's
    design bit for bit."""
    import numpy as np
    import torch
    from crnn_ocr_torch import load_pretrained
    from crnn_ocr_torch.kernels import bigru as bg

    T, B, H, name = BWD_SHAPES[dtype_name]
    dt = getattr(torch, dtype_name)
    rnn = load_pretrained(name, device="cuda", dtype=dtype_name).model.birnn0
    require(rnn.units == H, f"{name}'s layer 0 has {rnn.units} units")
    rng = np.random.default_rng(25)
    with torch.no_grad():
        xw = torch.from_numpy(rng.normal(size=(T, 2, B, 3 * H)).astype(
            np.float32)).to("cuda", dt)
        u = rnn.recurrent_kernel.detach().to(dt).contiguous()
        rb = rnn.bias.detach()[:, 1].contiguous()
        hs, gates = bg.bigru_train(xw, u, rb)
        g = torch.from_numpy((rng.normal(size=(T, 2, B, H)) * 1e-2).astype(
            np.float32)).to("cuda", dt)

        def kern():
            return bg.bigru_backward(g, u, hs, gates)

        def plain():
            return bg.bigru_backward_plain(g, u, hs, gates)

        d = bg.backward_design_for(H, B, dt)
        require(d.name == BWD_PATH_DESIGN, f"the backward at {T, B, H} "
                                           f"{dtype_name} is {d}")
        n0 = bg.backward_launches
        got, again, want = kern(), kern(), plain()
        torch.cuda.synchronize()
        require(bg.backward_launches == n0 + 2, "the backward did not launch "
                                                "its kernel")
        bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
        bf16 = dt == torch.bfloat16
        # f32 sums in other orders: rtol 1e-4 (bf16 dxw and du: 1e-2, a
        # value one bf16 ulp off where the f32 values round apart), atol
        # 1e-5 of the largest
        errs, ok = {}, bitwise
        for key, a, b in zip(("dxw", "du", "db"), got, want):
            rtol = 1e-2 if bf16 and key != "db" else 1e-4
            e, o = _close(a, b, 1e-5 * float(b.float().abs().max()), rtol)
            errs[f"{key}_max_abs_err"] = e
            ok = ok and o
        ops = 2 * T * 2 * B * H * 3 * H  # drec_t . U^T, f32 products
        kbytes = nbytes(g, hs, gates, u, got[0]) + 4 * 2 * T * B * 4 * H
        peak_key = "tf32x2" if bf16 else "tf32x3"
        bound, by = bound_ms(kbytes, ops, peak_key)
        rows = {}
        for r in bg.BWD_ROWS:
            dr = bg.Design("resident", d.cluster, r)
            if bg.bwd_smem(-(-H // 16) * 16, d.cluster, r,
                           2 if bf16 else 4) > bg.SMEM_BYTES:
                continue
            out = bg._backward_launch(g, u, hs, gates, dr)
            rows[r] = dict(equal=all(torch.equal(a, b)
                                     for a, b in zip(out, got)),
                           function_device_ms=device_ms(
                               lambda: bg._backward_launch(g, u, hs, gates,
                                                           dr)),
                           **backward_resources(H, dr, dtype_name))
            rows[r]["ctas"] = -(-B // r) * 2 * d.cluster
        res = dict(
            kernel="bigru_backward", dtype=dtype_name, model=name, T=T, B=B,
            H=H, design=d.name, cluster=d.cluster, rows=d.rows,
            max_abs_err=max(errs.values()), **errs, bitwise_repeat=bitwise,
            ok=ok, tolerance="dxw, du rtol 1e-2 (bf16) or 1e-4, db rtol "
                             "1e-4; atol 1e-5 of each one's largest",
            kernel_device_ms=kernel_device_ms(kern, "bigru_bwd_kernel"),
            function_device_ms=device_ms(kern),
            kernel_ms=time_ms(kern),
            plain_ms=time_ms(plain, reps=5),
            bound_ms=bound, bound_by=by, bound_peak=PEAK_TEXT[peak_key],
            bytes=kbytes, ops=ops, bound_without_h_prev_ms=bound_ms(
                kbytes - 4 * 2 * T * B * H, ops, peak_key)[0],
            row_designs=rows, resources=rows[d.rows])
    # yardstick only: the port never calls torch.nn.GRU
    gru = torch_gru_from(rnn, dt).train()
    x = torch.from_numpy(rng.normal(size=(B, T, rnn.kernel.shape[1])).astype(
        np.float32)).to("cuda", dt).requires_grad_(True)
    y = gru(x)[0]
    gy = torch.randn_like(y)

    def library():
        y.backward(gy, retain_graph=True)

    res.update(library_ms=time_ms(library), library_device_ms=device_ms(
        library), library="torch.nn.GRU bidirectional (cuDNN), training "
                          "backward (retain_graph), with the input "
                          "projection's")
    emit("kernel_check", **res)
    require(ok, f"bigru_backward {dtype_name}: {errs}, bitwise repeat "
                f"{bitwise}, beyond {res['tolerance']}")
    return res


def old_host_launch(name, emits, flags, lens):
    """K6 or K7 on the path's design through the wrapper's host path as it
    was first written (the C entry's restype and argtypes set on every call,
    always inside ``torch.cuda.device``), to time that path against the
    wrapper's own; uncounted."""
    import ctypes

    import torch
    from crnn_ocr_torch.kernels import _build
    from crnn_ocr_torch.kernels import ctc_loss as cl

    B, T, S = cl._check(emits, flags, lens)
    p = cl.plan(B, T, S)
    out = torch.empty_like(emits)
    lib = _build.load("ctc_loss")
    fn = getattr(lib, f"crnn_ctc_{name}")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    with torch.cuda.device(emits.device):
        err = fn(emits.data_ptr(), flags.data_ptr(), lens.data_ptr(),
                 out.data_ptr(), B, T, S, cl.DESIGNS[p.design],
                 p.warps, p.ring_frames, p.smem_bytes,
                 torch.cuda.current_stream(emits.device).cuda_stream)
    _build.check(lib, err, f"ctc {name}")
    return out


def check_ctc(state, batch, cfg, dtype_name: str):
    """K6 and K7 on the training path's log-probs and labels, on the path's
    design (``ctc_loss.plan``) and on ``"block"``, against their plain
    versions; F.ctc_loss's forward and backward as yardsticks."""
    import torch
    import torch.nn.functional as F
    from crnn_ocr_torch.kernels import ctc_loss as cl

    with torch.no_grad():
        logits = state.model(batch["x"])
    lp = torch.log_softmax(logits[:, cfg.ctc_time_slice:], dim=-1)
    emits, flags, lens, _, lab_len = cl.prepare(
        lp, batch["the_labels"], batch["input_length"],
        batch["label_length"])
    out = []
    for name, fn, plain in (("ctc_alpha", cl.ctc_alphas, cl.ctc_alphas_plain),
                            ("ctc_beta", cl.ctc_betas, cl.ctc_betas_plain)):
        B, T, S = emits.shape
        p = cl.plan(B, T, S)
        before = collections.Counter(cl.design_launches)
        got = fn(emits, flags, lens)
        block = fn(emits, flags, lens, "block")
        want = plain(emits, flags, lens)
        torch.cuda.synchronize()
        short = name[4:]
        require(cl.design_launches - before
                == {(short, p.design): 1, (short, "block"): 1},
                f"{name}: launched {dict(cl.design_launches - before)} by "
                f"design; expected one {p.design} and one block")
        err, ok = ctc_close(got, want)
        block_err, block_ok = ctc_close(block, want)
        bytes_moved = nbytes(emits, flags, lens, got)
        ops = 20 * B * T * S  # 3 exp, 1 log, ~16 adds, maxes and selects
        b_ms, b_by = bound_ms(bytes_moved, ops, "float32")
        frames = T - 1 if name == "ctc_alpha" else T  # dependent frames
        device = device_ms(lambda: fn(emits, flags, lens))
        res = dict(kernel=name, dtype=dtype_name, B=B, T=T, S=S,
                   max_abs_err=err, ok=ok and block_ok,
                   tolerance="1e-4 + 1e-5 * |plain| where finite; NEG "
                             "where plain is NEG",
                   design=p.design, plan=p._asdict(),
                   kernel_ms=time_ms(lambda: fn(emits, flags, lens)),
                   kernel_ms_old_host_path=time_ms(
                       lambda: old_host_launch(short, emits, flags, lens)),
                   kernel_device_ms=device,
                   us_per_frame=device * 1e3 / frames,
                   block_ms=device_ms(lambda: fn(emits, flags, lens,
                                                 "block")),
                   block_max_abs_err=block_err,
                   block_equal=bool(torch.equal(got, block)),
                   ptxas=CTC_PTXAS.get(ctc_ptxas_key(short, p)),
                   plain_ms=time_ms(lambda: plain(emits, flags, lens),
                                    reps=5),
                   bound_ms=b_ms, bound_by=b_by, bytes=bytes_moved, ops=ops,
                   dependent_frames=frames)
        out.append(res)
    # yardstick only: the port never calls F.ctc_loss
    lp_t = lp.detach().transpose(0, 1).contiguous().requires_grad_(True)
    args = (batch["the_labels"].long(), batch["input_length"].long(),
            batch["label_length"].long())

    def lib_fwd():
        return F.ctc_loss(lp_t, *args, blank=lp.shape[-1] - 1,
                          reduction="none", zero_infinity=False)

    loss = lib_fwd()
    out[0]["library_ms"] = time_ms(lib_fwd)
    out[0]["library_device_ms"] = device_ms(lib_fwd)
    out[0]["library"] = "F.ctc_loss forward (reduction='none')"
    ones = torch.ones_like(loss)
    out[1]["library_ms"] = time_ms(lambda: torch.autograd.grad(
        loss, lp_t, ones, retain_graph=True))
    out[1]["library_device_ms"] = device_ms(lambda: torch.autograd.grad(
        loss, lp_t, ones, retain_graph=True))
    out[1]["library"] = "F.ctc_loss backward alone (autograd.grad)"
    with torch.no_grad():
        ours = cl.loss_from_alphas(cl.ctc_alphas(emits, flags, lens), lab_len)
    out[0]["library_vs_port_loss_max_rel"] = float(
        ((loss.detach() - ours).abs() / ours.abs().clamp(min=1e-6)).max())
    for res in out:
        emit("kernel_check", **res)
        require(res["ok"], f"{res['kernel']} {dtype_name}: max error "
                           f"{res['max_abs_err']} ({res['design']}), "
                           f"{res['block_max_abs_err']} (block) beyond "
                           f"{res['tolerance']}")
    return out


def phase_train_kernels(g):
    """Phase 6: K3, K6 and K7 against their plain versions on the training
    path's own tensors, bf16 and f32, TF32 off."""
    checks = []
    for dtype_name in ("bfloat16", "float32"):
        cfg, _, state, _, batch = train_setup(g, dtype_name, 0.0)
        checks.append(check_bigru_train(state, batch, dtype_name))
        checks.extend(check_ctc(state, batch, cfg, dtype_name))
        checks.append(check_bigru_backward(dtype_name))
    return checks


# launches per train step: the head's and the loss's, then the stem's (an
# STN model trains through the plain stem)
HEAD_TRAIN_KERNELS = {"bigru_train": 2, "bigru_backward": 2, "ctc_alpha": 1,
                      "ctc_beta": 1}
TRAIN_KERNELS = dict(HEAD_TRAIN_KERNELS, fused_stem=1, stem_stats=1,
                     stem_bwd_partials=1, stem_bwd_final=1)
STN_TRAIN_KERNELS = dict(HEAD_TRAIN_KERNELS, grid_sample=1,
                         grid_sample_bwd=1)


def compare_steps(k, p) -> tuple:
    """One f32 train step ``k`` against another, ``p``, each ``(loss,
    loss_vec, grad_norm, grads, state dict)``: the differences, and whether
    they are within phase 7's tolerances."""
    k_loss, _, k_norm, k_grads, k_sd = k
    p_loss, _, p_norm, p_grads, p_sd = p
    # loss and norm rtol 2e-5; every parameter's gradient rtol 1e-4 / atol
    # 1e-4 of the leaf's largest (f32 sums in other orders; the CTC gradient
    # takes the rounding of alphas near -100 into every element), as
    # tests/test_torch_train.py holds the port's gradients to jax.grad.
    # Adam's first update is about lr * sign(g) whatever |g|, so the updated
    # parameters add a check of each sign: rtol 2e-4 / atol 2e-5, except
    # gradient elements at the f32 noise of their sums (<= 1e-5 of the
    # tensor's largest), where the update can differ by up to 2 * lr (at
    # most 0.1 % of a tensor)
    # per leaf: the smallest atol, as a share of its largest gradient, that
    # passes it at rtol 1e-4
    grad_err = {}
    for leaf, want in p_grads.items():
        excess = (k_grads[leaf] - want).abs() - 1e-4 * want.abs()
        grad_err[leaf] = (float(excess.clamp(min=0).max())
                          / max(float(want.abs().max()), 1e-30))
    grads_off = [n for n, e in grad_err.items() if e > 1e-4]
    bad = []
    for leaf, want in p_sd.items():
        got = k_sd[leaf]
        off = (got - want).abs() > 2e-5 + 2e-4 * want.abs()
        if leaf in p_grads:
            gr = p_grads[leaf].abs()
            noise = gr <= 1e-5 * gr.max()
            err_off = (got - want).abs()[off]
            if (bool((off & ~noise).any()) or float(off.float().mean()) > 1e-3
                    or (err_off.numel() and float(err_off.max())
                        > 2 * TRAIN_LR)):
                bad.append(leaf)
        elif bool(off.any()):
            bad.append(leaf)
    worst = max(grad_err, key=grad_err.get)
    res = dict(
        loss=k_loss, plain_loss=p_loss, grad_norm=k_norm,
        plain_grad_norm=p_norm,
        loss_rel_err=abs(k_loss / p_loss - 1),
        grad_norm_rel_err=abs(k_norm / p_norm - 1),
        grad_atol_needed_max=grad_err[worst], grad_atol_needed_worst=worst,
        grads_off=grads_off,
        max_param_abs_err=max(float((k_sd[n] - p_sd[n]).abs().max())
                              for n in p_sd),
        params_off=bad,
        tolerance="loss, grad_norm rtol 2e-5; each gradient rtol 1e-4 / "
                  "atol 1e-4 * the leaf's max; params rtol 2e-4 / atol "
                  "2e-5 (noise-level gradient elements: 2 * lr)")
    ok = (res["loss_rel_err"] <= 2e-5 and res["grad_norm_rel_err"] <= 2e-5
          and not grads_off and not bad)
    return res, ok


def phase_train_parity(g, name: str = "fonts-hard", key: str = "hard",
                       gold=None, want: dict = TRAIN_KERNELS,
                       bucket: int = BUCKET, norm_rtol: float = 2e-3,
                       plain_stem: bool = True, rnn_design: str = None):
    """Phases 7, 12, 16 and 21: one f32 train step of ``name`` (dropout 0)
    at ``bucket`` through the kernels against the same step through the
    plain versions on the card, and against the JAX package's step ``gold``
    (by default ``testdata/train_goldens.npz``'s fonts-hard keys); ``want``:
    the kernel step's launches; ``norm_rtol``: the per-parameter gradient
    norms' tolerance against the golden. ``plain_stem=False`` keeps the
    stem's kernels in the plain step, so that the check holds the rest of
    the path's kernels (the stem's are held to their plain versions in
    phases 15-17); the step with every kernel plain is then reported beside
    it, with the difference that the stem's kernels alone make.
    ``rnn_design``: the design every recurrence launch of the kernel step
    must run on (phase 16: K3 in f32 on ``"resident"``); the step's
    launches per design are reported in any case."""
    import numpy as np
    import torch
    from crnn_ocr_torch.train import state as st_lib
    from crnn_ocr_torch.train import step as step_lib

    def one_step(plain: bool, stem: bool = True):
        cfg, _, state, _, batch = train_setup(g, "float32", 0.0, name, key,
                                              bucket)
        ctx = plain_kernels(stem) if plain else contextlib.nullcontext()
        with ctx:
            state.optimizer.zero_grad(set_to_none=True)
            loss, loss_vec = step_lib.loss_fn(state.model, batch, cfg)
            loss.backward()
            grads = {k: p.grad.detach().clone()
                     for k, p in state.model.named_parameters()}
            gnorm = st_lib.apply_gradients(state)
        torch.cuda.synchronize()
        return (loss.item(), loss_vec.detach(), gnorm.item(), grads,
                {k: v.detach().clone()
                 for k, v in state.model.state_dict().items()})

    # the backbone's convolutions off cuDNN in both steps (PyTorch's own CUDA
    # convolutions instead): cuDNN's outputs at two positions with equal
    # inputs can differ in the last bit, so the stem kernels' ulp-level
    # differences from the plain stem flip max-pool near-ties behind them;
    # fonts-small, which reads its lines almost surely (small gradients),
    # showed that as 1.1e-3 of block3's largest gradient
    cudnn = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    from crnn_ocr_torch.kernels import bigru

    try:
        reset_launches()
        kern = one_step(False)
        kernel_counts = read_launches()
        kernel_designs = {d: n for d, n in bigru.design_launches.items()
                          if n}
        backward_designs = read_backward_design(
            kernel_counts, f"{name}: the f32 kernel step")
        plain = one_step(True)
        plain_but_stem = None if plain_stem else one_step(True, stem=False)
    finally:
        torch.backends.cudnn.enabled = cudnn
    require_launches(kernel_counts, want, f"{name}: the f32 kernel step")
    require(rnn_design is None or {d.name for d in kernel_designs}
            == {rnn_design}, f"{name}: the f32 kernel step's recurrences "
                             f"ran {kernel_designs}; expected {rnn_design}")
    extra = {}
    if plain_stem:
        res, ok = compare_steps(kern, plain)
    else:
        res, ok = compare_steps(kern, plain_but_stem)
        extra = dict(kernels_vs_all_plain=compare_steps(kern, plain)[0],
                     stem_kernels_alone=compare_steps(plain_but_stem,
                                                      plain)[0])
    res["launches_in_kernel_step"] = kernel_counts
    res["designs_in_kernel_step"] = [[*d, n] for d, n in
                                     kernel_designs.items()]
    res["backward_designs_in_kernel_step"] = backward_designs
    # against the JAX package's step: the port preprocesses the lines itself
    # (standardized frames within 1e-4 of JAX's), so loss rtol 1e-4, each
    # line's loss 1e-3 + 1e-3 relative, the global gradient norm rtol 2e-3
    # and the per-parameter ones ``norm_rtol``, the BatchNorm statistics
    # atol 1e-4
    k_loss, k_vec, k_norm, k_grads, k_sd = kern
    if gold is None:
        gold = np.load(TRAIN_GOLDENS)
    vec_err = np.abs(k_vec.cpu().numpy() - gold["loss_vec"])
    vec_ok = bool((vec_err <= 1e-3 + 1e-3 * np.abs(gold["loss_vec"])).all())
    gn_rel = max(abs(float(k_grads[n].norm()) / float(gold[f"gradnorm/{n}"])
                     - 1) for n in k_grads)
    st_err = max(float(np.abs(k_sd[k[6:]].cpu().numpy() - gold[k]).max())
                 for k in gold if k.startswith("stats/"))
    golden = dict(loss=float(gold["loss"]), grad_norm=float(gold["grad_norm"]),
                  loss_rel_err=abs(k_loss / float(gold["loss"]) - 1),
                  loss_vec_max_abs_err=float(vec_err.max()),
                  grad_norm_rel_err=abs(k_norm / float(gold["grad_norm"]) - 1),
                  param_grad_norm_max_rel_err=gn_rel,
                  bn_stats_max_abs_err=st_err)
    golden_ok = (golden["loss_rel_err"] <= 1e-4 and vec_ok
                 and golden["grad_norm_rel_err"] <= 2e-3
                 and gn_rel <= norm_rtol and st_err <= 1e-4)
    emit("train_parity", model=name, kernels_vs_plain=res, ok=ok,
         plain_stem=plain_stem, **extra, vs_jax_golden=golden,
         golden_ok=golden_ok)
    require(ok, f"{name} f32 train step: kernels differ from the plain "
                f"versions: {res}")
    require(golden_ok, f"{name} f32 train step differs from the JAX golden: "
                       f"{golden}")
    return dict(launches=kernel_counts, designs=kernel_designs)


def phase_train(g, card: str, name: str = "fonts-hard", key: str = "hard",
                want: dict = TRAIN_KERNELS, bucket: int = BUCKET):
    """Phases 8, 13 and 17, a training path counted: ``name`` in bf16,
    dropout 0.2, B = 128, at ``bucket``, fine-tuned on the 64 golden ``key``
    lines.
    Each step is ``produce_batch`` (the host canvas to device frames) plus
    ``fit``'s own train step, synchronized and timed; the launch counts are
    set to 0 just before the timed steps and read just after, and must be
    ``want``'s per step. Returns the counts and, under ``"design"``,
    ``read_design``'s."""
    import torch
    from crnn_ocr_torch.data.pipeline import produce_batch
    from crnn_ocr_torch.kernels import bigru, ctc_loss, fused_stem
    from crnn_ocr_torch.kernels import grid_sample as gs
    from crnn_ocr_torch.train import loop as loop_lib
    from crnn_ocr_torch.train import state as st_lib
    from crnn_ocr_torch.train import step as step_lib

    cfg, codec, state, host, _ = train_setup(g, "bfloat16", 0.2, name, key,
                                             bucket)
    train_step = step_lib.make_train_step(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    losses = []

    def step():
        batch = produce_batch(dict(host), "cuda", cfg)
        batch.pop("texts"), batch.pop("bucket")
        losses.append(train_step(state, batch, gen)["loss"])

    for _ in range(TRAIN_WARMUP):
        step()
    torch.cuda.synchronize()
    step_ms = []
    reset_launches()
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    counts = read_launches()
    emit("launches", model=name, train_steps=TRAIN_STEPS, **counts,
         designs=[[*d, n] for d, n in bigru.design_launches.items()],
         backward_designs=[[*d, n] for d, n in
                           bigru.backward_design_launches.items()],
         stem_designs=dict(fused_stem.design_launches),
         ctc_designs=[[*d, n] for d, n in ctc_loss.design_launches.items()],
         sampler_designs=dict(gs.design_launches))
    require_launches(counts, {k: v * TRAIN_STEPS for k, v in want.items()},
                     f"{name}: {TRAIN_STEPS} train steps")
    design = read_design(counts, f"{name}: {TRAIN_STEPS} train steps")
    backward_design = read_backward_design(
        counts, f"{name}: {TRAIN_STEPS} train steps")
    stem_design = read_stem_design(counts, "train",
                                   f"{name}: {TRAIN_STEPS} train steps")
    ctc_design = read_ctc_design(counts, f"{name}: {TRAIN_STEPS} train steps")
    sampler_design = read_sampler_design(
        counts, f"{name}: {TRAIN_STEPS} train steps")
    loss_curve = [float(x) for x in losses]
    first, last5 = loss_curve[0], statistics.mean(loss_curve[-5:])
    require(all(map(lambda v: v == v, loss_curve)), "a train loss is NaN")
    require(last5 < first, f"the loss did not fall: first {first}, mean of "
                           f"the last 5 {last5}")

    # per-stage breakdown through the same functions, synchronized per stage
    # ("forward" is the model's forward after an STN's two stages and the
    # stem)
    m = state.model
    keys = ["preprocess", "stem", "forward", "loss", "backward", "optimizer"]
    if m.stn is not None:
        keys[1:1] = ["stn_localize", "sampler"]
    stages = {k: [] for k in keys}

    def clock(key, t0):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        stages[key].append((t1 - t0) * 1e3)
        return t1

    for _ in range(8):
        torch.cuda.synchronize()
        t = time.perf_counter()
        batch = produce_batch(dict(host), "cuda", cfg)
        t = clock("preprocess", t)
        state.optimizer.zero_grad(set_to_none=True)
        x = batch["x"]
        if m.stn is not None:
            x, t = stn_stages(m, x, clock, t)
        x = m.stem(x)
        t = clock("stem", t)
        logits = m.head(m.backbone(x, gen))
        t = clock("forward", t)
        loss_vec = step_lib.ctc_loss_vec(
            logits, batch["the_labels"], batch["input_length"],
            batch["label_length"], cfg.ctc_time_slice)
        loss = torch.clamp(loss_vec, max=step_lib.LOSS_CLIP).mean()
        t = clock("loss", t)
        loss.backward()
        t = clock("backward", t)
        st_lib.apply_gradients(state)
        clock("optimizer", t)
    stage_ms = {k: statistics.median(v[2:]) for k, v in stages.items()}
    p50 = statistics.median(step_ms)
    # all the lines of the timed steps over all their time, stalls included
    emit("train", model=name, dtype="bfloat16", batch=TRAIN_BATCH,
         bucket=bucket, dropout=0.2, learning_rate=TRAIN_LR,
         steps=TRAIN_WARMUP + TRAIN_STEPS,
         lines_per_s=TRAIN_BATCH * TRAIN_STEPS / (sum(step_ms) / 1e3),
         p50_step_ms=p50, min_step_ms=min(step_ms), max_step_ms=max(step_ms),
         stage_ms=stage_ms, first_loss=first, last5_mean_loss=last5,
         loss_curve=loss_curve, card=card)
    # an STN model's stem is plain: no stem_backward range; a model has the
    # backward range of its own cell only
    skip = {"bilstm_backward" if cfg.rnn_cell == "gru" else "bigru_backward"}
    if m.stn is not None:
        skip.add("stem_backward")
    ranges = tuple(r for r in RANGES if r not in skip)
    emit("train_trace", model=name, **trace_train(step, ranges))

    # fit and evaluate themselves, outside the counted window
    batches = [produce_batch(dict(host), "cuda", cfg) for _ in range(4)]
    state = loop_lib.fit(state, cfg, iter(batches), lambda: iter(batches[:1]),
                         codec, loop_lib.FitConfig(
                             steps=state.step + 4, eval_every=2,
                             log_every=2, eval_batches=1))
    ev = loop_lib.evaluate(state, step_lib.make_eval_step(cfg),
                           iter(batches[:1]), codec, 1)
    emit("fit", steps=state.step, eval=ev)
    require(0.0 <= ev["cer"] <= 1.0, f"fit's evaluation is malformed: {ev}")
    return {**counts, "design": design, "stem_design": stem_design,
            "backward_design": backward_design,
            "ctc_design": ctc_design, "sampler_design": sampler_design,
            "lines_per_s": TRAIN_BATCH * TRAIN_STEPS / (sum(step_ms) / 1e3),
            "p50_step_ms": p50}


def trace_train(step, ranges, n: int = 3) -> dict:
    """torch.profiler over ``n`` train steps: the device's idle share, the
    top device and host ops, and each of the ``ranges``' host time, device
    span and share of the wall (the plain BiGRU or BiLSTM backward loop's,
    the CTC backward's, the training stem's backward)."""
    def run():
        for _ in range(n):
            step()

    prof, wall_us = profiled(run)
    out = _trace_summary(prof, wall_us, n)
    for key in ranges:
        # a range has a host row and a device-timeline row of one name; the
        # latter spans its first kernel's start to its last kernel's end,
        # gaps included
        rows = [r for r in prof.key_averages() if r.key == key]
        require(bool(rows), f"the trace has no {key} range")
        host = max(r.cpu_time_total for r in rows)
        span = max(r.device_time_total for r in rows)
        out[f"{key}_host_ms_per_step"] = host / n / 1e3
        out[f"{key}_device_span_ms_per_step"] = span / n / 1e3
        out[f"{key}_share_of_wall"] = host / wall_us
    return out


# record_function ranges the port's training path opens
RANGES = ("bigru_backward", "bilstm_backward", "ctc_loss_backward",
          "stem_backward")


def _trace_summary(prof, wall_us: float, n: int) -> dict:
    """Device busy time (the union of kernel and copy intervals on the card,
    ranges excluded: ``device_work``), idle share, and the top device and
    host ops (ranges excluded too)."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in device_work(prof))
    busy, end = 0.0, -1.0
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    require(busy > 0, "the trace shows no work on the device")
    ranges = {e.name for e in prof.events()
              if getattr(e, "is_user_annotation", False)}
    avg = [r for r in prof.key_averages() if not is_range_row(r.key, ranges)]

    def top(attr, k=8):
        rows = sorted(avg, key=lambda r: getattr(r, attr), reverse=True)[:k]
        return [(r.key[:60], round(getattr(r, attr) / n / 1e3, 4))
                for r in rows]

    # K11 and K12 (their CUDA names hold sample_fwd / sample_bwd)
    sampler = sum(r.self_device_time_total for r in avg
                  if "sample_fwd" in r.key or "sample_bwd" in r.key)
    # the host's waits on the card (a copy between host memory and the card
    # waits for the stream; the window's closing synchronize counts once)
    syncs = [r for r in avg if "Synchronize" in r.key]
    return dict(iterations=n, wall_ms_per_iteration=wall_us / n / 1e3,
                device_busy_ms_per_iteration=busy / n / 1e3,
                device_idle_share=1.0 - busy / wall_us,
                sampler_device_ms_per_iteration=sampler / n / 1e3,
                syncs_per_iteration=sum(r.count for r in syncs) / n,
                sync_host_ms_per_iteration=sum(
                    r.self_cpu_time_total for r in syncs) / n / 1e3,
                top_device_ms=top("self_device_time_total"),
                top_host_ms=top("self_cpu_time_total"))


# ---- slice 3: the STN front end, fonts-warp-stn (and fonts-stn) ----

STN_NAME, STN_KEY = "fonts-warp-stn", "warp"
STN_SERVE_KERNELS = {"grid_sample": 1, "fused_stem": 1, "bigru": 2}


def old_sampler_launch(img, x, y, g=None):
    """K11 (``g`` None) or K12 (on the path's plan) through the wrappers'
    host path as it was first written (the C entry's restype and argtypes
    set on every call, always inside ``torch.cuda.device``), to time that
    path against the wrappers' own; uncounted."""
    import ctypes

    import torch
    from crnn_ocr_torch.kernels import _build
    from crnn_ocr_torch.kernels import grid_sample as gs

    B, H, W, N = gs._check(img, x, y, g)
    dev = img.device
    lib = _build.load("grid_sample")
    ins = (x, y) if g is None else (x, y, g)
    row = torch.empty((B, N), dtype=torch.float32, device=dev)
    if g is None:
        fn, outs, extra = lib.crnn_grid_sample_fwd, (row,), ()
    else:
        p = gs.plan(B, H, W, N, img.element_size())
        fn = lib.crnn_grid_sample_bwd
        outs = (torch.empty((B, H, W), dtype=torch.float32, device=dev), row,
                torch.empty_like(row))
        extra = gs.plan_args(p)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * (1 + len(ins) + len(outs))
                   + [ctypes.c_int] * (5 + len(extra)) + [ctypes.c_void_p])
    with torch.cuda.device(dev):
        err = fn(img.data_ptr(), *(t.data_ptr() for t in ins),
                 *(t.data_ptr() for t in outs), B, H, W, N,
                 int(img.dtype == torch.bfloat16), *extra,
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "sample_pix (old host path)")
    return outs


def check_sampler(img, theta, dtype_name: str, path: str):
    """K11 and K12 on an STN's input frames ``img`` (B, H, W) in the compute
    dtype and its ``theta`` (B, 6), against their plain versions; the
    upstream gradient is drawn from a seed. ``d_img`` is also checked
    through the autograd Function with an image that requires a gradient.
    ``F.grid_sample`` (border, align_corners) and its backward are the
    yardsticks."""
    import torch
    import torch.nn.functional as F
    from crnn_ocr_torch.kernels import grid_sample as gs
    from crnn_ocr_torch.ops.grid_sample import affine_grid

    B, H, W = img.shape
    coords = affine_grid(theta, H, W)
    x, y = gs.pixel_coords(coords, H, W)
    g = torch.randn(x.shape, generator=torch.Generator(
        device="cuda").manual_seed(7), device="cuda")
    N = x.shape[1]
    p = gs.plan(B, H, W, N, img.element_size())
    before = collections.Counter(gs.design_launches)
    out = gs.sample_pix(img, x, y)
    dimg, dx, dy = gs.sample_pix_bwd(img, x, y, g)
    first = gs.sample_pix_bwd(img, x, y, g, "image")
    want = gs.sample_pix_plain(img, x, y)
    p_dimg, p_dx, p_dy = gs.sample_pix_bwd_plain(img, x, y, g)
    require(gs.design_launches - before == {p.design: 1, "image": 1},
            f"grid_sample_bwd: launched {dict(gs.design_launches - before)} "
            f"by design; expected one {p.design} and one image")
    # d_img through the path's autograd Function, image and coordinates
    # requiring gradients: kernels against plain versions
    grads = []
    for plain in (False, True):
        im = img.detach().clone().requires_grad_(True)
        co = coords.detach().clone().requires_grad_(True)
        with plain_kernels() if plain else contextlib.nullcontext():
            o = gs.bilinear_sample(im[..., None], co)
            o.backward(g.reshape(o.shape).to(o.dtype))
        grads.append((im.grad, co.grad))
    torch.cuda.synchronize()
    # the same f32 operations in the same order, each rounded on its own:
    # 1e-6 + 1e-6 * |plain|; d_img's shared-memory atomics add a pixel's
    # terms in no fixed order: 1e-5 + 1e-5 * |plain|, and through autograd
    # with a bf16 image, which gets a bf16 d_img, one bf16 ulp more (at
    # most 2^-7 of the value)
    ulp = 2.0 ** -7 if img.dtype == torch.bfloat16 else 0.0
    errs = {}
    ok = True
    for key, a, b, atol, rtol in (
            ("out", out, want, 1e-6, 1e-6), ("dx", dx, p_dx, 1e-6, 1e-6),
            ("dy", dy, p_dy, 1e-6, 1e-6), ("d_img", dimg, p_dimg, 1e-5, 1e-5),
            ("d_img_autograd", grads[0][0], grads[1][0], 1e-5, 1e-5 + ulp),
            ("d_coords_autograd", grads[0][1], grads[1][1], 1e-5, 1e-5),
            ("image_d_img", first[0], p_dimg, 1e-5, 1e-5)):
        errs[key], good = _close(a, b, atol, rtol)
        ok = ok and good
    # the two designs: the same per-sample operations, atomics in another
    # order
    image_equal = bool(torch.equal(dx, first[1]) and torch.equal(dy, first[2]))
    ok = ok and image_equal
    fwd_bytes = nbytes(img, x, y, out)
    bwd_bytes = nbytes(img, x, y, g, dimg, dx, dy)
    # ~20 f32 operations a sample forward (corner math, 4 loads, 6 products
    # and sums), ~40 backward
    f_ms, f_by = bound_ms(fwd_bytes, 20 * B * N, "float32")
    b_ms, b_by = bound_ms(bwd_bytes, 40 * B * N, "float32")
    # yardsticks only: the port never calls F.grid_sample
    img4 = img.float()[:, None].contiguous()
    lib_in = img4.clone().requires_grad_(True)
    lib_grid = coords.detach().clone().requires_grad_(True)

    def lib_fwd(a=img4, grid=coords):
        return F.grid_sample(a, grid, mode="bilinear", padding_mode="border",
                             align_corners=True)

    lib_out = lib_fwd(lib_in, lib_grid)
    g4 = g.reshape(B, 1, H, W)

    def lib_bwd():
        return torch.autograd.grad(lib_out, (lib_in, lib_grid), g4,
                                   retain_graph=True)

    lib_vs_plain = float((lib_out.detach()[:, 0].reshape(B, N)
                          - want).abs().max())
    common = dict(dtype=dtype_name, path=path, B=B, H=H, W=W, N=N, ok=ok)
    fwd = dict(kernel="grid_sample", **common, max_abs_err=errs["out"],
               tolerance="1e-6 + 1e-6 * |plain|",
               kernel_ms=time_ms(lambda: gs.sample_pix(img, x, y)),
               kernel_ms_old_host_path=time_ms(
                   lambda: old_sampler_launch(img, x, y)),
               kernel_device_ms=device_ms(lambda: gs.sample_pix(img, x, y)),
               cold_ms=kernel_device_ms(lambda: gs.sample_pix(img, x, y),
                                        "sample_fwd", cold=True),
               plain_ms=time_ms(lambda: gs.sample_pix_plain(img, x, y)),
               library_ms=time_ms(lib_fwd),
               library_device_ms=device_ms(lib_fwd),
               library="F.grid_sample bilinear, border, align_corners "
                       "(f32 image)",
               library_vs_plain_max_abs=lib_vs_plain,
               bound_ms=f_ms, bound_by=f_by, bytes=fwd_bytes, ops=20 * B * N)
    bwd = dict(kernel="grid_sample_bwd", **common,
               max_abs_err=max(errs["dx"], errs["dy"], errs["d_img"]),
               errors=errs,
               tolerance="dx, dy 1e-6 + 1e-6 * |plain| (and bit for bit "
                         "to the image design's); d_img 1e-5 + 1e-5 * "
                         "|plain| (through autograd with a bf16 image, "
                         "+ 2^-7 * |plain|)",
               design=p.design, plan=p._asdict(),
               ptxas=SAMPLER_PTXAS.get(sampler_ptxas_key(p, dtype_name)),
               kernel_ms=time_ms(lambda: gs.sample_pix_bwd(img, x, y, g)),
               kernel_ms_old_host_path=time_ms(
                   lambda: old_sampler_launch(img, x, y, g)),
               kernel_device_ms=device_ms(
                   lambda: gs.sample_pix_bwd(img, x, y, g)),
               cold_ms=kernel_device_ms(
                   lambda: gs.sample_pix_bwd(img, x, y, g), "sample_bwd",
                   cold=True),
               image_ms=device_ms(
                   lambda: gs.sample_pix_bwd(img, x, y, g, "image")),
               image_cold_ms=kernel_device_ms(
                   lambda: gs.sample_pix_bwd(img, x, y, g, "image"),
                   "sample_bwd", cold=True),
               image_equal=image_equal,
               plain_ms=time_ms(
                   lambda: gs.sample_pix_bwd_plain(img, x, y, g), reps=5),
               library_ms=time_ms(lib_bwd),
               library_device_ms=device_ms(lib_bwd),
               library="F.grid_sample backward alone (autograd.grad to the "
                       "image and the grid)",
               bound_ms=b_ms, bound_by=b_by, bytes=bwd_bytes, ops=40 * B * N)
    for res in (fwd, bwd):
        emit("kernel_check", **res)
        require(res["ok"], f"{res['kernel']} {dtype_name} ({path}): errors "
                           f"{errs} beyond the tolerances")
    return [fwd, bwd]


def phase_stn_kernels(sg):
    """Phase 9: K11 and K12 on the STN path's own frames and theta, at the
    serving shape (B 256, the predictor's preprocessed frames) and the
    training shape (B 128, the train batch), bf16 and f32, TF32 off."""
    import torch
    from crnn_ocr_torch import load_pretrained

    lines = golden_lines(sg, STN_KEY)
    lines = (lines * (BATCH // len(lines) + 1))[:BATCH]
    checks = []
    for dtype_name in ("bfloat16", "float32"):
        pred = load_pretrained(STN_NAME, device="cuda", dtype=dtype_name)
        with torch.no_grad():
            x, _ = pred.preprocess(lines, BUCKET)
            x = x.to(pred.model.dtype)
            theta = pred.model.stn.localize(x)
        checks += check_sampler(x, theta, dtype_name, "serve")
        _, _, state, _, batch = train_setup(sg, dtype_name, 0.0, STN_NAME,
                                            STN_KEY)
        m = state.model
        with torch.no_grad():
            x = batch["x"].to(m.dtype)
            theta = m.stn.localize(x)
        checks += check_sampler(x, theta, dtype_name, "train")
    return checks


def phase_serve_turns(card: str, hard_lines, stn_lines, rounds: int = 6,
                      calls: int = 10) -> dict:
    """Phase 14: ``fonts-hard`` and ``fonts-warp-stn`` served in turns in
    one call, ``rounds`` rounds of ``calls`` timed ``predict`` calls (B 256,
    bucket 256, bf16) per run, so that the host's drift over the call
    reaches every run alike. The runs: fonts-hard on its own lines, on the
    STN task's lines, and fonts-warp-stn on its lines. The STN's cost is the
    third run's p50 less the second's; the lines' cost (their sizes change
    the host's packing and the resize) the second's less the first's."""
    import torch
    from crnn_ocr_torch import load_pretrained

    hard = load_pretrained("fonts-hard", device="cuda")
    stn = load_pretrained(STN_NAME, device="cuda")
    runs = {"fonts-hard": (hard, hard_lines),
            "fonts-hard on the STN lines": (hard, stn_lines),
            STN_NAME: (stn, stn_lines)}
    for pred, lines in runs.values():
        for _ in range(3):
            pred.predict(lines, bucket=BUCKET)
    times = {k: [] for k in runs}
    for _ in range(rounds):
        for key, (pred, lines) in runs.items():
            torch.cuda.synchronize()
            for _ in range(calls):
                t0 = time.perf_counter()
                pred.predict(lines, bucket=BUCKET)
                times[key].append((time.perf_counter() - t0) * 1e3)
    p50 = {k: statistics.median(v) for k, v in times.items()}
    res = dict(
        rounds=rounds, calls_per_round=calls, batch=BATCH, bucket=BUCKET,
        p50_batch_ms=p50,
        lines_per_s={k: BATCH / (v / 1e3) for k, v in p50.items()},
        round_p50_ms={k: [statistics.median(v[i * calls:(i + 1) * calls])
                          for i in range(rounds)] for k, v in times.items()},
        stn_cost_ms=p50[STN_NAME] - p50["fonts-hard on the STN lines"],
        lines_cost_ms=p50["fonts-hard on the STN lines"] - p50["fonts-hard"],
        card=card)
    emit("serve_turns", **res)
    return res


# ---- slice 4: the training stem, fonts-small (B 128, bucket 128) ----

SMALL_NAME, SMALL_KEY, SMALL_BUCKET = "fonts-small", "small", 128
# the training stem's kernels on both non-STN training paths; the kernels
# line keeps fonts-small's, whose phase 17 counts their launches
STEM_TRAIN_PATHS = ((SMALL_NAME, SMALL_KEY, SMALL_BUCKET),
                    ("fonts-hard", "hard", BUCKET))


def stem_train_operands(state, batch):
    """The training stem's operands on a train batch, as the autograd
    Function hands them to K8-K10: the image (B, H, W, 1) in the compute
    dtype, the HWIO weights, the pooled gradient of the step's loss (in the
    compute dtype), the batch variance, and the per-channel f32 vectors of
    K9 (mean, inv, scale, bias) and K10 (those, then c1, c2, c3)."""
    import torch
    from crnn_ocr_torch.kernels import fused_stem_train as fst
    from crnn_ocr_torch.train import step as step_lib

    m = state.model
    bn = m.stem_bn
    s = m.stem(batch["x"])
    s.retain_grad()
    logits = m.head(m.backbone(s))
    loss_vec = step_lib.ctc_loss_vec(logits, batch["the_labels"],
                                     batch["input_length"],
                                     batch["label_length"])
    torch.clamp(loss_vec, max=step_lib.LOSS_CLIP).mean().backward()
    with torch.no_grad():
        img = batch["x"].to(m.dtype)[..., None].contiguous()
        w = m.stem_conv.weight.permute(2, 3, 1, 0).contiguous()
        g = s.grad.permute(0, 2, 3, 1).contiguous()
        n = float(img.numel())
        st = fst.stem_stats_plain(img, w)
        mean = st[0] / n
        var = st[1] / n - mean * mean
        vecs9 = (mean, *fst.bwd_affine(bn.weight, bn.bias, mean, var))
        p = fst.stem_bwd_partials_plain(img, w, g, *vecs9)
        vecs10 = vecs9 + (vecs9[2], p[0] / n, p[1] / n)
    return img, w, g, var, vecs9, vecs10


def stem_train_scales(img, w, g, mean, inv, scale, bias, c1, c2, c3):
    """Each K8-K10 output's sum of absolute terms (the same sums with every
    term's magnitude): the scale that f32 summation order errors follow."""
    import torch
    import torch.nn.functional as F
    from crnn_ocr_torch.kernels import fused_stem_train as fst

    z = fst._conv(img, w)
    B, C, H, W = z.shape
    d = fst._routed(z, g, scale, bias)
    ch = lambda v: v[:, None, None]  # noqa: E731
    xh = (z - ch(mean)) * ch(inv)
    dc = ch(c1) * ((d - ch(c2)) - xh * ch(c3))
    taps = F.unfold(img.float().permute(0, 3, 1, 2), 3, padding=1).abs()
    dims = (0, 2, 3)
    return (torch.stack([z.abs().sum(dims), (z * z).sum(dims)]),
            torch.stack([d.abs().sum(dims), (d * xh).abs().sum(dims)]),
            torch.einsum("bkl,bcl->kc", taps, dc.abs().reshape(B, C, H * W))
            .reshape(3, 3, 1, C))


def check_stem_train(state, batch, dtype_name: str, path: str):
    """K8, K9 and K10 against their plain versions on a training path's own
    operands (``stem_train_operands``); K1 in the training forward (on
    ``"conv9"``, fed the batch statistics) against its plain version, at
    phase 2's tolerance, and its time;
    the yardsticks: cuDNN's conv with ``torch.var_mean`` for K8, the plain
    stem's autograd backward (conv, BatchNorm, ReLU, max-pool) for K9 and
    K10 as a pair, cuDNN's conv with the affine, ReLU and max-pool for K1's
    training call."""
    import torch
    import torch.nn.functional as F
    from crnn_ocr_torch.kernels import fused_stem as fs
    from crnn_ocr_torch.kernels import fused_stem_train as fst

    img, w, g, var, vecs9, vecs10 = stem_train_operands(state, batch)
    B, H, W, _ = img.shape
    C = w.shape[-1]
    runs = (
        ("stem_stats", lambda: fst.stem_stats(img, w),
         lambda: fst.stem_stats_plain(img, w)),
        ("stem_bwd_partials",
         lambda: fst.stem_bwd_partials(img, w, g, *vecs9),
         lambda: fst.stem_bwd_partials_plain(img, w, g, *vecs9)),
        ("stem_bwd_final", lambda: fst.stem_bwd_final(img, w, g, *vecs10),
         lambda: fst.stem_bwd_final_plain(img, w, g, *vecs10)))
    scales = stem_train_scales(img, w, g, *vecs10)
    elems = B * H * W * C
    # bytes: each input once, each output once; operations: the 9-term conv
    # (2 * 9 per output) plus the per-position work (K8: z, z^2 and two
    # sums; K9: affine, ReLU, max, routing, xhat, two sums; K10: those, the
    # BatchNorm backward and the 9 weight-gradient products and sums)
    sizes = {"stem_stats": (nbytes(img) + 11 * C * 4, 21 * elems),
             "stem_bwd_partials": (nbytes(img, g) + 15 * C * 4, 30 * elems),
             "stem_bwd_final": (nbytes(img, g) + 25 * C * 4, 50 * elems)}
    dt = img.dtype
    x_nchw = img.permute(0, 3, 1, 2)
    w_lib = w.to(dt).permute(3, 2, 0, 1).contiguous().requires_grad_(True)
    gamma, beta = (t.detach().clone().requires_grad_(True)
                   for t in (state.model.stem_bn.weight,
                             state.model.stem_bn.bias))

    def lib_stats():
        z = F.conv2d(x_nchw, w_lib.detach(), padding=1)
        return torch.var_mean(z, dim=(0, 2, 3), unbiased=False)

    lib_out = F.max_pool2d(torch.relu(F.batch_norm(
        F.conv2d(x_nchw, w_lib, padding=1), None, None, gamma, beta,
        training=True, eps=1e-3)), 2)
    g_nchw = g.permute(0, 3, 1, 2)

    def lib_pair():
        return torch.autograd.grad(lib_out, (w_lib, gamma, beta), g_nchw,
                                   retain_graph=True)

    pair = dict(pair_library_ms=time_ms(lib_pair),
                pair_library_device_ms=device_ms(lib_pair),
                pair_library="the plain stem's backward through autograd "
                             "(cuDNN conv, BatchNorm, ReLU, max-pool) to "
                             "the weights, gamma and beta")
    out = []
    for (name, kern, plain), scale in zip(runs, scales):
        got = kern()
        want = plain()
        torch.cuda.synchronize()
        # f32 sums of up to B * H * W terms in other orders: 1e-5 of the
        # sum of the terms' magnitudes, plus 1e-6
        err = (got - want).abs()
        ok = bool((err <= 1e-5 * scale + 1e-6).all())
        b_ms, b_by = bound_ms(*sizes[name], dtype_name)
        res = dict(kernel=name, dtype=dtype_name, path=path, B=B, H=H, W=W,
                   C=C, max_abs_err=float(err.max()),
                   max_err_over_scale=float((err / scale.clamp(min=1e-30))
                                            .max()),
                   tolerance="1e-5 * sum of |terms| + 1e-6", ok=ok,
                   kernel_ms=time_ms(kern), kernel_device_ms=device_ms(kern),
                   plain_ms=time_ms(plain), bound_ms=b_ms, bound_by=b_by,
                   bytes=sizes[name][0], ops=sizes[name][1],
                   library_ms=None, library_device_ms=None)
        if name == "stem_stats":
            res.update(library_ms=time_ms(lib_stats),
                       library_device_ms=device_ms(lib_stats),
                       library="cuDNN conv2d + torch.var_mean over (N, H, W)",
                       design=stem_design_fields(img, C, "stats"),
                       ptxas=STEM_FWD_PTXAS.get(f"stem_stats {dtype_name}"))
        else:
            res.update(pair, library="none computes it alone; pair_library "
                                     "is K9 + K10's yardstick")
            res["design"] = dict(
                dataclasses.asdict(fst.bwd_design(img, C,
                                                  name == "stem_bwd_final")),
                channels_per_thread=fst.BWD_CPT)
            res["ptxas"] = STEM_BWD_PTXAS.get(f"{name} {dtype_name}")
        out.append(res)
        emit("kernel_check", **res)
        require(ok, f"{name} {dtype_name} ({path}): max error "
                    f"{res['max_abs_err']} beyond {res['tolerance']}")
    # K1 in the training forward (on conv9), fed the batch statistics
    scale, bias = fs.fold_bn(state.model.stem_bn.weight.detach(),
                             state.model.stem_bn.bias.detach(), vecs9[0], var)

    def k1_train():
        return fs._forward(img, w, scale, bias, "conv9")

    pooled = k1_train()
    want = fs.fused_stem_plain(img, w, scale, bias).float()
    torch.cuda.synchronize()
    err = (pooled.float() - want).abs()
    tol, tol_text = stem_tolerance(want, dt == torch.bfloat16)
    ok = bool((err <= tol).all())
    k1_ms, k1_by = bound_ms(nbytes(img, pooled) + 11 * C * 4, 21 * elems,
                            dtype_name)
    # yardstick only: the same function through cuDNN's conv, the affine,
    # ReLU and max-pool, as phase 2's for the serving call
    w_k1 = w.to(dt).permute(3, 2, 0, 1).contiguous()
    s4, b4 = scale.to(dt)[:, None, None], bias.to(dt)[:, None, None]

    def k1_library():
        z = F.conv2d(x_nchw, w_k1, padding=1)
        return F.max_pool2d(torch.relu(z * s4 + b4), 2)

    k1 = dict(dtype=dtype_name, path=path, max_abs_err=float(err.max()),
              tolerance=tol_text, ok=ok, kernel_ms=time_ms(k1_train),
              kernel_device_ms=device_ms(k1_train), bound_ms=k1_ms,
              bound_by=k1_by, library_ms=time_ms(k1_library),
              library_device_ms=device_ms(k1_library),
              library="cudnn conv2d + affine + relu + max_pool2d",
              design=stem_design_fields(img, C, "conv9"),
              ptxas=STEM_FWD_PTXAS.get(f"fused_stem {dtype_name} conv9"))
    K1_TRAIN[(dtype_name, path)] = k1
    emit("k1_train_forward", **k1)
    require(ok, f"fused_stem {dtype_name} conv9 ({path}): max error "
                f"{float(err.max())} beyond {tol_text}")
    return out


def phase_stem_train_kernels(g):
    """Phase 15: K8, K9 and K10 on the training stem's own operands, at
    fonts-small's and fonts-hard's training shapes, bf16 and f32, TF32
    off."""
    checks = []
    for name, key, bucket in STEM_TRAIN_PATHS:
        for dtype_name in ("bfloat16", "float32"):
            _, _, state, _, batch = train_setup(g, dtype_name, 0.0, name, key,
                                                bucket)
            checks += check_stem_train(state, batch, dtype_name, key)
    return checks


# ---- slice 5: the BiLSTM, fonts-hard-lstm (B 256 serving, B 128 training) ----

LSTM_NAME = "fonts-hard-lstm"
LSTM_SERVE_KERNELS = {"fused_stem": 1, "bilstm": 2}
LSTM_TRAIN_KERNELS = dict(
    {k: v for k, v in TRAIN_KERNELS.items()
     if k not in ("bigru_train", "bigru_backward")}, bilstm_train=2)


def torch_lstm_from(rnn, dtype):
    """torch.nn.LSTM (bidirectional, batch_first) with a BiRNN's LSTM
    weights: Keras's gate order i|f|c|o is PyTorch's i|f|g|o; the folded
    bias goes to ``bias_ih``, zeros to ``bias_hh``."""
    import torch

    H = rnn.units
    F = rnn.kernel.shape[1]
    lstm = torch.nn.LSTM(F, H, batch_first=True, bidirectional=True,
                         device=rnn.kernel.device, dtype=dtype)
    with torch.no_grad():
        for d, sfx in ((0, "l0"), (1, "l0_reverse")):
            getattr(lstm, f"weight_ih_{sfx}").copy_(rnn.kernel[d].T)
            getattr(lstm, f"weight_hh_{sfx}").copy_(rnn.recurrent_kernel[d].T)
            getattr(lstm, f"bias_ih_{sfx}").copy_(rnn.bias[d])
            getattr(lstm, f"bias_hh_{sfx}").zero_()
    return lstm.eval()


def lstm_sizes(xw, outs):
    """K4's or K5's bytes (xw, U and the outputs, each once) and operations
    (the recurrent product, and ~20 a unit for four gate adds, three
    sigmoids, two tanh and the c and h updates)."""
    T, _, B, G = xw.shape
    H = G // 4
    return (nbytes(xw, *outs) + 2 * H * G * xw.element_size(),
            2 * T * 2 * B * H * G + 20 * T * 2 * B * H)


def check_bilstm(rnn, feat, dtype_name: str):
    """K4 on layer 0's input projections of the serving path (B 256), as
    the path passes them, against its plain version; nn.LSTM as the
    yardstick."""
    import torch
    from crnn_ocr_torch.kernels import bigru as bg

    dt = rnn.dtype
    xw = rnn.project(feat)
    u = rnn.recurrent_kernel.to(dt).contiguous()
    uk = rnn.u_kernel  # as the main path passes it

    def kernel():
        return bg.bilstm(xw, u, uk)

    got = kernel()
    want = bg.bilstm_plain(xw, u)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    # as K2: outputs in (-1, 1) over 64 dependent steps
    tol = 2e-2 if dtype_name == "bfloat16" else 1e-4
    T, _, B, G = xw.shape
    bytes_moved, ops = lstm_sizes(xw, [got])
    b_ms, b_by, peak_text = rnn_bound(bytes_moved, ops, dtype_name)
    res = dict(
        kernel="bilstm", dtype=dtype_name, T=T, B=B, H=G // 4,
        max_abs_err=err, tolerance=f"{tol} abs", ok=err <= tol,
        kernel_ms=time_ms(kernel), kernel_device_ms=device_ms(kernel),
        plain_ms=time_ms(lambda: bg.bilstm_plain(xw, u)),
        bound_ms=b_ms, bound_by=b_by, bound_peak=peak_text,
        bytes=bytes_moved, ops=ops,
        library="torch.nn.LSTM bidirectional (cuDNN) on the layer input; "
                "its time includes the input projection",
        **design_times("lstm", xw, u, None, uk, False, want),
    )
    # yardstick only: the port never calls torch.nn.LSTM
    lstm = torch_lstm_from(rnn, dt)
    res["library_vs_port_max_abs"] = float(
        (lstm(feat)[0].float() - rnn(feat).float()).abs().max())
    res["library_ms"] = time_ms(lambda: lstm(feat))
    res["library_device_ms"] = device_ms(lambda: lstm(feat))
    emit("kernel_check", **res)
    require(res["ok"], f"bilstm {dtype_name}: max error {err} beyond {tol}")
    return res


def check_bilstm_train(state, batch, dtype_name: str):
    """K5 on layer 0's input projections of the training path (B 128),
    against its plain version; K4 on the same inputs, to price the
    stash."""
    import torch
    from crnn_ocr_torch.kernels import bigru as bg

    m = state.model
    rnn = m.birnn0
    with torch.no_grad():
        feat = m.frame_features(m.backbone(m.stem(batch["x"])))
        xw = rnn.project(feat)
    u = rnn.recurrent_kernel.detach().to(rnn.dtype).contiguous()
    uk = rnn.kernel_operand()
    hs, st = bg.bilstm_train(xw, u, uk)
    with torch.no_grad():
        p_hs, p_st = bg.bilstm_train_plain(xw, u)
    torch.cuda.synchronize()
    bf16 = dtype_name == "bfloat16"
    # as K3: hs 2e-2 (bf16) / 1e-4; the stash carries the same state error
    # through sums of 256 products, and c is not bounded by 1
    hs_err, hs_ok = _close(hs, p_hs, 2e-2 if bf16 else 1e-4, 0.0)
    s_err, s_ok = _close(st, p_st, 3e-2 if bf16 else 1e-4,
                         2e-2 if bf16 else 0.0)
    T, _, B, G = xw.shape
    bytes_moved, ops = lstm_sizes(xw, [hs, st])
    b_ms, b_by, peak_text = rnn_bound(bytes_moved, ops, dtype_name)
    # yardstick only: the port never calls torch.nn.LSTM
    lstm = torch_lstm_from(rnn, rnn.dtype).train()
    feat_g = feat.detach().to(rnn.dtype).requires_grad_(True)
    res = dict(
        kernel="bilstm_train", dtype=dtype_name, T=T, B=B, H=G // 4,
        max_abs_err=max(hs_err, s_err), hs_max_abs_err=hs_err,
        stash_max_abs_err=s_err, ok=hs_ok and s_ok,
        tolerance=("hs 2e-2 abs; stash 3e-2 + 2e-2 * |plain|" if bf16
                   else "hs and stash 1e-4 abs"),
        kernel_ms=time_ms(lambda: bg.bilstm_train(xw, u, uk)),
        kernel_device_ms=device_ms(lambda: bg.bilstm_train(xw, u, uk)),
        k4_same_inputs_ms=time_ms(lambda: bg.bilstm_infer(xw, u, uk)),
        k4_same_inputs_device_ms=device_ms(
            lambda: bg.bilstm_infer(xw, u, uk)),
        plain_ms=time_ms(lambda: bg.bilstm_train_plain(xw, u), reps=5),
        library_ms=time_ms(lambda: lstm(feat_g)),
        library_device_ms=device_ms(lambda: lstm(feat_g)),
        library="torch.nn.LSTM bidirectional (cuDNN), training-mode "
                "forward on the layer input; includes the input projection",
        bound_ms=b_ms, bound_by=b_by, bound_peak=peak_text,
        bytes=bytes_moved, ops=ops,
        **design_times("lstm", xw, u, None, uk, True, p_hs),
    )
    emit("kernel_check", **res)
    require(res["ok"], f"bilstm_train {dtype_name}: hs error {hs_err}, "
                       f"stash error {s_err} beyond {res['tolerance']}")
    return res


def phase_lstm_kernels(g, lines):
    """Phase 18: K4 on the serving path's own tensors (B 256) and K5 on the
    training path's (B 128), bf16 and f32, TF32 off."""
    import torch
    from crnn_ocr_torch import load_pretrained

    checks = []
    for dtype_name in ("bfloat16", "float32"):
        with torch.inference_mode():
            pred = load_pretrained(LSTM_NAME, device="cuda", dtype=dtype_name)
            m = pred.model
            x, _ = pred.preprocess(lines, BUCKET)
            feat = m.frame_features(m.backbone(m.stem(x)))
            checks.append(check_bilstm(m.birnn0, feat, dtype_name))
        _, _, state, _, batch = train_setup(g, dtype_name, 0.0, LSTM_NAME)
        checks.append(check_bilstm_train(state, batch, dtype_name))
    return checks


def phase_lstm_goldens(g, lg):
    """Phase 19: the seeded layers' digest, then ``phase_goldens`` on the
    ``hard`` lines with ``lstm_goldens.npz``'s texts and scores, then the
    probabilities of its first lines against JAX's."""
    import torch
    from crnn_ocr_torch import load_pretrained
    from crnn_ocr_torch.infer.pretrained import model_weights
    from crnn_ocr_torch.infer.weights import rnn_params_digest

    digest = rnn_params_digest(model_weights(LSTM_NAME)[1])
    require(digest == str(lg["lstm_weights_sha256"]),
            f"{LSTM_NAME}: the seeded BiLSTM layers built here ({digest}) "
            "are not the ones the golden was written from")
    gl = {f"lstm_{k}": g[f"hard_{k}"]
          for k in ("canvas", "heights", "widths", "truth")}
    gl.update({k: lg[k] for k in lg.files if k.startswith("lstm_")})
    # every text is empty and every frame's top class (blank) leads the
    # next by at least 4.08 nats in both JAX runs, more than a bf16
    # rounding moves a logit: no bf16 line may differ
    phase_goldens(gl, ((LSTM_NAME, "lstm"),), (LSTM_NAME, "lstm"),
                  bf16_max_off=0)
    n = len(lg["lstm_probs_f32"])
    lines = golden_lines(gl, "lstm")[:n]
    res = {}
    # f32: rtol 1e-4 / atol 2e-5, as tests/test_keras_parity.py; bf16: 5e-2,
    # bf16 noise on probabilities, as tests/test_torch_model.py holds bf16
    for dtype_name, tag, atol, rtol in (("float32", "f32", 2e-5, 1e-4),
                                        ("bfloat16", "bf16", 5e-2, 0.0)):
        pred = load_pretrained(LSTM_NAME, device="cuda", dtype=dtype_name)
        probs, _ = pred.predict_probs(lines, bucket=BUCKET)
        err, ok = _close(probs, torch.from_numpy(lg[f"lstm_probs_{tag}"])
                         .cuda(), atol, rtol)
        res[dtype_name] = dict(lines=n, max_abs_err=err, ok=ok,
                               tolerance=f"{atol} + {rtol} * |jax|")
    emit("golden_probs", model=LSTM_NAME, digest_ok=True, **res)
    require(all(r["ok"] for r in res.values()),
            f"{LSTM_NAME}: probabilities differ from JAX's: {res}")


# ---- phase 23: fonts-small served in its shipped f32 ----

F32_SERVE_KERNELS = {"fused_stem": 1, "bigru": 2}


def phase_f32_small(g, card: str):
    """Phase 23: ``fonts-small`` (n_units 128) in f32, as it ships. K2 at
    its serving shape (B 256, bucket 128, T 32) and K3 at its training
    shape (B 128) on the path's own tensors against their plain versions,
    with the old ``"f32"`` design and ``nn.GRU`` in f32 on the same inputs
    (``check_bigru``, ``check_bigru_train``); then the serving path counted
    at B 256, bucket 128: each ``predict`` must launch K1 once (on
    ``"conv9"``) and K2 twice, every K2 on ``PATH_DESIGN``'s design.
    Returns the two checks and the counted run's launches."""
    import torch
    from crnn_ocr_torch import load_pretrained

    lines = golden_lines(g, SMALL_KEY)
    lines = (lines * (BATCH // len(lines) + 1))[:BATCH]
    with torch.inference_mode():
        pred = load_pretrained(SMALL_NAME, device="cuda")
        m = pred.model
        require(m.dtype == torch.float32,
                f"{SMALL_NAME} ships f32, loaded {m.dtype}")
        x, _ = pred.preprocess(lines, SMALL_BUCKET)
        feat = m.frame_features(m.backbone(m.stem(x)))
        k2 = check_bigru(m, feat, "float32")
    _, _, state, _, batch = train_setup(g, "float32", 0.0, SMALL_NAME,
                                        SMALL_KEY, SMALL_BUCKET)
    k3 = check_bigru_train(state, batch, "float32")
    counts = phase_throughput(card, SMALL_NAME, lines, F32_SERVE_KERNELS,
                              SMALL_BUCKET, "serve_f32")
    return k2, k3, counts


def f32_fields(c: dict) -> dict:
    """An f32 recurrence check's numbers for the kernels line."""
    return {k: c[k] for k in (
        "T", "B", "H", "max_abs_err", "kernel_device_ms", "kernel_ms",
        "plain_ms", "library_ms", "library_device_ms", "bound_ms",
        "bound_by", "bound_peak", "design", "cluster", "rows", "old_f32_ms",
        "old_f32_max_abs_err", "resources") if k in c}


# ---- phase 25: serving by beam (fonts-hard) ----

BEAM_GOLDENS = os.path.join(REPO, "crnn_ocr_torch", "testdata",
                            "beam_goldens.npz")
BEAM_WIDTH, BEAM_TOP_PATHS = 10, 3
BEAM_SERVE = dict(greedy=False, beam_width=BEAM_WIDTH, top_paths=1)


def _tolerance_fields(got, want, rtol: float, atol: float) -> dict:
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    fin = np.isfinite(want)
    rel = np.abs(got[fin] - want[fin]) / (np.abs(want[fin]) + 1e-30)
    return dict(max_rel_err=float(rel.max(initial=0.0)),
                ok=bool(np.array_equal(np.isfinite(got), fin)
                        and np.allclose(got[fin], want[fin], rtol=rtol,
                                        atol=atol)))


def beam_decode_parity(bg, key: str) -> dict:
    """One key's decode-level checks on the card: the device beam (W 10,
    3 paths, both merge modes) against JAX's labels and scores, the C++
    decoder's labels against the same, greedy alignment and forced
    alignment of the beam's top path (merge off) against JAX's."""
    import numpy as np
    import torch
    from crnn_ocr_torch.ops import ctc
    from crnn_ocr_torch.ops.ctc_beam_device import ctc_beam_search_decode_tf
    from crnn_ocr_torch.ops.ctc_beam_exact import (
        ctc_beam_search_decode_exact)

    probs_np, il_np = bg[f"{key}_probs"], bg[f"{key}_input_len"]
    probs = torch.from_numpy(probs_np).cuda()
    il = torch.from_numpy(il_np).cuda()
    res = dict(key=key, lines=len(il_np), T=probs_np.shape[1],
               C=probs_np.shape[2])
    top0 = None
    for merge in (1, 0):
        want = bg[f"{key}_beam_m{merge}_decoded"].astype(np.int32)
        dec, sc = ctc_beam_search_decode_tf(
            probs, il, beam_width=BEAM_WIDTH, top_paths=BEAM_TOP_PATHS,
            merge_repeated=bool(merge))
        require(dec.device.type == "cuda", "the beam left the card")
        dec = dec.cpu().numpy()
        # atol 1e-5 as the greedy gate's: a near-certain line scores near
        # 0, where f32 ulps of the ~-10 terms are ~3e-6 of absolute error
        sc_fields = _tolerance_fields(sc.cpu().numpy(),
                                      bg[f"{key}_beam_m{merge}_scores"],
                                      1e-5, 1e-5)
        host, _ = ctc_beam_search_decode_exact(
            probs_np, il_np, beam_width=BEAM_WIDTH, top_paths=BEAM_TOP_PATHS,
            merge_repeated=bool(merge))
        host_bad = sum(int((h != want[p, :, :h.shape[1]]).any(1).sum()
                           + (want[p, :, h.shape[1]:] != -1).any(1).sum())
                       for p, h in enumerate(host))
        res[f"merge_{merge}"] = dict(
            label_rows_off=int((dec != want).any(2).sum()),
            exact_tf_label_rows_off=host_bad, scores=sc_fields)
        require(np.array_equal(dec, want) and sc_fields["ok"],
                f"{key} merge {merge}: the beam on the card differs from "
                f"JAX's ({res[f'merge_{merge}']})")
        require(host_bad == 0, f"{key} merge {merge}: the C++ decoder's "
                               f"labels differ from JAX's in {host_bad} rows")
        if not merge:
            top0 = torch.from_numpy(dec[0]).cuda()
    checks = (
        ("greedy_align", ("labels", "starts", "ends", "confs"),
         ctc.ctc_greedy_alignment(probs, il)),
        ("forced", ("starts", "ends", "confs", "feasible"),
         ctc.ctc_forced_alignment(probs, il, top0.clamp(min=0),
                                  (top0 >= 0).sum(1))),
    )
    for what, names, outs in checks:
        for n, v in zip(names, outs):
            got, want = v.cpu().numpy(), bg[f"{key}_{what}_{n}"]
            if n == "confs":
                f = _tolerance_fields(got, want, 1e-6, 0.0)
                res[f"{what}_confs_max_rel_err"] = f["max_rel_err"]
                ok = f["ok"]
            else:
                ok = bool(np.array_equal(got, want))
            require(ok, f"{key}: {what} {n} on the card differ from JAX's")
    emit("beam_decode", **res)
    return res


def beam_goldens(g, bg) -> dict:
    """``load_pretrained("fonts-hard").predict(greedy=False)`` end to end
    on the golden lines: f32 texts equal to JAX's beam texts, scores
    within rtol 1e-4 (atol 1e-5), spans (``alignments=True``) equal on
    every line whose text is equal; bf16 at most 1 line in 64 off JAX's
    bf16 beam texts."""
    import numpy as np
    from crnn_ocr_torch import load_pretrained

    lines = golden_lines(g, "hard")
    out = load_pretrained("fonts-hard", device="cuda", dtype="float32") \
        .predict(lines, greedy=False, alignments=True)
    want_t = [str(t) for t in bg["hard_pred_texts_f32"]]
    bad = [(i, o.text, w) for i, (o, w) in enumerate(zip(out, want_t))
           if o.text != w]
    sc = _tolerance_fields([o.score for o in out], bg["hard_pred_scores_f32"],
                           1e-4, 1e-5)
    want_spans = [[] for _ in lines]
    for (i, x0, x1), ch, conf in zip(bg["hard_pred_spans_f32"],
                                     bg["hard_pred_span_chars_f32"],
                                     bg["hard_pred_span_confs_f32"]):
        want_spans[i].append((str(ch), int(x0), int(x1), float(conf)))
    span_bad, conf_err = [], 0.0
    for i, o in enumerate(out):
        if o.text != want_t[i]:
            continue
        got = [(s.char, s.x0, s.x1) for s in o.spans]
        if got != [w[:3] for w in want_spans[i]]:
            span_bad.append(i)
        conf_err = max([conf_err] + [abs(s.conf - w[3]) / w[3] for s, w in
                                     zip(o.spans, want_spans[i])])
    bf16 = load_pretrained("fonts-hard", device="cuda").predict(
        lines, greedy=False)
    want_b = [str(t) for t in bg["hard_pred_texts_bf16"]]
    bf16_bad = [(i, o.text, w) for i, (o, w) in enumerate(zip(bf16, want_b))
                if o.text != w]
    res = dict(lines=len(lines), f32_text_mismatches=bad, f32_scores=sc,
               spans=sum(len(o.spans) for o in out),
               span_mismatch_lines=span_bad, span_conf_max_rel_err=conf_err,
               bf16_text_mismatches=bf16_bad,
               bf16_line_accuracy_vs_truth=float(np.mean(
                   [o.text == str(t) for o, t in zip(bf16,
                                                     g["hard_truth"])])))
    emit("beam_goldens", **res)
    require(not bad and sc["ok"], "fonts-hard f32 beam differs from JAX's")
    require(not span_bad, f"fonts-hard f32 spans differ on lines {span_bad}")
    require(len(bf16_bad) <= 1, f"fonts-hard bf16 beam: {len(bf16_bad)} "
                                "lines differ from JAX's (at most 1 may)")
    return res


def tier_mix(probs, il) -> dict:
    """The share of the decode's frames that each tier answers
    (``ctc_beam_tier_stats``: a frame goes to the first tier that admits
    every sample; the frames past every sample's length are not run), and
    the share of (frame, sample) pairs each tier alone would admit."""
    import torch
    from crnn_ocr_torch.ops.ctc_beam_device import ctc_beam_tier_stats

    cheap, bound = ctc_beam_tier_stats(probs, il, BEAM_WIDTH)[:2]
    n = int(il.max())
    cheap, bound = cheap[:n], bound[:n]
    fast = cheap.all(1)
    by_bound = ~fast & bound.all(1)
    live = torch.arange(n, device=il.device)[:, None] < il[None, :]
    return dict(frames=n, fast=float(fast.float().mean()),
                bound=float(by_bound.float().mean()),
                exact=float((~fast & ~by_bound).float().mean()),
                sample_frames_cheap=float(cheap[live].float().mean()),
                sample_frames_bound=float(bound[live].float().mean()))


def lean_trace(run, kernels=()) -> dict:
    """torch.profiler (host and card) over one ``run()``, read off the raw
    kineto records: building ``prof.events()``'s tree for a beam decode's
    ~60,000 ops took ~30 s on the card machine's host. The wall ms, the
    device's busy ms (the union of kernel and copy intervals), the host's
    waits on the card (synchronize calls; the window's closing one counts),
    the kernel launches with their host ms, and for each name in
    ``kernels`` the device ms of the kernels whose names hold it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(4):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        evs = prof.profiler.kineto_results.events()
        ranges = {e.name() for e in evs if e.is_user_annotation()}
        dev_evs = [e for e in evs
                   if e.device_type() == torch.autograd.DeviceType.CUDA
                   and not e.is_user_annotation()
                   and not is_range_row(e.name(), ranges)]
        spans = sorted((e.start_ns(), e.end_ns()) for e in dev_evs)
        if spans:
            break
    require(bool(spans), "the profiler saw no work on the device")
    busy, end = 0, -1
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    launch = [e.duration_ns() for e in evs if e.name() == "cudaLaunchKernel"]
    return dict(wall_ms=wall, device_busy_ms=busy / 1e6,
                syncs=sum("Synchronize" in e.name() for e in evs),
                kernel_launches=len(launch),
                launch_host_ms=sum(launch) / 1e6,
                kernel_device_ms={k: sum(e.duration_ns() for e in dev_evs
                                         if k in e.name()) / 1e6
                                  for k in kernels})


def decode_split(pred, probs, il, rounds: int = 2) -> dict:
    """The beam decode stage alone on the counted run's probabilities, at
    B 256 and on the first 16 lines (a small batch, where the fast tier
    answers more frames): the path's tier ladder beside the exact tier on
    every frame (no host test a frame; its output must be the same bit for
    bit), timed in turns (ladder, exact, exact, ladder, ...: the host's
    speed drifts within a call), wall ms a call (median, synchronized),
    then one traced call each: the device busy ms, the rest of the wall
    (the card waiting on the host) and the host's syncs."""
    import contextlib

    import torch
    from crnn_ocr_torch.ops import ctc_beam_device as dev

    def exact_every_frame(p, W, C):
        return dev._slow_path(p, dev._evict_counts(p, W, C), W, C)

    @contextlib.contextmanager
    def dispatch(name):
        ladder = dev._tier_dispatch
        if name == "exact_every_frame":
            dev._tier_dispatch = exact_every_frame
        try:
            yield
        finally:
            dev._tier_dispatch = ladder

    def timed(name, probs, il):
        with dispatch(name):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pred.decode(probs, il, **BEAM_SERVE)
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    names = ("ladder", "exact_every_frame")
    res = {}
    for key, n in (("b256", len(il)), ("b16", 16)):
        p_, il_ = probs[:n], il[:n]
        want = dev.ctc_beam_search_decode_tf(p_, il_, BEAM_WIDTH)
        with dispatch("exact_every_frame"):
            got = dev.ctc_beam_search_decode_tf(p_, il_, BEAM_WIDTH)
        require(all(torch.equal(a, b) for a, b in zip(got, want)),
                "the exact tier on every frame decodes otherwise than the "
                "ladder")
        walls = {name: [] for name in names}
        for r in range(rounds):
            for name in (names if r % 2 == 0 else names[::-1]):
                walls[name].append(timed(name, p_, il_))
        res[key] = {}
        for name in names:
            with dispatch(name):
                tr = lean_trace(lambda: pred.decode(p_, il_, **BEAM_SERVE))
            wall = statistics.median(walls[name])
            res[key][name] = dict(wall_ms=wall, walls=walls[name],
                                  device_ms=tr["device_busy_ms"],
                                  host_ms=wall - tr["device_busy_ms"],
                                  trace=tr)
    return res


def phase_beam(card: str, g, greedy_serve: dict) -> None:
    """Phase 25: serving by beam. Decode-level parity on the card
    (``fonts-hard`` and ``fonts-small``), the end-to-end goldens, then
    ``fonts-hard`` counted at B 256, bucket 256, bf16, W 10, one path (each
    ``predict``: K1 once on ``"mma"``, K2 twice on ``"resident"``), with
    the decode stage split into device and host ms, the tier mix and the
    C++ decoder's time on the same probabilities, beside phase 4's greedy
    numbers."""
    import numpy as np
    from crnn_ocr_torch import load_pretrained
    from crnn_ocr_torch.ops.ctc_beam_exact import (
        ctc_beam_search_decode_exact)

    secs = {}
    t0 = time.perf_counter()

    def lap(key):
        nonlocal t0
        t1 = time.perf_counter()
        secs[key] = t1 - t0
        t0 = t1

    bg = np.load(BEAM_GOLDENS)
    for key in ("hard", "small"):
        beam_decode_parity(bg, key)
    lap("decode_parity")
    beam_goldens(g, bg)
    lap("goldens")
    lines = golden_lines(g, "hard")
    lines = (lines * (BATCH // len(lines) + 1))[:BATCH]
    # a beam batch takes ~0.5-1 s of host time: fewer calls than phase
    # 4's, and its trace is the decode's (decode_split)
    serve = phase_throughput(card, "fonts-hard", lines,
                             {"fused_stem": 1, "bigru": 2},
                             decode_kw=BEAM_SERVE, reps=5, stage_reps=5,
                             trace_n=0)
    lap("counted")
    pred = load_pretrained("fonts-hard", device="cuda")
    probs, il = pred.predict_probs(lines, bucket=BUCKET)
    mix = tier_mix(probs, il)
    mix["b16"] = tier_mix(probs[:16], il[:16])
    lap("tier_mix")
    split = decode_split(pred, probs, il)
    lap("decode_split")
    probs_h, il_h = probs.float().cpu().numpy(), il.cpu().numpy()
    exact_ms = []
    for _ in range(3):
        t1 = time.perf_counter()
        ctc_beam_search_decode_exact(probs_h, il_h, beam_width=BEAM_WIDTH,
                                     merge_repeated=False)
        exact_ms.append((time.perf_counter() - t1) * 1e3)
    lap("exact_tf")
    tp = serve["throughput"]
    emit("beam_serving", model="fonts-hard", dtype=tp["dtype"], batch=BATCH,
         bucket=BUCKET, beam_width=BEAM_WIDTH, top_paths=1,
         lines_per_s=tp["lines_per_s"], p50_batch_ms=tp["p50_batch_ms"],
         stage_ms=tp["stage_ms"], decode=split["b256"]["ladder"],
         syncs_per_iteration=split["b256"]["ladder"]["trace"]["syncs"],
         dispatch=split, tier_mix=mix,
         exact_tf_ms=statistics.median(exact_ms),
         design=[*serve["design"][0], serve["design"][1]],
         stem_design=serve["stem_design"],
         greedy=dict(lines_per_s=greedy_serve["lines_per_s"],
                     p50_batch_ms=greedy_serve["p50_batch_ms"],
                     decode_ms=greedy_serve["stage_ms"]["decode"]),
         seconds=secs, card=card)


# ---- slice 16: the serving daemon, reference artifacts and the CLIs ----

SERVE_GOLDENS = os.path.join(REPO, "crnn_ocr_torch", "testdata",
                             "serve_goldens.npz")
MIGRATIONS = ("migration_autonamed", "migration_autonamed_stn")
# phase 26's counted daemon: 64 clients, each of the 64 golden lines
# DAEMON_REPEATS times (greedy) and BEAM_DAEMON_REPEATS times (beam); the
# profiled window's requests; the serve CLI's requests (the lines repeated)
DAEMON_CLIENTS, DAEMON_REPEATS, BEAM_DAEMON_REPEATS = 64, 32, 8
TRACE_REQUESTS, CLI_REPEATS = 512, 8


def canvas_variants(image) -> list:
    """The canvases a line can meet in a batch, as (pad_h, pad_w): the
    canvas is the batch's largest height and width snapped up
    ``quantize_dim``'s ladder (``pack_canvas(quantize=True)``), and the
    resize reads the canvas's first row and column past the line when there
    is one (white). So a line is padded on both axes unless its height or
    width lies on the ladder and it is the batch's tallest or widest."""
    from crnn_ocr_torch.ops.preprocess import quantize_dim

    h, w = image.shape[:2]
    hs = [True] + ([False] if quantize_dim(h) == h else [])
    ws = [True] + ([False] if quantize_dim(w) == w else [])
    return [(ph, pw) for ph in hs for pw in ws]


def padded_batch(image, pad_h: bool, pad_w: bool) -> list:
    """``[image, filler]``: a white filler that gives the line the canvas
    ``(pad_h, pad_w)`` names (one of ``canvas_variants(image)``)."""
    import numpy as np

    h, w = image.shape[:2]
    return [image, np.full((h + 1 if pad_h else 1, w + 1 if pad_w else 1),
                           255, np.uint8)]


def batch_padding(images) -> list:
    """Each image's (pad_h, pad_w) in a batch of ``images``."""
    from crnn_ocr_torch.ops.preprocess import quantize_dim

    Hm = quantize_dim(max(im.shape[0] for im in images))
    Wm = quantize_dim(max(im.shape[1] for im in images))
    return [(im.shape[0] < Hm, im.shape[1] < Wm) for im in images]


class PaddingLog:
    """Wraps a predictor's ``predict`` (the batcher's one call into it) to
    record each image's canvas padding, keyed by its bytes: a daemon's
    batches are whatever arrived together, and a line's canvas is theirs."""

    def __init__(self, pred):
        self.seen: dict = {}
        self._predict = pred.predict
        pred.predict = self

    def __call__(self, images, **kw):
        for im, pad in zip(images, batch_padding(images)):
            self.seen[(im.shape, im.tobytes())] = pad
        return self._predict(images, **kw)

    def of(self, image):
        return self.seen[(image.shape, image.tobytes())]


def npy_payload(img) -> bytes:
    import io

    import numpy as np

    buf = io.BytesIO()
    np.save(buf, img)
    return buf.getvalue()


def post(url: str, data: bytes, timeout: float = 120.0):
    """One POST: (status, JSON body, client ms). An HTTP error's status and
    body come back too; other failures raise."""
    import urllib.error
    import urllib.request

    t0 = time.perf_counter()
    req = urllib.request.Request(url, data=data, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            status, body = r.status, r.read()
    except urllib.error.HTTPError as e:
        status, body = e.code, e.read()
    return status, json.loads(body), (time.perf_counter() - t0) * 1e3


def get(url: str, timeout: float = 30.0):
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.headers.get("Content-Type", ""), r.read().decode()


def fire(url: str, payloads, clients: int) -> dict:
    """``payloads`` posted to ``url`` by ``clients`` threads at once, each
    taking the next payload when its reply is in: the replies in order,
    each request's client ms, and the wall seconds."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(clients) as ex:
        out = list(ex.map(lambda p: post(url, p), payloads))
    wall = time.perf_counter() - t0
    return dict(replies=[(s, b) for s, b, _ in out],
                client_ms=[ms for _, _, ms in out], wall_s=wall)


def client_fields(run: dict) -> dict:
    import numpy as np

    ms = np.asarray(run["client_ms"])
    return dict(requests=len(ms), req_per_s=len(ms) / run["wall_s"],
                wall_s=run["wall_s"],
                client_p50_ms=float(np.percentile(ms, 50)),
                client_p95_ms=float(np.percentile(ms, 95)))


def variant_of(sg, log, lines) -> list:
    """Each line's row of ``serve_goldens.npz``'s ``cond_*`` arrays: the
    canvas ``log`` (a ``PaddingLog``) saw it in."""
    index = {(int(i), bool(h), bool(w)): k for k, (i, h, w) in enumerate(
        zip(sg["cond_line"], sg["cond_pad_h"], sg["cond_pad_w"]))}
    return [index[(i, *log.of(im))] for i, im in enumerate(lines)]


def reply_gate(replies, texts, scores, rtol: float, atol: float) -> dict:
    """Replies (all 200) against per-line texts (equal) and scores."""
    import numpy as np

    require(all(s == 200 for s, _ in replies),
            f"replies not all 200: {[s for s, _ in replies if s != 200]}")
    got_t = [b["text"] for _, b in replies]
    bad = [(i, a, str(b)) for i, (a, b) in enumerate(zip(got_t, texts))
           if a != str(b)]
    fields = _tolerance_fields([b["score"] for _, b in replies], scores,
                               rtol, atol)
    return dict(lines=len(replies), text_mismatches=bad,
                max_score_rel_err=fields["max_rel_err"],
                scores_ok=fields["ok"])


def daemon_gates(g, sg) -> list:
    """Phase 26 (a): ``fonts-hard`` in f32 behind the daemon, the 64 lines
    from 16 client threads at once, greedy, then by beam, then greedy with
    alignments: each reply against JAX's output for its line on the canvas
    its batch gave it (``serve_goldens.npz``'s ``cond_*``; texts and spans
    equal, scores rtol 1e-4 / atol 1e-5, confidences within 1e-4); then
    ``predict_many`` against JAX's ``predict_many``. Returns the greedy
    daemon's texts."""
    import numpy as np
    from crnn_ocr_torch import load_pretrained
    from crnn_ocr_torch.serve import OCRServer

    lines = golden_lines(g, "hard")
    payloads = [npy_payload(im) for im in lines]
    pred = load_pretrained("fonts-hard", device="cuda", dtype="float32")
    buckets = [pred.bucket_for(im) for im in lines]
    require(buckets == sg["bucket"].tolist(),
            "bucket_for differs from JAX's on the golden lines")
    merge = pred.default_merge_repeated  # the serve CLI's default
    modes = (("greedy", {}), ("beam", dict(
        greedy=False, beam_width=10, top_paths=1, merge_repeated=merge)),
        ("greedy_align", {"greedy": True, "alignments": True}))
    log = PaddingLog(pred)
    out, texts = {}, None
    for mode, kw in modes:
        log.seen.clear()
        srv = OCRServer(pred, host="127.0.0.1", port=0, max_batch=32,
                        max_wait_ms=20, decode_kw=kw).start()
        try:
            base = f"http://127.0.0.1:{srv.port}"
            run = fire(base + "/predict", payloads, 16)
            snap = srv.batcher.stats.snapshot()
            key = "beam" if mode == "beam" else "greedy"
            ks = variant_of(sg, log, lines)
            gate = reply_gate(run["replies"], sg[f"cond_{key}_texts_f32"][ks],
                              sg[f"cond_{key}_scores_f32"][ks], 1e-4, 1e-5)
            res = dict(gate, batches=snap["batches"],
                       mean_batch_size=snap["mean_batch_size"],
                       unpadded_lines=sum(not (sg["cond_pad_h"][k]
                                               and sg["cond_pad_w"][k])
                                          for k in ks),
                       **client_fields(run))
            if mode == "greedy":
                texts = [b["text"] for _, b in run["replies"]]
                res["healthz"] = json.loads(get(base + "/healthz")[2])
                stats = json.loads(get(base + "/stats")[2])
                _, ctype, metrics = get(base + "/metrics")
                status, body, _ = post(base + "/predict", b"garbage")
                res.update(stats=stats, garbage_status=status,
                           garbage_error=body.get("error"))
                require(res["healthz"] == {"ok": True}
                        and stats["requests"] == 64
                        and ctype.startswith("text/plain")
                        and "ocr_requests_total 64" in metrics
                        and status == 400,
                        f"daemon endpoints: {res}, {metrics!r}")
            if mode == "greedy_align":
                spans = [(i, s) for i, (_, b) in enumerate(run["replies"])
                         for s in b["alignments"]]
                got = [(i, s["char"], s["x0"], s["x1"]) for i, s in spans]
                line_of = {k: i for i, k in enumerate(ks)}
                rows = [j for j, k in enumerate(sg["cond_align_spans_f32"]
                                                [:, 0]) if k in line_of]
                rows.sort(key=lambda j: line_of[
                    sg["cond_align_spans_f32"][j, 0]])
                want = [(line_of[int(k)], str(sg["cond_align_chars_f32"][j]),
                         int(x0), int(x1)) for j, (k, x0, x1) in
                        ((j, sg["cond_align_spans_f32"][j]) for j in rows)]
                conf_err = np.abs(np.array([s["conf"] for _, s in spans])
                                  - sg["cond_align_confs_f32"][rows]) if (
                    len(spans) == len(want)) else np.array([np.inf])
                res.update(spans=len(got), spans_equal=got == want,
                           max_conf_err=float(conf_err.max(initial=0.0)))
        finally:
            srv.stop()
        out[mode] = res
        emit("daemon_gate", mode=mode, **res)
        require(not res["text_mismatches"] and res["scores_ok"],
                f"daemon {mode} f32 differs from JAX's predict_many")
        require(mode != "greedy_align" or (res["spans_equal"]
                                           and res["max_conf_err"] <= 1e-4),
                "daemon alignments differ from JAX's")
    many = pred.predict_many(lines, batch_size=64)
    out["predict_many"] = reply_gate([(200, {"text": p.text,
                                             "score": p.score})
                                      for p in many],
                                     sg["greedy_texts_f32"],
                                     sg["greedy_scores_f32"], 1e-4, 1e-5)
    require(not out["predict_many"]["text_mismatches"]
            and out["predict_many"]["scores_ok"],
            "predict_many f32 differs from JAX's")
    emit("daemon_gates", model="fonts-hard", dtype="float32", clients=16,
         max_batch=32, max_wait_ms=20, beam_merge_repeated=merge,
         buckets=dict(collections.Counter(buckets)),
         predict_many=out["predict_many"])
    return texts


def daemon_counted(card: str, g, decode_kw: dict, repeats: int,
                   detail: bool) -> dict:
    """Phase 26 (b): ``fonts-hard`` as shipped (bf16) behind
    ``OCRServer(max_batch=256, max_wait_ms=5)``, after ``batcher.warmup()``;
    the launch counts set to 0, then the 64 lines ``repeats`` times from 64
    client threads: K1 once (``"mma"``) and K2 twice (``"resident"``) per
    batch, every reply's text one of ``reference_texts``' for its line (the
    line alone through ``Predictor.predict`` on the same predictor, on each
    canvas it can meet) with at most one reply in 64 off; req/s, client and
    server percentiles, mean batch size, padded rows, launches by design,
    and (``detail``) the device's idle share over a profiled window of
    further requests and ``daemon_split``'s."""
    from crnn_ocr_torch import load_pretrained
    from crnn_ocr_torch.kernels import bigru, fused_stem
    from crnn_ocr_torch.serve import OCRServer

    lines = golden_lines(g, "hard")
    payloads = [npy_payload(im) for im in lines]
    pred = load_pretrained("fonts-hard", device="cuda")
    srv = OCRServer(pred, host="127.0.0.1", port=0, max_batch=256,
                    max_wait_ms=5, decode_kw=decode_kw)
    t0 = time.perf_counter()
    srv.batcher.warmup()
    torch_sync()
    warmup_s = time.perf_counter() - t0
    srv.start()
    try:
        url = f"http://127.0.0.1:{srv.port}/predict"
        reset_launches()
        run = fire(url, payloads * repeats, DAEMON_CLIENTS)
        counts = read_launches()
        snap = srv.batcher.stats.snapshot()
        designs = {f"{d.name} C{d.cluster} R{d.rows}": n
                   for d, n in bigru.design_launches.items() if n}
        stem = dict(fused_stem.design_launches)
        n = snap["batches"]
        require_launches(counts, {"fused_stem": n, "bigru": 2 * n},
                         f"daemon ({n} batches)")
        require(all(k.startswith(PATH_DESIGN["bigru"] + " ")
                    for k in designs), f"daemon: K2 on {designs}")
        read_stem_design(counts, "serve", "daemon")
        trace_fields = {}
        if detail:
            sub = (payloads * (TRACE_REQUESTS // len(payloads) + 1))[
                :TRACE_REQUESTS]
            summary = _trace_summary(*profiled(
                lambda: fire(url, sub, DAEMON_CLIENTS)), TRACE_REQUESTS)
            trace_fields = dict(trace_per_request=summary,
                                split=daemon_split(srv, pred, lines * repeats,
                                                   snap["mean_batch_size"]))
    finally:
        srv.stop()
    require(snap["requests"] == len(payloads) * repeats
            and snap["errors"] == 0, f"daemon stats {snap}")
    require(all(s == 200 for s, _ in run["replies"]), "daemon: a reply "
                                                      "was not 200")
    ref = reference_texts(pred, lines, decode_kw)
    texts = [b["text"] for _, b in run["replies"]]
    off = [i for i, t in enumerate(texts) if t not in ref[i % len(lines)]]
    off_lines = sorted({i % len(lines) for i in off})
    res = dict(model="fonts-hard", dtype="bfloat16",
               decode=decode_kw or {"greedy": True},
               clients=DAEMON_CLIENTS, max_batch=256, max_wait_ms=5,
               warmup_s=warmup_s, **client_fields(run),
               server_p50_ms=snap["latency_ms_p50"],
               server_p95_ms=snap["latency_ms_p95"],
               batches=n, mean_batch_size=snap["mean_batch_size"],
               padded_rows=snap["padded_rows"],
               launches=dict(fused_stem=counts["fused_stem"],
                             bigru=counts["bigru"]),
               k2_designs=designs, k1_designs=stem,
               replies_off_single=len(off), lines_off_single=off_lines,
               card=card, **trace_fields)
    emit("daemon_serving", **res)
    require(len(off) <= len(texts) // 64, f"daemon: {len(off)} replies "
                                          "differ from single-line predict")
    return dict(res, reference=ref)


def daemon_split(srv, pred, images, mean_batch: float) -> dict:
    """Where the daemon's time goes: ``images`` through the same batcher
    without HTTP (``DAEMON_CLIENTS`` threads calling ``predict_sync``), and
    through ``predict_many`` alone on this thread at the daemon's mean
    batch (no threads, no window): each one's lines/s."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(DAEMON_CLIENTS) as ex:
        list(ex.map(lambda im: srv.batcher.predict_sync(im, timeout=120),
                    images))
    direct_s = time.perf_counter() - t0
    batch = max(1, round(mean_batch))
    t0 = time.perf_counter()
    pred.predict_many(images, batch_size=batch)
    torch_sync()
    alone_s = time.perf_counter() - t0
    return dict(requests=len(images),
                batcher_no_http_req_per_s=len(images) / direct_s,
                predict_many_lines_per_s=len(images) / alone_s,
                predict_many_batch=batch)


def reference_texts(pred, lines, decode_kw: dict) -> list:
    """Each line's texts from ``pred.predict`` of the line alone at its
    bucket, on each canvas it can meet in a batch (``canvas_variants``;
    the canvas set by a white filler row)."""
    return [{pred.predict(padded_batch(im, ph, pw),
                          bucket=pred.bucket_for(im), **decode_kw)[0].text
             for ph, pw in canvas_variants(im)} for im in lines]


def torch_sync() -> None:
    import torch

    torch.cuda.synchronize()


def migration_on_card() -> dict:
    """Phase 26 (c): the reference artifact directories through
    ``init_predictor`` on the card; the forward pass on ``io.npz``'s input
    (f32, TF32 off) against Keras's output at rtol 1e-4 / atol 2e-5."""
    import numpy as np
    import torch
    from crnn_ocr_torch.infer import init_predictor
    from crnn_ocr_torch.kernels import bigru, fused_stem

    out = {}
    for name in MIGRATIONS:
        mig = os.path.join(REPO, "tests", "goldens", name)
        data = np.load(os.path.join(mig, "io.npz"))
        pred = init_predictor(mig, device="cuda")
        reset_launches()
        with torch.inference_mode():
            y = torch.softmax(pred.model(torch.from_numpy(
                data["x"][..., 0]).to(pred.device)), -1).cpu().numpy()
        torch.cuda.synchronize()
        counts = {k: v for k, v in read_launches().items() if v}
        fields = _tolerance_fields(y, data["y"], 1e-4, 2e-5)
        out[name] = dict(
            max_abs_err=float(np.abs(y - data["y"]).max()), **fields,
            default_merge_repeated=pred.default_merge_repeated,
            width=pred.cfg.width, buckets=list(pred.buckets),
            n_units=pred.cfg.n_units, launches=counts,
            k2_designs={f"{d.name} C{d.cluster} R{d.rows}": n
                        for d, n in bigru.design_launches.items() if n},
            k1_designs=dict(fused_stem.design_launches))
        want = {"fused_stem": 1, "bigru": pred.cfg.rnn_layers}
        if pred.cfg.use_stn:
            want["grid_sample"] = 1
        require_launches(counts, want, name)
        require(fields["ok"] and pred.default_merge_repeated,
                f"{name} on the card: {out[name]}")
    emit("migration", shapes="io.npz x (3, 32, 64), f32, TF32 off", **out)
    return out


def serve_cli(g, ref_texts) -> dict:
    """Phase 26 (d): ``python -m crnn_ocr_torch.cli.serve --pretrained
    fonts-hard --port 0 --max_batch 64`` as a subprocess (it loads the
    kernels phase 1 built); the 64 lines ``CLI_REPEATS`` times from 64
    threads of this process, ``/metrics`` read, then SIGTERM: rc 0,
    ``shutting down``, every reply 200, texts at most one line in 64 off
    ``ref_texts`` (each line's set, ``reference_texts``)."""
    import queue
    import signal
    import threading

    lines = golden_lines(g, "hard")
    env = dict(os.environ, PYTHONPATH=REPO)
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "crnn_ocr_torch.cli.serve", "--pretrained",
         "fonts-hard", "--port", "0", "--host", "127.0.0.1", "--max_batch",
         "64"], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    out_lines: "queue.Queue[str]" = queue.Queue()
    reader = threading.Thread(
        target=lambda: [out_lines.put(ln) for ln in proc.stdout], daemon=True)
    reader.start()
    log = []
    try:
        port = None
        deadline = time.perf_counter() + 300
        while port is None:
            ln = out_lines.get(timeout=max(deadline - time.perf_counter(),
                                           0.1))
            log.append(ln.rstrip())
            if ln.startswith("serving on "):
                port = int(ln.split()[2].split(":")[1])
        ready_s = time.perf_counter() - t0
        base = f"http://127.0.0.1:{port}"
        run = fire(base + "/predict",
                   [npy_payload(im) for im in lines] * CLI_REPEATS,
                   DAEMON_CLIENTS)
        _, _, metrics = get(base + "/metrics")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        reader.join(timeout=30)  # its output's last lines
        proc.stdout.close()
    while not out_lines.empty():
        log.append(out_lines.get_nowait().rstrip())
    texts = [b["text"] for _, b in run["replies"]]
    off = sorted({i % len(lines) for i, t in enumerate(texts)
                  if t not in ref_texts[i % len(lines)]})
    res = dict(rc=rc, ready_s=ready_s, **client_fields(run),
               statuses=dict(collections.Counter(s for s, _ in
                                                 run["replies"])),
               lines_off=off, metrics=[m for m in metrics.splitlines()
                                       if not m.startswith("#")],
               log=[ln for ln in log if ln.startswith(("warmup", "serving",
                                                        "shutting"))])
    emit("serve_cli", **res)
    require(rc == 0 and "shutting down" in log
            and all(s == 200 for s, _ in run["replies"])
            and f"ocr_requests_total {len(texts)}" in metrics,
            f"serve CLI: rc {rc}, log {log[-5:]}")
    require(len(off) <= 1, f"serve CLI: lines {off} differ")
    return res


def predict_cli(g, f32_texts) -> dict:
    """Phase 26 (e): where cv2 imports, ``cli.predict.main`` on a temporary
    directory of the 64 lines as PNGs with ``--annotation`` and
    ``--validate`` (greedy, as shipped: bf16): its rows equal to
    ``predict_many``'s texts on the same model and at most one line in 64
    off (a)'s f32 texts. Without cv2 a line says so, and ``predict_many``
    runs alone."""
    import contextlib
    import io
    import tempfile

    from crnn_ocr_torch import load_pretrained

    lines = golden_lines(g, "hard")
    many = [p.text for p in load_pretrained(
        "fonts-hard", device="cuda").predict_many(lines, batch_size=64)]
    try:
        import cv2
    except ImportError:
        res = dict(cv2=False, predict_many_lines_off_f32=sum(
            a != b for a, b in zip(many, f32_texts)))
        emit("predict_cli", **res)
        require(res["predict_many_lines_off_f32"] <= 1,
                "predict_many differs from the f32 texts")
        return res
    from crnn_ocr_torch.cli import predict as predict_mod

    truth = [str(t) for t in g["hard_truth"]]
    with tempfile.TemporaryDirectory() as d:
        names = [f"l{i:02d}.png" for i in range(len(lines))]
        for name, im in zip(names, lines):
            require(cv2.imwrite(os.path.join(d, name), im), "imwrite")
        with open(os.path.join(d, "annotation.txt"), "w") as f:
            f.write("\n".join(f"{n}\t{t}" for n, t in zip(names, truth)))
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc = predict_mod.main([
                "--pretrained", "fonts-hard", "--image_dir", d,
                "--annotation", "annotation.txt", "--validate", "--greedy",
                "--result", os.path.join(d, "out.tsv")])
        with open(os.path.join(d, "out.tsv")) as f:
            rows = [r.split("\t") for r in f.read().splitlines()]
    texts = [r[1] if len(r) > 1 else "" for r in rows]
    res = dict(cv2=True, rc=rc, rows=len(rows),
               names_in_order=[r[0] for r in rows] == names,
               rows_off_predict_many=sum(a != b for a, b in
                                         zip(texts, many)),
               lines_off_f32=sum(a != b for a, b in zip(texts, f32_texts)),
               stderr=err.getvalue().strip().splitlines())
    emit("predict_cli", **res)
    require(rc == 0 and len(rows) == len(lines) and res["names_in_order"]
            and res["rows_off_predict_many"] == 0
            and res["lines_off_f32"] <= 1
            and any(ln.startswith("CER") for ln in res["stderr"]),
            f"predict CLI: {res}")
    return res


def phase_daemon(card: str, g) -> None:
    """Phase 26: the serving daemon, reference artifacts and the CLIs."""
    import numpy as np

    sg = np.load(SERVE_GOLDENS)
    secs = {}
    t0 = time.perf_counter()

    def lap(key):
        nonlocal t0
        t1 = time.perf_counter()
        secs[key] = t1 - t0
        t0 = t1

    f32_texts = daemon_gates(g, sg)
    lap("gates")
    greedy = daemon_counted(card, g, {}, DAEMON_REPEATS, detail=True)
    lap("counted_greedy")
    daemon_counted(card, g, BEAM_SERVE, BEAM_DAEMON_REPEATS, detail=False)
    lap("counted_beam")
    migration_on_card()
    lap("migration")
    serve_cli(g, greedy["reference"])
    lap("serve_cli")
    predict_cli(g, f32_texts)
    lap("predict_cli")
    emit("daemon_seconds", **secs)


# ---- phase 27: fine-tuning fonts-hard-lstm from image files ----

FILES_COPIES = 16  # names per golden line: 64 x 16 = 1,024 files
FILES_BUCKETS = (64, 128, 192, 256)
FILES_VAL = 0.125
FILES_LR = 1e-3  # a new BiLSTM head: the training default, not phase 22's
FILES_STEPS, FILES_EVAL_EVERY, FILES_LOG_EVERY = 360, 60, 10
FILES_RESUME_K = 9  # resume at step 9 of 18: an epoch is 6 batches
# per evaluation batch: the served forward (K1 on "mma", 2 K4) and the loss
FILES_EVAL_KERNELS = {"fused_stem": 1, "bilstm": 2, "ctc_alpha": 1}
RESUME_RTOL, RESUME_ATOL = 2e-4, 2e-5  # phase 7's parameter tolerance
OTHER_OPTIMIZERS = ("sgd", "rmsprop", "adadelta", "adamw")


def write_corpus(g, d: str):
    """Phase 27 (a): each of the 64 ``fonts-hard`` golden lines cropped
    from the canvas by its height and width, written with ``cv2.imwrite``
    as PNG under 16 names, and ``annotation.txt`` of ``<name>\\t<truth>``.
    Returns the lines and their texts."""
    import cv2

    lines = golden_lines(g, "hard")
    truth = [str(t) for t in g["hard_truth"]]
    rows = []
    for c in range(FILES_COPIES):
        for i, (im, text) in enumerate(zip(lines, truth)):
            name = f"c{c:02d}_l{i:02d}.png"
            require(cv2.imwrite(os.path.join(d, name), im), f"imwrite {name}")
            rows.append(f"{name}\t{text}")
    with open(os.path.join(d, "annotation.txt"), "w") as f:
        f.write("\n".join(rows) + "\n")
    return lines, truth


def reader_host_ms(reader) -> dict:
    """The reader's host ms per training batch over one epoch with the pack
    cache cold (planning decodes and packs every image once) and over the
    next, warm (batches from the mmap shards), and each split's batches by
    bucket."""
    out = {}
    for key in ("cold", "warm"):
        buckets = collections.Counter()
        t0 = time.perf_counter()
        for b in reader.run_generator(train=True, epochs=1):
            buckets[int(b["bucket"])] += 1
        n = sum(buckets.values())
        out[f"{key}_ms_per_batch"] = (time.perf_counter() - t0) * 1e3 / n
    out["train_batches_by_bucket"] = dict(sorted(buckets.items()))
    out["eval_batches_by_bucket"] = dict(sorted(collections.Counter(
        int(b["bucket"]) for b in reader.run_generator(train=False,
                                                       epochs=1)).items()))
    return out


def state_tensors(state) -> dict:
    """Every tensor a checkpoint holds: the model's state_dict and the
    optimizer's slots and step counts, by name."""
    out = {f"model/{k}": v for k, v in state.model.state_dict().items()}
    for i, slots in state.optimizer.state_dict()["state"].items():
        out.update({f"optimizer/{i}/{k}": v for k, v in slots.items()})
    return out


def compare_states(a, b) -> dict:
    """Bit-equality of two states' tensors and steps; where they differ,
    the largest difference, its tensor, and whether every tensor is within
    the resume tolerance."""
    import numpy as np

    ta, tb = state_tensors(a), state_tensors(b)
    require(ta.keys() == tb.keys(), "the states hold different tensors")
    worst, where, close = 0.0, None, True
    for k in ta:
        x = ta[k].detach().float().cpu().numpy()
        y = tb[k].detach().float().cpu().numpy()
        if np.array_equal(x, y):
            continue
        d = float(np.max(np.abs(x - y)))
        if d > worst:
            worst, where = d, k
        close = close and bool(np.allclose(x, y, rtol=RESUME_RTOL,
                                           atol=RESUME_ATOL))
    bitwise = where is None and a.step == b.step
    return dict(bitwise=bitwise, steps=[a.step, b.step], max_abs_diff=worst,
                max_diff_tensor=where, within_tolerance=close
                and a.step == b.step)


def files_fit(card: str, reader, cfg, codec, fresh, tmp: str) -> dict:
    """Phase 27 (b): ``fit`` from the files path (``device_batches`` with
    ``prefetch=2`` over ``reader.run_generator``) with ``checkpoint_dir``,
    an evaluation every ``FILES_EVAL_EVERY`` steps and ``profile_dir``,
    counted; then one checkpoint's save and restore timed."""
    import torch
    from crnn_ocr_torch.data.pipeline import device_batches
    from crnn_ocr_torch.kernels import bigru, fused_stem
    from crnn_ocr_torch.train import CheckpointManager, FitConfig, fit

    n_eval = reader.steps_per_epoch(train=False)
    evals = []

    def eval_iter():
        evals.append(0)
        for b in device_batches(reader.run_generator(train=False, epochs=1),
                                "cuda", cfg, prefetch=0):
            evals[-1] += 1
            yield b

    ck, trace_dir = os.path.join(tmp, "ckpt"), os.path.join(tmp, "trace")
    metrics_path = os.path.join(tmp, "fit.jsonl")
    state = fresh()
    stream = device_batches(reader.run_generator(train=True), "cuda", cfg,
                            prefetch=2)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    state = fit(state, cfg, stream, eval_iter, codec, FitConfig(
        steps=FILES_STEPS, eval_every=FILES_EVAL_EVERY, eval_batches=n_eval,
        log_every=FILES_LOG_EVERY, metrics_path=metrics_path,
        checkpoint_dir=ck, profile_dir=trace_dir))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stream.close()
    counts = read_launches()
    what = f"{LSTM_NAME} from files: {FILES_STEPS} steps"
    n_ev = sum(evals)
    want = {k: v * FILES_STEPS for k, v in LSTM_TRAIN_KERNELS.items()}
    for k, v in FILES_EVAL_KERNELS.items():
        want[k] = want.get(k, 0) + v * n_ev
    emit("launches", model=LSTM_NAME, path="files", train_steps=FILES_STEPS,
         eval_batches=n_ev, **counts,
         designs=[[*d, n] for d, n in bigru.design_launches.items()])
    require(state.step == FILES_STEPS and len(evals) == FILES_STEPS
            // FILES_EVAL_EVERY and n_ev == len(evals) * n_eval,
            f"{what}: {state.step} steps, evaluations of {evals} batches")
    require_launches(counts, want, what)
    stem = {d: n for d, n in fused_stem.design_launches.items() if n}
    require(stem == {STEM_PATH_DESIGN["train"]: FILES_STEPS,
                     STEM_PATH_DESIGN["serve"]: n_ev},
            f"{what}: K1 launched {stem} by design")
    rnn = {d: n for d, n in bigru.design_launches.items() if n}
    require(all(d.name == PATH_DESIGN["bilstm_train"] for d in rnn),
            f"{what}: recurrence launches by design {rnn}")
    read_ctc_design({"ctc_alpha": counts["ctc_alpha"],
                     "ctc_beta": counts["ctc_beta"]}, what)
    with open(metrics_path) as f:
        recs = [json.loads(line) for line in f]
    train = [r for r in recs if r["kind"] == "train"]
    ev = [r for r in recs if r["kind"] == "eval"]
    losses = [r["loss"] for r in train]
    cers = [r["cer"] for r in ev]
    require(all(v == v for v in losses) and statistics.mean(losses[-3:])
            < losses[0], f"{what}: the loss did not fall: {losses}")
    require(min(cers) < cers[0], f"{what}: the evaluation CER did not fall "
                                 f"from the first evaluation: {cers}")
    mgr = CheckpointManager(ck)
    require(mgr.all_steps() and mgr.best_step() in mgr.all_steps(),
            f"{what}: checkpoints {mgr.all_steps()}")
    traces = sorted(os.listdir(trace_dir))
    require(len(traces) == 1, f"{what}: trace files {traces}")
    with open(os.path.join(trace_dir, traces[0])) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "kernel"}
    k5 = sorted(n for n in names if "birnn_resident_kernel" in n
                and "Lstm" in n and ("true" in n or "Lb1E" in n))
    require(bool(k5), f"{what}: the trace names no K5 kernel "
                      f"({len(names)} kernel names)")
    # one checkpoint's save and restore, timed
    timing = CheckpointManager(os.path.join(tmp, "timing"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timing.save(state.step, state)
    save_ms = (time.perf_counter() - t0) * 1e3
    path = os.path.join(timing.directory, str(state.step), "checkpoint.pt")
    other = fresh()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timing.restore(other)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    same = compare_states(state, other)
    require(same["bitwise"], f"{what}: a restore differs: {same}")
    res = dict(
        steps=FILES_STEPS, eval_every=FILES_EVAL_EVERY, eval_batches=n_ev,
        learning_rate=FILES_LR, wall_s=wall,
        fit_lines_per_s=train[-1]["lines_per_sec"],
        host_step_p50_ms=train[-1]["host_step_p50_ms"],
        first_loss=losses[0], last3_mean_loss=statistics.mean(losses[-3:]),
        eval_cer=cers, eval_steps=[r["step"] for r in ev],
        best_step=mgr.best_step(), kept_steps=mgr.all_steps(),
        trace_k5_names=k5[:2], save_ms=save_ms, restore_ms=restore_ms,
        checkpoint_mb=os.path.getsize(path) / 1e6, card=card)
    emit("files_fit", **res)
    return dict(res, state=state, ckpt=ck)


def files_throughput(reader, cfg, fresh, reps: int = TRAIN_STEPS) -> dict:
    """Phase 27 (b): the files path timed as phase 22 times the in-memory
    one: each step is the next device batch plus ``fit``'s train step,
    synchronized; 3 warm-up steps, then ``reps`` timed. Three sources in
    turns, each on a fresh state: ``device_batches`` over
    ``reader.run_generator`` with ``prefetch=2`` (the path) and with
    ``prefetch=0`` (the reader on the step's thread), and ``produce_batch``
    of the same epoch's host batches held in memory (the same buckets with
    no reader at all)."""
    import torch
    from crnn_ocr_torch.data.pipeline import device_batches, produce_batch
    from crnn_ocr_torch.train import step as step_lib

    train_step = step_lib.make_train_step(cfg)
    gen = torch.Generator(device="cuda")
    held = list(reader.run_generator(train=True, epochs=1))

    def in_memory():
        while True:
            for b in held:
                yield produce_batch(dict(b), "cuda", cfg)

    sources = {
        "files_prefetch_2": lambda: device_batches(
            reader.run_generator(train=True), "cuda", cfg, prefetch=2),
        "files_prefetch_0": lambda: device_batches(
            reader.run_generator(train=True), "cuda", cfg, prefetch=0),
        "in_memory_same_batches": in_memory,
    }
    out = {}
    for key, source in sources.items():
        state, stream = fresh(), source()
        lines, step_ms = 0, []
        for i in range(TRAIN_WARMUP + reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batch = next(stream)
            batch.pop("texts"), batch.pop("bucket")
            gen.manual_seed(step_lib.step_seed(0, state.step))
            train_step(state, batch, gen)
            torch.cuda.synchronize()
            if i >= TRAIN_WARMUP:
                step_ms.append((time.perf_counter() - t0) * 1e3)
                lines += int(batch["x"].shape[0])
        stream.close()
        out[key] = dict(lines_per_s=lines / (sum(step_ms) / 1e3),
                        p50_step_ms=statistics.median(step_ms), steps=reps)
    return out


def files_resume(reader, cfg, fresh, tmp: str) -> dict:
    """Phase 27 (c): fit to step k with ``checkpoint_dir``, restore into a
    fresh state (the same optimizer and schedule), fit to 2k from
    ``run_generator(skip=k)``, against a straight 2k-step run. Where the
    two differ, a second straight run tells a fault of the resume from an
    operation that sums in another order on every run (``scatter_add_``'s
    atomics in the CTC gradient did, until it became a matmul)."""
    from crnn_ocr_torch.data.pipeline import device_batches
    from crnn_ocr_torch.train import CheckpointManager, FitConfig, fit

    k = FILES_RESUME_K

    def run(steps, state, skip=0, ck=None):
        stream = device_batches(reader.run_generator(train=True, skip=skip),
                                "cuda", cfg, prefetch=0)
        return fit(state, cfg, stream, cfg=FitConfig(
            steps=steps, log_every=10 ** 6, checkpoint_dir=ck))

    ck = os.path.join(tmp, "resume")
    straight = run(2 * k, fresh())
    first = run(k, fresh(), ck=ck)
    restored = CheckpointManager(ck).restore(fresh())
    restore = compare_states(first, restored)
    require(restore["bitwise"], f"the restored state differs from the saved "
                                f"one: {restore}")
    resumed = run(2 * k, restored, skip=k)
    res = dict(k=k, restore_bitwise=True, **compare_states(straight, resumed))
    if not res["bitwise"]:  # is it the resume, or any two runs?
        res["straight_vs_straight"] = compare_states(straight,
                                                     run(2 * k, fresh()))
    emit("files_resume", **res)
    require(res["bitwise"] or res["within_tolerance"],
            f"the resumed run disagrees with the straight one: {res}")
    print(f"bitwise: {'true' if res['bitwise'] else 'false'}"
          + ("" if res["bitwise"] else
             f" (max |diff| {res['max_abs_diff']} in "
             f"{res['max_diff_tensor']})"), flush=True)
    return res


def files_serve(state, cfg, codec, ck: str, lines, truth, tmp: str) -> dict:
    """Phase 27 (d): ``init_predictor`` of the checkpoint directory against
    a ``Predictor`` of the trained state in memory on the 64 golden lines
    (texts equal, scores within 1e-5), its CER, and ``python -m
    crnn_ocr_torch.cli.predict --model <checkpoint dir>``'s rows against
    ``predict_many``'s."""
    import cv2
    from crnn_ocr_torch.infer.predictor import Predictor, init_predictor
    from crnn_ocr_torch.utils import metrics as metrics_lib

    reloaded = init_predictor(ck, device="cuda")
    memory = Predictor(cfg, state.model.state_dict(), codec, device="cuda")
    got, want = reloaded.predict(lines), memory.predict(lines)
    texts = [p.text for p in got]
    score_diff = max(abs(a.score - b.score) for a, b in zip(got, want))
    require(texts == [p.text for p in want] and score_diff <= 1e-5,
            f"reloaded: texts or scores differ from the trained state's "
            f"(max score diff {score_diff})")
    d = os.path.join(tmp, "lines")
    os.makedirs(d)
    names = [f"l{i:02d}.png" for i in range(len(lines))]
    for name, im in zip(names, lines):
        require(cv2.imwrite(os.path.join(d, name), im), "imwrite")
    out = os.path.join(tmp, "out.tsv")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "crnn_ocr_torch.cli.predict", "--model", ck,
         "--image_dir", d, "--greedy", "--result", out],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    require(proc.returncode == 0, f"predict CLI: rc {proc.returncode}, "
                                  f"{proc.stderr[-2000:]}")
    with open(out) as f:
        rows = [r.split("\t") for r in f.read().splitlines()]
    many = reloaded.predict_many(lines, batch_size=64)
    res = dict(
        texts_equal=True, max_score_diff=score_diff,
        cer=metrics_lib.cer(texts, truth),
        seq_acc=metrics_lib.sequence_accuracy(texts, truth),
        nonempty_texts=sum(bool(t) for t in texts),
        cli_rows=len(rows),
        cli_names_in_order=[r[0] for r in rows] == names,
        cli_rows_off_predict_many=sum(
            r[1] != p.text or abs(float(r[2]) - p.score) > 1e-4
            for r, p in zip(rows, many)),
        sample=[[t, w] for t, w in zip(texts[:6], truth[:6])])
    emit("files_serve", **res)
    require(res["cli_rows"] == len(lines) and res["cli_names_in_order"]
            and res["cli_rows_off_predict_many"] == 0,
            f"predict CLI on the checkpoint: {res}")
    return res


def files_optimizers(g, card: str) -> dict:
    """Phase 27 (e): 3 counted steps of each of sgd, rmsprop, adadelta and
    adamw on ``fonts-hard`` (bf16, B 128, bucket 256, dropout 0.2): a
    finite loss, the optimizer's slots filled, and each step's launches
    (2 K3, K6, K7, K8, K1 on ``"conv9"``, K9, K10)."""
    import math

    import torch
    from crnn_ocr_torch.data.pipeline import produce_batch
    from crnn_ocr_torch.train import step as step_lib

    out = {}
    for name in OTHER_OPTIMIZERS:
        cfg, _, state, host, _ = train_setup(g, "bfloat16", 0.2,
                                             optimizer=name)
        train_step = step_lib.make_train_step(cfg)
        gen = torch.Generator(device="cuda")
        torch.cuda.synchronize()
        reset_launches()
        losses = []
        for _ in range(3):
            batch = produce_batch(dict(host), "cuda", cfg)
            batch.pop("texts"), batch.pop("bucket")
            gen.manual_seed(step_lib.step_seed(0, state.step))
            losses.append(float(train_step(state, batch, gen)["loss"]))
        counts = read_launches()
        require_launches(counts, {k: 3 * v for k, v in TRAIN_KERNELS.items()},
                         f"fonts-hard with {name}: 3 train steps")
        require(all(map(math.isfinite, losses)) and state.optimizer.state,
                f"fonts-hard with {name}: losses {losses}")
        out[name] = dict(losses=losses, optimizer=type(state.optimizer)
                         .__name__, bigru_train=counts["bigru_train"])
    emit("files_optimizers", card=card, **out)
    return out


def phase_files(card: str, g, in_memory: dict = None) -> dict:
    """Phase 27: fine-tune ``fonts-hard-lstm`` (bf16, dropout 0.2, Adam at
    ``FILES_LR``) from a directory of PNG files, resume it, reload and
    serve its checkpoint, and step the other optimizers. Everything is
    written to a temporary directory outside the repo. ``in_memory``:
    phase 22's lines/s and p50 in this call, reported beside the files
    path's."""
    import tempfile

    from crnn_ocr_torch.data.reader import Reader, ReaderConfig
    from crnn_ocr_torch.infer.pretrained import model_weights
    from crnn_ocr_torch.infer.weights import params_from_jax
    from crnn_ocr_torch.train import create_train_state

    cfg, params, stats, codec = model_weights(LSTM_NAME, "bfloat16")
    cfg = dataclasses.replace(cfg, dropout_rate=0.2)
    weights = params_from_jax(params, stats)

    def fresh():
        return create_train_state(cfg, weights, device="cuda",
                                  learning_rate=FILES_LR)

    secs = {}
    t0 = time.perf_counter()

    def lap(key):
        nonlocal t0
        t1 = time.perf_counter()
        secs[key] = t1 - t0
        t0 = t1

    with tempfile.TemporaryDirectory() as tmp:
        corpus = os.path.join(tmp, "corpus")
        os.makedirs(corpus)
        lines, truth = write_corpus(g, corpus)
        reader = Reader(ReaderConfig(
            corpus, batch_size=TRAIN_BATCH, val_fraction=FILES_VAL,
            buckets=FILES_BUCKETS, max_label_len=TRAIN_MAX_LABEL,
            pack_cache=True), codec=codec)
        host = reader_host_ms(reader)
        emit("files_corpus", files=len(reader.samples),
             train_steps_per_epoch=reader.steps_per_epoch(),
             eval_batches=reader.steps_per_epoch(train=False),
             packed=len(reader._pack), **host)
        lap("corpus")
        fitted = files_fit(card, reader, cfg, codec, fresh, tmp)
        lap("fit")
        speed = files_throughput(reader, cfg, fresh)
        emit("files_throughput", card=card, **speed,
             in_memory_phase_22=in_memory,
             train_batches_by_bucket=host["train_batches_by_bucket"])
        lap("throughput")
        files_resume(reader, cfg, fresh, tmp)
        lap("resume")
        files_serve(fitted["state"], cfg, codec, fitted["ckpt"], lines,
                    truth, tmp)
        lap("serve")
    files_optimizers(g, card)
    lap("optimizers")
    emit("files_seconds", **secs)
    return dict(speed, host=host)


# ---- phase 28: fonts-hard fine-tuned with augmentation from a corpus on
# ---- the card, K steps a call, evaluated on the card

AUG_K = 4  # steps a call
AUG_STEPS, AUG_EVAL_EVERY, AUG_LOG_EVERY = 160, 40, 8
AUG_SEED = 5  # the augmentation stream's
AUG_SPEED_STEPS = 48  # each throughput mode's steps
AUG_RESUME = 8  # resume at step 8 of 16
# per step: phase 8's kernels and the augmentation's warp (K11); per
# evaluation batch: the served forward (K1 on "mma", 2 K2) and the loss (K6)
AUG_TRAIN_KERNELS = dict(TRAIN_KERNELS, grid_sample=1)
AUG_EVAL_KERNELS = {"fused_stem": 1, "bigru": 2, "ctc_alpha": 1}
# a cached K-step call against single streamed steps: the CPU tests'
# tolerances (tests/test_torch_train_multi.py, test_torch_device_cache.py)
AUG_LOSS_RTOL, AUG_LOSS_ATOL = 1e-5, 1e-6
AUG_PARAM_RTOL, AUG_PARAM_ATOL, AUG_SLOT_ATOL = 1e-3, 1e-6, 2e-5


def sync(dev) -> None:
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def launch_state():
    """Every launch counter's value, to put back with
    :func:`restore_launches` (launches made only to compare do not count)."""
    from crnn_ocr_torch.kernels import bigru, ctc_loss, fused_stem
    from crnn_ocr_torch.kernels import grid_sample as gs

    return (read_launches(), collections.Counter(fused_stem.design_launches),
            collections.Counter(bigru.design_launches),
            collections.Counter(ctc_loss.design_launches),
            collections.Counter(gs.design_launches),
            collections.Counter(bigru.backward_design_launches))


def restore_launches(snap) -> None:
    from crnn_ocr_torch.kernels import bigru, ctc_loss, fused_stem
    from crnn_ocr_torch.kernels import fused_stem_train as fst
    from crnn_ocr_torch.kernels import grid_sample as gs

    counts, stem, rnn, ctc, sampler, rnn_bwd = snap
    bigru.launches, bigru.train_launches = (counts["bigru"],
                                            counts["bigru_train"])
    bigru.backward_launches = counts["bigru_backward"]
    bigru.lstm_launches = counts["bilstm"]
    bigru.lstm_train_launches = counts["bilstm_train"]
    ctc_loss.alpha_launches = counts["ctc_alpha"]
    ctc_loss.beta_launches = counts["ctc_beta"]
    gs.launches, gs.bwd_launches = (counts["grid_sample"],
                                    counts["grid_sample_bwd"])
    fst.stats_launches = counts["stem_stats"]
    fst.partials_launches = counts["stem_bwd_partials"]
    fst.final_launches = counts["stem_bwd_final"]
    for live, saved in ((fused_stem.design_launches, stem),
                        (bigru.design_launches, rnn),
                        (bigru.backward_design_launches, rnn_bwd),
                        (ctc_loss.design_launches, ctc),
                        (gs.design_launches, sampler)):
        live.clear()
        live.update(saved)
    require(read_launches() == counts, "the launch counts were not restored")


def flat_batches(stream):
    """Each batch of a stream of stacks and single batches, in order, with
    its stack's ``batch_index`` entry: (bucket, index, k, item)."""
    for item in stream:
        k_total = int(item.get("stacked", 0))
        if not k_total:
            yield int(item["bucket"]), int(item["batch_index"]), None, item
        for k in range(k_total):
            yield int(item["bucket"]), int(item["batch_index"][k]), k, item


def aug_stream_parity(reader, corpus, dev) -> dict:
    """Phase 28 (a): the stacks of ``stacked_index_batches(AUG_K)``
    gathered on the card against ``stack_host_batches`` of the host path
    (``run_generator``) over two epochs: each batch's pixel rows, widths,
    labels and label lengths byte for byte, and its ``batch_index``."""
    import numpy as np
    import torch
    from crnn_ocr_torch.data.pipeline import stack_host_batches

    host = flat_batches(stack_host_batches(
        reader.run_generator(train=True, epochs=2), AUG_K, prefetch=0))
    devs = flat_batches(corpus.stacked_index_batches(AUG_K, epochs=2))
    n = 0
    for (hb, hi, hk, h), (db, di, dk, d) in zip(host, devs, strict=True):
        require((hb, hi) == (db, di), f"batch {n}: host (bucket {hb}, index "
                                      f"{hi}), corpus ({db}, {di})")
        arrs = corpus.arrays(db)
        rows = torch.from_numpy(np.asarray(d["rows"][dk], np.int64)).to(dev)
        px = arrs["pixels"].index_select(0, rows).cpu().numpy()
        canvas = h["the_input"] if hk is None else h["the_input"][hk]
        pick = (lambda key: h[key]) if hk is None else (lambda key: h[key][hk])
        w = min(canvas.shape[2], px.shape[2])
        same = (np.array_equal(px[:, :canvas.shape[1], :w],
                               canvas[:, :px.shape[1], :w])
                and (px[:, :, w:] == 255).all()
                and (canvas[:, :, w:] == 255).all()
                and (canvas[:, px.shape[1]:] == 255).all())
        for key, tkey in (("widths", "widths"), ("the_labels", "labels"),
                          ("label_length", "lab_len")):
            same = same and np.array_equal(
                arrs[tkey].index_select(0, rows).cpu().numpy(), pick(key))
        require(same, f"batch {n} (bucket {db}, index {di}): the corpus's "
                      f"rows differ from the host path's")
        n += 1
    return dict(batches=n, equal=True)


def aug_cached_parity(reader, corpus, cfg32, fresh32, dev) -> dict:
    """Phase 28 (a): one cached K = 4 call (augmented) against 4 single
    streamed steps of the same 4 batches (one bucket) in f32, TF32 off:
    losses at rtol 1e-5 / atol 1e-6, parameters and BatchNorm statistics
    at rtol 1e-3 / atol 1e-6, Adam's slots at atol 2e-5."""
    import numpy as np
    import torch
    from crnn_ocr_torch.data.pipeline import produce_batch
    from crnn_ocr_torch.train import step as step_lib

    groups: dict = {}
    for i, b in enumerate(reader.run_generator(train=True, epochs=2)):
        group = groups.setdefault(int(b["bucket"]), [])
        group.append((i, b))
        if len(group) == AUG_K:
            break
    stack = next(corpus.stacked_index_batches(AUG_K))
    require([i for i, _ in group] == list(stack["batch_index"]),
            f"the first stack's batches {list(stack['batch_index'])}, the "
            f"host's {[i for i, _ in group]}")
    a, b = fresh32(), fresh32()
    single = step_lib.make_train_step(cfg32)
    gen = torch.Generator(device=dev)
    losses = []
    for i, raw in group:
        batch = produce_batch(dict(raw), dev, cfg32, augment=True,
                              augment_seed=AUG_SEED, index=i)
        batch.pop("texts"), batch.pop("bucket")
        gen.manual_seed(step_lib.step_seed(0, a.step))
        losses.append(float(single(a, batch, gen)["loss"]))
    arrs = corpus.arrays(stack["bucket"])
    ms = step_lib.make_cached_multi_train_step(
        cfg32, augment=True, augment_seed=AUG_SEED)(
        b, arrs["pixels"], arrs["widths"], arrs["labels"], arrs["lab_len"],
        stack["rows"], stack["batch_index"], 0, stack["bucket"])
    got = ms["loss"].cpu().numpy()
    loss_diff = float(np.max(np.abs(got - losses)))
    loss_ok = bool(np.allclose(got, losses, rtol=AUG_LOSS_RTOL,
                               atol=AUG_LOSS_ATOL))
    worst = {}
    ok = loss_ok
    ta, tb = state_tensors(a), state_tensors(b)
    for key in ta:
        x = ta[key].detach().float().cpu().numpy()
        y = tb[key].detach().float().cpu().numpy()
        slot = key.startswith("optimizer")
        rtol, atol = (0, AUG_SLOT_ATOL) if slot else (AUG_PARAM_RTOL,
                                                      AUG_PARAM_ATOL)
        ok = ok and bool(np.allclose(y, x, rtol=rtol, atol=atol))
        kind = "slots" if slot else "params"
        d = float(np.max(np.abs(x - y))) if x.size else 0.0
        if d >= worst.get(kind, (0.0, None))[0]:
            worst[kind] = (d, key)
    res = dict(bucket=int(stack["bucket"]), losses=losses,
               cached_losses=got.tolist(), max_loss_diff=loss_diff,
               max_param_diff=worst["params"][0],
               max_param_diff_tensor=worst["params"][1],
               max_slot_diff=worst["slots"][0],
               max_slot_diff_tensor=worst["slots"][1],
               bitwise=compare_states(a, b)["bitwise"], within=ok)
    require(ok, f"a cached K-step call differs from single steps: {res}")
    return res


def aug_fit_steps(state, cfg, stream, steps, **kw):
    from crnn_ocr_torch.train import FitConfig, fit

    return fit(state, cfg, stream, cfg=FitConfig(
        steps=steps, log_every=10 ** 6, steps_per_call=AUG_K, augment=True,
        augment_seed=AUG_SEED, **kw))


def aug_partial_parity(corpus, half, cfg, fresh) -> dict:
    """Phase 28 (a): 8 steps (2 calls) over the corpus with about half its
    pixel rows resident against the same over full residency: bitwise."""
    full = aug_fit_steps(fresh(), cfg, corpus.stacked_index_batches(AUG_K),
                         2 * AUG_K, device_corpus=corpus)
    part = aug_fit_steps(fresh(), cfg, half.stacked_index_batches(AUG_K),
                         2 * AUG_K, device_corpus=half)
    res = dict(resident_fraction=half.resident_fraction,
               resident_rows=dict(half._n_resident),
               rows=corpus._n_resident, **compare_states(full, part))
    require(res["bitwise"], f"partial residency differs from full: {res}")
    return res


def aug_sampler_check(reader, cfg, dev) -> dict:
    """Phase 28 (a): ``augment_with_draws`` on the card (K11) against its
    CPU twin on the same draws (the card's own, copied), atol 1e-5, on a
    training batch's frames at bucket 256; the draws in their ranges, the
    noise's mean and std within 3 standard errors."""
    import math

    from crnn_ocr_torch.data.pipeline import produce_batch
    from crnn_ocr_torch.kernels import grid_sample as gs
    from crnn_ocr_torch.ops import augment

    raw = next(b for b in reader.run_generator(train=True)
               if int(b["bucket"]) == BUCKET)
    x = produce_batch(dict(raw), dev, cfg)["x"]
    B, H, W = x.shape
    acfg = augment.AugmentConfig()
    draws = augment.augment_draws(B, H, W,
                                  augment.augment_generator(dev, AUG_SEED, 0))
    n = gs.launches
    got = augment.augment_with_draws(x, draws)
    sync(dev)
    launches = gs.launches - n
    want = augment.augment_with_draws(
        x.cpu(), {k: v.cpu() for k, v in draws.items()})
    err = float((got.cpu() - want).abs().max())
    ranges = {}
    for key, lo, hi in (
            ("brightness", -acfg.brightness, acfg.brightness),
            ("contrast", 1 - acfg.contrast, 1 + acfg.contrast),
            ("shear", -acfg.shear, acfg.shear),
            ("rotation", -acfg.rotate, acfg.rotate),
            ("translation", -acfg.translate, acfg.translate)):
        v = draws[key]
        ranges[key] = [float(v.min()), float(v.max())]
        require(lo <= ranges[key][0] and ranges[key][1] <= hi,
                f"augmentation draw {key} {ranges[key]} outside [{lo}, {hi}]")
    noise = draws["noise"].double()
    nn_ = noise.numel()
    mean, std = float(noise.mean()), float(noise.std())
    se_mean = acfg.noise_std / math.sqrt(nn_)
    se_std = acfg.noise_std / math.sqrt(2 * nn_)
    res = dict(shape=[B, H, W], max_abs_err=err, tolerance=1e-5,
               k11_launches=launches, ranges=ranges, noise_mean=mean,
               noise_std=std, noise_mean_se=se_mean, noise_std_se=se_std)
    require(err <= 1e-5 and launches == (1 if x.is_cuda else 0)
            and abs(mean) <= 3 * se_mean
            and abs(std - acfg.noise_std) <= 3 * se_std,
            f"the augmentation on the card: {res}")
    return res


def aug_levenshtein_check(dev, pairs: int = 4096) -> dict:
    """Phase 28 (a): ``batched_levenshtein`` on the card against the
    native ``editdistance`` on ``pairs`` random pairs, lengths 0-64, half
    over 2 labels and half over 60: equal."""
    import numpy as np
    import torch
    from crnn_ocr_torch import native
    from crnn_ocr_torch.ops.editdistance import batched_levenshtein

    rng = np.random.default_rng(28)
    out = {}
    for vocab in (2, 60):
        n = pairs // 2
        a = rng.integers(0, vocab, (n, 64)).astype(np.int32)
        b = rng.integers(0, vocab, (n, 64)).astype(np.int32)
        la = rng.integers(0, 65, n).astype(np.int32)
        lb = rng.integers(0, 65, n).astype(np.int32)
        got = batched_levenshtein(*(torch.from_numpy(v).to(dev)
                                    for v in (a, la, b, lb))).cpu().numpy()
        want = np.array([native.editdistance(a[i, :la[i]].tolist(),
                                             b[i, :lb[i]].tolist())
                         for i in range(n)])
        out[f"vocab_{vocab}"] = dict(pairs=n, equal=int((got == want).sum()),
                                     mean_distance=float(want.mean()))
        require(np.array_equal(got, want), f"batched_levenshtein differs "
                                           f"from editdistance: {out}")
    return out


def aug_fit(card, reader, corpus, cfg, codec, fresh, tmp, dev) -> dict:
    """Phase 28 (b): ``fit`` over the corpus on the card, K = 4 a call,
    augmented, evaluated with ``on_device_cer`` every ``AUG_EVAL_EVERY``
    steps and checkpointed, counted. Before each evaluation the same state
    is evaluated on the same batches with the host's CER (its launches are
    taken back out of the counts): the two CERs must be equal."""
    import math

    from crnn_ocr_torch.data.pipeline import device_batches
    from crnn_ocr_torch.kernels import bigru, fused_stem
    from crnn_ocr_torch.train import (
        CheckpointManager,
        FitConfig,
        evaluate,
        fit,
    )
    from crnn_ocr_torch.train import step as step_lib

    held = list(device_batches(reader.run_generator(train=False, epochs=1),
                               dev, cfg, prefetch=0))
    n_eval = len(held)
    eval_step = step_lib.make_eval_step(cfg)
    state = fresh()
    host_cers = []

    def eval_iter():
        snap = launch_state()
        host_cers.append(evaluate(state, eval_step, iter(held), codec,
                                  n_eval)["cer"])
        restore_launches(snap)
        return iter(held)

    ck, metrics_path = os.path.join(tmp, "aug_ckpt"), os.path.join(
        tmp, "aug_fit.jsonl")
    sync(dev)
    reset_launches()
    t0 = time.perf_counter()
    fit(state, cfg, corpus.stacked_index_batches(AUG_K), eval_iter, codec,
        FitConfig(steps=AUG_STEPS, eval_every=AUG_EVAL_EVERY,
                  eval_batches=n_eval, log_every=AUG_LOG_EVERY,
                  metrics_path=metrics_path, checkpoint_dir=ck,
                  steps_per_call=AUG_K, device_corpus=corpus, augment=True,
                  augment_seed=AUG_SEED, on_device_cer=True))
    sync(dev)
    wall = time.perf_counter() - t0
    counts = read_launches()
    n_evals = AUG_STEPS // AUG_EVAL_EVERY
    what = f"fonts-hard from the device corpus: {AUG_STEPS} steps"
    want = {k: v * AUG_STEPS for k, v in AUG_TRAIN_KERNELS.items()}
    for k, v in AUG_EVAL_KERNELS.items():
        want[k] = want.get(k, 0) + v * n_eval * n_evals
    emit("launches", model="fonts-hard", path="device_corpus_k4_aug",
         train_steps=AUG_STEPS, eval_batches=n_eval * n_evals, **counts)
    with open(metrics_path) as f:
        recs = [json.loads(line) for line in f]
    train = [r for r in recs if r["kind"] == "train"]
    ev = [r for r in recs if r["kind"] == "eval"]
    device_cers = [r["cer"] for r in ev]
    losses = [r["loss"] for r in train]
    res = dict(steps=state.step, steps_per_call=AUG_K, evals=len(ev),
               eval_steps=[r["step"] for r in ev], eval_batches=n_eval,
               device_cer=device_cers, host_cer=host_cers,
               eval_loss=[r["loss"] for r in ev], first_loss=losses[0],
               last_loss=losses[-1], wall_s=wall,
               fit_lines_per_s=train[-1]["lines_per_sec"],
               host_call_p50_ms=train[-1]["host_step_p50_ms"],
               checkpoints=CheckpointManager(ck).all_steps(), card=card)
    emit("aug_fit", **res)
    if dev.type == "cuda":
        require_launches(counts, want, what)
        stem = {d: n for d, n in fused_stem.design_launches.items() if n}
        require(stem == {STEM_PATH_DESIGN["train"]: AUG_STEPS,
                         STEM_PATH_DESIGN["serve"]: n_eval * n_evals},
                f"{what}: K1 launched {stem} by design")
        rnn = {d: n for d, n in bigru.design_launches.items() if n}
        require(all(d.name == PATH_DESIGN["bigru"] for d in rnn),
                f"{what}: recurrence launches by design {rnn}")
        read_ctc_design({"ctc_alpha": counts["ctc_alpha"],
                         "ctc_beta": counts["ctc_beta"]}, what)
    require(state.step == AUG_STEPS and len(ev) == n_evals >= 3,
            f"{what}: {state.step} steps, {len(ev)} evaluations")
    require(device_cers == host_cers,
            f"{what}: the on-device CER {device_cers} differs from the "
            f"host's {host_cers}")
    require(all(map(math.isfinite, losses)), f"{what}: losses {losses}")
    require(device_cers[-1] <= device_cers[0] + 0.02,
            f"{what}: the CER rose from {device_cers[0]} to "
            f"{device_cers[-1]}")
    return dict(res, held=held, launches=counts)


SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")


def sync_sites(run, top: int = 8, calls=SYNC_CALLS) -> dict:
    """The host's waits on the card in ``run()`` (the CUDA runtime's
    synchronize calls), by where they come from: torch.profiler with
    Python stacks, each wait charged to the innermost ``crnn_ocr_torch``
    function and the innermost ``aten::`` op whose intervals on its thread
    hold it (``"other"`` where none does)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if torch.cuda.is_available():
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 with_stack=True) as prof:
        run()
    evs = prof.events()
    frames = [e for e in evs if "crnn_ocr_torch/" in e.name
              or e.name.startswith("aten::")]
    sites = collections.Counter()
    for e in evs:
        if e.name not in calls:
            continue
        r = e.time_range
        holders = sorted((f for f in frames if f.thread == e.thread
                          and f.time_range.start <= r.start
                          and f.time_range.end >= r.end),
                         key=lambda f: f.time_range.start, reverse=True)
        fn = next((f.name.split("crnn_ocr_torch/")[-1] for f in holders
                   if "crnn_ocr_torch/" in f.name), "other")
        op = next((f.name for f in holders if f.name.startswith("aten::")),
                  "")
        sites[f"{fn} {op}".strip()] += 1
    return dict(sites.most_common(top))


def aug_throughput(card, reader, corpus, half, cfg, fresh, dev, tmp,
                   in_memory=None) -> dict:
    """Phase 28 (c): ``AUG_SPEED_STEPS`` steps of ``fit`` from a fresh
    state in five modes, in turns (1-5, then 5-1): lines/s over the
    synchronized wall time, and the host's p50 ms a call (``fit``'s
    timer); then a traced window of modes 2 and 4 (the device's idle share
    and K11's device ms a step), the corpus's bytes on the card and the
    memory allocated."""
    import torch
    from crnn_ocr_torch.data.pipeline import device_batches, \
        stack_host_batches
    from crnn_ocr_torch.train import FitConfig, fit

    aug = dict(augment=True, augment_seed=AUG_SEED)
    modes = {
        "1_streamed": (lambda: device_batches(
            reader.run_generator(train=True), dev, cfg, prefetch=2), {}),
        "2_streamed_aug": (lambda: device_batches(
            reader.run_generator(train=True), dev, cfg, prefetch=2, **aug),
            dict(aug)),
        "3_stacked_k4_aug": (lambda: stack_host_batches(
            reader.run_generator(train=True), AUG_K, prefetch=2),
            dict(aug, steps_per_call=AUG_K)),
        "4_corpus_k4_aug": (lambda: corpus.stacked_index_batches(AUG_K),
                            dict(aug, steps_per_call=AUG_K,
                                 device_corpus=corpus)),
        "5_partial_k4_aug": (lambda: half.stacked_index_batches(AUG_K),
                             dict(aug, steps_per_call=AUG_K,
                                  device_corpus=half)),
    }

    runs = iter(range(10 ** 6))

    def run(key, steps, state=None, trace=False, sites=False):
        make, kw = modes[key]
        state = state or fresh()
        stream = make()
        path = os.path.join(tmp, f"speed_{next(runs)}.jsonl")
        fitcfg = FitConfig(steps=state.step + steps,
                           log_every=steps, metrics_path=path, **kw)
        sync(dev)
        t0 = time.perf_counter()
        if sites:
            tr = sync_sites(lambda: fit(state, cfg, stream, cfg=fitcfg))
        elif trace:
            tr = lean_trace(lambda: fit(state, cfg, stream, cfg=fitcfg),
                            kernels=("sample_fwd",))
        else:
            fit(state, cfg, stream, cfg=fitcfg)
        sync(dev)
        wall = time.perf_counter() - t0
        if hasattr(stream, "close"):
            stream.close()
        with open(path) as f:
            last = [json.loads(line) for line in f][-1]
        out = dict(lines_per_s=steps * TRAIN_BATCH / wall,
                   host_call_p50_ms=last["host_step_p50_ms"],
                   host_step_p50_ms=last["host_step_p50_ms"]
                   / kw.get("steps_per_call", 1))
        return (out, tr, state) if trace else out

    rounds = {key: [] for key in modes}
    for order in (list(modes), list(reversed(modes))):
        for key in order:
            rounds[key].append(run(key, AUG_SPEED_STEPS))
    res = {key: dict(
        lines_per_s=[r["lines_per_s"] for r in rs],
        mean_lines_per_s=statistics.mean(r["lines_per_s"] for r in rs),
        host_call_p50_ms=[r["host_call_p50_ms"] for r in rs],
        host_step_p50_ms=[r["host_step_p50_ms"] for r in rs])
        for key, rs in rounds.items()}
    if dev.type == "cuda":
        for key in ("2_streamed_aug", "4_corpus_k4_aug"):
            _, _, warm = run(key, 8, trace=True)  # a warm state and stream
            _, tr, _ = run(key, 16, state=warm, trace=True)
            k11 = tr["kernel_device_ms"]["sample_fwd"]
            res[key]["trace"] = dict(
                tr, steps=16,
                device_idle_share=1 - tr["device_busy_ms"] / tr["wall_ms"],
                k11_ms_per_step=k11 / 16)
            # the same window's host waits by source line (8 steps)
            _, sites, _ = run(key, 8, state=warm, trace=True, sites=True)
            res[key]["sync_sites_8_steps"] = sites
        res["memory"] = dict(
            corpus_resident_bytes=corpus.resident_bytes(),
            corpus_total_bytes=corpus.total_bytes,
            partial_resident_bytes=half.resident_bytes(),
            partial_resident_fraction=half.resident_fraction,
            cuda_memory_allocated=torch.cuda.memory_allocated())
    res["in_memory_phase_22"] = in_memory
    return res


def aug_cer_timing(state, held, eval_step, dev) -> dict:
    """Phase 28 (d): one evaluation pass's CER sums on the card
    (``cer_sums_on_device`` on each batch's greedy decode; wall ms,
    synchronized, and the kernel launches of a traced pass) against the
    host's loop (the decodes copied to the host, each line's distance by
    the native ``editdistance``); then one ``batched_levenshtein`` call at
    B 128, La = Lb = 32 against the host loop on the same rows."""
    import numpy as np
    import torch
    from crnn_ocr_torch.ops.editdistance import (
        batched_levenshtein,
        cer_sums_on_device,
    )
    from crnn_ocr_torch.utils.metrics import levenshtein

    decoded = [eval_step(state, b)[1] for b in held]
    labels = [(b["the_labels"], b["label_length"]) for b in held]

    def on_device():
        s = r = 0
        for dec, (lab, ln) in zip(decoded, labels):
            d, n = cer_sums_on_device(dec, lab, ln)
            s, r = s + d, r + n
        return int(s), int(r)

    def on_host():
        s = r = 0
        for dec, (lab, ln) in zip(decoded, labels):
            dec, lab, ln = dec.cpu().numpy(), lab.cpu().numpy(), \
                ln.cpu().numpy()
            for row, lr, m in zip(dec, lab, ln):
                s += levenshtein(row[row >= 0].tolist(), lr[:m].tolist())
                r += int(m)
        return s, r

    def timed(fn, reps=5):
        fn()
        out, times = None, []
        for _ in range(reps):
            sync(dev)
            t0 = time.perf_counter()
            out = fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return out, statistics.median(times)

    (dev_sums, dev_ms), (host_sums, host_ms) = timed(on_device), timed(on_host)
    require(dev_sums == host_sums, f"CER sums: device {dev_sums}, host "
                                   f"{host_sums}")
    rng = np.random.default_rng(32)
    a = rng.integers(0, 60, (TRAIN_BATCH, 32)).astype(np.int32)
    b = rng.integers(0, 60, (TRAIN_BATCH, 32)).astype(np.int32)
    la = rng.integers(16, 33, TRAIN_BATCH).astype(np.int32)
    lb = rng.integers(16, 33, TRAIN_BATCH).astype(np.int32)
    ta = [torch.from_numpy(v).to(dev) for v in (a, la, b, lb)]
    (one, one_ms) = timed(lambda: batched_levenshtein(*ta).cpu().numpy())
    (ref, ref_ms) = timed(lambda: np.array([
        levenshtein(a[i, :la[i]].tolist(), b[i, :lb[i]].tolist())
        for i in range(TRAIN_BATCH)]))
    require(np.array_equal(one, ref), "batched_levenshtein at B 128 differs")
    res = dict(eval_batches=len(held), lines=sum(len(d) for d in decoded),
               sums=list(dev_sums), device_ms=dev_ms, host_loop_ms=host_ms,
               b128_l32=dict(device_ms=one_ms, host_loop_ms=ref_ms,
                             diagonals=63))
    if dev.type == "cuda":
        res["launches"] = lean_trace(on_device)["kernel_launches"]
        res["b128_l32"]["launches"] = lean_trace(
            lambda: batched_levenshtein(*ta))["kernel_launches"]
    return res


def aug_resume(corpus_dir, codec, cfg, fresh, tmp) -> dict:
    """Phase 28 (e): a single-bucket corpus (bucket 256, on a copy of the
    PNGs): fit 8 steps (K = 4, augmented) with ``checkpoint_dir``, restore
    into a fresh state, fit to 16 from ``stacked_index_batches(4,
    skip=8)``, against a straight 16-step run."""
    import shutil

    from crnn_ocr_torch.data.device_cache import DeviceResidentCorpus
    from crnn_ocr_torch.data.reader import Reader, ReaderConfig
    from crnn_ocr_torch.train import CheckpointManager

    d = os.path.join(tmp, "corpus_256")
    shutil.copytree(corpus_dir, d, ignore=shutil.ignore_patterns(
        ".crnn_pack", ".crnn_sizes.json"))
    reader = Reader(ReaderConfig(d, batch_size=TRAIN_BATCH,
                                 val_fraction=FILES_VAL, buckets=(BUCKET,),
                                 max_label_len=TRAIN_MAX_LABEL,
                                 pack_cache=True), codec=codec)
    one = DeviceResidentCorpus(reader, device=fresh().device)
    k = AUG_RESUME

    def run(state, steps, skip=0, ck=None):
        return aug_fit_steps(state, cfg, one.stacked_index_batches(
            AUG_K, skip=skip), steps, device_corpus=one, checkpoint_dir=ck)

    ck = os.path.join(tmp, "aug_resume")
    straight = run(fresh(), 2 * k)
    first = run(fresh(), k, ck=ck)
    restored = CheckpointManager(ck).restore(fresh())
    restore = compare_states(first, restored)
    require(restore["bitwise"], f"the restored state differs: {restore}")
    resumed = run(restored, 2 * k, skip=k)
    res = dict(k=k, buckets=[BUCKET], restore_bitwise=True,
               **compare_states(straight, resumed))
    if not res["bitwise"]:  # the resume, or any two runs?
        res["straight_vs_straight"] = compare_states(straight,
                                                     run(fresh(), 2 * k))
    emit("aug_resume", **res)
    require(res["bitwise"] or res["within_tolerance"],
            f"the resumed run disagrees with the straight one: {res}")
    print(f"bitwise: {'true' if res['bitwise'] else 'false'}"
          + ("" if res["bitwise"] else
             f" (max |diff| {res['max_abs_diff']} in "
             f"{res['max_diff_tensor']})"), flush=True)
    return res


def phase_aug(card: str, g, in_memory: dict = None, dev="cuda") -> dict:
    """Phase 28: fine-tune ``fonts-hard`` (bf16, dropout 0.2, Adam at
    ``TRAIN_LR``) with augmentation, K = 4 steps a call, from phase 27's
    1,024 PNGs held on the card (``DeviceResidentCorpus``), evaluated on
    the card; its parity checks, throughput in five modes, the CER's
    timing and a resume. Everything is written to a temporary directory
    outside the repo. ``in_memory``: phase 22's lines/s and p50 in this
    call."""
    import tempfile

    import torch
    from crnn_ocr_torch.data.device_cache import DeviceResidentCorpus
    from crnn_ocr_torch.data.reader import Reader, ReaderConfig
    from crnn_ocr_torch.infer.pretrained import model_weights
    from crnn_ocr_torch.infer.weights import params_from_jax
    from crnn_ocr_torch.train import create_train_state
    from crnn_ocr_torch.train import step as step_lib

    dev = torch.device(dev)

    def setup(dtype):
        cfg, params, stats, codec = model_weights("fonts-hard", dtype)
        cfg = dataclasses.replace(cfg, dropout_rate=0.2)
        weights = params_from_jax(params, stats)

        def fresh():
            return create_train_state(cfg, weights, device=dev,
                                      learning_rate=TRAIN_LR)
        return cfg, codec, fresh

    cfg, codec, fresh = setup("bfloat16")
    secs = {}
    t0 = time.perf_counter()

    def lap(key):
        nonlocal t0
        t1 = time.perf_counter()
        secs[key] = t1 - t0
        t0 = t1

    with tempfile.TemporaryDirectory() as tmp:
        corpus_dir = os.path.join(tmp, "corpus")
        os.makedirs(corpus_dir)
        write_corpus(g, corpus_dir)
        reader = Reader(ReaderConfig(
            corpus_dir, batch_size=TRAIN_BATCH, val_fraction=FILES_VAL,
            buckets=FILES_BUCKETS, max_label_len=TRAIN_MAX_LABEL,
            pack_cache=True), codec=codec)
        t1 = time.perf_counter()
        corpus = DeviceResidentCorpus(reader, device=dev)
        upload_s = time.perf_counter() - t1
        pixels = sum(mm.nbytes for mm in corpus._mm.values())
        half = DeviceResidentCorpus(
            reader, max_bytes=corpus.total_bytes - pixels + pixels // 2,
            device=dev)
        emit("aug_corpus", files=len(reader.samples),
             total_bytes=corpus.total_bytes,
             resident_bytes=corpus.resident_bytes(), upload_s=upload_s,
             rows=corpus._n_resident, partial_rows=half._n_resident,
             partial_resident_fraction=half.resident_fraction)
        lap("corpus")
        parity = dict(stream=aug_stream_parity(reader, corpus, dev))
        cfg32, _, fresh32 = setup("float32")
        parity["cached_vs_streamed_f32"] = aug_cached_parity(
            reader, corpus, cfg32, fresh32, dev)
        parity["partial_vs_full"] = aug_partial_parity(corpus, half, cfg,
                                                       fresh)
        parity["augment"] = aug_sampler_check(reader, cfg, dev)
        parity["levenshtein"] = aug_levenshtein_check(dev)
        emit("aug_parity", card=card, **parity)
        lap("parity")
        fitted = aug_fit(card, reader, corpus, cfg, codec, fresh, tmp, dev)
        lap("fit")
        speed = aug_throughput(card, reader, corpus, half, cfg, fresh, dev,
                               tmp, in_memory)
        emit("aug_throughput", card=card, **speed)
        lap("throughput")
        timing = aug_cer_timing(fresh(), fitted["held"],
                                step_lib.make_eval_step(cfg), dev)
        emit("aug_cer_timing", card=card, **timing)
        lap("cer_timing")
        aug_resume(corpus_dir, codec, cfg, fresh, tmp)
        lap("resume")
    emit("aug_seconds", **secs)
    return fitted["launches"]


DP_WORLD = 2  # ranks sharing the one card over gloo
DP_STEPS, DP_WARMUP = 20, 3  # the counted DP run's timed steps
DP_DROPOUT_STEPS = 3
DP_PAD_LINES = 120  # the padded leg: 120 lines padded to 128
DP_FIT_STEPS, DP_RESUME_AT = 8, 4
DP_COLLECTIVE_S = 120  # a collective that waits longer fails its rank
DP_SPAWN_S = 420  # the ranks' deadline
DP_SERVE_BATCH = 255  # odd: the batch does not divide the local mesh
# a step on a padded batch: the masked plain stem (no K8-K10, no training
# K1), the head's kernels as ever
DP_PADDED_KERNELS = dict(HEAD_TRAIN_KERNELS)


def dp_batch(batch) -> dict:
    """A device batch's tensors (``produce_batch`` adds ``texts`` and
    ``bucket``)."""
    return {k: v for k, v in batch.items() if k not in ("texts", "bucket")}


def dp_steps(g, mesh, dtype: str, dropout: float, batch, n: int = 1,
             shard: bool = True, seed: int = 0):
    """``n`` train steps of a fresh ``fonts-hard`` state (``train_setup``:
    shipped weights, ``TRAIN_LR``) on ``batch``, through
    ``make_train_step(mesh=mesh)``: on the rank's shard (``shard``) or, with
    ``mesh`` None, on one device; dropout drawn as ``fit`` draws it. Returns
    ``((loss, None, grad_norm, grads, state dict), [grads of each step],
    [loss of each step])``, the last step's, as ``compare_steps`` takes
    them."""
    import torch
    from crnn_ocr_torch.parallel import mesh as mesh_lib
    from crnn_ocr_torch.train import step as step_lib

    cfg, _, state, _, _ = train_setup(g, dtype, dropout, mesh=mesh)
    step = step_lib.make_train_step(cfg, mesh=mesh)
    gen = torch.Generator(device="cuda")
    b = mesh_lib.shard_batch(batch, mesh) if shard else batch
    grads, losses = [], []
    for _ in range(n):
        gen.manual_seed(step_lib.step_seed(seed, state.step))
        m = step(state, b, gen)
        grads.append({k: p.grad.detach().clone()
                      for k, p in state.model.named_parameters()})
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    sd = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    return (losses[-1], None, float(m["grad_norm"]), grads[-1], sd), grads, \
        losses


def dp_same_on_ranks(mesh, sd: dict) -> bool:
    """Whether every rank holds rank 0's ``sd``, bit for bit (rank 0's
    flat tensor broadcast and compared on each rank, the verdicts summed)."""
    import torch
    from crnn_ocr_torch.parallel import mesh as mesh_lib

    flat = torch.cat([v.detach().reshape(-1).float().to(mesh.device)
                      for v in sd.values()])
    ref = mesh_lib.broadcast_(flat.clone(), mesh)
    same = torch.tensor([float(torch.equal(ref, flat))], device=mesh.device)
    return bool(mesh_lib.all_reduce_(same, mesh).item() == mesh.world)


def dp_states_close(k_sd: dict, p_sd: dict, k_grads: list, p_grads: list,
                    steps: int) -> dict:
    """Several steps' states, as ``compare_steps`` holds one step's: the
    BatchNorm statistics rtol 2e-4 / atol 2e-5; each parameter rtol 2e-4 /
    atol 2e-5 (at lr 1e-4 a step moves an element by up to 1e-4, so the
    check can fail), but for its noise elements (at most 1e-5 of their
    tensor's largest gradient in any step, at most 0.1 % of it), whose
    Adam step can take either sign, within ``2 * lr`` a step. Each step's
    gradients are reported, not gated: compare_steps' measure, the
    smallest atol as a share of each leaf's largest gradient that passes
    it at rtol 1e-4. Only the first step starts from one state; after it
    the two states differ at rounding level, which the later steps'
    gradients amplify (measured 1.1e-4, 2.4e-3, 7.9e-4)."""
    needed = [{leaf: float(((kg[leaf] - want).abs() - 1e-4 * want.abs())
                           .clamp(min=0).max())
               / max(float(want.abs().max()), 1e-30)
               for leaf, want in pg.items()}
              for kg, pg in zip(k_grads, p_grads)]
    bad = []
    for leaf, want in p_sd.items():
        got = k_sd[leaf]
        off = (got - want).abs() > 2e-5 + 2e-4 * want.abs()
        if leaf not in p_grads[0]:
            if bool(off.any()):
                bad.append(leaf)
            continue
        noise = None
        for gr in p_grads:
            n = gr[leaf].abs() <= 1e-5 * gr[leaf].abs().max()
            noise = n if noise is None else noise | n
        err_off = (got - want).abs()[off]
        if (bool((off & ~noise).any()) or float(off.float().mean()) > 1e-3
                or (err_off.numel() and float(err_off.max())
                    > 2 * TRAIN_LR * steps)):
            bad.append(leaf)
    return dict(
        grad_atol_needed_max=[max(n.values()) for n in needed],
        grad_atol_needed_worst=[max(n, key=n.get) for n in needed],
        params_off=bad, max_param_abs_err=max(
            float((k_sd[n] - p_sd[n]).abs().max()) for n in p_sd))


def dp_collectives(mesh) -> dict:
    """Phase 29 (a): the process group's backend; ``all_reduce`` and
    ``broadcast`` of CUDA tensors, the port's autograd ``all_reduce``
    (value and gradient) and ``gather_rows``, each against its known
    result."""
    import torch
    import torch.distributed as dist
    from crnn_ocr_torch.parallel import mesh as mesh_lib

    dev, r, w = mesh.device, mesh.rank, mesh.world
    t = torch.full((4,), float(r + 1), device=dev)
    dist.all_reduce(t)
    total = float(w * (w + 1) // 2)
    b = torch.arange(4.0, device=dev) * (r + 1)
    dist.broadcast(b, src=0)
    x = torch.full((3,), float(r + 1), device=dev, requires_grad=True)
    c = torch.arange(1.0, 4.0, device=dev)
    y = mesh_lib.all_reduce(2 * x, mesh)
    (y * c).sum().backward()  # every rank's loss reads y: d/dx = 2 * w * c
    rows = mesh_lib.gather_rows(torch.full((2, 3), r, device=dev), mesh)
    res = dict(
        backend=dist.get_backend(), device=str(dev),
        all_reduce=bool(torch.equal(t, torch.full_like(t, total))),
        broadcast=bool(torch.equal(b, torch.arange(4.0, device=dev))),
        autograd_value=bool(torch.equal(y, torch.full_like(y, 2 * total))),
        autograd_grad=bool(torch.equal(x.grad, 2 * w * c)),
        gather_rows=bool(torch.equal(rows, torch.arange(w, device=dev)
                                     .repeat_interleave(2)[:, None]
                                     .expand(2 * w, 3))))
    require(res["backend"] == "gloo" and all(
        v for k, v in res.items() if k not in ("backend", "device")),
        f"rank {r}: collectives on {dev}: {res}")
    return res


def dp_parity(g, mesh) -> dict:
    """Phase 29 (b), f32, TF32 off, the backbone off cuDNN (as phase 7):
    the DP step on the global batch of 128 (64 rows a rank) against the
    single-device step (rank 0 runs it); the padded leg, 120 lines padded
    to 128, against the 120 lines on one device, unpadded and with an
    all-ones mask (the same masked plain stem), its launches counted; and
    3 steps with dropout 0.2, twice on the mesh (bitwise equal) and once
    on one device. Each rank checks that the ranks hold one state."""
    import torch
    from crnn_ocr_torch.parallel import mesh as mesh_lib

    rank0 = mesh.rank == 0
    cudnn = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        _, _, _, _, full = train_setup(g, "float32", 0.0)
        full = dp_batch(full)
        small = {k: v[:DP_PAD_LINES] for k, v in full.items()}
        padded = mesh_lib.pad_batch_to(dict(small), TRAIN_BATCH)
        ones = dict(small, valid_mask=torch.ones(DP_PAD_LINES,
                                                 device=mesh.device))
        single = dp_steps(g, None, "float32", 0.0, full, shard=False) \
            if rank0 else None
        dp = dp_steps(g, mesh, "float32", 0.0, full)
        if rank0:
            pad_single = dp_steps(g, None, "float32", 0.0, small,
                                  shard=False)
            pad_ones = dp_steps(g, None, "float32", 0.0, ones, shard=False)
        reset_launches()
        pad_dp = dp_steps(g, mesh, "float32", 0.0, padded)
        pad_counts = read_launches()
        drop = [dp_steps(g, mesh, "float32", 0.2, full, DP_DROPOUT_STEPS)
                for _ in range(2)]
        drop_single = (dp_steps(g, None, "float32", 0.2, full,
                                DP_DROPOUT_STEPS, shard=False)
                       if rank0 else None)
    finally:
        torch.backends.cudnn.enabled = cudnn
    require_launches(pad_counts, DP_PADDED_KERNELS,
                     f"rank {mesh.rank}: the padded DP step")
    same = {k: dp_same_on_ranks(mesh, run[0][4]) for k, run in
            (("dp", dp), ("padded", pad_dp), ("dropout", drop[0]))}
    drop_bitwise = drop[0][2] == drop[1][2] and all(
        torch.equal(v, drop[1][0][4][k]) for k, v in drop[0][0][4].items())
    res = dict(ranks_hold_one_state=same, padded_launches=pad_counts,
               dropout_runs_bitwise=drop_bitwise)
    require(all(same.values()) and drop_bitwise,
            f"rank {mesh.rank}: DP states: {res}")
    if not rank0:
        return res
    res["dp_vs_single"], ok = compare_steps(dp[0], single[0])
    res["padded_vs_ones_mask"], ok_ones = compare_steps(pad_dp[0],
                                                        pad_ones[0])
    res["padded_vs_unpadded"], ok_unpad = compare_steps(pad_dp[0],
                                                        pad_single[0])
    drop_losses = [abs(a / b - 1) for a, b in zip(drop[0][2],
                                                  drop_single[2])]
    res["dropout_vs_single"] = dict(
        loss_rel_err=max(drop_losses), losses=drop[0][2],
        single_losses=drop_single[2],
        **dp_states_close(drop[0][0][4], drop_single[0][4], drop[0][1],
                          drop_single[1], DP_DROPOUT_STEPS))
    res["ok"] = dict(dp_vs_single=ok, padded_vs_ones_mask=ok_ones,
                     padded_vs_unpadded=ok_unpad,
                     dropout_vs_single=max(drop_losses) <= 2e-5
                     and not res["dropout_vs_single"]["params_off"])
    require(all(res["ok"].values()), f"phase 29 (b): {res}")
    return res


def dp_counted(g, mesh, card: str) -> dict:
    """Phase 29 (c), timed and counted: ``fonts-hard`` in bf16, dropout
    0.2, ``DP_STEPS`` steps of ``produce_batch`` on the global batch of 128,
    the rank's 64 rows and the DP train step, synchronized; the launch
    counts set to 0 before the timed steps and read after, per rank; the
    loss must fall."""
    import torch
    from crnn_ocr_torch.data.pipeline import produce_batch
    from crnn_ocr_torch.parallel import mesh as mesh_lib
    from crnn_ocr_torch.train import step as step_lib

    cfg, _, state, host, _ = train_setup(g, "bfloat16", 0.2, mesh=mesh)
    train_step = step_lib.make_train_step(cfg, mesh=mesh)
    gen = torch.Generator(device="cuda")
    losses = []

    def step():
        b = mesh_lib.shard_batch(dp_batch(produce_batch(dict(host), "cuda",
                                                        cfg)), mesh)
        gen.manual_seed(step_lib.step_seed(0, state.step))
        losses.append(train_step(state, b, gen)["loss"])

    for _ in range(DP_WARMUP):
        step()
    torch.cuda.synchronize()
    mesh.barrier()
    reset_launches()
    step_ms = []
    for _ in range(DP_STEPS):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    counts = read_launches()
    what = f"rank {mesh.rank}: {DP_STEPS} DP train steps"
    require_launches(counts, {k: v * DP_STEPS
                              for k, v in TRAIN_KERNELS.items()}, what)
    design = read_design(counts, what)
    stem = read_stem_design(counts, "train", what)
    ctc = read_ctc_design(counts, what)
    curve = [float(x) for x in losses]
    first, last5 = curve[0], statistics.mean(curve[-5:])
    require(all(v == v for v in curve) and last5 < first,
            f"{what}: the loss did not fall: {curve}")
    return dict(launches=counts, design=[*design[0], design[1]],
                stem_designs=stem, ctc_designs={k: {d: n for d, n in v.items()}
                                                for k, v in ctc.items()},
                rows_per_rank=TRAIN_BATCH // mesh.world,
                lines_per_s=TRAIN_BATCH * DP_STEPS / (sum(step_ms) / 1e3),
                p50_step_ms=statistics.median(step_ms),
                min_step_ms=min(step_ms), max_step_ms=max(step_ms),
                first_loss=first, last5_mean_loss=last5, loss_curve=curve,
                card=card)


def dp_resume(g, mesh, out: str) -> dict:
    """Phase 29 (c), ``fit`` on the mesh (bf16, dropout 0.2): a straight
    run of ``DP_FIT_STEPS`` steps with an evaluation and a checkpoint every
    ``DP_RESUME_AT`` (rank 0 alone writes), and a fresh state restored at
    step ``DP_RESUME_AT`` and fitted on to the end; the two final states
    must be equal bit for bit (parameters, statistics, Adam's slots, step),
    and the evaluations equal on every rank."""
    import torch
    from crnn_ocr_torch.train import CheckpointManager
    from crnn_ocr_torch.train import loop as loop_lib

    cfg, codec, _, _, batch = train_setup(g, "bfloat16", 0.2)

    def fresh():
        return train_setup(g, "bfloat16", 0.2, mesh=mesh)[2]

    writes = []
    real_save = CheckpointManager._save

    def counted(self, *a, **kw):
        writes.append(int(a[0]))
        return real_save(self, *a, **kw)

    def run(state, steps, d):
        return loop_lib.fit(
            state, cfg, iter([batch] * steps), lambda: iter([batch]), codec,
            loop_lib.FitConfig(steps=steps, eval_every=DP_RESUME_AT,
                               eval_batches=1, log_every=DP_RESUME_AT,
                               checkpoint_dir=d, seed=3, mesh=mesh,
                               metrics_path=os.path.join(d, "m.jsonl")))

    CheckpointManager._save = counted
    try:
        d1, d2 = os.path.join(out, "straight"), os.path.join(out, "resumed")
        straight = run(fresh(), DP_FIT_STEPS, d1)
        resumed = CheckpointManager(d1).restore(fresh(), step=DP_RESUME_AT)
        from_step = resumed.step
        resumed = run(resumed, DP_FIT_STEPS, d2)  # a total step budget
    finally:
        CheckpointManager._save = real_save
    a = {**{f"model/{k}": v for k, v in straight.model.state_dict().items()},
         **{f"opt/{i}/{k}": v for i, s in enumerate(
             straight.optimizer.state.values()) for k, v in s.items()}}
    b = {**{f"model/{k}": v for k, v in resumed.model.state_dict().items()},
         **{f"opt/{i}/{k}": v for i, s in enumerate(
             resumed.optimizer.state.values()) for k, v in s.items()}}
    diff = [k for k in a if not torch.equal(a[k], b[k])]
    evals = []
    if mesh.writer:  # rank 0 alone writes the metrics
        with open(os.path.join(d1, "m.jsonl")) as f:
            evals = [r for r in map(json.loads, f) if r["kind"] == "eval"]
    res = dict(resumed_from=from_step, steps=straight.step,
               bitwise=not diff and straight.step == resumed.step,
               differing=diff[:5], checkpoint_writes=writes,
               ranks_hold_one_state=dp_same_on_ranks(mesh, a),
               evaluations=evals)
    require(res["bitwise"] and res["ranks_hold_one_state"],
            f"rank {mesh.rank}: the resumed DP run differs from the "
            f"straight one: {res}")
    require(bool(writes) == mesh.writer,
            f"rank {mesh.rank} wrote checkpoints {writes}")
    return res


def dp_rank(rank: int, world: int, store: str, out: str, card: str) -> None:
    """Phase 29 (a)-(c) on one of ``world`` ranks sharing ``cuda:0`` over
    gloo (NCCL refuses two ranks on one card); its results go to
    ``<out>/rank<r>.json``. A failed check raises: the rank exits non-zero
    and the phase fails."""
    sys.path.insert(0, REPO)
    import numpy as np
    import torch
    from crnn_ocr_torch.parallel import mesh as mesh_lib

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = mesh_lib.init_process_mesh(rank, world, f"file://{store}",
                                      device="cuda:0",
                                      timeout_s=DP_COLLECTIVE_S)
    try:
        g = np.load(os.path.join(REPO, "crnn_ocr_torch", "testdata",
                                 "greedy_goldens.npz"))
        res = {"rank": rank, "collectives": dp_collectives(mesh)}
        t0 = time.perf_counter()
        res["parity"] = dp_parity(g, mesh)
        res["counted"] = dp_counted(g, mesh, card)
        res["resume"] = dp_resume(g, mesh, out)
        res["rank_s"] = time.perf_counter() - t0
    finally:
        mesh_lib.close_process_mesh(mesh)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f, default=str)


def dp_serve(card: str, g) -> dict:
    """Phase 29 (d): ``fonts-hard`` on a local mesh of ``cuda:0`` twice
    (one process, one replica, the two shards one after the other): bf16
    at B 255 (padded to 256 with a blank row) against the single-device
    predictor's texts, with K1 once and K2 twice per shard; f32 on the 64
    golden lines against the JAX predictor's texts and scores (phase 3's
    tolerance). Times are two shards on one card: the mesh's overhead, not
    a speed-up."""
    import numpy as np
    import torch
    from crnn_ocr_torch import load_pretrained
    from crnn_ocr_torch.parallel import make_mesh

    lines = golden_lines(g, "hard")
    batch = (lines * (DP_SERVE_BATCH // len(lines) + 1))[:DP_SERVE_BATCH]
    mesh = make_mesh(devices=["cuda:0", "cuda:0"])
    single = load_pretrained("fonts-hard", device="cuda")
    dp = load_pretrained("fonts-hard", mesh=mesh)
    want = [p.text for p in single.predict(batch)]
    dp.predict(batch)  # warm
    torch.cuda.synchronize()
    reset_launches()
    got = [p.text for p in dp.predict(batch)]
    counts = read_launches()
    shards = mesh.size
    what = f"local mesh of {shards}: one predict of {DP_SERVE_BATCH} lines"
    require_launches(counts, {"fused_stem": shards, "bigru": 2 * shards},
                     what)
    design = read_design(counts, what)
    stem = read_stem_design(counts, "serve", what)

    def ms(pred):
        return statistics.median(
            time_host(lambda: pred.predict(batch)) for _ in range(5))

    texts32, scores32 = [], []
    for p in load_pretrained("fonts-hard", dtype="float32",
                             mesh=mesh).predict(lines):
        texts32.append(p.text)
        scores32.append(p.score)
    want_t = [str(t) for t in g["hard_texts_f32"]]
    want_s = g["hard_scores_f32"]
    bad32 = [(i, a, b) for i, (a, b) in enumerate(zip(texts32, want_t))
             if a != b]
    res = dict(mesh=str(mesh), batch=DP_SERVE_BATCH, launches=counts,
               design=[*design[0], design[1]], stem_designs=stem,
               bf16_texts_off_single=sum(a != b for a, b in zip(got, want)),
               f32_text_mismatches=bad32,
               f32_max_score_rel_err=float((np.abs(np.array(scores32)
                                                   - want_s)
                                            / (np.abs(want_s) + 1e-30))
                                           .max()),
               f32_scores_ok=bool(np.allclose(scores32, want_s, rtol=1e-4,
                                              atol=1e-5)),
               single_ms=ms(single), mesh_ms=ms(dp),
               note="two shards on one card: the mesh's overhead, not a "
                    "DP speed-up", card=card)
    emit("dp_serve", **res)
    require(res["bf16_texts_off_single"] == 0 and not bad32
            and res["f32_scores_ok"], f"phase 29 (d): {res}")
    return res


def time_host(fn) -> float:
    """One call of ``fn`` on the host clock, synchronized, in ms."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def dp_clis(card: str, tmp: str) -> dict:
    """Phase 29 (e): ``python -m crnn_ocr_torch.cli.train --dataset
    synthetic --n_devices 1 --steps 20`` on the card (bf16 by ``--dtype
    auto``), then ``cli.predict --model <its save path>`` on 16 synthetic
    lines as PNGs; and ``--n_devices 2`` on this one-card machine, which
    must exit non-zero with ``make_mesh``'s message."""
    import cv2
    import numpy as np
    from crnn_ocr_torch.data.synthetic import SyntheticTextlines

    save = os.path.join(tmp, "cli_model")
    train = [sys.executable, "-m", "crnn_ocr_torch.cli.train", "--dataset",
             "synthetic", "--steps", "20", "--eval_every", "20",
             "--log_every", "10", "--batch_size", "64"]
    t0 = time.perf_counter()
    r = subprocess.run([*train, "--n_devices", "1", "--save_path", save],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    train_s = time.perf_counter() - t0
    imgs = os.path.join(tmp, "cli_lines")
    os.makedirs(imgs)
    images, _ = SyntheticTextlines().sample_batch(
        16, np.random.default_rng(0))
    for i, im in enumerate(images):
        require(cv2.imwrite(os.path.join(imgs, f"l{i:02d}.png"), im),
                "imwrite")
    out = os.path.join(tmp, "cli_preds.tsv")
    p = subprocess.run([sys.executable, "-m", "crnn_ocr_torch.cli.predict",
                        "--model", save, "--image_dir", imgs, "--greedy",
                        "--result", out], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    rows = (open(out).read().splitlines() if os.path.exists(out) else [])
    two = subprocess.run([*train, "--n_devices", "2", "--save_path",
                          os.path.join(tmp, "cli_two")], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    with open(os.path.join(save, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    res = dict(train_rc=r.returncode, train_s=train_s,
               train_steps=[x["step"] for x in recs if x["kind"] == "train"],
               train_losses=[x["loss"] for x in recs if x["kind"] == "train"],
               dtype_auto="dtype: auto -> bfloat16" in r.stderr,
               predict_rc=p.returncode, predict_rows=len(rows),
               two_rc=two.returncode,
               two_message=two.stderr.strip().splitlines()[-1:],
               card=card)
    emit("dp_clis", **res)
    require(r.returncode == 0 and res["dtype_auto"]
            and res["train_steps"][-1] == 20, f"train CLI: {r.stderr[-2000:]}")
    require(p.returncode == 0 and len(rows) == 16,
            f"predict CLI: {p.stderr[-2000:]}")
    require(two.returncode != 0 and "requested a 2-device mesh but only 1 "
            "devices are available" in two.stderr,
            f"--n_devices 2 on one card: {two.returncode} {two.stderr[-800:]}")
    return res


def phase_dp(card: str, g, single_train: dict) -> dict:
    """Phase 29: data parallelism on the one card. Two gloo ranks share
    ``cuda:0`` (spawned; the kernels were built by ``phase_build`` before):
    (a) the collectives, (b) DP against one device in f32, the padded leg
    and dropout, (c) the counted DP fine-tune and a bitwise resume of
    ``fit``; then, in this process, (d) local-mesh serving and (e) the
    training and predict CLIs. ``single_train``: phase 8's single-device
    lines/s and p50 in this call."""
    import tempfile

    import torch
    from crnn_ocr_torch.parallel import spawn_ranks

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        spawn_ranks(dp_rank, DP_WORLD,
                    args=(DP_WORLD, os.path.join(tmp, "store"), tmp, card),
                    timeout_s=DP_SPAWN_S)
        ranks = []
        for r in range(DP_WORLD):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        spawn_s = time.perf_counter() - t0
        r0 = ranks[0]
        emit("dp_collectives", ranks=[r["collectives"] for r in ranks],
             card=card)
        emit("dp_parity", **r0["parity"], other_ranks=[
            r["parity"] for r in ranks[1:]], card=card)
        emit("dp_train", ranks=DP_WORLD, per_rank=[r["counted"]
                                                   for r in ranks],
             single_device=single_train,
             note="two ranks sharing one H100 over gloo: the collectives' "
                  "overhead, not a DP speed-up", card=card)
        emit("dp_resume", ranks=[r["resume"] for r in ranks], card=card)
        serve = dp_serve(card, g)
        clis = dp_clis(card, tmp)
    emit("dp_phase", spawn_s=spawn_s, rank_s=[r["rank_s"] for r in ranks],
         total_s=time.perf_counter() - t0, card=card)
    return dict(counted=r0["counted"], serve=serve, clis=clis)


# ---- phase 30: migration, both ways, and the JAX package's orbax
# ---- checkpoints on the card (no kernel of its own)

ORBAX_FIXTURE = os.path.join(REPO, "crnn_ocr_torch", "testdata",
                             "orbax_small")
ORBAX_GOLDENS = os.path.join(REPO, "crnn_ocr_torch", "testdata",
                             "orbax_goldens.npz")
# the fixture's model has one BiGRU layer
ORBAX_TRAIN_KERNELS = dict(TRAIN_KERNELS, bigru_train=1, bigru_backward=1)


def tree_digest(directory: str) -> str:
    """sha256 over a directory's relative paths and bytes."""
    import hashlib

    h = hashlib.sha256()
    for root, dirs, files in sorted(os.walk(directory)):
        dirs.sort()
        for name in sorted(files):
            path = os.path.join(root, name)
            h.update(os.path.relpath(path, directory).encode())
            with open(path, "rb") as f:
                h.update(f.read())
    return h.hexdigest()


def flat_tree(tree, prefix: str = "") -> dict:
    """A nested dict's leaves keyed by their ``/``-joined paths."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_tree(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def migrate_full_width(g, dev: str = "cuda") -> dict:
    """Phase 30 (a): ``fonts-hard``'s bundled weights saved as a model
    directory, ``cli.migrate export`` (the port's HDF5 writer: no h5py
    here), the ``.h5`` read back by the port's reader, ``cli.migrate
    import`` on the card, and the imported directory served: bf16 against
    ``load_pretrained``'s texts with its launches counted, f32 against the
    JAX goldens at phase 3's gate. ``dev="cpu"`` rehearses it on the CPU
    (no launches to count there)."""
    import tempfile

    import numpy as np
    import torch
    from crnn_ocr_torch import load_pretrained
    from crnn_ocr_torch.cli import migrate
    from crnn_ocr_torch.infer import init_predictor
    from crnn_ocr_torch.infer.predictor import Predictor
    from crnn_ocr_torch.infer.pretrained import model_weights
    from crnn_ocr_torch.infer.weights import import_keras_h5, params_from_jax
    from crnn_ocr_torch.train.checkpoint import (
        CheckpointManager,
        load_codec,
        load_model_config,
    )
    from crnn_ocr_torch.train.state import create_train_state

    cfg, params, stats, codec = model_weights("fonts-hard", "float32")
    lines = golden_lines(g, "hard")
    res = {}
    with tempfile.TemporaryDirectory(prefix="crnn_migrate_") as tmp:
        native, ref, imported = (os.path.join(tmp, n)
                                 for n in ("native", "ref", "imported"))
        state = create_train_state(cfg, params_from_jax(params, stats),
                                   device=dev)
        CheckpointManager(native).save(0, state, cfg, codec)
        t0 = time.perf_counter()
        rc = migrate.main(["export", "--src", native, "--dest", ref])
        res["export_ms"] = (time.perf_counter() - t0) * 1e3
        require(rc == 0, f"migrate export exited {rc}")
        h5 = os.path.join(ref, "model.h5")
        res["h5_bytes"] = os.path.getsize(h5)
        t0 = time.perf_counter()
        back = import_keras_h5(h5, cfg)
        res["h5_read_ms"] = (time.perf_counter() - t0) * 1e3
        want = {**flat_tree(params, "params/"),
                **flat_tree(stats, "stats/")}
        got = {**flat_tree(back[0], "params/"),
               **flat_tree(back[1], "stats/")}
        res["h5_bit_equal"] = (sorted(got) == sorted(want) and all(
            np.array_equal(got[k], want[k]) for k in want))
        require(res["h5_bit_equal"], "model.h5 read back differs from the "
                                     "bundled weights")
        res["model_json"] = os.path.exists(os.path.join(ref, "model.json"))
        t0 = time.perf_counter()
        rc = migrate.main(["import", "--src", ref, "--dest", imported,
                           "--device", dev])
        res["import_ms"] = (time.perf_counter() - t0) * 1e3
        require(rc == 0, f"migrate import exited {rc}")
        # bf16 (as fonts-hard ships): load_pretrained's texts on the card
        want_bf16 = [p.text for p in
                     load_pretrained("fonts-hard", device=dev)
                     .predict(lines)]
        pred = Predictor(
            dataclasses.replace(load_model_config(imported),
                                dtype="bfloat16"),
            CheckpointManager(imported).restore_inference(),
            load_codec(imported), device=dev)
        pred.predict(lines)  # warm
        reset_launches()
        out = pred.predict(lines)
        counts = read_launches()
        bad = [(i, a.text, b) for i, (a, b) in enumerate(zip(out, want_bf16))
               if a.text != b]
        res["bf16"] = dict(lines=len(out), text_mismatches=bad,
                           launches={k: v for k, v in counts.items() if v})
        if dev == "cuda":
            what = "the imported fonts-hard, bf16"
            require_launches(counts, {"fused_stem": 1, "bigru": 2}, what)
            res["bf16"]["k1_design"] = read_stem_design(counts, "serve", what)
            res["bf16"].update(design_fields(*read_design(counts, what)))
        require(not bad, f"imported fonts-hard bf16 texts differ from "
                         f"load_pretrained's: {bad}")
        # f32: the JAX goldens at phase 3's gate
        t0 = time.perf_counter()
        pred = init_predictor(imported, device=dev)
        res["init_predictor_ms"] = (time.perf_counter() - t0) * 1e3
        out = pred.predict(lines)
        texts, scores = [o.text for o in out], [o.score for o in out]
        want_t = [str(t) for t in g["hard_texts_f32"]]
        bad = [(i, a, b) for i, (a, b) in enumerate(zip(texts, want_t))
               if a != b]
        fields = _tolerance_fields(scores, g["hard_scores_f32"], 1e-4, 1e-5)
        res["f32"] = dict(lines=len(out), text_mismatches=bad,
                          max_score_rel_err=fields["max_rel_err"],
                          scores_ok=fields["ok"])
        require(not bad and fields["ok"],
                f"imported fonts-hard f32 differs from the JAX golden: "
                f"{res['f32']}")
    return res


def orbax_resume_on_card(dev: str = "cuda") -> dict:
    """Phase 30 (b): the committed orbax fixture (JAX's train state after
    2 Adam steps) restored into a train state on the card; one f32 step
    (TF32 and the backbone's cuDNN off, as phase 7) through the kernels,
    counted, against JAX's third step (``orbax_goldens.npz``).
    ``dev="cpu"`` rehearses it on the CPU."""
    import numpy as np
    import torch
    from crnn_ocr_torch.data.pipeline import produce_batch
    from crnn_ocr_torch.train import checkpoint as ckpt
    from crnn_ocr_torch.train.state import create_train_state
    from crnn_ocr_torch.train.step import make_train_step

    gold = np.load(ORBAX_GOLDENS)
    lr = float(gold["lr"])
    before = tree_digest(ORBAX_FIXTURE)
    cfg = ckpt.load_model_config(ORBAX_FIXTURE)
    codec = ckpt.load_codec(ORBAX_FIXTURE)
    state = create_train_state(cfg, device=dev, learning_rate=lr)
    t0 = time.perf_counter()
    ckpt.CheckpointManager(ORBAX_FIXTURE).restore(state)
    sync(dev)
    read_ms = (time.perf_counter() - t0) * 1e3
    require(state.step == int(gold["step"]),
            f"restored step {state.step}, the fixture's {int(gold['step'])}")
    truth = [str(t) for t in gold["truth"]]
    labels, lab_len = codec.encode_batch(truth, TRAIN_MAX_LABEL)
    batch = produce_batch({"the_input": gold["canvas"],
                           "heights": gold["heights"],
                           "widths": gold["widths"], "the_labels": labels,
                           "label_length": lab_len,
                           "bucket": int(gold["bucket"]), "texts": truth},
                          dev, cfg)
    step = make_train_step(cfg)
    cudnn = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        reset_launches()
        m = step(state, batch)
        loss = float(m["loss"])
        counts = read_launches()
    finally:
        torch.backends.cudnn.enabled = cudnn
    designs = {}
    if dev == "cuda":
        what = "the resumed orbax step"
        require_launches(counts, ORBAX_TRAIN_KERNELS, what)
        designs = dict(k1=read_stem_design(counts, "train", what),
                       k3=design_fields(*read_design(counts, what)),
                       ctc=read_ctc_design(counts, what))
    # JAX's third step: parameters rtol 2e-4 / atol 2e-5, but for elements
    # whose JAX gradient is at the f32 noise of its sum (noise/), at most
    # 0.1 % of a tensor, within 2 * lr (tests/test_torch_train.py)
    params = dict(state.model.named_parameters())
    off_leaves, max_err = [], 0.0
    for k, v in state.model.state_dict().items():
        got, want = v.detach().float().cpu().numpy(), gold[f"after/{k}"]
        err = np.abs(got - want)
        max_err = max(max_err, float(err.max()))
        off = err > 2e-5 + 2e-4 * np.abs(want)
        if k in params:
            shape = tuple(gold[f"noise_shape/{k}"])
            noise = np.unpackbits(gold[f"noise/{k}"])[:int(np.prod(shape))]
            noise = noise.reshape(shape).astype(bool)
            if (np.any(off & ~noise) or off.mean() > 1e-3
                    or np.any(err[off] > 2 * lr)):
                off_leaves.append(k)
        elif off.any():
            off_leaves.append(k)
    res = dict(fixture=os.path.relpath(ORBAX_FIXTURE, REPO),
               fixture_bytes=sum(os.path.getsize(os.path.join(d, f))
                                 for d, _, fs in os.walk(ORBAX_FIXTURE)
                                 for f in fs),
               read_ms=read_ms, step=state.step, loss=loss,
               jax_loss=float(gold["loss"]),
               loss_rel_err=abs(loss / float(gold["loss"]) - 1),
               max_param_abs_err=max_err, params_off=off_leaves,
               launches={k: v for k, v in counts.items() if v},
               designs=designs,
               fixture_unchanged=tree_digest(ORBAX_FIXTURE) == before,
               tolerance="loss rtol 1e-4; params rtol 2e-4 / atol 2e-5 "
                         "(JAX-gradient noise elements: 2 * lr, at most "
                         "0.1 % of a tensor)")
    require(res["loss_rel_err"] <= 1e-4 and not off_leaves,
            f"the resumed orbax step differs from JAX's third: {res}")
    require(res["fixture_unchanged"], "the orbax fixture was changed")
    return res


def phase_migration(card: str, g) -> None:
    """Phase 30: ``migrate_full_width`` and ``orbax_resume_on_card``,
    with the zstd decoder that read the fixture."""
    from crnn_ocr_torch.utils import zstd

    full = migrate_full_width(g)
    emit("migration_full_width", card=card, model="fonts-hard", **full)
    resume = orbax_resume_on_card()
    emit("orbax_resume", card=card, **resume)
    emit("zstd", path=zstd.describe())


SURFACE_GOLDENS = os.path.join(REPO, "crnn_ocr_torch", "testdata",
                               "surface_goldens.npz")
SURFACE_SEED = 31
# fonts-hard's training CTC: B 128, 62 frames (bucket 256 / 4 less the 2
# sliced), 62 classes and the blank, labels padded to 32
SURFACE_CTC = (128, 62, 63, 32)
SURFACE_WARP = (256, 32, 128)  # B, H, W: the serving batch's frames
# name -> (Ho, Wo, C): a warp up to twice the width (N = 2 H W), down to
# half each side (N = H W / 4), and 3 channels at the image's size
SURFACE_SIZES = {"up": (32, 256, 1), "down": (16, 64, 1), "c3": (32, 128, 3)}
SURFACE_GOLDEN_CTC_ROWS = 4  # samples whose whole JAX gradient is kept
SURFACE_KERNELS = {"ctc_alpha": 2, "ctc_beta": 2, "grid_sample": 3,
                   "grid_sample_bwd": 3}
# The CTC gradient's gates, (atol, rtol) a value. Over T 62 frames the
# gradient, exp(alpha + beta + loss - emission), carries K6's and K7's
# log-domain errors (MUFU ex2/lg2, ~1.5e-4 each at this shape), a relative
# error of up to about their sum. On the H100 the kernels read 1.82e-4
# (blank 0) and 1.42e-4 (blank 62) against the plain versions and 4.6e-5
# against JAX; log-probs rounded to TF32's significand read 1.28e-2, to
# bf16's 0.115 (``surface_ctc_control``). The limit lies between.
CTC_GRAD_TOL = (1e-6, 5e-4)
CTC_GRAD_JAX_TOL = (1e-6, 1e-4)


def surface_inputs() -> dict:
    """Phase 31's inputs, numpy, from ``SURFACE_SEED`` through
    ``RandomState`` (whose streams numpy keeps fixed across versions), so
    that ``tools/gen_torch_goldens.py --surface`` rebuilds them for JAX:
    log-probs (B, T, C) f32 (a float64 log-softmax of normal logits),
    labels drawn in [0, C - 2] (the blank-last labels; add 1 for blank 0),
    label lengths 1-25, input lengths 40-62 and at least 2 L + 1; images
    (B, H, W) and (B, H, W, 3) in [0, 1], theta the identity plus N(0,
    0.1) (samples past the borders), and an upstream gradient per warp."""
    import numpy as np

    rs = np.random.RandomState(SURFACE_SEED)
    B, T, C, L = SURFACE_CTC
    logits = rs.standard_normal((B, T, C))
    m = logits.max(-1, keepdims=True)
    lse = m + np.log(np.exp(logits - m).sum(-1, keepdims=True))
    ll = rs.randint(1, 26, B).astype(np.int32)
    il = np.maximum(rs.randint(40, T + 1, B), 2 * ll + 1).astype(np.int32)
    labels = rs.randint(0, C - 1, (B, L)).astype(np.int32)
    labels[np.arange(L)[None, :] >= ll[:, None]] = C - 1  # blank padding
    Bw, H, W = SURFACE_WARP
    out = dict(lp=(logits - lse).astype(np.float32), labels=labels, il=il,
               ll=ll, img=rs.uniform(size=(Bw, H, W)).astype(np.float32),
               img3=rs.uniform(size=(Bw, H, W, 3)).astype(np.float32),
               theta=(np.float32([1, 0, 0, 0, 1, 0])
                      + rs.normal(scale=0.1, size=(Bw, 6))).astype(
                          np.float32))
    for name, (Ho, Wo, Cc) in SURFACE_SIZES.items():
        out[f"g_{name}"] = rs.standard_normal((Bw, Ho, Wo, Cc)).astype(
            np.float32)
    return out


def labels_for_blank(labels, blank: int):
    """The blank-last labels for ``blank`` 0 or C - 1: at blank 0 every
    class moves one up, and the padding (C - 1) becomes 0."""
    C = SURFACE_CTC[2]
    require(blank in (0, C - 1), f"blank {blank}: 0 or {C - 1} only")
    return labels if blank else (labels + 1) % C


def surface_imports() -> dict:
    """Phase 31 (d): each port package's ``__all__`` resolves, each JAX
    module path (the files of ``crnn_ocr_tpu/``) imports in the port, and
    each counterpart that ``counterparts.JAX_COUNTERPARTS`` names resolves,
    in a process without JAX."""
    import importlib

    from crnn_ocr_torch.counterparts import JAX_COUNTERPARTS

    require("jax" not in sys.modules, "JAX is loaded in the card's process")
    root = os.path.join(REPO, "crnn_ocr_tpu")
    modules = []
    for d, _, files in os.walk(root):
        for f in files:
            if not f.endswith(".py") or "libcrnnocr" in f:
                continue
            rel = os.path.relpath(os.path.join(d, f), root)[:-3].split(os.sep)
            modules.append(".".join(rel[:-1] if rel[-1] == "__init__"
                                    else rel))
    names = 0
    for rel in sorted(modules):
        mod = importlib.import_module(
            "crnn_ocr_torch" + (f".{rel}" if rel else ""))
        for name in getattr(mod, "__all__", ()):
            require(getattr(mod, name, None) is not None,
                    f"crnn_ocr_torch.{rel}.{name} does not resolve")
            names += 1
    targets = 0
    for key, (target, why) in JAX_COUNTERPARTS.items():
        require(bool(why), f"{key}: no reason")
        if target is not None:
            rel, name = target.split(":")
            require(hasattr(importlib.import_module(f"crnn_ocr_torch.{rel}"),
                            name), f"{key} -> {target} does not resolve")
            targets += 1
    require("jax" not in sys.modules and "crnn_ocr_tpu" not in sys.modules,
            "the port's imports loaded JAX or the JAX package")
    return dict(modules=len(modules), exported_names=names,
                mapped=len(JAX_COUNTERPARTS), counterparts=targets)


def surface_run(t: dict):
    """The surface's new shapes through ``crnn_ocr_torch.ops``, forward and
    backward: ``ctc_forward_log_loss`` at blank 0 and
    ``ctc_loss_from_log_probs`` (blank C - 1), ``grid_sample_affine`` up
    and down, ``bilinear_sample`` over 3 channels. -> {case: tensors}."""
    import torch
    from crnn_ocr_torch import ops

    C = SURFACE_CTC[2]
    out = {}
    for blank in (0, C - 1):
        x = t["lp"].clone().requires_grad_(True)
        lab = labels_for_blank(t["labels"], blank)
        if blank == C - 1:
            loss = ops.ctc_loss_from_log_probs(x, lab, t["il"], t["ll"])
        else:
            loss = ops.ctc.ctc_forward_log_loss(x, lab, t["il"], t["ll"],
                                                blank)
        loss.sum().backward()
        out[f"ctc_b{blank}"] = dict(loss=loss.detach(), grad=x.grad)
    for name, (Ho, Wo, Cc) in SURFACE_SIZES.items():
        th = t["theta"].clone().requires_grad_(Cc == 1)
        if Cc == 1:
            im = t["img"][..., None].clone().requires_grad_(True)
            y = ops.grid_sample_affine(im, th, Ho, Wo)
            leaf = th
        else:
            im = t["img3"].clone().requires_grad_(True)
            leaf = ops.affine_grid(th, Ho, Wo).requires_grad_(True)
            y = ops.bilinear_sample(im, leaf)
        (y * t[f"g_{name}"]).sum().backward()
        out[name] = dict(out=y.detach(), d_img=im.grad,
                         **{"d_theta" if Cc == 1 else "d_coords": leaf.grad})
    return out


def surface_planes(t: dict, name: str, rows=None):
    """The sampler's kernel-level operands of warp ``name``: the images as
    (B * C, H, W) planes, f32 pixel coordinates repeated per channel and
    the upstream gradient, as ``ops.grid_sample.bilinear_sample`` folds
    them; ``rows``: the first that many images only."""
    from crnn_ocr_torch.kernels import grid_sample as gs
    from crnn_ocr_torch.ops.grid_sample import affine_grid

    Ho, Wo, Cc = SURFACE_SIZES[name]
    img = t["img"][..., None] if Cc == 1 else t["img3"]
    theta, g = t["theta"], t[f"g_{name}"]
    if rows is not None:
        img, theta, g = img[:rows], theta[:rows], g[:rows]
    B, H, W, _ = img.shape
    x, y = gs.pixel_coords(affine_grid(theta, Ho, Wo), H, W)
    planes = img.permute(0, 3, 1, 2).reshape(B * Cc, H, W).contiguous()
    g = g.permute(0, 3, 1, 2).reshape(B * Cc, Ho * Wo).contiguous()
    return (planes, x.repeat_interleave(Cc, 0).contiguous(),
            y.repeat_interleave(Cc, 0).contiguous(), g)


def surface_sampler_checks(t: dict) -> dict:
    """K11 and K12 on each warp's planes against their plain versions
    (uncounted): out, dx and dy within 1e-6 + 1e-6 * |plain|, d_img within
    1e-5 + 1e-5 * |plain| (phase 9's gates); K12's plan; CUDA-event ms of
    each kernel and of the plain versions. The bound is the warp's own
    function's: the images, each image's pixel coordinates and the samples
    (backward: also the upstream gradient, d_img and the coordinates'
    gradient) once each; ``kernel_bytes`` and ``kernel_bound_ms`` count
    the folded operands the kernels move, the coordinates (and their
    gradients) once a channel. The up and down warps also run at B 128,
    where K12's plan takes 2 CTAs an image and sums their tiles over the
    cluster."""
    from crnn_ocr_torch.kernels import grid_sample as gs

    res = {}
    for name in SURFACE_SIZES:
        Cc = SURFACE_SIZES[name][2]
        for rows in (None, 128) if Cc == 1 else (None,):
            img, x, y, g = surface_planes(t, name, rows)
            B, H, W = img.shape
            N = x.shape[1]
            p = gs.plan(B, H, W, N, img.element_size())
            out = gs.sample_pix(img, x, y)
            dimg, dx, dy = gs.sample_pix_bwd(img, x, y, g)
            want = gs.sample_pix_plain(img, x, y)
            p_dimg, p_dx, p_dy = gs.sample_pix_bwd_plain(img, x, y, g)
            errs, ok = {}, True
            for key, a, b, atol, rtol in (
                    ("out", out, want, 1e-6, 1e-6),
                    ("dx", dx, p_dx, 1e-6, 1e-6),
                    ("dy", dy, p_dy, 1e-6, 1e-6),
                    ("d_img", dimg, p_dimg, 1e-5, 1e-5)):
                errs[key], good = _close(a, b, atol, rtol)
                ok = ok and good
            key = name if rows is None else f"{name}_b{rows}"
            require(ok, f"sampler {key}: errors {errs} beyond the gates")
            # the function's bytes: images (d_img), the B / C images' x and
            # y (their gradients), samples (upstream gradient) once each
            px, xy, smp = nbytes(img), 2 * 4 * (B // Cc) * N, nbytes(out)
            f_ms, f_by = bound_ms(px + xy + smp, 20 * B * N, "float32")
            b_ms, b_by = bound_ms(2 * px + 2 * xy + smp, 40 * B * N,
                                  "float32")
            kernel_bytes = dict(fwd=nbytes(img, x, y, out),
                                bwd=nbytes(img, x, y, g, dimg, dx, dy))
            row = dict(B=B, H=H, W=W, N=N, errors=errs,
                       plan=dict(design=p.design, cluster=p.cluster,
                                 span=p.span, tile=p.tile, staged=p.staged,
                                 ctas=p.ctas))
            if rows is None:
                row.update(
                    fwd_ms=time_ms(lambda: gs.sample_pix(img, x, y)),
                    bwd_ms=time_ms(lambda: gs.sample_pix_bwd(img, x, y, g)),
                    fwd_plain_ms=time_ms(
                        lambda: gs.sample_pix_plain(img, x, y), reps=5),
                    bwd_plain_ms=time_ms(
                        lambda: gs.sample_pix_bwd_plain(img, x, y, g),
                        reps=5),
                    fwd_bound_ms=f_ms, fwd_bound_by=f_by,
                    bwd_bound_ms=b_ms, bwd_bound_by=b_by,
                    bytes=dict(fwd=px + xy + smp, bwd=2 * px + 2 * xy + smp),
                    kernel_bytes=kernel_bytes,
                    kernel_bound_ms=dict(
                        fwd=bound_ms(kernel_bytes["fwd"], 20 * B * N,
                                     "float32")[0],
                        bwd=bound_ms(kernel_bytes["bwd"], 40 * B * N,
                                     "float32")[0]))
            res[key] = row
    return res


def surface_fold_cost(t: dict, reps: int = 20) -> dict:
    """What folding the channels into the batch costs beside K11 and K12:
    ``ops.bilinear_sample``'s forward and backward (into the image and the
    coordinates) on the c3 warp's images, and on their first channel alone
    with the same coordinates, traced over ``reps`` calls each (after a
    warm-up call): a call's device records (kernels, copies, memsets) by
    name, the sampler's (``sample_fwd``, ``sample_bwd_*``) device ms and
    the rest's, and the call's CUDA-event ms. The c3 run's rest less the
    one-channel run's is the fold's: the planes' permute copy, the
    coordinates repeated per channel, the gradients' copies back and the
    coordinate gradient's sum over the channels."""
    import torch
    from crnn_ocr_torch import ops

    Ho, Wo, Cc = SURFACE_SIZES["c3"]
    coords = ops.affine_grid(t["theta"], Ho, Wo)
    res = {}
    for c in (Cc, 1):
        img = t["img3"][..., :c].contiguous()
        g = t["g_c3"][..., :c].contiguous()

        def call():
            im = img.clone().requires_grad_(True)
            xy = coords.clone().requires_grad_(True)
            ops.bilinear_sample(im, xy).backward(g)

        call()
        prof, _ = profiled(lambda: [call() for _ in range(reps)])
        recs = device_work(prof)
        is_sampler = [("sample_fwd" in e.name or "sample_bwd" in e.name)
                      for e in recs]
        sampler = [e for e, k in zip(recs, is_sampler) if k]
        rest = [e for e, k in zip(recs, is_sampler) if not k]

        def ms(es):
            return sum(e.time_range.end - e.time_range.start
                       for e in es) / reps / 1e3

        res[f"c{c}"] = dict(
            records=len(recs) / reps, sampler_records=len(sampler) / reps,
            sampler_device_ms=ms(sampler), rest_device_ms=ms(rest),
            rest_names={k: v / reps for k, v in sorted(collections.Counter(
                e.name[:60] for e in rest).items())},
            call_ms=time_ms(call, reps=10))
    c3, c1 = res[f"c{Cc}"], res["c1"]
    res["fold_records"] = c3["records"] - c1["records"]
    res["fold_device_ms"] = c3["rest_device_ms"] - c1["rest_device_ms"]
    return res


def surface_ctc_checks(t: dict) -> dict:
    """K6 and K7 at blank 0 (the permuted columns) against their plain
    versions on the same emissions (uncounted, K6/K7's phase 6 gate), with
    their CUDA-event ms and the permutation's: the blank-0 loss forward
    against the blank-last one on the same log-probs."""
    import torch
    from crnn_ocr_torch.kernels import ctc_loss as cl
    from crnn_ocr_torch.ops import ctc

    C = SURFACE_CTC[2]
    lp = t["lp"]
    b0 = lp[..., list(range(1, C)) + [0]]  # the blank's column last
    emits, flags, lens, _, _ = cl.prepare(b0, t["labels"], t["il"], t["ll"])
    res = {}
    for name, fn, plain in (("ctc_alpha", cl.ctc_alphas, cl.ctc_alphas_plain),
                            ("ctc_beta", cl.ctc_betas, cl.ctc_betas_plain)):
        err, ok = ctc_close(fn(emits, flags, lens), plain(emits, flags, lens))
        require(ok, f"{name} at blank 0: max error {err}")
        B, T, S = emits.shape
        b_ms, b_by = bound_ms(nbytes(emits, flags, lens, emits),
                              20 * B * T * S, "float32")
        res[name] = dict(B=B, T=T, S=S, max_abs_err=err,
                         ms=time_ms(lambda: fn(emits, flags, lens)),
                         plain_ms=time_ms(lambda: plain(emits, flags, lens),
                                          reps=5),
                         bound_ms=b_ms, bound_by=b_by)
    lab0 = labels_for_blank(t["labels"], 0)
    with torch.no_grad():
        res["loss_fwd_ms"] = {
            "blank_0": time_ms(lambda: ctc.ctc_forward_log_loss(
                lp, lab0, t["il"], t["ll"], 0)),
            "blank_last": time_ms(lambda: ctc.ctc_loss_from_log_probs(
                lp, t["labels"], t["il"], t["ll"]))}
    return res


def rtol_read(got, want, atol: float) -> float:
    """The least rtol at which ``got`` is within ``atol + rtol * |want|`` of
    ``want`` everywhere (inf where ``want`` is 0 and the gap over atol)."""
    import torch

    gap = ((got.float() - want.float()).abs() - atol).clamp(min=0)
    return float(torch.where(gap > 0, gap / want.float().abs(),
                             torch.zeros_like(gap)).max())


def surface_against(got: dict, want: dict, golden) -> dict:
    """The counted run against the plain run (``want``, the same entry
    points under ``plain_kernels``) and against the JAX goldens. CTC: the
    loss within 1e-5 * |plain| (JAX: 1e-4); the gradient within
    ``CTC_GRAD_TOL`` (JAX: ``CTC_GRAD_JAX_TOL``), each with its reading
    (``/rtol_read``: the least rtol that passes at the gate's atol).
    Warps: out 1e-5, d_img 1e-5 + 1e-5 * |want|, d_coords 1e-3 + 1e-5 *
    |want| (normalized units, (W - 1) / 2 = 63.5 pixels each: 1.6e-5 a
    pixel, on sums of three channels' terms up to ~60), d_theta 1e-5 * max
    |want| + 1e-4 * |want| (sums over the warp's 8,192 or 1,024 samples,
    in another order, which cancel to values far below their terms')."""
    import torch

    errs, bad = {}, []

    def hold(key, a, b):
        """``a`` against ``b`` at the gate of ``key``'s quantity."""
        k = key.split("/")[1]
        jax = key.endswith("/jax")
        b = torch.as_tensor(b).to(a.device)
        atol, rtol = {
            "loss": (0.0, 1e-4 if jax else 1e-5),
            "grad": CTC_GRAD_JAX_TOL if jax else CTC_GRAD_TOL,
            "out": (1e-5, 0.0), "d_img": (1e-5, 1e-5),
            "d_coords": (1e-3, 1e-5),
            "d_theta": (1e-5 * float(b.abs().max()), 1e-4)}.get(k, (1e-6, 0))
        err, ok = _close(a, b, atol, rtol)
        errs[key] = err
        if k == "grad":
            errs[f"{key}/rtol_read"] = rtol_read(a, b, atol)
        if not ok:
            bad.append(key)

    for case, tensors in got.items():
        for k, v in tensors.items():
            hold(f"{case}/{k}/plain", v, want[case][k])
    n = SURFACE_GOLDEN_CTC_ROWS
    for blank in (0, SURFACE_CTC[2] - 1):
        hold(f"ctc_b{blank}/loss/jax", got[f"ctc_b{blank}"]["loss"],
             golden[f"ctc_b{blank}/loss"])
    hold("ctc_b0/grad/jax", got["ctc_b0"]["grad"][:n], golden["ctc_b0/grad"])
    for name in SURFACE_SIZES:
        for k, v in got[name].items():
            hold(f"{name}/{k}/jax", v if k == "d_theta" else v[:1],
                 golden[f"{name}/{k}"])
    require(not bad, f"surface: {bad} beyond their gates ({errs})")
    return errs


def surface_ctc_control(t: dict, want: dict) -> dict:
    """The CTC gradient gate's lower-precision controls, plain versions
    only (call under ``plain_kernels``): the blank-0 loss's gradient from
    the log-probs rounded to TF32's 10-bit and to bf16's 7-bit significand,
    read against the f32 one as ``surface_against`` reads the kernels'
    (``rtol_read`` at ``CTC_GRAD_TOL``'s atol). A fault that lost as much
    precision would read about so."""
    import torch
    from crnn_ocr_torch.ops import ctc

    lp = t["lp"]
    bits = lp.view(torch.int32)
    tf32 = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    lab0 = labels_for_blank(t["labels"], 0)
    res = {}
    for name, x in (("tf32", tf32), ("bf16", lp.bfloat16().float())):
        x = x.clone().requires_grad_(True)
        ctc.ctc_forward_log_loss(x, lab0, t["il"], t["ll"], 0).sum().backward()
        res[name] = rtol_read(x.grad, want["ctc_b0"]["grad"],
                              CTC_GRAD_TOL[0])
    return res


def surface_build_model(g) -> dict:
    """Phase 31 (c): ``build_model`` of ``fonts-hard``'s config on the card
    with its weights through ``params_from_jax``, served in bf16 as
    shipped: texts equal to ``load_pretrained("fonts-hard")``'s on the 64
    golden lines, the forward's launches counted (1 K1 on ``"mma"``, 2 K2
    on the resident design)."""
    import torch
    from crnn_ocr_torch import load_pretrained
    from crnn_ocr_torch.infer.pretrained import model_weights
    from crnn_ocr_torch.infer.weights import params_from_jax
    from crnn_ocr_torch.models import build_model

    cfg, params, stats, _ = model_weights("fonts-hard")
    model = build_model(cfg)
    require(next(model.parameters()).device.type == "cuda",
            "build_model did not place the model on the card")
    model.load_state_dict(params_from_jax(params, stats))
    model.eval()
    pred = load_pretrained("fonts-hard")
    lines = golden_lines(g, "hard")[:64]
    with torch.inference_mode():
        x, w_new = pred.preprocess(lines, BUCKET)
        reset_launches()
        logits = model(x)
        torch.cuda.synchronize()
        counts = read_launches()
        require_launches(counts, {"fused_stem": 1, "bigru": 2},
                         "build_model's forward")
        design = read_design(counts, "build_model's forward")
        stem = read_stem_design(counts, "serve", "build_model's forward")
        got = [p.text for p in pred.decode(*pred.probs(logits, w_new))]
    want = pred.predict_text(lines, bucket=BUCKET)
    same = sum(a == b for a, b in zip(got, want))
    require(same == len(want), f"build_model's texts: {same} of {len(want)} "
                               "equal to load_pretrained's")
    return dict(lines=len(want), texts_equal=same, dtype=cfg.dtype,
                launches=counts, design=str(design[0]), stem_design=stem)


def phase_surface(card: str) -> dict:
    """Phase 31: the JAX package's public surface on the card. (d) first,
    then the counted run of the new shapes through ``crnn_ocr_torch.ops``
    (``SURFACE_KERNELS``: K6 and K7 once a loss and its backward, K11 and
    K12 once a warp, every K6/K7 on ``CTC_PATH_DESIGN``, every K12 on
    ``"cluster"``), the same run through the plain versions, the JAX
    goldens, the kernels alone against their plain versions with their
    times and K12's plans, and (c). -> each kernel's ``surface`` entry."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    imports = surface_imports()
    golden = np.load(SURFACE_GOLDENS)
    t = {k: torch.from_numpy(v).cuda() for k, v in surface_inputs().items()}
    torch.cuda.synchronize()
    reset_launches()
    got = surface_run(t)
    torch.cuda.synchronize()
    counts = read_launches()
    require_launches(counts, SURFACE_KERNELS, "phase 31's counted run")
    ctc_design = read_ctc_design(counts, "phase 31's counted run")
    sampler_design = read_sampler_design(counts, "phase 31's counted run")
    with plain_kernels():
        want = surface_run(t)
        control = surface_ctc_control(t, want)
    errs = surface_against(got, want, golden)
    sampler = surface_sampler_checks(t)
    fold = surface_fold_cost(t)
    ctc = surface_ctc_checks(t)
    model = surface_build_model(np.load(os.path.join(
        REPO, "crnn_ocr_torch", "testdata", "greedy_goldens.npz")))
    emit("surface", card=card, imports=imports, launches=counts,
         ctc_design=ctc_design, sampler_design=sampler_design, errors=errs,
         ctc_grad_tol=dict(plain=CTC_GRAD_TOL, jax=CTC_GRAD_JAX_TOL,
                           control_rtol_read=control),
         sampler=sampler, fold=fold, ctc=ctc, build_model=model,
         seconds=time.perf_counter() - t0)
    rows = {k: dict(launches=counts[k]) for k in SURFACE_KERNELS}
    for k in ("ctc_alpha", "ctc_beta"):
        rows[k].update(ctc[k], blank_0_loss_fwd_ms=ctc["loss_fwd_ms"])
    for k, pre in (("grid_sample", "fwd"), ("grid_sample_bwd", "bwd")):
        rows[k]["warps"] = {
            name: dict(ms=s[f"{pre}_ms"], plain_ms=s[f"{pre}_plain_ms"],
                       bound_ms=s[f"{pre}_bound_ms"],
                       bound_by=s[f"{pre}_bound_by"], B=s["B"], N=s["N"],
                       kernel_bound_ms=s["kernel_bound_ms"][pre],
                       **({"plan": s["plan"]} if pre == "bwd" else {}))
            for name, s in sampler.items() if "_b" not in name}
    rows["grid_sample_bwd"]["c3_fold"] = {
        k: fold[k] for k in ("fold_records", "fold_device_ms")}
    return rows


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on a GPU "
              "only", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    try:
        import numpy as np

        from crnn_ocr_torch import load_pretrained
    except ImportError as e:
        print(f"chip_smoke: the crnn_ocr_torch package is missing ({e})",
              file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]

    phase_build(card)
    g = np.load(os.path.join(REPO, "crnn_ocr_torch", "testdata",
                             "greedy_goldens.npz"))
    # phase 2: kernels against their plain versions on the main path's data
    lines = golden_lines(g, "hard")
    lines = (lines * (BATCH // len(lines) + 1))[:BATCH]
    checks = []
    with torch.inference_mode():
        for dtype_name in ("bfloat16", "float32"):
            pred = load_pretrained("fonts-hard", device="cuda",
                                   dtype=dtype_name)
            m = pred.model
            x, _ = pred.preprocess(lines, BUCKET)
            feat = m.frame_features(m.backbone(m.stem(x)))
            checks.append(check_stem(m, x, dtype_name))
            checks.append(check_bigru(m, feat, dtype_name))

    phase_goldens(g, (("fonts-hard", "hard"), ("fonts-small", "small")),
                  ("fonts-hard", "hard"))
    counts = phase_throughput(card, "fonts-hard", lines,
                              {"fused_stem": 1, "bigru": 2})
    # each recurrence's (design, launches) in the counted run that holds it
    designs = {"bigru": counts.pop("design")}
    stem_design_launches = counts.pop("stem_design")
    greedy_serve = counts.pop("throughput")

    # slice 2: training
    checks += phase_train_kernels(g)
    phase_train_parity(g)
    train = phase_train(g, card)
    hard_train = {k: train[k] for k in ("lines_per_s", "p50_step_ms")}
    counts.update({k: train[k] for k in ("bigru_train", "bigru_backward",
                                         "ctc_alpha", "ctc_beta")})
    designs["bigru_train"] = train["design"]
    backward_design = train["backward_design"]
    ctc_designs = train["ctc_design"]

    # slice 3: the STN front end
    sg = np.load(os.path.join(REPO, "crnn_ocr_torch", "testdata",
                              "stn_goldens.npz"))
    checks += phase_stn_kernels(sg)
    phase_goldens(sg, (("fonts-stn", "stn"), (STN_NAME, STN_KEY)),
                  (STN_NAME, STN_KEY))
    stn_lines = golden_lines(sg, STN_KEY)
    stn_lines = (stn_lines * (BATCH // len(stn_lines) + 1))[:BATCH]
    counts["grid_sample"] = phase_throughput(
        card, STN_NAME, stn_lines, STN_SERVE_KERNELS)["grid_sample"]
    phase_train_parity(sg, STN_NAME, STN_KEY,
                       {k[6:]: sg[k] for k in sg.files
                        if k.startswith("train/")}, STN_TRAIN_KERNELS)
    stn_train = phase_train(sg, card, STN_NAME, STN_KEY, STN_TRAIN_KERNELS)
    counts["grid_sample_bwd"] = stn_train["grid_sample_bwd"]
    sampler_design = stn_train["sampler_design"]
    phase_serve_turns(card, lines, stn_lines)

    # slice 4: the training stem
    checks += phase_stem_train_kernels(g)
    gold = np.load(TRAIN_GOLDENS)
    # fonts-small reads these lines almost surely (loss 0.037), so its
    # gradients are small and f32 noise weighs more in them: the JAX
    # package's own XLA and fused stems give per-parameter gradient norms
    # 1.7e-3 apart on this batch (tools/gen_torch_goldens.py, both stems),
    # the port's CPU step is 3.1e-3 from the golden; so 5e-3 here
    small_step = phase_train_parity(
        g, SMALL_NAME, SMALL_KEY,
        {k[6:]: gold[k] for k in gold.files if k.startswith("small/")},
        TRAIN_KERNELS, SMALL_BUCKET, norm_rtol=5e-3,
        rnn_design=PATH_DESIGN["bigru_train"])
    small = phase_train(g, card, SMALL_NAME, SMALL_KEY, TRAIN_KERNELS,
                        SMALL_BUCKET)
    for k in ("stem_stats", "stem_bwd_partials", "stem_bwd_final"):
        counts[k] = small[k]

    # slice 5: the BiLSTM
    lg = np.load(LSTM_GOLDENS)
    checks += phase_lstm_kernels(g, lines)
    phase_lstm_goldens(g, lg)
    serve = phase_throughput(card, LSTM_NAME, lines, LSTM_SERVE_KERNELS)
    counts["bilstm"], designs["bilstm"] = serve["bilstm"], serve["design"]
    # the stem's kernels in both steps: with the plain stem as well, block1's
    # weight gradients differed by 9e-4 of their largest on the H100
    # (stem_kernels_alone reports what the stem's kernels change alone)
    lstm_step = phase_train_parity(
        g, LSTM_NAME, "hard",
        {k[6:]: lg[k] for k in lg.files if k.startswith("train/")},
        LSTM_TRAIN_KERNELS, plain_stem=False,
        rnn_design=PATH_DESIGN["bilstm_train"])
    train = phase_train(g, card, LSTM_NAME, "hard", LSTM_TRAIN_KERNELS)
    counts["bilstm_train"] = train["bilstm_train"]
    designs["bilstm_train"] = train["design"]

    # phase 23: fonts-small served in its shipped f32
    k2_f32, k3_f32, f32_serve = phase_f32_small(g, card)
    (k3_design, k3_n), = small_step["designs"].items()
    f32_rows = {
        "bigru": dict(f32_fields(k2_f32), launches=f32_serve["bigru"],
                      design_launches=f32_serve["design"][1],
                      ms_per_step=k2_f32["kernel_device_ms"] / k2_f32["T"],
                      path="fonts-small serving, phase 23"),
        "bigru_train": dict(f32_fields(k3_f32),
                            launches=small_step["launches"]["bigru_train"],
                            design_launches=k3_n,
                            ms_per_step=(k3_f32["kernel_device_ms"]
                                         / k3_f32["T"]),
                            path="fonts-small f32 train step, phase 16"),
    }
    require(f32_serve["design"][0].name == k2_f32["design"]
            and k3_design.name == k3_f32["design"],
            "the f32 rows were timed on another design than their runs ran")

    # phase 24: fonts-hard-lstm served in f32; K4's and K5's f32 rows are
    # phase 18's checks at these paths' shapes, with phase 24's and phase
    # 21's launches
    lstm_serve = phase_throughput(card, LSTM_NAME, lines, LSTM_SERVE_KERNELS,
                                  BUCKET, "serve_f32", dtype="float32")
    (k5_design, k5_n), = lstm_step["designs"].items()
    k4_f32, k5_f32 = (next(c for c in checks if c["kernel"] == k
                           and c["dtype"] == "float32")
                      for k in ("bilstm", "bilstm_train"))
    f32_rows["bilstm"] = dict(
        f32_fields(k4_f32), launches=lstm_serve["bilstm"],
        design_launches=lstm_serve["design"][1],
        ms_per_step=k4_f32["kernel_device_ms"] / k4_f32["T"],
        path=f"{LSTM_NAME} f32 serving, phase 24")
    f32_rows["bilstm_train"] = dict(
        f32_fields(k5_f32), launches=lstm_step["launches"]["bilstm_train"],
        design_launches=k5_n,
        ms_per_step=k5_f32["kernel_device_ms"] / k5_f32["T"],
        path=f"{LSTM_NAME} f32 train step, phase 21")
    require(tuple(lstm_serve["design"][0]) == (k4_f32["design"],
                                               k4_f32["cluster"],
                                               k4_f32["rows"])
            and tuple(k5_design) == (k5_f32["design"], k5_f32["cluster"],
                                     k5_f32["rows"]),
            "the f32 LSTM rows were timed on another design than their runs "
            "ran")

    # phase 25: serving by beam (no kernel of its own)
    phase_beam(card, g, greedy_serve)

    # phase 26: the serving daemon, reference artifacts and the CLIs
    phase_daemon(card, g)

    # phase 27: fonts-hard-lstm fine-tuned from image files, resumed, served
    in_memory = {k: train[k] for k in ("lines_per_s", "p50_step_ms")}
    phase_files(card, g, in_memory)

    # phase 28: fonts-hard fine-tuned with augmentation from a corpus on
    # the card, K steps a call, evaluated on the card, resumed
    aug = phase_aug(card, g, in_memory)

    # phase 29: data parallelism, two ranks sharing the card, a local mesh
    # for serving and the training CLI
    phase_dp(card, g, hard_train)

    # phase 30: migration both ways, and JAX's orbax checkpoints
    phase_migration(card, g)

    # phase 31: the JAX package's public surface, its new shapes through
    # K6/K7 and K11/K12
    surface = phase_surface(card)

    sources = {
        "fused_stem": ("crnn_ocr_torch/kernels/csrc/fused_stem.cu",
                       "crnn_ocr_tpu/kernels/fused_stem.py:134"),
        "bigru": ("crnn_ocr_torch/kernels/csrc/bigru.cu",
                  "crnn_ocr_tpu/kernels/bigru.py:76"),
        "bigru_train": ("crnn_ocr_torch/kernels/csrc/bigru.cu",
                        "crnn_ocr_tpu/kernels/bigru.py:144"),
        # no Pallas kernel: the lax.scan of bigru_fused's backward
        "bigru_backward": ("crnn_ocr_torch/kernels/csrc/bigru.cu",
                           "crnn_ocr_tpu/kernels/bigru.py:214 (_bwd)"),
        "bilstm": ("crnn_ocr_torch/kernels/csrc/bigru.cu",
                   "crnn_ocr_tpu/kernels/bigru.py:321"),
        "bilstm_train": ("crnn_ocr_torch/kernels/csrc/bigru.cu",
                         "crnn_ocr_tpu/kernels/bigru.py:381"),
        "ctc_alpha": ("crnn_ocr_torch/kernels/csrc/ctc_loss.cu",
                      "crnn_ocr_tpu/kernels/ctc_loss.py:195"),
        "ctc_beta": ("crnn_ocr_torch/kernels/csrc/ctc_loss.cu",
                     "crnn_ocr_tpu/kernels/ctc_loss.py:217"),
        "grid_sample": ("crnn_ocr_torch/kernels/csrc/grid_sample.cu",
                        "crnn_ocr_tpu/kernels/grid_sample.py:131"),
        "grid_sample_bwd": ("crnn_ocr_torch/kernels/csrc/grid_sample.cu",
                            "crnn_ocr_tpu/kernels/grid_sample.py:160"),
        "stem_stats": ("crnn_ocr_torch/kernels/csrc/fused_stem.cu",
                       "crnn_ocr_tpu/kernels/fused_stem_train.py:290"),
        "stem_bwd_partials": ("crnn_ocr_torch/kernels/csrc/fused_stem.cu",
                              "crnn_ocr_tpu/kernels/fused_stem_train.py:309"),
        "stem_bwd_final": ("crnn_ocr_torch/kernels/csrc/fused_stem.cu",
                           "crnn_ocr_tpu/kernels/fused_stem_train.py:333"),
    }
    # the sampler and the training stem are checked on two paths each; each
    # kernel's line keeps the path that counts its launches
    main_path = {"grid_sample": "serve", "grid_sample_bwd": "train",
                 "stem_stats": SMALL_KEY, "stem_bwd_partials": SMALL_KEY,
                 "stem_bwd_final": SMALL_KEY}
    checks = [c for c in checks
              if c.get("path") == main_path.get(c["kernel"])]
    kernels = []
    for c in checks:
        if c["dtype"] != "bfloat16":  # every path runs bf16
            continue
        name = c["kernel"]
        kernels.append(dict(
            name=name, route="cuda", source=sources[name][0],
            replaces=sources[name][1], launches=counts[name],
            max_abs_err=c["max_abs_err"], ms=c["kernel_device_ms"],
            event_ms=c["kernel_ms"], plain_ms=c["plain_ms"],
            bound_ms=c["bound_ms"], bound_by=c["bound_by"],
            library_ms=c["library_ms"],
            library_device_ms=c["library_device_ms"],
            f32_max_abs_err=next(
                o["max_abs_err"] for o in checks
                if o["kernel"] == name and o["dtype"] == "float32"),
            **{k: c[k] for k in ("max_err_over_scale", "pair_library_ms",
                                 "pair_library_device_ms", "design", "ptxas",
                                 "plan", "us_per_frame", "block_ms",
                                 "block_equal", "kernel_ms_old_host_path",
                                 "cold_ms", "image_ms", "image_cold_ms",
                                 "image_equal",
                                 "k4_same_inputs_device_ms", "streamed_ms",
                                 "streamed_equal", "resources",
                                 "function_device_ms", "row_designs",
                                 "bound_without_h_prev_ms", "bitwise_repeat")
               if k in c},
        ))
        if name == "bigru_backward":  # timed at train-hard's shape; phase
            # 8's launches (B 128) by design
            kernels[-1].update(cluster=c["cluster"], rows=c["rows"],
                               design_launches=backward_design,
                               ms_per_step=c["kernel_device_ms"] / c["T"])
        if name == "fused_stem":  # phase 4's launches by design
            kernels[-1]["design_launches"] = stem_design_launches
            # the training call (phase 15 at train-small, phase 17's
            # launches)
            k1 = K1_TRAIN[("bfloat16", SMALL_KEY)]
            kernels[-1]["train_call"] = dict(
                launches=small["fused_stem"], ms=k1["kernel_device_ms"],
                event_ms=k1["kernel_ms"], bound_ms=k1["bound_ms"],
                bound_by=k1["bound_by"], library_ms=k1["library_ms"],
                library_device_ms=k1["library_device_ms"],
                library=k1["library"], max_abs_err=k1["max_abs_err"])
        if name == "grid_sample":  # the augmentation's warp, phase 28
            kernels[-1]["augment_launches"] = aug["grid_sample"]
        if name in surface:  # phase 31's shapes and launches
            kernels[-1]["surface"] = surface[name]
        if name == "grid_sample_bwd":  # phase 13's launches by design
            require({c["design"]: counts[name]} == sampler_design,
                    f"{name}: timed on {c['design']}, but the counted run "
                    f"ran {sampler_design}")
            kernels[-1]["design_launches"] = sampler_design
        if name in ctc_designs:  # phase 8's launches by design
            require({c["design"]: counts[name]} == ctc_designs[name],
                    f"{name}: timed on {c['design']}, but the counted run "
                    f"ran {ctc_designs[name]}")
            kernels[-1]["design_launches"] = ctc_designs[name]
        if name in f32_rows:  # the f32 paths (phases 16, 23; 21, 24)
            kernels[-1]["f32"] = f32_rows[name]
        if name.startswith("bi"):  # f32 at this row's own path shape
            kernels[-1]["f32_path_shape"] = f32_fields(next(
                o for o in checks
                if o["kernel"] == name and o["dtype"] == "float32"))
        if name in designs:  # the recurrences: T dependent steps
            d, n = designs[name]
            require((c["design"], c["cluster"], c["rows"]) == tuple(d),
                    f"{name}: timed on {c['design']} C{c['cluster']} "
                    f"R{c['rows']}, but the counted run ran {d}")
            kernels[-1].update(design_fields(d, n),
                               ms_per_step=c["kernel_device_ms"] / c["T"])
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
