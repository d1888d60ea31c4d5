#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``cst_captioning_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. Print the card's name and power limit (``nvidia-smi``), then build
   every CUDA kernel of the ported paths from ``cst_captioning_torch/
   csrc/`` with ``nvcc`` for ``sm_90a`` (one compiler per source, in
   parallel).
2. Hold each decode kernel against its plain PyTorch version on the card
   at the full ``msrvtt_serve_beam5`` shape (B=64, K=5, E=H=512,
   V=10,496, T=30) on synthetic weights with spread vocab logits (see
   ``make_inputs``): float32 tokens exact (beam, greedy, multinomial)
   with scores / log-probs within 1e-3 (30 steps of float32 sums in two
   orders); the same on edge shapes and on a saturated-gate case;
   bfloat16 caption agreement >= 0.95 with score rtol <= 1e-3 (the
   kernel tier, set from measured readings), which also clears the
   reference's relaxed-serving tier (>= 0.75, rtol 0.02).  A chaos
   witness at ``randn * 0.3`` recurrent weights is reported, not held
   (see ``chaos_witness``).  bf16 beam and greedy are also held pooled
   over four seeds, at the floor and no more than 0.05 below a bf16
   order witness: the plain version's captions on the model with its
   hidden and embedding units permuted, against its own
   (``meanpool_order_witness``; kernel vs permuted kernel and the
   witness's score rtol reported).  The bf16 calls run the tensor-core
   chain: one call must show 3 x T launches of the port's kernels in
   the profiler, and the first 1, 13 and 33 videos decoded alone must
   give bitwise the outputs of the same videos in the B = 64 call
   (``row_invariance``).  TF32 is off for the float32 phases.  Each
   kernel (5 calls) and its plain version (1 call) are timed with CUDA
   events after a warm-up call, and the multinomial sampler also at the
   CST rollout's 1,280 rows (``rollout_times``, a reading).
2b. Hold the ``lstm_recurrence`` kernel (the XE/WXE teacher-forced
   recurrence) against its plain version at the training shape (R =
   64 x 20 caption rows, T=29, H=512): forward, gradients through the
   autograd Function, and a saturated-gate case (``check_recurrence``
   states the tolerances).  Time it (bf16 and f32, with and without the
   cell output), its plain version, and cuDNN's LSTM on the same gates
   as the library yardstick.  One bf16 call, and one of the float16
   instantiation (phase 14a's count, taken here where the profiler records
   it), must each show exactly one launch of the recurrence kernel in the
   profiler's breakdown; its cluster
   plan and an order witness (the plain version with its product summed
   exactly, against the plain version: what the bf16 cell moves under
   any other order, reported, not held) are printed.
2c. Hold the attention decode kernels ``attlstm_beam`` and
   ``attlstm_sample`` against their plain versions at the same shape with
   attention fusion (F = 2 x 28 frames, A = 512), every video with a
   random valid-frame count per modality and one with all its frames
   masked (``make_att_inputs``): float32 tokens exact with scores /
   log-probs within 1e-3, bfloat16 at the attention kernel tier on seed
   0 and, beam and greedy, pooled over four seeds, with an order witness
   (``att_order_witness``); timed as phase 2.  The bf16 calls run the
   tensor-core chain: one call must show 5 x T launches of the port's
   kernels in the profiler, and the row invariance of phase 2 must hold.
   The multinomial sampler is also timed at the CST rollout's 1,280 rows
   (a reading).
2d. Hold the ``attlstm_recurrence`` forward and backward kernels against
   their plain versions at the attention XE shape (R = 1280 caption rows
   over 64 videos, rep = 20, the attention tensors per video with masked
   tails and video 0 all masked; T = 29, F = 56, E = H = A = 512):
   float32 h_seq, c_seq and the softmax weights, the backward kernel on
   the same residuals, all eight gradients through the autograd
   Function, bfloat16 h_seq and the bfloat16 backward kernel on the same
   residuals (``check_att_recurrence`` states the tolerances).  rep = 20
   against rep = 1 on the repeated tensors: the forward bitwise (kernel
   and plain, both dtypes); the backward's per-video d_proj / d_vals
   bitwise the rep = 1 rows folded in row order, f32 within 1e-5 of max
   of the plain gathered fold, bf16 within one ulp of the float64-exact
   fold (the reference's own order reported beside it).  The same checks
   off the main shape (``ATT_EDGE_SHAPES``: 3 videos x 7 captions, T = 3;
   T = 1).  The bf16 tanh table bitwise ``tanhf`` on all 65,536 bf16
   values.  An order witness
   (the plain forward and backward with exact products) is reported.
   Timed in both dtypes, at rep = 20 and on the repeated tensors; the
   profiler's launch count of one bf16 call held at 3T - 1 (forward)
   and 4T + 3 (backward).
2e. Hold the ``fused_context_attention`` kernel (the continuous slot
   loop's per-step attention context) against its plain version at F =
   56 (masked frame tails, one all-masked video), A = E = 512: R = 320
   rows over 64 videos at rep = 5 (a beam slot's K rows read one stored
   copy) and R = 64 at rep = 1 (greedy), in f32 and bf16 (``CTX_*``
   state the tolerances); rep = 5 must be bitwise the gathered layout.
   Timed (5 calls) by the event clock and by the profiler's device time
   (a window that recorded every launch), with the gathered layout at R
   = 320; one bf16 call must show exactly one kernel launch in the
   profiler.  The same checks off the main
   shapes
   (``CTX_EDGE_SHAPES``: one video; 3 videos x 7 rows over 7 frames at
   A = 264, E = 40; the smallest bank, R = 40).
2f. Hold ``row_gemm`` (``ops/rowgemm.py::row_dot``, the row-invariant
   product of the per-step decode and the admission encode) at the
   slot loop's products, for each operand case the path gives it (f32;
   bf16 W with f32 x, the encode; bf16 W and x, every bf16 decode
   step): every prefix of a 640-row call bitwise equal to the full
   call, values within ``RG_RTOL`` of cuBLAS; report how many rows
   cuBLAS itself changes with the call's row count.  Each operand case
   of each product timed at R = 320 beside ``torch.matmul`` on the same
   operands, by the profiler's device time (the event clock reads the
   host's enqueue at these sizes, so it is printed beside).  The int8-W
   path (int8w serving) the same way, for f32 and
   bf16 compute, bitwise the float path on the widened codes times the
   scale and within ``RG_RTOL`` of cuBLAS on the dequantized weights.
2g. Hold the ``fused_context_attention`` backward kernel (the context
   gradient of scheduled-sampling training) against its plain version at
   the training shape: R = 1280 caption rows over 64 videos (rep = 20),
   F = 56 with masked tails and one all-masked video, A = E = 512, on
   the forward kernel's own softmax weights; float32 and bfloat16
   (``CTXB_*`` state the tolerances); rep = 20 against the gathered
   layout (d_proj and d_vals folded in row order, as the kernel folds
   them: d_q, d_proj and d_vals bitwise).  Timed in both dtypes (5
   calls, event clock and profiler device time), with the plain backward
   (1 call) and the forward at the same shape; one bf16 call must show
   exactly two kernel launches in the profiler.  The same checks off the
   main shape (``CTXB_EDGE_SHAPES``: one video; 3 videos x 7 rows over 7
   frames at A = 264, E = 40; two videos of 20 rows).
2h. Hold the int8w decoders (the four fused decode kernels with
   ``quant=``) against their plain versions at phase 2's and 2c's shapes,
   on those weights quantized by ``quantize_params``: float32 compute
   tokens exact with scores / log-probs within 1e-3, bfloat16 compute at
   the float kernels' tiers (the attention decoders' launches per call
   held as in 2c); a V = 1,100 vocab (streamed tiles and a padded tail)
   at float32, no token in the padding.  Timed as phase 2; the bf16
   calls' launches held as in phase 2 and 2c.
2i. Hold the int8w recurrences (``lstm_recurrence_quant``,
   ``attlstm_recurrence_quant``) against their plain versions at R =
   1280, T = 29 (F = 56, the attention tensors per video at rep = 20,
   bitwise rep = 1 on the repeated tensors): float32 h_seq within 2b /
   2d's bound, bfloat16 within one bf16 ulp at |h| < 1 and two ulps past
   1e-3 x max |h|.  Timed.
3. Serve: ``CaptionServer`` on an ephemeral port with the
   ``msrvtt_serve_beam5`` preset, ``--serving.continuous false``,
   random-init weights and a generated 10,492-word vocabulary; a few
   concurrent ``POST /v1/caption`` requests in beam mode, then in greedy
   mode.  Captions must come back, ``/metrics`` must carry the latency
   histograms, and each kernel's launch count — zeroed just before its
   mode's requests — must rise.
3b. The same with ``--model.feature_fusion attention``: the
   ``attlstm_beam`` and ``attlstm_sample`` launch counts must rise.
3c. Continuous serving: ``msrvtt_serve_beam5`` with its defaults (the
   slot loop, 64 slots on the elastic bank ladder 8-64, one step per
   tick, bf16), each fusion, beam and greedy: 96 requests at once, then
   32 arrivals 20 ms apart, every one answered; the bank must resize,
   ``fused_context_attention`` launches must equal the attention decode
   steps (0 under meanpool) and ``row_dot`` must launch.  bf16 served
   captions are compared with the offline per-step decode and the
   ladder's fused kernels at the relaxed-serving tier; then two f32
   runs (``--model.compute_dtype float32``) in two arrival orders must
   give the same tokens, equal to the offline per-step decode on every
   request, and agree with the ladder's fused kernels to within
   ``SERVE_LADDER_F32_SLACK`` captions (or an order witness) with score
   rtol <= 1e-6.  Prints the stage latencies, the front end's host work
   per request (``front_end_cost``) and a per-step profile of a full
   bank (``slot_breakdown``).
3d. int8w and bf16 serving: the ladder with ``--serving.dtype int8w``,
   each fusion and mode, where the int8w decoders' launch counts must
   rise; the continuous default with ``--serving.dtype int8w`` after each
   3c case (``check_int8w_continuous``): int8 ``row_dot`` launches,
   ``describe()`` weight bytes equal to the closed form, served captions
   vs the same engine's offline per-step decode at the relaxed-serving
   tier and vs the f32 engine at that tier or an int8w-ladder witness,
   and two runs at float32 compute in two arrival orders equal to the
   offline per-step decode; one ``--serving.dtype bf16`` run (meanpool
   beam) equal to 3c's bf16 run; and the teacher-forced forward of an
   int8w model at the XE shape through the int8w recurrences (one launch
   each, f32-compute logits kernel vs plain within 1e-5).
   3c's and 3d's runs with the preset's defaults go through the
   ``ReplicaSet`` (one replica on the card); the meanpool beam case of
   3c is pinned to ``--serving.replicas 1`` (``ContinuousBatcher``).
3e. The production scheduler, ``serving/replicas.py::ReplicaSet``, at
   ``msrvtt_serve_beam5`` width (``check_replicas``).  a. f32, meanpool
   beam and attention greedy, each under the preset's defaults (one
   replica, double-buffered), ``--serving.double_buffer false`` and
   ``--serving.replicas 2`` (wrapped onto the card), 96 requests then 32
   arrivals 20 ms apart (the defaults in two arrival orders, the other
   variants in one): every caption equal to the offline per-step decode,
   every replica serving.  b. Two replicas,
   ``kill_replica(0)`` once it holds requests: every request answered
   with the same tokens, ``caption_requeues_total`` risen, and a request
   with a 1 ms deadline shed with 504.  c. ``--serving.hedge_ms 1``: the
   same tokens, ``caption_hedges_total`` risen.  d. An 8-slot bank
   behind an 8-deep queue: ``batch`` requests shed before
   ``interactive`` ones (``caption_shed_total``), every 429's
   ``Retry-After`` the jittered hint, an unknown priority a 400.  e.
   ``/debug/trace`` parses and, over the phase, holds every serving span
   of the catalogue but the ladder's ``batch_decode``; ``/debug/flight``
   holds ``tick`` events per replica; ``/debug/profile?ms=200`` answers
   202, then 409 (and 400 for a bad window) and writes a trace naming a
   ``row_gemm`` and the context kernel; a SIGTERM drain (``serve_forever``
   on the main thread) answers every request and leaves each replica's
   flight dump, which ``validate_flight_dump`` accepts.  f. bf16, 96
   requests at once: captions/s, client p50 / p99 and the server's total
   latency, one replica double-buffered, one synchronous, two wrapped
   (meanpool beam; attention greedy under the defaults), at 3c's
   relaxed-serving holds; the tick wall and the card's idle share,
   double-buffered against synchronous, at a full 64-slot bank
   (meanpool beam, attention beam).  Launches held exactly in every run,
   summed over replicas: per admitting tick 2 ``row_gemm`` (3 under
   attention), per decode step 2 (3), and ``fused_context_attention``
   once per attention decode step.  g. (run in phase 5) one meanpool CST
   step exported through ``train.trace_file``: its ``cst/step`` span
   holds a ``phase/*`` span for every phase, each phase's spans within
   0.5 ms of its ``phase_ms``.
3f. The tier-2 encoder-row cache (``feature_id`` requests) at
   ``msrvtt_serve_beam5`` width with the preset's tier (4096 entries,
   256 MiB), random weights spread so captions differ
   (``check_feature_cache``).  a. Per fusion, f32 and bf16, beam, the
   slot loop driven directly with tier 1 off: 64 requests with features
   and an id, the same ids alone, then half by id and half features
   only.  Every id-only and mixed caption equal to the features
   request's (token-exact, f32 also to the offline per-step decode);
   ``admit_rows_cached`` / ``admit_rows_encoded`` risen by the admitted
   rows' hits / misses; launches exact: 2 (attention 3) ``row_gemm``
   an admitting tick that holds a miss, none for an all-hit admission,
   2 (3) a decode step, one context launch an attention step.  At f32
   an all-hit admitting tick of 64 must show in a ``profiled`` window
   exactly the decode step's launches of the port's kernels, an
   all-miss one the encode's on top.  ``entry_nbytes`` of one entry
   equal to the closed form from the shapes (``entry_closed_form``).
   b. Two replicas on the card (``clone_for_device``): replica 0
   encodes 8 ids, replica 1 admits them with no ``row_gemm`` launch and
   decodes a.'s captions.  c. HTTP, bf16 under the preset's defaults
   (the ``ReplicaSet``): an unknown id answers 404; 96 requests at once
   with 0.67 MB feature bodies and an id, then the 96 ids alone, with
   tier 1 off (id-only captions equal, no encode launched, tier-2 hits
   on ``/metrics``) and at the preset's 65,536 (every id-only answer
   from tier 1, no decode step): captions/s and client p50 / p99 of
   each burst.  d. 480 entries into a fresh engine's tier: the bytes
   within ``feature_cache_bytes``, the evictions counted, fewer than
   4096 entries held (the byte bound binds).
4. Train: the port's ``Trainer`` on the ``msrvtt_resnet_c3d_xe`` preset
   (full width: resnet 2048 + c3d 4096 x 28 frames, E=H=512, V=10,496,
   64 videos x 20 captions per step, bf16) for 2 epochs of 4 steps over a
   generated MSR-VTT-width corpus (``make_msrvtt_corpus``), validating
   each epoch by greedy decode.  The loss must be finite and fall, the
   val entry must carry CIDEr, ``best`` and ``last`` must be written, and
   the ``lstm_recurrence`` and ``lstm_sample`` launch counts — zeroed
   just before ``fit`` — must rise.  Then one XE step at float32 through
   the kernel vs through the plain recurrence (loss rtol <= 1e-5,
   gradient gap <= 1e-4 of the gradient norm), and one instrumented
   bf16 step: where its time goes.
4b. The same with ``--model.feature_fusion attention`` (the flagship
   attention captioner): the ``attlstm_recurrence`` forward and backward
   and ``attlstm_sample`` launch counts must rise; the float32 XE step
   through both recurrence kernels vs the plain forward and backward.
4c. Scheduled sampling: the attention run of 4b with
   ``--model.scheduled_sampling_start 0``, ``increase_every 1`` and
   ``increase_prob 0.25``: epoch 0 (``ss_prob`` 0) trains through the
   fused recurrence, epoch 1 (0.25) through the model's per-step loop.
   Losses finite, checkpoints written, the ``fused_context_attention``
   forward and backward launches exactly T x 4 in epoch 1 and none in
   epoch 0, the share of rows fed a sample at t >= 1 within 5 binomial
   sigmas of 0.25.  Then one float32 step on the per-step path
   (``ss_prob`` a tensor 0, no dropout) through the kernels vs through
   the plain context step (loss rtol <= 1e-5, gradient gap <= 1e-4) and
   vs the fused ``attlstm_recurrence`` step (the same function summed in
   another order; the same bounds), and a per-part bf16 step breakdown.
5. CST (the main path's stage 3): the ``msrvtt_cst_ms_scb`` preset at
   full width (S = 20 rollouts of 64 videos, 1,280 rows, T = 30, the
   SCB baseline, the weighted 20-ref CIDEr-D reward on the native
   scorer, which must be the one built), warm-started from phase 4's
   meanpool ``best``, on phase 4's corpus.  One warm-up step, then 3
   timed steps of the trainer's split step: each phase's host ms
   (``phase_ms``), the device ms of the rollout chunks and of the update
   (CUDA events), the host scoring, and the wall time against the
   serial sum.  Launches held exactly: per step K = 4 ``lstm_sample``
   (the rollout chunks), 1 ``lstm_recurrence`` and 2 + K ``row_gemm``
   (the encode and the chunks' static gates); one step with a greedy
   baseline adds K greedy ``lstm_sample`` and K ``row_gemm``.  Held
   too: the native scorer's rewards on the card's tokens are the step's
   reward and agree with the Python scorer within rtol 1e-5 / atol 1e-6
   (the reference's tier for the pair); the f32 PG loss and gradients
   through the kernel vs the plain recurrence (phase 4's bounds); the
   parameters moved and are finite; ``overlap_rewards`` on, off and on
   again bitwise (deterministic algorithms on); the f32 rollout at R =
   1,280 kernel vs plain, token-exact.  Then one attention CST step
   (F = 56) from phase 4b's ``best``: K ``attlstm_sample``, 1
   ``attlstm_recurrence``, 1 backward and 3 ``row_gemm`` launches.
   The meanpool model after its CST steps is saved for phase 6.
5b. ``tools/overlap_sim.simulate`` at the reference's defaults (the
   scorer's sleep sized to the measured rollout, 4 chunks, 5 steps, 3
   interleaved reps, escalated while noisy): its JSON line printed, every
   ``cst_overlap_sim_*`` key present, the recovered fraction in [0, 1],
   ``lstm_recurrence`` once a step, over the warm-up step of each layout
   and every timed one; its preset leaves ``model.use_pallas_sampler``
   off, so its multinomial draws (4 for the rollout timing plus 1 + K a
   step, K = 4 chunks, K = 1 for the one-chunk layout) take the
   per-step decode, as the reference's sampler gate sends them: one
   ``threefry_sample`` a decode step run (counted), no ``lstm_sample``;
   ``noisy`` reported, not held.  Before it, the
   multinomial samplers at V = 40 (128 kernel columns) with seeds that
   put the +inf hash-Gumbel draw on a masked column (PAD, BOS, the
   padding past V) at row 0, step 0: no masked id drawn, every id below
   V, f32 tokens equal to the plain version's (``check_masked_draw``).
5c. CST's slot rollout (``cst_rollout`` "slot" / "padded") on phase 5's
   CST meanpool model and corpus (64 videos x S = 20, T = 30, V =
   10,496, bf16) and phase 4b's attention ``best``.  (a) The
   ``threefry_sample`` kernel vs its plain version on the model's own
   scaled logits at 320 and 1,280 rows, row-keyed and batch streams,
   every fifth row greedy (``TF_TOLERANCE``: tokens equal but for counted
   near-ties of the plain version's top two, tok_lp, no masked id),
   device ms, plain ms and the int32-issue bound.  (b) Per fusion at f32
   and bf16 the rollout (1,280 sampled + 64 greedy rows) padded, then at
   the default slot count, at 16 slots and at block 2, every row's tokens
   bitwise the padded run's; each rollout's launches held exactly (the
   encode's 2 row_gemm, 3 under attention, then per decode step 2
   row_gemm, 3 under attention, 1 sampler and, under attention, 1
   context launch), and at bf16 one profiled tick of each slot run held
   at its launches (``profiled``).  (c) The f32 padded rollout with the
   kernel swapped for its plain version, token-exact.  (d) 3 timed CST
   steps (after a warm-up) each under the scan (split), padded and slot
   rollouts from one state: wall, ``phase_ms``, rollout stats and the
   update's trim length, launches held (scan: phase 5's; slot / padded:
   1 sampler launch and 2 row_gemm a decode step, the encode's 2
   row_gemm and 1 ``lstm_recurrence`` a step); then two padded and two
   slot steps from one state with deterministic algorithms on: rewards,
   loss and parameters bitwise.
6. Stage 4, the beam-5 eval (``evaluation.evaluate_dataset``, as a user
   calls it), the readers and the staged pipeline.
   6a. ``msrvtt_eval_beam5`` at full width restored from phase 5's CST
   meanpool checkpoint (``restore_params``), on a generated corpus like
   phase 4's (``make_msrvtt_corpus``, seed 3, 512 videos: 8 batches of
   64, 20 references each).  float32: kernel vs plain (the captioner's
   ``lstm_beam`` swapped for ``lstm_beam_ref``) through the same
   ``evaluate_dataset``, ``predictions.json`` and ``scores.json``
   identical (or, if captions differ, no more than the plain eval on the
   hidden-unit-permuted model differs from it: ``hold_f32_eval``);
   bfloat16 at the meanpool kernel tier (caption match >= 0.95, score
   rtol <= 1e-3).  The corpus packed by the port's ``pack_dataset`` at
   float32 and float16, evaluated through the loader's batched gather
   (``features_batch`` answered once a batch): float32 predictions
   bitwise the in-memory run's, float16 bitwise an in-memory run on
   features rounded to float16 first.  With ``h5py`` on the host the
   split's labels are written as a label h5 in the reference's schema
   and ``cli/test.main`` runs on them with the float32 pack, its files
   equal to the in-memory run's; without it one line says so, the
   packed runs read labels from memory and ``cli/test.main`` runs in
   6c.  Launches held exactly: one ``lstm_beam`` and three ``row_gemm``
   (two projections, the static gates) a batch in every run, and one
   bf16 batch's ``beam_search`` at 3 x T + 3 launches of the port's
   kernels in a profiler window that recorded every launch
   (``profiled``).  Readings: batch assembly host ms (in
   memory, packed float32, float16), the beam's device ms a batch (CUDA
   events), the metric suite's host seconds and its parts, videos/s end
   to end.
   6b. 2 batches under attention fusion from phase 4b's ``best``: f32
   kernel vs plain token-exact, one ``attlstm_beam`` a batch.
   6c. ``cli/pipeline.main`` over XE, WXE and CST (one epoch each) and
   the eval, on the synthetic corpus at the preset's feature widths:
   each stage warm-starts from the previous stage's checkpoint,
   ``pipeline.json`` holds every stage and the eval, whose files equal
   ``evaluate_dataset`` run afresh on the final checkpoint, and
   ``lstm_beam`` launches once an eval batch; without ``h5py``,
   ``cli/test.main`` on that checkpoint and split writes the same files.
   6d. ``tools/rehearsal.main`` at the reference's branch-trap protocol
   (``--corpus branch-trap --videos 600 --seed 0 --train-seed 213`` at
   the preset's widths: resnet-2048 + c3d-4096, 28 frames, 12 words,
   batch 16, beam 5, 5 CST samples): ``--stages xe,wxe --epochs 12``,
   then ``--reuse-data --stages cst --epochs 8`` (the protocol's 16 cut
   where the held best checkpoint is already epoch 5's) warm-started from the
   WXE ``best`` (``--run-name rehearsal_cst``), on the memory route
   without ``h5py`` and the h5 route with it.  Logged: each stage's val
   CIDEr per epoch and best, CST's reward per epoch, the test scores,
   ``analyze_mle_optimum`` for val and test, the route and each stage's
   wall.  Held: both calls return 0; best val CIDEr XE < WXE <= CST;
   CST's last-epoch mean reward above its first; one ``lstm_beam``
   launch a test batch in each call's final eval; ``lstm_recurrence``
   launches equal to the XE / WXE steps, then to the CST updates; CST's
   best checkpoint's beam-5 test CIDEr and Bleu_4 inside the reference's
   nine-seed Round-4 band (mean +- 3 sd); WXE's and CST's best decoded
   again by the plain beam on the card (``tools/rehearsal_seeds.py::
   plain_beam_eval`` with ``lstm_beam_ref`` swapped in) to the
   kernel's captions, at most 2 of 150
   differing and CIDEr and Bleu_4 within 0.02.
7. Trained checkpoints and the category embedding.
   7a. Phase 5's CST checkpoint served by ``InferenceEngine(cfg,
   checkpoint=...)`` at ``msrvtt_serve_beam5`` (V = 10,496), on the
   first 64 videos of 6a's eval corpus: the f32 ladder beam's captions
   equal ``evaluate_dataset``'s (6a f32) token for token; the f32 ladder
   greedy the model's own sampler's; the f32 slot loop (elastic banks,
   8 admitted a tick) the offline per-step decode's; bf16 and int8w
   (ladder and slot loop) at 3c / 3d's holds (``relaxed_holds``), their
   match against f32 reported beside the 0.75 floor; an int8w engine
   booted from its own quantized save (``save_params``) gives the same
   codes and captions as quantize-at-boot; ``cli/serve.main
   ["--checkpoint", ...]`` with the preset's defaults serves 8 requests
   over HTTP with the direct bf16 slot run's captions and exits 0.
   Launches held exactly in every run: ``lstm_beam`` / ``lstm_sample``
   once a ladder batch, ``row_gemm`` 3 a ladder batch (int8: 1) and
   2 an admitting tick + 2 a decode step in the slot loop.
   7b. Phase 5's state dict written as the exporter's ``params.npz``
   (``state_dict_to_params``), imported by
   ``tools/import_jax_checkpoint.main`` into a params-only checkpoint,
   served: 7a's f32 captions, identical.
   7c. ``model.use_category`` (20 categories, C = 64) on generated
   corpora with categories from the seed: 3 meanpool XE steps (one
   ``lstm_recurrence`` each) and the f32 XE step kernel vs plain (phase
   4's bounds); one CST scb step from them (Kc ``lstm_sample``, 1
   ``lstm_recurrence``, 2 + 2 Kc ``row_gemm``: the chunks' static gates
   gain the category's rows), its f32 PG loss and f32 1,280-row rollout
   kernel vs plain (phase 5's holds); ``evaluate_dataset`` of 128 videos
   at f32, kernel vs plain files identical (or the order witness), 4
   ``row_gemm`` a batch; 32 requests carrying ``category`` served on the
   f32 ladder (the eval's tokens) and the slot loop (the offline
   per-step decode's); a witness: one video under two categories gives
   different ``gx_static`` rows on the card and different tier-1 keys;
   attention: one XE step (``attlstm_recurrence`` and its backward, the
   f32 step vs plain) and one beam batch (``attlstm_beam``, f32 kernel
   vs plain token-exact).
8. ``model.num_layers = 2``, the stacked captioner, at the presets'
   full width (``check_stacked``).  Its whole-recurrence decoders
   decline stacks, as the reference's do, so its decodes are the
   per-step ones on ``row_gemm`` and ``threefry_sample``; its meanpool
   teacher forcing runs one ``lstm_recurrence`` launch a layer, its
   attention teacher forcing the per-step loop with one context launch
   (and one backward) a step.  Every run's wrapper launches are held
   exactly, the single-layer kernels at zero.
   8a. ``msrvtt_resnet_c3d_xe`` (meanpool, bf16) at two layers: one
   epoch of 4 steps through ``Trainer.fit`` on phase 4's corpus
   (``lstm_recurrence`` 2 a step); one teacher-forced forward's profiler
   window holds exactly 2 launches, both the recurrence's; each layer's
   recurrence kernel vs its plain version on that layer's own gx (layer
   1's from layer 0's h sequence) at bf16 and f32, at 2b's tiers; the
   f32 XE step through the kernel vs the plain recurrence at phase 4's
   bounds; the bf16 step's ms (events).
   8b. The same under attention: 29 context launches in one forward's
   profiler window, 29 forward and 29 backward launches a step, the f32
   step vs the plain context forward and backward.
   8c. ``msrvtt_cst_ms_scb`` at two layers from 8a's ``best``: one
   warm-up and 2 timed split steps (launches: one ``threefry_sample`` a
   decode step, 2 row_gemm an encode and 3 a decode step, 2
   ``lstm_recurrence`` an update), the f32 1,280-row rollout through the
   kernel vs the plain draw token-exact, the slot rollout (default
   slots, block 1 and 2) bitwise the padded one at f32 and bf16 (5c's
   holds, with the plain draw at f32), the f32 PG loss at phase 5's
   tier.
   8d. ``evaluate_dataset`` of ``msrvtt_eval_beam5`` at two layers from
   8a's ``best`` on 128 generated videos: the per-step beam, f32 through
   ``row_gemm`` vs its plain version identical files (or within 6a's
   hidden-unit-permuted witness), then bf16; videos/s end to end.
   8e. 8a's checkpoint served: the f32 ladder equal to 8d's f32 eval for
   64 videos, the f32 slot loop token-exact against the offline per-step
   decode, bf16 and int8w (ladder and slot loop) at 3d's relaxed holds,
   ``state_bytes == expected_state_bytes`` over the (2, rows, H) carry,
   captions/s of the direct bf16 runs; then ``cli/serve.main`` with
   ``--model.num_layers 2`` under the preset's defaults and with
   ``--serving.continuous false``: 8 requests each, the direct bf16
   runs' captions.
9. The serving extensions at ``msrvtt_serve_beam5`` width, greedy, on
   random weights spread as in 3f (``check_serving_extensions``).
   9a. Speculative decode (the reference bench's protocol): a pool of 8
   videos, 64 requests drawn from it (request i: video i % 8), admitted
   at once into the 64-slot bank; per fusion (meanpool, attention) and
   dtype (f32, bf16, int8w) a plain greedy arm, then speculative arms at
   ``draft_k = 4``, ``draft_hidden = 128``: the truncation draft and the
   draft distilled by ``cli/distill_draft.py``'s update (150 Adam steps
   at lr 3e-3, once a fusion, on the f32 arm's teacher streams of the
   pool, served from its ``.npz``).  Held: 0 token and score mismatches
   against the plain arm; ``spec_stats`` emitted tokens equal to the
   captions' tokens; tokens per live round above 1.0 with the distilled
   draft; one ``decode_verify`` over 4 x 64 rows bitwise 4 plain steps at
   64 rows (logits, their log-softmax, h / c); each draft's two float32
   ``row_gemm`` products (the cell, K = 256, N = 512; the head, K = 128,
   N = 10,496) over 4 chained steps at 64 rows within ``RG_RTOL`` x max
   |value| of ``row_dot_ref`` on the same carry and tokens, 2 launches a
   step, rows bitwise invariant to the row count; launches exact in every
   arm (``row_gemm``: 2 / 3 an admitting tick, a plain step 2 / 3, a
   round 13 / 17: the draft's cell and head each of its 4 steps, each
   verify step's gates and query, one vocab product; the context kernel
   once a plain step and 4 times a round under attention; int8 launches
   the model's products alone) and in a profiled window of 3 rounds over
   a full bank.  Printed per arm: captions/s, host ms a round (or step),
   device ms a round and its largest kernels, rounds, launches a round,
   ``spec_stats`` (tokens a live round, acceptance rate).
   9b. ``serving/chaos.py::run_soak`` over a real two-replica
   ``ReplicaSet`` on the card (f32 meanpool, tier 1 at 65,536 entries):
   a 200-request diurnal trace (``make_diurnal_trace``) over a pool of
   1,024 keys (178 distinct videos drawn, each made from its own seed, so
   most requests decode and 22 repeats can hit tier 1), once chaos-free
   and twice under a schedule that fires all five
   sites (one ``replica_kill`` of replica 0 at its 40th iteration, tick
   stalls on replica 1, queue bursts, a cache-miss storm, deadline skews
   to 0 s).  Held: nothing lost; the two chaos runs' decision and fault
   logs identical and their captions too; every caption the chaos run
   served (decoded or from tier 1) equal to the chaos-free run's for the
   same request; all five sites fired, the kill requeued work, its
   flight dump valid; launches exact (2 ``row_gemm`` an admitting tick
   and a decode step, summed over replicas).  Printed: outcome counts
   (decoded and from tier 1 apart) and attainment at 10, 30 and 60
   ticks.
   9c. The ``CaptionServer``'s autoscaler (``min_replicas`` 1,
   ``max_replicas`` 2) stepped by ``run_soak`` over its ``ReplicaSet``
   on a burst of 512 requests in 4 ticks, then 6 quiet arrivals, against
   the static one-replica fleet: held: a scale-up through the server's
   factory (``clone_for_device`` onto the card: the weights shared, its
   own stream) that serves requests, a scale-down through the inline
   drain, nothing lost, every caption the static fleet's.  Printed: the
   decision log.
10. Serving artifacts (``serving/artifact.py``) at ``msrvtt_serve_beam5``
   width (64 slots, beam 5, V = 10,496, T = 30) from ``--random-init``
   (``check_artifacts``).  10a: ``cli/build_artifact.py`` builds two
   artifacts, attention f32 on the slot loop and meanpool bf16 on the
   batch ladder (``serving.continuous = false``); held: each written,
   its ``kernels/`` the names ``serving_kernels()`` gives
   (``context_attention``, ``lstm_beam``, ``row_gemm``; ``lstm_beam``,
   ``row_gemm``), each library byte for byte the one nvcc wrote.  10b:
   each boots in a fresh interpreter with no ``nvcc`` on PATH and no
   CUDA_HOME (``InferenceEngine.from_artifact``) and serves 64 requests:
   the slot loop 8 admissions a tick (banks 8 -> 64, then idle ticks
   down), the ladder in batches of 5, 13, 30 and 16.  Held: zero nvcc
   runs, every loaded library under the artifact's ``kernels/`` and
   none other, tokens and scores (the slot loop's, the ladder batches'
   beam scores) and the banks bitwise a warm engine's in this process
   built from the artifact's own params, launches exact (the slot loop:
   3 ``row_gemm`` an admitting tick and a step, one context launch a
   step; the ladder: one ``lstm_beam`` and 3 ``row_gemm`` a batch).
   10c, in the ladder artifact's process before its boot: a manifest
   copy with ``env.device_kind`` and the ``row_gemm`` digest altered
   raises ``ArtifactMismatchError`` naming both; a copy with its first
   library truncated raises ``ArtifactError``; no nvcc run, no library
   loaded.  10d: ``python -m cst_captioning_torch.cli.serve --artifact``
   (no nvcc on PATH) answers 3 ``POST /v1/caption`` with the warm
   engine's tokens, ``/healthz`` names the manifest's version, SIGTERM
   exits 0.  10e, readings: each boot's seconds beside phase 1's nvcc
   build and a warm engine's construction, the artifact's bytes.
11. Multi-GPU (``check_multi_gpu``): the (data x model) mesh of
   ``parallel/``, at full width (resnet-2048 + c3d-4096 over 28 frames,
   E = H = 512, V = 10,496, beam 5, T = 30), random spread weights from
   a seed.  Each mesh stands on distinct cards where the host has
   enough, else on card 0 at every position (a one-card mesh measures
   no NVLink).  11a: ``msrvtt_serve_tp2`` (M = 2) on 64 requests through
   the slot loop, meanpool and attention, at f32, bf16 and
   ``msrvtt_serve_int8w_tp2``'s int8w, against the one-device engine of
   the same dtype on the same requests; held: tokens exact, beam scores
   within rtol 1e-4, the same admitting ticks and steps, and launches
   exactly the one-device run's plus one ``row_gemm`` (and, at int8w,
   one int8 one) a decode step for the second shard's vocab product;
   both ``serving.shard_fused_decode`` arms at f32 (the candidate merge
   and the gather path).  The ladder's sharded decoders
   (``ops/shard_decode.py``) on one batch of 64 at f32: launches held (3
   ``row_gemm`` for the encode, then 2 + M, or 3 + M under attention, a
   step), tokens exact and beam scores within rtol 1e-4 against the
   same decoders over one shard holding the whole vocab on one device
   (no merge; the shards' ``row_gemm`` columns are its columns bit for
   bit); the caption matches against the one-device ``lstm_beam`` kernel
   and the one-device per-step beam, which sum the gates in other
   orders, are printed as readings.  11b: ``msrvtt_serve_r2xtp2``'s (2, 2)
   grid through the ``ReplicaSet``, 64 requests from client threads,
   token-exact against the offline per-step decode on one device, both
   replicas admitting.  11c: ``msrvtt_xe_2d`` on (data 2 x model 2) at
   64 videos x 20 captions (1,280 rows), T = 29, against the one-device
   trainer on the same batches from the same init, at float32 compute
   (the r12 tier): 3 meanpool steps with their losses within rtol 1e-5,
   the parameters after step 1 within rtol 2e-5 / atol 1e-5, a second
   3-step mesh run bitwise the first (deterministic algorithms on), one
   attention step at the same holds; one bf16 meanpool step (the
   preset's dtype), its loss at the bf16 kernel tier; launches exact:
   one ``lstm_recurrence`` (or ``attlstm_recurrence`` forward and
   backward) a data shard and a step; one CST step (scb, 20 rollouts a
   video through the split step) on the mesh against the one-device
   trainer's on the same batch and seed words, both rollouts on the
   per-step route (the reference's gate declines the fused sampler on a
   data-sharded mesh): rewards, baseline and advantage equal, the loss
   within rtol 1e-5, the parameters within rtol 2e-5 / atol 1e-5, 2
   recurrence launches on the mesh and 1 on one device.  11d: the (2, 2) trainer's checkpoint
   (its sidecar naming ``2x2`` and ``word_embed``'s spec) loads on one
   device bitwise, and a one-device and a 1x2 engine built from it serve
   64 requests with 11a's holds.  11e, only with two cards or more: one
   data-parallel XE step over two NCCL processes against the
   single-controller (2, 1) mesh on cards 0 and 1; with one card it
   prints that it did not run.  Timings (with the card line): a decode
   step's ms on the 1x2 mesh and on one device, the 2D and one-device
   XE step ms at f32 and bf16, the CST step ms.
12. The invariant engine and the lock-order twin.  12a: ``python -m
   cst_captioning_torch.analysis --json`` in a subprocess on this host's
   Python (the port's own source against its thirteen rule families,
   CST-THR / CFG / MET / EXC / OBS / RES / JIT / DON / DEC / RNG / SHD /
   DTY / SHP, stdlib only): exit 0 and zero unsuppressed findings; its
   seconds logged per family.  12b: 3e.b's two-replica
   ``ReplicaSet`` on this card, attention greedy at f32 (real
   ``fused_context_attention`` and ``row_gemm`` launches, held exactly
   as 3e holds them), built and driven under
   ``analysis/lockwatch.py``'s ``LockWatch.patched()``: P12_REQUESTS
   requests at once, ``kill_replica(0)`` once replica 0 holds work (its
   in-flight requests requeued onto replica 1); every answer valid, at
   least one requeue, one healthy replica of two after, and the
   observed lock-acquisition graph acyclic (its node and edge counts
   logged).  12c: the kernel-site registry against this process: the
   kernels its ``_build.load`` sites name equal ``_build.SOURCES``',
   every one was loaded by the earlier phases from the build directory,
   and ``_build.nvcc_runs`` is within the registry's budget.  12d: the
   result dtypes the type flow proves, taken under live argument dtypes
   on a bf16 ``msrvtt_serve_beam5`` model at full width, equal the live
   ones: the decode step's vocab product and logits (float32), the
   greedy pick's token ids (int64) and log-probs, the beam log-softmax,
   the threefry draw, the XE loss and the PG loss (float32); and the
   update step on bf16 leaves (``model.param_dtype = bfloat16``, one XE
   step's gradients): the clip and the Adam and RMSprop directions
   (bfloat16), proven; the step's returned norm and a leaf after ``p +
   lr * u`` (bfloat16) composed by hand with the type flow's promotion,
   not proven (the flow follows no loop over named tensors), and held
   as readings.  The engine now runs all
   thirteen families (12a checks it).
13. ``model.param_dtype`` = bfloat16, then float16, at full width (the
   ``msrvtt_resnet_c3d_xe`` / ``msrvtt_cst_ms_scb`` /
   ``msrvtt_serve_beam5`` shapes, P13_VIDEOS generated videos x 20
   captions, random weights from P13_SEED).  13a: the card's bytes for
   the leaves plus Adam moments, float32 against bfloat16 leaves (their
   ratio within P13_BYTES_RATIO).  13b: P13_XE_STEPS meanpool XE steps
   (and one attention step) through ``lstm_recurrence``
   (``attlstm_recurrence`` and its backward); before each update, on the
   same bf16 leaves, the loss within P13_LOSS_RTOL and each leaf's
   gradient within P13_GRAD_GAP of those with the plain recurrence
   swapped in; then the port's Adam applies the kernels' gradients: the
   leaves and moments bf16 after, the kernels' gradients-plus-update
   ms.  13e: the model and its Adam
   state saved and restored into a fresh model bitwise, then
   P13_REQUESTS videos served from the checkpoint through the slot loop
   at ``serving.dtype`` bf16 and int8w, ``row_gemm`` against
   ``row_dot_ref`` at the relaxed-serving tier (3d's for served bf16
   captions against other arithmetic), matched scores within the kernel
   tier's rtol.  13c: one ``msrvtt_cst_ms_scb``
   step on those leaves (the ``lstm_sample`` rollout, the
   ``lstm_recurrence`` PG update): finite, leaves bf16; the greedy
   decode through ``lstm_sample`` against its plain version.  13d: a
   beam-5 batch of 64 videos through ``lstm_beam`` against its plain
   version, every beam at the kernel tier; on float16 leaves only, a
   match below the floor passes within the plain version's own order
   witness (phase 6a's rule), bfloat16 leaves have no witness.  Then, on
   bfloat16 leaves only, the XE and CST step ms with float32 leaves
   against bfloat16 leaves, in turn.  The float16 leaves
   take P13_F16_OPTIMIZER in 13b and 13c (Adam follows optax into
   non-finite float16 leaves; 13a's bytes are Adam's), and 13b holds
   the float16 leaves' gradients of P13_F16_GRAD_SCALE x the loss (the
   unscaled ones reported).  Every launch count is read from the
   kernels' own runs.
14. ``model.compute_dtype = float16``, both fusions.  14a: the four float16
   instantiations at full width against their plain versions on the
   card: ``lstm_beam`` and ``lstm_sample`` (greedy, multinomial) at B =
   64, K = 5 on phase 2's inputs at the float16 kernel tier
   (``F16_TOLERANCE``), the first videos alone bitwise the B = 64 call,
   3T profiler launches a call; ``lstm_recurrence`` at R = 1,280, T = 29
   at the float16 tiers, one profiler launch a call, cuDNN's LSTM in
   float16 as the yardstick, its order witness reported; ``row_gemm``
   at the slot loop's vocab, gate and encode products with float16 and
   float32 x, row-invariant and within ``RG_RTOL`` of cuBLAS, timed
   beside ``torch.matmul``; each kernel timed with its plain version.
   Then the attention path's six (``F16_ATT_TOLERANCE``): the f16 tanh
   (tanhf of the f16-rounded argument, rounded to f16, no table) bitwise
   the plain versions' on all 65,536 f16 codes; ``attlstm_recurrence``
   forward and backward at 2d's shape (R = 1,280 over 64 videos, rep
   20, T = 29), rep 20 bitwise rep 1, the per-video fold, the order
   witness (reported), 3T - 1 / 4T + 3 profiler launches a call;
   ``fused_context_attention`` forward and backward at R = 320, rep 5
   and R = 1,280, rep 20, rep bitwise the gathered layout, one / two
   launches a call; ``attlstm_beam`` (B = 64, K = 5) and
   ``attlstm_sample`` (greedy at 64 rows, multinomial at 1,280), the
   first videos alone bitwise, 5T launches a call.  Each is timed beside
   the same call's bf16 in the order bf16, f16, f16, bf16 (``ab_ms``,
   ``scripts/ab_f16.py``'s) and beside its plain version.
   14b under attention, with every count zeroed first and read at its
   end: an XE step (float32 leaves) and a WXE step (float16 leaves) of
   ``msrvtt_resnet_c3d_xe`` with ``model.feature_fusion = attention``
   against the plain attention recurrence (P14_LOSS_RTOL, P14_ATT_GRAD_GAP
   on the gradients of P13_F16_GRAD_SCALE x the loss); the per-step loop's
   loss and gradients against the plain context step; a scan and a slot
   ``msrvtt_cst_ms_scb`` step, the greedy decode, beam-5
   ``evaluate_dataset`` of the 64 videos and the checkpoint served
   through the slot loop, each against its plain version.  Each of
   ``attlstm_recurrence``, its backward, ``fused_context_attention``, its
   backward, ``attlstm_sample``, ``attlstm_beam``, ``row_gemm`` and
   ``threefry_sample`` must have launched.
   14b under meanpool, with every count zeroed first and read at its end: an XE step
   (float32 leaves) and a WXE step (float16 leaves, per-caption weights)
   of ``msrvtt_resnet_c3d_xe`` at full width, each loss and gradient
   against the plain recurrence's (P14_LOSS_RTOL, P13_GRAD_GAP); a
   ``msrvtt_cst_ms_scb`` step through the fused sampler and one through
   the slot rollout (``threefry_sample``), then the greedy decode
   against its plain version; beam-5 ``evaluate_dataset`` of the 64
   videos against the plain beam's captions; the XE checkpoint served
   through the slot loop (P14_REQUESTS videos, ``row_gemm`` against
   ``row_dot_ref``).  Each of ``lstm_recurrence``, ``row_gemm``,
   ``lstm_sample``, ``lstm_beam`` and ``threefry_sample`` must have
   launched.  14c: an artifact of that engine booted in a fresh process
   with no ``nvcc`` (0 runs), its captions the warm engine's.
15. Print one JSON line of per-kernel numbers (twenty-seven entries:
   the seventeen kernels, then the ten float16 instantiations of phase
   14 as ``<name>_f16``; the int8 row_gemm's readings join the row_gemm
   entry, phase 3e's, 3f's, 5's, 5b's, 6's, 6d's, 7's, 8's, 9's, 10's,
   11's, 12's and 13's launches and readings the entries of the kernels
   they ran), the card line again, then, as the last line, ``{"ok":
   true, "device": {...}}``.
"""

from __future__ import annotations

import glob
import json
import logging
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

H100_BF16_FLOPS = 989e12     # dense tensor-core peak (NVIDIA data sheet)
H100_F32_FLOPS = 67e12       # float32 outside the tensor cores
H100_BYTES_PER_S = 3.35e12   # HBM3
RELAXED_SERVING_MATCH_FLOOR = 0.75
RELAXED_SERVING_SCORE_RTOL = 0.02
# Kernel vs plain version in bfloat16: both follow one rounding contract.
# Set from the readings of the H100 runs (PERF.md): caption match 0.9844
# (beam) and 1.0 (sampler), score rtol 7.3e-05 and 1.4e-04.
KERNEL_BF16_MATCH_FLOOR = 0.95
KERNEL_BF16_SCORE_RTOL = 1e-3
F32_ATOL = 1e-3


def decode_tolerance(floor: float) -> str:
    """The decode kernels' tolerance as the ``kernels`` line states it,
    for a bf16 caption-match floor."""
    return (f"f32: tokens exact, |score or logprob diff| <= {F32_ATOL:g} "
            f"(max_abs_err_f32); bf16: caption match >= {floor:g}, score "
            f"rtol <= {KERNEL_BF16_SCORE_RTOL:g}; max_abs_err is the bf16 "
            "|score diff| (sampler: summed log-probs) over matching captions")


TOLERANCE = decode_tolerance(KERNEL_BF16_MATCH_FLOOR)

B, K, E, H, V, T = 64, 5, 512, 512, 10_496, 30
DEVICE = "cuda"    # phases 2b, 2d-2i, 3-3d, 4-4c (a CPU rehearsal may point it elsewhere)
SATURATED_T = 4
REPS = 5           # timed kernel calls (after one warm-up call)
N_REQUESTS = 12    # HTTP requests per decode mode
# The JAX reference package: named as a path for the report, never imported.
REFERENCE = "cst_captioning" + "_tpu"
REPO_DIR = os.path.dirname(os.path.abspath(__file__))


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------ helpers

def time_call(torch, fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` on the card (CUDA events, one
    warm-up call first)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# Profiler windows tried before a count fails, and the host sleep (s)
# before and after the calls of each of a window's two steps.  After
# phase 3e the first windows of a call often record none of its
# launches (5c.a's five: 1, 0, 0, 0, 0, 4, 3, 0, 2, 2, 3, 4 of 5 in
# twelve windows of one run on an H100), and unpadded windows lost
# launches where padded ones kept them all (PERF.md), so after four
# unpadded windows the calls sit ever further inside their window.  A
# window with more than the count still fails at once.
PROFILE_PADS_S = ((0.0,) * 4 + (0.05,) * 4 + (0.2,) * 4 + (0.5,) * 4
                  + (1.0,) * 2)
# Host sleep (s) before and after the calls of an uncounted window
# (kernel breakdowns, a tick's device ms): late in a long process an
# unpadded window dropped a call's first 11 of 30 steps (PERF.md).
WINDOW_PAD_S = 0.1


def profiled(torch, fn, reps: int, launches=None):
    """[(kernel name, device ms a call, launches a call)] from one
    profiler window of ``reps`` calls of ``fn`` (after a warm-up call, and
    a warm-up step of the profiler's own before the window).  The
    profiler now and then leaves launches near a window's edge
    unrecorded (a window of five short calls has read none), so with
    ``launches`` (the port's kernels, ``cstk::``, that one call launches)
    a window counts only if it recorded exactly ``reps * launches`` of
    them: more fails at once, fewer tries another window, padded by
    PROFILE_PADS_S, and a count that no window holds fails, naming for
    each window the port's launches, the kernels and the device ms it
    recorded (whether the profiler saw the calls at all).  Without
    ``launches`` a window counts if it recorded any device time."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    seen = []
    for pad in PROFILE_PADS_S:
        got = []
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     on_trace_ready=lambda p: got.append(p.key_averages())
                     ) as prof:
            for _ in range(2):  # the warm-up step, then the window
                time.sleep(pad)
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                time.sleep(pad)
                prof.step()
        rows = []
        for e in (got[0] if got else []):
            us = (getattr(e, "device_time_total", 0)
                  or getattr(e, "cuda_time_total", 0))
            if us:
                rows.append((kernel_name(e.key), us / 1e3 / reps,
                             e.count / reps))
        n = round(sum(c for k, _, c in rows if k.startswith("cstk::")) * reps)
        want = "any device time" if launches is None else reps * launches
        if rows if launches is None else n == reps * launches:
            if seen:
                log(f"profiled: window {len(seen) + 1} (padded {pad:g} s) "
                    f"held; the windows before recorded "
                    f"{[x[0] for x in seen]} of the port's launches ("
                    f"{want} wanted)")
            return rows
        if launches is not None and n > reps * launches:
            fail(f"profiled: {n} of the port's kernel launches over {reps} "
                 f"calls, {launches} a call expected")
        if not seen:
            short = ("no device time" if launches is None else
                     f"{n} of {want} launches")
            log(f"profiled: a window recorded {short}; the profiler's "
                f"launch records sit {launch_offset_ms(torch):.3f} ms after "
                "their operators (about +0.01 when its clocks agree)")
        seen.append((n, len(rows), round(sum(ms for _, ms, _ in rows), 4),
                     pad))
    fail(f"profiled: no profiler window recorded the expected launches "
         f"((the port's launches, kernels, device ms a call, pad s) per "
         f"window: {seen}; {reps} x {launches} expected)")


def launch_offset_ms(torch) -> float:
    """Median over five calls of a CUDA launch record's start minus its
    ``aten::add_``'s in one CPU and CUDA profiler window (host times,
    ms; ``scripts/probe_profiler.py``'s drift reading): how far the
    profiler's two clocks have drifted apart in this process."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.zeros(1 << 16, device="cuda")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            x.add_(1.0)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "offset.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            ev = json.load(f)["traceEvents"]
    ops = sorted(float(e["ts"]) for e in ev if e.get("name") == "aten::add_")
    rt = sorted(float(e["ts"]) for e in ev
                if e.get("cat") == "cuda_runtime"
                and "LaunchKernel" in e.get("name", ""))
    diffs = sorted((r - o) / 1e3 for o, r in zip(ops, rt))
    return diffs[len(diffs) // 2] if diffs else float("nan")


def device_ms(torch, fn, reps: int, launches=None) -> float:
    """Mean milliseconds of device time per ``fn()`` call: the sum over
    every kernel the calls launched, from a window of ``profiled`` (with
    ``launches``, one that recorded every launch of the port's kernels).
    For calls shorter than their host work, where ``time_call`` reads the
    host's enqueue rate."""
    return sum(ms for _, ms, _ in profiled(torch, fn, reps, launches))


def make_inputs(torch, seed: int, rec: float = 0.03, gx: float = 0.1):
    """Spread vocab weights (randn * 0.3: logits far from tied) over a
    recurrence at the model's own weight scale (``rec`` = randn * 0.03,
    about the std of the uniform ±1/sqrt(H) init).  At ``rec`` = 0.3 the
    recurrence is chaotic (``chaos_witness``).  The draws do not depend
    on the scales, so one seed gives the same directions at any scale."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, sc=0.3: (torch.randn(*s, generator=g) * sc)  # noqa: E731
    return dict(
        gx_static=r(B, 4 * H, sc=gx),
        w_x=r(E, 4 * H, sc=rec), wh=r(H, 4 * H, sc=rec), emb=r(V, E),
        w_out=r(H, V), b_out=r(V, sc=0.1),
    )


def permute_hidden(torch, a, perm, pe=None):
    """The same model with its hidden units reordered by ``perm`` (and,
    given ``pe``, its embedding units: ``emb``'s columns and ``w_x``'s
    rows): every output is the same in exact arithmetic, but the sums
    over H (and E) run in another order."""
    cols = torch.cat([perm + j * H for j in range(4)])
    rows = slice(None) if pe is None else pe
    return dict(gx_static=a["gx_static"][:, cols], w_x=a["w_x"][rows][:, cols],
                wh=a["wh"][perm][:, cols], emb=a["emb"][:, rows],
                w_out=a["w_out"][perm], b_out=a["b_out"])


def to_card(torch, args, cdt):
    out = {}
    for k, v in args.items():
        dt = torch.float32 if k in ("gx_static", "b_out") else cdt
        out[k] = v.to("cuda", dt).contiguous()
    return out


def bound_ms(flops: float, nbytes: float, peak: float):
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def decode_work(rows: int, itemsize: int, out_bytes: int):
    """FLOPs and compulsory bytes of one fused decode call."""
    flops = T * (2 * rows * (E + H) * 4 * H + 2 * rows * H * V)
    in_bytes = (B * 4 * H * 4 + (E + H) * 4 * H * itemsize
                + V * E * itemsize + H * V * itemsize + V * 4)
    return flops, in_bytes + out_bytes


# ------------------------------------------------------------ phase 2

def decoders(beam_mod, sam_mod, attention: bool):
    """(beam kernel, its plain version, sampler kernel, its plain
    version) of one fusion."""
    p = "att" if attention else ""
    return (getattr(beam_mod, p + "lstm_beam"),
            getattr(beam_mod, p + "lstm_beam_ref"),
            getattr(sam_mod, p + "lstm_sample"),
            getattr(sam_mod, p + "lstm_sample_ref"))


def hold_f32(torch, fns, vals, what: str, *, k: int, t: int,
             seed=(123, 456), temperature: float = 1.0,
             suppress_unk: bool = False):
    """float32 kernel vs plain version (``fns`` as ``decoders`` gives)
    on ``vals`` (card tensors): beam, greedy and multinomial tokens (and
    the sampler's mask) exact, scores and log-probs within ``F32_ATOL``.
    Returns (beam err, sample err, beam seqs)."""
    beam, beam_ref, sample, sample_ref = fns
    b = vals[0].shape[0]
    kw = dict(max_len=t, suppress_unk=suppress_unk)
    ks, kc = beam(*vals, beam_size=k, **kw)
    rs, rc = beam_ref(*vals, beam_size=k, **kw)
    torch.cuda.synchronize()
    bad = int((ks != rs).any(-1).sum())
    beam_err = float((kc - rc).abs().max())
    log(f"{what}: {beam.__name__} f32 mismatching beams {bad}/{b * k}, "
        f"max |score diff| {beam_err:.3e}")
    if bad or not beam_err <= F32_ATOL:
        fail(f"{what}: {beam.__name__} float32 disagrees with its plain "
             "version")
    sam_err = 0.0
    for greedy in (True, False):
        kt, kl, km = sample(*vals, seed, greedy=greedy,
                            temperature=temperature, **kw)
        rt, rl, rm = sample_ref(*vals, seed, greedy=greedy,
                                temperature=temperature, **kw)
        torch.cuda.synchronize()
        bad = int((kt != rt).any(-1).sum())
        err = float((kl - rl).abs().max())
        mode = "greedy" if greedy else "multinomial"
        log(f"{what}: {sample.__name__} f32 {mode} mismatching rows "
            f"{bad}/{b}, max |logprob diff| {err:.3e}")
        if bad or not err <= F32_ATOL or not torch.equal(km, rm):
            fail(f"{what}: {sample.__name__} float32 {mode} disagrees with "
                 "its plain version")
        sam_err = max(sam_err, err)
    return beam_err, sam_err, rs


def bf16_and_times(torch, fns, v16, v32, floor: float, launches=None):
    """bfloat16 kernel vs plain version at the main shape (beam, greedy,
    multinomial; ``bf16_check`` with match ``floor``), then the kernel
    (REPS calls) and plain (1 call) times in bf16 and f32 and the bf16
    per-kernel breakdown; given ``launches``, the profiler's count of
    the port's kernels in one bf16 call is held at it.  Returns the
    readings."""
    from cst_captioning_torch.decoding.beam import finalize_beams

    beam, beam_ref, sample, sample_ref = fns
    res = {}
    kb = finalize_beams(*beam(*v16, beam_size=K, max_len=T))
    rb = finalize_beams(*beam_ref(*v16, beam_size=K, max_len=T))
    res["beam_bf16_err"] = bf16_check(
        f"{beam.__name__} bf16", kb.tokens, rb.tokens, kb.score, rb.score,
        floor)
    res["sample_bf16_err"] = 0.0
    for greedy, seed in ((True, (0, 0)), (False, (123, 456))):
        kt, kl, _ = sample(*v16, seed, max_len=T, greedy=greedy)
        rt, rl, _ = sample_ref(*v16, seed, max_len=T, greedy=greedy)
        mode = "greedy" if greedy else "multinomial"
        res["sample_bf16_err"] = max(res["sample_bf16_err"], bf16_check(
            f"{sample.__name__} bf16 {mode}", kt, rt, kl.sum(-1),
            rl.sum(-1), floor))
    for tag, args in (("bf16", v16), ("f32", v32)):
        res[f"beam_ms_{tag}"] = time_call(
            torch, lambda: beam(*args, beam_size=K, max_len=T), REPS)
        res[f"beam_plain_ms_{tag}"] = time_call(
            torch, lambda: beam_ref(*args, beam_size=K, max_len=T), 1)
        res[f"sample_ms_{tag}"] = time_call(
            torch, lambda: sample(*args, (0, 0), max_len=T, greedy=True),
            REPS)
        res[f"sample_plain_ms_{tag}"] = time_call(
            torch, lambda: sample_ref(*args, (0, 0), max_len=T, greedy=True),
            1)
        log(f"times {tag}: {beam.__name__} {res[f'beam_ms_{tag}']:.3f} ms "
            f"(plain {res[f'beam_plain_ms_{tag}']:.3f} ms), "
            f"{sample.__name__} greedy {res[f'sample_ms_{tag}']:.3f} ms "
            f"(plain {res[f'sample_plain_ms_{tag}']:.3f} ms)")
    res["launches_per_call_bf16"] = decode_breakdowns(
        torch, beam, sample, v16, launches)
    return res


def decode_breakdowns(torch, beam, sample, v16, want=None, dt="bf16"):
    """The per-kernel breakdown (``dt`` the 16-bit compute dtype of
    ``v16``) of one beam and one greedy call;
    given ``want``, each call's launches of the port's kernels are held
    at it (``att_launches``).  Returns those counts (None: not held)."""
    out = {}
    for fn, key, call in (
        (beam, "beam", lambda: beam(*v16, beam_size=K, max_len=T)),
        (sample, "greedy", lambda: sample(*v16, (0, 0), max_len=T,
                                          greedy=True)),
    ):
        if want is not None:
            out[key] = att_launches(torch, call, fn.__name__, want, dt)
            continue
        for kname, ms, count in kernel_breakdown(torch, call):
            log(f"breakdown {dt} {fn.__name__}: {kname} {ms:.3f} ms over "
                f"{count} launches")
    return out or None


def meanpool_order_witness(torch, fns):
    """bf16 beam and greedy captions of the meanpool decoders over
    ATT_SEEDS, kernel vs plain version and each of them vs itself on the
    model with its hidden and embedding units permuted
    (``permute_hidden``): held as ``order_witness`` states, at
    KERNEL_BF16_MATCH_FLOOR."""
    def inputs(seed):
        g = torch.Generator().manual_seed(2000 + seed)
        ph, pe = torch.randperm(H, generator=g), torch.randperm(E, generator=g)
        a = make_inputs(torch, seed)
        return (list(to_card(torch, a, torch.bfloat16).values()),
                list(to_card(torch, permute_hidden(torch, a, ph, pe),
                             torch.bfloat16).values()))

    return order_witness(torch, fns, "meanpool", inputs,
                         KERNEL_BF16_MATCH_FLOOR)


def check_kernels(torch, beam_mod, sam_mod):
    """Phase 2 (see module docstring)."""
    fns = decoders(beam_mod, sam_mod, attention=False)
    base = make_inputs(torch, 0)
    res = {}
    vals = list(to_card(torch, base, torch.float32).values())
    res["beam_f32_err"], res["sample_f32_err"], _ = hold_f32(
        torch, fns, vals, "main shape", k=K, t=T)
    check_edge_shapes(torch, fns)
    check_saturated(torch, fns)
    res["chaos"] = chaos_witness(torch, beam_mod)
    a16 = to_card(torch, base, torch.bfloat16)
    res.update(bf16_and_times(torch, fns, list(a16.values()), vals,
                              KERNEL_BF16_MATCH_FLOOR,
                              MEANPOOL_DEC_LAUNCHES))
    res["row_invariance"] = row_invariance(torch, fns, a16, "meanpool")
    res.update(rollout_times(torch, fns[2], a16))
    res["order_witness"] = meanpool_order_witness(torch, fns)
    return res


def check_edge_shapes(torch, fns):
    """float32 exactness off the main shape: ragged row and vocab tiles
    (B, V not multiples of the kernels' 32 x 128 tiling), K=1, a beam
    row with all five specials masked (suppress_unk), EOS rigged to
    win (frozen beams / finished rows), tempered multinomial."""
    cases = [
        # B, K, E, H, V, T, suppress_unk, eos_bias, temperature
        (3, 1, 64, 64, 1000, 7, False, 0.0, 1.0),
        (8, 3, 32, 96, 130, 5, True, 0.0, 0.7),
        (33, 5, 64, 32, 777, 9, False, 3.0, 1.3),
    ]
    for (b, k, e, h, v, t, unk, eos, temp) in cases:
        g = torch.Generator().manual_seed(b * 1000 + v)
        r = lambda *s, sc: torch.randn(*s, generator=g) * sc  # noqa: E731
        b_out = r(v, sc=0.1)
        b_out[2] += eos
        args = [x.to("cuda").contiguous() for x in (
            r(b, 4 * h, sc=0.1), r(e, 4 * h, sc=0.03), r(h, 4 * h, sc=0.03),
            r(v, e, sc=0.3), r(h, v, sc=0.3), b_out)]
        what = f"edge shape B={b} K={k} E={e} H={h} V={v} T={t} suppress_unk={unk}"
        _, _, rs = hold_f32(torch, fns, args, what, k=k, t=t,
                            seed=(b, v), temperature=temp, suppress_unk=unk)
        log(f"{what}: eos-finished beam rows {int((rs == 2).any(-1).sum())}")


def check_saturated(torch, fns):
    """float32 exactness with saturated gates at the main widths: gate
    pre-activations of std about 17 (gx_static randn * 16, recurrent
    weights randn * 0.3), where sigmoid and tanh sit at their limits,
    over SATURATED_T steps: too few for the chaos of such a recurrence
    to flip a beam."""
    from cst_captioning_torch.constants import BOS_ID

    a = make_inputs(torch, 1, rec=0.3, gx=16.0)
    gates1 = a["gx_static"] + a["emb"][BOS_ID] @ a["w_x"]
    sat = float((gates1.abs() > 10).float().mean())
    log(f"saturated gates: share of step-1 |pre-activation| > 10: {sat:.3f}")
    hold_f32(torch, fns, list(to_card(torch, a, torch.float32).values()),
             f"saturated gates T={SATURATED_T}", k=K, t=SATURATED_T)


def chaos_witness(torch, beam_mod):
    """float32 beams at randn * 0.3 recurrent weights, where the LSTM is
    chaotic: reported, not held.  Kernel vs plain version on the same
    inputs, and each of them vs itself on the model with its hidden
    units permuted (``permute_hidden``: the same function, summed in
    another order).  If a summation order alone flips about as many
    beams as kernel vs plain does, the kernel's gap there is chaos."""
    a = make_inputs(torch, 0, rec=0.3)
    perm = torch.randperm(H, generator=torch.Generator().manual_seed(5))
    x = list(to_card(torch, a, torch.float32).values())
    xp = list(to_card(torch, permute_hidden(torch, a, perm),
                      torch.float32).values())
    run = lambda fn, v: fn(*v, beam_size=K, max_len=T)  # noqa: E731
    ks, kc = run(beam_mod.lstm_beam, x)
    rs, rc = run(beam_mod.lstm_beam_ref, x)
    kps, kpc = run(beam_mod.lstm_beam, xp)
    rps, rpc = run(beam_mod.lstm_beam_ref, xp)
    torch.cuda.synchronize()
    out = {}
    for tag, (s1, c1, s2, c2) in (
            ("kernel_vs_plain", (ks, kc, rs, rc)),
            ("plain_vs_plain_permuted", (rs, rc, rps, rpc)),
            ("kernel_vs_kernel_permuted", (ks, kc, kps, kpc))):
        bad = int((s1 != s2).any(-1).sum())
        err = float((c1 - c2).abs().max())
        out[tag] = {"beams_differ": bad, "max_abs_score_diff": err}
        log(f"chaos witness (recurrent randn*0.3, f32): {tag}: beams differ "
            f"{bad}/{B * K}, max |score diff| {err:.3e}")
    return out


def bf16_check(what: str, k_tok, r_tok, k_score, r_score,
               floor: float = KERNEL_BF16_MATCH_FLOOR,
               rtol_tier: float = KERNEL_BF16_SCORE_RTOL) -> float:
    """Kernel vs plain version in a 16-bit compute dtype: the share of
    captions (rows of token ids) that match must reach the kernel floor
    (``floor``), and on the matching ones the score's relative gap must
    stay within ``rtol_tier``; both are tighter than the reference's
    relaxed-serving tier.  Returns the max absolute score gap over the
    matches."""
    same = (k_tok == r_tok).all(-1)
    match = float(same.float().mean())
    if not bool(same.any()):
        fail(f"{what}: no caption matches its plain version")
    gap = (k_score - r_score)[same].abs()
    rtol = float((gap / r_score[same].abs().clamp_min(1e-6)).max())
    log(f"{what}: caption match {match:.4f}, max score rtol {rtol:.3e}")
    if match < RELAXED_SERVING_MATCH_FLOOR or rtol > RELAXED_SERVING_SCORE_RTOL:
        fail(f"{what} outside the relaxed-serving tier")
    if match < floor or rtol > rtol_tier:
        fail(f"{what} outside the kernel tier (match >= "
             f"{floor}, rtol <= {rtol_tier})")
    return float(gap.max())


def kernel_name(key: str) -> str:
    """A profiler key shortened to the kernel's name: no ``void``, no
    ``(anonymous namespace)::``, no argument list."""
    key = key.replace("(anonymous namespace)::", "")
    if key.startswith("void "):
        key = key[5:]
    return key.split("(")[0][:90]


def kernel_breakdown(torch, fn):
    """Device time by CUDA kernel name over one call (torch.profiler);
    empty when the profiler records no device time in three windows (it
    now and then records none for a window, as ``device_ms`` found).
    The call sits WINDOW_PAD_S inside its window."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(WINDOW_PAD_S)
            fn()
            torch.cuda.synchronize()
            time.sleep(WINDOW_PAD_S)
        rows = []
        for e in prof.key_averages():
            us = (getattr(e, "device_time_total", 0)
                  or getattr(e, "cuda_time_total", 0))
            if us:
                rows.append((kernel_name(e.key), us / 1e3, e.count))
        if rows:
            return sorted(rows, key=lambda r: -r[1])
    log("breakdown: not measured (the profiler recorded no device time in "
        "three windows)")
    return []


# ------------------------------------------------------------ phase 2b

R_XE, T_XE = 64 * 20, 29   # caption rows x teacher-forced steps (XE batch)
# Kernel vs plain version of the recurrence (no token feedback, so no
# chaos): float32 h and c, bf16 h, bf16 c relative to max(|c|, 1),
# float32 gradients relative to each gradient's max |value|, saturated
# gates (gx randn * 16, recurrent randn * 0.3, T=4).
#
# The first H100 run read 0 for every one of these (the plain version's
# f32 GEMM accumulates in the kernel's order), so the bounds are
# tightened from 1e-4 / 8e-3 / 1e-3 / 1e-4 to what a change of
# summation order could still produce: f32 1e-5, bf16 h one bf16 ulp at
# |h| < 1 (4e-3), bf16 c 2e-4, gradients 1e-5.
REC_F32_ATOL = 1e-5
REC_BF16_H_ATOL = 4e-3
REC_BF16_C_RTOL = 2e-4
REC_GRAD_RTOL = 1e-5
REC_SATURATED_ATOL = 1e-5
REC_TOLERANCE = ("f32: |h|,|c| diff <= 1e-5 (max_abs_err_f32), grads "
                 "<= 1e-5 x max|grad|, saturated T=4 <= 1e-5; bf16: |h "
                 "diff| <= 4e-3 (max_abs_err), |c diff| <= 2e-4 x max(|c|, 1)")


def rec_inputs(torch, seed: int, R: int, T: int, gx_scale: float = 0.5,
               rec: float = 0.03):
    """Input gates, recurrent weights (model init scale by default) and
    an output cotangent, drawn on the card from ``seed``."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    kw = dict(generator=g, device=DEVICE)
    return (torch.randn(R, T, 4 * H, **kw) * gx_scale,
            torch.randn(H, 4 * H, **kw) * rec,
            torch.randn(R, T, H, **kw))


def max_diff(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def rec_work(R: int, T: int, itemsize: int, with_cell: bool = True):
    """FLOPs and compulsory bytes of one recurrence call: read gx and
    W_h, write h_seq (and the f32 c_seq)."""
    flops = 2 * R * H * 4 * H * T
    nbytes = (R * T * 4 * H * 4 + H * 4 * H * itemsize + R * T * H * itemsize
              + (R * T * H * 4 if with_cell else 0))
    return flops, nbytes


def cudnn_lstm(torch, gx, wh, dtype):
    """cuDNN's LSTM computing the same recurrence: input = gx, W_ih =
    I_{4H} (one extra (R*T, 4H) x (4H, 4H) GEMM), W_hh = wh^T, zero
    biases; PyTorch's gate order is i|f|g|o too.  The yardstick only."""
    lstm = torch.nn.LSTM(4 * H, H, batch_first=True).to(DEVICE, dtype)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(torch.eye(4 * H))
        lstm.weight_hh_l0.copy_(wh.T)
        lstm.bias_ih_l0.zero_()
        lstm.bias_hh_l0.zero_()
    # One contiguous weight buffer, or cuDNN re-packs it on every call.
    lstm.flatten_parameters()
    x = gx.to(dtype)

    def call():
        with torch.no_grad():
            return lstm(x)[0]

    return call


def check_recurrence(torch, lstm_mod):
    """Phase 2b (see module docstring)."""
    fwd, ref = lstm_mod.lstm_recurrence_fwd, lstm_mod.lstm_recurrence_ref
    res = {}
    gx, wh32, dh = rec_inputs(torch, 11, R_XE, T_XE)
    wh16 = wh32.to(torch.bfloat16)

    kh, kc = fwd(gx, wh32, with_cell=True)
    rh, rc = ref(gx, wh32, with_cell=True)
    torch.cuda.synchronize()
    eh, ec = max_diff(kh, rh), max_diff(kc, rc)
    log(f"lstm_recurrence f32 R={R_XE} T={T_XE} H={H}: max |h diff| {eh:.3e}, "
        f"max |c diff| {ec:.3e}")
    if eh > REC_F32_ATOL or ec > REC_F32_ATOL:
        fail("lstm_recurrence float32 disagrees with its plain version")
    if not torch.equal(fwd(gx, wh32, with_cell=False), kh):
        fail("lstm_recurrence without the cell output differs from with it")
    res["f32_err"] = max(eh, ec)
    kh32 = kh

    kh, kc = fwd(gx, wh16, with_cell=True)
    rh, rc = ref(gx, wh16, with_cell=True)
    torch.cuda.synchronize()
    eh = max_diff(kh, rh)
    c_rel = float(((kc - rc).abs() / rc.abs().clamp_min(1.0)).max())
    h_ne = float((kh != rh).float().mean())
    log(f"lstm_recurrence bf16: max |h diff| {eh:.3e} (share of h differing "
        f"{h_ne:.2e}), max |c diff| / max(|c|, 1) {c_rel:.3e}")
    if eh > REC_BF16_H_ATOL or c_rel > REC_BF16_C_RTOL:
        fail("lstm_recurrence bfloat16 outside its tolerance")
    res["bf16_err"], res["bf16_c_rel"] = eh, c_rel

    gk = gx.clone().requires_grad_()
    wk = wh32.clone().requires_grad_()
    lstm_mod.lstm_recurrence(gk, wk).backward(dh)
    rh, rc = ref(gx, wh32, with_cell=True)
    dgx, dwh = lstm_mod.lstm_recurrence_bwd(gx, wh32, rh, rc, dh)
    torch.cuda.synchronize()
    g_gx = max_diff(gk.grad, dgx) / float(dgx.abs().max())
    g_wh = max_diff(wk.grad, dwh) / float(dwh.abs().max())
    log(f"lstm_recurrence f32 gradients, kernel forward vs all-plain: "
        f"dgx {g_gx:.3e}, dwh {g_wh:.3e} (of max |grad|)")
    if g_gx > REC_GRAD_RTOL or g_wh > REC_GRAD_RTOL:
        fail("lstm_recurrence gradients disagree with the plain path")
    res["grad_rel"] = max(g_gx, g_wh)
    del gk, wk, dgx, dwh

    sg, sw, _ = rec_inputs(torch, 12, R_XE, SATURATED_T, gx_scale=16.0,
                           rec=0.3)
    kh, kc = fwd(sg, sw, with_cell=True)
    rh, rc = ref(sg, sw, with_cell=True)
    torch.cuda.synchronize()
    es = max(max_diff(kh, rh), max_diff(kc, rc))
    sat = float((sg[:, 0].abs() > 10).float().mean())
    log(f"lstm_recurrence saturated gates T={SATURATED_T} (share of step-1 "
        f"|gx| > 10: {sat:.3f}): max |diff| {es:.3e}")
    if es > REC_SATURATED_ATOL:
        fail("lstm_recurrence saturated-gate case disagrees")
    res["saturated_err"] = es

    for tag, w in (("bf16", wh16), ("f32", wh32)):
        res[f"ms_{tag}"] = time_call(
            torch, lambda: fwd(gx, w, with_cell=True), REPS)
        res[f"ms_nocell_{tag}"] = time_call(
            torch, lambda: fwd(gx, w, with_cell=False), REPS)
        res[f"plain_ms_{tag}"] = time_call(
            torch, lambda: ref(gx, w, with_cell=True), 1)
        h_, c_ = ref(gx, w, with_cell=True)
        res[f"plain_bwd_ms_{tag}"] = time_call(
            torch, lambda: lstm_mod.lstm_recurrence_bwd(gx, w, h_, c_, dh), 1)
        lib = cudnn_lstm(torch, gx, wh32, torch.float32 if tag == "f32"
                         else torch.bfloat16)
        res[f"library_ms_{tag}"] = time_call(torch, lib, REPS)
        if tag == "f32":
            res["library_err_f32"] = max_diff(lib(), kh32)
        log(f"times {tag}: lstm_recurrence {res[f'ms_{tag}']:.3f} ms with "
            f"cell, {res[f'ms_nocell_{tag}']:.3f} ms without (plain "
            f"{res[f'plain_ms_{tag}']:.3f} ms, plain backward "
            f"{res[f'plain_bwd_ms_{tag}']:.3f} ms, cuDNN LSTM incl. the "
            f"identity input GEMM {res[f'library_ms_{tag}']:.3f} ms)")
    log(f"cuDNN LSTM vs kernel f32: max |h diff| {res['library_err_f32']:.3e}")
    res["launch_plan"] = lstm_mod.bf16_launch_plan(R_XE, H)
    log("lstm_recurrence bf16 launch: {} clusters x {} CTAs, {} rows per "
        "cluster".format(*res["launch_plan"]))
    # A profiler window that recorded exactly one launch of the port's
    # kernels (``profiled``), which must be the recurrence kernel's.
    rows = profiled(torch, lambda: fwd(gx, wh16, with_cell=True), 1,
                    launches=1)
    for kname, ms, count in rows:
        log(f"breakdown bf16 lstm_recurrence: {kname} {ms:.3f} ms over "
            f"{count:g} launches")
    rec_launches = round(sum(c for k, _, c in rows if "lstm_rec" in k))
    if rec_launches != 1:
        fail(f"one bf16 lstm_recurrence call launched its kernel "
             f"{rec_launches} times in the profiler's breakdown (want 1)")
    res["launches_per_call_bf16"] = rec_launches
    # The float16 instantiation's launch, counted here for phase 14a: late
    # in the script's process the profiler has missed this one long launch
    # in every window (PERF.md), where here it records it.
    wh_f16 = wh32.to(torch.float16)
    rows = profiled(torch, lambda: fwd(gx, wh_f16, with_cell=True), 1,
                    launches=1)
    res["launches_per_call_f16"] = round(
        sum(c for k, _, c in rows if "lstm_rec" in k))
    if res["launches_per_call_f16"] != 1:
        fail(f"one f16 lstm_recurrence call launched its kernel "
             f"{res['launches_per_call_f16']} times in the profiler's "
             "breakdown (want 1)")
    res["order_witness_c_rel"] = exact_product_witness(torch, lstm_mod, gx,
                                                       wh16)
    return res


def exact_product_witness(torch, lstm_mod, gx, wh):
    """Reported, not held: how far the plain version's 16-bit cell moves
    when only the order of its product changes, to the float64 sum
    rounded once (the most exact order there is): max |c diff| / max(|c|,
    1).  The kernel keeps the plain version's own order (one ascending-k
    fmaf chain, bitwise), so REC_BF16_C_RTOL is met by construction; this
    records what any other order, tensor-core sums included, would read."""
    from cst_captioning_torch.ops.rnn import gate_update

    R, T, _ = gx.shape
    cdt = wh.dtype
    whd = wh.double()
    h = torch.zeros((R, H), device=gx.device)
    c = torch.zeros_like(h)
    c_seq = torch.empty((R, T, H), device=gx.device)
    for t in range(T):
        h, c = gate_update(gx[:, t] + (h.to(cdt).double() @ whd).float(), c)
        c_seq[:, t] = c
    _, rc = lstm_mod.lstm_recurrence_ref(gx, wh, with_cell=True)
    rel = float(((c_seq - rc).abs() / rc.abs().clamp_min(1.0)).max())
    dt = "f16" if cdt == torch.float16 else "bf16"
    log(f"lstm_recurrence {dt} order witness (not held): the plain version "
        f"with its product summed exactly vs the plain version, max |c diff| "
        f"/ max(|c|, 1) {rel:.3e} (REC_BF16_C_RTOL {REC_BF16_C_RTOL:g})")
    return rel


# ------------------------------------------------------------ phase 2c

A_ATT, FR_ATT = 512, 28          # attention width; frames per modality
F_ATT = 2 * FR_ATT               # resnet + c3d frames, concatenated
# The attention decoders' bf16 kernel tier.  bf16 attention rounds the
# query and every tanh argument (A per frame per row per step) to bf16,
# so a one-ulp f32 difference in the query's sum flips a rounding and,
# over 30 fed-back steps, a caption; float32 stays token-exact.
# ``att_order_witness`` measures how many captions a change of summation
# order alone moves: the same model with its hidden, attention, frame
# and embedding units permuted (every sum over H, A, F and E reordered).
# The H100 readings (PERF.md), beam / greedy caption match:
#   kernel vs plain, seed 0:                     0.875  / 0.906
#   kernel vs plain, per seed over ATT_SEEDS:    0.859-0.922 / 0.906-0.984
#   plain vs permuted plain, pooled:             0.922  / 0.941
#   kernel vs permuted kernel, pooled:           0.883  / 0.926
#   kernel vs plain, pooled:                     0.891  / 0.949
# so order alone moves about as many captions as kernel vs plain does.
# Held: seed 0 (beam, greedy, multinomial) and the pooled beam / greedy
# match at >= 0.85, below the lowest order-only pooled reading (0.883);
# and the pooled kernel-vs-plain match no more than ATT_WITNESS_MARGIN
# below the plain version's own match against its permuted model.
KERNEL_ATT_BF16_MATCH_FLOOR = 0.85
ATT_WITNESS_MARGIN = 0.05
ATT_SEEDS = (0, 1, 2, 3)
# The bf16 decoders' launches of the port's kernels per call
# (csrc/decode_tc.cuh): per step the gate GEMM with the update, the vocab
# tile GEMM with its partials and the select; attention adds the query
# and the attention step before the gates.
MEANPOOL_DEC_LAUNCHES = 3 * T
ATT_DEC_LAUNCHES = 5 * T
# Videos decoded alone against the same videos of the B-video call: B'
# K and B' rows that fill no 64-row tile (R = 5, 65, 165 beam rows).
ATT_ROW_VIDEOS = (1, 13, 33)
# Caption rows of the CST rollout (64 videos x 20 samples), at which
# the multinomial sampler is timed beside R = B (a reading, not a check).
ROLLOUT_ROWS = R_XE
ATT_TOLERANCE = (decode_tolerance(KERNEL_ATT_BF16_MATCH_FLOOR)
                 + f" (seed 0, and beam / greedy pooled over "
                 f"{len(ATT_SEEDS)} seeds, there also >= plain vs permuted "
                 f"plain - {ATT_WITNESS_MARGIN:g}); attention inputs: one "
                 "video all-masked")
MEANPOOL_TOLERANCE = (TOLERANCE + f" (seed 0, and beam / greedy pooled over "
                      f"{len(ATT_SEEDS)} seeds, there also >= plain vs "
                      f"permuted plain - {ATT_WITNESS_MARGIN:g})")


def att_mask(torch, g, n_videos: int, device="cpu"):
    """(n_videos, F_ATT) float32: a random valid-frame count in
    [1, FR_ATT] per modality and video (masked tails), and video 0 with
    every frame masked (the kernels must give uniform weights, not
    NaN)."""
    n = torch.randint(1, FR_ATT + 1, (n_videos, 2), generator=g)
    pos = torch.arange(FR_ATT)[None, :]
    mask = torch.cat([(pos < n[:, :1]), (pos < n[:, 1:])], dim=1).float()
    mask[0] = 0.0
    return mask.to(device)


def make_att_inputs(torch, seed: int):
    """The attention decoders' operands at the serving shape: phase 2's
    spread vocab weights and init-scale recurrence (``make_inputs``),
    plus w_ctx and att_wh at init scale, att_v randn * 0.06 and the
    per-video att_proj / att_vals at unit-ish scale."""
    a = make_inputs(torch, seed)
    g = torch.Generator().manual_seed(seed + 100)
    r = lambda *s, sc: torch.randn(*s, generator=g) * sc  # noqa: E731
    att = dict(w_ctx=r(E, 4 * H, sc=0.03), att_wh=r(H, A_ATT, sc=0.03),
               att_v=r(A_ATT, 1, sc=0.06),
               att_proj=r(B, F_ATT, A_ATT, sc=0.5),
               att_mask=att_mask(torch, g, B),
               att_vals=r(B, F_ATT, E, sc=0.5))
    return {"gx_static": a["gx_static"], "w_x": a["w_x"], "wh": a["wh"],
            **att, "emb": a["emb"], "w_out": a["w_out"], "b_out": a["b_out"]}


def att_to_card(torch, args, cdt):
    out = {}
    for k, v in args.items():
        dt = torch.float32 if k in ("gx_static", "b_out", "att_mask") else cdt
        out[k] = v.to("cuda", dt).contiguous()
    return out


def check_att_decoders(torch, beam_mod, sam_mod):
    """Phase 2c (see module docstring)."""
    fns = decoders(beam_mod, sam_mod, attention=True)
    base = make_att_inputs(torch, 0)
    res = {}
    v32 = list(att_to_card(torch, base, torch.float32).values())
    res["beam_f32_err"], res["sample_f32_err"], _ = hold_f32(
        torch, fns, v32, "attention main shape", k=K, t=T)
    a16 = att_to_card(torch, base, torch.bfloat16)
    v16 = list(a16.values())
    res.update(bf16_and_times(torch, fns, v16, v32,
                              KERNEL_ATT_BF16_MATCH_FLOOR, ATT_DEC_LAUNCHES))
    res["row_invariance"] = row_invariance(torch, fns, a16, "attention")
    res.update(rollout_times(torch, fns[2], a16))
    res["order_witness"] = att_order_witness(torch, fns)
    return res


PER_VIDEO = ("gx_static", "att_proj", "att_mask", "att_vals")


def row_invariance(torch, fns, a16, fusion: str, dt: str = "bf16"):
    """16-bit (``dt``): the first B' videos of ``a16`` (ATT_ROW_VIDEOS; either
    fusion's operands, the per-video ones cut to B') decoded alone give
    bitwise the beam seqs and scores and the greedy tokens and log-probs
    of the same videos in the B-video call: the tensor-core tiles' edges
    and the gate GEMM's split change no row."""
    beam, _, sample, _ = fns
    v16 = list(a16.values())
    full_b = beam(*v16, beam_size=K, max_len=T)
    full_g = sample(*v16, (0, 0), max_len=T, greedy=True)[:2]
    out = {}
    for nb in ATT_ROW_VIDEOS:
        sub = [x[:nb] if k in PER_VIDEO else x for k, x in a16.items()]
        got_b = beam(*sub, beam_size=K, max_len=T)
        got_g = sample(*sub, (0, 0), max_len=T, greedy=True)[:2]
        torch.cuda.synchronize()
        same = all(bool(torch.equal(x, y[:nb]))
                   for x, y in zip(got_b + got_g, full_b + full_g))
        out[str(nb)] = same
        log(f"{fusion} {dt} row invariance: the first {nb} videos alone "
            f"({nb * K} beam rows, {nb} greedy rows) bitwise the B={B} "
            f"call: {same}")
        if not same:
            fail(f"{fusion} {dt} decoders: {nb} videos alone differ from "
                 f"the same videos of the B={B} call")
    return out


def rollout_times(torch, sample, a16, dt: str = "bf16"):
    """The 16-bit (``dt``) multinomial sampler's (either fusion's) time
    at B = 64 rows and at the CST rollout's ROLLOUT_ROWS (each video's
    operands repeated to its rows), with the per-kernel breakdown at
    the rollout's rows: readings."""
    rep = ROLLOUT_ROWS // B
    big = [x.repeat_interleave(rep, 0) if k in PER_VIDEO else x
           for k, x in a16.items()]
    v16 = list(a16.values())
    out = {}
    for tag, args in ((f"R{B}", v16), (f"R{ROLLOUT_ROWS}", big)):
        out[f"sample_multinomial_ms_{tag}"] = time_call(
            torch, lambda: sample(*args, (123, 456), max_len=T, greedy=False),
            REPS)
    log(f"times {dt}: {sample.__name__} multinomial "
        f"{out[f'sample_multinomial_ms_R{B}']:.3f} ms at R={B}, "
        f"{out[f'sample_multinomial_ms_R{ROLLOUT_ROWS}']:.3f} ms at "
        f"R={ROLLOUT_ROWS} (the CST rollout's rows)")
    for kname, ms, count in kernel_breakdown(
            torch, lambda: sample(*big, (123, 456), max_len=T, greedy=False)):
        log(f"breakdown {dt} {sample.__name__} multinomial R={ROLLOUT_ROWS}: "
            f"{kname} {ms:.3f} ms over {count} launches")
    return out


def permute_att(torch, a, ph, pa, pf, pe):
    """The attention decoders' operands (``make_att_inputs``) of the
    same model with its hidden units reordered by ``ph``, attention units
    by ``pa``, frames by ``pf`` and embedding / context units by ``pe``:
    the same function in exact arithmetic, every sum over H, A, F and E
    in another order (those over the vocabulary are not permuted: that
    would move the token ids)."""
    cols = torch.cat([ph + j * H for j in range(4)])
    return dict(gx_static=a["gx_static"][:, cols],
                w_x=a["w_x"][pe][:, cols], wh=a["wh"][ph][:, cols],
                w_ctx=a["w_ctx"][pe][:, cols],
                att_wh=a["att_wh"][ph][:, pa], att_v=a["att_v"][pa],
                att_proj=a["att_proj"][:, pf][:, :, pa],
                att_mask=a["att_mask"][:, pf],
                att_vals=a["att_vals"][:, pf][:, :, pe],
                emb=a["emb"][:, pe], w_out=a["w_out"][ph], b_out=a["b_out"])


def att_order_witness(torch, fns):
    """The attention decoders' ``order_witness``: the model permuted by
    ``permute_att`` (every sum over H, A, F and E reordered), held at
    KERNEL_ATT_BF16_MATCH_FLOOR."""
    def inputs(seed):
        g = torch.Generator().manual_seed(1000 + seed)
        perms = [torch.randperm(n, generator=g)
                 for n in (H, A_ATT, F_ATT, E)]
        a = make_att_inputs(torch, seed)
        return (list(att_to_card(torch, a, torch.bfloat16).values()),
                list(att_to_card(torch, permute_att(torch, a, *perms),
                                 torch.bfloat16).values()))

    return order_witness(torch, fns, "attention", inputs,
                         KERNEL_ATT_BF16_MATCH_FLOOR)


def order_witness(torch, fns, fusion: str, inputs, floor: float):
    """bf16 beam and greedy captions over ATT_SEEDS (``inputs(seed)``
    gives the operands and those of the same model permuted): kernel vs
    plain version, and each of them vs itself on the permuted model,
    i.e. how many captions a change of summation order alone moves.
    Holds the pooled kernel-vs-plain match to ``floor`` and to no more
    than ATT_WITNESS_MARGIN below plain vs permuted plain.  Also reports
    each pair's max score rtol over its matching captions (beam: the
    finalized score; greedy: the summed log-probs)."""
    from cst_captioning_torch.decoding.beam import finalize_beams

    beam, beam_ref, sample, sample_ref = fns
    pairs = ("kernel_vs_plain", "plain_vs_plain_permuted",
             "kernel_vs_kernel_permuted")
    out = {"seeds": list(ATT_SEEDS)}
    for mode in ("beam", "greedy"):
        for key in pairs:
            out[f"{mode}_{key}"] = []
            out[f"{mode}_{key}_score_rtol"] = 0.0
    for seed in ATT_SEEDS:
        x, xp = inputs(seed)
        caps = {}
        for tag, (bfn, sfn) in (("kernel", (beam, sample)),
                                ("plain", (beam_ref, sample_ref))):
            for sfx, v in (("", x), ("_permuted", xp)):
                fb = finalize_beams(*bfn(*v, beam_size=K, max_len=T))
                caps[("beam", tag + sfx)] = (fb.tokens, fb.score)
                tok, lp, _ = sfn(*v, (0, 0), max_len=T, greedy=True)
                caps[("greedy", tag + sfx)] = (tok, lp.sum(-1))
        torch.cuda.synchronize()
        for mode in ("beam", "greedy"):
            for key in pairs:
                one, two = key.split("_vs_")
                (t1, s1), (t2, s2) = caps[(mode, one)], caps[(mode, two)]
                same = (t1 == t2).all(-1)
                out[f"{mode}_{key}"].append(float(same.float().mean()))
                if bool(same.any()):
                    rtol = float(((s1 - s2)[same].abs()
                                  / s2[same].abs().clamp_min(1e-6)).max())
                    out[f"{mode}_{key}_score_rtol"] = max(
                        out[f"{mode}_{key}_score_rtol"], rtol)
        log(f"{fusion} bf16 order witness, seed {seed}: " + ", ".join(
            f"{mode} {key} {out[f'{mode}_{key}'][-1]:.4f}"
            for mode in ("beam", "greedy") for key in pairs))
    for mode in ("beam", "greedy"):
        for key in pairs:
            vals = out[f"{mode}_{key}"]
            out[f"{mode}_{key}_pooled"] = sum(vals) / len(vals)
        pooled = out[f"{mode}_kernel_vs_plain_pooled"]
        log(f"{fusion} bf16 {mode} caption match pooled over "
            f"{len(ATT_SEEDS)} seeds: kernel vs plain {pooled:.4f}, plain "
            "vs permuted plain "
            f"{out[f'{mode}_plain_vs_plain_permuted_pooled']:.4f}, kernel "
            "vs permuted kernel "
            f"{out[f'{mode}_kernel_vs_kernel_permuted_pooled']:.4f}; max "
            "score rtol over matching captions: " + ", ".join(
                f"{key} {out[f'{mode}_{key}_score_rtol']:.3e}"
                for key in pairs))
        order = out[f"{mode}_plain_vs_plain_permuted_pooled"]
        if pooled < floor:
            fail(f"{fusion} bf16 {mode} pooled caption match {pooled:.4f} "
                 f"below the kernel floor {floor}")
        if pooled < order - ATT_WITNESS_MARGIN:
            fail(f"{fusion} bf16 {mode}: kernel vs plain moves more "
                 f"captions ({pooled:.4f} match) than a change of summation "
                 f"order does ({order:.4f}) by over {ATT_WITNESS_MARGIN}")
    return out


def att_decode_work(rows: int, itemsize: int, out_bytes: int):
    """FLOPs, compulsory bytes and tanh count of one attention decode
    call: the meanpool work plus, per step and row, the query GEMM, the
    ctx gate GEMM, the score and the context mix."""
    flops, nbytes = decode_work(rows, itemsize, out_bytes)
    flops += T * 2 * rows * (H * A_ATT + E * 4 * H + F_ATT * (A_ATT + E))
    nbytes += (E * 4 * H + H * A_ATT + A_ATT) * itemsize
    nbytes += B * F_ATT * (A_ATT + E) * itemsize + B * F_ATT * 4
    return flops, nbytes, T * rows * F_ATT * A_ATT


# ------------------------------------------------------------ phase 2d

# Kernel vs plain version of the attention recurrence (no token
# feedback, so no chaos): float32 forward (h_seq, c_seq, a_seq), the
# backward kernel on the plain forward's residuals and the end-to-end
# gradients (each relative to its max |value|), bfloat16 h_seq.  The
# first H100 run read 3.6e-07 (forward), 1.3e-06 (backward kernel) and
# 1.4e-06 (end to end) against the 1e-4 start bounds, and a bf16 h gap
# of exactly one ulp at |h| < 1 (3.9e-3; 3.7% of h differ: the bf16
# rounding of the query flips where its f32 sum differs in the last
# bit).  So the float32 bounds are tightened to 1e-5, what a change of
# summation order could still produce; bf16 stays at one ulp (4e-3).
# The tensor-core kernels (bf16 products in the mma order) read the same
# one ulp, and so does the order witness (att_rec_order_witness): the
# bound admits more than the plain version's own order.
ATT_F32_ATOL = 1e-5
ATT_BF16_H_ATOL = 4e-3
ATT_GRAD_RTOL = 1e-5
# The bf16 backward kernel vs its plain version on the same residuals
# (the plain forward's): each cotangent in bf16 ulps of the larger of
# the two values, past an absolute allowance of ATT_BWD_BF16_ATOL_REL x
# its max |value| (near zero, where sums cancel, ulps mean nothing).
# dgx is float32 but rides on dgates rounded to bf16 before three
# products each step, so it is counted in bf16 ulps too.  The first H100
# run read at most 0.82 ulps (w_ctx; dgx 0), so the bound is 2 ulps,
# the CPU tests' bound for the plain version against the reference.
ATT_BWD_BF16_ULPS = 2.0
ATT_BWD_BF16_ATOL_REL = 1e-3
# The XE path's layout: R_XE = 64 videos x ATT_REP caption rows, the
# attention tensors per video (row r reads video r // ATT_REP).
ATT_REP = 20
# bf16 d_proj / d_vals per video: the float32 fold (each row's sum over
# reversed time, then the rows in row order) rounded once, against the
# float64-exact fold of the same rows.  One rounding is at most half an
# ulp; the bound leaves the float32 sums' own error half an ulp more.
ATT_FOLD_BF16_ULPS = 1.0
ATT_TOL_TEXT = (
    f"f32: |h|,|c|,|a| diff <= {ATT_F32_ATOL:g} (max_abs_err_f32), grads "
    f"(backward kernel on the same residuals, and end to end) <= "
    f"{ATT_GRAD_RTOL:g} x max|grad|; bf16: |h diff| <= {ATT_BF16_H_ATOL:g} "
    f"(max_abs_err); bf16 backward on the same residuals: every cotangent "
    f"within {ATT_BWD_BF16_ULPS:g} bf16 ulps past {ATT_BWD_BF16_ATOL_REL:g} "
    f"x its max |value| (max_abs_err of the backward entry); rep = "
    f"{ATT_REP} (attention tensors per video): the forward bitwise rep = 1 "
    "on the repeated tensors (kernel and plain), d_proj / d_vals bitwise "
    "the rep = 1 rows folded in row order, f32 within "
    f"{ATT_GRAD_RTOL:g} x max of the plain gathered fold, bf16 within "
    f"{ATT_FOLD_BF16_ULPS:g} ulp of the float64-exact fold; the same at "
    "the edge shapes; the bf16 tanh table bitwise tanhf on every bf16 "
    "value but NaN (NaN there)")
GRAD_NAMES = ("gx", "wh", "w_ctx", "att_wh", "att_v", "att_proj",
              "att_mask", "att_vals")
BWD_NAMES = tuple(n for n in GRAD_NAMES if n != "att_mask")


def bf16_ulps(torch, got, want, atol_rel: float, bits: int = 7,
              low: float = 2.0 ** -126) -> float:
    """The largest gap between ``got`` and ``want`` in bf16 ulps (of a
    type with ``bits`` fraction bits and normals from ``low``) of the
    larger of the two values, after an absolute allowance of ``atol_rel``
    x max |want|."""
    g, w = got.double(), want.double()
    mag = torch.maximum(g.abs(), w.abs()).clamp_min(low)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - bits)
    gap = ((g - w).abs() - atol_rel * float(w.abs().max())).clamp_min(0)
    return float((gap / ulp).max())


def f16_ulps(torch, got, want, atol_rel: float) -> float:
    """``bf16_ulps`` in float16 ulps (10 fraction bits; the subnormal
    quantum 2^-24 below 2^-14)."""
    return bf16_ulps(torch, got, want, atol_rel, 10, 2.0 ** -14)


def ulps_of(torch, cdt):
    """``bf16_ulps`` or ``f16_ulps``, for the 16-bit dtype ``cdt``."""
    return f16_ulps if cdt == torch.float16 else bf16_ulps


def att_rec_inputs(torch, seed: int, R: int, T: int):
    """The attention recurrence's operands at model init scale, drawn on
    the card from ``seed``, plus an output cotangent: R caption rows over
    R // ATT_REP videos, the attention tensors per video and att_mask as
    ``att_mask`` gives (masked tails, video 0 all masked)."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    kw = dict(generator=g, device=DEVICE)
    nv = R // ATT_REP
    args = [torch.randn(R, T, 4 * H, **kw) * 0.5,
            torch.randn(H, 4 * H, **kw) * 0.03,
            torch.randn(E, 4 * H, **kw) * 0.03,
            torch.randn(H, A_ATT, **kw) * 0.03,
            torch.randn(A_ATT, 1, **kw) * 0.06,
            torch.randn(nv, F_ATT, A_ATT, **kw) * 0.5,
            att_mask(torch, torch.Generator().manual_seed(seed), nv, DEVICE),
            torch.randn(nv, F_ATT, E, **kw) * 0.5]
    return args, torch.randn(R, T, H, **kw)


def att_rec_cast(args, cdt):
    return [x if i in (0, 6) else x.to(cdt) for i, x in enumerate(args)]


def att_rows(args, rep: int):
    """The gathered layout: the per-video attention tensors repeated to
    their caption rows, as the reference's ``_repeat_cache``."""
    return [x.repeat_interleave(rep, 0) if i in (5, 6, 7) else x
            for i, x in enumerate(args)]


def exact_dot(a, b, cdt):
    """``dot_f32`` with the products summed in float64 and rounded once
    to float32 (the order witness's products)."""
    return (a.to(cdt).double() @ b.to(cdt).double()).float()


def hold_att_rep_forward(torch, att_mod, a32, a16):
    """rep = ATT_REP against rep = 1 on the repeated tensors: h_seq,
    c_seq and a_seq bitwise, for the kernel and the plain version, in
    both dtypes."""
    out = {}
    for tag, args in (("f32", a32), ("bf16", a16)):
        rows = att_rows(args, ATT_REP)
        for who, fn in (("kernel", att_mod.attlstm_recurrence_fwd),
                        ("plain", att_mod.attlstm_recurrence_ref)):
            per_video = fn(*args, ATT_REP, with_residuals=True)
            gathered = fn(*rows, 1, with_residuals=True)
            torch.cuda.synchronize()
            same = all(bool(torch.equal(x, y))
                       for x, y in zip(per_video, gathered))
            log(f"attlstm_recurrence {tag} {who}: rep={ATT_REP} over "
                f"{R_XE // ATT_REP} videos vs rep=1 on the repeated tensors "
                f"bitwise: {same}")
            if not same:
                fail(f"attlstm_recurrence {tag} {who} at rep={ATT_REP} "
                     "differs from rep=1 on the repeated tensors")
            out[f"{tag}_{who}"] = same
    return out


def hold_att_fold(torch, att_mod, args, resid, dh, tag: str):
    """The backward's per-video d_proj / d_vals (rep = ATT_REP) against the
    gathered layout: the kernel at rep = 1 on the repeated tensors, its
    rows folded by the plain version's fold (``_fold_rows``, row order):
    bitwise, with dgx and dq bitwise too (per-row arithmetic).  f32: within
    ATT_GRAD_RTOL x max of the plain version's gathered rows folded.  bf16:
    the kernel's once-rounded d_proj / d_vals in ulps of the float64-exact
    fold of its rep = 1 rows (held at ATT_FOLD_BF16_ULPS), beside the
    reference's order (each row rounded, one rounded add per row)."""
    core = att_mod.attlstm_recurrence_bwd_core
    rows = att_rows(args, ATT_REP)
    c20 = core(*args[:6], args[7], *resid, dh, ATT_REP)
    c1 = core(*rows[:6], rows[7], *resid, dh, 1)
    torch.cuda.synchronize()
    out = {}
    same = [bool(torch.equal(c20[i], c1[i])) for i in (0, 1)]
    for i in (2, 3):  # d_proj, d_vals
        same.append(bool(torch.equal(c20[i],
                                     att_mod._fold_rows(c1[i], ATT_REP))))
    log(f"attlstm_recurrence_bwd {tag}: rep={ATT_REP} vs rep=1 rows "
        f"(dgx, dq bitwise; d_proj, d_vals folded in row order bitwise): "
        f"{same}")
    if not all(same):
        fail(f"attlstm_recurrence_bwd {tag}: the per-video fold differs from "
             "the gathered layout folded in row order")
    out["bitwise"] = all(same)
    if tag == "f32":
        p1 = att_mod._bwd_core_ref(*rows[:6], rows[7], *resid, dh, 1)
        rel = {n: max_diff(c20[i], att_mod._fold_rows(p1[i], ATT_REP))
               / max(float(c20[i].abs().max()), 1e-30)
               for i, n in ((2, "d_proj"), (3, "d_vals"))}
        log(f"attlstm_recurrence_bwd f32: per-video kernel vs the plain "
            f"gathered rows folded (of max): " + ", ".join(
                f"{n} {v:.3e}" for n, v in rel.items()))
        if not max(rel.values()) <= ATT_GRAD_RTOL:
            fail("attlstm_recurrence_bwd f32 per-video fold outside "
                 "ATT_GRAD_RTOL of the gathered layout")
        out["f32_rel"] = rel
        return out
    cdt = args[1].dtype
    u = ulps_of(torch, cdt)
    tier = F16_ATT_FOLD_ULPS if cdt == torch.float16 else ATT_FOLD_BF16_ULPS
    ulps, ref_ulps = {}, {}
    for i, n in ((2, "d_proj"), (3, "d_vals")):
        rows_i = c1[i].reshape(-1, ATT_REP, *c1[i].shape[1:])
        exact = rows_i.double().sum(1)
        ulps[n] = u(torch, c20[i].to(cdt), exact, ATT_BWD_BF16_ATOL_REL)
        acc = rows_i[:, 0].to(cdt)
        for j in range(1, ATT_REP):
            acc = (acc.float() + rows_i[:, j].to(cdt).float()).to(cdt)
        ref_ulps[n] = u(torch, acc, exact, ATT_BWD_BF16_ATOL_REL)
    log(f"attlstm_recurrence_bwd {tag} per-video fold in {tag} ulps of the "
        f"float64-exact fold (past {ATT_BWD_BF16_ATOL_REL:g} x max): one "
        "rounding " + ", ".join(f"{n} {v:.2f}" for n, v in ulps.items())
        + "; the reference's order (rows rounded, one rounded add each) "
        + ", ".join(f"{n} {v:.2f}" for n, v in ref_ulps.items()))
    if not max(ulps.values()) <= tier:
        fail(f"attlstm_recurrence_bwd {tag} per-video fold is not within "
             f"{tier:g} ulp of the exact fold")
    out[f"{tag}_ulps"], out[f"{tag}_ulps_reference_order"] = ulps, ref_ulps
    return out


def att_rec_order_witness(torch, att_mod, a16, rr16, dh16, rh, rb):
    """Reported, not held: the plain forward and backward with every
    product summed exactly (``exact_dot``: float64, rounded once) against
    the plain version (``rh``, ``rb``), by 2d's measures at ``a16``'s
    16-bit dtype: max |h diff| (ATT_BF16_H_ATOL; 14a's F16_ATT_H_ATOL)
    and each cotangent's ulps of that dtype on the plain forward's
    residuals (ATT_BWD_BF16_ULPS; F16_ATT_BWD_ULPS).  What any other order
    of the products moves, the tensor cores' included."""
    f16 = a16[1].dtype == torch.float16
    dt, h_tier, b_tier = (("f16", F16_ATT_H_ATOL, F16_ATT_BWD_ULPS) if f16
                          else ("bf16", ATT_BF16_H_ATOL, ATT_BWD_BF16_ULPS))
    real = att_mod._dot
    att_mod._dot = exact_dot
    try:
        wh_ = att_mod.attlstm_recurrence_ref(*a16, ATT_REP)
        wb = att_mod.attlstm_recurrence_bwd_ref(*a16[:6], a16[7], *rr16,
                                                dh16, ATT_REP)
    finally:
        att_mod._dot = real
    torch.cuda.synchronize()
    h_err = max_diff(wh_, rh)
    u = ulps_of(torch, a16[1].dtype)
    ulps = {n: u(torch, x, y, ATT_BWD_BF16_ATOL_REL)
            for n, x, y in zip(BWD_NAMES, wb, rb)}
    log(f"attlstm_recurrence {dt} order witness (not held): the plain "
        f"version with exact products vs the plain version: max |h diff| "
        f"{h_err:.3e} (share of h differing "
        f"{float((wh_ != rh).float().mean()):.2e}; tier {h_tier:g}); "
        f"backward {dt} ulps "
        + ", ".join(f"{n} {v:.2f}" for n, v in ulps.items())
        + f" (tier {b_tier:g})")
    return {"h_err": h_err, "bwd_ulps": ulps,
            "bwd_ulps_max": max(ulps.values())}


def att_launches(torch, fn, what: str, want: int, dt: str = "bf16"):
    """The port's kernels launched by one call, held at ``want``: a
    profiler window must record exactly that many (``profiled``, which
    fails a window with more and, once every window of PROFILE_PADS_S
    has recorded fewer, none included, the count).  Returns ``want``."""
    rows = profiled(torch, fn, 1, launches=want)
    for kname, ms, count in sorted(rows, key=lambda r: -r[1]):
        log(f"breakdown {dt} {what}: {kname} {ms:.3f} ms over {count:g} "
            "launches")
    log(f"{what} {dt}: {want} kernel launches a call (held)")
    return want


# Off the XE shape, at the path's widths: 3 videos x 7 captions (rows
# that fill neither the GEMMs' 64-row tiles nor the attention blocks' 4
# rows) over T = 3, and T = 1 (the zero-state step alone) at rep = 1.
ATT_EDGE_SHAPES = ((3, 7, 3), (2, 1, 1))   # videos, rep, T


def check_att_edge_shapes(torch, att_mod):
    """2d off the main shape, in each dtype: the forward and backward
    kernels vs their plain versions at 2d's tolerances, rep vs rep = 1 on
    the repeated tensors (the forward bitwise, d_proj / d_vals bitwise
    the rows folded in row order).  Returns the largest readings."""
    fwd, ref = att_mod.attlstm_recurrence_fwd, att_mod.attlstm_recurrence_ref
    bwd, bwd_ref = att_mod.attlstm_recurrence_bwd, att_mod.attlstm_recurrence_bwd_ref
    core = att_mod.attlstm_recurrence_bwd_core
    out = {"f32_err": 0.0, "f32_grad_rel": 0.0, "bf16_err": 0.0,
           "bf16_ulps": 0.0}
    for nv, rep, t in ATT_EDGE_SHAPES:
        g = torch.Generator(device=DEVICE).manual_seed(100 * nv + 10 * rep + t)
        kw = dict(generator=g, device=DEVICE)
        R = nv * rep
        a32 = [torch.randn(R, t, 4 * H, **kw) * 0.5,
               torch.randn(H, 4 * H, **kw) * 0.03,
               torch.randn(E, 4 * H, **kw) * 0.03,
               torch.randn(H, A_ATT, **kw) * 0.03,
               torch.randn(A_ATT, 1, **kw) * 0.06,
               torch.randn(nv, F_ATT, A_ATT, **kw) * 0.5,
               att_mask(torch, torch.Generator().manual_seed(nv), nv, DEVICE),
               torch.randn(nv, F_ATT, E, **kw) * 0.5]
        dh = torch.randn(R, t, H, **kw)
        for tag, cdt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            a = att_rec_cast(a32, cdt)
            rows = att_rows(a, rep)
            d = dh.to(cdt)
            k = fwd(*a, rep, with_residuals=True)
            r = ref(*a, rep, with_residuals=True)
            same = all(bool(torch.equal(x, y)) for x, y in
                       zip(k, fwd(*rows, 1, with_residuals=True)))
            kb = bwd(*a[:6], a[7], *r, d, rep)
            rb = bwd_ref(*a[:6], a[7], *r, d, rep)
            c_rep = core(*a[:6], a[7], *r, d, rep)
            c_one = core(*rows[:6], rows[7], *r, d, 1)
            torch.cuda.synchronize()
            same = same and all(
                bool(torch.equal(c_rep[i], att_mod._fold_rows(c_one[i], rep)))
                for i in (2, 3))
            what = (f"attlstm_recurrence edge shape {nv} videos x rep {rep}, "
                    f"T={t} ({tag})")
            if tag == "f32":
                err = max(max_diff(x, y) for x, y in zip(k, r))
                rel = max(max_diff(x, y) / max(float(y.abs().max()), 1e-30)
                          for x, y in zip(kb, rb))
                ok = err <= ATT_F32_ATOL and rel <= ATT_GRAD_RTOL
                out["f32_err"] = max(out["f32_err"], err)
                out["f32_grad_rel"] = max(out["f32_grad_rel"], rel)
                log(f"{what}: max |h,c,a diff| {err:.3e}, backward {rel:.3e} "
                    f"of max; rep vs rep=1 bitwise {same}")
            else:
                err = max_diff(k[0], r[0])
                ulps = max(bf16_ulps(torch, x, y, ATT_BWD_BF16_ATOL_REL)
                           for x, y in zip(kb, rb))
                ok = err <= ATT_BF16_H_ATOL and ulps <= ATT_BWD_BF16_ULPS
                out["bf16_err"] = max(out["bf16_err"], err)
                out["bf16_ulps"] = max(out["bf16_ulps"], ulps)
                log(f"{what}: max |h diff| {err:.3e}, backward {ulps:.2f} bf16 "
                    f"ulps; rep vs rep=1 bitwise {same}")
            if not (ok and same and bool(torch.isfinite(k[0].float()).all())):
                fail(f"{what} disagrees with its plain version or its "
                     "repeated layout")
    return out


def check_att_recurrence(torch, att_mod):
    """Phase 2d (see module docstring)."""
    fwd, ref = att_mod.attlstm_recurrence_fwd, att_mod.attlstm_recurrence_ref
    bwd, bwd_ref = att_mod.attlstm_recurrence_bwd, att_mod.attlstm_recurrence_bwd_ref
    rep = ATT_REP
    res = {}
    tt = att_mod.tanh_table_check(DEVICE)
    torch.cuda.synchronize()
    bits = tt.view(torch.int32)
    nan_in = (torch.arange(65536, device=tt.device) & 0x7fff) > 0x7f80
    n_bad = int(torch.where(nan_in, ~(tt[0].isnan() & tt[1].isnan()),
                            bits[0] != bits[1]).sum())
    log(f"attlstm bf16 tanh table vs tanhf on all 65,536 bf16 values "
        f"(bitwise; NaN for the {int(nan_in.sum())} NaN inputs): {n_bad} "
        "differ")
    if n_bad:
        fail("the bf16 kernels' tanh table differs from tanhf")
    res["tanh_table_exact"] = True
    a32, dh = att_rec_inputs(torch, 21, R_XE, T_XE)
    a16 = att_rec_cast(a32, torch.bfloat16)

    k = fwd(*a32, rep, with_residuals=True)
    r = ref(*a32, rep, with_residuals=True)
    torch.cuda.synchronize()
    errs = [max_diff(x, y) for x, y in zip(k, r)]
    log(f"attlstm_recurrence f32 R={R_XE} ({R_XE // rep} videos x {rep}) "
        f"T={T_XE} F={F_ATT} A={A_ATT}: max |h diff| {errs[0]:.3e}, |c diff| "
        f"{errs[1]:.3e}, |a diff| {errs[2]:.3e}; all-masked video uniform "
        f"{bool(torch.allclose(k[2][0], torch.full_like(k[2][0], 1 / F_ATT)))}")
    if not max(errs) <= ATT_F32_ATOL or not torch.isfinite(k[0]).all():
        fail("attlstm_recurrence float32 disagrees with its plain version")
    if not torch.equal(fwd(*a32, rep), k[0]):
        fail("attlstm_recurrence without residuals differs from with them")
    res["f32_err"] = max(errs)
    res["rep_forward"] = hold_att_rep_forward(torch, att_mod, a32, a16)

    kb = bwd(*a32[:6], a32[7], *r, dh, rep)
    rb = bwd_ref(*a32[:6], a32[7], *r, dh, rep)
    torch.cuda.synchronize()
    rel = {n: max_diff(x, y) / max(float(y.abs().max()), 1e-30)
           for n, x, y in zip(BWD_NAMES, kb, rb)}
    log("attlstm_recurrence_bwd f32, kernel vs plain on the same residuals "
        "(of max |grad|): " + ", ".join(f"{n} {v:.3e}" for n, v in rel.items()))
    if not max(rel.values()) <= ATT_GRAD_RTOL:
        fail("attlstm_recurrence backward kernel disagrees with its plain "
             "version")
    res["bwd_grad_rel"] = max(rel.values())
    res["bwd_f32_err"] = max(max_diff(x, y) for x, y in zip(kb, rb))
    del kb, rb
    res["fold_f32"] = hold_att_fold(torch, att_mod, a32, r, dh, "f32")

    leaves = [x.clone().requires_grad_() for x in a32]
    (att_mod.attlstm_recurrence(*leaves, rep) * dh).sum().backward()
    want = list(bwd_ref(*a32[:6], a32[7], *r, dh, rep))
    want.insert(6, torch.zeros_like(a32[6]))
    torch.cuda.synchronize()
    e2e = {}
    for n, x, y in zip(GRAD_NAMES, leaves, want):
        e2e[n] = max_diff(x.grad, y) / max(float(y.abs().max()), 1e-30)
    log("attlstm_recurrence f32 gradients end to end, kernels vs all-plain "
        "(of max |grad|; att_mask is zero on both): "
        + ", ".join(f"{n} {v:.3e}" for n, v in e2e.items()))
    if not max(e2e.values()) <= ATT_GRAD_RTOL:
        fail("attlstm_recurrence gradients disagree with the plain path")
    res["grad_rel"] = max(e2e.values())
    del leaves, want

    kh = fwd(*a16, rep)
    rh = ref(*a16, rep)
    torch.cuda.synchronize()
    res["bf16_err"] = max_diff(kh, rh)
    res["bf16_share_differing"] = float((kh != rh).float().mean())
    log(f"attlstm_recurrence bf16: max |h diff| {res['bf16_err']:.3e} (share "
        f"of h differing {res['bf16_share_differing']:.2e})")
    if not res["bf16_err"] <= ATT_BF16_H_ATOL:
        fail("attlstm_recurrence bfloat16 outside its tolerance")

    rr16 = ref(*a16, rep, with_residuals=True)
    dh16 = dh.to(torch.bfloat16)
    kb = bwd(*a16[:6], a16[7], *rr16, dh16, rep)
    rb = bwd_ref(*a16[:6], a16[7], *rr16, dh16, rep)
    torch.cuda.synchronize()
    ulps = {n: bf16_ulps(torch, x, y, ATT_BWD_BF16_ATOL_REL)
            for n, x, y in zip(BWD_NAMES, kb, rb)}
    rel = {n: max_diff(x, y) / max(float(y.float().abs().max()), 1e-30)
           for n, x, y in zip(BWD_NAMES, kb, rb)}
    log("attlstm_recurrence_bwd bf16, kernel vs plain on the same "
        f"residuals: bf16 ulps past {ATT_BWD_BF16_ATOL_REL:g} x max "
        "|value|: " + ", ".join(f"{n} {v:.2f}" for n, v in ulps.items())
        + "; of max |grad|: " + ", ".join(f"{n} {v:.3e}"
                                          for n, v in rel.items()))
    if not max(ulps.values()) <= ATT_BWD_BF16_ULPS:
        fail("attlstm_recurrence backward kernel bfloat16 disagrees with "
             "its plain version")
    res["bwd_bf16_ulps"] = ulps
    res["bwd_bf16_err"] = max(max_diff(x, y) for x, y in zip(kb, rb))
    del kb
    res["fold_bf16"] = hold_att_fold(torch, att_mod, a16, rr16, dh16, "bf16")
    res["order_witness"] = att_rec_order_witness(torch, att_mod, a16, rr16,
                                                 dh16, rh, rb)
    del rb
    res["edge_shapes"] = check_att_edge_shapes(torch, att_mod)

    for tag, args in (("bf16", a16), ("f32", a32)):
        res[f"ms_{tag}"] = time_call(
            torch, lambda: fwd(*args, rep, with_residuals=True), REPS)
        res[f"ms_nores_{tag}"] = time_call(torch, lambda: fwd(*args, rep),
                                           REPS)
        res[f"plain_ms_{tag}"] = time_call(
            torch, lambda: ref(*args, rep, with_residuals=True), 1)
        rr = ref(*args, rep, with_residuals=True)
        dh_t = dh.to(args[1].dtype)
        res[f"bwd_ms_{tag}"] = time_call(
            torch, lambda: bwd(*args[:6], args[7], *rr, dh_t, rep), REPS)
        res[f"bwd_plain_ms_{tag}"] = time_call(
            torch, lambda: bwd_ref(*args[:6], args[7], *rr, dh_t, rep), 1)
        rows = att_rows(args, rep)
        res[f"ms_rep1_{tag}"] = time_call(
            torch, lambda: fwd(*rows, 1, with_residuals=True), REPS)
        res[f"bwd_ms_rep1_{tag}"] = time_call(
            torch, lambda: bwd(*rows[:6], rows[7], *rr, dh_t, 1), REPS)
        log(f"times {tag}: attlstm_recurrence {res[f'ms_{tag}']:.3f} ms with "
            f"residuals, {res[f'ms_nores_{tag}']:.3f} ms without (plain "
            f"{res[f'plain_ms_{tag}']:.3f} ms); backward kernel "
            f"{res[f'bwd_ms_{tag}']:.3f} ms incl. the three weight "
            f"contractions (plain {res[f'bwd_plain_ms_{tag}']:.3f} ms); at "
            f"rep=1 on the repeated tensors {res[f'ms_rep1_{tag}']:.3f} / "
            f"{res[f'bwd_ms_rep1_{tag}']:.3f} ms")
        del rr, rows
    res["launches_per_call"] = {
        "forward": att_launches(
            torch, lambda: fwd(*a16, rep, with_residuals=True),
            "attlstm_recurrence", 3 * T_XE - 1),
        "backward": att_launches(
            torch, lambda: bwd(*a16[:6], a16[7], *rr16, dh16, rep),
            "attlstm_recurrence_bwd", 4 * T_XE + 3)}
    return res


def att_rec_work(R: int, T: int, itemsize: int, rep: int = 1):
    """(forward, backward) FLOPs, compulsory bytes and tanh counts of one
    attention recurrence call with residuals (the backward without the
    three weight contractions done outside it), with the attention
    tensors per video (R // rep videos; rep = 1: per row)."""
    RT, nv = R * T, R // rep
    att_in = nv * F_ATT * (A_ATT + E) * itemsize + nv * F_ATT * 4
    w = (H * 4 * H + E * 4 * H + H * A_ATT + A_ATT) * itemsize
    res = RT * H * itemsize + RT * H * 4 + RT * F_ATT * 4   # h, c, a
    f_flops = 2 * RT * (H * 4 * H + E * 4 * H + H * A_ATT
                        + F_ATT * (A_ATT + E))
    f_bytes = RT * 4 * H * 4 + w + att_in + res
    b_flops = (2 * RT * (2 * 4 * H * (E + H) + 2 * H * A_ATT)
               + RT * F_ATT * (6 * E + 8 * A_ATT))
    b_bytes = (RT * 4 * H * 4 + w + att_in + res + RT * H * itemsize
               + RT * 4 * H * 4 + RT * A_ATT * 4
               + nv * F_ATT * (A_ATT + E) * 4 + A_ATT * 4)
    tanh = RT * F_ATT * A_ATT
    return (f_flops, f_bytes, tanh), (b_flops, b_bytes, tanh)


def rec_bound(flops: float, nbytes: float, tanh: float, peak: float):
    """(bound ms, "bytes" or "operations", the binding term): the larger
    of the byte floor, the other operations at ``peak`` and the tanh
    count at the SFU rate."""
    terms = {"bytes": nbytes / H100_BYTES_PER_S * 1e3,
             "products": flops / peak * 1e3, "tanh": sfu_floor_ms(tanh)}
    term = max(terms, key=terms.get)
    return terms[term], ("bytes" if term == "bytes" else "operations"), term


# SFU rate for tanh: 16 special-function results per SM per clock
# (H100 SM), 132 SMs at the 1.98 GHz boost clock.
H100_SFU_PER_S = 132 * 16 * 1.98e9


def sfu_floor_ms(n_tanh: float) -> float:
    return n_tanh / H100_SFU_PER_S * 1e3


# ------------------------------------------------------------ phase 2e

# fused_context_attention vs its plain version: float32 ctx and weights
# within CTX_F32_RTOL x max |value| (a change of summation order over A
# and F is all that differs); bfloat16 ctx within one bf16 ulp (the f32
# mix is rounded once, and an f32 difference in the last bit can flip
# that rounding) past an absolute CTX_BF16_ATOL_REL x max |value|, the
# weights (f32 in both dtypes) within 1e-5; rep = 5 bitwise the gathered
# layout at rep = 1.  The allowance: the first H100 run read 5 ulps on a
# few entries with |ctx| near 1e-5, where the f32 mix's own difference
# (<= 1.8e-7 in the f32 check, from the weights' last bits times |vals|)
# is several bf16 ulps of the entry; it is 50x that f32 reading.
CTX_F32_RTOL = 1e-5
CTX_BF16_ULPS = 1.0
CTX_BF16_ATOL_REL = 1e-5
CTX_BF16_ATTN_ATOL = 1e-5
CTX_TOLERANCE = (
    f"f32: |ctx|, |attn| diff <= {CTX_F32_RTOL:g} x max |value| "
    f"(max_abs_err_f32); bf16: ctx within {CTX_BF16_ULPS:g} bf16 ulp past "
    f"{CTX_BF16_ATOL_REL:g} x max |ctx| (max_abs_err: the bf16 |ctx "
    f"diff|), attn within {CTX_BF16_ATTN_ATOL:g}; rep=5 bitwise equal to "
    "rep=1 on the gathered tensors")


def ctx_inputs(torch, seed: int):
    """The context step's operands at the slot loop's beam shape: B*K
    queries, B videos' att_proj / att_vals / masks (``att_mask``: masked
    tails, video 0 all masked), att_v at the decoders' scale."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, sc: torch.randn(*s, generator=g) * sc  # noqa: E731
    return dict(q=r(B * K, A_ATT, sc=0.5), proj=r(B, F_ATT, A_ATT, sc=0.5),
                mask=att_mask(torch, g, B), vals=r(B, F_ATT, E, sc=0.5),
                v=r(A_ATT, 1, sc=0.06))


def ctx_work(R: int, n_videos: int, itemsize: int, attn_out: bool = False):
    """(FLOPs, compulsory bytes, tanh count) of one context call: read
    q, att_v and the videos' att_proj / att_vals / mask once, write ctx
    (and, with ``attn_out``, the float32 weights, which training saves;
    the serving path asks for none)."""
    flops = R * F_ATT * (2 * A_ATT + 2 * E)
    nbytes = ((R * A_ATT + A_ATT + n_videos * F_ATT * (A_ATT + E)
               + R * E) * itemsize + n_videos * F_ATT * 4
              + (R * F_ATT * 4 if attn_out else 0))
    return flops, nbytes, R * F_ATT * A_ATT


def ctx_bound(R: int, n_videos: int, itemsize: int, attn_out: bool = False):
    """The context step's bound: bytes, or tanh at the SFU rate and its
    other operations at the f32 rate."""
    return rec_bound(*ctx_work(R, n_videos, itemsize, attn_out),
                     H100_F32_FLOPS)[:2]


def check_context_attention(torch, att_mod):
    """Phase 2e (see module docstring)."""
    fca, ref = att_mod.fused_context_attention, att_mod.fused_context_attention_ref
    a = ctx_inputs(torch, 31)
    res = {}
    for tag, cdt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        proj, vals = a["proj"].to(DEVICE, cdt), a["vals"].to(DEVICE, cdt)
        mask, v = a["mask"].to(DEVICE), a["v"].to(DEVICE, cdt)
        for R, rep in ((B * K, K), (B, 1)):
            q = a["q"][:R].to(DEVICE, cdt)
            args = (q, proj, mask, vals, v)
            kc, ka = fca(*args, rep=rep, return_attn=True)
            rc, ra = ref(*args, rep=rep)
            torch.cuda.synchronize()
            ec, ea = max_diff(kc, rc), max_diff(ka, ra)
            what = f"fused_context_attention {tag} R={R} rep={rep}"
            uniform = bool(torch.allclose(
                ka[0], torch.full_like(ka[0], 1.0 / F_ATT)))
            if tag == "f32":
                ok = (ec <= CTX_F32_RTOL * float(rc.abs().max())
                      and ea <= CTX_F32_RTOL * float(ra.abs().max()))
                log(f"{what}: max |ctx diff| {ec:.3e}, |attn diff| {ea:.3e}; "
                    f"all-masked row uniform {uniform}")
            else:
                ulps = bf16_ulps(torch, kc, rc, CTX_BF16_ATOL_REL)
                raw = bf16_ulps(torch, kc, rc, 0.0)
                ok = ulps <= CTX_BF16_ULPS and ea <= CTX_BF16_ATTN_ATOL
                log(f"{what}: ctx {ulps:.2f} bf16 ulps past "
                    f"{CTX_BF16_ATOL_REL:g} x max ({raw:.2f} without), max "
                    f"|diff| {ec:.3e}, share differing "
                    f"{float((kc != rc).float().mean()):.2e}, |attn diff| "
                    f"{ea:.3e}; all-masked row uniform {uniform}")
            if not ok or not uniform or not torch.isfinite(kc.float()).all():
                fail(f"{what} disagrees with its plain version")
            res[f"err_{tag}_R{R}"] = ec
            res[f"attn_err_{tag}_R{R}"] = ea
            res[f"device_ms_{tag}_R{R}"] = device_ms(
                torch, lambda: fca(*args, rep=rep), REPS, CTX_LAUNCHES)
            if rep == 1:
                res[f"ms_{tag}_R{R}"] = time_call(
                    torch, lambda: fca(*args), REPS)
                res[f"plain_ms_{tag}_R{R}"] = time_call(
                    torch, lambda: ref(*args), 1)
                continue
            gp, gm, gv = (x.repeat_interleave(rep, dim=0)
                          for x in (proj, mask, vals))
            gc, ga = fca(q, gp, gm, gv, v, return_attn=True)
            if not (torch.equal(gc, kc) and torch.equal(ga, ka)):
                fail(f"{what}: rep={rep} differs from the gathered layout")
            res[f"ms_{tag}_R{R}"] = time_call(
                torch, lambda: fca(*args, rep=rep), REPS)
            res[f"gathered_ms_{tag}_R{R}"] = time_call(
                torch, lambda: fca(q, gp, gm, gv, v), REPS)
            res[f"plain_ms_{tag}_R{R}"] = time_call(
                torch, lambda: ref(*args, rep=rep), 1)
            log(f"{what}: rep={rep} bitwise equal to the gathered layout")
            if tag == "bf16":
                res["launches_per_call_bf16"] = ctx_launches(
                    torch, lambda: fca(*args, rep=rep),
                    "fused_context_attention", CTX_LAUNCHES)
        log(f"times {tag}: fused_context_attention R={B * K} rep={K} "
            f"{res[f'ms_{tag}_R{B * K}']:.4f} ms by the event clock, "
            f"{res[f'device_ms_{tag}_R{B * K}']:.4f} ms device (gathered "
            f"rep=1 {res[f'gathered_ms_{tag}_R{B * K}']:.4f} ms, plain "
            f"{res[f'plain_ms_{tag}_R{B * K}']:.4f} ms), R={B} rep=1 "
            f"{res[f'ms_{tag}_R{B}']:.4f} ms, "
            f"{res[f'device_ms_{tag}_R{B}']:.4f} ms device (plain "
            f"{res[f'plain_ms_{tag}_R{B}']:.4f} ms); bound "
            f"{ctx_bound(B * K, B, 2 if tag == 'bf16' else 4)[0]:.4f} ms")
    res["edges"] = check_context_edges(torch, att_mod)
    return res


# Off the main shapes (2e and 2g), at the same tolerances and with rep
# bitwise the gathered layout: (videos, rep, F, A, E).  One video (a
# cluster of 8 CTAs, 7 frames each); 3 videos x 7 rows over F = 7 frames
# at narrow widths the CUDA gate admits (A = 264 is 33 16-byte chunks,
# so a lane takes two; E = 40 is 5 chunks, fewer than the 8 CTAs, and
# one CTA owns no frame); the smallest bank (R = 40 at rep = K; the
# backward at two videos of CTXB_REP rows).
CTX_EDGE_SHAPES = ((1, K, F_ATT, A_ATT, E), (3, 7, 7, 264, 40),
                   (40 // K, K, F_ATT, A_ATT, E))
# One bf16 call's kernel launches in the profiler: the forward's one
# launch; the backward's cluster kernel and its d_v sum.
CTX_LAUNCHES = 1
CTXB_LAUNCHES = 2
CTX_PROFILED = 5  # calls in a launch-count window


def ctx_launches(torch, fn, what: str, launches: int,
                 dt: str = "bf16") -> int:
    """The port's kernels launched by one ``dt`` call, held at exactly
    ``launches``: a profiler window of CTX_PROFILED calls that recorded
    every launch (``profiled`` fails when none does, or on more), its
    kernels logged."""
    rows = profiled(torch, fn, CTX_PROFILED, launches)
    for kname, ms, count in rows:
        log(f"breakdown {dt} {what}: {kname} {ms:.4f} ms over {count:g} "
            "launches a call")
    log(f"{what} {dt}: {launches} kernel launches a call, as held")
    return launches


def ctx_edge_inputs(torch, seed: int, nv: int, rep: int, F: int, A: int,
                    Ee: int):
    """Operands of an off-main case: masked tails, video 0 all masked
    when there is more than one video."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, sc: torch.randn(*s, generator=g) * sc  # noqa: E731
    n = torch.randint(1, F + 1, (nv,), generator=g)
    mask = (torch.arange(F)[None, :] < n[:, None]).float()
    if nv > 1:
        mask[0] = 0.0
    return dict(q=r(nv * rep, A, sc=0.5), proj=r(nv, F, A, sc=0.5),
                mask=mask, vals=r(nv, F, Ee, sc=0.5), v=r(A, 1, sc=0.06),
                dctx=r(nv * rep, Ee, sc=1.0))


def check_context_edges(torch, att_mod):
    """Phase 2e off the main shapes (``CTX_EDGE_SHAPES``)."""
    fca, ref = att_mod.fused_context_attention, att_mod.fused_context_attention_ref
    out = []
    for i, (nv, rep, F, A, Ee) in enumerate(CTX_EDGE_SHAPES):
        a = ctx_edge_inputs(torch, 61 + i, nv, rep, F, A, Ee)
        for tag, cdt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            q, proj, vals, v = (a[k].to(DEVICE, cdt)
                                for k in ("q", "proj", "vals", "v"))
            mask = a["mask"].to(DEVICE)
            kc, ka = fca(q, proj, mask, vals, v, rep=rep, return_attn=True)
            rc, ra = ref(q, proj, mask, vals, v, rep=rep)
            gp, gm, gv = (x.repeat_interleave(rep, dim=0)
                          for x in (proj, mask, vals))
            gc, ga = fca(q, gp, gm, gv, v, return_attn=True)
            torch.cuda.synchronize()
            ec, ea = max_diff(kc, rc), max_diff(ka, ra)
            if tag == "f32":
                err = ec
                ok = (ec <= CTX_F32_RTOL * float(rc.abs().max())
                      and ea <= CTX_F32_RTOL * float(ra.abs().max()))
            else:
                err = bf16_ulps(torch, kc, rc, CTX_BF16_ATOL_REL)
                ok = err <= CTX_BF16_ULPS and ea <= CTX_BF16_ATTN_ATOL
            gathered = bool(torch.equal(gc, kc) and torch.equal(ga, ka))
            what = (f"fused_context_attention {tag} {nv} videos x rep={rep}, "
                    f"F={F}, A={A}, E={Ee}")
            log(f"{what}: ctx {'|diff|' if tag == 'f32' else 'bf16 ulps'} "
                f"{err:.3e}, |attn diff| {ea:.3e}; rep bitwise the gathered "
                f"layout {gathered}")
            if not ok or not torch.isfinite(kc.float()).all():
                fail(f"{what} disagrees with its plain version")
            if not gathered:
                fail(f"{what}: rep={rep} differs from the gathered layout")
            out.append(dict(videos=nv, rep=rep, F=F, A=A, E=Ee, dtype=tag,
                            ctx_err=err, attn_err=ea))
    return out


# ------------------------------------------------------------ phase 2f

# row_dot (csrc/row_gemm.cu): the per-step decode's and the admission
# encode's products.  Held: each row's bits are the same whatever the
# row count of the call (every prefix of RG_ROWS rows against the full
# call), and the values agree with the plain version (cuBLAS sgemm on the
# rounded operands, TF32 off) within RG_RTOL x max |value| (summation
# order only).  cuBLAS's own row invariance is measured and reported.
RG_RTOL = 1e-5
RG_ROWS = (1, 8, 40, 64, 80, 160, 320, 640)
RG_TIMED = 20  # timed calls per product (each well under a host launch)
RG_SHAPES = (("vocab", H, V), ("gates", 2 * E + H, 4 * H),
             ("query", H, A_ATT), ("encode_c3d", 4096, E))
# Three operand cases per product: f32 x and W (<float, float>); bf16 W
# with f32 x (<bf16, float>: the admission encode's feature rows); bf16 W
# with bf16 x (<bf16, bf16>: every per-step product of bf16 serving,
# whose x is h or the bf16 [emb | ctx | h]).  The kernels line's bf16
# numbers are the last case's.
RG_CASES = (("f32", "float32", "float32"), ("bf16_xf32", "bfloat16", "float32"),
            ("bf16", "bfloat16", "bfloat16"))
# int8w serving's products: int8 codes W with their per-column scale,
# x in the compute dtype (f32 compute with f32 x; bf16 compute with bf16
# x, every per-step product and the encode's att_wf).  Held bitwise to
# the float instantiation on the widened codes times the scale (the
# same ascending sum, then one float32 multiply), and within RG_RTOL x
# max |value| of cuBLAS on the dequantized weights.
RG_Q_CASES = (("int8_f32", "float32", "float32"),
              ("int8_bf16", "bfloat16", "bfloat16"))
RG_TOLERANCE = (f"rows bitwise invariant to the row count ({RG_ROWS}); "
                f"|diff| vs cuBLAS on the rounded operands <= {RG_RTOL:g} x "
                "max |value| (max_abs_err: bf16 W and x, max_abs_err_f32: "
                "f32, at the vocab product); int8 W: bitwise the float "
                "path on the widened codes times the scale, within "
                f"{RG_RTOL:g} x max |value| of cuBLAS on the dequantized W")


def rg_work(R: int, Kd: int, N: int, itemsize: int, x_itemsize: int):
    return 2 * R * Kd * N, R * Kd * x_itemsize + Kd * N * itemsize + R * N * 4


def check_row_gemm(torch, rg_mod, cases=RG_CASES, shapes=RG_SHAPES,
                   int8: bool = True):
    """Phase 2f (see module docstring); phase 14a's float16 cases with
    ``cases`` / ``shapes`` (no int8 weights)."""
    row_dot, ref = rg_mod.row_dot, rg_mod.row_dot_ref
    g = torch.Generator(device=DEVICE).manual_seed(41)
    res = {"cublas_rows_differing": {}}
    top = max(RG_ROWS)
    for name, Kd, N in RG_SHAPES:
        x32 = torch.randn(top, Kd, generator=g, device=DEVICE) * 0.5
        w = torch.randn(Kd, N, generator=g, device=DEVICE) * (1.0 / Kd ** 0.5)
        if all(name != n for n, _, _ in shapes):
            continue
        for tag, cname, xname in cases:
            cdt = getattr(torch, cname)
            x, wc = x32.to(getattr(torch, xname)), w.to(cdt)
            full = row_dot(x, wc, cdt)
            plain = ref(x, wc, cdt)
            torch.cuda.synchronize()
            err = max_diff(full, plain)
            rel = err / float(plain.abs().max())
            moved = [int((row_dot(x[:m], wc, cdt) != full[:m]).any(-1).sum())
                     for m in RG_ROWS]
            xr, wr = x.to(cdt).float(), wc.float()
            cub = {m: int(((xr[:m] @ wr) != plain[:m]).any(-1).sum())
                   for m in RG_ROWS}
            res["cublas_rows_differing"][f"{name}_{tag}"] = cub
            log(f"row_dot {name} K={Kd} N={N} {tag} (W {cname}, x {xname}): "
                f"|diff| vs cuBLAS "
                f"{err:.3e} ({rel:.2e} of max); rows moved by the row count "
                f"{sum(moved)}; cuBLAS rows differing from its {top}-row "
                f"call, by call rows: {cub}")
            if sum(moved) or not rel <= RG_RTOL:
                fail(f"row_dot {name} {tag}: not row-invariant or off its "
                     "plain version")
            t = time_row_dot(torch, res, name, tag,
                             lambda m: row_dot(x[:m], wc, cdt),
                             lambda m: xr[:m] @ wr,
                             "torch.matmul on the rounded operands")
            if name == "vocab" and not tag.endswith("_xf32"):
                R = B * K
                res[f"err_{tag}"] = err
                res[f"ms_{tag}"] = t["ms"]
                res[f"event_ms_{tag}"] = t["event_ms"]
                res[f"library_ms_{tag}"] = t["library_ms"]
                res[f"plain_ms_{tag}"] = time_call(
                    torch, lambda: ref(x[:R], wc, cdt), 1)
        if int8:
            check_row_gemm_int8(torch, rg_mod, res, name, x32, w)
    return res


def time_row_dot(torch, res, name: str, tag: str, kernel, library, lib: str):
    """Time ``kernel(m)`` and ``library(m)`` at the slot loop's beam rows
    (m = B * K) on one product: device ms per call from the profiler
    (``device_ms``; the kernel's own time), the event clock's ms beside
    it.  Recorded under ``res["shapes"][name][tag]``."""
    R = B * K
    t = {"ms": device_ms(torch, lambda: kernel(R), RG_TIMED),
         "event_ms": time_call(torch, lambda: kernel(R), RG_TIMED),
         "library_ms": device_ms(torch, lambda: library(R), RG_TIMED)}
    res.setdefault("shapes", {}).setdefault(name, {})[tag] = t
    log(f"times {tag}: row_dot {name} R={R} {t['ms']:.4f} ms device "
        f"({t['event_ms']:.4f} ms on the event clock), {lib} "
        f"{t['library_ms']:.4f} ms device")
    return t


def check_row_gemm_int8(torch, rg_mod, res, name, x32, w):
    """Phase 2f's int8-W cases (``RG_Q_CASES``) of one product."""
    from cst_captioning_torch.ops.quant import dequantize, quantize_per_channel

    row_dot, ref = rg_mod.row_dot, rg_mod.row_dot_ref
    codes, scale = (t.to(DEVICE) for t in quantize_per_channel(w.cpu(), 1))
    deq = dequantize(codes, scale, 1)
    Kd, N = w.shape
    for tag, cname, xname in RG_Q_CASES:
        cdt = getattr(torch, cname)
        x = x32.to(getattr(torch, xname))
        n0 = row_dot.quant_launches
        full = row_dot(x, codes, cdt, scale)
        widened = row_dot(x, codes.to(cdt), cdt) * scale
        cub = x.to(cdt).float() @ deq
        plain = ref(x, codes, cdt, scale)
        torch.cuda.synchronize()
        same = bool(torch.equal(full, widened))
        rel = max_diff(full, cub) / float(cub.abs().max())
        rel_plain = max_diff(full, plain) / float(plain.abs().max())
        moved = [int((row_dot(x[:m], codes, cdt, scale) != full[:m])
                      .any(-1).sum()) for m in RG_ROWS]
        log(f"row_dot {name} K={Kd} N={N} {tag} (int8 W, x {xname}, "
            f"compute {cname}): bitwise the widened-codes path {same}; "
            f"|diff| vs cuBLAS on the dequantized W {rel:.2e} of max, vs "
            f"the plain version {rel_plain:.2e}; rows moved by the row count "
            f"{sum(moved)}")
        if (not same or sum(moved) or not rel <= RG_RTOL
                or not rel_plain <= RG_RTOL
                or row_dot.quant_launches == n0):
            fail(f"row_dot {name} {tag}: int8 path not row-invariant, off "
                 "the float path on its codes, or off cuBLAS")
        xr = x.to(cdt).float()
        t = time_row_dot(torch, res, name, tag,
                         lambda m: row_dot(x[:m], codes, cdt, scale),
                         lambda m: xr[:m] @ deq,
                         "torch.matmul on the dequantized W")
        if name == "vocab":
            R = B * K
            res[f"err_{tag}"] = max_diff(full, cub)
            res[f"ms_{tag}"] = t["ms"]
            res[f"event_ms_{tag}"] = t["event_ms"]
            res[f"library_ms_{tag}"] = t["library_ms"]
            res[f"plain_ms_{tag}"] = time_call(
                torch, lambda: ref(x[:R], codes, cdt, scale), 1)


# ------------------------------------------------------------ phase 2g

# The backward kernel vs its plain version at the scheduled-sampling
# training shape (R_XE = 1280 caption rows over 64 videos, rep = 20, F =
# 56 with masked tails and video 0 all masked, A = E = 512), on the
# forward kernel's own weights: float32 cotangents within CTXB_F32_RTOL
# x their max |value| (a change of summation order is all that differs);
# bf16 within CTXB_BF16_ULPS bf16 ulps past CTXB_BF16_ATOL_REL x max
# |value| (phase 2d's measure: each row's rounded cotangent can flip
# with its float32 sum's last bit, and a video's 20 rounded rows are
# summed in bf16); rep = 20 vs the gathered layout (rep = 1 on the
# repeated tensors, then each video's rows folded in row order, as the
# kernel folds them): d_q, d_proj and d_vals bitwise, d_v (per-row
# partials reduced in another order) within the f32 bound.
CTXB_REP = 20
CTXB_F32_RTOL = 1e-5
CTXB_BF16_ULPS = 2.0
CTXB_BF16_ATOL_REL = 1e-3
CTXB_NAMES = ("d_q", "d_proj", "d_vals", "d_v")
CTXB_TOLERANCE = (
    f"f32: each cotangent within {CTXB_F32_RTOL:g} x its max |value| "
    f"(max_abs_err_f32: the largest |diff| over the four); bf16: within "
    f"{CTXB_BF16_ULPS:g} bf16 ulps past {CTXB_BF16_ATOL_REL:g} x max |value| "
    f"(max_abs_err: the largest bf16 |diff|); rep={CTXB_REP} vs the "
    "gathered layout folded in row order: d_q, d_proj, d_vals bitwise, d_v "
    "within the f32 bound; attention inputs: one video all masked (its "
    "rows get the kernel's non-zero gradient)")


def ctxb_inputs(torch, seed: int):
    """The backward's operands at the training shape: per-video proj /
    vals / mask, 20 query rows per video, att_v, a context cotangent."""
    nv = R_XE // CTXB_REP
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, sc: torch.randn(*s, generator=g) * sc  # noqa: E731
    return dict(q=r(R_XE, A_ATT, sc=0.5), proj=r(nv, F_ATT, A_ATT, sc=0.5),
                mask=att_mask(torch, g, nv), vals=r(nv, F_ATT, E, sc=0.5),
                v=r(A_ATT, 1, sc=0.06), dctx=r(R_XE, E, sc=1.0))


def ctxb_work(R: int, n_videos: int, itemsize: int):
    """(operations, compulsory bytes, tanh count) of one backward call:
    read q, dctx, the float32 weights, att_v and each video's proj / vals
    once; write d_q, d_proj, d_vals, d_v.  Per (row, frame): da and d_vals
    (4E); per (row, frame, column): 9 besides the tanh."""
    flops = R * F_ATT * (4 * E + 9 * A_ATT)
    per_video = n_videos * F_ATT * (A_ATT + E)
    nbytes = ((2 * R * A_ATT + R * E + 2 * per_video + 2 * A_ATT) * itemsize
              + R * F_ATT * 4)
    return flops, nbytes, R * F_ATT * A_ATT


def fold_rows(torch, x, rep: int):
    """Each video's ``rep`` rows of ``x`` summed in row order from zero,
    one float32 add per row rounded to ``x``'s dtype: the backward
    kernel's fold of a video's rows."""
    x = x.reshape(-1, rep, *x.shape[1:])
    acc = torch.zeros_like(x[:, 0], dtype=torch.float32)
    for r in range(rep):
        acc = (acc + x[:, r].float()).to(x.dtype).float()
    return acc.to(x.dtype)


def gathered_bwd(torch, bwd, args, rep: int):
    """The backward on the gathered layout (rep = 1 over the repeated
    tensors), each video's d_proj and d_vals rows then folded in row
    order (``fold_rows``)."""
    q, proj, vals, v, attn, dctx = args
    g = [x.repeat_interleave(rep, dim=0) for x in (proj, vals)]
    dq, dp, dvals, dv = bwd(q, g[0], g[1], v, attn, dctx, rep=1)
    return dq, fold_rows(torch, dp, rep), fold_rows(torch, dvals, rep), dv


def check_context_attention_bwd(torch, ctx_mod):
    """Phase 2g (see module docstring)."""
    fca, bwd = ctx_mod.fused_context_attention, ctx_mod.fused_context_attention_bwd
    bwd_ref = ctx_mod.fused_context_attention_bwd_ref
    a = ctxb_inputs(torch, 41)
    nv, rep = R_XE // CTXB_REP, CTXB_REP
    res = {}
    for tag, cdt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        q, proj, vals, v, dctx = (a[k].to(DEVICE, cdt) for k in
                                  ("q", "proj", "vals", "v", "dctx"))
        mask = a["mask"].to(DEVICE)
        _, attn = fca(q, proj, mask, vals, v, rep=rep, return_attn=True)
        args = (q, proj, vals, v, attn, dctx)
        kb = bwd(*args, rep=rep)
        rb = bwd_ref(*args, rep=rep)
        torch.cuda.synchronize()
        what = f"fused_context_attention_bwd {tag} R={R_XE} rep={rep}"
        rel = {n: max_diff(x, y) / max(float(y.float().abs().max()), 1e-30)
               for n, x, y in zip(CTXB_NAMES, kb, rb)}
        masked_rows = [float(x[:rep].float().abs().max()) for x in (kb[0],
                                                                    rb[0])]
        finite = all(bool(torch.isfinite(x.float()).all()) for x in kb)
        if tag == "f32":
            ok = max(rel.values()) <= CTXB_F32_RTOL
            log(f"{what}: kernel vs plain (of max |value|): " + ", ".join(
                f"{n} {x:.3e}" for n, x in rel.items()))
        else:
            ulps = {n: bf16_ulps(torch, x, y, CTXB_BF16_ATOL_REL)
                    for n, x, y in zip(CTXB_NAMES, kb, rb)}
            raw = {n: bf16_ulps(torch, x, y, 0.0)
                   for n, x, y in zip(CTXB_NAMES, kb, rb)}
            ok = max(ulps.values()) <= CTXB_BF16_ULPS
            res["bf16_ulps"] = ulps
            log(f"{what}: bf16 ulps past {CTXB_BF16_ATOL_REL:g} x max: "
                + ", ".join(f"{n} {x:.2f} ({raw[n]:.2f} without)"
                            for n, x in ulps.items())
                + "; of max |value|: "
                + ", ".join(f"{n} {x:.3e}" for n, x in rel.items()))
        log(f"{what}: all-masked video's rows max |d_q| kernel "
            f"{masked_rows[0]:.3e}, plain {masked_rows[1]:.3e}")
        if not ok or not finite or min(masked_rows) <= 0:
            fail(f"{what} disagrees with its plain version")
        res[f"err_{tag}"] = max(max_diff(x, y) for x, y in zip(kb, rb))
        res[f"rel_{tag}"] = rel
        if tag == "f32":
            gb = gathered_bwd(torch, bwd, args, rep)
            torch.cuda.synchronize()
            grel = {n: max_diff(x, y) / max(float(y.float().abs().max()),
                                             1e-30)
                    for n, x, y in zip(CTXB_NAMES, kb, gb)}
            bitwise = {n: bool(torch.equal(x, y))
                       for n, x, y in zip(CTXB_NAMES[:3], kb, gb)}
            log(f"{what}: rep={rep} vs the gathered layout folded in row "
                "order: bitwise " + ", ".join(
                    f"{n} {b}" for n, b in bitwise.items())
                + "; of max |value|: "
                + ", ".join(f"{n} {x:.3e}" for n, x in grel.items()))
            if not all(bitwise.values()) or not grel["d_v"] <= CTXB_F32_RTOL:
                fail(f"{what}: rep={rep} differs from the gathered layout")
            res["gathered_rel"] = max(grel.values())
            res["gathered_bitwise"] = bitwise
            del gb
        del kb, rb
        res[f"ms_{tag}"] = time_call(torch, lambda: bwd(*args, rep=rep), REPS)
        res[f"device_ms_{tag}"] = device_ms(
            torch, lambda: bwd(*args, rep=rep), REPS, CTXB_LAUNCHES)
        res[f"plain_ms_{tag}"] = time_call(
            torch, lambda: bwd_ref(*args, rep=rep), 1)
        res[f"fwd_ms_{tag}"] = time_call(
            torch, lambda: fca(q, proj, mask, vals, v, rep=rep,
                               return_attn=True), REPS)
        res[f"fwd_device_ms_{tag}"] = device_ms(
            torch, lambda: fca(q, proj, mask, vals, v, rep=rep,
                               return_attn=True), REPS, CTX_LAUNCHES)
        isz = 2 if tag == "bf16" else 4
        res[f"bound_{tag}"] = rec_bound(*ctxb_work(R_XE, nv, isz),
                                        H100_F32_FLOPS)[:2]
        res[f"fwd_bound_{tag}"] = ctx_bound(R_XE, nv, isz, attn_out=True)
        log(f"times {tag}: fused_context_attention_bwd R={R_XE} rep={rep} "
            f"{res[f'ms_{tag}']:.4f} ms by the event clock, "
            f"{res[f'device_ms_{tag}']:.4f} ms device (plain "
            f"{res[f'plain_ms_{tag}']:.4f} ms; bound "
            f"{res[f'bound_{tag}'][0]:.4f} ms, {res[f'bound_{tag}'][1]}; SFU "
            f"floor {sfu_floor_ms(ctxb_work(R_XE, nv, isz)[2]):.4f} ms); the "
            f"forward with weights {res[f'fwd_ms_{tag}']:.4f} ms, "
            f"{res[f'fwd_device_ms_{tag}']:.4f} ms device (bound "
            f"{res[f'fwd_bound_{tag}'][0]:.4f} ms)")
    res["launches_per_call_bf16"] = ctx_launches(
        torch, lambda: bwd(*args, rep=rep), "fused_context_attention_bwd",
        CTXB_LAUNCHES)
    res["edges"] = check_context_bwd_edges(torch, ctx_mod)
    return res


CTXB_EDGE_SHAPES = ((1, CTXB_REP, F_ATT, A_ATT, E), (3, 7, 7, 264, 40),
                    (2, CTXB_REP, F_ATT, A_ATT, E))


def check_context_bwd_edges(torch, ctx_mod):
    """Phase 2g off the main shapes (``CTXB_EDGE_SHAPES``, as 2e's): each
    cotangent at the CTXB_* tiers, and against the gathered layout folded
    in row order (d_q, d_proj, d_vals bitwise; f32 d_v within
    CTXB_F32_RTOL)."""
    fca, bwd = ctx_mod.fused_context_attention, ctx_mod.fused_context_attention_bwd
    bwd_ref = ctx_mod.fused_context_attention_bwd_ref
    out = []
    for i, (nv, rep, F, A, Ee) in enumerate(CTXB_EDGE_SHAPES):
        a = ctx_edge_inputs(torch, 71 + i, nv, rep, F, A, Ee)
        for tag, cdt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            q, proj, vals, v, dctx = (a[k].to(DEVICE, cdt) for k in
                                      ("q", "proj", "vals", "v", "dctx"))
            mask = a["mask"].to(DEVICE)
            _, attn = fca(q, proj, mask, vals, v, rep=rep, return_attn=True)
            args = (q, proj, vals, v, attn, dctx)
            kb = bwd(*args, rep=rep)
            rb = bwd_ref(*args, rep=rep)
            gb = gathered_bwd(torch, bwd, args, rep)
            torch.cuda.synchronize()
            rel = {n: max_diff(x, y) / max(float(y.float().abs().max()), 1e-30)
                   for n, x, y in zip(CTXB_NAMES, kb, rb)}
            if tag == "f32":
                err = max(rel.values())
                ok = err <= CTXB_F32_RTOL
            else:
                err = max(bf16_ulps(torch, x, y, CTXB_BF16_ATOL_REL)
                          for x, y in zip(kb, rb))
                ok = err <= CTXB_BF16_ULPS
            bitwise = all(bool(torch.equal(x, y))
                          for x, y in zip(kb[:3], gb[:3]))
            dv_rel = max_diff(kb[3], gb[3]) / max(
                float(gb[3].float().abs().max()), 1e-30)
            what = (f"fused_context_attention_bwd {tag} {nv} videos x "
                    f"rep={rep}, F={F}, A={A}, E={Ee}")
            log(f"{what}: {'of max |value|' if tag == 'f32' else 'bf16 ulps'}"
                f" {err:.3e}; d_q, d_proj, d_vals bitwise the gathered layout "
                f"folded in row order {bitwise}, d_v {dv_rel:.3e} of max")
            if not ok or not all(bool(torch.isfinite(x.float()).all())
                                 for x in kb):
                fail(f"{what} disagrees with its plain version")
            if not bitwise or (tag == "f32" and dv_rel > CTXB_F32_RTOL):
                fail(f"{what}: rep={rep} differs from the gathered layout")
            out.append(dict(videos=nv, rep=rep, F=F, A=A, E=Ee, dtype=tag,
                            err=err, gathered_dv_rel=dv_rel))
    return out


# ------------------------------------------------------------ phase 2h

# The int8w decoders (the four fused decode kernels with quant=) against
# their plain versions at the msrvtt_serve_beam5 shape, on phase 2 / 2c's
# weights quantized by the port's quantize_params in the model's layout
# (emb per row, w_out per column, one (4H,) scale over the stacked gate
# rows, att_wh per column).  float32 compute: tokens exact, scores /
# log-probs within F32_ATOL; bfloat16 compute at the float kernels' tiers
# (KERNEL_BF16_MATCH_FLOOR meanpool, KERNEL_ATT_BF16_MATCH_FLOOR
# attention, score rtol KERNEL_BF16_SCORE_RTOL); a multi-tile vocab with
# a padded tail (QV_TAIL, not a multiple of the kernels' 128 columns or
# the reference's tile) at float32, no token in the padding.
QV_TAIL = 1_100
Q_TOLERANCE = ("int8 weights with per-channel scales, " + TOLERANCE
               + f"; a V={QV_TAIL} padded tail at f32 exact, no token in "
               "the padding")
Q_ATT_TOLERANCE = ("int8 weights with per-channel scales, "
                   + decode_tolerance(KERNEL_ATT_BF16_MATCH_FLOOR)
                   + f" (seed 0); a V={QV_TAIL} padded tail at f32 exact")
Q_LIBRARY = ("none: no single PyTorch call computes it (cuDNN on "
             "dequantized weights would put the scale inside the sum)")


def quantize_decoder(torch, a, attention: bool):
    """Phase 2's float decoder operands ``a`` with their weights
    quantized by ``quantize_params`` as the model stores them.  Returns
    (operands with int8 codes, the quant tuple), on the CPU."""
    from cst_captioning_torch.ops.quant import quantize_params

    rows = ["w_x", "w_ctx", "wh"] if attention else ["w_x", "wh"]
    tree = {"word_embed": a["emb"], "logit_w": a["w_out"],
            "lstm0_w": torch.cat([a[k] for k in rows])}
    if attention:
        tree["att_wh"] = a["att_wh"]
    q = quantize_params(tree)
    out = dict(a, emb=q["word_embed"], w_out=q["logit_w"])
    r = 0
    for k in rows:
        out[k] = q["lstm0_w"][r: r + a[k].shape[0]]
        r += a[k].shape[0]
    quant = (q["word_embed_scale"], q["logit_w_scale"], q["lstm0_w_scale"])
    if attention:
        out["att_wh"] = q["att_wh"]
        quant += (q["att_wh_scale"],)
    return out, quant


def q_to_card(torch, qa, quant, cdt):
    """int8 codes and float32 scales to the card as they are; the float
    attention operands in ``cdt``; gx_static, b_out and att_mask f32."""
    out = {}
    for k, v in qa.items():
        if v.dtype == torch.int8 or k in ("gx_static", "b_out", "att_mask"):
            out[k] = v.to(DEVICE).contiguous()
        else:
            out[k] = v.to(DEVICE, cdt).contiguous()
    return list(out.values()), tuple(x.to(DEVICE) for x in quant)


def q_decoders(beam_mod, sam_mod, attention: bool, quant, cdt):
    """``decoders`` bound to the int8w mode: each call passes ``quant``
    and the compute dtype; the names gain ``_q``."""
    def bind(fn):
        def call(*args, **kw):
            return fn(*args, quant=quant, compute_dtype=cdt, **kw)
        call.__name__ = fn.__name__ + "_q"
        return call

    return tuple(bind(f) for f in decoders(beam_mod, sam_mod, attention))


def check_quant_decoders(torch, beam_mod, sam_mod, attention: bool):
    """Phase 2h for one fusion (see the module docstring)."""
    from cst_captioning_torch.decoding.beam import finalize_beams

    fusion = "attention" if attention else "meanpool"
    base = make_att_inputs(torch, 0) if attention else make_inputs(torch, 0)
    qa, quant = quantize_decoder(torch, base, attention)
    floor = (KERNEL_ATT_BF16_MATCH_FLOOR if attention
             else KERNEL_BF16_MATCH_FLOOR)
    res = {}
    v32, q32 = q_to_card(torch, qa, quant, torch.float32)
    f32_fns = q_decoders(beam_mod, sam_mod, attention, q32, torch.float32)
    res["beam_f32_err"], res["sample_f32_err"], _ = hold_f32(
        torch, f32_fns, v32, f"int8w {fusion} main shape", k=K, t=T)

    # the padded-tail vocab: the first QV_TAIL words of the same model
    tail = dict(qa)
    tail["emb"], tail["b_out"] = qa["emb"][:QV_TAIL], qa["b_out"][:QV_TAIL]
    tail["w_out"] = qa["w_out"][:, :QV_TAIL].contiguous()
    tq = (quant[0][:QV_TAIL], quant[1][:QV_TAIL]) + quant[2:]
    vt, qt = q_to_card(torch, tail, tq, torch.float32)
    fns_t = q_decoders(beam_mod, sam_mod, attention, qt, torch.float32)
    _, _, seqs = hold_f32(torch, fns_t, vt, f"int8w {fusion} V={QV_TAIL}",
                          k=K, t=T)
    greedy = fns_t[2](*vt, (0, 0), max_len=T, greedy=True)[0]
    top = max(int(seqs.max()), int(greedy.max()))
    log(f"int8w {fusion} V={QV_TAIL}: largest token id {top}")
    if top >= QV_TAIL:
        fail(f"int8w {fusion}: a token in the padded vocab tail")

    v16, q16 = q_to_card(torch, qa, quant, torch.bfloat16)
    beam, beam_ref, sample, sample_ref = q_decoders(
        beam_mod, sam_mod, attention, q16, torch.bfloat16)
    kb = finalize_beams(*beam(*v16, beam_size=K, max_len=T))
    rb = finalize_beams(*beam_ref(*v16, beam_size=K, max_len=T))
    res["beam_bf16_err"] = bf16_check(
        f"{beam.__name__} bf16", kb.tokens, rb.tokens, kb.score, rb.score,
        floor)
    res["sample_bf16_err"] = 0.0
    for greedy, seed in ((True, (0, 0)), (False, (123, 456))):
        kt, kl, _ = sample(*v16, seed, max_len=T, greedy=greedy)
        rt, rl, _ = sample_ref(*v16, seed, max_len=T, greedy=greedy)
        mode = "greedy" if greedy else "multinomial"
        res["sample_bf16_err"] = max(res["sample_bf16_err"], bf16_check(
            f"{sample.__name__} bf16 {mode}", kt, rt, kl.sum(-1),
            rl.sum(-1), floor))
    for tag, args, fns in (("bf16", v16, (beam, beam_ref, sample,
                                          sample_ref)),
                           ("f32", v32, f32_fns)):
        b_k, b_r, s_k, s_r = fns
        res[f"beam_ms_{tag}"] = time_call(
            torch, lambda: b_k(*args, beam_size=K, max_len=T), REPS)
        res[f"beam_plain_ms_{tag}"] = time_call(
            torch, lambda: b_r(*args, beam_size=K, max_len=T), 1)
        res[f"sample_ms_{tag}"] = time_call(
            torch, lambda: s_k(*args, (0, 0), max_len=T, greedy=True), REPS)
        res[f"sample_plain_ms_{tag}"] = time_call(
            torch, lambda: s_r(*args, (0, 0), max_len=T, greedy=True), 1)
        log(f"times {tag}: {b_k.__name__} {res[f'beam_ms_{tag}']:.3f} ms "
            f"(plain {res[f'beam_plain_ms_{tag}']:.3f} ms), {s_k.__name__} "
            f"greedy {res[f'sample_ms_{tag}']:.3f} ms (plain "
            f"{res[f'sample_plain_ms_{tag}']:.3f} ms)")
    res["launches_per_call_bf16"] = decode_breakdowns(
        torch, beam, sample, v16,
        ATT_DEC_LAUNCHES if attention else MEANPOOL_DEC_LAUNCHES)
    return res


def q_decode_work(rows: int, attention: bool, out_bytes: int):
    """FLOPs and compulsory bytes of one bf16-compute int8w decode call:
    the float call's operations; the weights as int8 codes plus their
    float32 scales."""
    if attention:
        flops, nbytes, _ = att_decode_work(rows, 2, out_bytes)
        w = E * 4 * H + H * A_ATT
        nbytes += A_ATT * 4 - w                   # 2 bytes -> 1, + scale
    else:
        flops, nbytes = decode_work(rows, 2, out_bytes)
    w = (E + H) * 4 * H + V * E + H * V
    nbytes -= w                                   # 2 bytes -> 1 a weight
    nbytes += (4 * H + 2 * V) * 4                 # the scales
    return flops, nbytes


# ------------------------------------------------------------ phase 2i

# The int8w recurrences against their plain versions at the XE shape (R
# = 1280, T = 29; attention F = 56, A = E = 512), on phase 2b / 2d's
# inputs with the weights quantized as the model stores them: float32
# h_seq within the 2b / 2d bound (REC_F32_ATOL); bfloat16 h_seq within
# REC_BF16_H_ATOL and QREC_BF16_ULPS bf16 ulps past ATT_BWD_BF16_ATOL_REL
# x max |h| (2d's measure).
QREC_BF16_ULPS = 2.0
QREC_TOLERANCE = (f"int8 weights with per-channel scales; f32: |h diff| <= "
                  f"{REC_F32_ATOL:g} (max_abs_err_f32); bf16: |h diff| <= "
                  f"{REC_BF16_H_ATOL:g} (max_abs_err) and within "
                  f"{QREC_BF16_ULPS:g} bf16 ulps past "
                  f"{ATT_BWD_BF16_ATOL_REL:g} x max |h|")


def q_rec_work(R: int, T: int, attention: bool):
    """(FLOPs, compulsory bytes, tanh count) of one bf16-compute int8w
    recurrence call: read gx, the int8 codes and their scales (and the
    per-video attention tensors), write h_seq; no residuals."""
    if attention:
        (flops, _, tanh), _ = att_rec_work(R, T, 2, ATT_REP)
        w = H * 4 * H + E * 4 * H + H * A_ATT
        nv = R // ATT_REP
        att_in = nv * F_ATT * (A_ATT + E) * 2 + nv * F_ATT * 4 + A_ATT * 2
        nbytes = (R * T * 4 * H * 4 + w + (4 * H + A_ATT) * 4 + att_in
                  + R * T * H * 2)
        return flops, nbytes, tanh
    flops = 2 * R * H * 4 * H * T
    return (flops, R * T * 4 * H * 4 + H * 4 * H + 4 * H * 4 + R * T * H * 2,
            0)


def hold_quant_rec(torch, what: str, kh, rh, res, tag: str):
    err = max_diff(kh, rh)
    if tag == "f32":
        ok = err <= REC_F32_ATOL
        log(f"{what} f32: max |h diff| {err:.3e}")
    else:
        ulps = bf16_ulps(torch, kh, rh, ATT_BWD_BF16_ATOL_REL)
        ok = err <= REC_BF16_H_ATOL and ulps <= QREC_BF16_ULPS
        res["bf16_ulps"] = ulps
        log(f"{what} bf16: max |h diff| {err:.3e}, {ulps:.2f} bf16 ulps past "
            f"{ATT_BWD_BF16_ATOL_REL:g} x max |h| (share of h differing "
            f"{float((kh != rh).float().mean()):.2e})")
    if not ok or not bool(torch.isfinite(kh.float()).all()):
        fail(f"{what} {tag} disagrees with its plain version")
    res[f"{tag}_err"] = err


def check_quant_recurrences(torch, lstm_mod, att_mod):
    """Phase 2i (see the module docstring)."""
    from cst_captioning_torch.ops.quant import quantize_per_channel

    out = {"lstm": {}, "att": {}}
    gx, wh, _ = rec_inputs(torch, 11, R_XE, T_XE)
    wq, ws = (x.to(DEVICE) for x in quantize_per_channel(wh.cpu(), 1))
    k_fn, r_fn = lstm_mod.lstm_recurrence_quant, lstm_mod.lstm_recurrence_quant_ref
    res = out["lstm"]
    for tag, cdt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        kh = k_fn(gx, wq, ws, cdt)
        rh = r_fn(gx, wq, ws, cdt)
        torch.cuda.synchronize()
        hold_quant_rec(torch, f"lstm_recurrence_q R={R_XE} T={T_XE}", kh, rh,
                       res, tag)
        res[f"ms_{tag}"] = time_call(torch, lambda: k_fn(gx, wq, ws, cdt),
                                     REPS)
        res[f"plain_ms_{tag}"] = time_call(
            torch, lambda: r_fn(gx, wq, ws, cdt), 1)
        log(f"times {tag}: lstm_recurrence_q {res[f'ms_{tag}']:.3f} ms "
            f"(plain {res[f'plain_ms_{tag}']:.3f} ms)")

    a32, _ = att_rec_inputs(torch, 21, R_XE, T_XE)
    gxa, wha, wctx, awh, av, proj, mask, vals = a32
    rows = att_rows(a32, ATT_REP)
    lq, ls = quantize_per_channel(torch.cat([wctx, wha]).cpu(), 1)
    lq = lq.to(DEVICE)
    wctx_q, wh_q = lq[:E], lq[E:]
    awh_q, asc = (x.to(DEVICE) for x in quantize_per_channel(awh.cpu(), 1))
    ls = ls.to(DEVICE)
    k_fn, r_fn = att_mod.attlstm_recurrence_quant, att_mod.attlstm_recurrence_quant_ref
    res = out["att"]
    for tag, cdt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        args = (gxa, wh_q, wctx_q, ls, awh_q, asc, av.to(cdt), proj.to(cdt),
                mask, vals.to(cdt), cdt)
        gathered = args[:7] + (rows[5].to(cdt), rows[6], rows[7].to(cdt), cdt)
        kh = k_fn(*args, rep=ATT_REP)
        rh = r_fn(*args, rep=ATT_REP)
        same = bool(torch.equal(kh, k_fn(*gathered, rep=1)))
        torch.cuda.synchronize()
        hold_quant_rec(torch, f"attlstm_recurrence_q R={R_XE} "
                       f"(rep={ATT_REP}) T={T_XE} F={F_ATT}", kh, rh, res, tag)
        log(f"attlstm_recurrence_q {tag}: rep={ATT_REP} vs rep=1 on the "
            f"repeated tensors bitwise: {same}")
        if not same:
            fail(f"attlstm_recurrence_q {tag} at rep={ATT_REP} differs from "
                 "rep=1 on the repeated tensors")
        res[f"ms_{tag}"] = time_call(torch, lambda: k_fn(*args, rep=ATT_REP),
                                     REPS)
        res[f"plain_ms_{tag}"] = time_call(
            torch, lambda: r_fn(*args, rep=ATT_REP), 1)
        log(f"times {tag}: attlstm_recurrence_q {res[f'ms_{tag}']:.3f} ms "
            f"(plain {res[f'plain_ms_{tag}']:.3f} ms)")
        if tag == "bf16":
            for kname, ms, count in kernel_breakdown(
                    torch, lambda: k_fn(*args, rep=ATT_REP)):
                log(f"breakdown bf16 attlstm_recurrence_q: {kname} {ms:.3f} "
                    f"ms over {count} launches")
    return out


# ------------------------------------------------------------ phase 3

def post(url: str, payload) -> dict:
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read())


def serve_mode(torch, mode: str, params, vocab, counter_fn, reset_fn,
               fusion: str, extra=()):
    """Boot the ladder server in ``mode`` with ``fusion`` (and the CLI
    flags ``extra``), POST concurrent requests, return (launches,
    responses, metrics text, stats, wall seconds, engine description)."""
    from cst_captioning_torch.config import parse_cli
    from cst_captioning_torch.serving.engine import InferenceEngine
    from cst_captioning_torch.serving.server import CaptionServer

    cfg = parse_cli([
        "--preset", "msrvtt_serve_beam5", "--serving.continuous", "false",
        "--serving.port", "0", "--serving.decode_mode", mode,
        "--model.feature_fusion", fusion, *extra,
    ])
    engine = InferenceEngine(cfg, params=params, vocab=vocab, device=DEVICE)
    server = CaptionServer(engine).start()
    desc = engine.describe()
    try:
        g = torch.Generator().manual_seed(7)
        payloads = []
        for _ in range(N_REQUESTS):
            feats = {
                m: (torch.randn(cfg.data.max_frames, cfg.data.feature_dims[m],
                                generator=g)).tolist()
                for m in cfg.data.feature_modalities
            }
            payloads.append({"features": feats})
        reset_fn()
        out = [None] * N_REQUESTS
        errs = []

        def worker(i):
            try:
                out[i] = post(server.url + "/v1/caption", payloads[i])
            except Exception as e:  # noqa: BLE001 — reported below
                errs.append(f"{type(e).__name__}: {e}")

        ths = [threading.Thread(target=worker, args=(i,))
               for i in range(N_REQUESTS)]
        t0 = time.perf_counter()
        for t in ths:
            t.start()
        for t in ths:
            t.join()
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = counter_fn()
        if errs:
            fail(f"{mode} requests failed: {errs[:3]}")
        with urllib.request.urlopen(server.url + "/metrics", timeout=60) as r:
            metrics = r.read().decode()
        with urllib.request.urlopen(server.url + "/stats", timeout=60) as r:
            stats = json.loads(r.read())
    finally:
        server.shutdown()
    return launches, out, metrics, stats, wall, desc


def check_engine(torch, kernels, fusion: str, dtype: str = "f32"):
    """Phase 3 (meanpool) / 3b (attention), and 3d's ladder runs at
    ``serving.dtype`` int8w: ``kernels`` maps each decode mode to the
    wrapper whose launches it must count (its ``launches``, or under
    int8w its ``quant_launches``)."""
    from cst_captioning_torch.config import get_preset
    from cst_captioning_torch.data.vocab import Vocabulary
    from cst_captioning_torch.models.captioner import model_from_config

    vocab = Vocabulary([f"w{i}" for i in range(V - 4)])
    cfg = get_preset("msrvtt_serve_beam5")
    cfg.model.vocab_size = len(vocab)
    cfg.model.feature_fusion = fusion
    model = model_from_config(cfg, device="cpu")
    model.init_weights(torch.Generator().manual_seed(cfg.train.seed))
    params = {k: v.clone() for k, v in model.state_dict().items()}
    res = {}
    attr = "quant_launches" if dtype == "int8w" else "launches"
    for mode, fn in kernels.items():
        def reset(fn=fn):
            setattr(fn, attr, 0)

        launches, out, metrics, stats, wall, desc = serve_mode(
            torch, mode, params, vocab, lambda fn=fn: getattr(fn, attr),
            reset, fusion, extra=("--serving.dtype", dtype))
        if desc["serving_dtype"] != dtype:
            fail(f"{fusion} {mode}: the engine serves {desc['serving_dtype']}"
                 f", not {dtype}")
        for r in out:
            if not isinstance(r, dict) or not isinstance(r.get("caption"), str):
                fail(f"{mode}: bad response {str(r)[:200]}")
            toks = r["tokens"]
            if len(toks) != cfg.eval.max_decode_len or not all(
                    0 <= t < V for t in toks):
                fail(f"{mode}: bad tokens {toks[:10]}")
        for fam in ("caption_latency_queue_ms_bucket",
                    "caption_latency_device_ms_bucket",
                    "caption_requests_served_total"):
            if fam not in metrics:
                fail(f"{mode}: /metrics lacks {fam}")
        if launches < 1:
            fail(f"{fusion} {mode} {dtype}: {fn.__name__} ({attr}) was not "
                 "launched on the serving path")
        lat = stats["latency_ms"]
        log(f"serve {fusion} {mode} {dtype}: {N_REQUESTS} requests in "
            f"{wall:.3f} s, batches {stats['batches']}, {fn.__name__} "
            f"{attr} {launches}, "
            f"device p50 {lat['device']['p50_ms']} ms, total p50 "
            f"{lat['total']['p50_ms']} ms")
        log(f"serve {fusion} {mode}: first caption "
            f"{out[0]['caption'][:80]!r}")
        res[mode] = launches
    return res


# ------------------------------------------------------------ phase 3c

N_BURST, N_STAGGER = 96, 32   # requests per run: a burst, then arrivals
STAGGER_S = 0.02              # between staggered arrivals
BREAKDOWN_TICKS = 10
# bf16 served captions vs the ladder's fused kernels.  The two paths
# add the same products in other orders, and bf16 rounds h and the
# query every step, so a last-bit f32 difference can flip a rounding
# and, over 30 fed-back steps, a caption.  On a random-init model the
# logits carry no margins: the first H100 run read 0.4062 served vs
# ladder (meanpool beam), and a CPU run of the same model found each
# path's bf16 captions matching its own f32 captions on only 0.19-0.78
# of requests.  So the relaxed-serving floor (0.75) is held where the
# ladder kernel's own bf16-vs-f32 match allows it, else that witness
# less this margin (about two standard errors of a share over 128
# requests).
SERVE_WITNESS_MARGIN = 0.1
# f32 served captions vs the ladder's fused kernels: the two are
# independent code (the per-step products and context kernel vs the
# whole-decode kernel, each held to its plain version) that compute the
# same function and differ only in summation order.  Held at no more
# than SERVE_LADDER_F32_SLACK differing captions, or, if more, no more
# than summation order alone moves (the offline per-step decode vs
# itself on the model with its hidden units permuted,
# ``permuted_model``); score rtol over the matches <= SERVE_LADDER_F32_RTOL.
SERVE_LADDER_F32_SLACK = 2
SERVE_LADDER_F32_RTOL = 1e-6


def make_bodies(np, cfg, n: int, seed: int):
    """``n`` requests at MSR-VTT widths: per modality a random frame
    count in [1, max_frames] (masked tails) of standard normal features
    rounded to 3 decimals.  Returns (payloads with float32 arrays, the
    JSON bodies); the server parses the bodies to the same float32."""
    rng = np.random.RandomState(seed)
    payloads, bodies = [], []
    for _ in range(n):
        raw = draw_features(np, rng, cfg)
        payloads.append({"features": {m: a.astype(np.float32)
                                      for m, a in raw.items()}})
        bodies.append(json.dumps({"features": {
            m: a.tolist() for m, a in raw.items()}}).encode())
    return payloads, bodies


def draw_features(np, rng, cfg) -> dict:
    """One request's features from ``rng`` (see ``make_bodies``)."""
    raw = {}
    for m in cfg.data.feature_modalities:
        nf = int(rng.randint(1, cfg.data.max_frames + 1))
        raw[m] = np.round(rng.standard_normal(
            (nf, cfg.data.feature_dims[m])), 3)
    return raw


def post_body(url: str, body: bytes) -> dict:
    req = urllib.request.Request(
        url, data=body, headers={"Content-Type": "application/json"},
        method="POST")
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read())


def continuous_cfg(mode: str, fusion: str, f32: bool, dtype: str = "f32",
                   *extra):
    from cst_captioning_torch.config import parse_cli

    argv = ["--preset", "msrvtt_serve_beam5", "--serving.port", "0",
            "--serving.decode_mode", mode, "--model.feature_fusion", fusion,
            "--serving.dtype", dtype, *extra]
    if f32:
        argv += ["--model.compute_dtype", "float32"]
    return parse_cli(argv)


def scheduler_decoders(server):
    """The slot decoders a server's scheduler drives: every replica's
    under the ``ReplicaSet``, else the engine's own."""
    reps = getattr(server.batcher, "replicas", None)
    if reps is not None:
        return [r.decoder for r in reps]
    return [server.engine.slot_decoder()]


def get_json(url: str):
    with urllib.request.urlopen(url, timeout=120) as r:
        return json.loads(r.read())


def serve_continuous(torch, cfg, params, vocab, bodies, order, counted,
                     prep=None, during=None, stagger=True):
    """Boot the continuous server of ``cfg`` (the ``ReplicaSet`` with the
    preset's defaults, ``ContinuousBatcher`` with ``replicas = 1``), send
    ``bodies`` in ``order`` (a burst of N_BURST, then N_STAGGER arrivals
    STAGGER_S apart; with ``stagger`` false all at once), with every
    count in ``counted`` zeroed just before (its ``quant_launches`` too,
    where it has one: read as ``<name>_quant``).  ``prep(engine)`` runs
    before the server is built; ``during(server)`` once the first
    requests are sent, its result returned as ``during``.  Returns the
    run's readings (decode steps and admitting ticks summed over the
    scheduler's decoders; per-request client latency) and the engine."""
    from cst_captioning_torch.serving.engine import InferenceEngine
    from cst_captioning_torch.serving.server import CaptionServer

    engine = InferenceEngine(cfg, params=params, vocab=vocab, device=DEVICE)
    if prep is not None:
        prep(engine)
    if not cfg.serving.continuous:
        fail("msrvtt_serve_beam5 no longer defaults to the slot loop")
    server = CaptionServer(engine).start()
    decs = scheduler_decoders(server)
    out, lat, errs = {}, {}, []
    burst = N_BURST if stagger else len(order)

    def worker(i):
        t0 = time.perf_counter()
        try:
            out[i] = post_body(server.url + "/v1/caption", bodies[i])
            lat[i] = time.perf_counter() - t0
        except Exception as e:  # noqa: BLE001 — reported below
            errs.append(f"{type(e).__name__}: {e}")

    try:
        torch.cuda.synchronize()
        for fn in counted:
            fn.launches = 0
            if hasattr(fn, "quant_launches"):
                fn.quant_launches = 0
        steps0 = [d.steps_run for d in decs]
        admits0 = [d.admit_ticks for d in decs]
        t0 = time.perf_counter()
        ths = [threading.Thread(target=worker, args=(i,))
               for i in order[:burst]]
        for t in ths:
            t.start()
        extra = during(server) if during is not None else None
        for i in order[burst:]:
            time.sleep(STAGGER_S)
            ths.append(threading.Thread(target=worker, args=(i,)))
            ths[-1].start()
        for t in ths:
            t.join()
        wall = time.perf_counter() - t0

        def reading():
            got = {fn.__name__: fn.launches for fn in counted}
            got.update({fn.__name__ + "_quant": fn.quant_launches
                        for fn in counted if hasattr(fn, "quant_launches")})
            return (got, sum(d.steps_run - s0 for d, s0 in zip(decs, steps0)),
                    sum(d.admit_ticks - a0 for d, a0 in zip(decs, admits0)))

        # Read once the scheduler is idle and the readings stand still: a
        # hedged request's losing copy may still be decoding, and a
        # /debug/profile window may still be open.
        t1, last = time.perf_counter(), None
        while True:
            torch.cuda.synchronize()
            now = reading()
            idle = (server.batcher.depth == 0 and not server._http._profiling
                    and not any(d.occupied for d in decs))
            if (idle and now == last) or time.perf_counter() - t1 > 120:
                break
            last = now
            time.sleep(0.05)
        launches, steps, admits = now
        with urllib.request.urlopen(server.url + "/metrics", timeout=60) as r:
            metrics = r.read().decode()
        stats = get_json(server.url + "/stats")
        trace = get_json(server.url + "/debug/trace")
        flight = get_json(server.url + "/debug/flight")
        health = get_json(server.url + "/healthz")
        scheduler = type(server.batcher).__name__
    finally:
        server.shutdown()
    if errs:
        fail(f"continuous requests failed: {errs[:3]}")
    return dict(out=out, launches=launches, steps=steps, admits=admits,
                wall=wall, lat=lat, metrics=metrics, stats=stats,
                trace=trace, flight=flight, health=health,
                scheduler=scheduler, during=extra,
                replicas=len(decs)), engine


def permuted_model(torch, model, seed: int):
    """A copy of ``model`` with its hidden units reordered (the same
    permutation in every layer): every output is the same in exact
    arithmetic, but the sums over H (gates, query, vocab logits) run in
    another order."""
    import copy

    m = copy.deepcopy(model)
    m._kw_key = None    # the copy's weight versions restart
    Hm, E2 = m.rnn_size, m.in_dim
    perm = torch.randperm(Hm, generator=torch.Generator().manual_seed(seed))
    perm = perm.to(m.device)
    cols = torch.cat([perm + j * Hm for j in range(4)])
    with torch.no_grad():
        for layer in range(m.num_layers):
            w_l = getattr(m, f"lstm{layer}_w")
            b_l = getattr(m, f"lstm{layer}_b")
            w = w_l[:, cols].clone()
            if layer == 0:
                w[E2:] = w[E2:][perm]
            else:   # rows [h of the layer below | hidden]
                w[:Hm] = w[:Hm][perm]
                w[Hm:] = w[Hm:][perm]
            w_l.copy_(w)
            b_l.copy_(b_l[cols].clone())
        m.logit_w.copy_(m.logit_w[perm].clone())
        if m.fusion == "attention":
            m.att_wh.copy_(m.att_wh[perm].clone())
    return m


def offline_decodes(torch, engine, payloads, witness: bool = False):
    """The same requests decoded offline, as one batch: the per-step
    decode (``beam_search_from_state`` / ``_sample_from_cache``) and the
    ladder's fused kernel (``beam_search`` / ``sample``, in chunks of the
    ladder top); with ``witness``, the per-step decode again on the
    model with its hidden units permuted ("per_step_permuted").  Returns
    {name: (tokens (n, L), scores (n,) or None)}."""
    from cst_captioning_torch.decoding.beam import (
        beam_search,
        beam_search_from_state,
    )

    m, ev = engine.model, engine.cfg.eval
    reqs = [engine.prepare(p) for p in payloads]
    feats, masks = engine._assemble(reqs, len(reqs))
    cat = engine._categories(reqs, len(reqs))
    state, cache = m.init_decode(feats, masks, cat)
    kw = dict(max_len=ev.max_decode_len)
    out = {}
    if witness:
        mp = permuted_model(torch, m, seed=5)
        if engine.decode_mode == "beam":
            r = beam_search_from_state(
                mp, *mp.init_decode(feats, masks, cat),
                beam_size=ev.beam_size,
                length_normalize=ev.length_normalize, **kw)
            out["per_step_permuted"] = (r.tokens, r.score)
        else:
            out["per_step_permuted"] = (mp._sample_from_cache(
                *mp.init_decode(feats, masks, cat), **kw).tokens, None)
        del mp

    def chunk(i):
        j = i + engine.max_batch
        return ({k: v[i: j] for k, v in feats.items()},
                {k: v[i: j] for k, v in masks.items()},
                None if cat is None else cat[i: j])

    if engine.decode_mode == "beam":
        r = beam_search_from_state(m, state, cache, beam_size=ev.beam_size,
                                   length_normalize=ev.length_normalize, **kw)
        out["per_step"] = (r.tokens, r.score)
        toks, scores = [], []
        for i in range(0, len(reqs), engine.max_batch):
            r = beam_search(m, *chunk(i), beam_size=ev.beam_size,
                            length_normalize=ev.length_normalize, **kw)
            toks.append(r.tokens)
            scores.append(r.score)
        out["ladder"] = (torch.cat(toks), torch.cat(scores))
        return out
    out["per_step"] = (m._sample_from_cache(state, cache, **kw).tokens, None)
    toks = []
    for i in range(0, len(reqs), engine.max_batch):
        toks.append(m.sample(*chunk(i), greedy=True, **kw).tokens)
    out["ladder"] = (torch.cat(toks), None)
    return out


def token_match(a, b) -> float:
    """Share of rows of ``a`` and ``b`` ((n, L) token ids) that agree."""
    return float((a.cpu() == b.cpu()).all(-1).float().mean())


def caption_match(served, tokens, scores):
    """(share of requests whose served tokens equal ``tokens``, max score
    rtol over the matches or None, max |score diff| over the matches)."""
    tok = tokens.cpu().numpy()
    same = [served[i]["tokens"] == [int(t) for t in tok[i]]
            for i in range(len(tok))]
    share = sum(same) / len(same)
    if scores is None or not any(same):
        return share, None, None
    sc = scores.float().cpu().numpy()
    gaps = [abs(served[i]["score"] - float(sc[i])) for i in range(len(sc))
            if same[i]]
    rtol = max(g / max(abs(float(sc[i])), 1e-6)
               for g, i in zip(gaps, [i for i in range(len(sc)) if same[i]]))
    return share, rtol, max(gaps)


def front_end_cost(engine, bodies, what: str):
    """The front end's host work per request, one request at a time on
    the scheduler's host: the body's ``json.loads`` (as the server's
    handler does) and ``engine.prepare``.  Under a burst the handler
    threads do this work concurrently with the scheduler thread, in the
    same process."""
    t_json = t_prep = 0.0
    for body in bodies:
        t0 = time.perf_counter()
        payload = json.loads(body)
        t1 = time.perf_counter()
        engine.prepare(payload)
        t_json += t1 - t0
        t_prep += time.perf_counter() - t1
    n = len(bodies)
    out = {"json_ms": t_json * 1e3 / n, "prepare_ms": t_prep * 1e3 / n,
           "body_mb": sum(len(b) for b in bodies) / n / 1e6,
           "serial_s": t_json + t_prep}
    log(f"{what}: front end host work per request (mean over {n}, "
        f"{out['body_mb']:.3f} MB bodies): json.loads {out['json_ms']:.3f} "
        f"ms, engine.prepare {out['prepare_ms']:.3f} ms; all {n} in series "
        f"{out['serial_s']:.3f} s")
    return out


def slot_breakdown(torch, engine, payloads, what: str, card: str):
    """Where one slot-loop step's time goes at the top bank, every slot
    occupied: host clock per tick (each tick ends in the host read of
    the done flags) over BREAKDOWN_TICKS ticks, then the profiler's
    device time by kernel over as many, grouped into the context
    kernel, the row-invariant GEMMs, the selection (top-K), the
    log-softmax and the rest; host gaps are the tick time the device
    spends idle."""
    from torch.profiler import ProfilerActivity, profile

    dec = engine.slot_decoder()
    dec.maybe_resize(dec.S_max)
    n = min(dec.S, dec.admit_cap, len(payloads))
    reqs = [engine.prepare(p) for p in payloads[:n]]
    dec.tick(reqs, list(range(n)))
    for _ in range(2):
        dec.tick()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(BREAKDOWN_TICKS):
        dec.tick()
    tick_ms = (time.perf_counter() - t0) * 1e3 / BREAKDOWN_TICKS
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(WINDOW_PAD_S)
        for _ in range(BREAKDOWN_TICKS):
            dec.tick()
        torch.cuda.synchronize()
        time.sleep(WINDOW_PAD_S)
    groups = {"context kernel": 0.0, "row_gemm (query, gates, vocab)": 0.0,
              "selection (top-K)": 0.0, "log-softmax": 0.0, "other": 0.0}
    for e in prof.key_averages():
        us = (getattr(e, "device_time_total", 0)
              or getattr(e, "cuda_time_total", 0))
        if not us:
            continue
        k = e.key.lower()
        if "ctx_fwd_kernel" in k:
            g = "context kernel"
        elif "row_gemm" in k:
            g = "row_gemm (query, gates, vocab)"
        elif "topk" in k or "sort" in k or "radix" in k or "select" in k:
            g = "selection (top-K)"
        elif "softmax" in k:
            g = "log-softmax"
        else:
            g = "other"
        groups[g] += us / 1e3 / BREAKDOWN_TICKS
    for s in list(dec.occupied):
        dec.evict(s)
    busy = sum(groups.values())
    out = {"rows": n * dec.K, "tick_ms": tick_ms, "device_ms": busy,
           "idle_share": max(0.0, 1.0 - busy / tick_ms), "groups": groups}
    log(f"slot step {what} ({n} slots, {n * dec.K} rows): {tick_ms:.3f} ms "
        f"per tick on the host clock, device busy {busy:.3f} ms (idle share "
        f"{out['idle_share']:.3f}): " + ", ".join(
            f"{k} {v:.4f}" for k, v in groups.items()) + f"  [{card}]")
    if busy == 0.0:
        log("slot step breakdown: not measured (the profiler recorded no "
            "device time)")
    return out


def check_continuous(torch, card: str, fusion: str, counted):
    """Phase 3c for one fusion, beam and greedy: see the module
    docstring.  ``counted`` is the kernel wrappers whose launches each
    run reads: [fused_context_attention, row_dot]."""
    import numpy as np

    from cst_captioning_torch.config import get_preset
    from cst_captioning_torch.data.vocab import Vocabulary
    from cst_captioning_torch.models.captioner import model_from_config

    vocab = Vocabulary([f"w{i}" for i in range(V - 4)])
    base = get_preset("msrvtt_serve_beam5")
    base.model.vocab_size = len(vocab)
    base.model.feature_fusion = fusion
    model = model_from_config(base, device="cpu")
    model.init_weights(torch.Generator().manual_seed(base.train.seed))
    params = {k: v.clone() for k, v in model.state_dict().items()}
    payloads, bodies = make_bodies(np, base, N_BURST + N_STAGGER, seed=17)
    n = len(bodies)
    res = {}
    for mode in ("beam", "greedy"):
        what = f"continuous {fusion} {mode}"
        # The preset's defaults serve through the ReplicaSet (3e); the
        # meanpool beam case is pinned to one engine's ContinuousBatcher.
        pin = (("--serving.replicas", "1")
               if (fusion, mode) == ("meanpool", "beam") else ())
        r16, eng16 = serve_continuous(
            torch, continuous_cfg(mode, fusion, False, "f32", *pin), params,
            vocab, bodies, list(range(n)), counted)
        want_sched = "ContinuousBatcher" if pin else "ReplicaSet"
        if r16["scheduler"] != want_sched:
            fail(f"{what}: served by {r16['scheduler']}, want {want_sched}")
        out = r16["out"]
        L = eng16.cfg.eval.max_decode_len
        for i in range(n):
            o = out.get(i)
            if not isinstance(o, dict) or not isinstance(o.get("caption"), str):
                fail(f"{what}: request {i} bad response {str(o)[:200]}")
            if len(o["tokens"]) != L or not all(0 <= t < V for t in o["tokens"]):
                fail(f"{what}: request {i} bad tokens {o['tokens'][:10]}")
        slots = r16["stats"]["slots"]
        lat = r16["stats"]["latency_ms"]
        ctx_n, rg_n = (r16["launches"][f.__name__] for f in counted)
        want_ctx = r16["steps"] if fusion == "attention" else 0
        log(f"{what} bf16 ({r16['scheduler']}): {n} requests in "
            f"{r16['wall']:.3f} s, "
            f"{r16['steps']} decode steps, bank resizes "
            f"{slots['bank_resizes']}, steps/caption "
            f"{slots['steps_per_caption']}, launches "
            f"fused_context_attention {ctx_n}, row_dot {rg_n}; device p50 "
            f"{lat['device']['p50_ms']} p99 {lat['device']['p99_ms']} ms, "
            f"total p50 {lat['total']['p50_ms']} p99 "
            f"{lat['total']['p99_ms']} ms, admission p50 "
            f"{lat['admission']['p50_ms']} ms  [{card}]")
        if slots["bank_resizes"] < 1:
            fail(f"{what}: the slot bank never resized")
        if ctx_n != want_ctx or rg_n < 1:
            fail(f"{what}: fused_context_attention launched {ctx_n} times "
                 f"for {want_ctx} attention decode steps, row_dot {rg_n}")
        for fam in ("caption_slots_admitted_total", "caption_slot_bank_size",
                    "caption_latency_admission_ms_bucket",
                    "caption_steps_per_caption_bucket"):
            if fam not in r16["metrics"]:
                fail(f"{what}: /metrics lacks {fam}")
        row = res[f"{mode}_bf16"] = {
            "scheduler": r16["scheduler"],
            "launches": r16["launches"], "steps": r16["steps"],
            "wall_s": r16["wall"], "bank_resizes": slots["bank_resizes"],
            "latency_ms": {k: lat[k] for k in ("admission", "device",
                                               "detok", "total")}}
        off16 = offline_decodes(torch, eng16, payloads)
        row["front_end"] = front_end_cost(eng16, bodies, what)
        row["step"] = slot_breakdown(torch, eng16, payloads,
                                     f"{fusion} {mode} bf16", card)
        del eng16

        runs = []
        for order in (list(range(n)), list(range(n))[::-1]):
            r32, eng32 = serve_continuous(
                torch, continuous_cfg(mode, fusion, True, "f32", *pin),
                params, vocab, bodies, order, counted)
            runs.append(r32)
        off32 = offline_decodes(torch, eng32, payloads, witness=True)
        del eng32
        a, b = runs[0]["out"], runs[1]["out"]
        moved = [i for i in range(n) if a[i]["tokens"] != b[i]["tokens"]]
        share, _, gap = caption_match(a, *off32["per_step"])
        lshare, lrtol, _ = caption_match(a, *off32["ladder"])
        l_off = round((1.0 - lshare) * n)
        w_off = round((1.0 - token_match(off32["per_step"][0],
                                         off32["per_step_permuted"][0])) * n)
        l_held = max(SERVE_LADDER_F32_SLACK, w_off)
        log(f"{what} f32: two arrival orders, requests whose tokens differ "
            f"{len(moved)}/{n}; served vs offline per-step decode caption "
            f"match {share:.4f} (max |score diff| {gap}); served vs the "
            f"ladder's fused kernel: captions differing {l_off}/{n} (held "
            f"<= {l_held}; order witness, the per-step decode vs itself "
            f"with hidden units permuted: {w_off}/{n}), score rtol over "
            f"matches {lrtol} (held <= {SERVE_LADDER_F32_RTOL:g})")
        if moved or share != 1.0:
            fail(f"{what} f32: served tokens depend on arrival order or "
                 "differ from the offline per-step decode")
        if l_off > l_held or (lrtol is not None
                              and lrtol > SERVE_LADDER_F32_RTOL):
            fail(f"{what} f32: served captions differ from the ladder's "
                 f"fused kernel on {l_off}/{n} requests (held <= {l_held}) "
                 f"or score rtol {lrtol}")
        res[f"{mode}_f32"] = {"orders_differ": len(moved),
                              "match_per_step": share,
                              "score_gap_per_step": gap,
                              "match_ladder": lshare,
                              "ladder_differ": l_off,
                              "ladder_differ_held": l_held,
                              "order_witness_differ": w_off,
                              "score_rtol_ladder": lrtol,
                              "steps": [x["steps"] for x in runs]}

        # bf16: the served captions against the offline per-step decode
        # (the same arithmetic) at the relaxed-serving tier; against the
        # ladder's fused kernel at that tier where this model allows it:
        # the floor drops to the ladder kernel's own bf16-vs-f32 match
        # less SERVE_WITNESS_MARGIN when bf16 rounding alone moves more
        # captions than the tier allows (see SERVE_WITNESS_MARGIN).
        witness = token_match(off16["ladder"][0], off32["ladder"][0])
        served_vs_f32 = token_match(
            torch.tensor([out[i]["tokens"] for i in range(n)]),
            off32["per_step"][0])
        floor = min(RELAXED_SERVING_MATCH_FLOOR,
                    witness - SERVE_WITNESS_MARGIN)
        for name in ("per_step", "ladder"):
            share, rtol, _ = caption_match(out, *off16[name])
            held = RELAXED_SERVING_MATCH_FLOOR if name == "per_step" else floor
            log(f"{what} bf16 served vs offline {name}: caption match "
                f"{share:.4f} (held >= {held:.4f}), max score rtol over "
                f"matches {rtol}")
            if share < held or (rtol is not None
                                and rtol > RELAXED_SERVING_SCORE_RTOL):
                fail(f"{what} bf16 vs offline {name} outside its tier")
            row[f"match_{name}"] = share
            row[f"score_rtol_{name}"] = rtol
        log(f"{what}: bf16 rounding witness, the ladder kernel's bf16 vs "
            f"f32 captions {witness:.4f}; served bf16 vs served f32 "
            f"{served_vs_f32:.4f}")
        row["ladder_bf16_vs_f32"] = witness
        row["served_bf16_vs_f32"] = served_vs_f32
        res[f"{mode}_int8w"] = check_int8w_continuous(
            torch, card, fusion, mode, params, vocab, payloads, bodies,
            off32, counted)
        if fusion == "meanpool" and mode == "beam":
            res["bf16_knob"] = check_bf16_serving(
                torch, card, params, vocab, bodies, out, counted)
    return res


# ------------------------------------------------------------ phase 3d

# int8w continuous serving (msrvtt_serve_beam5 --serving.dtype int8w, the
# slot loop with the int8 row_gemm): served captions against the same
# engine's offline per-step decode at the relaxed-serving tier (the same
# arithmetic), and against the float engine at f32 compute (phase 3c's
# offline per-step decode) at that tier where this random-init model
# allows it: as for bf16 in 3c, the floor drops to the int8w ladder
# kernel's own captions vs the f32 ladder's less SERVE_WITNESS_MARGIN
# when quantization and bf16 rounding alone move more captions than the
# tier allows.  Then two runs at float32 compute (``f32_compute``) in two
# arrival orders: the same tokens, equal to the offline per-step decode.
# The int8w engine's measured weight bytes must equal the closed form
# (quantized_leaf_bytes plus the float leaves), and its quantized leaves
# come to Q_BYTES_RATIO of their float32 bytes (0.25 plus the scales:
# 0.2517 at MSR-VTT widths).
Q_BYTES_RATIO = (0.25, 0.26)


def check_responses(out, n: int, L: int, what: str):
    for i in range(n):
        o = out.get(i)
        if not isinstance(o, dict) or not isinstance(o.get("caption"), str):
            fail(f"{what}: request {i} bad response {str(o)[:200]}")
        if len(o["tokens"]) != L or not all(0 <= t < V for t in o["tokens"]):
            fail(f"{what}: request {i} bad tokens {o['tokens'][:10]}")


def f32_compute(torch, engine):
    """An int8w engine's model switched to float32 compute (int8 codes,
    float32 activations: the reference's weight_quant model at
    compute_dtype float32), before its slot loop is built.  The serving
    knob always pairs int8w with bf16; this configuration makes the
    arrival-order and offline comparisons exact."""
    engine.model.compute_dtype = torch.float32
    engine.model._kw_key = None
    engine._slot_decoder = None


def expected_param_bytes(model):
    """The int8w engine's weight bytes in closed form: ``quantized_leaf_
    bytes`` for each quantized leaf plus 4 bytes an element for the rest;
    and the quantized leaves' bytes against their float32 bytes."""
    from cst_captioning_torch.ops.quant import (
        SCALE_SUFFIX,
        quant_axis,
        quantized_leaf_bytes,
    )

    total = q_bytes = f_bytes = 0
    for name, p in model.state_dict().items():
        if name.endswith(SCALE_SUFFIX):
            continue
        axis = quant_axis(name)
        if axis is None:
            total += p.numel() * 4
        else:
            codes, scales = quantized_leaf_bytes(tuple(p.shape), axis)
            total += codes + scales
            q_bytes += codes + scales
            f_bytes += p.numel() * 4
    return total, q_bytes / f_bytes


def relaxed_holds(what: str, served, per_step, ladder, f32_per_step,
                  f32_ladder):
    """3d's holds of a low-precision slot run (7a's too): served vs the same
    engine's offline per-step decode at the relaxed-serving tier; served
    vs the f32 engine's per-step decode at that tier where the model
    allows it, else at the ladder kernel's own low-precision-vs-f32
    match less SERVE_WITNESS_MARGIN.  Returns the readings."""
    share, rtol, _ = caption_match(served, *per_step)
    witness = token_match(ladder, f32_ladder)
    floor = min(RELAXED_SERVING_MATCH_FLOOR, witness - SERVE_WITNESS_MARGIN)
    fshare, frtol, _ = caption_match(served, *f32_per_step)
    log(f"{what}: served vs its offline per-step decode caption match "
        f"{share:.4f} (held >= {RELAXED_SERVING_MATCH_FLOOR}), score rtol "
        f"{rtol}; served vs the f32 engine's per-step decode {fshare:.4f} "
        f"(relaxed-serving floor {RELAXED_SERVING_MATCH_FLOOR}, held >= "
        f"{floor:.4f}; witness, its ladder kernel vs the f32 ladder "
        f"{witness:.4f}), score rtol {frtol}")
    if share < RELAXED_SERVING_MATCH_FLOOR or (
            rtol is not None and rtol > RELAXED_SERVING_SCORE_RTOL):
        fail(f"{what} vs its offline per-step decode outside the tier")
    if fshare < floor or (frtol is not None
                          and frtol > RELAXED_SERVING_SCORE_RTOL):
        fail(f"{what} vs the f32 engine outside its tier")
    return {"match_per_step": share, "score_rtol_per_step": rtol,
            "match_f32": fshare, "match_f32_floor": floor,
            "score_rtol_f32": frtol, "ladder_vs_f32_ladder": witness}


def check_int8w_continuous(torch, card, fusion, mode, params, vocab, payloads,
                           bodies, off32, counted):
    """Phase 3d for one fusion and mode (see above)."""
    n = len(bodies)
    what = f"int8w continuous {fusion} {mode}"
    rq, engq = serve_continuous(
        torch, continuous_cfg(mode, fusion, False, "int8w"), params, vocab,
        bodies, list(range(n)), counted)
    out = rq["out"]
    check_responses(out, n, engq.cfg.eval.max_decode_len, what)
    desc = engq.describe()
    want_bytes, q_ratio = expected_param_bytes(engq.model)
    ctx_n, rg_n = (rq["launches"][f.__name__] for f in counted)
    rq_n = rq["launches"]["row_dot_quant"]
    want_ctx = rq["steps"] if fusion == "attention" else 0
    lat = rq["stats"]["latency_ms"]
    log(f"{what}: {n} requests in {rq['wall']:.3f} s, {rq['steps']} decode "
        f"steps, launches fused_context_attention {ctx_n}, row_dot {rg_n} "
        f"(int8 {rq_n}); serving_dtype {desc['serving_dtype']}, "
        f"param_bytes_per_shard {desc['param_bytes_per_shard']} (closed form "
        f"{want_bytes}; quantized leaves {q_ratio:.4f} of their f32 bytes); "
        f"device p50 {lat['device']['p50_ms']} ms, total p50 "
        f"{lat['total']['p50_ms']} p99 {lat['total']['p99_ms']} ms  [{card}]")
    if desc["serving_dtype"] != "int8w" or \
            desc["param_bytes_per_shard"] != want_bytes or \
            not Q_BYTES_RATIO[0] <= q_ratio <= Q_BYTES_RATIO[1]:
        fail(f"{what}: not an int8w engine, or its weight bytes are off "
             "the closed form")
    if rq_n < 1 or ctx_n != want_ctx:
        fail(f"{what}: row_dot's int8 path launched {rq_n} times, "
             f"fused_context_attention {ctx_n} for {want_ctx} steps")
    row = {"launches": rq["launches"], "steps": rq["steps"],
           "wall_s": rq["wall"], "param_bytes_per_shard":
           desc["param_bytes_per_shard"], "quantized_leaf_ratio": q_ratio,
           "latency_ms": {k: lat[k] for k in ("admission", "device",
                                               "detok", "total")}}
    offq = offline_decodes(torch, engq, payloads)
    del engq
    row.update(relaxed_holds(what, out, offq["per_step"], offq["ladder"][0],
                             off32["per_step"], off32["ladder"][0]))

    runs = []
    for order in (list(range(n)), list(range(n))[::-1]):
        cfg = continuous_cfg(mode, fusion, False, "int8w")
        cfg.serving.warmup = False
        r32, eng32 = serve_continuous(
            torch, cfg, params, vocab, bodies, order, counted,
            prep=lambda e: f32_compute(torch, e))
        runs.append(r32)
    off = offline_decodes(torch, eng32, payloads)
    del eng32
    a, b = runs[0]["out"], runs[1]["out"]
    moved = [i for i in range(n) if a[i]["tokens"] != b[i]["tokens"]]
    share, _, gap = caption_match(a, *off["per_step"])
    log(f"{what} at f32 compute: two arrival orders, requests whose tokens "
        f"differ {len(moved)}/{n}; served vs offline per-step decode "
        f"caption match {share:.4f} (max |score diff| {gap}); int8 row_dot "
        f"launches {[r['launches']['row_dot_quant'] for r in runs]}")
    if moved or share != 1.0 or min(r["launches"]["row_dot_quant"]
                                     for r in runs) < 1:
        fail(f"{what} at f32 compute: served tokens depend on arrival order "
             "or differ from the offline per-step decode")
    row["f32_compute"] = {"orders_differ": len(moved),
                          "match_per_step": share,
                          "score_gap_per_step": gap}
    return row


def check_bf16_serving(torch, card, params, vocab, bodies, bf16_out,
                       counted):
    """Phase 3d's bf16 run: meanpool beam through the slot loop with
    ``--serving.dtype bf16``; the preset already computes in bf16, so the
    served tokens must equal phase 3c's bf16 run's."""
    n = len(bodies)
    what = "bf16 continuous meanpool beam"
    r, eng = serve_continuous(
        torch, continuous_cfg("beam", "meanpool", False, "bf16"), params,
        vocab, bodies, list(range(n)), counted)
    check_responses(r["out"], n, eng.cfg.eval.max_decode_len, what)
    desc = eng.describe()
    same = sum(r["out"][i]["tokens"] == bf16_out[i]["tokens"]
               for i in range(n))
    log(f"{what}: serving_dtype {desc['serving_dtype']}, compute "
        f"{eng.model.compute_dtype}, captions equal to the f32-knob bf16 "
        f"run {same}/{n}, row_dot launches {r['launches']['row_dot']}  "
        f"[{card}]")
    if desc["serving_dtype"] != "bf16" or same != n or \
            eng.model.compute_dtype != torch.bfloat16:
        fail(f"{what}: not the bf16 model, or its tokens moved")
    return {"match_f32_knob_run": same / n, "steps": r["steps"]}


def check_int8w_forward(torch, card, fusion: str, rec_fn, plain_fn):
    """Phase 3d's teacher-forced forward of an int8w model (the reference
    ``__call__`` under weight_quant) at the XE shape, 64 videos x 20
    captions x T_XE steps, random features at MSR-VTT widths: through
    ``rec_fn`` (the int8w recurrence kernel, whose launches are counted)
    at the serving dtype's bf16 compute; then at float32 compute kernel
    vs plain recurrence (``plain_fn`` swapped into the model), logits
    within REC_F32_ATOL."""
    from cst_captioning_torch.config import get_preset
    from cst_captioning_torch.models import captioner
    from cst_captioning_torch.models.captioner import model_from_config
    from cst_captioning_torch.models.weights import load_params
    from cst_captioning_torch.ops.quant import quantize_params

    cfg = get_preset("msrvtt_serve_beam5")
    cfg.model.vocab_size = V
    cfg.model.feature_fusion = fusion
    fm = model_from_config(cfg, device="cpu")
    fm.init_weights(torch.Generator().manual_seed(cfg.train.seed))
    model = model_from_config(cfg, serving_dtype="int8w", device="cpu")
    load_params(model, quantize_params(fm.state_dict()))
    model = model.to(DEVICE).requires_grad_(False)
    g = torch.Generator().manual_seed(29)
    nv, rep = R_XE // 20, 20
    feats = {m: torch.randn(nv, cfg.data.max_frames, cfg.data.feature_dims[m],
                            generator=g).to(DEVICE)
             for m in cfg.data.feature_modalities}
    masks = {m: att_mask(torch, g, nv, DEVICE)[:, :cfg.data.max_frames]
             for m in cfg.data.feature_modalities}
    ids = torch.randint(4, V, (R_XE, T_XE), generator=g).to(DEVICE)
    ids[:, 0] = 1
    name = rec_fn.__name__
    with torch.no_grad():
        torch.cuda.synchronize()
        rec_fn.launches = 0
        logits = model(feats, masks, ids, repeat=rep)
        torch.cuda.synchronize()
        launches = rec_fn.launches
        finite = bool(torch.isfinite(logits).all())
        shape = tuple(logits.shape)
        del logits
        model.compute_dtype = torch.float32
        model._kw_key = None
        k32 = model(feats, masks, ids, repeat=rep)
        setattr(captioner, name, plain_fn)
        try:
            r32 = model(feats, masks, ids, repeat=rep)
        finally:
            setattr(captioner, name, rec_fn)
        torch.cuda.synchronize()
        err = max_diff(k32, r32)
    log(f"int8w teacher-forced forward {fusion} R={R_XE} T={T_XE}: {name} "
        f"launches {launches}, logits {shape} finite {finite}; at f32 "
        f"compute kernel vs plain recurrence max |logit diff| {err:.3e} "
        f"(held <= {REC_F32_ATOL:g})  [{card}]")
    if launches != 1 or not finite or shape != (R_XE, T_XE, V) or \
            not err <= REC_F32_ATOL:
        fail(f"int8w teacher-forced forward {fusion}: launches {launches}, "
             f"finite {finite}, or kernel vs plain {err:.3e}")
    return {"launches": launches, "logit_err_f32": err}


# ------------------------------------------------------------ phase 3e

# The production scheduler: msrvtt_serve_beam5's defaults (replicas = 0:
# one replica per card, double-buffered) serve through the ReplicaSet.
# f32 parity runs per case and scheduler variant (REPLICA_ORDERS);
# the row products of an admitting tick (the encode's projections, plus
# att_proj under attention) and of a decode step (gates and vocab, plus
# the query under attention) are held exactly, summed over replicas.
REPLICA_CASES = (("meanpool", "beam"), ("attention", "greedy"))
REPLICA_VARIANTS = (
    ("one_double_buffered", ()),
    ("one_synchronous", ("--serving.double_buffer", "false")),
    ("two_wrapped", ("--serving.replicas", "2")))
# 3e.a's arrival orders: both for the first variant of each case (the
# preset's defaults), the forward order for the others.
REPLICA_ORDERS = {"one_double_buffered": 2}
ADMIT_RG = {"meanpool": 2, "attention": 3}
STEP_RG = {"meanpool": 2, "attention": 3}
TICK_READ = 20          # ticks per mode in a tick reading
OVERLOAD_SLOTS = 8      # 3e.d: a fixed 8-slot bank ...
OVERLOAD_DEPTH = 8      # ... behind an 8-deep queue
OVERLOAD_N = 48         # requests: half batch, then half interactive
PROFILE_MS = 200
# Every serving span of the catalogue that 3e exercises (batch_decode is
# the ladder's).
REPLICA_SPANS = ("request", "queue", "admit", "decode", "detok",
                 "tick_dispatch", "tick_wait", "harvest", "shed", "hedge",
                 "profile")


def replica_cfg(mode: str, fusion: str, f32: bool, tmp: str, *extra,
                dtype: str = "f32"):
    """``continuous_cfg`` with CLI flags ``extra``, flight dumps and
    profiler windows under ``tmp``."""
    cfg = continuous_cfg(mode, fusion, f32, dtype, *extra)
    cfg.serving.flight_dir = os.path.join(tmp, "flight")
    cfg.serving.profile_dir = os.path.join(tmp, "profiles")
    return cfg


def post_status(url: str, body: bytes):
    """(status, JSON body, headers) of one POST, error statuses too."""
    req = urllib.request.Request(
        url, data=body, headers={"Content-Type": "application/json"},
        method="POST")
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def metric_value(text: str, name: str) -> float:
    """One sample of the Prometheus text (``name`` with its labels)."""
    for line in text.splitlines():
        if line.startswith(name + " "):
            return float(line.split()[-1])
    fail(f"/metrics lacks {name}")


def span_names(trace) -> set:
    from cst_captioning_torch.observability import validate_chrome_trace

    validate_chrome_trace(trace)
    return {e["name"] for e in trace["traceEvents"] if e["ph"] == "X"}


def hold_replica_run(r, fusion: str, what: str, scheduler: str,
                     replicas: int):
    """A 3e run's holds: the scheduler it ran, the launches (exact,
    summed over replicas), ``tick`` events in every replica's flight
    ring, and a trace that parses.  Returns the launches."""
    want = {"row_dot": ADMIT_RG[fusion] * r["admits"]
            + STEP_RG[fusion] * r["steps"],
            "fused_context_attention":
                r["steps"] if fusion == "attention" else 0}
    got = {k: r["launches"][k] for k in want}
    if r["scheduler"] != scheduler or r["replicas"] != replicas:
        fail(f"{what}: served by {r['scheduler']} x {r['replicas']}, want "
             f"{scheduler} x {replicas}")
    if got != want or r["launches"].get("row_dot_quant"):
        fail(f"{what}: launches {r['launches']}, want {want} "
             f"({r['admits']} admitting ticks, {r['steps']} decode steps)")
    rings = r["flight"]["recorders"]
    ticks = {k: sum(e["event"] == "tick" for e in v["events"])
             for k, v in rings.items()}
    if len(ticks) != replicas or not all(ticks.values()):
        fail(f"{what}: /debug/flight tick events per replica {ticks}")
    return dict(got, admits=r["admits"], steps=r["steps"])


def client_latency(r, idx):
    """(captions/s, client p50, p99 ms) of requests ``idx`` of a run."""
    import numpy as np

    lat = np.array([r["lat"][i] for i in idx]) * 1e3
    return (len(idx) / r["wall"], float(np.percentile(lat, 50)),
            float(np.percentile(lat, 99)))


def tick_reading(torch, engine, payloads, what: str, card: str):
    """The tick wall and the card's idle share at a full bank, one
    replica (its own stream), synchronous (``tick``: dispatch, then wait)
    against double-buffered (dispatch tick t+1, then wait on tick t):
    TICK_READ ticks of each on the host clock in the turns S, D, D, S,
    then a profiler window of each for the device's busy time."""
    from torch.profiler import ProfilerActivity, profile

    rep = engine.clone_for_device(DEVICE, replica_id=0)
    dec = rep.slot_decoder()
    dec.maybe_resize(dec.S_max)
    n = min(dec.S, dec.admit_cap, len(payloads))
    dec.tick([rep.prepare(p) for p in payloads[:n]], list(range(n)))
    for _ in range(3):
        dec.tick()

    def sync_ticks():
        for _ in range(TICK_READ):
            dec.tick()

    def buffered_ticks():
        prev = dec.tick_begin()
        for _ in range(TICK_READ - 1):
            h = dec.tick_begin()
            dec.tick_wait(prev)
            prev = h
        dec.tick_wait(prev)

    loops = {"synchronous": sync_ticks, "double_buffered": buffered_ticks}
    walls = {k: [] for k in loops}
    for k in ("synchronous", "double_buffered", "double_buffered",
              "synchronous"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loops[k]()
        walls[k].append((time.perf_counter() - t0) * 1e3 / TICK_READ)
    out = {"rows": n * dec.K, "slots": n}
    for k, fn in loops.items():
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(WINDOW_PAD_S)
            fn()
            torch.cuda.synchronize()
            time.sleep(WINDOW_PAD_S)
        busy = sum((getattr(e, "device_time_total", 0)
                    or getattr(e, "cuda_time_total", 0))
                   for e in prof.key_averages()) / 1e3 / TICK_READ
        tick = min(walls[k])
        out[k] = {"tick_ms": tick, "tick_ms_turns": walls[k],
                  "device_ms": busy,
                  "idle_share": max(0.0, 1.0 - busy / tick) if busy else None}
    for s in list(dec.occupied):
        dec.evict(s)
    log(f"3e.f tick {what} ({n} slots, {n * dec.K} rows, one replica on "
        f"its stream): synchronous {out['synchronous']['tick_ms']:.3f} ms "
        f"a tick (turns {[round(x, 3) for x in walls['synchronous']]}), "
        f"device {out['synchronous']['device_ms']:.3f}, idle share "
        f"{out['synchronous']['idle_share']}; double-buffered "
        f"{out['double_buffered']['tick_ms']:.3f} ms (turns "
        f"{[round(x, 3) for x in walls['double_buffered']]}), device "
        f"{out['double_buffered']['device_ms']:.3f}, idle share "
        f"{out['double_buffered']['idle_share']}  [{card}]")
    return out


def profile_window(server):
    """3e.e's /debug/profile: a PROFILE_MS window opened (202), a second
    request refused while it runs (409)."""
    s1, b1, _ = get_status(server.url + f"/debug/profile?ms={PROFILE_MS}")
    s2, _, _ = get_status(server.url + "/debug/profile?ms=50")
    s3, _, _ = get_status(server.url + "/debug/profile?ms=0")
    return {"open": s1, "busy": s2, "bad": s3, "out_dir": b1.get("out_dir")}


def get_status(url: str):
    try:
        with urllib.request.urlopen(url, timeout=120) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def check_profile(prof, profile_dir: str, what: str):
    """The profile window answered 202 / 409 / 400 and wrote one Chrome
    trace naming a ``row_gemm`` kernel and the context kernel."""
    if (prof["open"], prof["busy"], prof["bad"]) != (202, 409, 400):
        fail(f"{what}: /debug/profile answered {prof}")
    t0 = time.perf_counter()
    files = []
    while not files and time.perf_counter() - t0 < 60:
        files = [f for f in os.listdir(profile_dir)
                 if f.endswith(".json")] if os.path.isdir(profile_dir) else []
        time.sleep(0.1)
    if len(files) != 1:
        fail(f"{what}: profile_dir holds {files}")
    with open(os.path.join(profile_dir, files[0])) as f:
        names = {str(e.get("name", "")) for e in json.load(f)["traceEvents"]}
    kernels = {k: sorted(n for n in names if k in n)[:2]
               for k in ("row_gemm", "ctx_fwd_kernel")}
    log(f"{what}: /debug/profile?ms={PROFILE_MS} wrote {files[0]} "
        f"({len(names)} event names), kernels {kernels}")
    if not all(kernels.values()):
        fail(f"{what}: the profile window names no port kernel {kernels}")
    return {"file": files[0], "kernels": kernels}


def overload_run(torch, cfg, params, vocab, payloads, card: str):
    """3e.d: a fixed 8-slot bank behind an 8-deep queue.  A burst of
    ``batch`` requests fills the queue; then ``interactive`` ones evict
    the queued ``batch`` ones (``caption_shed_total``), and arrivals that
    find nothing below them are refused: every 429 carries the jittered
    Retry-After, ``retry_after_s`` x (0.25 + depth / queue_depth) plus
    ``retry_after_s`` / 2 x (crc32(key) mod 1024) / 1024 of its content
    key.  An unknown priority is a 400."""
    import zlib

    from cst_captioning_torch.serving.engine import InferenceEngine
    from cst_captioning_torch.serving.server import CaptionServer

    engine = InferenceEngine(cfg, params=params, vocab=vocab, device=DEVICE)
    server = CaptionServer(engine).start()
    base, depth = engine.cfg.serving.retry_after_s, OVERLOAD_DEPTH
    bodies = {}
    for i, p in enumerate(payloads):
        prio = "batch" if i < len(payloads) // 2 else "interactive"
        bodies[i] = (prio, json.dumps({
            "features": {m: a.tolist() for m, a in p["features"].items()},
            "priority": prio}).encode())
    out = {}

    def worker(i):
        out[i] = post_status(server.url + "/v1/caption", bodies[i][1])

    try:
        bad = post_status(server.url + "/v1/caption", json.dumps(
            {"features": {m: a.tolist() for m, a in
                          payloads[0]["features"].items()},
             "priority": "urgent"}).encode())
        half = len(payloads) // 2
        ths = [threading.Thread(target=worker, args=(i,))
               for i in range(half)]
        for t in ths:
            t.start()
        t0 = time.perf_counter()
        while server.batcher.depth < depth:
            if time.perf_counter() - t0 > 60:
                fail("3e.d: the batch burst never filled the queue")
            time.sleep(0.001)
        ths2 = [threading.Thread(target=worker, args=(i,))
                for i in range(half, len(payloads))]
        for t in ths2:
            t.start()
        for t in ths + ths2:
            t.join()
        metrics = urllib.request.urlopen(server.url + "/metrics",
                                         timeout=60).read().decode()
        trace = get_json(server.url + "/debug/trace")
    finally:
        server.shutdown()
    shed = {p: metric_value(metrics, f'caption_shed_total{{priority="{p}"}}')
            for p in ("interactive", "batch", "best_effort")}
    codes = {}
    for i, (status, body, hdrs) in out.items():
        codes.setdefault((bodies[i][0], status), 0)
        codes[(bodies[i][0], status)] += 1
        if status == 200:
            continue
        if status != 429:
            fail(f"3e.d: request {i} answered {status}: {body}")
        ra = float(hdrs["Retry-After"])
        key = engine.prepare(payloads[i]).cache_key
        jitter = base * 0.5 * ((zlib.crc32(key.encode()) % 1024) / 1024.0)
        fill = (body["retry_after_s"] - jitter) / base - 0.25
        steps = fill * depth
        if (abs(ra - body["retry_after_s"]) > 6e-4
                or abs(steps - round(steps)) > 2e-3 * depth
                or not 0 <= round(steps) <= 2 * depth):
            fail(f"3e.d: request {i}: Retry-After {ra} / "
                 f"{body['retry_after_s']} is not the jittered hint "
                 f"(fill {fill})")
    log(f"3e.d overload ({OVERLOAD_SLOTS} slots, queue_depth {depth}): "
        f"responses by (priority, status) "
        f"{ {f'{k[0]} {k[1]}': v for k, v in sorted(codes.items())} }, "
        f"caption_shed_total {shed}; unknown priority -> {bad[0]}  [{card}]")
    if bad[0] != 400 or shed["batch"] < 1 or shed["interactive"] != 0:
        fail(f"3e.d: shedding order or priority check failed: {shed}, "
             f"unknown priority {bad[0]}")
    return {"codes": {f"{k[0]}_{k[1]}": v for k, v in codes.items()},
            "shed": shed, "unknown_priority_status": bad[0],
            "spans": span_names(trace)}


def sigterm_drain(torch, cfg, params, vocab, bodies, card: str):
    """3e.e: ``serve_forever`` on this (main) thread; a driver thread
    sends requests and, once they are accepted, SIGTERM to this process.
    Every request must be answered 200 by the drain, and each replica
    must leave a flight dump of the drain that ``validate_flight_dump``
    accepts."""
    import signal

    from cst_captioning_torch.observability import validate_flight_dump
    from cst_captioning_torch.serving.engine import InferenceEngine
    from cst_captioning_torch.serving.server import CaptionServer

    flight_dir = cfg.serving.flight_dir
    engine = InferenceEngine(cfg, params=params, vocab=vocab, device=DEVICE)
    server = CaptionServer(engine)
    out, errs = {}, []

    def driver():
        try:
            t0 = time.perf_counter()
            while not server._listening:
                if time.perf_counter() - t0 > 300:
                    raise RuntimeError("server did not start")
                time.sleep(0.01)

            def post(i):
                out[i] = post_status(server.url + "/v1/caption", bodies[i])

            ths = [threading.Thread(target=post, args=(i,))
                   for i in range(len(bodies))]
            for t in ths:
                t.start()
            while server.metrics.requests_total.value < len(bodies):
                if time.perf_counter() - t0 > 300:
                    raise RuntimeError("requests not accepted")
                time.sleep(0.002)
            os.kill(os.getpid(), signal.SIGTERM)
            for t in ths:
                t.join()
        except Exception as e:  # noqa: BLE001 — reported below
            errs.append(f"{type(e).__name__}: {e}")
            server.shutdown()

    old = signal.getsignal(signal.SIGTERM)
    d = threading.Thread(target=driver, name="3e-sigterm-driver")
    d.start()
    try:
        server.serve_forever()
    finally:
        signal.signal(signal.SIGTERM, old)
    d.join(timeout=300)
    if errs or d.is_alive():
        fail(f"3e.e SIGTERM drain: {errs or 'driver did not finish'}")
    statuses = sorted({s for s, _, _ in out.values()})
    dumps = sorted(f for f in os.listdir(flight_dir)
                   if f.endswith("-drain.json"))
    n_rep = len(server.batcher.replicas)
    events = {}
    for f in dumps:
        with open(os.path.join(flight_dir, f)) as fh:
            rec = validate_flight_dump(json.load(fh))
        events[f] = [e["event"] for e in rec["events"]]
    log(f"3e.e SIGTERM drain: {len(out)} requests in flight answered "
        f"{statuses}; flight dumps (events: ticks, then the last three) "
        f"{ {f: [ev.count('tick')] + ev[-3:] for f, ev in events.items()} }")
    if statuses != [200] or len(dumps) != n_rep or not all(
            ev[-1] == "drain_exit" and "drain_start" in ev
            for ev in events.values()):
        fail("3e.e SIGTERM drain did not answer every request or dump "
             "every replica")
    return {"statuses": statuses, "dumps": dumps}


def check_replicas(torch, card: str, counted):
    """Phase 3e (see the module docstring).  ``counted``: the wrappers
    whose launches each run reads, [fused_context_attention, row_dot]."""
    import numpy as np

    from cst_captioning_torch.config import get_preset
    from cst_captioning_torch.data.vocab import Vocabulary
    from cst_captioning_torch.models.captioner import model_from_config
    from cst_captioning_torch.serving.engine import InferenceEngine

    t_phase = time.perf_counter()
    vocab = Vocabulary([f"w{i}" for i in range(V - 4)])
    res = {"launches": {}, "f32": {}, "bf16": {}, "burst": {}, "tick": {}}
    spans = set()
    with tempfile.TemporaryDirectory() as tmp:
        params, data = {}, {}
        for fusion in ("meanpool", "attention"):
            base = get_preset("msrvtt_serve_beam5")
            base.model.vocab_size = len(vocab)
            base.model.feature_fusion = fusion
            model = model_from_config(base, device="cpu")
            model.init_weights(
                torch.Generator().manual_seed(base.train.seed))
            params[fusion] = {k: v.clone()
                              for k, v in model.state_dict().items()}
            data[fusion] = make_bodies(np, base, N_BURST + N_STAGGER,
                                       seed=23)
            del model

        # a. f32 parity: every variant, in REPLICA_ORDERS' orders.
        off32 = {}
        for fusion, mode in REPLICA_CASES:
            payloads, bodies = data[fusion]
            n = len(bodies)
            for name, extra in REPLICA_VARIANTS:
                nrep = 2 if name == "two_wrapped" else 1
                orders = (list(range(n)), list(range(n))[::-1])
                for o, order in enumerate(
                        orders[:REPLICA_ORDERS.get(name, 1)]):
                    what = f"3e.a {fusion} {mode} f32 {name} order {o}"
                    cfg = replica_cfg(mode, fusion, True, tmp, *extra)
                    cfg.serving.warmup = False
                    r, eng = serve_continuous(torch, cfg, params[fusion],
                                              vocab, bodies, order, counted)
                    check_responses(r["out"], n, eng.cfg.eval.max_decode_len,
                                    what)
                    res["launches"][f"{fusion}_{mode}_f32_{name}_{o}"] = \
                        hold_replica_run(r, fusion, what, "ReplicaSet", nrep)
                    spans |= span_names(r["trace"])
                    if (fusion, mode) not in off32:
                        off32[(fusion, mode)] = offline_decodes(
                            torch, eng, payloads)
                    share, _, gap = caption_match(
                        r["out"], *off32[(fusion, mode)]["per_step"])
                    cps, p50, p99 = client_latency(r, range(n))
                    by = [sum(v.get("replica") == k for v in r["out"].values())
                          for k in range(nrep)]
                    log(f"{what}: {n} requests in {r['wall']:.3f} s, "
                        f"{r['steps']} steps, {r['admits']} admitting ticks, "
                        f"served by replica {by}; caption match vs offline "
                        f"per-step {share:.4f} (max |score diff| {gap})")
                    if share != 1.0 or min(by) < 1:
                        fail(f"{what}: served tokens differ from the offline "
                             "per-step decode, or a replica served nothing")
                    res["f32"][f"{fusion}_{mode}_{name}_{o}"] = {
                        "match_per_step": share, "wall_s": r["wall"],
                        "captions_per_s": cps, "p50_ms": p50, "p99_ms": p99,
                        "by_replica": by}
                    del eng

        # b. kill_replica(0) mid-traffic, and a request past its deadline.
        payloads, bodies = data["meanpool"]
        n = len(bodies)
        late = json.loads(bodies[0])
        late["deadline_ms"] = 1
        late = json.dumps(late).encode()

        def kill(server):
            t0 = time.perf_counter()
            dec0 = server.batcher.replicas[0].decoder
            while not dec0.occupied:
                if time.perf_counter() - t0 > 60:
                    fail("3e.b: replica 0 never held a request")
                time.sleep(0.0005)
            server.batcher.kill_replica(0)
            return post_status(server.url + "/v1/caption", late)[0]

        cfg = replica_cfg("beam", "meanpool", True, tmp,
                          "--serving.replicas", "2")
        cfg.serving.warmup = False
        r, eng = serve_continuous(torch, cfg, params["meanpool"], vocab,
                                  bodies, list(range(n)), counted,
                                  during=kill)
        what = "3e.b kill_replica(0), meanpool beam f32"
        res["launches"]["kill"] = hold_replica_run(r, "meanpool", what,
                                                   "ReplicaSet", 2)
        spans |= span_names(r["trace"])
        share, _, _ = caption_match(r["out"], *off32[("meanpool",
                                                      "beam")]["per_step"])
        requeues = metric_value(r["metrics"], "caption_requeues_total")
        after = [v.get("replica") for v in r["out"].values()]
        rep0 = [e["event"] for e in
                r["flight"]["recorders"]["replica0"]["events"]]
        log(f"{what}: {n} answered, match vs offline per-step {share:.4f}; "
            f"caption_requeues_total {requeues}; served by replica 0 "
            f"{after.count(0)}, 1 {after.count(1)}; healthz replicas "
            f"{r['health'].get('replicas')}; the 1 ms deadline request "
            f"-> {r['during']}; expired {r['stats']['requests']['expired']}")
        if (share != 1.0 or requeues < 1 or r["during"] != 504
                or r["health"].get("replicas") != {"healthy": 1, "total": 2}
                or "kill" not in rep0 or "drain_requeue" not in rep0
                or r["stats"]["requests"]["expired"] != 1):
            fail(f"{what}: the survivor's answers, requeues or the "
                 "deadline shed are wrong")
        res["kill"] = {"match_per_step": share, "requeues": requeues,
                       "late_status": r["during"],
                       "by_replica": [after.count(0), after.count(1)]}
        del eng

        # c. hedging: every request hedges after 1 ms.
        cfg = replica_cfg("beam", "meanpool", True, tmp,
                          "--serving.replicas", "2", "--serving.hedge_ms",
                          "1")
        cfg.serving.warmup = False
        r, eng = serve_continuous(torch, cfg, params["meanpool"], vocab,
                                  bodies, list(range(n))[::-1], counted)
        what = "3e.c hedge_ms 1, meanpool beam f32"
        res["launches"]["hedge"] = hold_replica_run(r, "meanpool", what,
                                                    "ReplicaSet", 2)
        spans |= span_names(r["trace"])
        share, _, _ = caption_match(r["out"], *off32[("meanpool",
                                                      "beam")]["per_step"])
        hedges = metric_value(r["metrics"], "caption_hedges_total")
        cancelled = metric_value(r["metrics"],
                                 "caption_hedge_cancelled_total")
        log(f"{what}: match vs offline per-step {share:.4f}; "
            f"caption_hedges_total {hedges}, hedge_cancelled {cancelled}; "
            f"served {r['stats']['requests']['served']}")
        if share != 1.0 or hedges < 1 or \
                r["stats"]["requests"]["served"] != n:
            fail(f"{what}: hedged tokens moved or nothing hedged")
        res["hedge"] = {"match_per_step": share, "hedges": hedges,
                        "cancelled": cancelled}
        del eng

        # f. bf16 (the preset's dtype): 96 requests at once per variant,
        # meanpool beam; attention greedy under the defaults, with the
        # profile window (e).  Relaxed-serving holds vs offline, whose
        # decode is the model's whatever the scheduler: one a case.
        off16 = {}
        for fusion, mode in REPLICA_CASES:
            payloads, bodies = data[fusion]
            variants = (REPLICA_VARIANTS if fusion == "meanpool"
                        else REPLICA_VARIANTS[:1])
            for name, extra in variants:
                nrep = 2 if name == "two_wrapped" else 1
                what = f"3e.f {fusion} {mode} bf16 burst {name}"
                cfg = replica_cfg(mode, fusion, False, tmp, *extra)
                prof = fusion == "attention"
                r, eng = serve_continuous(
                    torch, cfg, params[fusion], vocab, bodies,
                    list(range(N_BURST)), counted, stagger=False,
                    during=profile_window if prof else None)
                check_responses(r["out"], N_BURST,
                                eng.cfg.eval.max_decode_len, what)
                res["launches"][f"{fusion}_{mode}_bf16_{name}"] = \
                    hold_replica_run(r, fusion, what, "ReplicaSet", nrep)
                spans |= span_names(r["trace"])
                if prof:
                    res["profile"] = check_profile(
                        r["during"], cfg.serving.profile_dir, what)
                cps, p50, p99 = client_latency(r, range(N_BURST))
                tot = r["stats"]["latency_ms"]["total"]
                log(f"{what}: {N_BURST} requests in {r['wall']:.3f} s = "
                    f"{cps:.1f} captions/s; client latency p50 {p50:.1f} "
                    f"p99 {p99:.1f} ms; server total p50 {tot['p50_ms']} "
                    f"p99 {tot['p99_ms']} ms; {r['steps']} steps  [{card}]")
                row = {"captions_per_s": cps, "p50_ms": p50, "p99_ms": p99,
                       "server_total_p50_ms": tot["p50_ms"],
                       "server_total_p99_ms": tot["p99_ms"],
                       "wall_s": r["wall"], "steps": r["steps"]}
                if fusion not in off16:
                    off16[fusion] = offline_decodes(torch, eng,
                                                    payloads[:N_BURST])
                f32 = off32[(fusion, mode)]
                row.update(relaxed_holds(
                    what, r["out"], off16[fusion]["per_step"],
                    off16[fusion]["ladder"][0],
                    tuple(None if x is None else x[:N_BURST]
                          for x in f32["per_step"]),
                    f32["ladder"][0][:N_BURST]))
                res["burst"][f"{fusion}_{mode}_{name}"] = row
                if name == "one_double_buffered":
                    beam_eng = eng
                    if fusion == "attention":
                        cfg_b = replica_cfg("beam", "attention", False, tmp)
                        cfg_b.serving.warmup = False
                        beam_eng = InferenceEngine(
                            cfg_b, params=params["attention"], vocab=vocab,
                            device=DEVICE)
                    res["tick"][f"{fusion}_beam"] = tick_reading(
                        torch, beam_eng, payloads, f"{fusion} beam bf16",
                        card)
                    del beam_eng
                del eng

        # d. overload and priorities.
        cfg = replica_cfg("beam", "meanpool", False, tmp,
                          "--serving.num_slots", str(OVERLOAD_SLOTS),
                          "--serving.slot_bank_min", "0",
                          "--serving.queue_depth", str(OVERLOAD_DEPTH))
        over = overload_run(torch, cfg, params["meanpool"], vocab,
                            data["meanpool"][0][:OVERLOAD_N], card)
        spans |= over.pop("spans")
        res["overload"] = over

        # e. the SIGTERM drain of two replicas, flight dumps.
        cfg = replica_cfg("greedy", "meanpool", False, tmp,
                          "--serving.replicas", "2")
        cfg.serving.flight_dir = os.path.join(tmp, "sigterm_flight")
        cfg.serving.warmup = False
        res["sigterm"] = sigterm_drain(torch, cfg, params["meanpool"],
                                       vocab, data["meanpool"][1][:16], card)
    missing = sorted(set(REPLICA_SPANS) - spans)
    log(f"3e.e /debug/trace span names over the phase: {sorted(spans)}")
    if missing:
        fail(f"3e.e: /debug/trace never held {missing}")
    res["spans"] = sorted(spans)
    res["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 3e (ReplicaSet) took {res['wall_s']:.1f} s  [{card}]")
    return res


# ------------------------------------------------------------ phase 3f

N_TIER = 64              # requests in each direct slot-loop pass of 3f
N_TIER_REPLICA = 8       # 3f.b: ids replica 0 encodes for replica 1
TIER_FILL = 480          # 3f.d: entries put into the preset's tier
TIER_PROFILED = 3        # admitting ticks a profiler window of 3f.a


def spread_params(params):
    """Random-init weights with the serving tests' spread (embeddings x10,
    LSTM x2, vocab projection x3, EOS bias +1) and the feature
    projections x10 (a video's mean-pooled context then moves its
    caption as much as the fed-back word does), so captions differ from
    video to video and end at different steps."""
    p = {k: v.clone() for k, v in params.items()}
    for k in p:
        if k.startswith("proj_") and k.endswith("_w"):
            p[k] *= 10.0
    p["word_embed"] *= 10.0
    p["lstm0_w"] *= 2.0
    p["logit_w"] *= 3.0
    p["logit_b"][2] += 1.0
    return p


def tier_pass(torch, eng, reqs, counted):
    """Decode ``reqs`` through ``eng``'s slot decoder, admitting as many a
    tick as the bank takes, with every count in ``counted`` zeroed first.
    Returns the tokens, the launches, decode steps, admitting ticks, the
    ``admit_rows_*`` deltas, the cached / encoded rows the admitted
    (padded) batches hold and how many of them hold a miss (an encode)."""
    import numpy as np

    dec = eng.slot_decoder()
    torch.cuda.synchronize()
    for fn in counted:
        fn.launches = 0
    steps0, admits0 = dec.steps_run, dec.admit_ticks
    hit0, enc0 = eng.admit_rows_cached, eng.admit_rows_encoded
    got, want_hit, want_enc, encodes = {}, 0, 0, 0
    pending = list(range(len(reqs)))
    while pending or dec.occupied:
        dec.maybe_resize(len(pending))
        n = min(len(pending), len(dec.free), dec.admit_cap)
        adm = [pending.pop(0) for _ in range(n)]
        if n:
            padded = adm + [adm[-1]] * (dec._pad_bucket(n) - n)
            hits = sum(reqs[i].enc_row is not None for i in padded)
            want_hit += hits
            want_enc += len(padded) - hits
            encodes += hits < len(padded)
        for i, toks, _, _ in dec.harvest_many(
                dec.tick([reqs[i] for i in adm], adm)):
            got[i] = [int(t) for t in np.asarray(toks)]
    torch.cuda.synchronize()
    return {"tokens": got,
            "launches": {fn.__name__: fn.launches for fn in counted},
            "steps": dec.steps_run - steps0,
            "admits": dec.admit_ticks - admits0,
            "cached": eng.admit_rows_cached - hit0,
            "encoded": eng.admit_rows_encoded - enc0,
            "want_cached": want_hit, "want_encoded": want_enc,
            "encodes": encodes}


def hold_tier_pass(r, fusion: str, what: str):
    """A 3f pass's holds: the admission counters equal the admitted rows'
    hits and misses, and the launches exact: ADMIT_RG ``row_gemm`` for
    each admitting tick that held a miss, none for one of hits alone,
    STEP_RG and (attention) one context launch a decode step."""
    encodes = r["encodes"]
    want = {"row_dot": (ADMIT_RG[fusion] * encodes
                        + STEP_RG[fusion] * r["steps"]),
            "fused_context_attention":
                r["steps"] if fusion == "attention" else 0}
    if r["launches"] != want:
        fail(f"{what}: launches {r['launches']}, want {want} ({encodes} "
             f"encodes, {r['steps']} decode steps)")
    if (r["cached"], r["encoded"]) != (r["want_cached"], r["want_encoded"]):
        fail(f"{what}: admit_rows_cached / encoded rose by {r['cached']} / "
             f"{r['encoded']}, the admitted rows hold {r['want_cached']} "
             f"hits / {r['want_encoded']} misses")
    return dict(want, steps=r["steps"], admits=r["admits"], encodes=encodes,
                cached=r["cached"], encoded=r["encoded"])


def same_tokens(a, b, n: int, what: str):
    bad = [i for i in range(n) if a[i] != b[i]]
    if bad:
        fail(f"{what}: {len(bad)} of {n} captions differ (first {bad[:5]})")


def admit_window(torch, eng, reqs, launches: int, what: str):
    """Device ms and launches of one admitting tick of ``reqs`` (then
    every slot evicted), from a ``profiled`` window that must record
    exactly ``launches`` of the port's kernels a tick."""
    dec = eng.slot_decoder()
    reqs = reqs[:min(dec.S_max, dec.admit_cap)]
    dec.maybe_resize(len(reqs))

    def fn():
        dec.tick(reqs, list(range(len(reqs))))
        for s in list(dec.occupied):
            dec.evict(s)

    rows = profiled(torch, fn, TIER_PROFILED, launches)
    names = sorted({k for k, _, _ in rows if k.startswith("cstk::")})
    port = sum(m for k, m, _ in rows if k.startswith("cstk::"))
    copies = sum(m for k, m, _ in rows if k.startswith("Memcpy"))
    other = sum(m for _, m, _ in rows) - port - copies
    log(f"{what}: {launches} launches of the port's kernels a tick "
        f"({names}); device ms a tick: the port's kernels {port:.4f}, "
        f"copies {copies:.4f}, other (selection, the evictions' zeroing) "
        f"{other:.4f}")
    return {"launches_per_tick": launches, "kernels": names,
            "port_kernels_ms": port, "copy_ms": copies, "other_ms": other}


def entry_closed_form(cfg, model) -> int:
    """``entry_nbytes`` of one tier-2 entry with its encoder rows, from
    the shapes: float32 feats and masks per modality, the DecodeCache
    row in the compute dtype (att_mask float32), 64 for each container,
    None, int and string."""
    d = cfg.data
    F = d.max_frames
    feats = sum(F * d.feature_dims[m] * 4 for m in d.feature_modalities)
    masks = len(d.feature_modalities) * F * 4
    cdt = model.compute_dtype.itemsize
    E = model.embed_size
    enc = E * cdt                                      # ctx_static
    if model.fusion == "attention":
        Fa = F * len(d.feature_modalities)
        enc += Fa * E * cdt + Fa * model.att_hidden_size * cdt + Fa * 4
    else:
        enc += 3 * 64                     # att_vals / att_proj / att_mask
    enc += (model.category_embed_size * cdt if model.use_category
            else 64)                      # cat_emb
    return (feats + 64) + (masks + 64) + 64 + 64 + (enc + 64) + 64


def http_burst(torch, server, bodies, counted):
    """All ``bodies`` at once over HTTP to a running server: responses,
    client latency, wall, launches (summed over the scheduler's
    decoders), decode steps and admitting ticks, read once the scheduler
    is idle."""
    decs = scheduler_decoders(server)
    out, lat, errs = {}, {}, []

    def worker(i):
        t0 = time.perf_counter()
        try:
            out[i] = post_body(server.url + "/v1/caption", bodies[i])
            lat[i] = time.perf_counter() - t0
        except Exception as e:  # noqa: BLE001 — reported below
            errs.append(f"{type(e).__name__}: {e}")

    torch.cuda.synchronize()
    for fn in counted:
        fn.launches = 0
    steps0 = [d.steps_run for d in decs]
    admits0 = [d.admit_ticks for d in decs]
    t0 = time.perf_counter()
    ths = [threading.Thread(target=worker, args=(i,))
           for i in range(len(bodies))]
    for t in ths:
        t.start()
    for t in ths:
        t.join()
    wall = time.perf_counter() - t0
    while server.batcher.depth or any(d.occupied for d in decs):
        time.sleep(0.01)
    torch.cuda.synchronize()
    if errs:
        fail(f"3f.c requests failed: {errs[:3]}")
    return {"out": out, "lat": lat, "wall": wall,
            "launches": {fn.__name__: fn.launches for fn in counted},
            "steps": sum(d.steps_run - s for d, s in zip(decs, steps0)),
            "admits": sum(d.admit_ticks - a for d, a in zip(decs, admits0))}


def check_feature_cache(torch, card: str, counted):
    """Phase 3f (see the module docstring).  ``counted``: the wrappers
    whose launches each run reads, [fused_context_attention, row_dot]."""
    import numpy as np

    from cst_captioning_torch.config import get_preset
    from cst_captioning_torch.data.vocab import Vocabulary
    from cst_captioning_torch.models.captioner import model_from_config
    from cst_captioning_torch.serving.cache import entry_nbytes
    from cst_captioning_torch.serving.engine import InferenceEngine
    from cst_captioning_torch.serving.server import CaptionServer

    t_phase = time.perf_counter()
    vocab = Vocabulary([f"w{i}" for i in range(V - 4)])
    res = {"launches": {}, "direct": {}, "entry_bytes": {}, "burst": {}}
    params = {}
    for fusion in ("meanpool", "attention"):
        base = get_preset("msrvtt_serve_beam5")
        base.model.vocab_size = len(vocab)
        base.model.feature_fusion = fusion
        model = model_from_config(base, device="cpu")
        model.init_weights(torch.Generator().manual_seed(base.train.seed))
        params[fusion] = spread_params(model.state_dict())
        del model
    payloads, bodies = make_bodies(np, base, N_BURST, seed=29)
    sv = base.serving
    tier = (sv.feature_cache_size, sv.feature_cache_bytes)

    # a. The slot loop, tier 1 off: N_TIER requests with features and an
    # id (misses), the same ids alone (hits), then half and half.
    def engine(fusion, f32, *extra):
        cfg = continuous_cfg("beam", fusion, f32, "f32",
                             "--serving.caption_cache_size", "0", *extra)
        cfg.serving.warmup = False
        eng = InferenceEngine(cfg, params=params[fusion], vocab=vocab,
                              device=DEVICE)
        st = eng.cache.features.stats()
        if (st["capacity"], st["max_bytes"]) != tier:
            fail(f"3f: the engine's tier 2 is {st['capacity']} entries / "
                 f"{st['max_bytes']} bytes, the preset's {tier}")
        return eng

    f32_tokens, engines = {}, {}
    for fusion in ("meanpool", "attention"):
        for f32 in (True, False):
            dt = "f32" if f32 else "bf16"
            what = f"3f.a {fusion} beam {dt}"
            eng = engine(fusion, f32)
            pl = payloads[:N_TIER]
            miss = tier_pass(torch, eng, [
                eng.prepare(dict(p, feature_id=f"v{i}"))
                for i, p in enumerate(pl)], counted)
            hits = [eng.prepare({"feature_id": f"v{i}"})
                    for i in range(N_TIER)]
            if not all(h.enc_row is not None for h in hits):
                fail(f"{what}: an id-only request came back without rows")
            hit = tier_pass(torch, eng, hits, counted)
            mixed = tier_pass(torch, eng, [
                eng.prepare({"feature_id": f"v{i}"}) if i % 2 == 0
                else eng.prepare(pl[i]) for i in range(N_TIER)], counted)
            if hit["encodes"] or miss["encodes"] != miss["admits"]:
                fail(f"{what}: {hit['encodes']} encodes in the id-only pass, "
                     f"{miss['encodes']} of {miss['admits']} in the first")
            row = {k: hold_tier_pass(r, fusion, f"{what} {k}")
                   for k, r in (("miss", miss), ("hit", hit),
                                ("mixed", mixed))}
            same_tokens(hit["tokens"], miss["tokens"], N_TIER,
                        what + " id-only vs features")
            same_tokens(mixed["tokens"], miss["tokens"], N_TIER,
                        what + " mixed vs features")
            # The admission rows themselves: from the tier, spliced, or
            # encoded afresh, bitwise.
            fresh = eng.encode_prepared_rows([eng.prepare(p) for p in pl])
            for name, rows in (
                    ("hit", eng.encode_prepared_rows(hits)),
                    ("mixed", eng.encode_prepared_rows([
                        hits[i] if i % 2 == 0 else eng.prepare(pl[i])
                        for i in range(N_TIER)]))):
                for f, (a, b) in enumerate(zip(rows, fresh)):
                    if (a is None) != (b is None) or (
                            a is not None and not torch.equal(a, b)):
                        fail(f"{what}: {name} admission rows differ from "
                             f"a fresh encode in field {f}")
            distinct = len({tuple(t) for t in miss["tokens"].values()})
            if distinct < 2:
                fail(f"{what}: every caption is the same; the holds would "
                     "be vacuous")
            if f32:
                off = offline_decodes(torch, eng, pl)
                share, _, _ = caption_match(
                    {i: {"tokens": t} for i, t in miss["tokens"].items()},
                    off["per_step"][0], None)
                if share != 1.0:
                    fail(f"{what}: served tokens vs the offline per-step "
                         f"decode {share}")
                f32_tokens[fusion] = miss["tokens"]
                step = STEP_RG[fusion] + (fusion == "attention")
                row["profile_hit"] = admit_window(
                    torch, eng, hits, step, what + " all-hit admitting tick")
                row["profile_miss"] = admit_window(
                    torch, eng, [eng.prepare(p) for p in pl],
                    ADMIT_RG[fusion] + step, what + " all-miss admitting tick")
            entry = eng.cache.features.get("v0")
            nbytes = entry_nbytes(entry)
            want_bytes = entry_closed_form(eng.cfg, eng.model)
            if nbytes != want_bytes:
                fail(f"{what}: entry_nbytes {nbytes}, the shapes give "
                     f"{want_bytes}")
            res["entry_bytes"][f"{fusion}_{dt}"] = {
                "bytes": nbytes, "entries_in_budget": tier[1] // nbytes}
            row["distinct_captions"] = distinct
            res["direct"][f"{fusion}_{dt}"] = row
            for k in ("miss", "hit", "mixed"):
                res["launches"][f"{fusion}_{dt}_{k}"] = {
                    n: row[k][n]
                    for n in ("row_dot", "fused_context_attention")}
            log(f"{what}: {N_TIER} feature+id requests ({miss['steps']} "
                f"steps, encoded {miss['encoded']} rows), then by id alone "
                f"(cached {hit['cached']}, encoded {hit['encoded']}, "
                f"row_gemm {hit['launches']['row_dot']} = {STEP_RG[fusion]} "
                f"x {hit['steps']} steps), then mixed (cached "
                f"{mixed['cached']}, encoded {mixed['encoded']}): "
                f"token-exact; {distinct} "
                f"distinct captions; entry {nbytes} B, {tier[1] // nbytes} "
                f"entries in {tier[1]} B  [{card}]")
            engines[(fusion, dt)] = eng

    # b. Two replicas on the card: replica 0 encodes, replica 1 admits the
    # same ids with no encode and decodes the same captions.
    eng = engines[("meanpool", "f32")]
    c0 = eng.clone_for_device(DEVICE, replica_id=0)
    c1 = eng.clone_for_device(DEVICE, replica_id=1)
    ids = range(N_TIER_REPLICA)
    c0.encode_prepared_rows([c0.prepare(dict(payloads[i], feature_id=f"r{i}"))
                             for i in ids])
    reqs1 = [c1.prepare({"feature_id": f"r{i}"}) for i in ids]
    if not all(r.enc_row is not None for r in reqs1):
        fail("3f.b: replica 1 did not see replica 0's rows")
    torch.cuda.synchronize()
    for fn in counted:
        fn.launches = 0
    c1.encode_prepared_rows(reqs1)
    torch.cuda.synchronize()
    rg_admit = counted[1].launches
    r1 = tier_pass(torch, c1, reqs1, counted)
    if (rg_admit, c1.admit_rows_encoded, c0.admit_rows_encoded) != \
            (0, 0, N_TIER_REPLICA):
        fail(f"3f.b: replica 1's admission launched {rg_admit} row_gemm, "
             f"encoded {c1.admit_rows_encoded} rows (replica 0 "
             f"{c0.admit_rows_encoded})")
    same_tokens(r1["tokens"], f32_tokens["meanpool"], N_TIER_REPLICA,
                "3f.b replica 1 vs replica 0's ids")
    res["replicas"] = {"admission_row_gemm": rg_admit,
                       "replica1_cached": c1.admit_rows_cached,
                       "replica0_encoded": c0.admit_rows_encoded}
    log(f"3f.b two replicas on one card: replica 0 encoded "
        f"{c0.admit_rows_encoded} rows, replica 1 admitted them with "
        f"{rg_admit} row_gemm launches (cached {c1.admit_rows_cached}); "
        "captions equal")
    del c0, c1, engines

    # c. HTTP, bf16 meanpool beam under the preset's defaults (the
    # ReplicaSet): an unknown id 404; the burst with 0.67 MB feature
    # bodies, then id-only; tier 1 off, then at the preset's 65,536.
    tmp = tempfile.mkdtemp()        # the servers' drain dumps
    id_bodies = [json.dumps({"feature_id": f"h{i}"}).encode()
                 for i in range(N_BURST)]
    feat_bodies = [b[:-1] + f', "feature_id": "h{i}"}}'.encode()
                   for i, b in enumerate(bodies)]
    for tier1 in (0, sv.caption_cache_size):
        cfg = continuous_cfg("beam", "meanpool", False, "f32",
                             "--serving.caption_cache_size", str(tier1))
        cfg.serving.flight_dir = tmp
        eng = InferenceEngine(cfg, params=params["meanpool"], vocab=vocab,
                              device=DEVICE)
        server = CaptionServer(eng).start()
        try:
            status = post_status(server.url + "/v1/caption",
                                 b'{"feature_id": "ghost"}')[0]
            if status != 404:
                fail(f"3f.c: an unknown feature_id answered {status}")
            bursts = {}
            if not tier1:
                # The feature burst without ids, read in the same call.
                bursts["features_no_id"] = http_burst(torch, server, bodies,
                                                      counted)
            bursts["features"] = http_burst(torch, server, feat_bodies,
                                            counted)
            bursts["id_only"] = http_burst(torch, server, id_bodies, counted)
            with urllib.request.urlopen(server.url + "/metrics",
                                        timeout=60) as r:
                metrics = r.read().decode()
        finally:
            server.shutdown()
        what = f"3f.c bf16 burst, tier 1 {tier1}"
        want_tok = {i: o["tokens"]
                    for i, o in bursts["features"]["out"].items()}
        row = {}
        for name, b in bursts.items():
            check_responses(b["out"], N_BURST, cfg.eval.max_decode_len, what)
            same_tokens({i: o["tokens"] for i, o in b["out"].items()},
                        want_tok, N_BURST, f"{what} {name} vs features")
            encodes = 0 if name == "id_only" else b["admits"]
            want_rg = (ADMIT_RG["meanpool"] * encodes
                       + STEP_RG["meanpool"] * b["steps"])
            if b["launches"]["row_dot"] != want_rg:
                fail(f"{what} {name}: row_gemm {b['launches']['row_dot']}, "
                     f"want {want_rg} ({encodes} encodes, {b['steps']} steps)")
            cps, p50, p99 = client_latency(b, range(N_BURST))
            row[name] = {"captions_per_s": cps, "p50_ms": p50, "p99_ms": p99,
                         "wall_s": b["wall"], "steps": b["steps"],
                         "admits": b["admits"],
                         "row_dot": b["launches"]["row_dot"]}
            res["launches"][f"http_tier1_{tier1}_{name}"] = b["launches"]
            log(f"{what} {name}: {N_BURST} requests in {b['wall']:.3f} s = "
                f"{cps:.1f} captions/s; client p50 {p50:.1f} p99 {p99:.1f} "
                f"ms; {b['steps']} steps, {b['admits']} admitting ticks, "
                f"row_gemm {b['launches']['row_dot']}  [{card}]")
        ib = bursts["id_only"]
        cached = sum(bool(o.get("cached")) for o in ib["out"].values())
        f_hits = metric_value(metrics, "caption_cache_features_hits")
        if tier1 and (cached != N_BURST or ib["steps"]):
            fail(f"{what}: {cached} id-only answers from tier 1, "
                 f"{ib['steps']} decode steps")
        if not tier1 and (cached or f_hits < N_BURST):
            fail(f"{what}: tier-2 hits {f_hits}, {cached} from tier 1")
        row["features_tier_hits"] = f_hits
        res["burst"][f"tier1_{tier1}"] = row
        del eng
    shutil.rmtree(tmp, ignore_errors=True)

    # d. Fill the preset's tier past its byte bound.
    eng = engine("meanpool", False)
    st0 = eng.cache.features.stats()
    for i in range(TIER_FILL):
        eng.prepare(dict(payloads[i % N_BURST], feature_id=f"fill{i}"))
    st = eng.cache.features.stats()
    evicted = st["evictions"] - st0["evictions"]
    if (st["bytes"] > st["max_bytes"] or st["size"] >= st["capacity"]
            or evicted != st0["size"] + TIER_FILL - st["size"]
            or evicted < 1):
        fail(f"3f.d: after {TIER_FILL} entries the tier reads {st}")
    res["overfill"] = {"puts": TIER_FILL, "size": st["size"],
                       "bytes": st["bytes"], "max_bytes": st["max_bytes"],
                       "evictions": evicted}
    log(f"3f.d {TIER_FILL} entries into the preset's tier: {st['size']} "
        f"held, {st['bytes']} of {st['max_bytes']} B, {evicted} evicted "
        "(the byte bound binds before the 4096-entry bound)")
    del eng
    res["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 3f (tier-2 encoder-row cache) took {res['wall_s']:.1f} s  "
        f"[{card}]")
    return res


# ------------------------------------------------------------ phase 4

N_TRAIN_VIDEOS, N_VAL_VIDEOS = 256, 64
N_TOPICS, WORDS_PER_TOPIC = 64, 48
XE_LOSS_RTOL = 1e-5
XE_GRAD_GAP = 1e-4


def make_msrvtt_corpus(np, vocab, cfg, n_videos: int, seed: int,
                       num_categories: int = 0):
    """An in-memory corpus at MSR-VTT widths with a learnable signal:
    each video has a topic; its frames (between F/2 and F of them) are
    the topic's fixed random embedding plus noise, per modality; its
    ``seq_per_img`` captions are 6..28 words drawn from the topic's
    words.  Topics are shared across seeds, so splits agree.  With
    ``num_categories`` each video also gets a category id, drawn after
    everything else (from a stream of its own), so the rest of the
    corpus is the one the same seed gives without them."""
    from cst_captioning_torch.data.datasets import InMemoryDataset

    d = cfg.data
    trng = np.random.RandomState(20261016)
    topic_embed = {m: trng.randn(N_TOPICS, d.feature_dims[m]).astype(np.float32)
                   for m in d.feature_modalities}
    topic_words = trng.randint(4, len(vocab), (N_TOPICS, WORDS_PER_TOPIC))
    rng = np.random.RandomState(seed)
    feats = {m: [] for m in d.feature_modalities}
    caps, refs = [], []
    max_words = d.max_seq_len - 2
    for _ in range(n_videos):
        t = rng.randint(N_TOPICS)
        nf = rng.randint(d.max_frames // 2, d.max_frames + 1)
        for m in d.feature_modalities:
            noise = rng.standard_normal((nf, d.feature_dims[m])).astype(np.float32)
            feats[m].append(topic_embed[m][t] + np.float32(0.5) * noise)
        sents = [" ".join(vocab.idx_to_word[w] for w in rng.choice(
            topic_words[t], rng.randint(6, max_words + 1)))
            for _ in range(d.seq_per_img)]
        refs.append(sents)
        caps.append(np.stack([vocab.encode(s.split(), max_words)
                              for s in sents]))
    ids = [f"video{seed}_{i}" for i in range(n_videos)]
    cats = (np.random.RandomState(seed + 1000).randint(
        num_categories, size=n_videos).tolist() if num_categories else None)
    return InMemoryDataset(vocab, ids, feats, caps, refs, categories=cats)


def plain_recurrence(torch, lstm_mod):
    """The recurrence through its plain version, forward and backward
    (for the kernel-vs-plain XE step)."""

    class PlainRecurrence(torch.autograd.Function):
        @staticmethod
        def forward(ctx, gx, wh):
            h, c = lstm_mod.lstm_recurrence_ref(gx, wh, with_cell=True)
            ctx.save_for_backward(gx, wh, h, c)
            return h

        @staticmethod
        def backward(ctx, dh):
            return lstm_mod.lstm_recurrence_bwd(*ctx.saved_tensors, dh)

    return PlainRecurrence.apply


def plain_att_recurrence(torch, att_mod):
    """The attention recurrence through its plain forward and backward
    (for the kernel-vs-plain XE step)."""

    class PlainAttRecurrence(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *args):
            *tensors, rep = args
            h, c, a = att_mod.attlstm_recurrence_ref(*tensors, rep,
                                                     with_residuals=True)
            ctx.save_for_backward(*tensors, h, c, a)
            ctx.rep = rep
            return h

        @staticmethod
        def backward(ctx, dh):
            gx, wh, w_ctx, att_wh, att_v, proj, _, vals, h, c, a = \
                ctx.saved_tensors
            g = att_mod.attlstm_recurrence_bwd_ref(
                gx, wh, w_ctx, att_wh, att_v, proj, vals, h, c, a, dh,
                ctx.rep)
            return (*g[:6], None, g[6], None)

    return PlainAttRecurrence.apply


def xe_step_fn(torch, trainer, cfg, dtype: str = "float32"):
    """A copy of the trained model in ``dtype`` (float32 unless given)
    and one training batch.
    Returns ``run(ss_prob, seed, swap)`` -> (loss, gradients) of one XE
    step; ``seed`` seeds the step's generator (None: no dropout), and
    ``swap`` = (captioner attribute, function) replaces a kernel wrapper
    the model calls for the duration of the step."""
    import copy

    from cst_captioning_torch.data.loader import to_device
    from cst_captioning_torch.models import captioner
    from cst_captioning_torch.training.steps import xe_loss

    c32 = copy.deepcopy(cfg)
    c32.model.compute_dtype = dtype
    model = captioner.model_from_config(c32, device=DEVICE)
    model.load_state_dict(trainer.model.state_dict())
    batch = to_device(next(iter(trainer.train_iter.epoch(0))),
                      torch.device(DEVICE))
    params = list(model.parameters())

    def run(ss_prob=0.0, seed=99, swap=None):
        gen = (None if seed is None
               else torch.Generator(device=DEVICE).manual_seed(seed))
        if swap is not None:
            kernel = getattr(captioner, swap[0])
            setattr(captioner, swap[0], swap[1])
        try:
            loss = xe_loss(model, batch.feats, batch.feat_masks,
                           batch.captions, torch.ones_like(batch.weights),
                           gen, ss_prob,
                           batch.category if model.use_category else None)
            return float(loss.detach()), torch.autograd.grad(loss, params)
        finally:
            if swap is not None:
                setattr(captioner, swap[0], kernel)

    return run


def step_gap(torch, a, b):
    """(loss rtol, |grad a - grad b| / |grad b|) of two (loss, grads)."""
    from cst_captioning_torch.training.steps import global_norm

    gap = float(global_norm({str(i): x - y for i, (x, y)
                             in enumerate(zip(a[1], b[1]))})
                / global_norm({str(i): y for i, y in enumerate(b[1])}))
    return abs(a[0] - b[0]) / abs(b[0]), gap


def check_xe_step(torch, trainer, cfg, kernel_name: str, plain_fn):
    """One XE step at float32 on the trained weights and one training
    batch: loss and gradients through the recurrence kernel(s) vs
    through ``plain_fn`` in place of ``captioner.<kernel_name>`` (the
    same dropout draw)."""
    run = xe_step_fn(torch, trainer, cfg)
    k, p = run(), run(swap=(kernel_name, plain_fn))
    loss_rtol, gap = step_gap(torch, k, p)
    log(f"XE step f32 {cfg.model.feature_fusion} kernel vs plain: loss "
        f"{k[0]:.6f} vs {p[0]:.6f} "
        f"(rtol {loss_rtol:.3e}), |grad diff| / |grad| {gap:.3e}")
    if loss_rtol > XE_LOSS_RTOL or gap > XE_GRAD_GAP:
        fail("XE step through the kernel disagrees with the plain version")
    return {"loss_rtol": loss_rtol, "grad_gap": gap}


def step_breakdown(torch, trainer, card: str):
    """Where one bf16 XE step's time goes: CUDA events around its parts
    (after a warm-up step), then the profiler's top device kernels of
    the same step."""
    from cst_captioning_torch.constants import PAD_ID
    from cst_captioning_torch.data.loader import to_device
    from cst_captioning_torch.models.captioner import _repeat_cache
    from cst_captioning_torch.ops.losses import weighted_cross_entropy

    model, opt = trainer.model, trainer.optimizer
    names, params = zip(*model.named_parameters())
    b = to_device(next(iter(trainer.train_iter.epoch(0))),
                  torch.device(DEVICE))
    Bv, S, L = b.captions.shape
    caps = b.captions.long().reshape(Bv * S, L)
    inputs, targets = caps[:, :-1], caps[:, 1:]
    tmask = (targets != PAD_ID).float()
    w = torch.ones(Bv * S, device=DEVICE)
    parts = ("encode", "input GEMMs + recurrence kernel",
             "dropout + vocab GEMM", "loss (log-softmax)",
             "backward (autograd; " + (
                 "attlstm_recurrence_bwd kernel" if model.fusion == "attention"
                 else "plain recurrence backward") + ")", "optimizer")

    def one_step(ev=None):
        mark = (lambda i: ev[i].record()) if ev else (lambda i: None)
        gen = torch.Generator(device=DEVICE).manual_seed(7)
        mark(0)
        cache = model._encode(b.feats, b.feat_masks,
                              b.category if model.use_category else None)
        if model.fusion != "attention":  # attention stays per video
            cache = _repeat_cache(cache, S)
        mark(1)
        if model.fusion == "attention":
            h_seq = model._fused_attention_forward(cache, inputs, S)
        else:
            h_seq = model._fused_forward(cache, inputs)
        mark(2)
        logits = model._logits(model._output_dropout(h_seq, gen))
        mark(3)
        loss = weighted_cross_entropy(logits, targets, tmask, w)
        mark(4)
        grads = torch.autograd.grad(loss, params)
        mark(5)
        opt.step(dict(zip(names, grads)))
        mark(6)

    one_step()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
    one_step(ev)
    torch.cuda.synchronize()
    out = {}
    for i, name in enumerate(parts):
        out[name] = ev[i].elapsed_time(ev[i + 1])
        log(f"XE step bf16 {model.fusion} part: {name} {out[name]:.3f} ms  "
            f"[{card}]")
    total = ev[0].elapsed_time(ev[6])
    log(f"XE step bf16 {model.fusion} total {total:.3f} ms  [{card}]")
    out["total"] = total
    for kname, ms, count in kernel_breakdown(torch, one_step)[:15]:
        log(f"breakdown XE step bf16 {model.fusion}: {kname} {ms:.3f} ms over "
            f"{count} launches")
    return out


def train_cfg(fusion: str):
    """``msrvtt_resnet_c3d_xe`` with ``fusion``, 2 epochs, validating
    each."""
    from cst_captioning_torch.config import get_preset

    cfg = get_preset("msrvtt_resnet_c3d_xe")
    cfg.model.feature_fusion = fusion
    cfg.train.max_epochs = 2
    cfg.train.eval_every = 1
    return cfg


def build_trainer(torch, cfg, workdir: str, corpora=None):
    """The port's ``Trainer`` on ``cfg`` at full width over a generated
    MSR-VTT-width corpus (``make_msrvtt_corpus``; ``corpora``, a (train,
    val) pair, reuses one built before), checkpoints under
    ``workdir``."""
    import numpy as np

    from cst_captioning_torch.data.vocab import Vocabulary
    from cst_captioning_torch.training.trainer import Trainer

    if corpora is None:
        vocab = Vocabulary([f"w{i}" for i in range(V - 4)])
        t0 = time.perf_counter()
        corpora = (make_msrvtt_corpus(np, vocab, cfg, N_TRAIN_VIDEOS, seed=1),
                   make_msrvtt_corpus(np, vocab, cfg, N_VAL_VIDEOS, seed=2))
        log(f"train corpus: {N_TRAIN_VIDEOS} + {N_VAL_VIDEOS} videos at "
            f"{cfg.data.feature_dims} x {cfg.data.max_frames} frames, "
            f"{cfg.data.seq_per_img} captions each, V={len(vocab)}, built "
            f"in {time.perf_counter() - t0:.1f} s")
    train_ds, val_ds = corpora
    cfg.train.checkpoint_dir = workdir
    trainer = Trainer(cfg, train_ds, val_ds, device=DEVICE)
    m = trainer.model
    if (m.vocab_size, m.rnn_size, m.embed_size) != (V, H, E):
        fail(f"model widths {(m.vocab_size, m.rnn_size, m.embed_size)}")
    return trainer


def check_training(torch, card: str, fusion: str, counted, swap,
                   workdir: str):
    """Phase 4 (meanpool) / 4b (attention), see the module docstring.
    ``counted`` maps names to the wrappers whose launches the training
    run must count; ``swap`` is (captioner attribute, plain autograd
    function) for the f32 XE step check.  Checkpoints go under
    ``workdir`` (phase 5 warm-starts from them).  Returns the launch
    counts of the training run, the readings and the ``best``
    checkpoint's path."""
    import numpy as np

    cfg = train_cfg(fusion)
    res = {}
    trainer = build_trainer(torch, cfg, workdir)
    seen = []
    inner = trainer._train_step

    def recording_step(*args):
        out = inner(*args)
        seen.append(out)
        return out

    trainer._train_step = recording_step
    for fn in counted.values():
        fn.launches = 0
    t0 = time.perf_counter()
    hist = trainer.fit()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in counted.items()}
    trainer._train_step = inner
    losses = [float(x["loss"]) for x in seen]
    gnorms = [float(x["grad_norm"]) for x in seen]
    per_epoch = trainer.train_iter.num_batches()
    log(f"train {fusion}: {len(seen)} steps ({per_epoch} per epoch) in "
        f"{wall:.1f} s incl. validation; losses "
        f"{[round(x, 4) for x in losses]}, grad norms "
        f"{[round(x, 4) for x in gnorms]}")
    if per_epoch != 4 or len(seen) != 2 * per_epoch:
        fail(f"expected 2 x 4 steps, ran {len(seen)}")
    if not all(np.isfinite(losses)) or not all(np.isfinite(gnorms)):
        fail("non-finite loss or grad norm")
    if sorted(hist) != ["0", "1"]:
        fail(f"history epochs {sorted(hist)}")
    e0, e1 = hist["0"], hist["1"]
    log(f"train {fusion}: epoch 0 loss {e0['train_loss']:.4f} "
        f"({e0['steps_per_sec']:.3f} steps/s), epoch 1 loss "
        f"{e1['train_loss']:.4f} ({e1['steps_per_sec']:.3f} steps/s)  "
        f"[{card}]")
    if not e1["train_loss"] < e0["train_loss"]:
        fail("the mean train loss did not fall from epoch 0 to 1")
    for e in (e0, e1):
        if "CIDEr" not in e.get("val", {}):
            fail("validation entry without CIDEr")
    log(f"val {fusion}: epoch 0 {json.dumps(e0['val'])}; epoch 1 "
        f"{json.dumps(e1['val'])}")
    for d in ("best", "last"):
        if not os.path.exists(os.path.join(trainer.workdir, d,
                                           "params.pt")):
            fail(f"no {d} checkpoint")
    if min(launches.values()) < 1:
        fail(f"a kernel of the training path was not launched: {launches}")
    log(f"train {fusion}: launches {launches}")
    res["launches"] = launches
    res["steps_per_sec"] = [e0["steps_per_sec"], e1["steps_per_sec"]]
    res["xe_f32"] = check_xe_step(torch, trainer, cfg, *swap)
    res["step_ms"] = step_breakdown(torch, trainer, card)
    res["best"] = os.path.join(trainer.workdir, "best")
    return res


# ------------------------------------------------------------ phase 4c

SS_PROB_EPOCH1 = 0.25
SS_SIGMAS = 5.0


def plain_context_attention(torch, ctx_mod):
    """The context step through its plain forward and backward (for the
    kernel-vs-plain step on the per-step path); same signature as
    ``fused_context_attention``."""

    class PlainContextAttention(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, proj, mask, vals, v, rep):
            out, attn = ctx_mod.fused_context_attention_ref(q, proj, mask,
                                                            vals, v, rep)
            ctx.rep = rep
            ctx.save_for_backward(q, proj, vals, v, attn)
            return out

        @staticmethod
        def backward(ctx, dctx):
            q, proj, vals, v, attn = ctx.saved_tensors
            g = ctx_mod.fused_context_attention_bwd_ref(q, proj, vals, v,
                                                        attn, dctx, ctx.rep)
            return g[0], g[1], None, g[2], g[3], None

    def call(q, proj, mask, vals, v, rep=1):
        return PlainContextAttention.apply(q, proj, mask, vals, v, rep)

    return call


def ss_step_breakdown(torch, trainer, card: str, fused_ms):
    """Where one bf16 training step on the per-step path (``ss_prob``
    0.25) goes: CUDA events around its parts after a warm-up step, each
    beside the same part of phase 4b's fused step (``fused_ms``, in
    ``step_breakdown``'s order); the sampling logits and draws (inside
    the loop) timed alone, T - 1 calls at the loop's shape; then the
    profiler's top device kernels."""
    from cst_captioning_torch.constants import PAD_ID
    from cst_captioning_torch.data.loader import to_device
    from cst_captioning_torch.ops.losses import weighted_cross_entropy

    model, opt = trainer.model, trainer.optimizer
    names, params = zip(*model.named_parameters())
    b = to_device(next(iter(trainer.train_iter.epoch(0))),
                  torch.device(DEVICE))
    Bv, S, L = b.captions.shape
    caps = b.captions.long().reshape(Bv * S, L)
    inputs, targets = caps[:, :-1], caps[:, 1:]
    tmask = (targets != PAD_ID).float()
    w = torch.ones(Bv * S, device=DEVICE)
    parts = ("encode", f"per-step forward loop ({T_XE} steps, incl. sampling)",
             "dropout + vocab GEMM", "loss (log-softmax)",
             "backward (autograd; fused_context_attention_bwd per step)",
             "optimizer")
    hold = {}

    def one_step(ev=None):
        mark = (lambda i: ev[i].record()) if ev else (lambda i: None)
        gen = torch.Generator(device=DEVICE).manual_seed(7)
        mark(0)
        cache = model._encode(b.feats, b.feat_masks)
        mark(1)
        h_seq = model._per_step_forward(cache, inputs, SS_PROB_EPOCH1, gen, S)
        mark(2)
        logits = model._logits(model._output_dropout(h_seq, gen))
        mark(3)
        loss = weighted_cross_entropy(logits, targets, tmask, w)
        mark(4)
        grads = torch.autograd.grad(loss, params)
        mark(5)
        opt.step(dict(zip(names, grads)))
        mark(6)
        hold["h"] = h_seq[:, 0].detach()

    one_step()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
    one_step(ev)
    torch.cuda.synchronize()
    out = {}
    for i, name in enumerate(parts):
        out[name] = ev[i].elapsed_time(ev[i + 1])
    gen = torch.Generator(device=DEVICE).manual_seed(8)
    with torch.no_grad():
        sample_ms = time_call(torch, lambda: model._sample_tokens(
            model._logits(hold["h"]), gen), REPS)
    out["of which sampling logits + draws"] = sample_ms * (T_XE - 1)
    out["total"] = ev[0].elapsed_time(ev[6])
    fused = list(fused_ms.items())
    for i, (name, ms) in enumerate(out.items()):
        beside = ""
        if i < len(parts) or name == "total":
            fname, fms = fused[i] if i < len(parts) else fused[-1]
            beside = f" (4b fused step, {fname}: {fms:.3f} ms)"
        log(f"SS step bf16 attention part: {name} {ms:.3f} ms{beside}  "
            f"[{card}]")
    for kname, ms, count in kernel_breakdown(torch, one_step)[:15]:
        log(f"breakdown SS step bf16 attention: {kname} {ms:.3f} ms over "
            f"{count} launches")
    return out


def check_ss_training(torch, card: str, counted, plain_ctx, fused_ms):
    """Phase 4c, see the module docstring.  ``counted`` maps names to the
    wrappers whose launches each epoch counts (the context kernels and
    the fused recurrence kernels); ``plain_ctx`` is the context step
    through its plain versions; ``fused_ms`` phase 4b's step breakdown,
    printed beside this one."""
    import numpy as np

    cfg = train_cfg("attention")
    cfg.model.scheduled_sampling_start = 0
    cfg.model.scheduled_sampling_increase_every = 1
    cfg.model.scheduled_sampling_increase_prob = SS_PROB_EPOCH1
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        trainer = build_trainer(torch, cfg, tmp)
        per_epoch, draws, sizes = {}, [], []
        inner_epoch = trainer.train_epoch
        feed_mask = trainer.model._feed_mask

        def counting_epoch(epoch, **kw):
            before = {n: fn.launches for n, fn in counted.items()}
            out = inner_epoch(epoch, **kw)
            per_epoch[epoch] = {n: fn.launches - before[n]
                                for n, fn in counted.items()}
            return out

        def recording_mask(*args):
            m = feed_mask(*args)
            draws.append(m.sum())
            sizes.append(m.numel())
            return m

        trainer.train_epoch = counting_epoch
        trainer.model._feed_mask = recording_mask
        for fn in counted.values():
            fn.launches = 0
        t0 = time.perf_counter()
        hist = trainer.fit()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {n: fn.launches for n, fn in counted.items()}
        del trainer.model._feed_mask
        trainer.train_epoch = inner_epoch
        steps = trainer.train_iter.num_batches()
        e0, e1 = hist.get("0", {}), hist.get("1", {})
        log(f"train attention + scheduled sampling: {2 * steps} steps in "
            f"{wall:.1f} s incl. validation; ss_prob {e0.get('ss_prob')} / "
            f"{e1.get('ss_prob')}; loss {e0.get('train_loss', 0):.4f} "
            f"({e0.get('steps_per_sec', 0):.3f} steps/s, fused) / "
            f"{e1.get('train_loss', 0):.4f} ({e1.get('steps_per_sec', 0):.3f} "
            f"steps/s, per step)  [{card}]; launches per epoch {per_epoch}")
        if steps != 4 or sorted(hist) != ["0", "1"]:
            fail(f"expected 2 x 4 steps, history {sorted(hist)}")
        if (e0["ss_prob"], e1["ss_prob"]) != (0.0, SS_PROB_EPOCH1):
            fail(f"ss_prob per epoch {e0['ss_prob']}, {e1['ss_prob']}")
        if not all(np.isfinite([e0["train_loss"], e1["train_loss"],
                                e0["grad_norm"], e1["grad_norm"]])):
            fail("non-finite loss or grad norm under scheduled sampling")
        for d in ("best", "last"):
            if not os.path.exists(os.path.join(trainer.workdir, d,
                                               "params.pt")):
                fail(f"no {d} checkpoint")
        want = T_XE * steps
        p0, p1 = per_epoch[0], per_epoch[1]
        if (p0["fused_context_attention"] or p0["fused_context_attention_bwd"]
                or p0["attlstm_recurrence"] != steps
                or p1["fused_context_attention"] != want
                or p1["fused_context_attention_bwd"] != want
                or p1["attlstm_recurrence"]):
            fail(f"epoch 0 must take the fused recurrence ({steps} launches) "
                 f"and epoch 1 the context kernels ({want} launches each): "
                 f"{per_epoch}")
        n = sum(sizes)
        share = float(torch.stack(draws).sum()) / n
        sigma = (SS_PROB_EPOCH1 * (1 - SS_PROB_EPOCH1) / n) ** 0.5
        log(f"fed-sample share at t >= 1 over {len(draws)} draws, {n} rows "
            f"in all: {share:.5f} (ss_prob {SS_PROB_EPOCH1}, "
            f"{abs(share - SS_PROB_EPOCH1) / sigma:.2f} binomial sigmas)")
        if len(draws) != (T_XE - 1) * steps or not (
                abs(share - SS_PROB_EPOCH1) <= SS_SIGMAS * sigma):
            fail("the fed-sample share is off the scheduled-sampling "
                 "probability")
        res.update(launches=launches, per_epoch=per_epoch, fed_share=share,
                   fed_sigmas=abs(share - SS_PROB_EPOCH1) / sigma,
                   steps_per_sec=[e0["steps_per_sec"], e1["steps_per_sec"]],
                   losses=[e0["train_loss"], e1["train_loss"]])

        run = xe_step_fn(torch, trainer, cfg)
        zero = torch.tensor(0.0)
        k = run(zero, None)
        p = run(zero, None, swap=("fused_context_attention", plain_ctx))
        f = run(0.0, None)
        kp, kf = step_gap(torch, k, p), step_gap(torch, k, f)
        log(f"SS step f32 (ss_prob a tensor 0, no dropout): kernels vs "
            f"plain loss {k[0]:.6f} vs {p[0]:.6f} (rtol {kp[0]:.3e}), "
            f"|grad diff| / |grad| {kp[1]:.3e}; vs the fused attlstm_"
            f"recurrence step {f[0]:.6f} (rtol {kf[0]:.3e}), |grad diff| / "
            f"|grad| {kf[1]:.3e}")
        if kp[0] > XE_LOSS_RTOL or kp[1] > XE_GRAD_GAP:
            fail("the per-step training step through the kernels disagrees "
                 "with the plain versions")
        if kf[0] > XE_LOSS_RTOL or kf[1] > XE_GRAD_GAP:
            fail("the per-step training step disagrees with the fused "
                 "attlstm_recurrence step")
        run16 = xe_step_fn(torch, trainer, cfg, "bfloat16")
        kb = step_gap(torch, run16(zero, None), run16(
            zero, None, swap=("fused_context_attention", plain_ctx)))
        log(f"SS step bf16 (reported, not held): kernels vs plain loss rtol "
            f"{kb[0]:.3e}, |grad diff| / |grad| {kb[1]:.3e}")
        res["step_bf16_vs_plain"] = {"loss_rtol": kb[0], "grad_gap": kb[1]}
        res["step_f32_vs_plain"] = {"loss_rtol": kp[0], "grad_gap": kp[1]}
        res["step_f32_vs_fused"] = {"loss_rtol": kf[0], "grad_gap": kf[1]}
        res["step_ms"] = ss_step_breakdown(torch, trainer, card, fused_ms)
    return res


# ------------------------------------------------------------ phase 5

CST_PRESET = "msrvtt_cst_ms_scb"
CST_TIMED = 3     # timed CST steps, after one warm-up step
# The native CIDEr-D scorer against the Python scorer on the card's
# tokens: the C++ scorer keeps the reference vectors in float32, the
# Python one in float64, so the two differ in the last bit of some
# rewards; held at the reference's own tier for this pair
# (tests/test_native_ciderd.py).
SCORER_RTOL, SCORER_ATOL = 1e-5, 1e-6
CST_SEED_WORDS = (0x2545F491, 0x9E3779B9)  # the f32 rollout check's stream


def cst_trainer(torch, fusion: str, start_from: str, workdir: str,
                train_ds=None, use_category: bool = False, layers: int = 1):
    """The port's ``Trainer`` on ``msrvtt_cst_ms_scb`` at full width
    (``fusion``, ``layers`` LSTM layers), warm-started from
    ``start_from``, over phase 4's generated corpus (256 videos, seed 1;
    built unless ``train_ds`` is given).  Returns (trainer, corpus, the
    corpus's batches on the card)."""
    import numpy as np

    from cst_captioning_torch.config import get_preset
    from cst_captioning_torch.data.loader import to_device
    from cst_captioning_torch.data.vocab import Vocabulary
    from cst_captioning_torch.training.trainer import Trainer

    cfg = get_preset(CST_PRESET)
    cfg.model.feature_fusion = fusion
    cfg.model.use_category = use_category
    cfg.model.num_layers = layers
    cfg.train.start_from = start_from
    cfg.train.checkpoint_dir = workdir
    cfg.train.max_epochs = 1
    if train_ds is None:
        vocab = Vocabulary([f"w{i}" for i in range(V - 4)])
        train_ds = make_msrvtt_corpus(np, vocab, cfg, N_TRAIN_VIDEOS, seed=1)
    trainer = Trainer(cfg, train_ds, None, device=DEVICE)
    m = trainer.model
    if (m.vocab_size, m.rnn_size, m.embed_size, m.fusion) != (V, H, E, fusion):
        fail(f"CST model widths {(m.vocab_size, m.rnn_size, m.embed_size)}")
    backend = trainer._train_step.scorer.backend
    if backend != "native":
        fail(f"the CST reward scorer is {backend!r}, not the native one")
    batches = [to_device(b, torch.device(DEVICE))
               for b in trainer.train_iter.epoch(0)]
    return trainer, train_ds, batches


def cst_probe(torch, model):
    """CUDA events around each rollout / greedy decode and the PG update
    of a CST step (wrappers on ``model.sample_cache`` and
    ``cst._pg_update``; events only, no synchronisation), and the last
    update's tokens, mask and advantage.  Returns (windows, last,
    restore)."""
    from cst_captioning_torch.training import cst as cst_mod

    windows = {"rollout": [], "greedy": [], "update": []}
    last = {}
    inner_sample, inner_pg = model.sample_cache, cst_mod._pg_update

    def timed(kind, fn, *args, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = fn(*args, **kw)
        ev[1].record()
        windows[kind].append(ev)
        return out

    def sample_cache(cache, seed, **kw):
        return timed("greedy" if kw["greedy"] else "rollout", inner_sample,
                     cache, seed, **kw)

    def pg_update(model_, opt, feats, masks, S, tokens, mask, adv, *args):
        last.update(tokens=tokens, mask=mask, adv=adv, feats=feats,
                    masks=masks, category=args[2] if len(args) > 2 else None)
        return timed("update", inner_pg, model_, opt, feats, masks, S,
                     tokens, mask, adv, *args)

    def restore():
        del model.sample_cache
        cst_mod._pg_update = inner_pg

    model.sample_cache = sample_cache
    cst_mod._pg_update = pg_update
    return windows, last, restore


def run_cst_step(torch, step, batch, seed: int, windows=None):
    """One CST step from an idle card: (metrics, phase_ms, wall ms to the
    end of its device work, device ms per probe window kind)."""
    if windows is not None:
        for v in windows.values():
            v.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = step(batch.feats, batch.feat_masks, batch.captions, batch.weights,
             batch.category, batch.video_idx,
             torch.Generator(device=DEVICE).manual_seed(seed), 0.0)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    dev = {k: sum(a.elapsed_time(b) for a, b in v)
           for k, v in (windows or {}).items()}
    if windows is not None:
        dev["rollout_chunks"] = [round(a.elapsed_time(b), 3)
                                 for a, b in windows["rollout"]]
    return m, dict(step.phase_ms), wall, dev


def log_cst_step(what: str, m, phases, wall, dev, card: str):
    """One step's phases and the overlap: the wall time against the
    serial sum of device decode, host scoring and the device update."""
    score = phases.get("score_ms", 0.0) + phases.get("score_wait_ms", 0.0)
    serial = dev["rollout"] + dev["greedy"] + score + dev["update"]
    log(f"CST step {what}: loss {float(m['loss']):.5f} grad norm "
        f"{float(m['grad_norm']):.4f} reward {m['reward']:.5f} baseline "
        f"{m['baseline']:.5f} advantage {m['advantage']:.3e}; phases "
        f"{json.dumps(phases)}; device ms rollout {dev['rollout']:.3f} "
        f"(chunks {dev['rollout_chunks']}), greedy {dev['greedy']:.3f}, "
        f"update {dev['update']:.3f}; host scoring {score:.3f} ms; wall "
        f"{wall:.3f} ms vs serial sum {serial:.3f} ms (overlap "
        f"{serial - wall:.3f} ms)  [{card}]")
    for k in ("loss", "grad_norm", "reward", "baseline", "advantage"):
        if not math.isfinite(float(m[k])):
            fail(f"CST step {what}: non-finite {k}")
    return dict(phases, wall_ms=wall, serial_ms=serial, score_host_ms=score,
                **{f"device_{k}_ms": v for k, v in dev.items()})


def counts(counted) -> dict:
    """Each wrapper's launches, and its int8w launches where it counts
    them (``<name>_quant``)."""
    out = {n: fn.launches for n, fn in counted.items()}
    out.update({n + "_quant": fn.quant_launches for n, fn in counted.items()
                if hasattr(fn, "quant_launches")})
    return out


def hold_launches(counted, want, what: str):
    """Hold the launch counts (``counts``) to ``want``; a count that
    ``want`` does not name must be 0."""
    return hold_counts(counts(counted), want, what)


def hold_counts(got: dict, want: dict, what: str):
    """``hold_launches`` on counts already read (a child process's)."""
    got = {k: v for k, v in got.items() if k in want or v}
    log(f"launches, {what}: {got}")
    if got != want:
        fail(f"launches, {what}: {got}, want {want}")
    return got


def zero(counted):
    for fn in counted.values():
        fn.launches = 0
        if hasattr(fn, "quant_launches"):
            fn.quant_launches = 0


def snapshot(model, optimizer):
    import copy

    return ({k: v.detach().clone() for k, v in model.state_dict().items()},
            copy.deepcopy(optimizer.state_dict()))


def restore_snapshot(model, optimizer, snap):
    model.load_state_dict(snap[0])
    optimizer.load_state_dict(snap[1])


def check_f32_rollout(torch, trainer, batch, sam_mod):
    """The f32 rollout at R = 1,280 (64 videos x S) on init-scale
    weights, kernel vs plain version with the same seed words: tokens
    and masks exact, log-probs within F32_ATOL."""
    import copy

    from cst_captioning_torch.models import captioner

    cfg = copy.deepcopy(trainer.cfg)
    cfg.model.compute_dtype = "float32"
    m32 = captioner.model_from_config(cfg, device=DEVICE)
    m32.init_weights(torch.Generator().manual_seed(5))
    S, L = cfg.train.cst_num_samples, cfg.data.max_seq_len
    with torch.no_grad():
        cache = captioner._repeat_cache(
            m32._encode(batch.feats, batch.feat_masks,
                        batch.category if m32.use_category else None), S)
    before = sam_mod.lstm_sample.launches

    def rollout():
        return m32.sample_cache(cache, CST_SEED_WORDS, max_len=L,
                                greedy=False)

    k = rollout()
    if sam_mod.lstm_sample.launches != before + 1:
        fail("the f32 rollout did not launch the lstm_sample kernel")
    captioner.lstm_sample = sam_mod.lstm_sample_ref
    try:
        p = rollout()
    finally:
        captioner.lstm_sample = sam_mod.lstm_sample
    R = k.tokens.shape[0]
    tok_diff = int((k.tokens != p.tokens).sum())
    mask_diff = int((k.mask != p.mask).sum())
    lp_err = float((k.logprobs - p.logprobs).abs().max())
    log(f"CST rollout f32 R={R} T={L} kernel vs plain: {tok_diff} tokens and "
        f"{mask_diff} mask entries differ, max |logprob diff| {lp_err:.3e}; "
        f"mean length {float(k.mask.sum(1).mean()):.2f}")
    if R != B * S or tok_diff or mask_diff or not lp_err <= F32_ATOL:
        fail("the f32 CST rollout through the kernel disagrees with the "
             "plain version")
    return {"rows": R, "tokens_differ": tok_diff, "max_abs_err": lp_err}


def check_pg_loss(torch, trainer, last, swap):
    """The PG loss and gradients at float32 on the last step's tokens,
    mask and advantage, through the recurrence kernel vs through its
    plain forward and backward (``swap``): loss within XE_LOSS_RTOL,
    gradient gap within XE_GRAD_GAP (phase 4's bounds)."""
    import copy

    from cst_captioning_torch.models import captioner
    from cst_captioning_torch.training import cst as cst_mod

    cfg = copy.deepcopy(trainer.cfg)
    cfg.model.compute_dtype = "float32"
    m32 = captioner.model_from_config(cfg, device=DEVICE)
    m32.load_state_dict(trainer.model.state_dict())
    params = list(m32.parameters())

    def run(plain=False):
        if plain:
            setattr(captioner, swap[0], swap[1])
        try:
            loss = cst_mod.pg_loss(
                m32, last["feats"], last["masks"], cfg.train.cst_num_samples,
                last["tokens"], last["mask"], last["adv"],
                cfg.train.sample_temperature,
                category=last.get("category"))
            return float(loss.detach()), torch.autograd.grad(loss, params)
        finally:
            setattr(captioner, swap[0], swap[2])

    k, p = run(), run(plain=True)
    loss_rtol, gap = step_gap(torch, k, p)
    log(f"CST PG loss f32 kernel vs plain: {k[0]:.7f} vs {p[0]:.7f} (rtol "
        f"{loss_rtol:.3e}), |grad diff| / |grad| {gap:.3e}")
    if not loss_rtol <= XE_LOSS_RTOL or not gap <= XE_GRAD_GAP:
        fail("the f32 PG loss through the kernel disagrees with the plain "
             "version")
    return {"loss_rtol": loss_rtol, "grad_gap": gap}


def check_scorer(torch, trainer, train_ds, batch, last, metrics):
    """The native scorer on the last step's tokens: its mean is the
    step's reward (bitwise), and it agrees with the Python scorer within
    SCORER_RTOL / SCORER_ATOL; both timed per 1,280 rows (host clock)."""
    import numpy as np

    from cst_captioning_torch.training.rewards import CiderDRewarder

    scorer = trainer._train_step.scorer
    S = trainer.cfg.train.cst_num_samples
    vid = np.repeat(batch.video_idx.cpu().numpy(), S)
    toks = last["tokens"].cpu().numpy()
    t0 = time.perf_counter()
    for _ in range(REPS):
        nat = scorer.score_ids(vid, toks)
    nat_ms = (time.perf_counter() - t0) * 1e3 / REPS
    py = CiderDRewarder(train_ds, backend="python",
                        weighted_refs=trainer.cfg.train.cst_weighted_reward)
    t0 = time.perf_counter()
    want = py.score_ids(vid, toks)
    py_ms = (time.perf_counter() - t0) * 1e3
    diff = np.abs(nat - want)
    log(f"CST scorer on the card's {len(vid)} rows: native {nat_ms:.3f} ms, "
        f"python {py_ms:.3f} ms; {int((nat != want).sum())} rows differ, "
        f"max |diff| {float(diff.max()):.3e}; mean reward {float(nat.mean()):.6f}"
        f", {int((nat > 0).sum())} rows > 0")
    if float(nat.mean()) != metrics["reward"]:
        fail("the native scorer's rewards are not the step's reward")
    if not np.all(diff <= SCORER_ATOL + SCORER_RTOL * np.abs(want)):
        fail("the native scorer disagrees with the Python scorer")
    return {"native_ms_per_1280_rows": nat_ms, "python_ms_per_1280_rows": py_ms,
            "rows_differ": int((nat != want).sum()),
            "max_abs_diff": float(diff.max())}


def check_overlap_parity(torch, trainer, batch):
    """``overlap_rewards`` on, off and on again, one step each from the
    same state and seed (deterministic algorithms on): rewards, loss and
    parameters bitwise equal."""
    import copy

    from cst_captioning_torch.training import cst as cst_mod

    model, opt = trainer.model, trainer.optimizer
    scorer = trainer._train_step.scorer
    snap = snapshot(model, opt)
    out = []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for overlap in (True, False, True):
            cfg = copy.deepcopy(trainer.cfg)
            cfg.train.overlap_rewards = overlap
            step = cst_mod._make_split_step(model, opt, cfg, scorer)
            restore_snapshot(model, opt, snap)
            m, phases, wall, _ = run_cst_step(torch, step, batch, 77)
            out.append((m, {k: v.detach().clone()
                            for k, v in model.state_dict().items()},
                        wall, phases))
    finally:
        torch.use_deterministic_algorithms(False)
        restore_snapshot(model, opt, snap)

    def same(a, b):
        return (all(a[0][k] == b[0][k]
                    for k in ("reward", "baseline", "advantage"))
                and float(a[0]["loss"]) == float(b[0]["loss"])
                and all(torch.equal(v, b[1][k]) for k, v in a[1].items()))

    on_off, on_on = same(out[0], out[1]), same(out[0], out[2])
    log(f"CST overlap on vs off bitwise: {on_off}; on vs on again (the "
        f"update's determinism): {on_on}; wall ms on / off / on "
        f"{[round(o[2], 3) for o in out]} (deterministic algorithms on), "
        f"phases {[o[3] for o in out]}")
    if not on_on:
        fail("two identical CST steps differ: the update is not "
             "deterministic, so overlap parity cannot be read")
    if not on_off:
        fail("CST overlap on and off differ")
    return {"bitwise": on_off, "wall_ms_on_off_on": [o[2] for o in out]}


def check_cst(torch, card: str, start: dict, counted: dict, swap, sam_mod,
              save_to: str):
    """Phase 5, see the module docstring.  ``start`` maps each fusion to
    phase 4's ``best`` checkpoint; ``counted`` names the wrappers whose
    launches are held (the meanpool path's, the attention path's);
    ``swap`` = (captioner attribute, plain recurrence, kernel wrapper)
    for the f32 PG loss check; ``sam_mod`` the sampler's module.  The
    meanpool model after its CST steps is saved as the checkpoint
    ``save_to`` (phase 6 evaluates it)."""
    from cst_captioning_torch.training import checkpoint as ckpt_mod
    from cst_captioning_torch.training import cst as cst_mod

    res = {"steps": []}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        trainer, train_ds, batches = cst_trainer(
            torch, "meanpool", start["meanpool"], tmp)
        cfg = trainer.cfg
        S, B_ = cfg.train.cst_num_samples, cfg.data.batch_size
        Kc = cst_mod._chunk_count(cfg.train.cst_score_chunks, B_)
        log(f"CST trainer ({CST_PRESET}, meanpool, S={S}, {B_} videos a "
            f"step, {Kc} chunks, {cfg.train.cst_baseline} baseline, native "
            f"scorer) warm-started from {start['meanpool']} in "
            f"{time.perf_counter() - t0:.1f} s")
        step = trainer._train_step
        windows, last, restore = cst_probe(torch, trainer.model)
        try:
            run_cst_step(torch, step, batches[0], 1, windows)  # warm-up
            before = snapshot(trainer.model, trainer.optimizer)[0]
            mp = counted["meanpool"]
            zero(mp)
            timed = [run_cst_step(torch, step, batches[i % len(batches)],
                                  10 + i, windows) for i in range(CST_TIMED)]
            res["launches_scb"] = hold_launches(
                mp, {"lstm_sample": CST_TIMED * Kc,
                     "lstm_recurrence": CST_TIMED,
                     "row_gemm": CST_TIMED * (2 + Kc)},
                f"CST, {CST_TIMED} scb steps")
            for i, (m, ph, wall, dev) in enumerate(timed):
                res["steps"].append(log_cst_step(
                    f"meanpool scb {i}", m, ph, wall, dev, card))
            moved = any(not torch.equal(v, trainer.model.state_dict()[k])
                        for k, v in before.items())
            finite = all(bool(torch.isfinite(p).all())
                         for p in trainer.model.parameters())
            if not moved or not finite:
                fail(f"CST parameters moved: {moved}, finite: {finite}")
            batch = batches[(CST_TIMED - 1) % len(batches)]
            res["scorer"] = check_scorer(torch, trainer, train_ds, batch,
                                         last, timed[-1][0])
            res["pg_loss_f32"] = check_pg_loss(torch, trainer, last, swap)
            # After the checks that read the last timed step's update.
            res["trace"] = check_cst_trace(torch, trainer, step,
                                           batches[0], tmp)

            gcfg = copy_cfg(cfg, cst_baseline="greedy")
            gstep = cst_mod._make_split_step(trainer.model, trainer.optimizer,
                                             gcfg, step.scorer)
            zero(mp)
            g = run_cst_step(torch, gstep, batches[0], 20, windows)
            res["launches_greedy"] = hold_launches(
                mp, {"lstm_sample": 2 * Kc, "lstm_recurrence": 1,
                     "row_gemm": 2 + 2 * Kc}, "CST, one greedy-baseline step")
            res["greedy_step"] = log_cst_step("meanpool greedy", *g, card)
            # A reading, not held: the rollout as one 1,280-row call.
            k1 = cst_mod._make_split_step(
                trainer.model, trainer.optimizer,
                copy_cfg(cfg, cst_score_chunks=1), step.scorer)
            run_cst_step(torch, k1, batches[1], 30, windows)
            res["k1_step"] = log_cst_step(
                "meanpool scb, one chunk (a reading)",
                *run_cst_step(torch, k1, batches[2], 31, windows), card)
            ckpt_mod.save_checkpoint(save_to, trainer.model,
                                     trainer.optimizer, {"phase": 5})
        finally:
            restore()
        res["overlap"] = check_overlap_parity(torch, trainer, batches[0])
        res["rollout_f32"] = check_f32_rollout(torch, trainer, batches[0],
                                               sam_mod)
        del trainer, batches

        atrainer, _, abatches = cst_trainer(
            torch, "attention", start["attention"], os.path.join(tmp, "att"),
            train_ds)
        windows, _, restore = cst_probe(torch, atrainer.model)
        try:
            run_cst_step(torch, atrainer._train_step, abatches[0], 1, windows)
            zero(counted["attention"])
            a = run_cst_step(torch, atrainer._train_step, abatches[1], 2,
                             windows)
            res["launches_attention"] = hold_launches(
                counted["attention"],
                {"attlstm_sample": Kc, "attlstm_recurrence": 1,
                 "attlstm_recurrence_bwd": 1, "row_gemm": 3},
                "CST, one attention scb step")
            res["attention_step"] = log_cst_step("attention scb", *a, card)
        finally:
            restore()
    return res


def check_cst_trace(torch, trainer, step, batch, tmp: str):
    """3e.g: one meanpool CST step, then the trainer's ``train.trace_file``
    export (``Trainer._export_trace``, what ``fit`` ends with): the step's
    ``cst/step`` span holds its ``phase/*`` spans, and each phase's spans
    sum to its ``phase_ms`` within 0.5 ms (the root to ``total_ms``)."""
    from cst_captioning_torch.observability import (
        get_tracer,
        validate_chrome_trace,
    )

    get_tracer().clear()
    _, phases, _, _ = run_cst_step(torch, step, batch, 40)
    path = os.path.join(tmp, "cst_trace.json")
    trainer.cfg.train.trace_file = path
    try:
        trainer._export_trace()
    finally:
        trainer.cfg.train.trace_file = ""
    with open(path) as f:
        x = [e for e in validate_chrome_trace(json.load(f))["traceEvents"]
             if e["ph"] == "X"]
    roots = [e for e in x if e["name"] == "cst/step"]
    if len(roots) != 1:
        fail(f"3e.g: {len(roots)} cst/step spans for one step")
    root = roots[0]
    kids = [e for e in x if e["args"].get("parent_id")
            == root["args"]["span_id"]]
    span_ms = {}
    for e in kids:
        key = e["name"][len("phase/"):] + "_ms"
        span_ms[key] = span_ms.get(key, 0.0) + e["dur"] / 1e3
    want = {k: v for k, v in phases.items() if k != "total_ms"}
    gaps = {k: abs(span_ms.get(k, -1e9) - v) for k, v in want.items()}
    root_gap = abs(root["dur"] / 1e3 - phases["total_ms"])
    inside = all(root["ts"] <= e["ts"] and e["ts"] + e["dur"]
                 <= root["ts"] + root["dur"] + 1e-3 for e in kids)
    log(f"3e.g train.trace_file: cst/step {root['dur'] / 1e3:.3f} ms "
        f"(total_ms {phases['total_ms']}), phase spans "
        f"{ {k: round(v, 3) for k, v in span_ms.items()} } vs phase_ms "
        f"{want}; max gap {max(gaps.values()):.4f} ms")
    if set(span_ms) != set(want) or max(gaps.values()) > 0.5 or \
            root_gap > 0.5 or not inside:
        fail("3e.g: the step's spans do not cover its phases")
    return {"phase_span_ms": span_ms, "phase_ms": phases,
            "max_gap_ms": max(gaps.values()), "root_gap_ms": root_gap}


def copy_cfg(cfg, **train):
    import copy

    out = copy.deepcopy(cfg)
    for k, v in train.items():
        setattr(out.train, k, v)
    return out


def att_kernel_entries(res, rec, launches, train):
    """The four attention kernels' entries of the ``kernels`` line."""
    bf, bb, bt = att_decode_work(B * K, 2, B * K * T * 4 + B * K * 4)
    bf32 = att_decode_work(B * K, 4, B * K * T * 4 + B * K * 4)
    sf, sb, st = att_decode_work(B, 2, 3 * B * T * 4)
    sf32 = att_decode_work(B, 4, 3 * B * T * 4)
    (ff, fb, ft), (gf, gb, gt) = att_rec_work(R_XE, T_XE, 2, ATT_REP)
    (ff32, fb32, _), (gf32, gb32, _) = att_rec_work(R_XE, T_XE, 4, ATT_REP)
    fwd1, bwd1 = att_rec_work(R_XE, T_XE, 2, 1)
    common = {"route": "cuda", "library_ms": None,
              "library": "none (no single call)", "dtype": "bfloat16"}
    dec = dict(common, tolerance=ATT_TOLERANCE)
    out = []
    for name, src, line, key, n, (fl, by, th), f32w in (
            ("attlstm_beam", "lstm_beam.cu", "pallas_beam.py:649", "beam",
             launches["beam"], (bf, bb, bt), bf32),
            ("attlstm_sample", "lstm_sample.cu", "pallas_sampler.py:643",
             "sample", launches["greedy"], (sf, sb, st), sf32)):
        bound, by_what = bound_ms(fl, by, H100_BF16_FLOPS)
        out.append(dict(
            dec, name=name,
            source=f"cst_captioning_torch/csrc/{src}",
            replaces=f"{REFERENCE}/ops/{line}", launches=n,
            max_abs_err=res[f"{key}_bf16_err"], ms=res[f"{key}_ms_bf16"],
            plain_ms=res[f"{key}_plain_ms_bf16"], bound_ms=bound,
            bound_by=by_what, sfu_floor_ms=sfu_floor_ms(th),
            bf16_order_witness=res["order_witness"],
            launches_per_call_bf16=res["launches_per_call_bf16"][
                "beam" if key == "beam" else "greedy"],
            bf16_row_invariance=res["row_invariance"],
            max_abs_err_f32=res[f"{key}_f32_err"],
            ms_f32=res[f"{key}_ms_f32"],
            plain_ms_f32=res[f"{key}_plain_ms_f32"],
            bound_ms_f32=bound_ms(f32w[0], f32w[1], H100_F32_FLOPS)[0]))
    out[1]["train_launches"] = train["launches"]["attlstm_sample"]
    out[1].update({k: v for k, v in res.items()
                   if k.startswith("sample_multinomial_ms_")})
    rec_common = dict(common, tolerance=ATT_TOL_TEXT,
                      source="cst_captioning_torch/csrc/attlstm_recurrence.cu")
    rec_common.update(rep=ATT_REP, order_witness_bf16=rec["order_witness"],
                      launches_per_call_bf16=rec["launches_per_call"],
                      tanh_table_exact=rec["tanh_table_exact"])
    fbound, fby, fterm = rec_bound(ff, fb, ft, H100_BF16_FLOPS)
    f1 = rec_bound(*fwd1, H100_BF16_FLOPS)
    out.append(dict(
        rec_common, name="attlstm_recurrence",
        replaces=f"{REFERENCE}/ops/pallas_attlstm.py:544",
        launches=train["launches"]["attlstm_recurrence"],
        max_abs_err=rec["bf16_err"], ms=rec["ms_bf16"],
        plain_ms=rec["plain_ms_bf16"], bound_ms=fbound, bound_by=fby,
        bound_term=fterm, bound_ms_rep1=f1[0], bound_term_rep1=f1[2],
        ms_rep1=rec["ms_rep1_bf16"], rep_forward_bitwise=rec["rep_forward"],
        edge_shapes=rec["edge_shapes"],
        bf16_share_differing=rec["bf16_share_differing"],
        sfu_floor_ms=sfu_floor_ms(ft), max_abs_err_f32=rec["f32_err"],
        ms_f32=rec["ms_f32"], plain_ms_f32=rec["plain_ms_f32"],
        bound_ms_f32=rec_bound(ff32, fb32, ft, H100_F32_FLOPS)[0],
        ms_no_residuals=rec["ms_nores_bf16"],
        ms_no_residuals_f32=rec["ms_nores_f32"],
        grad_rel_f32=rec["grad_rel"],
        xe_step_f32_vs_plain=train["xe_f32"],
        train_steps_per_sec=train["steps_per_sec"],
        xe_step_ms=train["step_ms"]))
    gbound, gby, gterm = rec_bound(gf, gb, gt, H100_BF16_FLOPS)
    g1 = rec_bound(*bwd1, H100_BF16_FLOPS)
    out.append(dict(
        rec_common, name="attlstm_recurrence_bwd",
        replaces=f"{REFERENCE}/ops/pallas_attlstm.py:578",
        launches=train["launches"]["attlstm_recurrence_bwd"],
        max_abs_err=rec["bwd_bf16_err"], ms=rec["bwd_ms_bf16"],
        plain_ms=rec["bwd_plain_ms_bf16"], bound_ms=gbound, bound_by=gby,
        bound_term=gterm, bound_ms_rep1=g1[0], bound_term_rep1=g1[2],
        ms_rep1=rec["bwd_ms_rep1_bf16"], fold_f32=rec["fold_f32"],
        fold_bf16=rec["fold_bf16"],
        sfu_floor_ms=sfu_floor_ms(gt), max_abs_err_f32=rec["bwd_f32_err"],
        grad_rel_f32=rec["bwd_grad_rel"], bf16_ulps=rec["bwd_bf16_ulps"],
        max_abs_err_note="backward kernel vs plain on the same residuals, "
                         "over the seven cotangents",
        ms_f32=rec["bwd_ms_f32"], plain_ms_f32=rec["bwd_plain_ms_f32"],
        bound_ms_f32=rec_bound(gf32, gb32, gt, H100_F32_FLOPS)[0],
        ms_note="includes the three weight contractions done outside the "
                "kernel (torch.matmul), as the reference's _vjp_bwd"))
    return out


def continuous_kernel_entries(cres, rgres, cont, bres, ss):
    """The ``fused_context_attention`` and ``row_gemm`` entries of the
    ``kernels`` line: launches from the bf16 continuous runs (phase 3c),
    times and errors from phases 2e and 2f; the forward's time at the
    training shape (2g) and its launches in the scheduled-sampling run
    (4c)."""
    R = B * K
    runs = {f"{f} {m}": cont[f][f"{m}_bf16"]["launches"]
            for f in ("meanpool", "attention") for m in ("beam", "greedy")}
    cb, cby = ctx_bound(R, B, 2)
    ctx = dict(
        name="fused_context_attention", route="cuda",
        source="cst_captioning_torch/csrc/context_attention.cu",
        replaces=f"{REFERENCE}/ops/pallas_attention.py:214",
        launches=sum(r["fused_context_attention"] for r in runs.values()),
        launches_by_run={k: r["fused_context_attention"]
                         for k, r in runs.items()},
        max_abs_err=cres[f"err_bf16_R{R}"],
        ms=cres[f"device_ms_bf16_R{R}"],
        plain_ms=cres[f"plain_ms_bf16_R{R}"], bound_ms=cb, bound_by=cby,
        library_ms=None, library="none (no single call)",
        ms_note="ms, ms_f32, ms_greedy_R64 and ms_train_shape: profiler "
                "device time per call, from a window that recorded every "
                "launch; event_ms*: the event clock, which reads the "
                "host's enqueue at these sizes",
        event_ms=cres[f"ms_bf16_R{R}"], event_ms_f32=cres[f"ms_f32_R{R}"],
        launches_per_call_bf16=cres["launches_per_call_bf16"],
        tolerance=CTX_TOLERANCE, dtype="bfloat16",
        shape=f"R={R} rows over {B} videos (rep={K}), F={F_ATT}, "
              f"A={A_ATT}, E={E}",
        max_abs_err_f32=cres[f"err_f32_R{R}"],
        ms_f32=cres[f"device_ms_f32_R{R}"],
        plain_ms_f32=cres[f"plain_ms_f32_R{R}"],
        bound_ms_f32=ctx_bound(R, B, 4)[0],
        gathered_rep1_ms=cres[f"gathered_ms_bf16_R{R}"],
        gathered_rep1_ms_f32=cres[f"gathered_ms_f32_R{R}"],
        ms_greedy_R64=cres[f"device_ms_bf16_R{B}"],
        event_ms_greedy_R64=cres[f"ms_bf16_R{B}"],
        bound_ms_greedy_R64=ctx_bound(B, B, 2)[0],
        sfu_floor_ms=sfu_floor_ms(ctx_work(R, B, 2)[2]),
        edge_cases=cres["edges"],
        train_shape=f"R={R_XE} rows over {R_XE // CTXB_REP} videos "
                    f"(rep={CTXB_REP}), weights written",
        ms_train_shape=bres["fwd_device_ms_bf16"],
        event_ms_train_shape=bres["fwd_ms_bf16"],
        ms_train_shape_f32=bres["fwd_device_ms_f32"],
        bound_ms_train_shape=bres["fwd_bound_bf16"][0],
        bound_ms_train_shape_f32=bres["fwd_bound_f32"][0],
        ss_train_launches=ss["launches"]["fused_context_attention"])
    fl, by = rg_work(R, H, V, 2, 2)
    rb, rby = bound_ms(fl, by, H100_BF16_FLOPS)
    rg = dict(
        name="row_gemm", route="cuda",
        source="cst_captioning_torch/csrc/row_gemm.cu",
        replaces=f"{REFERENCE}/models/captioner.py:408",
        replaces_note="no TPU kernel: the per-step decoder's products "
                      "(query, gates, vocab) and the admission encode's "
                      "projections, which the reference leaves to XLA; "
                      "the kernel makes them row-invariant",
        launches=sum(r["row_dot"] for r in runs.values()),
        launches_by_run={k: r["row_dot"] for k, r in runs.items()},
        max_abs_err=rgres["err_bf16"], ms=rgres["ms_bf16"],
        plain_ms=rgres["plain_ms_bf16"], bound_ms=rb, bound_by=rby,
        library_ms=rgres["library_ms_bf16"],
        library="torch.matmul on the rounded operands (cuBLAS sgemm)",
        ms_note="ms, library_ms and by_shape: profiler device time per "
                "call; event_ms: the event clock, which reads the host's "
                "enqueue rate at these sizes",
        event_ms=rgres["event_ms_bf16"], by_shape=rgres["shapes"],
        tolerance=RG_TOLERANCE, dtype="bfloat16",
        shape=f"vocab product R={R}, K={H}, N={V}",
        max_abs_err_f32=rgres["err_f32"], ms_f32=rgres["ms_f32"],
        plain_ms_f32=rgres["plain_ms_f32"],
        library_ms_f32=rgres["library_ms_f32"],
        bound_ms_f32=bound_ms(*rg_work(R, H, V, 4, 4), H100_F32_FLOPS)[0],
        cublas_rows_differing=rgres["cublas_rows_differing"],
        continuous_serving=cont)
    return [ctx, rg]


def ss_kernel_entry(bres, ss):
    """The ``fused_context_attention_bwd`` entry of the ``kernels`` line:
    launches from the scheduled-sampling run (phase 4c), times and
    errors from phase 2g."""
    nv = R_XE // CTXB_REP
    return dict(
        name="fused_context_attention_bwd", route="cuda",
        source="cst_captioning_torch/csrc/context_attention_bwd.cu",
        replaces=f"{REFERENCE}/ops/pallas_attention.py:202",
        launches=ss["launches"]["fused_context_attention_bwd"],
        launches_by_epoch={str(e): c["fused_context_attention_bwd"]
                           for e, c in ss["per_epoch"].items()},
        max_abs_err=bres["err_bf16"], ms=bres["device_ms_bf16"],
        plain_ms=bres["plain_ms_bf16"], bound_ms=bres["bound_bf16"][0],
        bound_by=bres["bound_bf16"][1], library_ms=None,
        ms_note="ms and ms_f32: profiler device time per call (both "
                "launches), from a window that recorded every launch; "
                "event_ms*: the event clock",
        event_ms=bres["ms_bf16"], event_ms_f32=bres["ms_f32"],
        launches_per_call_bf16=bres["launches_per_call_bf16"],
        edge_cases=bres["edges"],
        library="none (no single call)", tolerance=CTXB_TOLERANCE,
        dtype="bfloat16",
        shape=f"R={R_XE} rows over {nv} videos (rep={CTXB_REP}), "
              f"F={F_ATT}, A={A_ATT}, E={E}",
        sfu_floor_ms=sfu_floor_ms(ctxb_work(R_XE, nv, 2)[2]),
        bf16_ulps=bres["bf16_ulps"], rel_err_f32=bres["rel_f32"],
        gathered_rel_f32=bres["gathered_rel"],
        max_abs_err_f32=bres["err_f32"], ms_f32=bres["device_ms_f32"],
        plain_ms_f32=bres["plain_ms_f32"], bound_ms_f32=bres["bound_f32"][0],
        ss_fed_share=ss["fed_share"], ss_fed_sigmas=ss["fed_sigmas"],
        ss_train_steps_per_sec=ss["steps_per_sec"],
        ss_step_f32_vs_plain=ss["step_f32_vs_plain"],
        ss_step_f32_vs_fused=ss["step_f32_vs_fused"],
        ss_step_bf16_vs_plain=ss["step_bf16_vs_plain"],
        ss_step_ms=ss["step_ms"])


def quant_kernel_entries(qdec, qrec, qlad, qfwd, cont, rgres):
    """The six int8w kernels' entries of the ``kernels`` line: launches
    from phase 3d's ladder runs (decoders) and teacher-forced forwards
    (recurrences), times and errors from phases 2h and 2i; and the int8
    row_gemm's readings, which join the row_gemm entry."""
    out = []
    for fusion, p in (("meanpool", ""), ("attention", "att")):
        r, att = qdec[fusion], fusion == "attention"
        tol = Q_ATT_TOLERANCE if att else Q_TOLERANCE
        for kind, src, line, rows, outb in (
                ("beam", "lstm_beam.cu",
                 "pallas_beam.py:649" if att else "pallas_beam.py:687",
                 B * K, B * K * T * 4 + B * K * 4),
                ("sample", "lstm_sample.cu",
                 "pallas_sampler.py:643" if att else "pallas_sampler.py:682",
                 B, 3 * B * T * 4)):
            fl, by = q_decode_work(rows, att, outb)
            bound, by_what = bound_ms(fl, by, H100_BF16_FLOPS)
            mode = "beam" if kind == "beam" else "greedy"
            out.append(dict(
                name=f"{p}lstm_{kind}_q", route="cuda",
                source=f"cst_captioning_torch/csrc/{src}",
                replaces=f"{REFERENCE}/ops/{line}",
                replaces_note="the quant= mode of the same pallas_call",
                launches=qlad[fusion][mode],
                max_abs_err=r[f"{kind}_bf16_err"], ms=r[f"{kind}_ms_bf16"],
                plain_ms=r[f"{kind}_plain_ms_bf16"], bound_ms=bound,
                bound_by=by_what, library_ms=None, library=Q_LIBRARY,
                tolerance=tol, dtype="int8 weights, bfloat16 compute",
                launches_per_call_bf16=(r["launches_per_call_bf16"] or {}).get(
                    mode),
                max_abs_err_f32=r[f"{kind}_f32_err"],
                ms_f32=r[f"{kind}_ms_f32"],
                plain_ms_f32=r[f"{kind}_plain_ms_f32"]))
    for fusion, name, line, key in (
            ("meanpool", "lstm_recurrence_q", "pallas_lstm.py:342", "lstm"),
            ("attention", "attlstm_recurrence_q", "pallas_attlstm.py:687",
             "att")):
        r = qrec[key]
        att = key == "att"
        bound, by_what, term = rec_bound(*q_rec_work(R_XE, T_XE, att),
                                         H100_BF16_FLOPS)
        out.append(dict(
            name=name, route="cuda",
            source="cst_captioning_torch/csrc/"
                   + ("attlstm_recurrence.cu" if att else "lstm_recurrence.cu"),
            replaces=f"{REFERENCE}/ops/{line}",
            replaces_note="via the same pallas_call with quant=True",
            launches=qfwd[fusion]["launches"], max_abs_err=r["bf16_err"],
            ms=r["ms_bf16"], plain_ms=r["plain_ms_bf16"], bound_ms=bound,
            bound_by=by_what, bound_term=term, library_ms=None,
            library=Q_LIBRARY,
            tolerance=QREC_TOLERANCE, dtype="int8 weights, bfloat16 compute",
            bf16_ulps=r["bf16_ulps"], max_abs_err_f32=r["f32_err"],
            ms_f32=r["ms_f32"], plain_ms_f32=r["plain_ms_f32"],
            forward_logit_err_f32=qfwd[fusion]["logit_err_f32"]))
    runs = {f"{f} {m}": cont[f][f"{m}_int8w"]["launches"]
            for f in ("meanpool", "attention") for m in ("beam", "greedy")}
    fl, by = rg_work(B * K, H, V, 1, 2)
    by += V * 4
    rg_int8 = dict(
        launches_int8=sum(r["row_dot_quant"] for r in runs.values()),
        launches_int8_by_run={k: r["row_dot_quant"] for k, r in runs.items()},
        ms_int8=rgres["ms_int8_bf16"], plain_ms_int8=rgres["plain_ms_int8_bf16"],
        library_ms_int8=rgres["library_ms_int8_bf16"],
        library_int8="torch.matmul on the dequantized W (cuBLAS sgemm)",
        bound_ms_int8=bound_ms(fl, by, H100_BF16_FLOPS)[0],
        max_abs_err_int8=rgres["err_int8_bf16"],
        ms_int8_f32=rgres["ms_int8_f32"],
        max_abs_err_int8_f32=rgres["err_int8_f32"])
    return out, rg_int8


def add_cst_readings(kernels, cst):
    """Phase 5's launches (``cst_launches``, per run) on the entries of
    the kernels the CST path ran, and its readings on the main path's
    two kernels' entries."""
    runs = {f"scb_steps_{CST_TIMED}": cst["launches_scb"],
            "greedy_step": cst["launches_greedy"],
            "attention_scb_step": cst["launches_attention"]}
    for k in kernels:
        got = {run: counts[k["name"]] for run, counts in runs.items()
               if k["name"] in counts}
        if got:
            k["cst_launches"] = got
    by_name = {k["name"]: k for k in kernels}
    by_name["lstm_sample"]["cst_rollout_f32_vs_plain"] = cst["rollout_f32"]
    by_name["lstm_recurrence"].update(
        cst_pg_loss_f32_vs_plain=cst["pg_loss_f32"],
        cst_steps_ms=cst["steps"], cst_greedy_step_ms=cst["greedy_step"],
        cst_scorer=cst["scorer"], cst_overlap=cst["overlap"],
        cst_one_chunk_step_ms=cst["k1_step"], cst_trace_file=cst["trace"])
    by_name["attlstm_recurrence"]["cst_step_ms"] = cst["attention_step"]


# ------------------------------------------------------------ phase 5b

OVERLAP_CHUNKS = 4
OVERLAP_STEPS = 5
OVERLAP_REPS = 3
OVERLAP_BATCH = 48           # simulate's default batch
OVERLAP_ROLLOUT_CALLS = 4    # simulate's rollout timing: 1 warm-up + 3
OVERLAP_MAX_LEN = 10         # simulate's max_seq_len: a draw's most steps
OVERLAP_KEYS = (
    "cst_overlap_sim_dispatch_latency_ms",
    "cst_overlap_sim_rollout_compute_ms",
    "cst_overlap_sim_injected_scorer_ms",
    "cst_overlap_sim_k1_step_ms",
    f"cst_overlap_sim_k{OVERLAP_CHUNKS}_step_ms",
    "cst_overlap_sim_recovered_ms",
    "cst_overlap_sim_recoverable_ms",
    "cst_overlap_sim_recovered_frac",
    "cst_overlap_sim_reps",
    "cst_overlap_sim_noisy",
)


MASKED_V = 40     # a vocab the kernel pads to 128 columns
MASKED_COLS = ("PAD", "BOS", "padding", "last padding")


def check_masked_draw(torch, sam_mod):
    """The multinomial samplers give masked columns (PAD, BOS, the
    padding past V) no Gumbel draw: with a seed that puts the +inf draw
    on such a column at row 0, step 0, no masked id is sampled, every id
    is below V, and f32 tokens equal the plain version's.  meanpool at
    f32 and bf16 (the tensor-core chain), attention at f32; not counted
    as launches of the main path."""
    from cst_captioning_torch.constants import BOS_ID, PAD_ID
    from cst_captioning_torch.ops.decode_common import seed_for_inf_draw

    g = torch.Generator().manual_seed(17)
    V, E, H, Bm, F, A = MASKED_V, 32, 32, 4, 3, 32
    r = lambda *s: (torch.randn(*s, generator=g) * 0.3).to(DEVICE)  # noqa
    mp = [r(Bm, 4 * H), r(E, 4 * H), r(H, 4 * H)]
    att = [r(E, 4 * H), r(H, A), r(A, 1), r(Bm, F, A),
           torch.ones(Bm, F, device=DEVICE), r(Bm, F, E)]
    tail = [r(V, E), r(H, V), r(V)]
    cols = dict(zip(MASKED_COLS, (PAD_ID, BOS_ID, V, 127)))
    cases = [("meanpool f32", sam_mod.lstm_sample, sam_mod.lstm_sample_ref,
              mp + tail, None),
             ("meanpool bf16", sam_mod.lstm_sample, sam_mod.lstm_sample_ref,
              mp + tail, torch.bfloat16),
             ("attention f32", sam_mod.attlstm_sample,
              sam_mod.attlstm_sample_ref, mp + att + tail, None)]
    out = {}
    for what, fn, ref, ops, cdt in cases:
        # bf16: the weights (w_x, wh, emb, w_out) in bf16, gx_static and
        # b_out in f32, as ``to_card`` casts them.
        n = len(ops)
        args = ops if cdt is None else [
            x.to(cdt) if i in (1, 2, n - 3, n - 2) else x
            for i, x in enumerate(ops)]
        for name, col in cols.items():
            kw = dict(max_len=4, greedy=False)
            k_tok = fn(*args, seed_for_inf_draw(col), **kw)[0].cpu()
            p_tok = ref(*args, seed_for_inf_draw(col), **kw)[0].cpu()
            first = int(k_tok[0, 0])
            bad = (first in (PAD_ID, BOS_ID, col)
                   or int(k_tok.max()) >= V or int(k_tok.min()) < 0)
            same = bool(torch.equal(k_tok, p_tok))
            out[f"{what}, {name}"] = {"first": first, "equal_plain": same}
            if bad or (cdt is None and not same):
                fail(f"masked draw, {what}, the +inf draw on the {name} "
                     f"column ({col}): kernel tokens {k_tok.tolist()}, "
                     f"plain {p_tok.tolist()}")
    log(f"masked columns never drawn (V = {V}, the +inf draw at row 0, "
        f"step 0): {out}")
    return out


def check_overlap_sim(torch, card: str, counted):
    """Phase 5b: ``tools/overlap_sim.simulate`` at the reference's
    defaults.  Held: every key, the fraction in [0, 1], and the launches
    of the steps it ran (each layout's warm-up step and every timed step
    of every rep: one ``lstm_recurrence`` a step).  Its preset
    (``synthetic_smoke``) leaves ``model.use_pallas_sampler`` off, so
    every multinomial draw (1 + K a step over the two layouts, plus the
    rollout timing's samples) takes the per-step decode as the
    reference's sampler gate sends it: one ``threefry_sample`` launch a
    decode step it ran (counted by its ``decode_logits`` calls) and no
    ``lstm_sample``.  ``noisy`` is reported, not held."""
    from cst_captioning_torch.models.captioner import CaptionModel
    from cst_captioning_torch.ops import sampler as sam_mod
    from cst_captioning_torch.tools import overlap_sim
    from cst_captioning_torch.training.cst import _chunk_count

    masked = check_masked_draw(torch, sam_mod)
    zero(counted)
    decode_calls = [0]
    inner = CaptionModel.decode_logits

    def counting(self, *a, **kw):
        decode_calls[0] += 1
        return inner(self, *a, **kw)

    CaptionModel.decode_logits = counting
    t0 = time.perf_counter()
    try:
        out = overlap_sim.simulate(0.0, OVERLAP_CHUNKS, OVERLAP_STEPS,
                                   reps=OVERLAP_REPS, device=DEVICE)
    finally:
        CaptionModel.decode_logits = inner
    wall = time.perf_counter() - t0
    print(json.dumps(out), flush=True)
    missing = [k for k in OVERLAP_KEYS if k not in out]
    if missing:
        fail(f"overlap_sim: keys missing {missing}")
    frac = out["cst_overlap_sim_recovered_frac"]
    if not 0.0 <= frac <= 1.0:
        fail(f"overlap_sim: recovered_frac {frac} outside [0, 1]")
    steps = 1 + out["cst_overlap_sim_reps"] * OVERLAP_STEPS  # per layout
    k = _chunk_count(OVERLAP_CHUNKS, OVERLAP_BATCH)
    draws = OVERLAP_ROLLOUT_CALLS + steps * (1 + k)
    if not draws <= decode_calls[0] <= draws * OVERLAP_MAX_LEN:
        fail(f"5b overlap_sim: {decode_calls[0]} decode steps for {draws} "
             f"multinomial draws of at most {OVERLAP_MAX_LEN} steps")
    launches = hold_launches(
        counted, {"threefry_sample": decode_calls[0],
                  "lstm_recurrence": 2 * steps}, "5b overlap_sim")
    log(f"overlap_sim: K=1 {out['cst_overlap_sim_k1_step_ms']} ms vs "
        f"K={OVERLAP_CHUNKS} "
        f"{out[f'cst_overlap_sim_k{OVERLAP_CHUNKS}_step_ms']} ms a step; "
        f"recovered {out['cst_overlap_sim_recovered_ms']} of "
        f"{out['cst_overlap_sim_recoverable_ms']} ms (frac {frac}, noisy "
        f"{out['cst_overlap_sim_noisy']}, {out['cst_overlap_sim_reps']} "
        f"reps) in {wall:.1f} s  [{card}]")
    return {"result": out, "launches": launches, "wall_s": wall,
            "masked_draw": masked}


# ------------------------------------------------------------ phase 5c

SLOT_SEED_WORDS = (0x0BADF00D, 0x5EED1234)  # 5c's base key (two words)
TF_ROWS = (320, 1280)   # the default slot count, the rollout's sampled rows
TF_STEPS = 3            # decode steps before the logits 5c.a draws from
TF_NEAR_TIE_ULPS = 4
TF_LP_RTOL, TF_LP_ATOL = 1e-5, 4.8e-7
TF_TOLERANCE = (
    f"tokens equal; a row may differ only where the plain version's top "
    f"two noisy values lie within {TF_NEAR_TIE_ULPS} float32 ulps of the "
    f"larger (counted); tok_lp |diff| <= {TF_LP_RTOL:g} x |plain| + "
    f"{TF_LP_ATOL:g} (4 float32 ulps at 1: the log of a sum near 1); no "
    f"masked id drawn")
# int32 operations a sampled element costs in csrc/threefry_sample.cu:
# 20 rounds of add / funnel shift / xor, 12 key adds, the counter's
# 64-bit add, the output xor, the mantissa shift and or.
THREEFRY_INT_OPS = 20 * 3 + 12 + 2 + 1 + 2
# The H100's int32 issue rate: 64 int32 lanes an SM against the 128 FMA
# lanes (2 FLOP each) that give H100_F32_FLOPS.
H100_INT32_OPS = H100_F32_FLOPS / 4
SLOT_GEOMETRIES = (("padded", 0, 1), ("slot", 0, 1), ("slot", 16, 1),
                   ("slot", 0, 2))     # (layout, slots (0: default), block)
SLOT_STEP_RG = {"meanpool": 2, "attention": 3}   # row_gemm a decode step
SLOT_ENCODE_RG = {"meanpool": 2, "attention": 3}  # row_gemm an encode
SLOT_LAYOUTS = ("scan", "padded", "slot")
SLOT_TIMED = 3          # timed CST steps a layout, after one warm-up step
SLOT_TICKS_PROFILED = 3


def tf_work(G: int, n_sample: int, V_: int):
    """(int32 operations, compulsory bytes) of one draw: the sampled
    elements' threefry, the logits read once, the row metadata read and
    the token and log-prob written."""
    return (n_sample * V_ * THREEFRY_INT_OPS,
            G * V_ * 4 + G * (4 + 4 + 1) + G * (8 + 4))


def tf_bound(G: int, n_sample: int, V_: int):
    ops, nbytes = tf_work(G, n_sample, V_)
    t_ops = ops / H100_INT32_OPS * 1e3
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def tf_noisy(torch, tf, x, rows, kw):
    """The plain version's noisy values of rows ``rows`` of ``x`` (the
    scaled logits alone for greedy rows)."""
    cols = torch.arange(x.shape[1], dtype=torch.int64, device=x.device)
    if "base" in kw:
        r0, r1 = tf.row_keys(kw["base"], kw["row_id"][rows], kw["step"][rows])
        y0, y1 = tf.threefry2x32((r0[:, None], r1[:, None]), 0, cols[None, :])
    else:
        c = rows.long()[:, None] * x.shape[1] + cols[None, :]
        y0, y1 = tf.threefry2x32(tf.key_words(kw["key"]), c >> 32,
                                 c & tf.MASK32)
    vals = tf.gumbel_from_bits(y0 ^ y1) + x[rows]
    return torch.where(kw["is_sample"][rows][:, None], vals, x[rows])


def scaled_logits(torch, model, cache, rows: int, L: int, temperature: float):
    """The model's decode-policy logits / T at step TF_STEPS of a
    row-keyed sampled decode of the first ``rows`` rows of ``cache``."""
    from cst_captioning_torch.decoding import core as core_mod

    cache = type(cache)(*(None if x is None else x[:rows] for x in cache))
    st = core_mod.init_core(model.init_state(rows), rows, 1, L, mode="sample")
    fn = core_mod.row_sample_fn(SLOT_SEED_WORDS, torch.arange(
        rows, dtype=torch.int32, device=DEVICE))

    def step_logits(s, tok):
        return model.decode_logits(s, cache, tok)

    with torch.no_grad():
        for _ in range(TF_STEPS):
            st = core_mod.decode_step(step_logits, st, mode="sample",
                                      temperature=temperature, sample_fn=fn)
        _, logits = model.decode_logits(st.state, cache, st.tokens)
    return logits.float() / torch.tensor(temperature, dtype=torch.float32)


def check_threefry_kernel(torch, card: str, model, cache, L: int,
                          temperature: float):
    """5c.a: the kernel vs its plain version on the model's own scaled
    logits at TF_ROWS rows, row-keyed and batch, every fifth row greedy
    (TF_TOLERANCE); device ms (profiler, one launch a call), plain ms
    (events) and the bound."""
    from cst_captioning_torch.ops import threefry as tf

    res = {}
    full = scaled_logits(torch, model, cache, max(TF_ROWS), L, temperature)
    for G in TF_ROWS:
        x = full[:G].contiguous()
        idx = torch.arange(G, device=DEVICE)
        greedy = idx % 5 == 0
        n_sample = int((~greedy).sum())
        modes = {
            "rows": dict(base=SLOT_SEED_WORDS, row_id=(idx * 7 + 3).int(),
                         step=(idx % L).int(), is_sample=~greedy),
            "batch": dict(key=SLOT_SEED_WORDS, is_sample=~greedy)}
        for mode, kw in modes.items():
            before = tf.threefry_sample.launches
            k_tok, k_lp = tf.threefry_sample(x, **kw)
            if tf.threefry_sample.launches != before + 1:
                fail("threefry_sample did not launch its kernel")
            p_tok, p_lp = tf.categorical_ref(x, **kw)
            diff = (k_tok != p_tok).nonzero()[:, 0]
            ties = 0
            if len(diff):
                top = tf_noisy(torch, tf, x, diff, kw).topk(2, dim=-1).values
                ulp = torch.nextafter(top[:, 0], torch.full_like(
                    top[:, 0], math.inf)) - top[:, 0]
                ties = int(((top[:, 0] - top[:, 1])
                            <= TF_NEAR_TIE_ULPS * ulp).sum())
                if ties != len(diff) or bool(greedy[diff].any()):
                    fail(f"threefry_sample {mode} R={G}: {len(diff)} rows "
                         f"differ from the plain version, {ties} of them "
                         f"near-ties")
            same = k_tok == p_tok
            err = (k_lp - p_lp).abs()[same]
            lp_ok = bool((err <= TF_LP_RTOL * p_lp[same].abs()
                          + TF_LP_ATOL).all())
            masked = int((x.gather(1, k_tok[:, None])[:, 0] <= -1e29).sum())
            ms = device_ms(torch, lambda: tf.threefry_sample(x, **kw), REPS,
                           launches=1)
            plain_ms = time_call(torch, lambda: tf.categorical_ref(x, **kw),
                                 1)
            bound, by = tf_bound(G, n_sample, x.shape[1])
            key = f"{mode}_R{G}"
            res[key] = {"rows_differ": len(diff), "near_ties": ties,
                        "max_abs_err_lp": float(err.max()),
                        "masked_drawn": masked, "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound,
                        "bound_by": by, "sampled_rows": n_sample}
            log(f"5c.a threefry_sample {mode} R={G} V={x.shape[1]}: "
                f"{len(diff)} rows differ ({ties} near-ties), max |tok_lp "
                f"diff| {res[key]['max_abs_err_lp']:.3e}, masked ids drawn "
                f"{masked}; device {ms:.4f} ms, plain {plain_ms:.3f} ms, "
                f"bound {bound:.4f} ms ({by})  [{card}]")
            if not lp_ok or masked:
                fail(f"threefry_sample {mode} R={G}: tok_lp outside "
                     f"{TF_LP_RTOL:g} x |plain| + {TF_LP_ATOL:g}, or a masked "
                     f"id drawn ({masked})")
    return res


def f32_model(torch, trainer):
    """The trainer's model at float32 compute, same parameters."""
    import copy

    from cst_captioning_torch.models import captioner

    cfg = copy.deepcopy(trainer.cfg)
    cfg.model.compute_dtype = "float32"
    m32 = captioner.model_from_config(cfg, device=DEVICE)
    m32.load_state_dict(trainer.model.state_dict())
    return m32


def step_rg(fusion: str, layers: int = 1) -> int:
    """row_gemm launches of one per-step decode step: each layer's gates,
    the vocab and, under attention, the query."""
    return SLOT_STEP_RG[fusion] + layers - 1


def tick_launches(fusion: str, block: int, layers: int = 1) -> int:
    """The port's kernels one slot-rollout tick launches."""
    return block * (step_rg(fusion, layers) + 1 + (fusion == "attention"))


def slot_rollout(torch, model, batch, fusion: str, geometry, L: int,
                 temperature: float, S: int, counted=None, tag: str = "5c"):
    """One ``SlotRollout`` of ``batch`` (S rollouts a video plus the
    greedy rows).  With ``counted`` its launches are held: the encode's
    row_gemm once, then per decode step ``step_rg`` row_gemm, one
    sampler launch and, under attention, one context launch.  Returns
    (tokens, stats, wall ms, the rollout)."""
    from cst_captioning_torch.training import cst as cst_mod

    layout, n_slots, block = geometry
    ro = cst_mod.SlotRollout(model, max_len=L, temperature=temperature,
                             n_slots=n_slots, block=block,
                             padded=layout == "padded")
    if counted is not None:
        zero(counted)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks, stats = ro.run(batch.feats, batch.feat_masks,
                         batch.category if model.use_category else None,
                         SLOT_SEED_WORDS, repeat=S, need_greedy=True)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    if counted is not None:
        steps = stats["rollout_decode_steps"]
        want = {"row_gemm": SLOT_ENCODE_RG[fusion]
                + steps * step_rg(fusion, model.num_layers),
                "threefry_sample": steps}
        if fusion == "attention":
            want["fused_context_attention"] = steps
        hold_launches(counted, want, f"{tag}.b {fusion} {model.compute_dtype} "
                      f"{layout} slots={stats['rollout_slots']} "
                      f"block={block}")
    return toks, stats, wall, ro


def check_slot_layouts(torch, card: str, models: dict, L: int,
                       temperature: float, S: int, counted,
                       geometries=SLOT_GEOMETRIES, tag: str = "5c"):
    """5c.b: per fusion and compute dtype, the rollout through every
    entry of ``geometries`` (padded first), each bitwise the padded
    run's tokens; at bf16 one profiled tick of each slot run holds
    tick_launches exactly.  5c.c: the f32 padded rollout with the kernel
    swapped for its plain version, token-exact.  ``tag`` names the
    phase in the log."""
    from cst_captioning_torch.decoding import core as core_mod
    from cst_captioning_torch.ops import threefry as tf

    res = {}
    for (fusion, dtype), (model, batch) in models.items():
        base = None
        for geo in geometries:
            toks, stats, wall, ro = slot_rollout(
                torch, model, batch, fusion, geo, L, temperature, S, counted,
                tag)
            what = (f"{fusion} {dtype} {geo[0]} "
                    f"slots={stats['rollout_slots']} block={geo[2]}")
            rec = dict(stats, wall_ms=wall,
                       tick_ms=wall / stats["rollout_ticks"])
            if base is None:
                base = toks
            elif not (toks == base).all():
                fail(f"{tag}.b {what}: {int((toks != base).any(1).sum())} "
                     f"rows differ from the padded rollout")
            if dtype == "bf16" and geo[0] == "slot":
                sst = ro._sst_cache[stats["rollout_slots"]]
                words = tf.key_words(SLOT_SEED_WORDS)
                want = tick_launches(fusion, geo[2], model.num_layers)
                rows = profiled(torch, lambda: ro._tick(sst, words),
                                SLOT_TICKS_PROFILED, launches=want)
                rec["tick_device_ms"] = sum(ms for _, ms, _ in rows)
                rec["tick_launches"] = want
            res[what] = rec
            log(f"{tag}.b rollout {what}: {stats['rollout_ticks']} ticks, "
                f"{stats['rollout_steps_per_row']} steps a row, mean length "
                f"{stats['rollout_mean_len']}, wall {wall:.3f} ms "
                f"({rec['tick_ms']:.3f} ms a tick"
                + (f", device {rec['tick_device_ms']:.3f} ms a tick, "
                   f"{rec['tick_launches']} launches" if "tick_launches"
                   in rec else "") + f"); tokens == padded  [{card}]")
        if dtype == "f32":
            core_mod.threefry_sample = tf.categorical_ref
            try:
                plain = slot_rollout(torch, model, batch, fusion,
                                     geometries[0], L, temperature, S)[0]
            finally:
                core_mod.threefry_sample = tf.threefry_sample
            n = int((plain != base).any(1).sum())
            log(f"{tag}.c {fusion} f32 padded rollout, kernel vs plain: {n} "
                f"rows differ")
            if n:
                fail(f"{tag}.c the f32 {fusion} padded rollout through the "
                     f"kernel differs from the plain version in {n} rows")
            res[f"{fusion} f32 kernel vs plain rows differ"] = n
    return res


def check_cst_layouts(torch, card: str, trainer, batches, counted):
    """5c.d: SLOT_TIMED timed CST steps (after a warm-up step) each under
    the scan (split), padded and slot rollouts from one state, with their
    launches held; then two padded and two slot steps from one state,
    deterministic algorithms on: rewards, loss and parameters bitwise."""
    from cst_captioning_torch.training import cst as cst_mod

    model, opt, cfg = trainer.model, trainer.optimizer, trainer.cfg
    scorer = trainer._train_step.scorer
    Kc = cst_mod._chunk_count(cfg.train.cst_score_chunks, cfg.data.batch_size)
    steps = {"scan": trainer._train_step}
    for layout in ("padded", "slot"):
        steps[layout] = cst_mod._make_slot_step(
            model, opt, copy_cfg(cfg, cst_rollout=layout), scorer, layout)
    snap = snapshot(model, opt)
    res = {}
    try:
        for layout, step in steps.items():
            restore_snapshot(model, opt, snap)
            run_cst_step(torch, step, batches[0], 1)
            zero(counted)
            runs, decode_steps = [], 0
            for i in range(SLOT_TIMED):
                m, ph, wall, _ = run_cst_step(
                    torch, step, batches[(i + 1) % len(batches)], 50 + i)
                stats = dict(getattr(step, "rollout_stats", {}))
                decode_steps += stats.get("rollout_decode_steps", 0)
                for k in ("loss", "grad_norm", "reward"):
                    if not math.isfinite(float(m[k])):
                        fail(f"5c.d {layout} step: non-finite {k}")
                runs.append(dict(phase_ms=ph, wall_ms=wall, stats=stats,
                                 loss=float(m["loss"]), reward=m["reward"]))
                log(f"5c.d CST step {layout} {i}: wall {wall:.3f} ms, phases "
                    f"{json.dumps(ph)}, rollout {json.dumps(stats)}, loss "
                    f"{float(m['loss']):.5f} reward {m['reward']:.5f}  "
                    f"[{card}]")
            if layout == "scan":
                want = {"lstm_sample": SLOT_TIMED * Kc,
                        "lstm_recurrence": SLOT_TIMED,
                        "row_gemm": SLOT_TIMED * (2 + Kc)}
            else:
                want = {"threefry_sample": decode_steps,
                        "lstm_recurrence": SLOT_TIMED,
                        "row_gemm": SLOT_TIMED * SLOT_ENCODE_RG["meanpool"]
                        + decode_steps * SLOT_STEP_RG["meanpool"]}
            launches = hold_launches(counted, want,
                                     f"5c.d {SLOT_TIMED} {layout} steps")
            res[layout] = {"steps": runs, "launches": launches,
                           "layout": step.layout,
                           "wall_ms_mean": sum(r["wall_ms"] for r in runs)
                           / SLOT_TIMED}
        out = {}
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            for layout in ("padded", "slot"):
                restore_snapshot(model, opt, snap)
                ms = [run_cst_step(torch, steps[layout], batches[i], 70 + i)[0]
                      for i in range(2)]
                out[layout] = (ms, {k: v.detach().clone()
                                    for k, v in model.state_dict().items()})
        finally:
            torch.use_deterministic_algorithms(False)
        (pm, pp), (sm, sp) = out["padded"], out["slot"]
        same = (all(a[k] == b[k] for a, b in zip(pm, sm)
                    for k in ("reward", "baseline", "advantage"))
                and all(float(a["loss"]) == float(b["loss"])
                        for a, b in zip(pm, sm))
                and all(torch.equal(v, sp[k]) for k, v in pp.items()))
        log(f"5c.d two padded vs two slot CST steps from one state "
            f"(deterministic algorithms on): bitwise {same}; losses "
            f"{[float(m['loss']) for m in pm]} / "
            f"{[float(m['loss']) for m in sm]}")
        if not same:
            fail("5c.d the padded and slot CST steps differ")
        res["padded_vs_slot_bitwise"] = same
    finally:
        restore_snapshot(model, opt, snap)
    return res


def check_slot_rollout(torch, card: str, start: dict, counted):
    """Phase 5c, see the module docstring.  ``start``: phase 5's CST
    meanpool checkpoint and phase 4b's attention ``best``; ``counted``:
    every wrapper whose launches 5c holds."""
    from cst_captioning_torch.models import captioner

    t0 = time.perf_counter()
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        trainer, train_ds, batches = cst_trainer(
            torch, "meanpool", start["meanpool"], tmp)
        cfg = trainer.cfg
        S, L = cfg.train.cst_num_samples, cfg.data.max_seq_len
        temp = cfg.train.sample_temperature
        batch = batches[0]
        with torch.no_grad():
            cache = captioner._repeat_cache(trainer.model._encode(
                batch.feats, batch.feat_masks, None), S)
        res["kernel"] = check_threefry_kernel(torch, card, trainer.model,
                                              cache, L, temp)
        del cache
        atrainer, _, abatches = cst_trainer(
            torch, "attention", start["attention"], os.path.join(tmp, "att"),
            train_ds)
        models = {("meanpool", "bf16"): (trainer.model, batch),
                  ("meanpool", "f32"): (f32_model(torch, trainer), batch),
                  ("attention", "bf16"): (atrainer.model, abatches[0]),
                  ("attention", "f32"): (f32_model(torch, atrainer),
                                         abatches[0])}
        res["layouts"] = check_slot_layouts(torch, card, models, L, temp, S,
                                            counted)
        del models, atrainer, abatches
        res["steps"] = check_cst_layouts(torch, card, trainer, batches,
                                         counted)
    res["wall_s"] = time.perf_counter() - t0
    log(f"phase 5c (the slot rollout) took {res['wall_s']:.1f} s")
    return res


def slot_kernel_entry(slot):
    """The ``threefry_sample`` entry of the ``kernels`` line: launches
    from 5c's timed slot and padded CST steps, times and errors from
    5c.a at the default slot count, row-keyed."""
    k = slot["kernel"]
    main = k[f"rows_R{TF_ROWS[0]}"]
    steps = slot["steps"]
    return dict(
        name="threefry_sample", route="cuda",
        source="cst_captioning_torch/csrc/threefry_sample.cu",
        replaces=f"{REFERENCE}/decoding/core.py:422",
        replaces_note="no TPU kernel: the per-step jax.random.categorical "
                      "draw of row_sample_fn (and of the batch stream), "
                      "which the reference leaves to XLA",
        launches=sum(steps[lay]["launches"]["threefry_sample"]
                     for lay in ("padded", "slot")),
        launches_by_run={lay: steps[lay]["launches"]["threefry_sample"]
                         for lay in ("padded", "slot")},
        max_abs_err=main["max_abs_err_lp"], ms=main["ms"],
        plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
        bound_by=main["bound_by"], library_ms=None,
        library="none (no single call): torch.multinomial draws another "
                "stream",
        ms_note="ms: profiler device time per call; plain_ms: events",
        tolerance=TF_TOLERANCE, dtype="float32 logits",
        shape=f"R={TF_ROWS[0]} rows (every fifth greedy), V={V}, row-keyed",
        by_shape=k, slot_rollouts=slot["layouts"],
        cst_layouts={lay: steps[lay] for lay in SLOT_LAYOUTS},
        padded_vs_slot_bitwise=steps["padded_vs_slot_bitwise"],
        wall_s=slot["wall_s"])


# ------------------------------------------------------------ phase 6

EVAL_PRESET = "msrvtt_eval_beam5"
N_EVAL_VIDEOS = 512      # 8 batches of 64 (6a)
N_ATT_EVAL_VIDEOS = 128  # 2 batches (6b)
EVAL_SEED = 3            # the eval corpus's seed (phase 4's splits: 1, 2)
# row_gemm launches a batch: the two feature projections, then the
# static gates (meanpool) or att_proj (attention).
EVAL_ROW_GEMM = 3
PIPELINE_STAGES = ("xe", "wxe", "cst")
EVAL_FILES = ("predictions.json", "scores.json")


def eval_cfg(fusion: str = "meanpool", dtype=None):
    """``msrvtt_eval_beam5`` at full width (V = 10,496), ``fusion``, at
    the preset's compute dtype unless ``dtype`` is given."""
    from cst_captioning_torch.config import get_preset

    cfg = get_preset(EVAL_PRESET)
    cfg.model.feature_fusion = fusion
    cfg.model.vocab_size = V
    if dtype is not None:
        cfg.model.compute_dtype = dtype
    return cfg


def eval_model(cfg, checkpoint: str):
    """A model of ``cfg`` on the card, restored from ``checkpoint`` by
    ``restore_params``."""
    from cst_captioning_torch.models.captioner import model_from_config
    from cst_captioning_torch.training.checkpoint import restore_params

    return restore_params(checkpoint, model_from_config(cfg, device=DEVICE))


def read_files(out_dir: str) -> dict:
    out = {}
    for n in EVAL_FILES:
        with open(os.path.join(out_dir, n), "rb") as f:
            out[n] = f.read()
    return out


class swapped:
    """``obj.name = fn`` for the duration of a ``with`` block (a kernel
    wrapper's reference in the captioner swapped for its plain
    version)."""

    def __init__(self, obj, name: str, fn):
        self.obj, self.name, self.fn = obj, name, fn

    def __enter__(self):
        self.inner = getattr(self.obj, self.name)
        setattr(self.obj, self.name, self.fn)

    def __exit__(self, *exc):
        setattr(self.obj, self.name, self.inner)


def run_eval(torch, what: str, model, ds, cfg, out_dir: str,
             card: str) -> dict:
    """``evaluation.evaluate_dataset`` on the card, as a user calls it,
    with each batch's beam result and CUDA-event device ms (around the
    beam search, the encode included) and the metric suite's host time
    recorded by wrappers on the module's ``make_beam_search_fn`` and
    ``score_predictions``; logged as ``what``."""
    from cst_captioning_torch import evaluation

    rec = {"tokens": [], "score": [], "events": [], "score_s": 0.0}
    inner_make, inner_score = (evaluation.make_beam_search_fn,
                               evaluation.score_predictions)

    def make(model_, **kw):
        fn = inner_make(model_, **kw)

        def timed(feats, masks, category=None):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            r = fn(feats, masks, category)
            ev[1].record()
            rec["tokens"].append(r.tokens)
            rec["score"].append(r.score)
            rec["events"].append(ev)
            return r

        return timed

    def score(*args, **kw):
        t0 = time.perf_counter()
        out = inner_score(*args, **kw)
        rec["score_s"] += time.perf_counter() - t0
        return out

    evaluation.make_beam_search_fn = make
    evaluation.score_predictions = score
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scores, preds = evaluation.evaluate_dataset(model, ds, cfg,
                                                    out_dir=out_dir,
                                                    device=DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        evaluation.make_beam_search_fn = inner_make
        evaluation.score_predictions = inner_score
    if len(preds) != len(ds):
        fail(f"eval: {len(preds)} predictions for {len(ds)} videos")
    for k in cfg.eval.metrics:
        if not math.isfinite(float(scores.get(k, math.nan))):
            fail(f"eval: metric {k} missing or not finite: {scores}")
    dev = [a.elapsed_time(b) for a, b in rec["events"]]
    log(f"eval {what}: {json.dumps(scores)}; beam device ms a batch "
        f"{[round(x, 3) for x in dev]} (mean {sum(dev) / len(dev):.3f}); "
        f"metric suite {rec['score_s']:.3f} s (host); wall {wall:.3f} s, "
        f"{len(ds) / wall:.1f} videos/s end to end  [{card}]")
    return dict(scores=scores, preds=preds, files=read_files(out_dir),
                tokens=torch.cat(rec["tokens"]), score=torch.cat(rec["score"]),
                device_ms=dev, wall_s=wall, score_s=rec["score_s"],
                videos_per_s=len(ds) / wall)


def differing(a: dict, b: dict) -> int:
    return sum(a[v] != b[v] for v in a)


def write_label_h5(h5py, path: str, ds) -> None:
    """``ds`` as a label h5 in the reference's schema (the JAX package's
    ``tools/prepare_data.py::write_label_h5``, copied: this script
    imports nothing of that package): uniform consensus weights,
    category 0."""
    import numpy as np

    ids = [ds.video_id(i) for i in range(len(ds))]
    caps = [ds.captions(i) for i in range(len(ds))]
    ends = np.cumsum([c.shape[0] for c in caps]).astype(np.int64)
    with h5py.File(path, "w") as f:
        f.create_dataset("captions", data=np.concatenate(caps, axis=0))
        f.create_dataset("cap_start", data=ends - [c.shape[0] for c in caps])
        f.create_dataset("cap_end", data=ends)
        f.create_dataset("weights", data=np.ones((int(ends[-1]),),
                                                  np.float32))
        f.create_dataset("category", data=np.zeros((len(ids),), np.int32))
        f.create_dataset("video_ids",
                         data=np.asarray([v.encode() for v in ids]))
        g = f.create_group("refs")
        for i, vid in enumerate(ids):
            g.create_dataset(vid, data=np.asarray(
                [r.encode() for r in ds.references(i)]))


def packed_split(corpus, directory: str, label, calls: list):
    """The split with its features read from the packed ``directory``:
    ``H5Dataset`` on ``label`` (an h5 label file) when there is one,
    else the package's ``PackedDataset`` with ``corpus``'s labels in
    memory (uniform consensus weights, category 0, as ``write_label_h5``
    writes them; the same batched gather, ``features_batch``).  Each
    answered ``features_batch`` call appends its batch size to
    ``calls``."""
    import numpy as np

    from cst_captioning_torch.data.datasets import H5Dataset, PackedDataset

    dirs = {m: directory for m in corpus.feature_dims}
    if label:
        ds = H5Dataset(label, dirs, corpus.vocab)
    else:
        caps = [corpus.captions(i) for i in range(len(corpus))]
        ends = np.cumsum([c.shape[0] for c in caps]).astype(np.int64)
        ds = PackedDataset(
            corpus.vocab, [corpus.video_id(i) for i in range(len(corpus))],
            np.concatenate(caps, axis=0), ends - [c.shape[0] for c in caps],
            ends, [corpus.references(i) for i in range(len(corpus))], dirs)
    inner = ds.features_batch

    def counted(idxs, max_frames):
        out = inner(idxs, max_frames)
        if out is not None:
            calls.append(len(idxs))
        return out

    ds.features_batch = counted
    return ds


def assembly_ms(ds, cfg) -> float:
    """Host ms to assemble one eval batch (seq_per_img 1, no shuffle),
    the mean over the second of two passes over the split."""
    from cst_captioning_torch.data.loader import BatchIterator

    it = BatchIterator(ds, batch_size=cfg.data.batch_size, seq_per_img=1,
                       max_frames=cfg.data.max_frames, shuffle=False)
    for _ in it.epoch(0):
        pass
    t0 = time.perf_counter()
    n = sum(1 for _ in it.epoch(0))
    return (time.perf_counter() - t0) * 1e3 / n


def metric_breakdown(ds, preds, metrics, card: str) -> dict:
    """Host seconds of the metric suite's parts on one eval's
    predictions: tokenization once, then each metric alone."""
    from cst_captioning_torch.metrics.evaluator import language_eval
    from cst_captioning_torch.metrics.tokenizer import tokenize_corpus

    gts = {ds.video_id(i): ds.references(i) for i in range(len(ds))}
    t0 = time.perf_counter()
    gts = tokenize_corpus(gts)
    res = tokenize_corpus({v: [preds[v]] for v in gts})
    out = {"tokenize": time.perf_counter() - t0}
    for m in metrics:
        t0 = time.perf_counter()
        language_eval(gts, res, metrics=[m], tokenized=True)
        out[m] = time.perf_counter() - t0
    log(f"eval metric suite, host s per part over {len(gts)} videos: "
        f"{json.dumps({k: round(v, 4) for k, v in out.items()})}  [{card}]")
    return out


def hold_f32_eval(torch, what: str, k, p, witness=None):
    """f32 kernel vs plain through ``evaluate_dataset``: both files
    identical.  With ``witness`` (a callable returning the plain eval's
    predictions on the hidden-unit-permuted model), differing captions
    pass only if the witness differs from the plain eval in at least as
    many: the trained recurrence then holds candidates within the f32
    sums' reach of each other, in the plain version alone."""
    n = differing(k["preds"], p["preds"])
    same = k["files"] == p["files"]
    log(f"eval {what} f32 kernel vs plain: predictions.json and scores.json "
        f"identical: {same} ({n} of {len(p['preds'])} captions differ)")
    if same:
        return {"identical": True, "captions_differing": 0}
    if witness is None:
        fail(f"eval {what} f32: kernel and plain files differ")
    n_wit = differing(witness(), p["preds"])
    log(f"eval {what} f32 order witness (plain on the H-permuted model vs "
        f"plain): {n_wit} captions differ")
    if n_wit == 0 or n > n_wit:
        fail(f"eval {what} f32: {n} captions differ kernel vs plain, the "
             f"order witness {n_wit}")
    return {"identical": False, "captions_differing": n,
            "witness_differing": n_wit}


def check_eval(torch, card: str, checkpoint: str, counted, beam_mod,
               tmp: str):
    """Phase 6a, see the module docstring.  ``checkpoint``: phase 5's CST
    meanpool ``best``; ``counted``: {"lstm_beam", "row_gemm"} wrappers;
    files go under ``tmp``.  Returns the readings."""
    import importlib.util

    import numpy as np

    from cst_captioning_torch.data.datasets import InMemoryDataset
    from cst_captioning_torch.data.packed import pack_dataset
    from cst_captioning_torch.data.vocab import Vocabulary
    from cst_captioning_torch.decoding.beam import beam_search
    from cst_captioning_torch.models import captioner

    res = {"launches": {}}
    cfg = eval_cfg()
    nb = N_EVAL_VIDEOS // cfg.data.batch_size
    want = {"lstm_beam": nb, "row_gemm": EVAL_ROW_GEMM * nb}
    vocab = Vocabulary([f"w{i}" for i in range(V - 4)])
    t0 = time.perf_counter()
    corpus = make_msrvtt_corpus(np, vocab, cfg, N_EVAL_VIDEOS, EVAL_SEED)
    log(f"eval corpus: {N_EVAL_VIDEOS} videos ({nb} batches of "
        f"{cfg.data.batch_size}) at {cfg.data.feature_dims} x "
        f"{cfg.data.max_frames} frames, {cfg.data.seq_per_img} references "
        f"each, V={len(vocab)}, seed {EVAL_SEED}, built in "
        f"{time.perf_counter() - t0:.1f} s; model from {checkpoint}")
    plain = swapped(captioner, "lstm_beam", beam_mod.lstm_beam_ref)

    c32 = eval_cfg(dtype="float32")
    m32 = eval_model(c32, checkpoint)
    zero(counted)
    k32 = run_eval(torch, "f32 kernel", m32, corpus, c32,
                   os.path.join(tmp, "f32"), card)
    res["launches"]["f32"] = hold_launches(counted, want, "eval, f32 kernel")
    with plain:
        p32 = run_eval(torch, "f32 plain", m32, corpus, c32,
                       os.path.join(tmp, "f32_plain"), card)

    def witness():
        mp = permuted_model(torch, m32, seed=5)
        with plain:
            return run_eval(torch, "f32 plain, H-permuted", mp, corpus, c32,
                            os.path.join(tmp, "f32_witness"), card)["preds"]

    res["f32"] = hold_f32_eval(torch, "meanpool", k32, p32, witness)
    res["ms_f32"] = k32["device_ms"]
    # Phase 7a serves this checkpoint and holds it to these tokens.
    res["f32_tokens"], res["corpus"], res["vocab"] = (k32["tokens"], corpus,
                                                      vocab)
    del m32

    model = eval_model(cfg, checkpoint)
    zero(counted)
    kb = run_eval(torch, "bf16 kernel, in memory", model, corpus, cfg,
                  os.path.join(tmp, "bf16"), card)
    res["launches"]["bf16"] = hold_launches(counted, want, "eval, bf16 kernel")
    with plain:
        pb = run_eval(torch, "bf16 plain", model, corpus, cfg,
                      os.path.join(tmp, "bf16_plain"), card)
    res["bf16_err"] = bf16_check("eval bf16 lstm_beam", kb["tokens"],
                                 pb["tokens"], kb["score"], pb["score"])
    res.update(ms_bf16=kb["device_ms"], plain_ms_bf16=pb["device_ms"],
               videos_per_s=kb["videos_per_s"], wall_s=kb["wall_s"],
               metric_s=kb["score_s"], scores=kb["scores"])
    res["metric_parts_s"] = metric_breakdown(corpus, kb["preds"],
                                             cfg.eval.metrics, card)

    from cst_captioning_torch.data.loader import BatchIterator, to_device

    first = to_device(next(iter(BatchIterator(
        corpus, batch_size=cfg.data.batch_size, seq_per_img=1,
        max_frames=cfg.data.max_frames, shuffle=False).epoch(0))),
        torch.device(DEVICE))
    rows = profiled(
        torch, lambda: beam_search(model, first.feats, first.feat_masks,
                                   beam_size=cfg.eval.beam_size,
                                   max_len=cfg.eval.max_decode_len),
        1, MEANPOOL_DEC_LAUNCHES + EVAL_ROW_GEMM)
    for kname, ms, count in sorted(rows, key=lambda r: -r[1]):
        log(f"breakdown bf16 eval batch (beam_search): {kname} {ms:.3f} ms "
            f"over {count:g} launches")
    res["launches_per_batch_bf16"] = round(
        sum(c for k, _, c in rows if k.startswith("cstk::")))
    res["batch_device_ms_bf16"] = sum(ms for _, ms, _ in rows)
    log(f"eval batch bf16: {res['launches_per_batch_bf16']} launches of the "
        f"port's kernels, {res['batch_device_ms_bf16']:.3f} ms of device time "
        f"(profiler)  [{card}]")

    have_h5py = importlib.util.find_spec("h5py") is not None
    label = None
    if have_h5py:
        import h5py

        label = os.path.join(tmp, "labels_test.h5")
        write_label_h5(h5py, label, corpus)
    else:
        log("h5py is not installed on this host: the packed runs read "
            "their labels from memory, and the h5 label reader is held by "
            "the CPU tests alone (cli/test runs on the synthetic corpus "
            "after 6c)")
    res["h5py"] = have_h5py
    assembly = {"in_memory": assembly_ms(corpus, cfg)}
    runs = {}
    for dtype in ("float32", "float16"):
        d = os.path.join(tmp, f"packed_{dtype}")
        t0 = time.perf_counter()
        pack_dataset(corpus, d, max_frames=cfg.data.max_frames, dtype=dtype)
        log(f"packed the eval corpus at {dtype} in "
            f"{time.perf_counter() - t0:.1f} s")
        calls = []
        ds = packed_split(corpus, d, label, calls)
        assembly[f"packed_{dtype}"] = assembly_ms(ds, cfg)
        calls.clear()
        zero(counted)
        runs[dtype] = run_eval(torch, f"bf16 kernel, packed {dtype}", model,
                               ds, cfg, os.path.join(tmp, f"bf16_{dtype}"),
                               card)
        res["launches"][f"packed_{dtype}"] = hold_launches(
            counted, want, f"eval, bf16 kernel, packed {dtype}")
        if calls != [cfg.data.batch_size] * nb:
            fail(f"packed {dtype}: the loader's batched gather answered "
                 f"{calls}, want {nb} batches of {cfg.data.batch_size}")
    log(f"eval batch assembly, host ms a batch (second pass): "
        f"{json.dumps({k: round(v, 3) for k, v in assembly.items()})}  "
        f"[{card}]")
    res["assembly_ms"] = assembly
    res["videos_per_s_packed"] = {k: r["videos_per_s"]
                                  for k, r in runs.items()}
    if runs["float32"]["files"] != kb["files"] or not torch.equal(
            runs["float32"]["tokens"], kb["tokens"]):
        fail("eval: the float32 pack's predictions differ from the "
             "in-memory run's")
    rounded = InMemoryDataset(
        vocab, [corpus.video_id(i) for i in range(len(corpus))],
        {m: [corpus.features(i)[m].astype(np.float16).astype(np.float32)
             for i in range(len(corpus))] for m in corpus.feature_dims},
        [corpus.captions(i) for i in range(len(corpus))],
        [corpus.references(i) for i in range(len(corpus))])
    r16 = run_eval(torch, "bf16 kernel, in memory, features rounded to f16",
                   model, rounded, cfg, os.path.join(tmp, "bf16_r16"), card)
    same16 = (runs["float16"]["files"] == r16["files"]
              and torch.equal(runs["float16"]["tokens"], r16["tokens"]))
    log(f"eval packed float32 == in memory: True; packed float16 == in "
        f"memory on features rounded to float16: {same16} (vs the float32 "
        f"features: {differing(runs['float16']['preds'], kb['preds'])} "
        f"captions differ)")
    if not same16:
        fail("eval: the float16 pack's predictions differ from the "
             "in-memory run on float16-rounded features")
    if have_h5py:
        res["cli_test"] = check_cli_test(
            torch, card, counted, nb, kb["files"],
            ["--checkpoint", checkpoint, "--preset", EVAL_PRESET,
             "--data.vocab_file", save_vocab(vocab, tmp),
             "--data.label_file", os.path.join(tmp, "labels_{split}.h5"),
             "--data.feature_files", json.dumps(
                 {m: os.path.join(tmp, "packed_float32")
                  for m in corpus.feature_dims})],
            os.path.join(tmp, "cli_test"), "the h5 labels, packed float32")
    return res


def save_vocab(vocab, tmp: str) -> str:
    path = os.path.join(tmp, "vocab.json")
    vocab.save(path)
    return path


def check_cli_test(torch, card, counted, nb: int, want_files, argv,
                   out_dir: str, what: str):
    """``cli/test.main`` end to end (its own model, restore, split and
    evaluate_dataset): exit 0, one ``lstm_beam`` launch a batch, and both
    files equal to ``want_files``."""
    from cst_captioning_torch.cli import test as cli_test

    zero(counted)
    t0 = time.perf_counter()
    rc = cli_test.main(argv + ["--eval.out_dir", out_dir], device=DEVICE)
    wall = time.perf_counter() - t0
    launches = hold_launches(
        counted, {"lstm_beam": nb, "row_gemm": EVAL_ROW_GEMM * nb},
        f"eval, cli/test on {what}")
    same = read_files(out_dir) == want_files
    log(f"cli/test on {what}: rc {rc}, {wall:.1f} s, files equal to the "
        f"direct evaluate_dataset run's: {same}  [{card}]")
    if rc != 0 or not same:
        fail(f"cli/test on {what}: rc {rc}, files equal {same}")
    return {"launches": launches, "wall_s": wall, "on": what}


def check_att_eval(torch, card: str, checkpoint: str, counted, beam_mod,
                   tmp: str):
    """Phase 6b: 2 batches under attention fusion from phase 4b's
    ``best``, f32 kernel vs plain through ``evaluate_dataset``,
    token-exact; ``attlstm_beam`` once a batch."""
    import numpy as np

    from cst_captioning_torch.data.vocab import Vocabulary
    from cst_captioning_torch.models import captioner

    cfg = eval_cfg("attention", "float32")
    nb = N_ATT_EVAL_VIDEOS // cfg.data.batch_size
    vocab = Vocabulary([f"w{i}" for i in range(V - 4)])
    corpus = make_msrvtt_corpus(np, vocab, cfg, N_ATT_EVAL_VIDEOS, EVAL_SEED)
    model = eval_model(cfg, checkpoint)
    zero(counted)
    k = run_eval(torch, "attention f32 kernel", model, corpus, cfg,
                 os.path.join(tmp, "att"), card)
    launches = hold_launches(
        counted, {"attlstm_beam": nb, "row_gemm": EVAL_ROW_GEMM * nb},
        "eval, attention f32 kernel")
    with swapped(captioner, "attlstm_beam", beam_mod.attlstm_beam_ref):
        p = run_eval(torch, "attention f32 plain", model, corpus, cfg,
                     os.path.join(tmp, "att_plain"), card)
    return {"f32": hold_f32_eval(torch, "attention", k, p),
            "launches": launches, "ms_f32": k["device_ms"],
            "plain_ms_f32": p["device_ms"]}


def check_pipeline(torch, card: str, counted, tmp: str, cli: bool):
    """Phase 6c: ``cli/pipeline.main`` (``run_pipeline`` over XE, WXE and
    CST, then the eval) on the synthetic corpus at the preset's feature
    widths, one epoch a stage.  Held: exit 0; each stage warm-starts from
    the previous stage's checkpoint and the eval restores the last
    (``restore_params`` calls, in order); ``pipeline.json`` holds every
    stage and the eval; the eval's files equal ``evaluate_dataset`` run
    afresh on the final checkpoint; ``lstm_beam`` launched once an eval
    batch.  With ``cli``, ``cli/test.main`` on the same checkpoint and
    split must write the same files."""
    from cst_captioning_torch.cli import pipeline
    from cst_captioning_torch.config import parse_cli
    from cst_captioning_torch.data.build import build_dataset
    from cst_captioning_torch.training import checkpoint as ckpt_mod

    root = os.path.join(tmp, "pipeline")
    base = ["--preset", EVAL_PRESET, "--data.dataset", "synthetic",
            "--train.max_epochs", "1", "--train.checkpoint_dir", root]
    cfg = parse_cli(base)
    ds, vocab = build_dataset(cfg, "test")
    nb = -(-len(ds) // cfg.data.batch_size)
    seen = []
    inner = ckpt_mod.restore_params

    def spy(path, model):
        seen.append(os.path.abspath(path))
        return inner(path, model)

    ckpt_mod.restore_params = spy
    zero(counted)
    t0 = time.perf_counter()
    try:
        rc = pipeline.main(base + ["--stages", ",".join(PIPELINE_STAGES)],
                           device=DEVICE)
    finally:
        ckpt_mod.restore_params = inner
    wall = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in counted.items()}
    with open(os.path.join(root, cfg.name, "pipeline.json")) as f:
        saved = json.load(f)
    ck = {}
    for s in PIPELINE_STAGES:
        wd = os.path.join(root, f"{cfg.name}_{s}")
        best = os.path.join(wd, "best")
        ck[s] = best if os.path.exists(best) else os.path.join(wd, "last")
    chain = [ck[s] for s in PIPELINE_STAGES]
    ev = saved.get("eval", {})
    log(f"pipeline {'->'.join(PIPELINE_STAGES)} -> eval on the synthetic "
        f"corpus ({len(ds)} test videos at {cfg.data.feature_dims}): rc {rc} "
        f"in {wall:.1f} s; pipeline.json keys {sorted(saved)}; restores "
        f"{seen}; eval {json.dumps(ev.get('scores'))}; launches "
        f"{launches}  [{card}]")
    for s in PIPELINE_STAGES:
        log(f"pipeline stage {s}: {json.dumps(saved.get(s))}")
    if rc != 0 or sorted(saved) != sorted(PIPELINE_STAGES + ("eval",)):
        fail(f"pipeline: rc {rc}, pipeline.json keys {sorted(saved)}")
    if seen != chain:
        fail(f"pipeline warm starts {seen}, want {chain}")
    if launches["lstm_beam"] != nb:
        fail(f"pipeline: {launches['lstm_beam']} lstm_beam launches, want "
             f"{nb} (one an eval batch)")
    cfg.model.vocab_size = len(vocab)
    fresh = os.path.join(tmp, "pipeline_fresh")
    r = run_eval(torch, "pipeline checkpoint, afresh",
                 eval_model(cfg, ck[PIPELINE_STAGES[-1]]), ds, cfg, fresh, card)
    same = (read_files(fresh) == read_files(ev["out_dir"])
            and r["scores"] == ev["scores"])
    log(f"pipeline eval == evaluate_dataset afresh on {chain[-1]}: {same}")
    if not same:
        fail("pipeline: its eval differs from evaluate_dataset afresh")
    out = {"wall_s": wall, "launches": launches, "eval": ev["scores"]}
    if cli:
        out["cli_test"] = check_cli_test(
            torch, card, counted, nb, read_files(fresh),
            ["--checkpoint", chain[-1]] + base[:4], os.path.join(tmp, "cli"),
            "the synthetic corpus, the pipeline's checkpoint")
    return out


REHEARSAL_ARGS = ("--corpus", "branch-trap", "--videos", "600", "--seed",
                  "0", "--train-seed", "213")
REHEARSAL_MLE_EPOCHS = 12
# The protocol's CST stage runs 16 epochs.  At train seed 213 its best val
# CIDEr, the checkpoint every held test score comes from, is epoch 5's
# and stays the best through epoch 16 (2.2398 from epoch 5 on, on one
# H100), and each epoch's results do not depend on the epochs after it:
# 8 epochs keep that checkpoint, its test scores and every hold, at half
# the stage's wall.
REHEARSAL_CST_EPOCHS = 8
REHEARSAL_VIDEOS = 600
# The beam-5 test scores of CST's best checkpoint, held to the
# reference's nine-seed Round-4 band (docs/REHEARSAL.md: CIDEr 2.245 +-
# 0.041, Bleu_4 0.959 +- 0.072) at mean +- 3 sd.  The port's nine seeds
# on the card (tools/rehearsal_seeds.py) read CIDEr 2.2598-2.2774,
# Bleu_4 0.9832-1.0.  WXE's best is not held to its band (2.174 +-
# 0.014): its test CIDEr turns on the epoch keep-best picks (0.0, the
# generic caption for every video, at four of the port's nine seeds;
# 1.2196-2.3209 at five), and the JAX package itself on the CPU reads
# 0.0 and 1.7315 at seeds 7 and 213 (PERF.md §6).  Both best
# checkpoints are held to the plain beam's decode instead.
REHEARSAL_CST_TEST_CIDER = (2.245 - 3 * 0.041, 2.245 + 3 * 0.041)
REHEARSAL_CST_TEST_BLEU4_MIN = 0.959 - 3 * 0.072
# The plain beam on the CPU against the kernel's decode of the same
# checkpoint (bf16 compute on both): captions that may differ on a near
# tie, and the CIDEr and Bleu_4 difference that allows.  The nine seeds'
# 18 checkpoints on the card: 150 of 150 captions the kernel's each.
REHEARSAL_PLAIN_DIFFER_MAX = 2
REHEARSAL_PLAIN_SCORE_TOL = 0.02


def stage_walls():
    """Wrap ``Trainer.fit`` to record each stage's wall: (walls {run
    name: s}, undo)."""
    from cst_captioning_torch.training import trainer as trainer_mod

    walls = {}
    inner = trainer_mod.Trainer.fit

    def timed(self):
        t0 = time.perf_counter()
        try:
            return inner(self)
        finally:
            walls[self.cfg.name] = time.perf_counter() - t0

    trainer_mod.Trainer.fit = timed

    def undo():
        trainer_mod.Trainer.fit = inner

    return walls, undo


def rehearsal_call(torch, rehearsal, argv, counted, what: str, card: str):
    """One ``rehearsal.main`` call: (rc, summary, launches, wall s,
    stage walls, the route's log line)."""
    import contextlib
    import io

    lines = []

    class Grab(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    grab = Grab(level=logging.INFO)
    rlog = logging.getLogger("cst_captioning_torch.rehearsal")
    rlog.addHandler(grab)
    rlog.setLevel(logging.INFO)
    walls, undo = stage_walls()
    zero(counted)
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = rehearsal.main(list(argv), device=DEVICE)
    finally:
        undo()
        rlog.removeHandler(grab)
    wall = time.perf_counter() - t0
    launches = counts(counted)
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    route = next((m for m in lines if "data route" in m), None)
    log(f"rehearsal {what}: rc {rc} in {wall:.1f} s (stages "
        f"{ {k: round(v, 1) for k, v in walls.items()} } s); {route}; "
        f"launches {launches}  [{card}]")
    log(f"rehearsal {what} summary: {json.dumps(summary)}")
    if route is None:
        fail(f"rehearsal {what}: no log line names the data route")
    return rc, summary, launches, wall, walls, route


def check_rehearsal(torch, card: str, counted, tmp: str):
    """Phase 6d: the reference's Round-4 branch-trap protocol through
    ``tools/rehearsal.main`` (module docstring).  Returns the readings."""
    from cst_captioning_torch.config import get_preset
    from cst_captioning_torch.models import captioner
    from cst_captioning_torch.ops.beam import lstm_beam_ref
    from cst_captioning_torch.tools import rehearsal
    from cst_captioning_torch.tools.rehearsal_seeds import (
        plain_beam_eval,
        stage_history,
    )

    out = os.path.join(tmp, "rehearsal")
    base = ["--out-dir", out, *REHEARSAL_ARGS]
    bs = rehearsal.parser().parse_args(base).batch_size
    n_train = int(REHEARSAL_VIDEOS * 0.65)
    n_val = max(1, int(REHEARSAL_VIDEOS * 0.1))
    n_test = REHEARSAL_VIDEOS - n_train - n_val
    drop_last = get_preset("msrvtt_resnet_c3d_xe").data.drop_last
    steps = n_train // bs if drop_last else -(-n_train // bs)
    test_batches = -(-n_test // bs)

    rc1, s1, l1, w1, sw1, route = rehearsal_call(
        torch, rehearsal,
        base + ["--stages", "xe,wxe", "--epochs", str(REHEARSAL_MLE_EPOCHS)],
        counted, "xe,wxe", card)
    wxe_best = os.path.join(out, "checkpoints", "rehearsal_wxe", "best")
    rc2, s2, l2, w2, sw2, route2 = rehearsal_call(
        torch, rehearsal,
        base + ["--reuse-data", "--stages", "cst", "--epochs",
                str(REHEARSAL_CST_EPOCHS), "--start-from", wxe_best,
                "--run-name", "rehearsal_cst"],
        counted, "cst", card)
    val = {}
    for stage, run in (("xe", "rehearsal_xe"), ("wxe", "rehearsal_wxe"),
                       ("cst", "rehearsal_cst_cst")):
        val[stage] = stage_history(out, run)["val"]
        log(f"rehearsal {stage}: val CIDEr per epoch "
            f"{[round(v, 4) for v in val[stage]]}, best {max(val[stage]):.4f}")
    cst_rewards = stage_history(out, "rehearsal_cst_cst")["reward"]
    log(f"rehearsal cst: mean reward per epoch "
        f"{[round(r, 4) for r in cst_rewards]}")
    best = {"xe": s1["stages"]["xe"]["best_val_cider"],
            "wxe": s1["stages"]["wxe"]["best_val_cider"],
            "cst": s2["stages"]["cst"]["best_val_cider"]}
    log(f"rehearsal best val CIDEr: {best}; test (WXE best) "
        f"{json.dumps(s1['test_scores'])}; test (CST best) "
        f"{json.dumps(s2['test_scores'])}; mle optimum val "
        f"{json.dumps(s2.get('mle_optimum_val'))}, test "
        f"{json.dumps(s2.get('mle_optimum_test'))}  [{card}]")
    if rc1 != 0 or rc2 != 0:
        fail(f"rehearsal: main returned {rc1}, {rc2}")
    if not best["xe"] < best["wxe"]:
        fail(f"rehearsal: XE best val {best['xe']} not below WXE "
             f"{best['wxe']}")
    if not best["cst"] >= best["wxe"]:
        fail(f"rehearsal: CST best val {best['cst']} below WXE "
             f"{best['wxe']}")
    if not cst_rewards[-1] > cst_rewards[0]:
        fail(f"rehearsal: CST reward did not rise ({cst_rewards[0]} -> "
             f"{cst_rewards[-1]})")
    test = {"wxe": s1["test_scores"], "cst": s2["test_scores"]}
    lo, hi = REHEARSAL_CST_TEST_CIDER
    if not lo <= test["cst"]["CIDEr"] <= hi:
        fail(f"rehearsal: CST's best scores test CIDEr "
             f"{test['cst']['CIDEr']}, outside the reference's nine-seed "
             f"band [{lo:.3f}, {hi:.3f}]")
    if not test["cst"]["Bleu_4"] >= REHEARSAL_CST_TEST_BLEU4_MIN:
        fail(f"rehearsal: CST's best scores test Bleu_4 "
             f"{test['cst']['Bleu_4']}, under the reference's nine-seed "
             f"band ({REHEARSAL_CST_TEST_BLEU4_MIN:.3f})")
    # The eval path's witness: the plain beam (on the card, the captioner's
    # lstm_beam swapped for its plain version) decodes both best
    # checkpoints again; no kernel launch, none counted.
    plain = {}
    t0 = time.perf_counter()
    for stage, argv, run in (
            ("wxe", ["--stages", "xe,wxe", "--run-name", "rehearsal"],
             "rehearsal"),
            ("cst", ["--stages", "cst", "--run-name", "rehearsal_cst"],
             "rehearsal_cst")):
        ns = rehearsal.parser().parse_args(base + argv)
        best = os.path.join(out, "checkpoints", f"{run}_{stage}", "best")
        with swapped(captioner, "lstm_beam", lstm_beam_ref):
            plain[stage] = plain_beam_eval(ns, best, os.path.join(
                out, "checkpoints", run, "eval", "predictions.json"),
                device=DEVICE)
        got = plain[stage]
        differ = got["captions"] - got["same_captions"]
        dc = max(abs(got["scores"][m] - test[stage][m])
                 for m in ("CIDEr", "Bleu_4"))
        log(f"rehearsal {stage} best, plain beam on {DEVICE}: "
            f"{got['same_captions']} of {got['captions']} captions the "
            f"kernel's, test CIDEr {got['scores']['CIDEr']:.4f} (kernel "
            f"{test[stage]['CIDEr']:.4f}), Bleu_4 "
            f"{got['scores']['Bleu_4']:.4f}")
        if differ > REHEARSAL_PLAIN_DIFFER_MAX or \
                dc > REHEARSAL_PLAIN_SCORE_TOL:
            fail(f"rehearsal {stage}: the plain beam differs from the "
                 f"kernel's on {differ} captions (at most "
                 f"{REHEARSAL_PLAIN_DIFFER_MAX}), CIDEr or Bleu_4 by "
                 f"{dc:.4f} (at most {REHEARSAL_PLAIN_SCORE_TOL})")
    plain_s = time.perf_counter() - t0
    for what, got, want_rec in (
            ("xe,wxe", l1, 2 * REHEARSAL_MLE_EPOCHS * steps),
            ("cst", l2, REHEARSAL_CST_EPOCHS * steps)):
        if got["lstm_beam"] != test_batches:
            fail(f"rehearsal {what}: {got['lstm_beam']} lstm_beam launches, "
                 f"want {test_batches} (one a test batch)")
        if got["lstm_recurrence"] != want_rec:
            fail(f"rehearsal {what}: {got['lstm_recurrence']} "
                 f"lstm_recurrence launches, want {want_rec} (one a "
                 f"training step or CST update)")
    return {"route": route, "best_val_cider": best, "val_cider": val,
            "cst_rewards": cst_rewards,
            "test_scores": {"wxe_best": s1["test_scores"],
                            "cst_best": s2["test_scores"]},
            "mle_optimum": {"val": s2.get("mle_optimum_val"),
                            "test": s2.get("mle_optimum_test")},
            "plain_beam": {k: {"same_captions": v["same_captions"],
                               "scores": v["scores"]}
                           for k, v in plain.items()},
            "wall_s": {"xe,wxe": w1, "cst": w2, "plain_beam": plain_s,
                       **sw1, **sw2},
            "launches": {"xe,wxe": l1, "cst": l2}}


def add_tool_readings(kernels, osim, reh):
    """Phase 5b's and 6d's launches (``overlap_sim_launches``,
    ``rehearsal_launches``) on the entries of the kernels they ran, and
    their readings on ``lstm_recurrence``'s entry."""
    runs = {"overlap_sim": osim["launches"],
            "rehearsal_xe_wxe": reh["launches"]["xe,wxe"],
            "rehearsal_cst": reh["launches"]["cst"]}
    for k in kernels:
        got = {run: c[k["name"]] for run, c in runs.items()
               if c.get(k["name"])}
        if got:
            k["tool_launches"] = got
    rec = next(k for k in kernels if k["name"] == "lstm_recurrence")
    rec["overlap_sim"] = osim["result"]
    rec["rehearsal"] = {k: v for k, v in reh.items() if k != "launches"}


def add_eval_readings(kernels, ev, aev, pev):
    """Phase 6's launches (``eval_launches``, per run) and readings on
    the beam kernels' and ``row_gemm``'s entries."""
    by_name = {k["name"]: k for k in kernels}
    runs = {f"6a_{k}": v for k, v in ev["launches"].items()}
    runs["6b_attention_f32"] = aev["launches"]
    runs["6c_pipeline"] = pev["launches"]
    cli = ev.get("cli_test") or pev.get("cli_test")
    runs["cli_test"] = cli["launches"]
    for k in kernels:
        got = {run: counts[k["name"]] for run, counts in runs.items()
               if k["name"] in counts}
        if got:
            k["eval_launches"] = got
    mean = lambda xs: sum(xs) / len(xs)  # noqa: E731
    by_name["lstm_beam"].update(
        eval_f32_vs_plain=ev["f32"], eval_max_abs_err_bf16=ev["bf16_err"],
        eval_beam_ms_per_batch_bf16=mean(ev["ms_bf16"]),
        eval_beam_ms_per_batch_f32=mean(ev["ms_f32"]),
        eval_plain_ms_per_batch_bf16=mean(ev["plain_ms_bf16"]),
        eval_launches_per_batch_bf16=ev["launches_per_batch_bf16"],
        eval_batch_device_ms_bf16=ev["batch_device_ms_bf16"],
        eval_videos_per_s=ev["videos_per_s"],
        eval_videos_per_s_packed=ev["videos_per_s_packed"],
        eval_assembly_ms=ev["assembly_ms"], eval_metric_s=ev["metric_s"],
        eval_metric_parts_s=ev["metric_parts_s"], eval_h5py=ev["h5py"],
        eval_scores=ev["scores"], pipeline=pev)
    by_name["attlstm_beam"].update(
        eval_f32_vs_plain=aev["f32"],
        eval_beam_ms_per_batch_f32=mean(aev["ms_f32"]),
        eval_plain_ms_per_batch_f32=mean(aev["plain_ms_f32"]))


# ------------------------------------------------------------ phase 7

SERVE_PRESET = "msrvtt_serve_beam5"
N_SERVE_VIDEOS = 64      # 7a: the first batch of 6a's eval corpus
N_CLI_REQUESTS = 8       # 7a: requests through cli/serve.main
N_CAT_XE_STEPS = 3       # 7c: XE steps of the category model
N_CAT_EVAL_VIDEOS = 128  # 7c: 2 beam batches
N_CAT_REQUESTS = 32      # 7c: served requests carrying a category
N_CAT_ATT_VIDEOS = 64    # 7c: one attention beam batch
SLOT_ADMIT = 8           # requests admitted a tick in the direct slot runs
# row_gemm launches of one meanpool ladder batch: the two feature
# projections and the static context's gate rows (the category's gate
# rows are one more); of a slot-loop tick that admits: the two
# projections; of a meanpool decode step: the gates and the vocab.
LADDER_ROW_GEMM = 3
ADMIT_ROW_GEMM = 2
STEP_ROW_GEMM = 2


def serve_cfg(dtype: str = "f32", continuous: bool = False,
              f32: bool = False, category: bool = False, layers: int = 1):
    """``msrvtt_serve_beam5`` at full width (V = 10,496) as the engine's
    configuration: the ladder or the slot loop, ``serving.dtype``,
    float32 compute with ``f32``, ``model.use_category``,
    ``model.num_layers``."""
    from cst_captioning_torch.config import parse_cli

    argv = ["--preset", SERVE_PRESET, "--serving.port", "0",
            "--serving.continuous", "true" if continuous else "false",
            "--serving.dtype", dtype, "--serving.warmup", "false",
            "--model.vocab_size", str(V)]
    if f32:
        argv += ["--model.compute_dtype", "float32"]
    if category:
        argv += ["--model.use_category", "true"]
    if layers != 1:
        argv += ["--model.num_layers", str(layers)]
    return parse_cli(argv)


def video_payloads(ds, idx, category: bool = False):
    """Requests carrying videos ``idx`` of ``ds``: every frame of each
    modality (the engine pads and masks them as the loader does) and,
    with ``category``, the video's category id."""
    out = []
    for i in idx:
        p = {"features": ds.features(i)}
        if category:
            p["category"] = int(ds.category(i))
        out.append(p)
    return out


def ladder_serve(engine, payloads):
    """(tokens (n, L) int64 on the host, scores None) of ``payloads``
    through the engine's ladder, in batches of its top."""
    import torch

    reqs = [engine.prepare(p) for p in payloads]
    toks = []
    for i in range(0, len(reqs), engine.max_batch):
        toks += [r.tokens for r in engine.decode_prepared(
            reqs[i: i + engine.max_batch], store=False)]
    return torch.tensor(toks)


def slot_serve(engine, payloads):
    """``payloads`` through the engine's slot loop, SLOT_ADMIT admitted
    a tick (elastic banks).  Returns ({i: {"tokens", "score"}}, ticks
    that admitted, decode steps run)."""
    dec = engine.slot_decoder()
    reqs = [engine.prepare(p) for p in payloads]
    got, pending, admits = {}, list(range(len(reqs))), 0
    steps0 = dec.steps_run
    while pending or dec.occupied:
        dec.maybe_resize(len(pending))
        n = min(SLOT_ADMIT, len(pending), len(dec.free), dec.admit_cap)
        adm = [pending.pop(0) for _ in range(n)]
        admits += bool(adm)
        for i, toks, score, _ in dec.harvest_many(
                dec.tick([reqs[i] for i in adm], adm)):
            got[i] = {"tokens": [int(t) for t in toks], "score": score}
    return got, admits, dec.steps_run - steps0


def served_tensor(torch, served: dict):
    return torch.tensor([served[i]["tokens"] for i in range(len(served))])


def beam_batch_ms(torch, engine, payloads) -> float:
    """CUDA-event ms of the engine's beam decode (encode, static gates,
    ``lstm_beam``) of the first ladder batch of ``payloads``, as 6a times
    an eval batch: REPS calls after a warm-up."""
    reqs = [engine.prepare(p) for p in payloads[: engine.max_batch]]
    feats, masks = engine._assemble(reqs, len(reqs))
    cat = engine._categories(reqs, len(reqs))
    mode, engine.decode_mode = engine.decode_mode, "beam"
    try:
        return time_call(torch, lambda: engine._decode(feats, masks, cat),
                         REPS)
    finally:
        engine.decode_mode = mode


def cli_serve(torch, argv, payloads, what: str):
    """``cli/serve.main(argv)`` as a user runs it, in a thread: the
    server it builds is recorded (a subclass of ``CaptionServer`` binding
    port 0), ``payloads`` are POSTed to it concurrently, then it is shut
    down and ``main`` must return 0.  Returns (responses, engine)."""
    from cst_captioning_torch.cli import serve as cli_mod
    from cst_captioning_torch.serving import server as server_mod

    made = []
    inner = server_mod.CaptionServer

    class Recording(inner):
        def __init__(self, engine, **kw):
            super().__init__(engine, port=0, **kw)
            made.append(self)

    rc = []

    def run():
        try:
            rc.append(cli_mod.main(argv))
        except BaseException as e:  # noqa: BLE001 — reported below
            rc.append(e)

    server_mod.CaptionServer = Recording
    t = threading.Thread(target=run, name="cli-serve", daemon=True)
    t0 = time.perf_counter()
    t.start()
    try:
        while not (made and made[0]._listening):
            if rc or time.perf_counter() - t0 > 300:
                fail(f"{what}: cli/serve.main did not start serving: {rc}")
            time.sleep(0.05)
    finally:
        server_mod.CaptionServer = inner
    srv = made[0]
    boot = time.perf_counter() - t0
    out, errs = {}, []

    def worker(i):
        try:
            out[i] = post(srv.url + "/v1/caption", payloads[i])
        except Exception as e:  # noqa: BLE001 — reported below
            errs.append(f"{type(e).__name__}: {e}")

    ths = [threading.Thread(target=worker, args=(i,))
           for i in range(len(payloads))]
    for th in ths:
        th.start()
    for th in ths:
        th.join()
    srv.shutdown()
    t.join(timeout=120)
    # cli/serve.main configured the root logger for INFO: quiet it again.
    logging.getLogger().setLevel(logging.WARNING)
    if t.is_alive() or rc != [0]:
        fail(f"{what}: cli/serve.main returned {rc}")
    if errs:
        fail(f"{what}: requests failed: {errs[:3]}")
    log(f"{what}: booted and warmed in {boot:.1f} s, {len(out)} requests "
        f"served, then shut down (rc 0)")
    return out, srv.engine


def check_trained_serving(torch, card: str, checkpoint: str, ev: dict,
                          counted, tmp: str):
    """Phase 7a: serve phase 5's CST checkpoint (``checkpoint``) through
    ``InferenceEngine(cfg, checkpoint=...)`` and ``cli/serve.main``.
    ``ev`` is phase 6a's readings (the eval corpus and its f32 tokens);
    ``counted``: the lstm_beam, lstm_sample and row_gemm wrappers."""
    from cst_captioning_torch.serving.engine import InferenceEngine
    from cst_captioning_torch.training.checkpoint import save_params

    t0 = time.perf_counter()
    res = {"launches": {}}
    corpus, vocab = ev["corpus"], ev["vocab"]
    n = N_SERVE_VIDEOS
    payloads = video_payloads(corpus, range(n))
    want = ev["f32_tokens"][:n].cpu()

    # f32 ladder, beam: the eval's tokens for the same videos.
    eng = InferenceEngine(serve_cfg(f32=True), checkpoint=checkpoint,
                          vocab=vocab, device=DEVICE)
    if f"|{checkpoint}|" not in eng.params_tag:
        fail(f"7a: the tier-1 tag {eng.params_tag!r} lacks the checkpoint")
    nl = -(-n // eng.max_batch)   # ladder batches
    zero(counted)
    t1 = time.perf_counter()
    f32_ladder = ladder_serve(eng, payloads)
    torch.cuda.synchronize()
    res["f32_ladder_s"] = time.perf_counter() - t1
    res["launches"]["f32_ladder_beam"] = hold_launches(
        counted, {"lstm_beam": nl, "lstm_beam_quant": 0, "lstm_sample": 0,
                  "lstm_sample_quant": 0, "row_gemm": LADDER_ROW_GEMM * nl,
                  "row_gemm_quant": 0}, f"7a f32 ladder beam, {n} videos")
    same = int((f32_ladder == want).all(-1).sum())
    log(f"7a serve {checkpoint} f32 ladder beam: {same}/{n} captions equal "
        f"to evaluate_dataset's (6a f32) for the same videos")
    if same != n:
        fail("7a: the served f32 captions differ from evaluate_dataset's")
    res["f32_beam_ms"] = beam_batch_ms(torch, eng, payloads)
    # f32 ladder, greedy: the kernel's launches, and the tokens of the
    # model's own fused sampler on the same batch.
    eng.decode_mode = "greedy"
    zero(counted)
    greedy = ladder_serve(eng, payloads)
    res["launches"]["f32_ladder_greedy"] = hold_launches(
        counted, {"lstm_beam": 0, "lstm_beam_quant": 0, "lstm_sample": nl,
                  "lstm_sample_quant": 0, "row_gemm": LADDER_ROW_GEMM * nl,
                  "row_gemm_quant": 0}, f"7a f32 ladder greedy, {n} videos")
    reqs = [eng.prepare(p) for p in payloads]
    direct = torch.cat([eng.model.sample(
        *eng._assemble(reqs[i: i + eng.max_batch],
                       len(reqs[i: i + eng.max_batch])),
        greedy=True, max_len=eng.cfg.eval.max_decode_len).tokens.cpu()
        for i in range(0, n, eng.max_batch)])
    if not torch.equal(greedy, direct.long()):
        fail("7a: served greedy captions differ from the model's sampler")
    del eng

    # f32 continuous: bit for bit the offline per-step decode.
    eng = InferenceEngine(serve_cfg(continuous=True, f32=True),
                          checkpoint=checkpoint, vocab=vocab, device=DEVICE)
    zero(counted)
    f32_slots, admits, steps = slot_serve(eng, payloads)
    torch.cuda.synchronize()
    res["launches"]["f32_continuous"] = hold_launches(
        counted, {"lstm_beam": 0, "lstm_beam_quant": 0, "lstm_sample": 0,
                  "lstm_sample_quant": 0,
                  "row_gemm": ADMIT_ROW_GEMM * admits + STEP_ROW_GEMM * steps,
                  "row_gemm_quant": 0},
        f"7a f32 continuous ({admits} admitting ticks, {steps} steps)")
    off32 = offline_decodes(torch, eng, payloads)
    share, _, gap = caption_match(f32_slots, *off32["per_step"])
    lshare = token_match(served_tensor(torch, f32_slots), want)
    log(f"7a f32 continuous: served vs offline per-step decode caption match "
        f"{share:.4f} (max |score diff| {gap}); vs the ladder / "
        f"evaluate_dataset's kernel {lshare:.4f} (a reading)")
    if share != 1.0:
        fail("7a f32 continuous: served differs from the offline per-step "
             "decode")
    res["f32"] = {"ladder_equal_eval": same, "continuous_match_per_step":
                  share, "continuous_vs_ladder": lshare}
    del eng

    # bf16 and int8w: 3c / 3d's holds on the trained weights.
    low = {}
    for dtype in ("bf16", "int8w"):
        eng = InferenceEngine(serve_cfg(dtype, continuous=True),
                              checkpoint=checkpoint, vocab=vocab,
                              device=DEVICE)
        zero(counted)
        lad = ladder_serve(eng, payloads)
        q = int(dtype == "int8w")
        res["launches"][f"{dtype}_ladder_beam"] = hold_launches(
            counted, {"lstm_beam": (1 - q) * nl, "lstm_beam_quant": q * nl,
                      "lstm_sample": 0, "lstm_sample_quant": 0,
                      "row_gemm": LADDER_ROW_GEMM * nl,
                      "row_gemm_quant": q * nl}, f"7a {dtype} ladder beam")
        zero(counted)
        served, admits, steps = slot_serve(eng, payloads)
        res["launches"][f"{dtype}_continuous"] = hold_launches(
            counted, {"lstm_beam": 0, "lstm_beam_quant": 0, "lstm_sample": 0,
                      "lstm_sample_quant": 0,
                      "row_gemm": ADMIT_ROW_GEMM * admits
                      + STEP_ROW_GEMM * steps,
                      "row_gemm_quant": q * STEP_ROW_GEMM * steps},
            f"7a {dtype} continuous ({admits} admitting ticks, {steps} "
            "steps)")
        off = offline_decodes(torch, eng, payloads)
        row = relaxed_holds(f"7a {dtype} continuous", served,
                            off["per_step"], lad, off32["per_step"],
                            f32_ladder)
        row["beam_ms"] = beam_batch_ms(torch, eng, payloads)
        row["served_vs_f32_ladder"] = token_match(
            served_tensor(torch, served), f32_ladder)
        row["ladder_vs_eval_f32"] = token_match(lad, want)
        low[dtype] = dict(row, served=served, ladder=lad, engine=eng)
    res["bf16"] = {k: v for k, v in low["bf16"].items()
                   if k not in ("served", "ladder", "engine")}

    # int8w from a quantized save: the same codes and captions.
    qdir = os.path.join(tmp, "int8w_save")
    qeng = low["int8w"]["engine"]
    save_params(qdir, qeng.model, {"phase": "7a", "quantized": True})
    eng = InferenceEngine(serve_cfg("int8w", continuous=True),
                          checkpoint=qdir, vocab=vocab, device=DEVICE)
    same_codes = all(torch.equal(v, qeng.model.state_dict()[k])
                     for k, v in eng.model.state_dict().items())
    same_ladder = torch.equal(ladder_serve(eng, payloads),
                              low["int8w"]["ladder"])
    qserved, _, _ = slot_serve(eng, payloads)
    same_slots = qserved == low["int8w"]["served"]
    log(f"7a int8w from a quantized save ({qdir}): codes and scales equal "
        f"to quantize-at-boot {same_codes}; ladder captions equal "
        f"{same_ladder}; slot-loop captions equal {same_slots}")
    if not (same_codes and same_ladder and same_slots):
        fail("7a: the quantized save serves otherwise than quantize-at-boot")
    res["int8w"] = {k: v for k, v in low["int8w"].items()
                    if k not in ("served", "ladder", "engine")}
    res["int8w"]["quantized_save_equal"] = True
    bf16_served = low["bf16"]["served"]
    del eng, qeng, low

    # cli/serve.main --checkpoint, the preset's defaults (the slot loop,
    # bf16, warm-up on): the direct bf16 slot run's captions.
    vf = save_vocab(vocab, tmp)
    idx = list(range(N_CLI_REQUESTS))
    body = [{"features": {m: a.tolist() for m, a in p["features"].items()}}
            for p in video_payloads(corpus, idx)]
    out, ceng = cli_serve(
        torch, ["--checkpoint", checkpoint, "--preset", SERVE_PRESET,
                "--data.vocab_file", vf], body,
        "7a cli/serve.main --checkpoint")
    if ceng.params_tag.split("|")[1] != checkpoint or \
            ceng.model.compute_dtype != torch.bfloat16:
        fail(f"7a: cli/serve built {ceng.params_tag!r}")
    cli_same = sum(out[i]["tokens"] == bf16_served[i]["tokens"] for i in idx)
    log(f"7a cli/serve.main: {cli_same}/{len(idx)} captions equal to the "
        f"direct bf16 slot run's; first {out[0]['caption'][:80]!r}")
    if cli_same != len(idx):
        fail("7a: cli/serve's captions differ from the engine's")
    del ceng
    res["cli_serve_equal"] = cli_same
    res["f32_ladder_tokens"] = f32_ladder
    res["wall_s"] = time.perf_counter() - t0
    log(f"7a took {res['wall_s']:.1f} s  [{card}]")
    return res


def check_import_on_card(torch, card: str, checkpoint: str, ev: dict,
                         f32_ladder, counted, tmp: str):
    """Phase 7b: phase 5's state dict written in the exporter's npz
    format (``state_dict_to_params``: the flat names, float32), imported
    by ``tools/import_jax_checkpoint.main`` into a params-only
    checkpoint and served: the f32 ladder's captions of 7a."""
    import shutil

    import numpy as np

    from cst_captioning_torch.models.weights import state_dict_to_params
    from cst_captioning_torch.serving.engine import InferenceEngine
    from cst_captioning_torch.tools import import_jax_checkpoint as importer
    from cst_captioning_torch.training import checkpoint as ckpt_mod

    export = os.path.join(tmp, "export")
    os.makedirs(export, exist_ok=True)
    flat = state_dict_to_params(ckpt_mod.load_params_file(checkpoint))
    np.savez(os.path.join(export, importer.NPZ_FILE), **flat["params"])
    shutil.copyfile(os.path.join(checkpoint, ckpt_mod.INFOS_FILE),
                    os.path.join(export, ckpt_mod.INFOS_FILE))
    port = os.path.join(tmp, "imported")
    vf = save_vocab(ev["vocab"], tmp)
    rc = importer.main(["--export", export, "--out", port, "--preset",
                        SERVE_PRESET, "--data.vocab_file", vf])
    files = sorted(os.listdir(port))
    eng = InferenceEngine(serve_cfg(f32=True), checkpoint=port,
                          vocab=ev["vocab"], device=DEVICE)
    zero(counted)
    toks = ladder_serve(eng, video_payloads(ev["corpus"],
                                            range(N_SERVE_VIDEOS)))
    nl = -(-N_SERVE_VIDEOS // eng.max_batch)
    launches = hold_launches(
        counted, dict(lstm_beam=nl,
                      row_gemm=LADDER_ROW_GEMM * nl), "7b f32 ladder beam")
    same = torch.equal(toks, f32_ladder)
    log(f"7b import of phase 5's weights through the exporter's npz: rc "
        f"{rc}, files {files}; served f32 ladder captions identical to "
        f"7a's: {same}; launches {launches}  [{card}]")
    if rc != 0 or files != [ckpt_mod.INFOS_FILE, ckpt_mod.PARAMS_FILE] \
            or not same:
        fail("7b: the imported checkpoint does not serve 7a's captions")
    return {"identical": same, "launches": launches}


def category_trainer(torch, fusion: str, train_ds, workdir: str):
    """The port's ``Trainer`` on ``msrvtt_resnet_c3d_xe`` with
    ``model.use_category`` (20 categories, C = 64), ``fusion``, over
    ``train_ds``."""
    from cst_captioning_torch.training.trainer import Trainer

    cfg = train_cfg(fusion)
    cfg.model.use_category = True
    cfg.train.checkpoint_dir = workdir
    trainer = Trainer(cfg, train_ds, None, device=DEVICE)
    m = trainer.model
    if (m.category_embed_size, m.num_categories, m.in_dim) != (
            64, 20, 2 * E + 64):
        fail(f"7c: category widths "
             f"{(m.category_embed_size, m.num_categories)}")
    return trainer, cfg


def xe_steps(torch, trainer, n: int):
    """``n`` of the trainer's own XE steps on its first batches, as
    ``train_epoch`` calls them (the batch's category ids into the
    step).  Returns the losses."""
    from cst_captioning_torch.data.loader import to_device

    out = []
    for i, b in enumerate(trainer.train_iter.epoch(0)):
        if i == n:
            break
        b = to_device(b, torch.device(DEVICE))
        m = trainer._train_step(b.feats, b.feat_masks, b.captions,
                                torch.ones_like(b.weights), b.category,
                                b.video_idx, trainer._step_generator(0, i),
                                0.0)
        out.append(float(m["loss"]))
    torch.cuda.synchronize()
    if len(out) != n or not all(math.isfinite(x) for x in out):
        fail(f"7c: XE losses {out}")
    return out


def category_witness(torch, engine, ds):
    """The same video under two categories: different ``gx_static`` rows
    from the card's encode and static-gate products, and different
    tier-1 keys."""
    reqs = [engine.prepare(dict(p, category=c)) for c in (3, 11)
            for p in video_payloads(ds, [0])]
    feats, masks = engine._assemble(reqs, 2)
    m = engine.model
    with torch.no_grad():
        cache = m._encode(feats, masks, engine._categories(reqs, 2))
        gx = m._fused_gx_static(cache)
    if gx.device.type != torch.device(DEVICE).type:
        fail("7c: the category witness ran off the card")
    diff = float((gx[0] - gx[1]).abs().max())
    keys = reqs[0].cache_key != reqs[1].cache_key
    same_rows = torch.equal(cache.ctx_static[0], cache.ctx_static[1])
    log(f"7c category witness: one video under categories 3 and 11: "
        f"ctx_static rows equal {same_rows}, gx_static rows differ by up to "
        f"{diff:.4e}, tier-1 keys differ {keys}")
    if not same_rows or diff == 0.0 or not keys:
        fail("7c: the category term is dropped on the kernel path or the "
             "cache key")
    return {"gx_static_max_diff": diff, "keys_differ": keys}


def check_category(torch, card: str, counted, plain, beam_mod, sam_mod,
                   tmp: str):
    """Phase 7c, see the module docstring.  ``counted``: the wrappers
    whose launches are held; ``plain``: {captioner attribute: plain
    autograd recurrence} for the f32 XE steps."""
    import numpy as np

    from cst_captioning_torch.data.vocab import Vocabulary
    from cst_captioning_torch.models import captioner
    from cst_captioning_torch.serving.engine import InferenceEngine
    from cst_captioning_torch.training import checkpoint as ckpt_mod
    from cst_captioning_torch.training import cst as cst_mod

    t0 = time.perf_counter()
    res = {"launches": {}}
    vocab = Vocabulary([f"w{i}" for i in range(V - 4)])
    cfg0 = train_cfg("meanpool")
    ncat = cfg0.data.num_categories
    train_ds = make_msrvtt_corpus(np, vocab, cfg0, N_TRAIN_VIDEOS, 1, ncat)
    eval_ds = make_msrvtt_corpus(np, vocab, cfg0, N_CAT_EVAL_VIDEOS,
                                 EVAL_SEED, ncat)
    log(f"7c corpora: {N_TRAIN_VIDEOS} + {N_CAT_EVAL_VIDEOS} videos, "
        f"{len(set(train_ds._cats))} of {ncat} categories drawn, built in "
        f"{time.perf_counter() - t0:.1f} s")

    # Meanpool: 3 XE steps, an f32 step kernel vs plain.
    trainer, cfg = category_trainer(torch, "meanpool", train_ds,
                                    os.path.join(tmp, "xe"))
    zero(counted)
    losses = xe_steps(torch, trainer, N_CAT_XE_STEPS)
    res["launches"]["xe_meanpool"] = hold_launches(
        counted, dict(lstm_recurrence=N_CAT_XE_STEPS),
        f"7c {N_CAT_XE_STEPS} XE steps, meanpool with categories")
    log(f"7c XE losses {[round(x, 4) for x in losses]}")
    res["xe_step_ms"] = step_breakdown(torch, trainer, card)
    res["xe_f32"] = check_xe_step(torch, trainer, cfg, "lstm_recurrence",
                                  plain["lstm_recurrence"])
    xe_best = os.path.join(tmp, "xe", "best")
    ckpt_mod.save_checkpoint(xe_best, trainer.model, trainer.optimizer,
                             {"phase": "7c"})
    del trainer

    # One CST scb step from it: the chunks' static gates gain the
    # category's rows (one more row_gemm a chunk).
    ctrainer, _, batches = cst_trainer(torch, "meanpool", xe_best,
                                       os.path.join(tmp, "cst"), train_ds,
                                       use_category=True)
    ccfg = ctrainer.cfg
    Kc = cst_mod._chunk_count(ccfg.train.cst_score_chunks,
                              ccfg.data.batch_size)
    windows, last, restore = cst_probe(torch, ctrainer.model)
    try:
        zero(counted)
        m, ph, wall, dev = run_cst_step(torch, ctrainer._train_step,
                                        batches[0], 40, windows)
        res["launches"]["cst_meanpool"] = hold_launches(
            counted, dict(lstm_sample=Kc,
                          lstm_recurrence=1, row_gemm=2 + 2 * Kc),
            "7c one CST scb step with categories")
        res["cst_step"] = log_cst_step("7c meanpool scb, categories", m, ph,
                                       wall, dev, card)
    finally:
        restore()
    if last.get("category") is None or not torch.equal(
            last["category"], batches[0].category):
        fail("7c: the CST update did not take the batch's categories")
    res["pg_loss_f32"] = check_pg_loss(
        torch, ctrainer, last, ("lstm_recurrence", plain["lstm_recurrence"],
                                captioner.lstm_recurrence))
    res["rollout_f32"] = check_f32_rollout(torch, ctrainer, batches[0],
                                           sam_mod)
    cst_best = os.path.join(tmp, "cst", "best")
    ckpt_mod.save_checkpoint(cst_best, ctrainer.model, ctrainer.optimizer,
                             {"phase": "7c"})
    del ctrainer, batches

    # Beam-5 eval of 128 videos, f32 kernel vs plain.
    ecfg = eval_cfg(dtype="float32")
    ecfg.model.use_category = True
    nb = N_CAT_EVAL_VIDEOS // ecfg.data.batch_size
    model = eval_model(ecfg, cst_best)
    zero(counted)
    k = run_eval(torch, "7c f32 kernel, categories", model, eval_ds, ecfg,
                 os.path.join(tmp, "eval"), card)
    res["launches"]["eval_meanpool"] = hold_launches(
        counted, dict(lstm_beam=nb,
                      row_gemm=(EVAL_ROW_GEMM + 1) * nb),
        "7c eval with categories, f32 kernel")
    with swapped(captioner, "lstm_beam", beam_mod.lstm_beam_ref):
        p = run_eval(torch, "7c f32 plain, categories", model, eval_ds, ecfg,
                     os.path.join(tmp, "eval_plain"), card)

    def witness():
        mp = permuted_model(torch, model, seed=5)
        with swapped(captioner, "lstm_beam", beam_mod.lstm_beam_ref):
            return run_eval(torch, "7c f32 plain, H-permuted", mp, eval_ds,
                            ecfg, os.path.join(tmp, "eval_witness"),
                            card)["preds"]

    res["eval_f32"] = hold_f32_eval(torch, "7c meanpool, categories", k, p,
                                    witness)
    del model

    # Served with a category: the ladder (the eval's f32 tokens for the
    # same videos) and the slot loop (the offline per-step decode).
    payloads = video_payloads(eval_ds, range(N_CAT_REQUESTS), category=True)
    eng = InferenceEngine(serve_cfg(f32=True, category=True),
                          checkpoint=cst_best, vocab=vocab, device=DEVICE)
    nl = -(-N_CAT_REQUESTS // eng.max_batch)
    zero(counted)
    lad = ladder_serve(eng, payloads)
    res["launches"]["serve_ladder"] = hold_launches(
        counted, dict(lstm_beam=nl,
                      row_gemm=(LADDER_ROW_GEMM + 1) * nl),
        f"7c f32 ladder, {N_CAT_REQUESTS} requests with categories")
    lsame = int((lad == k["tokens"][:N_CAT_REQUESTS].cpu()).all(-1).sum())
    res["witness"] = category_witness(torch, eng, eval_ds)
    del eng
    eng = InferenceEngine(serve_cfg(continuous=True, f32=True, category=True),
                          checkpoint=cst_best, vocab=vocab, device=DEVICE)
    zero(counted)
    served, admits, steps = slot_serve(eng, payloads)
    res["launches"]["serve_continuous"] = hold_launches(
        counted, dict(row_gemm=ADMIT_ROW_GEMM * admits
                      + STEP_ROW_GEMM * steps),
        f"7c f32 continuous with categories ({admits} admitting ticks, "
        f"{steps} steps)")
    off = offline_decodes(torch, eng, payloads)
    share, _, gap = caption_match(served, *off["per_step"])
    log(f"7c served with categories: ladder {lsame}/{N_CAT_REQUESTS} equal "
        f"to the eval's f32 tokens; continuous vs offline per-step decode "
        f"{share:.4f} (max |score diff| {gap})")
    if lsame != N_CAT_REQUESTS or share != 1.0:
        fail("7c: captions served with a category differ from the eval's "
             "or the offline per-step decode's")
    res["serve"] = {"ladder_equal_eval": lsame, "continuous_match": share}
    del eng

    # Attention, at a smaller depth: one XE step, one beam batch.
    atrainer, acfg = category_trainer(torch, "attention", train_ds,
                                      os.path.join(tmp, "att"))
    zero(counted)
    xe_steps(torch, atrainer, 1)
    res["launches"]["xe_attention"] = hold_launches(
        counted, dict(attlstm_recurrence=1,
                      attlstm_recurrence_bwd=1),
        "7c one attention XE step with categories")
    res["att_xe_f32"] = check_xe_step(torch, atrainer, acfg,
                                      "attlstm_recurrence",
                                      plain["attlstm_recurrence"])
    att_best = os.path.join(tmp, "att", "best")
    ckpt_mod.save_checkpoint(att_best, atrainer.model, atrainer.optimizer,
                             {"phase": "7c"})
    del atrainer
    acfg_e = eval_cfg("attention", "float32")
    acfg_e.model.use_category = True
    amodel = eval_model(acfg_e, att_best)
    att_ds = make_msrvtt_corpus(np, vocab, acfg_e, N_CAT_ATT_VIDEOS,
                                EVAL_SEED, ncat)
    zero(counted)
    ak = run_eval(torch, "7c attention f32 kernel, categories", amodel,
                  att_ds, acfg_e, os.path.join(tmp, "att_eval"), card)
    anb = N_CAT_ATT_VIDEOS // acfg_e.data.batch_size
    res["launches"]["eval_attention"] = hold_launches(
        counted, dict(attlstm_beam=anb,
                      row_gemm=(EVAL_ROW_GEMM + 1) * anb),
        "7c attention beam batch with categories, f32 kernel")
    with swapped(captioner, "attlstm_beam", beam_mod.attlstm_beam_ref):
        ap = run_eval(torch, "7c attention f32 plain, categories", amodel,
                      att_ds, acfg_e, os.path.join(tmp, "att_plain"), card)
    res["att_eval_f32"] = hold_f32_eval(torch, "7c attention, categories",
                                        ak, ap)
    res["wall_s"] = time.perf_counter() - t0
    log(f"7c took {res['wall_s']:.1f} s  [{card}]")
    return res


def add_phase7_readings(kernels, a, b, c):
    """Phase 7's launches per run on the entries of the kernels it ran,
    and its readings on ``lstm_beam``'s."""
    runs = {f"7a_{k}": v for k, v in a["launches"].items()}
    runs["7b_import_f32_ladder"] = b["launches"]
    runs.update({f"7c_{k}": v for k, v in c["launches"].items()})
    for k in kernels:
        got = {}
        for run, cnt in runs.items():
            for key in (k["name"], k["name"] + "_quant"):
                if cnt.get(key):
                    got[run if key == k["name"] else run + "_int8w"] = cnt[key]
        if got:
            k["phase7_launches"] = got
    by_name = {k["name"]: k for k in kernels}
    by_name["lstm_beam"]["phase7"] = {
        "7a": {key: a[key] for key in ("f32", "f32_beam_ms", "bf16", "int8w",
                                       "cli_serve_equal", "wall_s")},
        "7b": {"identical": b["identical"]},
        "7c": {key: c[key] for key in ("xe_f32", "xe_step_ms", "pg_loss_f32",
                                       "cst_step",
                                       "rollout_f32", "eval_f32", "serve",
                                       "witness", "att_xe_f32",
                                       "att_eval_f32", "wall_s")}}


def add_replica_readings(kernels, reps):
    """Phase 3e's launches per run on the ``row_gemm`` and
    ``fused_context_attention`` entries, and its readings on
    ``row_gemm``'s."""
    by_name = {k["name"]: k for k in kernels}
    for name, key in (("row_gemm", "row_dot"),
                      ("fused_context_attention", "fused_context_attention")):
        runs = {run: v[key] for run, v in reps["launches"].items()
                if v[key]}
        by_name[name]["phase3e_launches"] = runs
        by_name[name]["phase3e_launches_total"] = sum(runs.values())
    by_name["row_gemm"]["replica_serving"] = {
        k: reps[k] for k in ("f32", "kill", "hedge", "burst", "tick",
                             "overload", "profile", "sigterm", "spans",
                             "wall_s")}


def add_tier_readings(kernels, tier):
    """Phase 3f's launches per pass on the ``row_gemm`` and
    ``fused_context_attention`` entries, and its readings on
    ``row_gemm``'s."""
    by_name = {k["name"]: k for k in kernels}
    for name, key in (("row_gemm", "row_dot"),
                      ("fused_context_attention", "fused_context_attention")):
        runs = {run: v[key] for run, v in tier["launches"].items()}
        by_name[name]["phase3f_launches"] = runs
        by_name[name]["phase3f_launches_total"] = sum(runs.values())
    by_name["row_gemm"]["feature_cache"] = {
        k: tier[k] for k in ("direct", "entry_bytes", "replicas", "burst",
                             "overfill", "wall_s")}


# ------------------------------------------------------------ main

# ------------------------------------------------------------ phase 8

STACK_LAYERS = 2
STACK_XE_TIMED = 3        # 8a / 8b: timed bf16 XE steps, after a warm-up
STACK_CST_TIMED = 2       # 8c: timed CST steps, after one warm-up step
STACK_GEOMETRIES = (("padded", 0, 1), ("slot", 0, 1), ("slot", 0, 2))
STACK_EVAL_VIDEOS = 128   # 8d: 2 beam batches of 64
STACK_SERVE_VIDEOS = 64   # 8e: the first batch of 8d's corpus
STACK_CLI_REQUESTS = 8    # 8e: requests through each cli/serve.main run
# row_gemm launches of a meanpool encode: the two feature projections.
# A stacked decode step launches ``step_rg``: each layer's gates, the
# vocab (and, under attention, the query).
STACK_ENCODE_RG = 2


class decode_steps:
    """Counts ``model``'s decode steps (``decode_logits`` calls) inside a
    ``with`` block, by an instance attribute over the method."""

    def __init__(self, model):
        self.model, self.n = model, 0

    def __enter__(self):
        inner = self.model.decode_logits

        def counting(*args, **kw):
            self.n += 1
            return inner(*args, **kw)

        self.model.decode_logits = counting
        return self

    def __exit__(self, *exc):
        del self.model.decode_logits


def stacked_counted():
    """Every wrapper phase 8 counts: the four kernels its path runs, and
    the single-layer kernels, which it must not launch."""
    from cst_captioning_torch.ops import attention, attlstm, beam, lstm
    from cst_captioning_torch.ops import rowgemm, sampler, threefry

    return {"lstm_recurrence": lstm.lstm_recurrence,
            "lstm_recurrence_quant": lstm.lstm_recurrence_quant,
            "fused_context_attention": attention.fused_context_attention,
            "fused_context_attention_bwd":
                attention.fused_context_attention_bwd,
            "row_gemm": rowgemm.row_dot,
            "threefry_sample": threefry.threefry_sample,
            "lstm_beam": beam.lstm_beam, "attlstm_beam": beam.attlstm_beam,
            "lstm_sample": sampler.lstm_sample,
            "attlstm_sample": sampler.attlstm_sample,
            "attlstm_recurrence": attlstm.attlstm_recurrence}


def tf_inputs(b):
    """(caption-row inputs (B*S, T), S) of a training batch."""
    Bv, S, L = b.captions.shape
    return b.captions.long().reshape(Bv * S, L)[:, :-1], S


def layer_inputs(torch, model, b):
    """Each layer's (gx, W_h) as one teacher-forced forward of batch
    ``b`` hands them to ``lstm_recurrence`` (no autograd)."""
    from cst_captioning_torch.models import captioner

    seen, inner = [], captioner.lstm_recurrence

    def spy(gx, wh):
        seen.append((gx.detach().clone(), wh.detach().clone()))
        return inner(gx, wh)

    inputs, S = tf_inputs(b)
    with swapped(captioner, "lstm_recurrence", spy), torch.no_grad():
        model(b.feats, b.feat_masks, inputs, repeat=S)
    return seen


def hold_layer_recurrences(torch, lstm_mod, pairs, tag: str, card: str):
    """8a: each layer's recurrence kernel vs its plain version on the
    layer's own gx (layer 1's from layer 0's h sequence), at 2b's tiers;
    kernel (events, REPS calls) and plain (one call) ms."""
    fwd, ref = lstm_mod.lstm_recurrence_fwd, lstm_mod.lstm_recurrence_ref
    out = []
    for layer, (gx, wh) in enumerate(pairs):
        kh, kc = fwd(gx, wh, with_cell=True)
        rh, rc = ref(gx, wh, with_cell=True)
        torch.cuda.synchronize()
        err = {"h": max_diff(kh, rh)}
        if wh.dtype == torch.float32:
            err["c"] = max_diff(kc, rc)
            ok = max(err.values()) <= REC_F32_ATOL
        else:
            err["c_rel"] = float(((kc - rc).abs()
                                  / rc.abs().clamp_min(1.0)).max())
            ok = (err["h"] <= REC_BF16_H_ATOL
                  and err["c_rel"] <= REC_BF16_C_RTOL)
        del kh, kc, rh, rc
        ms = time_call(torch, lambda: fwd(gx, wh, with_cell=True), REPS)
        plain_ms = time_call(torch, lambda: ref(gx, wh, with_cell=True), 1)
        log(f"8a lstm_recurrence {tag} layer {layer} (R={gx.shape[0]}, "
            f"T={gx.shape[1]}): kernel vs plain {json.dumps(err)}; "
            f"{ms:.3f} ms, plain {plain_ms:.3f} ms  [{card}]")
        if not ok:
            fail(f"8a: layer {layer}'s {tag} recurrence outside 2b's tier "
                 f"({REC_TOLERANCE})")
        out.append(dict(err, ms=ms, plain_ms=plain_ms))
    return out


def check_stacked_xe(torch, card: str, fusion: str, counted, workdir: str,
                     corpora=None):
    """8a (meanpool) / 8b (attention): ``msrvtt_resnet_c3d_xe`` at two
    layers, one epoch of 4 steps through ``Trainer.fit`` (validation
    decodes per step), launches held; one bf16 teacher-forced forward's
    profiler launches held (meanpool: one ``lstm_recurrence`` a layer;
    attention: one context launch a step); the wrappers' launches over
    the timed steps held (attention: the context backward's T a step);
    under meanpool each layer's recurrence kernel vs its plain version
    at bf16 and f32; the f32 XE step through the kernels vs their plain
    versions at phase 4's bounds."""
    import numpy as np

    from cst_captioning_torch.data.loader import to_device
    from cst_captioning_torch.ops import attention as ctx_mod
    from cst_captioning_torch.ops import lstm as lstm_mod

    part = "8a" if fusion == "meanpool" else "8b"
    cfg = train_cfg(fusion)
    cfg.model.num_layers = STACK_LAYERS
    cfg.train.max_epochs = 1
    trainer = build_trainer(torch, cfg, workdir, corpora)
    model = trainer.model
    if model.num_layers != STACK_LAYERS:
        fail(f"{part}: the trainer built {model.num_layers} layers")
    res = {}
    zero(counted)
    with decode_steps(model) as val:
        t0 = time.perf_counter()
        hist = trainer.fit()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    steps = trainer.train_iter.num_batches()
    e0 = hist.get("0", {})
    log(f"{part} train {fusion} num_layers={STACK_LAYERS}: {steps} steps in "
        f"{wall:.1f} s incl. validation ({val.n} decode steps); loss "
        f"{e0.get('train_loss', math.nan):.4f}, grad norm "
        f"{e0.get('grad_norm', math.nan):.4f}, "
        f"{e0.get('steps_per_sec', 0):.3f} steps/s; val "
        f"{json.dumps(e0.get('val', {}))}  [{card}]")
    if steps != 4 or sorted(hist) != ["0"] or not np.isfinite(
            [e0["train_loss"], e0["grad_norm"]]).all():
        fail(f"{part}: expected one finite epoch of 4 steps: {hist}")
    if "CIDEr" not in e0.get("val", {}):
        fail(f"{part}: validation entry without CIDEr")
    for d in ("best", "last"):
        if not os.path.exists(os.path.join(trainer.workdir, d, "params.pt")):
            fail(f"{part}: no {d} checkpoint")
    got = counts(counted)
    if fusion == "meanpool":
        fit_ok = got["lstm_recurrence"] == STACK_LAYERS * steps
    else:
        fit_ok = (got["fused_context_attention_bwd"] == T_XE * steps
                  and got["fused_context_attention"] == T_XE * steps + val.n)
    fused = {k: v for k, v in got.items() if v and k not in (
        "lstm_recurrence", "fused_context_attention",
        "fused_context_attention_bwd", "row_gemm")}
    log(f"{part} launches over fit: {got}")
    if not fit_ok or fused or not got["row_gemm"]:
        fail(f"{part}: launches over fit {got} (the single-layer kernels "
             f"none, the training kernels once a layer or step)")
    res["fit_launches"] = {k: v for k, v in got.items() if v}
    res["val_decode_steps"] = val.n
    res["steps_per_sec"] = e0["steps_per_sec"]

    b = to_device(next(iter(trainer.train_iter.epoch(0))),
                  torch.device(DEVICE))
    inputs, S = tf_inputs(b)

    def forward():
        with torch.enable_grad():
            model(b.feats, b.feat_masks, inputs, repeat=S)

    per_fwd = (STACK_LAYERS if fusion == "meanpool"
               else T_XE * CTX_LAUNCHES)
    rows = profiled(torch, forward, 1, launches=per_fwd)
    for kname, ms, count in sorted(rows, key=lambda r: -r[1])[:8]:
        log(f"breakdown {part} bf16 teacher-forced forward: {kname} {ms:.3f} "
            f"ms over {count:g} launches")
    if fusion == "meanpool":
        rec = round(sum(c for k, _, c in rows if "lstm_rec" in k))
        if rec != STACK_LAYERS:
            fail(f"8a: {rec} lstm_recurrence launches in one forward's "
                 f"profile, {STACK_LAYERS} wanted")
    res["forward_launches_profiled"] = per_fwd
    res["forward_device_ms"] = sum(ms for _, ms, _ in rows)

    gen = torch.Generator(device=DEVICE).manual_seed(7)
    calls = []

    def train_step():
        calls.append(1)
        trainer._train_step(b.feats, b.feat_masks, b.captions, b.weights,
                            b.category, b.video_idx, gen, 0.0)

    zero(counted)
    res["step_ms"] = time_call(torch, train_step, STACK_XE_TIMED)
    n = len(calls)
    want = ({"lstm_recurrence": STACK_LAYERS * n} if fusion == "meanpool"
            else {"fused_context_attention": T_XE * n,
                  "fused_context_attention_bwd": T_XE * n})
    res["step_launches"] = hold_launches(
        counted, want, f"{part} {n} bf16 XE steps")
    log(f"{part} bf16 XE step {fusion} num_layers={STACK_LAYERS}: "
        f"{res['step_ms']:.3f} ms (events, {STACK_XE_TIMED} steps after a "
        f"warm-up)  [{card}]")
    if fusion == "meanpool":
        res["layers_bf16"] = hold_layer_recurrences(
            torch, lstm_mod, layer_inputs(torch, model, b), "bf16", card)
        m32 = f32_model(torch, trainer)
        res["layers_f32"] = hold_layer_recurrences(
            torch, lstm_mod, layer_inputs(torch, m32, b), "f32", card)
        del m32
        swap = ("lstm_recurrence", plain_recurrence(torch, lstm_mod))
    else:
        swap = ("fused_context_attention",
                plain_context_attention(torch, ctx_mod))
    res["xe_f32"] = check_xe_step(torch, trainer, cfg, *swap)
    res["best"] = os.path.join(trainer.workdir, "best")
    res["corpora"] = (trainer.train_ds, trainer.val_ds)
    return res


def check_stacked_cst(torch, card: str, start: str, train_ds, counted,
                      workdir: str):
    """8c: ``msrvtt_cst_ms_scb`` at two layers from 8a's ``best``: one
    warm-up and STACK_CST_TIMED timed split steps (the rollout chunks on
    the per-step route), launches held (one ``threefry_sample`` a decode
    step, the encode's and each step's row_gemm, one recurrence launch a
    layer for the update); the f32 1,280-row rollout kernel vs the plain
    draw token-exact; the slot rollout bitwise the padded one at f32 and
    bf16 (with 5c.c's plain draw at f32); the f32 PG loss at phase 5's
    tier."""
    from cst_captioning_torch.decoding import core as core_mod
    from cst_captioning_torch.models import captioner
    from cst_captioning_torch.ops import lstm as lstm_mod
    from cst_captioning_torch.ops import threefry as tf

    res = {}
    trainer, _, batches = cst_trainer(torch, "meanpool", start, workdir,
                                      train_ds, layers=STACK_LAYERS)
    model, cfg, step = trainer.model, trainer.cfg, trainer._train_step
    S, L = cfg.train.cst_num_samples, cfg.data.max_seq_len
    temp = cfg.train.sample_temperature
    if model.num_layers != STACK_LAYERS or step.layout != "split":
        fail(f"8c: {model.num_layers} layers, layout {step.layout}")
    windows, last, restore = cst_probe(torch, model)
    try:
        run_cst_step(torch, step, batches[0], 1, windows)
        zero(counted)
        rows = []
        with decode_steps(model) as ds:
            for i in range(STACK_CST_TIMED):
                m, ph, wall, dev = run_cst_step(
                    torch, step, batches[(i + 1) % len(batches)], 60 + i,
                    windows)
                rows.append(log_cst_step(
                    f"8c scb num_layers={STACK_LAYERS} {i}", m, ph, wall, dev,
                    card))
        want = {"threefry_sample": ds.n,
                "lstm_recurrence": STACK_LAYERS * STACK_CST_TIMED,
                "row_gemm": STACK_CST_TIMED * STACK_ENCODE_RG
                + ds.n * step_rg("meanpool", STACK_LAYERS)}
        res["launches"] = hold_launches(
            counted, want, f"8c {STACK_CST_TIMED} CST steps ({ds.n} decode "
            "steps)")
        res["decode_steps"] = ds.n
    finally:
        restore()
    res["steps"] = rows
    res["wall_ms_mean"] = sum(r["wall_ms"] for r in rows) / len(rows)
    res["pg_loss_f32"] = check_pg_loss(
        torch, trainer, last, ("lstm_recurrence",
                               plain_recurrence(torch, lstm_mod),
                               lstm_mod.lstm_recurrence))

    batch = batches[0]
    m32 = f32_model(torch, trainer)
    with torch.no_grad():
        cache = captioner._repeat_cache(
            m32._encode(batch.feats, batch.feat_masks, None), S)

    def rollout():
        return m32.sample_cache(cache, CST_SEED_WORDS, max_len=L,
                                greedy=False, temperature=temp)

    before = tf.threefry_sample.launches
    with decode_steps(m32) as ds:
        k = rollout()
    if tf.threefry_sample.launches - before != ds.n:
        fail("8c: the rollout did not launch threefry_sample once a step")
    with swapped(core_mod, "threefry_sample", tf.categorical_ref):
        p = rollout()
    tok_diff = int((k.tokens != p.tokens).sum())
    mask_diff = int((k.mask != p.mask).sum())
    lp_err = float((k.logprobs - p.logprobs).abs().max())
    log(f"8c rollout f32 R={k.tokens.shape[0]} num_layers={STACK_LAYERS}, "
        f"threefry_sample kernel vs plain draw: {tok_diff} tokens and "
        f"{mask_diff} mask entries differ, max |logprob diff| {lp_err:.3e}; "
        f"{ds.n} decode steps, mean length {float(k.mask.sum(1).mean()):.2f}")
    if tok_diff or mask_diff or not lp_err <= F32_ATOL:
        fail("8c: the f32 stacked rollout through the kernel disagrees with "
             "the plain draw")
    res["rollout_f32"] = {"rows": int(k.tokens.shape[0]),
                          "tokens_differ": tok_diff, "max_abs_err": lp_err}
    del cache, k, p
    res["layouts"] = check_slot_layouts(
        torch, card, {("meanpool", "bf16"): (model, batch),
                      ("meanpool", "f32"): (m32, batch)},
        L, temp, S, counted, STACK_GEOMETRIES, tag="8c")
    return res


def check_stacked_eval(torch, card: str, start: str, counted, tmp: str):
    """8d: ``evaluate_dataset`` of ``msrvtt_eval_beam5`` at two layers
    from 8a's ``best`` on STACK_EVAL_VIDEOS generated videos: the
    per-step beam, f32 through ``row_gemm`` vs its plain version (the
    captioner's ``row_dot`` swapped for ``row_dot_ref``) identical files
    (or within 6a's hidden-unit-permuted witness), launches held (the
    encode's row_gemm a batch, ``step_rg`` a decode step, no fused
    decoder), then bf16 as a reading: videos/s end to end."""
    import numpy as np

    from cst_captioning_torch.data.vocab import Vocabulary
    from cst_captioning_torch.decoding.beam import beam_backend
    from cst_captioning_torch.models import captioner
    from cst_captioning_torch.ops import rowgemm as rg_mod

    res = {}
    c32 = eval_cfg(dtype="float32")
    c32.model.num_layers = STACK_LAYERS
    vocab = Vocabulary([f"w{i}" for i in range(V - 4)])
    corpus = make_msrvtt_corpus(np, vocab, c32, STACK_EVAL_VIDEOS, EVAL_SEED)
    nb = STACK_EVAL_VIDEOS // c32.data.batch_size
    m32 = eval_model(c32, start)
    backend = beam_backend(m32)
    log(f"8d eval backend: {backend}")
    if not backend.startswith(f"per-step beam (num_layers={STACK_LAYERS}"):
        fail(f"8d: the stacked eval's backend is {backend!r}")
    zero(counted)
    with decode_steps(m32) as ds:
        k32 = run_eval(torch, "8d f32 per-step beam (row_gemm kernel)", m32,
                       corpus, c32, os.path.join(tmp, "f32"), card)
    rg = step_rg("meanpool", STACK_LAYERS)
    res["launches_f32"] = hold_launches(
        counted, {"row_gemm": STACK_ENCODE_RG * nb + rg * ds.n},
        f"8d eval f32 ({nb} batches, {ds.n} decode steps)")
    plain = swapped(captioner, "row_dot", rg_mod.row_dot_ref)
    with plain:
        p32 = run_eval(torch, "8d f32 per-step beam (plain products)", m32,
                       corpus, c32, os.path.join(tmp, "f32_plain"), card)

    def witness():
        mp = permuted_model(torch, m32, seed=5)
        with plain:
            return run_eval(torch, "8d f32 plain, H-permuted", mp, corpus,
                            c32, os.path.join(tmp, "f32_witness"),
                            card)["preds"]

    res["f32"] = hold_f32_eval(torch, "8d stacked meanpool", k32, p32,
                               witness)
    res["f32_videos_per_s"] = k32["videos_per_s"]
    res["f32_device_ms"] = k32["device_ms"]
    res["f32_tokens"], res["corpus"], res["vocab"] = (k32["tokens"], corpus,
                                                      vocab)
    del m32
    cfg = eval_cfg()
    cfg.model.num_layers = STACK_LAYERS
    model = eval_model(cfg, start)
    zero(counted)
    with decode_steps(model) as ds:
        kb = run_eval(torch, "8d bf16 per-step beam", model, corpus, cfg,
                      os.path.join(tmp, "bf16"), card)
    res["launches_bf16"] = hold_launches(
        counted, {"row_gemm": STACK_ENCODE_RG * nb + rg * ds.n},
        f"8d eval bf16 ({nb} batches, {ds.n} decode steps)")
    res.update(videos_per_s=kb["videos_per_s"], wall_s=kb["wall_s"],
               device_ms=kb["device_ms"], metric_s=kb["score_s"],
               scores=kb["scores"])
    return res


def check_stacked_serving(torch, card: str, start: str, ev: dict, counted,
                          tmp: str):
    """8e: 8a's checkpoint served at two layers: the f32 ladder beam
    equal to 8d's f32 eval tokens for the same videos; the f32 slot loop
    token-exact against the offline per-step decode; bf16 and int8w
    (ladder and slot loop) at 3d's relaxed holds; ``state_bytes ==
    expected_state_bytes`` with the (layers, rows, H) carry; the slot
    loop's and the ladder's captions/s (bf16, host clock); then
    ``cli/serve.main`` with ``--model.num_layers 2`` under the preset's
    defaults (the slot loop) and with ``--serving.continuous false``
    (the ladder): the direct bf16 runs' captions.  Launches held in every
    direct run."""
    from cst_captioning_torch.serving.engine import InferenceEngine

    res = {"launches": {}}
    corpus, vocab = ev["corpus"], ev["vocab"]
    n = STACK_SERVE_VIDEOS
    payloads = video_payloads(corpus, range(n))
    want = ev["f32_tokens"][:n].cpu()
    rg = step_rg("meanpool", STACK_LAYERS)

    def engine(dtype, continuous, f32=False):
        eng = InferenceEngine(serve_cfg(dtype, continuous=continuous, f32=f32,
                                        layers=STACK_LAYERS),
                              checkpoint=start, vocab=vocab, device=DEVICE)
        if eng.model.num_layers != STACK_LAYERS:
            fail(f"8e: the engine built {eng.model.num_layers} layers")
        return eng

    def ladder(eng, what, q=0):
        zero(counted)
        with decode_steps(eng.model) as ds:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks = ladder_serve(eng, payloads)
            wall = time.perf_counter() - t0
        nl = -(-n // eng.max_batch)
        res["launches"][what] = hold_launches(
            counted, {"row_gemm": STACK_ENCODE_RG * nl + rg * ds.n,
                      "row_gemm_quant": q * rg * ds.n},
            f"8e {what} ({nl} batches, {ds.n} decode steps)")
        return toks, n / wall

    def slots(eng, what, q=0):
        zero(counted)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        served, admits, steps = slot_serve(eng, payloads)
        wall = time.perf_counter() - t0
        res["launches"][what] = hold_launches(
            counted, {"row_gemm": ADMIT_ROW_GEMM * admits + rg * steps,
                      "row_gemm_quant": q * rg * steps},
            f"8e {what} ({admits} admitting ticks, {steps} steps)")
        dec = eng.slot_decoder()
        if (dec.state_bytes() != dec.expected_state_bytes()
                or dec._st.core.state.h.shape[0] != STACK_LAYERS):
            fail(f"8e {what}: state bytes {dec.state_bytes()} vs "
                 f"{dec.expected_state_bytes()}, carry "
                 f"{tuple(dec._st.core.state.h.shape)}")
        return served, n / wall

    eng = engine("f32", False, f32=True)
    f32_ladder, _ = ladder(eng, "f32_ladder_beam")
    same = int((f32_ladder == want).all(-1).sum())
    log(f"8e f32 ladder beam: {same}/{n} captions equal to 8d's f32 eval")
    if same != n:
        fail("8e: the served f32 captions differ from evaluate_dataset's")
    del eng
    eng = engine("f32", True, f32=True)
    f32_slots, _ = slots(eng, "f32_continuous")
    off32 = offline_decodes(torch, eng, payloads)
    share, _, gap = caption_match(f32_slots, *off32["per_step"])
    log(f"8e f32 continuous: served vs offline per-step decode caption "
        f"match {share:.4f} (max |score diff| {gap})")
    if share != 1.0:
        fail("8e f32 continuous: served differs from the offline per-step "
             "decode")
    res["f32"] = {"ladder_equal_eval": same, "continuous_match_per_step":
                  share}
    del eng
    low = {}
    for dtype in ("bf16", "int8w"):
        q = int(dtype == "int8w")
        eng = engine(dtype, True)
        lad, lad_rate = ladder(eng, f"{dtype}_ladder_beam", q)
        served, rate = slots(eng, f"{dtype}_continuous", q)
        off = offline_decodes(torch, eng, payloads)
        row = relaxed_holds(f"8e {dtype} continuous", served,
                            off["per_step"], lad, off32["per_step"],
                            f32_ladder)
        row.update(slot_captions_per_s=rate, ladder_captions_per_s=lad_rate)
        log(f"8e {dtype}: slot loop {rate:.1f} captions/s, ladder "
            f"{lad_rate:.1f} captions/s ({n} requests, host clock)  [{card}]")
        low[dtype] = dict(row, served=served, ladder=lad)
        del eng
    res.update({k: {kk: vv for kk, vv in v.items()
                    if kk not in ("served", "ladder")}
                for k, v in low.items()})
    os.makedirs(tmp, exist_ok=True)
    vf = save_vocab(vocab, tmp)
    idx = list(range(STACK_CLI_REQUESTS))
    body = [{"features": {m: a.tolist() for m, a in p["features"].items()}}
            for p in video_payloads(corpus, idx)]
    base = ["--checkpoint", start, "--preset", SERVE_PRESET,
            "--data.vocab_file", vf, "--model.num_layers", str(STACK_LAYERS)]
    res["cli_serve_equal"] = {}
    for what, extra, direct in (
            ("slot loop", [], [low["bf16"]["served"][i]["tokens"]
                               for i in idx]),
            ("ladder", ["--serving.continuous", "false"],
             low["bf16"]["ladder"][:len(idx)].tolist())):
        out, ceng = cli_serve(torch, base + extra, body,
                              f"8e cli/serve.main {what}")
        if ceng.model.num_layers != STACK_LAYERS:
            fail(f"8e: cli/serve built {ceng.model.num_layers} layers")
        got = sum(out[i]["tokens"] == direct[i] for i in idx)
        log(f"8e cli/serve.main {what}: {got}/{len(idx)} captions equal to "
            f"the direct bf16 run's; first {out[0]['caption'][:80]!r}")
        if got != len(idx):
            fail(f"8e: cli/serve's {what} captions differ from the "
                 f"engine's")
        res["cli_serve_equal"][what] = got
        del ceng
    return res


def check_stacked(torch, card: str, tmp: str):
    """Phase 8, ``model.num_layers = 2`` (see the module docstring):
    8a-8e.  Returns the readings."""
    t0 = time.perf_counter()
    counted = stacked_counted()
    res = {}
    res["xe"] = check_stacked_xe(torch, card, "meanpool", counted,
                                 os.path.join(tmp, "xe"))
    corpora = res["xe"].pop("corpora")
    res["att_xe"] = check_stacked_xe(torch, card, "attention", counted,
                                     os.path.join(tmp, "att_xe"), corpora)
    res["att_xe"].pop("corpora")
    start = res["xe"]["best"]
    res["cst"] = check_stacked_cst(torch, card, start, corpora[0], counted,
                                   os.path.join(tmp, "cst"))
    del corpora
    res["eval"] = check_stacked_eval(torch, card, start, counted,
                                     os.path.join(tmp, "eval"))
    res["serve"] = check_stacked_serving(torch, card, start, res["eval"],
                                         counted, os.path.join(tmp, "serve"))
    for k in ("corpus", "vocab", "f32_tokens"):
        del res["eval"][k]
    res["wall_s"] = time.perf_counter() - t0
    log(f"phase 8 (num_layers = {STACK_LAYERS}) took {res['wall_s']:.1f} s  "
        f"[{card}]")
    return res


def add_phase8_readings(kernels, p8):
    """Phase 8's launches per run on the entries of the four kernels it
    ran, and its readings on ``lstm_recurrence``'s."""
    runs = {"8a_fit": p8["xe"]["fit_launches"],
            "8a_steps": p8["xe"]["step_launches"],
            "8b_fit": p8["att_xe"]["fit_launches"],
            "8b_steps": p8["att_xe"]["step_launches"],
            "8c_cst_steps": p8["cst"]["launches"],
            "8d_eval_f32": p8["eval"]["launches_f32"],
            "8d_eval_bf16": p8["eval"]["launches_bf16"]}
    runs.update({f"8e_{k}": v for k, v in p8["serve"]["launches"].items()})
    for k in kernels:
        got = {}
        for run, cnt in runs.items():
            for key in (k["name"], k["name"] + "_quant"):
                if cnt.get(key):
                    got[run if key == k["name"] else run + "_int8w"] = cnt[key]
        if got:
            k["phase8_launches"] = got
    by_name = {k["name"]: k for k in kernels}
    by_name["lstm_recurrence"]["phase8"] = {
        "num_layers": STACK_LAYERS,
        "8a": {key: p8["xe"][key] for key in (
            "layers_bf16", "layers_f32", "xe_f32", "step_ms",
            "steps_per_sec", "forward_device_ms")},
        "8b": {key: p8["att_xe"][key] for key in (
            "xe_f32", "step_ms", "steps_per_sec", "forward_device_ms")},
        "8c": {key: p8["cst"][key] for key in (
            "wall_ms_mean", "steps", "decode_steps", "pg_loss_f32",
            "rollout_f32", "layouts")},
        "8d": p8["eval"], "8e": p8["serve"], "wall_s": p8["wall_s"]}


# ----------------------------------------------------------------- phase 9

SPEC_POOL = 8            # 9a: videos in the request pool
SPEC_REQS = 64           # 9a: requests drawn from it (request i: video i % 8)
SPEC_K = 4               # serving.speculative defaults (draft_k, draft_hidden)
SPEC_HIDDEN = 128
SPEC_DISTILL_STEPS = 150  # 9a: Adam steps of a distillation, lr below
SPEC_DISTILL_LR = 3e-3
SPEC_DTYPES = ("f32", "bf16", "int8w")
SPEC_PROFILED = 3        # rounds in a profiled window
SOAK_REQUESTS = 200      # 9b: the recorded diurnal trace
SOAK_KEYS = 1024         # 9b: the key pool its trace draws from (178 keys
                         # drawn, so most requests decode)
AUTOSCALE_KEYS = 16      # 9c: the request pool its trace cycles through
SOAK_SEED = 7
SOAK_SLO_TICKS = (10, 30, 60)
SOAK_SCHEDULE = [
    {"site": "replica_kill", "at": 40, "replica": 0},
    {"site": "tick_stall", "every": 15, "replica": 1, "value": 0.02},
    {"site": "queue_burst", "every": 10, "value": 16},
    {"site": "cache_miss", "p": 0.3},
    {"site": "deadline_skew", "every": 25, "value": 0.0},
]
AUTOSCALE = {"min_replicas": 1, "max_replicas": 2, "window_ticks": 4,
             "scale_up_queue_depth": 8.0, "cooldown_ticks": 8,
             "scale_down_occupancy": 0.25}
AUTOSCALE_BURST = (512, 4)   # 9c: requests, over this many ticks
AUTOSCALE_QUIET = (6, 40, 25)  # then requests, from tick, every ticks


def spec_launches(fusion: str, k: int) -> dict:
    """Wrapper launches of one speculative round: the draft's cell and
    head products each of its k steps, each verify step's gates (and
    query, under attention) and the one vocab product over k*S rows; k
    context launches under attention.  ``k`` = 0 is a plain step."""
    if not k:
        return {"row_gemm": STEP_RG[fusion],
                "fused_context_attention": int(fusion == "attention")}
    return {"row_gemm": 2 * k + (STEP_RG[fusion] - 1) * k + 1,
            "fused_context_attention": k * int(fusion == "attention")}


def spec_engine(torch, fusion: str, dtype: str, params, vocab, spec=None,
                *extra):
    """A ``msrvtt_serve_beam5`` greedy slot-loop engine at full width
    (tier 1 off), f32 / bf16 / int8w, speculative with ``spec``."""
    from cst_captioning_torch.serving.engine import InferenceEngine

    cfg = continuous_cfg("greedy", fusion, dtype == "f32",
                         "f32" if dtype == "f32" else dtype,
                         "--serving.caption_cache_size", "0", *extra)
    cfg.serving.warmup = False
    cfg.serving.speculative = dict(spec or {})
    return InferenceEngine(cfg, params=params, vocab=vocab, device=DEVICE)


def spec_drive(torch, eng, reqs, counted, k: int, fusion: str, what: str):
    """``reqs`` through ``eng``'s slot loop, every tick admitting all it
    can, with the counts zeroed first and held after at the admissions'
    and rounds' launches.  Returns tokens, host ms of the ticks with and
    without an admission, captions/s and the run's launches and rounds."""
    dec = eng.slot_decoder()
    torch.cuda.synchronize()
    zero(counted)
    steps0, admits0 = dec.steps_run, dec.admit_ticks
    got, pending, walls = {}, list(range(len(reqs))), ([], [])
    t0 = time.perf_counter()
    while pending or dec.occupied:
        dec.maybe_resize(len(pending))
        n = min(len(pending), len(dec.free), dec.admit_cap)
        adm = [pending.pop(0) for _ in range(n)]
        tt = time.perf_counter()
        done = dec.tick([reqs[i] for i in adm], adm)
        walls[bool(adm)].append((time.perf_counter() - tt) * 1e3)
        for i, toks, score, _ in dec.harvest_many(done):
            got[i] = ([int(t) for t in toks], score)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rounds, admits = dec.steps_run - steps0, dec.admit_ticks - admits0
    per = spec_launches(fusion, k)
    want = {"row_gemm": ADMIT_RG[fusion] * admits + per["row_gemm"] * rounds}
    if fusion == "attention":
        want["fused_context_attention"] = (
            per["fused_context_attention"] * rounds)
    if eng.serving_dtype == "int8w":
        # The model's int8 products: the attention encode's att_wf, each
        # step's gates (and query) and the vocab; the draft is float32.
        model_rg = (STEP_RG[fusion] - 1) * k + 1 if k else STEP_RG[fusion]
        want["row_gemm_quant"] = (int(fusion == "attention") * admits
                                  + model_rg * rounds)
    launches = hold_launches(counted, want, what)
    return {"tokens": got, "rounds": rounds, "admits": admits,
            "captions_per_s": len(reqs) / wall, "wall_s": wall,
            "host_ms_round": sum(walls[0]) / max(len(walls[0]), 1),
            "host_ms_admitting_tick": sum(walls[1]) / max(len(walls[1]), 1),
            "launches": launches,
            "launches_per_round": {n: v for n, v in per.items()
                                   if fusion == "attention"
                                   or n == "row_gemm"}}


def round_profile(torch, eng, reqs, fusion: str, k: int, what: str):
    """Device ms of one round (or plain step) over a full bank: the bank
    admits ``reqs``, then a ``profiled`` window of SPEC_PROFILED pure
    rounds must record exactly their launches of the port's kernels."""
    dec = eng.slot_decoder()
    reqs = reqs[:min(dec.S_max, dec.admit_cap)]
    dec.maybe_resize(len(reqs))
    dec.harvest_many(dec.tick(reqs, list(range(len(reqs)))))
    per = spec_launches(fusion, k)
    n = sum(per.values())
    rows = profiled(torch, lambda: dec.tick(), SPEC_PROFILED, n)
    for s in list(dec.occupied):
        dec.evict(s)
    port = sum(m for key, m, _ in rows if key.startswith("cstk::"))
    total = sum(m for _, m, _ in rows)
    top = sorted(rows, key=lambda r: -r[1])[:6]
    log(f"{what}: device ms a round {total:.4f} (the port's kernels "
        f"{port:.4f}, {n} launches); largest: "
        + ", ".join(f"{key} {ms:.4f} x{c:g}" for key, ms, c in top))
    return {"device_ms_round": total, "port_kernels_ms_round": port,
            "largest": [(key, ms, c) for key, ms, c in top]}


def verify_bitwise(torch, eng, reqs, k: int, what: str):
    """One ``decode_verify`` pass over the S rows of ``reqs`` (two plain
    steps in, so the prefix is not BOS) against k chained plain steps on
    the same inputs: logits, their log-softmax (the pick's input) and the
    state snapshots bitwise."""
    from cst_captioning_torch.decoding.core import greedy_pick

    m = eng.model
    with torch.no_grad():
        cache = eng.encode_prepared_rows(reqs)
        state = m.init_state(len(reqs))
        tok = torch.full((len(reqs),), 1, dtype=torch.int64,
                         device=state.h.device)
        for _ in range(2):
            state, lg = m.decode_logits(state, cache, tok)
            tok = greedy_pick(lg)[0]
        vin, plain, snaps, s, t = [tok], [], [], state, tok
        for j in range(k):
            s, lg = m.decode_logits(s, cache, t)
            plain.append(lg)
            snaps.append(s)
            t = greedy_pick(lg)[0]
            if j < k - 1:
                vin.append(t)
        h_all, c_all, vl = m.decode_verify(state, cache, torch.stack(vin))
    G = len(reqs)
    lp_v = torch.log_softmax(vl, dim=-1)
    for j in range(k):
        rows = slice(j * G, (j + 1) * G)
        if not (torch.equal(vl[rows], plain[j])
                and torch.equal(lp_v[rows],
                                torch.log_softmax(plain[j], dim=-1))
                and torch.equal(h_all[j], snaps[j].h)
                and torch.equal(c_all[j], snaps[j].c)):
            fail(f"{what}: verify row block {j} ({k * G} rows) is not "
                 f"bitwise the plain step at {G} rows")
    log(f"{what}: one verify pass over {k * G} rows bitwise {k} plain "
        f"steps at {G} rows (logits, log-softmax, h / c)")
    return True


def draft_vs_plain(torch, eng, what: str):
    """The draft's two float32 products on the card against their plain
    version, at a full bank's rows: SPEC_K chained ``draft_logits`` steps
    from a random carry and random tokens, each step's carry and logits
    (the unmasked columns) within RG_RTOL x max |value| of the same step
    with ``row_dot`` swapped for ``row_dot_ref`` on the same inputs, the
    ``row_gemm`` kernel launched twice a step (the cell, K = 2*Hd, N =
    4*Hd; the head, K = Hd, N = V), and each product's rows bitwise
    invariant to the row count (``RG_ROWS`` up to the bank)."""
    from unittest import mock

    from cst_captioning_torch.constants import BOS_ID, PAD_ID, UNK_ID
    from cst_captioning_torch.decoding import speculative as spec_mod
    from cst_captioning_torch.ops.rowgemm import row_dot_ref

    row_dot = spec_mod.row_dot
    dp, S = eng.draft_params, eng.slot_decoder().S_max
    Hd = int(dp["draft_cell_b"].shape[0]) // 4
    Vd = int(dp["draft_head_b"].shape[0])
    keep = torch.ones(Vd, dtype=torch.bool, device=DEVICE)
    keep[[PAD_ID, BOS_ID, UNK_ID]] = False
    suppress = bool(eng.model.decode_suppress_unk)
    g = torch.Generator(device=DEVICE).manual_seed(53)
    carry = torch.randn(2, S, Hd, generator=g, device=DEVICE) * 0.5
    tok = torch.randint(4, Vd, (S,), generator=g, device=DEVICE)
    f32 = torch.float32
    rel = {"carry": 0.0, "logits": 0.0}
    moved, agree = 0, 0
    n0 = row_dot.launches
    with torch.no_grad():
        for _ in range(SPEC_K):
            c_k, lg_k = spec_mod.draft_logits(dp, carry, tok, suppress)
            launched = row_dot.launches - n0
            with mock.patch.object(spec_mod, "row_dot", row_dot_ref):
                c_p, lg_p = spec_mod.draft_logits(dp, carry, tok, suppress)
            torch.cuda.synchronize()
            for key, a, b in (("carry", c_k, c_p),
                              ("logits", lg_k[:, keep], lg_p[:, keep])):
                rel[key] = max(rel[key],
                               max_diff(a, b) / float(b.abs().max()))
            x_cell = torch.cat([dp["draft_embed"][tok], carry[0]], dim=-1)
            for x, w in ((x_cell, dp["draft_cell_w"]),
                         (c_k[0], dp["draft_head_w"])):
                full = row_dot(x, w, f32)
                moved += sum(int((row_dot(x[:m], w, f32) != full[:m])
                                 .any(-1).sum()) for m in RG_ROWS if m < S)
            agree += int((lg_k.argmax(-1) == lg_p.argmax(-1)).sum())
            carry, tok = c_k, lg_k.argmax(-1)
            n0 = row_dot.launches
            if launched != 2:
                fail(f"{what}: a draft step launched row_gemm {launched} "
                     "times, not 2")
    log(f"{what}: the draft's products on the card vs row_dot_ref, "
        f"{SPEC_K} steps at {S} rows (cell K={2 * Hd} N={4 * Hd}, head "
        f"K={Hd} N={Vd}): carry {rel['carry']:.2e}, logits "
        f"{rel['logits']:.2e} of max (held <= {RG_RTOL:g}); rows moved by "
        f"the row count {moved}; proposals equal {agree} of {SPEC_K * S}")
    if moved or not max(rel.values()) <= RG_RTOL:
        fail(f"{what}: the draft's row_gemm products are not row-invariant "
             "or off their plain version")
    return {"carry_rel": rel["carry"], "logits_rel": rel["logits"],
            "proposals_equal": agree, "proposals": SPEC_K * S}


def distill(torch, eng, teacher, what: str):
    """The draft distilled by ``cli/distill_draft.py``'s update (Adam,
    SPEC_DISTILL_STEPS steps) against ``teacher`` (B, T+1), from the
    truncation draft of ``eng``'s weights."""
    from cst_captioning_torch.cli.distill_draft import _make_update, adam
    from cst_captioning_torch.decoding.speculative import (
        draft_to_device,
        make_draft_params,
    )

    dp = draft_to_device(make_draft_params(eng.model.state_dict(),
                                           SPEC_HIDDEN), eng.device)
    for v in dp.values():
        v.requires_grad_(True)
    update = _make_update(adam(dp, SPEC_DISTILL_LR),
                          bool(eng.model.decode_suppress_unk))
    t0 = time.perf_counter()
    first = None
    for _ in range(SPEC_DISTILL_STEPS):
        loss, agree = update(teacher)
        first = float(agree) if first is None else first
    torch.cuda.synchronize()
    out = {"steps": SPEC_DISTILL_STEPS, "final_loss": float(loss),
           "teacher_match_first": first,
           "teacher_match_final": float(agree),
           "wall_s": time.perf_counter() - t0}
    log(f"{what}: distilled {SPEC_DISTILL_STEPS} steps in "
        f"{out['wall_s']:.1f} s: loss {out['final_loss']:.4f}, teacher "
        f"match {first:.3f} -> {out['teacher_match_final']:.3f}")
    return dp, out


def check_speculative(torch, card: str, params, vocab, counted, tmp: str):
    """9a: per fusion and dtype, a plain greedy arm and speculative arms
    (the truncation draft, then the draft distilled on the pool's own f32
    teacher streams, one a fusion) through the same admit / tick /
    harvest loop."""
    import numpy as np

    from cst_captioning_torch.constants import BOS_ID
    from cst_captioning_torch.decoding.speculative import save_draft_params

    base = spec_engine(torch, "meanpool", "f32", params["meanpool"], vocab)
    pool = make_bodies(np, base.cfg, SPEC_POOL, seed=43)[0]
    del base
    res = {}
    for fusion in ("meanpool", "attention"):
        for dtype in SPEC_DTYPES:
            what = f"9a {fusion} {dtype}"
            plain_eng = spec_engine(torch, fusion, dtype, params[fusion],
                                    vocab)
            reqs = [plain_eng.prepare(pool[i % SPEC_POOL])
                    for i in range(SPEC_REQS)]
            spec_drive(torch, plain_eng, reqs[:SPEC_POOL], counted, 0,
                       fusion, what + " plain warm-up")
            plain = spec_drive(torch, plain_eng, reqs, counted, 0, fusion,
                               what + " plain")
            plain.update(round_profile(torch, plain_eng, reqs, fusion, 0,
                                       what + " plain"))
            path = os.path.join(tmp, f"draft_{fusion}.npz")
            row = {"plain": plain}
            if dtype == "f32":
                # One draft a fusion, distilled on the f32 teacher streams
                # of the pool; the bf16 and int8w arms serve it too.
                teacher = torch.tensor(
                    [[BOS_ID] + plain["tokens"][i][0]
                     for i in range(SPEC_POOL)],
                    dtype=torch.int64, device=plain_eng.device)
                dp, row["distill"] = distill(torch, plain_eng, teacher, what)
                save_draft_params(path, dp)
                del dp
            del plain_eng
            for draft in ("truncation", "distilled"):
                spec = {"draft_k": SPEC_K, "draft_hidden": SPEC_HIDDEN}
                if draft == "distilled":
                    spec["draft_params"] = path
                eng = spec_engine(torch, fusion, dtype, params[fusion],
                                  vocab, spec)
                dec = eng.slot_decoder()
                r_draft = draft_vs_plain(torch, eng, f"{what} {draft}")
                wreqs = [eng.prepare(p) for p in pool]
                spec_drive(torch, eng, wreqs, counted, SPEC_K, fusion,
                           f"{what} {draft} warm-up")
                before = dec.spec_stats()
                r = spec_drive(torch, eng, [eng.prepare(pool[i % SPEC_POOL])
                                            for i in range(SPEC_REQS)],
                               counted, SPEC_K, fusion, f"{what} {draft}")
                after = dec.spec_stats()
                r["draft_vs_plain"] = r_draft
                emitted = after["emitted_tokens"] - before["emitted_tokens"]
                live = after["live_slot_rounds"] - before["live_slot_rounds"]
                r["spec_stats"] = {
                    "emitted_tokens": emitted, "live_slot_rounds": live,
                    "tokens_per_round": emitted / live,
                    "acceptance_rate": (emitted - live)
                    / (live * (SPEC_K - 1))}
                bad = [i for i in range(SPEC_REQS)
                       if r["tokens"][i][0] != plain["tokens"][i][0]]
                score_bad = [i for i in range(SPEC_REQS)
                             if r["tokens"][i][1] != plain["tokens"][i][1]]
                if bad or score_bad:
                    fail(f"{what} {draft}: {len(bad)} token and "
                         f"{len(score_bad)} score mismatches of {SPEC_REQS} "
                         f"against the plain arm (first {bad[:5]})")
                emitted_tokens = sum(sum(t != 0 for t in r["tokens"][i][0])
                                     for i in range(SPEC_REQS))
                if emitted != emitted_tokens:
                    fail(f"{what} {draft}: spec_stats counts {emitted} "
                         f"emitted tokens, the captions hold "
                         f"{emitted_tokens}")
                if draft == "distilled":
                    if r["spec_stats"]["tokens_per_round"] <= 1.0:
                        fail(f"{what}: {r['spec_stats']['tokens_per_round']}"
                             " tokens per live round with the distilled "
                             "draft, not above 1.0")
                    r["verify_bitwise"] = verify_bitwise(
                        torch, eng, [eng.prepare(p) for p in
                                     (pool * (SPEC_REQS // SPEC_POOL))],
                        SPEC_K, what)
                r.update(round_profile(torch, eng, [eng.prepare(p) for p in (
                    pool * (SPEC_REQS // SPEC_POOL))], fusion, SPEC_K,
                    f"{what} {draft}"))
                log(f"{what} {draft}: 0 token / score mismatches vs plain; "
                    f"{r['spec_stats']}; captions/s {r['captions_per_s']:.1f}"
                    f" (plain {plain['captions_per_s']:.1f}); host ms a round "
                    f"{r['host_ms_round']:.3f} (plain step "
                    f"{plain['host_ms_round']:.3f}); device ms a round "
                    f"{r['device_ms_round']:.4f} (plain step "
                    f"{plain['device_ms_round']:.4f}); rounds "
                    f"{r['rounds']} (plain steps {plain['rounds']}); "
                    f"launches a round {r['launches_per_round']}  [{card}]")
                del r["tokens"], eng, dec
                row[draft] = r
            del plain["tokens"]
            res[f"{fusion}_{dtype}"] = row
    return res


def soak_served(torch, eng, payloads, trace, schedule, counted, n: int,
                autoscaler=None, rs=None):
    """``chaos.run_soak`` over a fresh ``n``-replica ``ReplicaSet`` of
    ``eng`` (or ``rs``) with an empty tier 1, recording every served
    caption (decoded or a tier-1 hit) by recorded request id.  Returns
    (report, {rid: tokens}, the replica set, launches)."""
    from cst_captioning_torch.serving import chaos
    from cst_captioning_torch.serving.cache import TwoTierCache
    from cst_captioning_torch.serving.metrics import ServingMetrics
    from cst_captioning_torch.serving.replicas import ReplicaSet

    sv = eng.cfg.serving
    if rs is None:
        eng.cache = TwoTierCache(sv.caption_cache_size,
                                 sv.feature_cache_size,
                                 sv.feature_cache_bytes)
        rs = ReplicaSet.from_engine(eng, ServingMetrics(), n_replicas=n)
    tokens, seen = {}, {}
    resolve, submit = rs._resolve_one, rs.submit_async
    arrivals = iter(sorted(trace, key=lambda r: (r.t_tick, r.rid)))

    def recording(p, e, toks, *a, **kw):
        tokens[id(p)] = [int(t) for t in toks]
        return resolve(p, e, toks, *a, **kw)

    def submitting(payload, **kw):
        rid = next(arrivals).rid
        out = submit(payload, **kw)
        seen[rid] = out
        return out

    rs._resolve_one, rs.submit_async = recording, submitting
    ce = (chaos.ChaosEngine(seed=SOAK_SEED, schedule=schedule)
          if schedule is not None else None)
    torch.cuda.synchronize()
    zero(counted)
    t0 = time.perf_counter()
    report = chaos.run_soak(rs, payloads, trace, chaos=ce,
                            autoscaler=autoscaler)
    torch.cuda.synchronize()
    report.wall_s = time.perf_counter() - t0
    served = {}
    for rid, out in seen.items():
        if isinstance(out, dict):
            served[rid] = list(out["tokens"])
        elif id(out) in tokens and report.outcomes[rid]["outcome"] == "served":
            served[rid] = tokens[id(out)]
    decs = [r.decoder for r in rs.replicas]
    want = {"row_gemm": sum(ADMIT_RG["meanpool"] * d.admit_ticks
                            + STEP_RG["meanpool"] * d.steps_run
                            for d in decs)}
    return report, served, rs, hold_launches(counted, want,
                                             "9b / 9c soak")


def soak_summary(report) -> dict:
    out = {k: report.count(k) for k in ("served", "served_cached", "shed",
                                        "expired", "rejected")}
    out.update(lost=report.lost, ticks=report.ticks, kills=report.kills,
               stall_ticks=report.stall_ticks,
               failed=sum(1 for o in report.outcomes.values()
                          if o["outcome"].startswith("failed")),
               wall_s=report.wall_s,
               attainment={t: report.attainment(t) for t in SOAK_SLO_TICKS})
    return out


def same_served(got, want, what: str):
    """Every caption ``got`` served equals ``want``'s for the request."""
    bad = [rid for rid in got if got[rid] != want.get(rid)]
    if bad or not got:
        fail(f"{what}: {len(bad)} of {len(got)} served captions differ from "
             f"the chaos-free run's (first {bad[:5]})")


def check_chaos_soak(torch, card: str, params, vocab, counted, tmp: str):
    """9b: ``run_soak`` over two replicas on the card, f32 meanpool
    greedy, a diurnal trace, the five-site schedule; twice with the same
    seed, once chaos-free."""
    import numpy as np

    from cst_captioning_torch.observability.flight import (
        validate_flight_dump,
    )
    from cst_captioning_torch.serving import chaos

    flight = os.path.join(tmp, "flight")
    eng = spec_engine(torch, "meanpool", "f32", params["meanpool"], vocab,
                      None, "--serving.flight_dir", flight,
                      "--serving.caption_cache_size", "65536")
    trace = chaos.make_diurnal_trace(SOAK_SEED, SOAK_REQUESTS, SOAK_KEYS,
                                     base_per_tick=1.0, burst_factor=4.0,
                                     period_ticks=32)
    # Only the keys the trace draws are made, each from its own seed.
    keys = sorted({r.key for r in trace})
    payloads = {key: {"features": {
        m: a.astype(np.float32) for m, a in draw_features(
            np, np.random.RandomState([47, key]), eng.cfg).items()}}
        for key in keys}
    base, base_served, _, base_l = soak_served(
        torch, eng, payloads, trace, None, counted, 2)
    runs = [soak_served(torch, eng, payloads, trace, SOAK_SCHEDULE,
                        counted, 2) for _ in range(2)]
    (a, a_served, rs, a_l), (b, b_served, _, _) = runs
    for what, r in (("chaos-free", base), ("chaos", a), ("chaos again", b)):
        if not r.completed or r.lost:
            fail(f"9b {what}: completed {r.completed}, {r.lost} lost")
    if (a.decisions, a.chaos_log) != (b.decisions, b.chaos_log):
        fail("9b: two soaks with the same seed gave different decision or "
             "fault logs")
    if a_served != b_served:
        fail("9b: two soaks with the same seed served different captions")
    fired = {site for site, *_ in a.chaos_log}
    if fired != {s for s, _, _ in chaos.FAULT_SITES} or a.kills != 1:
        fail(f"9b: fired {sorted(fired)}, {a.kills} kills")
    if rs.metrics.requeues_total.value < 1:
        fail("9b: the replica kill requeued nothing")
    if 2 * base.count("served") <= SOAK_REQUESTS:
        fail(f"9b: the chaos-free run decoded {base.count('served')} of "
             f"{SOAK_REQUESTS} requests, not most of them")
    same_served(a_served, base_served, "9b")
    dumps = sorted(glob.glob(os.path.join(flight, "flight-*.json")))
    if not dumps:
        fail("9b: the replica kill left no flight dump")
    for path in dumps:
        with open(path) as f:
            validate_flight_dump(json.load(f))
    res = {"chaos_free": soak_summary(base), "chaos": soak_summary(a),
           "faults": len(a.chaos_log), "fired": sorted(fired),
           "requeues": rs.metrics.requeues_total.value,
           "flight_dumps": len(dumps), "launches_chaos_free": base_l,
           "launches_chaos": a_l, "served_compared": len(a_served),
           "distinct_keys": len(keys)}
    log(f"9b chaos soak ({SOAK_REQUESTS} requests over {len(keys)} distinct "
        f"videos, 2 replicas, f32 meanpool greedy; served: decoded, "
        f"served_cached: from tier 1): chaos-free {res['chaos_free']}; "
        f"chaos {res['chaos']}; "
        f"{res['faults']} faults at {res['fired']}, {res['requeues']} "
        f"requeues, {len(dumps)} valid flight dumps; decision and fault logs "
        f"identical over two runs; {len(a_served)} served captions equal to "
        f"the chaos-free run's  [{card}]")
    return res


def burst_then_quiet():
    from cst_captioning_torch.serving.chaos import RecordedRequest

    n, ticks = AUTOSCALE_BURST
    out = [RecordedRequest(rid=i, t_tick=i * ticks // n,
                           key=i % AUTOSCALE_KEYS) for i in range(n)]
    m, start, every = AUTOSCALE_QUIET
    out += [RecordedRequest(rid=n + j, t_tick=start + every * j,
                            key=j % AUTOSCALE_KEYS) for j in range(m)]
    return out


def check_autoscaler(torch, card: str, params, vocab, counted, tmp: str):
    """9c: the ``CaptionServer``'s autoscaler (its scale-up factory:
    ``clone_for_device`` onto the card) stepped by ``run_soak`` on a
    burst-then-quiet trace, against the static one-replica fleet."""
    import numpy as np

    from cst_captioning_torch.serving.server import CaptionServer

    eng = spec_engine(torch, "meanpool", "f32", params["meanpool"], vocab,
                      None, "--serving.autoscale", json.dumps(AUTOSCALE),
                      "--serving.flight_dir", os.path.join(tmp, "flight9c"))
    payloads = make_bodies(np, eng.cfg, AUTOSCALE_KEYS, seed=47)[0]
    trace = burst_then_quiet()
    static, static_served, _, _ = soak_served(torch, eng, payloads, trace,
                                              None, counted, 1)
    srv = CaptionServer(eng, port=0)
    try:
        if srv.autoscaler is None or len(srv.batcher.replicas) != 1:
            fail("9c: the server built no autoscaler over one replica")
        rep, served, rs, launches = soak_served(
            torch, eng, payloads, trace, None, counted, 1,
            autoscaler=srv.autoscaler, rs=srv.batcher)
        log_ = srv.autoscaler.decision_log()
    finally:
        srv.shutdown(drain=False)
    actions = [e[1] for e in log_]
    if "up" not in actions or "down" not in actions:
        fail(f"9c: decision log {log_} holds no scale-up and scale-down")
    if not rep.completed or rep.lost or static.lost:
        fail(f"9c: {rep.lost} lost (static fleet {static.lost})")
    new = rs.replicas[1]
    on_card = torch.device(eng.device).type == "cuda"
    if (new.engine.model is not eng.model
            or (new.engine.stream is None) == on_card):
        fail(f"9c: the scale-up replica (on {new.engine.device}) is not a "
             f"clone sharing the weights with its own stream")
    if not any(o.get("replica") == 1 for o in rep.outcomes.values()):
        fail("9c: the added replica served nothing")
    same_served(served, static_served, "9c vs the static fleet")
    res = {"decision_log": log_, "autoscaled": soak_summary(rep),
           "static": soak_summary(static), "replicas": len(rs.replicas),
           "healthy_at_end": rs.healthy_replicas, "launches": launches,
           "requeues": rs.metrics.requeues_total.value}
    log(f"9c autoscaler {AUTOSCALE}: decision log {log_}; {res['replicas']} "
        f"replicas made, {res['healthy_at_end']} healthy at the end; "
        f"autoscaled {res['autoscaled']}; static {res['static']}; every "
        f"caption the static fleet's  [{card}]")
    return res


def phase9_counted():
    from cst_captioning_torch.ops import attention, rowgemm

    return {"row_gemm": rowgemm.row_dot,
            "fused_context_attention": attention.fused_context_attention}


def check_serving_extensions(torch, card: str, tmp: str):
    """Phase 9 (see the module docstring): 9a speculative serving, 9b the
    chaos soak, 9c the autoscaler.  Returns the readings."""
    from cst_captioning_torch.config import get_preset
    from cst_captioning_torch.data.vocab import Vocabulary
    from cst_captioning_torch.models.captioner import model_from_config

    t0 = time.perf_counter()
    os.makedirs(tmp, exist_ok=True)
    counted = phase9_counted()
    vocab = Vocabulary([f"w{i}" for i in range(V - 4)])
    params = {}
    for fusion in ("meanpool", "attention"):
        base = get_preset("msrvtt_serve_beam5")
        base.model.vocab_size = len(vocab)
        base.model.feature_fusion = fusion
        model = model_from_config(base, device="cpu")
        model.init_weights(torch.Generator().manual_seed(base.train.seed))
        params[fusion] = spread_params(model.state_dict())
        del model
    res = {"9a": check_speculative(torch, card, params, vocab, counted, tmp)}
    t9b = time.perf_counter()
    res["9b"] = check_chaos_soak(torch, card, params, vocab, counted, tmp)
    res["9c"] = check_autoscaler(torch, card, params, vocab, counted, tmp)
    res["wall_s"] = time.perf_counter() - t0
    log(f"phase 9 (speculative decode, chaos soak, autoscaler) took "
        f"{res['wall_s']:.1f} s (9a {t9b - t0:.1f} s)  [{card}]")
    return res


def add_phase9_readings(kernels, p9):
    """Phase 9's launches on the ``row_gemm`` and
    ``fused_context_attention`` entries, its readings on ``row_gemm``'s."""
    runs = {}
    for case, row in p9["9a"].items():
        for arm in ("plain", "truncation", "distilled"):
            runs[f"9a_{case}_{arm}"] = row[arm]["launches"]
    runs["9b_chaos_free"] = p9["9b"]["launches_chaos_free"]
    runs["9b_chaos"] = p9["9b"]["launches_chaos"]
    runs["9c_autoscaled"] = p9["9c"]["launches"]
    for k in kernels:
        got = {run: cnt[k["name"]] for run, cnt in runs.items()
               if cnt.get(k["name"])}
        if got:
            k["phase9_launches"] = got
    rg = next(k for k in kernels if k["name"] == "row_gemm")
    rg["phase9"] = {
        "9a": {case: {arm: {key: v for key, v in row[arm].items()
                            if key != "launches"}
                      for arm in row} for case, row in p9["9a"].items()},
        "9b": {k: v for k, v in p9["9b"].items() if not k.startswith(
            "launches")},
        "9c": {k: v for k, v in p9["9c"].items() if k != "launches"},
        "wall_s": p9["wall_s"]}


# ---------------------------------------------------------------- phase 10

ART_REQUESTS = 64        # 10b: requests each booted replica serves
ART_ADMIT = 8            # 10b: slot-loop admissions a tick (the bank grows)
ART_LADDER_BATCHES = (5, 13, 30, 16)  # 10b: ladder batches (buckets 8-32)
ART_CLI_REQUESTS = 3     # 10d
ART_SEED = 10
# (name, build flags, kernels it ships): attention f32 on the slot loop,
# meanpool bf16 on the batch ladder.
ART_CASES = (
    ("attention_f32_continuous",
     ("--model.feature_fusion", "attention", "--model.compute_dtype",
      "float32", "--serving.dtype", "f32"),
     ["context_attention", "lstm_beam", "row_gemm"]),
    ("meanpool_bf16_ladder",
     ("--model.feature_fusion", "meanpool", "--serving.dtype", "bf16",
      "--serving.continuous", "false"),
     ["lstm_beam", "row_gemm"]),
)
ART_FOREIGN_CARD = "NVIDIA A100-SXM4-80GB"   # 10c: the altered device_kind


def phase10_counted():
    """The wrappers a booted replica's serving launches."""
    from cst_captioning_torch.ops import attention, beam, rowgemm

    return {"lstm_beam": beam.lstm_beam, "attlstm_beam": beam.attlstm_beam,
            "fused_context_attention": attention.fused_context_attention,
            "row_gemm": rowgemm.row_dot}


def art_payloads(np, path: str):
    """The 10b payloads saved by ``build_artifacts`` (one array per video
    and modality)."""
    with np.load(path) as z:
        n = int(z["n"])
        mods = [str(m) for m in z["modalities"]]
        return [{"features": {m: z[f"{i}:{m}"] for m in mods}}
                for i in range(n)]


def art_serve(torch, eng, payload_file: str):
    """The 10b requests (saved in ``payload_file``) through ``eng``: the slot loop (ART_ADMIT a tick,
    every bank it passes noted, then idle ticks down the ladder) or the
    ladder in ART_LADDER_BATCHES.  Returns tokens, scores (the slot
    loop's, or the ladder batches' beam scores decoded after the counted
    run), banks, admitting ticks, decode steps and batches."""
    import numpy as np

    from cst_captioning_torch.decoding.beam import beam_search

    payloads = art_payloads(np, payload_file)
    reqs = [eng.prepare(p) for p in payloads]
    counted = phase10_counted()
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    zero(counted)
    out = {"tokens": {}, "scores": {}}
    if eng.cfg.serving.continuous:
        dec = eng.slot_decoder()
        steps0, admits0 = dec.steps_run, dec.admit_ticks
        banks, pending = [dec.S], list(range(len(reqs)))
        while pending or dec.occupied:
            dec.maybe_resize(len(pending))
            if dec.S != banks[-1]:
                banks.append(dec.S)
            n = min(ART_ADMIT, len(pending), len(dec.free), dec.admit_cap)
            adm = [pending.pop(0) for _ in range(n)]
            for i, toks, score, _ in dec.harvest_many(
                    dec.tick([reqs[i] for i in adm], adm)):
                out["tokens"][i] = [int(t) for t in toks]
                out["scores"][i] = float(score)
        for _ in range(dec.shrink_after):
            dec.maybe_resize(0)
            if dec.S != banks[-1]:
                banks.append(dec.S)
        out.update(banks=banks, admit_ticks=dec.admit_ticks - admits0,
                   steps=dec.steps_run - steps0, batches=0)
    else:
        lo = 0
        for n in ART_LADDER_BATCHES:
            for j, r in enumerate(eng.decode_prepared(reqs[lo: lo + n],
                                                      store=False)):
                out["tokens"][lo + j] = r.tokens
            lo += n
        out.update(banks=[], admit_ticks=0, steps=0,
                   batches=len(ART_LADDER_BATCHES))
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    out["launches"] = counts(counted)
    if not eng.cfg.serving.continuous:
        ev, lo = eng.cfg.eval, 0
        for n in ART_LADDER_BATCHES:
            feats, masks = eng._assemble(reqs[lo: lo + n], eng.bucket(n))
            with torch.no_grad():
                r = beam_search(eng.model, feats, masks, None,
                                beam_size=ev.beam_size,
                                max_len=ev.max_decode_len,
                                length_normalize=ev.length_normalize)
            for j, s in enumerate(r.score[:n].tolist()):
                out["scores"][lo + j] = float(s)
            lo += n
    return out


def art_refusals(vdir: str, tmp: str, device: str = "cuda"):
    """10c, in a process that has loaded no library: a manifest copy with
    ``env.device_kind`` and the ``row_gemm`` digest altered, and a copy
    whose first kernel library (in name order, so the failed boot opens
    none) is truncated.  Returns what each raised."""
    from cst_captioning_torch.ops import _build
    from cst_captioning_torch.serving import artifact as art
    from cst_captioning_torch.serving.engine import InferenceEngine

    res = {}
    man = art.load_manifest(vdir)
    bad = os.path.join(tmp, "mismatch", os.path.basename(vdir))
    shutil.copytree(vdir, bad)
    man["env"]["device_kind"] = ART_FOREIGN_CARD
    man["kernels"]["row_gemm"] = "0" * 16
    with open(os.path.join(bad, art.MANIFEST_NAME), "w") as f:
        json.dump(man, f)
    try:
        InferenceEngine.from_artifact(bad, device=device)
        res["mismatch"] = None
    except art.ArtifactMismatchError as e:
        res["mismatch"] = {"fields": e.fields, "message": str(e)[:400]}
    man = art.load_manifest(vdir)
    if not man["kernels"]:           # an engine on the CPU ships none
        res.update(truncated=None, nvcc_runs=_build.nvcc_runs,
                   loaded=dict(_build.LOADED_FROM))
        return res
    first = sorted(man["kernels"])[0]
    cut = os.path.join(tmp, "truncated", os.path.basename(vdir))
    shutil.copytree(vdir, cut)
    so = os.path.join(cut, art.KERNELS_DIR,
                      f"{first}-{man['kernels'][first]}.so")
    with open(so, "rb") as f:
        data = f.read()
    with open(so, "wb") as f:
        f.write(data[: len(data) // 3])
    try:
        InferenceEngine.from_artifact(cut, device=device)
        res["truncated"] = None
    except art.ArtifactMismatchError as e:
        res["truncated"] = {"type": "ArtifactMismatchError",
                            "message": str(e)[:400]}
    except art.ArtifactError as e:
        res["truncated"] = {"type": "ArtifactError", "library": first,
                            "message": str(e)[:400]}
    res["nvcc_runs"] = _build.nvcc_runs
    res["loaded"] = dict(_build.LOADED_FROM)
    return res


def artifact_child(vdir: str, payload_file: str, out_file: str,
                   refuse: bool = False, device: str = "cuda") -> None:
    """10b (and 10c with ``refuse``) in a fresh process: boot a replica
    from the artifact at ``vdir``, serve the saved requests, write the
    readings as JSON to ``out_file``.  The parent holds them."""
    t_start = time.perf_counter()
    import torch

    from cst_captioning_torch.ops import _build
    from cst_captioning_torch.serving.engine import InferenceEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = {"import_s": time.perf_counter() - t_start}
    if refuse:
        res["refusals"] = art_refusals(vdir, os.path.dirname(out_file),
                                       device)
    t0 = time.perf_counter()
    eng = InferenceEngine.from_artifact(vdir, device=device)
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    res["boot_s"] = time.perf_counter() - t0
    res.update(nvcc_runs=_build.nvcc_runs,
               loaded_from=dict(_build.LOADED_FROM),
               artifact_version=eng.artifact_version,
               fingerprint=eng.fingerprint())
    t0 = time.perf_counter()
    res["served"] = art_serve(torch, eng, payload_file)
    res["serve_s"] = time.perf_counter() - t0
    with open(out_file, "w") as f:
        json.dump(res, f)


def no_nvcc_env() -> dict:
    """The environment of a booted replica: no ``nvcc`` on PATH, no
    CUDA_HOME, so a build could not find the compiler there."""
    env = dict(os.environ)
    env.pop("CUDA_HOME", None)
    env.pop("CUDA_PATH", None)
    env["PATH"] = os.pathsep.join(
        d for d in env.get("PATH", "").split(os.pathsep)
        if d and not os.access(os.path.join(d, "nvcc"), os.X_OK))
    return env


def run_child(args: list, out_file: str, timeout: int = 300) -> dict:
    """``artifact_child(*args)`` in a fresh interpreter under
    ``no_nvcc_env``, from this script's directory; returns its JSON."""
    code = ("import sys, chip_smoke; "
            "chip_smoke.artifact_child(*sys.argv[1:4], "
            "refuse=sys.argv[4] == '1')")
    r = subprocess.run([sys.executable, "-c", code, *args], cwd=REPO_DIR,
                       env=no_nvcc_env(), capture_output=True, text=True,
                       timeout=timeout)
    if r.returncode != 0:
        fail(f"10b: the booted replica exited {r.returncode}:\n"
             f"{r.stdout[-3000:]}\n{r.stderr[-6000:]}")
    with open(out_file) as f:
        res = json.load(f)
    for key in ("tokens", "scores"):      # JSON keys are strings
        res["served"][key] = {int(i): v for i, v in
                              res["served"][key].items()}
    return res


def build_artifacts(torch, tmp: str, cases=ART_CASES,
                    weights=("--random-init",)) -> list:
    """10a: ``cli/build_artifact.py`` on ``cases`` at full width from
    ``weights`` (``--random-init``, or 14b's ``--checkpoint``); the 10b
    payloads saved beside them.  Held: each build written, its kernels
    the expected ones, each shipped library byte for byte the one nvcc
    wrote."""
    import contextlib
    import filecmp
    import io

    import numpy as np

    from cst_captioning_torch.cli import build_artifact as cli
    from cst_captioning_torch.config import get_preset
    from cst_captioning_torch.data.vocab import Vocabulary
    from cst_captioning_torch.ops import _build
    from cst_captioning_torch.serving import artifact as art

    os.makedirs(tmp, exist_ok=True)
    vocab_file = os.path.join(tmp, "vocab.json")
    Vocabulary([f"w{i}" for i in range(V - 4)]).save(vocab_file)
    base = get_preset(SERVE_PRESET)
    payloads, bodies = make_bodies(np, base, ART_REQUESTS, ART_SEED)
    payload_file = os.path.join(tmp, "payloads.npz")
    np.savez(payload_file, n=ART_REQUESTS,
             modalities=np.array(base.data.feature_modalities),
             **{f"{i}:{m}": a for i, p in enumerate(payloads)
                for m, a in p["features"].items()})
    out = []
    for name, flags, want in cases:
        root = os.path.join(tmp, name)
        argv = ["--preset", SERVE_PRESET, *weights, "--out", root,
                "--data.vocab_file", vocab_file,
                "--serving.flight_dir", os.path.join(tmp, "flight"),
                "--serving.profile_dir", os.path.join(tmp, "profiles"),
                *flags]
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv, device=DEVICE)
        wall = time.perf_counter() - t0
        summary = json.loads(buf.getvalue().strip().splitlines()[-1])
        log(f"10a build_artifact {name}: rc {rc} in {wall:.2f} s: "
            f"{json.dumps(summary)}")
        if rc != 0 or not summary["rebuilt"] or summary["kernels"] != want:
            fail(f"10a {name}: rc {rc}, summary {summary}, want kernels "
                 f"{want}")
        man = art.load_manifest(summary["path"])
        for k, digest in man["kernels"].items():
            shipped = os.path.join(summary["path"], art.KERNELS_DIR,
                                   f"{k}-{digest}.so")
            if not filecmp.cmp(shipped, _build.library_path(k),
                               shallow=False):
                fail(f"10a {name}: {shipped} is not nvcc's library")
        out.append(dict(name=name, root=root, vdir=summary["path"],
                        manifest=man, summary=summary, build_s=wall))
    return out, payload_file, bodies


def warm_twin(torch, case, payload_file: str):
    """A warm engine in this process from the artifact's own params and
    config (constructed with its warmup), serving the 10b requests."""
    from cst_captioning_torch.config import Config
    from cst_captioning_torch.data.vocab import Vocabulary
    from cst_captioning_torch.serving.engine import InferenceEngine
    from cst_captioning_torch.training.checkpoint import load_params_file

    cfg = Config.from_dict(case["manifest"]["config"])
    cfg.serving.warmup = True
    vdir = case["vdir"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = InferenceEngine(cfg, params=load_params_file(vdir),
                          vocab=Vocabulary.load(os.path.join(vdir,
                                                             "vocab.json")),
                          device=DEVICE)
    torch.cuda.synchronize()
    ctor_s = time.perf_counter() - t0
    return ctor_s, art_serve(torch, eng, payload_file)


def art_want_launches(fusion: str, served: dict) -> dict:
    """Launches of 10b's serving: the slot loop's admission encodes and
    steps (the context kernel once a step under attention), or one
    ``lstm_beam`` and the encode's products a ladder batch."""
    if served["batches"]:
        return {"lstm_beam": served["batches"],
                "row_gemm": LADDER_ROW_GEMM * served["batches"]}
    want = {"row_gemm": ADMIT_RG[fusion] * served["admit_ticks"]
            + STEP_RG[fusion] * served["steps"]}
    if fusion == "attention":
        want["fused_context_attention"] = served["steps"]
    return want


def check_artifact_cli(case, bodies, want_tokens, card: str, tmp: str):
    """10d: ``python -m cst_captioning_torch.cli.serve --artifact`` as a
    user runs it (no nvcc on PATH): ART_CLI_REQUESTS POSTs of the 10b
    videos answer the warm engine's tokens, ``/healthz`` names the
    artifact version, SIGTERM drains and exits 0."""
    import signal
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    logf = os.path.join(tmp, "serve_cli.log")
    url = f"http://127.0.0.1:{port}"
    t0 = time.perf_counter()
    with open(logf, "w") as lf:
        proc = subprocess.Popen(
            [sys.executable, "-m", "cst_captioning_torch.cli.serve",
             "--artifact", case["root"], "--serving.host", "127.0.0.1",
             "--serving.port", str(port)], cwd=REPO_DIR, env=no_nvcc_env(),
            stdout=lf, stderr=subprocess.STDOUT)
        try:
            health = None
            while time.perf_counter() - t0 < 240:
                if proc.poll() is not None:
                    break
                try:
                    health = get_json(url + "/healthz")
                    break
                except (urllib.error.URLError, ConnectionError, OSError):
                    time.sleep(0.5)
            up_s = time.perf_counter() - t0
            if health is None:
                with open(logf) as f:
                    tail = f.read()[-4000:]
                fail(f"10d: cli/serve --artifact never answered /healthz "
                     f"(rc {proc.poll()}):\n{tail}")
            got = []
            for i in range(ART_CLI_REQUESTS):
                req = urllib.request.Request(
                    url + "/v1/caption", data=bodies[i],
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=120) as r:
                    got.append(json.loads(r.read())["tokens"])
        finally:
            proc.send_signal(signal.SIGTERM)
            try:
                rc = proc.wait(timeout=90)
            except subprocess.TimeoutExpired:
                proc.kill()
                rc = proc.wait(timeout=30)
    version = case["manifest"]["artifact_version"]
    log(f"10d cli/serve --artifact {case['name']}: /healthz after "
        f"{up_s:.1f} s (build {health['build']}), {ART_CLI_REQUESTS} "
        f"captions, SIGTERM exit {rc}  [{card}]")
    if health["build"]["artifact_version"] != version:
        fail(f"10d: /healthz names {health['build']['artifact_version']}, "
             f"the manifest {version}")
    if got != [want_tokens[i] for i in range(ART_CLI_REQUESTS)]:
        fail(f"10d: served tokens differ from the warm engine's: {got}")
    if rc != 0:
        fail(f"10d: cli/serve exited {rc} after SIGTERM")
    return {"healthz_s": up_s, "exit": rc}


def check_artifacts(torch, card: str, tmp: str, build_s: float):
    """Phase 10 (see the module docstring): 10a build, 10b boot and
    serve in fresh processes against warm twins, 10c refusals, 10d the
    CLI, 10e readings.  Returns the readings."""
    t_all = time.perf_counter()
    cases, payload_file, bodies = build_artifacts(torch, tmp)
    res = {"cases": {}}
    for case in cases:
        name, vdir = case["name"], case["vdir"]
        fusion = case["manifest"]["config"]["model"]["feature_fusion"]
        refuse = not case["manifest"]["config"]["serving"]["continuous"]
        out_file = os.path.join(tmp, f"{name}-child.json")
        t0 = time.perf_counter()
        child = run_child([vdir, payload_file, out_file,
                           "1" if refuse else "0"], out_file)
        child_wall = time.perf_counter() - t0
        ctor_s, warm = warm_twin(torch, case, payload_file)
        served = child["served"]
        kdir = os.path.join(vdir, "kernels")
        loaded = child["loaded_from"]
        log(f"10b {name}: booted in {child['boot_s']:.2f} s (import "
            f"{child['import_s']:.2f} s, process {child_wall:.1f} s), nvcc "
            f"runs {child['nvcc_runs']}, libraries {loaded}; served "
            f"{len(served['tokens'])} in {child['serve_s']:.2f} s, banks "
            f"{served['banks']}, launches {served['launches']}; the warm "
            f"twin's construction {ctor_s:.2f} s  [{card}]")
        if child["nvcc_runs"] != 0:
            fail(f"10b {name}: the boot ran nvcc {child['nvcc_runs']} times")
        if sorted(loaded) != sorted(case["manifest"]["kernels"]) or any(
                os.path.dirname(p) != kdir for p in loaded.values()):
            fail(f"10b {name}: libraries loaded from {loaded}, want every "
                 f"one of {sorted(case['manifest']['kernels'])} under {kdir}")
        if child["artifact_version"] != case["manifest"]["artifact_version"]:
            fail(f"10b {name}: booted {child['artifact_version']}")
        if served["banks"] and not (
                any(b > a for a, b in zip(served["banks"],
                                          served["banks"][1:]))
                and any(b < a for a, b in zip(served["banks"],
                                              served["banks"][1:]))):
            fail(f"10b {name}: banks {served['banks']}: no grow and shrink")
        for key in ("tokens", "scores", "banks"):
            if served[key] != warm[key]:
                diff = ([i for i in served[key]
                         if served[key][i] != warm[key].get(i)]
                        if isinstance(served[key], dict) else served[key])
                fail(f"10b {name}: {key} of the booted replica differ from "
                     f"the warm twin's ({diff[:8]})")
        hold_counts(served["launches"],
                           art_want_launches(fusion, served),
                           f"10b {name}, the booted replica")
        row = {"boot_s": child["boot_s"], "import_s": child["import_s"],
               "process_s": child_wall, "serve_s": child["serve_s"],
               "warm_ctor_s": ctor_s, "build_s": case["build_s"],
               "artifact_bytes": case["summary"]["artifact_bytes"],
               "artifact_version": child["artifact_version"],
               "kernels": sorted(loaded), "launches": served["launches"],
               "banks": served["banks"], "steps": served["steps"],
               "admit_ticks": served["admit_ticks"],
               "batches": served["batches"],
               "distinct_captions": len({tuple(t) for t in
                                         served["tokens"].values()})}
        if refuse:
            ref = child["refusals"]
            mm, tr = ref["mismatch"], ref["truncated"]
            log(f"10c refusals {name}: {json.dumps(ref)}")
            if mm is None or not {"env.device_kind", "kernels.row_gemm"} <= \
                    set(mm["fields"]):
                fail(f"10c: the altered manifest gave {mm}")
            if tr is None or tr["type"] != "ArtifactError":
                fail(f"10c: the truncated library gave {tr}")
            if ref["nvcc_runs"] != 0 or ref["loaded"]:
                fail(f"10c: the refusals ran nvcc {ref['nvcc_runs']} times "
                     f"or loaded {ref['loaded']}")
            row["refusals"] = ref
            row["cli"] = check_artifact_cli(case, bodies, served["tokens"],
                                            card, tmp)
        res["cases"][name] = row
    res["nvcc_build_s"] = build_s
    res["wall_s"] = time.perf_counter() - t_all
    for name, row in res["cases"].items():
        log(f"10e {name}: boot {row['boot_s']:.2f} s in a fresh process "
            f"({row['import_s']:.2f} s of imports before it) against phase "
            f"1's nvcc build {build_s:.1f} s plus a warm engine's "
            f"construction {row['warm_ctor_s']:.2f} s; artifact "
            f"{row['artifact_bytes']} bytes  [{card}]")
    log(f"phase 10 (serving artifacts) took {res['wall_s']:.1f} s  [{card}]")
    return res


def add_phase10_readings(kernels, p10):
    """Phase 10's launches (``phase10_launches``, per booted replica) on
    the entries of the kernels they ran, and its readings on
    ``row_gemm``'s entry."""
    for k in kernels:
        got = {name: row["launches"][k["name"]]
               for name, row in p10["cases"].items()
               if row["launches"].get(k["name"])}
        if got:
            k["phase10_launches"] = got
    rg = next(k for k in kernels if k["name"] == "row_gemm")
    rg["phase10"] = {name: {key: v for key, v in row.items()
                            if key != "launches"}
                     for name, row in p10["cases"].items()}
    rg["phase10"]["nvcc_build_s"] = p10["nvcc_build_s"]
    rg["phase10"]["wall_s"] = p10["wall_s"]



# ------------------------------------------------------------ phase 11

P11_M = 2                 # model shards (msrvtt_serve_tp2 / _r2xtp2)
P11_REQUESTS = 64         # 11a / 11b / 11d: requests through a slot loop
P11_DTYPES = ("f32", "bf16", "int8w")
P11_SCORE_RTOL = 1e-4     # r15: the folded normalizer moves scores by ulps
P11_XE_VIDEOS = 64        # 11c: videos a batch (x 20 captions = 1,280 rows)
P11_XE_STEPS = 3
P11_LOSS_RTOL = 1e-5      # r12
P11_PARAM_RTOL, P11_PARAM_ATOL = 2e-5, 1e-5
P11_SEED = 11


def mesh_devices(torch, n: int):
    """``n`` mesh positions: distinct cards where the host has ``n``,
    else card 0 at every position (a one-card mesh measures no
    NVLink)."""
    if DEVICE != "cuda":
        return [torch.device(DEVICE)] * n
    if torch.cuda.device_count() >= n:
        return [torch.device("cuda", i) for i in range(n)]
    return [torch.device("cuda", 0)] * n


def p11_cfg(preset: str, fusion: str, dtype: str = "f32", fused=True):
    """A serving preset at full width (V = 10,496) through the CLI
    parser, with ``fusion``, ``serving.dtype`` and the merge arm."""
    from cst_captioning_torch.config import parse_cli

    cfg = parse_cli([
        "--preset", preset, "--serving.port", "0", "--serving.warmup",
        "false", "--serving.continuous", "true", "--serving.dtype", dtype,
        "--serving.shard_fused_decode", "true" if fused else "false",
        "--model.vocab_size", str(V), "--model.feature_fusion", fusion])
    cfg.serving.flight_dir = ""
    return cfg


def p11_params(torch, fusion: str):
    """Random float weights of the serving model from a seed, spread
    (embeddings x10, LSTM x2, vocab head x3, EOS bias +0.6) so captions
    vary in length (1 to 30 tokens) and content."""
    from cst_captioning_torch.models.captioner import model_from_config

    cfg = p11_cfg("msrvtt_serve_beam5", fusion)
    m = model_from_config(cfg, device="cpu")
    m.init_weights(torch.Generator().manual_seed(P11_SEED))
    sd = {k: v.detach().clone() for k, v in m.state_dict().items()}
    sd["word_embed"] *= 10.0
    sd["lstm0_w"] *= 2.0
    sd["logit_w"] *= 3.0
    sd["logit_b"][2] += 0.6
    return sd


def p11_payloads(np, cfg, n: int, seed: int = P11_SEED):
    """``n`` requests of random frames at the preset's widths, 14..28
    frames each."""
    rng = np.random.RandomState(seed)
    d = cfg.data
    out = []
    for _ in range(n):
        nf = int(rng.randint(d.max_frames // 2, d.max_frames + 1))
        out.append({"features": {m: rng.standard_normal(
            (nf, d.feature_dims[m])).astype(np.float32)
            for m in d.feature_modalities}})
    return out


def p11_slot_run(torch, engine, payloads, counted):
    """The slot loop on ``payloads`` from zeroed counters, after one pass
    over its banks (``SlotDecoder.warmup``): (served, admitting ticks,
    steps, launches, wall ms)."""
    engine.slot_decoder().warmup()
    zero(counted)
    sync(torch)
    t0 = time.perf_counter()
    got, admits, steps = slot_serve(engine, payloads)
    sync(torch)
    return got, admits, steps, counts(counted), (time.perf_counter() - t0) * 1e3


def sync(torch):
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def hold_same_served(one, tp, rtol: float, what: str):
    for i in range(len(one)):
        if one[i]["tokens"] != tp[i]["tokens"]:
            fail(f"{what}: request {i} tokens {tp[i]['tokens']} != "
                 f"{one[i]['tokens']}")
        a, b = one[i]["score"], tp[i]["score"]
        if a is not None and abs(a - b) > rtol * abs(a) + 1e-6:
            fail(f"{what}: request {i} score {b} vs {a}")
    lens = sorted({sum(t != 0 for t in s["tokens"]) for s in one.values()})
    log(f"{what}: {len(one)} requests token-exact, scores within rtol "
        f"{rtol:g}; caption lengths {lens[:3]}..{lens[-3:]}")


def check_tp_serving(torch, card: str, counted):
    """Phase 11a (see the module docstring).  ``counted``: the wrappers
    the slot loop launches, {row_gemm, fused_context_attention}."""
    import numpy as np

    from cst_captioning_torch.data.vocab import Vocabulary
    from cst_captioning_torch.serving.engine import InferenceEngine

    vocab = Vocabulary([f"w{i}" for i in range(V - 4)])
    presets = {"f32": "msrvtt_serve_tp2", "bf16": "msrvtt_serve_tp2",
               "int8w": "msrvtt_serve_int8w_tp2"}
    res = {"launches": {}, "ms_per_step": {}, "ladder_match": {}}
    singles = {}
    payloads = p11_payloads(np, p11_cfg("msrvtt_serve_beam5", "meanpool"),
                            P11_REQUESTS)
    devs = mesh_devices(torch, P11_M)
    for fusion in ("meanpool", "attention"):
        params = p11_params(torch, fusion)
        for dtype in P11_DTYPES:
            one = InferenceEngine(p11_cfg("msrvtt_serve_beam5", fusion,
                                          dtype),
                                  params=params, vocab=vocab, device=DEVICE)
            got1, adm1, st1, c1, ms1 = p11_slot_run(torch, one, payloads,
                                                    counted)
            for fused in ((True, False) if dtype == "f32" else (True,)):
                what = (f"11a {fusion} {dtype} "
                        f"{'merge' if fused else 'gather'}")
                tp = InferenceEngine(p11_cfg(presets[dtype], fusion, dtype,
                                             fused),
                                     params=params, vocab=vocab,
                                     devices=devs)
                if (tp.fingerprint()["mesh_shape"] != "1x2"
                        or tp.model.vshards is None
                        or tp.serving_dtype != dtype):
                    fail(f"{what}: the engine is not a 1x2 vocab split "
                         f"({tp.fingerprint()})")
                dec = tp.slot_decoder()
                if (dec.tp_topk is not None) != fused:
                    fail(f"{what}: the merge hook is {dec.tp_topk}")
                got2, adm2, st2, c2, ms2 = p11_slot_run(torch, tp, payloads,
                                                        counted)
                hold_same_served(got1, got2, P11_SCORE_RTOL, what)
                if (adm2, st2) != (adm1, st1):
                    fail(f"{what}: {adm2} admitting ticks / {st2} steps vs "
                         f"{adm1} / {st1} on one device")
                # Each decode step's vocab product runs once a shard.
                want = dict(c1)
                want["row_gemm"] += (P11_M - 1) * st2
                if dtype == "int8w":
                    want["row_gemm_quant"] += (P11_M - 1) * st2
                res["launches"][what] = hold_counts(
                    c2, {k: v for k, v in want.items() if v}, what)
                res["ms_per_step"][what] = (ms2 / st2, ms1 / st1)
                log(f"{what}: {ms2 / st2:.3f} ms a decode step on the 1x2 "
                    f"mesh vs {ms1 / st1:.3f} ms on one device ({st2} steps, "
                    f"{adm2} admitting ticks; {card})")
                del tp
            if dtype == "f32":
                singles[fusion] = (one, got1, params)
                res["ladder_match"][fusion] = tp_ladder(
                    torch, one, presets[dtype], fusion, params, vocab,
                    payloads, devs, counted, card)
            else:
                del one
    res["singles"] = singles
    return res


def tp_ladder(torch, one, preset, fusion, params, vocab, payloads, devs,
              counted, card):
    """The ladder's sharded decoders (``ops/shard_decode.py``, engaged by
    the preset's ``use_pallas_beam``): one batch of the ladder top, its
    launches held (the encode's products, the meanpool static gate rows,
    then per step the gate products and one vocab product a shard), its
    tokens exact and its beam scores within ``P11_SCORE_RTOL`` against
    the same decoders over one shard that holds the whole vocab on one
    device (no merge; every logit column is the one-device ``row_gemm``
    column and the normalizer folds to the same bits).  Two caption
    matches are printed readings: against the one-device ladder's
    ``lstm_beam`` kernel and against the one-device per-step beam, which
    both sum the gates in other orders, so neither is an exact witness."""
    from cst_captioning_torch.decoding.beam import beam_search
    from cst_captioning_torch.parallel.mesh import row_mesh
    from cst_captioning_torch.serving.engine import InferenceEngine

    tp = InferenceEngine(p11_cfg(preset, fusion), params=params, vocab=vocab,
                         devices=devs)
    if tp.model.decode_mesh is None:
        fail(f"11a ladder {fusion}: the sharded decoders did not engage "
             f"({tp.model.mesh_decline})")
    n = tp.max_batch
    ev = tp.cfg.eval
    L = ev.max_decode_len
    kernel_tok = ladder_serve(one, payloads[:n])
    step_tok = offline_decodes(torch, one, payloads[:n])["per_step"][0].cpu()
    zero(counted)
    sync(torch)
    t0 = time.perf_counter()
    got_tok = ladder_serve(tp, payloads[:n])
    sync(torch)
    ms = (time.perf_counter() - t0) * 1e3
    # The encode's products (the two projections, and the attention
    # projection or the meanpool static gate rows), then a step's gate
    # products and one vocab product a shard.
    per_step = (3 if fusion == "attention" else 2) + P11_M
    hold_counts(counts(counted), {"row_gemm": 3 + per_step * L},
                f"11a ladder {fusion}")
    # The witness: the one-device engine's model through the sharded
    # decoders over a one-position mesh, on the ladder's batch.
    wit = InferenceEngine(p11_cfg("msrvtt_serve_beam5", fusion),
                          params=params, vocab=vocab, device=DEVICE)
    wit.model.decode_mesh = row_mesh([wit.model.device])
    feats, masks = tp._assemble([tp.prepare(p) for p in payloads[:n]], n)
    kw = dict(beam_size=ev.beam_size, length_normalize=ev.length_normalize,
              max_len=L)
    want = beam_search(wit.model, feats, masks, **kw)
    r = beam_search(tp.model, feats, masks, **kw)
    want_tok = want.tokens.cpu()
    for what, toks in (("ladder", got_tok), ("beam_search", r.tokens.cpu())):
        bad = (toks != want_tok).any(dim=1).nonzero().flatten().tolist()
        if bad:
            fail(f"11a ladder {fusion}: the sharded {what} differs from the "
                 f"one-shard decode on {len(bad)} of {n} videos (first "
                 f"{bad[0]}: {toks[bad[0]].tolist()} vs "
                 f"{want_tok[bad[0]].tolist()})")
    ws = want.score.float().cpu()
    rel = float(((r.score.float().cpu() - ws).abs()
                 / ws.abs().clamp_min(1e-6)).max())
    if rel > P11_SCORE_RTOL:
        fail(f"11a ladder {fusion}: beam scores off by rtol {rel:.3e}")
    share = float((got_tok == kernel_tok).all(dim=1).float().mean())
    step_share = float((got_tok == step_tok).all(dim=1).float().mean())
    log(f"11a ladder {fusion}: {n} videos through the sharded beam in "
        f"{ms:.1f} ms ({card}); tokens exact and scores within rtol "
        f"{rel:.3e} vs the one-shard decode; caption match (readings) vs "
        f"the one-device lstm_beam kernel {share:.4f}, vs the one-device "
        f"per-step beam {step_share:.4f}")
    del wit
    return {"lstm_beam": share, "per_step": step_share}


def check_tp_grid(torch, card: str, singles, counted):
    """Phase 11b: ``msrvtt_serve_r2xtp2``'s (2, 2) grid through the
    ``ReplicaSet``, the requests from client threads, token-exact
    against the offline per-step decode on one device."""
    import numpy as np

    from cst_captioning_torch.serving.engine import InferenceEngine
    from cst_captioning_torch.serving.replicas import ReplicaSet

    one, _, params = singles["meanpool"]
    payloads = p11_payloads(np, one.cfg, P11_REQUESTS, seed=P11_SEED + 1)
    offline = offline_decodes(torch, one, payloads)["per_step"][0]
    cfg = p11_cfg("msrvtt_serve_r2xtp2", "meanpool")
    cfg.serving.default_deadline_ms = 600_000.0
    eng = InferenceEngine(cfg, params=params, vocab=one.vocab,
                          devices=mesh_devices(torch, 2 * P11_M))
    rs = ReplicaSet.from_engine(eng)
    if len(rs.replicas) != 2 or any(
            r.engine.fingerprint()["mesh_shape"] != "1x2"
            for r in rs.replicas):
        fail("11b: the grid is not 2 replicas of 1x2")
    results, errors, lock = {}, [], threading.Lock()

    def client(i):
        try:
            out = rs.submit(dict(payloads[i]))
            with lock:
                results[i] = out
        except Exception as e:  # noqa: BLE001 — failed below
            with lock:
                errors.append((i, repr(e)))

    zero(counted)
    t0 = time.perf_counter()
    with rs:
        ths = [threading.Thread(target=client, args=(i,))
               for i in range(len(payloads))]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors or len(results) != len(payloads):
        fail(f"11b: {errors[:3]}, {len(results)} results")
    for i in range(len(payloads)):
        want = [int(t) for t in offline[i].tolist()]
        if [int(t) for t in results[i]["tokens"]] != want:
            fail(f"11b: request {i} {results[i]['tokens']} != offline "
                 f"{want}")
    by = [rs.metrics.replica(r.rid).admitted_total.value
          for r in rs.replicas]
    log(f"11b: {len(payloads)} requests through the (2, 2) grid in "
        f"{wall:.3f} s, admitted by replica {by}, token-exact vs the "
        f"offline per-step decode; launches {counts(counted)} ({card})")
    if min(by) < 1:
        fail(f"11b: a replica admitted nothing ({by})")
    return {"wall_s": wall, "admitted": by,
            "launches": counts(counted)}


def p11_train_cfg(fusion: str, mesh: bool, workdir: str,
                  dtype: str = "float32"):
    from cst_captioning_torch.config import get_preset

    cfg = get_preset("msrvtt_xe_2d" if mesh else "msrvtt_resnet_c3d_xe")
    cfg.model.feature_fusion = fusion
    cfg.model.compute_dtype = dtype
    cfg.model.vocab_size = V
    cfg.data.batch_size = P11_XE_VIDEOS
    cfg.train.checkpoint_dir = workdir
    cfg.train.reward_workers = 0
    return cfg


def p11_trainer(torch, fusion, mesh, corpus, workdir, mode="xe",
                dtype="float32"):
    from cst_captioning_torch.training.trainer import Trainer

    cfg = p11_train_cfg(fusion, mesh, workdir, dtype)
    if mode == "cst":
        cfg.train.train_mode = "cst"
        cfg.train.cst_baseline = "scb"
        # The per-step rollout on one device too: the reference's gate
        # declines the fused sampler on a data-sharded mesh, so both
        # runs then draw from one stream.
        cfg.model.use_pallas_sampler = False
    devices = mesh_devices(torch, 4) if mesh else [torch.device(DEVICE)]
    tr = Trainer(cfg, corpus, devices=devices)
    if mesh and tr.mesh.shape != {"data": 2, "model": 2}:
        fail(f"11c: mesh {tr.mesh.shape}")
    return tr


def p11_steps(torch, tr, batches, counted):
    """``len(batches)`` steps of ``tr`` from zeroed counters: ([loss],
    [params after each step, gathered], launches, wall ms a step)."""
    zero(counted)
    losses, states, walls = [], [], []
    for i, b in enumerate(batches):
        sync(torch)
        t0 = time.perf_counter()
        m = tr._train_step(b.feats, b.feat_masks, b.captions,
                           torch.ones_like(b.weights), None, b.video_idx,
                           tr._step_generator(0, i), 0.0)
        loss = float(m["loss"])
        sync(torch)
        walls.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        src = (tr.mesh_model.gathered_state_dict() if tr.mesh_model
               else {k: v.detach().to("cpu", copy=True) for k, v in
                     tr.model.state_dict().items()})
        states.append(src)
    return losses, states, counts(counted), walls


def hold_params(a, b, what: str):
    worst = 0.0
    for k, v in a.items():
        d = (b[k].float() - v.float()).abs()
        lim = P11_PARAM_ATOL + P11_PARAM_RTOL * v.float().abs()
        worst = max(worst, float((d / lim).max()))
        if bool((d > lim).any()):
            fail(f"{what}: {k} differs by {float(d.max()):.3e}")
    log(f"{what}: parameters within rtol {P11_PARAM_RTOL:g} / atol "
        f"{P11_PARAM_ATOL:g} (worst |diff| / bound {worst:.4f})")
    return worst


def check_mesh_training(torch, card: str, counted, tmp: str):
    """Phase 11c (see the module docstring).  ``counted``: the training
    kernels' wrappers."""
    import numpy as np

    from cst_captioning_torch.data import loader as tloader
    from cst_captioning_torch.data.vocab import Vocabulary

    res = {}
    vocab = Vocabulary([f"w{i}" for i in range(V - 4)])
    cfg0 = p11_train_cfg("meanpool", True, tmp)
    corpus = make_msrvtt_corpus(np, vocab, cfg0,
                                P11_XE_VIDEOS * P11_XE_STEPS, seed=P11_SEED)
    lead = torch.device(DEVICE if DEVICE != "cuda" else "cuda:0")
    # The r12 parity at float32 compute (meanpool 3 steps and a bitwise
    # rerun; attention 1 step), then bf16 (the preset's dtype): 1 step,
    # timed, its loss at the bf16 tier.
    for fusion, dtype in (("meanpool", "float32"), ("attention", "float32"),
                          ("meanpool", "bfloat16")):
        n = P11_XE_STEPS if (fusion, dtype) == ("meanpool", "float32") else 1
        runs = {}
        for name, mesh in (("one", False), ("mesh", True), ("mesh2", True)):
            if n == 1 and name == "mesh2":
                continue
            tr = p11_trainer(torch, fusion, mesh, corpus,
                             os.path.join(tmp, f"{fusion}_{dtype}_{name}"),
                             dtype=dtype)
            batches = [tloader.to_device(b, lead) for b, _ in
                       zip(tr.train_iter.epoch(0), range(n))]
            det = name.startswith("mesh") and n > 1
            if det:
                torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                runs[name] = p11_steps(torch, tr, batches, counted)
            finally:
                if det:
                    torch.use_deterministic_algorithms(False)
            if name == "mesh" and n > 1:
                res["trainer"] = tr
            else:
                del tr
        (l1, s1, c1, w1), (l2, s2, c2, w2) = runs["one"], runs["mesh"]
        what = f"11c {fusion} {dtype}"
        if dtype == "bfloat16":
            # bf16 rounds the vocab-parallel sums in their own order; the
            # loss at the bf16 kernel tier, the parameters not held.
            if abs(l1[0] - l2[0]) > KERNEL_BF16_SCORE_RTOL * abs(l1[0]):
                fail(f"{what}: loss {l2} vs {l1} on one device")
            res["bf16_step_ms"] = (w2, w1)
            res["bf16_losses"] = (l2, l1)
            log(f"{what}: loss {l2} on the 2x2 mesh vs {l1} on one device; "
                f"step ms {w2[0]:.1f} vs {w1[0]:.1f} ({card})")
            continue
        for i, (a, b) in enumerate(zip(l1, l2)):
            if abs(a - b) > P11_LOSS_RTOL * abs(a):
                fail(f"{what}: step {i} loss {b} vs {a} on one device")
        res[f"{fusion}_param_worst"] = hold_params(s1[0], s2[0],
                                                   f"{what} after step 1")
        rec = "lstm_recurrence" if fusion == "meanpool" else \
            "attlstm_recurrence"
        want_one = {rec: n}
        want_mesh = {rec: 2 * n}
        if fusion == "attention":
            want_one["attlstm_recurrence_bwd"] = n
            want_mesh["attlstm_recurrence_bwd"] = 2 * n
        res[f"{fusion}_launches_one"] = hold_counts(c1, want_one,
                                                    f"{what} one device")
        res[f"{fusion}_launches_mesh"] = hold_counts(
            c2, want_mesh, f"{what} (data 2 x model 2)")
        res[f"{fusion}_step_ms"] = (w2, w1)   # the first step warms up
        log(f"{what}: losses {l2} on the 2x2 mesh vs {l1} on one device "
            f"(rtol {P11_LOSS_RTOL:g}); step ms {[round(x, 1) for x in w2]} "
            f"vs {[round(x, 1) for x in w1]} ({card}; one card: no NVLink "
            "in the reading)")
        if "mesh2" in runs:
            s3 = runs["mesh2"][1]
            for k in s2[-1]:
                if not torch.equal(s2[-1][k], s3[-1][k]):
                    fail(f"{what}: two runs on one mesh differ in {k}")
            log(f"{what}: two {n}-step runs on the 2x2 mesh bitwise equal "
                "(deterministic algorithms on)")
    cst = {}
    for name, mesh in (("one", False), ("mesh", True)):
        tr = p11_trainer(torch, "meanpool", mesh, corpus,
                         os.path.join(tmp, f"cst_{name}"), mode="cst")
        if tr._train_step.layout != "split":
            fail(f"11c CST {name}: the {tr._train_step.layout} step")
        b = tloader.to_device(next(iter(tr.train_iter.epoch(0))), lead)
        zero(counted)
        sync(torch)
        t0 = time.perf_counter()
        m = tr._train_step(b.feats, b.feat_masks, b.captions, b.weights,
                           None, b.video_idx, tr._step_generator(0, 0), 0.0)
        sync(torch)
        ms = (time.perf_counter() - t0) * 1e3
        state = (tr.mesh_model.gathered_state_dict() if tr.mesh_model
                 else {k: v.detach().to("cpu", copy=True) for k, v in
                       tr.model.state_dict().items()})
        cst[name] = (m, state, counts(counted), ms)
        del tr
    (m1, s1, c1, w1), (m2, s2, c2, w2) = cst["one"], cst["mesh"]
    for k in ("reward", "baseline", "advantage"):
        if m1[k] != m2[k]:
            fail(f"11c CST: {k} {m2[k]} on the 2x2 mesh vs {m1[k]} on one "
                 "device")
    l1, l2 = float(m1["loss"]), float(m2["loss"])
    if not (math.isfinite(l2) and abs(l1 - l2) <= P11_LOSS_RTOL * abs(l1)):
        fail(f"11c CST: loss {l2} on the 2x2 mesh vs {l1} on one device")
    res["cst_param_worst"] = hold_params(s1, s2, "11c CST step")
    hold_counts(c1, {"lstm_recurrence": 1}, "11c CST one device")
    hold_counts(c2, {"lstm_recurrence": 2}, "11c CST (data 2 x model 2)")
    res["cst_step_ms"] = (w2, w1)
    log(f"11c CST: loss {l2!r} on the 2x2 mesh vs {l1!r} on one device "
        f"(rtol {P11_LOSS_RTOL:g}), reward {m2['reward']!r} == "
        f"{m1['reward']!r}; step {w2:.1f} ms on the mesh vs {w1:.1f} ms "
        f"({card})")
    res["cst_launches"] = {k: v for k, v in c2.items() if v}
    return res


def check_mesh_checkpoint(torch, card: str, tr, singles, counted, tmp: str):
    """Phase 11d: 11c's (2, 2) trainer saved, loaded on one device
    bitwise, and served by a one-device engine and a 1x2 engine with the
    same tokens (11a's holds)."""
    import numpy as np

    from cst_captioning_torch.models.captioner import model_from_config
    from cst_captioning_torch.serving.engine import InferenceEngine
    from cst_captioning_torch.training import checkpoint as ckpt

    path = os.path.join(tmp, "ck2x2")
    ckpt.save_checkpoint(path, tr._ckpt_model, tr.optimizer, {"epoch": 0})
    meta = ckpt.saved_sharding(path)
    if meta["mesh_shape"] != "2x2" or meta["specs"]["word_embed"] != [
            "model", None]:
        fail(f"11d: sidecar {meta['mesh_shape']}, {meta['specs']}")
    full = tr.mesh_model.gathered_state_dict()
    one = model_from_config(tr.cfg, device="cpu")
    ckpt.restore_params(path, one)
    for k, v in one.state_dict().items():
        if not torch.equal(v, full[k]):
            fail(f"11d: {k} differs after the 2x2 -> 1x1 load")
    vocab = singles["meanpool"][0].vocab
    payloads = p11_payloads(np, tr.cfg, P11_REQUESTS, seed=P11_SEED + 2)
    e1 = InferenceEngine(p11_cfg("msrvtt_serve_beam5", "meanpool"),
                         checkpoint=path, vocab=vocab, device=DEVICE)
    e2 = InferenceEngine(p11_cfg("msrvtt_serve_tp2", "meanpool"),
                         checkpoint=path, vocab=vocab,
                         devices=mesh_devices(torch, P11_M))
    got1 = p11_slot_run(torch, e1, payloads, counted)[0]
    got2 = p11_slot_run(torch, e2, payloads, counted)[0]
    hold_same_served(got1, got2, P11_SCORE_RTOL,
                     "11d the 2x2 checkpoint served on 1x1 and 1x2")
    log(f"11d: the 2x2 checkpoint loads on 1x1 bitwise ({len(full)} "
        f"leaves) and serves 1x2 == 1x1 ({card})")
    return {"leaves": len(full)}


NCCL_CHILD = r"""
import sys, torch
rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
sys.path.insert(0, ".")
import chip_smoke as cs
from cst_captioning_torch.parallel import distributed, make_mesh
from cst_captioning_torch.training import sharded
torch.cuda.set_device(rank)
distributed.ensure_initialized(f"tcp://localhost:{port}", 2, rank,
                               backend="nccl")
cfg, model, batch = cs.nccl_world(torch, rank)
mm = sharded.MeshModel(cfg, make_mesh({"data": 1, "model": 1},
                                      [torch.device("cuda", rank)]), model)
m = sharded.make_mesh_xe_train_step(
    mm, sharded.MeshOptimizer(mm, cfg.train, 10))(*batch, None, 0.0)
torch.save({"loss": float(m["loss"]),
            "params": mm.gathered_state_dict()}, out)
"""


def nccl_world(torch, rank):
    """The model from seed 0 and process ``rank``'s half of one batch
    (``None``: the whole batch) for 11e's data-parallel step."""
    import numpy as np

    from cst_captioning_torch.data import loader as tloader
    from cst_captioning_torch.data.vocab import Vocabulary
    from cst_captioning_torch.models.captioner import model_from_config

    cfg = p11_train_cfg("meanpool", False, "")
    cfg.model.drop_prob = 0.0
    vocab = Vocabulary([f"w{i}" for i in range(V - 4)])
    corpus = make_msrvtt_corpus(np, vocab, cfg, P11_XE_VIDEOS,
                                seed=P11_SEED)
    b = next(iter(tloader.BatchIterator(
        corpus, P11_XE_VIDEOS, cfg.data.seq_per_img, cfg.data.max_frames,
        shuffle=False).epoch(0)))
    dev = torch.device("cuda", 0 if rank is None else rank)
    b = tloader.to_device(b, dev)
    if rank is not None:
        h = P11_XE_VIDEOS // 2
        sl = slice(rank * h, (rank + 1) * h)
        b = b._replace(feats={k: v[sl] for k, v in b.feats.items()},
                       feat_masks={k: v[sl] for k, v in b.feat_masks.items()},
                       captions=b.captions[sl], weights=b.weights[sl],
                       video_idx=b.video_idx[sl])
    model = model_from_config(cfg, device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    batch = (b.feats, b.feat_masks, b.captions, torch.ones_like(b.weights),
             None, b.video_idx)
    return cfg, model.to(dev), batch


def check_multi_card(torch, card: str, tmp: str):
    """Phase 11e: only with two cards or more — one data-parallel XE step
    over two NCCL processes against the single-controller (2, 1) mesh on
    the same two cards."""
    import socket

    from cst_captioning_torch.parallel import make_mesh
    from cst_captioning_torch.training import sharded

    n = torch.cuda.device_count() if DEVICE == "cuda" else 0
    if n < 2:
        log(f"11e: not run — this host has {n} card(s); the multi-card "
            "checks need two")
        return {"ran": False, "cards": n}
    cfg, model, batch = nccl_world(torch, None)
    mm = sharded.MeshModel(cfg, make_mesh(
        {"data": 2, "model": 1},
        [torch.device("cuda", 0), torch.device("cuda", 1)]), model)
    m = sharded.make_mesh_xe_train_step(
        mm, sharded.MeshOptimizer(mm, cfg.train, 10))(*batch, None, 0.0)
    want = mm.gathered_state_dict()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    outs = [os.path.join(tmp, f"nccl{r}.pt") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, "-c", NCCL_CHILD, str(r),
                               port, outs[r]], cwd=REPO_DIR)
             for r in range(2)]
    for p in procs:
        if p.wait(timeout=600) != 0:
            fail("11e: an NCCL process failed")
    for r in range(2):
        got = torch.load(outs[r], weights_only=False)
        if abs(got["loss"] - float(m["loss"])) > P11_LOSS_RTOL * abs(
                float(m["loss"])):
            fail(f"11e: rank {r} loss {got['loss']} vs {float(m['loss'])}")
        hold_params(want, got["params"], f"11e NCCL rank {r} vs the mesh")
    log(f"11e: two NCCL processes == the (2, 1) mesh on cards 0, 1 ({card})")
    return {"ran": True, "cards": n}


def check_multi_gpu(torch, card: str, tmp: str, counted):
    """Phase 11 (see the module docstring)."""
    t0 = time.perf_counter()
    serve_counted = {k: counted[k] for k in ("row_gemm",
                                             "fused_context_attention")}
    a = check_tp_serving(torch, card, serve_counted)
    singles = a.pop("singles")
    b = check_tp_grid(torch, card, singles, serve_counted)
    train_counted = {k: counted[k] for k in (
        "lstm_recurrence", "attlstm_recurrence", "attlstm_recurrence_bwd")}
    c = check_mesh_training(torch, card, train_counted, tmp)
    d = check_mesh_checkpoint(torch, card, c.pop("trainer"), singles,
                              serve_counted, tmp)
    e = check_multi_card(torch, card, tmp)
    wall = time.perf_counter() - t0
    log(f"phase 11 (multi-GPU) took {wall:.1f} s")
    return {"a": a, "b": b, "c": c, "d": d, "e": e, "wall_s": wall}


def add_phase11_readings(kernels, p11):
    """Phase 11's launches (11a's per case, 11c's per trainer) on the
    entries of the kernels they ran, and its timings on ``row_gemm``'s
    (the TP decode step) and ``lstm_recurrence``'s (the 2D step)."""
    by = {k["name"]: k for k in kernels}
    a, c = p11["a"], p11["c"]
    for what, got in a["launches"].items():
        for name, n in got.items():
            base = name[:-6] if name.endswith("_quant") else name
            if base in by:
                by[base].setdefault("phase11_launches", {})[
                    what + (" quant" if name != base else "")] = n
    for key in ("meanpool_launches_mesh", "attention_launches_mesh",
                "meanpool_launches_one", "attention_launches_one"):
        for name, n in c[key].items():
            by[name].setdefault("phase11_launches", {})[f"11c {key}"] = n
    by["lstm_recurrence"]["phase11_launches"]["11c cst"] = c[
        "cst_launches"].get("lstm_recurrence", 0)
    by["row_gemm"]["phase11"] = {
        "tp_ms_per_decode_step_vs_one_device": a["ms_per_step"],
        "tp_ladder_caption_match": a["ladder_match"],
        "grid_11b": p11["b"], "multi_card_11e": p11["e"],
        "wall_s": p11["wall_s"]}
    by["lstm_recurrence"]["phase11"] = {
        "xe_step_ms_2x2_vs_one_device_f32": {
            f: c[f"{f}_step_ms"] for f in ("meanpool", "attention")},
        "xe_step_ms_2x2_vs_one_device_bf16": c["bf16_step_ms"],
        "param_worst_ratio": {f: c[f"{f}_param_worst"]
                              for f in ("meanpool", "attention")},
        "cst_step_ms_2x2_vs_one_device": c["cst_step_ms"],
        "cst_param_worst_ratio": c["cst_param_worst"]}


# ------------------------------------------------------------ phase 12

P12_REQUESTS = 48        # requests through 12b's two-replica ReplicaSet


def check_analysis() -> dict:
    """Phase 12a: the port's invariant engine over its own source, in a
    subprocess on this host's Python (the engine imports neither torch
    nor the kernels): exit 0 and zero unsuppressed findings."""
    from cst_captioning_torch.analysis import validate_report

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "cst_captioning_torch.analysis", "--json"],
        capture_output=True, text=True, timeout=300, cwd=REPO_DIR)
    wall = time.perf_counter() - t0
    try:
        rec = validate_report(json.loads(proc.stdout))
    except ValueError as e:
        fail(f"12a: the analysis CLI printed no valid report ({e}); exit "
             f"{proc.returncode}, stderr {proc.stderr[-2000:]}")
    if proc.returncode != 0 or rec["findings"]:
        fail(f"12a: python -m cst_captioning_torch.analysis exited "
             f"{proc.returncode} with findings {rec['findings'][:5]}")
    if len(rec["rules_run"]) != 13 or set(rec["family_s"]) != set(
            rec["rules_run"]):
        fail(f"12a: the engine ran {rec['rules_run']}, not the thirteen "
             "families")
    log(f"12a: python -m cst_captioning_torch.analysis --json: exit 0, 0 "
        f"findings, {len(rec['suppressed'])} suppressed, "
        f"{rec['files_scanned']} files, {rec['duration_s']} s in the "
        f"engine ({rec['family_s']}), {wall:.2f} s with the interpreter")
    return {"exit": proc.returncode, "findings": 0,
            "suppressed": len(rec["suppressed"]),
            "files": rec["files_scanned"], "engine_s": rec["duration_s"],
            "family_s": rec["family_s"], "subprocess_s": wall}


def check_lockwatch(torch, card: str, counted) -> dict:
    """Phase 12b (see the module docstring).  ``counted``: the wrappers
    whose launches the run holds, [fused_context_attention, row_dot]."""
    import numpy as np

    from cst_captioning_torch.analysis.lockwatch import LockWatch
    from cst_captioning_torch.config import get_preset
    from cst_captioning_torch.data.vocab import Vocabulary
    from cst_captioning_torch.models.captioner import model_from_config

    vocab = Vocabulary([f"w{i}" for i in range(V - 4)])
    base = get_preset("msrvtt_serve_beam5")
    base.model.vocab_size = len(vocab)
    base.model.feature_fusion = "attention"
    model = model_from_config(base, device="cpu")
    model.init_weights(torch.Generator().manual_seed(base.train.seed))
    params = {k: v.clone() for k, v in model.state_dict().items()}
    del model
    _, bodies = make_bodies(np, base, P12_REQUESTS, seed=29)
    n = len(bodies)

    def kill(server):
        t0 = time.perf_counter()
        dec0 = server.batcher.replicas[0].decoder
        while not dec0.occupied:
            if time.perf_counter() - t0 > 60:
                fail("12b: replica 0 never held a request")
            time.sleep(0.0005)
        server.batcher.kill_replica(0)

    what = "12b LockWatch over the ReplicaSet, attention greedy f32"
    watch = LockWatch()
    with tempfile.TemporaryDirectory() as tmp:
        cfg = replica_cfg("greedy", "attention", True, tmp,
                          "--serving.replicas", "2")
        cfg.serving.warmup = False
        t0 = time.perf_counter()
        with watch.patched():
            r, eng = serve_continuous(torch, cfg, params, vocab, bodies,
                                      list(range(n)), counted, during=kill,
                                      stagger=False)
        wall = time.perf_counter() - t0
    check_responses(r["out"], n, eng.cfg.eval.max_decode_len, what)
    launches = hold_replica_run(r, "attention", what, "ReplicaSet", 2)
    del eng
    requeues = metric_value(r["metrics"], "caption_requeues_total")
    nodes, edges = watch.graph_size()
    acquired = sum(watch.acquisitions.values())
    cycles = watch.cycles()
    log(f"{what}: {n} answered in {r['wall']:.3f} s ({wall:.1f} s with "
        f"the boot), caption_requeues_total {requeues}, healthz "
        f"{r['health'].get('replicas')}; launches {launches}; lock graph "
        f"{nodes} nodes, {edges} edges, {acquired} acquisitions, "
        f"{len(cycles)} cycles  [{card}]")
    if cycles:
        fail(f"{what}: lock-order inversion under traffic: {cycles[:3]}")
    if requeues < 1 or r["health"].get("replicas") != {"healthy": 1,
                                                       "total": 2}:
        fail(f"{what}: the kill did not requeue onto the survivor")
    if not edges or not acquired:
        fail(f"{what}: no nested lock acquisitions were recorded")
    return {"requests": n, "requeues": requeues, "launches": launches,
            "lock_nodes": nodes, "lock_edges": edges,
            "acquisitions": acquired, "wall_s": wall}


def check_kernel_registry(card: str) -> dict:
    """Phase 12c: the kernel-site registry (``analysis/jit_registry.py``)
    against this process, after every earlier phase: the kernels its
    load sites name are ``_build.SOURCES``' and every one of them has
    been loaded, and the compilers this process started stay within the
    registry's budget (one nvcc per kernel and build directory)."""
    from cst_captioning_torch.analysis import jit_registry as jr
    from cst_captioning_torch.ops import _build

    named = set(jr.kernel_names())
    if named != set(_build.SOURCES):
        fail(f"12c: the registry's kernel sites name {sorted(named)}, the "
             f"build knows {sorted(_build.SOURCES)}")
    unloaded = sorted(named - set(_build.LOADED_FROM))
    if unloaded:
        fail(f"12c: kernels {unloaded} were never loaded by phases 1-12b")
    budget = jr.nvcc_budget()
    if _build.nvcc_runs > budget:
        fail(f"12c: this process ran nvcc {_build.nvcc_runs} times, over "
             f"the registry's budget of {budget}")
    foreign = {k: p for k, p in _build.LOADED_FROM.items()
               if p != _build.library_path(k)}
    if foreign:
        fail(f"12c: libraries loaded from outside the build directory: "
             f"{foreign}")
    log(f"12c: {len(jr.JIT_SITE_REGISTRY)} registry entries, "
        f"{len(named)} kernels = _build.SOURCES, all loaded from "
        f"_kernels_build, nvcc runs {_build.nvcc_runs} (budget {budget})  "
        f"[{card}]")
    return {"kernels": sorted(named), "nvcc_runs": _build.nvcc_runs,
            "nvcc_budget": budget, "loaded": len(_build.LOADED_FROM)}


def check_proven_dtypes(torch, card: str) -> dict:
    """Phase 12d: the functions whose result dtype the type flow
    (``analysis/typeflow.py``, stdlib ``ast`` only) proves, run once on
    the card in bf16 on a random-init ``msrvtt_serve_beam5`` model at
    full width: each proof is taken under the live arguments' dtypes and
    must equal the live result's.  The decode step: the vocab product
    (``row_dot``), its logits (``decode_logits``: ``row_dot`` plus the
    float32 bias, then ``mask_decode_logits``), the greedy pick's token
    ids and log-probs, the beam log-softmax and the threefry draw; the
    XE loss (``weighted_cross_entropy``, which ``xe_loss`` returns) and
    the PG loss; then the update step on bf16 leaves
    (:func:`bf16_update_rows`)."""
    import ast
    from pathlib import Path

    from cst_captioning_torch.analysis import typeflow as tfl
    from cst_captioning_torch.analysis.astutil import (
        PackageIndex,
        scan_package,
    )
    from cst_captioning_torch.analysis.engine import CheckContext
    from cst_captioning_torch.config import get_preset
    from cst_captioning_torch.constants import BOS_ID, PAD_ID
    from cst_captioning_torch.decoding.core import (
        beam_log_softmax,
        greedy_pick,
    )
    from cst_captioning_torch.models.captioner import model_from_config
    from cst_captioning_torch.ops.losses import weighted_cross_entropy
    from cst_captioning_torch.ops.rowgemm import row_dot
    from cst_captioning_torch.ops.threefry import threefry_sample
    from cst_captioning_torch.training.cst import pg_loss
    from cst_captioning_torch.training.steps import xe_loss

    t0 = time.perf_counter()
    root = Path(REPO_DIR) / "cst_captioning_torch"
    mods = [m for m in scan_package(root)
            if not m.rel.startswith("analysis/")]
    flow = tfl.TypeFlow(mods, CheckContext(
        index=PackageIndex(mods), package_root=root, docs_root=None))
    lattice = {getattr(torch, n): el for n, el in tfl.TORCH_DTYPES.items()}

    def av(t):
        return tfl.tensor(lattice[t.dtype], zero=t.dim() == 0)

    cfg = get_preset("msrvtt_serve_beam5")
    cfg.model.vocab_size = V
    cfg.model.compute_dtype = "bfloat16"
    model = model_from_config(cfg, device=DEVICE)
    model.init_weights(torch.Generator().manual_seed(cfg.train.seed))
    cdt = model.compute_dtype
    d = cfg.data
    gen = torch.Generator(device=DEVICE).manual_seed(12)
    feats = {m: torch.randn((B, d.max_frames, d.feature_dims[m]),
                            generator=gen, device=DEVICE)
             for m in d.feature_modalities}
    masks = {m: torch.ones((B, d.max_frames), device=DEVICE) for m in feats}
    cat = (torch.zeros((B,), dtype=torch.int64, device=DEVICE)
           if model.use_category else None)
    S, L = 2, 16
    caps = torch.randint(4, V, (B, S, L), generator=gen, device=DEVICE)
    weights = torch.ones((B, S), device=DEVICE)
    rows = []

    def hold(what, proven, live, composed=False):
        rows.append((what, proven, lattice[live.dtype],
                     "composed" if composed else "proven"))

    with torch.no_grad():
        state, cache = model.init_decode(feats, masks, cat)
        tokens = torch.full((B,), BOS_ID, dtype=torch.int64, device=DEVICE)
        state, logits = model.decode_logits(state, cache, tokens)
        h = state.h[-1]
        w = model.logit_w.detach().to(cdt)
        vocab = row_dot(h, w, cdt)
        p_vocab = flow.prove("ops/rowgemm.py::row_dot",
                             [av(h), av(w), tfl.PY])
        hold("row_dot(bf16 h, bf16 logit_w)", p_vocab.dtype, vocab)
        p_logits = flow.prove(
            "models/captioner.py::CaptionModel.mask_decode_logits",
            [tfl.binop_value(ast.Add(), p_vocab,
                             av(model.logit_b.detach().float()))])
        hold("decode_logits (bf16 decode step)", p_logits.dtype, logits)
        tok, lp = greedy_pick(logits)
        p_pick = flow.prove("decoding/core.py::greedy_pick", [av(logits)])
        hold("greedy_pick token ids", p_pick.elts[0].dtype, tok)
        hold("greedy_pick log-probs", p_pick.elts[1].dtype, lp)
        hold("beam_log_softmax",
             flow.prove("decoding/core.py::beam_log_softmax",
                        [av(logits)]).dtype, beam_log_softmax(logits))
        scaled = logits.float()
        s_tok, s_lp = threefry_sample(scaled, key=(1, 2))
        p_draw = flow.prove("ops/threefry.py::threefry_sample", [av(scaled)],
                            {"key": tfl.PY})
        hold("threefry_sample tokens", p_draw.elts[0].dtype, s_tok)
        hold("threefry_sample log-probs", p_draw.elts[1].dtype, s_lp)
        flat = caps.reshape(B * S, L)
        inputs, targets = flat[:, :-1], flat[:, 1:]
        tmask = (targets != PAD_ID).float()
        seq_logits = model(feats, masks, inputs, category=cat, repeat=S)
        wflat = weights.reshape(-1)
        loss = weighted_cross_entropy(seq_logits, targets, tmask, wflat)
        p_loss = flow.prove("ops/losses.py::weighted_cross_entropy",
                            [av(seq_logits), av(targets), av(tmask),
                             av(wflat)])
        hold("XE loss (weighted_cross_entropy, bf16 forward)",
             p_loss.dtype, loss)
        hold("xe_loss", p_loss.dtype,
             xe_loss(model, feats, masks, caps, weights, None, 0.0, cat))
        adv = torch.randn((B * S,), generator=gen, device=DEVICE)
        hold("pg_loss", flow.prove("training/cst.py::pg_loss").dtype,
             pg_loss(model, feats, masks, S, targets, tmask, adv, 1.0,
                     False, cat))
    bf16_update_rows(torch, flow, av, hold, cfg, feats, masks, caps,
                     weights, cat)
    wall = time.perf_counter() - t0
    bad = [r for r in rows if r[1] != r[2]]
    for what, expect, live, kind in rows:
        log(f"12d: {what}: {kind} {expect}, live {live}")
    if bad:
        fail(f"12d: proven or composed dtypes differ from the live ones: "
             f"{bad}")
    proven = sum(r[3] == "proven" for r in rows)
    log(f"12d: {proven} proven result dtypes and {len(rows) - proven} "
        f"composed ones equal the live ones on the bf16 model, "
        f"{wall:.1f} s  [{card}]")
    return {"held": proven, "composed": len(rows) - proven,
            "rows": [list(r) for r in rows], "wall_s": wall}


def bf16_update_rows(torch, flow, av, hold, cfg, feats, masks, caps,
                     weights, cat) -> None:
    """12d's rows of the update step on bf16 leaves
    (``model.param_dtype = bfloat16``), one XE step's gradients at full
    width.  Proven under the live dtypes: the clip, and the Adam and
    RMSprop directions (the leaf dtype).  Composed, not proven (the flow
    follows no loop over a dict of named tensors, so it cannot prove
    ``global_norm`` or ``Optimizer.step``): the step's returned norm and
    a leaf after the in-place ``p + lr * u``, each built from the leaf
    dtype with the type flow's own promotion and held against the live
    dtype as a reading."""
    import ast
    import copy

    from cst_captioning_torch.analysis import typeflow as tfl
    from cst_captioning_torch.models.captioner import model_from_config
    from cst_captioning_torch.training import steps as st

    c16 = copy.deepcopy(cfg)
    c16.model.param_dtype = "bfloat16"
    model = model_from_config(c16, device=DEVICE)
    model.init_weights(torch.Generator().manual_seed(c16.train.seed))
    names, params = zip(*model.named_parameters())
    loss = st.xe_loss(model, feats, masks, caps, weights, None, 0.0, cat)
    grads = dict(zip(names, torch.autograd.grad(loss, params)))
    opt = st.make_optimizer(c16.train, 1, dict(model.named_parameters()))
    g, p = grads["logit_w"], model.logit_w
    with torch.no_grad():
        mu, nu = torch.zeros_like(p), torch.zeros_like(p)
        clip = max(float(c16.train.grad_clip), 1e-3)
        gnorm = st.global_norm(grads)
        hold("clip_leaf (bf16 gradient, bf16 norm)",
             flow.prove("training/steps.py::clip_leaf",
                        [av(g), av(gnorm), tfl.PY]).dtype,
             st.clip_leaf(g, gnorm, clip))
        u = st.adam_direction(g, mu, nu, 1, c16.train.beta1,
                              c16.train.beta2, c16.train.epsilon)
        p_u = flow.prove("training/steps.py::adam_direction",
                         [av(g), av(mu), av(nu)] + [tfl.PY] * 4)
        hold("adam_direction (bf16 leaf)", p_u.dtype, u)
        hold("rmsprop_direction (bf16 leaf)",
             flow.prove("training/steps.py::rmsprop_direction",
                        [av(g), av(nu)]).dtype,
             st.rmsprop_direction(g, nu.clone()))
        live_norm = opt.step(grads)
    # global_norm rounds each leaf's float32 sum into the leaf's dtype,
    # then adds; Optimizer.step rounds lr to u's dtype, then p + lr * u.
    leaf_sum = tfl.tensor(av(g).dtype, zero=True)
    hold("Optimizer.step's norm (leaf sums rounded, added)",
         tfl.binop_value(ast.Add(), leaf_sum, leaf_sum).dtype, live_norm,
         composed=True)
    lr = tfl.tensor(p_u.dtype, zero=True)
    hold("a leaf after Optimizer.step (p + lr * u in place)",
         tfl.binop_value(ast.Add(), av(p.detach()), tfl.binop_value(
             ast.Mult(), lr, p_u)).dtype, model.logit_w.detach(),
         composed=True)


def check_phase12(torch, card: str, counted) -> dict:
    """Phase 12: 12a, 12b, 12c, then 12d."""
    t0 = time.perf_counter()
    out = {"a": check_analysis(), "b": check_lockwatch(torch, card,
                                                         counted)}
    out["c"] = check_kernel_registry(card)
    out["d"] = check_proven_dtypes(torch, card)
    out["wall_s"] = time.perf_counter() - t0
    log(f"phase 12 (invariant engine, lock-order twin, kernel registry, "
        f"proven dtypes) took {out['wall_s']:.1f} s  [{card}]")
    return out


def add_phase12_readings(kernels, p12):
    """12b's launches on the entries of the kernels it ran, and the
    phase's readings on ``row_gemm``'s."""
    by = {k["name"]: k for k in kernels}
    b = p12["b"]
    for name, key in (("row_gemm", "row_dot"),
                      ("fused_context_attention",
                       "fused_context_attention")):
        by[name]["phase12_launches"] = b["launches"][key]
    by["row_gemm"]["phase12"] = {
        "analysis": p12["a"],
        "kernel_registry": p12["c"],
        "proven_dtypes": {k: p12["d"][k] for k in ("held", "composed",
                                                   "wall_s")},
        "lockwatch": {k: b[k] for k in ("requests", "requeues",
                                         "lock_nodes", "lock_edges",
                                         "acquisitions", "wall_s")},
        "wall_s": p12["wall_s"]}


# ------------------------------------------------------------ phase 13

P13_VIDEOS = 64          # one msrvtt_* batch (batch_size 64, 20 captions)
P13_SEED = 13
P13_XE_STEPS = 3
P13_REQUESTS = 16
# Kernel vs plain on bf16 leaves, each step from the same leaves before
# the update: the XE loss within one bf16 ulp (relative), and each leaf's
# gradient within P13_GRAD_GAP of the plain one (|g_k - g_p| / |g_p| per
# leaf, widened to float32).  The leaves after an update are not compared
# element by element: Adam moves each element by about lr whatever the
# gradient is, so that comparison passes any backward kernel.  The gap's
# tier is set from H100 readings (PERF.md): sound runs 0 (meanpool) and
# at most 2.33e-3 (attention, word_embed); a copy whose backward kernel's
# outputs were faulted 1.02e-2 (dv x 1.01), 1.03e-2 (dvals x 1.01),
# 2.74e-2 (the last step's dgx zeroed) and 6.04e-3 (dgx x 1.001).
P13_LOSS_RTOL = 2.0 ** -8
P13_GRAD_GAP = 5e-3
P13_BYTES_RATIO = (0.49, 0.51)   # 16-bit / f32 leaves + Adam moments
P13_LEAF_DTYPES = ("bfloat16", "float16")
# The optimizer that updates float16 leaves here.  Adam on them follows
# optax bitwise into non-finite leaves: optax rounds eps = 1e-8 into the
# leaf dtype, 0 in float16, so an element with a zero gradient (a word
# absent from the batch) updates by 0 / 0 and one whose g^2 (1 - b2)
# underflows by m / 0 (tests/test_torch_param_dtype.py holds the port to
# the reference's NaN and inf elements).  SGD's update stays finite.
P13_F16_OPTIMIZER = "sgd"
# 13b holds float16 leaves' gradients of P13_F16_GRAD_SCALE x the loss.
# word_embed's gradients (about 1e-6) are float16 subnormals, whose
# quantum of 2^-24 leaves them a few bits: there the kernels' summation
# order (the 2.33e-3 that bf16 leaves read) reads 5.8e-3 of the norm
# (measured on one H100; reported each step as the unscaled gap).  A power of
# two is exact through every product and sum of the step and lifts them
# into float16's normal range, so the scaled gap holds the kernels at
# P13_GRAD_GAP as on bf16 leaves; the update takes the unscaled ones.
P13_F16_GRAD_SCALE = 2.0 ** 10


def p13_cfg(preset: str, fusion: str = "meanpool", pdt: str = "bfloat16",
            cdt=None, update: bool = True):
    """``preset`` at full width (V = 10,496) with ``fusion``,
    ``model.param_dtype = pdt`` and ``model.compute_dtype = cdt`` (None:
    the preset's); the CST reward scored inline.  With ``update``,
    float16 leaves take P13_F16_OPTIMIZER."""
    from cst_captioning_torch.config import get_preset

    cfg = get_preset(preset)
    cfg.model.vocab_size = V
    cfg.model.feature_fusion = fusion
    cfg.model.param_dtype = pdt
    if cdt is not None:
        cfg.model.compute_dtype = cdt
    if update and pdt == "float16":
        cfg.train.optimizer = P13_F16_OPTIMIZER
    cfg.train.reward_workers = 0
    return cfg


def p13_model(torch, cfg, state=None):
    """The model of ``cfg`` on the card (random init from P13_SEED, or
    ``state``) and a fresh Adam over it."""
    from cst_captioning_torch.models.captioner import model_from_config
    from cst_captioning_torch.training.steps import make_optimizer

    model = model_from_config(cfg, device=DEVICE)
    if state is None:
        model.init_weights(torch.Generator().manual_seed(P13_SEED))
    else:
        model.load_state_dict(state)
    return model, make_optimizer(cfg.train, 1,
                                 dict(model.named_parameters()))


def hold_leaves(model, optimizer, what: str, pdt: str = "bfloat16") -> None:
    """Every leaf, and every optimizer moment, in ``pdt``."""
    leaves = {str(p.dtype) for p in model.parameters()}
    moments = {str(m.dtype) for d in (optimizer.mu, optimizer.nu)
               for m in d.values()}
    if leaves != {f"torch.{pdt}"} or moments - {f"torch.{pdt}"}:
        fail(f"{what}: leaves {leaves}, moments {moments}")


def check_p13_bytes(torch, card: str, pdt: str = "bfloat16") -> dict:
    """13a: device bytes of the leaves plus Adam moments, float32 against
    ``pdt`` leaves (``torch.cuda.memory_allocated`` around the build)."""
    out = {}
    for dt in ("float32", pdt):
        torch.cuda.synchronize()
        m0 = torch.cuda.memory_allocated()
        model, opt = p13_model(torch, p13_cfg("msrvtt_resnet_c3d_xe",
                                              pdt=dt, update=False))
        torch.cuda.synchronize()
        used = torch.cuda.memory_allocated() - m0
        n = sum(p.numel() for p in model.parameters())
        if dt == pdt:
            hold_leaves(model, opt, "13a", pdt)
        item = 4 if dt == "float32" else 2
        out[dt] = {"bytes": used, "params": n,
                   "closed_form_bytes": 3 * n * item}
        log(f"13a: {dt} leaves + Adam moments: {used / 1e6:.3f} MB on the "
            f"card ({n} parameters; closed form 3 x {item} B x n = "
            f"{3 * n * item / 1e6:.3f} MB)  [{card}]")
        del model, opt
    ratio = out[pdt]["bytes"] / out["float32"]["bytes"]
    out["ratio"] = ratio
    log(f"13a: {pdt} / f32 state bytes {ratio:.4f}")
    if not P13_BYTES_RATIO[0] <= ratio <= P13_BYTES_RATIO[1]:
        fail(f"13a: {pdt} / f32 state bytes {ratio:.4f} outside "
             f"{P13_BYTES_RATIO}")
    return out


def p13_batch(torch, cfg):
    """P13_VIDEOS generated MSR-VTT-width videos (``make_msrvtt_corpus``)
    and their one batch on the card."""
    import numpy as np

    from cst_captioning_torch.data.loader import BatchIterator, to_device
    from cst_captioning_torch.data.vocab import Vocabulary

    vocab = Vocabulary([f"w{i}" for i in range(V - 4)])
    ds = make_msrvtt_corpus(np, vocab, cfg, P13_VIDEOS, seed=P13_SEED)
    d = cfg.data
    it = BatchIterator(ds, batch_size=d.batch_size, seq_per_img=d.seq_per_img,
                       max_frames=d.max_frames, shuffle=False)
    return vocab, ds, to_device(next(iter(it.epoch(0))), torch.device(DEVICE))


def p13_grads(torch, model, batch, scale: float = 1.0):
    """(loss, {name: gradient}) of one XE step on ``model``'s leaves, no
    dropout (``make_xe_train_step``'s loss and gradients); with
    ``scale`` (a power of two) the gradients of ``scale * loss``."""
    from cst_captioning_torch.training.steps import xe_loss

    names, params = zip(*model.named_parameters())
    loss = xe_loss(model, batch.feats, batch.feat_masks, batch.captions,
                   batch.weights, None, 0.0, None)
    grads = torch.autograd.grad(loss * scale if scale != 1.0 else loss,
                                params)
    return loss.detach(), dict(zip(names, grads))


def leaf_gaps(torch, got, want) -> dict:
    """|got - want| / |want| for each named gradient, widened to
    float32 (0 where both are zero)."""
    out = {}
    for k, b in want.items():
        a, b = got[k].float(), b.float()
        num, den = float(torch.linalg.vector_norm(a - b)), float(
            torch.linalg.vector_norm(b))
        out[k] = num / den if den > 0 else (0.0 if num == 0 else math.inf)
    return out


def p13_xe(torch, card: str, cfg, batch, counted, swap, steps: int,
           tag: str = "13b", loss_rtol: float = P13_LOSS_RTOL,
           scale=None, gap_tier: float = P13_GRAD_GAP):
    """13b (and 14b's XE and WXE steps, ``tag``): ``steps`` XE steps on
    ``cfg``'s leaves and compute dtype.  Before each update the loss and
    gradients through the kernels are held against those with ``swap``
    (captioner attribute, plain autograd function) in place of the
    recurrence, on the same leaves (the loss within ``loss_rtol``); then
    the port's optimizer applies the kernels' gradients, and every leaf
    must stay finite.  The held gradients are those of ``scale`` x the
    loss (None: P13_F16_GRAD_SCALE on float16 leaves, else 1), within
    ``gap_tier``, the unscaled gap reported beside.  The kernels' gradients and update are
    timed with CUDA events; the launches are counted without zeroing the
    counts.  Returns the readings and the model and optimizer."""
    from cst_captioning_torch.models import captioner

    mk, ok = p13_model(torch, cfg)
    fusion = cfg.model.feature_fusion
    pdt = cfg.model.param_dtype
    launches = {n: 0 for n in counted}
    ms, rtols, gaps, unscaled = [], [], [], []
    if scale is None:
        scale = P13_F16_GRAD_SCALE if pdt == "float16" else 1.0
    for i in range(steps):
        with swapped(captioner, *swap):
            lp, gp = p13_grads(torch, mk, batch, scale)
        if scale != 1.0:
            _, gks = p13_grads(torch, mk, batch, scale)
            with swapped(captioner, *swap):
                _, gpu = p13_grads(torch, mk, batch)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        before = counts(counted)
        ev[0].record()
        lk, gk = p13_grads(torch, mk, batch)
        gnorm = ok.step(gk)
        ev[1].record()
        torch.cuda.synchronize()
        for n, c in counts(counted).items():
            if n in launches:
                launches[n] += c - before[n]
        ms.append(ev[0].elapsed_time(ev[1]))
        lk, lp = float(lk), float(lp)
        rtols.append(abs(lk - lp) / abs(lp))
        gap = leaf_gaps(torch, gks if scale != 1.0 else gk, gp)
        top = sorted(gap, key=gap.get, reverse=True)[:4]
        gaps.append(gap[top[0]])
        if scale != 1.0:
            raw = leaf_gaps(torch, gk, gpu)
            worst = max(raw, key=raw.get)
            unscaled.append(raw[worst])
            log(f"{tag} {fusion} {pdt} leaves XE step {i}: the unscaled "
                f"gradients' gap (reported) worst {worst} {raw[worst]:.3e}; "
                f"the gap below holds the gradients of "
                f"{scale:g} x the loss")
        if gnorm.dtype != getattr(torch, pdt):
            fail(f"{tag} {fusion}: grad norm {gnorm.dtype}")
        if not all(bool(torch.isfinite(p).all()) for p in mk.parameters()):
            fail(f"{tag} {fusion}: a {pdt} leaf is not finite after the "
                 "update")
        log(f"{tag} {fusion} {pdt} leaves, {mk.compute_dtype} compute, XE "
            f"step {i}: loss kernel {lk:.6f} plain {lp:.6f} "
            f"(rtol {rtols[-1]:.3e}), gradient gap per leaf worst "
            f"{', '.join(f'{k} {gap[k]:.3e}' for k in top)}; grad norm "
            f"{float(gnorm):.4f}, grads + update {ms[-1]:.3f} ms  [{card}]")
    hold_leaves(mk, ok, f"{tag} {fusion}", pdt)
    log(f"{tag} {fusion} {pdt} leaves: {steps} steps, loss rtol worst "
        f"{max(rtols):.3e} "
        f"(tier {loss_rtol:.3e}), gradient gap worst {max(gaps):.3e} "
        f"(tier {gap_tier:.1e}); launches {launches}")
    if max(rtols) > loss_rtol or max(gaps) > gap_tier:
        fail(f"{tag} {fusion}: kernel vs plain XE gradients on {pdt} "
             "leaves outside the tier")
    if min(launches.values()) < 1:
        fail(f"{tag} {fusion}: a kernel of the XE path did not launch: "
             f"{launches}")
    return {"step_ms": ms, "loss_rtol": rtols, "grad_gap": gaps,
            "grad_gap_unscaled": unscaled or None, "grad_scale": scale,
            "launches": launches}, mk, ok


def p13_step_ms(torch, step, args, reps: int) -> list:
    """CUDA-event ms of ``reps`` calls of ``step(*args)`` after one
    warm-up call."""
    step(*args)
    out = []
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        step(*args)
        ev[1].record()
        torch.cuda.synchronize()
        out.append(ev[0].elapsed_time(ev[1]))
    return out


def p13_leaf_timings(torch, card: str, batch, corpus) -> dict:
    """XE and CST step ms with float32 leaves against bfloat16 leaves
    (same init, same batch, one call each side in turn)."""
    from cst_captioning_torch.training.cst import make_cst_train_step
    from cst_captioning_torch.training.steps import make_xe_train_step

    out = {}
    xe_args = (batch.feats, batch.feat_masks, batch.captions, batch.weights,
               None, batch.video_idx, None, 0.0)
    for pdt in ("float32", "bfloat16", "float32", "bfloat16"):
        m, o = p13_model(torch, p13_cfg("msrvtt_resnet_c3d_xe", pdt=pdt))
        out.setdefault(f"xe_{pdt}", []).extend(
            p13_step_ms(torch, make_xe_train_step(m, o), xe_args, 2))
        cc = p13_cfg(CST_PRESET, pdt=pdt)
        m, o = p13_model(torch, cc)
        step = make_cst_train_step(m, o, cc, corpus)
        cst_args = (batch.feats, batch.feat_masks, None, None, None,
                    batch.video_idx,
                    torch.Generator(device=DEVICE).manual_seed(P13_SEED),
                    0.0)
        out.setdefault(f"cst_{pdt}", []).extend(
            p13_step_ms(torch, step, cst_args, 1))
        del m, o, step
    for k, v in out.items():
        log(f"13b/c timing: {k} step ms {[round(x, 3) for x in v]}  [{card}]")
    return out


def p13_cst(torch, card: str, model, batch, corpus, counted, sam_mod,
            pdt: str = "bfloat16"):
    """13c: one CST scb step (``msrvtt_cst_ms_scb``) on the ``pdt``-leaf
    model: the fused ``lstm_sample`` rollout and the ``lstm_recurrence``
    PG update; then the greedy decode through ``lstm_sample`` against
    its plain version on the same leaves."""
    from cst_captioning_torch.models import captioner
    from cst_captioning_torch.training.cst import make_cst_train_step
    from cst_captioning_torch.training.steps import make_optimizer

    cfg = p13_cfg(CST_PRESET, pdt=pdt)
    opt = make_optimizer(cfg.train, 1, dict(model.named_parameters()))
    step = make_cst_train_step(model, opt, cfg, corpus)
    zero(counted)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = step(batch.feats, batch.feat_masks, None, None, None,
             batch.video_idx,
             torch.Generator(device=DEVICE).manual_seed(P13_SEED), 0.0)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    launches = counts(counted)
    log(f"13c CST step ({pdt} leaves): loss {float(m['loss']):.5f} grad norm "
        f"{float(m['grad_norm']):.4f} reward {m['reward']:.5f} baseline "
        f"{m['baseline']:.5f}, {wall:.3f} ms wall, launches {launches}  "
        f"[{card}]")
    for k in ("loss", "grad_norm", "reward", "baseline", "advantage"):
        if not math.isfinite(float(m[k])):
            fail(f"13c: non-finite {k}")
    hold_leaves(model, opt, "13c", pdt)
    if launches["lstm_sample"] < 1 or launches["lstm_recurrence"] < 1:
        fail(f"13c: the CST step's kernels did not launch: {launches}")
    with torch.no_grad():
        k = model.sample(batch.feats, batch.feat_masks, max_len=T,
                         greedy=True)
        with swapped(captioner, "lstm_sample", sam_mod.lstm_sample_ref):
            p = model.sample(batch.feats, batch.feat_masks, max_len=T,
                             greedy=True)
    err = bf16_check(f"13c greedy lstm_sample vs plain ({pdt} leaves)",
                     k.tokens, p.tokens, k.logprobs.sum(-1),
                     p.logprobs.sum(-1))
    return {"wall_ms": wall, "launches": launches,
            "reward": float(m["reward"]), "greedy_max_abs_err": err}


def p13_beam(torch, card: str, model, batch, counted, beam_mod,
             pdt: str = "bfloat16"):
    """13d: a beam-5 batch of 64 videos through ``lstm_beam`` against
    its plain version, on the ``pdt`` leaves: every beam at the kernel
    tier.  On float16 leaves only, a match below the floor passes with
    no more beams differing than the plain version differs from itself
    on the hidden-unit-permuted model (the order witness of phases 3c
    and 6a: 16-bit sums in another order flip near-tied beams of a
    random model in the plain version alone), and then at the
    relaxed-serving tier; bfloat16 leaves are held at the kernel floor
    with no witness."""
    from cst_captioning_torch.models import captioner

    zero(counted)
    with torch.no_grad():
        ks, kc = model.fused_beam(batch.feats, batch.feat_masks, beam_size=K,
                                  max_len=T)
        launches = counts(counted)
        with swapped(captioner, "lstm_beam", beam_mod.lstm_beam_ref):
            ps, pc = model.fused_beam(batch.feats, batch.feat_masks,
                                      beam_size=K, max_len=T)
    rows = lambda x: x.reshape(-1, x.shape[-1])  # noqa: E731
    differ = int((rows(ks) != rows(ps)).any(-1).sum())
    floor, witness = KERNEL_BF16_MATCH_FLOOR, None
    if pdt == "float16" and 1.0 - differ / rows(ps).shape[0] < floor:
        with torch.no_grad(), swapped(captioner, "lstm_beam",
                                      beam_mod.lstm_beam_ref):
            ws, _ = permuted_model(torch, model, P13_SEED).fused_beam(
                batch.feats, batch.feat_masks, beam_size=K, max_len=T)
        witness = int((rows(ws) != rows(ps)).any(-1).sum())
        log(f"13d order witness ({pdt} leaves; plain on the H-permuted "
            f"model vs plain): {witness} beams differ, kernel vs plain "
            f"{differ}")
        if witness == 0 or differ > witness:
            fail(f"13d: {differ} beams differ kernel vs plain, the order "
                 f"witness {witness}")
        floor = RELAXED_SERVING_MATCH_FLOOR
    err = bf16_check(f"13d beam-5 lstm_beam vs plain ({pdt} leaves)",
                     rows(ks), rows(ps), kc.reshape(-1), pc.reshape(-1),
                     floor)
    log(f"13d: launches {launches}")
    if launches["lstm_beam"] != 1:
        fail(f"13d: lstm_beam launched {launches['lstm_beam']} times")
    return {"launches": launches, "max_abs_err": err,
            "beams_differing": differ, "witness_differing": witness}


def p13_checkpoint_and_serve(torch, card: str, model, optimizer, vocab,
                             corpus, counted, tmp: str,
                             pdt: str = "bfloat16"):
    """13e: save the ``pdt``-leaf model and its optimizer state, restore
    both into a fresh model bitwise, then serve P13_REQUESTS videos from
    the checkpoint through the slot loop at ``serving.dtype`` bf16 and
    int8w, the kernels' captions against the plain products'."""
    from cst_captioning_torch.models import captioner
    from cst_captioning_torch.ops.rowgemm import row_dot_ref
    from cst_captioning_torch.serving.engine import InferenceEngine
    from cst_captioning_torch.training import checkpoint as ckpt

    leaf = getattr(torch, pdt)
    path = os.path.join(tmp, f"p13_{pdt}")
    ckpt.save_checkpoint(path, model, optimizer, {"epoch": 0})
    other, o2 = p13_model(torch, p13_cfg("msrvtt_resnet_c3d_xe", pdt=pdt))
    ckpt.restore_checkpoint(path, other, o2)
    for mine, theirs, what in ((model.state_dict(), other.state_dict(),
                                "leaves"), (optimizer.mu, o2.mu, "mu"),
                               (optimizer.nu, o2.nu, "nu")):
        for k, v in mine.items():
            if theirs[k].dtype != leaf or not torch.equal(theirs[k], v):
                fail(f"13e: restored {what} {k} differs")
    log(f"13e: checkpoint restored bitwise (leaves and moments in {pdt})")
    del other, o2
    payloads = video_payloads(corpus, range(P13_REQUESTS))
    out = {}
    for dtype in ("bf16", "int8w"):
        cfg = serve_cfg(dtype, continuous=True)
        cfg.model.param_dtype = pdt
        eng = InferenceEngine(cfg, checkpoint=path, vocab=vocab,
                              device=DEVICE)
        leaves = {str(p.dtype) for n, p in eng.model.named_parameters()
                  if not n.endswith("_scale")}
        want = {f"torch.{pdt}"} | ({"torch.int8"} if dtype == "int8w"
                                   else set())
        if leaves != want:
            fail(f"13e {dtype}: engine leaves {leaves}")
        zero(counted)
        served, _, _ = slot_serve(eng, payloads)
        launches = counts(counted)
        with swapped(captioner, "row_dot", row_dot_ref):
            plain, _, _ = slot_serve(eng, payloads)
        kt, pt = served_tensor(torch, served), served_tensor(torch, plain)
        ks = torch.tensor([served[i]["score"] for i in range(len(served))])
        ps = torch.tensor([plain[i]["score"] for i in range(len(plain))])
        # The served tier of 3d: bf16 rounds h every step, so a product
        # summed in cuBLAS's order flips near-ties of a random model.
        err = bf16_check(f"13e slot loop {dtype} on {pdt} leaves, row_gemm "
                         "vs plain", kt, pt, ks, ps,
                         floor=RELAXED_SERVING_MATCH_FLOOR)
        log(f"13e {dtype}: launches {launches}")
        if launches["row_gemm"] < 1 or (
                dtype == "int8w" and launches["row_gemm_quant"] < 1):
            fail(f"13e {dtype}: row_gemm did not launch: {launches}")
        out[dtype] = {"launches": launches, "max_abs_err": err}
        del eng
    return out


def check_param_dtype(torch, card: str, tmp: str, mods,
                      pdt: str = "bfloat16") -> dict:
    """Phase 13: ``model.param_dtype = pdt`` (bfloat16, float16) on the
    card at full width, 13a-13e (see the module docstring); the step ms
    by leaf dtype at bfloat16."""
    t0 = time.perf_counter()
    beam_mod, sam_mod, lstm_mod, att_mod, rg_mod = mods
    out = {"a": check_p13_bytes(torch, card, pdt)}
    cfg = p13_cfg("msrvtt_resnet_c3d_xe", pdt=pdt)
    vocab, corpus, batch = p13_batch(torch, cfg)
    out["b"], model, opt = p13_xe(
        torch, card, cfg, batch,
        {"lstm_recurrence": lstm_mod.lstm_recurrence},
        ("lstm_recurrence", plain_recurrence(torch, lstm_mod)), P13_XE_STEPS)
    out["b_attention"], _, _ = p13_xe(
        torch, card, p13_cfg("msrvtt_resnet_c3d_xe", "attention", pdt),
        batch,
        {"attlstm_recurrence": att_mod.attlstm_recurrence,
         "attlstm_recurrence_bwd": att_mod.attlstm_recurrence_bwd},
        ("attlstm_recurrence", plain_att_recurrence(torch, att_mod)), 1)
    out["e"] = p13_checkpoint_and_serve(
        torch, card, model, opt, vocab, corpus,
        {"row_gemm": rg_mod.row_dot}, tmp, pdt)
    out["c"] = p13_cst(torch, card, model, batch, corpus,
                       {"lstm_sample": sam_mod.lstm_sample,
                        "lstm_recurrence": lstm_mod.lstm_recurrence,
                        "row_gemm": rg_mod.row_dot}, sam_mod, pdt)
    out["d"] = p13_beam(torch, card, model, batch,
                        {"lstm_beam": beam_mod.lstm_beam,
                         "row_gemm": rg_mod.row_dot}, beam_mod, pdt)
    if pdt == "bfloat16":
        out["timings"] = p13_leaf_timings(torch, card, batch, corpus)
    out["wall_s"] = time.perf_counter() - t0
    log(f"phase 13 (param_dtype {pdt}) took {out['wall_s']:.1f} s  "
        f"[{card}]")
    return out


def add_phase13_readings(kernels, p13, pdt: str = "bfloat16"):
    """Phase 13's launches on the entries of the kernels it ran, and its
    readings on ``lstm_recurrence``'s (``pdt`` the leaves' dtype: the
    float16 run's keys say so)."""
    by = {k["name"]: k for k in kernels}
    sfx = "" if pdt == "bfloat16" else f" ({pdt} leaves)"

    def put(name, what, n):
        by[name].setdefault("phase13_launches", {})[what + sfx] = n

    for name, n in p13["b"]["launches"].items():
        put(name, "13b meanpool XE", n)
    for name, n in p13["b_attention"]["launches"].items():
        put(name, "13b attention XE", n)
    for name in ("lstm_sample", "lstm_recurrence", "row_gemm"):
        put(name, "13c CST", p13["c"]["launches"][name])
    for name in ("lstm_beam", "row_gemm"):
        put(name, "13d beam", p13["d"]["launches"][name])
    for dtype in ("bf16", "int8w"):
        put("row_gemm", f"13e slot loop {dtype}",
            p13["e"][dtype]["launches"]["row_gemm"])
    by["lstm_recurrence"]["phase13" + ("" if not sfx else "_" + pdt)] = {
        "state_bytes": p13["a"],
        "xe_step_ms": p13["b"]["step_ms"],
        "xe_loss_rtol_vs_plain": p13["b"]["loss_rtol"],
        "grad_gap_vs_plain": {"meanpool": p13["b"]["grad_gap"],
                              "attention": p13["b_attention"]["grad_gap"]},
        "step_ms_by_leaf_dtype": p13.get("timings"),
        "cst_step_wall_ms": p13["c"]["wall_ms"],
        "wall_s": p13["wall_s"]}


# ------------------------------------------------------------ phase 14

P14_SEED = 14
# float16 compute's tiers.  Each is no looser than the bfloat16 tier of
# the same path; PERF.md gives the readings they were set from.
# The recurrence: one float16 ulp of h below 1 (bf16: one bf16 ulp), and
# the exact-product order witness's 4.27e-5 on c with a margin of 2.3
# (bf16: 2e-4).  The decoders: bf16's match floor (a near-tie may flip a
# caption; 14a read 0.9844 on the beam) and ten times the largest score
# rtol 14a read, 1.89e-5 (bf16: 1e-3).  The XE loss: one float16 ulp.
F16_REC_H_ATOL = 2.0 ** -11
F16_REC_C_RTOL = 1e-4
KERNEL_F16_MATCH_FLOOR = KERNEL_BF16_MATCH_FLOOR
KERNEL_F16_SCORE_RTOL = 2e-4
P14_LOSS_RTOL = 2.0 ** -11
RG_F16_CASES = (("f16_xf32", "float16", "float32"),
                ("f16", "float16", "float16"))
RG_F16_SHAPES = tuple(s for s in RG_SHAPES if s[0] != "query")
F16_TOLERANCE = (
    f"float16 compute: decoders caption match >= {KERNEL_F16_MATCH_FLOOR} "
    f"with score rtol <= {KERNEL_F16_SCORE_RTOL} (beam, greedy, "
    f"multinomial); lstm_recurrence |h diff| <= {F16_REC_H_ATOL:g}, |c "
    f"diff| <= {F16_REC_C_RTOL:g} x max(|c|, 1); row_gemm " + RG_TOLERANCE)


def f16_decoders(torch, beam_mod, sam_mod) -> dict:
    """14a: the meanpool decoders at float16 compute against their plain
    versions at the main shape (B = 64, K = 5; phase 2's inputs, seed 0):
    beam, greedy and multinomial at the float16 kernel tier, the first
    videos alone bitwise the B = 64 call, 3T profiler launches a call;
    the kernel (REPS calls) and the plain version (1 call) timed, the
    multinomial sampler also at the CST rollout's rows."""
    from cst_captioning_torch.decoding.beam import finalize_beams

    fns = decoders(beam_mod, sam_mod, attention=False)
    beam, beam_ref, sample, sample_ref = fns
    a16 = to_card(torch, make_inputs(torch, 0), torch.float16)
    v16 = list(a16.values())
    res = {}
    kb = finalize_beams(*beam(*v16, beam_size=K, max_len=T))
    rb = finalize_beams(*beam_ref(*v16, beam_size=K, max_len=T))
    res["beam_err"] = bf16_check(
        "14a lstm_beam f16", kb.tokens, rb.tokens, kb.score, rb.score,
        KERNEL_F16_MATCH_FLOOR, KERNEL_F16_SCORE_RTOL)
    res["sample_err"] = 0.0
    for greedy, seed in ((True, (0, 0)), (False, (123, 456))):
        kt, kl, _ = sample(*v16, seed, max_len=T, greedy=greedy)
        rt, rl, _ = sample_ref(*v16, seed, max_len=T, greedy=greedy)
        mode = "greedy" if greedy else "multinomial"
        res["sample_err"] = max(res["sample_err"], bf16_check(
            f"14a lstm_sample f16 {mode}", kt, rt, kl.sum(-1), rl.sum(-1),
            KERNEL_F16_MATCH_FLOOR, KERNEL_F16_SCORE_RTOL))
    res["row_invariance"] = row_invariance(torch, fns, a16, "meanpool",
                                           "f16")
    res["launches_per_call"] = decode_breakdowns(torch, beam, sample, v16,
                                                 MEANPOOL_DEC_LAUNCHES, "f16")
    res["beam_ms"] = time_call(
        torch, lambda: beam(*v16, beam_size=K, max_len=T), REPS)
    res["beam_plain_ms"] = time_call(
        torch, lambda: beam_ref(*v16, beam_size=K, max_len=T), 1)
    res["sample_ms"] = time_call(
        torch, lambda: sample(*v16, (0, 0), max_len=T, greedy=True), REPS)
    res["sample_plain_ms"] = time_call(
        torch, lambda: sample_ref(*v16, (0, 0), max_len=T, greedy=True), 1)
    res.update(rollout_times(torch, sample, a16, "f16"))
    log(f"times f16: lstm_beam {res['beam_ms']:.3f} ms (plain "
        f"{res['beam_plain_ms']:.3f} ms), lstm_sample greedy "
        f"{res['sample_ms']:.3f} ms (plain {res['sample_plain_ms']:.3f} ms)")
    return res


def f16_recurrence(torch, lstm_mod, launches=None) -> dict:
    """14a: ``lstm_recurrence`` at float16 compute against its plain
    version at the XE shape (R = 1,280, T = 29, H = 512; phase 2b's
    inputs): h_seq and c_seq at the float16 tiers, the output without the
    cell bitwise the one with it, one profiler launch a call (``launches``:
    phase 2b's count of it; None: counted here), the autograd Function's
    gradients (kernel forward, plain backward) against the all-plain path
    (reported); timed with its plain version and cuDNN's LSTM in float16;
    the exact-product order witness at float16 (reported)."""
    fwd, ref = lstm_mod.lstm_recurrence_fwd, lstm_mod.lstm_recurrence_ref
    gx, wh32, dh = rec_inputs(torch, 11, R_XE, T_XE)
    wh = wh32.to(torch.float16)
    res = {}
    kh, kc = fwd(gx, wh, with_cell=True)
    rh, rc = ref(gx, wh, with_cell=True)
    torch.cuda.synchronize()
    eh = max_diff(kh, rh)
    c_rel = float(((kc - rc).abs() / rc.abs().clamp_min(1.0)).max())
    h_ne = float((kh != rh).float().mean())
    log(f"14a lstm_recurrence f16 R={R_XE} T={T_XE} H={H}: max |h diff| "
        f"{eh:.3e} (share of h differing {h_ne:.2e}), max |c diff| / "
        f"max(|c|, 1) {c_rel:.3e}")
    if kh.dtype != torch.float16 or eh > F16_REC_H_ATOL or (
            c_rel > F16_REC_C_RTOL):
        fail("14a lstm_recurrence float16 outside its tolerance")
    if not torch.equal(fwd(gx, wh, with_cell=False), kh):
        fail("14a lstm_recurrence f16 without the cell output differs")
    res["err"], res["c_rel"], res["h_differing"] = eh, c_rel, h_ne
    gk = gx.clone().requires_grad_()
    wk = wh.clone().requires_grad_()
    lstm_mod.lstm_recurrence(gk, wk).backward(dh)
    dgx, dwh = lstm_mod.lstm_recurrence_bwd(gx, wh, rh, rc, dh)
    torch.cuda.synchronize()
    res["grad_rel"] = {
        "gx": max_diff(gk.grad, dgx) / float(dgx.abs().max()),
        "wh": max_diff(wk.grad, dwh) / float(dwh.float().abs().max())}
    log(f"14a lstm_recurrence f16 gradients, kernel forward vs all-plain "
        f"(reported): {res['grad_rel']}")
    del gk, wk, dgx, dwh
    res["ms"] = time_call(torch, lambda: fwd(gx, wh, with_cell=True), REPS)
    res["ms_nocell"] = time_call(
        torch, lambda: fwd(gx, wh, with_cell=False), REPS)
    res["plain_ms"] = time_call(torch, lambda: ref(gx, wh, with_cell=True), 1)
    res["library_ms"] = time_call(
        torch, cudnn_lstm(torch, gx, wh32, torch.float16), REPS)
    log(f"times f16: lstm_recurrence {res['ms']:.3f} ms with cell, "
        f"{res['ms_nocell']:.3f} ms without (plain {res['plain_ms']:.3f} ms, "
        f"cuDNN LSTM in f16 incl. the identity input GEMM "
        f"{res['library_ms']:.3f} ms)")
    if launches is None:
        rows = profiled(torch, lambda: fwd(gx, wh, with_cell=True), 1,
                        launches=1)
        launches = round(sum(c for k, _, c in rows if "lstm_rec" in k))
    if launches != 1:
        fail(f"14a: one f16 lstm_recurrence call launched its kernel "
             f"{launches} times")
    res["launches_per_call"] = launches
    res["order_witness_c_rel"] = exact_product_witness(torch, lstm_mod, gx,
                                                       wh)
    return res


# The attention kernels at float16 compute (14a), each against its plain
# version on the card at 2c / 2d / 2e / 2g's inputs.  The first H100
# run was held at the bf16 tiers of the same paths (an f16 ulp is an
# eighth of a bf16 one) and read (PERF.md): h 4.883e-4, one f16 ulp at
# |h| < 1, in 9.2% of h, as the exact-product order witness reads too
# (8.7%); the backward's cotangents 0.00 f16 ulps past 2d's allowance,
# the fold 0.00 of the exact fold; ctx 0.94 / 0.98 f16 ulps past 2e's
# allowance (1.00 without: the f32 mix rounded once), the context
# backward 0.00; the decoders' caption match 0.9531 (beam), 0.9844
# (greedy), 0.9945 (multinomial) with score rtol at most 2.72e-5.  So
# the tiers: h one f16 ulp at |h| < 1 (2d's bf16: one bf16 ulp), the
# counts of 2d / 2e / 2g's bf16 tiers in f16 ulps, bf16's attention
# floor and ten times the largest score rtol read (bf16: 1e-3).
F16_ATT_H_ATOL = 5e-4
F16_ATT_BWD_ULPS = ATT_BWD_BF16_ULPS
F16_ATT_FOLD_ULPS = ATT_FOLD_BF16_ULPS
F16_CTX_ULPS = CTX_BF16_ULPS
F16_CTXB_ULPS = CTXB_BF16_ULPS
KERNEL_ATT_F16_MATCH_FLOOR = KERNEL_ATT_BF16_MATCH_FLOOR
F16_ATT_SCORE_RTOL = 3e-4
# 14b's attention steps hold each leaf's gradient of P13_F16_GRAD_SCALE
# x the loss within P14_ATT_GRAD_GAP of the plain path's, tighter than
# 13b's P13_GRAD_GAP: on one H100, float32 leaves at float16 compute
# (``scripts/probe_grad_faults.py --pdt float32 --cdt float16``) read
# 4.2e-4 to 4.4e-4 sound (word_embed), and with the attention backward's
# outputs faulted 1.00e-2 (dv x 1.01), 9.9e-3 (dvals x 1.01), 2.5e-2
# (the last step's dgx zeroed) and 1.50e-3 (dgx x 1.001), which
# P13_GRAD_GAP would pass; 14b's first run read 4.2e-4 (XE), 4.6e-4 (WXE)
# and 6.1e-4 (the per-step loop).  1e-3 sits 1.6x above the worst sound
# reading and 1.5x below the smallest fault.
P14_ATT_GRAD_GAP = 1e-3
F16_ATT_TOLERANCE = (
    f"float16 compute, attention: decoders caption match >= "
    f"{KERNEL_ATT_F16_MATCH_FLOOR} with score rtol <= {F16_ATT_SCORE_RTOL:g} "
    f"(beam, greedy, multinomial at R = {ROLLOUT_ROWS}); attlstm_recurrence "
    f"|h diff| <= {F16_ATT_H_ATOL:g}, backward cotangents within "
    f"{F16_ATT_BWD_ULPS:g} f16 ulps past {ATT_BWD_BF16_ATOL_REL:g} x max, "
    f"per-video d_proj / d_vals within {F16_ATT_FOLD_ULPS:g} f16 ulp of the "
    f"exact fold; fused_context_attention ctx within {F16_CTX_ULPS:g} f16 "
    f"ulps past {CTX_BF16_ATOL_REL:g} x max, weights within "
    f"{CTX_BF16_ATTN_ATOL:g}, backward within {F16_CTXB_ULPS:g} f16 ulps "
    f"past {CTXB_BF16_ATOL_REL:g} x max; rep bitwise the gathered layout")


def ab_ms(torch, calls: dict, timer) -> dict:
    """One round of ``scripts/ab_f16.py``'s turns: ``calls`` maps
    "bf16" / "f16" to a call on that dtype's operands, timed by
    ``timer(fn)`` in the order bf16, f16, f16, bf16; each dtype's mean of
    its two turns (the same call's bf16 beside the f16 reading)."""
    got = {"bf16": [], "f16": []}
    for dt in ("bf16", "f16", "f16", "bf16"):
        got[dt].append(timer(calls[dt]))
    return {dt: sum(v) / len(v) for dt, v in got.items()}


def f16_tanh_check(torch, att_mod) -> dict:
    """The f16 kernels' tanh (``attention_tc.cuh::tanh_direct<__half>``:
    tanhf of the f16-rounded argument, rounded to f16) on all 65,536 f16
    codes against the plain versions' ``ops/attlstm.py::tanh_of`` on the
    card: bitwise, NaN for the 2,046 NaN codes."""
    tt = att_mod.tanh_f16_check(DEVICE)
    x = torch.arange(65536, dtype=torch.int32, device=DEVICE).to(
        torch.int16).view(torch.float16)
    want = att_mod.tanh_of(x, torch.float32)
    torch.cuda.synchronize()
    nan = x.isnan()
    n_bad = int(torch.where(nan, ~(tt.isnan() & want.isnan()),
                            tt.view(torch.int32) != want.view(torch.int32)
                            ).sum())
    log(f"14a f16 tanh (tanhf of the f16 argument, rounded to f16) vs "
        f"tanh_of on the card on all 65,536 f16 codes (bitwise; NaN for the "
        f"{int(nan.sum())} NaN codes): {n_bad} differ")
    if n_bad:
        fail("14a: the f16 kernels' tanh differs from the plain versions'")
    return {"codes": 65536, "differ": n_bad}


def f16_att_recurrence(torch, att_mod) -> dict:
    """14a: ``attlstm_recurrence`` forward and backward at float16
    compute at 2d's shape and inputs (R = 1,280 over 64 videos, rep 20,
    T = 29, F = 56, A = 512): h against the plain forward, the backward's
    cotangents on the plain forward's residuals, rep 20 bitwise rep 1 on
    the repeated tensors, the per-video fold, the order witness
    (reported), the profiler's launches a call (3T - 1, 4T + 3); timed
    beside the same call's bf16 (``ab_ms``) and the plain version."""
    fwd, ref = att_mod.attlstm_recurrence_fwd, att_mod.attlstm_recurrence_ref
    bwd = att_mod.attlstm_recurrence_bwd
    bwd_ref = att_mod.attlstm_recurrence_bwd_ref
    rep, f16 = ATT_REP, torch.float16
    a32, dh = att_rec_inputs(torch, 21, R_XE, T_XE)
    a16 = att_rec_cast(a32, f16)
    dh16 = dh.to(f16)
    res = {}
    kh = fwd(*a16, rep)
    rr16 = ref(*a16, rep, with_residuals=True)
    rh = rr16[0]
    kr = fwd(*a16, rep, with_residuals=True)
    torch.cuda.synchronize()
    res["err"] = max_diff(kh, rh)
    res["share_differing"] = float((kh != rh).float().mean())
    res["c_err"] = max_diff(kr[1], rr16[1])
    res["a_err"] = max_diff(kr[2], rr16[2])
    log(f"14a attlstm_recurrence f16 R={R_XE} ({R_XE // rep} videos x {rep}) "
        f"T={T_XE} F={F_ATT} A={A_ATT}: max |h diff| {res['err']:.3e} (share "
        f"of h differing {res['share_differing']:.2e}), |c diff| "
        f"{res['c_err']:.3e}, |a diff| {res['a_err']:.3e}")
    if (kh.dtype != f16 or not res["err"] <= F16_ATT_H_ATOL
            or not torch.isfinite(kh.float()).all()):
        fail("14a attlstm_recurrence float16 outside its tolerance")
    if not torch.equal(kr[0], kh):
        fail("14a attlstm_recurrence f16 with residuals differs from "
             "without them")
    rows = att_rows(a16, rep)
    if not torch.equal(fwd(*rows, 1), kh):
        fail(f"14a attlstm_recurrence f16 at rep={rep} differs from rep=1 "
             "on the repeated tensors")
    kb = bwd(*a16[:6], a16[7], *rr16, dh16, rep)
    rb = bwd_ref(*a16[:6], a16[7], *rr16, dh16, rep)
    torch.cuda.synchronize()
    ulps = {n: f16_ulps(torch, x, y, ATT_BWD_BF16_ATOL_REL)
            for n, x, y in zip(BWD_NAMES, kb, rb)}
    log("14a attlstm_recurrence_bwd f16, kernel vs plain on the same "
        f"residuals: f16 ulps past {ATT_BWD_BF16_ATOL_REL:g} x max |value|: "
        + ", ".join(f"{n} {v:.2f}" for n, v in ulps.items()))
    if (not max(ulps.values()) <= F16_ATT_BWD_ULPS
            or not all(bool(torch.isfinite(x.float()).all()) for x in kb)):
        fail("14a attlstm_recurrence backward float16 disagrees with its "
             "plain version")
    res["bwd_ulps"] = ulps
    res["bwd_err"] = max(max_diff(x, y) for x, y in zip(kb, rb))
    del kb
    res["fold"] = hold_att_fold(torch, att_mod, a16, rr16, dh16, "f16")
    res["order_witness"] = att_rec_order_witness(torch, att_mod, a16, rr16,
                                                 dh16, rh, rb)
    del rb
    a_bf = att_rec_cast(a32, torch.bfloat16)
    rr_bf = ref(*a_bf, rep, with_residuals=True)
    dh_bf = dh.to(torch.bfloat16)
    timer = lambda fn: time_call(torch, fn, REPS)  # noqa: E731
    t = ab_ms(torch, {
        "bf16": lambda: fwd(*a_bf, rep, with_residuals=True),
        "f16": lambda: fwd(*a16, rep, with_residuals=True)}, timer)
    res["ms"], res["ms_bf16_same_call"] = t["f16"], t["bf16"]
    t = ab_ms(torch, {
        "bf16": lambda: bwd(*a_bf[:6], a_bf[7], *rr_bf, dh_bf, rep),
        "f16": lambda: bwd(*a16[:6], a16[7], *rr16, dh16, rep)}, timer)
    res["bwd_ms"], res["bwd_ms_bf16_same_call"] = t["f16"], t["bf16"]
    del a_bf, rr_bf
    res["plain_ms"] = time_call(
        torch, lambda: ref(*a16, rep, with_residuals=True), 1)
    res["bwd_plain_ms"] = time_call(
        torch, lambda: bwd_ref(*a16[:6], a16[7], *rr16, dh16, rep), 1)
    log(f"times f16: attlstm_recurrence {res['ms']:.3f} ms with residuals "
        f"(the same call's bf16 {res['ms_bf16_same_call']:.3f} ms; plain "
        f"{res['plain_ms']:.3f} ms); backward {res['bwd_ms']:.3f} ms incl. "
        f"the three weight contractions (bf16 "
        f"{res['bwd_ms_bf16_same_call']:.3f} ms; plain "
        f"{res['bwd_plain_ms']:.3f} ms)")
    res["launches_per_call"] = {
        "forward": att_launches(
            torch, lambda: fwd(*a16, rep, with_residuals=True),
            "attlstm_recurrence", 3 * T_XE - 1, "f16"),
        "backward": att_launches(
            torch, lambda: bwd(*a16[:6], a16[7], *rr16, dh16, rep),
            "attlstm_recurrence_bwd", 4 * T_XE + 3, "f16")}
    return res


def f16_context(torch, ctx_mod) -> dict:
    """14a: ``fused_context_attention`` forward and backward at float16
    at the slot loop's beam shape (R = 320, rep 5; 2e's inputs) and the
    training shape (R = 1,280, rep 20; 2g's), each against its plain
    version and the gathered layout at rep 1 (forward bitwise; backward
    d_q, d_proj, d_vals bitwise after the row-order fold, d_v at the
    tier); device ms beside the same call's bf16 (``ab_ms``), the plain
    version's ms, one / two profiler launches a call."""
    fca, ref = ctx_mod.fused_context_attention, \
        ctx_mod.fused_context_attention_ref
    bwd, bwd_ref = ctx_mod.fused_context_attention_bwd, \
        ctx_mod.fused_context_attention_bwd_ref
    f16 = torch.float16
    res = {}
    g = torch.Generator().manual_seed(43)
    for (R, rep, src) in ((B * K, K, ctx_inputs(torch, 31)),
                          (R_XE, CTXB_REP, ctxb_inputs(torch, 41))):
        dctx = src.get("dctx", torch.randn(R, E, generator=g))

        def ops(cdt):
            return ([src[k][:R].to(DEVICE, cdt) if k == "q"
                     else src[k].to(DEVICE, cdt) for k in
                     ("q", "proj", "vals", "v")], src["mask"].to(DEVICE),
                    dctx.to(DEVICE, cdt))

        (q, proj, vals, v), mask, dc = ops(f16)
        args = (q, proj, mask, vals, v)
        what = f"14a fused_context_attention f16 R={R} rep={rep}"
        kc, ka = fca(*args, rep=rep, return_attn=True)
        rc, ra = ref(*args, rep=rep)
        gp, gm, gv = (x.repeat_interleave(rep, 0) for x in (proj, mask, vals))
        gc, ga = fca(q, gp, gm, gv, v, return_attn=True)
        torch.cuda.synchronize()
        ulps = f16_ulps(torch, kc, rc, CTX_BF16_ATOL_REL)
        ea = max_diff(ka, ra)
        uniform = bool(torch.allclose(ka[0], torch.full_like(ka[0],
                                                             1.0 / F_ATT)))
        log(f"{what}: ctx {ulps:.2f} f16 ulps past {CTX_BF16_ATOL_REL:g} x max "
            f"({f16_ulps(torch, kc, rc, 0.0):.2f} without), max |diff| "
            f"{max_diff(kc, rc):.3e}, |attn diff| {ea:.3e}; all-masked row "
            f"uniform {uniform}; rep bitwise the gathered layout "
            f"{bool(torch.equal(gc, kc) and torch.equal(ga, ka))}")
        if (kc.dtype != f16 or not ulps <= F16_CTX_ULPS
                or not ea <= CTX_BF16_ATTN_ATOL or not uniform
                or not torch.isfinite(kc.float()).all()):
            fail(f"{what} disagrees with its plain version")
        if not (torch.equal(gc, kc) and torch.equal(ga, ka)):
            fail(f"{what}: rep={rep} differs from the gathered layout")
        res[f"ulps_R{R}"], res[f"attn_err_R{R}"] = ulps, ea
        res[f"err_R{R}"] = max_diff(kc, rc)

        bargs = (q, proj, vals, v, ka, dc)
        bwhat = f"14a fused_context_attention_bwd f16 R={R} rep={rep}"
        kb = bwd(*bargs, rep=rep)
        rb = bwd_ref(*bargs, rep=rep)
        gb = gathered_bwd(torch, bwd, bargs, rep)
        torch.cuda.synchronize()
        bulps = {n: f16_ulps(torch, x, y, CTXB_BF16_ATOL_REL)
                 for n, x, y in zip(CTXB_NAMES, kb, rb)}
        bitwise = {n: bool(torch.equal(x, y))
                   for n, x, y in zip(CTXB_NAMES[:3], kb, gb)}
        gdv = f16_ulps(torch, kb[3], gb[3], CTXB_BF16_ATOL_REL)
        masked_rows = float(kb[0][:rep].float().abs().max())
        log(f"{bwhat}: f16 ulps past {CTXB_BF16_ATOL_REL:g} x max: "
            + ", ".join(f"{n} {x:.2f}" for n, x in bulps.items())
            + f"; vs the gathered layout folded in row order: bitwise "
            + ", ".join(f"{n} {b}" for n, b in bitwise.items())
            + f", d_v {gdv:.2f} f16 ulps; all-masked video's rows max "
            f"|d_q| {masked_rows:.3e}")
        if (not max(bulps.values()) <= F16_CTXB_ULPS or masked_rows <= 0
                or not all(bool(torch.isfinite(x.float()).all())
                           for x in kb)):
            fail(f"{bwhat} disagrees with its plain version")
        if not all(bitwise.values()) or not gdv <= F16_CTXB_ULPS:
            fail(f"{bwhat}: rep={rep} differs from the gathered layout")
        res[f"bwd_ulps_R{R}"] = bulps
        res[f"bwd_err_R{R}"] = max(max_diff(x, y) for x, y in zip(kb, rb))
        del kb, rb, gb

        (qb, pb, vb, vv), _, dcb = ops(torch.bfloat16)
        _, ab = fca(qb, pb, mask, vb, vv, rep=rep, return_attn=True)
        t = ab_ms(torch, {
            "bf16": lambda: fca(qb, pb, mask, vb, vv, rep=rep),
            "f16": lambda: fca(*args, rep=rep)},
            lambda fn: device_ms(torch, fn, REPS, CTX_LAUNCHES))
        res[f"device_ms_R{R}"] = t["f16"]
        res[f"device_ms_bf16_same_call_R{R}"] = t["bf16"]
        t = ab_ms(torch, {
            "bf16": lambda: bwd(qb, pb, vb, vv, ab, dcb, rep=rep),
            "f16": lambda: bwd(*bargs, rep=rep)},
            lambda fn: device_ms(torch, fn, REPS, CTXB_LAUNCHES))
        res[f"bwd_device_ms_R{R}"] = t["f16"]
        res[f"bwd_device_ms_bf16_same_call_R{R}"] = t["bf16"]
        res[f"plain_ms_R{R}"] = time_call(torch,
                                          lambda: ref(*args, rep=rep), 1)
        res[f"bwd_plain_ms_R{R}"] = time_call(
            torch, lambda: bwd_ref(*bargs, rep=rep), 1)
        log(f"times f16: fused_context_attention R={R} rep={rep} "
            f"{res[f'device_ms_R{R}']:.4f} ms device (the same call's bf16 "
            f"{res[f'device_ms_bf16_same_call_R{R}']:.4f}; plain "
            f"{res[f'plain_ms_R{R}']:.4f} ms), backward "
            f"{res[f'bwd_device_ms_R{R}']:.4f} ms device (bf16 "
            f"{res[f'bwd_device_ms_bf16_same_call_R{R}']:.4f}; plain "
            f"{res[f'bwd_plain_ms_R{R}']:.4f} ms)")
        if R == B * K:
            res["launches_per_call"] = {
                "forward": ctx_launches(torch, lambda: fca(*args, rep=rep),
                                        "fused_context_attention",
                                        CTX_LAUNCHES, "f16"),
                "backward": ctx_launches(
                    torch, lambda: bwd(*bargs, rep=rep),
                    "fused_context_attention_bwd", CTXB_LAUNCHES, "f16")}
    return res


def f16_att_decoders(torch, beam_mod, sam_mod) -> dict:
    """14a: ``attlstm_beam`` (B = 64, K = 5) and ``attlstm_sample``
    (greedy at B = 64, multinomial at the CST rollout's 1,280 rows) at
    float16 on 2c's inputs (seed 0, video 0 all masked), each against its
    plain version at the f16 attention tier; the first videos alone
    bitwise the B = 64 call; 5T profiler launches a call; timed beside
    the same call's bf16 (``ab_ms``) and the plain version."""
    from cst_captioning_torch.decoding.beam import finalize_beams

    fns = decoders(beam_mod, sam_mod, attention=True)
    beam, beam_ref, sample, sample_ref = fns
    base = make_att_inputs(torch, 0)
    a16 = att_to_card(torch, base, torch.float16)
    v16 = list(a16.values())
    nrep = ROLLOUT_ROWS // B
    big16 = [x.repeat_interleave(nrep, 0) if k in PER_VIDEO else x
             for k, x in a16.items()]
    res = {}
    kb = finalize_beams(*beam(*v16, beam_size=K, max_len=T))
    rb = finalize_beams(*beam_ref(*v16, beam_size=K, max_len=T))
    res["beam_err"] = bf16_check(
        "14a attlstm_beam f16", kb.tokens, rb.tokens, kb.score, rb.score,
        KERNEL_ATT_F16_MATCH_FLOOR, F16_ATT_SCORE_RTOL)
    res["sample_err"] = 0.0
    for mode, args, seed in (("greedy", v16, (0, 0)),
                             (f"multinomial R={ROLLOUT_ROWS}", big16,
                              (123, 456))):
        greedy = mode == "greedy"
        kt, kl, _ = sample(*args, seed, max_len=T, greedy=greedy)
        rt, rl, _ = sample_ref(*args, seed, max_len=T, greedy=greedy)
        res["sample_err"] = max(res["sample_err"], bf16_check(
            f"14a attlstm_sample f16 {mode}", kt, rt, kl.sum(-1), rl.sum(-1),
            KERNEL_ATT_F16_MATCH_FLOOR, F16_ATT_SCORE_RTOL))
    res["row_invariance"] = row_invariance(torch, fns, a16, "attention",
                                           "f16")
    res["launches_per_call"] = decode_breakdowns(
        torch, beam, sample, v16, ATT_DEC_LAUNCHES, "f16")
    abf = att_to_card(torch, base, torch.bfloat16)
    vbf = list(abf.values())
    bigbf = [x.repeat_interleave(nrep, 0) if k in PER_VIDEO else x
             for k, x in abf.items()]
    timer = lambda fn: time_call(torch, fn, REPS)  # noqa: E731
    for key, call in (
            ("beam", lambda v: lambda: beam(*v, beam_size=K, max_len=T)),
            ("sample", lambda v: lambda: sample(*v, (0, 0), max_len=T,
                                                greedy=True))):
        t = ab_ms(torch, {"bf16": call(vbf), "f16": call(v16)}, timer)
        res[f"{key}_ms"], res[f"{key}_ms_bf16_same_call"] = t["f16"], t["bf16"]
    t = ab_ms(torch, {
        dt: (lambda v: lambda: sample(*v, (123, 456), max_len=T,
                                      greedy=False))(v)
        for dt, v in (("bf16", bigbf), ("f16", big16))}, timer)
    key = f"sample_multinomial_ms_R{ROLLOUT_ROWS}"
    res[key], res[key + "_bf16_same_call"] = t["f16"], t["bf16"]
    res["beam_plain_ms"] = time_call(
        torch, lambda: beam_ref(*v16, beam_size=K, max_len=T), 1)
    res["sample_plain_ms"] = time_call(
        torch, lambda: sample_ref(*v16, (0, 0), max_len=T, greedy=True), 1)
    log(f"times f16: attlstm_beam {res['beam_ms']:.3f} ms (the same call's "
        f"bf16 {res['beam_ms_bf16_same_call']:.3f} ms; plain "
        f"{res['beam_plain_ms']:.3f} ms), attlstm_sample greedy "
        f"{res['sample_ms']:.3f} ms (bf16 {res['sample_ms_bf16_same_call']:.3f}"
        f" ms; plain {res['sample_plain_ms']:.3f} ms), multinomial at "
        f"R={ROLLOUT_ROWS} {res[key]:.3f} ms (bf16 "
        f"{res[key + '_bf16_same_call']:.3f} ms)")
    return res


def check_f16_att_kernels(torch, card: str, mods) -> dict:
    """Phase 14a, attention: the six float16 instantiations of the
    attention path's kernels against their plain versions at full width,
    and the f16 tanh."""
    beam_mod, sam_mod, _, _, att_mod, ctx_mod = mods
    t0 = time.perf_counter()
    out = {"tanh": f16_tanh_check(torch, att_mod),
           "rec": f16_att_recurrence(torch, att_mod),
           "ctx": f16_context(torch, ctx_mod),
           "dec": f16_att_decoders(torch, beam_mod, sam_mod)}
    out["wall_s"] = time.perf_counter() - t0
    log(f"phase 14a attention (float16 kernels) took {out['wall_s']:.1f} s  "
        f"[{card}]")
    return out


def check_f16_kernels(torch, card: str, mods, rec_launches=None) -> dict:
    """Phase 14a: the four float16 instantiations of the meanpool path's
    kernels against their plain versions at full width (``rec_launches``:
    ``f16_recurrence``'s ``launches``)."""
    beam_mod, sam_mod, lstm_mod, rg_mod = mods
    t0 = time.perf_counter()
    out = {"dec": f16_decoders(torch, beam_mod, sam_mod),
           "rec": f16_recurrence(torch, lstm_mod, rec_launches),
           "rg": check_row_gemm(torch, rg_mod, RG_F16_CASES, RG_F16_SHAPES,
                                int8=False)}
    out["wall_s"] = time.perf_counter() - t0
    log(f"phase 14a (float16 kernels) took {out['wall_s']:.1f} s  [{card}]")
    return out


P14_REQUESTS = 16        # 14b: requests served through the slot loop
P14_WXE_SEED = 14        # 14b: the WXE step's caption weights
# 14b's artifact: the f16 slot loop's engine, built from 14b's checkpoint.
P14_ART_CASE = ("meanpool_f16_slot",
                ("--model.feature_fusion", "meanpool",
                 "--model.compute_dtype", "float16", "--serving.dtype",
                 "f32"), ["lstm_beam", "row_gemm"])
P14_KERNELS = ("lstm_recurrence", "row_gemm", "lstm_sample", "lstm_beam",
               "threefry_sample")
# 14b's attention path: every kernel it runs must launch.
P14_ATT_KERNELS = ("attlstm_recurrence", "attlstm_recurrence_bwd",
                   "fused_context_attention", "fused_context_attention_bwd",
                   "attlstm_sample", "attlstm_beam", "row_gemm",
                   "threefry_sample")


def f16_ss_step(torch, card: str, model, batch, ctx_mod) -> dict:
    """14b: the XE loss and gradients through the per-step loop
    (scheduled sampling's branch, a tensor ``ss_prob`` of 0: the context
    step's forward and backward kernels at every teacher-forced step) at
    float16 compute, against the same with the context step's plain
    forward and backward swapped in: the loss within P14_LOSS_RTOL, each
    leaf's gradient of P13_F16_GRAD_SCALE x the loss within
    P14_ATT_GRAD_GAP (no update)."""
    from cst_captioning_torch.models import captioner
    from cst_captioning_torch.training.steps import xe_loss

    names, params = zip(*model.named_parameters())
    ssp = torch.tensor(0.0, device=DEVICE)

    def grads():
        loss = xe_loss(model, batch.feats, batch.feat_masks, batch.captions,
                       batch.weights, None, ssp, None)
        g = torch.autograd.grad(loss * P13_F16_GRAD_SCALE, params)
        return float(loss.detach()), dict(zip(names, g))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lk, gk = grads()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    with swapped(captioner, "fused_context_attention",
                 plain_context_attention(torch, ctx_mod)):
        lp, gp = grads()
    rtol = abs(lk - lp) / abs(lp)
    gap = leaf_gaps(torch, gk, gp)
    top = sorted(gap, key=gap.get, reverse=True)[:4]
    log(f"14b attention f16 per-step XE (ss_prob tensor 0): loss kernel "
        f"{lk:.6f} plain {lp:.6f} (rtol {rtol:.3e}, tier "
        f"{P14_LOSS_RTOL:.3e}); gradient gap per leaf at {P13_F16_GRAD_SCALE:g}"
        f" x the loss worst {', '.join(f'{k} {gap[k]:.3e}' for k in top)} "
        f"(tier {P14_ATT_GRAD_GAP:.1e}); {wall:.1f} ms wall  [{card}]")
    if rtol > P14_LOSS_RTOL or gap[top[0]] > P14_ATT_GRAD_GAP:
        fail("14b attention f16 per-step XE: kernel vs plain outside the "
             "tier")
    return {"loss_rtol": rtol, "grad_gap": gap[top[0]], "wall_ms": wall}


def f16_cst_steps(torch, card: str, model, batch, corpus, sam_mod,
                  fusion: str = "meanpool"):
    """One ``msrvtt_cst_ms_scb`` step at float16 compute on the XE model
    through the fused sampler (the ``lstm_sample`` rollout and greedy
    baseline, the ``lstm_recurrence`` PG update; attention: ``attlstm_
    sample``, the attention recurrence and its backward), one through the
    slot rollout (``row_gemm`` steps, the ``threefry_sample`` draw, and
    under attention ``fused_context_attention``); then the greedy decode
    through the sampler against its plain version."""
    from cst_captioning_torch.models import captioner
    from cst_captioning_torch.training.cst import make_cst_train_step
    from cst_captioning_torch.training.steps import make_optimizer

    out = {}
    att = fusion == "attention"
    for rollout in ("scan", "slot"):
        cfg = p13_cfg(CST_PRESET, fusion=fusion, pdt="float32",
                      cdt="float16")
        cfg.train.cst_rollout = rollout
        opt = make_optimizer(cfg.train, 1, dict(model.named_parameters()))
        step = make_cst_train_step(model, opt, cfg, corpus)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(batch.feats, batch.feat_masks, None, None, None,
                 batch.video_idx,
                 torch.Generator(device=DEVICE).manual_seed(P14_SEED), 0.0)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        log(f"14b {fusion} CST step ({rollout} rollout, f16 compute): loss "
            f"{float(m['loss']):.5f} grad norm {float(m['grad_norm']):.4f} "
            f"reward {m['reward']:.5f} baseline {m['baseline']:.5f}, "
            f"{wall:.3f} ms wall  [{card}]")
        for k in ("loss", "grad_norm", "reward", "baseline", "advantage"):
            if not math.isfinite(float(m[k])):
                fail(f"14b {fusion} CST {rollout}: non-finite {k}")
        out[rollout] = {"wall_ms": wall, "reward": float(m["reward"])}
    name = "attlstm_sample" if att else "lstm_sample"
    with torch.no_grad():
        k = model.sample(batch.feats, batch.feat_masks, max_len=T,
                         greedy=True)
        with swapped(captioner, name, getattr(sam_mod, name + "_ref")):
            p = model.sample(batch.feats, batch.feat_masks, max_len=T,
                             greedy=True)
    out["greedy_err"] = bf16_check(
        f"14b greedy {name} f16 vs plain", k.tokens, p.tokens,
        k.logprobs.sum(-1), p.logprobs.sum(-1),
        *((KERNEL_ATT_F16_MATCH_FLOOR, F16_ATT_SCORE_RTOL) if att
          else (KERNEL_F16_MATCH_FLOOR, KERNEL_F16_SCORE_RTOL)))
    return out


def f16_eval(torch, card: str, model, corpus, beam_mod, tmp: str,
             fusion: str = "meanpool"):
    """Beam-5 ``evaluate_dataset`` (``msrvtt_eval_beam5`` at float16
    compute) of the XE model over the corpus's videos, and the same with
    the beam's plain version swapped in: the captions' share that
    match."""
    from cst_captioning_torch.evaluation import evaluate_dataset
    from cst_captioning_torch.models import captioner

    att = fusion == "attention"
    name = "attlstm_beam" if att else "lstm_beam"
    floor = KERNEL_ATT_F16_MATCH_FLOOR if att else KERNEL_F16_MATCH_FLOOR
    cfg = eval_cfg(fusion, "float16")
    t0 = time.perf_counter()
    scores, preds = evaluate_dataset(model, corpus, cfg,
                                     os.path.join(tmp, f"eval_{fusion}"))
    wall = time.perf_counter() - t0
    with swapped(captioner, name, getattr(beam_mod, name + "_ref")):
        _, plain = evaluate_dataset(model, corpus, cfg)
    match = sum(preds[v] == plain[v] for v in plain) / len(plain)
    log(f"14b {fusion} beam-5 evaluate_dataset f16: {len(preds)} videos in "
        f"{wall:.2f} s, CIDEr-D {scores.get('CIDEr', float('nan')):.4f}; "
        f"captions matching the plain beam {match:.4f}  [{card}]")
    if set(preds) != set(plain) or match < floor:
        fail(f"14b {fusion} eval: caption match {match:.4f} under {floor}")
    return {"wall_s": wall, "match": match, "scores": scores}


def f16_serve(torch, card: str, model, opt, vocab, corpus, tmp: str,
              fusion: str = "meanpool"):
    """The XE model's checkpoint served through the slot loop at float16
    compute (P14_REQUESTS videos), the kernels' captions against the
    plain products' (``row_dot``, and under attention the context step,
    swapped for their plain versions).  Returns the readings and the
    checkpoint's path."""
    from cst_captioning_torch.models import captioner
    from cst_captioning_torch.ops.attention import (
        fused_context_attention_ref,
    )
    from cst_captioning_torch.ops.rowgemm import row_dot_ref
    from cst_captioning_torch.serving.engine import InferenceEngine
    from cst_captioning_torch.training import checkpoint as ckpt

    att = fusion == "attention"
    path = os.path.join(tmp, f"p14_{fusion}")
    ckpt.save_checkpoint(path, model, opt, {"epoch": 0})
    cfg = serve_cfg("f32", continuous=True)
    cfg.model.compute_dtype = "float16"
    cfg.model.feature_fusion = fusion
    eng = InferenceEngine(cfg, checkpoint=path, vocab=vocab, device=DEVICE)
    if eng.model.compute_dtype != torch.float16:
        fail(f"14b {fusion} serve: compute dtype {eng.model.compute_dtype}")
    payloads = video_payloads(corpus, range(P14_REQUESTS))
    served, admits, steps = slot_serve(eng, payloads)

    def plain_ctx(q, att_proj, att_mask, att_vals, att_v, rep=1,
                  return_attn=False):
        ctx, a = fused_context_attention_ref(q, att_proj, att_mask,
                                             att_vals, att_v, rep)
        return (ctx, a) if return_attn else ctx

    with swapped(captioner, "row_dot", row_dot_ref), swapped(
            captioner, "fused_context_attention",
            plain_ctx if att else captioner.fused_context_attention):
        plain, _, _ = slot_serve(eng, payloads)
    ks = torch.tensor([served[i]["score"] for i in range(len(served))])
    ps = torch.tensor([plain[i]["score"] for i in range(len(plain))])
    err = bf16_check(
        f"14b {fusion} slot loop f16, kernels vs plain",
        served_tensor(torch, served), served_tensor(torch, plain), ks, ps,
        *((KERNEL_ATT_F16_MATCH_FLOOR, F16_ATT_SCORE_RTOL) if att
          else (KERNEL_F16_MATCH_FLOOR, KERNEL_F16_SCORE_RTOL)))
    return {"slot_err": err, "admits": admits, "steps": steps}, path


def f16_artifact(torch, card: str, path: str, tmp: str) -> dict:
    """14c: an artifact of the float16 slot loop's engine, built from
    the checkpoint at ``path``, booted in a fresh process with no
    ``nvcc`` and serving the 10b requests, its captions the warm
    engine's (``warm_twin``, whose serving zeroes phase 10's counts: so
    it runs after 14b's are read)."""
    (built,), payload_file, _ = build_artifacts(
        torch, os.path.join(tmp, "art"), (P14_ART_CASE,),
        ("--checkpoint", path))
    out_file = os.path.join(tmp, "art", "child.json")
    child = run_child([built["vdir"], payload_file, out_file, "0"], out_file)
    _, warm = warm_twin(torch, built, payload_file)
    got = child["served"]
    log(f"14c artifact boot (f16 slot loop): booted in "
        f"{child['boot_s']:.2f} s, nvcc runs {child['nvcc_runs']}, served "
        f"{len(got['tokens'])}, launches {got['launches']}  [{card}]")
    if child["nvcc_runs"] != 0:
        fail(f"14c: the artifact boot ran nvcc {child['nvcc_runs']} times")
    if got["tokens"] != warm["tokens"]:
        fail("14c: the booted replica's captions differ from the warm "
             "engine's")
    return {"boot_s": child["boot_s"], "nvcc_runs": child["nvcc_runs"],
            "served": len(got["tokens"]), "launches": got["launches"]}


def f16_path(torch, card: str, tmp: str, counted, mods) -> dict:
    """Phase 14b: the meanpool path at float16 compute on the card at
    full width, the launches counted over the whole of it."""
    beam_mod, sam_mod, lstm_mod, _ = mods
    t0 = time.perf_counter()
    plain_rec = plain_recurrence(torch, lstm_mod)
    xe_cfg = p13_cfg("msrvtt_resnet_c3d_xe", pdt="float32", cdt="float16")
    vocab, corpus, batch = p13_batch(torch, xe_cfg)
    import numpy as np

    rng = np.random.RandomState(P14_WXE_SEED)
    wxe_batch = batch._replace(weights=torch.from_numpy(
        rng.uniform(0.2, 1.0, tuple(batch.weights.shape)).astype(np.float32)
    ).to(batch.weights.device))
    zero(counted)
    out = {}
    rec = {"lstm_recurrence": counted["lstm_recurrence"]}
    swap = ("lstm_recurrence", plain_rec)
    out["xe"], model, opt = p13_xe(torch, card, xe_cfg, batch, rec, swap, 1,
                                   "14b XE", P14_LOSS_RTOL)
    out["wxe"], _, _ = p13_xe(
        torch, card, p13_cfg("msrvtt_resnet_c3d_xe", pdt="float16",
                             cdt="float16"), wxe_batch, rec, swap, 1,
        "14b WXE", P14_LOSS_RTOL)
    if model.compute_dtype != torch.float16:
        fail(f"14b: compute dtype {model.compute_dtype}")
    out["cst"] = f16_cst_steps(torch, card, model, batch, corpus, sam_mod)
    out["eval"] = f16_eval(torch, card, model, corpus, beam_mod, tmp)
    out["serve"], path = f16_serve(torch, card, model, opt, vocab, corpus,
                                   tmp)
    torch.cuda.synchronize()
    out["launches"] = counts(counted)
    out["wall_s"] = time.perf_counter() - t0
    log(f"phase 14b (the f16 path) took {out['wall_s']:.1f} s, launches "
        f"{out['launches']}  [{card}]")
    idle = [n for n in P14_KERNELS if out["launches"][n] < 1]
    if idle:
        fail(f"14b: kernels of the f16 path never launched: {idle}")
    out["artifact"] = f16_artifact(torch, card, path, tmp)
    return out


def f16_att_path(torch, card: str, tmp: str, counted, mods) -> dict:
    """Phase 14b under attention fusion: the same path as ``f16_path``
    at float16 compute on the card at full width, every count zeroed
    first and read over the whole of it.  The XE (float32 leaves) and WXE
    (float16 leaves) steps hold the loss within P14_LOSS_RTOL and the
    gradients of P13_F16_GRAD_SCALE x the loss within P14_ATT_GRAD_GAP of
    the plain attention recurrence's; the per-step loop's the same against
    the plain context step (``f16_ss_step``); then a scan and a slot CST
    step, the greedy decode, a beam-5 eval and the slot loop, each
    against its plain version at the f16 attention tier."""
    import numpy as np

    beam_mod, sam_mod, _, _, att_mod, _ = mods
    t0 = time.perf_counter()
    plain_rec = plain_att_recurrence(torch, att_mod)
    xe_cfg = p13_cfg("msrvtt_resnet_c3d_xe", fusion="attention",
                     pdt="float32", cdt="float16")
    vocab, corpus, batch = p13_batch(torch, xe_cfg)
    rng = np.random.RandomState(P14_WXE_SEED)
    wxe_batch = batch._replace(weights=torch.from_numpy(
        rng.uniform(0.2, 1.0, tuple(batch.weights.shape)).astype(np.float32)
    ).to(batch.weights.device))
    zero(counted)
    out = {}
    rec = {n: counted[n] for n in ("attlstm_recurrence",
                                   "attlstm_recurrence_bwd")}
    swap = ("attlstm_recurrence", plain_rec)
    out["xe"], model, opt = p13_xe(torch, card, xe_cfg, batch, rec, swap, 1,
                                   "14b XE", P14_LOSS_RTOL,
                                   P13_F16_GRAD_SCALE, P14_ATT_GRAD_GAP)
    out["wxe"], _, _ = p13_xe(
        torch, card, p13_cfg("msrvtt_resnet_c3d_xe", fusion="attention",
                             pdt="float16", cdt="float16"), wxe_batch, rec,
        swap, 1, "14b WXE", P14_LOSS_RTOL, P13_F16_GRAD_SCALE,
        P14_ATT_GRAD_GAP)
    if model.compute_dtype != torch.float16:
        fail(f"14b attention: compute dtype {model.compute_dtype}")
    out["ss"] = f16_ss_step(torch, card, model, batch, mods[5])
    out["cst"] = f16_cst_steps(torch, card, model, batch, corpus, sam_mod,
                               "attention")
    out["eval"] = f16_eval(torch, card, model, corpus, beam_mod, tmp,
                           "attention")
    out["serve"], _ = f16_serve(torch, card, model, opt, vocab, corpus, tmp,
                                "attention")
    torch.cuda.synchronize()
    out["launches"] = counts(counted)
    out["wall_s"] = time.perf_counter() - t0
    log(f"phase 14b attention (the f16 path) took {out['wall_s']:.1f} s, "
        f"launches {out['launches']}  [{card}]")
    idle = [n for n in P14_ATT_KERNELS if out["launches"][n] < 1]
    if idle:
        fail(f"14b: kernels of the f16 attention path never launched: "
             f"{idle}")
    return out


def check_f16_compute(torch, card: str, tmp: str, mods, tf_mod,
                      rec_launches=None) -> dict:
    """Phase 14 (see the module docstring).  ``mods``: the beam, sampler,
    lstm, row_gemm, attlstm and attention modules; ``rec_launches``: phase
    2b's profiler count of one float16 ``lstm_recurrence`` call's
    launches (None: 14a counts them)."""
    t0 = time.perf_counter()
    beam_mod, sam_mod, lstm_mod, rg_mod, att_mod, ctx_mod = mods
    out = {"a": check_f16_kernels(torch, card, mods[:4], rec_launches),
           "a_att": check_f16_att_kernels(torch, card, mods)}
    counted = {"lstm_recurrence": lstm_mod.lstm_recurrence,
               "row_gemm": rg_mod.row_dot,
               "lstm_sample": sam_mod.lstm_sample,
               "lstm_beam": beam_mod.lstm_beam,
               "threefry_sample": tf_mod.threefry_sample}
    out["b_att"] = f16_att_path(
        torch, card, tmp,
        {"attlstm_recurrence": att_mod.attlstm_recurrence,
         "attlstm_recurrence_bwd": att_mod.attlstm_recurrence_bwd,
         "fused_context_attention": ctx_mod.fused_context_attention,
         "fused_context_attention_bwd": ctx_mod.fused_context_attention_bwd,
         "attlstm_sample": sam_mod.attlstm_sample,
         "attlstm_beam": beam_mod.attlstm_beam,
         "row_gemm": rg_mod.row_dot,
         "threefry_sample": tf_mod.threefry_sample}, mods)
    out["b"] = f16_path(torch, card, tmp, counted, mods[:4])
    out["wall_s"] = time.perf_counter() - t0
    log(f"phase 14 (compute_dtype float16) took {out['wall_s']:.1f} s  "
        f"[{card}]")
    return out


def f16_kernel_entries(p14) -> list:
    """The kernels line's entries of the four float16 instantiations
    (phase 14): times and errors from 14a, launches from 14b's path."""
    a, b = p14["a"], p14["b"]
    dec, rec, rg = a["dec"], a["rec"], a["rg"]
    n = b["launches"]
    common = dict(route="cuda", dtype="float16", tolerance=F16_TOLERANCE,
                  phase14_path_wall_s=b["wall_s"])
    beam_b = bound_ms(*decode_work(B * K, 2, B * K * T * 4 + B * K * 4),
                      H100_BF16_FLOPS)
    samp_b = bound_ms(*decode_work(B, 2, 3 * B * T * 4), H100_BF16_FLOPS)
    roll_b = bound_ms(*decode_work(ROLLOUT_ROWS, 2, 3 * ROLLOUT_ROWS * T * 4),
                      H100_BF16_FLOPS)
    rec_b = bound_ms(*rec_work(R_XE, T_XE, 2), H100_BF16_FLOPS)
    R = B * K
    rg_b = bound_ms(*rg_work(R, H, V, 2, 2), H100_BF16_FLOPS)
    return [
        dict(name="lstm_recurrence_f16",
             source="cst_captioning_torch/csrc/lstm_recurrence.cu",
             replaces=f"{REFERENCE}/ops/pallas_lstm.py:172",
             launches=n["lstm_recurrence"], max_abs_err=rec["err"],
             ms=rec["ms"], plain_ms=rec["plain_ms"], bound_ms=rec_b[0],
             bound_by=rec_b[1], library_ms=rec["library_ms"],
             library="torch.nn.LSTM (cuDNN) in float16 on the same gates, "
                     "plus its identity input GEMM",
             c_rel=rec["c_rel"], ms_no_cell=rec["ms_nocell"],
             launches_per_call=rec["launches_per_call"],
             order_witness_c_rel=rec["order_witness_c_rel"],
             grad_rel_kernel_fwd_vs_plain=rec["grad_rel"],
             shape=f"R={R_XE}, T={T_XE}, H={H}", **common),
        dict(name="row_gemm_f16",
             source="cst_captioning_torch/csrc/row_gemm.cu",
             replaces=f"{REFERENCE}/models/captioner.py:408",
             replaces_note="no TPU kernel: the per-step decoder's products "
                           "and the admission encode's projections, which "
                           "the reference leaves to XLA",
             launches=n["row_gemm"], max_abs_err=rg["err_f16"],
             ms=rg["ms_f16"], plain_ms=rg["plain_ms_f16"],
             bound_ms=rg_b[0], bound_by=rg_b[1],
             library_ms=rg["library_ms_f16"],
             library="torch.matmul on the rounded operands (cuBLAS sgemm)",
             ms_note="ms, library_ms and by_shape: profiler device time",
             event_ms=rg["event_ms_f16"], by_shape=rg["shapes"],
             cublas_rows_differing=rg["cublas_rows_differing"],
             shape=f"vocab product R={R}, K={H}, N={V}", **common),
        dict(name="lstm_sample_f16",
             source="cst_captioning_torch/csrc/lstm_sample.cu",
             replaces=f"{REFERENCE}/ops/pallas_sampler.py:682",
             launches=n["lstm_sample"], max_abs_err=dec["sample_err"],
             ms=dec["sample_ms"], plain_ms=dec["sample_plain_ms"],
             bound_ms=samp_b[0], bound_by=samp_b[1], library_ms=None,
             launches_per_call=dec["launches_per_call"]["greedy"],
             row_invariance=dec["row_invariance"],
             bound_ms_multinomial_R1280=roll_b[0],
             **{k: v for k, v in dec.items()
                if k.startswith("sample_multinomial_ms_")},
             shape=f"greedy B={B}, T={T}", **common),
        dict(name="lstm_beam_f16",
             source="cst_captioning_torch/csrc/lstm_beam.cu",
             replaces=f"{REFERENCE}/ops/pallas_beam.py:687",
             launches=n["lstm_beam"], max_abs_err=dec["beam_err"],
             ms=dec["beam_ms"], plain_ms=dec["beam_plain_ms"],
             bound_ms=beam_b[0], bound_by=beam_b[1], library_ms=None,
             launches_per_call=dec["launches_per_call"]["beam"],
             row_invariance=dec["row_invariance"],
             phase14_path=dict(
                 xe=b["xe"], wxe=b["wxe"], cst=b["cst"],
                 eval={k: b["eval"][k] for k in ("wall_s", "match")},
                 serve=b["serve"], artifact=b["artifact"], launches=n),
             shape=f"B={B}, K={K}, T={T}", **common),
    ]


def f16_att_kernel_entries(p14) -> list:
    """The kernels line's entries of the six float16 instantiations of
    the attention path (phase 14): times and errors from 14a's attention
    half, each beside the same call's bf16; launches from 14b's attention
    path."""
    a, b = p14["a_att"], p14["b_att"]
    rec, ctx, dec = a["rec"], a["ctx"], a["dec"]
    n = b["launches"]
    common = dict(route="cuda", dtype="float16", tolerance=F16_ATT_TOLERANCE,
                  library_ms=None, library="none (no single call)",
                  phase14_attention_path_wall_s=b["wall_s"],
                  tanh="tanhf of the f16-rounded argument, rounded to f16 "
                       "(no table); bitwise the plain version's on all "
                       f"65,536 f16 codes: {a['tanh']['differ'] == 0}")
    (ff, fb, ft), (gf, gb, gt) = att_rec_work(R_XE, T_XE, 2, ATT_REP)
    fbound, fby, fterm = rec_bound(ff, fb, ft, H100_BF16_FLOPS)
    gbound, gby, gterm = rec_bound(gf, gb, gt, H100_BF16_FLOPS)
    R, nv = B * K, R_XE // CTXB_REP
    cb, cby = ctx_bound(R, B, 2)
    xb, xby = rec_bound(*ctxb_work(R_XE, nv, 2), H100_F32_FLOPS)[:2]
    bf, bb, bt = att_decode_work(R, 2, R * T * 4 + R * 4)
    sf, sb, st = att_decode_work(B, 2, 3 * B * T * 4)
    rf, rb_, _ = att_decode_work(ROLLOUT_ROWS, 2, 3 * ROLLOUT_ROWS * T * 4)
    beam_b = bound_ms(bf, bb, H100_BF16_FLOPS)
    samp_b = bound_ms(sf, sb, H100_BF16_FLOPS)
    roll = f"sample_multinomial_ms_R{ROLLOUT_ROWS}"
    rec_src = "cst_captioning_torch/csrc/attlstm_recurrence.cu"
    return [
        dict(common, name="attlstm_recurrence_f16", source=rec_src,
             replaces=f"{REFERENCE}/ops/pallas_attlstm.py:544",
             launches=n["attlstm_recurrence"], max_abs_err=rec["err"],
             ms=rec["ms"], plain_ms=rec["plain_ms"], bound_ms=fbound,
             bound_by=fby, bound_term=fterm,
             ms_bf16_same_call=rec["ms_bf16_same_call"],
             share_differing=rec["share_differing"],
             launches_per_call=rec["launches_per_call"]["forward"],
             order_witness=rec["order_witness"], rep=ATT_REP,
             shape=f"R={R_XE} over {R_XE // ATT_REP} videos, T={T_XE}, "
                   f"F={F_ATT}, A={A_ATT}"),
        dict(common, name="attlstm_recurrence_bwd_f16", source=rec_src,
             replaces=f"{REFERENCE}/ops/pallas_attlstm.py:578",
             launches=n["attlstm_recurrence_bwd"], max_abs_err=rec["bwd_err"],
             ms=rec["bwd_ms"], plain_ms=rec["bwd_plain_ms"], bound_ms=gbound,
             bound_by=gby, bound_term=gterm,
             ms_bf16_same_call=rec["bwd_ms_bf16_same_call"],
             f16_ulps=rec["bwd_ulps"], fold=rec["fold"],
             launches_per_call=rec["launches_per_call"]["backward"],
             ms_note="includes the three weight contractions done outside "
                     "the kernel (torch.matmul)", rep=ATT_REP),
        dict(common, name="fused_context_attention_f16",
             source="cst_captioning_torch/csrc/context_attention.cu",
             replaces=f"{REFERENCE}/ops/pallas_attention.py:214",
             launches=n["fused_context_attention"],
             max_abs_err=ctx[f"err_R{R}"], ms=ctx[f"device_ms_R{R}"],
             plain_ms=ctx[f"plain_ms_R{R}"], bound_ms=cb, bound_by=cby,
             ms_bf16_same_call=ctx[f"device_ms_bf16_same_call_R{R}"],
             ms_note="ms: profiler device time per call",
             f16_ulps=ctx[f"ulps_R{R}"],
             ms_train_shape=ctx[f"device_ms_R{R_XE}"],
             ms_train_shape_bf16_same_call=ctx[
                 f"device_ms_bf16_same_call_R{R_XE}"],
             launches_per_call=ctx["launches_per_call"]["forward"],
             shape=f"R={R} over {B} videos (rep={K}); R={R_XE} (rep="
                   f"{CTXB_REP}) for the *_train_shape readings"),
        dict(common, name="fused_context_attention_bwd_f16",
             source="cst_captioning_torch/csrc/context_attention_bwd.cu",
             replaces=f"{REFERENCE}/ops/pallas_attention.py:202",
             launches=n["fused_context_attention_bwd"],
             max_abs_err=ctx[f"bwd_err_R{R_XE}"],
             ms=ctx[f"bwd_device_ms_R{R_XE}"],
             plain_ms=ctx[f"bwd_plain_ms_R{R_XE}"], bound_ms=xb,
             bound_by=xby,
             ms_bf16_same_call=ctx[f"bwd_device_ms_bf16_same_call_R{R_XE}"],
             ms_note="ms: profiler device time per call (both launches)",
             f16_ulps=ctx[f"bwd_ulps_R{R_XE}"],
             ms_beam_shape=ctx[f"bwd_device_ms_R{R}"],
             launches_per_call=ctx["launches_per_call"]["backward"],
             shape=f"R={R_XE} over {nv} videos (rep={CTXB_REP}); R={R} "
                   f"(rep={K}) for ms_beam_shape"),
        dict(common, name="attlstm_beam_f16",
             source="cst_captioning_torch/csrc/lstm_beam.cu",
             replaces=f"{REFERENCE}/ops/pallas_beam.py:649",
             launches=n["attlstm_beam"], max_abs_err=dec["beam_err"],
             ms=dec["beam_ms"], plain_ms=dec["beam_plain_ms"],
             bound_ms=beam_b[0], bound_by=beam_b[1],
             sfu_floor_ms=sfu_floor_ms(bt),
             ms_bf16_same_call=dec["beam_ms_bf16_same_call"],
             launches_per_call=dec["launches_per_call"]["beam"],
             row_invariance=dec["row_invariance"],
             phase14_attention_path=dict(
                 xe=b["xe"], wxe=b["wxe"], ss=b["ss"], cst=b["cst"],
                 eval={k: b["eval"][k] for k in ("wall_s", "match")},
                 serve=b["serve"], launches=n),
             shape=f"B={B}, K={K}, T={T}, F={F_ATT}, A={A_ATT}"),
        dict(common, name="attlstm_sample_f16",
             source="cst_captioning_torch/csrc/lstm_sample.cu",
             replaces=f"{REFERENCE}/ops/pallas_sampler.py:643",
             launches=n["attlstm_sample"], max_abs_err=dec["sample_err"],
             ms=dec["sample_ms"], plain_ms=dec["sample_plain_ms"],
             bound_ms=samp_b[0], bound_by=samp_b[1],
             sfu_floor_ms=sfu_floor_ms(st),
             ms_bf16_same_call=dec["sample_ms_bf16_same_call"],
             launches_per_call=dec["launches_per_call"]["greedy"],
             **{roll: dec[roll], roll + "_bf16_same_call":
                dec[roll + "_bf16_same_call"]},
             bound_ms_multinomial_R1280=bound_ms(rf, rb_, H100_BF16_FLOPS)[0],
             shape=f"greedy B={B}, T={T}; multinomial R={ROLLOUT_ROWS}"),
    ]


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a GPU")
    try:
        from cst_captioning_torch.ops import _build
        from cst_captioning_torch.ops import attention as ctx_mod
        from cst_captioning_torch.ops import attlstm as att_mod
        from cst_captioning_torch.ops import beam as beam_mod
        from cst_captioning_torch.ops import lstm as lstm_mod
        from cst_captioning_torch.ops import rowgemm as rg_mod
        from cst_captioning_torch.ops import sampler as sam_mod
        from cst_captioning_torch.ops import threefry as tf_mod
    except ImportError as e:
        fail(f"cannot import cst_captioning_torch ({e}); run from the repo root")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)

    t0 = time.perf_counter()
    logs = _build.build()
    build_s = time.perf_counter() - t0
    log(f"built {sorted(logs) or 'nothing (cached)'} in {build_s:.1f} s")
    for name, text in sorted(logs.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    res = check_kernels(torch, beam_mod, sam_mod)
    rec = check_recurrence(torch, lstm_mod)
    ares = check_att_decoders(torch, beam_mod, sam_mod)
    arec = check_att_recurrence(torch, att_mod)
    cres = check_context_attention(torch, ctx_mod)
    rgres = check_row_gemm(torch, rg_mod)
    bres = check_context_attention_bwd(torch, ctx_mod)
    qdec = {f: check_quant_decoders(torch, beam_mod, sam_mod,
                                    f == "attention")
            for f in ("meanpool", "attention")}
    qrec = check_quant_recurrences(torch, lstm_mod, att_mod)
    launches = check_engine(torch, {"beam": beam_mod.lstm_beam,
                                    "greedy": sam_mod.lstm_sample},
                            "meanpool")
    alaunches = check_engine(torch, {"beam": beam_mod.attlstm_beam,
                                     "greedy": sam_mod.attlstm_sample},
                             "attention")
    qlad = {"meanpool": check_engine(
                torch, {"beam": beam_mod.lstm_beam,
                        "greedy": sam_mod.lstm_sample}, "meanpool", "int8w"),
            "attention": check_engine(
                torch, {"beam": beam_mod.attlstm_beam,
                        "greedy": sam_mod.attlstm_sample}, "attention",
                "int8w")}
    qfwd = {"meanpool": check_int8w_forward(
                torch, card, "meanpool", lstm_mod.lstm_recurrence_quant,
                lstm_mod.lstm_recurrence_quant_ref),
            "attention": check_int8w_forward(
                torch, card, "attention", att_mod.attlstm_recurrence_quant,
                att_mod.attlstm_recurrence_quant_ref)}
    cont = {f: check_continuous(torch, card, f, [ctx_mod.fused_context_attention,
                                                 rg_mod.row_dot])
            for f in ("meanpool", "attention")}
    reps = check_replicas(torch, card, [ctx_mod.fused_context_attention,
                                        rg_mod.row_dot])
    tier = check_feature_cache(torch, card,
                               [ctx_mod.fused_context_attention,
                                rg_mod.row_dot])
    with tempfile.TemporaryDirectory() as ckroot:
        train = check_training(
            torch, card, "meanpool",
            {"lstm_recurrence": lstm_mod.lstm_recurrence,
             "lstm_sample": sam_mod.lstm_sample},
            ("lstm_recurrence", plain_recurrence(torch, lstm_mod)),
            os.path.join(ckroot, "meanpool"))
        atrain = check_training(
            torch, card, "attention",
            {"attlstm_recurrence": att_mod.attlstm_recurrence,
             "attlstm_recurrence_bwd": att_mod.attlstm_recurrence_bwd,
             "attlstm_sample": sam_mod.attlstm_sample},
            ("attlstm_recurrence", plain_att_recurrence(torch, att_mod)),
            os.path.join(ckroot, "attention"))
        sstrain = check_ss_training(
            torch, card,
            {"fused_context_attention": ctx_mod.fused_context_attention,
             "fused_context_attention_bwd":
                 ctx_mod.fused_context_attention_bwd,
             "attlstm_recurrence": att_mod.attlstm_recurrence,
             "attlstm_recurrence_bwd": att_mod.attlstm_recurrence_bwd},
            plain_context_attention(torch, ctx_mod), atrain["step_ms"])
        cst = check_cst(
            torch, card,
            {"meanpool": train["best"], "attention": atrain["best"]},
            {"meanpool": {"lstm_sample": sam_mod.lstm_sample,
                          "lstm_recurrence": lstm_mod.lstm_recurrence,
                          "row_gemm": rg_mod.row_dot},
             "attention": {"attlstm_sample": sam_mod.attlstm_sample,
                           "attlstm_recurrence": att_mod.attlstm_recurrence,
                           "attlstm_recurrence_bwd":
                               att_mod.attlstm_recurrence_bwd,
                           "row_gemm": rg_mod.row_dot}},
            ("lstm_recurrence", plain_recurrence(torch, lstm_mod),
             lstm_mod.lstm_recurrence), sam_mod,
            os.path.join(ckroot, "cst_meanpool", "best"))
        osim = check_overlap_sim(
            torch, card, {"lstm_sample": sam_mod.lstm_sample,
                          "lstm_recurrence": lstm_mod.lstm_recurrence,
                          "threefry_sample": tf_mod.threefry_sample})
        slot = check_slot_rollout(
            torch, card, {"meanpool": os.path.join(ckroot, "cst_meanpool",
                                                   "best"),
                          "attention": atrain["best"]},
            {"lstm_sample": sam_mod.lstm_sample,
             "lstm_recurrence": lstm_mod.lstm_recurrence,
             "row_gemm": rg_mod.row_dot,
             "threefry_sample": tf_mod.threefry_sample,
             "fused_context_attention": ctx_mod.fused_context_attention})
        beam_counted = {"lstm_beam": beam_mod.lstm_beam,
                        "row_gemm": rg_mod.row_dot}
        t6 = time.perf_counter()
        ev = check_eval(torch, card, os.path.join(ckroot, "cst_meanpool",
                                                  "best"),
                        beam_counted, beam_mod, ckroot)
        aev = check_att_eval(torch, card, atrain["best"],
                             {"attlstm_beam": beam_mod.attlstm_beam,
                              "row_gemm": rg_mod.row_dot}, beam_mod, ckroot)
        pev = check_pipeline(torch, card, beam_counted, ckroot,
                             cli=not ev["h5py"])
        t6d = time.perf_counter()
        reh = check_rehearsal(
            torch, card, {"lstm_beam": beam_mod.lstm_beam,
                          "lstm_sample": sam_mod.lstm_sample,
                          "lstm_recurrence": lstm_mod.lstm_recurrence},
            ckroot)
        log(f"phase 6d (the rehearsal) took "
            f"{time.perf_counter() - t6d:.1f} s")
        log(f"phase 6 (stage 4: eval, readers, pipeline) took "
            f"{time.perf_counter() - t6:.1f} s")
        t7 = time.perf_counter()
        cst_best = os.path.join(ckroot, "cst_meanpool", "best")
        serve_counted = {"lstm_beam": beam_mod.lstm_beam,
                         "lstm_sample": sam_mod.lstm_sample,
                         "row_gemm": rg_mod.row_dot}
        p7a = check_trained_serving(torch, card, cst_best, ev, serve_counted,
                                    os.path.join(ckroot, "p7a"))
        p7b = check_import_on_card(torch, card, cst_best, ev,
                                   p7a.pop("f32_ladder_tokens"),
                                   serve_counted, os.path.join(ckroot, "p7b"))
        for k in ("corpus", "f32_tokens", "vocab"):
            del ev[k]
        p7c = check_category(
            torch, card,
            {"lstm_recurrence": lstm_mod.lstm_recurrence,
             "lstm_sample": sam_mod.lstm_sample,
             "lstm_beam": beam_mod.lstm_beam,
             "attlstm_recurrence": att_mod.attlstm_recurrence,
             "attlstm_recurrence_bwd": att_mod.attlstm_recurrence_bwd,
             "attlstm_beam": beam_mod.attlstm_beam,
             "row_gemm": rg_mod.row_dot},
            {"lstm_recurrence": plain_recurrence(torch, lstm_mod),
             "attlstm_recurrence": plain_att_recurrence(torch, att_mod)},
            beam_mod, sam_mod, os.path.join(ckroot, "p7c"))
        log(f"phase 7 (trained checkpoints, the importer, use_category) "
            f"took {time.perf_counter() - t7:.1f} s")
        p8 = check_stacked(torch, card, os.path.join(ckroot, "p8"))
        p9 = check_serving_extensions(torch, card,
                                      os.path.join(ckroot, "p9"))
        p10 = check_artifacts(torch, card, os.path.join(ckroot, "p10"),
                              build_s)
        p11 = check_multi_gpu(
            torch, card, os.path.join(ckroot, "p11"),
            {"row_gemm": rg_mod.row_dot,
             "fused_context_attention": ctx_mod.fused_context_attention,
             "lstm_recurrence": lstm_mod.lstm_recurrence,
             "attlstm_recurrence": att_mod.attlstm_recurrence,
             "attlstm_recurrence_bwd": att_mod.attlstm_recurrence_bwd})
    p12 = check_phase12(torch, card, [ctx_mod.fused_context_attention,
                                      rg_mod.row_dot])
    with tempfile.TemporaryDirectory() as p13root:
        p13 = {pdt: check_param_dtype(torch, card, p13root,
                                      (beam_mod, sam_mod, lstm_mod, att_mod,
                                       rg_mod), pdt)
               for pdt in P13_LEAF_DTYPES}
    with tempfile.TemporaryDirectory() as p14root:
        p14 = check_f16_compute(torch, card, p14root,
                                (beam_mod, sam_mod, lstm_mod, rg_mod,
                                 att_mod, ctx_mod), tf_mod,
                                rec["launches_per_call_f16"])

    beam_flops, beam_bytes = decode_work(B * K, 2, B * K * T * 4 + B * K * 4)
    samp_flops, samp_bytes = decode_work(B, 2, 3 * B * T * 4)
    bb, bb_by = bound_ms(beam_flops, beam_bytes, H100_BF16_FLOPS)
    sb, sb_by = bound_ms(samp_flops, samp_bytes, H100_BF16_FLOPS)
    rb, rb_by = bound_ms(*rec_work(R_XE, T_XE, 2), H100_BF16_FLOPS)
    kernels = [
        {"name": "lstm_beam", "route": "cuda",
         "source": "cst_captioning_torch/csrc/lstm_beam.cu",
         "replaces": f"{REFERENCE}/ops/pallas_beam.py:687",
         "launches": launches["beam"], "max_abs_err": res["beam_bf16_err"],
         "ms": res["beam_ms_bf16"], "plain_ms": res["beam_plain_ms_bf16"],
         "bound_ms": bb, "bound_by": bb_by, "library_ms": None,
         "max_abs_err_f32": res["beam_f32_err"],
         "tolerance": MEANPOOL_TOLERANCE, "dtype": "bfloat16",
         "ms_f32": res["beam_ms_f32"],
         "plain_ms_f32": res["beam_plain_ms_f32"],
         "bound_ms_f32": bound_ms(beam_flops, beam_bytes, H100_F32_FLOPS)[0],
         "chaos_witness_f32": res["chaos"],
         "bf16_order_witness": res["order_witness"],
         "launches_per_call_bf16": res["launches_per_call_bf16"]["beam"],
         "bf16_row_invariance": res["row_invariance"]},
        {"name": "lstm_sample", "route": "cuda",
         "source": "cst_captioning_torch/csrc/lstm_sample.cu",
         "replaces": f"{REFERENCE}/ops/pallas_sampler.py:682",
         "launches": launches["greedy"], "max_abs_err": res["sample_bf16_err"],
         "ms": res["sample_ms_bf16"], "plain_ms": res["sample_plain_ms_bf16"],
         "bound_ms": sb, "bound_by": sb_by, "library_ms": None,
         "max_abs_err_f32": res["sample_f32_err"],
         "tolerance": MEANPOOL_TOLERANCE, "dtype": "bfloat16",
         "ms_f32": res["sample_ms_f32"],
         "plain_ms_f32": res["sample_plain_ms_f32"],
         "bound_ms_f32": bound_ms(samp_flops, samp_bytes, H100_F32_FLOPS)[0],
         "bf16_order_witness": res["order_witness"],
         "launches_per_call_bf16": res["launches_per_call_bf16"]["greedy"],
         "bf16_row_invariance": res["row_invariance"],
         **{k: v for k, v in res.items()
            if k.startswith("sample_multinomial_ms_")}},
        {"name": "lstm_recurrence", "route": "cuda",
         "source": "cst_captioning_torch/csrc/lstm_recurrence.cu",
         "replaces": f"{REFERENCE}/ops/pallas_lstm.py:172",
         "launches": train["launches"]["lstm_recurrence"],
         "max_abs_err": rec["bf16_err"], "ms": rec["ms_bf16"],
         "plain_ms": rec["plain_ms_bf16"], "bound_ms": rb, "bound_by": rb_by,
         "library_ms": rec["library_ms_bf16"],
         "library": "torch.nn.LSTM (cuDNN) on the same gates, plus its "
                    "identity input GEMM",
         "max_abs_err_f32": rec["f32_err"], "tolerance": REC_TOLERANCE,
         "dtype": "bfloat16", "ms_f32": rec["ms_f32"],
         "plain_ms_f32": rec["plain_ms_f32"],
         "bound_ms_f32": bound_ms(*rec_work(R_XE, T_XE, 4), H100_F32_FLOPS)[0],
         "library_ms_f32": rec["library_ms_f32"],
         "launches_per_call_bf16": rec["launches_per_call_bf16"],
         "launch_plan_bf16": dict(zip(("clusters", "ctas_per_cluster",
                                       "rows_per_cluster"),
                                      rec["launch_plan"])),
         "order_witness_c_rel_bf16": rec["order_witness_c_rel"],
         "ms_no_cell": rec["ms_nocell_bf16"],
         "ms_no_cell_f32": rec["ms_nocell_f32"],
         "plain_bwd_ms": rec["plain_bwd_ms_bf16"],
         "grad_rel_f32": rec["grad_rel"],
         "xe_step_f32_vs_plain": train["xe_f32"],
         "train_steps_per_sec": train["steps_per_sec"],
         "train_launches_lstm_sample": train["launches"]["lstm_sample"],
         "xe_step_ms": train["step_ms"]},
    ]
    kernels += att_kernel_entries(res=ares, rec=arec, launches=alaunches,
                                  train=atrain)
    kernels += continuous_kernel_entries(cres, rgres, cont, bres, sstrain)
    add_replica_readings(kernels, reps)
    add_tier_readings(kernels, tier)
    kernels.append(ss_kernel_entry(bres, sstrain))
    qentries, rg_int8 = quant_kernel_entries(qdec, qrec, qlad, qfwd, cont,
                                             rgres)
    next(k for k in kernels if k["name"] == "row_gemm").update(rg_int8)
    kernels += qentries
    add_cst_readings(kernels, cst)
    kernels.append(slot_kernel_entry(slot))
    add_eval_readings(kernels, ev, aev, pev)
    add_tool_readings(kernels, osim, reh)
    add_phase7_readings(kernels, p7a, p7b, p7c)
    add_phase8_readings(kernels, p8)
    add_phase9_readings(kernels, p9)
    add_phase10_readings(kernels, p10)
    add_phase11_readings(kernels, p11)
    add_phase12_readings(kernels, p12)
    for pdt in P13_LEAF_DTYPES:
        add_phase13_readings(kernels, p13[pdt], pdt)
    kernels += f16_kernel_entries(p14)
    kernels += f16_att_kernel_entries(p14)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
