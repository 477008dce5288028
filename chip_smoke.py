#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):

1. Card: requires CUDA, prints ``nvidia-smi``'s name and power limit,
   builds the four CUDA sources (``src/repro_torch/kernels/{pullpush,
   swa_attention,mamba_scan,slstm_step}/csrc``, as ``kernels/_build.py``
   lists them), one ``nvcc`` each (``pullpush.cu`` one a part, five parts,
   then linked), all at once, and prints each source's own seconds.
2. Kernels: every kernel of the DPPF round against its plain PyTorch
   version at (4, 300), (8, 4097), (5, 2^26 + 3), (32, 65537) and at the
   main path's shape R = 4, n = 1,216,385,024 (yi-6b at LAYERS = 4);
   at each, ``fused_round`` (the partial Gram whose last block runs the
   coefficient phase, then the mix), ``mix_from_gram`` (the coefficients
   in the mix's prologue) and its stale epilogue bit-equal (out, r, G)
   to the launch sequences they replaced (block partials, ``gram_coef``,
   ``mix_shard`` / ``stale_mix``), and the tail's G bit-equal to the
   plain fixed-order sum (``ref.gram_sum_plain``); ``pullpush_fused``'s
   two leaf kernels on small stacked trees (``LEAF_CASES``: mixed fp32 /
   bf16 leaves, sizes not multiples of 4, leaves off a 16-byte boundary,
   M from 2 to 32) bit-equal to the flattened composite and held against
   their plain versions. Then times kernel, plain version and the
   nearest PyTorch call at the main shape (CUDA events, median of 20
   runs after 3 warm-ups; the plain versions, 0.1-0.4 s a call there,
   median of 3 after 1), the replaced launch sequences, and
   ``gram_coef``'s device time (one block on a few KB, whose event time
   is the host's launch cost) from ``torch.profiler`` and from 20 calls
   queued behind a sleep kernel. No main path launches ``gram_coef``
   (``MERGED``): every phase's census below holds it at 0.
3. The slice: yi-6b at full width (d_model 4096, 32/4 heads, d_ff 11008,
   vocab 64000), depth cut to 4 layers, bf16 model over the fp32 flat
   master view; M = 4 workers, simple_avg, alpha 0.1, lam 0.5, tau 4,
   16 steps, seq 64, batch 8 per worker, SGD (momentum 0.9, wd 1e-3).
   Launch counters are zeroed just before and read just after.
4. The launcher: ``repro_torch.launch.train.main`` (``--smoke``) on the
   card, on the flat engine and with ``--engine tree``.
5. Attention kernel: ``swa_attention`` against its plain version in fp32
   (the CUDA-core kernel) and bf16 (the tensor-core kernel) on the six
   cases of ``tests/test_kernels.py``, a ragged non-causal case, an
   ``Sq > Skv`` case, an hd = 112 case, a small hd = 256 case (B = 2, 8
   heads over 4, S = 333, window 96, cap 50) and the serving shapes
   (B = 4, H = 8 over 4 kv heads, S = 8160, hd = 256: local window 4096
   with cap 50, global with cap 50, and cap 0 / window 0 where one
   PyTorch call, ``scaled_dot_product_attention``, computes the same
   function; zamba2-7b's B = 4, 32 heads over 32, S = 8160, hd = 112,
   cap 0 / window 0); times kernel, plain version (at the serving shapes
   a median of 3) and that call (CUDA events, median of 20 after 3
   warm-ups). Each query row is held to 2e-5
   (fp32) or 2e-2 (bf16) of its own largest |output|; bf16 both in the
   (B, H, S, hd) layout and as the transposed (B, S, H, hd) view the model
   hands the kernel (timed too). For each bf16 serving shape it prints
   TFLOP/s, the share of the bound and the ratio to that call; for every
   kernel instance the registers and spills (ptxas) and, from
   ``cuobjdump -sass``, the highest register and the count of ``HGMMA``
   (``wgmma``) instructions, which must be nonzero in every bf16 instance.
6. Serving gemma2-2b at full width and full depth (26 layers, bf16,
   random weights from a seeded generator): (0) the kernel route of the
   prefill against the ``attend`` path at full width, 2 layers, fp32;
   (a) ``generate`` on 4 prompts of 8160 tokens, greedy, 32 new tokens,
   buf_len 8192 — the main path, launch counters zeroed just before and
   read just after — then the same call traced with ``torch.profiler``
   (8 new tokens: device busy time, idle share, the longest kernels, the
   share of the traced prefill taken by the ``swa*`` kernels);
   (b) one prompt through ``make_state`` +
   ``prefill_chunk`` in chunks of 512; (c) the continuous-batching
   launcher ``repro_torch.launch.serve.main`` at full width, depth cut
   to 2 layers (``SERVE_LAYERS``: the run's time limit), as every
   launcher drill runs (``_launcher_drill``, ``DRILLS``: 4 slots, chunks
   of 64): first (c0) the batched slot step (``serving.slot_step``, one
   ``decode_step`` over the 4 rows) against the per-slot loop
   (``slot_step_loop``) on a table of 4 requests at different indices,
   one switched off, 8 teacher-forced steps (each active row's bf16
   logits within 2e-2 of its scale, lanes equal, the inactive row bit
   for bit; a MoE config routes each row as its own group and drops
   nothing), then the stream, with one forward a decode step asserted
   (a counter around ``decode_step``) and forwards, steps, tokens/s,
   mean TTFT and decode ms a step printed.
7. SSD kernel: ptxas's registers and spills and a ``cuobjdump -sass``
   census of every ``ssd_kernel`` instance (highest register, HMMA and
   HGMMA counts: the phase fails unless each instance runs its products
   on the tensor cores) and the launch geometry at the three timed
   shapes; ``ssd_chunks`` against its plain version (fp32, TF32 off) on
   the three cases of ``tests/test_kernels.py``, then in the model's
   layout a ragged sequence (S = 70 in chunks of 32) and the serving
   shape (B = 4, S = 8160 -> 64 chunks of 128 with a 96-token last one,
   H = 112, P = N = 64, B_ / C_ as strided column slices, decay spanning
   A = 1..8), launched twice there (the two results must be bit-equal);
   then a 512-token chunk of the chunked prefill (1, 512, 112) and the
   launcher's 64-token chunk (1, 64, 112). Every output held to 1e-4 of
   its scale. Times kernel and plain version at the three shapes (CUDA
   events, median of 20 after 3 warm-ups) beside the bound of the
   kernel's route (bytes, or 3xTF32 operations over the TF32 peak), with
   the fp32 CUDA-core bound kept beside it. No single PyTorch call
   computes this function.
8. Serving zamba2-7b at full width and full depth (81 layers: 68 Mamba2
   blocks and 13 occurrences of one shared attention + MLP block, bf16,
   5,737,416,000 random parameters from a seeded generator): (0) one
   Mamba2 block's kernel route against the plain ``_ssd_chunked`` route
   at full width, fp32, S = 1024, with non-zero carried-in states;
   (a) ``generate`` on 4 prompts of 8160 tokens, greedy, 32 new tokens,
   buf_len 8192 (counters zeroed just before and read just after: 68
   ``ssd_chunks`` and 13 ``swa_attention`` launches), then the same call
   traced (8 new tokens) with CUDA events around each SSD scan and its
   kernel, and the share of the traced prefill taken by the ``swa*``
   kernels; (b) one prompt in chunks of 512 (carried ssm and conv states);
   (c) the serving launcher drill at 6 layers (``SERVE_LAYERS``): 5
   requests of 256 / 512 / 1024 / 256 / 512 tokens, 4 slots, chunk 64,
   16 new tokens.
9. sLSTM kernel: its launch geometry at every head dim (blocks per
   cluster, batch group, rows of R in registers and in shared memory,
   shared bytes) with ``cudaOccupancyMaxActiveClusters``' count, and
   ptxas's registers and spills (the P = 512 instance must not spill).
   ``slstm_steps`` against its plain version on the four cases of
   ``tests/test_kernels.py``, a carried state, T = 1, the reduced config's
   P = 128; then the serving shape (B = 4, T = 4096, H = 4, P = 512) on
   the model's own gates, launched twice (the two results must be
   bit-equal): g_in = xi @ w_gates + b_gates of a
   real xlstm-350m sLSTM block (its seeded init, bf16) on a random
   prompt, reshaped head-major as the model does, so the forget bias of 3
   lands on every gate of head 2 and on no gate of heads 0, 1, 3. Error
   per head beside that head's plain fp32-vs-fp64 drift: a head is held
   to 1e-4 of its scale, or, where its own fp32 arithmetic drifts further
   over 4096 chaotic steps, to twice that drift. The same gates over
   their first 512 steps (a strided view), before chaos amplifies
   rounding: every head held to 1e-4. Then the serving shape with a
   forget bias of 3 on every head (not the model's layout), held to 1e-4.
   Then xlstm-350m's 512-token chunk (1, 512, 4, 512), a B
   above one batch group (9, 64, 4, 512) and the batched slot step's
   decode (4, 1, 4, 512, carried), after the serving shape so that
   their draws are those of the cases before them. Times kernel (median of 20
   after 3 warm-ups) and plain version (median of 3) on the model's
   gates; then the kernel at the
   serving, chunk and decode (4, 1, 4, 512) shapes, in CUDA events around
   each call and in device time (20 calls queued behind a sleep kernel,
   so that at T = 1 the launch's host cost does not count), with
   microseconds a step and the share of the bound; and the h exchange alone at the serving geometry, microseconds a
   step, for each protocol of ``EXCHANGES`` (``slstm_exchange_probe``).
   No single PyTorch call computes this recurrence.
10. Serving xlstm-350m at full width and full depth (24 layers: 18 mLSTM
   and 6 sLSTM blocks, bf16, 555,246,736 random parameters from a seeded
   generator): (0) one sLSTM block's kernel route against its plain route
   (fp32, S = 1024, a carried state) and one mLSTM block's chunked form
   (256) against its per-step one (fp32, S = 512); (a) ``generate`` with
   ``xlstm_chunk = 256`` on 4 prompts of 4096 tokens, greedy, 32 new
   tokens (counters zeroed just before and read just after: 6
   ``slstm_steps`` launches in the prefill and 6 in each decode step),
   then the same call traced (8 new tokens), with the share of the traced
   prefill taken by its 6 ``slstm`` kernels; (b) one prompt in chunks of
   512 (and, for information, one-shot against chunked in fp32 at 1024
   and 4096 tokens); (c) the serving launcher drill on the published
   config (``xlstm_chunk = 0``) at 4 layers (``SERVE_LAYERS``): 5
   requests of 256 / 512 / 1024 / 256 / 512 tokens, 4 slots, chunk 64,
   16 new tokens; every decode step's ``slstm_steps`` at B = 4, T = 1.

11. The tree path's pair: ``sq_dist`` and ``apply_update`` against their
   plain versions on the cases of ``tests/test_kernels.py`` (n = 128 to
   40001) in fp32, bf16 and bf16 x with fp32 a, a row at an odd element
   offset, and the slice's leaves (``embed`` / ``lm_head``, n =
   262,144,000; a stacked MLP leaf, n = 180,355,072) in bf16 x / fp32 a
   and fp32 / fp32; two ``sq_dist`` calls must give the same bits. Times
   kernel, plain version and one PyTorch call (``torch.dist(x, a) ** 2``,
   ``torch.lerp``; fp32 / fp32) at n = 262,144,000 (CUDA events, median of
   20 after 3 warm-ups).
12. The tree path: yi-6b at full width, 4 layers, bf16 stacked leaves with
   fp32 momentum, ``engine="tree"``, as phase 3 otherwise (M = 4,
   simple_avg, tau 4, 16 steps). Counters zeroed just before the four
   rounds and read just after: 48 ``sq_dist`` and 48 ``apply_update``
   launches a round (M x 12 leaves). Then one ``easgd`` round (pull, then
   push): 144 and 48. Then, on the full-width state, one Eq. 5 round on
   the kernels against the same round on ``ref.py``'s plain functions,
   leaf by leaf.
13. The overlap modes: yi-6b at full width, 4 layers, as phase 3
   otherwise, through ``make_round_step``: ``staleness1``, ``doublebuf``
   (4 chunks), ``staleness_k`` k = 1 elastic (row 2 dropped through
   ``set_participation`` in rounds 1-2, forced back in at round 2 after k
   misses, ``sync = 0`` in round 3); then ``staleness_k`` k = 2 elastic at
   2 layers (a ring of two does not fit at 4; the reckoning is printed),
   6 rounds, row 2 out in rounds 2-4, ``sync = 0`` in round 5. Counters
   zeroed before each round and held to the launches the code implies;
   a frozen row and every row of a ``sync = 0`` round bit-exact; peak
   memory under 70 GB. Prints round ms (host clock, synchronised),
   boundary ms (CUDA events around the consensus application after the
   local steps), the chunk Grams' ms (events around each
   ``stage_comm``) and peak memory for each, beside phase 3's. (c) On
   the doublebuf run's full-width state: one stale application on the
   kernels (4 strided ``partial_gram`` chunks, ``mix_from_gram`` with the
   ``stale_mix`` epilogue) against the same on ``ref.py``'s plain
   functions, each row within 1e-5 of its scale; the epilogue bit-equal
   to the plain ``q + (mix(s) - s)`` on the kernel's coefficients;
   times of the epilogue, ``mix_from_gram`` and a strided chunk Gram
   beside a contiguous one; then doublebuf in one chunk against
   staleness_k k = 1 in one chunk, 3 rounds at 1 layer, bit for bit.
   (d) The launcher with ``--overlap doublebuf --log-every-round``:
   one JSONL record a round, staleness 0 in round 0 and 1 after.
14. The paper's harness and measures (``repro_torch.benchmarks``): (a)
   the README quickstart through ``common.run_distributed`` (M = 4,
   alpha 0.1, lam 0.5, tau 4; 300 steps on the tree engine and on the
   flat engine, 100 DDP steps) on the card and on the CPU from the same
   weights (``mlp_init`` draws on a CPU generator): the card's width
   within 1e-3 of the CPU's, its errors within 0.5 points; counters
   zeroed just before each card run and held to what the code implies
   (tree: 24 ``sq_dist`` + 24 ``apply_update`` a round, 6 MLP leaves x 4
   workers, plus the final ``worker_dists``' 24 ``sq_dist``; flat: one
   ``fused_round`` a round plus those 24; DDP: none); wall seconds of
   each. (b) ``pullpush_fused`` (one ``leaf_gram`` and one ``leaf_mix``
   launch a call, over the tree's own leaves) against the tree
   ``pullpush`` (``sq_dist`` / ``apply_update``): the reference test's
   near-consensus case (M = 8, n = 4096, spread 1e-5: r within 1e-3,
   entries within 2e-3), then yi-6b's stacked bf16 tree at 4 layers, M =
   4: bit-equal (leaves, r) to the route it replaced (the engine's
   flatten, ``fused_round`` on the fp32 view, unflatten), against the
   tree route (r within 1e-5 relative, each entry within 2 bf16 ulps of
   the larger of its input and output); the peak memory above the tree
   of both routes; its time at full width (CUDA events, median of 5
   after 1 warm-up) beside the replaced route, each pass alone (median of
   20), the two-pass floor (the tree read twice and written once), the
   ``fused_round`` launch on the fp32 view, the tree route and the plain
   versions (median of 3). (c) ``mean_valley`` (Table 1's kappa 2, step 0.05, 120
   steps) and ``hessian_measures`` on the tree run's workers, on the card
   and on the CPU with the same draws: MV within 1e-4 relative,
   lambda_max, trace and Frobenius norm within 1e-3; seconds of each.
   (d) ``repro_torch.benchmarks.run --fast --only theorem1,table2,
   method_zoo`` in this process, table2 on the first of its two seeds
   (``HARNESS_TABLE2_SEEDS``: the run's time limit): its CSV rows
   printed, every number finite, ``fused_round`` and ``sq_dist``
   launched; seconds of each suite.
15. The sharded round on ``torch.distributed`` ranks, spawned from this
   script (two, then eight, on the one card: the transport is gloo, every
   collective staged through host memory; the kernels are built in phase
   1 and the ranks load them). (a) ``fused_round_sharded`` on each rank's
   column shard of the main path's (4, 1,216,385,024) view (2 shards of
   608,192,512 columns, seeds 15 and 16): out within 1e-6 of each row's
   scale of ``fused_round`` on the whole view (its columns are
   ``mix_shard`` of the shard with its coefficients, checked here), r
   within 1e-6; bit-equal (out, r, G) to the launch sequence it replaced
   (block partials, ``gram_coef``'s sum, the all-reduce, ``gram_coef``,
   ``mix_shard``); against its plain version within 1e-4; times (CUDA
   events, median of 20 after 3 warm-ups; plain: 5 after 1) of the
   composite on each rank alone (the other runs only the matching
   all-reduces) and on both at once, of the all-reduce, and of each
   launch alone; bound 3 R n_local 4 bytes / 3.35 TB/s. (b) The trainer:
   yi-6b at full width cut to 1 layer (n = 697,316,352), M = 4, tau 4,
   simple_avg, on the kernel route, meshes 2x1 and 1x2, overlap
   ``none`` (1 round), ``doublebuf`` (4 chunks, 2 rounds) and
   ``staleness_k`` k = 1 elastic (2 rounds) under 16(b)'s membership
   (row 2 out of round 1, which the quorum of 4 degrades; 16(b)'s clock:
   its ring slot gathered over ``ring_gather`` on 2x1) (``SH_OVERLAPS``),
   each rank's block within 2e-5 of the single-device run's
   parameter scale on 2x1 and 1e-3 on 1x2 (``SH_BAR`` says why), each
   round's consensus_dist within 1e-5 relative (each rank runs the
   single-device rounds alone first and keeps its blocks on the host).
   After its two rounds the staleness_k 2x1 shard saves its resume point
   (``RESUME_POINT``: each leaf gathered, rank 0 writing the one ~33.5 GB
   file), each rank's shard is overwritten and read back from its blocks
   of the file in place, and every tensor's bits must come back (sums of
   the bit patterns per row and 2^24 columns); 16(b) resumes from it;
   per rank: round times, the host seconds of the single-device turns
   and of making and sharding each mesh's state, host seconds in gathers
   and all-reduces, bytes staged, peak memory (their sum beside the
   card's); the counters are
   zeroed just before each sharded run. (c) The launcher: ``--sharded
   --arch yi-6b --smoke`` under ``torch.distributed.run`` with two ranks
   against the same run unsharded: per-round consensus_dist and
   pull_force within 1e-5 relative. (d) Eight ranks on the 2x2x2
   hierarchical mesh: the MLP, easgd, precise mode, 3 rounds, against the
   single-device rounds, each entry within eps32 * max(|x|, 1). Then the
   transport line: backend, ranks a card, bytes staged; NCCL is not
   verified on one card. ``python3 chip_smoke.py --phases 15`` runs
   phase 1 and this phase alone.
16. The fault-tolerant round loop (``train.Supervisor``, checkpoints,
   chaos plans). (a) The committed chaos plan
   ``results/chaos/plan_ci.json`` replayed through the launcher on 8
   ranks sharing the card over gloo, as (15d) spawns them, with the
   pinned command of ``results/chaos/events_ci.json`` (reduced yi-6b at
   d_model 32, 1 layer, ``--sharded`` staleness_k k = 2, quorum 7): rank
   0's ``supervisor events`` / ``counters`` lines must equal the file.
   (b) The supervised path at full width: yi-6b at full width cut to 1
   layer (n = 697,316,352; the launcher's config patched, ``_cut_depth``),
   one device, M = 4, tau 4, 16 steps, seq 64, batch 8, ``--overlap
   staleness_k --staleness 1 --elastic-drop 2,1,3 --quorum 4``: a
   straight run against one resumed with ``--ckpt`` from phase 15(b)'s
   sharded resume point after round 2 (a resume across meshes, 2x1 ->
   one device), their final parameters equal bit for bit and their eval
   loss within 1e-5 relative; the supervisor's events equal the same
   flags' run on the CPU (the smoke config), and the resumed run's those
   of rounds 2-3; the rounds' ms in the supervised loop
   (CUDA-synchronised host clock around each step) beside the plain
   ``for spec in clock.rounds`` loop's; the resume point's bytes and its
   load seconds. The machine takes at most 45 GiB of disk writes a call,
   so (b) writes nothing: the runs' final parameters are compared in
   memory. Counters are zeroed just before the straight run and read
   just after. (c) ``launch.train --smoke --ckpt`` on the card, then
   ``launch.serve --smoke --ckpt`` on the same file. ``python3
   chip_smoke.py --phases 15,16`` runs phase 1 and phases 15 and 16
   alone (16 resumes from 15's resume point).
17. The MoE, enc-dec and vlm families (bf16, random weights from seeded
   generators on the card). First ``swa_attention`` against its plain
   version (bf16, each query row within 2e-2 of its scale, both layouts)
   and timed beside ``scaled_dot_product_attention`` at every shape this
   phase's serving paths launch it (``ATTN_FAMILIES``: hd 128 GQA causal
   with 6, 5 and 2 heads a kv head, seamless's hd 64 causal
   self-attention and its non-causal encoder pass and cross-attention, in
   (a)'s prefill, (b)'s 512-token chunks and (c)'s 64-token chunks; a
   census of (a)-(c) fails on a launch at any other shape). Then, for dbrx-132b cut to 6 of 40 layers,
   llama4-scout-17b-a16e cut to 10 of 48, internvl2-2b at its 24 layers
   with a 256-patch prefix and seamless-m4t-medium at its 12 + 12 layers
   over 1536 frames (``FAMILIES``): (0) the kernel route of the serving
   prefill against ``attend`` at full width in fp32 (1 MoE layer, 2 dense
   layers, seamless's 1 + 1: its encoder pass, causal self-attention and
   non-causal cross-attention), 1e-4 of the scale; (a) ``generate`` on 4
   prompts (8160 positions; seamless 2048 tokens), greedy, 32 new tokens,
   counters zeroed just before and read just after (``swa_attention``: 6,
   10, 24 and 12 + 12 + 12 launches), prefill ms, decode ms a token, peak
   memory, and for dbrx a traced prefill; (b) one prompt through
   ``make_state`` + ``prefill_chunk`` in chunks of 512; (c) the serving
   launcher drill at ``SERVE_LAYERS``' depth, 4 requests, 8 new tokens
   (seamless's requests carry their frames). (d) Training at full width on
   the flat engine's kernel mode, as phase 3 (M = 4, tau 4, seq 64, batch
   8, 2 rounds; ``FAMILY_TRAIN``): seamless-m4t-medium cut to 2 + 2 of its
   12 + 12 layers, internvl2-2b to 12 of 24, zamba2-7b to 18 of 81 on the
   plain SSD route, xlstm-350m to 4 of its 24 blocks on the plain sLSTM
   loop and the chunkwise mLSTM (``xlstm_chunk = 16``) at learning rate 0.01,
   the round batches carrying frames / the prefix; round ms, consensus
   ms, peak memory, ``fused_round`` launches. ``python3 chip_smoke.py
   --phases 17`` runs phase 1 and this phase alone.
18. The autotune search. (a) ``train.autotune`` through the port's API:
   ``make_round_probe_runner(device="cuda")`` on yi-6b at full width and
   ``LAYERS``, M = 4, ``doublebuf`` with staleness 1, sequences of
   ``TUNE_SEQ`` = 2048 tokens, batches 1-6, taus (4, 8), chunks (1, 2, 4),
   6 probes (``TUNE_SPACE``), ``make_lm_model_fn`` as the model, no
   injected fault. Every probe printed (batch, tau, chunks, ok, measured
   and modeled µs, seconds, peak, the memory allocated before and after
   it, the exception it raised, its launches). It fails unless a probe
   met a real ``torch.cuda.OutOfMemoryError``, each probe left the
   allocated memory within 4 MiB of where it found it, the chosen batch
   is the ladder's largest feasible one, the failures are sorted and
   unique, the budget held, ``dominates_model`` holds, the saved plan
   re-dumps byte for byte after ``TunePlan.load``, and each feasible
   probe launched ``partial_gram``, ``mix_from_gram`` and ``stale_mix``
   and no ``gram_coef``. (b) ``launch.train --smoke --autotune --tune-oom-above
   3 --tune-plan P``, then ``--tune-plan P`` alone: equal round plans
   (``RoundClock.describe()``), finite losses, batch 3 chosen. ``python3
   chip_smoke.py --phases 18`` runs phase 1 and this phase alone (``2``
   and ``14`` run phase 2 and phase 14 alone).
19. Launch analysis against the card (``launch/roofline.py``,
   ``validate.py``, ``dryrun.py``). (a) Phase 3's round (yi-6b, 4
   layers, M = 4, tau 4) traced on meta by ``analyze_step``: each
   kernel's calls must equal phase 3's launches a round; the modelled
   round (``roofline`` / ``overlap_model`` on the counted flops and
   bytes) is printed beside phase 3's measured round and their ratio.
   (b) ``torch.cuda.memory_allocated()`` between phase 12's rounds
   within 1% of ``validate``'s formula (params bf16 + momentum fp32) x
   M, else the buffer that differs is named; the tree engine's
   persistent state builds at the largest yi-6b depth whose formula fits
   the card's ``total_memory``, the next depth raises a real
   ``OutOfMemoryError``, and 0 B are left allocated (this part runs
   before phase 2, while the process holds the least of the card: see
   ``_state_against_total_memory``). (c) The dry-run CLI
   (yi-6b ``train_4k`` at 1 and 32 nodes, gemma2-2b ``decode_32k``) into
   a fresh directory and the ``roofline`` suite row on it. (d)
   ``--sharded --autotune`` of the smoke config under torchrun on two
   ranks: both ranks print the sha256 of the plan file rank 0 writes,
   and rank 1 probes nothing. ``python3 chip_smoke.py --phases 19`` runs
   phase 1, phases 3 and 12 (whose numbers it reads) and this phase.
20. Tensor-parallel serving over the ``model`` axis
   (``models/parallel.py``): two ranks share the card over gloo, a flat
   (data = 1, model = 2) mesh. ``swa_attention`` is first held against
   its plain version at the ranks' shapes (``ATTN_TP``). Then qwen2-72b
   (full width, 4 of 80 layers, QKV bias; B = 2, S = 2048) and dbrx-132b
   (full width, 2 of 40 layers, 8 experts a rank; B = 4, S = 2048, its
   prompt drawn from 16 token ids, so that capacity drops happen), each
   from the seeded full tree: one rank
   runs ``generate`` (greedy, 16 new tokens), then a teacher-forced pass
   on its own tokens; the ranks cut their shards with ``shard_params``
   from the same seeded tree and run the same ``generate`` (the main
   path; kernel counts, the collectives' census and the staged bytes
   zeroed just before it), then the teacher-forced pass on the one-rank
   tokens. It fails unless every rank holds the same tokens, launches
   ``swa_attention`` once a layer a prefill on nq / 2 over nkv / 2 heads,
   holds each step's logits within ``TP_TOL`` of its row's largest
   |logit| of one rank's, picks the one-rank greedy token wherever the
   one-rank top-2 margin exceeds ``TP_TOL``, and (dbrx) drops the same
   entries as one rank on the one-rank prefill's MoE inputs. A row whose
   own token the ranks routed apart from one rank (bf16 sums in another
   order can flip a near tie, and a token behind it in its expert's
   queue is then kept or dropped apart) is not held to ``TP_TOL``; at
   most ``TP_APART`` of the tokens may route apart, and every token kept
   or dropped apart must follow one routed apart. On one rank's own
   prefill MoE inputs a rank must route every entry as one rank does,
   but at a router-logit gap below ``TP_TIE``. Each rank prints
   its prefill ms and decode ms a token, its census of collectives by
   kind, axis and bytes, the bytes and seconds staged through host memory
   and its peak memory against half of one rank's.
   ``python3 chip_smoke.py --phases 20`` runs phase 1 and this phase.

It prints a ``kernels`` line, the ``{"kernels": [...]}`` record and, last,
``{"ok": true, "device": {...}}``. It imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ROOT = os.path.dirname(os.path.abspath(__file__))
# H100 SXM published peaks (NVIDIA's data sheet): HBM bytes/s and
# fp32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
SHAPES = ((4, 300), (8, 4097), (5, 2 ** 26 + 3), (32, 65537))
MAIN_R, MAIN_N = 4, 1_216_385_024
# the slice's depth and local-step learning rate (the launcher's default);
# PERF.md records the numbers of this depth and rate
LAYERS, LR = 4, 0.3
# phases 3 and 12 (and 19's trace of phase 3's round): workers, tau,
# steps, sequence length, batch a worker
SLICE_RUN = (4, 4, 16, 64, 8)
TOL = 1e-4          # max abs error relative to the output's scale
SOURCE = "src/repro_torch/kernels/pullpush/csrc/pullpush.cu"
# H100 SXM dense bf16 and TF32 tensor-core peaks (NVIDIA's data sheet)
BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
# swa_attention cases: (B, H, Hkv, Sq, Skv, hd, window, cap, causal); the
# first six are tests/test_kernels.py::ATTN_CASES
ATTN_CASES = (
    (1, 4, 4, 128, 128, 64, 0, 0.0, True),
    (2, 4, 2, 256, 256, 64, 0, 0.0, True),
    (1, 8, 4, 384, 384, 128, 128, 0.0, True),
    (1, 2, 1, 512, 512, 64, 0, 50.0, True),
    (2, 4, 4, 200, 200, 64, 96, 30.0, True),
    (1, 4, 2, 128, 1024, 64, 256, 0.0, True),
    (1, 2, 1, 128, 200, 64, 0, 0.0, False),     # ragged, not causal
    (1, 2, 1, 300, 200, 64, 0, 0.0, True),      # Sq > Skv
    (1, 4, 4, 200, 200, 112, 96, 30.0, True),   # zamba2-7b's head_dim
    (2, 8, 4, 333, 333, 256, 96, 50.0, True),   # gemma2-2b's, small
)
# the serving shapes: gemma2-2b's local and global layers at S = 8160,
# and the cap 0 / window 0 case one PyTorch call computes
SERVE_S = 8160
# the serving launchers of phases 6(c), 8(c), 10(c) and 17(c) at a cut
# depth: their host-bound decode costs time in proportion to the layers,
# and the whole run must end within its limit (the models' (a) and (b)
# parts stay at full depth). gemma2-2b 2 of 26 layers (1 local + 1
# global), zamba2-7b 6 of 81 (5 Mamba2 + 1 shared attention),
# xlstm-350m 4 of 24 (3 mLSTM + 1 sLSTM)
SERVE_LAYERS = {"gemma2-2b": 2, "zamba2-7b": 6, "xlstm-350m": 4,
                # phase 17(c): dbrx-132b and llama4-scout-17b-a16e 2 of 40
                # / 48 (13.0 / 8.8 GB of weights), internvl2-2b 4 of 24,
                # seamless-m4t-medium 4 of its 12 decoder layers (all 12
                # encoder layers)
                "dbrx-132b": 2, "llama4-scout-17b-a16e": 2,
                "internvl2-2b": 4, "seamless-m4t-medium": 4}


@contextlib.contextmanager
def _cut_depth(launcher, layers):
    """A launcher module whose ``get_arch`` returns the full config cut to
    ``layers`` layers, widths unchanged (the launchers themselves cut
    only the smoke config)."""
    orig = launcher.get_arch
    launcher.get_arch = lambda name: dataclasses.replace(orig(name),
                                                         n_layers=layers)
    try:
        yield
    finally:
        launcher.get_arch = orig


def _serve_cut(argv):
    """``launch.serve.main(argv)`` on the card with ``--arch``'s config at
    its ``SERVE_LAYERS`` depth."""
    from repro_torch.launch import serve
    with _cut_depth(serve, SERVE_LAYERS[argv[argv.index("--arch") + 1]]):
        return serve.main(argv)


# the launcher drills of phases 6(c), 8(c), 10(c) and 17(c): each arch's
# request stream (requests, prompt length, new tokens; 4 slots, chunks of
# 64) and the kernels the stream must launch. Prompts of p/2, p and 2p
# tokens each end in a tail of up to 64 tokens fed through the decode
# step; 5 requests (zamba2-7b, xlstm-350m) so that one is admitted
# mid-stream
DRILLS = {"gemma2-2b": (8, 512, 32, ("swa_attention",)),
          "zamba2-7b": (5, 512, 16, ("ssd_chunks", "swa_attention")),
          "xlstm-350m": (5, 512, 16, ("slstm_steps",)),
          "dbrx-132b": (4, 256, 8, ("swa_attention",)),
          "llama4-scout-17b-a16e": (4, 256, 8, ("swa_attention",)),
          "internvl2-2b": (4, 256, 8, ("swa_attention",)),
          "seamless-m4t-medium": (4, 256, 8, ("swa_attention",))}
DRILL_SLOTS = 4
# the card-side parity check of the batched slot step before each drill's
# stream: prompts a slot (different indices; the vlm's and the enc-dec
# model's requests carry their own prefix / frames), the slot switched
# off, teacher-forced steps, and the bf16 bar (each logits row, of its
# scale)
PARITY_LENS = (70, 135, 200, 260)
PARITY_OFF = 2
PARITY_STEPS = 8
PARITY_TOL = 2e-2


def _drill_argv(arch):
    requests, prompt, new, _ = DRILLS[arch]
    return ["--arch", arch, "--requests", str(requests), "--max-slots",
            str(DRILL_SLOTS), "--prompt-len", str(prompt), "--new-tokens",
            str(new), "--chunk", "64"]


def _copy_table(engine, slots):
    """Another slot table holding the same numbers."""
    from repro_torch.core.engine import tree_items
    out = engine.blank_slots()
    for (_, dst), (_, src) in zip(tree_items(out["rows"]),
                                  tree_items(slots["rows"])):
        dst.copy_(src)
    for lane in ("index", "gen", "budget", "key", "active"):
        out[lane] = slots[lane].clone()
    return out


def _slot_parity(launched):
    """(c0) The batched slot step (``serving.slot_step``: one forward over
    the 4 rows) against its plain version, the per-slot loop
    (``slot_step_loop``), on an engine over the launcher's model and
    weights (its own, so that the launcher's lanes keep their one
    signature): a table with a request in each slot (PARITY_LENS prompt
    tokens, so each row at its own index; prefix or frames of its own, a
    vlm's rows starting at P), slot PARITY_OFF switched off,
    PARITY_STEPS teacher-forced steps through each path on copies of the
    table. Each active row's logits within PARITY_TOL of its scale, the
    lanes equal, the inactive row's state bit-identical to what it held;
    a MoE config's batched steps route every row as its own group and
    drop no entry."""
    from repro_torch.core.engine import tree_items
    from repro_torch.models import moe as moe_lib
    from repro_torch.serving import SlotEngine, slot_step, slot_step_loop
    model, params, cfg = launched.model, launched.params, launched.model.cfg
    gen = torch.Generator().manual_seed(28)
    context = "enc" if cfg.n_enc_layers else "prefix"

    def batch(ctx):
        out = {"tokens": np.zeros((1, 1), np.int32)}
        if cfg.n_prefix:
            out[context] = ctx((1, cfg.n_prefix, cfg.d_model))
        return out
    engine = SlotEngine(model, params, max_slots=DRILL_SLOTS,
                        buf_len=launched.buf_len, window=launched.window,
                        chunk=launched.chunk, sampling=launched.sampling,
                        example=batch(lambda shape: np.zeros(shape,
                                                             np.float32)))
    slots = engine.blank_slots()
    for s, n in enumerate(PARITY_LENS):
        state, start = engine.request_state(batch(lambda shape: 0.02 * (
            torch.randn(shape, generator=gen).numpy())))
        prompt = torch.randint(0, cfg.vocab_size, (n,), generator=gen)
        state, idx, _ = engine.prefill_chunks(state, prompt.numpy(), start)
        slots = engine.insert(slots, state, s, idx, s - 1, 1000, 100 + s)
    slots["active"][PARITY_OFF] = False
    loop = _copy_table(engine, slots)
    frozen = [t.clone() for _, t in
              tree_items(engine.slot_state(slots, PARITY_OFF))]
    live = [s for s in range(DRILL_SLOTS) if s != PARITY_OFF]
    routed = []
    orig = moe_lib.moe_mlp

    def recorded(p, x, cfg_, per_row=False):
        routed.append((per_row,
                       moe_lib.dropped_entries(p, x, cfg_, per_row=per_row),
                       moe_lib.dropped_entries(p, x, cfg_)))
        return orig(p, x, cfg_, per_row=per_row)
    worst, same = 0.0, 0
    for _ in range(PARITY_STEPS):
        toks = torch.randint(0, cfg.vocab_size, (DRILL_SLOTS,),
                             generator=gen).numpy()
        moe_lib.moe_mlp = recorded
        try:
            nxt, logits = slot_step(model, params, slots, toks,
                                    engine.window, engine.sampling)
        finally:
            moe_lib.moe_mlp = orig
        want, want_logits = slot_step_loop(model, params, loop, toks,
                                           engine.window, engine.sampling)
        got, ref = logits[live].float(), want_logits[live].float()
        scale = ref.abs().amax(dim=-1).clamp(min=1e-30)
        worst = max(worst, float(((got - ref).abs().amax(dim=-1)
                                  / scale).max()))
        same += int((nxt[live] == want[live]).sum())
    lanes_equal = all(torch.equal(slots[k], loop[k])
                      for k in ("index", "gen", "active"))
    still = all(torch.equal(t, f) for (_, t), f in zip(
        tree_items(engine.slot_state(slots, PARITY_OFF)), frozen))
    out = {"steps": PARITY_STEPS, "max_rel_err": worst,
           "tokens_equal": f"{same}/{PARITY_STEPS * len(live)}",
           "lanes_equal": lanes_equal, "inactive_bit_identical": still,
           "indices": slots["index"].tolist()}
    if cfg.n_experts:
        out["moe_calls_per_row"] = sum(r[0] for r in routed)
        out["dropped_per_row"] = int(sum(int(r[1]) for r in routed))
        out["dropped_if_one_group"] = int(sum(int(r[2]) for r in routed))
    del slots, loop, frozen
    print("  (c0) batched slot step vs the per-slot loop " + json.dumps(out))
    if not worst <= PARITY_TOL:
        raise AssertionError(f"{cfg.name}: batched step's logits differ "
                             f"from the loop's: {worst:.3e} > {PARITY_TOL}")
    if not (lanes_equal and still):
        raise AssertionError(f"{cfg.name}: lanes differ or the inactive "
                             "row moved")
    if cfg.n_experts and (out["dropped_per_row"] or out["moe_calls_per_row"]
                          != PARITY_STEPS * cfg.n_layers):
        raise AssertionError(f"{cfg.name}: the batched step did not route "
                             f"each row as its own group: {out}")
    return out


def _launcher_drill(arch, kernels, batched=True):
    """(c) The continuous-batching launcher (``launch.serve.main``) at full
    width and ``SERVE_LAYERS``' depth on ``DRILLS[arch]``'s stream, with a
    counter around the model's ``decode_step`` and the host clock around
    each engine step (it ends in the sampled tokens' read-back). Before
    the warm-up stream, ``_slot_parity`` on the launcher's own engine.
    ``kernels``: {name: kernel module} whose kernels the timed stream must
    launch (counters zeroed just before it). Asserts one forward a decode
    step and, for xlstm-350m, the decode's ``slstm_steps`` at B = the
    slots. ``batched=False`` (another tree, ``tools/serve_drills.py``)
    only measures. Returns the drill's numbers."""
    from repro_torch.launch import serve as launcher
    from repro_torch.models import xlstm as xlstm_lib
    forwards, step_s, runs, out = [0], [], [], {}
    orig_build, orig_serve = launcher.build_model, launcher.serve

    def build(cfg):
        model = orig_build(cfg)

        def counted(*a, **kw):
            forwards[0] += 1
            return model.decode_step(*a, **kw)
        return dataclasses.replace(model, decode_step=counted)

    def serve(engine, requests, **kw):
        if batched and not runs:
            out["parity"] = _slot_parity(engine)
        if len(runs) == 1:              # the timed stream
            for m in kernels.values():
                m.reset_launches()
        decode = engine.decode

        def timed(slots, toks):
            t0 = time.perf_counter()
            res = decode(slots, toks)
            step_s.append(time.perf_counter() - t0)
            return res
        engine.decode = timed
        f0, n0 = forwards[0], len(step_s)
        try:
            report = orig_serve(engine, requests, **kw)
        finally:
            del engine.decode
        runs.append((report, forwards[0] - f0, step_s[n0:]))
        return report

    shapes = []
    orig_slstm = getattr(xlstm_lib, "slstm_steps", None)

    def slstm_probe(g_in, R, state, out_state=None):
        shapes.append(tuple(g_in.shape[:2]))
        return orig_slstm(g_in, R, state, out_state)
    launcher.build_model, launcher.serve = build, serve
    if batched and "slstm_steps" in kernels:
        xlstm_lib.slstm_steps = slstm_probe
    try:
        report = _serve_cut(_drill_argv(arch))
    finally:
        launcher.build_model, launcher.serve = orig_build, orig_serve
        if orig_slstm is not None:
            xlstm_lib.slstm_steps = orig_slstm
    (warm, warm_fw, _), (_, fw, secs) = runs
    launches = {n: m.LAUNCHES[n] for n, m in kernels.items()}
    requests, _, new, _ = DRILLS[arch]
    out.update({"layers": SERVE_LAYERS[arch], "steps": report.steps,
                "forwards": fw, "forwards_per_step": fw / report.steps,
                "generated": report.generated,
                "occupancy": report.occupancy, "wall_s": report.wall_s,
                "tok_s": report.tok_s,
                "ttft_mean_ms": report.ttft_mean_s * 1e3,
                "decode_ms_per_step": 1e3 * statistics.mean(secs),
                "decode_ms_median": 1e3 * statistics.median(secs),
                "launches": launches})
    if shapes:
        out["slstm_decode_launch_shapes"] = sorted(set(shapes))
    print("  (c) launcher " + json.dumps(out))
    if sorted(report.results) != list(range(requests)) or any(
            len(r.tokens) != new for r in report.results.values()):
        raise AssertionError(f"{arch}: the launcher left requests "
                             "unfinished")
    if not all(launches.values()):
        raise AssertionError(f"{arch}: the launcher's stream launched "
                             f"none of some kernel: {launches}")
    if batched and (fw != report.steps or warm_fw != warm.steps):
        raise AssertionError(f"{arch}: {fw} forwards in {report.steps} "
                             "decode steps, not one a step")
    if batched and "slstm_steps" in kernels:
        # the parity check's batched steps, the warm-up's and the timed
        # stream's: n_slstm launches each, all at B = the slots, T = 1
        from repro_torch.configs import get_arch
        n_slstm = dataclasses.replace(
            get_arch(arch), n_layers=SERVE_LAYERS[arch]).blocks().count(
                "slstm")
        want = n_slstm * (PARITY_STEPS + warm.steps + report.steps)
        if set(shapes) != {(DRILL_SLOTS, 1)} or len(shapes) != want:
            raise AssertionError(
                f"{arch}: the batched decode launched slstm_steps "
                f"{len(shapes)} times at {sorted(set(shapes))}, not {want} "
                f"at B = {DRILL_SLOTS}, T = 1")
    return out


ATTN_SLICE = {
    "local": (4, 8, 4, SERVE_S, SERVE_S, 256, 4096, 50.0, True),
    "global": (4, 8, 4, SERVE_S, SERVE_S, 256, 0, 50.0, True),
    "library": (4, 8, 4, SERVE_S, SERVE_S, 256, 0, 0.0, True),
    # zamba2-7b's shared attention: 32 heads over 32 kv heads, hd 112
    "zamba2": (4, 32, 32, SERVE_S, SERVE_S, 112, 0, 0.0, True),
}
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
ATTN_SOURCE = "src/repro_torch/kernels/swa_attention/csrc/swa_attention.cu"
ATTN_REPLACES = "src/repro/kernels/swa_attention/swa_attention.py:85"
# ssd_chunks cases: (B, H, nc, L, P, N), tests/test_kernels.py::SSD_CASES
SSD_CASES = (
    (1, 2, 2, 32, 16, 8),
    (2, 4, 3, 64, 32, 16),
    (1, 1, 4, 128, 64, 64),
)
# in the model's layout, (Bt, S, H, P, N, L): a ragged last chunk (70 =
# 2 x 32 + 6), and zamba2-7b's prefill
SSD_RAGGED = (2, 70, 3, 16, 8, 32)
SSD_SLICE = (4, SERVE_S, 112, 64, 64, 128)
# checked and timed after the serving shape, so that the draws above stay
# as they were: a 512-token chunk of zamba2-7b's chunked prefill and the
# serving launcher's 64-token chunk
SSD_MORE = {"chunk512": (1, 512, 112, 64, 64, 128),
            "launcher64": (1, 64, 112, 64, 64, 128)}
SSD_SOURCE = "src/repro_torch/kernels/mamba_scan/csrc/mamba_scan.cu"
SSD_REPLACES = "src/repro/kernels/mamba_scan/mamba_scan.py:46"
# zamba2-7b's parameter tree, counted from the reference's init
ZAMBA2_PARAMS = 5_737_416_000
# slstm_steps cases: (B, T, H, P, carried state); the first four are
# tests/test_kernels.py::SLSTM_CASES, then a carried state, T = 1, the
# reduced config's P = 128
SLSTM_CASES = (
    (2, 50, 2, 16, False),
    (1, 128, 4, 32, False),
    (2, 37, 2, 8, False),
    (1, 16, 1, 8, False),
    (2, 40, 3, 32, True),
    (3, 1, 4, 512, True),
    (2, 300, 4, 128, False),
)
# checked after the serving shape, so that its draws stay those above:
# xlstm-350m's 512-token chunk (B = 1), a B above one batch group (9 =
# 4 + 4 + 1), and the slot engine's batched decode step (B = max_slots
# = 4 of the launcher drill, T = 1, a carried state)
SLSTM_MORE_CASES = (
    (1, 512, 4, 512, False),
    (9, 64, 4, 512, True),
    (4, 1, 4, 512, True),
)
SLSTM_CHUNK = 512       # the chunked prefill's launch length
# xlstm-350m's prefill: B = 4 prompts of 4096 tokens, 4 heads of 512; its
# prefill in 512-token chunks (B = 1) and its decode step (T = 1)
SLSTM_SLICE = (4, 4096, 4, 512)
SLSTM_TIMED = {"serving": SLSTM_SLICE, "chunk": (1, 512, 4, 512),
               "decode": (4, 1, 4, 512)}
FORGET_BIAS = 3.0       # the forget part of b_gates (models/xlstm.py)
SLSTM_SOURCE = "src/repro_torch/kernels/slstm_step/csrc/slstm_step.cu"
SLSTM_REPLACES = "src/repro/kernels/slstm_step/slstm_step.py:79"
# xlstm-350m's parameter tree, counted from the reference's init
XLSTM_PARAMS = 555_246_736
REPLACES = {
    "fused_round": "src/repro/kernels/pullpush/pullpush.py:194",
    "partial_gram": "src/repro/kernels/pullpush/pullpush.py:298",
    "gram_coef": "src/repro/kernels/pullpush/pullpush.py:162",
    "mix_shard": "src/repro/kernels/pullpush/pullpush.py:319",
}
# the coefficient phase runs in the partial-Gram kernel's tail and in the
# mix's prologue: no main path launches gram_coef, and every census below
# holds it at 0 (it stays as their standalone counterpart, checked and
# timed in phase 2)
MERGED = {"gram_coef": ["partial_gram (its last block's tail)",
                        "mix_shard / stale_mix (the prologue, where the "
                        "Gram is given)"]}
# pullpush_fused's two passes over a stacked tree's own leaves (phase 2:
# small trees bit-equal to the flattened composite; phase 14(b): yi-6b)
LEAF_REPLACES = {
    "leaf_gram": "src/repro/kernels/pullpush/ops.py:26 (pullpush_fused: "
                 "flatten + fused_round's phase 0 and _coef, "
                 "src/repro/kernels/pullpush/pullpush.py:142)",
    "leaf_mix": "src/repro/kernels/pullpush/ops.py:26 (pullpush_fused: "
                "fused_round's phase 1 + unflatten, "
                "src/repro/kernels/pullpush/pullpush.py:142)",
}
# (M, leaves as (worker shape, dtype, element shift of the leaf's start)):
# sizes that are not multiples of 4, mixed dtypes, leaves that start off
# a 16-byte boundary, n a multiple of 4 (float4 groups that straddle
# leaves) and not, M from 2 to 32, and one tree large enough for a full
# grid of blocks
LEAF_CASES = (
    (4, (((3, 5), torch.bfloat16, 0), ((7,), torch.float32, 1),
         ((33, 2), torch.bfloat16, 0), ((1,), torch.float32, 0),
         ((101,), torch.bfloat16, 3))),
    (4, (((6,), torch.float32, 0), ((2, 5), torch.bfloat16, 1),
         ((1,), torch.bfloat16, 0), ((3,), torch.float32, 2),
         ((4,), torch.bfloat16, 0), ((4096,), torch.bfloat16, 0))),
    (2, (((4098,), torch.bfloat16, 1), ((6,), torch.float32, 0),
         ((20000,), torch.bfloat16, 2))),
    (8, (((32,), torch.float32, 0), ((64,), torch.bfloat16, 1),
         ((1024, 3), torch.float32, 0), ((3,), torch.bfloat16, 0))),
    (16, (((17,), torch.bfloat16, 0), ((300,), torch.float32, 0),
          ((4000,), torch.bfloat16, 0))),
    (32, (((17,), torch.bfloat16, 0), ((300,), torch.float32, 1),
          ((3,), torch.bfloat16, 0))),
    (4, (((1_000_003,), torch.bfloat16, 0), ((2_097_152,), torch.float32, 0),
         ((777,), torch.bfloat16, 1))),
)
# the tree path's pair (phase 11): the cases of tests/test_kernels.py
PAIR_REPLACES = {
    "sq_dist": "src/repro/kernels/pullpush/pullpush.py:90",
    "apply_update": "src/repro/kernels/pullpush/pullpush.py:110",
}
PAIR_N = {"sq_dist": (128, 1000, 32768, 40001),
          "apply_update": (256, 5000, 33000)}
# the slice's leaves: embed / lm_head, and one stacked MLP leaf (4 layers)
PAIR_SLICE_N = (262_144_000, 180_355_072)
# phase 13: (label, overlap settings, layers, rounds, elastic plan);
# a plan maps a round to (row dropped or None, sync)
OVERLAP_RUNS = (
    ("staleness1", dict(overlap="staleness1"), LAYERS, 4, None),
    ("doublebuf", dict(overlap="doublebuf", overlap_chunks=4), LAYERS, 4,
     None),
    ("staleness_k k=1 elastic", dict(overlap="staleness_k", staleness=1,
                                     elastic=True, overlap_chunks=4),
     LAYERS, 4, {1: (2, 1.0), 2: (2, 1.0), 3: (None, 0.0)}),
    ("staleness_k k=2 elastic", dict(overlap="staleness_k", staleness=2,
                                     elastic=True, overlap_chunks=4),
     2, 6, {2: (2, 1.0), 3: (2, 1.0), 4: (2, 1.0), 5: (None, 0.0)}),
)
OVERLAP_TOL = 1e-5      # each row of a stale application, of its scale
STALE_SOURCE = SOURCE
STALE_REPLACES = {
    "mix_from_gram": "src/repro/kernels/pullpush/pullpush.py:345",
    "stale_mix": "src/repro/kernels/pullpush/pullpush.py:319 (mix_shard) "
                 "+ src/repro/train/trainer.py:387 (q + (c_out - s))",
}
PAIR_DTYPES = ((torch.float32, torch.float32),
               (torch.bfloat16, torch.bfloat16),
               (torch.bfloat16, torch.float32))
SQ_DIST_RTOL = 1e-5     # the same numbers summed in fp32 in another order


def _time_ms(fn, reps=20, warm=3):
    """Median CUDA-event time of ``fn`` in ms."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def _profiled_ms(fn, kernel, reps=20):
    """Mean device time in ms of ``kernel``'s launches over ``reps`` calls
    of ``fn``, read from ``torch.profiler`` (CUPTI); None when the trace
    holds no device time for it."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for ev in prof.key_averages():
        if kernel in ev.key:
            us = getattr(ev, "device_time_total", None)
            total += ev.cuda_time_total if us is None else us
            count += ev.count
    return total / count / 1e3 if count and total > 0 else None


def _forms(G, T, coef):
    """Pre / post distance forms (zero-sum) of a Gram."""
    R = G.shape[0]
    eye = torch.eye(R, dtype=torch.float32, device=G.device)
    Vu = eye - 1.0 / R
    W = eye + coef[:, None] * (T - eye)
    f = lambda V: torch.sum((V @ G) * V, dim=1)
    return torch.cat([f(Vu), f(Vu @ W)])


class ErrLog:
    """Largest error per kernel, absolute and relative to the output's
    scale (max |plain output|); the relative one is held to TOL."""

    def __init__(self):
        self.abs = {k: 0.0 for k in (*REPLACES, *LEAF_REPLACES)}
        self.rel = {k: 0.0 for k in (*REPLACES, *LEAF_REPLACES)}

    def check(self, name, what, got, want):
        # column chunks: a full-width difference of the main path's view
        # would be one more 19.5 GB temporary
        got, want = got.reshape(got.shape[0], -1), want.reshape(
            want.shape[0], -1)
        err = max(float((g - w).abs().max()) for g, w in zip(
            got.split(1 << 24, dim=-1), want.split(1 << 24, dim=-1)))
        scale = max(float(want.max()), -float(want.min()), 1e-30)
        self.abs[name] = max(self.abs[name], err)
        self.rel[name] = max(self.rel[name], err / scale)
        if not err <= TOL * scale:
            raise AssertionError(f"{name} {what}: max abs err {err:.3e} > "
                                 f"{TOL} x {scale:.3e}")


def _merged_launched(counts, where):
    """Failures for a main path's census: the kernels of MERGED must not
    run there (their work runs in their neighbours)."""
    return [f"{where} launched {name} {counts[name]} times; its work runs "
            f"in {' and '.join(MERGED[name])}" for name in MERGED
            if counts.get(name, 0)]


def _inputs(R, n, gen):
    x = torch.randn((R, n), generator=gen, device="cuda")
    x.mul_(2.0).add_(1.0)
    T = torch.softmax(torch.randn((R, R), generator=gen, device="cuda"),
                      dim=1)
    c0 = torch.linspace(0.1, 0.5, R, device="cuda")
    c1 = torch.linspace(-0.4, -0.1, R, device="cuda")
    return x, T, c0, c1


def check_shape(pk, ref, errs, x, T, c0, c1):
    """Every kernel against its plain version on one input."""
    out, r, G = pk.fused_round(x, T, c0, c1)
    torch.cuda.synchronize()
    p_out, p_r, p_G = ref.fused_round_plain(x, T, c0, c1)
    coef = c0 + c1 / torch.clamp(p_r, min=1e-12)
    errs.check("fused_round", "out", out, p_out)
    errs.check("fused_round", "r", r, p_r)
    errs.check("fused_round", "G forms", _forms(G, T, coef),
               _forms(p_G, T, coef))
    del out
    Gk = pk.partial_gram(x)
    torch.cuda.synchronize()
    errs.check("partial_gram", "G forms", _forms(Gk, T, coef),
               _forms(p_G, T, coef))
    m = pk.mix_shard(x, T, coef)
    torch.cuda.synchronize()
    errs.check("mix_shard", "out", m, p_out)
    del m
    nblk = pk.workspace_blocks(x)
    ws = torch.stack([ref.partial_gram_plain(c)
                      for c in torch.tensor_split(x, nblk, dim=1)])
    g_G, g_r, g_coef = pk.gram_coef(ws, T, c0, c1)
    torch.cuda.synchronize()
    w_G = ref.gram_sum_plain(ws)
    w_r, w_coef = ref.gram_coef_plain(w_G, T, c0, c1)
    errs.check("gram_coef", "G", g_G, w_G)
    errs.check("gram_coef", "r", g_r, w_r)
    errs.check("gram_coef", "coef", g_coef, w_coef)
    if not torch.equal(g_G, w_G):
        raise AssertionError("gram_coef's G is not the plain fixed-order "
                             "sum bit for bit")
    return p_out, p_r, coef, ws


def check_sequences(pk, ref, x, T, c0, c1, stale=True):
    """The stages that run the coefficient phase in a neighbour kernel,
    bit for bit against the launch sequences they replaced: fused_round
    (partial Gram with its tail, mix) against block partials, gram_coef
    and mix_shard; mix_from_gram (the mix's prologue) against gram_coef on
    G as a one-block workspace and mix_shard, and with ``stale`` also its
    stale epilogue against gram_coef and stale_mix. At most two (R, n)
    buffers beside x."""
    out, r, G = pk.fused_round(x, T, c0, c1)
    ws = pk._launch_partial_gram(x, pk._vec(x), tail=False)
    o_G, o_r, o_coef = pk.gram_coef(ws, T, c0, c1)
    buf = pk.mix_shard(x, T, o_coef)
    same = {"fused_round": torch.equal(G, o_G) and torch.equal(r, o_r)
            and _equal(out, buf),
            "tail_G_is_the_plain_sum": torch.equal(G,
                                                   ref.gram_sum_plain(ws))}
    del ws
    _, g_r, g_coef = pk.gram_coef(G[None], T, c0, c1)
    pk.mix_shard(x, T, g_coef, out=buf)
    _, m_r, m_G = pk.mix_from_gram(x, T, c0, c1, G, out=out)
    same["mix_from_gram"] = torch.equal(m_r, g_r) and _equal(out, buf)
    if stale:
        q = torch.randn_like(x)
        pk.stale_mix(x, T, g_coef, q, out=buf)
        _, s_r, _ = pk.mix_from_gram(x, T, c0, c1, G, out=out, base=q)
        same["mix_from_gram stale"] = torch.equal(s_r, g_r) \
            and _equal(out, buf)
        del q
    del out, buf
    bad = [k for k, v in same.items() if not v]
    if bad:
        raise AssertionError(f"not bit-equal to the launches they replace: "
                             f"{bad}")
    return same


def _leaf_tree(M, spec, gen):
    """Stacked leaves (M, *shape) on the card, each in its dtype and
    starting ``shift`` elements into a buffer of its own (off any 16-byte
    boundary for shift not a multiple of 4 / 8), M workers around one
    model."""
    leaves = []
    for shape, dtype, shift in spec:
        size = math.prod(shape)
        v = torch.randn((1, size), generator=gen, device="cuda") \
            + 0.3 * torch.randn((M, size), generator=gen, device="cuda")
        buf = torch.empty((M * size + shift,), dtype=dtype, device="cuda")
        leaf = buf[shift:].view((M,) + shape)
        leaf.copy_(v.view((M,) + shape))
        leaves.append(leaf)
    return leaves


def _leaf_errs(pk, ref, errs, leaves, outs, r, G, T, c0, c1):
    """The leaf kernels against their plain versions: r and the Gram's
    forms against the plain Gram of the flattened view (fp32, TOL); the
    new leaves against the plain mix of that view on the kernel's own
    coefficients (gram_coef on G, the tail's arithmetic), cast back:
    bit for bit, as mix_shard against its plain version."""
    M = leaves[0].shape[0]
    flat = torch.cat([l.reshape(M, -1).float() for l in leaves], dim=1)
    p_G = ref.partial_gram_plain(flat)
    p_r, p_coef = ref.gram_coef_plain(p_G, T, c0, c1)
    errs.check("leaf_gram", "r", r, p_r)
    errs.check("leaf_gram", "G forms", _forms(G, T, p_coef),
               _forms(p_G, T, p_coef))
    _, _, coef = pk.gram_coef(G[None], T, c0, c1)
    ref.mix_shard_plain(flat, T, coef, out=flat)
    off = 0
    for o, l in zip(outs, leaves):
        size = l[0].numel()
        errs.check("leaf_mix", "leaf", o.reshape(M, -1).float(),
                   flat[:, off:off + size].to(l.dtype).float())
        off += size
    del flat


def check_leaves(pk, ref, errs):
    """pullpush_fused's two leaf kernels on LEAF_CASES: new leaves, r and
    G bit-equal to the flattened composite (the fp32 view, fused_round,
    each leaf's columns cast back), and held against the plain version
    (``ref.fused_round_leaves_plain``)."""
    gen = torch.Generator(device="cuda").manual_seed(26)
    for M, spec in LEAF_CASES:
        leaves = _leaf_tree(M, spec, gen)
        T = torch.full((M, M), 1.0 / M, device="cuda")
        c0 = torch.full((M,), 0.1, device="cuda")
        c1 = torch.full((M,), -0.5, device="cuda")
        outs, r, G = pk.fused_round_leaves(leaves, T, c0, c1)
        flat = torch.cat([l.reshape(M, -1).float() for l in leaves], dim=1)
        _, f_r, f_G = pk.fused_round(flat, T, c0, c1, out=flat)
        want = [p.reshape(l.shape).to(l.dtype) for p, l in zip(
            flat.split([l[0].numel() for l in leaves], dim=1), leaves)]
        torch.cuda.synchronize()
        same = torch.equal(r, f_r) and torch.equal(G, f_G) and all(
            o.dtype == w.dtype and torch.equal(o, w)
            for o, w in zip(outs, want))
        _leaf_errs(pk, ref, errs, leaves, outs, r, G, T, c0, c1)
        n = flat.shape[1]
        print(f"  leaves M = {M}, n = {n} ({len(spec)} leaves, vec "
              f"{pk.leaf_table(leaves).vec}): bit-equal to the flattened "
              f"composite: {same}")
        if not same:
            raise AssertionError(f"leaf kernels (M = {M}, n = {n}) differ "
                                 "from the flattened composite")
        del leaves, outs, flat, want


def phase_kernels(pk, ref):
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = ErrLog()
    for R, n in SHAPES:
        args = _inputs(R, n, gen)
        check_shape(pk, ref, errs, *args)
        same = check_sequences(pk, ref, *args)
        print(f"  checked ({R}, {n}); bit-equal to the replaced launch "
              f"sequences {json.dumps(same)}")
    R, n = MAIN_R, MAIN_N
    x, T, c0, c1 = _inputs(R, n, gen)
    p_out, _, coef, ws = check_shape(pk, ref, errs, x, T, c0, c1)
    del p_out
    torch.cuda.empty_cache()
    # the stale epilogue at this width: phase 13(c)
    same = check_sequences(pk, ref, x, T, c0, c1, stale=False)
    print(f"  checked ({R}, {n}) (main path); bit-equal to the replaced "
          f"launch sequences {json.dumps(same)}")
    check_leaves(pk, ref, errs)
    out = torch.empty_like(x)

    def three_launches():       # the sequence fused_round replaced
        _, _, c = pk.gram_coef(pk._launch_partial_gram(
            x, pk._vec(x), tail=False), T, c0, c1)
        pk.mix_shard(x, T, c, out=out)

    G_x = pk.partial_gram(x)
    sequences = {
        "fused_round, 3 launches (partial_gram, gram_coef, mix_shard)":
            _time_ms(three_launches),
        "mix_from_gram, 2 launches (gram_coef, mix_shard)":
            _time_ms(lambda: pk.mix_shard(x, T, pk.gram_coef(
                G_x[None], T, c0, c1)[2], out=out)),
        "mix_from_gram, 1 launch (prologue)":
            _time_ms(lambda: pk.mix_from_gram(x, T, c0, c1, G_x, out=out)),
        "partial_gram without its tail": _time_ms(
            lambda: pk._launch_partial_gram(x, pk._vec(x), tail=False)),
    }
    times = {
        "fused_round": (
            _time_ms(lambda: pk.fused_round(x, T, c0, c1, out=out)),
            _time_ms(lambda: ref.fused_round_plain(x, T, c0, c1, out=out),
                     reps=3, warm=1),
            None),
        "partial_gram": (
            _time_ms(lambda: pk.partial_gram(x)),
            _time_ms(lambda: ref.partial_gram_plain(x), reps=3, warm=1),
            _time_ms(lambda: torch.matmul(x, x.T))),
        "gram_coef": (
            _time_ms(lambda: pk.gram_coef(ws, T, c0, c1)),
            _time_ms(lambda: ref.gram_coef_plain(ws.sum(0), T, c0, c1)),
            None),
        "mix_shard": (
            _time_ms(lambda: pk.mix_shard(x, T, coef, out=out)),
            _time_ms(lambda: ref.mix_shard_plain(x, T, coef, out=out),
                     reps=3, warm=1),
            _time_ms(lambda: torch.matmul(T, x, out=out))),
    }
    # gram_coef is one block on a few KB: its event time is the host's
    # launch cost; the device's own time comes from the profiler, and from
    # calls queued behind a sleep kernel
    coef_device = {
        "profiler": _profiled_ms(lambda: pk.gram_coef(ws, T, c0, c1),
                                 "gram_coef"),
        "queued": _device_ms(lambda: pk.gram_coef(ws, T, c0, c1))}
    print("  gram_coef device ms " + json.dumps(coef_device)
          + f", event ms {times['gram_coef'][0]}")
    print("  replaced launch sequences, ms " + json.dumps(sequences)
          + f"; fused_round (2 launches) {times['fused_round'][0]}")
    # bytes (inputs once, outputs once) and fp32 operations: pk.cost
    work = {name: pk.cost(name, R, n, nblk=ws.shape[0]) for name in times}
    del x, out, ws
    torch.cuda.empty_cache()
    rows = {}
    for name, (ms, plain_ms, lib_ms) in times.items():
        t_bytes = work[name]["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = work[name]["flops"] / FP32_FLOPS * 1e3
        rows[name] = {
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": 0,
            "max_abs_err": errs.abs[name], "max_rel_err": errs.rel[name],
            "tol_rel": TOL, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms}
    rows["gram_coef"]["device_ms"] = coef_device
    rows["gram_coef"]["merged_into"] = MERGED["gram_coef"]
    rows["fused_round"]["replaced_sequences_ms"] = sequences
    leaf_errs = {k: (errs.abs[k], errs.rel[k]) for k in LEAF_REPLACES}
    return rows, leaf_errs


def phase_slice(pk):
    from repro_torch.configs import DPPFConfig, get_arch
    from repro_torch.core import consensus
    from repro_torch.data import TokenTask, make_round_batch
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer
    from repro_torch.train import (
        RoundClock, init_train_state, make_round_step,
    )
    import repro_torch.train.trainer as trainer_mod

    cfg = dataclasses.replace(get_arch("yi-6b"), n_layers=LAYERS)
    M, tau, steps, seq, batch = SLICE_RUN
    print(f"  config {cfg.name}: d_model {cfg.d_model}, heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, layers {cfg.n_layers}, dtype {cfg.dtype}; "
          f"M={M} tau={tau} steps={steps} seq={seq} batch={batch} "
          f"lr={LR}")
    model = build_model(cfg)
    dcfg = DPPFConfig(alpha=0.1, lam=0.5, tau=tau, consensus="simple_avg",
                      engine="flat")
    opt = make_optimizer("sgd", momentum=0.9, weight_decay=1e-3)
    clock = RoundClock.from_config(dcfg, base_lr=LR, total_steps=steps)
    task = TokenTask(vocab_size=cfg.vocab_size, seq_len=seq)
    gen = torch.Generator(device="cuda").manual_seed(0)

    torch.cuda.reset_peak_memory_stats()
    pk.reset_launches()                     # main path: counts from here
    state = init_train_state(model.init, opt, dcfg, M, gen, device="cuda")
    n = state.engine.layout.n
    if n != cfg.param_count():
        raise AssertionError(f"flat view has {n} columns, param_count() "
                             f"{cfg.param_count()}")
    print(f"  flat view ({state.engine.layout.R}, {n}) fp32, "
          f"use_kernel={state.engine.use_kernel}")
    step = make_round_step(model.loss, opt, dcfg, clock=clock)
    stages_per_round = sum(
        s[0] == "coef" for s in consensus.lower_stages(
            state.engine, dcfg, clock.lam_at(0))[0])

    # CUDA events around the consensus stage of each round
    apply_round = trainer_mod.consensus.apply_round
    events = []

    def timed_apply_round(*a, **kw):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = apply_round(*a, **kw)
        e1.record()
        events.append((e0, e1))
        return out

    trainer_mod.consensus.apply_round = timed_apply_round
    rounds = []
    try:
        for spec in clock.rounds:
            b = make_round_batch(task, 0, M, spec.tau, spec.start, batch,
                                 cfg, device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, b)
            torch.cuda.synchronize()
            round_ms = (time.perf_counter() - t0) * 1e3
            cons_ms = events[-1][0].elapsed_time(events[-1][1])
            row = {"round": spec.index, "loss": float(m["train_loss"]),
                   "consensus_dist": float(m["consensus_dist"]),
                   "round_ms": round_ms, "consensus_ms": cons_ms,
                   "local_ms": round_ms - cons_ms}
            rounds.append(row)
            print("  round " + json.dumps(row))
    finally:
        trainer_mod.consensus.apply_round = apply_round
    launches = dict(pk.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    print(f"  peak memory allocated {peak} bytes ({peak / 1e9:.2f} GB)")
    print(f"  launches on the main path {json.dumps(launches)}")
    if not all(math.isfinite(r["loss"]) for r in rounds):
        raise AssertionError("non-finite training loss")
    if not all(r["consensus_dist"] > 0 for r in rounds[1:]):
        raise AssertionError("consensus_dist is 0 after round 0")
    want = stages_per_round * len(rounds)
    if launches["fused_round"] != want:
        raise AssertionError(f"fused_round launched {launches['fused_round']}"
                             f" times for {want} consensus stages")
    for name in REPLACES:
        if launches[name] == 0 and name not in MERGED:
            raise AssertionError(f"{name} was not launched on the main path")
    bad = _merged_launched(launches, "phase 3's training")
    if bad:
        raise AssertionError("; ".join(bad))
    if peak > 70e9:
        raise AssertionError(f"peak memory {peak / 1e9:.1f} GB > 70 GB: set "
                             "LAYERS = 2 and record why in PERF.md")
    later = rounds[1:] or rounds
    summary = {k: statistics.mean(r[k] for r in later)
               for k in ("round_ms", "consensus_ms", "local_ms")}
    print("  mean of rounds 1.. " + json.dumps(summary))
    del state, step
    torch.cuda.empty_cache()
    return launches, dict(summary, peak_bytes=peak, rounds=len(rounds))


def phase_launcher(pk):
    from repro_torch.launch.train import main as train_main
    for engine, kernels in (("flat", ("fused_round",)),
                            ("tree", ("sq_dist", "apply_update"))):
        pk.reset_launches()
        loss = train_main(["--arch", "yi-6b", "--smoke", "--workers", "4",
                           "--tau", "4", "--steps", "16", "--seq", "16",
                           "--batch", "2", "--engine", engine])
        if not math.isfinite(loss):
            raise AssertionError(f"launcher ({engine}) eval loss {loss}")
        if any(pk.LAUNCHES[k] <= 0 for k in kernels):
            raise AssertionError(f"the launcher's {engine} rounds launched "
                                 f"no {kernels}")
        print(f"  launcher --engine {engine}: eval loss {loss:.4f}, "
              f"launches {json.dumps(dict(pk.LAUNCHES))}")


# ---------------------------------------------------------------------------
# phase 5: the attention kernel
# ---------------------------------------------------------------------------

def _attn_bound(swa, case, dtype):
    """Least time in ms: ``swa.cost`` (4 hd FLOPs per in-band pair per (b,
    h); q, k, v read once and the output written once) over the peak of
    the inputs' type and the memory rate, whichever is larger."""
    B, H, Hkv, Sq, Skv, hd, window, cap, causal = case
    work = swa.cost(B, H, Hkv, Sq, Skv, hd, window=window, causal=causal,
                    esize=torch.finfo(dtype).bits // 8)
    flops, nbytes = work["flops"], work["bytes"]
    peak = BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes"), flops


def _attn_plain_rows(plain, q, k, v, **kw):
    """The plain version one batch row at a time: one row of the serving
    shape's fp32 scores is 2.1 GB."""
    return torch.cat([plain(q[b:b + 1], k[b:b + 1], v[b:b + 1], **kw)
                      for b in range(q.shape[0])])


def _row_rel_err(got, want):
    """The largest error of a query row over that row's own largest
    |want|, maximised over (b, h, row). A row that attends to n keys has
    outputs of order n^-1/2, so one scale for the whole tensor (set by the
    first rows) would not see a wrong long row."""
    d = (got.float() - want.float()).abs().amax(-1)
    return float((d / want.float().abs().amax(-1).clamp_min(1e-30)).max())


def _model_layout(t):
    """The same values as the transposed view of a (B, S, H, hd) tensor:
    the layout ``qkv_proj`` hands the kernel on the main path."""
    return t.transpose(1, 2).contiguous().transpose(1, 2)


def _attn_case(swa, plain, case, dtype, gen, name, plain_reps=20):
    """One case against the plain version, each query row held to the
    dtype's tolerance of its own largest |value|; bf16 also in the model's
    transposed (B, S, H, hd) view, whose strides the TMA descriptors are
    built from. Where ``scaled_dot_product_attention`` computes the same
    function (no window, no cap; causal only with Sq = Skv) it is timed
    too."""
    B, H, Hkv, Sq, Skv, hd, window, cap, causal = case
    q = torch.randn((B, H, Sq, hd), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, Hkv, Skv, hd), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, Hkv, Skv, hd), generator=gen, device="cuda").to(dtype)
    kw = dict(causal=causal, window=window, cap=cap)
    got = swa.swa_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    want = _attn_plain_rows(plain, q, k, v, **kw)
    err = float((got.float() - want.float()).abs().max())
    rel = _row_rel_err(got, want)
    tol = ATTN_TOL[dtype]
    if not rel <= tol:
        raise AssertionError(f"swa_attention {name} {dtype}: largest error "
                             f"over its row's scale {rel:.3e} > {tol}")
    del got
    bound, bound_by, flops = _attn_bound(swa, case, dtype)
    row = {"case": name, "shape": list(case), "dtype": str(dtype)[6:],
           "max_abs_err": err, "max_rel_err": rel, "tol_rel": tol,
           "ms": _time_ms(lambda: swa.swa_attention(q, k, v, **kw)),
           "plain_ms": _time_ms(lambda: _attn_plain_rows(plain, q, k, v,
                                                         **kw),
                                reps=plain_reps),
           "bound_ms": bound, "bound_by": bound_by, "flops": flops,
           "library_ms": None}
    if dtype == torch.bfloat16:
        qm, km, vm = (_model_layout(t) for t in (q, k, v))
        got = swa.swa_attention(qm, km, vm, **kw)
        torch.cuda.synchronize()
        row["max_rel_err_model_layout"] = _row_rel_err(got, want)
        if not row["max_rel_err_model_layout"] <= tol:
            raise AssertionError(
                f"swa_attention {name} bf16 in the (B, S, H, hd) layout: "
                "largest error over its row's scale "
                f"{row['max_rel_err_model_layout']:.3e} > {tol}")
        del got
        row["ms_model_layout"] = _time_ms(
            lambda: swa.swa_attention(qm, km, vm, **kw))
        del qm, km, vm
    del want
    if not window and not cap and (Sq == Skv or not causal):
        sdpa = torch.nn.functional.scaled_dot_product_attention
        row["library_ms"] = _time_ms(lambda: sdpa(q, k, v, is_causal=causal,
                                                  enable_gqa=True))
    print("  attention " + json.dumps(row))
    if name in ATTN_SLICE and dtype == torch.bfloat16:
        ratio = (f", {row['ms'] / row['library_ms']:.3f} x "
                 "scaled_dot_product_attention" if row["library_ms"] else "")
        print(f"  {name} bf16: {row['ms']:.4f} ms "
              f"({row['ms_model_layout']:.4f} in the model's layout), "
              f"{flops / row['ms'] / 1e9:.1f} TFLOP/s, "
              f"{bound / row['ms']:.1%} of the bound{ratio}")
    return row


def _ptxas_report(log, kernels=("swa_wgmma_kernel", "swa_kernel")):
    """{kernel instance: (registers, spill store bytes, spill load bytes)}
    from ptxas's -v report of a source (by default swa_attention's;
    an instance is named by its first template argument)."""
    import re
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            k = re.search(rf"({'|'.join(kernels)})(?:ILi(\d+)E)?", m[1])
            name = (f"{k[1]}<{k[2]}>" if k[2] else k[1]) if k else m[1]
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out[name] = [None, int(m[1]), int(m[2])]
        m = re.search(r"Used (\d+) registers", line)
        if m and name in out:
            out[name][0] = int(m[1])
    return {k: tuple(v) for k, v in out.items()}


def _sass_census(path, kernels=("swa_wgmma_kernel", "swa_kernel"),
                 op="HGMMA"):
    """{kernel instance: (highest register the SASS names, ``op``
    instructions: HGMMA for wgmma, HMMA for mma.sync)} from ``cuobjdump
    -sass`` of the built library. ptxas reports a launch's registers; a
    warpgroup that raises its share with ``setmaxnreg`` shows only here."""
    import re
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(rf"Function : \S*?({'|'.join(kernels)})ILi(\d+)E",
                      line)
        if m:
            name = f"{m[1]}<{m[2]}>"
            out[name] = [-1, 0]
        elif "Function : " in line:
            name = None
        elif name:
            for r in re.findall(r"\bR(\d+)\b", line):
                out[name][0] = max(out[name][0], int(r))
            out[name][1] += bool(re.search(rf"\b{op}\.", line))
    return {k: tuple(v) for k, v in out.items()}


def phase_attention(swa, plain):
    from repro_torch.kernels import _build
    info = _build.build_info["swa_attention"]
    regs = _ptxas_report(info["log"])
    print("  ptxas (registers, spill store / load bytes) " + json.dumps(regs))
    sass = _sass_census(info["path"])
    print("  SASS (highest register, HGMMA instructions) "
          + json.dumps(sass))
    wgmma = {k: v for k, v in sass.items() if "wgmma" in k}
    if len(wgmma) != len(swa.HEAD_DIMS) or not all(
            n for _, n in wgmma.values()):
        raise AssertionError("the bf16 kernel's instances do not all run "
                             f"their products on wgmma: {sass}")
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for i, case in enumerate(ATTN_CASES):
            rows.append(_attn_case(swa, plain, case, dtype, gen, f"case{i}"))
        for name, case in ATTN_SLICE.items():
            # the plain version at a serving shape takes 0.1-0.2 s a call:
            # median of 3 (the run's time limit)
            rows.append(_attn_case(swa, plain, case, dtype, gen, name,
                                   plain_reps=3))
            torch.cuda.empty_cache()
    by = {(r["case"], r["dtype"]): r for r in rows}
    head, local = by[("global", "bfloat16")], by[("local", "bfloat16")]
    lib = by[("library", "bfloat16")]
    z = by[("zamba2", "bfloat16")]
    return {
        "name": "swa_attention", "route": "cuda", "source": ATTN_SOURCE,
        "replaces": ATTN_REPLACES, "launches": 0,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        # errors over each query row's own scale
        "max_rel_err": max(r["max_rel_err"] for r in rows
                           if r["dtype"] == "bfloat16"),
        "tol_rel": ATTN_TOL[torch.bfloat16],
        "max_rel_err_fp32": max(r["max_rel_err"] for r in rows
                                if r["dtype"] == "float32"),
        "tol_rel_fp32": ATTN_TOL[torch.float32],
        # the headline: a global layer of the serving prefill, bf16, cap 50
        "shape": head["shape"], "ms": head["ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        # scaled_dot_product_attention(is_causal, enable_gqa) at cap 0
        "library_ms": lib["library_ms"], "ms_library_case": lib["ms"],
        "ms_local": local["ms"], "plain_ms_local": local["plain_ms"],
        "bound_ms_local": local["bound_ms"],
        "ms_hd112": z["ms"], "plain_ms_hd112": z["plain_ms"],
        "bound_ms_hd112": z["bound_ms"], "library_ms_hd112": z["library_ms"],
        "max_rel_err_model_layout": max(
            r["max_rel_err_model_layout"] for r in rows
            if r["dtype"] == "bfloat16"),
        "ms_model_layout": head["ms_model_layout"],
        "product_route": "wgmma", "sass_bf16": wgmma,
        "ptxas_bf16": {k: v for k, v in regs.items() if "wgmma" in k}}


# ---------------------------------------------------------------------------
# phase 6: serving gemma2-2b
# ---------------------------------------------------------------------------

def _events_of(model, names):
    """The model with CUDA events around each call of the named lanes."""
    events = {n: [] for n in names}

    def wrap(name, fn):
        def run(*a, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*a, **kw)
            e1.record()
            events[name].append((e0, e1))
            return out
        return run
    return dataclasses.replace(model, **{n: wrap(n, getattr(model, n))
                                         for n in names}), events


def _serve_reference_check(swa, cfg):
    """(0) The kernel route of the prefill (fresh caches at index 0)
    against the training path's ``attend`` on the same input, at full
    width, 2 layers (one local, one global) and fp32; S = 4608 crosses
    the local window. Hidden states at every position, tolerance 1e-4 of
    their scale."""
    from repro_torch.models import build_model
    from repro_torch.models import transformer as lm

    small = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    params = build_model(small).init(
        torch.Generator(device="cuda").manual_seed(3), "cuda")
    tokens = torch.randint(0, small.vocab_size, (1, 4608), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(4))
    with torch.no_grad():
        x = lm._embed(params, small, tokens)
        want, _, _ = lm.run_blocks(params["blocks"], x, small)
        before = swa.LAUNCHES["swa_attention"]
        states = lm.init_states(small, 1, 4608, torch.float32, device="cuda")
        got, _, _ = lm.run_blocks(params["blocks"], x, small, states=states,
                                  index=0)
    if swa.LAUNCHES["swa_attention"] - before != small.n_layers:
        raise AssertionError("the kernel route was not taken")
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    print(f"  (0) kernel route vs attend, full width, 2 layers, fp32, "
          f"S=4608: max abs err {err:.3e} (scale {scale:.3e})")
    if not err <= 1e-4 * scale:
        raise AssertionError(f"prefill kernel route differs from attend: "
                             f"{err:.3e} > 1e-4 x {scale:.3e}")


def _profile_generate(generate, model, params, prompts, buf, new,
                      prefill_kernel=None):
    """``torch.profiler`` over one ``generate`` call (prefill + new - 1
    decode steps; ``prompts`` the tokens or a whole batch): wall time, the
    device's busy time (the sum of its kernels' and copies' spans: one
    stream, so they do not overlap) and idle share, and the kernels that
    hold the device longest. With ``prefill_kernel = (name, n)``: the time
    of the kernels whose name holds ``name``, in all and in their first n
    launches (the prefill's)."""
    batch = prompts if isinstance(prompts, dict) else {"tokens": prompts}
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    # the device's activity alone, read from the raw trace: host operator
    # events, and the event tree ``prof.events()`` builds from them, took
    # most of the phase's time at full depth and are not read here
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        generate(model, params, batch, max_new_tokens=new, buf_len=buf)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = [(e.name(), e.start_ns(), e.duration_ns() / 1e6)
             for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA]
    by_name = {}
    for name, _, ms in spans:
        tot, n = by_name.get(name, (0.0, 0))
        by_name[name] = (tot + ms, n + 1)
    busy_ms = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    swa = [(ms, n) for name, (ms, n) in by_name.items() if "swa_" in name]
    out = {"new_tokens": new, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "swa_ms": sum(ms for ms, _ in swa),
           "swa_kernels": sum(n for _, n in swa),
           "idle_share": (1 - busy_ms / wall_ms) if busy_ms else None,
           "device_launches": sum(n for _, n in by_name.values()),
           "top": [[name[:70], ms, n] for name, (ms, n) in top]}
    if prefill_kernel:
        name, n = prefill_kernel
        spans = sorted((start, ms) for kname, start, ms in spans
                       if name in kname)
        out[f"{name}_ms"] = sum(ms for _, ms in spans)
        out[f"{name}_kernels"] = len(spans)
        out[f"{name}_prefill_ms"] = sum(ms for _, ms in spans[:n])
    if not busy_ms:
        out["note"] = "the profiler recorded no device time: not measured"
    return out


def phase_serving(swa):
    from repro_torch.configs import get_arch
    from repro_torch.core.engine import tree_items
    from repro_torch.models import build_model
    from repro_torch.serving import generate

    cfg = get_arch("gemma2-2b")
    _serve_reference_check(swa, cfg)
    torch.cuda.empty_cache()

    B, NEW, BUF = 4, 32, 8192
    print(f"  config {cfg.name}: d_model {cfg.d_model}, heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads}, head_dim {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, layers {cfg.n_layers}, "
          f"window {cfg.sliding_window}, dtype {cfg.dtype}; B={B} "
          f"S={SERVE_S} new={NEW} buf_len={BUF}")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    n = sum(leaf.numel() for _, leaf in tree_items(params))
    # param_count() leaves out gemma2's post-block norms (ROADMAP Queue 3)
    post = 2 * cfg.d_model * cfg.n_layers if cfg.post_block_norm else 0
    print(f"  parameters {n} = param_count() {cfg.param_count()} + "
          f"post-block norms {post}")
    if n != cfg.param_count() + post:
        raise AssertionError("parameter count differs from the config's")
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, SERVE_S))).cuda()

    # (a) the main path: generate, counters zeroed just before
    timed, events = _events_of(model, ("prefill", "decode_step"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    swa.reset_launches()
    t0 = time.perf_counter()
    toks, logits = generate(timed, params, {"tokens": prompts},
                            max_new_tokens=NEW, buf_len=BUF)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = swa.LAUNCHES["swa_attention"]
    peak = torch.cuda.max_memory_allocated()
    prefill_ms = events["prefill"][0][0].elapsed_time(events["prefill"][0][1])
    dec = [a.elapsed_time(b) for a, b in events["decode_step"]]
    a = {"prefill_ms": prefill_ms, "ttft_ms": prefill_ms,
         "decode_ms_per_token": statistics.mean(dec),
         "decode_ms_median": statistics.median(dec),
         "wall_s": wall, "tok_s": B * NEW / wall,
         "prefill_tok_s": B * SERVE_S / (prefill_ms / 1e3),
         "peak_bytes": peak, "swa_launches": launches}
    print("  (a) generate " + json.dumps(a))
    print(f"  first tokens {toks[:, :8].tolist()}")
    if launches != cfg.n_layers:
        raise AssertionError(f"swa_attention launched {launches} times in "
                             f"the prefill, not {cfg.n_layers}")
    if toks.shape != (B, NEW) or not bool(torch.isfinite(logits).all()):
        raise AssertionError("generate gave a bad shape or non-finite logits")
    if not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError("token ids out of the vocabulary")
    # where the time goes: the same call, traced, with 8 new tokens
    prof = _profile_generate(generate, timed, params, prompts, BUF, 8)
    prof["prefill_ms"] = events["prefill"][-1][0].elapsed_time(
        events["prefill"][-1][1])
    prof["swa_share_of_prefill"] = prof["swa_ms"] / prof["prefill_ms"]
    print("  (a) profile " + json.dumps(prof))

    # (b) one prompt in chunks of 512: the first through the kernel
    swa.reset_launches()
    states, start = model.make_state(params, {"tokens": prompts[:1]}, BUF)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for j in range(0, SERVE_S, 512):
        lg, states = model.prefill_chunk(params, states,
                                         prompts[:1, j:j + 512], start + j)
    e1.record()
    torch.cuda.synchronize()
    diff = float((lg[0] - logits[0]).abs().max())
    print(f"  (b) chunked prefill (512): {e0.elapsed_time(e1):.1f} ms, "
          f"swa launches {swa.LAUNCHES['swa_attention']}, max |last-token "
          f"logits - (a)'s| {diff:.4f} (information; logits scale "
          f"{float(logits[0].abs().max()):.2f})")
    if swa.LAUNCHES["swa_attention"] != cfg.n_layers:
        raise AssertionError("the first chunk did not run the kernel")
    del params, states, timed, model, lg, logits
    torch.cuda.empty_cache()

    # (c) the continuous-batching launcher at full width
    _launcher_drill("gemma2-2b", {"swa_attention": swa})
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 7: the SSD kernel
# ---------------------------------------------------------------------------

def _rel_err(got, want):
    """(max abs error, the plain output's scale)."""
    return (float((got - want).abs().max()),
            max(float(want.abs().max()), 1e-30))


def _ssd_check(name, errs, got, want):
    for what, g, w in zip(("y", "states"), got, want):
        err, scale = _rel_err(g, w)
        errs.append((err, err / scale))
        if not err <= TOL * scale:
            raise AssertionError(f"ssd_chunks {name} {what}: max abs err "
                                 f"{err:.3e} > {TOL} x {scale:.3e}")


def _ssd_bound(mk, Bt, S, H, P, N, L):
    """Least time in ms for ``ssd_chunks_seq`` on S tokens in chunks of L:
    ``mk.cost``'s bytes (x, B, C, a read once, y and the states written
    once) over the memory rate, or its FLOPs over the peak of the route,
    whichever is larger. The kernel's route takes each product in 3xTF32
    (three TF32 passes on the tensor cores), so its operations bound is 3
    x the FLOPs over the TF32 peak; the fp32 CUDA-core figure (the first
    kernel's route) and one TF32 pass are kept beside it."""
    work = mk.cost(Bt, S, H, P, N, L)
    nbytes, flops = work["bytes"], work["flops"]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 3 * flops / TF32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_ms_bytes": t_bytes, "bound_ms_3xtf32_ops": t_ops,
            "bound_ms_tf32_ops": flops / TF32_FLOPS * 1e3,
            "bound_ms_fp32_ops": flops / FP32_FLOPS * 1e3, "flops": flops}


def _ssd_census(mk):
    """ptxas's registers and spills and the SASS census of every instance
    of the kernel (``ssd_kernel<MP>``, MP = P / 16): its products must run
    on the tensor cores (HMMA, mma.sync; or HGMMA, wgmma)."""
    from repro_torch.kernels import _build
    info = _build.build_info["mamba_scan"]
    regs = _ptxas_report(info["log"], kernels=("ssd_kernel",))
    hmma = _sass_census(info["path"], kernels=("ssd_kernel",), op="HMMA")
    hgmma = _sass_census(info["path"], kernels=("ssd_kernel",), op="HGMMA")
    census = {k: {"ptxas_registers": regs.get(k, (None,))[0],
                  "spill_store_bytes": regs.get(k, (None, None))[1],
                  "spill_load_bytes": regs.get(k, (None, None, None))[2],
                  "sass_highest_register": v[0], "hmma": v[1],
                  "hgmma": hgmma[k][1]} for k, v in hmma.items()}
    print("  ptxas and SASS per instance " + json.dumps(census))
    if len(census) != mk.MAX_P // 16 or not all(
            c["hmma"] + c["hgmma"] for c in census.values()):
        raise AssertionError("ssd_kernel's instances do not all run their "
                             f"products on the tensor cores: {census}")
    return census


def phase_ssd(mk, ssd_ref):
    census = _ssd_census(mk)
    for name, (Bt, S, H, P, N, L) in dict(
            serving=SSD_SLICE, **SSD_MORE).items():
        print(f"  geometry {name}: {mk.geometry(Bt, S, H, L, P, N)}")
    gen = torch.Generator(device="cuda").manual_seed(5)
    errs = []

    def a_log_of(shape, scale=1.0):
        return -scale * torch.nn.functional.softplus(
            torch.randn(shape, generator=gen, device="cuda"))
    for i, (B, H, nc, L, P, N) in enumerate(SSD_CASES):
        x = torch.randn((B, H, nc, L, P), generator=gen, device="cuda")
        B_, C_ = (torch.randn((B, nc, L, N), generator=gen, device="cuda")
                  for _ in range(2))
        a = a_log_of((B, H, nc, L))
        got = mk.ssd_chunks(x, B_, C_, a)
        torch.cuda.synchronize()
        _ssd_check(f"case{i}", errs, got,
                   ssd_ref.ssd_chunks_plain(x, B_, C_, a))
        print(f"  checked case{i} {(B, H, nc, L, P, N)}")

    def seq_inputs(Bt, S, H, P, N, decay):
        xh = torch.randn((Bt, S, H, P), generator=gen, device="cuda")
        conv = torch.randn((Bt, S, 2 * N + 64), generator=gen,
                           device="cuda")
        # B_ and C_ as strided column slices, as the conv output gives them
        return (xh, conv[..., :N], conv[..., N:2 * N],
                a_log_of((Bt, S, H)) * decay)

    def zamba2_decay(H):  # zamba2's A = 1..8: la falls to about -700
        return torch.linspace(1.0, 8.0, H, device="cuda")
    # the model's layout: a ragged last chunk (the plain version pads it
    # with zeros, the kernel reads past S as zero), then the serving shape,
    # whose decay spans zamba2's A = 1..8 (la falls to about -700 over a
    # chunk); the serving shape twice, bit for bit
    bit_equal = None
    for name, (Bt, S, H, P, N, L), decay in (
            ("ragged", SSD_RAGGED, 1.0),
            ("serving shape", SSD_SLICE, zamba2_decay(SSD_SLICE[2]))):
        xh, B_, C_, a = seq_inputs(Bt, S, H, P, N, decay)
        got = mk.ssd_chunks_seq(xh, B_, C_, a, L)
        torch.cuda.synchronize()
        _ssd_check(name, errs, got,
                   ssd_ref.ssd_chunks_seq_plain(xh, B_, C_, a, L))
        if name == "serving shape":
            again = mk.ssd_chunks_seq(xh, B_, C_, a, L)
            bit_equal = all(torch.equal(u, v) for u, v in zip(got, again))
            del again
            if not bit_equal:
                raise AssertionError("two launches at the serving shape "
                                     "differ")
        del got
        torch.cuda.empty_cache()
        print(f"  checked the {name} {(Bt, S, H, P, N, L)}: "
              f"{-(-S // L)} chunks" + (", two launches bit-equal"
                                       if bit_equal else ""))
    ms = _time_ms(lambda: mk.ssd_chunks_seq(xh, B_, C_, a, L))
    plain_ms = _time_ms(lambda: ssd_ref.ssd_chunks_seq_plain(xh, B_, C_, a,
                                                             L))
    bound = _ssd_bound(mk, Bt, S, H, P, N, L)
    row = {"name": "ssd_chunks", "route": "cuda", "source": SSD_SOURCE,
           "replaces": SSD_REPLACES, "launches": 0,
           "product_route": "mma.sync m16n8k8 tf32, 3xTF32",
           "shape": [Bt, S, H, P, N, L], "ms": ms, "plain_ms": plain_ms,
           **bound, "bit_equal_serving": bit_equal,
           "library_ms": None,
           "library_note": "no single PyTorch call computes the SSD chunk",
           "census": census}
    del xh, B_, C_, a
    torch.cuda.empty_cache()
    # the chunked prefill's and the launcher's chunks, checked and timed
    for name, (Bt, S, H, P, N, L) in SSD_MORE.items():
        xh, B_, C_, a = seq_inputs(Bt, S, H, P, N, zamba2_decay(H))
        got = mk.ssd_chunks_seq(xh, B_, C_, a, L)
        torch.cuda.synchronize()
        _ssd_check(name, errs, got,
                   ssd_ref.ssd_chunks_seq_plain(xh, B_, C_, a, L))
        row[f"ms_{name}"] = _time_ms(
            lambda: mk.ssd_chunks_seq(xh, B_, C_, a, L))
        row[f"plain_ms_{name}"] = _time_ms(
            lambda: ssd_ref.ssd_chunks_seq_plain(xh, B_, C_, a, L))
        row[f"bound_ms_{name}"] = _ssd_bound(mk, Bt, S, H, P, N,
                                             L)["bound_ms"]
        print(f"  checked and timed {name} {(Bt, S, H, P, N, L)}: "
              f"{row[f'ms_{name}']:.4f} ms")
    row["max_abs_err"] = max(e for e, _ in errs)
    row["max_rel_err"] = max(r for _, r in errs)
    row["tol_rel"] = TOL
    print("  ssd_chunks " + json.dumps(row))
    return row


# ---------------------------------------------------------------------------
# phase 8: serving zamba2-7b
# ---------------------------------------------------------------------------

def _release_graph(states):
    """Detach state tensors that a plain route updated in place with a
    gradient recorded: each one's graph saved the tensor itself, a cycle
    of C++ references that outlives the call and that Python's collector
    cannot see (it held the block's parameters and activations, 640 MB by
    phase 12, until the process ended)."""
    for t in states:
        t.detach_()


def _mamba_route_check(mk, cfg):
    """(0) One Mamba2 block at full width in fp32, S = 1024, with non-zero
    carried-in ssm and conv states: the kernel route (no gradient
    recorded) against the plain ``_ssd_chunked`` route (a gradient
    recorded), outputs and new states within 1e-4 of their scale."""
    from repro_torch.models import ssm
    gen = torch.Generator(device="cuda").manual_seed(6)
    p = ssm.init_mamba(gen, cfg, torch.float32, device="cuda")
    x = torch.randn((1, 1024, cfg.d_model), generator=gen, device="cuda")
    state = ssm.init_mamba_state(cfg, 1, torch.float32, device="cuda")
    state["ssm"].normal_(generator=gen)
    state["conv"].normal_(generator=gen)
    plain_state = {k: v.clone() for k, v in state.items()}
    before = mk.LAUNCHES["ssd_chunks"]
    with torch.no_grad():
        got, _ = ssm.mamba_forward(p, x, cfg, state)
    if mk.LAUNCHES["ssd_chunks"] != before + 1:
        raise AssertionError("the kernel route was not taken")
    with torch.enable_grad():
        want, _ = ssm.mamba_forward(p, x.clone().requires_grad_(True), cfg,
                                    plain_state)
    if mk.LAUNCHES["ssd_chunks"] != before + 1:
        raise AssertionError("the plain route launched the kernel")
    out = {}
    for name, g, w in (("out", got, want),
                       ("ssm", state["ssm"], plain_state["ssm"]),
                       ("conv", state["conv"], plain_state["conv"])):
        err, scale = _rel_err(g, w.detach())
        out[name] = [err, scale]
        if not err <= 1e-4 * scale:
            raise AssertionError(f"mamba kernel route {name}: {err:.3e} > "
                                 f"1e-4 x {scale:.3e}")
    _release_graph(plain_state.values())
    print("  (0) mamba block, kernel route vs plain, full width, fp32, "
          "S=1024, carried states: [max abs err, scale] " + json.dumps(out))


def _scan_events():
    """CUDA events around every SSD scan and its kernel call (the glue is
    the scan less the kernel). Returns (events, undo)."""
    from repro_torch.kernels.mamba_scan import ops
    events = {"scan": [], "kernel": []}
    real = {"ssd_scan": ops.ssd_scan, "ssd_chunks_seq": ops.ssd_chunks_seq}

    def timed(name, fn):
        def run(*a, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*a, **kw)
            e1.record()
            events[name].append((e0, e1))
            return out
        return run
    ops.ssd_scan = timed("scan", real["ssd_scan"])
    ops.ssd_chunks_seq = timed("kernel", real["ssd_chunks_seq"])

    def undo():
        ops.ssd_scan = real["ssd_scan"]
        ops.ssd_chunks_seq = real["ssd_chunks_seq"]
    return events, undo


def phase_zamba2(swa, mk):
    from repro_torch.configs import get_arch
    from repro_torch.core.engine import tree_items
    from repro_torch.models import build_model
    from repro_torch.serving import generate

    cfg = get_arch("zamba2-7b")
    _mamba_route_check(mk, cfg)
    torch.cuda.empty_cache()

    B, NEW, BUF = 4, 32, 8192
    n_mamba = cfg.blocks().count("mamba")
    n_attn = cfg.blocks().count("shared_attn")
    print(f"  config {cfg.name}: d_model {cfg.d_model}, heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads}, head_dim {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, layers {cfg.n_layers} "
          f"({n_mamba} mamba, {n_attn} shared_attn), ssm heads "
          f"{cfg.ssm_heads}, state {cfg.ssm_state}, chunk {cfg.ssm_chunk}, "
          f"dtype {cfg.dtype}; B={B} S={SERVE_S} new={NEW} buf_len={BUF}")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    n = sum(leaf.numel() for _, leaf in tree_items(params))
    print(f"  parameters {n} (param_count() says {cfg.param_count()}: it "
          "overcounts Mamba blocks, ROADMAP Queue 3)")
    if n != ZAMBA2_PARAMS:
        raise AssertionError(f"zamba2-7b has {n} parameters, not "
                             f"{ZAMBA2_PARAMS}")
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, SERVE_S))).cuda()

    # (a) the main path: generate, counters zeroed just before
    timed, events = _events_of(model, ("prefill", "decode_step"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    swa.reset_launches()
    mk.reset_launches()
    t0 = time.perf_counter()
    toks, logits = generate(timed, params, {"tokens": prompts},
                            max_new_tokens=NEW, buf_len=BUF)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"ssd_chunks": mk.LAUNCHES["ssd_chunks"],
                "swa_attention": swa.LAUNCHES["swa_attention"]}
    peak = torch.cuda.max_memory_allocated()
    prefill_ms = events["prefill"][0][0].elapsed_time(events["prefill"][0][1])
    dec = [a.elapsed_time(b) for a, b in events["decode_step"]]
    a = {"prefill_ms": prefill_ms, "ttft_ms": prefill_ms,
         "decode_ms_per_token": statistics.mean(dec),
         "decode_ms_median": statistics.median(dec),
         "wall_s": wall, "tok_s": B * NEW / wall,
         "prefill_tok_s": B * SERVE_S / (prefill_ms / 1e3),
         "peak_bytes": peak, "allocated_before_bytes": before,
         "launches": launches}
    print("  (a) generate " + json.dumps(a))
    print(f"  first tokens {toks[:, :8].tolist()}")
    if launches != {"ssd_chunks": n_mamba, "swa_attention": n_attn}:
        raise AssertionError(f"launches in the prefill {launches}, not "
                             f"{n_mamba} ssd_chunks and {n_attn} "
                             "swa_attention")
    if toks.shape != (B, NEW) or not bool(torch.isfinite(logits).all()):
        raise AssertionError("generate gave a bad shape or non-finite logits")
    if not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError("token ids out of the vocabulary")
    # where the time goes: the same call traced (8 new tokens), with
    # events around each SSD scan and its kernel
    scan_events, undo = _scan_events()
    try:
        prof = _profile_generate(generate, timed, params, prompts, BUF, 8)
    finally:
        undo()
    scan_ms = sum(a.elapsed_time(b) for a, b in scan_events["scan"])
    kernel_ms = sum(a.elapsed_time(b) for a, b in scan_events["kernel"])
    traced_prefill = events["prefill"][-1][0].elapsed_time(
        events["prefill"][-1][1])
    prof["prefill_ms"] = traced_prefill
    prof["ssd_scans"] = len(scan_events["scan"])
    prof["ssd_scan_ms"] = scan_ms
    prof["ssd_kernel_ms"] = kernel_ms
    prof["ssd_glue_ms"] = scan_ms - kernel_ms
    prof["ssd_kernel_share_of_prefill"] = kernel_ms / traced_prefill
    prof["ssd_glue_share_of_prefill"] = (scan_ms - kernel_ms) / traced_prefill
    prof["swa_share_of_prefill"] = prof["swa_ms"] / traced_prefill
    print("  (a) profile " + json.dumps(prof))

    # (b) one prompt in chunks of 512: ssm and conv states carried
    swa.reset_launches()
    mk.reset_launches()
    states, start = model.make_state(params, {"tokens": prompts[:1]}, BUF)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for j in range(0, SERVE_S, 512):
        lg, states = model.prefill_chunk(params, states,
                                         prompts[:1, j:j + 512], start + j)
    e1.record()
    torch.cuda.synchronize()
    n_chunks = -(-SERVE_S // 512)
    diff = float((lg[0] - logits[0]).abs().max())
    print(f"  (b) chunked prefill (512): {e0.elapsed_time(e1):.1f} ms, "
          f"ssd launches {mk.LAUNCHES['ssd_chunks']}, swa launches "
          f"{swa.LAUNCHES['swa_attention']}, max |last-token logits - "
          f"(a)'s| {diff:.4f} (information; logits scale "
          f"{float(logits[0].abs().max()):.2f})")
    if (mk.LAUNCHES["ssd_chunks"] != n_mamba * n_chunks
            or swa.LAUNCHES["swa_attention"] != n_attn):
        raise AssertionError("the chunks did not run the kernels")
    if not bool(torch.isfinite(lg).all()):
        raise AssertionError("non-finite chunked-prefill logits")
    del params, states, timed, model, lg, logits, toks
    torch.cuda.empty_cache()

    # (c) the continuous-batching launcher at full width
    _launcher_drill("zamba2-7b", {"ssd_chunks": mk, "swa_attention": swa})
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 9: the sLSTM kernel
# ---------------------------------------------------------------------------

def _slstm_inputs(B, T, H, P, gen, carried=False, forget_bias=0.0):
    """g_in (unit normal, every head's forget block shifted by
    ``forget_bias``), R (the model's init scale P^-1/2) and a fresh or
    carried state."""
    g = torch.randn((B, T, H, 4 * P), generator=gen, device="cuda")
    g[..., 2 * P:3 * P] += forget_bias
    R = torch.randn((H, P, 4 * P), generator=gen, device="cuda") * P ** -0.5
    shape = (B, H, P)
    if carried:
        st = (torch.randn(shape, generator=gen, device="cuda"),
              torch.rand(shape, generator=gen, device="cuda") + 0.5,
              torch.randn(shape, generator=gen, device="cuda") * 0.3,
              torch.randn(shape, generator=gen, device="cuda"))
    else:
        z = torch.zeros(shape, device="cuda")
        st = (z, z + 1e-6, z.clone(), z - 1e30)
    return g, R, st


def _slstm_model_inputs(B, T, gen):
    """The serving shape on the model's own gates: a seeded xlstm-350m
    sLSTM block (bf16, its init), a random prompt's block input x, and
    g_in = xi @ w_gates + b_gates reshaped head-major as
    ``models/xlstm.py::slstm_forward`` does; R is the block's r_gates."""
    from repro_torch.configs import get_arch
    from repro_torch.models import xlstm
    from repro_torch.models.layers import rms_norm
    cfg = get_arch("xlstm-350m")
    d_in, H, P = xlstm.dims(cfg)
    p = xlstm.init_slstm(gen, cfg, torch.bfloat16, device="cuda")
    x = torch.randn((B, T, cfg.d_model), generator=gen,
                    device="cuda").to(torch.bfloat16)
    xi = (rms_norm(x, p["ln"], cfg.norm_eps) @ p["w_up"])[..., :d_in]
    g = (xi.to(torch.float32) @ p["w_gates"].to(torch.float32)
         + p["b_gates"]).view(B, T, H, 4 * P)
    st = xlstm.init_slstm_state(cfg, B, device="cuda")
    return g, p["r_gates"], st


def _slstm_head_rel(got, want, head):
    """Largest error relative to its scale over h and the four final-state
    tensors, restricted to one head."""
    (h, st), (wh, wst) = got, want
    pairs = [(h[:, :, head], wh[:, :, head])] + [
        (a[:, head], b[:, head]) for a, b in zip(st, wst)]
    return max(err / scale for err, scale in (
        _rel_err(a.double(), b.double()) for a, b in pairs))


def _slstm_errs(got, want):
    """[(max abs err, scale)] of h and the four final-state tensors."""
    (h, st), (wh, wst) = got, want
    return [_rel_err(a.double(), b.double())
            for a, b in zip((h,) + tuple(st), (wh,) + tuple(wst))]


def _slstm_bound(sk, B, T, H, P):
    """Least time in ms: ``sk.cost``'s FLOPs (2 B T H P 4P for h @ R) over
    the fp32 peak, or its bytes (g_in, R and the state read once, h and
    the final state written once) over the memory rate, whichever is
    larger."""
    work = sk.cost(B, T, H, P)
    flops, nbytes = work["flops"], work["bytes"]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), t_bytes, t_ops, flops


def _device_ms(fn, reps=20, sleep_cycles=20_000_000):
    """Mean device time in ms of ``reps`` back-to-back calls of ``fn``:
    queued behind a sleep kernel (~10 ms), so that the host has enqueued
    them all before the first runs. At T = 1 a call's host cost exceeds
    its kernel's, and CUDA events around each call would time the host."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(sleep_cycles)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _slstm_layout(sk):
    """The kernel's geometry at each head dim (B = 4), the card's count of
    resident clusters, ptxas's registers and spills; fails if the P = 512
    instance spills."""
    from repro_torch.kernels import _build
    geo = {P: dataclasses.asdict(sk.geometry(P, 4)) for P in sk.HEAD_DIMS}
    for P, row in geo.items():
        row["max_active_clusters"] = sk.max_active_clusters(P)
    print("  geometry (B = 4) and cudaOccupancyMaxActiveClusters: "
          + json.dumps(geo))
    regs = _ptxas_report(_build.build_info["slstm_step"]["log"],
                         ("slstm_cluster_kernel",
                          "slstm_exchange_probe_kernel"))
    print("  ptxas (registers, spill store / load bytes) " + json.dumps(regs))
    big = regs.get("slstm_cluster_kernel<512>")
    if big is None or big[1] or big[2]:
        raise AssertionError(f"slstm_cluster_kernel<512> spills or is "
                             f"missing from the ptxas report: {big}")
    need = SLSTM_SLICE[2] * -(-SLSTM_SLICE[0] // sk.G)
    if geo[512]["max_active_clusters"] < need:
        raise AssertionError(f"{need} clusters of 16 needed at once, the "
                             f"card holds {geo[512]['max_active_clusters']}")
    return geo, regs


def phase_slstm(sk, sref):
    gen = torch.Generator(device="cuda").manual_seed(9)
    errs = []
    geo, regs = _slstm_layout(sk)
    def check_cases(cases):
        for B, T, H, P, carried in cases:
            g, R, st = _slstm_inputs(B, T, H, P, gen, carried)
            got = sk.slstm_steps(g, R, st)
            torch.cuda.synchronize()
            e = _slstm_errs(got, sref.slstm_steps_ref(g, R, st))
            errs.extend(e)
            worst = max(err / scale for err, scale in e)
            print(f"  checked {(B, T, H, P)} carried={carried}: max rel "
                  f"err {worst:.3e}")
            if not worst <= TOL:
                raise AssertionError(f"slstm_steps {(B, T, H, P)}: max rel "
                                     f"err {worst:.3e} > {TOL}")

    with torch.no_grad():
        check_cases(SLSTM_CASES)
        # the serving shape on the model's own gates, head by head, twice
        B, T, H, P = SLSTM_SLICE
        g, R, st = _slstm_model_inputs(B, T, gen)
        k32 = sk.slstm_steps(g, R, st)
        again = sk.slstm_steps(g, R, st)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(
            (k32[0],) + tuple(k32[1]), (again[0],) + tuple(again[1])))
        print(f"  serving shape, the model's gates: two launches bit-equal "
              f"{same}")
        if not same:
            raise AssertionError("two slstm_steps launches on the same "
                                 "inputs differ")
        p32 = sref.slstm_steps_ref(g, R, st)
        p64 = sref.slstm_steps_ref(g.double(), R.double(),
                                   tuple(t.double() for t in st))
        heads = []
        for hd in range(H):
            f_bias = float(g[..., hd, 2 * P:3 * P].mean())
            row = {"head": hd, "mean_forget_preact": f_bias,
                   "kernel_vs_plain32": _slstm_head_rel(k32, p32, hd),
                   "plain32_vs_plain64": _slstm_head_rel(p32, p64, hd)}
            row["bar"] = max(TOL, 2 * row["plain32_vs_plain64"])
            heads.append(row)
            print("  serving shape, the model's gates, head " + json.dumps(
                row))
            if not row["kernel_vs_plain32"] <= row["bar"]:
                raise AssertionError(
                    f"slstm_steps head {hd}: rel err "
                    f"{row['kernel_vs_plain32']:.3e} > {row['bar']:.3e}")
        # the same gates over one chunk's steps (a strided view), before
        # 4096 chaotic steps amplify rounding: every head within TOL
        gc = g[:, :SLSTM_CHUNK]
        e = _slstm_errs(sk.slstm_steps(gc, R, st),
                        sref.slstm_steps_ref(gc, R, st))
        worst = max(err / scale for err, scale in e)
        print(f"  the model's gates, first {SLSTM_CHUNK} steps: max rel err "
              f"{worst:.3e}")
        if not worst <= TOL:
            raise AssertionError(f"slstm_steps on the model's gates, "
                                 f"{SLSTM_CHUNK} steps: max rel err "
                                 f"{worst:.3e} > {TOL}")
        errs += e
        ms = _time_ms(lambda: sk.slstm_steps(g, R, st))
        plain_ms = _time_ms(lambda: sref.slstm_steps_ref(g, R, st), reps=3,
                            warm=1)
        del g, R, st, k32, again, p32, p64
        # a forget bias of 3 on every head: not the model's layout
        g, R, st = _slstm_inputs(B, T, H, P, gen, forget_bias=FORGET_BIAS)
        got = sk.slstm_steps(g, R, st)
        torch.cuda.synchronize()
        e = _slstm_errs(got, sref.slstm_steps_ref(g, R, st))
        errs += e
        worst = max(err / scale for err, scale in e)
        print(f"  checked the serving shape {SLSTM_SLICE}, forget bias "
              f"{FORGET_BIAS} on every head (not the model's layout): max "
              f"rel err {worst:.3e} ([abs, scale] of h, c, n, h_T, m: "
              f"{json.dumps(e)})")
        if not worst <= TOL:
            raise AssertionError(f"slstm_steps serving shape: max rel err "
                                 f"{worst:.3e} > {TOL}")
        del got, g, R, st
        check_cases(SLSTM_MORE_CASES)
        # the three shapes of the main path: CUDA events around a call and
        # the kernel's device time (profiler)
        shapes = {}
        for name, shape in SLSTM_TIMED.items():
            g, R, st = _slstm_inputs(*shape, gen)
            run = lambda: sk.slstm_steps(g, R, st)  # noqa: E731
            row = {"shape": list(shape), "events_ms": _time_ms(run),
                   "device_ms": _device_ms(run),
                   "bound_ms": _slstm_bound(sk, *shape)[0]}
            row["us_per_step"] = row["device_ms"] / shape[1] * 1e3
            row["share_of_bound"] = row["bound_ms"] / row["device_ms"]
            shapes[name] = row
            print(f"  {name} {shape}: {row['device_ms']:.4f} ms on the "
                  f"device ({row['events_ms']:.4f} ms in events), "
                  f"{row['us_per_step']:.3f} us a step, "
                  f"{row['share_of_bound']:.1%} of the bound")
            del g, R, st
        # what a step pays to pass h around, without arithmetic
        exchange = {}
        for mode, what in enumerate(sk.EXCHANGES):
            t_ms = _time_ms(lambda: sk.exchange_probe(H, T, mode))
            exchange[what] = t_ms / T * 1e3
        print("  h exchange alone, us a step at the serving geometry "
              f"(H = {H}, T = {T}): " + json.dumps(exchange))
    bound, bound_by, t_bytes, t_ops, flops = _slstm_bound(sk, B, T, H, P)
    row = {"name": "slstm_steps", "route": "cuda", "source": SLSTM_SOURCE,
           "replaces": SLSTM_REPLACES, "launches": 0,
           "max_abs_err": max(e for e, _ in errs),
           "max_rel_err": max(e / s for e, s in errs), "tol_rel": TOL,
           "shape": [B, T, H, P], "ms": ms, "ms_per_step": ms / T,
           "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
           "bound_ms_bytes": t_bytes, "bound_ms_fp32_ops": t_ops,
           "flops": flops, "library_ms": None,
           "library_note": "no single PyTorch call computes the sLSTM "
                           "recurrence",
           "model_gates_by_head": heads, "shapes": shapes,
           "exchange_us_per_step": exchange,
           "geometry": geo[P], "ptxas": regs}
    print("  slstm_steps " + json.dumps(row))
    torch.cuda.empty_cache()
    return row


# ---------------------------------------------------------------------------
# phase 10: serving xlstm-350m
# ---------------------------------------------------------------------------

def _xlstm_route_checks(sk, cfg):
    """(0) At full width in fp32: one sLSTM block's kernel route (no
    gradient recorded) against its plain route (a gradient recorded), S =
    1024 after a 256-token prefix that leaves a carried state; one mLSTM
    block's chunked form (256) against its per-step one, S = 512. Outputs
    and new states within 1e-4 of their scale."""
    from repro_torch.models import xlstm
    gen = torch.Generator(device="cuda").manual_seed(7)
    out = {}

    def check(name, got, want):
        err, scale = _rel_err(got, want.detach())
        out[name] = [err, scale]
        if not err <= 1e-4 * scale:
            raise AssertionError(f"xlstm route check {name}: {err:.3e} > "
                                 f"1e-4 x {scale:.3e}")
    p = xlstm.init_slstm(gen, cfg, torch.float32, device="cuda")
    x = torch.randn((1, 1280, cfg.d_model), generator=gen, device="cuda")
    state = xlstm.init_slstm_state(cfg, 1, device="cuda")
    before = sk.LAUNCHES["slstm_steps"]
    with torch.no_grad():
        xlstm.slstm_forward(p, x[:, :256], cfg, state)
        plain_state = tuple(t.clone() for t in state)
        got, _ = xlstm.slstm_forward(p, x[:, 256:], cfg, state)
    if sk.LAUNCHES["slstm_steps"] != before + 2:
        raise AssertionError("the sLSTM kernel route was not taken")
    with torch.enable_grad():
        want, _ = xlstm.slstm_forward(
            p, x[:, 256:].clone().requires_grad_(True), cfg, plain_state)
    if sk.LAUNCHES["slstm_steps"] != before + 2:
        raise AssertionError("the sLSTM plain route launched the kernel")
    check("slstm out", got, want)
    for name, a, b in zip("cnhm", state, plain_state):
        check(f"slstm {name}", a, b)
    _release_graph(plain_state)

    p = xlstm.init_mlstm(gen, cfg, torch.float32, device="cuda")
    x = torch.randn((1, 512, cfg.d_model), generator=gen, device="cuda")
    with torch.no_grad():
        want, st_w = xlstm.mlstm_forward(
            p, x, dataclasses.replace(cfg, xlstm_chunk=0))
        got, st_g = xlstm.mlstm_forward(
            p, x, dataclasses.replace(cfg, xlstm_chunk=256))
    check("mlstm out", got, want)
    for name, a, b in zip(("C", "n", "m"), st_g, st_w):
        check(f"mlstm {name}", a, b)
    print("  (0) full width, fp32: sLSTM kernel route vs plain (S=1024, "
          "carried state), mLSTM chunked (256) vs per-step (S=512): "
          "[max abs err, scale] " + json.dumps(out))


def _count_launches(model, names, counter):
    """The model with the kernel launches of each call of the named lanes
    recorded (``counter()`` reads the launch count)."""
    counts = {n: [] for n in names}

    def wrap(name, fn):
        def run(*a, **kw):
            before = counter()
            out = fn(*a, **kw)
            counts[name].append(counter() - before)
            return out
        return run
    return dataclasses.replace(model, **{n: wrap(n, getattr(model, n))
                                         for n in names}), counts


def phase_xlstm(sk):
    from repro_torch.configs import get_arch
    from repro_torch.core.engine import tree_items
    from repro_torch.models import build_model
    from repro_torch.serving import generate

    published = get_arch("xlstm-350m")
    _xlstm_route_checks(sk, dataclasses.replace(published, dtype="float32"))
    torch.cuda.empty_cache()

    # the one-shot prefill runs the chunked mLSTM (the reference's "opt"
    # setting): the per-step form makes about 15 launches per token and
    # layer
    cfg = dataclasses.replace(published, xlstm_chunk=256)
    B, S, NEW = 4, 4096, 32
    BUF = S + NEW
    n_slstm = cfg.blocks().count("slstm")
    n_mlstm = cfg.blocks().count("mlstm")
    print(f"  config {cfg.name}: d_model {cfg.d_model}, layers "
          f"{cfg.n_layers} ({n_mlstm} mlstm, {n_slstm} slstm), heads "
          f"{cfg.ssm_heads}, d_in {cfg.ssm_expand * cfg.d_model}, vocab "
          f"{cfg.vocab_size}, tied {cfg.tie_embeddings}, dtype {cfg.dtype}, "
          f"xlstm_chunk {cfg.xlstm_chunk}; B={B} S={S} new={NEW}")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    n = sum(leaf.numel() for _, leaf in tree_items(params))
    print(f"  parameters {n} (param_count() says {cfg.param_count()}: it "
          "undercounts xLSTM blocks, ROADMAP Queue 3)")
    if n != XLSTM_PARAMS:
        raise AssertionError(f"xlstm-350m has {n} parameters, not "
                             f"{XLSTM_PARAMS}")
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S))).cuda()

    # (a) the main path: generate, counters zeroed just before
    timed, events = _events_of(model, ("prefill", "decode_step"))
    counted, per_call = _count_launches(
        timed, ("prefill", "decode_step"),
        lambda: sk.LAUNCHES["slstm_steps"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    sk.reset_launches()
    t0 = time.perf_counter()
    toks, logits = generate(counted, params, {"tokens": prompts},
                            max_new_tokens=NEW, buf_len=BUF)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = sk.LAUNCHES["slstm_steps"]
    peak = torch.cuda.max_memory_allocated()
    prefill_ms = events["prefill"][0][0].elapsed_time(events["prefill"][0][1])
    dec = [a.elapsed_time(b) for a, b in events["decode_step"]]
    a = {"prefill_ms": prefill_ms, "ttft_ms": prefill_ms,
         "decode_ms_per_token": statistics.mean(dec),
         "decode_ms_median": statistics.median(dec),
         "wall_s": wall, "tok_s": B * NEW / wall,
         "prefill_tok_s": B * S / (prefill_ms / 1e3),
         "peak_bytes": peak, "allocated_before_bytes": before,
         "slstm_launches": launches,
         "slstm_launches_prefill": per_call["prefill"],
         "slstm_launches_per_decode_step": sorted(set(
             per_call["decode_step"]))}
    print("  (a) generate " + json.dumps(a))
    print(f"  first tokens {toks[:, :8].tolist()}")
    if per_call["prefill"] != [n_slstm] or set(
            per_call["decode_step"]) != {n_slstm}:
        raise AssertionError(f"slstm_steps launches {per_call}: not "
                             f"{n_slstm} per prefill and per decode step")
    if launches != n_slstm * NEW:
        raise AssertionError(f"slstm_steps launched {launches} times, not "
                             f"{n_slstm * NEW}")
    if toks.shape != (B, NEW) or not bool(torch.isfinite(logits).all()):
        raise AssertionError("generate gave a bad shape or non-finite logits")
    if not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError("token ids out of the vocabulary")
    # where the time goes: the same call traced, with 8 new tokens
    prof = _profile_generate(generate, timed, params, prompts, BUF, 8,
                             prefill_kernel=("slstm", n_slstm))
    prof["prefill_ms"] = events["prefill"][-1][0].elapsed_time(
        events["prefill"][-1][1])
    prof["slstm_share_of_prefill"] = (prof["slstm_prefill_ms"]
                                      / prof["prefill_ms"])
    print("  (a) profile " + json.dumps(prof))
    print(f"  (a) slstm kernels: {prof['slstm_prefill_ms']:.2f} ms of the "
          f"traced prefill's {prof['prefill_ms']:.2f} "
          f"({prof['slstm_share_of_prefill']:.1%}), "
          f"{prof['slstm_kernels']} launches in the traced call (of "
          f"{n_slstm * 8} launched)")

    # (b) one prompt in chunks of 512: the recurrent states carried
    sk.reset_launches()
    states, start = model.make_state(params, {"tokens": prompts[:1]}, BUF)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for j in range(0, S, 512):
        lg, states = model.prefill_chunk(params, states,
                                         prompts[:1, j:j + 512], start + j)
    e1.record()
    torch.cuda.synchronize()
    n_chunks = -(-S // 512)
    diff = float((lg[0] - logits[0]).abs().max())
    print(f"  (b) chunked prefill (512): {e0.elapsed_time(e1):.1f} ms, "
          f"slstm launches {sk.LAUNCHES['slstm_steps']}, max |last-token "
          f"logits - (a)'s| {diff:.4f} (information; logits scale "
          f"{float(logits[0].abs().max()):.2f})")
    if sk.LAUNCHES["slstm_steps"] != n_slstm * n_chunks:
        raise AssertionError("the chunks did not run the kernel")
    if not bool(torch.isfinite(lg).all()):
        raise AssertionError("non-finite chunked-prefill logits")
    m_max = {kind: max(float(states["cycle"][f"b{j}"][-1].abs().max())
                       for j, k in enumerate(cfg.layer_pattern) if k == kind)
             for kind in ("mlstm", "slstm")}
    del params, states, timed, counted, model, lg, logits, toks
    torch.cuda.empty_cache()
    # (information) the same one-shot / chunked comparison in fp32, at two
    # prompt lengths: how far rounding alone carries the two apart through
    # 24 random-weight layers while the stabilisers m grow with the length
    model = build_model(dataclasses.replace(cfg, dtype="float32"))
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    gap = {"max_abs_m_after_b": m_max}
    for L in (1024, S):
        one, _ = model.prefill(params, {"tokens": prompts[:1, :L]}, BUF)
        states, _ = model.make_state(params, {"tokens": prompts[:1]}, BUF)
        for j in range(0, L, 512):
            lg, states = model.prefill_chunk(params, states,
                                             prompts[:1, j:j + 512], j)
        gap[f"fp32_len{L}"] = [float((lg - one).abs().max()),
                               float(one.abs().max())]
        del states
    print("  (b) information: [max |one-shot - chunked| logits, scale] "
          + json.dumps(gap))
    del params, model, one, lg
    torch.cuda.empty_cache()

    # (c) the launcher on the published config (xlstm_chunk = 0, the
    # per-step mLSTM: a 64-token chunk makes about 15 launches per token
    # and layer) at full width
    _launcher_drill("xlstm-350m", {"slstm_steps": sk})
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 11: the tree path's pair, sq_dist and apply_update
# ---------------------------------------------------------------------------

def _bf16_ulp(t):
    """One bf16 ulp (8 significant bits) at each entry's magnitude."""
    _, e = torch.frexp(t.float())
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32), e - 8)


def _pair_inputs(n, xd, ad, gen):
    x = torch.randn((n,), generator=gen, device="cuda").to(xd)
    a = torch.randn((n,), generator=gen, device="cuda").to(ad)
    return x, a


def _check_pair(pk, ref, name, x, a, coef, errs, what):
    """One kernel against its plain version; sq_dist within
    SQ_DIST_RTOL, twice with the same bits; apply_update within 1e-6
    (fp32) or one bf16 ulp of each entry (bf16)."""
    if name == "sq_dist":
        got, again = pk.sq_dist(x, a), pk.sq_dist(x, a)
        torch.cuda.synchronize()
        want = ref.sq_dist_plain(x, a)
        if not torch.equal(got, again):
            raise AssertionError(f"sq_dist {what}: two calls differ")
        err = abs(float(got) - float(want))
        rel = err / max(abs(float(want)), 1e-30)
        ok = rel <= SQ_DIST_RTOL
    else:
        got = pk.apply_update(x, a, coef)
        torch.cuda.synchronize()
        want = ref.apply_plain(x, a, coef)
        d = (got.float() - want.float()).abs()
        err = float(d.max())
        rel = err / max(float(want.float().abs().max()), 1e-30)
        bar = _bf16_ulp(want) if x.dtype == torch.bfloat16 else 1e-6
        ok = bool((d <= bar).all())
        del d
    errs[name] = (max(errs[name][0], err), max(errs[name][1], rel))
    if not ok:
        raise AssertionError(f"{name} {what}: err {err:.3e} (rel "
                             f"{rel:.3e}) over its bar")
    return err


def phase_pair(pk, ref):
    gen = torch.Generator(device="cuda").manual_seed(11)
    errs = {k: (0.0, 0.0) for k in PAIR_REPLACES}
    coef = torch.tensor([0.1 - 0.5 / 3.0], device="cuda")
    for name, ns in PAIR_N.items():
        for xd, ad in PAIR_DTYPES:
            for n in ns:
                x, a = _pair_inputs(n, xd, ad, gen)
                _check_pair(pk, ref, name, x, a, coef, errs,
                            f"n={n} {xd}/{ad}")
        # a stacked leaf's row at an odd element offset (element-wise path)
        leaf = torch.randn((4, 40001), generator=gen,
                           device="cuda").to(torch.bfloat16)
        c = torch.randn((40001,), generator=gen, device="cuda")
        _check_pair(pk, ref, name, leaf[1], c, coef, errs, "odd offset")
        print(f"  {name}: checked the test cases and an odd offset")
    rows = {}
    for name in PAIR_REPLACES:
        timing = {}
        for n in PAIR_SLICE_N:
            for xd, ad in ((torch.bfloat16, torch.float32),
                           (torch.float32, torch.float32)):
                x, a = _pair_inputs(n, xd, ad, gen)
                err = _check_pair(pk, ref, name, x, a, coef, errs,
                                  f"n={n} {xd}/{ad}")
                out = torch.empty_like(x)
                if name == "sq_dist":
                    kern = lambda: pk.sq_dist(x, a)
                    plain = lambda: ref.sq_dist_plain(x, a)
                    lib = lambda: torch.dist(x, a) ** 2
                    nbytes = pk.cost("sq_dist", 1, n,
                                     x_bytes=x.element_size(),
                                     a_bytes=a.element_size())["bytes"]
                else:
                    kern = lambda: pk.apply_update(x, a, coef, out=out)
                    plain = lambda: ref.apply_plain(x, a, coef, out=out)
                    lib = lambda: torch.lerp(x, a, coef, out=out)
                    nbytes = pk.cost("apply_update", 1, n,
                                     x_bytes=x.element_size(),
                                     a_bytes=a.element_size())["bytes"]
                key = f"{n} {str(xd)[6:]}/{str(ad)[6:]}"
                timing[key] = {
                    "ms": _time_ms(kern), "plain_ms": _time_ms(plain),
                    "library_ms": _time_ms(lib) if xd == ad else None,
                    "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                    "bytes": nbytes, "max_abs_err": err}
                print(f"  {name} {key}: " + json.dumps(timing[key]))
                del x, a, out
                torch.cuda.empty_cache()
        n = PAIR_SLICE_N[0]
        head = timing[f"{n} bfloat16/float32"]
        same = timing[f"{n} float32/float32"]
        rows[name] = {
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": PAIR_REPLACES[name], "launches": 0,
            "max_abs_err": errs[name][0], "max_rel_err": errs[name][1],
            "tol_rel": SQ_DIST_RTOL if name == "sq_dist" else
            "1e-6 abs fp32, one bf16 ulp bf16",
            # the headline: the tree path's bf16 leaf against the fp32
            # center at the largest leaf; one PyTorch call computes the
            # function only on inputs of one dtype, so library_ms is the
            # fp32 / fp32 case's, beside that case's own kernel time
            "shape": [n], "dtypes": "bfloat16/float32", "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": "bytes", "library_ms": same["library_ms"],
            "library_call": ("torch.dist(x, a) ** 2" if name == "sq_dist"
                             else "torch.lerp(x, a, coef, out=out)"),
            "ms_fp32": same["ms"], "bound_ms_fp32": same["bound_ms"],
            "timings": timing}
    return rows


# ---------------------------------------------------------------------------
# phase 12: the tree path, yi-6b at full width
# ---------------------------------------------------------------------------

def _timed_rounds(trainer_mod, step, box, batches, label):
    """Run ``step`` over ``batches`` from the state in the one-element list
    ``box`` (taken out of it, so that no caller keeps a round's input
    alive), with CUDA events around each ``apply_round``; print and return
    the last state and each round's numbers."""
    state = box.pop()
    apply_round = trainer_mod.consensus.apply_round
    events = []

    def timed_apply_round(*a, **kw):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = apply_round(*a, **kw)
        e1.record()
        events.append((e0, e1))
        return out

    trainer_mod.consensus.apply_round = timed_apply_round
    rounds = []
    try:
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, b())
            torch.cuda.synchronize()
            round_ms = (time.perf_counter() - t0) * 1e3
            cons_ms = events[-1][0].elapsed_time(events[-1][1])
            row = {"round": state.round - 1, "loss": float(m["train_loss"]),
                   "consensus_dist": float(m["consensus_dist"]),
                   "round_ms": round_ms, "consensus_ms": cons_ms,
                   "local_ms": round_ms - cons_ms,
                   "peak_bytes": torch.cuda.max_memory_allocated(),
                   "allocated_bytes": torch.cuda.memory_allocated()}
            rounds.append(row)
            print(f"  {label} round " + json.dumps(row))
    finally:
        trainer_mod.consensus.apply_round = apply_round
    return state, rounds


@contextlib.contextmanager
def _plain_pair(core_pp, ref):
    """``core/pullpush.py`` on ``ref.py``'s plain functions in place of the
    ``sq_dist`` / ``apply_update`` kernels."""
    kernels = core_pp.sq_dist, core_pp.apply_update
    core_pp.sq_dist, core_pp.apply_update = ref.sq_dist_plain, ref.apply_plain
    try:
        yield
    finally:
        core_pp.sq_dist, core_pp.apply_update = kernels


def _plain_round(core_pp, ref, stacked):
    """One Eq. 5 round on ``ref.py``'s plain functions in place of the
    kernels."""
    with _plain_pair(core_pp, ref):
        return core_pp.pullpush(stacked, 0.1, 0.5)[0], \
            core_pp.worker_dists(stacked)


def phase_tree(pk, ref):
    from repro_torch.configs import DPPFConfig, get_arch
    from repro_torch.core import consensus
    from repro_torch.core import pullpush as core_pp
    from repro_torch.core.engine import tree_items
    from repro_torch.data import TokenTask, make_round_batch
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer
    from repro_torch.train import (
        RoundClock, init_train_state, make_round_step,
    )
    import repro_torch.train.trainer as trainer_mod

    cfg = dataclasses.replace(get_arch("yi-6b"), n_layers=LAYERS)
    M, tau, steps, seq, batch = SLICE_RUN
    model = build_model(cfg)
    dcfg = DPPFConfig(alpha=0.1, lam=0.5, tau=tau, consensus="simple_avg",
                      engine="tree")
    opt = make_optimizer("sgd", momentum=0.9, weight_decay=1e-3)
    clock = RoundClock.from_config(dcfg, base_lr=LR, total_steps=steps)
    task = TokenTask(vocab_size=cfg.vocab_size, seq_len=seq)
    gen = torch.Generator(device="cuda").manual_seed(0)
    print(f"  config {cfg.name}: layers {cfg.n_layers}, dtype {cfg.dtype}, "
          f"engine tree; M={M} tau={tau} steps={steps} seq={seq} "
          f"batch={batch} lr={LR}")

    torch.cuda.reset_peak_memory_stats()
    base_bytes = torch.cuda.memory_allocated()    # earlier phases' buffers
    state = init_train_state(model.init, opt, dcfg, M, gen, device="cuda")
    leaves = tree_items(state.params)
    n = sum(leaf[0].numel() for _, leaf in leaves)
    if state.engine is not None or n != cfg.param_count():
        raise AssertionError(f"tree state: engine {state.engine}, {n} "
                             f"parameters, param_count() "
                             f"{cfg.param_count()}")
    L = len(leaves)
    print(f"  stacked tree: {L} leaves, {n} parameters a worker, dtypes "
          f"{sorted({str(leaf.dtype) for _, leaf in leaves})}")
    # the persistent state's buffers, for phase 19(b)
    state_bytes = {k: sum(t.numel() * t.element_size()
                          for _, t in tree_items(v))
                   for k, v in (("params", state.params),
                                ("momentum", state.opt),
                                ("consensus state", state.cstate))}
    step = make_round_step(model.loss, opt, dcfg, clock=clock)
    batches = [lambda spec=spec: make_round_batch(
        task, 0, M, spec.tau, spec.start, batch, cfg, device="cuda")
        for spec in clock.rounds]
    box = [state]
    del state, leaves           # each round's input goes with its round
    pk.reset_launches()                     # main path: counts from here
    state, rounds = _timed_rounds(trainer_mod, step, box, batches,
                                  "simple_avg")
    eq5 = {k: pk.LAUNCHES[k] for k in PAIR_REPLACES}
    print(f"  launches over {len(rounds)} Eq. 5 rounds {json.dumps(eq5)}")
    want = {k: M * L * len(rounds) for k in PAIR_REPLACES}
    if eq5 != want:
        raise AssertionError(f"Eq. 5 rounds launched {eq5}, want {want}")
    if not all(math.isfinite(r["loss"]) for r in rounds):
        raise AssertionError("non-finite training loss")
    if not all(r["consensus_dist"] > 0 for r in rounds[1:]):
        raise AssertionError("consensus_dist is 0 after round 0")

    # one easgd round: the center state, a pull, then a push
    edcfg = dataclasses.replace(dcfg, consensus="easgd")
    eclock = RoundClock.from_config(edcfg, base_lr=LR,
                                    total_steps=steps + tau)
    estep = make_round_step(model.loss, opt, edcfg, clock=eclock)
    spec = eclock.rounds[state.round]
    box = [dataclasses.replace(
        state, cstate=consensus.init_state("easgd", state.params))]
    del state
    pk.reset_launches()
    state, erounds = _timed_rounds(
        trainer_mod, estep, box, [lambda: make_round_batch(
            task, 0, M, spec.tau, spec.start, batch, cfg, device="cuda")],
        "easgd")
    ez = {k: pk.LAUNCHES[k] for k in PAIR_REPLACES}
    print(f"  launches in the easgd round {json.dumps(ez)}")
    if ez != {"sq_dist": 3 * M * L, "apply_update": M * L}:
        raise AssertionError(f"easgd round launched {ez}")
    peak = torch.cuda.max_memory_allocated()
    print(f"  peak memory allocated {peak} bytes ({peak / 1e9:.2f} GB)")
    if peak > 70e9:
        raise AssertionError(f"peak memory {peak / 1e9:.1f} GB > 70 GB")
    later = rounds[1:] or rounds
    print("  mean of Eq. 5 rounds 1.. " + json.dumps({
        k: statistics.mean(r[k] for r in later)
        for k in ("round_ms", "consensus_ms", "local_ms")}))

    # one Eq. 5 round on the kernels against the plain functions
    stacked = state.params
    del state, step, estep
    torch.cuda.empty_cache()
    pk.reset_launches()
    new_k, _ = core_pp.pullpush(stacked, 0.1, 0.5)
    r_k = core_pp.worker_dists(stacked)
    kernel_launches = dict(pk.LAUNCHES)
    new_p, r_p = _plain_round(core_pp, ref, stacked)
    if dict(pk.LAUNCHES) != kernel_launches:
        raise AssertionError("the plain round launched a kernel")
    r_rel = float(((r_k - r_p).abs() / r_p).max())
    center = core_pp.tree_mean0(stacked)
    sq_rel = 0.0
    for (_, a), (_, c) in zip(tree_items(stacked), tree_items(center)):
        for row in a.view(M, -1):
            want = float(ref.sq_dist_plain(row, c.view(-1)))
            got = float(pk.sq_dist(row, c.view(-1)))
            sq_rel = max(sq_rel, abs(got - want) / want)
    del center
    worst, flips = 0.0, 0
    for (path, k), (_, p) in zip(tree_items(new_k), tree_items(new_p)):
        for m in range(M):
            d = (k[m].float() - p[m].float()).abs()
            u = _bf16_ulp(p[m])
            worst = max(worst, float((d / u).max()))
            flips += int((d > 0).sum())
            del d, u
    print(f"  kernel round vs plain round: r max rel err {r_rel:.3e} "
          f"(per (worker, leaf) sums of squares {sq_rel:.3e}), leaves max "
          f"err {worst:.3f} bf16 ulp, {flips} entries differ")
    if not (r_rel <= 1e-5 and sq_rel <= SQ_DIST_RTOL and worst <= 1.0):
        raise AssertionError("the kernel round differs from the plain one")
    del new_k, new_p, stacked
    torch.cuda.empty_cache()
    return {"eq5": eq5, "easgd": ez, "rounds": rounds, "easgd_round":
            erounds, "peak_bytes": peak, "state_bytes": state_bytes,
            "base_bytes": base_bytes, "n": n, "M": M,
            "plain_round_r_rel": r_rel,
            "plain_round_sq_rel": sq_rel, "plain_round_ulp": worst}


# ---------------------------------------------------------------------------
# phase 13: the overlap modes
# ---------------------------------------------------------------------------

def _expected_launches(dcfg, r, launch_names):
    """The kernel launches round r of a one-stage lowering runs: a
    staleness1 round is one fused_round with the stale epilogue; a fill
    round of doublebuf / staleness_k is one fused_round (partial_gram,
    mix_shard); a stale one runs its chunk Grams, then mix_from_gram (one
    stale_mix launch with the coefficient prologue). gram_coef: never."""
    want = dict.fromkeys(launch_names, 0)
    k = dcfg.staleness if dcfg.overlap == "staleness_k" else 1
    if dcfg.overlap == "staleness1":
        want.update(fused_round=1, partial_gram=1, stale_mix=1)
    elif r < k:
        want.update(fused_round=1, partial_gram=1, mix_shard=1)
    else:
        want.update(partial_gram=dcfg.overlap_chunks, mix_from_gram=1,
                    stale_mix=1)
    return want


def _equal(a, b, chunk=1 << 24):
    """Bit-equality of two (R, n) tensors on the card, column chunk by
    chunk (a whole-width comparison would be an (R, n) temporary)."""
    return all(torch.equal(x, y) for x, y in zip(a.split(chunk, dim=-1),
                                                  b.split(chunk, dim=-1)))


class _Events:
    """CUDA events around every call of a function in a module or class,
    collected per round."""

    def __init__(self, owner, name):
        self.owner, self.name = owner, name
        self.fn = getattr(owner, name)
        self.ms, self.pairs = [], []

    def __enter__(self):
        def timed(*a, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = self.fn(*a, **kw)
            e1.record()
            self.pairs.append((e0, e1))
            return out
        setattr(self.owner, self.name, timed)
        return self

    def close_round(self):
        self.ms.append(sum(a.elapsed_time(b) for a, b in self.pairs))
        self.pairs = []

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.fn)


def _overlap_run(pk, label, over, layers, rounds, plan, keep=False):
    from repro_torch.configs import DPPFConfig, get_arch
    from repro_torch.core.engine import ConsensusEngine
    from repro_torch.data import TokenTask, make_round_batch
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer
    from repro_torch.train import (
        RoundClock, init_train_state, make_round_step, set_participation,
    )
    import repro_torch.train.trainer as trainer_mod

    cfg = dataclasses.replace(get_arch("yi-6b"), n_layers=layers)
    M, tau, seq, batch = 4, 4, 64, 8
    model = build_model(cfg)
    dcfg = DPPFConfig(alpha=0.1, lam=0.5, tau=tau, consensus="simple_avg",
                      engine="flat", **over)
    opt = make_optimizer("sgd", momentum=0.9, weight_decay=1e-3)
    clock = RoundClock.from_config(dcfg, base_lr=LR,
                                   total_steps=rounds * tau)
    task = TokenTask(vocab_size=cfg.vocab_size, seq_len=seq)
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(model.init, opt, dcfg, M, gen, device="cuda")
    step = make_round_step(model.loss, opt, dcfg, clock=clock)
    boundary = "_staleness1" if dcfg.overlap == "staleness1" \
        else "_ring_round"
    out, held = [], None
    launched = dict.fromkeys(pk.LAUNCHES, 0)
    # the dropped row before each round, in page-locked host memory
    row = torch.empty((state.engine.layout.n,), pin_memory=True) \
        if plan else None
    with _Events(trainer_mod, boundary) as bev, \
            _Events(ConsensusEngine, "stage_comm") as gev:
        for spec in clock.rounds:
            r = spec.index
            drop, sync = (plan or {}).get(r, (None, 1.0))
            if plan is not None:
                mask = torch.ones(M)
                if drop is not None:
                    mask[drop] = 0.0
                state = set_participation(state, mask, sync=sync)
            b = make_round_batch(task, 0, M, spec.tau, spec.start, batch,
                                 cfg, device="cuda")
            if drop is not None:
                row.copy_(state.params[drop])
            missed = state.snap["missed"].tolist() if plan else None
            pk.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, b)
            torch.cuda.synchronize()
            round_ms = (time.perf_counter() - t0) * 1e3
            got = dict(pk.LAUNCHES)
            for key, v in got.items():
                launched[key] += v
            bev.close_round()
            gev.close_round()
            want = _expected_launches(dcfg, r, pk.LAUNCHES)
            if got != want:
                raise AssertionError(f"{label} round {r} launched {got}, "
                                     f"want {want}")
            rec = {"round": r, "loss": float(m["train_loss"]),
                   "consensus_dist": float(m["consensus_dist"]),
                   "staleness": m["staleness"], "round_ms": round_ms,
                   "boundary_ms": bev.ms[-1], "chunk_gram_ms": gev.ms[-1]}
            if plan is not None:
                frozen = drop is not None and missed[drop] < dcfg.staleness
                if drop is not None:
                    same = all(torch.equal(now, was.to("cuda"))
                               for now, was in zip(
                                   state.params[drop].split(1 << 24),
                                   row.split(1 << 24)))
                    if frozen != same:
                        raise AssertionError(
                            f"{label} round {r}: row {drop} "
                            f"{'moved' if frozen else 'did not move'} (it "
                            f"was {'frozen' if frozen else 'forced back'})")
                if sync == 0.0 and not _equal(state.params,
                                              state.snap["x"][-1]):
                    raise AssertionError(f"{label} round {r}: a sync = 0 "
                                         "round moved a row off its q")
                rec.update(dropped=drop, frozen=frozen, sync=sync)
            if not math.isfinite(rec["loss"]) or not (
                    r == 0 or rec["consensus_dist"] > 0):
                raise AssertionError(f"{label} round {r}: {rec}")
            out.append(rec)
            print(f"  {label} round " + json.dumps(rec))
    peak = torch.cuda.max_memory_allocated()
    print(f"  {label}: peak memory allocated {peak} bytes "
          f"({peak / 1e9:.2f} GB), layers {layers}, "
          f"n = {state.engine.layout.n}")
    if peak > 70e9:
        raise AssertionError(f"{label}: peak memory {peak / 1e9:.1f} GB > "
                             "70 GB: an (R, n) temporary beside the carry")
    if keep:
        held = state
    del state, step
    torch.cuda.empty_cache()
    k = dcfg.staleness if dcfg.overlap == "staleness_k" else 1
    stale = [rec for rec in out if rec["round"] >= k] or out
    summary = {key: statistics.mean(rec[key] for rec in stale)
               for key in ("round_ms", "boundary_ms", "chunk_gram_ms")}
    summary.update(peak_bytes=peak, rounds=[rec["round"] for rec in stale],
                   launches=launched)
    print(f"  {label}: mean of stale rounds " + json.dumps(summary))
    return summary, held


def _stale_against_plain(pk, ref, state):
    """(c): one stale application on the doublebuf run's full-width state
    (snapshot s, fresh view q = its params) on the kernels and on the
    plain functions; times of the epilogue and of a strided chunk Gram."""
    from repro_torch.train.trainer import _chunk_bounds
    s, q = state.snap["x"], state.params
    R, n = s.shape
    state.opt = None                    # the momentum's 19.5 GB go
    torch.cuda.empty_cache()
    T = torch.full((R, R), 1.0 / R, device="cuda")
    c0 = torch.full((R,), 0.1, device="cuda")        # alpha
    c1 = torch.full((R,), -0.5, device="cuda")       # -lam
    bounds = _chunk_bounds(n, 4)
    pk.reset_launches()
    Gk = sum(pk.partial_gram(s[:, a:b]) for a, b in bounds)
    Gp = sum(ref.partial_gram_plain(s[:, a:b]) for a, b in bounds)
    out = torch.empty_like(s)
    _, r_mix, _ = pk.mix_from_gram(s, T, c0, c1, Gk, out=out, base=q)
    _, rk, coef_k = pk.gram_coef(Gk[None], T, c0, c1)
    rp, coef_p = ref.gram_coef_plain(Gp, T, c0, c1)
    torch.cuda.synchronize()
    r_rel = float(((rk - rp).abs() / rp).max())
    err = torch.zeros(R, device="cuda")
    scale = torch.zeros(R, device="cuda")
    bitwise = True
    for a in range(0, n, ref.PLAIN_CHUNK * 4):
        b = min(n, a + ref.PLAIN_CHUNK * 4)
        got = out[:, a:b]
        plain = ref.stale_mix_plain(s[:, a:b], T, coef_p, q[:, a:b])
        err = torch.maximum(err, (got - plain).abs().amax(dim=1))
        scale = torch.maximum(scale, plain.abs().amax(dim=1))
        same = ref.stale_mix_plain(s[:, a:b], T, coef_k, q[:, a:b])
        bitwise = bitwise and torch.equal(got, same)
        del got, plain, same
    # the prologue's r is gram_coef's on the same Gram
    bitwise = bitwise and torch.equal(r_mix, rk)
    rel = float((err / scale).max())
    abs_err = float(err.max())
    print(f"  stale application, kernels vs plain: r max rel err "
          f"{r_rel:.3e}, rows max err {rel:.3e} of their scale "
          f"(tolerance {OVERLAP_TOL}); epilogue bit-equal to the plain "
          f"q + (mix(s) - s) on gram_coef's coefficients, its r to "
          f"gram_coef's: {bitwise}")
    if not (rel <= OVERLAP_TOL and r_rel <= OVERLAP_TOL and bitwise):
        raise AssertionError("the stale application differs from plain")
    # times at the main path's shape
    a, b = bounds[0]
    contiguous = out.view(-1)[:R * (b - a)].view(R, b - a)
    contiguous.copy_(s[:, a:b])
    times = {
        "stale_mix": (
            _time_ms(lambda: pk.stale_mix(s, T, coef_k, q, out=out)),
            _time_ms(lambda: ref.stale_mix_plain(s, T, coef_k, q, out=out),
                     reps=1, warm=1),
            None),
        "mix_from_gram": (
            _time_ms(lambda: pk.mix_from_gram(s, T, c0, c1, Gk, out=out,
                                              base=q)),
            _time_ms(lambda: ref.mix_from_gram_plain(
                s, T, c0, c1, Gk, out=out, base=q), reps=1, warm=1),
            None),
    }
    strided_ms = _time_ms(lambda: pk.partial_gram(s[:, a:b]))
    contiguous_ms = _time_ms(lambda: pk.partial_gram(contiguous))
    chunk_bound = pk.cost("partial_gram", R, b - a)["bytes"] \
        / HBM_BYTES_PER_S * 1e3
    print(f"  partial_gram on a 4-chunk column slice ({R}, {b - a}) of the "
          f"({R}, {n}) view: strided {strided_ms:.4f} ms, contiguous copy "
          f"{contiguous_ms:.4f} ms, bound {chunk_bound:.4f} ms (bytes)")
    rows = {}
    for name, (ms, plain_ms, lib_ms) in times.items():
        work = pk.cost(name, R, n, base=True)    # with the fresh view q
        t_bytes = work["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = work["flops"] / FP32_FLOPS * 1e3
        rows[name] = {
            "name": name, "route": "cuda", "source": STALE_SOURCE,
            "replaces": STALE_REPLACES[name], "launches": 0,
            "max_abs_err": 0.0 if bitwise else abs_err,
            "max_rel_err": 0.0 if bitwise else rel, "tol_rel": OVERLAP_TOL,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms,
            "round_vs_plain_rel_err": rel}
    rows["partial_gram_strided"] = {"ms": strided_ms,
                                    "contiguous_ms": contiguous_ms,
                                    "bound_ms": chunk_bound,
                                    "shape": [R, b - a], "ld": n}
    del out, contiguous
    return rows


def _k1_pin(pk):
    """(c): doublebuf in one chunk against staleness_k k = 1 in one chunk,
    3 rounds at full width and 1 layer from one seed: bit for bit."""
    kept = {}
    for label, over in (("doublebuf", dict(overlap="doublebuf",
                                           overlap_chunks=1)),
                        ("k=1", dict(overlap="staleness_k", staleness=1,
                                     overlap_chunks=1))):
        _, st = _overlap_run(pk, f"pin {label}", over, 1, 3, None,
                             keep=True)
        x = st.snap["x"]
        kept[label] = (st.params, x[0] if isinstance(x, list) else x)
        del st, x
        torch.cuda.empty_cache()
    (pa, sa), (pb, sb) = kept["doublebuf"], kept["k=1"]
    same = _equal(pa, pb) and _equal(sa, sb)
    print(f"  doublebuf (1 chunk) and staleness_k k=1 (1 chunk) after 3 "
          f"rounds: params and snapshot bit-equal: {same}")
    if not same:
        raise AssertionError("staleness_k k=1 differs from doublebuf")
    del kept, pa, pb, sa, sb
    torch.cuda.empty_cache()


def _launcher_overlap(pk):
    """(d): the launcher with --overlap doublebuf --log-every-round."""
    from repro_torch.launch.train import main as train_main
    path = os.path.join(ROOT, "build", "chip_smoke", "round_metrics.jsonl")
    pk.reset_launches()
    loss = train_main(["--arch", "yi-6b", "--smoke", "--workers", "4",
                       "--tau", "4", "--steps", "16", "--seq", "16",
                       "--batch", "2", "--overlap", "doublebuf",
                       "--log-every-round", path])
    with open(path) as fh:
        recs = [json.loads(line) for line in fh]
    stal = [r["staleness"] for r in recs]
    print(f"  launcher --overlap doublebuf: eval loss {loss:.4f}, "
          f"{len(recs)} records, staleness {stal}, launches "
          f"{json.dumps(dict(pk.LAUNCHES))}")
    if not math.isfinite(loss) or stal != [0.0] + [1.0] * 3 \
            or [r["round"] for r in recs] != [0, 1, 2, 3] \
            or pk.LAUNCHES["stale_mix"] != 3:
        raise AssertionError("the overlap launcher's records are off")


def phase_overlap(pk, ref, none_mode):
    view4 = 4 * MAIN_N * 4
    n2 = 870_338_560
    print(f"  reckoning: one (4, n) fp32 view is {view4 / 1e9:.2f} GB at 4 "
          f"layers, {4 * n2 * 4 / 1e9:.2f} GB at 2; with one snapshot the "
          f"carry is params + momentum + snapshot, ~"
          f"{none_mode['peak_bytes'] / 1e9 + view4 / 1e9:.1f} GB at 4 "
          f"layers (phase 3's peak + a view); a k = 2 ring needs 4 views + "
          f"~9.8 GB = {(4 * view4) / 1e9 + 9.8:.1f} GB at 4 layers (more "
          f"than the card), {4 * 4 * n2 * 4 / 1e9 + 7.0:.1f} GB at 2")
    summaries = {"none (phase 3)": none_mode}
    for label, over, layers, rounds, plan in OVERLAP_RUNS:
        keep = label == "doublebuf"
        summary, st = _overlap_run(pk, label, over, layers, rounds, plan,
                                   keep=keep)
        summaries[label] = summary
        if keep:
            rows = _stale_against_plain(pk, ref, st)
        del st
        torch.cuda.empty_cache()
    # the counters are zeroed before each round: the runs' sums
    totals = {key: sum(summaries[label]["launches"][key]
                       for label, *_ in OVERLAP_RUNS)
              for key in pk.LAUNCHES}
    print("  launches over the phase's runs " + json.dumps(totals))
    print("  modes side by side " + json.dumps(summaries))
    _k1_pin(pk)
    _launcher_overlap(pk)
    strided = rows.pop("partial_gram_strided")
    for name in ("stale_mix", "mix_from_gram"):
        rows[name]["launches"] = totals[name]
        rows[name]["launches_by_path"] = {
            "yi-6b training, overlap modes (phase 13)": totals[name]}
        rows[name]["boundary_ms"] = summaries["doublebuf"]["boundary_ms"]
    return {"rows": rows, "launches": totals, "summaries": summaries,
            "partial_gram_strided": strided}


# ---------------------------------------------------------------------------
# phase 14: the paper's harness and measures
# ---------------------------------------------------------------------------

# (a) the README quickstart through run_distributed: (label, DPPFConfig
# settings, steps)
HARNESS_RUNS = (("tree", dict(alpha=0.1, lam=0.5, tau=4), 300),
                ("flat", dict(alpha=0.1, lam=0.5, tau=4, engine="flat"), 300),
                ("ddp", dict(consensus="ddp"), 100))
HARNESS_M = 4
MLP_LEAVES = 6           # the benchmark MLP: 3 layers x (w, b)
HARNESS_SUITES = "theorem1,table2,method_zoo"
# (d): table2 averages each row over its two seeds (``table2_comm.SEEDS``);
# here over the first (a cut of repetitions: the run's time limit)
HARNESS_TABLE2_SEEDS = 1
FUSED_SPREAD = 1e-5      # (b) the reference test's near-consensus spread
FUSED_VIEW_RTOL = 1e-5   # (b) full width: the fp32 update against the tree's


def _harness_launches(label, rounds, M):
    """The launches a quickstart run implies: the tree engine runs one
    ``sq_dist`` and one ``apply_update`` per (worker, leaf) a round, the
    flat engine one ``fused_round`` a round; both end with the final
    ``worker_dists`` (one ``sq_dist`` per (worker, leaf)); DDP none."""
    from repro_torch.kernels.pullpush import pullpush as pk
    want = dict.fromkeys(pk.LAUNCHES, 0)
    if label == "ddp":
        return want
    pair = M * MLP_LEAVES
    if label == "tree":
        want.update(sq_dist=pair * rounds + pair, apply_update=pair * rounds)
    else:           # each fused_round is a partial_gram and a mix
        want.update({k: rounds for k in ("fused_round", "partial_gram",
                                         "mix_shard")},
                    sq_dist=pair)
    return want


def _quickstart(pk, common):
    """(a): each run on the card, launches counted, then on the CPU from
    the same weights: ``run_distributed`` draws them from its seed on a CPU
    generator (``mlp_init``) and moves them to the data's device."""
    from repro_torch.configs import DPPFConfig
    from repro_torch.train import RoundClock
    dev_data = common.default_data()
    cpu_data = common.default_data(device="cpu")
    out, total = {}, {k: 0 for k in pk.LAUNCHES}
    for label, dkw, steps in HARNESS_RUNS:
        dcfg = DPPFConfig(**dkw)
        rounds = RoundClock.from_config(dcfg, base_lr=0.05,
                                        total_steps=steps).total_rounds
        torch.cuda.synchronize()
        pk.reset_launches()                 # main path: counts from here
        t0 = time.perf_counter()
        card = common.run_distributed(dev_data, dcfg, M=HARNESS_M,
                                      steps=steps)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        got = {k: pk.LAUNCHES[k] for k in total}
        t0 = time.perf_counter()
        cpu = common.run_distributed(cpu_data, dcfg, M=HARNESS_M,
                                     steps=steps)
        cpu_s = time.perf_counter() - t0
        want = _harness_launches(label, rounds, HARNESS_M)
        row = {"card_s": card_s, "cpu_s": cpu_s, "rounds": rounds,
               "width": [card.consensus_dist, cpu.consensus_dist],
               "train_err": [card.train_err, cpu.train_err],
               "test_err": [card.test_err, cpu.test_err],
               "launches": got}
        print(f"  quickstart {label} ({steps} steps) " + json.dumps(row))
        if got != want:
            raise AssertionError(f"quickstart {label} launched {got}, the "
                                 f"code implies {want}")
        if abs(card.consensus_dist - cpu.consensus_dist) > 1e-3:
            raise AssertionError(f"quickstart {label}: width on the card "
                                 f"{card.consensus_dist}, on the CPU "
                                 f"{cpu.consensus_dist}")
        for k in ("train_err", "test_err"):
            a, b = getattr(card, k), getattr(cpu, k)
            if not (math.isfinite(a) and abs(a - b) <= 0.5):
                raise AssertionError(f"quickstart {label}: {k} {a} on the "
                                     f"card, {b} on the CPU")
        for k in total:
            total[k] += got[k]
        out[label] = row
        if label == "tree":
            workers = card.workers
    return out, total, workers, dev_data


def _fused_checks(pk, ref, pullpush_fused, core_pp):
    """(b): ``pullpush_fused`` (two launches over the tree's own leaves) on
    the card: the reference test's near-consensus case against the port's
    tree ``pullpush`` (the sq_dist / apply_update route); then yi-6b's
    stacked bf16 tree at 4 layers, bit-equal to the route it replaced
    (the engine's flatten, ``fused_round`` on the fp32 view, unflatten)
    and held against the tree route; its peak memory beside that
    route's; times at full width beside that route, each pass alone, the
    tree route and the plain versions. Returns the leaf kernels' rows."""
    from repro_torch.configs import get_arch
    from repro_torch.core.engine import (
        ConsensusEngine, tree_from_items, tree_items,
    )
    from repro_torch.models import build_model
    want_one = dict.fromkeys(pk.LAUNCHES, 0)
    want_one.update(leaf_gram=1, leaf_mix=1)
    gen = torch.Generator(device="cuda").manual_seed(14)
    # near consensus: M = 8, n = 4096, spread 1e-5 (coef ~ -800)
    base = torch.randn((4096,), generator=gen, device="cuda")
    small = {"w": base[None] + FUSED_SPREAD * torch.randn(
        (8, 4096), generator=gen, device="cuda")}
    pk.reset_launches()
    got, r = pullpush_fused(small, 0.1, 0.5)
    one = dict(pk.LAUNCHES)
    want, _ = core_pp.pullpush(small, 0.1, 0.5)
    r_exact = core_pp.worker_dists(small)
    near = {"r_rel": float(((r - r_exact).abs() / r_exact).max()),
            "max_abs": float((got["w"] - want["w"]).abs().max())}
    print("  pullpush_fused near consensus (M = 8, n = 4096, spread 1e-5) "
          + json.dumps(near) + f", launches {json.dumps(one)}")
    if not (near["r_rel"] <= 1e-3 and near["max_abs"] <= 2e-3):
        raise AssertionError("pullpush_fused near consensus differs from "
                             "the tree route")
    if one != want_one:
        raise AssertionError(f"pullpush_fused launched {one}; want one "
                             "leaf_gram and one leaf_mix")
    del small, got, want

    cfg = dataclasses.replace(get_arch("yi-6b"), n_layers=LAYERS)
    M = 4
    torch.cuda.empty_cache()
    p = build_model(cfg).init(gen, "cuda")
    items = []
    for path, leaf in tree_items(p):
        # M distinct workers around the model: x + 0.01 N(0, 1) each
        w = leaf[None].expand((M,) + leaf.shape).to(torch.float32)
        w = w + 0.01 * torch.randn(w.shape, generator=gen, device="cuda")
        items.append((path, w.to(leaf.dtype)))
        del w
    del p
    stacked = tree_from_items(items)
    del items
    leaves = [l for _, l in tree_items(stacked)]
    n = sum(l[0].numel() for l in leaves)
    tree_bytes = sum(l.numel() * l.element_size() for l in leaves)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    pk.reset_launches()
    got, r = pullpush_fused(stacked, 0.1, 0.5)
    torch.cuda.synchronize()
    one = dict(pk.LAUNCHES)
    peak_new = torch.cuda.max_memory_allocated() - held
    # the route it replaced: the engine's flatten, fused_round in place on
    # the fp32 view, unflatten
    eng = ConsensusEngine.from_stacked(stacked, precise=True)
    T = eng.uniform.expand(M, M).contiguous()
    c0 = torch.full((M,), 0.1, device="cuda")
    c1 = torch.full((M,), -0.5, device="cuda")

    def replaced():
        flat = eng.flatten(stacked)
        _, r_c, _ = pk.fused_round(flat, T, c0, c1, out=flat)
        return eng.unflatten(flat), r_c, flat
    held_c = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    want_c, r_c, view = replaced()
    torch.cuda.synchronize()
    peak_old = torch.cuda.max_memory_allocated() - held_c
    bit_equal = torch.equal(r, r_c) and all(
        torch.equal(k, w) for (_, k), (_, w) in zip(tree_items(got),
                                                    tree_items(want_c)))
    del want_c
    want, _ = core_pp.pullpush(stacked, 0.1, 0.5)
    center = core_pp.tree_mean0(stacked)
    r_tree = core_pp.worker_dists(stacked, center)
    coef = 0.1 - 0.5 / torch.clamp(r_tree, min=1e-12)
    # the update, held in fp32: the replaced route's view (the kernels'
    # fp32 values, bit for bit, before the cast) against the tree route's
    # apply_update on an fp32 copy of each row, relative to the larger of
    # |x| and |x_A| (the two routes round T x + (1 - c)(x - T x) and
    # x + c (T x - x), so they part by ~eps32 there). ``seen``: each leaf's
    # largest update on that basis, so the bar can see every leaf's mix
    view_rel, seen, cast_ok = 0.0, math.inf, True
    worst, flips, off = 0.0, 0, 0
    for (_, k), (_, t), (_, x), (_, c) in zip(
            tree_items(got), tree_items(want), tree_items(stacked),
            tree_items(center)):
        if k.dtype != t.dtype:
            raise AssertionError(f"pullpush_fused returned {k.dtype} for a "
                                 f"{t.dtype} leaf")
        size, cv, leaf_seen = x[0].numel(), c.reshape(-1), 0.0
        for m in range(M):
            v = view[m, off:off + size]
            cast_ok &= torch.equal(k[m].reshape(-1), v.to(k.dtype))
            xf = x[m].reshape(-1).float()
            tf = pk.apply_update(xf, cv, coef[m:m + 1])
            basis = torch.clamp(torch.maximum(xf.abs(), cv.abs()),
                                min=1e-30)
            view_rel = max(view_rel, float(((v - tf).abs() / basis).max()))
            leaf_seen = max(leaf_seen, float(((tf - xf).abs() / basis)
                                             .max()))
            # the bf16 results of the two routes, in ulps of the larger of
            # input and output
            d = (k[m].float() - t[m].float()).abs()
            u = _bf16_ulp(torch.maximum(x[m].float().abs(),
                                        t[m].float().abs()))
            worst = max(worst, float((d / u).max()))
            flips += int((d > 0).sum())
            del v, xf, tf, basis, d, u
        seen = min(seen, leaf_seen)
        off += size
    r_rel = float(((r - r_tree).abs() / r_tree).max())
    del want, view, center
    torch.cuda.empty_cache()
    # the kernels against their plain versions at full width
    errs = ErrLog()
    out_leaves = [k for _, k in tree_items(got)]
    _, _, G = pk.fused_round_leaves(leaves, T, c0, c1)
    _leaf_errs(pk, ref, errs, leaves, out_leaves, r, G, T, c0, c1)
    del got, out_leaves
    torch.cuda.empty_cache()
    floor_ms = 3 * tree_bytes / HBM_BYTES_PER_S * 1e3
    full = {"n": n, "dtypes": sorted({str(l.dtype) for l in leaves}),
            "tree_bytes": tree_bytes, "bit_equal_to_replaced": bit_equal,
            "r_rel": r_rel, "view_rel": view_rel, "update_rel_min": seen,
            "cast_exact": cast_ok, "max_ulp": worst, "entries_differ": flips,
            "peak_bytes_above_the_tree": peak_new,
            "replaced_peak_bytes_above_the_tree": peak_old,
            "launches": one}
    print(f"  pullpush_fused, yi-6b stacked at {LAYERS} layers, M = {M} "
          + json.dumps(full))
    if one != want_one:
        raise AssertionError(f"pullpush_fused launched {one}")
    if not bit_equal:
        raise AssertionError("pullpush_fused at full width is not bit-equal "
                             "to the flatten + fused_round + unflatten "
                             "route")
    if not (r_rel <= 1e-5 and view_rel <= FUSED_VIEW_RTOL and cast_ok
            and worst <= 2.0):
        raise AssertionError("pullpush_fused at full width differs from the "
                             "tree route")
    if seen <= 10 * FUSED_VIEW_RTOL:
        raise AssertionError(f"a leaf's update ({seen}) is too small for "
                             "the fp32 bar to see")
    ms = _time_ms(lambda: pullpush_fused(stacked, 0.1, 0.5), reps=5,
                  warm=1)
    replaced_ms = _time_ms(replaced, reps=5, warm=1)
    torch.cuda.empty_cache()
    # each pass alone, on one prepared table (launches not counted here)
    gram, mix, *_ = pk._leaf_launches(leaves, pk.leaf_table(leaves), T, c0,
                                      c1, 1e-12)
    gram_ms = _time_ms(gram)
    mix_ms = _time_ms(mix)
    del gram, mix
    torch.cuda.empty_cache()

    def flatten():
        return torch.cat([l.reshape(M, -1).float() for l in leaves], dim=1)

    def gram_plain():
        G_ = ref.partial_gram_plain(flatten())
        return ref.gram_coef_plain(G_, T, c0, c1)

    coef_k = c0 + c1 / torch.clamp(r, min=1e-12)

    def mix_plain():
        f = ref.mix_shard_plain(flatten(), T, coef_k)
        return [p_.reshape(l.shape).to(l.dtype) for p_, l in zip(
            f.split([l[0].numel() for l in leaves], dim=1), leaves)]
    gram_plain_ms = _time_ms(gram_plain, reps=3, warm=1)
    mix_plain_ms = _time_ms(mix_plain, reps=3, warm=1)
    torch.cuda.empty_cache()
    flat = eng.flatten(stacked)
    alone = _time_ms(lambda: pk.fused_round(flat, T, c0, c1, out=flat),
                     reps=5, warm=1)
    del flat, eng
    torch.cuda.empty_cache()
    tree_ms = _time_ms(lambda: core_pp.pullpush(stacked, 0.1, 0.5), reps=5,
                       warm=1)
    with _plain_pair(core_pp, ref):
        plain_ms = _time_ms(lambda: core_pp.pullpush(stacked, 0.1, 0.5),
                            reps=3, warm=1)
    full.update(pullpush_fused_ms=ms, replaced_ms=replaced_ms,
                leaf_gram_ms=gram_ms, leaf_mix_ms=mix_ms,
                fused_round_on_the_view_ms=alone,
                two_pass_floor_ms=floor_ms,
                one_pass_bound_ms=2 * tree_bytes / HBM_BYTES_PER_S * 1e3,
                tree_route_ms=tree_ms, plain_ms=plain_ms)
    print(f"  pullpush_fused {ms:.4f} ms (leaf_gram {gram_ms:.4f} + "
          f"leaf_mix {mix_ms:.4f}) against the two-pass floor "
          f"{floor_ms:.4f} ms ({100 * floor_ms / ms:.1f}%); the replaced "
          f"flatten + fused_round + unflatten {replaced_ms:.4f} ms (its "
          f"fused_round alone {alone:.4f}); peak bytes above the tree "
          f"{peak_new} against {peak_old}; the tree route {tree_ms:.4f} ms, "
          f"on the plain functions {plain_ms:.4f} ms")
    rows = {}
    for name, (kms, pms) in {"leaf_gram": (gram_ms, gram_plain_ms),
                             "leaf_mix": (mix_ms, mix_plain_ms)}.items():
        work = pk.cost(name, M, n, leaf_bytes=tree_bytes)
        t_bytes = work["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = work["flops"] / FP32_FLOPS * 1e3
        rows[name] = {
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": LEAF_REPLACES[name], "launches": 0,
            "max_abs_err": errs.abs[name], "max_rel_err": errs.rel[name],
            "tol_rel": TOL, "ms": kms, "plain_ms": pms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}
    del stacked, leaves
    torch.cuda.empty_cache()
    return {"near": near, "full": full, "rows": rows}


def _measures_checks(common, workers, data):
    """(c): Mean Valley and the Hessian measures on the tree run's card
    workers, on the card and on the CPU with the same draws."""
    from repro_torch.core import sharpness as sh
    from repro_torch.core.engine import tree_map
    from repro_torch.core.valley import mean_valley
    fb = {"x": data["x_train"][:1024], "y": data["y_train"][:1024]}
    fb_cpu = {k: v.cpu() for k, v in fb.items()}
    cpu_workers = [tree_map(lambda a: a.cpu(), w) for w in workers]
    out = {}
    for dev, ws, b in (("card", workers, fb), ("cpu", cpu_workers, fb_cpu)):
        sync = torch.cuda.synchronize if dev == "card" else (lambda: None)
        sync()
        t0 = time.perf_counter()
        mv = mean_valley(lambda p: common.mlp_loss(p, b)[0], ws, kappa=2.0,
                         step=0.05, max_steps=120)
        sync()
        t1 = time.perf_counter()
        avg = tree_map(lambda *ls: sum(ls) / len(ls), *ws)
        hm = sh.hessian_measures(lambda p, bb: common.mlp_loss(p, bb)[0],
                                 avg, b, torch.Generator().manual_seed(0))
        sync()
        t2 = time.perf_counter()
        out[dev] = {"mv": mv["mv"], "betas": mv["betas"], **hm,
                    "mv_s": t1 - t0, "hessian_s": t2 - t1}
        print(f"  measures on the {dev} " + json.dumps(out[dev]))
    c, p = out["card"], out["cpu"]
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)
    errs = {"mv": rel(c["mv"], p["mv"]),
            **{k: rel(c[k], p[k]) for k in ("lambda_max", "trace", "frob")}}
    print("  measures card vs cpu, relative " + json.dumps(errs))
    if errs["mv"] > 1e-4 or max(errs[k] for k in ("lambda_max", "trace",
                                                  "frob")) > 1e-3:
        raise AssertionError(f"measures on the card differ: {errs}")
    return {"card": c, "cpu": p, "rel": errs}


def _fast_suites(pk):
    """(d): ``repro_torch.benchmarks.run --fast`` on three suites, in this
    process (table2 on ``HARNESS_TABLE2_SEEDS`` of its seeds); every
    number of their CSV rows finite."""
    import contextlib
    import io
    from unittest import mock
    from repro_torch.benchmarks import run, table2_comm
    buf = io.StringIO()
    seeds = table2_comm.SEEDS[:HARNESS_TABLE2_SEEDS]
    pk.reset_launches()                     # main path: counts from here
    try:
        with contextlib.redirect_stdout(buf), \
                mock.patch.object(table2_comm, "SEEDS", seeds):
            secs = run.main(["--fast", "--only", HARNESS_SUITES])
    finally:
        print("\n".join("  " + line for line in
                        buf.getvalue().splitlines()))
    launches = dict(pk.LAUNCHES)
    bad = []
    n_rows = 0
    for line in buf.getvalue().splitlines():
        if line.startswith("#") or "=" not in line:
            continue
        n_rows += 1
        for kv in line.split(",")[1:]:
            v = kv.split("=", 1)[1]
            try:
                x = float(v)
            except ValueError:
                continue
            if not math.isfinite(x):
                bad.append(line)
    print(f"  --fast {HARNESS_SUITES} (table2 seeds {list(seeds)}): "
          f"{n_rows} rows, seconds "
          f"{json.dumps(secs)}, launches {json.dumps(launches)}")
    if bad or n_rows == 0:
        raise AssertionError(f"non-finite rows: {bad}")
    if launches["fused_round"] <= 0 or launches["sq_dist"] <= 0:
        raise AssertionError(f"the --fast suites launched {launches}")
    bad = _merged_launched(launches, "the --fast suites")
    if bad:
        raise AssertionError("; ".join(bad))
    return {"seconds": secs, "launches": launches, "rows": n_rows}


def phase_harness(pk, ref):
    from repro_torch.benchmarks import common
    from repro_torch.core import pullpush as core_pp
    from repro_torch.kernels.pullpush import pullpush_fused
    secs = {}
    t0 = time.perf_counter()
    runs, quick, workers, data = _quickstart(pk, common)
    secs["quickstart"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fused = _fused_checks(pk, ref, pullpush_fused, core_pp)
    secs["pullpush_fused"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    measures = _measures_checks(common, workers, data)
    secs["measures"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fast = _fast_suites(pk)
    secs["fast_suites"] = time.perf_counter() - t0
    launches = {k: quick[k] + fast["launches"][k] for k in quick}
    print("  phase 14 seconds " + json.dumps(secs))
    return {"runs": runs, "fused": fused, "measures": measures,
            "fast": fast, "launches": launches, "seconds": secs}


# ---------------------------------------------------------------------------
# phase 15: the sharded round on torch.distributed ranks
# ---------------------------------------------------------------------------

DEV = "cuda"                   # where the phase runs (the card)
SHARD_SEED = 15                # x's column shard j is drawn with seed 15 + j
SHARD_TOL = 1e-6               # of each row's scale, against fused_round
SHARDED_SOURCE = SOURCE
SHARDED_REPLACES = "src/repro/kernels/pullpush/pullpush.py:367"
# (b): yi-6b at full width cut to 1 layer, M = 4, tau 4, 2 rounds
# (doublebuf's round 0 and one stale round, within the run's time limit)
SH_LAYERS, SH_ROUNDS, SH_M, SH_TAU, SH_SEQ, SH_BATCH = 1, 2, 4, 4, 64, 8
SH_MESHES = ((2, 1), (1, 2))
# phase 16(b)'s configuration, the launcher's defaults (lr 0.3, sgd with
# momentum 0.9 and weight decay 1e-3, simple_avg, 4 chunks) at --workers 4
# --tau 4 --steps 16 --seq 64 --batch 8 --overlap staleness_k --staleness 1
# --elastic-drop 2,1,3 --quorum 4: (b)'s staleness_k case runs its first
# two rounds (row 2 out of round 1, which degrades below the quorum), and
# its 2x1 run writes the resume point from which 16(b) resumes
SUP_LR, SUP_STEPS, SUP_DROP, SUP_QUORUM = 0.3, 16, (2, 1, 3), 4
SUP_DCFG = dict(overlap="staleness_k", staleness=1, overlap_chunks=4,
                elastic=True)
# (label, overlap settings, rounds), each on every mesh of SH_MESHES:
# ``none`` runs one round (its rounds are alike: the run's time limit),
# doublebuf and staleness_k two (round 1 is their stale round)
SH_OVERLAPS = (("none", dict(overlap="none"), 1),
               ("doublebuf", dict(overlap="doublebuf", overlap_chunks=4),
                SH_ROUNDS),
               ("staleness_k", SUP_DCFG, SH_ROUNDS))
# where (b)'s 2x1 staleness_k run writes its resume point (one file, ~33.5
# GB: the machine takes at most 45 GiB of disk writes a call, so phase 16
# resumes from it instead of writing one of its own)
RESUME_POINT = os.path.join(ROOT, "build", "chip_smoke", "ckpt16",
                            "sharded.state.npz")
SUP_DISK = 40e9                # free disk the resume point needs
# each rank's block against the single-device run, of its parameter scale:
# 2e-5 (the CPU tests' fast-mode bar) where the mesh splits no column (the
# ranks run the single-device operations); 1e-3 where it does. There the
# Gram is summed over column shards in another order, which moves the fp32
# view by ulps, and the next round's bf16 local steps re-round it: a
# flipped bf16 rounding moves the parameters by lr times the change of the
# gradient (1.4e-4 of the scale seen on 1x2 doublebuf; the 1-layer model's
# single-device rounds show the same under any reduction order). The
# consensus itself is held per round: consensus_dist within SH_METRIC_BAR.
SH_BAR = {"2x1": 2e-5, "1x2": 1e-3}
SH_METRIC_BAR = 1e-5           # relative, each round's consensus_dist
# the kernels the sharded rounds of (b) must launch
SHARDED_KERNELS = ("fused_round_sharded", "partial_gram", "mix_shard",
                   "fused_round", "mix_from_gram", "stale_mix")
# those the staleness_k case must launch: its fill round's consensus, the
# stale round's chunk Grams and its mix from their Gram
RING_KERNELS = ("partial_gram", "mix_from_gram")
HIER_ULP = 1.0                 # (d): eps32 * max(|x|, 1) an entry


def _rank_entry(fn, rank, world, tmp, args):
    """A spawned rank: gloo on the one card (``launch.mesh.start``), a
    ``file://`` rendezvous in ``tmp``; ``fn``'s result is pickled beside
    it, a failure's traceback too."""
    import pickle
    import traceback
    # set before the rank's first allocation: two ranks share the card
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        from repro_torch.launch import mesh as mm
        mm.start(DEV, init_method=f"file://{tmp}/rendezvous", rank=rank,
                 world=world, timeout_s=600)
        out = fn(rank, world, *args)
        with open(os.path.join(tmp, f"{rank}.pkl"), "wb") as fh:
            pickle.dump(out, fh)
        torch.distributed.destroy_process_group()
    except BaseException:
        with open(os.path.join(tmp, f"{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        raise SystemExit(1)


def _spawn_ranks(fn, world, *args, timeout=600):
    """``[fn(r, world, *args) for r in range(world)]``, each in a rank of
    its own; every child is stopped before this returns or raises. Each
    caller's ``timeout`` is several times its ranks' usual seconds and
    short enough that a stalled phase fails, and says why, inside the
    script's limit."""
    import pickle
    import tempfile
    ctx = torch.multiprocessing.get_context("spawn")
    base = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(base, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="ranks-", dir=base)
    procs = [ctx.Process(target=_rank_entry, args=(fn, r, world, tmp, args))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        # the first rank that fails ends the wait: its peers, blocked in a
        # collective, are stopped below instead of waiting out gloo's timeout
        from multiprocessing.connection import wait
        deadline = time.monotonic() + timeout
        while not any(p.exitcode not in (None, 0) for p in procs):
            alive = [p.sentinel for p in procs if p.is_alive()]
            if not alive or time.monotonic() >= deadline:
                break
            wait(alive, min(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    errs = []
    for r, p in enumerate(procs):
        err = os.path.join(tmp, f"{r}.err")
        if os.path.exists(err):
            errs.append(f"rank {r}:\n" + open(err).read())
        elif p.exitcode != 0:
            errs.append(f"rank {r}: exit code {p.exitcode} (stopped "
                        f"after {timeout} s, or when a peer failed)")
    if errs:
        shutil.rmtree(tmp, ignore_errors=True)
        raise AssertionError("ranks failed:\n" + "\n".join(errs))
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"{r}.pkl"), "rb") as fh:
            out.append(pickle.load(fh))
    shutil.rmtree(tmp, ignore_errors=True)
    return out


def _shard_x(j, n_loc):
    """Column shard j of the (a) view: (4, n_loc) from seed 15 + j."""
    gen = torch.Generator(device=DEV).manual_seed(SHARD_SEED + j)
    x = torch.randn((MAIN_R, n_loc), generator=gen, device=DEV)
    return x.mul_(2.0).add_(1.0)


def _shard_stage_inputs():
    gen = torch.Generator(device=DEV).manual_seed(SHARD_SEED + 100)
    T = torch.softmax(torch.randn((MAIN_R, MAIN_R), generator=gen,
                                  device=DEV), dim=1)
    c0 = torch.linspace(0.1, 0.5, MAIN_R, device=DEV)
    c1 = torch.linspace(-0.4, -0.1, MAIN_R, device=DEV)
    return T, c0, c1


def _single_rank_round(pk, world):
    """(a), in this process before the ranks start: ``fused_round`` on the
    whole (4, n) view (the shards side by side), its r and coefficients
    for the ranks, and the check that its columns are ``mix_shard`` of a
    shard with those coefficients (the mix is column-local), which is
    what each rank holds its shard's output against."""
    n_loc = MAIN_N // world
    x = torch.empty((MAIN_R, MAIN_N), device=DEV)
    for j in range(world):
        x[:, j * n_loc:(j + 1) * n_loc] = _shard_x(j, n_loc)
    T, c0, c1 = _shard_stage_inputs()
    out, r, G = pk.fused_round(x, T, c0, c1)
    _, r1, coef = pk.gram_coef(G[None], T, c0, c1)
    x0 = x[:, :n_loc].contiguous()
    del x
    m0 = pk.mix_shard(x0, T, coef)
    col_err = float((m0 - out[:, :n_loc]).abs().max())
    del x0, m0, out
    torch.cuda.empty_cache()
    print(f"  (a) single-rank fused_round on (4, {MAIN_N}): r "
          f"{[round(v, 3) for v in r.tolist()]}; its first {n_loc} columns "
          f"against mix_shard of that shard with its coefficients: max abs "
          f"{col_err:.3e}; r from the Gram again: "
          f"{float((r1 - r).abs().max()):.3e}")
    if col_err > SHARD_TOL * 10:
        raise AssertionError("fused_round's columns are not mix_shard's")
    return {"r": r.cpu(), "coef": coef.cpu()}


def _time_alone(rank, world, fn, partner, reps=20, warm=3):
    """``fn`` timed on each rank in turn (CUDA events, median) while the
    other ranks run only ``partner`` (the matching collectives)."""
    import torch.distributed as dist
    ms = None
    for turn in range(world):
        dist.barrier()
        if turn == rank:
            ms = _time_ms(fn, reps=reps, warm=warm)
        else:
            for _ in range(reps + warm):
                partner()
        torch.cuda.synchronize()
    dist.barrier()
    return ms


def _sharded_kernel_rank(rank, world, single):
    """(a) on a rank: its column shard of the (4, n) view through
    ``fused_round_sharded`` (the Gram's all-reduce over the two ranks)."""
    from repro_torch.kernels.pullpush import pullpush as pk
    from repro_torch.kernels.pullpush import ref
    from repro_torch.launch import mesh as mm
    mesh = mm.Mesh(mm.FLAT_AXES, (1, world), device=DEV)
    g = mesh.group(("model",))
    n_loc = MAIN_N // world
    x = _shard_x(g.index, n_loc)
    T, c0, c1 = _shard_stage_inputs()
    r1, coef1 = single["r"].to(DEV), single["coef"].to(DEV)
    out = torch.empty_like(x)
    mm.reset_staged()
    _, r, G = pk.fused_round_sharded(x, T, c0, c1, group=g, out=out)
    torch.cuda.synchronize()
    staged = mm.STAGED["bytes"]
    want = pk.mix_shard(x, T, coef1)
    err1 = float((_row_err(out, want) / _row_absmax(want)).max())
    r_err = float(((r - r1).abs() / r1.abs()).max())
    # the launch sequence it replaced: block partials, gram_coef's sum,
    # the all-reduce, gram_coef on the completed Gram, mix_shard
    ws = pk._launch_partial_gram(x, pk._vec(x), tail=False)
    o_G, _, _ = pk.gram_coef(ws, T, c0, c1)
    o_G = mm.all_reduce(o_G, g)
    _, o_r, o_coef = pk.gram_coef(o_G[None], T, c0, c1)
    pk.mix_shard(x, T, o_coef, out=want)
    torch.cuda.synchronize()
    old_seq = torch.equal(G, o_G) and torch.equal(r, o_r) \
        and _equal(out, want)
    del want, ws
    reduce = lambda G_: mm.all_reduce(G_, g)
    plain = torch.empty_like(x)
    p_out, p_r, _ = ref.fused_round_sharded_plain(x, T, c0, c1, reduce,
                                                  out=plain)
    pscale = float(_row_absmax(plain).max())
    perr = float(_row_err(out, plain).max())
    prerr = float((r - p_r).abs().max())
    Gs = torch.zeros((MAIN_R, MAIN_R), device=DEV)
    ar = lambda: mm.all_reduce(Gs, g)
    comp = lambda: pk.fused_round_sharded(x, T, c0, c1, group=g, out=out)
    both_ms = _time_ms(comp)
    ar_ms = _time_ms(ar)
    alone_ms = _time_alone(rank, world, comp, ar)
    plain_ms = _time_alone(
        rank, world, lambda: ref.fused_round_sharded_plain(
            x, T, c0, c1, reduce, out=plain), ar, reps=5, warm=1)
    del plain
    launches = {}
    for turn in range(world):
        torch.distributed.barrier()
        if turn == rank:
            coef = c0 + c1 / torch.clamp(r, min=1e-12)
            launches = {
                "partial_gram (with its summing tail)":
                    _time_ms(lambda: pk.partial_gram(x)),
                "mix_shard with the coefficient prologue":
                    _time_ms(lambda: pk.mix_from_gram(x, T, c0, c1, G,
                                                      out=out)),
                "gram_coef alone (one block; no longer launched)":
                    _time_ms(lambda: pk.gram_coef(G[None], T, c0, c1)),
                "mix_shard": _time_ms(lambda: pk.mix_shard(x, T, coef,
                                                           out=out))}
        torch.cuda.synchronize()
    torch.distributed.barrier()
    return {"rank": rank, "n_local": n_loc, "err_vs_single": err1,
            "r_err_vs_single": r_err, "bit_equal_to_old_sequence": old_seq,
            "max_abs_err_vs_plain": perr,
            "max_rel_err_vs_plain": perr / pscale, "r_err_vs_plain": prerr,
            "ms_alone": alone_ms, "ms_both_ranks": both_ms,
            "plain_ms_alone": plain_ms, "all_reduce_ms": ar_ms,
            "bytes_staged_per_call": staged, "launch_ms": launches}


def _row_absmax(x):
    """(R,) largest |x| of each row, in column chunks."""
    return torch.stack([c.abs().amax(dim=1)
                        for c in x.split(1 << 24, dim=1)]).amax(dim=0)


def _row_err(got, want):
    """(R,) largest |got - want| of each row, in column chunks, on
    ``got``'s device (a ``want`` kept on the host moves there a chunk at a
    time)."""
    return torch.stack([
        (g - w.to(g.device)).abs().amax(dim=1) for g, w in zip(
            got.split(1 << 24, dim=1), want.split(1 << 24, dim=1))
    ]).amax(dim=0)


def _block_sums(x):
    """Per row: the sum and the sum of |x| in float64 (a round's trace)."""
    return [float(v) for v in torch.cat([
        x.double().sum(dim=1), x.double().abs().sum(dim=1)])] \
        if x.numel() < (1 << 27) else [
        float(v) for v in torch.stack([torch.cat([
            c.double().sum(dim=1), c.double().abs().sum(dim=1)])
            for c in x.split(1 << 24, dim=1)]).sum(dim=0)]


def _host_mem():
    """This process's resident host memory now, bytes (``VmRSS``; a
    spawned rank's ``ru_maxrss`` would start from its parent's)."""
    with open("/proc/self/status") as fh:
        for line in fh:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no VmRSS in /proc/self/status")


def _release_host_memory():
    """Collect garbage and hand PyTorch's cached page-locked host blocks
    (the earlier phases' pinned copies) back before the ranks start: the
    ranks' staging shares the machine's host memory with this process."""
    import gc
    before = _host_mem()
    gc.collect()
    how = "no API here"
    for name in ("_host_emptyCache", "_accelerator_emptyHostCache"):
        fn = getattr(torch._C, name, None)
        if fn is not None:
            fn()
            how = f"torch._C.{name}"
            break
    print(f"  host memory of this process: {before / 2 ** 30:.1f} GiB, "
          f"{_host_mem() / 2 ** 30:.1f} GiB after releasing the "
          f"cached page-locked blocks ({how})")


class _TimedPending:
    """A ``launch.mesh.Pending`` whose ``wait`` adds its host seconds to
    ``acc[name]`` (a wrapper, so that no reference cycle keeps a landed
    tensor alive)."""

    def __init__(self, pending, acc, name):
        self.pending, self.acc, self.name = pending, acc, name

    def wait(self):
        t0 = time.perf_counter()
        v = self.pending.wait()
        self.acc[self.name] += time.perf_counter() - t0
        return v


def _timed_collectives(mm, acc):
    """Host seconds in ``launch.mesh.all_gather`` / ``all_reduce`` /
    ``ring_gather`` (after a synchronize, so queued kernels are not
    counted), waits of the asynchronous ones included. Returns the
    originals."""
    orig = {k: getattr(mm, k) for k in acc}

    def wrap(name):
        f = orig[name]

        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = f(*a, **kw)
            acc[name] += time.perf_counter() - t0
            return _TimedPending(out, acc, name) if kw.get("async_op") \
                else out
        return timed
    for k in acc:
        setattr(mm, k, wrap(k))
    return orig


def _newest(snap):
    """The newest snapshot: the snapshot, or a ring's last slot."""
    x = snap["x"]
    return x[-1] if isinstance(x, list) else x


def _sup_membership(r):
    """(mask, sync) of round r under 16(b)'s ``--elastic-drop`` and
    ``--quorum``, as the supervisor sets them."""
    from repro_torch.train import ScheduleMembership
    mask, _ = ScheduleMembership(SH_M, [SUP_DROP]).mask_for(r)
    return mask, 0.0 if int(mask.sum()) < SUP_QUORUM else 1.0


def _state_tensors(state):
    """A train state's tensors by name (a ring's slots apart)."""
    from repro_torch.optim.optimizers import leaves
    out = {"params": state.params}
    for k, v in state.opt.items():
        for i, t in enumerate(leaves(v)):
            out[f"opt {k} {i}"] = t
    out.update({f"cstate {k}": v for k, v in state.cstate.items()})
    for k, v in (state.snap or {}).items():
        for i, t in enumerate(v if isinstance(v, list) else [v]):
            out[f"snap {k} {i}"] = t
    return out


def _bit_sums(t):
    """int64 sums of ``t``'s bit patterns, per row and 2^24-column chunk
    (a change of any element's bits changes its sum)."""
    bits = t.detach().reshape(t.shape[0] if t.dim() > 1 else 1, -1).view(
        {8: torch.int64, 4: torch.int32, 2: torch.int16,
         1: torch.uint8}[t.element_size()])
    return torch.stack([c.long().sum(dim=1)
                        for c in bits.split(1 << 24, dim=1)]).tolist()


def _sharded_resume_point(state, mesh, plan, path, rows):
    """(b)'s 2x1 staleness_k shard after its rounds: the resume point
    saved (every rank gathers each leaf, rank 0 writes), this rank's
    shard overwritten (NaN, -1), its blocks read back in place; the
    tensors whose bits did not come back (of a ring slot, its valid
    ``rows``: this rank's and the aux rows; the others are the peers',
    gathered before use), with the file's bytes and the save and load
    seconds."""
    import torch.distributed as dist
    from repro_torch.checkpoint import load_train_state, save_train_state

    def sums(st):
        out = {}
        for k, t in _state_tensors(st).items():
            v = _bit_sums(t)
            out[k] = [[c[i] for i in rows] for c in v] \
                if k.startswith("snap x") else v
        return out
    before = sums(state)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    dist.barrier()
    t0 = time.perf_counter()
    save_train_state(path, state, mesh=mesh, plan=plan)
    save_s = time.perf_counter() - t0
    for t in _state_tensors(state).values():
        t.fill_(float("nan") if t.is_floating_point() else -1)
    dist.barrier()
    t0 = time.perf_counter()
    back = load_train_state(path, state, mesh=mesh, plan=plan, in_place=True)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    after = sums(back)
    return {"bytes": os.path.getsize(path), "save_s": save_s,
            "load_s": load_s, "tensors": len(before),
            "differ": sorted(k for k in before if before[k] != after.get(k)),
            "bits_equal": before == after,
            "in_place": back.params.data_ptr() == state.params.data_ptr(),
            "t": back.t, "round": back.round}


def _trainer_rank(rank, world, resume_path=None):
    """(b) on a rank: for each overlap mode, the single-device rounds
    (one rank at a time, this rank's blocks kept on the host), then the
    sharded rounds on each mesh against them; the staleness_k case under
    16(b)'s membership, its 2x1 run's resume point written to
    ``resume_path`` and read back. Returns (runs, resume point)."""
    import torch.distributed as dist
    from repro_torch.configs import DPPFConfig, get_arch
    from repro_torch.configs.base import MeshPlan
    from repro_torch.data import TokenTask, make_round_batch
    from repro_torch.kernels.pullpush import pullpush as pk
    from repro_torch.launch import mesh as mm
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer
    from repro_torch.train import (
        RoundClock, init_train_state, make_round_step,
        make_sharded_round_step, set_participation, shard_train_state,
    )
    from repro_torch.train.trainer import _shard_of
    cfg = dataclasses.replace(get_arch("yi-6b"), n_layers=SH_LAYERS)
    model = build_model(cfg)
    opt = make_optimizer("sgd", momentum=0.9, weight_decay=1e-3)
    task = TokenTask(vocab_size=cfg.vocab_size, seq_len=SH_SEQ)
    plan = MeshPlan(worker_axes=("data",), model_axes=("model",))
    meshes = {f"{a}x{b}": mm.Mesh(mm.FLAT_AXES, (a, b), device=DEV)
              for a, b in SH_MESHES}
    steps = SH_ROUNDS * SH_TAU
    batches = lambda clock: [make_round_batch(
        task, 0, SH_M, s.tau, s.start, SH_BATCH, cfg, device="cpu")
        for s in clock.rounds[:SH_ROUNDS]]
    results, resume = {}, None
    for label, over, n_rounds in SH_OVERLAPS:
        dcfg = DPPFConfig(alpha=0.1, lam=0.5, tau=SH_TAU,
                          consensus="simple_avg", engine="flat", **over)
        ring = over is SUP_DCFG
        clock = RoundClock.from_config(
            dcfg, base_lr=SUP_LR if ring else LR,
            total_steps=SUP_STEPS if ring else steps)
        data = batches(clock)[:n_rounds]

        def member(st, r):
            if not ring:
                return st
            mask, sync = _sup_membership(r)
            return set_participation(st, mask, sync=sync)
        want, single_m, single_ms, scale = {}, [], [], None
        t_single = time.perf_counter()
        for turn in range(world):
            dist.barrier()
            if turn == rank:
                gen = torch.Generator(device=DEV).manual_seed(0)
                st = init_train_state(model.init, opt, dcfg, SH_M, gen,
                                      device=DEV)
                step = make_round_step(model.loss, opt, dcfg, clock=clock)
                trace = {name: [] for name in meshes}
                strace = {name: [] for name in meshes}
                for r, b in enumerate(data):
                    b = {k: v.to(DEV) for k, v in b.items()}
                    st = member(st, r)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    st, m = step(st, b)
                    torch.cuda.synchronize()
                    single_ms.append((time.perf_counter() - t0) * 1e3)
                    single_m.append(float(m["consensus_dist"]))
                    for name, mesh in meshes.items():
                        sh = _shard_of(st.engine, mesh, plan)
                        blk_of = lambda x: x[sh.r_off:sh.r_off + sh.m_loc,
                                             sh.c_off:sh.c_off + sh.n_loc]
                        trace[name].append(_block_sums(blk_of(st.params)))
                        if st.snap is not None:
                            strace[name].append(_block_sums(
                                blk_of(_newest(st.snap))))
                scale = float(_row_absmax(st.params).max())
                for name, mesh in meshes.items():
                    sh = _shard_of(st.engine, mesh, plan)
                    want[name] = st.params[sh.r_off:sh.r_off + sh.m_loc,
                                           sh.c_off:sh.c_off + sh.n_loc] \
                        .cpu()
                del st, step
                torch.cuda.empty_cache()
            torch.cuda.synchronize()
        dist.barrier()
        single_s = time.perf_counter() - t_single
        for name, mesh in meshes.items():
            state = None
            t_init = time.perf_counter()
            for turn in range(world):      # the whole state, in turns
                dist.barrier()
                if turn == rank:
                    gen = torch.Generator(device=DEV).manual_seed(0)
                    whole = init_train_state(model.init, opt, dcfg, SH_M,
                                             gen, device=DEV)
                    state = shard_train_state(whole, mesh, plan, dcfg=dcfg)
                    del whole
                    torch.cuda.empty_cache()
                torch.cuda.synchronize()
            dist.barrier()
            init_s = time.perf_counter() - t_init
            acc = {"all_gather": 0.0, "all_reduce": 0.0,
                   "ring_gather": 0.0}
            orig = _timed_collectives(mm, acc)
            try:
                step = make_sharded_round_step(model.loss, opt, dcfg,
                                               mesh=mesh, plan=plan,
                                               clock=clock)
                sh = _shard_of(state.engine, mesh, plan)
                own = slice(sh.r_off, sh.r_off + sh.m_loc)
                torch.cuda.reset_peak_memory_stats()
                mm.reset_staged()
                pk.reset_launches()        # the main path: counts from here
                rounds = []
                for i, b in enumerate(data):
                    b = {k: v[:, own].to(DEV) for k, v in b.items()}
                    state = member(state, i)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    state, m = step(state, b)
                    torch.cuda.synchronize()
                    ms = (time.perf_counter() - t0) * 1e3
                    got_s = _block_sums(state.params[:sh.m_loc])
                    snap_d = None
                    if state.snap is not None:
                        g2 = _block_sums(_newest(state.snap)[
                            sh.r_off:sh.r_off + sh.m_loc])
                        snap_d = max(abs(g - w) / max(abs(w), 1e-30)
                                     for g, w in zip(g2, strace[name][i]))
                    rounds.append({
                        "snap_row_sums_rel_diff": snap_d,
                        "round_ms": ms,
                        "consensus_dist": float(m["consensus_dist"]),
                        "loss": float(m["train_loss"]),
                        "row_sums_rel_diff": max(
                            abs(g - w) / max(abs(w), 1e-30) for g, w in
                            zip(got_s, trace[name][i]))})
                launches = dict(pk.LAUNCHES)
            finally:
                for k, f in orig.items():
                    setattr(mm, k, f)
            peak = torch.cuda.max_memory_allocated()
            mm.release_staging()
            dp = float(_row_err(state.params[:sh.m_loc], want[name]).max())
            results[f"{label} {name}"] = {
                "rank": rank, "peak_bytes": peak,
                "rounds": rounds, "single_consensus_dist": single_m,
                "single_round_ms": single_ms,
                # host seconds: the mode's single-device turns (both
                # ranks'), this mesh's state made and sharded in turns
                "single_s": single_s, "init_s": init_s,
                "gather_s": acc["all_gather"],
                "ring_gather_s": acc["ring_gather"],
                "all_reduce_s": acc["all_reduce"],
                "bytes_staged": mm.STAGED["bytes"],
                "staging_s": mm.STAGED["seconds"], "launches": launches,
                "host_rss_bytes": _host_mem(),
                "max_abs_diff": dp, "scale": scale,
                "block": [sh.m_loc, sh.n_loc]}
            sums = [x["row_sums_rel_diff"] for x in rounds] + [
                x["snap_row_sums_rel_diff"] for x in rounds]
            print(f"  (b) rank {rank}: {label} {name} rounds "
                  f"{[round(x['round_ms']) for x in rounds]} ms, peak "
                  f"{peak / 2 ** 30:.1f} GiB (host RSS "
                  f"{_host_mem() / 2 ** 30:.1f}), max diff {dp:.3e}, "
                  f"row sums by round (params, snapshot) "
                  f"{[f'{v:.2e}' if v is not None else '-' for v in sums]}, "
                  f"gathers "
                  f"{acc['all_gather']:.2f} s, ring "
                  f"{acc['ring_gather']:.2f} s (staging "
                  f"{mm.STAGED['seconds']:.2f} s)", flush=True)
            if ring and name == "2x1" and resume_path:
                resume = _sharded_resume_point(
                    state, mesh, plan, resume_path,
                    list(range(sh.r_off, sh.r_off + sh.m_loc))
                    + list(range(SH_M, state.engine.layout.R)))
                mm.release_staging()
                print(f"  (b) rank {rank}: resume point " + json.dumps(
                    resume), flush=True)
            del state, step
            torch.cuda.empty_cache()
            dist.barrier()
        del want
    mm.release_staging()
    return results, resume


def _hier_rank(rank, world):
    """(d) on a rank of 8: the MLP (dim 16, width 8, 4 classes; 244
    parameters), M = 8, tau 4, easgd in the precise mode, 3 rounds on the
    2x2x2 hierarchical mesh against the single-device rounds (each rank
    runs them too)."""
    import dataclasses as dc
    from repro_torch.benchmarks.common import mlp_init, mlp_loss
    from repro_torch.configs import DPPFConfig
    from repro_torch.launch import mesh as mm
    from repro_torch.optim import make_optimizer
    from repro_torch.train import (
        init_train_state, make_round_step, make_sharded_round_step,
        shard_train_state, unshard_params,
    )
    mesh, plan = mm.make_hier_engine_mesh(2, 2, 2, device=DEV)
    M, tau = 8, 4
    dcfg = DPPFConfig(alpha=0.2, lam=0.4, tau=tau, consensus="easgd",
                      engine="flat")
    opt = make_optimizer("sgd", momentum=0.9)
    init = lambda gen, device: mlp_init(torch.Generator().manual_seed(0),
                                        16, 4, 8, device=device)
    states = []
    for _ in range(2):
        st = init_train_state(init, opt, dcfg, M, None, device=DEV)
        st.engine = dc.replace(st.engine, precise=True, use_kernel=False)
        states.append(st)
    single, sharded = states[0], shard_train_state(states[1], mesh, plan,
                                                   dcfg=dcfg)
    f1 = make_round_step(mlp_loss, opt, dcfg, base_lr=0.05, total_steps=40)
    f2 = make_sharded_round_step(mlp_loss, opt, dcfg, mesh=mesh, plan=plan,
                                 base_lr=0.05, total_steps=40)
    gen = np.random.default_rng(0)
    r0 = mesh.lin_index(("data",)) * (M // 2)
    mm.reset_staged()
    dm = 0.0
    for _ in range(3):
        x = torch.tensor(gen.standard_normal((tau, M, 8, 16))
                         .astype(np.float32), device=DEV)
        y = torch.tensor(gen.integers(0, 4, size=(tau, M, 8)),
                         device=DEV)
        single, m1 = f1(single, {"x": x, "y": y})
        sharded, m2 = f2(sharded, {"x": x[:, r0:r0 + M // 2],
                                   "y": y[:, r0:r0 + M // 2]})
        dm = max(dm, max(abs(float(m1[k]) - float(m2[k]))
                         for k in ("consensus_dist", "pre_dist",
                                   "pull_force")))
    full = unshard_params(sharded, mesh, plan)
    a, b = full.double(), single.params.double()
    ulps = float(((a - b).abs() / (torch.finfo(torch.float32).eps
                                   * torch.maximum(a.abs().maximum(b.abs()),
                                                   torch.ones_like(a))))
                 .max())
    return {"rank": rank, "coords": dict(mesh.coords),
            "col_axes": list(mm.flat_col_axes(mesh, single.engine.layout.n,
                                              plan)),
            "max_abs_diff": float((a - b).abs().max()), "ulps": ulps,
            "metric_diff": dm, "bytes_staged": mm.STAGED["bytes"],
            "transport": mm.transport(DEV)}


class _Started:
    """A command started now, in a session of its own with its output in
    files (a pipe nobody reads would stall it), so that this process does
    other work meanwhile. ``finish`` waits for it, stops its whole process
    group (torchrun's ranks too) once ``timeout`` seconds have passed since
    the start, and returns (``CompletedProcess``, seconds)."""

    def __init__(self, cmd, tag, timeout=300):
        base = os.path.join(ROOT, "build", "chip_smoke")
        os.makedirs(base, exist_ok=True)
        self.paths = [os.path.join(base, f"{tag}.{k}") for k in ("out",
                                                                  "err")]
        self.files = [open(p, "w+") for p in self.paths]
        self.cmd, self.timeout = cmd, timeout
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            cmd, stdout=self.files[0], stderr=self.files[1], text=True,
            env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
            cwd=ROOT, start_new_session=True)

    def stop(self):
        import signal
        if self.proc.poll() is None:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(self.proc.pid, signal.SIGKILL)
            self.proc.wait()

    def finish(self):
        try:
            self.proc.wait(max(1.0, self.timeout
                               - (time.perf_counter() - self.t0)))
        except subprocess.TimeoutExpired:
            pass
        finally:
            self.stop()
        secs = time.perf_counter() - self.t0
        text = []
        for f, p in zip(self.files, self.paths):
            f.seek(0)
            text.append(f.read())
            f.close()
            os.remove(p)
        return subprocess.CompletedProcess(self.cmd, self.proc.returncode,
                                           *text), secs


LAUNCHER_ARGV = ["--arch", "yi-6b", "--smoke", "--workers", "4", "--tau",
                 "4", "--steps", "16", "--seq", "16", "--batch", "2"]


def _launcher_sharded_start():
    """(c), started: ``--sharded --arch yi-6b --smoke`` under torchrun with
    two ranks, in the background (beside (d))."""
    two = os.path.join(ROOT, "build", "chip_smoke", "launcher_sharded.jsonl")
    return _Started([sys.executable, "-m", "torch.distributed.run",
                     "--standalone", "--nproc-per-node", "2", "-m",
                     "repro_torch.launch.train", *LAUNCHER_ARGV, "--sharded",
                     "--log-every-round", two], "launcher15")


def _launcher_sharded(started):
    """(c): the same run unsharded here, then the torchrun run ``started``
    against it: their per-round records."""
    from repro_torch.launch.train import main as train_main
    base = os.path.join(ROOT, "build", "chip_smoke")
    one, two = (os.path.join(base, f"launcher_{k}.jsonl")
                for k in ("unsharded", "sharded"))
    t0 = time.perf_counter()
    want = train_main(LAUNCHER_ARGV + ["--log-every-round", one])
    t_one = time.perf_counter() - t0
    proc, t_two = started.finish()
    if proc.returncode != 0:
        raise AssertionError("torchrun --sharded failed:\n"
                             + proc.stdout[-3000:] + proc.stderr[-3000:])
    lines = proc.stdout.splitlines()
    mesh_line = [l for l in lines if l.startswith("sharded round on mesh")]
    loss = [float(l.split()[2]) for l in lines if l.startswith("eval loss")]
    rec = lambda p: [json.loads(l) for l in open(p)]
    a, b = rec(one), rec(two)
    d = max(abs(x[k] - y[k]) / max(abs(y[k]), 1e-30) for x, y in zip(a, b)
            for k in ("consensus_dist", "pull_force"))
    print(f"  (c) launcher: {mesh_line}; eval loss sharded {loss} against "
          f"unsharded {want:.6f}; {len(b)} round records, largest relative "
          f"difference of consensus_dist / pull_force {d:.3e}; wall "
          f"{t_one:.1f} s unsharded, {t_two:.1f} s under torchrun (beside "
          f"(d))")
    if len(mesh_line) != 1 or len(loss) != 1 or len(a) != len(b) \
            or d > 1e-5 or abs(loss[0] - want) > 1e-3:
        raise AssertionError("the sharded launcher disagrees with the "
                             "unsharded one")
    return {"rel_diff": d, "loss": loss[0], "want": want,
            "seconds": [t_one, t_two]}


def phase_sharded(pk, ref, resume_path=None):
    """Phase 15; with ``resume_path`` (b)'s 2x1 staleness_k run leaves its
    resume point there, for phase 16(b)."""
    world = 2
    secs = {}
    if resume_path:
        os.makedirs(os.path.dirname(resume_path), exist_ok=True)
        free = shutil.disk_usage(os.path.dirname(resume_path)).free
        print(f"  free disk for (b)'s resume point: {free / 1e9:.1f} GB "
              f"(need {SUP_DISK / 1e9:.0f})")
        if free < SUP_DISK:
            raise AssertionError(f"phase 15: {free / 1e9:.1f} GB free disk, "
                                 f"the resume point needs "
                                 f"{SUP_DISK / 1e9:.0f}")
    _release_host_memory()
    t0 = time.perf_counter()
    single = _single_rank_round(pk, world)
    n_loc = MAIN_N // world
    view = 4 * SH_M * 697_316_352
    print(f"  reckoning: (a) a rank's (4, {n_loc}) shard is "
          f"{MAIN_R * n_loc * 4 / 1e9:.2f} GB, three buffers a rank; (b) a "
          f"1-layer (4, n) view is {view / 1e9:.2f} GB: on 1x2 a rank "
          f"holds half of it, its rows' momentum at full width, its rows "
          f"gathered for the local steps and a snapshot (doublebuf): "
          f"~{3 * view / 1e9:.1f} GB + the steps' temporaries")
    out = _spawn_ranks(_phase15_pair, world, single, resume_path,
                       timeout=600)
    secs["a+b"] = time.perf_counter() - t0
    a = [o["a"] for o in out]
    b = [o["b"] for o in out]
    fails = []      # every part runs; the phase fails at its end
    worst = max(res["err_vs_single"] for res in a)
    r_worst = max(res["r_err_vs_single"] for res in a)
    if not (worst <= SHARD_TOL and r_worst <= SHARD_TOL):
        fails.append(f"(a) fused_round_sharded against fused_round: "
                     f"{worst:.3e} / r {r_worst:.3e} > {SHARD_TOL}")
    if max(res["max_rel_err_vs_plain"] for res in a) > TOL:
        fails.append("(a) fused_round_sharded against its plain version")
    if not all(res["bit_equal_to_old_sequence"] for res in a):
        fails.append("(a) fused_round_sharded is not bit-equal to the "
                     "launch sequence it replaced")
    totals, by_overlap = {}, {}
    for key in b[0]:
        runs = [res[key] for res in b]
        peak = [r["peak_bytes"] for r in runs]
        summary = {
            "round_ms_by_rank": [[x["round_ms"] for x in r["rounds"]]
                                 for r in runs],
            "gather_s_by_rank": [r["gather_s"] for r in runs],
            "ring_gather_s_by_rank": [r["ring_gather_s"] for r in runs],
            "all_reduce_s_by_rank": [r["all_reduce_s"] for r in runs],
            "bytes_staged_by_rank": [r["bytes_staged"] for r in runs],
            "staging_s_by_rank": [r["staging_s"] for r in runs],
            "host_rss_bytes_by_rank": [r["host_rss_bytes"] for r in runs],
            "peak_bytes_by_rank": peak, "peak_bytes_sum": sum(peak),
            "card_bytes": torch.cuda.get_device_properties(0).total_memory,
            "consensus_dist": [x["consensus_dist"]
                               for x in runs[0]["rounds"]],
            "single_consensus_dist": runs[0]["single_consensus_dist"],
            "single_round_ms_by_rank": [r["single_round_ms"] for r in runs],
            "single_s_by_rank": [r["single_s"] for r in runs],
            "init_s_by_rank": [r["init_s"] for r in runs],
            "max_abs_diff": max(r["max_abs_diff"] for r in runs),
            "bar": SH_BAR[key.split()[-1]] * runs[0]["scale"],
            "launches_by_rank": [r["launches"] for r in runs]}
        print(f"  (b) {key}: " + json.dumps(summary))
        if not summary["max_abs_diff"] <= summary["bar"]:
            fails.append(f"(b) {key}: sharded against single-device "
                         f"{summary['max_abs_diff']:.3e} > "
                         f"{summary['bar']:.3e}")
        dist_err = max(abs(g - w) / abs(w) for g, w in zip(
            summary["consensus_dist"], summary["single_consensus_dist"]))
        summary["consensus_dist_rel_diff"] = dist_err
        if not dist_err <= SH_METRIC_BAR:
            fails.append(f"(b) {key}: consensus_dist {dist_err:.3e} > "
                         f"{SH_METRIC_BAR}")
        mode = by_overlap.setdefault(key.split()[0], {})
        for r in runs:
            for name, v in r["launches"].items():
                totals[name] = totals.get(name, 0) + v
                mode[name] = mode.get(name, 0) + v
    print("  (b) launches over the sharded runs, both ranks "
          + json.dumps(totals) + "; by overlap mode "
          + json.dumps(by_overlap))
    for name in SHARDED_KERNELS:
        if totals.get(name, 0) == 0:
            fails.append(f"(b) {name} was not launched by the sharded "
                         "rounds")
    for name in RING_KERNELS:
        if by_overlap["staleness_k"].get(name, 0) == 0:
            fails.append(f"(b) {name} was not launched by the sharded "
                         "staleness_k rounds")
    fails += _merged_launched(totals, "(b) the sharded rounds")
    resume = [o["resume"] for o in out]
    if resume_path:
        print("  (b) resume point of 2x1 staleness_k after round 2, by rank "
              + json.dumps(resume))
        if not all(r and r["bits_equal"] and r["in_place"]
                   and (r["round"], r["t"]) == (SH_ROUNDS,
                                                SH_ROUNDS * SH_TAU)
                   for r in resume):
            fails.append("(b) the sharded resume point did not read back "
                         "bit for bit")
    # (c)'s torchrun and (d)'s ranks run side by side: both are mostly
    # processes starting, and neither times anything the other disturbs
    t0 = time.perf_counter()
    started = _launcher_sharded_start()
    try:
        hier = _spawn_ranks(_hier_rank, 8, timeout=240)
        secs["hier"] = time.perf_counter() - t0
        try:
            launcher = _launcher_sharded(started)
        except AssertionError as e:
            launcher = None
            fails.append(str(e))
    finally:
        started.stop()
    secs["launcher and hier, side by side"] = time.perf_counter() - t0
    ulps = max(h["ulps"] for h in hier)
    print(f"  (d) 2x2x2, 8 ranks, easgd precise, 3 rounds: column axes "
          f"{hier[0]['col_axes']}; largest difference against "
          f"single-device {max(h['max_abs_diff'] for h in hier):.3e} "
          f"({ulps:.2f} of eps32 * max(|x|, 1)); metrics "
          f"{max(h['metric_diff'] for h in hier):.3e}")
    if ulps > HIER_ULP or max(h["metric_diff"] for h in hier) > 1e-6:
        fails.append("(d) the hierarchical round disagrees")
    tr = hier[0]["transport"]
    staged = sum(r["bytes_staged"] for res in b for r in res.values())
    print(f"  transport: backend {tr['backend']}, {out[0]['transport']['ranks_per_card']} "
          f"ranks a card in (a)-(c), {tr['ranks_per_card']} in (d), "
          f"{tr['cards']} card(s); bytes staged through the host: (a) "
          f"{a[0]['bytes_staged_per_call']} a call a rank, (b) {staged} "
          f"over both ranks, (d) {sum(h['bytes_staged'] for h in hier)}; "
          f"NCCL: not verified (one card)")
    print("  phase 15 seconds " + json.dumps(secs))
    if fails:
        raise AssertionError("phase 15: " + "; ".join(fails))
    r0 = a[0]
    work = pk.cost("fused_round_sharded", MAIN_R, n_loc)
    t_bytes = work["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = work["flops"] / FP32_FLOPS * 1e3
    row = {
        "name": "fused_round_sharded", "route": "cuda",
        "source": SHARDED_SOURCE, "replaces": SHARDED_REPLACES,
        "launches": totals["fused_round_sharded"],
        "max_abs_err": max(res["max_abs_err_vs_plain"] for res in a),
        "max_rel_err": max(res["max_rel_err_vs_plain"] for res in a),
        "tol_rel": TOL, "ms": r0["ms_alone"],
        "plain_ms": r0["plain_ms_alone"], "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None, "ms_both_ranks": r0["ms_both_ranks"],
        "all_reduce_ms": r0["all_reduce_ms"], "launch_ms": r0["launch_ms"],
        "shape": [MAIN_R, n_loc], "err_vs_fused_round": worst,
        "transport": tr["backend"]}
    return {"row": row, "launches": totals, "by_overlap": by_overlap,
            "seconds": secs, "launcher": launcher, "resume": resume}


# ---------------------------------------------------------------------------
# phase 16: the fault-tolerant round loop
# ---------------------------------------------------------------------------

CHAOS_PLAN = os.path.join("results", "chaos", "plan_ci.json")
CHAOS_EVENTS = os.path.join("results", "chaos", "events_ci.json")
CHAOS_ARGV = ["--arch", "yi-6b", "--smoke", "--d-model", "32", "--layers",
              "1", "--seq", "16", "--workers", "8", "--tau", "2", "--steps",
              "16", "--batch", "2", "--overlap", "staleness_k",
              "--staleness", "2", "--sharded", "--chaos",
              os.path.join(ROOT, CHAOS_PLAN),
              "--quorum", "7", "--heartbeat-timeout", "0.9"]
# (b): yi-6b at full width cut to 1 layer (``_cut_depth``), one device,
# 4 rounds, the configuration of phase 15(b)'s staleness_k case
SUP_FLAGS = ["--workers", str(SH_M), "--tau", str(SH_TAU), "--steps",
             str(SUP_STEPS), "--seq", str(SH_SEQ), "--batch", str(SH_BATCH),
             "--overlap", "staleness_k", "--staleness", "1",
             "--elastic-drop", ",".join(map(str, SUP_DROP)), "--quorum",
             str(SUP_QUORUM), "--log-every", "1"]
SUP_ARGV = ["--arch", "yi-6b"] + SUP_FLAGS
SUP_STOP = SH_ROUNDS
# straight against resumed, exactly: the same kernels on the same inputs
# in the same order (bits equal in every earlier reading), and phase
# 15(b)'s 2x1 run, which wrote the resume point, runs the single-device
# operations (its rows equal the single-device run's bit for bit). A
# resume that restored the ring slot or the momentum wrongly moves the
# parameters by less than a loose bar would notice.
# The machine takes at most 45 GiB of disk writes a call, deleted files
# included: phase 15 writes the one resume point (~33.5 GB); the straight
# and resumed runs write nothing (their final parameters are compared in
# memory).


def _chaos_rank(rank, world):
    """(a) on a rank: the launcher with the pinned chaos command on the
    card; what it printed, its eval loss, and this rank's launches."""
    import io
    from repro_torch.kernels.pullpush import pullpush as pk
    from repro_torch.launch.train import main as train_main
    pk.reset_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        loss = train_main(CHAOS_ARGV)
    return {"text": buf.getvalue(), "loss": loss,
            "seconds": time.perf_counter() - t0,
            "launches": dict(pk.LAUNCHES)}


def _supervisor_lines(text):
    ev = [l for l in text.splitlines() if l.startswith("supervisor events: ")]
    ct = [l for l in text.splitlines()
          if l.startswith("supervisor counters: ")]
    if len(ev) != 1 or len(ct) != 1:
        raise AssertionError("no supervisor lines in:\n" + text[-3000:])
    counters = dict(kv.split("=") for kv in ct[0].split(": ", 1)[1].split())
    return ev[0].split(": ", 1)[1].split(), \
        {k: int(v) for k, v in counters.items()}


class _Timed:
    """Wraps a function of ``launch.train``'s namespace; each call's host
    seconds (after a synchronize, CUDA-synchronised at its end) land in
    ``secs``."""

    def __init__(self, fn, secs):
        self.fn, self.secs = fn, secs

    def __call__(self, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.fn(*a, **kw)
        torch.cuda.synchronize()
        self.secs.append(time.perf_counter() - t0)
        return out


def _timed_launcher(argv):
    """``launch.train.main(argv)`` on the card at 1 layer, with its round
    steps and its resume point's load timed and its final parameters
    kept (a host copy of ``average_params``' tree); it writes nothing.
    Returns (eval loss, printed text, {"round_ms", "load_s", "final"})."""
    import io
    from repro_torch.core.engine import tree_items
    from repro_torch.launch import train as lt
    secs = {"round": [], "load": []}
    final = {}
    names = ("make_round_step", "save_train_state", "load_train_state",
             "average_params", "save_pytree")
    orig = {k: getattr(lt, k) for k in names}

    def step_maker(*a, **kw):
        return _Timed(orig["make_round_step"](*a, **kw), secs["round"])

    def keep_final(state):
        tree = orig["average_params"](state)
        final.update({p: leaf.detach().cpu() for p, leaf in tree_items(tree)})
        return tree
    lt.make_round_step = step_maker
    lt.load_train_state = _Timed(orig["load_train_state"], secs["load"])
    lt.average_params = keep_final
    lt.save_pytree = lt.save_train_state = lambda *a, **kw: None
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf), _cut_depth(lt, SH_LAYERS):
            loss = lt.main(argv)
    finally:
        for k, v in orig.items():
            setattr(lt, k, v)
    torch.cuda.empty_cache()
    text = buf.getvalue()
    print("\n".join("    " + l for l in text.splitlines()
                    if not l.startswith("round ")))
    return loss, text, {"round_ms": [x * 1e3 for x in secs["round"]],
                        "load_s": secs["load"], "final": final}


def _plain_loop_ms():
    """The plain ``for spec in clock.rounds`` loop of (b)'s configuration
    (the same masks through ``set_participation``, no supervisor):
    each round's ms."""
    from repro_torch.configs import DPPFConfig, get_arch
    from repro_torch.data import TokenTask, make_round_batch
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer
    from repro_torch.train import (
        RoundClock, init_train_state, make_round_step, set_participation,
    )
    cfg = dataclasses.replace(get_arch("yi-6b"), n_layers=SH_LAYERS)
    model = build_model(cfg)
    dcfg = DPPFConfig(alpha=0.1, lam=0.5, tau=SH_TAU,
                      consensus="simple_avg", engine="flat", **SUP_DCFG)
    opt = make_optimizer("sgd", momentum=0.9, weight_decay=1e-3)
    clock = RoundClock.from_config(dcfg, base_lr=SUP_LR,
                                   total_steps=SUP_STEPS)
    gen = torch.Generator(device=DEV).manual_seed(0)
    st = init_train_state(model.init, opt, dcfg, SH_M, gen, device=DEV)
    step = make_round_step(model.loss, opt, dcfg, clock=clock)
    task = TokenTask(vocab_size=cfg.vocab_size, seq_len=SH_SEQ)
    out = []
    for spec in clock.rounds:
        b = make_round_batch(task, 0, SH_M, spec.tau, spec.start, SH_BATCH,
                             cfg, device="cpu")
        b = {k: v.to(DEV) for k, v in b.items()}
        mask, sync = _sup_membership(spec.index)
        st = set_participation(st, mask, sync=sync)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, _ = step(st, b)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    del st, step
    torch.cuda.empty_cache()
    return out


def _params_diff(a, b):
    """Largest difference between two parameter trees ({path: tensor}),
    and the scale (largest |x|) of the first."""
    if set(a) != set(b):
        raise AssertionError("the final parameter trees differ in leaves")
    worst = scale = 0.0
    for p, x in a.items():
        worst = max(worst, float((x.double() - b[p].double()).abs().max()))
        scale = max(scale, float(x.abs().max()))
    return worst, scale


def phase_supervised(pk, resume_point):
    """Phase 16; (b) resumes from ``resume_point``, the sharded resume
    point phase 15(b) wrote."""
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.launch.train import main as train_main
    secs, fails = {}, []
    # (a) the chaos replay on 8 ranks
    t0 = time.perf_counter()
    with open(os.path.join(ROOT, CHAOS_EVENTS)) as fh:
        pinned = json.load(fh)
    _release_host_memory()
    ranks = _spawn_ranks(_chaos_rank, 8, timeout=240)
    secs["a"] = time.perf_counter() - t0
    seq, counters = _supervisor_lines(ranks[0]["text"])
    final_batch = counters.pop("final_batch")
    a_launch = {}
    for r in ranks:
        for k, v in r["launches"].items():
            a_launch[k] = a_launch.get(k, 0) + v
    print(f"  (a) 8 ranks on the card, gloo: supervisor events "
          f"{' '.join(seq)}; counters {counters}; final batch "
          f"{final_batch}; eval loss {ranks[0]['loss']:.4f} on every rank: "
          f"{len({r['loss'] for r in ranks}) == 1}; launcher seconds "
          f"{[round(r['seconds'], 1) for r in ranks]}; launches (all "
          f"ranks) {json.dumps(a_launch)}")
    fails += _merged_launched(a_launch, "(a) the chaos replay")
    if seq != pinned["event_seq"] or counters != pinned["counters"] \
            or final_batch != pinned["final_batch"]:
        fails.append("(a) the chaos replay differs from "
                     f"{CHAOS_EVENTS}: {seq} {counters} {final_batch}")
    if any(r["text"] for r in ranks[1:]):
        fails.append("(a) a rank other than 0 printed")
    # (b) the supervised path at full width
    t0 = time.perf_counter()
    base = os.path.dirname(RESUME_POINT)
    os.makedirs(base, exist_ok=True)
    buf_cpu = __import__("io").StringIO()
    with contextlib.redirect_stdout(buf_cpu):     # the same flags, smoke
        train_main(["--arch", "yi-6b", "--smoke"] + SUP_FLAGS[:6]
                   + ["--seq", "16"] + SUP_FLAGS[8:], device="cpu")
    cpu_seq, cpu_counters = _supervisor_lines(buf_cpu.getvalue())
    pk.reset_launches()        # the main path: counts from here
    loss_a, text_a, t_a = _timed_launcher(SUP_ARGV)
    b_launch = dict(pk.LAUNCHES)
    seq_a, cnt_a = _supervisor_lines(text_a)
    state_bytes = os.path.getsize(resume_point)
    loss_b, text_b, t_b = _timed_launcher(
        SUP_ARGV + ["--ckpt", resume_point[:-len(".state.npz")]])
    diff, scale = _params_diff(t_a["final"], t_b["final"])
    del t_a["final"], t_b["final"]
    plain = _plain_loop_ms()
    seq_b, _ = _supervisor_lines(text_b)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    summary = {
        "card": card, "events_straight": seq_a, "events_cpu_smoke": cpu_seq,
        "events_resumed": seq_b,
        "counters": cnt_a, "round_ms_supervised": t_a["round_ms"],
        "round_ms_plain_loop": plain, "round_ms_resumed": t_b["round_ms"],
        "resume_point_bytes": state_bytes,
        "load_s": t_b["load_s"], "final_params_max_abs_diff": diff,
        "scale": scale, "bar": 0.0,
        "eval_loss": [loss_a, loss_b], "launches": b_launch}
    print("  (b) " + json.dumps(summary))
    if seq_a != cpu_seq or cnt_a != cpu_counters:
        fails.append(f"(b) supervisor events {seq_a} {cnt_a} differ from "
                     f"the CPU run's {cpu_seq} {cpu_counters}")
    if seq_b != [e for e in seq_a if int(e.split(":")[0][1:]) >= SUP_STOP]:
        fails.append("(b) the resumed run's events are not the straight "
                     f"run's from round {SUP_STOP}")
    if diff != 0.0:
        fails.append(f"(b) resumed against straight {diff:.3e}: not bit "
                     "for bit")
    if abs(loss_b - loss_a) > 1e-5 * abs(loss_a):
        fails.append(f"(b) eval loss {loss_b} against {loss_a}")
    if f"(round {SUP_STOP})" not in text_b or not t_b["load_s"]:
        fails.append(f"(b) the second half did not resume at round "
                     f"{SUP_STOP}")
    for name in ("fused_round", "partial_gram", "mix_from_gram",
                 "stale_mix"):
        if b_launch.get(name, 0) == 0:
            fails.append(f"(b) {name} was not launched")
    fails += _merged_launched(b_launch, "(b) the supervised run")
    secs["b"] = time.perf_counter() - t0
    # (c) train, then serve the trained checkpoint
    t0 = time.perf_counter()
    small = os.path.join(base, "smoke.npz")
    loss_c = train_main(["--arch", "yi-6b", "--smoke", "--workers", "4",
                         "--tau", "4", "--steps", "8", "--seq", "16",
                         "--batch", "2", "--ckpt", small])
    report = serve_main(["--arch", "yi-6b", "--smoke", "--requests", "4",
                         "--max-slots", "2", "--prompt-len", "12",
                         "--new-tokens", "4", "--ckpt", small])
    served = sorted(report.results)
    print(f"  (c) trained (eval loss {loss_c:.4f}) and served from "
          f"{os.path.basename(small)}: requests {served}, "
          f"{report.generated} tokens, {report.tok_s:.1f} tokens/s")
    if served != list(range(4)) or report.generated != 16:
        fails.append("(c) the served checkpoint did not answer every "
                     "request")
    secs["c"] = time.perf_counter() - t0
    _remove_in_background(base)
    print("  phase 16 seconds " + json.dumps(secs))
    if fails:
        raise AssertionError("phase 16: " + "; ".join(fails))
    launches = dict(b_launch)
    for k, v in a_launch.items():
        launches[k] = launches.get(k, 0) + v
    return {"launches": launches, "a": a_launch, "b": b_launch,
            "seconds": secs, "summary": summary}


def _phase15_pair(rank, world, single, resume_path):
    """The two ranks of (a) and (b), in one process group."""
    from repro_torch.launch import mesh as mm
    t0 = time.perf_counter()
    a = _sharded_kernel_rank(rank, world, single)
    print(f"  (a) rank {rank} in {time.perf_counter() - t0:.1f} s: "
          + json.dumps(a), flush=True)
    torch.cuda.empty_cache()
    b, resume = _trainer_rank(rank, world, resume_path)
    return {"a": a, "b": b, "resume": resume,
            "transport": mm.transport(DEV)}


# ---------------------------------------------------------------------------
# phase 17: the MoE, enc-dec and vlm families
# ---------------------------------------------------------------------------

# (a) / (b): (config, depth served, prompt tokens a sequence). dbrx-132b
# and llama4-scout-17b-a16e cut for the card's 80 GB (41.6 and 48.2 GB of
# bf16 weights at 6 and 10 layers, the MoE transients beside them);
# internvl2-2b's 256-patch prefix + 7904 tokens fill 8160 positions;
# seamless-m4t-medium decodes 2048 tokens over 1536 frames
FAMILIES = (("dbrx-132b", 6, SERVE_S), ("llama4-scout-17b-a16e", 10, SERVE_S),
            ("internvl2-2b", None, SERVE_S - 256),
            ("seamless-m4t-medium", None, 2048))
FAMILY_B, FAMILY_NEW, FAMILY_CHUNK = 4, 32, 512
FAMILY_CHECK_S = 1024        # (0): one sequence, fp32, 1 MoE / 2 dense layers
# (d): (config, depth) trained at full width on the flat engine's kernels
# (d): (config, layers or None for the full depth, config fields set for
# training, local-step learning rate). seamless-m4t-medium cut 12 + 12 ->
# 2 + 2 layers (the run's time limit); zamba2-7b cut 81 -> 18 layers
# (n = 1,604,578,608, a 25.7 GB view); xlstm-350m cut 24 -> 4 blocks (3
# mLSTM + 1 sLSTM, the 3:1 pattern kept; the run's time limit: its plain
# sLSTM loop under autograd is most of the phase) on the chunkwise mLSTM
# (xlstm_chunk = 16): the published per-step recurrence keeps every step's
# (B, 4, 512, 512) fp32 matrix memory for the backward pass, > 100 GB at
# seq 64, batch 8, 18 mLSTM blocks. At LR = 0.3 its SGD diverges in either
# mLSTM form (its gradient norm is ~130 at the seeded init); it trains at
# 0.01
FAMILY_TRAIN = (("seamless-m4t-medium", 2, {"n_enc_layers": 2}, LR),
                ("internvl2-2b", 12, {}, LR), ("zamba2-7b", 18, {}, LR),
                ("xlstm-350m", 4, {"xlstm_chunk": 16}, 0.01))
FAMILY_ROUNDS = 2
# swa_attention at every shape this phase's serving paths launch it, bf16
# (B, H, Hkv, Sq, Skv, hd, window, cap, causal); the census of (a)-(c)
# (_attn_census) fails the phase on a launch at a shape not held here
ATTN_FAMILIES = {
    # (a) generate's prefill, B = 4: the MoE / vlm prefill (hd 128, GQA
    # 6, 5 and 2), seamless's decoder self-attention, encoder pass and
    # cross-attention
    "dbrx": (4, 48, 8, SERVE_S, SERVE_S, 128, 0, 0.0, True),
    "llama4": (4, 40, 8, SERVE_S, SERVE_S, 128, 0, 0.0, True),
    "internvl2": (4, 16, 8, SERVE_S, SERVE_S, 128, 0, 0.0, True),
    "seamless_self": (4, 16, 16, 2048, 2048, 64, 0, 0.0, True),
    "seamless_encoder": (4, 16, 16, 1536, 1536, 64, 0, 0.0, False),
    "seamless_cross": (4, 16, 16, 2048, 1536, 64, 0, 0.0, False),
    # (b) one sequence in 512-token chunks: the first chunk's
    # self-attention, internvl2-2b's prefix in make_state, seamless's
    # encoder pass (also each launcher slot's, (c)) and every chunk's
    # cross-attention
    "dbrx_chunk": (1, 48, 8, 512, 512, 128, 0, 0.0, True),
    "llama4_chunk": (1, 40, 8, 512, 512, 128, 0, 0.0, True),
    "internvl2_prefix": (1, 16, 8, 256, 256, 128, 0, 0.0, True),
    "seamless_self_chunk": (1, 16, 16, 512, 512, 64, 0, 0.0, True),
    "seamless_encoder_one": (1, 16, 16, 1536, 1536, 64, 0, 0.0, False),
    "seamless_chunk": (1, 16, 16, 512, 1536, 64, 0, 0.0, False),
    # (c) the launcher's first 64-token chunk of each request, one slot
    # at a time, and seamless's cross-attention of every chunk
    "dbrx_launcher": (1, 48, 8, 64, 64, 128, 0, 0.0, True),
    "llama4_launcher": (1, 40, 8, 64, 64, 128, 0, 0.0, True),
    "internvl2_launcher": (1, 16, 8, 64, 64, 128, 0, 0.0, True),
    "seamless_self_launcher": (1, 16, 16, 64, 64, 64, 0, 0.0, True),
    "seamless_launcher": (1, 16, 16, 64, 1536, 64, 0, 0.0, False),
}


@contextlib.contextmanager
def _attn_census(seen):
    """Add to ``seen`` the (dtype, case) of every ``swa_attention`` call
    the models make (through ``ops.attention``) while the block runs."""
    from repro_torch.kernels.swa_attention import ops
    orig = ops.swa_attention

    def recorded(q, k, v, *, causal=True, window=0, cap=0.0):
        B, H, Sq, hd = q.shape
        seen.add((q.dtype, (B, H, k.shape[1], Sq, k.shape[2], hd,
                            int(window), float(cap), bool(causal))))
        return orig(q, k, v, causal=causal, window=window, cap=cap)

    ops.swa_attention = recorded
    try:
        yield
    finally:
        ops.swa_attention = orig


def _family_cfg(name, layers):
    from repro_torch.configs import get_arch
    cfg = get_arch(name)
    return dataclasses.replace(cfg, n_layers=layers) if layers else cfg


def _family_batch(cfg, B, S, seed):
    """Random prompts and the config's stubbed input (vlm prefix or
    enc-dec frames, 0.02 x normal), made on the card from a seed."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                     device="cuda", generator=gen)}
    if cfg.n_prefix:
        batch["enc" if cfg.n_enc_layers else "prefix"] = 0.02 * torch.randn(
            (B, cfg.n_prefix, cfg.d_model), device="cuda", generator=gen)
    return batch


def _prefill_launches(cfg):
    """swa_attention launches of one prefill at index 0: a layer's
    self-attention, and for an enc-dec model the encoder pass and the
    cross-attention too."""
    return cfg.n_enc_layers + cfg.n_layers * (2 if cfg.n_enc_layers else 1)


def _family_route_check(swa, cfg):
    """(0) The kernel route of the serving prefill against the training
    path's ``attend`` on the same input, at full width, fp32, one sequence
    of FAMILY_CHECK_S tokens (internvl2-2b: its 256-patch prefix and 768
    tokens): 1 MoE layer, 2 dense layers, or seamless's 1 encoder + 1
    decoder layer (the encoder pass, the decoder's causal self-attention
    and its non-causal cross-attention over 1536 frames). Hidden states
    held to 1e-4 of their scale."""
    from repro_torch.models import build_model, encdec
    from repro_torch.models import transformer as lm
    small = dataclasses.replace(
        cfg, n_layers=1 if cfg.n_experts or cfg.n_enc_layers else 2,
        n_enc_layers=min(cfg.n_enc_layers, 1), dtype="float32")
    params = build_model(small).init(
        torch.Generator(device="cuda").manual_seed(3), "cuda")
    S = FAMILY_CHECK_S - (small.n_prefix if not small.n_enc_layers else 0)
    batch = _family_batch(small, 1, S, seed=4)
    errs = {}
    before = swa.LAUNCHES["swa_attention"]
    with torch.no_grad():
        x = lm._embed(params, small, batch["tokens"], batch.get("prefix"))
        if small.n_enc_layers:
            enc_w = encdec.encode(small, params, batch["enc"])
            enc_g = encdec.encode(small, params, batch["enc"], kernel=True)
            errs["encoder"] = (float((enc_g - enc_w).abs().max()),
                               float(enc_w.abs().max()))
            want, _ = encdec.decode_stack(small, params, x, enc_out=enc_w)
            states, _ = encdec.encdec_make_state(small, params, 1, S,
                                                 enc=batch["enc"])
            got, _ = encdec.decode_stack(small, params, x, states=states,
                                         index=0, kernel=True)
        else:
            want, _, _ = lm.run_blocks(params["blocks"], x, small)
            states = lm.init_states(small, 1, x.shape[1], torch.float32,
                                    device="cuda")
            got, _, _ = lm.run_blocks(params["blocks"], x, small,
                                      states=states, index=0)
    errs["output"] = (float((got - want).abs().max()),
                      float(want.abs().max()))
    launched = swa.LAUNCHES["swa_attention"] - before
    expect = _prefill_launches(small) + small.n_enc_layers
    print(f"  (0) kernel route vs attend, full width, {small.n_layers} "
          f"layer(s), fp32, {x.shape[1]} positions: [max abs err, scale] "
          f"{json.dumps(errs)}; {launched} swa_attention launches")
    del params, states, want, got, x
    torch.cuda.empty_cache()
    if launched != expect:
        raise AssertionError(f"{cfg.name}: the kernel route launched "
                             f"{launched} times, not {expect}")
    for what, (err, scale) in errs.items():
        if not err <= 1e-4 * scale:
            raise AssertionError(f"{cfg.name} {what}: the kernel route "
                                 f"differs from attend: {err:.3e} > 1e-4 x "
                                 f"{scale:.3e}")
    return errs


def _serve_family(swa, cfg, S, route):
    """(a), (b) and (c) for one configuration with prompts of ``S``
    tokens, after its route check ``route`` (0); returns their numbers
    and (a)'s swa_attention launches."""
    from repro_torch.core.engine import tree_items
    from repro_torch.models import build_model
    from repro_torch.serving import generate
    name = cfg.name
    extra = cfg.n_prefix if not cfg.n_enc_layers else 0
    buf = extra + S + FAMILY_NEW
    B = FAMILY_B
    print(f"  config {cfg.name} ({cfg.family}): d_model {cfg.d_model}, heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads}, head_dim {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, layers {cfg.n_layers}"
          f"{f' + {cfg.n_enc_layers} encoder' if cfg.n_enc_layers else ''}"
          f", experts {cfg.n_experts} top {cfg.top_k}, n_prefix "
          f"{cfg.n_prefix}; B={B} S={S} new={FAMILY_NEW} buf_len={buf}")
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    torch.cuda.synchronize()
    n = sum(leaf.numel() for _, leaf in tree_items(params))
    weights = torch.cuda.memory_allocated()
    print(f"  parameters {n} ({weights / 1e9:.2f} GB on the card, made in "
          f"{time.perf_counter() - t0:.1f} s); peak while made "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    batch = _family_batch(cfg, B, S, seed=1)

    # (a) the main path: generate, counters zeroed just before
    timed, events = _events_of(model, ("prefill", "decode_step"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    swa.reset_launches()
    t0 = time.perf_counter()
    toks, logits = generate(timed, params, batch, max_new_tokens=FAMILY_NEW,
                            buf_len=buf)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = swa.LAUNCHES["swa_attention"]
    peak = torch.cuda.max_memory_allocated()
    prefill_ms = events["prefill"][0][0].elapsed_time(events["prefill"][0][1])
    dec = [a.elapsed_time(b) for a, b in events["decode_step"]]
    a = {"config": cfg.name, "layers": cfg.n_layers,
         "parameters": n, "weight_bytes": weights,
         "prefill_ms": prefill_ms, "ttft_ms": prefill_ms,
         "prefill_positions": B * (S + extra),
         "decode_ms_per_token": statistics.mean(dec),
         "decode_ms_median": statistics.median(dec),
         "wall_s": wall, "tok_s": B * FAMILY_NEW / wall,
         "peak_bytes": peak, "swa_launches": launches,
         "route_check": route}
    print("  (a) generate " + json.dumps(a))
    print(f"  first tokens {toks[:, :8].tolist()}")
    want = _prefill_launches(cfg)
    if launches != want:
        raise AssertionError(f"{cfg.name}: swa_attention launched "
                             f"{launches} times in generate, not {want}")
    if toks.shape != (B, FAMILY_NEW) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"{cfg.name}: generate gave a bad shape or "
                             "non-finite logits")
    if not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError(f"{cfg.name}: token ids out of the vocabulary")
    if cfg.n_experts and cfg.top_k > 1:
        # one new token: the prefill alone
        prof = _profile_generate(generate, model, params, batch, buf, 1)
        print("  (a) profile of one prefill " + json.dumps(prof))
        a["profile"] = prof

    # (b) one prompt in chunks of FAMILY_CHUNK
    one = {k: v[:1] for k, v in batch.items()}
    swa.reset_launches()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    states, start = model.make_state(params, one, buf)
    for j in range(0, S, FAMILY_CHUNK):
        lg, states = model.prefill_chunk(
            params, states, one["tokens"][:, j:j + FAMILY_CHUNK], start + j)
    e1.record()
    torch.cuda.synchronize()
    chunks = -(-S // FAMILY_CHUNK)
    b_launch = swa.LAUNCHES["swa_attention"]
    # make_state: the encoder pass, or the prefix at index 0; the first
    # chunk's self-attention at index 0 (no prefix); every chunk's
    # cross-attention
    want = (cfg.n_enc_layers + cfg.n_layers * (1 + chunks)
            if cfg.n_enc_layers else cfg.n_layers)
    diff = float((lg[0] - logits[0]).abs().max())
    b = {"ms": e0.elapsed_time(e1), "start": int(start), "chunks": chunks,
         "swa_launches": b_launch,
         "max_abs_last_logits_vs_a": diff,
         "logits_scale": float(logits[0].abs().max())}
    why = ("a MoE chunk is its own routing group" if cfg.n_experts
           else "bf16 sums in another order")
    print("  (b) chunked prefill " + json.dumps(b) + " (the difference is "
          f"information: {why})")
    if b_launch != want:
        raise AssertionError(f"{cfg.name}: chunked prefill launched "
                             f"swa_attention {b_launch} times, not {want}")
    if int(start) != extra or not bool(torch.isfinite(lg).all()):
        raise AssertionError(f"{cfg.name}: make_state start {start} or "
                             "non-finite chunk logits")
    del params, states, timed, model, lg, logits, batch, one
    torch.cuda.empty_cache()

    # (c) the continuous-batching launcher at a cut depth
    c = _launcher_drill(name, {"swa_attention": swa})
    torch.cuda.empty_cache()
    return {"a": a, "b": b, "c": c, "launches": launches}


def _train_family(pk, name, layers, over, lr):
    """(d) DPPF rounds at full width on the flat engine's kernel mode (as
    phase 3): M = 4, tau 4, seq 64, batch 8 a worker, the round batches
    carrying the stubbed prefix / frames (made before the rounds, so that
    no round times their host draws); counters zeroed just before the
    state is made. ``over``: config fields set for training; ``lr`` the
    local steps' learning rate."""
    from repro_torch.configs import DPPFConfig
    from repro_torch.core import consensus
    from repro_torch.data import TokenTask, make_round_batch
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer
    from repro_torch.train import (
        RoundClock, init_train_state, make_round_step,
    )
    import repro_torch.train.trainer as trainer_mod
    cfg = dataclasses.replace(_family_cfg(name, layers), **over)
    M, tau, seq, batch = 4, 4, 64, 8
    model = build_model(cfg)
    dcfg = DPPFConfig(alpha=0.1, lam=0.5, tau=tau, consensus="simple_avg",
                      engine="flat")
    opt = make_optimizer("sgd", momentum=0.9, weight_decay=1e-3)
    clock = RoundClock.from_config(dcfg, base_lr=lr,
                                   total_steps=FAMILY_ROUNDS * tau)
    task = TokenTask(vocab_size=cfg.vocab_size, seq_len=seq)
    batches = [make_round_batch(task, 0, M, spec.tau, spec.start, batch, cfg,
                                device="cuda") for spec in clock.rounds]
    inputs = sorted(batches[0])
    torch.cuda.reset_peak_memory_stats()
    pk.reset_launches()
    state = init_train_state(model.init, opt, dcfg, M,
                             torch.Generator(device="cuda").manual_seed(0),
                             device="cuda")
    n, R = state.engine.layout.n, state.engine.layout.R
    stages = sum(s[0] == "coef" for s in consensus.lower_stages(
        state.engine, dcfg, clock.lam_at(0))[0])
    step = make_round_step(model.loss, opt, dcfg, clock=clock)
    state, rounds = _timed_rounds(
        trainer_mod, step, [state],
        [lambda b=b: b for b in batches], f"(d) {cfg.name}")
    launches = dict(pk.LAUNCHES)
    d = {"config": cfg.name, "layers": cfg.n_layers,
         "enc_layers": cfg.n_enc_layers, "set": over, "lr": lr, "n": n,
         "view_bytes": 4 * R * n,
         "inputs": inputs, "rounds": rounds,
         "peak_bytes": torch.cuda.max_memory_allocated(),
         "fused_round": launches["fused_round"]}
    print("  (d) training " + json.dumps(d))
    del state, step, batches
    torch.cuda.empty_cache()
    if not all(math.isfinite(r["loss"]) for r in rounds):
        raise AssertionError(f"{cfg.name}: non-finite training loss")
    if not all(r["consensus_dist"] > 0 for r in rounds[1:]):
        raise AssertionError(f"{cfg.name}: consensus_dist 0 after round 0")
    if launches["fused_round"] != stages * len(rounds):
        raise AssertionError(f"{cfg.name}: fused_round launched "
                             f"{launches['fused_round']} times for "
                             f"{stages * len(rounds)} consensus stages")
    bad = _merged_launched(launches, f"{cfg.name}'s training")
    if bad:
        raise AssertionError("; ".join(bad))
    return d, launches


def phase_families(pk, swa, plain):
    """Phase 17: the attention kernel at this phase's shapes, then the four
    families served, then two trained. Returns the swa_attention row's
    additions and the launches of each main path."""
    t_all = time.perf_counter()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    print(f"  card {card}")
    gen = torch.Generator(device="cuda").manual_seed(17)
    attn = {}
    for name, case in ATTN_FAMILIES.items():
        row = _attn_case(swa, plain, case, torch.bfloat16, gen, name,
                         plain_reps=3)
        attn[name] = {k: row[k] for k in (
            "shape", "ms", "ms_model_layout", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "max_rel_err",
            "max_rel_err_model_layout")}
        torch.cuda.empty_cache()
    secs = {"attention": time.perf_counter() - t_all}
    launches, seen = {}, set()
    for name, layers, S in FAMILIES:
        t0 = time.perf_counter()
        cfg = _family_cfg(name, layers)
        route = _family_route_check(swa, cfg)
        with _attn_census(seen):
            served = _serve_family(swa, cfg, S, route)
        launches[f"{name} serving, {served['a']['layers']} layers "
                 "(phase 17)"] = served["launches"]
        secs[name] = time.perf_counter() - t0
    checked = set(ATTN_FAMILIES.values())
    unchecked = sorted(case for dtype, case in seen
                       if dtype != torch.bfloat16 or case not in checked)
    print(f"  census: (a)-(c) launched swa_attention at {len(seen)} "
          f"shapes, each held above: {not unchecked}")
    if unchecked:
        raise AssertionError("swa_attention launched at shapes not held "
                             f"against its plain version: {unchecked}")
    train_launches = {}
    for name, layers, over, lr in FAMILY_TRAIN:
        t0 = time.perf_counter()
        d, counts = _train_family(pk, name, layers, over, lr)
        label = (f"{name} training, {d['layers']} layers, "
                 f"{FAMILY_ROUNDS} rounds (phase 17)")
        for k, v in counts.items():
            if v:
                train_launches.setdefault(k, {})[label] = v
        secs[f"{name} training"] = time.perf_counter() - t0
    print("  phase 17 seconds " + json.dumps(secs))
    return {"attention": attn, "serve_launches": launches,
            "train_launches": train_launches}


# ---------------------------------------------------------------------------
# phase 18: the autotune search
# ---------------------------------------------------------------------------

# (a): yi-6b at LAYERS, M = 4, doublebuf with staleness 1, on sequences of
# TUNE_SEQ tokens: the fleet's three (4, n) fp32 views take 58.4 GB and a
# worker's activations ~2.3 MB a token, so batches of 2048-token sequences
# reach the card's memory at 5-6 of them; the budget ends the search at
# one point of the joint sweep (a tau 4 probe at the frontier takes ~18 s)
TUNE_SEQ = 2048
TUNE_SPACE = dict(min_batch=1, max_batch=6, taus=(4, 8), chunks=(1, 2, 4),
                  probe_budget=6, overlap="doublebuf", staleness=1)
TUNE_REPS = 1
TUNE_MEM_TOL = 4 << 20      # allocated bytes a probe may leave behind
# the kernels every feasible doublebuf probe launches: its stale rounds'
# chunk Grams, coefficients and mix with the stale epilogue
TUNE_KERNELS = ("partial_gram", "mix_from_gram", "stale_mix")
# (b): the smoke launcher, searched under an injected frontier, then
# replayed from the plan it wrote
TUNE_ARGV = ["--arch", "yi-6b", "--smoke", "--workers", "4", "--tau", "2",
             "--steps", "8", "--seq", "16", "--batch", "1", "--overlap",
             "doublebuf", "--probe-budget", "8"]
TUNE_OOM_ABOVE = 3
TUNE_PLAN = os.path.join(ROOT, "build", "chip_smoke", "tune18", "plan.json")


def _tune_search(pk):
    """(a) ``autotune`` through the port's API on the card: the round probe
    runner at full width, no injected fault. Each probe is recorded with
    the memory allocated before and after it, the exception it raised and
    the kernels it launched."""
    from repro_torch.configs import DPPFConfig, get_arch
    from repro_torch.data import TokenTask, make_round_batch
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer
    from repro_torch.train import (
        TunePlan, TuneSpace, autotune, make_lm_model_fn,
        make_round_probe_runner,
    )
    cfg = dataclasses.replace(get_arch("yi-6b"), n_layers=LAYERS)
    M = 4
    space = TuneSpace(**TUNE_SPACE)
    model = build_model(cfg)
    dcfg = DPPFConfig(alpha=0.1, lam=0.5, tau=space.taus[0],
                      consensus="simple_avg", engine="flat",
                      overlap=space.overlap, overlap_chunks=1,
                      staleness=space.staleness)
    opt = make_optimizer("sgd", momentum=0.9, weight_decay=1e-3)
    task = TokenTask(vocab_size=cfg.vocab_size, seq_len=TUNE_SEQ)
    rounds = 2 + TUNE_REPS
    inner = make_round_probe_runner(
        model.init, model.loss, opt, dcfg, M,
        lambda c: make_round_batch(task, 0, M, c.tau, 0, c.batch, cfg,
                                   device="cuda"),
        base_lr=LR, total_steps=rounds * max(space.taus), reps=TUNE_REPS,
        seed=0, device="cuda")
    model_fn = make_lm_model_fn(n_params=cfg.param_count(), seq=TUNE_SEQ,
                                workers=M, overlap=space.overlap,
                                staleness=space.staleness)
    records = []

    def runner(cand):
        torch.cuda.synchronize()
        rec = {"batch": cand.batch, "tau": cand.tau,
               "chunks": cand.overlap_chunks,
               "allocated_before": torch.cuda.memory_allocated(),
               "raised": None}
        before = dict(pk.LAUNCHES)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            return inner(cand)
        except BaseException as e:
            rec["raised"] = type(e).__name__
            raise
        finally:
            rec["seconds"] = time.perf_counter() - t0
            rec["peak_bytes"] = torch.cuda.max_memory_allocated()
            rec["allocated_after"] = torch.cuda.memory_allocated()
            rec["launches"] = {k: v - before[k] for k, v in pk.LAUNCHES.items()
                               if v > before[k]}
            records.append(rec)

    t0 = time.perf_counter()
    pk.reset_launches()                     # main path: counts from here
    plan = autotune(runner, model_fn, space)
    launches = dict(pk.LAUNCHES)
    secs = time.perf_counter() - t0
    os.makedirs(os.path.dirname(TUNE_PLAN), exist_ok=True)
    plan.save(TUNE_PLAN)
    with open(TUNE_PLAN) as f:
        saved = f.read()
    reloaded = TunePlan.load(TUNE_PLAN).dumps()
    for p, rec in zip(plan.probes, records):
        print("  (a) probe " + json.dumps(dict(
            rec, ok=p.ok, us_round=p.us_round, modeled_us=p.modeled_us)))
    ch = plan.chosen
    out = {"seq": TUNE_SEQ, "n": cfg.param_count(), "space": TUNE_SPACE,
           "chosen": [ch.batch, ch.tau, ch.overlap_chunks],
           "failures": list(plan.failures),
           "probes_used": plan.probes_used,
           "residual_scale": plan.residual_scale,
           "dominates_model": plan.dominates_model,
           "dominates_measured": plan.dominates_measured,
           "seconds": secs, "launches": launches}
    print("  (a) search " + json.dumps(out))
    fails = []
    if not any(r["raised"] == "OutOfMemoryError" for r in records):
        fails.append("no probe met a real torch.cuda.OutOfMemoryError")
    for r in records:
        if abs(r["allocated_after"] - r["allocated_before"]) > TUNE_MEM_TOL:
            fails.append(f"probe {r['batch']},{r['tau']},{r['chunks']} "
                         f"left {r['allocated_after'] - r['allocated_before']}"
                         " bytes allocated")
    base = (space.taus[0], space.chunk_ladder()[0])
    ladder_ok = [p.batch for p in plan.probes
                 if p.ok and (p.tau, p.overlap_chunks) == base]
    if ch.batch != max(ladder_ok):
        fails.append(f"chose batch {ch.batch}, the ladder's largest "
                     f"feasible is {max(ladder_ok)}")
    if list(plan.failures) != sorted(set(plan.failures)):
        fails.append(f"failures {plan.failures} not sorted and unique")
    if plan.probes_used > space.probe_budget:
        fails.append(f"{plan.probes_used} probes > budget")
    if not plan.dominates_model:
        fails.append("the chosen point does not dominate the model")
    if reloaded != saved:
        fails.append("TunePlan.load of the saved plan re-dumps otherwise")
    for p, r in zip(plan.probes, records):
        if p.ok and any(r["launches"].get(k, 0) == 0 for k in TUNE_KERNELS):
            fails.append(f"feasible probe {r['batch']},{r['tau']},"
                         f"{r['chunks']} launched {r['launches']}")
        fails += _merged_launched(r["launches"], f"probe {r['batch']},"
                                  f"{r['tau']},{r['chunks']}")
    if fails:
        raise AssertionError("phase 18(a): " + "; ".join(fails))
    return out


def _tune_launcher(pk):
    """(b) The launcher's ``--autotune --tune-oom-above N --tune-plan P``,
    then ``--tune-plan P`` alone: both build the same round plan."""
    from repro_torch.launch import train as train_mod
    from repro_torch.train import RoundClock
    plans = []
    orig = RoundClock.from_tune_plan.__func__

    def recorded(cls, *a, **kw):
        clock = orig(cls, *a, **kw)
        plans.append(clock.describe())
        return clock

    if os.path.exists(TUNE_PLAN):
        os.remove(TUNE_PLAN)
    runs = {}
    pk.reset_launches()                     # main path: counts from here
    RoundClock.from_tune_plan = classmethod(recorded)
    try:
        for label, extra in (
                ("search", ["--autotune", "--tune-oom-above",
                            str(TUNE_OOM_ABOVE), "--tune-plan", TUNE_PLAN]),
                ("replay", ["--tune-plan", TUNE_PLAN])):
            loss = train_mod.main(TUNE_ARGV + extra)
            runs[label] = loss
    finally:
        RoundClock.from_tune_plan = classmethod(orig)
    launches = dict(pk.LAUNCHES)
    with open(TUNE_PLAN) as f:
        chosen = json.load(f)["chosen"]
    out = {"losses": runs, "chosen": chosen, "round_plans_equal":
           len(plans) == 2 and plans[0] == plans[1],
           "round_plan": plans[0] if plans else None, "launches": launches}
    print("  (b) launcher " + json.dumps(out))
    if not out["round_plans_equal"]:
        raise AssertionError(f"phase 18(b): replay's round plan differs: "
                             f"{plans}")
    if not all(math.isfinite(v) for v in runs.values()):
        raise AssertionError(f"phase 18(b): eval losses {runs}")
    if chosen["batch"] != TUNE_OOM_ABOVE:
        raise AssertionError(f"phase 18(b): chose {chosen} under a frontier "
                             f"of {TUNE_OOM_ABOVE}")
    return out


def phase_autotune(pk):
    """Phase 18: (a) the search at full width, (b) the launcher's flags."""
    secs = {}
    t0 = time.perf_counter()
    a = _tune_search(pk)
    secs["a"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    b = _tune_launcher(pk)
    secs["b"] = time.perf_counter() - t0
    print("  phase 18 seconds " + json.dumps(secs))
    return {"a": a, "b": b, "seconds": secs}


# ---------------------------------------------------------------------------
# phase 19: launch analysis against the card
# ---------------------------------------------------------------------------

INSPECT_TOL = 0.01        # (b): allocated bytes against validate's formula
DRYRUNS = (["--arch", "yi-6b", "--shape", "train_4k", "--nodes", "1,32"],
           ["--arch", "gemma2-2b", "--shape", "decode_32k", "--nodes", "1"])
TUNE_SHARDED_ARGV = ["--arch", "yi-6b", "--smoke", "--d-model", "32",
                     "--layers", "1", "--workers", "4", "--tau", "2",
                     "--steps", "2", "--seq", "16", "--batch", "1",
                     "--max-batch", "4", "--probe-budget", "4",
                     "--tune-oom-above", "2", "--overlap", "doublebuf",
                     "--autotune", "--sharded"]


def _census_of_the_slice(pk, launches, slice_res):
    """(a): phase 3's round traced on meta (``launch.roofline.
    analyze_step``); each kernel's calls against phase 3's launches a
    round, and the modelled round beside the measured one."""
    from repro_torch.configs import DPPFConfig, get_arch
    from repro_torch.launch import roofline as rf
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer
    from repro_torch.train import (
        RoundClock, init_train_state, make_round_step,
    )
    cfg = dataclasses.replace(get_arch("yi-6b"), n_layers=LAYERS)
    M, tau, steps, seq, batch = SLICE_RUN
    model = build_model(cfg)
    dcfg = DPPFConfig(alpha=0.1, lam=0.5, tau=tau, consensus="simple_avg",
                      engine="flat")
    opt = make_optimizer("sgd", momentum=0.9, weight_decay=1e-3)
    clock = RoundClock.from_config(dcfg, base_lr=LR, total_steps=steps)
    t0 = time.perf_counter()
    state = init_train_state(model.init, opt, dcfg, M, None, device="meta")
    step = make_round_step(model.loss, opt, dcfg, clock=clock)
    b = {k: torch.empty((tau, M, batch, seq), dtype=torch.int64,
                        device="meta") for k in ("tokens", "labels")}
    ana = rf.analyze_step(step, state, b)
    trace_s = time.perf_counter() - t0
    calls = {k: v["calls"] for k, v in ana["kernels"].items()}
    rounds = slice_res["rounds"]
    per_round = {k: v / rounds for k, v in launches.items() if v}
    print(f"  (a) phase 3's round traced on meta in {trace_s:.2f} s: "
          f"flops {ana['flops']:.6e}, bytes {ana['bytes']:.6e}, kernels "
          + json.dumps(ana["kernels"]) + f"; phase 3's launches a round "
          + json.dumps(per_round))
    if calls != per_round:
        raise AssertionError(f"(a) the trace counts {calls}, phase 3 "
                             f"launched {per_round} a round")
    terms = rf.roofline(ana["flops"], ana["bytes"], ana["collectives"])
    model_ms = rf.overlap_model(terms, ana["collective_axis_bytes"],
                                R=M)["exact_s"] * 1e3
    measured = slice_res["round_ms"]
    print(f"  (a) modelled round {model_ms:.3f} ms (compute "
          f"{terms['compute_s'] * 1e3:.3f} + memory "
          f"{terms['memory_s'] * 1e3:.3f}, on {rf.PEAK_FLOPS:.3e} FLOP/s "
          f"and {rf.HBM_BW:.3e} B/s), measured {measured:.3f} ms (phase "
          f"3, mean of rounds 1..): measured / modelled "
          f"{measured / model_ms:.3f}")
    return {"calls": calls, "trace_s": trace_s, "flops": ana["flops"],
            "bytes": ana["bytes"], "model_ms": model_ms,
            "measured_ms": measured, "ratio": measured / model_ms}


def _persistent_state(cfg, M, opt):
    """The tree engine's persistent state of ``M`` workers on the card, as
    the trainer holds it: each stacked leaf in its dtype and the
    optimizer's state (``opt.init``). Its bytes; freed on return."""
    from repro_torch.core.engine import tree_from_items, tree_items
    from repro_torch.launch.specs import param_specs
    params = tree_from_items([
        (path, torch.empty((M,) + tuple(leaf.shape), dtype=leaf.dtype,
                           device="cuda"))
        for path, leaf in tree_items(param_specs(cfg))])
    mom = opt.init(params, workers=M)
    torch.cuda.synchronize()
    return sum(t.numel() * t.element_size()
               for tree in (params, mom) for _, t in tree_items(tree))


def _state_against_total_memory(M=SLICE_RUN[0]):
    """(b), the card's memory: the tree engine's persistent state of ``M``
    workers builds at the largest yi-6b depth whose ``launch.validate``
    formula fits the card's ``total_memory``, the next depth raises a real
    OutOfMemoryError, and nothing is left allocated. It runs before phase
    2 (or, with ``--phases 19``, before phases 3 and 12): by phase 19 the
    CUDA context and the libraries the earlier phases load hold about 2.1
    GiB of the card outside PyTorch's allocator (0.7 GiB after phase 12
    alone; both measured on an H100 80GB HBM3), and 17 layers need all but
    1.7 GiB of it."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import validate
    from repro_torch.optim import make_optimizer
    total = torch.cuda.get_device_properties(0).total_memory
    yi = get_arch("yi-6b")
    need = lambda L: validate.state_gb(dataclasses.replace(
        yi, n_layers=L).param_count(), 1) * 1e9 * M
    fit = max(L for L in range(1, yi.n_layers + 1) if need(L) <= total)
    opt = make_optimizer("sgd", momentum=0.9, weight_decay=1e-3)
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    free = torch.cuda.mem_get_info()[0]
    t0 = time.perf_counter()
    built = _persistent_state(dataclasses.replace(yi, n_layers=fit), M,
                              opt)
    t_fit = time.perf_counter() - t0
    oom = ""
    try:
        _persistent_state(dataclasses.replace(yi, n_layers=fit + 1), M,
                          opt)
    except torch.cuda.OutOfMemoryError as e:
        oom = str(e).splitlines()[0]
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() - before
    print(f"  (b) total_memory {total} bytes ({free} free, {before} "
          f"allocated): {fit} layers need {need(fit):.0f} and built "
          f"({built} bytes, {t_fit:.2f} s); {fit + 1} layers need "
          f"{need(fit + 1):.0f}: {oom or 'built'}; {left} bytes left "
          "allocated")
    if not oom:
        raise AssertionError(f"(b) {fit + 1} layers built past the card")
    if abs(built - need(fit)) > INSPECT_TOL * need(fit) or left:
        raise AssertionError(f"(b) the state built {built} bytes against "
                             f"{need(fit):.0f}; {left} bytes left")
    return {"total_memory": total, "free_before": free, "fit_layers": fit,
            "fit_bytes": built, "oom": oom, "left_bytes": left}


def _formula_against_allocation(tree_res):
    """(b), the allocation: the bytes phase 12's round holds between
    rounds against ``launch.validate``'s formula (params bf16 + momentum
    fp32, per worker) x M, within 1%; else the buffer that differs is
    named."""
    from repro_torch.launch import validate
    n, M, base = tree_res["n"], tree_res["M"], tree_res["base_bytes"]
    want = validate.state_gb(n, 1) * 1e9 * M
    # allocated between rounds less what was allocated before phase 12
    # built its state
    got = [r["allocated_bytes"] - base for r in tree_res["rounds"]]
    worst = max(abs(g - want) / want for g in got)
    free = torch.cuda.mem_get_info()[0]
    print(f"  (b) phase 12 between rounds: allocated {got} bytes above the "
          f"{base} allocated before its state was built, against the "
          f"formula's {want:.0f} (params bf16 + momentum fp32 x {M} "
          f"workers): largest difference {worst:.3%}; the card has {free} "
          "bytes free now")
    if worst > INSPECT_TOL:
        parts = tree_res["state_bytes"]
        named = {"params": 2 * n * M, "momentum": 4 * n * M,
                 "consensus state": 0}
        off = {k: parts[k] - named[k] for k in parts if parts[k] != named[k]}
        off["other buffers"] = max(got) - sum(parts.values())
        raise AssertionError(f"(b) allocated bytes {got} differ from the "
                             f"formula's {want:.0f} by more than "
                             f"{INSPECT_TOL:.0%}; buffers that differ "
                             f"(bytes): {off}")
    return {"allocated": got, "base_bytes": base, "formula": want,
            "worst": worst, "free_now": free}


def _planner_and_report():
    """(c): the dry-run CLI over H100 nodes into a fresh directory, then the
    ``roofline`` suite row on it."""
    import contextlib as ctx
    import io
    import tempfile
    from repro_torch.benchmarks import run as bench_run
    from repro_torch.launch import dryrun
    base = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(base, exist_ok=True)
    out = tempfile.mkdtemp(prefix="dryrun19_", dir=base)
    t0 = time.perf_counter()
    for argv in DRYRUNS:
        buf = io.StringIO()
        try:
            with ctx.redirect_stdout(buf):
                dryrun.main(argv + ["--out", out])
        except SystemExit as e:
            raise AssertionError("(c) the dry-run failed:\n"
                                 + buf.getvalue()[-3000:]) from e
        print("\n".join("  (c) " + l for l in buf.getvalue().splitlines()
                        if l.startswith(("[", "all", "round plan"))))
    t_dry = time.perf_counter() - t0
    buf = io.StringIO()
    with ctx.redirect_stdout(buf):
        recs = bench_run.suites(roofline_dir=out)["roofline"]()
    rows = buf.getvalue().splitlines()
    print("\n".join("  (c) " + l for l in rows))
    shutil.rmtree(out, ignore_errors=True)
    kinds = [l.split(",")[0] for l in rows]
    if len(recs) != 3 or kinds.count("roofline") != 3 \
            or kinds.count("roofline_overlap") != 2:
        raise AssertionError(f"(c) {len(recs)} records, rows {kinds}")
    return {"seconds": t_dry, "records": [
        {k: r[k] for k in ("arch", "shape", "mesh", "mode", "roofline",
                           "hlo_flops_per_dev", "hlo_bytes_per_dev",
                           "lower_s", "kernels")} for r in recs]}


TUNE_SHARDED_PLAN = os.path.join(ROOT, "build", "chip_smoke", "plan19.json")


def _launcher_autotune_sharded_start():
    """(d), started: ``--sharded --autotune`` under torchrun on two ranks,
    in the background (beside (c), which traces on the host alone)."""
    return _Started([sys.executable, "-m", "torch.distributed.run",
                     "--standalone", "--nproc-per-node", "2", "-m",
                     "repro_torch.launch.train", *TUNE_SHARDED_ARGV,
                     "--tune-plan", TUNE_SHARDED_PLAN], "autotune19")


def _launcher_autotune_sharded(started):
    """(d): both ranks of the ``started`` run print the same plan (the
    sha256 of its JSON, that of the file rank 0 writes) and rank 1 probes
    nothing."""
    import hashlib
    import re
    plan = TUNE_SHARDED_PLAN
    proc, secs = started.finish()
    if proc.returncode != 0:
        raise AssertionError("torchrun --sharded --autotune failed:\n"
                             + proc.stdout[-3000:] + proc.stderr[-3000:])
    seen = {int(r): (h, int(n)) for r, h, n in re.findall(
        r"autotune rank (\d): plan sha256 ([0-9a-f]{64}), probes here "
        r"(\d+)", proc.stdout)}
    text = open(plan).read()
    sha = hashlib.sha256(text.encode()).hexdigest()
    chose = [l for l in proc.stdout.splitlines()
             if l.startswith("autotune: chose")]
    print(f"  (d) torchrun --sharded --autotune, 2 ranks, {secs:.1f} s "
          f"(beside (c)): "
          f"{chose}; ranks {seen}; the plan file's sha256 {sha}")
    if sorted(seen) != [0, 1] or seen[0][0] != sha or seen[1][0] != sha \
            or seen[1][1] != 0 \
            or seen[0][1] != json.loads(text)["probes_used"]:
        raise AssertionError(f"(d) ranks {seen}, plan sha256 {sha}")
    return {"seconds": secs, "ranks": seen, "chose": chose}


def phase_launch_analysis(pk, launches, slice_res, tree_res, memory):
    """Phase 19. ``memory``: ``_state_against_total_memory``'s result, run
    first in the script (its docstring says why)."""
    secs, out = {}, {}
    print("  (b) at the start of the run: " + json.dumps(memory))
    for part, fn in (
            ("a", lambda: _census_of_the_slice(pk, launches, slice_res)),
            ("b", lambda: dict(_formula_against_allocation(tree_res),
                               **memory))):
        t0 = time.perf_counter()
        out[part] = fn()
        secs[part] = time.perf_counter() - t0
    # (d)'s torchrun starts first and runs while (c) traces on the host;
    # its seconds run from its start, so (c)'s are inside them
    t0 = time.perf_counter()
    started = _launcher_autotune_sharded_start()
    try:
        out["c"] = _planner_and_report()
        secs["c"] = time.perf_counter() - t0
        out["d"] = _launcher_autotune_sharded(started)
        secs["d"] = time.perf_counter() - t0
    finally:
        started.stop()
    print("  phase 19 seconds " + json.dumps(secs))
    out["seconds"] = secs
    return out


# ---------------------------------------------------------------------------
# phase 20: tensor-parallel serving over the model axis
# ---------------------------------------------------------------------------

TP_WORLD = 2             # ranks sharing the one card over gloo (as 15(b))
# (config, layers, B, S) at full width, greedy, TP_NEW new tokens:
# qwen2-72b (arXiv:2407.10671) cut 80 -> 4 layers (5.99 B parameters,
# 12.0 GB in bf16; the whole model, 145 GB, fits no one card), dbrx-132b
# (hf:databricks/dbrx-base) cut 40 -> 2 (8 experts a rank), on a prompt
# where capacity drops happen
TP_RUNS = (("qwen2-72b", 4, 2, 2048), ("dbrx-132b", 2, 4, 2048))
TP_NEW = 16
TP_SEED = 20
TP_TOL = 2e-2      # bf16: a step's logits against one rank's, of the row's
#                    largest |logit| (the ranks' partial sums round apart)
TP_TIE = 1e-4      # on one rank's MoE inputs a rank routes as one rank,
#                    but where the K-th and (K+1)-th router logits lie
#                    closer than this (fp32 sums of another split)
TP_APART = 0.05    # on its own activations, the share of tokens a rank
#                    may route apart from one rank (bf16 near ties flip
#                    every token of a type at once: 0.73% on an H100)
TP_FILE = os.path.join(ROOT, "build", "chip_smoke", "tp20.pt")
# a MoE run's prompt draws its tokens from this many ids: hidden states
# that cluster route to few experts, past their capacity (seeded random
# prompts over the whole vocabulary drop nothing at dbrx's factor 1.25)
TP_MOE_IDS = 16
# swa_attention at the shapes the ranks launch (nq / 2 over nkv / 2 heads)
ATTN_TP = {"qwen2_tp": (2, 32, 4, 2048, 2048, 128, 0, 0.0, True),
           "dbrx_tp": (4, 24, 4, 2048, 2048, 128, 0, 0.0, True)}


def _tp_batch(cfg, B, S):
    gen = torch.Generator(device="cuda").manual_seed(TP_SEED + 1)
    ids = TP_MOE_IDS if cfg.n_experts else cfg.vocab_size
    return {"tokens": torch.randint(0, ids, (B, S), device="cuda",
                                    generator=gen)}


def _choices(routed):
    """A routing's (expert ids (G, Tg, K) in ascending order, int16, and
    their keep flags in that order) on the host: the entries, whatever
    the order of their gates."""
    ids = routed[2].argmax(-1)
    ids, order = ids.sort(-1)
    return ids.to(torch.int16).cpu(), routed[3].gather(-1, order).bool().cpu()


@contextlib.contextmanager
def _routing(log):
    """Append each MoE routing's (``_choices``, the K-th minus the
    (K+1)-th router logit (G, Tg)) to ``log``, on the host."""
    from repro_torch.models import moe as moe_lib
    orig = moe_lib._route

    def recorded(p, xg, cfg_, tp=None):
        out = orig(p, xg, cfg_, tp)
        K = out[2].shape[2]
        top = torch.topk(out[0], K + 1, dim=-1).values
        log.append(_choices(out)
                   + ((top[..., K - 1].log() - top[..., K].log()).cpu(),))
        return out

    moe_lib._route = recorded
    try:
        yield
    finally:
        moe_lib._route = orig


@contextlib.contextmanager
def _moe_inputs(xs):
    """Append the input of every MoE layer of a prefill (S > 1) to ``xs``,
    on the host."""
    from repro_torch.models import moe as moe_lib
    orig = moe_lib.moe_mlp

    def recorded(p, x, cfg_, per_row=False, **kw):
        if x.shape[1] > 1:
            xs.append(x.cpu())
        return orig(p, x, cfg_, per_row=per_row, **kw)

    moe_lib.moe_mlp = recorded
    try:
        yield
    finally:
        moe_lib.moe_mlp = orig


@contextlib.contextmanager
def _swa_shapes(seen):
    """Append the (B, H, Hkv, Sq, Skv, hd, window, cap, causal) of every
    ``swa_attention`` call the model makes to ``seen``."""
    from repro_torch.kernels.swa_attention import ops
    orig = ops.swa_attention

    def recorded(q, k, v, *, causal=True, window=0, cap=0.0):
        B, H, Sq, hd = q.shape
        seen.append((B, H, k.shape[1], Sq, k.shape[2], hd, int(window),
                     float(cap), bool(causal)))
        return orig(q, k, v, causal=causal, window=window, cap=cap)

    ops.swa_attention = recorded
    try:
        yield
    finally:
        ops.swa_attention = orig


def _tp_generate(swa, model, params, batch, buf, n_model):
    """The main path: ``generate``, greedy, with CUDA events around its
    lanes, the kernel counts, the collectives' census and the staged
    bytes zeroed just before it and read just after (after a 2-token
    warm-up: the first call of a shape pays cuBLAS's and the kernels'
    set-up)."""
    from repro_torch.launch import census
    from repro_torch.launch import mesh as mm
    from repro_torch.serving import generate
    generate(model, params, batch, max_new_tokens=2, buf_len=buf)
    timed, events = _events_of(model, ("prefill", "decode_step"))
    c, seen = census.Census(n_model), []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mm.reset_staged()
    swa.reset_launches()
    t0 = time.perf_counter()
    with census.counting(c), _swa_shapes(seen):
        toks, logits = generate(timed, params, batch, max_new_tokens=TP_NEW,
                                buf_len=buf)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res = c.result()
    dec = [a.elapsed_time(b) for a, b in events["decode_step"]]
    return {"tokens": toks.cpu(), "prefill_logits": logits.float().cpu(),
            "prefill_ms": events["prefill"][0][0].elapsed_time(
                events["prefill"][0][1]),
            "decode_ms_per_token": statistics.mean(dec), "wall_s": wall,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "swa_launches": swa.LAUNCHES["swa_attention"],
            "swa_shapes": sorted(set(seen)),
            "collectives": {k: v for k, v in res["collectives"].items()
                            if v["count"]},
            "collective_axis_bytes": {k: v for k, v in
                                      res["collective_axis_bytes"].items()
                                      if v},
            "staged_bytes": mm.STAGED["bytes"],
            "staged_s": mm.STAGED["seconds"]}


def _teacher_forced(model, params, batch, forced, buf, capture=False):
    """The prefill, then one decode step a token of ``forced`` (B, n):
    (fp32 logits (B, n + 1, V) on the host, the routing of every MoE
    call, the prefill's MoE inputs if ``capture``)."""
    log, xs = [], []
    S = batch["tokens"].shape[1]
    forced = forced.to(batch["tokens"].device)
    with _routing(log), (_moe_inputs(xs) if capture
                         else contextlib.nullcontext()):
        logits, states = model.prefill(params, batch, buf)
        steps = [logits.float().cpu()]
        for i in range(forced.shape[1] - 1):
            lg, states = model.decode_step(params, states,
                                           forced[:, i:i + 1], S + i)
            steps.append(lg.float().cpu())
    del states
    return torch.stack(steps, 1), log, xs


def _tp_one_rank(swa, name, layers, B, S):
    """One card, one rank: ``generate``, then the teacher-forced pass on
    its own tokens, the MoE layers' inputs and drops of its prefill."""
    from repro_torch.core.engine import tree_items
    from repro_torch.models import build_model
    cfg = _family_cfg(name, layers)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(TP_SEED),
                        "cuda")
    weights = sum(t.numel() * t.element_size() for _, t in tree_items(params))
    batch = _tp_batch(cfg, B, S)
    buf = S + TP_NEW
    main = _tp_generate(swa, model, params, batch, buf, 1)
    logits, log, xs = _teacher_forced(model, params, batch, main["tokens"],
                                      buf, capture=bool(cfg.n_experts))
    drops = [int((keep == 0).sum()) for _, keep, _ in log[:len(xs)]]
    del params, model, batch
    torch.cuda.empty_cache()
    return dict(main, weight_bytes=weights, logits=logits, routing=log,
                moe_inputs=xs, drops=drops)


def _tp_rank(rank, world, runs, ref_path):
    """A rank of the (1, world) mesh: each run's shard cut by
    ``shard_params`` from the same seeded full tree, ``generate`` (the
    main path), the teacher-forced pass on the one-rank tokens, and its
    routing of the one-rank prefill's MoE inputs."""
    from repro_torch.configs.base import MeshPlan
    from repro_torch.core.engine import tree_items
    from repro_torch.launch import mesh as mm
    from repro_torch.models import build_model, moe as moe_lib
    import importlib
    swa = importlib.import_module(
        "repro_torch.kernels.swa_attention.swa_attention")
    mesh = mm.Mesh(mm.FLAT_AXES, (1, world), device=DEV)
    plan = MeshPlan()
    refs = torch.load(ref_path)
    out = {}
    for name, layers, B, S in runs:
        cfg = _family_cfg(name, layers)
        model = build_model(cfg, mesh, plan)
        t0 = time.perf_counter()
        params = model.init(torch.Generator(device=DEV).manual_seed(TP_SEED),
                            DEV)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        weights = sum(t.numel() * t.element_size()
                      for _, t in tree_items(params))
        built_s = time.perf_counter() - t0
        batch = _tp_batch(cfg, B, S)
        buf = S + TP_NEW
        ref = refs[name]
        main = _tp_generate(swa, model, params, batch, buf, world)
        logits, log, _ = _teacher_forced(model, params, batch,
                                         ref["tokens"], buf)
        on_ref = []
        for layer, x in enumerate(ref["moe_inputs"]):
            router = params["blocks"]["stack"]["moe"]["router"][layer]
            on_ref.append(_choices(moe_lib._route(
                {"router": router}, x.to(DEV), model.tp.cfg, model.tp)))
        out[name] = dict(main, weight_bytes=weights, built_s=built_s,
                         logits=logits, routing=log, routing_on_ref=on_ref,
                         heads=(model.tp.cfg.n_heads,
                                model.tp.cfg.n_kv_heads))
        del params, model, batch
        torch.cuda.empty_cache()
    return out


def _row_errs(got, want):
    """(B, n) largest |got - want| of each row over its largest |want|."""
    return (got - want).abs().amax(-1) / want.abs().amax(-1).clamp_min(1e-30)


def _routed_apart(ids1, keep1, ids2, keep2, where):
    """(G, Tg) bools of the tokens two routings of one call route apart:
    (their choices, their choices or keep flags). Raises where a token is
    kept or dropped apart with the same choices and no token of its group
    before it routed apart (only that moves a queue)."""
    ids_diff = (ids1 != ids2).any(-1)
    keep_diff = (keep1 != keep2).any(-1)
    for g, t in (keep_diff & ~ids_diff).nonzero().tolist():
        if not bool(ids_diff[g, :t].any()):
            raise AssertionError(
                f"{where}: token ({g}, {t}) kept or dropped apart from one "
                "rank with no choice routed apart before it")
    return ids_diff, ids_diff | keep_diff


def _routing_rows(one, got, B, n_steps):
    """Compare a rank's routing on its own activations with one rank's:
    (a (B, n_steps) bool of the (row, step)s whose own token routed alike
    in every MoE layer, the tokens routed to another set of experts, the
    tokens routed, over all calls). A prefill call is (G = B, Tg = S):
    its last token is step 0; a decode call routes the batch as one group
    (1, B): step i + 1."""
    same = torch.ones((B, n_steps), dtype=torch.bool)
    apart = routed = 0
    layers = len(one) // n_steps
    for c, ((ids1, keep1, _), (ids2, keep2, _)) in enumerate(zip(one, got)):
        step = c // layers
        ids_diff, diff = _routed_apart(ids1, keep1, ids2, keep2,
                                       f"routing call {c}")
        apart += int(ids_diff.sum())
        routed += ids_diff.numel()
        if step == 0:
            same[:, 0] &= ~diff[:, -1]
        else:
            same[:, step] &= ~diff[0]
    return same, apart, routed


def _tp_check(name, one, ranks, cfg):
    """The ranks' results against one rank's; raises on a failed check.
    Returns the printed summary."""
    B, n = one["tokens"].shape
    for r, got in enumerate(ranks):
        if not torch.equal(got["tokens"], ranks[0]["tokens"]):
            raise AssertionError(f"{name}: rank {r}'s tokens differ from "
                                 "rank 0's")
        if got["tokens"].shape != (B, n) or not bool(
                torch.isfinite(got["logits"]).all()):
            raise AssertionError(f"{name}: rank {r} gave a bad shape or "
                                 "non-finite logits")
        want = [(B, cfg.n_heads // TP_WORLD, max(cfg.n_kv_heads // TP_WORLD,
                                                  1), s[3], s[4], s[5], s[6],
                 s[7], s[8]) for s in got["swa_shapes"]]
        if got["swa_launches"] != cfg.n_layers or \
                got["swa_shapes"] != want or not all(
                    s in ATTN_TP.values() for s in got["swa_shapes"]):
            raise AssertionError(
                f"{name}: rank {r} launched swa_attention "
                f"{got['swa_launches']} times at {got['swa_shapes']}, not "
                f"{cfg.n_layers} at nq / {TP_WORLD} over nkv / {TP_WORLD}")
    if one["swa_launches"] != cfg.n_layers:
        raise AssertionError(f"{name}: one rank launched swa_attention "
                             f"{one['swa_launches']} times")
    if cfg.n_experts and not sum(one["drops"]):
        raise AssertionError(f"{name}: the prompt dropped no entry")
    res = {"config": name, "layers": cfg.n_layers,
           "one_rank": {k: one[k] for k in (
               "prefill_ms", "decode_ms_per_token", "wall_s", "peak_bytes",
               "weight_bytes", "swa_launches", "drops")}}
    errs, agree, compared, apart_rows = [], 0, 0, 0
    for r, got in enumerate(ranks):
        err = _row_errs(got["logits"], one["logits"])          # (B, n)
        same, apart, routed = torch.ones((B, n), dtype=torch.bool), 0, 0
        drops, ties = [], 0
        if cfg.n_experts:
            # on one rank's inputs: the same choices, keep flags and drops
            for layer, ((ids2, keep2), (ids1, keep1, gap1)) in enumerate(
                    zip(got["routing_on_ref"], one["routing"])):
                ids_diff, _ = _routed_apart(
                    ids1, keep1, ids2, keep2,
                    f"{name}: rank {r}, layer {layer}, one rank's inputs")
                ties += int(ids_diff.sum())
                if bool(ids_diff.any()) and not \
                        float(gap1[ids_diff].max()) < TP_TIE:
                    raise AssertionError(
                        f"{name}: rank {r} routes one rank's layer {layer} "
                        f"inputs apart at a router-logit gap of "
                        f"{float(gap1[ids_diff].max()):.3e}")
                drops.append(int((keep2 == 0).sum()))
            if drops != one["drops"]:
                raise AssertionError(
                    f"{name}: rank {r} drops {drops} entries on one rank's "
                    f"prefill MoE inputs, one rank {one['drops']}")
            same, apart, routed = _routing_rows(one["routing"],
                                                got["routing"], B, n)
            if apart > TP_APART * routed:
                raise AssertionError(
                    f"{name}: rank {r} routed {apart} of {routed} tokens "
                    f"apart from one rank (over {TP_APART:.0%})")
        held = err[same]
        if not bool((held <= TP_TOL).all()):
            raise AssertionError(
                f"{name}: rank {r} logits {float(held.max()):.3e} of the "
                f"row's scale from one rank's (tolerance {TP_TOL})")
        top2 = one["logits"].topk(2, dim=-1).values
        margin = (top2[..., 0] - top2[..., 1]) / \
            one["logits"].abs().amax(-1)
        pick = got["logits"].argmax(-1)
        clear = same & (margin > TP_TOL)
        wrong = clear & (pick != one["tokens"])
        if bool(wrong.any()):
            raise AssertionError(f"{name}: rank {r}'s greedy token differs "
                                 f"from one rank's at {wrong.nonzero()} "
                                 "where the margin is clear")
        agree += int((pick == one["tokens"]).sum())
        compared += pick.numel()
        apart_rows += int((~same).sum())
        errs.append({"rank": r, "max_rel_err": float(held.max()),
                     "max_rel_err_all_rows": float(err.max()),
                     "tokens_routed_apart": apart, "tokens_routed": routed,
                     "rows_routed_apart": int((~same).sum()),
                     "drops_on_one_rank_inputs": drops,
                     "ties_on_one_rank_inputs": ties,
                     **{k: got[k] for k in (
                         "prefill_ms", "decode_ms_per_token", "wall_s",
                         "peak_bytes", "weight_bytes", "built_s",
                         "swa_launches", "staged_bytes", "staged_s",
                         "collectives", "collective_axis_bytes")},
                     "swa_heads": got["heads"],
                     "peak_over_half_one_rank": got["peak_bytes"] / (
                         one["peak_bytes"] / 2)})
    res.update(ranks=errs, greedy_tokens_equal=f"{agree}/{compared}",
               tokens_equal_one_rank=bool(torch.equal(ranks[0]["tokens"],
                                                      one["tokens"])))
    return res


def phase_tp(swa, plain):
    """Phase 20: tensor-parallel serving over the model axis. Returns the
    ranks' swa_attention launches on the main path and the attention
    rows at the ranks' shapes."""
    t_all = time.perf_counter()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    print(f"  card {card}")
    gen = torch.Generator(device="cuda").manual_seed(TP_SEED)
    attn = {}
    for name, case in ATTN_TP.items():
        row = _attn_case(swa, plain, case, torch.bfloat16, gen, name,
                         plain_reps=3)
        attn[name] = {k: row[k] for k in (
            "shape", "ms", "ms_model_layout", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "max_rel_err",
            "max_rel_err_model_layout")}
        torch.cuda.empty_cache()
    secs = {"attention": time.perf_counter() - t_all}
    refs = {}
    for name, layers, B, S in TP_RUNS:
        t0 = time.perf_counter()
        refs[name] = _tp_one_rank(swa, name, layers, B, S)
        secs[f"{name} one rank"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    os.makedirs(os.path.dirname(TP_FILE), exist_ok=True)
    torch.save({k: {f: v[f] for f in ("tokens", "moe_inputs")}
                for k, v in refs.items()}, TP_FILE)
    for ref in refs.values():
        ref.pop("moe_inputs")
    _release_host_memory()
    torch.cuda.empty_cache()
    try:
        ranks = _spawn_ranks(_tp_rank, TP_WORLD, TP_RUNS, TP_FILE,
                             timeout=240)
    finally:
        os.remove(TP_FILE)
    secs["ranks"] = time.perf_counter() - t0
    launches = {}
    for name, layers, B, S in TP_RUNS:
        cfg = _family_cfg(name, layers)
        res = _tp_check(name, refs[name], [r[name] for r in ranks], cfg)
        print(f"  {name} ({layers} layers, B = {B}, S = {S}, {TP_NEW} new, "
              f"{TP_WORLD} ranks) " + json.dumps(res))
        launches[f"{name} tensor-parallel serving, {layers} layers, "
                 f"{TP_WORLD} ranks (phase 20)"] = sum(
            r[name]["swa_launches"] for r in ranks)
    secs["total"] = time.perf_counter() - t_all
    print("  phase 20 seconds " + json.dumps(secs))
    return {"attention": attn, "launches": launches}



_T0 = time.perf_counter()
_REMOVALS = []     # deletions on threads of their own, joined in ``main``


def _remove_in_background(path):
    """Delete ``path`` on a thread of its own, while the next phase runs
    (unlinking the 33.5 GB resume point took 6-8 s on the card's host);
    ``main`` waits for every such deletion before it returns."""
    import threading
    t = threading.Thread(target=shutil.rmtree, args=(path,),
                         kwargs={"ignore_errors": True})
    t.start()
    _REMOVALS.append(t)


def _phase(title):
    """Print a phase's header, and the same with the seconds since the
    script started on standard error, flushed, so that a run stopped from
    outside shows how far it got."""
    print(title, flush=True)
    print(f"chip_smoke: {time.perf_counter() - _T0:.1f} s, {title}",
          file=sys.stderr, flush=True)


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description="the port's smoke run on one "
                                 "card (all phases when run with no "
                                 "arguments)")
    ap.add_argument("--phases", default="",
                    help="comma-separated phases to run after phase 1 "
                         "(a partial run prints no kernels record)")
    args = ap.parse_args(argv)
    only = {int(p) for p in args.phases.split(",") if p}
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device — the port's smoke run "
                         "needs the card")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import importlib
    from repro_torch.kernels import _build
    from repro_torch.kernels.pullpush import pullpush as pk
    from repro_torch.kernels.pullpush import ref
    from repro_torch.kernels.swa_attention import swa_attention_plain
    from repro_torch.kernels.mamba_scan import ref as ssd_ref
    from repro_torch.kernels.slstm_step import ref as slstm_ref
    swa = importlib.import_module(
        "repro_torch.kernels.swa_attention.swa_attention")
    mk = importlib.import_module("repro_torch.kernels.mamba_scan.mamba_scan")
    sk = importlib.import_module("repro_torch.kernels.slstm_step.slstm_step")

    _phase("phase 1: card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(f"  torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    # one nvcc per source, all started together
    _build.build(*_build.all_sources())
    print(f"  kernels built in {time.perf_counter() - t0:.2f} s")
    for name, info in _build.build_info.items():
        own = info["nvcc_seconds"]
        print(f"  {name}: {info['path']}"
              + (f" (nvcc {own:.2f} s)" if own is not None else ""))
        print("\n".join("    " + line for line in info["log"].splitlines()
                        if "registers" in line or "spill" in line))

    secs = {"card": time.perf_counter() - t_start}
    try:
        if only:
            _partial(only, pk, ref, swa, swa_attention_plain, secs)
        else:
            _whole(pk, ref, swa, swa_attention_plain, mk, ssd_ref, sk,
                   slstm_ref, secs, t_start)
    finally:       # the resume point (~33.5 GB) never outlives the run
        for t in _REMOVALS:
            t.join()
        shutil.rmtree(os.path.dirname(RESUME_POINT), ignore_errors=True)


def _partial(only, pk, ref, swa, swa_attention_plain, secs):
    """``--phases``: phase 1, then the phases named, alone."""
    if not only <= {2, 14, 15, 16, 17, 18, 19, 20} or (16 in only
                                                       and 15 not in only):
        raise SystemExit("--phases: any of 2, 14, 15, 16, 17, 18, 19, 20 "
                         "(phase 16 resumes from phase 15's resume point: "
                         "15,16; 19 runs phases 3 and 12 first)")
    for ph in sorted(only):
        t0 = time.perf_counter()
        _phase(f"phase {ph} (partial run)")
        if ph == 2:
            rows, leaf_errs = phase_kernels(pk, ref)
            print("  kernels " + json.dumps(list(rows.values())))
            print("  leaf kernels' errors (abs, rel) "
                  + json.dumps(leaf_errs))
        elif ph == 15:
            res = phase_sharded(pk, ref, RESUME_POINT if 16 in only
                                else None)
            print("  fused_round_sharded " + json.dumps(res["row"]))
        elif ph == 14:
            res = phase_harness(pk, ref)
            print("  pullpush_fused " + json.dumps(res["fused"]["full"]))
            print("  leaf kernels " + json.dumps(res["fused"]["rows"]))
        elif ph == 16:
            phase_supervised(pk, RESUME_POINT)
        elif ph == 18:
            phase_autotune(pk)
        elif ph == 20:
            tp = phase_tp(swa, swa_attention_plain)
            print("  swa_attention at phase 20's shapes "
                  + json.dumps(tp["attention"]))
            print("  swa_attention launches " + json.dumps(tp["launches"]))
        elif ph == 19:
            memory = _state_against_total_memory()
            launches, slice_res = phase_slice(pk)
            tree = phase_tree(pk, ref)
            phase_launch_analysis(pk, launches, slice_res, tree, memory)
        else:
            fam = phase_families(pk, swa, swa_attention_plain)
            print("  swa_attention at phase 17's shapes "
                  + json.dumps(fam["attention"]))
            print("  swa_attention launches " + json.dumps(
                fam["serve_launches"]))
        secs[ph] = time.perf_counter() - t0
    print("partial run, phase seconds " + json.dumps(secs))


def _whole(pk, ref, swa, swa_attention_plain, mk, ssd_ref, sk, slstm_ref,
           secs, t_start):
    """Phases 2-20, the kernels record and the contract's last line."""
    held = {}      # bytes allocated as each phase starts
    _phase("phase 19(b), first: the persistent state against total_memory")
    t0 = time.perf_counter()
    memory = _state_against_total_memory()
    secs["state vs total_memory"] = time.perf_counter() - t0
    _phase("phase 2: kernels against their plain versions")
    held[2] = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    rows, leaf_errs = phase_kernels(pk, ref)
    secs["kernels"] = time.perf_counter() - t0

    _phase("phase 3: the slice (yi-6b, full width)")
    held[3] = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    launches, none_mode = phase_slice(pk)
    secs["slice"] = time.perf_counter() - t0
    for name, row in rows.items():
        row["launches"] = launches[name]

    _phase("phase 4: the launcher")
    held[4] = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    phase_launcher(pk)
    secs["launcher"] = time.perf_counter() - t0

    _phase("phase 5: swa_attention against its plain version")
    held[5] = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    rows["swa_attention"] = phase_attention(swa, swa_attention_plain)
    secs["attention"] = time.perf_counter() - t0

    _phase("phase 6: serving gemma2-2b (full width, full depth)")
    held[6] = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    by_path = {"gemma2-2b serving": phase_serving(swa)}
    secs["serving"] = time.perf_counter() - t0

    _phase("phase 7: ssd_chunks against its plain version")
    held[7] = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    rows["ssd_chunks"] = phase_ssd(mk, ssd_ref)
    secs["ssd"] = time.perf_counter() - t0

    _phase("phase 8: serving zamba2-7b (full width, full depth)")
    held[8] = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    zamba = phase_zamba2(swa, mk)
    secs["zamba2"] = time.perf_counter() - t0
    # launches on each main path that runs the kernel, and their sum
    rows["swa_attention"]["launches_by_path"] = dict(
        by_path, **{"zamba2-7b serving": zamba["swa_attention"]})
    rows["swa_attention"]["launches"] = sum(
        rows["swa_attention"]["launches_by_path"].values())
    rows["ssd_chunks"]["launches_by_path"] = {
        "zamba2-7b serving": zamba["ssd_chunks"]}
    rows["ssd_chunks"]["launches"] = zamba["ssd_chunks"]

    _phase("phase 9: slstm_steps against its plain version")
    held[9] = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    rows["slstm_steps"] = phase_slstm(sk, slstm_ref)
    secs["slstm"] = time.perf_counter() - t0

    _phase("phase 10: serving xlstm-350m (full width, full depth)")
    held[10] = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    xl = phase_xlstm(sk)
    secs["xlstm"] = time.perf_counter() - t0
    rows["slstm_steps"]["launches_by_path"] = {"xlstm-350m serving": xl}
    rows["slstm_steps"]["launches"] = xl

    _phase("phase 11: sq_dist and apply_update against their plain versions")
    held[11] = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    rows.update(phase_pair(pk, ref))
    secs["pair"] = time.perf_counter() - t0

    _phase("phase 12: the tree path (yi-6b, full width)")
    held[12] = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    tree = phase_tree(pk, ref)
    secs["tree"] = time.perf_counter() - t0
    for name in PAIR_REPLACES:
        rows[name]["launches_by_path"] = {
            "yi-6b tree training, 4 Eq. 5 rounds": tree["eq5"][name],
            "yi-6b tree training, 1 easgd round": tree["easgd"][name]}
        rows[name]["launches"] = tree["eq5"][name] + tree["easgd"][name]

    _phase("phase 13: the overlap modes (yi-6b, full width)")
    held[13] = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    overlap = phase_overlap(pk, ref, none_mode)
    secs["overlap"] = time.perf_counter() - t0
    rows.update(overlap["rows"])
    for name in REPLACES:
        rows[name]["launches_by_path"] = {
            "yi-6b training, none (phase 3)": launches[name],
            "yi-6b training, overlap modes (phase 13)":
                overlap["launches"][name]}
        rows[name]["launches"] += overlap["launches"][name]

    _phase("phase 14: the paper's harness and measures")
    held[14] = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    harness = phase_harness(pk, ref)
    secs["harness"] = time.perf_counter() - t0
    for name, n in harness["launches"].items():
        if n:
            rows[name].setdefault("launches_by_path", {})[
                "MLP harness: quickstart + --fast suites (phase 14)"] = n
            rows[name]["launches"] += n
    rows["fused_round"]["pullpush_fused"] = harness["fused"]["full"]
    for name, row in harness["fused"]["rows"].items():
        # errors: phase 2's small trees and the full-width tree
        row["max_abs_err"] = max(row["max_abs_err"], leaf_errs[name][0])
        row["max_rel_err"] = max(row["max_rel_err"], leaf_errs[name][1])
        n = harness["fused"]["full"]["launches"][name]
        row["launches_by_path"] = {
            "pullpush_fused, yi-6b stacked bf16 tree (phase 14b)": n}
        row["launches"] = n
        rows[name] = row

    _phase("phase 15: the sharded round on torch.distributed ranks")
    held[15] = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    sharded = phase_sharded(pk, ref, RESUME_POINT)
    secs["sharded"] = time.perf_counter() - t0
    rows["fused_round_sharded"] = dict(sharded["row"], launches_by_path={})
    for mode, counts in sharded["by_overlap"].items():
        label = ("yi-6b sharded staleness_k, elastic, 1 layer, 2 ranks "
                 "(phase 15)" if mode == "staleness_k" else
                 f"yi-6b sharded rounds, {mode}, 1 layer, 2 ranks "
                 "(phase 15)")
        for name, n in counts.items():
            if n and name in rows:
                rows[name].setdefault("launches_by_path", {})[label] = n
                if name != "fused_round_sharded":
                    rows[name]["launches"] += n

    _phase("phase 16: the fault-tolerant round loop")
    held[16] = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    sup = phase_supervised(pk, RESUME_POINT)
    secs["supervised"] = time.perf_counter() - t0
    for label, counts in (
            ("chaos replay, 8 ranks, reduced yi-6b (phase 16a)", sup["a"]),
            ("yi-6b supervised staleness_k, 1 layer (phase 16b)",
             sup["b"])):
        for name, n in counts.items():
            if n and name in rows:
                rows[name].setdefault("launches_by_path", {})[label] = n
                rows[name]["launches"] += n

    _phase("phase 17: the MoE, enc-dec and vlm families")
    held[17] = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    fam = phase_families(pk, swa, swa_attention_plain)
    secs["families"] = time.perf_counter() - t0
    row = rows["swa_attention"]
    row["phase17_shapes"] = fam["attention"]
    row["launches_by_path"].update(fam["serve_launches"])
    row["launches"] += sum(fam["serve_launches"].values())
    for name, by_path in fam["train_launches"].items():
        if name in rows:
            rows[name].setdefault("launches_by_path", {}).update(by_path)
            rows[name]["launches"] += sum(by_path.values())

    _phase("phase 18: the autotune search")
    held[18] = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    tune = phase_autotune(pk)
    secs["autotune"] = time.perf_counter() - t0
    for part, label in (
            ("a", "yi-6b autotune search, doublebuf, full width (phase 18a)"),
            ("b", "smoke launcher --autotune, then --tune-plan (phase 18b)")):
        for name, n in tune[part]["launches"].items():
            if n and name in rows:
                rows[name].setdefault("launches_by_path", {})[label] = n
                rows[name]["launches"] += n

    _phase("phase 19: launch analysis against the card")
    held[19] = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    phase_launch_analysis(pk, launches, none_mode, tree, memory)
    secs["launch analysis"] = time.perf_counter() - t0

    _phase("phase 20: tensor-parallel serving over the model axis")
    held[20] = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    tp = phase_tp(swa, swa_attention_plain)
    secs["tensor parallel"] = time.perf_counter() - t0
    row = rows["swa_attention"]
    row["phase20_shapes"] = tp["attention"]
    row["launches_by_path"].update(tp["launches"])
    row["launches"] += sum(tp["launches"].values())
    secs["total"] = time.perf_counter() - t_start
    print("phase seconds " + json.dumps(secs))
    print(f"chip_smoke: {secs['total']:.1f} s, every phase passed",
          file=sys.stderr, flush=True)
    print("allocated bytes as each phase starts " + json.dumps(held))

    record = list(rows.values())
    print("kernels " + json.dumps([
        {k: r[k] for k in ("name", "launches", "ms", "plain_ms", "bound_ms",
                           "library_ms")} | {"max_err": r["max_rel_err"]}
        for r in record]))
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
