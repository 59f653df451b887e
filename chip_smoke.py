#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA card: the quickest proof that the port still starts on the GPU.

    python3 chip_smoke.py          # from the repository root, one card

Phases, in order; any failure exits non-zero and prints no result line:

  1. the card's name and power limit, as nvidia-smi reports them;
  2. build every kernel from the sources in the checkout: one nvcc for
     sm_90a per csrc/*.cu (dampen.cu: dampen, dampen_int8 and
     dampen_int8_rowscale; fimd.cu; gemm_fisher.cu; gemm_fisher_int8.cu),
     all started together, with each kernel's registers and spills;
  3. each kernel against its plain PyTorch version on the card. dampen and
     dampen_int8: one leaf per launch at every ResNet-18 leaf shape, three
     (alpha, lambda) pairs (f32 and bf16 theta for dampen, int8 codes for
     dampen_int8), and the edge cases (ties, half-way codes, saturation,
     zeros, NaN/inf, lambda = NaN/inf, alpha = 0, n = 1, n % 4 != 0,
     misaligned pointers): the result and the mask must be BIT-identical;
     then one launch over a table of leaves, as the request launches them:
     each layer's table, the whole 56-leaf tree, tables past the 64-leaf
     capacity, and edge tables (empty leaves, n < 4, odd n, offset views,
     in place, NaN/inf/1e-38, int8 ties and saturation), every leaf and the
     selection count BIT-identical and the launch and leaf counters equal to
     the table; the same over VIT_CIFAR20's 14 layer tables (leaves of 192
     to 147,456 elements, the rank-3 patch/cls and patch/pos) and its
     176-leaf tree. The four kernels reached
     through ``kernels.ops`` only: odd shapes, misaligned pointers, special
     values, extreme codes, and for the GEMMs reductions split over N
     (S > 1) with a ragged last slice and, for gemm_fisher_int8, N = MAX_N
     with every code -128 (every sum at the int32 limit);
     for dampen_int8_rowscale rows of 1, 2, 3 and 5 elements over several
     blocks, rows that end inside a block, partial last blocks, leaves cut
     into parts (small ones, cut at a small limit) and two leaves of more
     than 2^31 elements (21.5 GB each, the host's cut into parts);
     dampen_int8_rowscale and gemm_fisher_int8 BIT-identical, fimd within
     rtol 1e-5 (atol 0), gemm_fisher within relative L2 1e-5 and
     |d| <= 1e-4 |ref| + 1e-4 max|ref|, its fish bit-equal to dw * dw and
     every case run twice with the same bits;
  4. the slices at full width: RESNET18_CIFAR20 (random weights from a
     seed, pre-trained here for a few hundred steps of the port's AdamW,
     ``repro_torch.optim``, so that halting means something) served
     through ``Unlearner`` with ``use_kernel=True``:
     ensure_fisher on a retain batch, a 64-image forget request of one
     class at chunk 8, in "ssd" mode (all 10 layers: 10 kernel launches
     over 56 leaves, one per layer) and "ficabu" mode (checkpoint_every=2;
     one launch per layer swept), then warm requests that must build
     nothing — first the fp32 path, then the int8 path
     (``precision="int8"``: dampen_int8 on the codes, every leaf on its q8
     grid, per-layer error against fp32 within INT8_SWEEP_RTOL). All six
     launch counters and the two leaf counters are zeroed just before each
     path and read just after: an fp32 request launches only dampen, an
     int8 request only dampen_int8, once per layer swept over every leaf of
     those layers;
  5. the whole ssd forget with the kernel against the same forget with the
     plain version, under deterministic cuDNN, fp32 and int8:
     bit-identical parameters;
  6. [vit]: the paper's ViT at full width, VIT_CIFAR20 (12 blocks, d_model
     192, 3 heads, d_ff 768, 65 tokens, 176 leaves in 14 layers, 7,120,340
     parameters), random weights from the seed pre-trained here, through
     ``Unlearner.forget`` on the same data with alpha 5 and b_r 5 (the
     reference's calibration of its reduced ViT; the paper's full-size
     ViT uses alpha 25 and b_r 10) and checkpoints every 3 blocks: "ssd" (14
     launches over 176 leaves), "ficabu", and "ficabu" with tau = -1 (it
     never halts) on a facade of its own (checkpoints l = 1, 3, 6, 9, 12,
     14; two checkpoint runners built cold, the depth-operand one and depth
     0's, none warm),
     each cold then warm, fp32 then int8, with the counters zeroed just
     before each path and read just after, as in phase 4; then the ssd
     forget with the kernel against the plain one, bit for bit, in both
     precisions;
  7. [scanned]: the scanned whole-sweep program (``sweep_mode="scanned"``,
     ``repro_torch.engine.sweep``) on the [vit] phase's weights and Fisher,
     inside one ``repro_torch.obs.telemetry`` capture: ssd, the
     never-halting ficabu and the ficabu that halts at l = 1, each cold
     then warm, fp32 then int8, the counters zeroed just before each path
     and read just after. Every request equals the layerwise request of
     [vit] bit for bit (parameters and stats) and launches its dampen
     kernel 14 times over all 176 leaves (the program masks a halted
     request's edits on the card instead of stopping); a sweep program is
     built on a request's first use of its key and never warm, once per
     request, and each warm program call runs under
     ``torch.cuda.set_sync_debug_mode("error")``. Then a K = 2 ssd
     ``forget_group`` of two classes' 64-image batches, scanned (cold and
     warm), equal to the layerwise drain of the same sets bit for bit, 28
     launches over 352 leaves, in both precisions; and a ResNet-18 K = 2
     group asked for as scanned: plan None, the layerwise drain, 20
     launches over 112 leaves. The telemetry events are counted by kind;
  8. [fisher kernels]: the ``kernels.ops`` API — the entry point of fimd,
     gemm_fisher, gemm_fisher_int8 and dampen_int8_rowscale, as in the JAX
     package — on operands of the same forget request (64 images, chunk 8):
     fimd on the 8 stacked chunk gradients of each of the 56 leaves,
     gemm_fisher and gemm_fisher_int8 on each chunk's cached input and
     output cotangent of the fc and three convs (im2col), and
     dampen_int8_rowscale on every leaf's int8 codes against its row-
     quantised forget Fisher. The four counters are zeroed just before and
     must count exactly the calls made. Each result is held against its
     plain version and against what the main path computes itself: the
     fused step's Fisher (grad_fisher_chunks), the autograd weight
     gradient, the fp32 dW (int8, its operands quantised per column of each
     1024-row block of N, within INT8_SWEEP_RTOL) and dampen_int8 on the
     dequantised Fisher;
  9. [lm]: the dense decoder LM at full width, gemma3-1b at 12 of its 26
     blocks (two periods of five local (window 512) to one global
     attention block, d_model 1152, 4 heads over 1 KV head of 256, d_ff
     6912, vocab 262,144, tied embeddings; 624,062,592 bf16 parameters in
     56 stored leaves, 110 layer leaves in 14 unlearn layers; all 26
     blocks until the [train] phase, which the cut pays for; two periods
     so that [shard] walks a stacked pair of periods; [serve] runs 6,
     [stream] all 26), random
     weights from a CUDA
     generator seeded with 0. Token data from ``make_lm_domains`` (data
     vocabulary 512, S = 1024 tokens, longer than the window); a request
     is 8 sequences of one domain at chunk 2, labelled with the model's own
     argmax, and the global Fisher comes from ``Unlearner.ensure_fisher``
     over 4 retain sequences labelled the same way; alpha 25, lambda 1,
     checkpoints every 4 layers. Served with the [lm] path's counters
     zeroed before and read after: ssd (14 launches over 110 leaves) cold
     and warm, ficabu with tau = -1 (every checkpoint), a ficabu whose tau
     is the forget accuracy that one read at its middle checkpoint (it
     halts partway), int8 ssd and ficabu (every layer on the grid the
     reference gives it, per-layer error against fp32 within
     INT8_SWEEP_RTOL), ssd and the halting ficabu with
     ``sweep_mode="scanned"`` (each == its layerwise request bit for bit),
     a K = 2 ficabu drain over two domains, layerwise and scanned (== bit
     for bit, each set halting at its first checkpoint at or below tau,
     beside single-set requests), and the ssd forget with the kernel
     against the plain one in both precisions (bit for bit on all 56
     stored leaves). Every parameter finite, the caller's tree unchanged;
     the peak of ``torch.cuda.max_memory_allocated``; warm ssd requests'
     wall, device busy time, idle share and device kernels; the 14-launch
     sweeps' device time against their byte bounds (13 bytes per element
     with bf16 theta, 11 with int8 codes);
 10. [shard]: sharded requests (``repro_torch.dist``) on [lm]'s weights,
     Fisher and request: ``Unlearner(...).shard(make_host_mesh(
     device="cuda"))`` (the 1x1 ("data", "model") mesh on a one-rank NCCL
     process group), ``use_kernel=True``, warm ssd requests in fp32
     layerwise, fp32 scanned and int8 (layerwise), each beside the same
     request through the unsharded facade: every parameter bit for bit,
     ``stopped_at_l``, the checkpoints, the selection counts and the MACs
     equal, the dampen launches and leaves equal (14 over 110 a request),
     every returned leaf a DTensor with ``placements(param_pspecs(...))``;
     the [shard] path's counters zeroed before and read after. Then the
     sharded fp32 result saved as a checkpoint and restored with
     ``sharding_fn`` onto the mesh, bit for bit, and the process group
     destroyed. The warm requests' walls, sharded beside unsharded;
 11. [cache]: the persistent compilation cache (the kernel build
     directory): ``python -m repro_torch.launch.serve --fleet <spec>
     --cache-dir <fresh dir> --check --device cuda`` twice, as
     subprocesses, on two gemma3-1b SMOKE tenants whose specs set
     ``use_kernel=True`` (``--check`` on a fleet needs two tenants of one
     family), 4 requests of 8 prompt tokens, 4 generated (``--check``
     runs under deterministic algorithms, as [fleet]): the first start
     builds the dampen library into the empty cache (``entries_before``
     0, ``entries_new`` >= 1), the second, a cold start on the warm cache,
     builds nothing (``entries_new`` 0) and passes ``--check``; the same
     gate fed the warm cache plus one more finished library reports it.
     Each start's seconds and entry counts;
 12. [recurrent]: the recurrent LMs at full width, bf16, from a CUDA
     generator seeded with 0, on the [lm] phase's data (vocabulary 512,
     S = 1024, chunk 2, argmax labels, the retain Fisher of 4 sequences
     from ensure_fisher), lambda 1: xlstm-125m at full width and 4 of its
     12 blocks (one period of mLSTM and sLSTM blocks 3:1, no FFN;
     87,909,144 parameters, 44 layer leaves in 6 unlearn layers; the
     sLSTM's host-bound time loop makes its requests the script's
     slowest, so its data, retain Fisher and requests are S = 512 tokens
     long), 8 sequences a request, checkpoints every 4 layers,
     alpha 50; recurrentgemma-9b at full width and 3 of its 38 blocks (one
     (rglru, rglru, local) period; 2,839,587,104 parameters, 38 leaves in
     5 layers; the whole model does not fit one card, and since the
     [train] phase it runs 3 blocks rather than 5), 4 sequences a
     request, checkpoints every 2 layers, alpha 25. First each model's
     layer tables (whole, and per dtype) through the group kernels
     against their plain versions; then, with the counters zeroed before
     and read after: ssd cold and warm, ficabu
     with tau = -1, int8 ssd (on its q8 grids, per-layer error against
     fp32 within INT8_SWEEP_RTOL; cold and warm on recurrentgemma, cold on
     xlstm), kernel forget == plain forget in both precisions; on
     recurrentgemma ssd with sweep_mode="scanned" (no plan for layers of
     unequal shapes: the layerwise loop, == the layerwise request bit for
     bit); on xlstm a ficabu that halts partway, fp32 and int8 (its
     per-layer int8 error within INT8_SWEEP_RTOL of an fp32 request that
     halts where it did: the fp32 one at the same tau, or, where a near-tie
     halts the two at different checkpoints, one whose tau is the fp32
     trace's value at the int8 request's), and a layerwise K = 2
     drain (not its "scanned" ssd and drain, the same layerwise loop that
     recurrentgemma and [encdec] hold, at ~3 s of host-bound sLSTM loop a
     request). An fp32 request launches the dampen kernel
     once per dtype of each layer swept (an RG-LRU layer's f32 log_lambda
     beside its bf16 weights: two launches), an int8 request once per
     layer. Every parameter finite, the caller's tree unchanged; peak
     memory, the warm ssd requests' wall, device busy time, idle share and
     device kernels (xlstm: fp32, its device activity alone), the sweeps
     against their byte bounds, and each model's and the phase's seconds;
 13. [dense]: the dense GQA LM yi-6b at full width (d_model 4096, 32
     heads over 4 KV heads of 128, d_ff 11008, vocab 64,000, RoPE theta
     5e6, untied) and 4 of its 32 blocks (1,216,385,024 bf16 parameters in
     12 stored leaves, 39 layer leaves in 6 unlearn layers; all 32 do not
     fit one card with their Fisher and a request; it ran 16 blocks before
     the [serve] phase and 8 before the [train] phase, to keep the script
     near 800 s), from a
     CUDA generator
     seeded with 0, on the [lm] phase's data (vocabulary 512, 8 sequences
     of S = 1024 at chunk 2, argmax labels, the retain Fisher of 4
     sequences), alpha 25, lambda 1, checkpoints every 4 layers. First its
     three distinct layer tables through the group kernels against their
     plain versions; then, with the counters zeroed before and read after:
     ssd cold and warm (6 launches over 39 leaves), ficabu with tau = -1
     and a ficabu that halts partway (cold and warm), ssd with
     sweep_mode="scanned" (the blocks are uniform: a plan, one program per
     request; cold and warm, the warm program call under
     ``set_sync_debug_mode("error")``, each == the layerwise request bit for
     bit), kernel forget == plain forget, int8 ssd cold and warm (on its q8
     grids, per-layer error against fp32 within INT8_SWEEP_RTOL), kernel ==
     plain in int8; then a request of 4 sequences of 2048 tokens, which
     takes the query-chunked attention in every block, layerwise cold and
     warm (its peak memory) and scanned cold and warm (== layerwise, bit for
     bit, the warm program call guarded). Every parameter finite, the
     caller's tree unchanged; one block's chunked attention against one
     block over all 2048 queries (largest relative difference, and whether
     the two are bit-identical); the warm ssd requests' wall, device busy
     time, idle share and device kernels; the 18-launch sweeps against their
     byte bounds, and the phase's seconds;
 13b. [qwen]: qwen1.5-32b at full width (d_model 5120, 40 heads over 40
     KV heads of 128 with q/k/v biases under RoPE theta 1e6, d_ff 27,392,
     vocab 152,064, untied) and 2 of its 64 blocks (2,608,389,120 bf16
     parameters in 15 stored leaves, 27 layer leaves in 4 unlearn layers),
     from a CUDA generator seeded with 0, on the [lm] phase's data (8
     sequences of S = 1024 at chunk 2, argmax labels, the retain Fisher of
     4 sequences), alpha 25, lambda 1, checkpoints every 2 layers. First
     its three distinct layer tables through the group kernels against
     their plain versions; then, with the counters zeroed before and read
     after: ssd cold and warm (4 launches over 27 leaves), kernel == plain,
     ficabu with tau = -1, a ficabu that halts partway with the kernel and
     the plain one (halting, MACs and every leaf equal), int8 ssd cold and
     warm (on its q8 grids, per-layer error against fp32 within
     INT8_SWEEP_RTOL) and kernel == plain in int8. Every parameter finite,
     the caller's tree unchanged; the peak memory; the warm ssd requests'
     wall, device busy time, idle share and device kernels; the sweeps
     against their byte bounds, and the phase's seconds;
 13c. [dryrun]: the dry-run launchers (``repro_torch.launch.dryrun``,
     ``unlearn_cell``, ``hillclimb``) against the card: (a) run_cell's
     record of qwen1.5-32b x decode_32k at 2 blocks on the 16 x 16 mesh,
     its terms at the card's peaks (``launch.roofline.PEAKS``), and that
     cell's function run for one data rank (8 of 128 rows, one token
     against a 32,768-token cache, 10.7 GB of bf16) on [qwen]'s weights:
     its device time beside step_time_bound_s and each term; (b)
     unlearn_cell's streamed and fused programs at one rank's share (4 of
     the 64 forget rows x 4096 tokens, one yi-6b attention block at full
     width), streamed == fused bit for bit, each timed beside its predicted
     terms, then the fused step replayed with ``use_kernel=True`` (the
     counters zeroed before and read after: 1 launch over the block's 9
     leaves), bit for bit against the plain step; (c) qwen1.5-32b x
     train_4k and hill-climb's qwen_fsdp counted on the host, their record
     lines;
 14. [moe]: the MoE LM llama4-scout-17b-a16e at full width (d_model
     5120, 40 heads over 8 KV heads of 128, 16 experts of d_ff 8192,
     top-1, a shared expert of 8192, capacity factor 1.25, vocab 202,048,
     RoPE theta 5e5, untied) and 1 of its 48 blocks (4,271,078,400
     parameters: bf16 weights and an f32 router, 16 stored leaves, 16 layer
     leaves in 3 unlearn layers; two blocks do not fit one card with their
     Fisher and a request), from a CUDA generator seeded with 0, on the
     [lm] phase's data (vocabulary 512, 2 sequences of S = 1024 at chunk 1,
     argmax labels, the retain Fisher of 4 sequences at chunk 2 from
     ensure_fisher through ``lm_loss`` with its aux weight 0.01), alpha
     800 (at 25 to 200 the int8 request misses INT8_SWEEP_RTOL in the
     block, at 400 it meets it by 0.2%), lambda 1,
     checkpoints at every layer. First the tables its requests launch
     through the group kernels against their plain versions (the bf16
     parts, the block's f32 router apart, and each whole layer as int8
     codes); then, with the counters zeroed before and read after: ssd
     cold and warm (4 launches over 16 leaves: the block's bf16 leaves and
     its router in two), ficabu with tau = -1 and a ficabu that halts
     partway (cold and warm), ssd with sweep_mode="scanned" (cold and warm,
     the warm program call under ``set_sync_debug_mode("error")``, each ==
     the layerwise request bit for bit), kernel forget == plain forget,
     int8 ssd cold and warm (on its q8 grids, per-layer error against fp32
     within INT8_SWEEP_RTOL), kernel == plain in int8. Every parameter
     finite, every router the caller's after every request (in int8 its
     pre-edit codes), the caller's tree unchanged; each block's capacity
     and dropped choices in the collection and in each vjp chunk, the aux
     loss (finite, > 0); the peak memory; the warm ssd requests' wall,
     device busy time, idle share and device kernels; the sweeps against
     their byte bounds, and the phase's seconds;
 15. [encdec]: the encoder-decoder whisper-tiny FULL (4 encoder and 4
     decoder blocks, d_model 384, 6 heads of 64, d_ff 1536, vocab 51,865,
     untied; 61,074,432 bf16 parameters in 27 stored leaves, the decoder
     chain's 59 layer leaves in 6 unlearn layers) and stub frames
     [8, 1500, 384], both from a CUDA generator seeded with 0; a request
     is 8 sequences of 448 tokens (the decoder's ceiling) at chunk 8, the
     frames' batch, labelled with the model's argmax, the retain Fisher of
     8 sequences on frames of their own; alpha 25, lambda 1, checkpoints
     at every layer. First its 6 layer tables through the group kernels
     against their plain versions; then, with the counters zeroed before
     and read after: ssd cold and warm (6 launches over 59 leaves), ficabu
     with tau = -1 and a ficabu that halts partway (cold and warm), ssd and
     the halting ficabu with sweep_mode="scanned" (no plan: the layerwise
     loop, == the layerwise request bit for bit), kernel forget == plain
     forget, int8 ssd cold and warm (on its q8 grids, per-layer error
     against fp32 within INT8_SWEEP_RTOL) and the halting ficabu, int8
     scanned == layerwise and kernel == plain, a K = 2 ssd drain layerwise
     and "scanned" (== bit for bit, 12 launches over 118 leaves). Every
     parameter finite, the encoder and enc_norm of every result bit for
     bit the caller's (in int8 their fake quantisation), the caller's tree
     unchanged; the warm ssd requests' wall, device busy time, idle share
     and device kernels; the sweeps against their byte bounds; then encode
     and 64 tokenwise decode_steps against the forward's logits. The
     decode checks of the LM phases run at the end of [lm] (gemma3-1b's
     64-token chunked prefill against its tokenwise decode too, caches
     included), of each [recurrent] model and of [moe] (at a capacity that
     drops nothing), on their phases' models: the stepped logits within a
     stated relative L2 of the forward's (DECODE_RTOL, DECODE_RTOL_CONV),
     not bit for bit;
 16. [serve]: the streamed Fisher refresh and the serving loop
     (``repro_torch.launch.serve.ForgetService`` on a one-tenant
     ``repro_torch.fleet.Fleet``) on gemma3-1b at full width and 6 of its
     26 blocks (``SERVE_BLOCKS``; 26 until the [shard] and [cache]
     phases, 12 until the [qwen] and [dryrun] phases), bf16, from a CUDA
     generator seeded with 0: make_lm_domains (vocabulary 512, 4 domains x
     16 sequences of 160 tokens); 3 batches of 8 prompts of 128 tokens, 32
     greedy tokens each (chunked prefill, then decode_step); forget bursts
     "1,2;3,2" due after batches 1 and 2, a flush at inf;
     ``ServeSpec(chunk_size=4, refresh_every=1, sweep_mode="scanned")``
     (ficabu, alpha 8, tau 0.6, checkpoints every 2 layers, a refresh of 2
     retain microbatches at decay 0.5 after every drain), under
     deterministic algorithms. In fp32 and int8: the service (the plain
     dampen, as the reference's ServeSpec lowers) passes every gate of the
     reference's ``serve --check`` (one sweep per drain point, no build for
     a drain signature already seen, one scanned launch per drain, the
     precision tag, an int8 sweep launched, a refresh with no build after
     the first, the staleness oracle), every parameter finite, int8 on its
     q8 grids; then a one-tenant Fleet on the same ServeSpec's lowering
     with ``use_kernel=True`` and the same submissions, the counters zeroed
     before and read after (16 launches over 112 leaves a drain), its
     served tree and Fisher bit for bit the service's; the fp32 service
     layerwise == scanned bit for bit; a guarded drain (``GuardSpec()``)
     under a ``nan_batch`` fault in both its attempts: rejected, requeued,
     dead-lettered, the live tree bit for bit as it was. Each warm drain's
     program call runs under ``torch.cuda.set_sync_debug_mode("error")``.
     Per drain its wall (cold, warm), layers reached and MACs against SSD;
     per refresh its wall and the staleness errors; generate's wall and
     tokens/s per batch, and NVML's busy share over one batch; the warm
     kernel drain's profile and its dampen time against the byte bound;
     the phase's peak memory and seconds;
 17. [stream]: the continuous-batching ``StreamEngine``
     (``repro_torch.launch.serve``) on gemma3-1b FULL weights and data
     of its own, seeded as [serve]'s (26 blocks, 999,812,736 bf16
     parameters: the depth its near-tie gate was set at), under
     deterministic algorithms: the traffic of ``serve --serve-mode
     stream``, 24 sequences of 128 prompt tokens, 32 generated each, 8
     decode slots, admission in chunks of 4 (prefill block 8), bursts
     "1,2;3,2" due at engine steps 32 and 64 and published 16 steps after
     they fire, ``ServeSpec(chunk_size=4, refresh_every=1,
     sweep_mode="scanned", publish="step")``; run twice, on a tenant whose
     lowered spec sets ``use_kernel=True`` (the counters zeroed before and
     read after: 112 dampen launches over 944 leaves, 2 drains x 2 sets x
     28 layers) and on the plain path (0 launches). Each run passes every
     gate of ``stream --check`` (``stream_check_problems``), publishes at
     exactly its deadlines, and runs every step_once after its last
     publication under ``torch.cuda.set_sync_debug_mode("error")``; the two
     runs' engine fingerprints, published trees, Fishers and every
     sequence's tokens equal bit for bit. The first 8 sequences (batch 0's
     prompts, done before the first publication) against ``generate`` of
     batch 0 on the same weights: where a token differs, generate's top-2 logit gap
     at the first differing position is below 1e-2, a replica of the
     engine's grouping (prefill per admission chunk of 4, decode of the
     pool of 8 at per-row positions) gives the wave bit for bit and
     chooses the engine's token there, and its logits teacher-forced on
     generate's tokens lie within DECODE_RTOL of generate's. Then a guarded
     drain under a ``worker_exc`` fault in both its attempts: aborted at
     its deadline and requeued, then dead-lettered, the live tree bit for
     bit as it was. Steps, tokens/s, decode-step wall p50 / p99 with and
     without a drain in flight, each drain's wall on the worker, peak
     memory and the phase's seconds;
 18. [fleet]: ``serve.run_fleet`` (the loop of ``serve --fleet``) on two
     gemma3-1b tenants at full width and 6 of its 26 blocks, one
     local/global period (``FLEET_BLOCKS``; all 26 until the [qwen] and
     [dryrun] phases, 12 until the [examples] phase), seeds
     0 and 1 (one family), built by the
     card's builder (data at vocabulary 512), with the reference CLI's
     traffic (8 requests of 16 prompt tokens, 8 generated, prefill block 8,
     3 batches, bursts "1,2;3,2" after batch 1, scanned), every gate of
     ``fleet_check_problems`` (the solo replay on a fresh cache bit for bit
     and with the fleet's builds), the shared cache's builds and hits;
 19. [recover]: the reference's kill-mid-drain scenario on the card:
     gemma3-1b at full width and 6 of its 26 blocks (one local/global
     period), ficabu (alpha 8, tau 0.6, checkpoints every 2 layers, chunk
     4, scanned) with a WAL; a subprocess drains once, checkpoints (params
     and Fisher, about 3.7 GB), WAL-accepts request 2 and is SIGKILLed at
     the top of its drain; the parent recovers (restored step 1, one
     replay, version 2, the WAL's accounting) to params and Fisher bit for
     bit equal to an uninterrupted twin, and ``latest_step`` skips a step
     that ``ckpt_crash`` cut between its shard and META;
 20. [load]: ``LoadHarness`` twice on freshly built [fleet]-like fleets
     (``LoadScenario(ticks=8, forget=poisson 0.5, serve_generate=False,
     domains=3, seed=0)``): equal fingerprints, the accounting equal to the
     scheduler's, and ``report --slo`` rendering the first run's JSONL
     stream against an ``SLOSpec`` (exit 0, every objective met);
 21. [train]: ``repro_torch.launch.train`` (the loop of ``main``) on
     gemma3-1b at full width and 6 of its 26 blocks (one local/global
     period; 463,026,816 bf16 parameters in 56 leaves), from a CUDA
     generator seeded with 0, on make_lm_domains at vocabulary 512 (8
     domains x 24 sequences of 128 tokens, the reference's draw), batch 8,
     lr 3e-3, 5 warm-up steps, under deterministic algorithms: 10 steps
     with checkpoints every 4 and the mid-run forget at step 8 (journal,
     pre-unlearn checkpoint, the retain Fisher, a ficabu request on the
     plain path: 0 kernel launches), every loss finite and the last below
     the first; a run resumed from step 4 (alone in a directory) with the
     same schedule and the same forget at step 8 (its pre-unlearn write
     the fourth), whose losses and final params, mu, nu, ef, step and
     data_step equal the first run's bit for bit (and the two step-8
     METAs' data_step); the forget replayed from the pre-unlearn
     checkpoint's params with ``use_kernel=True``, its counters zeroed
     before and read after, equal to the run's forget bit for bit; 2 steps
     under ``--compress int8`` with a finite EF state, and on one more
     gradient, per leaf, the f32 value sent plus the residual equal to
     ``g + e_prev`` within relative 1e-6, the bf16 ``sent`` that value
     cast, as the reference sends it. The
     warm step's wall, each checkpoint write's and the restore's seconds,
     the bytes on disk, the peak memory and the phase's seconds, beside
     the card's name and power limit. At most 4 checkpoint writes;
 22. [examples]: the port's six examples (``examples/torch_*.py``:
     quickstart, unlearn_lm_domain, train_then_forget,
     serve_with_unlearning, fleet_two_tenants, load_fleet_smoke), each
     one's ``run(device="cuda")`` in this process at the example's own
     sizes, one line each with its seconds and key outputs (halt depth,
     MACs vs SSD, accuracies, the resume step and journal, the staleness
     figures, the fleet's builds, the load run's fingerprints), gated on
     every check the reference example's own run passes (the serving
     example's ``improved`` printed, not gated: ROADMAP.md Queue 3);
 23. times: each kernel and its plain version at the main paths' shapes
     (the dampen sweeps as a request launches them, one grouped launch per
     layer, with the 56 per-leaf launches beside them and the figures from
     before the grouped kernel; and, for fimd and the GEMMs, one PyTorch
     library call computing the same function, the GEMMs' dW alone; the
     GEMMs on operand sets rotated beyond the L2, with their split plans),
     beside the bound (for
     gemm_fisher the larger of its bytes and the 3xTF32 arithmetic, the
     FP32-SIMT figure beside it), the ViT's 14-launch sweeps beside their
     byte bound, printed as one ``{"kernels": [...]}`` line, and where a
     warm fp32 and a warm int8 ssd request spend their time, ResNet-18 and
     ViT (device kernels, the dampen launches among them, idle share),
     and the ViT's warm scanned requests beside layerwise ones (ssd and
     the halting ficabu, fp32 and int8) and its fp32 K = 2 ssd drains
     beside two single requests. The dampen entries of the
     ``kernels`` line carry the [scanned] phase's launches and leaves,
     the [lm] phase's (``lm_*`` keys), the [recurrent] phase's
     (``rec_*``), the [dense] phase's (``dense_*``), the [qwen] and
     [dryrun] phases' (``qwen_*``, ``dryrun_*``), the [moe] phase's
     (``moe_*``), the [encdec] phase's (``encdec_*``), the [serve]
     phase's (``serve_*``) and the [stream], [fleet], [recover] and [load]
     phases' (``stream_*``, ``fleet_*``, ``recover_*``, ``load_*``) and
     the [train] phase's (``train_*``: the kernel replay's launches and
     leaves, and the phase's figures) and [examples]' seconds.

After ``[done]`` one ``[phases]`` line gives every phase's seconds, from
one ``PhaseClock`` that each phase of ``main`` starts in turn (the card and
the build through the profiles at the end). The last line is the
contract line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
This script imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
PAIRS = [(2.0, 0.5), (10.0, 1.0), (0.5, 0.1)]
SEED = 0
FORGET_CLASS = 3
# the second set of the coalesced drains in the [scanned] phase
OTHER_CLASS = 5
# rows of one gemm_fisher_int8 call in the [fisher kernels] phase: its int8
# operands carry one scale per column of each such block of N
Q8_GEMM_ROWS = 1024
# the card's L2: timed operand sets rotate through more than this
L2_BYTES = 50e6
# the [lm] phase: the arch served at full width, its sequence length (more
# than the 512-token window, within the unchunked attention path), the data
# vocabulary of make_lm_domains (every id valid in the model's table; the
# generator draws a dense span x span transition matrix per domain) and the
# two forget domains
LM_ARCH = "gemma3-1b"
# the [lm] phase's depth (None: all 26 blocks) and its expected
# (parameters, stored leaves, layer leaves, unlearn layers): two of the
# 26 blocks' local/global periods since the [train] phase, which this cut
# (114.8 -> 67.1 s), recurrentgemma-9b's 5 -> 3 and yi-6b's 8 -> 4 pay for
# (tools/train_phase.py --cuts; PERF.md section 6). Not cut to one period:
# [shard] runs on these weights, and is the card's only sharded run of a
# stack of more than one period. [stream] runs gemma3-1b with all 26
# blocks; [serve] with SERVE_BLOCKS
LM_BLOCKS = 12
LM_WANT = (624_062_592, 56, 110, 14)
LM_SEQ = 1024
LM_DATA_VOCAB = 512
LM_FORGET = 1
LM_OTHER = 2
# the dampen kernels' times before the grouped launch, printed beside this
# run's (ms, NVIDIA H100 80GB HBM3 at 700 W, from this script, PERF.md
# sections 5-6): the sweep of 56 per-leaf launches, device and stream time,
# and the largest leaf; and the rowscale kernel's at its largest leaf before
# it became a table of parts (one division per thread, a 64-bit row walk)
BEFORE_MS = {"source": "the per-leaf kernel, PERF.md sections 5-6",
             "dampen": {"sweep": 0.229, "stream": 1.23, "big": 0.01517,
                        "bf16": 0.01199},
             "dampen_int8": {"sweep": 0.199, "big": 0.01085},
             "dampen_int8_rowscale": {"big": 0.01413}}


def log(msg: str) -> None:
    print(msg, flush=True)


class PhaseClock:
    """Seconds per phase of ``main``: ``start(name)`` ends the phase that
    was running and starts ``name``, ``stop()`` ends the last one. Every
    second between the first ``start`` and ``stop`` is charged to exactly
    one phase; ``seconds`` holds them in the order the phases ran."""

    def __init__(self):
        self.seconds = {}
        self._name, self._t0 = None, None

    def start(self, name):
        now = time.perf_counter()
        if self._name is not None:
            self.seconds[self._name] = (self.seconds.get(self._name, 0.0)
                                        + now - self._t0)
        self._name, self._t0 = name, now

    def stop(self):
        self.start(None)


# the phase_seconds table every phase of main() writes into, printed as the
# [phases] line after [done]
PHASES = PhaseClock()


def peaks(name: str):
    """(memory bytes/s, f32 FLOP/s, int8 OP/s, TF32 FLOP/s) of the card
    ``name``, from the port's one table of peaks,
    ``repro_torch.launch.roofline.PEAKS`` (NVIDIA's data sheets, dense),
    which the dry run's roofline reads too. A kernel's bound is the larger
    of its bytes over the first and its operations over the rate of their
    type."""
    from repro_torch.launch.roofline import peaks as card_peaks
    r = card_peaks(name)
    return r["hbm"], r["f32"], r["int8"], r["tf32"]


def cuda_time_ms(fn, iters: int, *, queue_ahead: bool = False) -> float:
    """Mean time of one ``fn()`` over ``iters`` calls, from CUDA events
    around the run, after a warm-up.

    ``queue_ahead`` first parks the stream on a spin kernel that outlasts
    the host's enqueueing of all ``iters`` calls, so the events see only
    the device running them back to back (device time; keep ``iters``
    small enough for the launch queue). Without it the events also see the
    host's launch overhead wherever the host is the slower side (stream
    time, what the request itself experiences)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    if queue_ahead:
        # >= 2x the host time at SM clocks up to 2 GHz
        torch.cuda._sleep(int(host_s * 4e9) + 1_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profile_request(run):
    """Device busy time of one ``run()`` from torch.profiler: the sum of
    the CUDA kernels' self time, the number of device kernels, and every
    kernel by time, as (name, ms, count). The device activity alone:
    nothing here reads the host's operators, and recording them beside the
    kernels cost about 1 ms a kernel (a warm ViT request's 14,000 kernels:
    ~14 s of profiling, PERF.md section 6)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in evs) / 1e3
    ranked = sorted(evs, key=lambda e: -e.self_device_time_total)
    return busy, sum(e.count for e in evs), [
        (e.key, e.self_device_time_total / 1e3, e.count) for e in ranked]


def bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else
                  torch.int32 if t.element_size() == 4 else torch.uint8)


def check_kernel_against_plain(leaf_shapes, dev):
    """Phase 3: the CUDA kernel vs dampen_ref, bit for bit."""
    from repro_torch.kernels import dampen as kd

    gen = torch.Generator(device=dev).manual_seed(SEED)
    max_err = 0.0
    cases = 0

    def compare(theta, i_f, i_g, alpha, lam, what):
        nonlocal max_err, cases
        got, mask = kd.dampen_cuda(theta, i_f, i_g, alpha, lam)
        want, want_mask = kd.dampen_ref(theta, i_f, i_g, alpha, lam)
        torch.cuda.synchronize()
        if not torch.equal(bits(got), bits(want)) \
                or not torch.equal(mask, want_mask):
            raise AssertionError(f"dampen kernel != dampen_ref: {what}")
        fin = torch.isfinite(want)
        if fin.any():
            max_err = max(max_err, float((got.float() - want.float())[fin]
                                         .abs().max()))
        cases += 1

    def operands(n, dtype):
        th = torch.randn(n, generator=gen, device=dev).to(dtype)
        i_g = torch.rand(n, generator=gen, device=dev) + 1e-6
        i_f = torch.rand(n, generator=gen, device=dev) * 20 * i_g
        return th, i_f, i_g

    for shape in leaf_shapes:
        n = 1
        for s in shape:
            n *= s
        for dtype in (torch.float32, torch.bfloat16):
            for alpha, lam in PAIRS:
                th, i_f, i_g = operands(n, dtype)
                # ties: i_f == f32(alpha) * i_g exactly, never selected
                tie = torch.rand(n, generator=gen, device=dev) < 0.01
                i_f = torch.where(tie, alpha * i_g, i_f)
                compare(th.view(shape), i_f.view(shape), i_g.view(shape),
                        alpha, lam, f"{shape} {dtype} a={alpha} l={lam}")

    nan, inf = float("nan"), float("inf")
    special = torch.tensor([0.0, -0.0, nan, inf, -inf, 1.0, 2.0, 1e-30,
                            1e-38, 3.0], device=dev)
    for n in (1, 2, 3, 4, 5, 7, 33, 1023, 4097):
        for dtype in (torch.float32, torch.bfloat16):
            for alpha, lam in PAIRS + [(2.0, nan), (2.0, inf), (0.0, 1.0)]:
                th, i_f, i_g = operands(n + 1, dtype)
                pick = lambda: special[torch.randint(  # noqa: E731
                    0, len(special), (n + 1,), generator=gen, device=dev)]
                th = torch.where(torch.rand(n + 1, generator=gen, device=dev)
                                 < 0.3, pick().to(dtype), th)
                i_f = torch.where(torch.rand(n + 1, generator=gen, device=dev)
                                  < 0.3, pick(), i_f)
                i_g = torch.where(torch.rand(n + 1, generator=gen, device=dev)
                                  < 0.3, pick(), i_g)
                for lo in (0, 1):   # lo=1: pointers off the 16-byte grid
                    compare(th[lo:lo + n], i_f[lo:lo + n], i_g[lo:lo + n],
                            alpha, lam, f"edge n={n} {dtype} lo={lo} "
                            f"a={alpha} l={lam}")
    return cases, max_err


def check_int8_kernel_against_plain(leaf_shapes, dev):
    """Phase 3, int8: dampen_int8_cuda vs dampen_int8_ref, bit for bit."""
    from repro_torch.kernels import dampen as kd

    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    max_err = 0
    cases = 0

    def compare(theta_q, i_f, i_g, alpha, lam, what):
        nonlocal max_err, cases
        got, mask = kd.dampen_int8_cuda(theta_q, i_f, i_g, alpha, lam)
        want, want_mask = kd.dampen_int8_ref(theta_q, i_f, i_g, alpha, lam)
        torch.cuda.synchronize()
        if not torch.equal(got, want) or not torch.equal(mask, want_mask):
            raise AssertionError(f"dampen_int8 kernel != dampen_int8_ref: "
                                 f"{what}")
        if got.numel():
            max_err = max(max_err, int((got.int() - want.int()).abs().max()))
        cases += 1

    def operands(n):
        th = torch.randint(-128, 128, (n,), generator=gen, device=dev,
                           dtype=torch.int8)
        i_g = torch.rand(n, generator=gen, device=dev) + 1e-6
        i_f = torch.rand(n, generator=gen, device=dev) * 20 * i_g
        return th, i_f, i_g

    for shape in leaf_shapes:
        n = torch.Size(shape).numel()
        for alpha, lam in PAIRS:
            th, i_f, i_g = operands(n)
            tie = torch.rand(n, generator=gen, device=dev) < 0.01
            i_f = torch.where(tie, alpha * i_g, i_f)
            compare(th.view(shape), i_f.view(shape), i_g.view(shape), alpha,
                    lam, f"{shape} a={alpha} l={lam}")

    # every code at beta = 0.5 exactly (half-way products round to even),
    # and at a negative beta (saturation at +-127)
    codes = torch.arange(-128, 128, device=dev).to(torch.int8)
    ones = torch.ones(256, device=dev)
    compare(codes, ones, ones, 0.5, 0.5, "half-way codes")
    compare(codes, ones, -ones, 2.0, 10.0, "saturation")
    nan, inf = float("nan"), float("inf")
    special = torch.tensor([0.0, -0.0, nan, inf, -inf, 1.0, 2.0, 1e-30,
                            1e-38, 3.0], device=dev)
    for n in (1, 2, 3, 4, 5, 7, 33, 1023, 4097):
        for alpha, lam in PAIRS + [(2.0, nan), (2.0, inf), (0.0, 1.0),
                                   (0.5, 0.5)]:
            th, i_f, i_g = operands(n + 3)
            pick = lambda: special[torch.randint(  # noqa: E731
                0, len(special), (n + 3,), generator=gen, device=dev)]
            i_f = torch.where(torch.rand(n + 3, generator=gen, device=dev)
                              < 0.3, pick(), i_f)
            i_g = torch.where(torch.rand(n + 3, generator=gen, device=dev)
                              < 0.3, pick(), i_g)
            for lo in (0, 1, 3):   # lo > 0: pointers off the 4/16-byte grid
                compare(th[lo:lo + n], i_f[lo:lo + n], i_g[lo:lo + n],
                        alpha, lam, f"edge n={n} lo={lo} a={alpha} l={lam}")
    return cases, max_err


def check_group_kernels_against_plain(layer_shapes, dev, edges=True,
                                      whole=True, kinds=None):
    """Phase 3, grouped: dampen_group_cuda and dampen_int8_group_cuda (one
    launch per 64 leaves) against their plain versions, bit for bit, the
    selection count included, and the launch and leaf counters against the
    table: each layer's table and (``whole``) the whole tree, then
    (``edges``) tables past capacity and edge tables (empty leaves, n < 4,
    odd n, offset views off the 16-byte grid, in-place out, NaN/inf/1e-38
    entries, int8 ties and saturation). ``kinds`` (default all of "f32",
    "bf16", "int8") names the theta dtypes the tables are checked in.
    Returns the tables checked per kind and the largest |err| per
    kernel."""
    from repro_torch.kernels import dampen as kd

    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    nan, inf = float("nan"), float("inf")
    special = torch.tensor([0.0, -0.0, nan, inf, -inf, 1.0, 2.0, 1e-30,
                            1e-38, 3.0], device=dev)
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16,
              "int8": torch.int8}
    cases = dict.fromkeys(dtypes, 0)
    max_err = {"dampen": 0.0, "dampen_int8": 0}

    def compare(kind, thetas, i_fs, i_gs, alpha, lam, what, in_place=False):
        int8 = kind == "int8"
        cuda_fn = kd.dampen_int8_group_cuda if int8 else kd.dampen_group_cuda
        ref_fn = kd.dampen_int8_group_ref if int8 else kd.dampen_group_ref
        counters = lambda: ((kd.INT8_LAUNCHES, kd.INT8_LEAVES) if int8  # noqa: E731
                            else (kd.LAUNCHES, kd.LEAVES))
        want, want_m, want_n = ref_fn(thetas, i_fs, i_gs, alpha, lam)
        (l0, v0) = counters()
        got, got_m, got_n = cuda_fn(thetas, i_fs, i_gs, alpha, lam,
                                    outs=thetas if in_place else None)
        torch.cuda.synchronize()
        (l1, v1) = counters()
        # one launch per MAX_LEAVES leaves that hold an element
        launches = sum(any(t.numel() for t in thetas[i:i + kd.MAX_LEAVES])
                       for i in range(0, len(thetas), kd.MAX_LEAVES))
        if (l1 - l0, v1 - v0) != (launches, len(thetas) if launches else 0):
            raise AssertionError(f"grouped {kind} {what}: {l1 - l0} launches "
                                 f"over {v1 - v0} leaves, expected "
                                 f"{launches} over {len(thetas)}")
        if int(got_n) != int(want_n):
            raise AssertionError(f"grouped {kind} {what}: count "
                                 f"{int(got_n)} != plain {int(want_n)}")
        key = "dampen_int8" if int8 else "dampen"
        for i, (g, w, gm, wm) in enumerate(zip(got, want, got_m, want_m)):
            if not torch.equal(bits(g), bits(w)) or not torch.equal(gm, wm) \
                    or (in_place and g.data_ptr() != thetas[i].data_ptr()):
                raise AssertionError(f"grouped {kind} kernel != plain: "
                                     f"{what}, leaf {i} {tuple(g.shape)}")
            # in f32, not f64: the tables reach 1.05 B-element leaves; the
            # bits are equal here, so every finite difference is 0 either way
            d = (g.float() - w.float()).abs()
            d = d[torch.isfinite(d)]
            if d.numel():
                max_err[key] = max(max_err[key], type(max_err[key])(d.max()))
        cases[kind] += 1

    def operands(n, kind, extra=0):
        if kind == "int8":
            th = torch.randint(-128, 128, (n + extra,), generator=gen,
                               device=dev, dtype=torch.int8)
        else:
            th = torch.randn(n + extra, generator=gen, device=dev).to(
                dtypes[kind])
        i_g = torch.rand(n + extra, generator=gen, device=dev) + 1e-6
        i_f = torch.rand(n + extra, generator=gen, device=dev) * 20 * i_g
        return th, i_f, i_g

    def table(shapes, kind, alpha):
        out = ([], [], [])
        for shape in shapes:
            n = torch.Size(shape).numel()
            th, i_f, i_g = operands(n, kind)
            # ties: i_f == f32(alpha) * i_g exactly, never selected
            tie = torch.rand(n, generator=gen, device=dev) < 0.01
            i_f = torch.where(tie, alpha * i_g, i_f)
            for acc, t in zip(out, (th, i_f, i_g)):
                acc.append(t.view(shape))
        return out

    every = [s for shapes in layer_shapes for s in shapes]
    for kind in kinds or dtypes:
        for alpha, lam in PAIRS:
            for j, shapes in enumerate(layer_shapes):
                compare(kind, *table(shapes, kind, alpha), alpha, lam,
                        f"layer {j} a={alpha} l={lam}")
            if whole:
                compare(kind, *table(every, kind, alpha), alpha, lam,
                        f"all {len(every)} leaves a={alpha} l={lam}")
        if not edges:
            continue
        # past capacity: the tree twice (2 launches), and 150 small leaves
        # of 0..99 elements (3 launches)
        compare(kind, *table(every + every, kind, 10.0), 10.0, 1.0,
                f"{2 * len(every)} leaves")
        small = [(int(n),) for n in torch.randint(
            0, 100, (150,), generator=gen, device=dev)]
        compare(kind, *table(small, kind, 2.0), 2.0, 0.5, "150 small leaves")
    if not edges:
        return cases, max_err

    # edge tables: every leaf an offset view (lo > 0: off the 4/16-byte
    # grid), empty leaves among them, special values, every pair and the
    # odd ones; in place and not
    edge_n = (0, 1, 2, 3, 4, 5, 7, 0, 33, 1023, 4097, 64)
    codes = torch.arange(-128, 128, device=dev).to(torch.int8)
    ones = torch.ones(256, device=dev)
    for kind in dtypes:
        los = (0, 1, 3) if kind == "int8" else (0, 1)
        for alpha, lam in PAIRS + [(2.0, nan), (2.0, inf), (0.0, 1.0),
                                   (0.5, 0.5), (2.0, 10.0)]:
            for in_place in (False, True):
                ths, i_fs, i_gs = [], [], []
                for i, n in enumerate(edge_n):
                    lo = los[i % len(los)]
                    th, i_f, i_g = operands(n, kind, extra=lo)
                    pick = lambda: special[torch.randint(  # noqa: E731
                        0, len(special), (n + lo,), generator=gen,
                        device=dev)]
                    hit = lambda: torch.rand(  # noqa: E731
                        n + lo, generator=gen, device=dev) < 0.3
                    if kind != "int8":
                        th = torch.where(hit(), pick().to(th.dtype), th)
                    i_f = torch.where(hit(), pick(), i_f)
                    i_g = torch.where(hit(), pick(), i_g)
                    ths.append(th[lo:])
                    i_fs.append(i_f[lo:])
                    i_gs.append(i_g[lo:])
                if kind == "int8":
                    # every code at beta = 0.5 (half-way products round to
                    # even) and at beta = -10 (saturation at +-127)
                    ths += [codes.clone(), codes.clone()]
                    i_fs += [ones, ones]
                    i_gs += [ones, -ones]
                compare(kind, ths, i_fs, i_gs, alpha, lam,
                        f"edge table a={alpha} l={lam} in_place={in_place}",
                        in_place=in_place)

    # a table that the wrapper converts before it launches, as the
    # reference converts its operands: non-contiguous thetas and Fisher
    # operands, the Fisher in f64 and bf16
    for kind in dtypes:
        ths, i_fs, i_gs = table([(64, 33), (7, 5), (130, 1)], kind, 2.0)
        compare(kind, [t.t() for t in ths], [f.t().double() for f in i_fs],
                [g.t().to(torch.bfloat16) for g in i_gs], 2.0, 0.5,
                "converted table")
    # refused before any launch: a leaf off the card, an out that the
    # kernel cannot write
    th, i_f, i_g = operands(64, "f32")
    sq = lambda t: t.view(8, 8)  # noqa: E731
    before = (kd.LAUNCHES, kd.LEAVES)
    for what, bad in (
            ("a leaf on the CPU", ([th, th.cpu()], [i_f, i_f], [i_g, i_g],
                                   None)),
            ("a non-contiguous out", ([sq(th)], [sq(i_f)], [sq(i_g)],
                                      [sq(th).t()]))):
        try:
            kd.dampen_group_cuda(*bad[:3], 2.0, 0.5, outs=bad[3])
        except ValueError:
            continue
        raise AssertionError(f"grouped f32: a table with {what} was not "
                             f"refused")
    if (kd.LAUNCHES, kd.LEAVES) != before:
        raise AssertionError("grouped f32: a refused table launched")
    return cases, max_err


def gemm_close(got, want, rtol=1e-4):
    """gemm_fisher's tolerance for signed sums: relative L2 <= rtol / 10
    and |d| <= rtol |ref| + rtol max|ref| elementwise (entries that cancel
    to near zero defeat a pure rtol). Returns the relative L2."""
    d = got.double() - want.double()
    w = want.double()
    rel = float(d.norm() / w.norm()) if float(w.norm()) else float(d.norm())
    ok = rel <= rtol / 10 and bool(
        (d.abs() <= rtol * w.abs() + rtol * w.abs().max()).all())
    return rel, ok


def check_fisher_kernels_against_plain(dev):
    """Phase 3, the four kernels reached through ``kernels.ops``: each
    ``*_cuda`` wrapper against its plain version at odd shapes, misaligned
    pointers, special values and extreme codes."""
    from repro_torch.kernels import dampen as kd
    from repro_torch.kernels import fimd as kf
    from repro_torch.kernels import gemm_fisher as kg
    from repro_torch.kernels import gemm_fisher_int8 as kg8

    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    cases = {"fimd": 0, "gemm_fisher": 0, "gemm_fisher S>1, ragged": 0,
             "gemm_fisher_int8": 0, "gemm_fisher_int8 S>1, ragged": 0,
             "dampen_int8_rowscale": 0, "dampen_int8_rowscale in parts": 0,
             "dampen_int8_rowscale > 2^31 elements": 0}
    nan, inf = float("nan"), float("inf")
    special = torch.tensor([0.0, -0.0, nan, inf, -inf, 1.0, 2.0, 1e-30,
                            1e-38, 3.0], device=dev)

    def pick(n):
        return special[torch.randint(0, len(special), (n,), generator=gen,
                                     device=dev)]

    # fimd: f32/bf16, P odd or even, offsets off the 16-byte grid, B = 1..33,
    # some NaN/inf gradients (NaN where the plain version has NaN)
    for B, P in ((1, 1), (3, 5), (8, 1023), (8, 4096), (33, 130), (1, 8192)):
        for dtype in (torch.float32, torch.bfloat16):
            for lo in (0, 1):
                buf = torch.randn(B * P + lo, generator=gen, device=dev)
                if P > 100:
                    buf = torch.where(torch.rand(B * P + lo, generator=gen,
                                                 device=dev) < 0.001,
                                      pick(B * P + lo), buf)
                g = buf.to(dtype)[lo:].view(B, P)
                got, want = kf.fimd_cuda(g), kf.fimd_ref(g)
                torch.cuda.synchronize()
                torch.testing.assert_close(got, want, rtol=1e-5, atol=0,
                                           equal_nan=True)
                cases["fimd"] += 1

    # gemm_fisher: M, K off the 64-wide tile, N off the 32-row slab, one
    # empty reduction, and reductions split over N (S > 1) with a ragged
    # last slice, on the 16-byte cp.async path and (lo = 1: pointers off
    # the 16-byte grid) the element path; f32 and bf16. Every case runs
    # twice and must give the same bits.
    for N, M, K, lo in ((1, 1, 1, 0), (17, 5, 3, 0), (0, 7, 9, 0),
                        (100, 65, 130, 0), (129, 200, 64, 0),
                        (2049, 70, 33, 0), (5000, 96, 40, 0),
                        (5000, 96, 40, 1), (8192, 576, 64, 0)):
        S, rows = kg.split_plan(N, M, K)
        for dtype in (torch.float32, torch.bfloat16):
            a = torch.randn(N * M + lo, generator=gen, device=dev).to(
                dtype)[lo:].view(N, M)
            g = torch.randn(N * K + lo, generator=gen, device=dev).to(
                dtype)[lo:].view(N, K)
            dw, fish = kg.gemm_fisher_cuda(a, g)
            dw2, fish2 = kg.gemm_fisher_cuda(a, g)
            dwr, _ = kg.gemm_fisher_ref(a, g)
            torch.cuda.synchronize()
            rel, ok = gemm_close(dw, dwr) if N else (0.0, torch.equal(dw, dwr))
            if not ok or not torch.equal(bits(fish), bits(dw * dw)):
                raise AssertionError(f"gemm_fisher kernel != plain at "
                                     f"{(N, M, K)} lo={lo} {dtype} S={S}: "
                                     f"rel L2 {rel}")
            if not (torch.equal(bits(dw), bits(dw2))
                    and torch.equal(bits(fish), bits(fish2))):
                raise AssertionError(f"gemm_fisher kernel at {(N, M, K)} "
                                     f"{dtype} S={S}: two runs differ")
            cases["gemm_fisher"] += 1
            cases["gemm_fisher S>1, ragged"] += S > 1 and N % rows != 0

    # gemm_fisher_int8: every code including -128, extreme codes over a long
    # reduction, odd shapes, scales with zeros and infinities, reductions
    # split over N with a ragged last slice (lo = 3: the byte path), and
    # N = MAX_N with every code -128 (every sum at the int32 limit,
    # 128^2 MAX_N = 2,147,467,264): bit for bit
    for N, M, K, lo in ((1, 1, 1, 0), (3, 5, 7, 0), (33, 65, 129, 0),
                        (8192, 70, 9, 0), (0, 4, 4, 0), (3000, 48, 80, 0),
                        (3000, 48, 80, 3), (kg8.MAX_N, 64, 64, 0)):
        S, rows = kg.split_plan(N, M, K, kg8.SLAB)
        a = torch.randint(-128, 128, (N * M + lo,), generator=gen, device=dev,
                          dtype=torch.int8)[lo:].view(N, M)
        g = torch.randint(-128, 128, (N * K + lo,), generator=gen, device=dev,
                          dtype=torch.int8)[lo:].view(N, K)
        if N == 8192:
            a[:, :3] = torch.tensor([127, -128, -127], device=dev,
                                    dtype=torch.int8)
            g[:, :2] = torch.tensor([127, -128], device=dev, dtype=torch.int8)
        sa = torch.rand(M, generator=gen, device=dev)
        sg = torch.rand(K, generator=gen, device=dev)
        sa[0] = 0.0 if M > 1 else sa[0]
        sg[-1] = inf if K > 2 else sg[-1]
        if N == kg8.MAX_N:
            a.fill_(-128)
            g.fill_(-128)
            sa[0] = 1.0
            sg[0] = 1.0
        dw, fish = kg8.gemm_fisher_int8_cuda(a, g, sa, sg)
        dwr, fishr = kg8.gemm_fisher_int8_ref(a, g, sa, sg)
        torch.cuda.synchronize()
        if not (torch.equal(bits(dw), bits(dwr))
                and torch.equal(bits(fish), bits(fishr))):
            raise AssertionError(f"gemm_fisher_int8 kernel != plain at "
                                 f"{(N, M, K)} lo={lo} S={S}")
        if N == kg8.MAX_N and float(dw[0, 0]) != float(128 * 128 * N):
            raise AssertionError(f"gemm_fisher_int8 at the int32 limit: "
                                 f"{float(dw[0, 0])} != {128 * 128 * N}")
        cases["gemm_fisher_int8"] += 1
        cases["gemm_fisher_int8 S>1, ragged"] += S > 1 and N % rows != 0
    for key, want in (("gemm_fisher S>1, ragged", 8),
                      ("gemm_fisher_int8 S>1, ragged", 3)):
        if cases[key] < want:
            raise AssertionError(f"{key}: {cases[key]} cases, expected "
                                 f">= {want}")

    # dampen_int8_rowscale: dampen_int8's edge cases on the dequantised
    # Fisher — zero/NaN/inf/subnormal i_fq, fs and i_g, lambda = NaN/inf,
    # alpha = 0, rows of odd length C = 1..4097, pointers off the 4/16-byte
    # grid — and the shapes that the kernel's decomposition (1024 elements
    # of a part per block, a quad's row from a multiplier) treats apart:
    # C = 1, 2, 3, 5 over three blocks and more (every quad crosses a row
    # end), C = 1023, 1024, 1025 and 300 (rows end inside a block), partial
    # last blocks; each also cut into parts of at most 3000 elements (whole
    # rows, or pieces of a row: the plan of a leaf of 2^31 elements or more,
    # at a small size). Then one leaf of more than 2^31 elements of each
    # kind: many rows per part, and one row longer than a part.
    for R, C in ((1, 1), (1, 4097), (3, 1), (3, 5), (2, 7), (5, 33),
                 (4, 1023), (7, 4), (3500, 1), (1800, 2), (1200, 3),
                 (721, 5), (5, 1023), (5, 1024), (5, 1025), (7, 300),
                 (3, 1000)):
        n = R * C
        for alpha, lam in PAIRS + [(2.0, nan), (2.0, inf), (0.0, 1.0),
                                   (0.5, 0.5)]:
            th = torch.randint(-128, 128, (n + 3,), generator=gen,
                               device=dev, dtype=torch.int8)
            i_fq = torch.randint(0, 128, (n + 3,), generator=gen,
                                 device=dev).float()
            i_fq = torch.where(torch.rand(n + 3, generator=gen, device=dev)
                               < 0.3, pick(n + 3), i_fq)
            fs = torch.rand(R + 3, generator=gen, device=dev) * 0.05
            fs = torch.where(torch.rand(R + 3, generator=gen, device=dev)
                             < 0.3, pick(R + 3), fs)
            i_g = torch.rand(n + 3, generator=gen, device=dev)
            i_g = torch.where(torch.rand(n + 3, generator=gen, device=dev)
                              < 0.3, pick(n + 3), i_g)
            for lo in (0, 1, 3):   # lo > 0: pointers off the 4/16-byte grid
                args = (th[lo:lo + n].view(R, C), i_fq[lo:lo + n].view(R, C),
                        fs[lo:lo + R], i_g[lo:lo + n].view(R, C), alpha, lam)
                want = kd.dampen_int8_rowscale_ref(*args)
                for limit in ((kd.PART_LIMIT, 3000) if n > 3000
                              else (kd.PART_LIMIT,)):
                    with part_limit(kd, limit):
                        got = kd.dampen_int8_rowscale_cuda(*args)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        raise AssertionError(
                            f"dampen_int8_rowscale kernel != plain at "
                            f"{(R, C)} lo={lo} a={alpha} l={lam} part limit "
                            f"{limit}")
                    cases["dampen_int8_rowscale"] += 1
                    cases["dampen_int8_rowscale in parts"] += (
                        limit < kd.PART_LIMIT)
    for R, C in ((524_289, 4096), (1, 2 ** 31 + 5)):
        check_huge_rowscale(kd, R, C, gen, dev)
        cases["dampen_int8_rowscale > 2^31 elements"] += 1
    return cases


@contextlib.contextmanager
def part_limit(kd, limit):
    """The rowscale wrapper cuts leaves into parts of at most ``limit``
    elements (kernels/dampen.py::PART_LIMIT, 2^31 - 1): the plan of a leaf
    of 2^31 elements or more, at a small size."""
    was, kd.PART_LIMIT = kd.PART_LIMIT, limit
    try:
        yield
    finally:
        kd.PART_LIMIT = was


def check_huge_rowscale(kd, R, C, gen, dev):
    """The rowscale kernel on one leaf [R, C] of 2^31 elements or more (21.5
    GB of operands), cut by the host into parts of fewer and launched once,
    against its plain version a slab at a time: bit for bit."""
    parts = kd.rowscale_parts(R, C)
    th = torch.randint(-128, 128, (R, C), generator=gen, device=dev,
                       dtype=torch.int8)
    i_fq = torch.randint(0, 128, (R, C), generator=gen, device=dev,
                         dtype=torch.uint8).float()
    fs = torch.rand(R, generator=gen, device=dev) * 0.05
    i_g = torch.rand((R, C), generator=gen, device=dev)
    launches = kd.ROWSCALE_LAUNCHES
    got = kd.dampen_int8_rowscale_cuda(th, i_fq, fs, i_g, 0.5, 0.5)
    torch.cuda.synchronize()
    launches = kd.ROWSCALE_LAUNCHES - launches
    if launches != 1:
        raise AssertionError(f"dampen_int8_rowscale on {(R, C)}: {launches} "
                             f"launches, expected 1")
    step = 1 << 27          # elements per slab of the plain version
    if R > 1:
        rows = max(1, step // C)
        slabs = [(slice(r, r + rows), slice(None)) for r in range(0, R, rows)]
    else:
        slabs = [(slice(None), slice(c, c + step)) for c in range(0, C, step)]
    edited = 0
    for rs, cs in slabs:
        want = kd.dampen_int8_rowscale_ref(th[rs, cs], i_fq[rs, cs], fs[rs],
                                           i_g[rs, cs], 0.5, 0.5)
        if not torch.equal(got[rs, cs], want):
            raise AssertionError(f"dampen_int8_rowscale kernel != plain on "
                                 f"the leaf {(R, C)} at rows {rs}, columns "
                                 f"{cs}")
        edited += int((want != th[rs, cs]).sum())
    log(f"[kernel] dampen_int8_rowscale on [{R}, {C}] ({R * C} elements, "
        f"{len(parts)} parts of {[n for _, _, n, _ in parts]} elements, "
        f"1 launch): bit-identical to plain, {edited} codes edited")
    del th, i_fq, fs, i_g, got
    torch.cuda.empty_cache()


def sweep_operands(adapter, params, fx, fy, cs, dev):
    """Per layer of an ssd sweep over the forget batch (back to front, as
    the engine walks it, on the original weights): the layer's params, its
    forward, the chunked cached inputs and output cotangents, the Fisher of
    ``grad_fisher_chunks`` and each chunk's autograd gradients (leaves in
    ``tree_leaves`` order)."""
    from repro_torch.core.cau import _chunk, _logit_cotangents
    from repro_torch.engine.fused import grad_fisher_chunks
    from repro_torch.models.module import tree_leaves, tree_unflatten

    xs = torch.as_tensor(fx, device=dev)
    ys = torch.as_tensor(fy, device=dev)
    with torch.no_grad():
        logits, acts = adapter.forward_collect(params, xs)
    cot = _logit_cotangents(adapter.loss, _chunk(logits, cs), _chunk(ys, cs))
    layers = {}
    for j in range(adapter.n_layers - 1, -1, -1):
        lp = adapter.get_layer(params, j)
        apply = lambda p, a, _j=j: adapter.apply_layer(None, _j, p, a)  # noqa: E731
        acts_c = _chunk(acts[j], cs)
        fish, g_acts = grad_fisher_chunks(apply, lp, acts_c, cot,
                                          with_act_grad=j > 0)
        grads = []
        with torch.enable_grad():
            for i in range(acts_c.shape[0]):
                leaves = [t.detach().requires_grad_(True)
                          for t in tree_leaves(lp)]
                a = acts_c[i].detach().requires_grad_(j > 0)
                out = apply(tree_unflatten(lp, leaves), a)
                grads.append(torch.autograd.grad(
                    out, leaves + ([a] if j > 0 else []),
                    grad_outputs=cot[i])[:len(leaves)])
        layers[j] = {"params": lp, "apply": apply, "acts": acts_c,
                     "cot": cot, "fisher": tree_leaves(fish),
                     "fisher_tree": fish, "grads": grads}
        cot = g_acts
    return layers


@contextlib.contextmanager
def conv_tape(V):
    """While open, record every ``V.conv2d`` the model runs as (weight,
    input, stride, output), with the output's gradient retained."""
    tape = []
    conv = V.conv2d

    def taped(w, x, stride=1):
        out = conv(w, x, stride)
        if out.requires_grad:
            out.retain_grad()
        tape.append((w, x, stride, out))
        return out

    V.conv2d = taped
    try:
        yield tape
    finally:
        V.conv2d = conv


def conv_operands(x, gy, kernel, stride):
    """A convolution's weight gradient as one ``gemm_fisher`` GEMM.

    ``x`` [B, cin, H, W] is the conv's input, ``gy`` [B, cout, Ho, Wo] the
    cotangent of its output, ``kernel`` (kh, kw), and the padding is the
    model's "SAME" rule (``models.vision.same_padding``: a stride-2 3x3
    conv pads (0, 1)). Returns A [B*Ho*Wo, cin*kh*kw] (im2col) and
    G [B*Ho*Wo, cout]; A^T G is the gradient as [cin*kh*kw, cout]."""
    import torch.nn.functional as F
    from repro_torch.models.vision import same_padding

    kh, kw = kernel
    ph = same_padding(x.shape[2], kh, stride)
    pw = same_padding(x.shape[3], kw, stride)
    cols = F.unfold(F.pad(x, (pw[0], pw[1], ph[0], ph[1])), (kh, kw),
                    stride=stride)                    # [B, cin*kh*kw, L]
    a = cols.transpose(1, 2).reshape(-1, cols.shape[1])
    g = gy.permute(0, 2, 3, 1).reshape(-1, gy.shape[1])
    return a, g


def oihw(dw, weight_shape):
    """A conv weight gradient [cin*kh*kw, cout] in the weight's OIHW
    layout."""
    return dw.t().reshape(tuple(weight_shape))


def conv_gemm_operands(layer, name, V):
    """Per chunk, the GEMM operands of conv ``name`` of a basic block and
    its autograd weight gradient: the conv's own input (im2col, the model's
    "SAME" padding) and the cotangent of its output, recorded by running
    the block's forward under ``conv_tape``."""
    per_chunk = []
    with conv_tape(V) as tape:
        for i in range(layer["acts"].shape[0]):
            tape.clear()
            with torch.enable_grad():
                w = layer["params"][name].detach().requires_grad_(True)
                out = layer["apply"](dict(layer["params"], **{name: w}),
                                     layer["acts"][i])
                out.backward(layer["cot"][i])
            (x, stride, y), = [(x, s, y) for ww, x, s, y in tape if ww is w]
            a, g = conv_operands(x.detach(), y.grad, w.shape[2:], stride)
            per_chunk.append((a, g, w.grad, stride))
    return per_chunk


def q8_gemm_operands(a, g):
    """The int8 operands of one ``gemm_fisher_int8`` call on A [N, M] and
    G [N, K], each quantised per column: (a_q, g_q, sa, sg)."""
    (aq, sa), (gq, sg) = q8_columns(a), q8_columns(g)
    return aq, gq, sa, sg


def q8_columns(x):
    """Per-column int8 codes of a GEMM operand [N, C]: the port's q8 rule
    (``q8_quantize``, max-abs times f32(1/127), clamped to Q8_MIN_SCALE,
    round half to even) applied to the transposed operand, whose rows are
    the columns. Returns (codes [N, C] int8, scales [C] f32)."""
    from repro_torch.optim.compression import q8_quantize
    q, s = q8_quantize(x.t())
    return q.t().contiguous(), s[:, 0].contiguous()


def on_q8_grid(new, pristine):
    """True when every leaf of ``new`` is f32(code * scale) with integer
    codes in +-127 on the scale table of the pristine leaf."""
    from repro_torch.optim.compression import q8_scales
    for k, p in pristine.items():
        s = q8_scales(p)
        q = torch.round(new[k] / s)
        if q.abs().max() > 127 or not torch.equal(q * s, new[k]):
            return False
    return True


def layer_rel_l2(adapter, p8, p32, piece=1 << 26):
    """Per layer, ||p8 - p32|| / ||p32|| over the layer's leaves, summed in
    f64 over pieces of ``piece`` elements (a 1.05 B-element leaf in f64
    would take 8.4 GB beside a full card). ``p32`` may lie on the host:
    its pieces go to ``p8``'s device one at a time."""
    from repro_torch.models.module import tree_leaves
    out = []
    for j in range(adapter.n_layers):
        d = n = 0.0
        for x, y in zip(tree_leaves(adapter.get_layer(p8, j)),
                        tree_leaves(adapter.get_layer(p32, j))):
            for xs, ys in zip(x.reshape(-1).split(piece),
                              y.reshape(-1).split(piece)):
                ys = ys.to(xs.device)
                d += float(((xs.double() - ys.double()) ** 2).sum())
                n += float((ys.double() ** 2).sum())
        out.append((d / n) ** 0.5)
    return out


def nvml_busy(run, period_s=0.02):
    """The card's busy share while ``run()`` runs, from NVML: the mean of
    ``nvmlDeviceGetUtilizationRates().gpu`` (the share of NVML's last
    sample period in which a kernel ran) read every ``period_s`` on a
    thread. A cheap stand-in for ``profile_request`` where a request makes
    a million kernels; ``[recurrent]`` reads both on recurrentgemma to set
    one beside the other. Returns (share, samples)."""
    import ctypes
    import threading

    class Util(ctypes.Structure):
        _fields_ = [("gpu", ctypes.c_uint), ("memory", ctypes.c_uint)]

    nvml = ctypes.CDLL("libnvidia-ml.so.1")
    handle = ctypes.c_void_p()
    if nvml.nvmlInit_v2() != 0 or nvml.nvmlDeviceGetHandleByIndex_v2(
            ctypes.c_uint(0), ctypes.byref(handle)) != 0:
        raise RuntimeError("NVML did not open card 0")
    samples, stop = [], threading.Event()

    def sample():
        util = Util()
        while not stop.is_set():
            if nvml.nvmlDeviceGetUtilizationRates(handle,
                                                  ctypes.byref(util)) == 0:
                samples.append(util.gpu)
            time.sleep(period_s)

    thread = threading.Thread(target=sample)
    torch.cuda.synchronize()
    thread.start()
    try:
        run()
        torch.cuda.synchronize()
    finally:
        stop.set()
        thread.join(timeout=10)
        nvml.nvmlShutdown()
    if thread.is_alive() or not samples:
        raise RuntimeError(f"NVML sampling: {len(samples)} samples")
    return sum(samples) / len(samples) / 100.0, len(samples)


def guard_syncs(unl, calls):
    """Wrap each cached sweep program of ``unl``'s session so that its call
    runs under torch.cuda.set_sync_debug_mode("error"), counting the calls
    in ``calls[0]``."""
    progs = unl.session.programs._progs
    for key, prog in list(progs.items()):
        if key[1] != "sweep" or getattr(prog, "guarded", False):
            continue

        def guarded(*args, _prog=prog):
            calls[0] += 1
            torch.cuda.set_sync_debug_mode("error")
            try:
                return _prog(*args)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        guarded.guarded = True
        progs[key] = guarded


def pretrain(params, forward, x, y, steps, batch, dev):
    """A few hundred steps of the port's AdamW (``repro_torch.optim``, as
    torch's AdamW defaults set it: a constant lr 1e-3, betas 0.9 / 0.999,
    weight decay 1e-4, no clip) of ``forward(params, images) -> logits`` on
    the synthetic classes, so the forget class is learnt and the
    checkpoints have something to halt on."""
    from repro_torch.models import vision as V
    from repro_torch.optim import AdamWConfig, init_adamw, make_train_step

    cfg = AdamWConfig(lr=1e-3, b2=0.999, weight_decay=1e-4,
                      clip_norm=float("inf"), warmup_steps=0,
                      total_steps=steps, min_lr_frac=1.0)
    step = make_train_step(
        lambda p, b: V.cls_loss(forward(p, b[0]), b[1]), cfg)
    opt = init_adamw(cfg, params)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    for _ in range(steps):
        idx = torch.randint(0, x.shape[0], (batch,), generator=gen, device=dev)
        params, opt, loss = step(params, opt, (x[idx], y[idx]))
    return params, float(loss)


def lm_tables(adapter, params, fisher, gen, dev):
    """One ssd request's dampen tables, back to front, one per layer: the
    layer's leaves, a forget Fisher drawn around the global one, and the
    global Fisher's leaves."""
    from repro_torch.models.module import tree_leaves
    tables = []
    for j in range(adapter.n_layers - 1, -1, -1):
        i_gs = tree_leaves(adapter.get_layer(fisher, j))
        tables.append((tree_leaves(adapter.get_layer(params, j)),
                       [torch.rand(g.shape, generator=gen, device=dev) * 20 * g
                        for g in i_gs], i_gs))
    return tables


def lm_on_q8_grid(adapter, new, pristine, stopped):
    """True when every layer of the int8 deployment ``new`` lies on the grid
    the reference gives it: a layer the sweep reached on the per-row scale
    table of its own pristine leaves (the edit codes' grouping), a layer it
    did not reach exactly as the whole-tree fake quantisation left it (one
    scale per period on a stacked leaf)."""
    from repro_torch.models.module import tree_leaves
    from repro_torch.optim.compression import q8_fakequant_tree, q8_scales
    fq = None
    L = adapter.n_layers
    for j in range(L):
        got = tree_leaves(adapter.get_layer(new, j))
        if L - j > stopped:
            if fq is None:
                fq = q8_fakequant_tree(pristine)
            want = tree_leaves(adapter.get_layer(fq, j))
            if not all(torch.equal(bits(a), bits(b))
                       for a, b in zip(got, want)):
                return False
            continue
        for a, p in zip(got, tree_leaves(adapter.get_layer(pristine, j))):
            s = q8_scales(p)
            q = torch.round(a.float() / s)
            if q.abs().max() > 127 or not torch.equal(
                    bits((q * s).to(a.dtype)), bits(a)):
                return False
    return True


def lm_phase(dev, rate, zero_counts, dampen_counts, fisher_counts,
             keep=None):
    """Phase 9, [lm]: the dense decoder LM at full width (module docstring).
    Returns the figures the kernels line carries; ``keep`` (a dict) gets
    the phase's config, adapter, weights, Fisher, request and ssd spec, for
    [shard]."""
    from repro_torch import bridge
    from repro_torch.api import ForgetRequest, QuantSpec, Unlearner, UnlearnSpec
    from repro_torch.configs import get as get_arch
    from repro_torch.core import adapters
    from repro_torch.core.schedule import checkpoint_set
    from repro_torch.data import synthetic as syn
    from repro_torch.engine import plan_scanned_sweep
    from repro_torch.kernels import dampen as kd
    from repro_torch.models import lm as LM
    from repro_torch.models.module import tree_leaves
    from repro_torch.optim.compression import INT8_SWEEP_RTOL, q8_quantize

    t_phase = time.perf_counter()
    gib = 2.0 ** 30
    torch.cuda.reset_peak_memory_stats()
    full = get_arch(LM_ARCH).full
    cfg = full if LM_BLOCKS is None else full.with_(n_layers=LM_BLOCKS)
    t0 = time.perf_counter()
    params = LM.init_lm(torch.Generator(device=dev).manual_seed(SEED), cfg,
                        device="cuda")
    adapter = adapters.lm_adapter(cfg, LM_SEQ, device="cuda")
    torch.cuda.synchronize()
    L = adapter.n_layers
    stored = bridge.paths(params)
    n_params = sum(t.numel() for t in stored.values())
    n_bytes = sum(t.numel() * t.element_size() for t in stored.values())
    layer_leaves = [len(tree_leaves(adapter.get_layer(params, j)))
                    for j in range(L)]
    n_leaves = sum(layer_leaves)
    depth = ("FULL" if LM_BLOCKS is None else
             f"at full width and {LM_BLOCKS} of {full.n_layers} blocks")
    log(f"[lm] {cfg.name} {depth} ({cfg.n_layers} blocks "
        f"{cfg.block_pattern}, "
        f"d_model {cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} KV of "
        f"{cfg.dh}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, window {cfg.window}, "
        f"tied, {cfg.param_dtype}) from torch.Generator('cuda') seed {SEED} "
        f"in {time.perf_counter() - t0:.1f} s: {n_params} parameters, "
        f"{n_bytes} bytes in {len(stored)} stored leaves; {n_leaves} layer "
        f"leaves in {L} unlearn layers")
    if (n_params, len(stored), n_leaves, L) != LM_WANT:
        raise AssertionError(f"{cfg.name}: {n_params} parameters, "
                             f"{len(stored)} stored leaves, {n_leaves} layer "
                             f"leaves, {L} layers; expected {LM_WANT}")
    t0 = time.perf_counter()
    toks, doms = syn.make_lm_domains(syn.LMDataConfig(
        vocab=LM_DATA_VOCAB, n_domains=4, seq_len=LM_SEQ, n_per_domain=8,
        seed=SEED))
    splits = {d: syn.lm_split_forget_retain(toks, doms, d)
              for d in (LM_FORGET, LM_OTHER)}

    def request(seqs, tag):
        """Sequences [N, S + 1] as a request of their first S tokens,
        labelled with the model's own argmax (accuracy 1.0 before an
        edit)."""
        inputs = torch.as_tensor(seqs[:, :-1], device=dev).long().contiguous()
        with torch.no_grad():
            labels = LM.forward(params, cfg, inputs)[0].argmax(-1)
        return ForgetRequest(inputs, labels, tag=tag)

    req = request(splits[LM_FORGET]["forget"][:8], LM_FORGET)
    req2 = request(splits[LM_OTHER]["forget"][:8], LM_OTHER)
    retain = request(splits[LM_FORGET]["retain"][:4], "retain")
    log(f"[lm] make_lm_domains (vocab {LM_DATA_VOCAB}, 4 domains x 8, "
        f"S = {LM_SEQ}) and the argmax labels of two 8-sequence forget "
        f"requests (domains {LM_FORGET}, {LM_OTHER}) in "
        f"{time.perf_counter() - t0:.1f} s")

    # alpha 25 (the paper's full-size ViT setting), lambda 1, checkpoints
    # every 4 layers, chunk 2. The retain Fisher takes the model's argmax
    # labels too: with the next tokens as labels, a random model's retain
    # gradients are incoherent, I_g is far below I_f, and 80% of the entries
    # were selected at alpha 5 (measured on an H100): the int8 and fp32
    # paths then differ by 0.18 per layer, outside INT8_SWEEP_RTOL
    def spec(mode, **kw):
        return UnlearnSpec.for_mode(mode, **{
            "alpha": 25.0, "lam": 1.0, "tau": -1.0, "checkpoint_every": 4,
            "chunk_size": 2, "use_kernel": True, **kw})

    lssd = Unlearner(adapter, spec=spec("ssd"), device="cuda")
    t0 = time.perf_counter()
    lssd.ensure_fisher(lambda p, b: LM.lm_loss(p, cfg, b[0], b[1]), params,
                       (retain.inputs, retain.labels), chunk_size=2)
    torch.cuda.synchronize()
    fisher = lssd.fisher_global
    log(f"[lm] ensure_fisher on 4 retain sequences of domain {LM_FORGET}'s "
        f"split, argmax-labelled as the requests (chunk 2, lm_loss with "
        f"z-loss 1e-4), in {time.perf_counter() - t0:.1f} s; peak "
        f"{torch.cuda.max_memory_allocated() / gib:.2f} GiB")
    before = {k: v.clone() for k, v in stored.items()}
    cps = checkpoint_set(L, 4)

    def swept_leaves(stop):
        return sum(layer_leaves[L - l] for l in range(1, stop + 1))

    runs = {}

    def serve(name, unl, path, *, group=None, want=None, keep=False):
        """One request (or a drain of ``group``) with its dampen launches
        and leaves, checked: one launch per layer swept over that layer's
        leaves in the path's own kernel (every layer for a scanned
        program), none in the other, every parameter finite."""
        c0 = dampen_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if group is None:
            new, st = unl.forget(req, params=params)
            sts = [st]
        else:
            new, sts, st = unl.forget_group(group, params=params)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        dc = tuple(b - a for a, b in zip(c0, dampen_counts()))
        mine, other = (dc[:2], dc[2:]) if path == "fp32" else (dc[2:], dc[:2])
        eng = st["engine"]
        if eng["sweep_mode"] == "scanned":
            want_l = (len(sts) * L, len(sts) * n_leaves)
        else:
            want_l = (sum(s["stopped_at_l"] for s in sts),
                      sum(swept_leaves(s["stopped_at_l"]) for s in sts))
        log(f"[lm] {path} {name:22s}: stopped_at_l="
            f"{[s['stopped_at_l'] for s in sts]} checkpoints="
            f"{[s['checkpoints_hit'] for s in sts]} macs_vs_ssd_pct="
            f"{[round(s['macs_vs_ssd_pct'], 4) for s in sts]} "
            f"{eng['sweep_mode']}, launches {mine[0]} over {mine[1]} leaves, "
            f"builds={eng['compiles']} hits={eng['cache_hits']} wall="
            f"{secs * 1e3:.1f} ms, peak "
            f"{torch.cuda.max_memory_allocated() / gib:.2f} GiB")
        if (mine != want_l or other != (0, 0) or eng["precision"] != path
                or (want is not None and eng["sweep_mode"] != want)):
            raise AssertionError(f"lm {path} {name}: {eng}, launches {dc}, "
                                 f"expected {want_l} in {path}")
        if not all(torch.isfinite(t).all() for t in tree_leaves(new)):
            raise AssertionError(f"lm {path} {name}: non-finite parameters")
        # a result tree is kept only where a later check reads it
        runs[(path, name)] = (new if keep else None, sts, mine, secs)
        return new, sts

    zero_counts()                                   # the [lm] path starts
    serve("ssd cold", lssd, "fp32")
    _, (st_ssd,) = serve("ssd warm", lssd, "fp32", keep=True)
    _, (st_nh,) = serve("ficabu tau=-1", lssd.with_spec(spec("ficabu")),
                        "fp32")
    if (st_ssd["stopped_at_l"], runs[("fp32", "ssd warm")][2]) != \
            (L, (L, n_leaves)) or st_nh["stopped_at_l"] != L \
            or st_nh["checkpoints_hit"] != cps:
        raise AssertionError(f"lm ssd stopped at {st_ssd['stopped_at_l']}, "
                             f"ficabu tau=-1 at {st_nh['stopped_at_l']} "
                             f"through {st_nh['checkpoints_hit']}")
    # tau for the request that halts partway: the forget accuracy the
    # never-halting request read at its middle checkpoint
    trace = st_nh["forget_acc_trace"]
    tau = trace[len(trace) // 2][1]
    ficabu = lssd.with_spec(spec("ficabu", tau=tau))
    serve("ficabu cold", ficabu, "fp32")
    _, (st_h,) = serve("ficabu warm", ficabu, "fp32", keep=True)
    log(f"[lm] ficabu tau=-1 forget-accuracy trace {trace}; the halting "
        f"request's tau {tau} (the trace at its middle checkpoint): stopped "
        f"at l = {st_h['stopped_at_l']} of {L}")
    if not st_h["stopped_at_l"] < L:
        raise AssertionError("lm ficabu did not halt partway")
    for name in ("ssd warm", "ficabu warm"):
        if runs[("fp32", name)][1][0]["engine"]["compiles"] != 0:
            raise AssertionError(f"lm {name} request built steps")
    # int8: ssd and the halting ficabu, each on its q8 grid
    int8_kw = {"precision": "int8", "quant": QuantSpec()}
    lssd8 = lssd.with_spec(spec("ssd", **int8_kw))
    serve("ssd", lssd8, "int8", keep=True)
    serve("ficabu", lssd.with_spec(spec("ficabu", tau=tau, **int8_kw)),
          "int8", keep=True)
    for name, name32 in (("ssd", "ssd warm"), ("ficabu", "ficabu warm")):
        new8, (st8,), *_ = runs[("int8", name)]
        new32, (st32,), *_ = runs[("fp32", name32)]
        if not lm_on_q8_grid(adapter, new8, params, st8["stopped_at_l"]):
            raise AssertionError(f"lm int8 {name}: a leaf left its q8 grid")
        rel = layer_rel_l2(adapter, new8, new32)
        log(f"[lm] int8 {name} (stopped at {st8['stopped_at_l']}) vs fp32 "
            f"(stopped at {st32['stopped_at_l']}): every leaf on its q8 grid;"
            f" per-layer relative L2 (j = 0..{L - 1}) "
            f"{[round(r, 6) for r in rel]}")
        if st8["stopped_at_l"] == st32["stopped_at_l"] and not all(
                0.0 < r <= INT8_SWEEP_RTOL for r in rel):
            raise AssertionError(f"lm int8 {name}: per-layer error {rel} "
                                 f"outside (0, {INT8_SWEEP_RTOL}]")
    runs[("int8", "ficabu")] = None
    # scanned: the same ssd and halting ficabu as one program each, equal
    # to their layerwise requests bit for bit
    plan = plan_scanned_sweep(adapter, params, req.inputs)
    if plan is None or len(plan.kinds) != 2:
        raise AssertionError(f"lm scanned plan {plan}")
    stat_keys = ("stopped_at_l", "checkpoints_hit", "selected_per_layer",
                 "forget_acc_trace", "macs", "macs_ssd", "macs_vs_ssd_pct")

    def same(p, q):
        a, b = bridge.paths(p), bridge.paths(q)
        return sorted(a) == sorted(b) and all(
            torch.equal(bits(a[k]), bits(b[k])) for k in a)

    for name, mode, kw in (("ssd", "ssd", {}),
                           ("ficabu", "ficabu", {"tau": tau})):
        new, (st,) = serve(f"{name} scanned",
                           lssd.with_spec(spec(mode, sweep_mode="scanned",
                                               **kw)), "fp32",
                           want="scanned")
        want_new, (want_st,), *_ = runs[("fp32", f"{name} warm")]
        diff = [k for k in stat_keys if st[k] != want_st[k]]
        if diff or not same(new, want_new):
            raise AssertionError(f"lm scanned {name} != layerwise: {diff}")
    log(f"[lm] scanned ssd and ficabu == their layerwise requests, bit for "
        f"bit (all {len(stored)} stored leaves and stats); plan kinds "
        f"{plan.kinds}")
    # a K = 2 drain over two domains (the halting ficabu), layerwise and
    # scanned, beside single-set requests of the same sets
    serve("ficabu single, set 2", ficabu, "fp32", group=[req2])
    group = [req, req2]
    new_lw, sts_lw = serve("ficabu K=2 drain", ficabu, "fp32", group=group,
                           want="layerwise")
    new_sc, sts_sc = serve("ficabu K=2 drain scanned",
                           lssd.with_spec(spec("ficabu", tau=tau,
                                               sweep_mode="scanned")),
                           "fp32", group=group, want="scanned")
    if not same(new_sc, new_lw) or any(a[k] != b[k] for a, b in
                                       zip(sts_sc, sts_lw)
                                       for k in stat_keys):
        raise AssertionError("lm K=2 scanned drain != layerwise drain")
    singles = [st_h["stopped_at_l"],
               runs[("fp32", "ficabu single, set 2")][1][0]["stopped_at_l"]]
    for k, st in enumerate(sts_lw):
        stop = st["stopped_at_l"]
        halted = stop < L
        if (list(st["selected_per_layer"]) != list(range(1, stop + 1))
                or (halted and (st["checkpoints_hit"][-1] != stop
                                or st["forget_acc_trace"][-1][1] > tau))
                or any(a <= tau for _, a in st["forget_acc_trace"][:-1])):
            raise AssertionError(f"lm K=2 drain set {k}: stopped at {stop} "
                                 f"with trace {st['forget_acc_trace']}")
    log(f"[lm] K=2 drain: scanned == layerwise bit for bit; per set stopped "
        f"at {[st['stopped_at_l'] for st in sts_lw]} (single-set requests: "
        f"{singles}), each set halting at its first checkpoint at or below "
        f"tau")
    # kernel forget == plain forget, fp32 and int8 ssd
    for path, unl, kw in (("fp32", lssd, {}), ("int8", lssd8, int8_kw)):
        p_plain, _ = lssd.with_spec(spec("ssd", use_kernel=False, **kw)
                                    ).forget(req, params=params)
        p_kernel = runs[(path, "ssd warm" if path == "fp32" else "ssd")][0]
        a, b = bridge.paths(p_kernel), bridge.paths(p_plain)
        diff = [k for k in a if not torch.equal(bits(a[k]), bits(b[k]))]
        if diff:
            raise AssertionError(f"lm {path} kernel forget != plain forget "
                                 f"at {diff}")
        log(f"[lm] {path} ssd forget with the kernel == plain forget, bit for "
            f"bit, all {len(a)} stored leaves")
    path_counts = dampen_counts()                   # the [lm] path ends
    if fisher_counts() != (0, 0, 0, 0):
        raise AssertionError(f"lm requests launched fimd/gemm/rowscale "
                             f"{fisher_counts()}")
    for k, t in stored.items():
        if not torch.equal(bits(t), bits(before[k])):
            raise AssertionError(f"lm: a request edited the caller's {k}")
    del before
    log(f"[lm] the caller's tree unchanged after every request; dampen "
        f"counters over the path {path_counts}; peak "
        f"{torch.cuda.max_memory_allocated() / gib:.2f} GiB")

    # where a warm request spends its time, and the dampen sweep against its
    # byte bound
    prof = {}
    for path, unl in (("fp32", lssd), ("int8", lssd8)):
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            unl.forget(req, params=params)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t1) * 1e3)
        busy, n_kernels, ranked = profile_request(
            lambda: unl.forget(req, params=params))
        damp = [(ms, count) for name, ms, count in ranked
                if "dampen_group_kernel" in name]
        wall = sorted(walls)[1]
        prof[path] = (wall, busy, n_kernels, sum(c for _, c in damp),
                      sum(ms for ms, _ in damp))
        log(f"[profile] warm lm {path} ssd request: wall {wall:.2f} ms "
            f"(median of {[round(w, 2) for w in walls]}), device busy "
            f"{busy:.3f} ms, idle share {1 - busy / wall:.3f}, {n_kernels} "
            f"device kernels, of them {prof[path][3]} dampen_group_kernel "
            f"({prof[path][4]:.4f} ms)")
        for name, ms, count in ranked[:6]:
            log(f"[profile]   {ms:9.3f} ms  x{count:<5d} {name[:70]}")
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    tables = lm_tables(adapter, params, fisher, gen, dev)
    n_el = sum(t.numel() for ths, _, _ in tables for t in ths)

    def sweep(fn, tabs):
        for ths, i_fs, i_gs in tabs:
            fn(ths, i_fs, i_gs, 25.0, 1.0)

    tl = {"fp32": cuda_time_ms(lambda: sweep(kd.dampen_group_cuda, tables),
                               5, queue_ahead=True),
          "fp32_plain": cuda_time_ms(
              lambda: sweep(kd.dampen_group_ref, tables), 1,
              queue_ahead=True)}
    tables = [([q8_quantize(th)[0] for th in ths], i_fs, i_gs)
              for ths, i_fs, i_gs in tables]
    tl["int8"] = cuda_time_ms(lambda: sweep(kd.dampen_int8_group_cuda,
                                            tables), 5, queue_ahead=True)
    tl["int8_plain"] = cuda_time_ms(
        lambda: sweep(kd.dampen_int8_group_ref, tables), 1, queue_ahead=True)
    del tables
    # bf16 theta: 2 + 4 + 4 read, 2 + 1 written; int8 codes: 1 + 4 + 4
    # read, 1 + 1 written; and each layer's 8-byte count
    lbound = {"fp32": (n_el * 13 + 8 * L) / rate * 1e3,
              "int8": (n_el * 11 + 8 * L) / rate * 1e3}
    for kernel, path in (("dampen", "fp32"), ("dampen_int8", "int8")):
        log(f"[time] {kernel} lm sweep device ({L} grouped launches, {n_el} "
            f"elements, {'bf16 theta' if path == 'fp32' else 'int8 codes'})"
            f": kernel {tl[path]:.5f} ms, plain {tl[path + '_plain']:.5f} ms,"
            f" bound {lbound[path]:.5f} ms ({lbound[path] / tl[path] * 100:.1f}"
            f"% of the memory bound)")
    # decode: tokenwise decode_step against the forward, and the chunked
    # prefill (wide: 64 tokens fit every window) against the tokenwise decode
    dec = lm_decode_check("gemma3-1b", cfg, params,
                          req.inputs[:2, :DECODE_TOKENS], prefill=True)
    peak = torch.cuda.max_memory_allocated() / gib
    log(f"[lm] phase done in {time.perf_counter() - t_phase:.1f} s; "
        f"torch.cuda.max_memory_allocated {peak:.2f} GiB")
    out = {}
    for path in ("fp32", "int8"):
        pfx = "ssd warm" if path == "fp32" else "ssd"
        out[path] = {
            "lm_launches": path_counts[0 if path == "fp32" else 2],
            "lm_launches_per_ssd_request": runs[(path, pfx)][2][0],
            "lm_leaves_per_ssd_request": runs[(path, pfx)][2][1],
            "lm_sweep_ms": tl[path], "lm_sweep_plain_ms": tl[path + "_plain"],
            "lm_sweep_bound_ms": lbound[path],
            "lm_warm_ssd_wall_ms": prof[path][0],
            "lm_warm_ssd_device_busy_ms": prof[path][1],
        }
    out["fp32"]["lm_scanned_ssd_launches_leaves"] = list(
        runs[("fp32", "ssd scanned")][2])
    out["fp32"]["lm_k2_drain_scanned_launches_leaves"] = list(
        runs[("fp32", "ficabu K=2 drain scanned")][2])
    out["fp32"].update({
        "lm_decode_rel_l2": dec["decode_vs_forward"][0],
        "lm_prefill_rel_l2": dec["prefill_vs_decode"][0],
        "lm_prefill_cache_rel_l2": dec["prefill_cache_rel_l2"],
        "lm_decode_seconds": dec["seconds"]})
    out["peak_gib"] = peak
    if keep is not None:
        keep.update(cfg=cfg, adapter=adapter, params=params, fisher=fisher,
                    req=req, spec=spec, lssd=lssd, n_leaves=n_leaves)
    del params, fisher, lssd, lssd8, ficabu, runs, stored
    torch.cuda.empty_cache()
    return out


def shard_phase(dev, card, zero_counts, dampen_counts, fisher_counts, sh):
    """Phase 10, [shard]: sharded requests on [lm]'s weights (module
    docstring). ``sh`` is [lm]'s ``keep``. Returns the figures the kernels
    line carries, per precision."""
    import shutil
    import tempfile

    from repro_torch import bridge
    from repro_torch.api import QuantSpec, Unlearner
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.dist import execute as dx
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh

    t_phase = time.perf_counter()
    adapter, params, fisher, req, spec, lssd = (
        sh[k] for k in ("adapter", "params", "fisher", "req", "spec",
                        "lssd"))
    L, n_leaves = adapter.n_layers, sh["n_leaves"]
    stat_keys = ("stopped_at_l", "checkpoints_hit", "selected_per_layer",
                 "forget_acc_trace", "macs", "macs_ssd", "macs_vs_ssd_pct")
    mesh = make_host_mesh(device="cuda")
    out = {"fp32": {}, "int8": {}}
    try:
        log(f"[shard] {mesh} on a one-rank {torch.distributed.get_backend()} "
            f"process group; [lm]'s {sh['cfg'].name} weights, Fisher and "
            f"8 x {LM_SEQ}-token request; {card}")
        # one warm sharded session for the three requests (with_spec), the
        # unsharded ones on [lm]'s warm session
        base = Unlearner(adapter, fisher, spec("ssd"),
                         device="cuda").shard(mesh)
        int8_kw = {"precision": "int8", "quant": QuantSpec()}
        cases = (("fp32 layerwise", "fp32", spec("ssd")),
                 ("fp32 scanned", "fp32", spec("ssd", sweep_mode="scanned")),
                 ("int8", "int8", spec("ssd", **int8_kw)))
        zero_counts()                               # the [shard] path starts
        kept = None
        for name, path, sp in cases:
            res = {}
            for tag, unl in (("unsharded", lssd.with_spec(sp)),
                             ("sharded", base.with_spec(sp))):
                unl.forget(req, params=params)      # a first run, untimed
                c0 = dampen_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                new, st = unl.forget(req, params=params)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                res[tag] = (new, st, tuple(b - a for a, b in
                                           zip(c0, dampen_counts())), wall)
            (nu, su, cu, wu), (ns, ss, cs, ws) = (res["unsharded"],
                                                  res["sharded"])
            specs = shd.spec_paths(sp.exec.param_pspecs(nu, mesh))
            a, b = bridge.paths(nu), bridge.paths(ns)
            bad = [k for k in a if not (
                dx.is_dtensor(b[k])
                and tuple(b[k].placements) == shd.placements(specs[k], mesh)
                and torch.equal(bits(a[k]), bits(b[k].full_tensor())))]
            diff = [k for k in stat_keys if su[k] != ss[k]]
            mine = cs[:2] if path == "fp32" else cs[2:]
            log(f"[shard] {name:14s} ssd: sharded == unsharded bit for bit "
                f"on {len(a) - len(bad)} of {len(a)} stored leaves, stats "
                f"{'equal' if not diff else diff}, stopped_at_l "
                f"{ss['stopped_at_l']}, {ss['engine']['sweep_mode']}; "
                f"launches {mine[0]} over {mine[1]} leaves (unsharded "
                f"{cu}); warm wall {ws * 1e3:.1f} ms sharded, "
                f"{wu * 1e3:.1f} ms unsharded")
            if bad or diff or cu != cs or mine != (L, n_leaves) \
                    or ss["engine"]["sweep_mode"] != su["engine"]["sweep_mode"]:
                raise AssertionError(f"shard {name}: leaves {bad[:4]}, stats "
                                     f"{diff}, launches {cs} vs {cu}")
            key = name.replace(" ", "_")
            out[path].update({
                f"shard_{key}_launches_leaves": list(mine),
                f"shard_{key}_warm_wall_ms": ws * 1e3,
                f"shard_{key}_unsharded_warm_wall_ms": wu * 1e3})
            if name == "fp32 layerwise":
                kept = (ns, nu)
        counts = dampen_counts()                    # the [shard] path ends
        out["fp32"]["shard_launches"] = counts[0]
        out["int8"]["shard_launches"] = counts[2]
        if fisher_counts() != (0, 0, 0, 0):
            raise AssertionError(f"shard requests launched fimd/gemm/rowscale "
                                 f"{fisher_counts()}")
        # the elastic restore: the sharded result saved, restored onto the
        # mesh by sharding_fn, bit for bit
        ns, nu = kept
        specs = shd.spec_paths(spec("ssd").exec.param_pspecs(nu, mesh))
        (ROOT / "build").mkdir(exist_ok=True)
        tmp = Path(tempfile.mkdtemp(prefix="shard_", dir=ROOT / "build"))
        try:
            t0 = time.perf_counter()
            ckpt.save(str(tmp), 1, ns)
            t_save = time.perf_counter() - t0
            t0 = time.perf_counter()
            got, _ = ckpt.restore(str(tmp), 1, nu, device="cuda",
                                  sharding_fn=lambda p: (mesh, specs[p]))
            torch.cuda.synchronize()
            t_restore = time.perf_counter() - t0
            size = sum(f.stat().st_size for f in tmp.rglob("*") if f.is_file())
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        a, b = bridge.paths(nu), bridge.paths(got)
        bad = [k for k in a if not (
            tuple(b[k].placements) == shd.placements(specs[k], mesh)
            and torch.equal(bits(a[k]), bits(b[k].full_tensor())))]
        if bad:
            raise AssertionError(f"shard restore: {bad[:4]} differ")
        log(f"[shard] checkpoint of the sharded fp32 result ({size} bytes) "
            f"saved in {t_save:.1f} s, restored with sharding_fn onto the "
            f"mesh in {t_restore:.1f} s: all {len(a)} leaves DTensors with "
            f"their placements, bit for bit")
        out["fp32"].update({"shard_checkpoint_bytes": size,
                            "shard_save_seconds": t_save,
                            "shard_restore_seconds": t_restore})
        del base, kept, ns, nu, got
    finally:
        mesh.close()
    secs = time.perf_counter() - t_phase
    out["fp32"]["shard_phase_seconds"] = secs
    log(f"[shard] phase done in {secs:.1f} s; the process group destroyed")
    return out


# the [cache] phase's traffic: 4 requests of 8 prompt tokens, 4 generated,
# one forget after batch 1 (the CPU tests' serve traffic) on a fleet of two
# gemma3-1b SMOKE tenants (the CLI serves SMOKE) whose specs set use_kernel
CACHE_SEEDS = (0, 1)
CACHE_TRAFFIC = ("--requests", "4", "--prompt-len", "8", "--gen-len", "4")


def cache_phase(card):
    """Phase 11, [cache]: two cold starts of ``serve --fleet --cache-dir``
    on one cache dir (module docstring). Each start is ``python -m
    repro_torch.launch.serve``, whose ``--check`` runs under deterministic
    algorithms, as [fleet] runs, so that the fleet's solo replay gate can
    hold bit for bit. Returns the figures the kernels line carries."""
    import shutil
    import tempfile

    from repro_torch.api import UnlearnSpec
    from repro_torch.launch import serve as S

    t_phase = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="cache_", dir=ROOT / "build"))
    cdir = tmp / "cache"
    tspec = UnlearnSpec.for_mode("ficabu", chunk_size=4, use_kernel=True,
                                 sweep_mode="scanned").to_dict()
    fleet = {"tenants": [{"name": f"k{s}", "arch": LM_ARCH, "seed": s,
                          "spec": tspec} for s in CACHE_SEEDS],
             "serve": {"chunk_size": 4}}
    (tmp / "fleet.json").write_text(json.dumps(fleet))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    runs = []
    try:
        for i in (1, 2):
            res = tmp / f"run{i}.json"
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.serve",
                 "--fleet", str(tmp / "fleet.json"), "--cache-dir", str(cdir),
                 "--check", "--device", "cuda", "--out", str(res),
                 *CACHE_TRAFFIC],
                cwd=ROOT, env=env, capture_output=True, text=True,
                timeout=600)
            secs = time.perf_counter() - t0
            if proc.returncode != 0:
                raise AssertionError(
                    f"cache run {i} exited {proc.returncode}: "
                    f"{proc.stderr[-3000:]} {proc.stdout[-2000:]}")
            info = json.loads(res.read_text())["compilation_cache"]
            runs.append((secs, info))
            log(f"[cache] start {i}: serve --fleet --cache-dir --check exit 0 "
                f"in {secs:.1f} s; entries before {info['entries_before']}, "
                f"new {info['entries_new']}; "
                f"{sorted(p.name for p in cdir.glob('*.so'))}")
        (s1, c1), (s2, c2) = runs
        if not (c1["entries_before"] == 0 and c1["entries_new"] >= 1):
            raise AssertionError(f"cache start 1 built nothing: {c1}")
        if not (c2["entries_before"] >= 1 and c2["entries_new"] == 0):
            raise AssertionError(f"cache start 2 rebuilt: {c2}")
        # the negative control: the gate fed the warm cache plus one more
        # finished library
        n = S.compilation_cache_entries(str(cdir))
        (cdir / "libficabu_extra-0000000000000000.so").write_bytes(b"\0")
        problems = S.cache_problems(S.cache_info_since(str(cdir), n))
        if not problems:
            raise AssertionError("cache gate missed an added library")
        log(f"[cache] negative control: the gate on a warm cache plus one "
            f"finished library reports {problems}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    secs = time.perf_counter() - t_phase
    log(f"[cache] phase done in {secs:.1f} s; {card}")
    return {"cache_start_seconds": [s1, s2],
            "cache_entries_before_new": [[c1["entries_before"],
                                          c1["entries_new"]],
                                         [c2["entries_before"],
                                          c2["entries_new"]]],
            "cache_phase_seconds": secs}


def split_by_dtype(tables):
    """Each (thetas, i_fs, i_gs) table cut into one table per theta dtype,
    in first-seen order: the tables a fp32 request launches, where a bf16
    layer's f32 leaf (the RG-LRU's log_lambda) goes out on its own."""
    out = []
    for ths, i_fs, i_gs in tables:
        for dt in dict.fromkeys(t.dtype for t in ths):
            idx = [i for i, t in enumerate(ths) if t.dtype == dt]
            out.append(tuple([seq[i] for i in idx]
                             for seq in (ths, i_fs, i_gs)))
    return out


def rec_model(arch, n_layers, n_seq, every, alpha, want, dev, rate,
              counters, seq=LM_SEQ):
    """One model of the [recurrent] phase (module docstring, phase 12):
    built at full width from a seeded CUDA generator, its layer tables
    through the group kernels against their plain versions, then its
    requests of ``seq`` tokens with the dampen counters zeroed before and
    read after. Returns
    the figures the kernels line carries, the largest |err| per kernel and
    the path's dampen counters."""
    from repro_torch import bridge
    from repro_torch.api import (ForgetRequest, QuantSpec, Unlearner,
                                 UnlearnSpec)
    from repro_torch.configs import get as get_arch
    from repro_torch.core import adapters
    from repro_torch.core.schedule import checkpoint_set
    from repro_torch.data import synthetic as syn
    from repro_torch.engine import plan_scanned_sweep
    from repro_torch.kernels import dampen as kd
    from repro_torch.models import lm as LM
    from repro_torch.models.module import tree_leaves
    from repro_torch.optim.compression import INT8_SWEEP_RTOL, q8_quantize

    zero_counts, dampen_counts, fisher_counts = counters
    t_model = time.perf_counter()
    gib = 2.0 ** 30
    xl = arch.startswith("xlstm")
    tag = "xlstm" if xl else "rg"
    torch.cuda.reset_peak_memory_stats()
    full = get_arch(arch).full
    cfg = full if n_layers is None else full.with_(n_layers=n_layers)
    t0 = time.perf_counter()
    params = LM.init_lm(torch.Generator(device=dev).manual_seed(SEED), cfg,
                        device="cuda")
    adapter = adapters.lm_adapter(cfg, seq, device="cuda")
    torch.cuda.synchronize()
    L = adapter.n_layers
    stored = bridge.paths(params)
    n_params = sum(t.numel() for t in stored.values())
    layers = [tree_leaves(adapter.get_layer(params, j)) for j in range(L)]
    layer_leaves = [len(ls) for ls in layers]
    n_leaves = sum(layer_leaves)
    # a fp32 request launches the dampen kernel once per dtype among a
    # layer's leaves (an RG-LRU layer: bf16 weights and the f32
    # log_lambda), an int8 request once per layer of codes
    launches32 = [len({t.dtype for t in ls}) for ls in layers]
    log(f"[recurrent] {cfg.name} ({cfg.n_layers} blocks {cfg.block_pattern}"
        f"{f', depth cut from {full.n_layers}' if n_layers else ''}, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.dh}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab}, {cfg.param_dtype}) from torch.Generator('cuda') "
        f"seed {SEED} in {time.perf_counter() - t0:.1f} s: {n_params} "
        f"parameters in {len(stored)} stored leaves; {n_leaves} layer leaves "
        f"in {L} unlearn layers; dampen launches per layer (fp32) "
        f"{launches32}")
    if (n_params, len(stored), n_leaves, L) != want:
        got = (n_params, len(stored), n_leaves, L)
        raise AssertionError(f"{cfg.name}: {got} (parameters, stored "
                             f"leaves, layer leaves, layers), expected "
                             f"{want}")

    # the group kernels on this model's tables, before the path's counters
    # are zeroed: each layer's whole table (as an int8 request launches it)
    # and, for a layer of two dtypes, each dtype's part (as a fp32 request
    # launches it); the whole tree too where it fits beside the model
    shapes = [[tuple(t.shape) for t in ls] for ls in layers]
    shapes += [[tuple(t.shape) for t in ls if t.dtype == dt]
               for ls in layers if len({t.dtype for t in ls}) > 1
               for dt in dict.fromkeys(t.dtype for t in ls)]
    t0 = time.perf_counter()
    gcases, gerr = check_group_kernels_against_plain(shapes, dev, edges=False,
                                                     whole=xl)
    whole = ", and the whole tree" if xl else ""
    log(f"[recurrent] {cfg.name}: grouped dampen and dampen_int8 over its "
        f"{len(shapes)} tables ({L} layers, {len(shapes) - L} per-dtype "
        f"parts{whole}) x f32/bf16/int8 x 3 pairs: bit-identical to their plain versions, "
        f"selection count, launch and leaf counters included, in {gcases} "
        f"tables, max |err| {gerr} ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    toks, doms = syn.make_lm_domains(syn.LMDataConfig(
        vocab=LM_DATA_VOCAB, n_domains=4, seq_len=seq, n_per_domain=8,
        seed=SEED))
    splits = {d: syn.lm_split_forget_retain(toks, doms, d)
              for d in (LM_FORGET, LM_OTHER)}

    def request(seqs, tag):
        inputs = torch.as_tensor(seqs[:, :-1], device=dev).long().contiguous()
        with torch.no_grad():
            labels = LM.forward(params, cfg, inputs)[0].argmax(-1)
        return ForgetRequest(inputs, labels, tag=tag)

    req = request(splits[LM_FORGET]["forget"][:n_seq], LM_FORGET)
    req2 = request(splits[LM_OTHER]["forget"][:n_seq], LM_OTHER) if xl \
        else None
    retain = request(splits[LM_FORGET]["retain"][:4], "retain")
    log(f"[recurrent] {cfg.name}: {n_seq}-sequence requests of S = {seq} "
        f"tokens (domains {LM_FORGET}{f', {LM_OTHER}' if xl else ''}), "
        f"argmax labels, in {time.perf_counter() - t0:.1f} s")

    def spec(mode, **kw):
        return UnlearnSpec.for_mode(mode, **{
            "alpha": alpha, "lam": 1.0, "tau": -1.0,
            "checkpoint_every": every, "chunk_size": 2, "use_kernel": True,
            **kw})

    lssd = Unlearner(adapter, spec=spec("ssd"), device="cuda")
    t0 = time.perf_counter()
    lssd.ensure_fisher(lambda p, b: LM.lm_loss(p, cfg, b[0], b[1]), params,
                       (retain.inputs, retain.labels), chunk_size=2)
    torch.cuda.synchronize()
    fisher = lssd.fisher_global
    log(f"[recurrent] {cfg.name}: ensure_fisher on 4 retain sequences "
        f"(chunk 2) in {time.perf_counter() - t0:.1f} s; peak "
        f"{torch.cuda.max_memory_allocated() / gib:.2f} GiB")
    # the caller's tree as it was, kept on the host (6.8 GB for
    # recurrentgemma)
    before = {k: v.cpu() for k, v in stored.items()}
    cps = checkpoint_set(L, every)
    if plan_scanned_sweep(adapter, params, req.inputs) is not None:
        raise AssertionError(f"{cfg.name}: a scanned plan for a stack of "
                             f"layers of unequal shapes")
    runs = {}

    def expected(path, sts):
        per = launches32 if path == "fp32" else [1] * L
        return (sum(per[L - l] for s in sts
                    for l in range(1, s["stopped_at_l"] + 1)),
                sum(layer_leaves[L - l] for s in sts
                    for l in range(1, s["stopped_at_l"] + 1)))

    busy = {}

    def serve(name, unl, path, *, group=None, keep=False):
        """One request (or a drain of ``group``), checked: its dampen
        launches and leaves in its own precision's kernel (one launch per
        dtype of each layer swept, fp32; one per layer, int8), none in the
        other's; the layerwise loop (no scanned plan for this stack); every
        parameter finite. A warm ssd request runs under ``nvml_busy``."""
        c0 = dampen_counts()
        got = []

        def call():
            got.append(unl.forget(req, params=params) if group is None
                       else unl.forget_group(group, params=params))

        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if name == "ssd warm":
            busy[path] = nvml_busy(call)
        else:
            call()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        if group is None:
            new, st = got[0]
            sts = [st]
        else:
            new, sts, st = got[0]
        dc = tuple(b - a for a, b in zip(c0, dampen_counts()))
        mine, other = (dc[:2], dc[2:]) if path == "fp32" else (dc[2:], dc[:2])
        eng = st["engine"]
        log(f"[recurrent] {tag} {path} {name:22s}: stopped_at_l="
            f"{[s['stopped_at_l'] for s in sts]} checkpoints="
            f"{[s['checkpoints_hit'] for s in sts]} macs_vs_ssd_pct="
            f"{[round(s['macs_vs_ssd_pct'], 4) for s in sts]} "
            f"{eng['sweep_mode']}, launches {mine[0]} over {mine[1]} leaves, "
            f"builds={eng['compiles']} hits={eng['cache_hits']} wall="
            f"{secs * 1e3:.1f} ms, peak "
            f"{torch.cuda.max_memory_allocated() / gib:.2f} GiB")
        if (mine != expected(path, sts) or other != (0, 0)
                or eng["precision"] != path
                or eng["sweep_mode"] != "layerwise"):
            raise AssertionError(f"{tag} {path} {name}: {eng}, launches {dc},"
                                 f" expected {expected(path, sts)} in {path}")
        if not all(torch.isfinite(t).all() for t in tree_leaves(new)):
            raise AssertionError(f"{tag} {path} {name}: non-finite "
                                 f"parameters")
        runs[(path, name)] = (new if keep else None, sts, mine, secs)
        return new, sts

    def selected(st):
        """Per layer (j = 0..L-1), the share of its entries selected."""
        return [round(st["selected_per_layer"].get(L - j, 0) / sum(
            t.numel() for t in layers[j]), 4) for j in range(L)]

    stat_keys = ("stopped_at_l", "checkpoints_hit", "selected_per_layer",
                 "forget_acc_trace", "macs", "macs_ssd", "macs_vs_ssd_pct")

    def same(p, q):
        a, b = bridge.paths(p), bridge.paths(q)
        return sorted(a) == sorted(b) and all(
            torch.equal(bits(a[k]), bits(b[k])) for k in a)

    def drop(path, name):
        """Free a kept result tree once its checks are done (a
        recurrentgemma tree is 6.8 GB)."""
        runs[(path, name)] = (None,) + runs[(path, name)][1:]
        torch.cuda.empty_cache()

    def kernel_equals_plain(path, name, kw):
        """The ssd forget with the kernel == the same with the plain
        version, bit for bit on every stored leaf."""
        p_plain, _ = lssd.with_spec(spec("ssd", use_kernel=False, **kw)
                                    ).forget(req, params=params)
        a, b = bridge.paths(runs[(path, name)][0]), bridge.paths(p_plain)
        diff = [k for k in a if not torch.equal(bits(a[k]), bits(b[k]))]
        if diff:
            raise AssertionError(f"{tag} {path} kernel forget != plain forget"
                                 f" at {diff}")
        log(f"[recurrent] {tag} {path} ssd forget with the kernel == plain "
            f"forget, bit for bit, all {len(a)} stored leaves")

    def int8_checks(name, name32):
        """An int8 request on its q8 grids and, where it halted where its
        fp32 twin did, within INT8_SWEEP_RTOL of it, per layer."""
        new8, (st8,), *_ = runs[("int8", name)]
        new32, (st32,), *_ = runs[("fp32", name32)]
        if not lm_on_q8_grid(adapter, new8, params, st8["stopped_at_l"]):
            raise AssertionError(f"{tag} int8 {name}: a leaf left its q8 "
                                 f"grid")
        rel = layer_rel_l2(adapter, new8, new32)
        log(f"[recurrent] {tag} int8 {name} (stopped at "
            f"{st8['stopped_at_l']}) vs fp32 (stopped at "
            f"{st32['stopped_at_l']}): every leaf on its q8 grid; per-layer "
            f"relative L2 (j = 0..{L - 1}) {[round(r, 6) for r in rel]}; "
            f"share selected per layer, fp32 {selected(st32)}, int8 "
            f"{selected(st8)}")
        if st8["stopped_at_l"] == st32["stopped_at_l"] and not all(
                0.0 < r <= INT8_SWEEP_RTOL for r in rel):
            raise AssertionError(f"{tag} int8 {name}: per-layer error {rel} "
                                 f"outside (0, {INT8_SWEEP_RTOL}]")

    zero_counts()                       # the model's [recurrent] path starts
    serve("ssd cold", lssd, "fp32")
    _, (st_ssd,) = serve("ssd warm", lssd, "fp32", keep=True)
    _, (st_nh,) = serve("ficabu tau=-1", lssd.with_spec(spec("ficabu")),
                        "fp32")
    if st_ssd["stopped_at_l"] != L or st_nh["stopped_at_l"] != L \
            or st_nh["checkpoints_hit"] != cps:
        raise AssertionError(f"{tag} ssd stopped at {st_ssd['stopped_at_l']}"
                             f", ficabu tau=-1 at {st_nh['stopped_at_l']} "
                             f"through {st_nh['checkpoints_hit']}")
    if runs[("fp32", "ssd warm")][1][0]["engine"]["compiles"] != 0:
        raise AssertionError(f"{tag} warm ssd request built steps")
    trace = st_nh["forget_acc_trace"]
    tau = trace[len(trace) // 2][1]
    if not xl:
        # scanned: no plan for a stack of unequal layers, so the request
        # runs the layerwise loop, equal to the layerwise request bit for
        # bit (recurrentgemma's request holds it for both recurrent
        # stacks: the same fallback, at a fifth of xlstm's host time)
        new, (st,) = serve("ssd scanned", lssd.with_spec(spec(
            "ssd", sweep_mode="scanned")), "fp32")
        want_new, (want_st,), *_ = runs[("fp32", "ssd warm")]
        diff = [k for k in stat_keys if st[k] != want_st[k]]
        if diff or not same(new, want_new):
            raise AssertionError(f"{tag} scanned ssd != layerwise: {diff}")
        del new, want_new
        log(f"[recurrent] {tag} scanned ssd: no plan (the layers differ in "
            f"shape), the layerwise loop, == the layerwise request bit for "
            f"bit (all {len(stored)} stored leaves and stats)")
    kernel_equals_plain("fp32", "ssd warm", {})
    int8_kw = {"precision": "int8", "quant": QuantSpec()}
    lssd8 = lssd.with_spec(spec("ssd", **int8_kw))
    # (xlstm's requests are host-bound and long: one int8 ssd, cold)
    int8_ssd = "ssd cold" if xl else "ssd warm"
    if not xl:
        serve("ssd cold", lssd8, "int8")
    serve(int8_ssd, lssd8, "int8", keep=True)
    int8_checks(int8_ssd, "ssd warm")
    drop("fp32", "ssd warm")
    kernel_equals_plain("int8", int8_ssd, int8_kw)
    drop("int8", int8_ssd)
    if xl:
        # the request that halts partway, fp32 and int8, and a K = 2 drain
        ficabu = lssd.with_spec(spec("ficabu", tau=tau))
        _, (st_h,) = serve("ficabu", ficabu, "fp32", keep=True)
        log(f"[recurrent] {tag} ficabu tau=-1 forget-accuracy trace {trace};"
            f" the halting request's tau {tau} (the trace at its middle "
            f"checkpoint): stopped at l = {st_h['stopped_at_l']} of {L}")
        if not st_h["stopped_at_l"] < L:
            raise AssertionError(f"{tag} ficabu did not halt partway")
        _, (st8,) = serve("ficabu", lssd.with_spec(spec(
            "ficabu", tau=tau, **int8_kw)), "int8", keep=True)
        stop8, twin = st8["stopped_at_l"], "ficabu"
        if stop8 != st_h["stopped_at_l"]:
            # a near-tie at tau (the int8 walk's forget accuracy a few
            # tokens off fp32's): the int8 sweep's per-layer error is held
            # against an fp32 request that halts at the same checkpoint,
            # its tau the never-halting fp32 trace's value there
            twin = f"ficabu halting at l = {stop8}"
            _, (st_t,) = serve(twin, lssd.with_spec(spec(
                "ficabu", tau=dict(trace)[stop8])), "fp32", keep=True)
            if st_t["stopped_at_l"] != stop8:
                raise AssertionError(f"{tag} {twin}: stopped at "
                                     f"{st_t['stopped_at_l']}")
        int8_checks("ficabu", twin)
        drop("fp32", "ficabu")
        drop("fp32", twin)
        drop("int8", "ficabu")
        # the K = 2 drain, layerwise: a "scanned" drain of this stack is the
        # same layerwise loop, and [encdec] holds that fallback (its K = 2
        # drain, "scanned" == layerwise)
        group = [req, req2]
        _, sts_lw = serve("ficabu K=2 drain", ficabu, "fp32", group=group)
        for k, st in enumerate(sts_lw):
            stop = st["stopped_at_l"]
            if (list(st["selected_per_layer"]) != list(range(1, stop + 1))
                    or (stop < L and (st["checkpoints_hit"][-1] != stop
                                      or st["forget_acc_trace"][-1][1] > tau))
                    or any(a <= tau for _, a in st["forget_acc_trace"][:-1])):
                raise AssertionError(f"{tag} K=2 drain set {k}: stopped at "
                                     f"{stop}, trace "
                                     f"{st['forget_acc_trace']}")
        log(f"[recurrent] {tag} K=2 drain: per set stopped at "
            f"{[s['stopped_at_l'] for s in sts_lw]}, each at its first "
            f"checkpoint at or below tau")
    path_counts = dampen_counts()         # the model's [recurrent] path ends
    if fisher_counts() != (0, 0, 0, 0):
        raise AssertionError(f"{tag} requests launched fimd/gemm/rowscale "
                             f"{fisher_counts()}")
    for k, t in stored.items():
        if not torch.equal(bits(t.cpu()), bits(before[k])):
            raise AssertionError(f"{tag}: a request edited the caller's {k}")
    del before
    log(f"[recurrent] {tag}: the caller's tree unchanged after every "
        f"request; dampen counters over the path {path_counts}; peak "
        f"{torch.cuda.max_memory_allocated() / gib:.2f} GiB")

    # where a warm ssd request spends its time: its wall and NVML busy
    # share from the warm request served above; on recurrentgemma also the
    # profile of one more (xlstm's, a million kernels, takes minutes:
    # tools/recurrent_profile.py)
    prof = {}
    for path, unl in (("fp32", lssd), ("int8", lssd8)):
        if path not in busy:
            continue
        wall = runs[(path, "ssd warm")][3] * 1e3
        share, n_samples = busy[path]
        prof[path] = (wall, share * wall, None)
        log(f"[profile] warm {tag} {path} ssd request: wall {wall:.2f} ms, "
            f"NVML busy share {share:.3f} over {n_samples} samples (device "
            f"busy {share * wall:.1f} ms, idle share {1 - share:.3f})")
        if xl:
            continue
        t1 = time.perf_counter()
        pbusy, n_kernels, ranked = profile_request(
            lambda: unl.forget(req, params=params))
        damp = [(ms, count) for name, ms, count in ranked
                if "dampen_group_kernel" in name]
        prof[path] = (wall, pbusy, n_kernels)
        log(f"[profile] warm {tag} {path} ssd request, profiled: device busy "
            f"{pbusy:.3f} ms, idle share {1 - pbusy / wall:.3f} (NVML: "
            f"{1 - share:.3f}), {n_kernels} device kernels, of them "
            f"{sum(c for _, c in damp)} dampen_group_kernel "
            f"({sum(ms for ms, _ in damp):.4f} ms); profiled in "
            f"{time.perf_counter() - t1:.1f} s")
        for name, ms, count in ranked[:6]:
            log(f"[profile]   {ms:9.3f} ms  x{count:<7d} {name[:70]}")
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    base = lm_tables(adapter, params, fisher, gen, dev)
    tables = split_by_dtype(base)
    n_el = {dt: sum(t.numel() for ths, _, _ in tables for t in ths
                    if t.dtype == dt)
            for dt in (torch.bfloat16, torch.float32)}

    def sweep(fn, tabs):
        for ths, i_fs, i_gs in tabs:
            fn(ths, i_fs, i_gs, 25.0, 1.0)

    tl = {"fp32": cuda_time_ms(lambda: sweep(kd.dampen_group_cuda, tables),
                               5, queue_ahead=True),
          "fp32_plain": cuda_time_ms(
              lambda: sweep(kd.dampen_group_ref, tables), 1,
              queue_ahead=True)}
    n_launch32 = len(tables)
    tables = [([q8_quantize(th)[0] for th in ths], i_fs, i_gs)
              for ths, i_fs, i_gs in base]
    del base
    tl["int8"] = cuda_time_ms(lambda: sweep(kd.dampen_int8_group_cuda,
                                            tables), 5, queue_ahead=True)
    tl["int8_plain"] = cuda_time_ms(
        lambda: sweep(kd.dampen_int8_group_ref, tables), 1, queue_ahead=True)
    del tables
    # bf16 theta: 2 + 4 + 4 read, 2 + 1 written; f32 theta (log_lambda):
    # 4 + 4 + 4 read, 4 + 1 written; int8 codes: 1 + 4 + 4 read, 1 + 1
    # written; and each launch's 8-byte count
    lbound = {"fp32": (n_el[torch.bfloat16] * 13 + n_el[torch.float32] * 17
                       + 8 * n_launch32) / rate * 1e3,
              "int8": ((n_el[torch.bfloat16] + n_el[torch.float32]) * 11
                       + 8 * L) / rate * 1e3}
    for kernel, path, n in (("dampen", "fp32", n_launch32),
                            ("dampen_int8", "int8", L)):
        log(f"[time] {kernel} {tag} sweep device ({n} grouped launches, "
            f"{sum(n_el.values())} elements): kernel {tl[path]:.5f} ms, plain "
            f"{tl[path + '_plain']:.5f} ms, bound {lbound[path]:.5f} ms "
            f"({lbound[path] / tl[path] * 100:.1f}% of the memory bound)")
    # decode: each block's decode form (the recurrent states, the local
    # attention's cache) token by token against the forward
    dec = lm_decode_check(cfg.name, cfg, params,
                          req.inputs[:2, :DECODE_TOKENS],
                          rtol=DECODE_RTOL if xl else DECODE_RTOL_CONV)
    peak = torch.cuda.max_memory_allocated() / gib
    secs = time.perf_counter() - t_model
    log(f"[recurrent] {tag} done in {secs:.1f} s; "
        f"torch.cuda.max_memory_allocated {peak:.2f} GiB")
    out = {}
    for path in ("fp32", "int8"):
        ssd_run = runs[(path, "ssd warm" if path == "fp32" else int8_ssd)]
        out[path] = {
            f"rec_{tag}_launches": path_counts[0 if path == "fp32" else 2],
            f"rec_{tag}_leaves": path_counts[1 if path == "fp32" else 3],
            f"rec_{tag}_launches_per_ssd_request": ssd_run[2][0],
            f"rec_{tag}_leaves_per_ssd_request": ssd_run[2][1],
            f"rec_{tag}_sweep_ms": tl[path],
            f"rec_{tag}_sweep_plain_ms": tl[path + "_plain"],
            f"rec_{tag}_sweep_bound_ms": lbound[path],
        }
        if path in prof:
            out[path].update({
                f"rec_{tag}_warm_ssd_wall_ms": prof[path][0],
                f"rec_{tag}_warm_ssd_device_busy_ms": prof[path][1],
                f"rec_{tag}_warm_ssd_nvml_busy_share": busy[path][0]})
            if prof[path][2] is not None:
                out[path][f"rec_{tag}_warm_ssd_device_kernels"] = \
                    prof[path][2]
    out["fp32"][f"rec_{tag}_decode_rel_l2"] = dec["decode_vs_forward"][0]
    out["fp32"][f"rec_{tag}_peak_gib"] = peak
    out["fp32"][f"rec_{tag}_seconds"] = secs
    del params, fisher, lssd, lssd8, runs, stored, layers
    torch.cuda.empty_cache()
    return out, gerr


# the [recurrent] phase: (arch, depth cut or None, sequences per request,
# checkpoint cadence, alpha, expected (parameters, stored leaves, layer
# leaves, unlearn layers)). recurrentgemma-9b runs at full width and 3 of
# its 38 blocks: one whole (rglru, rglru, local) period, 2.8 B parameters
# (5 blocks, with the two-layer rglru tail, before the [train] phase); all
# 38 would hold 11.6 B, 23 GB in bf16 and a 46 GB f32 Fisher, more than one
# card (PERF.md section 4). xlstm-125m
# runs at full width and 4 of its 12 blocks, one (mlstm x3, slstm) period:
# its requests are host-bound in the sLSTM's time loop (R8), a third of its
# requests' time per sLSTM layer; the whole 12 took 190-254 s of the
# script's time, which the [moe] phase pushed past 800 s, and 8 blocks 183
# s, which the [serve] phase pushed past it again (PERF.md section 4). It
# takes alpha 50: at [lm]'s 25 its int8 ssd request reads more than
# INT8_SWEEP_RTOL against fp32 in its first mLSTM block, with 4% of the
# block's entries selected (tools/recurrent_profile.py measures both
# settings on the whole model; PERF.md section 7)
REC_MODELS = (
    ("xlstm-125m", 4, 8, 4, 50.0, (87_909_144, 44, 44, 6)),
    ("recurrentgemma-9b", 3, 4, 2, 25.0, (2_839_587_104, 38, 38, 5)),
)
# a model's sequence length where it is not LM_SEQ: xlstm-125m's requests,
# retain Fisher and data are 512 tokens long, the sLSTM's loop taking one
# host-bound step per token (PERF.md section 4)
REC_SEQ = {"xlstm-125m": 512}


def recurrent_phase(dev, rate, zero_counts, dampen_counts, fisher_counts):
    """Phase 12, [recurrent]: the recurrent LMs (module docstring). Returns
    the figures the kernels line carries and the largest |err| per
    kernel."""
    t_phase = time.perf_counter()
    out = {"fp32": {}, "int8": {}}
    err = {"dampen": 0.0, "dampen_int8": 0}
    for arch, n_layers, n_seq, every, alpha, want in REC_MODELS:
        got, gerr = rec_model(arch, n_layers, n_seq, every, alpha, want, dev,
                              rate, (zero_counts, dampen_counts,
                                     fisher_counts),
                              seq=REC_SEQ.get(arch, LM_SEQ))
        for path in out:
            out[path].update(got[path])
        for k in err:
            err[k] = max(err[k], gerr[k])
    secs = time.perf_counter() - t_phase
    out["fp32"]["rec_phase_seconds"] = secs
    log(f"[recurrent] phase done in {secs:.1f} s")
    return out, err


# the [dense] phase: the dense GQA arch served at full width, the depth it
# is cut to, its expected (parameters, stored leaves, layer leaves, unlearn
# layers) and the sequence length of its long request (past 2 * Q_CHUNK
# queries: every block takes the query-chunked attention). All 32 blocks
# hold 6.06 B parameters, 12.1 GB in bf16 and a 24.2 GB f32 Fisher; at the
# ~20 bytes of peak per parameter recurrentgemma-9b's requests take, more
# than one 80 GB card. It ran 16 blocks before the [serve] phase, 8 before
# the [train] phase and 4 since, to keep the script near 800 s (PERF.md
# section 4)
DENSE_ARCH = "yi-6b"
DENSE_BLOCKS = 4
DENSE_WANT = (1_216_385_024, 12, 39, 6)
DENSE_LONG_SEQ = 2048


def dense_phase(dev, rate, zero_counts, dampen_counts, fisher_counts):
    """Phase 13, [dense]: the dense GQA LM at full width and a cut depth
    (module docstring). Returns the figures the kernels line carries and
    the largest |err| per kernel."""
    from repro_torch import bridge
    from repro_torch.api import (ForgetRequest, QuantSpec, Unlearner,
                                 UnlearnSpec)
    from repro_torch.configs import get as get_arch
    from repro_torch.core import adapters
    from repro_torch.core.schedule import checkpoint_set
    from repro_torch.data import synthetic as syn
    from repro_torch.engine import plan_scanned_sweep
    from repro_torch.kernels import dampen as kd
    from repro_torch.models import layers as LY
    from repro_torch.models import lm as LM
    from repro_torch.models.module import tree_leaves
    from repro_torch.optim.compression import INT8_SWEEP_RTOL, q8_quantize

    t_phase = time.perf_counter()
    gib = 2.0 ** 30
    torch.cuda.reset_peak_memory_stats()
    full = get_arch(DENSE_ARCH).full
    cfg = full.with_(n_layers=DENSE_BLOCKS)
    t0 = time.perf_counter()
    params = LM.init_lm(torch.Generator(device=dev).manual_seed(SEED), cfg,
                        device="cuda")
    adapter = adapters.lm_adapter(cfg, LM_SEQ, device="cuda")
    torch.cuda.synchronize()
    L = adapter.n_layers
    stored = bridge.paths(params)
    n_params = sum(t.numel() for t in stored.values())
    layers = [tree_leaves(adapter.get_layer(params, j)) for j in range(L)]
    layer_leaves = [len(ls) for ls in layers]
    n_leaves = sum(layer_leaves)
    log(f"[dense] {cfg.name} at full width and {cfg.n_layers} of its "
        f"{full.n_layers} blocks ({cfg.block_pattern}, d_model {cfg.d_model},"
        f" {cfg.n_heads} heads / {cfg.n_kv_heads} KV of {cfg.dh}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}, RoPE theta {cfg.rope_theta}, "
        f"untied, {cfg.param_dtype}) from torch.Generator('cuda') seed {SEED}"
        f" in {time.perf_counter() - t0:.1f} s: {n_params} parameters in "
        f"{len(stored)} stored leaves; {n_leaves} layer leaves in {L} unlearn"
        f" layers")
    got = (n_params, len(stored), n_leaves, L)
    if got != DENSE_WANT:
        raise AssertionError(f"{cfg.name}: {got} (parameters, stored leaves,"
                             f" layer leaves, layers), expected {DENSE_WANT}")

    # the group kernels on this model's distinct layer tables (the
    # embedding, a block with its [4096, 512] K/V projections, the head),
    # before the path's counters are zeroed
    shapes = list(dict.fromkeys(tuple(tuple(t.shape) for t in ls)
                                for ls in layers))
    t0 = time.perf_counter()
    gcases, gerr = check_group_kernels_against_plain(
        [list(s) for s in shapes], dev, edges=False, whole=False)
    log(f"[dense] grouped dampen and dampen_int8 over its {len(shapes)} "
        f"distinct layer tables x f32/bf16/int8 x 3 pairs: bit-identical to "
        f"their plain versions, selection count, launch and leaf counters "
        f"included, in {gcases} tables, max |err| {gerr} "
        f"({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()

    def domains(seq_len, n):
        toks, doms = syn.make_lm_domains(syn.LMDataConfig(
            vocab=LM_DATA_VOCAB, n_domains=4, seq_len=seq_len,
            n_per_domain=n, seed=SEED))
        return syn.lm_split_forget_retain(toks, doms, LM_FORGET)

    def request(seqs, tag):
        inputs = torch.as_tensor(seqs[:, :-1], device=dev).long().contiguous()
        with torch.no_grad():
            labels = LM.forward(params, cfg, inputs)[0].argmax(-1)
        return ForgetRequest(inputs, labels, tag=tag)

    split, lsplit = domains(LM_SEQ, 8), domains(DENSE_LONG_SEQ, 4)
    t_data = time.perf_counter() - t0
    req = request(split["forget"][:8], LM_FORGET)
    retain = request(split["retain"][:4], "retain")
    long_req = request(lsplit["forget"][:4], f"{LM_FORGET} long")
    log(f"[dense] 8 sequences of S = {LM_SEQ} and 4 of S = {DENSE_LONG_SEQ} "
        f"tokens of domain {LM_FORGET} (make_lm_domains, vocab "
        f"{LM_DATA_VOCAB}) in {t_data:.1f} s, their argmax labels in "
        f"{time.perf_counter() - t0 - t_data:.1f} s")

    def spec(mode, **kw):
        return UnlearnSpec.for_mode(mode, **{
            "alpha": 25.0, "lam": 1.0, "tau": -1.0, "checkpoint_every": 4,
            "chunk_size": 2, "use_kernel": True, **kw})

    lssd = Unlearner(adapter, spec=spec("ssd"), device="cuda")
    t0 = time.perf_counter()
    lssd.ensure_fisher(lambda p, b: LM.lm_loss(p, cfg, b[0], b[1]), params,
                       (retain.inputs, retain.labels), chunk_size=2)
    torch.cuda.synchronize()
    fisher = lssd.fisher_global
    log(f"[dense] ensure_fisher on 4 retain sequences (chunk 2) in "
        f"{time.perf_counter() - t0:.1f} s; peak "
        f"{torch.cuda.max_memory_allocated() / gib:.2f} GiB")
    before = {k: v.clone() for k, v in stored.items()}
    cps = checkpoint_set(L, 4)
    plan = plan_scanned_sweep(adapter, params, req.inputs)
    if plan is None or plan.kinds != (("blk", "attn"),):
        raise AssertionError(f"{cfg.name}: scanned plan {plan}")
    runs = {}
    guarded_calls = [0]

    def serve(name, unl, path, *, request=req, want="layerwise", keep=False):
        """One request, checked: one launch of its precision's dampen kernel
        per layer swept (every layer for a scanned program), over that
        layer's leaves, none of the other's; the sweep mode asked for;
        every parameter finite."""
        c0 = dampen_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        new, st = unl.forget(request, params=params)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        dc = tuple(b - a for a, b in zip(c0, dampen_counts()))
        mine, other = (dc[:2], dc[2:]) if path == "fp32" else (dc[2:], dc[:2])
        eng = st["engine"]
        stop = L if eng["sweep_mode"] == "scanned" else st["stopped_at_l"]
        want_l = (stop, sum(layer_leaves[L - l] for l in range(1, stop + 1)))
        log(f"[dense] {path} {name:22s}: stopped_at_l={st['stopped_at_l']} "
            f"checkpoints={st['checkpoints_hit']} macs_vs_ssd_pct="
            f"{round(st['macs_vs_ssd_pct'], 4)} {eng['sweep_mode']}, launches "
            f"{mine[0]} over {mine[1]} leaves, builds={eng['compiles']} "
            f"hits={eng['cache_hits']} wall={secs * 1e3:.1f} ms, peak "
            f"{torch.cuda.max_memory_allocated() / gib:.2f} GiB")
        if (mine != want_l or other != (0, 0) or eng["precision"] != path
                or eng["sweep_mode"] != want):
            raise AssertionError(f"dense {path} {name}: {eng}, launches {dc},"
                                 f" expected {want_l} in {path}")
        if not all(torch.isfinite(t).all() for t in tree_leaves(new)):
            raise AssertionError(f"dense {path} {name}: non-finite "
                                 f"parameters")
        runs[(path, name)] = (new if keep else None, st, mine, secs)
        return new, st

    stat_keys = ("stopped_at_l", "checkpoints_hit", "selected_per_layer",
                 "forget_acc_trace", "macs", "macs_ssd", "macs_vs_ssd_pct")

    def same_as(new, st, path, name):
        """The request ``(new, st)`` == the kept request ``name``, bit for
        bit on every stored leaf and in its stats."""
        want_new, want_st = runs[(path, name)][:2]
        a, b = bridge.paths(new), bridge.paths(want_new)
        diff = [k for k in stat_keys if st[k] != want_st[k]] + [
            k for k in a if not torch.equal(bits(a[k]), bits(b[k]))]
        if diff:
            raise AssertionError(f"dense {path}: != {name} at {diff}")

    def drop(path, name):
        runs[(path, name)] = (None,) + runs[(path, name)][1:]
        torch.cuda.empty_cache()

    def kernel_equals_plain(path, name, **kw):
        p_plain, st = lssd.with_spec(spec("ssd", use_kernel=False, **kw)
                                     ).forget(req, params=params)
        same_as(p_plain, st, path, name)
        log(f"[dense] {path} {name}: the forget with the kernel == the plain "
            f"forget, bit for bit, all {len(stored)} stored leaves")

    zero_counts()                                  # the [dense] path starts
    serve("ssd cold", lssd, "fp32")
    _, st_ssd = serve("ssd warm", lssd, "fp32", keep=True)
    _, st_nh = serve("ficabu tau=-1", lssd.with_spec(spec("ficabu")), "fp32")
    if st_ssd["stopped_at_l"] != L or st_nh["stopped_at_l"] != L \
            or st_nh["checkpoints_hit"] != cps:
        raise AssertionError(f"dense ssd stopped at {st_ssd['stopped_at_l']},"
                             f" ficabu tau=-1 at {st_nh['stopped_at_l']} "
                             f"through {st_nh['checkpoints_hit']}")
    trace = st_nh["forget_acc_trace"]
    tau = trace[len(trace) // 2][1]
    ficabu = lssd.with_spec(spec("ficabu", tau=tau))
    serve("ficabu cold", ficabu, "fp32")
    _, st_h = serve("ficabu warm", ficabu, "fp32")
    log(f"[dense] ficabu tau=-1 forget-accuracy trace {trace}; the halting "
        f"request's tau {tau} (the trace at its middle checkpoint): stopped "
        f"at l = {st_h['stopped_at_l']} of {L}")
    if not st_h["stopped_at_l"] < L:
        raise AssertionError("dense ficabu did not halt partway")
    for name in ("ssd warm", "ficabu warm"):
        if runs[("fp32", name)][1]["engine"]["compiles"] != 0:
            raise AssertionError(f"dense {name} request built steps")
    # scanned: one program for the whole walk, == the layerwise request
    scan = lssd.with_spec(spec("ssd", sweep_mode="scanned"))
    new, st = serve("ssd scanned cold", scan, "fp32", want="scanned")
    same_as(new, st, "fp32", "ssd warm")
    guard_syncs(scan, guarded_calls)
    new, st = serve("ssd scanned warm", scan, "fp32", want="scanned")
    same_as(new, st, "fp32", "ssd warm")
    if st["engine"]["compiles"] != 0 or guarded_calls[0] != 1:
        raise AssertionError(f"dense scanned warm: {st['engine']}, "
                             f"{guarded_calls[0]} guarded program calls")
    del new
    log(f"[dense] scanned ssd, cold and warm (its program call under "
        f"set_sync_debug_mode('error')) == the layerwise request bit for "
        f"bit (all {len(stored)} stored leaves and stats); plan kinds "
        f"{plan.kinds}")
    kernel_equals_plain("fp32", "ssd warm")
    # int8 ssd, cold and warm: every leaf on its q8 grid, per layer within
    # INT8_SWEEP_RTOL of the fp32 request
    int8_kw = {"precision": "int8", "quant": QuantSpec()}
    lssd8 = lssd.with_spec(spec("ssd", **int8_kw))
    serve("ssd cold", lssd8, "int8")
    new8, st8 = serve("ssd warm", lssd8, "int8", keep=True)
    if st8["engine"]["compiles"] != 0:
        raise AssertionError("dense int8 ssd warm request built steps")
    if not lm_on_q8_grid(adapter, new8, params, st8["stopped_at_l"]):
        raise AssertionError("dense int8 ssd: a leaf left its q8 grid")
    rel = layer_rel_l2(adapter, new8, runs[("fp32", "ssd warm")][0])
    log(f"[dense] int8 ssd vs fp32 ssd: every leaf on its q8 grid; per-layer "
        f"relative L2 (j = 0..{L - 1}) {[round(r, 6) for r in rel]}")
    if not all(0.0 < r <= INT8_SWEEP_RTOL for r in rel):
        raise AssertionError(f"dense int8 ssd: per-layer error {rel} outside"
                             f" (0, {INT8_SWEEP_RTOL}]")
    del new8
    drop("fp32", "ssd warm")
    kernel_equals_plain("int8", "ssd warm", **int8_kw)
    drop("int8", "ssd warm")

    # the long request: 4 x 2048 tokens, every block's attention chunked,
    # layerwise cold and warm, then scanned cold and warm (== layerwise)
    ladapter = adapters.lm_adapter(cfg, DENSE_LONG_SEQ, device="cuda")
    lunl = Unlearner(ladapter, fisher, spec("ssd"), device="cuda")
    torch.cuda.reset_peak_memory_stats()
    serve("long ssd cold", lunl, "fp32", request=long_req)
    _, st_long = serve("long ssd warm", lunl, "fp32", request=long_req,
                       keep=True)
    long_peak = torch.cuda.max_memory_allocated() / gib
    lscan = lunl.with_spec(spec("ssd", sweep_mode="scanned"))
    new, st = serve("long ssd scanned cold", lscan, "fp32", request=long_req,
                    want="scanned")
    same_as(new, st, "fp32", "long ssd warm")
    guard_syncs(lscan, guarded_calls)
    new, st = serve("long ssd scanned warm", lscan, "fp32", request=long_req,
                    want="scanned")
    same_as(new, st, "fp32", "long ssd warm")
    if (st_long["stopped_at_l"], st_long["engine"]["compiles"],
            st["engine"]["compiles"], guarded_calls[0]) != (L, 0, 0, 2):
        raise AssertionError(f"dense long: stopped at "
                             f"{st_long['stopped_at_l']}, builds "
                             f"{st_long['engine']['compiles']} / "
                             f"{st['engine']['compiles']}, "
                             f"{guarded_calls[0]} guarded program calls")
    del new
    drop("fp32", "long ssd warm")
    log(f"[dense] long request ({long_req.inputs.shape[0]} x "
        f"{DENSE_LONG_SEQ} tokens, query-chunked attention in every block): "
        f"macs {st_long['macs']}, torch.cuda.max_memory_allocated "
        f"{long_peak:.2f} GiB over its layerwise requests; scanned cold and "
        f"warm (under set_sync_debug_mode('error')) == layerwise bit for bit")
    path_counts = dampen_counts()                   # the [dense] path ends
    if fisher_counts() != (0, 0, 0, 0):
        raise AssertionError(f"dense requests launched fimd/gemm/rowscale "
                             f"{fisher_counts()}")
    for k, t in stored.items():
        if not torch.equal(bits(t), bits(before[k])):
            raise AssertionError(f"dense: a request edited the caller's {k}")
    del before
    into = time.perf_counter() - t_phase
    log(f"[dense] the caller's tree unchanged after every request; dampen "
        f"counters over the path {path_counts} ({into:.1f} s into the "
        f"phase)")

    # the chunked attention against one block over all 2048 queries, on the
    # q/k/v of the middle block of the long request (f32 outputs)
    j_mid = DENSE_BLOCKS // 2 + 1
    with torch.no_grad():
        x = long_req.inputs[:1]
        x = ladapter.apply_layer(params, 0, params["embed"], x)
        for j in range(1, j_mid):
            x = ladapter.apply_layer(params, j, adapter.get_layer(params, j),
                                     x)
        blk = adapter.get_layer(params, j_mid)
        acfg = cfg.attn_cfg("attn")
        pos = LM._positions(x)
        q, k, v = LY._qkv(blk["mixer"], acfg, LY.rmsnorm(blk["ln1"], x))
        q = LY.apply_rope(q, pos, acfg.rope_theta)
        k = LY.apply_rope(k, pos, acfg.rope_theta)
        chunked = LY._sdpa(q, k, v, torch.float32, True, 0)
        whole = LY._sdpa_block(q, k, v, torch.float32, True, 0)
        attn_rel = float((chunked - whole).abs().max() / whole.abs().max())
        attn_same = bool(torch.equal(bits(chunked), bits(whole)))
        same16 = bool(torch.equal(
            bits(LY._sdpa(q, k, v, x.dtype, True, 0)),
            bits(LY._sdpa_block(q, k, v, x.dtype, True, 0))))
    log(f"[dense] block {j_mid}'s attention over {DENSE_LONG_SEQ} queries, "
        f"one sequence of the long request: query-chunked (4 blocks of "
        f"{LY.Q_CHUNK}) vs one block, f32 outputs: max |diff| / max |out| "
        f"{attn_rel:.3e}, bit-identical {attn_same}; in bf16 bit-identical "
        f"{same16}")
    del x, q, k, v, chunked, whole

    # where a warm ssd request spends its time: its wall from the warm
    # request above, the device's from one more under the profiler (the
    # device activity alone)
    prof = {}
    for path, unl in (("fp32", lssd), ("int8", lssd8)):
        wall = runs[(path, "ssd warm")][3] * 1e3
        t0 = time.perf_counter()
        busy, n_kernels, ranked = profile_request(
            lambda: unl.forget(req, params=params))
        damp = [(ms, count) for name, ms, count in ranked
                if "dampen_group_kernel" in name]
        prof[path] = (wall, busy, n_kernels)
        log(f"[profile] warm yi-6b {path} ssd request: wall {wall:.2f} ms, "
            f"device busy {busy:.3f} ms, idle share {1 - busy / wall:.3f}, "
            f"{n_kernels} device kernels, of them {sum(c for _, c in damp)} "
            f"dampen_group_kernel ({sum(ms for ms, _ in damp):.4f} ms); "
            f"profiled in {time.perf_counter() - t0:.1f} s")
        for name, ms, count in ranked[:6]:
            log(f"[profile]   {ms:9.3f} ms  x{count:<6d} {name[:70]}")
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    tables = lm_tables(adapter, params, fisher, gen, dev)
    n_el = sum(t.numel() for ths, _, _ in tables for t in ths)

    def sweep(fn, tabs):
        for ths, i_fs, i_gs in tabs:
            fn(ths, i_fs, i_gs, 25.0, 1.0)

    tl = {"fp32": cuda_time_ms(lambda: sweep(kd.dampen_group_cuda, tables),
                               5, queue_ahead=True),
          "fp32_plain": cuda_time_ms(
              lambda: sweep(kd.dampen_group_ref, tables), 1,
              queue_ahead=True)}
    tables = [([q8_quantize(th)[0] for th in ths], i_fs, i_gs)
              for ths, i_fs, i_gs in tables]
    tl["int8"] = cuda_time_ms(lambda: sweep(kd.dampen_int8_group_cuda,
                                            tables), 5, queue_ahead=True)
    tl["int8_plain"] = cuda_time_ms(
        lambda: sweep(kd.dampen_int8_group_ref, tables), 1, queue_ahead=True)
    del tables
    # bf16 theta: 2 + 4 + 4 read, 2 + 1 written; int8 codes: 1 + 4 + 4
    # read, 1 + 1 written; and each layer's 8-byte count
    lbound = {"fp32": (n_el * 13 + 8 * L) / rate * 1e3,
              "int8": (n_el * 11 + 8 * L) / rate * 1e3}
    for kernel, path in (("dampen", "fp32"), ("dampen_int8", "int8")):
        share = lbound[path] / tl[path] * 100
        log(f"[time] {kernel} yi-6b sweep device ({L} grouped launches, "
            f"{n_el} elements, {'bf16 theta' if path == 'fp32' else 'int8'} "
            f"): kernel {tl[path]:.5f} ms, plain {tl[path + '_plain']:.5f} "
            f"ms, bound {lbound[path]:.5f} ms ({share:.1f}% of the memory "
            f"bound)")
    peak = torch.cuda.max_memory_allocated() / gib
    secs = time.perf_counter() - t_phase
    log(f"[dense] phase done in {secs:.1f} s; torch.cuda.max_memory_allocated"
        f" {peak:.2f} GiB since the long request")
    out = {}
    for path in ("fp32", "int8"):
        out[path] = {
            "dense_launches": path_counts[0 if path == "fp32" else 2],
            "dense_leaves": path_counts[1 if path == "fp32" else 3],
            "dense_launches_per_ssd_request": runs[(path, "ssd warm")][2][0],
            "dense_leaves_per_ssd_request": runs[(path, "ssd warm")][2][1],
            "dense_sweep_ms": tl[path],
            "dense_sweep_plain_ms": tl[path + "_plain"],
            "dense_sweep_bound_ms": lbound[path],
            "dense_warm_ssd_wall_ms": prof[path][0],
            "dense_warm_ssd_device_busy_ms": prof[path][1],
            "dense_warm_ssd_device_kernels": prof[path][2],
        }
    out["fp32"].update({
        "dense_scanned_ssd_launches_leaves": list(
            runs[("fp32", "ssd scanned warm")][2]),
        "dense_long_ssd_launches_leaves": list(
            runs[("fp32", "long ssd warm")][2]),
        "dense_long_ssd_warm_wall_ms": runs[("fp32", "long ssd warm")][3]
        * 1e3,
        "dense_long_peak_gib": long_peak,
        "dense_long_attention_chunked_rel_diff": attn_rel,
        "dense_long_attention_chunked_bit_identical": attn_same,
        "dense_phase_seconds": secs})
    del params, fisher, lssd, lssd8, lunl, lscan, scan, ficabu, runs, stored
    del layers
    torch.cuda.empty_cache()
    return out, gerr


# the [qwen] phase: qwen1.5-32b at full width (d_model 5120, 40 heads over
# 40 KV heads of 128 with q/k/v biases under RoPE, d_ff 27,392, vocabulary
# 152,064, untied) and 2 of its 64 blocks: two 778.6 M embedding and head
# matrices and 525.6 M a block, 5.2 GB in bf16 and a 10.4 GB f32 Fisher.
# Its expected (parameters, stored leaves, layer leaves, unlearn layers),
# its alpha (as yi-6b's and gemma3-1b's) and checkpoints every 2 layers
# (l = 1, 2, 4: the halting request's tau is read at l = 2). [dryrun]
# serves its decode cell on these weights
QWEN_ARCH = "qwen1.5-32b"
QWEN_BLOCKS = 2
QWEN_WANT = (2_608_389_120, 15, 27, 4)
QWEN_ALPHA = 25.0


def qwen_phase(dev, rate, zero_counts, dampen_counts, fisher_counts, keep):
    """[qwen]: qwen1.5-32b at full width and QWEN_BLOCKS blocks through
    ``Unlearner.forget``: ssd in fp32 and int8 (8 x 1024 tokens at chunk
    2), a halting ficabu with the kernel against the plain one, kernel ==
    plain, the group kernels on its tables. Leaves its weights in
    ``keep`` for [dryrun]. Returns the kernels line's figures and the
    largest |err| per kernel."""
    from repro_torch import bridge
    from repro_torch.api import (ForgetRequest, QuantSpec, Unlearner,
                                 UnlearnSpec)
    from repro_torch.configs import get as get_arch
    from repro_torch.core import adapters
    from repro_torch.core.schedule import checkpoint_set
    from repro_torch.data import synthetic as syn
    from repro_torch.kernels import dampen as kd
    from repro_torch.models import lm as LM
    from repro_torch.models.module import tree_leaves
    from repro_torch.optim.compression import INT8_SWEEP_RTOL, q8_quantize

    t_phase = time.perf_counter()
    gib = 2.0 ** 30
    torch.cuda.reset_peak_memory_stats()
    full = get_arch(QWEN_ARCH).full
    cfg = full.with_(n_layers=QWEN_BLOCKS)
    t0 = time.perf_counter()
    params = LM.init_lm(torch.Generator(device=dev).manual_seed(SEED), cfg,
                        device="cuda")
    adapter = adapters.lm_adapter(cfg, LM_SEQ, device="cuda")
    torch.cuda.synchronize()
    L = adapter.n_layers
    stored = bridge.paths(params)
    n_params = sum(t.numel() for t in stored.values())
    layers = [tree_leaves(adapter.get_layer(params, j)) for j in range(L)]
    layer_leaves = [len(ls) for ls in layers]
    n_leaves = sum(layer_leaves)
    log(f"[qwen] {cfg.name} at full width and {cfg.n_layers} of its "
        f"{full.n_layers} blocks (d_model {cfg.d_model}, {cfg.n_heads} heads"
        f" / {cfg.n_kv_heads} KV of {cfg.dh}, q/k/v biases {cfg.qkv_bias} "
        f"under RoPE theta {cfg.rope_theta}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}, untied, {cfg.param_dtype}) from torch.Generator("
        f"'cuda') seed {SEED} in {time.perf_counter() - t0:.1f} s: "
        f"{n_params} parameters in {len(stored)} stored leaves; {n_leaves} "
        f"layer leaves in {L} unlearn layers")
    got = (n_params, len(stored), n_leaves, L)
    if got != QWEN_WANT:
        raise AssertionError(f"{cfg.name}: {got} (parameters, stored leaves,"
                             f" layer leaves, layers), expected {QWEN_WANT}")

    # the group kernels on its distinct layer tables (the embedding, a
    # block with its q/k/v biases, the head), before the path's counters
    # are zeroed
    shapes = list(dict.fromkeys(tuple(tuple(t.shape) for t in ls)
                                for ls in layers))
    t0 = time.perf_counter()
    gcases, gerr = check_group_kernels_against_plain(
        [list(s) for s in shapes], dev, edges=False, whole=False)
    log(f"[qwen] grouped dampen and dampen_int8 over its {len(shapes)} "
        f"distinct layer tables x f32/bf16/int8 x 3 pairs: bit-identical to "
        f"their plain versions, selection count, launch and leaf counters "
        f"included, in {gcases} tables, max |err| {gerr} "
        f"({time.perf_counter() - t0:.1f} s)")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    toks, doms = syn.make_lm_domains(syn.LMDataConfig(
        vocab=LM_DATA_VOCAB, n_domains=4, seq_len=LM_SEQ, n_per_domain=8,
        seed=SEED))
    split = syn.lm_split_forget_retain(toks, doms, LM_FORGET)

    def request(seqs, tag):
        inputs = torch.as_tensor(seqs[:, :-1], device=dev).long().contiguous()
        with torch.no_grad():
            labels = LM.forward(params, cfg, inputs)[0].argmax(-1)
        return ForgetRequest(inputs, labels, tag=tag)

    req = request(split["forget"][:8], LM_FORGET)
    retain = request(split["retain"][:4], "retain")
    log(f"[qwen] 8 forget and 4 retain sequences of S = {LM_SEQ} tokens "
        f"(make_lm_domains, vocab {LM_DATA_VOCAB}) with their argmax labels "
        f"in {time.perf_counter() - t0:.1f} s")

    def spec(mode, **kw):
        return UnlearnSpec.for_mode(mode, **{
            "alpha": QWEN_ALPHA, "lam": 1.0, "tau": -1.0,
            "checkpoint_every": 2, "chunk_size": 2, "use_kernel": True,
            **kw})

    lssd = Unlearner(adapter, spec=spec("ssd"), device="cuda")
    t0 = time.perf_counter()
    lssd.ensure_fisher(lambda p, b: LM.lm_loss(p, cfg, b[0], b[1]), params,
                       (retain.inputs, retain.labels), chunk_size=2)
    torch.cuda.synchronize()
    fisher = lssd.fisher_global
    log(f"[qwen] ensure_fisher on 4 retain sequences (chunk 2) in "
        f"{time.perf_counter() - t0:.1f} s; peak "
        f"{torch.cuda.max_memory_allocated() / gib:.2f} GiB")
    before = {k: v.clone() for k, v in stored.items()}
    runs = {}
    stat_keys = ("stopped_at_l", "checkpoints_hit", "selected_per_layer",
                 "forget_acc_trace", "macs", "macs_ssd", "macs_vs_ssd_pct")

    def serve(name, unl, path, *, keep_new=False, kernel=True):
        """One request, checked: with the kernel one launch of its
        precision's dampen kernel per layer swept, over that layer's
        leaves, none of the other's (none at all for the plain one);
        every parameter finite."""
        c0 = dampen_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        new, st = unl.forget(req, params=params)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        dc = tuple(b - a for a, b in zip(c0, dampen_counts()))
        mine, other = (dc[:2], dc[2:]) if path == "fp32" else (dc[2:], dc[:2])
        stop = st["stopped_at_l"]
        want_l = ((stop, sum(layer_leaves[L - l] for l in range(1, stop + 1)))
                  if kernel else (0, 0))
        log(f"[qwen] {path} {name:22s}: stopped_at_l={stop} checkpoints="
            f"{st['checkpoints_hit']} macs_vs_ssd_pct="
            f"{round(st['macs_vs_ssd_pct'], 4)}, launches {mine[0]} over "
            f"{mine[1]} leaves, builds={st['engine']['compiles']} hits="
            f"{st['engine']['cache_hits']} wall={secs * 1e3:.1f} ms, peak "
            f"{torch.cuda.max_memory_allocated() / gib:.2f} GiB")
        if (mine != want_l or other != (0, 0)
                or st["engine"]["precision"] != path):
            raise AssertionError(f"qwen {path} {name}: {st['engine']}, "
                                 f"launches {dc}, expected {want_l}")
        if not all(torch.isfinite(t).all() for t in tree_leaves(new)):
            raise AssertionError(f"qwen {path} {name}: non-finite "
                                 f"parameters")
        runs[(path, name)] = (new if keep_new else None, st, mine, secs)
        return new, st

    def same_as(new, st, path, name):
        want_new, want_st = runs[(path, name)][:2]
        a, b = bridge.paths(new), bridge.paths(want_new)
        diff = [k for k in stat_keys if st[k] != want_st[k]] + [
            k for k in a if not torch.equal(bits(a[k]), bits(b[k]))]
        if diff:
            raise AssertionError(f"qwen {path}: != {name} at {diff}")

    def drop(path, name):
        runs[(path, name)] = (None,) + runs[(path, name)][1:]
        torch.cuda.empty_cache()

    zero_counts()                                   # the [qwen] path starts
    serve("ssd cold", lssd, "fp32")
    _, st_ssd = serve("ssd warm", lssd, "fp32", keep_new=True)
    if st_ssd["stopped_at_l"] != L or st_ssd["engine"]["compiles"] != 0:
        raise AssertionError(f"qwen ssd warm: stopped at "
                             f"{st_ssd['stopped_at_l']}, built "
                             f"{st_ssd['engine']['compiles']} steps")
    new, st = serve("ssd plain", lssd.with_spec(spec("ssd",
                                                     use_kernel=False)),
                    "fp32", kernel=False)
    same_as(new, st, "fp32", "ssd warm")
    del new
    log(f"[qwen] fp32 ssd: the forget with the kernel == the plain forget, "
        f"bit for bit, all {len(stored)} stored leaves and the stats")
    _, st_nh = serve("ficabu tau=-1", lssd.with_spec(spec("ficabu")), "fp32")
    cps = checkpoint_set(L, 2)
    if st_nh["stopped_at_l"] != L or st_nh["checkpoints_hit"] != cps:
        raise AssertionError(f"qwen ficabu tau=-1 stopped at "
                             f"{st_nh['stopped_at_l']} through "
                             f"{st_nh['checkpoints_hit']}")
    trace = st_nh["forget_acc_trace"]
    tau = trace[len(trace) // 2][1]
    serve("ficabu halting", lssd.with_spec(spec("ficabu", tau=tau)), "fp32",
          keep_new=True)
    new, st_hp = serve("ficabu halting plain", lssd.with_spec(
        spec("ficabu", tau=tau, use_kernel=False)), "fp32", kernel=False)
    same_as(new, st_hp, "fp32", "ficabu halting")
    del new
    st_h = runs[("fp32", "ficabu halting")][1]
    log(f"[qwen] ficabu tau=-1 forget-accuracy trace {trace}; tau {tau}: "
        f"the kernel request and the plain one both stopped at l = "
        f"{st_h['stopped_at_l']} of {L} with macs {st_h['macs']} (ssd "
        f"{st_h['macs_ssd']}), bit for bit")
    if not st_h["stopped_at_l"] < L:
        raise AssertionError("qwen ficabu did not halt partway")
    drop("fp32", "ficabu halting")
    # int8 ssd, cold and warm: every leaf on its q8 grid, per layer within
    # INT8_SWEEP_RTOL of the fp32 request; then kernel == plain
    int8_kw = {"precision": "int8", "quant": QuantSpec()}
    lssd8 = lssd.with_spec(spec("ssd", **int8_kw))
    serve("ssd cold", lssd8, "int8")
    new8, st8 = serve("ssd warm", lssd8, "int8", keep_new=True)
    if st8["engine"]["compiles"] != 0:
        raise AssertionError("qwen int8 ssd warm request built steps")
    if not lm_on_q8_grid(adapter, new8, params, st8["stopped_at_l"]):
        raise AssertionError("qwen int8 ssd: a leaf left its q8 grid")
    rel = layer_rel_l2(adapter, new8, runs[("fp32", "ssd warm")][0])
    log(f"[qwen] int8 ssd vs fp32 ssd: every leaf on its q8 grid; per-layer "
        f"relative L2 (j = 0..{L - 1}) {[round(r, 6) for r in rel]}")
    if not all(0.0 < r <= INT8_SWEEP_RTOL for r in rel):
        raise AssertionError(f"qwen int8 ssd: per-layer error {rel} outside "
                             f"(0, {INT8_SWEEP_RTOL}]")
    del new8
    drop("fp32", "ssd warm")
    new, st = serve("ssd plain", lssd.with_spec(spec(
        "ssd", use_kernel=False, **int8_kw)), "int8", kernel=False)
    same_as(new, st, "int8", "ssd warm")
    del new
    drop("int8", "ssd warm")
    log(f"[qwen] int8 ssd: the forget with the kernel == the plain forget, "
        f"bit for bit, all {len(stored)} stored leaves and the stats")
    path_counts = dampen_counts()                   # the [qwen] path ends
    if fisher_counts() != (0, 0, 0, 0):
        raise AssertionError(f"qwen requests launched fimd/gemm/rowscale "
                             f"{fisher_counts()}")
    for k, t in stored.items():
        if not torch.equal(bits(t), bits(before[k])):
            raise AssertionError(f"qwen: a request edited the caller's {k}")
    del before
    request_peak = torch.cuda.max_memory_allocated() / gib
    log(f"[qwen] the caller's tree unchanged after every request; dampen "
        f"counters over the path {path_counts}; torch.cuda."
        f"max_memory_allocated {request_peak:.2f} GiB "
        f"({time.perf_counter() - t_phase:.1f} s into the phase)")

    # where a warm ssd request spends its time: its wall from the warm
    # request above, the device's from one more under the profiler
    prof = {}
    for path, unl in (("fp32", lssd), ("int8", lssd8)):
        wall = runs[(path, "ssd warm")][3] * 1e3
        t0 = time.perf_counter()
        busy, n_kernels, ranked = profile_request(
            lambda: unl.forget(req, params=params))
        damp = [(ms, count) for name, ms, count in ranked
                if "dampen_group_kernel" in name]
        prof[path] = (wall, busy, n_kernels)
        log(f"[profile] warm qwen1.5-32b {path} ssd request: wall "
            f"{wall:.2f} ms, device busy {busy:.3f} ms, idle share "
            f"{1 - busy / wall:.3f}, {n_kernels} device kernels, of them "
            f"{sum(c for _, c in damp)} dampen_group_kernel "
            f"({sum(ms for ms, _ in damp):.4f} ms); profiled in "
            f"{time.perf_counter() - t0:.1f} s")
        for name, ms, count in ranked[:6]:
            log(f"[profile]   {ms:9.3f} ms  x{count:<6d} {name[:70]}")
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    tables = lm_tables(adapter, params, fisher, gen, dev)
    n_el = sum(t.numel() for ths, _, _ in tables for t in ths)

    def sweep(fn, tabs):
        for ths, i_fs, i_gs in tabs:
            fn(ths, i_fs, i_gs, QWEN_ALPHA, 1.0)

    tl = {"fp32": cuda_time_ms(lambda: sweep(kd.dampen_group_cuda, tables),
                               5, queue_ahead=True),
          "fp32_plain": cuda_time_ms(
              lambda: sweep(kd.dampen_group_ref, tables), 1,
              queue_ahead=True)}
    tables = [([q8_quantize(th)[0] for th in ths], i_fs, i_gs)
              for ths, i_fs, i_gs in tables]
    tl["int8"] = cuda_time_ms(lambda: sweep(kd.dampen_int8_group_cuda,
                                            tables), 5, queue_ahead=True)
    tl["int8_plain"] = cuda_time_ms(
        lambda: sweep(kd.dampen_int8_group_ref, tables), 1, queue_ahead=True)
    del tables
    # bf16 theta: 2 + 4 + 4 read, 2 + 1 written; int8 codes: 1 + 4 + 4
    # read, 1 + 1 written; and each layer's 8-byte count
    lbound = {"fp32": (n_el * 13 + 8 * L) / rate * 1e3,
              "int8": (n_el * 11 + 8 * L) / rate * 1e3}
    for kernel, path in (("dampen", "fp32"), ("dampen_int8", "int8")):
        share = lbound[path] / tl[path] * 100
        log(f"[time] {kernel} qwen1.5-32b sweep device ({L} grouped "
            f"launches, {n_el} elements, "
            f"{'bf16 theta' if path == 'fp32' else 'int8'}): kernel "
            f"{tl[path]:.5f} ms, plain {tl[path + '_plain']:.5f} ms, bound "
            f"{lbound[path]:.5f} ms ({share:.1f}% of the memory bound)")
    secs = time.perf_counter() - t_phase
    log(f"[qwen] phase done in {secs:.1f} s; torch.cuda.max_memory_allocated"
        f" {torch.cuda.max_memory_allocated() / gib:.2f} GiB")
    out = {}
    for path in ("fp32", "int8"):
        out[path] = {
            "qwen_launches": path_counts[0 if path == "fp32" else 2],
            "qwen_leaves": path_counts[1 if path == "fp32" else 3],
            "qwen_launches_per_ssd_request": runs[(path, "ssd warm")][2][0],
            "qwen_leaves_per_ssd_request": runs[(path, "ssd warm")][2][1],
            "qwen_sweep_ms": tl[path],
            "qwen_sweep_plain_ms": tl[path + "_plain"],
            "qwen_sweep_bound_ms": lbound[path],
            "qwen_warm_ssd_wall_ms": prof[path][0],
            "qwen_warm_ssd_device_busy_ms": prof[path][1],
            "qwen_warm_ssd_device_kernels": prof[path][2],
        }
    out["fp32"].update({
        "qwen_halting_ficabu_launches_leaves": list(
            runs[("fp32", "ficabu halting")][2]),
        "qwen_request_peak_gib": request_peak, "qwen_phase_seconds": secs})
    del fisher, lssd, lssd8, runs, stored, layers
    keep.update(params=params, cfg=cfg)
    del params
    torch.cuda.empty_cache()
    return out, gerr


def dryrun_phase(dev, card, zero_counts, dampen_counts, fisher_counts, keep):
    """[dryrun]: the launchers' cost model against the card. (a) the
    qwen1.5-32b decode_32k cell at 2 blocks: run_cell's terms at the
    card's peaks for one rank of the 16 x 16 mesh, and that rank's program
    (8 of 128 rows, one token against a 32,768-token cache) run on
    [qwen]'s weights, its device time beside the bound; (b) unlearn_cell's
    streamed and fused programs at one rank's share (4 of 64 rows x 4096
    tokens, one yi-6b attention block at full width), each timed beside
    its terms, streamed == fused, and the fused step replayed with the
    kernel bit for bit; (c) qwen1.5-32b x train_4k and hill-climb's
    qwen_fsdp counted on the host. Returns the kernels line's figures."""
    import dataclasses

    from repro_torch.configs import SHAPES
    from repro_torch.configs import get as get_arch
    from repro_torch.core.ssd import dampen_tree
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import hillclimb as HC
    from repro_torch.launch import specs as SP
    from repro_torch.launch import unlearn_cell as UC
    from repro_torch.launch.mesh import abstract_production_mesh
    from repro_torch.models import lm as LM
    from repro_torch.models.module import tree_leaves, tree_map

    t_phase = time.perf_counter()
    gib = 2.0 ** 30
    out = {}
    # (a) the decode cell
    params, cfg = keep["params"], keep["cfg"]
    over = {"n_layers": QWEN_BLOCKS}
    rec = DR.run_cell(QWEN_ARCH, "decode_32k", False, over, card=card)
    terms, cnt = rec["roofline"], rec["count"]
    spec = get_arch(QWEN_ARCH)
    spec = dataclasses.replace(spec, full=spec.full.with_(**over))
    if spec.full != cfg:
        raise AssertionError(f"[dryrun] the cell's config {spec.full} is not "
                             f"[qwen]'s {cfg}")
    cell = SP.build_cell(spec, "decode_32k", abstract_production_mesh())
    rows, S = cnt["rows_per_rank"], SHAPES["decode_32k"].seq_len
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    torch.cuda.reset_peak_memory_stats()
    cache = LM.init_cache(cfg, rows, S, device="cuda")
    cache = tree_map(lambda t: torch.randn(t.shape, generator=gen,
                                           device=dev).to(t.dtype), cache)
    token = torch.randint(0, cfg.vocab, (rows, 1), generator=gen, device=dev)
    cache_gb = sum(t.numel() * t.element_size()
                   for t in tree_leaves(cache)) / 1e9
    with torch.no_grad():
        logits, new_cache = cell.fn(params, cache, token, S - 1)
        torch.cuda.synchronize()
        ok = (tuple(logits.shape) == (rows, 1, cfg.vocab)
              and bool(torch.isfinite(logits).all())
              and all(bool(torch.isfinite(t).all())
                      for t in tree_leaves(new_cache)))
        del new_cache
        ms = cuda_time_ms(lambda: cell.fn(params, cache, token, S - 1), 3)
    if not ok:
        raise AssertionError("[dryrun] the decode cell's logits or cache are "
                             "not finite or not [rows, 1, vocab]")
    peak = torch.cuda.max_memory_allocated() / gib
    bound = terms["step_time_bound_s"] * 1e3
    device_bound = max(terms["compute_s"], terms["memory_s"]) * 1e3
    floor = terms["data_floor_s"] * 1e3
    log(f"[dryrun] {rec['arch']} x decode_32k at {QWEN_BLOCKS} blocks on the "
        f"{rec['mesh']} mesh, one rank ({rows} of 128 rows, one token against "
        f"a {S}-token cache of {cache_gb:.2f} GB, bf16): counted on the host "
        f"in {rec['compile_full_s']} s ({cnt['method']}, {cnt['ops']} ops): "
        f"{rec['cost']['flops']:.6e} FLOPs, {rec['cost']['bytes accessed']:.6e}"
        f" bytes, {rec['collectives']['bytes_per_device']} collective bytes; "
        f"at {card}'s peaks compute {terms['compute_s'] * 1e3:.4f} ms, memory "
        f"{terms['memory_s'] * 1e3:.4f} ms, collective "
        f"{terms['collective_s'] * 1e3:.4f} ms, dominant {terms['dominant']},"
        f" step_time_bound {bound:.4f} ms; data floor (the weights and the "
        f"cache read once, {rec['memory']['argument_size_in_bytes']} bytes) "
        f"{floor:.4f} ms")
    log(f"[dryrun] measured on the card: that rank's program on [qwen]'s "
        f"weights {ms:.4f} ms of device time (CUDA events, mean of 3) = "
        f"{ms / bound:.3f} x step_time_bound_s, {ms / device_bound:.3f} x "
        f"the larger of compute and memory (no collective runs on one "
        f"card), {ms / floor:.3f} x the data floor; logits [{rows}, 1, "
        f"{cfg.vocab}] finite; peak {peak:.2f} GiB")
    out["dryrun_decode_ms"] = ms
    out["dryrun_decode_bound_ms"] = bound
    out["dryrun_decode_data_floor_ms"] = floor
    out["dryrun_decode_terms_ms"] = {
        k: terms[k + "_s"] * 1e3 for k in ("compute", "memory",
                                           "collective")}
    del cache, token, logits
    keep.clear()
    del params
    torch.cuda.empty_cache()

    # (b) unlearn_cell at one rank's share
    t0 = time.perf_counter()
    pred = UC.run(card=card)
    ycfg = get_arch(UC.ARCH).full
    rows = pred["rows_per_rank"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    blk = LM.init_block(gen, ycfg, "attn", device=dev)
    act = torch.randn(rows, UC.SEQ, ycfg.d_model, generator=gen,
                      device=dev).to(torch.bfloat16)
    cot = (torch.randn(rows, UC.SEQ, ycfg.d_model, generator=gen,
                       device=dev) * 1e-3).to(torch.bfloat16)
    layer = UC.layer_fn(ycfg)
    grads, damp = UC.grads_program(layer), UC.dampen_program
    g_blk, g_act = grads(blk, act, cot)
    fish = UC.fimd_program(g_blk)
    # a global Fisher under the forget one: about half the entries pass
    # alpha = 10
    fish_g = tree_map(lambda f: f * torch.rand(f.shape, generator=gen,
                                               device=dev) * 0.2, fish)
    with torch.no_grad():
        new_s, masks = dampen_tree(blk, fish, fish_g, UC.SPEC.dampen.alpha,
                                   UC.SPEC.dampen.lam)
    n_s = int(sum(m.sum() for m in tree_leaves(masks)))
    step = UC.fused_program(layer)
    acts_c, cot_c = act[None], cot[None]
    new_f, g_act_f, n_f = step(None, blk, fish_g, acts_c, cot_c, UC.scalars())
    same = (all(torch.equal(bits(a), bits(b)) for a, b in
                zip(tree_leaves(new_s), tree_leaves(new_f)))
            and torch.equal(bits(g_act), bits(g_act_f[0]))
            and int(n_f) == n_s)
    log(f"[dryrun] unlearn_cell (yi-6b attention block, {rows} of "
        f"{UC.N_FORGET} rows x {UC.SEQ} tokens, alpha "
        f"{UC.SPEC.dampen.alpha}): streamed (vjp, squares, dampen_tree) == "
        f"fused (engine.build_fused_step) bit for bit on all "
        f"{len(tree_leaves(new_s))} leaves, the input cotangent and the "
        f"selection count ({n_s}): {same}")
    if not same:
        raise AssertionError("[dryrun] unlearn_cell: the streamed step and "
                             "the fused step differ")
    zero_counts()                                 # the [dryrun] path starts
    step_k = UC.fused_program(layer, use_kernel=True)
    new_k, g_act_k, n_k = step_k(None, blk, fish_g, acts_c, cot_c,
                                 UC.scalars())
    torch.cuda.synchronize()
    path_counts = dampen_counts()                 # the [dryrun] path ends
    n_blk = len(tree_leaves(blk))
    if path_counts != (1, n_blk, 0, 0) or fisher_counts() != (0, 0, 0, 0):
        raise AssertionError(f"[dryrun] the kernel replay launched "
                             f"{path_counts}, {fisher_counts()}")
    if not (all(torch.equal(bits(a), bits(b)) for a, b in
                zip(tree_leaves(new_k), tree_leaves(new_f)))
            and torch.equal(bits(g_act_k), bits(g_act_f))
            and int(n_k) == int(n_f)):
        raise AssertionError("[dryrun] the fused step with the kernel != "
                             "the plain fused step")
    log(f"[dryrun] the fused step replayed with use_kernel=True: dampen "
        f"{path_counts[0]} launch over {path_counts[1]} leaves, == the plain "
        f"step bit for bit (block, cotangent, count)")
    del new_s, masks, new_f, new_k, g_act_f, g_act_k
    t_ms = {
        "grads": cuda_time_ms(lambda: grads(blk, act, cot), 3),
        "fimd": cuda_time_ms(lambda: UC.fimd_program(g_blk), 3),
        "dampen": cuda_time_ms(lambda: damp(blk, fish, fish_g), 3),
        "fused": cuda_time_ms(lambda: step(None, blk, fish_g, acts_c, cot_c,
                                           UC.scalars()), 3),
        "fused_kernel": cuda_time_ms(lambda: step_k(
            None, blk, fish_g, acts_c, cot_c, UC.scalars()), 3)}
    t_ms["streamed"] = t_ms["grads"] + t_ms["fimd"] + t_ms["dampen"]
    parts = {"streamed": f"grads {t_ms['grads']:.4f} + fimd "
                         f"{t_ms['fimd']:.4f} + dampen {t_ms['dampen']:.4f}",
             "fused": f"with the kernel {t_ms['fused_kernel']:.4f}"}
    for name in ("streamed", "fused"):
        p = pred[name]
        b = max(p["compute_s"], p["memory_s"]) * 1e3
        log(f"[dryrun] unlearn_cell {name}: measured {t_ms[name]:.4f} ms of "
            f"device time (mean of 3; {parts[name]} ms); predicted at "
            f"{card}'s peaks: compute {p['compute_s'] * 1e3:.4f} ms, memory "
            f"{p['memory_s'] * 1e3:.4f} ms, collective "
            f"{p['collective_s'] * 1e3:.4f} ms ({p['flops']:.6e} FLOPs, "
            f"{p['bytes']:.6e} bytes); measured / max(compute, memory) "
            f"{t_ms[name] / b:.3f}")
    log(f"[dryrun] unlearn_cell speedup_memory_term (streamed / fused) "
        f"{pred['speedup_memory_term']:.4f} predicted, measured streamed / "
        f"fused {t_ms['streamed'] / t_ms['fused']:.4f} "
        f"({time.perf_counter() - t0:.1f} s)")
    out["dryrun_unlearn_cell_ms"] = t_ms
    out["dryrun_unlearn_cell_predicted"] = {
        name: {k: pred[name][k] for k in ("compute_s", "memory_s",
                                          "collective_s")}
        for name in ("streamed", "fused")}
    out["dryrun_fused_kernel_launches_leaves"] = list(path_counts[:2])
    del blk, act, cot, g_blk, g_act, fish, fish_g
    torch.cuda.empty_cache()

    # (c) one full-configuration cell on the host, hill-climb's beside it
    t0 = time.perf_counter()
    exp = HC.EXPERIMENTS["qwen_fsdp"]
    for name, over in (("baseline", None), ("qwen_fsdp", exp["overrides"])):
        r = DR.run_cell(exp["arch"], exp["shape"], False, over, card=card)
        t = r["roofline"]
        line = {"experiment": name, "overrides": over,
                "compile_full_s": r["compile_full_s"],
                "count": r["count"], "memory": r["memory"],
                "cost": r["cost"], "collectives": r["collectives"],
                **{k: t[k] for k in ("compute_s", "memory_s", "collective_s",
                                     "dominant", "useful_flops_ratio",
                                     "roofline_fraction",
                                     "step_time_bound_s")}}
        log(f"[dryrun] {exp['arch']} x {exp['shape']} {name}: "
            f"{json.dumps(line)}")
        out[f"dryrun_qwen_train_{name}_bound_s"] = t["step_time_bound_s"]
    host_s = time.perf_counter() - t0
    if host_s > 90:
        raise AssertionError(f"[dryrun] the host cells took {host_s:.1f} s")
    secs = time.perf_counter() - t_phase
    log(f"[dryrun] host cells in {host_s:.1f} s; phase done in {secs:.1f} s")
    out["dryrun_phase_seconds"] = secs
    return out


def moe_dispatches(adapter, cfg, params, inputs, chunk):
    """Each MoE block's dispatch of a request's tokens as the request makes
    it: over all its sequences (the collection) and over each vjp chunk of
    ``chunk`` sequences. Returns ([(block, call, top-1 experts, kept
    choices, capacity C)], [the aux loss of each block on the
    collection])."""
    from repro_torch.models import layers as LY
    from repro_torch.models import lm as LM

    mcfg = cfg.moe_cfg()
    calls, auxes = [], []
    with torch.no_grad():
        x = adapter.apply_layer(params, 0, params["embed"], inputs)
        for j in range(1, adapter.n_layers - 1):
            blk = adapter.get_layer(params, j)
            h = LY.rmsnorm(blk["ln1"], x)
            h = LY.rmsnorm(blk["ln2"], x + LY.attention(
                blk["mixer"], cfg.attn_cfg(cfg.layer_types[j - 1]), h,
                LM._positions(x)))
            for what, hc in [("collection", h)] + [
                    (f"chunk {i}", c) for i, c in enumerate(h.split(chunk))]:
                _, _, eidx, kept, _, C = LY.moe_dispatch(
                    blk["ffn"], mcfg, hc.reshape(1, -1, cfg.d_model))
                calls.append((j, what, eidx[..., 0], kept, C))
            auxes.append(float(LY.moe_ffn(blk["ffn"], mcfg, h)[1]))
            x = adapter.apply_layer(params, j, blk, x)
    return calls, auxes


# the [moe] phase: the MoE LM served at full width and the depth it is cut
# to, its expected (parameters, stored leaves, layer leaves, unlearn
# layers) and the sequences of a request. llama4-scout's blocks hold 2.2 B
# parameters each (2.0 B of them in 16 experts of d_ff 8192) beside a 2.07
# B embedding and head: 1 block holds 4.27 B parameters, 2 blocks 6.47 B
# and all 48 about 108 B, so more than one block would not fit one card
# with its f32 Fisher and a request's transients (PERF.md section 4). A
# request is 2 sequences at chunk 1: 4 at chunk 2 peaked at 76.03 GiB in
# the whole script (the int8 plain forget), past the 75 GiB line; two vjp
# chunks keep the collection's capacity apart from a chunk's. The phase
# takes alpha 800: its int8 ssd request reads 0.181 / 0.161 / 0.140 / 0.119
# against fp32 in the block at alpha 25 / 50 / 100 / 200, outside
# INT8_SWEEP_RTOL, 0.0998 at 400 and 0.0824 at 800 (tools/moe_int8.py;
# PERF.md section 7)
MOE_ARCH = "llama4-scout-17b-a16e"
MOE_BLOCKS = 1
MOE_WANT = (4_271_078_400, 16, 16, 3)
MOE_SEQS = 2
MOE_CHUNK = 1
MOE_ALPHA = 800.0


def moe_phase(dev, rate, zero_counts, dampen_counts, fisher_counts):
    """Phase 14, [moe]: the MoE LM at full width and a cut depth (module
    docstring). Returns the figures the kernels line carries and the
    largest |err| per kernel."""
    from repro_torch import bridge
    from repro_torch.api import (ForgetRequest, QuantSpec, Unlearner,
                                 UnlearnSpec)
    from repro_torch.configs import get as get_arch
    from repro_torch.core import adapters
    from repro_torch.core.schedule import checkpoint_set
    from repro_torch.data import synthetic as syn
    from repro_torch.engine import plan_scanned_sweep
    from repro_torch.kernels import dampen as kd
    from repro_torch.models import lm as LM
    from repro_torch.models.module import tree_leaves, tree_map
    from repro_torch.optim.compression import (INT8_SWEEP_RTOL, q8_fakequant,
                                               q8_quantize)

    t_phase = time.perf_counter()
    gib = 2.0 ** 30
    held = torch.cuda.memory_allocated() / gib
    torch.cuda.reset_peak_memory_stats()
    full = get_arch(MOE_ARCH).full
    cfg = full.with_(n_layers=MOE_BLOCKS)
    mcfg = cfg.moe_cfg()
    t0 = time.perf_counter()
    params = LM.init_lm(torch.Generator(device=dev).manual_seed(SEED), cfg,
                        device="cuda")
    adapter = adapters.lm_adapter(cfg, LM_SEQ, device="cuda")
    torch.cuda.synchronize()
    L = adapter.n_layers
    stored = bridge.paths(params)
    n_params = sum(t.numel() for t in stored.values())
    layers = [tree_leaves(adapter.get_layer(params, j)) for j in range(L)]
    layer_leaves = [len(ls) for ls in layers]
    n_leaves = sum(layer_leaves)
    # a fp32 request launches the dampen kernel once per dtype among a
    # layer's leaves (a block: its bf16 weights, then its f32 router), an
    # int8 request once per layer of codes
    launches32 = [len({t.dtype for t in ls}) for ls in layers]
    log(f"[moe] {cfg.name} at full width and {cfg.n_layers} of its "
        f"{full.n_layers} blocks (d_model {cfg.d_model}, {cfg.n_heads} heads"
        f" / {cfg.n_kv_heads} KV of {cfg.dh}, {mcfg.num_experts} experts of "
        f"d_ff {mcfg.d_ff}, top-{mcfg.top_k}, shared_ff {mcfg.shared_ff}, "
        f"capacity factor {mcfg.capacity_factor}, vocab {cfg.vocab}, RoPE "
        f"theta {cfg.rope_theta}, untied, {cfg.param_dtype} with an f32 "
        f"router) from torch.Generator('cuda') seed {SEED} in "
        f"{time.perf_counter() - t0:.1f} s: {n_params} parameters in "
        f"{len(stored)} stored leaves; {n_leaves} layer leaves in {L} unlearn"
        f" layers; dampen launches per layer (fp32) {launches32}; "
        f"{held:.2f} GiB held on the card from earlier phases")
    got = (n_params, len(stored), n_leaves, L)
    if got != MOE_WANT:
        raise AssertionError(f"{cfg.name}: {got} (parameters, stored leaves,"
                             f" layer leaves, layers), expected {MOE_WANT}")

    # the group kernels on the tables this model's requests launch, before
    # the path's counters are zeroed: each layer's bf16 leaves and the
    # block's f32 router apart (a fp32 request), each whole layer as codes
    # (an int8 request)
    def shapes(ts):
        return [tuple(t.shape) for t in ts]

    parts = [[t for t in ls if t.dtype == dt] for ls in layers
             for dt in dict.fromkeys(t.dtype for t in ls)]
    t0 = time.perf_counter()
    gcases, gerr = {}, {"dampen": 0.0, "dampen_int8": 0}
    for kind, tables in (
            ("bf16", [shapes(p) for p in parts
                      if p[0].dtype == torch.bfloat16]),
            ("f32", [shapes(p) for p in parts if p[0].dtype == torch.float32]),
            ("int8", [shapes(ls) for ls in layers])):
        cases, err = check_group_kernels_against_plain(
            tables, dev, edges=False, whole=False, kinds=(kind,))
        gcases[kind] = cases[kind]
        for k in gerr:
            gerr[k] = max(gerr[k], err[k])
    log(f"[moe] grouped dampen (bf16 parts, the f32 router's table) and "
        f"dampen_int8 (whole layers) over the tables its requests launch, "
        f"the block's [{mcfg.num_experts}, {cfg.d_model}, {mcfg.d_ff}] "
        f"expert stacks among them, x 3 pairs: bit-identical to their plain "
        f"versions, selection count, launch and leaf counters included, in "
        f"{gcases} tables, max |err| {gerr} "
        f"({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    toks, doms = syn.make_lm_domains(syn.LMDataConfig(
        vocab=LM_DATA_VOCAB, n_domains=4, seq_len=LM_SEQ, n_per_domain=8,
        seed=SEED))
    split = syn.lm_split_forget_retain(toks, doms, LM_FORGET)

    def request(seqs, tag):
        inputs = torch.as_tensor(seqs[:, :-1], device=dev).long().contiguous()
        with torch.no_grad():
            labels = LM.forward(params, cfg, inputs)[0].argmax(-1)
        return ForgetRequest(inputs, labels, tag=tag)

    req = request(split["forget"][:MOE_SEQS], LM_FORGET)
    retain = request(split["retain"][:4], "retain")
    log(f"[moe] {MOE_SEQS} sequences of S = {LM_SEQ} tokens of domain "
        f"{LM_FORGET} (make_lm_domains, vocab {LM_DATA_VOCAB}; requests at "
        f"chunk {MOE_CHUNK}) and 4 retain sequences, argmax labels, in "
        f"{time.perf_counter() - t0:.1f} s")

    def spec(mode, **kw):
        return UnlearnSpec.for_mode(mode, **{
            "alpha": MOE_ALPHA, "lam": 1.0, "tau": -1.0,
            "checkpoint_every": 1,
            "chunk_size": MOE_CHUNK, "use_kernel": True, **kw})

    lssd = Unlearner(adapter, spec=spec("ssd"), device="cuda")
    t0 = time.perf_counter()
    lssd.ensure_fisher(lambda p, b: LM.lm_loss(p, cfg, b[0], b[1]), params,
                       (retain.inputs, retain.labels), chunk_size=2)
    torch.cuda.synchronize()
    fisher = lssd.fisher_global
    blocks = list(range(1, L - 1))
    r_fish = max(float(adapter.get_layer(fisher, j)["ffn"]["router"].max())
                 for j in blocks)
    log(f"[moe] ensure_fisher (lm_loss, aux weight 0.01) on 4 retain "
        f"sequences (chunk 2) in {time.perf_counter() - t0:.1f} s; the "
        f"routers' largest Fisher entry {r_fish:.3e}; peak "
        f"{torch.cuda.max_memory_allocated() / gib:.2f} GiB")
    if not r_fish > 0.0:
        raise AssertionError(f"moe: the routers' Fisher is {r_fish}")
    # the caller's tree as it was, on the host (8.5 GB)
    before = {k: v.cpu() for k, v in stored.items()}
    router0 = {j: adapter.get_layer(params, j)["ffn"]["router"].clone()
               for j in blocks}
    router8 = {j: q8_fakequant(r) for j, r in router0.items()}
    cps = checkpoint_set(L, 1)
    plan = plan_scanned_sweep(adapter, params, req.inputs)
    if plan is None or plan.kinds != (("blk", "attn"),):
        raise AssertionError(f"{cfg.name}: scanned plan {plan}")
    runs = {}
    guarded_calls = [0]

    def serve(name, unl, path, *, want="layerwise", keep=False):
        """One request, checked: one launch of its precision's dampen kernel
        per dtype of each layer swept (every layer for a scanned program),
        over that layer's leaves, none of the other's; the sweep mode asked
        for; every parameter finite; every router the caller's (in int8,
        its pre-edit codes: an int8 result holds every leaf on its grid).
        ``keep`` keeps the result on the host."""
        c0 = dampen_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        new, st = unl.forget(req, params=params)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        dc = tuple(b - a for a, b in zip(c0, dampen_counts()))
        mine, other = (dc[:2], dc[2:]) if path == "fp32" else (dc[2:], dc[:2])
        eng = st["engine"]
        stop = L if eng["sweep_mode"] == "scanned" else st["stopped_at_l"]
        per = launches32 if path == "fp32" else [1] * L
        want_l = (sum(per[L - l] for l in range(1, stop + 1)),
                  sum(layer_leaves[L - l] for l in range(1, stop + 1)))
        log(f"[moe] {path} {name:18s}: stopped_at_l={st['stopped_at_l']} "
            f"checkpoints={st['checkpoints_hit']} macs_vs_ssd_pct="
            f"{round(st['macs_vs_ssd_pct'], 4)} {eng['sweep_mode']}, launches "
            f"{mine[0]} over {mine[1]} leaves, builds={eng['compiles']} "
            f"hits={eng['cache_hits']} wall={secs * 1e3:.1f} ms, peak "
            f"{torch.cuda.max_memory_allocated() / gib:.2f} GiB")
        if (mine != want_l or other != (0, 0) or eng["precision"] != path
                or eng["sweep_mode"] != want):
            raise AssertionError(f"moe {path} {name}: {eng}, launches {dc},"
                                 f" expected {want_l} in {path}")
        if not all(torch.isfinite(t).all() for t in tree_leaves(new)):
            raise AssertionError(f"moe {path} {name}: non-finite parameters")
        for j in blocks:
            ref = router0[j] if path == "fp32" else router8[j]
            if not torch.equal(bits(adapter.get_layer(new, j)["ffn"][
                    "router"]), bits(ref)):
                raise AssertionError(f"moe {path} {name}: block {j}'s router "
                                     f"was edited")
        runs[(path, name)] = (tree_map(lambda t: t.cpu(), new) if keep
                              else None, st, mine, secs)
        return new, st

    stat_keys = ("stopped_at_l", "checkpoints_hit", "selected_per_layer",
                 "forget_acc_trace", "macs", "macs_ssd", "macs_vs_ssd_pct")

    def same_as(new, st, path, name):
        """The request ``(new, st)`` == the kept request ``name``, bit for
        bit on every stored leaf (the kept one brought back leaf by leaf)
        and in its stats."""
        want_new, want_st = runs[(path, name)][:2]
        a, b = bridge.paths(new), bridge.paths(want_new)
        diff = [k for k in stat_keys if st[k] != want_st[k]] + [
            k for k in a if not torch.equal(bits(a[k]), bits(b[k].to(dev)))]
        if diff:
            raise AssertionError(f"moe {path}: != {name} at {diff}")

    def kernel_equals_plain(path, name, **kw):
        p_plain, st = lssd.with_spec(spec("ssd", use_kernel=False, **kw)
                                     ).forget(req, params=params)
        same_as(p_plain, st, path, name)
        log(f"[moe] {path} {name}: the forget with the kernel == the plain "
            f"forget, bit for bit, all {len(stored)} stored leaves")

    zero_counts()                                    # the [moe] path starts
    serve("ssd cold", lssd, "fp32")
    _, st_ssd = serve("ssd warm", lssd, "fp32", keep=True)
    _, st_nh = serve("ficabu tau=-1", lssd.with_spec(spec("ficabu")), "fp32")
    if st_ssd["stopped_at_l"] != L or st_nh["stopped_at_l"] != L \
            or st_nh["checkpoints_hit"] != cps:
        raise AssertionError(f"moe ssd stopped at {st_ssd['stopped_at_l']}, "
                             f"ficabu tau=-1 at {st_nh['stopped_at_l']} "
                             f"through {st_nh['checkpoints_hit']}")
    trace = st_nh["forget_acc_trace"]
    tau = trace[len(trace) // 2][1]
    ficabu = lssd.with_spec(spec("ficabu", tau=tau))
    serve("ficabu cold", ficabu, "fp32")
    _, st_h = serve("ficabu warm", ficabu, "fp32")
    log(f"[moe] ficabu tau=-1 forget-accuracy trace {trace}; the halting "
        f"request's tau {tau} (the trace at its middle checkpoint): stopped "
        f"at l = {st_h['stopped_at_l']} of {L}")
    if not st_h["stopped_at_l"] < L:
        raise AssertionError("moe ficabu did not halt partway")
    for name in ("ssd warm", "ficabu warm"):
        if runs[("fp32", name)][1]["engine"]["compiles"] != 0:
            raise AssertionError(f"moe {name} request built steps")
    # scanned: one program for the whole walk, == the layerwise request
    scan = lssd.with_spec(spec("ssd", sweep_mode="scanned"))
    new, st = serve("ssd scanned cold", scan, "fp32", want="scanned")
    same_as(new, st, "fp32", "ssd warm")
    del new
    guard_syncs(scan, guarded_calls)
    new, st = serve("ssd scanned warm", scan, "fp32", want="scanned")
    same_as(new, st, "fp32", "ssd warm")
    del new
    if st["engine"]["compiles"] != 0 or guarded_calls[0] != 1:
        raise AssertionError(f"moe scanned warm: {st['engine']}, "
                             f"{guarded_calls[0]} guarded program calls")
    log(f"[moe] scanned ssd, cold and warm (its program call under "
        f"set_sync_debug_mode('error')) == the layerwise request bit for "
        f"bit (all {len(stored)} stored leaves and stats); plan kinds "
        f"{plan.kinds}")
    kernel_equals_plain("fp32", "ssd warm")
    # int8 ssd, cold and warm: every leaf on its q8 grid, per layer within
    # INT8_SWEEP_RTOL of the fp32 request
    int8_kw = {"precision": "int8", "quant": QuantSpec()}
    lssd8 = lssd.with_spec(spec("ssd", **int8_kw))
    serve("ssd cold", lssd8, "int8")
    new8, st8 = serve("ssd warm", lssd8, "int8", keep=True)
    if st8["engine"]["compiles"] != 0:
        raise AssertionError("moe int8 ssd warm request built steps")
    if not lm_on_q8_grid(adapter, new8, params, st8["stopped_at_l"]):
        raise AssertionError("moe int8 ssd: a leaf left its q8 grid")
    rel = layer_rel_l2(adapter, new8, runs[("fp32", "ssd warm")][0])
    del new8
    log(f"[moe] int8 ssd vs fp32 ssd: every leaf on its q8 grid; per-layer "
        f"relative L2 (j = 0..{L - 1}) {[round(r, 6) for r in rel]}")
    if not all(0.0 < r <= INT8_SWEEP_RTOL for r in rel):
        raise AssertionError(f"moe int8 ssd: per-layer error {rel} outside "
                             f"(0, {INT8_SWEEP_RTOL}]")
    kernel_equals_plain("int8", "ssd warm", **int8_kw)

    # the MoE's own figures on this request: capacity and dropped choices
    # of each block's dispatch in the collection and in each vjp chunk,
    # and the aux loss
    calls, auxes = moe_dispatches(adapter, cfg, params, req.inputs,
                                  MOE_CHUNK)
    figures = [(j, what, top1.numel(), C, int((~kept).sum()))
               for j, what, top1, kept, C in calls]
    aux = auxes[-1]
    for j, what, T, C, dropped in figures:
        log(f"[moe] block {j} {what}: {T} tokens, capacity C = {C} per "
            f"expert, {dropped} of {T * mcfg.top_k} choices dropped "
            f"({dropped / (T * mcfg.top_k):.4f})")
    log(f"[moe] aux loss on the request (last block) {aux:.6f}")
    if not (aux > 0.0 and aux == aux and aux < float("inf")):
        raise AssertionError(f"moe aux loss {aux}")

    path_counts = dampen_counts()                     # the [moe] path ends
    if fisher_counts() != (0, 0, 0, 0):
        raise AssertionError(f"moe requests launched fimd/gemm/rowscale "
                             f"{fisher_counts()}")
    for k, t in stored.items():
        if not torch.equal(bits(t.cpu()), bits(before[k])):
            raise AssertionError(f"moe: a request edited the caller's {k}")
    del before
    into = time.perf_counter() - t_phase
    peak_requests = torch.cuda.max_memory_allocated() / gib
    log(f"[moe] the caller's tree unchanged after every request; dampen "
        f"counters over the path {path_counts}; peak {peak_requests:.2f} "
        f"GiB ({into:.1f} s into the phase)")
    for key in list(runs):
        runs[key] = (None,) + runs[key][1:]

    # where a warm ssd request spends its time: its wall from the warm
    # request above, the device's from one more under the profiler (the
    # device activity alone)
    prof = {}
    for path, unl in (("fp32", lssd), ("int8", lssd8)):
        wall = runs[(path, "ssd warm")][3] * 1e3
        t0 = time.perf_counter()
        busy, n_kernels, ranked = profile_request(
            lambda: unl.forget(req, params=params))
        damp = [(ms, count) for name, ms, count in ranked
                if "dampen_group_kernel" in name]
        prof[path] = (wall, busy, n_kernels)
        log(f"[profile] warm llama4-scout {path} ssd request: wall "
            f"{wall:.2f} ms, device busy {busy:.3f} ms, idle share "
            f"{1 - busy / wall:.3f}, {n_kernels} device kernels, of them "
            f"{sum(c for _, c in damp)} dampen_group_kernel "
            f"({sum(ms for ms, _ in damp):.4f} ms); profiled in "
            f"{time.perf_counter() - t0:.1f} s")
        for name, ms, count in ranked[:6]:
            log(f"[profile]   {ms:9.3f} ms  x{count:<6d} {name[:70]}")
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    base = lm_tables(adapter, params, fisher, gen, dev)
    tables = split_by_dtype(base)
    n_el = {dt: sum(t.numel() for ths, _, _ in tables for t in ths
                    if t.dtype == dt)
            for dt in (torch.bfloat16, torch.float32)}

    def sweep(fn, tabs):
        for ths, i_fs, i_gs in tabs:
            fn(ths, i_fs, i_gs, MOE_ALPHA, 1.0)

    tl = {"fp32": cuda_time_ms(lambda: sweep(kd.dampen_group_cuda, tables),
                               5, queue_ahead=True),
          "fp32_plain": cuda_time_ms(
              lambda: sweep(kd.dampen_group_ref, tables), 1,
              queue_ahead=True)}
    n_launch32 = len(tables)
    tables = [([q8_quantize(th)[0] for th in ths], i_fs, i_gs)
              for ths, i_fs, i_gs in base]
    del base
    tl["int8"] = cuda_time_ms(lambda: sweep(kd.dampen_int8_group_cuda,
                                            tables), 5, queue_ahead=True)
    tl["int8_plain"] = cuda_time_ms(
        lambda: sweep(kd.dampen_int8_group_ref, tables), 1, queue_ahead=True)
    del tables
    # bf16 theta: 2 + 4 + 4 read, 2 + 1 written; the f32 router: 4 + 4 + 4
    # read, 4 + 1 written; int8 codes: 1 + 4 + 4 read, 1 + 1 written; and
    # each launch's 8-byte count
    lbound = {"fp32": (n_el[torch.bfloat16] * 13 + n_el[torch.float32] * 17
                       + 8 * n_launch32) / rate * 1e3,
              "int8": ((n_el[torch.bfloat16] + n_el[torch.float32]) * 11
                       + 8 * L) / rate * 1e3}
    for kernel, path, n in (("dampen", "fp32", n_launch32),
                            ("dampen_int8", "int8", L)):
        log(f"[time] {kernel} llama4-scout sweep device ({n} grouped "
            f"launches, {sum(n_el.values())} elements): kernel "
            f"{tl[path]:.5f} ms, plain {tl[path + '_plain']:.5f} ms, bound "
            f"{lbound[path]:.5f} ms ({lbound[path] / tl[path] * 100:.1f}% of "
            f"the memory bound)")
    # decode: the MoE block's decode form token by token against the
    # forward, at a capacity that drops no choice (a dispatch of a whole
    # sequence may drop where one of a token per row cannot), as the
    # reference's own check takes it
    import dataclasses
    del lssd8, scan, ficabu
    torch.cuda.empty_cache()
    dec = lm_decode_check(cfg.name, cfg.with_(moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(mcfg.num_experts))), params,
        req.inputs[:, :DECODE_TOKENS])
    peak = torch.cuda.max_memory_allocated() / gib
    secs = time.perf_counter() - t_phase
    log(f"[moe] phase done in {secs:.1f} s; torch.cuda.max_memory_allocated"
        f" {peak:.2f} GiB")
    out = {}
    for path in ("fp32", "int8"):
        out[path] = {
            "moe_launches": path_counts[0 if path == "fp32" else 2],
            "moe_leaves": path_counts[1 if path == "fp32" else 3],
            "moe_launches_per_ssd_request": runs[(path, "ssd warm")][2][0],
            "moe_leaves_per_ssd_request": runs[(path, "ssd warm")][2][1],
            "moe_sweep_ms": tl[path],
            "moe_sweep_plain_ms": tl[path + "_plain"],
            "moe_sweep_bound_ms": lbound[path],
            "moe_warm_ssd_wall_ms": prof[path][0],
            "moe_warm_ssd_device_busy_ms": prof[path][1],
            "moe_warm_ssd_device_kernels": prof[path][2],
        }
    out["fp32"].update({
        "moe_scanned_ssd_launches_leaves": list(
            runs[("fp32", "ssd scanned warm")][2]),
        "moe_int8_rel_l2": rel,
        "moe_dispatch": [{"block": j, "call": what, "tokens": T,
                          "capacity": C, "dropped": dropped}
                         for j, what, T, C, dropped in figures],
        "moe_aux_loss": aux,
        "moe_decode_rel_l2": dec["decode_vs_forward"][0],
        "moe_peak_gib": peak,
        "moe_phase_seconds": secs})
    del params, fisher, lssd, runs, stored, layers
    torch.cuda.empty_cache()
    return out, gerr


# the decode checks: tokens stepped one at a time through decode_step
# against the forward over the whole sequence (and gemma3-1b's chunked
# prefill against the tokenwise decode), on the bf16 models the phases
# build. The two paths run the same arithmetic per token in another
# grouping (a [1, D] product beside a [T, D] one sums in another order, so
# a bf16 rounding now and then lands on the other side), except
# recurrentgemma's conv, which the reference's decode takes in f32 and its
# forward in bf16 (2% apart in the logits on its bf16 SMOKE model on the
# host): the logits must agree within these relative L2 distances, not bit
# for bit (ROADMAP Queue 3), and be finite
DECODE_TOKENS = 64
DECODE_RTOL = 0.05
DECODE_RTOL_CONV = 0.1


def rel_l2(a, b):
    """||a - b|| / ||b|| in f64."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def decode_agrees(tag, what, got, want, rtol):
    """``got`` (stepped) against ``want``: finite, within relative L2
    ``rtol``; logs the distance and the argmax agreement. Returns both."""
    rel = rel_l2(got, want)
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    log(f"[decode] {tag} {what}: logits {tuple(got.shape)}, relative L2 "
        f"{rel:.3e} (must be <= {rtol}), argmax agreement {agree:.4f}")
    if not (torch.isfinite(got).all() and rel <= rtol):
        raise AssertionError(f"decode {tag} {what}: relative L2 {rel}")
    return rel, agree


def lm_decode_check(tag, cfg, params, tokens, *, prefill=False,
                    rtol=DECODE_RTOL):
    """An LM's tokenwise ``decode_step`` from an empty cache against its
    ``forward`` on ``tokens`` [B, T], and (``prefill``) ``prefill`` of the
    same prompt against the tokenwise decode, the caches too. Returns the
    figures the kernels line carries."""
    from repro_torch.models import lm as LM
    from repro_torch.models.module import tree_leaves

    B, T = tokens.shape
    t0 = time.perf_counter()
    with torch.no_grad():
        full = LM.forward(params, cfg, tokens)[0]
        cache = LM.init_cache(cfg, B, T, device="cuda")
        steps = []
        for i in range(T):
            lg, cache = LM.decode_step(params, cfg, tokens[:, i:i + 1], cache,
                                       i)
            steps.append(lg)
        dec = torch.cat(steps, 1)
    torch.cuda.synchronize()
    out = {"decode_vs_forward": decode_agrees(
        tag, f"{T} decode steps vs forward", dec, full, rtol)}
    if prefill:
        with torch.no_grad():
            pre, pcache = LM.prefill(params, cfg, tokens, LM.init_cache(
                cfg, B, T, device="cuda"), last_only=False)
        out["prefill_vs_decode"] = decode_agrees(
            tag, f"prefill ({T} tokens, wide "
            f"{T <= LM._min_attn_cache(cfg, cache)}) vs tokenwise decode",
            pre, dec, rtol)
        crel = max(rel_l2(a.float(), b.float()) for a, b in
                   zip(tree_leaves(pcache), tree_leaves(cache)))
        log(f"[decode] {tag} prefill caches vs tokenwise decode caches: "
            f"largest relative L2 {crel:.3e}")
        if not crel <= rtol:
            raise AssertionError(f"decode {tag} prefill caches: {crel}")
        out["prefill_cache_rel_l2"] = crel
    out["seconds"] = time.perf_counter() - t0
    return out


# the [encdec] phase: whisper-tiny FULL (4 encoder and 4 decoder blocks,
# d_model 384, 6 heads, d_ff 1536, vocab 51,865, untied, bf16), its
# expected (parameters, stored leaves, layer leaves, unlearn layers), the
# decoder's ceiling of 448 tokens as the request's length, and a request
# of 8 sequences at chunk 8: the stub frames' batch, where the reference's
# cross attention pairs each query row with its own frames (ROADMAP Queue
# 3). The adapter sweeps the decoder chain: the embedding, 4 blocks, the
# head; each block re-encodes the frames, as the reference does
ENCDEC_ARCH = "whisper-tiny"
ENCDEC_WANT = (61_074_432, 27, 59, 6)
ENCDEC_SEQ = 448
ENCDEC_N = 8
ENCDEC_ALPHA = 25.0


def encdec_phase(dev, rate, zero_counts, dampen_counts, fisher_counts):
    """Phase 15, [encdec]: the encoder-decoder at full width (module
    docstring). Returns the figures the kernels line carries and the
    largest |err| per kernel."""
    from repro_torch import bridge
    from repro_torch.api import (ForgetRequest, QuantSpec, Unlearner,
                                 UnlearnSpec)
    from repro_torch.configs import get as get_arch
    from repro_torch.core import adapters
    from repro_torch.core.schedule import checkpoint_set
    from repro_torch.data import synthetic as syn
    from repro_torch.engine import plan_scanned_sweep
    from repro_torch.kernels import dampen as kd
    from repro_torch.models import encdec as ED
    from repro_torch.models.module import tree_leaves, tree_map
    from repro_torch.optim.compression import (INT8_SWEEP_RTOL,
                                               q8_fakequant_tree, q8_quantize)

    t_phase = time.perf_counter()
    gib = 2.0 ** 30
    held = torch.cuda.memory_allocated() / gib
    torch.cuda.reset_peak_memory_stats()
    cfg = get_arch(ENCDEC_ARCH).full
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = ED.init_encdec(gen, cfg, device="cuda")
    frames = torch.randn(ENCDEC_N, cfg.n_frames, cfg.d_model, generator=gen,
                         device=dev)
    frames_retain = torch.randn(ENCDEC_N, cfg.n_frames, cfg.d_model,
                                generator=gen, device=dev)
    adapter = adapters.encdec_adapter(cfg, ENCDEC_SEQ, frames, device="cuda")
    torch.cuda.synchronize()
    L = adapter.n_layers
    stored = bridge.paths(params)
    n_params = sum(t.numel() for t in stored.values())
    layers = [tree_leaves(adapter.get_layer(params, j)) for j in range(L)]
    layer_leaves = [len(ls) for ls in layers]
    n_leaves = sum(layer_leaves)
    log(f"[encdec] {cfg.name} FULL ({cfg.n_enc_layers} encoder and "
        f"{cfg.n_dec_layers} decoder blocks, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads of {cfg.dh}, d_ff {cfg.d_ff}, vocab {cfg.vocab},"
        f" untied, {cfg.param_dtype}) and stub frames "
        f"{tuple(frames.shape)} from torch.Generator('cuda') seed {SEED} in "
        f"{time.perf_counter() - t0:.1f} s: {n_params} parameters in "
        f"{len(stored)} stored leaves; the decoder chain's {n_leaves} layer "
        f"leaves in {L} unlearn layers; {held:.2f} GiB held on the card "
        f"from earlier phases")
    got = (n_params, len(stored), n_leaves, L)
    if got != ENCDEC_WANT:
        raise AssertionError(f"{cfg.name}: {got} (parameters, stored leaves,"
                             f" layer leaves, layers), expected "
                             f"{ENCDEC_WANT}")
    if {t.dtype for ls in layers for t in ls} != {torch.bfloat16}:
        raise AssertionError(f"{cfg.name}: layer dtypes are not all bf16")

    # the group kernels on the tables its requests launch, before the path's
    # counters are zeroed: each layer's bf16 leaves (fp32 requests) and its
    # int8 codes (int8 requests)
    t0 = time.perf_counter()
    gcases, gerr = check_group_kernels_against_plain(
        [[tuple(t.shape) for t in ls] for ls in layers], dev, edges=False,
        whole=False, kinds=("bf16", "int8"))
    log(f"[encdec] grouped dampen (bf16 theta) and dampen_int8 over the "
        f"{L} layer tables its requests launch x 3 pairs: bit-identical to "
        f"their plain versions, selection count, launch and leaf counters "
        f"included, in {gcases} tables, max |err| {gerr} "
        f"({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    toks, doms = syn.make_lm_domains(syn.LMDataConfig(
        vocab=LM_DATA_VOCAB, n_domains=4, seq_len=ENCDEC_SEQ + 1,
        n_per_domain=ENCDEC_N, seed=SEED))
    splits = {d: syn.lm_split_forget_retain(toks, doms, d)
              for d in (LM_FORGET, LM_OTHER)}

    def request(seqs, tag, fr):
        """Sequences [N, S + 1] as a request of their first S tokens,
        labelled with the model's own argmax on the frames ``fr``."""
        inputs = torch.as_tensor(seqs[:, :-1], device=dev).long().contiguous()
        with torch.no_grad():
            labels = ED.forward(params, cfg, inputs, fr).argmax(-1)
        return ForgetRequest(inputs, labels, tag=tag)

    req = request(splits[LM_FORGET]["forget"][:ENCDEC_N], LM_FORGET, frames)
    req2 = request(splits[LM_OTHER]["forget"][:ENCDEC_N], LM_OTHER, frames)
    retain = request(splits[LM_FORGET]["retain"][:ENCDEC_N], "retain",
                     frames_retain)
    log(f"[encdec] two {ENCDEC_N}-sequence forget requests of S = "
        f"{ENCDEC_SEQ} tokens (domains {LM_FORGET}, {LM_OTHER}; "
        f"make_lm_domains, vocab {LM_DATA_VOCAB}) on the adapter's frames and"
        f" {ENCDEC_N} retain sequences on frames of their own, argmax "
        f"labels, in {time.perf_counter() - t0:.1f} s")

    def spec(mode, **kw):
        return UnlearnSpec.for_mode(mode, **{
            "alpha": ENCDEC_ALPHA, "lam": 1.0, "tau": -1.0,
            "checkpoint_every": 1, "chunk_size": ENCDEC_N,
            "use_kernel": True, **kw})

    lssd = Unlearner(adapter, spec=spec("ssd"), device="cuda")
    t0 = time.perf_counter()
    lssd.ensure_fisher(lambda p, b: ED.lm_loss(p, cfg, b[0], b[1], b[2]),
                       params, (retain.inputs, retain.labels, frames_retain),
                       chunk_size=ENCDEC_N)
    torch.cuda.synchronize()
    fisher = lssd.fisher_global
    log(f"[encdec] ensure_fisher (lm_loss, z-loss 1e-4) on the retain batch "
        f"in {time.perf_counter() - t0:.1f} s, the encoder's leaves among "
        f"its {len(bridge.paths(fisher))}; peak "
        f"{torch.cuda.max_memory_allocated() / gib:.2f} GiB")
    before = {k: v.clone() for k, v in stored.items()}
    front = ("encoder/", "enc_norm/")
    front8 = {k: v for k, v in bridge.paths(q8_fakequant_tree(params)).items()
              if k.startswith(front)}
    cps = checkpoint_set(L, 1)
    if plan_scanned_sweep(adapter, params, req.inputs) is not None:
        raise AssertionError("encdec: the scanned planner planned the "
                             "decoder chain (it has no layer_ctx)")
    runs = {}
    stat_keys = ("stopped_at_l", "checkpoints_hit", "selected_per_layer",
                 "forget_acc_trace", "macs", "macs_ssd", "macs_vs_ssd_pct")

    def serve(name, unl, path, *, group=None, keep=False):
        """One request (or a drain of ``group``), checked: one launch of its
        precision's kernel per layer swept, over that layer's leaves, none
        of the other's; the layerwise loop (no plan, whatever the mode
        asked); every parameter finite; the encoder and enc_norm bit for bit
        the caller's (fp32) or their fake quantisation (int8)."""
        c0 = dampen_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if group is None:
            new, st = unl.forget(req, params=params)
            sts = [st]
        else:
            new, sts, st = unl.forget_group(group, params=params)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        dc = tuple(b - a for a, b in zip(c0, dampen_counts()))
        mine, other = (dc[:2], dc[2:]) if path == "fp32" else (dc[2:], dc[:2])
        eng = st["engine"]
        want_l = (sum(s["stopped_at_l"] for s in sts),
                  sum(sum(layer_leaves[L - l]
                          for l in range(1, s["stopped_at_l"] + 1))
                      for s in sts))
        log(f"[encdec] {path} {name:22s}: stopped_at_l="
            f"{[s['stopped_at_l'] for s in sts]} checkpoints="
            f"{[s['checkpoints_hit'] for s in sts]} macs_vs_ssd_pct="
            f"{[round(s['macs_vs_ssd_pct'], 4) for s in sts]} "
            f"{eng['sweep_mode']}, launches {mine[0]} over {mine[1]} leaves, "
            f"builds={eng['compiles']} hits={eng['cache_hits']} wall="
            f"{secs * 1e3:.1f} ms, peak "
            f"{torch.cuda.max_memory_allocated() / gib:.2f} GiB")
        if (mine != want_l or other != (0, 0) or eng["precision"] != path
                or eng["sweep_mode"] != "layerwise"):
            raise AssertionError(f"encdec {path} {name}: {eng}, launches "
                                 f"{dc}, expected {want_l} in {path}")
        if not all(torch.isfinite(t).all() for t in tree_leaves(new)):
            raise AssertionError(f"encdec {path} {name}: non-finite "
                                 f"parameters")
        got = bridge.paths(new)
        for k, v in (stored.items() if path == "fp32" else front8.items()):
            if k.startswith(front) and not torch.equal(bits(got[k]),
                                                       bits(v)):
                raise AssertionError(f"encdec {path} {name}: the request "
                                     f"edited the encoder's {k}")
        runs[(path, name)] = (new if keep else None, sts, mine, secs)
        return new, sts

    def same_as(new, sts, path, name):
        want_new, want_sts = runs[(path, name)][:2]
        a, b = bridge.paths(new), bridge.paths(want_new)
        diff = [k for k in stat_keys for s, w in zip(sts, want_sts)
                if s[k] != w[k]] + [
            k for k in a if not torch.equal(bits(a[k]), bits(b[k]))]
        if diff:
            raise AssertionError(f"encdec {path}: != {name} at {diff}")

    zero_counts()                                 # the [encdec] path starts
    serve("ssd cold", lssd, "fp32")
    _, (st_ssd,) = serve("ssd warm", lssd, "fp32", keep=True)
    _, (st_nh,) = serve("ficabu tau=-1", lssd.with_spec(spec("ficabu")),
                        "fp32")
    if st_ssd["stopped_at_l"] != L or st_nh["stopped_at_l"] != L \
            or st_nh["checkpoints_hit"] != cps:
        raise AssertionError(f"encdec ssd stopped at "
                             f"{st_ssd['stopped_at_l']}, ficabu tau=-1 at "
                             f"{st_nh['stopped_at_l']} through "
                             f"{st_nh['checkpoints_hit']}")
    trace = st_nh["forget_acc_trace"]
    tau = trace[len(trace) // 2][1]
    ficabu = lssd.with_spec(spec("ficabu", tau=tau))
    serve("ficabu cold", ficabu, "fp32")
    _, (st_h,) = serve("ficabu warm", ficabu, "fp32", keep=True)
    log(f"[encdec] ficabu tau=-1 forget-accuracy trace {trace}; the halting "
        f"request's tau {tau} (the trace at its middle checkpoint): stopped "
        f"at l = {st_h['stopped_at_l']} of {L}")
    if not st_h["stopped_at_l"] < L:
        raise AssertionError("encdec ficabu did not halt partway")
    for name in ("ssd warm", "ficabu warm"):
        if runs[("fp32", name)][1][0]["engine"]["compiles"] != 0:
            raise AssertionError(f"encdec {name} request built steps")
    # "scanned": no plan, so the layerwise loop, bit for bit
    for name, mode, kw in (("ssd", "ssd", {}),
                           ("ficabu", "ficabu", {"tau": tau})):
        new, sts = serve(f"{name} scanned", lssd.with_spec(
            spec(mode, sweep_mode="scanned", **kw)), "fp32")
        same_as(new, sts, "fp32", f"{name} warm")
    del new
    # kernel forget == plain forget
    p_plain, st = lssd.with_spec(spec("ssd", use_kernel=False)).forget(
        req, params=params)
    same_as(p_plain, [st], "fp32", "ssd warm")
    del p_plain
    log(f"[encdec] scanned ssd and ficabu (the layerwise loop: no plan) == "
        f"their layerwise requests, and the ssd forget with the kernel == "
        f"the plain forget, bit for bit (all {len(stored)} stored leaves and "
        f"stats)")
    # int8: ssd cold and warm and the halting ficabu, on their q8 grids,
    # per layer within INT8_SWEEP_RTOL of fp32; scanned and kernel == plain
    int8_kw = {"precision": "int8", "quant": QuantSpec()}
    lssd8 = lssd.with_spec(spec("ssd", **int8_kw))
    serve("ssd cold", lssd8, "int8")
    new8, (st8,) = serve("ssd warm", lssd8, "int8", keep=True)
    serve("ficabu", lssd.with_spec(spec("ficabu", tau=tau, **int8_kw)),
          "int8")
    if st8["engine"]["compiles"] != 0:
        raise AssertionError("encdec int8 ssd warm request built steps")
    if not lm_on_q8_grid(adapter, new8, params, st8["stopped_at_l"]):
        raise AssertionError("encdec int8 ssd: a leaf left its q8 grid")
    rel = layer_rel_l2(adapter, new8, runs[("fp32", "ssd warm")][0])
    log(f"[encdec] int8 ssd vs fp32 ssd: every leaf on its q8 grid; "
        f"per-layer relative L2 (j = 0..{L - 1}) "
        f"{[round(r, 6) for r in rel]}")
    if not all(0.0 < r <= INT8_SWEEP_RTOL for r in rel):
        raise AssertionError(f"encdec int8 ssd: per-layer error {rel} "
                             f"outside (0, {INT8_SWEEP_RTOL}]")
    new, sts = serve("ssd scanned", lssd.with_spec(
        spec("ssd", sweep_mode="scanned", **int8_kw)), "int8")
    same_as(new, sts, "int8", "ssd warm")
    p_plain, st = lssd.with_spec(spec("ssd", use_kernel=False, **int8_kw)
                                 ).forget(req, params=params)
    same_as(p_plain, [st], "int8", "ssd warm")
    del new, new8, p_plain
    log("[encdec] int8: scanned ssd == layerwise, and the forget with the "
        "kernel == the plain forget, bit for bit")
    # a K = 2 ssd drain over two domains, layerwise and "scanned"
    group = [req, req2]
    serve("ssd K=2 drain", lssd, "fp32", group=group, keep=True)
    new, sts = serve("ssd K=2 drain scanned", lssd.with_spec(
        spec("ssd", sweep_mode="scanned")), "fp32", group=group)
    same_as(new, sts, "fp32", "ssd K=2 drain")
    del new
    log(f"[encdec] K=2 ssd drain: 'scanned' == layerwise bit for bit, "
        f"{runs[('fp32', 'ssd K=2 drain')][2]} launches and leaves")
    path_counts = dampen_counts()                  # the [encdec] path ends
    if fisher_counts() != (0, 0, 0, 0):
        raise AssertionError(f"encdec requests launched fimd/gemm/rowscale "
                             f"{fisher_counts()}")
    for k, t in stored.items():
        if not torch.equal(bits(t), bits(before[k])):
            raise AssertionError(f"encdec: a request edited the caller's {k}")
    del before
    log(f"[encdec] the caller's tree unchanged after every request, the "
        f"encoder of every result the caller's (its fake quantisation in "
        f"int8); dampen counters over the path {path_counts}; peak "
        f"{torch.cuda.max_memory_allocated() / gib:.2f} GiB")
    for key in list(runs):
        runs[key] = (None,) + runs[key][1:]

    # where a warm ssd request spends its time
    prof = {}
    for path, unl in (("fp32", lssd), ("int8", lssd8)):
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            unl.forget(req, params=params)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t1) * 1e3)
        wall = sorted(walls)[1]
        busy, n_kernels, ranked = profile_request(
            lambda: unl.forget(req, params=params))
        damp = [(ms, count) for name, ms, count in ranked
                if "dampen_group_kernel" in name]
        prof[path] = (wall, busy, n_kernels)
        log(f"[profile] warm whisper-tiny {path} ssd request: wall "
            f"{wall:.2f} ms (median of {[round(w, 2) for w in walls]}), "
            f"device busy {busy:.3f} ms, idle share {1 - busy / wall:.3f}, "
            f"{n_kernels} device kernels, of them {sum(c for _, c in damp)} "
            f"dampen_group_kernel ({sum(ms for ms, _ in damp):.4f} ms)")
        for name, ms, count in ranked[:6]:
            log(f"[profile]   {ms:9.3f} ms  x{count:<6d} {name[:70]}")
    # the dampen sweep of one ssd request against its byte bound
    tables = lm_tables(adapter, params, fisher,
                       torch.Generator(device=dev).manual_seed(SEED + 4), dev)
    n_el = sum(t.numel() for ths, _, _ in tables for t in ths)

    def sweep(fn, tabs):
        for ths, i_fs, i_gs in tabs:
            fn(ths, i_fs, i_gs, ENCDEC_ALPHA, 1.0)

    tl = {"fp32": cuda_time_ms(lambda: sweep(kd.dampen_group_cuda, tables),
                               20, queue_ahead=True),
          "fp32_plain": cuda_time_ms(
              lambda: sweep(kd.dampen_group_ref, tables), 3,
              queue_ahead=True)}
    tables = [([q8_quantize(th)[0] for th in ths], i_fs, i_gs)
              for ths, i_fs, i_gs in tables]
    tl["int8"] = cuda_time_ms(lambda: sweep(kd.dampen_int8_group_cuda,
                                            tables), 20, queue_ahead=True)
    tl["int8_plain"] = cuda_time_ms(
        lambda: sweep(kd.dampen_int8_group_ref, tables), 3, queue_ahead=True)
    del tables
    # bf16 theta: 2 + 4 + 4 read, 2 + 1 written; int8 codes: 1 + 4 + 4
    # read, 1 + 1 written; and each launch's 8-byte count
    lbound = {"fp32": (n_el * 13 + 8 * L) / rate * 1e3,
              "int8": (n_el * 11 + 8 * L) / rate * 1e3}
    for kernel, path in (("dampen", "fp32"), ("dampen_int8", "int8")):
        log(f"[time] {kernel} whisper-tiny sweep device ({L} grouped "
            f"launches, {n_el} elements): kernel {tl[path]:.5f} ms, plain "
            f"{tl[path + '_plain']:.5f} ms, bound {lbound[path]:.5f} ms "
            f"({lbound[path] / tl[path] * 100:.1f}% of the memory bound)")

    # decode: encode once, then DECODE_TOKENS tokens one at a time through
    # decode_step against the forward's logits
    del fisher, lssd, lssd8, ficabu
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tokens = req.inputs[:2, :DECODE_TOKENS]
    fr = frames[:2]
    with torch.no_grad():
        full = ED.forward(params, cfg, tokens, fr)
        memory = ED.encode(params, cfg, fr)
        cache = ED.init_cache(cfg, 2, DECODE_TOKENS, device="cuda")
        steps = []
        for i in range(DECODE_TOKENS):
            lg, cache = ED.decode_step(params, cfg, tokens[:, i:i + 1], cache,
                                       i, memory)
            steps.append(lg)
    dec = decode_agrees("whisper-tiny", f"encode + {DECODE_TOKENS} decode "
                        f"steps vs forward", torch.cat(steps, 1), full,
                        DECODE_RTOL)
    dec_secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / gib
    secs = time.perf_counter() - t_phase
    log(f"[encdec] phase done in {secs:.1f} s; torch.cuda.max_memory_allocated"
        f" {peak:.2f} GiB")
    out = {}
    for path in ("fp32", "int8"):
        out[path] = {
            "encdec_launches": path_counts[0 if path == "fp32" else 2],
            "encdec_leaves": path_counts[1 if path == "fp32" else 3],
            "encdec_launches_per_ssd_request": runs[(path, "ssd warm")][2][0],
            "encdec_leaves_per_ssd_request": runs[(path, "ssd warm")][2][1],
            "encdec_sweep_ms": tl[path],
            "encdec_sweep_plain_ms": tl[path + "_plain"],
            "encdec_sweep_bound_ms": lbound[path],
            "encdec_warm_ssd_wall_ms": prof[path][0],
            "encdec_warm_ssd_device_busy_ms": prof[path][1],
            "encdec_warm_ssd_device_kernels": prof[path][2],
        }
    out["fp32"].update({
        "encdec_k2_drain_launches_leaves": list(
            runs[("fp32", "ssd K=2 drain")][2]),
        "encdec_int8_rel_l2": rel,
        "encdec_decode_rel_l2": dec[0],
        "encdec_decode_argmax_agreement": dec[1],
        "encdec_decode_seconds": dec_secs,
        "encdec_peak_gib": peak,
        "encdec_phase_seconds": secs})
    del params, runs, stored, layers, frames, frames_retain
    torch.cuda.empty_cache()
    return out, gerr


# the [serve] phase: gemma3-1b at full width and SERVE_BLOCKS of its 26
# blocks (26 -> 12 paid for [shard] and [cache], 12 -> 6 for [qwen] and
# [dryrun]: PERF.md section 4)
# served through the port's batch-mode
# serving loop (``repro_torch.launch.serve``) as ``serve.main`` builds it:
# make_lm_domains, 4 domains x 16 sequences of 128 + 32 tokens (at the LM
# phases' data vocabulary: serve.main's cfg.vocab would make four 65,536 x
# 65,536 transition matrices at FULL, 34 GB each); 3 batches of 8 prompts
# of 128 tokens, 32 greedy tokens each; forget bursts "1,2;3,2" due after
# batches 1 and 2, a final flush at inf. ServeSpec(chunk_size=4, refresh_every=1) lowers to ficabu, alpha 8,
# lambda 1, tau 0.6, checkpoints every 2 layers, chunk 4, and a refresh of
# 2 retain microbatches at decay 0.5 after every drain
SERVE_ARCH = "gemma3-1b"
SERVE_BLOCKS = 6
SERVE_WANT = (463_026_816, 56)  # (parameters, stored leaves) at 6 blocks
SERVE_PROMPT = 128
SERVE_GEN = 32
SERVE_REQUESTS = 8
SERVE_BATCHES = 3
SERVE_BURSTS = ((1, 2), (3, 2))
SERVE_AFTER = 1


def deterministic_algorithms():
    """Deterministic algorithms for the serving phases that drive the
    serving objects directly (``repro_torch.device.deterministic`` on the
    card, as ``serve --check`` and the load harness set them): every run
    computes its own Fisher, and the embedding's gradient accumulates by
    atomics otherwise, so two runs' Fishers would differ in their last
    bits."""
    from repro_torch.device import deterministic
    return deterministic("cuda")


def serve_phase(dev, rate, zero_counts, dampen_counts, fisher_counts):
    """Phase 16, [serve]: the streamed Fisher refresh and the serving loop
    at full width and SERVE_BLOCKS blocks (module docstring), under
    deterministic algorithms. Returns the figures the kernels line
    carries."""
    with deterministic_algorithms():
        return _serve_phase(dev, rate, zero_counts, dampen_counts,
                            fisher_counts)


def _serve_phase(dev, rate, zero_counts, dampen_counts, fisher_counts):
    import dataclasses
    import types

    from repro_torch import bridge
    from repro_torch.api import ForgetRequest, ServeSpec
    from repro_torch.configs import get as get_arch
    from repro_torch.data import synthetic as syn
    from repro_torch.fleet import Fleet
    from repro_torch.launch import serve as S
    from repro_torch.models import lm as LM
    from repro_torch.models.module import tree_leaves
    from repro_torch.robust import faults
    from repro_torch.robust.guards import GuardSpec

    t_phase = time.perf_counter()
    gib = 2.0 ** 30
    torch.cuda.reset_peak_memory_stats()
    cfg = get_arch(SERVE_ARCH).full.with_(n_layers=SERVE_BLOCKS)
    params = LM.init_lm(torch.Generator(device=dev).manual_seed(SEED), cfg,
                        device="cuda")
    stored = bridge.paths(params)
    n_params = sum(t.numel() for t in stored.values())
    if (n_params, len(stored)) != SERVE_WANT:
        raise AssertionError(f"serve {cfg.name}: {n_params} parameters in "
                             f"{len(stored)} stored leaves")
    seq_len = SERVE_PROMPT + SERVE_GEN
    tokens, domains = syn.make_lm_domains(syn.LMDataConfig(
        vocab=LM_DATA_VOCAB, n_domains=4, seq_len=seq_len, n_per_domain=16,
        seed=SEED))
    batches = [tokens[i:i + SERVE_REQUESTS, :SERVE_PROMPT]
               for i in range(0, len(tokens) - SERVE_REQUESTS,
                              SERVE_REQUESTS)][:SERVE_BATCHES]
    before = {k: v.clone() for k, v in stored.items()}
    log(f"[serve] {cfg.name} at full width and {cfg.n_layers} of 26 blocks "
        f"from torch.Generator('cuda') seed {SEED}: "
        f"{n_params} parameters in {len(stored)} stored leaves; "
        f"make_lm_domains (vocab {LM_DATA_VOCAB}, 4 domains x 16, "
        f"{seq_len} tokens); {len(batches)} batches of {SERVE_REQUESTS} "
        f"prompts of {SERVE_PROMPT} tokens, {SERVE_GEN} generated each; "
        f"bursts {SERVE_BURSTS} due after batches {SERVE_AFTER}..")

    def same(p, q):
        a, b = bridge.paths(p), bridge.paths(q)
        return sorted(a) == sorted(b) and all(
            torch.equal(bits(a[k]), bits(b[k])) for k in a)

    def timed_refreshes(rt, walls):
        """Time each refresh the drains run, on the host's clock between
        synchronizes."""
        inner = rt.maybe_refresh

        def run(p, batch_idx):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ran = inner(p, batch_idx)
            torch.cuda.synchronize()
            if ran:
                walls.append(time.perf_counter() - t0)
            return ran
        rt.maybe_refresh = run

    def decode(p, c, t, pos):
        return LM.decode_step(p, cfg, t, c, pos)

    def drive(label, rt, drain, *, generate):
        """The serving loop of ``serve.main``: per batch generate (or not),
        then the drain due after it, the flush at inf last; the warm
        drain's scanned program call under set_sync_debug_mode("error").
        Returns the final tree and the run's figures."""
        refresh_walls, drain_walls, gen, outs = [], [], [], []
        timed_refreshes(rt, refresh_walls)
        calls = [0]
        p = last_in = params
        for bi in range(len(batches) + 1):
            if bi < len(batches) and generate:
                prompts = torch.as_tensor(batches[bi], device=dev).long()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = S.generate(p, cfg, prompts, SERVE_GEN, decode)
                secs = time.perf_counter() - t0
                gen.append((secs, out.size / secs))
                outs.append(out)
                if out.shape != (SERVE_REQUESTS, SERVE_GEN):
                    raise AssertionError(f"serve generate {out.shape}")
            idx = bi + 1 if bi < len(batches) else float("inf")
            n_ref = len(refresh_walls)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p_in = p
            p, ran = drain(p, idx)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            if ran:
                last_in = p_in
                drain_walls.append(secs - sum(refresh_walls[n_ref:]))
                if rt.spec.exec.sweep_mode == "scanned" and calls[0] == 0:
                    guard_syncs(rt.unlearner, calls)
        for g, wall in zip(rt.group_log, drain_walls):
            log(f"[serve] {label} drain {g['group']} at batch {g['batch']}: "
                f"domains {g['domains']} sig {g['sweep_sig']}, stopped_at_l="
                f"{[e['stopped_at_l'] for e in rt.log if e.get('group') == g['group']]} "
                f"of {rt.adapter.n_layers}, macs_vs_ssd_pct="
                f"{[round(e['macs_vs_ssd_pct'], 4) for e in rt.log if e.get('group') == g['group']]}, "
                f"{g['engine']['sweep_mode']}, builds="
                f"{g['engine']['compiles']} hits={g['engine']['cache_hits']}"
                f", wall {wall * 1e3:.1f} ms "
                f"({'cold' if g['group'] == 0 else 'warm'}, refresh apart)")
        for i, (r, wall) in enumerate(zip(rt.refresh_log, refresh_walls)):
            log(f"[serve] {label} refresh {i} after batch {r['batch']}: "
                f"{r['batches']} microbatches, ema_count {r['ema_count']}, "
                f"refresh builds={r['engine']['refresh_compiles']} "
                f"hits={r['engine']['refresh_hits']}, wall "
                f"{wall * 1e3:.1f} ms")
        for bi, (secs, tps) in enumerate(gen):
            log(f"[serve] {label} generate batch {bi}: {SERVE_REQUESTS} x "
                f"{SERVE_GEN} tokens in {secs * 1e3:.1f} ms, {tps:.1f} "
                f"tokens/s")
        if rt.spec.exec.sweep_mode == "scanned" and calls[0] != 1:
            raise AssertionError(f"serve {label}: {calls[0]} guarded warm "
                                 f"program calls")
        if not all(torch.isfinite(t).all() for t in tree_leaves(p)):
            raise AssertionError(f"serve {label}: non-finite parameters")
        return p, {"drain_walls": drain_walls, "refresh_walls":
                   refresh_walls, "gen": gen, "last_in": last_in,
                   "outs": outs}

    def gates(label, rt, serve_spec, p, staleness=True):
        """Every gate of the reference's ``serve --check`` on a finished
        run (the staleness oracle where asked)."""
        stale = rt.staleness_report(p) if staleness else None
        view = types.SimpleNamespace(
            group_log=rt.group_log, spec=rt.spec, unlearner=rt.unlearner,
            refresh_log=rt.refresh_log, serve_spec=serve_spec)
        problems = S.check_problems(view, {
            "refreshes": len(rt.refresh_log), "staleness": stale})
        if len(rt.group_log) != len(SERVE_BURSTS):
            problems.append(f"{len(rt.group_log)} drain groups")
        if problems:
            raise AssertionError(f"serve {label} check: {problems}")
        if stale is not None:
            log(f"[serve] {label} staleness oracle: stale I_D rel err "
                f"{stale['stale_rel_err']:.6f}, refreshed "
                f"{stale['refreshed_rel_err']:.6f} against a recompute at "
                f"the served weights; improved {stale['improved']}")
        log(f"[serve] {label} passes every serve --check gate")
        return stale

    def service(serve_spec):
        svc = S.ForgetService(cfg, tokens, domains, seq_len, serve=serve_spec,
                              device="cuda")
        for i, burst in enumerate(SERVE_BURSTS):
            for d in burst:
                svc.submit(d, due_batch=SERVE_AFTER + i)
        return svc, svc._rt

    def kernel_fleet(serve_spec, name):
        """A one-tenant Fleet on the lowering of ``serve_spec`` with the
        CUDA dampen kernels, the same weights and submissions."""
        low = serve_spec.to_unlearn_spec()
        fleet = Fleet()
        rt = fleet.add_tenant(
            name, cfg, tokens, domains, seq_len, params=params,
            spec=dataclasses.replace(low, exec=dataclasses.replace(
                low.exec, use_kernel=True)), device="cuda")
        for i, burst in enumerate(SERVE_BURSTS):
            for d in burst:
                fleet.submit(name, d, due_batch=SERVE_AFTER + i)

        def drain(p, idx):
            entries = fleet.drain(idx)
            return rt.params, any(e["ran"] for e in entries)
        return fleet, rt, drain

    runs, counts = {}, {}
    for path in ("fp32", "int8"):
        spec = ServeSpec(chunk_size=4, refresh_every=1, sweep_mode="scanned",
                         precision=path)
        # the serving default: the plain dampen (use_kernel=False)
        zero_counts()
        svc, rt = service(spec)
        p, fig = drive(f"{path} scanned", rt, svc.drain, generate=True)
        if dampen_counts() != (0, 0, 0, 0):
            raise AssertionError(f"serve {path}: the plain service launched "
                                 f"{dampen_counts()}")
        stale = gates(f"{path} scanned", rt, spec, p)
        if path == "int8":
            # every layer on the per-row grid of the tree its last drain
            # started from (the scanned program quantises per layer and
            # row, reached or not)
            if not lm_on_q8_grid(rt.adapter, p, fig.pop("last_in"),
                                 rt.adapter.n_layers):
                raise AssertionError("serve int8: a leaf left its q8 grid")
            log("[serve] int8 scanned: every leaf on its q8 grid")
        fig.pop("last_in", None)
        if path == "fp32":
            # where a batch's generate spends its time: NVML's busy share
            # (a batch launches some 230,000 kernels; torch.profiler's
            # trace of them took 43.6 s on an H100)
            prompts = torch.as_tensor(batches[0], device=dev).long()
            t0 = time.perf_counter()
            share, n_samples = nvml_busy(
                lambda: S.generate(p, cfg, prompts, SERVE_GEN, decode))
            gwall = time.perf_counter() - t0
            fig["gen_prof"] = (gwall, share)
            log(f"[profile] serve generate (8 x {SERVE_PROMPT} prompt, "
                f"{SERVE_GEN} tokens): wall {gwall * 1e3:.1f} ms, NVML busy "
                f"share {share:.3f} over {n_samples} samples")
        fisher = rt.unlearner.fisher_global
        runs[path] = {"fig": fig, "stale": stale,
                      "stops": [e["stopped_at_l"] for e in rt.log],
                      "macs": [e["macs_vs_ssd_pct"] for e in rt.log]}
        del svc, rt
        # the same with the CUDA dampen kernels on a one-tenant Fleet:
        # the served tree and the Fisher bit for bit
        zero_counts()                               # the [serve] path starts
        fleet, krt, kdrain = kernel_fleet(spec, f"kernel-{path}")
        kp, kfig = drive(f"{path} scanned kernel", krt, kdrain,
                         generate=False)
        kfig.pop("last_in")
        counts[path] = dampen_counts()              # the [serve] path ends
        gates(f"{path} scanned kernel", krt, spec, kp, staleness=False)
        mine = counts[path][:2] if path == "fp32" else counts[path][2:]
        other = counts[path][2:] if path == "fp32" else counts[path][:2]
        L = krt.adapter.n_layers
        n_leaves = sum(len(tree_leaves(krt.adapter.get_layer(params, j)))
                       for j in range(L))
        want = (2 * len(SERVE_BURSTS) * L, 2 * len(SERVE_BURSTS) * n_leaves)
        log(f"[serve] {path} kernel fleet: dampen launches {mine[0]} over "
            f"{mine[1]} leaves (expected {want}: each K = 2 scanned drain "
            f"walks every layer per set), other path {other}")
        if mine != want or other != (0, 0) or fisher_counts() != (0, 0, 0, 0):
            raise AssertionError(f"serve {path} kernel counts {counts[path]}")
        if not same(kp, p) or not same(krt.unlearner.fisher_global, fisher):
            raise AssertionError(f"serve {path}: the kernel fleet's tree or "
                                 f"Fisher != the plain service's")
        log(f"[serve] {path} kernel fleet == plain service, bit for bit: "
            f"all {len(stored)} served leaves and the Fisher")
        runs[path]["kernel_fig"] = kfig
        if path == "fp32":
            # the warm drain's profile: the second drain's sets again on
            # the kernel tenant's warm session
            reqs = []
            fbs = [krt._forget_batch(d)[0] for d in SERVE_BURSTS[1]]
            widest = max(len(fb) for fb in fbs)
            for d, fb in zip(SERVE_BURSTS[1], fbs):
                fb = krt._wrap_pad(fb, widest - len(fb))
                reqs.append(ForgetRequest(fb[:, :-1], fb[:, 1:], tag=d))
            busy, n_kernels, ranked = profile_request(
                lambda: krt.unlearner.forget_group(reqs, params=kp))
            damp = [(ms, c) for name, ms, c in ranked
                    if "dampen_group_kernel" in name]
            n_el = sum(t.numel() for j in range(L)
                       for t in tree_leaves(krt.adapter.get_layer(params, j)))
            runs[path]["prof"] = (busy, n_kernels, sum(c for _, c in damp),
                                  sum(ms for ms, _ in damp),
                                  (2 * n_el * 13 + 8 * 2 * L) / rate * 1e3)
            wall = kfig["drain_walls"][1]
            log(f"[profile] warm serve fp32 K=2 scanned drain (kernel): "
                f"wall {wall * 1e3:.1f} ms (refresh apart), device busy "
                f"{busy:.3f} ms, {n_kernels} device kernels, of them "
                f"{runs[path]['prof'][2]} dampen_group_kernel "
                f"({runs[path]['prof'][3]:.4f} ms; bound "
                f"{runs[path]['prof'][4]:.4f} ms for 2 x {n_el} bf16 "
                f"elements at 13 bytes)")
            for name, ms, c in ranked[:6]:
                log(f"[profile]   {ms:9.3f} ms  x{c:<5d} {name[:70]}")
            # layerwise: the same service's tree, bit for bit
            lspec = dataclasses.replace(spec, sweep_mode="layerwise")
            lsvc, lrt = service(lspec)
            lp, lfig = drive("fp32 layerwise", lrt, lsvc.drain,
                             generate=False)
            lfig.pop("last_in")
            gates("fp32 layerwise", lrt, lspec, lp, staleness=False)
            if not same(lp, p) or not same(lrt.unlearner.fisher_global,
                                           fisher):
                raise AssertionError("serve: layerwise != scanned")
            log(f"[serve] fp32 layerwise == scanned, bit for bit; drain "
                f"walls {[round(w * 1e3, 1) for w in lfig['drain_walls']]} "
                f"ms against scanned "
                f"{[round(w * 1e3, 1) for w in fig['drain_walls']]} ms")
            runs[path]["layerwise_fig"] = lfig
            del lsvc, lrt, lp
        del fleet, krt, kp, p, fisher
        torch.cuda.empty_cache()
    # a guarded abort: a nan_batch fault in both attempts of the group,
    # a finite guard with one retry at a backoff of one batch
    gspec = ServeSpec(chunk_size=4, sweep_mode="scanned",
                      guard=GuardSpec())
    fleet = Fleet()
    grt = fleet.add_tenant("guarded", cfg, tokens, domains, seq_len,
                           params=params, spec=gspec.to_unlearn_spec(),
                           device="cuda")
    for d in SERVE_BURSTS[0]:
        fleet.submit("guarded", d, due_batch=SERVE_AFTER)
    inj = faults.FaultInjector([faults.FaultSpec("nan_batch",
                                                 tenant="guarded", count=2)])
    prev = faults.install(inj)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e1 = fleet.drain(SERVE_AFTER)
        e2 = fleet.drain(SERVE_AFTER + 1)
        torch.cuda.synchronize()
        gsecs = time.perf_counter() - t0
    finally:
        faults.install(prev)
    acts = [e["aborted"]["action"] if e.get("aborted") else None
            for e in e1 + e2]
    acc = fleet.accounting()["guarded"]
    log(f"[serve] guarded nan_batch drains: actions {acts}, abort guards "
        f"{[a['guard'] for a in grt.abort_log]} at leaves "
        f"{[a.get('leaf') for a in grt.abort_log]}, dead-lettered "
        f"{fleet.scheduler.dead('guarded')}, requeues "
        f"{fleet.scheduler.requeues['guarded']}, accounting {acc}, fired "
        f"{len(inj.fired)}; {gsecs:.1f} s")
    if (acts != ["requeue", "dead_letter"] or grt.groups != 0
            or [a["guard"] for a in grt.abort_log] != ["finite", "finite"]
            or fleet.scheduler.dead("guarded") != 2 or not acc["ok"]
            or grt.params is not params or len(inj.fired) != 2):
        raise AssertionError("serve guarded abort: the drain was not "
                             "rejected, requeued and dead-lettered")
    for k, t in stored.items():
        if not torch.equal(bits(t), bits(before[k])):
            raise AssertionError(f"serve: the live tree's {k} changed")
    log("[serve] the live tree bit for bit as it was after the rejected "
        "drains (and after every service)")
    del fleet, grt, before
    peak = torch.cuda.max_memory_allocated() / gib
    secs = time.perf_counter() - t_phase
    log(f"[serve] phase done in {secs:.1f} s; torch.cuda.max_memory_allocated"
        f" {peak:.2f} GiB")
    busy, n_kernels, n_damp, damp_ms, bound = runs["fp32"]["prof"]
    out = {}
    for path in ("fp32", "int8"):
        c = counts[path]
        fig, kfig = runs[path]["fig"], runs[path]["kernel_fig"]
        out[path] = {
            "serve_launches": c[0] if path == "fp32" else c[2],
            "serve_leaves": c[1] if path == "fp32" else c[3],
            "serve_drain_walls_ms": [w * 1e3 for w in fig["drain_walls"]],
            "serve_kernel_drain_walls_ms": [
                w * 1e3 for w in kfig["drain_walls"]],
            "serve_refresh_walls_ms": [w * 1e3 for w in fig["refresh_walls"]],
            "serve_generate_tokens_per_s": [t for _, t in fig["gen"]],
            "serve_stale_rel_err": runs[path]["stale"]["stale_rel_err"],
            "serve_refreshed_rel_err":
                runs[path]["stale"]["refreshed_rel_err"],
            "serve_stopped_at_l": runs[path]["stops"],
        }
    gwall, gshare = runs["fp32"]["fig"].pop("gen_prof")
    out["fp32"].update({
        "serve_generate_wall_ms": gwall * 1e3,
        "serve_generate_nvml_busy_share": gshare,
        "serve_layerwise_drain_walls_ms": [
            w * 1e3 for w in runs["fp32"]["layerwise_fig"]["drain_walls"]],
        "serve_warm_drain_device_busy_ms": busy,
        "serve_warm_drain_device_kernels": n_kernels,
        "serve_warm_drain_dampen_launches": n_damp,
        "serve_warm_drain_dampen_ms": damp_ms,
        "serve_warm_drain_dampen_bound_ms": bound,
        "serve_guarded_seconds": gsecs,
        "serve_peak_gib": peak, "serve_phase_seconds": secs})
    del params, stored, runs
    torch.cuda.empty_cache()
    return out


# [stream] (phase 17): the continuous-batching StreamEngine on gemma3-1b
# FULL weights and data of its own (the 26 blocks [serve] ran before it was
# cut to SERVE_BLOCKS: at 12 blocks the near-tie gate below, calibrated at
# 26, met a grouping flip at a top-2 gap of 0.0163, PERF.md section 6):
# the traffic of serve --serve-mode
# stream (3 x 8 = 24 sequences of SERVE_PROMPT tokens, SERVE_GEN generated
# each), 8 decode slots, admission in chunks of 4 with a prefill block of
# 8, bursts "1,2;3,2" due at engine steps 32 and 64 (SERVE_AFTER + k times
# SERVE_GEN) and published 16 steps after they fire; a shadow drain is
# ficabu (alpha 8, tau 0.6, chunk 4, scanned) with a refresh after it
STREAM_BATCH = 8
STREAM_ADMIT = 4
STREAM_PREFILL = 8
STREAM_LAG = 16
# the faulted run: one wave of 8 sequences of 8 tokens, a lag of 2 steps
STREAM_FAULT_GEN = 8
STREAM_FAULT_LAG = 2
# a token of the first wave that differs from generate's is excused only
# where generate's top-2 logit gap is below this (a near-tie)
STREAM_TIE_GAP = 1e-2


def serve_weights(dev):
    """[stream]'s config (gemma3-1b FULL), weights and data, seeded as
    [serve]'s, and the tokens ``generate`` gives its batch 0."""
    from repro_torch.configs import get as get_arch
    from repro_torch.data import synthetic as syn
    from repro_torch.launch import serve as S
    from repro_torch.models import lm as LM

    cfg = get_arch(SERVE_ARCH).full
    params = LM.init_lm(torch.Generator(device=dev).manual_seed(SEED), cfg,
                        device="cuda")
    seq_len = SERVE_PROMPT + SERVE_GEN
    tokens, domains = syn.make_lm_domains(syn.LMDataConfig(
        vocab=LM_DATA_VOCAB, n_domains=4, seq_len=seq_len, n_per_domain=16,
        seed=SEED))
    prompts = torch.as_tensor(tokens[:SERVE_REQUESTS, :SERVE_PROMPT],
                              device=dev).long()
    with deterministic_algorithms():
        gen0 = S.generate(params, cfg, prompts, SERVE_GEN,
                          lambda p, c, t, pos: LM.decode_step(p, cfg, t, c,
                                                              pos))
    return {"cfg": cfg, "params": params, "tokens": tokens,
            "domains": domains, "seq_len": seq_len, "gen0": gen0}


def stream_phase(dev, rate, zero_counts, dampen_counts, fisher_counts):
    """Phase 17, [stream] (module docstring), under deterministic
    algorithms, on ``serve_weights``. Returns the figures the kernels line
    carries."""
    with deterministic_algorithms():
        return _stream_phase(dev, rate, zero_counts, dampen_counts,
                             fisher_counts, serve_weights(dev))


def _stream_phase(dev, rate, zero_counts, dampen_counts, fisher_counts,
                  sh):
    import dataclasses

    import numpy as np

    from repro_torch import bridge
    from repro_torch.api import ServeSpec
    from repro_torch.launch import serve as S
    from repro_torch.models import lm as LM
    from repro_torch.models.module import tree_leaves
    from repro_torch.obs import telemetry
    from repro_torch.robust import faults
    from repro_torch.robust.guards import GuardSpec

    t_phase = time.perf_counter()
    gib = 2.0 ** 30
    torch.cuda.reset_peak_memory_stats()
    cfg, params, tokens, domains, seq_len, gen0 = (
        sh[k] for k in ("cfg", "params", "tokens", "domains", "seq_len",
                        "gen0"))
    stored = bridge.paths(params)
    before = {k: v.clone() for k, v in stored.items()}
    n_seq = SERVE_BATCHES * SERVE_REQUESTS
    prompts = np.asarray(tokens[:, :SERVE_PROMPT])
    fires = [(SERVE_AFTER + i) * SERVE_GEN for i in range(len(SERVE_BURSTS))]
    deadlines = [f + STREAM_LAG for f in fires]
    spec = ServeSpec(chunk_size=4, refresh_every=1, sweep_mode="scanned",
                     publish="step", max_batch=STREAM_BATCH,
                     admit_chunk=STREAM_ADMIT, publish_lag=STREAM_LAG)
    log(f"[stream] {cfg.name} FULL ({cfg.n_layers} blocks, {len(stored)} "
        f"stored leaves), weights and data seeded as [serve]'s: {n_seq} "
        f"sequences of "
        f"{SERVE_PROMPT} prompt tokens, {SERVE_GEN} generated each, "
        f"{STREAM_BATCH} slots, admission chunks of {STREAM_ADMIT} "
        f"(prefill block {STREAM_PREFILL}), bursts {SERVE_BURSTS} fired at "
        f"steps {fires}, publication deadlines {deadlines}; {spec}")

    def run(label, use_kernel):
        """One engine run, the [stream] path's counters zeroed just before
        and read just after; after the last publication each step_once
        runs under set_sync_debug_mode("error")."""
        svc = S.ForgetService(cfg, tokens, domains, seq_len, serve=spec,
                              device="cuda")
        if use_kernel:
            low = svc.spec
            svc._rt.spec = dataclasses.replace(low, exec=dataclasses.replace(
                low.exec, use_kernel=True))
        for f, burst in zip(fires, SERVE_BURSTS):
            for d in burst:
                svc.submit(d, due_batch=f)
        eng = S.StreamEngine(params, cfg, gen_len=SERVE_GEN,
                             prompt_len=SERVE_PROMPT,
                             max_batch=STREAM_BATCH,
                             admit_chunk=STREAM_ADMIT,
                             prefill_block=STREAM_PREFILL,
                             publish_lag=STREAM_LAG, service=svc,
                             device="cuda")
        worker_walls = []
        shadow = svc.run_shadow_guarded

        def timed(payloads, step):
            t0 = time.perf_counter()
            out = shadow(payloads, step)
            worker_walls.append(time.perf_counter() - t0)
            return out
        svc.run_shadow_guarded = timed
        for i in range(n_seq):
            eng.enqueue(i, prompts[i % len(prompts)])
        inflight, guarded = [], 0
        zero_counts()                          # the [stream] path starts
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with telemetry.capture() as cap:
            while eng.pending or any(s is not None for s in eng.slot_seq):
                busy = any(not p[1].done() for p in eng._pending_pubs)
                quiet = (eng.step > deadlines[-1] and not eng._pending_pubs
                         and not svc.scheduler.pending())
                if quiet:
                    torch.cuda.set_sync_debug_mode("error")
                    try:
                        eng.step_once()
                    finally:
                        torch.cuda.set_sync_debug_mode(0)
                    guarded += 1
                else:
                    eng.step_once()
                # a drain in flight: its sweep ran on the worker at the
                # start or the end of the step (the step that fires it, and
                # the one that waits for it at its deadline, among them)
                inflight.append(busy or any(not p[1].done()
                                            for p in eng._pending_pubs))
            results = eng.finish()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = dampen_counts()               # the [stream] path ends
        others = fisher_counts()
        pubs = [e["step"] for e in cap.events
                if e["kind"] == "params.publish"]
        problems = S.stream_check_problems(eng, svc, n_seq, results)
        if pubs != deadlines:
            problems.append(f"publications at steps {pubs}, deadlines "
                            f"{deadlines}")
        if len(svc.group_log) != len(SERVE_BURSTS) or not guarded:
            problems.append(f"{len(svc.group_log)} drain groups, {guarded} "
                            f"guarded steps")
        if problems:
            raise AssertionError(f"stream {label} check: {problems}")
        walls = [w * 1e3 for w in eng.step_wall]
        drain = sorted(w for w, f in zip(walls, inflight) if f)
        rest = sorted(w for w, f in zip(walls, inflight) if not f)
        n_tok = sum(r.size for r in results.values())
        fig = {"steps": eng.step, "secs": secs, "tokens": n_tok,
               "p50": S._percentile(rest, 0.5), "p99": S._percentile(rest,
                                                                     0.99),
               "drain_p50": S._percentile(drain, 0.5),
               "drain_p99": S._percentile(drain, 0.99),
               "drain_steps": len(drain), "worker": worker_walls,
               "guarded": guarded, "counts": counts}
        log(f"[stream] {label}: {len(results)} sequences, {n_tok} tokens in "
            f"{eng.step} steps, {secs:.2f} s ({n_tok / secs:.1f} tokens/s); "
            f"publications at steps {pubs} (versions "
            f"{[e['version'] for e in cap.events if e['kind'] == 'params.publish']}"
            f"); decode step wall p50 {fig['p50']:.2f} / p99 "
            f"{fig['p99']:.2f} ms over {len(rest)} steps without a drain in "
            f"flight, p50 {fig['drain_p50']:.2f} / p99 "
            f"{fig['drain_p99']:.2f} ms over {len(drain)} steps with one; "
            f"worker walls per drain "
            f"{[round(w * 1e3, 1) for w in worker_walls]} ms; drains "
            f"{[(g['domains'], g['sweep_sig'], g['engine']['sweep_mode']) for g in svc.group_log]}"
            f", stopped_at_l {[e['stopped_at_l'] for e in svc.log]}; "
            f"{guarded} warm step_once under set_sync_debug_mode('error'); "
            f"dampen launches {counts[0]} over {counts[1]} leaves, int8 "
            f"{counts[2:]}, fimd/gemm/rowscale {others}; one decode "
            f"signature; every stream --check gate holds")
        if not all(torch.isfinite(t).all() for t in tree_leaves(eng.params)):
            raise AssertionError(f"stream {label}: non-finite parameters")
        return {"results": results, "params": eng.params,
                "fisher": svc.unlearner.fisher_global, "fig": fig,
                "fingerprint": S.engine_fingerprint(cap.events),
                "others": others}

    kernel = run("kernel", True)
    plain = run("plain", False)
    adapter = S.ForgetService(cfg, tokens, domains, seq_len, serve=spec,
                              device="cuda").adapter
    L = adapter.n_layers
    n_leaves = sum(len(tree_leaves(adapter.get_layer(params, j)))
                   for j in range(L))
    want = (2 * len(SERVE_BURSTS) * L, 2 * len(SERVE_BURSTS) * n_leaves)
    kc, pc = kernel["fig"]["counts"], plain["fig"]["counts"]
    if kc != want + (0, 0) or pc != (0, 0, 0, 0) or \
            kernel["others"] != (0, 0, 0, 0):
        raise AssertionError(f"stream counts: kernel {kc}, plain {pc}, "
                             f"expected {want}")
    log(f"[stream] kernel run: dampen launches {kc[0]} over {kc[1]} leaves "
        f"(expected {want}: 2 drains x 2 sets x {L} layers); plain run "
        f"{pc[0]} launches")

    def same(p, q):
        a, b = bridge.paths(p), bridge.paths(q)
        return sorted(a) == sorted(b) and all(
            torch.equal(bits(a[k]), bits(b[k])) for k in a)

    if kernel["fingerprint"] != plain["fingerprint"]:
        raise AssertionError("stream: the two runs' engine fingerprints "
                             "differ")
    if not same(kernel["params"], plain["params"]) or \
            not same(kernel["fisher"], plain["fisher"]):
        raise AssertionError("stream: the kernel run's published tree or "
                             "Fisher != the plain run's")
    diff = [s for s in range(n_seq) if not np.array_equal(
        kernel["results"][s], plain["results"][s])]
    if diff:
        raise AssertionError(f"stream: sequences {diff} differ between the "
                             f"kernel and the plain run")
    log(f"[stream] kernel run == plain run, bit for bit: the published "
        f"tree ({len(stored)} leaves), the Fisher, all {n_seq} sequences' "
        f"tokens; engine fingerprints equal ({kernel['fingerprint'][:16]})")
    # the first wave (batch 0's prompts, done before the first
    # publication) against generate of batch 0 on the same weights. The
    # engine
    # prefills them in admission chunks of STREAM_ADMIT rows where generate
    # prefills all 8 at once: a [4 x 8, D] product sums in another order
    # than an [8 x 8, D] one, so a bf16 rounding may land on the other side
    # (as decode beside the forward, DECODE_RTOL). Where a token differs,
    # generate's top-2 logit gap at the first differing position must be
    # below STREAM_TIE_GAP; and a replica of the engine's grouping (prefill
    # per admission chunk, the rows scattered into a pool of 8, decode at
    # per-row positions) must give every token of the wave bit for bit and
    # choose the engine's token there, and its logits, teacher-forced on
    # generate's tokens, must lie within DECODE_RTOL (relative L2) of
    # generate's
    got0 = np.stack([plain["results"][s] for s in range(SERVE_REQUESTS)])
    rows = [b for b in range(SERVE_REQUESTS)
            if not np.array_equal(got0[b], gen0[b])]
    flips = []
    if rows:
        P, S_len = SERVE_PROMPT, SERVE_PROMPT + SERVE_GEN
        pr = torch.as_tensor(tokens[:SERVE_REQUESTS, :P], device=dev).long()
        forced = torch.as_tensor(gen0, device=dev).long()

        def walk(grouped, force):
            """(greedy tokens [8, G], logits [8, G, V]) of one grouping,
            teacher-forced on ``force`` when given."""
            B = SERVE_REQUESTS
            with torch.no_grad():
                if grouped:
                    cache = LM.init_cache(cfg, B, S_len, device="cuda")
                    firsts = []
                    for a in range(0, B, STREAM_ADMIT):
                        lg, sub = LM.prefill(
                            params, cfg, pr[a:a + STREAM_ADMIT],
                            LM.init_cache(cfg, STREAM_ADMIT, S_len,
                                          device="cuda"),
                            block=STREAM_PREFILL)
                        firsts.append(lg[:, -1])
                        cache = LM.scatter_cache_rows(cache, sub, torch.arange(
                            a, a + STREAM_ADMIT, device=dev))
                    lg = torch.cat(firsts)
                else:
                    lg, cache = LM.prefill(params, cfg, pr, LM.init_cache(
                        cfg, B, S_len, device="cuda"), block=STREAM_PREFILL)
                    lg = lg[:, -1]
                logits, toks = [lg], [torch.argmax(lg, -1)]
                for j in range(SERVE_GEN - 1):
                    tok = (force[:, j] if force is not None else toks[-1])
                    pos = (torch.full((B,), P + j, device=dev)
                           if grouped else P + j)
                    lg, cache = LM.decode_step(params, cfg, tok[:, None],
                                               cache, pos)
                    logits.append(lg[:, -1])
                    toks.append(torch.argmax(lg[:, -1], -1))
            return (torch.stack(toks, 1).cpu().numpy(),
                    torch.stack(logits, 1))

        replica, _ = walk(True, None)
        _, lg_gen = walk(False, forced)
        _, lg_rep = walk(True, forced)
        rel = float(torch.linalg.vector_norm(lg_rep - lg_gen)
                    / torch.linalg.vector_norm(lg_gen))
        top2 = lg_gen.topk(2, dim=-1).values.cpu()
        for b in rows:
            j = int(np.nonzero(got0[b] != gen0[b])[0][0])
            gap = float(top2[b, j, 0] - top2[b, j, 1])
            chose = int(torch.argmax(lg_rep[b, j]))
            flips.append((b, j, gap, chose == int(got0[b, j])))
            log(f"[stream] sequence {b}: first token that differs from "
                f"generate at position {j}, generate's top-2 logit gap "
                f"there {gap:.6f}; the grouping replica chooses the "
                f"engine's token there: {chose == int(got0[b, j])}")
        log(f"[stream] the engine's grouping replayed: its tokens == the "
            f"engine's first wave bit for bit: "
            f"{np.array_equal(replica, got0)}; its logits teacher-forced "
            f"on generate's tokens within relative L2 {rel:.6f} of "
            f"generate's (DECODE_RTOL {DECODE_RTOL})")
        if not np.array_equal(replica, got0) or rel > DECODE_RTOL or \
                not all(f[3] and f[2] < STREAM_TIE_GAP for f in flips):
            raise AssertionError(f"stream: tokens differ from generate's "
                                 f"beyond the grouping: {flips}, rel {rel}")
        del lg_gen, lg_rep
    log(f"[stream] the first {SERVE_REQUESTS} sequences (batch 0's prompts, "
        f"generated before the first publication) == generate of "
        f"batch 0 in {SERVE_REQUESTS - len(rows)} of {SERVE_REQUESTS} rows"
        + (f"; the others first differ at (row, position, generate's "
           f"top-2 gap) {[f[:3] for f in flips]}, the engine's grouping "
           f"replayed bit for bit" if rows else ""))
    fig_k, fig_p = kernel["fig"], plain["fig"]
    del kernel, plain
    torch.cuda.empty_cache()

    # a worker exception in both attempts of a guarded drain: aborted at
    # its deadline and requeued, then dead-lettered; the live tree serves on
    gspec = ServeSpec(chunk_size=4, sweep_mode="scanned", publish="step",
                      max_batch=STREAM_BATCH, admit_chunk=STREAM_ADMIT,
                      publish_lag=STREAM_FAULT_LAG, guard=GuardSpec())
    svc = S.ForgetService(cfg, tokens, domains, seq_len, serve=gspec,
                          device="cuda")
    for d in SERVE_BURSTS[0]:
        svc.submit(d, due_batch=1)
    eng = S.StreamEngine(params, cfg, gen_len=STREAM_FAULT_GEN,
                         prompt_len=SERVE_PROMPT, max_batch=STREAM_BATCH,
                         admit_chunk=STREAM_ADMIT,
                         prefill_block=STREAM_PREFILL,
                         publish_lag=STREAM_FAULT_LAG, service=svc,
                         device="cuda")
    for i in range(STREAM_BATCH):
        eng.enqueue(i, prompts[i])
    inj = faults.FaultInjector([faults.FaultSpec("worker_exc",
                                                 tenant="default",
                                                 count=2)])
    prev = faults.install(inj)
    t0 = time.perf_counter()
    try:
        with telemetry.capture() as cap:
            fres = eng.run()
    finally:
        faults.install(prev)
    fsecs = time.perf_counter() - t0
    acts = [(e["batch"], e["action"]) for e in cap.events
            if e["kind"] == "drain.abort"]
    acc = svc._fleet.accounting()["default"]
    log(f"[stream] worker_exc in both attempts: {len(fres)} sequences in "
        f"{eng.step} steps; aborts {eng.aborts} (actions at batches "
        f"{acts}), dead-lettered {svc.scheduler.dead()}, publications "
        f"{eng.publications}, accounting {acc}; {fsecs:.1f} s")
    if (eng.aborts != 2 or [a for _, a in acts] != ["requeue", "dead_letter"]
            or svc.scheduler.dead() != 2 or eng.publications != 0
            or not acc["ok"] or eng.params is not params
            or len(inj.fired) != 2 or len(fres) != STREAM_BATCH):
        raise AssertionError("stream worker_exc: the drain was not "
                             "aborted, requeued and dead-lettered")
    for k, t in stored.items():
        if not torch.equal(bits(t), bits(before[k])):
            raise AssertionError(f"stream: the live tree's {k} changed")
    log("[stream] the live tree bit for bit as it was after every run")
    del svc, eng, before
    peak = torch.cuda.max_memory_allocated() / gib
    secs = time.perf_counter() - t_phase
    log(f"[stream] phase done in {secs:.1f} s; torch.cuda.max_memory_"
        f"allocated {peak:.2f} GiB")
    return {
        "stream_launches": fig_k["counts"][0],
        "stream_leaves": fig_k["counts"][1],
        "stream_plain_launches": fig_p["counts"][0],
        "stream_steps": fig_p["steps"],
        "stream_tokens_per_s": fig_p["tokens"] / fig_p["secs"],
        "stream_kernel_tokens_per_s": fig_k["tokens"] / fig_k["secs"],
        "stream_step_p50_ms": fig_p["p50"], "stream_step_p99_ms":
            fig_p["p99"],
        "stream_drain_step_p50_ms": fig_p["drain_p50"],
        "stream_drain_step_p99_ms": fig_p["drain_p99"],
        "stream_drain_steps": fig_p["drain_steps"],
        "stream_kernel_step_p50_ms": fig_k["p50"],
        "stream_kernel_drain_step_p99_ms": fig_k["drain_p99"],
        "stream_worker_drain_walls_ms": [w * 1e3 for w in fig_p["worker"]],
        "stream_kernel_worker_drain_walls_ms": [
            w * 1e3 for w in fig_k["worker"]],
        "stream_guarded_steps": fig_p["guarded"] + fig_k["guarded"],
        "stream_generate_rows_equal": SERVE_REQUESTS - len(rows),
        "stream_generate_first_diffs": [list(f[:3]) for f in flips],
        "stream_fault_seconds": fsecs,
        "stream_peak_gib": peak, "stream_phase_seconds": secs}


# [fleet] (phase 18), [recover] (19) and [load] (20): --fleet's loop on two
# gemma3-1b tenants (seeds 0 and 1: one family) with the reference
# CLI's traffic, built by the card's own builder (data at LM_DATA_VOCAB)
FLEET_SPEC = {"tenants": [{"name": "t0", "arch": SERVE_ARCH, "seed": 0},
                          {"name": "t1", "arch": SERVE_ARCH, "seed": 1}],
              "serve": {"chunk_size": 4}}
FLEET_TRAFFIC = {"requests": 8, "prompt_len": 16, "gen_len": 8,
                 "prefill_block": 8, "unlearn_after": 1,
                 "forget_domains": "1,2;3,2", "coalesce": False,
                 "forget_domain": 1}
# [recover]: gemma3-1b at full width and one local/global period of its
# blocks, sequences of RECOVER_SEQ tokens
# the depth of [fleet]'s and [load]'s gemma3-1b tenants (None: all 26; 12
# since the [qwen] and [dryrun] phases, 31.6 -> 13.6 s and 44.6 -> 17.6 s
# on an NVIDIA H100 80GB HBM3 at 700 W; one period, 6, since the
# [examples] phase, PERF.md section 4)
FLEET_BLOCKS = 6
RECOVER_BLOCKS = 6
RECOVER_SEQ = 128
# [load]: the harness's virtual ticks
LOAD_TICKS = 8


def card_lm_tenant(tspec, seq_len, n_layers=None, n_per_domain=16):
    """The card's tenant builder: ``serve._build_lm_tenant`` at FULL width
    (``n_layers`` cuts the depth), with its data at LM_DATA_VOCAB (the
    model's 262,144 cannot be drawn, [serve])."""
    from repro_torch.configs import get as get_arch
    from repro_torch.data import synthetic as syn
    from repro_torch.models import lm as LM

    cfg = get_arch(tspec.arch).full
    if n_layers is not None:
        cfg = cfg.with_(n_layers=n_layers)
    params = LM.init_lm(torch.Generator(device="cuda").manual_seed(
        tspec.seed), cfg, device="cuda")
    tokens, domains = syn.make_lm_domains(syn.LMDataConfig(
        vocab=LM_DATA_VOCAB, n_domains=4, seq_len=seq_len,
        n_per_domain=n_per_domain, seed=tspec.seed))
    return {"cfg": cfg, "tokens": tokens, "domains": domains,
            "seq_len": seq_len, "params": params}


def fleet_phase(dev, zero_counts, dampen_counts, fisher_counts):
    """Phase 18, [fleet]: ``serve.run_fleet`` and every gate of
    ``fleet_check_problems`` (module docstring), under deterministic
    algorithms."""
    import types

    from repro_torch.fleet import FleetSpec
    from repro_torch.launch import serve as S
    from repro_torch.models.module import tree_leaves

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    args = types.SimpleNamespace(**FLEET_TRAFFIC)
    fspec = FleetSpec.from_dict(FLEET_SPEC)

    def build(t):
        return card_lm_tenant(t, args.prompt_len + args.gen_len,
                              n_layers=FLEET_BLOCKS)

    with deterministic_algorithms():
        zero_counts()                          # the [fleet] path starts
        fleet, result = S.run_fleet(fspec, build, args, device="cuda")
        counts = dampen_counts() + fisher_counts()   # the path ends
        t_check = time.perf_counter()
        problems = S.fleet_check_problems(fleet, fspec, build)
        check_secs = time.perf_counter() - t_check
    pick = S._shared_family_tenant(fleet, fspec)
    for name, rt in fleet.tenants.items():
        if not all(torch.isfinite(t).all() for t in tree_leaves(rt.params)):
            problems.append(f"tenant {name}: non-finite parameters")
    if any(counts):
        problems.append(f"the plain fleet launched kernels {counts}")
    if problems:
        raise AssertionError(f"fleet check: {problems}")
    st = fleet.programs.stats()
    for name, rt in fleet.tenants.items():
        log(f"[fleet] tenant {name}: drains "
            f"{[(g['batch'], g['domains'], g['sweep_sig'], g['engine']['compiles'], g['engine']['cache_hits']) for g in rt.group_log]}"
            f" (batch, domains, signature, builds, hits); served "
            f"{[(e['batch'], e['tokens'], e['latency_s']) for e in result['served'][name]]}"
            f" (batch, tokens, latency s)")
    secs = time.perf_counter() - t_phase
    peak = torch.cuda.max_memory_allocated() / 2.0 ** 30
    depth = "FULL" if FLEET_BLOCKS is None else f"{FLEET_BLOCKS}-block"
    log(f"[fleet] fleet check ok: {len(fleet.tenants)} gemma3-1b {depth} "
        f"tenants, {sum(rt.groups for rt in fleet.tenants.values())} drain "
        f"groups; the shared cache built {st['compiles']} programs and hit "
        f"{st['hits']} times across {st['sessions']} sessions; tenant "
        f"{pick!r} replayed alone on a fresh cache: bit for bit, the same "
        f"builds ({check_secs:.1f} s); phase {secs:.1f} s, peak {peak:.2f} "
        f"GiB")
    del fleet, result
    torch.cuda.empty_cache()
    return {"fleet_builds": st["compiles"], "fleet_hits": st["hits"],
            "fleet_phase_seconds": secs, "fleet_peak_gib": peak}


def recover_fleet(wal_dir=None):
    """[recover]'s one-tenant fleet: gemma3-1b at full width and
    RECOVER_BLOCKS blocks from the seed, ficabu (alpha 8, tau 0.6,
    checkpoints every 2 layers, chunk 4, scanned), a WAL in ``wal_dir``.
    The victim process and the parent build it alike."""
    from repro_torch.api import UnlearnSpec
    from repro_torch.fleet import Fleet, TenantSpec
    from repro_torch.robust import ForgetWAL

    b = card_lm_tenant(TenantSpec("a", arch=SERVE_ARCH, seed=SEED),
                       RECOVER_SEQ, n_layers=RECOVER_BLOCKS, n_per_domain=8)
    fleet = Fleet()
    rt = fleet.add_tenant("a", b["cfg"], b["tokens"], b["domains"],
                          b["seq_len"], params=b["params"],
                          spec=UnlearnSpec.for_mode(
                              "ficabu", alpha=8.0, lam=1.0, tau=0.6,
                              checkpoint_every=2, chunk_size=4,
                              sweep_mode="scanned"), device="cuda")
    if wal_dir is not None:
        rt.wal = ForgetWAL(wal_dir, "a")
    return fleet, rt


# the [recover] victim: drain once, checkpoint, WAL-accept a second request,
# die by SIGKILL at the top of its drain
_VICTIM = """
import sys
import torch
sys.path.insert(0, sys.argv[3])
import chip_smoke as cs
from repro_torch.robust import FaultInjector, FaultSpec, faults

torch.use_deterministic_algorithms(True, warn_only=True)
fleet, rt = cs.recover_fleet(sys.argv[1])
fleet.submit("a", 1, due_batch=1)
fleet.drain(1)
fleet.checkpoint(sys.argv[2])
fleet.submit("a", 2, due_batch=2)
faults.install(FaultInjector([FaultSpec("kill_mid_drain", tenant="a")]))
fleet.drain(2)
print("UNREACHABLE", flush=True)
"""


def recover_phase(dev):
    """Phase 19, [recover]: the reference's kill-mid-drain scenario on the
    card (module docstring), under deterministic algorithms."""
    import shutil
    import tempfile

    from repro_torch import bridge
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.robust import ForgetWAL, faults

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="recover_", dir=ROOT / "build"))
    wal_dir, ckpt_dir = str(tmp / "wal"), str(tmp / "ckpt")
    try:
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", _VICTIM, wal_dir,
                               ckpt_dir, str(ROOT)], env=env,
                              capture_output=True, text=True, timeout=600)
        vsecs = time.perf_counter() - t0
        if proc.returncode != -9 or "UNREACHABLE" in proc.stdout:
            raise AssertionError(f"recover victim exited {proc.returncode}: "
                                 f"{proc.stderr[-2000:]}")
        size = sum(f.stat().st_size for f in (tmp / "ckpt").rglob("*")
                   if f.is_file())
        wacc = ForgetWAL(wal_dir, "a").accounting()
        if wacc != {"accepted": 2, "applied": 1, "dead": 0, "pending": 1}:
            raise AssertionError(f"recover: the victim's WAL {wacc}")
        with deterministic_algorithms():
            fleet, rt = recover_fleet(wal_dir)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            report = fleet.recover(ckpt_dir)["a"]
            torch.cuda.synchronize()
            rsecs = time.perf_counter() - t0
            twin, rt_twin = recover_fleet()
            twin.submit("a", 1, due_batch=1)
            twin.drain(1)
            twin.submit("a", 2, due_batch=2)
            twin.drain(2)
        n_leaves = len(bridge.paths(rt.params))
        log(f"[recover] victim ({RECOVER_BLOCKS} of 26 blocks at full width,"
            f" {n_leaves} stored leaves) drained, checkpointed "
            f"({size / 1e9:.2f} GB on disk), WAL-accepted request 2 and was "
            f"SIGKILLed mid-drain: exit {proc.returncode}, {vsecs:.1f} s; "
            f"WAL {wacc}; recover: {report} in {rsecs:.1f} s, version "
            f"{rt.params_version}, WAL {rt.wal.accounting()}")
        if (report["restored_step"] != 1 or report["restored_version"] != 1
                or len(report["replayed"]) != 1 or rt.params_version != 2
                or rt.wal.accounting() != {"accepted": 2, "applied": 2,
                                           "dead": 0, "pending": 0}):
            raise AssertionError(f"recover: {report}")

        def same(p, q):
            a, b = bridge.paths(p), bridge.paths(q)
            return sorted(a) == sorted(b) and all(
                torch.equal(bits(a[k]), bits(b[k])) for k in a)

        if not same(rt.params, rt_twin.params) or not same(
                rt.unlearner.fisher_global, rt_twin.unlearner.fisher_global):
            raise AssertionError("recover: params or Fisher != the "
                                 "uninterrupted twin's")
        log("[recover] recovered params and Fisher == the uninterrupted "
            "twin's, bit for bit")
        # a checkpoint cut between its shard and META is never restored
        prev = faults.install(faults.FaultInjector(
            [faults.FaultSpec("ckpt_crash")]))
        try:
            fleet.checkpoint(ckpt_dir)
            raise AssertionError("recover: ckpt_crash did not fire")
        except RuntimeError as e:
            if "ckpt_crash" not in str(e):
                raise
        finally:
            faults.install(prev)
        cut = Path(ckpt_dir) / "a" / "step_00000002"
        latest = ckpt.latest_step(str(Path(ckpt_dir) / "a"))
        if latest != 1 or not (cut / "host_0.npz").exists() \
                or (cut / "META.json").exists():
            raise AssertionError(f"recover: latest_step {latest} after a "
                                 f"cut step")
        log(f"[recover] a checkpoint of version 2 cut by ckpt_crash (shard "
            f"written, META withheld): latest_step still {latest}")
        del fleet, rt, twin, rt_twin
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t_phase
    log(f"[recover] phase done in {secs:.1f} s")
    return {"recover_victim_seconds": vsecs, "recover_seconds": rsecs,
            "recover_checkpoint_bytes": size,
            "recover_phase_seconds": secs}


def load_phase(dev):
    """Phase 20, [load]: ``LoadHarness`` twice on freshly built [fleet]-
    like fleets and ``report --slo`` (module docstring); the harness runs
    under deterministic algorithms on the card."""
    import shutil
    import tempfile

    from repro_torch.fleet import Fleet, FleetSpec
    from repro_torch.load import ArrivalSpec, LoadHarness, LoadScenario, SLOSpec
    from repro_torch.obs import report, telemetry

    t_phase = time.perf_counter()
    sc = LoadScenario(ticks=LOAD_TICKS,
                      forget=ArrivalSpec(kind="poisson", rate=0.5),
                      serve_generate=False, domains=3, seed=0)
    seq_len = FLEET_TRAFFIC["prompt_len"] + FLEET_TRAFFIC["gen_len"]
    slo = SLOSpec(max_queue_depth=2 * LOAD_TICKS, max_dead_letter_fraction=0.0)
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="load_", dir=ROOT / "build"))
    runs = []
    try:
        for i in range(2):
            fleet = Fleet.from_spec(
                FleetSpec.from_dict(FLEET_SPEC),
                lambda t: card_lm_tenant(t, seq_len,
                                         n_layers=FLEET_BLOCKS),
                device="cuda")
            tel = telemetry.Telemetry(path=str(tmp / f"events{i}.jsonl"),
                                      clock=telemetry.VirtualClock())
            t0 = time.perf_counter()
            try:
                res = LoadHarness(fleet, sc).run(tel)
            finally:
                tel.close()
            secs = time.perf_counter() - t0
            acct = fleet.accounting()
            applied = sum(rt.applied_requests
                          for rt in fleet.tenants.values())
            groups = sum(rt.groups for rt in fleet.tenants.values())
            log(f"[load] run {i}: {res['admitted']} forget requests "
                f"admitted over {LOAD_TICKS} ticks (flushed by tick "
                f"{res['final_tick']}), {groups} drain groups, "
                f"{res['n_events']} events, fingerprint "
                f"{res['fingerprint'][:16]}; accounting {acct}; {secs:.1f} s")
            if not all(a["ok"] for a in acct.values()) or \
                    applied != res["admitted"] or \
                    res["fleet"]["drained_requests"] != res["admitted"] or \
                    res["admitted"] != sum(fleet.scheduler.submits.values()):
                raise AssertionError(f"load run {i}: accounting {acct}, "
                                     f"{applied} applied")
            runs.append((res, secs))
            del fleet
            torch.cuda.empty_cache()
        if runs[0][0]["fingerprint"] != runs[1][0]["fingerprint"] or \
                runs[0][0]["event_counts"] != runs[1][0]["event_counts"]:
            raise AssertionError("load: the two runs' event streams differ")
        ev = slo.evaluate(runs[0][0])
        slo_path = tmp / "slo.json"
        slo_path.write_text(slo.to_json())
        rc = report.main([str(tmp / "events0.jsonl"), "-o",
                          str(tmp / "report.md"), "--slo", str(slo_path),
                          "--warmup-t", str(sc.warmup_ticks)])
        md = (tmp / "report.md").read_text()
        if rc != 0 or not ev["ok"] or "## SLO attainment" not in md:
            raise AssertionError(f"load: report --slo exit {rc}, {ev}")
        log(f"[load] the two runs' fingerprints and event counts equal; "
            f"report --slo {slo.to_json()}: exit {rc}, attained "
            f"{ev['attained']}, "
            f"{[(r['objective'], r['actual']) for r in ev['objectives']]}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    secs = time.perf_counter() - t_phase
    log(f"[load] phase done in {secs:.1f} s")
    return {"load_admitted": runs[0][0]["admitted"],
            "load_run_seconds": [s for _, s in runs],
            "load_phase_seconds": secs}


# [train]: gemma3-1b at full width and one local/global period of its
# blocks (463,026,816 parameters; a checkpoint holds 12 bytes a parameter,
# params as their f32 upcast, mu and nu, about 5.6 GB), trained as the
# reference's train.py trains: batch 8 of 128-token sequences, lr 3e-3, 5
# warm-up steps; checkpoints every 4 steps and the mid-run forget at step 8
# of 10 (3 checkpoint writes); a run resumed from step 4 with the same
# schedule and forget (its pre-unlearn write the 4th), its final state
# against the first run's; TRAIN_CODEC_STEPS steps under --compress int8
TRAIN_BLOCKS = 6
TRAIN_SEQ = 128
TRAIN_WANT = (463_026_816, 56)
TRAIN_STEPS = 10
TRAIN_CKPT_EVERY = 4
TRAIN_UNLEARN_AT = 8
TRAIN_CODEC_STEPS = 2
TRAIN_CODEC_RTOL = 1e-6


def train_phase(dev, card, zero_counts, dampen_counts, fisher_counts):
    """Phase 21, [train]: ``repro_torch.launch.train`` on gemma3-1b at full
    width (module docstring), under deterministic algorithms. Returns the
    figures the kernels line carries."""
    import math
    import shutil
    import tempfile

    from repro_torch import bridge
    from repro_torch.api import ForgetRequest, UnlearnSpec, Unlearner
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.configs import get as get_arch
    from repro_torch.core import adapters, fisher
    from repro_torch.data import synthetic as syn
    from repro_torch.launch import train as T
    from repro_torch.models import lm as LM
    from repro_torch.models.module import tree_leaves, tree_map
    from repro_torch.optim import Int8Codec, value_and_grad

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_arch(SERVE_ARCH).full.with_(n_layers=TRAIN_BLOCKS)
    # the reference's draw (8 domains x 24) at the data vocabulary
    tokens, domains = syn.make_lm_domains(syn.LMDataConfig(
        vocab=LM_DATA_VOCAB, n_domains=8, seq_len=TRAIN_SEQ,
        n_per_domain=24, seed=0))
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="train_", dir=ROOT / "build"))

    def args(name, *extra):
        return T.parse_args(["--batch", "8", "--seq", str(TRAIN_SEQ),
                             "--lr", "3e-3", "--ckpt-dir", str(tmp / name),
                             "--device", "cuda", *extra])

    def same(p, q):
        a, b = bridge.paths(p), bridge.paths(q)
        return sorted(a) == sorted(b) and all(
            a[k].dtype == b[k].dtype and torch.equal(bits(a[k]), bits(b[k]))
            for k in a)

    def card_line(what):
        log(f"[train] {what} ({card})")

    try:
        with deterministic_algorithms():
            zero_counts()                      # the [train] path starts
            run = T.train(cfg, dev, args(
                "a", "--steps", str(TRAIN_STEPS), "--ckpt-every",
                str(TRAIN_CKPT_EVERY), "--unlearn-at",
                str(TRAIN_UNLEARN_AT)), data=(tokens, domains))
            torch.cuda.synchronize()
            counts = dampen_counts() + fisher_counts()   # the path ends
            n_par = sum(t.numel() for t in tree_leaves(run.params))
            n_leaves = len(bridge.paths(run.params))
            if (n_par, n_leaves) != TRAIN_WANT:
                raise AssertionError(f"train: {n_par} parameters in "
                                     f"{n_leaves} leaves, want {TRAIN_WANT}")
            losses = run.losses
            if not all(math.isfinite(x) for x in losses) or \
                    not losses[-1] < losses[0]:
                raise AssertionError(f"train: losses {losses}")
            if any(counts):
                raise AssertionError(f"train: the plain run launched "
                                     f"kernels {counts}")
            journal = ckpt.journal_read(str(tmp / "a"))
            st = run.forget_stats
            if not journal or journal[0]["forget_domain"] != 2 or st is None:
                raise AssertionError(f"train: journal {journal}")
            steps_on_disk = sorted(p.name for p in (tmp / "a").iterdir()
                                   if p.name.startswith("step_"))
            size = {n: sum(f.stat().st_size for f in (tmp / "a" / n).rglob(
                "*") if f.is_file()) for n in steps_on_disk}
            synced = sorted(run.timings["step_synced"][1:])
            step_ms = 1e3 * synced[len(synced) // 2]
            dispatch = [round(1e3 * w, 1) for w in run.timings["step"]]
            saves = run.timings["save"]
            card_line(
                f"gemma3-1b at full width, {TRAIN_BLOCKS} of 26 blocks, "
                f"{n_par} {cfg.param_dtype} parameters in {n_leaves} "
                f"leaves, from "
                f"torch.Generator('cuda') seed 0; {TRAIN_STEPS} steps of "
                f"batch 8 x {TRAIN_SEQ} tokens (make_lm_domains vocabulary "
                f"{LM_DATA_VOCAB}, 8 domains x 24): losses "
                f"{[round(x, 4) for x in losses]}; warm step wall (to the "
                f"loss read, median of {len(synced)}) {step_ms:.1f} ms, the "
                f"watchdog's dispatch walls {dispatch} ms; checkpoint "
                f"writes {[round(w, 2) for w in saves]} s; on disk {size} "
                f"bytes")
            card_line(f"mid-run forget at step {TRAIN_UNLEARN_AT} (journal "
                      f"{journal[0]}): stopped at l={st['stopped_at_l']} of "
                      f"{LM.n_unlearn_layers(cfg)}, checkpoints "
                      f"{st['checkpoints_hit']}, macs%="
                      f"{st['macs_vs_ssd_pct']:.1f}, selected "
                      f"{st['selected_per_layer']}; plain dampen, 0 kernel "
                      f"launches")

            # resume from step 4 (alone in a directory) with the same
            # schedule and the same forget at step 8: its final state
            # against the uninterrupted run's, bit for bit
            first = f"step_{TRAIN_CKPT_EVERY:08d}"
            (tmp / "b").mkdir()
            os.symlink(tmp / "a" / first, tmp / "b" / first)
            resumed = T.train(cfg, dev, args(
                "b", "--steps", str(TRAIN_STEPS), "--ckpt-every", "0",
                "--unlearn-at", str(TRAIN_UNLEARN_AT), "--resume"),
                data=(tokens, domains))
            restore_s = resumed.timings["restore"]
            saves += resumed.timings["save"]
            metas = [json.loads((tmp / d / f"step_{TRAIN_UNLEARN_AT:08d}" /
                                 "META.json").read_text()) for d in "ab"]
            final = [{"params": r.params, "opt": r.opt._asdict(),
                      "ef": r.ef} for r in (run, resumed)]
            if resumed.result["start_step"] != TRAIN_CKPT_EVERY or \
                    not same(*final) or resumed.data_step != run.data_step \
                    or metas[0]["data_step"] != metas[1]["data_step"] or \
                    resumed.losses != losses[TRAIN_CKPT_EVERY:] or \
                    resumed.forget_stats["stopped_at_l"] != \
                    st["stopped_at_l"]:
                raise AssertionError(
                    f"train: the run resumed at step "
                    f"{resumed.result['start_step']} != the uninterrupted "
                    f"run (data_step {resumed.data_step} / {run.data_step})")
            card_line(f"resumed from step {TRAIN_CKPT_EVERY} (restore "
                      f"{restore_s:.2f} s), with the same forget at step "
                      f"{TRAIN_UNLEARN_AT} (its pre-unlearn write "
                      f"{saves[-1]:.2f} s): its losses, final params, mu, "
                      f"nu, ef, step and data_step {run.data_step} (META "
                      f"{metas[0]['data_step']} at step {TRAIN_UNLEARN_AT}) "
                      f"== the uninterrupted run's, bit for bit")
            del resumed, final

            # the forget replayed from the pre-unlearn checkpoint with the
            # dampen kernel
            def loss_fn(p, batch):
                return LM.lm_loss(p, cfg, batch[0], batch[1], aux_weight=0.01)

            batches = [(tokens[i:i + 16, :-1], tokens[i:i + 16, 1:])
                       for i in range(0, 64 - 15, 16)]
            fb = syn.lm_split_forget_retain(tokens, domains, 2)["forget"][:16]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pre = ckpt.restore(str(tmp / "a"), TRAIN_UNLEARN_AT,
                               {"params": run.params}, device="cuda"
                               )[0]["params"]
            torch.cuda.synchronize()
            read_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            i_d = fisher.diag_fisher_streaming(loss_fn, pre, batches,
                                               chunk_size=4, device="cuda")
            unl = Unlearner(adapters.lm_adapter(cfg, TRAIN_SEQ, device="cuda"),
                            i_d, UnlearnSpec.for_mode(
                                "ficabu", alpha=8.0, lam=1.0, tau=0.6,
                                checkpoint_every=2, chunk_size=4,
                                use_kernel=True), device="cuda")
            zero_counts()                      # the replay starts
            new, st_k = unl.forget(ForgetRequest(fb[:, :-1], fb[:, 1:],
                                                 tag=2), params=pre)
            torch.cuda.synchronize()
            launches, leaves = dampen_counts()[:2]
            others = dampen_counts()[2:] + fisher_counts()
            replay_s = time.perf_counter() - t0
            if not same(new, run.forgotten) or launches < 1 or any(others) \
                    or st_k["stopped_at_l"] != st["stopped_at_l"]:
                raise AssertionError(
                    f"train: the kernel replay of the forget != the plain "
                    f"forget ({launches} launches over {leaves} leaves, "
                    f"others {others})")
            card_line(f"the forget replayed from the pre-unlearn checkpoint "
                      f"(its params read in {read_s:.2f} s) with "
                      f"use_kernel=True == the run's plain forget, bit for "
                      f"bit: {launches} dampen launches over {leaves} leaves, "
                      f"{replay_s:.2f} s with its Fisher")
            del pre, new, unl, i_d, run

            # the int8 codec at full width
            coded = T.train(cfg, dev, args(
                "c", "--steps", str(TRAIN_CODEC_STEPS), "--ckpt-every", "0",
                "--compress", "int8"), data=(tokens, domains))
            if not all(torch.isfinite(t).all() for t in tree_leaves(coded.ef)):
                raise AssertionError("train: non-finite codec EF state")
            if not all(math.isfinite(x) for x in coded.losses):
                raise AssertionError(f"train: codec losses {coded.losses}")
            bx = torch.as_tensor(tokens[:8, :-1], device="cuda")
            by = torch.as_tensor(tokens[:8, 1:], device="cuda")
            _, g = value_and_grad(loss_fn, coded.params, (bx, by))
            sent, e_new = Int8Codec().apply(g, coded.ef)
            # the same totals from an f32 copy of the gradient: the value
            # that crosses the wire before its cast to the gradient's dtype
            # (bf16), a rounding the reference's error feedback does not see
            deq, e32 = Int8Codec().apply(tree_map(lambda t: t.float(), g),
                                         coded.ef)
            worst = 0.0
            gp, ep = bridge.paths(g), bridge.paths(coded.ef)
            sp, np_ = bridge.paths(sent), bridge.paths(e_new)
            dp, e32p = bridge.paths(deq), bridge.paths(e32)
            for k in gp:
                if not torch.equal(e32p[k], np_[k]) or not torch.equal(
                        bits(dp[k].to(sp[k].dtype)), bits(sp[k])):
                    raise AssertionError(f"train: codec {k}: the bf16 and f32 "
                                         f"gradients' codes differ")
                want_k = gp[k].float() + ep[k]
                got_k = dp[k] + np_[k]
                rel = float((got_k - want_k).norm() /
                            want_k.norm().clamp_min(1e-30))
                worst = max(worst, rel)
            if not worst <= TRAIN_CODEC_RTOL:
                raise AssertionError(f"train: sent + residual != g + e_prev "
                                     f"(relative {worst})")
            card_line(f"--compress int8: {TRAIN_CODEC_STEPS} steps, losses "
                      f"{[round(x, 4) for x in coded.losses]}, the EF state "
                      f"finite; on one more gradient, per leaf, sent (f32) + "
                      f"residual == g + e_prev within relative {worst:.2e} "
                      f"(gate {TRAIN_CODEC_RTOL}), the bf16 sent == its f32 "
                      f"value cast, the residual the same bits")
            del coded, g, sent, e_new, deq, e32, gp, ep, sp, np_, dp, e32p
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    peak = torch.cuda.max_memory_allocated() / 2.0 ** 30
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t_phase
    card_line(f"phase done in {secs:.1f} s; torch.cuda.max_memory_allocated "
              f"{peak:.2f} GiB")
    return {"train_launches": launches, "train_leaves": leaves,
            "train_losses": losses, "train_step_ms": step_ms,
            "train_save_seconds": saves, "train_restore_seconds": restore_s,
            "train_params_read_seconds": read_s,
            "train_replay_seconds": replay_s,
            "train_checkpoint_bytes": size, "train_codec_rel": worst,
            "train_peak_gib": peak, "train_phase_seconds": secs}


# [examples]: the port's six examples (examples/torch_*.py), each one's
# run(device="cuda") in this process at the example's own sizes: its
# seconds and key outputs on one line, gated on every check the reference
# example's own run passes. The serving example runs without --cache-dir
# (the kernel build directory is process-wide and this process loaded its
# libraries at [build]; [cache] holds the cold starts) and prints its
# staleness verdict ungated: the reference example's check of it fails on
# the reference's own weights (ROADMAP.md, Queue 3)
EXAMPLES = ("torch_quickstart", "torch_unlearn_lm_domain",
            "torch_train_then_forget", "torch_serve_with_unlearning",
            "torch_fleet_two_tenants", "torch_load_fleet_smoke")


def load_example(name):
    """``examples/<name>.py`` as a module (its ``__main__`` block does not
    run)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def examples_phase(dev):
    """Phase 22, [examples] (above). Returns the figures the kernels line
    carries."""
    import math

    t_phase = time.perf_counter()
    secs = {}
    problems = []

    def pct(accs):
        return [round(a * 100, 1) for a in accs]

    for name in EXAMPLES:
        mod = load_example(name)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = mod.run("cuda")
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        if name == "torch_quickstart":
            (fb, rb), (fa, ra) = res["before"], res["after"]
            what = (f"final loss {res['final_loss']:.4f}; forget {fb:.3f} -> "
                    f"{fa:.3f}, retain {rb:.3f} -> {ra:.3f}; stopped at l = "
                    f"{res['stopped_at_l']} of {res['n_layers']} "
                    f"(checkpoints {res['checkpoints_hit']}), MACs vs SSD "
                    f"{res['macs_vs_ssd_pct']:.1f}%; refresh {res['refresh']}")
            ok = (math.isfinite(res["final_loss"])
                  and 1 <= res["stopped_at_l"] <= res["n_layers"]
                  and res["refresh"] == {"batches": 2, "ema_count": 2})
        elif name == "torch_unlearn_lm_domain":
            what = (f"next-token accuracy per domain {pct(res['pre'])} -> "
                    f"{pct(res['post'])} %; stopped at l = "
                    f"{res['stopped_at_l']} (checkpoints "
                    f"{res['checkpoints_hit']}), MACs vs SSD "
                    f"{res['macs_vs_ssd_pct']:.1f}%")
            ok = all(math.isfinite(a) for a in res["pre"] + res["post"])
        elif name == "torch_train_then_forget":
            r1, r2 = res["run1"], res["run2"]
            what = (f"run 1 loss {r1['first_loss']:.4f} -> "
                    f"{r1['final_loss']:.4f} in {r1['steps_run']} steps; "
                    f"journal {res['journal']}; run 2 resumed at step "
                    f"{r2['start_step']}, {r2['steps_run']} steps, loss "
                    f"{r2['final_loss']:.4f}")
            ok = r2["start_step"] >= 150
        elif name == "torch_serve_with_unlearning":
            st = res["staleness"]
            what = (f"batches served in {res['latency_s']} s; stopped at l = "
                    f"{res['stopped_at_l']}, MACs vs SSD "
                    f"{res['macs_vs_ssd_pct']:.1f}%; {res['refreshes']} "
                    f"refresh(es), I_D rel err {st['stale_rel_err']:.4f} -> "
                    f"{st['refreshed_rel_err']:.4f}, improved "
                    f"{st['improved']} (not gated: Queue 3)")
            ok = res["unlearned"] and res["refreshes"] >= 1
        elif name == "torch_fleet_two_tenants":
            t = res["tenants"]
            first = {k: tuple(v["first_drain"].values())
                     for k, v in t.items()}
            what = (f"--check passed; program cache {res['cache']}; first "
                    f"drain (builds, hits) {first}")
            ok = (set(t) == {"acme", "globex", "initech"}
                  and t["acme"]["first_drain"]["compiles"] > 0
                  and t["globex"]["first_drain"]["compiles"] == 0
                  and t["globex"]["first_drain"]["cache_hits"] > 0
                  and t["initech"]["first_drain"]["compiles"] > 0)
        else:
            r, rp = res["res"], res["replay"]
            fl = r["fleet"]
            what = (f"fingerprints {r['fingerprint'][:16]} / "
                    f"{rp['fingerprint'][:16]}; submitted {fl['submitted']}, "
                    f"merged {fl['merged']}, queue depth max "
                    f"{fl['queue_depth_max']}, steady-state builds "
                    f"{fl['steady_state_compiles']}; SLO ok "
                    f"{res['evaluation']['ok']}")
            ok = (res["evaluation"]["ok"]
                  and r["fingerprint"] == rp["fingerprint"]
                  and fl["queue_depth_max"] <= 2)
        log(f"[examples] {name}: {secs[name]:.1f} s; {what}")
        if not ok:
            problems.append(name)
    if problems:
        raise AssertionError(f"examples failed their checks: {problems}")
    total = time.perf_counter() - t_phase
    log(f"[examples] all six passed the reference examples' checks; phase "
        f"{total:.1f} s")
    return {"examples_seconds": {k: round(v, 2) for k, v in secs.items()},
            "examples_phase_seconds": total}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 1
    # before the first allocation on the card: segments that grow in place,
    # so that a request's transients over the [moe] phase's 671 M-element
    # expert leaves do not strand reserved memory between fixed segments
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    # cuBLAS's deterministic workspace, for the [serve] phase's
    # deterministic algorithms (the default size on Hopper)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    t_main = time.perf_counter()
    PHASES.start("card")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import bridge
    from repro_torch.api import (ForgetRequest, QuantSpec, Unlearner,
                                 UnlearnSpec)
    from repro_torch.configs import RESNET18_CIFAR20 as cfg
    from repro_torch.configs import VIT_CIFAR20 as vcfg
    from repro_torch.core import adapters
    from repro_torch.data import synthetic as syn
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import dampen as kd
    from repro_torch.kernels import fimd as kf
    from repro_torch.kernels import gemm_fisher as kg
    from repro_torch.kernels import gemm_fisher_int8 as kg8
    from repro_torch.models import vision as V
    from repro_torch.models.module import tree_leaves, tree_unflatten
    from repro_torch.optim.compression import INT8_SWEEP_RTOL, q8_quantize

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    # deterministic cuDNN algorithms from the start: the pre-trained weights,
    # and every number and gate that depends on them, repeat from run to run
    # on this card and software
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    rate, fp32_rate, int8_rate, tf32_rate = peaks(kind)
    log(f"[card] {kind} | torch {torch.__version__} cuda {torch.version.cuda}"
        f" | PYTORCH_CUDA_ALLOC_CONF {os.environ['PYTORCH_CUDA_ALLOC_CONF']}"
        f" | rates used for bounds: memory {rate / 1e12:.2f} TB/s, f32 "
        f"{fp32_rate / 1e12:.0f} TFLOP/s, int8 {int8_rate / 1e12:.0f} TOP/s, "
        f"TF32 {tf32_rate / 1e12:.0f} TFLOP/s")

    PHASES.start("build")
    # 2. build: one nvcc per csrc/*.cu, all started together
    t0 = time.perf_counter()
    libs = kbuild.build_all()
    log(f"[build] {len(libs)} libraries in {time.perf_counter() - t0:.1f} s")
    for name, so in libs.items():
        log(f"[build] {so.relative_to(ROOT)}")
        for line in kbuild.BUILD_LOG.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"[build]   {line.strip()}")

    PHASES.start("kernels vs plain")
    # 3. kernel vs plain at every leaf shape + edge cases
    params = V.init_resnet(torch.Generator().manual_seed(SEED), cfg,
                           device="cuda")
    leaves = bridge.paths(params)
    shapes = [tuple(t.shape) for t in leaves.values()]
    n_params = sum(t.numel() for t in leaves.values())
    if len(shapes) != 56 or n_params != 11_177_300:
        raise AssertionError(f"RESNET18_CIFAR20 has {len(shapes)} leaves and "
                             f"{n_params} parameters, expected 56 / 11177300")
    t0 = time.perf_counter()
    cases, max_err = check_kernel_against_plain(shapes, dev)
    log(f"[kernel] dampen bit-identical to dampen_ref in {cases} cases "
        f"(56 leaf shapes x f32/bf16 x 3 pairs + edges), max |err| "
        f"{max_err} ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    cases8, max_err8 = check_int8_kernel_against_plain(shapes, dev)
    log(f"[kernel] dampen_int8 bit-identical to dampen_int8_ref in {cases8} "
        f"cases (56 leaf shapes x 3 pairs + half-way, saturation, edges), "
        f"max |err| {max_err8} ({time.perf_counter() - t0:.1f} s)")
    adapter = adapters.resnet_adapter(cfg, device="cuda")
    layer_shapes = [[tuple(t.shape) for t in
                     tree_leaves(adapter.get_layer(params, j))]
                    for j in range(adapter.n_layers - 1, -1, -1)]
    t0 = time.perf_counter()
    gcases, gmax_err = check_group_kernels_against_plain(layer_shapes, dev)
    log(f"[kernel] grouped dampen and dampen_int8 (one launch per 64 leaves) "
        f"bit-identical to their plain versions, selection count included, "
        f"launch and leaf counters equal to the table, in {gcases} tables "
        f"(each of the {len(layer_shapes)} layers' tables "
        f"({[len(s) for s in layer_shapes]} leaves) and the "
        f"{len(shapes)}-leaf tree x 3 pairs, {2 * len(shapes)} and 150 "
        f"leaves past capacity, edge tables of offset views x 8 pairs x "
        f"in place or not), max |err| {gmax_err} "
        f"({time.perf_counter() - t0:.1f} s)")
    # the same over VIT_CIFAR20's 14 layer tables: leaves of 192 elements,
    # the rank-3 patch/cls and patch/pos, 147,456-element MLP weights
    vparams = V.init_vit(torch.Generator().manual_seed(SEED), vcfg,
                         device="cuda")
    vsizes = [t.numel() for t in bridge.paths(vparams).values()]
    if len(vsizes) != 176 or sum(vsizes) != 7_120_340:
        raise AssertionError(f"VIT_CIFAR20 has {len(vsizes)} leaves and "
                             f"{sum(vsizes)} parameters, expected 176 / "
                             f"7120340")
    vadapter = adapters.vit_adapter(vcfg, device="cuda")
    vlayer_shapes = [[tuple(t.shape) for t in
                      tree_leaves(vadapter.get_layer(vparams, j))]
                     for j in range(vadapter.n_layers - 1, -1, -1)]
    t0 = time.perf_counter()
    vcases, vmax_err = check_group_kernels_against_plain(vlayer_shapes, dev,
                                                         edges=False)
    for k in gmax_err:
        gmax_err[k] = max(gmax_err[k], vmax_err[k])
    log(f"[kernel] grouped dampen and dampen_int8 over VIT_CIFAR20's "
        f"{len(vlayer_shapes)} layer tables "
        f"({[len(s) for s in vlayer_shapes]} leaves of {min(vsizes)} to "
        f"{max(vsizes)} elements, rank-3 patch/cls and patch/pos) and its "
        f"{len(vsizes)}-leaf tree (3 launches) x 3 pairs: bit-identical to "
        f"their plain versions, selection count, launch and leaf counters "
        f"included, in {vcases} tables, max |err| {vmax_err} "
        f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    edge = check_fisher_kernels_against_plain(dev)
    log(f"[kernel] fimd (rtol 1e-5, atol 0), gemm_fisher (rel L2 1e-5), "
        f"gemm_fisher_int8 and dampen_int8_rowscale (bit-identical) against "
        f"their plain versions at odd shapes, misaligned pointers and special "
        f"values: {edge} cases ({time.perf_counter() - t0:.1f} s)")

    PHASES.start("slice")
    # 4. the slice at full width
    x, y = syn.make_classification(syn.ClsDataConfig(
        n_classes=cfg.n_classes, img_size=cfg.img_size, n_per_class=80,
        seed=SEED))
    xd, yd = torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)
    t0 = time.perf_counter()
    params, loss = pretrain(params,
                            lambda p, im: V.resnet_forward(p, cfg, im),
                            xd, yd, steps=300, batch=128, dev=dev)
    torch.cuda.synchronize()
    log(f"[slice] 300 AdamW steps (the port's optimizer) at batch 128 in "
        f"{time.perf_counter() - t0:.1f} s, last loss {loss:.4f}")

    splits = syn.split_forget_retain(x, y, forget_class=FORGET_CLASS)
    fx, fy = splits["forget"]
    fx, fy = fx[:64], fy[:64]
    rx, ry = splits["retain"]

    def accuracy_of(forward):
        def acc(p, xs, ys):
            with torch.no_grad():
                xs = torch.as_tensor(xs, device=dev)
                ys = torch.as_tensor(ys, device=dev)
                return float(V.cls_accuracy(forward(p, xs), ys))
        return acc

    acc = accuracy_of(lambda p, im: V.resnet_forward(p, cfg, im))

    tau = 1.0 / cfg.n_classes + 0.03
    log(f"[slice] before: forget acc {acc(params, fx, fy):.4f}, retain acc "
        f"{acc(params, rx, ry):.4f}; tau {tau:.4f}")
    loss_fn = lambda p, b: V.cls_loss(V.resnet_forward(p, cfg, b[0]), b[1])  # noqa: E731
    spec = lambda mode, **kw: UnlearnSpec.for_mode(  # noqa: E731
        mode, alpha=10.0, lam=1.0, tau=tau, checkpoint_every=2, chunk_size=8,
        **kw)
    ssd = Unlearner(adapter, spec=spec("ssd", use_kernel=True), device="cuda")
    t0 = time.perf_counter()
    ssd.ensure_fisher(loss_fn, params, (rx[:256], ry[:256]))
    torch.cuda.synchronize()
    log(f"[slice] ensure_fisher on 256 retain images (chunk 8) in "
        f"{time.perf_counter() - t0:.2f} s")
    ficabu = ssd.with_spec(spec("ficabu", use_kernel=True))
    before = {k: v.clone() for k, v in bridge.paths(params).items()}

    def fisher_counts():
        return (kf.LAUNCHES, kg.LAUNCHES, kg8.LAUNCHES, kd.ROWSCALE_LAUNCHES)

    def zero_counts():
        kd.LAUNCHES = kd.INT8_LAUNCHES = kd.ROWSCALE_LAUNCHES = 0
        kd.LEAVES = kd.INT8_LEAVES = 0
        kf.LAUNCHES = kg.LAUNCHES = kg8.LAUNCHES = 0

    def dampen_counts():
        return (kd.LAUNCHES, kd.LEAVES, kd.INT8_LAUNCHES, kd.INT8_LEAVES)

    def serve(path, pairs, m):
        """Drive one path of model ``m``: all six launch counters (and the
        two leaf counters) zeroed just before, read just after; per request
        the launches of each dampen kernel, the leaves they dampened and the
        checkpoint runners built."""
        adapter, params, acc = m["adapter"], m["params"], m["acc"]
        L = adapter.n_layers
        zero_counts()                          # this path starts
        runs = []
        for name, unl in pairs:
            c0 = dampen_counts()
            p0 = unl.stats.get("partial_compiles", 0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            new, st = unl.forget(ForgetRequest(fx, fy, tag=name),
                                 params=params)
            torch.cuda.synchronize()
            runs.append((name, new, st,
                         tuple(b - a for a, b in zip(c0, dampen_counts())),
                         time.perf_counter() - t0,
                         unl.stats["partial_compiles"] - p0))
        counts = dampen_counts()               # this path ends
        if fisher_counts() != (0, 0, 0, 0):
            raise AssertionError(f"{path} requests launched fimd/gemm_fisher/"
                                 f"gemm_fisher_int8/rowscale "
                                 f"{fisher_counts()} times")
        acc_before = acc(params, fx, fy)
        for i, (name, new, st, dc, secs, partial) in enumerate(runs):
            warm = any(n == name for n, *_ in runs[:i])
            layers = st["stopped_at_l"]
            swept = sum(len(tree_leaves(adapter.get_layer(new, L - l)))
                        for l in range(1, layers + 1))
            log(f"[{m['tag']}] {path} {name:6s} {'warm' if warm else 'cold'}: "
                f"stopped_at_l={layers} "
                f"checkpoints={st['checkpoints_hit']} "
                f"macs_vs_ssd_pct={st['macs_vs_ssd_pct']:.4f} "
                f"launches dampen={dc[0]} over {dc[1]} leaves, "
                f"dampen_int8={dc[2]} over {dc[3]} leaves "
                f"builds={st['engine']['compiles']} "
                f"hits={st['engine']['cache_hits']} partial builds={partial} "
                f"wall={secs * 1e3:.1f} ms "
                f"forget acc {acc(new, fx, fy):.4f} retain acc "
                f"{acc(new, rx, ry):.4f}")
            # one launch per layer swept, over every leaf of those layers
            mine, other = ((dc[:2], dc[2:]) if path == "fp32"
                           else (dc[2:], dc[:2]))
            if mine != (layers, swept) or other != (0, 0):
                raise AssertionError(
                    f"{path} {name}: {dc[0]} dampen launches over {dc[1]} "
                    f"leaves and {dc[2]} dampen_int8 launches over {dc[3]} "
                    f"leaves for {layers} layers of {swept} leaves")
            if name == "ssd" and (mine != (L, m["n_leaves"])
                                  or layers != L):
                raise AssertionError(f"{path} ssd sweep: {mine[0]} launches "
                                     f"over {mine[1]} leaves, stopped at "
                                     f"{layers}")
            if st["engine"]["precision"] != path:
                raise AssertionError(f"{path} {name}: the engine ran "
                                     f"{st['engine']['precision']}")
            if warm and st["engine"]["compiles"] != 0:
                raise AssertionError(f"warm {path} {name} request built "
                                     f"{st['engine']['compiles']} steps")
            if not all(torch.isfinite(t).all() for t in tree_leaves(new)):
                raise AssertionError(f"{path} {name}: non-finite parameters")
            if acc(new, fx, fy) > acc_before:
                raise AssertionError(f"{path} {name}: forget accuracy rose")
        for k, t in bridge.paths(params).items():
            if not torch.equal(t, m["before"][k]):
                raise AssertionError(f"{path} forget without donation "
                                     f"edited {k}")
        return runs, counts

    rn = {"tag": "slice", "adapter": adapter, "params": params, "acc": acc,
          "n_leaves": len(shapes), "before": before}
    runs, (main_launches, main_leaves, _, _) = serve(
        "fp32", (("ssd", ssd), ("ficabu", ficabu), ("ssd", ssd),
                 ("ficabu", ficabu)), rn)
    spec8 = lambda mode: spec(mode, use_kernel=True,  # noqa: E731
                              precision="int8", quant=QuantSpec())
    ssd8 = ssd.with_spec(spec8("ssd"))
    ficabu8 = ssd.with_spec(spec8("ficabu"))
    runs8, (_, _, main_launches8, main_leaves8) = serve(
        "int8", (("ssd", ssd8), ("ficabu", ficabu8), ("ssd", ssd8),
                 ("ficabu", ficabu8)), rn)
    # launches of the warm ssd request, in its own precision
    ssd_launches = {"fp32": runs[2][3][0], "int8": runs8[2][3][2]}
    for (name, new8, *_), (name32, new32, *_) in zip(runs8[:2], runs[:2]):
        if not on_q8_grid(bridge.paths(new8), before):
            raise AssertionError(f"int8 {name}: a leaf left its q8 grid")
        rel = layer_rel_l2(adapter, new8, new32)
        log(f"[slice] int8 {name} vs fp32 {name32}, per-layer relative L2 "
            f"(j = 0..9): {[round(r, 6) for r in rel]}")
        if not all(0.0 < r <= INT8_SWEEP_RTOL for r in rel):
            raise AssertionError(f"int8 {name}: per-layer error {rel} "
                                 f"outside (0, {INT8_SWEEP_RTOL}]")

    # 5. whole forget: kernel vs plain (deterministic cuDNN, set above)
    for path, unl, plain in (
            ("fp32", ssd, ssd.with_spec(spec("ssd", use_kernel=False))),
            ("int8", ssd8, ssd.with_spec(spec("ssd", precision="int8",
                                              quant=QuantSpec())))):
        p_kernel, _ = unl.forget(ForgetRequest(fx, fy), params=params)
        p_plain, _ = plain.forget(ForgetRequest(fx, fy), params=params)
        a, b = bridge.paths(p_kernel), bridge.paths(p_plain)
        diff = [k for k in a if not torch.equal(bits(a[k]), bits(b[k]))]
        if diff:
            raise AssertionError(f"{path} kernel forget != plain forget at "
                                 f"{diff}")
        log(f"[slice] {path} ssd forget with the kernel == plain forget, bit "
            f"for bit, all 56 leaves")

    PHASES.start("vit")
    # 6. [vit]: the paper's ViT at full width (VIT_CIFAR20, the random
    # weights of phase 3 pre-trained here) through the same entry point, on
    # the same data, with alpha 5, b_r 5 (benchmarks/common.py: the
    # reference's calibration of its reduced ViT; the paper's full-size
    # ViT uses alpha 25, b_r 10) and checkpoints every 3 blocks. The third
    # request never halts (tau = -1: a request halts where the forget
    # accuracy is <= tau, and tau = 0 halts wherever the head's edit alone
    # takes it to 0), so it passes every checkpoint; it has a facade of its
    # own, so that its cold run builds the checkpoint runners: the
    # depth-operand one and the one of depth 0.
    t0 = time.perf_counter()
    vparams, vloss = pretrain(vparams,
                              lambda p, im: V.vit_forward(p, vcfg, im),
                              xd, yd, steps=300, batch=128, dev=dev)
    torch.cuda.synchronize()
    log(f"[vit] 300 AdamW steps (the port's optimizer) at batch 128 in "
        f"{time.perf_counter() - t0:.1f} s, last loss {vloss:.4f}")
    vacc = accuracy_of(lambda p, im: V.vit_forward(p, vcfg, im))
    vit = {"tag": "vit", "adapter": vadapter, "params": vparams,
           "acc": vacc, "n_leaves": len(vsizes),
           "before": {k: v.clone() for k, v in bridge.paths(vparams).items()}}
    log(f"[vit] before: forget acc {vacc(vparams, fx, fy):.4f}, retain acc "
        f"{vacc(vparams, rx, ry):.4f}; tau {tau:.4f}")

    def vspec(mode, use_kernel=True, **kw):
        return UnlearnSpec.for_mode(
            mode, **{"alpha": 5.0, "lam": 1.0, "b_r": 5.0, "tau": tau,
                     "checkpoint_every": 3, "chunk_size": 8,
                     "use_kernel": use_kernel, **kw})

    vssd = Unlearner(vadapter, spec=vspec("ssd"), device="cuda")
    t0 = time.perf_counter()
    vssd.ensure_fisher(lambda p, b: V.cls_loss(V.vit_forward(p, vcfg, b[0]),
                                               b[1]),
                       vparams, (rx[:256], ry[:256]))
    torch.cuda.synchronize()
    log(f"[vit] ensure_fisher on 256 retain images (chunk 8) in "
        f"{time.perf_counter() - t0:.2f} s")
    vfisher = vssd.fisher_global
    int8_kw = {"precision": "int8", "quant": QuantSpec()}
    vruns = {}
    for path, kw in (("fp32", {}), ("int8", int8_kw)):
        order = (("ssd", vssd.with_spec(vspec("ssd", **kw))),
                 ("ficabu", vssd.with_spec(vspec("ficabu", **kw))),
                 ("ficabu-nohalt", Unlearner(vadapter, vfisher,
                                             vspec("ficabu", tau=-1.0, **kw),
                                             device="cuda")))
        vruns[path] = serve(path, order + order, vit)
        for i, (name, new, st, dc, secs, partial) in enumerate(
                vruns[path][0]):
            if name == "ficabu-nohalt" and (
                    st["checkpoints_hit"] != [1, 3, 6, 9, 12, 14]
                    or st["stopped_at_l"] != 14
                    or partial != (0 if i >= 3 else 2)):
                raise AssertionError(
                    f"vit {path} {name} ({'warm' if i >= 3 else 'cold'}): "
                    f"checkpoints {st['checkpoints_hit']}, stopped at "
                    f"{st['stopped_at_l']}, {partial} checkpoint runners "
                    f"built")
    # the warm ssd request's (launches, leaves) in its own precision
    vit_ssd = {"fp32": vruns["fp32"][0][3][3][:2],
               "int8": vruns["int8"][0][3][3][2:]}
    for (name, new8, *_), (_, new32, *_) in zip(vruns["int8"][0][:3],
                                                vruns["fp32"][0][:3]):
        if not on_q8_grid(bridge.paths(new8), vit["before"]):
            raise AssertionError(f"vit int8 {name}: a leaf left its q8 grid")
        rel = layer_rel_l2(vadapter, new8, new32)
        log(f"[vit] int8 {name} vs fp32 {name}, per-layer relative L2 "
            f"(j = 0..13): {[round(r, 6) for r in rel]}")
        if not all(0.0 < r <= INT8_SWEEP_RTOL for r in rel):
            raise AssertionError(f"vit int8 {name}: per-layer error {rel} "
                                 f"outside (0, {INT8_SWEEP_RTOL}]")
    # the whole forget, kernel vs plain (no TF32, deterministic cuDNN)
    for path, kw in (("fp32", {}), ("int8", int8_kw)):
        p_kernel, _ = vssd.with_spec(vspec("ssd", **kw)).forget(
            ForgetRequest(fx, fy), params=vparams)
        p_plain, _ = vssd.with_spec(vspec("ssd", use_kernel=False, **kw)
                                    ).forget(ForgetRequest(fx, fy),
                                             params=vparams)
        a, b = bridge.paths(p_kernel), bridge.paths(p_plain)
        diff = [k for k in a if not torch.equal(bits(a[k]), bits(b[k]))]
        if diff:
            raise AssertionError(f"vit {path} kernel forget != plain forget "
                                 f"at {diff}")
        log(f"[vit] {path} ssd forget with the kernel == plain forget, bit "
            f"for bit, all {len(a)} leaves")

    PHASES.start("scanned")
    # 7. [scanned]: the scanned whole-sweep program (sweep_mode="scanned")
    # on the [vit] phase's pre-trained weights and Fisher, inside one
    # telemetry capture. Each request must equal the layerwise request of
    # [vit] bit for bit, parameters and stats; the program walks every
    # layer (a halted request's edits are masked on the card), so every
    # request launches its dampen kernel 14 times over all 176 leaves. A
    # warm program call runs with CUDA's sync debug mode at "error": it
    # may not read the card on the host.
    from repro_torch.engine import plan_scanned_sweep
    from repro_torch.obs import telemetry
    stat_keys = ("stopped_at_l", "checkpoints_hit", "selected_per_layer",
                 "forget_acc_trace", "macs", "macs_ssd", "macs_vs_ssd_pct")
    guarded_calls = [0]

    def same_bits(p, q):
        a, b = bridge.paths(p), bridge.paths(q)
        return sorted(a) == sorted(b) and all(
            torch.equal(bits(a[k]), bits(b[k])) for k in a)

    vlayer = {p: {name: (new, st) for name, new, st, *_ in vruns[p][0][:3]}
              for p in vruns}
    n_vit = len(vsizes)
    L_vit = vadapter.n_layers
    scanned = {}
    fx2, fy2 = syn.split_forget_retain(x, y, forget_class=OTHER_CLASS)[
        "forget"]
    group = [ForgetRequest(fx, fy, tag=FORGET_CLASS),
             ForgetRequest(fx2[:64], fy2[:64], tag=OTHER_CLASS)]
    t0 = time.perf_counter()
    with telemetry.capture() as tel:
        for path, kw in (("fp32", {}), ("int8", int8_kw)):
            fam = "int8_sweep" if path == "int8" else "sweep"
            unls = {name: vssd.with_spec(vspec(mode, sweep_mode="scanned",
                                               **extra, **kw))
                    for name, mode, extra in (
                        ("ssd", "ssd", {}),
                        ("ficabu-nohalt", "ficabu", {"tau": -1.0}),
                        ("ficabu", "ficabu", {}))}
            zero_counts()                      # this path starts
            for i, name in enumerate(list(unls) * 2):
                warm = i >= len(unls)
                unl = unls[name]
                if warm:
                    guard_syncs(unl, guarded_calls)
                c0, s0, g0 = dampen_counts(), dict(unl.stats), guarded_calls[0]
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                new, st = unl.forget(ForgetRequest(fx, fy), params=vparams)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t1
                dc = tuple(b - a for a, b in zip(c0, dampen_counts()))
                built = unl.stats[f"{fam}_compiles"] - s0[f"{fam}_compiles"]
                mine, other = ((dc[:2], dc[2:]) if path == "fp32"
                               else (dc[2:], dc[:2]))
                want_new, want_st = vlayer[path][name]
                log(f"[scanned] {path} {name:13s} {'warm' if warm else 'cold'}"
                    f": stopped_at_l={st['stopped_at_l']} checkpoints="
                    f"{st['checkpoints_hit']} launches {mine[0]} over "
                    f"{mine[1]} leaves, sweep programs built {built}, "
                    f"program launches "
                    f"{unl.stats[f'{fam}_launches'] - s0[f'{fam}_launches']}"
                    f", builds={st['engine']['compiles']} hits="
                    f"{st['engine']['cache_hits']}, guarded calls "
                    f"{guarded_calls[0] - g0}, wall {secs * 1e3:.1f} ms")
                # the halting ficabu shares the never-halting one's program
                # (the same checkpoints; tau is an operand)
                want_built = 0 if warm or name == "ficabu" else 1
                if (st["engine"]["sweep_mode"] != "scanned"
                        or st["engine"]["precision"] != path
                        or st["engine"]["sweep_launches"] != 1
                        or built != want_built
                        or (warm and st["engine"]["compiles"] != 0)
                        or guarded_calls[0] - g0 != int(warm)
                        or mine != (L_vit, n_vit) or other != (0, 0)):
                    raise AssertionError(f"scanned {path} {name} "
                                         f"({'warm' if warm else 'cold'}): "
                                         f"{st['engine']}, {built} built, "
                                         f"launches {dc}")
                diff = [k for k in stat_keys if st[k] != want_st[k]]
                if diff or not same_bits(new, want_new):
                    raise AssertionError(f"scanned {path} {name} != the "
                                         f"layerwise request of [vit]: "
                                         f"stats {diff}")
                scanned[(path, name)] = mine
            if fisher_counts() != (0, 0, 0, 0):    # this path ends
                raise AssertionError(f"scanned {path}: fimd/gemm/rowscale "
                                     f"launched {fisher_counts()}")
            log(f"[scanned] {path}: every request == the layerwise request "
                f"of [vit], bit for bit (all {n_vit} leaves and stats); "
                f"{fam}_compiles {unls['ssd'].stats[f'{fam}_compiles']} "
                f"(ssd's program and ficabu's), dampen counters over the "
                f"path {dampen_counts()}")
            # a K = 2 drain: two classes' 64-image batches, ssd, scanned
            # (cold, then warm under the guard) against the layerwise
            # forget_many of the same sets
            lw = vssd.with_spec(vspec("ssd", **kw))
            sc = vssd.with_spec(vspec("ssd", sweep_mode="scanned", **kw))
            drains = {}
            for name, unl in (("layerwise", lw), ("scanned", sc),
                              ("scanned warm", sc)):
                if name == "scanned warm":
                    guard_syncs(sc, guarded_calls)
                zero_counts()
                p_g, st_g, g = unl.forget_group(group, params=vparams)
                torch.cuda.synchronize()
                dc = dampen_counts()
                drains[name] = (p_g, st_g, g,
                                dc[:2] if path == "fp32" else dc[2:])
                log(f"[scanned] {path} K=2 ssd drain {name}: sweep_mode "
                    f"{g['engine']['sweep_mode']}, stopped_at_l "
                    f"{g['stopped_at_l']}, launches {drains[name][3][0]} "
                    f"over {drains[name][3][1]} leaves, builds "
                    f"{g['engine']['compiles']}")
            for name in ("scanned", "scanned warm"):
                p_g, st_g, g, lv = drains[name]
                q_g, qt_g, h, lv_lw = drains["layerwise"]
                if (g["engine"]["sweep_mode"] != "scanned"
                        or h["engine"]["sweep_mode"] != "layerwise"
                        or lv != lv_lw or lv != (2 * L_vit, 2 * n_vit)
                        or (name == "scanned warm"
                            and g["engine"]["compiles"] != 0)
                        or not same_bits(p_g, q_g)
                        or any(a[k] != b[k] for a, b in zip(st_g, qt_g)
                               for k in stat_keys)):
                    raise AssertionError(f"scanned {path} K=2 drain "
                                         f"({name}) != layerwise: "
                                         f"{g['engine']}, launches {lv} vs "
                                         f"{lv_lw}")
            scanned[(path, "group")] = drains["scanned"][3]
        # ResNet-18 cannot be scanned (its stages change shape): a K = 2
        # group asked for as scanned runs the layerwise drain
        rplan = plan_scanned_sweep(adapter, params,
                                   torch.as_tensor(fx, device=dev))
        rsc = ssd.with_spec(spec("ssd", use_kernel=True,
                                 sweep_mode="scanned"))
        zero_counts()
        p_r, _, g_r = rsc.forget_group(group, params=params)
        torch.cuda.synchronize()
        rcounts = dampen_counts()
        q_r, _, _ = ssd.forget_group(group, params=params)
        if (rplan is not None or g_r["engine"]["sweep_mode"] != "layerwise"
                or rcounts != (20, 112, 0, 0) or not same_bits(p_r, q_r)):
            raise AssertionError(f"ResNet-18 K=2 scanned group: plan {rplan}"
                                 f", {g_r['engine']}, counters {rcounts}")
        scanned[("fp32", "resnet group")] = rcounts[:2]
        log(f"[scanned] ResNet-18 K=2 ssd group asked for as scanned: plan "
            f"{rplan}, sweep_mode {g_r['engine']['sweep_mode']}, launches "
            f"{rcounts[0]} over {rcounts[1]} leaves, == the layerwise group "
            f"bit for bit")
    if guarded_calls[0] != 2 * 3 + 2:
        raise AssertionError(f"{guarded_calls[0]} sweep program calls ran "
                             f"under the sync guard, expected 8")
    # the guard itself: a host read under it must raise
    torch.cuda.set_sync_debug_mode("error")
    try:
        float(torch.ones((), device=dev))
        caught = False
    except RuntimeError:
        caught = True
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if not caught:
        raise AssertionError("set_sync_debug_mode('error') let a host read "
                             "of the card pass")
    log(f"[scanned] telemetry events by kind: "
        f"{dict(sorted(tel.counts.items()))}; {guarded_calls[0]} warm "
        f"program calls under "
        f"set_sync_debug_mode('error'), none synchronised "
        f"({time.perf_counter() - t0:.1f} s)")

    PHASES.start("fisher kernels")
    # 8. [fisher kernels]: the kernels.ops API, the entry point of fimd,
    # gemm_fisher, gemm_fisher_int8 and dampen_int8_rowscale (as in the JAX
    # package), on operands of the same 64-image forget request at chunk 8
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    fisher_g = ssd.fisher_global
    n_layers = adapter.n_layers
    sw = sweep_operands(adapter, params, fx, fy, 8, dev)
    # fimd: each leaf's 8 chunk gradients, stacked [8, *leaf]
    fimd_in = [(j, li, torch.stack([g[li] for g in sw[j]["grads"]]))
               for j in range(n_layers - 1, -1, -1)
               for li in range(len(sw[j]["fisher"]))]
    big_stack = max((st for *_, st in fimd_in), key=lambda t: t.numel())
    big_stack_bf16 = big_stack.to(torch.bfloat16)
    # gemm_fisher: per chunk, the layer's cached input A and its output
    # cotangent G — the fc's pooled input and the logit cotangent, and three
    # convs through im2col — with the autograd weight gradient of the chunk
    fc = sw[n_layers - 1]
    gemm_in = {"fc/w": [(fc["acts"][i].mean(dim=(2, 3)), fc["cot"][i],
                         tree_unflatten(fc["params"], fc["grads"][i])["w"],
                         None) for i in range(8)]}
    for name, j, conv in (("blocks/1/conv1", 2, "conv1"),
                          ("blocks/2/conv1", 3, "conv1"),
                          ("blocks/7/conv2", 8, "conv2")):
        gemm_in[name] = [(a, g, w_grad, w_grad.shape) for a, g, w_grad, _
                         in conv_gemm_operands(sw[j], conv, V)]
    shapes_nmk = {k: tuple(v[0][0].shape) + (v[0][1].shape[1],)
                  for k, v in gemm_in.items()}
    if shapes_nmk != {"fc/w": (8, 512, 20),
                      "blocks/1/conv1": (8192, 576, 64),
                      "blocks/2/conv1": (2048, 576, 128),
                      "blocks/7/conv2": (128, 4608, 512)}:
        raise AssertionError(f"GEMM operands (N, M, K): {shapes_nmk}")
    a_bf16, g_bf16 = (t.to(torch.bfloat16)
                      for t in gemm_in["blocks/2/conv1"][0][:2])
    # gemm_fisher_int8: the same A and G, quantised per column of each
    # block of Q8_GEMM_ROWS rows, one call per block (the blocks' dW summed
    # is the chunk's dW). A column's max-abs over all 8192 positions of a
    # chunk at blocks/1/conv1 leaves 77% of the cotangent's codes at 0 and
    # the int8 dW within a few percent of the 0.10 contract; that reading is
    # printed beside, from the plain version.
    gemm8_in = {k: [[q8_gemm_operands(a[r:r + Q8_GEMM_ROWS],
                                      g[r:r + Q8_GEMM_ROWS])
                     for r in range(0, a.shape[0], Q8_GEMM_ROWS)]
                    for a, g, *_ in v] for k, v in gemm_in.items()}
    # dampen_int8_rowscale: every leaf's int8 codes (the int8 request's
    # QuantSpec calibration) as [R = leaf.shape[0], C], the forget Fisher
    # quantised per row (fs[r] = max_c i_f[r, c] * f32(1/127), i_fq =
    # round(i_f / fs[r])), the global Fisher as i_g
    min_scale = QuantSpec().min_scale
    rs_in = []
    for j in range(n_layers - 1, -1, -1):
        for th, i_f, i_g in zip(tree_leaves(adapter.get_layer(params, j)),
                                sw[j]["fisher"],
                                tree_leaves(adapter.get_layer(fisher_g, j))):
            R = th.shape[0]
            th_q = q8_quantize(th, min_scale=min_scale)[0].reshape(R, -1)
            i_fq, fs = q8_quantize(i_f.reshape(R, -1))
            rs_in.append((th_q, i_fq, fs[:, 0].contiguous(),
                          i_g.reshape(R, -1)))
    torch.cuda.synchronize()
    log(f"[fisher] operands of the forget request: {len(fimd_in)} leaf "
        f"stacks, GEMMs (N, M, K) {shapes_nmk} x 8 chunks, {len(rs_in)} "
        f"leaves for rowscale ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    zero_counts()                              # this path starts
    fimd_out = [ops.fimd(st) for *_, st in fimd_in]
    fimd_out_bf16 = ops.fimd(big_stack_bf16)
    gemm_out = {k: [ops.gemm_fisher(a, g) for a, g, *_ in v]
                for k, v in gemm_in.items()}
    gemm_out_bf16 = ops.gemm_fisher(a_bf16, g_bf16)
    gemm8_out = {k: [[ops.gemm_fisher_int8(*q) for q in blocks]
                     for blocks in v] for k, v in gemm8_in.items()}
    rs_out = [[ops.dampen_int8_rowscale(*x, alpha, lam) for alpha, lam in PAIRS]
              for x in rs_in]
    torch.cuda.synchronize()
    fisher_launches = dict(zip(("fimd", "gemm_fisher", "gemm_fisher_int8",
                                "dampen_int8_rowscale"), fisher_counts()))
    # this path ends
    calls = {"fimd": len(fimd_in) + 1,
             "gemm_fisher": sum(map(len, gemm_in.values())) + 1,
             "gemm_fisher_int8": sum(len(blocks) for v in gemm8_in.values()
                                     for blocks in v),
             "dampen_int8_rowscale": len(rs_in) * len(PAIRS)}
    log(f"[fisher] kernels.ops calls {calls}, launches {fisher_launches} "
        f"({time.perf_counter() - t0:.2f} s)")
    if fisher_launches != calls:
        raise AssertionError(f"[fisher kernels] launches {fisher_launches} "
                             f"!= calls {calls}")

    t0 = time.perf_counter()
    f_err = {"fimd": 0.0, "gemm_fisher": 0.0, "gemm_fisher_int8": 0.0,
             "dampen_int8_rowscale": 0}
    worst = {"fimd_vs_fused": 0.0, "gemm_vs_plain": 0.0,
             "gemm_vs_autograd": 0.0, "gemm_fisher_vs_fused": 0.0}
    int8_rel = {}   # per GEMM, the largest relative L2 of int8 dW vs fp32
    int8_rel_whole = {}  # the same with one scale per column per chunk
    zero_g = {}     # per GEMM, the largest share of G's int8 codes at 0
    for (j, li, st), got in zip(fimd_in, fimd_out):
        want = kf.fimd_ref(st)
        fused = sw[j]["fisher"][li]
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
        torch.testing.assert_close(got / 8, fused, rtol=1e-5, atol=0)
        f_err["fimd"] = max(f_err["fimd"], float((got - want).abs().max()))
        worst["fimd_vs_fused"] = max(worst["fimd_vs_fused"], float(
            ((got / 8 - fused).abs() / fused.abs()).nan_to_num(0.0).max()))
    torch.testing.assert_close(fimd_out_bf16, kf.fimd_ref(big_stack_bf16),
                               rtol=2e-2, atol=0)
    for name, v in gemm_in.items():
        fish_sum = None
        for (a, g, w_grad, w_shape), (dw, fish), blocks8, outs8 in zip(
                v, gemm_out[name], gemm8_in[name], gemm8_out[name]):
            dwr, _ = kg.gemm_fisher_ref(a, g)
            rel_p, ok_p = gemm_close(dw, dwr)
            layout = dw if w_shape is None else oihw(dw, w_shape)
            rel_a, ok_a = gemm_close(layout, w_grad)
            if not (ok_p and ok_a) or not torch.equal(bits(fish),
                                                      bits(dw * dw)):
                raise AssertionError(
                    f"gemm_fisher {name}: relative L2 {rel_p} against plain, "
                    f"{rel_a} against autograd")
            f_err["gemm_fisher"] = max(f_err["gemm_fisher"],
                                       float((dw - dwr).abs().max()))
            worst["gemm_vs_plain"] = max(worst["gemm_vs_plain"], rel_p)
            worst["gemm_vs_autograd"] = max(worst["gemm_vs_autograd"], rel_a)
            fish_sum = fish if fish_sum is None else fish_sum + fish
            dw8_sum = torch.zeros_like(dw)
            for (aq, gq, sa, sg), (dw8, fish8) in zip(blocks8, outs8):
                dwr8, fishr8 = kg8.gemm_fisher_int8_ref(aq, gq, sa, sg)
                if not (torch.equal(bits(dw8), bits(dwr8))
                        and torch.equal(bits(fish8), bits(fishr8))):
                    raise AssertionError(f"gemm_fisher_int8 {name}: kernel "
                                         f"!= plain")
                f_err["gemm_fisher_int8"] = max(
                    f_err["gemm_fisher_int8"],
                    float((dw8 - dwr8).abs().max()))
                dw8_sum += dw8
                zero_g[name] = max(zero_g.get(name, 0.0),
                                   float((gq == 0).float().mean()))
            int8_rel[name] = max(int8_rel.get(name, 0.0),
                                 float((dw8_sum - dw).norm() / dw.norm()))
            dw8_whole, _ = kg8.gemm_fisher_int8_ref(*q8_gemm_operands(a, g))
            int8_rel_whole[name] = max(
                int8_rel_whole.get(name, 0.0),
                float((dw8_whole - dw).norm() / dw.norm()))
        # the chunks' dW^2 over nc is the fused step's Fisher of the weight
        j, leaf = ((n_layers - 1, "w") if name == "fc/w" else
                   (int(name.split("/")[1]) + 1, name.split("/")[2]))
        fused = sw[j]["fisher_tree"][leaf]
        mean = fish_sum / 8
        rel_f, ok_f = gemm_close(mean if name == "fc/w"
                                 else oihw(mean, fused.shape), fused)
        worst["gemm_fisher_vs_fused"] = max(worst["gemm_fisher_vs_fused"],
                                            rel_f)
        if not ok_f:
            raise AssertionError(f"gemm_fisher {name}: mean dW^2 at relative "
                                 f"L2 {rel_f} from grad_fisher_chunks")
    rel_b, ok_b = gemm_close(gemm_out_bf16[0],
                             kg.gemm_fisher_ref(a_bf16, g_bf16)[0], rtol=2e-2)
    if not ok_b:
        raise AssertionError(f"gemm_fisher bf16: relative L2 {rel_b}")
    edited = 0
    for (th_q, i_fq, fs, i_g), outs in zip(rs_in, rs_out):
        for (alpha, lam), got in zip(PAIRS, outs):
            a32, l32 = ops.f32(alpha), ops.f32(lam)
            want = kd.dampen_int8_rowscale_ref(th_q, i_fq, fs, i_g, a32, l32)
            via, _ = ops.dampen_int8(th_q, i_fq.float() * fs[:, None], i_g,
                                     alpha, lam)
            f_err["dampen_int8_rowscale"] = max(
                f_err["dampen_int8_rowscale"],
                int((got.int() - want.int()).abs().max()))
            if not (torch.equal(got, want) and torch.equal(got, via)):
                raise AssertionError(f"dampen_int8_rowscale {tuple(th_q.shape)}"
                                     f" a={alpha} l={lam}: kernel != plain or "
                                     f"!= dampen_int8 on the dequantised "
                                     f"Fisher")
            edited += int((got != th_q).sum())
    log(f"[fisher] fimd == plain (rtol 1e-5, atol 0) on 56 leaves + bf16, "
        f"fimd / 8 == grad_fisher_chunks' Fisher (max rel "
        f"{worst['fimd_vs_fused']:.3e}); gemm_fisher relative L2 max "
        f"{worst['gemm_vs_plain']:.3e} vs plain, "
        f"{worst['gemm_vs_autograd']:.3e} vs autograd, mean dW^2 "
        f"{worst['gemm_fisher_vs_fused']:.3e} vs the fused Fisher, bf16 "
        f"{rel_b:.3e}; gemm_fisher_int8 bit-identical; "
        f"dampen_int8_rowscale bit-identical to plain and to dampen_int8 on "
        f"the dequantised Fisher, {edited} codes edited over "
        f"{len(rs_in)} leaves x {len(PAIRS)} pairs "
        f"({time.perf_counter() - t0:.1f} s)")
    log(f"[fisher] gemm_fisher_int8 dW (codes per column of each "
        f"{Q8_GEMM_ROWS}-row block) vs the fp32 dW of the same chunk, "
        f"largest relative L2 per GEMM (must be <= {INT8_SWEEP_RTOL}): "
        f"{ {k: round(v, 6) for k, v in int8_rel.items()} }; largest share "
        f"of zero codes in G: { {k: round(v, 4) for k, v in zero_g.items()} }"
        f"; with one scale per column over the whole chunk (plain version, "
        f"not gated): "
        f"{ {k: round(v, 6) for k, v in int8_rel_whole.items()} }")
    # held until the times are printed, so that a failing run still shows
    # them; the run fails before its result lines all the same
    late_failures = [f"gemm_fisher_int8 {k}: int8 dW at relative L2 {v} "
                     f"from the fp32 dW" for k, v in int8_rel.items()
                     if not v <= INT8_SWEEP_RTOL]
    # what the checks above read and the times below do not, freed before
    # the LM phases (the largest of them needs the card to itself)
    del sw, fimd_in, fimd_out, fimd_out_bf16, gemm_out, gemm_out_bf16
    del gemm8_in, gemm8_out, rs_out, a_bf16, g_bf16, big_stack_bf16
    torch.cuda.empty_cache()

    PHASES.start("lm")
    # 9. [lm]: the dense decoder LM at full width, fp32 (bf16 weights) and
    # int8, layerwise and scanned, and a K = 2 drain
    lm_keep = {}
    lm = lm_phase(dev, rate, zero_counts, dampen_counts, fisher_counts,
                  keep=lm_keep)

    # 10. [shard]: sharded requests on [lm]'s weights on the 1x1 mesh of a
    # one-rank NCCL group, == unsharded, and the elastic restore;
    # 11. [cache]: two cold starts of serve --fleet on one cache dir
    PHASES.start("shard")
    sharded = shard_phase(dev, smi, zero_counts, dampen_counts,
                          fisher_counts, lm_keep)
    lm_keep.clear()
    torch.cuda.empty_cache()
    PHASES.start("cache")
    cached = cache_phase(smi)

    # 12. [recurrent]: xlstm-125m (4 blocks) and recurrentgemma-9b (3
    # blocks) at full width, fp32 (bf16 weights) and int8, layerwise and
    # scanned
    PHASES.start("recurrent")
    rec, rec_err = recurrent_phase(dev, rate, zero_counts, dampen_counts,
                                   fisher_counts)
    for k in gmax_err:
        gmax_err[k] = max(gmax_err[k], rec_err[k])

    # 13. [dense]: yi-6b at full width and 4 of its 32 blocks, fp32 (bf16
    # weights) and int8, layerwise and scanned, and a 2048-token request
    PHASES.start("dense")
    dense, dense_err = dense_phase(dev, rate, zero_counts, dampen_counts,
                                   fisher_counts)
    for k in gmax_err:
        gmax_err[k] = max(gmax_err[k], dense_err[k])

    # 13b. [qwen]: qwen1.5-32b at full width and 2 of its 64 blocks, fp32
    # (bf16 weights) and int8, a halting ficabu kernel against plain;
    # 13c. [dryrun]: the launchers' terms against the card, its decode cell
    # on [qwen]'s weights
    qkeep = {}
    PHASES.start("qwen")
    qwen, qwen_err = qwen_phase(dev, rate, zero_counts, dampen_counts,
                                fisher_counts, qkeep)
    for k in gmax_err:
        gmax_err[k] = max(gmax_err[k], qwen_err[k])
    PHASES.start("dryrun")
    dry = dryrun_phase(dev, kind, zero_counts, dampen_counts, fisher_counts,
                       qkeep)

    # 14. [moe]: llama4-scout at full width and 1 of its 48 blocks, fp32
    # (bf16 weights, the f32 router) and int8, layerwise and scanned
    PHASES.start("moe")
    moe, moe_err = moe_phase(dev, rate, zero_counts, dampen_counts,
                             fisher_counts)
    for k in gmax_err:
        gmax_err[k] = max(gmax_err[k], moe_err[k])

    # 15. [encdec]: whisper-tiny FULL, fp32 (bf16 weights) and int8, the
    # layerwise loop (scanned has no plan), a K = 2 drain, and decode
    PHASES.start("encdec")
    encdec, encdec_err = encdec_phase(dev, rate, zero_counts, dampen_counts,
                                      fisher_counts)
    for k in gmax_err:
        gmax_err[k] = max(gmax_err[k], encdec_err[k])

    # 16. [serve]: gemma3-1b (6 blocks) through the serving loop, the
    # streamed Fisher refresh, the kernel fleet, layerwise and a guarded
    # abort
    PHASES.start("serve")
    served = serve_phase(dev, rate, zero_counts, dampen_counts,
                         fisher_counts)

    # 17. [stream]: the StreamEngine on gemma3-1b FULL, kernel == plain;
    # 18. [fleet]: --fleet's loop and gates; 19. [recover]: a SIGKILLed
    # drain recovered; 20. [load]: the load harness and report --slo
    PHASES.start("stream")
    streamed = stream_phase(dev, rate, zero_counts, dampen_counts,
                            fisher_counts)
    torch.cuda.empty_cache()
    PHASES.start("fleet")
    streamed.update(fleet_phase(dev, zero_counts, dampen_counts,
                                fisher_counts))
    PHASES.start("recover")
    streamed.update(recover_phase(dev))
    PHASES.start("load")
    streamed.update(load_phase(dev))

    # 21. [train]: the train launcher on gemma3-1b at full width and 6 of
    # its 26 blocks: resume, the mid-run forget replayed with the kernel,
    # the int8 codec
    PHASES.start("train")
    streamed.update(train_phase(dev, smi, zero_counts, dampen_counts,
                                fisher_counts))

    PHASES.start("examples")
    streamed.update(examples_phase(dev))

    PHASES.start("time")
    # 23. times at the main paths' shapes. The sweep as a request launches
    # it: one grouped launch per layer, back to front, on the layers' own
    # tensors against the global Fisher; beside it the same 56 leaves one
    # launch each, as the request launched them before the grouped kernel
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    sweep_tables = []
    for j in range(adapter.n_layers - 1, -1, -1):
        i_gs = tree_leaves(adapter.get_layer(fisher_g, j))
        sweep_tables.append((
            tree_leaves(adapter.get_layer(params, j)),
            [torch.rand(g.shape, generator=gen, device=dev) * 20 * g
             for g in i_gs], i_gs))
    sweep_ops = [leaf for tab in sweep_tables for leaf in zip(*tab)]
    n_sweep = sum(t.numel() for t, _, _ in sweep_ops)
    if len(sweep_ops) != 56 or n_sweep != n_params:
        raise AssertionError(f"the timed sweep holds {len(sweep_ops)} leaves "
                             f"of {n_sweep} elements")

    def sweep(fn):
        for th, i_f, i_g in sweep_ops:
            fn(th, i_f, i_g, 10.0, 1.0)

    def sweep_grouped(fn, tables=sweep_tables):
        for ths, i_fs, i_gs in tables:
            fn(ths, i_fs, i_gs, 10.0, 1.0)

    big = max(shapes, key=lambda s: torch.Size(s).numel())
    n_big = torch.Size(big).numel()
    # four operand sets of the largest leaf (4 x 40 MB) so that every
    # launch reads from device memory, not from the 50 MB L2
    sets = [(torch.randn(big, generator=gen, device=dev),
             torch.rand(big, generator=gen, device=dev),
             torch.rand(big, generator=gen, device=dev)) for _ in range(4)]
    rot = iter(range(1 << 30))

    def one_big(fn, dtype=torch.float32):
        th, i_f, i_g = sets[next(rot) % 4]
        fn(th if dtype == torch.float32 else th.to(dtype), i_f, i_g, 10.0,
           1.0)

    sets_bf16 = [(s[0].to(torch.bfloat16),) + s[1:] for s in sets]

    def one_big_bf16(fn):
        th, i_f, i_g = sets_bf16[next(rot) % 4]
        fn(th, i_f, i_g, 10.0, 1.0)

    t = {
        "sweep_kernel": cuda_time_ms(
            lambda: sweep_grouped(kd.dampen_group_cuda), 8, queue_ahead=True),
        "sweep_per_leaf": cuda_time_ms(lambda: sweep(kd.dampen_cuda), 8,
                                       queue_ahead=True),
        "sweep_plain": cuda_time_ms(
            lambda: sweep_grouped(kd.dampen_group_ref), 1, queue_ahead=True),
        "sweep_kernel_stream": cuda_time_ms(
            lambda: sweep_grouped(kd.dampen_group_cuda), 20),
        "sweep_ops_stream": cuda_time_ms(
            lambda: sweep_grouped(ops.dampen_group), 20),
        "sweep_per_leaf_stream": cuda_time_ms(lambda: sweep(kd.dampen_cuda),
                                              20),
        "sweep_plain_stream": cuda_time_ms(
            lambda: sweep_grouped(kd.dampen_group_ref), 20),
        "big_kernel": cuda_time_ms(lambda: one_big(kd.dampen_cuda), 200,
                                   queue_ahead=True),
        "big_plain": cuda_time_ms(lambda: one_big(kd.dampen_ref), 50,
                                  queue_ahead=True),
        "bf16_kernel": cuda_time_ms(lambda: one_big_bf16(kd.dampen_cuda),
                                    200, queue_ahead=True),
        "bf16_plain": cuda_time_ms(lambda: one_big_bf16(kd.dampen_ref), 40,
                                   queue_ahead=True),
    }
    # 17 bytes per element (theta, i_f, i_g read; theta', mask written) and
    # each layer's 8-byte count
    bound = {"sweep": (n_sweep * 17 + 8 * len(sweep_tables)) / rate * 1e3,
             "big": n_big * 17 / rate * 1e3, "bf16": n_big * 13 / rate * 1e3}

    def time_lines(kernel, tk, bk, keys):
        for key in keys:
            before = BEFORE_MS[kernel].get(key)
            log(f"[time] {kernel} {key:5s} device: kernel "
                f"{tk[key + '_kernel']:.5f} ms, plain "
                f"{tk[key + '_plain']:.5f} ms, bound {bk[key]:.5f} ms "
                f"({bk[key] / tk[key + '_kernel'] * 100:.1f}% of the memory "
                f"bound); before: {before} ms")
        log(f"[time] {kernel} sweep per leaf (56 launches) device: "
            f"{tk['sweep_per_leaf']:.5f} ms "
            f"({bk['sweep'] / tk['sweep_per_leaf'] * 100:.1f}% of the bound)")
        before = BEFORE_MS[kernel].get("stream")
        log(f"[time] {kernel} sweep stream (host launch overhead included): "
            f"grouped {tk['sweep_kernel_stream']:.5f} ms, through kernels.ops "
            f"{tk['sweep_ops_stream']:.5f} ms, per leaf "
            f"{tk['sweep_per_leaf_stream']:.5f} ms, plain "
            f"{tk['sweep_plain_stream']:.5f} ms"
            + (f"; before: {before} ms" if before else ""))

    time_lines("dampen", t, bound, ("sweep", "big", "bf16"))
    log(f"[time] (sweep = the {len(sweep_tables)} grouped launches of one ssd "
        f"request, one per layer, {len(sweep_ops)} leaves, {n_sweep} "
        f"elements, f32; big = the largest leaf {big}, {n_big} elements, "
        f"one launch; device = launches queued ahead, back to back on the "
        f"card; before = {BEFORE_MS['source']})")

    # the int8 kernel at the int8 path's shapes: the same tables (and four
    # sets of the largest leaf, 4 x 21 MB) as int8 codes
    sweep8_tables = [([q8_quantize(th)[0] for th in ths], i_fs, i_gs)
                     for ths, i_fs, i_gs in sweep_tables]
    sweep8_ops = [leaf for tab in sweep8_tables for leaf in zip(*tab)]
    sets8 = [(q8_quantize(st[0])[0],) + st[1:] for st in sets]

    def sweep8(fn):
        for q, i_f, i_g in sweep8_ops:
            fn(q, i_f, i_g, 10.0, 1.0)

    def one_big8(fn):
        q, i_f, i_g = sets8[next(rot) % 4]
        fn(q, i_f, i_g, 10.0, 1.0)

    t8 = {
        "sweep_kernel": cuda_time_ms(
            lambda: sweep_grouped(kd.dampen_int8_group_cuda, sweep8_tables),
            8, queue_ahead=True),
        "sweep_per_leaf": cuda_time_ms(lambda: sweep8(kd.dampen_int8_cuda),
                                       8, queue_ahead=True),
        "sweep_plain": cuda_time_ms(
            lambda: sweep_grouped(kd.dampen_int8_group_ref, sweep8_tables),
            1, queue_ahead=True),
        "sweep_kernel_stream": cuda_time_ms(
            lambda: sweep_grouped(kd.dampen_int8_group_cuda, sweep8_tables),
            20),
        "sweep_ops_stream": cuda_time_ms(
            lambda: sweep_grouped(ops.dampen_int8_group, sweep8_tables), 20),
        "sweep_per_leaf_stream": cuda_time_ms(
            lambda: sweep8(kd.dampen_int8_cuda), 20),
        "sweep_plain_stream": cuda_time_ms(
            lambda: sweep_grouped(kd.dampen_int8_group_ref, sweep8_tables),
            20),
        "big_kernel": cuda_time_ms(lambda: one_big8(kd.dampen_int8_cuda),
                                   200, queue_ahead=True),
        "big_plain": cuda_time_ms(lambda: one_big8(kd.dampen_int8_ref), 50,
                                  queue_ahead=True),
    }
    # 11 bytes per element: theta_q (1) + i_f (4) + i_g (4) read, codes (1)
    # + mask (1) written; and each layer's count
    bound8 = {"sweep": (n_sweep * 11 + 8 * len(sweep_tables)) / rate * 1e3,
              "big": n_big * 11 / rate * 1e3}
    time_lines("dampen_int8", t8, bound8, ("sweep", "big"))

    # the ViT sweep as its ssd request launches it: 14 grouped launches, back
    # to front, on the pre-trained layers against the ViT's global Fisher,
    # in f32 and as int8 codes
    vit_tables = []
    for j in range(vadapter.n_layers - 1, -1, -1):
        i_gs = tree_leaves(vadapter.get_layer(vfisher, j))
        vit_tables.append((
            tree_leaves(vadapter.get_layer(vparams, j)),
            [torch.rand(g.shape, generator=gen, device=dev) * 20 * g
             for g in i_gs], i_gs))
    vit_tables8 = [([q8_quantize(th)[0] for th in ths], i_fs, i_gs)
                   for ths, i_fs, i_gs in vit_tables]
    n_vit = sum(t.numel() for ths, _, _ in vit_tables for t in ths)
    tv = {
        "fp32": cuda_time_ms(
            lambda: sweep_grouped(kd.dampen_group_cuda, vit_tables), 8,
            queue_ahead=True),
        "fp32_plain": cuda_time_ms(
            lambda: sweep_grouped(kd.dampen_group_ref, vit_tables), 1,
            queue_ahead=True),
        "int8": cuda_time_ms(
            lambda: sweep_grouped(kd.dampen_int8_group_cuda, vit_tables8), 8,
            queue_ahead=True),
        "int8_plain": cuda_time_ms(
            lambda: sweep_grouped(kd.dampen_int8_group_ref, vit_tables8), 1,
            queue_ahead=True),
    }
    # the same bytes per element as the ResNet sweeps, and each layer's count
    vbound = {"fp32": (n_vit * 17 + 8 * len(vit_tables)) / rate * 1e3,
              "int8": (n_vit * 11 + 8 * len(vit_tables)) / rate * 1e3}
    for kernel, path in (("dampen", "fp32"), ("dampen_int8", "int8")):
        log(f"[time] {kernel} vit sweep device ({len(vit_tables)} grouped "
            f"launches, {n_vit} elements): kernel {tv[path]:.5f} ms, plain "
            f"{tv[path + '_plain']:.5f} ms, bound {vbound[path]:.5f} ms "
            f"({vbound[path] / tv[path] * 100:.1f}% of the memory bound)")

    # the four kernels reached through kernels.ops, at the largest shapes of
    # the [fisher kernels] phase (and gemm at the longest reduction too)
    def bound_of(nbytes, n_ops=0.0, op_rate=1.0):
        by_bytes, by_ops = nbytes / rate * 1e3, n_ops / op_rate * 1e3
        return ((by_bytes, "bytes") if by_bytes >= by_ops
                else (by_ops, "operations"))

    def int_mm_layout(a_q, g_q):
        """How torch._int_mm computes a_q^T g_q (int32, dW only, no scale or
        square): the name of the first operand layout it accepts and the map
        from (a_q, g_q) to its arguments, or (None, None) where it refuses
        the shape."""
        for how, prep in (("a_q.t(), g_q", lambda x, y: (x.t(), y)),
                          ("a_q.t().contiguous(), g_q",
                           lambda x, y: (x.t().contiguous(), y))):
            try:
                torch._int_mm(*prep(a_q, g_q))
                torch.cuda.synchronize()
            except RuntimeError:
                continue
            return how, prep
        return None, None

    def rotating(first, make, nbytes):
        """``first`` and copies from ``make()``: at least three operand sets,
        together more than the L2, so that every timed call reads its
        operands from device memory."""
        return [first] + [make() for _ in range(
            max(3, int(L2_BYTES // nbytes) + 1) - 1)]

    def fimd_library(st):
        """One PyTorch call computing fimd's function (a yardstick only)."""
        return torch.linalg.vecdot(st, st, dim=0)

    stacks = [big_stack.view(8, -1), big_stack.clone().view(8, -1)]
    B_f, P_f = stacks[0].shape
    torch.testing.assert_close(fimd_library(stacks[0]), kf.fimd_ref(stacks[0]),
                               rtol=1e-5, atol=0)
    rs_big = max(rs_in, key=lambda x: x[0].numel())
    R_b, C_b = rs_big[0].shape
    # four operand sets of the largest leaf (4 x 23.6 MB) beyond the L2
    rs_sets = [(rs_big[0], rs_big[1].float(), rs_big[2], rs_big[3])] + [
        (torch.randint(-127, 128, (R_b, C_b), generator=gen, device=dev,
                       dtype=torch.int8),
         torch.randint(0, 128, (R_b, C_b), generator=gen,
                       device=dev).float(),
         rs_big[2].clone(), rs_big[3].clone()) for _ in range(3)]
    tf = {
        "fimd_kernel": cuda_time_ms(
            lambda: kf.fimd_cuda(stacks[next(rot) % 2]), 100,
            queue_ahead=True),
        "fimd_plain": cuda_time_ms(
            lambda: kf.fimd_ref(stacks[next(rot) % 2]), 40, queue_ahead=True),
        "fimd_library": cuda_time_ms(
            lambda: fimd_library(stacks[next(rot) % 2]), 100,
            queue_ahead=True),
        "rs_kernel": cuda_time_ms(
            lambda: kd.dampen_int8_rowscale_cuda(*rs_sets[next(rot) % 4],
                                                 10.0, 1.0), 200,
            queue_ahead=True),
        "rs_plain": cuda_time_ms(
            lambda: kd.dampen_int8_rowscale_ref(*rs_sets[next(rot) % 4],
                                                10.0, 1.0), 50,
            queue_ahead=True),
    }
    bounds = {"fimd": bound_of(4 * B_f * P_f + 4 * P_f),
              "dampen_int8_rowscale": bound_of(10 * R_b * C_b + 4 * R_b)}
    gemm_t = {}
    for name, iters in (("blocks/7/conv2", 50), ("blocks/1/conv1", 30)):
        a, g = gemm_in[name][0][:2]
        aq, gq, sa, sg = q8_gemm_operands(a, g)   # the whole chunk, one call
        N, M = a.shape
        K = g.shape[1]
        fsets = rotating((a, g), lambda: (
            torch.randn(a.shape, generator=gen, device=dev),
            torch.randn(g.shape, generator=gen, device=dev)),
            4 * N * (M + K))
        qsets = rotating((aq, gq), lambda: (
            torch.randint(-127, 128, aq.shape, generator=gen, device=dev,
                          dtype=torch.int8),
            torch.randint(-127, 128, gq.shape, generator=gen, device=dev,
                          dtype=torch.int8)), N * (M + K))
        how, prep = int_mm_layout(aq, gq)
        lsets = [prep(x, y) for x, y in qsets] if prep else None

        def pick(sets):
            return sets[next(rot) % len(sets)]

        gemm_t[name] = {
            "nmk": (N, M, K), "int_mm_layout": how,
            "sets": (len(fsets), len(qsets)),
            "split": kg.split_plan(N, M, K),
            "split8": kg.split_plan(N, M, K, kg8.SLAB),
            "kernel": cuda_time_ms(lambda: kg.gemm_fisher_cuda(*pick(fsets)),
                                   iters, queue_ahead=True),
            "plain": cuda_time_ms(lambda: kg.gemm_fisher_ref(*pick(fsets)),
                                  iters, queue_ahead=True),
            "library": cuda_time_ms(
                lambda: torch.matmul(*(lambda x, y: (x.t(), y))(
                    *pick(fsets))), iters, queue_ahead=True),
            # 3xTF32: three TF32 products per term on the tensor cores
            "bound": bound_of(4 * (N * M + N * K) + 8 * M * K,
                              3 * 2 * N * M * K, tf32_rate),
            "bound_simt": 2 * N * M * K / fp32_rate * 1e3,
            "kernel8": cuda_time_ms(
                lambda: kg8.gemm_fisher_int8_cuda(*pick(qsets), sa, sg),
                iters, queue_ahead=True),
            "plain8": cuda_time_ms(
                lambda: kg8.gemm_fisher_int8_ref(*pick(qsets), sa, sg),
                iters, queue_ahead=True),
            "library8": (cuda_time_ms(lambda: torch._int_mm(*pick(lsets)),
                                      iters, queue_ahead=True)
                         if lsets else None),
            "bound8": bound_of(N * M + N * K + 4 * (M + K) + 8 * M * K,
                               2 * N * M * K, int8_rate),
        }
    log(f"[time] fimd [{B_f}, {P_f}] f32 device: kernel "
        f"{tf['fimd_kernel']:.5f} ms, plain {tf['fimd_plain']:.5f} ms, "
        f"torch.linalg.vecdot(g, g, dim=0) {tf['fimd_library']:.5f} ms, bound "
        f"{bounds['fimd'][0]:.5f} ms ({bounds['fimd'][1]}, "
        f"{bounds['fimd'][0] / tf['fimd_kernel'] * 100:.1f}%)")
    log(f"[time] dampen_int8_rowscale [{R_b}, {C_b}] device, four operand "
        f"sets rotated beyond L2: kernel {tf['rs_kernel']:.5f} ms, plain "
        f"{tf['rs_plain']:.5f} ms, bound "
        f"{bounds['dampen_int8_rowscale'][0]:.5f} ms (bytes, "
        f"{bounds['dampen_int8_rowscale'][0] / tf['rs_kernel'] * 100:.1f}%); "
        f"before: {BEFORE_MS['dampen_int8_rowscale']['big']} ms (one "
        f"division per thread and a 64-bit row walk, PERF.md section 6)")
    for name, gt in gemm_t.items():
        log(f"[time] gemm_fisher {name} (N, M, K) {gt['nmk']}, split S, rows "
            f"{gt['split']}, {gt['sets'][0]} operand sets rotated beyond L2, "
            f"device: kernel {gt['kernel']:.5f} ms, plain {gt['plain']:.5f} "
            f"ms, torch.matmul (dW only, no square, TF32 off) "
            f"{gt['library']:.5f} ms, bound {gt['bound'][0]:.5f} ms "
            f"({gt['bound'][1]} vs 3xTF32, "
            f"{gt['bound'][0] / gt['kernel'] * 100:.1f}%); FP32-SIMT bound "
            f"{gt['bound_simt']:.5f} ms")
        lib8 = ("refused" if gt["library8"] is None
                else f"{gt['library8']:.5f} ms ({gt['int_mm_layout']})")
        log(f"[time] gemm_fisher_int8 {name}, split S, rows {gt['split8']}, "
            f"{gt['sets'][1]} operand sets, device: kernel "
            f"{gt['kernel8']:.5f} ms, plain {gt['plain8']:.5f} ms, "
            f"torch._int_mm (dW only, no square) {lib8}, bound "
            f"{gt['bound8'][0]:.5f} ms ({gt['bound8'][1]}, "
            f"{gt['bound8'][0] / gt['kernel8'] * 100:.1f}%)")

    PHASES.start("profile")
    # where one warm ssd request spends its time on the card, per model and
    # path
    def warm_profile(unl, prm, group=None, profiled=True):
        """Wall time of a warm request (or of a warm drain of ``group``):
        the median of 3 on the host's clock, ending in a synchronize, and
        (``profiled``) one profiled run: device busy time, device kernels,
        the dampen kernels among them, the top kernels."""
        def run():
            if group is None:
                unl.forget(ForgetRequest(fx, fy), params=prm)
            else:
                unl.forget_group(group, params=prm)

        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        if not profiled:
            return sorted(walls)[1], walls
        busy, n_kernels, ranked = profile_request(run)
        damp = [(ms, count) for name, ms, count in ranked
                if "dampen_group_kernel" in name]
        return (sorted(walls)[1], walls, busy, n_kernels,
                sum(c for _, c in damp), sum(ms for ms, _ in damp), ranked)

    prof = {}
    vssd8 = vssd.with_spec(vspec("ssd", **int8_kw))
    for path, unl, prm in (("fp32", ssd, params), ("int8", ssd8, params),
                           ("vit fp32", vssd, vparams),
                           ("vit int8", vssd8, vparams)):
        wall, walls, busy, n_kernels, n_damp, damp_ms, ranked = \
            warm_profile(unl, prm)
        prof[path] = (wall, busy, n_kernels, n_damp, damp_ms)
        log(f"[profile] warm {path} ssd request: wall {wall:.2f} ms (median "
            f"of {[round(w, 2) for w in walls]}), device busy {busy:.3f} ms, "
            f"idle share {1 - busy / wall:.3f}, {n_kernels} device kernels, "
            f"of them {n_damp} dampen_group_kernel ({damp_ms:.4f} ms)")
        for name, ms, count in ranked[:6]:
            log(f"[profile]   {ms:9.3f} ms  x{count:<5d} {name[:70]}")
    for model, p32, p8 in (("", "fp32", "int8"),
                           ("vit ", "vit fp32", "vit int8")):
        log(f"[profile] {model}int8 / fp32 warm ssd request: wall "
            f"{prof[p8][0] / prof[p32][0]:.3f}x, device busy "
            f"{prof[p8][1] / prof[p32][1]:.3f}x, device kernels "
            f"{prof[p8][2]} vs {prof[p32][2]} "
            f"(+{prof[p8][2] - prof[p32][2]})")
    # the scanned whole-sweep program against the layerwise loop: warm ViT
    # requests, ssd and the ficabu that halts at l = 1, side by side (the
    # layerwise ssd request's device figures are those of its profile
    # above; its wall is taken again here, beside the scanned one)
    sprof = {}
    for path, kw in (("fp32", {}), ("int8", int8_kw)):
        for name in ("ssd", "ficabu"):
            for mode in ("layerwise", "scanned"):
                unl = vssd.with_spec(vspec(name, sweep_mode=mode, **kw))
                if (name, mode) == ("ssd", "layerwise"):
                    wall, walls = warm_profile(unl, vparams, profiled=False)
                    _, busy, n_kernels, n_damp, damp_ms = prof["vit " + path]
                else:
                    wall, walls, busy, n_kernels, n_damp, damp_ms, _ = \
                        warm_profile(unl, vparams)
                sprof[(path, name, mode)] = (wall, busy, n_kernels, n_damp)
                log(f"[profile] warm vit {path} {name} {mode} request: wall "
                    f"{wall:.2f} ms (median of "
                    f"{[round(w, 2) for w in walls]}), device busy "
                    f"{busy:.3f} ms, idle share {1 - busy / wall:.3f}, "
                    f"{n_kernels} device kernels, {n_damp} dampen launches "
                    f"({damp_ms:.4f} ms)")
            a, b = sprof[(path, name, "scanned")], sprof[(path, name,
                                                          "layerwise")]
            log(f"[profile] vit {path} {name} scanned / layerwise: wall "
                f"{a[0] / b[0]:.3f}x, device busy {a[1] / b[1]:.3f}x, device "
                f"kernels {a[2]} vs {b[2]}, dampen launches {a[3]} vs "
                f"{b[3]}")
    # the fp32 K = 2 ssd drain of [scanned] against two single requests
    for path, kw in (("fp32", {}),):
        for mode in ("layerwise", "scanned"):
            wall, walls, busy, n_kernels, n_damp, damp_ms, _ = warm_profile(
                vssd.with_spec(vspec("ssd", sweep_mode=mode, **kw)),
                vparams, group)
            one = sprof[(path, "ssd", mode)]
            log(f"[profile] warm vit {path} K=2 ssd {mode} drain: wall "
                f"{wall:.2f} ms (median of {[round(w, 2) for w in walls]}), "
                f"device busy {busy:.3f} ms, idle share "
                f"{1 - busy / wall:.3f}, {n_kernels} device kernels, "
                f"{n_damp} dampen launches; / two single {mode} requests: "
                f"wall {wall / (2 * one[0]):.3f}x, device busy "
                f"{busy / (2 * one[1]):.3f}x, device kernels "
                f"{n_kernels / (2 * one[2]):.3f}x")

    PHASES.stop()
    if late_failures:
        raise AssertionError("; ".join(late_failures))
    log(f"[done] every phase passed in {time.perf_counter() - t_main:.1f} s")
    log("[phases] " + json.dumps({k: round(v, 1)
                                  for k, v in PHASES.seconds.items()}))

    def scanned_keys(path):
        """(launches, leaves) of the [scanned] phase's warm requests and
        drains in ``path``'s kernel."""
        keys = {f"vit_scanned_{name}_launches_leaves": list(
            scanned[(path, name)]) for name in ("ssd", "ficabu-nohalt",
                                                "ficabu", "group")}
        if path == "fp32":
            keys["resnet_group_k2_launches_leaves"] = list(
                scanned[("fp32", "resnet group")])
        return keys

    print(json.dumps({"kernels": [{
        "name": "dampen", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/dampen.cu",
        "replaces": "src/repro/kernels/dampen.py:28",
        "launches": main_launches, "leaves": main_leaves,
        "launches_per_ssd_request": ssd_launches["fp32"],
        "vit_launches": vruns["fp32"][1][0],
        "vit_launches_per_ssd_request": vit_ssd["fp32"][0],
        "vit_leaves": vit_ssd["fp32"][1],
        "vit_sweep_ms": tv["fp32"], "vit_sweep_plain_ms": tv["fp32_plain"],
        "vit_sweep_bound_ms": vbound["fp32"],
        **scanned_keys("fp32"), **lm["fp32"], **rec["fp32"],
        **dense["fp32"], **qwen["fp32"], **dry, **moe["fp32"],
        **encdec["fp32"], **served["fp32"], **streamed, **sharded["fp32"],
        **cached,
        "max_abs_err": max(max_err, gmax_err["dampen"]),
        "ms": t["sweep_kernel"], "plain_ms": t["sweep_plain"],
        "bound_ms": bound["sweep"], "bound_by": "bytes",
        "library_ms": None,
        "stream_ms": t["sweep_kernel_stream"],
        "ops_stream_ms": t["sweep_ops_stream"],
        "plain_stream_ms": t["sweep_plain_stream"],
        "per_leaf_ms": t["sweep_per_leaf"],
        "per_leaf_stream_ms": t["sweep_per_leaf_stream"],
        "largest_leaf": {"n": n_big, "ms": t["big_kernel"],
                         "plain_ms": t["big_plain"],
                         "bound_ms": bound["big"],
                         "bf16_ms": t["bf16_kernel"],
                         "bf16_plain_ms": t["bf16_plain"],
                         "bf16_bound_ms": bound["bf16"]},
    }, {
        "name": "dampen_int8", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/dampen.cu",
        "replaces": "src/repro/kernels/dampen.py:39",
        "launches": main_launches8, "leaves": main_leaves8,
        "launches_per_ssd_request": ssd_launches["int8"],
        "vit_launches": vruns["int8"][1][2],
        "vit_launches_per_ssd_request": vit_ssd["int8"][0],
        "vit_leaves": vit_ssd["int8"][1],
        "vit_sweep_ms": tv["int8"], "vit_sweep_plain_ms": tv["int8_plain"],
        "vit_sweep_bound_ms": vbound["int8"],
        **scanned_keys("int8"), **lm["int8"], **rec["int8"],
        **dense["int8"], **qwen["int8"], **moe["int8"], **encdec["int8"],
        **served["int8"], **sharded["int8"],
        "max_abs_err": max(max_err8, gmax_err["dampen_int8"]),
        "ms": t8["sweep_kernel"], "plain_ms": t8["sweep_plain"],
        "bound_ms": bound8["sweep"], "bound_by": "bytes",
        "library_ms": None,
        "stream_ms": t8["sweep_kernel_stream"],
        "ops_stream_ms": t8["sweep_ops_stream"],
        "plain_stream_ms": t8["sweep_plain_stream"],
        "per_leaf_ms": t8["sweep_per_leaf"],
        "per_leaf_stream_ms": t8["sweep_per_leaf_stream"],
        "largest_leaf": {"n": n_big, "ms": t8["big_kernel"],
                         "plain_ms": t8["big_plain"],
                         "bound_ms": bound8["big"]},
    }, {
        "name": "dampen_int8_rowscale", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/dampen.cu",
        "replaces": "src/repro/kernels/dampen.py:51",
        "launches": fisher_launches["dampen_int8_rowscale"],
        "max_abs_err": f_err["dampen_int8_rowscale"],
        "ms": tf["rs_kernel"], "plain_ms": tf["rs_plain"],
        "bound_ms": bounds["dampen_int8_rowscale"][0],
        "bound_by": bounds["dampen_int8_rowscale"][1], "library_ms": None,
        "shape": [R_b, C_b],
    }, {
        "name": "fimd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fimd.cu",
        "replaces": "src/repro/kernels/fimd.py:27",
        "launches": fisher_launches["fimd"], "max_abs_err": f_err["fimd"],
        "ms": tf["fimd_kernel"], "plain_ms": tf["fimd_plain"],
        "bound_ms": bounds["fimd"][0], "bound_by": bounds["fimd"][1],
        "library_ms": tf["fimd_library"],
        "library_call": "torch.linalg.vecdot(g, g, dim=0)",
        "shape": [B_f, P_f],
    }] + [{
        "name": kname, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{kname}.cu",
        "replaces": replaces,
        "launches": fisher_launches[kname], "max_abs_err": f_err[kname],
        "ms": gt[key], "plain_ms": gt["plain" + sfx],
        "bound_ms": gt["bound" + sfx][0], "bound_by": gt["bound" + sfx][1],
        "library_ms": gt["library" + sfx], "library_call": lib,
        "shape_nmk": list(gt["nmk"]),
        "bound_basis": basis,
        "split_s_rows": {"blocks/7/conv2": list(gt["split" + sfx]),
                         "blocks/1/conv1": list(gl["split" + sfx])},
        "operand_sets": [gt["sets"][bool(sfx)], gl["sets"][bool(sfx)]],
        **({"fp32_simt_bound_ms": gt["bound_simt"]} if not sfx else {}),
        "longest_n": {"shape_nmk": list(gl["nmk"]), "ms": gl[key],
                      "plain_ms": gl["plain" + sfx],
                      "bound_ms": gl["bound" + sfx][0],
                      "bound_by": gl["bound" + sfx][1],
                      "library_ms": gl["library" + sfx],
                      **({"fp32_simt_bound_ms": gl["bound_simt"]}
                         if not sfx else {})},
    } for kname, key, sfx, replaces, lib, basis, gt, gl in (
        ("gemm_fisher", "kernel", "",
         "src/repro/kernels/gemm_fisher.py:38",
         "torch.matmul(a.t(), g), TF32 off: dW only, no square",
         "max(bytes at the memory rate, 3 x 2NMK operations of 3xTF32 at "
         "the TF32 rate)",
         gemm_t["blocks/7/conv2"], gemm_t["blocks/1/conv1"]),
        ("gemm_fisher_int8", "kernel8", "8",
         "src/repro/kernels/gemm_fisher_int8.py:50",
         f"torch._int_mm({gemm_t['blocks/7/conv2']['int_mm_layout']}): "
         f"int32 dW only, no scale, no square",
         "max(bytes at the memory rate, 2NMK operations at the int8 rate)",
         gemm_t["blocks/7/conv2"], gemm_t["blocks/1/conv1"]))]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
