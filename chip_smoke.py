#!/usr/bin/env python3
"""Smoke run of the PyTorch port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final line is printed):
  1. build   — nvcc builds every CUDA kernel of the port from
               src/repro_torch/kernels/csrc, one process per source, in
               parallel; prints the build seconds and ptxas' register use.
  2. kernels — each kernel against its plain PyTorch version on the card, at
               the shapes granite-8b's serving path gives it, with the stated
               tolerance, run twice for identical bits; prints its plan
               (int4_matmul's and int_matmul's contraction splits, the
               attention's key splits and row tiles), the kernel's median
               ms, the plain version's ms, one PyTorch library call
               computing the same function (timed here only, never used by
               the port) and the least time the card could take (bytes
               over 3.35 TB/s or operations over 989 TFLOP/s, whichever is
               larger), and the device kernels one call launches, as
               torch.profiler names them.
               int_matmul runs at all five w8a8 linears of granite-8b at
               M 4 (w_gate / w_in, w_out, wq, wk / wv, the head) and the
               head at M 32. Then int4_matmul's and int_matmul's rows at
               M 1, 4 and 32 must be bit-equal where they overlap, and an
               attention slot's triple the same bits in a pool of 4, alone,
               and with T 160 grown to 256 by idle rows.
  3. serve   — `repro_torch.launch.serve` on full-width granite-8b, all 36
               layers, w4a4 weights, int8 KV, 4 slots, 8 requests of 128
               prompt tokens and 32 new tokens, chunk 32: prints prefill and
               decode tok/s, peak memory and the launch count of each
               kernel over the run (each must be > 0); then holds two
               requests' engine streams (one-chunk prefill, 4-slot pool)
               equal to their single-request greedy_generate streams, and
               reports the chunk-32 run's streams against them.
  4. serve   — w8a8 weights (every N-side linear on int_matmul) with packed
               int4 KV, 4 layers; and its logits on a 16-token prompt
               against the same port on the CPU (the plain versions), with
               its int4 KV cache and with an fp one. Its
               streams are not held against greedy_generate: with 4-bit KV,
               the chunked prefill's online-softmax merge rounds otherwise
               than a one-shot prefill, and one ulp can flip a 4-bit code
               (the JAX package's own int4 engine test shows the same).
  12. moe serve — `repro_torch.launch.serve` on full-width
               granite-moe-1b-a400m, all 24 layers, 32 experts top 8, tied
               head, w3a3 weights (3-bit packed experts: the
               dequantize-and-einsum fallback in 8-row blocks; an 8-bit
               f32 router), int8 KV, 4 slots, 8 requests of 128 prompt
               tokens and 32 new tokens, chunk 32 (run after phase 4):
               phase 3's numbers, int4_matmul's and pooled_decode_attention's
               launches (each > 0) and its stream contract at the config's
               own capacity factor 1.25 (a one-chunk prefill has
               greedy_generate's shape and capacity; a decode step's 4 tokens
               fit an expert's 8 slots); then a token's MoE-layer output the
               same bits at M 1, 4 and 32, a slot's decode logits the same
               bits alone, in a pool of 4 and beside 3 idle slots; the expert
               dequantization's ms a decode step; and a 4-layer cut's logits
               on a 16-token prompt against the CPU, int8 and fp KV, with
               phase 4's bars.
  5. qat kernels — each QAT kernel against its plain version at the shapes
               of the training path (M = 8 x 512 tokens of qwen1.5-0.5b):
               quant_matmul (the tensor-core path) at both FFN shapes, a
               K-side-scaled wo and the tied head, granite-moe's attention
               shapes (w3a3) and head (8 bits), and odd, misaligned shapes
               (one with f32 x), each row within 1e-5 x max|y| (K / 2816
               times that past K 2816, always below the error of a bf16
               output: `fwd_bar`) and every
               element within the f32 order bound, run twice for identical
               bits, its prologue bit-equal to the plain dequantization;
               quant_matmul_bwd, the combined backward on the tensor cores,
               at the FFN's two shapes and wo (bf16 cotangents, one plane),
               at granite-moe's attention shapes (w3a3), at odd, misaligned
               shapes (one with f32 x), and with f32 cotangents on three
               planes (at (4096, 1024, 2816), and last at two odd shapes
               whose dW contraction `dw_splits` cuts in ranges), each row
               naming its path, planes and dW ranges S, run twice for
               identical bits, its prologue bit-equal to the plain
               dequantization; an f32 row in one dW range bit-equal to the
               split route ("as split") and each f32 row with the split
               route's time beside its own;
               quant_matmul_dx / _dw (the split grids, on the tensor cores)
               at the head with f32 cotangents as three exact bf16 planes
               (the planes bit-equal to the plain split, hi + mid + lo == dY
               in f64 over the whole cotangent), at the FFN's shape with bf16
               cotangents (one plane, bit-equal to quant_matmul_bwd's
               outputs) and at an odd K-side shape with f32 cotangents; the
               split's edges: a softmax head cotangent with entries below
               2^-110, and whether mma.sync keeps a bf16 subnormal lo
               (reported); with the same four numbers a kernel (the f32
               line beside the three planes' bound), and the bars of the CPU
               tests; dws is held as in phase 5b (the
               plain bar plus its differing bf16(xd^T dY) summands x
               |q - mf u|, read from a launch with w = 0, each summand the
               real dW where w is in range and held to the dW bar; the
               allowance approved for phase 5 too, ROADMAP Queue 3), each
               row printing the share of the allowance it uses (<= 1.0);
               each f32 row that computes dW also prints the shares of
               bf16(xd^T dY) off its correctly rounded value in the kernel
               and in the plain version.
  6. train   — `repro_torch.launch.train` on full-width qwen1.5-0.5b (24
               layers, tied head, QKV bias), w4a4, MCKD top-16, sentinel on,
               batch 8 x 512, 3 steps saving at step 2, then a second call to
               4 steps that restores step 2 and runs one: finite loss, health
               0 every step, s/step, tokens/s, peak memory, and each QAT
               kernel's launches equal to its count per step x steps.
  7. route   — the same model cut to 2 layers, batch 2 x 256: gradients on
               the kernel route against the unfused composition on the card
               (run with the kernels' rule at the clip edge; the gaps against
               the composition as it is are printed beside it).
  5b. moe kernels — quant_matmul_batched and quant_matmul_bwd_batched
               against their plain versions at granite-moe-1b-a400m's expert
               shapes (32 experts x 1280 capacity rows, K/N 1024/512 and
               512/1024, w3a3) and at an odd (3, 257, 129, 65) with f32 x,
               both on the tensor cores; the forward with phase 5's forward
               bars and experts 0 and E-1 bit-equal to quant_matmul on their
               slices; the backward with phase 5's backward bars per expert,
               each row naming its path, run twice for identical bits, its
               prologue bit-equal to the plain dequantization, and experts 0
               and E-1 bit-equal in all five outputs to quant_matmul_bwd on
               their slices; dws may also differ from the plain dws by its
               differing bf16(xd^T dY) summands x |q - mf u| (read from a
               launch with w = 0, each summand held to the dW bar); the
               backward also with f32 cotangents (three planes, the 2D
               backward's dW ranges, the split route's time beside it) and
               once on its split route (a wide N past the reference's
               scratch budget: the split grids, expert by expert); run with
               phase 5.
  8. train   — `run_training` on full-width granite-moe-1b-a400m (24 layers,
               32 experts top 8, tied head), w3a3 (OBR lambda 0.1 on a cosine
               ramp) with oscillation tracking, MCKD top-16, sentinel on,
               batch 8 x 512, 3 steps: finite loss and no fatal health bit
               every step, loss_main / loss_obr / obr_lambda (0, then > 0) /
               osc_frac / lb_loss / drop_frac per step, s/step, peak memory,
               and every QAT kernel's launches equal to the printed formula x
               3 (the batched kernels on the expert linears).
  9. route   — granite-moe cut to 2 layers, batch 2 x 256, at init: phase
               7's check, plus the share of expert choices that differ
               between the routes.
  10. quantizer kernels — fake_quant_2d, fake_quant_rows and bin_stats_2d
               against their plain versions (fake-quant bit for bit; bin
               counts equal, sums within 1e-5 of each bin's sum of
               |summands|) at the kernel benchmark's (4096, 1024) f32,
               granite-8b's w_in (4096, 14336) f32 at 4 and 8 bits,
               qwen1.5-0.5b's FFN activation (4096, 2816) bf16 unsigned
               4 bits with offset, granite-moe's expert stack (32, 1024 x
               512) with a scale an expert at 3 bits, and odd, misaligned
               edges; run with phase 5.
  11. kernel bench — `repro_torch.launch.kernel_bench` --smoke, then the
               full run (JSON in build/, its numbers also on stdout and
               in the summary line): every gate passes, and
               fake_quant_2d / bin_stats_2d are launched (fake_quant_rows
               has no entry point: its launches are phase 10's).
  13. serve  — `repro_torch.launch.serve` on full-width musicgen-medium, all
               48 layers (learned positions, layernorm, gelu, untied 8-bit
               head), w4a4, int8 KV, 4 slots, 8 requests of 128 prompt
               tokens and 32 new tokens, chunk 32 (run after phase 12):
               phase 3's numbers, kernels 7, 8 and 9 launched, streams
               equal greedy_generate with a one-chunk prefill, a slot's
               decode logits the same bits alone, pooled and beside idle
               slots, and a 4-layer cut against the CPU with phase 4's
               bars. Phase 2 holds kernels 7-9 at its shapes and phase 5
               the QAT kernels at the training shapes of phase 14 (the
               f32 combined backward on three planes at musicgen-medium's
               head, one dW range, and paper-deit-t's, 13 ranges; the
               one-plane split dx / dw at musicgen-medium's
               w_in, paper-bert-base's head on three planes).
  14. train  — `repro_torch.launch.train --arch musicgen-medium` (w4a4, MCKD,
               batch 8 x 512, 3 steps); `run_training` on full-width
               paper-bert-base (w2a2, OBR, oscillation tracked, batch 32 x
               128) and paper-deit-t (w3a3, batch 64 x 197 patches): finite
               losses, health 0, s/step, peak memory, and each run's QAT
               launches equal to `qat_launches_per_step`, which decides
               each linear's backward route by `quant_matmul.bwd_route` on
               the padded shape as the dispatcher does. Then the MCKD store
               on the card: paper-bert-base's fp teacher builds a shard of
               2 batches x 4 window_crop views, read back bit for bit, and
               one w2a2 MCKD step trains from it.
  15. tables — the five paper-table twins (`repro_torch.tables`) at their
               reference size, steps cut to TABLE_STEPS: their rows,
               every value finite.
  16. train  — `repro_torch.launch.train --arch xlstm-350m` at full width
               cut to one period (`--layers 8`: 7 mLSTM, 1 sLSTM; 24
               layers before PR 30; tied 50,304 head), w4a4, MCKD, batch 8 x 512, 3 steps saving at step 2,
               then a restored 4th step: phase 6's gates, launches equal
               `qat_launches_per_step` (the recurrent projections, the
               N = 4 gates and the sLSTM's FFN on kernels 1 and 5).
  17. serve  — `greedy_generate` over full-width recurrentgemma-9b (38
               layers: RG-LRU and local attention, window 2048, MQA, head
               dim 256, tied 256,000 head), w4a4, int8 KV, 8 x 128 prompt
               tokens + 32 new (the engine refuses recurrent patterns, as
               the reference's does): prefill and decode tok/s, peak
               memory, kernels 8 and 9 launched (kernel 7 has no linear
               here: every projection is 4-bit, the head tied); rows 0
               and 7 alone give their batch rows' tokens and logits bits
               at every step; a one-period cut (3 layers) against the CPU
               with phase 4's bars.
  18. serve  — the same over full-width xlstm-350m: kernels 7 (the 8-bit
               gates, m_i / m_f at N = 4) and 8 launched, row bits, an
               8-layer cut against the CPU.
  19. train  — `run_training` on recurrentgemma-9b cut to one period (3
               layers, full width), w4a4, 8 x 512, 2 steps: health 0,
               launches equal the formula (the RG-LRU's g_a / g_x with f32
               outputs, the split dx / dw past the scratch budget).
  20. train  — `run_training` on llama-3.2-vision-11b cut to one period (5
               layers, one cross layer, full width) with 1024 stub patch
               embeddings a sample, w4a4, 4 x 512, 2 steps (xk / xv over
               the 4 x 1024 patch rows); then its token-by-token decode
               against its forward at init, the reference's bars, the
               cached attention unfused as the reference's test runs it
               (the kernel route's gap printed beside it).
  21. faults — `run_training` on full-width paper-bert-base (w2a2, OBR,
               oscillation tracked, batch 32 x 128) through the NaN
               rollback scenario of the reference's
               test_e2e_nan_rollback_recovery: 14 steps saving every 4, the
               token embedding NaN-poisoned before step 9 and the step-8
               checkpoint corrupted; loop steps 9 and 10 fatal, one
               rollback to step 4, lr_scale 0.5, 20 steps run, step 12's
               checkpoint verified, QAT launches equal the formula x 20;
               then SIGTERM before step 3: a forced checkpoint at 3, a
               clean exit, the signal handlers restored. Prints the health
               bits by step, each save's seconds and the checkpoint size.
  22. compress — phase 6's run again with --compress-grads (int8 gradients
               with error feedback): step 0's loss bit-equal to phase 6's,
               health 0, launches equal the formula, |err| <= scale / 2
               after every step; compress_leaf on the card bit-equal to the
               CPU at the tied head's (152064, 1024); s/step, tokens/s and
               peak memory beside phase 6's.
  23. sharded, one rank (cell R) — a process group of one over NCCL: phase
               6's run through `launch.train --model-parallel 1` (the world
               of one holds the whole state), 3 steps, losses bit-equal to
               phase 6's, launches equal the formula; phase 3's full-width
               granite-8b served with --model-parallel 1, streams equal
               phase 3's.
  Phases 24, 26 and 27 run after phase 25, in one spawn of four
  processes (`chip_smoke.py --cells-rank R PORT DIR`, logs in
  `build/chip_smoke_cells/`) that run cells S, T and U in turn: one
  interpreter, CUDA context and process group each (rank 0's start and
  its seconds a cell printed); phase 27's one-process run goes first, and
  each cell's checks follow the ranks.
  24. sharded, four ranks (cell S) — four processes share the card on a
               (2 data, 2 model) mesh over gloo (NCCL refuses two ranks on
               one device; gloo moves each CUDA payload through a host
               copy, the compute stays on the card), on the gathered
               runtime (`tp_compute=False`: every layer gathered whole,
               each model rank computing every linear whole): (a) phase 6's
               full-width qwen1.5-0.5b QAT, 3 steps, each data rank taking
               4 of the 8 rows: losses against phase 23's (step 0 within
               1e-6 relative, the CPU harness's bar; steps 1-2 within
               1e-3) and the gradient norm of steps 0-1 (the same
               weights) within 1e-4 relative of phase 23's (a gradient
               scaled by a factor fails it; the losses cannot show that,
               Adam's step being nearly blind to a gradient's scale),
               each rank's resident state bytes
               (about a quarter of cell C's params and moments) and peak;
               (b) full-width granite-8b cut to 2 layers, w4a4, int8
               KV, 4 slots, 8 x 128 prompt + 4 new tokens (4 layers and
               32 tokens, then 8, before: `SHARDED_SERVE`), one-chunk
               prefill, the KV sequence axis over the 2 model ranks (132
               rows rounded up to 256 by launch.serve: 128 a rank, two
               whole 64-key splits of kernel 9): the sharded logits (prefill + 4
               teacher-forced decode steps) bit-equal to the one-process
               model's and all 8 streams equal its greedy_generate;
               kernel 9's launches per rank. Then kernel 9 over 128 keys
               against two 64-key halves merged by
               `attention.merge_partials` (bit-equal) and over 160 keys
               against two 80-key halves (not whole splits: the gap
               printed).
  25. dry run — `launch.dryrun.lower_cell` on cell C (qwen1.5-0.5b, w4a4,
               MCKD, 8 x 512, one rank): (a) its step counted by
               `launch.cost` on the card must equal the same cell on the
               meta device exactly (FLOPs, bytes, every kernel's record);
               (b) the model-FLOPs share of phase 6's s/step (mfu against
               989 TFLOP/s), the counted FLOPs over the same time and the
               useful-FLOPs ratio; (c) the dry run's per_device_bytes
               over phase 6's torch.cuda.max_memory_allocated, held to
               MEM_BAR; (d) one decode step of cell A (granite-8b, w4a4,
               int8 KV, 4 slots x 160 rows) counted on the card and on
               meta, beside the weight bytes a step must read, and the
               roofline's memory term beside the busy ms a decode step
               measured by `launch.profile_decode`; (e) the dry-run CLI
               for qwen1.5-0.5b x train_4k and x decode_32k on the 16 x 16
               mesh, run in processes of their own (no card, lowest
               priority) from the end of the build on: each record's
               status must be "ok".
  26. tensor-parallel compute (cell T) — four processes share the card
               over gloo as in phase 24, on the launchers' default
               tensor-parallel runtime (`models.model.layer_tp` /
               `vocab_tp`: attention on heads, the dense FFN on d_ff, the
               embedding and the head on vocab, each rank's kernels on its
               weight slices): (a) phase
               6's full-width qwen1.5-0.5b QAT, 3 steps, on a (2 data, 2
               model) mesh: losses against phase 23's (step 0 within
               1e-3 relative, steps 1-2 within 5 %), the gradient norm of
               steps 0-1 (gap printed, held to 1e-2), every rank's
               kernel 1 and 5 launches equal to the formula on the
               slices' shapes, s/step, peak memory and collective bytes a
               rank beside phase 24's, a step's beside the 4.40 GiB a
               rank moved with the f32 logits gather; the MCKD loss on each rank's
               logit columns: no all-gather of (rows, padded vocab) f32,
               the bytes under "loss" rows x 3 f32 x 4 B a step,
               rank 0's last step traced by torch.profiler (the spans of
               its kernels and copies on the card, the host's seconds
               inside `spmd.collect`); (b) full-width granite-8b cut to 2
               layers (phase 24's; w4a4, int8 KV, 4 slots, 8 x 128 prompt
               + 32 new tokens where phases 24 and 27 stop at 8: `TP_NEW`,
               one-chunk prefill) on a (1, 4) mesh, heads, d_ff and vocab split
               four ways, the KV sequence too (64 rows a rank, one whole
               key split of kernel 9): the logits of the prefill and 4
               teacher-forced decode steps against the one-process model
               on the card, and both against the one-process model on the
               CPU at the same inputs (the bf16 model-logits bar of
               tests/test_fused_qat_matmul.py printed; held to phase 4's
               bar for two summation orders: 90th percentile |dlogit|
               <= 2**-7 max|logit|, argmax equal at all positions but one
               and wherever decided beyond the gap, and the largest
               |dlogit| within 4 x the one-process model's own
               card-vs-CPU gap), 8 / 8 streams equal the
               tensor-parallel greedy_generate and equal on every rank,
               the first token where a stream leaves the one-process
               stream (printed), kernels 7-9 launched on every rank,
               decode tok/s a rank beside phase 24's; (c) kernel 8's
               rows M-independent at the slices (4, 4096, 3584) and
               (4, 3584, 4096), kernels 1 and 5 against their plain
               versions at the column slice (4096, 1024, 1408) and the
               row slice (4096, 1408, 1024); (d) in the four ranks, the
               vocab-parallel hard CE, MCKD's sparse soft-CE (K 16) and
               teacher soft-CE (temperature 2) on each rank's quarter of
               seeded f32 logits at (a)'s shape, 2,048 x 152,064 (the
               four ranks as one (1, 4) group): each loss within 1e-6
               relative of the same function on the whole logits and the
               same bits on every rank, each rank's gradient columns
               within 1e-6 of max|g|, the "loss" bytes 2,048 x (3, 3, 6)
               x 4 B.
  27. expert-parallel MoE (cell U) — the four processes share the card
               over gloo, on the launchers' default
               runtime, each MoE FFN's experts split over the model ranks
               (`TPSplit.experts`: the capacity buffer cut to the rank's
               experts, the output buffer all-gathered before the
               combine): (a) phase 8's granite-moe QAT (w3a3, OBR 0.1,
               oscillation tracked, MCKD, 8 x 512, 3 steps) cut to
               EP_TRAIN_LAYERS layers on a (2 data, 2 model) mesh, 16
               experts a rank, the data ranks routing the global batch
               (`models.moe`: the batch's one dispatch group, its
               capacity, the batch's Switch loss), against one process of
               the same run at the same configuration made just before
               the ranks start: step 0's loss and lb_loss within 1e-3
               relative, steps 1-2 within 5 %, the gradient norm of steps
               0-1 within 1e-2 (phase 26's bars), step 0's drop_frac
               beside the one process's (printed), every rank's QAT
               launches equal to `qat_launches_per_step` on its experts
               (`tp_parts=2`) at the capacity buffers' rows it reported
               (`models.moe.buffer_rows`), s/step, peak, collective bytes
               by kind and by use (`spmd.moved_bytes_by_use`: the expert
               compute's, OBR's, the oscillation tracker's and the
               loss's, held as phase 26's: no logits gathered), the
               expert collectives' bytes held to the reported buffers'
               bytes and the routing counts' gathers
               (`expert_buffer_bytes`) plus at most 1 MiB of f32
               scalars, OBR's and the tracker's to the leaves' sums
               (`obr_osc_stats_bytes`: Eq. 10 and the oscillation
               fraction taken on the rank's slices, no leaf or EMA
               gathered; under 1 MiB a step), each rank's peak and the
               four peaks' sum against the card's memory, and loss_obr
               and osc_frac a step beside the one process's; (b)
               granite-moe's serving
               (phase 12's w3a3, int8 KV, 4 slots, 8 x 128 + 4,
               one-chunk prefill) cut to 2 layers on a (1, 4) mesh, 8
               experts a rank, heads and vocab split: 8 / 8 streams equal
               the expert-parallel single-request greedy_generate on every
               rank, the logits of the prefill and 4 teacher-forced decode
               steps against the one-process model on the card and on the
               CPU under phase 26's two-orders bar, kernels 8-9 launched,
               decode tok/s a rank; (c) one full-width MoE layer (seeded,
               w3a3, 8 x 512 tokens) with its 32 experts over the 4 ranks
               (sliced by the sharding rules, `_expert_slice`)
               against the whole layer in this process: the output, the
               input's gradient, the expert weights' and the router's
               gradients bit-equal, every scale's gradient within 1e-5
               relative (sums over the ranks, and a per-expert scale's
               column sum, whose reduction plan follows the experts in the
               call); the same layer in serving form (the 8-row bmm
               fallback) bit-equal at 4 and 128 tokens; then kernels 2 and
               6 at mixtral-8x7b's d_ff slice on 16 ranks, (8, 1280, 4096,
               896) and (8, 1280, 896, 4096), and at this cell's 16
               experts a rank, (16, 640, 1024, 512) and (16, 640, 512,
               1024), against their plain versions under phase 5's bars;
               (e) (c)'s layer (drop_frac 0.1614) with its 8 x 512 rows
               over the 4 ranks as data ranks (a (4, 1) mesh, 2 rows a
               rank, `moe_ffn(dp=...)`) against the whole layer here:
               each rank's keep mask equal to the whole layer's on its
               tokens, the output bit-equal on its rows, lb_loss (the
               ranks' mean) within 1e-6 relative, drop_frac equal, the
               input's gradient within 1e-6 of max|dx| and every leaf's
               gradient, summed over the ranks, within 1e-5 (EP_SCALE_BAR)
               of |the whole's| + the sum of |the ranks' parts|, element by
               element, the expert weights' and weight scales' within 2^-7
               (DP_BF16_BAR: each rank's dW is a bf16 product), for loss
               sum(y * dy) + lb_loss; it prints
               the pairs that routing each rank's own rows would have
               routed otherwise (> 0, or the check shows nothing).
  Phase 2 also holds kernels 7-9 at recurrentgemma-9b's and xlstm-350m's
  serving shapes (the attention at D 256 with one kv head, q_per_kv 16,
  C 1 and 32; int_matmul at N = 4), and phase 5 kernels 1 and 5 at
  xlstm-350m's mq (4096, 2048, 2048) and its N = 4 gate (4096, 2048, 4).
  NaN and Inf pass through every quantizer as in the reference's kernels:
  phase 2 runs int_matmul and int4_matmul with a NaN column scale, phase 5
  quant_matmul, quant_matmul_bwd (one plane and three) and
  quant_matmul_batched at (4096, 1024, 2816) with NaN in 3 weights and 3
  activations, ±Inf in one activation each and a NaN column scale (on
  power-of-two grids, so the sums are exact), phase 10 fake_quant_2d /
  fake_quant_rows with NaN / ±Inf in x and NaN scales and bin_stats_2d
  with non-finite weights: NaN where the plain version has it, bit-equal
  elsewhere (bin_stats: counts equal, NaN / Inf positions equal).
Then one JSON line with every kernel's numbers, the card's name and power
limit (nvidia-smi), and last `{"ok": true, "device": {...}}`.

Phases 2, 5 and 10 each draw their random inputs from a generator of their
own, seeded with 100 x SEED + the phase's number, so that rows added to one
phase leave the others' inputs as they were.

Needs one CUDA card and nvcc (CUDA_HOME or /usr/local/cuda). Imports
nothing of JAX.
"""
from __future__ import annotations

import copy
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
try:  # the H100 SXM data sheet's rates, from the port's roofline
    from repro_torch.launch.roofline import (F32_FLOPS as F32_OPS_PER_S,
                                             HBM_BW as HBM_BYTES_PER_S,
                                             PEAK_FLOPS as BF16_OPS_PER_S)
except ImportError:  # not a checkout: main() says so and exits
    F32_OPS_PER_S = HBM_BYTES_PER_S = BF16_OPS_PER_S = None
NEG_INF = -2.0e9
SEED = 0


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

class Timer:
    """Median of single-launch CUDA-event times (`kernel_bench.device_ms`).
    Before each launch a 2 GB buffer is read (not written: dirty lines
    would be written back during the timed launch): it evicts the 50 MB
    L2, so every launch finds its inputs in HBM as the serving path does
    (each weight is read once a step), and it keeps the device busy for
    ~0.7 ms while the host enqueues the timed call, so the events time the
    device's work and not the Python in front of the launch."""

    def __init__(self, torch, iters: int = 15):
        from repro_torch.launch.kernel_bench import Flush, device_ms
        self.device = torch.device("cuda")
        self.flush = Flush(self.device)
        self.iters = iters
        self._device_ms = device_ms

    def ms(self, fn) -> float:
        return self._device_ms(fn, self.device, self.flush, self.iters)


def bound(nbytes: float, ops: float, ops_per_s: float = None) -> tuple[float, str]:
    ops_per_s = ops_per_s or BF16_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _same_bits(torch, a, b) -> bool:
    view = torch.int32 if a.dtype == torch.float32 else torch.int16
    return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))


def device_kernels(torch, fn, windows: int = 3, calls: int = 3) -> list:
    """The port's device kernels (its CUDA sources' anonymous namespace) that
    fn launches, by name and template arguments, as torch.profiler reads
    them: the union over a few windows of a few calls each, since a short
    window on the card now and then comes back without some of its kernels."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    names = set()
    for _ in range(windows):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names |= {re.sub(r"^.*?\(anonymous namespace\)::", "", e.key).split("(")[0]
                  for e in prof.key_averages() if "(anonymous namespace)::" in e.key}
    return sorted(names)


def _int_operands(torch, packed: bool, m: int, k: int, n: int, gen):
    dev = "cuda"
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    lim = 8 if packed else 128
    codes = torch.randint(-lim, lim, (k, n), generator=gen, device=dev,
                          dtype=torch.int32).to(torch.int8)
    scale = torch.rand((n,), generator=gen, device=dev) * 0.02 + 1e-3
    if packed:
        from repro_torch.core.quantizer import pack_int4
        return x, codes, pack_int4(codes, 0), scale
    return x, codes, codes, scale


def check_matmul(torch, timer, qmm, ref, packed: bool, m: int, k: int, n: int,
                 gen) -> dict:
    x, codes, w, scale = _int_operands(torch, packed, m, k, n, gen)
    if packed:
        kern = lambda: qmm.int4_matmul(x, w, scale)
        plain = lambda: ref.int4_matmul(x, w, scale)
    else:
        kern = lambda: qmm.int_matmul(x, w, scale)
        plain = lambda: ref.int_matmul(x, w, scale)
    y_k = kern()
    y_k2 = kern()
    y_r = plain()
    torch.cuda.synchronize()
    err = (y_k - y_r).abs().max().item()
    repeat = _same_bits(torch, y_k, y_k2)
    # only the f32 summation order differs (up to 14336 terms)
    tol = 1e-5 * y_r.abs().max().item()
    wd = (codes.float() * scale).to(torch.bfloat16)
    lib = lambda: torch.matmul(x, wd)
    nbytes = m * k * 2 + w.numel() + n * 4 + m * n * 4
    b_ms, b_by = bound(nbytes, 2.0 * m * k * n)
    row = {"shape": [m, k, n], "max_abs_err": err, "tol": tol, "repeat": repeat,
           "ms": timer.ms(kern), "plain_ms": timer.ms(plain),
           "library_ms": timer.ms(lib), "bound_ms": b_ms, "bound_by": b_by}
    name = "int4_matmul" if packed else "int_matmul"
    # both kernels cut the contraction by int4_plan; int_matmul's blocks
    # are 128 columns wide at decode and 64 at prefill
    pl = dict(qmm.int4_plan(k, n), token_tiles=qmm.int4_token_tiles(m))
    tiles = pl["col_tiles"] if packed else qmm.int8_col_tiles(m, n)
    pl["block_cols"] = qmm.INT4_COLS if packed else qmm.INT8_COLS[int(m > 8)]
    pl["blocks"] = tiles * pl["splits"] * pl["token_tiles"][1]
    row["plan"] = pl
    row["device_kernels"] = device_kernels(torch, kern)
    plan = (f" [plan: {pl['splits']} splits x {pl['ksteps_per_split']} steps, "
            f"{pl['blocks']} blocks of {pl['block_cols']} columns; "
            f"{', '.join(row['device_kernels'])}]")
    log(f"  {name} M={m} K={k} N={n}{plan}: max|err| {err:.3e} (tol {tol:.3e}), "
        f"repeat {'ok' if repeat else 'DIFFERS'}; "
        f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
        f"torch.matmul(bf16 dequant) {row['library_ms']:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by})")
    if not err <= tol:
        fail(f"{name} {m}x{k}x{n} disagrees with its plain version: {err} > {tol}")
    if not repeat:
        fail(f"{name} {m}x{k}x{n}: a second launch gave other bits")
    return row


def check_m_independence(torch, qmm, k: int, n: int, gen, packed: bool = True) -> dict:
    """int4_matmul's (or int_matmul's) rows at M 1, 4 and 32 bit-equal where
    they overlap: the plan, hence each element's sum order, depends on
    (K, N) alone (not on the block width or the token tiles)."""
    x, _, w, scale = _int_operands(torch, packed, 32, k, n, gen)
    kern = qmm.int4_matmul if packed else qmm.int_matmul
    name = kern.__name__
    ys = {m: kern(x[:m], w, scale) for m in (1, 4, 32)}
    torch.cuda.synchronize()
    ok = all(_same_bits(torch, ys[m], ys[32][:m]) for m in (1, 4))
    log(f"  {name} K={k} N={n}: rows at M 1, 4, 32 bit-equal: {ok}")
    if not ok:
        fail(f"{name} {k}x{n}: a row's bits depend on M")
    return {"shape": [k, n], "m": [1, 4, 32], "equal": ok}


def check_attention(torch, timer, da, ref, *, storage: str, c: int, window: int,
                    softcap: float, gen, qdtype=None, b=4, t=160, hkv=8,
                    q_per_kv=4, d=128) -> dict:
    dev = "cuda"
    qdtype = qdtype or torch.bfloat16
    h = hkv * q_per_kv
    q = torch.randn((b, c, h, d), generator=gen, device=dev).to(qdtype)
    k = torch.randn((b, t, hkv, d), generator=gen, device=dev)
    v = torch.randn((b, t, hkv, d), generator=gen, device=dev)
    pos = torch.full((b, t), -1, dtype=torch.int32, device=dev)
    pos[0, :100] = torch.arange(100, device=dev)
    pos[1, :] = torch.arange(t, device=dev)
    pos[2, :40] = torch.arange(40, device=dev)          # slot 3 stays idle
    last = torch.tensor([99, t - 1, 39, -1], device=dev)
    q_pos = (last[:, None] - c + 1 + torch.arange(c, device=dev)).to(torch.int32)
    q_pos[3] = -1
    if storage == "fp":
        ks_ = vs_ = None
        k_st, v_st = k.to(qdtype), v.to(qdtype)
    else:
        from repro_torch.core.quantizer import QuantSpec, pack_int4
        from repro_torch.models.attention import _quantize_kv
        spec = QuantSpec(bits=8 if storage == "int8" else 4)
        k_st, ks_ = _quantize_kv(k, spec)
        v_st, vs_ = _quantize_kv(v, spec)
        if storage == "int4":
            k_st, v_st = pack_int4(k_st, -1), pack_int4(v_st, -1)
    args = (q, k_st, v_st, ks_, vs_, pos, q_pos)
    kw = dict(q_per_kv=q_per_kv, window=window, softcap=softcap)
    kern = lambda: da.pooled_decode_attention(*args, **kw)
    plain = lambda: ref.pooled_decode_attention(*args, **kw)
    acc_k, m_k, l_k = kern()
    again = kern()
    acc_r, m_r, l_r = plain()
    torch.cuda.synchronize()
    repeat = all(_same_bits(torch, u, w) for u, w in zip((acc_k, m_k, l_k), again))
    live = m_r > NEG_INF / 2
    o_k = (acc_k / l_k[..., None])[live]
    o_r = (acc_r / l_r[..., None])[live]
    err = (o_k - o_r).abs().max().item()
    if qdtype == torch.float32:
        tol = 1e-5  # only the f32 summation order differs
    else:
        # P is rounded to bf16 after an f32 exp of dots summed in another
        # order, so a P at a rounding boundary lands one bf16 ulp apart
        tol = 2.0 ** -7 * o_r.abs().max().item()
    m_err = (m_k[live] - m_r[live]).abs().max().item()
    dead_ok = bool((m_k[~live] == NEG_INF).all() and (l_k[~live] > 0).all()
                   and torch.isfinite(acc_k).all() and torch.isfinite(l_k).all())
    kd, vd = (ref.dequant_kv(s, sc, d, qdtype) for s, sc in
              ((k_st, ks_), (v_st, vs_)))
    # yardstick: SDPA on the dequantized cache, GQA expanded, same masks
    qh = (q.float() * d ** -0.5).to(qdtype).transpose(1, 2)
    kh = kd.repeat_interleave(q_per_kv, 2).transpose(1, 2)
    vh = vd.repeat_interleave(q_per_kv, 2).transpose(1, 2)
    valid = (pos[:, None, :] >= 0) & (pos[:, None, :] <= q_pos[:, :, None])
    if window > 0:
        valid &= pos[:, None, :] > q_pos[:, :, None] - window
    mask = valid[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = lambda: sdpa(qh, kh, vh, attn_mask=mask, scale=1.0)
    esz = 2 if qdtype == torch.bfloat16 else 4
    kv_bytes = 2 * k_st.numel() * k_st.element_size()
    sc_bytes = 0 if ks_ is None else 2 * ks_.numel() * 4
    nbytes = (q.numel() * esz + kv_bytes + sc_bytes + pos.numel() * 4
              + q_pos.numel() * 4 + acc_k.numel() * 4 + 2 * m_k.numel() * 4)
    b_ms, b_by = bound(nbytes, 4.0 * b * c * h * t * d)
    row = {"shape": {"B": b, "C": c, "H": h, "Hkv": hkv, "T": t, "D": d,
                     "storage": storage, "window": window, "softcap": softcap,
                     "q": str(qdtype).replace("torch.", "")},
           "plan": da.decode_plan(t, c * q_per_kv, qdtype == torch.bfloat16),
           "repeat": repeat, "max_abs_err": err, "tol": tol, "ms": timer.ms(kern),
           "plain_ms": timer.ms(plain), "library_ms": timer.ms(lib),
           "bound_ms": b_ms, "bound_by": b_by}
    log(f"  pooled_decode_attention {storage} q={row['shape']['q']} C={c} "
        f"T={t} window={window} softcap={softcap}: max|err| {err:.3e} "
        f"(tol {tol:.3e}), max|dm| {m_err:.2e}, masked rows ok {dead_ok}, "
        f"repeat {'ok' if repeat else 'DIFFERS'} [plan: {row['plan']['splits']} "
        f"splits x {da.KV_SPLIT} keys, {row['plan']['row_tiles']} x "
        f"{row['plan']['rows']} rows]; "
        f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
        f"sdpa(dequant) {row['library_ms']:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
    if not err <= tol:
        fail(f"decode attention {storage} C={c} disagrees: {err} > {tol}")
    if not m_err <= 1e-4 * max(1.0, m_r[live].abs().max().item()):
        fail(f"decode attention {storage} C={c}: running max differs by {m_err}")
    if not dead_ok:
        fail(f"decode attention {storage} C={c}: fully masked rows not finite "
             "with m = NEG_INF, l > 0")
    if not repeat:
        fail(f"decode attention {storage} C={c}: a second launch gave other bits")
    return row


def check_slot_independence(torch, da, *, storage: str, c: int, gen, qdtype=None,
                            hkv=8, q_per_kv=4, d=128) -> dict:
    """A slot's triple is the same bits in a pool of 4 slots, alone (B 1),
    and with the pool's T of 160 grown to 256 by idle rows (pos -1, random
    codes): the key splits sit at fixed keys and a wholly masked split adds
    nothing."""
    dev = "cuda"
    qdtype = qdtype or torch.bfloat16
    b, t, t_big = 4, 160, 256
    q = torch.randn((b, c, hkv * q_per_kv, d), generator=gen, device=dev).to(qdtype)
    kv = torch.randn((2, b, t_big, hkv, d), generator=gen, device=dev)
    if storage == "fp":
        stores, scales = [kv[0].to(qdtype), kv[1].to(qdtype)], [None, None]
    else:
        from repro_torch.core.quantizer import QuantSpec, pack_int4
        from repro_torch.models.attention import _quantize_kv
        spec = QuantSpec(bits=8 if storage == "int8" else 4)
        stores, scales = zip(*(_quantize_kv(kv[i], spec) for i in range(2)))
        if storage == "int4":
            stores = [pack_int4(st, -1) for st in stores]
    pos = torch.full((b, t_big), -1, dtype=torch.int32, device=dev)
    pos[:, :t] = torch.arange(t, device=dev)
    pos[0, 100:t] = -1
    q_pos = (t - c + torch.arange(c, device=dev, dtype=torch.int32))[None].repeat(b, 1)
    kw = dict(q_per_kv=q_per_kv, window=0, softcap=0.0)

    def run(rows, tt):
        sl = lambda x: None if x is None else x[rows, :tt].contiguous()
        return da.pooled_decode_attention(q[rows], sl(stores[0]), sl(stores[1]),
                                          sl(scales[0]), sl(scales[1]),
                                          pos[rows, :tt].contiguous(), q_pos[rows], **kw)

    pool, alone, grown = run(slice(0, 4), t), run(slice(1, 2), t), run(slice(1, 2), t_big)
    torch.cuda.synchronize()
    b_ok = all(_same_bits(torch, u[1:2], w) for u, w in zip(pool, alone))
    t_ok = all(_same_bits(torch, u, w) for u, w in zip(alone, grown))
    name = f"{storage} q={str(qdtype).replace('torch.', '')} C={c}"
    log(f"  pooled_decode_attention {name}: slot 1 in a pool of 4 == alone: {b_ok}; "
        f"alone at T {t} == at T {t_big} (idle rows): {t_ok}")
    if not (b_ok and t_ok):
        fail(f"decode attention {name}: a slot's bits depend on the pool")
    return {"storage": storage, "C": c, "q": str(qdtype).replace("torch.", ""),
            "pool_eq_alone": b_ok, "t_eq_grown": t_ok}


# (M, K, N) rows of phase 2 (`chip_compare.py` runs the same ones):
# int4_matmul at granite-8b's w4a4 linears at decode and prefill; int_matmul
# at its head at decode and prefill, then the w8a8 model's other N-side
# linears at decode (w_gate / w_in, w_out, wq, wk / wv)
INT4_ROWS = ((4, 4096, 14336), (4, 14336, 4096), (4, 4096, 4096), (4, 4096, 1024),
             (32, 4096, 14336), (32, 14336, 4096))
INT8_ROWS = ((4, 4096, 49152), (32, 4096, 49152), (4, 4096, 14336), (4, 14336, 4096),
             (4, 4096, 4096), (4, 4096, 1024))


def serving_kernel_rows(torch, timer, qmm, da, ref, gen) -> dict:
    """Phase 2: the serving kernels against their plain versions at
    granite-8b's shapes, each run twice for identical bits; int4_matmul's
    and int_matmul's M-independence and the attention's B- and
    T-independence."""
    rows = {"int4_matmul": [], "int_matmul": [], "pooled_decode_attention": []}
    for m, k, n in INT4_ROWS:
        rows["int4_matmul"].append(check_matmul(torch, timer, qmm, ref, True,
                                                m, k, n, gen))
    for m, k, n in INT8_ROWS:
        rows["int_matmul"].append(check_matmul(torch, timer, qmm, ref, False,
                                               m, k, n, gen))
    for storage, c, window, softcap, qd in (
            ("int8", 1, 0, 0.0, None), ("fp", 1, 0, 0.0, None),
            ("int4", 1, 0, 0.0, None), ("int8", 32, 0, 0.0, None),
            ("int8", 1, 64, 50.0, None), ("int4", 32, 64, 50.0, None),
            ("fp", 32, 0, 50.0, None), ("int8", 1, 0, 0.0, torch.float32),
            ("int4", 32, 64, 50.0, torch.float32)):
        rows["pooled_decode_attention"].append(check_attention(
            torch, timer, da, ref, storage=storage, c=c, window=window,
            softcap=softcap, gen=gen, qdtype=qd))
    indep = {"int4_matmul": [check_m_independence(torch, qmm, k, n, gen) for k, n in
                             ((4096, 14336), (14336, 4096), (4096, 1024))],
             "int_matmul": [check_m_independence(torch, qmm, k, n, gen, packed=False)
                            for k, n in ((4096, 49152), (4096, 14336))],
             "pooled_decode_attention": [
                 check_slot_independence(torch, da, storage=st, c=c, gen=gen, qdtype=qd)
                 for st, c, qd in (("int8", 1, None), ("int8", 32, None), ("int4", 1, None),
                                   ("fp", 32, None), ("int8", 1, torch.float32))]}
    return {"rows": rows, "independence": indep}


# musicgen-medium's serving shapes (phase 13's path, run in phase 2 after
# granite-8b's rows): int4_matmul at its w4a4 N-side linears (wq / wk / wv,
# w_in, w_out) at decode and prefill, int_matmul at its untied 8-bit head,
# the attention at D 64 over 24 kv heads (q_per_kv 1) with int8 KV
MUSICGEN_INT4_ROWS = ((4, 1536, 1536), (4, 1536, 6144), (4, 6144, 1536),
                      (32, 1536, 6144), (32, 6144, 1536))
MUSICGEN_INT8_ROWS = ((4, 1536, 2048), (32, 1536, 2048))


def musicgen_kernel_rows(torch, timer, qmm, da, ref, gen, rows: dict) -> None:
    """Kernels 7-9 against their plain versions at musicgen-medium's
    serving shapes, appended to phase 2's rows."""
    for m, k, n in MUSICGEN_INT4_ROWS:
        rows["int4_matmul"].append(check_matmul(torch, timer, qmm, ref, True,
                                                m, k, n, gen))
    for m, k, n in MUSICGEN_INT8_ROWS:
        rows["int_matmul"].append(check_matmul(torch, timer, qmm, ref, False,
                                               m, k, n, gen))
    for c in (1, 32):
        rows["pooled_decode_attention"].append(check_attention(
            torch, timer, da, ref, storage="int8", c=c, window=0, softcap=0.0,
            gen=gen, hkv=24, q_per_kv=1, d=64))


# the recurrent families' serving shapes (phases 17-18's paths, run in phase
# 2 after musicgen-medium's rows): int4_matmul at recurrentgemma-9b's gated
# FFN (its RG-LRU's 4096 x 4096 linears are granite-8b's wq row) and at
# xlstm-350m's m_up / mq / m_down; int_matmul at xlstm-350m's 8-bit gates
# (m_i / m_f, N = 4 heads, at decode and a 1024-token prefill; s_i / s_f /
# s_o); the attention at recurrentgemma-9b's local layers: D 256, MQA (one
# kv head, q_per_kv 16), window 2048, int8 KV
RECURRENT_INT4_ROWS = ((4, 4096, 12288), (4, 12288, 4096), (4, 1024, 2048),
                       (4, 2048, 2048), (4, 2048, 1024))
RECURRENT_INT8_ROWS = ((4, 2048, 4), (1024, 2048, 4), (4, 1024, 1024))


def recurrent_kernel_rows(torch, timer, qmm, da, ref, gen, rows: dict) -> None:
    """Kernels 7-9 against their plain versions at recurrentgemma-9b's and
    xlstm-350m's serving shapes, appended to phase 2's rows."""
    for m, k, n in RECURRENT_INT4_ROWS:
        rows["int4_matmul"].append(check_matmul(torch, timer, qmm, ref, True,
                                                m, k, n, gen))
    for m, k, n in RECURRENT_INT8_ROWS:
        rows["int_matmul"].append(check_matmul(torch, timer, qmm, ref, False,
                                               m, k, n, gen))
    for c in (1, 32):
        rows["pooled_decode_attention"].append(check_attention(
            torch, timer, da, ref, storage="int8", c=c, window=2048, softcap=0.0,
            gen=gen, hkv=1, q_per_kv=16, d=256))


# ---------------------------------------------------------------------------
# phases 3-4: the serving path
# ---------------------------------------------------------------------------

def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def check_against_cpu(torch, M, run, qcfg, n_tok: int = 16) -> None:
    """The same params and prompt through the port on the CPU, where every
    kernel wrapper takes its plain version: the reference for the card's
    logits. The two sum in other orders, so isolated bf16 activations land
    one ulp apart and spread. With an fp KV cache that is all: 90th
    percentile |dlogit| <= 2**-7 * max|logit|, max |dp| < 0.02, argmax equal
    at >= 15 of 16 positions. A quantized KV cache turns such an ulp, where
    it crosses a rounding boundary, into a whole code step (amax/7 of the
    head at 4 bits), so there the bar is on what the model decides: max |dp|
    < 0.02 and equal argmax at every position whose top-2 gap in the
    reference exceeds twice that position's largest |dlogit|."""
    prompt = torch.from_numpy(run.prompts[:1, :n_tok])
    pos = torch.arange(n_tok, dtype=torch.int32)[None]
    out = {}
    for dev, params in ((run.device, run.params), ("cpu", _to(run.params, "cpu"))):
        cache = M.init_cache(run.cfg, qcfg, 1, n_tok, dev)
        lg, _ = M.prefill_step(params, cache, {"tokens": prompt.to(dev),
                                               "pos": pos.to(dev)},
                               run.cfg, qcfg)
        out[str(dev)] = lg[0, :, :run.cfg.vocab_size].float().cpu()
    a, b = out[str(run.device)], out["cpu"]
    if not (torch.isfinite(a).all() and a.shape == (n_tok, run.cfg.vocab_size)):
        fail("card logits not finite / wrong shape")
    d = (a - b).abs()
    q90 = torch.quantile(d.flatten(), 0.9).item()
    dp = (torch.softmax(a, -1) - torch.softmax(b, -1)).abs().max().item()
    same = a.argmax(-1) == b.argmax(-1)
    top2 = torch.topk(b, 2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > 2 * d.max(-1).values
    scale = b.abs().max().item()
    kv = f"int{qcfg.kv_cache_bits}" if qcfg.kv_cache_bits else "fp"
    log(f"  card vs CPU plain versions, {kv} KV, "
        f"{n_tok}-token prefill: max|dlogit| {d.max().item():.3e}, q90 "
        f"{q90:.3e} (max|logit| {scale:.2f}), max|dp| {dp:.3e}, argmax equal "
        f"{int(same.sum())}/{n_tok} ({int(decided.sum())} decided beyond "
        f"the difference, all equal: {bool(same[decided].all())})")
    if qcfg.kv_cache_bits:
        ok = dp < 0.02 and bool(same[decided].all())
    else:
        ok = q90 <= 2 ** -7 * scale and dp < 0.02 and int(same.sum()) >= n_tok - 1
    if not ok:
        fail("card logits depart from the CPU reference")


def _first_difference(a: list, b: list):
    return next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)


def check_stream_contract(torch, M, serve, run, new_tokens: int, chunk: int):
    """The engine's determinism contract: each request's stream equals its
    own single-request greedy_generate stream. greedy_generate prefills the
    whole prompt in one call and decodes one row; the engine prefills in
    chunks and decodes the pooled slots together. On the kernel route the
    chunking itself changes rounding (the flash-decode kernel rounds P to
    bf16 against each partial's running max, as the TPU kernel does, and
    the merge rescales it), so the contract is held with the engine's chunk
    equal to the prompt length, decoding in a pool of 4 slots; the main
    run's chunked streams are compared and reported. Printed beside it: how
    far a 4-row step's logits are from the same rows run one at a time."""
    from repro_torch.serve import (ModelExecutor, SamplingParams, Scheduler,
                                   ServeEngine)
    cfg, qcfg, params, dev = run.cfg, run.qcfg, run.params, run.device
    plen = run.prompts.shape[1]
    max_len = plen + new_tokens
    step = lambda p, c, b: M.prefill_step(p, c, b, cfg, qcfg)
    rids = (0, len(run.prompts) - 1)
    refs = {}
    for rid in rids:
        cache = M.init_cache(cfg, qcfg, 1, max_len, dev)
        prompt = torch.from_numpy(run.prompts[rid:rid + 1]).to(dev)
        toks, _ = serve.greedy_generate(step, params, cache, prompt, new_tokens)
        refs[rid] = toks[0].tolist()
        got = run.engine.results[f"req-{rid}"].tokens
        log(f"  req-{rid}: chunk-{chunk} engine stream == greedy_generate "
            f"stream: {got == refs[rid]} (first difference at token "
            f"{_first_difference(got, refs[rid])})")

    # rows batched vs one at a time, same inputs: prefill, then one decode
    prompts = torch.from_numpy(run.prompts[:4]).to(dev)
    pos = torch.arange(plen, dtype=torch.int32, device=dev)[None].expand(4, -1)
    pool = M.init_cache(cfg, qcfg, 4, max_len, dev)
    lg4, _ = step(params, pool, {"tokens": prompts, "pos": pos})
    nxt = torch.argmax(lg4[:, -1], -1)[:, None].to(torch.int32)
    dpos = torch.full((4, 1), plen, dtype=torch.int32, device=dev)
    dl4, _ = step(params, pool, {"tokens": nxt, "pos": dpos})
    gaps = []
    for r in range(4):
        single = M.init_cache(cfg, qcfg, 1, max_len, dev)
        lg1, _ = step(params, single, {"tokens": prompts[r:r + 1], "pos": pos[:1]})
        dl1, _ = step(params, single, {"tokens": nxt[r:r + 1], "pos": dpos[:1]})
        gaps.append(((lg4[r, -1] - lg1[0, -1]).abs().max().item(),
                     (dl4[r, 0] - dl1[0, 0]).abs().max().item()))
    log(f"  4 rows together vs one at a time: max|dlogit| prefill "
        f"{max(g[0] for g in gaps):.3e}, decode {max(g[1] for g in gaps):.3e}")

    ex = ModelExecutor(params, cfg, qcfg, n_slots=4, max_len=max_len, chunk=plen)
    eng = ServeEngine(ex, Scheduler(max_len=max_len))
    for rid in rids:
        ok, reason = eng.submit(run.prompts[rid],
                                SamplingParams(max_new_tokens=new_tokens),
                                rid=f"r{rid}")
        if not ok:
            fail(f"engine refused req-{rid}: {reason}")
    eng.run_until_idle()
    for rid in rids:
        got = eng.results[f"r{rid}"].tokens
        first = _first_difference(got, refs[rid])
        log(f"  req-{rid}: chunk-{plen} engine stream (4-slot pool) == "
            f"greedy_generate stream: {first is None}")
        if first is not None:
            fail(f"req-{rid} engine stream departs from greedy_generate at "
                 f"token {first}: {got} vs {refs[rid]}")


def serve_phase(torch, ops, serve, M, argv: list, path_kernels: tuple,
                check_streams: bool, cpu_reference: bool, extra=None) -> dict:
    """Serve through the CLI with the launch counts set to 0 just before and
    read just after; then the stream contract, the CPU reference and
    `extra(run)` (its dict under "extra") as asked."""
    log(f"serve: python -m repro_torch.launch.serve {' '.join(argv)}")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    run = serve.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    tp = run.summary["throughput"]
    log(f"  wall {wall:.1f} s (params built on the card included); prefill "
        f"{tp['prefill_tok_s']:.1f} tok/s, decode {tp['decode_tok_s']:.1f} "
        f"tok/s, peak {(run.peak_bytes or 0) / 2**30:.2f} GiB; launches {counts}")
    for name in path_kernels:
        if counts[name] <= 0:
            fail(f"{name} was never launched on the main path: {counts}")
    faults = {k: v for k, v in run.summary["faults"].items() if v}
    if faults:
        fail(f"serving faults: {faults}")
    n_req = len(run.prompts)
    new_tokens = int(argv[argv.index("--new-tokens") + 1])
    for i in range(n_req):
        res = run.engine.results[f"req-{i}"]
        if res.finish_reason != "length" or len(res.tokens) != new_tokens:
            fail(f"req-{i}: {res.finish_reason}, {len(res.tokens)} tokens")
        if not all(0 <= t < run.cfg.vocab_size for t in res.tokens):
            fail(f"req-{i}: token out of vocabulary: {res.tokens}")

    if check_streams:
        chunk = int(argv[argv.index("--chunk") + 1])
        check_stream_contract(torch, M, serve, run, new_tokens, chunk)

    if cpu_reference:  # the run's own KV cache, and an fp one
        check_against_cpu(torch, M, run, run.qcfg)
        check_against_cpu(torch, M, run, run.qcfg.replace(kv_cache_bits=0))
    return {"counts": counts, "summary": run.summary, "peak": run.peak_bytes,
            "wall": wall, "extra": extra(run) if extra else None, "argv": argv,
            "streams": {k: v.tokens for k, v in run.engine.results.items()}}


# ---------------------------------------------------------------------------
# phases 23-24: sharding (cells R and S)
# ---------------------------------------------------------------------------

SHARDED_TRAIN = ["--arch", "qwen1.5-0.5b", "--quant", "w4a4", "--kd", "mckd",
                 "--batch", "8", "--seq", "512", "--steps", "3",
                 "--save-every", str(10 ** 6)]
# cut to 2 layers and 4 new tokens (4 layers and 32, then 8, before it) so
# that phase 27 fits the run's time limit: every call of this gloo serving
# gathers or sums through host memory (phase 24's gathered runtime the whole
# head each decode step: 99.7 s at 2 layers and 32 new tokens, 3.1 tok/s a
# rank; 46 s at 8)
SHARDED_NEW = 4
SHARDED_SERVE = ["--arch", "granite-8b", "--quant", "w4a4", "--kv-bits", "8",
                 "--layers", "2", "--batch", "8", "--slots", "4",
                 "--prompt-len", "128", "--new-tokens", str(SHARDED_NEW),
                 "--chunk", "128"]
# the sharded run's cache rows: 128 + SHARDED_NEW rounded up to M x 64 (launch.serve)
# for M 2 and 4: 128 a model rank on (2, 2) (two whole 64-key splits of
# kernel 9), 64 on (1, 4)
SHARDED_CACHE = 256
# cell S against cell R, relative: step 0's loss to the CPU harness's bar;
# the later losses, which the half batches' bf16 sums move by about 1e-4 on
# the card, to 1e-3; the gradient norm of steps 0 and 1 (the same weights)
# to 1e-4, where the sums leave about 1e-6 and a gradient scaled by a
# factor gives at least its factor less one (see cell_s_phase)
LOSS0_BAR, LOSS_BAR, GNORM_BAR = 1e-6, 1e-3, 1e-4
SHARDED_RANKS = 4


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _torchrun_env(rank: int, world: int, port: int) -> dict:
    return {"WORLD_SIZE": str(world), "RANK": str(rank), "LOCAL_RANK": str(rank),
            "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}


def cell_r_phase(torch, ops, train, serve, cell_c: dict, cell_a: dict) -> dict:
    """Phase 23: a process group of one over NCCL; phase 6's training and
    phase 3's serving through --model-parallel 1."""
    import os
    import shutil
    import torch.distributed as dist
    from repro_torch.configs.registry import get_config
    from repro_torch.core.policy import get_preset
    env = _torchrun_env(0, 1, _free_port())
    os.environ.update(env)
    try:
        cdir = ROOT / "build" / "chip_smoke_cell_r"
        shutil.rmtree(cdir, ignore_errors=True)
        run = train_phase(torch, ops, train, SHARDED_TRAIN + [
            "--ckpt", str(cdir), "--model-parallel", "1"], 0, 3)
        shutil.rmtree(cdir, ignore_errors=True)
        rep = run["report"]
        if rep.mesh is None or rep.mesh.backend != "nccl":
            fail(f"cell R did not run on an NCCL group: {rep.mesh}")
        run.update(cfg=get_config("qwen1.5-0.5b"), qcfg=get_preset("w4a4"))
        per_step = check_launches(run, 3, 8 * 512)
        base = cell_c["report"].losses[:3]
        same = rep.losses == base
        log(f"  cell R (one NCCL rank, --model-parallel 1): losses {rep.losses} vs "
            f"phase 6's {base}: bit-equal {same}; s/step {run['s_step']:.3f} vs "
            f"{cell_c['s_step']:.3f}; state {rep.state_bytes / 2**30:.3f} GiB")
        if not same:
            fail(f"cell R losses {rep.losses} != phase 6's {base}")
        torch.cuda.empty_cache()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        srun = serve.main(cell_a["argv"] + ["--model-parallel", "1"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        streams = {k: v.tokens for k, v in srun.engine.results.items()}
        equal = streams == cell_a["streams"]
        log(f"  cell R serving (phase 3's argv + --model-parallel 1): {wall:.1f} s, "
            f"streams equal phase 3's {equal}; launches {ops.launch_counts()}")
        if not equal:
            fail("cell R serving streams differ from phase 3's")
        del srun
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k in env:
            os.environ.pop(k, None)
        torch.cuda.empty_cache()
    return {"losses": rep.losses, "grad_norms": rep.grad_norms,
            "s_per_step": run["s_step"],
            "tokens_per_s": run["tokens_s"], "launches_per_step": per_step,
            "state_gib": rep.state_bytes / 2**30,
            "peak_gib": (rep.peak_bytes or 0) / 2**30, "serve_wall_s": wall,
            "streams_equal_phase_3": equal}


def sharded_rank(torch, rank: int, out_dir: str) -> None:
    """Phase 24's part of a rank (`cells_rank`): the sharded QAT run, then
    the sharded serving run, both on the gathered runtime (`tp_compute=
    False`: every layer gathered whole); writes its numbers to
    DIR/rank{R}.json."""
    from repro_torch.dist import spmd
    from repro_torch.kernels import ops
    from repro_torch.launch import serve, train
    ckpt_dir = Path(out_dir) / "ckpt"
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    spmd.reset_moved_bytes()
    rep = train.main(SHARDED_TRAIN + ["--ckpt", str(ckpt_dir), "--model-parallel", "2"],
                     tp_compute=False)
    torch.cuda.synchronize()
    res = {"train": {"wall_s": time.perf_counter() - t0, "losses": rep.losses,
                     "moved_bytes": spmd.moved_bytes(),
                     "grad_norms": rep.grad_norms, "healths": rep.healths, "step_seconds": rep.step_seconds,
                     "state_bytes": rep.state_bytes, "peak_bytes": rep.peak_bytes,
                     "launches": ops.launch_counts(), "backend": rep.mesh.backend,
                     "staged": rep.mesh.staged, "coords": rep.mesh.coords}}
    del rep
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    spmd.reset_moved_bytes()
    t0 = time.perf_counter()
    run = serve.main(SHARDED_SERVE + ["--model-parallel", "2"], tp_compute=False)
    torch.cuda.synchronize()
    kv = run.engine.executor.pool["layers"][0]["kv"]
    # the sharded decode's logits on fixed inputs, for the parent to hold
    # against the one-process model's
    forced = torch.tensor([run.engine.results[f"req-{i}"].tokens[:4]
                           for i in range(len(run.prompts))], dtype=torch.int32)
    lg = teacher_forced(torch, run.params, run.cfg, run.qcfg, run.prompts, forced,
                        run.spmd)
    if rank == 0:
        import numpy as np
        np.save(Path(out_dir) / "sharded_logits.npy", lg.cpu().numpy())
    res["serve"] = {"wall_s": time.perf_counter() - t0,
                    "streams": {k: v.tokens for k, v in run.engine.results.items()},
                    "launches": ops.launch_counts(), "kv_rows": int(kv.k.shape[1]),
                    "throughput": run.summary["throughput"],
                    "faults": {k: v for k, v in run.summary["faults"].items() if v},
                    "peak_bytes": run.peak_bytes, "moved_bytes": spmd.moved_bytes(),
                    "param_bytes": sum(t.numel() * t.element_size() for t in
                                       _leaves(run.params))}
    with open(Path(out_dir) / f"rank{rank}.json", "w") as f:
        json.dump(res, f)


def cpu_teacher_forced(torch, params, cfg, qcfg, prompts, forced, spmd) -> tuple:
    """(`teacher_forced` on CPU params without autograd, its seconds)."""
    t0 = time.perf_counter()
    with torch.no_grad():
        lg = teacher_forced(torch, params, cfg, qcfg, prompts, forced, spmd)
    return lg, time.perf_counter() - t0


def teacher_forced(torch, params, cfg, qcfg, prompts, forced, spmd):
    """Logits (B, 1 + F, vocab) f32 of a one-chunk prefill of `prompts`
    (numpy) and F decode steps fed `forced` (B, F), in a cache of the
    serving run's length (sequence-sharded on spmd's mesh)."""
    from repro_torch.models import model as M
    dev = M.params_device(params)
    prompts = torch.from_numpy(prompts).to(dev)
    forced = forced.to(dev)
    b, plen = prompts.shape
    cache = M.init_cache(cfg, qcfg, b, SHARDED_CACHE, dev, spmd=spmd)
    pos = torch.arange(plen, dtype=torch.int32, device=dev)[None].expand(b, plen)
    lg, cache = M.prefill_step(params, cache, {"tokens": prompts, "pos": pos},
                               cfg, qcfg, spmd=spmd)
    outs = [lg[:, -1]]
    for j in range(forced.shape[1]):
        p = torch.full((b,), plen + j, dtype=torch.int32, device=dev)
        lg, cache = M.decode_step(params, cache, {"tokens": forced[:, j:j + 1],
                                                  "pos": p}, cfg, qcfg, spmd=spmd)
        outs.append(lg[:, 0])
    return torch.stack(outs, 1)[..., :cfg.vocab_size].float()


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for c in tree for x in _leaves(c)]
    return [tree] if tree is not None else []


def seq_merge_check(torch, da, gen) -> dict:
    """Kernel 9 over a cache against its halves merged in rank order by
    `attention.merge_partials` (the sequence-sharded decode's merge): at
    128 keys (one 64-key split a half: bit-equal) and at 160 (80 a half)."""
    from repro_torch.models.attention import merge_partials
    out = {}
    for t in (128, 160):
        b, c, hkv, qpk, d = 4, 1, 8, 4, 128
        q = torch.randn((b, c, hkv * qpk, d), generator=gen, device="cuda").to(torch.bfloat16)
        k = torch.randint(-127, 128, (b, t, hkv, d), generator=gen, device="cuda",
                          dtype=torch.int8)
        v = torch.randint(-127, 128, (b, t, hkv, d), generator=gen, device="cuda",
                          dtype=torch.int8)
        ks = torch.rand((b, t, hkv, 1), generator=gen, device="cuda") * 0.02 + 1e-3
        vs = torch.rand((b, t, hkv, 1), generator=gen, device="cuda") * 0.02 + 1e-3
        pos = torch.arange(t, dtype=torch.int32, device="cuda")[None].expand(b, t).contiguous()
        pos[1, t - 9:] = -1  # a slot with idle rows in the second half
        qp = torch.full((b, c), t - 1, dtype=torch.int32, device="cuda")
        kw = dict(q_per_kv=qpk, window=0, softcap=0.0)
        acc, m, l = da.pooled_decode_attention(q, k, v, ks, vs, pos, qp, **kw)
        h = t // 2
        parts = [da.pooled_decode_attention(
            q, k[:, s:s + h].contiguous(), v[:, s:s + h].contiguous(),
            ks[:, s:s + h].contiguous(), vs[:, s:s + h].contiguous(),
            pos[:, s:s + h].contiguous(), qp, **kw) for s in (0, h)]
        acc2, m2, l2 = merge_partials(*(torch.stack([p[i] for p in parts])
                                        for i in range(3)))
        same = bool(torch.equal(acc, acc2) and torch.equal(m, m2) and torch.equal(l, l2))
        gap = float(((acc / l[..., None]) - (acc2 / l2[..., None])).abs().max())
        out[t] = {"splits_per_rank": h / da.KV_SPLIT, "bit_equal": same,
                  "max_abs_out_gap": gap}
        log(f"  kernel 9 over {t} keys vs two {h}-key halves merged in rank "
            f"order: bit-equal {same}, max |out gap| {gap:.3e}")
    if not out[128]["bit_equal"]:
        fail("kernel 9's halves of one split each, merged, differ from the whole")
    return out


def cell_s_phase(torch, M, serve, cell_r: dict, cell_c: dict, ranks: list,
                 out_dir: Path, wall: float) -> dict:
    """Phase 24's checks: four ranks share the card over gloo (see the
    docstring); `ranks` their results, `out_dir` their files, `wall` rank
    0's seconds in the cell."""
    import shutil
    # (a) training: the losses against cell R's, and the gradient's norm at
    # steps 0 and 1, which run on the same weights (lr is 0 at step 0).
    # Adam's step barely moves when a gradient is scaled, so the losses
    # cannot witness a model-axis gradient summed once per model rank or a
    # data mean left undivided; the norm does, by its factor. From step 2
    # the weights differ by the first update, so its norm is printed only.
    base, gbase = cell_r["losses"], cell_r["grad_norms"]
    losses, gnorms = ranks[0]["train"]["losses"], ranks[0]["train"]["grad_norms"]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, base)]
    grel = [abs(a - b) / abs(b) for a, b in zip(gnorms, gbase)]
    full_state = cell_c["state_bytes"]
    for r, res in enumerate(ranks):
        tr = res["train"]
        log(f"  rank {r} {tr['coords']} ({tr['backend']}, staged {tr['staged']}): "
            f"train {tr['wall_s']:.1f} s, s/step {[round(x, 2) for x in tr['step_seconds']]}, "
            f"losses {tr['losses']}, state {tr['state_bytes'] / 2**30:.3f} GiB "
            f"({tr['state_bytes'] / full_state:.3f} of cell C's), peak "
            f"{tr['peak_bytes'] / 2**30:.2f} GiB; launches "
            f"{ {k: v for k, v in tr['launches'].items() if v} }")
        if (tr["losses"] != losses or tr["grad_norms"] != gnorms
                or any(tr["healths"])):
            fail(f"rank {r}'s losses / norms / health differ: {tr['losses']} "
                 f"{tr['grad_norms']} {tr['healths']}")
    log(f"  cell S losses {losses} vs cell R's {base}: rel {rel} (bars: step 0 "
        f"{LOSS0_BAR}, later {LOSS_BAR}); gradient norms {gnorms} vs {gbase}: "
        f"rel {grel} (bar {GNORM_BAR} at steps 0-1)")
    if (not all(x == x for x in losses + gnorms) or rel[0] > LOSS0_BAR
            or max(rel[1:]) > LOSS_BAR or max(grel[:2]) > GNORM_BAR):
        fail(f"cell S losses {losses} / norms {gnorms} vs {base} / {gbase}")
    # (b) serving: the one-process engine and model on the same inputs
    sv = [res["serve"] for res in ranks]
    streams = sv[0]["streams"]
    for r, s in enumerate(sv):
        log(f"  rank {r}: serve {s['wall_s']:.1f} s, {s['kv_rows']} KV rows, "
            f"pooled_decode_attention launches {s['launches']['pooled_decode_attention']}, "
            f"params {s['param_bytes'] / 2**30:.3f} GiB, peak "
            f"{s['peak_bytes'] / 2**30:.2f} GiB, decode "
            f"{s['throughput']['decode_tok_s']:.1f} tok/s; faults {s['faults']}")
        if s["streams"] != streams or s["faults"]:
            fail(f"rank {r}'s streams differ or faulted")
        if (s["launches"]["pooled_decode_attention"] <= 0
                or s["kv_rows"] != SHARDED_CACHE // 2):
            fail(f"rank {r}: kernel 9 launches {s['launches']} over {s['kv_rows']} rows")
    run = serve.main(SHARDED_SERVE)  # the one-process engine (a world of one)
    params, cfg, qcfg = run.params, run.cfg, run.qcfg
    one_engine = {k: v.tokens for k, v in run.engine.results.items()}
    sharded = [streams[f"req-{i}"] for i in range(8)]
    # each rank holds two whole key splits of kernel 9, so the sharded
    # decode merges the same split triples in the same order as the
    # one-process kernel call: its logits must be the same bits
    import numpy as np
    a = torch.from_numpy(np.load(out_dir / "sharded_logits.npy"))
    b = teacher_forced(torch, params, cfg, qcfg, run.prompts,
                       torch.tensor([s[:4] for s in sharded], dtype=torch.int32),
                       run.spmd).cpu()
    same_logits = bool(torch.equal(a, b))
    prompts = torch.from_numpy(run.prompts).cuda()
    step = lambda p, c, x: M.prefill_step(p, c, x, cfg, qcfg)
    toks, _ = serve.greedy_generate(
        step, params, M.init_cache(cfg, qcfg, 8, SHARDED_CACHE), prompts, SHARDED_NEW)
    greedy = toks.tolist()
    equal = sum(x == y for x, y in zip(sharded, greedy))
    log(f"  cell S logits (prefill + 4 forced decode steps, 8 rows) bit-equal to "
        f"the one-process model's: {same_logits} (max |dlogit| "
        f"{float((a - b).abs().max()):.3e}); streams: {equal}/8 equal the "
        f"one-process greedy_generate (first differences "
        f"{[_first_difference(x, y) for x, y in zip(sharded, greedy)]}); "
        f"one-process engine == greedy "
        f"{one_engine == {f'req-{i}': g for i, g in enumerate(greedy)}}")
    if not same_logits or equal != 8:
        fail(f"cell S serving: logits bit-equal {same_logits}, {equal}/8 streams equal")
    del run, params
    shutil.rmtree(out_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    from repro_torch.kernels import decode_attention as da
    merge = seq_merge_check(torch, da, torch.Generator(device="cuda").manual_seed(
        100 * SEED + 24))
    log(f"  cell S wall {wall:.1f} s (rank 0, after the ranks' start)")
    return {"wall_s": wall, "train": {
        "losses": losses, "rel_vs_cell_r": rel, "grad_norms": gnorms,
        "grad_norm_rel_vs_cell_r": grel,
        "state_gib": [r["train"]["state_bytes"] / 2**30 for r in ranks],
        "state_share_of_cell_c": [r["train"]["state_bytes"] / full_state for r in ranks],
        "peak_gib": [r["train"]["peak_bytes"] / 2**30 for r in ranks],
        "moved_gib": [sum(r["train"]["moved_bytes"].values()) / 2**30 for r in ranks],
        "step_seconds": [r["train"]["step_seconds"] for r in ranks],
        "launches": [r["train"]["launches"] for r in ranks]},
        "serve": {"streams_equal": equal, "logits_bit_equal": same_logits,
                  "decode_launches": [s["launches"]["pooled_decode_attention"] for s in sv],
                  "kv_rows_per_rank": sv[0]["kv_rows"],
                  "decode_tok_s": [s["throughput"]["decode_tok_s"] for s in sv],
                  "wall_s": [s["wall_s"] for s in sv],
                  "moved_gib": [sum(s["moved_bytes"].values()) / 2**30 for s in sv],
                  "peak_gib": [s["peak_bytes"] / 2**30 for s in sv]},
        "seq_merge": merge}


# ---------------------------------------------------------------------------
# phase 26: tensor-parallel compute (cell T)
# ---------------------------------------------------------------------------

TP_TRAIN_MODEL, TP_SERVE_MODEL = 2, 4
# (b) serves SHARDED_SERVE's 2 layers for 32 new tokens (phases 24 and 27
# stop at 8), so that one engine-vs-greedy_generate stream check runs a
# long decode; 128 + 32 rows still round up to SHARDED_CACHE on 4 ranks
TP_NEW = 32
TP_SERVE = list(SHARDED_SERVE)
TP_SERVE[TP_SERVE.index("--new-tokens") + 1] = str(TP_NEW)
# cell T against cell R, relative: step 0's loss (the row-parallel sums
# and the column-parallel dX partials only reorder and re-round f32 / bf16
# sums); the later losses to the reference's 5 % (tests/test_spmd.py); the
# gradient norm of steps 0 and 1, a factor's witness (a gradient scaled
# by a factor gives at least its factor less one; tests/test_torch_tp.py
# holds the same at 2e-3 on the CPU)
TP_LOSS0_BAR, TP_LOSS_BAR, TP_GNORM_BAR = 1e-3, 0.05, 1e-2
# rank 0 traces its last training step with torch.profiler (s/step is
# read from the step before it)
TP_PROFILED_STEP = 2
# cell T's serving logits against the one-process model's on the card:
# the largest |dlogit| within this multiple of the one-process model's own
# largest gap between the card and the CPU at the same inputs (both are
# one more order of the same sums; a rank's partial lost or doubled moves
# logits by their own size, two orders beyond)
TP_CPU_GAP_FACTOR = 4.0


def tp_rank(torch, rank: int, out_dir: str) -> None:
    """Phase 26's part of a rank (`cells_rank`): cell C's QAT on a (2, 2)
    mesh, then cell S's serving on a (1, 4) mesh, both tensor-parallel
    (the launchers' default); writes its numbers to DIR/rank{R}.json and
    rank 0 its teacher-forced logits."""
    from repro_torch.dist import spmd
    from repro_torch.kernels import ops
    from repro_torch.launch import serve, train
    from repro_torch.models import model as M
    ops.reset_launch_counts()
    spmd.reset_moved_bytes()
    prof = {}

    def on_step(i, state):
        if rank == 0 and i == TP_PROFILED_STEP:
            torch.cuda.synchronize()
            prof["p"] = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            prof["p"].start()
            prof["t0"] = time.perf_counter()
            prof["collect0"] = spmd.collect_seconds()

    t0 = time.perf_counter()
    from repro_torch.configs.registry import get_config
    with logits_gathers(torch, VL_ROWS, get_config("qwen1.5-0.5b").padded_vocab) as gathers:
        rep = train.main(SHARDED_TRAIN + ["--ckpt", str(Path(out_dir) / "ckpt"),
                                          "--model-parallel", str(TP_TRAIN_MODEL)],
                         on_step=on_step)
    torch.cuda.synchronize()
    step_prof = None
    if prof:
        window = time.perf_counter() - prof["t0"]
        collect_s = spmd.collect_seconds() - prof["collect0"]
        prof["p"].stop()
        step_prof = step_profile(torch, prof["p"], window, collect_s)
    res = {"train": {"wall_s": time.perf_counter() - t0, "losses": rep.losses,
                     "profile": step_prof,
                     "grad_norms": rep.grad_norms, "healths": rep.healths,
                     "step_seconds": rep.step_seconds, "state_bytes": rep.state_bytes,
                     "peak_bytes": rep.peak_bytes, "moved_bytes": spmd.moved_bytes(),
                     "moved_by_use": spmd.moved_bytes_by_use(),
                     "logits_gathers": gathers,
                     "launches": ops.launch_counts(), "coords": rep.mesh.coords,
                     "mesh": rep.mesh.shape}}
    del rep
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    spmd.reset_moved_bytes()
    t0 = time.perf_counter()
    run = serve.main(TP_SERVE + ["--model-parallel", str(TP_SERVE_MODEL)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, moved = ops.launch_counts(), spmd.moved_bytes()
    sp, cfg, qcfg = run.spmd, run.cfg, run.qcfg
    streams = {k: v.tokens for k, v in run.engine.results.items()}
    n = len(run.prompts)
    forced = torch.tensor([streams[f"req-{i}"][:4] for i in range(n)], dtype=torch.int32)
    lg = teacher_forced(torch, run.params, cfg, qcfg, run.prompts, forced, sp)
    dev = M.params_device(run.params)
    step = lambda p, c, x: M.prefill_step(p, c, x, cfg, qcfg, spmd=sp)  # noqa: E731
    toks, _ = serve.greedy_generate(
        step, run.params, M.init_cache(cfg, qcfg, n, SHARDED_CACHE, dev, spmd=sp),
        torch.from_numpy(run.prompts).to(dev), TP_NEW)
    if rank == 0:
        import numpy as np
        np.save(Path(out_dir) / "tp_logits.npy", lg.cpu().numpy())
    kv = run.engine.executor.pool["layers"][0]["kv"]
    res["serve"] = {"wall_s": wall, "streams": streams, "greedy": toks.tolist(),
                    "launches": launches, "moved_bytes": moved,
                    "kv_rows": int(kv.k.shape[1]), "mesh": sp.mesh.shape,
                    "tp": [[t is not None for t in M.layer_tp(sp, cfg, i)[:2]]
                           for i in range(cfg.n_layers)],
                    "embed_tp": M.vocab_tp(sp, cfg)[0] is not None,
                    "head_tp": M.vocab_tp(sp, cfg)[1] is not None,
                    "throughput": run.summary["throughput"],
                    "faults": {k: v for k, v in run.summary["faults"].items() if v},
                    "peak_bytes": run.peak_bytes,
                    "param_bytes": sum(t.numel() * t.element_size() for t in
                                       _leaves(run.params))}
    with open(Path(out_dir) / f"rank{rank}.json", "w") as f:
        json.dump(res, f)


class logits_gathers:
    """Inside, the shapes of the f32 all-gathers whose output holds `rows`
    x `vocab` elements (a rank's whole logits) are listed in the value
    `with` gives (`launch.cost.record_collective` sees every collective
    `dist.spmd.collect` launches)."""

    def __init__(self, torch, rows: int, vocab: int):
        from repro_torch.launch import cost
        self.cost, self.record, self.found = cost, cost.record_collective, []

        def spy(kind, out):
            if (kind == "gather" and out.dtype == torch.float32
                    and out.numel() == rows * vocab):
                self.found.append(list(out.shape))
            self.record(kind, out)
        self.spy = spy

    def __enter__(self) -> list:
        self.cost.record_collective = self.spy
        return self.found

    def __exit__(self, *exc) -> None:
        self.cost.record_collective = self.record


# (d) the vocab-parallel losses at cell T's shape, on the (1, 4) group of the
# four ranks: rows, MCKD's top-K, the teacher's temperature; f32 values a row
# all-reduces (the max, then the sum of exp and the target term; the teacher
# first takes its own max and sum); the bars (the loss, relative; the
# gradient, of max|g|)
VL_ROWS, VL_K, VL_T = 8 * 512 // (SHARDED_RANKS // TP_TRAIN_MODEL), 16, 2.0
VL_VALUES = {"hard": 3, "mckd": 3, "teacher": 6}
VL_LOSS_BAR = VL_GRAD_BAR = 1e-6


def vocab_loss_rank(torch, rank: int, out_dir: str) -> None:
    """Phase 26 (d)'s part of a rank (`cells_rank`): `core.kd`'s hard CE,
    MCKD's sparse soft-CE and the teacher soft-CE on this rank's quarter
    of seeded f32 logits (VL_ROWS x qwen1.5-0.5b's padded vocab, its 128
    padding columns -1e9, drawn alike on every rank), the split over the
    four ranks' default group; each against the same function on the whole
    logits in this process (value and this rank's columns of its gradient),
    with the bytes launched under "loss" and the host ms of each (a card
    shared by four processes); writes DIR/rank{R}.json."""
    import torch.distributed as dist
    from repro_torch.configs.registry import get_config
    from repro_torch.core import kd
    from repro_torch.dist import spmd
    cfg = get_config("qwen1.5-0.5b")
    vp, v = cfg.padded_vocab, cfg.vocab_size
    gen = torch.Generator(device="cuda").manual_seed(100 * SEED + 26)
    x = torch.randn((VL_ROWS, vp), generator=gen, device="cuda") * 4.0
    t = torch.randn((VL_ROWS, vp), generator=gen, device="cuda") * 3.0
    x[:, v:] = -1e9
    t[:, v:] = -1e9
    labels = torch.randint(0, v, (VL_ROWS,), generator=gen, device="cuda")
    ids = torch.randint(0, v, (VL_ROWS, VL_K), generator=gen, device="cuda")
    ids[:, 0] = labels
    p = torch.softmax(torch.randn((VL_ROWS, VL_K), generator=gen, device="cuda"), -1)
    tp = spmd.TPSplit(dist.group.WORLD, rank, SHARDED_RANKS)
    fns = {"hard": lambda z, s: kd.hard_ce(z, labels, tp=s),
           "mckd": lambda z, s: kd.sparse_soft_ce(z, ids, p, tp=s),
           "teacher": lambda z, s: kd.kd_from_teacher_logits(z, t, VL_T, tp=s)}
    res = {}
    for name, fn in fns.items():
        out = {}
        for split, z in ((tp, tp.local(x, -1)), (None, x)):
            z = z.clone().requires_grad_(True)
            spmd.reset_moved_bytes()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = fn(z, split)
            (g,) = torch.autograd.grad(loss, z)
            torch.cuda.synchronize()
            out[split is None] = (float(loss.detach()), g, (time.perf_counter() - t0) * 1e3,
                                  spmd.moved_bytes_by_use().get("loss", 0))
            del z, loss
        n = vp // SHARDED_RANKS
        (lv, g, ms, nbytes), (lw, gw, whole_ms, _) = out[False], out[True]
        res[name] = {"loss": lv, "whole": lw, "rel": abs(lv - lw) / abs(lw),
                     "gap": float((g - gw[:, rank * n:(rank + 1) * n]).abs().max()),
                     "gmax": float(gw.abs().max()), "bytes": nbytes, "ms": ms,
                     "whole_ms": whole_ms}
        del out, g, gw
    with open(Path(out_dir) / f"rank{rank}.json", "w") as f:
        json.dump(res, f)


def vocab_loss_phase(ranks: list) -> dict:
    """Phase 26 (d)'s checks (`vocab_loss_rank`): every rank's loss within
    VL_LOSS_BAR relative of the whole logits' and the same bits on every
    rank, its columns' gradient within VL_GRAD_BAR of max|g|, the "loss"
    bytes VL_ROWS x VL_VALUES x 4."""
    out = {}
    for name, values in VL_VALUES.items():
        rs = [r[name] for r in ranks]
        want = VL_ROWS * values * 4
        log(f"  (d) vocab-parallel {name} on {VL_ROWS} x 152064 f32 logits over 4 ranks: "
            f"{rs[0]['loss']} vs the whole logits' {[r['whole'] for r in rs]} (rel "
            f"{[r['rel'] for r in rs]}, bar {VL_LOSS_BAR}); gradient gap "
            f"{[r['gap'] for r in rs]} of max|g| {rs[0]['gmax']} (bar {VL_GRAD_BAR}); "
            f"'loss' bytes {[r['bytes'] for r in rs]} (formula {want}); host ms with the "
            f"backward {[round(r['ms'], 3) for r in rs]} vs whole "
            f"{[round(r['whole_ms'], 3) for r in rs]}")
        if (any(r["rel"] > VL_LOSS_BAR or r["gap"] > VL_GRAD_BAR * r["gmax"]
                or r["bytes"] != want or r["loss"] != rs[0]["loss"] for r in rs)):
            fail(f"vocab-parallel {name} departs from the whole logits' loss: {rs}")
        out[name] = rs
    return out


def step_profile(torch, prof, window_s: float, collect_s: float) -> dict:
    """What torch.profiler (device activity) saw on this rank over a window
    of `window_s` host seconds (one training step): the spans of its
    kernels and of its copies (gloo's staging between the card and the
    host among them), their share of the window, and `collect_s`, the host
    seconds inside `spmd.collect` (staging, the wire and the wait for the
    other ranks). Where processes share the card, a span includes the
    other contexts' time slices."""
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and e.self_device_time_total > 0]
    copy = sum(e.self_device_time_total for e in dev
               if e.key.startswith(("Memcpy", "Memset"))) / 1e6
    kernel = sum(e.self_device_time_total for e in dev) / 1e6 - copy
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:6]
    return {"window_s": window_s, "kernel_s": kernel, "copy_s": copy,
            "device_busy_share": (kernel + copy) / window_s,
            "kernel_share": kernel / window_s,
            "collect_host_s": collect_s, "collect_share": collect_s / window_s,
            "kernels": sum(e.count for e in dev),
            "top": [(e.key[:80], e.count, e.self_device_time_total / 1e3)
                    for e in top]}


# the four-process cells, in the order each rank runs them (`cells_rank`)
CELLS = ("S", "T", "U", "VL", "V")


def cells_rank(rank: int, port: int, out_dir: str) -> None:
    """One of the SHARDED_RANKS processes of phases 24, 26 and 27
    (`chip_smoke.py --cells-rank R PORT DIR`): one interpreter, CUDA
    context and process group run cells S, T and U, phase 26 (d)'s
    vocab-parallel losses ("VL") and cell V in turn, each writing into
    DIR/<cell>/;
    DIR/start{R}.json holds the seconds from the spawn
    (`_spawn_ranks` puts its clock in CHIP_SMOKE_SPAWNED) to this line and
    to torch with a CUDA context, and each cell's wall seconds."""
    import os
    t_entry = time.time()
    os.environ.update(_torchrun_env(rank, SHARDED_RANKS, port))
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.zeros(1, device="cuda")
    spawned = float(os.environ["CHIP_SMOKE_SPAWNED"])
    start = {"interpreter_s": round(t_entry - spawned, 3),
             "torch_cuda_s": round(time.time() - spawned, 3), "cells_s": {}}
    runs = {"S": sharded_rank, "T": tp_rank, "U": ep_rank, "VL": vocab_loss_rank,
            "V": recurrent_tp_rank}
    for cell in CELLS:
        t0 = time.perf_counter()
        runs[cell](torch, rank, str(Path(out_dir) / cell))
        torch.cuda.empty_cache()
        start["cells_s"][cell] = round(time.perf_counter() - t0, 3)
    with open(Path(out_dir) / f"start{rank}.json", "w") as f:
        json.dump(start, f)
    dist.barrier()
    dist.destroy_process_group()


def _spawn_ranks(out_dir: Path, timeout: int) -> dict:
    """SHARDED_RANKS processes of this script (`--cells-rank R PORT DIR`),
    their logs in DIR; {cell: the ranks' JSON results} and rank 0's start
    (`cells_rank`), or a failure with each log's tail."""
    import os
    for cell in CELLS:
        (out_dir / cell).mkdir(parents=True, exist_ok=True)
    port = _free_port()
    logs = [open(out_dir / f"rank{r}.log", "w") for r in range(SHARDED_RANKS)]
    env = dict(os.environ, CHIP_SMOKE_SPAWNED=repr(time.time()))
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                               "--cells-rank", str(r), str(port), str(out_dir)],
                              cwd=str(ROOT), stdout=logs[r], stderr=subprocess.STDOUT,
                              env=env)
             for r in range(SHARDED_RANKS)]
    try:
        rcs = [p.wait(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for f in logs:
            f.close()
    if any(rcs):
        for r in range(SHARDED_RANKS):
            log(f"--- rank {r} (exit {rcs[r]}):\n"
                + (out_dir / f"rank{r}.log").read_text()[-3000:])
        fail(f"--cells-rank ranks exited {rcs}")
    start = json.loads((out_dir / "start0.json").read_text())
    log(f"  rank 0's start (seconds from its spawn) and its cells' seconds: {start}")
    log("  rank 0's log: " + " | ".join(
        (out_dir / "rank0.log").read_text().splitlines()[:6]))
    return {cell: [json.loads((out_dir / cell / f"rank{r}.json").read_text())
                   for r in range(SHARDED_RANKS)] for cell in CELLS}, start


def _gap(torch, a, b) -> dict:
    """|a - b| of logits (..., vocab) against the reference b: its 90th
    percentile, mean and max, the largest |dp|, the argmax agreement, and
    the positions whose top-2 gap in b exceeds twice their largest
    |dlogit| (decided), all of which must agree."""
    import numpy as np
    d = (a - b).abs()
    dn = d.numpy()
    a2, b2 = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
    same = a2.argmax(-1) == b2.argmax(-1)
    top2 = torch.topk(b2, 2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > 2 * d.reshape(a2.shape).max(-1).values
    return {"q90": float(np.quantile(dn, 0.9)), "mean": float(dn.mean()),
            "max": float(dn.max()), "max_logit": float(b.abs().max()),
            "bit_equal_share": float((dn == 0).mean()),
            "prob_gap": float((a.softmax(-1) - b.softmax(-1)).abs().max()),
            "argmax_equal": int(same.sum()), "positions": same.numel(),
            "decided": int(decided.sum()),
            "decided_equal": bool(same[decided].all())}


def logits_bar(torch, a, b, cpu) -> dict:
    """Tensor-parallel logits `a` against the one-process model's `b` on
    the card, and both against the one-process model on the CPU (`cpu`,
    every kernel's plain version) at the same inputs (..., vocab).
    Printed: tests/test_fused_qat_matmul.py's bf16 model-logits bar (90 %
    of the logits within 1e-3, the mean gap under 0.05, probabilities
    within 0.02, the argmax unchanged), which the CPU test holds (bit-equal
    there). Held: phase 4's bar for two summation orders (90th percentile
    |dlogit| <= 2**-7 max|logit|, the argmax equal at all positions but
    one and at every decided one), and the largest |dlogit| within
    TP_CPU_GAP_FACTOR x the one-process model's own card-vs-CPU largest
    gap. The witness of the cause (each slice's split-K plan and the
    ranks' f32 sum order the row-parallel products otherwise than the
    whole weight's one call): the tensor-parallel logits are as far from
    the CPU's as the one-process card logits are."""
    out = _gap(torch, a, b)
    out["vs_cpu"] = {"tp": _gap(torch, a, cpu), "one_process": _gap(torch, b, cpu)}
    n = out["positions"]
    out["bf16_bar"] = (out["q90"] < 1e-3 and out["mean"] < 0.05
                       and out["prob_gap"] < 0.02 and out["argmax_equal"] == n)
    out["ok"] = (out["q90"] <= 2 ** -7 * out["max_logit"]
                 and out["argmax_equal"] >= n - 1 and out["decided_equal"]
                 and out["max"] <= TP_CPU_GAP_FACTOR * out["vs_cpu"]["one_process"]["max"])
    return out


def check_loss_bytes(cell: str, trains: list, tokens: int, steps: int) -> int:
    """The training loss on the rank's logit columns (MCKD): each rank's
    bytes under "loss" are tokens x 3 f32 x 4 B a step (a row's max, then
    its sum of exp and its target term), and no all-gather delivered a
    (tokens, padded vocab) f32 tensor (`logits_gathers`)."""
    want = tokens * 3 * 4 * steps
    for r, tr in enumerate(trains):
        got = tr["moved_by_use"].get("loss", 0)
        if got != want or tr["logits_gathers"]:
            fail(f"cell {cell} rank {r}: 'loss' moved {got} B against {want}, logits "
                 f"gathered {tr['logits_gathers']}")
    return want


def cell_t_phase(torch, M, serve, qmm, ref, cell_r: dict, cell_s: dict,
                 cell_c: dict, ranks: list, out_dir: Path, wall: float) -> dict:
    """Phase 26's checks: tensor-parallel compute (see the docstring);
    `ranks`, `out_dir` and `wall` as for `cell_s_phase`."""
    import shutil
    from repro_torch.configs.registry import get_config
    from repro_torch.core.policy import get_preset
    # (a) training on (2 data, 2 model): losses and gradient norms against
    # cell R's one-process bits, launches against the formula on the slices
    base, gbase = cell_r["losses"], cell_r["grad_norms"]
    tr0 = ranks[0]["train"]
    losses, gnorms = tr0["losses"], tr0["grad_norms"]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, base)]
    grel = [abs(a - b) / abs(b) for a, b in zip(gnorms, gbase)]
    cfg, qcfg = get_config("qwen1.5-0.5b"), get_preset("w4a4")
    tokens = 8 * 512 // (SHARDED_RANKS // TP_TRAIN_MODEL)
    per_step = None
    for r, res in enumerate(ranks):
        tr = res["train"]
        steady = tr["step_seconds"][1:] or tr["step_seconds"]
        log(f"  rank {r} {tr['coords']}: train {tr['wall_s']:.1f} s, s/step "
            f"{[round(x, 3) for x in tr['step_seconds']]} (median after the first "
            f"{statistics.median(steady):.3f}), state {tr['state_bytes'] / 2**30:.3f} GiB, "
            f"peak {tr['peak_bytes'] / 2**30:.2f} GiB, collectives "
            f"{sum(tr['moved_bytes'].values()) / 2**30:.3f} GiB {tr['moved_bytes']}")
        if (tr["losses"] != losses or tr["grad_norms"] != gnorms
                or any(tr["healths"])):
            fail(f"cell T rank {r}'s losses / norms / health differ: {tr['losses']} "
                 f"{tr['grad_norms']} {tr['healths']}")
        per_step = check_launches({"cfg": cfg, "qcfg": qcfg, "counts": {
            k: tr["launches"][k] for k in QAT_KERNELS}}, len(losses), tokens,
            tp_parts=TP_TRAIN_MODEL)
    log(f"  cell T losses {losses} vs cell R's {base}: rel {rel} (bars: step 0 "
        f"{TP_LOSS0_BAR}, later {TP_LOSS_BAR}); gradient norms {gnorms} vs {gbase}: "
        f"gap {grel[:2]} at steps 0-1 (bar {TP_GNORM_BAR})")
    if (not all(x == x for x in losses + gnorms) or rel[0] > TP_LOSS0_BAR
            or max(rel[1:]) > TP_LOSS_BAR or max(grel[:2]) > TP_GNORM_BAR):
        fail(f"cell T losses {losses} / norms {gnorms} vs {base} / {gbase}")
    # s/step: the step before the traced one
    s_train = [r["train"]["step_seconds"][TP_PROFILED_STEP - 1] for r in ranks]
    moved = [sum(r["train"]["moved_bytes"].values()) for r in ranks]
    loss_bytes = check_loss_bytes("T", [r["train"] for r in ranks], tokens, len(losses))
    prof = tr0["profile"]
    log(f"  cell T s/step (step {TP_PROFILED_STEP - 1}) {s_train} vs cell S's (gathered) "
        f"{[statistics.median(x[1:]) for x in cell_s['train']['step_seconds']]}; "
        f"collectives a rank {[m / 2**30 for m in moved]} GiB vs "
        f"{cell_s['train']['moved_gib']}; a step {[m / len(losses) / 2**30 for m in moved]} "
        f"GiB a rank (4.40 with the f32 logits gather), 'loss' "
        f"{loss_bytes // len(losses)} B of them; peaks "
        f"{[round(r['train']['peak_bytes'] / 2**30, 3) for r in ranks]} GiB; "
        f"rank 0's traced step {TP_PROFILED_STEP}: {prof}")
    # (b) serving on (1, 4): heads, d_ff and vocab over the 4 ranks, the KV
    # sequence over the same 4
    sv = [res["serve"] for res in ranks]
    streams = sv[0]["streams"]
    n = len(streams)
    for r, s in enumerate(sv):
        log(f"  rank {r}: serve {s['wall_s']:.1f} s, {s['kv_rows']} KV rows, launches "
            f"{ {k: s['launches'][k] for k in ('int_matmul', 'int4_matmul', 'pooled_decode_attention')} }, "
            f"params {s['param_bytes'] / 2**30:.3f} GiB, peak {s['peak_bytes'] / 2**30:.2f} GiB, "
            f"decode {s['throughput']['decode_tok_s']:.1f} tok/s, collectives "
            f"{sum(s['moved_bytes'].values()) / 2**30:.3f} GiB; faults {s['faults']}")
        if s["streams"] != streams or s["faults"]:
            fail(f"cell T rank {r}'s streams differ or faulted")
        if s["greedy"] != [streams[f"req-{i}"] for i in range(n)]:
            fail(f"cell T rank {r}: the engine's streams differ from the "
                 "tensor-parallel greedy_generate")
        if (not all(a and f for a, f in s["tp"]) or not s["embed_tp"] or not s["head_tp"]
                or s["kv_rows"] != SHARDED_CACHE // TP_SERVE_MODEL
                or min(s["launches"][k] for k in ("int_matmul", "int4_matmul",
                                                  "pooled_decode_attention")) <= 0):
            fail(f"cell T rank {r}: not tensor-parallel throughout, or kernels 7-9 "
                 f"not launched: {s['tp']} {s['launches']} {s['kv_rows']}")
    run = serve.main(TP_SERVE)  # the one-process engine and model
    one_streams = {k: v.tokens for k, v in run.engine.results.items()}
    import numpy as np
    a = torch.from_numpy(np.load(out_dir / "tp_logits.npy"))
    forced = torch.tensor([streams[f"req-{i}"][:4] for i in range(n)], dtype=torch.int32)
    b = teacher_forced(torch, run.params, run.cfg, run.qcfg, run.prompts, forced,
                       run.spmd).cpu()
    # the one-process model on the CPU (the plain versions), in the
    # background of the card's work that follows (`finish`)
    cpu = background(cpu_teacher_forced, torch, _to(run.params, "cpu"), run.cfg,
                     run.qcfg, run.prompts, forced, run.spmd)
    firsts = [_first_difference(streams[f"req-{i}"], one_streams[f"req-{i}"])
              for i in range(n)]
    out = {}

    def finish() -> None:
        lg, t_cpu = cpu.result()
        bar = logits_bar(torch, a, b, lg)
        log(f"  cell T logits (prefill + 4 forced decode steps, {n} rows) against the "
            f"one-process model's on the card, and both against the CPU's ({t_cpu:.1f} s "
            f"there, in the background): {bar}; streams {n}/{n} equal the tensor-parallel "
            f"greedy_generate on every rank; first token leaving the one-process stream "
            f"{firsts}; decode tok/s a rank "
            f"{[s['throughput']['decode_tok_s'] for s in sv]} vs cell S's "
            f"{cell_s['serve']['decode_tok_s']}")
        if not bar["ok"]:
            fail(f"cell T serving logits depart from the one-process model's: {bar}")
        out["serve"]["logits"] = bar

    del run
    shutil.rmtree(out_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    # (c) the kernels at the slices' shapes
    gen = torch.Generator(device="cuda").manual_seed(100 * SEED + 26)
    timer = Timer(torch)
    indep = [check_m_independence(torch, qmm, k, nn, gen) for k, nn in
             ((4096, 14336 // TP_SERVE_MODEL), (14336 // TP_SERVE_MODEL, 4096))]
    m = 8 * 512
    qat = {"quant_matmul": [], "quant_matmul_bwd": []}
    for k, nn in ((1024, 2816 // TP_TRAIN_MODEL), (2816 // TP_TRAIN_MODEL, 1024)):
        qat["quant_matmul"].append(check_qat_fwd(torch, timer, qmm, ref, m, k, nn, False,
                                                 gen, QAT_QS))
        qat["quant_matmul_bwd"].append(check_qat_bwd(
            torch, timer, qmm, ref, "quant_matmul_bwd", m, k, nn, False, True, gen, QAT_QS))
    torch.cuda.empty_cache()
    log(f"  cell T wall {wall:.1f} s (rank 0, after the ranks' start)")
    out.update({"finish": finish, "wall_s": wall, "train": {
        "losses": losses, "rel_vs_cell_r": rel, "grad_norms": gnorms,
        "grad_norm_rel_vs_cell_r": grel, "launches_per_step": per_step,
        "s_per_step": s_train, "profile": prof,
        "loss_bytes": loss_bytes,
        "moved_gib_per_step": [m / len(losses) / 2**30 for m in moved],
        "state_gib": [r["train"]["state_bytes"] / 2**30 for r in ranks],
        "peak_gib": [r["train"]["peak_bytes"] / 2**30 for r in ranks],
        "moved_gib": [sum(r["train"]["moved_bytes"].values()) / 2**30 for r in ranks],
        "step_seconds": [r["train"]["step_seconds"] for r in ranks]},
        "serve": {"first_difference": firsts,
                  "launches": [{k: s["launches"][k] for k in (
                      "int_matmul", "int4_matmul", "pooled_decode_attention")} for s in sv],
                  "decode_tok_s": [s["throughput"]["decode_tok_s"] for s in sv],
                  "wall_s": [s["wall_s"] for s in sv],
                  "moved_gib": [sum(s["moved_bytes"].values()) / 2**30 for s in sv],
                  "peak_gib": [s["peak_bytes"] / 2**30 for s in sv],
                  "param_gib": [s["param_bytes"] / 2**30 for s in sv]},
        "slices": {"m_independence": indep, "qat": qat}})
    return out


# ---------------------------------------------------------------------------
# phase 27: expert-parallel MoE (cell U)
# ---------------------------------------------------------------------------

EP_TRAIN_MODEL, EP_SERVE_MODEL = 2, 4
# (a)'s depth: 16 of phase 8's 24 layers (4 before, when the whole-EMA
# gathers ran 24 out of memory). OBR and the oscillation fraction move only
# each leaf's sums, so all 24 fit the card (14.30 GiB a rank at peak), but
# a step there takes 30-50 s a rank (the layers' FSDP gathers and gradient
# sums, staged through host memory), which the script's time limit does
# not hold beside the other cells
EP_TRAIN_LAYERS = 16
# (b)'s depth and length: at 4 layers and 32 new tokens the serving run
# took 24 s and the 8 single-request greedy_generate 58 s a rank (~0.3 s a
# decode step of host-staged collectives)
EP_SERVE = ["--arch", "granite-moe-1b-a400m", "--quant", "w3a3", "--kv-bits", "8",
            "--layers", "2", "--batch", "8", "--slots", "4", "--prompt-len", "128",
            "--new-tokens", str(SHARDED_NEW), "--chunk", "128"]
# the expert layer of (c): seeded params and inputs, made alike in the
# ranks and the parent (CUDA's generator gives the same bits for the same
# seed and draws on one device)
EP_LAYER_SEED = 100 * SEED + 27
# the scale gradients of (c), relative to the whole layer's: the
# replicated ones sum the ranks' partials in another order, and a
# per-expert scale's sum over its columns is a reduction whose plan on the
# card follows the number of experts in the call (bit-equal on the CPU)
EP_SCALE_BAR = 1e-5
# (e)'s expert weights' and weight scales' gradients, summed over the data
# ranks, element by element against |the whole's| + the sum of |the ranks'
# parts|: each rank's dW is a bf16 product (kernel 6 for bf16 cotangents,
# as the reference's bf16 einsum: `kernels.ref.quant_matmul_dw`), rounded
# before the sum, and its weight scale's gradient is summed from it; a
# bf16 ulp is at most 2^-7 of its value
DP_BF16_BAR = 2.0 ** -7


def moe_qat_config():
    """Phase 8's configuration: full-width granite-moe-1b-a400m, w3a3 (OBR
    0.1), oscillation tracked."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.policy import get_preset
    return get_config("granite-moe-1b-a400m"), get_preset("w3a3").replace(
        track_oscillation=True)


def smoke_tcfg(steps: int):
    """`training_run`'s TrainConfig: MCKD top-16, the sentinel on, the
    CLI's optimizer settings."""
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.sentinel import SentinelConfig
    from repro_torch.train.state import TrainConfig
    return TrainConfig(total_steps=steps, warmup_steps=2, kd="mckd", kd_topk=16,
                       adamw=AdamWConfig(lr_peak=3e-3), sentinel=SentinelConfig())


def moe_layer(torch, serving: bool = False):
    """(cfg, qcfg, params, x, dy) of one full-width granite-moe MoE FFN
    layer from EP_LAYER_SEED: latent (w3a3, the batched QAT kernels) or
    converted to int codes (the expert fallback); x and dy (8, 512, d)
    bf16."""
    from repro_torch.models.common import convert_to_serving
    from repro_torch.models.moe import moe_init
    cfg, qcfg = moe_qat_config()
    gen = torch.Generator(device="cuda").manual_seed(EP_LAYER_SEED)
    p = moe_init(gen, cfg, qcfg, device="cuda")
    x = torch.randn((8, 512, cfg.d_model), generator=gen, device="cuda").to(torch.bfloat16)
    dy = torch.randn((8, 512, cfg.d_model), generator=gen, device="cuda").to(torch.bfloat16)
    if serving:
        p = convert_to_serving(p, qcfg)
    return cfg, qcfg, p, x, dy


def _expert_slice(p: dict, mesh):
    """(params, tp): this rank's slices of a layer's MoE params, cut by the
    sharding rules (`dist.sharding.param_pspecs`) as the runtime holds
    them, and its split as `models.model.layer_tp` makes it: the expert
    linears' leaves on their model slices (`Spmd.gather` keeps them), the
    router whole (`Spmd.gather` gathers it: top-k reads every expert's
    logit)."""
    from repro_torch.dist import sharding as shard
    from repro_torch.dist.spmd import Spmd
    specs = shard.param_pspecs({"moe": p}, mesh)
    sp = Spmd(mesh, specs)
    tp = sp.tp(("moe",), tuple(n for n in p if n != "router"))
    tp = tp._replace(experts=sp.experts(("moe", "moe_in")))
    return {name: sub if name == "router" else {
        k: shard.local_shard(v, specs["moe"][name][k], mesh, mesh.coords).clone()
        for k, v in sub.items()} for name, sub in p.items()}, tp


def moe_layer_run(torch, mesh=None) -> dict:
    """The layer of `moe_layer` (this rank's experts on `mesh`'s model
    axis, split as the rules split them): its output, and the gradients of
    its input and of every leaf for the cotangent dy; then the serving
    form's outputs at 4 tokens (a decode step) and 128 (a prefill), all on
    the host."""
    from repro_torch.models.moe import moe_ffn
    cfg, qcfg, p, x, dy = moe_layer(torch)
    tp = None
    if mesh is not None:
        p, tp = _expert_slice(p, mesh)
    leaves = [(f"{name}/{k}", v.requires_grad_(True)) for name, sub in sorted(p.items())
              for k, v in sorted(sub.items())]
    x = x.clone().requires_grad_(True)
    y, aux = moe_ffn(p, x, cfg, qcfg, torch.bfloat16, tp)
    gs = torch.autograd.grad(torch.sum(y.float() * dy.float()), [v for _, v in leaves] + [x])
    out = {"y": y.detach().cpu(), "dx": gs[-1].cpu(),
           "grads": {k: g.cpu() for (k, _), g in zip(leaves, gs)},
           "drop_frac": float(aux["drop_frac"]), "experts": tp is not None and tp.experts}
    del y, gs, leaves
    _, _, sp, _, _ = moe_layer(torch, serving=True)
    if mesh is not None:
        sp, tp = _expert_slice(sp, mesh)
    with torch.no_grad():
        out["serve"] = [moe_ffn(sp, xs, cfg, qcfg, torch.bfloat16, tp)[0].cpu()
                        for xs in (x.detach()[:4, :1], x.detach()[:1, :128])]
    torch.cuda.empty_cache()
    return out


def moe_layer_dp(torch, mesh=None) -> dict:
    """(e): the layer of `moe_layer` (latent), its rows split over `mesh`'s
    data ranks (None: the whole layer in this process) and routed over
    them (`models.moe.moe_ffn(dp=...)`), for the loss sum(y * dy) +
    lb_loss (a rank's lb_loss over the ranks, so that the ranks' losses
    add up to the batch's): its output, keep mask, lb_loss and drop_frac
    (the data ranks' means), the gradients of its input and of every leaf;
    on the ranks also the keep mask that routing the rank's own rows gives
    (the per-rank routing this replaces); all on the host."""
    from repro_torch.dist.spmd import Spmd
    from repro_torch.models.moe import moe_ffn
    cfg, qcfg, p, x, dy = moe_layer(torch)
    sp = dp = None
    if mesh is not None:
        sp = Spmd(mesh)
        dp = sp.dp
        n = x.shape[0] // dp.parts
        x, dy = x[dp.index * n:(dp.index + 1) * n], dy[dp.index * n:(dp.index + 1) * n]
    leaves = [(f"{name}/{k}", v.requires_grad_(True)) for name, sub in sorted(p.items())
              for k, v in sorted(sub.items())]
    x = x.clone().requires_grad_(True)
    y, aux = moe_ffn(p, x, cfg, qcfg, torch.bfloat16, None, dp, keep_mask=True)
    loss = torch.sum(y.float() * dy.float()) + aux["lb_loss"] / (dp.parts if dp else 1)
    gs = torch.autograd.grad(loss, [v for _, v in leaves] + [x])
    mean = (lambda v: v) if sp is None else sp.mean
    out = {"y": y.detach().cpu(), "dx": gs[-1].cpu(), "keep": aux["keep"].cpu(),
           "grads": {k: g.cpu() for (k, _), g in zip(leaves, gs)},
           "lb_loss": float(mean(aux["lb_loss"].detach())),
           "drop_frac": float(mean(aux["drop_frac"]))}
    del y, gs, leaves, loss
    if dp is not None:
        with torch.no_grad():
            out["own_keep"] = moe_ffn(p, x.detach(), cfg, qcfg, torch.bfloat16,
                                      keep_mask=True)[1]["keep"].cpu()
        out["index"] = dp.index
    torch.cuda.empty_cache()
    return out


def ep_rank(torch, rank: int, out_dir: str) -> None:
    """Phase 27's part of a rank (`cells_rank`): phase 8's MoE QAT on a
    (2, 2) mesh, granite-moe's serving cut to 2 layers on a (1, 4) mesh,
    and one MoE layer expert-parallel on the 4 ranks (the launchers'
    default runtime: experts split on their expert axis); writes its
    numbers to DIR/rank{R}.json, rank 0 its teacher-forced logits and
    every rank its layer's results, (c)'s and (e)'s."""
    from repro_torch.data.synthetic import DataConfig
    from repro_torch.dist import spmd
    from repro_torch.kernels import ops
    from repro_torch.launch import serve, train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as M
    from repro_torch.models import moe
    cfg, qcfg = moe_qat_config()
    cfg = cfg.replace(n_layers=EP_TRAIN_LAYERS)
    ops.reset_launch_counts()
    spmd.reset_moved_bytes()
    moe.reset_buffer_rows()
    t0 = time.perf_counter()
    rows = 8 * 512 // (SHARDED_RANKS // EP_TRAIN_MODEL)
    with logits_gathers(torch, rows, cfg.padded_vocab) as gathers:
        rep = train.run_training(cfg, qcfg, smoke_tcfg(3), DataConfig(seed=0), steps=3,
                                 batch_size=8, seq_len=512,
                                 ckpt_dir=str(Path(out_dir) / "ckpt"), save_every=10 ** 6,
                                 log_every=0, seed=0, device="cuda",
                                 model_parallel=EP_TRAIN_MODEL)
    torch.cuda.synchronize()
    res = {"train": {"wall_s": time.perf_counter() - t0, "losses": rep.losses,
                     "grad_norms": rep.grad_norms, "healths": rep.healths,
                     "metrics": rep.metrics, "step_seconds": rep.step_seconds,
                     "state_bytes": rep.state_bytes, "peak_bytes": rep.peak_bytes,
                     "moved_bytes": spmd.moved_bytes(),
                     "moved_by_use": spmd.moved_bytes_by_use(),
                     "logits_gathers": gathers,
                     "collect_s": spmd.collect_seconds(),
                     "launches": ops.launch_counts(), "coords": rep.mesh.coords,
                     "mesh": rep.mesh.shape, "buffer_rows": moe.buffer_rows(),
                     "count_bytes": moe.count_gather_bytes()}}
    del rep
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    spmd.reset_moved_bytes()
    t0 = time.perf_counter()
    run = serve.main(EP_SERVE + ["--model-parallel", str(EP_SERVE_MODEL)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, moved = ops.launch_counts(), spmd.moved_bytes()
    sp, scfg, sqcfg = run.spmd, run.cfg, run.qcfg
    streams = {k: v.tokens for k, v in run.engine.results.items()}
    n = len(run.prompts)
    forced = torch.tensor([streams[f"req-{i}"][:4] for i in range(n)], dtype=torch.int32)
    lg = teacher_forced(torch, run.params, scfg, sqcfg, run.prompts, forced, sp)
    if rank == 0:
        import numpy as np
        np.save(Path(out_dir) / "ep_logits.npy", lg.cpu().numpy())
    dev = M.params_device(run.params)
    step = lambda p, c, x: M.prefill_step(p, c, x, scfg, sqcfg, spmd=sp)  # noqa: E731
    t_greedy = time.perf_counter()
    greedy = [serve.greedy_generate(
        step, run.params, M.init_cache(scfg, sqcfg, 1, SHARDED_CACHE, dev, spmd=sp),
        torch.from_numpy(run.prompts[i:i + 1]).to(dev), SHARDED_NEW)[0][0].tolist()
        for i in range(n)]
    ffn = [M.layer_tp(sp, scfg, i)[1] for i in range(scfg.n_layers)]
    res["serve"] = {"wall_s": wall, "streams": streams, "greedy": greedy,
                    "greedy_s": time.perf_counter() - t_greedy,
                    "launches": launches, "moved_bytes": moved,
                    "ep": [t is not None and t.experts for t in ffn],
                    "attn_tp": [M.layer_tp(sp, scfg, i)[0] is not None
                                for i in range(scfg.n_layers)],
                    "local_experts": [int(lay["moe"]["moe_in"]["codes4"].shape[0])
                                      for lay in run.params["layers"]],
                    "throughput": run.summary["throughput"],
                    "faults": {k: v for k, v in run.summary["faults"].items() if v},
                    "peak_bytes": run.peak_bytes}
    del run
    torch.cuda.empty_cache()
    # (c) one layer, its experts over the 4 ranks
    mesh = make_host_mesh(EP_SERVE_MODEL, "cuda")
    t0 = time.perf_counter()
    torch.save(moe_layer_run(torch, mesh), Path(out_dir) / f"layer{rank}.pt")
    res["layer_s"] = time.perf_counter() - t0
    # (e) the layer's rows over the 4 ranks as data ranks
    mesh = make_host_mesh(1, "cuda")
    t0 = time.perf_counter()
    torch.save(moe_layer_dp(torch, mesh), Path(out_dir) / f"dp{rank}.pt")
    res["dp_s"] = time.perf_counter() - t0
    with open(Path(out_dir) / f"rank{rank}.json", "w") as f:
        json.dump(res, f)


def expert_buffer_bytes(cfg, buffer_rows: dict, passes: int) -> int:
    """The bytes the expert buffers' collectives delivered to a rank whose
    MoE FFN calls ran the capacity buffers `buffer_rows` ({rows: calls},
    `models.moe.buffer_rows`: on data ranks, each call's local capacity):
    each call's output buffer all-gathered along the experts (bf16), and
    its input buffer's gradient all-gathered from the parts once for every
    `passes` forwards (remat: the backward's recompute runs the same
    rows)."""
    rows = sum(r * n for r, n in buffer_rows.items())
    return rows * cfg.n_experts * cfg.d_model * 2 * (passes + 1) // passes


def obr_osc_stats_bytes(cfg, qcfg, tcfg, model: int) -> dict:
    """The bytes OBR and the oscillation fraction deliver to a rank of a
    (SHARDED_RANKS / model, model) mesh in a step: for each quantized leaf
    its weight's spec splits, its Eq. 10 sums in f32 (the sum of squares,
    and 3 x bins x the whole scale's groups); for each oscillation state
    its spec splits, one int64 count each time the step reads the fraction
    (before the update for the sentinel, and after it)."""
    from repro_torch.dist import sharding as shard
    from repro_torch.dist.spmd import spec_at, state_specs
    from repro_torch.models.model import quant_leaf_paths
    from repro_torch.train.state import init_state
    import torch
    mesh = shard.AxisSizes(("data", "model"), (SHARDED_RANKS // model, model))
    like = init_state(cfg, qcfg, tcfg, torch.Generator(), "meta")
    specs = state_specs(cfg, qcfg, tcfg, mesh)
    reads = 1 + (tcfg.sentinel is not None)
    obr = osc = 0
    for j, (path, _, s, spec) in enumerate(quant_leaf_paths(like["params"], qcfg)):
        if shard.split_dims(spec_at(specs["params"], path)["w"], mesh):
            obr += 4 * (1 + 3 * spec.n_bins * s.numel())
        if specs["osc"] and shard.split_dims(specs["osc"][j].freq, mesh):
            osc += 8 * reads
    return {"obr": obr, "oscillation": osc}


def cell_u_one(torch, ops) -> dict:
    """Phase 27 (a)'s one process, run before the ranks take the card: the
    ranks' run at the same configuration (the reference's one dispatch
    group over the whole batch, which the ranks route together)."""
    cfg, qcfg = moe_qat_config()
    one = training_run(torch, ops, cfg.replace(n_layers=EP_TRAIN_LAYERS), qcfg,
                       batch=8, seq=512, steps=3, tag="cell_u_one", strict_health=False)
    torch.cuda.empty_cache()
    return one


def dp_layer_check(torch, out_dir: Path) -> dict:
    """Phase 27 (e): the layer routed over the 4 data ranks (`moe_layer_dp`,
    DIR/dp{R}.pt) against the whole layer in this process."""
    whole = moe_layer_dp(torch)
    parts = [torch.load(out_dir / f"dp{r}.pt") for r in range(SHARDED_RANKS)]
    n, t = whole["y"].shape[0] // SHARDED_RANKS, whole["keep"].shape[0] // SHARDED_RANKS
    dx_max = float(whole["dx"].float().abs().max())
    out = {"keep": all(torch.equal(p["keep"], whole["keep"][p["index"] * t:(p["index"] + 1) * t])
                       for p in parts),
           "y": all(_same_bits(torch, p["y"], whole["y"][p["index"] * n:(p["index"] + 1) * n])
                    for p in parts),
           "drop_frac": all(p["drop_frac"] == whole["drop_frac"] for p in parts)}
    lb_gap = max(abs(p["lb_loss"] - whole["lb_loss"]) for p in parts) / abs(whole["lb_loss"])
    dx_gap = max(float((p["dx"].float() - whole["dx"][p["index"] * n:(p["index"] + 1) * n]
                        .float()).abs().max()) for p in parts) / dx_max
    out["lb_loss"], out["dx"] = lb_gap <= 1e-6, dx_gap <= 1e-6
    gaps = {}
    for key, want in whole["grads"].items():
        lin, leaf = key.split("/")
        got = [p["grads"][key] for p in parts]
        size = want.abs() + sum(g.abs() for g in got)
        gaps[key] = float(((sum(got) - want).abs() / size.clamp_min(1e-30)).max())
        bf16 = lin != "router" and leaf in ("w", "w_scale")
        out[key] = gaps[key] <= (DP_BF16_BAR if bf16 else EP_SCALE_BAR)
    other = sum(int((p["own_keep"] != p["keep"]).sum()) for p in parts)
    log(f"  cell U layer (e): its 8 x 512 rows over 4 data ranks against the whole layer "
        f"(drop_frac {whole['drop_frac']:.4f} vs the ranks' {[p['drop_frac'] for p in parts]}, "
        f"lb_loss {whole['lb_loss']} vs {[p['lb_loss'] for p in parts]}: gap {lb_gap}, dx gap "
        f"{dx_gap} of max|dx|): equal {out}; the leaves' gradients summed over the ranks, "
        f"gaps (of |whole| + the sum of |the ranks' parts|, element by element; bars "
        f"{DP_BF16_BAR} the expert weights' and their scales', {EP_SCALE_BAR} the rest) "
        f"{gaps}; per-rank routing (each rank's own rows) would have routed {other} of "
        f"the {whole['keep'].numel()} pairs otherwise")
    if not all(out.values()) or other <= 0:
        fail(f"cell U layer (e) departs from the whole layer: {out}, {other} pairs")
    return {"equal": out, "lb_gap": lb_gap, "dx_gap": dx_gap, "grad_gaps": gaps,
            "drop_frac": whole["drop_frac"], "per_rank_routing_differs": other}


def cell_u_phase(torch, ops, M, serve, qmm, ref, one: dict, ranks: list,
                 out_dir: Path, wall: float) -> dict:
    """Phase 27's checks: expert-parallel MoE (see the docstring); `one`
    (a)'s one-process run (`cell_u_one`), `ranks`, `out_dir` and `wall`
    as for `cell_s_phase`."""
    import shutil
    import numpy as np
    from repro_torch.train.sentinel import SentinelConfig
    cfg, qcfg = moe_qat_config()
    cfg = cfg.replace(n_layers=EP_TRAIN_LAYERS)
    one_rep = one.pop("report")
    # (a) training on (2 data, 2 model), 16 experts a rank
    base, gbase = one_rep.losses, one_rep.grad_norms
    tr0 = ranks[0]["train"]
    losses, gnorms = tr0["losses"], tr0["grad_norms"]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, base)]
    grel = [abs(a - b) / abs(b) for a, b in zip(gnorms, gbase)]
    tokens = 8 * 512 // (SHARDED_RANKS // EP_TRAIN_MODEL)
    stats = obr_osc_stats_bytes(cfg, qcfg, smoke_tcfg(3), EP_TRAIN_MODEL)
    per_step, bufs = None, []
    for r, res in enumerate(ranks):
        tr = res["train"]
        rows = {int(k): v for k, v in tr["buffer_rows"].items()}
        buf = expert_buffer_bytes(cfg, rows, 2) + tr["count_bytes"]
        bufs.append(buf)
        steady = tr["step_seconds"][1:] or tr["step_seconds"]
        total, uses = sum(tr["moved_bytes"].values()), tr["moved_by_use"]
        log(f"  rank {r} {tr['coords']}: train {tr['wall_s']:.1f} s, s/step "
            f"{[round(x, 3) for x in tr['step_seconds']]} (median after the first "
            f"{statistics.median(steady):.3f}), state {tr['state_bytes'] / 2**30:.3f} GiB, "
            f"peak {tr['peak_bytes'] / 2**30:.2f} GiB, collectives "
            f"{total / 2**30:.3f} GiB {tr['moved_bytes']}; by use (measured, "
            f"`spmd.moved_bytes_by_use`) "
            + ", ".join(f"{k} {v / 2**30:.3f} GiB ({v / total:.3f})" for k, v in uses.items())
            + f", the rest {(total - sum(uses.values())) / 2**30:.3f} GiB; the expert "
            f"buffers at the local capacities it reported ({{rows: calls}} {rows}) and "
            f"the routing counts' gathers ({tr['count_bytes']} B) reckoned "
            f"{buf / 2**30:.3f} GiB (`expert_buffer_bytes`); OBR and "
            f"the oscillation fraction {uses.get('obr', 0)} / {uses.get('oscillation', 0)} B "
            f"against the leaves' sums {stats} B a step x {len(losses)} "
            f"(`obr_osc_stats_bytes`); host in collectives {tr['collect_s']:.1f} s")
        if not 0 <= uses.get("experts", 0) - buf <= 2**20:
            fail(f"cell U rank {r}: the expert collectives counted {uses.get('experts')} "
                 f"bytes against the buffers' {buf}")
        if (any(uses.get(k, 0) != v * len(losses) for k, v in stats.items())
                or sum(stats.values()) >= 2**20):
            fail(f"cell U rank {r}: OBR / oscillation moved {uses} against the leaves' "
                 f"sums {stats} a step (under 1 MiB)")
        if (tr["losses"] != losses or tr["grad_norms"] != gnorms
                or any(h & SentinelConfig().fatal_bits for h in tr["healths"])):
            fail(f"cell U rank {r}'s losses / norms / health differ: {tr['losses']} "
                 f"{tr['grad_norms']} {tr['healths']}")
        per_step = check_launches({"cfg": cfg, "qcfg": qcfg, "counts": {
            k: tr["launches"][k] for k in QAT_KERNELS}}, len(losses), tokens,
            every_kernel=True, tp_parts=EP_TRAIN_MODEL, moe_rows=rows)
    loss_bytes = check_loss_bytes("U", [r["train"] for r in ranks], tokens, len(losses))
    moved = [sum(r["train"]["moved_bytes"].values()) / len(losses) for r in ranks]
    log(f"  cell U collectives a step {[m / 2**30 for m in moved]} GiB a rank (6.97 with the "
        f"f32 logits gather), 'loss' {loss_bytes // len(losses)} B of them, no "
        f"logits gathered")
    m0, b0 = tr0["metrics"][0], one_rep.metrics[0]
    lb_rel = abs(m0["lb_loss"] - b0["lb_loss"]) / abs(b0["lb_loss"])
    log(f"  cell U losses {losses} vs one process (one dispatch group) {base}: rel "
        f"{rel} (bars: step 0 {TP_LOSS0_BAR}, later {TP_LOSS_BAR}); gradient norms "
        f"{gnorms} vs {gbase}: gap {grel[:2]} at steps 0-1 (bar {TP_GNORM_BAR}); "
        f"step 0 lb_loss {m0['lb_loss']} vs {b0['lb_loss']}: rel {lb_rel} (bar "
        f"{TP_LOSS0_BAR}; the batch's Switch loss on both), drop_frac "
        f"{m0['drop_frac']} vs {b0['drop_frac']} (summed over the layers; the "
        f"heads-split attention may move a token's route by an ulp)")
    if (not all(x == x for x in losses + gnorms) or rel[0] > TP_LOSS0_BAR
            or max(rel[1:]) > TP_LOSS_BAR or max(grel[:2]) > TP_GNORM_BAR
            or not lb_rel <= TP_LOSS0_BAR):
        fail(f"cell U losses {losses} / norms {gnorms} / step 0 lb_loss {m0['lb_loss']} "
             f"vs {base} / {gbase} / {b0['lb_loss']}")
    peaks = [res["train"]["peak_bytes"] for res in ranks]
    card = torch.cuda.get_device_properties(0).total_memory
    log(f"  cell U peaks a rank {[round(p / 2**30, 2) for p in peaks]} GiB, their sum "
        f"{sum(peaks) / 2**30:.2f} of the card's {card / 2**30:.2f} GiB (one process "
        f"{(one_rep.peak_bytes or 0) / 2**30:.2f}); loss_obr a step "
        f"{[m['loss_obr'] for m in tr0['metrics']]} vs one process "
        f"{[m['loss_obr'] for m in one_rep.metrics]}; osc_frac "
        f"{[m['osc_frac'] for m in tr0['metrics']]} vs "
        f"{[m['osc_frac'] for m in one_rep.metrics]}")
    # (b) serving on (1, 4): 8 experts a rank, heads and vocab split
    sv = [res["serve"] for res in ranks]
    streams = sv[0]["streams"]
    n = len(streams)
    for r, s in enumerate(sv):
        log(f"  rank {r}: serve {s['wall_s']:.1f} s (then 8 single-request greedy_generate "
            f"{s['greedy_s']:.1f} s, the layer {ranks[r]['layer_s']:.1f} s, (e) "
            f"{ranks[r]['dp_s']:.1f} s), experts a "
            f"layer {s['local_experts']}, "
            f"launches { {k: s['launches'][k] for k in ('int_matmul', 'int4_matmul', 'pooled_decode_attention')} }, "
            f"peak {s['peak_bytes'] / 2**30:.2f} GiB, decode "
            f"{s['throughput']['decode_tok_s']:.1f} tok/s, collectives "
            f"{sum(s['moved_bytes'].values()) / 2**30:.3f} GiB; faults {s['faults']}")
        if s["streams"] != streams or s["faults"]:
            fail(f"cell U rank {r}'s streams differ or faulted")
        if s["greedy"] != [streams[f"req-{i}"] for i in range(n)]:
            fail(f"cell U rank {r}: the engine's streams differ from the "
                 "expert-parallel greedy_generate")
        if (not all(s["ep"]) or not all(s["attn_tp"])
                or set(s["local_experts"]) != {cfg.n_experts // EP_SERVE_MODEL}
                or min(s["launches"][k] for k in ("int4_matmul",
                                                  "pooled_decode_attention")) <= 0):
            fail(f"cell U rank {r}: not expert-parallel throughout, or kernels 8-9 "
                 f"not launched: {s['ep']} {s['attn_tp']} {s['launches']}")
    run = serve.main(EP_SERVE)  # the one-process model
    a = torch.from_numpy(np.load(out_dir / "ep_logits.npy"))
    forced = torch.tensor([streams[f"req-{i}"][:4] for i in range(n)], dtype=torch.int32)
    b = teacher_forced(torch, run.params, run.cfg, run.qcfg, run.prompts, forced,
                       run.spmd).cpu()
    # the one-process model on the CPU, in the background of (c)
    cpu = background(cpu_teacher_forced, torch, _to(run.params, "cpu"), run.cfg,
                     run.qcfg, run.prompts, forced, run.spmd)
    del run
    torch.cuda.empty_cache()
    # (c) the layer, whole in this process against its experts over the ranks
    whole = moe_layer_run(torch)
    parts = [torch.load(out_dir / f"layer{r}.pt") for r in range(SHARDED_RANKS)]
    layer = {"ep": all(p["experts"] for p in parts),
             "y": all(_same_bits(torch, p["y"], whole["y"]) for p in parts),
             "dx": all(_same_bits(torch, p["dx"], whole["dx"]) for p in parts),
             "serve": all(_same_bits(torch, u, v) for p in parts
                          for u, v in zip(p["serve"], whole["serve"]))}
    scale_gaps = {}
    for key, want in whole["grads"].items():
        got = [p["grads"][key] for p in parts]
        if got[0].shape != want.shape:  # an expert leaf: the ranks' experts in order
            got = [torch.cat(got, 0)]
        lin, leaf = key.split("/")
        if lin != "router" and leaf in ("w_scale", "a_scale", "a_offset"):
            gap = max(float((g - want).abs().max()) for g in got) / max(
                float(want.abs().max()), 1e-30)
            scale_gaps[key] = gap
            layer[key] = gap <= EP_SCALE_BAR
        else:  # weights, the router (run whole)
            layer[key] = all(_same_bits(torch, g, want) for g in got)
    log(f"  cell U layer (granite-moe, 32 experts over 4 ranks, 8 x 512 tokens, "
        f"drop_frac {whole['drop_frac']:.4f}) against the whole layer: bit-equal "
        f"{ {k: v for k, v in layer.items() if k not in scale_gaps} }; scales' "
        f"gaps (relative, bar {EP_SCALE_BAR}) {scale_gaps}")
    if not all(layer.values()):
        fail(f"cell U layer differs from the whole layer: {layer}")
    del whole, parts
    torch.cuda.empty_cache()
    dp_layer = dp_layer_check(torch, out_dir)
    shutil.rmtree(out_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    # kernels 2 and 6 at the slices: mixtral-8x7b's expert d_ff over 16
    # model ranks, and this cell's 16 experts a rank at 640 rows
    gen = torch.Generator(device="cuda").manual_seed(100 * SEED + 27)
    timer = Timer(torch)
    qat = {"quant_matmul_batched": [], "quant_matmul_bwd_batched": []}
    for e, mm, k, nn in ((8, 1280, 4096, 896), (8, 1280, 896, 4096),
                         (16, 640, 1024, 512), (16, 640, 512, 1024)):
        qat["quant_matmul_batched"].append(check_batched_fwd(
            torch, timer, qmm, ref, e, mm, k, nn, gen, MOE_QS))
        qat["quant_matmul_bwd_batched"].append(check_batched_bwd(
            torch, timer, qmm, ref, e, mm, k, nn, gen, MOE_QS))
        torch.cuda.empty_cache()
    del timer
    torch.cuda.empty_cache()
    lg, t_cpu = cpu.result()
    bar = logits_bar(torch, a, b, lg)
    log(f"  cell U logits (prefill + 4 forced decode steps, {n} rows) against the "
        f"one-process model's on the card, and both against the CPU's ({t_cpu:.1f} s "
        f"there, in the background): {bar}; "
        f"streams {n}/{n} equal the expert-parallel greedy_generate on every rank; "
        f"decode tok/s a rank {[s['throughput']['decode_tok_s'] for s in sv]}")
    if not bar["ok"]:
        fail(f"cell U serving logits depart from the one-process model's: {bar}")
    log(f"  cell U wall {wall:.1f} s (rank 0, after the ranks' start)")
    return {"wall_s": wall, "train": {
        "losses": losses, "losses_one_process": base, "rel": rel,
        "grad_norms": gnorms, "grad_norm_rel": grel, "launches_per_step": per_step,
        "drop_frac0": [m0["drop_frac"], b0["drop_frac"]],
        "lb_loss0": [m0["lb_loss"], b0["lb_loss"]],
        "one_process_s_per_step": one["s_step"],
        "one_process_peak_gib": (one_rep.peak_bytes or 0) / 2**30,
        "loss_obr": [m["loss_obr"] for m in tr0["metrics"]],
        "loss_obr_one_process": [m["loss_obr"] for m in one_rep.metrics],
        "osc_frac": [m["osc_frac"] for m in tr0["metrics"]],
        "osc_frac_one_process": [m["osc_frac"] for m in one_rep.metrics],
        "lb_loss0_rel": lb_rel,
        "buffer_rows": [r["train"]["buffer_rows"] for r in ranks],
        "stats_bytes_per_step": stats, "peaks_sum_gib": sum(peaks) / 2**30,
        "card_gib": card / 2**30,
        "step_seconds": [r["train"]["step_seconds"] for r in ranks],
        "state_gib": [r["train"]["state_bytes"] / 2**30 for r in ranks],
        "peak_gib": [r["train"]["peak_bytes"] / 2**30 for r in ranks],
        "moved_gib": [{k: v / 2**30 for k, v in r["train"]["moved_bytes"].items()}
                      for r in ranks],
        "expert_buffer_gib": [b / 2**30 for b in bufs], "loss_bytes": loss_bytes,
        "moved_by_use_gib": [{k: v / 2**30 for k, v in r["train"]["moved_by_use"].items()}
                             for r in ranks],
        "collect_s": [r["train"]["collect_s"] for r in ranks]},
        "serve": {"logits": bar,
                  "launches": [{k: s["launches"][k] for k in (
                      "int_matmul", "int4_matmul", "pooled_decode_attention")} for s in sv],
                  "decode_tok_s": [s["throughput"]["decode_tok_s"] for s in sv],
                  "wall_s": [s["wall_s"] for s in sv],
                  "moved_gib": [sum(s["moved_bytes"].values()) / 2**30 for s in sv],
                  "peak_gib": [s["peak_bytes"] / 2**30 for s in sv]},
        "layer": {"bit_equal": layer, "scale_gaps": scale_gaps}, "dp_layer": dp_layer,
        "slices": qat}


# ---------------------------------------------------------------------------
# phase 28: tensor-parallel recurrent blocks and cross-attention (cell V)
# ---------------------------------------------------------------------------

RT_TRAIN_MODEL, RT_BLOCK_MODEL = 2, 4
# (a): cell K's run (phase 16) on the (2, 2) mesh, 3 steps
RT_TRAIN = ["--arch", "xlstm-350m", "--quant", "w4a4", "--kd", "mckd", "--batch", "8",
            "--seq", "512", "--layers", str(8), "--steps", "3",
            "--save-every", str(10 ** 6)]
# cell V against cell K, relative: step 0's loss, every loss (the
# reference's 5 %), the gradient norm of steps 0 and 1 (tests/test_torch_tp.py's
# bars; the reordered sums and the data ranks' halves move them)
RT_LOSS0_BAR, RT_LOSS_BAR, RT_GNORM_BAR = 1e-3, 0.05, 2e-3
# (b) / (c): one full-width block, seeded alike in the ranks and here, at
# 4 x 512 rows; the activation quantizers calibrated as the CPU tests do
# (scale 0.1, offset -0.5: at the init's 1 and 0 nearly every normalised
# input clips), the cross gate at 0.5 (tanh(0) shuts the sublayer)
RT_BLOCK_SEED = 100 * SEED + 28
RT_BLOCK_ROWS = (4, 512)
# the gradients' bars (tests/test_torch_tp.py): a leaf with axes within
# 2e-2 relative L2, a 0-d scale within 0.2 of its kind's RMS over the
# block; the output, whose only cross-rank sum is the row-parallel g_out /
# xo, mostly bit-equal: 90 % of |d| below 1e-3, the mean below 0.05
RT_GRAD_BAR, RT_SCALAR_BAR = 2e-2, 0.2


def rt_block(torch, kind: str, mesh=None) -> dict:
    """(b) kind "rglru": one full-width RG-LRU block of recurrentgemma-9b
    (d 4096, lru_width 4096, conv 4), (c) "cross": one full-width
    cross-attention sublayer of llama-3.2-vision-11b (32 q / 8 kv heads of
    128, 1024 stub patches), w4a4, bf16, seeded (`RT_BLOCK_SEED`): its
    output, the input's gradient and every leaf's for a seeded cotangent,
    whole (mesh None) or on `mesh`'s model ranks, the split linears cut to
    this rank's slices by the sharding rules (`layer_tp`'s names; the rest
    whole, as `Spmd.gather` gives it). Returns host tensors and each leaf's
    model-split axis (None: replicated)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.policy import get_preset
    from repro_torch.dist import sharding as shard
    from repro_torch.dist.spmd import Spmd
    from repro_torch.models import model as M
    from repro_torch.models import recurrent as R
    qcfg = get_preset("w4a4")
    gen = torch.Generator(device="cuda").manual_seed(RT_BLOCK_SEED)
    bf16 = torch.bfloat16
    if kind == "rglru":
        cfg = get_config("recurrentgemma-9b")
        p, names = R.rglru_init(gen, cfg, qcfg, device="cuda"), M.RGLRU_LINEARS
    else:
        cfg = get_config("llama-3.2-vision-11b")
        p, names = M._attn_init(gen, cfg, qcfg, "cuda", cross=True), M.CROSS_LINEARS
        p["xgate"] = torch.full((), 0.5, device="cuda")
    for sub in p.values():
        if isinstance(sub, dict) and "a_scale" in sub:
            sub["a_scale"] = torch.full((), 0.1, device="cuda")
            sub["a_offset"] = torch.full((), -0.5, device="cuda")
    b, s = RT_BLOCK_ROWS
    x = torch.randn((b, s, cfg.d_model), generator=gen, device="cuda").to(bf16)
    dy = torch.randn((b, s, cfg.d_model), generator=gen, device="cuda").to(bf16)
    embeds = (torch.randn((b, cfg.n_frontend_tokens, cfg.d_model), generator=gen,
                          device="cuda").to(bf16) if kind == "cross" else None)
    tp, dims = None, {}
    if mesh is not None:
        specs = shard.param_pspecs(p, mesh)
        tp = Spmd(mesh, specs).tp((), names)
        if tp is None:
            fail(f"({kind}) the rules do not split {names} over {mesh.shape}")
        for name in names:
            p[name] = {k: shard.local_shard(v, specs[name][k], mesh, mesh.coords).clone()
                       for k, v in p[name].items()}
            for k in p[name]:
                dims[f"{name}/{k}"] = next((i for i, e in enumerate(specs[name][k] or ())
                                            if "model" in shard.spec_axes(e)), None)
    leaves = [(f"{name}/{k}" if isinstance(sub, dict) else name, v)
              for name, sub in sorted(p.items())
              for k, v in (sorted(sub.items()) if isinstance(sub, dict) else [(None, sub)])]
    for _, v in leaves:
        v.requires_grad_(True)
    x.requires_grad_(True)
    if kind == "rglru":
        y, _ = R.rglru_block(p, x, cfg, qcfg, bf16, tp=tp)
    else:
        kv = M.cross_kv(p, embeds, cfg, qcfg, bf16, tp)
        y = M._cross_sublayer(p, x, kv, cfg, qcfg, bf16, tp)
    gs = torch.autograd.grad(torch.sum(y.float() * dy.float()), [v for _, v in leaves] + [x])
    out = {"y": y.detach().float().cpu(), "dx": gs[-1].float().cpu(),
           "grads": {k: g.cpu() for (k, _), g in zip(leaves, gs)}, "dims": dims,
           "x": x.detach().float().cpu()}
    del p, leaves, gs, y
    torch.cuda.empty_cache()
    return out


def recurrent_tp_rank(torch, rank: int, out_dir: str) -> None:
    """Phase 28's part of a rank (`cells_rank`): cell K's QAT on a (2, 2)
    mesh, tensor-parallel (the mLSTM on heads, the sLSTM's FFN on d_ff),
    then (b) and (c) on a (1, 4) mesh; writes its numbers to
    DIR/rank{R}.json and its blocks' results to DIR/{kind}{R}.pt."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.policy import get_preset
    from repro_torch.dist import sharding, spmd
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as M
    ops.reset_launch_counts()
    spmd.reset_moved_bytes()
    t0 = time.perf_counter()
    rep = train.main(RT_TRAIN + ["--ckpt", str(Path(out_dir) / "ckpt"),
                                 "--model-parallel", str(RT_TRAIN_MODEL)])
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    cfg = get_config("xlstm-350m").replace(n_layers=8)
    like = M.init_params(cfg, get_preset("w4a4"), torch.Generator(), "meta")
    sp = spmd.Spmd(rep.mesh, sharding.param_pspecs(like, rep.mesh))
    res = {"train": {"wall_s": time.perf_counter() - t0, "losses": rep.losses,
                     "grad_norms": rep.grad_norms, "healths": rep.healths,
                     "step_seconds": rep.step_seconds, "state_bytes": rep.state_bytes,
                     "peak_bytes": rep.peak_bytes, "moved_bytes": spmd.moved_bytes(),
                     "moved_by_use": spmd.moved_bytes_by_use(),
                     "collect_s": spmd.collect_seconds(), "launches": launches,
                     "coords": rep.mesh.coords, "mesh": rep.mesh.shape,
                     "tp": [[t is not None for t in M.layer_tp(sp, cfg, i)[:3]]
                            for i in range(cfg.n_layers)]}}
    del rep
    torch.cuda.empty_cache()
    mesh = make_host_mesh(RT_BLOCK_MODEL, "cuda")
    for kind in ("rglru", "cross"):
        t0 = time.perf_counter()
        torch.save(rt_block(torch, kind, mesh), Path(out_dir) / f"{kind}{rank}.pt")
        res[f"{kind}_s"] = time.perf_counter() - t0
    with open(Path(out_dir) / f"rank{rank}.json", "w") as f:
        json.dump(res, f)


def rt_block_check(torch, kind: str, out_dir: Path) -> dict:
    """(b) / (c): the ranks' block (`rt_block` on the (1, 4) mesh) against
    the whole block here: the output and the input's gradient the same
    bits on every rank, held to RT's output bar; every leaf's gradient,
    the slices concatenated in rank order (a replicated leaf's the same
    bits on every rank), to the gradient bars."""
    parts = [torch.load(out_dir / f"{kind}{r}.pt") for r in range(SHARDED_RANKS)]
    whole = rt_block(torch, kind)
    for key in ("y", "dx", "x"):
        if not all(torch.equal(p[key], parts[0][key]) for p in parts[1:]):
            fail(f"({kind}) the ranks' {key} differ")
    if not torch.equal(parts[0]["x"], whole["x"]):
        fail(f"({kind}) the ranks' input is not the whole block's")
    d = (parts[0]["y"] - whole["y"]).abs()
    fwd = {"q90": float(d.quantile(0.9)) if d.numel() <= 2 ** 24 else
           float(d.flatten()[::4].quantile(0.9)),
           "mean": float(d.mean()), "max": float(d.max()),
           "bit_equal": float((d == 0).float().mean())}
    grads = {"dx": (parts[0]["dx"], whole["dx"])}
    for key, w in whole["grads"].items():
        dim = parts[0]["dims"].get(key)
        if dim is None:
            if not all(torch.equal(p["grads"][key], parts[0]["grads"][key])
                       for p in parts[1:]):
                fail(f"({kind}) {key}'s gradient differs between the ranks")
            grads[key] = (parts[0]["grads"][key], w)
        else:
            grads[key] = (torch.cat([p["grads"][key] for p in parts], dim), w)
    rels, kinds = {}, {}
    for key, (g, w) in grads.items():
        if g.shape != w.shape or not torch.isfinite(g).all():
            fail(f"({kind}) {key}'s gradient: shape {tuple(g.shape)} vs "
                 f"{tuple(w.shape)}, or not finite")
        if g.dim() == 0 and key.split("/")[-1] in ("w_scale", "a_scale", "a_offset"):
            kinds.setdefault(key.split("/")[-1], []).append((key, float(g), float(w)))
        else:
            rels[key] = float((g.float() - w.float()).norm() / max(float(w.float().norm()),
                                                                  1e-30))
    scal = {}
    for name, leaves in kinds.items():
        rms = (sum(w * w for _, _, w in leaves) / len(leaves)) ** 0.5
        scal[name] = max((abs(g - w) / rms, key) for key, g, w in leaves)
    worst = max(rels.items(), key=lambda kv: kv[1])
    log(f"  ({kind}) over {SHARDED_RANKS} ranks vs the whole block: output {fwd}; "
        f"worst gradient {worst} (bar {RT_GRAD_BAR}), every leaf "
        f"{ {k: round(v, 6) for k, v in rels.items()} }; scales (of their kind's RMS, bar "
        f"{RT_SCALAR_BAR}) {scal}")
    if (fwd["q90"] >= 1e-3 or fwd["mean"] >= 0.05 or worst[1] >= RT_GRAD_BAR
            or any(v[0] >= RT_SCALAR_BAR for v in scal.values())):
        fail(f"({kind}) the tensor-parallel block departs from the whole block")
    return {"forward": fwd, "grad_rel": rels, "worst": worst, "scales": scal}


def cell_v_phase(torch, cell_k: dict, ranks: list, out_dir: Path, wall: float) -> dict:
    """Phase 28's checks (see the docstring): (a) against cell K (phase
    16), (b) and (c) against the whole block; `ranks`, `out_dir` and
    `wall` as for `cell_s_phase`."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.policy import get_preset
    base, gbase = cell_k["losses"][:3], cell_k["grad_norms"][:3]
    tr0 = ranks[0]["train"]
    losses, gnorms = tr0["losses"], tr0["grad_norms"]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, base)]
    grel = [abs(a - b) / abs(b) for a, b in zip(gnorms, gbase)]
    cfg = get_config("xlstm-350m").replace(n_layers=8)
    tokens = 8 * 512 // (SHARDED_RANKS // RT_TRAIN_MODEL)
    per_step = None
    for r, res in enumerate(ranks):
        tr = res["train"]
        steady = tr["step_seconds"][1:] or tr["step_seconds"]
        log(f"  rank {r} {tr['coords']}: train {tr['wall_s']:.1f} s, s/step "
            f"{[round(x, 3) for x in tr['step_seconds']]} (median after the first "
            f"{statistics.median(steady):.3f}), state {tr['state_bytes'] / 2**30:.3f} GiB, "
            f"peak {tr['peak_bytes'] / 2**30:.2f} GiB, collectives a step "
            f"{ {k: v / len(losses) for k, v in tr['moved_bytes'].items()} } B by kind, "
            f"{ {k: v / len(losses) for k, v in tr['moved_by_use'].items()} } B by use, "
            f"{tr['collect_s']:.1f} s inside spmd.collect; split (mixer, FFN, cross) "
            f"{tr['tp']}")
        if (tr["losses"] != losses or tr["grad_norms"] != gnorms
                or any(tr["healths"])):
            fail(f"cell V rank {r}'s losses / norms / health differ: {tr['losses']} "
                 f"{tr['grad_norms']} {tr['healths']}")
        want_tp = [[cfg.block_at(i).attn == "mlstm", cfg.block_at(i).attn == "slstm",
                    False] for i in range(cfg.n_layers)]
        if tr["tp"] != want_tp:
            fail(f"cell V rank {r}: the mLSTM / sLSTM FFN not split: {tr['tp']}")
        per_step = check_launches({"cfg": cfg, "qcfg": get_preset("w4a4"), "counts": {
            k: tr["launches"][k] for k in QAT_KERNELS}}, len(losses), tokens,
            tp_parts=RT_TRAIN_MODEL)
    if per_step != cell_k["launches_per_step"]:
        fail(f"cell V's launches a step {per_step} != cell K's "
             f"{cell_k['launches_per_step']}")
    log(f"  cell V losses {losses} vs cell K's {base}: rel {rel} (bars: step 0 "
        f"{RT_LOSS0_BAR}, every step {RT_LOSS_BAR}); gradient norms {gnorms} vs "
        f"{gbase}: gap {grel[:2]} at steps 0-1 (bar {RT_GNORM_BAR})")
    if (not all(x == x for x in losses + gnorms) or rel[0] > RT_LOSS0_BAR
            or max(rel) > RT_LOSS_BAR or max(grel[:2]) > RT_GNORM_BAR):
        fail(f"cell V losses {losses} / norms {gnorms} vs {base} / {gbase}")
    blocks = {kind: rt_block_check(torch, kind, out_dir) for kind in ("rglru", "cross")}
    steady = [statistics.median(r["train"]["step_seconds"][1:]) for r in ranks]
    log(f"  cell V s/step a rank (median after the first) {steady} vs cell K's "
        f"{cell_k['s_per_step']:.3f} (one process); peaks "
        f"{[round(r['train']['peak_bytes'] / 2**30, 3) for r in ranks]} GiB vs K's "
        f"{cell_k['peak_gib']:.2f}; blocks' seconds a rank "
        f"{[(r['rglru_s'], r['cross_s']) for r in ranks]}; wall {wall:.1f} s")
    n = len(losses)
    return {"wall_s": wall, "train": {
        "losses": losses, "losses_k": base, "rel": rel, "grad_norms": gnorms,
        "grad_norm_rel": grel[:2], "launches_per_step": per_step,
        "s_per_step": steady,
        "step_seconds": [r["train"]["step_seconds"] for r in ranks],
        "state_gib": [r["train"]["state_bytes"] / 2**30 for r in ranks],
        "peak_gib": [r["train"]["peak_bytes"] / 2**30 for r in ranks],
        "moved_per_step": [{k: v / n for k, v in r["train"]["moved_bytes"].items()}
                           for r in ranks],
        "moved_by_use_per_step": [{k: v / n for k, v in r["train"]["moved_by_use"].items()}
                                  for r in ranks],
        "collect_s": [r["train"]["collect_s"] for r in ranks]},
        "blocks": blocks}


# ---------------------------------------------------------------------------
# phase 12: MoE serving
# ---------------------------------------------------------------------------

def slot_independence(torch, M, run) -> dict:
    """A slot's decode logits are the same bits alone, in a pool of 4 and
    beside 3 idle slots (pos = -1), after the same 16-token prefill of each
    slot inserted as the engine does."""
    cfg, qcfg, params, dev = run.cfg, run.qcfg, run.params, run.device
    plen, max_len = 16, 20
    prompts = torch.from_numpy(run.prompts[:4, :plen]).to(dev)
    nxt = torch.from_numpy(run.prompts[:4, plen:plen + 1]).to(dev)
    pos = torch.arange(plen, dtype=torch.int32, device=dev)[None]

    def decode(rows, idle=()):
        pool = M.init_cache(cfg, qcfg, rows, max_len, dev)
        for r in range(rows):  # each slot's own prefill, inserted as the engine does
            one = M.init_cache(cfg, qcfg, 1, max_len, dev)
            M.prefill_step(params, one, {"tokens": prompts[r:r + 1], "pos": pos}, cfg, qcfg)
            M.cache_slot_insert(pool, one, r)
        dpos = torch.full((rows, 1), plen, dtype=torch.int32, device=dev)
        dpos[list(idle)] = -1
        lg, _ = M.decode_step(params, pool, {"tokens": nxt[:rows], "pos": dpos}, cfg, qcfg)
        return lg[0, 0]

    alone, pooled, beside_idle = decode(1), decode(4), decode(4, (1, 2, 3))
    torch.cuda.synchronize()
    return {"pool_eq_alone": _same_bits(torch, pooled, alone),
            "idle_eq_alone": _same_bits(torch, beside_idle, alone)}


def check_moe_row_independence(torch, M, run) -> dict:
    """A token's MoE-layer output (router, experts, combine) is the same bits
    at M 1, 4 and 32 (capacities 8, 8 and 16), and a slot's decode logits
    the same bits alone, in a pool of 4 and beside 3 idle slots (pos = -1:
    routed, taking capacity), after the same 16-token prefill: the router's
    f32 product runs in fixed 128-row blocks, the experts' bf16 products in
    8-row blocks, and softmax, the stable sort and the k-sum are per row.
    The token is first in every expert's capacity order, so never dropped."""
    from repro_torch.models import moe
    cfg, qcfg, params, dev = run.cfg, run.qcfg, run.params, run.device
    gen = torch.Generator(device=dev).manual_seed(100 * SEED + 12)
    p = params["layers"][0]["moe"]
    x = torch.randn((1, 32, cfg.d_model), generator=gen, device=dev).to(torch.bfloat16)
    outs = [moe.moe_ffn(p, x[:, :m], cfg, qcfg, torch.bfloat16)[0][0, 0]
            for m in (1, 4, 32)]
    torch.cuda.synchronize()
    res = {"moe_m_1_4_32": all(_same_bits(torch, o, outs[0]) for o in outs[1:]),
           **slot_independence(torch, M, run)}
    log(f"  MoE layer 0, token 0 at M 1, 4, 32: same bits {res['moe_m_1_4_32']}; "
        f"decode logits of slot 0 in a pool of 4 == alone: {res['pool_eq_alone']}; "
        f"beside 3 idle slots == alone: {res['idle_eq_alone']}")
    if not all(res.values()):
        fail(f"MoE serving: a row's bits depend on its pool: {res}")
    return res


def expert_dequant(torch, run) -> dict:
    """What the serving fallback's expert dequantization costs a decode step:
    every layer's three expert weights unpacked and scaled to bf16 as
    `common._serving_linear` does (bf16(code) x bf16(scale)); CUDA events
    around the whole step's set (72 weights, far past L2), median of 5."""
    from repro_torch.core.quantizer import unpack_int4
    from repro_torch.models.common import pack_axis_of
    ws = [(lay["moe"][n], n) for lay in run.params["layers"]
          for n in ("moe_in", "moe_gate", "moe_out") if n in lay["moe"]]

    def step():
        for p, n in ws:
            codes = p["codes4"]
            unpack_int4(codes, pack_axis_of(n) % codes.dim()).to(torch.bfloat16) \
                * p["w_scale"].to(torch.bfloat16)

    step()
    times = []
    for _ in range(5):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        step()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    read = sum(p["codes4"].numel() for p, _ in ws)
    written = 2 * 2 * read  # two codes a byte, two bytes a bf16 weight
    ms = statistics.median(times)
    res = {"ms_per_decode_step": ms, "weights": len(ws), "bytes_read": read,
           "bytes_written": written,
           "bound_ms": bound(read + written, 0)[0]}
    log(f"  expert dequantization a decode step: {ms:.3f} ms for {len(ws)} weights "
        f"({read / 1e9:.3f} GB of codes read, {written / 1e9:.3f} GB bf16 written; "
        f"bound {res['bound_ms']:.3f} ms)")
    return res


def moe_serve_checks(torch, M):
    """Phase 12's checks beyond serve_phase's: row independence, the expert
    dequantization's cost, and a 4-layer cut's logits against the CPU."""
    def checks(run) -> dict:
        indep = check_moe_row_independence(torch, M, run)
        dq = expert_dequant(torch, run)
        cut_against_cpu(torch, M, run)
        return {"independence": indep, "expert_dequant": dq}
    return checks


def cut_against_cpu(torch, M, run, layers: int = 4) -> None:
    """The run's model cut to its first `layers` layers, its logits on a
    16-token prompt against the CPU's (phase 4's bars), at the run's KV
    cache and at an fp one."""
    cut = copy.copy(run)
    cut.cfg = run.cfg.replace(n_layers=layers)
    cut.params = dict(run.params, layers=run.params["layers"][:layers])
    log(f"  {layers}-layer cut against the CPU:")
    check_against_cpu(torch, M, cut, run.qcfg)
    check_against_cpu(torch, M, cut, run.qcfg.replace(kv_cache_bits=0))


def dense_serve_checks(torch, M):
    """Phase 13's checks beyond serve_phase's: a slot's decode logits the
    same bits alone, pooled and beside idle slots (layernorm's f64 row
    means, learned positions gathered per row at max(pos, 0)), and a
    4-layer cut's logits against the CPU."""
    def checks(run) -> dict:
        res = slot_independence(torch, M, run)
        log(f"  decode logits of slot 0 in a pool of 4 == alone: "
            f"{res['pool_eq_alone']}; beside 3 idle slots == alone: "
            f"{res['idle_eq_alone']}")
        if not all(res.values()):
            fail(f"{run.cfg.name} serving: a row's bits depend on its pool: {res}")
        cut_against_cpu(torch, M, run)
        return {"independence": res}
    return checks


# ---------------------------------------------------------------------------
# phase 5: the QAT kernels against their plain versions
# ---------------------------------------------------------------------------

QAT_QS = dict(q_n_a=0, q_p_a=15, q_n_w=8, q_p_w=7)    # w4a4: LSQ+ acts, 4-bit w
HEAD_QS = dict(q_n_a=0, q_p_a=255, q_n_w=128, q_p_w=127)  # 8-bit edges


def _bf16_ulp(torch, v):
    a = v.abs().double()
    e = torch.floor(torch.log2(torch.where(a > 0, a, torch.ones_like(a))))
    return torch.where(a > 0, 2.0 ** (e - 7), torch.zeros_like(a))


def _bf16_close(torch, got, want, abs_products, length) -> tuple[float, float]:
    """The CPU tests' bar for dX / dW: each element within one bf16 ulp plus
    the order-independent bound on two f32 sums of `length` products
    (2 * length * 2**-24 * sum|products|), and at most 1% differing.
    Returns (worst excess over the bound, fraction differing)."""
    d = (got.double() - want.double()).abs()
    tol = (_bf16_ulp(torch, torch.maximum(got.abs(), want.abs()))
           + 2 * length * 2.0 ** -24 * abs_products.double())
    return (d - tol).max().item(), (d > 0).double().mean().item()


def qat_operands(torch, m, k, n, k_side, gen, qs, x_dtype=None):
    dev = "cuda"
    x = (torch.randn((m, k), generator=gen, device=dev) * 2).to(
        x_dtype or torch.bfloat16)
    w = torch.randn((k, n), generator=gen, device=dev) * k ** -0.5
    ws = torch.rand((k, 1) if k_side else (1, n), generator=gen, device=dev)
    ws = ws * 0.05 + 0.02
    if qs["q_p_w"] > 7:  # 8-bit edge: scales that use the 8-bit range
        ws = ws * 0.1
    a_s = torch.tensor({15: 0.3, 7: 0.6}.get(qs["q_p_a"], 0.02), device=dev)
    a_b = torch.tensor(-0.2, device=dev)
    return x, w, a_s, a_b, ws


def _order_excess(torch, got, want, xd, wd, length) -> float:
    """Worst excess of |got - want| over the order-independent bound on two
    f32 sums of the same `length` exact products, 2 * length * 2**-24 *
    (|xd| @ |wd|) (<= 0: every element within it)."""
    abs_products = torch.matmul(xd.abs(), wd.abs())
    excess = ((got - want).abs() - 2 * length * 2.0 ** -24 * abs_products).max().item()
    del abs_products
    return excess


# the QAT forwards' max|err| bar: 1e-5 x max|y| up to a contraction of
# FWD_BAR_K (granite-8b's and qwen's FFN rows), growing in proportion to K
# past it, as the f32 order bound 2 K 2^-24 (|xd| @ |wd|) does: two f32
# sums of the same products drift apart with K (kernel 2 at (8, 1280,
# 4096, 896): 7.87e-5 against 1e-5 x max|y| = 6.82e-5, every element inside
# its order bound). Each row also holds the bar below the error of its
# output rounded to bf16 (about 2^-9 x max|y|), so that a kernel that
# rounded its output would fail it at every K.
FWD_BAR_K = 2816


def fwd_bar(torch, y_r, k: int):
    """(tol, bf16_err): the forward's max|err| bar at contraction k, and the
    largest error of the plain output rounded to bf16."""
    tol = 1e-5 * y_r.abs().max().item() * max(1.0, k / FWD_BAR_K)
    bf16_err = (y_r.to(torch.bfloat16).float() - y_r).abs().max().item()
    return tol, bf16_err


def check_qat_fwd(torch, timer, qmm, ref, m, k, n, k_side, gen, qs,
                  x_dtype=None) -> dict:
    """quant_matmul (the tensor-core path) against its plain version: within
    `fwd_bar` and, element by element, within the f32 order bound; a second
    launch on the same inputs gives the same bits; the prologue alone
    bit-equal to the plain dequantization."""
    x, w, a_s, a_b, ws = qat_operands(torch, m, k, n, k_side, gen, qs, x_dtype)
    args = (x, w, a_s, a_b, ws)
    kern = lambda: qmm.quant_matmul(*args, **qs)
    plain = lambda: ref.quant_matmul(*args, **qs)
    y_k, y_r = kern(), plain()
    again = kern()
    torch.cuda.synchronize()
    repeat = _same_bits(torch, y_k, again)
    del again
    err = (y_k - y_r).abs().max().item()
    tol, bf16_err = fwd_bar(torch, y_r, k)
    _, _, xd = ref._act_codes(x, a_s, a_b, qs["q_n_a"], qs["q_p_a"])
    _, _, wd = ref._weight_codes(w, ws, qs["q_n_w"], qs["q_p_w"])
    excess = _order_excess(torch, y_k, y_r, xd, wd, k)
    del y_k, y_r
    same, prologue_ms, _ = check_prologue(torch, timer, qmm, ref, args, qs)
    xd, wd = xd.to(torch.bfloat16), wd.to(torch.bfloat16)
    lib = lambda: torch.matmul(xd, wd)
    checks = [("max|err|", err <= tol, f"{err:.3e}, tol {tol:.3e}"),
              ("bar", tol < bf16_err, f"below a bf16 output's {bf16_err:.3e}"),
              ("order", excess <= 0, f"excess {excess:.2e}"),
              ("repeat", repeat, "same bits on a second launch"),
              ("prologue", same, "bit-equal to the plain dequantization")]
    nbytes = m * k * x.element_size() + k * n * 4 + ws.numel() * 4 + 8 + m * n * 4
    b_ms, b_by = bound(nbytes, 2.0 * m * k * n)
    row = {"shape": [m, k, n], "w_scale": "rows" if k_side else "cols",
           "x": str(x.dtype)[6:], "path": "tc", "max_abs_err": err, "tol": tol,
           "bf16_err": bf16_err, "order_excess": excess, "ms": timer.ms(kern),
           "plain_ms": timer.ms(plain), "library_ms": timer.ms(lib),
           "bound_ms": b_ms, "bound_by": b_by, "prologue_ms": prologue_ms}
    log(f"  quant_matmul [tc] M={m} K={k} N={n} ({row['w_scale']} scales, "
        f"{row['x']} x): "
        + "; ".join(f"{c} {'ok' if ok else 'FAIL'} ({msg})" for c, ok, msg in checks)
        + f"; kernel {row['ms']:.4f} ms, prologue {prologue_ms:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, torch.matmul(bf16 dequant) "
        f"{row['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    bad = [c for c, ok, _ in checks if not ok]
    if bad:
        fail(f"quant_matmul {m}x{k}x{n} disagrees with its plain version on {bad}")
    return row


def check_prologue(torch, timer, qmm, ref, args, qs, planes=None):
    """A tensor-core prologue alone against the plain dequantization: the
    forward's (args x, w, a_s, a_b, ws; x (M, K) or (E, M, K)) xd and wd, or
    the backward's (dY first) xd, wd and the cotangent's `planes` bf16
    planes (1: bf16(dY); 3: its exact split), zero-padded; bit for bit.
    Returns (equal, its ms, the kernel's planes or None)."""
    name, scratch = (("fwd_prologue", qmm._fwd_tc_scratch) if len(args) == 5
                     else ("bwd_prologue", qmm._bwd_tc_scratch))
    kw = dict(qs) if planes is None else dict(qs, planes=planes)
    kern = lambda: getattr(qmm, name)(*args, **kw)
    m, k = args[-5].shape[-2:]
    lds, _ = scratch(m, k, args[-4].shape[-1])
    got = kern()
    want = getattr(ref, name)(*args, lds=lds, **kw)
    torch.cuda.synchronize()
    same = all(_same_bits(torch, a, b) for a, b in zip(got, want))
    del want
    return same, timer.ms(kern), (got[2] if planes else None)


def check_split(torch, planes, dy, n) -> tuple[bool, int, float]:
    """The kernel's three planes (3, M, ld_y) against the exact split's
    contract: hi + mid + lo == dY in f64 for every |dY| >= 2**-110, and
    within 2**-134 below that. Returns (holds, the count of nonzero |dY|
    below 2**-110, the worst error below it)."""
    holds, below, worst = True, 0, 0.0
    for r0 in range(0, dy.shape[0], 512):  # row blocks: f64 copies of the head are 5 GB
        y = dy[r0:r0 + 512].double()
        s = sum(planes[p, r0:r0 + 512, :n].double() for p in range(3))
        tiny = (y.abs() < 2.0 ** -110) & (y != 0)
        err = (s - y).abs()
        holds = holds and bool((err[~tiny] == 0).all()) and bool((err[tiny] <= 2.0 ** -134).all())
        below += int(tiny.sum().item())
        worst = max(worst, err[tiny].max().item() if bool(tiny.any()) else 0.0)
    return holds, below, worst


def check_qat_bwd(torch, timer, qmm, ref, name, m, k, n, k_side, round_cot,
                  gen, qs, x_dtype=None) -> dict:
    """quant_matmul_bwd (combined) or quant_matmul_dx / _dw (split) against
    the plain versions; the scalar and per-column sums within 1e-4 of their
    sum of |summands| (dws, as in phase 5b, may also differ by its
    differing bf16(xd^T dY) summands x |q - mf u|, read from a launch with
    w = 0: those must be the real dW where w is in range and meet the dW
    bar); a second launch on the same inputs gives the same bits; the
    prologue bit-equal to the plain dequantization and the cotangent's
    planes. Everything runs on the tensor cores, f32 cotangents as three
    planes whose sum must be dY exactly. With bf16 cotangents, where
    quant_matmul_bwd's route is the combined one too, the split dx / dw
    outputs must equal its bits; an f32 combined row whose dW contraction
    is one range (`dw_splits`) must equal the split route's bits in all
    five outputs, and prints the split route's time beside its own. Every
    f32 row that computes dW prints the shares of bf16(xd^T dY) off its
    correctly rounded value (an f64 product) in the kernel and in the
    plain version, and how far correctly rounded summands would put dws
    from the plain dws (ROADMAP Queue 3)."""
    x, w, a_s, a_b, ws = qat_operands(torch, m, k, n, k_side, gen, qs, x_dtype)
    dy = torch.randn((m, n), generator=gen, device="cuda")
    kw = dict(round_cot=round_cot, **qs)
    args = (dy, x, w, a_s, a_b, ws)
    fn = getattr(qmm, name)
    plain_fn = getattr(ref, name)
    kern = lambda: fn(*args, **kw)
    plain = lambda: plain_fn(*args, **kw)
    path = qmm.bwd_route(m, k, n) if name == "quant_matmul_bwd" else "tc"
    planes = qmm.plane_count(round_cot)
    splits = qmm.dw_splits(m, k, n, planes)[0] if name == "quant_matmul_bwd" else 1
    got, want = kern(), plain()
    again = kern()
    torch.cuda.synchronize()
    repeat = all(_same_bits(torch, a, b) for a, b in zip(got, again))
    del again
    u_x, q_x, xd = ref._act_codes(x, a_s, a_b, qs["q_n_a"], qs["q_p_a"])
    u_w, q_w, wd = ref._weight_codes(w, ws, qs["q_n_w"], qs["q_p_w"])
    cot = ref._cotangent(dy, round_cot)
    checks, worst = [("repeat", repeat, "same bits on a second launch")], 0.0
    split = vs_plain = past = summands = None
    same, prologue_ms, dyb = check_prologue(torch, timer, qmm, ref, args, qs, planes)
    checks.append(("prologue", same, f"bit-equal to the plain dequantization, "
                   f"{planes} plane{'s' * (planes > 1)}"))
    if planes == 3:
        holds, below, err = check_split(torch, dyb, dy, n)
        split = {"exact": holds, "below_2^-110": below, "worst_below": err}
        checks.append(("split", holds, f"hi + mid + lo == dY in f64 over all {m * n} "
                       f"cotangents; {below} below 2^-110"))
    del dyb
    if name != "quant_matmul_bwd" and round_cot and qmm.bwd_route(m, k, n) == "tc":
        both = qmm.quant_matmul_bwd(*args, **kw)
        mine = both[:3] if name == "quant_matmul_dx" else both[3:]
        checks.append(("as combined", all(_same_bits(torch, a, b) for a, b in zip(got, mine)),
                       "bit-equal to quant_matmul_bwd's tensor-core outputs"))
        del both, mine
    if name == "quant_matmul_bwd" and not round_cot and splits == 1:
        routed = qmm._split_bwd(*args, qs, round_cot)
        checks.append(("as split", all(_same_bits(torch, a, b) for a, b in zip(got, routed)),
                       "one dW range: bit-equal to the split route in all five"))
        del routed
    if name in ("quant_matmul_bwd", "quant_matmul_dx"):
        dx_abs = cot.abs() @ wd.abs().T
        ex, frac = _bf16_close(torch, got[0], want[0], dx_abs, n)
        del dx_abs
        mf = ref._in_range(u_x, qs["q_n_a"], qs["q_p_a"])
        dxd = ref._bf16(cot @ wd.T)
        l1a = (dxd * (q_x - mf * u_x)).abs().sum().item()
        l1b = (dxd * (1 - mf)).abs().sum().item()
        del dxd, mf
        checks += [("dX", ex <= 0 and frac <= 0.01, f"excess {ex:.2e}, differing {frac:.2e}"),
                   ("dsa", abs(got[1].item() - want[1].item()) <= 1e-4 * l1a,
                    f"{abs(got[1].item() - want[1].item()):.3e} vs 1e-4 x {l1a:.3e}"),
                   ("dba", abs(got[2].item() - want[2].item()) <= 1e-4 * l1b,
                    f"{abs(got[2].item() - want[2].item()):.3e} vs 1e-4 x {l1b:.3e}")]
        worst = max(worst, (got[0] - want[0]).abs().max().item())
    if name in ("quant_matmul_bwd", "quant_matmul_dw"):
        at = 3 if name == "quant_matmul_bwd" else 0
        gw, ww, rw, rws = got[at], got[at + 1], want[at], want[at + 1]
        dw_abs = xd.abs().T @ cot.abs()
        ex, frac = _bf16_close(torch, gw, rw, dw_abs, m)
        mf = ref._in_range(u_w, qs["q_n_w"], qs["q_p_w"])
        dwd = ref._bf16(xd.T @ cot)
        fac = (q_w - mf * u_w).abs()
        axis = 1 if k_side else 0
        l1 = (dwd.abs() * fac).sum(dim=axis, keepdim=True)
        # phase 5b's allowance (ROADMAP Queue 3): the tile's f32 order
        # rounds some bf16(xd^T dY) summands to the other bf16 neighbour
        # (the dW bar allows that), and at clipped weights (|q - mf u| up
        # to 4 at 3 bits) one such flip can move a sum past 1e-4 x
        # sum|summands|; so each sum may also differ by its differing
        # summands x |q - mf u|. The kernel's summands come from a launch
        # with w = 0 (every code in range): they must be the real dW
        # wherever w is in range and meet the dW bar.
        dwd_k = fn(dy, x, torch.zeros_like(w), a_s, a_b, ws, **kw)[at]
        real = bool(torch.equal(gw, dwd_k * mf))
        ex_d, fr_d = _bf16_close(torch, dwd_k, dwd, dw_abs, m)
        flips = ((dwd_k - dwd).abs() * fac).sum(dim=axis, keepdim=True)
        checks += [("summands", real, "the w = 0 launch's bf16(xd^T dY) is the real dW "
                    "where in range"),
                   ("xd^T dY", ex_d <= 0 and fr_d <= 0.01,
                    f"every element: excess {ex_d:.2e}, differing {fr_d:.2e}")]
        if not round_cot:
            summands = summand_shares(torch, ref, dwd_k, dwd, xd, cot, q_w - mf * u_w,
                                      lambda t: t.sum(dim=axis, keepdim=True), rws, l1)
        del dwd_k, dw_abs, dwd, fac, mf
        gap = (ww - rws).abs()
        allowed = 1e-4 * l1 + flips
        dws_ok = bool((gap <= allowed).all())
        past = int((gap > 1e-4 * l1).sum().item())
        vs_plain = (gap / (1e-4 * l1).clamp_min(1e-30)).max().item()
        use = (gap / allowed.clamp_min(1e-30)).max().item()
        checks += [("dW", ex <= 0 and frac <= 0.01, f"excess {ex:.2e}, differing {frac:.2e}"),
                   ("dws", dws_ok, f"max {gap.max().item():.3e}, {vs_plain:.3f} x the plain "
                    f"bar, {use:.3f} of the allowance; {past} sums past the plain bar")]
        del gap, l1, flips, allowed
        worst = max(worst, (gw - rw).abs().max().item())
    del got, want
    # yardstick: the two products on operands dequantized beforehand
    ct = cot.to(torch.bfloat16) if round_cot else cot
    xl = xd.to(torch.bfloat16) if round_cot else xd
    wl = wd.to(torch.bfloat16) if round_cot else wd
    libs = {"quant_matmul_dx": lambda: ct @ wl.T, "quant_matmul_dw": lambda: xl.T @ ct,
            "quant_matmul_bwd": lambda: (ct @ wl.T, xl.T @ ct)}
    products = 2 if name == "quant_matmul_bwd" else 1
    outs = {"quant_matmul_dx": m * k * 4 + 8, "quant_matmul_dw": k * n * 4 + ws.numel() * 4,
            "quant_matmul_bwd": m * k * 4 + 8 + k * n * 4 + ws.numel() * 4}[name]
    nbytes = (m * n * 4 + m * k * x.element_size() + k * n * 4 + ws.numel() * 4
              + 8 + outs)
    ops = 2.0 * m * k * n * products
    # f32 cotangents: the f32 line, and the line of the three planes' bf16
    # products on the tensor cores (the least time for this kernel's work)
    b32 = None if round_cot else bound(nbytes, ops, F32_OPS_PER_S)[0]
    b_ms, b_by = bound(nbytes, ops * planes)
    row = {"shape": [m, k, n], "w_scale": "rows" if k_side else "cols",
           "round_cot": round_cot, "path": path, "planes": planes, "dw_splits": splits,
           "x": str(x.dtype)[6:], "max_abs_err": worst,
           "tol": "bf16 ulp + f32 order bound; sums 1e-4 x sum|summands|",
           "ms": timer.ms(kern), "plain_ms": timer.ms(plain),
           "library_ms": timer.ms(libs[name]), "bound_ms": b_ms, "bound_by": b_by,
           "bound_f32_ms": b32, "prologue_ms": prologue_ms, "split": split,
           "dws_vs_plain": vs_plain, "dws_past_plain": past, "summands": summands}
    if name != "quant_matmul_bwd":  # the grid and its finish: the call less its prologue
        row["grid_tflops"] = ops * planes / (row["ms"] - prologue_ms) / 1e9
    if name == "quant_matmul_bwd" and not round_cot:  # the split route on the same inputs
        row["split_route_ms"] = timer.ms(lambda: qmm._split_bwd(*args, qs, round_cot))
    tag = f"{path}, {planes} plane{'s' * (planes > 1)}"
    if name == "quant_matmul_bwd":
        tag += f", S={splits}"
    log(f"  {name} [{tag}] M={m} K={k} N={n} ({row['w_scale']} scales, "
        f"{row['x']} x, {'bf16' if round_cot else 'f32'} cotangents): "
        + "; ".join(f"{c} {'ok' if ok else 'FAIL'} ({msg})" for c, ok, msg in checks)
        + f"; kernel {row['ms']:.4f} ms, prologue {prologue_ms:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, torch.matmul(dequant) {row['library_ms']:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by})"
        + ("" if b32 is None else f", f32 line {b32:.4f} ms")
        + (f", grid {row['grid_tflops']:.1f} TFLOP/s" if "grid_tflops" in row else "")
        + (f", split route {row['split_route_ms']:.4f} ms" if "split_route_ms" in row else "")
        + ("" if summands is None else summand_text(summands)))
    bad = [c for c, ok, _ in checks if not ok]
    if bad:
        fail(f"{name} {m}x{k}x{n} disagrees with its plain version on {bad}")
    return row


def summand_shares(torch, ref, dwd_k, dwd, xd, cot, factor, dws_of, rws, l1) -> dict:
    """Not a check: the shares of bf16(xd^T dY) off its correctly rounded
    value (an f64 product, summed over 512-row blocks of M) in the kernel
    (its w = 0 launch, dwd_k) and in the plain version (dwd), and how far
    correctly rounded summands would put dws (dws_of their products with
    factor = q - mf u) from the plain dws rws, in plain bars 1e-4 x l1
    (ROADMAP Queue 3). xd (..., M, K), cot (..., M, N), the rest as dW."""
    exact = None
    for r0 in range(0, xd.shape[-2], 512):  # f64 copies of a head's cotangent are GBs
        part = (xd[..., r0:r0 + 512, :].double().transpose(-1, -2)
                @ cot[..., r0:r0 + 512, :].double())
        exact = part if exact is None else exact + part
    dwe = ref._bf16(exact.float())
    del exact
    dws_e = dws_of(dwe * factor)
    return {"kernel_off": (dwd_k != dwe).float().mean().item(),
            "plain_off": (dwd != dwe).float().mean().item(),
            "exact_vs_plain_bar": ((dws_e - rws).abs()
                                   / (1e-4 * l1).clamp_min(1e-30)).max().item()}


def summand_text(s: dict) -> str:
    return (f"; bf16(xd^T dY) off the correctly rounded value: kernel {s['kernel_off']:.2e}, "
            f"plain {s['plain_off']:.2e}; correctly rounded summands "
            f"{s['exact_vs_plain_bar']:.3f} x the plain dws bar")


def split_edges(torch, timer, qmm, ref, gen) -> dict:
    """Two edges of the three-plane split on the card. (1) A head cotangent
    as training makes it, (softmax(z) - onehot) / M over the qwen head's
    152,064 columns with confident logits z = 8 x randn, whose smallest
    entries fall below 2**-110: the prologue's planes bit-equal to the plain
    split and within its contract (`check_split`). (2) Whether mma.sync keeps
    a bf16 subnormal lo: a dX whose hi and mid products cancel exactly,
    leaving lo = 2**-132 (a bf16 subnormal) times wd = 1 (a subnormal
    product) and times wd = 1024 (a normal one, 2**-122). Reported, not
    held: the plain version keeps both."""
    m, n = 8 * 512, 152064
    x, w, a_s, a_b, ws = qat_operands(torch, m, 1024, n, False, gen, HEAD_QS)
    z = torch.randn((m, n), generator=gen, device="cuda") * 8
    dy = torch.softmax(z, dim=1)
    del z
    tgt = torch.randint(0, n, (m,), generator=gen, device="cuda")
    dy[torch.arange(m, device="cuda"), tgt] -= 1.0
    dy /= m
    args = (dy, x, w, a_s, a_b, ws)
    same, _, dyb = check_prologue(torch, timer, qmm, ref, args, HEAD_QS, 3)
    holds, below, err = check_split(torch, dyb, dy, n)
    del dyb, dy, args
    torch.cuda.empty_cache()
    # (2) rows of dY: [y, -(hi + mid)] with y = 2^-115 (1 + 2^-9 + 2^-17):
    # hi = 2^-115, mid = 2^-124, lo = 2^-132; wd rows 1 and 1024 (K-side
    # scales 2^-6 and 16, codes 64); x in range, so dX = bf16(lo x wd)
    y = 2.0 ** -115 * (1 + 2.0 ** -9 + 2.0 ** -17)
    dy = torch.tensor([[y, -(2.0 ** -115 + 2.0 ** -124)]] * 16, device="cuda")
    xs = torch.full((16, 2), 0.5, device="cuda").to(torch.bfloat16)
    wk = torch.tensor([[1.0, 1.0], [1024.0, 1024.0]], device="cuda")
    sk = torch.tensor([[2.0 ** -6], [16.0]], device="cuda")
    probe = (dy, xs, wk, torch.tensor(0.1, device="cuda"), torch.tensor(0.0, device="cuda"),
             sk)
    lo_plane = qmm.bwd_prologue(*probe, planes=3, **HEAD_QS)[2][2, 0, 0].item()
    dx = qmm.quant_matmul_dx(*probe, round_cot=False, **HEAD_QS)[0]
    plain = ref.quant_matmul_dx(*probe, round_cot=False, **HEAD_QS)[0]
    out = {"head_cotangent": {"planes_bit_equal": same, "exact": holds,
                              "below_2^-110": below, "worst_below": err},
           "lo_plane": lo_plane, "kernel_dx": [dx[0, 0].item(), dx[0, 1].item()],
           "plain_dx": [plain[0, 0].item(), plain[0, 1].item()]}
    out["subnormal_lo_kept"] = {"subnormal product": out["kernel_dx"][0] == 2.0 ** -132,
                                "normal product": out["kernel_dx"][1] == 2.0 ** -122}
    log(f"  split edges: softmax head cotangent (z = 8 x randn) planes "
        f"{'ok' if same else 'FAIL'} (bit-equal to the plain split), split "
        f"{'ok' if holds else 'FAIL'} ({below} nonzero below 2^-110, worst error there "
        f"{err:.3e}); subnormal lo: prologue lo {lo_plane:.6e} (2^-132 = "
        f"{2.0 ** -132:.6e}), kernel dX {out['kernel_dx']}, plain {out['plain_dx']}: "
        f"mma.sync kept it {out['subnormal_lo_kept']}")
    if not (same and holds and lo_plane == 2.0 ** -132):
        fail("the three-plane split broke its contract on the card")
    return out


MOE_QS = dict(q_n_a=0, q_p_a=7, q_n_w=4, q_p_w=3)     # w3a3


def batched_operands(torch, e, m, k, n, gen, qs, x_dtype=None):
    dev = "cuda"
    x = (torch.randn((e, m, k), generator=gen, device=dev) * 2).to(
        x_dtype or torch.bfloat16)
    w = torch.randn((e, k, n), generator=gen, device=dev) * k ** -0.5
    a_s = torch.rand((e, 1), generator=gen, device=dev) * 0.3 + 0.2
    a_b = torch.randn((e, 1), generator=gen, device=dev) * 0.1
    ws = torch.rand((e, n), generator=gen, device=dev) * 0.01 + 0.005
    return x, w, a_s, a_b, ws


def check_batched_fwd(torch, timer, qmm, ref, e, m, k, n, gen, qs,
                      x_dtype=None) -> dict:
    """quant_matmul_batched (the tensor-core path) against its plain
    version, with check_qat_fwd's bars; and experts 0 and E-1 bit-equal to
    quant_matmul on their slices."""
    x, w, a_s, a_b, ws = batched_operands(torch, e, m, k, n, gen, qs, x_dtype)
    args = (x, w, a_s, a_b, ws)
    kern = lambda: qmm.quant_matmul_batched(*args, **qs)
    plain = lambda: ref.quant_matmul_batched(*args, **qs)
    y_k, y_r = kern(), plain()
    again = kern()
    ends = sorted({0, e - 1})
    per_expert = [qmm.quant_matmul(x[i], w[i], a_s[i, 0], a_b[i, 0], ws[i:i + 1], **qs)
                  for i in ends]
    torch.cuda.synchronize()
    repeat = _same_bits(torch, y_k, again)
    as_2d = all(_same_bits(torch, y_k[i], y2) for i, y2 in zip(ends, per_expert))
    del again, per_expert
    err = (y_k - y_r).abs().max().item()
    tol, bf16_err = fwd_bar(torch, y_r, k)
    s_a, b_a, s_w = ref._expert_scales(a_s, a_b, ws)
    xd = ref._act_codes(x, s_a, b_a, qs["q_n_a"], qs["q_p_a"])[2]
    wd = ref._weight_codes(w, s_w, qs["q_n_w"], qs["q_p_w"])[2]
    excess = _order_excess(torch, y_k, y_r, xd, wd, k)
    del y_k, y_r
    same, prologue_ms, _ = check_prologue(torch, timer, qmm, ref, args, qs)
    xd, wd = xd.to(torch.bfloat16), wd.to(torch.bfloat16)
    lib = lambda: torch.bmm(xd, wd)
    checks = [("max|err|", err <= tol, f"{err:.3e}, tol {tol:.3e}"),
              ("bar", tol < bf16_err, f"below a bf16 output's {bf16_err:.3e}"),
              ("order", excess <= 0, f"excess {excess:.2e}"),
              ("repeat", repeat, "same bits on a second launch"),
              ("prologue", same, "bit-equal to the plain dequantization"),
              ("per-expert", as_2d, f"experts {ends} bit-equal to quant_matmul")]
    nbytes = e * (m * k * x.element_size() + k * n * 4 + 8 + n * 4 + m * n * 4)
    b_ms, b_by = bound(nbytes, 2.0 * e * m * k * n)
    row = {"shape": [e, m, k, n], "x": str(x.dtype)[6:], "path": "tc",
           "max_abs_err": err, "tol": tol, "bf16_err": bf16_err, "order_excess": excess,
           "ms": timer.ms(kern), "plain_ms": timer.ms(plain),
           "library_ms": timer.ms(lib), "bound_ms": b_ms, "bound_by": b_by,
           "prologue_ms": prologue_ms}
    log(f"  quant_matmul_batched [tc] E={e} M={m} K={k} N={n} ({row['x']} x): "
        + "; ".join(f"{c} {'ok' if ok else 'FAIL'} ({msg})" for c, ok, msg in checks)
        + f"; kernel {row['ms']:.4f} ms, prologue {prologue_ms:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, torch.bmm(bf16 dequant) "
        f"{row['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    bad = [c for c, ok, _ in checks if not ok]
    if bad:
        fail(f"quant_matmul_batched {e}x{m}x{k}x{n} disagrees with its plain "
             f"version on {bad}")
    return row


def check_batched_bwd(torch, timer, qmm, ref, e, m, k, n, gen, qs,
                      x_dtype=None, round_cot=True) -> dict:
    """quant_matmul_bwd_batched against its plain version, with the bars of
    check_qat_bwd per expert; the path is `bwd_route` on the per-expert
    shape: the combined backward ("tc", one plane for bf16 cotangents,
    three for f32 ones, the dW contraction cut as `dw_splits` cuts the
    per-expert shape), or split expert by expert through the split dx / dw
    grids past the reference's scratch budget; all on the tensor cores. A
    second launch gives the same bits; experts 0 and E-1 are bit-equal, in
    all five outputs, to quant_matmul_bwd on their slices; the prologue
    alone is bit-equal to the plain dequantization, and dws may differ from
    the plain dws by 1e-4 x sum|summands| plus what its differing summands
    account for (below). An f32 row prints the split route's time (every
    expert through it) and check_qat_bwd's summand shares beside its own."""
    x, w, a_s, a_b, ws = batched_operands(torch, e, m, k, n, gen, qs, x_dtype)
    dy = torch.randn((e, m, n), generator=gen, device="cuda")
    path = qmm.bwd_route(m, k, n)
    planes = qmm.plane_count(round_cot)
    splits = qmm.dw_splits(m, k, n, planes)[0] if path == "tc" else 1
    kw = dict(round_cot=round_cot, **qs)
    args = (dy, x, w, a_s, a_b, ws)
    kern = lambda: qmm.quant_matmul_bwd_batched(*args, **kw)
    plain = lambda: ref.quant_matmul_bwd_batched(*args, **kw)
    got, want = kern(), plain()
    again = kern()
    torch.cuda.synchronize()
    checks = [("repeat", all(_same_bits(torch, a, b) for a, b in zip(got, again)),
               "same bits on a second launch")]
    del again
    ends = sorted({0, e - 1})
    as_2d = True
    for i in ends:
        two_d = qmm.quant_matmul_bwd(dy[i], x[i], w[i], a_s[i, 0], a_b[i, 0],
                                     ws[i:i + 1], **kw)
        mine = (got[0][i], got[1][i, 0], got[2][i, 0], got[3][i], got[4][i:i + 1])
        as_2d = as_2d and all(_same_bits(torch, a, b) for a, b in zip(mine, two_d))
        del two_d
    checks.append(("per-expert", as_2d,
                   f"experts {ends} bit-equal to quant_matmul_bwd in all five"))
    same, prologue_ms, _ = check_prologue(torch, timer, qmm, ref, args, qs, planes)
    checks.append(("prologue", same, "bit-equal to the plain dequantization"))
    s_a, b_a, s_w = ref._expert_scales(a_s, a_b, ws)
    u, q, xd = ref._act_codes(x, s_a, b_a, qs["q_n_a"], qs["q_p_a"])
    uw, qw, wd = ref._weight_codes(w, s_w, qs["q_n_w"], qs["q_p_w"])
    cot = ref._cotangent(dy, round_cot)
    ex_x, fr_x = _bf16_close(torch, got[0], want[0],
                             cot.abs() @ wd.abs().transpose(1, 2), n)
    dw_abs = xd.abs().transpose(1, 2) @ cot.abs()
    ex_w, fr_w = _bf16_close(torch, got[3], want[3], dw_abs, m)
    dxd = ref._bf16(cot @ wd.transpose(1, 2))
    mf = ref._in_range(u, qs["q_n_a"], qs["q_p_a"])
    l1a = (dxd * (q - mf * u)).abs().sum(dim=(1, 2)).reshape(e, 1)
    l1b = (dxd * (1 - mf)).abs().sum(dim=(1, 2)).reshape(e, 1)
    del dxd, mf
    dwd = ref._bf16(xd.transpose(1, 2) @ cot)
    fac = (qw - ref._in_range(uw, qs["q_n_w"], qs["q_p_w"]) * uw).abs()
    l1w = (dwd.abs() * fac).sum(dim=1)
    # dws sums the summands bf16(xd^T dY) x (q - mf u) over K. The tile's
    # f32 order rounds some of bf16(xd^T dY) to the other bf16 neighbour of
    # the plain version's (the dW bar allows that), and at clipped weights
    # (|q - mf u| up to 4) one such flip can move a K = 512 column's dws
    # past 1e-4 x sum|summands|. So each column's allowance adds, to that,
    # |its kernel summand - the plain one| x |q - mf u| summed over the
    # summands that differ. The kernel's summands come from a launch with w
    # = 0 (every code in range, so dW is bf16(xd^T dY) on every element):
    # they must be the real launch's dW wherever w is in range, and meet the
    # dW bar against the plain ones on every element, clipped ones included.
    dwd_k = qmm.quant_matmul_bwd_batched(dy, x, torch.zeros_like(w), a_s, a_b, ws, **kw)[3]
    mfw = ref._in_range(uw, qs["q_n_w"], qs["q_p_w"])
    real = bool(torch.equal(got[3], dwd_k * mfw))
    ex_d, fr_d = _bf16_close(torch, dwd_k, dwd, dw_abs, m)
    flips = ((dwd_k - dwd).abs() * fac).sum(dim=1)
    summand_checks = [
        ("summands", real, "the w = 0 launch's bf16(xd^T dY) is the real dW where in range"),
        ("xd^T dY", ex_d <= 0 and fr_d <= 0.01,
         f"every element: excess {ex_d:.2e}, differing {fr_d:.2e}")]
    summands = None
    if not round_cot:
        summands = summand_shares(torch, ref, dwd_k, dwd, xd, cot, qw - mfw * uw,
                                  lambda t: t.sum(dim=1), want[4], l1w)
    del dwd_k, mfw, dw_abs, dwd, fac
    gap = (got[4] - want[4]).abs()
    allowed = 1e-4 * l1w + flips
    dws_ok = bool((gap <= allowed).all())
    vs_plain = (gap / l1w.clamp_min(1e-30)).max().item()
    flip_cols = int((gap > 1e-4 * l1w).sum().item())
    use = (gap / allowed.clamp_min(1e-30)).max().item()
    del l1w, flips, allowed
    checks += [("dX", ex_x <= 0 and fr_x <= 0.01, f"excess {ex_x:.2e}, differing {fr_x:.2e}"),
               ("dsa", bool(((got[1] - want[1]).abs() <= 1e-4 * l1a).all()),
                f"max {(got[1] - want[1]).abs().max().item():.3e}"),
               ("dba", bool(((got[2] - want[2]).abs() <= 1e-4 * l1b).all()),
                f"max {(got[2] - want[2]).abs().max().item():.3e}"),
               ("dW", ex_w <= 0 and fr_w <= 0.01, f"excess {ex_w:.2e}, differing {fr_w:.2e}"),
               *summand_checks,
               ("dws", dws_ok, f"max {vs_plain:.3e} x sum|summands| from the plain dws, "
                f"{use:.3f} of the allowance; {flip_cols} columns past 1e-4 x sum|summands|")]
    worst = max((got[0] - want[0]).abs().max().item(),
                (got[3] - want[3]).abs().max().item())
    del got, want
    # yardstick: the two products on operands dequantized beforehand
    lt = torch.bfloat16 if round_cot else torch.float32
    ct, xl, wl = cot.to(lt), xd.to(lt), wd.to(lt)
    lib = lambda: (torch.bmm(ct, wl.transpose(1, 2)), torch.bmm(xl.transpose(1, 2), ct))
    nbytes = e * (m * n * 4 + m * k * x.element_size() + k * n * 4 + 8 + n * 4
                  + m * k * 4 + 8 + k * n * 4 + n * 4)
    ops = 4.0 * e * m * k * n
    # f32 cotangents: the three planes' bf16 products, beside the f32 line
    b_ms, b_by = bound(nbytes, ops * planes)
    b32 = None if round_cot else bound(nbytes, ops, F32_OPS_PER_S)[0]
    row = {"shape": [e, m, k, n], "path": path, "planes": planes, "dw_splits": splits,
           "x": str(x.dtype)[6:], "round_cot": round_cot, "max_abs_err": worst,
           "tol": "bf16 ulp + f32 order bound; sums 1e-4 x sum|summands| per expert "
                  "(dws: + the differing summands x |q - mf u|)",
           "ms": timer.ms(kern), "plain_ms": timer.ms(plain),
           "library_ms": timer.ms(lib), "bound_ms": b_ms, "bound_by": b_by,
           "bound_f32_ms": b32, "prologue_ms": prologue_ms, "dws_vs_plain": vs_plain,
           "dws_allowance_used": use, "dws_flip_cols": flip_cols, "summands": summands}
    if path == "tc" and not round_cot:  # every expert on the split route, same inputs
        row["split_route_ms"] = timer.ms(
            lambda: qmm.quant_matmul_bwd_batched(*args, scratch_budget=0, **kw))
    tag = f"{path}, {planes} plane{'s' * (planes > 1)}" + (f", S={splits}" if path == "tc"
                                                            else "")
    log(f"  quant_matmul_bwd_batched [{tag}] E={e} M={m} K={k} N={n} ({row['x']} x, "
        f"{'bf16' if round_cot else 'f32'} cotangents): "
        + "; ".join(f"{c} {'ok' if ok else 'FAIL'} ({msg})" for c, ok, msg in checks)
        + f"; kernel {row['ms']:.4f} ms, prologue {prologue_ms:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, torch.bmm(dequant) {row['library_ms']:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by})" + ("" if b32 is None else f", f32 line {b32:.4f} ms")
        + (f", split route {row['split_route_ms']:.4f} ms" if "split_route_ms" in row else "")
        + ("" if summands is None else summand_text(summands)))
    bad = [c for c, ok, _ in checks if not ok]
    if bad:
        fail(f"quant_matmul_bwd_batched {e}x{m}x{k}x{n} disagrees with its "
             f"plain version on {bad}")
    return row


# ---------------------------------------------------------------------------
# phases 6-7: QAT training
# ---------------------------------------------------------------------------

QAT_KERNELS = ("quant_matmul", "quant_matmul_bwd", "quant_matmul_dx",
               "quant_matmul_dw", "quant_matmul_batched",
               "quant_matmul_bwd_batched")


def qat_linears(cfg, qcfg, tokens: int, frontend_rows: int = 0,
                tp_parts: int = 1, moe_rows=None) -> list:
    """Every linear of a train step that takes the QAT kernels, as
    (name, count in the model, M, K, N, f32 cotangent, experts, remat),
    experts the batched kernels' expert count (0 for a 2D linear):
    a block linear whose kind quantizes both its input and its weight (not
    at 1 bit), with its (K, N) from the config: an attention block's wq /
    wk / wv, wo; a cross layer's xq, xo and xk / xv (over the
    `frontend_rows` patch rows); the dense FFN's, an MoE FFN's expert
    linears at the per-expert capacity rows (the router stays on the f32
    einsum); an mLSTM block's m_up_gate / m_up, mq / mk / mv, the m_i /
    m_f gates (N = heads), m_down; an sLSTM block's s_z / s_i / s_f / s_o
    and its 4/3-GLU FFN (its recurrent mix s_r is read whole, not a
    linear); an RG-LRU block's g_gate / g_in, g_a / g_x, g_out; and the
    head (untied, or tied as the transposed per-tensor embedding). Block
    linears run their forward twice (remat recomputes the block in the
    backward); the head once. tp_parts: one rank's slices of a
    tensor-parallel run (`dist.spmd.Spmd.tp`): the attention's, the dense
    FFN's, the mLSTM's, the sLSTM FFN's, the RG-LRU's and the cross
    layer's linears and the head cut over that many model ranks, on N for
    the column-parallel ones and on K for the row-parallel wo, w_out,
    m_down, g_out and xo (the sLSTM's s_z / s_i / s_f / s_o stay whole);
    an MoE FFN's experts over them where they divide (expert parallelism:
    the rank's experts at the same shapes), else each expert's d_ff as the
    dense FFN's. Every count cut here must divide: a sublayer the rules
    keep whole (an attention whose kv heads do not split) is not cut.
    moe_rows: the MoE capacity buffer's rows (0: leave the MoE FFN out;
    None: the dispatch groups' capacity over `tokens`)."""
    from repro_torch.core.policy import act_spec, weight_spec
    from repro_torch.models.common import NAME2KIND
    from repro_torch.models.moe import capacity
    from repro_torch.models.recurrent import slstm_ff

    def fused(name, wname=None):
        a, w = act_spec(qcfg, NAME2KIND[name]), weight_spec(qcfg, NAME2KIND[wname or name])
        return a is not None and w is not None and a.bits != 1 and w.bits != 1

    d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim_
    h, hkv = cfg.n_heads, cfg.n_kv_heads
    blocks = [cfg.block_at(i) for i in range(cfg.n_layers)]
    n_of = lambda pred: sum(1 for bd in blocks if pred(bd))
    attn = n_of(lambda bd: bd.attn in ("global", "local"))
    cross = n_of(lambda bd: bd.cross_attn)
    moe = n_of(lambda bd: bd.ffn == "moe")
    dense = n_of(lambda bd: bd.ffn == "dense")
    du, w = 2 * d, cfg.lru_width or d
    out = []

    def add(name, count, m, k, n, label=None):
        if count and fused(name):
            out.append((label or name, count, m, k, n, False, 0, True))

    p = tp_parts
    for name, k, n in (("wq", d, h * hd // p), ("wk", d, hkv * hd // p),
                       ("wv", d, hkv * hd // p), ("wo", h * hd // p, d)):
        add(name, attn, tokens, k, n)
    for name, m, k, n in (("xq", tokens, d, h * hd // p),
                          ("xk", frontend_rows, d, hkv * hd // p),
                          ("xv", frontend_rows, d, hkv * hd // p),
                          ("xo", tokens, h * hd // p, d)):
        add(name, cross, m, k, n)
    ffn = (("w_gate", d, f),) if cfg.ffn_gated else ()
    ffn += (("w_in", d, f), ("w_out", f, d))
    for name, k, n in ffn:
        add(name, dense, tokens, *((k // p, n) if name == "w_out" else (k, n // p)))
        moe_name = {"w_gate": "moe_gate", "w_in": "moe_in", "w_out": "moe_out"}[name]
        if moe and fused(moe_name) and moe_rows != 0:
            groups = cfg.moe_dispatch_groups
            rows = moe_rows or groups * capacity(tokens // groups, cfg)
            e, ek, en = cfg.n_experts, k, n
            if p > 1 and e % p == 0:
                e //= p
            elif p > 1 and f % p == 0:
                ek, en = (k // p, n) if name == "w_out" else (k, n // p)
            out.append((moe_name, moe, rows, ek, en, False, e, True))
    mlstm = n_of(lambda bd: bd.attn == "mlstm")
    for name, k, n in (("m_up_gate", d, du // p), ("m_up", d, du // p),
                       ("mq", du, du // p), ("mk", du, du // p), ("mv", du, du // p),
                       ("m_i", du, h // p), ("m_f", du, h // p), ("m_down", du // p, d)):
        add(name, mlstm, tokens, k, n)
    slstm, f_ff = n_of(lambda bd: bd.attn == "slstm"), slstm_ff(d)
    for name, k, n in (("s_z", d, d), ("s_i", d, d), ("s_f", d, d), ("s_o", d, d),
                       ("w_gate", d, f_ff // p), ("w_in", d, f_ff // p),
                       ("w_out", f_ff // p, d)):
        add(name, slstm, tokens, k, n, name + (" (sLSTM)" if name.startswith("w_") else ""))
    rglru = n_of(lambda bd: bd.attn == "rglru")
    for name, k, n in (("g_gate", d, w // p), ("g_in", d, w // p), ("g_a", w, w // p),
                       ("g_x", w, w // p), ("g_out", w // p, d)):
        add(name, rglru, tokens, k, n)
    tied_ok = (cfg.tie_embeddings and fused("lm_head", "embed")
               and weight_spec(qcfg, "embed").granularity == "per_tensor")
    if tied_ok or (not cfg.tie_embeddings and fused("lm_head")):
        out.append(("lm_head", 1, tokens, d, cfg.padded_vocab // p, True, 0, False))
    return out


def qat_launches_per_step(cfg, qcfg, tokens: int, frontend_rows: int = 0,
                          tp_parts: int = 1, moe_rows=None) -> dict:
    """Launches a train step makes, from `qat_linears`: each linear's
    forward (twice for a block linear), and its backward on the route the
    dispatcher takes (`quant_matmul.bwd_route` on the padded shape, the
    per-expert shape for the batched kernels): the combined backward once
    ("tc": bf16 cotangents on one plane, the head's f32 ones on three), or,
    past the reference's scratch budget, the split dx / dw once each
    (expert by expert for the batched kernels). moe_rows: `qat_linears`'."""
    from repro_torch.kernels.quant_matmul import bwd_route
    c = dict.fromkeys(QAT_KERNELS, 0)
    for _, count, m, k, n, f32_cot, batched, remat in qat_linears(
            cfg, qcfg, tokens, frontend_rows, tp_parts, moe_rows):
        e = batched or 1
        c["quant_matmul_batched" if batched else "quant_matmul"] += count * (2 if remat else 1)
        if bwd_route(m, k, n) == "split":
            c["quant_matmul_dx"] += count * e
            c["quant_matmul_dw"] += count * e
        else:
            c["quant_matmul_bwd_batched" if batched else "quant_matmul_bwd"] += count
    return c


def formula(cfg, qcfg, tokens: int, frontend_rows: int = 0, tp_parts: int = 1,
            moe_rows=None) -> str:
    """`qat_launches_per_step`'s terms: each linear, its count, its
    forwards and its backward route."""
    from repro_torch.kernels.quant_matmul import bwd_route
    parts = []
    for name, count, m, k, n, f32_cot, batched, remat in qat_linears(
            cfg, qcfg, tokens, frontend_rows, tp_parts, moe_rows):
        route = bwd_route(m, k, n)
        route += " (3 planes)" if f32_cot else (" (1 plane)" if route == "split" else "")
        each = f" x {batched} experts" if batched and route.startswith("split") else ""
        parts.append(f"{name} ({m}, {k}, {n}) x {count}: fwd {2 if remat else 1}, "
                     f"bwd {route}{each}")
    return "; ".join(parts)


def train_phase(torch, ops, train, argv: list, expect_start: int,
                steps: int) -> dict:
    log(f"train: python -m repro_torch.launch.train {' '.join(argv)}")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rep = train.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: ops.launch_counts()[k] for k in QAT_KERNELS}
    tokens = int(argv[argv.index("--batch") + 1]) * int(argv[argv.index("--seq") + 1])
    steady = rep.step_seconds[1:] or rep.step_seconds
    s_step = statistics.median(steady)
    log(f"  wall {wall:.1f} s (params built on the card included), steps "
        f"{rep.start_step}..{rep.final_step}, s/step {[round(v, 3) for v in rep.step_seconds]}"
        f" (median after the first {s_step:.3f} s, {tokens / s_step:.0f} tokens/s), "
        f"losses {rep.losses}, health {rep.healths}, peak "
        f"{(rep.peak_bytes or 0) / 2**30:.2f} GiB; launches {counts}")
    if rep.start_step != expect_start or rep.steps_run != steps:
        fail(f"train run started at {rep.start_step} and ran {rep.steps_run} "
             f"steps; expected {expect_start} and {steps}")
    if not all(map(lambda v: v == v and abs(v) < float("inf"), rep.losses)):
        fail(f"non-finite training loss: {rep.losses}")
    if any(rep.healths) or len(rep.healths) != steps:
        fail(f"sentinel health bits set: {rep.healths}")
    return {"report": rep, "counts": counts, "wall": wall, "s_step": s_step,
            "tokens_s": tokens / s_step}


def route_check(torch, arch: str = "qwen1.5-0.5b", quant: str = "w4a4",
                gen_seed: int = 0) -> dict:
    """Gradients of full-width `arch` cut to 2 layers (batch 2 x 256, one
    step from init) on the kernel route against the unfused composition,
    both on the card: loss within 1e-3 relative, every non-scalar gradient
    leaf within 1e-2 relative L2, the scalar quantizer leaves pooled per
    kind (a single near-zero scalar's relative error means little). For an
    MoE model, also the share of (token, slot) expert choices that differ
    between the routes (the router is an f32 einsum on both, fed by
    activations that may differ in an ulp: a top-k flip is a discontinuity,
    reported, not hidden). The bar is held with the kernels' rule at the
    clip edge on both routes (see below): the router, unfused on both,
    sees exact zeros at init too (the embedding's code-0 entries), and must
    take one rule on both.

    At init the forward is exact on both routes (scales 1, offsets 0:
    integer codes times bf16 weights sum without rounding), so the routes
    differ only where a quantizer input sits exactly on the clip edge
    u = -Q_N (the 8-bit embedding's code-0 zeros, silu underflow): there the
    reference's kernels pass the whole gradient and its unfused clip half
    (PERF.md, ROADMAP Queue 3). The bar is held against the unfused route
    run with the kernels' edge rule (torch.clamp: same forward, whole
    gradient at the edge); the gaps against the unfused route as it is are
    printed beside it."""
    import numpy as np
    from repro_torch import tree as T
    from repro_torch.configs.registry import get_config
    from repro_torch.core import quantizer
    from repro_torch.core.policy import get_preset
    from repro_torch.data.mckd_store import synthetic_kd_labels
    from repro_torch.data.synthetic import DataConfig, sample_batch
    from repro_torch.train.sentinel import SentinelConfig
    from repro_torch.train.state import TrainConfig, init_state
    from repro_torch.train.train_step import make_grad_fn
    from repro_torch.models import moe
    cfg = get_config(arch).replace(n_layers=2)
    qcfg = get_preset(quant)
    tcfg = TrainConfig(total_steps=10, warmup_steps=0, kd="mckd",
                       sentinel=SentinelConfig())
    state = init_state(cfg, qcfg, tcfg,
                       torch.Generator(device="cuda").manual_seed(gen_seed), "cuda")
    b = sample_batch(cfg, DataConfig(), 0, 2, 256)
    b["kd_idx"], b["kd_p"] = synthetic_kd_labels(b["labels"], cfg.vocab_size, 16, seed=0)
    b = {k: torch.from_numpy(np.ascontiguousarray(v)).cuda() for k, v in b.items()}

    choices = {}

    def grads(route, clip=None):
        orig, orig_route = quantizer._clip, moe._route_group
        seen = choices.setdefault((route, clip is not None), [])

        def recording(xt, exp_idx, *a):
            seen.append(exp_idx.detach().clone())
            return orig_route(xt, exp_idx, *a)

        if clip is not None:
            quantizer._clip = clip
        moe._route_group = recording
        try:
            loss, _, g = make_grad_fn(cfg, qcfg.replace(fused_matmul=route), tcfg)(
                state["params"], b, state["step"])
        finally:
            quantizer._clip, moe._route_group = orig, orig_route
        return loss.item(), {T.path_str(p): v for p, v in T.flatten(g)}

    def gaps(a, o):
        res, pools = {}, {k: ([], []) for k in ("w_scale", "a_scale", "a_offset")}
        for k, go in o[1].items():
            ga = a[1][k]
            kind = k.rsplit("/", 1)[-1]
            if kind in pools and go.numel() == 1:
                pools[kind][0].append(ga.reshape(()))
                pools[kind][1].append(go.reshape(()))
                continue
            res[k] = ((ga - go).norm() / go.norm().clamp_min(1e-30)).item()
        for kind, (x, y) in pools.items():
            x, y = torch.stack(x), torch.stack(y)
            res["pooled " + kind] = ((x - y).norm() / y.norm().clamp_min(1e-30)).item()
        top = sorted(res.items(), key=lambda kv: -kv[1])[:5]
        return abs(a[0] - o[0]) / abs(o[0]), [(k, round(v, 7)) for k, v in top]

    # the edge rule on both routes: a linear that is unfused on both (the
    # MoE router) then keeps one rule, and only the kernels' linears differ
    d_edge, top_edge = gaps(grads("auto", torch.clamp), grads("off", torch.clamp))
    d_raw, top_raw = gaps(grads("auto"), grads("off"))
    flips = None
    if choices[("auto", True)]:
        a, o = choices[("auto", True)], choices[("off", True)]
        if len(a) != len(o):
            fail(f"routes routed {len(a)} and {len(o)} times")
        flips = (sum(int((x != y).sum()) for x, y in zip(a, o))
                 / sum(x.numel() for x in a))
    log(f"route check ({cfg.name}, {quant}): kernel route vs unfused (kernels' "
        f"edge rule): loss gap {d_edge:.3e} (bar 1e-3), worst leaves {top_edge} "
        f"(bar 1e-2)" + ("" if flips is None else
                         f"; expert choices that differ {flips:.3e}"))
    log(f"  vs unfused as it is (clip splits the gradient at the edge): loss "
        f"gap {d_raw:.3e}, worst leaves {top_raw}")
    if not (d_edge <= 1e-3 and top_edge[0][1] <= 1e-2):
        fail(f"kernel route departs from the unfused route: loss {d_edge}, {top_edge[0]}")
    return {"edge_rule": {"loss": d_edge, "worst": top_edge},
            "as_is": {"loss": d_raw, "worst": top_raw}, "choice_flips": flips}


def training_run(torch, ops, cfg, qcfg, *, batch: int, seq: int, steps: int,
                 tag: str, strict_health: bool) -> dict:
    """`run_training` on the card with the launch counts set to 0 just
    before and read just after: MCKD top-16, sentinel on, seed 0, the CLI's
    optimizer settings, no checkpoint written (save_every beyond the run).
    Finite losses; health 0 every step (strict_health) or no fatal bit;
    with OBR on, obr_lambda 0 at step 0 and > 0 after and loss_obr > 0;
    with oscillation tracked, osc_frac every step."""
    from repro_torch.data.synthetic import DataConfig
    from repro_torch.launch import train
    from repro_torch.train.sentinel import SentinelConfig
    import shutil
    tcfg = smoke_tcfg(steps)
    ckpt_dir = ROOT / "build" / f"chip_smoke_{tag}_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    log(f"train: run_training({cfg.name}, {cfg.n_layers} layers, "
        f"w{qcfg.w_bits}a{qcfg.a_bits}{' + OBR' if qcfg.obr_lambda else ''}"
        f"{', track_oscillation' if qcfg.track_oscillation else ''}, batch "
        f"{batch} x {seq}, {steps} steps)")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rep = train.run_training(cfg, qcfg, tcfg, DataConfig(seed=0), steps=steps,
                             batch_size=batch, seq_len=seq, ckpt_dir=str(ckpt_dir),
                             save_every=10 ** 6, log_every=1, seed=0,
                             device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: ops.launch_counts()[k] for k in QAT_KERNELS}
    written = sorted(p.name for p in ckpt_dir.glob("*")) if ckpt_dir.exists() else []
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    steady = rep.step_seconds[1:] or rep.step_seconds
    s_step = statistics.median(steady)
    log(f"  wall {wall:.1f} s (params built on the card included), s/step "
        f"{[round(v, 3) for v in rep.step_seconds]} (median after the first "
        f"{s_step:.3f} s, {batch * seq / s_step:.0f} tokens/s), losses {rep.losses}, "
        f"health {rep.healths}, peak {(rep.peak_bytes or 0) / 2**30:.2f} GiB, "
        f"checkpoint files {written}")
    for i, mm in enumerate(rep.metrics):
        log(f"  step {i}: " + ", ".join(f"{k} {v:.6g}" for k, v in mm.items()))
    if rep.steps_run != steps or len(rep.healths) != steps:
        fail(f"{cfg.name} train run ran {rep.steps_run} steps; expected {steps}")
    if not all(v == v and abs(v) < float("inf") for v in rep.losses):
        fail(f"non-finite {cfg.name} training loss: {rep.losses}")
    bad = [h for h in rep.healths if (h if strict_health
                                      else h & SentinelConfig().fatal_bits)]
    if bad:
        fail(f"sentinel health bits in the {cfg.name} run: {rep.healths}")
    if qcfg.obr_lambda > 0:
        lams = [mm["obr_lambda"] for mm in rep.metrics]
        if lams[0] != 0.0 or not all(v > 0 for v in lams[1:]):
            fail(f"obr_lambda should be 0 at step 0 and > 0 after: {lams}")
        if not all(mm["loss_obr"] > 0 for mm in rep.metrics):
            fail(f"OBR metrics missing: {rep.metrics}")
    if qcfg.track_oscillation and not all("osc_frac" in mm for mm in rep.metrics):
        fail(f"oscillation metrics missing: {rep.metrics}")
    return {"report": rep, "counts": counts, "wall": wall, "s_step": s_step,
            "tokens_s": batch * seq / s_step, "cfg": cfg, "qcfg": qcfg}


def moe_train_phase(torch, ops, steps: int = 3) -> dict:
    """The MoE training path through `run_training` (the CLI has no flag for
    oscillation tracking, as in the reference): full-width 24-layer
    granite-moe-1b-a400m, w3a3 (OBR lambda 0.1 on a cosine ramp over the
    run), track_oscillation, batch 8 x 512 (`training_run`; no checkpoint:
    the full state with its oscillation state is ~24 GB)."""
    cfg, qcfg = moe_qat_config()
    return training_run(torch, ops, cfg, qcfg, batch=8, seq=512, steps=steps,
                        tag="moe", strict_health=False)


def obr_grad_bits(torch) -> dict:
    """Eq. 10's value and gradient as the train step takes them (the leaf's
    sums, then `core.obr.obr_grad`) against autograd through `obr_loss`, at
    granite-moe-1b-a400m's leaf shapes on the card (seeded; w3a3's 3-bit
    per-head wq and per-expert moe_in, the 8-bit router and tied
    embedding, whose 256 levels take the level-by-level reductions):
    {leaf: bit-equal}."""
    from repro_torch.core.obr import obr_grad, obr_loss, obr_stats
    from repro_torch.core.quantizer import QuantSpec
    gen = torch.Generator(device="cuda").manual_seed(100 * SEED + 8)
    out = {}
    for name, shape, groups, bits in (("wq", (1024, 16, 64), (1,), 3),
                                      ("moe_in", (32, 1024, 512), (0,), 3),
                                      ("router", (1024, 32), (), 8),
                                      ("embed", (49408, 1024), (), 8)):
        w = 0.02 * torch.randn(shape, generator=gen, device="cuda")
        sshape = tuple(n if i in groups else 1 for i, n in enumerate(shape)) if groups else ()
        s = 0.01 + 0.01 * torch.rand(sshape, generator=gen, device="cuda")
        spec = QuantSpec(bits=bits, signed=True)
        wl = w.clone().requires_grad_(True)
        v = obr_loss(wl, s, spec)
        (g,) = torch.autograd.grad(v, wl)
        with torch.no_grad():
            stats = obr_stats(w, s, spec)
        v2, g2 = obr_grad(w, s, spec, stats)
        out[name] = _same_bits(torch, v.detach(), v2) and _same_bits(torch, g, g2)
        del w, wl, g, g2, stats
    return out


def check_launches(run: dict, steps: int, tokens: int,
                   every_kernel: bool = False, frontend_rows: int = 0,
                   tp_parts: int = 1, moe_rows: dict = None) -> dict:
    """A run's QAT launches equal `qat_launches_per_step` x steps (and,
    with every_kernel, each QAT kernel was launched). moe_rows: the MoE
    calls' capacity buffers, {rows: calls} (`models.moe.buffer_rows`: a
    data rank's local capacities, two forwards a layer and step): the MoE
    FFN's launches are counted at those rows, the rest a step."""
    cfg, qcfg = run["cfg"], run["qcfg"]
    per_step = qat_launches_per_step(cfg, qcfg, tokens, frontend_rows, tp_parts,
                                     0 if moe_rows else None)
    want = {k: v * steps for k, v in per_step.items()}
    terms = formula(cfg, qcfg, tokens, frontend_rows, tp_parts, 0 if moe_rows else None)
    if moe_rows:
        layers = sum(1 for i in range(cfg.n_layers) if cfg.block_at(i).ffn == "moe")
        for rows, calls in sorted(moe_rows.items()):
            at = qat_launches_per_step(cfg, qcfg, tokens, frontend_rows, tp_parts, rows)
            for k in want:  # one layer's launches, times its steps at these rows
                want[k] += (at[k] - per_step[k]) // layers * calls // 2
            terms += f"; at {rows} rows x {calls // 2} layer-steps: " + "; ".join(
                t for t in formula(cfg, qcfg, tokens, frontend_rows, tp_parts, rows)
                .split("; ") if t.startswith("moe_"))
        per_step = {k: v / steps for k, v in want.items()}
    log(f"  launches {run['counts']}; per step {per_step} ({terms}) x "
        f"{steps} steps = {want}")
    if (run["counts"] != want or not any(want.values())
            or (every_kernel and not all(want.values()))):
        fail(f"{run['cfg'].name} QAT launches {run['counts']} != {per_step} "
             f"per step x {steps}")
    return per_step


# ---------------------------------------------------------------------------
# phases 16-20: the recurrent families and cross-attention (cells K-O)
# ---------------------------------------------------------------------------

def greedy_serve_phase(torch, ops, M, serve, arch: str, quant: str, *,
                       path_kernels: tuple, cut_layers: int, batch: int = 8,
                       prompt_len: int = 128, new_tokens: int = 32,
                       kv_bits: int = 8) -> dict:
    """Serve full-width `arch` through `greedy_generate` (the serving path
    of recurrent and cross patterns, which the engine refuses, as in the
    reference): random int-coded params built on the card (seed 0),
    `batch` synthetic prompts of `prompt_len` tokens, one prefill call,
    then `new_tokens` - 1 decode calls, the launch counts set to 0 just
    before and read just after. Prefill and decode tok/s from each call
    timed between device syncs; peak memory. Gates: every kernel of
    `path_kernels` launched, tokens in the vocabulary; rows independent: a
    prompt's greedy run alone gives the same tokens and, step by step, the
    same logits bits as its row inside the batch (rows 0 and batch - 1);
    the model cut to `cut_layers` layers against the CPU (phase 4's bars)."""
    import types
    from repro_torch.configs.registry import get_config
    from repro_torch.core.policy import get_preset
    from repro_torch.data.synthetic import DataConfig, sample_batch
    dev = torch.device("cuda")
    cfg = get_config(arch)
    qcfg = get_preset(quant).replace(kv_cache_bits=kv_bits, a_bits=32)
    log(f"serve: greedy_generate({cfg.name}, {cfg.n_layers} layers, {quant}, "
        f"int{kv_bits} KV, {batch} x {prompt_len} + {new_tokens})")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = M.init_serving_params(cfg, qcfg, torch.Generator(device=dev).manual_seed(0),
                                   dev)
    prompts = sample_batch(cfg, DataConfig(), 0, batch, prompt_len)["tokens"]
    max_len = prompt_len + new_tokens

    def generate(rows):
        times, logits = [], []

        def step(p, c, b):
            torch.cuda.synchronize()
            t = time.perf_counter()
            lg, c = M.prefill_step(p, c, b, cfg, qcfg)
            logits.append(lg[:, -1].clone())
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            return lg, c

        cache = M.init_cache(cfg, qcfg, len(rows), max_len, dev)
        toks, _ = serve.greedy_generate(step, params, cache,
                                        torch.from_numpy(prompts[rows]).to(dev),
                                        new_tokens)
        return toks, times, logits

    ops.reset_launch_counts()
    toks, times, logits = generate(list(range(batch)))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    wall = time.perf_counter() - t0
    prefill_tok_s = batch * prompt_len / times[0]
    decode_tok_s = batch * (new_tokens - 1) / sum(times[1:])
    log(f"  wall {wall:.1f} s (params built on the card included); prefill "
        f"{prefill_tok_s:.1f} tok/s ({times[0] * 1e3:.1f} ms), decode "
        f"{decode_tok_s:.1f} tok/s (median step "
        f"{statistics.median(times[1:]) * 1e3:.1f} ms), peak {peak / 2**30:.2f} GiB; "
        f"launches {counts}")
    for name in path_kernels:
        if counts[name] <= 0:
            fail(f"{name} was never launched on {cfg.name}'s serving path: {counts}")
    if toks.shape != (batch, new_tokens) or not bool(
            ((toks >= 0) & (toks < cfg.vocab_size)).all()):
        fail(f"{cfg.name}: generated tokens {tuple(toks.shape)} out of range")
    if not all(bool(torch.isfinite(lg).all()) for lg in logits):
        fail(f"{cfg.name}: non-finite logits")
    indep = {}
    for r in (0, batch - 1):
        t_alone, _, lg_alone = generate([r])
        same_tok = bool(torch.equal(t_alone[0], toks[r]))
        same_bits = all(_same_bits(torch, a[0], b[r]) for a, b in zip(lg_alone, logits))
        indep[f"row_{r}"] = same_tok and same_bits
        log(f"  row {r} alone == row {r} of the batch of {batch}: tokens {same_tok}, "
            f"logits bits at all {len(logits)} steps {same_bits}")
    if not all(indep.values()):
        fail(f"{cfg.name} serving: a row's bits depend on its batch: {indep}")
    run = types.SimpleNamespace(cfg=cfg, qcfg=qcfg, params=params, device=dev,
                                prompts=prompts)
    cut_against_cpu(torch, M, run, cut_layers)
    del params, run, logits
    torch.cuda.empty_cache()
    return {"prefill_tok_s": prefill_tok_s, "decode_tok_s": decode_tok_s,
            "prefill_ms": times[0] * 1e3,
            "decode_step_ms": statistics.median(times[1:]) * 1e3,
            "peak_gib": peak / 2**30, "launches": counts, "wall_s": wall,
            "row_independence": indep, "tokens_row0": toks[0].tolist()}


def cross_decode_check(torch, cfg, qcfg) -> dict:
    """The cut llama-3.2-vision-11b's token by token decode against its
    full forward (teacher forcing), latent params at init (cross gates 0,
    as the reference's test_arch_smoke.py:57-91 runs it), 2 x 12 tokens
    with 1024 patch embeddings, QAT linears on kernel 1: the reference's
    bars (rtol 0.1, atol 0.6, top-1 agreement > 0.9), with the cached
    attention unfused, as the reference's test runs it off the TPU. On the
    kernel route (kernel 9) the flash-style P, rounded to bf16 against a
    running max, differs from softmax-then-round by a bf16 ulp of P, which
    the next 4-bit activation quantizer (scale 1 at init) turns into whole
    codes: that gap is printed, not held (ROADMAP Queue 3)."""
    import numpy as np
    from repro_torch.data.synthetic import DataConfig, sample_batch
    from repro_torch.models import model as M
    dev = torch.device("cuda")
    params = M.init_params(cfg, qcfg, torch.Generator(device=dev).manual_seed(1), dev)
    b, s = 2, 12
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
             for k, v in sample_batch(cfg, DataConfig(), 0, b, s).items()}
    with torch.no_grad():
        full = M.forward(params, batch, cfg, qcfg)[0].float()
    res = {}
    for route in ("off", "auto"):
        q = qcfg.replace(fused_attention=route)
        cache = M.init_cache(cfg, q, b, s, dev)
        got = []
        for t in range(s):
            lg, cache = M.decode_step(params, cache, {
                "tokens": batch["tokens"][:, t:t + 1],
                "pos": torch.full((b,), t, dtype=torch.int32, device=dev)}, cfg, q)
            got.append(lg[:, 0].float())
        got = torch.stack(got, 1)
        d = (got - full).abs()
        res[route] = {"max_abs_dlogit": d.max().item(),
                      "within_bars": bool((d <= 0.6 + 0.1 * full.abs()).all()),
                      "top1_agreement": float((got.argmax(-1) == full.argmax(-1))
                                              .float().mean())}
        log(f"  decode vs forward ({cfg.name}, {cfg.n_layers} layers, {b} x {s}, "
            f"cached attention {'unfused' if route == 'off' else 'on kernel 9'}): "
            f"max|dlogit| {res[route]['max_abs_dlogit']:.3e}, within rtol 0.1 / atol "
            f"0.6: {res[route]['within_bars']}, top-1 agreement "
            f"{res[route]['top1_agreement']:.3f}")
    if not (res["off"]["within_bars"] and res["off"]["top1_agreement"] > 0.9):
        fail(f"{cfg.name}: decode departs from forward")
    del params
    torch.cuda.empty_cache()
    return {"unfused_attention": res["off"], "kernel_route": res["auto"]}


XLSTM_TRAIN_LAYERS = 8  # one period: 7 mLSTM blocks, then an sLSTM


def recurrent_phases(torch, ops, train) -> dict:
    """Phases 16-20 (cells K-O): QAT of xlstm-350m one period deep through
    the CLI (3 steps saving at 2, then a restored 4th); serving full-depth
    recurrentgemma-9b and xlstm-350m through greedy_generate; QAT of
    recurrentgemma-9b cut to one period (3 layers) and of
    llama-3.2-vision-11b cut to one period (5 layers, one cross layer)
    through run_training, the latter's decode against its forward."""
    import shutil
    from repro_torch.configs.registry import get_config
    from repro_torch.core.policy import get_preset
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    out = {}
    # 16 (K). xlstm-350m QAT at full width, one period deep (8 layers: 24
    # before PR 30, cut to fit the run's time limit), through the CLI
    ckpt_dir = ROOT / "build" / "chip_smoke_xlstm_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    xargv = ["--arch", "xlstm-350m", "--quant", "w4a4", "--kd", "mckd", "--batch", "8",
             "--seq", "512", "--layers", str(XLSTM_TRAIN_LAYERS), "--save-every", "2",
             "--ckpt", str(ckpt_dir)]
    first = train_phase(torch, ops, train, xargv + ["--steps", "3"], 0, 3)
    resumed = train_phase(torch, ops, train, xargv + ["--steps", "4"], 3, 1)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    for run, n in ((first, 3), (resumed, 1)):
        run.update(cfg=get_config("xlstm-350m").replace(n_layers=XLSTM_TRAIN_LAYERS),
                   qcfg=get_preset("w4a4"))
        per_step = check_launches(run, n, 8 * 512)
    out["K"] = {"s_per_step": first["s_step"], "tokens_per_s": first["tokens_s"],
                "step_seconds": first["report"].step_seconds,
                "grad_norms": first["report"].grad_norms,
                "peak_gib": (first["report"].peak_bytes or 0) / 2**30,
                "losses": first["report"].losses + resumed["report"].losses,
                "launches_per_step": per_step, "counts": first["counts"]}
    torch.cuda.empty_cache()
    # 17 (L). recurrentgemma-9b served at full width and depth
    out["L"] = greedy_serve_phase(
        torch, ops, M, serve, "recurrentgemma-9b", "w4a4",
        path_kernels=("int4_matmul", "pooled_decode_attention"), cut_layers=3)
    # 18 (M). xlstm-350m served at full width and depth
    out["M"] = greedy_serve_phase(
        torch, ops, M, serve, "xlstm-350m", "w4a4",
        path_kernels=("int4_matmul", "int_matmul"), cut_layers=8)
    # 19 (N). recurrentgemma-9b QAT, cut to one period
    cfg = get_config("recurrentgemma-9b").replace(n_layers=3)
    run = training_run(torch, ops, cfg, get_preset("w4a4"), batch=8, seq=512,
                       steps=2, tag="rgemma", strict_health=True)
    out["N"] = {"s_per_step": run["s_step"], "tokens_per_s": run["tokens_s"],
                "step_seconds": run["report"].step_seconds,
                "peak_gib": (run["report"].peak_bytes or 0) / 2**30,
                "losses": run["report"].losses,
                "launches_per_step": check_launches(run, 2, 8 * 512),
                "counts": run["counts"]}
    torch.cuda.empty_cache()
    # 20 (O). llama-3.2-vision-11b QAT, cut to one period, 1024 patches
    cfg = get_config("llama-3.2-vision-11b").replace(n_layers=5)
    run = training_run(torch, ops, cfg, get_preset("w4a4"), batch=4, seq=512,
                       steps=2, tag="vision", strict_health=True)
    out["O"] = {"s_per_step": run["s_step"], "tokens_per_s": run["tokens_s"],
                "step_seconds": run["report"].step_seconds,
                "peak_gib": (run["report"].peak_bytes or 0) / 2**30,
                "losses": run["report"].losses,
                "launches_per_step": check_launches(
                    run, 2, 4 * 512, frontend_rows=4 * cfg.n_frontend_tokens),
                "counts": run["counts"]}
    torch.cuda.empty_cache()
    out["O"]["decode_vs_forward"] = cross_decode_check(torch, cfg, get_preset("w4a4"))
    return out


# ---------------------------------------------------------------------------
# phase 14: the MCKD store on the card
# ---------------------------------------------------------------------------

def mckd_store_phase(torch) -> dict:
    """Full-width paper-bert-base's fp teacher (random, seed 0) builds one
    MCKD shard: 2 batches of 8 x 256 tokens, 4 window_crop views of 128
    each, top-16 labels. iter_shard reads every item back bit for bit
    against the labels of the teacher's logits as it built them; then one
    make_train_step step (w2a2, MCKD from the shard's first item, no
    teacher in the loop) gives a finite loss and health 0."""
    import numpy as np
    import shutil
    from repro_torch.configs.registry import get_config
    from repro_torch.core.kd import make_topk_labels
    from repro_torch.core.policy import QuantConfig, get_preset
    from repro_torch.data.mckd_store import MCKDStore, window_crop
    from repro_torch.data.synthetic import DataConfig, sample_batch
    from repro_torch.models import model as M
    from repro_torch.train.sentinel import SentinelConfig
    from repro_torch.train.state import TrainConfig, init_state
    from repro_torch.train.train_step import make_train_step
    cfg, fp = get_config("paper-bert-base"), QuantConfig(mode="off")
    root = ROOT / "build" / "chip_smoke_mckd"
    shutil.rmtree(root, ignore_errors=True)
    t_params = M.init_params(cfg, fp, torch.Generator(device="cuda").manual_seed(0), "cuda")
    built = []

    @torch.no_grad()
    def teacher_apply(view):
        b = {k: torch.from_numpy(np.ascontiguousarray(v)).cuda() for k, v in view.items()}
        logits = M.forward(t_params, b, cfg, fp)[0]
        built.append([t.cpu().numpy() for t in make_topk_labels(logits, 16)])
        return logits

    store = MCKDStore(str(root), k=16, n_crops=4)
    batches = [sample_batch(cfg, DataConfig(), i, 8, 256) for i in range(2)]
    t0 = time.perf_counter()
    store.build_shard(0, teacher_apply, batches, lambda b, m: window_crop(b, m, 128))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    items = list(store.iter_shard(0))
    same = len(items) == len(built) == 8 and all(
        np.array_equal(it["kd_idx"], ki) and np.array_equal(
            it["kd_p"].view(np.int32), kp.view(np.int32))
        for it, (ki, kp) in zip(items, built))
    del t_params
    qcfg = get_preset("w2a2")
    tcfg = TrainConfig(total_steps=4, warmup_steps=1, kd="mckd", kd_topk=16,
                       sentinel=SentinelConfig())
    state = init_state(cfg, qcfg, tcfg, torch.Generator(device="cuda").manual_seed(1), "cuda")
    _, m = make_train_step(cfg, qcfg, tcfg)(
        state, {k: torch.from_numpy(v).cuda() for k, v in items[0].items()})
    loss, health = float(m["loss"]), int(m["health"])
    shutil.rmtree(root, ignore_errors=True)
    log(f"mckd store: {cfg.name} fp teacher, 2 batches x 4 views of 8 x 128, "
        f"top-16: built in {build_s:.2f} s, {len(items)} items read back bit for bit: "
        f"{same}; one w2a2 MCKD step from the shard: loss {loss:.4f}, health {health}")
    if not same:
        fail("MCKD store: the shard read back differs from the labels built")
    if not (loss == loss and abs(loss) < float("inf")) or health:
        fail(f"MCKD step from the store: loss {loss}, health {health}")
    return {"items": len(items), "bit_equal": same, "build_s": build_s,
            "loss": loss, "health": health}


# ---------------------------------------------------------------------------
# phase 15: the paper-table twins
# ---------------------------------------------------------------------------

TABLES = ("table1_sensitivity", "table2_sdam", "table4_qat", "table5_kd",
          "table7_oscillation")
# 10 steps a run (20 before PR 30) to fit the run's time limit
TABLE_STEPS = 10


def tables_phase(torch) -> dict:
    """Each paper-table twin at its reference size (reduced 2-layer
    qwen1.5-0.5b, batch 16 x 16) with its step count cut to TABLE_STEPS;
    prints its rows, every value finite."""
    import importlib
    import math
    out = {}
    for name in TABLES:
        mod = importlib.import_module(f"repro_torch.tables.{name}")
        t0 = time.perf_counter()
        rows = mod.run(steps=TABLE_STEPS, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        flat = (rows.items() if isinstance(rows, dict) else
                [(r[0] if len(r) == 3 else f"{r[0]} {r[1]}-bit", r[-2:]) for r in rows])
        log(f"table {name}: {TABLE_STEPS} steps a run, {wall:.1f} s")
        vals = []
        for key, v in flat:
            if isinstance(v, dict):
                vals += list(v.values())
                txt = ", ".join(f"{k} {x:.4g}" for k, x in v.items())
            elif isinstance(v, float):
                vals.append(v)
                txt = f"SDAM {v:.4e}"
            else:
                vals += list(v)
                txt = f"eval CE {v[0]:.4f}, acc {v[1]:.4f}"
            log(f"  {key}: {txt}")
        if not all(isinstance(x, float) and math.isfinite(x) for x in vals):
            fail(f"{name}: a value is not finite: {rows}")
        out[name] = {"steps": TABLE_STEPS, "wall_s": wall, "rows": rows}
    return out

# ---------------------------------------------------------------------------
# phase 10: the quantizer kernels (fake_quant_2d, fake_quant_rows,
# bin_stats_2d) and the kernel benchmark, their entry point
# ---------------------------------------------------------------------------

def _operand(torch, shape, dtype, std, gen, misaligned: bool):
    """randn * std on the card in `dtype`; misaligned: a contiguous view
    that starts one element past an aligned allocation (the kernels' scalar,
    unvectorised path)."""
    n = 1
    for d in shape:
        n *= d
    base = (torch.randn((n + 1,), generator=gen, device="cuda") * std).to(dtype)
    return base[1:].reshape(shape) if misaligned else base[:n].reshape(shape)


def check_fake_quant(torch, timer, fq, ref, label, shape, dtype, q_n, q_p,
                     gen, *, std=1.0, scale=None, offset=None,
                     misaligned=False) -> dict:
    """fake_quant_2d against its plain version: bit for bit. scale None =
    the LSQ init 2 mean|x| / sqrt(Q_P), computed on the card."""
    x = _operand(torch, shape, dtype, std, gen, misaligned)
    s = (2 * x.float().abs().mean() / q_p ** 0.5 if scale is None
         else torch.tensor(scale, device="cuda"))
    b = None if offset is None else torch.tensor(offset, device="cuda")
    kern = lambda: fq.fake_quant_2d(x, s, b, q_n=q_n, q_p=q_p)
    plain = lambda: ref.fake_quant_2d(x, s, b, q_n=q_n, q_p=q_p)
    y_k, y_r = kern(), plain()
    torch.cuda.synchronize()
    same = _same_bits(torch, y_k, y_r)
    err = (y_k.float() - y_r.float()).abs().max().item()
    nbytes = 2 * x.numel() * x.element_size() + 4 + (0 if b is None else 4)
    b_ms, b_by = bound(nbytes, 5.0 * x.numel(), F32_OPS_PER_S)
    lib_ms = None
    if dtype == torch.float32:  # offset 0; multiplies by 1/s: not bit-equal
        zp = torch.zeros((1,), dtype=torch.int32, device="cuda")
        sv = s.reshape(1)
        lib_ms = timer.ms(lambda: torch.fake_quantize_per_tensor_affine(
            x, sv, zp, -q_n, q_p))
    row = {"shape": list(shape), "case": label, "max_abs_err": err,
           "tol": "bit-equal", "ms": timer.ms(kern), "plain_ms": timer.ms(plain),
           "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by}
    lib = "n/a (bf16)" if lib_ms is None else f"{lib_ms:.4f} ms"
    log(f"  fake_quant_2d {label} {tuple(shape)} {str(dtype)[6:]} Q_N={q_n} "
        f"Q_P={q_p}{' offset' if b is not None else ''}"
        f"{' misaligned' if misaligned else ''}: bit-equal {same} (max|err| "
        f"{err:.3e}); kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} "
        f"ms, fake_quantize_per_tensor_affine {lib}, bound {b_ms:.4f} ms ({b_by})")
    if not same:
        fail(f"fake_quant_2d {label} {shape} differs from its plain version")
    return row


def check_fake_quant_rows(torch, timer, fq, ref, label, shape, dtype, q_n,
                          q_p, gen, *, std=1.0, misaligned=False) -> dict:
    """fake_quant_rows (one scale a row, the LSQ init of each row) against
    its plain version: bit for bit."""
    x = _operand(torch, shape, dtype, std, gen, misaligned)
    rs = 2 * x.float().abs().mean(dim=1, keepdim=True) / q_p ** 0.5
    kern = lambda: fq.fake_quant_rows(x, rs, q_n=q_n, q_p=q_p)
    plain = lambda: ref.fake_quant_rows(x, rs, q_n=q_n, q_p=q_p)
    y_k, y_r = kern(), plain()
    torch.cuda.synchronize()
    same = _same_bits(torch, y_k, y_r)
    err = (y_k.float() - y_r.float()).abs().max().item()
    nbytes = 2 * x.numel() * x.element_size() + 4 * shape[0]
    b_ms, b_by = bound(nbytes, 5.0 * x.numel(), F32_OPS_PER_S)
    lib_ms = None
    if dtype == torch.float32:
        zp = torch.zeros((shape[0],), dtype=torch.int32, device="cuda")
        sv = rs.reshape(-1)
        lib_ms = timer.ms(lambda: torch.fake_quantize_per_channel_affine(
            x, sv, zp, 0, -q_n, q_p))
    row = {"shape": list(shape), "case": label, "max_abs_err": err,
           "tol": "bit-equal", "ms": timer.ms(kern), "plain_ms": timer.ms(plain),
           "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by}
    lib = "n/a (bf16)" if lib_ms is None else f"{lib_ms:.4f} ms"
    log(f"  fake_quant_rows {label} {tuple(shape)} {str(dtype)[6:]} Q_N={q_n} "
        f"Q_P={q_p}{' misaligned' if misaligned else ''}: bit-equal {same} "
        f"(max|err| {err:.3e}); kernel {row['ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, fake_quantize_per_channel_affine {lib}, "
        f"bound {b_ms:.4f} ms ({b_by})")
    if not same:
        fail(f"fake_quant_rows {label} {shape} differs from its plain version")
    return row


def check_bin_stats(torch, timer, bs, ref, label, shape, q_n, q_p, gen, *,
                    misaligned=False) -> dict:
    """bin_stats_2d against its plain version: counts equal (both round an
    exact count once, exact below 2^24), summing to the element count in
    f64 (within the f32 rounding of counts past 2^24); sum and sum of
    squares within 1e-5 of each bin's sum of |summands|."""
    w = _operand(torch, shape, torch.float32, shape[-1] ** -0.5, gen, misaligned)
    s = 2 * w.abs().mean() / q_p ** 0.5
    kern = lambda: bs.bin_stats_2d(w, s, q_n=q_n, q_p=q_p)
    plain = lambda: ref.bin_stats_2d(w, s, q_n=q_n, q_p=q_p)
    got, want = kern(), plain()
    torch.cuda.synchronize()
    n_bins = q_n + q_p + 1
    codes = (torch.clamp(torch.round(w.reshape(-1) / torch.clamp(s, min=1e-9)),
                         -q_n, q_p).to(torch.int64) + q_n)
    wd = w.reshape(-1).double()
    mag = torch.zeros((2, n_bins), dtype=torch.float64, device="cuda")
    mag[0].index_add_(0, codes, wd.abs())
    mag[1].index_add_(0, codes, wd * wd)
    del codes, wd
    counts_equal = torch.equal(got[0], want[0])
    slack = torch.where(got[0] >= 2 ** 24, got[0].abs() * 2.0 ** -24,
                        torch.zeros_like(got[0])).double().sum().item()
    count_gap = abs(got[0].double().sum().item() - w.numel())
    d = (got[1:].double() - want[1:].double()).abs()
    sums_ok = bool((d <= 1e-5 * mag).all())
    err = d.max().item()
    nbytes = w.numel() * 4 + 4 + 3 * n_bins * 4
    b_ms, b_by = bound(nbytes, 8.0 * w.numel(), F32_OPS_PER_S)
    row = {"shape": list(shape), "case": label, "bins": n_bins,
           "max_abs_err": err,
           "tol": "counts equal; sums 1e-5 x per-bin sum|summands|",
           "ms": timer.ms(kern), "plain_ms": timer.ms(plain),
           "library_ms": None,
           "library": "none: no one PyTorch call gives per-bin count, sum "
                      "and sum of squares (histc counts only; bincount "
                      "needs the codes)",
           "bound_ms": b_ms, "bound_by": b_by,
           "device_kernels": device_kernels(torch, kern)}
    log(f"  bin_stats_2d {label} {tuple(shape)} bins={n_bins}"
        f"{' misaligned' if misaligned else ''}: counts equal {counts_equal}, "
        f"count sum - n {count_gap:.0f} (slack {slack:.0f}), sums within bar "
        f"{sums_ok} (max|err| {err:.3e}); kernel {row['ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, library n/a, bound {b_ms:.4f} ms ({b_by}); "
        f"{', '.join(row['device_kernels'])}")
    if not (counts_equal and count_gap <= slack and sums_ok):
        fail(f"bin_stats_2d {label} {shape} disagrees with its plain version")
    return row


# bin_stats_2d's rows of phase 10 (`chip_compare.py` runs the same ones):
# (label, shape, Q_N, Q_P), options
BIN_STATS_ROWS = ((("kernel_bench wq", (4096, 1024), 8, 7), {}),
                  (("granite-8b w_in w4", (4096, 14336), 8, 7), {}),
                  (("granite-8b w_in w8", (4096, 14336), 128, 127), {}),
                  (("odd", (513, 7), 4, 3), {}), (("odd", (1000, 33), 2, 1), {}),
                  (("odd", (100, 33), 128, 127), {"misaligned": True}),
                  (("odd", (64, 64), 1, 1), {}))


def quantizer_kernel_checks(torch, timer, ops, ref, gen) -> tuple[dict, int]:
    """Kernels 10-12 at the kernel benchmark's own shape, at full-width
    tensors of the models the repo trains, and at odd edges. Returns the
    rows and fake_quant_rows' launches here (no entry point reaches it)."""
    from repro_torch.kernels import bin_stats as bs, fake_quant as fq
    log("quantizer kernels (each against its plain version on the card):")
    f32, bf16 = torch.float32, torch.bfloat16
    rows = {"fake_quant_2d": [], "fake_quant_rows": [], "bin_stats_2d": []}
    for args, kw in (
            (("kernel_bench wq", (4096, 1024), f32, 8, 7),
             dict(std=0.1, scale=0.05)),
            (("granite-8b w_in w4", (4096, 14336), f32, 8, 7),
             dict(std=4096 ** -0.5)),
            (("granite-8b w_in w8", (4096, 14336), f32, 128, 127),
             dict(std=4096 ** -0.5)),
            (("qwen1.5-0.5b ffn act a4", (4096, 2816), bf16, 0, 15),
             dict(std=2.0, scale=0.3, offset=-0.2)),
            (("odd", (300, 700), f32, 0, 3), dict(scale=0.1, offset=0.05)),
            (("odd", (257, 129), bf16, 128, 127), dict(scale=0.07)),
            (("odd", (1, 640), f32, 2, 1), dict(scale=0.07)),
            (("odd", (1, 1001), bf16, 0, 15),
             dict(scale=0.1, offset=0.03, misaligned=True)),
            (("odd", (37, 53), f32, 4, 3), dict(scale=0.2, misaligned=True))):
        rows["fake_quant_2d"].append(check_fake_quant(
            torch, timer, fq, ref, *args, gen, **kw))
    ops.reset_launch_counts()
    for args, kw in (
            (("granite-moe experts w3", (32, 1024 * 512), f32, 4, 3),
             dict(std=1024 ** -0.5)),
            (("odd", (6, 960), bf16, 8, 7), {}),
            (("odd", (5, 35), f32, 2, 1), {}),
            (("odd", (70000, 3), f32, 8, 7), {}),
            (("odd", (3, 129), f32, 8, 7), dict(misaligned=True))):
        rows["fake_quant_rows"].append(check_fake_quant_rows(
            torch, timer, fq, ref, *args, gen, **kw))
    rows_launches = ops.launch_counts()["fake_quant_rows"]
    for args, kw in BIN_STATS_ROWS:
        rows["bin_stats_2d"].append(check_bin_stats(
            torch, timer, bs, ref, *args, gen, **kw))
        torch.cuda.empty_cache()
    return rows, rows_launches


# ---------------------------------------------------------------------------
# NaN and Inf through the quantizer kernels (rows of phases 2, 5 and 10)
# ---------------------------------------------------------------------------

def _nan_same(torch, got, want) -> tuple[bool, int]:
    """NaN at the same positions and every other element bit-equal (a NaN's
    payload bits aside). Returns (holds, NaN count)."""
    got, want = got.float(), want.float()
    gn, wn = torch.isnan(got), torch.isnan(want)
    same = torch.equal(gn, wn) and torch.equal(
        torch.where(wn, 0.0, got).view(torch.int32),
        torch.where(wn, 0.0, want).view(torch.int32))
    return same, int(wn.sum().item())


def _grid_qat_operands(torch, gen, e, m, k, n):
    """QAT operands on power-of-two grids (x on 2^-3, w on 2^-6, dY on 2^-3,
    scales 2^-2 and 2^-5, offset -2^-1), so every product and partial sum is
    exact in f32 and a finite output does not depend on the summation
    order; then NaN in 3 weights and 3 activations, +Inf and -Inf in one
    activation each and one NaN column scale (expert e - 1 only when e > 1:
    the other experts stay finite). e = 0: the 2D operands."""
    dev = "cuda"
    lead = (e,) if e else ()
    x = (torch.randint(-16, 17, lead + (m, k), generator=gen, device=dev)
         * 2.0 ** -3).to(torch.bfloat16)
    w = torch.randint(-20, 21, lead + (k, n), generator=gen, device=dev) * 2.0 ** -6
    dy = torch.randint(-8, 9, lead + (m, n), generator=gen, device=dev) * 2.0 ** -3
    ws = torch.full(lead + ((n,) if e else (1, n)), 2.0 ** -5, device=dev)
    xs, wsl, wss = (x[-1], w[-1], ws[-1]) if e else (x, w, ws.view(-1))
    nan = float("nan")
    for r, c in ((1, 2), (m // 2, k - 1), (m - 1, 0)):
        xs[r, c] = nan
    xs[2, 3], xs[3, 4] = float("inf"), float("-inf")
    for r, c in ((0, 1), (k // 3, n - 2), (k - 1, 5)):
        wsl[r, c] = nan
    wss[7] = nan
    a_s = torch.full((e, 1) if e else (), 0.25, device=dev)
    a_b = torch.full((e, 1) if e else (), -0.5, device=dev)
    return x, w, a_s, a_b, ws, dy


def nan_qat_rows(torch, qmm, ref, gen) -> list:
    """Phase 5's NaN / Inf rows: quant_matmul, quant_matmul_bwd on one plane
    (bf16 dY) and on three (f32 dY), and quant_matmul_batched (expert 1 of
    2 carrying the non-finite values), at (4096, 1024, 2816) on grid
    operands (`_grid_qat_operands`): every output NaN where the plain
    version's is, bit-equal elsewhere."""
    m, k, n = 8 * 512, 1024, 2816
    out = []
    x, w, a_s, a_b, ws, dy = _grid_qat_operands(torch, gen, 0, m, k, n)
    cases = [("quant_matmul", lambda: (qmm.quant_matmul(x, w, a_s, a_b, ws, **QAT_QS),),
              lambda: (ref.quant_matmul(x, w, a_s, a_b, ws, **QAT_QS),))]
    for planes, rc in ((1, True), (3, False)):
        cases.append((f"quant_matmul_bwd, {planes} plane{'s' * (planes > 1)}",
                      lambda rc=rc: qmm.quant_matmul_bwd(dy, x, w, a_s, a_b, ws,
                                                         round_cot=rc, **QAT_QS),
                      lambda rc=rc: ref.quant_matmul_bwd(dy, x, w, a_s, a_b, ws,
                                                         round_cot=rc, **QAT_QS)))
    for name, kern, plain in cases:
        out.append(_nan_row(torch, name, [m, k, n], kern, plain))
    del x, w, dy
    torch.cuda.empty_cache()
    x, w, a_s, a_b, ws, _ = _grid_qat_operands(torch, gen, 2, m, k, n)
    out.append(_nan_row(torch, "quant_matmul_batched", [2, m, k, n],
                        lambda: (qmm.quant_matmul_batched(x, w, a_s, a_b, ws, **QAT_QS),),
                        lambda: (ref.quant_matmul_batched(x, w, a_s, a_b, ws, **QAT_QS),)))
    if out[-1]["nan"][0] == 0 or not bool(torch.isfinite(
            qmm.quant_matmul_batched(x, w, a_s, a_b, ws, **QAT_QS)[0]).all()):
        fail("quant_matmul_batched: expert 1's NaN did not show, or expert 0 is not finite")
    return out


def _nan_row(torch, name, shape, kern, plain) -> dict:
    got, want = kern(), plain()
    torch.cuda.synchronize()
    res = [_nan_same(torch, g, wv) for g, wv in zip(got, want)]
    row = {"name": name, "shape": shape, "nan": [c for _, c in res],
           "same": all(ok for ok, _ in res)}
    log(f"  {name} {tuple(shape)} with NaN / ±Inf inputs: NaN where the plain "
        f"version's is and bit-equal elsewhere {row['same']} (NaN counts by "
        f"output {row['nan']})")
    if not row["same"] or not any(row["nan"]):
        fail(f"{name} {shape}: NaN / Inf not passed on as its plain version does")
    return row


def nan_serving_rows(torch, qmm, ref, gen) -> list:
    """Phase 2's NaN-scale rows: int_matmul and int4_matmul at granite-8b's
    w_in (4, 4096, 14336) with one NaN column scale (and one 0 scale, at
    the 1e-9 floor), x and the scales on power-of-two grids so that the
    sums are exact: the NaN column where the plain version's is, bit-equal
    elsewhere."""
    out = []
    m, k, n = 4, 4096, 14336
    for packed in (False, True):
        x, codes, w, _ = _int_operands(torch, packed, m, k, n, gen)
        x = (torch.randint(-8, 9, (m, k), generator=gen, device="cuda")
             * 2.0 ** -3).to(torch.bfloat16)
        scale = torch.full((n,), 2.0 ** -6, device="cuda")
        scale[5], scale[6] = float("nan"), 0.0
        name = "int4_matmul" if packed else "int_matmul"
        kern, plain = getattr(qmm, name), getattr(ref, name)
        row = _nan_row(torch, f"{name} (NaN column scale)", [m, k, n],
                       lambda: (kern(x, w, scale),), lambda: (plain(x, w, scale),))
        if row["nan"] != [m]:
            fail(f"{name}: a NaN column scale gave {row['nan']} NaN, want {m}")
        out.append(row)
    return out


def nan_quantizer_rows(torch, ref, gen) -> list:
    """Phase 10's NaN / Inf rows: fake_quant_2d (f32 with offset, then a NaN
    scale), fake_quant_rows (one NaN row scale) on (4096, 1024) with NaN
    and ±Inf in x: NaN where the plain version's is, bit-equal elsewhere;
    bin_stats_2d with a w whose square overflows f32, a +Inf, NaN with
    ±Inf, and a NaN scale: counts equal, NaN and ±Inf where the plain
    version has them, the finite sums within 1e-5 of each bin's sum of
    |summands| (of its finite elements)."""
    from repro_torch.kernels import bin_stats as bs, fake_quant as fq
    out = []
    x = torch.randn((4096, 1024), generator=gen, device="cuda")
    x[0, 3] = x[17, 0] = x[4095, 1023] = float("nan")
    x[1, 1], x[2, 7] = float("inf"), float("-inf")
    s, b, nan = torch.tensor(0.3, device="cuda"), torch.tensor(-0.2, device="cuda"), \
        torch.tensor(float("nan"), device="cuda")
    for label, sc in (("finite scale, offset", s), ("NaN scale", nan)):
        out.append(_nan_row(
            torch, f"fake_quant_2d ({label})", [4096, 1024],
            lambda sc=sc: (fq.fake_quant_2d(x, sc, b, q_n=0, q_p=15),),
            lambda sc=sc: (ref.fake_quant_2d(x, sc, b, q_n=0, q_p=15),)))
    rs = torch.full((4096, 1), 0.2, device="cuda")
    rs[9] = float("nan")
    out.append(_nan_row(torch, "fake_quant_rows (a NaN row scale)", [4096, 1024],
                        lambda: (fq.fake_quant_rows(x, rs, q_n=4, q_p=3),),
                        lambda: (ref.fake_quant_rows(x, rs, q_n=4, q_p=3),)))
    base = torch.randn((4096, 1024), generator=gen, device="cuda") * 0.02
    for label, poison, sc in (
            ("w^2 past f32", {(5, 5): 3e19}, 0.01),
            ("+Inf", {(6, 1): float("inf")}, 0.01),
            ("NaN, ±Inf", {(0, 3): float("nan"), (1, 1): float("inf"),
                           (2, 7): float("-inf")}, 0.01),
            ("NaN scale", {}, float("nan"))):
        w = base.clone()
        for at, v in poison.items():
            w[at] = v
        sc = torch.tensor(sc, device="cuda")
        got, want = bs.bin_stats_2d(w, sc, q_n=8, q_p=7), ref.bin_stats_2d(w, sc, q_n=8, q_p=7)
        torch.cuda.synchronize()
        # each bin's sum of |summands| over its finite elements: the bar's scale
        u = torch.clamp(torch.round(w / sc), -8, 7)
        ok = torch.isfinite(w) & ~torch.isnan(u)
        codes, wd = (u[ok] + 8).long(), w[ok].double()
        mag = torch.zeros((2, 16), dtype=torch.float64, device="cuda")
        mag[0].index_add_(0, codes, wd.abs())
        mag[1].index_add_(0, codes, wd * wd)
        fin = torch.isfinite(want[1:])
        inf = torch.isinf(want)
        same = (torch.equal(got[0], want[0])
                and torch.equal(torch.isnan(got), torch.isnan(want))
                and torch.equal(inf, torch.isinf(got)) and torch.equal(got[inf], want[inf])
                and bool(((got[1:] - want[1:]).double().abs() <= 1e-5 * mag)[fin].all()))
        row = {"name": f"bin_stats_2d ({label})", "shape": [4096, 1024],
               "nan": [int(torch.isnan(want).sum().item())], "same": same,
               "finite_sums": int(fin.sum().item())}
        log(f"  bin_stats_2d (4096, 1024) bins=16 {label}: counts equal, NaN / ±Inf "
            f"where the plain version has them, finite sums within the bar: {same} "
            f"({row['nan'][0]} NaN and {row['finite_sums']} finite of 32 sums)")
        if not same:
            fail(f"bin_stats_2d ({label}) disagrees with its plain version: "
                 f"{got.tolist()} vs {want.tolist()}")
        out.append(row)
    return out


# ---------------------------------------------------------------------------
# phases 21-22: the training half of the fault contract, gradient compression
# ---------------------------------------------------------------------------

def fault_contract_phase(torch, ops) -> dict:
    """Phase 21: `run_training` on full-width paper-bert-base (w2a2, OBR,
    oscillation tracked, as in phase 14; batch 32 x 128) through the
    scenario of tests/test_sentinel_faults.py::test_e2e_nan_rollback_recovery:
    14 steps saving every 4 (synchronous saves), SentinelConfig(k 2, 2
    retries, backoff 0.5), the token embedding NaN-poisoned before loop step
    9 and the step-8 checkpoint byte-corrupted (seed 11). Gates: loop steps 9
    and 10 NONFINITE_LOSS, no other fatal bit, one rollback, to step 4 (not
    the corrupt 8), lr_scale 0.5, 20 steps run, final step 13 with a finite
    loss, step 12's checkpoint verified, and the QAT launches equal to
    `qat_launches_per_step` x 20 (a fatal step runs its forward and backward
    too). Then the SIGTERM case (10 steps, SIGTERM before step 3): a forced
    checkpoint at 3, a clean exit, the signal handlers restored. Prints the
    health bits step by step, each save's seconds and the checkpoint's size."""
    import shutil
    import signal
    from repro_torch.configs.registry import get_config
    from repro_torch.core.policy import get_preset
    from repro_torch.data.synthetic import DataConfig
    from repro_torch.launch import train
    from repro_torch.testing import faultinject as fi
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import sentinel as S
    from repro_torch.train.fault_tolerance import CheckpointManager
    from repro_torch.train.state import TrainConfig
    cfg, batch, seq = get_config("paper-bert-base"), 32, 128
    qcfg = get_preset("w2a2").replace(track_oscillation=True)
    d = ROOT / "build" / "chip_smoke_fault_ckpt"
    shutil.rmtree(d, ignore_errors=True)
    scfg = S.SentinelConfig(k_consecutive=2, max_retries=2, lr_backoff=0.5)
    tcfg = TrainConfig(total_steps=14, warmup_steps=2, sentinel=scfg)
    handler = signal.getsignal(signal.SIGTERM)
    mgr = CheckpointManager(str(d), save_every=4, async_io=False)
    hooks = fi.chain(fi.OneShot(9, fi.poison_params_nan),
                     fi.OneShot(9, lambda st: (fi.corrupt_checkpoint(
                         str(d), step=8, seed=11), None)[1]))
    saves, real_save = [], ckpt.save

    def timed_save(*a, **kw):
        t0 = time.perf_counter()
        path = real_save(*a, **kw)
        saves.append({"step": a[2], "s": time.perf_counter() - t0,
                      "bytes": Path(path).stat().st_size})
        return path

    log(f"fault contract: run_training({cfg.name}, {cfg.n_layers} layers, w2a2 + OBR, "
        f"track_oscillation, batch {batch} x {seq}, 14 steps, save every 4; NaN "
        f"embedding and a corrupt step-8 checkpoint at step 9)")
    ckpt.save = timed_save
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        rep = train.run_training(cfg, qcfg, tcfg, DataConfig(), steps=14,
                                 batch_size=batch, seq_len=seq, ckpt_dir=str(d),
                                 save_every=4, mgr=mgr, on_step=hooks, log_every=0,
                                 device="cuda")
    finally:
        ckpt.save = real_save
    wall = time.perf_counter() - t0
    counts = {k: ops.launch_counts()[k] for k in QAT_KERNELS}
    verified_12 = ckpt.verify(str(d), 12)
    fatal = S.NONFINITE_LOSS | S.NONFINITE_GRAD
    log(f"  wall {wall:.1f} s, steps run {rep.steps_run}, final step {rep.final_step}, "
        f"rollbacks {rep.rollbacks} to {rep.rollback_to}, lr_scale {rep.lr_scale}, "
        f"skipped {rep.skipped}, final loss {rep.final_loss:.6g}, step 12 verified "
        f"{verified_12}")
    log(f"  health by step run: {[S.describe(h) for h in rep.healths]}")
    log(f"  losses {rep.losses}; the replayed step 5 {rep.losses[11]!r} against its "
        f"first run {rep.losses[5]!r}")
    log(f"  saves: " + ", ".join(f"step {s['step']} {s['s']:.2f} s" for s in saves)
        + f"; checkpoint {saves[0]['bytes'] / 2**30:.3f} GiB")
    healths_ok = (len(rep.healths) == 20
                  and all(rep.healths[i] & S.NONFINITE_LOSS for i in (9, 10))
                  and not any(h & scfg.fatal_bits for i, h in enumerate(rep.healths)
                              if i not in (9, 10)))
    gates = [("health", healths_ok), ("rollbacks", rep.rollbacks == 1),
             ("to step 4", rep.rollback_to == [4]), ("lr_scale", rep.lr_scale == 0.5),
             ("steps run", rep.steps_run == 20), ("final step", rep.final_step == 13),
             ("final loss", rep.final_loss == rep.final_loss
              and abs(rep.final_loss) < float("inf")),
             ("step 12 verified", verified_12), ("saves", len(saves) >= 3)]
    bad = [g for g, ok in gates if not ok]
    if bad:
        fail(f"fault contract on {cfg.name}: {bad} ({rep})")
    run = {"counts": counts, "cfg": cfg, "qcfg": qcfg}
    per_step = check_launches(run, rep.steps_run, batch * seq)
    shutil.rmtree(d, ignore_errors=True)

    # SIGTERM: a forced checkpoint and a clean exit at the step boundary
    d2 = ROOT / "build" / "chip_smoke_sigterm_ckpt"
    shutil.rmtree(d2, ignore_errors=True)
    mgr2 = CheckpointManager(str(d2), save_every=100, async_io=False)
    if signal.getsignal(signal.SIGTERM) != mgr2.guard._handler:
        fail("the preemption guard did not take SIGTERM: firing it would end this run")
    t0 = time.perf_counter()
    rep2 = train.run_training(cfg, qcfg, TrainConfig(total_steps=10, warmup_steps=2,
                                                     sentinel=S.SentinelConfig()),
                              DataConfig(), steps=10, batch_size=batch, seq_len=seq,
                              ckpt_dir=str(d2), save_every=100, mgr=mgr2,
                              on_step=fi.sigterm_at(3), log_every=0, device="cuda")
    restored = signal.getsignal(signal.SIGTERM) == handler
    latest = ckpt.latest_step(str(d2), verified=True)
    log(f"  SIGTERM before step 3: preempted {rep2.preempted}, final step "
        f"{rep2.final_step}, newest verified checkpoint {latest}, final loss "
        f"{rep2.final_loss:.6g}, handlers restored {restored} "
        f"({time.perf_counter() - t0:.1f} s)")
    shutil.rmtree(d2, ignore_errors=True)
    if not (rep2.preempted and rep2.final_step == 3 and latest == 3 and restored
            and rep2.final_loss == rep2.final_loss):
        fail(f"SIGTERM on {cfg.name}: {rep2}, newest checkpoint {latest}, "
             f"handlers restored {restored}")
    return {"wall_s": wall, "steps_run": rep.steps_run, "final_step": rep.final_step,
            "rollbacks": rep.rollbacks, "rollback_to": rep.rollback_to,
            "lr_scale": rep.lr_scale, "healths": rep.healths, "losses": rep.losses,
            "step_seconds": rep.step_seconds, "saves": saves,
            "peak_gib": (rep.peak_bytes or 0) / 2**30, "launches": counts,
            "launches_per_step": per_step,
            "sigterm": {"preempted": rep2.preempted, "final_step": rep2.final_step,
                        "checkpoint": latest, "handlers_restored": restored}}


def compression_phase(torch, ops, train, cell_c: dict, argv: list) -> dict:
    """Phase 22: cell C's run (`repro_torch.launch.train`, full-width
    qwen1.5-0.5b, w4a4, MCKD, 8 x 512, 3 steps) again with --compress-grads,
    beside phase 6's uncompressed run: step 0's loss bit-equal, finite
    losses and health 0, launches equal the formula, and after every step
    each leaf's |err| <= scale / 2 (times 1 + 2^-14 for the f32 roundings of
    gf / scale, code x scale and gf - deq; scale = max|deq| / 127, read by a
    wrapper around the step's `compress_tree`: two multi-tensor max-norms
    a step); then `compress_leaf` on the
    card bit-equal to the same call on the CPU for one gradient of the tied
    head's size (152,064 x 1,024)."""
    from repro_torch import tree as T
    from repro_torch.configs import registry
    from repro_torch.core.policy import get_preset
    from repro_torch.optim import grad_compress as gc
    from repro_torch.train import train_step as TS
    cfg = registry.get_config(argv[argv.index("--arch") + 1])
    tokens = int(argv[argv.index("--batch") + 1]) * int(argv[argv.index("--seq") + 1])
    ratios, real = [], TS.compress_tree

    def recorded(grads, err, **kw):  # max|err| / (max|deq| / 127)
        deq, new_err = real(grads, err, **kw)
        inf = float("inf")
        top = torch.stack(torch._foreach_norm(T.leaves(deq), inf))
        ratios.append((torch.stack(torch._foreach_norm(T.leaves(new_err), inf))
                       / torch.clamp(top / 127.0, min=1e-12)).max())
        return deq, new_err

    TS.compress_tree = recorded
    try:
        run = train_phase(torch, ops, train, argv + ["--compress-grads"], 0, 3)
    finally:
        TS.compress_tree = real
    run.update(cfg=cfg, qcfg=get_preset(argv[argv.index("--quant") + 1]))
    per_step = check_launches(run, 3, tokens)
    worst = max(float(r) for r in ratios)
    rep, base = run["report"], cell_c["report"]
    same0 = rep.losses[0] == base.losses[0]
    gen = torch.Generator().manual_seed(100 * SEED + 22)
    head = (cfg.padded_vocab, cfg.d_model)
    g = torch.randn(head, generator=gen) * 1e-3
    e = torch.randn(head, generator=gen) * 1e-6
    d_cpu, e_cpu = gc.compress_leaf(g, e)
    d_dev, e_dev = gc.compress_leaf(g.cuda(), e.cuda())
    leaf_same = (_same_bits(torch, d_dev.cpu(), d_cpu)
                 and _same_bits(torch, e_dev.cpu(), e_cpu))
    del g, e, d_cpu, e_cpu, d_dev, e_dev
    log(f"  compressed against cell C: step 0 loss {rep.losses[0]!r} vs "
        f"{base.losses[0]!r} (bit-equal {same0}); s/step {run['s_step']:.3f} vs "
        f"{cell_c['s_step']:.3f}, tokens/s {run['tokens_s']:.0f} vs "
        f"{cell_c['tokens_s']:.0f}, peak {(rep.peak_bytes or 0) / 2**30:.2f} vs "
        f"{(base.peak_bytes or 0) / 2**30:.2f} GiB; worst |err| / (scale / 2) "
        f"{2 * worst:.6f}; compress_leaf at {head} bit-equal to the CPU "
        f"{leaf_same}")
    if not (same0 and worst <= 0.5 * (1 + 2.0 ** -14) and leaf_same):
        fail(f"gradient compression: step 0 loss equal {same0}, worst |err| / scale "
             f"{worst}, compress_leaf as on the CPU {leaf_same}")
    return {"s_per_step": run["s_step"], "tokens_per_s": run["tokens_s"],
            "peak_gib": (rep.peak_bytes or 0) / 2**30, "losses": rep.losses,
            "healths": rep.healths, "step_seconds": rep.step_seconds,
            "launches_per_step": per_step, "err_over_half_scale": 2 * worst,
            "compress_leaf_as_cpu": leaf_same,
            "cell_c": {"s_per_step": cell_c["s_step"], "tokens_per_s": cell_c["tokens_s"],
                       "peak_gib": (base.peak_bytes or 0) / 2**30,
                       "losses": base.losses}}


def kernel_bench_phase(torch, ops) -> tuple[dict, dict]:
    """`repro_torch.launch.kernel_bench` on the card: --smoke, then the
    full run, whose launches of kernels 10 and 12 must be > 0."""
    from repro_torch.launch import kernel_bench
    out = ROOT / "build"
    argv = ["--smoke", "--out", str(out / "kernel_bench_smoke.json")]
    log(f"kernel bench: python -m repro_torch.launch.kernel_bench {' '.join(argv)}")
    if kernel_bench.main(argv) != 0:
        fail("kernel_bench --smoke failed a gate")
    argv = ["--out", str(out / "kernel_bench.json")]
    log(f"kernel bench: python -m repro_torch.launch.kernel_bench {' '.join(argv)}")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rc = kernel_bench.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    log(f"  wall {wall:.1f} s; launches {counts}")
    if rc != 0:
        fail("kernel_bench (full run) failed a gate")
    for name in ("fake_quant_2d", "bin_stats_2d"):
        if counts[name] <= 0:
            fail(f"{name} was never launched by the kernel benchmark: {counts}")
    res = json.loads((out / "kernel_bench.json").read_text())
    return counts, res


QAT_SOURCE = "qat_matmul"  # the kernel library of kernels 1-6 (`build.SOURCES`)


def background(fn, *args):
    """fn(*args) in a thread of its own: a `concurrent.futures.Future`,
    whose result() joins it and raises its exception."""
    from concurrent.futures import ThreadPoolExecutor
    pool = ThreadPoolExecutor(max_workers=1)
    try:
        return pool.submit(fn, *args)
    finally:
        pool.shutdown(wait=False)


def log_build(report: dict) -> None:
    """Each source's build seconds and ptxas' register use and spills."""
    for name, r in report.items():
        log(f"  {name}: {r['seconds']:.1f} s")
        entry = ""
        for line in r["log"].splitlines():
            if "Compiling entry function" in line:
                sym = line.split("'")[1]
                args = (["bf16"] if "bfloat16" in sym else []) + [
                    ("false", "true")[int(v)] for v in re.findall(r"Lb([01])E", sym)] + \
                    re.findall(r"Li(\d+)E", sym)
                entry = (_kernel_name(sym) + (f"<{', '.join(args)}>" if args else "")
                         + ": ")
            elif "Used" in line or "spill" in line.lower() and "0 bytes spill" not in line:
                log(f"    {entry}{line.strip()}")


def _kernel_name(sym: str) -> str:
    """The innermost name of a mangled kernel symbol: its length-prefixed
    components read in turn (the anonymous namespace's, then the kernel's)."""
    name, i = sym, 3 if sym.startswith("_ZN") else 2
    while (found := re.match(r"\d+", sym[i:])):
        n, i = int(found.group()), i + found.end()
        name, i = sym[i:i + n], i + n
    return name


# ---------------------------------------------------------------------------
# phase 25: the dry run and the H100 roofline
# ---------------------------------------------------------------------------

# (arch, shape) cells of the dry-run CLI on the 16 x 16 mesh (phase 25e)
DRYRUN_CLI = (("qwen1.5-0.5b", "train_4k"), ("qwen1.5-0.5b", "decode_32k"))
# the dry run's per_device_bytes of cell C over phase 6's measured peak
# (torch.cuda.max_memory_allocated): the bar written in PERF.md before
# phase 25 first ran on the card
MEM_BAR = (0.8, 1.2)


def start_dryrun_cli() -> list:
    """Phase 25(e)'s CLI cells, each in a process of its own at the lowest
    priority, started after the build: host work on the meta device (no
    card: CUDA_VISIBLE_DEVICES is empty), beside the card's phases. Any
    still running when the script exits are stopped."""
    import atexit
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    procs = []
    for arch, shape in DRYRUN_CLI:
        out = ROOT / "build" / f"chip_smoke_dryrun_{shape}.jsonl"
        out.parent.mkdir(parents=True, exist_ok=True)
        out.unlink(missing_ok=True)
        with open(out.with_suffix(".log"), "w") as logf:
            p = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                 "--shape", shape, "--mesh", "single", "--out", str(out)],
                cwd=ROOT, env=env, stdout=logf, stderr=subprocess.STDOUT,
                preexec_fn=lambda: os.nice(19))
        procs.append({"arch": arch, "shape": shape, "out": out, "proc": p,
                      "t0": time.perf_counter()})

    def stop():
        for c in procs:
            if c["proc"].poll() is None:
                c["proc"].kill()
                c["proc"].wait()
    atexit.register(stop)
    return procs


def _cost_diff(a: dict, b: dict, top: int = 20) -> list:
    """The per-op rows in which two counts differ."""
    rows = []
    for op in sorted(set(a["by_op"]) | set(b["by_op"])):
        x, y = a["by_op"].get(op), b["by_op"].get(op)
        if x != y:
            rows.append((op, x, y))
    return rows[:top]


def dryrun_phase(torch, cell_c: dict, cli: list) -> dict:
    """Phase 25: (a) cell C's QAT step counted by `launch.cost` on the card
    equals `dryrun.lower_cell` of the same cell on meta, exactly; (b) the
    model-FLOPs share of phase 6's s/step; (c) the dry run's per-rank bytes
    against phase 6's measured peak, held to MEM_BAR; (d) one decode step
    of cell A counted, beside the weight bytes it must read and the
    measured busy ms of a decode step; (e) the dry-run CLI's records."""
    from repro_torch.configs import shapes as shp
    from repro_torch.configs.registry import get_config
    from repro_torch.core.policy import get_preset
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import profile_decode
    from repro_torch.launch import roofline as rl
    out = {}
    # (a) the counter on the card against the meta dry run, cell C at one rank
    cell = dict(multi_pod=False, preset="w4a4", grad_accum=8, serve_kv_bits=8,
                mesh_sizes=(1, 1), shape=shp.ShapeSpec("cell_c", 512, 8, "train"))
    t0 = time.perf_counter()
    card = D.lower_cell("qwen1.5-0.5b", "train_4k", device="cuda", **cell)
    t_card = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    meta = D.lower_cell("qwen1.5-0.5b", "train_4k", device="meta", **cell)
    t_meta = time.perf_counter() - t0
    same = all(card["cost"][k] == meta["cost"][k] for k in ("flops", "bytes", "kernels"))
    log(f"  (a) cell C's step counted on the card ({t_card:.1f} s) and on meta "
        f"({t_meta:.1f} s): flops {card['cost']['flops']:.6e} / {meta['cost']['flops']:.6e}, "
        f"bytes {card['cost']['bytes']:.6e} / {meta['cost']['bytes']:.6e}, kernels "
        f"{ {k: v['calls'] for k, v in card['cost']['kernels'].items()} }, equal {same}")
    if not same:
        for row in _cost_diff(card["cost"], meta["cost"]):
            log(f"      {row}")
        fail("the counter's count of cell C on the card differs from the meta dry run")
    # (b) the model-FLOPs share of phase 6's step
    cfg = get_config("qwen1.5-0.5b")
    s_step = cell_c["s_step"]
    model_flops = rl.model_flops_per_step(cfg, 8 * 512, train=True)
    out.update(mfu=model_flops / (s_step * rl.PEAK_FLOPS), s_per_step=s_step,
               model_flops=model_flops, counted_flops=card["cost"]["flops"],
               counted_tflops_per_s=card["cost"]["flops"] / s_step / 1e12,
               useful_flops_ratio=card["roofline"]["useful_flops_ratio"],
               counted_bytes=card["cost"]["bytes"], roofline=card["roofline"])
    log(f"  (b) mfu {out['mfu']:.5f} (model FLOPs {model_flops:.4e} over phase 6's "
        f"{s_step:.4f} s/step x {rl.PEAK_FLOPS:.3e}); counted FLOPs "
        f"{out['counted_tflops_per_s']:.3f} TFLOP/s over the same time; useful FLOPs "
        f"ratio {out['useful_flops_ratio']:.4f}; roofline terms compute "
        f"{card['roofline']['compute_s'] * 1e3:.2f} ms, memory "
        f"{card['roofline']['memory_s'] * 1e3:.2f} ms ({card['roofline']['dominant']})")
    # (c) the dry run's per-rank bytes against phase 6's measured peak
    peak = cell_c["report"].peak_bytes
    ratio = meta["per_device_bytes"] / peak
    out.update(per_device_bytes=meta["per_device_bytes"], memory=meta["memory"],
               phase6_peak_bytes=peak, memory_ratio=ratio,
               counted_step_device_peak_bytes=card["memory"]["device_peak_bytes"],
               card_per_device_bytes=card["per_device_bytes"])
    log(f"  (c) dry-run per_device_bytes {meta['per_device_bytes'] / 2**30:.3f} GiB "
        f"(argument {meta['memory']['argument_size_in_bytes'] / 2**30:.3f}, temp "
        f"{meta['memory']['temp_size_in_bytes'] / 2**30:.3f}) against phase 6's peak "
        f"{peak / 2**30:.3f} GiB: ratio {ratio:.4f}, bar {MEM_BAR}; the counted step's "
        f"own peak on the card {card['memory']['device_peak_bytes'] / 2**30:.3f} GiB "
        f"(its counted per_device_bytes {card['per_device_bytes'] / 2**30:.3f} GiB)")
    if not MEM_BAR[0] <= ratio <= MEM_BAR[1]:
        fail(f"dry-run memory ratio {ratio:.4f} outside {MEM_BAR}")
    # (d) one decode step of cell A (granite-8b, w4a4, int8 KV, 4 slots x 160)
    torch.cuda.empty_cache()
    qa = get_preset("w4a4").replace(kv_cache_bits=8, a_bits=32)
    cell_a = dict(multi_pod=False, preset="w4a4", grad_accum=8, serve_kv_bits=8,
                  mesh_sizes=(1, 1), shape=shp.ShapeSpec("cell_a", 160, 4, "decode"),
                  qcfg=qa)
    dec = D.lower_cell("granite-8b", "decode_32k", device="cuda", **cell_a)
    torch.cuda.empty_cache()
    dec_meta = D.lower_cell("granite-8b", "decode_32k", device="meta", **cell_a)
    prof = profile_decode.main([])
    torch.cuda.empty_cache()
    weights = dec["memory"]["argument_parts"]["params"]
    out["decode"] = {
        "counted_bytes": dec["cost"]["bytes"], "meta_counted_bytes": dec_meta["cost"]["bytes"],
        "counted_flops": dec["cost"]["flops"], "weight_bytes": weights,
        "cache_bytes": dec["memory"]["argument_parts"]["cache"],
        "memory_term_ms": dec["roofline"]["memory_s"] * 1e3,
        "weight_bound_ms": weights / rl.HBM_BW * 1e3,
        "busy_ms": prof["device_busy_ms_per_step"],
        "busy_cache_rows": prof["cache_len"], "kernels": dec["cost"]["kernels"]}
    d = out["decode"]
    log(f"  (d) cell A's decode step counted: {d['counted_bytes']:.6e} bytes (meta "
        f"{d['meta_counted_bytes']:.6e}, equal {d['counted_bytes'] == d['meta_counted_bytes']}), "
        f"{d['counted_flops']:.4e} FLOPs, beside the weight bytes a step must read "
        f"{weights:.6e} ({d['counted_bytes'] / weights:.3f}x) and the cache's "
        f"{d['cache_bytes']:.4e}; roofline memory term {d['memory_term_ms']:.3f} ms "
        f"(weights alone {d['weight_bound_ms']:.3f} ms) against a measured busy "
        f"{d['busy_ms']:.3f} ms a step (profile_decode.py, cache rows {d['busy_cache_rows']})")
    if not all(v == v and v > 0 for v in (d["counted_bytes"], d["busy_ms"])):
        fail("cell A's decode count or busy time is not a positive number")
    # (e) the dry-run CLI's cells, started after the build
    out["cli"] = []
    for c in cli:
        rc = c["proc"].wait(timeout=900)
        recs = [json.loads(line) for line in c["out"].read_text().splitlines()] \
            if c["out"].exists() else []
        rec = recs[-1] if recs else {"status": "missing"}
        row = {"arch": c["arch"], "shape": c["shape"], "rc": rc,
               "status": rec.get("status"), "wall_s": rec.get("wall_s"),
               "trace_s": rec.get("trace_s"), "per_device_bytes": rec.get("per_device_bytes"),
               "fits_80g": rec.get("fits_80g"), "roofline": rec.get("roofline"),
               "collectives": rec.get("collectives")}
        out["cli"].append(row)
        roof = row["roofline"] or {}
        log(f"  (e) dryrun --arch {c['arch']} --shape {c['shape']} --mesh single: rc {rc}, "
            f"status {row['status']}, {row['wall_s']} s, per-rank "
            f"{(row['per_device_bytes'] or 0) / 2**30:.2f} GiB, {roof.get('dominant')}, "
            f"useful FLOPs ratio {roof.get('useful_flops_ratio')}")
        if rc != 0 or row["status"] != "ok":
            fail(f"dry-run CLI cell {c['arch']} x {c['shape']}: rc {rc}, status "
                 f"{row['status']} ({rec.get('error')})")
    return out


def cell_c_state_bytes(torch, cfg, qcfg) -> int:
    """Bytes of cell C's params and AdamW moments (shapes only)."""
    from repro_torch.models.model import init_params
    params = init_params(cfg, qcfg, torch.Generator(), "meta")
    return 3 * sum(t.numel() * t.element_size() for t in _leaves(params))


def sharded_cells_phase(torch, ops, M, serve, qmm, ref, cell_r: dict,
                        cell_c: dict, cell_k: dict) -> dict:
    """Phases 24, 26, 27 and 28: cell U's one process first (`cell_u_one`:
    the card is the ranks' after it), then one spawn of the four ranks
    that run cells S, T, U and V in turn (`cells_rank`), then each cell's
    checks here."""
    import shutil
    out_dir = ROOT / "build" / "chip_smoke_cells"
    shutil.rmtree(out_dir, ignore_errors=True)
    one = cell_u_one(torch, ops)
    t0 = time.perf_counter()
    ranks, start = _spawn_ranks(out_dir, timeout=1100)
    log(f"  the four ranks ran {time.perf_counter() - t0:.1f} s, their start included")
    walls = start["cells_s"]
    log("sharded, four ranks sharing the card (cell S):")
    cell_s = cell_s_phase(torch, M, serve, cell_r, cell_c, ranks["S"], out_dir / "S",
                          walls["S"])
    torch.cuda.empty_cache()
    log("tensor-parallel compute, four ranks sharing the card (cell T):")
    cell_t = cell_t_phase(torch, M, serve, qmm, ref, cell_r, cell_s, cell_c, ranks["T"],
                          out_dir / "T", walls["T"])
    cell_t["vocab_loss"] = vocab_loss_phase(ranks["VL"])
    torch.cuda.empty_cache()
    log("expert-parallel MoE, four ranks sharing the card (cell U):")
    cell_u = cell_u_phase(torch, ops, M, serve, qmm, ref, one, ranks["U"], out_dir / "U",
                          walls["U"])
    cell_t.pop("finish")()  # cell T's CPU logits, computed meanwhile
    torch.cuda.empty_cache()
    log("tensor-parallel recurrent blocks and cross-attention, four ranks sharing "
        "the card (cell V):")
    cell_v = cell_v_phase(torch, cell_k, ranks["V"], out_dir / "V", walls["V"])
    shutil.rmtree(out_dir, ignore_errors=True)
    cell_u["rank_start"] = start
    return {"S": cell_s, "T": cell_t, "U": cell_u, "V": cell_v}


def main() -> None:
    if len(sys.argv) > 1 and sys.argv[1] == "--cells-rank":
        cells_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        return
    t_start = time.perf_counter()

    marks = []

    def mark(label: str) -> None:
        marks.append((label, time.perf_counter() - t_start))
        log(f"[{marks[-1][1]:.1f} s into the run] {label}")

    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             "a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the unfused route's bf16 products: one f32 sum rounded once, as in
    # the reference (cuBLAS may otherwise reduce split-K partials in bf16)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    from repro_torch.kernels import build, decode_attention as da, ops, ref
    from repro_torch.kernels import quant_matmul as qmm
    dev_name = torch.cuda.get_device_name(0)
    log(f"device: {dev_name}, torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 1. build: one nvcc per source, all started together; the QAT kernels'
    #    source, the longest, finishes in the background of phases 2-4,
    #    which run the serving kernels only
    t0 = time.perf_counter()
    qat_build = background(build.build_all, [QAT_SOURCE])
    report = build.build_all([n for n in build.SOURCES if n != QAT_SOURCE])
    log(f"build: {time.perf_counter() - t0:.1f} s wall for "
        f"{', '.join(report)} (in parallel; {QAT_SOURCE} goes on in the background)")

    # 25(e)'s dry-run CLI cells: host work on the meta device, from here on
    dryrun_cli = start_dryrun_cli()

    mark("phase 2")
    # 2. kernels
    def phase_gen(phase: int):
        return torch.Generator(device="cuda").manual_seed(100 * SEED + phase)

    gen = phase_gen(2)
    timer = Timer(torch)
    log("kernels (each against its plain version on the card):")
    serving = serving_kernel_rows(torch, timer, qmm, da, ref, gen)
    rows = serving["rows"]
    log("kernels at musicgen-medium's serving shapes:")
    musicgen_kernel_rows(torch, timer, qmm, da, ref, gen, rows)
    log("kernels at recurrentgemma-9b's and xlstm-350m's serving shapes:")
    recurrent_kernel_rows(torch, timer, qmm, da, ref, gen, rows)
    # NaN and Inf through the quantizers, on a generator of their own (the
    # rows above keep their inputs)
    nan_gen = torch.Generator(device="cuda").manual_seed(100 * SEED + 26)
    log("serving kernels with a NaN column scale (against their plain versions):")
    nan_rows = {"serving": nan_serving_rows(torch, qmm, ref, nan_gen)}

    del timer  # its 2 GB buffer would count in the serving runs' peak memory
    torch.cuda.empty_cache()
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    mark("phase 3")
    # 3. the main path: full-width granite-8b, all 36 layers
    main_run = serve_phase(
        torch, ops, serve, M,
        ["--arch", "granite-8b", "--quant", "w4a4", "--kv-bits", "8",
         "--batch", "8", "--slots", "4", "--prompt-len", "128",
         "--new-tokens", "32", "--chunk", "32"],
        ("int4_matmul", "int_matmul", "pooled_decode_attention"), 2,
        cpu_reference=False)
    counts = main_run["counts"]
    # 4. second config: w8a8 weights, packed int4 KV, 4 layers
    serve_phase(
        torch, ops, serve, M,
        ["--arch", "granite-8b", "--quant", "w8a8", "--kv-bits", "4",
         "--layers", "4", "--batch", "8", "--slots", "4",
         "--prompt-len", "128", "--new-tokens", "32", "--chunk", "32"],
        ("int_matmul", "pooled_decode_attention"), 0, cpu_reference=True)

    report.update(qat_build.result())
    log(f"build: {QAT_SOURCE} {report[QAT_SOURCE]['seconds']:.1f} s, joined "
        f"{time.perf_counter() - t0:.1f} s after the build began")
    log_build(report)
    timer = Timer(torch)

    mark("phase 5")
    # 5. the QAT kernels at the training path's shapes (qwen1.5-0.5b,
    #    M = 8 x 512 tokens)
    log("qat kernels (each against its plain version on the card):")
    gen = phase_gen(5)
    m = 8 * 512
    qat_rows = {name: [] for name in QAT_KERNELS}
    # quant_matmul at qwen's FFN (w_in, then the down projection), a K-side
    # wo and the tied head; granite-moe's attention linears (w3a3: wk / wv,
    # and wq / wo K-side) and its head (8 bits); odd and misaligned shapes
    # (one with f32 x)
    for mm, k, n, k_side, qs, xdt in (
            (m, 1024, 2816, False, QAT_QS, None), (m, 1024, 1024, True, QAT_QS, None),
            (m, 1024, 152064, False, HEAD_QS, None), (m, 2816, 1024, False, QAT_QS, None),
            (m, 1024, 512, False, MOE_QS, None), (m, 1024, 1024, True, MOE_QS, None),
            (m, 1024, 49408, False, HEAD_QS, None),
            (1000, 700, 300, False, QAT_QS, torch.float32),
            (257, 129, 65, True, QAT_QS, None), (m, 1000, 2817, False, QAT_QS, None)):
        qat_rows["quant_matmul"].append(check_qat_fwd(
            torch, timer, qmm, ref, mm, k, n, k_side, gen, qs, xdt))
        torch.cuda.empty_cache()
    for k, n in ((1024, 2816), (2816, 1024)):
        qat_rows["quant_matmul_bwd"].append(check_qat_bwd(
            torch, timer, qmm, ref, "quant_matmul_bwd", m, k, n, False, True,
            gen, QAT_QS))
    qat_rows["quant_matmul_bwd"].append(check_qat_bwd(
        torch, timer, qmm, ref, "quant_matmul_bwd", m, 1024, 1024, True, True,
        gen, QAT_QS))
    # granite-moe's attention linears (w3a3: wk / wv, and wq / wo K-side),
    # odd and misaligned shapes on the combined route (one with f32 x), and
    # the f32-cotangent form (three planes, one dW range: as the split route)
    for mm, k, n, k_side, qs, xdt in (
            (m, 1024, 512, False, MOE_QS, None), (m, 1024, 1024, True, MOE_QS, None),
            (1000, 700, 300, False, QAT_QS, torch.float32),
            (257, 129, 65, True, QAT_QS, None), (m, 1000, 2817, False, QAT_QS, None)):
        qat_rows["quant_matmul_bwd"].append(check_qat_bwd(
            torch, timer, qmm, ref, "quant_matmul_bwd", mm, k, n, k_side, True,
            gen, qs, xdt))
    qat_rows["quant_matmul_bwd"].append(check_qat_bwd(
        torch, timer, qmm, ref, "quant_matmul_bwd", m, 1024, 2816, False, False,
        gen, QAT_QS))
    paths = [(r["path"], r["planes"]) for r in qat_rows["quant_matmul_bwd"]]
    if paths != [("tc", 1)] * 8 + [("tc", 3)]:
        fail(f"quant_matmul_bwd took paths {paths}")
    # the split dx / dw on the tensor cores: the tied head (f32 cotangents,
    # three planes), the FFN's shape with bf16 cotangents (one plane, held
    # to quant_matmul_bwd's bits) and an odd K-side shape with f32 ones
    for name in ("quant_matmul_dx", "quant_matmul_dw"):
        for mm, k, n, k_side, round_cot, qs in (
                (m, 1024, 152064, False, False, HEAD_QS), (m, 1024, 2816, False, True, QAT_QS),
                (257, 129, 65, True, False, QAT_QS)):
            qat_rows[name].append(check_qat_bwd(
                torch, timer, qmm, ref, name, mm, k, n, k_side, round_cot, gen, qs))
            torch.cuda.empty_cache()
        if [r["path"] for r in qat_rows[name]] != ["tc"] * 3:
            fail(f"{name} took paths {[r['path'] for r in qat_rows[name]]}")
    edges = split_edges(torch, timer, qmm, ref, gen)
    torch.cuda.empty_cache()
    # the learned-position models' training shapes, after the rows above
    # (which keep their inputs): the forward at musicgen-medium's w_in and
    # head and at paper-bert-base's and paper-deit-t's heads; the f32
    # combined backward's training path, musicgen-medium's head (one dW
    # range: as the split route) and paper-deit-t's (the dW contraction in
    # 13 ranges);
    # the split dx / dw at musicgen-medium's w_in, one plane (the split
    # route of a dense FFN), and at paper-bert-base's head, three planes
    log("qat kernels at musicgen-medium's, paper-bert-base's and paper-deit-t's shapes:")
    for mm, k, n, qs in ((m, 1536, 6144, QAT_QS), (m, 1536, 2048, HEAD_QS),
                         (32 * 128, 768, 30720, HEAD_QS), (64 * 197, 192, 1024, HEAD_QS)):
        qat_rows["quant_matmul"].append(check_qat_fwd(
            torch, timer, qmm, ref, mm, k, n, False, gen, qs))
        torch.cuda.empty_cache()
    for mm, k, n in ((m, 1536, 2048), (64 * 197, 192, 1024)):
        qat_rows["quant_matmul_bwd"].append(check_qat_bwd(
            torch, timer, qmm, ref, "quant_matmul_bwd", mm, k, n, False, False,
            gen, HEAD_QS))
        torch.cuda.empty_cache()
    heads = [(r["path"], r["planes"], r["dw_splits"] > 1)
             for r in qat_rows["quant_matmul_bwd"][-2:]]
    if heads != [("tc", 3, False), ("tc", 3, True)]:
        fail(f"the f32 heads' quant_matmul_bwd took {heads}: want three planes, "
             "musicgen-medium's in one dW range, paper-deit-t's split")
    for name in ("quant_matmul_dx", "quant_matmul_dw"):
        for mm, k, n, round_cot, qs in ((m, 1536, 6144, True, QAT_QS),
                                        (32 * 128, 768, 30720, False, HEAD_QS)):
            if qmm.bwd_route(mm, k, n) != "split":
                fail(f"({mm}, {k}, {n}) would not take the split route in training")
            qat_rows[name].append(check_qat_bwd(
                torch, timer, qmm, ref, name, mm, k, n, False, round_cot, gen, qs))
            torch.cuda.empty_cache()

    # the batched (MoE expert) kernels at granite-moe's training shapes: 32
    # experts x 1280 capacity rows (8 x 512 tokens, top 8, factor 1.25),
    # w3a3; and one shape past the combined route's budget (split route)
    log("moe kernels (each against its plain version on the card):")
    for name in ("quant_matmul_batched", "quant_matmul_bwd_batched"):
        qat_rows[name] = []
    for k, n in ((1024, 512), (512, 1024)):
        qat_rows["quant_matmul_batched"].append(check_batched_fwd(
            torch, timer, qmm, ref, 32, 1280, k, n, gen, MOE_QS))
        qat_rows["quant_matmul_bwd_batched"].append(check_batched_bwd(
            torch, timer, qmm, ref, 32, 1280, k, n, gen, MOE_QS))
        torch.cuda.empty_cache()
    qat_rows["quant_matmul_batched"].append(check_batched_fwd(
        torch, timer, qmm, ref, 3, 257, 129, 65, gen, MOE_QS, torch.float32))
    # the batched backward at an odd shape with f32 x, with f32 cotangents
    # (three planes, the 2D backward's dW ranges), and past the reference's
    # scratch budget (split)
    qat_rows["quant_matmul_bwd_batched"].append(check_batched_bwd(
        torch, timer, qmm, ref, 3, 257, 129, 65, gen, MOE_QS, torch.float32))
    qat_rows["quant_matmul_bwd_batched"].append(check_batched_bwd(
        torch, timer, qmm, ref, 32, 1280, 1024, 512, gen, MOE_QS, round_cot=False))
    torch.cuda.empty_cache()
    qat_rows["quant_matmul_bwd_batched"].append(check_batched_bwd(
        torch, timer, qmm, ref, 4, 256, 512, 8192, gen, MOE_QS))
    paths = [(r["path"], r["planes"]) for r in qat_rows["quant_matmul_bwd_batched"]]
    if paths != [("tc", 1)] * 3 + [("tc", 3), ("split", 1)]:
        fail(f"quant_matmul_bwd_batched took paths {paths}")
    torch.cuda.empty_cache()
    # the f32 combined backward's edges, after every row above (which keep
    # their inputs): odd, misaligned shapes whose dW contraction is cut in
    # ranges with a ragged last one (f32 x; K-side scales)
    log("qat kernels: the f32 combined backward's split dW at odd shapes:")
    for mm, k, n, k_side, xdt in ((1000, 700, 300, False, torch.float32),
                                  (257, 129, 65, True, None)):
        qat_rows["quant_matmul_bwd"].append(check_qat_bwd(
            torch, timer, qmm, ref, "quant_matmul_bwd", mm, k, n, k_side, False, gen,
            QAT_QS, xdt))
        if qat_rows["quant_matmul_bwd"][-1]["dw_splits"] < 2:
            fail(f"({mm}, {k}, {n}) f32 kept one dW range")
    torch.cuda.empty_cache()
    # the recurrent families' training shapes, after the rows above: the
    # forward and the combined backward at xlstm-350m's mq / mk / mv (w4a4)
    # and at its m_i / m_f gates (8 bits, N = 4 heads)
    log("qat kernels at xlstm-350m's shapes:")
    for k, n, qs in ((2048, 2048, QAT_QS), (2048, 4, HEAD_QS)):
        qat_rows["quant_matmul"].append(check_qat_fwd(
            torch, timer, qmm, ref, m, k, n, False, gen, qs))
        qat_rows["quant_matmul_bwd"].append(check_qat_bwd(
            torch, timer, qmm, ref, "quant_matmul_bwd", m, k, n, False, True, gen, qs))
        torch.cuda.empty_cache()
    log("qat kernels with NaN / ±Inf inputs (against their plain versions):")
    nan_rows["qat"] = nan_qat_rows(torch, qmm, ref, nan_gen)
    torch.cuda.empty_cache()

    mark("phase 10")
    # 10. the quantizer kernels (10-12) against their plain versions
    q_rows, rows_launches = quantizer_kernel_checks(torch, timer, ops, ref, phase_gen(10))
    log("quantizer kernels with NaN / ±Inf inputs (against their plain versions):")
    nan_rows["quantizer"] = nan_quantizer_rows(torch, ref, nan_gen)
    del timer  # its 2 GB buffer would count in the serving runs' peak memory
    torch.cuda.empty_cache()

    mark("phase 12")
    # 12. MoE serving: full-width granite-moe-1b-a400m, all 24 layers
    moe_serve = serve_phase(
        torch, ops, serve, M,
        ["--arch", "granite-moe-1b-a400m", "--quant", "w3a3", "--kv-bits", "8",
         "--batch", "8", "--slots", "4", "--prompt-len", "128",
         "--new-tokens", "32", "--chunk", "32"],
        ("int4_matmul", "pooled_decode_attention"), True, cpu_reference=False,
        extra=moe_serve_checks(torch, M))
    torch.cuda.empty_cache()

    mark("phase 13")
    # 13. learned positions and layernorm on the serving path: full-width
    #     musicgen-medium, all 48 layers
    music_serve = serve_phase(
        torch, ops, serve, M,
        ["--arch", "musicgen-medium", "--quant", "w4a4", "--kv-bits", "8",
         "--batch", "8", "--slots", "4", "--prompt-len", "128",
         "--new-tokens", "32", "--chunk", "32"],
        ("int4_matmul", "int_matmul", "pooled_decode_attention"), True,
        cpu_reference=False, extra=dense_serve_checks(torch, M))
    torch.cuda.empty_cache()

    mark("phase 6")
    # 6. QAT training, the main path of the training slice: full-width
    #    qwen1.5-0.5b, 3 steps saving at step 2, then a restored 4th step
    from repro_torch.launch import train
    import shutil
    ckpt_dir = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    targv = ["--arch", "qwen1.5-0.5b", "--quant", "w4a4", "--kd", "mckd",
             "--batch", "8", "--seq", "512", "--save-every", "2",
             "--ckpt", str(ckpt_dir)]
    first = train_phase(torch, ops, train, targv + ["--steps", "3"], 0, 3)
    resumed = train_phase(torch, ops, train, targv + ["--steps", "4"], 3, 1)
    from repro_torch.configs.registry import get_config
    from repro_torch.core.policy import get_preset
    for run, n_steps in ((first, 3), (resumed, 1)):
        run.update(cfg=get_config("qwen1.5-0.5b"), qcfg=get_preset("w4a4"))
        per_step = check_launches(run, n_steps, 8 * 512)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    # 7. the kernel route against the unfused composition, on the card
    route = route_check(torch)
    torch.cuda.empty_cache()
    mark("phase 8")
    # 8. MoE QAT training with OBR and oscillation tracking, full width
    moe_run = moe_train_phase(torch, ops)
    moe_step = check_launches(moe_run, 3, 8 * 512, every_kernel=True)
    torch.cuda.empty_cache()
    obr_bits = obr_grad_bits(torch)
    log(f"  OBR's value and gradient as the train step takes them (`obr_grad`) "
        f"bit-equal to autograd through obr_loss at granite-moe's leaves: {obr_bits}")
    if not all(obr_bits.values()):
        fail(f"obr_grad departs from autograd through obr_loss: {obr_bits}")
    torch.cuda.empty_cache()
    # 9. the MoE kernel route against the unfused composition, at init
    moe_route = route_check(torch, "granite-moe-1b-a400m", "w3a3")
    torch.cuda.empty_cache()
    mark("phase 14")
    # 14. training the learned-position models at full width: musicgen-medium
    #     through the CLI, the paper's BERT-base (w2a2, OBR, oscillation
    #     tracked) and DeiT-T (w3a3, 197 patches) through run_training; then
    #     the MCKD store on the card
    music_dir = ROOT / "build" / "chip_smoke_musicgen_ckpt"
    shutil.rmtree(music_dir, ignore_errors=True)
    music_train = train_phase(
        torch, ops, train, ["--arch", "musicgen-medium", "--quant", "w4a4",
                            "--kd", "mckd", "--batch", "8", "--seq", "512",
                            "--steps", "3", "--save-every", str(10 ** 6),
                            "--ckpt", str(music_dir)], 0, 3)
    shutil.rmtree(music_dir, ignore_errors=True)
    music_train.update(cfg=get_config("musicgen-medium"), qcfg=get_preset("w4a4"))
    music_step = check_launches(music_train, 3, 8 * 512)
    torch.cuda.empty_cache()
    paper_runs = {}
    for arch, qcfg, batch, seq in (
            ("paper-bert-base", get_preset("w2a2").replace(track_oscillation=True), 32, 128),
            ("paper-deit-t", get_preset("w3a3"), 64, 197)):
        run = training_run(torch, ops, get_config(arch), qcfg, batch=batch, seq=seq,
                           steps=3, tag=arch, strict_health=True)
        run["per_step"] = check_launches(run, 3, batch * seq)
        paper_runs[arch] = run
        torch.cuda.empty_cache()
    store = mckd_store_phase(torch)
    torch.cuda.empty_cache()
    mark("phase 15")
    # 15. the paper-table twins, steps cut
    tables = tables_phase(torch)
    torch.cuda.empty_cache()
    mark("phase 16-20")
    # 16-20. the recurrent families and cross-attention (cells K-O)
    recurrent = recurrent_phases(torch, ops, train)
    torch.cuda.empty_cache()
    mark("phase 21")
    # 21. the training half of the fault contract: NaN rollback and SIGTERM
    #     on full-width paper-bert-base
    faults = fault_contract_phase(torch, ops)
    torch.cuda.empty_cache()
    mark("phase 22")
    # 22. gradient compression on cell C's configuration, beside phase 6
    cdir = ROOT / "build" / "chip_smoke_compress_ckpt"
    shutil.rmtree(cdir, ignore_errors=True)
    compressed = compression_phase(
        torch, ops, train, first,
        ["--arch", "qwen1.5-0.5b", "--quant", "w4a4", "--kd", "mckd", "--batch", "8",
         "--seq", "512", "--save-every", str(10 ** 6), "--ckpt", str(cdir),
         "--steps", "3"])
    shutil.rmtree(cdir, ignore_errors=True)
    torch.cuda.empty_cache()
    mark("phase 23")
    # 23. sharding on one NCCL rank (cell R)
    log("sharded, one rank (cell R):")
    first["state_bytes"] = cell_c_state_bytes(torch, get_config("qwen1.5-0.5b"),
                                              get_preset("w4a4"))
    cell_r = cell_r_phase(torch, ops, train, serve, first, main_run)
    torch.cuda.empty_cache()
    mark("phase 11")
    # 11. the kernel benchmark, the entry point of kernels 10 and 12
    bench_counts, bench = kernel_bench_phase(torch, ops)
    torch.cuda.empty_cache()
    mark("phase 25")
    # 25. the dry run and the H100 roofline: cell C's counted step on the
    #     card against the meta dry run, its model-FLOPs share and memory,
    #     cell A's decode count, the dry-run CLI
    log("dry run and roofline (cells C and A):")
    dry = dryrun_phase(torch, first, dryrun_cli)
    torch.cuda.empty_cache()
    mark("phases 24, 26, 27, 28")
    # 24, 26, 27, 28. four ranks sharing the card over gloo, one spawn: cell
    #     C's QAT and cell A's serving on the gathered runtime (S), both
    #     tensor-parallel (T), cell D's QAT and cell F's serving with the
    #     experts split (U), cell K's QAT with its recurrent blocks split
    #     and one full-width RG-LRU block and cross sublayer (V); then T's
    #     and U's kernels at the slices' shapes
    cells = sharded_cells_phase(torch, ops, M, serve, qmm, ref, cell_r, first,
                                recurrent["K"])
    cell_s, cell_t, cell_u = cells["S"], cells["T"], cells["U"]
    for name, rs in cell_t["slices"]["qat"].items():
        qat_rows[name].extend(rs)
    for name, rs in cell_u["slices"].items():
        qat_rows[name].extend(rs)
    mark("done")
    counts.update(first["counts"])
    for name in ("quant_matmul_batched", "quant_matmul_bwd_batched"):
        counts[name] = moe_run["counts"][name]
    for name in ("fake_quant_2d", "bin_stats_2d"):
        counts[name] = bench_counts[name]
    counts["fake_quant_rows"] = rows_launches
    rows.update(qat_rows)
    rows.update(q_rows)

    sources = {"int4_matmul": ("src/repro_torch/kernels/csrc/quant_matmul.cu",
                               "src/repro/kernels/quant_matmul.py:863"),
               "int_matmul": ("src/repro_torch/kernels/csrc/quant_matmul.cu",
                              "src/repro/kernels/quant_matmul.py:819"),
               "pooled_decode_attention": (
                   "src/repro_torch/kernels/csrc/decode_attention.cu",
                   "src/repro/kernels/decode_attention.py:137"),
               "quant_matmul": ("src/repro_torch/kernels/csrc/qat_matmul.cu",
                                "src/repro/kernels/quant_matmul.py:81"),
               "quant_matmul_dx": ("src/repro_torch/kernels/csrc/qat_matmul.cu",
                                   "src/repro/kernels/quant_matmul.py:241"),
               "quant_matmul_dw": ("src/repro_torch/kernels/csrc/qat_matmul.cu",
                                   "src/repro/kernels/quant_matmul.py:361"),
               "quant_matmul_bwd": ("src/repro_torch/kernels/csrc/qat_matmul.cu",
                                    "src/repro/kernels/quant_matmul.py:574"),
               "quant_matmul_batched": ("src/repro_torch/kernels/csrc/qat_matmul.cu",
                                        "src/repro/kernels/quant_matmul.py:141"),
               "quant_matmul_bwd_batched": ("src/repro_torch/kernels/csrc/qat_matmul.cu",
                                            "src/repro/kernels/quant_matmul.py:743"),
               "fake_quant_2d": ("src/repro_torch/kernels/csrc/fake_quant.cu",
                                 "src/repro/kernels/fake_quant.py:48"),
               "fake_quant_rows": ("src/repro_torch/kernels/csrc/fake_quant.cu",
                                   "src/repro/kernels/fake_quant.py:73"),
               "bin_stats_2d": ("src/repro_torch/kernels/csrc/bin_stats.cu",
                                "src/repro/kernels/bin_stats.py:48")}
    kernels = []
    for name, rs in rows.items():
        r = rs[0]  # the decode shape of the main path
        kernels.append({"name": name, "route": "cuda", "source": sources[name][0],
                        "replaces": sources[name][1], "launches": counts[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        "shape": r["shape"], "tol": r["tol"],
                        "checks": len(rs)})
        if name in ("int4_matmul", "pooled_decode_attention"):
            kernels[-1]["launches_moe_serve"] = moe_serve["counts"][name]
        if name in ("int4_matmul", "int_matmul", "pooled_decode_attention"):
            kernels[-1]["launches_musicgen_serve"] = music_serve["counts"][name]
        if name in QAT_KERNELS:
            kernels[-1]["launches_train"] = {
                "musicgen-medium": music_train["counts"][name],
                **{a: r["counts"][name] for a, r in paper_runs.items()},
                **{cell: recurrent[cell]["counts"][name] for cell in "KNO"}}
        if name in ("int4_matmul", "int_matmul", "pooled_decode_attention"):
            kernels[-1]["launches_recurrent_serve"] = {
                cell: recurrent[cell]["launches"][name] for cell in "LM"}
        if name == "pooled_decode_attention":
            kernels[-1]["launches_sharded_serve_per_rank"] = cell_s["serve"]["decode_launches"]
        if name in ("int4_matmul", "int_matmul", "pooled_decode_attention"):
            kernels[-1]["launches_tp_serve_per_rank"] = [
                x[name] for x in cell_t["serve"]["launches"]]
        if name in ("quant_matmul", "quant_matmul_bwd"):
            kernels[-1]["launches_tp_train_per_rank_step"] = cell_t["train"][
                "launches_per_step"][name]
        if name in QAT_KERNELS:
            kernels[-1]["launches_ep_train_per_rank_step"] = cell_u["train"][
                "launches_per_step"][name]
            kernels[-1]["launches_recurrent_tp_train_per_rank_step"] = cells["V"][
                "train"]["launches_per_step"][name]
        if name in ("int4_matmul", "pooled_decode_attention"):
            kernels[-1]["launches_ep_serve_per_rank"] = [
                x[name] for x in cell_u["serve"]["launches"]]
        if name in ("int4_matmul", "int_matmul", "pooled_decode_attention"):
            kernels[-1].update(plan=r["plan"], independence=serving["independence"][name],
                               rows=[{k: v for k, v in row.items() if k in (
                                   "shape", "ms", "plain_ms", "library_ms", "bound_ms")}
                                   for row in rs])
        if any("device_kernels" in row for row in rs):
            kernels[-1]["device_kernels"] = sorted(
                {d for row in rs for d in row.get("device_kernels", [])})
        if name == "fake_quant_rows":
            kernels[-1]["launches_from"] = ("the kernel checks: no entry point "
                                            "of the repo reaches fake_quant_rows")
        if name == "bin_stats_2d":
            kernels[-1]["library"] = r["library"]
        if name in ("quant_matmul", "quant_matmul_batched", "quant_matmul_bwd",
                    "quant_matmul_bwd_batched", "quant_matmul_dx", "quant_matmul_dw"):
            kernels[-1]["path"] = r["path"]
            kernels[-1]["prologue_ms"] = r["prologue_ms"]
        if name in ("quant_matmul_bwd", "quant_matmul_bwd_batched"):
            kernels[-1]["f32_rows"] = [{k: v for k, v in row.items() if k in (
                "shape", "planes", "dw_splits", "ms", "prologue_ms", "plain_ms", "library_ms",
                "bound_ms", "bound_f32_ms", "split_route_ms", "dws_vs_plain", "summands")}
                for row in rs if not row["round_cot"]]
        if name in ("quant_matmul_dx", "quant_matmul_dw"):
            kernels[-1].update(
                kernel=f"qat_{name[-2:]}_tc_kernel", planes=r["planes"],
                bound_f32_ms=r["bound_f32_ms"], grid_tflops=r["grid_tflops"],
                split=r["split"], rows=[{k: v for k, v in row.items() if k in (
                    "shape", "planes", "ms", "prologue_ms", "plain_ms", "library_ms",
                    "bound_ms", "bound_f32_ms", "grid_tflops")} for row in rs])
        if name == "quant_matmul_dx":
            kernels[-1]["split_edges"] = edges
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log("seconds by phase (from phase 2 on; the build's above): " + ", ".join(
        f"{a} {t1 - t0:.1f}" for (a, t0), (_, t1) in zip(marks, marks[1:])))
    log(f"chip_smoke: total wall {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"train": {
        "s_per_step": first["s_step"], "tokens_per_s": first["tokens_s"],
        "peak_gib": (first["report"].peak_bytes or 0) / 2**30,
        "losses": first["report"].losses + resumed["report"].losses,
        "launches_per_step": per_step, "route": route},
        "moe_train": {
        "s_per_step": moe_run["s_step"], "tokens_per_s": moe_run["tokens_s"],
        "step_seconds": moe_run["report"].step_seconds,
        "peak_gib": (moe_run["report"].peak_bytes or 0) / 2**30,
        "losses": moe_run["report"].losses, "metrics": moe_run["report"].metrics,
        "launches_per_step": moe_step, "route": moe_route},
        "moe_serve": {
        "throughput": moe_serve["summary"]["throughput"],
        "peak_gib": (moe_serve["peak"] or 0) / 2**30, "launches": moe_serve["counts"],
        "wall_s": moe_serve["wall"], **moe_serve["extra"]},
        "musicgen_serve": {
        "throughput": music_serve["summary"]["throughput"],
        "peak_gib": (music_serve["peak"] or 0) / 2**30,
        "launches": music_serve["counts"], "wall_s": music_serve["wall"],
        **music_serve["extra"]},
        "learned_pos_train": {
        arch: {"s_per_step": r["s_step"], "tokens_per_s": r["tokens_s"],
               "step_seconds": r["report"].step_seconds,
               "peak_gib": (r["report"].peak_bytes or 0) / 2**30,
               "losses": r["report"].losses, "healths": r["report"].healths,
               "metrics": r["report"].metrics, "launches_per_step": per}
        for arch, r, per in (("musicgen-medium", music_train, music_step),
                             *((a, r, r["per_step"]) for a, r in paper_runs.items()))},
        "mckd_store": store,
        "nan_rows": nan_rows, "fault_contract": faults, "compression": compressed,
        "sharded": {"R": cell_r, "S": cell_s, "T": cell_t, "U": cell_u}, "dryrun": dry,
        "recurrent": {cell: {k: v for k, v in r.items() if k != "counts"}
                      for cell, r in recurrent.items()},
        "tables": {k: {"steps": v["steps"], "wall_s": v["wall_s"], "rows": v["rows"]}
                   for k, v in tables.items()},
        "kernel_bench": {
        "launches": bench_counts, "equivalence": bench["equivalence"],
        "decode_parity": bench["decode_parity"],
        "standalone": bench["standalone"]}}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev_name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
