#!/usr/bin/env python3
"""GPU smoke of chainermn_tpu_torch: build, kernel checks, serving (with the prefix cache, the spill tier, the router, the disaggregated prefill / decode fleet, the cross-process fleet, its autoscaler and its worker groups at TP = 2), beam search, LM training (also at TP = 2 and SP = 2), MoE and pipelines, ZeRO-1, FSDP and the int8 gradient wire, ImageNet training, the communicator, the Trainer, its metrics stream and comm ledger, seq2seq, model parallelism, training robustness, and the analysis package's trace engine and lock-order recorder on one card.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each named on its own output line; any failure exits non-zero
and prints no result line:

1. ``device``  — the card (nvidia-smi name and power limit), torch and
   CUDA versions; ``build`` — every kernel compiled from ``csrc/`` in
   parallel (one nvcc per source), with each kernel's ptxas report, and
   the count of ``HGMMA`` instructions (``cuobjdump``) in the SASS of each
   bf16 ``wgmma`` kernel (``WGMMA_KERNELS``: ``ce_stats``, the three CE
   gradient GEMMs, the flash forward, the flash backward's dk/dv and dq
   kernels, ``conv_wgrad`` and ``conv_dgrad``), none of which may be 0;
   the flash backward's two bf16 kernels and the beam kernel's bf16 split
   kernels and the decode kernel's bf16 split kernels
   (``NO_SPILL_KERNELS``) may not spill.
2. ``kernels`` — each kernel against its plain PyTorch version on the
   card, at the main paths' shapes and edge shapes, in bf16 (atol = rtol =
   2e-2: bf16 keeps 8 mantissa bits) and fp32 (atol = rtol = 1e-4: the
   kernel sums in another order); the bf16 main-path shapes are also
   timed (CUDA events, L2 flushed before each launch) beside the plain
   version, one PyTorch library call, and the bound (bytes / 3.35 TB/s or
   FLOPs / peak, whichever is larger).  Decode attention (``check_decode``):
   ``decode_attend`` and the tick's fused ``decode_append_attend`` (the
   caches after each fused call equal to ``cache_append_plain``'s,
   exactly) at tiny caches, few slots (33 and 64 splits a row), widths
   past one head group (D 2560 to 8192), per-row pos at the edges, on the
   bf16 split plan's tile and split edges, scalar, the full cache and the
   serving lengths, two fused calls in a row, q / k / v as QKV head views; both
   timed at the serving lengths and the full cache beside SDPA (and
   ``index_put_`` of the new rows for the fused call).  The flash forward: the training
   shape (B 8, S 1024, H 8, hd 128, causal) and the prefill (B 8, S 512,
   H 16, hd 64) timed beside SDPA, then serving's B 1 prefill (the 64-row
   blocks), ragged S, GQA, S 1, a q whose base is not 16-byte aligned, and
   ViT-B/16's attention (B 128, S 197, H 12, hd 64, non-causal) and
   ViT-S/16's at one FSDP rank's rows (B 32, H 6), timed.
   The training kernels: the flash
   backward (B 8, S 1024, H 8, hd 128, causal; hd 64, group 2, a ragged S
   of 77, the LSE cotangent, bases not 16-byte aligned; ViT-B/16's
   non-causal B 128, S 197, H 12, hd 64 and ViT-S/16's B 32, H 6, timed
   beside SDPA's backward)
   and the fused
   cross-entropy (T 8192, V 32768,
   D 1024; ragged T and V; targets out of range; for the bf16 gradients,
   which walk V in chunks of at most 32 MiB of ``ds``, V = 2 chunks of
   2048 + 77 at T 8000, D 200 and V = 2 chunks of 1920 + 77 at T 8738,
   D 64; with targets at each chunk's first column, the column before it,
   the bf16 ``ce_stats``' 256-wide V tile edges and V - 1): ``ce_stats``,
   ``ce_dh``
   and ``ce_dtable`` alone and both gradients from one ``ce_grads`` call.
   The CE gradients are small numbers, so their largest error must also
   stay within the tolerance times their largest entry.  ``ce_grads`` is
   timed beside the sum of the two library calls, with its peak memory
   above its inputs; bf16 at D = 100, 4, 1026 and 33 (padded to a
   multiple of 8 in a copy) and with a misaligned h must give the plain
   version's statistics and gradients.  The beam kernel
   (``beam_attend_parts``: acc, m and l): beam 4's two segments at full
   width (the (8, 512, 1024) prompt, mode none; the (8, 2048, 1024)
   generated window as a strided view, mode amask, one valid slot per
   (b, beam, t)), the GQA tick (B 8, 4 KV heads of 64, g 4, S 1024, pos
   scalar, per-row and at the edges), hd 128, S 1, a ragged S of 77,
   8 or 16 rows per cache row and the edges of the S splits (S one past a
   split multiple, pos on a split boundary, a split with no valid amask
   position); the three timed shapes beside
   ``scaled_dot_product_attention`` (the rows as the query length, a
   boolean mask; ``enable_gqa`` for GQA).  The conv backward kernels
   (``conv3x3_wgrad``, ``conv3x3_dgrad``): ResNet-50's three eligible 3x3
   shapes at batch 128 (56² x 64, 28² x 128, 14² x 256), a ragged 7 x 5
   plane, a 196-row plane, n = 1 and channel counts that are not
   multiples of 8, and the ten distinct 1x1 shapes of an NF-ResNet-50 step
   at batch 128 (``NF_1X1``: 64 → 64, 64 → 256, 256 → 64 and 256 → 128 at
   56², 128 → 512, 512 → 128 and 512 → 256 at 28², 256 → 1024, 1024 →
   256 and 1024 → 512 at 14²), the bf16 error also within tol x max
   |ref|; the three 3x3 and ten 1x1 shapes timed beside cuDNN's
   ``convolution_backward`` asked for dW alone or dX alone; then the bf16
   ``conv3x3_dgrad`` of a dY whose base is not 16-byte aligned.  The
   flash kernels also at the sequence-parallel shapes (the ring's blocks
   at SP = 2, (2, 4096, 8, 128), causal and whole, the backward with the
   LSE cotangent and with GQA; Ulysses' (2, 8192, 4, 128), causal), and
   ``bench.py :: bench_long_context``'s rows (``check_flash_long``: 1c /
   2c at B 2, S 8,192 and 1d / 2d at B 1, S 16,384, 8 heads of 128,
   causal, bf16): forward and backward against the plain versions run a
   head at a time, timed beside the whole plain version where it fits
   on the card and SDPA's forward and backward.
3. ``parity``  — fp32, full width (d 1024, 8 layers, 16 heads, vocab
   32768), and a small RoPE model (d 256, 4 heads, 2 layers): 4 staggered
   requests through the port's ServingEngine on the card and on the CPU
   with the same weights; tokens must be equal, or
   differ only where the CPU's logits of the two tokens are within 1e-3
   (a near-tie, after which that request's comparison stops).  The same
   for the full-width GQA model (4 KV heads) with requests 1 and 3
   sampled at temperature 0.7 (for a sampled row the near-tie is in the
   CPU's ``logits / T + gumbel``), and beam 4, lazy and physical, at
   prompt 128 and 16 new tokens (the best beams equal, or their CPU
   log-probabilities within 1e-3).  TF32 is off for the whole run
   (matmul and cuDNN).  Then the chunked fill (``_decoder_core``'s
   ``attn_block`` at ``s_q`` 64 and a nonzero write position: one scalar
   start, and four per-row starts) on one full-width fp32 block, MHA and
   GQA: the card's output and the chunk's K / V rows against the CPU's
   within the fp32 tolerance (also against the largest |ref|), every other
   cache row untouched, the append kernel launched once a call.
4. ``serving`` — bf16, full width: 16 staggered requests (prompt 512, 64
   new tokens) through an 8-slot, max_total 1024 ServingEngine; every
   request must finish ``done``.  The launch counts, zeroed just before
   this run and read just after, must be exactly one decode-attention
   launch a layer a tick (its K/V append folded in) and one append and one
   flash forward a layer a prefill (the prefix cache is on, as in JAX's
   engine, but the random prompts share no two-token prefix: no hit, no
   restore, which the run checks).  Then ``lm_generate`` at B 8, prompt
   512, 64 new tokens: 8 x 63 decode launches, 8 appends, 8 flash
   forwards.
5. ``beam`` — bf16, ``bench.py :: bench_decode``'s full width: beam 4,
   lazy reorder, B 8, prompt 512, 512 new tokens (tokens/s, ms per token,
   peak memory), beside the prefill alone and the greedy ``lm_generate``
   of the same size.  Launch counts zeroed just before the beam run and
   read just after must be 2 x 8 x 511 beam-kernel launches, 8 x 511 + 8
   appends and 8 flash forwards.
6. ``serving-gqa`` — bf16, the GQA model (4 KV heads): the serving run
   of phase 4 with the odd half of the requests sampled at temperature
   0.7; every request ``done``, the beam kernel launched 8 times on every
   tick and the decode kernel never.
6b. ``serving-prefix`` — the prefix cache, the host spill tier and the
   router at the decode-bench width (bf16, 8 slots, max_total 1024).
   (a) 16 requests of one 448-token system prompt plus a distinct
   64-token tail, 64 new tokens each, the first alone, then waves of 7,
   7 and 1 (each run to idle): with the cache off (16 prefills), then on
   (launch counts zeroed just before, read just after): every request
   ``done``, 1 prefill and 15 prefix copies (``serving/prefix/hits``
   15), exactly 8 flash forward and 8 append launches (the one miss's
   prefill) and 8 decode launches a tick; TTFT p50/p99 of the hits and
   the misses, the ``prefix_copy`` ms (synchronised), tick p50/p99 and
   tokens/s of both runs.  (b) 2 slots and a spill budget of two slabs:
   prompts A, B, C (512 tokens, 16 new) and D sharing A's first 480
   tokens; C's admission spills A's donation, D restores it (the slot's
   rows after the restore byte-equal to the payload's), then the same
   with one bit of A's payload flipped: refused, ``crc_refusals`` 1, D
   prefills; pack and restore ms and the bytes.  (c) ``build_fleet(params,
   2)``, two engines on the card: two prefix families alternate (each
   run to idle) onto replica0 / replica1, 2 prefix hits on each, 4
   affinity dispatches; a burst with no step fills both queues and the
   next submit is refused ``queue_full`` with ``retry_after_ms`` and
   ``queue_depth`` 4.  (d) fp32 at 2 layers (full width otherwise): the
   shared-prefix (8 requests) and spill schedules with the cache on and
   off, on the card and on the CPU: tokens equal or a CPU near-tie
   under 1e-3, the hits and restores equal.
6c. ``serving-disagg`` — disaggregated prefill / decode serving at the
   decode-bench width (bf16, prompt 512, 64 new, cache 1024): a 1:1
   ``build_disagg_fleet`` (2 staging slots, 8 decode slots) takes 16
   requests submitted at once over the ``local`` transport (a row copy
   between the pools) and then the ``lanes`` one (pack, object lane,
   unpack), each once under ``run()`` (launch counts zeroed just before,
   read just after) and once under ``start()`` / ``stop()`` (one driver
   thread per role: tokens/s, TTFT p50 / p99, the decode tick gap p50 /
   p99, transfer ms p50 / p99, the prefill worker's goodput buckets),
   beside the fused ``ServingEngine`` (cache and spill off) run both ways
   on the same 16 requests.  Held: 16 transfers a run, no prefill on the
   decode worker and no tick on the prefill worker, 8 flash forward and 8
   append launches a prefill and 8 decode launches a tick, lanes
   ``bytes_moved`` 16 x ``slab_nbytes(8, 512, 1024, bf16)`` =
   268,435,456, every allocator drained, and every request's tokens the
   fused engine's (or first different at a near-tie < 1e-3 of the card's
   logits).  Then the GQA model (4 KV heads) over the lanes, 8 requests of
   16 new tokens (8 beam launches and 8 appends a tick, on rows the plane
   landed; tokens against the fused GQA engine), and fp32 at 2 layers
   (full width otherwise; 8 requests, prompt 256, 16 new) on both
   transports, card against CPU: tokens equal or a CPU near-tie < 1e-3.
6d. ``serving-fleet`` — the cross-process fleet (worker processes over the
   file lanes behind the supervised ``FleetRouter``) at the decode-bench
   width (bf16, prompt 512, 64 new, cache 1024, 8 slots a worker).  (1)
   ``python -m chainermn_tpu_torch.serve --fleet-procs 2`` and ``--disagg
   1:1 --procs`` as subprocesses (16 corpus requests, ``--train-steps
   0``): exit codes ``{"engine0": 0, "engine1": 0}`` and ``{"prefill0":
   0, "decode0": 0}``, each worker's ready line naming ``device=cuda``,
   shed rate 0, no failover, tokens the fused engine's (or a near-tie).
   (2) ``build_proc_fleet({"engine": 2})`` with each worker run through
   ``chip_smoke.py --fleet-worker DIR`` (``serving.worker.main`` that
   writes its launch counts, engine metrics and plane call times at
   exit): serving-disagg's 16 requests at once (tokens/s, TTFT p50 / p99,
   each worker's tick gap p50 / p99, spawn-to-live seconds), 8 flash
   forward + 8 append launches a prefill and 8 decode launches a tick in
   the children, no shed, no failover; then the in-process
   ``build_fleet(params, 2)`` on the same requests.  (3) The 1:1 process
   split over the file lanes (launches per role, no prefill on the decode
   worker, slab pack / put / get / unpack ms p50 / p99).  (4) engine0
   SIGKILLed mid-run: every request ends exactly once, at least one
   failover, the survivor exits 0.  (5) fp32 at 2 layers: the card's
   process fleet against the CPU's ``build_local_fleet``, tokens equal or
   a CPU near-tie < 1e-3.
6e. ``serving-autoscale`` — the fleet autoscaler at the decode-bench
   width: ``build_proc_fleet({"engine": 1})`` with
   ``FleetAutoscaler(proc_spawn_factory, AutoscalePolicy(min_workers=1,
   max_workers=2))`` (spawned workers through ``--fleet-worker`` too);
   ``build_scenario("flash_crowd", prompt_len=512, crowd_prefix_len=448,
   max_new_tokens=64, crowd_n=16, n_background=8)`` replayed by
   ``run_scenario`` crowd after crowd until the spawned worker holds its
   lease, one more crowd on two workers, then no load until the
   autoscaler drains back to one; the status server on port 0, each of
   ``/statusz``, ``/metricsz``, ``/requestz``, ``/debugz`` read once.
   Decision to first lease seconds, TTFT p50 / p99 before and after the
   scale-up, the decisions with their signals.  Fails without a scale-up,
   with no flash / append / decode launch in the spawned worker, a
   request not ended exactly once (done, or shed with its payload), a
   flap, a drained worker's exit code other than 0, endpoints without
   JAX's top-level keys, or tokens off the fused engine's (beyond a
   near-tie < 1e-3; the first crowd and the one on two workers).
6f. ``serving-fleet-tp`` — the worker-process fleet at TP = 2: every
   worker a group of two processes (its leader holds the lease and speaks
   on the lanes, its follower runs the leader's plan) over gloo on this
   one card.  bf16 at the decode-bench width: ``build_proc_fleet({"engine":
   2}, tp=2)`` (four processes) and the 1:1 split ``{"prefill": 1,
   "decode": 1}`` at TP = 2, each serving 16 requests at once (prompt 512,
   64 new tokens) through ``--fleet-worker``: launch counts gathered from
   every rank's report (8 flash forward + 8 append launches a prefill on
   each rank of a prefilling group, 8 decode launches a tick on each rank
   of a ticking one, the follower's calls equal to its leader's), tokens/s,
   TTFT p50 / p99, each group's tick gap p50 / p99, spawn to first lease,
   every request done, every rank's exit 0 after the drain (a 1 s lease
   window: beat 0.1 s, 9 missed beats).  Then fp32 at
   2 layers (the full width otherwise): two groups serve 8 requests (prompt
   256, 32 new) while engine0's follower is SIGKILLed (its leader stops
   beating and exits 3, the lease expires, its requests fail over), then
   engine1's leader is SIGKILLed (its follower must exit within
   ``FLEET_TP_FOLLOWER_BOUND_S``); detection ms for each kill; every
   request done once with tokens equal to the CPU's TP = 1 engine's (or a
   CPU near-tie < 1e-3).  No process of any group may be alive after a
   leg.
7. ``train-parity`` — fp32, d 1024, 2 layers, 8 heads, vocab 32768, S 256,
   B 2, flash attention and the fused CE, TF32 off: the gradient of every
   parameter at the initial weights, card against CPU, to a relative norm
   of 1e-4 (an SGD step of 1e-2 moves the tied embedding by less than
   the parameter tolerance, so the gradients are held directly); then
   two SGD steps on the card and on the CPU from the same weights, losses
   to rtol 1e-4 and parameters to atol 1e-4.
8. ``train`` — bf16, the full width of ``bench.py``'s
   ``bench_transformer_lm`` (d 1024, 8 layers, 8 heads of 128, vocab
   32768, S 1024, B 8, learned positions, SGD 1e-2, flash attention) with
   ``ce_impl="fused"``: 2 warm-up steps, then 10 timed steps, each
   synchronised (step ms p50/p99, tokens/s, analytic MFU against 989
   TFLOP/s, peak memory, every loss).  Losses must be finite and fall, and
   the launch counts, zeroed just before the timed steps and read just
   after, must show 8 flash forward and 8 flash backward launches and one
   of each CE kernel per step.  Then 3 steps with ``ce_impl="auto"`` from
   the same initial weights: the first loss within 2e-2 of the fused one.
9. ``tp`` — the LM over the ``('data', 'model')`` mesh.  First the train
   phase's bf16 step at full width through ``make_hybrid_shard_map_step``
   on a ``(1, 1)`` mesh of the NCCL group: 3 steps whose losses must equal
   the train phase's first 3 bit for bit.  Then TP = 2 as two worker
   processes (``chip_smoke.py --tp-worker RANK DIR``) on this card over a
   gloo group through a ``FileStore`` (NCCL refuses two ranks of one
   communicator on one device; gloo stages the card tensors through host
   memory, so the times are the gloo host wire's on a shared card, not
   NCCL's): (a) fp32 at full width, 3 Adam steps (lr 1e-4) at TP = 2 and
   at TP = 1 on the card, losses rtol 1e-4 and the parameters gathered by
   ``gather_to_numpy`` atol 1e-4 (the key bias apart: its exact gradient
   is zero, and Adam turns the rounding noise there into +-lr steps);
   (b) bf16 at full width, SGD 1e-2, 1 warm-up and 3 timed steps: step
   ms p50 / p99 and each rank's launches a step (8 flash forward, 8 flash
   backward, one of each CE kernel, at flash (8, 1024, 4, 128) and CE
   (8192, 16384, 1024)); (c) fp32 serving of the decode-bench LM (16 heads
   of 64, prompt 512, cache 1024; depth not cut) through
   ``ServingEngine(mesh=...)`` (JAX's defaults: the prefix cache and the
   spill tier on), 8 requests, the odd half sampled, and the
   GQA model (4 KV heads) through beam 4 (B 2, prompt 128, 16 new): each
   TP = 2 token equal to the TP = 1 model's choice on the card at its
   position (a sampled row with TP = 2's noise: each shard's ``(1, V/2)``
   draw), or a near-tie under 1e-3, and the best beams equal or within
   1e-3 of log-probability; the decode, append, beam and flash launches of
   each rank.  (d) The in-process fleets at TP = 2 (rank 0 hosts the
   router and every engine, rank 1 follows the fleet's one plan):
   ``build_disagg_fleet(1, 1)`` over the local and the lanes transport and
   ``build_fleet(2)``, fp32 at 2 layers (8 requests, prompt 256, 16 new,
   the odd half sampled; every token the TP = 1 model's choice on the card
   or a near-tie < 1e-3), then bf16 at full width under ``start()`` (8
   requests, prompt 512, 32 new: TTFT and tick gap p50 / p99 on the gloo
   host wire of one shared card; flash, append and decode launches on
   each rank).  A worker that fails fails the phase.
10. ``sp`` — the sequence-sharded LM (``sp_transformer_lm_loss``) at the
   train phase's widths with RoPE (d 1024, 8 layers, 8 heads of 128,
   vocab 32,768; depth not cut), global S 8,192, B 2, SP = 2 as two
   worker processes (``chip_smoke.py --sp-worker RANK DIR``) on this card
   over a gloo group, as phase ``tp``: ring attention over the flash
   kernels (each visiting K/V block a flash forward with its LSE, the
   backward with the LSE cotangent) and Ulysses (two all-to-alls around
   the flash kernels at the global S).  (a) fp32, 3 Adam steps (lr 1e-4)
   at SP = 2 and at SP = 1 on the card: losses rtol 1e-4, the first
   step's gradients per leaf rtol 1e-4 with atol 1e-4 x the leaf's max
   |g|, the parameters atol 1e-4; (b) bf16, SGD
   1e-2, 1 warm-up and 3 timed steps: losses within 2e-2 of SP = 1's,
   step ms p50 / p99 and tokens/s (the gloo host wire's), each rank's
   launches a step (ring: 8 and 16 of each flash kernel on ranks 0 and 1,
   the causal ring skipping rank 0's later block; Ulysses: 8 and 8);
   (c) ``train_moe`` at P = 2 (the JAX example's sizes, top-1 and top-2,
   20 steps) on the card and on the CPU: losses and the largest expert
   fraction rtol 1e-4; ``make_pipeline`` (remat off and on) and
   ``make_pipeline_1f1b`` with ``tests/test_pipeline.py``'s stage, card
   against CPU, rtol 1e-5 with atol 1e-5 x the largest entry.
10b. ``zero-wire`` — the sharded data-parallel state and the gradient
   wire as two worker processes (``chip_smoke.py --zero-worker RANK
   DIR``) on this card over a gloo group, as phase ``tp``: (a) ZeRO-1
   (``make_zero1_train_step``) on the LM at the train phase's widths and
   4 layers (``ZW_LM``), global batch 8 (4 rows a rank): fp32, 3 Adam
   steps (lr 1e-4) against the unsharded step on the card over the same 8
   rows (losses rtol 1e-4, parameters atol 1e-4), each Adam moment half
   its leaf; bf16, SGD 1e-2, 1 + 3 steps (step ms, each rank's launches a
   step: 4 of each flash kernel and one of each CE kernel); (b) ``train_imagenet --fsdp --arch
   vit_s16 --optimizer lamb --lr 1e-3 --agc 0.01`` at 224, fp32, global
   batch 64, the warm-up step and 2 more, against the same CLI at world 1
   (losses rtol 1e-4, the gathered parameters atol 1e-4; 12 + 12 flash
   launches a step and rank at (32, 197, 6, 64)); (c) ResNet-50 through
   ``train_imagenet`` at 224, global batch 128, pallas, bf16, on the fp32,
   int8, int8 + error feedback wires and, double-buffered, fp32 and int8
   + error feedback: each int8 leg's losses within 5e-2 of its fp32 leg's
   and its parameters different from them (11 launches of each conv
   kernel a step and rank); (d) the int8 ring on a gradient-like vector
   of ResNet-50's 25,557,032 entries on the card and on the CPU (entries
   that differ, and by how many steps of the final block scale) and
   against the exact mean (at most the two quantizations' ``blockmax /
   254`` over P); (e) ``hierarchical_pmean`` on the ``(1, 2)`` multislice
   mesh against the flat mean (fp32 equal, the bf16 slice leg within
   2^-8).  The times are the gloo host wire's; each leg's seconds are
   printed.
11. ``resnet-parity`` — fp32, TF32 off: ResNet-50 at image 112 (stages 1-2
   eligible for the conv kernels at 28² and 14²; the stride-2 and 7 x 7
   convs take cuDNN's backward), batch 4, ``conv_impl="pallas"``, card
   against CPU from the same random weights: the loss to rtol 1e-4, every
   gradient to a relative norm of 1e-4 (6 launches of each conv kernel
   per backward on the card), then two ``make_flax_train_step`` steps
   (SGD 0.1, momentum 0.9, wd 1e-4, world 1; NCCL on the card, gloo on
   the CPU): losses rtol 1e-4, parameters and running statistics atol
   1e-4.
12. ``resnet-train`` — bf16, ``bench.py``'s headline (ResNet-50, image
   224, batch 128, 1,000 classes, SGD 0.1 / momentum 0.9 / wd 1e-4
   through the multi-node optimizer) via ``train_imagenet.build_step`` at
   world 1 over a one-rank NCCL group, ``conv_impl="pallas"``: 2 warm-up
   and 10 timed steps, each synchronised (step ms p50/p99, images/s,
   analytic MFU by ``bench.py:3106``'s 3 x 4.1e9 FLOP per image over 989
   TFLOP/s, peak memory, every loss).  Losses must be finite and the
   launch counts, zeroed just before the timed steps and read just after,
   exactly 11 ``conv_wgrad`` and 11 ``conv_dgrad`` per step.  Then the
   same with ``conv_impl="xla"`` (cuDNN's backward) from the same
   weights: no conv-kernel launch, the first loss within 2e-2 of the
   pallas run's, the step times side by side.
13. ``resnet152-db`` — BASELINE config #4: ResNet-152 with double
   buffering (``build_step(arch="resnet152", double_buffering=True)``),
   bf16, 128 images per card (12.25 GiB at peak on an 80 GB H100), 10
   synchronised steps each with ``conv_impl="pallas"`` and ``"xla"``:
   step ms p50/p99, images/s, analytic MFU (3 x 11.5e9 FLOP per image over
   989 TFLOP/s), peak memory, beside ResNet-50's; exactly 45 ``conv_wgrad``
   and 45 ``conv_dgrad`` launches per pallas step.
14. ``imagenet-parity`` — fp32 (TF32 off), card vs CPU from the same
   weights: NF-ResNet-50 at image 112, batch 4, ``conv_impl="pallas"``
   (skip gains 0.2; 16 1x1 and 6 3x3 launches of each conv kernel a
   backward), ViT-S/16 at image 64 (17 tokens), full depth, through the
   flash kernels (12 forward and 12 backward calls), AlexNet, VGG-16 and
   GoogLeNet at ``stem_strides=1``, image 32: the loss rtol 1e-4, the
   running statistics atol 1e-4, the whole gradient to a relative norm of
   max(1e-4, 4x the CPU's own change when the images move by +1e-7 or by
   -1e-7, the larger) (``_grad_parity``: fp32 ReLU / max-pool flips make
   these gradients chaotic at small batch), and each leaf to 4x the
   larger of that and the leaf's own change; the NF-ResNet's gradients
   with the conv kernels also against the same model's with cuDNN's
   backward on the card (the same forward, so the same flips), each leaf
   to a relative norm of 1e-4.  Then ``train_imagenet.run`` on the card
   and on the CPU: NF-ResNet-50 with LARS, warmup 2, AGC 0.01 and the
   fp16 wire, and ResNet-18 with stalebn and LAMB at lr 0.01, 4 steps at
   image 64, every loss rtol 1e-4; then the stalebn LAMB run at lr 0.1,
   every loss within max(1e-4, 4x the CPU's own change when its initial
   weights move by +1e-7 or by -1e-7).
15. ``imagenet-train`` — bf16, image 224, batch 128, world 1 over a one-rank
   NCCL group, through ``train_imagenet.build_step``: NF-ResNet-50 with
   ``conv_impl="pallas"`` and ``"xla"`` and ViT-B/16 (``attn_impl="auto"``:
   the flash kernels; LAMB 1e-3), 2 warm-up and 10 timed steps each (step
   ms p50/p99, images/s, analytic MFU, peak memory, every loss), exactly
   28 1x1 and 11 3x3 launches of each conv kernel a pallas step, none a
   xla step, 12 flash forward and 12 flash backward calls a ViT step, the
   first xla loss within 2e-2 of the pallas one; then AlexNet, VGG-16 and
   GoogLeNet, 2 + 3 steps.  Losses must be finite.
16. ``comm`` — every communicator method and in-step collective of the
   port's ``TorchDistCommunicator`` on the card at world 1 (the one-rank
   NCCL group the ResNet phases made, or a new one), against
   ``NaiveCommunicator(size=1)``: fp32 and int32 tensors, objects,
   ``split`` with one color (a new NCCL group) and ``send`` / ``recv``
   with ``source == dest``; data movement exact, sums rtol 1e-6.
17. ``trainer`` — ChainerMN's own loop (Trainer → StandardUpdater with the
   prefetch thread → ObservationAggregator / LogReport → the multi-node
   evaluator), each run on the card and again on the CPU from the same
   seeds (fp32, TF32 off): ``python -m chainermn_tpu_torch.train``'s run
   (20 steps; every iteration's ``main/loss`` rtol 1e-4, the final
   weights atol 1e-4, the trace's ``step``, ``step/data`` and
   ``step/compute`` spans) and ``train_mnist`` at ``--unit 1000
   --batchsize 128 --epoch 1`` (64 iterations), run twice on the card
   (with the prefetch thread, a trace and a profiler window; then plain:
   the epoch's loss rtol 1e-4, the evaluator's accuracy within 1/1,024)
   and held to the CPU within ``MNIST_CPU_TOL`` (rtol 1e-3, 32/1,024:
   Adam at width 1000 spreads that far under fp32 reordering alone,
   ``scripts/mnist_fp32_spread.py``); then ``train_mnist --optimizer sgd
   --lr 0.1`` on the card and on the CPU, the epoch loss rtol 1e-4.  Each prints
   iterations/s, update() ms (the two phase spans, host
   ``perf_counter``) and whole-step ms p50/p99 after 3 warm-up steps, the
   two spans' medians and the card line; the MNIST run also the device
   busy ms and idle share of a ``torch.profiler`` window over iterations
   10-19.  No hand-written kernel is on this path.
18. ``observability`` — the metrics stream and the comm ledger on the
   card, each number beside the card line: (a) ``python -m
   chainermn_tpu_torch.train``'s run with ``--metrics-out`` and
   ``--trace-out`` (20 steps) on the card and on the CPU: the JSONL
   validates (``read_metrics_jsonl(strict=True)``), every step record
   carries ``time/data``, ``time/compute``,
   ``throughput/items_per_sec``, ``comm/bytes`` and ``comm/calls``, the
   ``.prom`` parses, the result's keys equal the CPU run's, no loss,
   comm-bytes or MFU finding (step-time spikes of this ~8 ms host-bound
   step are printed: the exporter's own write every 10 iterations can
   make one);
   (b) ResNet-50 at the headline size as the robustness phase builds it
   (bf16, batch 128, pallas), through Trainer + StandardUpdater with
   tracing, ``StepBreakdownReport(flops_per_item=3 * 4.1e9)``,
   ``HealthMonitor`` and ``MetricsReport``: 3 warm-up and 10 timed
   synchronised steps; 11 + 11 conv launches a step, ``perf/mfu``
   within 10% of the MFU the smoke computes from the same iterations'
   wall times, ``comm/bytes`` a step equal to the same step's on the CPU
   (image 64, batch 2: the same tree), no finding; then 4 steps with
   the loss of the third made NaN: ``loss_nonfinite`` in the metrics
   file's summary; (c) the step and iteration ms p50/p99 with tracing
   and the three extensions beside runs without them, in turns (off,
   on, on, off; printed, no limit).
19. ``seq2seq`` — BASELINE config #3 through ``train_seq2seq.run``
   (Trainer, the per-epoch evaluator, four greedy translations, BLEU):
   fp32 (TF32 off) at 512 units, 3 layers, vocabulary 4,096, 3 steps on
   the card and on the CPU, every loss rtol 1e-4 and the greedy tokens
   equal (or a CPU near-tie under 1e-3); then bf16 at full width
   (``SEQ2SEQ``: 512 units, 3 layers, batch 64, bucket 32, vocabulary
   32,768, one epoch of 40 iterations): target tokens/s over the sum of
   every step's span, step ms p50/p99, peak memory, and the device busy
   ms, ops and idle share of a
   ``torch.profiler`` window of 5 iterations.  No kernel launches.
20. ``model-parallel`` — at world 1 (NCCL cannot put two ranks on one
   card): a ``MultiNodeChainList`` of config #5's two stages on rank 0
   joined by a self-edge, every ``functions`` call forward and backward,
   and ``MultiNodeBatchNormalization``, each against the CPU in fp32
   (elementwise rtol 1e-5, atol 1e-5 of the tensor's largest entry).
   World 2 is held over gloo by the tests.
21. ``robustness`` — ResNet-50 at the headline size (bf16, image 224,
   batch 128, ``conv_impl="pallas"``, ``train_imagenet.build_step``)
   through Trainer + StandardUpdater with a ``MultiNodeCheckpointer``
   (asynchronous, keep 2, a save every 4 iterations, through
   ``training.extensions.snapshot``): leg U runs 8 steps twice (losses, a
   device clone of the whole state at iteration 4); leg R builds the model
   from another seed, ``maybe_load``s U's generation 4 (generation 8
   removed, as by a crash before it) and runs iterations 5-8.  Held: the
   loaded state equals the clone bit for bit; R's losses equal U's when
   the two U runs agree bit for bit, else lie within their spread;
   exactly 11 launches of each conv kernel a step in every run.  The same
   with double buffering (``stale_grads`` come back too).  A timing leg
   (16 steps, four saves) prints the bytes a generation, ``save()``'s
   blocking ms, the writer's ms, ``maybe_load``'s ms and the step ms p50
   with a write in flight beside p50 without.  Then three groups side by
   side, in subprocesses: ``train_mnist_checkpoint --unit 1000`` killed at
   epoch 2 (exit 99) and rerun, its final loss against an uninterrupted
   run's; ``python -m chainermn_tpu_torch.train --checkpoint-dir
   --preemption-grace-s 30 --self-heal --flight-dump-dir`` sent SIGTERM
   once its first generation is on disk (exit 0, a ``preempt`` bundle
   naming the generation saved) and rerun to the uninterrupted run's final
   loss; and two gloo processes on the CPU training MNIST with SGD 0.1 to
   a world-2 generation, resumed at world 1 on the card (batch 256, the
   same global batch) within rtol 1e-4 of the CPU's own continuation.
22. ``analysis`` — the trace engine (``analysis/trace_engine.py``) over
   its two kernel-bearing entry points at ``size="full"`` (the
   decode-bench LM width, 2 layers, fp32) on the card:
   ``parallel.decode.lm_decode_tick`` (a prefill through the flash forward
   and the append kernel, then three ticks through the decode kernel with
   the K/V append folded in) and ``serving.prefill_family`` (three
   prefills at two prompt lengths).  Held: no finding beyond the port's
   baseline; the collective sequences and program counts equal the CPU's
   at ``size="tiny"``; the flash, decode and append launches equal what
   the calls imply (a layer each per prefill or tick); each entry's
   outputs (hidden states and caches) equal the same entry's on the CPU's
   plain path within fp32's 1e-4.  Then the shard-flow analyzer
   (``analysis/shardflow.py``) over the same two entries at ``size="full"``
   on the card: each ``reconciled`` with no finding beyond the port's
   ``.shardflow-baseline.json``; its kernel-wrapper nodes equal the kernel
   launches of the same call (flash forward and append for the family,
   decode for the tick); its static groups, replication report and
   peak-live estimate equal the CPU's at the same size byte for byte; and
   the estimate less the card storages resident before the call is at
   most the caching allocator's peak delta over one plain call (after a
   warm one), and so is the peak of the storages the call creates on the
   card (``peak_defined_bytes``), all printed with their ratios.  Then the port's lock-order recorder
   (``CHAINERMN_TPU_TORCH_LOCK_ASSERT``) in a child process
   (``chip_smoke.py --lock-worker``) over 16 requests served on the card,
   8 through a ``ServingEngine``'s driver thread and 8 through a
   two-replica router: ``assert_consistent`` must pass; the dynamic edges
   are printed.
23. One ``{"kernels": [...]}`` line (launches summed over the main paths'
   runs: the analysis phase's two entry points, the two serving runs, the serving-prefix cache-on run, the
   serving-disagg ``run()`` legs (local, lanes, GQA), the beam
   run, the timed LM training steps,
   the ``tp`` phase's ``(1, 1)`` steps and both ranks' bf16 steps, serving
   and beam runs, phase ``sp``'s bf16 steps of both ranks (ring and
   Ulysses), phase ``zero-wire``'s ZeRO-1 bf16 steps, FSDP run and int8
   ResNet-50 run of both ranks, the timed pallas ResNet-50, ResNet-152 and NF-ResNet-50
   steps, the timed ViT-B/16 steps, the observability phase's instrumented
   ResNet-50 run and the robustness phase's ResNet-50 runs), the
   card line, then the result line ``{"ok": true, "device": {...}}``.
"""

import json
import os
import signal
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# the card's bf16 peak and HBM bandwidth come from the port's peak table
# (observability/metrics.py) once the package imports (main); the fp32
# CUDA-core peak is the smoke's own
HBM_BYTES_PER_S = None
PEAK_FLOPS = {"bfloat16": None, "float32": 67e12}
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
FULL = dict(vocab=32768, d_model=1024, n_heads=16, n_layers=8)
HEAD_DIM = FULL["d_model"] // FULL["n_heads"]
GQA_KV_HEADS = 4            # the GQA configuration: g = 4 query heads per KV head
BEAM = dict(batch=8, prompt=512, new=512, beam_size=4)   # bench.py bench_decode
# bench.py :: bench_transformer_lm's defaults
TRAIN = dict(vocab=32768, d_model=1024, n_heads=8, n_layers=8)
TRAIN_SEQ, TRAIN_BATCH = 1024, 8
# the LM of phase zero-wire: the train widths (so every kernel runs at its
# per-layer shapes) at half the depth
ZW_LM = dict(TRAIN, n_layers=4)
HEAD_DIM_TRAIN = TRAIN["d_model"] // TRAIN["n_heads"]
# bench.py's headline: ResNet-50, image 224, batch 128 per card, 1,000 classes
RESNET = dict(arch="resnet50", image=224, batch=128, classes=1000)
RESNET_FLOPS_PER_IMAGE = 3 * 4.1e9          # bench.py:3106, training ~3x fwd
RESNET_CONV_LAUNCHES = 11   # eligible 3x3 convs per step at 224 (3 + 3 + 5)
# BASELINE config #4: ResNet-152 with double buffering, bench.py's batch
RESNET152 = dict(arch="resnet152", image=224, batch=128, classes=1000)
# ResNet-152's forward is 11.5e9 FLOP per 224² image, counted as bench.py
# counts ResNet-50's 4.1e9 (multiply-adds; He et al. 2016, Table 1, gives
# 11.3e9 and 3.8e9); training ~3x forward
RESNET152_FLOPS_PER_IMAGE = 3 * 11.5e9
RESNET152_CONV_LAUNCHES = 45    # eligible 3x3 convs per step (3 + 7 + 35)
# BASELINE config #3 at full width: the model's own defaults (512 units, 3
# layers), the example's batch of 64 a step, bucket 32 with sources of 2-30
# tokens, a WMT-scale vocabulary of 32,768 (the example's 32 is the
# alphabet of its toy task); one epoch of 2,560 pairs is 40 iterations
SEQ2SEQ = dict(unit=512, layer=3, batchsize=64, bucket=32, max_len=30,
               vocab=32768, n_train=2560, n_val=256, epoch=1)
# the fp32 card-vs-CPU leg: the same width, vocabulary 4,096, 3 steps
SEQ2SEQ_PARITY = dict(SEQ2SEQ, vocab=4096, n_train=192, n_val=64)
# NF-ResNet-50 (Brock et al. 2021) at bench.py's headline size: every SAME
# conv goes through ops.conv2d, so the eligible ones (stride 1, plane >= 14²)
# launch the conv kernels: 28 1x1 and 11 3x3 a step at 224
NF_RESNET = dict(arch="nf_resnet50", image=224, batch=128, classes=1000)
NF_CONV_LAUNCHES = {1: 28, 3: 11}
# the ten distinct eligible 1x1 shapes of an NF-ResNet-50 step at batch 128
# (plane, Ci, Co), timed beside cuDNN: stage 0 (56²) 64 -> 64, 64 -> 256
# (the last conv and the shortcut), 256 -> 64; stage 1 (the stride on the
# 3x3) 256 -> 128 at 56², then 128 -> 512, 512 -> 128 at 28²; stage 2
# 512 -> 256 at 28², then 256 -> 1024, 1024 -> 256 at 14²; stage 3's first
# 1024 -> 512 at 14² (the rest of stage 3, at 7², is not eligible)
NF_1X1 = ((56, 64, 64), (56, 64, 256), (56, 256, 64), (56, 256, 128),
          (28, 128, 512), (28, 512, 128), (28, 512, 256), (14, 256, 1024),
          (14, 1024, 256), (14, 1024, 512))
# ViT-B/16 (Dosovitskiy et al. 2021): d 768, 12 layers of 12 heads of 64,
# patch 16 (196 patches + CLS = 197 tokens at 224), at the same size
VIT = dict(arch="vit_b16", image=224, batch=128, classes=1000)
VIT_LAYERS, VIT_HEADS, VIT_HEAD_DIM = 12, 12, 64
# the rest of the example's zoo, 2 warm-up and 3 timed steps each
CONVNETS = ("alex", "vgg16", "googlenet")
# (library, kernel, a piece of its mangled name): the bf16 kernels that are
# wgmma GEMMs, each of which must hold HGMMA instructions in its SASS
WGMMA_KERNELS = (
    ("fused_ce", "ce_stats", "ce_gemm_kernelILi256ELi3E"),
    ("fused_ce", "ce_grads ds pass", "ce_gemm_kernelILi256ELi0E"),
    ("fused_ce", "ce_grads dh", "ce_gemm_kernelILi256ELi1E"),
    ("fused_ce", "ce_grads dtable", "ce_gemm_kernelILi128ELi2E"),
    ("flash_fwd", "flash_fwd", "flash_fwd_wgmma_kernel"),
    ("conv_backward", "conv_wgrad", "conv_wgrad_wgmma_kernel"),
    ("conv_backward", "conv_dgrad", "conv_dgrad_wgmma_kernel"),
    ("flash_bwd", "flash_bwd dk, dv", "flash_bwd_dkdv_wgmma_kernel"),
    ("flash_bwd", "flash_bwd dq", "flash_bwd_dq_wgmma_kernel"),
)
# (library, a piece of the mangled name): kernels whose ptxas report must
# show no spill (the bf16 redesigns; the build phase prints every kernel's)
NO_SPILL_KERNELS = (
    ("flash_bwd", "flash_bwd_dkdv_wgmma_kernel"),
    ("flash_bwd", "flash_bwd_dq_wgmma_kernel"),
    ("beam_attention", "beam_split_mma_kernel"),
    ("decode_attention", "decode_split_kernel"),
)
KERNEL_INFO = {
    "flash_fwd": ("chainermn_tpu_torch/csrc/flash_fwd.cu",
                  "chainermn_tpu/ops/flash_attention.py:226"),
    "flash_bwd": ("chainermn_tpu_torch/csrc/flash_bwd.cu",
                  "chainermn_tpu/ops/flash_attention.py:426"),
    "decode_attend": ("chainermn_tpu_torch/csrc/decode_attention.cu",
                      "chainermn_tpu/ops/decode_attention.py:181"),
    "cache_append": ("chainermn_tpu_torch/csrc/kv_cache.cu",
                     "chainermn_tpu/ops/kv_cache.py:198"),
    "ce_stats": ("chainermn_tpu_torch/csrc/fused_ce.cu",
                 "chainermn_tpu/ops/fused_ce.py:210"),
    "ce_dh": ("chainermn_tpu_torch/csrc/fused_ce.cu",
              "chainermn_tpu/ops/fused_ce.py:254"),
    "ce_dtable": ("chainermn_tpu_torch/csrc/fused_ce.cu",
                  "chainermn_tpu/ops/fused_ce.py:273"),
    "beam_attend": ("chainermn_tpu_torch/csrc/beam_attention.cu",
                    "chainermn_tpu/ops/decode_attention.py:324"),
    "conv_wgrad": ("chainermn_tpu_torch/csrc/conv_backward.cu",
                   "chainermn_tpu/ops/conv_backward.py:243"),
    "conv_dgrad": ("chainermn_tpu_torch/csrc/conv_backward.cu",
                   "chainermn_tpu/ops/conv_backward.py:320"),
}


def emit(obj):
    print(json.dumps(obj), flush=True)


class Smoke:
    def __init__(self, torch):
        self.torch = torch
        self.failed = []
        self.errors = {}           # failed phase -> its exception's repr
        self.kernel_rows = {}      # name -> timing/err row of the main shape
        self.launches = {}         # name -> launches summed over main paths

    def add_launches(self, counts):
        for name, n in counts.items():
            self.launches[name] = self.launches.get(name, 0) + n

    def phase(self, name, fn):
        t0 = time.monotonic()
        try:
            fn()
        except Exception as e:  # noqa: BLE001 — report every phase
            self.failed.append(name)
            self.errors[name] = repr(e)[:2000]
            print(f"FAIL phase {name}: {e!r}", flush=True)
            traceback.print_exc()
            return
        print(f"PASS phase {name} ({time.monotonic() - t0:.1f} s)", flush=True)

    # ---- timing ----
    def time_ms(self, fn, iters=20):
        """Median device time of ``fn`` with L2 flushed before each launch.
        The flush writes 256 MB (~80 us of device time), long enough for
        the host to enqueue the start event and ``fn``'s launches behind
        it, so the measured window holds device work, not host enqueue."""
        torch = self.torch
        flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
        for _ in range(3):
            fn()
        times = []
        for _ in range(iters):
            flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        times.sort()
        return times[len(times) // 2]

    def compare(self, name, got, want, dtype_name, scaled=False, **info):
        """Elementwise ``|got - want| <= tol + tol·|want|``.  With
        ``scaled``, also ``max |got - want| <= tol · max |want|``: for
        outputs whose entries sit far below ``tol``, where the elementwise
        test alone would pass zeros."""
        tol = TOL[dtype_name]
        got, want = got.float(), want.float()
        err = (got - want).abs()
        bad = int((err > tol + tol * want.abs()).sum())
        finite = bool(self.torch.isfinite(got).all().item())
        max_err, max_ref = float(err.max()), float(want.abs().max())
        row = dict(check=name, dtype=dtype_name, max_abs_err=max_err,
                   atol=tol, rtol=tol, bad=bad, finite=finite, **info)
        if scaled:
            row.update(max_abs_ref=max_ref, err_over_max_ref=max_err / max_ref)
            bad += int(max_err > tol * max_ref)
        emit(row)
        if bad or not finite:
            raise AssertionError(f"{name} [{dtype_name}] out of tolerance: "
                                 f"{bad} failures, max err {max_err}, "
                                 f"max |ref| {max_ref}")
        return max_err


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device(smoke):
    torch = smoke.torch
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    smoke.card = out.stdout.strip().splitlines()[0] if out.stdout else "unknown"
    print(smoke.card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}",
          flush=True)


def phase_build(smoke):
    from chainermn_tpu_torch.ops import _build

    t0 = time.monotonic()
    report = _build.build()
    emit({"check": "build", "seconds": round(time.monotonic() - t0, 2),
          "per_source_s": {k: round(v["seconds"], 2) for k, v in report.items()}})
    for name, rep in report.items():
        for line in rep["log"].splitlines():
            if name in ("fused_ce", "flash_fwd", "flash_bwd", "conv_backward",
                        "beam_attention", "decode_attention") \
                    and "Compiling entry" in line \
                    or any(k in line for k in ("registers", "spill", "warning")):
                print(f"ptxas {name}: {line.strip()}", flush=True)
        _build.library(name)
    # every bf16 wgmma kernel must have kept its wgmma instructions
    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    if not cuobjdump.exists():
        raise AssertionError(f"no cuobjdump beside nvcc ({cuobjdump}): the "
                             f"HGMMA counts cannot be read")
    per_fn = {}
    for lib in sorted({lib for lib, _, _ in WGMMA_KERNELS}):
        sass = subprocess.run([str(cuobjdump), "-sass", report[lib]["path"]],
                              capture_output=True, text=True, timeout=300)
        per_fn[lib] = _hgmma_per_function(sass.stdout)
    for lib, kernel, piece in WGMMA_KERNELS:
        fns = {f: n for f, n in per_fn[lib].items() if piece in f}
        emit({"check": f"build.{lib}.hgmma", "kernel": kernel,
              "sass_hgmma_instructions": fns})
        if not fns or not all(fns.values()):
            raise AssertionError(f"{kernel} in lib{lib} has no HGMMA "
                                 f"instruction: its bf16 kernel lost its "
                                 f"wgmma ({fns})")
    for lib, piece in NO_SPILL_KERNELS:
        spills = {f: n for f, n in _spills_per_function(report[lib]["log"])
                  .items() if piece in f}
        emit({"check": f"build.{lib}.spill", "kernel": piece,
              "spill_bytes": spills})
        if not spills or any(spills.values()):
            raise AssertionError(f"{piece} in lib{lib} spills (or has no "
                                 f"ptxas report): {spills}")


def _spills_per_function(log):
    """Spill store + load bytes per kernel (mangled name) of a ``ptxas
    -v`` report."""
    spills, name = {}, None
    for line in log.splitlines():
        if "Function properties for" in line:
            name = line.split("Function properties for", 1)[1].strip()
        elif name is not None and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            spills[name] = nums[1] + nums[2]   # stack, stores, loads
            name = None
    return spills


def _hgmma_per_function(sass):
    """HGMMA instructions per kernel (mangled name) of a ``cuobjdump
    -sass`` listing."""
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            counts[name] = 0
        elif name is not None and "HGMMA" in line:
            counts[name] += 1
    return counts


def _flash_bound(b, s, h, d, causal, elem, dtype_name):
    pairs = s * (s + 1) / 2 if causal else s * s
    flops = 4.0 * b * h * d * pairs
    nbytes = 4.0 * b * s * h * d * elem + 4.0 * b * h * s
    return _bound(nbytes, flops, dtype_name)


def _bound(nbytes, flops, dtype_name):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def check_flash(smoke):
    torch = smoke.torch
    import torch.nn.functional as F
    from chainermn_tpu_torch.ops import flash_attention, flash_attention_plain

    g = torch.Generator(device="cuda").manual_seed(1)
    cases = [  # (B, S, H, H_kv, D, causal, timed)
        (8, 1024, 8, 8, 128, True, True),     # the LM training step
        (8, 1024, 4, 4, 128, True, False),    # the step at TP = 2 (a rank)
        (8, 512, 16, 16, 64, True, True),     # lm_generate prefill
        (1, 512, 8, 8, 64, True, False),      # serving prefill at TP = 2
        (2, 128, 8, 2, 64, True, False),      # GQA beam prefill at TP = 2
        (1, 512, 16, 16, 64, True, False),    # serving prefill
        (2, 77, 16, 16, 64, True, False),     # ragged tail
        (2, 77, 16, 16, 64, False, False),    # non-causal
        (2, 512, 16, 8, 64, True, False),     # group 2
        (2, 200, 4, 4, 128, True, False),     # head_dim 128
        (1, 1, 4, 4, 64, True, False),        # one token
        (3, 33, 6, 2, 128, False, False),     # tail inside a tile, group 3
        (1, 1000, 2, 2, 64, False, False),    # long, non-causal
        (128, 197, 12, 12, 64, False, True),  # ViT-B/16 at 224
        (32, 197, 6, 6, 64, False, True),     # ViT-S/16 FSDP, a rank's rows
        (2, 4096, 8, 8, 128, True, False),    # ring at SP = 2: the diagonal
        (2, 4096, 8, 8, 128, False, False),   # ring at SP = 2: a whole block
        (2, 8192, 4, 4, 128, True, False),    # Ulysses at SP = 2: a rank's heads
    ]
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).replace("torch.", "")
        for b, s, h, hkv, d, causal, timed in cases + [
                (2, 200, 4, 2, 128, True, "misaligned")]:
            q = torch.randn(b, s, h, d, generator=g, device="cuda").to(dtype)
            k = torch.randn(b, s, hkv, d, generator=g, device="cuda").to(dtype)
            v = torch.randn(b, s, hkv, d, generator=g, device="cuda").to(dtype)
            if timed == "misaligned":       # q's base one element past 16 bytes
                q = torch.empty(q.numel() + 1, dtype=dtype, device="cuda")[
                    1:].view(q.shape).copy_(q)
                assert q.data_ptr() % 16
                timed = False
            out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
            ref, ref_lse = flash_attention_plain(q, k, v, causal=causal)
            torch.cuda.synchronize()
            shape = dict(B=b, S=s, H=h, H_kv=hkv, D=d, causal=causal,
                         aligned=q.data_ptr() % 16 == 0)
            err = smoke.compare("flash_fwd.out", out, ref, dn, **shape)
            smoke.compare("flash_fwd.lse", lse, ref_lse, dn, **shape)
            del out, lse, ref, ref_lse
            if not (timed and dtype == torch.bfloat16):
                continue
            ms = smoke.time_ms(lambda: flash_attention(q, k, v,
                                                       causal=causal))
            plain = smoke.time_ms(
                lambda: flash_attention_plain(q, k, v, causal=causal), iters=3)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            lib = smoke.time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal))
            bound, by = _flash_bound(b, s, h, d, causal, q.element_size(), dn)
            if s == TRAIN_SEQ:               # the main-path row: training
                smoke.kernel_rows["flash_fwd"] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
                    bound_by=by, library_ms=lib, shape=shape, dtype=dn)
            emit(dict(check="flash_fwd.time", max_abs_err=err, atol=TOL[dn],
                      kernel_ms=ms, plain_ms=plain, library_ms=lib,
                      library="SDPA", bound_ms=bound, bound_by=by, **shape))
    check_flash_long(smoke)


# bench.py :: bench_long_context's rows (B, S, H, hd; causal): 1c / 2c, 1d / 2d
LONG_ROWS = {"c": (2, 8192, 8, 128), "d": (1, 16384, 8, 128)}


def _by_head(torch, fn, *xs):
    """``fn`` over one head at a time (every ``(B, S, H, D)`` argument
    sliced on dim 2, every ``(B, H, S)`` one on dim 1), the results joined
    back: the plain versions' answer at a size whose whole ``(B, H, S,
    S)`` scores would not fit (MHA only)."""
    def head(x, i):
        return x[:, :, i:i + 1] if x.dim() == 4 else x[:, i:i + 1]

    parts = [fn(*(head(x, i) for x in xs)) for i in range(xs[0].shape[2])]
    return [torch.cat([p[j] for p in parts], 2 if parts[0][j].dim() == 4
                      else 1) for j in range(len(parts[0]))]


def _time_plain(smoke, fn, iters=3):
    """The plain version's median ms, or None where it does not fit on
    the card (it materialises the ``(B, H, S, S)`` fp32 scores)."""
    torch = smoke.torch
    try:
        return smoke.time_ms(fn, iters=iters)
    except torch.cuda.OutOfMemoryError:
        torch.cuda.empty_cache()
        return None


def check_flash_long(smoke):
    """The long-context rows in bf16, causal: the forward (1c, 1d) and the
    backward (2c, 2d) against their plain versions (run a head at a time)
    and timed beside the plain version, where it fits, and SDPA's forward
    and backward."""
    torch = smoke.torch
    import torch.nn.functional as F
    from chainermn_tpu_torch.ops import (flash_attention, flash_attention_bwd,
                                         flash_attention_bwd_plain,
                                         flash_attention_plain)

    g = torch.Generator(device="cuda").manual_seed(11)
    dn = "bfloat16"
    for row, (b, s, h, d) in LONG_ROWS.items():
        q, k, v, do = (torch.randn(b, s, h, d, generator=g, device="cuda")
                       .to(torch.bfloat16) for _ in range(4))
        out, lse = flash_attention(q, k, v, causal=True, return_lse=True)
        ref = _by_head(torch, lambda *a: flash_attention_plain(
            *a, causal=True), q, k, v)
        torch.cuda.synchronize()
        shape = dict(B=b, S=s, H=h, H_kv=h, D=d, causal=True)
        err = smoke.compare(f"flash_fwd.out.1{row}", out, ref[0], dn, **shape)
        smoke.compare(f"flash_fwd.lse.1{row}", lse, ref[1], dn, **shape)
        del ref
        ms = smoke.time_ms(lambda: flash_attention(q, k, v, causal=True))
        plain = _time_plain(smoke, lambda: flash_attention_plain(
            q, k, v, causal=True))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib = smoke.time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))
        bound, by = _flash_bound(b, s, h, d, True, 2, dn)
        emit(dict(check="flash_fwd.time", row=f"1{row}", max_abs_err=err,
                  atol=TOL[dn], kernel_ms=ms, plain_ms=plain,
                  plain_fits=plain is not None, library_ms=lib,
                  library="SDPA", bound_ms=bound, bound_by=by, **shape))
        got = flash_attention_bwd(q, k, v, out, lse, do, True)
        ref = _by_head(torch, lambda *a: flash_attention_bwd_plain(
            *a, causal=True), q, k, v, out, lse, do)
        torch.cuda.synchronize()
        err = max(smoke.compare(f"flash_bwd.d{n}.2{row}", x, r, dn, **shape)
                  for n, x, r in zip("qkv", got, ref))
        del got, ref
        ms = smoke.time_ms(lambda: flash_attention_bwd(q, k, v, out, lse, do,
                                                       True))
        plain = _time_plain(smoke, lambda: flash_attention_bwd_plain(
            q, k, v, out, lse, do, True))
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                      for x in (q, k, v))
        ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        dot = do.transpose(1, 2).contiguous()
        lib = smoke.time_ms(lambda: torch.autograd.grad(
            ot, (qt, kt, vt), dot, retain_graph=True))
        bound, by = _flash_bwd_bound(b, s, h, h, d, True, 2, dn)
        emit(dict(check="flash_bwd.time", row=f"2{row}", max_abs_err=err,
                  atol=TOL[dn], kernel_ms=ms, plain_ms=plain,
                  plain_fits=plain is not None, library_ms=lib,
                  library="SDPA backward", bound_ms=bound, bound_by=by,
                  **shape))
        del q, k, v, do, out, lse, qt, kt, vt, ot, dot
        torch.cuda.empty_cache()


def _decode_bound(pos, b, s, d, elem, dtype_name, append):
    """Bytes: each row's K and V up to pos read once, q read and the
    output written, pos; with the append, the new K and V rows read and
    written.  Operations: the scores and the PV products."""
    n_read = float((pos.long().clamp(0, s - 1) + 1).sum()
                   if hasattr(pos, "long") else b * (min(pos, s - 1) + 1))
    nbytes = 2 * b * d * elem + 2 * n_read * d * elem + 4 * b
    if append:
        nbytes += 2 * 2 * b * d * elem
    return _bound(nbytes, 4.0 * n_read * d, dtype_name)


def check_decode(smoke):
    """``decode_attend`` and the tick's ``decode_append_attend`` against
    their plain versions: the new K/V row attended at min(pos, S - 1) and
    the caches after the call equal to ``cache_append_plain``'s, exactly.
    Cases: tiny caches (S 7, S 1), few slots (B 4 and 1: 33 and 64 splits
    a row, merged in three and four rounds), widths past one head group (D
    2560, 4096, 8192), per-row pos at the edges (0, 1, S - 1, past S), on
    the bf16 split plan's tile and split edges and at the serving run's
    lengths (also at a rank's 8 heads of 64 at TP = 2), a scalar pos, two fused calls in a row at different pos (the
    counters reset), q / k / v as head views of a fused QKV projection;
    bf16 and fp32, hd 64 and 128.  Timed (bf16, hd
    64): attention alone and the fused call at the serving lengths and over
    the full cache, beside SDPA (+ ``index_put_`` of the new rows for the
    fused call)."""
    torch = smoke.torch
    import torch.nn.functional as F
    from chainermn_tpu_torch.ops import (decode_append_attend,
                                         decode_append_attend_plain,
                                         decode_attend, decode_attend_plain)

    g = torch.Generator(device="cuda").manual_seed(2)
    b, s = 8, 1024

    def vec(xs):
        return torch.tensor(xs, dtype=torch.int32, device="cuda")

    edge_pos = vec([0, 1, 100, 511, 777, 1022, 1023, 5000])
    # n = pos + 1 over the plan's 8-position tiles and 16 splits (B 8, D
    # 1024): one tile, the new row last (n 8) or first (n 9) in it; one
    # tile a split (n 128) and one over, in the last split (n 129); two a
    # split (n 256) and one over (n 257); 17 tiles, the last full (n 136),
    # and 18, the last of one position (n 137)
    split_pos = vec([7, 8, 127, 128, 255, 256, 135, 136])
    # the serving run's positions: prompts of 512 plus up to 64 new tokens
    serve_pos = torch.randint(512, 576, (b,), generator=g, device="cuda",
                              dtype=torch.int32)

    def fused_check(q, kc, vc, kn, vn, at, dn, **shape):
        """One fused call at positions ``at`` on copies of the caches
        against the plain pair; returns the context's error."""
        k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
        kw = dict(n_heads=shape["H"], head_dim=shape["hd"])
        out = decode_append_attend(q, kn, vn, k1, v1, at, **kw)
        ref = decode_append_attend_plain(q, kn, vn, k2, v2, at, **kw)
        torch.cuda.synchronize()
        err = smoke.compare("decode_append_attend", out, ref, dn, **shape)
        if not (torch.equal(k1, k2) and torch.equal(v1, v2)):
            raise AssertionError(f"decode_append_attend {shape}: the caches "
                                 f"differ from cache_append_plain's")
        return err

    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).replace("torch.", "")
        for bs, ss, h, hd, pos, label in (
                (3, 7, 2, 128, [0, 3, 100], "tiny"),
                (1, 1, 4, 64, [0], "tiny"),
                # 33 splits: one tile each (n 264), one over (n 265)
                (4, 1024, 16, 64, [263, 264, 1023, 5000], "few_slots"),
                # 64 splits: one tile each, two each, one live split
                (1, 1024, 16, 64, [511], "few_slots"),
                (1, 1024, 16, 64, [1023], "few_slots"),
                (1, 1024, 8, 128, [0], "few_slots"),
                # two head groups of 1280 and of 2048 lanes, four of 2048
                (3, 200, 40, 64, [17, 199, 64], "wide"),
                (4, 512, 32, 128, [0, 100, 511, 5000], "wide"),
                (2, 300, 64, 128, [299, 32], "wide")):
            q, kn, vn = (torch.randn(bs, h * hd, generator=g, device="cuda")
                         .to(dtype) for _ in range(3))
            kc, vc = (torch.randn(bs, ss, h * hd, generator=g,
                                  device="cuda").to(dtype) for _ in range(2))
            pos = vec(pos)
            shape = dict(B=bs, S=ss, H=h, hd=hd, pos=label)
            smoke.compare(
                "decode_attend",
                decode_attend(q, kc, vc, pos, n_heads=h, head_dim=hd),
                decode_attend_plain(q, kc, vc, pos, n_heads=h, head_dim=hd),
                dn, **shape)
            fused_check(q, kc, vc, kn[:, None], vn[:, None], pos, dn,
                        **shape)
        # the serving width, hd 128, and a rank's heads at TP = 2
        for h, hd in ((16, 64), (8, 128), (8, 64)):
            d = h * hd
            q, kn, vn = (torch.randn(b, d, generator=g, device="cuda")
                         .to(dtype) for _ in range(3))
            kc = torch.randn(b, s, d, generator=g, device="cuda").to(dtype)
            vc = torch.randn(b, s, d, generator=g, device="cuda").to(dtype)
            for label, pos in (("edge", edge_pos), ("split_edges", split_pos),
                               ("scalar", 300), ("full", 1023),
                               ("serve", serve_pos)):
                out = decode_attend(q, kc, vc, pos, n_heads=h, head_dim=hd)
                ref = decode_attend_plain(q, kc, vc, pos, n_heads=h,
                                          head_dim=hd)
                torch.cuda.synchronize()
                shape = dict(B=b, S=s, H=h, hd=hd, pos=label)
                err = smoke.compare("decode_attend", out, ref, dn, **shape)
                f_err = fused_check(q, kc, vc, kn[:, None], vn[:, None], pos,
                                    dn, **shape)
                if not (label in ("serve", "full") and hd == 64
                        and h == FULL["n_heads"] and dtype == torch.bfloat16):
                    continue
                ms = smoke.time_ms(lambda: decode_attend(
                    q, kc, vc, pos, n_heads=h, head_dim=hd))
                k1, v1 = kc.clone(), vc.clone()
                f_ms = smoke.time_ms(lambda: decode_append_attend(
                    q, kn, vn, k1, v1, pos, n_heads=h, head_dim=hd))
                plain = smoke.time_ms(lambda: decode_attend_plain(
                    q, kc, vc, pos, n_heads=h, head_dim=hd), iters=5)
                f_plain = smoke.time_ms(lambda: decode_append_attend_plain(
                    q, kn, vn, k1, v1, pos, n_heads=h, head_dim=hd), iters=5)
                p_vec = (pos.long() if isinstance(pos, torch.Tensor)
                         else torch.full((b,), pos, device="cuda"))
                qt = q.view(b, h, 1, hd)
                kt = kc.view(b, s, h, hd).transpose(1, 2)
                vt = vc.view(b, s, h, hd).transpose(1, 2)
                mask = (torch.arange(s, device="cuda")[None, :]
                        <= p_vec[:, None])[:, None, None, :]
                bi, row = torch.arange(b, device="cuda"), p_vec.clamp(0, s - 1)

                def sdpa():
                    return F.scaled_dot_product_attention(qt, kt, vt,
                                                          attn_mask=mask)

                def sdpa_append():
                    kc.index_put_((bi, row), kn)
                    vc.index_put_((bi, row), vn)
                    return sdpa()

                lib = smoke.time_ms(sdpa)
                f_lib = smoke.time_ms(sdpa_append)
                elem = q.element_size()
                bound, by = _decode_bound(pos, b, s, d, elem, dn, False)
                f_bound, f_by = _decode_bound(pos, b, s, d, elem, dn, True)
                if label == "serve":       # the main path's call: the tick
                    smoke.kernel_rows["decode_attend"] = dict(
                        max_abs_err=f_err, ms=f_ms, plain_ms=f_plain,
                        bound_ms=f_bound, bound_by=f_by, library_ms=f_lib,
                        shape=shape, dtype=dn)
                emit(dict(check="decode_attend.time", max_abs_err=err,
                          atol=TOL[dn], kernel_ms=ms, plain_ms=plain,
                          library_ms=lib, library="SDPA", bound_ms=bound,
                          bound_by=by, **shape))
                emit(dict(check="decode_append_attend.time",
                          max_abs_err=f_err, atol=TOL[dn], kernel_ms=f_ms,
                          plain_ms=f_plain, library_ms=f_lib,
                          library="SDPA + index_put_", bound_ms=f_bound,
                          bound_by=f_by, **shape))
            # two fused calls in a row on one pair of caches, at different
            # pos: the second sees the first's row and fresh counters
            k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
            for i, pos in enumerate((serve_pos, split_pos + 1)):
                kn_i, vn_i = kn.roll(i, 0), vn.roll(i, 0)
                out = decode_append_attend(q, kn_i, vn_i, k1, v1, pos,
                                           n_heads=h, head_dim=hd)
                ref = decode_append_attend_plain(q, kn_i, vn_i, k2, v2, pos,
                                                 n_heads=h, head_dim=hd)
                torch.cuda.synchronize()
                smoke.compare("decode_append_attend", out, ref, dn, B=b, S=s,
                              H=h, hd=hd, pos=f"twice.{i}")
            if not (torch.equal(k1, k2) and torch.equal(v1, v2)):
                raise AssertionError("decode_append_attend twice: the caches "
                                     "differ from cache_append_plain's")
        # the tick's layout: q, k, v as head views of one QKV projection
        h, hd = 16, 64
        qkv = torch.randn(b, 1, h, 3, hd, generator=g, device="cuda").to(dtype)
        kc, vc = (torch.randn(b, s, h * hd, generator=g, device="cuda")
                  .to(dtype) for _ in range(2))
        fused_check(qkv[..., 0, :], kc, vc, qkv[..., 1, :], qkv[..., 2, :],
                    serve_pos, dn, B=b, S=s, H=h, hd=hd, pos="qkv_views")


def check_append(smoke):
    torch = smoke.torch
    from chainermn_tpu_torch.ops import cache_append, cache_append_plain

    g = torch.Generator(device="cuda").manual_seed(3)
    tick_pos = torch.tensor([0, 5, 511, 1023, 1024, 2000, 700, 64],
                            dtype=torch.int32, device="cuda")
    cases = [  # (label, B, S, W, rows, pos)
        ("tick", 8, 1024, 1024, 1, tick_pos),
        ("tick_scalar", 8, 1024, 1024, 1, 1500),
        ("prefill_slab", 1, 512, 1024, 512, 0),
        ("rows4_clamped", 8, 64, 1024, 4, torch.tensor(
            [0, 3, 60, 61, 62, 100, 7, 59], dtype=torch.int32,
            device="cuda")),
        ("odd_width", 3, 10, 1001, 3, torch.tensor(
            [0, 8, 50], dtype=torch.int32, device="cuda")),
        # TP = 2: a rank's 8 heads of 64 (the tick, the prefill slab), and
        # its 2 GQA KV heads of the beam (the prompt slab, a tick's 4 rows)
        ("tp2_tick", 8, 1024, 512, 1, tick_pos),
        ("tp2_prefill_slab", 1, 1024, 512, 512, 0),
        ("tp2_gqa_slab", 2, 128, 128, 128, 0),
        ("tp2_gqa_beam_rows", 2, 64, 128, 4, 8),
    ]
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).replace("torch.", "")
        for label, b, s, w, rows, pos in cases:
            kc = torch.randn(b, s, w, generator=g, device="cuda").to(dtype)
            vc = torch.randn(b, s, w, generator=g, device="cuda").to(dtype)
            kn = torch.randn(b, rows, w, generator=g, device="cuda").to(dtype)
            vn = torch.randn(b, rows, w, generator=g, device="cuda").to(dtype)
            k1, v1 = kc.clone(), vc.clone()
            k2, v2 = kc.clone(), vc.clone()
            cache_append(k1, v1, kn, vn, pos)
            cache_append_plain(k2, v2, kn, vn, pos)
            torch.cuda.synchronize()
            shape = dict(B=b, S=s, W=w, rows=rows, pos=label)
            err = max(smoke.compare("cache_append.k", k1, k2, dn, **shape),
                      smoke.compare("cache_append.v", v1, v2, dn, **shape))
            if err != 0.0:
                raise AssertionError(f"cache_append is a copy, err {err}")
            if not (label == "tick" and dtype == torch.bfloat16):
                continue
            ms = smoke.time_ms(lambda: cache_append(k1, v1, kn, vn, pos))
            plain = smoke.time_ms(
                lambda: cache_append_plain(k2, v2, kn, vn, pos), iters=5)
            bi = torch.arange(b, device="cuda")
            pl = pos.long().clamp(0, s - rows)

            def library():
                k2.index_put_((bi, pl), kn[:, 0])
                v2.index_put_((bi, pl), vn[:, 0])

            lib = smoke.time_ms(library)
            nbytes = 2 * 2 * b * rows * w * kc.element_size() + 4 * b
            bound, by = _bound(nbytes, 0.0, dn)
            smoke.kernel_rows["cache_append"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
                bound_by=by, library_ms=lib, shape=shape, dtype=dn)
            emit(dict(check="cache_append.time", max_abs_err=err,
                      atol=TOL[dn], kernel_ms=ms, plain_ms=plain,
                      library_ms=lib, bound_ms=bound, bound_by=by, **shape))


def _flash_bwd_bound(b, s, h, h_kv, d, causal, elem, dtype_name):
    """Five (S x S x d) products over the causal half; q, o, do, dq at H
    heads and k, v, dk, dv at H_kv moved once, plus lse and delta."""
    pairs = s * (s + 1) / 2 if causal else s * s
    flops = 5 * 2.0 * b * h * d * pairs
    nbytes = (4 * b * s * h * d + 4 * b * s * h_kv * d) * elem + 8.0 * b * h * s
    return _bound(nbytes, flops, dtype_name)


def check_flash_bwd(smoke):
    torch = smoke.torch
    import torch.nn.functional as F
    from chainermn_tpu_torch.ops import (flash_attention, flash_attention_bwd,
                                         flash_attention_bwd_plain,
                                         flash_attention_plain)

    g = torch.Generator(device="cuda").manual_seed(4)
    # through autograd: the output carries a grad_fn and its backward is
    # the kernel
    qkv = [torch.randn(2, 64, 4, 128, generator=g, device="cuda")
           for _ in range(3)]
    leaves = [x.clone().requires_grad_() for x in qkv]
    out = flash_attention(*leaves, causal=True)
    before = flash_attention_bwd.launches
    got = torch.autograd.grad(out, leaves, torch.ones_like(out))
    if out.grad_fn is None or flash_attention_bwd.launches != before + 1:
        raise AssertionError("flash_attention on CUDA is not differentiated "
                             "by the backward kernel")
    o_ref, lse_ref = flash_attention_plain(*qkv, causal=True)
    ref = flash_attention_bwd_plain(*qkv, o_ref, lse_ref,
                                    torch.ones_like(o_ref), True)
    for n, x, r in zip("qkv", got, ref):
        smoke.compare(f"flash_attention.grad.d{n}", x, r, "float32",
                      B=2, S=64, H=4, D=128, causal=True)
    cases = [  # (B, S, H, H_kv, D, causal, dlse, timed)
        (8, 1024, 8, 8, 128, True, False, True),   # the training step
        (8, 1024, 4, 4, 128, True, False, False),  # the step at TP = 2
        (2, 256, 8, 8, 64, True, False, False),    # head_dim 64
        (2, 256, 8, 4, 128, True, False, False),   # group 2
        (2, 77, 4, 4, 128, True, False, False),    # ragged tail
        (3, 77, 6, 2, 64, False, False, False),    # ragged, group 3
        (2, 128, 4, 4, 128, False, True, False),   # LSE cotangent
        (2, 200, 4, 2, 64, True, True, "misaligned"),
        (128, 197, 12, 12, 64, False, False, True),  # ViT-B/16 at 224
        (32, 197, 6, 6, 64, False, False, True),   # ViT-S/16 FSDP, a rank
        (2, 4096, 8, 8, 128, True, True, False),   # ring at SP = 2: diagonal
        (2, 4096, 8, 8, 128, False, True, False),  # ring: a whole block
        (2, 4096, 8, 4, 128, False, True, False),  # ring, GQA
        (2, 8192, 4, 4, 128, True, False, False),  # Ulysses at SP = 2
    ]
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).replace("torch.", "")
        for b, s, h, hkv, d, causal, with_dlse, timed in cases:
            q, do = (torch.randn(b, s, h, d, generator=g, device="cuda")
                     .to(dtype) for _ in range(2))
            k, v = (torch.randn(b, s, hkv, d, generator=g, device="cuda")
                    .to(dtype) for _ in range(2))
            dlse = (torch.randn(b, h, s, generator=g, device="cuda")
                    if with_dlse else None)
            out, lse = flash_attention_plain(q, k, v, causal)
            if timed == "misaligned":   # bases one element past 16 bytes
                q, k, out, do = (
                    torch.empty(x.numel() + 1, dtype=dtype, device="cuda")[1:]
                    .view(x.shape).copy_(x) for x in (q, k, out, do))
                assert q.data_ptr() % 16 and do.data_ptr() % 16
                timed = False
            got = flash_attention_bwd(q, k, v, out, lse, do, causal, dlse)
            ref = flash_attention_bwd_plain(q, k, v, out, lse, do, causal,
                                            dlse)
            torch.cuda.synchronize()
            shape = dict(B=b, S=s, H=h, H_kv=hkv, D=d, causal=causal,
                         dlse=with_dlse, aligned=q.data_ptr() % 16 == 0)
            err = max(smoke.compare(f"flash_bwd.d{n}", x, r, dn, **shape)
                      for n, x, r in zip("qkv", got, ref))
            del ref
            if not (timed and dtype == torch.bfloat16):
                continue
            ms = smoke.time_ms(lambda: flash_attention_bwd(
                q, k, v, out, lse, do, causal))
            plain = smoke.time_ms(lambda: flash_attention_bwd_plain(
                q, k, v, out, lse, do, causal), iters=5)
            qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                          for x in (q, k, v))
            ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
            dot = do.transpose(1, 2).contiguous()
            lib = smoke.time_ms(lambda: torch.autograd.grad(
                ot, (qt, kt, vt), dot, retain_graph=True))
            bound, by = _flash_bwd_bound(b, s, h, hkv, d, causal,
                                         q.element_size(), dn)
            if s == TRAIN_SEQ:               # the main-path row: training
                smoke.kernel_rows["flash_bwd"] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
                    bound_by=by, library_ms=lib, shape=shape, dtype=dn)
            emit(dict(check="flash_bwd.time", max_abs_err=err, atol=TOL[dn],
                      kernel_ms=ms, plain_ms=plain,
                      library_ms=lib, library="SDPA backward",
                      bound_ms=bound, bound_by=by, **shape))


def _ce_bounds(t, v, d, elem, dtype_name):
    """(bound_ms, bound_by) per CE kernel: h and the table read once, the
    (T,) rows in, the outputs out; 2·T·V·D FLOP for the logits and as many
    again for each gradient product (``ce_grads``: one logits pass, both
    products)."""
    ins = (t * d + v * d) * elem + 4.0 * t
    return {
        "ce_stats": _bound(ins + 12.0 * t, 2.0 * t * v * d, dtype_name),
        "ce_dh": _bound(ins + 8.0 * t + t * d * elem, 4.0 * t * v * d,
                        dtype_name),
        "ce_dtable": _bound(ins + 8.0 * t + v * d * elem, 4.0 * t * v * d,
                            dtype_name),
        "ce_grads": _bound(ins + 8.0 * t + (t + v) * d * elem,
                           6.0 * t * v * d, dtype_name),
    }


def _ce_inputs(torch, g, t, v, d, dtype):
    h = torch.randn(t, d, generator=g, device="cuda").to(dtype)
    tab = (torch.randn(v, d, generator=g, device="cuda")
           * (2.0 / d) ** 0.5 * 4).to(dtype)
    tgt = torch.randint(0, v, (t,), generator=g, device="cuda")
    edges = [-1, v, v + 100]                         # pick nothing
    # each bf16 gradient chunk's first column and the one before it, the
    # bf16 ce_stats' 256-wide V tile edges (255, 256, the last tile's first
    # column), V - 1
    from chainermn_tpu_torch.ops.fused_ce import _grad_plan

    bounds = _grad_plan(t, v, d, torch.bfloat16)["bounds"]
    edges += [x for v0, _ in bounds[1:] for x in (v0 - 1, v0)]
    edges += [x for x in (255, 256, (v - 1) // 256 * 256) if x < v] + [v - 1]
    edges = edges[:t]
    tgt[:len(edges)] = torch.tensor(edges)
    dnll = torch.rand(t, generator=g, device="cuda")
    return h, tab, tgt, dnll


def check_ce(smoke):
    torch = smoke.torch
    from chainermn_tpu_torch.ops import (ce_dh, ce_dh_plain, ce_dtable,
                                         ce_dtable_plain, ce_grads,
                                         ce_grads_plain, ce_stats,
                                         ce_stats_plain)
    from chainermn_tpu_torch.ops.fused_ce import _grad_plan

    g = torch.Generator(device="cuda").manual_seed(5)
    cases = [  # (T, V, D, timed); the bf16 gradients' V chunk follows T
        (TRAIN_BATCH * TRAIN_SEQ, TRAIN["vocab"], TRAIN["d_model"], True),
        # the step at TP = 2: a rank's V / 2 shard
        (TRAIN_BATCH * TRAIN_SEQ, TRAIN["vocab"] // 2, TRAIN["d_model"],
         False),
        (77, 301, 96, False),              # ragged T, V and D tiles
        (512, 32768, 1024, False),         # the train-parity shape
        # T not a multiple of 128, D = 200: chunks of 2048, 2048 and 77
        (8000, 2 * 2048 + 77, 200, False),
        # chunks of 1920 (a workspace row of 2048), 1920 and 77
        (8738, 2 * 1920 + 77, 64, False),
    ]
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).replace("torch.", "")
        for t, v, d, timed in cases:
            h, tab, tgt, dnll = _ce_inputs(torch, g, t, v, d, dtype)
            shape = dict(T=t, V=v, D=d,
                         chunk=_grad_plan(t, v, d, torch.bfloat16)["chunk"])
            got = ce_stats(h, tab, tgt)
            ref = ce_stats_plain(h, tab, tgt)
            torch.cuda.synchronize()
            errs = {"ce_stats": max(
                smoke.compare(f"ce_stats.{n}", x, r, dn, **shape)
                for n, x, r in zip(("m", "l", "picked"), got, ref))}
            lse = ref[0] + torch.log(ref[1])
            dh_ref, dt_ref = ce_grads_plain(h, tab, tgt, lse, dnll)
            errs["ce_dh"] = smoke.compare(
                "ce_dh", ce_dh(h, tab, tgt, lse, dnll), dh_ref, dn,
                scaled=True, **shape)
            errs["ce_dtable"] = smoke.compare(
                "ce_dtable", ce_dtable(h, tab, tgt, lse, dnll), dt_ref, dn,
                scaled=True, **shape)
            both = ce_grads(h, tab, tgt, lse, dnll)
            errs["ce_grads"] = max(
                smoke.compare(f"ce_grads.{n}", x, r, dn, scaled=True, **shape)
                for n, x, r in zip(("dh", "dtable"), both, (dh_ref, dt_ref)))
            del dh_ref, dt_ref, both
            if not (timed and dtype == torch.bfloat16):
                continue
            lib = {"ce_dh": lambda: torch.matmul(torch.softmax(
                       torch.matmul(h, tab.t()), -1), tab),
                   "ce_dtable": lambda: torch.matmul(torch.softmax(
                       torch.matmul(h, tab.t()), -1).t(), h)}
            kernels = {
                "ce_stats": (lambda: ce_stats(h, tab, tgt),
                             lambda: ce_stats_plain(h, tab, tgt),
                             lambda: torch.logsumexp(
                                 torch.matmul(h, tab.t()).float(), -1)),
                "ce_dh": (lambda: ce_dh(h, tab, tgt, lse, dnll),
                          lambda: ce_dh_plain(h, tab, tgt, lse, dnll),
                          lib["ce_dh"]),
                "ce_dtable": (lambda: ce_dtable(h, tab, tgt, lse, dnll),
                              lambda: ce_dtable_plain(h, tab, tgt, lse,
                                                      dnll),
                              lib["ce_dtable"]),
            }
            bounds = _ce_bounds(t, v, d, h.element_size(), dn)
            lib_ms = {}
            for name, (kern, plain_fn, lib_fn) in kernels.items():
                ms = smoke.time_ms(kern, iters=10)
                plain = smoke.time_ms(plain_fn, iters=3)
                lib_ms[name] = smoke.time_ms(lib_fn, iters=10)
                bound, by = bounds[name]
                smoke.kernel_rows[name] = dict(
                    max_abs_err=errs[name], ms=ms, plain_ms=plain,
                    bound_ms=bound, bound_by=by, library_ms=lib_ms[name],
                    shape=shape, dtype=dn)
                emit(dict(check=f"{name}.time", max_abs_err=errs[name],
                          atol=TOL[dn], kernel_ms=ms, plain_ms=plain,
                          library_ms=lib_ms[name], bound_ms=bound,
                          bound_by=by, **shape))
            # both gradients from one ds pass (the training step's call),
            # beside the two library calls it replaces; then its memory
            ms = smoke.time_ms(lambda: ce_grads(h, tab, tgt, lse, dnll),
                               iters=10)
            bound, by = bounds["ce_grads"]
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            ce_grads(h, tab, tgt, lse, dnll)
            torch.cuda.synchronize()
            extra = torch.cuda.max_memory_allocated() - before
            emit(dict(check="ce_grads.time", max_abs_err=errs["ce_grads"],
                      atol=TOL[dn], kernel_ms=ms,
                      library_ms=lib_ms["ce_dh"] + lib_ms["ce_dtable"],
                      library="softmax + matmul, dh and dtable",
                      bound_ms=bound, bound_by=by,
                      peak_extra_mib=extra / 2 ** 20,
                      outputs_mib=(h.numel() + tab.numel())
                      * h.element_size() / 2 ** 20, **shape))
    # bf16 at any D: the wrapper pads D to a multiple of 8 (TMA's 16-byte
    # row strides) in a copy, and a misaligned h or table is copied
    for d in (100, 4, 1026, 33):
        h, tab, tgt, dnll = _ce_inputs(torch, g, 64, 300, d, torch.bfloat16)
        shape = dict(T=64, V=300, D=d)
        ref = ce_stats_plain(h, tab, tgt)
        for n, x, r in zip(("m", "l", "picked"), ce_stats(h, tab, tgt), ref):
            smoke.compare(f"ce_stats.{n}.d_not_multiple_of_8", x, r,
                          "bfloat16", **shape)
        m, l, _ = ref
        lse = m + torch.log(l)
        dh_ref, dt_ref = ce_grads_plain(h, tab, tgt, lse, dnll)
        smoke.compare("ce_dh.d_not_multiple_of_8", ce_dh(h, tab, tgt, lse,
                                                         dnll),
                      dh_ref, "bfloat16", scaled=True, **shape)
        smoke.compare("ce_dtable.d_not_multiple_of_8",
                      ce_dtable(h, tab, tgt, lse, dnll), dt_ref, "bfloat16",
                      scaled=True, **shape)
        for n, x, r in zip(("dh", "dtable"), ce_grads(h, tab, tgt, lse, dnll),
                           (dh_ref, dt_ref)):
            smoke.compare(f"ce_grads.{n}.d_not_multiple_of_8", x, r,
                          "bfloat16", scaled=True, **shape)
    h, tab, tgt, dnll = _ce_inputs(torch, g, 64, 300, 128, torch.bfloat16)
    hs = torch.empty(64 * 128 + 1, dtype=torch.bfloat16,
                     device="cuda")[1:].view(64, 128)
    hs.copy_(h)                                  # a 2-byte misaligned base
    ref = ce_stats_plain(h, tab, tgt)
    for n, x, r in zip(("m", "l", "picked"), ce_stats(hs, tab, tgt), ref):
        smoke.compare(f"ce_stats.{n}.misaligned", x, r, "bfloat16", T=64,
                      V=300, D=128)
    m, l, _ = ref
    lse = m + torch.log(l)
    for n, x, r in zip(("dh", "dtable"), ce_grads(hs, tab, tgt, lse, dnll),
                       ce_grads_plain(h, tab, tgt, lse, dnll)):
        smoke.compare(f"ce_grads.{n}.misaligned", x, r, "bfloat16",
                      scaled=True, T=64, V=300, D=128)


def _beam_bound(b, r, d, n_read, mode, elem, dtype_name, h):
    """q read once, K and V of every position read once, the mask bytes,
    fp32 (acc, m, l) written; 2·R·D FLOP per position for the scores and
    as many for the values."""
    nbytes = (b * r * d * elem + 2.0 * n_read * d * elem
              + (r * n_read if mode == "amask" else 0.0)
              + 4.0 * b * r * (d + 2 * h))
    return _bound(nbytes, 4.0 * r * n_read * d, dtype_name)


def check_beam(smoke):
    """``beam_attend_parts`` against its plain version: the beam-4 tick's
    two segments at full width (the shared prompt, mode none; the
    generated window, a strided view of the slot caches, mode amask with
    one valid slot per (b, beam, t)), the GQA tick (B 8, 4 KV heads of
    64, g 4, S 1024, pos scalar / per-row / edge), the GQA beam at TP = 2
    (a rank's 2 KV heads, 16 rows: the prompt, the window), hd 128, S 1,
    a ragged S, 8 or 16 rows per cache row, and the S splits' edges: S one
    past a
    split multiple, pos on a split's last and on its first position, an
    amask with a split of no valid position beside valid ones."""
    torch = smoke.torch
    import torch.nn.functional as F
    from chainermn_tpu_torch.ops import beam_attend_parts, beam_attend_parts_plain
    from chainermn_tpu_torch.ops.decode_attention import beam_split_plan

    g = torch.Generator(device="cuda").manual_seed(9)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # the split edges: segments of B 2 x 4 heads split every `sl` positions
    sl = beam_split_plan(4 * 64, 2 * 4, sms)[0]
    edge_s = 4 * sl + 5
    assert beam_split_plan(edge_s, 2 * 4, sms) == (sl, 5)
    on_split = torch.tensor([sl - 1, 2 * sl], dtype=torch.int32,
                            device="cuda")

    def one_slot_mask(b, k, t_len):
        """Exactly one valid slot per (b, beam, t), rows t·k + slot."""
        slot = torch.randint(0, k, (b, k, t_len), generator=g, device="cuda")
        m = torch.zeros(b, k, t_len, k, dtype=torch.int8, device="cuda")
        m.scatter_(3, slot[..., None], 1)
        return m.reshape(b, k, t_len * k)

    edge = torch.tensor([0, 1, 100, 511, 777, 1022, 1023, 5000],
                        dtype=torch.int32, device="cuda")
    serve = torch.randint(512, 576, (8,), generator=g, device="cuda",
                          dtype=torch.int32)
    cases = [  # (label, B, S, H, hd, R, mode, pos, window, timed)
        ("beam_prompt", 8, 512, 16, 64, 4, "none", None, False, True),
        ("beam_window", 8, 2048, 16, 64, 4, "amask", None, True, True),
        ("gqa_scalar", 8, 1024, 4, 64, 4, "pos", 700, False, False),
        ("gqa_serve", 8, 1024, 4, 64, 4, "pos", serve, False, True),
        ("gqa_edge", 8, 1024, 4, 64, 4, "pos", edge, False, False),
        # the GQA beam 4 at TP = 2: a rank's 2 KV heads, g 4 x 4 beams
        ("tp2_gqa_prompt", 2, 128, 2, 64, 16, "none", None, False, False),
        ("tp2_gqa_window", 2, 60, 2, 64, 16, "amask", None, True, False),
        ("hd128", 2, 300, 8, 128, 4, "amask", None, True, False),
        ("s1", 3, 1, 4, 64, 2, "none", None, False, False),
        ("ragged", 2, 77, 4, 64, 3, "pos", torch.tensor(
            [10, 76], dtype=torch.int32, device="cuda"), False, False),
        ("rows8", 2, 96, 2, 128, 8, "amask", None, False, False),
        ("rows16", 2, 100, 2, 64, 16, "amask", None, True, False),
        # S one past a split multiple: the last split holds one position
        ("split_plus1", 2, 3 * sl + 1, 4, 64, 4, "none", None, False, False),
        # pos on the last position of a split, and on the first of one
        ("split_pos", 2, edge_s, 4, 64, 4, "pos", on_split, True, False),
        # a split whose amask rows are all 0, beside valid splits; row 0
        # valid at the last position only
        ("split_gap", 2, edge_s, 4, 128, 4, "amask", None, True, False),
    ]
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).replace("torch.", "")
        for label, b, s, h, hd, r, mode, pos, window, timed in cases:
            d = h * hd
            q = torch.randn(b * r, d, generator=g, device="cuda").to(dtype)
            rows = s + 64 if window else s
            kfull, vfull = (torch.randn(b, rows, d, generator=g,
                                        device="cuda").to(dtype)
                            for _ in range(2))
            kc, vc = kfull[:, :s], vfull[:, :s]    # strided when window
            amask = None
            if mode == "amask":
                if r == 4 and s % 4 == 0:
                    amask = one_slot_mask(b, 4, s // 4)
                else:
                    amask = (torch.rand(b, r, s, generator=g, device="cuda")
                             > 0.5).to(torch.int8)
                    amask[:, :, 0] = 1
                if label == "split_gap":
                    amask[:, :, sl:2 * sl] = 0
                    amask[:, 0] = 0
                    amask[:, 0, -1] = 1
            kw = dict(beams=r, n_heads=h, head_dim=hd)
            args = (q, kc, vc, amask, pos if mode == "pos" else None)
            got = beam_attend_parts(*args, **kw)
            ref = beam_attend_parts_plain(*args, **kw)
            torch.cuda.synchronize()
            shape = dict(B=b, S=s, H=h, hd=hd, R=r, mode=mode, case=label,
                         strided=not kc.is_contiguous())
            err = max(smoke.compare(f"beam_attend.{n}", x, y, dn, **shape)
                      for n, x, y in zip(("acc", "m", "l"), got, ref))
            if not (timed and dtype == torch.bfloat16):
                continue
            ms = smoke.time_ms(lambda: beam_attend_parts(*args, **kw))
            plain = smoke.time_ms(lambda: beam_attend_parts_plain(*args, **kw),
                                  iters=5)
            if mode == "pos":      # GQA: q heads grouped onto KV heads
                qt = q.view(b, r, h, hd).transpose(1, 2).reshape(
                    b, h * r, 1, hd)
                mask = (torch.arange(s, device="cuda")[None, :]
                        <= pos.long()[:, None])[:, None, None, :]
                n_read = float((pos.long().clamp(max=s - 1) + 1).sum())
                lib_kw = dict(attn_mask=mask, enable_gqa=True)
            else:                  # the beam rows as the query length
                qt = q.view(b, r, h, hd).transpose(1, 2)
                mask = None if amask is None else (amask > 0)[:, None]
                n_read = float(b * s)
                lib_kw = dict(attn_mask=mask)
            kt = kc.view(b, s, h, hd).transpose(1, 2)
            vt = vc.view(b, s, h, hd).transpose(1, 2)
            lib = smoke.time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, **lib_kw))
            bound, by = _beam_bound(b, r, d, n_read, mode, q.element_size(),
                                    dn, h)
            row = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
                       bound_by=by, library_ms=lib, shape=shape, dtype=dn)
            if label == "beam_window":
                smoke.kernel_rows["beam_attend"] = row
            emit(dict(check="beam_attend.time", max_abs_err=err,
                      atol=TOL[dn], kernel_ms=ms, plain_ms=plain,
                      library_ms=lib, library="SDPA", bound_ms=bound,
                      bound_by=by, **shape))


def _conv_bounds(n, h, w, ci, co, k, elem, dtype_name):
    """(bound_ms, bound_by) of wgrad and dgrad: 2·N·H·W·k²·Ci·Co FLOP each;
    wgrad reads x and dy once and writes dW, dgrad reads dy and W once and
    writes dX."""
    flops = 2.0 * n * h * w * k * k * ci * co
    pix = n * h * w
    return {
        "conv_wgrad": _bound((pix * (ci + co) + k * k * ci * co) * elem,
                             flops, dtype_name),
        "conv_dgrad": _bound((pix * (co + ci) + k * k * ci * co) * elem,
                             flops, dtype_name),
    }


def check_conv(smoke):
    """``conv3x3_wgrad`` / ``conv3x3_dgrad`` against their plain versions:
    ResNet-50's three eligible 3x3 shapes at batch 128, a ragged 7 x 5
    plane, a 196-row plane, n = 1, channel counts that are not multiples
    of 8, and NF-ResNet-50's ten 1x1 shapes at batch 128 (``NF_1X1``).
    Inputs are scaled so that the outputs are O(1), as a training step's
    gradients are small.  The 3x3 and the 1x1 shapes at batch 128 are
    timed in bf16 beside the plain version and cuDNN's
    ``convolution_backward`` asked for dW alone or dX alone.  Then bf16
    dgrad of a misaligned dY (the wrapper copies it for TMA)."""
    torch = smoke.torch
    from chainermn_tpu_torch.ops import (conv3x3_dgrad, conv3x3_dgrad_plain,
                                         conv3x3_wgrad, conv3x3_wgrad_plain)

    g = torch.Generator(device="cuda").manual_seed(10)
    cases = [  # (N, H, W, Ci, Co, k, timed)
        (128, 56, 56, 64, 64, 3, True),
        (128, 28, 28, 128, 128, 3, True),
        (128, 14, 14, 256, 256, 3, True),
        (2, 7, 5, 8, 8, 3, False),
        (4, 14, 14, 64, 64, 3, False),
        (1, 28, 28, 128, 128, 3, False),
        (3, 9, 11, 12, 20, 3, False),
        (2, 15, 13, 36, 44, 1, False),
    ] + [(128, hw, hw, ci, co, 1, True) for hw, ci, co in NF_1X1]
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).replace("torch.", "")
        for n, h, w, ci, co, k, timed in cases:
            x = torch.randn(n, h, w, ci, generator=g, device="cuda").to(dtype)
            dy = (torch.randn(n, h, w, co, generator=g, device="cuda")
                  / (n * h * w) ** 0.5).to(dtype)
            wt = (torch.randn(k, k, ci, co, generator=g, device="cuda")
                  / (k * k * co) ** 0.5).to(dtype)
            dys = (dy.float() * (n * h * w) ** 0.5).to(dtype)  # O(1) for dgrad
            shape = dict(N=n, H=h, W=w, Ci=ci, Co=co, k=k)
            errs = {
                "conv_wgrad": smoke.compare(
                    "conv_wgrad", conv3x3_wgrad(x, dy, 1, ksize=k),
                    conv3x3_wgrad_plain(x, dy, 1, k), dn, scaled=True,
                    **shape),
                "conv_dgrad": smoke.compare(
                    "conv_dgrad", conv3x3_dgrad(dys, wt, x.shape),
                    conv3x3_dgrad_plain(dys, wt, x.shape), dn, scaled=True,
                    **shape),
            }
            if not (timed and dtype == torch.bfloat16):
                continue
            pad = (k - 1) // 2
            xn, dyn = x.permute(0, 3, 1, 2), dys.permute(0, 3, 1, 2)
            wn = wt.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)

            def cudnn(mask):
                return lambda: torch.ops.aten.convolution_backward(
                    dyn, xn, wn, None, [1, 1], [pad, pad], [1, 1], False,
                    [0, 0], 1, mask)

            kernels = {
                "conv_wgrad": (lambda: conv3x3_wgrad(x, dys, 1, ksize=k),
                               lambda: conv3x3_wgrad_plain(x, dys, 1, k),
                               cudnn([False, True, False])),
                "conv_dgrad": (lambda: conv3x3_dgrad(dys, wt, x.shape),
                               lambda: conv3x3_dgrad_plain(dys, wt, x.shape),
                               cudnn([True, False, False])),
            }
            bounds = _conv_bounds(n, h, w, ci, co, k, x.element_size(), dn)
            for name, (kern, plain_fn, lib_fn) in kernels.items():
                ms = smoke.time_ms(kern)
                plain = smoke.time_ms(plain_fn, iters=5)
                lib = smoke.time_ms(lib_fn)
                bound, by = bounds[name]
                row = dict(max_abs_err=errs[name], ms=ms, plain_ms=plain,
                           bound_ms=bound, bound_by=by, library_ms=lib,
                           shape=shape, dtype=dn)
                if h == 56 and k == 3:
                    smoke.kernel_rows[name] = row
                emit(dict(check=f"{name}.time", max_abs_err=errs[name],
                          atol=TOL[dn], kernel_ms=ms, plain_ms=plain,
                          library_ms=lib, library="cuDNN convolution_backward",
                          bound_ms=bound, bound_by=by, **shape))
    # a dY 2 bytes past 16-byte alignment: the wrapper copies it for TMA
    n, h, w, ci, co = 2, 14, 14, 64, 64
    dy = torch.randn(n, h, w, co, generator=g, device="cuda").bfloat16()
    dym = torch.empty(dy.numel() + 1, dtype=torch.bfloat16,
                      device="cuda")[1:].view(dy.shape)
    dym.copy_(dy)
    wt = (torch.randn(3, 3, ci, co, generator=g, device="cuda")
          / (9 * co) ** 0.5).bfloat16()
    smoke.compare("conv_dgrad.misaligned",
                  conv3x3_dgrad(dym, wt, (n, h, w, ci)),
                  conv3x3_dgrad_plain(dy, wt, (n, h, w, ci)), "bfloat16",
                  scaled=True, N=n, H=h, W=w, Ci=ci, Co=co, k=3)


def phase_kernels(smoke):
    check_flash(smoke)
    check_decode(smoke)
    check_append(smoke)
    check_flash_bwd(smoke)
    check_ce(smoke)
    check_beam(smoke)
    check_conv(smoke)


def _init_full(torch, device, dtype, max_len, n_kv_heads=None):
    from chainermn_tpu_torch.parallel import init_tp_transformer_lm

    return init_tp_transformer_lm(torch.Generator().manual_seed(0),
                                  max_len=max_len, dtype=dtype, device=device,
                                  n_kv_heads=n_kv_heads, **FULL)


def _drive(eng, prompts, max_new, first_wave, stagger_every, sample=None):
    """Submit ``first_wave`` requests, then one more every
    ``stagger_every`` steps, and run until every request is finished.
    ``sample[i]`` holds request ``i``'s ``temperature``/``rng`` keywords."""
    def submit(i):
        return eng.submit(prompts[i], max_new, **(sample or {}).get(i, {}))

    handles = [submit(i) for i in range(first_wave)]
    steps = 0
    while len(handles) < len(prompts) or eng.scheduler.queue_depth \
            or eng.pool.busy_count:
        eng.step()
        steps += 1
        if len(handles) < len(prompts) and steps % stagger_every == 0:
            handles.append(submit(len(handles)))
    return handles, steps


def _half_sampled(n, seed, temperature=0.7):
    """Sampling keywords for the odd requests of ``n``: request ``i`` at
    ``temperature`` with the key ``fold_in(PRNGKey(seed), i)``."""
    from chainermn_tpu_torch import prng

    return {i: {"temperature": temperature,
                "rng": prng.fold_in(prng.PRNGKey(seed), i)}
            for i in range(1, n, 2)}


def phase_parity(smoke):
    """fp32 card-vs-CPU token parity: the full-width learned-position model
    (the slice's model) and a small RoPE model (the per-row rotation)
    through the serving engine; the full-width GQA model (4 KV heads) with
    half its requests sampled; beam-4, lazy and physical, at full width."""
    torch = smoke.torch
    from chainermn_tpu_torch.parallel import init_tp_transformer_lm

    s_p, max_new = 128, 16
    full = _init_full(torch, "cpu", torch.float32, s_p + max_new)
    _parity_case(smoke, "full_width_learned", full, HEAD_DIM, s_p, max_new)
    rope = init_tp_transformer_lm(torch.Generator().manual_seed(1), 512, 256,
                                  4, 2, pos_impl="rope", device="cpu")
    _parity_case(smoke, "small_rope", rope, 64, s_p, max_new)
    for lazy in (True, False):
        _beam_parity(smoke, full, s_p, max_new, lazy)
    del full
    gqa = _init_full(torch, "cpu", torch.float32, s_p + max_new,
                     n_kv_heads=GQA_KV_HEADS)
    _parity_case(smoke, "full_width_gqa_sampled", gqa, HEAD_DIM, s_p,
                 max_new, sample=_half_sampled(4, 7))
    del gqa
    _chunked_fill_parity(smoke)


CHUNK = dict(rows=4, total=1024, s_q=64, scalar=300,
             per_row=(0, 37, 512, 900))


def _chunked_fill_parity(smoke):
    """The chunked fill (``attn_block`` at ``s_q > 1`` and a nonzero write
    position): one full-width fp32 block, MHA and GQA (4 KV heads), a
    64-token chunk into a 1024-row cache of stale values at one scalar
    start and at four per-row starts, on the card against the CPU with
    the same inputs: the block's output and the chunk's cache rows within
    the fp32 tolerance, every other row untouched (the append kernel
    writes the slab at any position; one launch a call)."""
    torch = smoke.torch
    from chainermn_tpu_torch import ops
    from chainermn_tpu_torch.parallel import decode as tdec
    from chainermn_tpu_torch.parallel import init_tp_transformer_lm

    cfg = CHUNK
    d, n, total, s_q = FULL["d_model"], cfg["rows"], cfg["total"], cfg["s_q"]
    for kv_heads in (None, GQA_KV_HEADS):
        params = init_tp_transformer_lm(
            torch.Generator().manual_seed(5), max_len=total,
            dtype=torch.float32, device="cpu", n_kv_heads=kv_heads,
            **dict(FULL, n_layers=1))
        card = _tree_to(torch, params, "cuda")
        kv = (kv_heads or FULL["n_heads"]) * HEAD_DIM
        g = torch.Generator().manual_seed(8)
        x = torch.randn(n, s_q, d, generator=g)
        kc = torch.randn(n, total, kv, generator=g)
        vc = torch.randn(n, total, kv, generator=g)
        steps = torch.arange(s_q)
        for form in ("scalar", "per_row"):
            start = (torch.tensor(cfg["per_row"], dtype=torch.int32)
                     if form == "per_row" else cfg[form])
            pos = (start[:, None].long() + steps if form == "per_row"
                   else start + steps)
            outs = {}
            for dev, p in (("cpu", params), ("cuda", card)):
                _, attn_block, _, _ = tdec._decoder_core(p, HEAD_DIM)
                w = start.to(dev) if form == "per_row" else start
                ops.reset_launch_counts()
                got = attn_block(x.to(dev), p["blocks"][0],
                                 kc.clone().to(dev), vc.clone().to(dev),
                                 pos.to(dev), w, w)
                torch.cuda.synchronize()
                outs[dev] = [t.cpu() for t in got]
                launches = ops.launch_counts()["cache_append"]
            label = f"chunked_fill.{'gqa' if kv_heads else 'mha'}.{form}"
            info = dict(rows=n, s_q=s_q, total=total, start=str(cfg[form]))
            err = smoke.compare(label, outs["cuda"][0], outs["cpu"][0],
                                "float32", scaled=True, **info)
            # the chunk's rows hold K / V projected on each device (within
            # the tolerance); every other row is untouched (equal)
            rows = torch.zeros(n, total, dtype=torch.bool)
            rows[torch.arange(n)[:, None], pos] = True
            for i, kind in ((1, "k"), (2, "v")):
                err = max(err, smoke.compare(
                    f"{label}.{kind}_chunk", outs["cuda"][i][rows],
                    outs["cpu"][i][rows], "float32", scaled=True, **info))
            same = all(torch.equal(outs["cuda"][i][~rows],
                                   outs["cpu"][i][~rows]) for i in (1, 2))
            emit({"check": f"{label}.caches", "untouched_rows_equal": same,
                  "append_launches": launches, "max_abs_err": err})
            if not same or launches != 1:
                raise AssertionError(f"{label}: untouched rows equal {same}, "
                                     f"append launches {launches} (want 1)")
        del card


def _cpu_choice_values(params_cpu, head_dim, prompt, tokens, t, kw):
    """The CPU's values behind token ``t`` of a request: its logits, or
    for a sampled request the scored values ``logits / T + gumbel`` with
    the noise of that position."""
    import numpy as np
    import torch

    from chainermn_tpu_torch import prng
    from chainermn_tpu_torch.parallel.decode import lm_prefill

    ctx = np.concatenate([prompt, np.asarray(tokens[:t], np.int32)])
    with torch.inference_mode():
        h, _ = lm_prefill(params_cpu, torch.tensor(ctx[None], dtype=torch.long),
                          len(ctx), head_dim=head_dim)
        logits = h[0, -1].float() @ params_cpu["embed"].float().t()
    if not kw:
        return logits
    key = prng.fold_in(prng.fold_in(kw["rng"], len(ctx)), 0)
    temp = torch.tensor(kw["temperature"], dtype=torch.float32)
    return logits / temp + prng.gumbel(key, (1, logits.shape[0]))[0]


def _near_ties(label, card_rows, cpu_rows, cpu_values):
    """Token rows of the card against the CPU's: each equal, or first
    differing where the CPU's values of the two tokens lie within 1e-3 (a
    near-tie, after which the row is not compared).  ``cpu_values(i, t)``
    gives the CPU's value of every token at row ``i``'s first difference
    ``t`` (logits, or a sampled row's perturbed logits).  Returns the equal
    rows and the ``(row, step, gap)`` of each near-tie."""
    equal, near = 0, []
    for i, (a, c) in enumerate(zip(card_rows, cpu_rows)):
        a, c = [int(v) for v in a], [int(v) for v in c]
        if a == c:
            equal += 1
            continue
        t = next((j for j, (x, y) in enumerate(zip(a, c)) if x != y), None)
        if t is None:
            raise AssertionError(f"{label} row {i}: card {len(a)} tokens, "
                                 f"CPU {len(c)}")
        vals = cpu_values(i, t)
        gap = abs(float(vals[a[t]]) - float(vals[c[t]]))
        emit({"check": "parity.mismatch", "model": label, "row": i,
              "step": t, "card_token": a[t], "cpu_token": c[t],
              "cpu_value_gap": gap})
        if gap >= 1e-3:
            raise AssertionError(f"{label} row {i} step {t}: tokens {a[t]} "
                                 f"vs {c[t]} with CPU gap {gap} >= 1e-3: "
                                 f"card {a}, CPU {c}")
        near.append((i, t, gap))
    return equal, near


def _parity_case(smoke, label, params_cpu, head_dim, s_p, max_new,
                 sample=None):
    import numpy as np

    torch = smoke.torch
    from chainermn_tpu_torch.serving import ServingEngine

    n_req = 4
    vocab = params_cpu["embed"].shape[0]
    prompts = np.random.RandomState(5).randint(
        0, vocab, (n_req, s_p)).astype(np.int32)
    results = {}
    for dev in ("cuda", "cpu"):
        eng = ServingEngine(params_cpu, head_dim=head_dim, n_slots=4,
                            max_total=s_p + max_new, queue_capacity=8,
                            device=dev)
        handles, _ = _drive(eng, list(prompts), max_new, 2, 2, sample)
        results[dev] = [h.tokens for h in handles]
        if not all(h.status == "done" for h in handles):
            raise AssertionError(f"{label} {dev}: not every request done")
        eng.close()
    equal, near = _near_ties(
        label, results["cuda"], results["cpu"],
        lambda i, t: _cpu_choice_values(params_cpu, head_dim, prompts[i],
                                        results["cpu"][i], t,
                                        (sample or {}).get(i)))
    emit({"check": "parity", "model": label, "requests": n_req,
          "sampled": sorted(sample or {}), "equal": equal,
          "near_ties": len(near), "dtype": "float32"})


def _seq_logprob(torch, params_cpu, head_dim, prompt, toks):
    """The CPU's cumulative log-probability of ``toks`` after ``prompt``."""
    import numpy as np

    from chainermn_tpu_torch.parallel.decode import lm_prefill

    full = np.concatenate([prompt, np.asarray(toks, np.int32)])
    with torch.inference_mode():
        h, _ = lm_prefill(params_cpu, torch.tensor(full[None], dtype=torch.long),
                          len(full), head_dim=head_dim)
        logits = h[0, len(prompt) - 1:-1].float() @ \
            params_cpu["embed"].float().t()
        logp = torch.log_softmax(logits, -1)
    return float(logp.gather(1, torch.tensor(toks, dtype=torch.long)[:, None]
                             ).sum())


def _beam_parity(smoke, params_cpu, s_p, max_new, lazy):
    """Beam-4 at full width, card vs CPU: the best beams equal, or the
    card's scores within 1e-3 of the CPU's best under the CPU's model."""
    import numpy as np

    torch = smoke.torch
    from chainermn_tpu_torch.convert import tree_map
    from chainermn_tpu_torch.parallel import make_lm_beam_generator

    prompts = np.random.RandomState(10).randint(
        0, FULL["vocab"], (2, s_p)).astype(np.int32)
    gen = make_lm_beam_generator(head_dim=HEAD_DIM, max_new_tokens=max_new,
                                 beam_size=4, lazy_reorder=lazy)
    card = gen(tree_map(params_cpu, lambda t: t.to("cuda")), prompts).cpu()
    cpu = gen(params_cpu, prompts)
    label = "beam4_lazy" if lazy else "beam4_physical"
    near_ties = 0
    for i in range(prompts.shape[0]):
        a, c = card[i].tolist(), cpu[i].tolist()
        if a == c:
            continue
        la, lc = (_seq_logprob(torch, params_cpu, HEAD_DIM, prompts[i], x)
                  for x in (a, c))
        emit({"check": "parity.mismatch", "model": label, "row": i,
              "card_logprob": la, "cpu_logprob": lc})
        if abs(la - lc) >= 1e-3:
            raise AssertionError(f"{label} row {i}: card beam log-prob {la} "
                                 f"vs CPU {lc}")
        near_ties += 1
    emit({"check": "parity", "model": label, "rows": prompts.shape[0],
          "equal": prompts.shape[0] - near_ties, "near_ties": near_ties,
          "new_tokens": max_new, "prompt": s_p, "dtype": "float32"})


SERVE = dict(requests=16, prompt=512, new=64, max_total=1024, slots=8)


def _serve_run(smoke, label, params, seed, sample=None):
    """16 staggered requests (prompt 512, 64 new) through an 8-slot
    ServingEngine on the card, launch counts zeroed just before and read
    just after; every request must finish ``done`` with 64 tokens in the
    vocabulary.  Emits the run's line and returns ``(launches, ticks)``."""
    import numpy as np

    torch = smoke.torch
    from chainermn_tpu_torch import ops
    from chainermn_tpu_torch.serving import ServingEngine

    n_req, s_p, max_new = SERVE["requests"], SERVE["prompt"], SERVE["new"]
    prompts = np.random.RandomState(seed).randint(
        0, FULL["vocab"], (n_req, s_p)).astype(np.int32)
    eng = ServingEngine(params, head_dim=HEAD_DIM, n_slots=SERVE["slots"],
                        max_total=SERVE["max_total"], queue_capacity=n_req,
                        device="cuda")
    prefill_ms, tick_ms = [], []

    def timed(fn, sink):
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)          # ends in a device-to-host read
            sink.append((time.perf_counter() - t0) * 1e3)
            return out
        return wrapper

    eng.engine.prefill_into_slot = timed(eng.engine.prefill_into_slot,
                                         prefill_ms)
    eng.engine.tick = timed(eng.engine.tick, tick_ms)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    handles, steps = _drive(eng, list(prompts), max_new, SERVE["slots"], 2,
                           sample)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    smoke.add_launches(launches)
    done = sum(h.status == "done" for h in handles)
    m = eng.metrics()
    n_tok = sum(len(h.tokens) for h in handles)
    # the prefix cache is on (JAX's default), but these random prompts
    # share no two-token prefix: no hit, so the launch counts stay
    if m["serving/prefix/hits"] or m["serving/spill/restores"]:
        raise AssertionError(f"{label}: prefix hits or restores on random "
                             f"prompts: {m}")
    emit({"check": label, "dtype": "bfloat16", "requests": n_req,
          "prefix_hits": m["serving/prefix/hits"],
          "spills": m["serving/spill/spills"],
          "sampled": sorted(sample or {}), "done": done, "steps": steps,
          "wall_s": wall, "tokens": n_tok, "tokens_per_s": n_tok / wall,
          "ms_per_token": wall * 1e3 / n_tok,
          "prefill_ms_mean": sum(prefill_ms) / len(prefill_ms),
          "prefill_ms_p50": _percentile(prefill_ms, 0.5),
          "tick_ms_p50": _percentile(tick_ms, 0.5),
          "tick_ms_p99": _percentile(tick_ms, 0.99),
          "ticks": len(tick_ms), "launches": launches,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
          "metrics": m})
    eng.close()
    if done != n_req:
        raise AssertionError(f"{label}: {done}/{n_req} requests finished done")
    for h in handles:
        if len(h.tokens) != max_new or not all(
                0 <= t < FULL["vocab"] for t in h.tokens):
            raise AssertionError(f"{label} request {h.id}: bad tokens "
                                 f"{h.tokens[:8]}")
    return launches, len(tick_ms)


def phase_serving(smoke):
    import numpy as np

    torch = smoke.torch
    from chainermn_tpu_torch import ops
    from chainermn_tpu_torch.parallel import make_lm_generator

    s_p, max_new = SERVE["prompt"], SERVE["new"]
    params = _init_full(torch, "cuda", torch.bfloat16, SERVE["max_total"])
    launches, ticks = _serve_run(smoke, "serving", params, 6)
    # a tick: one decode launch a layer, its K/V append folded in; the
    # append kernel runs only in the prefills (one slab write a layer)
    n_layers = FULL["n_layers"]
    want = {"decode_attend": n_layers * ticks,
            "cache_append": n_layers * SERVE["requests"],
            "flash_fwd": n_layers * SERVE["requests"], "beam_attend": 0}
    wrong = {n: (launches[n], w) for n, w in want.items() if launches[n] != w}
    if wrong:
        raise AssertionError(f"serving launches (got, want): {wrong}")

    gen = make_lm_generator(head_dim=HEAD_DIM, max_new_tokens=max_new)
    batch = np.random.RandomState(7).randint(
        0, FULL["vocab"], (8, s_p)).astype(np.int32)
    gen(params, batch[:, :16])  # warm-up
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = gen(params, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    if tuple(toks.shape) != (8, max_new):
        raise AssertionError(f"lm_generate shape {tuple(toks.shape)}")
    emit({"check": "lm_generate", "dtype": "bfloat16", "B": 8, "prompt": s_p,
          "new_tokens": max_new, "wall_s": wall,
          "tokens_per_s": 8 * max_new / wall,
          "ms_per_token_step": wall * 1e3 / max_new, "launches": launches})
    want = {"decode_attend": n_layers * (max_new - 1),
            "cache_append": n_layers, "flash_fwd": n_layers}
    wrong = {n: (launches[n], w) for n, w in want.items() if launches[n] != w}
    if wrong:
        raise AssertionError(f"lm_generate launches (got, want): {wrong}")


def phase_beam(smoke):
    """bf16 at ``bench_decode``'s full width: beam 4 with the lazy reorder
    (B 8, prompt 512, 512 new tokens), and beside it the prefill alone and
    the greedy ``lm_generate`` of the same size, for ``bench_decode``'s
    decode rates (a run's wall less the prefill's, per new token)."""
    import numpy as np

    torch = smoke.torch
    from chainermn_tpu_torch import ops
    from chainermn_tpu_torch.parallel import (make_lm_beam_generator,
                                              make_lm_generator)

    b, s_p, new, k = (BEAM[x] for x in ("batch", "prompt", "new",
                                        "beam_size"))
    n_layers = FULL["n_layers"]
    params = _init_full(torch, "cuda", torch.bfloat16, s_p + new)
    prompt = np.random.RandomState(0).randint(
        0, FULL["vocab"], (b, s_p)).astype(np.int32)
    make_lm_beam_generator(head_dim=HEAD_DIM, max_new_tokens=4, beam_size=k)(
        params, prompt[:, :16])   # warm-up

    def run(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(params, prompt)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    _, prefill_s = run(make_lm_generator(head_dim=HEAD_DIM, max_new_tokens=1))
    greedy, greedy_s = run(make_lm_generator(head_dim=HEAD_DIM,
                                             max_new_tokens=new))
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    toks, beam_s = run(make_lm_beam_generator(
        head_dim=HEAD_DIM, max_new_tokens=new, beam_size=k,
        lazy_reorder=True))
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    smoke.add_launches(launches)
    greedy_dec, beam_dec = greedy_s - prefill_s, beam_s - prefill_s
    emit({"check": "beam", "dtype": "bfloat16", **BEAM, **FULL,
          "lazy_reorder": True, "prefill_ms": prefill_s * 1e3,
          "beam_wall_s": beam_s, "greedy_wall_s": greedy_s,
          "beam4_tokens_per_s": b * new / beam_dec,
          "beam4_ms_per_token": beam_dec * 1e3 / new,
          "greedy_tokens_per_s": b * new / greedy_dec,
          "greedy_ms_per_token": greedy_dec * 1e3 / new,
          "beam_over_greedy_tokens_per_s": greedy_dec / beam_dec,
          "peak_mem_gb": peak, "launches": launches,
          "best_beam_equals_greedy_rows": int(
              (toks.cpu() == greedy.cpu()).all(1).sum())})
    if tuple(toks.shape) != (b, new) or not bool(
            ((toks >= 0) & (toks < FULL["vocab"])).all()):
        raise AssertionError(f"beam tokens: shape {tuple(toks.shape)} or "
                             f"out of the vocabulary")
    # per tick: two segments per layer through the beam kernel, one append
    # per layer; the prefill appends once per layer and runs flash forward
    want = {"beam_attend": 2 * n_layers * (new - 1),
            "cache_append": n_layers * (new - 1) + n_layers,
            "flash_fwd": n_layers, "decode_attend": 0}
    wrong = {n: (launches[n], w) for n, w in want.items() if launches[n] != w}
    if wrong:
        raise AssertionError(f"beam launches (got, want): {wrong}")


def phase_serving_gqa(smoke):
    """bf16, the GQA model (4 KV heads, g 4): 16 requests through the
    ServingEngine, the odd half sampled at temperature 0.7; the beam
    kernel must run every layer of every tick."""
    torch = smoke.torch

    params = _init_full(torch, "cuda", torch.bfloat16, SERVE["max_total"],
                        n_kv_heads=GQA_KV_HEADS)
    launches, ticks = _serve_run(smoke, "serving_gqa", params, 11,
                                 _half_sampled(SERVE["requests"], 12))
    want = {"beam_attend": FULL["n_layers"] * ticks, "decode_attend": 0}
    wrong = {n: (launches[n], w) for n, w in want.items() if launches[n] != w}
    if wrong or not launches["cache_append"] or not launches["flash_fwd"]:
        raise AssertionError(f"GQA serving launches (got, want): {wrong}; "
                             f"{launches}")


PREFIX_SERVE = dict(prefix=448, suffix=64, new=64, requests=16,
                    waves=(1, 7, 7, 1), max_total=1024, slots=8)
PREFIX_SPILL = dict(prompt=512, shared=480, new=16, slots=2)
PREFIX_ROUTER = dict(prefix=448, suffix=64, new=16, slots=4, queue=2)
PREFIX_PARITY = dict(n_layers=2, new=16)


def _prefix_prompts(seed, n, prefix, suffix, vocab):
    """``n`` prompts of one common ``prefix``-token system prompt plus a
    distinct ``suffix``-token tail each (their first tokens differ, so no
    two share more than the system prompt)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    system = rng.randint(0, vocab, prefix)
    firsts = rng.choice(vocab, n, replace=False)
    return [np.concatenate([system, [firsts[i]],
                            rng.randint(0, vocab, suffix - 1)]
                           ).astype(np.int32) for i in range(n)]


def _waves(eng, prompts, new, waves):
    """Submit the prompts in ``waves``, each run to idle before the next:
    the first request alone, then waves no larger than the free slots
    beside the cached one."""
    handles, i = [], 0
    for w in waves:
        handles += [eng.submit(p, new) for p in prompts[i:i + w]]
        i += w
        eng.run()
    return handles


def _timed_calls(torch, obj, names, sync=False):
    """Wrap ``obj``'s methods ``names``: each call's wall ms (after a device
    sync where ``sync``) lands in the returned lists."""
    out = {n: [] for n in names}
    for n in names:
        fn = getattr(obj, n)

        def wrapper(*a, _fn=fn, _sink=out[n], **k):
            t0 = time.perf_counter()
            res = _fn(*a, **k)
            if sync:
                torch.cuda.synchronize()
            _sink.append((time.perf_counter() - t0) * 1e3)
            return res

        setattr(obj, n, wrapper)
    return out


def _prefix_leg_shared(smoke, params):
    """bf16, full width: the 16-request shared-system-prompt schedule with
    the prefix cache off (every request prefills), then on (one prefill,
    15 prefix copies), launch counts zeroed just before the cache-on run
    and read just after."""
    torch = smoke.torch
    from chainermn_tpu_torch import ops
    from chainermn_tpu_torch.serving import ServingEngine

    cfg = PREFIX_SERVE
    n_layers = FULL["n_layers"]
    prompts = _prefix_prompts(21, cfg["requests"], cfg["prefix"],
                              cfg["suffix"], FULL["vocab"])
    rows = {}
    for cache in (False, True):
        eng = ServingEngine(params, head_dim=HEAD_DIM, n_slots=cfg["slots"],
                            max_total=cfg["max_total"],
                            queue_capacity=cfg["requests"],
                            prefix_cache=cache, spill_bytes=0,
                            device="cuda")
        times = _timed_calls(torch, eng.engine,
                             ("tick", "prefill_into_slot"))
        times.update(_timed_calls(torch, eng.engine, ("copy_prefix",),
                                  sync=True))
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        handles = _waves(eng, prompts, cfg["new"], cfg["waves"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        m = eng.metrics()
        ticks = len(times["tick"])
        hit = [h.ttft_ms for h in handles if h._req.prefix_len > 0]
        miss = [h.ttft_ms for h in handles if h._req.prefix_len == 0]
        n_tok = sum(len(h.tokens) for h in handles)
        row = {"check": "serving_prefix.shared", "prefix_cache": cache,
               "dtype": "bfloat16", "requests": len(handles),
               "waves": list(cfg["waves"]), "prompt": cfg["prefix"]
               + cfg["suffix"], "shared": cfg["prefix"], "new": cfg["new"],
               "done": sum(h.status == "done" for h in handles),
               "wall_s": wall, "tokens": n_tok, "tokens_per_s": n_tok / wall,
               "ticks": ticks, "tick_ms_p50": _percentile(times["tick"], 0.5),
               "tick_ms_p99": _percentile(times["tick"], 0.99),
               "prefill_ms_p50": (_percentile(times["prefill_into_slot"], 0.5)
                                  if times["prefill_into_slot"] else None),
               "prefix_copy_ms_p50": (_percentile(times["copy_prefix"], 0.5)
                                      if times["copy_prefix"] else None),
               "hits": len(hit), "misses": len(miss),
               "ttft_hit_ms_p50": _percentile(hit, 0.5) if hit else None,
               "ttft_hit_ms_p99": _percentile(hit, 0.99) if hit else None,
               "ttft_miss_ms_p50": _percentile(miss, 0.5) if miss else None,
               "ttft_miss_ms_p99": _percentile(miss, 0.99) if miss else None,
               "prefix_copies": eng.engine.prefix_copies,
               "prefill_calls": eng.engine.prefill_calls,
               "launches": launches,
               "prefix_metrics": {k: v for k, v in m.items()
                                  if k.startswith("serving/prefix/")}}
        emit(row)
        eng.close()
        if row["done"] != cfg["requests"]:
            raise AssertionError(f"serving_prefix.shared cache={cache}: "
                                 f"{row['done']} of {cfg['requests']} done")
        # the schedule: without the cache every request prefills; with it
        # only the first does, and every later one copies a cached slot
        n_miss = 1 if cache else cfg["requests"]
        want = {"flash_fwd": n_layers * n_miss,
                "cache_append": n_layers * n_miss,
                "decode_attend": n_layers * ticks, "beam_attend": 0}
        wrong = {n: (launches[n], w) for n, w in want.items()
                 if launches[n] != w}
        counts = (row["prefix_copies"], row["prefill_calls"],
                  m.get("serving/prefix/hits", 0.0))
        want_counts = ((cfg["requests"] - 1, 1, cfg["requests"] - 1)
                       if cache else (0, cfg["requests"], 0.0))
        if wrong or counts != want_counts:
            raise AssertionError(f"serving_prefix.shared cache={cache}: "
                                 f"launches (got, want) {wrong}; copies, "
                                 f"prefills, hits {counts} vs {want_counts}")
        if cache:
            smoke.add_launches(launches)
        rows[cache] = [h.tokens for h in handles]
    return rows


def _prefix_leg_spill(smoke, params, corrupt):
    """bf16, full width, 2 slots, a spill budget of two slabs: requests A,
    B, C with distinct prompts (C's admission scavenges A's donation into
    the spill tier), then D, sharing A's first ``shared`` tokens: a device
    miss that restores A's slab (or, with A's payload corrupted by one
    bit, is refused and prefills)."""
    import pickle

    import numpy as np

    torch = smoke.torch
    from chainermn_tpu_torch.serving import ServingEngine
    from chainermn_tpu_torch.serving.transfer import slab_nbytes

    cfg = PREFIX_SPILL
    rng = np.random.RandomState(31)
    vocab = FULL["vocab"]
    prompts = [rng.randint(0, vocab, cfg["prompt"]).astype(np.int32)
               for _ in range(3)]
    tail = rng.randint(0, vocab, cfg["prompt"] - cfg["shared"])
    tail[0] = (prompts[0][cfg["shared"]] + 1) % vocab
    prompts.append(np.concatenate([prompts[0][:cfg["shared"]], tail]
                                  ).astype(np.int32))
    length = cfg["prompt"] + cfg["new"] - 1        # a donation's rows
    slab = slab_nbytes(FULL["n_layers"], length, FULL["d_model"], "bfloat16")
    budget = 2 * (slab + (1 << 16))                # two payloads
    eng = ServingEngine(params, head_dim=HEAD_DIM, n_slots=cfg["slots"],
                        max_total=cfg["prompt"] + cfg["new"],
                        queue_capacity=4, spill_bytes=budget, device="cuda")
    times = _timed_calls(torch, eng._spill_plane, ("pack",))
    restore = eng.engine.restore
    landed = []

    def checked_restore(payload, slot, seq, n):
        t0 = time.perf_counter()
        restore(payload, slot, seq, n)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        rows = pickle.loads(payload)["rows"]
        same = all(
            k[slot, :n].view(torch.int16).cpu().numpy().tobytes()
            == np.ascontiguousarray(kr[:n]).tobytes()
            and v[slot, :n].view(torch.int16).cpu().numpy().tobytes()
            == np.ascontiguousarray(vr[:n]).tobytes()
            for (k, v), (kr, vr) in zip(eng.pool.caches, rows))
        landed.append({"ms": ms, "rows": n, "byte_equal": same})

    eng.engine.restore = checked_restore
    handles = []
    for i, p in enumerate(prompts):
        if i == 3 and corrupt:
            seq = next(s for s, _ in eng.spill.entries()
                       if s[:cfg["shared"]] == tuple(prompts[0][:cfg["shared"]]))
            data = pickle.loads(eng.spill.get(seq))
            k, v = data["rows"][0]
            k = np.array(k, copy=True)
            k.view(np.uint8).flat[0] ^= 1
            data["rows"][0] = (k, v)
            eng.spill.put(seq, len(seq), pickle.dumps(data))
        handles.append(eng.submit(p, cfg["new"]))
        eng.run()
    sp = eng.spill.stats()
    row = {"check": "serving_prefix.spill", "corrupt": corrupt,
           "dtype": "bfloat16", "slots": cfg["slots"], "prompt": cfg["prompt"],
           "shared": cfg["shared"], "new": cfg["new"],
           "slab_bytes": slab, "budget_bytes": budget,
           "done": sum(h.status == "done" for h in handles),
           "pack_ms": times["pack"], "restores": landed,
           "prefill_calls": eng.engine.prefill_calls,
           "spill": sp}
    emit(row)
    eng.close()
    if row["done"] != len(prompts):
        raise AssertionError(f"serving_prefix.spill: {row}")
    if corrupt:
        ok = (sp["crc_refusals"] == 1 and sp["restores"] == 0
              and row["prefill_calls"] == 4)
    else:
        ok = (sp["restores"] >= 1 and landed and all(
            r["byte_equal"] for r in landed) and row["prefill_calls"] == 3)
    if not ok:
        raise AssertionError(f"serving_prefix.spill corrupt={corrupt}: "
                             f"{row}")


def _prefix_leg_router(smoke, params):
    """``build_fleet(params, 2)``: two engines on the one card.  Families
    X and Y alternate, each drained before the next: X lands on replica0,
    Y on replica1 (the tie's round-robin), and every later request of a
    family on its replica by affinity (2 hits each).  Then a burst with
    no step fills both queues, and the next submit is refused
    ``queue_full`` with ``retry_after_ms`` and ``queue_depth``."""
    import numpy as np

    from chainermn_tpu_torch.serving import AdmissionError, build_fleet

    cfg = PREFIX_ROUTER
    fams = [_prefix_prompts(41 + f, 4, cfg["prefix"], cfg["suffix"],
                            FULL["vocab"]) for f in range(2)]
    router = build_fleet(params, 2, head_dim=HEAD_DIM, n_slots=cfg["slots"],
                         max_total=cfg["prefix"] + cfg["suffix"] + cfg["new"],
                         queue_capacity=cfg["queue"], device="cuda")
    went = []
    for i in range(6):
        before = dict(router._dispatched_by)
        h = router.submit(fams[i % 2][i // 2], cfg["new"])
        went.append(next(k for k, v in router._dispatched_by.items()
                         if v != before[k]))
        router.run()
        if h.status != "done":
            raise AssertionError(f"router request {i}: {h.status}")
    hits = [int(r.engine.metrics()["serving/prefix/hits"])
            for r in router.replicas]
    affinity = router.metrics()["router/affinity_dispatches_total"]
    burst, rejected = [], None
    for i in range(2 * cfg["queue"] + 1):
        try:
            burst.append(router.submit(fams[i % 2][3], cfg["new"]))
        except AdmissionError as e:
            rejected = e.to_dict()
    router.run()
    row = {"check": "serving_prefix.router", "replicas": 2, "went": went,
           "hits": hits, "affinity_dispatches": affinity,
           "burst_done": sum(h.status == "done" for h in burst),
           "rejection": rejected,
           "rejected": router.rejection_counters()}
    emit(row)
    router.close()
    want_went = ["replica0", "replica1"] * 3
    if (went != want_went or hits != [2, 2] or affinity != 4.0
            or rejected is None or rejected["reason"] != "queue_full"
            or rejected.get("retry_after_ms", 0) < 1.0
            or rejected.get("queue_depth") != 2 * cfg["queue"]
            or row["burst_done"] != 2 * cfg["queue"]):
        raise AssertionError(f"serving_prefix.router: {row}")


def _prefix_leg_parity(smoke):
    """fp32 at a reduced depth (2 layers, the full width otherwise): the
    shared-prefix schedule and the spill schedule with the cache on and
    off, on the card and on the CPU; each card row equals the CPU's (the
    same cache setting, and the cache-off one), or first differs at a
    CPU near-tie < 1e-3."""
    import numpy as np

    torch = smoke.torch
    from chainermn_tpu_torch.parallel import init_tp_transformer_lm
    from chainermn_tpu_torch.serving import ServingEngine

    cfg = PREFIX_PARITY
    shape = dict(FULL, n_layers=cfg["n_layers"])
    max_total, s_p, shared_len = (PREFIX_SERVE["max_total"],
                                  PREFIX_SPILL["prompt"],
                                  PREFIX_SPILL["shared"])
    params = init_tp_transformer_lm(torch.Generator().manual_seed(3),
                                    max_len=max_total, dtype=torch.float32,
                                    device="cpu", **shape)
    shared = _prefix_prompts(51, 8, PREFIX_SERVE["prefix"],
                             PREFIX_SERVE["suffix"], FULL["vocab"])
    rng = np.random.RandomState(52)
    spill = [rng.randint(0, FULL["vocab"], s_p).astype(np.int32)
             for _ in range(3)]
    spill.append(np.concatenate([spill[0][:shared_len], rng.randint(
        0, FULL["vocab"], s_p - shared_len)]).astype(np.int32))
    schedules = {
        "shared": (shared, dict(n_slots=8, max_total=max_total,
                                spill_bytes=0), (1, 7)),
        "spill": (spill, dict(n_slots=2, max_total=s_p + cfg["new"],
                              spill_bytes=64 << 20), (1, 1, 1, 1))}
    for name, (prompts, kw, waves) in schedules.items():
        rows = {}
        for dev in ("cuda", "cpu"):
            for cache in (True, False):
                eng = ServingEngine(params, head_dim=HEAD_DIM,
                                    queue_capacity=8, prefix_cache=cache,
                                    device=dev, **kw)
                handles = _waves(eng, prompts, cfg["new"], waves)
                if not all(h.status == "done" for h in handles):
                    raise AssertionError(f"prefix parity {name} {dev}")
                rows[dev, cache] = [h.tokens for h in handles]
                if cache:
                    m = eng.metrics()
                    rows[dev, "hits"] = (m["serving/prefix/hits"],
                                         m.get("serving/spill/restores"))
                eng.close()
        result = {"check": "serving_prefix.parity", "schedule": name,
                  "dtype": "float32", "n_layers": cfg["n_layers"],
                  "hits_restores": rows["cuda", "hits"]}
        for card_cache, cpu_cache in ((True, True), (False, False),
                                      (True, False)):
            label = f"prefix_{name}_card{int(card_cache)}_cpu{int(cpu_cache)}"
            equal, near = _near_ties(
                label, rows["cuda", card_cache], rows["cpu", cpu_cache],
                lambda i, t, c=cpu_cache: _cpu_choice_values(
                    params, HEAD_DIM, prompts[i], rows["cpu", c][i], t,
                    None))
            result[label] = {"equal": equal, "near_ties": len(near)}
        emit(result)
        if rows["cuda", "hits"] != rows["cpu", "hits"]:
            raise AssertionError(f"prefix parity {name}: hits / restores "
                                 f"card {rows['cuda', 'hits']} vs CPU "
                                 f"{rows['cpu', 'hits']}")


def phase_serving_prefix(smoke):
    """The prefix cache with copy-on-extend, the spill tier and the
    router at the decode-bench LM's full width (bf16), then fp32 parity
    at 2 layers."""
    torch = smoke.torch

    params = _init_full(torch, "cuda", torch.bfloat16,
                        PREFIX_SERVE["max_total"])
    _prefix_leg_shared(smoke, params)
    for corrupt in (False, True):
        _prefix_leg_spill(smoke, params, corrupt)
    _prefix_leg_router(smoke, params)
    del params
    torch.cuda.empty_cache()
    _prefix_leg_parity(smoke)


DISAGG = dict(requests=16, prompt=512, new=64, max_total=1024, slots=8,
              staging=2)
DISAGG_GQA = dict(requests=8, new=16)
DISAGG_PARITY = dict(n_layers=2, requests=8, prompt=256, new=16, slots=4)


def _disagg_prompts(seed, n, s_p):
    import numpy as np

    return list(np.random.RandomState(seed).randint(
        0, FULL["vocab"], (n, s_p)).astype(np.int32))


def _drive_all(service, prompts, new, threads):
    """Submit every prompt at once and serve them: under ``run()`` (one
    thread, deterministic), or ``start()`` / ``stop()`` (the service's
    driver threads).  Returns the handles and the wall seconds."""
    t0 = time.perf_counter()
    if threads:
        service.start()
    try:
        handles = [service.submit(p, new) for p in prompts]
        if threads:
            for h in handles:
                if not h.wait(timeout=300):
                    raise AssertionError(f"request {h.id} not finished in "
                                         f"300 s: {h.status}")
        else:
            service.run()
    finally:
        if threads:
            service.stop()
    return handles, time.perf_counter() - t0


def _card_choice_values(params, prompt, tokens, t):
    """The card's logits (fp32 upcast of the model's dtype) behind token
    ``t`` of a greedy request."""
    import numpy as np
    import torch

    from chainermn_tpu_torch.parallel.decode import lm_prefill

    ctx = np.concatenate([prompt, np.asarray(tokens[:t], np.int32)])
    dev = params["embed"].device
    with torch.inference_mode():
        h, _ = lm_prefill(params, torch.tensor(ctx[None], dtype=torch.long,
                                               device=dev),
                          len(ctx), head_dim=HEAD_DIM)
        return (h[0, -1].float() @ params["embed"].float().t()).cpu()


def _disagg_fleet(params, transport, staging, slots, max_total, dev):
    from chainermn_tpu_torch.serving import build_disagg_fleet

    return build_disagg_fleet(params, 1, 1, head_dim=HEAD_DIM,
                              max_total=max_total, n_slots=slots,
                              staging_slots=staging, queue_capacity=32,
                              transport_mode=transport, device=dev)


def _disagg_check_roles(label, fleet, n_req):
    """transfers, the role split and every allocator drained."""
    m = fleet.metrics()
    pw, dw = fleet.prefill_workers[0], fleet.decode_workers[0]
    bad = []
    if m["disagg/transfers_total"] != n_req:
        bad.append(f"transfers {m['disagg/transfers_total']}, want {n_req}")
    if dw.engine.engine.prefill_calls or pw.engine.tick_calls:
        bad.append(f"role split: decode prefills "
                   f"{dw.engine.engine.prefill_calls}, prefill ticks "
                   f"{pw.engine.tick_calls}")
    for alloc in (pw.pool.allocator, dw.engine.pool.allocator):
        alloc.check_invariants()
        if alloc.busy_count or alloc.reserved_count:
            bad.append(f"allocator not drained: busy {alloc.busy_count}, "
                       f"reserved {alloc.reserved_count}")
    if dw.inbox:
        bad.append(f"{len(dw.inbox)} transfers left in the inbox")
    if bad:
        raise AssertionError(f"{label}: " + "; ".join(bad))
    return m


def _disagg_leg_bf16(smoke, params):
    """bf16, the decode-bench width: the fused engine (cache and spill
    off) and the 1:1 fleet over each transport take the same 16 requests,
    each once under ``run()`` (tokens and launch counts) and once under
    ``start()`` / ``stop()`` (times)."""
    torch = smoke.torch
    from chainermn_tpu_torch import ops
    from chainermn_tpu_torch.serving import ServingEngine
    from chainermn_tpu_torch.serving.transfer import slab_nbytes

    cfg = DISAGG
    n_layers = FULL["n_layers"]
    prompts = _disagg_prompts(61, cfg["requests"], cfg["prompt"])
    slab = slab_nbytes(n_layers, cfg["prompt"], FULL["d_model"], "bfloat16")
    # first use of the shapes (the library loads, the allocator's pools)
    # outside the measured runs
    warm = ServingEngine(params, head_dim=HEAD_DIM, n_slots=cfg["slots"],
                         max_total=cfg["max_total"], prefix_cache=False,
                         spill_bytes=0, device="cuda")
    _drive_all(warm, prompts[:2], 4, False)
    warm.close()
    rows, tokens = {}, {}
    for name in ("fused", "local", "lanes"):
        for threads in (False, True):
            if name == "fused":
                service = ServingEngine(
                    params, head_dim=HEAD_DIM, n_slots=cfg["slots"],
                    max_total=cfg["max_total"], queue_capacity=32,
                    prefix_cache=False, spill_bytes=0, device="cuda")
            else:
                service = _disagg_fleet(params, name, cfg["staging"],
                                        cfg["slots"], cfg["max_total"],
                                        "cuda")
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            handles, wall = _drive_all(service, prompts, cfg["new"], threads)
            torch.cuda.synchronize()
            launches = ops.launch_counts()
            if any(h.status != "done" or len(h.tokens) != cfg["new"]
                   for h in handles):
                raise AssertionError(f"disagg {name} threads={threads}: "
                                     f"{[h.status for h in handles]}")
            ttft = [h.ttft_ms for h in handles]
            n_tok = sum(len(h.tokens) for h in handles)
            row = {"check": "serving_disagg.bf16", "service": name,
                   "drive": "start/stop" if threads else "run",
                   "dtype": "bfloat16", **cfg, "wall_s": wall,
                   "tokens": n_tok, "tokens_per_s": n_tok / wall,
                   "ttft_ms_p50": _percentile(ttft, 0.5),
                   "ttft_ms_p99": _percentile(ttft, 0.99),
                   "card": smoke.card}
            m = service.metrics()
            if name == "fused":
                row.update(tick_gap_ms_p50=m.get("serving/tick_gap_p50_ms"),
                           tick_gap_ms_p99=m.get("serving/tick_gap_p99_ms"),
                           ticks=service.engine.tick_calls,
                           goodput=service.goodput.report())
            else:
                m = _disagg_check_roles(f"disagg {name}", service,
                                        cfg["requests"])
                pw, dw = service.prefill_workers[0], service.decode_workers[0]
                row.update(
                    tick_gap_ms_p50=m.get("disagg/decode_tick_gap_p50_ms"),
                    tick_gap_ms_p99=m.get("disagg/decode_tick_gap_p99_ms"),
                    transfer_ms_p50=m.get("disagg/transfer_p50_ms"),
                    transfer_ms_p99=m.get("disagg/transfer_p99_ms"),
                    ticks=dw.engine.engine.tick_calls,
                    plane=service.plane.stats(),
                    prefill_goodput=pw.goodput.report(),
                    decode_goodput=dw.engine.goodput.report(),
                    requeued=m["disagg/requeued_total"])
                if name == "lanes" and service.plane.bytes_moved \
                        != cfg["requests"] * slab:
                    raise AssertionError(
                        f"lanes bytes {service.plane.bytes_moved}, want "
                        f"{cfg['requests']} x {slab}")
            if not threads:
                ticks = row["ticks"]
                want = {"flash_fwd": n_layers * cfg["requests"],
                        "cache_append": n_layers * cfg["requests"],
                        "decode_attend": n_layers * ticks, "beam_attend": 0}
                wrong = {k: (launches[k], w) for k, w in want.items()
                         if launches[k] != w}
                row["launches"] = launches
                if wrong:
                    raise AssertionError(f"disagg {name} launches (got, "
                                         f"want): {wrong}")
                if name != "fused":
                    smoke.add_launches(launches)
                tokens[name] = [h.tokens for h in handles]
            else:
                tokens[name, "threads"] = [h.tokens for h in handles]
            emit(row)
            rows[name, threads] = row
            service.close()
    # the fleets serve the fused engine's tokens (the same kernels at the
    # same shapes), or differ first at a near-tie of the card's logits
    for name in ("local", "lanes"):
        for key in (name, (name, "threads")):
            equal, near = _near_ties(
                f"disagg_{key}", tokens[key], tokens["fused"],
                lambda i, t: _card_choice_values(params, prompts[i],
                                                 tokens["fused"][i], t))
            emit({"check": "serving_disagg.tokens_vs_fused",
                  "service": name,
                  "drive": "start/stop" if key != name else "run",
                  "equal": equal,
                  "near_ties": len(near), "dtype": "bfloat16"})
    return rows


def _disagg_leg_gqa(smoke):
    """bf16, the GQA model (4 KV heads) over the lanes: the beam kernel
    ticks on rows another pool's prefill wrote."""
    torch = smoke.torch
    from chainermn_tpu_torch import ops
    from chainermn_tpu_torch.serving import ServingEngine

    cfg = dict(DISAGG, **DISAGG_GQA)
    n_layers = FULL["n_layers"]
    params = _init_full(torch, "cuda", torch.bfloat16, cfg["max_total"],
                        n_kv_heads=GQA_KV_HEADS)
    prompts = _disagg_prompts(62, cfg["requests"], cfg["prompt"])
    fused = ServingEngine(params, head_dim=HEAD_DIM, n_slots=cfg["slots"],
                          max_total=cfg["max_total"], queue_capacity=32,
                          prefix_cache=False, spill_bytes=0, device="cuda")
    want_tokens = [h.tokens for h in _drive_all(fused, prompts, cfg["new"],
                                                False)[0]]
    fused.close()
    fleet = _disagg_fleet(params, "lanes", cfg["staging"], cfg["slots"],
                          cfg["max_total"], "cuda")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    handles, wall = _drive_all(fleet, prompts, cfg["new"], False)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    _disagg_check_roles("disagg gqa", fleet, cfg["requests"])
    ticks = fleet.decode_workers[0].engine.engine.tick_calls
    got = [h.tokens for h in handles]
    equal, near = _near_ties(
        "disagg_gqa", got, want_tokens,
        lambda i, t: _card_choice_values(params, prompts[i], want_tokens[i],
                                         t))
    emit({"check": "serving_disagg.gqa", "dtype": "bfloat16",
          "kv_heads": GQA_KV_HEADS, **cfg, "transport": "lanes",
          "wall_s": wall, "ticks": ticks, "launches": launches,
          "equal_to_fused": equal, "near_ties": len(near),
          "bytes_moved": fleet.plane.bytes_moved, "card": smoke.card})
    fleet.close()
    want = {"beam_attend": n_layers * ticks, "decode_attend": 0,
            "flash_fwd": n_layers * cfg["requests"],
            "cache_append": n_layers * (cfg["requests"] + ticks)}
    wrong = {k: (launches[k], w) for k, w in want.items()
             if launches[k] != w}
    if wrong:
        raise AssertionError(f"disagg GQA launches (got, want): {wrong}")
    smoke.add_launches(launches)


def _disagg_leg_parity(smoke):
    """fp32 at 2 layers (the full width otherwise): the 1:1 fleet over each
    transport on the card and on the CPU, the same requests; each card row
    equals the CPU's, or first differs at a CPU near-tie < 1e-3."""
    import numpy as np

    torch = smoke.torch
    from chainermn_tpu_torch.parallel import init_tp_transformer_lm

    cfg = DISAGG_PARITY
    max_total = cfg["prompt"] + cfg["new"]
    params = init_tp_transformer_lm(
        torch.Generator().manual_seed(4), max_len=max_total,
        dtype=torch.float32, device="cpu",
        **dict(FULL, n_layers=cfg["n_layers"]))
    prompts = _disagg_prompts(63, cfg["requests"], cfg["prompt"])
    for transport in ("local", "lanes"):
        rows = {}
        for dev in ("cuda", "cpu"):
            fleet = _disagg_fleet(params, transport, 2, cfg["slots"],
                                  max_total, dev)
            handles, _ = _drive_all(fleet, prompts, cfg["new"], False)
            _disagg_check_roles(f"disagg parity {transport} {dev}", fleet,
                                cfg["requests"])
            if not all(h.status == "done" for h in handles):
                raise AssertionError(f"disagg parity {transport} {dev}")
            rows[dev] = [h.tokens for h in handles]
            fleet.close()
        equal, near = _near_ties(
            f"disagg_parity_{transport}", rows["cuda"], rows["cpu"],
            lambda i, t: _cpu_choice_values(params, HEAD_DIM,
                                            np.asarray(prompts[i]),
                                            rows["cpu"][i], t, None))
        emit({"check": "serving_disagg.parity", "transport": transport,
              "dtype": "float32", **cfg, "equal": equal,
              "near_ties": len(near)})


def phase_serving_disagg(smoke):
    """Disaggregated prefill / decode serving at the decode-bench LM's
    full width (bf16): the 1:1 fleet over the local and the lanes
    transports beside the fused engine, the GQA model over the lanes, then
    fp32 card-vs-CPU parity at 2 layers on both transports."""
    torch = smoke.torch

    params = _init_full(torch, "cuda", torch.bfloat16, DISAGG["max_total"])
    _disagg_leg_bf16(smoke, params)
    del params
    torch.cuda.empty_cache()
    _disagg_leg_gqa(smoke)
    torch.cuda.empty_cache()
    _disagg_leg_parity(smoke)


FLEET = dict(requests=16, prompt=512, new=64, max_total=1024, slots=8,
             queue=32, staging=2)
FLEET_PARITY = dict(n_layers=2, requests=8, prompt=256, new=16, slots=4)
FLEET_TIMEOUT_S = 300       # a fleet leg's bound: spawn to the last exit
FLEET_CLI = ["--dtype", "bfloat16", "--vocab", str(FULL["vocab"]),
             "--d-model", str(FULL["d_model"]), "--n-heads",
             str(FULL["n_heads"]), "--n-layers", str(FULL["n_layers"]),
             "--n-slots", str(FLEET["slots"]), "--max-total",
             str(FLEET["max_total"]), "--requests", str(FLEET["requests"]),
             "--prompt-len", str(FLEET["prompt"]), "--max-new-tokens",
             str(FLEET["new"]), "--train-steps", "0"]


def _fleet_cli_ref(smoke):
    """The serve CLI's model (``--seed 0``, random init on the CPU in bf16,
    moved to the card) and its corpus prompts; the fused engine's tokens
    for them under the CLI's staggered schedule."""
    import numpy as np

    torch = smoke.torch
    from chainermn_tpu_torch.parallel import init_tp_transformer_lm
    from chainermn_tpu_torch.serve import make_corpus
    from chainermn_tpu_torch.serving import ServingEngine

    cfg = FLEET
    params = init_tp_transformer_lm(
        torch.Generator().manual_seed(0), max_len=cfg["max_total"],
        dtype=torch.bfloat16, device="cpu", **FULL)
    params = _tree_to(torch, params, "cuda")
    test = make_corpus(np.random.RandomState(99), cfg["requests"],
                       cfg["prompt"] + cfg["new"], FULL["vocab"])
    prompts = list(test[:, :cfg["prompt"]])
    eng = ServingEngine(params, head_dim=HEAD_DIM, n_slots=cfg["slots"],
                        max_total=cfg["max_total"], device="cuda")
    handles, _ = _drive(eng, prompts, cfg["new"], cfg["slots"], 2)
    eng.close()
    return params, prompts, [h.tokens for h in handles]


def _fleet_leg_cli(smoke):
    """Leg 1: ``serve --fleet-procs 2`` and ``serve --disagg 1:1 --procs``
    as subprocesses through the CLI (side by side): exit codes, every
    worker on the card, no shed, no failover, tokens the fused engine's
    (or a near-tie)."""
    import os
    import signal

    env = dict(os.environ, PYTHONPATH=str(ROOT))
    # each CLI leads its own process group: a CLI that outlives the bound
    # is killed with its workers
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", "chainermn_tpu_torch.serve", "--device",
         "cuda", *FLEET_CLI, *extra], cwd=str(ROOT), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
        for name, extra in (("fleet", ["--fleet-procs", "2"]),
                            ("disagg", ["--disagg", "1:1", "--procs"]))}
    try:
        params, prompts, want = _fleet_cli_ref(smoke)
        outs = {name: _finish(p, f"serve {name}", timeout=FLEET_TIMEOUT_S)
                for name, p in procs.items()}
    finally:
        for p in procs.values():
            try:
                os.killpg(p.pid, signal.SIGKILL)   # stragglers, if any
            except ProcessLookupError:
                pass
            p.wait()
    codes = {"fleet": {"engine0": 0, "engine1": 0},
             "disagg": {"prefill0": 0, "decode0": 0}}
    for name, (out, err) in outs.items():
        s = _last_json(out)
        m = s["metrics"]
        ready = [ln for ln in err.splitlines() if "worker]" in ln
                 and ln.endswith("ready")]
        got = [r.get("tokens") for r in s["requests"]]
        row = {"check": "serving_fleet.cli", "service": name,
               "fleet_exit_codes": s["fleet_exit_codes"],
               "shed_rate": m["fleet/shed_rate"],
               "redispatched": m["fleet/redispatched_total"],
               "dead_workers": m["fleet/dead_workers"],
               "tokens_per_s": m["fleet/tokens_per_sec"],
               "ttft_ms_p50": m.get("fleet/ttft_p50_ms"),
               "ttft_ms_p99": m.get("fleet/ttft_p99_ms"),
               "ready": ready, "card": smoke.card}
        if (s["fleet_exit_codes"] != codes[name] or m["fleet/shed_rate"]
                or m["fleet/redispatched_total"] or m["fleet/dead_workers"]
                or len(ready) != 2
                or not all("device=cuda" in ln for ln in ready)
                or any(r["status"] != "done" for r in s["requests"])):
            raise AssertionError(f"serve {name}: {row}\n{err[-4000:]}")
        equal, near = _near_ties(
            f"fleet_cli_{name}", got, want,
            lambda i, t: _card_choice_values(params, prompts[i], want[i], t))
        emit(dict(row, equal_to_fused=equal, near_ties=len(near)))


def fleet_worker(out_dir, argv):
    """``chip_smoke.py --fleet-worker DIR ARGS``: the fleet's worker entry
    (``serving.worker.main(ARGS)``) that also writes, at exit, its
    kernel launch counts, its engine's metrics and the host ms of the
    transfer plane's calls, of each outbound mailbox message and of each
    engine step to ``DIR/<name>.json`` (a follower rank r of a worker
    group: ``DIR/<name>.r<r>.json``, its launches and device calls)."""
    from chainermn_tpu_torch import ops
    from chainermn_tpu_torch import health
    from chainermn_tpu_torch.serving import (engine, frontend, lanes,
                                             transfer, worker)

    op_ms, metrics = {}, []

    def timed(cls, name, key):
        fn = getattr(cls, name)

        def wrapped(self, *a, **k):
            t0 = time.perf_counter()
            try:
                return fn(self, *a, **k)
            finally:
                op_ms.setdefault(key, []).append(
                    (time.perf_counter() - t0) * 1e3)
        setattr(cls, name, wrapped)

    for name in ("pack", "lane_put", "lane_get", "unpack_into"):
        timed(transfer.KvTransferPlane, name, name)
    for name in ("pack_slab", "land_slab"):     # the group's global slabs
        timed(engine.DecodeEngine, name, name)
    timed(lanes.MailboxSender, "send", "mailbox_send")
    timed(frontend.ServingEngine, "step", "engine_step")
    timed(health.HeartbeatPublisher, "beat", "beat")
    beat, beat_at = health.HeartbeatPublisher.beat, []

    def gap(self, *a, **k):
        # the lease's own cadence: ms between two published beats
        now = time.perf_counter()
        if beat_at:
            op_ms.setdefault("beat_gap", []).append((now - beat_at[0]) * 1e3)
        beat_at[:] = [now]
        return beat(self, *a, **k)

    health.HeartbeatPublisher.beat = gap
    close = frontend.ServingEngine.close

    def snapshot(self):
        metrics.append(self.metrics())
        close(self)

    built, build_role = [], worker.build_role

    def keep_role(*a, **k):
        built.append(build_role(*a, **k))
        return built[-1]

    worker.build_role = keep_role
    frontend.ServingEngine.close = snapshot
    rc = worker.main(argv)

    def arg(flag, default=None):
        return argv[argv.index(flag) + 1] if flag in argv else default

    rank = int(arg("--group-rank", 0))
    name = arg("--name") + (f".r{rank}" if rank else "")
    eng = built[0][1]
    with open(Path(out_dir) / f"{name}.json", "w") as f:
        json.dump({"name": name, "role": arg("--role"), "rank": rank,
                   "rc": rc, "launches": ops.launch_counts(),
                   "prefills": eng.prefill_calls, "ticks": eng.tick_calls,
                   "metrics": metrics[0] if metrics else {},
                   "op_ms": op_ms}, f)
    return rc


def _fleet_up(smoke, params, topology, worker_kwargs, report_dir=None,
              tp=1, **lease):
    """``build_proc_fleet`` on the card (the smoke's worker entry when
    ``report_dir`` is given; ``tp`` ranks a worker; ``lease``: its
    ``beat_interval_s`` / ``miss_beats``); waits until every worker is
    live and returns the router and the spawn-to-live seconds of each
    worker (a group's: spawn to its leader's first lease)."""
    import tempfile

    from chainermn_tpu_torch.serving import build_proc_fleet

    lane_dir = tempfile.mkdtemp(prefix="chainermn_fleet_")
    cmd = (None if report_dir is None else
           [sys.executable, str(ROOT / "chip_smoke.py"), "--fleet-worker",
            str(report_dir)])
    t0 = time.monotonic()
    router = build_proc_fleet(params, topology, lane_dir, head_dim=HEAD_DIM,
                              device="cuda", worker_kwargs=worker_kwargs,
                              worker_cmd=cmd, tp=tp, **lease)
    built = time.monotonic() - t0
    live = {}
    try:
        while len(live) < len(router.workers):
            router.step()
            for name, wc in router.workers.items():
                if wc.state == "live" and name not in live:
                    live[name] = time.monotonic() - t0
                if wc.state in ("dead", "drained"):
                    raise AssertionError(f"fleet worker {name} {wc.state} "
                                         f"before its first lease")
            if time.monotonic() - t0 > FLEET_TIMEOUT_S:
                raise AssertionError(f"fleet not live in {FLEET_TIMEOUT_S}"
                                     f" s: {live}")
            time.sleep(0.002)
    except BaseException:
        router.shutdown(timeout_s=10)
        router.close()
        raise
    return router, {"lane_dir": lane_dir, "build_s": built,
                    "spawn_to_live_s": live}


def _fleet_down(router, info, want_codes):
    """Drain every live worker, reap every process (a worker that outlives
    the timeout is killed and fails the leg), remove the lanes."""
    import shutil

    try:
        for name, wc in list(router.workers.items()):
            if wc.state in ("starting", "live"):
                router.drain(name)
                if not router.wait_drained(name, timeout_s=60):
                    raise AssertionError(f"fleet worker {name} not drained "
                                         f"in 60 s")
    finally:
        codes = router.shutdown(timeout_s=60)
        router.close()
        shutil.rmtree(info["lane_dir"], ignore_errors=True)
    if codes != want_codes:
        raise AssertionError(f"fleet exit codes {codes}, want {want_codes}")
    return codes


def _fleet_serve(router, prompts, new):
    """Submit every prompt at once to the started router and wait."""
    router.start()
    t0 = time.perf_counter()
    try:
        handles = [router.submit(p, new) for p in prompts]
        for h in handles:
            if not h.wait(timeout=FLEET_TIMEOUT_S):
                raise AssertionError(f"fleet request {h.id} not finished: "
                                     f"{h.status}")
    finally:
        router.stop()
    return handles, time.perf_counter() - t0


def _fleet_op_stats(report):
    """Count, p50, p99 and sum (ms) of each timed call of a worker."""
    return {op: {"n": len(v), "p50": _percentile(v, 0.5),
                 "p99": _percentile(v, 0.99), "max": max(v), "sum": sum(v)}
            for op, v in report["op_ms"].items()}


def _fleet_reports(report_dir):
    return {p.stem: json.loads(p.read_text())
            for p in sorted(Path(report_dir).glob("*.json"))}


def _fleet_row(smoke, label, handles, wall, router):
    m = router.metrics()
    n_tok = sum(len(h.tokens) for h in handles)
    return {"check": f"serving_fleet.{label}", "dtype": "bfloat16",
            **FLEET, "wall_s": wall, "tokens": n_tok,
            "tokens_per_s": n_tok / wall,
            "ttft_ms_p50": _percentile([h.ttft_ms for h in handles], 0.5),
            "ttft_ms_p99": _percentile([h.ttft_ms for h in handles], 0.99),
            "shed_rate": m["fleet/shed_rate"],
            "redispatched": m["fleet/redispatched_total"],
            "dead_workers": m["fleet/dead_workers"], "card": smoke.card}


def _fleet_check_clean(row):
    if row["shed_rate"] or row["redispatched"] or row["dead_workers"]:
        raise AssertionError(f"{row['check']}: a clean run shed or failed "
                             f"over: {row}")


def _fleet_check_launches(label, reports, prefill_names, tick_names):
    """8 flash forward + 8 append launches a prefill on the prefilling
    workers, 8 decode launches a tick on the ticking ones, nothing else."""
    n_layers = FULL["n_layers"]
    wrong = {}
    for name, rep in reports.items():
        want = {"flash_fwd": 0, "cache_append": 0, "decode_attend": 0,
                "beam_attend": 0}
        if name in prefill_names:
            want["flash_fwd"] = want["cache_append"] = \
                n_layers * rep["prefills"]
        if name in tick_names:
            want["decode_attend"] = n_layers * rep["ticks"]
        got = rep["launches"]
        bad = {k: (got[k], w) for k, w in want.items() if got[k] != w}
        if bad or rep["rc"] != 0:
            wrong[name] = dict(bad, rc=rep["rc"])
    if wrong:
        raise AssertionError(f"{label} launches (got, want): {wrong}")


def _fleet_leg_engines(smoke, params, prompts, want):
    """Leg 2: ``build_proc_fleet({"engine": 2})`` on the card with each
    worker's launch counts and tick gaps gathered from its process; then
    the in-process ``build_fleet(params, 2)`` on the same requests."""
    import tempfile

    torch = smoke.torch
    from chainermn_tpu_torch.serving import build_fleet

    cfg = FLEET
    report_dir = Path(tempfile.mkdtemp(prefix="chainermn_fleet_reports_"))
    router, info = _fleet_up(smoke, params, {"engine": 2},
                             dict(n_slots=cfg["slots"],
                                  max_total=cfg["max_total"],
                                  queue_capacity=cfg["queue"]), report_dir)
    try:
        handles, wall = _fleet_serve(router, prompts, cfg["new"])
        row = _fleet_row(smoke, "procs", handles, wall, router)
    finally:
        _fleet_down(router, info, {"engine0": 0, "engine1": 0})
    reports = _fleet_reports(report_dir)
    _fleet_check_launches("fleet procs", reports, set(reports), set(reports))
    for rep in reports.values():
        smoke.add_launches(rep["launches"])
    row.update(build_s=info["build_s"],
               spawn_to_live_s=info["spawn_to_live_s"], workers={
        n: {"prefills": r["prefills"], "ticks": r["ticks"],
            "tick_gap_ms_p50": r["metrics"].get("serving/tick_gap_p50_ms"),
            "tick_gap_ms_p99": r["metrics"].get("serving/tick_gap_p99_ms"),
            "host_ms": _fleet_op_stats(r),
            "launches": r["launches"]} for n, r in reports.items()})
    got = [h.tokens for h in handles]
    equal, near = _near_ties(
        "fleet_procs", got, want,
        lambda i, t: _card_choice_values(params, prompts[i], want[i], t))
    emit(dict(row, equal_to_fused=equal, near_ties=len(near)))
    _fleet_check_clean(row)
    if sum(r["prefills"] for r in reports.values()) != cfg["requests"]:
        raise AssertionError(f"fleet procs prefills: {row['workers']}")
    # the in-process router: two engines in this process, one driver
    # thread each, on the one card
    fleet = build_fleet(params, 2, head_dim=HEAD_DIM, n_slots=cfg["slots"],
                        max_total=cfg["max_total"],
                        queue_capacity=cfg["queue"], device="cuda")
    torch.cuda.synchronize()
    handles, wall = _drive_all(fleet, prompts, cfg["new"], True)
    n_tok = sum(len(h.tokens) for h in handles)
    got = [h.tokens for h in handles]
    equal, near = _near_ties(
        "fleet_inprocess", got, want,
        lambda i, t: _card_choice_values(params, prompts[i], want[i], t))
    emit({"check": "serving_fleet.in_process_router", "dtype": "bfloat16",
          **cfg, "wall_s": wall, "tokens": n_tok,
          "tokens_per_s": n_tok / wall,
          "ttft_ms_p50": _percentile([h.ttft_ms for h in handles], 0.5),
          "ttft_ms_p99": _percentile([h.ttft_ms for h in handles], 0.99),
          "replicas": {rep.name: {
              "tick_gap_ms_p50": rep.engine.metrics().get(
                  "serving/tick_gap_p50_ms"),
              "tick_gap_ms_p99": rep.engine.metrics().get(
                  "serving/tick_gap_p99_ms")} for rep in fleet.replicas},
          "equal_to_fused": equal, "near_ties": len(near),
          "card": smoke.card})
    fleet.close()


def _fleet_leg_disagg(smoke, params, prompts, want):
    """Leg 3: ``build_proc_fleet({"prefill": 1, "decode": 1})``: slabs over
    the file lanes between two processes on the card; launch counts,
    the decode tick gap and the plane's call times from each process."""
    import tempfile

    cfg = FLEET
    report_dir = Path(tempfile.mkdtemp(prefix="chainermn_fleet_reports_"))
    router, info = _fleet_up(smoke, params, {"prefill": 1, "decode": 1},
                             dict(n_slots=cfg["slots"],
                                  max_total=cfg["max_total"],
                                  queue_capacity=cfg["queue"],
                                  staging_slots=cfg["staging"]), report_dir)
    try:
        handles, wall = _fleet_serve(router, prompts, cfg["new"])
        row = _fleet_row(smoke, "disagg_procs", handles, wall, router)
    finally:
        _fleet_down(router, info, {"prefill0": 0, "decode0": 0})
    reports = _fleet_reports(report_dir)
    _fleet_check_launches("disagg procs", reports, {"prefill0"},
                          {"decode0"})
    for rep in reports.values():
        smoke.add_launches(rep["launches"])
    pw, dw = reports["prefill0"], reports["decode0"]
    host = {n: _fleet_op_stats(r) for n, r in reports.items()}
    ops_ms = {op: st for h in host.values() for op, st in h.items()
              if op in ("pack", "lane_put", "lane_get", "unpack_into")}
    row.update(build_s=info["build_s"],
               spawn_to_live_s=info["spawn_to_live_s"],
               prefills=pw["prefills"], decode_prefills=dw["prefills"],
               ticks=dw["ticks"],
               tick_gap_ms_p50=dw["metrics"].get("serving/tick_gap_p50_ms"),
               tick_gap_ms_p99=dw["metrics"].get("serving/tick_gap_p99_ms"),
               slab_ms=ops_ms,
               host_ms={n: {op: st for op, st in h.items()
                            if op not in ops_ms} for n, h in host.items()})
    got = [h.tokens for h in handles]
    equal, near = _near_ties(
        "fleet_disagg_procs", got, want,
        lambda i, t: _card_choice_values(params, prompts[i], want[i], t))
    emit(dict(row, equal_to_fused=equal, near_ties=len(near)))
    _fleet_check_clean(row)
    if pw["prefills"] != cfg["requests"] or dw["prefills"] or \
            ops_ms.get("unpack_into", {}).get("n") != cfg["requests"]:
        raise AssertionError(f"disagg procs role split: {row}")


def _fleet_leg_kill(smoke, params, prompts, want):
    """Leg 4: SIGKILL engine0 mid-run; the router detects it within the
    lease window and fails its requests over to engine1: every request
    ends exactly once (done, or a machine-readable shed), at least one
    failover."""
    import os
    import signal

    cfg = FLEET
    router, info = _fleet_up(smoke, params, {"engine": 2},
                             dict(n_slots=cfg["slots"],
                                  max_total=cfg["max_total"],
                                  queue_capacity=cfg["queue"]))
    try:
        router.start()
        handles = [router.submit(p, cfg["new"]) for p in prompts]
        t0 = time.monotonic()
        while router.metrics()["fleet/tokens_total"] < 4 * cfg["requests"]:
            if time.monotonic() - t0 > FLEET_TIMEOUT_S:
                raise AssertionError("kill leg: no progress")
            time.sleep(0.005)
        os.kill(router.workers["engine0"].proc.pid, signal.SIGKILL)
        for h in handles:
            if not h.wait(timeout=FLEET_TIMEOUT_S):
                raise AssertionError(f"kill leg: request {h.id} never "
                                     f"ended: {h.status}")
        router.stop()
        m = router.metrics()
        det = router.last_detection or {}
        ends = {"done": sum(h.status == "done" for h in handles),
                "shed": sum(h.finish_reason == "shed" for h in handles)}
        row = {"check": "serving_fleet.kill", "dtype": "bfloat16", **cfg,
               "ends": ends, "redispatched": m["fleet/redispatched_total"],
               "shed_inflight": m["fleet/shed_inflight_total"],
               "results": router._results,
               "detection_ms": m.get("fleet/detection_ms"),
               "lease_window_ms": router.lease_window_s * 1e3,
               "failover_ttft_ms_p99": m.get("fleet/failover_ttft_p99_ms"),
               "dead": det.get("worker"), "card": smoke.card}
    finally:
        _fleet_down(router, info,
                    {"engine0": -signal.SIGKILL, "engine1": 0})
    done = [i for i, h in enumerate(handles) if h.status == "done"]
    equal, near = _near_ties(
        "fleet_kill", [handles[i].tokens for i in done],
        [want[i] for i in done],
        lambda j, t: _card_choice_values(params, prompts[done[j]],
                                         want[done[j]], t))
    emit(dict(row, equal_to_fused=equal, near_ties=len(near)))
    if (ends["done"] + ends["shed"] != cfg["requests"]
            or row["results"] + row["shed_inflight"] != cfg["requests"]
            or row["redispatched"] < 1 or row["dead"] != "engine0"
            or any(h.status == "done" and len(h.tokens) != cfg["new"]
                   for h in handles)):
        raise AssertionError(f"kill leg: {row}")


def _fleet_leg_parity(smoke):
    """Leg 5: fp32 at 2 layers (the full width otherwise): the process
    fleet of 2 engines on the card against the local fleet of 2 engines
    on the CPU, the same requests: tokens equal, or first different at a
    CPU near-tie < 1e-3."""
    import numpy as np

    torch = smoke.torch
    from chainermn_tpu_torch.parallel import init_tp_transformer_lm
    from chainermn_tpu_torch.serving import build_local_fleet

    cfg = FLEET_PARITY
    max_total = cfg["prompt"] + cfg["new"]
    params = init_tp_transformer_lm(
        torch.Generator().manual_seed(4), max_len=max_total,
        dtype=torch.float32, device="cpu",
        **dict(FULL, n_layers=cfg["n_layers"]))
    prompts = _disagg_prompts(64, cfg["requests"], cfg["prompt"])
    kw = dict(n_slots=cfg["slots"], max_total=max_total, queue_capacity=16)
    router, info = _fleet_up(smoke, params, {"engine": 2}, kw)
    try:
        handles, _ = _fleet_serve(router, prompts, cfg["new"])
        card = [h.tokens for h in handles]
    finally:
        _fleet_down(router, info, {"engine0": 0, "engine1": 0})
    router, runtimes = build_local_fleet(
        params, {"engine": 2}, head_dim=HEAD_DIM,
        worker_kwargs=dict(kw, device="cpu"))
    try:
        handles = [router.submit(p, cfg["new"]) for p in prompts]
        t0 = time.monotonic()
        while any(h.status not in ("done", "evicted") for h in handles):
            if time.monotonic() - t0 > FLEET_TIMEOUT_S:
                raise AssertionError("CPU local fleet hung")
            for rt in runtimes:
                rt.step()
            router.step()
        cpu = [h.tokens for h in handles]
    finally:
        for rt in runtimes:
            rt.finished = True
            if rt.engine is not None:
                rt.engine.close()
        router.close()
    equal, near = _near_ties(
        "fleet_parity", card, cpu,
        lambda i, t: _cpu_choice_values(params, HEAD_DIM,
                                        np.asarray(prompts[i]), cpu[i], t,
                                        None))
    emit({"check": "serving_fleet.parity", "dtype": "float32", **cfg,
          "equal": equal, "near_ties": len(near)})


def phase_serving_fleet(smoke):
    """The cross-process serving fleet at the decode-bench LM's full width
    (bf16): the serve CLI's ``--fleet-procs 2`` and ``--disagg 1:1
    --procs``, the process fleet of 2 engines (the workers' launch counts,
    tick gaps and cold starts) beside the in-process router, the 1:1
    process split over the file lanes, a SIGKILLed engine worker, then
    fp32 at 2 layers, the card's process fleet against the CPU's local
    fleet."""
    torch = smoke.torch
    from chainermn_tpu_torch.serving import ServingEngine

    legs_s, t0 = {}, time.monotonic()
    _fleet_leg_cli(smoke)
    torch.cuda.empty_cache()
    legs_s["cli"] = time.monotonic() - t0
    t0 = time.monotonic()
    cfg = FLEET
    params = _init_full(torch, "cuda", torch.bfloat16, cfg["max_total"])
    prompts = _disagg_prompts(61, cfg["requests"], cfg["prompt"])
    fused = ServingEngine(params, head_dim=HEAD_DIM, n_slots=cfg["slots"],
                          max_total=cfg["max_total"], queue_capacity=32,
                          prefix_cache=False, spill_bytes=0, device="cuda")
    want = [h.tokens for h in
            _drive_all(fused, prompts, cfg["new"], False)[0]]
    fused.close()
    for name, leg in (("engines", _fleet_leg_engines),
                      ("disagg", _fleet_leg_disagg),
                      ("kill", _fleet_leg_kill)):
        leg(smoke, params, prompts, want)
        legs_s[name] = time.monotonic() - t0
        t0 = time.monotonic()
    del params
    torch.cuda.empty_cache()
    _fleet_leg_parity(smoke)
    legs_s["parity"] = time.monotonic() - t0
    emit({"check": "serving_fleet.legs_s", **legs_s})


FLEET_TP = dict(FLEET, tp=2)
#: the bf16 group legs' lease: four ranks and the router share the host's
#: cores, and at the default 0.05 s x 4 missed beats (250 ms) a leader's
#: beat gaps reached 148 ms, its lease writes 65 ms and the router's
#: steps 89 ms; one whole-smoke run lost both groups to it.  The chaos
#: leg keeps the default window, the one PR 19's detections were read at.
FLEET_TP_LEASE = dict(beat_interval_s=0.1, miss_beats=9)
FLEET_TP_CHAOS = dict(n_layers=2, requests=8, prompt=256, new=32, slots=4,
                      tp=2, kill_after_tokens=16)
#: a follower's exit after its leader's SIGKILL: PR_SET_PDEATHSIG at
#: once, the parent-pid watch within worker.LEADER_WATCH_S (0.1 s)
FLEET_TP_FOLLOWER_BOUND_S = 1.0


def _proc_alive(pid):
    """A process that runs (a zombie holds no card: it counts as gone)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except (FileNotFoundError, ProcessLookupError):
        return False


def _group_pids(router):
    """Each worker group's pids, leader first, from its leases."""
    return {n: list(w.last_lease["group"]["pids"])
            for n, w in router.workers.items()
            if w.last_lease and "group" in w.last_lease}


def _check_no_rank_left(label, pids):
    left = [p for ps in pids.values() for p in ps if _proc_alive(p)]
    for p in left:
        os.kill(p, signal.SIGKILL)
    if left:
        raise AssertionError(f"{label}: ranks {left} outlived their fleet")


def _fleet_tp_leg(smoke, params, prompts, topology, kw, label):
    """A bf16 fleet of TP = 2 groups through ``--fleet-worker``: 16
    requests at once; every rank's launches, its leader's tick gap, spawn
    to first lease, exit 0 after the drain, no rank left."""
    import tempfile

    cfg = FLEET_TP
    report_dir = Path(tempfile.mkdtemp(prefix="chainermn_fleet_tp_"))
    router, info = _fleet_up(smoke, params, topology, kw, report_dir,
                             tp=cfg["tp"], **FLEET_TP_LEASE)
    pids = _group_pids(router)
    step, step_at, step_gaps = router.step, [], []

    def timed_step():
        # the supervisor's cadence: a stalled router thread ages every
        # lease at once
        now = time.perf_counter()
        if step_at:
            step_gaps.append((now - step_at[0]) * 1e3)
        step_at[:] = [now]
        return step()

    router.step = timed_step
    try:
        handles, wall = _fleet_serve(router, prompts, cfg["new"])
        # a request that ended without a first token fails here, with the
        # fleet's state, not later in the row's percentiles
        if any(h.status != "done" or h.ttft_ms is None for h in handles):
            raise AssertionError(
                f"{label}: requests "
                f"{[(h.status, h.finish_reason, len(h.tokens)) for h in handles]}"
                f", states {[(n, w.state) for n, w in router.workers.items()]}"
                f", detection {router.last_detection}, metrics "
                f"{router.metrics()}")
        row = _fleet_row(smoke, label, handles, wall, router)
        row.update(group=dict(router.group),
                   lease_window_ms=router.lease_window_s * 1e3,
                   router_step_gap_ms={"p99": _percentile(step_gaps, 0.99),
                                       "max": max(step_gaps)})
    finally:
        _fleet_down(router, info, dict.fromkeys(router.workers, 0))
    _check_no_rank_left(label, pids)
    reports = _fleet_reports(report_dir)
    want = {n + sfx for n in router.workers for sfx in ("", ".r1")}
    if set(reports) != want:
        raise AssertionError(f"{label}: rank reports {sorted(reports)}")
    prefill = {n for n in reports if not n.startswith("decode")}
    tick = {n for n in reports if not n.startswith("prefill")}
    _fleet_check_launches(label, reports, prefill, tick)
    for n in router.workers:           # the follower mirrors its leader
        lead, fol = reports[n], reports[n + ".r1"]
        if (lead["prefills"], lead["ticks"]) != (fol["prefills"],
                                                  fol["ticks"]):
            raise AssertionError(f"{label}: {n}'s follower ran "
                                 f"{fol['prefills']} / {fol['ticks']} "
                                 f"prefills / ticks, its leader "
                                 f"{lead['prefills']} / {lead['ticks']}")
    for rep in reports.values():
        smoke.add_launches(rep["launches"])
    row.update(build_s=info["build_s"], pids=pids,
               spawn_to_first_lease_s=info["spawn_to_live_s"], ranks={
        n: {"prefills": r["prefills"], "ticks": r["ticks"],
            "tick_gap_ms_p50": r["metrics"].get("serving/tick_gap_p50_ms"),
            "tick_gap_ms_p99": r["metrics"].get("serving/tick_gap_p99_ms"),
            "host_ms": _fleet_op_stats(r), "launches": r["launches"]}
        for n, r in reports.items()})
    emit(row)
    _fleet_check_clean(row)
    done = sum(h.status == "done" and len(h.tokens) == cfg["new"]
               for h in handles)
    leaders = [r for n, r in reports.items() if r["rank"] == 0]
    if done != cfg["requests"] or sum(
            r["prefills"] for r in leaders) != cfg["requests"]:
        raise AssertionError(f"{label}: {done} requests done, prefills "
                             f"{[r['prefills'] for r in leaders]}")
    return row


def _fleet_tp_leg_chaos(smoke):
    """fp32 at 2 layers: two TP = 2 groups; engine0's follower SIGKILLed
    with requests in flight, then engine1's leader; every request done
    once, tokens the CPU's TP = 1 engine's (or a CPU near-tie)."""
    import numpy as np

    torch = smoke.torch
    from chainermn_tpu_torch.parallel import init_tp_transformer_lm
    from chainermn_tpu_torch.serving import ServingEngine, worker

    cfg = FLEET_TP_CHAOS
    max_total = cfg["prompt"] + cfg["new"]
    params = init_tp_transformer_lm(
        torch.Generator().manual_seed(6), max_len=max_total,
        dtype=torch.float32, device="cpu",
        **dict(FULL, n_layers=cfg["n_layers"]))
    prompts = _disagg_prompts(73, cfg["requests"], cfg["prompt"])
    kw = dict(n_slots=cfg["slots"], max_total=max_total, queue_capacity=16)
    router, info = _fleet_up(smoke, params, {"engine": 2}, kw, tp=cfg["tp"])
    pids = _group_pids(router)
    row = {"check": "serving_fleet_tp.chaos", "dtype": "float32", **cfg,
           "pids": pids, "spawn_to_first_lease_s": info["spawn_to_live_s"],
           "lease_window_ms": router.lease_window_s * 1e3,
           "card": smoke.card}

    def until(preds):
        """ms from now until each predicate first holds (all must)."""
        t0, got = time.monotonic(), {}
        while len(got) < len(preds):
            for k, pred in preds.items():
                if k not in got and pred():
                    got[k] = (time.monotonic() - t0) * 1e3
            if time.monotonic() - t0 > FLEET_TIMEOUT_S:
                raise AssertionError(f"chaos leg: {sorted(set(preds) - set(got))}"
                                     f" never held")
            time.sleep(0.001)
        return got

    try:
        router.start()
        handles = [router.submit(p, cfg["new"]) for p in prompts]
        until({"progress": lambda: router.metrics()["fleet/tokens_total"]
               >= cfg["kill_after_tokens"]})
        os.kill(pids["engine0"][1], signal.SIGKILL)
        row["follower_kill"] = until({
            "leader_exit_ms": lambda: not _proc_alive(pids["engine0"][0]),
            "detection_ms": lambda: router.workers["engine0"].state
            == "dead"})
        for h in handles:
            if not h.wait(timeout=FLEET_TIMEOUT_S):
                raise AssertionError(f"chaos leg: request {h.id} never "
                                     f"ended: {h.status}")
        m = router.metrics()
        os.kill(pids["engine1"][0], signal.SIGKILL)
        row["leader_kill"] = until({
            "follower_exit_ms": lambda: not _proc_alive(pids["engine1"][1]),
            "detection_ms": lambda: router.workers["engine1"].state
            == "dead"})
        follower_ms = row["leader_kill"]["follower_exit_ms"]
        router.stop()
        row.update(redispatched=m["fleet/redispatched_total"],
                   shed_inflight=m["fleet/shed_inflight_total"],
                   results=router._results,
                   router_detection_ms=m.get("fleet/detection_ms"))
    finally:
        _fleet_down(router, info, {"engine0": worker.GROUP_LOST_RC,
                                   "engine1": -signal.SIGKILL})
        _check_no_rank_left("chaos leg", pids)
    card = [h.tokens for h in handles]
    eng = ServingEngine(params, head_dim=HEAD_DIM, n_slots=cfg["slots"],
                        max_total=max_total, queue_capacity=16,
                        device="cpu")
    cpu = [h.tokens for h in _drive_all(eng, prompts, cfg["new"],
                                        False)[0]]
    eng.close()
    equal, near = _near_ties(
        "fleet_tp_chaos", card, cpu,
        lambda i, t: _cpu_choice_values(params, HEAD_DIM,
                                        np.asarray(prompts[i]), cpu[i], t,
                                        None))
    row.update(done=sum(h.status == "done" for h in handles), equal=equal,
               near_ties=len(near))
    emit(row)
    if (row["done"] != cfg["requests"] or row["results"] != cfg["requests"]
            or row["shed_inflight"] or row["redispatched"] < 1
            or follower_ms > FLEET_TP_FOLLOWER_BOUND_S * 1e3):
        raise AssertionError(f"chaos leg: {row}")
    return row


def phase_serving_fleet_tp(smoke):
    """The worker-process fleet at TP = 2 on this card over gloo: the
    engine groups and the 1:1 split at the decode-bench width (bf16),
    then the chaos leg (fp32 at 2 layers) against the CPU."""
    torch = smoke.torch

    legs_s, t0 = {}, time.monotonic()
    cfg = FLEET_TP
    params = _init_full(torch, "cpu", torch.bfloat16, cfg["max_total"])
    prompts = _disagg_prompts(71, cfg["requests"], cfg["prompt"])
    kw = dict(n_slots=cfg["slots"], max_total=cfg["max_total"],
              queue_capacity=cfg["queue"])
    _fleet_tp_leg(smoke, params, prompts, {"engine": 2}, kw,
                  "serving_fleet_tp.engines")
    legs_s["engines"] = time.monotonic() - t0
    t0 = time.monotonic()
    _fleet_tp_leg(smoke, params, prompts, {"prefill": 1, "decode": 1},
                  dict(kw, staging_slots=cfg["staging"]),
                  "serving_fleet_tp.disagg")
    legs_s["disagg"] = time.monotonic() - t0
    del params
    t0 = time.monotonic()
    _fleet_tp_leg_chaos(smoke)
    legs_s["chaos"] = time.monotonic() - t0
    emit({"check": "serving_fleet_tp.legs_s", **legs_s})


AUTOSCALE = dict(FLEET, scenario=dict(prompt_len=512, crowd_prefix_len=448,
                                      max_new_tokens=64, crowd_n=16,
                                      n_background=8), max_waves=10)
#: the four endpoints' top-level keys (JAX's ``introspect.py`` over a
#: FleetRouter's ``requests_table``)
STATUSZ_KEYS = {"schema", "t", "uptime_s", "pid", "rank", "tracing_enabled",
                "current_span", "last_phase", "flight_ring", "providers"}


class _Recording:
    """The router ``run_scenario`` drives, keeping each accepted request's
    handle and its submit time."""

    def __init__(self, router):
        self._router = router
        self.handles = []

    def __getattr__(self, name):
        return getattr(self._router, name)

    def submit(self, *args, **kw):
        h = self._router.submit(*args, **kw)
        self.handles.append((time.monotonic(), h))
        return h


def _scrape_statusz(port):
    """GET each of the four endpoints once: their payloads, parsed (the
    Prometheus text of ``/metricsz`` by its parser)."""
    import urllib.request

    from chainermn_tpu_torch.observability.export import (
        parse_prometheus_text)

    out = {}
    for path in ("/statusz", "/metricsz", "/requestz", "/debugz"):
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as r:
            body = r.read().decode()
        out[path] = (parse_prometheus_text(body) if path == "/metricsz"
                     else json.loads(body))
    return out


def phase_serving_autoscale(smoke):
    """The autoscaler on the cross-process fleet at the decode-bench LM's
    full width (bf16): ``build_proc_fleet({"engine": 1})`` with a
    ``FleetAutoscaler(proc_spawn_factory, AutoscalePolicy(min_workers=1,
    max_workers=2))``; flash crowds (``build_scenario("flash_crowd")`` at
    the serving sizes) replayed by ``run_scenario`` back to back until the
    worker the scale-up spawned holds its lease, one more crowd on the two
    workers, then no load until the autoscaler drains back to one.  The
    status server runs throughout and each endpoint is read once.  Every
    worker process (the spawned one too) reports its launch counts."""
    import tempfile
    import threading

    import numpy as np

    torch = smoke.torch
    from chainermn_tpu_torch.observability import start_status_server
    from chainermn_tpu_torch.serving import (AutoscalePolicy,
                                             FleetAutoscaler, ServingEngine,
                                             build_scenario,
                                             materialize_prompt,
                                             run_scenario)
    from chainermn_tpu_torch.serving.autoscale import proc_spawn_factory

    cfg = AUTOSCALE
    params = _init_full(torch, "cuda", torch.bfloat16, cfg["max_total"])
    report_dir = Path(tempfile.mkdtemp(prefix="chainermn_autoscale_"))
    router, info = _fleet_up(smoke, params, {"engine": 1},
                             dict(n_slots=cfg["slots"],
                                  max_total=cfg["max_total"],
                                  queue_capacity=cfg["queue"]), report_dir)
    auto = FleetAutoscaler(
        router, proc_spawn_factory(
            info["lane_dir"], str(Path(info["lane_dir"])
                                  / "fleet_params.pkl"),
            device="cuda",
            worker_cmd=[sys.executable, str(ROOT / "chip_smoke.py"),
                        "--fleet-worker", str(report_dir)]),
        policies=[AutoscalePolicy(min_workers=1, max_workers=2)])
    policy = auto.policies["engine"]
    # the first monotonic time each spawned worker is seen holding a lease
    live_t, watching = {}, threading.Event()

    def watch():
        while not watching.is_set():
            for name, w in list(router.workers.items()):
                if name != "engine0" and w.state == "live":
                    live_t.setdefault(name, time.monotonic())
            time.sleep(0.002)

    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    srv = start_status_server(0, extra_gauges=router.metrics,
                              requests_fn=router.requests_table)
    rec, waves, rows = _Recording(router), [], []
    endpoints, victim = None, None
    router.start()
    t0 = time.monotonic()
    try:
        for k in range(cfg["max_waves"]):
            two = bool(live_t)      # the spawned worker is live already
            events = build_scenario("flash_crowd", seed=k, **cfg["scenario"])
            n0 = len(rec.handles)
            rows.append(run_scenario(events, rec, vocab=FULL["vocab"],
                                     max_attempts=3,
                                     settle_timeout_s=FLEET_TIMEOUT_S))
            waves.append((events, [h for _, h in rec.handles[n0:]], two))
            if two:
                break                # the crowd on two workers is in
        if not waves[-1][2]:
            raise AssertionError(f"no scaled-up worker live after "
                                 f"{cfg['max_waves']} crowds: "
                                 f"{list(policy.decisions)}")
        endpoints = _scrape_statusz(srv.port)
        t_calm = time.monotonic()
        while not any(d["direction"] == "down" and d.get("drained")
                      for d in list(policy.decisions)):
            if time.monotonic() - t_calm > 60:
                raise AssertionError("no scale-down in 60 s of calm")
            time.sleep(0.05)
        victim = next(d for d in list(policy.decisions)
                      if d["direction"] == "down")["drained"][0]
        if not router.wait_drained(victim, timeout_s=60):
            raise AssertionError(f"autoscale victim {victim} not drained")
        m = router.metrics()
    finally:
        auto.stop()
        router.stop()
        srv.stop()
        watching.set()
        watcher.join(timeout=5)
        names = list(router.workers)
        codes = _fleet_down(router, info, {n: 0 for n in names})
    wall = time.monotonic() - t0
    decisions = list(policy.decisions)
    up = next(d for d in decisions if d["direction"] == "up")
    spawned = up["spawned"][0]
    reports = _fleet_reports(report_dir)
    _fleet_check_launches("autoscale", reports, set(reports), set(reports))
    for rep in reports.values():
        smoke.add_launches(rep["launches"])
    handles = [h for _, hs, _ in waves for h in hs]
    ttft = {two: [h.ttft_ms for _, hs, t in waves if t == two for h in hs
                  if h.ttft_ms is not None] for two in (False, True)}
    ended = {"done": sum(h.status == "done" for h in handles),
             "shed": sum(h.finish_reason == "shed" for h in handles)}
    shed_at_submit = sum(r["offered_shed"] for r in rows)
    row = {"check": "serving_autoscale.run", "dtype": "bfloat16", **FLEET,
           "scenario": cfg["scenario"], "waves": len(waves),
           "wall_s": wall, "spawned": spawned,
           "decision_to_first_lease_s": live_t[spawned] - up["t"],
           "drained": victim, "exit_codes": codes,
           "ttft_ms_p50_before": _percentile(ttft[False], 0.5),
           "ttft_ms_p99_before": _percentile(ttft[False], 0.99),
           "ttft_ms_p50_after": _percentile(ttft[True], 0.5),
           "ttft_ms_p99_after": _percentile(ttft[True], 0.99),
           "requests": sum(r["n_requests"] for r in rows), "ended": ended,
           "shed_at_submit": shed_at_submit,
           "flap_count": policy.flap_count(),
           "decisions": [{k: d.get(k) for k in (
               "direction", "reason", "signal", "threshold", "before",
               "target", "t", "spawned", "drained", "signals")}
               for d in decisions],
           "fleet_shed_rate": m["fleet/shed_rate"],
           "launches": {n: r["launches"] for n, r in reports.items()},
           "card": smoke.card}
    emit(row)
    bad = []
    if spawned not in reports or not all(
            reports[spawned]["launches"][k] for k in
            ("flash_fwd", "cache_append", "decode_attend")):
        bad.append(f"the spawned worker's launches: "
                   f"{reports.get(spawned, {}).get('launches')}")
    if len(handles) + shed_at_submit != row["requests"] or any(
            h.status != "done" and h.finish_reason != "shed"
            for h in handles) or any(
            h.finish_reason == "shed" and not h.shed_payload
            for h in handles):
        bad.append(f"requests not ended exactly once: {ended}, "
                   f"{shed_at_submit} shed at submit of {row['requests']}")
    if policy.flap_count() or codes.get(victim) != 0:
        bad.append(f"flaps {policy.flap_count()}, exit codes {codes}")
    st = endpoints["/statusz"]
    if set(st) != STATUSZ_KEYS or "fleet_health" not in st["providers"] \
            or "autoscale" not in st["providers"]["fleet_health"] \
            or set(endpoints["/requestz"]) != set(router.requests_table()) \
            or set(endpoints["/debugz"]) != {"last_bundle"} \
            or "chainermn_tpu_fleet_dispatched_total" not in \
            endpoints["/metricsz"]["families"]:
        bad.append(f"endpoints: statusz {sorted(st)}, requestz "
                   f"{sorted(endpoints['/requestz'])}, debugz "
                   f"{sorted(endpoints['/debugz'])}")
    if bad:
        raise AssertionError("; ".join(bad))
    # greedy tokens against the fused engine: the first crowd and the
    # crowd on two workers
    fused = ServingEngine(params, head_dim=HEAD_DIM, n_slots=cfg["slots"],
                          max_total=cfg["max_total"], queue_capacity=64,
                          prefix_cache=False, spill_bytes=0, device="cuda")
    for label, (events, hs, _) in (("first", waves[0]),
                                   ("two_workers", waves[-1])):
        specs = [ev for ev in events if ev["kind"] == "request"]
        done = [(ev, h) for ev, h in zip(specs, hs) if h.status == "done"]
        prompts = [np.asarray(materialize_prompt(ev["prompt"],
                                                 FULL["vocab"]), np.int32)
                   for ev, _ in done]
        want = [h.tokens for h in
                _drive_all(fused, prompts, cfg["scenario"]["max_new_tokens"],
                           False)[0]]
        equal, near = _near_ties(
            f"autoscale_{label}", [h.tokens for _, h in done], want,
            lambda i, t: _card_choice_values(params, prompts[i], want[i], t))
        emit({"check": "serving_autoscale.tokens", "crowd": label,
              "rows": len(done), "equal_to_fused": equal,
              "near_ties": len(near)})
    fused.close()
    emit({"check": "serving_autoscale.endpoints",
          "statusz_keys": sorted(st), "requestz_keys": sorted(
              endpoints["/requestz"]), "debugz": endpoints["/debugz"],
          "metricsz_families": len(endpoints["/metricsz"]["families"])})


def _tree_to(torch, params, device):
    from chainermn_tpu_torch.convert import tree_map

    return tree_map(params, lambda t: t.detach().to(device).clone())


def _make_step(torch, params, head_dim, ce_impl, lr=1e-2):
    """The training step the smoke drives: SGD through
    ``make_hybrid_shard_map_step`` with flash attention, updating
    ``params`` in place."""
    from functools import partial

    from chainermn_tpu_torch.parallel import (make_hybrid_shard_map_step,
                                              param_leaves,
                                              tp_transformer_lm_loss)

    return make_hybrid_shard_map_step(
        partial(tp_transformer_lm_loss, head_dim=head_dim, attn_impl="flash",
                ce_impl=ce_impl),
        torch.optim.SGD(param_leaves(params), lr=lr), params)


def _train_run(torch, step, params, steps, tokens):
    """``steps`` calls of ``step``; returns (losses, per-step ms), each
    step ended by the device-to-host read of its loss and a synchronise."""
    losses, ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(step(params, (tokens,))))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return losses, ms


def phase_train_parity(smoke):
    """fp32, card vs CPU: two SGD steps from the same weights."""
    import numpy as np

    torch = smoke.torch
    from chainermn_tpu_torch.convert import flatten
    from chainermn_tpu_torch.parallel import (init_tp_transformer_lm,
                                              tp_transformer_lm_loss)

    seq, batch = 256, 2
    cfg = dict(TRAIN, n_layers=2)
    head_dim = cfg["d_model"] // cfg["n_heads"]
    cpu = init_tp_transformer_lm(torch.Generator().manual_seed(3),
                                 max_len=seq, device="cpu", **cfg)
    tokens = np.random.RandomState(8).randint(
        0, cfg["vocab"], (batch, seq + 1))
    runs, grads = {}, {}
    for dev in ("cuda", "cpu"):
        params = _tree_to(torch, cpu, dev)
        batch_t = (torch.as_tensor(tokens, device=dev),)
        flat = flatten(params)
        for leaf in flat.values():
            leaf.requires_grad_(True)
        loss = tp_transformer_lm_loss(params, batch_t, head_dim=head_dim,
                                      attn_impl="flash", ce_impl="fused")
        grads[dev] = {k: g.detach().cpu() for k, g in zip(
            flat, torch.autograd.grad(loss, list(flat.values())))}
        del loss
        step = _make_step(torch, params, head_dim, "fused")
        losses = [float(step(params, batch_t)) for _ in range(2)]
        runs[dev] = (losses, {k: v.detach().float().cpu()
                              for k, v in flat.items()})
    (lc, pc), (lh, ph) = runs["cuda"], runs["cpu"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(lc, lh))
    worst = max(float((pc[k] - ph[k]).abs().max()) for k in ph)
    grad_rel = {k: float((grads["cuda"][k] - g).norm()
                         / g.norm().clamp_min(1e-30))
                for k, g in grads["cpu"].items()}
    worst_grad = max(grad_rel, key=grad_rel.get)
    emit({"check": "train_parity", "dtype": "float32", "card_losses": lc,
          "cpu_losses": lh, "loss_max_rel_err": rel,
          "param_max_abs_err": worst, "rtol": 1e-4, "atol": 1e-4,
          "grad_max_rel_norm_err": grad_rel[worst_grad],
          "grad_worst_param": worst_grad,
          "embed_grad_rel_norm_err": grad_rel["embed"], **cfg,
          "S": seq, "B": batch})
    if rel > 1e-4 or worst > 1e-4 or grad_rel[worst_grad] > 1e-4:
        raise AssertionError(f"train parity: loss rel err {rel}, param "
                             f"abs err {worst}, grad rel norm err "
                             f"{grad_rel[worst_grad]} ({worst_grad})")


def _percentile(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


def phase_train(smoke):
    """bf16 at full width: the fused-CE path (2 warm-up + 10 timed steps),
    then 3 ``ce_impl="auto"`` steps from the same initial weights."""
    import math

    import numpy as np

    torch = smoke.torch
    from chainermn_tpu_torch import ops
    from chainermn_tpu_torch.convert import flatten
    from chainermn_tpu_torch.parallel import init_tp_transformer_lm

    head_dim = TRAIN["d_model"] // TRAIN["n_heads"]
    params = init_tp_transformer_lm(torch.Generator().manual_seed(0),
                                    max_len=TRAIN_SEQ, dtype=torch.bfloat16,
                                    device="cuda", **TRAIN)
    initial = _tree_to(torch, params, "cuda")
    tokens = torch.as_tensor(np.random.RandomState(0).randint(
        0, TRAIN["vocab"], (TRAIN_BATCH, TRAIN_SEQ + 1)), device="cuda")
    n_params = sum(t.numel() for t in flatten(params).values())
    toks = TRAIN_BATCH * TRAIN_SEQ
    flops = (6.0 * n_params
             + 12.0 * TRAIN["n_layers"] * TRAIN["d_model"] * TRAIN_SEQ) * toks
    step = _make_step(torch, params, head_dim, "fused")
    warm, _ = _train_run(torch, step, params, 2, tokens)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    losses, ms = _train_run(torch, step, params, 10, tokens)
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    smoke.add_launches(launches)
    p50 = _percentile(ms, 0.5)
    emit({"check": "train", "dtype": "bfloat16", "ce_impl": "fused",
          **TRAIN, "S": TRAIN_SEQ, "B": TRAIN_BATCH, "n_params": n_params,
          "warmup_losses": warm, "losses": losses, "step_ms": ms,
          "step_ms_p50": p50, "step_ms_p99": _percentile(ms, 0.99),
          "tokens_per_s": toks / (p50 / 1e3),
          "mfu_analytic": flops / (p50 / 1e3) / PEAK_FLOPS["bfloat16"],
          "peak_mem_gb": peak, "launches": launches})
    every = warm + losses
    smoke.train_losses = every          # phase tp holds its (1, 1) step to these
    if not all(math.isfinite(x) for x in every) or not every[-1] < every[0]:
        raise AssertionError(f"train losses not finite and falling: {every}")
    n_layers, n = TRAIN["n_layers"], len(losses)
    want = {"flash_fwd": n_layers * n, "flash_bwd": n_layers * n,
            "ce_stats": n, "ce_dh": n, "ce_dtable": n}
    wrong = {k: (launches[k], w) for k, w in want.items() if launches[k] != w}
    if wrong:
        raise AssertionError(f"training launches (got, want): {wrong}")
    del step, params

    ops.reset_launch_counts()
    auto, auto_ms = _train_run(torch, _make_step(torch, initial, head_dim,
                                                 "auto"), initial, 3, tokens)
    rel = abs(auto[0] - every[0]) / abs(every[0])
    emit({"check": "train", "dtype": "bfloat16", "ce_impl": "auto",
          "losses": auto, "step_ms": auto_ms,
          "first_loss_rel_err_vs_fused": rel, "rtol": 2e-2,
          "launches": ops.launch_counts()})
    if rel > 2e-2:
        raise AssertionError(f"auto vs fused first loss: rel err {rel}")


# ---------------------------------------------------------------------------
# tp: the LM at TP = 1 through the mesh path, and TP = 2 on one card
# ---------------------------------------------------------------------------

TP_ADAM_LR, TP_PARITY_STEPS = 1e-4, 3
TP_BF16 = dict(warm=1, steps=3)
TP_SERVE = dict(requests=8, prompt=512, new=16, max_total=1024, slots=8)
TP_BEAM = dict(batch=2, prompt=128, new=16, beam_size=4)
TP_FLEET = dict(requests=8, prompt=256, new=16, slots=4, max_total=512,
                n_layers=2)
TP_FLEET_BF16 = dict(requests=8, prompt=512, new=32, slots=8,
                     max_total=1024)
TP_WORKER_TIMEOUT_S = 600
TP_WIRE = "gloo host wire, one shared card"
TP_DEVICE = "cuda"          # the card the legs run on


def phase_tp(smoke):
    """The LM over the ``('data', 'model')`` mesh: the train phase's bf16
    step at TP = 1 through ``make_hybrid_shard_map_step`` on a ``(1, 1)``
    NCCL mesh (losses bit for bit the train phase's), then TP = 2 as two
    processes on this card over a gloo group (NCCL refuses two ranks of one
    communicator on one device): fp32 training parity against TP = 1, bf16
    training (times are the gloo host wire's, not NCCL's), fp32 serving
    and GQA beam 4, each held against TP = 1 on the card."""
    _tp_mesh_1x1(smoke)
    _tp_two_ranks(smoke)


def _tp_loss(head_dim, axis_name, ce_impl="fused"):
    from functools import partial

    from chainermn_tpu_torch.parallel import tp_transformer_lm_loss

    return partial(tp_transformer_lm_loss, head_dim=head_dim,
                   axis_name=axis_name, attn_impl="flash", ce_impl=ce_impl)


def _tp_train_tokens(torch):
    import numpy as np

    return torch.as_tensor(np.random.RandomState(0).randint(
        0, TRAIN["vocab"], (TRAIN_BATCH, TRAIN_SEQ + 1)), device=TP_DEVICE)


def _tp_mesh_1x1(smoke):
    torch = smoke.torch
    import torch.distributed as dist

    from chainermn_tpu_torch import ops
    from chainermn_tpu_torch.parallel import (init_tp_transformer_lm,
                                              make_hybrid_shard_map_step,
                                              param_leaves)
    from chainermn_tpu_torch.topology import init_distributed, make_nd_mesh

    want = getattr(smoke, "train_losses", None)
    if want is None:
        raise AssertionError("the train phase left no losses to hold the "
                             "(1, 1) mesh step against")
    init_distributed(TP_DEVICE)
    mesh = make_nd_mesh(("data", "model"), (1, 1))
    head_dim = TRAIN["d_model"] // TRAIN["n_heads"]
    params = init_tp_transformer_lm(torch.Generator().manual_seed(0),
                                    max_len=TRAIN_SEQ, dtype=torch.bfloat16,
                                    device=TP_DEVICE, **TRAIN)
    step = make_hybrid_shard_map_step(
        _tp_loss(head_dim, "model"),
        torch.optim.SGD(param_leaves(params), lr=1e-2), params, mesh)
    n = TP_PARITY_STEPS
    ops.reset_launch_counts()
    losses, ms = _train_run(torch, step, params, n, _tp_train_tokens(torch))
    launches = ops.launch_counts()
    smoke.add_launches(launches)
    emit({"check": "tp.mesh_1x1", "dtype": "bfloat16", "mesh": [1, 1],
          "backend": dist.get_backend(), "losses": losses,
          "train_phase_losses": want[:n], "step_ms": ms,
          "launches": launches, **TRAIN, "S": TRAIN_SEQ, "B": TRAIN_BATCH})
    if losses != want[:n]:
        raise AssertionError(f"(1, 1) mesh losses {losses} are not the "
                             f"train phase's {want[:n]} bit for bit")
    del step, params
    torch.cuda.empty_cache()


def _two_workers(smoke, flag, timeout):
    """Run ``chip_smoke.py FLAG RANK DIR`` as two processes on this card
    (a gloo group through a ``FileStore`` in ``DIR``); returns each rank's
    unpickled results and the wall seconds.  A worker that fails or
    outlives ``timeout`` fails the phase; none is left running."""
    import os
    import pickle
    import tempfile

    torch = smoke.torch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    tmp = Path(tempfile.mkdtemp(prefix="chainermn_workers_"))
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    t0 = time.monotonic()
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), flag, str(r),
         str(tmp)], cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = ["", ""]
    try:
        for r, p in enumerate(procs):
            logs[r] = p.communicate(timeout=timeout)[0]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise AssertionError(f"{flag} {r}: exit {p.returncode}\n"
                                 f"{logs[r][-4000:]}")
    res = []
    for r in range(2):
        with open(tmp / f"rank{r}.pkl", "rb") as fh:
            res.append(pickle.load(fh))
    return res, time.monotonic() - t0


def _tp_two_ranks(smoke):
    res, wall = _two_workers(smoke, "--tp-worker", TP_WORKER_TIMEOUT_S)
    for r in range(2):
        for leg in ("train_bf16", "serve", "beam"):
            smoke.add_launches(res[r][leg]["launches"])
        for name in TP_FLEETS:
            smoke.add_launches(res[r]["fleets"][name + "_bf16"]["launches"])
    _tp_report(smoke, res, wall)


def _tp_report(smoke, res, wall):
    """Emit the TP = 2 legs' lines and hold them to their bounds."""
    r0, r1 = res
    a, ref = r0["train_fp32"], r0["train_ref"]
    rel = max(abs(x - y) / abs(y) for x, y in zip(a["losses"],
                                                   ref["losses"]))
    emit({"check": "tp.train_fp32", "dtype": "float32", "mesh": [1, 2],
          "backend": r0["backend"], "optimizer": f"adam {TP_ADAM_LR}",
          "tp2_losses": a["losses"], "tp1_losses": ref["losses"],
          "loss_max_rel_err": rel, "rtol": 1e-4,
          "param_max_abs_err": ref["param_max_abs_err"],
          "param_worst": ref["param_worst"], "atol": 1e-4,
          "first_grads": {"rtol": 1e-4, "atol": "1e-4 * max|g| of the leaf",
                          "worst_leaf": ref["grad_worst"],
                          "worst_err_over_bound": ref["grad_worst_ratio"],
                          "worst_max_abs_err": ref["grad_worst_max_abs_err"],
                          "worst_max_abs_ref": ref["grad_worst_max_abs_ref"],
                          "replicated_vs_rank0_err_over_bound": [
                              r["train_fp32"]["replicated_grad_vs_rank0"]
                              for r in res]},
          "tp2_step_ms": a["ms"], "tp1_step_ms": ref["ms"],
          "wire": TP_WIRE, **TRAIN, "S": TRAIN_SEQ, "B": TRAIN_BATCH})
    b = [r["train_bf16"] for r in res]
    per_step = [{k: v / TP_BF16["steps"] for k, v in x["launches"].items()
                 if v} for x in b]
    tp1 = smoke.train_losses[:len(b[0]["losses"])]
    bf16_rel = max(abs(x - y) / abs(y) for x, y in zip(b[0]["losses"], tp1))
    emit({"check": "tp.train_bf16", "dtype": "bfloat16", "mesh": [1, 2],
          "wire": TP_WIRE, "losses": b[0]["losses"],
          "train_phase_losses": tp1, "loss_max_rel_err_vs_tp1": bf16_rel,
          "rtol": TOL["bfloat16"],
          "step_ms": b[0]["ms"], "step_ms_p50": _percentile(b[0]["ms"], 0.5),
          "step_ms_p99": _percentile(b[0]["ms"], 0.99),
          "launches_per_step_by_rank": per_step, "shapes": b[0]["shapes"],
          **TRAIN, "S": TRAIN_SEQ, "B": TRAIN_BATCH, "card": smoke.card})
    s, sref = r0["serve"], r0["serve_ref"]
    emit({"check": "tp.serve_fp32", "dtype": "float32", "tp": 2,
          "wire": TP_WIRE, **TP_SERVE, "sampled": s["sampled"],
          "done": s["done"], "steps": s["steps"], "wall_s": s["wall_s"],
          "tick_ms_p50": _percentile(s["tick_ms"], 0.5),
          "tick_ms_p99": _percentile(s["tick_ms"], 0.99),
          "follower_calls": r1["serve"]["follower_calls"],
          "equal_rows": sref["equal"], "near_ties": sref["near"],
          "launches_by_rank": [r["serve"]["launches"] for r in res],
          "shapes": s["shapes"]})
    m, mref = r0["beam"], r0["beam_ref"]
    emit({"check": "tp.beam_fp32", "dtype": "float32", "tp": 2,
          "kv_heads": GQA_KV_HEADS, **TP_BEAM, "wire": TP_WIRE,
          "equal_rows": mref["equal"], "near_ties": mref["near"],
          "wall_s": m["wall_s"],
          "launches_by_rank": [r["beam"]["launches"] for r in res],
          "shapes": m["shapes"]})
    for name in TP_FLEETS:
        f32, fref = r0["fleets"][name + "_fp32"], r0["fleets_ref"][name]
        emit({"check": f"tp.fleet_{name}_fp32", "dtype": "float32",
              "tp": 2, "wire": TP_WIRE, **TP_FLEET,
              "done": f32["done"], "wall_s": f32["wall_s"],
              "follower_calls": r1["fleets"][name + "_fp32"][
                  "follower_calls"],
              "equal_rows": fref["equal"], "near_ties": fref["near"]})
        b16 = [r["fleets"][name + "_bf16"] for r in res]
        emit({"check": f"tp.fleet_{name}_bf16", "dtype": "bfloat16",
              "tp": 2, "wire": TP_WIRE, **TP_FLEET_BF16,
              **{k: v for k, v in b16[0].items() if k != "launches"},
              "follower_calls": b16[1]["follower_calls"],
              "launches_by_rank": [x["launches"] for x in b16],
              "card": smoke.card})
    emit({"check": "tp.workers", "wall_s": wall, "card": smoke.card})
    bad = []
    if rel > 1e-4 or ref["param_max_abs_err"] > 1e-4:
        bad.append(f"fp32 TP=2 vs TP=1: loss rel err {rel}, param abs err "
                   f"{ref['param_max_abs_err']} ({ref['param_worst']})")
    if ref["grad_worst_ratio"] > 1:
        bad.append(f"fp32 TP=2 vs TP=1 first gradients: {ref['grad_worst']} "
                   f"off by {ref['grad_worst_max_abs_err']} (max |g| "
                   f"{ref['grad_worst_max_abs_ref']}), "
                   f"{ref['grad_worst_ratio']} times the bound")
    for r, x in enumerate(res):
        ratio, leaf = x["train_fp32"]["replicated_grad_vs_rank0"]
        if ratio > 1:
            bad.append(f"rank {r}: replicated {leaf}'s gradient is not rank "
                       f"0's ({ratio} times the bound)")
    losses = b[0]["losses"]
    if not all(x == x and abs(x) < 1e9 for x in losses) \
            or not losses[-1] < losses[0]:
        bad.append(f"bf16 TP=2 losses not finite and falling: {losses}")
    if bf16_rel > TOL["bfloat16"]:
        bad.append(f"bf16 TP=2 losses vs the train phase's TP=1: rel err "
                   f"{bf16_rel} > {TOL['bfloat16']}")
    n_layers = TRAIN["n_layers"]
    want = {"flash_fwd": n_layers, "flash_bwd": n_layers, "ce_stats": 1,
            "ce_dh": 1, "ce_dtable": 1}
    for r, ps in enumerate(per_step):
        wrong = {k: (ps.get(k), w) for k, w in want.items()
                 if ps.get(k) != w}
        if wrong:
            bad.append(f"bf16 TP=2 rank {r} launches a step (got, want): "
                       f"{wrong}")
    if s["done"] != TP_SERVE["requests"]:
        bad.append(f"TP=2 serving: {s['done']} requests done")
    for r in res:
        ls, lb = r["serve"]["launches"], r["beam"]["launches"]
        if not (ls["decode_attend"] and ls["cache_append"]
                and ls["flash_fwd"] and lb["beam_attend"]
                and lb["cache_append"] and lb["flash_fwd"]):
            bad.append(f"TP=2 serving / beam launches: {ls} / {lb}")
    for name in TP_FLEETS:
        f32 = r0["fleets"][name + "_fp32"]
        b16 = [r["fleets"][name + "_bf16"] for r in res]
        if f32["done"] != TP_FLEET["requests"] \
                or b16[0]["done"] != TP_FLEET_BF16["requests"]:
            bad.append(f"TP=2 fleet {name}: {f32['done']} fp32 and "
                       f"{b16[0]['done']} bf16 requests done")
        for r, x in enumerate(b16):
            ln = x["launches"]
            if not (ln["flash_fwd"] and ln["cache_append"]
                    and ln["decode_attend"]):
                bad.append(f"TP=2 fleet {name} rank {r} launches: {ln}")
    if bad:
        raise AssertionError("; ".join(bad))


def tp_worker(rank, tmp):
    """One of the two TP = 2 processes of phase ``tp`` on ``cuda:0``: a
    gloo group through a ``FileStore`` in ``tmp``, the legs, then (rank 0,
    after the group is gone) the TP = 1 references on the card; pickles
    its results to ``tmp/rank<r>.pkl``."""
    import datetime
    import pickle

    import torch
    import torch.distributed as dist

    from chainermn_tpu_torch.topology import make_nd_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    tmp = Path(tmp)
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp / "store"),
                                                         2),
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=180))
    mesh = make_nd_mesh(("data", "model"), (1, 2))
    serve_mesh = make_nd_mesh(("model",), (2,))
    out = {"backend": dist.get_backend()}
    out["train_fp32"], train_keep = _tp_leg_train_fp32(torch, mesh)
    out["train_bf16"] = _tp_leg_train_bf16(torch, mesh)
    out["serve"], serve_keep = _tp_leg_serve(torch, serve_mesh)
    out["beam"], beam_keep = _tp_leg_beam(torch, serve_mesh)
    out["fleets"], fleets_keep = _tp_leg_fleets(torch, serve_mesh)
    dist.destroy_process_group()
    if rank == 0:
        torch.cuda.empty_cache()
        out["train_ref"] = _tp_ref_train(torch, *train_keep)
        out["serve_ref"] = _tp_ref_serve(torch, *serve_keep)
        out["beam_ref"] = _tp_ref_beam(torch, *beam_keep)
        params, prompts, sample, rows = fleets_keep
        out["fleets_ref"] = {
            name: _tp_ref_serve(torch, params, prompts, sample, r)
            for name, r in rows.items()}
    with open(tmp / f"rank{rank}.pkl", "wb") as fh:
        pickle.dump(out, fh)
    return 0


def _keep_first_grads(optimizer, params):
    """Wrap ``optimizer.step`` so that its first call keeps a copy of
    every leaf's gradient, in a tree like ``params``: the first step's
    gradients, after the step's reductions and before the update."""
    from chainermn_tpu_torch.convert import tree_map

    kept, step = {}, optimizer.step

    def first(*args, **kwargs):
        if not kept:
            kept["grads"] = tree_map(params,
                                     lambda t: t.grad.detach().clone())
        return step(*args, **kwargs)

    optimizer.step = first
    return kept


def _grad_err(got, want):
    """Per leaf, ``|got - want| <= 1e-4·|want| + 1e-4·max|want|``: the
    worst leaf by its largest error over that bound, as ``(ratio, leaf,
    max abs err, max |want|)``.  A leaf's gradient off by a constant
    factor (a sum over the model axis where there should be none) breaks
    it, which Adam's update, blind to a leaf's scale, does not show."""
    import numpy as np

    worst = (0.0, None, 0.0, 0.0)
    for name, w in want.items():
        top = float(np.abs(w).max())
        err = np.abs(got[name] - w)
        ratio = float((err / (1e-4 * np.abs(w) + 1e-4 * top + 1e-30)).max())
        if ratio >= worst[0]:
            worst = (ratio, name, float(err.max()), top)
    return worst


def _tp_leg_train_fp32(torch, mesh):
    """fp32 at full width, 3 Adam steps at TP = 2; keeps the initial global
    params, the first step's gradients and the final params, each gathered
    by ``gather_to_numpy``, for the TP = 1 reference.  Each replicated
    leaf's first gradient is also held to model rank 0's."""
    from chainermn_tpu_torch.convert import (flatten, gather_to_numpy,
                                             shard_from_jax)
    from chainermn_tpu_torch.ops import collective as col
    from chainermn_tpu_torch.parallel import (init_tp_transformer_lm,
                                              make_hybrid_train_step,
                                              param_leaves,
                                              transformer_lm_specs)

    params = init_tp_transformer_lm(torch.Generator().manual_seed(0),
                                    max_len=TRAIN_SEQ, device="cpu", **TRAIN)
    specs = transformer_lm_specs(params, "model")
    local = shard_from_jax(params, specs, mesh, device=TP_DEVICE)
    head_dim = TRAIN["d_model"] // TRAIN["n_heads"]
    optimizer = torch.optim.Adam(param_leaves(local), lr=TP_ADAM_LR)
    kept = _keep_first_grads(optimizer, local)
    step = make_hybrid_train_step(_tp_loss(head_dim, "model"), optimizer,
                                  local, mesh)
    losses, ms = _train_run(torch, step, local, TP_PARITY_STEPS,
                            _tp_train_tokens(torch))
    rep = (0.0, None)          # replicated leaves: this rank vs rank 0
    for (name, g), spec in zip(flatten(kept["grads"]).items(),
                               flatten(specs).values()):
        if any(spec):
            continue
        g0 = col.bcast(g.clone(), 0, mesh.axis("model"))
        ratio = float(((g - g0).abs() / (1e-4 * g0.abs()
                                         + 1e-4 * g0.abs().max()
                                         + 1e-30)).max())
        if ratio >= rep[0]:
            rep = (ratio, name)
    grads = gather_to_numpy(kept["grads"], specs, mesh)
    gathered = gather_to_numpy(local, specs, mesh)
    del step, local, kept, optimizer
    torch.cuda.empty_cache()
    return ({"losses": losses, "ms": ms, "replicated_grad_vs_rank0": rep},
            (params, losses, grads, gathered))


def _tp_ref_train(torch, params, tp2_losses, tp2_grads, gathered):
    """The same 3 Adam steps at TP = 1 on the card: TP = 2's first-step
    gradients against these (:func:`_grad_err`), and the largest parameter
    difference from TP = 2's gathered params after the steps."""
    import numpy as np

    from chainermn_tpu_torch.convert import flatten, to_numpy
    from chainermn_tpu_torch.parallel import (make_hybrid_shard_map_step,
                                              param_leaves)

    head_dim = TRAIN["d_model"] // TRAIN["n_heads"]
    p = _tree_to(torch, params, TP_DEVICE)
    optimizer = torch.optim.Adam(param_leaves(p), lr=TP_ADAM_LR)
    kept = _keep_first_grads(optimizer, p)
    step = make_hybrid_shard_map_step(_tp_loss(head_dim, None), optimizer, p)
    losses, ms = _train_run(torch, step, p, TP_PARITY_STEPS,
                            _tp_train_tokens(torch))
    grad = _grad_err(flatten(tp2_grads), flatten(to_numpy(kept["grads"])))
    ref, got = flatten(to_numpy(p)), flatten(gathered)
    errs = {name: float(np.abs(got[name] - w).max())
            for name, w in ref.items()}
    worst = max(errs, key=errs.get)
    del step, p, kept, optimizer
    torch.cuda.empty_cache()
    return {"losses": losses, "ms": ms, "param_max_abs_err": errs[worst],
            "param_worst": worst, "grad_worst_ratio": grad[0],
            "grad_worst": grad[1], "grad_worst_max_abs_err": grad[2],
            "grad_worst_max_abs_ref": grad[3]}


def _tp_leg_train_bf16(torch, mesh):
    """bf16 at full width, SGD 1e-2 as the train phase: 2 warm-up and 10
    timed steps at TP = 2, launch counts zeroed just before the timed
    steps and read just after."""
    from chainermn_tpu_torch import ops
    from chainermn_tpu_torch.convert import shard_from_jax
    from chainermn_tpu_torch.parallel import (init_tp_transformer_lm,
                                              make_hybrid_train_step,
                                              param_leaves,
                                              transformer_lm_specs)

    params = init_tp_transformer_lm(torch.Generator().manual_seed(0),
                                    max_len=TRAIN_SEQ, device="cpu", **TRAIN)
    local = shard_from_jax(params, transformer_lm_specs(params, "model"),
                           mesh, device=TP_DEVICE, dtype=torch.bfloat16)
    del params
    head_dim = TRAIN["d_model"] // TRAIN["n_heads"]
    step = make_hybrid_train_step(
        _tp_loss(head_dim, "model"),
        torch.optim.SGD(param_leaves(local), lr=1e-2), local, mesh)
    tokens = _tp_train_tokens(torch)
    warm, _ = _train_run(torch, step, local, TP_BF16["warm"], tokens)
    ops.reset_launch_counts()
    losses, ms = _train_run(torch, step, local, TP_BF16["steps"], tokens)
    launches = ops.launch_counts()
    h = TRAIN["n_heads"] // 2
    shapes = {"flash": [TRAIN_BATCH, TRAIN_SEQ, h, head_dim],
              "ce": [TRAIN_BATCH * TRAIN_SEQ, TRAIN["vocab"] // 2,
                     TRAIN["d_model"]]}
    del step, local
    torch.cuda.empty_cache()
    return {"losses": warm + losses, "ms": ms, "launches": launches,
            "shapes": shapes}


def _tp_leg_serve(torch, mesh):
    """fp32, the decode-bench LM sharded over two ranks: 8 requests (the
    odd half sampled) through ``ServingEngine(mesh=...)``; rank 0 drives,
    rank 1 follows.  Launch counts zeroed just before and read after."""
    import numpy as np

    from chainermn_tpu_torch import ops
    from chainermn_tpu_torch.convert import shard_from_jax
    from chainermn_tpu_torch.parallel import transformer_lm_specs
    from chainermn_tpu_torch.serving import ServingEngine

    cfg = TP_SERVE
    params = _init_full(torch, "cpu", torch.float32, cfg["max_total"])
    local = shard_from_jax(params, transformer_lm_specs(params, "model"),
                           mesh, device=TP_DEVICE)
    eng = ServingEngine(local, head_dim=HEAD_DIM, n_slots=cfg["slots"],
                        max_total=cfg["max_total"],
                        queue_capacity=cfg["requests"], mesh=mesh,
                        device=TP_DEVICE)
    prompts = np.random.RandomState(5).randint(
        0, FULL["vocab"], (cfg["requests"], cfg["prompt"])).astype(np.int32)
    sample = _half_sampled(cfg["requests"], 7)
    tick_ms = []
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    if eng.engine.leader:
        tick = eng.engine.tick

        def timed(*a, **k):
            t = time.perf_counter()
            nxt = tick(*a, **k)           # ends in a device-to-host read
            tick_ms.append((time.perf_counter() - t) * 1e3)
            return nxt

        eng.engine.tick = timed
        try:      # the follower waits in follow() until the leader closes
            handles, steps = _drive(eng, list(prompts), cfg["new"],
                                    cfg["slots"], 2, sample)
        finally:
            eng.close()
        rows = [h.tokens for h in handles]
        done = sum(h.status == "done" for h in handles)
        calls = None
    else:
        calls = eng.follow()
        rows, done, steps = None, None, None
    torch.cuda.synchronize()
    res = {"launches": ops.launch_counts(), "wall_s": time.perf_counter() - t0,
           "tick_ms": tick_ms, "done": done, "steps": steps,
           "sampled": sorted(sample), "follower_calls": calls,
           "shapes": {"decode": [cfg["slots"], FULL["n_heads"] // 2,
                                 HEAD_DIM, cfg["max_total"]],
                      "prefill_flash": [1, cfg["prompt"],
                                        FULL["n_heads"] // 2, HEAD_DIM]}}
    del eng, local
    torch.cuda.empty_cache()
    return res, (params, prompts, sample, rows)


#: the in-process fleets of the TP = 2 legs: name -> builder keywords
TP_FLEETS = {"disagg_local": ("disagg", "local"),
             "disagg_lanes": ("disagg", "lanes"),
             "replicas": ("replicas", None)}


def _tp_fleet(name, local, mesh, slots, max_total):
    """One in-process fleet at TP = 2 over this rank's shards: rank 0
    hosts the router and every engine, rank 1 mirrors them."""
    from chainermn_tpu_torch.serving import build_disagg_fleet, build_fleet

    kind, transport = TP_FLEETS[name]
    if kind == "disagg":
        return build_disagg_fleet(local, 1, 1, head_dim=HEAD_DIM,
                                  max_total=max_total, n_slots=slots,
                                  staging_slots=2, queue_capacity=32,
                                  mesh=mesh, transport_mode=transport,
                                  device=TP_DEVICE)
    return build_fleet(local, 2, head_dim=HEAD_DIM, n_slots=slots,
                       max_total=max_total, queue_capacity=32, mesh=mesh,
                       device=TP_DEVICE)


def _tp_fleet_gaps(fleet):
    """The decode tick gaps (ms) of a fleet's ticking engines."""
    engines = ([dw.engine for dw in fleet.decode_workers]
               if hasattr(fleet, "decode_workers")
               else [rep.engine for rep in fleet.replicas])
    return [g for e in engines for g in e._tick_gap_ms.values()]


def _tp_leg_fleets(torch, mesh):
    """The in-process fleets at TP = 2: ``build_disagg_fleet(1, 1)`` with
    the local and the lanes transport, and ``build_fleet(2)``, each with
    rank 0 hosting the whole fleet and rank 1 following its one plan.
    fp32 at 2 layers (the full width otherwise): 8 requests, the odd half
    sampled, under ``run()`` (the caller holds the rows against TP = 1 on
    the card).  Then bf16 at the full width under ``start()`` (the role
    or replica threads announce their device calls concurrently), the
    tick gap and TTFT timed; launch counts zeroed just before each bf16
    drive and read after it."""
    import numpy as np

    from chainermn_tpu_torch import ops
    from chainermn_tpu_torch.convert import shard_from_jax
    from chainermn_tpu_torch.parallel import (init_tp_transformer_lm,
                                              transformer_lm_specs)

    def shard(params):
        return shard_from_jax(params, transformer_lm_specs(params, "model"),
                              mesh, device=TP_DEVICE)

    cfg = TP_FLEET
    p32 = init_tp_transformer_lm(
        torch.Generator().manual_seed(4), max_len=cfg["max_total"],
        dtype=torch.float32, device="cpu",
        **dict(FULL, n_layers=cfg["n_layers"]))
    local = shard(p32)
    prompts = np.random.RandomState(11).randint(
        0, FULL["vocab"], (cfg["requests"], cfg["prompt"])).astype(np.int32)
    sample = _half_sampled(cfg["requests"], 9)
    res, rows = {}, {}
    for name in TP_FLEETS:
        t0 = time.perf_counter()
        fleet = _tp_fleet(name, local, mesh, cfg["slots"], cfg["max_total"])
        if fleet.leader:
            try:     # the follower waits in follow() until the leader closes
                hs = [fleet.submit(p, cfg["new"], **sample.get(i, {}))
                      for i, p in enumerate(prompts)]
                fleet.run()
            finally:
                fleet.close()
            rows[name] = [h.tokens for h in hs]
            res[name + "_fp32"] = {
                "done": sum(h.status == "done" for h in hs),
                "wall_s": time.perf_counter() - t0}
        else:
            res[name + "_fp32"] = {"follower_calls": fleet.follow(),
                                   "wall_s": time.perf_counter() - t0}
    del local
    cfg = TP_FLEET_BF16
    local = shard(_init_full(torch, "cpu", torch.bfloat16,
                             cfg["max_total"]))
    prompts16 = list(np.random.RandomState(12).randint(
        0, FULL["vocab"], (cfg["requests"], cfg["prompt"])).astype(np.int32))
    for name in TP_FLEETS:
        fleet = _tp_fleet(name, local, mesh, cfg["slots"], cfg["max_total"])
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        row = {}
        if fleet.leader:
            try:
                hs, wall = _drive_all(fleet, prompts16, cfg["new"], True)
                gaps = _tp_fleet_gaps(fleet)
            finally:
                fleet.close()
            row = {"done": sum(h.status == "done"
                               and len(h.tokens) == cfg["new"] for h in hs),
                   "wall_s": wall,
                   "ttft_ms_p50": _percentile([h.ttft_ms for h in hs], 0.5),
                   "ttft_ms_p99": _percentile([h.ttft_ms for h in hs], 0.99),
                   "tick_gap_ms_p50": _percentile(gaps, 0.5),
                   "tick_gap_ms_p99": _percentile(gaps, 0.99)}
        else:
            row = {"follower_calls": fleet.follow(),
                   "wall_s": time.perf_counter() - t0}
        torch.cuda.synchronize()
        row["launches"] = ops.launch_counts()
        res[name + "_bf16"] = row
    del local
    torch.cuda.empty_cache()
    return res, (p32, prompts, sample, rows)


def _tp_choice_values(torch, params, prompt, row, sample_kw):
    """TP = 1 on the card, teacher-forced on a TP = 2 row: the values the
    token choice compares at each generated position (the logits, or a
    sampled row's ``logits / T`` plus the noise TP = 2 draws: each shard's
    ``(1, V/2)`` uniform from ``fold_in(fold_in(key, pos), rank)``)."""
    import numpy as np

    from chainermn_tpu_torch import prng
    from chainermn_tpu_torch.parallel.decode import lm_prefill

    s_p = len(prompt)
    full = np.concatenate([prompt, np.asarray(row[:-1], np.int32)])
    with torch.inference_mode():
        h, _ = lm_prefill(params, torch.tensor(full[None], device=TP_DEVICE,
                                               dtype=torch.long),
                          len(full), head_dim=HEAD_DIM)
        logits = (h[0, s_p - 1:].float() @ params["embed"].float().t()).cpu()
    if not sample_kw:
        return logits
    half = logits.shape[1] // 2
    noise = torch.stack([torch.cat([prng.gumbel(prng.fold_in(prng.fold_in(
        sample_kw["rng"], s_p + t), r), (1, half))[0] for r in range(2)])
        for t in range(len(row))])
    return logits / sample_kw["temperature"] + noise


def _tp_ref_serve(torch, params, prompts, sample, rows):
    """Each TP = 2 row, position by position: the TP = 1 model's choice on
    the card, or a near-tie (the two tokens' values within 1e-3)."""
    p = _tree_to(torch, params, TP_DEVICE)
    equal, near = 0, []
    for i, row in enumerate(rows):
        vals = _tp_choice_values(torch, p, prompts[i], row, sample.get(i))
        ok = True
        for t, tok in enumerate(row):
            best = int(vals[t].argmax())
            if best != tok:
                gap = float(vals[t, best] - vals[t, tok])
                if gap >= 1e-3:
                    raise AssertionError(
                        f"TP=2 serving row {i} step {t}: token {tok}, TP=1 "
                        f"picks {best} by {gap} >= 1e-3")
                near.append((i, t, gap))
                ok = False
        equal += ok
    del p
    torch.cuda.empty_cache()
    return {"equal": equal, "near": near}


def _tp_leg_beam(torch, mesh):
    """fp32, the GQA model (4 KV heads: 2 a rank) sharded over two ranks:
    beam 4 through ``make_lm_beam_generator(mesh, 'model')``."""
    import numpy as np

    from chainermn_tpu_torch import ops
    from chainermn_tpu_torch.convert import shard_from_jax
    from chainermn_tpu_torch.parallel import (make_lm_beam_generator,
                                              transformer_lm_specs)

    cfg = TP_BEAM
    params = _init_full(torch, "cpu", torch.float32,
                        cfg["prompt"] + cfg["new"], n_kv_heads=GQA_KV_HEADS)
    local = shard_from_jax(params, transformer_lm_specs(params, "model"),
                           mesh, device=TP_DEVICE)
    prompts = np.random.RandomState(10).randint(
        0, FULL["vocab"], (cfg["batch"], cfg["prompt"])).astype(np.int32)
    gen = make_lm_beam_generator(mesh, "model", head_dim=HEAD_DIM,
                                 max_new_tokens=cfg["new"],
                                 beam_size=cfg["beam_size"])
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    toks = gen(local, prompts).cpu().numpy()
    res = {"launches": ops.launch_counts(), "wall_s": time.perf_counter() - t0,
           "shapes": {"kv_heads_per_rank": GQA_KV_HEADS // 2,
                      "g": FULL["n_heads"] // GQA_KV_HEADS,
                      "rows": cfg["batch"] * cfg["beam_size"]}}
    del local, gen
    torch.cuda.empty_cache()
    return res, (params, prompts, toks)


def _tp_ref_beam(torch, params, prompts, toks):
    """TP = 1 beam 4 on the card: the best beams equal, or TP = 2's within
    1e-3 of TP = 1's cumulative log-probability under the TP = 1 model."""
    import numpy as np

    from chainermn_tpu_torch.parallel import make_lm_beam_generator
    from chainermn_tpu_torch.parallel.decode import lm_prefill

    p = _tree_to(torch, params, TP_DEVICE)
    ref = make_lm_beam_generator(
        head_dim=HEAD_DIM, max_new_tokens=TP_BEAM["new"],
        beam_size=TP_BEAM["beam_size"])(p, prompts).cpu().numpy()

    def logprob(prompt, row):
        full = np.concatenate([prompt, row])
        with torch.inference_mode():
            h, _ = lm_prefill(p, torch.tensor(full[None], device=TP_DEVICE,
                                              dtype=torch.long),
                              len(full), head_dim=HEAD_DIM)
            logp = torch.log_softmax(h[0, len(prompt) - 1:-1].float()
                                     @ p["embed"].float().t(), -1)
        return float(logp.gather(1, torch.tensor(
            row, device=TP_DEVICE, dtype=torch.long)[:, None]).sum())

    equal, near = 0, []
    for i in range(len(prompts)):
        if (toks[i] == ref[i]).all():
            equal += 1
            continue
        gap = abs(logprob(prompts[i], toks[i]) - logprob(prompts[i], ref[i]))
        if gap >= 1e-3:
            raise AssertionError(f"TP=2 beam row {i}: {toks[i].tolist()} vs "
                                 f"TP=1 {ref[i].tolist()}, log-prob gap {gap}")
        near.append((i, gap))
    del p
    torch.cuda.empty_cache()
    return {"equal": equal, "near": near}


SP = dict(seq=8192, batch=2, ranks=2)   # global S, B, the 'sp' axis
SP_ADAM_LR, SP_PARITY_STEPS = 1e-4, 3
SP_BF16 = dict(warm=1, steps=3)
SP_MOE_STEPS = 20
SP_PIPE = dict(batch=16, d=8, microbatches=4)  # tests/test_pipeline.py
SP_WORKER_TIMEOUT_S = 600
SP_IMPLS = ("ring", "ulysses")
SP_DEVICE = "cuda"          # the card the legs run on


def phase_sp(smoke):
    """The sequence-sharded LM at ``bench_transformer_lm``'s widths with
    RoPE (d 1024, 8 layers, 8 heads of 128, vocab 32,768), global S 8,192,
    B 2, SP = 2 as two processes on this card over a gloo group (NCCL
    refuses two ranks of one communicator on one device): ring attention
    and Ulysses over the flash kernels, fp32 against SP = 1 and bf16 steps
    timed (the gloo host wire's); then ``train_moe`` and the two pipelines
    at P = 2, card against CPU."""
    res, wall = _two_workers(smoke, "--sp-worker", SP_WORKER_TIMEOUT_S)
    for r in range(2):
        for impl in SP_IMPLS:
            smoke.add_launches(res[r][f"{impl}_bf16"]["launches"])
    _sp_report(smoke, res, wall)


def _sp_loss(sp_impl, axis_name="sp"):
    from functools import partial

    from chainermn_tpu_torch.parallel import sp_transformer_lm_loss

    return partial(sp_transformer_lm_loss,
                   head_dim=TRAIN["d_model"] // TRAIN["n_heads"],
                   axis_name=axis_name, attn_impl="flash", sp_impl=sp_impl)


def _sp_tokens():
    """``(inputs, targets)`` of a ``(B, S + 1)`` draw, shifted before any
    sharding (host int64)."""
    import numpy as np

    t = np.random.RandomState(0).randint(
        0, TRAIN["vocab"], (SP["batch"], SP["seq"] + 1)).astype(np.int64)
    return t[:, :-1], t[:, 1:]


def _sp_params(torch):
    from chainermn_tpu_torch.parallel import init_tp_transformer_lm

    return init_tp_transformer_lm(torch.Generator().manual_seed(0),
                                  max_len=SP["seq"], pos_impl="rope",
                                  device="cpu", **TRAIN)


def _sp_batch(torch, mesh):
    from chainermn_tpu_torch.parallel import P
    from chainermn_tpu_torch.parallel._factory import local_block

    return tuple(local_block(torch.as_tensor(t, device=SP_DEVICE),
                             P(None, "sp"), mesh).contiguous()
                 if mesh is not None else torch.as_tensor(t, device=SP_DEVICE)
                 for t in _sp_tokens())


def _sp_steps(torch, step, params, batch, n):
    losses, ms = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        losses.append(float(step(params, batch)))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return losses, ms


def _sp_train(torch, params, mesh, sp_impl, dtype, optimizer, steps,
              keep=False, warm=0):
    """``warm`` then ``steps`` steps of the sequence-sharded LM on the card
    (``mesh`` None: SP = 1) from ``params`` (host fp32), launch counts
    zeroed between them; returns ``{"losses" (every step), "ms" (the
    timed steps), "launches" (theirs), "grads" (the first step's, host
    fp32, with ``keep``), "final" (the params after)}``."""
    from chainermn_tpu_torch import ops
    from chainermn_tpu_torch.convert import flatten, to_numpy, tree_map
    from chainermn_tpu_torch.parallel import (make_hybrid_shard_map_step,
                                              param_leaves)

    local = tree_map(_tree_to(torch, params, SP_DEVICE), lambda t: t.to(dtype))
    opt = optimizer(param_leaves(local))
    kept = _keep_first_grads(opt, local) if keep else None
    step = make_hybrid_shard_map_step(
        _sp_loss(sp_impl, "sp" if mesh is not None else None), opt, local,
        mesh, data_axis="sp")
    batch = _sp_batch(torch, mesh)
    first, _ = _sp_steps(torch, step, local, batch, warm)
    ops.reset_launch_counts()
    losses, ms = _sp_steps(torch, step, local, batch, steps)
    out = {"losses": first + losses, "ms": ms,
           "launches": ops.launch_counts(),
           "grads": flatten(to_numpy(kept["grads"])) if keep else None,
           "final": flatten(to_numpy(local))}
    del step, local, kept, opt
    torch.cuda.empty_cache()
    return out


def sp_worker(rank, tmp):
    """One of the two SP = 2 processes of phase ``sp`` on ``cuda:0``: a
    gloo group through a ``FileStore`` in ``tmp``, the legs, then (rank 0,
    after the group is gone) the SP = 1 references on the card; pickles
    its results to ``tmp/rank<r>.pkl``."""
    import datetime
    import pickle

    import torch
    import torch.distributed as dist

    from chainermn_tpu_torch.topology import make_nd_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    tmp = Path(tmp)
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp / "store"),
                                                         2),
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=180))
    mesh = make_nd_mesh(("sp",), (SP["ranks"],))
    params = _sp_params(torch)
    out, keep = {"backend": dist.get_backend()}, {}
    for impl in SP_IMPLS:
        run = _sp_train(torch, params, mesh, impl, torch.float32, _sp_adam,
                        SP_PARITY_STEPS, keep=True)
        out[f"{impl}_fp32"] = {"losses": run["losses"], "ms": run["ms"]}
        keep[impl] = (run["grads"], run["final"])
    for impl in SP_IMPLS:
        run = _sp_train(torch, params, mesh, impl, torch.bfloat16, _sp_sgd,
                        SP_BF16["steps"], warm=SP_BF16["warm"])
        out[f"{impl}_bf16"] = {k: run[k] for k in ("losses", "ms",
                                                    "launches")}
    out["moe"] = _sp_leg_moe()
    out["pipe"] = _sp_leg_pipe(torch, mesh)
    dist.destroy_process_group()
    if rank == 0:
        out["ref"] = _sp_ref(torch, params, keep)
    with open(tmp / f"rank{rank}.pkl", "wb") as fh:
        pickle.dump(out, fh)
    return 0


def _sp_adam(leaves):
    import torch

    return torch.optim.Adam(leaves, lr=SP_ADAM_LR)


def _sp_sgd(leaves):
    import torch

    return torch.optim.SGD(leaves, lr=1e-2)


def _sp_ref(torch, params, keep):
    """SP = 1 on the card: fp32, 3 Adam steps (losses; SP = 2's first-step
    gradients per leaf by :func:`_grad_err`; the largest parameter
    difference after the steps) and bf16, SGD, 1 + 3 steps (losses, step
    ms)."""
    import numpy as np

    run = _sp_train(torch, params, None, "ring", torch.float32, _sp_adam,
                    SP_PARITY_STEPS, keep=True)
    out = {"fp32_losses": run["losses"], "fp32_ms": run["ms"]}
    for impl, (g2, p2) in keep.items():
        out[f"{impl}_grad"] = _grad_err(g2, run["grads"])
        errs = {name: float(np.abs(p2[name] - w).max())
                for name, w in run["final"].items()}
        worst = max(errs, key=errs.get)
        out[f"{impl}_param"] = (errs[worst], worst)
    run = _sp_train(torch, params, None, "ring", torch.bfloat16, _sp_sgd,
                    SP_BF16["steps"], warm=SP_BF16["warm"])
    out["bf16_losses"], out["bf16_ms"] = run["losses"], run["ms"]
    return out


def _sp_leg_moe():
    """``train_moe`` at P = 2 (the JAX example's sizes), top-1 and top-2,
    ``SP_MOE_STEPS`` steps on the card and again on the CPU over the same
    gloo group: each step's loss and maximum expert fraction."""
    import contextlib
    import io

    from chainermn_tpu_torch import train_moe

    out = {}
    for topk in (1, 2):
        for dev in (SP_DEVICE, "cpu"):
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                res = train_moe.run(["--device", dev, "--steps",
                                     str(SP_MOE_STEPS), "--router-topk",
                                     str(topk)])
            out[(topk, dev)] = {
                "losses": res["losses"],
                "max_frac": [a["max_frac"] for a in res["aux"]],
                "wall_s": time.perf_counter() - t0}
    return out


def _sp_leg_pipe(torch, mesh):
    """``make_pipeline`` (``remat`` off and on) and ``make_pipeline_1f1b``
    with ``tests/test_pipeline.py``'s dense + tanh stage, one stage a rank,
    on the card and on the CPU: outputs and gradients."""
    import numpy as np

    from chainermn_tpu_torch.parallel import (make_pipeline,
                                              make_pipeline_1f1b,
                                              stack_stage_params)

    def stage_fn(p, x):
        return torch.tanh(x @ p["w"] + p["b"])

    rng = np.random.RandomState(0)
    d = SP_PIPE["d"]
    per = [{"w": rng.randn(d, d).astype(np.float32) * 0.5,
            "b": rng.randn(d).astype(np.float32) * 0.1} for _ in range(2)]
    x, r, tgt = (rng.randn(SP_PIPE["batch"], d).astype(np.float32)
                 for _ in range(3))
    out = {}
    for dev in (SP_DEVICE, "cpu"):
        res = {}
        for remat in (False, True):
            st = stack_stage_params([{k: torch.tensor(v, device=dev)
                                      for k, v in p.items()} for p in per])
            for t in st.values():
                t.requires_grad_(True)
            xt = torch.tensor(x, device=dev).requires_grad_(True)
            y = make_pipeline(stage_fn, mesh, "sp",
                              num_microbatches=SP_PIPE["microbatches"],
                              remat=remat)(st, xt)
            (y * torch.tensor(r, device=dev)).sum().backward()
            res[f"gpipe{int(remat)}"] = [t.detach().cpu().numpy() for t in
                                         (y, xt.grad, st["w"].grad,
                                          st["b"].grad)]
        st = stack_stage_params([{k: torch.tensor(v, device=dev)
                                  for k, v in p.items()} for p in per])
        loss, g = make_pipeline_1f1b(
            stage_fn, lambda y, t: ((y - t) ** 2).mean(), mesh, "sp",
            num_microbatches=SP_PIPE["microbatches"])(
            st, torch.tensor(x, device=dev), torch.tensor(tgt, device=dev))
        res["1f1b"] = [np.asarray(float(loss))] + [
            g[k].cpu().numpy() for k in ("w", "b")]
        out[dev] = res
    return out


def _close_ratio(got, want, rtol=1e-5):
    """The largest ``|got - want| / (rtol·|want| + rtol·max|want|)``."""
    import numpy as np

    top = float(np.abs(want).max())
    return float((np.abs(got - want)
                  / (rtol * np.abs(want) + rtol * top + 1e-30)).max())


def _sp_report(smoke, res, wall):
    """Emit phase ``sp``'s lines and hold them to their bounds."""
    r0 = res[0]
    ref = r0["ref"]
    bad = []
    n_layers = TRAIN["n_layers"]
    shapes = {"ring": [SP["batch"], SP["seq"] // 2, TRAIN["n_heads"],
                       HEAD_DIM_TRAIN],
              "ulysses": [SP["batch"], SP["seq"], TRAIN["n_heads"] // 2,
                          HEAD_DIM_TRAIN]}
    for impl in SP_IMPLS:
        a = r0[f"{impl}_fp32"]
        rel = max(abs(x - y) / abs(y) for x, y in zip(a["losses"],
                                                       ref["fp32_losses"]))
        g = ref[f"{impl}_grad"]
        perr, pworst = ref[f"{impl}_param"]
        emit({"check": f"sp.{impl}_fp32", "dtype": "float32", "sp": 2,
              "backend": r0["backend"], "optimizer": f"adam {SP_ADAM_LR}",
              "sp2_losses": a["losses"], "sp1_losses": ref["fp32_losses"],
              "loss_max_rel_err": rel, "rtol": 1e-4,
              "param_max_abs_err": perr, "param_worst": pworst,
              "atol": 1e-4,
              "first_grads": {"rtol": 1e-4,
                              "atol": "1e-4 * max|g| of the leaf",
                              "worst_leaf": g[1], "worst_err_over_bound": g[0],
                              "worst_max_abs_err": g[2],
                              "worst_max_abs_ref": g[3]},
              "sp2_step_ms": a["ms"], "sp1_step_ms": ref["fp32_ms"],
              "wire": TP_WIRE, **TRAIN, "S": SP["seq"], "B": SP["batch"],
              "pos": "rope"})
        if rel > 1e-4 or perr > 1e-4 or g[0] > 1:
            bad.append(f"fp32 {impl} SP=2 vs SP=1: loss rel err {rel}, "
                       f"param abs err {perr} ({pworst}), first gradients "
                       f"{g[0]} times the bound ({g[1]})")
        b = [r[f"{impl}_bf16"] for r in res]
        per_step = [{k: v / SP_BF16["steps"] for k, v in x["launches"].items()
                     if v} for x in b]
        sp1 = ref["bf16_losses"]
        brel = max(abs(x - y) / abs(y) for x, y in zip(b[0]["losses"], sp1))
        ms = b[0]["ms"]
        tok_s = SP["batch"] * SP["seq"] * len(ms) / (sum(ms) / 1e3)
        emit({"check": f"sp.{impl}_bf16", "dtype": "bfloat16", "sp": 2,
              "wire": TP_WIRE, "losses": b[0]["losses"], "sp1_losses": sp1,
              "loss_max_rel_err_vs_sp1": brel, "rtol": TOL["bfloat16"],
              "step_ms": ms, "step_ms_p50": _percentile(ms, 0.5),
              "step_ms_p99": _percentile(ms, 0.99), "tokens_per_s": tok_s,
              "sp1_step_ms_p50": _percentile(ref["bf16_ms"], 0.5),
              "launches_per_step_by_rank": per_step,
              "flash_shape": shapes[impl], **TRAIN, "S": SP["seq"],
              "B": SP["batch"], "card": smoke.card})
        losses = b[0]["losses"]
        if not all(x == x and abs(x) < 1e9 for x in losses) \
                or not losses[-1] < losses[0]:
            bad.append(f"bf16 {impl} SP=2 losses not finite and falling: "
                       f"{losses}")
        if brel > TOL["bfloat16"]:
            bad.append(f"bf16 {impl} SP=2 vs SP=1: rel err {brel}")
        for r, ps in enumerate(per_step):
            # causal ring: rank r runs its r full blocks and its diagonal
            n = n_layers * (r + 1 if impl == "ring" else 1)
            want = {"flash_fwd": n, "flash_bwd": n}
            if ps != want:
                bad.append(f"bf16 {impl} rank {r} launches a step: {ps}, "
                           f"want {want}")
    for topk in (1, 2):
        card, cpu = r0["moe"][(topk, SP_DEVICE)], r0["moe"][(topk, "cpu")]
        rel = max(abs(x - y) / abs(y) for x, y in zip(
            card["losses"] + card["max_frac"], cpu["losses"] + cpu["max_frac"]))
        emit({"check": f"sp.train_moe_top{topk}", "dtype": "float32",
              "ranks": 2, "steps": SP_MOE_STEPS,
              "card_losses": card["losses"], "cpu_losses": cpu["losses"],
              "card_max_frac": card["max_frac"],
              "cpu_max_frac": cpu["max_frac"], "max_rel_err": rel,
              "rtol": 1e-4, "card_wall_s": card["wall_s"],
              "cpu_wall_s": cpu["wall_s"], "wire": TP_WIRE})
        if rel > 1e-4:
            bad.append(f"train_moe top-{topk} card vs CPU: rel err {rel}")
    pipe = r0["pipe"]
    ratios = {name: max(_close_ratio(g, w) for g, w in zip(
        pipe[SP_DEVICE][name], pipe["cpu"][name])) for name in pipe["cpu"]}
    emit({"check": "sp.pipeline", "dtype": "float32", "stages": 2,
          **SP_PIPE, "worst_err_over_bound": ratios,
          "bound": "rtol 1e-5 + 1e-5 * max|ref|"})
    for name, ratio in ratios.items():
        if ratio > 1:
            bad.append(f"pipeline {name} card vs CPU: {ratio} times the "
                       f"bound")
    emit({"check": "sp.workers", "wall_s": wall, "card": smoke.card})
    if bad:
        raise AssertionError("; ".join(bad))


ZW_WORKER_TIMEOUT_S = 600
ZW_DEVICE = "cuda"          # the card the legs run on
ZERO_LM = dict(batch=8, adam_lr=1e-4, steps=3, sgd_lr=1e-2, warm=1, timed=3)
# LAMB at the imagenet-train phase's ViT rate (1e-3), fp32 compute
FSDP_VIT = ["--fsdp", "--arch", "vit_s16", "--optimizer", "lamb", "--lr",
            "1e-3", "--agc", "0.01", "--image-size", "224", "--steps", "2",
            "--dataset-size", "64"]
FSDP_VIT_GLOBAL = 64        # images a step, 32 a rank at P = 2
INT8_R50 = ["--arch", "resnet50", "--image-size", "224", "--batchsize",
            "64", "--steps", "2", "--conv-impl", "pallas",
            "--dataset-size", "128"]
# wire legs of INT8_R50: name -> (extra flags, error feedback, the fp32
# leg it is held against)
INT8_LEGS = {"fp32": ([], False, None),
             "fp32_db": (["--double-buffering"], False, None),
             "int8": (["--allreduce-grad-dtype", "int8"], False, "fp32"),
             "int8_ef": (["--allreduce-grad-dtype", "int8"], True, "fp32"),
             "int8_ef_db": (["--allreduce-grad-dtype", "int8",
                             "--double-buffering"], True, "fp32_db")}
R50_PARAMS = 25_557_032     # the gradient vector of the ring and mean legs


def phase_zero_wire(smoke):
    """ZeRO-1, FSDP and the int8 wire with two processes on this card over
    a gloo group (``chip_smoke.py --zero-worker RANK DIR``, phase ``tp``'s
    mechanism; the times are the gloo host wire's): (a) ZeRO-1 on the LM
    at the train widths and 4 layers (global B 8, 4 a rank), fp32 3 Adam
    steps against the unsharded step on the card and bf16 1 + 3 SGD steps;
    (b) ``python
    -m chainermn_tpu_torch.train_imagenet --fsdp`` on ViT-S/16 at 224
    (LAMB, AGC, fp32, global batch 64) against the same CLI at world 1;
    (c) the int8 wire through ``train_imagenet`` on ResNet-50 at 224
    (global batch 128, pallas): int8, error feedback and the combined
    double-buffered mode against the fp32 wire; the ring on the card
    against the ring on the CPU and the exact mean; ``hierarchical_pmean``
    on the ``(1, 2)`` multislice mesh against the flat mean."""
    res, wall = _two_workers(smoke, "--zero-worker", ZW_WORKER_TIMEOUT_S)
    for r in range(2):
        for leg in ("zero1_bf16", "fsdp", "int8"):
            smoke.add_launches(res[r][leg]["launches"])
    _zw_report(smoke, res, wall)


def zero_worker(rank, tmp):
    """One of the two processes of phase ``zero-wire`` on ``cuda:0``: a
    gloo group through a ``FileStore`` in ``tmp``, the legs, then (rank 0,
    after the group is gone) the world-1 references on the card; pickles
    its results to ``tmp/rank<r>.pkl``."""
    import datetime
    import pickle

    import torch
    import torch.distributed as dist

    from chainermn_tpu_torch.topology import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    tmp = Path(tmp)
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp / "store"),
                                                         2),
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=180))
    mesh = make_mesh()
    out, keep, legs_s = {"backend": dist.get_backend()}, {}, {}

    def leg(name, fn, *args):
        t0 = time.monotonic()
        result = fn(*args)
        legs_s[name] = time.monotonic() - t0
        return result

    out["zero1_fp32"], keep["zero1"] = leg("zero1_fp32", _zw_zero1_fp32,
                                           torch, mesh, rank)
    out["zero1_bf16"] = leg("zero1_bf16", _zw_zero1_bf16, torch, mesh, rank)
    out["fsdp"], keep["fsdp"] = leg("fsdp", _zw_fsdp, torch, rank)
    out["int8"] = leg("int8", _zw_int8, torch)
    out["ring"] = leg("ring", _zw_ring, torch, mesh, rank)
    out["hier"] = leg("hier", _zw_hier, torch, mesh, rank)
    dist.destroy_process_group()
    if rank == 0:
        torch.cuda.empty_cache()
        out["ref"] = leg("ref", _zw_ref, torch, keep)
    out["legs_s"] = legs_s
    with open(tmp / f"rank{rank}.pkl", "wb") as fh:
        pickle.dump(out, fh)
    return 0


def _zw_lm(torch, dtype):
    from chainermn_tpu_torch.parallel import init_tp_transformer_lm

    return init_tp_transformer_lm(torch.Generator().manual_seed(0),
                                  max_len=TRAIN_SEQ, dtype=dtype,
                                  device=ZW_DEVICE, **ZW_LM)


def _zw_tokens(torch, rank=None):
    """The global batch of token rows (B 8, S + 1), or rank ``rank``'s
    half."""
    import numpy as np

    t = np.random.RandomState(0).randint(
        0, TRAIN["vocab"], (ZERO_LM["batch"], TRAIN_SEQ + 1))
    if rank is not None:
        half = ZERO_LM["batch"] // 2
        t = t[rank * half:(rank + 1) * half]
    return torch.as_tensor(t, device=ZW_DEVICE)


def _zw_host(torch, params):
    from chainermn_tpu_torch.convert import flatten

    return {k: t.detach().float().cpu().numpy()
            for k, t in flatten(params).items()}


def _zw_zero1_fp32(torch, mesh, rank):
    """fp32, 3 Adam steps of ZeRO-1 on the LM: the losses, each Adam
    moment's size over its leaf's, and (kept) the final params on the
    host."""
    from functools import partial

    from chainermn_tpu_torch.convert import flatten
    from chainermn_tpu_torch.parallel import (init_zero1_state,
                                              make_zero1_train_step)

    params = _zw_lm(torch, torch.float32)
    opt = init_zero1_state(partial(torch.optim.Adam,
                                   lr=ZERO_LM["adam_lr"]), params, mesh)
    step = make_zero1_train_step(_tp_loss(HEAD_DIM_TRAIN, None), opt,
                                 params, mesh)
    tokens = _zw_tokens(torch, rank)
    losses, ms = _sp_steps(torch, step, params, (tokens,), ZERO_LM["steps"])
    leaves = list(flatten(params).values())
    fractions = sorted({
        st[k].numel() / leaf.numel()
        for leaf, q in zip(leaves, opt.param_groups[0]["params"])
        for st in (opt.state[q],) for k in ("exp_avg", "exp_avg_sq")})
    keep = _zw_host(torch, params) if rank == 0 else None
    del step, opt, params
    torch.cuda.empty_cache()
    return {"losses": losses, "ms": ms, "moment_fractions": fractions}, keep


def _zw_zero1_bf16(torch, mesh, rank):
    from functools import partial

    from chainermn_tpu_torch import ops
    from chainermn_tpu_torch.parallel import (init_zero1_state,
                                              make_zero1_train_step)

    params = _zw_lm(torch, torch.bfloat16)
    opt = init_zero1_state(partial(torch.optim.SGD, lr=ZERO_LM["sgd_lr"]),
                           params, mesh)
    step = make_zero1_train_step(_tp_loss(HEAD_DIM_TRAIN, None), opt,
                                 params, mesh)
    batch = (_zw_tokens(torch, rank),)
    first, _ = _sp_steps(torch, step, params, batch, ZERO_LM["warm"])
    ops.reset_launch_counts()
    losses, ms = _sp_steps(torch, step, params, batch, ZERO_LM["timed"])
    launches = ops.launch_counts()
    del step, opt, params
    torch.cuda.empty_cache()
    return {"losses": first + losses, "ms": ms, "launches": launches}


def _zw_cli(torch, argv, error_feedback=False, dtype=None):
    """``train_imagenet.run(argv)`` on the card (compute ``dtype``: the
    model's bf16 if None), its launches counted from 0; returns the result
    and the launches."""
    import contextlib
    import io

    from chainermn_tpu_torch import ops, train_imagenet

    ops.reset_launch_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        res = train_imagenet.run(["--device", ZW_DEVICE, *argv],
                                 error_feedback=error_feedback, dtype=dtype)
    torch.cuda.synchronize()
    return res, ops.launch_counts()


def _zw_fsdp(torch, rank):
    """``train_imagenet --fsdp`` on ViT-S/16 at P = 2, fp32: the losses,
    the launches, the shapes of some of this rank's blocks and (kept on
    rank 0) the gathered params on the host."""
    t0 = time.monotonic()
    res, launches = _zw_cli(torch, FSDP_VIT + [
        "--batchsize", str(FSDP_VIT_GLOBAL // 2)], dtype=torch.float32)
    wall = time.monotonic() - t0
    step = res["step"]
    whole = step.gather()                    # every rank gathers
    keep = ({k: t.float().cpu().numpy() for k, t in whole.items()}
            if rank == 0 else None)
    local = {k: list(t.shape) for k, t in step.params.items()
             if k in ("patch_embed.kernel", "_Block_0.Dense_0.weight",
                      "_Block_0._MHSA_0.qkv.kernel")}
    out = {"losses": res["losses"], "launches": launches, "local": local,
           "wall_s": wall}
    del res, step, whole
    torch.cuda.empty_cache()
    return out, keep


def _zw_int8(torch):
    """ResNet-50 through ``train_imagenet`` on each wire of
    :data:`INT8_LEGS` (the warm-up step and 2 more, bf16, pallas): the
    losses, each int8 leg's largest parameter difference from its fp32
    leg's and the int8 leg's launches."""
    out, fp32 = {}, {}
    for name, (extra, ef, against) in INT8_LEGS.items():
        t0 = time.monotonic()
        res, launches = _zw_cli(torch, INT8_R50 + extra, error_feedback=ef)
        params = {k: t.detach().float().clone()
                  for k, t in res["model"].named_parameters()}
        diff = None
        if against is None:
            fp32[name] = params
        else:
            diff = max(float((params[k] - fp32[against][k]).abs().max())
                       for k in params)
        out[name] = {"losses": res["losses"], "param_diff_vs_fp32": diff,
                     "against": against, "wall_s": time.monotonic() - t0}
        if name == "int8":
            out["launches"] = launches
        del res, params
        torch.cuda.empty_cache()
    return out


def _zw_vectors(torch):
    """Both ranks' gradient-like vectors of ResNet-50's size: normal
    entries scaled by a log-normal spread, each rank's from its own seed,
    on the card."""
    out = []
    for r in range(2):
        g = torch.Generator(device=ZW_DEVICE).manual_seed(100 + r)
        x = torch.randn(R50_PARAMS, generator=g, device=ZW_DEVICE)
        out.append(x * torch.randn(R50_PARAMS, generator=g,
                                   device=ZW_DEVICE).exp())
    return out


def _zw_ring(torch, mesh, rank):
    """The int8 ring on this rank's vector on the card and on its host
    copy (the same gloo group): the entries that differ and by how many
    of the final block's quantization steps; the card's error against the
    exact mean over the bound of its two quantizations (the sent chunk's
    and the gathered sum's, ``blockmax/254`` each, over P)."""
    from chainermn_tpu_torch.ops import quantized_ring_pmean
    from chainermn_tpu_torch.ops.collective import DEFAULT_QUANT_BLOCK

    xs = _zw_vectors(torch)
    t0 = time.monotonic()
    card = quantized_ring_pmean(xs[rank], mesh)
    torch.cuda.synchronize()
    card_ms = (time.monotonic() - t0) * 1e3
    t0 = time.monotonic()
    host = quantized_ring_pmean(xs[rank].cpu(), mesh)
    host_ms = (time.monotonic() - t0) * 1e3
    host = host.to(ZW_DEVICE)
    b = DEFAULT_QUANT_BLOCK
    n = R50_PARAMS

    def blocks(v):
        return torch.nn.functional.pad(v, (0, (-n) % b)).view(-1, b)

    # one step of the output is the final scale over P: blockmax / 127
    step = blocks(host).abs().amax(1, keepdim=True) / 127.0
    diff = blocks(card - host).abs()
    steps = float((diff / step.clamp_min(1e-30)).max())
    # chunk c's first quantization is of rank (c + 1) % 2's entries
    chunk = -(-n // 2)
    chunk = -(-chunk // b) * b
    idx = torch.arange(n, device=ZW_DEVICE)
    sender = torch.where(idx < chunk, xs[1], xs[0])
    exact = (xs[0].double() + xs[1].double()) / 2
    e1 = blocks(sender).abs().amax(1, keepdim=True) / 254.0
    e2 = (blocks((xs[0] + xs[1]).float()).abs().amax(1, keepdim=True)
          + e1) / 254.0
    # the slack covers fp32 rounding of the scales, quotients and sums
    bound = (e1 + e2) / 2 * (1 + 2.0 ** -10) \
        + blocks(exact.abs().float()) * 2.0 ** -22
    err = blocks((card.double() - exact).float()).abs()
    out = {"n": n, "block": b, "differ": int((card != host).sum()),
           "max_steps": steps, "err_over_bound": float((err / bound).max()),
           "max_abs_err": float(err.max()), "card_ms": card_ms,
           "host_ms": host_ms}
    del xs, card, host, sender, exact, idx
    torch.cuda.empty_cache()
    return out


def _zw_hier(torch, mesh, rank):
    """``hierarchical_pmean`` on the ``(1, 2)`` multislice mesh (both ranks
    on this host) against the flat mean: fp32 bit for bit, the bf16 slice
    leg within bf16 rounding."""
    from chainermn_tpu_torch.ops import hierarchical_pmean, pmean
    from chainermn_tpu_torch.topology import make_multislice_mesh

    x = _zw_vectors(torch)[rank]
    ms = make_multislice_mesh()
    flat = pmean(x, mesh)
    with ms:
        t0 = time.monotonic()
        got = hierarchical_pmean(x)
        torch.cuda.synchronize()
        fp32_ms = (time.monotonic() - t0) * 1e3
        bf = hierarchical_pmean(x, dcn_dtype="bfloat16")
    rel = float(((bf - flat).abs() / flat.abs().clamp_min(1e-30)).max())
    out = {"mesh": dict(ms.shape), "fp32_differ": int((got != flat).sum()),
           "bf16_max_rel_err": rel, "bf16_rtol": 2.0 ** -8,
           "fp32_ms": fp32_ms}
    del x, flat, got, bf
    torch.cuda.empty_cache()
    return out


def _zw_ref(torch, keep):
    """World 1 on the card (rank 0, the gloo group gone): the unsharded
    LM, 3 fp32 Adam steps on the global batch against ZeRO-1's losses and
    params; the FSDP CLI at batch 64 against P = 2's gathered params."""
    import numpy as np

    from chainermn_tpu_torch.parallel import (make_hybrid_shard_map_step,
                                              param_leaves)

    params = _zw_lm(torch, torch.float32)
    step = make_hybrid_shard_map_step(
        _tp_loss(HEAD_DIM_TRAIN, None),
        torch.optim.Adam(param_leaves(params), lr=ZERO_LM["adam_lr"]),
        params)
    losses, ms = _sp_steps(torch, step, params, (_zw_tokens(torch),),
                           ZERO_LM["steps"])
    want = _zw_host(torch, params)
    worst = max(((float(np.abs(keep["zero1"][k] - w).max()), k)
                 for k, w in want.items()))
    out = {"zero1_losses": losses, "zero1_ms": ms, "zero1_param": worst}
    del step, params
    torch.cuda.empty_cache()
    res, _ = _zw_cli(torch, FSDP_VIT + ["--batchsize", str(FSDP_VIT_GLOBAL)],
                     dtype=torch.float32)
    got = {k: t.float().cpu().numpy() for k, t in res["step"].gather().items()}
    out["fsdp_losses"] = res["losses"]
    out["fsdp_param"] = max(((float(np.abs(keep["fsdp"][k] - w).max()), k)
                             for k, w in got.items()))
    del res
    if torch.distributed.is_initialized():    # the CLI's one-rank group
        torch.distributed.destroy_process_group()
    return out


def _zw_report(smoke, res, wall):
    """Emit phase ``zero-wire``'s lines and hold them to their bounds."""
    r0 = res[0]
    ref = r0["ref"]
    bad = []

    def rel(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a, b))

    z = r0["zero1_fp32"]
    zrel = rel(z["losses"], ref["zero1_losses"])
    fractions = [x["zero1_fp32"]["moment_fractions"] for x in res]
    emit({"check": "zero_wire.zero1_fp32", "dtype": "float32", "ranks": 2,
          "optimizer": f"adam {ZERO_LM['adam_lr']}",
          "p2_losses": z["losses"], "p1_losses": ref["zero1_losses"],
          "loss_max_rel_err": zrel, "rtol": 1e-4,
          "param_max_abs_err": ref["zero1_param"][0],
          "param_worst": ref["zero1_param"][1], "atol": 1e-4,
          "adam_moment_fraction_of_leaf_by_rank": fractions,
          "p2_step_ms": z["ms"], "p1_step_ms": ref["zero1_ms"],
          "wire": TP_WIRE, **ZW_LM, "S": TRAIN_SEQ, "B": ZERO_LM["batch"]})
    if zrel > 1e-4 or ref["zero1_param"][0] > 1e-4:
        bad.append(f"ZeRO-1 fp32 vs world 1: loss rel err {zrel}, param "
                   f"{ref['zero1_param']}")
    if any(f != [0.5] for f in fractions):
        bad.append(f"ZeRO-1 Adam moments are not half of each leaf: "
                   f"{fractions}")
    zb = [x["zero1_bf16"] for x in res]
    per_step = [{k: v / ZERO_LM["timed"] for k, v in x["launches"].items()
                 if v} for x in zb]
    ms = zb[0]["ms"]
    emit({"check": "zero_wire.zero1_bf16", "dtype": "bfloat16", "ranks": 2,
          "wire": TP_WIRE, "losses": zb[0]["losses"], "step_ms": ms,
          "step_ms_p50": _percentile(ms, 0.5),
          "tokens_per_s": ZERO_LM["batch"] * TRAIN_SEQ * len(ms)
          / (sum(ms) / 1e3), "launches_per_step_by_rank": per_step,
          **ZW_LM, "S": TRAIN_SEQ, "B": ZERO_LM["batch"],
          "card": smoke.card})
    losses = zb[0]["losses"]
    if not all(x == x and abs(x) < 1e9 for x in losses) \
            or not losses[-1] < losses[0]:
        bad.append(f"ZeRO-1 bf16 losses not finite and falling: {losses}")
    want = {"flash_fwd": ZW_LM["n_layers"],
            "flash_bwd": ZW_LM["n_layers"],
            "ce_stats": 1, "ce_dh": 1, "ce_dtable": 1}
    if any(ps != want for ps in per_step):
        bad.append(f"ZeRO-1 bf16 launches a step {per_step}, want {want}")
    f = [x["fsdp"] for x in res]
    frel = rel(f[0]["losses"], ref["fsdp_losses"])
    fl = [{k: v / 3 for k, v in x["launches"].items() if v} for x in f]
    emit({"check": "zero_wire.fsdp_vit_s16", "dtype": "float32", "ranks": 2,
          "cli": "train_imagenet " + " ".join(FSDP_VIT), "global_batch":
          FSDP_VIT_GLOBAL, "p2_losses": f[0]["losses"],
          "p1_losses": ref["fsdp_losses"], "loss_max_rel_err": frel,
          "rtol": 1e-4, "param_max_abs_err": ref["fsdp_param"][0],
          "param_worst": ref["fsdp_param"][1], "atol": 1e-4,
          "blocks_rank0": f[0]["local"], "launches_per_step_by_rank": fl,
          "flash_shape": [FSDP_VIT_GLOBAL // 2, 197, 6, 64],
          "wall_s": [x["wall_s"] for x in f], "wire": TP_WIRE})
    if frel > 1e-4 or ref["fsdp_param"][0] > 1e-4:
        bad.append(f"FSDP ViT-S/16 vs world 1: loss rel err {frel}, param "
                   f"{ref['fsdp_param']}")
    if any(x != {"flash_fwd": 12, "flash_bwd": 12} for x in fl):
        bad.append(f"FSDP ViT-S/16 launches a step {fl}")
    q = r0["int8"]
    for name in INT8_LEGS:
        leg = q[name]
        row = {"check": f"zero_wire.resnet50_{name}", "dtype": "bfloat16",
               "ranks": 2, "global_batch": 128, "losses": leg["losses"],
               "wall_s": leg["wall_s"]}
        if leg["against"] is not None:
            base = q[leg["against"]]["losses"]
            gap = max(abs(x - y) for x, y in zip(leg["losses"], base))
            row.update(fp32_leg=leg["against"], fp32_wire_losses=base,
                       loss_max_abs_gap=gap, bound=5e-2,
                       param_max_abs_diff_vs_fp32=leg["param_diff_vs_fp32"])
            if gap > 5e-2 or not leg["param_diff_vs_fp32"] > 0:
                bad.append(f"ResNet-50 {name}: loss gap {gap} (bound 5e-2), "
                           f"param diff {leg['param_diff_vs_fp32']}")
        emit(row)
    ql = [{k: v / 3 for k, v in x["int8"]["launches"].items() if v}
          for x in res]
    emit({"check": "zero_wire.resnet50_int8_launches",
          "launches_per_step_by_rank": ql})
    if any(x != {"conv_wgrad": RESNET_CONV_LAUNCHES,
                 "conv_dgrad": RESNET_CONV_LAUNCHES} for x in ql):
        bad.append(f"ResNet-50 int8 launches a step {ql}")
    for r, x in enumerate(res):
        ring = x["ring"]
        emit({"check": "zero_wire.ring", "rank": r, **ring,
              "card": smoke.card})
        if ring["err_over_bound"] > 1:
            bad.append(f"ring rank {r}: {ring['err_over_bound']} times its "
                       f"bound")
        h = x["hier"]
        emit({"check": "zero_wire.hierarchical_pmean", "rank": r, **h})
        if h["fp32_differ"] or h["bf16_max_rel_err"] > h["bf16_rtol"]:
            bad.append(f"hierarchical_pmean rank {r}: {h}")
    emit({"check": "zero_wire.workers", "wall_s": wall,
          "legs_s_by_rank": [x["legs_s"] for x in res], "card": smoke.card})
    if bad:
        raise AssertionError("; ".join(bad))


def phase_resnet_parity(smoke):
    """fp32 (TF32 off), card vs CPU from the same weights: ResNet-50 at image
    112 (stages 1-2 eligible at 28² and 14², the stride-2 and 7x7 convs
    fall back), batch 4, ``conv_impl="pallas"``: the loss and every
    gradient, then two ``make_flax_train_step`` steps (SGD 0.1, momentum
    0.9, wd 1e-4) at world 1, the card's group over NCCL and the CPU's
    over gloo.  The weights are the random init: each block's last
    BatchNorm scale starts at 0, so the first backward gives the conv
    kernels zero gradients and the second step's runs them on live ones.
    (Scales redrawn to open every branch make this 50-layer ReLU network
    chaotic in fp32: a 1e-7 relative change of the input moves the CPU's
    own gradients by ~0.25% in norm, as ReLUs and max-pool windows flip,
    so no card could be held to 1e-4 there.)"""
    torch = smoke.torch
    from chainermn_tpu_torch.communicators import create_communicator
    from chainermn_tpu_torch.models import ARCHS, cross_entropy_loss
    from chainermn_tpu_torch.ops import conv3x3_dgrad, conv3x3_wgrad
    from chainermn_tpu_torch.optimizers import create_multi_node_optimizer
    from chainermn_tpu_torch.train import make_flax_train_step, shard_batch
    from chainermn_tpu_torch.train_imagenet import synthetic_batch

    image, batch = 112, 4
    comms = {dev: create_communicator("xla", device=dev)   # the card's first
             for dev in ("cuda", "cpu")}
    ref = ARCHS["resnet50"](dtype=torch.float32, conv_impl="pallas", seed=3,
                            device="cpu")
    weights = {k: v.clone() for k, v in ref.state_dict().items()}
    x, y = synthetic_batch(batch, image, seed=5)
    runs, grads = {}, {}
    for dev, comm in comms.items():
        model = ARCHS["resnet50"](dtype=torch.float32, conv_impl="pallas",
                                  device=dev)
        model.load_state_dict(weights)
        names = [n for n, _ in model.named_parameters()]
        model.train()
        before = (conv3x3_wgrad.launches, conv3x3_dgrad.launches)
        loss = cross_entropy_loss(model(torch.from_numpy(x).to(dev)),
                                  torch.from_numpy(y).to(dev))
        grads[dev] = {n: g.detach().cpu() for n, g in zip(
            names, torch.autograd.grad(loss, list(model.parameters())))}
        launched = (conv3x3_wgrad.launches - before[0],
                    conv3x3_dgrad.launches - before[1])
        if dev == "cuda" and launched != (6, 6):
            raise AssertionError(f"the card's backward launched (wgrad, "
                                 f"dgrad) {launched}, want (6, 6)")
        model.load_state_dict(weights)
        opt = create_multi_node_optimizer(
            torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9,
                            weight_decay=1e-4), comm)
        step = make_flax_train_step(
            model, lambda logits, b: (cross_entropy_loss(logits, b[1]), {}),
            opt, mesh=comm.mesh)
        b = shard_batch((x, y), comm.device, comm.mesh)
        losses = [float(step(model, b)[0]) for _ in range(2)]
        runs[dev] = (float(loss.detach()), losses,
                     {k: v.detach().float().cpu()
                      for k, v in model.state_dict().items()})
    (l0c, lc, pc), (l0h, lh, ph) = runs["cuda"], runs["cpu"]
    rel = max(abs(a - b) / abs(b) for a, b in zip([l0c] + lc, [l0h] + lh))
    worst = max(ph, key=lambda k: float((pc[k] - ph[k]).abs().max()))
    worst_err = float((pc[worst] - ph[worst]).abs().max())
    grad_rel = {k: float((grads["cuda"][k] - g).norm()
                         / g.norm().clamp_min(1e-30))
                for k, g in grads["cpu"].items()}
    worst_grad = max(grad_rel, key=grad_rel.get)
    emit({"check": "resnet_parity", "dtype": "float32", "arch": "resnet50",
          "image": image, "B": batch, "card_losses": [l0c] + lc,
          "cpu_losses": [l0h] + lh, "loss_max_rel_err": rel,
          "state_max_abs_err": worst_err, "state_worst": worst,
          "grad_max_rel_norm_err": grad_rel[worst_grad],
          "grad_worst_param": worst_grad, "rtol": 1e-4, "atol": 1e-4,
          "conv_launches_per_backward": 6})
    if rel > 1e-4 or worst_err > 1e-4 or grad_rel[worst_grad] > 1e-4:
        raise AssertionError(f"resnet parity: loss rel err {rel}, state abs "
                             f"err {worst_err} ({worst}), grad rel norm err "
                             f"{grad_rel[worst_grad]} ({worst_grad})")


def _resnet_run(torch, step, model, batch, steps):
    """``steps`` synchronised steps: (losses, per-step ms)."""
    losses, ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(step(model, batch)[0]))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return losses, ms


def _imagenet_cell(smoke, cfg, warm, timed, flops_per_image=None,
                   check="imagenet_train", label=None, **build_kw):
    """bf16 through ``train_imagenet.build_step`` (seeded weights) at world
    1 over a one-rank NCCL group, ``cfg``'s arch, image, per-card batch and
    classes: ``warm`` warm-up and ``timed`` synchronised steps (a batch that
    does not fit in the card's memory fails the phase).  Returns the row:
    losses, step ms p50/p99, images/s, analytic MFU (``flops_per_image``
    at 224², scaled by the image's area), peak memory and the launches of
    the timed steps (the conv kernels also by kernel size)."""
    torch = smoke.torch
    from chainermn_tpu_torch import ops
    from chainermn_tpu_torch.train import shard_batch
    from chainermn_tpu_torch.train_imagenet import build_step, synthetic_batch

    image, per_card, classes = cfg["image"], cfg["batch"], cfg["classes"]
    step, model, comm = build_step(cfg["arch"], image, num_classes=classes,
                                   **build_kw)
    batch = shard_batch(synthetic_batch(per_card * comm.size, image,
                                        classes), comm.device, comm.mesh)
    warm_losses, _ = _resnet_run(torch, step, model, batch, warm)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    losses, ms = _resnet_run(torch, step, model, batch, timed)
    launches = ops.launch_counts()
    for name in ("conv_wgrad", "conv_dgrad"):
        launches.update({f"{name}_k{k}": n for k, n in
                         ops.KERNEL_WRAPPERS[name].launches_by_k.items()})
    p50 = _percentile(ms, 0.5)
    row = {"check": check, "case": label or cfg["arch"], "dtype": "bfloat16",
           **cfg, **build_kw, "world": comm.size,
           "n_params": sum(p.numel() for p in model.parameters()),
           "warmup_losses": warm_losses, "losses": losses, "step_ms": ms,
           "step_ms_p50": p50, "step_ms_p99": _percentile(ms, 0.99),
           "images_per_s": per_card / (p50 / 1e3),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
           "launches": launches,
           "conv_launches_per_step": {k: launches[k] / timed
                                      for k in ("conv_wgrad", "conv_dgrad")},
           "card": smoke.card}
    if flops_per_image:
        flops = flops_per_image * (image / 224.0) ** 2 * per_card
        row["mfu_analytic"] = flops / (p50 / 1e3) / PEAK_FLOPS["bfloat16"]
    del step, model, batch
    torch.cuda.empty_cache()
    return row


def _check_finite(row):
    import math

    every = row["warmup_losses"] + row["losses"]
    if not all(math.isfinite(v) for v in every):
        raise AssertionError(f"{row['case']} losses not finite: {every}")


def _resnet_cell(smoke, cfg, flops_per_image, conv_launches,
                 check="resnet_train", **build_kw):
    """``cfg``'s model with ``conv_impl="pallas"``, 2 warm-up and 10 timed
    steps, then the same with ``"xla"`` (cuDNN's backward) from the same
    seed as the yardstick.  Checks: finite losses, exactly
    ``conv_launches`` (launch-count name -> per step) a pallas step and no
    conv kernel under xla, the first losses within 2e-2.  Emits and
    returns the two rows."""
    rows = {impl: _imagenet_cell(smoke, cfg, 2, 10, flops_per_image, check,
                                 f"{cfg['arch']} {impl}", conv_impl=impl,
                                 **build_kw)
            for impl in ("pallas", "xla")}
    pal, xla = rows["pallas"], rows["xla"]
    first = abs(xla["warmup_losses"][0] - pal["warmup_losses"][0]) \
        / abs(pal["warmup_losses"][0])
    xla.update(first_loss_rel_err_vs_pallas=first, rtol=2e-2,
               step_ms_p50_pallas_minus_xla=pal["step_ms_p50"]
               - xla["step_ms_p50"],
               images_per_s_pallas_over_xla=pal["images_per_s"]
               / xla["images_per_s"])
    for row in (pal, xla):
        emit(row)
        _check_finite(row)
    n = len(pal["losses"])
    wrong = {k: (pal["launches"][k], c * n) for k, c in conv_launches.items()
             if pal["launches"][k] != c * n}
    wrong.update({f"xla {k}": (xla["launches"][k], 0)
                  for k in ("conv_wgrad", "conv_dgrad")
                  if xla["launches"][k] != 0})
    if wrong:
        raise AssertionError(f"{cfg['arch']} conv launches (got, want): "
                             f"{wrong}")
    if first > 2e-2:
        raise AssertionError(f"xla vs pallas first loss: rel err {first}")
    smoke.add_launches(pal["launches"])
    return rows


def phase_resnet_train(smoke):
    """bf16, ``bench.py``'s headline through the port's entry points
    (``train_imagenet.build_step``: create_communicator → ResNet-50 →
    create_multi_node_optimizer → make_flax_train_step, world 1 over a
    one-rank NCCL group), ``conv_impl="pallas"``: 2 warm-up and 10 timed
    steps; then the same with ``conv_impl="xla"`` (cuDNN's backward) from
    the same weights as the yardstick."""
    smoke.resnet50 = _resnet_cell(
        smoke, RESNET, RESNET_FLOPS_PER_IMAGE,
        {"conv_wgrad": RESNET_CONV_LAUNCHES,
         "conv_dgrad": RESNET_CONV_LAUNCHES})


def phase_resnet152_db(smoke):
    """BASELINE config #4 on the card: ResNet-152 with double buffering
    (``train_imagenet.build_step(arch="resnet152",
    double_buffering=True)``), bf16, ``bench.py``'s 128 images per card,
    10 synchronised steps each with ``conv_impl="pallas"`` and ``"xla"``;
    the step time, images/s, MFU and peak memory beside ResNet-50's."""
    rows = _resnet_cell(smoke, RESNET152, RESNET152_FLOPS_PER_IMAGE,
                        {"conv_wgrad": RESNET152_CONV_LAUNCHES,
                         "conv_dgrad": RESNET152_CONV_LAUNCHES},
                        double_buffering=True)
    r50 = getattr(smoke, "resnet50", None) or {}
    keys = ("batch", "step_ms_p50", "step_ms_p99", "images_per_s",
            "mfu_analytic", "peak_mem_gb", "conv_launches_per_step")
    emit({"check": "resnet152_vs_resnet50", "card": smoke.card,
          **{f"resnet152_{impl}": {k: rows[impl][k] for k in keys}
             for impl in rows},
          **{f"resnet50_{impl}": {k: r[k] for k in keys}
             for impl, r in r50.items()}})


def _rel_norm(a, b):
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _grad_parity(smoke, label, build, weights, x, y, launches=None,
                 cudnn_twin=None):
    """fp32 card vs CPU from the same ``weights``: one training forward and
    backward of ``build(device)``.  The loss to rtol 1e-4, the buffers (the
    BatchNorm running statistics) to atol 1e-4.  Gradients: where ReLUs or
    max-pool windows sit within rounding of a flip, fp32 reordering moves
    a channel's gradients by ~1e-3 at a few hundred pixels a channel, on
    the CPU alone.  So the whole gradient (every leaf in one vector) is
    held to a relative norm of max(1e-4, 4x the CPU's own change when the
    images move by +1e-7 or by -1e-7, the larger), and each leaf to 4x the
    larger of that and its own change: which leaves a flip lands in is
    chance (one sign alone can miss a flip), and a wrong leaf (relative
    error ~1) fails all the same.
    ``cudnn_twin``: the same model with cuDNN's conv backward; its forward
    on the card is the same code, so flips are the same, and each of its
    gradients must equal the kernels' to a relative norm of 1e-4.
    ``launches``: the exact kernel launches
    the card's backward must make (``conv_*_k1`` / ``_k3`` by kernel
    size)."""
    import numpy as np

    torch = smoke.torch
    from chainermn_tpu_torch import ops
    from chainermn_tpu_torch.models import cross_entropy_loss

    def run(make, dev, images):
        model = make(dev)
        model.load_state_dict(weights)
        model.train()
        names = [n for n, _ in model.named_parameters()]
        loss = cross_entropy_loss(model(torch.from_numpy(images).to(dev)),
                                  torch.from_numpy(y).to(dev))
        grads = torch.autograd.grad(loss, list(model.parameters()))
        return (float(loss.detach()),
                {n: g.detach().float().cpu() for n, g in zip(names, grads)},
                {k: b.detach().float().cpu()
                 for k, b in model.named_buffers()})

    ops.reset_launch_counts()
    lc, gc, bc = run(build, "cuda", x)
    counts = ops.launch_counts()
    for name in ("conv_wgrad", "conv_dgrad"):
        fn = ops.KERNEL_WRAPPERS[name]
        counts.update({f"{name}_k{k}": n
                       for k, n in fn.launches_by_k.items()})
    lh, gh, bh = run(build, "cpu", x)
    moved = [run(build, "cpu", (x * np.float32(1 + e)).astype(np.float32))[1]
             for e in (1e-7, -1e-7)]

    def whole(a, b):
        num = sum(float((a[n] - b[n]).norm()) ** 2 for n in b)
        return (num / sum(float(g.norm()) ** 2 for g in b.values())) ** 0.5

    rows = {n: (_rel_norm(gc[n], g), max(_rel_norm(m[n], g) for m in moved))
            for n, g in gh.items()}
    err, self_change = whole(gc, gh), max(whole(m, gh) for m in moved)
    bad = {}
    if err > max(1e-4, 4 * self_change):
        bad["whole gradient"] = (err, self_change)
    bad.update({n: r for n, r in rows.items()
                if r[0] > max(1e-4, 4 * max(r[1], self_change))})
    twin = {}
    if cudnn_twin is not None:
        _, gt, _ = run(cudnn_twin, "cuda", x)
        twin = {n: _rel_norm(gc[n], gt[n]) for n in gt}
        bad.update({f"vs cudnn {n}": (e,) for n, e in twin.items()
                    if e > 1e-4})
    worst = max(rows, key=lambda n: rows[n][0])
    stats = max((float((bc[k] - b).abs().max()) for k, b in bh.items()),
                default=0.0)
    loss_rel = abs(lc - lh) / abs(lh)
    wrong = {k: (counts[k], n) for k, n in (launches or {}).items()
             if counts[k] != n}
    emit({"check": "imagenet_parity", "case": label, "dtype": "float32",
          "B": int(x.shape[0]), "image": int(x.shape[1]),
          "card_loss": lc, "cpu_loss": lh, "loss_rel_err": loss_rel,
          "grad_rel_norm_err": err, "grad_cpu_self_change": self_change,
          "leaf_max_rel_norm_err": rows[worst][0], "leaf_worst": worst,
          "leaf_worst_cpu_self_change": rows[worst][1],
          "leaves_over_1e-4": {n: list(r) for n, r in rows.items()
                               if r[0] > 1e-4},
          "leaves": len(rows),
          "vs_cudnn_max_rel_norm_err": max(twin.values(), default=None),
          "stats_max_abs_err": stats,
          "launches": {k: counts[k] for k in (launches or {})},
          "rtol": 1e-4, "atol": 1e-4})
    if loss_rel > 1e-4 or stats > 1e-4 or bad or wrong:
        raise AssertionError(
            f"{label}: loss rel err {loss_rel}, stats err {stats}, grads "
            f"past their bound {bad}, launches (got, want) {wrong}")


def _cli_parity(smoke, label, argv, seeded=None):
    """``train_imagenet.run`` on the card and on the CPU from the same seed
    (fp32): every step's loss to rtol 1e-4.  With ``seeded`` (the model as
    ``run`` seeds it, for a run whose steps amplify rounding), to max(1e-4,
    4x the CPU's own change when those weights move by +1e-7 or by -1e-7,
    the larger)."""
    import numpy as np

    torch = smoke.torch
    from chainermn_tpu_torch.convert import resnet_to_numpy, tree_map
    from chainermn_tpu_torch.train_imagenet import run

    got = {dev: run(["--device", dev, *argv], dtype=torch.float32)
           for dev in ("cuda", "cpu")}
    card, cpu = got["cuda"]["losses"], got["cpu"]["losses"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
    bound, self_change = 1e-4, None
    if seeded is not None:
        self_change = 0.0
        for e in (1e-7, -1e-7):
            variables = resnet_to_numpy(seeded)
            variables["params"] = tree_map(
                variables["params"], lambda a: a * np.float32(1 + e))
            moved = run(["--device", "cpu", *argv], variables=variables,
                        dtype=torch.float32)["losses"]
            self_change = max(self_change, *(abs(a - b) / abs(b)
                                             for a, b in zip(moved, cpu)))
        bound = max(bound, 4 * self_change)
    emit({"check": "imagenet_cli_parity", "case": label, "argv": argv,
          "card_losses": card, "cpu_losses": cpu, "loss_max_rel_err": rel,
          "cpu_self_change": self_change, "rtol": bound})
    if len(card) != len(cpu) or rel > bound:
        raise AssertionError(f"{label}: card losses {card}, cpu {cpu}, "
                             f"bound {bound}")


def phase_imagenet_parity(smoke):
    """fp32 (TF32 off), card vs CPU from the same weights (``_grad_parity``):
    NF-ResNet-50 at image 112, batch 4, ``conv_impl="pallas"`` (skip gains
    0.2, so every branch is live; 16 1x1 and 6 3x3 launches of each conv
    kernel a backward), each gradient also against the same model's on
    the card with cuDNN's backward; ViT-S/16 at image 64 (17 tokens), full
    depth, the flash kernels (12 forward and 12 backward calls); AlexNet,
    VGG-16 and
    GoogLeNet at ``stem_strides=1``, image 32.  Then ``train_imagenet``'s
    own ``run`` on both: NF-ResNet-50 with LARS, warmup 2, AGC 0.01 and
    the fp16 wire, and ResNet-18 with stalebn and LAMB at lr 0.01 (rtol
    1e-4) and at lr 0.1 (within 4x the CPU's own change), 4 steps each."""
    torch = smoke.torch
    from chainermn_tpu_torch.communicators import create_communicator
    from chainermn_tpu_torch.models import ARCHS
    from chainermn_tpu_torch.train_imagenet import arch_kwargs, synthetic_batch

    for dev in ("cuda", "cpu"):            # the card's group first
        create_communicator("xla", device=dev)

    def model(arch, **kw):
        return lambda dev: ARCHS[arch](dtype=torch.float32, seed=3,
                                       device=dev, **kw)

    nf = model("nf_resnet50", conv_impl="pallas")
    weights = nf("cpu").state_dict()
    for k in weights:
        if k.endswith("skip_gain"):
            weights[k].fill_(0.2)
    x, y = synthetic_batch(4, 112, seed=5)
    _grad_parity(smoke, "nf_resnet50", nf, weights, x, y, launches={
        "conv_wgrad_k1": 16, "conv_wgrad_k3": 6, "conv_dgrad_k1": 16,
        "conv_dgrad_k3": 6}, cudnn_twin=model("nf_resnet50"))
    vit = model("vit_s16", image_size=64, attn_impl="flash")
    x, y = synthetic_batch(4, 64, seed=6)
    _grad_parity(smoke, "vit_s16", vit, vit("cpu").state_dict(), x, y,
                 launches={"flash_fwd": 12, "flash_bwd": 12})
    for arch in CONVNETS:
        kw = {} if arch == "googlenet" else {"image_size": 32}
        net = model(arch, stem_strides=1, **kw)
        x, y = synthetic_batch(4, 32, seed=7)
        _grad_parity(smoke, arch, net, net("cpu").state_dict(), x, y)
    small = ["--image-size", "64", "--batchsize", "4", "--dataset-size",
             "16", "--steps", "3", "--num-classes", "1000"]
    _cli_parity(smoke, "nf_resnet50 lars warmup agc fp16", [
        "--arch", "nf_resnet50", "--conv-impl", "pallas", "--optimizer",
        "lars", "--warmup-steps", "2", "--agc", "0.01",
        "--allreduce-grad-dtype", "float16", *small])
    # LAMB at its own scale of lr, then at SGD's 0.1: there every step moves
    # each leaf by 10% of its norm, stalebn's stale statistics blow the
    # loss up (7 -> 87 -> 9 -> 47) and 1e-7 differences grow to ~1e-4 by
    # the fourth step, on the CPU alone
    stale = ["--arch", "resnet18", "--norm", "stalebn", "--optimizer", "lamb",
             *small]
    _cli_parity(smoke, "resnet18 stalebn lamb", [*stale, "--lr", "0.01"])
    _cli_parity(smoke, "resnet18 stalebn lamb lr 0.1", stale,
                seeded=ARCHS["resnet18"](
                    num_classes=1000, seed=0, device="cpu",
                    dtype=torch.float32, **arch_kwargs("resnet18", 64,
                                                       norm="stalebn")))


def _vit_macs_per_image(image, patch, d, layers, classes):
    """Forward multiply-adds of a ViT on one image: per layer and token
    12·D² (qkv, proj, the 4x MLP) and 2·S·D (QKᵀ, PV), the patch
    embedding and the head."""
    n = (image // patch) ** 2
    s = n + 1
    return (layers * (12 * s * d * d + 2 * s * s * d)
            + n * patch * patch * 3 * d + d * classes)


def phase_imagenet_train(smoke):
    """bf16, 224², batch 128, world 1: NF-ResNet-50 with ``conv_impl=
    "pallas"`` then ``"xla"`` from the same seed (SGD 0.1 / momentum 0.9 /
    wd 1e-4, bench.py's recipe), and ViT-B/16 with ``attn_impl="auto"``
    (the flash kernels at S 197; LAMB at lr 1e-3), 2 warm-up and 10 timed
    steps each; then AlexNet, VGG-16 and GoogLeNet, 2 + 3.  Launch
    counts of the timed steps must be exact: 28 1x1 and 11 3x3 launches of
    each conv kernel a pallas step, none a xla step, 12 flash forward and
    12 flash backward calls a ViT step; the first xla loss within 2e-2 of
    the first pallas loss.  MFU counts multiply-adds as FLOPs, as bench.py
    counts ResNet-50's 4.1e9: NF-ResNet-50 that same 3 x 4.1e9 an image
    (the weight standardisation is O(parameters)), ViT-B/16 3 x 17.56e9
    (``_vit_macs_per_image``)."""
    _resnet_cell(smoke, NF_RESNET, RESNET_FLOPS_PER_IMAGE, {
        f"conv_{g}_k{k}": c for g in ("wgrad", "dgrad")
        for k, c in NF_CONV_LAUNCHES.items()}, check="imagenet_train")
    vit_flops = 3 * _vit_macs_per_image(224, 16, 768, VIT_LAYERS, 1000)
    # ViT trains with LAMB (SGD 0.1 / momentum 0.9 blows a ViT up)
    vit = _imagenet_cell(smoke, VIT, 2, 10, vit_flops, optimizer="lamb",
                         lr=1e-3)
    vit["flops_per_image"] = vit_flops
    emit(vit)
    _check_finite(vit)
    n = len(vit["losses"])
    want = {"flash_fwd": VIT_LAYERS * n, "flash_bwd": VIT_LAYERS * n,
            "conv_wgrad": 0, "conv_dgrad": 0}
    wrong = {k: (vit["launches"][k], w) for k, w in want.items()
             if vit["launches"][k] != w}
    if wrong:
        raise AssertionError(f"vit launches (got, want): {wrong}")
    smoke.add_launches(vit["launches"])
    for arch in CONVNETS:
        row = _imagenet_cell(smoke, dict(VIT, arch=arch), 2, 3)
        emit(row)
        _check_finite(row)


def phase_comm(smoke):
    """Every communicator method and in-step collective of the port's
    ``TorchDistCommunicator`` on the card at world 1 (the one-rank NCCL
    group; gloo carries the object lane), against ``NaiveCommunicator(
    size=1)`` on the same values: fp32 and int32 tensors, objects,
    ``split`` with one color (a new NCCL group) and ``send`` / ``recv``
    with ``source == dest``.  Data movement exact; sums rtol 1e-6."""
    import numpy as np
    import torch.distributed as dist

    torch = smoke.torch
    from chainermn_tpu_torch.communicators import (NaiveCommunicator,
                                                   create_communicator)
    from chainermn_tpu_torch.ops import collective as col

    comm = create_communicator("xla", device="cuda")
    naive = NaiveCommunicator(size=1)
    rng = np.random.RandomState(0)
    checked = []

    def same(name, got, want, exact=True):
        got = got.detach().cpu().numpy() if hasattr(got, "detach") \
            else np.asarray(got)
        want = np.asarray(want)
        if got.shape != want.shape or not (
                np.array_equal(got, want) if exact
                else np.allclose(got, want, rtol=1e-6, atol=0)):
            raise AssertionError(f"comm {name}: got {got}, want {want}")
        checked.append(name)

    for dt in (np.float32, np.int32):
        stack = (rng.randn(1, 4, 3) * 10).astype(dt)
        x = torch.from_numpy(stack[0]).cuda()
        tag = np.dtype(dt).name
        if x.device.type != "cuda":
            raise AssertionError("the input is not on the card")
        for op in ("sum", "max", "min"):
            same(f"allreduce/{op}/{tag}", comm.allreduce(x, op),
                 naive.allreduce(stack, op)[0])
        same(f"bcast/{tag}", comm.bcast(x, 0), naive.bcast(stack, 0)[0])
        same(f"gather/{tag}", comm.gather(x, 0), naive.gather(stack, 0))
        same(f"allgather/{tag}", comm.allgather(x), naive.allgather(stack)[0])
        same(f"scatter/{tag}", comm.scatter(torch.from_numpy(stack).cuda(),
                                            0), naive.scatter(stack, 0)[0])
        same(f"alltoall/{tag}", comm.alltoall(x[:1]),
             naive.alltoall(stack[:, :1])[0])
        same(f"send/{tag}", comm.send(x, dest=0, source=0),
             naive.send(stack, dest=0, source=0)[0])
        same(f"recv/{tag}", comm.recv(x, source=0, dest=0),
             naive.recv(stack, source=0, dest=0)[0])
        for name in ("psum", "pmax", "pmin"):
            same(f"{name}/{tag}", getattr(col, name)(x), stack[0])
        same(f"all_gather/{tag}", col.all_gather(x), stack[0])
        same(f"all_gather/untiled/{tag}", col.all_gather(x, tiled=False),
             stack)
        same(f"all_to_all/{tag}", col.all_to_all(x, split_axis=1,
                                                 concat_axis=0), stack[0])
        same(f"reduce_scatter/{tag}", col.reduce_scatter(x, scatter_axis=1),
             stack[0])
        same(f"ppermute/{tag}", col.ppermute(x, [(0, 0)]), stack[0])
        same(f"shift/{tag}", col.shift(x, 1), stack[0])
        same(f"bcast_col/{tag}", col.bcast(x, 0), stack[0])
    f = torch.from_numpy(rng.randn(5, 2).astype(np.float32)).cuda()
    same("allreduce/mean", comm.allreduce(f, "mean"),
         naive.allreduce(f.cpu().numpy()[None], "mean")[0], exact=False)
    same("pmean", col.pmean(f), f.cpu(), exact=False)
    same("pmean_if_bound", col.pmean_if_bound(f), f.cpu(), exact=False)
    same("mean_grad", comm.multi_node_mean_grad([f])[0], f.cpu(),
         exact=False)
    same("stack", comm.stack([f.cpu().numpy()]), f.cpu().numpy()[None])
    same("unstack", comm.unstack(f[None])[0], f.cpu())
    if (col.axis_index(), col.axis_size()) != (0, 1):
        raise AssertionError("axis_index / axis_size")
    checked.append("axis_index/axis_size")
    obj = {"a": [1, 2], "b": "x"}
    objs = {"bcast_obj": (comm.bcast_obj(obj), naive.bcast_obj(obj)),
            "gather_obj": (comm.gather_obj(obj), naive.gather_obj(obj)),
            "allgather_obj": (comm.allgather_obj(obj),
                              naive.allgather_obj(obj)),
            "allreduce_obj": (comm.allreduce_obj(3), naive.allreduce_obj(3))}
    comm.send_obj(obj, dest=0)
    naive.send_obj(obj, dest=0)
    objs["recv_obj"] = (comm.recv_obj(source=0), naive.recv_obj(source=0))
    for name, (got, want) in objs.items():
        if got != want:
            raise AssertionError(f"comm {name}: got {got}, want {want}")
        checked.append(name)
    (color, sub), = comm.split([0]).items()
    whole = comm.split(0)
    for name, c in (("split/seq", sub), ("split/scalar", whole)):
        if (c.size, c.rank) != (1, 0) or c.device != comm.device:
            raise AssertionError(f"{name}: size {c.size}, rank {c.rank}")
        same(name, c.allreduce(f), f.cpu(), exact=False)
    if str(comm.device_of(0)) != str(comm.device):
        raise AssertionError(f"device_of(0) {comm.device_of(0)}")
    checked.append("device_of")
    emit({"check": "comm", "world": comm.size,
          "backend": str(dist.get_backend()), "device": str(comm.device),
          "checked": len(checked), "names": checked})


def _span_ms(events, name):
    """Durations (ms) of the trace's complete events called ``name``, in
    order."""
    return [e["dur"] / 1e3 for e in events
            if e.get("ph") == "X" and e.get("name") == name]


def _trainer_timing(trace_path, warmup=3):
    """Iterations/s, update() ms (``step/data`` + ``step/compute``, host
    ``perf_counter``) and whole-step ms p50/p99 after ``warmup`` steps, and
    the two phase spans' medians, from the run's own trace; also every
    step's span summed, warm-up, evaluator and profiler steps included."""
    import statistics

    with open(trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    data, compute = _span_ms(events, "step/data"), _span_ms(events, "step/compute")
    steps = _span_ms(events, "step")
    if not (data and compute and steps):
        raise AssertionError(f"{trace_path}: no step, step/data or "
                             f"step/compute spans")
    update = [d + c for d, c in zip(data, compute)][warmup:]
    whole = steps[warmup:]
    return {"steps": len(steps), "steps_ms_total": sum(steps),
            "iterations_per_s": len(whole) / (sum(whole) / 1e3),
            "update_ms_p50": _percentile(update, 0.5),
            "update_ms_p99": _percentile(update, 0.99),
            "step_ms_p50": _percentile(whole, 0.5),
            "step_ms_p99": _percentile(whole, 0.99),
            "step_data_ms_median": statistics.median(data[warmup:]),
            "step_compute_ms_median": statistics.median(compute[warmup:])}


def _profile_window(trace_path, iterations):
    """Device busy ms per iteration (union of kernel, memcpy and memset
    intervals) and the idle share of the profiled window."""
    with open(trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    dev = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                 if e.get("ph") == "X"
                 and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, None
    for a, b in dev:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e
             and e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset")]
    wall = (max(e["ts"] + e["dur"] for e in spans)
            - min(e["ts"] for e in spans))
    return {"device_busy_ms_per_iteration": busy / 1e3 / iterations,
            "device_ops_per_iteration": len(dev) / iterations,
            "window_ms_per_iteration": wall / 1e3 / iterations,
            "device_idle_share": 1.0 - busy / wall}


MNIST = dict(unit=1000, batchsize=128, epoch=1, n_train=8192, n_val=1024)
# Adam (eps 1e-8) at width 1000 amplifies the order in which fp32 sums:
# noise of 3e-8 x max|g| in the gradients (under fp32's unit roundoff) moves
# this run's epoch loss by up to 2.7e-4 and its validation accuracy by up to
# 9/1024 on the CPU, 1e-7 x max|g| by 2.4e-4 and 15/1024
# (scripts/mnist_fp32_spread.py).  The card is held to the CPU within those
# spreads with margin, and to its own plain rerun at rtol 1e-4 and 1/1024.
MNIST_CPU_TOL = {"rtol": 1e-3, "accuracy": 32 / 1024}


def phase_trainer(smoke):
    """ChainerMN's own loop on the card, through the port's entry points,
    each run again on the CPU from the same seeds (fp32, TF32 off):
    (a) ``train.run`` (``python -m chainermn_tpu_torch.train``: 20 steps,
    the prefetch thread, a trace): every iteration's ``main/loss`` rtol
    1e-4, the final weights atol 1e-4, the trace's ``step`` /
    ``step/data`` / ``step/compute`` spans; (b) ``train_mnist.run`` at
    ``--unit 1000 --batchsize 128 --epoch 1`` (64 iterations, 8,192 rows)
    with the evaluator at the end, run twice on the card (with the
    prefetch thread, the trace and a ``torch.profiler`` window of
    iterations 10-19, which gives the device busy time and idle share;
    then plain): the two epoch losses rtol 1e-4 and evaluator accuracies
    within 1/1,024, and the card within ``MNIST_CPU_TOL`` of the CPU.
    No hand-written kernel is on this path: the launch counts must stay 0."""
    import math

    torch = smoke.torch
    from chainermn_tpu_torch import ops, train, train_mnist

    out = ROOT / "build" / "chip_smoke"
    out.mkdir(parents=True, exist_ok=True)
    ops.reset_launch_counts()
    runs = {}
    for dev in ("cuda", "cpu"):
        trace_path = out / f"demo_{dev}.json"
        result, trainer = train.run(
            ["--device", dev, "--steps", "20", "--log-every", "1",
             "--prefetch", "--out", str(out / f"demo_{dev}"),
             "--trace-out", str(trace_path)])
        log = trainer.get_extension("LogReport").log
        runs[dev] = (result, [e["main/loss"] for e in log],
                     {k: v.detach().cpu() for k, v in
                      trainer.updater.state[0].items()}, trace_path)
        if dev == "cuda" and any(v.device.type != "cuda" for v in
                                 trainer.updater.state[0].values()):
            raise AssertionError("the demo's weights are not on the card")
    (res_c, loss_c, par_c, trace_c), (_, loss_h, par_h, _) = \
        runs["cuda"], runs["cpu"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(loss_c, loss_h))
    par_err = max(float((par_c[k] - par_h[k]).abs().max()) for k in par_h)
    names = {e["name"] for e in json.load(open(trace_c))["traceEvents"]}
    row = {"check": "trainer_demo", "card": smoke.card, "steps": 20,
           "world": res_c["world"], "card_losses": loss_c,
           "cpu_losses": loss_h, "loss_max_rel_err": loss_err,
           "param_max_abs_err": par_err, "rtol": 1e-4, "atol": 1e-4,
           "trace_events": res_c["trace_events"],
           **_trainer_timing(trace_c)}
    emit(row)
    missing = {"step", "step/data", "step/compute"} - names
    if len(loss_c) != 20 or loss_err > 1e-4 or par_err > 1e-4 or missing \
            or not all(math.isfinite(v) for v in loss_c):
        raise AssertionError(f"demo trainer: loss rel err {loss_err}, param "
                             f"err {par_err}, spans missing {missing}")

    runs = {}
    for label, dev in (("card", "cuda"), ("card_plain", "cuda"),
                       ("cpu", "cpu")):
        argv = ["--device", dev, "--out", str(out / f"mnist_{label}")] + [
            f"--{k.replace('_', '-')}={v}" for k, v in MNIST.items()]
        if label == "card":
            argv += ["--prefetch", "--trace-out", str(out / "mnist.json"),
                     "--profile-out", str(out / "mnist_profile")]
        t0 = time.perf_counter()
        result, trainer = train_mnist.run(argv)
        runs[label] = (result, trainer, time.perf_counter() - t0)
    (res_c, tr_c, wall_c), (res_p, _, _), (res_h, _, wall_h) = (
        runs["card"], runs["card_plain"], runs["cpu"])
    prof = tr_c.get_extension("TorchProfiler")
    window = prof.stop_iteration - prof.start_iteration

    def loss_err(a, b):
        return abs(a["epoch_losses"][0] - b["epoch_losses"][0]) \
            / abs(b["epoch_losses"][0])

    def acc_err(a, b):
        return abs(a["validation/accuracy"] - b["validation/accuracy"])

    launches = ops.launch_counts()
    row = {"check": "trainer_mnist", "card": smoke.card, **MNIST,
           "iterations": res_c["iterations"], "world": res_c["world"],
           "card_epoch_loss": res_c["epoch_losses"][0],
           "card_plain_epoch_loss": res_p["epoch_losses"][0],
           "cpu_epoch_loss": res_h["epoch_losses"][0],
           "card_val_accuracy": res_c["validation/accuracy"],
           "cpu_val_accuracy": res_h["validation/accuracy"],
           "card_val_loss": res_c["validation/loss"],
           "plain_loss_rel_err": loss_err(res_c, res_p),
           "plain_val_accuracy_err": acc_err(res_c, res_p),
           "plain_tol": {"rtol": 1e-4, "accuracy": 1 / 1024},
           "cpu_loss_rel_err": loss_err(res_c, res_h),
           "cpu_val_accuracy_err": acc_err(res_c, res_h),
           "cpu_tol": MNIST_CPU_TOL,
           "run_s_card": wall_c, "run_s_cpu": wall_h,
           "kernel_launches": launches,
           **_trainer_timing(out / "mnist.json"),
           "profiled_iterations": window,
           **_profile_window(prof.trace_path, window)}
    emit(row)
    bad = []
    if res_c["iterations"] != 64 or not math.isfinite(res_c["epoch_losses"][0]):
        bad.append(f"{res_c['iterations']} iterations, loss "
                   f"{res_c['epoch_losses']}")
    if row["plain_loss_rel_err"] > 1e-4 or \
            row["plain_val_accuracy_err"] > 1 / 1024:
        bad.append("the prefetch / traced run left the trajectory")
    if row["cpu_loss_rel_err"] > MNIST_CPU_TOL["rtol"] or \
            row["cpu_val_accuracy_err"] > MNIST_CPU_TOL["accuracy"]:
        bad.append("card and CPU apart by more than fp32 reordering moves "
                   "Adam")
    if any(launches.values()):
        bad.append(f"kernel launches {launches}")

    # the strict leg: plain SGD (lr 0.1) does not amplify fp32 rounding as
    # Adam does, so the card's epoch loss is held to the CPU's at rtol 1e-4.
    # The evaluator's loss and accuracy, read after the last step alone, are
    # reported: rounding-level gradient noise moves them by up to 3.2e-5
    # and 2/1,024 on the CPU alone, single iterations by up to 5.3e-4
    # (scripts/mnist_fp32_spread.py --optimizer sgd --lr 0.1)
    sgd = {}
    for dev in ("cuda", "cpu"):
        argv = ["--device", dev, "--out", str(out / f"mnist_sgd_{dev}"),
                "--optimizer", "sgd"] + [
            f"--{k.replace('_', '-')}={v}" for k, v in MNIST.items()]
        sgd[dev] = train_mnist.run(argv + ["--lr", "0.1"])[0]
    row = {"check": "trainer_mnist_sgd", "card": smoke.card, **MNIST,
           "optimizer": "sgd", "lr": 0.1,
           "iterations": sgd["cuda"]["iterations"],
           "card_epoch_loss": sgd["cuda"]["epoch_losses"][0],
           "cpu_epoch_loss": sgd["cpu"]["epoch_losses"][0],
           "card_val_loss": sgd["cuda"]["validation/loss"],
           "cpu_val_loss": sgd["cpu"]["validation/loss"],
           "card_val_accuracy": sgd["cuda"]["validation/accuracy"],
           "cpu_val_accuracy": sgd["cpu"]["validation/accuracy"],
           "cpu_loss_rel_err": loss_err(sgd["cuda"], sgd["cpu"]),
           "cpu_val_loss_rel_err": abs(
               sgd["cuda"]["validation/loss"] - sgd["cpu"]["validation/loss"])
           / abs(sgd["cpu"]["validation/loss"]),
           "cpu_val_accuracy_err": acc_err(sgd["cuda"], sgd["cpu"]),
           "cpu_tol": {"rtol": 1e-4}}
    emit(row)
    if sgd["cuda"]["iterations"] != 64 or row["cpu_loss_rel_err"] > 1e-4:
        bad.append(f"SGD leg: card vs CPU loss rel err "
                   f"{row['cpu_loss_rel_err']}")
    if any(ops.launch_counts().values()):
        bad.append(f"kernel launches {ops.launch_counts()}")
    if bad:
        raise AssertionError(f"train_mnist: {bad}")


OBS_STEPS = dict(warm=3, timed=10)     # the ResNet-50 leg's steps
OBS_NAN_AT = 3                          # the NaN run's poisoned iteration
OBS_STEP_KEYS = ("time/data", "time/compute", "throughput/items_per_sec",
                 "comm/bytes", "comm/calls")


def _obs_demo(smoke, out):
    """Leg (a): the demo CLI's run with the metrics stream and a trace,
    on the card and on the CPU."""
    from chainermn_tpu_torch import train
    from chainermn_tpu_torch.observability import export

    runs = {}
    for dev in ("cuda", "cpu"):
        metrics_path = out / f"demo_{dev}.jsonl"
        result, _ = train.run(
            ["--device", dev, "--steps", "20", "--log-every", "10",
             "--out", str(out / f"demo_{dev}"), "--metrics-out",
             str(metrics_path), "--trace-out", str(out / f"demo_{dev}.json")])
        records = export.read_metrics_jsonl(str(metrics_path), strict=True)
        prom = export.parse_prometheus_text(
            open(f"{metrics_path}.prom").read())
        runs[dev] = (result, records, prom)
    (res, recs, prom), (res_h, recs_h, _) = runs["cuda"], runs["cpu"]
    steps = [r for r in recs if r["kind"] == "step"]
    summary = next(r for r in recs if r["kind"] == "summary")
    # the loss, comm-bytes and MFU detectors must stay quiet; the
    # step-time detector, at JAX's defaults (1.5x and 4 sigma over an
    # EWMA), is reported: a few ms of host work (the .prom write and
    # fsync every 10 iterations, a collection) is a real 1.5x spike of
    # this host-bound step once the process is warm
    found = {dev: next(r for r in runs[dev][1] if r["kind"] == "summary")[
        "anomalies"] for dev in runs}
    judged = {dev: {k: n for k, n in a["counts"].items()
                    if k != "step_time_spike"} for dev, a in found.items()}
    missing = sorted({k for r in steps for k in OBS_STEP_KEYS if k not in r})
    row = {"check": "observability_demo", "card": smoke.card,
           "steps": len(steps),
           "kinds": [r["kind"] for r in recs],
           "comm_bytes_per_step": [r["comm/bytes"] for r in steps],
           "items_per_sec_p50": _percentile(
               [r["throughput/items_per_sec"] for r in steps], 0.5),
           "prom_samples": len(prom["samples"]),
           "anomalies": summary["anomalies"]["counts"],
           "cpu_anomalies": found["cpu"]["counts"],
           "step_time_spikes": {dev: [
               {k: f[k] for k in ("iteration", "value", "expected")}
               for f in a["findings"] if f["kind"] == "step_time_spike"]
               for dev, a in found.items()},
           "iteration_ms": [1e3 * sum(r.get(k, 0.0) for k in (
               "time/data", "time/compute", "time/extensions"))
               for r in steps],
           "result_keys": sorted(res), "cpu_result_keys": sorted(res_h),
           "straggler_rank": res["straggler_rank"],
           "step_time_skew": res["step_time_skew"]}
    emit(row)
    bad = []
    if len(steps) != 20 or missing:
        bad.append(f"{len(steps)} step records, keys missing {missing}")
    if sorted(res) != sorted(res_h):
        bad.append("the card's result keys are not the CPU's")
    if judged["cuda"] or judged["cpu"]:
        bad.append(f"loss / comm / MFU findings on a clean run: {judged}")
    if [r["comm/bytes"] for r in steps] != \
            [r["comm/bytes"] for r in recs_h if r["kind"] == "step"]:
        bad.append("comm bytes a step differ from the CPU's")
    if bad:
        raise AssertionError(f"demo metrics stream: {bad}")


def _obs_r50_run(smoke, step, model, comm, batch, steps, out, extensions,
                 nan_at=None):
    """``steps`` iterations of the ResNet-50 step through Trainer +
    StandardUpdater (the robustness phase's wiring); with ``extensions``,
    tracing on and the step breakdown, the health monitor and the metrics
    stream.  Returns each step's loss and synchronised ms, the wall time
    from each step call's start to the next (data, step and extensions),
    the metrics records and the monitor."""
    from chainermn_tpu_torch import observability as obs
    from chainermn_tpu_torch.training import StandardUpdater, Trainer

    run = {"losses": [], "ms": [], "starts": [], "records": [],
           "monitor": None}

    def step_fn(state, b):
        run["starts"].append(time.perf_counter())
        loss, _ = step(model, b)
        run["losses"].append(float(loss))              # synchronises
        run["ms"].append((time.perf_counter() - run["starts"][-1]) * 1e3)
        if nan_at == len(run["ms"]):
            loss = loss * float("nan")
        return state, {"main/loss": loss}

    updater = StandardUpdater(_OneBatch(batch), step_fn,
                              (model, step.optimizer), converter=lambda b: b,
                              mesh=comm.mesh, device=comm.device)
    trainer = Trainer(updater, (steps, "iteration"), out=str(out))
    path = out / "metrics.jsonl"
    if extensions:
        obs.reset_all()
        obs.enable()
        run["monitor"] = obs.HealthMonitor()
        trainer.extend(obs.StepBreakdownReport(
            flops_per_item=RESNET_FLOPS_PER_IMAGE))
        trainer.extend(run["monitor"])
        trainer.extend(obs.MetricsReport(str(path),
                                         prometheus_path=f"{path}.prom",
                                         monitor=run["monitor"]))
    try:
        trainer.run()
    finally:
        obs.disable()
    starts = run["starts"]
    run["walls"] = [(b - a) * 1e3 for a, b in zip(starts, starts[1:])]
    if extensions:
        run["records"] = obs.read_metrics_jsonl(str(path), strict=True)
        obs.parse_prometheus_text(open(f"{path}.prom").read())
    return run


def _obs_cpu_comm_bytes(out):
    """``comm/bytes`` of a ResNet-50 step on the CPU: the same build (the
    byte count depends on the parameter and statistics tree only), image
    64, batch 2, two steps."""
    from chainermn_tpu_torch import observability as obs
    from chainermn_tpu_torch.train_imagenet import build_step, synthetic_batch
    from chainermn_tpu_torch.training import StandardUpdater, Trainer

    step, model, comm = build_step("resnet50", 64, conv_impl="pallas",
                                   num_classes=RESNET["classes"],
                                   device="cpu", seed=0)
    batch = synthetic_batch(2, 64, RESNET["classes"])
    updater = StandardUpdater(
        _OneBatch(batch), lambda st, b: (st, {"main/loss": step(model, b)[0]}),
        (model, step.optimizer), converter=lambda b: b, mesh=comm.mesh,
        device="cpu")
    trainer = Trainer(updater, (2, "iteration"), out=str(out / "cpu"))
    path = out / "cpu.jsonl"
    trainer.extend(obs.StepBreakdownReport())
    trainer.extend(obs.MetricsReport(str(path)))
    obs.reset_all()
    obs.enable()
    try:
        trainer.run()
    finally:
        obs.disable()
    recs = obs.read_metrics_jsonl(str(path))
    return [(r["comm/bytes"], r["comm/calls"]) for r in recs
            if r["kind"] == "step"]


def phase_observability(smoke):
    """The metrics stream, the comm ledger and the detectors on the card:
    (a) the demo CLI with ``--metrics-out`` / ``--trace-out``, card and
    CPU; (b) ResNet-50 at the headline size through the Trainer with the
    step breakdown, the health monitor and the metrics stream (conv
    launches, the MFU gauge against the smoke's own, comm bytes against
    the CPU's, no finding), then a NaN loss that the monitor must find;
    (c) the step ms with and without the instrumentation, in turns
    (printed)."""
    import math
    import shutil

    torch = smoke.torch
    from chainermn_tpu_torch import ops
    from chainermn_tpu_torch.train_imagenet import build_step, synthetic_batch

    out = ROOT / "build" / "chip_smoke" / "observability"
    shutil.rmtree(out, ignore_errors=True)   # the streams append
    out.mkdir(parents=True)
    _obs_demo(smoke, out)

    step, model, comm = build_step("resnet50", RESNET["image"],
                                   conv_impl="pallas",
                                   num_classes=RESNET["classes"], seed=0)
    batch = synthetic_batch(RESNET["batch"] * comm.size, RESNET["image"],
                            RESNET["classes"])
    warm, n = OBS_STEPS["warm"], OBS_STEPS["warm"] + OBS_STEPS["timed"]
    # (b) instrumented: tracing and the three extensions; the launch
    # counts cover this run alone
    ops.reset_launch_counts()
    on = _obs_r50_run(smoke, step, model, comm, batch, n, out / "r50_on",
                      True)
    counts = ops.launch_counts()
    steps = [r for r in on["records"] if r["kind"] == "step"]
    summary = next(r for r in on["records"] if r["kind"] == "summary")
    timed = steps[warm:]
    # the smoke's own MFU over the same iterations: FLOPs over the wall
    # time from one step call's start to the next, the same span
    # (data, step, extensions) that the gauge divides by
    flops = RESNET_FLOPS_PER_IMAGE * RESNET["batch"]
    peak = PEAK_FLOPS["bfloat16"]
    mfu_smoke = flops / (_percentile(on["walls"][warm:], 0.5) / 1e3) / peak
    mfu_gauge = _percentile([r["perf/mfu"] for r in timed], 0.5)
    cpu_comm = _obs_cpu_comm_bytes(out)
    # (c) the same steps without tracing or the extensions, in turns with
    # two more instrumented runs (off, on, on, off): the first run of a
    # model also warms the pinned-memory allocator its uploads use
    turns = {"off": [], "on": []}
    for i, label in enumerate(("off", "on", "on", "off")):
        turns[label].append(_obs_r50_run(
            smoke, step, model, comm, batch, n, out / f"r50_turn{i}",
            label == "on"))

    def timed_of(label, key):
        return [v for r in turns[label] for v in r[key][warm:]]
    # a poisoned loss: the monitor must find it and the stream carry it
    nan = _obs_r50_run(smoke, step, model, comm, batch, OBS_NAN_AT + 1,
                       out / "r50_nan", True, nan_at=OBS_NAN_AT)
    nan_summary = next(r for r in nan["records"] if r["kind"] == "summary")

    def p50(xs):
        return _percentile(xs, 0.5)

    row = {"check": "observability_resnet50", "card": smoke.card,
           **RESNET, "dtype": "bfloat16", "conv_impl": "pallas",
           "warm": warm, "timed": OBS_STEPS["timed"],
           "conv_launches_per_step": {k: counts[k] / n
                                      for k in ("conv_wgrad", "conv_dgrad")},
           "mfu_gauge_p50": mfu_gauge, "mfu_smoke_p50": mfu_smoke,
           "mfu_gauge_over_smoke": mfu_gauge / mfu_smoke,
           "mfu_step_call_p50": flops / (p50(on["ms"][warm:]) / 1e3) / peak,
           "time_data_ms_p50": p50([r["time/data"] for r in timed]) * 1e3,
           "time_compute_ms_p50": p50([r["time/compute"]
                                       for r in timed]) * 1e3,
           "time_extensions_ms_p50": p50([r["time/extensions"]
                                          for r in timed]) * 1e3,
           "time_comm_ms_p50": p50([r["time/comm"] for r in timed]) * 1e3,
           "comm_bytes_per_step": [r["comm/bytes"] for r in steps],
           "comm_calls_per_step": [r["comm/calls"] for r in steps],
           "comm_per_op": summary["last_step_comm"]["per_op"],
           "cpu_comm_bytes_calls": cpu_comm,
           "anomalies": summary["anomalies"]["counts"],
           "nan_findings": nan_summary["anomalies"]["findings"],
           "losses": on["losses"],
           "first_run_step_ms_p50": p50(on["ms"][warm:]),
           "first_run_iteration_ms_p50": p50(on["walls"][warm:]),
           "turn_iteration_ms_p50": [p50(r["walls"][warm:]) for r in
                                     (turns["off"][0], *turns["on"],
                                      turns["off"][1])]}
    for label, key in (("with", "on"), ("without", "off")):
        for what, k in (("step", "ms"), ("iteration", "walls")):
            xs = timed_of(key, k)
            row[f"{what}_ms_p50_{label}"] = p50(xs)
            row[f"{what}_ms_p99_{label}"] = _percentile(xs, 0.99)
    for what in ("step", "iteration"):
        row[f"overhead_{what}_p50_frac"] = \
            row[f"{what}_ms_p50_with"] / row[f"{what}_ms_p50_without"] - 1
    emit(row)
    bad = []
    want = {k: RESNET_CONV_LAUNCHES for k in ("conv_wgrad", "conv_dgrad")}
    if row["conv_launches_per_step"] != want:
        bad.append(f"conv launches a step {row['conv_launches_per_step']}")
    if len(steps) != n or not all(math.isfinite(v) for v in on["losses"]):
        bad.append(f"{len(steps)} step records, losses {on['losses']}")
    if abs(mfu_gauge / mfu_smoke - 1) > 0.10:
        bad.append(f"perf/mfu {mfu_gauge} vs the smoke's {mfu_smoke}")
    card_comm = {(r["comm/bytes"], r["comm/calls"]) for r in steps}
    if card_comm != set(cpu_comm):
        bad.append(f"comm bytes/calls a step {card_comm} vs the CPU's "
                   f"{set(cpu_comm)}")
    if summary["anomalies"]["counts"]:
        bad.append(f"findings on a clean run {summary['anomalies']}")
    kinds = [f["kind"] for f in nan_summary["anomalies"]["findings"]]
    if "loss_nonfinite" not in kinds or \
            nan["monitor"].counts.get("loss_nonfinite", 0) < 1:
        bad.append(f"the NaN loss was not found: {kinds}")
    if bad:
        raise AssertionError(f"observability: {bad}")
    smoke.add_launches(counts)
    del step, model, batch
    torch.cuda.empty_cache()


def _seq2seq_argv(cfg, device, out, *extra):
    return ["--device", device, "--out", str(out)] + [
        f"--{k.replace('_', '-')}={v}" for k, v in cfg.items()] + list(extra)


def _translation_parity(torch, card_model, cpu_model, src, max_len):
    """Greedy tokens of the card's model against the CPU's (``_near_ties``
    on the CPU's logits)."""
    from chainermn_tpu_torch.models.seq2seq import BOS

    got = card_model.translate(src.cuda(), max_len=max_len).cpu()
    want = cpu_model.translate(src, max_len=max_len)

    def cpu_logits(i, t):
        tin = torch.cat([torch.tensor([BOS]), want[i, :t]])[None]
        with torch.no_grad():
            return cpu_model(src[i:i + 1], tin)[0, -1]

    return _near_ties("seq2seq translation", got, want, cpu_logits)


def phase_seq2seq(smoke):
    """BASELINE config #3 through ``train_seq2seq.run`` (Trainer →
    StandardUpdater → make_train_step, the evaluator each epoch, four greedy
    translations, BLEU): first the fp32 leg at ``SEQ2SEQ_PARITY`` (3 steps,
    TF32 off) on the card and on the CPU from the same seeds, every
    iteration's loss rtol 1e-4 and the greedy tokens equal (or a CPU
    near-tie); then bf16 at ``SEQ2SEQ``'s full width on the card: target
    tokens/s (the epoch's non-PAD ``tgt_out`` tokens over the sum of every
    ``step`` span), step ms p50/p99 (the spans after 3 warm-up steps), peak
    memory, and the device busy
    time, ops and idle share of a ``torch.profiler`` window of iterations
    10-14.  No hand-written kernel is on this path: the launch counts, zeroed
    before the runs, must stay 0."""
    import math

    torch = smoke.torch
    from chainermn_tpu_torch import ops, train_seq2seq
    from chainermn_tpu_torch.models.seq2seq import PAD, encode_pairs

    out = ROOT / "build" / "chip_smoke"
    out.mkdir(parents=True, exist_ok=True)
    ops.reset_launch_counts()
    runs = {}
    for dev in ("cuda", "cpu"):
        result, trainer = train_seq2seq.run(_seq2seq_argv(
            SEQ2SEQ_PARITY, dev, out / f"s2s_parity_{dev}", "--dtype",
            "float32"))
        runs[dev] = (result, trainer.updater.state[0])
    (res_c, model_c), (res_h, model_h) = runs["cuda"], runs["cpu"]
    loss_err = max(abs(a - b) / abs(b) for a, b in
                   zip(res_c["iteration_losses"], res_h["iteration_losses"]))
    pairs = train_seq2seq.make_corpus(SEQ2SEQ_PARITY["n_val"],
                                      SEQ2SEQ_PARITY["vocab"], seed=2,
                                      max_len=SEQ2SEQ_PARITY["max_len"])
    bucket = SEQ2SEQ_PARITY["bucket"]
    src = torch.from_numpy(encode_pairs(pairs, bucket, bucket)[0])
    equal, near = _translation_parity(torch, model_c, model_h, src, bucket)
    emit({"check": "seq2seq_parity", "dtype": "float32", **SEQ2SEQ_PARITY,
          "card_losses": res_c["iteration_losses"],
          "cpu_losses": res_h["iteration_losses"],
          "loss_max_rel_err": loss_err, "rtol": 1e-4,
          "card_val_loss": res_c["validation/loss"],
          "cpu_val_loss": res_h["validation/loss"],
          "translated_rows": len(src), "equal_rows": equal,
          "near_ties": near, "card_bleu": res_c["bleu"],
          "cpu_bleu": res_h["bleu"]})
    if len(res_c["iteration_losses"]) != 3 or loss_err > 1e-4:
        raise AssertionError(f"seq2seq card vs CPU: loss rel err {loss_err}")
    del runs, model_c, model_h

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result, trainer = train_seq2seq.run(_seq2seq_argv(
        SEQ2SEQ, "cuda", out / "s2s", "--trace-out", str(out / "s2s.json"),
        "--profile-out", str(out / "s2s_profile")))
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    model = trainer.updater.state[0]
    prof = trainer.get_extension("TorchProfiler")
    window = prof.stop_iteration - prof.start_iteration
    timing = _trainer_timing(out / "s2s.json")
    pairs = train_seq2seq.make_corpus(SEQ2SEQ["n_train"], SEQ2SEQ["vocab"],
                                      seed=1, max_len=SEQ2SEQ["max_len"])
    _, _, tout = encode_pairs(pairs, SEQ2SEQ["bucket"], SEQ2SEQ["bucket"])
    # one epoch walks every pair once: the run's target tokens over the
    # time of all its steps
    tokens = int((tout != PAD).sum())
    losses = result["iteration_losses"]
    row = {"check": "seq2seq", "card": smoke.card, "dtype": result["dtype"],
           **SEQ2SEQ, "world": result["world"],
           "n_params": sum(p.numel() for p in model.parameters()),
           "iterations": result["iterations"], "losses": losses,
           "epoch_loss": result["epoch_losses"][0],
           "validation/loss": result["validation/loss"],
           "validation/accuracy": result["validation/accuracy"],
           "bleu": result["bleu"], "translations": result["translations"],
           "run_s": wall, "target_tokens": tokens, **timing,
           "target_tokens_per_s": tokens / (timing["steps_ms_total"] / 1e3),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
           "kernel_launches": launches, "profiled_iterations": window,
           **_profile_window(prof.trace_path, window)}
    emit(row)
    bad = []
    if result["iterations"] < 40 or len(losses) != result["iterations"] \
            or timing["steps"] != result["iterations"]:
        bad.append(f"{result['iterations']} iterations")
    if not all(math.isfinite(v) for v in losses + [
            result["validation/loss"], result["validation/accuracy"]]) \
            or not losses[-1] < losses[0]:
        bad.append(f"losses not finite and falling: {losses}")
    if not 0.0 <= result["bleu"] <= 1.0 or len(result["translations"]) != 4:
        bad.append(f"BLEU {result['bleu']}, {result['translations']}")
    if result["dtype"] != "bfloat16" or any(
            p.device.type != "cuda" for p in model.parameters()):
        bad.append("the model is not bf16 on the card")
    if any(launches.values()):
        bad.append(f"kernel launches {launches}")
    if bad:
        raise AssertionError(f"seq2seq: {bad}")


def phase_model_parallel(smoke):
    """BASELINE config #5's pieces at world 1 on the card (NCCL cannot put
    two ranks on one card), each against the CPU on the same values in
    fp32: a ``MultiNodeChainList`` of the model-parallel MLP's two
    stages, both on rank 0 and joined by a self-edge (the output and every
    gradient of the sigmoid BCE; against the naive communicator on the
    CPU); every differentiable function of ``functions`` (and the private
    all-reduce), forward and backward, on the card's NCCL group against the
    same group's gloo side; ``MultiNodeBatchNormalization`` (two training
    calls, the gradients, the running statistics, the running-average
    output).  Each entry within rtol 1e-5 and an atol of 1e-5 of its
    tensor's largest entry.  No hand-written kernel is on this path."""
    import numpy as np
    import torch.nn.functional as tF

    torch = smoke.torch
    from chainermn_tpu_torch import functions as F
    from chainermn_tpu_torch import ops
    from chainermn_tpu_torch.communicators import (NaiveCommunicator,
                                                   create_communicator)
    from chainermn_tpu_torch.functions.collective import _pmean, _psum
    from chainermn_tpu_torch.functions.point_to_point import ring_exchange
    from chainermn_tpu_torch.links import (MultiNodeBatchNormalization,
                                           MultiNodeChainList)
    from chainermn_tpu_torch.train_model_parallel import (init_params,
                                                          make_task)

    comm = create_communicator("xla", device="cuda")
    ops.reset_launch_counts()
    checked, worst = [], [0.0]

    def close(name, got, want):
        """Elementwise ``|card − CPU| <= 1e-5 · |CPU| + 1e-5 · max |CPU|``:
        the atol follows the tensor's largest entry, since a summed
        gradient (a BatchNorm scale, a weight) errs by its terms' size, not
        by its own."""
        got, want = got.detach().float().cpu(), want.detach().float().cpu()
        if got.shape != want.shape:
            raise AssertionError(f"model-parallel {name}: shapes "
                                 f"{tuple(got.shape)} {tuple(want.shape)}")
        ref = float(want.abs().max())
        excess = float(((got - want).abs() - 1e-5 * want.abs()).max())
        worst[0] = max(worst[0], excess / max(ref, 1e-30))
        if not torch.allclose(got, want, rtol=1e-5, atol=1e-5 * ref):
            raise AssertionError(
                f"model-parallel {name}: max err "
                f"{float((got - want).abs().max())}, max |ref| {ref}")
        checked.append(name)

    xs, ys = make_task()
    params = init_params(32)

    def stage0(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    def stage1(p, h):
        return h @ p["w"] + p["b"]

    chains = {}
    for dev, c in (("cuda", comm), ("cpu", NaiveCommunicator(size=1))):
        mnc = MultiNodeChainList(c)
        mnc.add_link(stage0, params["w0"], rank=0, rank_in=None, rank_out=0)
        mnc.add_link(stage1, params["w1"], rank=0, rank_in=0, rank_out=None)
        out = mnc(torch.from_numpy(xs).to(dev))
        tF.binary_cross_entropy_with_logits(
            out, torch.from_numpy(ys).to(dev)).backward()
        chains[dev] = (out, {f"stage{i}.{k}": v for i, p in
                             enumerate(mnc.params()) for k, v in p.items()})
    (out_c, par_c), (out_h, par_h) = chains["cuda"], chains["cpu"]
    if out_c.device.type != "cuda" or any(
            v.device.type != "cuda" for v in par_c.values()):
        raise AssertionError("the chain list's stages are not on the card")
    close("chain/output", out_c, out_h)
    for k in par_h:
        close(f"chain/grad/{k}", par_c[k].grad, par_h[k].grad)

    cases = {
        "send": lambda b: F.send(b, dest=0, source=0),
        "recv": lambda b: F.recv(b, source=0, dest=0),
        "ring_exchange": lambda b: ring_exchange(b, 1),
        "bcast": lambda b: F.bcast(b, root=0),
        "allgather": lambda b: F.allgather(b),
        "allgather_tiled": lambda b: F.allgather(b, axis=1, tiled=True),
        "all_to_all": lambda b: F.all_to_all(b[:1]),
        "all_to_all_tiled": lambda b: F.all_to_all(
            b, split_axis=1, concat_axis=0, tiled=True),
        "scatter": lambda b: F.scatter(b[None], root=0),
        "gather": lambda b: F.gather(b, root=0),
        "pseudo_connect": lambda b: F.pseudo_connect(
            F.send(b, dest=0, source=0), b * 2.0),
        "psum": lambda b: _psum(b),
        "pmean": lambda b: _pmean(b),
    }
    x = np.random.RandomState(3).randn(64, 1024).astype(np.float32)
    for name, fn in cases.items():
        res = {}
        for dev in ("cuda", "cpu"):
            b = torch.from_numpy(x).to(dev).requires_grad_(True)
            y = fn(b)
            w = torch.randn(y.shape, generator=torch.Generator()
                            .manual_seed(7)).to(dev)
            (y * w).sum().backward()
            res[dev] = (y, b.grad)
        close(f"functions/{name}", res["cuda"][0], res["cpu"][0])
        close(f"functions/{name}/grad", res["cuda"][1], res["cpu"][1])

    xb = (np.random.RandomState(4).randn(256, 1024) * 3 + 1).astype(
        np.float32)
    wb = np.random.RandomState(5).randn(256, 1024).astype(np.float32)
    bns = {}
    for dev in ("cuda", "cpu"):
        bn = MultiNodeBatchNormalization(1024).to(dev)
        xt = torch.from_numpy(xb).to(dev).requires_grad_(True)
        y = bn(xt)
        (y * torch.from_numpy(wb).to(dev)).sum().backward()
        bn(torch.from_numpy(xb * 0.5).to(dev))
        bns[dev] = {"y": y, "dx": xt.grad, "dscale": bn.scale.grad,
                    "dbias": bn.bias.grad, "mean": bn.mean, "var": bn.var,
                    "y_ra": bn(torch.from_numpy(xb).to(dev),
                               use_running_average=True)}
    for k in bns["cpu"]:
        close(f"batchnorm/{k}", bns["cuda"][k], bns["cpu"][k])
    launches = ops.launch_counts()
    emit({"check": "model_parallel", "world": comm.size,
          "device": str(comm.device), "rtol": 1e-5, "atol_of_max_ref": 1e-5,
          "max_err_beyond_rtol_over_max_ref": worst[0],
          "checked": len(checked), "names": checked,
          "kernel_launches": launches})
    print("model-parallel at world 2 (the chain list across processes, "
          "send / recv, the collectives' backward, the synchronized "
          "BatchNorm) is held to JAX over gloo on the CPU "
          "(tests/test_torch_{functions,links,model_parallel}.py) until "
          "two cards are given: one card cannot hold two NCCL ranks",
          flush=True)
    if any(launches.values()):
        raise AssertionError(f"kernel launches {launches}")


# ---------------------------------------------------------------------------
# robustness: checkpoints, resume, preemption, elastic resume
# ---------------------------------------------------------------------------

ROBUST_EVERY = 4           # the checkpointer's save cadence, iterations
ROBUST_STEPS = 8           # leg U's uninterrupted steps
ROBUST_TIMING_STEPS = 16   # the timing leg: four saves, two of them warm
MNIST_UNIT = 1000
DEMO_STEPS = 600           # long enough for SIGTERM to land mid-run


class _OneBatch:
    """An iterator over ``bench.py``'s one repeated global batch, with the
    resume contract of ``SerialIterator`` (its position)."""

    epoch, is_new_epoch, epoch_detail = 0, False, 0.0

    def __init__(self, batch):
        self.batch, self.position = batch, 0

    def next(self):
        self.position += 1
        return self.batch

    def state_dict(self):
        return {"position": self.position}

    def load_state_dict(self, state):
        self.position = int(state["position"])


def _r50_trainer(smoke, seed, db, stop, out, cp=None, clone_at=None):
    """ResNet-50 at the headline size (``train_imagenet.build_step``: bf16,
    image 224, batch 128, SGD 0.1 / 0.9 / 1e-4, ``conv_impl="pallas"``)
    driven by Trainer + StandardUpdater, the checkpointer ``cp`` as an
    extension through ``training.extensions.snapshot`` (every
    ``ROBUST_EVERY`` iterations).  Returns ``(trainer, record)``: every
    step's loss, its synchronised ms and whether a checkpoint write was in
    flight when it began, and at ``clone_at`` a device clone of the whole
    state (the updater's ``state_dict``)."""
    torch = smoke.torch
    from chainermn_tpu_torch.train_imagenet import build_step, synthetic_batch
    from chainermn_tpu_torch.training import StandardUpdater, Trainer
    from chainermn_tpu_torch.training.extensions import snapshot
    from chainermn_tpu_torch.training.trainer import make_extension

    step, model, comm = build_step("resnet50", RESNET["image"],
                                   conv_impl="pallas",
                                   num_classes=RESNET["classes"],
                                   double_buffering=db, seed=seed)
    batch = synthetic_batch(RESNET["batch"] * comm.size, RESNET["image"],
                            RESNET["classes"])
    rec = {"losses": [], "ms": [], "in_flight": [], "clone": None}

    def step_fn(state, b):
        rec["in_flight"].append(cp is not None and cp._pending is not None
                                and not cp._pending.done())
        t0 = time.perf_counter()
        loss, _ = step(model, b)
        rec["losses"].append(float(loss))          # synchronises
        rec["ms"].append((time.perf_counter() - t0) * 1e3)
        return state, {"main/loss": loss}

    updater = StandardUpdater(_OneBatch(batch), step_fn,
                              (model, step.optimizer), converter=lambda b: b,
                              mesh=comm.mesh, device=comm.device)
    trainer = Trainer(updater, (stop, "iteration"), out=str(out))
    if cp is not None:
        trainer.extend(snapshot(cp, trigger=(ROBUST_EVERY, "iteration")))
    if clone_at is not None:
        @make_extension(trigger=(clone_at, "iteration"), name="clone")
        def _clone(tr):
            if tr.iteration == clone_at:
                rec["clone"] = tr.updater.state_dict()["state"]
        trainer.extend(_clone)
    return trainer, rec


def _state_tensors(state):
    """``(path, tensor)`` of a ``(model, optimizer)`` state snapshot."""
    import torch

    from chainermn_tpu_torch import _tree

    return [(p, x) for p, x in _tree.flatten_with_path(state)[0]
            if isinstance(x, torch.Tensor)]


def _live_state(trainer):
    model, opt = trainer.updater.state
    return (model.state_dict(), opt.state_dict())


def _resnet_resume_leg(smoke, tmp, db):
    """Leg U twice (8 uninterrupted steps, saves at 4 and 8, a device clone
    of the state at 4), then leg R: a model from another seed,
    ``maybe_load`` of U's generation 4 (its generation 8 removed, as by a
    crash before it), iterations 5-8.  Held: the loaded state equals the
    clone bit for bit (``stale_grads`` too, double-buffered); R's losses
    equal U's bit for bit when the two U runs agree, else within their
    spread; 11 launches of each conv kernel a step in every run."""
    import os
    import shutil

    torch = smoke.torch
    from chainermn_tpu_torch import ops
    from chainermn_tpu_torch.extensions import create_multi_node_checkpointer

    name = f"resnet50{'_db' if db else ''}"
    runs = []
    for k in range(2):
        path = tmp / f"{name}_U{k}"
        cp = create_multi_node_checkpointer(name, _comm(),
                                            cp_interval=ROBUST_EVERY,
                                            path=str(path), keep=2)
        trainer, rec = _r50_trainer(smoke, 0, db, ROBUST_STEPS,
                                    tmp / f"out_U{k}", cp=cp,
                                    clone_at=ROBUST_EVERY)
        ops.reset_launch_counts()
        trainer.run()
        torch.cuda.synchronize()
        rec["launches"] = ops.launch_counts()
        cp.flush()
        rec["timings"] = list(cp.timings)
        rec["path"] = path
        runs.append(rec)
        del trainer, cp
        torch.cuda.empty_cache()
    u1, u2 = runs
    # a crash after iteration 7: generation 8 never reached the disk
    for f in os.listdir(u2["path"]):
        if f".iter{ROBUST_STEPS:012d}." in f:
            os.unlink(u2["path"] / f)
    trainer, rec = _r50_trainer(smoke, 1, db, ROBUST_STEPS, tmp / "out_R")
    cp = create_multi_node_checkpointer(name, _comm(), path=str(u2["path"]))
    t0 = time.perf_counter()
    state, it = cp.maybe_load()
    load_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    trainer.load_checkpoint_state(state)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    if it != ROBUST_EVERY:
        raise AssertionError(f"{name}: maybe_load gave generation {it}, "
                             f"want {ROBUST_EVERY}")
    want = _state_tensors(u2["clone"])
    got = _state_tensors(_live_state(trainer))
    if [p for p, _ in got] != [p for p, _ in want]:
        raise AssertionError(f"{name}: the loaded state's leaves differ "
                             f"from the clone's")
    unequal = [p for (p, g), (_, w) in zip(got, want)
               if g.dtype != w.dtype or g.device != w.device
               or not torch.equal(g, w)]
    stale = [p for p, _ in got if "stale_grads" in p]
    if unequal or (db and not stale):
        raise AssertionError(f"{name}: {len(unequal)} of {len(got)} tensors "
                             f"differ from the iteration-4 clone after the "
                             f"load ({unequal[:5]}); stale_grads leaves "
                             f"{len(stale)}")
    ops.reset_launch_counts()
    trainer.run()
    torch.cuda.synchronize()
    rec["launches"] = ops.launch_counts()
    tail = slice(ROBUST_EVERY, ROBUST_STEPS)
    spread = max(abs(a - b) for a, b in zip(u1["losses"][tail],
                                           u2["losses"][tail]))
    diff = max(abs(a - b) for a, b in zip(rec["losses"],
                                          u2["losses"][tail]))
    per_step = {"U": ROBUST_STEPS, "R": ROBUST_STEPS - ROBUST_EVERY}
    wrong = {f"{leg} {k}": (r["launches"][k], RESNET_CONV_LAUNCHES * n)
             for leg, r, n in (("U1", u1, per_step["U"]),
                               ("U2", u2, per_step["U"]),
                               ("R", rec, per_step["R"]))
             for k in ("conv_wgrad", "conv_dgrad")
             if r["launches"][k] != RESNET_CONV_LAUNCHES * n}
    row = {"check": "robustness.resume", "case": name, "db": db,
           "generation_bytes": u1["timings"][0].get("bytes"),
           "save_block_ms": [t["save_block_ms"] for t in u1["timings"]],
           "write_ms": [t.get("write_ms") for t in u1["timings"]],
           "maybe_load_ms": load_ms, "load_state_ms": restore_ms,
           "tensors_equal": len(got), "stale_grads_tensors": len(stale),
           "u1_losses": u1["losses"], "u2_losses": u2["losses"],
           "r_losses": rec["losses"], "u_spread": spread,
           "r_vs_u_max_abs": diff, "bitwise_u": spread == 0.0,
           "launches": {"U1": u1["launches"], "U2": u2["launches"],
                        "R": rec["launches"]},
           "card": smoke.card}
    emit(row)
    for r in (u1, u2, rec):
        smoke.add_launches({k: r["launches"][k]
                            for k in ("conv_wgrad", "conv_dgrad")})
    if wrong:
        raise AssertionError(f"{name} conv launches (got, want): {wrong}")
    if diff > spread:
        raise AssertionError(f"{name}: resumed losses {rec['losses']} vs "
                             f"U's {u2['losses'][tail]}: max |diff| {diff} "
                             f"over the U runs' spread {spread}")
    del trainer, state
    torch.cuda.empty_cache()
    return row


def _comm():
    from chainermn_tpu_torch.communicators import create_communicator

    return create_communicator("xla", device="cuda")


def _resnet_timing_leg(smoke, tmp):
    """16 steps, a save every 4 (four generations, the pinned buffers warm
    from the third): save()'s blocking ms, the writer's ms and bytes, and
    the step ms p50 with a write in flight beside p50 without."""
    torch = smoke.torch
    from chainermn_tpu_torch.extensions import create_multi_node_checkpointer

    cp = create_multi_node_checkpointer("resnet50_t", _comm(),
                                        cp_interval=ROBUST_EVERY,
                                        path=str(tmp / "timing"), keep=2)
    trainer, rec = _r50_trainer(smoke, 0, False, ROBUST_TIMING_STEPS,
                                tmp / "out_T", cp=cp)
    trainer.run()
    cp.flush()
    steps = list(zip(rec["ms"], rec["in_flight"]))[2:]     # 2 warm-up
    busy = [ms for ms, f in steps if f]
    idle = [ms for ms, f in steps if not f]
    warm = cp.timings[2:]
    row = {"check": "robustness.checkpoint_cost", "case": "resnet50",
           "saves": len(cp.timings),
           "generation_bytes": [t["bytes"] for t in cp.timings],
           "save_block_ms": [t["save_block_ms"] for t in cp.timings],
           "write_ms": [t["write_ms"] for t in cp.timings],
           "save_block_ms_warm_p50": _percentile(
               [t["save_block_ms"] for t in warm], 0.5),
           "write_ms_warm_p50": _percentile([t["write_ms"] for t in warm],
                                            0.5),
           "step_ms": rec["ms"], "in_flight": rec["in_flight"],
           "step_ms_p50_write_in_flight": _percentile(busy, 0.5)
           if busy else None,
           "step_ms_p50_no_write": _percentile(idle, 0.5) if idle else None,
           "steps_in_flight": len(busy), "steps_without": len(idle),
           "card": smoke.card}
    emit(row)
    smoke.robust_cost = row
    if not busy or not idle:
        raise AssertionError(f"timing leg: {len(busy)} steps with a write "
                             f"in flight, {len(idle)} without: both needed")
    del trainer, cp
    torch.cuda.empty_cache()


def _free_port():
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(module, args, env_extra=None, cwd=None):
    """``python -m module args`` from the checkout, output captured."""
    import os

    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    env.update(env_extra or {})
    return subprocess.Popen([sys.executable, "-m", module, *args],
                            cwd=str(cwd or ROOT), env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _finish(p, label, want_rc=0, timeout=600):
    out, err = p.communicate(timeout=timeout)
    if p.returncode != want_rc:
        raise AssertionError(f"{label}: exit {p.returncode}, want {want_rc}"
                             f"\n{out[-2000:]}\n{err[-3000:]}")
    return out, err


def _last_json(out):
    return json.loads(out.strip().splitlines()[-1])


def _cli_mnist_kill_resume(tmp):
    """``train_mnist_checkpoint --unit 1000``, killed at epoch 2 (exit 99),
    rerun to its end, against an uninterrupted run, on the card."""
    mod = "chainermn_tpu_torch.train_mnist_checkpoint"
    base = ["--unit", str(MNIST_UNIT)]
    full = _spawn(mod, base + ["--out", str(tmp / "m_full")])
    kill = _spawn(mod, base + ["--kill-at-epoch", "2",
                               "--out", str(tmp / "m_run")])
    out, _ = _finish(kill, "mnist --kill-at-epoch 2", want_rc=99)
    res = _spawn(mod, base + ["--out", str(tmp / "m_run")])
    want = _last_json(_finish(full, "mnist uninterrupted")[0])
    out, _ = _finish(res, "mnist resumed")
    got = _last_json(out)
    if got["resumed_from"] != 64 or got["iterations"] != want["iterations"]:
        raise AssertionError(f"mnist resume: resumed from "
                             f"{got['resumed_from']}, {got['iterations']} "
                             f"iterations (want 64, {want['iterations']})")
    diff = abs(got["epoch_losses"][-1] - want["epoch_losses"][-1])
    row = {"check": "robustness.mnist_kill_resume", "device": "cuda",
           "final_loss": got["epoch_losses"][-1],
           "uninterrupted_final_loss": want["epoch_losses"][-1],
           "abs_diff": diff, "resumed_from": got["resumed_from"]}
    if diff > 1e-6 * abs(want["epoch_losses"][-1]):
        raise AssertionError(f"mnist resumed final loss off: {row}")
    return row


def _cli_demo_preempt(tmp):
    """``python -m chainermn_tpu_torch.train`` with the checkpointer, the
    preemption handler, the self-healing gang and the flight recorder:
    SIGTERM once its first generation is on disk; exit 0, a ``preempt``
    bundle naming the generation saved; the rerun resumes to the
    uninterrupted run's final loss."""
    import os
    import signal

    from chainermn_tpu_torch.observability.flight import (find_bundles,
                                                          read_bundle)

    mod = "chainermn_tpu_torch.train"
    base = ["--steps", str(DEMO_STEPS), "--log-every", "100"]
    ck, dump = tmp / "d_ck", tmp / "d_dump"
    argv = base + ["--checkpoint-dir", str(ck), "--preemption-grace-s", "30",
                   "--self-heal", "--flight-dump-dir", str(dump),
                   "--out", str(tmp / "d_run")]
    full = _spawn(mod, base + ["--out", str(tmp / "d_full")])
    p = _spawn(mod, argv)
    first = ck / "train.iter000000000005.proc0of1"
    deadline = time.monotonic() + 300
    while not first.exists():
        if p.poll() is not None or time.monotonic() > deadline:
            raise AssertionError("demo: no first generation before the end:"
                                 f" {p.communicate()[1][-3000:]}")
        time.sleep(0.002)
    t_sig = time.monotonic()
    p.send_signal(signal.SIGTERM)
    _, err = _finish(p, "demo after SIGTERM")
    exit_s = time.monotonic() - t_sig
    bundles = [b for b in find_bundles(str(dump)) if b.endswith("-preempt")]
    if len(bundles) != 1:
        raise AssertionError(f"demo: preempt bundles {bundles}")
    pre = read_bundle(bundles[0])["manifest"]["extra"]["preempt"]
    saved = pre["generation_saved"]
    if not isinstance(saved, int) or not any(
            f".iter{saved:012d}.proc0of1" in f for f in os.listdir(ck)):
        raise AssertionError(f"demo: the bundle names generation {saved}, "
                             f"not on disk: {sorted(os.listdir(ck))}")
    res = _spawn(mod, argv)
    want = _last_json(_finish(full, "demo uninterrupted")[0])["final_loss"]
    out, err2 = _finish(res, "demo resumed")
    got = _last_json(out)
    if f"resumed from generation {saved}" not in err2:
        raise AssertionError(f"demo: the rerun did not resume: "
                             f"{err2[-2000:]}")
    row = {"check": "robustness.demo_preempt", "device": "cuda",
           "generation_saved": saved, "grace_used_s": pre["grace_used_s"],
           "save_s": pre["save_s"], "sigterm_to_exit_s": exit_s,
           "final_loss": got["final_loss"],
           "uninterrupted_final_loss": want,
           "abs_diff": abs(got["final_loss"] - want),
           "self_heal": got.get("self_heal")}
    if row["abs_diff"] > 1e-6 * abs(want):
        raise AssertionError(f"demo resumed final loss off: {row}")
    return row


def _cli_elastic(tmp):
    """Two gloo processes on the CPU train MNIST with SGD (``--optimizer
    sgd --lr 0.1``, unit 1000) and stop at epoch 2 with a world-2
    generation; the world-2 run continues on the CPU while a world-1 run on
    the card resumes from a copy of the same generations (batch 256: the
    same global batch).  Final epoch losses within rtol 1e-4."""
    import shutil

    mod = "chainermn_tpu_torch.train_mnist_checkpoint"
    base = ["--unit", str(MNIST_UNIT), "--optimizer", "sgd", "--lr", "0.1"]

    def pair(extra):
        port = str(_free_port())
        return [_spawn(mod, ["--device", "cpu"] + base + extra,
                       {"RANK": str(r), "WORLD_SIZE": "2",
                        "LOCAL_RANK": str(r), "LOCAL_WORLD_SIZE": "2",
                        "MASTER_ADDR": "localhost", "MASTER_PORT": port,
                        "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "2"})
                for r in range(2)]

    for r, p in enumerate(pair(["--kill-at-epoch", "2",
                                "--out", str(tmp / "e2")])):
        _finish(p, f"elastic world-2 rank {r} --kill-at-epoch 2",
                want_rc=99)
    shutil.copytree(tmp / "e2", tmp / "e1")
    cont = pair(["--out", str(tmp / "e2")])
    card = _spawn(mod, base + ["--batchsize", "256",
                               "--out", str(tmp / "e1")])
    outs = [_finish(p, f"elastic world-2 rank {r} continued")[0]
            for r, p in enumerate(cont)]
    want = _last_json(outs[0])
    out, err = _finish(card, "elastic world-1 card resume")
    got = _last_json(out)
    if "resharded 2 -> 1" not in err:
        raise AssertionError(f"elastic: no elastic resume: {err[-2000:]}")
    rel = abs(got["epoch_losses"][-1] - want["epoch_losses"][-1]) \
        / abs(want["epoch_losses"][-1])
    row = {"check": "robustness.elastic_2_to_1", "rtol": 1e-4,
           "world2_cpu_epoch_losses": want["epoch_losses"],
           "world1_card_epoch_losses": got["epoch_losses"],
           "resumed_from": got["resumed_from"], "final_rel_err": rel}
    if rel > 1e-4 or got["world"] != 1 or want["world"] != 2:
        raise AssertionError(f"elastic resume off: {row}")
    return row


def phase_robustness(smoke):
    """Training robustness on the card.  ResNet-50 at the headline size
    through Trainer + StandardUpdater with a ``MultiNodeCheckpointer``
    (asynchronous, keep 2, a save every 4 iterations): leg U twice, leg R
    resumed from U's generation 4 into a model from another seed, without
    and with double buffering; a timing leg for the save's cost.  Then, in
    subprocesses and side by side: ``train_mnist_checkpoint`` killed and
    resumed, the demo CLI preempted by SIGTERM and resumed, and a world-2
    CPU generation resumed on the card."""
    import concurrent.futures
    import tempfile

    torch = smoke.torch
    tmp = Path(tempfile.mkdtemp(prefix="chainermn_robustness_"))
    legs_s, t0 = {}, time.monotonic()
    for db in (False, True):
        _resnet_resume_leg(smoke, tmp, db)
        legs_s[f"resume_db{int(db)}"] = time.monotonic() - t0
        t0 = time.monotonic()
    _resnet_timing_leg(smoke, tmp)
    torch.cuda.synchronize()
    legs_s["timing"] = time.monotonic() - t0
    t0 = time.monotonic()
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        futs = {name: pool.submit(fn, tmp) for name, fn in
                (("mnist", _cli_mnist_kill_resume),
                 ("demo", _cli_demo_preempt),
                 ("elastic", _cli_elastic))}
        rows = {name: f.result() for name, f in futs.items()}
    legs_s["subprocesses"] = time.monotonic() - t0
    for row in rows.values():
        emit({**row, "card": smoke.card})
    emit({"check": "robustness.legs_s", **legs_s})


# the analysis phase: the trace engine's two kernel-bearing entry points
ANALYSIS_ENTRIES = ("parallel.decode.lm_decode_tick", "serving.prefill_family")
LOCK_SERVE = dict(requests=16, prompt=64, new=8, slots=4, n_layers=2)


def _analysis_outputs(smoke, name, got, want):
    """Hold an entry's card outputs (tensors, nested in tuples and lists)
    against its plain path's at fp32's tolerance; returns how many."""
    torch = smoke.torch
    if isinstance(got, torch.Tensor):
        smoke.compare(f"analysis.{name}", got.cpu(), want.cpu(), "float32")
        return 1
    return sum(_analysis_outputs(smoke, name, g, w)
               for g, w in zip(got, want))


#: kernel wrapper (a dispatch-graph node) -> the launch counter its
#: kernel counts under (ops.KERNEL_WRAPPERS)
WRAPPER_LAUNCHES = {"decode_append_attend": "decode_attend",
                    "flash_attention": "flash_fwd",
                    "cache_append": "cache_append"}


def _allocator_delta(smoke, ep):
    """Bytes the caching allocator holds at its peak over one plain call
    of ``ep``'s trace at ``size="full"`` on the card, above what it held
    before the call (after one warm call)."""
    torch = smoke.torch
    spec = ep.build(device="cuda", size="full")
    try:
        fn, args = spec["trace"]
        fn(*args)                                   # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        m0 = torch.cuda.memory_allocated()
        out = fn(*args)
        torch.cuda.synchronize()
        delta = torch.cuda.max_memory_allocated() - m0
        del out
    finally:
        teardown = spec.get("teardown")
        if teardown is not None:
            teardown()
    return int(delta)


def _analysis_shardflow(smoke, ep):
    """The shard-flow analyzer over ``ep`` at ``size="full"``, fp32: on the
    card, reconciled and clean modulo the port's baseline; its wrapper
    nodes equal the kernel launches of the same call; its static groups,
    replication report and peak-live estimate equal the CPU's at the same
    size byte for byte; the estimate less the card storages resident
    before the call is at most the allocator's measured peak delta."""
    from chainermn_tpu_torch.analysis import shardflow
    from chainermn_tpu_torch.analysis.findings import load_baseline

    baseline = load_baseline(str(ROOT / "chainermn_tpu_torch"
                                 / shardflow.SHARDFLOW_BASELINE_FILENAME))
    t0 = time.monotonic()
    findings, card = shardflow.analyze_entrypoint(ep, device="cuda",
                                                  size="full")
    card_s = time.monotonic() - t0
    new, _ = baseline.filter(findings)
    if new or card.error or card.reconciled is not True:
        raise AssertionError(f"shardflow {ep.name}: reconciled "
                             f"{card.reconciled}, {card.error}, findings "
                             f"{[f.render() for f in new]}")
    nodes = {}
    for name, n in card.kernels.items():
        key = WRAPPER_LAUNCHES[name]
        nodes[key] = nodes.get(key, 0) + n
    if nodes != card.launches or not nodes:
        raise AssertionError(f"shardflow {ep.name}: wrapper nodes {nodes} "
                             f"!= kernel launches {card.launches}")
    smoke.add_launches(card.launches)
    _, cpu = shardflow.analyze_entrypoint(ep, device="cpu", size="full")
    for key in ("static_groups", "replication", "peak_live_bytes",
                "kernels"):
        if getattr(card, key) != getattr(cpu, key):
            raise AssertionError(f"shardflow {ep.name}: card {key} "
                                 f"{getattr(card, key)} != CPU's "
                                 f"{getattr(cpu, key)}")
    # the estimate frees inputs at their last use (JAX's liveness), so
    # its peak less the resident inputs is what it holds above them at
    # that peak; the created peak counts only storages the call makes
    estimate = card.peak_live_bytes - card.input_bytes
    created = card.peak_defined_bytes
    delta = _allocator_delta(smoke, ep)
    if not (0 <= estimate <= delta and 0 < created <= delta):
        raise AssertionError(f"shardflow {ep.name}: intermediates estimate "
                             f"{estimate} B or created peak {created} B not "
                             f"within the allocator delta {delta} B")
    emit({"check": "analysis.shardflow", "entry": ep.name, "size": "full",
          "reconciled": card.reconciled, "static_groups": card.static_groups,
          "wrapper_nodes": card.kernels, "launches": card.launches,
          "peak_live_bytes": card.peak_live_bytes,
          "resident_bytes": card.input_bytes,
          "intermediates_bytes": estimate, "created_peak_bytes": created,
          "allocator_delta_bytes": delta,
          "estimate_over_delta": round(estimate / delta, 4),
          "created_over_delta": round(created / delta, 4),
          "card_s": round(card_s, 3),
          "phase_s": round(time.monotonic() - t0, 3), "card": smoke.card})


def phase_analysis(smoke):
    from chainermn_tpu_torch.analysis.entrypoints import (SIZES,
                                                          select_entrypoints)
    from chainermn_tpu_torch.analysis.findings import load_baseline
    from chainermn_tpu_torch.analysis.trace_engine import check_entrypoint

    baseline = load_baseline(str(ROOT / "chainermn_tpu_torch"
                                 / ".spmd-lint-baseline.json"))
    n_layers = SIZES["full"]["n_layers"]
    eps, err = select_entrypoints(list(ANALYSIS_ENTRIES))
    if err:
        raise AssertionError(err)
    for ep in eps:
        _, tiny = check_entrypoint(ep, device="cpu", size="tiny")
        t0 = time.monotonic()
        findings, card = check_entrypoint(ep, device="cuda", size="full",
                                          keep_outputs=True)
        smoke.torch.cuda.synchronize()
        card_s = time.monotonic() - t0
        new, _ = baseline.filter(findings)
        if new or card.error:
            raise AssertionError(f"{ep.name}: findings "
                                 f"{[f.render() for f in new]} {card.error}")
        if (card.collectives, card.n_compiles) != (tiny.collectives,
                                                   tiny.n_compiles):
            raise AssertionError(
                f"{ep.name}: card (sequence, programs) "
                f"{card.collectives, card.n_compiles} != CPU tiny's "
                f"{tiny.collectives, tiny.n_compiles}")
        # a layer each per call: the tick entry prefills once in its
        # build, then ticks (the trace call and the variants); the family
        # only prefills
        if ep.name == "serving.prefill_family":
            prefills, ticks = card.calls, 0
        else:
            prefills, ticks = 1, card.calls
        want = {"flash_fwd": n_layers * prefills,
                "cache_append": n_layers * prefills,
                "decode_attend": n_layers * ticks}
        got = {k: card.launches.get(k, 0) for k in want}
        if got != want or set(card.launches) - set(want):
            raise AssertionError(f"{ep.name} launches (got, want): "
                                 f"{card.launches}, {want}")
        _, plain = check_entrypoint(ep, device="cpu", size="full",
                                    keep_outputs=True)
        n_out = _analysis_outputs(smoke, ep.name, card.outputs,
                                  plain.outputs)
        smoke.add_launches(card.launches)
        emit({"check": "analysis.trace", "entry": ep.name, "size": "full",
              "collectives": card.collectives,
              "n_compiles": card.n_compiles, "calls": card.calls,
              "launches": card.launches, "outputs_compared": n_out,
              "card_s": round(card_s, 3), "card": smoke.card})
    for ep in eps:
        _analysis_shardflow(smoke, ep)
    # the lock-order recorder over the card's serving, in a child process
    # that installs it before the package's modules are imported
    import tempfile

    out = Path(tempfile.mkdtemp(prefix="chainermn_lock_")) / "locks.json"
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                           "--lock-worker", str(out)], capture_output=True,
                          text=True, timeout=300)
    res = json.loads(out.read_text()) if out.exists() else {}
    if proc.returncode or "cycle" in res or not res:
        raise AssertionError(f"lock recorder: rc {proc.returncode}, "
                             f"{res.get('cycle')}: {proc.stderr[-3000:]}")
    if res["status"] != ["done"] * LOCK_SERVE["requests"]:
        raise AssertionError(f"lock recorder: requests {res['status']}")
    emit({"check": "analysis.lock_order", "n_tracked": res["n_tracked"],
          "requests": len(res["status"]), "dynamic_edges": res["dynamic"],
          "wall_s": round(time.monotonic() - t0, 1), "card": smoke.card})


def lock_worker(out_path):
    """Child of phase ``analysis``: the port's lock-order recorder, live
    before the package's modules are imported, over 16 requests on the
    card (8 through a ``ServingEngine``'s driver thread, 8 through a
    two-replica router), then ``assert_consistent``.  Writes the result
    to ``out_path``; exits 1 on a cycle."""
    os.environ["CHAINERMN_TPU_TORCH_LOCK_ASSERT"] = "1"
    from chainermn_tpu_torch.analysis import lockassert

    rec = lockassert.install_from_env()
    import numpy as np
    import torch

    from chainermn_tpu_torch.parallel import init_tp_transformer_lm
    from chainermn_tpu_torch.serving import ServingEngine, build_fleet

    cfg = LOCK_SERVE
    full = dict(FULL, n_layers=cfg["n_layers"])
    params = init_tp_transformer_lm(torch.Generator().manual_seed(0),
                                    max_len=cfg["prompt"] + cfg["new"],
                                    dtype=torch.bfloat16, device="cuda",
                                    **full)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, FULL["vocab"], cfg["prompt"]).tolist()
               for _ in range(cfg["requests"])]
    half = cfg["requests"] // 2
    kw = dict(head_dim=HEAD_DIM, max_total=cfg["prompt"] + cfg["new"],
              device="cuda")
    eng = ServingEngine(params, n_slots=cfg["slots"], **kw)
    eng.start()
    try:
        handles = [eng.submit(p, cfg["new"]) for p in prompts[:half]]
        ok = all(h.wait(timeout=120) for h in handles)
    finally:
        eng.close()
    router = build_fleet(params, 2, n_slots=cfg["slots"] // 2,
                         queue_capacity=half, **kw)
    router.start()
    try:
        routed = [router.submit(p, cfg["new"]) for p in prompts[half:]]
        ok = all(h.wait(timeout=120) for h in routed) and ok
    finally:
        router.stop()
    rec.uninstall()
    result = {"n_tracked": rec.n_tracked, "waited": ok,
              "status": [h.status for h in handles + routed]}
    try:
        result["dynamic"] = sorted(
            list(e) for e in lockassert.assert_consistent(rec))
    except AssertionError as e:
        result["cycle"] = str(e)
    Path(out_path).write_text(json.dumps(result))
    return 1 if "cycle" in result else 0


def main():
    import torch

    if not torch.cuda.is_available():
        print("FAIL phase device: torch.cuda.is_available() is False",
              flush=True)
        return 1
    try:
        import chainermn_tpu_torch  # noqa: F401
        from chainermn_tpu_torch.observability import metrics
    except ImportError as e:
        print(f"FAIL phase device: the chainermn_tpu_torch package is not "
              f"importable from here: {e!r}", flush=True)
        return 1
    global HBM_BYTES_PER_S
    kind = torch.cuda.get_device_name(0)
    PEAK_FLOPS["bfloat16"] = metrics.peak_flops_for(kind)
    HBM_BYTES_PER_S = metrics.hbm_bw_for(kind)
    if PEAK_FLOPS["bfloat16"] is None or HBM_BYTES_PER_S is None:
        print(f"FAIL phase device: {kind!r} has no row in the peak table "
              f"(observability/metrics.py): no bound can be computed",
              flush=True)
        return 1

    # fp32 comparisons (kernel checks, parity) must not run in TF32, which
    # keeps ~3 decimal digits: both matmul and cuDNN TF32 are off for the run
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smoke = Smoke(torch)
    smoke.card = "unknown"
    smoke.phase("device", lambda: phase_device(smoke))
    smoke.phase("build", lambda: phase_build(smoke))
    if "build" not in smoke.failed:
        for name, fn in (("kernels", phase_kernels), ("parity", phase_parity),
                         ("serving", phase_serving), ("beam", phase_beam),
                         ("serving-gqa", phase_serving_gqa),
                         ("serving-prefix", phase_serving_prefix),
                         ("serving-disagg", phase_serving_disagg),
                         ("serving-fleet", phase_serving_fleet),
                         ("serving-autoscale", phase_serving_autoscale),
                         ("serving-fleet-tp", phase_serving_fleet_tp),
                         ("train-parity", phase_train_parity),
                         ("train", phase_train), ("tp", phase_tp),
                         ("sp", phase_sp), ("zero-wire", phase_zero_wire),
                         ("resnet-parity", phase_resnet_parity),
                         ("resnet-train", phase_resnet_train),
                         ("resnet152-db", phase_resnet152_db),
                         ("imagenet-parity", phase_imagenet_parity),
                         ("imagenet-train", phase_imagenet_train),
                         ("comm", phase_comm), ("trainer", phase_trainer),
                         ("observability", phase_observability),
                         ("seq2seq", phase_seq2seq),
                         ("model-parallel", phase_model_parallel),
                         ("robustness", phase_robustness),
                         ("analysis", phase_analysis)):
            smoke.phase(name, lambda fn=fn: fn(smoke))
    kernels = []
    for name, (source, replaces) in KERNEL_INFO.items():
        row = smoke.kernel_rows.get(name, {})
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": smoke.launches.get(name, 0),
            "max_abs_err": row.get("max_abs_err"), "ms": row.get("ms"),
            "plain_ms": row.get("plain_ms"), "bound_ms": row.get("bound_ms"),
            "bound_by": row.get("bound_by"),
            "library_ms": row.get("library_ms")})
    if torch.distributed.is_initialized():     # the one-rank group
        torch.distributed.destroy_process_group()
    if smoke.failed:
        print(f"FAILED phases: {smoke.failed}", flush=True)
        # the tail of stderr is what a caller sees first: name each
        # failure there too, after the phases' own output
        for name in smoke.failed:
            print(f"FAIL phase {name}: {smoke.errors[name]}",
                  file=sys.stderr, flush=True)
        return 1
    emit({"kernels": kernels})
    print(smoke.card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--tp-worker"]:
        sys.exit(tp_worker(int(sys.argv[2]), sys.argv[3]))
    if sys.argv[1:2] == ["--sp-worker"]:
        sys.exit(sp_worker(int(sys.argv[2]), sys.argv[3]))
    if sys.argv[1:2] == ["--zero-worker"]:
        sys.exit(zero_worker(int(sys.argv[2]), sys.argv[3]))
    if sys.argv[1:2] == ["--fleet-worker"]:
        sys.exit(fleet_worker(sys.argv[2], sys.argv[3:]))
    if sys.argv[1:2] == ["--lock-worker"]:
        sys.exit(lock_worker(sys.argv[2]))
    sys.exit(main())
