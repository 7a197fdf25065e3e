"""Card check of the PyTorch port: builds its CUDA kernels, holds each
against its plain version, and drives GPT-2 125M inference, training and
continuous-batching serving, with its hierarchical KV memory, speculative
decoding, the int8 KV cache, beam search and int8 weight export, the
trainer shell (data loading, checkpointed fit, 8k context), data
parallelism (a process group, a mesh, synced gradients), FSDP (sharded
parameters, state and checkpoints), tensor parallelism, pipeline
parallelism on GPT-2 350M, sequence parallelism (ring and Ulysses
attention) at 32k context, mixture of experts with expert
parallelism (``gpt2_moe_ep``), and the Llama family (``llama_1b`` served
and trained on one device, ``llama_1b_3d``'s FSDP x TP x PP over eight
ranks), at full width.

    python3 chip_smoke.py

Needs one CUDA device (exits non-zero without one) and ``nvcc`` (the kernels
are built from ``tpu_parallel_torch/csrc`` at first use, one ``nvcc`` per
source, all started together).  Phases, in order; any failure raises:

1. setup: card name and power limit, versions, kernel builds and ``ptxas``;
2. ``flash_fwd`` kernel against ``flash_fwd_reference`` at shapes (a)-(g)
   and the training pass's shape, in both layouts: the main path's (q, k, v
   views of a fused [B, S, H, 3D] qkv buffer, or q and views of a
   [B, S, H_KV, 2D] kv buffer under GQA; out written [B, S, H, D]) and the
   JAX layout [B, H, S, D], whose outputs must be bitwise equal; the
   kernel's time on the main path's layout and SDPA's on the same inputs in
   turns (kernel, SDPA, SDPA, kernel; medians), the [B, H, S, D] layout's
   and the plain version's times, and the bound;
2b. ``flash_bwd`` (one pass for dq, dk and dv) against
   ``flash_bwd_reference`` at shapes (a)-(g) and the training pass's shape,
   row by row, dq exactly 0 on empty rows; the kernel's time and SDPA's
   backward time taken in turns (kernel, SDPA, SDPA, kernel; medians), the
   plain version's time and the one-pass bound; at (a), planted faults that
   the row check must reject; at the training pass, two runs: dk and dv
   bitwise equal, dq's largest difference printed; and the same pass on the
   main path's layout (strided q, k, v, out, do; dq, dk, dv written
   [B, S, H, D]): within the row rule, dk and dv bitwise equal to the
   [B, H, S, D] run's, and its time;
3. forward: ``gpt2_125m(attn_impl="flash")`` on tokens [8, 1024], seeded
   weights, against the same weights under ``attn_impl="xla"``;
4. generate: greedy on 4 ragged prompts, then a top-p sampled call;
5. profile: device time by kernel and kind, the copy kernels by name with
   their counts, and the device's idle share over one forward and over 8
   decode steps (``torch.profiler``); the profile of one training step runs
   at the end of phase 6, after its counted steps;
6. training: the ``Trainer`` at ``bench.py``'s shape (GPT-2 125M, flash,
   "proj_attn" remat, global batch 256 in 16 minibatches of [16, 1024]):
   3 warm-up and 3 timed steps, launches per step, step time, tokens/s,
   MFU and peak memory; one minibatch's loss and gradients against the
   xla path; a profile of one step;
7. serve: the continuous-batching ``ServingEngine`` on GPT-2 125M (bf16,
   16 slots, auto buckets, prefill batch 4, chunks of 256, a prefix cache
   of 4) over 32 requests (prompts of 16-768 tokens, 8 behind one shared
   128-token prefix, 32-128 new tokens, 8 of them sampled; 16 arrive at
   tick 0, then 4 per tick), run seven times: per-step ticks, fused T=8
   ticks run eagerly, fused T=8 ticks replaying one CUDA graph, and the
   same under ``run(overlap=True)`` (these four pinned to the per-phase
   tick); then the unified ragged tick (chunked prefills folded into the
   fused tick, two CUDA graphs: fused and unified) over the contiguous
   pool, over the paged pool (``kv_block_tokens="auto"``: 512 blocks of
   32 tokens), and over the same 512 blocks with 32 slots.  Greedy tokens
   must be bitwise equal across all but the 32-slot run (whose GEMM batch
   differs; there every request must finish at its budget), each captured
   run must capture its pinned number of graphs, the overlap run must
   launch ticks ahead, the paged runs must return every block, and no
   flash kernel may launch (the engine reads its cache through
   ``decode_attention``, as the JAX engine does).  Per run: wall seconds,
   tokens, TTFT and ITL p50/p95, host ms per tick, host dispatches per
   token, prefill chunks carried by unified ticks, peak memory (paged:
   peak blocks in use, copy-on-write copies, block-gate holds), and for
   five runs a 16-slot pure-decode stretch ticked the same way: decode
   tokens/s, device idle share, device ms per decode step, kernel
   launches per token, ``direct_copy`` and gather launches per step and
   the longest kernels (``torch.profiler``).  One decode step per layout
   must make no cache-sized copy (contiguous) and exactly one gather per
   payload per layer (paged).  Then the weights in fp32 (TF32 off): 8
   greedy requests against static ``generate()`` at batch 1, a differing
   token allowed only on a top-2 logit gap < 1e-4;
8. kv: the hierarchical KV memory on GPT-2 125M (bf16, 16 slots over 512
   blocks of 32 tokens, monolithic prefill, fused T=8 ticks replaying one
   CUDA graph) over 192 requests that visit 64 distinct 512-token system
   prompts (1024 blocks, twice the pool) three times each, plus a
   16-64-token suffix and 32-64 new tokens, 16 of them sampled; 16 arrive
   at tick 0, then 4 per tick.  Four runs: ``paged_lru`` (phase 7's
   aligned-LRU prefix cache of 4 entries), ``radix`` (a 192-block radix
   tree), ``radix_host`` (plus 1024 host blocks) and ``radix_host_disk``
   (256 host blocks over 1024 disk blocks in a temporary directory).  Per
   run: wall, tokens/s, TTFT p50/p95, ITL p95, prefix hit rate, prompt
   tokens prefilled, offloads, restored blocks, disk spills and restores,
   peak memory, graph captures, and the rates of ``export_blocks``
   (device to host) and of ``import_stored``'s copy (host to device) beside
   a 256 MB pinned ``copy_`` each way.  Every request must finish at its
   budget with no restore or integrity failure and every block back; then
   a fresh engine boots on the disk run's directory and replays 16
   requests, whose first tick must hit from disk; one flipped byte in a
   spilled host payload must be refused typed and the request recomputed
   to its cold tokens; an fp32 leg (TF32 off) of 8 greedy requests through
   a hierarchy that spills and restores must equal the same engine without
   it (top-2 rule as in phase 7); and an export -> wire -> import between
   two engines must continue as the exporter does.  No flash launch.
9. spec: speculative decoding on GPT-2 125M (bf16, 16 slots, auto
   buckets, prefill batch 4, 4 draft tokens: verify blocks of [16, 5])
   over 24 requests (prompts of 64-512 tokens, half a 32-token motif
   repeated, 64-128 new tokens, 4 sampled; 16 at tick 0, then 4 per tick),
   run seven times: (a) the non-spec engine at its defaults; (b) per-step
   verify ticks with the host n-gram drafter; (c) fused ticks of 4 verify
   blocks drafting on the device (one CUDA graph per variant, greedy and
   sampled); (d) the same over 512 blocks of 32 tokens; (e) the same with
   chunks of 256 (the unified spec graph); (f) an oracle and (g) an
   anti-oracle drafter (no adaptation), per-step, keyed on (b)'s greedy
   tokens.  Every request finishes at its budget; greedy tokens bitwise
   equal across (b)-(g) (one verify width; (a)'s bits are printed, not
   held); (g) accepts nothing; (f) takes fewer decode ticks than (b); each
   run replays its graph kinds, each captured once; every block returns;
   no flash launch.  Per run: wall, tokens/s, TTFT and ITL p50/p95, decode
   ticks, acceptance, tokens per verify, wasted verify positions, host
   dispatches per token, peak memory.  Pure-decode stretches at 16 slots
   (profiled): device ms per decode step [16, 1] and per verify step
   [16, 5], idle share, launches per token.  Then fp32 (TF32 off): 8
   greedy requests through (c) against the non-spec engine (top-2 rule as
   in phase 7);
10. decode extras: phase 7's engine and workload at
   ``kv_cache_dtype="int8"`` in three runs (fused T=8 graph, contiguous;
   unified over 512 blocks of 32; unified over 960 blocks of 32 under 32
   slots, the bf16 pool's KV bytes): every request at its budget, the
   pinned captures, every block back; the pools' KV bytes beside bf16's
   and the greedy tokens' agreement with phase 7's bf16 runs printed.
   Profiled pure-decode stretches, int8 and bf16, per layout (device ms
   per step, tokens/s, idle share, launches per token, the copy, cast and
   gather kernels by name).  Phase 9's run (c) at int8, greedy tokens
   bitwise equal to a per-step int8 spec run.  ``generate_beam`` on 4
   prompts of 256 tokens, 4 beams, 32 new, lazy and eager (tokens/s,
   device ms per beam step, the eager reorder's bytes), the int8 lazy beam,
   and fp32 lazy tokens equal to eager with scores within 1e-4.  The seeded
   weight tree quantized to int8 (bytes against fp32 and bf16, held under
   0.35x fp32), its ``.npz`` round trip (held bitwise), the dequantized
   model's logits and greedy tokens against the original's (printed).
   Then fp32 (TF32 off): 8 greedy int8 requests through the engine against
   static int8 ``generate()``; a differing token passes only where the
   reference's top-2 gap is below INT8_TIE_GAP or twice what the GEMMs'
   batch shape alone moves those logits by.  No flash launch.

11. trainer shell: a byte-level corpus built on the card (the repo's
   ``*.py``/``*.md`` and the standard library's ``*.py`` in sorted path
   order, EOS 50256 after each file, at most 16M tokens), packed at 1024.
   Both kernels at the packed training pass [16, 1024] with the segment ids
   of the fit's first minibatch, and at the 8k pass [2, 8192], against the
   plain versions under phase 2's and 2b's rules.  ``Trainer.fit`` on
   ``gpt2_125m_corpus`` over packed rows (8 steps; checkpoints and
   held-out evaluation every 4; the best snapshot): 24 ``flash_fwd`` and 24
   ``flash_bwd`` launches per step, forwards only in evaluation, a falling
   loss, ``best/`` with ``best_loss.json``; a new Trainer resumes at 8
   (state restored bitwise) and runs to 10; a third fails once through the
   step seam at step 9 of a run to 12, rolls back, replays ``batch_at(9)``
   and ends at 12; save (blocking snapshot, background write), restore and
   eval times; packed against flat step time and the kernels' share of a
   step.  ``gpt2_125m_long`` (16 rows of 8192 in 8 minibatches,
   ``loss_chunk=1024``): 96 launches of each kernel per step, step time,
   tokens/s, MFU, peak memory, and one minibatch's chunked loss and
   gradients against the full logits'.  lion and sgd; an EMA shadow whose
   evaluation equals a plain forward on its weights and leaves the module's
   bitwise; dropout 0.1 (evaluation deterministic; under remat the same
   generator state gives the gradients of remat off) and "dots" against
   "proj_attn", each policy's peak memory and ms.  The final masters as a
   serving weight set (verified; a flipped byte refused) served through
   ``rebind_params`` against static ``generate()`` on the trainer's module.
   ``python -m tpu_parallel_torch.train`` in a subprocess at
   ``CLI_LAYERS`` layers, started after the timed legs above and
   collected at the phase's end (exit 0, its trace's spans, its metrics'
   ``train_loss``).
12. data parallelism on ``gpt2_125m_dp`` ([64, 1024] in one minibatch):
   both kernels at that shape [64, 12, 1024, 64] against the plain
   versions; then three legs, (a) and (b) subprocesses of this script
   (``--leg``), each printing one JSON line.  (a) An NCCL group of one from torchrun's
   environment: ``Trainer`` over ``make_mesh(MeshConfig(data=-1))``, 3
   steps on a seeded batch with 12 ``flash_fwd``, 12 ``flash_bwd`` and one
   ``dp_allreduce_launches`` per step and a falling loss; step host and
   device ms with the group and without one, the all-reduce of the flat
   fp32 gradient buffer alone, peak memory.  (b) Two gloo ranks on the one
   card (gloo takes the CUDA tensors, or the leg stages them through
   pinned host copies, and says which), each on rows ``r::2`` of 2 global
   batches: masters and AdamW moments bitwise equal across the ranks after
   every step; against one process on the same rows (run in this process),
   losses within ``LOSS_TOL``, step-1 gradients within ``TRAIN_GRAD_TOL``
   per weight, and the final masters' loss on a third batch within
   ``LOSS_TOL``; each rank's all-reduce ms and peak memory.  (c)
   ``python -m torch.distributed.run --standalone --nproc_per_node=1 -m
   tpu_parallel_torch.train --config=gpt2_125m_dp`` for 3 steps on
   ``CLI_ROWS`` rows at ``CLI_LAYERS`` layers (as phases 13-15's CLI
   legs): exit 0, a topology line with one process and NCCL,
   ``train_loss`` in its metrics.  It starts with phases 13-18's CLI
   legs at phase 9, on all but MAIN_CORES of the host's cores, and all
   are collected in phase 12, after (b)'s reference.
13. FSDP: ``gpt2_125m_dp`` with ``model_overrides.fsdp=True`` (the blocks,
   the embedding and the lm_head sharded over the data axis), the same
   legs.  (a) An NCCL group of one (phase 12 (a)'s process and group,
   after its steps): 3 steps with 12 ``flash_fwd`` and 12
   ``flash_bwd`` launches, 26 gathers, 14 reduce-scatters and one
   all-reduce per step, a falling loss within ``LOSS_TOL`` of phase 12
   (a)'s; step ms beside phase 12 (a)'s, one block's, the embedding's and
   the lm_head's gather and reduce-scatter alone, the state's bytes
   (sharded and replicated), peak memory.  (b) Two gloo ranks on the card
   on phase 12 (b)'s rows: replicated leaves bitwise equal across the
   ranks after every step, the state's sharded bytes halved; against
   phase 12 (b)'s DP pair, losses within ``LOSS_TOL``, step-1 gradients
   within ``TRAIN_GRAD_TOL`` per weight, the gathered masters (of non-zero
   init) after every step within ``FSDP_MASTER_TOL`` and every weight's
   update within ``FSDP_UPDATE_MEDIAN_TOL`` (median) and
   ``FSDP_UPDATE_MAX_TOL`` (max); gloo's ms per collective, the steps'
   peak memory.  (c) In (b)'s ranks, the sharded checkpoint (every rank its
   shards, ``torch.distributed.checkpoint``) saved twice, its snapshot on the
   host (pinned where the card held it) and adding under ``FSDP_SAVE_DEVICE_BYTES`` to the
   device's peak, the second save (pinned blocks cached) blocking under
   ``FSDP_SAVE_BLOCKING_MS``, beside phase 11's save; restored bitwise into
   a fresh Trainer, which takes one more step; save and restore ms and
   bytes.  (d) ``export_single_device_params``: its
   serving weight set's fingerprint equals that of the masters gathered
   another way, and static ``generate()`` gives equal greedy tokens on
   both.  (e) The CLI under torchrun with
   ``--config.model_overrides.fsdp=True`` for 3 steps on ``CLI_ROWS``
   rows (started at phase 9, collected in phase 12): exit 0.
14. tensor parallelism on ``gpt2_125m_tp`` ([32, 1024] in one minibatch,
   a ``model`` axis over the ranks): both kernels at one rank's shape
   [32, 6, 1024, 64], q, k and v views of its [B, S, 6, 192] qkv buffer,
   against the plain versions.  (a) ``python -m torch.distributed.run
   --standalone --nproc_per_node=1`` over the CLI's ``main`` with
   ``--config=gpt2_125m_tp`` on ``CLI_ROWS`` rows (a model axis of 1,
   NCCL; started at phase 9, collected in phase 12): exit 0, 12/12 launches per
   step, a falling loss, ``train_loss`` in its metrics.  A
   one-process reference (no group, run in this process) on 3 seeded batches, then (b) two
   gloo ranks sharing the card on a data=1 x model=2 mesh, each on all 32
   rows, both at ``TP_PAIR_LAYERS`` of the 12 layers (legs (b)-(e); the
   run's time limit): 6/6 launches, 31 model-axis all-reduces and one
   gradient all-reduce per step, the replicated leaves bitwise equal across the
   ranks after every step; against the reference, losses within
   ``LOSS_TOL``, the step-1 synced gradients (assembled from the ranks'
   slices) within ``TRAIN_GRAD_TOL`` per weight, the masters after every
   step within ``TP_MASTER_TOL`` and their updates within
   ``TP_UPDATE_MEDIAN_TOL`` / ``TP_UPDATE_MAX_TOL``, the fp32 synced
   gradients of a 2-layer cut on 4 rows within ``TP_FP32_GRAD_TOL``; state bytes, peak
   memory and gloo's ms per activation all-reduce.  (c) In (b)'s ranks
   the model-sharded checkpoint restored bitwise into a fresh Trainer,
   then one more step on both (equal losses).  (d) ``generate_sharded``
   on 4 ragged prompts, 32 new tokens: fp32 greedy tokens equal to static
   ``generate()`` on the assembled masters (top-2 rule) and on both
   ranks; bf16 ms per token; top-k and top-p sampled tokens equal on both
   ranks.  (e) ``ServingEngine(mesh=...)`` (fp32, per-step ticks) over 8
   requests: every one at its budget, equal on both ranks, greedy tokens
   equal to ``generate_sharded``'s (top-2 rule).
15. pipeline parallelism on ``gpt2_350m_pp`` (GPT-2 350M: 24 layers, 16
   heads of 64; 8 microbatches, interleave 2, over a ``pipe`` axis of 4)
   at ``PP_ROWS`` rows (the config's 64 do not fit four ranks on one card:
   PERF.md): both kernels at the PP pass [PP_ROWS / 8, 1024] x 16 heads,
   views of the [B, S, 16, 192] qkv buffer, against the plain versions.
   (a) ``python -m torch.distributed.run --standalone --nproc_per_node=1``
   over the CLI's ``main`` with ``--config=gpt2_350m_pp``, the mesh's pipe
   and ``pipe_interleave`` set to 1 and ``pipe_schedule="1f1b"`` on
   ``CLI_ROWS`` rows (NCCL; started at phase 9, collected in phase 12): exit 0,
   384/192 launches per step, a falling loss.  A one-process
   reference (no group, run in this process, the microbatches as minibatches) on 3 seeded
   batches, then four gloo ranks sharing the card on a data=1 x pipe=4
   mesh, both at ``PP_PAIR_LAYERS`` of the 24 layers (legs (b)-(e); the
   run's time limit): (b) GPipe with interleave 2: 16/16 launches and the schedule's
   point-to-point ops per step per rank (bubbles send nothing), the
   replicated leaves bitwise equal across the ranks after every step;
   against the reference, losses within ``LOSS_TOL``, each rank's step-1
   synced gradients within ``TRAIN_GRAD_TOL`` per weight, the masters
   after every step within ``PP_MASTER_TOL`` and their updates within
   ``PP_UPDATE_MEDIAN_TOL`` / ``PP_UPDATE_MAX_TOL``; state bytes, peak
   memory, host ms per hop, step wall against the reference's, the bubble
   share the schedule implies.  (d) Its checkpoint (every rank its
   stage's keys) restored bitwise into a fresh Trainer, one more step on
   both (equal losses).  (c) 1F1B (interleave 1): step-1 gradients within
   ``TRAIN_GRAD_TOL`` of the reference's, 96/48 launches per step, peak
   memory beside (b)'s.  (e) ``generate_sharded`` on 4 ragged prompts, 32
   new tokens: fp32 greedy on a 4-layer cut equal to static
   ``generate()`` of one process (top-2 rule) and on every rank; bf16 at
   ``PP_PAIR_LAYERS`` layers on (c)'s module, ms per token; a sampled call equal on
   every rank.  Each multi-rank leg fails at once when a rank fails, and
   on its timeout.
16. sequence parallelism on ``gpt2_125m_long`` at ``seq_len`` 32768 (the
   context ``docs/04_scaling_further.md`` trains; the position table
   grows to 32768 rows) over a ``seq`` axis of 4 with data 1 (the docs'
   data=2 would be eight ranks, more than one card holds), ``"proj_attn"``,
   ``loss_chunk=1024``.  (a) In this process, one [1, 32768] sequence of
   12 heads of 64 (views of a fused qkv buffer) split into 4 chunks,
   every (query chunk, key chunk) pair by the ring's rules through
   ``flash_chunk_attention`` (the diagonal causal, past chunks whole or
   banded, future chunks skipped) and merged with ``combine_chunks``,
   plain, under a window of 4096 and packed: out and lse against one flash
   call over the whole sequence (2e-2, 1e-3, on rows that see a key; out
   also row by row) and against the plain versions through the same
   merge; the gradients
   through the merge (the lse cotangent reaching the backward kernel as
   dlse) against the plain versions', row by row; 10, 7 and 10 launches of
   each kernel.  Both kernels at the ring's chunk shapes [1, 8192] x 12
   heads (a diagonal chunk, a past chunk, a past chunk at offset 8192
   under the window, SDPA there with an explicit mask) and at Ulysses'
   inner shape [1, 32768] x 3 heads (the plain versions one head at a
   time) against the plain versions (out also row by row, and a planted
   P.V fault that keeps lse rejected), timed in turns with SDPA.  A
   one-process reference (``attn_impl="flash"``, no group, run in this
   process) on 3 seeded batches of one row, then four gloo ranks sharing
   the card on a data=1 x seq=4 mesh, each on its [1, 8192] block: (b) ``attn_impl="ring"`` (the
   flash-composed ring: K/V rotate through the host, dk/dv travel back
   with them), (c) ``attn_impl="ulysses"`` (all-to-alls over gloo, 3 heads
   per rank), each from the reference's init: 3 counted steps (the first
   a warm-up, its synced gradients within ``TRAIN_GRAD_TOL`` per weight
   of the reference's) with losses within ``LOSS_TOL``, the masters bitwise equal
   across the ranks after every step, per step (r + 1) x 4 launches of
   each kernel on ring rank r and 4 on every Ulysses rank (``SP_LAYERS``,
   4 of the 12 layers), 28 ring sends and receives or 32 all-to-alls, one
   gradient all-reduce; step wall
   against the reference's, state and peak memory, host ms per ring hop
   and per all-to-all; then in the same ranks the ring op alone,
   ``ring_flash_attention`` forward and backward on each rank's block of
   a seeded [1, 32768] x 12 heads sequence, its out, dq, dk and dv row by
   row against one ``flash_attention`` call over the whole sequence.  (d) ``python -m torch.distributed.run --standalone
   --nproc_per_node=4`` over the CLI's ``main`` with
   ``--config=gpt2_125m_long``, the seq axis 4, ring attention, 32768
   tokens at ``SP_CLI_LAYERS`` layers, one row, ``--device=cuda:0
   --backend=gloo`` (started at phase 9, collected in phase 12): exit 0 on every
   rank, (r + 1) x ``SP_CLI_LAYERS`` launches per step on rank r, a
   falling loss equal on every rank, ``train_loss`` in its metrics;
17. mixture of experts: ``gpt2_moe_ep``'s model (GPT-2 125M with 8
   experts per layer, top-1, capacity 1.25, flash, bf16, "proj_attn";
   559.9M parameters) at full width and depth, ``MOE_ROWS`` rows of 1024
   per step (the config has 64).  Both kernels at one EP rank's shape
   [8, 1024] x 3 heads against the plain versions, timed in turns with
   SDPA.  (a) one device: a forward on [8, 1024] against the same weights
   under ``attn_impl="xla"`` on the flash pass's expert choices (routing
   pinned: bf16 noise flips near-tied choices at random init), the loss
   and the logits token by token within their limits, at the config's
   capacity and at ample capacity, greedy ``generate()`` on 4 ragged
   prompts (decode routes 4 tokens into 1 slot per expert), twice bitwise
   equal, the serving engine on the same prompts with fused T=4 ticks run
   eagerly and replayed as a CUDA graph (greedy tokens bitwise equal), and
   the index dispatch against ``_dispatch_masks`` and the einsums on layer
   0's input, [2, 128] in fp32, at capacity factors 1.25 and 0.5 (the
   same slots exactly, outputs within 1e-5).  (b) a one-process reference
   with every expert (run in this process) at ``MOE_STEP_LAYERS`` (4 of
   the 12 layers; (a) and the fp32 pass below run all 12): 4 steps (the first at
   learning rate 0), its step-1 synced gradients and every step's expert
   choices kept, the dropped share of a forward's choices under the dense
   dispatch and the all-to-all's quota.  Then four gloo ranks sharing the
   card on a data=1 x model=4 mesh (2 experts and 3 heads per rank): (c)
   the dense dispatch on (b)'s expert choices, 4 counted steps on one
   seeded batch with losses within ``LOSS_TOL`` of (b)'s, the step-1
   synced gradients within ``TRAIN_GRAD_TOL`` per weight of (b)'s,
   replicated masters bitwise equal across the ranks, 4/4 launches and
   the collectives derived from the schedule per step (23 model-axis
   all-reduces, one gradient all-reduce), and in fp32 (xla attention,
   full depth, 2 rows, routed alike) the synced gradients, expert stacks
   assembled after the sync, within 1e-4 per weight of one process's;
   (d) the all-to-all dispatch in the same ranks: the same launches, 27
   all-reduces, 24 all-to-alls, 4 all-gathers and 4 reduce-scatters per
   step, finite and falling losses (its per-sender quota drops other
   choices, so no equality with (c)); state bytes, peak memory, step wall
   against (b)'s, host ms per 25.2 MB combine all-reduce and per
   all-to-all;
18. the Llama family: ``llama_1b`` (rope, RMSNorm, swiglu; 16 layers, d
   2048, 16 heads of 128, seq 2048, vocab 32000, bf16, flash,
   "proj_attn"; 1.205B parameters, seeded).  Both kernels at its D=128
   shapes, one device's [4, 2048] x 16 heads and a 3-D rank's [1, 2048] x
   8 heads, against the plain versions, timed in turns with SDPA.  (a) one
   device at full depth: a forward on [4, 2048], 16 launches, the loss
   within ``LOSS_TOL`` of the xla path's and the logits token by token
   within ``LOGITS_TOL`` of the xla path's with its attention in fp32 and
   by a row rule that scales with them (``LLAMA_LOGITS_ROW_TOL``; V's
   second half zeroed in every layer's kernel call must fail it, in the
   last layer's alone is read; the bf16 xla path's own distance printed
   beside); greedy ``generate()`` on
   4 ragged prompts against the full forward's argmax; 8 requests through
   the engine's fused T=8 ticks replayed as CUDA graphs against
   ``generate()`` at batch 1 (both equal, or first differing where the top-2
   gap is below twice what the bf16 paths alone move the logits by);
   forward ms and decode ms per step.  (b) training at full depth, 4 steps
   of 2 minibatches of [4, 2048] (warm-up 1: steps 2-4 update), step-1
   gradients flash against xla within ``TRAIN_GRAD_TOL`` per weight, 32
   launches of each kernel per step, a falling loss; state bytes, peak
   memory, step ms, tokens/s, MFU with the gated MLP's three products.
   (c) ``llama_1b_3d`` over eight gloo ranks sharing the card, data 2 x
   model 2 x pipe 2, ``fsdp=True`` (every tensor-parallel slice split
   again over data by JAX's rule), 4 layers (cut from 16), 8 rows (cut
   from 64), 4 microbatches of one row per data rank (cut from the
   config's 8), GPipe, 3 steps (cut from 100), against one process (run in
   this process): the
   init's masters gathered over both axes bitwise equal to the
   one-process init, each rank's state bytes equal to JAX's rule's, losses
   within ``LOSS_TOL``, bf16 step-1 gradients within ``TRAIN_GRAD_TOL``
   per weight (each rank's slices), an fp32 pass at 2 layers within 1e-4,
   FSDP gathers and reduce-scatters, model-axis all-reduces and pipe
   sends and receives per step equal to the numbers derived from the
   schedule and remat (``_llama_want_counts``), a checkpoint at step 2
   restored bitwise into a fresh init, the export refused as JAX refuses
   it, and the state gathered over both axes onto one device (by this
   script's all-gathers: the port, as JAX, has no one-device export of
   this state) giving 8 greedy tokens equal to the one-process model's
   (the top-2 rule, with the two weight sets' distance as the noise);
   step wall against the
   reference's, state and peak per rank, host ms per all-reduce, hop and
   gather.  (d) ``python -m torch.distributed.run --nproc_per_node=4`` over
   the CLI's ``main`` with ``--config=llama_1b_3d`` on data 2 x model 2 x
   pipe 1 at 2 layers, 8 rows, 2 steps (started with the CLI batch at
   phase 9, collected in phase 12): exit 0 on every rank, 2 launches of each kernel per
   step, finite losses equal on every rank.

Weights and inputs are made from ``SEED``.  The kernel launch counters are
set to 0 before each main path (phases 3-4: inference; phase 6's steps:
training; phases 7-10: serving, which must leave them at 0; phase 11's
packed fit and its 8k steps; phase 12's and phase 13's legs (a), in their
subprocesses; phase 14's CLI leg and its leg (b)'s steps; phase 15's CLI
leg and its leg (b)'s steps; phase 16's CLI leg and the steps of its
legs (b) and (c) in every rank; phase 17 (a)'s forward and the steps of
(c) and (d) in every rank; phase 18 (a)'s forward and ``generate()``, (b)'s
steps, (c)'s steps in every rank and (d)'s CLI) and read after it.  The last two lines
are the ``kernels`` JSON object and the ``{"ok": true, ...}`` line.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

# H100 SXM published peaks (NVIDIA data sheet): dense bf16 and HBM3 rate
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
# kernel vs plain version: P is rounded to bf16 before P.V and sums run in
# another order (out); lse is fp32 throughout
OUT_TOL = 2e-2
LSE_TOL = 1e-3
# and out row by row (one query's out over D), as the backward's rows
# below: ||got - plain|| <= OUT_ROW_RTOL * ||plain row|| + OUT_ROW_ATOL *
# (rms row norm).  Where a query sees thousands of keys, |out| is about
# OUT_TOL itself (near 0.02 at 8192 keys of unit-variance v), so the
# elementwise rule alone would pass a P.V that is wrong while lse is right;
# each row held to its own norm fails it (phase 16 plants such a fault).
# A row's error is two bf16 roundings (P before P.V, out): a few 1e-3 of
# its norm, so OUT_ROW_RTOL leaves 4x and more
OUT_ROW_RTOL = 2e-2
OUT_ROW_ATOL = 1e-3
# backward kernels vs plain version, row by row (one query's dq, one key's dk
# or dv, over D): ||got - plain|| <= GRAD_RTOL * ||plain row|| + GRAD_ATOL *
# (rms row norm of the tensor).  A row's error comes from the bf16 rounding of
# its own elements (rms 2^-9 / sqrt(3) = 1.1e-3 relative), ds and p rounded to
# bf16 where the kernel's fp32 scores differ in their last bits, and sums in
# another order: a few 1e-3 of the row's norm, so GRAD_RTOL = 2e-2 leaves 4x
# and more.  GRAD_ATOL covers rows that are rounding noise in both, such as
# the dq of a query that sees one key (ds = p * (dp - delta) cancels).  Each
# row is held to its own norm, so a kernel that drops the contributions to
# the late keys (whose rows are small under a causal mask) fails; phase 2b
# plants two such faults and checks that this rule rejects them.
GRAD_RTOL = 2e-2
GRAD_ATOL = 1e-3
# flash vs xla path of the full model, bf16 (the xla path rounds its scores
# to bf16 before the softmax, the kernel keeps them in fp32)
LOSS_TOL = 1e-2
LOGITS_TOL = 0.1
# flash vs xla gradients of one training minibatch, relative L2 error per
# weight: bf16 activations and gradients through 12 layers, and the xla
# path's bf16 scores; the key slice of the qkv bias is left out (its
# gradient is zero in exact arithmetic, so both paths give rounding noise)
TRAIN_GRAD_TOL = 5e-2
SEED = 0
# cycles of the spin kernel `cuda_ms` queues per timed run: about 0.2 ms at
# the H100's clock, more than the host takes to launch one of the timed calls
SPIN_CYCLES_PER_RUN = 400_000
# name: (B, H, H_KV, S, D, kwargs, packed segments, timing iterations)
SHAPES = {
    "a_main": (8, 12, 12, 1024, 64, dict(causal=True), False, 50),
    "b_gqa_d128": (2, 16, 4, 2048, 128, dict(causal=True), False, 20),
    "c_window256": (8, 12, 12, 1024, 64, dict(causal=True, window=256), False, 50),
    "d_packed": (8, 12, 12, 1024, 64, dict(causal=True), True, 50),
    "e_offset_plus512": (4, 12, 12, 1024, 64, dict(causal=False, q_offset=512, window=384), False, 50),
    "e_offset_minus512": (4, 12, 12, 1024, 64, dict(causal=False, q_offset=-512, window=384), False, 50),
    "f_stream_8192": (1, 12, 12, 8192, 64, dict(causal=True), False, 10),
    "g_ragged_1000": (8, 12, 12, 1000, 64, dict(causal=True), False, 50),
}
# the shape the training pass gives the kernels: [16, 1024] per minibatch
TRAIN_SHAPE = (16, 12, 12, 1024, 64, dict(causal=True), False, 20)


def log(*parts):
    print(*parts, flush=True)


def cuda_ms(fn, iters, warmup=2):
    """Mean device time of ``fn`` in ms from CUDA events over ``iters`` runs.
    A spin kernel queued first keeps the card busy while the host enqueues
    the runs, so a call whose kernels are shorter than the host's work to
    launch them is timed on the device and not at the host's launch rate."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES_PER_RUN * iters)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters):
    """Mean wall time of ``fn`` in ms, each run ended by a synchronize."""
    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - start) * 1e3 / iters


def setup():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    import tpu_parallel_torch
    from tpu_parallel_torch.ops import build

    here = Path(__file__).resolve().parent
    if here not in Path(tpu_parallel_torch.__file__).resolve().parents:
        raise RuntimeError(f"tpu_parallel_torch imported from outside {here}")
    start = time.perf_counter()
    build.build_all()
    log(f"kernel build: {time.perf_counter() - start:.2f} s wall; nvcc seconds {build.build_seconds}")
    for name, report in build.build_reports.items():
        for line in report.splitlines():
            if "Used" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    return smi


def visible_pairs(b, h, s, s_kv, causal, window, q_offset, seg, device):
    """(query, key) pairs the inputs let attend, summed over batch and heads."""
    from tpu_parallel_torch.ops.flash_attention import _band_mask

    mask = _band_mask(0, 0, (s, s_kv), s, s_kv, causal, window, q_offset, device=device)
    if mask is None:
        mask = torch.ones(s, s_kv, dtype=torch.bool, device=device)
    if seg is None:
        return int(mask.sum()) * b * h
    same = seg[:, :, None] == seg[:, None, :]
    return int((mask[None] & same).sum()) * h


def _packed(b, s, gen):
    dev = gen.device
    cuts = torch.sort(torch.randint(1, s - 1, (b, 2), device=dev, generator=gen), dim=1).values
    pos = torch.arange(s, device=dev)[None, :]
    return ((pos >= cuts[:, :1]).int() + (pos >= cuts[:, 1:]).int()).to(torch.int32)


def _inputs(shape, gen, with_do=False, seg=None):
    """bf16 q, k, v (and do) and the segment ids (or None) of one shape;
    ``seg`` gives the segment ids (a packed batch's real ones)."""
    b, h, h_kv, s, d, _, pack, _ = shape
    dev = gen.device
    q = torch.randn(b, h, s, d, device=dev, generator=gen).to(torch.bfloat16)
    k = torch.randn(b, h_kv, s, d, device=dev, generator=gen).to(torch.bfloat16)
    v = torch.randn(b, h_kv, s, d, device=dev, generator=gen).to(torch.bfloat16)
    if seg is None and pack:
        seg = _packed(b, s, gen)
    if not with_do:
        return q, k, v, seg
    do = torch.randn(b, h, s, d, device=dev, generator=gen).to(torch.bfloat16)
    return q, k, v, seg, do


def _sdpa_mask(kw, s, seg, dev):
    """The boolean mask SDPA needs for a shape (None: plain causal, or a
    fully visible chunk; :func:`_sdpa_causal` says which)."""
    from tpu_parallel_torch.ops import flash_attention as fa

    if not (kw.get("window") or seg is not None):
        return None
    mask = fa._band_mask(0, 0, (s, s), s, s, kw["causal"], kw.get("window", 0),
                         kw.get("q_offset", 0), device=dev)
    mask = (torch.ones(s, s, dtype=torch.bool, device=dev) if mask is None else mask)[None, None]
    if seg is not None:
        mask = mask & (seg[:, :, None] == seg[:, None, :])[:, None]
    return mask


def _sdpa_causal(kw, mask):
    """SDPA's ``is_causal`` beside :func:`_sdpa_mask`'s mask."""
    return mask is None and kw["causal"]


def row_error_ratio(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL):
    """Worst row (last dim) of ``got`` against ``want``: its L2 error over
    its limit, rtol * ||row|| + atol * rms row norm; at most 1 passes."""
    g, w = got.float().flatten(0, -2), want.float().flatten(0, -2)
    err = (g - w).norm(dim=-1)
    ref = w.norm(dim=-1)
    limit = rtol * ref + atol * ref.square().mean().sqrt()
    return (err / limit.clamp(min=1e-30)).max().item()


def _bound(flops, nbytes):
    ops_ms = flops / PEAK_BF16_FLOPS * 1e3
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms > bytes_ms else "bytes"


def main_path_layout(*tensors):
    """The same values as [B, H, S, D]-shaped views in the layout the model
    hands the kernels: q, k, v as views of one fused [B, S, H, 3D] buffer
    when the heads match, as ``Attention.qkv`` makes
    them; under GQA q contiguous in [B, S, H, D] and k, v views of a fused
    [B, S, H_KV, 2D] buffer, as ``Attention.q`` and ``.kv`` do.  Further
    tensors (do) come back contiguous in [B, S, H, D], as the gradient of
    the model's output projection arrives."""
    q, k = tensors[:2]
    d = q.shape[3]
    bshd = [x.transpose(1, 2) for x in tensors]
    fused = 3 if q.shape[1] == k.shape[1] else 2  # q, k, v or k, v share a buffer
    views = [x.transpose(1, 2) for x in torch.cat(bshd[3 - fused:3], dim=-1).split(d, dim=-1)]
    rest = [x.contiguous().transpose(1, 2) for x in bshd[3:]]
    return [x.contiguous().transpose(1, 2) for x in bshd[:3 - fused]] + views + rest


def in_turns(fns, iters):
    """Medians of ``cuda_ms`` of each of two callables timed in turns (a,
    b, b, a), with the list of each one's times."""
    import statistics

    turns = ([], [])
    for i in (0, 1, 1, 0):
        turns[i].append(cuda_ms(fns[i], iters))
    return [statistics.median(t) for t in turns], turns


def kernel_phase(seed):
    """Phase 2: the kernel against its plain version at shapes (a)-(g), in
    the main path's layout and in [B, H, S, D]."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return {name: fwd_kernel_row(name, shape, gen)
            for name, shape in {**SHAPES, "t_train_pass": TRAIN_SHAPE}.items()}


def _plain_fwd(q, k, v, seg, kw, split=1):
    """``flash_fwd_reference`` over ``split`` groups of heads, concatenated:
    the same result (heads are independent), with [B, H / split, S, S] fp32
    scores at a time, so that a long sequence's fit on the card."""
    from tpu_parallel_torch.ops import flash_attention as fa

    hq, hk = q.shape[1] // split, k.shape[1] // split
    parts = [fa.flash_fwd_reference(q[:, i * hq:(i + 1) * hq], k[:, i * hk:(i + 1) * hk],
                                    v[:, i * hk:(i + 1) * hk], seg, seg, **kw)
             for i in range(split)]
    return tuple(torch.cat(x, 1) for x in zip(*parts))


def _plain_bwd(q, k, v, seg, out, lse, do, kw, split=1):
    """``flash_bwd_reference`` over ``split`` groups of heads (as
    :func:`_plain_fwd`)."""
    from tpu_parallel_torch.ops import flash_attention as fa

    hq, hk = q.shape[1] // split, k.shape[1] // split
    sq, sk = (lambda x, i: x[:, i * hq:(i + 1) * hq]), (lambda x, i: x[:, i * hk:(i + 1) * hk])
    parts = [fa.flash_bwd_reference(sq(q, i), sk(k, i), sk(v, i), seg, seg, sq(out, i),
                                    sq(lse, i), sq(do, i), **kw) for i in range(split)]
    return tuple(torch.cat(x, 1) for x in zip(*parts))


def fwd_kernel_row(name, shape, gen, seg=None, plain_split=1, plant=False):
    """One shape of phase 2 (and of phases 11-16's training shapes): the
    forward kernel against its plain version in both layouts (out also row
    by row), its time and SDPA's in turns, the plain version's time and the
    bound.  The plain version runs over ``plain_split`` groups of heads.
    ``plant``: also check that the row rule rejects a P.V fault that keeps
    lse, the kernel run with the second half of the keys' v zeroed."""
    import torch.nn.functional as F
    from tpu_parallel_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    b, h, h_kv, s, d, kw, pack, iters = shape
    q, k, v, seg = _inputs(shape, gen, seg=seg)
    qm, km, vm = main_path_layout(q, k, v)
    with torch.inference_mode():
        out, lse = fa._flash_fwd(qm, km, vm, seg, seg, **kw)
        out_bhsd, lse_bhsd = fa._flash_fwd(q, k, v, seg, seg, **kw)
        ref_out, ref_lse = _plain_fwd(q, k, v, seg, kw, plain_split)
        torch.cuda.synchronize()
        if not out.transpose(1, 2).is_contiguous():
            raise AssertionError(f"{name}: out is not [B, S, H, D] in memory")
        if not (torch.equal(out, out_bhsd) and torch.equal(lse, lse_bhsd)):
            raise AssertionError(f"{name}: out/lse differ between the two layouts")
        out_err = (out.float() - ref_out.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        empty_rows = int((ref_lse <= fa.NEG_INF / 2).sum())
        torch.testing.assert_close(out.float(), ref_out.float(), atol=OUT_TOL, rtol=OUT_TOL)
        torch.testing.assert_close(lse, ref_lse, atol=LSE_TOL, rtol=0)
        if empty_rows:
            assert (out.float()[ref_lse <= fa.NEG_INF / 2] == 0).all()
        out_ratio = row_error_ratio(out, ref_out, OUT_ROW_RTOL, OUT_ROW_ATOL)
        out_rms = ref_out.float().square().mean().sqrt().item()
        if out_ratio > 1:
            raise AssertionError(f"{name}: a row of out is {out_ratio:.2f}x its limit "
                                 f"({OUT_ROW_RTOL} * ||row|| + {OUT_ROW_ATOL} * rms row norm)")
        planted = None
        if plant:
            v_fault = v.clone()
            v_fault[:, :, s // 2:] = 0
            fault_out, fault_lse = fa._flash_fwd(q, k, v_fault, seg, seg, **kw)
            planted = dict(worst_row_ratio=row_error_ratio(fault_out, ref_out, OUT_ROW_RTOL,
                                                           OUT_ROW_ATOL),
                           max_abs_err=(fault_out.float() - ref_out.float()).abs().max().item())
            if not torch.equal(fault_lse, lse) or planted["worst_row_ratio"] <= 1:
                raise AssertionError(f"{name}: the planted P.V fault (lse kept) passes the row "
                                     f"rule: {planted}")
            del v_fault, fault_out, fault_lse

        mask = _sdpa_mask(kw, s, seg, dev)
        (ms, library_ms), turns = in_turns((
            lambda: fa._flash_fwd(qm, km, vm, seg, seg, **kw),
            lambda: F.scaled_dot_product_attention(qm, km, vm, attn_mask=mask,
                                                   is_causal=_sdpa_causal(kw, mask),
                                                   enable_gqa=h != h_kv),
        ), iters)
        ms_bhsd = cuda_ms(lambda: fa._flash_fwd(q, k, v, seg, seg, **kw), iters)
        plain_ms = cuda_ms(lambda: _plain_fwd(q, k, v, seg, kw, plain_split),
                           max(2, iters // 10), 1)
    pairs = visible_pairs(b, h, s, s, kw["causal"], kw.get("window", 0),
                          kw.get("q_offset", 0), seg, dev)
    flops = 4 * d * pairs  # Q.K^T and P.V, 2*D each per visible pair
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + out.numel()) + 4 * lse.numel()
    if seg is not None:
        nbytes += 2 * 4 * seg.numel()
    bound_ms, bound_by = _bound(flops, nbytes)
    row = dict(
        shape=f"B={b} H={h} Hkv={h_kv} S={s} D={d} {kw} packed={pack}",
        layout="views of fused [B, S, H, 3D] qkv" if h == h_kv
        else "q [B, S, H, D], k/v views of fused [B, S, Hkv, 2D] kv",
        max_abs_err=out_err, lse_max_abs_err=lse_err, empty_rows=empty_rows,
        out_worst_row_ratio=out_ratio, plain_out_rms=out_rms, planted_pv_fault=planted,
        bitwise_equal_across_layouts=True, ms=ms, kernel_turns_ms=turns[0], ms_bhsd=ms_bhsd,
        plain_ms=plain_ms, library_ms=library_ms, sdpa_turns_ms=turns[1], bound_ms=bound_ms,
        bound_by=bound_by, gflop=flops / 1e9, mbytes=nbytes / 1e6,
        share_of_bound=bound_ms / ms, tflops=flops / ms / 1e9,
    )
    log(f"[kernel {name}] {row['shape']}; main-path layout: {row['layout']}")
    log(f"  out max abs err {out_err:.3e} (atol=rtol={OUT_TOL}; plain out rms {out_rms:.3e}), "
        f"worst row over its limit {out_ratio:.3f} ({OUT_ROW_RTOL} * ||row|| + {OUT_ROW_ATOL} * "
        f"rms row norm), lse max abs err {lse_err:.3e} (atol {LSE_TOL}), empty rows "
        f"{empty_rows}; out and lse bitwise equal in [B, H, S, D]")
    if planted is not None:
        log(f"  planted P.V fault (v of the second half of the keys zeroed, lse bitwise the "
            f"kernel's): worst row {planted['worst_row_ratio']:.2f}x its limit (rejected), max "
            f"abs err {planted['max_abs_err']:.3e}")
    log(f"  kernel {ms:.4f} ms (turns {', '.join(f'{x:.4f}' for x in turns[0])}), SDPA "
        f"{library_ms:.4f} ms (turns {', '.join(f'{x:.4f}' for x in turns[1])}), kernel on "
        f"[B, H, S, D] {ms_bhsd:.4f} ms, plain {plain_ms:.4f} ms; bound {bound_ms:.4f} ms by "
        f"{row['bound_by']} ({row['gflop']:.2f} GFLOP, {row['mbytes']:.1f} MB), share of "
        f"bound {row['share_of_bound']:.3f}, {row['tflops']:.1f} TFLOP/s")
    del q, k, v, qm, km, vm, out, lse, out_bhsd, lse_bhsd, ref_out, ref_lse
    torch.cuda.empty_cache()
    return row


def backward_kernel_phase(seed):
    """Phase 2b: the backward kernel against its plain version at shapes
    (a)-(g) and the training pass's shape."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 10)
    return {name: bwd_kernel_row(name, shape, gen)
            for name, shape in {**SHAPES, "t_train_pass": TRAIN_SHAPE}.items()}


def bwd_kernel_row(name, shape, gen, seg=None, main_path=None, plain_split=1):
    """One shape of phase 2b (and of phases 11-16's training shapes): the
    backward kernel against its plain version row by row, its time and
    SDPA's backward in turns, the plain version's time and the one-pass
    bound; at the training shapes (``main_path``, default: the training
    pass) also two runs and the main path's layout.  The plain version runs
    over ``plain_split`` groups of heads."""
    import statistics

    import torch.nn.functional as F
    from tpu_parallel_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    if main_path is None:
        main_path = name == "t_train_pass"
    b, h, h_kv, s, d, kw, pack, iters = shape
    q, k, v, seg, do = _inputs(shape, gen, with_do=True, seg=seg)
    causal, window, q_offset = kw["causal"], kw.get("window", 0), kw.get("q_offset", 0)
    kernel = lambda: fa._flash_bwd(q, k, v, seg, seg, out, lse, do, **kw)
    row = dict(shape=f"B={b} H={h} Hkv={h_kv} S={s} D={d} {kw} packed={pack}")
    with torch.inference_mode():
        out, lse = fa._flash_fwd(q, k, v, seg, seg, **kw)
        got = kernel()
        want = _plain_bwd(q, k, v, seg, out, lse, do, kw, plain_split)
        torch.cuda.synchronize()
        errs, scales, ratios = {}, {}, {}
        for gname, g, w in zip(("dq", "dk", "dv"), got, want):
            errs[gname] = (g.float() - w.float()).abs().max().item()
            scales[gname] = w.float().abs().max().item()
            ratios[gname] = row_error_ratio(g, w)
            if ratios[gname] > 1:
                raise AssertionError(
                    f"{name}: a row of {gname} is {ratios[gname]:.2f}x its limit "
                    f"({GRAD_RTOL} * ||row|| + {GRAD_ATOL} * rms row norm)")
        empty = lse <= fa.NEG_INF / 2
        row["empty_rows"] = int(empty.sum())
        if row["empty_rows"] and not (got[0][empty] == 0).all():
            raise AssertionError(f"{name}: dq is not 0 on the {row['empty_rows']} empty rows")
        if name == "a_main":
            row["planted_faults"] = planted_faults((q, k, v, out, do, lse), kw, want)
        if main_path:
            again = kernel()
            torch.cuda.synchronize()
            if not (torch.equal(again[1], got[1]) and torch.equal(again[2], got[2])):
                raise AssertionError("dk / dv differ between two runs on the same inputs")
            row["dkv_bitwise_equal_across_runs"] = True
            row["dq_run_to_run_max_abs"] = (again[0].float() - got[0].float()).abs().max().item()
            row["dq_run_to_run_worst_row_ratio"] = row_error_ratio(again[0], got[0])
            del again
            # the main path's layout: q, k, v views of the fused qkv buffer,
            # out and do [B, S, H, D] in memory; dq, dk, dv written so
            qm, km, vm, om, dom = main_path_layout(q, k, v, out, do)
            strided = lambda: fa._flash_bwd(qm, km, vm, seg, seg, om, lse, dom, **kw)
            got_m = strided()
            torch.cuda.synchronize()
            if not all(g.transpose(1, 2).is_contiguous() for g in got_m):
                raise AssertionError("dq, dk, dv are not [B, S, H, D] in memory")
            ratios_m = {g: row_error_ratio(x, w)
                        for g, x, w in zip(("dq", "dk", "dv"), got_m, want)}
            if max(ratios_m.values()) > 1:
                raise AssertionError(f"strided backward: worst rows {ratios_m} over limit")
            if not (torch.equal(got_m[1], got[1]) and torch.equal(got_m[2], got[2])):
                raise AssertionError("strided dk / dv differ from the [B, H, S, D] run's")
            row["main_path_layout"] = dict(
                worst_row_ratio=ratios_m, dkv_bitwise_equal_to_bhsd=True,
                ms=cuda_ms(strided, iters))
            del got_m
        del got, want
        plain_ms = cuda_ms(lambda: _plain_bwd(q, k, v, seg, out, lse, do, kw, plain_split),
                           max(2, iters // 10), 1)
    # SDPA's backward alone, on a retained graph, timed in turns with the kernel
    mask = _sdpa_mask(kw, s, seg, dev)
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    sdpa_out = F.scaled_dot_product_attention(*leaves, attn_mask=mask,
                                              is_causal=_sdpa_causal(kw, mask),
                                              enable_gqa=h != h_kv)
    sdpa = lambda: torch.autograd.grad(sdpa_out, leaves, do, retain_graph=True)
    turns = {"kernel": [], "sdpa": []}
    for who in ("kernel", "sdpa", "sdpa", "kernel"):
        with torch.inference_mode(who == "kernel"):
            turns[who].append(cuda_ms(kernel if who == "kernel" else sdpa, iters))
    del sdpa_out, leaves
    ms, library_ms = statistics.median(turns["kernel"]), statistics.median(turns["sdpa"])
    pairs = visible_pairs(b, h, s, s, causal, window, q_offset, seg, dev)
    flops = 10 * d * pairs  # S, dP, dV, dK and dQ, 2*D each per visible pair
    # inputs read once (q, k, v, out, do, lse, segment ids), outputs written once
    nbytes = 2 * (2 * q.numel() + 2 * k.numel() + 2 * v.numel() + 2 * do.numel()) + 4 * lse.numel()
    if seg is not None:
        nbytes += 2 * 4 * seg.numel()
    bound_ms, bound_by = _bound(flops, nbytes)
    row.update(
        max_abs_err=max(errs.values()), errs=errs, max_abs_plain=scales,
        worst_row_ratio=ratios, ms=ms, kernel_turns_ms=turns["kernel"], plain_ms=plain_ms,
        library_ms=library_ms, sdpa_turns_ms=turns["sdpa"], bound_ms=bound_ms,
        bound_by=bound_by, gflop=flops / 1e9, mbytes=nbytes / 1e6,
        share_of_bound=bound_ms / ms, tflops=flops / ms / 1e9,
    )
    log(f"[bwd kernel {name}] {row['shape']}")
    log("  worst row over its limit " + ", ".join(f"{g} {ratios[g]:.3f}" for g in ratios)
        + f" (limit {GRAD_RTOL} * ||row|| + {GRAD_ATOL} * rms row norm; passes <= 1); "
        + "max abs err " + ", ".join(f"{g} {errs[g]:.3e} (max |plain| {scales[g]:.3e})"
                                     for g in errs)
        + f"; empty rows {row['empty_rows']} (dq 0 there)")
    if "planted_faults" in row:
        log("  planted faults, worst row over its limit (and max abs err over max |plain|): "
            + ", ".join(f"{f} {r['worst_row_ratio']:.2f} ({r['max_abs_over_max']:.3e})"
                        for f, r in row["planted_faults"].items()))
    if "dq_run_to_run_max_abs" in row:
        log(f"  two runs: dk, dv bitwise equal; dq max |run 1 - run 2| "
            f"{row['dq_run_to_run_max_abs']:.3e} (worst row {row['dq_run_to_run_worst_row_ratio']:.3f}"
            f" of its limit; fp32 atomics sum dq in a varying order)")
    if "main_path_layout" in row:
        m = row["main_path_layout"]
        log("  main-path layout (q, k, v views of fused qkv; out, do, dq, dk, dv "
            "[B, S, H, D]): worst row over its limit "
            + ", ".join(f"{g} {r:.3f}" for g, r in m["worst_row_ratio"].items())
            + f"; dk, dv bitwise equal to the [B, H, S, D] run's; {m['ms']:.4f} ms")
    log(f"  kernel {ms:.4f} ms (turns {', '.join(f'{x:.4f}' for x in turns['kernel'])}), "
        f"SDPA backward (dq, dk, dv) {library_ms:.4f} ms (turns "
        f"{', '.join(f'{x:.4f}' for x in turns['sdpa'])}), plain {plain_ms:.4f} ms; one-pass "
        f"bound {bound_ms:.4f} ms by {bound_by} ({row['gflop']:.2f} GFLOP, "
        f"{row['mbytes']:.1f} MB), share of bound {row['share_of_bound']:.3f}, "
        f"{row['tflops']:.1f} TFLOP/s")
    del q, k, v, do, out, lse
    torch.cuda.empty_cache()
    return row


def planted_faults(tensors, kw, want):
    """Kernel faults the backward check must reject, made with the real
    kernel by hiding keys or queries through the segment ids while lse and
    delta stay those of the whole input: dq without the last 64 keys, dk/dv
    without the last 64 queries, and dk/dv that leave out every key of the
    second half (rows that are small under a causal mask).  Raises if a
    fault's worst row is within its limit; returns each fault's worst-row
    ratio and its max abs error over max |plain|."""
    q, k, v, out, do, lse = tensors
    bwd = torch.ops.tpu_parallel_torch.flash_bwd
    s = q.shape[2]
    none = torch.zeros(q.shape[0], s, dtype=torch.int32, device=q.device)
    last_tile, second_half = none.clone(), none.clone()
    last_tile[:, -64:] = 1
    second_half[:, s // 2:] = 1
    opts = (kw["causal"], kw.get("window", 0), kw.get("q_offset", 0))
    dq = bwd(q, k, v, out, do, lse, None, none, last_tile, *opts)[0]
    dkv_tile = bwd(q, k, v, out, do, lse, None, last_tile, none, *opts)[1:]
    dkv_half = bwd(q, k, v, out, do, lse, None, none, second_half, *opts)[1:]
    faults = {}
    for fault, got, w in (("dq_without_last_64_keys", dq, want[0]),
                          ("dk_without_last_64_queries", dkv_tile[0], want[1]),
                          ("dv_without_last_64_queries", dkv_tile[1], want[2]),
                          ("dk_without_second_half_keys", dkv_half[0], want[1]),
                          ("dv_without_second_half_keys", dkv_half[1], want[2])):
        w = w.float()
        faults[fault] = dict(worst_row_ratio=row_error_ratio(got, w),
                             max_abs_over_max=((got.float() - w).abs().max() / w.abs().max()).item())
        if faults[fault]["worst_row_ratio"] <= 1:
            raise AssertionError(f"the backward check passes a planted fault: {fault} {faults[fault]}")
    return faults


def forward_phase(seed):
    """Phase 3: the full-width forward through the kernel, against xla."""
    from tpu_parallel_torch.core.losses import token_cross_entropy
    from tpu_parallel_torch.models import GPTLM, gpt2_125m
    from tpu_parallel_torch.ops import flash_attention as fa
    from tpu_parallel_torch.utils.profiling import transformer_flops_per_token

    cfg = gpt2_125m(attn_impl="flash")
    start = time.perf_counter()
    model = GPTLM(cfg, device="cuda", seed=seed).eval()
    ref = GPTLM(gpt2_125m(attn_impl="xla"), device="cuda", seed=seed).eval()
    ref.load_state_dict(model.state_dict())
    log(f"[forward] two GPT-2 125M models built in {time.perf_counter() - start:.1f} s")
    gen = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (8, 1024), generator=gen).cuda()
    targets = tokens.roll(-1, dims=1)
    with torch.inference_mode():
        before = fa.flash_fwd_launches
        logits = model(tokens)
        torch.cuda.synchronize()
        launched = fa.flash_fwd_launches - before
        if launched != cfg.n_layers:
            raise AssertionError(f"forward launched the kernel {launched} times, want {cfg.n_layers}")
        want = ref(tokens)
        if logits.shape != (8, 1024, cfg.vocab_size) or not torch.isfinite(logits).all():
            raise AssertionError(f"bad logits {tuple(logits.shape)}")
        loss = token_cross_entropy(logits, targets).mean().item()
        ref_loss = token_cross_entropy(want, targets).mean().item()
        logit_err = (logits.float() - want.float()).abs().max().item()
        log(f"[forward] loss flash {loss:.6f} xla {ref_loss:.6f} (|diff| {abs(loss - ref_loss):.2e}, "
            f"tol {LOSS_TOL}); logits max abs err {logit_err:.4f} (tol {LOGITS_TOL})")
        if abs(loss - ref_loss) > LOSS_TOL or logit_err > LOGITS_TOL:
            raise AssertionError("flash forward disagrees with the xla forward")
        del want
        ms = host_ms(lambda: model(tokens), 10)
        xla_ms = host_ms(lambda: ref(tokens), 5)
    toks = tokens.numel()
    fwd_flops = transformer_flops_per_token(cfg) / 3 * toks  # a forward is 1/3 of 6N+attn
    log(f"[forward] {ms:.3f} ms per forward [8, 1024] (xla path {xla_ms:.3f} ms), "
        f"{toks / ms * 1e3:.0f} tokens/s, {fwd_flops / ms / 1e9:.1f} TFLOP/s achieved")
    del ref
    torch.cuda.empty_cache()
    return model, dict(forward_ms=ms, xla_forward_ms=xla_ms, tokens_per_s=toks / ms * 1e3,
                       tflops=fwd_flops / ms / 1e9, loss=loss, xla_loss=ref_loss,
                       logits_max_abs_err=logit_err)


def generate_phase(model, seed):
    """Phase 4: ragged greedy and top-p generation; prefill against the
    kernel forward."""
    from tpu_parallel_torch.models.generate import generate, prefill_step

    cfg = model.config
    lengths = [16, 50, 97, 128]
    width, new = max(lengths), 32
    gen = torch.Generator().manual_seed(seed + 1)
    prompt = torch.randint(0, cfg.vocab_size, (len(lengths), width), generator=gen).cuda()
    mask = torch.zeros(len(lengths), width, dtype=torch.bool)
    for r, n in enumerate(lengths):
        mask[r, width - n:] = True  # left-padded
    mask = mask.cuda()
    with torch.inference_mode():
        greedy = generate(model, prompt, max_new_tokens=new, prompt_mask=mask)
        sampled = generate(model, prompt, torch.Generator(device="cuda").manual_seed(seed),
                           max_new_tokens=new, temperature=0.8, top_p=0.9, prompt_mask=mask)
        for name, out in (("greedy", greedy), ("top-p", sampled)):
            if out.shape != (len(lengths), new) or out.min() < 0 or out.max() >= cfg.vocab_size:
                raise AssertionError(f"{name} tokens {tuple(out.shape)} out of range")
        positions = torch.where(mask, mask.long().cumsum(1) - 1, torch.full_like(prompt, -1))
        hidden, _ = prefill_step(model, prompt, positions)
        dec_logits = model.lm_head(hidden[:, -1]).float()
        err = 0.0
        for r, n in enumerate(lengths):
            fwd = model(prompt[r:r + 1, width - n:])[0, -1].float()
            err = max(err, (fwd - dec_logits[r]).abs().max().item())
        log(f"[generate] greedy {tuple(greedy.shape)} first row {greedy[0, :8].tolist()}, "
            f"top-p {tuple(sampled.shape)}; prefill last-position logits vs kernel forward "
            f"max abs err {err:.4f} (tol {LOGITS_TOL})")
        if err > LOGITS_TOL:
            raise AssertionError("decode-path prefill disagrees with the kernel forward")
        prefill_ms = host_ms(lambda: generate(model, prompt, max_new_tokens=1, prompt_mask=mask), 5)
        total_ms = host_ms(lambda: generate(model, prompt, max_new_tokens=new + 1, prompt_mask=mask), 3)
    decode_tps = len(lengths) * new / ((total_ms - prefill_ms) / 1e3)
    log(f"[generate] prefill [4, {width}] + first token {prefill_ms:.3f} ms; decode "
        f"{decode_tps:.1f} tokens/s at batch {len(lengths)} "
        f"({(total_ms - prefill_ms) / new:.3f} ms per step)")
    return dict(prefill_ms=prefill_ms, decode_tokens_per_s=decode_tps,
                decode_step_ms=(total_ms - prefill_ms) / new)


# kinds of device kernels in a profile, by a substring of their names
PROFILE_GROUPS = (
    ("flash kernels", ("flash_fwd_kernel", "flash_bwd_")),
    ("GEMM", ("nvjet", "gemm", "cutlass", "xmma")),
    ("softmax/CE", ("SoftMax", "softmax", "nll_loss")),
    ("LayerNorm", ("layer_norm", "GammaBeta")),
    ("copies/casts", ("copy", "Memcpy", "Memset")),
)


def _profile(name, fn, grad=False):
    """Device time by kernel and the device's idle share over one call of
    ``fn`` after a warm-up call (``torch.profiler``)."""
    import contextlib

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with contextlib.nullcontext() if grad else torch.inference_mode():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - start) * 1e6
    # device-side entries only: an aten op's entry repeats its kernels' time
    events = [(e.key, e.count, e.self_device_time_total) for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy_us = sum(t for _, _, t in events)
    log(f"[profile {name}] wall {wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms "
        f"(idle share {1 - busy_us / wall_us:.3f})")
    groups = {}
    for key, _, t in events:
        group = next((g for g, marks in PROFILE_GROUPS if any(m in key for m in marks)), "other")
        groups[group] = groups.get(group, 0.0) + t
    log("  by kind: " + ", ".join(f"{g} {t / 1e3:.3f} ms ({100 * t / busy_us:.1f}%)"
                                  for g, t in sorted(groups.items(), key=lambda e: -e[1])))
    for label, mark in (("forward", "flash_fwd_"), ("backward", "flash_bwd_")):
        picked = [(c, t) for key, c, t in events if mark in key]
        if picked:
            log(f"  flash {label} kernels: {sum(t for _, t in picked) / 1e3:.3f} ms in "
                f"{sum(c for c, _ in picked)} launches")
    # copy kernels by name: layout copies, dtype casts and concatenations all
    # run through PyTorch's copy kernels
    copies = [e for e in events if "copy" in e[0].lower()]
    log(f"  copy kernels: {sum(c for _, c, _ in copies)} launches, "
        f"{sum(t for _, _, t in copies) / 1e3:.3f} ms")
    for key, count, t in sorted(copies, key=lambda e: -e[2]):
        log(f"    {t / 1e3:9.3f} ms x{count:<5d} {key[:150]}")
    for key, count, t in sorted(events, key=lambda e: -e[2])[:12]:
        log(f"  {t / 1e3:9.3f} ms {100 * t / busy_us:5.1f}% x{count:<5d} {key[:90]}")


def profile_phase(model, seed):
    """Phase 5: one forward [8, 1024] and 8 decode steps at batch 4."""
    from tpu_parallel_torch.models.generate import generate

    gen = torch.Generator().manual_seed(seed + 2)
    tokens = torch.randint(0, model.config.vocab_size, (8, 1024), generator=gen).cuda()
    prompt = tokens[:4, :128].contiguous()
    _profile("forward [8, 1024]", lambda: model(tokens))
    _profile("generate [4, 128] + 8 new", lambda: generate(model, prompt, max_new_tokens=8))


LAUNCH_COUNTERS = ("flash_fwd_launches", "flash_bwd_launches")


def train_phase(seed, card_name):
    """Phase 6: bench.py's training loop on the port's Trainer, launches per
    step, throughput and memory; flash against xla gradients on one
    minibatch; a profile of one step.  Returns the main path's launches."""
    import dataclasses
    import math

    from tpu_parallel_torch.core.metrics import compute
    from tpu_parallel_torch.models import GPTLM
    from tpu_parallel_torch.models.gpt import make_gpt_loss
    from tpu_parallel_torch.ops import flash_attention as fa
    from tpu_parallel_torch.train_lib import Trainer, TrainerConfig
    from tpu_parallel_torch.utils.profiling import peak_flops, transformer_flops_per_token

    # 3 timed steps (12, then 6, until the whole run neared its time limit)
    warmup, timed = 3, 3
    config = TrainerConfig(
        model="gpt2_125m", global_batch_size=256, num_minibatches=16, steps=warmup + timed,
        seed=seed, model_overrides=dict(dropout_rate=0.0, remat=True, remat_policy="proj_attn",
                                        attn_impl="flash", scan_layers=False),
    )
    start = time.perf_counter()
    trainer = Trainer(config, device="cuda")
    state = trainer.init()
    batch = trainer.example_batch
    cfg = trainer.model_config
    log(f"[train] GPT-2 125M trainer (fp32 masters, AdamW) built in "
        f"{time.perf_counter() - start:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    for name in LAUNCH_COUNTERS:  # the training main path starts here
        setattr(fa, name, 0)
    per_step, step_metrics = [], []
    t0 = None
    for i in range(warmup + timed):
        if i == warmup:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        before = [getattr(fa, name) for name in LAUNCH_COUNTERS]
        state, metrics = trainer.step_fn(state, None, batch)
        per_step.append([getattr(fa, name) - n for name, n in zip(LAUNCH_COUNTERS, before)])
        step_metrics.append(metrics)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {name: getattr(fa, name) for name in LAUNCH_COUNTERS}
    peak_mem = torch.cuda.max_memory_allocated()
    losses = [compute(m)["loss"] for m in step_metrics]
    want = cfg.n_layers * config.num_minibatches
    if any(n != [want] * len(LAUNCH_COUNTERS) for n in per_step):
        raise AssertionError(f"launches per step (fwd, bwd) {per_step}, want {want} each")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"training loss not finite and falling: {losses}")
    tokens = config.global_batch_size * cfg.seq_len
    step_ms = dt / timed * 1e3
    tokens_per_s = tokens * timed / dt
    peak = peak_flops(card_name)
    mfu = tokens_per_s * transformer_flops_per_token(cfg) / peak if peak else None
    log(f"[train] losses by step {[round(x, 5) for x in losses]}")
    log(f"[train] launches per step (flash_fwd, flash_bwd) {per_step[-1]} "
        f"in every step, {launches} over {warmup + timed} steps")
    log(f"[train] {step_ms:.2f} ms per step of {tokens} tokens ({config.num_minibatches} "
        f"minibatches of [16, 1024]), {tokens_per_s:.0f} tokens/s, MFU {mfu} against "
        f"{peak} FLOP/s ({card_name}); max memory allocated {peak_mem / 2**30:.2f} GiB")

    # one minibatch's loss and gradients, flash against xla on the same weights
    mb = batch.rows(0, config.global_batch_size // config.num_minibatches)
    ref = GPTLM(dataclasses.replace(cfg, attn_impl="xla"), device="cuda", seed=seed)
    ref.load_state_dict(trainer.model.state_dict())
    results = {}
    for name, model in (("flash", trainer.model), ("xla", ref)):
        loss, _ = make_gpt_loss(model.config)(model, mb)
        loss.backward()
        results[name] = (loss.item(), {n: p.grad.float() for n, p in model.named_parameters()})
        model.zero_grad(set_to_none=True)
    del ref
    dh = cfg.head_dim
    not_key = (torch.arange(3 * cfg.d_model, device="cuda") % (3 * dh)) // dh != 1
    rel = {}
    for n, g_x in results["xla"][1].items():
        g_f = results["flash"][1][n]
        if n.endswith("attn.qkv.bias"):
            g_f, g_x = g_f[not_key], g_x[not_key]
        rel[n] = ((g_f - g_x).norm() / g_x.norm().clamp(min=1e-30)).item()
    worst = max(rel, key=rel.get)
    loss_diff = abs(results["flash"][0] - results["xla"][0])
    log(f"[train] minibatch loss flash {results['flash'][0]:.6f} xla {results['xla'][0]:.6f} "
        f"(|diff| {loss_diff:.2e}, tol {LOSS_TOL}); gradient relative L2 error median "
        f"{sorted(rel.values())[len(rel) // 2]:.3e}, max {rel[worst]:.3e} ({worst}), tol "
        f"{TRAIN_GRAD_TOL}")
    if loss_diff > LOSS_TOL or rel[worst] > TRAIN_GRAD_TOL:
        raise AssertionError("flash training gradients disagree with the xla path")
    del results
    torch.cuda.empty_cache()

    _profile("train step [256, 1024] in 16 minibatches",
             lambda: trainer.step_fn(trainer.state, None, batch), grad=True)
    return launches, dict(
        losses=losses, step_ms=step_ms, tokens_per_s=tokens_per_s, mfu=mfu, peak_flops=peak,
        max_memory_allocated=peak_mem, launches_per_step=per_step[-1],
        flash_xla_loss=(loss_diff, LOSS_TOL), flash_xla_grad_rel_l2_max=(rel[worst], worst),
    )


# phase 7: the serving engine's workload (GPT-2 125M, seeded weights)
SERVE_SLOTS = 16
SERVE_REQUESTS = 32  # 48 until phase 18 needed the run's time
SERVE_SAMPLED = 8
SERVE_SHARED_PREFIX = (8, 128)  # 8 prompts share a 128-token prefix
SERVE_FIRST_TICK, SERVE_PER_TICK = 16, 4
SERVE_FP32_REQUESTS = 8
# the runs: (name, decode steps per tick, bodies eager, overlap, engine
# kwargs).  The first four are pinned to the per-phase tick, so they stay
# comparable with earlier runs; the unified ones fold chunked prefills into
# the tick, over the contiguous pool, the paged pool (32-token blocks,
# 16 x 32 = 512 of them), and the same 512 blocks (the contiguous pool's
# KV memory) under 32 slots
PER_PHASE = dict(unified_tick=False)
PAGED = dict(kv_block_tokens="auto")
RUNS = (("per_step", 1, False, False, PER_PHASE), ("fused_eager", 8, True, False, PER_PHASE),
        ("fused_graph", 8, False, False, PER_PHASE),
        ("fused_graph_overlap", 8, False, True, PER_PHASE),
        ("unified_graph", 8, False, False, {}),
        ("paged_unified_graph", 8, False, False, PAGED),
        ("paged_unified_graph_32slots", 8, False, False,
         dict(PAGED, n_slots=2 * SERVE_SLOTS, kv_pool_blocks=512)))
# graph captures each run must make (the 32-slot run is not pinned)
CAPTURES = dict(per_step=0, fused_eager=0, fused_graph=1, fused_graph_overlap=1,
                unified_graph=2, paged_unified_graph=2)
# runs whose greedy tokens must equal per_step's bitwise (the 32-slot run
# decodes at another GEMM batch, so its bits may differ)
BITWISE_RUNS = ("fused_eager", "fused_graph", "fused_graph_overlap", "unified_graph",
                "paged_unified_graph")
# runs with a pure-decode stretch, and its decode steps per timed and per
# profiled window (the profiled window's trace takes most of a stretch's
# seconds; 32 steps keep the run inside its time limit)
STRETCH_STEPS = 8
STRETCH_RUNS = ("per_step", "fused_eager", "fused_graph", "fused_graph_overlap",
                "paged_unified_graph")
# an fp32 engine token that differs from static generate() must sit on a
# near-tie of the reference: its top-2 logit gap below this
FP32_TIE_GAP = 1e-4


def serve_workload(seed, vocab):
    """SERVE_REQUESTS requests from ``seed`` with numpy: prompt lengths
    16-768 (8 of them behind one shared 128-token prefix), 32-128 new
    tokens, 8 of them sampled (temperature 0.8, top_p 0.9), in arrival order.
    Returns (prompt, max_new_tokens, sampled) triples."""
    import numpy as np

    rs = np.random.default_rng(seed)
    n_shared, prefix_len = SERVE_SHARED_PREFIX
    prefix = rs.integers(0, vocab, prefix_len).tolist()
    lengths = rs.integers(16, 769, SERVE_REQUESTS)
    budgets = rs.integers(32, 129, SERVE_REQUESTS)
    shared = set(rs.choice(SERVE_REQUESTS, n_shared, replace=False).tolist())
    sampled = set(rs.choice(SERVE_REQUESTS, SERVE_SAMPLED, replace=False).tolist())
    out = []
    for i in range(SERVE_REQUESTS):
        if i in shared:
            tail = rs.integers(0, vocab, max(1, int(lengths[i]) - prefix_len)).tolist()
            prompt = prefix + tail
        else:
            prompt = rs.integers(0, vocab, int(lengths[i])).tolist()
        out.append((prompt, int(budgets[i]), i in sampled))
    return out


def serve_engine(model, steps, seed, eager=False, **kwargs):
    from tpu_parallel_torch.serving import SchedulerConfig, ServingEngine

    eng = ServingEngine(
        model, **{"n_slots": SERVE_SLOTS, **kwargs},
        scheduler=SchedulerConfig(max_prefills_per_tick=4),
        rng=torch.Generator(device=model.device).manual_seed(seed), prefill_buckets="auto",
        prefill_batch=4, prefill_chunk_tokens=256, prefix_cache_size=4,
        decode_steps_per_tick=steps,
    )
    if eager:
        eng._run_fused_eagerly()
    return eng


def _watch_blocks(eng):
    """Paged engines: count the block gate's holds and the allocator's peak
    of blocks in use over a run.  Returns a dict the run fills in."""
    seen = dict(peak_blocks_in_use=0, block_gate_holds=0)
    allocator, make_gate = eng.pool.allocator, eng._block_gate
    alloc = allocator.alloc

    def counted_alloc():
        block = alloc()
        seen["peak_blocks_in_use"] = max(seen["peak_blocks_in_use"], allocator.in_use)
        return block

    def counted_gate():
        gate = make_gate()

        def check(out):
            admit = gate(out)
            seen["block_gate_holds"] += not admit
            return admit
        return check

    allocator.alloc, eng._block_gate = counted_alloc, counted_gate
    return seen


def serve_run(model, workload, steps, seed, eager=False, overlap=False, **kwargs):
    """One run of the workload: 16 requests at tick 0, then 4 per tick,
    then ``run(overlap=overlap)`` to idle.  Returns (engine, outputs, wall
    seconds, peak memory, block counts of a paged engine)."""
    from tpu_parallel_torch.serving import Request, SamplingParams

    eng = serve_engine(model, steps, seed, eager, **kwargs)
    blocks = _watch_blocks(eng) if "kv_block_tokens" in kwargs else None
    capture, captured_s = eng._capture_graph, [0.0]

    def timed_capture(body):  # warm-up + capture, inside the run's wall time
        t0 = time.perf_counter()
        graph = capture(body)
        captured_s[0] += time.perf_counter() - t0
        return graph

    eng._capture_graph = timed_capture
    requests = [
        Request(prompt=p, max_new_tokens=n, request_id=f"r{i}",
                sampling=SamplingParams(temperature=0.8, top_p=0.9) if hot else SamplingParams())
        for i, (p, n, hot) in enumerate(workload)
    ]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    outs = [eng.add_request(r) for r in requests[:SERVE_FIRST_TICK]]
    while len(outs) < len(requests):
        eng.step()
        outs += [eng.add_request(r) for r in requests[len(outs):len(outs) + SERVE_PER_TICK]]
    eng.run(overlap=overlap)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    eng.capture_s = captured_s[0]
    return eng, outs, wall, torch.cuda.max_memory_allocated(), blocks


def _check_blocks_returned(name, eng):
    """A paged run's end: the allocator audit passes and, once the prefix
    cache's entries are released, every block is free."""
    pool = eng.pool
    pool.allocator.check()
    for blocks, _ in list(eng._prefix.values()):
        pool.free_stored(blocks)
    pool.allocator.check()
    if pool.blocks_in_use or (pool.block_table >= 0).any():
        raise AssertionError(f"[serve {name}] {pool.blocks_in_use} blocks still in use")


def decode_stretch(model, steps, seed, ticks, eager=False, overlap=False, **kwargs):
    """A profiled stretch of pure-decode ticks: 16 slots decoding (prompts
    of 64 tokens, 512 new each), no admission or prefill inside it, ticked
    as the run of the same name ticks (``run(overlap=...)``).  Returns
    decode tokens/s unprofiled, and the device idle share, kernel launches
    per token, device ms per decode step, the copy and gather kernels
    (``direct_copy``, ``index_select``, ``gather``) per step by name, and
    the ten longest kernels of the profiled ticks."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpu_parallel_torch.serving import Request

    gen = torch.Generator().manual_seed(seed)
    eng = serve_engine(model, steps, seed, eager, **kwargs)
    for i in range(SERVE_SLOTS):
        prompt = torch.randint(0, model.config.vocab_size, (64,), generator=gen).tolist()
        eng.add_request(Request(prompt=prompt, max_new_tokens=512, request_id=f"d{i}"))
    while eng.scheduler.depth or eng.in_flight < SERVE_SLOTS:
        eng.step()
    eng.step()  # the first fused tick captures its graph
    torch.cuda.synchronize()
    before = eng.metrics.tokens_out
    start = time.perf_counter()
    eng.run(max_ticks=ticks, overlap=overlap)
    torch.cuda.synchronize()
    tps = (eng.metrics.tokens_out - before) / (time.perf_counter() - start)
    before = eng.metrics.tokens_out
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        eng.run(max_ticks=ticks, overlap=overlap)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - start) * 1e6
    tokens = eng.metrics.tokens_out - before
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    launches = sum(e.count for e in events)
    decode_steps = ticks * steps
    top = [(e.key[:100], e.count, e.self_device_time_total / 1e3)
           for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]]
    # copy and gather kernels, one entry per kernel (template) name: a
    # cache-sized one moves 25 MB per launch, tens of us
    kinds = [dict(kernel=e.key[:90], launches_per_step=e.count / decode_steps,
                  ms_per_step=e.self_device_time_total / 1e3 / decode_steps,
                  us_per_launch=e.self_device_time_total / e.count)
             for e in sorted(events, key=lambda e: -e.self_device_time_total)
             if any(m in e.key for m in ("direct_copy", "indexSelect", "scatter_gather"))]
    return dict(decode_tokens_per_s=tps, idle_share=1 - busy_us / wall_us,
                device_busy_ms=busy_us / 1e3, profiled_wall_ms=wall_us / 1e3,
                device_ms_per_step=busy_us / 1e3 / decode_steps, decode_steps=decode_steps,
                kernel_launches_per_token=launches / max(tokens, 1), profiled_tokens=tokens,
                copies_per_step=kinds, top_kernels_ms=top)


def fp32_check(seed, workload, tie_gap=FP32_TIE_GAP, **overrides):
    """The same weights in fp32 (TF32 off): 8 greedy requests through the
    fused, captured engine against static ``generate()`` at batch 1, token
    for token.  A differing token passes only on a near-tie: the
    reference's top-2 logit gap at that step below ``tie_gap`` (with
    config ``overrides``, such as the int8 cache, the gap is read through
    that cache: a prefill of the context with ``decode=True``)."""
    from tpu_parallel_torch.models import GPTLM, gpt2_125m
    from tpu_parallel_torch.models.generate import generate
    from tpu_parallel_torch.serving import Request

    model = GPTLM(gpt2_125m(dtype=torch.float32, **overrides), device="cuda", seed=seed).eval()
    picked = [(i, p, n) for i, (p, n, hot) in enumerate(workload) if not hot][:SERVE_FP32_REQUESTS]
    eng = serve_engine(model, 8, seed)
    outs = [eng.add_request(Request(prompt=p, max_new_tokens=n, request_id=f"r{i}"))
            for i, p, n in picked]
    eng.run()
    report = []
    with torch.inference_mode():
        for (i, p, n), out in zip(picked, outs):
            want = generate(model, torch.tensor([p], device="cuda"), max_new_tokens=n)[0].tolist()
            if out.tokens == want:
                report.append(dict(request=i, tokens=n, equal=True))
                continue
            step = next(j for j, (a, b) in enumerate(zip(out.tokens, want)) if a != b)
            ctx = torch.tensor([p + want[:step]], device="cuda")
            cached = dict(decode=True, cache=model.init_cache(1)) if overrides else {}
            logits = model(ctx, **cached)[0, -1].float()
            top2 = logits.topk(2).values
            gap = (top2[0] - top2[1]).item()
            report.append(dict(request=i, tokens=n, equal=False, first_diff=step, top2_gap=gap))
            limit = tie_gap
            if overrides.get("kv_cache_dtype") == "int8":
                report[-1].update(_int8_shape_noise(model, ctx, cached["cache"], logits))
                # a token may flip where the two top logits lie closer than
                # the batch shape alone moves them (each by up to the noise)
                limit = max(tie_gap, 2 * report[-1]["shape_noise"])
            if gap >= limit:
                raise AssertionError(f"fp32 engine request r{i} differs from generate() at "
                                     f"token {step} with top-2 gap {gap:.3e} >= {limit:.3e}: "
                                     f"{report[-1]}")
    del model, eng
    torch.cuda.empty_cache()
    return report


def _int8_shape_noise(model, ctx, cache, logits):
    """What the GEMMs' shape alone does to an int8 decode: the context
    prefilled at batch 1 (``cache``, last-position ``logits``) against row
    0 of the same context at batch 16.  Returns the largest logit
    difference, and the int8 payload elements that differ, per layer.  In
    layer 0 (whose K and V come from the embedding through one GEMM) an
    element may move by one step only, across a .5 boundary of its grid
    (held); deeper layers read earlier layers' caches, so a flip there
    moves their inputs and the steps compound."""
    many = model.init_cache(SERVE_SLOTS)
    wide = model(ctx.expand(SERVE_SLOTS, -1), decode=True, cache=many)[0, -1].float()
    flips, steps = [], []
    for one, row in zip(cache, many):
        k, v = one.read()[:2]
        k2, v2 = row.read()[:2]
        d = torch.cat([(k.int() - k2[:, :1].int()).abs().flatten(),
                       (v.int() - v2[:, :1].int()).abs().flatten()])
        flips.append(int((d > 0).sum()))
        steps.append(int(d.max()))
    if steps[0] > 1:
        raise AssertionError(f"layer 0's int8 payloads at batch 1 and 16 differ by {steps[0]} steps")
    return dict(shape_noise=(logits - wide).abs().max().item(), int8_flips_by_layer=flips,
                int8_max_step_by_layer=steps)


def cache_sized_copies(model, seed):
    """Copies of at least one layer's cache payload that one eager decode
    step at 16 slots dispatches, per layout, by op name (a
    ``TorchDispatchMode`` over ``decode_step``; the captured ticks replay
    these same ops)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from tpu_parallel_torch.models.generate import decode_step
    from tpu_parallel_torch.serving import PagedCachePool

    cfg = model.config
    n = SERVE_SLOTS
    cache_numel = cfg.n_heads * n * cfg.seq_len * cfg.head_dim
    gen = torch.Generator().manual_seed(seed)
    tok = torch.randint(0, cfg.vocab_size, (n,), generator=gen).cuda()
    pos = torch.randint(0, cfg.seq_len, (n,), generator=gen).cuda()
    names = ("copy_", "clone", "_to_copy", "index_select", "contiguous", "cat", "index",
             "gather", "_reshape_copy")

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__
            if name in names and isinstance(out, torch.Tensor) and out.numel() >= cache_numel:
                self.seen[name] = self.seen.get(name, 0) + 1
            return out

    paged = PagedCachePool(model, n, block_tokens=32, n_blocks=n * cfg.seq_len // 32)
    for slot in range(n):
        paged.acquire()
        paged.ensure_writable(slot, 0, cfg.seq_len)
    table = torch.from_numpy(paged.block_table).long().cuda()
    out = {}
    with torch.inference_mode():
        for name, cache, kw in (("contiguous", model.init_cache(n), {}),
                                ("paged", paged.cache, dict(block_table=table))):
            counter = Count()
            with counter:
                decode_step(model, cache, tok, pos, write_index=pos, **kw)
            out[name] = counter.seen
    del paged
    torch.cuda.empty_cache()
    return out


def serve_phase(seed, smi):
    """Phase 7: the continuous-batching engine on GPT-2 125M (bf16, seeded
    weights) over one SERVE_REQUESTS-request workload, run as ``RUNS`` lists: the
    four per-phase runs ((i) per-step ticks, (ii) fused T=8 ticks with the
    body run eagerly, (iii) fused T=8 ticks replaying one CUDA graph, (iv)
    as (iii) under ``run(overlap=True)``), then the unified ragged tick
    over the contiguous pool, over the paged pool, and over the same 512
    blocks with 32 slots.  Greedy tokens bitwise equal across all but the
    32-slot run, sampled tokens in the vocabulary, the pinned graph
    captures, no flash launch, every block returned by the paged runs;
    pure-decode stretches, the cache-sized copies of one decode step per
    layout, then the fp32 check against static generate()."""
    from tpu_parallel_torch.models import GPTLM, gpt2_125m
    from tpu_parallel_torch.ops import flash_attention as fa

    start, parts_s = time.perf_counter(), {}

    def lap(name):
        parts_s[name] = time.perf_counter() - start - sum(parts_s.values())

    cfg = gpt2_125m()
    model = GPTLM(cfg, device="cuda", seed=seed).eval()
    workload = serve_workload(seed, cfg.vocab_size)
    flash_before = [getattr(fa, name) for name in LAUNCH_COUNTERS]
    lap("model")
    runs = {}
    for name, steps, eager, overlap, kwargs in RUNS:
        eng, outs, wall, peak, blocks = serve_run(model, workload, steps, seed, eager, overlap,
                                                  **kwargs)
        s = eng.metrics.summary()
        bad = [o.request.request_id for o in outs if o.status != "finished"
               or len(o.tokens) != o.request.max_new_tokens]
        if bad:
            raise AssertionError(f"[serve {name}] requests not finished at their budget: {bad}")
        for o in outs:
            if min(o.tokens) < 0 or max(o.tokens) >= cfg.vocab_size:
                raise AssertionError(f"[serve {name}] {o.request.request_id} tokens out of range")
        hists = {row["name"]: row for row in eng.registry.snapshot()["histograms"]}
        unified_ticks = hists.get("serving_unified_tick_tokens", {}).get("count", 0)
        runs[name] = dict(
            tokens={o.request.request_id: o.tokens for o in outs},
            wall_s=wall, tokens_out=s["tokens_out"], tokens_per_s=s["tokens_out"] / wall,
            ttft_ms_p50=s["ttft_ms_p50"], ttft_ms_p95=s["ttft_ms_p95"],
            itl_ms_p50=s["itl_ms_p50"], itl_ms_p95=s["itl_ms_p95"],
            host_ms_per_tick_p50=s["host_ms_per_tick_p50"],
            host_ms_per_tick_p95=s["host_ms_per_tick_p95"],
            host_ms_per_tick_max=hists["serving_host_ms_per_tick"]["max"],
            graph_capture_s=eng.capture_s, ticks=s["ticks"],
            host_dispatches_per_token=s["host_dispatches"] / s["tokens_out"],
            prefix_hits=s["prefix_hits"], prefix_misses=s["prefix_misses"],
            prefill_calls=s["prefill_calls"], prefill_chunks=s["prefill_chunks"],
            unified_ticks=unified_ticks, unified_chunks=s["prefill_chunks"] if eng.unified_tick
            else 0, peak_memory_gib=peak / 2**30, graph_captures=eng.graph_captures,
            host_overlap_ratio=s["host_overlap_ratio"],
        )
        if blocks is not None:
            runs[name].update(blocks, cow_copies=eng.pool.cow_copies, n_blocks=eng.pool.n_blocks,
                              block_tokens=eng.pool.block_tokens, slots=eng.pool.n_slots)
            _check_blocks_returned(name, eng)
        # the measuring wrappers tie the engine into reference cycles: free
        # its pool now, so the next run's peak memory is its own
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    captures = {name: r["graph_captures"] for name, r in runs.items() if name in CAPTURES}
    if captures != CAPTURES:
        raise AssertionError(f"graph captures by run: {captures}, want {CAPTURES}")
    if not runs["fused_graph_overlap"]["host_overlap_ratio"] > 0:
        raise AssertionError("run(overlap=True) never launched a tick ahead")
    greedy = [f"r{i}" for i, (_, _, hot) in enumerate(workload) if not hot]
    for name in BITWISE_RUNS:
        differ = [r for r in greedy if runs[name]["tokens"][r] != runs["per_step"]["tokens"][r]]
        if differ:
            r = differ[0]
            a, b = runs["per_step"]["tokens"][r], runs[name]["tokens"][r]
            step = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
            raise AssertionError(f"[serve] greedy tokens of {len(differ)} requests differ between "
                                 f"per_step and {name} (first: {r} at token {step})")
    same_32 = sum(runs["paged_unified_graph_32slots"]["tokens"][r] == runs["per_step"]["tokens"][r]
                  for r in greedy)
    moved = [getattr(fa, name) - n for name, n in zip(LAUNCH_COUNTERS, flash_before)]
    if any(moved):
        raise AssertionError(f"the serving path launched flash kernels: {moved}")
    lap("runs")
    for name, steps, eager, overlap, kwargs in RUNS:
        if name in STRETCH_RUNS:
            runs[name]["decode_stretch"] = decode_stretch(
                model, steps, seed, STRETCH_STEPS // steps, eager, overlap, **kwargs)
    lap("stretches")
    copies = cache_sized_copies(model, seed)
    if copies["contiguous"] or copies["paged"] != {"index_select": 2 * cfg.n_layers}:
        raise AssertionError(f"cache-sized copies of one decode step: {copies}, want none "
                             f"contiguous and {2 * cfg.n_layers} gathers paged")
    lap("copies")
    del model
    torch.cuda.empty_cache()
    fp32 = fp32_check(seed, workload)
    lap("fp32")
    for name, r in runs.items():
        log(f"[serve {name}] {r['wall_s']:.3f} s wall, {r['tokens_out']} tokens out "
            f"({r['tokens_per_s']:.1f} tokens/s over the run), {r['ticks']} ticks; TTFT p50 "
            f"{r['ttft_ms_p50']} ms p95 {r['ttft_ms_p95']} ms; ITL p50 {r['itl_ms_p50']} ms p95 "
            f"{r['itl_ms_p95']} ms; host ms per tick p50 {r['host_ms_per_tick_p50']} p95 "
            f"{r['host_ms_per_tick_p95']} max {r['host_ms_per_tick_max']:.3f} (graph warm-up "
            f"and capture {r['graph_capture_s']:.3f} s); host dispatches per token "
            f"{r['host_dispatches_per_token']:.4f}; prefix hits {r['prefix_hits']} misses "
            f"{r['prefix_misses']}; prefill calls {r['prefill_calls']} (chunks "
            f"{r['prefill_chunks']}); unified ticks {r['unified_ticks']} carrying "
            f"{r['unified_chunks']} prefill chunks; peak memory {r['peak_memory_gib']:.2f} GiB; "
            f"graph captures {r['graph_captures']}; host overlap ratio {r['host_overlap_ratio']}")
        if "peak_blocks_in_use" in r:
            log(f"  paged: {r['slots']} slots over {r['n_blocks']} blocks of "
                f"{r['block_tokens']} tokens; peak blocks in use {r['peak_blocks_in_use']}; "
                f"copy-on-write copies {r['cow_copies']}; block-gate holds "
                f"{r['block_gate_holds']}; every block free at the end")
        d = r.get("decode_stretch")
        if d is None:
            continue
        log(f"  pure decode, 16 slots: {d['decode_tokens_per_s']:.1f} decode tokens/s; "
            f"profiled {d['profiled_tokens']} tokens: device busy {d['device_busy_ms']:.3f} ms "
            f"of {d['profiled_wall_ms']:.3f} ms (idle share {d['idle_share']:.3f}), "
            f"{d['device_ms_per_step']:.4f} device ms per decode step, "
            f"{d['kernel_launches_per_token']:.2f} kernel launches per token")
        for c in d["copies_per_step"]:
            log(f"    copy/gather per decode step: {c['launches_per_step']:6.2f} launches, "
                f"{c['ms_per_step']:.4f} ms, {c['us_per_launch']:7.2f} us each: {c['kernel']}")
        for key, count, ms in d["top_kernels_ms"]:
            log(f"    {ms:9.3f} ms {100 * ms / d['device_busy_ms']:5.1f}% x{count:<5d} {key}")
    log(f"[serve] cache-sized copies in one decode step at 16 slots: contiguous "
        f"{copies['contiguous']}, paged {copies['paged']}")
    log(f"[serve] greedy tokens of {len(greedy)} requests bitwise equal across per_step, "
        f"{', '.join(BITWISE_RUNS)}; paged_unified_graph_32slots: every request at its budget, "
        f"{same_32}/{len(greedy)} greedy requests equal per_step's; {SERVE_SAMPLED} sampled "
        f"requests in vocabulary; no flash launch; fp32 engine vs generate(): "
        f"{sum(r['equal'] for r in fp32)}/{len(fp32)} equal {fp32}")
    log("[serve] phase 7's parts, s: " + ", ".join(f"{k} {v:.1f}" for k, v in parts_s.items()))
    log(f"card: {smi}")
    # phase 10 compares its int8 runs' greedy tokens with these runs'
    greedy_tokens = {name: {r: runs[name]["tokens"][r] for r in greedy}
                     for name in ("fused_graph", "paged_unified_graph",
                                  "paged_unified_graph_32slots")}
    for r in runs.values():
        del r["tokens"]
    return dict(runs=runs, fp32=fp32, cache_sized_copies=copies), greedy_tokens



# phase 8: the hierarchical KV memory (GPT-2 125M, bf16, the seed of phase 7)
HIER_PROMPTS, HIER_PROMPT_LEN = 64, 512  # 16 blocks each: 1024 blocks, twice the pool
HIER_VISITS = 3
HIER_GROUP = 8  # prompts per group: first visits, then second visits (hits while resident)
HIER_LAG = 4  # third visits trail their group by 4 groups (512 blocks of other prompts)
HIER_SAMPLED = 16
HIER_BLOCK_TOKENS, HIER_POOL_BLOCKS = 32, 512
HIER_TREE_BLOCKS = 192  # the radix tree's device budget: 16 slots x 20 blocks + 192 = 512
HIER_REPLAY = 16
HIER_FP32_REQUESTS = 8
PINNED_PEAK_BYTES = 256 * 2**20
# the four runs: (name, engine kwargs); the disk run's directory is added
HIER_RUNS = (("paged_lru", dict(prefix_cache_size=4)),
             ("radix", dict(prefix_cache_size=HIER_TREE_BLOCKS, kv_radix_cache=True)),
             ("radix_host", dict(prefix_cache_size=HIER_TREE_BLOCKS, kv_host_blocks=1024)),
             ("radix_host_disk", dict(prefix_cache_size=HIER_TREE_BLOCKS, kv_host_blocks=256,
                                      kv_disk_blocks=1024)))


def hier_workload(seed, vocab):
    """192 requests from ``seed`` with numpy: 64 distinct 512-token system
    prompts, each visited three times, every visit the prompt plus a
    16-64-token suffix and 32-64 new tokens; 16 sampled (temperature 0.8,
    top_p 0.9), the rest greedy.  Order, by groups of 8 prompts: the group's
    first visits, its second visits (hits while resident), then the third
    visits of the group 4 back (after 32 other prompts, 512 blocks: evicted
    from the device), then the last groups' third visits.  Returns (prompt
    index, prompt, max_new_tokens, sampled) in arrival order."""
    import numpy as np

    rs = np.random.default_rng(seed)
    prompts = rs.integers(0, vocab, (HIER_PROMPTS, HIER_PROMPT_LEN)).tolist()
    groups = [list(range(g, g + HIER_GROUP)) for g in range(0, HIER_PROMPTS, HIER_GROUP)]
    order = []
    for g, members in enumerate(groups):
        order += members + members
        if g >= HIER_LAG:
            order += groups[g - HIER_LAG]
    for members in groups[len(groups) - HIER_LAG:]:
        order += members
    assert len(order) == HIER_PROMPTS * HIER_VISITS
    sampled = set(rs.choice(len(order), HIER_SAMPLED, replace=False).tolist())
    out = []
    for i, k in enumerate(order):
        suffix = rs.integers(0, vocab, int(rs.integers(16, 65))).tolist()
        out.append((k, prompts[k] + suffix, int(rs.integers(32, 65)), i in sampled))
    return out


def hier_engine(model, seed, **kwargs):
    """Phase 8's engine: phase 7's settings (16 slots, auto buckets, prefill
    batch 4, fused T=8 ticks replaying a CUDA graph) over 512 blocks of 32
    tokens, with monolithic prefill: under the unified tick a chunked
    prompt's prefix is never stored, in either package, so chunks would
    leave every prefix cache empty."""
    from tpu_parallel_torch.serving import SchedulerConfig, ServingEngine

    return ServingEngine(
        model, n_slots=SERVE_SLOTS, scheduler=SchedulerConfig(max_prefills_per_tick=4),
        rng=torch.Generator(device=model.device).manual_seed(seed), prefill_buckets="auto",
        prefill_batch=4, prefill_chunk_tokens=None, kv_block_tokens=HIER_BLOCK_TOKENS,
        kv_pool_blocks=HIER_POOL_BLOCKS, decode_steps_per_tick=8, **kwargs)


def _watch_exchange(eng):
    """Time the pool's exchange calls of a run: ``export_blocks`` (gathers,
    one device-to-host copy, the copy-out to numpy) and the device half of
    ``import_stored`` (packing into a pinned buffer, one host-to-device copy,
    the scatter), each between two synchronizes; the host seconds spent
    inside the radix tree's entry points (lookup with its restores, insert
    and the gate's evictions with their spills, checksums included); and
    the prompt tokens every lookup matched.  Returns a dict the run fills
    in."""
    seen = dict(export_bytes=0, export_s=0.0, export_calls=0, import_bytes=0, import_s=0.0,
                import_calls=0, matched_tokens=0, hierarchy_s=0.0)
    pool, lookup = eng.pool, eng._lookup_prefix
    export, write = pool.export_blocks, pool._write_blocks

    def timed_export(blocks):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = export(blocks)
        seen["export_s"] += time.perf_counter() - t0
        seen["export_bytes"] += sum(r.nbytes for r in rows)
        seen["export_calls"] += 1
        return rows

    def timed_write(rows, blocks):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        write(rows, blocks)
        torch.cuda.synchronize()
        seen["import_s"] += time.perf_counter() - t0
        seen["import_bytes"] += len(blocks) * pool.bytes_per_block
        seen["import_calls"] += 1

    def counted_lookup(prompt, reserve=0):
        hit = lookup(prompt, reserve=reserve)
        if hit is not None:
            seen["matched_tokens"] += hit[1]
        return hit

    def timed(fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                seen["hierarchy_s"] += time.perf_counter() - t0
        return call

    pool.export_blocks, pool._write_blocks, eng._lookup_prefix = (
        timed_export, timed_write, counted_lookup)
    radix = eng._radix
    if radix is not None:
        radix.lookup, radix.insert, radix.pop_lru = (
            timed(radix.lookup), timed(radix.insert), timed(radix.pop_lru))
    return seen


def _hier_requests(workload):
    from tpu_parallel_torch.serving import Request, SamplingParams

    return [Request(prompt=p, max_new_tokens=n, request_id=f"h{i}",
                    sampling=SamplingParams(temperature=0.8, top_p=0.9) if hot
                    else SamplingParams())
            for i, (_, p, n, hot) in enumerate(workload)]


def hier_run(model, workload, seed, **kwargs):
    """One run of phase 8's workload: 16 requests at tick 0, then 4 per tick,
    then ``run()`` to idle.  Returns (engine, outputs, wall seconds, peak
    memory, exchange counts)."""
    eng = hier_engine(model, seed, **kwargs)
    seen = _watch_exchange(eng)
    requests = _hier_requests(workload)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    outs = [eng.add_request(r) for r in requests[:SERVE_FIRST_TICK]]
    while len(outs) < len(requests):
        eng.step()
        outs += [eng.add_request(r) for r in requests[len(outs):len(outs) + SERVE_PER_TICK]]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    return eng, outs, wall, torch.cuda.max_memory_allocated(), seen


def _drain_blocks(name, eng):
    """A run's end: the allocator audit passes, and once the prefix cache
    lets go of its entries (aligned LRU: released; radix: evicted dry)
    every block is free."""
    pool = eng.pool
    pool.allocator.check()
    if eng._radix is not None:
        while eng._radix.pop_lru():
            pass
    else:
        for blocks, _ in list(eng._prefix.values()):
            pool.free_stored(blocks)
    pool.allocator.check()
    if pool.blocks_in_use or (pool.block_table >= 0).any():
        raise AssertionError(f"[kv {name}] {pool.blocks_in_use} blocks still in use")


def pinned_copy_peak():
    """Device-to-host and host-to-device rates of one 256 MB ``copy_``
    between a pinned host buffer and the device (CUDA events, mean of 5
    after a warm-up): the bound of the exchange copies."""
    dev = torch.empty(PINNED_PEAK_BYTES, dtype=torch.uint8, device="cuda")
    host = torch.empty(PINNED_PEAK_BYTES, dtype=torch.uint8, pin_memory=True)
    rates = {}
    for name, fn in (("d2h", lambda: host.copy_(dev, non_blocking=True)),
                     ("h2d", lambda: dev.copy_(host, non_blocking=True))):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            fn()
        end.record()
        end.synchronize()
        rates[name] = PINNED_PEAK_BYTES * 5 / (start.elapsed_time(end) / 1e3) / 1e9
    del dev, host
    return rates


def _single(eng, request):
    out = eng.add_request(request)
    eng.run()
    if out.status != "finished":
        raise AssertionError(f"[kv] {request.request_id} ended {out.status}")
    return out.tokens


def planted_fault(model, workload, seed):
    """Flip one byte of one host payload: the first block of a warm prompt
    spilled to the host tier.  Its revisit must refuse the restore typed
    (one integrity failure, no block restored), recompute, and give exactly
    the tokens its cold first visit gave."""
    from tpu_parallel_torch.serving import Request

    eng = hier_engine(model, seed, prefix_cache_size=HIER_TREE_BLOCKS, kv_host_blocks=256)
    _, prompt, n, _ = next(w for w in workload if not w[3])
    want = _single(eng, Request(prompt=prompt, max_new_tokens=n, request_id="f0"))
    _single(eng, Request(prompt=prompt, max_new_tokens=4, request_id="f1"))  # a hit: warm
    radix = eng._radix
    node = radix._root.children.get(tuple(prompt[:HIER_BLOCK_TOKENS]))
    while node.block is not None and radix.pop_lru():  # the warm chain spills, deepest first
        pass
    if node.host is None:
        raise AssertionError("[kv fault] the prompt's first block was not spilled to host")
    node.host[0].view("u1").flat[7] ^= 0x10
    restored = radix.restored_blocks
    got = _single(eng, Request(prompt=prompt, max_new_tokens=n, request_id="f2"))
    if radix.integrity_failures != 1 or radix.restored_blocks != restored:
        raise AssertionError(f"[kv fault] integrity failures {radix.integrity_failures}, "
                             f"restored {radix.restored_blocks - restored} blocks; want 1 and 0")
    if got != want:
        raise AssertionError("[kv fault] the recomputed request's tokens differ from its cold run")
    _drain_blocks("fault", eng)
    return dict(integrity_failures=radix.integrity_failures,
                restore_failures=radix.restore_failures, tokens=len(got), equal=True)


def hier_fp32_leg(seed, workload):
    """The weights in fp32 (TF32 off): 8 greedy requests over three prompts
    (a, a, b, b, c, c, a, b), one at a time through a tight hierarchy (a
    2-prompt device budget over a host tier) that must spill warm blocks
    and restore them, against the same engine without the hierarchy.  A differing token passes only
    on a near-tie: the reference's top-2 logit gap there below
    FP32_TIE_GAP."""
    from tpu_parallel_torch.models import GPTLM, gpt2_125m
    from tpu_parallel_torch.serving import Request

    model = GPTLM(gpt2_125m(dtype=torch.float32), device="cuda", seed=seed).eval()
    seen, picked = set(), []
    for k, p, n, hot in workload:
        if not hot and k not in seen and len(seen) < 3:
            seen.add(k)
            picked.append((k, p, n))
    a, b, c = picked
    order = [a, a, b, b, c, c, a, b]
    assert len(order) == HIER_FP32_REQUESTS
    budget = 2 * HIER_PROMPT_LEN // HIER_BLOCK_TOKENS
    with_tiers = hier_engine(model, seed, prefix_cache_size=budget, kv_host_blocks=256)
    plain = hier_engine(model, seed, prefix_cache_size=4)
    report = []
    for i, (k, p, n) in enumerate(order):
        got = _single(with_tiers, Request(prompt=p, max_new_tokens=n, request_id=f"t{i}"))
        want = _single(plain, Request(prompt=p, max_new_tokens=n, request_id=f"p{i}"))
        if got == want:
            report.append(dict(request=i, prompt=k, equal=True))
            continue
        step = next(j for j, (x, y) in enumerate(zip(got, want)) if x != y)
        with torch.inference_mode():
            top2 = model(torch.tensor([p + want[:step]], device="cuda"))[0, -1].float().topk(2)
        gap = (top2.values[0] - top2.values[1]).item()
        report.append(dict(request=i, prompt=k, equal=False, first_diff=step, top2_gap=gap))
        if gap >= FP32_TIE_GAP:
            raise AssertionError(f"[kv fp32] request {i} differs from the engine without the "
                                 f"hierarchy at token {step}, top-2 gap {gap:.3e}")
    radix = with_tiers._radix
    if radix.offloads == 0 or radix.restored_blocks == 0:
        raise AssertionError(f"[kv fp32] no spill and restore: offloads {radix.offloads}, "
                             f"restored {radix.restored_blocks}")
    counts = dict(offloads=radix.offloads, restored_blocks=radix.restored_blocks,
                  hits=radix.hits)
    del model, with_tiers, plain
    gc.collect()
    torch.cuda.empty_cache()
    return report, counts


def export_across_engines(model, workload, seed):
    """Export -> wire -> import between two engines on the card.  Engine A
    serves a request; after its first tick A exports its written full
    blocks (the prompt's), the export goes through ``encode_export`` /
    ``decode_export`` and engine B imports it (``"imported"``).  Then the
    forced-prefix continuation (prompt + delivered tokens) runs on B, which
    hits the imported blocks, and on A, which hits its own: B's
    continuation must equal A's."""
    from tpu_parallel_torch.serving import Request, decode_export, encode_export

    kw = dict(prefix_cache_size=HIER_TREE_BLOCKS, kv_radix_cache=True)
    a, b = hier_engine(model, seed, **kw), hier_engine(model, seed, **kw)
    k, prompt, n, _ = next(w for w in workload if not w[3])
    prompt = prompt[:HIER_PROMPT_LEN + 16]  # + 8 tokens of the first tick stay in block 16
    out = a.add_request(Request(prompt=prompt, max_new_tokens=n, request_id="x"))
    a.step()
    export = a.export_prefix("x")
    if export is None or export.n_blocks != HIER_PROMPT_LEN // HIER_BLOCK_TOKENS:
        raise AssertionError(f"[kv export] export of {export and export.n_blocks} blocks")
    frame = encode_export(export)
    verdict = b.import_prefix(decode_export(frame))
    if verdict != "imported":
        raise AssertionError(f"[kv export] import verdict {verdict}")
    delivered = list(out.tokens)
    a.run()
    cont = dict(prompt=prompt + delivered, max_new_tokens=n - len(delivered))
    hits_b = b._radix.hits
    got = _single(b, Request(request_id="cb", **cont))
    want = _single(a, Request(request_id="ca", **cont))
    if b._radix.hits != hits_b + 1 or got != want:
        raise AssertionError(f"[kv export] engine B's continuation (hit {b._radix.hits - hits_b}) "
                             "differs from engine A's")
    return dict(blocks=export.n_blocks, frame_bytes=len(frame), delivered=len(delivered),
                continuation_tokens=len(got), equal=True,
                equal_to_uninterrupted=delivered + got == out.tokens)


def hier_phase(seed, smi):
    """Phase 8: the hierarchical KV memory on GPT-2 125M (bf16, seeded
    weights, 16 slots over 512 blocks of 32 tokens) over 192 requests that
    revisit 64 distinct 512-token system prompts, run four times
    (``HIER_RUNS``), then a warm restart on the disk run's directory, a
    planted integrity fault, an fp32 leg and an export -> wire -> import
    between two engines.  Every request finishes at its budget, no restore
    or integrity failure, every block returned, no flash launch."""
    import tempfile

    from tpu_parallel_torch.models import GPTLM, gpt2_125m
    from tpu_parallel_torch.ops import flash_attention as fa

    gc.collect()  # garbage of earlier phases would count in the first run's peak
    torch.cuda.empty_cache()
    cfg = gpt2_125m()
    model = GPTLM(cfg, device="cuda", seed=seed).eval()
    workload = hier_workload(seed, cfg.vocab_size)
    flash_before = [getattr(fa, name) for name in LAUNCH_COUNTERS]
    peak = pinned_copy_peak()
    disk_dir = tempfile.mkdtemp(prefix="kv_disk_")
    runs, tokens = {}, {}
    try:
        for name, kwargs in HIER_RUNS:
            if "kv_disk_blocks" in kwargs:
                kwargs = dict(kwargs, kv_disk_dir=disk_dir)
            eng, outs, wall, mem, seen = hier_run(model, workload, seed, **kwargs)
            s = eng.metrics.summary()
            bad = [o.request.request_id for o in outs if o.status != "finished"
                   or len(o.tokens) != o.request.max_new_tokens]
            if bad:
                raise AssertionError(f"[kv {name}] requests not finished at their budget: {bad}")
            radix = eng._radix
            counts = {c: getattr(radix, c, 0) if radix is not None else 0 for c in (
                "offloads", "restored_blocks", "host_evictions", "restore_failures",
                "integrity_failures", "disk_spills", "disk_restores", "disk_restore_failures")}
            if counts["restore_failures"] or counts["integrity_failures"] or counts[
                    "disk_restore_failures"]:
                raise AssertionError(f"[kv {name}] restore or integrity failures: {counts}")
            prompt_tokens = sum(len(o.request.prompt) for o in outs)
            runs[name] = dict(
                wall_s=wall, tokens_out=s["tokens_out"], tokens_per_s=s["tokens_out"] / wall,
                ttft_ms_p50=s["ttft_ms_p50"], ttft_ms_p95=s["ttft_ms_p95"],
                itl_ms_p95=s["itl_ms_p95"], prefix_hit_rate=s["prefix_hit_rate"],
                ticks=s["ticks"], prefill_calls=s["prefill_calls"], prompt_tokens=prompt_tokens,
                prompt_tokens_prefilled=prompt_tokens - seen["matched_tokens"],
                peak_memory_gib=mem / 2**30, graph_captures=eng.graph_captures, **counts,
                export_calls=seen["export_calls"], import_calls=seen["import_calls"],
                export_gb_per_s=(seen["export_bytes"] / seen["export_s"] / 1e9
                                 if seen["export_calls"] else None),
                import_gb_per_s=(seen["import_bytes"] / seen["import_s"] / 1e9
                                 if seen["import_calls"] else None),
                export_bytes=seen["export_bytes"], import_bytes=seen["import_bytes"],
                export_s=seen["export_s"], import_s=seen["import_s"],
                hierarchy_host_s=seen["hierarchy_s"])
            tokens[name] = {o.request.request_id: o.tokens for o in outs}
            _drain_blocks(name, eng)
            if radix is not None and radix.disk is not None:
                radix.disk.close()  # the restart below reopens the directory
            del eng
            gc.collect()
            torch.cuda.empty_cache()
        # a fresh engine boots warm on the disk run's directory and replays
        # the third visits of the 16 prompts whose chains sit deepest on disk
        restart = hier_engine(model, seed, **dict(HIER_RUNS[3][1], kv_disk_dir=disk_dir))
        radix = restart._radix
        if radix.disk_seeded_blocks == 0:
            raise AssertionError("[kv restart] the manifest seeded no block")
        on_disk = {tuple(n.run) for n in radix._root.children.values() if n.disk is not None}
        replay = [(i, w) for i, w in enumerate(workload)
                  if tuple(w[1][:HIER_BLOCK_TOKENS]) in on_disk and not w[3]][-HIER_REPLAY:]
        requests = _hier_requests(workload)
        outs = [restart.add_request(requests[i]) for i, _ in replay]
        restart.step()
        first_hits, first_disk = radix.hits, radix.disk_restores
        restart.run()
        if not first_hits or not first_disk:
            raise AssertionError(f"[kv restart] first lookups: {first_hits} hits, {first_disk} "
                                 "disk restores")
        if any(o.status != "finished" for o in outs) or radix.disk_restore_failures:
            raise AssertionError("[kv restart] replay failed")
        restart_report = dict(
            seeded_blocks=radix.disk_seeded_blocks, seeded_chains=radix.disk_seeded_chains,
            replayed=len(outs), first_tick_hits=first_hits, first_tick_disk_restores=first_disk,
            hits=radix.hits, disk_restores=radix.disk_restores,
            equal_to_disk_run=sum(o.tokens == tokens["radix_host_disk"][o.request.request_id]
                                  for o in outs))
        radix.disk.close()
        _drain_blocks("restart", restart)
        del restart
    finally:
        import shutil

        shutil.rmtree(disk_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    fault = planted_fault(model, workload, seed)
    exchange = export_across_engines(model, workload, seed)
    moved = [getattr(fa, name) - n for name, n in zip(LAUNCH_COUNTERS, flash_before)]
    if any(moved):
        raise AssertionError(f"the hierarchy path launched flash kernels: {moved}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    fp32, fp32_counts = hier_fp32_leg(seed, workload)
    greedy = [f"h{i}" for i, w in enumerate(workload) if not w[3]]
    for name, r in runs.items():
        r["greedy_equal_to_paged_lru"] = sum(tokens[name][g] == tokens["paged_lru"][g]
                                             for g in greedy)
        log(f"[kv {name}] {r['wall_s']:.3f} s wall, {r['tokens_out']} tokens out "
            f"({r['tokens_per_s']:.1f} tokens/s); TTFT p50 {r['ttft_ms_p50']} ms p95 "
            f"{r['ttft_ms_p95']} ms; ITL p95 {r['itl_ms_p95']} ms; {r['ticks']} ticks, "
            f"{r['prefill_calls']} prefill calls; prefix hit rate {r['prefix_hit_rate']:.4f}; "
            f"prompt tokens prefilled {r['prompt_tokens_prefilled']} of {r['prompt_tokens']}; offloads {r['offloads']}, restored blocks "
            f"{r['restored_blocks']}, host evictions {r['host_evictions']}, disk spills "
            f"{r['disk_spills']}, disk restores {r['disk_restores']}; peak memory "
            f"{r['peak_memory_gib']:.2f} GiB; graph captures {r['graph_captures']}; "
            f"greedy requests equal to paged_lru's {r['greedy_equal_to_paged_lru']}/{len(greedy)}; "
            f"host s inside the radix tree {r['hierarchy_host_s']:.3f} (export_blocks "
            f"{r['export_s']:.3f}, import_stored's copy {r['import_s']:.3f})")
        if r["export_calls"] or r["import_calls"]:
            fmt = lambda x: "n/a" if x is None else f"{x:.3f}"  # noqa: E731
            log(f"  export_blocks: {r['export_calls']} calls, {r['export_bytes'] / 1e9:.3f} GB, "
                f"{fmt(r['export_gb_per_s'])} GB/s device-to-host (pinned copy_ peak "
                f"{peak['d2h']:.3f} GB/s); import_stored: {r['import_calls']} calls, "
                f"{r['import_bytes'] / 1e9:.3f} GB, {fmt(r['import_gb_per_s'])} GB/s "
                f"host-to-device (pinned copy_ peak {peak['h2d']:.3f} GB/s)")
    log(f"[kv restart] {restart_report}")
    log(f"[kv fault] one flipped byte in a host payload: {fault}")
    log(f"[kv export] engine A -> wire -> engine B: {exchange}")
    log(f"[kv fp32] hierarchy vs none, 8 greedy requests: "
        f"{sum(r['equal'] for r in fp32)}/{len(fp32)} equal; {fp32_counts}; {fp32}")
    log(f"[kv] pinned copy_ of 256 MB: {peak}; card: {smi}")
    return dict(runs=runs, restart=restart_report, fault=fault, export=exchange, fp32=fp32,
                fp32_counts=fp32_counts, pinned_copy_gb_per_s=peak)


# phase 9: speculative decoding (GPT-2 125M, bf16, the seed of phase 7)
# 24 requests (32 until phase 18 needed the run's time)
SPEC_REQUESTS, SPEC_SAMPLED, SPEC_MOTIF = 24, 4, 32
SPEC_DRAFT = 4  # draft tokens: verify blocks of [16 slots, 5]
SPEC_FUSED_STEPS = 4
SPEC_BLOCK_TOKENS, SPEC_POOL_BLOCKS = 32, 512
SPEC_FP32_REQUESTS = 8
SPEC_STRETCH_STEPS = 8  # decode (verify) steps per measured and per profiled window


class OracleDrafter:
    """Drafts the true greedy continuation (a copy of the test suite's
    oracle): maximal acceptance."""

    def __init__(self, refs):
        self.refs = refs

    def draft(self, context, k):
        for prompt, ref in self.refs.items():
            if tuple(context[: len(prompt)]) == prompt:
                idx = len(context) - len(prompt)
                return [int(t) for t in ref[idx: idx + k]]
        return []


class AntiOracleDrafter:
    """Drafts something other than the true greedy next token (a copy of
    the test suite's anti-oracle): acceptance exactly 0, output unchanged."""

    def __init__(self, refs, vocab):
        self.refs = refs
        self.vocab = vocab

    def draft(self, context, k):
        for prompt, ref in self.refs.items():
            if tuple(context[: len(prompt)]) == prompt:
                idx = len(context) - len(prompt)
                truth = ref[idx] if idx < len(ref) else 0
                return [(int(truth) + 1) % self.vocab] * k
        return [0] * k


# the runs: (name, engine kwargs, drafter).  (a) the non-spec engine at its
# defaults; (b) per-step ticks with the host n-gram drafter; (c) fused ticks
# of 4 verify blocks drafting on the device, one CUDA graph per variant;
# (d) the same over 512 blocks of 32 tokens; (e) the same with chunks of 256
# folded in (the unified spec graph); (f) and (g) per-step with the oracle
# and the anti-oracle (no adaptation) keyed on (b)'s greedy tokens
SPEC = dict(draft_tokens=SPEC_DRAFT)
SPEC_FUSED = dict(SPEC, decode_steps_per_tick=SPEC_FUSED_STEPS)
SPEC_RUNS = (
    ("plain", {}, None),
    ("spec_step_ngram", SPEC, None),
    ("spec_fused_ngram", SPEC_FUSED, None),
    ("spec_fused_paged", dict(SPEC_FUSED, kv_block_tokens=SPEC_BLOCK_TOKENS,
                              kv_pool_blocks=SPEC_POOL_BLOCKS), None),
    ("spec_unified_chunked", dict(SPEC_FUSED, prefill_chunk_tokens=256), None),
    ("spec_step_oracle", SPEC, "oracle"),
    ("spec_step_anti", dict(SPEC, spec_adaptive=False), "anti"),
)
# the graph kinds each run must replay (each captured once); the rest none
SPEC_GRAPH_KINDS = dict(plain=("fused",), spec_fused_ngram=("spec_fused",),
                        spec_fused_paged=("spec_fused",),
                        spec_unified_chunked=("spec_fused", "spec_unified"))


def spec_workload(seed, vocab):
    """SPEC_REQUESTS requests from ``seed`` with numpy: prompts of 64-512 tokens, half
    of them a 32-token motif of their own repeated (the traffic of code
    edits and of answers that quote their prompt, where the n-gram drafter
    finds matches), 64-128 new tokens, 28 greedy and 4 sampled
    (temperature 0.8, top_p 0.9).  Returns (prompt, max_new_tokens, sampled)
    triples in arrival order."""
    import numpy as np

    rs = np.random.default_rng(seed + 9)
    lengths = rs.integers(64, 513, SPEC_REQUESTS)
    budgets = rs.integers(64, 129, SPEC_REQUESTS)
    motif = set(rs.choice(SPEC_REQUESTS, SPEC_REQUESTS // 2, replace=False).tolist())
    sampled = set(rs.choice(SPEC_REQUESTS, SPEC_SAMPLED, replace=False).tolist())
    out = []
    for i in range(SPEC_REQUESTS):
        n = int(lengths[i])
        if i in motif:
            m = rs.integers(0, vocab, SPEC_MOTIF).tolist()
            prompt = (m * (n // SPEC_MOTIF + 1))[:n]
        else:
            prompt = rs.integers(0, vocab, n).tolist()
        out.append((prompt, int(budgets[i]), i in sampled))
    return out


def spec_engine(model, seed, drafter=None, **kwargs):
    from tpu_parallel_torch.serving import SchedulerConfig, ServingEngine

    kwargs = {"n_slots": SERVE_SLOTS, **kwargs}
    return ServingEngine(
        model, scheduler=SchedulerConfig(max_prefills_per_tick=4),
        rng=torch.Generator(device=model.device).manual_seed(seed), prefill_buckets="auto",
        prefill_batch=4, drafter=drafter, **kwargs)


def _watch_kinds(eng):
    """Record the kinds of tick body an engine runs through ``_replay``."""
    kinds, replay = set(), eng._replay

    def counted(kind, body):
        kinds.add(kind)
        return replay(kind, body)

    eng._replay = counted
    return kinds


def spec_run(model, workload, seed, drafter=None, **kwargs):
    """One run of phase 9's workload: 16 requests at tick 0, then 4 per
    tick, then ``run()`` to idle.  Returns (engine, outputs, wall seconds,
    peak memory, tick kinds replayed)."""
    from tpu_parallel_torch.serving import Request, SamplingParams

    eng = spec_engine(model, seed, drafter, **kwargs)
    kinds = _watch_kinds(eng)
    requests = [
        Request(prompt=p, max_new_tokens=n, request_id=f"s{i}",
                sampling=SamplingParams(temperature=0.8, top_p=0.9) if hot else SamplingParams())
        for i, (p, n, hot) in enumerate(workload)
    ]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    outs = [eng.add_request(r) for r in requests[:SERVE_FIRST_TICK]]
    while len(outs) < len(requests):
        eng.step()
        outs += [eng.add_request(r) for r in requests[len(outs):len(outs) + SERVE_PER_TICK]]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    return eng, outs, wall, torch.cuda.max_memory_allocated(), kinds


def spec_stretch(model, seed, steps, name, refs=None, drafter=None, **kwargs):
    """A profiled stretch of pure-decode ticks at 16 slots (prompts of 64
    random tokens, 400 new each): one warm tick, a timed window and a
    profiled window of SPEC_STRETCH_STEPS decode (or verify) steps each.
    Returns tokens/s, device ms per step, tokens per step per slot, device
    ms per token, the idle share and kernel launches per token; with
    ``refs`` (a dict) the engine then runs to idle and leaves each prompt's
    greedy tokens in it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpu_parallel_torch.serving import Request

    gen = torch.Generator().manual_seed(seed)
    prompts = [torch.randint(0, model.config.vocab_size, (64,), generator=gen).tolist()
               for _ in range(SERVE_SLOTS)]
    if drafter == "oracle":
        drafter = OracleDrafter(refs)
    eng = spec_engine(model, seed, drafter, decode_steps_per_tick=steps, **kwargs)
    outs = [eng.add_request(Request(prompt=p, max_new_tokens=400, request_id=f"d{i}"))
            for i, p in enumerate(prompts)]
    while eng.scheduler.depth or eng.in_flight < SERVE_SLOTS:
        eng.step()
    eng.step()  # a fused tick captures its graph
    ticks = SPEC_STRETCH_STEPS // steps
    torch.cuda.synchronize()
    before = eng.metrics.tokens_out
    start = time.perf_counter()
    eng.run(max_ticks=ticks)
    torch.cuda.synchronize()
    tps = (eng.metrics.tokens_out - before) / (time.perf_counter() - start)
    before = eng.metrics.tokens_out
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        eng.run(max_ticks=ticks)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - start) * 1e6
    tokens = eng.metrics.tokens_out - before
    if eng.in_flight != SERVE_SLOTS:
        raise AssertionError(f"[spec stretch {name}] a slot finished inside the stretch")
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    n_steps = ticks * steps
    top = [(e.key[:100], e.count, e.self_device_time_total / 1e3)
           for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]]
    if refs is not None:
        eng.run()
        refs.update({tuple(p): o.tokens for p, o in zip(prompts, outs)})
    return dict(tokens_per_s=tps, device_ms_per_step=busy_us / 1e3 / n_steps,
                tokens_per_step_per_slot=tokens / (n_steps * SERVE_SLOTS),
                device_ms_per_token=busy_us / 1e3 / max(tokens, 1),
                idle_share=1 - busy_us / wall_us, kernel_launches_per_token=sum(
                    e.count for e in events) / max(tokens, 1), profiled_tokens=tokens,
                steps=n_steps, top_kernels_ms=top)


def spec_fp32_leg(seed, workload):
    """The weights in fp32 (TF32 off): 8 greedy requests through the fused
    spec engine (run (c): 4 verify blocks per tick, one graph per variant)
    against the non-spec engine at its defaults.  A differing token passes
    only on a near-tie: the reference's top-2 logit gap there below
    FP32_TIE_GAP."""
    from tpu_parallel_torch.models import GPTLM, gpt2_125m
    from tpu_parallel_torch.serving import Request

    model = GPTLM(gpt2_125m(dtype=torch.float32), device="cuda", seed=seed).eval()
    picked = [(i, p, n) for i, (p, n, hot) in enumerate(workload) if not hot][:SPEC_FP32_REQUESTS]
    results = []
    for kwargs in (SPEC_FUSED, {}):
        eng = spec_engine(model, seed, **kwargs)
        outs = [eng.add_request(Request(prompt=p, max_new_tokens=n, request_id=f"f{i}"))
                for i, p, n in picked]
        eng.run()
        results.append([o.tokens for o in outs])
        if kwargs:
            accepted = eng.metrics.tokens_accepted
        del eng
    report = []
    for (i, p, n), got, want in zip(picked, *results):
        if got == want:
            report.append(dict(request=i, tokens=n, equal=True))
            continue
        step = next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)
        with torch.inference_mode():
            top2 = model(torch.tensor([p + want[:step]], device="cuda"))[0, -1].float().topk(2)
        gap = (top2.values[0] - top2.values[1]).item()
        report.append(dict(request=i, tokens=n, equal=False, first_diff=step, top2_gap=gap))
        if gap >= FP32_TIE_GAP:
            raise AssertionError(f"[spec fp32] request s{i} differs from the non-spec engine at "
                                 f"token {step} with top-2 gap {gap:.3e} >= {FP32_TIE_GAP}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return report, accepted


def spec_phase(seed, smi):
    """Phase 9: speculative decoding on GPT-2 125M (bf16, seeded weights,
    16 slots, auto buckets, prefill batch 4, 4 draft tokens) over one
    32-request workload, run as ``SPEC_RUNS`` lists.  Every request
    finishes at its budget; greedy tokens bitwise equal across the six spec
    runs (one verify width); the anti-oracle accepts nothing; the oracle
    takes fewer decode ticks than the n-gram run; each run replays its
    graph kinds, each captured once; every paged block returns; no flash
    launch.  Then pure-decode stretches and the fp32 leg."""
    from tpu_parallel_torch.models import GPTLM, gpt2_125m
    from tpu_parallel_torch.ops import flash_attention as fa

    start, parts_s = time.perf_counter(), {}

    def lap(name):
        parts_s[name] = time.perf_counter() - start - sum(parts_s.values())

    cfg = gpt2_125m()
    model = GPTLM(cfg, device="cuda", seed=seed).eval()
    workload = spec_workload(seed, cfg.vocab_size)
    greedy = [f"s{i}" for i, (_, _, hot) in enumerate(workload) if not hot]
    flash_before = [getattr(fa, name) for name in LAUNCH_COUNTERS]
    runs, refs = {}, {}
    for name, kwargs, drafter in SPEC_RUNS:
        if drafter == "oracle":
            drafter = OracleDrafter(refs)
        elif drafter == "anti":
            drafter = AntiOracleDrafter(refs, cfg.vocab_size)
        eng, outs, wall, peak, kinds = spec_run(model, workload, seed, drafter, **kwargs)
        s = eng.metrics.summary()
        bad = [o.request.request_id for o in outs if o.status != "finished"
               or len(o.tokens) != o.request.max_new_tokens]
        if bad:
            raise AssertionError(f"[spec {name}] requests not finished at their budget: {bad}")
        for o in outs:
            if min(o.tokens) < 0 or max(o.tokens) >= cfg.vocab_size:
                raise AssertionError(f"[spec {name}] {o.request.request_id} tokens out of range")
        want_kinds = SPEC_GRAPH_KINDS.get(name, ())
        if {k.replace("_sampled", "") for k in kinds} != set(want_kinds):
            raise AssertionError(f"[spec {name}] replayed tick kinds {sorted(kinds)}, want the "
                                 f"families {want_kinds}")
        if eng.graph_captures != (len(kinds) if want_kinds else 0):
            raise AssertionError(f"[spec {name}] {eng.graph_captures} graph captures for the "
                                 f"kinds {sorted(kinds)}")
        if eng._paged:
            pool = eng.pool
            pool.allocator.check()
            if pool.blocks_in_use or (pool.block_table >= 0).any():
                raise AssertionError(f"[spec {name}] {pool.blocks_in_use} blocks still in use")
        if name == "spec_step_ngram":
            refs.update({tuple(o.request.prompt): list(o.tokens) for o in outs
                         if o.request.request_id in greedy})
        verify_blocks = eng.metrics.spec_slot_ticks
        runs[name] = dict(
            tokens={o.request.request_id: o.tokens for o in outs},
            wall_s=wall, tokens_out=s["tokens_out"], tokens_per_s=s["tokens_out"] / wall,
            ttft_ms_p50=s["ttft_ms_p50"], ttft_ms_p95=s["ttft_ms_p95"],
            itl_ms_p50=s["itl_ms_p50"], itl_ms_p95=s["itl_ms_p95"],
            decode_ticks=s["decode_ticks"], ticks=s["ticks"],
            tokens_drafted=s["tokens_drafted"], tokens_accepted=s["tokens_accepted"],
            acceptance_rate=s["spec_acceptance_rate"],
            tokens_per_verify=((s["tokens_out"] - len(outs)) / verify_blocks if verify_blocks
                               else None),
            wasted_verify_positions=s["spec_wasted_positions"],
            host_dispatches_per_token=s["host_dispatches"] / s["tokens_out"],
            peak_memory_gib=peak / 2**30, graph_captures=eng.graph_captures,
            kinds=sorted(kinds),
        )
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    spec_names = [name for name, _, _ in SPEC_RUNS if name != "plain"]
    base = runs["spec_step_ngram"]["tokens"]
    for name in spec_names:
        differ = [r for r in greedy if runs[name]["tokens"][r] != base[r]]
        if differ:
            r = differ[0]
            step = next(j for j, (x, y) in enumerate(zip(base[r], runs[name]["tokens"][r]))
                        if x != y)
            raise AssertionError(f"[spec] greedy tokens of {len(differ)} requests differ between "
                                 f"spec_step_ngram and {name} (first: {r} at token {step})")
        runs[name]["greedy_equal_to_plain"] = sum(
            runs[name]["tokens"][r] == runs["plain"]["tokens"][r] for r in greedy)
    anti, oracle = runs["spec_step_anti"], runs["spec_step_oracle"]
    if anti["tokens_accepted"] != 0 or anti["tokens_drafted"] == 0:
        raise AssertionError(f"[spec] the anti-oracle accepted {anti['tokens_accepted']} of "
                             f"{anti['tokens_drafted']} drafts, want 0 of > 0")
    if not oracle["decode_ticks"] < runs["spec_step_ngram"]["decode_ticks"]:
        raise AssertionError(f"[spec] the oracle took {oracle['decode_ticks']} decode ticks, the "
                             f"n-gram run {runs['spec_step_ngram']['decode_ticks']}")
    moved = [getattr(fa, name) - n for name, n in zip(LAUNCH_COUNTERS, flash_before)]
    if any(moved):
        raise AssertionError(f"the spec path launched flash kernels: {moved}")
    # pure decode at 16 slots: [16, 1] decode steps against [16, 5] verify
    # steps; the plain fused stretch's greedy tokens key the oracle's
    lap("runs")
    stretch_refs = {}
    stretches = {
        "decode_step": spec_stretch(model, seed, 1, "decode_step"),
        "plain_fused_graph": spec_stretch(model, seed, 8, "plain_fused_graph",
                                          refs=stretch_refs),
        "verify_step_ngram": spec_stretch(model, seed, 1, "verify_step_ngram", **SPEC),
        "verify_fused_ngram_graph": spec_stretch(model, seed, SPEC_FUSED_STEPS,
                                                 "verify_fused_ngram_graph", **SPEC),
    }
    stretches["verify_step_oracle"] = spec_stretch(model, seed, 1, "verify_step_oracle",
                                                   refs=stretch_refs, drafter="oracle", **SPEC)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    lap("stretches")
    fp32, fp32_accepted = spec_fp32_leg(seed, workload)
    lap("fp32")
    for name, r in runs.items():
        tpv = r["tokens_per_verify"]
        log(f"[spec {name}] {r['wall_s']:.3f} s wall, {r['tokens_out']} tokens out "
            f"({r['tokens_per_s']:.1f} tokens/s); TTFT p50 {r['ttft_ms_p50']} ms p95 "
            f"{r['ttft_ms_p95']} ms; ITL p50 {r['itl_ms_p50']} ms p95 {r['itl_ms_p95']} ms; "
            f"{r['decode_ticks']} decode ticks of {r['ticks']}; drafted {r['tokens_drafted']}, "
            f"accepted {r['tokens_accepted']} (rate {r['acceptance_rate']}); tokens per verify "
            f"{'n/a' if tpv is None else f'{tpv:.3f}'}; wasted verify positions "
            f"{r['wasted_verify_positions']}; host dispatches per token "
            f"{r['host_dispatches_per_token']:.4f}; peak memory {r['peak_memory_gib']:.2f} GiB; "
            f"graph captures {r['graph_captures']} {r['kinds']}; greedy requests equal to plain: "
            f"{r.get('greedy_equal_to_plain', len(greedy))}/{len(greedy)}")
    for name, d in stretches.items():
        log(f"[spec stretch {name}] 16 slots: {d['tokens_per_s']:.1f} tokens/s; "
            f"{d['device_ms_per_step']:.4f} device ms per step, "
            f"{d['tokens_per_step_per_slot']:.3f} tokens per step per slot, "
            f"{d['device_ms_per_token']:.4f} device ms per token; idle share "
            f"{d['idle_share']:.3f}; {d['kernel_launches_per_token']:.2f} kernel launches per "
            f"token ({d['profiled_tokens']} tokens over {d['steps']} steps)")
        for key, count, ms in d["top_kernels_ms"]:
            log(f"    {ms:9.3f} ms x{count:<5d} {key}")
    ratio = (stretches["verify_step_ngram"]["device_ms_per_step"]
             / stretches["decode_step"]["device_ms_per_step"])
    log(f"[spec] device ms per verify step [16, {SPEC_DRAFT + 1}] / per decode step [16, 1]: "
        f"{ratio:.3f}")
    log(f"[spec] greedy tokens of {len(greedy)} requests bitwise equal across "
        f"{', '.join(spec_names)}; anti-oracle acceptance 0; oracle {oracle['decode_ticks']} "
        f"decode ticks against the n-gram run's {runs['spec_step_ngram']['decode_ticks']}; no "
        f"flash launch; fp32 spec vs non-spec engine: {sum(r['equal'] for r in fp32)}/"
        f"{len(fp32)} equal ({fp32_accepted} drafts accepted) {fp32}")
    log("[spec] phase 9's parts, s: " + ", ".join(f"{k} {v:.1f}" for k, v in parts_s.items()))
    log(f"card: {smi}")
    # phase 10 compares its int8 spec run's greedy tokens with run (c)'s
    greedy_tokens = {r: runs["spec_fused_ngram"]["tokens"][r] for r in greedy}
    for r in runs.values():
        del r["tokens"]
    return (dict(runs=runs, stretches=stretches, verify_over_decode_device_ms=ratio, fp32=fp32),
            greedy_tokens)


# phase 10: decode extras on GPT-2 125M (the seed of phase 7): the int8 KV
# cache through the engine and speculative decoding, beam search, and
# weight-only int8 export
INT8 = dict(kv_cache_dtype="int8")
# the int8 engine's runs over phase 7's workload: (name, decode steps per
# tick, engine kwargs, the phase 7 run whose greedy tokens it is printed
# beside).  The last is the paged pool in the bf16 pool's KV bytes: 960
# int8 blocks of 32 tokens take what 512 bf16 ones do, under 32 slots
INT8_RUNS = (
    ("int8_fused_graph", 8, PER_PHASE, "fused_graph"),
    ("int8_paged_unified_graph", 8, PAGED, "paged_unified_graph"),
    ("int8_paged_unified_graph_32slots", 8,
     dict(PAGED, n_slots=2 * SERVE_SLOTS, kv_pool_blocks=960), "paged_unified_graph_32slots"),
)
INT8_CAPTURES = dict(int8_fused_graph=1, int8_paged_unified_graph=2)
# the int8 fp32 leg's near-tie.  The engine's GEMMs (16 slots) and static
# generate()'s (batch 1) round fp32 K and V differently in the last bit;
# an element on a .5 boundary of its int8 grid then moves by one step
# (max|k| / 127, about 0.02, in one element of one head: about 1e-3 in
# the logits), and deeper layers, which read the moved cache, compound it.
# A differing token passes below ten such steps, or below twice what
# prefilling the context at batch 16 instead of 1 moves its logits by
# (``_int8_shape_noise``), whichever is larger.
INT8_TIE_GAP = 1e-2
# 32 new tokens (128, then 64, until the whole run neared its time limit)
BEAM_PROMPTS, BEAM_PROMPT_LEN, BEAM_WIDTH, BEAM_NEW = 4, 256, 4, 32
BEAM_PROFILED_NEW = 18  # profiled calls of 18 and 2 new tokens: 16 steps apart
BEAM_FP32_NEW = 16
EXTRAS_STRETCH_TICKS = 1  # fused T=8 ticks per timed and per profiled window
WEIGHT_TOKENS, WEIGHT_GREEDY = (4, 256), 32


def pool_kv_bytes(cache):
    """Bytes of a pool's KV storage (payloads, int8 scales, positions) and
    what the same slots or blocks take as a bf16 pool (2 bytes per payload
    element, no scales)."""
    total = sum(s.nbytes for c in cache for s in c.stores + [c.pos_store])
    bf16 = sum(2 * c.key_store.numel() + 2 * c.value_store.numel() + c.pos_store.nbytes
               for c in cache)
    return total, bf16


def tokens_of(outs, keys):
    return {o.request.request_id: o.tokens for o in outs if o.request.request_id in keys}


def int8_engine_leg(seed, workload, bf16_tokens):
    """Phase 7's engine at ``kv_cache_dtype="int8"`` over phase 7's
    workload, as INT8_RUNS lists; every request at its budget, the pinned
    captures, every block back; the greedy tokens' agreement with phase
    7's bf16 runs and the pools' KV bytes printed."""
    from tpu_parallel_torch.models import GPTLM, gpt2_125m

    cfg = gpt2_125m(**INT8)
    model = GPTLM(cfg, device="cuda", seed=seed).eval()
    runs = {}
    for name, steps, kwargs, bf16_run in INT8_RUNS:
        eng, outs, wall, peak, blocks = serve_run(model, workload, steps, seed, **kwargs)
        s = eng.metrics.summary()
        bad = [o.request.request_id for o in outs if o.status != "finished"
               or len(o.tokens) != o.request.max_new_tokens]
        if bad:
            raise AssertionError(f"[extras {name}] requests not finished at their budget: {bad}")
        if any(min(o.tokens) < 0 or max(o.tokens) >= cfg.vocab_size for o in outs):
            raise AssertionError(f"[extras {name}] tokens out of range")
        if eng.pool.cache[0].key_store.dtype != torch.int8:
            raise AssertionError(f"[extras {name}] the pool is not int8")
        want = bf16_tokens[bf16_run]
        kv_bytes, bf16_bytes = pool_kv_bytes(eng.pool.cache)
        runs[name] = dict(
            wall_s=wall, tokens_out=s["tokens_out"], tokens_per_s=s["tokens_out"] / wall,
            ttft_ms_p50=s["ttft_ms_p50"], ttft_ms_p95=s["ttft_ms_p95"],
            itl_ms_p50=s["itl_ms_p50"], itl_ms_p95=s["itl_ms_p95"], ticks=s["ticks"],
            peak_memory_gib=peak / 2**30, graph_captures=eng.graph_captures,
            slots=eng.pool.n_slots, kv_bytes=kv_bytes, kv_bytes_as_bf16=bf16_bytes,
            greedy_equal_to_bf16=sum(o.tokens == want[o.request.request_id] for o in outs
                                     if o.request.request_id in want),
            greedy_requests=len(want), greedy=tokens_of(outs, want),
        )
        if blocks is not None:
            runs[name].update(blocks, n_blocks=eng.pool.n_blocks,
                              block_tokens=eng.pool.block_tokens)
            _check_blocks_returned(name, eng)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    captures = {n: r["graph_captures"] for n, r in runs.items() if n in INT8_CAPTURES}
    if captures != INT8_CAPTURES:
        raise AssertionError(f"int8 graph captures by run: {captures}, want {INT8_CAPTURES}")
    return model, runs


def int8_spec_leg(model, seed, bf16_spec_tokens):
    """Phase 9's run (c) (fused ticks of 4 verify blocks drafting on the
    device, one graph per variant) at int8, against a per-step int8 spec
    run: every request at its budget, greedy tokens bitwise equal."""
    workload = spec_workload(seed, model.config.vocab_size)
    greedy = [f"s{i}" for i, (_, _, hot) in enumerate(workload) if not hot]
    runs = {}
    for name, kwargs in (("int8_spec_step_ngram", SPEC), ("int8_spec_fused_ngram", SPEC_FUSED)):
        eng, outs, wall, peak, kinds = spec_run(model, workload, seed, **kwargs)
        s = eng.metrics.summary()
        bad = [o.request.request_id for o in outs if o.status != "finished"
               or len(o.tokens) != o.request.max_new_tokens]
        if bad:
            raise AssertionError(f"[extras {name}] requests not finished at their budget: {bad}")
        want_kinds = {"spec_fused"} if kwargs is SPEC_FUSED else set()
        if {k.replace("_sampled", "") for k in kinds} != want_kinds:
            raise AssertionError(f"[extras {name}] replayed tick kinds {sorted(kinds)}")
        runs[name] = dict(wall_s=wall, tokens_out=s["tokens_out"],
                          tokens_per_s=s["tokens_out"] / wall, decode_ticks=s["decode_ticks"],
                          acceptance_rate=s["spec_acceptance_rate"],
                          peak_memory_gib=peak / 2**30, graph_captures=eng.graph_captures,
                          tokens=tokens_of(outs, greedy))
        del eng
        gc.collect()
    step, fused = runs["int8_spec_step_ngram"]["tokens"], runs["int8_spec_fused_ngram"]["tokens"]
    differ = [r for r in greedy if step[r] != fused[r]]
    if differ:
        raise AssertionError(f"[extras int8 spec] greedy tokens of {len(differ)} requests differ "
                             f"between the per-step and the fused int8 spec runs")
    for r in runs.values():
        r["greedy_equal_to_bf16_c"] = sum(r["tokens"][k] == bf16_spec_tokens[k] for k in greedy)
        r["greedy_requests"] = len(greedy)
        del r["tokens"]
    torch.cuda.empty_cache()
    return runs


def _device_ms(fn):
    """(result, device busy ms, kernel launches, copy, index and gather
    kernels by name: (launches, ms)) of one call under ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    copies = {e.key[:90]: (e.count, e.self_device_time_total / 1e3) for e in events
              if any(m in e.key for m in ("copy", "index", "gather"))}
    return (out, sum(e.self_device_time_total for e in events) / 1e3,
            sum(e.count for e in events), copies)


def beam_leg(model, model8, seed):
    """``generate_beam`` on GPT-2 125M: 4 prompts of 256 tokens, 4 beams,
    BEAM_NEW new tokens, lazy and eager, timed; device ms per beam step from
    two profiled calls (18 and 2 new tokens: the difference over 16
    steps, so the prefill drops out); the eager form's reorder copies per
    step.  Then the int8 cache's lazy beam (``model8``), and an fp32 leg
    (TF32 off): lazy tokens equal to eager, scores within 1e-4."""
    from tpu_parallel_torch.models import GPTLM, gpt2_125m
    from tpu_parallel_torch.models.generate import generate_beam

    cfg = model.config
    gen = torch.Generator().manual_seed(seed + 10)
    prompt = torch.randint(0, cfg.vocab_size, (BEAM_PROMPTS, BEAM_PROMPT_LEN),
                           generator=gen).cuda()
    kw = dict(num_beams=BEAM_WIDTH)
    out = {}
    with torch.inference_mode():
        for lazy in (True, False):
            name = "lazy" if lazy else "eager"
            generate_beam(model, prompt, max_new_tokens=2, lazy=lazy, **kw)  # warm
            torch.cuda.synchronize()
            start = time.perf_counter()
            toks, scores = generate_beam(model, prompt, max_new_tokens=BEAM_NEW, lazy=lazy, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - start
            _, long_ms, long_n, copies = _device_ms(lambda: generate_beam(
                model, prompt, max_new_tokens=BEAM_PROFILED_NEW, lazy=lazy, **kw))
            _, short_ms, short_n, short_copies = _device_ms(
                lambda: generate_beam(model, prompt, max_new_tokens=2, lazy=lazy, **kw))
            steps = BEAM_PROFILED_NEW - 2
            if not torch.isfinite(scores).all() or toks.min() < 0 or toks.max() >= cfg.vocab_size:
                raise AssertionError(f"[extras beam {name}] bad tokens or scores")
            copy_ms = sum(ms for _, ms in copies.values()) - sum(
                ms for _, ms in short_copies.values())
            out[name] = dict(wall_s=wall, tokens_per_s=BEAM_PROMPTS * BEAM_NEW / wall,
                             device_ms_per_step=(long_ms - short_ms) / steps,
                             launches_per_step=(long_n - short_n) / steps,
                             copy_ms_per_step=copy_ms / steps, copies=copies,
                             tokens=toks.cpu(), scores=scores.cpu().tolist())
        # the eager reorder reads and writes every row of every store of
        # the [16 rows, seq_len] cache, positions included, each step
        rows, n_kv = BEAM_PROMPTS * BEAM_WIDTH, cfg.n_kv_heads or cfg.n_heads
        per_layer = (2 * n_kv * rows * cfg.seq_len * cfg.head_dim * cfg.dtype.itemsize
                     + rows * cfg.seq_len * 4)
        out["eager"]["reorder_bytes_per_step"] = 2 * cfg.n_layers * per_layer
        out["lazy_equal_eager_bf16"] = int(
            (out["lazy"]["tokens"] == out["eager"]["tokens"]).all(dim=1).sum())
        torch.cuda.synchronize()
        start = time.perf_counter()
        toks8, scores8 = generate_beam(model8, prompt, max_new_tokens=BEAM_NEW, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        out["int8_lazy"] = dict(wall_s=wall, tokens_per_s=BEAM_PROMPTS * BEAM_NEW / wall,
                                rows_equal_to_bf16_lazy=int(
                                    (toks8.cpu() == out["lazy"]["tokens"]).all(dim=1).sum()))
        if not torch.isfinite(scores8).all():
            raise AssertionError("[extras beam int8] non-finite scores")
        model32 = GPTLM(gpt2_125m(dtype=torch.float32), device="cuda", seed=seed).eval()
        lazy = generate_beam(model32, prompt, max_new_tokens=BEAM_FP32_NEW, lazy=True, **kw)
        eager = generate_beam(model32, prompt, max_new_tokens=BEAM_FP32_NEW, lazy=False, **kw)
        del model32
    torch.cuda.empty_cache()
    if not torch.equal(lazy[0], eager[0]):
        raise AssertionError("[extras beam fp32] lazy and eager tokens differ")
    score_diff = (lazy[1] - eager[1]).abs().max().item()
    if score_diff > 1e-4:
        raise AssertionError(f"[extras beam fp32] lazy and eager scores differ by {score_diff}")
    out["fp32_score_max_abs_diff"] = score_diff
    for name in ("lazy", "eager"):
        del out[name]["tokens"]
    return out


def weights_leg(model, seed):
    """Weight-only int8 export of the seeded GPT-2 125M tree (the fp32
    draws, through ``params_to_jax``): ``quantized_nbytes`` against the fp32
    and bf16 trees (held under 0.35x fp32), the ``save_int8_npz`` ->
    ``load_int8_npz`` round trip (held bitwise), and the dequantized
    model's logits against the original's on [4, 256] tokens and its
    greedy agreement over 32 tokens (printed)."""
    import tempfile

    from tpu_parallel_torch.models import GPTLM
    from tpu_parallel_torch.models.convert import init_params, params_from_jax, params_to_jax
    from tpu_parallel_torch.models.generate import generate
    from tpu_parallel_torch.models.quantize import (
        QuantizedTensor, dequantize_params, load_int8_npz, quantize_params, quantized_nbytes,
        save_int8_npz)

    cfg = model.config
    # the seed's fp32 draws (init_params refills the model with the same values)
    tree = params_to_jax(init_params(model, seed), cfg)
    start = time.perf_counter()
    qtree = quantize_params(tree)
    quantize_s = time.perf_counter() - start
    fp32_bytes = quantized_nbytes(tree)
    q_bytes = quantized_nbytes(qtree)
    if not q_bytes < 0.35 * fp32_bytes:
        raise AssertionError(f"[extras weights] int8 tree {q_bytes} B, fp32 {fp32_bytes} B")
    with tempfile.TemporaryDirectory(prefix="int8_npz_") as tmp:
        path = f"{tmp}/gpt2_125m_int8.npz"
        save_int8_npz(path, qtree)
        file_bytes = Path(path).stat().st_size
        loaded = load_int8_npz(path)

    def leaves(t, prefix=""):
        for k, v in t.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", v

    got, want = dict(leaves(loaded)), dict(leaves(qtree))
    for key, w in want.items():
        g = got[key]
        same = (isinstance(g, QuantizedTensor) and torch.equal(g.q, w.q)
                and torch.equal(g.scale, w.scale)) if isinstance(w, QuantizedTensor) else (
            torch.equal(g, w))
        if not same or sorted(got) != sorted(want):
            raise AssertionError(f"[extras weights] npz round trip changed {key}")
    restored = GPTLM(cfg, device="cuda", seed=seed).eval()
    restored.load_state_dict(params_from_jax(dequantize_params(loaded, cfg.dtype), cfg))
    gen = torch.Generator().manual_seed(seed + 11)
    tokens = torch.randint(0, cfg.vocab_size, WEIGHT_TOKENS, generator=gen).cuda()
    with torch.inference_mode():
        ref, got_logits = model(tokens).float(), restored(tokens).float()
        if not torch.isfinite(got_logits).all():
            raise AssertionError("[extras weights] non-finite logits")
        a = generate(model, tokens[:, :64], max_new_tokens=WEIGHT_GREEDY)
        b = generate(restored, tokens[:, :64], max_new_tokens=WEIGHT_GREEDY)
    del restored
    torch.cuda.empty_cache()
    return dict(fp32_tree_bytes=fp32_bytes, bf16_tree_bytes=fp32_bytes // 2, int8_tree_bytes=q_bytes,
                npz_file_bytes=file_bytes, quantize_s=quantize_s,
                logits_max_abs_diff=(got_logits - ref).abs().max().item(),
                logits_ref_max_abs=ref.abs().max().item(),
                greedy_tokens_equal=int((a == b).sum()), greedy_tokens=int(a.numel()),
                argmax_agreement=float((got_logits.argmax(-1) == ref.argmax(-1)).float().mean()),
                quantized_leaves=sum(isinstance(v, QuantizedTensor) for v in want.values()),
                leaves=len(want))


def extras_phase(seed, smi, bf16_tokens, bf16_spec_tokens):
    """Phase 10: decode extras on GPT-2 125M.  The int8 KV cache through
    phase 7's engine (three runs) with a profiled pure-decode stretch per
    layout beside the same stretch at bf16 and an fp32 leg against static
    int8 ``generate()``; phase 9's run (c) at int8 against a per-step int8
    spec run; beam search, lazy and eager; weight-only int8 export.  No
    flash launch.  Each leg prints its lines as it ends."""
    from tpu_parallel_torch.models import GPTLM, gpt2_125m
    from tpu_parallel_torch.ops import flash_attention as fa

    start = time.perf_counter()
    legs_s = {}

    def lap(name):
        legs_s[name] = time.perf_counter() - start - sum(legs_s.values())

    flash_before = [getattr(fa, name) for name in LAUNCH_COUNTERS]
    workload = serve_workload(seed, gpt2_125m().vocab_size)
    model8, runs = int8_engine_leg(seed, workload, bf16_tokens)
    lap("int8_engine")
    for name, r in runs.items():
        log(f"[extras {name}] {r['wall_s']:.3f} s wall, {r['tokens_out']} tokens out "
            f"({r['tokens_per_s']:.1f} tokens/s), {r['ticks']} ticks; TTFT p50 "
            f"{r['ttft_ms_p50']} ms p95 {r['ttft_ms_p95']} ms; ITL p50 {r['itl_ms_p50']} ms p95 "
            f"{r['itl_ms_p95']} ms; peak memory {r['peak_memory_gib']:.2f} GiB; graph captures "
            f"{r['graph_captures']}; {r['slots']} slots, KV bytes {r['kv_bytes']} int8 against "
            f"{r['kv_bytes_as_bf16']} as bf16 ({r['kv_bytes'] / r['kv_bytes_as_bf16']:.4f}); "
            f"greedy requests equal to phase 7's bf16 run: {r['greedy_equal_to_bf16']}/"
            f"{r['greedy_requests']}")
        if "peak_blocks_in_use" in r:
            log(f"  paged: {r['n_blocks']} blocks of {r['block_tokens']} tokens; peak blocks in "
                f"use {r['peak_blocks_in_use']}; block-gate holds {r['block_gate_holds']}; every "
                f"block free at the end")
        del r["greedy"]
    stretches = {}
    for layout, kwargs in (("contiguous", PER_PHASE), ("paged", PAGED)):
        stretches[f"int8_{layout}"] = decode_stretch(model8, 8, seed, EXTRAS_STRETCH_TICKS,
                                                     **kwargs)
    lap("int8_stretches")
    spec = int8_spec_leg(model8, seed, bf16_spec_tokens)
    lap("int8_spec")
    for name, r in spec.items():
        log(f"[extras {name}] {r['wall_s']:.3f} s wall, {r['tokens_out']} tokens out "
            f"({r['tokens_per_s']:.1f} tokens/s); {r['decode_ticks']} decode ticks; acceptance "
            f"{r['acceptance_rate']}; peak memory {r['peak_memory_gib']:.2f} GiB; graph captures "
            f"{r['graph_captures']}; greedy requests equal to phase 9 (c) bf16: "
            f"{r['greedy_equal_to_bf16_c']}/{r['greedy_requests']}")
    model = GPTLM(gpt2_125m(), device="cuda", seed=seed).eval()
    for layout, kwargs in (("contiguous", PER_PHASE), ("paged", PAGED)):
        stretches[f"bf16_{layout}"] = decode_stretch(model, 8, seed, EXTRAS_STRETCH_TICKS,
                                                     **kwargs)
    lap("bf16_stretches")
    for name, d in stretches.items():
        log(f"[extras stretch {name}] 16 slots: {d['decode_tokens_per_s']:.1f} decode tokens/s; "
            f"{d['device_ms_per_step']:.4f} device ms per decode step; idle share "
            f"{d['idle_share']:.3f}; {d['kernel_launches_per_token']:.2f} kernel launches per "
            f"token")
        for c in d["copies_per_step"]:
            log(f"    copy/cast/gather per decode step: {c['launches_per_step']:6.2f} launches, "
                f"{c['ms_per_step']:.4f} ms, {c['us_per_launch']:7.2f} us each: {c['kernel']}")
        for key, count, ms in d["top_kernels_ms"][:6]:
            log(f"    {ms:9.3f} ms {100 * ms / d['device_busy_ms']:5.1f}% x{count:<5d} {key}")
    for layout in ("contiguous", "paged"):
        a, b = stretches[f"int8_{layout}"], stretches[f"bf16_{layout}"]
        log(f"[extras] int8 / bf16 device ms per decode step, {layout}: "
            f"{a['device_ms_per_step']:.4f} / {b['device_ms_per_step']:.4f} = "
            f"{a['device_ms_per_step'] / b['device_ms_per_step']:.3f}")
    beam = beam_leg(model, model8, seed)
    lap("beam")
    del model8
    for name in ("lazy", "eager"):
        r = beam[name]
        log(f"[extras beam {name}] [{BEAM_PROMPTS}, {BEAM_PROMPT_LEN}] x {BEAM_WIDTH} beams, "
            f"{BEAM_NEW} new: {r['wall_s']:.3f} s wall, {r['tokens_per_s']:.1f} tokens/s; "
            f"{r['device_ms_per_step']:.4f} device ms per beam step, "
            f"{r['launches_per_step']:.1f} launches per step; copy/gather "
            f"{r['copy_ms_per_step']:.4f} ms per step")
        for key, (count, ms) in sorted(r["copies"].items(), key=lambda kv: -kv[1][1])[:4]:
            log(f"    {ms:9.3f} ms x{count:<6d} {key}")
    e = beam["eager"]
    log(f"[extras beam] eager reorder: {e['reorder_bytes_per_step']} bytes read and written "
        f"per step ({e['reorder_bytes_per_step'] / 1e6:.1f} MB); lazy rows equal to eager in "
        f"bf16: {beam['lazy_equal_eager_bf16']}/{BEAM_PROMPTS}; int8 lazy "
        f"{beam['int8_lazy']['tokens_per_s']:.1f} tokens/s, rows equal to bf16 lazy "
        f"{beam['int8_lazy']['rows_equal_to_bf16_lazy']}/{BEAM_PROMPTS}; fp32 lazy = eager, "
        f"scores within {beam['fp32_score_max_abs_diff']:.2e}")
    weights = weights_leg(model, seed)
    lap("weights")
    w = weights
    log(f"[extras weights] GPT-2 125M tree: fp32 {w['fp32_tree_bytes']} B, bf16 "
        f"{w['bf16_tree_bytes']} B, int8 {w['int8_tree_bytes']} B "
        f"({w['int8_tree_bytes'] / w['fp32_tree_bytes']:.4f}x fp32, "
        f"{w['int8_tree_bytes'] / w['bf16_tree_bytes']:.4f}x bf16; {w['quantized_leaves']} of "
        f"{w['leaves']} leaves quantized in {w['quantize_s']:.2f} s); .npz {w['npz_file_bytes']} "
        f"B, round trip bitwise; dequantized logits max abs diff {w['logits_max_abs_diff']:.4f} "
        f"(logits up to {w['logits_ref_max_abs']:.3f}), argmax agreement "
        f"{w['argmax_agreement']:.4f}; greedy tokens equal {w['greedy_tokens_equal']}/"
        f"{w['greedy_tokens']}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    fp32 = fp32_check(seed, workload, tie_gap=INT8_TIE_GAP, **INT8)
    lap("fp32")
    moved = [getattr(fa, name) - n for name, n in zip(LAUNCH_COUNTERS, flash_before)]
    if any(moved):
        raise AssertionError(f"the decode-extras path launched flash kernels: {moved}")
    phase_s = time.perf_counter() - start
    log(f"[extras] fp32 int8 engine vs static int8 generate(): {sum(r['equal'] for r in fp32)}/"
        f"{len(fp32)} equal {fp32}; no flash launch; phase 10 took {phase_s:.1f} s ("
        + ", ".join(f"{k} {v:.1f}" for k, v in legs_s.items()) + ")")
    log(f"card: {smi}")
    return dict(int8_runs=runs, stretches=stretches, int8_spec=spec, beam=beam, weights=weights,
                fp32=fp32, phase_s=phase_s, legs_s=legs_s)


# phase 11: the trainer shell (GPT-2 125M, seeded weights, a byte-level
# corpus made on the card from the repo's and the standard library's sources)
CORPUS_CAP = 16 * 2**20  # tokens
EOS_ID = 50256  # GPT-2's <|endoftext|>
FIT_STEPS, RESUME_STEPS, ROLLBACK_STEPS, FAIL_AT = 8, 10, 12, 9
FIT_EVERY = 4  # checkpoint_every and eval_every of the packed fit
SHELL_WARMUP = 2  # warmup_steps of phase 11's short runs (the configs' own are 10-100)
SHELL_STEPS = 4  # steps of the optimizer, EMA and dropout legs
TIMED_STEPS = 4  # timed steps, packed against flat and at 8k
# lion's and sgd's learning rates on the corpus config: lion's sign steps
# move every weight by the whole rate (its authors take 3-10x below AdamW's;
# at the config's 3e-4 the loss rose at the third step), and sgd's steps
# at 3e-4 fall below the bf16 weights' rounding, so the module would not move
LION_LR, SGD_LR = 3e-5, 0.1
PACKED_SHAPE = (16, 12, 12, 1024, 64, dict(causal=True), True, 20)
LONG_SHAPE = (2, 12, 12, 8192, 64, dict(causal=True), False, 10)
SERVE_PROMPTS, SERVE_PROMPT_LEN, SERVE_NEW = 4, 64, 32
SHELL_SEQ = 1024  # gpt2_125m's seq_len: the packed rows and flat windows of the corpus


def build_corpus(directory):
    """Byte-level tokens of the repo's ``*.py``/``*.md`` files and the
    standard library's ``*.py`` (its third-party packages left out), in
    sorted path order, EOS after each file, capped at CORPUS_CAP tokens;
    written with ``TokenDataset.write_bin``.  Returns (path, tokens,
    documents)."""
    import sysconfig

    import numpy as np
    from tpu_parallel_torch.data import TokenDataset

    here = Path(__file__).resolve().parent
    stdlib = Path(sysconfig.get_paths()["stdlib"])
    # the directories git leaves out of a checkout, and third-party packages
    ignored = (here / ".gitignore").read_text().splitlines()
    skip = {"site-packages", "dist-packages"} | {
        line.strip().rstrip("/").split("/")[-1] for line in ignored if line.strip().endswith("/")}
    # directories are judged below each root, whatever lies above it
    paths = [p for root, files in ((here, [*here.rglob("*.py"), *here.rglob("*.md")]),
                                   (stdlib, stdlib.rglob("*.py")))
             for p in files if p.is_file() and not any(
                 part in skip or part.startswith(".") for part in p.relative_to(root).parts[:-1])]
    chunks, total, docs = [], 0, 0
    for path in sorted(set(paths)):
        data = np.frombuffer(path.read_bytes(), dtype=np.uint8).astype(np.uint16)
        doc = np.append(data, np.uint16(EOS_ID))[:CORPUS_CAP - total]
        chunks.append(doc)
        total += len(doc)
        docs += 1
        if total >= CORPUS_CAP:
            break
    tokens = np.concatenate(chunks)
    path = str(Path(directory) / "corpus.bin")
    TokenDataset.write_bin(path, tokens)
    return path, len(tokens), docs


def _shell_config(name, **changes):
    """A config of ``tpu_parallel_torch/configs`` as a ``TrainerConfig``
    and its plumbing keys (model overrides in ``changes["model_overrides"]``
    merge into the config's)."""
    from tpu_parallel_torch.configs import get_config
    from tpu_parallel_torch.train_lib import TrainerConfig

    cd = get_config(name)
    plumbing = {k: cd.pop(k) for k in ("checkpoint_dir", "checkpoint_every", "data_path",
                                        "data_format", "eos_id", "eval_steps", "eval_every",
                                        "keep_best", "eval_fraction", "simulate_cpu_devices")
                if k in cd}
    cd["model_overrides"].update(changes.pop("model_overrides", {}))
    cd.update(changes)
    return TrainerConfig.from_config_dict(cd), plumbing


def _launch_counts():
    from tpu_parallel_torch.ops import flash_attention as fa

    return [getattr(fa, name) for name in LAUNCH_COUNTERS]


def _reset_launches():
    from tpu_parallel_torch.ops import flash_attention as fa

    for name in LAUNCH_COUNTERS:
        setattr(fa, name, 0)


def _counting_step(trainer, per_step, losses):
    """Replace ``trainer.step_fn`` (the fit's seam) by one that records each
    step's (fwd, bwd) launches and its own loss."""
    from tpu_parallel_torch.core.metrics import accumulate_metrics, compute

    real = trainer.step_fn

    def step(state, metrics, batch):
        before = _launch_counts()
        state, step_metrics = real(state, None, batch)
        per_step.append([a - b for a, b in zip(_launch_counts(), before)])
        losses.append(compute(step_metrics)["loss"])
        return state, accumulate_metrics(metrics, step_metrics)

    trainer.step_fn = step


def _state_tensors(sd, prefix=""):
    if isinstance(sd, torch.Tensor):
        return {prefix: sd}
    if not isinstance(sd, (dict, list, tuple)):
        return {}
    items = sd.items() if isinstance(sd, dict) else enumerate(sd)
    out = {}
    for k, v in items:
        out.update(_state_tensors(v, f"{prefix}/{k}"))
    return out


def _falls(name, losses):
    import math

    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"{name}: loss not finite and falling: {losses}")


def _timed_steps(trainer, batches):
    """Host ms per step over ``batches`` after one warm-up step, each run
    ended by a synchronize."""
    trainer.step_fn(trainer.state, None, batches[0])
    torch.cuda.synchronize()
    start = time.perf_counter()
    for batch in batches:
        trainer.step_fn(trainer.state, None, batch)
    torch.cuda.synchronize()
    return (time.perf_counter() - start) * 1e3 / len(batches)


def _step_profile(fn):
    """Device busy ms, flash forward and backward ms and wall ms of one
    call of ``fn`` (``torch.profiler``), after a warm-up call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - start) * 1e3
    events = [(e.key, e.self_device_time_total) for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy = sum(t for _, t in events) / 1e3
    fwd = sum(t for k, t in events if "flash_fwd_" in k) / 1e3
    bwd = sum(t for k, t in events if "flash_bwd_" in k) / 1e3
    return dict(wall_ms=wall, busy_ms=busy, flash_fwd_ms=fwd, flash_bwd_ms=bwd,
                kernel_share=(fwd + bwd) / busy if busy else None)


def _grad_rel(model_a, model_b, loss_a, loss_b, batch, gen_a=None, gen_b=None):
    """Loss difference and the worst per-weight relative L2 gradient error
    of two models (the same weights) on one minibatch; the key slice of the
    qkv bias left out (zero in exact arithmetic)."""
    grads = []
    for model, loss_fn, gen in ((model_a, loss_a, gen_a), (model_b, loss_b, gen_b)):
        loss, _ = loss_fn(model, batch, gen)
        loss.backward()
        grads.append((loss.item(), {n: p.grad.float() for n, p in model.named_parameters()}))
        model.zero_grad(set_to_none=True)
    cfg = model_a.config
    dh = cfg.head_dim
    not_key = (torch.arange(3 * cfg.d_model, device="cuda") % (3 * dh)) // dh != 1
    rel = {}
    for n, g_b in grads[1][1].items():
        g_a = grads[0][1][n]
        if n.endswith("attn.qkv.bias"):
            g_a, g_b = g_a[not_key], g_b[not_key]
        rel[n] = ((g_a - g_b).norm() / g_b.norm().clamp(min=1e-30)).item()
    worst = max(rel, key=rel.get)
    return abs(grads[0][0] - grads[1][0]), rel[worst], worst


def _same_weights(model, config):
    """A second ``GPTLM`` of ``config`` holding ``model``'s weights."""
    from tpu_parallel_torch.models import GPTLM

    other = GPTLM(config, device="cuda")
    other.load_state_dict(model.state_dict())
    return other


def packed_fit_leg(seed, work, corpus):
    """(b): the packed fit with checkpoints, held-out evaluation and the
    best snapshot; a resume in a new Trainer; a rollback after a failure
    injected through the step seam; packed against flat step time and
    kernel share; save, restore and eval timings.  Returns the leg's
    report and the launches of the packed fit (the main path)."""
    import os
    import shutil

    import numpy as np
    from tpu_parallel_torch.checkpoint import Checkpointer
    from tpu_parallel_torch.data import DataLoader, PackedDataset, TokenDataset
    from tpu_parallel_torch.train_lib import Trainer

    report = {}
    config, plumbing = _shell_config("gpt2_125m_corpus", steps=FIT_STEPS, seed=seed,
                                     warmup_steps=SHELL_WARMUP)
    packed = PackedDataset(corpus, SHELL_SEQ, eos_id=EOS_ID)
    loader = DataLoader(packed, config.global_batch_size, seed=seed,
                        holdout_fraction=plumbing["eval_fraction"], device="cuda")
    run = os.path.join(work, "run")
    fit_kw = dict(checkpoint_every=FIT_EVERY, eval_every=FIT_EVERY, eval_steps=2,
                  keep_best=True, max_to_keep=2)
    t1 = Trainer(config, device="cuda")
    per_step, losses, evals = [], [], []
    _counting_step(t1, per_step, losses)
    real_eval = t1.evaluate

    def counting_eval(*args, **kwargs):
        before = _launch_counts()
        out = real_eval(*args, **kwargs)
        evals.append([a - b for a, b in zip(_launch_counts(), before)])
        return out

    t1.evaluate = counting_eval
    logged = []
    _reset_launches()  # the packed training main path starts here
    start = time.perf_counter()
    t1.fit(run, data_loader=loader, log_fn=lambda s, m: logged.append((s, m)), **fit_kw)
    torch.cuda.synchronize()
    report["fit_s"] = time.perf_counter() - start
    launches = dict(zip(LAUNCH_COUNTERS, _launch_counts()))
    want = t1.model_config.n_layers * config.num_minibatches
    if any(n != [want, want] for n in per_step) or len(per_step) != FIT_STEPS:
        raise AssertionError(f"packed fit: launches per step (fwd, bwd) {per_step}, want "
                             f"{want} each over {FIT_STEPS} steps")
    if any(e[1] != 0 or e[0] != t1.model_config.n_layers * fit_kw["eval_steps"] for e in evals):
        raise AssertionError(f"evaluation launched {evals} (want 12 forwards per batch, "
                             "no backward)")
    _falls("packed fit", losses)
    best = os.path.join(run, "best")
    best_loss = json.loads(Path(best, "best_loss.json").read_text())
    if Checkpointer(best).latest_step != best_loss["step"]:
        raise AssertionError(f"best/ holds {Checkpointer(best).latest_step}, best_loss.json "
                             f"{best_loss}")
    report.update(losses=losses, launches_per_step=per_step[-1], eval_launches=evals,
                  evals=[(s, m) for s, m in logged if "eval_loss" in m], best=best_loss,
                  launches=launches)

    # resume: a new Trainer on the same directory, restored bitwise, to RESUME_STEPS
    ckpt = Checkpointer(run)
    saved = ckpt.load(FIT_STEPS)
    report["checkpoint_bytes"] = ckpt.bytes_on_disk(FIT_STEPS)
    del t1
    gc.collect()
    t2 = Trainer(_shell_config("gpt2_125m_corpus", steps=RESUME_STEPS, seed=seed,
                               warmup_steps=SHELL_WARMUP)[0], device="cuda")
    t2.init()
    torch.cuda.synchronize()
    start = time.perf_counter()
    t2.restore_checkpoint(run)
    torch.cuda.synchronize()
    report["restore_ms"] = (time.perf_counter() - start) * 1e3
    got = _state_tensors(t2.state.state_dict())
    want_tensors = _state_tensors(saved)
    if set(got) != set(want_tensors) or not all(torch.equal(got[k].cpu(), want_tensors[k])
                                                for k in want_tensors):
        raise AssertionError("the restored state differs from the checkpoint")
    if t2.state.step != FIT_STEPS or t2.state.ema_params is not None:
        raise AssertionError(f"restored step {t2.state.step}, ema {t2.state.ema_params}")
    report["restored_bitwise"] = dict(tensors=len(got), step=t2.state.step, ema=None)
    del saved, got, want_tensors
    resume_losses = []
    _counting_step(t2, [], resume_losses)
    t2.fit(run, data_loader=loader, **fit_kw)
    if t2.state.step != RESUME_STEPS or len(resume_losses) != RESUME_STEPS - FIT_STEPS:
        raise AssertionError(f"resume ran {len(resume_losses)} steps to {t2.state.step}")
    report["resume_losses"] = resume_losses
    del t2
    gc.collect()

    # rollback: checkpoint FIT_STEPS in a directory of its own; the step
    # seam fails once at step FAIL_AT of a run to ROLLBACK_STEPS
    run3 = os.path.join(work, "rollback")
    os.makedirs(run3)
    shutil.copytree(os.path.join(run, str(FIT_STEPS)), os.path.join(run3, str(FIT_STEPS)))
    t3 = Trainer(_shell_config("gpt2_125m_corpus", steps=ROLLBACK_STEPS, seed=seed,
                               warmup_steps=SHELL_WARMUP)[0], device="cuda")
    fed = []
    real_batch_at = loader.batch_at
    recording = DataLoader(packed, config.global_batch_size, seed=seed,
                           holdout_fraction=plumbing["eval_fraction"], device="cuda")
    recording.batch_at = lambda step: fed.append(step) or real_batch_at(step)
    real_step = t3.step_fn
    boom = {"done": False}

    def flaky_step(state, metrics, batch):
        if state.step == FAIL_AT and not boom["done"]:
            boom["done"] = True
            raise RuntimeError(f"injected failure at step {FAIL_AT}")
        return real_step(state, metrics, batch)

    t3.step_fn = flaky_step
    t3.fit(run3, data_loader=recording, checkpoint_every=FIT_EVERY, max_to_keep=2)
    if not boom["done"] or t3.state.step != ROLLBACK_STEPS or fed.count(FAIL_AT) != 2:
        raise AssertionError(f"rollback: failed {boom['done']}, ended at {t3.state.step}, "
                             f"batches requested {fed}")
    report["rollback"] = dict(batches_requested=fed, ended_at=t3.state.step)
    t3.step_fn = real_step

    # save: the blocking snapshot and the background write to done
    extra = Checkpointer(os.path.join(work, "save_timing"))
    torch.cuda.synchronize()
    start = time.perf_counter()
    extra.save(t3.state.step, t3.state)
    returned = time.perf_counter()
    torch.cuda.synchronize()
    copied = time.perf_counter()
    extra.wait()
    done = time.perf_counter()
    report["save"] = dict(blocking_ms=(returned - start) * 1e3,
                          snapshot_copied_ms=(copied - start) * 1e3,
                          write_to_done_ms=(done - returned) * 1e3,
                          bytes=extra.bytes_on_disk(t3.state.step))
    shutil.rmtree(os.path.join(work, "save_timing"))

    # eval ms per batch; packed against flat windows at the same config
    eval_iter = iter(loader.eval_view())
    t3.evaluate(batch_iter=eval_iter, steps=1)
    torch.cuda.synchronize()
    start = time.perf_counter()
    t3.evaluate(batch_iter=eval_iter, steps=4)
    torch.cuda.synchronize()
    report["eval_ms_per_batch"] = (time.perf_counter() - start) * 1e3 / 4
    flat = DataLoader(TokenDataset(corpus, SHELL_SEQ), config.global_batch_size, seed=seed,
                      device="cuda")
    batches = {"packed": [loader.batch_at(i) for i in range(TIMED_STEPS)],
               "flat": [flat.batch_at(i) for i in range(TIMED_STEPS)]}
    report["step_ms"], report["step_profile"] = {}, {}
    for kind in ("packed", "flat", "flat", "packed"):
        report["step_ms"].setdefault(kind, []).append(_timed_steps(t3, batches[kind]))
    for kind in ("packed", "flat"):
        report["step_profile"][kind] = _step_profile(
            lambda: t3.step_fn(t3.state, None, batches[kind][0]))
    report["segments_per_row"] = float(np.mean(
        [int(r.max()) for r in batches["packed"][0].segment_ids.cpu()]))
    masters, module = t3.state.params, t3.model.eval()
    del t3, batches
    gc.collect()
    torch.cuda.empty_cache()
    return report, launches, (masters, module)


def long_leg(seed, corpus):
    """(d): ``gpt2_125m_long`` over flat 8k windows, 2 warm-up and 4 timed
    steps; one minibatch with the chunked loss against the full logits."""
    import dataclasses

    from tpu_parallel_torch.data import DataLoader, TokenDataset
    from tpu_parallel_torch.models.gpt import make_gpt_loss
    from tpu_parallel_torch.train_lib import Trainer
    from tpu_parallel_torch.utils.profiling import peak_flops, transformer_flops_per_token

    config, _ = _shell_config("gpt2_125m_long", steps=2 + TIMED_STEPS, seed=seed,
                              warmup_steps=SHELL_WARMUP)
    trainer = Trainer(config, device="cuda")
    trainer.init()
    cfg = trainer.model_config
    loader = DataLoader(TokenDataset(corpus, cfg.seq_len), config.global_batch_size, seed=seed,
                        device="cuda")
    per_step, losses = [], []
    _counting_step(trainer, per_step, losses)
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()  # the long-context training main path starts here
    for i in range(2 + TIMED_STEPS):
        if i == 2:
            torch.cuda.synchronize()
            start = time.perf_counter()
        trainer.step_fn(trainer.state, None, loader.batch_at(i))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - start) * 1e3 / TIMED_STEPS
    launches = dict(zip(LAUNCH_COUNTERS, _launch_counts()))
    peak_mem = torch.cuda.max_memory_allocated()
    want = cfg.n_layers * config.num_minibatches
    if any(n != [want, want] for n in per_step):
        raise AssertionError(f"8k: launches per step (fwd, bwd) {per_step}, want {want} each")
    _falls("8k training", losses)
    tokens = config.global_batch_size * cfg.seq_len
    card = torch.cuda.get_device_name(0)
    peak = peak_flops(card)
    tokens_per_s = tokens / step_ms * 1e3
    report = dict(losses=losses, launches_per_step=per_step[-1], launches=launches,
                  step_ms=step_ms, tokens_per_s=tokens_per_s,
                  mfu=tokens_per_s * transformer_flops_per_token(cfg) / peak if peak else None,
                  max_memory_allocated=peak_mem)
    # one minibatch [2, 8192]: loss_chunk=1024 against the full logits
    mb = loader.batch_at(0).rows(0, config.global_batch_size // config.num_minibatches)
    model = trainer.model
    full_cfg = dataclasses.replace(cfg, loss_chunk=0)
    mems = {}
    for name, c in (("chunked", cfg), ("full", full_cfg)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss, _ = make_gpt_loss(c)(model, mb)
        loss.backward()
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        mems[name] = torch.cuda.max_memory_allocated()
    loss_diff, worst, worst_name = _grad_rel(model, model, make_gpt_loss(cfg),
                                             make_gpt_loss(full_cfg), mb)
    if loss_diff > LOSS_TOL or worst > TRAIN_GRAD_TOL:
        raise AssertionError(f"8k chunked loss: |loss diff| {loss_diff}, worst gradient "
                             f"{worst} ({worst_name})")
    report.update(chunk_vs_full=dict(loss_diff=loss_diff, worst_grad_rel=worst,
                                     worst_weight=worst_name, peak_memory=mems))
    del trainer, model
    gc.collect()
    torch.cuda.empty_cache()
    return report, launches


def optimizer_leg(seed, batch, eval_batches):
    """(e) and (f): lion, sgd, an EMA shadow and dropout, 4 steps each on
    one packed batch; EMA evaluation against a plain forward on the EMA
    weights; dropout's mask reproduced under remat and "dots" against
    "proj_attn", with each policy's peak memory and ms."""
    import dataclasses

    from tpu_parallel_torch.core.metrics import accumulate_metrics, compute
    from tpu_parallel_torch.models.gpt import make_gpt_loss
    from tpu_parallel_torch.train_lib import Trainer

    report = {}

    def run(**changes):
        config, _ = _shell_config("gpt2_125m_corpus", steps=SHELL_STEPS, seed=seed,
                                  warmup_steps=SHELL_WARMUP, **changes)
        trainer = Trainer(config, device="cuda")
        trainer.init()
        losses = []
        _counting_step(trainer, [], losses)
        for _ in range(SHELL_STEPS):
            trainer.step_fn(trainer.state, None, batch)
        return trainer, losses

    for name, changes in (("lion", dict(optimizer="lion", learning_rate=LION_LR)),
                          ("sgd", dict(optimizer="sgd", learning_rate=SGD_LR))):
        trainer, losses = run(**changes)
        _falls(name, losses)
        report[name] = dict(losses=losses, **changes)
        del trainer

    trainer, losses = run(ema_decay=0.99)
    _falls("ema", losses)
    state = trainer.state
    drift = max((state.ema_params[n] - p).abs().max().item() for n, p in state.params.items())
    if drift == 0:
        raise AssertionError("the EMA shadow equals the masters after 4 steps")
    before = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    got = trainer.evaluate(batch_iter=iter(eval_batches), steps=len(eval_batches))
    if not all(torch.equal(p, before[n]) for n, p in trainer.model.named_parameters()):
        raise AssertionError("evaluate changed the module's weights")
    ema_model = _same_weights(trainer.model, trainer.model_config)
    with torch.no_grad():
        for n, p in ema_model.named_parameters():
            p.copy_(state.ema_params[n])
        metrics = None
        for b in eval_batches:
            metrics = accumulate_metrics(
                metrics, make_gpt_loss(ema_model.config, train=False)(ema_model, b)[1])
    want = compute(metrics)
    ema_rel = max(abs(got[k] - want[k]) / max(abs(want[k]), 1e-30) for k in want)
    if ema_rel > 1e-6:
        raise AssertionError(f"evaluate {got} != a plain forward on the EMA weights {want}")
    report["ema"] = dict(losses=losses, shadow_max_abs_from_masters=drift, evaluate=got,
                         plain_forward=want, max_rel_diff=ema_rel,
                         bitwise=got == want)
    del trainer, ema_model, before
    gc.collect()

    trainer, losses = run(model_overrides=dict(dropout_rate=0.1))
    _falls("dropout", losses)
    e1 = trainer.evaluate(batch_iter=iter(eval_batches), steps=len(eval_batches))
    e2 = trainer.evaluate(batch_iter=iter(eval_batches), steps=len(eval_batches))
    if e1 != e2:
        raise AssertionError(f"two evaluations of the dropout model differ: {e1} {e2}")
    mb = batch.rows(0, batch.size // trainer.config.num_minibatches)
    cfg = trainer.model_config
    plain = _same_weights(trainer.model, dataclasses.replace(cfg, remat=False))
    gen = lambda s: torch.Generator().manual_seed(s)
    same = _grad_rel(trainer.model, plain, make_gpt_loss(cfg), make_gpt_loss(plain.config), mb,
                     gen(7), gen(7))
    other = _grad_rel(trainer.model, plain, make_gpt_loss(cfg), make_gpt_loss(plain.config), mb,
                      gen(7), gen(8))
    if same[0] > LOSS_TOL or same[1] > TRAIN_GRAD_TOL or other[1] <= TRAIN_GRAD_TOL:
        raise AssertionError(f"dropout under remat: same generator state {same}, another "
                             f"{other}")
    report["dropout"] = dict(losses=losses, evaluate=e1, proj_attn_vs_no_remat=same,
                             another_generator_state=other)
    del plain
    nodrop = dataclasses.replace(cfg, dropout_rate=0.0)
    models = {p: _same_weights(trainer.model, dataclasses.replace(nodrop, remat=p != "none",
                                                                  remat_policy=p if p != "none"
                                                                  else "full"))
              for p in ("proj_attn", "dots", "full", "none")}
    del trainer
    gc.collect()
    dots = _grad_rel(models["dots"], models["proj_attn"], make_gpt_loss(models["dots"].config),
                     make_gpt_loss(models["proj_attn"].config), mb)
    if dots[0] > LOSS_TOL or dots[1] > TRAIN_GRAD_TOL:
        raise AssertionError(f"'dots' against 'proj_attn': {dots}")
    policies = {}
    for name, model in models.items():
        loss_fn = make_gpt_loss(model.config)

        def fwd_bwd():
            loss, _ = loss_fn(model, mb)
            loss.backward()
            model.zero_grad(set_to_none=True)

        fwd_bwd()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        start = time.perf_counter()
        for _ in range(3):
            fwd_bwd()
        torch.cuda.synchronize()
        policies[name] = dict(ms=(time.perf_counter() - start) * 1e3 / 3,
                              peak_gib=(torch.cuda.max_memory_allocated() - base) / 2**30)
    report["dots_vs_proj_attn"] = dots
    report["policies"] = policies
    del models
    gc.collect()
    torch.cuda.empty_cache()
    return report


def serve_weights_leg(seed, work, trained, prompts):
    """(g): the packed fit's final masters as a serving weight set, loaded
    and verified, a flipped byte refused, then served through a
    ``ServingEngine`` by ``rebind_params`` against static ``generate()`` on
    the trainer's module."""
    import dataclasses
    import os

    from tpu_parallel_torch.checkpoint import (WeightsCorrupt, load_serving_weights,
                                               params_fingerprint, save_serving_weights)
    from tpu_parallel_torch.models import GPTLM
    from tpu_parallel_torch.models.convert import params_from_jax, params_to_jax
    from tpu_parallel_torch.models.generate import generate
    from tpu_parallel_torch.serving import Request

    masters, trained = trained
    # the served model: the trained GPT-2 125M's shapes on the engine's
    # attention path (its caches are read by decode_attention either way)
    cfg = dataclasses.replace(trained.config, attn_impl="xla", remat=False)
    directory = os.path.join(work, "weights")
    start = time.perf_counter()
    manifest = save_serving_weights(directory, ROLLBACK_STEPS, params_to_jax(masters, cfg))
    save_s = time.perf_counter() - start
    tree, loaded = load_serving_weights(directory)
    if loaded != manifest or params_fingerprint(tree) != manifest.fingerprint:
        raise AssertionError(f"weights manifest {loaded} != {manifest}")
    payload = Path(directory, f"weights_{ROLLBACK_STEPS}", "params.pt")
    raw = bytearray(payload.read_bytes())
    raw[len(raw) // 2] ^= 0x01
    payload.write_bytes(bytes(raw))
    try:
        load_serving_weights(directory)
    except WeightsCorrupt as exc:
        refused = str(exc)[:120]
    else:
        raise AssertionError("a flipped byte in the weights loaded without WeightsCorrupt")
    served = params_from_jax(tree, cfg)
    model = GPTLM(cfg, device="cuda", seed=seed + 1).eval()
    eng = serve_engine(model, 8, seed)
    eng.rebind_params({n: t.cuda() for n, t in served.items()}, version=manifest.version)
    outs = [eng.add_request(Request(prompt=p, max_new_tokens=SERVE_NEW, request_id=f"w{i}"))
            for i, p in enumerate(prompts)]
    eng.run()
    results = []
    with torch.inference_mode():
        for i, (p, out) in enumerate(zip(prompts, outs)):
            want = generate(trained, torch.tensor([p], device="cuda"),
                            max_new_tokens=SERVE_NEW)[0].tolist()
            if out.tokens == want:
                results.append(dict(request=i, equal=True))
                continue
            step = next(j for j, (a, b) in enumerate(zip(out.tokens, want)) if a != b)
            ctx = torch.tensor([p + want[:step]], device="cuda")
            logits = trained(ctx, decode=True, cache=trained.init_cache(1))[0, -1].float()
            wide = trained(ctx.expand(SERVE_SLOTS, -1), decode=True,
                           cache=trained.init_cache(SERVE_SLOTS))[0, -1].float()
            top2 = logits.topk(2).values
            gap, noise = (top2[0] - top2[1]).item(), (logits - wide).abs().max().item()
            results.append(dict(request=i, equal=False, first_diff=step, top2_gap=gap,
                                shape_noise=noise))
            # phase 7's rule: a token may differ only on a near-tie, here
            # below twice what the GEMMs' batch shape moves the bf16 logits
            if gap >= max(FP32_TIE_GAP, 2 * noise):
                raise AssertionError(f"served request w{i} differs from generate() at token "
                                     f"{step}: {results[-1]}")
    del model, eng, trained
    gc.collect()
    torch.cuda.empty_cache()
    return dict(manifest=dataclasses.asdict(manifest), save_s=save_s, refused=refused,
                requests=results)


def cli_launch(work, corpus):
    """(h), launched: ``python -m tpu_parallel_torch.train`` in a subprocess
    on the packed corpus with a checkpoint directory, a trace and metrics;
    :func:`cli_check` holds it."""
    trace, metrics = Path(work, "trace.json"), Path(work, "metrics.prom")
    cmd = [sys.executable, "-m", "tpu_parallel_torch.train", "--config=gpt2_125m_corpus",
           "--config.steps=3", f"--config.model_overrides.n_layers={CLI_LAYERS}",
           f"--config.data_path={corpus}", "--config.data_format=packed",
           f"--config.checkpoint_dir={Path(work, 'cli_ckpt')}", f"--trace-out={trace}",
           f"--metrics-out={metrics}"]
    return _launch(cmd), trace, metrics


def cli_check(launched):
    """(h): exit 0, the trace's ``data_wait`` and ``compute`` spans, the
    metrics' ``train_loss``."""
    handle, trace, metrics = launched
    out, wall = _finish(handle, "the CLI")
    names = {e["name"] for e in json.loads(trace.read_text())["traceEvents"]}
    if not {"data_wait", "compute"} <= names or "train_loss" not in metrics.read_text():
        raise AssertionError(f"CLI trace spans {names} or metrics without train_loss")
    return dict(wall_s=wall, stdout_tail=out.strip().splitlines()[-3:])


def trainer_phase(seed, smi):
    """Phase 11: the trainer shell on GPT-2 125M (see the module
    docstring).  Its CLI leg starts after the timed packed and 8k legs,
    beside the optimizer, dropout and serving legs, and is collected at
    the end.  Returns the phase's report and the kernels' rows and
    launches on the packed and the long training paths."""
    import shutil
    import tempfile

    from tpu_parallel_torch.data import PackedDataset

    start = time.perf_counter()
    legs_s = {}

    def lap(name):
        legs_s[name] = time.perf_counter() - start - sum(legs_s.values())

    work = tempfile.mkdtemp(prefix="trainer_shell_")
    try:
        corpus, n_tokens, n_docs = build_corpus(work)
        packed = PackedDataset(corpus, SHELL_SEQ, eos_id=EOS_ID)
        lengths = packed._chunk_ends - packed._chunk_starts
        corpus_report = dict(tokens=n_tokens, documents=n_docs, packed_rows=packed.num_windows,
                             documents_per_row=len(lengths) / packed.num_windows,
                             padding_share=1 - lengths.sum() / (packed.num_windows * SHELL_SEQ))
        log(f"[trainer corpus] {n_tokens} byte-level tokens in {n_docs} documents (the repo's "
            f".py/.md and the standard library's .py, EOS {EOS_ID} after each); packed at {SHELL_SEQ}: "
            f"{packed.num_windows} rows, {corpus_report['documents_per_row']:.3f} documents "
            f"(or pieces) per row, padding share {corpus_report['padding_share']:.4f}")
        lap("corpus")

        # (c) the kernels at the packed pass, with the segment ids of the
        # fit's first minibatch, and at the 8k pass
        import numpy as np

        from tpu_parallel_torch.data import DataLoader

        fit_config, plumbing = _shell_config("gpt2_125m_corpus")
        loader = DataLoader(packed, fit_config.global_batch_size, seed=seed,
                            holdout_fraction=plumbing["eval_fraction"], device="cuda")
        batch = loader.batch_at(0)
        seg = batch.segment_ids[:PACKED_SHAPE[0]]
        gen = torch.Generator(device="cuda").manual_seed(seed + 20)
        rows = dict(packed_fwd=fwd_kernel_row("t_packed_pass", PACKED_SHAPE, gen, seg=seg),
                    packed_bwd=bwd_kernel_row("t_packed_pass", PACKED_SHAPE, gen, seg=seg,
                                              main_path=True),
                    long_fwd=fwd_kernel_row("t_long_pass", LONG_SHAPE, gen),
                    long_bwd=bwd_kernel_row("t_long_pass", LONG_SHAPE, gen, main_path=True))
        lap("kernels")

        fit, packed_launches, trained = packed_fit_leg(seed, work, corpus)
        lap("packed_fit")
        log(f"[trainer fit] gpt2_125m_corpus packed, {FIT_STEPS} steps of [32, 1024] in 2 "
            f"minibatches: losses {[round(x, 4) for x in fit['losses']]}; launches per step "
            f"(flash_fwd, flash_bwd) {fit['launches_per_step']} in every step; evaluation "
            f"launches per call {fit['eval_launches']}; evals "
            f"{[(s, round(m['eval_loss'], 4)) for s, m in fit['evals']]}; best {fit['best']}; "
            f"main-path launches {fit['launches']}; fit {fit['fit_s']:.1f} s")
        log(f"[trainer resume] restored step {FIT_STEPS} bitwise ({fit['restored_bitwise']}) "
            f"in {fit['restore_ms']:.1f} ms from {fit['checkpoint_bytes']} bytes on disk; "
            f"resumed losses {[round(x, 4) for x in fit['resume_losses']]}")
        log(f"[trainer rollback] failure injected at step {FAIL_AT}: batches requested "
            f"{fit['rollback']['batches_requested']}, ended at {fit['rollback']['ended_at']}")
        sv = fit["save"]
        log(f"[trainer save] {sv['bytes']} bytes: blocking snapshot {sv['blocking_ms']:.1f} ms "
            f"(copies done {sv['snapshot_copied_ms']:.1f} ms), background write to done "
            f"{sv['write_to_done_ms']:.1f} ms; eval {fit['eval_ms_per_batch']:.2f} ms per "
            f"batch of [32, 1024]")
        for kind in ("packed", "flat"):
            p = fit["step_profile"][kind]
            log(f"[trainer step {kind}] {fit['step_ms'][kind]} ms per step (two windows of "
                f"{TIMED_STEPS}); profile: wall {p['wall_ms']:.1f} ms, device busy "
                f"{p['busy_ms']:.1f} ms, flash fwd {p['flash_fwd_ms']:.2f} ms, flash bwd "
                f"{p['flash_bwd_ms']:.2f} ms, kernels' share {p['kernel_share']}")
        log(f"  packed rows carry {fit['segments_per_row']:.2f} segments on average")

        long, long_launches = long_leg(seed, corpus)
        lap("long")
        c = long["chunk_vs_full"]
        log(f"[trainer 8k] gpt2_125m_long, {2 + TIMED_STEPS} steps of [16, 8192] in 8 "
            f"minibatches: losses {[round(x, 4) for x in long['losses']]}; launches per step "
            f"{long['launches_per_step']}; {long['step_ms']:.1f} ms per step, "
            f"{long['tokens_per_s']:.0f} tokens/s, MFU {long['mfu']}; max memory allocated "
            f"{long['max_memory_allocated'] / 2**30:.2f} GiB")
        log(f"  one minibatch [2, 8192], loss_chunk=1024 against 0: |loss diff| "
            f"{c['loss_diff']:.2e} (tol {LOSS_TOL}), worst gradient {c['worst_grad_rel']:.3e} "
            f"({c['worst_weight']}, tol {TRAIN_GRAD_TOL}); peak memory chunked "
            f"{c['peak_memory']['chunked'] / 2**30:.2f} GiB, full "
            f"{c['peak_memory']['full'] / 2**30:.2f} GiB")

        cli_launched = cli_launch(work, corpus)
        eval_batches = [loader.eval_view().batch_at(i) for i in range(2)]
        opt = optimizer_leg(seed, batch, eval_batches)
        lap("optimizers_dropout")
        for name in ("lion", "sgd"):
            log(f"[trainer {name}] losses {[round(x, 4) for x in opt[name]['losses']]} "
                f"({ {k: v for k, v in opt[name].items() if k != 'losses'} })")
        e = opt["ema"]
        log(f"[trainer ema 0.99] losses {[round(x, 4) for x in e['losses']]}; shadow max |ema - "
            f"master| {e['shadow_max_abs_from_masters']:.3e}; evaluate {e['evaluate']} against "
            f"a plain forward on the EMA weights {e['plain_forward']} (bitwise {e['bitwise']}); "
            f"module weights bitwise unchanged")
        d = opt["dropout"]
        log(f"[trainer dropout 0.1] losses {[round(x, 4) for x in d['losses']]}; two evaluations "
            f"bitwise equal {d['evaluate']}; proj_attn against remat off, same generator state: "
            f"|loss diff| {d['proj_attn_vs_no_remat'][0]:.2e}, worst gradient "
            f"{d['proj_attn_vs_no_remat'][1]:.3e}; another generator state "
            f"{d['another_generator_state'][1]:.3e} (tol {TRAIN_GRAD_TOL})")
        log(f"[trainer dots] against proj_attn: |loss diff| {opt['dots_vs_proj_attn'][0]:.2e}, "
            f"worst gradient {opt['dots_vs_proj_attn'][1]:.3e}; one minibatch [16, 1024] "
            f"fwd+bwd: " + ", ".join(f"{k} {v['ms']:.1f} ms peak +{v['peak_gib']:.2f} GiB"
                                     for k, v in opt["policies"].items()))

        tokens = np.memmap(corpus, dtype=np.uint16, mode="r")
        prompts = [[int(t) for t in tokens[o:o + SERVE_PROMPT_LEN]]
                   for o in np.linspace(0, n_tokens // 2, SERVE_PROMPTS, dtype=np.int64)]
        serve = serve_weights_leg(seed, work, trained, prompts)
        del trained
        lap("serve_weights")
        log(f"[trainer weights] manifest {serve['manifest']} saved in {serve['save_s']:.1f} s "
            f"and verified; a flipped byte refused: {serve['refused']}; served through "
            f"rebind_params: {serve['requests']}")

        cli = cli_check(cli_launched)
        lap("cli")
        log(f"[trainer cli] python -m tpu_parallel_torch.train exited 0, collected "
            f"{cli['wall_s']:.1f} s after its launch (beside the legs above); "
            f"trace has data_wait and compute spans, metrics train_loss; {cli['stdout_tail']}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    phase_s = time.perf_counter() - start
    log(f"[trainer] phase 11 took {phase_s:.1f} s ("
        + ", ".join(f"{k} {v:.1f}" for k, v in legs_s.items()) + ")")
    log(f"card: {smi}")
    report = dict(corpus=corpus_report, fit=fit, long=long, optimizers=opt, serve=serve, cli=cli,
                  phase_s=phase_s, legs_s=legs_s)
    return report, rows, dict(training_packed=packed_launches, training_long=long_launches)


# phase 12: data parallelism on the card (GPT-2 125M, ``gpt2_125m_dp``).  One
# H100, and NCCL puts no two ranks on one GPU: (a) runs the DP step at full
# width in an NCCL group of one, (b) two gloo ranks on the one card, (c) the
# CLI under torchrun.  Each leg is a subprocess of this script printing one
# JSON line, so no process group outlives its leg.
DP_STEPS = 3  # leg (a)'s counted steps
DP_TIMED = 3  # leg (a)'s timed steps, with and without the group
DP_SHAPE = (64, 12, 12, 1024, 64, dict(causal=True), False, 10)  # the kernels' shape in leg (a)
# leg (b): each rank's 32 rows of a [64, 1024] batch in two minibatches, so
# the two processes and the reference fit on the one card together
DP_PAIR_BATCHES, DP_PAIR_MINIBATCHES = 2, 2
DP_LEG_TIMEOUT = 600
DP_RESULT = "dp-leg-result: "


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _dp_config(**changes):
    config, _ = _shell_config("gpt2_125m_dp", seed=SEED, **changes)
    return config


def _dp_batches(n, vocab, device):
    """``n`` seeded global batches of [64, 1024]."""
    from tpu_parallel_torch.data import lm_batch

    return [lm_batch(torch.Generator().manual_seed(SEED + 40 + i), 64, SHELL_SEQ, vocab,
                     device=device) for i in range(n)]


def _every_other(batch, rank, world):
    """Rows ``rank::world`` of every field, the DataLoader's per-rank rows."""
    import dataclasses

    return type(batch)(**{f.name: None if getattr(batch, f.name) is None
                          else getattr(batch, f.name)[rank::world].contiguous()
                          for f in dataclasses.fields(batch)})


def _digest(state):
    """sha256 of the masters and AdamW's two moments, bytes in name order."""
    import hashlib

    h = hashlib.sha256()
    opt = state.opt_state[-1]
    for tree in (state.params, opt["mu"], opt["nu"]):
        for name in sorted(tree):
            h.update(tree[name].detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _timed_dp_steps(trainer, batch, n):
    """Host ms (each step ended by a synchronize) and CUDA-event device ms
    per step over ``n`` steps."""
    host, device = [], []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        trainer.step_fn(trainer.state, None, batch)
        end.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        device.append(start.elapsed_time(end))
    return host, device


def dp_nccl_leg():
    """Leg (a), in its own process under torchrun's environment for one
    rank: ``initialize()``, ``Trainer(gpt2_125m_dp)`` over
    ``make_mesh(MeshConfig(data=-1))``, DP_STEPS counted steps on a fixed
    seeded batch, then the timed steps, the all-reduce alone on the flat
    fp32 gradient buffer; phase 13 (a) in the same group
    (:func:`fsdp_nccl_part`, under the key ``"fsdp"``: one process start
    for both); and the DP steps with no group."""
    import torch.distributed as dist

    from tpu_parallel_torch.core.metrics import compute
    from tpu_parallel_torch.ops import flash_attention as fa
    from tpu_parallel_torch.parallel import dp
    from tpu_parallel_torch.runtime import MeshConfig, initialize, make_mesh, process_info
    from tpu_parallel_torch.train_lib import Trainer

    initialize()
    info = process_info()
    if info["backend"] != "nccl" or info["process_count"] != 1:
        raise AssertionError(f"leg (a) wants an NCCL group of one: {info}")
    config = _dp_config()
    mesh = make_mesh(MeshConfig(data=-1))
    trainer = Trainer(config, mesh, device="cuda")
    state = trainer.init()
    batch = trainer.example_batch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()  # the main path starts here
    dp.dp_allreduce_launches = 0
    per_step, losses = [], []
    for _ in range(DP_STEPS):
        before = _launch_counts()
        state, metrics = trainer.step_fn(state, None, batch)
        per_step.append([a - b for a, b in zip(_launch_counts(), before)])
        losses.append(compute(metrics)["loss"])
    torch.cuda.synchronize()
    launches = dict(zip(LAUNCH_COUNTERS, _launch_counts()))
    allreduces = dp.dp_allreduce_launches
    peak = torch.cuda.max_memory_allocated()
    want = trainer.model_config.n_layers * config.num_minibatches
    if allreduces != DP_STEPS:
        raise AssertionError(f"dp_allreduce_launches {allreduces} over {DP_STEPS} steps")
    if any(n != [want, want] for n in per_step):
        raise AssertionError(f"launches per step (fwd, bwd) {per_step}, want {want} each")
    _falls("leg (a)", losses)
    host, device = _timed_dp_steps(trainer, batch, DP_TIMED)
    group = mesh.get_group("data")
    flat = state.flat_grads
    allreduce_ms = cuda_ms(lambda: dist.all_reduce(flat, group=group), 10)
    result = dict(process_info=info, losses=losses, launches_per_step=per_step,
                  launches=launches, dp_allreduce_launches=allreduces,
                  flat_grad_bytes=flat.numel() * flat.element_size(),
                  allreduce_ms=allreduce_ms, step_host_ms=host, step_device_ms=device,
                  max_memory_allocated=peak, mesh_shape=list(mesh.shape),
                  device=str(trainer.device))
    del trainer, state, flat, batch
    gc.collect()
    torch.cuda.empty_cache()
    result["fsdp"] = fsdp_nccl_part(info)
    gc.collect()
    torch.cuda.empty_cache()
    dist.destroy_process_group()
    alone = Trainer(config, device="cuda")
    if alone.mesh is not None:
        raise AssertionError("a Trainer without a group has a mesh")
    alone.init()
    alone.step_fn(alone.state, None, alone.example_batch)
    host, device = _timed_dp_steps(alone, alone.example_batch, DP_TIMED)
    result.update(no_group_step_host_ms=host, no_group_step_device_ms=device)
    return result


def _stage_gloo_through_host():
    """Probe whether this build's gloo takes CUDA tensors; where it does
    not, wrap ``all_reduce`` and ``broadcast`` so that a CUDA tensor goes
    through a pinned host copy (this leg's own staging, not a path of the
    port).  Returns True when gloo took the CUDA tensor itself."""
    import torch.distributed as dist

    try:
        probe = torch.ones(1, device="cuda:0")
        dist.all_reduce(probe)
        torch.cuda.synchronize()
        if probe.item() != dist.get_world_size():
            raise RuntimeError(f"gloo all_reduce of a CUDA tensor gave {probe.item()}")
        return True
    except RuntimeError:
        pass
    plain = {name: getattr(dist, name) for name in ("all_reduce", "broadcast")}

    def staged(name):
        def collective(tensor, *args, **kwargs):
            if not tensor.is_cuda:
                return plain[name](tensor, *args, **kwargs)
            host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
            host.copy_(tensor)
            plain[name](host, *args, **kwargs)
            tensor.copy_(host)
        return collective

    for name in plain:
        setattr(dist, name, staged(name))
    return False


def dp_pair_leg(rank, rendezvous, workdir):
    """Leg (b), one of two ranks on the one card: a gloo group over CUDA
    tensors on ``cuda:0``.  Each rank steps on rows ``rank::2`` of the same
    DP_PAIR_BATCHES global batches; it reports a digest of its masters and
    moments after every step, its all-reduce time and its peak memory, and
    rank 0 saves the step-1 gradients, the losses and the final masters
    for the reference run."""
    import torch.distributed as dist

    from tpu_parallel_torch.core.metrics import compute
    from tpu_parallel_torch.runtime import MeshConfig, initialize, make_mesh, process_info
    from tpu_parallel_torch.train_lib import Trainer

    initialize(rendezvous, 2, rank, backend="gloo", device="cuda:0")
    _share_cores(2)
    info = process_info()
    gloo_cuda = _stage_gloo_through_host()
    config = _dp_config(num_minibatches=DP_PAIR_MINIBATCHES)
    trainer = Trainer(config, make_mesh(MeshConfig(data=2)), device="cuda:0")
    state = trainer.init()
    batches = _dp_batches(DP_PAIR_BATCHES, trainer.model_config.vocab_size, "cuda:0")
    torch.cuda.reset_peak_memory_stats()
    digests, losses, grads, masters = [], [], None, []
    for batch in batches:
        state, metrics = trainer.step_fn(state, None, _every_other(batch, rank, 2))
        losses.append(compute(metrics)["loss"])
        digests.append(_digest(state))
        if grads is None:
            grads = state.flat_grads.to("cpu", copy=True)
        if rank == 0:  # phase 13 (b) holds its FSDP pair to these
            masters.append({n: p.to("cpu", copy=True) for n, p in state.params.items()})
    peak = torch.cuda.max_memory_allocated()
    flat = state.flat_grads
    dist.barrier()
    host = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce(flat)
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    if rank == 0:
        torch.save(dict(grads=grads, losses=losses, masters=masters[-1], masters_by_step=masters),
                   Path(workdir, "pair.pt"))
    dist.barrier()
    dist.destroy_process_group()
    return dict(rank=rank, process_info=info, gloo_takes_cuda=gloo_cuda, losses=losses,
                digests=digests,
                allreduce_host_ms=host, flat_grad_bytes=flat.numel() * flat.element_size(),
                max_memory_allocated=peak)


def dp_pair_reference_leg(workdir):
    """Leg (b)'s reference: one process, no group, the same init and global
    batches (all 64 rows, DP_PAIR_MINIBATCHES minibatches), against what
    rank 0 saved: the losses within LOSS_TOL, the step-1 gradients per
    weight within TRAIN_GRAD_TOL (relative L2, the qkv bias's key slice
    left out), and the final masters by the loss they give on a third
    batch (within LOSS_TOL), with their update's relative error printed."""
    from tpu_parallel_torch.core.metrics import compute
    from tpu_parallel_torch.models import GPTLM
    from tpu_parallel_torch.models.gpt import make_gpt_loss
    from tpu_parallel_torch.train_lib import Trainer

    pair = torch.load(Path(workdir, "pair.pt"), weights_only=True)
    config = _dp_config(num_minibatches=DP_PAIR_MINIBATCHES)
    trainer = Trainer(config, device="cuda")
    state = trainer.init()
    cfg = trainer.model_config
    start = {n: p.detach().clone() for n, p in state.params.items()}
    batches = _dp_batches(DP_PAIR_BATCHES + 1, cfg.vocab_size, "cuda")
    losses, grads = [], None
    for batch in batches[:-1]:
        state, metrics = trainer.step_fn(state, None, batch)
        losses.append(compute(metrics)["loss"])
        if grads is None:
            grads = {n: g.detach().clone() for n, g in state.grads.items()}
    dh = cfg.head_dim
    not_key = (torch.arange(3 * cfg.d_model, device="cuda") % (3 * dh)) // dh != 1
    offsets, grad_rel, update_rel = 0, {}, {}
    pair_grads = pair["grads"].cuda()
    for name, g in grads.items():
        got = pair_grads[offsets:offsets + g.numel()].view_as(g)
        offsets += g.numel()
        upd_got = pair["masters"][name].cuda() - start[name]
        upd_want = state.params[name] - start[name]
        if name.endswith("attn.qkv.bias"):
            got, g = got[not_key], g[not_key]
            upd_got, upd_want = upd_got[not_key], upd_want[not_key]
        grad_rel[name] = ((got - g).norm() / g.norm().clamp(min=1e-30)).item()
        update_rel[name] = ((upd_got - upd_want).norm() / upd_want.norm().clamp(min=1e-30)).item()
    loss_fn = make_gpt_loss(cfg, train=False)
    dp_model = GPTLM(cfg, device="cuda")
    dp_model.load_state_dict({n: p.cuda() for n, p in pair["masters"].items()})
    with torch.no_grad():
        eval_dp = loss_fn(dp_model, batches[-1])[0].item()
        eval_ref = loss_fn(trainer.model, batches[-1])[0].item()
    worst = max(grad_rel, key=grad_rel.get)
    result = dict(losses=losses, pair_losses=pair["losses"],
                  loss_diffs=[abs(a - b) for a, b in zip(losses, pair["losses"])],
                  step1_grad_rel_max=(grad_rel[worst], worst),
                  step1_grad_rel_median=sorted(grad_rel.values())[len(grad_rel) // 2],
                  update_rel_max=max(update_rel.values()),
                  update_rel_median=sorted(update_rel.values())[len(update_rel) // 2],
                  eval_loss_dp=eval_dp, eval_loss_ref=eval_ref)
    if max(result["loss_diffs"]) > LOSS_TOL or grad_rel[worst] > TRAIN_GRAD_TOL \
            or abs(eval_dp - eval_ref) > LOSS_TOL:
        raise AssertionError(f"two ranks disagree with one: {result}")
    return result


def _run_leg(args, env=None, timeout=DP_LEG_TIMEOUT):
    """Run ``chip_smoke.py --leg ...`` and return its JSON result; a
    non-zero exit raises with the leg's output."""
    import os

    here = Path(__file__).resolve().parent
    out = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--leg", *args],
                         cwd=here, env=dict(os.environ, PYTHONPATH=str(here), **(env or {})),
                         capture_output=True, text=True, timeout=timeout)
    if out.returncode != 0:
        raise AssertionError(f"leg {args} exited {out.returncode}: "
                             f"{out.stdout[-3000:]}\n{out.stderr[-5000:]}")
    lines = [line for line in out.stdout.splitlines() if line.startswith(DP_RESULT)]
    return json.loads(lines[-1][len(DP_RESULT):])


# the legs that run as several rank processes; each is started early by
# _spawn_ranks, imports what the legs use (torch's first selective checkpoint
# imports torch._dynamo) and waits for _join_ranks to let it run
RANK_LEGS = ("dp_pair", "fsdp_pair", "tp_pair", "pp_rank", "sp_rank", "moe_rank", "llama_rank")
RANK_START_TIMEOUT = 1200


def _spawn_ranks(leg, work, n):
    """Start ``n`` processes of ``chip_smoke.py --leg <leg> <rank>
    <rendezvous> <work>`` (a file rendezvous in ``work``) now, so that their
    start-up (interpreter, imports) overlaps the caller's own work; they
    wait for :func:`_join_ranks` before joining the group."""
    import tempfile

    rendezvous = f"file://{Path(work, leg + '_rendezvous')}"
    files = [(tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")) for _ in range(n)]
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--leg", leg, str(r), rendezvous, work],
        cwd=Path(__file__).resolve().parent, stdout=out, stderr=err, text=True)
        for r, (out, err) in enumerate(files)]
    _SPAWNED.extend(procs)
    return dict(leg=leg, work=work, procs=procs, files=files)


def _wait_to_run(leg, work):
    """A rank of ``leg`` (:data:`RANK_LEGS`): import what the legs use, then
    wait until :func:`_join_ranks` lets the ranks run."""
    import torch._dynamo  # noqa: F401
    import tpu_parallel_torch.train_lib  # noqa: F401

    go = Path(work, leg + "_go")
    deadline = time.perf_counter() + RANK_START_TIMEOUT
    while not go.exists():
        if time.perf_counter() > deadline:
            raise SystemExit(f"{leg}: never told to run")
        time.sleep(0.05)


def _join_ranks(spawned, timeout):
    """Let :func:`_spawn_ranks`' processes run and return their JSON
    results.  A rank that exits non-zero fails the leg at once, every other
    rank killed (its peers would wait on it forever), and so does the
    timeout; the error holds the ranks' output."""
    leg, procs, files = spawned["leg"], spawned["procs"], spawned["files"]
    Path(spawned["work"], leg + "_go").touch()
    deadline = time.perf_counter() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs) \
                    or time.perf_counter() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for out, err in files:
        out.seek(0)
        err.seek(0)
        outs.append((out.read(), err.read()))
        out.close()
        err.close()
    if any(p.returncode != 0 for p in procs):
        raise AssertionError(f"{leg} ranks failed (timeout {timeout} s): " + "\n".join(
            f"rank {r} exit {p.returncode}: {o[0][-1500:]}\n{o[1][-4000:]}"
            for r, (p, o) in enumerate(zip(procs, outs))))
    return [json.loads([line for line in o[0].splitlines()
                        if line.startswith(DP_RESULT)][-1][len(DP_RESULT):]) for o in outs]


def _reference(leg, work):
    """A one-process reference leg run in this process (no group; it has
    its own legs' imports and first calls behind it, which a fresh
    process would pay again), its memory released after."""
    result = leg(work)
    gc.collect()
    torch.cuda.empty_cache()
    return result


def _share_cores(n):
    """One of ``n`` ranks sharing the host: its share of the cores it may
    run on for torch's intra-op threads (each rank taking all of them
    thrashes)."""
    import os

    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // n))


# the torchrun CLI legs of phases 12-18 each start their processes, build
# their model and run 2-3 steps: they run together, at CLI_ROWS rows, from
# the start of phase 9 (phases 9 and 10 hold under 4 GiB of the card; the
# batch takes over a minute, most of it its processes' start-up) on all but
# MAIN_CORES of the host's cores, and all are collected in phase 12 after
# (b)'s reference (phase 11's CLI, whose evaluation needs 6 GiB of logits,
# ran out of memory beside them on a crowded card, so it runs in phase 11)
CLI_ROWS = 8
# and at CLI_LAYERS of their models' layers (the run's time limit): they
# hold the CLI's plumbing, which depth does not change
CLI_LAYERS = 2
# the host cores left to this process while the CLI batch runs beside
# phases 9 and 10
MAIN_CORES = 2


_LAUNCHED = []  # every _launch'ed process, killed by main's exit if still running
_SPAWNED = []  # every _spawn_ranks process, killed likewise


def _launch(cmd, cores=None):
    """Start ``cmd`` from the script's directory (``PYTHONPATH`` there) in a
    session of its own, its output into temporary files (a pipe nobody
    reads until :func:`_finish` could fill and stall it); on the host
    cores ``cores`` (all it inherits when None), which its children
    inherit."""
    import os
    import tempfile

    here = Path(__file__).resolve().parent
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    proc = subprocess.Popen(cmd, cwd=here, env=dict(os.environ, PYTHONPATH=str(here)),
                            stdout=out, stderr=err, text=True, start_new_session=True)
    if cores is not None:  # set before torchrun, still importing, starts its workers
        os.sched_setaffinity(proc.pid, cores)
    _LAUNCHED.append(proc)
    return proc, out, err, time.perf_counter()


def _kill_launched():
    """Kill the session of every launched process still running."""
    import os
    import signal

    for proc in _LAUNCHED:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    for proc in _SPAWNED:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _finish(launched, what):
    """``(stdout, s from the launch to this collection)`` of a
    :func:`_launch`ed command; a non-zero exit raises with its output, and
    on the leg timeout its whole session is killed (torchrun's workers
    too)."""
    import os
    import signal

    proc, out_file, err_file, start = launched
    try:
        proc.wait(timeout=DP_LEG_TIMEOUT)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    out_file.seek(0)
    err_file.seek(0)
    out, err = out_file.read(), err_file.read()
    out_file.close()
    err_file.close()
    if proc.returncode != 0:
        raise AssertionError(f"{what} exited {proc.returncode}: {out[-2000:]}\n{err[-3000:]}")
    return out, time.perf_counter() - start


def _torchrun(*args):
    return [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=1",
            *args]


def dp_cli_leg(work, cores):
    """Leg (c), launched: ``python -m torch.distributed.run --standalone
    --nproc_per_node=1 -m tpu_parallel_torch.train --config=gpt2_125m_dp``
    for DP_STEPS steps on CLI_ROWS rows; :func:`dp_cli_check` holds it."""
    metrics = Path(work, "dp_metrics.prom")
    return _launch(_torchrun("-m", "tpu_parallel_torch.train", "--config=gpt2_125m_dp",
                             f"--config.steps={DP_STEPS}",
                             f"--config.model_overrides.n_layers={CLI_LAYERS}",
                             f"--config.global_batch_size={CLI_ROWS}",
                             f"--metrics-out={metrics}"), cores), metrics


def _collect_clis(clis):
    """Wait for every launched CLI leg (``{name: (launched, metrics)}``):
    ``{name: ((stdout, s from its launch), metrics)}``, which each leg's
    check then holds.  A non-zero exit raises here."""
    return {name: (_finish(launched, f"torchrun ({name})"), metrics)
            for name, (launched, metrics) in clis.items()}


def dp_cli_check(collected):
    """Leg (c): exit 0, a topology line with one process and NCCL,
    ``train_loss`` in its metrics."""
    (out, wall), metrics = collected
    topology = [json.loads(line[len("topology: "):]) for line in out.splitlines()
                if line.startswith("topology: ")]
    if len(topology) != 1 or topology[0]["process_count"] != 1 \
            or topology[0]["backend"] != "nccl":
        raise AssertionError(f"CLI topology lines {topology}")
    if "train_loss" not in metrics.read_text():
        raise AssertionError("CLI metrics without train_loss")
    return dict(wall_s=wall, topology=topology[0], stdout_tail=out.strip().splitlines()[-2:])


def cli_batch(work):
    """Launch leg (c) and phases 13-18's CLI legs together, in the
    directory ``work``, on all but the first MAIN_CORES of the host cores
    this process may run on (all of them on a host with fewer than twice
    as many): ``{name: (launched, metrics)}`` for :func:`dp_phase`."""
    import os

    cores = sorted(os.sched_getaffinity(0))
    cores = set(cores[MAIN_CORES:] if len(cores) >= 2 * MAIN_CORES else cores)
    return dict(dp=dp_cli_leg(work, cores), fsdp=fsdp_cli_leg(work, cores),
                tp=tp_cli_leg(work, cores), pp=pp_cli_leg(work, cores),
                sp=sp_cli_leg(work, cores), llama=llama_cli_leg(work, cores))


def dp_phase(smi, work, clis):
    """Phase 12: the kernels at the DP step's shape against their plain
    versions, then legs (a), (b) and (c), in the directory ``work`` (leg
    (b)'s ``pair.pt`` stays there for phase 13).  ``clis`` (from
    :func:`cli_batch`, launched at phase 9) are collected after leg (b)'s
    reference.  Returns the report, the kernels' rows, leg (a)'s launches,
    the collected CLI legs of phases 13-18 and phase 13's pair (started
    here, waiting to run)."""
    start = time.perf_counter()
    legs_s = {}

    def lap(name):
        legs_s[name] = time.perf_counter() - start - sum(legs_s.values())

    gen = torch.Generator(device="cuda").manual_seed(SEED + 30)
    rows = dict(fwd=fwd_kernel_row("t_dp_pass", DP_SHAPE, gen),
                bwd=bwd_kernel_row("t_dp_pass", DP_SHAPE, gen, main_path=True))
    gc.collect()
    torch.cuda.empty_cache()
    lap("kernels")
    pair = _spawn_ranks("dp_pair", work, 2)
    # phase 13's pair starts up now too and waits for its turn
    fsdp_pair = _spawn_ranks("fsdp_pair", work, 2)
    env = dict(WORLD_SIZE="1", RANK="0", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()))
    nccl = _run_leg(["dp_nccl"], env=env)
    nccl_fsdp = nccl.pop("fsdp")  # phase 13 (a), printed there
    lap("nccl")
    log(f"[dp nccl] {nccl['process_info']}; mesh {nccl['mesh_shape']} on {nccl['device']}; "
        f"gpt2_125m_dp [64, 1024] in 1 minibatch, losses "
        f"{[round(x, 5) for x in nccl['losses']]}; launches per step (flash_fwd, flash_bwd) "
        f"{nccl['launches_per_step']}; dp_allreduce_launches {nccl['dp_allreduce_launches']} "
        f"over {DP_STEPS} steps")
    log(f"  step with the group: host ms {[round(x, 2) for x in nccl['step_host_ms']]}, device "
        f"ms {[round(x, 2) for x in nccl['step_device_ms']]}; without a group: host ms "
        f"{[round(x, 2) for x in nccl['no_group_step_host_ms']]}, device ms "
        f"{[round(x, 2) for x in nccl['no_group_step_device_ms']]}; all-reduce of the flat "
        f"fp32 buffer ({nccl['flat_grad_bytes']} bytes) alone {nccl['allreduce_ms']:.4f} device "
        f"ms; max memory allocated {nccl['max_memory_allocated'] / 2**30:.2f} GiB")
    pair = _join_ranks(pair, DP_LEG_TIMEOUT)
    if pair[0]["digests"] != pair[1]["digests"]:
        raise AssertionError(f"leg (b) replicas differ: {pair[0]['digests']} against "
                             f"{pair[1]['digests']}")
    if pair[0]["losses"] != pair[1]["losses"]:
        raise AssertionError(f"leg (b) ranks' synced losses differ: {pair}")
    lap("pair")
    # phases 12-18's CLI legs, launched at phase 9, are all collected here,
    # before the timed legs of phases 13-18
    ref = _reference(dp_pair_reference_leg, work)
    lap("pair_reference")
    clis = _collect_clis(clis)
    lap("cli_collect")
    how = ("gloo over CUDA tensors" if pair[0]["gloo_takes_cuda"]
           else "gloo staged through pinned host copies (it refused CUDA tensors)")
    log(f"[dp two ranks] {how}, two processes on cuda:0 "
        f"({pair[0]['process_info']}); rows r::2 of {DP_PAIR_BATCHES} batches of [64, 1024], "
        f"{DP_PAIR_MINIBATCHES} minibatches per rank: masters and moments bitwise equal "
        f"after every step ({[d[:12] for d in pair[0]['digests']]}); losses "
        f"{[round(x, 5) for x in pair[0]['losses']]} against one process's "
        f"{[round(x, 5) for x in ref['losses']]} (|diff| {ref['loss_diffs']}, tol "
        f"{LOSS_TOL})")
    log(f"  step-1 gradients against one process: relative L2 per weight median "
        f"{ref['step1_grad_rel_median']:.3e}, max {ref['step1_grad_rel_max'][0]:.3e} "
        f"({ref['step1_grad_rel_max'][1]}), tol {TRAIN_GRAD_TOL}; final masters' update "
        f"relative error median {ref['update_rel_median']:.3e}, max "
        f"{ref['update_rel_max']:.3e}; their loss on a third batch {ref['eval_loss_dp']:.6f} "
        f"against {ref['eval_loss_ref']:.6f} (tol {LOSS_TOL})")
    log("  all-reduce of the flat fp32 buffer through gloo (host ms per call): "
        + "; ".join(f"rank {p['rank']} {[round(x, 1) for x in p['allreduce_host_ms']]}"
                    for p in pair)
        + "; max memory allocated "
        + ", ".join(f"{p['max_memory_allocated'] / 2**30:.2f} GiB" for p in pair))
    cli = dp_cli_check(clis.pop("dp"))
    log(f"[dp cli] torchrun --standalone --nproc_per_node=1 -m tpu_parallel_torch.train "
        f"--config=gpt2_125m_dp --config.steps={DP_STEPS} --config.model_overrides.n_layers="
        f"{CLI_LAYERS} --config.global_batch_size={CLI_ROWS} (with phases 13-18's CLI legs "
        f"from the start of phase 9): exit 0, "
        f"collected {cli['wall_s']:.1f} s after its launch; "
        f"topology {cli['topology']}; metrics have train_loss; {cli['stdout_tail']}")
    phase_s = time.perf_counter() - start
    log(f"[dp] phase 12 took {phase_s:.1f} s ("
        + ", ".join(f"{k} {v:.1f}" for k, v in legs_s.items()) + ")")
    log(f"card: {smi}")
    return dict(nccl=nccl, nccl_fsdp=nccl_fsdp, pair=pair, pair_reference=ref, cli=cli,
                phase_s=phase_s,
                legs_s=legs_s), rows, nccl["launches"], clis, fsdp_pair

# phase 13: FSDP on the card (``gpt2_125m_dp`` with ``model_overrides.fsdp``:
# ZeRO-3 over the data axis).  The same three-process layout as phase 12:
# (a) an NCCL group of one, (b) two gloo ranks sharing the card, then (c)
# a sharded checkpoint and (d) the export, in (b)'s ranks, and (e) the CLI
# under torchrun.
FSDP_STEPS = 3  # leg (a)'s counted steps
FSDP_TIMED = 3  # leg (a)'s timed steps
FSDP_PROMPTS = (4, 32, 16)  # leg (d): prompts, prompt tokens, new tokens
# leg (b) against phase 12's DP pair, per weight, relative L2, set from
# earlier readings on an H100 80GB HBM3 at 700 W (gathered masters of
# non-zero init within 1.8e-5; their updates' error median 3.3e-3, max
# 3.1e-2, flash dq's atomics through AdamW's first steps).  A state whose
# shards never moved misses the update limits (an error of 1) and the
# masters' (the update, about 1e-3 of a weight).
FSDP_MASTER_TOL = 2e-4
FSDP_UPDATE_MEDIAN_TOL = 1e-2
FSDP_UPDATE_MAX_TOL = 1e-1
# leg (c): device memory a sharded save may add (its snapshot is on the
# host), and the blocking time of a save with the pinned blocks cached
FSDP_SAVE_DEVICE_BYTES = 64 * 2**20
FSDP_SAVE_BLOCKING_MS = 100.0


def _fsdp_config(**changes):
    overrides = dict(fsdp=True, **changes.pop("model_overrides", {}))
    return _dp_config(model_overrides=overrides, **changes)


def _named_trees(state):
    """The state's dicts by parameter name: masters, accumulators, the
    optimizer's moments, the EMA shadow and the module's weights."""
    trees = [state.params, state.grads, dict(state.model.named_parameters())]
    if state.ema_params is not None:
        trees.append(state.ema_params)

    def walk(node):
        if isinstance(node, dict):
            if node.keys() == state.params.keys():
                trees.append(node)
            else:
                for v in node.values():
                    walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)

    walk(state.opt_state)
    return trees


def _state_bytes(state):
    """This rank's bytes of the state's tensors (:func:`_named_trees`),
    split into FSDP-sharded leaves and replicated ones."""
    out = dict(sharded=0, replicated=0)
    for tree in _named_trees(state):
        for name, t in tree.items():
            out["sharded" if name in state.shards else "replicated"] += t.numel() * t.element_size()
    return out


def _replicated_digest(state):
    """sha256 of the replicated leaves of every named tree, in name order."""
    import hashlib

    h = hashlib.sha256()
    for tree in _named_trees(state):
        for name in sorted(n for n in tree if n not in state.shards):
            h.update(tree[name].detach().cpu().float().numpy().tobytes())
    return h.hexdigest()


def _collective_counts():
    from tpu_parallel_torch.parallel import dp, fsdp

    return [fsdp.fsdp_allgather_launches, fsdp.fsdp_reducescatter_launches,
            dp.dp_allreduce_launches]


def _unit_collectives(unit, time_fn):
    """Times of one FSDP unit's gather and of the reduce-scatter of its
    packed fp32 gradient, by ``time_fn(fn)``, and their bytes per rank."""
    from tpu_parallel_torch.parallel import fsdp

    info = unit.entries[0][2]
    numel = sum(torch.Size(i.full_shape).numel() for _, _, i in unit.entries)
    full = torch.empty(numel, dtype=torch.float32, device="cuda")
    out = torch.empty(numel // info.size, dtype=torch.float32, device="cuda")
    dtype = unit.entries[0][0]._parameters[unit.entries[0][1]].dtype
    with torch.no_grad():
        gather = time_fn(unit.gather)
        scatter = time_fn(lambda: fsdp._reduce_scatter(out, full, group=info.group))
    return dict(gather=gather, reduce_scatter=scatter,
                gather_bytes=numel * torch.empty((), dtype=dtype).element_size(),
                reduce_scatter_bytes=numel * 4)


def fsdp_nccl_part(info):
    """Leg (a), in phase 12 (a)'s process and NCCL group of one:
    ``Trainer(gpt2_125m_dp, fsdp=True)`` over ``make_mesh(
    MeshConfig(data=-1))``, FSDP_STEPS counted steps on the fixed seeded
    batch of phase 12 (a), then the timed steps, one block's and the
    lm_head's gather and reduce-scatter alone, the state's bytes."""
    from tpu_parallel_torch.core.metrics import compute
    from tpu_parallel_torch.runtime import MeshConfig, make_mesh
    from tpu_parallel_torch.train_lib import Trainer

    config = _fsdp_config()
    mesh = make_mesh(MeshConfig(data=-1))
    trainer = Trainer(config, mesh, device="cuda")
    state = trainer.init()
    if not state.shards:
        raise AssertionError("fsdp=True over a data mesh sharded nothing")
    batch = trainer.example_batch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()  # the main path starts here
    per_step, coll, losses = [], [], []
    for _ in range(FSDP_STEPS):
        before, cbefore = _launch_counts(), _collective_counts()
        state, metrics = trainer.step_fn(state, None, batch)
        per_step.append([a - b for a, b in zip(_launch_counts(), before)])
        coll.append([a - b for a, b in zip(_collective_counts(), cbefore)])
        losses.append(compute(metrics)["loss"])
    torch.cuda.synchronize()
    launches = dict(zip(LAUNCH_COUNTERS, _launch_counts()))
    peak = torch.cuda.max_memory_allocated()
    layers, mb = trainer.model_config.n_layers, config.num_minibatches
    want = [mb * layers, mb * layers]
    want_coll = [mb * (2 * layers + 2), mb * (layers + 2), 1]
    if any(n != want for n in per_step):
        raise AssertionError(f"launches per step (fwd, bwd) {per_step}, want {want}")
    if any(c != want_coll for c in coll):
        raise AssertionError(f"(gathers, reduce-scatters, all-reduces) per step {coll}, "
                             f"want {want_coll}")
    _falls("leg (a)", losses)
    host, device = _timed_dp_steps(trainer, batch, FSDP_TIMED)
    block = _unit_collectives(trainer.model.blocks.layer_0._fsdp_unit,
                              lambda fn: cuda_ms(fn, 10))
    head = _unit_collectives(trainer.model.lm_head._fsdp_unit, lambda fn: cuda_ms(fn, 10))
    embed = _unit_collectives(trainer.model.embed._fsdp_unit, lambda fn: cuda_ms(fn, 10))
    per_step_ms = (mb * (2 * layers * block["gather"] + head["gather"] + embed["gather"])
                   + mb * (layers * block["reduce_scatter"] + head["reduce_scatter"]
                           + embed["reduce_scatter"]))
    result = dict(process_info=info, losses=losses, launches_per_step=per_step,
                  launches=launches, collectives_per_step=coll, block=block, lm_head=head,
                  embed=embed, collective_device_ms_per_step=per_step_ms,
                  state_bytes=_state_bytes(state), n_sharded=len(state.shards),
                  n_replicated=len(state.params) - len(state.shards), step_host_ms=host,
                  step_device_ms=device, max_memory_allocated=peak,
                  mesh_shape=list(mesh.shape), device=str(trainer.device))
    del trainer, state, batch
    return result


def fsdp_pair_leg(rank, rendezvous, workdir):
    """Leg (b), one of two gloo ranks on the one card, each on rows
    ``rank::2`` of phase 12 (b)'s global batches in two minibatches: after
    every step a digest of the replicated leaves and (rank 0) the gathered
    masters against phase 12 (b)'s DP masters (of non-zero init: a
    zero-init leaf's master is its update) and every weight's update from
    the initial masters against DP's; the step-1 gradients against DP's;
    the steps' peak memory; one block's gloo
    gather and reduce-scatter; then (c) a sharded checkpoint restored into
    a fresh Trainer and (d) the export."""
    import torch.distributed as dist

    from tpu_parallel_torch.core.metrics import compute
    from tpu_parallel_torch.parallel.tp import export_single_device_params
    from tpu_parallel_torch.runtime import MeshConfig, initialize, make_mesh, process_info
    from tpu_parallel_torch.train_lib import Trainer

    initialize(rendezvous, 2, rank, backend="gloo", device="cuda:0")
    _share_cores(2)
    info = process_info()
    config = _fsdp_config(num_minibatches=DP_PAIR_MINIBATCHES)
    mesh = make_mesh(MeshConfig(data=2))
    trainer = Trainer(config, mesh, device="cuda:0")
    state = trainer.init()
    cfg = trainer.model_config
    batches = _dp_batches(DP_PAIR_BATCHES, cfg.vocab_size, "cuda:0")
    dp_pair = torch.load(Path(workdir, "pair.pt"), weights_only=True) if rank == 0 else None
    # the initial masters, on the host: the comparisons' buffers stay out of
    # the steps' peak memory
    start = {n: p.to("cpu", copy=True) for n, p in export_single_device_params(
        state.partitioned(state.params)).items()}
    losses, digests, master_rel, update_rel, grad_rel, peak = [], [], [], [], None, 0
    for i, batch in enumerate(batches):
        torch.cuda.reset_peak_memory_stats()
        state, metrics = trainer.step_fn(state, None, _every_other(batch, rank, 2))
        peak = max(peak, torch.cuda.max_memory_allocated())
        losses.append(compute(metrics)["loss"])
        digests.append(_replicated_digest(state))
        full = export_single_device_params(state.partitioned(state.params))
        grads = export_single_device_params(state.partitioned(state.grads)) if i == 0 else None
        if rank == 0:
            m_rel, u_rel, g_rel = _against_dp_pair(cfg, full, grads, start, dp_pair, i)
            master_rel.append(m_rel)
            update_rel.append(u_rel)
            if i == 0:
                grad_rel = g_rel
        del full, grads
    dist.barrier()
    block = _unit_collectives(trainer.model.blocks.layer_0._fsdp_unit,
                              lambda fn: host_ms(fn, 3))
    result = dict(rank=rank, process_info=info, losses=losses, digests=digests,
                  state_bytes=_state_bytes(state), block=block, max_memory_allocated=peak)
    if rank == 0:
        worst = lambda rel: max(rel.items(), key=lambda kv: kv[1])
        result.update(
            dp_losses=dp_pair["losses"],
            master_rel_max=[worst(r) for r in master_rel],
            update_rel_median=[sorted(r.values())[len(r) // 2] for r in update_rel],
            update_rel_max=[worst(r) for r in update_rel],
            step1_grad_rel_max=worst(grad_rel),
            step1_grad_rel_median=sorted(grad_rel.values())[len(grad_rel) // 2])
        del dp_pair
    result.update(checkpoint=_fsdp_checkpoint(trainer, config, mesh, batches[0], rank, workdir))
    result.update(export=_fsdp_export(trainer, rank, workdir))
    dist.barrier()
    dist.destroy_process_group()
    return result


def _against_dp_pair(cfg, full, grads, start, dp_pair, step):
    """Per weight, relative L2 of the gathered masters after ``step``
    against the DP pair's (leaves of non-zero init only: a zero-init
    leaf's master is its update), of their updates from ``start``, and of
    the step-1 gradients (when ``grads``); the qkv bias's key slice left
    out."""
    dh = cfg.head_dim
    not_key = (torch.arange(3 * cfg.d_model, device="cuda:0") % (3 * dh)) // dh != 1
    rel = lambda a, b: ((a - b).norm() / b.norm().clamp(min=1e-30)).item()
    m_rel, u_rel, g_rel = {}, {}, {}
    for name, got in full.items():
        want, init = dp_pair["masters_by_step"][step][name].cuda(), start[name].cuda()
        upd_got, upd_want = got - init, want - init
        if name.endswith("attn.qkv.bias"):
            got, want = got[not_key], want[not_key]
            upd_got, upd_want = upd_got[not_key], upd_want[not_key]
        if init.norm() > 0:
            m_rel[name] = rel(got, want)
        u_rel[name] = rel(upd_got, upd_want)
    if grads is not None:
        flat, offset = dp_pair["grads"].cuda(), 0
        for name, g in grads.items():
            want = flat[offset:offset + g.numel()].view_as(g)
            offset += g.numel()
            if name.endswith("attn.qkv.bias"):
                g, want = g[not_key], want[not_key]
            g_rel[name] = rel(g, want)
    return m_rel, u_rel, g_rel


def _local_leaves(sd):
    return {k: (v.to_local() if hasattr(v, "to_local") else v)
            for k, v in _state_tensors(sd).items()}


def _fsdp_checkpoint(trainer, config, mesh, batch, rank, workdir):
    """Leg (c): save the sharded state (every rank its shards) twice, the
    second time with the pinned blocks cached: its snapshot's local
    tensors on the host (pinned where the card held them), the saves adding under
    FSDP_SAVE_DEVICE_BYTES to the device's peak, the second blocking under
    FSDP_SAVE_BLOCKING_MS; restore it into a fresh Trainer, every local
    tensor bitwise equal, then one more step there."""
    import torch.distributed as dist

    from tpu_parallel_torch.checkpoint import Checkpointer
    from tpu_parallel_torch.checkpoint.io import snapshot_to_host
    from tpu_parallel_torch.core.metrics import compute
    from tpu_parallel_torch.train_lib import Trainer

    directory = Path(workdir, "fsdp_ckpt")
    ckpt = Checkpointer(str(directory), group=dist.group.WORLD)
    step = trainer.state.step
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    blocking, done = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        ckpt.save(step, trainer.state, wait=False)
        blocking.append((time.perf_counter() - t0) * 1e3)
        ckpt.wait()
        done.append((time.perf_counter() - t0) * 1e3)
    added = torch.cuda.max_memory_allocated() - base
    ckpt.close()
    state_dict = trainer.state.state_dict()
    snapshot, event = snapshot_to_host(state_dict)
    event.synchronize()
    sources = _local_leaves(state_dict)
    off_host = [k for k, v in _local_leaves(snapshot).items()
                if v.device.type != "cpu" or (sources[k].is_cuda and not v.is_pinned())]
    del snapshot, state_dict, sources
    if off_host or added > FSDP_SAVE_DEVICE_BYTES or blocking[1] > FSDP_SAVE_BLOCKING_MS:
        raise AssertionError(f"rank {rank}: a sharded save put {added} bytes on the device "
                             f"(limit {FSDP_SAVE_DEVICE_BYTES}), blocked {blocking} ms (limit "
                             f"{FSDP_SAVE_BLOCKING_MS} for the second), snapshot tensors of "
                             f"the card's not in pinned host memory: {off_host[:5]}")
    nbytes = ckpt.bytes_on_disk(step)
    files = sorted(p.name for p in Path(directory, str(step)).iterdir())
    fresh = Trainer(config, mesh, device="cuda:0")
    fresh.init()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fresh.restore_checkpoint(str(directory))
    torch.cuda.synchronize()
    restore = (time.perf_counter() - t0) * 1e3
    want, got = _local_leaves(trainer.state.state_dict()), _local_leaves(fresh.state.state_dict())
    module_equal = all(torch.equal(a, b) for a, b in zip(trainer.model.parameters(),
                                                         fresh.model.parameters()))
    if got.keys() != want.keys() or not all(torch.equal(got[k], want[k]) for k in want) \
            or not module_equal or fresh.state.step != step:
        raise AssertionError(f"rank {rank}: the restored shards differ from the saved ones")
    _, metrics = fresh.step_fn(fresh.state, None, _every_other(batch, rank, 2))
    loss = compute(metrics)["loss"]
    if not loss == loss or fresh.state.step != step + 1:
        raise AssertionError(f"rank {rank}: the restored state did not train: {loss}")
    tensors = len(want)
    del fresh
    gc.collect()
    torch.cuda.empty_cache()
    return dict(save_blocking_ms=blocking, save_done_ms=done, save_device_bytes=added,
                restore_ms=restore, bytes_on_disk=nbytes, files=files, local_tensors=tensors,
                next_loss=loss)


def _fsdp_export(trainer, rank, workdir):
    """Leg (d): ``export_single_device_params`` on the FSDP state, and the
    masters gathered another way (every rank saves its slices, rank 0 joins
    them along each ``ShardInfo``'s dim): the two serving weight sets'
    fingerprints are equal, and static ``generate()`` gives the same
    greedy tokens on both."""
    import torch.distributed as dist

    from tpu_parallel_torch.checkpoint import params_fingerprint, save_serving_weights
    from tpu_parallel_torch.models import GPTLM
    from tpu_parallel_torch.models.convert import params_to_jax
    from tpu_parallel_torch.models.generate import export_single_device_params, generate

    state, cfg = trainer.state, trainer.model_config
    t0 = time.perf_counter()
    exported = export_single_device_params(state.partitioned(state.params))
    torch.cuda.synchronize()
    export_ms = (time.perf_counter() - t0) * 1e3
    torch.save({n: p.cpu() for n, p in state.params.items() if n in state.shards},
               Path(workdir, f"fsdp_slices_{rank}.pt"))
    dist.barrier()
    if rank != 0:
        return dict(export_ms=export_ms)
    slices = [torch.load(Path(workdir, f"fsdp_slices_{r}.pt"), weights_only=True)
              for r in range(2)]
    gathered = {n: (torch.cat([s[n] for s in slices], dim=state.shards[n].dim)
                    if n in state.shards else p.cpu()) for n, p in state.params.items()}
    manifest = save_serving_weights(str(Path(workdir, "fsdp_serving")), state.step,
                                    params_to_jax(exported, cfg), version="fsdp-export")
    fingerprint = params_fingerprint(params_to_jax(gathered, cfg))
    if manifest.fingerprint != fingerprint:
        raise AssertionError("the export's serving weight set and the gathered masters' differ")
    b, t, new = FSDP_PROMPTS
    prompt = torch.randint(0, cfg.vocab_size, (b, t),
                           generator=torch.Generator().manual_seed(SEED + 50)).cuda()
    tokens = []
    for weights in (exported, gathered):
        model = GPTLM(cfg, device="cuda:0")  # no mesh: full weights
        model.load_state_dict(weights)
        with torch.no_grad():
            tokens.append(generate(model, prompt, max_new_tokens=new).cpu())
        del model
    if not torch.equal(tokens[0], tokens[1]):
        raise AssertionError("generate() differs on the exported and the gathered weights")
    return dict(export_ms=export_ms, fingerprint=manifest.fingerprint, n_leaves=manifest.n_leaves,
                n_params=manifest.n_params, tokens=tokens[0][0].tolist())


def fsdp_cli_leg(work, cores):
    """Leg (e), launched: the CLI under torchrun with
    ``--config.model_overrides.fsdp=True`` for FSDP_STEPS steps on
    CLI_ROWS rows; :func:`fsdp_cli_check` holds it."""
    metrics = Path(work, "fsdp_metrics.prom")
    return _launch(_torchrun("-m", "tpu_parallel_torch.train", "--config=gpt2_125m_dp",
                             "--config.model_overrides.fsdp=True",
                             f"--config.steps={FSDP_STEPS}",
                             f"--config.model_overrides.n_layers={CLI_LAYERS}",
                             f"--config.global_batch_size={CLI_ROWS}",
                             f"--metrics-out={metrics}"), cores), metrics


def fsdp_cli_check(collected):
    """Leg (e): exit 0, one NCCL process, ``train_loss`` in its metrics."""
    (out, wall), metrics = collected
    topology = [json.loads(line[len("topology: "):]) for line in out.splitlines()
                if line.startswith("topology: ")]
    if len(topology) != 1 or topology[0]["backend"] != "nccl":
        raise AssertionError(f"CLI topology lines {topology}")
    if "train_loss" not in metrics.read_text():
        raise AssertionError("CLI metrics without train_loss")
    return dict(wall_s=wall, stdout_tail=out.strip().splitlines()[-2:])


def fsdp_phase(smi, work, dp_report, dp_save, cli_collected, pair):
    """Phase 13: legs (a)-(e) of FSDP, against phase 12's DP legs in this
    call (``dp_save``: phase 11's save timing, printed beside leg (c)'s;
    ``pair``: leg (b)'s ranks, started in phase 12).  Returns the report
    and leg (a)'s launches (its main path)."""
    start = time.perf_counter()
    legs_s = {}

    def lap(name):
        legs_s[name] = time.perf_counter() - start - sum(legs_s.values())

    nccl = dp_report["nccl_fsdp"]  # run in phase 12 (a)'s process
    dp = dp_report["nccl"]
    diffs = [abs(a - b) for a, b in zip(nccl["losses"], dp["losses"])]
    if max(diffs) > LOSS_TOL:
        raise AssertionError(f"leg (a): FSDP losses {nccl['losses']} against DP's "
                             f"{dp['losses']}")
    gib = lambda n: f"{n / 2**30:.3f} GiB"
    log(f"[fsdp nccl] {nccl['process_info']}; mesh {nccl['mesh_shape']}; gpt2_125m_dp + "
        f"fsdp=True [64, 1024] in 1 minibatch: {nccl['n_sharded']} sharded and "
        f"{nccl['n_replicated']} replicated leaves; losses "
        f"{[round(x, 5) for x in nccl['losses']]} against DP's "
        f"{[round(x, 5) for x in dp['losses']]} (|diff| {diffs}, tol {LOSS_TOL}); launches per "
        f"step (flash_fwd, flash_bwd) {nccl['launches_per_step']}; (gathers, reduce-scatters, "
        f"all-reduces) per step {nccl['collectives_per_step']}")
    log(f"  step device ms {[round(x, 2) for x in nccl['step_device_ms']]}, host ms "
        f"{[round(x, 2) for x in nccl['step_host_ms']]}; DP's (phase 12 (a), this call) device "
        f"ms {[round(x, 2) for x in dp['step_device_ms']]}, host ms "
        f"{[round(x, 2) for x in dp['step_host_ms']]}; one block's gather "
        f"({nccl['block']['gather_bytes']} bytes) {nccl['block']['gather']:.4f} device ms, its "
        f"reduce-scatter ({nccl['block']['reduce_scatter_bytes']} bytes) "
        f"{nccl['block']['reduce_scatter']:.4f}; lm_head {nccl['lm_head']['gather']:.4f} / "
        f"{nccl['lm_head']['reduce_scatter']:.4f}; embedding {nccl['embed']['gather']:.4f} / "
        f"{nccl['embed']['reduce_scatter']:.4f}; collectives per step "
        f"{nccl['collective_device_ms_per_step']:.3f} device ms")
    log(f"  state per rank: sharded {gib(nccl['state_bytes']['sharded'])}, replicated "
        f"{gib(nccl['state_bytes']['replicated'])}; max memory allocated "
        f"{gib(nccl['max_memory_allocated'])} (DP {gib(dp['max_memory_allocated'])})")
    pair = _join_ranks(pair, DP_LEG_TIMEOUT)
    lap("pair")
    r0 = pair[0]
    if pair[0]["digests"] != pair[1]["digests"]:
        raise AssertionError(f"leg (b): replicated leaves differ across ranks: {pair}")
    if pair[0]["losses"] != pair[1]["losses"]:
        raise AssertionError(f"leg (b) ranks' synced losses differ: {pair}")
    loss_diffs = [abs(a - b) for a, b in zip(r0["losses"], r0["dp_losses"])]
    worst_master = max(m for _, m in r0["master_rel_max"])
    if max(loss_diffs) > LOSS_TOL or r0["step1_grad_rel_max"][1] > TRAIN_GRAD_TOL \
            or worst_master > FSDP_MASTER_TOL \
            or max(r0["update_rel_median"]) > FSDP_UPDATE_MEDIAN_TOL \
            or max(m for _, m in r0["update_rel_max"]) > FSDP_UPDATE_MAX_TOL:
        raise AssertionError(f"leg (b): FSDP disagrees with DP: {r0}")
    want_bytes = dict(sharded=nccl["state_bytes"]["sharded"] // 2,
                      replicated=nccl["state_bytes"]["replicated"])
    if any(p["state_bytes"] != want_bytes for p in pair):
        raise AssertionError(f"leg (b) state bytes {[p['state_bytes'] for p in pair]}, want "
                             f"{want_bytes} (leg (a)'s sharded bytes halved)")
    log(f"[fsdp two ranks] gloo over CUDA tensors, two processes on cuda:0, rows r::2 of "
        f"{DP_PAIR_BATCHES} batches of [64, 1024] in {DP_PAIR_MINIBATCHES} minibatches: "
        f"replicated leaves bitwise equal across the ranks after every step; losses "
        f"{[round(x, 5) for x in r0['losses']]} against DP's "
        f"{[round(x, 5) for x in r0['dp_losses']]} (|diff| {loss_diffs}, tol {LOSS_TOL})")
    log(f"  against phase 12's DP pair: step-1 gradients relative L2 per weight median "
        f"{r0['step1_grad_rel_median']:.3e}, max {r0['step1_grad_rel_max'][1]:.3e} "
        f"({r0['step1_grad_rel_max'][0]}); gathered masters (of non-zero init) after each "
        f"step, worst relative L2 {[(n, f'{m:.3e}') for n, m in r0['master_rel_max']]} (tol "
        f"{FSDP_MASTER_TOL}); their update's relative error median "
        f"{[f'{x:.3e}' for x in r0['update_rel_median']]} (tol {FSDP_UPDATE_MEDIAN_TOL}), "
        f"max {[(n, f'{m:.3e}') for n, m in r0['update_rel_max']]} (tol {FSDP_UPDATE_MAX_TOL})")
    log("  per rank: state " + "; ".join(
        f"rank {p['rank']} sharded {gib(p['state_bytes']['sharded'])} + replicated "
        f"{gib(p['state_bytes']['replicated'])}, max memory allocated in a step "
        f"{gib(p['max_memory_allocated'])}, one block's gloo gather "
        f"{p['block']['gather']:.1f} host ms, reduce-scatter {p['block']['reduce_scatter']:.1f}"
        for p in pair))
    ck = [p["checkpoint"] for p in pair]
    log(f"[fsdp checkpoint] step {pair[0]['checkpoint']['files']}: "
        f"{ck[0]['bytes_on_disk']} bytes on disk; per rank, a first save and a second (pinned "
        f"blocks cached) block {[[round(x, 1) for x in c['save_blocking_ms']] for c in ck]} ms "
        f"(the second's limit {FSDP_SAVE_BLOCKING_MS}; phase 11's one-device save of "
        f"{dp_save['bytes']} bytes, this call: {dp_save['blocking_ms']:.1f}), done in "
        f"{[[round(x, 1) for x in c['save_done_ms']] for c in ck]} ms, adding "
        f"{[c['save_device_bytes'] for c in ck]} bytes to the device's peak (limit "
        f"{FSDP_SAVE_DEVICE_BYTES}); restore "
        f"{[round(c['restore_ms'], 1) for c in ck]} ms into a fresh Trainer: "
        f"{ck[0]['local_tensors']} local tensors per rank bitwise equal; the next step's loss "
        f"{ck[0]['next_loss']:.5f}")
    ex = pair[0]["export"]
    log(f"[fsdp export] export_single_device_params {[round(p['export']['export_ms'], 1) for p in pair]} "
        f"ms; serving weight set fingerprint {ex['fingerprint'][:16]} ({ex['n_leaves']} leaves, "
        f"{ex['n_params']} params) equal to the gathered masters'; greedy tokens of generate() "
        f"equal on both ({FSDP_PROMPTS[0]} prompts of {FSDP_PROMPTS[1]}, {FSDP_PROMPTS[2]} new; "
        f"row 0 {ex['tokens'][-FSDP_PROMPTS[2]:]})")
    cli = fsdp_cli_check(cli_collected)
    log(f"[fsdp cli] torchrun --standalone --nproc_per_node=1 -m tpu_parallel_torch.train "
        f"--config=gpt2_125m_dp --config.model_overrides.fsdp=True --config.steps={FSDP_STEPS} "
        f"--config.model_overrides.n_layers={CLI_LAYERS} "
        f"--config.global_batch_size={CLI_ROWS} (started at phase 9, collected in phase 12): exit 0, "
        f"collected {cli['wall_s']:.1f} s after its launch; {cli['stdout_tail']}")
    phase_s = time.perf_counter() - start
    log(f"[fsdp] phase 13 took {phase_s:.1f} s ("
        + ", ".join(f"{k} {v:.1f}" for k, v in legs_s.items()) + ")")
    log(f"card: {smi}")
    return dict(nccl=nccl, pair=pair, cli=cli, phase_s=phase_s, legs_s=legs_s), nccl["launches"]


# phase 14: tensor parallelism on the card (``gpt2_125m_tp``: the blocks'
# projections and the lm_head split over a model axis).  The kernels at a
# rank's shape, then (a) the CLI under torchrun in an NCCL group of one,
# a one-process reference, and two gloo ranks sharing the card on a
# data=1 x model=2 mesh: (b) training, (c) a model-sharded checkpoint,
# (d) ``generate_sharded`` and (e) the engine over the mesh.
TP_STEPS = 3  # counted steps of legs (a) and (b)
# legs (b)-(e) and their reference run gpt2_125m_tp at 2 of its 12 layers:
# the whole run stays inside its time limit with phases 15-17 (PERF.md)
TP_PAIR_LAYERS = 2
TP_SHAPE = (32, 6, 6, 1024, 64, dict(causal=True), False, 10)  # one rank's flash shape
TP_PROMPT_LENS = (32, 20, 27, 12)  # leg (d)'s ragged prompts, left-padded to 32
TP_NEW = 32  # new tokens per prompt in legs (d) and (e)
TP_ENGINE_EXTRA = ((9, 16), (24, 24), (5, 8), (17, 32))  # leg (e)'s other (length, budget)
TP_TIMED_GENERATE = 1  # timed bf16 generate_sharded calls
# leg (b) against one process, per weight, relative L2 (the qkv bias's key
# slice left out): the masters of non-zero init after each step, and each
# step's update from the initial masters, median and max over the weights.
# Set from the first reading on an H100 80GB HBM3 at 700 W (masters within
# 1.09e-4; updates median 2.2e-2 and 1.6e-2, max 0.100, the token
# embedding): in bf16 each rank's row partial is rounded before the
# all-reduce sums it, so the step-1 gradients differ from one process's by
# about 1e-2 per weight, which AdamW's first steps (m / sqrt(v) near
# sign(g)) carry into the updates.  A step that leaves the shards where
# they were misses the update limits (an error of 1); a wrong gradient
# scale misses TRAIN_GRAD_TOL and the fp32 check below.
TP_MASTER_TOL = 5e-4
TP_UPDATE_MEDIAN_TOL = 5e-2
TP_UPDATE_MAX_TOL = 3e-1
# the synced gradients in fp32 (TF32 off, xla attention) of gpt2_125m_tp's
# widths cut to TP_FP32_LAYERS layers, on TP_FP32_ROWS rows, where the split
# changes only fp32 rounding: per weight within TP_FP32_GRAD_TOL of one
# process's
TP_FP32_ROWS, TP_FP32_LAYERS = 4, 2
TP_FP32_GRAD_TOL = 1e-4


def _tp_config(**changes):
    config, _ = _shell_config("gpt2_125m_tp", seed=SEED, **changes)
    return config


def _tp_batches(vocab, device):
    """TP_STEPS seeded global batches of [32, 1024]: every rank of the model
    axis steps on all 32 rows."""
    from tpu_parallel_torch.data import lm_batch

    return [lm_batch(torch.Generator().manual_seed(SEED + 60 + i), 32, SHELL_SEQ, vocab,
                     device=device) for i in range(TP_STEPS)]


def _tp_assembled(state, tree):
    """The full fp32 tensors of ``tree`` (a dict by parameter name, this
    rank's slices of the model-sharded ones), on the host: each slice
    all-gathered over its axis (a collective: every rank calls it)."""
    import torch.distributed as dist

    out = {}
    for name, value in tree.items():
        value = value.detach()
        info = state.shards.get(name)
        if info is not None:
            parts = [torch.empty_like(value) for _ in range(info.size)]
            dist.all_gather(parts, value.contiguous(), group=info.group)
            value = torch.cat(parts, dim=info.dim)
        out[name] = value.to("cpu", torch.float32, copy=True)
    return out


def _tp_grads(trainer, state, batch, mesh):
    """The step's synced gradients on ``batch`` (accumulated, then
    ``fsdp.sync_gradients`` over the Trainer's axes on a mesh), without an
    update; the accumulators are cleared after."""
    from tpu_parallel_torch.core.accumulate import accumulate_gradients
    from tpu_parallel_torch.parallel import fsdp

    grads, _ = accumulate_gradients(state, batch, state.rng, 1, trainer.loss_fn)
    if mesh is not None:
        fsdp.sync_gradients(state.partitioned(grads), ("data", "model"), mesh=mesh)
    return grads


def _rel_by_weight(cfg, got, want, keep_zero_init=True, init=None):
    """Relative L2 of ``got`` against ``want`` per weight, the qkv bias's
    key slice left out; with ``init`` the updates from it are compared
    instead, and ``keep_zero_init=False`` skips leaves whose init is 0."""
    dh = cfg.head_dim
    not_key = (torch.arange(3 * cfg.d_model) % (3 * dh)) // dh != 1
    rel = {}
    for name, g in got.items():
        w = want[name]
        if init is not None:
            if not keep_zero_init and init[name].norm() == 0:
                continue
            g, w = g - init[name], w - init[name]
        if name.endswith("attn.qkv.bias"):
            g, w = g[not_key], w[not_key]
        rel[name] = ((g - w).norm() / w.norm().clamp(min=1e-30)).item()
    return rel


def _tp_fp32_grads(mesh, device):
    """The synced gradients of ``gpt2_125m_tp``'s model in fp32 (xla
    attention) at TP_FP32_LAYERS layers on TP_FP32_ROWS seeded rows,
    assembled on the host."""
    from tpu_parallel_torch.data import lm_batch
    from tpu_parallel_torch.train_lib import Trainer

    config = _tp_config(global_batch_size=TP_FP32_ROWS,
                        model_overrides=dict(dtype=torch.float32, attn_impl="xla",
                                             n_layers=TP_FP32_LAYERS))
    trainer = Trainer(config, mesh, device=device)
    state = trainer.init()
    batch = lm_batch(torch.Generator().manual_seed(SEED + 65), TP_FP32_ROWS, SHELL_SEQ,
                     trainer.model_config.vocab_size, device=device)
    grads = _tp_assembled(state, _tp_grads(trainer, state, batch, mesh))
    del trainer, state, batch
    gc.collect()
    torch.cuda.empty_cache()
    return grads


def tp_reference_leg(workdir):
    """One process, no group: ``Trainer(gpt2_125m_tp)`` at TP_PAIR_LAYERS
    layers (one device), the step-1 gradients, then TP_STEPS steps on the seeded batches; saves the
    losses, the gradients, the masters after each step and the fp32
    gradients for leg (b), with its step times and peak memory."""
    from tpu_parallel_torch.core.metrics import compute
    from tpu_parallel_torch.train_lib import Trainer

    trainer = Trainer(_tp_config(model_overrides=dict(n_layers=TP_PAIR_LAYERS)), device="cuda")
    if trainer.mesh is not None:
        raise AssertionError("a Trainer without a group has a mesh")
    state = trainer.init()
    batches = _tp_batches(trainer.model_config.vocab_size, "cuda")
    start = {n: p.detach().to("cpu", torch.float32, copy=True) for n, p in state.params.items()}
    grads = {n: g.detach().to("cpu", torch.float32, copy=True)
             for n, g in _tp_grads(trainer, state, batches[0], None).items()}
    state.zero_grads()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, masters, step_ms = [], [], []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = trainer.step_fn(state, None, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(compute(metrics)["loss"])
        masters.append({n: p.detach().to("cpu", torch.float32, copy=True)
                        for n, p in state.params.items()})
    peak = torch.cuda.max_memory_allocated()
    state_bytes = _state_bytes(state)
    del trainer, state
    gc.collect()
    torch.cuda.empty_cache()
    torch.save(dict(start=start, grads=grads, losses=losses, masters_by_step=masters,
                    fp32_grads=_tp_fp32_grads(None, "cuda")), Path(workdir, "tp_ref.pt"))
    return dict(losses=losses, step_host_ms=step_ms, max_memory_allocated=peak,
                state_bytes=state_bytes)


def _tp_counts():
    from tpu_parallel_torch.parallel import dp, tp

    return [tp.tp_allreduce_launches, tp.tp_allgather_launches, dp.dp_allreduce_launches]


def tp_pair_leg(rank, rendezvous, workdir):
    """Legs (b)-(e), one of two gloo ranks on the one card over a data=1 x
    model=2 mesh: the step-1 synced gradients, then TP_STEPS counted steps
    on all 32 rows of the seeded batches (rank 0 holds the gradients, the
    losses, the masters and their updates to the reference's), a digest
    of the replicated leaves after every step, the state's bytes and the
    steps' peak memory, gloo's time per activation all-reduce, the fp32
    synced gradients against one process's; then the checkpoint,
    ``generate_sharded`` and the engine."""
    import torch.distributed as dist

    from tpu_parallel_torch.core.metrics import compute
    from tpu_parallel_torch.parallel import tp
    from tpu_parallel_torch.runtime import MeshConfig, initialize, make_mesh, process_info
    from tpu_parallel_torch.train_lib import Trainer

    initialize(rendezvous, 2, rank, backend="gloo", device="cuda:0")
    _share_cores(2)
    info = process_info()
    config = _tp_config(model_overrides=dict(n_layers=TP_PAIR_LAYERS))
    mesh = make_mesh(MeshConfig(data=1, model=2))
    trainer = Trainer(config, mesh, device="cuda:0")
    state = trainer.init()
    cfg = trainer.model_config
    if len(state.shards) != 6 * cfg.n_layers + 1:
        raise AssertionError(f"{len(state.shards)} model-sharded leaves")
    batches = _tp_batches(cfg.vocab_size, "cuda:0")
    ref = torch.load(Path(workdir, "tp_ref.pt"), weights_only=True) if rank == 0 else None
    start = _tp_assembled(state, state.params)
    grads = _tp_assembled(state, _tp_grads(trainer, state, batches[0], mesh))
    state.zero_grads()
    result = dict(rank=rank, process_info=info)
    if rank == 0:
        if any(not torch.equal(start[n], ref["start"][n]) for n in start):
            raise AssertionError("leg (b): the assembled initial masters differ from one "
                                 "process's")
        grad_rel = _rel_by_weight(cfg, grads, ref["grads"])
    del grads
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()  # the main path starts here
    losses, digests, per_step, colls, step_ms, master_rel, update_rel = [], [], [], [], [], [], []
    for i, batch in enumerate(batches):
        before, cbefore = _launch_counts(), _tp_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = trainer.step_fn(state, None, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        per_step.append([a - b for a, b in zip(_launch_counts(), before)])
        colls.append([a - b for a, b in zip(_tp_counts(), cbefore)])
        losses.append(compute(metrics)["loss"])
        digests.append(_replicated_digest(state))
        full = _tp_assembled(state, state.params)
        if rank == 0:
            want = ref["masters_by_step"][i]
            master_rel.append(_rel_by_weight(
                cfg, {n: v for n, v in full.items() if start[n].norm() > 0}, want))
            update_rel.append(_rel_by_weight(cfg, full, want, init=start))
        del full
    launches = dict(zip(LAUNCH_COUNTERS, _launch_counts()))
    peak = torch.cuda.max_memory_allocated()
    act = torch.randn(32, SHELL_SEQ, cfg.d_model, device="cuda:0").to(cfg.dtype)
    dist.barrier()
    act_ms = host_ms(lambda: tp.all_reduce(act, "model", mesh), 1)
    del act
    fp32_grads = _tp_fp32_grads(mesh, "cuda:0")
    result.update(losses=losses, digests=digests, launches_per_step=per_step, launches=launches,
                  collectives_per_step=colls, step_host_ms=step_ms, max_memory_allocated=peak,
                  state_bytes=_state_bytes(state), activation_allreduce_host_ms=act_ms,
                  activation_allreduce_bytes=32 * SHELL_SEQ * cfg.d_model * 2)
    if rank == 0:
        worst = lambda rel: max(rel.items(), key=lambda kv: kv[1])
        result.update(
            ref_losses=ref["losses"],
            step1_grad_rel_max=worst(grad_rel),
            step1_grad_rel_median=sorted(grad_rel.values())[len(grad_rel) // 2],
            master_rel_max=[worst(r) for r in master_rel],
            update_rel_median=[sorted(r.values())[len(r) // 2] for r in update_rel],
            update_rel_max=[worst(r) for r in update_rel])
        fp32_rel = _rel_by_weight(cfg, fp32_grads, ref["fp32_grads"])
        result.update(fp32_grad_rel_max=worst(fp32_rel),
                      fp32_grad_rel_median=sorted(fp32_rel.values())[len(fp32_rel) // 2])
        loss_diffs = [abs(a - b) for a, b in zip(losses, ref["losses"])]
        result.update(loss_diffs=loss_diffs)
        del ref
        if max(loss_diffs) > LOSS_TOL or result["step1_grad_rel_max"][1] > TRAIN_GRAD_TOL \
                or max(m for _, m in result["master_rel_max"]) > TP_MASTER_TOL \
                or max(result["update_rel_median"]) > TP_UPDATE_MEDIAN_TOL \
                or max(m for _, m in result["update_rel_max"]) > TP_UPDATE_MAX_TOL \
                or result["fp32_grad_rel_max"][1] > TP_FP32_GRAD_TOL:
            raise AssertionError(f"leg (b): two TP ranks disagree with one process: {result}")
    del fp32_grads
    gc.collect()
    torch.cuda.empty_cache()
    result.update(checkpoint=_tp_checkpoint(trainer, config, mesh, batches[0], rank, workdir))
    result.update(generate=_tp_generate(trainer, mesh, rank))
    dist.barrier()
    dist.destroy_process_group()
    return result


def _tp_checkpoint(trainer, config, mesh, batch, rank, workdir):
    """Leg (c): the model-sharded state saved (every rank its slices,
    ``torch.distributed.checkpoint``), restored into a fresh Trainer with
    every local tensor bitwise equal, then one more step on both: the same
    loss."""
    from tpu_parallel_torch.core.metrics import compute
    from tpu_parallel_torch.train_lib import Trainer

    directory = str(Path(workdir, "tp_ckpt"))
    step = trainer.state.step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.save_checkpoint(directory, step)
    save_ms = (time.perf_counter() - t0) * 1e3
    fresh = Trainer(config, mesh, device="cuda:0")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fresh.restore_checkpoint(directory)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    want, got = _local_leaves(trainer.state.state_dict()), _local_leaves(fresh.state.state_dict())
    module_equal = all(torch.equal(a, b) for a, b in zip(trainer.model.parameters(),
                                                         fresh.model.parameters()))
    if got.keys() != want.keys() or not all(torch.equal(got[k], want[k]) for k in want) \
            or not module_equal or fresh.state.step != step:
        raise AssertionError(f"rank {rank}: the restored slices differ from the saved ones")
    losses = [compute(t.step_fn(t.state, None, batch)[1])["loss"] for t in (trainer, fresh)]
    if losses[0] != losses[1] or fresh.state.step != step + 1:
        raise AssertionError(f"rank {rank}: the restored state trains apart: {losses}")
    tensors = len(want)
    del fresh
    gc.collect()
    torch.cuda.empty_cache()
    return dict(save_ms=save_ms, restore_ms=restore_ms, local_tensors=tensors, next_loss=losses[0])


def _tp_prompts(vocab):
    """Leg (d)'s ragged prompts, left-padded to the longest: ``(prompt,
    mask, rows)`` with the unpadded rows as lists."""
    gen = torch.Generator().manual_seed(SEED + 70)
    rows = [torch.randint(1, vocab, (n,), generator=gen).tolist() for n in TP_PROMPT_LENS]
    width = max(TP_PROMPT_LENS)
    prompt = torch.zeros(len(rows), width, dtype=torch.long)
    mask = torch.zeros(len(rows), width, dtype=torch.bool)
    for i, row in enumerate(rows):
        prompt[i, width - len(row):] = torch.tensor(row)
        mask[i, width - len(row):] = True
    return prompt.cuda(), mask.cuda(), rows


def _top2_held(dense, prompt, got, want, what):
    """Greedy tokens ``got`` against the reference's ``want`` after the
    unpadded ``prompt``: equal, or first differing where the reference's
    top-2 logit gap is below FP32_TIE_GAP (raises otherwise)."""
    if got == want:
        return dict(equal=True)
    step = next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)
    with torch.inference_mode():
        top2 = dense(torch.tensor([prompt + want[:step]], device="cuda:0"))[0, -1].float().topk(2)
    gap = (top2.values[0] - top2.values[1]).item()
    if gap >= FP32_TIE_GAP:
        raise AssertionError(f"{what} differs from the reference at token {step} with top-2 "
                             f"gap {gap:.3e}")
    return dict(equal=False, first_diff=step, top2_gap=gap)


def _tp_generate(trainer, mesh, rank):
    """Legs (d) and (e) on the trained weights.  fp32 (TF32 off): greedy
    ``generate_sharded`` on the ragged prompts against static ``generate()``
    on the assembled masters (the top-2 rule, rank 0); the engine over the
    mesh (per-step ticks) on those prompts and 4 more, its greedy tokens
    against ``generate_sharded``'s under the same rule, every request at
    its budget.  bf16 (the trainer's module): ``generate_sharded``'s
    tokens/s and ms per token, and a top-k and a top-p sampled call."""
    import dataclasses

    from tpu_parallel_torch.models import GPTLM
    from tpu_parallel_torch.models.generate import generate, generate_sharded
    from tpu_parallel_torch.serving import Request, ServingEngine

    state, cfg = trainer.state, trainer.model_config
    fp32_cfg = dataclasses.replace(cfg, dtype=torch.float32, remat=False)
    sharded = GPTLM(fp32_cfg, device="cuda:0", mesh=mesh).eval()
    sharded.load_state_dict({n: p.detach() for n, p in state.params.items()})
    full = _tp_assembled(state, state.params)
    dense = None
    if rank == 0:
        dense = GPTLM(fp32_cfg, device="cuda:0").eval()
        dense.load_state_dict(full)
    del full
    prompt, mask, rows = _tp_prompts(cfg.vocab_size)
    got = generate_sharded(sharded, prompt, max_new_tokens=TP_NEW, prompt_mask=mask).tolist()
    report = dict(tokens=got)
    if rank == 0:
        with torch.inference_mode():
            want = generate(dense, prompt, max_new_tokens=TP_NEW, prompt_mask=mask).tolist()
        report["fp32_against_generate"] = [
            _top2_held(dense, row, g, w, f"generate_sharded row {i}")
            for i, (row, g, w) in enumerate(zip(rows, got, want))]
    gen = torch.Generator().manual_seed(SEED + 71)
    extra = [(torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist(), budget)
             for n, budget in TP_ENGINE_EXTRA]
    work = [(row, TP_NEW) for row in rows] + extra
    eng = ServingEngine(sharded, n_slots=4, mesh=mesh)
    if eng.decode_steps_per_tick != 1 or eng.unified_tick:
        raise AssertionError("the engine over a mesh is not per-step")
    outs = [eng.add_request(Request(prompt=p, max_new_tokens=n, request_id=f"r{i}"))
            for i, (p, n) in enumerate(work)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    engine_s = time.perf_counter() - t0
    if any(o.status != "finished" or len(o.tokens) != n for o, (_, n) in zip(outs, work)):
        raise AssertionError(f"rank {rank}: engine requests not at their budgets: "
                             f"{[(o.status, len(o.tokens), n) for o, (_, n) in zip(outs, work)]}")
    if eng.graph_captures:
        raise AssertionError("the engine over a mesh captured a graph")
    report.update(engine_tokens=[o.tokens for o in outs], engine_s=engine_s,
                  engine_tokens_out=sum(len(o.tokens) for o in outs),
                  engine_ticks=eng.metrics.ticks)
    if rank == 0:
        report["engine_against_generate_sharded"] = [
            _top2_held(dense, row, o.tokens, g, f"engine request r{i}")
            for i, (row, o, g) in enumerate(zip(rows, outs, got))]
    del eng, sharded, dense
    gc.collect()
    torch.cuda.empty_cache()
    model = trainer.model.eval()
    generate_sharded(model, prompt, max_new_tokens=TP_NEW, prompt_mask=mask)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TP_TIMED_GENERATE):
        generate_sharded(model, prompt, max_new_tokens=TP_NEW, prompt_mask=mask)
    torch.cuda.synchronize()
    call_s = (time.perf_counter() - t0) / TP_TIMED_GENERATE
    report.update(bf16_ms_per_token=call_s / TP_NEW * 1e3,
                  bf16_tokens_per_s=len(rows) * TP_NEW / call_s)
    for name, kw in (("top_k", dict(temperature=0.8, top_k=40)),
                     ("top_p", dict(temperature=0.8, top_p=0.9))):
        report[name] = generate_sharded(model, prompt, rng=torch.Generator().manual_seed(SEED),
                                        max_new_tokens=8, prompt_mask=mask, **kw).tolist()
    model.train()
    return report


def tp_cli_rank_leg(metrics):
    """Leg (a)'s rank, under torchrun: ``tpu_parallel_torch.train``'s
    ``main`` on ``--config=gpt2_125m_tp`` for TP_STEPS steps with each
    step's kernel launches and loss recorded at the Trainer's step."""
    from tpu_parallel_torch import train
    from tpu_parallel_torch.core.metrics import accumulate_metrics, compute
    from tpu_parallel_torch.train_lib import Trainer

    per_step, losses = [], []
    real = Trainer.step_fn

    def step(self, state, metrics, batch):
        before = _launch_counts()
        state, step_metrics = real(self, state, None, batch)
        per_step.append([a - b for a, b in zip(_launch_counts(), before)])
        losses.append(compute(step_metrics)["loss"])
        return state, accumulate_metrics(metrics, step_metrics)

    Trainer.step_fn = step
    _reset_launches()  # the main path starts here
    code = train.main(["--config=gpt2_125m_tp", f"--config.steps={TP_STEPS}",
                       f"--config.model_overrides.n_layers={CLI_LAYERS}",
                       f"--config.global_batch_size={CLI_ROWS}", "--config.log_every=1",
                       f"--metrics-out={metrics}"])
    return dict(exit=code, launches_per_step=per_step, losses=losses,
                launches=dict(zip(LAUNCH_COUNTERS, _launch_counts())))


def tp_cli_leg(work, cores):
    """Leg (a), launched: ``python -m torch.distributed.run --standalone
    --nproc_per_node=1`` over this script's ``tp_cli_rank`` leg on CLI_ROWS
    rows; :func:`tp_cli_check` holds it."""
    metrics = Path(work, "tp_metrics.prom")
    return _launch(_torchrun(str(Path(__file__).resolve()), "--leg", "tp_cli_rank",
                             str(metrics)), cores), metrics


def tp_cli_check(collected):
    """Leg (a): exit 0, a topology line with one NCCL process, CLI_LAYERS
    launches of each kernel per step, a falling loss, ``train_loss`` in
    the metrics."""
    (out, wall), metrics = collected
    topology = [json.loads(line[len("topology: "):]) for line in out.splitlines()
                if line.startswith("topology: ")]
    if len(topology) != 1 or topology[0]["process_count"] != 1 \
            or topology[0]["backend"] != "nccl":
        raise AssertionError(f"CLI topology lines {topology}")
    result = json.loads([line for line in out.splitlines()
                         if line.startswith(DP_RESULT)][-1][len(DP_RESULT):])
    layers = CLI_LAYERS
    if result["exit"] != 0 or result["launches_per_step"] != [[layers, layers]] * TP_STEPS:
        raise AssertionError(f"leg (a): exit {result['exit']}, launches per step "
                             f"{result['launches_per_step']}, want {layers} of each")
    _falls("leg (a)", result["losses"])
    if "train_loss" not in metrics.read_text():
        raise AssertionError("CLI metrics without train_loss")
    result.update(wall_s=wall, topology=topology[0])
    return result


def tp_phase(smi, work, cli_collected):
    """Phase 14: the kernels at one TP rank's shape against their plain
    versions, then legs (a)-(e) in the directory ``work``.  Returns the
    report, the kernels' rows and leg (b)'s launches (rank 0's main
    path)."""
    start = time.perf_counter()
    legs_s = {}

    def lap(name):
        legs_s[name] = time.perf_counter() - start - sum(legs_s.values())

    gen = torch.Generator(device="cuda").manual_seed(SEED + 50)
    rows = dict(fwd=fwd_kernel_row("t_tp_pass", TP_SHAPE, gen),
                bwd=bwd_kernel_row("t_tp_pass", TP_SHAPE, gen, main_path=True))
    gc.collect()
    torch.cuda.empty_cache()
    lap("kernels")
    cli = tp_cli_check(cli_collected)
    log(f"[tp cli] torchrun --standalone --nproc_per_node=1 over -m tpu_parallel_torch.train's "
        f"main --config=gpt2_125m_tp --config.steps={TP_STEPS} --config.model_overrides."
        f"n_layers={CLI_LAYERS} --config.global_batch_size={CLI_ROWS} (a model axis of 1; started at phase 9, collected in phase 12): exit 0, "
        f"collected {cli['wall_s']:.1f} s after its launch; topology {cli['topology']}; "
        f"launches per step "
        f"(flash_fwd, "
        f"flash_bwd) {cli['launches_per_step']}; losses {[round(x, 5) for x in cli['losses']]}")
    pair = _spawn_ranks("tp_pair", work, 2)
    ref = _reference(tp_reference_leg, work)
    lap("reference")
    pair = _join_ranks(pair, DP_LEG_TIMEOUT)
    lap("pair")
    r0 = pair[0]
    layers, mb = TP_PAIR_LAYERS, _tp_config().num_minibatches
    want_coll = [mb * (2 * layers + 5 + 2 * layers + 2), 0, 1]
    for p in pair:
        if p["launches_per_step"] != [[layers, layers]] * TP_STEPS:
            raise AssertionError(f"leg (b) rank {p['rank']}: launches per step "
                                 f"{p['launches_per_step']}")
        if p["collectives_per_step"] != [want_coll] * TP_STEPS:
            raise AssertionError(f"leg (b) rank {p['rank']}: (tp all-reduces, tp all-gathers, "
                                 f"gradient all-reduces) per step {p['collectives_per_step']}, "
                                 f"want {want_coll}")
    if pair[0]["digests"] != pair[1]["digests"]:
        raise AssertionError(f"leg (b): replicated leaves differ across ranks: {pair}")
    if pair[0]["losses"] != pair[1]["losses"]:
        raise AssertionError(f"leg (b) ranks' synced losses differ: {pair}")
    g0, g1 = pair[0]["generate"], pair[1]["generate"]
    for key in ("tokens", "engine_tokens", "top_k", "top_p"):
        if g0[key] != g1[key]:
            raise AssertionError(f"legs (d)-(e): the ranks' {key} differ")
    gib = lambda n: f"{n / 2**30:.3f} GiB"
    log(f"[tp two ranks] gloo over CUDA tensors, two processes on cuda:0 ({r0['process_info']}), "
        f"mesh data=1 x model=2, gpt2_125m_tp at {TP_PAIR_LAYERS} of its 12 layers, [32, 1024] "
        f"on both ranks: launches per step "
        f"{r0['launches_per_step']}; (tp all-reduces, tp all-gathers, gradient all-reduces) per "
        f"step {r0['collectives_per_step']}; replicated leaves bitwise equal across the ranks "
        f"after every step; losses {[round(x, 5) for x in r0['losses']]} against one process's "
        f"{[round(x, 5) for x in r0['ref_losses']]} (|diff| {r0['loss_diffs']}, tol {LOSS_TOL})")
    log(f"  against one process: step-1 synced gradients relative L2 per weight median "
        f"{r0['step1_grad_rel_median']:.3e}, max {r0['step1_grad_rel_max'][1]:.3e} "
        f"({r0['step1_grad_rel_max'][0]}), tol {TRAIN_GRAD_TOL}; assembled masters after each "
        f"step, worst {[(n, f'{m:.3e}') for n, m in r0['master_rel_max']]} (tol "
        f"{TP_MASTER_TOL}); their update's relative error median "
        f"{[f'{x:.3e}' for x in r0['update_rel_median']]} (tol {TP_UPDATE_MEDIAN_TOL}), max "
        f"{[(n, f'{m:.3e}') for n, m in r0['update_rel_max']]} (tol {TP_UPDATE_MAX_TOL}); fp32 "
        f"(TF32 off, xla, {TP_FP32_LAYERS} layers) synced gradients on {TP_FP32_ROWS} rows median "
        f"{r0['fp32_grad_rel_median']:.3e}, max {r0['fp32_grad_rel_max'][1]:.3e} "
        f"({r0['fp32_grad_rel_max'][0]}), tol {TP_FP32_GRAD_TOL}")
    log(f"  step host ms per rank {[[round(x, 1) for x in p['step_host_ms']] for p in pair]} "
        f"against one process's {[round(x, 1) for x in ref['step_host_ms']]}; gloo all-reduce "
        f"of one [32, 1024, 768] bf16 activation ({r0['activation_allreduce_bytes']} bytes) "
        f"{[round(p['activation_allreduce_host_ms'], 2) for p in pair]} host ms; state per rank "
        + "; ".join(f"rank {p['rank']} sharded {gib(p['state_bytes']['sharded'])} + replicated "
                    f"{gib(p['state_bytes']['replicated'])}, max memory allocated in a step "
                    f"{gib(p['max_memory_allocated'])}" for p in pair)
        + f"; one process: {gib(sum(ref['state_bytes'].values()))}, "
        f"{gib(ref['max_memory_allocated'])}")
    ck = [p["checkpoint"] for p in pair]
    log(f"[tp checkpoint] save {[round(c['save_ms'], 1) for c in ck]} ms, restore "
        f"{[round(c['restore_ms'], 1) for c in ck]} ms into a fresh Trainer: "
        f"{ck[0]['local_tensors']} local tensors per rank bitwise equal; one more step on both: "
        f"loss {ck[0]['next_loss']:.5f} equal")
    log(f"[tp generate] fp32 (TF32 off) generate_sharded on {len(TP_PROMPT_LENS)} ragged prompts "
        f"{TP_PROMPT_LENS}, {TP_NEW} new: greedy tokens equal on both ranks, against static "
        f"generate() on the assembled masters {g0['fp32_against_generate']}; bf16 "
        f"{g0['bf16_ms_per_token']:.2f} ms per token, {g0['bf16_tokens_per_s']:.1f} tokens/s "
        f"(rank 1: {g1['bf16_ms_per_token']:.2f} ms); top-k and top-p sampled tokens equal on "
        f"both ranks (row 0 {g0['top_k'][0]}, {g0['top_p'][0]})")
    log(f"[tp engine] ServingEngine(mesh=...) fp32, 4 slots, {len(g0['engine_tokens'])} requests, "
        f"per-step ticks: every request at its budget, tokens equal on both ranks, against "
        f"generate_sharded {g0['engine_against_generate_sharded']}; {g0['engine_ticks']} ticks, "
        f"{g0['engine_tokens_out']} tokens in {g0['engine_s']:.2f} s")
    phase_s = time.perf_counter() - start
    log(f"[tp] phase 14 took {phase_s:.1f} s ("
        + ", ".join(f"{k} {v:.1f}" for k, v in legs_s.items()) + ")")
    log(f"card: {smi}")
    return dict(cli=cli, reference=ref, pair=pair, phase_s=phase_s, legs_s=legs_s), rows, \
        r0["launches"]

# phase 15: pipeline parallelism on the card (``gpt2_350m_pp``: GPT-2 350M,
# 24 layers over a pipe axis of 4 with 2 virtual stages per rank, flash
# attention under the proj_attn policy, 8 microbatches).  The kernels at
# the PP pass's shape; (a) the CLI under torchrun, a pipe axis of 1 with
# 1F1B (NCCL, a group of one; started at phase 9, collected in phase 12); a
# one-process reference; then four gloo ranks sharing the card for (b)
# GPipe with interleave 2, (c) 1F1B, (d) a checkpoint and (e)
# ``generate_sharded``.
PP_STEPS = 3  # counted steps of leg (b)
PP_RANKS = 4
PP_ROWS = 32  # global batch (the config has 64: see PERF.md): 8 microbatches of [4, 1024]
PP_MICRO = 8  # the config's num_microbatches
PP_SHAPE = (PP_ROWS // PP_MICRO, 16, 16, 1024, 64, dict(causal=True), False, 20)
PP_PROMPT_LENS = (32, 20, 27, 12)  # leg (e)'s ragged prompts, left-padded to 32
PP_NEW = 32  # new tokens per prompt in leg (e)
PP_FP32_LAYERS = 4  # leg (e)'s fp32 cut: one layer per rank
# legs (b)-(e) and their reference run 8 of the 24 layers at full width (one
# per virtual stage: pipe 4 x interleave 2), for the run's time limit
PP_PAIR_LAYERS = 8
PP_LEG_TIMEOUT = 420
# leg (b) against one process, per weight, relative L2 (the qkv bias's key
# slice left out): the masters of non-zero init after each step, and each
# step's update from the initial masters, median and max over the weights.
# The one process runs the same 8 microbatches as 8 minibatches; the
# pipelined step differs from it in the summation order of the lm_head's
# and the embedding's gradients (one product over the 64 rows against 8
# accumulated ones) and in bf16 rounding, as phase 14's split does.
PP_MASTER_TOL = 5e-4
PP_UPDATE_MEDIAN_TOL = 5e-2
PP_UPDATE_MAX_TOL = 3e-1


def _pp_config(**changes):
    """``gpt2_350m_pp`` at PP_PAIR_LAYERS layers (legs (b)-(e) and their
    reference)."""
    overrides = dict(n_layers=PP_PAIR_LAYERS, **changes.pop("model_overrides", {}))
    config, _ = _shell_config("gpt2_350m_pp", seed=SEED, global_batch_size=PP_ROWS,
                              model_overrides=overrides, **changes)
    return config


def _pp_batches(vocab, device):
    """PP_STEPS seeded global batches of [PP_ROWS, 1024]."""
    from tpu_parallel_torch.data import lm_batch

    return [lm_batch(torch.Generator().manual_seed(SEED + 80 + i), PP_ROWS, SHELL_SEQ, vocab,
                     device=device) for i in range(PP_STEPS)]


def _pp_counts():
    from tpu_parallel_torch.parallel import pp

    return [pp.pp_send_launches, pp.pp_recv_launches]


def _pp_grads(trainer, state, batch, mesh):
    """The step's synced gradients on ``batch`` without an update (the
    Trainer's schedule and sync); the caller clears the accumulators."""
    from tpu_parallel_torch.core.accumulate import accumulate_gradients
    from tpu_parallel_torch.models.gpt import make_gpt_1f1b_grad_fn
    from tpu_parallel_torch.parallel import fsdp

    if trainer.model_config.pipe_schedule == "1f1b":
        grads, _ = make_gpt_1f1b_grad_fn(trainer.model_config, mesh=mesh)(state, batch, None)
    else:
        grads, _ = accumulate_gradients(state, batch, state.rng, trainer.config.num_minibatches,
                                        trainer.loss_fn)
    if mesh is not None:
        fsdp.sync_gradients(state.partitioned(grads), ("data", "model"), ("pipe",), mesh=mesh)
    return grads


def _host(tree):
    return {n: v.detach().to("cpu", torch.float32, copy=True) for n, v in tree.items()}


def pp_reference_leg(workdir):
    """One process, no group: ``gpt2_350m_pp`` on one device (a pipe axis
    of 1, its 8 microbatches as 8 minibatches), the step-1 gradients, then
    PP_STEPS steps on the seeded batches; saves the initial masters, the
    gradients and the masters after each step for leg (b), with its step
    times, state bytes and peak memory."""
    from tpu_parallel_torch.core.metrics import compute
    from tpu_parallel_torch.train_lib import Trainer

    config = _pp_config(num_minibatches=PP_MICRO, mesh=dict(data=1, model=1, pipe=1, seq=1),
                        model_overrides=dict(pipe_interleave=1))
    t0 = time.perf_counter()
    trainer = Trainer(config, device="cuda")
    if trainer.mesh is not None or trainer.model.pipe is not None:
        raise AssertionError("the one-process reference runs on a mesh")
    state = trainer.init()
    init_s = time.perf_counter() - t0
    batches = _pp_batches(trainer.model_config.vocab_size, "cuda")
    start = _host(state.params)
    grads = _host(_pp_grads(trainer, state, batches[0], None))
    state.zero_grads()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, masters, step_ms = [], [], []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = trainer.step_fn(state, None, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(compute(metrics)["loss"])
        masters.append(_host(state.params))
    peak = torch.cuda.max_memory_allocated()
    state_bytes = _state_bytes(state)
    del trainer, state
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    torch.save(dict(start=start, grads=grads, losses=losses, masters_by_step=masters),
               Path(workdir, "pp_ref.pt"))
    return dict(losses=losses, step_host_ms=step_ms, max_memory_allocated=peak,
                state_bytes=state_bytes, init_s=init_s, save_s=time.perf_counter() - t0)


def _pp_replicated_digest(state):
    """sha256 of the masters and optimizer moments of the leaves replicated
    over pipe (the embedding, positions, ``norm_final``, the lm_head), in
    name order: what a step updates (the module's weights are the
    masters' casts)."""
    import hashlib

    h = hashlib.sha256()
    for tree in [state.params] + _named_trees(state)[3:]:
        if tree is state.ema_params:
            continue
        for name in sorted(n for n in tree if n not in state.stages):
            h.update(tree[name].detach().cpu().float().contiguous().numpy())
    return h.hexdigest()


def _pp_state_bytes(state):
    out = dict(stage=0, replicated=0)
    for tree in _named_trees(state):
        for name, t in tree.items():
            out["stage" if name in state.stages else "replicated"] += t.numel() * t.element_size()
    return out


def _pp_hop_ms(mesh, cfg):
    """Host ms of one point-to-point hop: every rank sends a microbatch's
    bf16 activation [8, 1024, d_model] to the next and receives one from
    the previous, in one exchange (the ring's tick), averaged over 5."""
    import torch.distributed as dist

    from tpu_parallel_torch.parallel import pp

    group, size, index = pp.pipe_axis(mesh)
    act = torch.randn(PP_ROWS // PP_MICRO, SHELL_SEQ, cfg.d_model, device="cuda:0").to(cfg.dtype)
    buf = torch.empty_like(act)
    dist.barrier()
    ring = lambda: pp._exchange(group, [(act, (index + 1) % size)], [(buf, (index - 1) % size)])
    ring()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        ring()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / 5 * 1e3, act.numel() * act.element_size()


def pp_rank_leg(rank, rendezvous, workdir):
    """Legs (b)-(e), one of PP_RANKS gloo ranks on the one card over a
    data=1 x pipe=4 mesh.  (b) ``gpt2_350m_pp`` (GPipe, interleave 2): the
    step-1 synced gradients and PP_STEPS counted steps on the seeded
    batches against the reference (this rank's stage leaves, and the
    replicated ones), a digest of the replicated leaves after every step,
    launches and point-to-point ops per step, state bytes and peak memory,
    ms per hop.  (d) The checkpoint of (b) restored bitwise into a fresh
    Trainer, one more step on both.  (c) 1F1B (interleave 1): the step-1
    gradients against the reference, one counted step, peak memory.  (e)
    ``generate_sharded``."""
    import torch.distributed as dist

    from tpu_parallel_torch.core.metrics import compute
    from tpu_parallel_torch.runtime import MeshConfig, initialize, make_mesh, process_info
    from tpu_parallel_torch.train_lib import Trainer

    initialize(rendezvous, PP_RANKS, rank, backend="gloo", device="cuda:0")
    _share_cores(PP_RANKS)
    start_s, legs_s = time.perf_counter(), {}

    def lap(name):
        legs_s[name] = time.perf_counter() - start_s - sum(legs_s.values())

    result = dict(rank=rank, process_info=process_info(), legs_s=legs_s,
                  free_bytes_at_start=torch.cuda.mem_get_info()[0])
    mesh = make_mesh(MeshConfig(data=1, pipe=PP_RANKS))
    config = _pp_config()
    t0 = time.perf_counter()
    trainer = Trainer(config, mesh, device="cuda:0")
    state = trainer.init()
    result["init_s"] = time.perf_counter() - t0
    cfg = trainer.model_config
    if cfg.pipe_size != PP_RANKS or cfg.pipe_interleave != 2:
        raise AssertionError(f"leg (b) pipe_size {cfg.pipe_size}, interleave "
                             f"{cfg.pipe_interleave}")
    ref = torch.load(Path(workdir, "pp_ref.pt"), weights_only=True, mmap=True)
    keys = sorted(state.params)
    result.update(layers=trainer.model.blocks.layer_ids, stage_leaves=len(state.stages))
    start = _host(state.params)
    if any(not torch.equal(start[n], ref["start"][n]) for n in keys):
        raise AssertionError(f"rank {rank}: the initial masters differ from one process's")
    batches = _pp_batches(cfg.vocab_size, "cuda:0")
    lap("init")
    grads = _pp_grads(trainer, state, batches[0], mesh)
    torch.cuda.synchronize()
    lap("step1_grads")
    grads = _host(grads)
    state.zero_grads()
    grad_rel = _rel_by_weight(cfg, grads, {n: ref["grads"][n] for n in keys})
    del grads
    lap("step1_compare")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()  # the main path starts here
    losses, digests, per_step, p2p, step_ms, master_rel, update_rel = [], [], [], [], [], [], []
    for i, batch in enumerate(batches):
        before, pbefore = _launch_counts(), _pp_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = trainer.step_fn(state, None, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        per_step.append([a - b for a, b in zip(_launch_counts(), before)])
        p2p.append([a - b for a, b in zip(_pp_counts(), pbefore)])
        losses.append(compute(metrics)["loss"])
        lap(f"step{i + 1}")
        digests.append(_pp_replicated_digest(state))
        lap(f"step{i + 1}_digest")
        full = _host(state.params)
        want = ref["masters_by_step"][i]
        master_rel.append(_rel_by_weight(cfg, {n: full[n] for n in keys if start[n].norm() > 0},
                                         want))
        update_rel.append(_rel_by_weight(cfg, {n: full[n] for n in keys}, want, init=start))
        del full
        lap(f"step{i + 1}_compare")
    launches = dict(zip(LAUNCH_COUNTERS, _launch_counts()))
    peak = torch.cuda.max_memory_allocated()
    hop_ms, hop_bytes = _pp_hop_ms(mesh, cfg)
    worst = lambda rel: max(rel.items(), key=lambda kv: kv[1])
    loss_diffs = [abs(a - b) for a, b in zip(losses, ref["losses"])]
    result.update(
        losses=losses, ref_losses=ref["losses"], loss_diffs=loss_diffs, digests=digests,
        launches_per_step=per_step, p2p_per_step=p2p, launches=launches, step_host_ms=step_ms,
        max_memory_allocated=peak, state_bytes=_pp_state_bytes(state), hop_host_ms=hop_ms,
        hop_bytes=hop_bytes, step1_grad_rel_max=worst(grad_rel),
        step1_grad_rel_median=sorted(grad_rel.values())[len(grad_rel) // 2],
        master_rel_max=[worst(r) for r in master_rel],
        update_rel_median=[sorted(r.values())[len(r) // 2] for r in update_rel],
        update_rel_max=[worst(r) for r in update_rel])
    if max(loss_diffs) > LOSS_TOL or result["step1_grad_rel_max"][1] > TRAIN_GRAD_TOL \
            or max(m for _, m in result["master_rel_max"]) > PP_MASTER_TOL \
            or max(result["update_rel_median"]) > PP_UPDATE_MEDIAN_TOL \
            or max(m for _, m in result["update_rel_max"]) > PP_UPDATE_MAX_TOL:
        raise AssertionError(f"leg (b) rank {rank} disagrees with one process: "
                             f"{ {k: v for k, v in result.items() if k != 'digests'} }")
    gc.collect()
    torch.cuda.empty_cache()
    result.update(checkpoint=_pp_checkpoint(trainer, config, mesh, batches[0], rank, workdir))
    lap("checkpoint")
    del trainer, state
    gc.collect()
    torch.cuda.empty_cache()
    result.update(one_f_one_b=_pp_1f1b(mesh, ref, batches, rank))
    lap("one_f_one_b_and_generate")
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    dist.destroy_process_group()
    return result


def _pp_checkpoint(trainer, config, mesh, batch, rank, workdir):
    """Leg (d): (b)'s state saved (every rank its stage's keys and the
    replicated ones, ``torch.distributed.checkpoint``), restored into a
    fresh Trainer with every tensor bitwise equal, then one more step on
    both: the same loss."""
    from tpu_parallel_torch.core.metrics import compute
    from tpu_parallel_torch.train_lib import Trainer

    directory = str(Path(workdir, "pp_ckpt"))
    step = trainer.state.step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.save_checkpoint(directory, step)
    save_ms = (time.perf_counter() - t0) * 1e3
    fresh = Trainer(config, mesh, device="cuda:0")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fresh.restore_checkpoint(directory)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    want, got = _local_leaves(trainer.state.state_dict()), _local_leaves(fresh.state.state_dict())
    module_equal = all(torch.equal(a, b) for a, b in zip(trainer.model.parameters(),
                                                         fresh.model.parameters()))
    if got.keys() != want.keys() or not all(torch.equal(got[k], want[k]) for k in want) \
            or not module_equal or fresh.state.step != step:
        raise AssertionError(f"rank {rank}: the restored state differs from the saved one")
    losses = []
    for t in (trainer, fresh):
        losses.append(compute(t.step_fn(t.state, None, batch)[1])["loss"])
        gc.collect()
        torch.cuda.empty_cache()
    if losses[0] != losses[1] or fresh.state.step != step + 1:
        raise AssertionError(f"rank {rank}: the restored state trains apart: {losses}")
    tensors = len(want)
    del fresh
    gc.collect()
    torch.cuda.empty_cache()
    return dict(save_ms=save_ms, restore_ms=restore_ms, local_tensors=tensors, next_loss=losses[0])


def _pp_1f1b(mesh, ref, batches, rank):
    """Leg (c): ``gpt2_350m_pp`` under ``pipe_schedule="1f1b"`` (interleave
    1; JAX refuses 1F1B with interleave) from the same seeded init: the
    step-1 synced gradients against the reference, then one counted step
    (launches and point-to-point ops) and its peak memory; then leg (e)
    on its trained module."""
    from tpu_parallel_torch.core.metrics import compute
    from tpu_parallel_torch.train_lib import Trainer

    config = _pp_config(model_overrides=dict(pipe_interleave=1, pipe_schedule="1f1b"))
    t0 = time.perf_counter()
    trainer = Trainer(config, mesh, device="cuda:0")
    state = trainer.init()
    init_s = time.perf_counter() - t0
    cfg = trainer.model_config
    if any(not torch.equal(p.cpu(), ref["start"][n]) for n, p in state.params.items()):
        raise AssertionError(f"rank {rank}: leg (c)'s initial masters differ from one process's")
    grads = _host(_pp_grads(trainer, state, batches[0], mesh))
    state.zero_grads()
    rel = _rel_by_weight(cfg, grads, {n: ref["grads"][n] for n in grads})
    del grads
    worst = max(rel.items(), key=lambda kv: kv[1])
    if worst[1] > TRAIN_GRAD_TOL:
        raise AssertionError(f"leg (c) rank {rank}: 1F1B step-1 gradients against one "
                             f"process's, worst {worst}")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    before = _pp_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, metrics = trainer.step_fn(state, None, batches[0])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    out = dict(layers=trainer.model.blocks.layer_ids, step1_grad_rel_max=worst,
               step1_grad_rel_median=sorted(rel.values())[len(rel) // 2],
               launches_per_step=_launch_counts(),
               p2p_per_step=[a - b for a, b in zip(_pp_counts(), before)],
               loss=compute(metrics)["loss"], step_host_ms=step_ms,
               max_memory_allocated=torch.cuda.max_memory_allocated())
    t0 = time.perf_counter()
    out.update(generate=_pp_generate(trainer, mesh, rank), init_s=init_s,
               generate_s=time.perf_counter() - t0)
    del trainer, state
    return out


def _pp_prompts(vocab):
    gen = torch.Generator().manual_seed(SEED + 90)
    rows = [torch.randint(1, vocab, (n,), generator=gen).tolist() for n in PP_PROMPT_LENS]
    width = max(PP_PROMPT_LENS)
    prompt = torch.zeros(len(rows), width, dtype=torch.long)
    mask = torch.zeros(len(rows), width, dtype=torch.bool)
    for i, row in enumerate(rows):
        prompt[i, width - len(row):] = torch.tensor(row)
        mask[i, width - len(row):] = True
    return prompt.cuda(), mask.cuda(), rows


def _pp_generate(trainer, mesh, rank):
    """Leg (e).  fp32 (TF32 off) on a PP_FP32_LAYERS-layer cut of GPT-2
    350M (seeded, one layer per rank): greedy ``generate_sharded`` on the
    ragged prompts against static ``generate()`` of one process on the same
    weights (top-2 rule, rank 0).  bf16 on (c)'s trained module
    (PP_PAIR_LAYERS layers): ms per token and tokens/s, and a top-k
    sampled call."""
    import dataclasses

    from tpu_parallel_torch.models import GPTLM
    from tpu_parallel_torch.models.generate import generate, generate_sharded

    cfg = trainer.model_config
    cut = dataclasses.replace(cfg, dtype=torch.float32, remat=False, n_layers=PP_FP32_LAYERS)
    sharded = GPTLM(cut, device="cuda:0", seed=SEED, mesh=mesh).eval()
    prompt, mask, rows = _pp_prompts(cfg.vocab_size)
    got = generate_sharded(sharded, prompt, max_new_tokens=PP_NEW, prompt_mask=mask).tolist()
    report = dict(tokens=got)
    del sharded
    if rank == 0:
        dense = GPTLM(dataclasses.replace(cut, pipe_size=1), device="cuda:0", seed=SEED).eval()
        with torch.inference_mode():
            want = generate(dense, prompt, max_new_tokens=PP_NEW, prompt_mask=mask).tolist()
        report["fp32_against_generate"] = [
            _top2_held(dense, row, g, w, f"generate_sharded row {i}")
            for i, (row, g, w) in enumerate(zip(rows, got, want))]
        del dense
    gc.collect()
    torch.cuda.empty_cache()
    model = trainer.model.eval()
    before = _pp_counts()
    generate_sharded(model, prompt, max_new_tokens=PP_NEW, prompt_mask=mask)
    hops = [a - b for a, b in zip(_pp_counts(), before)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    generate_sharded(model, prompt, max_new_tokens=PP_NEW, prompt_mask=mask)
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    report.update(bf16_ms_per_token=call_s / PP_NEW * 1e3,
                  bf16_tokens_per_s=len(rows) * PP_NEW / call_s, p2p_per_call=hops,
                  top_k=generate_sharded(model, prompt, rng=torch.Generator().manual_seed(SEED),
                                         max_new_tokens=8, prompt_mask=mask, temperature=0.8,
                                         top_k=40).tolist())
    model.train()
    return report


def pp_cli_rank_leg(metrics):
    """Leg (a)'s rank, under torchrun: ``tpu_parallel_torch.train``'s
    ``main`` on ``--config=gpt2_350m_pp`` with the mesh's pipe axis and
    ``pipe_interleave`` set to 1 and ``pipe_schedule="1f1b"`` (the config
    declares no such field, so this leg adds it to the loaded config: the
    pipe-1 1F1B JAX calls the legitimate degenerate) for PP_STEPS steps on
    CLI_ROWS rows, with each step's kernel launches and loss."""
    from tpu_parallel_torch import configs, train
    from tpu_parallel_torch.core.metrics import accumulate_metrics, compute
    from tpu_parallel_torch.train_lib import Trainer

    per_step, losses = [], []
    real_step, real_config = Trainer.step_fn, configs.get_config

    def step(self, state, metrics, batch):
        before = _launch_counts()
        state, step_metrics = real_step(self, state, None, batch)
        per_step.append([a - b for a, b in zip(_launch_counts(), before)])
        losses.append(compute(step_metrics)["loss"])
        return state, accumulate_metrics(metrics, step_metrics)

    def get_config(name):
        cd = real_config(name)
        cd["model_overrides"]["pipe_schedule"] = "1f1b"
        return cd

    Trainer.step_fn = step
    configs.get_config = get_config
    _reset_launches()  # the main path starts here
    code = train.main(["--config=gpt2_350m_pp", "--config.mesh.pipe=1",
                       "--config.model_overrides.pipe_interleave=1",
                       f"--config.model_overrides.n_layers={CLI_LAYERS}",
                       f"--config.steps={PP_STEPS}", f"--config.global_batch_size={CLI_ROWS}",
                       "--config.log_every=1", f"--metrics-out={metrics}"])
    return dict(exit=code, launches_per_step=per_step, losses=losses,
                launches=dict(zip(LAUNCH_COUNTERS, _launch_counts())))


def pp_cli_leg(work, cores):
    """Leg (a), launched: ``python -m torch.distributed.run --standalone
    --nproc_per_node=1`` over this script's ``pp_cli_rank`` leg;
    :func:`pp_cli_check` holds it."""
    metrics = Path(work, "pp_metrics.prom")
    return _launch(_torchrun(str(Path(__file__).resolve()), "--leg", "pp_cli_rank",
                             str(metrics)), cores), metrics


def pp_cli_check(collected):
    """Leg (a): exit 0, one NCCL process; per step and layer, each of the 8
    microbatches launches the forward kernel twice (the forward and the
    backward's recompute) and the backward kernel once; a falling loss;
    ``train_loss`` in the metrics."""
    (out, wall), metrics = collected
    topology = [json.loads(line[len("topology: "):]) for line in out.splitlines()
                if line.startswith("topology: ")]
    if len(topology) != 1 or topology[0]["process_count"] != 1 \
            or topology[0]["backend"] != "nccl":
        raise AssertionError(f"CLI topology lines {topology}")
    result = json.loads([line for line in out.splitlines()
                         if line.startswith(DP_RESULT)][-1][len(DP_RESULT):])
    want = [2 * PP_MICRO * CLI_LAYERS, PP_MICRO * CLI_LAYERS]
    if result["exit"] != 0 or result["launches_per_step"] != [want] * PP_STEPS:
        raise AssertionError(f"leg (a): exit {result['exit']}, launches per step "
                             f"{result['launches_per_step']}, want {want}")
    _falls("leg (a)", result["losses"])
    if "train_loss" not in metrics.read_text():
        raise AssertionError("CLI metrics without train_loss")
    result.update(wall_s=wall, topology=topology[0])
    return result


def pp_phase(smi, work, cli_collected):
    """Phase 15: the kernels at the PP pass's shape against their plain
    versions, then legs (a)-(e) in the directory ``work``.  Returns the
    report, the kernels' rows and leg (b)'s launches (rank 0's main
    path)."""
    start = time.perf_counter()
    legs_s = {}

    def lap(name):
        legs_s[name] = time.perf_counter() - start - sum(legs_s.values())

    ranks = _spawn_ranks("pp_rank", work, PP_RANKS)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 85)
    rows = dict(fwd=fwd_kernel_row("t_pp_pass", PP_SHAPE, gen),
                bwd=bwd_kernel_row("t_pp_pass", PP_SHAPE, gen, main_path=True))
    gc.collect()
    torch.cuda.empty_cache()
    lap("kernels")
    cli = pp_cli_check(cli_collected)
    log(f"[pp cli] torchrun --standalone --nproc_per_node=1 over -m tpu_parallel_torch.train's "
        f"main --config=gpt2_350m_pp --config.mesh.pipe=1 --config.model_overrides."
        f"pipe_interleave=1 --config.model_overrides.n_layers={CLI_LAYERS} (pipe_schedule="
        f"'1f1b' added to the loaded config) --config.steps="
        f"{PP_STEPS} --config.global_batch_size={CLI_ROWS} (NCCL, a group of one; started and "
        f"collected in phase 12): exit 0, collected {cli['wall_s']:.1f} s after its launch; "
        f"topology {cli['topology']}; launches per step (flash_fwd, flash_bwd) "
        f"{cli['launches_per_step']}; losses {[round(x, 5) for x in cli['losses']]}")
    ref = _reference(pp_reference_leg, work)
    lap("reference")
    ranks = _join_ranks(ranks, PP_LEG_TIMEOUT)
    lap("ranks")
    r0 = ranks[0]
    n, v, m = PP_RANKS, 2, PP_MICRO
    per_rank_layers = PP_PAIR_LAYERS // n
    want_launches = [m * per_rank_layers, m * per_rank_layers]
    for p in ranks:
        r = p["rank"]
        if p["launches_per_step"] != [want_launches] * PP_STEPS:
            raise AssertionError(f"leg (b) rank {r}: launches per step {p['launches_per_step']}, "
                                 f"want {want_launches}")
        # each of the rank's m * v (microbatch, chunk) steps receives its
        # input and sends its output, forward, and the reverse backward,
        # except rank 0's first chunk (fed) and the last rank's last
        # (collected): bubbles send nothing
        ops = 2 * m * v - m * (r == 0) - m * (r == n - 1)
        want_p2p = [ops, ops]
        if p["p2p_per_step"] != [want_p2p] * PP_STEPS:
            raise AssertionError(f"leg (b) rank {r}: (sends, receives) per step "
                                 f"{p['p2p_per_step']}, want {want_p2p}")
        f1 = p["one_f_one_b"]
        if f1["launches_per_step"] != [2 * m * per_rank_layers, m * per_rank_layers]:
            raise AssertionError(f"leg (c) rank {r}: launches {f1['launches_per_step']}")
        ops = 2 * m - m * (r == 0) - m * (r == n - 1)
        if f1["p2p_per_step"] != [ops, ops]:
            raise AssertionError(f"leg (c) rank {r}: (sends, receives) {f1['p2p_per_step']}")
    if any(p["digests"] != r0["digests"] for p in ranks):
        raise AssertionError("leg (b): the replicated leaves differ across the ranks")
    if any(p["losses"] != r0["losses"] for p in ranks):
        raise AssertionError("leg (b): the ranks' synced losses differ")
    gens = [p["one_f_one_b"]["generate"] for p in ranks]
    for key in ("tokens", "top_k"):
        if any(g[key] != gens[0][key] for g in gens):
            raise AssertionError(f"leg (e): the ranks' {key} differ")
    gib = lambda x: f"{x / 2**30:.3f} GiB"
    bubble = (n - 1) / (m * v + n - 1)
    log(f"[pp ranks] {PP_RANKS} gloo processes on cuda:0 ({r0['process_info']}), mesh data=1 x "
        f"pipe={n}, gpt2_350m_pp at {PP_PAIR_LAYERS} of its 24 layers ({m} microbatches of "
        f"[{PP_ROWS // m}, 1024], interleave {v}: "
        f"rank r holds layers {[p['layers'] for p in ranks]}); free at the start "
        f"{gib(r0['free_bytes_at_start'])}; activations and gradients cross the ranks "
        f"through host buffers (gloo's point-to-point takes no CUDA tensor)")
    log(f"  launches per step per rank {[p['launches_per_step'][0] for p in ranks]}; (sends, "
        f"receives) per step {[p['p2p_per_step'][0] for p in ranks]}; replicated leaves bitwise "
        f"equal across the ranks after every step; losses {[round(x, 5) for x in r0['losses']]} "
        f"against one process's {[round(x, 5) for x in r0['ref_losses']]} (|diff| "
        f"{r0['loss_diffs']}, tol {LOSS_TOL})")
    log("  against one process, per rank: step-1 synced gradients relative L2 per weight "
        + "; ".join(f"rank {p['rank']} median {p['step1_grad_rel_median']:.3e} max "
                    f"{p['step1_grad_rel_max'][1]:.3e} ({p['step1_grad_rel_max'][0]})"
                    for p in ranks)
        + f" (tol {TRAIN_GRAD_TOL}); masters after each step worst "
        + str([[(n_, f'{x:.2e}') for n_, x in p["master_rel_max"]] for p in ranks])
        + f" (tol {PP_MASTER_TOL}); updates median "
        + str([[f'{x:.2e}' for x in p["update_rel_median"]] for p in ranks])
        + f" (tol {PP_UPDATE_MEDIAN_TOL}), max "
        + str([[(n_, f'{x:.2e}') for n_, x in p["update_rel_max"]] for p in ranks])
        + f" (tol {PP_UPDATE_MAX_TOL})")
    log(f"  step host ms per rank {[[round(x, 1) for x in p['step_host_ms']] for p in ranks]} "
        f"against one process's {[round(x, 1) for x in ref['step_host_ms']]}; bubble share the "
        f"schedule implies (n-1)/(m v + n - 1) = {bubble:.4f}; one hop (a [{PP_ROWS // m}, 1024, "
        f"1024] bf16 activation, {r0['hop_bytes']} bytes, staged through the host) "
        f"{[round(p['hop_host_ms'], 2) for p in ranks]} host ms; state per rank "
        + "; ".join(f"rank {p['rank']} stage {gib(p['state_bytes']['stage'])} + replicated "
                    f"{gib(p['state_bytes']['replicated'])}, max memory allocated in a step "
                    f"{gib(p['max_memory_allocated'])}" for p in ranks)
        + f"; one process: {gib(sum(ref['state_bytes'].values()))}, "
        f"{gib(ref['max_memory_allocated'])} (8 minibatches)")
    log(f"  rank legs' seconds {[{k: round(v, 1) for k, v in p['legs_s'].items()} for p in ranks]} "
        f"(1F1B's init {[round(p['one_f_one_b']['init_s'], 1) for p in ranks]}, leg (e) "
        f"{[round(p['one_f_one_b']['generate_s'], 1) for p in ranks]}); the reference's init "
        f"{ref['init_s']:.1f} s, save {ref['save_s']:.1f} s")
    f1s = [p["one_f_one_b"] for p in ranks]
    log(f"[pp 1f1b] interleave 1 (rank r holds layers {[f['layers'] for f in f1s]}): step-1 "
        f"synced gradients against one process's median "
        f"{[round(f['step1_grad_rel_median'], 5) for f in f1s]}, max "
        f"{[(f['step1_grad_rel_max'][0], round(f['step1_grad_rel_max'][1], 5)) for f in f1s]} "
        f"(tol {TRAIN_GRAD_TOL}); launches per step {[f['launches_per_step'] for f in f1s]}; "
        f"(sends, receives) {[f['p2p_per_step'] for f in f1s]}; step host ms "
        f"{[round(f['step_host_ms'], 1) for f in f1s]}; max memory allocated in a step "
        f"{[gib(f['max_memory_allocated']) for f in f1s]} against GPipe's (interleave 2) "
        f"{[gib(p['max_memory_allocated']) for p in ranks]}")
    ck = [p["checkpoint"] for p in ranks]
    log(f"[pp checkpoint] save {[round(c['save_ms'], 1) for c in ck]} ms, restore "
        f"{[round(c['restore_ms'], 1) for c in ck]} ms into a fresh Trainer: local tensors per "
        f"rank {[c['local_tensors'] for c in ck]} bitwise equal; one more step on both: loss "
        f"{ck[0]['next_loss']:.5f} equal")
    g0 = gens[0]
    log(f"[pp generate] fp32 (TF32 off, {PP_FP32_LAYERS} layers, seeded) generate_sharded on "
        f"{len(PP_PROMPT_LENS)} ragged prompts {PP_PROMPT_LENS}, {PP_NEW} new: greedy tokens "
        f"equal on every rank, against static generate() of one process on the same weights "
        f"{g0['fp32_against_generate']}; bf16 on leg (c)'s module ({PP_PAIR_LAYERS} layers) "
        f"{[round(g['bf16_ms_per_token'], 2) for g in gens]} ms per token, "
        f"{g0['bf16_tokens_per_s']:.1f} tokens/s, (sends, receives) per call "
        f"{[g['p2p_per_call'] for g in gens]}; top-k sampled tokens equal on every rank "
        f"(row 0 {g0['top_k'][0]})")
    phase_s = time.perf_counter() - start
    log(f"[pp] phase 15 took {phase_s:.1f} s ("
        + ", ".join(f"{k} {v_:.1f}" for k, v_ in legs_s.items()) + ")")
    log(f"card: {smi}")
    return dict(cli=cli, reference=ref, ranks=ranks, bubble_share=bubble,
                phase_s=phase_s, legs_s=legs_s), rows, r0["launches"]



# phase 16: sequence parallelism on the card (``gpt2_125m_long`` at the
# context docs/04_scaling_further.md trains, 32768, over a seq axis of 4 with
# data 1: four gloo ranks on the one card, each holding [rows, 8192]
# tokens).  (a) In this process, the chunk wrapper at full width; the chunk
# kernels' rows.  A one-process reference, then four rank processes for (b)
# ring and (c) Ulysses attention; (d) the CLI under torchrun (launched and
# collected in phase 12).
SP_RANKS = 4
SP_SEQ = 32768
SP_LOCAL = SP_SEQ // SP_RANKS
SP_ROWS = 1  # global batch: one row of SP_SEQ (the run's time limit)
SP_MINIBATCHES = 1
SP_STEPS = 3  # one warm-up step, then the timed ones
SP_WINDOW = 4096  # (a)'s windowed split: one chunk back at most
SP_LEG_TIMEOUT = 600
SP_CLI_LAYERS = 2  # (d) runs 2 of the 12 layers at full width (the run's time limit)
SP_LAYERS = 4  # (b) and (c) and their reference: 4 of the 12 layers (the run's time limit)
SP_CLI_STEPS = 3
# the kernels at the ring's chunk shapes (the diagonal, a past chunk, a
# past chunk straddling the window's edge) and at Ulysses' inner shape
SP_DIAG_SHAPE = (1, 12, 12, SP_LOCAL, 64, dict(causal=True), False, 10)
SP_PAST_SHAPE = (1, 12, 12, SP_LOCAL, 64, dict(causal=False), False, 10)
SP_BAND_SHAPE = (1, 12, 12, SP_LOCAL, 64, dict(causal=False, q_offset=SP_LOCAL,
                                              window=SP_WINDOW), False, 10)
SP_ULYSSES_SHAPE = (1, 3, 3, SP_SEQ, 64, dict(causal=True), False, 5)
SP_PLAIN_SPLIT = 3  # the plain versions at Ulysses' shape, one head at a time


def _sp_chunk_kernels(q, k, v, seg, window):
    """A [B, S, H, D] sequence as SP_RANKS chunks through
    ``flash_chunk_attention`` (the kernels), each (query chunk, key chunk)
    pair by the ring's rules (``_chunk_band``: the diagonal causal, past
    chunks whole or banded, the rest skipped), merged with
    ``combine_chunks``: ``(out, lse)`` fp32, differentiable."""
    from tpu_parallel_torch.ops.flash_attention import flash_chunk_attention
    from tpu_parallel_torch.ops.ring_attention import NEG_INF, _chunk_band, combine_chunks

    b, s, h, d = q.shape
    c = s // SP_RANKS
    outs, lses = [], []
    for i in range(SP_RANKS):
        out = torch.zeros(b, c, h, d, device=q.device)
        lse = torch.full((b, h, c), NEG_INF, device=q.device)
        for j in range(SP_RANKS):
            band = _chunk_band(i - j, c, SP_RANKS, True, window)
            if band is None:
                continue
            kw = {} if seg is None else dict(segment_ids_q=seg[:, i * c:(i + 1) * c],
                                             segment_ids_kv=seg[:, j * c:(j + 1) * c])
            o, part = flash_chunk_attention(
                q[:, i * c:(i + 1) * c], k[:, j * c:(j + 1) * c], v[:, j * c:(j + 1) * c],
                causal=band[0], window=band[1], q_offset=band[2], **kw)
            out, lse = combine_chunks(out, lse, o.float(), part)
        outs.append(out)
        lses.append(lse)
    return torch.cat(outs, 1), torch.cat(lses, 2)


def _sp_chunk_plain(q, k, v, seg, window, do):
    """:func:`_sp_chunk_kernels` on the plain versions: each pair's forward
    by ``flash_fwd_reference``, the merge differentiated by autograd, each
    pair's backward by ``flash_bwd_reference`` on the merge's cotangents
    (``do_c`` rounded to bf16 as the kernel path's cast does, and
    ``dlse_c``).  Returns ``(out, lse, dq, dk, dv, max |dlse|)``."""
    from tpu_parallel_torch.ops import flash_attention as fa
    from tpu_parallel_torch.ops.ring_attention import NEG_INF, _chunk_band, combine_chunks

    b, s, h, d = q.shape
    c = s // SP_RANKS
    blk = lambda x, i: x[:, i * c:(i + 1) * c]  # noqa: E731
    grads = [torch.zeros(x.shape, device=x.device) for x in (q, k, v)]
    outs, lses, dlse_max = [], [], 0.0
    for i in range(SP_RANKS):
        out = torch.zeros(b, c, h, d, device=q.device)
        lse = torch.full((b, h, c), NEG_INF, device=q.device)
        parts = []
        for j in range(SP_RANKS):
            band = _chunk_band(i - j, c, SP_RANKS, True, window)
            if band is None:
                continue
            seg_kw = (None, None) if seg is None else (blk(seg, i), blk(seg, j))
            args = (blk(q, i).transpose(1, 2), blk(k, j).transpose(1, 2),
                    blk(v, j).transpose(1, 2), *seg_kw)
            opts = dict(causal=band[0], window=band[1], q_offset=band[2])
            o, part = fa.flash_fwd_reference(*args, **opts)
            leaves = (o.transpose(1, 2).float().requires_grad_(), part.clone().requires_grad_())
            parts.append((j, args, opts, o, part, leaves))
            out, lse = combine_chunks(out, lse, *leaves)
        cots = torch.autograd.grad(out, [x for p in parts for x in p[5]], blk(do, i).float())
        for n, (j, args, opts, o, part, _) in enumerate(parts):
            do_c, dlse_c = cots[2 * n].to(q.dtype).transpose(1, 2), cots[2 * n + 1]
            dlse_max = max(dlse_max, dlse_c.abs().max().item())
            with torch.no_grad():
                dq, dk, dv = fa.flash_bwd_reference(*args, o, part, do_c, dlse=dlse_c, **opts)
            grads[0][:, i * c:(i + 1) * c] += dq.transpose(1, 2).float()
            grads[1][:, j * c:(j + 1) * c] += dk.transpose(1, 2).float()
            grads[2][:, j * c:(j + 1) * c] += dv.transpose(1, 2).float()
        outs.append(out.detach())
        lses.append(lse.detach())
    return torch.cat(outs, 1), torch.cat(lses, 2), *grads, dlse_max


def sp_chunk_leg(seed):
    """(a): one [1, SP_SEQ] sequence of 12 heads of 64 (q, k, v views of a
    fused [1, S, 12, 192] buffer, as the model's) split into SP_RANKS
    chunks through the chunk wrapper, plain, under SP_WINDOW and packed:
    out and lse against one flash call over the whole sequence and against
    the plain versions through the same merge; the gradients through the
    merge (the lse cotangent reaching the backward kernel as dlse) against
    the plain versions', row by row; the pairs' launches."""
    from tpu_parallel_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(seed + 90)
    out = {}
    for name, window, packed in (("plain", 0, False), ("window", SP_WINDOW, False),
                                 ("packed", 0, True)):
        qkv = torch.randn(1, SP_SEQ, 12, 192, device="cuda", generator=gen).to(torch.bfloat16)
        do = torch.randn(1, SP_SEQ, 12, 64, device="cuda", generator=gen).to(torch.bfloat16)
        seg = _packed(1, SP_SEQ, gen) if packed else None
        leaf = qkv.detach().requires_grad_()
        before = _launch_counts()
        got, got_lse = _sp_chunk_kernels(*leaf.split(64, -1), seg, window)
        got.backward(do.float())
        torch.cuda.synchronize()
        launches = [a - b for a, b in zip(_launch_counts(), before)]
        dq, dk, dv = leaf.grad.split(64, -1)
        q, k, v = qkv.split(64, -1)
        with torch.inference_mode():
            full, full_lse = fa._flash_fwd(q.transpose(1, 2), k.transpose(1, 2),
                                           v.transpose(1, 2), seg, seg, window=window)
        p_out, p_lse, pdq, pdk, pdv, dlse_max = _sp_chunk_plain(q, k, v, seg, window, do)
        full = full.transpose(1, 2).float()
        live_rows = (full_lse > fa.NEG_INF / 2).transpose(1, 2)
        live = live_rows[..., None].expand_as(full)
        got_out = got.detach()
        out_rule = dict(rtol=OUT_ROW_RTOL, atol=OUT_ROW_ATOL)
        row = dict(
            launches=launches,
            full_out_max_abs_err=(got_out - full).abs()[live].max().item(),
            full_out_worst_row_ratio=row_error_ratio(got_out[live_rows], full[live_rows],
                                                     **out_rule),
            full_lse_max_abs_err=(got_lse - full_lse).abs().max().item(),
            plain_out_max_abs_err=(got_out - p_out).abs().max().item(),
            plain_out_worst_row_ratio=row_error_ratio(got_out, p_out, **out_rule),
            plain_out_rms=p_out.square().mean().sqrt().item(),
            plain_lse_max_abs_err=(got_lse - p_lse).abs().max().item(),
            worst_row_ratio={n: row_error_ratio(g, w)
                             for n, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), (pdq, pdk, pdv))},
            plain_dlse_max_abs=dlse_max)
        torch.testing.assert_close(got_out[live], full[live], atol=OUT_TOL, rtol=OUT_TOL)
        torch.testing.assert_close(got_lse, full_lse, atol=LSE_TOL, rtol=0)
        torch.testing.assert_close(got_out, p_out, atol=OUT_TOL, rtol=OUT_TOL)
        torch.testing.assert_close(got_lse, p_lse, atol=LSE_TOL, rtol=0)
        pairs = sum(1 for i in range(SP_RANKS) for j in range(SP_RANKS)
                    if _sp_band(i - j, window) is not None)
        if launches != [pairs, pairs] or max(row["worst_row_ratio"].values()) > 1 \
                or row["full_out_worst_row_ratio"] > 1 or row["plain_out_worst_row_ratio"] > 1 \
                or not dlse_max > 0:
            raise AssertionError(f"(a) {name}: {row}, want {pairs} launches of each kernel")
        out[name] = row
        del qkv, do, leaf, got, got_out, got_lse, full, p_out, pdq, pdk, pdv, dq, dk, dv
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _sp_band(j, window):
    from tpu_parallel_torch.ops.ring_attention import _chunk_band

    return _chunk_band(j, SP_LOCAL, SP_RANKS, True, window)


def _sp_config(impl, **changes):
    config, _ = _shell_config(
        "gpt2_125m_long", seed=SEED, global_batch_size=SP_ROWS, num_minibatches=SP_MINIBATCHES,
        model_overrides=dict(seq_len=SP_SEQ, attn_impl=impl, n_layers=SP_LAYERS), **changes)
    return config


def _sp_batches(vocab, device):
    """SP_STEPS seeded global batches of [SP_ROWS, SP_SEQ]."""
    from tpu_parallel_torch.data import lm_batch

    return [lm_batch(torch.Generator().manual_seed(SEED + 95 + i), SP_ROWS, SP_SEQ, vocab,
                     device=device) for i in range(SP_STEPS)]


def _sp_counts():
    from tpu_parallel_torch.ops import ring_attention, ulysses
    from tpu_parallel_torch.parallel import dp

    return [ring_attention.sp_ring_send_launches, ring_attention.sp_ring_recv_launches,
            ulysses.sp_alltoall_launches, dp.dp_allreduce_launches]


def _sp_digest(tree):
    """sha256 of a dict of tensors, in name order."""
    import hashlib

    h = hashlib.sha256()
    for name in sorted(tree):
        h.update(tree[name].detach().cpu().float().contiguous().numpy().tobytes())
    return h.hexdigest()


def sp_reference_leg(workdir):
    """One process, no group: ``gpt2_125m_long`` at SP_SEQ with
    ``attn_impl="flash"``, SP_STEPS steps, the first step's gradients kept;
    saves the initial masters' digest, the gradients and the losses for
    legs (b) and (c), with its step times and peak memory."""
    from tpu_parallel_torch.core.metrics import compute
    from tpu_parallel_torch.train_lib import Trainer

    t0 = time.perf_counter()
    trainer = Trainer(_sp_config("flash", mesh=dict(data=1, model=1, pipe=1, seq=1)),
                      device="cuda")
    if trainer.mesh is not None:
        raise AssertionError("the one-process reference runs on a mesh")
    state = trainer.init()
    init_s = time.perf_counter() - t0
    batches = _sp_batches(trainer.model_config.vocab_size, "cuda")
    digest = _sp_digest(state.params)
    grads = _first_synced_grads(state)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = trainer.step_fn(state, None, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(compute(metrics)["loss"])
    peak = torch.cuda.max_memory_allocated()
    state_bytes = _state_bytes(state)
    del trainer, state
    gc.collect()
    torch.cuda.empty_cache()
    torch.save(dict(digest=digest, grads=grads, losses=losses), Path(workdir, "sp_ref.pt"))
    return dict(losses=losses, step_host_ms=step_ms, max_memory_allocated=peak,
                state_bytes=state_bytes, init_s=init_s)


def _sp_run(impl, mesh, ref, rank):
    """One of legs (b) and (c) in a rank: ``gpt2_125m_long`` at SP_SEQ with
    ``attn_impl=impl`` over the data=1 x seq=SP_RANKS mesh, from the
    reference's init (its digest): SP_STEPS counted steps (the main path:
    the launch counters set to 0 first) with each step's launches, ring
    sends and receives, all-to-alls and gradient all-reduces, the masters'
    digest after each, its wall ms; the first step's synced gradients (as
    the optimizer receives them) against the reference's; state bytes and
    peak memory."""
    from tpu_parallel_torch.core.metrics import compute
    from tpu_parallel_torch.train_lib import Trainer

    start_s, legs_s = time.perf_counter(), {}

    def lap(name):
        legs_s[name] = time.perf_counter() - start_s - sum(legs_s.values())

    trainer = Trainer(_sp_config(impl, mesh=dict(data=1, model=1, pipe=1, seq=SP_RANKS)), mesh,
                      device="cuda:0")
    state = trainer.init()
    cfg = trainer.model_config
    if trainer.batch_spec != ("data", "seq") or _sp_digest(state.params) != ref["digest"]:
        raise AssertionError(f"{impl} rank {rank}: batch spec {trainer.batch_spec} or the "
                             "initial masters differ from one process's")
    batches = [trainer.local_rows(b) for b in _sp_batches(cfg.vocab_size, "cuda:0")]
    if tuple(batches[0].tokens.shape) != (SP_ROWS, SP_LOCAL):
        raise AssertionError(f"{impl} rank {rank}: local batch {tuple(batches[0].tokens.shape)}")
    lap("init")
    synced = _first_synced_grads(state)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()  # the main path starts here
    losses, per_step, comm, step_ms, digests = [], [], [], [], []
    for i, batch in enumerate(batches):
        before, cbefore = _launch_counts(), _sp_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = trainer.step_fn(state, None, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        per_step.append([a - b for a, b in zip(_launch_counts(), before)])
        comm.append([a - b for a, b in zip(_sp_counts(), cbefore)])
        losses.append(compute(metrics)["loss"])
        digests.append(_sp_digest(state.params))
        lap(f"step{i + 1}")
    launches = dict(zip(LAUNCH_COUNTERS, _launch_counts()))
    grad_rel = _rel_by_weight(cfg, synced, ref["grads"])
    worst = max(grad_rel.items(), key=lambda kv: kv[1])
    result = dict(
        losses=losses, ref_losses=ref["losses"],
        loss_diffs=[abs(a - b) for a, b in zip(losses, ref["losses"])],
        launches_per_step=per_step, comm_per_step=comm, launches=launches,
        step_host_ms=step_ms, digests=digests, step1_grad_rel_max=worst,
        step1_grad_rel_median=sorted(grad_rel.values())[len(grad_rel) // 2],
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        state_bytes=sum(_state_bytes(state).values()), legs_s=legs_s, n_layers=cfg.n_layers)
    if max(result["loss_diffs"]) > LOSS_TOL or worst[1] > TRAIN_GRAD_TOL:
        raise AssertionError(f"{impl} rank {rank} disagrees with one process: "
                             f"{ {k: v for k, v in result.items() if k != 'digests'} }")
    del trainer, state, batches
    gc.collect()
    torch.cuda.empty_cache()
    return result


def _first_synced_grads(state):
    """A dict that receives a host copy of the synced gradients of the
    state's next step, as ``apply_gradients`` receives them (the step-1
    gradients without a pass of their own)."""
    snapshot = {}
    apply = state.apply_gradients

    def apply_and_keep(grads, *args, **kwargs):
        if not snapshot:
            snapshot.update(_host(grads))
        return apply(grads, *args, **kwargs)

    state.apply_gradients = apply_and_keep
    return snapshot


def _sp_exchange_ms(mesh):
    """Host ms of one ring hop (every rank sends a [2, 1, SP_LOCAL, 12, 64]
    bf16 K/V buffer to the next and receives one, through the host) and of
    one Ulysses all-to-all of a [1, SP_LOCAL, 12, 64] bf16 activation,
    each averaged over 5 after one warm-up, and their bytes per rank."""
    import torch.distributed as dist

    from tpu_parallel_torch.ops import ring_attention, ulysses
    from tpu_parallel_torch.runtime.comm import group_name

    group = group_name(mesh.get_group("seq"))
    kv = torch.randn(2, 1, SP_LOCAL, 12, 64, device="cuda:0").to(torch.bfloat16)
    x = kv[0]
    out = {}
    for name, fn in (("hop", lambda: ring_attention._rotate(group, [kv])),
                     ("alltoall", lambda: ulysses._all_to_all_op(x, group, True))):
        dist.barrier()
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        out[f"{name}_host_ms"] = (time.perf_counter() - t0) / 5 * 1e3
    out.update(hop_bytes=kv.numel() * kv.element_size(), alltoall_bytes=x.numel() * 2)
    return out


def _sp_ring_op(mesh):
    """The ring op alone on this rank: a seeded [1, SP_SEQ] sequence of 12
    heads of 64 (q, k, v views of a fused qkv buffer; every rank draws it
    whole from one seed), this rank's block through ``ring_flash_attention``
    forward and backward (the backward the model runs: each chunk's kernel
    on the final out and lse, dk and dv travelling home in bf16), against
    one ``flash_attention`` call over the whole sequence (its kernels held
    to the plain versions at Ulysses' [1, SP_SEQ] shape): the block's out,
    dq, dk and dv by the row rules, the kernels' launches, the ring's sends
    and receives."""
    from tpu_parallel_torch.ops import ring_attention
    from tpu_parallel_torch.ops.flash_attention import flash_attention

    c = mesh.get_local_rank("seq")
    gen = torch.Generator(device="cuda:0").manual_seed(SEED + 92)
    qkv = torch.randn(1, SP_SEQ, 12, 192, device="cuda:0", generator=gen).to(torch.bfloat16)
    do = torch.randn(1, SP_SEQ, 12, 64, device="cuda:0", generator=gen).to(torch.bfloat16)
    whole = qkv.detach().requires_grad_()
    want = flash_attention(*whole.split(64, -1))
    want.backward(do)
    block = slice(c * SP_LOCAL, (c + 1) * SP_LOCAL)
    local = qkv[:, block].detach().requires_grad_()
    before, cbefore = _launch_counts(), _sp_counts()
    got = ring_attention.ring_flash_attention(*local.split(64, -1), mesh=mesh)
    got.backward(do[:, block])
    torch.cuda.synchronize()
    launches = [a - b for a, b in zip(_launch_counts(), before)]
    hops = [a - b for a, b in zip(_sp_counts()[:2], cbefore[:2])]
    ratios = dict(out=row_error_ratio(got, want[:, block], OUT_ROW_RTOL, OUT_ROW_ATOL))
    ratios.update({n: row_error_ratio(g, w) for n, g, w in zip(
        ("dq", "dk", "dv"), local.grad.split(64, -1), whole.grad[:, block].split(64, -1))})
    result = dict(worst_row_ratio=ratios, launches=launches, sends_receives=hops,
                  out_rms=want[:, block].float().square().mean().sqrt().item())
    # the diagonal and c past chunks; 3 hops of K/V forward, 3 of K, V, dk,
    # dv backward and 1 taking dk, dv home
    if max(ratios.values()) > 1 or launches != [c + 1] * 2 or hops != [7, 7]:
        raise AssertionError(f"the ring op on seq rank {c} against one flash call: {result}")
    del qkv, do, whole, want, local, got
    torch.cuda.empty_cache()
    return result


def sp_rank_leg(rank, rendezvous, workdir):
    """Legs (b) and (c), one of SP_RANKS gloo ranks on the one card over a
    data=1 x seq=SP_RANKS mesh: :func:`_sp_run` with ring attention, then
    with Ulysses in the same process; the exchanges' host ms; the ring op
    alone against one flash call (:func:`_sp_ring_op`)."""
    import torch.distributed as dist

    from tpu_parallel_torch.runtime import MeshConfig, initialize, make_mesh, process_info

    initialize(rendezvous, SP_RANKS, rank, backend="gloo", device="cuda:0")
    _share_cores(SP_RANKS)
    result = dict(rank=rank, process_info=process_info(),
                  free_bytes_at_start=torch.cuda.mem_get_info()[0])
    mesh = make_mesh(MeshConfig(data=1, seq=SP_RANKS))
    result["seq_coord"] = mesh.get_local_rank("seq")
    ref = torch.load(Path(workdir, "sp_ref.pt"), weights_only=True, mmap=True)
    result["ring"] = _sp_run("ring", mesh, ref, rank)
    result["ulysses"] = _sp_run("ulysses", mesh, ref, rank)
    result["exchange"] = _sp_exchange_ms(mesh)
    result["ring_op"] = _sp_ring_op(mesh)
    del ref
    dist.barrier()
    dist.destroy_process_group()
    return result


def sp_cli_rank_leg(metrics):
    """Leg (d)'s rank, under torchrun (SP_RANKS processes): ``tpu_parallel_torch.
    train``'s ``main`` on ``--config=gpt2_125m_long`` with a seq axis of
    SP_RANKS, ring attention, ``seq_len`` SP_SEQ at SP_CLI_LAYERS layers, one
    row, over gloo on ``cuda:0``, with each step's launches and loss."""
    from tpu_parallel_torch import train
    from tpu_parallel_torch.core.metrics import accumulate_metrics, compute
    from tpu_parallel_torch.train_lib import Trainer

    per_step, losses = [], []
    real_step = Trainer.step_fn

    def step(self, state, metrics, batch):
        before = _launch_counts()
        state, step_metrics = real_step(self, state, None, batch)
        per_step.append([a - b for a, b in zip(_launch_counts(), before)])
        losses.append(compute(step_metrics)["loss"])
        return state, accumulate_metrics(metrics, step_metrics)

    Trainer.step_fn = step
    _share_cores(SP_RANKS)
    _reset_launches()  # the main path starts here
    code = train.main(["--config=gpt2_125m_long", "--config.mesh.data=1",
                       f"--config.mesh.seq={SP_RANKS}", "--config.model_overrides.attn_impl=ring",
                       f"--config.model_overrides.seq_len={SP_SEQ}",
                       f"--config.model_overrides.n_layers={SP_CLI_LAYERS}",
                       "--config.global_batch_size=1", "--config.num_minibatches=1",
                       f"--config.steps={SP_CLI_STEPS}", "--config.log_every=1",
                       f"--metrics-out={metrics}", "--device=cuda:0", "--backend=gloo"])
    import os

    result = dict(exit=code, rank=int(os.environ["RANK"]), launches_per_step=per_step,
                  losses=losses, launches=dict(zip(LAUNCH_COUNTERS, _launch_counts())))
    # the ranks share torchrun's stdout: each writes its result to a file
    Path(metrics).with_name(f"sp_cli_rank{result['rank']}.json").write_text(json.dumps(result))
    return result


def sp_cli_leg(work, cores):
    """Leg (d), launched: ``python -m torch.distributed.run --standalone
    --nproc_per_node=SP_RANKS`` over this script's ``sp_cli_rank`` leg;
    :func:`sp_cli_check` holds it."""
    metrics = Path(work, "sp_metrics.prom")
    cmd = _torchrun(str(Path(__file__).resolve()), "--leg", "sp_cli_rank", str(metrics))
    cmd[cmd.index("--nproc_per_node=1")] = f"--nproc_per_node={SP_RANKS}"
    return _launch(cmd, cores), metrics


def sp_cli_check(collected):
    """Leg (d): exit 0 on every rank, one topology line (SP_RANKS processes,
    gloo); per step, rank r launches each kernel (r + 1) x SP_CLI_LAYERS
    times (the diagonal and r past chunks per layer, the proj_attn policy
    keeping the ring's output); a falling loss, equal on every rank;
    ``train_loss`` in the metrics."""
    (out, wall), metrics = collected
    topology = [json.loads(line[len("topology: "):]) for line in out.splitlines()
                if line.startswith("topology: ")]
    if len(topology) != 1 or topology[0]["process_count"] != SP_RANKS \
            or topology[0]["backend"] != "gloo":
        raise AssertionError(f"CLI topology lines {topology}")
    ranks = [json.loads(metrics.with_name(f"sp_cli_rank{r}.json").read_text())
             for r in range(SP_RANKS)]
    for r in ranks:
        want = [(r["rank"] + 1) * SP_CLI_LAYERS] * 2
        if r["exit"] != 0 or r["launches_per_step"] != [want] * SP_CLI_STEPS \
                or r["losses"] != ranks[0]["losses"]:
            raise AssertionError(f"leg (d) rank {r['rank']}: {r}, want launches {want}")
    _falls("leg (d)", ranks[0]["losses"])
    if "train_loss" not in metrics.read_text():
        raise AssertionError("CLI metrics without train_loss")
    return dict(wall_s=wall, topology=topology[0], losses=ranks[0]["losses"],
                launches_per_step=[r["launches_per_step"][0] for r in ranks])


def sp_phase(smi, work, cli_collected):
    """Phase 16: (a) the chunk wrapper at full width and the chunk kernels'
    rows, then legs (b)-(d) in the directory ``work``.  Returns the report,
    the kernels' rows and the launches of the main paths of (b) (by chunk
    shape, past and diagonal, every rank's summed) and (c) (rank 0's)."""
    start = time.perf_counter()
    legs_s = {}

    def lap(name):
        legs_s[name] = time.perf_counter() - start - sum(legs_s.values())

    ranks = _spawn_ranks("sp_rank", work, SP_RANKS)
    chunk = sp_chunk_leg(SEED)
    for name, row in chunk.items():
        log(f"[sp chunk {name}] [1, {SP_SEQ}] x 12 heads of 64 (views of a fused qkv) as "
            f"{SP_RANKS} chunks of {SP_LOCAL} by the ring's rules"
            + (f", window {SP_WINDOW}" if name == "window" else "")
            + (", packed (3 segments per row)" if name == "packed" else "")
            + f": (flash_fwd, flash_bwd) launches {row['launches']}; against one flash call: "
            f"out max abs err {row['full_out_max_abs_err']:.3e} (worst row "
            f"{row['full_out_worst_row_ratio']:.3f} of its limit), lse "
            f"{row['full_lse_max_abs_err']:.3e}; against the plain versions through the same "
            f"merge: out {row['plain_out_max_abs_err']:.3e} (worst row "
            f"{row['plain_out_worst_row_ratio']:.3f}; plain out rms {row['plain_out_rms']:.3e}), "
            f"lse {row['plain_lse_max_abs_err']:.3e} (atol {OUT_TOL} / {LSE_TOL}; rows "
            f"{OUT_ROW_RTOL} * ||row|| + {OUT_ROW_ATOL} * rms row norm); gradients "
            "through the merge, worst row over its limit "
            + ", ".join(f"{g} {r:.3f}" for g, r in row["worst_row_ratio"].items())
            + f" (max |dlse| of a pair {row['plain_dlse_max_abs']:.3e})")
    lap("chunk_wrapper")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 91)
    rows = {}
    for name, shape, split in (("ring_diag", SP_DIAG_SHAPE, 1), ("ring_past", SP_PAST_SHAPE, 1),
                               ("ring_band", SP_BAND_SHAPE, 1),
                               ("ulysses", SP_ULYSSES_SHAPE, SP_PLAIN_SPLIT)):
        rows[f"{name}_fwd"] = fwd_kernel_row(f"t_sp_{name}", shape, gen, plain_split=split,
                                             plant=True)
        rows[f"{name}_bwd"] = bwd_kernel_row(f"t_sp_{name}", shape, gen, main_path=True,
                                             plain_split=split)
        gc.collect()
        torch.cuda.empty_cache()
    lap("kernels")
    cli = sp_cli_check(cli_collected)
    log(f"[sp cli] torchrun --standalone --nproc_per_node={SP_RANKS} over -m "
        f"tpu_parallel_torch.train's main --config=gpt2_125m_long --config.mesh.data=1 "
        f"--config.mesh.seq={SP_RANKS} --config.model_overrides.attn_impl=ring "
        f"--config.model_overrides.seq_len={SP_SEQ} --config.model_overrides.n_layers="
        f"{SP_CLI_LAYERS} --config.global_batch_size=1 --config.num_minibatches=1 "
        f"--config.steps={SP_CLI_STEPS} --device=cuda:0 --backend=gloo (started and collected "
        f"in phase 12): exit 0 on every rank, collected {cli['wall_s']:.1f} s after its launch; "
        f"topology {cli['topology']}; launches per step (flash_fwd, flash_bwd) by rank "
        f"{cli['launches_per_step']}; losses {[round(x, 5) for x in cli['losses']]}")
    ref = _reference(sp_reference_leg, work)
    lap("reference")
    ranks = _join_ranks(ranks, SP_LEG_TIMEOUT)
    lap("ranks")
    layers, m = ranks[0]["ring"]["n_layers"], SP_MINIBATCHES
    # per layer and minibatch: the ring forward's 3 hops of K and V, the
    # backward's 3 of K, V and their gradients and 1 of the gradients home
    # (the proj_attn recompute keeps the ring's output); Ulysses' 4
    # all-to-alls in the forward and 4 in the backward (kept, likewise)
    want_comm = dict(ring=[7 * layers * m, 7 * layers * m, 0, 1],
                     ulysses=[0, 0, 8 * layers * m, 1])
    for p in ranks:
        c = p["seq_coord"]
        for impl, want_launch in (("ring", (c + 1) * layers * m), ("ulysses", layers * m)):
            run = p[impl]
            if run["launches_per_step"] != [[want_launch] * 2] * SP_STEPS \
                    or run["comm_per_step"] != [want_comm[impl]] * SP_STEPS:
                raise AssertionError(f"({impl}) rank {p['rank']}: launches per step "
                                     f"{run['launches_per_step']}, (sends, receives, "
                                     f"all-to-alls, all-reduces) {run['comm_per_step']}, want "
                                     f"{want_launch} and {want_comm[impl]}")
    for impl in ("ring", "ulysses"):
        if any(p[impl]["digests"] != ranks[0][impl]["digests"] for p in ranks):
            raise AssertionError(f"({impl}): the replicated masters differ across the ranks")
        if any(p[impl]["losses"] != ranks[0][impl]["losses"] for p in ranks):
            raise AssertionError(f"({impl}): the ranks' synced losses differ")
    gib = lambda x: f"{x / 2**30:.3f} GiB"  # noqa: E731
    r0 = ranks[0]
    ex = [p["exchange"] for p in ranks]
    log(f"[sp ranks] {SP_RANKS} gloo processes on cuda:0 ({r0['process_info']}), mesh data=1 x "
        f"seq={SP_RANKS}, gpt2_125m_long at seq_len {SP_SEQ}: {SP_ROWS} rows in {m} "
        f"minibatches, each rank [1, {SP_LOCAL}] per minibatch; free at the start "
        f"{gib(r0['free_bytes_at_start'])}; one process: losses "
        f"{[round(x, 5) for x in ref['losses']]}, step host ms "
        f"{[round(x, 1) for x in ref['step_host_ms']]}, state {gib(sum(ref['state_bytes'].values()))}, "
        f"max memory allocated {gib(ref['max_memory_allocated'])}, init {ref['init_s']:.1f} s")
    for impl in ("ring", "ulysses"):
        runs = [p[impl] for p in ranks]
        medians = [f"{r['step1_grad_rel_median']:.3e}" for r in runs]
        worsts = [(r["step1_grad_rel_max"][0], f"{r['step1_grad_rel_max'][1]:.3e}") for r in runs]
        diffs = [f"{x:.2e}" for x in runs[0]["loss_diffs"]]
        log(f"[sp {impl}] launches per step (flash_fwd, flash_bwd) by rank "
            f"{[r['launches_per_step'][0] for r in runs]}; (ring sends, receives, all-to-alls, "
            f"gradient all-reduces) per step {runs[0]['comm_per_step'][0]}; replicated masters "
            f"bitwise equal across the ranks after every step; losses "
            f"{[round(x, 5) for x in runs[0]['losses']]} against one process's (|diff| "
            f"{diffs}, tol {LOSS_TOL}); step-1 synced gradients relative L2 per weight, by "
            f"rank, median {medians} max {worsts} (tol {TRAIN_GRAD_TOL})")
        log(f"  step host ms by rank {[[round(x, 1) for x in r['step_host_ms']] for r in runs]} "
            f"(the first a warm-up) against one process's "
            f"{[round(x, 1) for x in ref['step_host_ms']]}; state "
            f"{[gib(r['state_bytes']) for r in runs]}, max memory allocated in a step "
            f"{[gib(r['max_memory_allocated']) for r in runs]}; legs' seconds "
            f"{[{k: round(v, 1) for k, v in r['legs_s'].items()} for r in runs]}")
    log(f"[sp ring op] ring_flash_attention on each rank's [1, {SP_LOCAL}] block of a seeded "
        f"[1, {SP_SEQ}] x 12 heads sequence, forward and backward, against one flash_attention "
        f"call over the whole sequence: worst row over its limit by rank "
        f"{[{k: round(v, 3) for k, v in p['ring_op']['worst_row_ratio'].items()} for p in ranks]} "
        f"(out {OUT_ROW_RTOL} * ||row|| + {OUT_ROW_ATOL} * rms row norm, gradients {GRAD_RTOL} / "
        f"{GRAD_ATOL}; out rms {[round(p['ring_op']['out_rms'], 4) for p in ranks]}); "
        f"(flash_fwd, flash_bwd) launches {[p['ring_op']['launches'] for p in ranks]}, (sends, "
        f"receives) {[p['ring_op']['sends_receives'] for p in ranks]}")
    log(f"[sp exchanges] one ring hop (a {ex[0]['hop_bytes']}-byte K/V buffer through the host) "
        f"{[round(e['hop_host_ms'], 2) for e in ex]} host ms by rank; one all-to-all of "
        f"{ex[0]['alltoall_bytes']} bytes per rank {[round(e['alltoall_host_ms'], 2) for e in ex]} "
        f"host ms by rank")
    phase_s = time.perf_counter() - start
    log(f"[sp] phase 16 took {phase_s:.1f} s ("
        + ", ".join(f"{k} {v_:.1f}" for k, v_ in legs_s.items()) + ")")
    log(f"card: {smi}")
    # the ring's launches by chunk shape, summed over the ranks: rank r
    # runs per layer its diagonal chunk and r past ones (its per-step counts
    # are held to (r + 1) x layers above), so a (r + 1)-th of its launches
    # are diagonal and the rest past
    diag = {name: sum(p["ring"]["launches"][name] // (p["seq_coord"] + 1) for p in ranks)
            for name in LAUNCH_COUNTERS}
    past = {name: sum(p["ring"]["launches"][name] for p in ranks) - diag[name]
            for name in LAUNCH_COUNTERS}
    return (dict(chunk=chunk, cli=cli, reference=ref, ranks=ranks, phase_s=phase_s,
                 legs_s=legs_s), rows, dict(past=past, diagonal=diag), r0["ulysses"]["launches"])


# phase 17: mixture of experts with expert parallelism: ``gpt2_moe_ep``
# (GPT-2 125M, 8 experts per layer, top-1, capacity 1.25, flash) at full
# width and depth, bf16, "proj_attn", MOE_ROWS rows per step (the config has
# 64: see PERF.md).  (a) one device, the serving path; (b) one process
# training with every expert, the reference, in this process; (c) four gloo
# ranks sharing the card on a data=1 x model=4 mesh, dense dispatch; (d) the
# same ranks with the all-to-all dispatch.
MOE_RANKS = 4
MOE_ROWS = 8  # global batch (the config has 64): every rank of the model axis runs all rows
MOE_STEPS = 4  # step 1's learning rate is 0 (warm-up): the losses cover 2 updates
MOE_SHAPE = (MOE_ROWS, 3, 3, 1024, 64, dict(causal=True), False, 20)  # one rank's flash shape
MOE_PROMPT_LENS = (32, 20, 27, 12)  # (a)'s ragged prompts, left-padded to 32
MOE_NEW = 16  # new tokens per prompt in (a)
MOE_DISPATCH_SHAPE = (2, 128)  # (a)'s token set for the index dispatch against the masks
MOE_DISPATCH_TOL = 1e-5
MOE_LEG_TIMEOUT = 600
# (c)'s synced step-1 gradients in fp32 (TF32 off, xla attention) at full
# width and depth on MOE_FP32_ROWS rows, routed alike, where the split changes
# only fp32 rounding: per weight within MOE_FP32_GRAD_TOL of one process's
# (phase 14's limit)
MOE_FP32_ROWS = 2
MOE_FP32_GRAD_TOL = TP_FP32_GRAD_TOL
# (b)-(d)'s bf16 steps at 4 of the 12 layers (the run's time limit); (a) and
# the fp32 pass keep the full depth
MOE_STEP_LAYERS = 4


def _moe_config(**changes):
    over = dict(remat_policy="proj_attn", **changes.pop("model_overrides", {}))
    changes = dict(dict(seed=SEED, global_batch_size=MOE_ROWS, warmup_steps=SHELL_WARMUP),
                   **changes)
    config, _ = _shell_config("gpt2_moe_ep", model_overrides=over, **changes)
    return config


def _moe_model_config(**changes):
    """``gpt2_moe_ep``'s model config (with (b)-(d)'s overrides)."""
    from tpu_parallel_torch.train_lib import MODEL_REGISTRY

    config = _moe_config()
    kw = {k: v for k, v in config.model_overrides.items() if v is not None}
    return MODEL_REGISTRY[config.model](**{**kw, **changes})


def _moe_batches(vocab, device):
    """One seeded global batch of [MOE_ROWS, 1024] for each of the MOE_STEPS
    steps (the same rows: on random tokens a falling loss needs them)."""
    from tpu_parallel_torch.data import lm_batch

    return [lm_batch(torch.Generator().manual_seed(SEED + 110), MOE_ROWS, SHELL_SEQ, vocab,
                     device=device)] * MOE_STEPS


def _moe_draws():
    """The seeded fp32 draws of ``gpt2_moe_ep``'s model by name at full
    shape, from the one-device model built on the meta device (the names
    and draws of every layout).  (b)-(d) and the fp32 pass take one set per
    process (the draws are most of a Trainer's init), the ranks' made
    before they are let run, beside (a) and (b)."""
    from tpu_parallel_torch.models import GPTLM
    from tpu_parallel_torch.models.convert import init_params

    return init_params(GPTLM(_moe_model_config(), device="meta"), _moe_config().seed)


def _moe_fp32_grads(mesh, device, draws, routes=None):
    """The synced step-1 gradients of ``gpt2_moe_ep``'s model in fp32 (xla
    attention) from ``draws`` on MOE_FP32_ROWS seeded rows, assembled on
    the host (a collective under a mesh), the config, and the expert
    choices the pass made: pinned to ``routes`` where given
    (:class:`_PinnedRoutes`)."""
    from tpu_parallel_torch.data import lm_batch
    from tpu_parallel_torch.train_lib import Trainer

    model = 1 if mesh is None else MOE_RANKS
    config = _moe_config(global_batch_size=MOE_FP32_ROWS,
                         mesh=dict(data=1, model=model, pipe=1, seq=1),
                         model_overrides=dict(dtype=torch.float32, attn_impl="xla"))
    trainer = Trainer(config, mesh, device=device)
    state = trainer.init(draws)
    batch = lm_batch(torch.Generator().manual_seed(SEED + 115), MOE_FP32_ROWS, SHELL_SEQ,
                     trainer.model_config.vocab_size, device=device)
    pins = _PinnedRoutes(trainer.model, routes)
    try:
        grads = _tp_assembled(state, _tp_grads(trainer, state, batch, mesh))
    finally:
        pins.close()
    cfg = trainer.model_config
    del trainer, state, batch
    gc.collect()
    torch.cuda.empty_cache()
    return grads, cfg, pins


def _moe_counts():
    """(model-axis all-reduces, all-to-alls, all-gathers, reduce-scatters,
    gradient all-reduces) launched so far."""
    from tpu_parallel_torch.models import moe
    from tpu_parallel_torch.parallel import dp, tp

    return [tp.tp_allreduce_launches, moe.ep_alltoall_launches, tp.tp_allgather_launches,
            tp.tp_reducescatter_launches, dp.dp_allreduce_launches]


def _moe_want_counts(layers, dispatch):
    """The collectives per step of one minibatch under "proj_attn",
    derived from the schedule: forward, one all-reduce per layer after
    attention's row projection (kept by the policy) and the dense
    dispatch's combine (past the recompute's early stop), the
    vocab-parallel loss's 5; backward, each of those all-reduces' own and
    the loss's 2.  The all-to-all dispatch replaces the combine's with a
    packed balance all-reduce, which the recompute replays, and moves
    tokens with two all-to-alls per layer forward, two in the recompute
    and two in the backward, one all-gather per layer and its
    reduce-scatter; one gradient all-reduce either way."""
    if dispatch == "dense":
        return [4 * layers + 7, 0, 0, 0, 1]
    return [5 * layers + 7, 6 * layers, layers, layers, 1]


def _moe_rel(cfg, got, want):
    """Relative L2 per weight of local tensors (a rank's slices), the key
    slice of each local qkv bias left out (rounding noise under AdamW)."""
    dh = cfg.head_dim
    rel = {}
    for name, g in got.items():
        w = want[name]
        if name.endswith("attn.qkv.bias"):
            keep = (torch.arange(g.numel()) % (3 * dh)) // dh != 1
            g, w = g[keep], w[keep]
        rel[name] = ((g - w).norm() / w.norm().clamp(min=1e-30)).item()
    return rel


def _moe_inputs(model):
    """Forward pre-hooks that record each MoE layer's input (the normed
    hidden state): ``(handles, recorded list)``."""
    recorded = []
    handles = [block.moe.register_forward_pre_hook(
        lambda module, args: recorded.append((module, args[0].detach())))
        for block in model.blocks.children()]
    return handles, recorded


def _moe_dropped(config, x, router_weight, ep=1):
    """The share of (token, choice) assignments that capacity drops in one
    top-k MoE layer on its input ``x`` [B, S, d]; ``ep`` > 1 with the
    all-to-all dispatch counts each sender's quota on its own block of
    tokens."""
    from tpu_parallel_torch.models import moe

    xf = x.reshape(-1, x.shape[-1]).float()
    blocks = xf.chunk(ep) if config.moe_dispatch == "alltoall" and ep > 1 else (xf,)
    dropped = total = 0
    for block in blocks:
        probs = torch.softmax(block @ router_weight.float().t(), dim=-1)
        experts = moe.topk_choices(probs, config.moe_top_k)[1]
        cap = moe.capacity_for(config.moe_capacity_factor, config.moe_top_k, block.shape[0],
                               config.moe_experts)
        kept = moe.dispatch_slots(experts, config.moe_experts, cap)[1]
        dropped += int((~kept).sum())
        total += kept.numel()
    return dropped / total


class _PinnedRoutes:
    """Pins the top-k expert choices of every MoE layer of ``model``, so two
    runs that differ in rounding route alike and can be held token by token
    (bf16 noise flips near-tied choices at random init, and a flipped token
    takes another expert's output and, under capacity, the slots of later
    ones).  A forward pre-hook on each ``MoEMLP`` names its layer, and
    ``moe.topk_choices`` is replaced until :meth:`close` by one that returns
    the choices recorded for (``step``, layer), recording the call's own on
    the first visit; the gates are recomputed from the call's own router
    probabilities, so gradients reach the router as under the module's own
    routing.  A recompute under remat replays the forward's choices.
    ``alike`` holds, per (step, layer), which tokens' own choices equal the
    pinned ones (no host sync; all of them where the call recorded)."""

    def __init__(self, model, routes=None):
        from tpu_parallel_torch.models import moe

        self.moe, self.own = moe, moe.topk_choices
        self.routes = {} if routes is None else dict(routes)
        self.alike, self.step, self.layer = {}, 0, None
        self.handles = [block.moe.register_forward_pre_hook(self._naming(i))
                        for i, block in enumerate(model.blocks.children())]
        moe.topk_choices = self._choices

    def _naming(self, i):
        def hook(module, args):
            self.layer = i
        return hook

    def _choices(self, probs, top_k):
        # every visit runs the same ops: a selective-checkpoint recompute
        # must replay the forward's
        own = self.own(probs, top_k)[1]
        key = f"{self.step}/{self.layer}"
        pinned = self.routes.setdefault(key, own.detach()).to(probs.device, torch.long)
        self.alike.setdefault(key, (own == pinned).all(-1))
        vals = probs.gather(1, pinned)
        return (vals if top_k == 1 else vals / vals.sum(-1, keepdim=True)), pinned

    def close(self):
        self.moe.topk_choices = self.own
        for h in self.handles:
            h.remove()

    def host_routes(self):
        return {k: v.to("cpu", torch.uint8) for k, v in self.routes.items()}

    def alike_share(self):
        """The share of (step, layer, token) choices that the run's own
        routing makes alike the pinned ones."""
        return torch.cat(list(self.alike.values())).float().mean().item()

    def alike_every_layer(self):
        """[tokens]: routed alike in every layer (one step's pins)."""
        return torch.stack(list(self.alike.values())).all(0)


def moe_serve_leg(seed):
    """(a): the model on one device.  A forward on [MOE_ROWS, 1024] through
    the kernel against the same modules under ``attn_impl="xla"`` (one
    launch per layer) on the flash pass's expert choices
    (:class:`_PinnedRoutes`), at the config's capacity and at ample
    capacity (capacity factor = experts: nothing dropped): the loss within
    LOSS_TOL and the logits within LOGITS_TOL token by token, as phases
    3-4 hold them; the share of tokens that the xla pass's own routing
    sends alike in every layer is printed; greedy ``generate()`` on ragged
    prompts, whose decode steps route 4 tokens into 1 slot per expert
    (capacity binds), twice, bitwise equal; the index dispatch against
    ``_dispatch_masks`` and the einsums on layer 0's real input, a
    [2, 128] token set in fp32, at capacity factors 1.25 and 0.5: the same
    kept slots exactly, outputs within MOE_DISPATCH_TOL; the serving
    engine on the same prompts, fused T=4 ticks run eagerly and replayed
    as one CUDA graph: greedy tokens bitwise equal (the dispatch syncs
    nothing with the host, so it captures)."""
    from tpu_parallel_torch.core.losses import token_cross_entropy
    from tpu_parallel_torch.models import GPTLM, moe
    from tpu_parallel_torch.models.generate import generate
    from tpu_parallel_torch.ops import flash_attention as fa

    cfg = _moe_model_config()
    t0 = time.perf_counter()
    model = GPTLM(cfg, device="cuda", seed=seed).eval()
    out = dict(build_s=time.perf_counter() - t0,
               params=sum(p.numel() for p in model.parameters()))
    gen = torch.Generator().manual_seed(seed + 110)
    tokens = torch.randint(0, cfg.vocab_size, (MOE_ROWS, SHELL_SEQ), generator=gen).cuda()
    targets = tokens.roll(-1, dims=1)
    xla = dataclasses.replace(cfg, attn_impl="xla")
    with torch.inference_mode():
        handles, recorded = _moe_inputs(model)
        balances = []
        pins = _PinnedRoutes(model)  # records the flash pass's choices
        _reset_launches()
        logits = model(tokens, moe_losses=balances)
        torch.cuda.synchronize()
        pins.close()
        for h in handles:
            h.remove()
        launched = fa.flash_fwd_launches
        if launched != cfg.n_layers or not torch.isfinite(logits).all():
            raise AssertionError(f"(a): {launched} launches, finite {torch.isfinite(logits).all()}")
        out.update(launches=launched, balance_per_layer=[round(float(b), 5) for b in balances],
                   dense_dropped=sum(_moe_dropped(cfg, x, m.router.weight)
                                     for m, x in recorded) / len(recorded))
        del recorded
        ample = dataclasses.replace(cfg, moe_capacity_factor=float(cfg.moe_experts))
        for name, moe_cfg in (("config", cfg), ("ample", ample)):
            for block in model.blocks.children():
                block.moe.config = moe_cfg
            got = logits
            if name == "ample":
                pins = _PinnedRoutes(model)
                got = model(tokens)
                pins.close()
            for block in model.blocks.children():  # the same weights under the xla path
                block.attn.config = xla
            replay = _PinnedRoutes(model, pins.routes)  # ... on the flash pass's choices
            want = model(tokens)
            replay.close()
            for block in model.blocks.children():
                block.attn.config, block.moe.config = cfg, cfg
            got, want = (t.float().reshape(-1, t.shape[-1]) for t in (got, want))
            err = (got - want).abs().amax(-1)
            out[name] = dict(loss=token_cross_entropy(got, targets.reshape(-1)).mean().item(),
                             xla_loss=token_cross_entropy(want, targets.reshape(-1)).mean().item(),
                             logits_max_abs_err=err.max().item(),
                             logits_rel_l2=((got - want).norm() / want.norm()).item(),
                             own_routed_alike=replay.alike_every_layer().float().mean().item())
            del got, want
        if any(abs(v["loss"] - v["xla_loss"]) > LOSS_TOL or v["logits_max_abs_err"] > LOGITS_TOL
               for v in (out["config"], out["ample"])):
            raise AssertionError(f"(a): the flash forward disagrees with the xla forward: {out}")
        out["forward_ms"] = host_ms(lambda: model(tokens), 5)
        # greedy generation on ragged prompts: decode capacity binds
        width = max(MOE_PROMPT_LENS)
        prompt = torch.randint(1, cfg.vocab_size, (len(MOE_PROMPT_LENS), width),
                               generator=gen).cuda()
        mask = torch.zeros_like(prompt, dtype=torch.bool)
        for r, n in enumerate(MOE_PROMPT_LENS):
            mask[r, width - n:] = True
        handles, recorded = _moe_inputs(model)
        greedy = generate(model, prompt, max_new_tokens=MOE_NEW, prompt_mask=mask)
        for h in handles:
            h.remove()
        decode = [(m, x) for m, x in recorded if x.shape[1] == 1]
        again = generate(model, prompt, max_new_tokens=MOE_NEW, prompt_mask=mask)
        if greedy.shape != (len(MOE_PROMPT_LENS), MOE_NEW) or not torch.equal(greedy, again) \
                or greedy.min() < 0 or greedy.max() >= cfg.vocab_size:
            raise AssertionError(f"(a): greedy tokens {tuple(greedy.shape)} out of range or "
                                 "not reproducible")
        out.update(decode_capacity=moe.capacity_for(cfg.moe_capacity_factor, cfg.moe_top_k,
                                                    len(MOE_PROMPT_LENS), cfg.moe_experts),
                   decode_dropped=sum(_moe_dropped(cfg, x, m.router.weight)
                                      for m, x in decode) / len(decode),
                   greedy_first_row=greedy[0].tolist())
        out["generate_ms"] = host_ms(lambda: generate(model, prompt, max_new_tokens=MOE_NEW,
                                                      prompt_mask=mask), 1)
        # the index dispatch against the masks, on layer 0's real input
        b, s = MOE_DISPATCH_SHAPE
        layer0 = model.blocks.layer_0.moe
        handles, recorded = _moe_inputs(model)
        model(tokens[:b, :s])
        for h in handles:
            h.remove()
        x = recorded[0][1].float()
        xf = x.reshape(b * s, -1)
        checks = {}
        for cf in (1.25, 0.5):
            c32 = dataclasses.replace(cfg, dtype=torch.float32, moe_capacity_factor=cf)
            layer = moe.MoEMLP(c32, device="cuda")
            layer.load_state_dict({k: v.float() for k, v in layer0.state_dict().items()})
            got, _ = layer(x)
            probs = torch.softmax(xf @ layer.router.weight.t(), dim=-1)
            gates, onehots = moe._topk_gates(probs, cfg.moe_top_k)
            capacity = moe.capacity_for(cf, cfg.moe_top_k, b * s, cfg.moe_experts)
            dispatch, combine = moe._dispatch_masks(onehots, gates, cfg.moe_experts, capacity)
            x_exp = torch.einsum("td,tec->ecd", xf, dispatch)
            plain = torch.einsum("ecd,tec->td", layer.experts(x_exp), combine)
            slots, kept = moe.dispatch_slots(moe.topk_choices(probs, cfg.moe_top_k)[1],
                                             cfg.moe_experts, capacity)
            mask_of_slots = torch.zeros(b * s, cfg.moe_experts * capacity + 1, device="cuda")
            mask_of_slots.scatter_(1, slots, 1.0)
            same = torch.equal(mask_of_slots[:, :-1].view_as(dispatch), dispatch)
            err_y = (got.reshape(b * s, -1) - plain).abs().max().item()
            checks[cf] = dict(capacity=capacity, kept=int(kept.sum()), slots_equal=same,
                              max_abs_err=err_y)
            if not same or err_y > MOE_DISPATCH_TOL:
                raise AssertionError(f"(a): the index dispatch against the masks at capacity "
                                     f"factor {cf}: {checks[cf]}")
        out["dispatch"] = checks
    # the engine: fused T=4 ticks run eagerly and replayed as a CUDA graph
    # (the dispatch syncs nothing with the host), greedy tokens bitwise equal
    from tpu_parallel_torch.serving import Request, SchedulerConfig, ServingEngine

    runs = []
    for eager in (True, False):
        eng = ServingEngine(model, n_slots=len(MOE_PROMPT_LENS), decode_steps_per_tick=4,
                            scheduler=SchedulerConfig(max_prefills_per_tick=len(MOE_PROMPT_LENS)))
        if eager:
            eng._run_fused_eagerly()
        reqs = [eng.add_request(Request(prompt=prompt[r, width - n:].tolist(),
                                        max_new_tokens=MOE_NEW + 1))
                for r, n in enumerate(MOE_PROMPT_LENS)]
        eng.run()
        runs.append(([r.tokens for r in reqs], eng.graph_captures))
        del eng
    out["engine"] = dict(captures=[n for _, n in runs], equal=runs[0][0] == runs[1][0],
                         first_row=runs[1][0][0])
    if runs[0][0] != runs[1][0] or runs[0][1] != 0 or runs[1][1] < 1 \
            or any(len(t) != MOE_NEW + 1 for t in runs[1][0]):
        raise AssertionError(f"(a): the engine's captured ticks against eager ones: {runs}")
    del model, logits
    gc.collect()
    torch.cuda.empty_cache()
    return out


def moe_reference_leg(workdir):
    """(b): one process, no group, every expert on the card: MOE_STEPS
    steps of the dense dispatch on the seeded batch, the step-1 synced
    gradients kept and every step's expert choices recorded
    (:class:`_PinnedRoutes`); the dropped share of one forward's choices
    under the dense dispatch and under the all-to-all's per-sender quota
    (the same hidden states cut in MOE_RANKS blocks); the fp32 gradients of
    :func:`_moe_fp32_grads` and their choices.  Saves the gradients, the
    losses and the choices for (c), which replays the choices: a token
    whose top-1 expert flips on the two layouts' bf16 rounding (their
    attention sums its heads' partials in another order) would take its
    gradient to another expert and, under the config's capacity, move the
    slots of later tokens.  Returns the losses, step times, state bytes
    and peak memory."""
    from tpu_parallel_torch.core.metrics import compute
    from tpu_parallel_torch.train_lib import Trainer

    t0 = time.perf_counter()
    trainer = Trainer(_moe_config(mesh=dict(data=1, model=1, pipe=1, seq=1),
                                  model_overrides=dict(n_layers=MOE_STEP_LAYERS)), device="cuda")
    if trainer.mesh is not None:
        raise AssertionError("the one-process reference runs on a mesh")
    draws = _moe_draws()
    state = trainer.init(draws)
    init_s = time.perf_counter() - t0
    cfg = trainer.model_config
    batches = _moe_batches(cfg.vocab_size, "cuda")
    with torch.no_grad():
        handles, recorded = _moe_inputs(trainer.model)
        trainer.model(batches[0].tokens, hidden_only=True)
        for h in handles:
            h.remove()
        dropped = {kind: sum(_moe_dropped(
            dataclasses.replace(cfg, moe_dispatch=kind), x, m.router.weight, MOE_RANKS)
            for m, x in recorded) / len(recorded) for kind in ("dense", "alltoall")}
        del recorded
    grads = _first_synced_grads(state)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    pins = _PinnedRoutes(trainer.model)
    losses, step_ms, bals = [], [], []
    for i, batch in enumerate(batches):
        pins.step = i
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = trainer.step_fn(state, None, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        m = compute(metrics)
        losses.append(m["loss"])
        bals.append(m["moe_balance"])
    pins.close()
    peak = torch.cuda.max_memory_allocated()
    launches = dict(zip(LAUNCH_COUNTERS, _launch_counts()))
    state_bytes = _state_bytes(state)
    del trainer, state
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    fp32_grads, _, fp32_pins = _moe_fp32_grads(None, "cuda", draws)
    del draws
    fp32_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    torch.save(dict(grads=grads, losses=losses, routes=pins.host_routes(),
                    fp32_grads=fp32_grads, fp32_routes=fp32_pins.host_routes()),
               Path(workdir, "moe_ref.pt"))
    save_s = time.perf_counter() - t0
    return dict(losses=losses, balances=bals, step_host_ms=step_ms, max_memory_allocated=peak,
                state_bytes=state_bytes, init_s=init_s, launches=launches, dropped=dropped,
                fp32_s=fp32_s, grads_save_s=save_s)


def _moe_run(dispatch, mesh, ref, rank, draws):
    """(c) or (d) in a rank: ``gpt2_moe_ep`` with ``moe_dispatch=dispatch``
    over the data=1 x model=MOE_RANKS mesh: MOE_STEPS counted steps (the
    main path: the launch counters set to 0 first) with each step's
    launches and collectives, the replicated masters' digest after each,
    its wall ms; state bytes and peak memory.  Under the dense dispatch
    each step runs on the reference's expert choices (``ref["routes"]``,
    :class:`_PinnedRoutes`), and the losses are held within LOSS_TOL of the
    reference's and the step-1 synced gradients (as the optimizer receives
    them; a rank's slices of the model-split ones, the expert stacks among
    them) within TRAIN_GRAD_TOL per weight of the reference's; the share
    of choices that the rank's own routing makes alike is kept."""
    from tpu_parallel_torch.core.metrics import compute
    from tpu_parallel_torch.train_lib import Trainer

    start_s, legs_s = time.perf_counter(), {}

    def lap(name):
        legs_s[name] = time.perf_counter() - start_s - sum(legs_s.values())

    trainer = Trainer(_moe_config(mesh=dict(data=1, model=MOE_RANKS, pipe=1, seq=1),
                                  model_overrides=dict(moe_dispatch=dispatch,
                                                       n_layers=MOE_STEP_LAYERS)), mesh,
                      device="cuda:0")
    state = trainer.init(draws)
    cfg = trainer.model_config
    experts = [n for n in state.shards if ".moe.experts." in n]
    if len(experts) != 4 * cfg.n_layers or any(state.shards[n].dim != 0 for n in experts):
        raise AssertionError(f"({dispatch}) rank {rank}: expert leaves {len(experts)} not all "
                             "split at dim 0 over the model axis")
    batches = _moe_batches(cfg.vocab_size, "cuda:0")
    lap("init")
    synced = _first_synced_grads(state)
    pins = _PinnedRoutes(trainer.model, ref["routes"]) if dispatch == "dense" else None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()  # the main path starts here
    losses, bals, per_step, comm, step_ms, digests = [], [], [], [], [], []
    for i, batch in enumerate(batches):
        if pins is not None:
            pins.step = i
        before, cbefore = _launch_counts(), _moe_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = trainer.step_fn(state, None, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        per_step.append([a - b for a, b in zip(_launch_counts(), before)])
        comm.append([a - b for a, b in zip(_moe_counts(), cbefore)])
        m = compute(metrics)
        losses.append(m["loss"])
        bals.append(m["moe_balance"])
        digests.append(_replicated_digest(state))
        lap(f"step{i + 1}")
    launches = dict(zip(LAUNCH_COUNTERS, _launch_counts()))
    result = dict(losses=losses, balances=bals, launches_per_step=per_step, comm_per_step=comm,
                  launches=launches, step_host_ms=step_ms, digests=digests,
                  max_memory_allocated=torch.cuda.max_memory_allocated(),
                  state_bytes=_state_bytes(state), n_layers=cfg.n_layers)
    if not all(map(lambda x: x == x and abs(x) < float("inf"), losses)):
        raise AssertionError(f"({dispatch}) rank {rank}: losses {losses}")
    if pins is not None:
        pins.close()
        result["own_routed_alike"] = pins.alike_share()
        want = {n: (state.shards[n].local(g) if n in state.shards else g)
                for n, g in ((n, ref["grads"][n]) for n in synced)}
        rel = _moe_rel(cfg, synced, want)
        worst = max(rel.items(), key=lambda kv: kv[1])
        experts_worst = max((kv for kv in rel.items() if ".moe.experts." in kv[0]),
                            key=lambda kv: kv[1])
        result.update(loss_diffs=[abs(a - b) for a, b in zip(losses, ref["losses"])],
                      step1_grad_rel_max=worst, step1_expert_grad_rel_max=experts_worst,
                      step1_grad_rel_median=sorted(rel.values())[len(rel) // 2])
        if max(result["loss_diffs"]) > LOSS_TOL or worst[1] > TRAIN_GRAD_TOL:
            raise AssertionError(f"(dense) rank {rank} disagrees with one process: "
                                 f"{ {k: v for k, v in result.items() if k != 'digests'} }")
    elif not losses[-1] < losses[0]:
        raise AssertionError(f"({dispatch}) rank {rank}: the loss does not fall: {losses}")
    result["legs_s"] = legs_s
    del trainer, state, batches
    gc.collect()
    torch.cuda.empty_cache()
    return result


def _moe_exchange_ms(mesh):
    """Host ms of one model-axis all-reduce of a [MOE_ROWS, 1024, 768]
    fp32 combine (the dense dispatch's, through gloo) and of one dispatch
    all-to-all of an [8, C / 4, 768] bf16 payload, each averaged over 5
    after one warm-up, and their bytes per rank."""
    import torch.distributed as dist

    from tpu_parallel_torch.models import moe
    from tpu_parallel_torch.parallel import tp
    from tpu_parallel_torch.runtime.comm import group_name

    cfg = _moe_model_config()
    group = group_name(mesh.get_group("model"))
    act = torch.randn(MOE_ROWS, SHELL_SEQ, cfg.d_model, device="cuda:0")
    cap = moe.capacity_for(cfg.moe_capacity_factor, cfg.moe_top_k,
                           MOE_ROWS * SHELL_SEQ // MOE_RANKS, cfg.moe_experts)
    send = torch.randn(cfg.moe_experts, cap, cfg.d_model, device="cuda:0").to(torch.bfloat16)
    out = {}
    for name, fn in (("allreduce", lambda: tp.all_reduce(act, "model", mesh)),
                     ("alltoall", lambda: moe._ep_all_to_all_op(send, group, True))):
        dist.barrier()
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        out[f"{name}_host_ms"] = (time.perf_counter() - t0) / 5 * 1e3
    out.update(allreduce_bytes=act.numel() * 4, alltoall_bytes=send.numel() * 2)
    return out


def moe_rank_leg(rank, rendezvous, workdir, draws):
    """(c) and (d), one of MOE_RANKS gloo ranks on the one card over a
    data=1 x model=MOE_RANKS mesh (2 experts and 3 heads per layer each):
    :func:`_moe_run` with the dense dispatch, then with the all-to-all in
    the same process, both from ``draws`` (:func:`_moe_draws`); the
    exchanges' host ms; the fp32 pass."""
    import torch.distributed as dist

    from tpu_parallel_torch.runtime import MeshConfig, initialize, make_mesh, process_info

    initialize(rendezvous, MOE_RANKS, rank, backend="gloo", device="cuda:0")
    _share_cores(MOE_RANKS)
    result = dict(rank=rank, process_info=process_info(),
                  free_bytes_at_start=torch.cuda.mem_get_info()[0])
    mesh = make_mesh(MeshConfig(data=1, model=MOE_RANKS))
    result["model_coord"] = mesh.get_local_rank("model")
    ref = torch.load(Path(workdir, "moe_ref.pt"), weights_only=True, mmap=True)
    result["dense"] = _moe_run("dense", mesh, ref, rank, draws)
    result["alltoall"] = _moe_run("alltoall", mesh, None, rank, draws)
    result["exchange"] = _moe_exchange_ms(mesh)
    t0 = time.perf_counter()
    fp32, cfg, pins = _moe_fp32_grads(mesh, "cuda:0", draws, ref["fp32_routes"])
    result["fp32_s"] = time.perf_counter() - t0
    del draws
    if rank == 0:
        rel = _rel_by_weight(cfg, fp32, ref["fp32_grads"])
        worst = max(rel.items(), key=lambda kv: kv[1])
        experts = max((kv for kv in rel.items() if ".moe.experts." in kv[0]),
                      key=lambda kv: kv[1])
        result["fp32"] = dict(grad_rel_max=worst, expert_grad_rel_max=experts,
                              grad_rel_median=sorted(rel.values())[len(rel) // 2],
                              own_routed_alike=pins.alike_share())
        if worst[1] > MOE_FP32_GRAD_TOL:
            raise AssertionError(f"(c) fp32: the synced gradients disagree with one "
                                 f"process's: {result['fp32']}")
    del ref, fp32
    dist.barrier()
    dist.destroy_process_group()
    return result


def moe_phase(smi, work):
    """Phase 17: the kernels at one EP rank's flash shape against their
    plain versions, then legs (a)-(d) in the directory ``work``.  Returns
    the report, the kernels' rows and the launches of (c)'s main path
    (rank 0's)."""
    start = time.perf_counter()
    legs_s = {}

    def lap(name):
        legs_s[name] = time.perf_counter() - start - sum(legs_s.values())

    ranks = _spawn_ranks("moe_rank", work, MOE_RANKS)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 111)
    rows = dict(fwd=fwd_kernel_row("t_moe_pass", MOE_SHAPE, gen),
                bwd=bwd_kernel_row("t_moe_pass", MOE_SHAPE, gen, main_path=True))
    gc.collect()
    torch.cuda.empty_cache()
    lap("kernels")
    serve = moe_serve_leg(SEED)
    lap("serve")
    d = serve["dispatch"]
    log(f"[moe serve] gpt2_moe_ep's model ({serve['params'] / 1e6:.1f}M parameters, 8 experts "
        f"per layer, top-1, capacity 1.25, flash, bf16; built in {serve['build_s']:.1f} s) on "
        f"one device: forward [{MOE_ROWS}, {SHELL_SEQ}] {serve['forward_ms']:.2f} ms, "
        f"{serve['launches']} flash_fwd launches; balance per layer "
        f"{serve['balance_per_layer']}; dropped share of the forward's choices "
        f"{serve['dense_dropped']:.4f}; against the xla path on the flash pass's expert "
        f"choices (loss tol {LOSS_TOL}, logits {LOGITS_TOL}): " + "; ".join(
            f"{name} capacity loss {v['loss']:.6f} against {v['xla_loss']:.6f}, logits max abs "
            f"err {v['logits_max_abs_err']:.4f} (relative L2 {v['logits_rel_l2']:.3e}); tokens "
            f"the xla pass's own routing sends alike in every layer {v['own_routed_alike']:.5f}"
            for name, v in (("the config's", serve["config"]), ("ample", serve["ample"]))))
    log(f"  greedy generate() on {len(MOE_PROMPT_LENS)} ragged prompts {MOE_PROMPT_LENS}, "
        f"{MOE_NEW} new tokens, twice bitwise equal, {serve['generate_ms']:.1f} ms; decode "
        f"capacity {serve['decode_capacity']} slot per expert, dropped share of decode choices "
        f"{serve['decode_dropped']:.4f}; first row {serve['greedy_first_row']}")
    log(f"  the engine, {len(MOE_PROMPT_LENS)} slots, fused T=4 ticks: eager and captured "
        f"greedy tokens bitwise equal {serve['engine']['equal']}, graph captures "
        f"{serve['engine']['captures']}; first row {serve['engine']['first_row']}")
    log(f"  index dispatch against _dispatch_masks and the einsums on layer 0's input "
        f"{list(MOE_DISPATCH_SHAPE)} in fp32: " + "; ".join(
            f"capacity factor {cf}: capacity {v['capacity']}, {v['kept']} of "
            f"{MOE_DISPATCH_SHAPE[0] * MOE_DISPATCH_SHAPE[1]} choices kept, slots equal "
            f"{v['slots_equal']}, max abs err {v['max_abs_err']:.2e} (tol {MOE_DISPATCH_TOL})"
            for cf, v in d.items()))
    ref = _reference(moe_reference_leg, work)
    lap("reference")
    ranks = _join_ranks(ranks, MOE_LEG_TIMEOUT)
    lap("ranks")
    layers = ranks[0]["dense"]["n_layers"]
    for p in ranks:
        for dispatch in ("dense", "alltoall"):
            run = p[dispatch]
            want = _moe_want_counts(layers, dispatch)
            if run["launches_per_step"] != [[layers, layers]] * MOE_STEPS \
                    or run["comm_per_step"] != [want] * MOE_STEPS:
                raise AssertionError(f"({dispatch}) rank {p['rank']}: launches per step "
                                     f"{run['launches_per_step']}, collectives "
                                     f"{run['comm_per_step']}, want {layers} and {want}")
    for dispatch in ("dense", "alltoall"):
        if any(p[dispatch]["digests"] != ranks[0][dispatch]["digests"] for p in ranks):
            raise AssertionError(f"({dispatch}): the replicated masters differ across the ranks")
        if any(p[dispatch]["losses"] != ranks[0][dispatch]["losses"] for p in ranks):
            raise AssertionError(f"({dispatch}): the ranks' synced losses differ")
    gib = lambda x: f"{x / 2**30:.3f} GiB"  # noqa: E731
    r0 = ranks[0]
    log(f"[moe reference] one process, every expert: losses "
        f"{[round(x, 5) for x in ref['losses']]}, moe_balance "
        f"{[round(x, 5) for x in ref['balances']]}, step host ms "
        f"{[round(x, 1) for x in ref['step_host_ms']]}, state "
        f"{gib(sum(ref['state_bytes'].values()))}, max memory allocated "
        f"{gib(ref['max_memory_allocated'])}, init {ref['init_s']:.1f} s, launches "
        f"{ref['launches']}; dropped share of a forward's choices: dense "
        f"{ref['dropped']['dense']:.4f}, all-to-all quota {ref['dropped']['alltoall']:.4f}")
    for dispatch in ("dense", "alltoall"):
        runs = [p[dispatch] for p in ranks]
        line = (f"[moe {dispatch}] {MOE_RANKS} gloo ranks on cuda:0, data=1 x model="
                f"{MOE_RANKS} ({r0['process_info']['backend']}): launches per step "
                f"(flash_fwd, flash_bwd) {runs[0]['launches_per_step'][0]}; (model-axis "
                f"all-reduces, all-to-alls, all-gathers, reduce-scatters, gradient all-reduces) "
                f"per step {runs[0]['comm_per_step'][0]} (derived "
                f"{_moe_want_counts(layers, dispatch)}); replicated masters bitwise equal "
                f"across the ranks after every step; losses "
                f"{[round(x, 5) for x in runs[0]['losses']]}, moe_balance "
                f"{[round(x, 5) for x in runs[0]['balances']]}")
        if dispatch == "dense":
            diffs = ["%.2e" % x for x in runs[0]["loss_diffs"]]
            medians = ["%.3e" % r["step1_grad_rel_median"] for r in runs]
            worsts = [(r["step1_grad_rel_max"][0], "%.3e" % r["step1_grad_rel_max"][1])
                      for r in runs]
            experts = ["%.3e" % r["step1_expert_grad_rel_max"][1] for r in runs]
            alike = ["%.5f" % r["own_routed_alike"] for r in runs]
            line += (f"; against one process, on its expert choices (the share of choices the "
                     f"ranks' own routing makes alike {alike}): |loss diff| {diffs} (tol "
                     f"{LOSS_TOL}), step-1 synced gradients relative L2 per weight by rank, "
                     f"median {medians}, max {worsts}, expert leaves' max {experts} (tol "
                     f"{TRAIN_GRAD_TOL})")
        log(line)
        log(f"  step host ms by rank {[[round(x, 1) for x in r['step_host_ms']] for r in runs]} "
            f"against one process's {[round(x, 1) for x in ref['step_host_ms']]}; state "
            f"{[gib(sum(r['state_bytes'].values())) for r in runs]}, max memory allocated in a "
            f"step {[gib(r['max_memory_allocated']) for r in runs]}; legs' seconds "
            f"{[{k: round(v, 1) for k, v in r['legs_s'].items()} for r in runs]}")
    ex = [p["exchange"] for p in ranks]
    fp = r0["fp32"]
    log(f"[moe fp32] (c)'s synced step-1 gradients in fp32 (xla attention, full width and "
        f"depth, {MOE_FP32_ROWS} rows; expert stacks assembled from the ranks' slices) against "
        f"one process's, on its expert choices (the share the ranks' own routing makes alike "
        f"{fp['own_routed_alike']:.5f}; the pass took {ref['fp32_s']:.1f} s in the reference, "
        f"{[round(p['fp32_s'], 1) for p in ranks]} s in the ranks): "
        f"relative L2 per weight median {fp['grad_rel_median']:.3e}, max "
        f"{fp['grad_rel_max'][0]} {fp['grad_rel_max'][1]:.3e}, expert leaves' max "
        f"{fp['expert_grad_rel_max'][1]:.3e} (tol {MOE_FP32_GRAD_TOL})")
    log(f"[moe exchanges] one model-axis all-reduce of the {ex[0]['allreduce_bytes']}-byte fp32 "
        f"combine {[round(e['allreduce_host_ms'], 2) for e in ex]} host ms by rank; one "
        f"dispatch all-to-all of {ex[0]['alltoall_bytes']} bytes per rank "
        f"{[round(e['alltoall_host_ms'], 2) for e in ex]} host ms by rank")
    phase_s = time.perf_counter() - start
    log(f"[moe] phase 17 took {phase_s:.1f} s ("
        + ", ".join(f"{k} {v_:.1f}" for k, v_ in legs_s.items()) + ")")
    log(f"card: {smi}")
    return (dict(serve=serve, reference=ref, ranks=ranks, phase_s=phase_s, legs_s=legs_s), rows,
            r0["dense"]["launches"])


# phase 18: the Llama family.  llama_1b (rope, RMSNorm, swiglu, 16 heads of
# 128, vocab 32000, seq 2048; seeded weights) at full width: (a) serving and
# (b) training on one device at full depth; (c) llama_1b_3d's FSDP x TP x
# PP over eight gloo ranks at LLAMA_3D_LAYERS layers against one process;
# (d) its CLI under torchrun (started with the CLI batch at phase 9)
LLAMA_SIZE = {}  # overrides of llama_1b's widths (none: its own)
LLAMA_SEQ = 2048  # llama_1b's seq_len
LLAMA_ROWS = 4  # (a)'s forward and (b)'s minibatches: [4, 2048]
LLAMA_MINIBATCHES = 2  # (b): 2 minibatches of [4, 2048] per step
LLAMA_STEPS = 4  # (b)
LLAMA_WARMUP = 1  # warmup_steps of (b) and (c): step 1's rate is 0
LLAMA_SHAPE = (LLAMA_ROWS, 16, 16, LLAMA_SEQ, 128, dict(causal=True), False, 10)
LLAMA_PROMPT_LENS = (64, 37, 50, 21)  # (a)'s ragged prompts, left-padded to 64
LLAMA_NEW = 16  # new tokens per prompt in (a)
LLAMA_ENGINE_LENS = (64, 37, 50, 21, 45, 30, 58, 12)  # (a)'s 8 engine requests
LLAMA_RANKS = 8
LLAMA_MESH = dict(data=2, model=2, pipe=2, seq=1)  # the smallest mesh with all three axes
LLAMA_ONE = dict(data=1, model=1, pipe=1, seq=1)
LLAMA_3D_LAYERS = 4  # (c): cut from 16
LLAMA_3D_ROWS = 8  # (c): cut from 64 (the run's time limit)
LLAMA_3D_MICRO = 4  # (c): one row each per data rank, cut from the config's 8 (the time limit)
LLAMA_3D_STEPS = 3  # (c): cut from 100 (the run's time limit); steps 2-3 update
LLAMA_3D_SHAPE = (1, 8, 8, LLAMA_SEQ, 128, dict(causal=True), False, 20)  # a rank's microbatch
LLAMA_3D_FP32_LAYERS = 2
LLAMA_3D_FP32_MICRO = 2  # (c)'s fp32 pass: 2 microbatches of one row per data rank
LLAMA_3D_FP32_TOL = TP_FP32_GRAD_TOL  # phase 14's
LLAMA_3D_NEW = 8  # (c): greedy tokens from the exported state
LLAMA_LEG_TIMEOUT = 900
# (a): the forward's logits against the xla path with fp32 attention, token
# by token (a row: one position's 32000 logits), by the row rule of
# row_error_ratio: ||err|| <= 5e-2 * ||row|| + 1e-3 * rms row norm.  It
# scales with the logits, where LOGITS_TOL does not: at 16 layers the
# kernel's logits read 0.0986 max abs against 0.1, relative L2 1.68e-2, a
# few times under this rtol; the run prints the worst token's share of the
# limit and what two planted faults (V's second half zeroed) read
LLAMA_LOGITS_ROW_TOL = (5e-2, 1e-3)
LLAMA_CLI_RANKS = 4  # (d): data 2 x model 2 x pipe 1
LLAMA_CLI_LAYERS = 2
LLAMA_CLI_STEPS = 2


def _llama_model_config(**changes):
    """``llama_1b`` (flash, ``"proj_attn"``) with ``changes``."""
    from tpu_parallel_torch.models.gpt import llama_1b

    return llama_1b(**{**dict(attn_impl="flash", remat_policy="proj_attn"), **LLAMA_SIZE,
                        **changes})


def _llama3d_config(**changes):
    """``llama_1b_3d`` at LLAMA_3D_LAYERS layers on LLAMA_3D_ROWS rows in
    LLAMA_3D_MICRO microbatches, for
    (c)'s ranks and their reference (``mesh`` in ``changes``)."""
    overrides = {**LLAMA_SIZE, "n_layers": LLAMA_3D_LAYERS, "num_microbatches": LLAMA_3D_MICRO,
                 **changes.pop("model_overrides", {})}
    changes = {**dict(seed=SEED, global_batch_size=LLAMA_3D_ROWS, warmup_steps=LLAMA_WARMUP,
                      steps=LLAMA_3D_STEPS), **changes}
    config, _ = _shell_config("llama_1b_3d", model_overrides=overrides, **changes)
    return config


def _gated_flops_per_token(cfg):
    """Training FLOPs per token with the gated MLP's three products (and
    grouped kv heads) counted: 6 per matmul parameter, plus attention's
    ``12 * L * d * T``.  ``utils/profiling.transformer_flops_per_token``
    (JAX's accounting, kept as it is) counts two MLP products and MHA."""
    hidden = cfg.mlp_ratio * cfg.d_model
    n_kv = cfg.n_kv_heads or cfg.n_heads
    attn = cfg.d_model * (cfg.n_heads + 2 * n_kv) * cfg.head_dim \
        + cfg.n_heads * cfg.head_dim * cfg.d_model
    mlp = (3 if cfg.mlp in ("swiglu", "geglu") else 2) * cfg.d_model * hidden
    matmul = cfg.vocab_size * cfg.d_model + cfg.n_layers * (attn + mlp)
    return 6 * matmul + 12 * cfg.n_layers * cfg.d_model * cfg.seq_len


def _bf16_tie(model, context, batch):
    """What the bf16 paths alone move the last position's logits of
    ``context`` by: the full forward (the flash kernel), the decode path's
    prefill at batch 1 and at ``batch`` rows; the largest pairwise
    difference, and the full forward's top-2 gap there."""
    with torch.inference_mode():
        ctx = torch.tensor([context], device="cuda")
        full = model(ctx)[0, -1].float()
        one = model(ctx, decode=True, cache=model.init_cache(1))[0, -1].float()
        wide = model(ctx.expand(batch, -1), decode=True,
                     cache=model.init_cache(batch))[0, -1].float()
    noise = max((full - one).abs().max().item(), (full - wide).abs().max().item(),
                (one - wide).abs().max().item())
    top2 = full.topk(2).values
    return noise, (top2[0] - top2[1]).item()


def _bf16_tie_held(model, prompt, got, want, what, batch):
    """bf16 greedy tokens ``got`` against the reference's ``want`` after
    ``prompt`` (lists): equal, or first differing where the top-2 gap is
    below twice what the paths alone move the logits by (phase 10's rule
    for the int8 cache, in bf16) and at least FP32_TIE_GAP.  Raises
    otherwise."""
    if got == want:
        return dict(equal=True)
    step = next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)
    noise, gap = _bf16_tie(model, prompt + want[:step], batch)
    limit = max(FP32_TIE_GAP, 2 * noise)
    if gap >= limit:
        raise AssertionError(f"{what} differs from the reference at token {step} with top-2 gap "
                             f"{gap:.3e} >= {limit:.3e} (twice the paths' noise {noise:.3e})")
    return dict(equal=False, first_diff=step, top2_gap=gap, limit=limit)


def llama_serve_leg(seed):
    """(a): ``llama_1b`` on one device at full depth.  A forward on
    [LLAMA_ROWS, 2048] through the kernel (16 launches) against the same
    weights under ``attn_impl="xla"``: the loss within LOSS_TOL, the logits
    token by token within LOGITS_TOL; greedy ``generate()`` on ragged
    prompts against the argmax of one full forward over each prompt and
    its generated tokens (teacher-forced: the rollout while they agree);
    the engine's fused T=8 ticks replayed as CUDA graphs on 8 requests
    against ``generate()`` at batch 1 (:func:`_bf16_tie_held` for both).
    Forward ms, decode ms per step and the launches."""
    from tpu_parallel_torch.core.losses import token_cross_entropy
    from tpu_parallel_torch.models import GPTLM, layers
    from tpu_parallel_torch.models.convert import init_params
    from tpu_parallel_torch.models.generate import generate
    from tpu_parallel_torch.ops import flash_attention as fa
    from tpu_parallel_torch.serving import Request, SchedulerConfig, ServingEngine

    cfg = _llama_model_config()
    t0 = time.perf_counter()
    model = GPTLM(cfg, device="cuda", seed=None).eval()
    draws = init_params(model, seed)  # (b) starts from the same draws
    torch.cuda.synchronize()
    out = dict(build_s=time.perf_counter() - t0,
               params=sum(p.numel() for p in model.parameters()))
    gen = torch.Generator().manual_seed(seed + 120)
    tokens = torch.randint(0, cfg.vocab_size, (LLAMA_ROWS, cfg.seq_len), generator=gen).cuda()
    targets = tokens.roll(-1, dims=1)
    xla = dataclasses.replace(cfg, attn_impl="xla")
    with torch.inference_mode():
        _reset_launches()  # the inference main path starts here
        logits = model(tokens)
        torch.cuda.synchronize()
        if fa.flash_fwd_launches != cfg.n_layers or not torch.isfinite(logits).all():
            raise AssertionError(f"(a): {fa.flash_fwd_launches} launches, finite "
                                 f"{torch.isfinite(logits).all()}")
        for block in model.blocks.children():  # the same weights under the xla path
            block.attn.config = xla
        want = model(tokens)
        # ... and with the xla path's attention computed in fp32 (q, k, v
        # upcast): the same function, without its bf16 roundings of the
        # scaled q and the probabilities
        plain = layers.causal_attention
        layers.causal_attention = lambda q, k, v, **kw: plain(q.float(), k.float(), v.float(),
                                                              **kw).to(q.dtype)
        try:
            want32 = model(tokens)
        finally:
            layers.causal_attention = plain
            for block in model.blocks.children():
                block.attn.config = cfg
        got = logits.float().reshape(-1, logits.shape[-1])
        flat = targets.reshape(-1)
        out["loss"] = token_cross_entropy(got, flat).mean().item()
        for name, ref in (("xla", want), ("xla_fp32_attention", want32)):
            ref = ref.float().reshape(-1, ref.shape[-1])
            err = (got - ref).abs().amax(-1)
            out[name] = dict(loss=token_cross_entropy(ref, flat).mean().item(),
                             logits_max_abs_err=err.max().item(),
                             logits_rel_l2=((got - ref).norm() / ref.norm()).item())
            del ref, err
        bf16 = want.float().reshape(-1, want.shape[-1])
        ref = want32.float().reshape(-1, want32.shape[-1])
        out["xla"]["against_fp32_attention"] = dict(
            logits_max_abs_err=(bf16 - ref).abs().max().item(),
            logits_rel_l2=((bf16 - ref).norm() / ref.norm()).item(),
            worst_row_ratio=row_error_ratio(bf16, ref, *LLAMA_LOGITS_ROW_TOL))
        out["xla_fp32_attention"]["worst_row_ratio"] = row_error_ratio(
            got, ref, *LLAMA_LOGITS_ROW_TOL)
        del bf16, want, want32, logits
        # planted faults the row rule must reject: V's second half of
        # head_dim zeroed in every layer's kernel call, and in the last
        # layer's alone (read, not held); their launches do not count
        real, saved = layers.flash_attention, fa.flash_fwd_launches
        planted = {}
        for fault, hit in (("every_layer", lambda i: True),
                           ("last_layer", lambda i: i == cfg.n_layers - 1)):
            calls = []

            def zeroed_v_half(q, k, v, hit=hit, calls=calls, **kw):
                if hit(len(calls)):
                    v = v.clone()
                    v[..., v.shape[-1] // 2:] = 0
                calls.append(1)
                return real(q, k, v, **kw)

            layers.flash_attention = zeroed_v_half
            try:
                bad = model(tokens).float().reshape(-1, ref.shape[-1])
            finally:
                layers.flash_attention = real
            planted[fault] = row_error_ratio(bad, ref, *LLAMA_LOGITS_ROW_TOL)
            del bad
        fa.flash_fwd_launches = saved
        out["planted_worst_row_ratio"] = planted
        del got, ref
        if abs(out["loss"] - out["xla"]["loss"]) > LOSS_TOL \
                or out["xla_fp32_attention"]["logits_max_abs_err"] > LOGITS_TOL \
                or out["xla_fp32_attention"]["worst_row_ratio"] > 1:
            raise AssertionError(f"(a): the flash forward disagrees with the xla forward: {out}")
        if planted["every_layer"] <= 1:
            raise AssertionError(f"(a): the logits' row rule passes a planted fault: {planted}")
        out["forward_ms"] = host_ms(lambda: model(tokens), 2)
        width = max(LLAMA_PROMPT_LENS)
        prompt = torch.randint(1, cfg.vocab_size, (len(LLAMA_PROMPT_LENS), width),
                               generator=gen).cuda()
        mask = torch.zeros_like(prompt, dtype=torch.bool)
        for r, n in enumerate(LLAMA_PROMPT_LENS):
            mask[r, width - n:] = True
        greedy = generate(model, prompt, max_new_tokens=LLAMA_NEW, prompt_mask=mask)
        out["inference_launches"] = fa.flash_fwd_launches  # the main path ends here
        if greedy.shape != (len(LLAMA_PROMPT_LENS), LLAMA_NEW) or greedy.min() < 0 \
                or greedy.max() >= cfg.vocab_size:
            raise AssertionError(f"(a): greedy tokens {tuple(greedy.shape)} out of range")
        rollout = []
        for r, n in enumerate(LLAMA_PROMPT_LENS):
            row = prompt[r, width - n:].tolist()
            got = greedy[r].tolist()
            seq = torch.tensor([row + got[:-1]], device="cuda")
            argmax = model(seq)[0, n - 1:].argmax(-1).tolist()
            rollout.append(_bf16_tie_held(model, row, got, argmax, f"(a) generate() row {r}",
                                          len(LLAMA_PROMPT_LENS)))
        out.update(rollout=rollout, greedy_first_row=greedy[0].tolist())
        prefill_ms = host_ms(lambda: generate(model, prompt, max_new_tokens=1, prompt_mask=mask),
                             1)
        total_ms = host_ms(lambda: generate(model, prompt, max_new_tokens=LLAMA_NEW + 1,
                                            prompt_mask=mask), 1)
        out.update(prefill_ms=prefill_ms, decode_step_ms=(total_ms - prefill_ms) / LLAMA_NEW)
    # the engine: 8 requests, fused T=8 ticks replayed as CUDA graphs
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in LLAMA_ENGINE_LENS]
    eng = ServingEngine(model, n_slots=len(prompts), decode_steps_per_tick=8,
                        scheduler=SchedulerConfig(max_prefills_per_tick=len(prompts)))
    reqs = [eng.add_request(Request(prompt=p, max_new_tokens=LLAMA_NEW, request_id=f"r{i}"))
            for i, p in enumerate(prompts)]
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    engine_s = time.perf_counter() - t0
    if eng.graph_captures < 1 or any(len(r.tokens) != LLAMA_NEW for r in reqs):
        raise AssertionError(f"(a): the engine captured {eng.graph_captures} graphs, tokens "
                             f"{[len(r.tokens) for r in reqs]}")
    held = []
    with torch.inference_mode():
        for i, (p, r) in enumerate(zip(prompts, reqs)):
            want = generate(model, torch.tensor([p], device="cuda"),
                            max_new_tokens=LLAMA_NEW)[0].tolist()
            held.append(_bf16_tie_held(model, p, r.tokens, want, f"(a) engine request r{i}",
                                       len(prompts)))
    out["engine"] = dict(captures=eng.graph_captures, wall_s=engine_s, held=held,
                         first_row=reqs[0].tokens)
    del eng, model
    gc.collect()
    torch.cuda.empty_cache()
    return out, draws


def llama_train_leg(seed, card_name, draws):
    """(b): ``llama_1b`` trained on one device at full depth: the step-1
    gradients of one minibatch, flash against xla on the same weights
    (phase 6's rule), then LLAMA_STEPS steps of LLAMA_MINIBATCHES
    minibatches of [LLAMA_ROWS, 2048] on one seeded batch (the launch
    counters set to 0 first), a falling loss; state bytes, peak memory,
    step ms (steps 2 on), tokens/s and MFU, the gated MLP's three products
    counted.  The masters start from ``draws`` ((a)'s seeded draws)."""
    from tpu_parallel_torch.core.metrics import compute
    from tpu_parallel_torch.models.gpt import make_gpt_loss
    from tpu_parallel_torch.train_lib import Trainer, TrainerConfig
    from tpu_parallel_torch.utils.profiling import peak_flops, transformer_flops_per_token

    from tpu_parallel_torch.train_lib import make_lr_schedule

    rows = LLAMA_ROWS * LLAMA_MINIBATCHES
    config = TrainerConfig(model="llama_1b", global_batch_size=rows,
                           num_minibatches=LLAMA_MINIBATCHES, steps=LLAMA_STEPS,
                           warmup_steps=LLAMA_WARMUP, seed=seed, mesh=LLAMA_ONE,
                           model_overrides=dict(attn_impl="flash", remat_policy="proj_attn",
                                                **LLAMA_SIZE))
    schedule = make_lr_schedule(config)
    lrs = [schedule(i) for i in range(LLAMA_STEPS)]
    if sum(lr > 0 for lr in lrs) < 3:
        raise AssertionError(f"(b): learning rates by step {lrs}: fewer than 3 updates")
    t0 = time.perf_counter()
    trainer = Trainer(config, device="cuda")
    state = trainer.init(draws)
    del draws
    torch.cuda.synchronize()
    out = dict(build_s=time.perf_counter() - t0)
    cfg = trainer.model_config
    batch = trainer.example_batch
    # one minibatch's loss and gradients, flash against xla on the same weights
    mb = batch.rows(0, LLAMA_ROWS)
    xla = dataclasses.replace(cfg, attn_impl="xla")
    grads = {}
    for name in ("flash", "xla"):
        for block in trainer.model.blocks.children():
            block.attn.config = xla if name == "xla" else cfg
        loss, _ = make_gpt_loss(cfg)(trainer.model, mb)
        loss.backward()
        grads[name] = (loss.item(), {n: p.grad for n, p in trainer.model.named_parameters()})
        trainer.model.zero_grad(set_to_none=True)
    for block in trainer.model.blocks.children():
        block.attn.config = cfg
    rel = {n: ((g.float() - grads["xla"][1][n].float()).norm()
               / grads["xla"][1][n].float().norm().clamp(min=1e-30)).item()
           for n, g in grads["flash"][1].items()}
    worst = max(rel, key=rel.get)
    out.update(flash_loss=grads["flash"][0], xla_loss=grads["xla"][0],
               grad_rel_max=(rel[worst], worst), grad_rel_median=sorted(rel.values())[len(rel) // 2])
    del grads
    if abs(out["flash_loss"] - out["xla_loss"]) > LOSS_TOL or rel[worst] > TRAIN_GRAD_TOL:
        raise AssertionError(f"(b): flash training gradients disagree with the xla path: {out}")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()  # the training main path starts here
    per_step, losses, step_ms = [], [], []
    for _ in range(LLAMA_STEPS):
        before = _launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = trainer.step_fn(state, None, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        per_step.append([a - b for a, b in zip(_launch_counts(), before)])
        losses.append(compute(metrics)["loss"])
    launches = dict(zip(LAUNCH_COUNTERS, _launch_counts()))
    want = cfg.n_layers * LLAMA_MINIBATCHES
    if per_step != [[want, want]] * LLAMA_STEPS:
        raise AssertionError(f"(b): launches per step {per_step}, want {want} of each kernel")
    _falls("(b)", losses)
    tokens = rows * cfg.seq_len
    timed = step_ms[1:]
    tokens_per_s = tokens / (sum(timed) / len(timed) / 1e3)
    peak = peak_flops(card_name)
    out.update(losses=losses, step_ms=step_ms, launches_per_step=per_step[0], launches=launches,
               tokens_per_s=tokens_per_s, state_bytes=_state_bytes(state),
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               params=trainer.num_params, flops_per_token=_gated_flops_per_token(cfg),
               profiling_flops_per_token=transformer_flops_per_token(cfg), lr_by_step=lrs)
    out["mfu"] = tokens_per_s * out["flops_per_token"] / peak if peak else None
    out["mfu_profiling_flops"] = (tokens_per_s * out["profiling_flops_per_token"] / peak
                                  if peak else None)
    del trainer, state, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _llama3d_batch(vocab, device, rows=LLAMA_3D_ROWS):
    """(c)'s one seeded global batch of [rows, 2048] (every step's)."""
    from tpu_parallel_torch.data import lm_batch

    return lm_batch(torch.Generator().manual_seed(SEED + 121), rows, LLAMA_SEQ, vocab,
                    device=device)


def _llama_prompt(vocab):
    return torch.randint(1, vocab, (1, 32), generator=torch.Generator().manual_seed(SEED + 122))


def _tensor_digest(t):
    import hashlib

    return hashlib.sha256(t.detach().to("cpu", torch.float32).numpy().tobytes()).hexdigest()


def _llama_fp32_grads(mesh, device):
    """The synced gradients of (c)'s model in fp32 (xla attention, TF32
    off) at LLAMA_3D_FP32_LAYERS layers on 2 x LLAMA_3D_FP32_MICRO seeded
    rows: this rank's local tensors on the host."""
    from tpu_parallel_torch.train_lib import Trainer

    rows = 2 * LLAMA_3D_FP32_MICRO
    config = _llama3d_config(
        mesh=LLAMA_MESH if mesh is not None else LLAMA_ONE, global_batch_size=rows,
        model_overrides=dict(n_layers=LLAMA_3D_FP32_LAYERS, dtype=torch.float32,
                             attn_impl="xla", num_microbatches=LLAMA_3D_FP32_MICRO))
    trainer = Trainer(config, mesh, device=device)
    state = trainer.init()
    batch = _llama3d_batch(trainer.model_config.vocab_size, device, rows)
    batch = trainer.local_rows(batch)
    grads = _host(_pp_grads(trainer, state, batch, mesh))
    cfg, shards = trainer.model_config, dict(state.shards)
    del trainer, state, batch
    gc.collect()
    torch.cuda.empty_cache()
    return grads, cfg, shards


def llama_reference_leg(workdir, draws):
    """(c)'s reference: one process, no group, (c)'s model (LLAMA_3D_LAYERS
    layers at full width) on the whole batch: its init masters' digests,
    the step-1 synced gradients, LLAMA_3D_STEPS steps' losses and step ms,
    state bytes and peak memory, its final bf16 weights and LLAMA_3D_NEW
    greedy tokens from them, and the fp32 pass's gradients; the gradients,
    weights and tokens saved for the ranks and the export check.  The
    masters start from ``draws`` ((a)'s draws of the same parameter names
    and seed: the ranks' own draws are bitwise the same).  It runs beside
    the ranks, which read its file only after their steps: its step times
    share the host with them."""
    from tpu_parallel_torch.core.metrics import compute
    from tpu_parallel_torch.models.generate import generate
    from tpu_parallel_torch.train_lib import Trainer

    t0 = time.perf_counter()
    trainer = Trainer(_llama3d_config(mesh=LLAMA_ONE), device="cuda")
    if trainer.mesh is not None:
        raise AssertionError("the one-process reference runs on a mesh")
    state = trainer.init(draws)
    init_s = time.perf_counter() - t0
    digests = {n: _tensor_digest(p) for n, p in state.params.items()}
    cfg = trainer.model_config
    batch = _llama3d_batch(cfg.vocab_size, "cuda")
    grads = _first_synced_grads(state)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for _ in range(LLAMA_3D_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = trainer.step_fn(state, None, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(compute(metrics)["loss"])
    peak = torch.cuda.max_memory_allocated()
    state_bytes = _state_bytes(state)
    final = {n: p.detach().to("cpu", copy=True) for n, p in trainer.model.state_dict().items()}
    with torch.inference_mode():
        tokens = generate(trainer.model, _llama_prompt(cfg.vocab_size).cuda(),
                          max_new_tokens=LLAMA_3D_NEW)[0].tolist()
    del trainer, state, batch
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    fp32_grads, _, _ = _llama_fp32_grads(None, "cuda")
    fp32_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    import os

    # written whole, then renamed: the ranks wait for the name
    torch.save(dict(final=final, tokens=tokens), Path(workdir, "llama_ref_final.pt"))
    torch.save(dict(grads=grads, losses=losses, fp32_grads=fp32_grads),
               Path(workdir, "llama_ref.pt.tmp"))
    os.replace(Path(workdir, "llama_ref.pt.tmp"), Path(workdir, "llama_ref.pt"))
    save_s = time.perf_counter() - t0
    return dict(losses=losses, step_host_ms=step_ms, max_memory_allocated=peak,
                state_bytes=state_bytes, init_s=init_s, digests=digests, tokens=tokens,
                fp32_s=fp32_s, save_s=save_s)


def _llama_assembled(state, name, value):
    """The full tensor of one parameter's local ``value`` (a rank's slice
    under ``state.shards[name]``): all-gathered over each axis of its
    (nested) split, innermost first; a collective of the data and model
    ranks."""
    import torch.distributed as dist

    info = state.shards.get(name)
    value = value.detach()
    while info is not None:
        parts = [torch.empty_like(value) for _ in range(info.size)]
        dist.all_gather(parts, value.contiguous(), group=info.group)
        value = torch.cat(parts, dim=info.dim)
        info = info.outer
    return value


def _jax_local_shape(name, shape, tp, dp, min_size=2**18):
    """A parameter's local torch shape under JAX's rules, reckoned from its
    name and global shape without the port's code: ``TPDense`` splits a
    column layer's output (``qkv``, ``gate``, ``up``, the lm_head, the
    column bias) and a row layer's input (``out``, ``down``) over the model
    axis; then FSDP's ``shard_params`` on that local (TP-stacked) leaf
    splits the largest dim of its flax shape that the data axis divides
    (the later of two equal ones), when it holds more than ``min_size``
    elements."""
    shape = list(shape)
    linear = name.endswith(".weight") and len(shape) == 2 and not name.startswith("embed.")
    if any(name.endswith(f"{k}.weight") or name.endswith(f"{k}.bias")
           for k in ("attn.qkv", "mlp.gate", "mlp.up")) or name == "lm_head.weight":
        shape[0] //= tp
    elif name.endswith(("attn.out.weight", "mlp.down.weight")):
        shape[1] //= tp
    n = 1
    for s in shape:
        n *= s
    if n <= min_size:
        return shape
    flax = list(reversed(shape)) if linear else shape
    order = sorted(range(len(flax)), key=lambda d: (flax[d], d), reverse=True)
    for d in order:
        if flax[d] % dp == 0:
            flax[d] //= dp
            break
    return list(reversed(flax)) if linear else flax


def _llama_reckoned_bytes(cfg, names_shapes, tp, dp):
    """This rank's state bytes from :func:`_jax_local_shape`, counted as
    :func:`_state_bytes` counts them: the fp32 master, accumulator and two
    AdamW moments of every parameter, and the module's own weight (a bf16
    copy, or the fp32 master itself, counted again)."""
    total = 0
    for name, (shape, dtype) in names_shapes.items():
        n = 1
        for s in _jax_local_shape(name, shape, tp, dp, cfg.fsdp_min_size):
            n *= s
        total += n * (16 + (2 if dtype == torch.bfloat16 else 4))
    return total


def _llama_want_counts(cfg, pipe_rank, pipe, micro):
    """The collectives per step of one GPipe minibatch on pipe rank
    ``pipe_rank``, derived from the schedule and "proj_attn": each of the
    stage's layers runs once per microbatch forward and once in its
    backward's recompute, each run one packed FSDP gather of its bf16
    slices (the norms and biases, under ``fsdp_min_size``, stay
    replicated), the forward's gather reduce-scattered once; the first rank
    gathers the embedding once for the whole batch, the last rank the
    lm_head once for the loss, each reduce-scattered once.  Tensor
    parallelism: two row all-reduces per layer forward (kept by the
    policy, none in the recompute) and their two transposes in the
    backward, the vocab-parallel loss's 5 and 2 on the last rank.  The
    pipe: the first rank sends each microbatch's activation and receives
    its gradient, the last the reverse.  Returns (gathers, reduce-scatters,
    model-axis all-reduces, sends, receives)."""
    layers = cfg.n_layers // pipe
    edge = 1  # the embedding on the first rank, the lm_head on the last
    last = pipe_rank == pipe - 1
    return [2 * micro * layers + edge, micro * layers + edge,
            4 * micro * layers + (7 if last else 0), micro, micro]


def _llama_counts():
    from tpu_parallel_torch.parallel import dp, fsdp, pp, tp

    return [fsdp.fsdp_allgather_launches, fsdp.fsdp_reducescatter_launches,
            tp.tp_allreduce_launches, pp.pp_send_launches, pp.pp_recv_launches,
            dp.dp_allreduce_launches]


def _llama_exchange_ms(mesh, cfg, state):
    """Host ms of one model-axis all-reduce of a microbatch's bf16
    activation [1, 2048, d_model], one pipe hop of it, and one data-axis
    FSDP gather of a block's bf16 slices (as its unit packs them), each
    averaged over 5 after one warm-up; their bytes per rank."""
    import torch.distributed as dist

    from tpu_parallel_torch.parallel import pp, tp

    act = torch.randn(1, LLAMA_SEQ, cfg.d_model, device="cuda:0").to(cfg.dtype)
    buf = torch.empty_like(act)
    group, size, index = pp.pipe_axis(mesh)
    block = next(iter(state.model.blocks.children()))
    unit = block._fsdp_unit
    out = {}
    for name, fn in (
            ("allreduce", lambda: tp.all_reduce(act, "model", mesh)),
            ("hop", lambda: pp._exchange(group, [(act, (index + 1) % size)],
                                         [(buf, (index - 1) % size)])),
            ("gather", lambda: unit.gather())):
        dist.barrier()
        with torch.no_grad():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
        out[f"{name}_host_ms"] = (time.perf_counter() - t0) / 5 * 1e3
    out.update(activation_bytes=act.numel() * act.element_size(),
               gather_bytes=sum(p.numel() * p.element_size() for p in
                                (owner._parameters[attr] for owner, attr, _ in unit.entries)))
    return out


def llama_rank_leg(rank, rendezvous, workdir):
    """(c): one of LLAMA_RANKS gloo ranks on the one card over data 2 x
    model 2 x pipe 2 (``fsdp=True``, GPipe over LLAMA_3D_MICRO
    microbatches): the init's masters gathered over both axes (sha256 per
    parameter, on the rank at data and model coordinate 0); the state bytes
    against :func:`_llama_reckoned_bytes`; LLAMA_3D_STEPS counted steps (the
    launch counters set to 0 first) with the collectives of each against
    :func:`_llama_want_counts`, losses within LOSS_TOL of the reference's
    and the step-1 synced gradients within TRAIN_GRAD_TOL per weight of
    the reference's (this rank's slices); a checkpoint saved at step 2 and
    restored into a fresh init bitwise; the exchanges' host ms; the fp32
    pass within LLAMA_3D_FP32_TOL per weight; the final module weights
    gathered over both axes and saved by the rank at data and model
    coordinate 0 of each stage (the export)."""
    import torch.distributed as dist

    from tpu_parallel_torch.core.metrics import compute
    from tpu_parallel_torch.runtime import MeshConfig, initialize, make_mesh, process_info
    from tpu_parallel_torch.train_lib import Trainer

    initialize(rendezvous, LLAMA_RANKS, rank, backend="gloo", device="cuda:0")
    _share_cores(LLAMA_RANKS)
    start_s, legs_s = time.perf_counter(), {}

    def lap(name):
        legs_s[name] = time.perf_counter() - start_s - sum(legs_s.values())

    mesh = make_mesh(MeshConfig(**LLAMA_MESH))
    coord = {a: mesh.get_local_rank(a) for a in ("data", "model", "pipe")}
    lead = coord["data"] == 0 and coord["model"] == 0
    result = dict(rank=rank, coord=coord, process_info=process_info())
    config = _llama3d_config(mesh=LLAMA_MESH)
    trainer = Trainer(config, mesh, device="cuda:0")
    state = trainer.init()
    cfg = trainer.model_config
    lap("init")
    # the masters at step 0, gathered over data and model
    digests = {}
    for name, value in state.params.items():
        full = _llama_assembled(state, name, value)
        if lead:
            digests[name] = _tensor_digest(full)
        del full
    result["init_digests"] = digests
    result["nested"] = sum(len(info.axes) == 2 for info in state.shards.values())
    names_shapes = {n: (tuple(s.global_shape) if (s := state.shards.get(n)) is not None
                        else tuple(p.shape), p.dtype)
                    for n, p in trainer.model.named_parameters()}
    result["state_bytes"] = _state_bytes(state)
    result["reckoned_bytes"] = _llama_reckoned_bytes(cfg, names_shapes, LLAMA_MESH["model"],
                                                     LLAMA_MESH["data"])
    if sum(result["state_bytes"].values()) != result["reckoned_bytes"]:
        raise AssertionError(f"rank {rank}: state bytes {result['state_bytes']} against "
                             f"{result['reckoned_bytes']} reckoned from JAX's rule")
    lap("layout")
    batch = trainer.local_rows(_llama3d_batch(cfg.vocab_size, "cuda:0"))
    synced = _first_synced_grads(state)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()  # the main path starts here
    losses, per_step, comm, step_ms = [], [], [], []
    for i in range(LLAMA_3D_STEPS):
        before, cbefore = _launch_counts(), _llama_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = trainer.step_fn(state, None, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        per_step.append([a - b for a, b in zip(_launch_counts(), before)])
        comm.append([a - b for a, b in zip(_llama_counts(), cbefore)])
        losses.append(compute(metrics)["loss"])
        if i == 1:
            result["checkpoint"] = _llama_checkpoint(trainer, config, mesh, rank, workdir)
    result.update(losses=losses, launches_per_step=per_step, comm_per_step=comm,
                  step_host_ms=step_ms, launches=dict(zip(LAUNCH_COUNTERS, _launch_counts())),
                  max_memory_allocated=torch.cuda.max_memory_allocated())
    lap("steps")
    # the reference runs beside the ranks: its file appears when it is done
    path = Path(workdir, "llama_ref.pt")
    deadline = time.perf_counter() + LLAMA_LEG_TIMEOUT
    while not path.exists():
        if time.perf_counter() > deadline:
            raise AssertionError(f"rank {rank}: the reference never wrote {path}")
        time.sleep(0.2)
    ref = torch.load(path, weights_only=True, mmap=True)
    lap("reference_wait")
    want_comm = _llama_want_counts(cfg, coord["pipe"], LLAMA_MESH["pipe"], cfg.num_microbatches)
    layers = cfg.n_layers // LLAMA_MESH["pipe"] * cfg.num_microbatches
    if per_step != [[layers, layers]] * LLAMA_3D_STEPS \
            or any(c[:5] != want_comm for c in comm):
        raise AssertionError(f"rank {rank}: launches per step {per_step} (want {layers}), "
                             f"collectives {comm} (want {want_comm} and the gradient sync)")
    want = {n: (state.shards[n].local(ref["grads"][n]) if n in state.shards
                else ref["grads"][n]) for n in synced}
    rel = _moe_rel(cfg, synced, want)
    worst = max(rel.items(), key=lambda kv: kv[1])
    result.update(loss_diffs=[abs(a - b) for a, b in zip(losses, ref["losses"])],
                  step1_grad_rel_max=worst, step1_grad_rel_median=sorted(rel.values())[len(rel) // 2])
    if max(result["loss_diffs"]) > LOSS_TOL or worst[1] > TRAIN_GRAD_TOL:
        raise AssertionError(f"rank {rank} disagrees with one process: losses {losses} against "
                             f"{ref['losses']}, step-1 gradients worst {worst}")
    result["exchange"] = _llama_exchange_ms(mesh, cfg, state)
    lap("exchange")
    # the export: every parameter gathered over data and model
    t0 = time.perf_counter()
    exported = {}
    for name, p in trainer.model.named_parameters():
        full = _llama_assembled(state, name, p)
        if lead:
            exported[name] = full.to("cpu", copy=True)
    if lead:
        torch.save(exported, Path(workdir, f"llama_export_p{coord['pipe']}.pt"))
    result["export_s"] = time.perf_counter() - t0
    del exported
    try:
        from tpu_parallel_torch.parallel.tp import export_single_device_params

        export_single_device_params(state.partitioned(state.params))
        result["export_error"] = ""
    except ValueError as exc:
        result["export_error"] = str(exc)
    lap("export")
    del trainer, state, batch
    gc.collect()
    torch.cuda.empty_cache()
    fp32, fcfg, shards = _llama_fp32_grads(mesh, "cuda:0")
    # this rank's slices of the reference's full gradients
    fp32_want = {n: (shards[n].local(ref["fp32_grads"][n]) if n in shards
                     else ref["fp32_grads"][n]) for n in fp32}
    rel = _moe_rel(fcfg, fp32, fp32_want)
    worst = max(rel.items(), key=lambda kv: kv[1])
    result["fp32"] = dict(grad_rel_max=worst, grad_rel_median=sorted(rel.values())[len(rel) // 2])
    if worst[1] > LLAMA_3D_FP32_TOL:
        raise AssertionError(f"rank {rank}: fp32 synced gradients disagree with one process's: "
                             f"{result['fp32']}")
    lap("fp32")
    result["legs_s"] = legs_s
    del ref
    dist.barrier()
    dist.destroy_process_group()
    return result


def _llama_checkpoint(trainer, config, mesh, rank, workdir):
    """(c)'s checkpoint: the state after step 2 saved (every rank its
    slices and stage, ``torch.distributed.checkpoint``; a nested slice as a
    ``_StridedShard`` ``DTensor``) and restored into a fresh Trainer's
    init, in place: every tensor bitwise equal, the module's too."""
    from tpu_parallel_torch.train_lib import Trainer

    directory = str(Path(workdir, "llama_ckpt"))
    step = trainer.state.step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.save_checkpoint(directory, step)
    save_ms = (time.perf_counter() - t0) * 1e3
    fresh = Trainer(config, mesh, device="cuda:0")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fresh.restore_checkpoint(directory)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    want, got = _local_leaves(trainer.state.state_dict()), _local_leaves(fresh.state.state_dict())
    module_equal = all(torch.equal(a, b) for a, b in zip(trainer.model.parameters(),
                                                         fresh.model.parameters()))
    if got.keys() != want.keys() or not all(torch.equal(got[k], want[k]) for k in want) \
            or not module_equal or fresh.state.step != step:
        raise AssertionError(f"rank {rank}: the restored state differs from the saved one")
    tensors = len(want)
    del fresh
    gc.collect()
    torch.cuda.empty_cache()
    return dict(step=step, save_ms=save_ms, restore_ms=restore_ms, local_tensors=tensors)


def llama_cli_rank_leg(metrics):
    """(d)'s rank, under torchrun (LLAMA_CLI_RANKS processes):
    ``tpu_parallel_torch.train``'s ``main`` on ``--config=llama_1b_3d`` over
    data 2 x model 2 x pipe 1 at LLAMA_CLI_LAYERS layers, CLI_ROWS rows,
    LLAMA_CLI_STEPS steps, over gloo on ``cuda:0``, with each step's
    launches and loss."""
    from tpu_parallel_torch import train
    from tpu_parallel_torch.core.metrics import accumulate_metrics, compute
    from tpu_parallel_torch.train_lib import Trainer

    per_step, losses = [], []
    real_step = Trainer.step_fn

    def step(self, state, metrics, batch):
        before = _launch_counts()
        state, step_metrics = real_step(self, state, None, batch)
        per_step.append([a - b for a, b in zip(_launch_counts(), before)])
        losses.append(compute(step_metrics)["loss"])
        return state, accumulate_metrics(metrics, step_metrics)

    Trainer.step_fn = step
    _share_cores(LLAMA_CLI_RANKS)
    _reset_launches()  # the main path starts here
    code = train.main(["--config=llama_1b_3d", "--config.mesh.data=2", "--config.mesh.model=2",
                       "--config.mesh.pipe=1",
                       *(f"--config.model_overrides.{k}={v}" for k, v in LLAMA_SIZE.items()),
                       f"--config.model_overrides.n_layers={LLAMA_CLI_LAYERS}",
                       f"--config.global_batch_size={CLI_ROWS}",
                       f"--config.steps={LLAMA_CLI_STEPS}", "--config.log_every=1",
                       f"--metrics-out={metrics}", "--device=cuda:0", "--backend=gloo"])
    import os

    result = dict(exit=code, rank=int(os.environ["RANK"]), launches_per_step=per_step,
                  losses=losses, launches=dict(zip(LAUNCH_COUNTERS, _launch_counts())))
    # the ranks share torchrun's stdout: each writes its result to a file
    Path(metrics).with_name(f"llama_cli_rank{result['rank']}.json").write_text(json.dumps(result))
    return result


def llama_cli_leg(work, cores):
    """(d), launched: ``python -m torch.distributed.run --standalone
    --nproc_per_node=LLAMA_CLI_RANKS`` over this script's ``llama_cli_rank``
    leg; :func:`llama_cli_check` holds it."""
    metrics = Path(work, "llama_metrics.prom")
    cmd = _torchrun(str(Path(__file__).resolve()), "--leg", "llama_cli_rank", str(metrics))
    cmd[cmd.index("--nproc_per_node=1")] = f"--nproc_per_node={LLAMA_CLI_RANKS}"
    return _launch(cmd, cores), metrics


def llama_cli_check(collected):
    """(d): exit 0 on every rank, one topology line (LLAMA_CLI_RANKS
    processes, gloo); LLAMA_CLI_LAYERS launches of each kernel per step;
    finite losses, equal on every rank; ``train_loss`` in the metrics."""
    import math

    (out, wall), metrics = collected
    topology = [json.loads(line[len("topology: "):]) for line in out.splitlines()
                if line.startswith("topology: ")]
    if len(topology) != 1 or topology[0]["process_count"] != LLAMA_CLI_RANKS \
            or topology[0]["backend"] != "gloo":
        raise AssertionError(f"CLI topology lines {topology}")
    ranks = [json.loads(metrics.with_name(f"llama_cli_rank{r}.json").read_text())
             for r in range(LLAMA_CLI_RANKS)]
    want = [LLAMA_CLI_LAYERS] * 2
    for r in ranks:
        if r["exit"] != 0 or r["launches_per_step"] != [want] * LLAMA_CLI_STEPS \
                or r["losses"] != ranks[0]["losses"] \
                or not all(math.isfinite(x) for x in r["losses"]):
            raise AssertionError(f"(d) rank {r['rank']}: {r}, want launches {want}")
    if "train_loss" not in metrics.read_text():
        raise AssertionError("CLI metrics without train_loss")
    return dict(wall_s=wall, topology=topology[0], losses=ranks[0]["losses"],
                launches_per_step=ranks[0]["launches_per_step"][0])


def _llama_export_check(work, ref):
    """(c)'s export on one device: the ranks' gathered final weights (the
    stages' files) loaded into a ``GPTLM`` of (c)'s model, LLAMA_3D_NEW
    greedy tokens from it against the reference's final weights' tokens:
    equal, or first differing where the reference's top-2 gap is below
    twice what the two weight sets move those logits by."""
    from tpu_parallel_torch.models import GPTLM
    from tpu_parallel_torch.models.generate import generate

    saved = torch.load(Path(work, "llama_ref_final.pt"), weights_only=True)
    exported = {}
    for p in range(LLAMA_MESH["pipe"]):
        exported.update(torch.load(Path(work, f"llama_export_p{p}.pt"), weights_only=True))
    model = GPTLM(_llama_model_config(n_layers=LLAMA_3D_LAYERS), device="cuda",
                  seed=None).eval()
    if sorted(exported) != sorted(saved["final"]):
        raise AssertionError(f"the export's parameters {sorted(exported)[:4]}... differ from the "
                             "one-process model's")
    prompt = _llama_prompt(model.config.vocab_size).cuda()
    model.load_state_dict(exported)
    with torch.inference_mode():
        got = generate(model, prompt, max_new_tokens=LLAMA_3D_NEW)[0].tolist()
    want = saved["tokens"]
    out = dict(tokens=got, reference_tokens=want, equal=got == want)
    if got != want:
        step = next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)
        ctx = torch.cat([prompt, torch.tensor([want[:step]], dtype=torch.long, device="cuda")],
                        1)
        with torch.inference_mode():
            mine = model(ctx)[0, -1].float()
            model.load_state_dict(saved["final"])
            theirs = model(ctx)[0, -1].float()
        top2 = theirs.topk(2).values
        gap, noise = (top2[0] - top2[1]).item(), (mine - theirs).abs().max().item()
        out.update(first_diff=step, top2_gap=gap, weights_noise=noise)
        if gap >= max(FP32_TIE_GAP, 2 * noise):
            raise AssertionError(f"(c): the export's greedy tokens differ from the one-process "
                                 f"model's at token {step}: {out}")
    del model, saved, exported
    gc.collect()
    torch.cuda.empty_cache()
    return out


def llama_phase(smi, work, cli_collected):
    """Phase 18: the kernels at ``llama_1b``'s D=128 shapes (one device's
    minibatch, a 3-D rank's microbatch) against their plain versions, then
    (a) and (b) on one device, (c)'s reference and ranks, the export check
    and (d)'s CLI, in the directory ``work``.  Returns the report, the
    kernels' rows and the main paths' launches ((a)'s inference, (b)'s
    training, (c)'s rank 0)."""
    start = time.perf_counter()
    legs_s = {}

    def lap(name):
        legs_s[name] = time.perf_counter() - start - sum(legs_s.values())

    gen = torch.Generator(device="cuda").manual_seed(SEED + 123)
    rows = dict(fwd=fwd_kernel_row("t_llama_pass", LLAMA_SHAPE, gen),
                bwd=bwd_kernel_row("t_llama_pass", LLAMA_SHAPE, gen, main_path=True),
                fwd3d=fwd_kernel_row("t_llama3d_pass", LLAMA_3D_SHAPE, gen),
                bwd3d=bwd_kernel_row("t_llama3d_pass", LLAMA_3D_SHAPE, gen, main_path=True))
    gc.collect()
    torch.cuda.empty_cache()
    lap("kernels")
    # started after the kernels' turns (their imports crowd the host), they
    # start up beside (a) and (b)
    ranks = _spawn_ranks("llama_rank", work, LLAMA_RANKS)
    serve, draws = llama_serve_leg(SEED)
    lap("serve")
    log(f"[llama serve] llama_1b ({serve['params'] / 1e6:.1f}M parameters: 16 layers, d 2048, "
        f"16 heads of 128, rope, RMSNorm, swiglu, vocab 32000, bf16, flash; built in "
        f"{serve['build_s']:.1f} s, the draws shared with (b)) on one device: forward "
        f"[{LLAMA_ROWS}, 2048] "
        f"{serve['forward_ms']:.2f} ms; loss {serve['loss']:.6f} against the xla path's "
        f"{serve['xla']['loss']:.6f} (tol {LOSS_TOL}); logits max abs err against the xla "
        f"path with its attention in fp32 {serve['xla_fp32_attention']['logits_max_abs_err']:.4f} "
        f"(tol {LOGITS_TOL}; relative L2 {serve['xla_fp32_attention']['logits_rel_l2']:.3e}; "
        f"worst token's row {serve['xla_fp32_attention']['worst_row_ratio']:.4f} of the row "
        f"rule's limit {LLAMA_LOGITS_ROW_TOL}, planted faults (V's second half zeroed) "
        f"{serve['planted_worst_row_ratio']} of it), "
        f"against the bf16 xla path {serve['xla']['logits_max_abs_err']:.4f} (relative L2 "
        f"{serve['xla']['logits_rel_l2']:.3e}; that path's own against fp32 attention "
        f"{serve['xla']['against_fp32_attention']}); flash_fwd launches over the forward and "
        f"generate() {serve['inference_launches']}")
    log(f"  greedy generate() on {len(LLAMA_PROMPT_LENS)} ragged prompts {LLAMA_PROMPT_LENS}, "
        f"{LLAMA_NEW} new tokens, against the full forward's argmax: {serve['rollout']}; "
        f"prefill + first token {serve['prefill_ms']:.2f} ms, decode "
        f"{serve['decode_step_ms']:.3f} ms per step at batch {len(LLAMA_PROMPT_LENS)}; first row "
        f"{serve['greedy_first_row']}")
    eng = serve["engine"]
    log(f"  the engine, {len(LLAMA_ENGINE_LENS)} requests of {LLAMA_NEW} tokens, fused T=8 ticks "
        f"({eng['captures']} CUDA graphs captured), {eng['wall_s']:.2f} s: against generate() at "
        f"batch 1 {eng['held']}; first row {eng['first_row']}")
    ref_draws = {n: v for n, v in draws.items()
                 if not n.startswith("blocks.") or int(n.split(".")[1][6:]) < LLAMA_3D_LAYERS}
    train = llama_train_leg(SEED, smi.split(",")[0].strip(), draws)
    del draws
    lap("train")
    gib = lambda x: f"{x / 2**30:.3f} GiB"  # noqa: E731
    log(f"[llama train] llama_1b ({train['params'] / 1e6:.1f}M parameters; Trainer built and "
        f"initialized from (a)'s draws in {train['build_s']:.1f} s), {LLAMA_MINIBATCHES} "
        f"minibatches of "
        f"[{LLAMA_ROWS}, 2048] per step, flash, proj_attn, AdamW, warmup {LLAMA_WARMUP} "
        f"(learning rates {train['lr_by_step']}): step-1 minibatch loss flash "
        f"{train['flash_loss']:.6f} xla {train['xla_loss']:.6f} (tol {LOSS_TOL}); gradients "
        f"relative L2 median {train['grad_rel_median']:.3e}, max {train['grad_rel_max'][0]:.3e} "
        f"({train['grad_rel_max'][1]}), tol {TRAIN_GRAD_TOL}")
    log(f"  losses {[round(x, 5) for x in train['losses']]}; launches per step (flash_fwd, "
        f"flash_bwd) {train['launches_per_step']}; step ms "
        f"{[round(x, 1) for x in train['step_ms']]}; {train['tokens_per_s']:.0f} tokens/s; MFU "
        f"{train['mfu']} with the "
        f"gated MLP's three products ({train['flops_per_token'] / 1e9:.3f} GFLOP per token; "
        f"{train['mfu_profiling_flops']} by profiling.transformer_flops_per_token's "
        f"{train['profiling_flops_per_token'] / 1e9:.3f}); state "
        f"{gib(sum(train['state_bytes'].values()))}, max memory allocated "
        f"{gib(train['max_memory_allocated'])}")
    Path(work, "llama_rank_go").touch()  # the ranks run beside the reference
    ref = _reference(functools.partial(llama_reference_leg, draws=ref_draws), work)
    del ref_draws
    lap("reference")
    ranks = _join_ranks(ranks, LLAMA_LEG_TIMEOUT)
    lap("ranks")
    export = _llama_export_check(work, ref)
    lap("export")
    cli = llama_cli_check(cli_collected)
    for p in ranks:
        for name, digest in p["init_digests"].items():
            if digest != ref["digests"][name]:
                raise AssertionError(f"(c) rank {p['rank']}: the gathered init master {name} "
                                     "differs from the one-process init")
        if p["losses"] != ranks[0]["losses"]:
            raise AssertionError("(c): the ranks' synced losses differ")
        if "split over mesh axis" not in p["export_error"]:
            raise AssertionError(f"(c) rank {p['rank']}: export_single_device_params took a "
                                 f"state split over the model axis: {p['export_error']!r}")
    checked = sum(len(p["init_digests"]) for p in ranks)
    r0 = ranks[0]
    comm = {tuple(p["coord"].values()): p["comm_per_step"][0] for p in ranks}
    log(f"[llama reference] one process, {LLAMA_3D_LAYERS} layers at full width, "
        f"[{LLAMA_3D_ROWS}, 2048] per step: losses {[round(x, 5) for x in ref['losses']]}, step "
        f"host ms {[round(x, 1) for x in ref['step_host_ms']]}, state "
        f"{gib(sum(ref['state_bytes'].values()))}, max memory allocated "
        f"{gib(ref['max_memory_allocated'])}, init {ref['init_s']:.1f} s, fp32 pass "
        f"{ref['fp32_s']:.1f} s")
    log(f"[llama 3d] {LLAMA_RANKS} gloo ranks on cuda:0, data 2 x model 2 x pipe 2, fsdp=True, "
        f"GPipe over {LLAMA_3D_MICRO} microbatches of one row per data rank "
        f"({r0['process_info']['backend']}): init masters gathered over both axes bitwise equal "
        f"to the one-process init ({checked} parameters checked); {r0['nested']} parameters "
        f"split over model and data on rank 0; state bytes by rank "
        f"{[sum(p['state_bytes'].values()) for p in ranks]} equal to JAX's rule's "
        f"{[p['reckoned_bytes'] for p in ranks]}; launches per step {r0['launches_per_step'][0]}; "
        f"(gathers, reduce-scatters, model-axis all-reduces, sends, receives, gradient "
        f"all-reduces) per step by (data, model, pipe) {comm}")
    log(f"  losses {[round(x, 5) for x in r0['losses']]} (|diff| against one process "
        f"{['%.2e' % x for x in r0['loss_diffs']]}, tol {LOSS_TOL}); step-1 synced gradients "
        f"relative L2 per weight by rank, median "
        f"{['%.3e' % p['step1_grad_rel_median'] for p in ranks]}, max "
        f"{[(p['step1_grad_rel_max'][0], '%.3e' % p['step1_grad_rel_max'][1]) for p in ranks]} "
        f"(tol {TRAIN_GRAD_TOL}); fp32 at {LLAMA_3D_FP32_LAYERS} layers: max "
        f"{[('%.3e' % p['fp32']['grad_rel_max'][1]) for p in ranks]} (tol {LLAMA_3D_FP32_TOL})")
    log(f"  step host ms by rank {[[round(x, 1) for x in p['step_host_ms']] for p in ranks]} "
        f"against one process's {[round(x, 1) for x in ref['step_host_ms']]}; state "
        f"{[gib(sum(p['state_bytes'].values())) for p in ranks]}, max memory allocated in a step "
        f"{[gib(p['max_memory_allocated']) for p in ranks]}")
    ex = [p["exchange"] for p in ranks]
    log(f"  host ms by rank: model-axis all-reduce of {ex[0]['activation_bytes']} bytes "
        f"{[round(e['allreduce_host_ms'], 2) for e in ex]}, pipe hop "
        f"{[round(e['hop_host_ms'], 2) for e in ex]}, a block's FSDP gather of "
        f"{ex[0]['gather_bytes']} bytes per rank {[round(e['gather_host_ms'], 2) for e in ex]}")
    ck = r0["checkpoint"]
    log(f"  checkpoint at step {ck['step']} restored bitwise into a fresh init on every rank "
        f"({ck['local_tensors']} local tensors on rank 0; save {ck['save_ms']:.1f} ms, restore "
        f"{ck['restore_ms']:.1f} ms); export_single_device_params refuses the state as JAX's "
        f"does ({r0['export_error'][:60]}...); the state gathered over both axes by this "
        f"script's all-gathers, not by an entry point of the port ({r0['export_s']:.1f} s), "
        f"on one device: greedy tokens {export}")
    log(f"  legs' seconds by rank {[{k: round(v, 1) for k, v in p['legs_s'].items()} for p in ranks]}")
    log(f"[llama cli] torchrun --nproc_per_node={LLAMA_CLI_RANKS} -m tpu_parallel_torch.train "
        f"--config=llama_1b_3d (data 2 x model 2 x pipe 1, {LLAMA_CLI_LAYERS} layers, "
        f"{CLI_ROWS} rows, {LLAMA_CLI_STEPS} steps; started with the CLI batch at phase 9): exit 0, "
        f"collected {cli['wall_s']:.1f} s after its launch; topology {cli['topology']}; losses "
        f"{cli['losses']}; launches per step {cli['launches_per_step']}")
    phase_s = time.perf_counter() - start
    log(f"[llama] phase 18 took {phase_s:.1f} s ("
        + ", ".join(f"{k} {v:.1f}" for k, v in legs_s.items()) + ")")
    log(f"card: {smi}")
    launches = dict(inference=dict(flash_fwd_launches=serve["inference_launches"],
                                   flash_bwd_launches=0),
                    training=train["launches"], ranks=r0["launches"])
    return (dict(serve=serve, train=train, reference=ref, ranks=ranks, export=export, cli=cli,
                 phase_s=phase_s, legs_s=legs_s), rows, launches)


def leg_main(argv):
    """``chip_smoke.py --leg <name> ...``: one leg of phases 12-17 in
    this process; prints its result as one ``dp-leg-result:`` JSON line."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name, rest = argv[0], argv[1:]
    if name == "moe_rank":
        _share_cores(MOE_RANKS)
        draws = _moe_draws()
    if name in RANK_LEGS:
        _wait_to_run(name, rest[2])
    if name == "dp_nccl":
        result = dp_nccl_leg()
    elif name == "dp_pair":
        result = dp_pair_leg(int(rest[0]), rest[1], rest[2])
    elif name == "fsdp_pair":
        result = fsdp_pair_leg(int(rest[0]), rest[1], rest[2])
    elif name == "tp_cli_rank":
        result = tp_cli_rank_leg(rest[0])
    elif name == "tp_pair":
        result = tp_pair_leg(int(rest[0]), rest[1], rest[2])
    elif name == "pp_cli_rank":
        result = pp_cli_rank_leg(rest[0])
    elif name == "pp_rank":
        result = pp_rank_leg(int(rest[0]), rest[1], rest[2])
    elif name == "sp_cli_rank":
        result = sp_cli_rank_leg(rest[0])
    elif name == "sp_rank":
        result = sp_rank_leg(int(rest[0]), rest[1], rest[2])
    elif name == "moe_rank":
        result = moe_rank_leg(int(rest[0]), rest[1], rest[2], draws)
    elif name == "llama_cli_rank":
        result = llama_cli_rank_leg(rest[0])
    elif name == "llama_rank":
        result = llama_rank_leg(int(rest[0]), rest[1], rest[2])
    else:
        raise SystemExit(f"unknown leg {name!r}")
    print(DP_RESULT + json.dumps(result), flush=True)
    return 0


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    clock = [time.perf_counter()]

    def took(phases):
        """Log the seconds since the last call: the run's time by phase."""
        now = time.perf_counter()
        log(f"[time] {phases} took {now - clock[0]:.1f} s")
        clock[0] = now

    smi = setup()
    kernel_rows = kernel_phase(SEED)
    bwd_rows = backward_kernel_phase(SEED)
    took("phases 1-2b (build, kernels)")

    from tpu_parallel_torch.ops import flash_attention as fa

    for name in LAUNCH_COUNTERS:  # the inference main path starts here
        setattr(fa, name, 0)
    model, fwd = forward_phase(SEED)
    gen = generate_phase(model, SEED)
    inference_launches = fa.flash_fwd_launches
    if inference_launches == 0:
        raise AssertionError("the inference path never launched flash_fwd")
    log(f"[inference] flash_fwd launches over phases 3-4: {inference_launches}")
    profile_phase(model, SEED)
    del model
    torch.cuda.empty_cache()
    took("phases 3-5 (inference, profiles)")
    launches, train = train_phase(SEED, smi.split(",")[0].strip())
    if not all(launches.values()):
        raise AssertionError(f"the training path left a kernel unlaunched: {launches}")
    took("phase 6 (training)")
    for name in LAUNCH_COUNTERS:  # the serving main path starts here
        setattr(fa, name, 0)
    serve, serve_tokens = serve_phase(SEED, smi)
    took("phase 7 (serving)")
    kv = hier_phase(SEED, smi)
    took("phase 8 (KV hierarchy)")
    import shutil
    import tempfile

    work = tempfile.mkdtemp(prefix="dp_legs_")
    try:
        # phases 12-18's CLI legs run beside phases 9 and 10 (and 11 if
        # they outlast them), collected in phase 12
        clis = cli_batch(work)
        spec, spec_tokens = spec_phase(SEED, smi)
        took("phase 9 (speculative decoding)")
        extras = extras_phase(SEED, smi, serve_tokens, spec_tokens)
        took("phase 10 (decode extras)")
        serve_launches = {name: getattr(fa, name) for name in LAUNCH_COUNTERS}
        if any(serve_launches.values()):
            raise AssertionError(f"the serving path launched flash kernels: {serve_launches}")
        gc.collect()
        torch.cuda.empty_cache()
        shell, shell_rows, shell_launches = trainer_phase(SEED, smi)
        for path, counts in shell_launches.items():
            if not all(counts.values()):
                raise AssertionError(f"the {path} path left a kernel unlaunched: {counts}")
        took("phase 11 (trainer shell)")
        gc.collect()
        torch.cuda.empty_cache()
        dp_report, dp_rows, dp_launches, clis, fsdp_pair = dp_phase(smi, work, clis)
        if not all(dp_launches.values()):
            raise AssertionError(f"the training_dp path left a kernel unlaunched: {dp_launches}")
        took("phase 12 (data parallelism)")
        fsdp_report, fsdp_launches = fsdp_phase(smi, work, dp_report, shell["fit"]["save"],
                                                clis["fsdp"], fsdp_pair)
        if not all(fsdp_launches.values()):
            raise AssertionError(f"the training_fsdp path left a kernel unlaunched: "
                                 f"{fsdp_launches}")
        took("phase 13 (FSDP)")
        tp_report, tp_rows, tp_launches = tp_phase(smi, work, clis["tp"])
        if not all(tp_launches.values()):
            raise AssertionError(f"the training_tp path left a kernel unlaunched: {tp_launches}")
        took("phase 14 (tensor parallelism)")
        gc.collect()
        torch.cuda.empty_cache()
        pp_report, pp_rows, pp_launches = pp_phase(smi, work, clis["pp"])
        if not all(pp_launches.values()):
            raise AssertionError(f"the training_pp path left a kernel unlaunched: {pp_launches}")
        took("phase 15 (pipeline parallelism)")
        gc.collect()
        torch.cuda.empty_cache()
        sp_report, sp_rows, sp_ring_launches, sp_ulysses_launches = sp_phase(
            smi, work, clis["sp"])
        for path, counts in (("training_sp_ring", sp_ring_launches["past"]),
                             ("training_sp_ring_diagonal", sp_ring_launches["diagonal"]),
                             ("training_sp_ulysses", sp_ulysses_launches)):
            if not all(counts.values()):
                raise AssertionError(f"the {path} path left a kernel unlaunched: {counts}")
        took("phase 16 (sequence parallelism)")
        gc.collect()
        torch.cuda.empty_cache()
        moe_report, moe_rows, moe_launches = moe_phase(smi, work)
        if not all(moe_launches.values()):
            raise AssertionError(f"the training_moe_ep path left a kernel unlaunched: "
                                 f"{moe_launches}")
        took("phase 17 (mixture of experts)")
        gc.collect()
        torch.cuda.empty_cache()
        llama_report, llama_rows, llama_launches = llama_phase(smi, work, clis["llama"])
        for path, counts in llama_launches.items():
            if not all(counts.values()) and path != "inference":
                raise AssertionError(f"the llama {path} path left a kernel unlaunched: {counts}")
        if not llama_launches["inference"]["flash_fwd_launches"]:
            raise AssertionError("the llama inference path never launched flash_fwd")
        took("phase 18 (the Llama family)")
    finally:
        _kill_launched()
        shutil.rmtree(work, ignore_errors=True)

    # one row per kernel and main path, each at the shape that path gives it:
    # the forward at (a) for inference and at the training pass;
    # the backward, one pass for dq, dk and dv, at the training pass
    train_row = bwd_rows["t_train_pass"]
    kernels = {"kernels": [
        dict(name="flash_fwd", route="cuda", source="tpu_parallel_torch/csrc/flash_fwd.cu",
             replaces="tpu_parallel/ops/flash_attention.py:240", path=path,
             shape=kernel_rows[shape]["shape"], layout=kernel_rows[shape]["layout"], launches=n,
             max_abs_err=kernel_rows[shape]["max_abs_err"], ms=kernel_rows[shape]["ms"],
             plain_ms=kernel_rows[shape]["plain_ms"], bound_ms=kernel_rows[shape]["bound_ms"],
             bound_by=kernel_rows[shape]["bound_by"], library_ms=kernel_rows[shape]["library_ms"])
        for path, shape, n in (("inference", "a_main", inference_launches),
                               ("training", "t_train_pass", launches["flash_fwd_launches"]))
    ] + [
        dict(name="flash_bwd", route="cuda", source="tpu_parallel_torch/csrc/flash_bwd.cu",
             replaces="tpu_parallel/ops/flash_attention.py:464,563", path="training",
             shape=train_row["shape"], launches=launches["flash_bwd_launches"],
             max_abs_err=train_row["max_abs_err"], ms=train_row["ms"],
             plain_ms=train_row["plain_ms"], bound_ms=train_row["bound_ms"],
             bound_by=train_row["bound_by"], library_ms=train_row["library_ms"],
             library_covers="dq+dk+dv", ms_main_path_layout=train_row["main_path_layout"]["ms"])
    ] + [
        dict(name=f"flash_{kind}", route="cuda", source=f"tpu_parallel_torch/csrc/flash_{kind}.cu",
             replaces=replaces, path=path, shape=row["shape"],
             launches=shell_launches[path][f"flash_{kind}_launches"],
             max_abs_err=row["max_abs_err"], ms=row["ms"], plain_ms=row["plain_ms"],
             bound_ms=row["bound_ms"], bound_by=row["bound_by"], library_ms=row["library_ms"])
        for path, kind, row, replaces in (
            ("training_packed", "fwd", shell_rows["packed_fwd"],
             "tpu_parallel/ops/flash_attention.py:240"),
            ("training_packed", "bwd", shell_rows["packed_bwd"],
             "tpu_parallel/ops/flash_attention.py:464,563"),
            ("training_long", "fwd", shell_rows["long_fwd"],
             "tpu_parallel/ops/flash_attention.py:296"),
            ("training_long", "bwd", shell_rows["long_bwd"],
             "tpu_parallel/ops/flash_attention.py:512,635"))
    ] + [
        dict(name=f"flash_{kind}", route="cuda", source=f"tpu_parallel_torch/csrc/flash_{kind}.cu",
             replaces=replaces, path="training_dp", shape=row["shape"],
             launches=dp_launches[f"flash_{kind}_launches"], max_abs_err=row["max_abs_err"],
             ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
             bound_by=row["bound_by"], library_ms=row["library_ms"])
        for kind, row, replaces in (
            ("fwd", dp_rows["fwd"], "tpu_parallel/ops/flash_attention.py:240"),
            ("bwd", dp_rows["bwd"], "tpu_parallel/ops/flash_attention.py:464,563"))
    ] + [
        # phase 13 (a)'s step gives the kernels phase 12 (a)'s shape: its row
        dict(name=f"flash_{kind}", route="cuda", source=f"tpu_parallel_torch/csrc/flash_{kind}.cu",
             replaces=replaces, path="training_fsdp", shape=row["shape"],
             launches=fsdp_launches[f"flash_{kind}_launches"], max_abs_err=row["max_abs_err"],
             ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
             bound_by=row["bound_by"], library_ms=row["library_ms"])
        for kind, row, replaces in (
            ("fwd", dp_rows["fwd"], "tpu_parallel/ops/flash_attention.py:240"),
            ("bwd", dp_rows["bwd"], "tpu_parallel/ops/flash_attention.py:464,563"))
    ] + [
        # phase 14 (b)'s step on one rank: 6 local heads, views of its
        # [B, S, 6, 192] qkv buffer; launches are rank 0's
        dict(name=f"flash_{kind}", route="cuda", source=f"tpu_parallel_torch/csrc/flash_{kind}.cu",
             replaces=replaces, path="training_tp", shape=row["shape"],
             launches=tp_launches[f"flash_{kind}_launches"], max_abs_err=row["max_abs_err"],
             ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
             bound_by=row["bound_by"], library_ms=row["library_ms"])
        for kind, row, replaces in (
            ("fwd", tp_rows["fwd"], "tpu_parallel/ops/flash_attention.py:240"),
            ("bwd", tp_rows["bwd"], "tpu_parallel/ops/flash_attention.py:464,563"))
    ] + [
        # phase 15 (b)'s step on rank 0: GPT-2 350M's 16 heads of 64 on a
        # microbatch, views of its [B, S, 16, 192] qkv buffer
        dict(name=f"flash_{kind}", route="cuda", source=f"tpu_parallel_torch/csrc/flash_{kind}.cu",
             replaces=replaces, path="training_pp", shape=row["shape"],
             launches=pp_launches[f"flash_{kind}_launches"], max_abs_err=row["max_abs_err"],
             ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
             bound_by=row["bound_by"], library_ms=row["library_ms"])
        for kind, row, replaces in (
            ("fwd", pp_rows["fwd"], "tpu_parallel/ops/flash_attention.py:240"),
            ("bwd", pp_rows["bwd"], "tpu_parallel/ops/flash_attention.py:464,563"))
    ] + [
        # phase 16: the ring's chunks [1, 8192] x 12 heads (past chunks run
        # the full kernel, diagonal chunks the causal one: rank r runs the
        # diagonal and r past chunks per layer; each row's launches those of
        # its shape, summed over the four ranks of (b)), and Ulysses' inner
        # call [1, 32768] x 3 heads (rank 0's launches, as every rank's)
        dict(name=f"flash_{kind}", route="cuda", source=f"tpu_parallel_torch/csrc/flash_{kind}.cu",
             replaces=replaces, path=path, shape=sp_rows[f"{shape}_{kind}"]["shape"],
             launches=counts[f"flash_{kind}_launches"],
             max_abs_err=sp_rows[f"{shape}_{kind}"]["max_abs_err"],
             ms=sp_rows[f"{shape}_{kind}"]["ms"], plain_ms=sp_rows[f"{shape}_{kind}"]["plain_ms"],
             bound_ms=sp_rows[f"{shape}_{kind}"]["bound_ms"],
             bound_by=sp_rows[f"{shape}_{kind}"]["bound_by"],
             library_ms=sp_rows[f"{shape}_{kind}"]["library_ms"])
        for path, shape, counts in (("training_sp_ring", "ring_past", sp_ring_launches["past"]),
                                    ("training_sp_ring_diagonal", "ring_diag",
                                     sp_ring_launches["diagonal"]),
                                    ("training_sp_ulysses", "ulysses", sp_ulysses_launches))
        for kind, replaces in (
            ("fwd", "tpu_parallel/ops/flash_attention.py:296"),
            ("bwd", "tpu_parallel/ops/flash_attention.py:512,635"))
    ] + [
        # phase 17 (c)'s step on rank 0: 3 local heads of 64 (12 over the
        # model axis of 4), views of its [B, S, 3, 192] qkv buffer
        dict(name=f"flash_{kind}", route="cuda", source=f"tpu_parallel_torch/csrc/flash_{kind}.cu",
             replaces=replaces, path="training_moe_ep", shape=row["shape"],
             launches=moe_launches[f"flash_{kind}_launches"], max_abs_err=row["max_abs_err"],
             ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
             bound_by=row["bound_by"], library_ms=row["library_ms"])
        for kind, row, replaces in (
            ("fwd", moe_rows["fwd"], "tpu_parallel/ops/flash_attention.py:240"),
            ("bwd", moe_rows["bwd"], "tpu_parallel/ops/flash_attention.py:464,563"))
    ] + [
        # phase 18: llama_1b's 16 heads of 128 at [4, 2048] ((a)'s forward,
        # (b)'s minibatches; a forward-only row for (a)'s inference path) and
        # a 3-D rank's microbatch [1, 2048] x 8 heads ((c)'s rank 0)
        dict(name=f"flash_{kind}", route="cuda", source=f"tpu_parallel_torch/csrc/flash_{kind}.cu",
             replaces=replaces, path=path, shape=llama_rows[key]["shape"],
             launches=llama_launches[launches][f"flash_{kind}_launches"],
             max_abs_err=llama_rows[key]["max_abs_err"], ms=llama_rows[key]["ms"],
             plain_ms=llama_rows[key]["plain_ms"], bound_ms=llama_rows[key]["bound_ms"],
             bound_by=llama_rows[key]["bound_by"], library_ms=llama_rows[key]["library_ms"])
        for path, kind, key, launches, replaces in (
            ("llama_inference", "fwd", "fwd", "inference", "tpu_parallel/ops/flash_attention.py:240"),
            ("llama_training", "fwd", "fwd", "training", "tpu_parallel/ops/flash_attention.py:240"),
            ("llama_training", "bwd", "bwd", "training",
             "tpu_parallel/ops/flash_attention.py:464,563"),
            ("llama_3d", "fwd", "fwd3d", "ranks", "tpu_parallel/ops/flash_attention.py:240"),
            ("llama_3d", "bwd", "bwd3d", "ranks", "tpu_parallel/ops/flash_attention.py:464,563"))
    ]}
    summary = dict(card=smi, forward=fwd, generate=gen, train=train, serve=serve, kv=kv,
                   spec=spec, decode_extras=extras, trainer_shell=shell, data_parallel=dp_report,
                   fsdp=fsdp_report, tensor_parallel=tp_report,
                   tensor_parallel_kernel_shapes=tp_rows, pipeline_parallel=pp_report,
                   pipeline_parallel_kernel_shapes=pp_rows, sequence_parallel=sp_report,
                   sequence_parallel_kernel_shapes=sp_rows, mixture_of_experts=moe_report,
                   mixture_of_experts_kernel_shapes=moe_rows, llama=llama_report,
                   llama_kernel_shapes=llama_rows,
                   inference_flash_fwd_launches=inference_launches,
                   kernel_shapes=kernel_rows, bwd_kernel_shapes=bwd_rows,
                   trainer_shell_kernel_shapes=shell_rows, data_parallel_kernel_shapes=dp_rows)
    log("[summary] " + json.dumps(summary, sort_keys=True))
    log(f"card: {smi}")
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--leg"]:
        sys.exit(leg_main(sys.argv[2:]))
    sys.exit(main())
