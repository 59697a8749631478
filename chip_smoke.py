"""Drive the PyTorch / CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. Environment: the card (nvidia-smi name and power limit), torch and CUDA
   versions, nvcc and triton; build the thirteen CUDA sources from ``src/``
   and the ``mma.sync`` TF32 probe (``scripts/mma_tf32_probe.cu``) in
   parallel and print their build times and ``ptxas`` registers and
   spills per instantiation.  TF32 is switched off for fp32 matmuls and
   cuDNN.
2. The flash forward kernels against their plain PyTorch version: the
   reference suite's sweep, zigzag bands with split q_seg / k_seg, a
   negative scale, a kv_valid cut, packed documents with the K-tile skip
   on and off (at D 64 / 128, and as phase 3's band cases at D 16 / 32),
   the full-width prefill shape and a ragged full-width case (L=4000,
   kv_valid, packed documents); and at the head dims above 128 that the
   reference's configs use (192, 240, 288) and at head dim 320 (padded to
   384): causal with GQA group 2 on a ragged length, softcap 50, a window
   shorter than L, a zigzag band, a kv_valid cut, packed documents with
   the skip on and off, gemma2-2b's full training shape (B=2, L=4096, 8 /
   4 heads, D=288, causal, softcap 50) and the ragged case at its width
   (L=4000, kv_valid, packed documents); and the shapes the paths give
   the kernels at D 16 / 32 and 384 (phase 6's reduced qwen3-1.7b, B=1,
   L=1024, 4 / 2 heads, D 16; phase 8's timing shape, B=2, L=4096, 16 / 8
   heads, D 32; gemma2-2b's training shape at head dim 320 with softcap 50
   and without); each in fp32 and bf16.  Every case must hold the
   reference suite's elementwise tolerance (fp32 2e-5, bf16 2e-2), a
   norm-relative out error (fp32 2e-5, bf16 1e-2: one bf16 rounding step
   is at most 2^-7 relative) and lse within 1e-4 on the rows that see a
   key, and go through the route ``fwd_route`` picks: in bf16 the
   tensor-core kernels at every width (sm90n at D 16 / 32, sm90 at 64 /
   128, sm90w above), in fp32 the 3xTF32 tensor-core kernels, tf32x3 up
   to D 128 and tf32x3w above.
3. The dq and dk/dv kernels against their plain version on every case of
   the CPU parity suite (sweep and band cases), phase 2's band cases at
   D 64 / 128, phase 2's cases above D 128, the full-width training shapes
   of qwen3-1.7b and gemma2-2b and a ragged full-width case (L=4000,
   kv_valid, packed documents), fp32 and bf16: max error within atol 5e-4
   / rtol 1e-3 in fp32 (the reference suite's backward tolerance) and
   2e-2 in bf16, norm-relative error within 2e-5 / 1e-2.  Each kernel must
   go through the route ``bwd_route`` picks for it: above D 128 the sm90w
   tensor-core dq and dk/dv in bf16 (at D 384 their own source) and the
   3xTF32 tensor-core kernels of the tf32x3w route in fp32 (at every width
   above 128), at D 384 on every phase-2 case at head dim 320 and, in both
   dtypes, gemma2-2b's full training shape at head dim 320 with softcap 50
   and the ragged case at that width; the sm90 tensor-core kernels
   for bf16 at D in {64, 128}, the sm90n tensor-core kernels for bf16 at
   D in {16, 32}
   (every bf16 case of the sweep at D 16, 24, 32 and of the band cases,
   kv_valid and packed documents with the skip on and off, and, in bf16
   only, the shapes the paths give them: phase 6's reduced qwen3-1.7b,
   B=1, L=1024, 4 / 2 heads, D 16, causal, and phase 8's timing shape,
   B=2, L=4096, 16 / 8 heads, D 32, causal), the 3xTF32
   tensor-core kernels for fp32 up to D 128 (each fp32 operand split into
   a TF32 hi and lo, three TF32 products a product: about 21 of fp32's 24
   mantissa bits, so the fp32 tolerances stand).
4. Serving qwen3-1.7b at full width: random bf16 weights from a seed,
   greedy ``generate`` of 32 tokens for 2 prompts of 4096 tokens.  Prefill
   must launch the sm90 forward kernel once per layer (and no other
   forward and no backward kernel), the tokens must lie in the vocabulary, and
   the last-token logits must match a prefill on plain attention (cosine
   >= 0.999).
5. Serving timings with CUDA events (both forward routes at the
   full-width shape, the sm90 kernel in bf16 and the tf32x3 kernel in
   fp32, one call at a time and back to back, each beside its plain
   version, ``scaled_dot_product_attention`` in the same dtype (in fp32
   with ``enable_gqa`` and on repeated K/V) and its bound: 989 TFLOP/s in
   bf16, three TF32 passes at 495 in fp32, beside the ceiling the
   ``mma.sync`` TF32 probe reaches, measured here; prefill, a decode step)
   and ``torch.profiler`` over one prefill and one decode step.
6. The whole model at full width and depth 2, ``forward_loss`` and its
   backward on the kernels and on the dense oracle: qwen3-1.7b at B=1,
   L=4096, gemma2-2b (one local layer with its 4096 window, one global)
   at B=1, L=8192, so the window cuts, gemma2-2b at head dim 320 (padded
   to 384) at B=1, L=4096, and qwen3-1.7b's reduced config (head dim 16)
   at B=1, L=1024.  In fp32 (qwen3 and reduced: the tf32x3 forward, dq
   and dk/dv; gemma2 at both head dims: the tf32x3w forward, dq and dk/dv;
   2 launches each): loss within 1e-5 relative,
   every grad leaf within 1e-4
   norm-relative.  In bf16 (qwen3: the sm90 kernels; gemma2 at both head
   dims: the sm90w kernels; reduced: the sm90n kernels): loss within 1e-2
   of the bf16 oracle;
   every grad leaf within
   1e-2 of the bf16 oracle's, or, where the bf16 oracle itself lies
   further than that from the fp32 oracle, no further from it than that
   (all norm-relative to the fp32 oracle's leaf).
7. Training at full depth through ``launch/train.py``'s path
   (``Trainer``), 3 steps of 2 microbatches of 1 x 4096 tokens each:
   qwen3-1.7b, exactly 56 forward (scpp), 56 dq and 56 dk/dv launches a
   step, all on the sm90 route; then gemma2-2b, exactly 52 of each, all
   on the sm90w route.  Finite
   losses, step 0 within 1.5 of ln(vocab).
   Step time by CUDA events, tokens/s, MFU, peak memory; more steps timed,
   and ``torch.profiler`` over one step of each.
8. The backward kernels' times at qwen3-1.7b's training shape (the sm90
   kernels in bf16, the 3xTF32 kernels in fp32; the sm90n kernels, which
   serve bf16 at D 16 / 32, in bf16 at D=32 on phase 3's case of that
   shape) beside their bounds, the
   plain version and SDPA's backward in the same dtype (timed alone: one
   forward, then the median of 21 ``autograd.grad`` calls with
   ``retain_graph``, with its spread; in fp32 both with ``enable_gqa``
   and on repeated K/V), each kernel and SDPA also back to back (20 calls
   between two events, median of 5), which leaves out the host's time to
   launch a call.  The 3xTF32 rows carry two bounds (three TF32
   passes a product at 495 TFLOP/s, and 67 TFLOP/s of fp32 off the tensor
   cores) and the ceiling ``mma.sync`` TF32 reached in the probe.  Then
   the forward, dq and dk/dv at gemma2-2b's training shape on the routes
   they take there (bf16: sm90w; fp32: tf32x3w), beside their bounds (the
   dtype's rate: 989 TFLOP/s in bf16, three TF32 passes at 495 TFLOP/s in
   fp32; and 67 TFLOP/s of fp32 off the tensor cores),
   the plain version and SDPA in the same dtype on repeated K/V with the
   backend that ran named (SDPA has no softcap, so it computes the causal
   shape without one; the kernels are timed without the softcap too, the
   same function as SDPA's; every kernel and SDPA also back to back).
   Then the rows no training step runs: the bf16 forward at D 32 (the
   sm90n route) at qwen3-1.7b's shape, one call at a time and back to
   back, beside its tensor bound and the special-function unit's floor
   (one exp2 a score, 16 a clock an SM at the card's maximum SM clock);
   and at head dim 320 (padded 384) at gemma2-2b's shape the forward, dq
   and dk/dv, in bf16 (all sm90w) and in fp32 (all tf32x3w), with softcap
   50 and without, one call at a time
   and back to back, each beside its bounds, the plain version and SDPA
   (forward, and backward alone), also both ways.

9. 2D-Attention on eight ranks that share the card: the ranks are
   processes started here (``torch.multiprocessing``, a ``FileStore``
   rendezvous in a temp dir, one thread each) on the gloo backend, asked
   for by name, since NCCL will not put two ranks on one device; every
   collective stages through host memory.  The references run first, in
   this process on the card.  (a) The attention op at B=1, S=32768
   (4,096 tokens a rank): qwen3-1.7b's 16 / 8 heads at D 128, causal,
   zigzag, on (hp, outer, inner) = (2, 2, 2) head-first and
   context-first, and gemma2-2b's 8 / 4 heads at D 288 with softcap 50
   and window 4096 on (8, 1, 1), which repeats the KV heads (the sm90w /
   tf32x3w routes); fp32 and bf16; out and dq / dk / dv put together
   from the shards against one ``flash_attention`` call and its autograd
   grads, norm-relative within 2e-5 (fp32) / 1e-2 (bf16); each rank
   launches exactly ``n_out * w`` forwards, dq and dk/dv a call on the
   routes ``fwd_route`` / ``bwd_route`` pick, and nothing else.  (b)
   qwen3-1.7b at full width and depth 2, B=1, S=8192, on the (2, 2, 2)
   grid: ``forward_loss`` on each rank's shard and the grads summed over
   ranks against one process on the same params and global batch, fp32
   (loss 1e-5 relative, each leaf 1e-4 norm-relative) and bf16 (phase
   6's rule).  (c) ``launch/train.py``'s path (``make_trainer``: the
   grid from ``--hp 2 --inner 2``, ``build_plan``, ``Trainer``) for 2
   steps at depth 2, B=1, S=4096: finite losses, the same on every rank,
   step 0 within 1.5 of ln(vocab).  Per-rank times and peak memory are
   printed as what they are: gloo with host-staged collectives on one
   shared card.  This phase runs right after phase 1, while this process
   holds nothing on the card: the eight ranks of (c) need nearly all of
   its memory.
10. Hybrid ZeRO on four ranks that share the card (gloo by name,
   host-staged, as phase 9; run right after it), on (dp, hp, outer,
   inner) = (2, 1, 1, 2) head-first, B=2, S=4096, 3 trainer steps in
   (a) and (b), 1 in (b').
   (a) qwen3-1.7b at full width and depth 2 in fp32, lr 1e-2:
   ``zero="dp_sp"`` against ``zero="replica"`` on the same grid, losses
   within 1e-5 relative, the gathered params within 1e-5 on at least
   99.9% of each leaf and within 2e-3 on all, every rank's masters, m and
   v exactly ``1/extent`` of each leaf (a quarter of every large one).
   (b) qwen3-1.7b at full depth in bf16 under ``dp_sp``, with phase 7's
   seed, ``OptConfig`` and two sequences, the step gathering each layer
   at use: finite losses, the same on every rank, each and their fall
   over the steps within 2e-3 of phase 7's (checked once phase 7 has
   run); per-rank peak memory at most 12.0 GiB, beside ``plan_memory``'s
   estimate with the gap itemised, the card's total in use, and
   ``"auto"``'s choice at the rank's budget.  (b') One step at full depth
   under ``zero="auto"``: the mode it picks (``plan_memory``'s), and
   every rank's peak within its budget (its share of the card).  In all
   three, every rank launches exactly its ring's forward, dq and dk/dv a
   layer a step on the dtype's route.  (c) The pinned host <-> device
   copy rate of 1 GiB each way, median of 5 (``core/plan.py``'s two rate
   constants).  Per-rank times are gloo with host staging on one card,
   not NCCL figures.
11. Packed documents on one card.  (a) qwen3-1.7b at full width and
   depth 2, one ``PackedLM`` sequence of L=4096 (documents of mean 1024):
   ``forward_loss`` and its grads against the token-weighted sum of one
   unpacked run a document, fp32 (loss 1e-5 relative, each leaf 1e-4
   norm-relative, as phase 9 (b)) and bf16 (phase 6's rule), the packed
   run launching exactly 2 forward, dq and dk/dv on the dtype's route,
   each with the doc table.  (b) Full-depth training through
   ``launch/train.py``'s path with ``--pack`` (phase 7's shape, bf16):
   finite losses, step 0 within 1.5 of ln(vocab), every launch on the
   sm90 route; step ms, tokens/s and peak beside phase 7's.  (c) One call
   of each kernel at qwen3-1.7b's training shape on (b)'s first doc
   table with the K-tile skip, beside phase 8's causal times.  Runs after
   phase 8.
12. Checkpoints (``runtime/checkpoint.py``), under a temp directory that
   is deleted at the end.  (a) qwen3-1.7b at full width, depth 4, bf16,
   through ``launch/train.py``'s path at phase 7's shape: two
   uninterrupted 4-step runs (their distance is the tolerance), a run
   stopped after 2 steps with ``--ckpt-dir --save-every 2``, and a fresh
   trainer that resumes at step 2 and runs steps 2-3.  (b) Run inside
   phase 7 on its full-depth trainer, after the free disk is checked:
   one ``save_async``, its blocking stall (the pinned buffers'
   allocation apart from the copy) beside ``plan_memory``'s
   ``ckpt_stall_s`` and ``ckpt_bytes_host``, the write's GB/s, then the
   state zeroed and restored, bit for bit the snapshot, and the
   restore's seconds.  (c) Phase 10 (a)'s ``dp_sp`` run saves at step 2
   on its four ranks; one process on the card restores that checkpoint
   (shards over 1) and runs step 2, within 1e-5 of the ranks' loss.
   (d) SIGTERM to a ``launch/train.py`` process once it has logged step
   0: it exits 0 with one checkpoint at the next step boundary, and a
   relaunch resumes there and runs the rest.
13. The FPDT chunk pipeline (``chunked_attention_2d``, ``OffloadManager``)
   on one card at qwen3-1.7b's attention shape (B=1, 16 / 8 heads, D
   128, C=4), with and without a doc table whose documents straddle the
   chunk edges: (a) out, dq, dk and dv against the resident
   ``attention_2d`` with autograd, bf16 at S=32768 norm-relative 2e-2,
   fp32 at S=8192 at the kernel suite's tolerances; (b) exactly 10
   forward, 10 dq and 10 dk/dv launches a forward + vjp, on sm90 (bf16)
   and tf32x3 (fp32); (c) no stall, the peak device bytes within a
   budget of the double-buffer schedule's bytes (enforced), the bytes
   each way, forward + vjp ms beside the resident call's, and the
   manager's host -> device rate beside ``OFFLOAD_WIRE_BYTES_PER_S``.
   (d) Runs inside phase 9: its (2, 2, 2) head-first ranks run the
   chunked op (fp32, S=8192, C=2, documents across the chunk edge)
   against the resident one, within phase 9's fp32 bound.
14. The MoE family, qwen3-moe-30b-a3b (32 / 4 heads of head dim 64, 128
   experts, top-8, capacity factor 1.25), after phase 13.  (d) and (e)
   first, on four gloo ranks sharing the card (host-staged, as phase 10)
   on (dp, hp, outer, inner) = (1, 2, 1, 2), EP = 4 (32 experts a rank):
   (d) ``moe_apply`` at full width, B=1, S=4096, fp32 and bf16, against
   one process applying it to each rank's own token shard (y per shard,
   the aux as their mean, the router and expert grads as their sum; phase
   9's bounds); (e) two steps of the mesh trainer at depth 1 under
   ``dp_sp``: finite losses, the same on every rank, each rank's peak
   beside ``plan_memory``.  Then the sm90 trio at qwen3-moe's shape (B=2,
   L=4096, causal, bf16; phases 2 and 3 check it as ``moe-full``, the
   dk/dv kernel summing a group of 8) one call at a time and back to
   back, beside the plain version, SDPA with ``enable_gqa`` and the
   bounds.  (a) Depth 2 at full width, L=4096, on the kernels against the
   dense oracle by phase 6's rules (fp32 on tf32x3, bf16 on sm90), and
   the share of fp32's (token, k) routing choices that bf16 also makes.
   (b) ``launch/train.py --arch qwen3-moe-30b-a3b --layers 4`` at phase
   7's shape, bf16, scpp: 3 finite losses, step 0 within 1.5 of
   ln(vocab), exactly 8 forward, dq and dk/dv launches a step on sm90;
   step ms, tokens/s, MFU on the reference's active weights, peak memory
   and each layer's dropped share.  (c) Greedy fixed-batch serving at
   depth 4, bf16, 2 prompts of 4096 tokens, 32 generated: tokens in the
   vocab, 4 sm90 forward launches in the prefill; prefill ms and decode
   ms a step.
15. The SSM and hybrid families, falcon-mamba-7b (Mamba1) and zamba2-7b
   (Mamba2, and a shared block of 32 / 32 heads of head dim 112 padded
   to 128 on the contiguous layout), full width, after phase 14.  (e)
   first, on four gloo ranks sharing the card (host-staged) on (dp, hp,
   outer, inner) = (1, 2, 1, 2), four sequence ranks (which then run
   phases 16 (e) and 17 (e)): each Mamba layer
   at B=1, S=4096, fp32, against one process on the whole sequence (y and
   x's grad norm-relative 2e-5, each leaf's grad summed over the ranks
   1e-4).  (a) ``_mamba1_scan`` and ``_mamba2_scan`` at B=1, S=1024,
   fp32, against the recurrence one token at a time (y and the final
   state norm-relative 2e-5), with their ms.  The sm90 trio at zamba2's
   shape (B=1, L=4096, causal, bf16; phases 2 and 3 check it as
   ``zamba2-full`` in fp32 and bf16) timed as phase 14's, beside SDPA.
   zamba2 at depth 2 with the shared block after each layer, L=4096, on
   the kernels against the dense oracle by phase 6's rules (fp32 on
   tf32x3, bf16 on sm90).  (b) ``launch/train.py --arch falcon-mamba-7b
   --layers 4`` and (c) ``--arch zamba2-7b --layers 7`` at phase 7's
   shape, bf16, scpp: 3 finite losses, step 0 within 1.5 of ln(vocab),
   exactly the shared block's applications' forward, dq and dk/dv a step
   on sm90 (none for falcon-mamba); step ms, tokens/s, MFU on the matmul
   weights, peak memory and a profiled step.  (d) Greedy fixed-batch
   serving of both at full depth in bf16, 2 prompts of 4096 tokens, 32
   generated: tokens in the vocab, the shared block's 13 sm90 forwards in
   zamba2's prefill (none in falcon-mamba's); prefill ms, decode ms a
   step, peak memory; and 16 decode steps of known tokens after the
   prefill against a prefill of the 4112 tokens: the last logits' cosine
   at least 0.995 in bf16 at full depth, and in fp32 at the training
   depth within the reference's decode-test bounds (atol = rtol = 2e-3).
16. The encoder-decoder family, whisper-small (12 + 12 layers, 12 / 12
   heads of head dim 64, 1536 frames a sequence), and the last two dense
   configs, chameleon-34b (64 / 8 heads of 128) and gemma3-12b (16 / 8
   heads of 240, padded to 256, window 1024 on five layers of six), full
   width, after phase 15.  (e) run by phase 15 (e)'s four gloo ranks
   (host-staged) on (dp, hp, outer, inner) = (1, 2, 1, 2): whisper with
   one encoder and one decoder layer, fp32, B=1, S=4096 over 1536 frames
   (the encoder's non-causal ring on the contiguous frames, the cross
   K/V gathered over the sequence ranks), against one process (loss
   1e-5, each leaf's grad summed over the ranks 1e-4 norm-relative).  (a)
   The kernels at the new paths' shapes: whisper's encoder (1536 x 1536,
   non-causal), cross-attention (4096 x 1536, non-causal) and decoder
   (4096, causal), chameleon-34b's (GQA group 8 at D 128) and gemma3-12b's
   local (window 1024) and global layers, each in fp32 (tf32x3 /
   tf32x3w) and bf16 (sm90 / sm90w) against the plain version within
   phases 2 and 3's bounds, and in bf16 timed beside the plain version,
   SDPA and the bound of its visible pairs.  (b) whisper at depth 2 + 2,
   L=4096, on the kernels against the dense oracle by phase 6's rules (a
   self-attention key bias, whose true grad is zero, measured against its
   layer's key weight; in bf16 a leaf may also lie no further from the
   fp32 oracle than sqrt(2) times the bf16 oracle: two independent bf16
   roundings of one size, where the grads at init are rounding-dominated).  (c) ``launch/train.py`` at phase 7's shape,
   bf16, scpp: whisper-small at full depth, chameleon-34b ``--layers 2``
   and gemma3-12b ``--layers 6`` (one whole 5:1 pattern): 3 finite
   losses, step 0 within 1e-2 of the same step on the dense oracle (at
   random init gemma3's tied, scaled embedding puts it far above
   ln(vocab)), exactly one forward, dq and
   dk/dv an attention call a step on the route (sm90; sm90w for gemma3);
   step ms, tokens/s, MFU, peak memory and a profiled step.  (d) Greedy
   fixed-batch serving of whisper at full depth in bf16, 2 prompts of
   4096 tokens over 1536 frames, 32 generated: tokens in the vocab, 36
   sm90 forwards in the prefill; prefill ms, decode ms a step, peak
   memory, and 16 decode steps against a prefill of 4112 tokens (cosine
   at least 0.995 in bf16, and in fp32 within atol = rtol = 2e-3).
17. MLA, deepseek-v2-lite-16b (16 heads: q / k of d_qk 192, V of d_v 128
   zero-padded to 192, one shared rope key head; 64 experts top-6 and
   two shared), full width, after phase 16.  (e) run by phase 15 (e)'s
   four gloo ranks on (dp, hp, outer, inner) = (1, 2, 1, 2): the reduced
   model in fp32 (aux weight 0), B=1, S=4096, against one process (loss
   1e-5, each leaf's grad summed over the ranks 1e-4 norm-relative).  (a)
   The trio at MLA's training shape (B=1, L=4096, a GQA group of 1,
   causal, scale 1/sqrt(192)) in fp32 (tf32x3w) and bf16 (sm90w) against
   the plain version within phases 2 and 3's bounds, and in bf16 timed one
   call at a time beside the plain version, SDPA on the unpadded V and the
   bound of the products at their true widths (QK^T and dK at 192, PV, dP
   and dV at 128), with the FLOPs the kernels issue at 192 (phase 16's
   walk of a shape table, one entry).  (b) Depth 2, L=4096, on the
   kernels against the dense oracle by phase 6's rules (fp32 on tf32x3w,
   bf16 on sm90w).  (c)
   ``launch/train.py --arch deepseek-v2-lite-16b --layers 4`` at phase 7's
   shape, bf16, scpp: 3 finite losses, step 0 within 1e-2 of the dense
   oracle's, exactly 8 forward, dq and dk/dv launches a step on sm90w;
   step ms, tokens/s, MFU (MLA's own weights from
   ``convert.ref_param_shapes``, attention at the true widths; the padded
   work the kernels issue on its own line), peak memory and a profiled
   step.  (d) Greedy fixed-batch serving at full depth (27 layers) in
   bf16, 2 prompts of 4096 tokens, 32 generated: tokens in the vocab, 27
   sm90w forwards in the prefill and none in the absorbed decode; prefill
   ms, decode ms a step, peak memory, the prefill's dropped share of the
   MoE assignments at capacity factor 1.25; and, with a capacity that
   drops nothing (a prefill drops assignments past an expert's capacity,
   a one-token decode step never does), 16 absorbed decode steps against
   a prefill of 4112 tokens (cosine at least 0.995 in bf16, and at depth 4
   in fp32 within atol = rtol = 2e-3).
18. Serving, after phase 17.  (a) qwen3-1.7b at full width and depth,
   bf16 (phase 4's weights), through the paged engine
   (``serve/engine.py``, ``serve_spec`` from the plan): after ``warmup``,
   8 requests (phase 4's two 4096-token prompts and six of lengths drawn
   from seed 18 in 256-4096), 32 tokens each, 4 slots, pages of 16,
   prefill chunks of 512: exact token counts, the pool free at the end,
   exactly one sm90 forward a layer a prefill chunk and no backward, the
   first token's logits of phase 4's prompts within cosine 0.999 of its
   ``generate``; tokens/s, TTFT p50 / p99, ms a decode tick at 4 slots
   (CUDA events), peak memory.  The sm90 forward at the engine's chunk
   shape (B=1, Lq 512, Lk 4096, causal at mask_offset 3584) against its
   plain version at phase 2's bounds (``check_kernel``), timed beside SDPA
   and its bound.  (b) qwen3-1.7b,
   gemma2-2b and deepseek-v2-lite at full width, depth 2, fp32 (MoE
   routing every assignment): the engine's greedy tokens against
   ``generate``'s on two 1024-token prompts; where they part, the step's
   two top logits lie within 1e-4.  (c) Run by phase 15 (e)'s four ranks
   (gloo, host-staged, not NCCL figures): qwen3-1.7b on (dp, hp, outer,
   inner) = (1, 2, 2, 1) and deepseek-v2-lite on (1, 4, 1, 1), full width,
   depth 2, fp32 and bf16: prefill of 2 x 4096 over the contiguous ring
   and 8 decode steps against one process on the card fed the same tokens
   (fp32 within 1e-3, bf16 cosine at least 0.999), every rank's prefill
   launching exactly its ring's forwards on the dtype's route and decode
   none; per-rank ms.

Each phase prints its seconds, and the script its total.  The kernels'
record carries, for the sm90 and tf32x3 kernels, their launches in one
chunk-pipeline forward + vjp (phase 13 (b)) and their launches on
qwen3-moe's and zamba2's paths, and for the sm90 trio its times at
qwen3-moe's and zamba2's shapes (phases 14 and 15); the sm90 and sm90w
kernels their times at phase 16's shapes and their launches in its
training steps; the sm90w kernels their times at MLA's shape and their
launches in phase 17's training step and prefill, the tf32x3w kernels
their launches in phase 17 (b)'s fp32 run; the sm90 forward its launches
in phase 18 (a)'s engine stream and its times at the chunk shape, and
each forward route its launches a rank in phase 18 (c)'s mesh prefill.
The last two lines are the
kernels' JSON record and ``{"ok": true, "device": {...}}``.  Without a
CUDA device, or without the repository's ``src/`` beside it, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import functools
import gc
import importlib.util
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
REL_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}   # ||d|| / ||plain||
LSE_TOL = 1e-4
PEAK_BF16_FLOPS = 989e12        # H100 SXM dense bf16 tensor-core rate
PEAK_TF32_FLOPS = 495e12        # H100 SXM dense TF32 tensor-core rate
PEAK_FP32_FLOPS = 67e12         # H100 SXM fp32 outside the tensor cores
PEAK_BYTES = 3.35e12            # H100 SXM HBM3
ARCH = "qwen3-1.7b"
# The CUDA sources phase 1 builds, one nvcc each, in parallel.
SOURCES = ["flash_fwd_tf32x3", "flash_fwd_sm90", "flash_fwd_sm90_narrow",
           "flash_fwd_sm90_wide", "flash_fwd_sm90_d384",
           "flash_fwd_tf32x3_wide", "flash_bwd_sm90", "flash_bwd_sm90_narrow",
           "flash_dq_sm90_wide", "flash_dkv_sm90_wide", "flash_bwd_sm90_d384",
           "flash_bwd_tf32x3", "flash_bwd_tf32x3_wide"]
GEMMA = "gemma2-2b"
# gemma2-2b at head dim 320 (padded to 384), the one path of phase 6 that
# runs the bf16 kernels at D 384 (sm90w, the forward's and the backward's
# own sources).
GEMMA320 = "gemma2-2b-hd320"
# qwen3-1.7b's reduced config (2 layers, 4 / 2 heads of head dim 16), the
# one path of phase 6 that runs the narrow kernels (sm90n) in bf16.
REDUCED, REDUCED_L = "qwen3-1.7b-smoke", 1024
REDUCED_HQ, REDUCED_HKV, REDUCED_D = 4, 2, 16
BATCH, PROMPT, GEN = 2, 4096, 32
GEMMA_L = 8192                  # phase 6: twice gemma2-2b's 4096 window
# Phase 14: qwen3-moe-30b-a3b at full width (32 / 4 heads of head dim 64,
# a GQA group of 8; 128 experts, top-8), depth 4 on one card.
MOE = "qwen3-moe-30b-a3b"
MOE_HQ, MOE_HKV, MOE_D = 32, 4, 64
MOE_LAYERS = 4
# Phase 15: the SSM family (falcon-mamba-7b, Mamba1) and the hybrid
# (zamba2-7b: Mamba2 and a shared attention block of 32 / 32 heads of head
# dim 112, padded to 128, on the contiguous layout), full width; training
# cut in depth to fit one card.
FALCON, ZAMBA = "falcon-mamba-7b", "zamba2-7b"
FALCON_LAYERS, ZAMBA_LAYERS = 4, 7
ZAMBA_HQ, ZAMBA_D = 32, 112
# Phase 16: whisper-small (encoder-decoder, 12 / 12 heads of head dim 64,
# 1536 encoder frames a sequence: 1500 padded), full depth; chameleon-34b
# (64 / 8 heads of 128) and gemma3-12b (16 / 8 heads of 240, padded to
# 256; window 1024 on five layers of six) at full width, cut in depth.
WHISPER, CHAMELEON, GEMMA3 = "whisper-small", "chameleon-34b", "gemma3-12b"
CHAMELEON_LAYERS, GEMMA3_LAYERS = 2, 6
WHISPER_F = 1536
# Phase 17: deepseek-v2-lite-16b (MLA: 16 heads, q / k of d_qk 192, V of
# d_v 128 zero-padded to 192, one shared rope key head, so the kernels run
# at a GQA group of 1; 64 experts top-6 and two shared), full width;
# training cut to depth 4 (about 16 bytes of state a parameter: 44 GB),
# serving at full depth (16.2 B parameters, 32.4 GB in bf16).
DEEPSEEK = "deepseek-v2-lite-16b"
DEEPSEEK_LAYERS = 4
MLA_HQ, MLA_DQK, MLA_DV = 16, 192, 128

SWEEP = [
    # b, lq, lk, hq, hkv, d, causal, window, softcap (tests/test_kernels.py)
    (2, 64, 64, 4, 4, 32, True, None, 0.0),
    (1, 48, 80, 4, 2, 24, True, None, 0.0),
    (1, 33, 100, 6, 3, 40, True, None, 0.0),
    (2, 16, 96, 4, 4, 32, True, None, 0.0),
    (1, 32, 32, 2, 2, 16, False, None, 30.0),
    (2, 64, 64, 4, 1, 32, True, 16, 0.0),
    (1, 64, 64, 8, 2, 64, True, 8, 25.0),
    (1, 128, 128, 2, 2, 128, True, None, 0.0),
]


def check(ok: bool, msg: str):
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def ptxas_summary(log: str):
    """(instantiation, registers, spill-store bytes) from ``ptxas -v``."""
    out, name, spills = [], None, 0
    for line in log.splitlines():
        m = re.search(r"(flash_[a-z]+_kernel)I(\w+?)Li(\d+)ELi(\d+)E", line)
        m90 = re.search(r"(flash_[a-z]+_(sm90[wn]?|tf32x3w?)_kernel)ILi(\d+)E",
                        line)
        if "Compiling entry function" in line and m:
            dtype = "bf16" if "bfloat16" in m.group(2) else "fp32"
            name = (f"{m.group(1)}<{dtype}, D={m.group(3)}, "
                    f"tile={m.group(4)}>")
        elif "Compiling entry function" in line and m90:
            dtype = "fp32" if m90.group(2).startswith("tf32x3") else "bf16"
            tile = 32 if m90.group(2) == "tf32x3w" else 64
            name = f"{m90.group(1)}<{dtype}, D={m90.group(3)}, tile={tile}>"
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spills = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1)), spills))
            name = None
    return out


def cuda_times(fn, reps: int = 7, warmup: int = 2) -> list:
    """Milliseconds of ``reps`` calls of ``fn()`` on the current stream,
    each between two CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times


def cuda_ms(fn, reps: int = 7, warmup: int = 2) -> float:
    """Median milliseconds of ``fn()`` on the current stream."""
    return statistics.median(cuda_times(fn, reps, warmup))


def cuda_loop_times(fn, calls: int = 20, reps: int = 5,
                    warmup: int = 3) -> list:
    """Milliseconds a call of ``fn()``: ``reps`` timings of ``calls`` calls
    back to back between two CUDA events, each divided by ``calls``.  The
    host stays ahead of the card, so its time to launch a call, which
    ``cuda_times`` counts, is not counted."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return times


FLASH_NAME = re.compile(r"flash_\w+_kernel")


def profile_call(fn, top: int = 5):
    """Run ``fn`` once under ``torch.profiler``; returns (summary, result).
    The summary gives the host wall time under the profiler, the summed
    device time of the CUDA kernels (their busy share of that wall time),
    the kernels that took the most device time and every flash kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms == 0.0:
        return (f"wall {wall_ms:.1f} ms; device time not measured (the "
                "profiler recorded no CUDA kernel)"), result
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    tops = ", ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.2f} ms"
                     f" x{e.count}" for e in kernels[:top])
    launches = sum(e.count for e in kernels)
    flash = ", ".join(
        f"{FLASH_NAME.search(e.key).group(0)} "
        f"{e.self_device_time_total / 1e3:.2f} ms x{e.count}"
        for e in kernels if FLASH_NAME.search(e.key))
    summary = (f"wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
               f"({100 * busy_ms / wall_ms:.1f}%, idle "
               f"{100 - 100 * busy_ms / wall_ms:.1f}%), {launches} kernel "
               f"launches; top: {tops}; flash kernels: {flash or 'none'}")
    return summary, result


# ---------------------------------------------------------------------------
# Phase 2: kernel against its plain version
# ---------------------------------------------------------------------------

def kernel_cases(gen: torch.Generator):
    """(name, q, k, v, keyword arguments) on the card."""
    from repro_torch.kernels.ref import BandMask

    def rand(*shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        tag = "fp32" if dtype == torch.float32 else "bf16"
        for i, (b, lq, lk, hq, hkv, d, causal, window, cap) in \
                enumerate(SWEEP):
            cases.append((f"sweep{i}-{tag}", rand(b, lq, hq, d, dtype=dtype),
                          rand(b, lk, hkv, d, dtype=dtype),
                          rand(b, lk, hkv, d, dtype=dtype),
                          dict(causal=causal, window=window, softcap=cap)))
        for i, j in ((1, 2), (2, 2), (3, 0)):
            cases.append((f"zigzag{i}{j}-{tag}", rand(1, 256, 8, 64,
                                                       dtype=dtype),
                          rand(1, 256, 4, 64, dtype=dtype),
                          rand(1, 256, 4, 64, dtype=dtype),
                          dict(causal=True,
                               band=BandMask.zigzag(i, j, 128, 4))))
        cases.append((f"neg_scale-{tag}", rand(1, 96, 4, 64, dtype=dtype),
                      rand(1, 160, 2, 64, dtype=dtype),
                      rand(1, 160, 2, 64, dtype=dtype),
                      dict(causal=True, scale=-0.2)))
        cases.append((f"kv_valid-{tag}", rand(2, 200, 8, 128, dtype=dtype),
                      rand(2, 448, 4, 128, dtype=dtype),
                      rand(2, 448, 4, 128, dtype=dtype),
                      dict(causal=True, kv_valid_len=301)))
        doc = torch.tensor(np.repeat([0, 100, 230, 400], [100, 130, 170, 112]),
                           dtype=torch.int32, device="cuda")[None].repeat(2, 1)
        for skip in (True, False):
            cases.append((f"doc_skip{int(skip)}-{tag}",
                          rand(2, 512, 8, 64, dtype=dtype),
                          rand(2, 512, 4, 64, dtype=dtype),
                          rand(2, 512, 4, 64, dtype=dtype),
                          dict(causal=True, q_doc_start=doc, doc_skip=skip)))
        for name, (b, lq, lk, hq, hkv, d), kw in [
                *((name, shape[:6], on_card(shape[6]))
                  for name, shape in EXTRA.items()),
                *above_128_shapes()]:
            cases.append((f"{name}-{tag}", rand(b, lq, hq, d, dtype=dtype),
                          rand(b, lk, hkv, d, dtype=dtype),
                          rand(b, lk, hkv, d, dtype=dtype), kw))
    # The shapes the paths give the forward at D 16 / 32 (phase 6's reduced
    # qwen3-1.7b, phase 8's timing shape at D 32: bf16's sm90n, fp32's
    # tf32x3) and at D 384 (gemma2-2b's training shape at head dim 320, with
    # its softcap and without: bf16's sm90w, fp32's tf32x3w), in both dtypes.
    for dtype, tag in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        for name, (b, lq, lk, hq, hkv, d), kw in (
                *narrow_full_shapes(),
                ("gemma2-d320-full", (BATCH, PROMPT, PROMPT, GEMMA_HQ,
                                      GEMMA_HKV, 320),
                 dict(causal=True, softcap=GEMMA_CAP)),
                ("gemma2-d320-nocap-full", (BATCH, PROMPT, PROMPT, GEMMA_HQ,
                                            GEMMA_HKV, 320),
                 dict(causal=True))):
            cases.append((f"{name}-{tag}", rand(b, lq, hq, d, dtype=dtype),
                          rand(b, lk, hkv, d, dtype=dtype),
                          rand(b, lk, hkv, d, dtype=dtype), kw))
    b, h, hkv, d = BATCH, 16, 8, 128
    ragged_doc = torch.as_tensor(RAGGED_DOC[None], dtype=torch.int32,
                                 device="cuda")
    for dtype, tag in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        cases.append((f"prefill-full-{tag}",
                      rand(b, PROMPT, h, d, dtype=dtype),
                      rand(b, PROMPT, hkv, d, dtype=dtype),
                      rand(b, PROMPT, hkv, d, dtype=dtype),
                      dict(causal=True)))
        cases.append((f"ragged-full-{tag}",
                      rand(1, RAGGED_L, h, d, dtype=dtype),
                      rand(1, RAGGED_L, hkv, d, dtype=dtype),
                      rand(1, RAGGED_L, hkv, d, dtype=dtype),
                      dict(causal=True, kv_valid_len=RAGGED_KV,
                           q_doc_start=ragged_doc)))
        # qwen3-moe-30b-a3b's prefill and training shape: D 64, group 8.
        cases.append((f"moe-full-{tag}",
                      rand(BATCH, PROMPT, MOE_HQ, MOE_D, dtype=dtype),
                      rand(BATCH, PROMPT, MOE_HKV, MOE_D, dtype=dtype),
                      rand(BATCH, PROMPT, MOE_HKV, MOE_D, dtype=dtype),
                      dict(causal=True)))
        # zamba2-7b's shared block in a training microbatch: head dim 112
        # (padded to 128), no GQA, causal on the contiguous layout.
        cases.append((f"zamba2-full-{tag}",
                      rand(1, PROMPT, ZAMBA_HQ, ZAMBA_D, dtype=dtype),
                      rand(1, PROMPT, ZAMBA_HQ, ZAMBA_D, dtype=dtype),
                      rand(1, PROMPT, ZAMBA_HQ, ZAMBA_D, dtype=dtype),
                      dict(causal=True)))
    return cases


def check_kernel(name, q, k, v, kw):
    """Kernel and plain version on the same folded operands, through the
    route ``fwd_route`` picks; returns the route, the max |out error|, the
    max |lse error| on visible rows and the folded call for timing."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ops import NEG_INF, _fold_chunk_args

    d = q.shape[3]
    qf, kf, vf, p, band, doc = _fold_chunk_args(q, k, v, **kw)
    route = fa.fwd_route(qf.dtype, qf.shape[2])
    n0 = launch_counts()
    out_k, lse_k = fa._fwd(qf, kf, vf, p, band=band, doc=doc)
    torch.cuda.synchronize()
    moved = launches_since(n0)
    check(moved == expected_launches(1, 0, {"fwd": route}),
          f"{name} launched {moved}, expected one forward launch on the "
          f"{route} route")
    out_p, lse_p = fa._fwd_plain(qf, kf, vf, p, band=band, doc=doc)
    ok_, op_ = out_k[..., :d].float(), out_p[..., :d].float()
    tol = TOL[q.dtype]
    err = float((ok_ - op_).abs().max())
    rel = float((ok_ - op_).norm() / op_.norm().clamp_min(1e-30))
    close = torch.allclose(ok_, op_, atol=tol, rtol=tol)
    seen = lse_p > NEG_INF / 2
    same_rows = bool(((lse_k > NEG_INF / 2) == seen).all())
    lse_err = float(torch.where(seen, lse_k - lse_p, 0.0).abs().max())
    good = (close and rel <= REL_TOL[q.dtype] and same_rows
            and lse_err <= LSE_TOL and bool(torch.isfinite(ok_).all()))
    print(f"  {name:22s} {route:4s} out max|err| {err:.3e} (tol {tol:g})  "
          f"||err||/||out|| {rel:.3e} (tol {REL_TOL[q.dtype]:g})  "
          f"lse max|err| {lse_err:.3e} (tol {LSE_TOL:g})  "
          f"{'ok' if good else 'FAIL'}")
    check(good, f"kernel disagrees with its plain version on {name}")
    del out_p, lse_p
    return route, err, lse_err, (qf, kf, vf, p, band, doc)


# ---------------------------------------------------------------------------
# Phase 3: the backward kernels against their plain version
# ---------------------------------------------------------------------------

# The band cases of tests/_torch_parity.py: name -> (b, lq, lk, hq, hkv, d,
# keyword arguments); ``band`` is (i, j, chunk, cp) of a zigzag ring step.
_DOC = np.repeat(np.array([0, 20, 52]), [20, 32, 28])[None].repeat(2, 0)
EXTRA = {
    "zigzag": (1, 16, 16, 4, 2, 16, dict(causal=True, band=(1, 2, 8, 4))),
    "zigzag_diag": (1, 16, 16, 4, 2, 16,
                    dict(causal=True, window=6, band=(2, 2, 8, 4))),
    "kv_valid": (2, 40, 64, 4, 2, 32, dict(causal=True, kv_valid_len=41)),
    "doc_skip": (2, 80, 80, 4, 2, 32,
                 dict(causal=True, q_doc_start=_DOC, doc_skip=True)),
    "doc_noskip": (2, 80, 80, 4, 2, 32,
                   dict(causal=True, q_doc_start=_DOC, doc_skip=False)),
}
# The reference suite's backward tolerance (tests/test_kernels.py:65) in
# fp32, its bf16 tolerance in bf16; and the norm-relative bound.
BWD_TOL = {torch.float32: (5e-4, 1e-3), torch.bfloat16: (2e-2, 2e-2)}
BWD_REL_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}
TRAIN_HQ, TRAIN_HKV, TRAIN_D = 16, 8, 128
# (route, kernel) of every backward kernel phase 3 must run.
# The sm90w pair at D 384 (its own source) apart as "sm90w384".
BWD_KERNELS = (("sm90", "dq"), ("sm90", "dkv"), ("tf32x3", "dq"),
               ("tf32x3", "dkv"), ("sm90n", "dq"), ("sm90n", "dkv"),
               ("sm90w", "dq"), ("sm90w", "dkv"), ("sm90w384", "dq"),
               ("sm90w384", "dkv"), ("tf32x3w", "dq"), ("tf32x3w", "dkv"))
# Phase 2's band cases at their widths (D 64 and 128, so bf16 takes the
# sm90 route): zigzag ring steps (i, j) of cp=4 over chunks of 128, a
# kv_valid cut, packed documents with the K-tile skip on and off.
_BAND_DOC = np.repeat([0, 100, 230, 400], [100, 130, 170, 112])[None]
BANDS = {
    **{f"zigzag{i}{j}-band": (1, 256, 256, 8, 4, 64,
                              dict(causal=True, band=(i, j, 128, 4)))
       for i, j in ((1, 2), (2, 2), (3, 0))},
    "kv_valid-band": (2, 200, 448, 8, 4, 128,
                      dict(causal=True, kv_valid_len=301)),
    **{f"doc_skip{int(skip)}-band": (2, 512, 512, 8, 4, 64,
                                     dict(causal=True,
                                          q_doc_start=_BAND_DOC.repeat(2, 0),
                                          doc_skip=skip))
       for skip in (True, False)},
}
# The cases above D 128 (phases 2 and 3), at each width the
# reference's configs use (deepseek-v2-lite MLA's 192, gemma3-12b's 240,
# gemma2-2b's 288): name -> (b, lq, lk, hq, hkv, keyword arguments), GQA
# group 2 throughout, ragged lengths; ``band`` as in ``BANDS``.
ABOVE_128_D = (192, 240, 288)
ABOVE_128 = {
    "causal": (2, 200, 200, 8, 4, dict(causal=True)),
    "softcap": (1, 256, 256, 8, 4, dict(causal=True, softcap=50.0)),
    "window": (1, 320, 320, 4, 2, dict(causal=True, window=100,
                                       softcap=50.0)),
    "zigzag": (1, 256, 256, 8, 4, dict(causal=True, band=(1, 2, 128, 4))),
    "kv_valid": (2, 200, 448, 8, 4, dict(causal=True, kv_valid_len=301)),
    **{f"doc_skip{int(skip)}": (2, 512, 512, 4, 2,
                                dict(causal=True,
                                     q_doc_start=_BAND_DOC.repeat(2, 0),
                                     doc_skip=skip))
       for skip in (True, False)},
}
# The cases of ``ABOVE_128`` that also run at head dim 320, which pads to
# 384: all of them.  There bf16's three kernels take the sm90w route, and
# fp32's forward the wide one and its dq and dk/dv the tf32x3w one.
AT_384 = tuple(ABOVE_128)
# gemma2-2b's training shape (B, L, Hq, Hkv, D; causal, softcap 50).
GEMMA_HQ, GEMMA_HKV, GEMMA_D, GEMMA_CAP = 8, 4, 288, 50.0


def on_card(kw: dict) -> dict:
    """A case's keyword arguments with its band as a ``BandMask`` and its
    doc table on the card."""
    from repro_torch.kernels.ref import BandMask

    kw = dict(kw)
    if "band" in kw:
        kw["band"] = BandMask.zigzag(*kw["band"])
    if "q_doc_start" in kw:
        kw["q_doc_start"] = torch.as_tensor(kw["q_doc_start"],
                                            dtype=torch.int32, device="cuda")
    return kw


def above_128_shapes():
    """(name, (b, lq, lk, hq, hkv, d), keyword arguments) of the cases
    above D 128 and at head dim 320, then gemma2-2b's full training shape
    (``gemma2-full``) and the ragged full-width case at its width
    (``gemma2-ragged``)."""
    out = [(f"{name}-d{d}", (b, lq, lk, hq, hkv, d), on_card(kw))
           for d in ABOVE_128_D
           for name, (b, lq, lk, hq, hkv, kw) in ABOVE_128.items()]
    out += [(f"{name}-d320", (*ABOVE_128[name][:5], 320),
             on_card(ABOVE_128[name][5])) for name in AT_384]
    out.append(("gemma2-full", (BATCH, PROMPT, PROMPT, GEMMA_HQ, GEMMA_HKV,
                                GEMMA_D),
                dict(causal=True, softcap=GEMMA_CAP)))
    out.append(("gemma2-ragged", (1, RAGGED_L, RAGGED_L, GEMMA_HQ, GEMMA_HKV,
                                  GEMMA_D),
                on_card(dict(causal=True, softcap=GEMMA_CAP,
                             kv_valid_len=RAGGED_KV,
                             q_doc_start=RAGGED_DOC[None]))))
    return out
# The ragged full-width case: L=4000 (not a multiple of any tile), keys cut
# at 3900, four packed documents.
RAGGED_L, RAGGED_KV = 4000, 3900
RAGGED_DOC = np.repeat([0, 1111, 2345, 3500], [1111, 1234, 1155, 500])


def narrow_full_shapes():
    """(name, (b, lq, lk, hq, hkv, d), keyword arguments) of the sm90n
    kernels' shapes on the paths: phase 6's reduced qwen3-1.7b
    (``reduced-full``) and phase 8's timing shape at D 32
    (``train-d32-full``), both causal."""
    return [("reduced-full", (1, REDUCED_L, REDUCED_L, REDUCED_HQ,
                              REDUCED_HKV, REDUCED_D), dict(causal=True)),
            ("train-d32-full", (BATCH, PROMPT, PROMPT, TRAIN_HQ, TRAIN_HKV,
                                32), dict(causal=True))]


def d384_full_shapes():
    """(name, (b, lq, lk, hq, hkv, d), keyword arguments) of the
    backward's shapes at head dim 320 (padded to 384: in bf16 the sm90w
    pair's own source, in fp32 the tf32x3w pair's D 384 instantiation, as
    phase 6's fp32 run at that width drives it): gemma2-2b's training shape
    with its softcap
    (``gemma2-d320-full``) and the ragged case at that width
    (``gemma2-d320-ragged``: L=4000, kv_valid, packed documents)."""
    return [("gemma2-d320-full", (BATCH, PROMPT, PROMPT, GEMMA_HQ, GEMMA_HKV,
                                  320), dict(causal=True, softcap=GEMMA_CAP)),
            ("gemma2-d320-ragged", (1, RAGGED_L, RAGGED_L, GEMMA_HQ,
                                    GEMMA_HKV, 320),
             on_card(dict(causal=True, softcap=GEMMA_CAP,
                          kv_valid_len=RAGGED_KV,
                          q_doc_start=RAGGED_DOC[None])))]


def bwd_cases(gen: torch.Generator):
    """(name, q, k, v, do, keyword arguments) on the card: the CPU parity
    suite's sweep and band cases, the band cases at phase 2's widths, the
    cases above D 128 and gemma2-2b's training shape, then qwen3-1.7b's
    full-width training shape and the ragged full-width case, the D 384
    pair's shapes at head dim 320 (``d384_full_shapes``); in bf16 last the
    sm90n kernels' shapes on the paths (``reduced-full``,
    ``train-d32-full``)."""
    def rand(*shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        tag = "fp32" if dtype == torch.float32 else "bf16"
        shapes = [(f"sweep{i}", (b, lq, lk, hq, hkv, d),
                   dict(causal=causal, window=window, softcap=cap))
                  for i, (b, lq, lk, hq, hkv, d, causal, window, cap)
                  in enumerate(SWEEP)]
        for name, (b, lq, lk, hq, hkv, d, kw) in {**EXTRA, **BANDS}.items():
            shapes.append((name, (b, lq, lk, hq, hkv, d), on_card(kw)))
        shapes.extend(above_128_shapes())
        shapes.append(("train-full", (BATCH, PROMPT, PROMPT, TRAIN_HQ,
                                      TRAIN_HKV, TRAIN_D), dict(causal=True)))
        # qwen3-moe-30b-a3b's training shape: dk/dv sums a group of 8.
        shapes.append(("moe-full", (BATCH, PROMPT, PROMPT, MOE_HQ, MOE_HKV,
                                    MOE_D), dict(causal=True)))
        # zamba2-7b's shared block in a training microbatch (head dim 112).
        shapes.append(("zamba2-full", (1, PROMPT, PROMPT, ZAMBA_HQ, ZAMBA_HQ,
                                       ZAMBA_D), dict(causal=True)))
        shapes.append(("train-ragged", (1, RAGGED_L, RAGGED_L, TRAIN_HQ,
                                        TRAIN_HKV, TRAIN_D),
                       dict(causal=True, kv_valid_len=RAGGED_KV,
                            q_doc_start=torch.as_tensor(
                                RAGGED_DOC[None], dtype=torch.int32,
                                device="cuda"))))
        # The pair at D 384 (bf16: sm90w; fp32: tf32x3w) at gemma2-2b's
        # training shape and a ragged one at head dim 320.
        shapes.extend(d384_full_shapes())
        if dtype == torch.bfloat16:
            # The sm90n kernels at the shapes the paths give them: phase
            # 6's reduced qwen3-1.7b and phase 8's timing shape at D 32.
            shapes.extend(narrow_full_shapes())
        for name, (b, lq, lk, hq, hkv, d), kw in shapes:
            cases.append((f"{name}-{tag}", rand(b, lq, hq, d, dtype=dtype),
                          rand(b, lk, hkv, d, dtype=dtype),
                          rand(b, lk, hkv, d, dtype=dtype),
                          rand(b, lq, hq, d, dtype=dtype), kw))
    return cases


def check_bwd(name, q, k, v, do, kw):
    """dq and dk/dv kernels against ``_bwd_plain`` on the same folded
    operands and the same ``(out, lse)``, each through the route
    ``bwd_route`` picks for it.  Returns ``{"dq": route, "dkv": route}``,
    ``{"dq": (max |err|, norm-relative err), "dk": ..., "dv": ...}`` and
    the folded call for timing."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ops import _fold_chunk_args, _fold_pad

    d = q.shape[3]
    qf, kf, vf, p, band, doc = _fold_chunk_args(q, k, v, **kw)
    dof = _fold_pad(do, qf.shape[2])
    out, lse = fa._fwd_plain(qf, kf, vf, p, band=band, doc=doc)
    dsum = (dof.float() * out.float()).sum(dim=-1)
    routes = {key: fa.bwd_route(qf.dtype, qf.shape[2], key)
              for key in ("dq", "dkv")}
    n0 = launch_counts()
    got = fa._bwd_cuda(qf, kf, vf, dof, lse, dsum, p, band, doc)
    torch.cuda.synchronize()
    moved = launches_since(n0)
    check(moved == expected_launches(0, 1, routes),
          f"{name} launched {moved}, expected one dq and one dk/dv launch "
          f"on the routes {routes}")
    want = fa._bwd_plain(qf, kf, vf, out, lse, dof, p, band, doc)
    atol, rtol = BWD_TOL[q.dtype]
    errs, good, parts = {}, True, []
    for label, g, w in zip(("dq", "dk", "dv"), got, want):
        g, w = g[..., :d].float(), w[..., :d].float()
        err = float((g - w).abs().max())
        rel = float((g - w).norm() / w.norm().clamp_min(1e-30))
        ok = (torch.allclose(g, w, atol=atol, rtol=rtol)
              and rel <= BWD_REL_TOL[q.dtype]
              and bool(torch.isfinite(g).all()))
        good = good and ok
        errs[label] = (err, rel)
        parts.append(f"{label} {err:.2e}/{rel:.2e}")
    route = "/".join(dict.fromkeys(routes.values()))
    print(f"  {name:18s} {route:4s} max|err|/norm-rel: {'  '.join(parts)}  "
          f"(tol {atol:g}+{rtol:g}|x|, {BWD_REL_TOL[q.dtype]:g})  "
          f"{'ok' if good else 'FAIL'}")
    check(good, f"backward kernels disagree with their plain version on "
                f"{name}")
    del want, got
    return routes, errs, (qf, kf, vf, dof, lse, dsum, p, band, doc)


def bwd_bound(q, k, n_products: int, dtype: torch.dtype,
              peak: float | None = None, passes: int = 1):
    """(bound ms, bound_by, FLOP) of one backward kernel at a causal shape:
    ``n_products`` products of 2*D FLOPs per visible (q, k) pair, each
    issued ``passes`` times, against ``peak`` FLOP/s (by default the rate
    of ``dtype``: 989 TFLOP/s on the bf16 tensor cores, 67 TFLOP/s of fp32
    off them; the 3xTF32 kernels take passes=3 at 495 TFLOP/s of TF32), or
    the bytes it must move (q, k, v, dO read; its outputs written; lse and
    dsum) against 3.35 TB/s.  The FLOP returned counts one pass."""
    b, lq, hq, d = q.shape
    hkv = k.shape[2]
    pairs = lq * (lq + 1) // 2
    flops = n_products * 2 * b * hq * d * pairs
    item = dtype.itemsize
    q_bytes, kv_bytes = b * lq * hq * d * item, b * lq * hkv * d * item
    out_bytes = q_bytes if n_products == 3 else 2 * kv_bytes
    nbytes = 2 * q_bytes + 2 * kv_bytes + out_bytes + 2 * b * hq * lq * 4
    if peak is None:
        peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    t_ops, t_bytes = passes * flops / peak, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops)


def fwd_bound(q, k, dtype: torch.dtype, peak: float | None = None,
              passes: int = 1):
    """(bound ms, bound_by, FLOP) of the forward kernel at a causal shape:
    two products of 2*D FLOPs per visible (q, k) pair, each issued
    ``passes`` times, against ``peak`` FLOP/s (by default the rate of
    ``dtype``, as in ``bwd_bound``; the 3xTF32 kernels take passes=3 at 495
    TFLOP/s of TF32), or the bytes it must move (q, k, v read; out and lse
    written) against 3.35 TB/s.  The FLOP returned counts one pass."""
    b, lq, hq, d = q.shape
    hkv = k.shape[2]
    flops = 4 * b * hq * d * (lq * (lq + 1) // 2)
    item = dtype.itemsize
    nbytes = (2 * b * lq * hq * d + 2 * b * lq * hkv * d) * item \
        + b * hq * lq * 4
    if peak is None:
        peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    t_ops, t_bytes = passes * flops / peak, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops)


# ---------------------------------------------------------------------------
# Phase 4: serving
# ---------------------------------------------------------------------------

def counted_fns(cfg, rt, record):
    """``make_generate_fns`` whose prefill records its kernel launches and
    its logits."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve

    pf, step, traces = serve.make_generate_fns(cfg, rt)

    def pf_counted(p, batch):
        n0 = fa.FWD_LAUNCHES
        logits, caches = pf(p, batch)
        record["prefill_launches"].append(fa.FWD_LAUNCHES - n0)
        record["logits"] = logits
        return logits, caches

    return pf_counted, step, traces


def launch_counts() -> dict:
    """Kernel launches: the forward, the backward pair, and each of them
    by route."""
    from repro_torch.kernels import flash_attention as fa
    return {"flash_fwd": fa.FWD_LAUNCHES, "flash_bwd_dq": fa.DQ_LAUNCHES,
            "flash_bwd_dkv": fa.DKV_LAUNCHES,
            "fwd_sm90": fa.FWD_SM90_LAUNCHES,
            "fwd_sm90n": fa.FWD_SM90N_LAUNCHES,
            "fwd_tf32x3": fa.FWD_TF32X3_LAUNCHES,
            "dq_sm90": fa.DQ_SM90_LAUNCHES, "dkv_sm90": fa.DKV_SM90_LAUNCHES,
            "dq_tf32x3": fa.DQ_TF32X3_LAUNCHES,
            "dkv_tf32x3": fa.DKV_TF32X3_LAUNCHES,
            "dq_sm90n": fa.DQ_SM90N_LAUNCHES,
            "dkv_sm90n": fa.DKV_SM90N_LAUNCHES,
            "fwd_tf32x3w": fa.FWD_TF32X3W_LAUNCHES,
            "dq_tf32x3w": fa.DQ_TF32X3W_LAUNCHES,
            "dkv_tf32x3w": fa.DKV_TF32X3W_LAUNCHES,
            "fwd_sm90w": fa.FWD_SM90W_LAUNCHES,
            "dq_sm90w": fa.DQ_SM90W_LAUNCHES,
            "dkv_sm90w": fa.DKV_SM90W_LAUNCHES}


def launches_since(n0: dict) -> dict:
    return {key: n - n0[key] for key, n in launch_counts().items()}


def expected_launches(fwd: int, bwd: int, routes: dict) -> dict:
    """``launch_counts`` after ``fwd`` forward launches on
    ``routes["fwd"]``, ``bwd`` dq launches on ``routes["dq"]`` and ``bwd``
    dk/dv launches on ``routes["dkv"]``."""
    want = {key: 0 for key in launch_counts()}
    want.update(flash_fwd=fwd, flash_bwd_dq=bwd, flash_bwd_dkv=bwd)
    if fwd:
        want[f"fwd_{routes['fwd']}"] = fwd
    if bwd:
        want[f"dq_{routes['dq']}"] = want[f"dkv_{routes['dkv']}"] = bwd
    return want


def routes_of(dtype: torch.dtype, d: int) -> dict:
    """The route of each kernel at a dtype and padded head dim."""
    from repro_torch.kernels import flash_attention as fa
    return {"fwd": fa.fwd_route(dtype, d), "dq": fa.bwd_route(dtype, d, "dq"),
            "dkv": fa.bwd_route(dtype, d, "dkv")}


def reset_counts():
    from repro_torch.kernels import flash_attention as fa
    fa.FWD_LAUNCHES = fa.DQ_LAUNCHES = fa.DKV_LAUNCHES = 0
    fa.FWD_SM90_LAUNCHES = fa.FWD_SM90N_LAUNCHES = 0
    fa.FWD_TF32X3_LAUNCHES = fa.FWD_TF32X3W_LAUNCHES = 0
    fa.DQ_SM90_LAUNCHES = fa.DKV_SM90_LAUNCHES = 0
    fa.DQ_TF32X3_LAUNCHES = fa.DKV_TF32X3_LAUNCHES = 0
    fa.DQ_SM90N_LAUNCHES = fa.DKV_SM90N_LAUNCHES = 0
    fa.DQ_TF32X3W_LAUNCHES = fa.DKV_TF32X3W_LAUNCHES = 0
    fa.FWD_SM90W_LAUNCHES = fa.DQ_SM90W_LAUNCHES = fa.DKV_SM90W_LAUNCHES = 0


# ---------------------------------------------------------------------------
# Phase 6: the whole model, kernels against the dense oracle
# ---------------------------------------------------------------------------

# (arch, dtype) -> the route of each kernel; dtype -> (loss tolerance
# (relative), grad tolerance (norm-relative)).  fp32 keeps fp32 accuracy
# (3xTF32 products of about 21 mantissa bits in every fp32 kernel), so its
# differences are those of reordered sums; bf16 takes the bf16 kernel
# tolerance.
MODEL_ROUTES = {
    (ARCH, "float32"): {"fwd": "tf32x3", "dq": "tf32x3", "dkv": "tf32x3"},
    (ARCH, "bfloat16"): {"fwd": "sm90", "dq": "sm90", "dkv": "sm90"},
    (GEMMA, "float32"): {"fwd": "tf32x3w", "dq": "tf32x3w",
                         "dkv": "tf32x3w"},
    (GEMMA, "bfloat16"): {"fwd": "sm90w", "dq": "sm90w", "dkv": "sm90w"},
    (GEMMA320, "float32"): {"fwd": "tf32x3w", "dq": "tf32x3w",
                            "dkv": "tf32x3w"},
    (GEMMA320, "bfloat16"): {"fwd": "sm90w", "dq": "sm90w", "dkv": "sm90w"},
    (REDUCED, "float32"): {"fwd": "tf32x3", "dq": "tf32x3",
                           "dkv": "tf32x3"},
    (REDUCED, "bfloat16"): {"fwd": "sm90n", "dq": "sm90n", "dkv": "sm90n"},
    (MOE, "float32"): {"fwd": "tf32x3", "dq": "tf32x3", "dkv": "tf32x3"},
    (MOE, "bfloat16"): {"fwd": "sm90", "dq": "sm90", "dkv": "sm90"},
    (ZAMBA, "float32"): {"fwd": "tf32x3", "dq": "tf32x3", "dkv": "tf32x3"},
    (ZAMBA, "bfloat16"): {"fwd": "sm90", "dq": "sm90", "dkv": "sm90"},
    (WHISPER, "float32"): {"fwd": "tf32x3", "dq": "tf32x3",
                           "dkv": "tf32x3"},
    (WHISPER, "bfloat16"): {"fwd": "sm90", "dq": "sm90", "dkv": "sm90"},
    (CHAMELEON, "bfloat16"): {"fwd": "sm90", "dq": "sm90", "dkv": "sm90"},
    (GEMMA3, "bfloat16"): {"fwd": "sm90w", "dq": "sm90w", "dkv": "sm90w"},
    (DEEPSEEK, "float32"): {"fwd": "tf32x3w", "dq": "tf32x3w",
                            "dkv": "tf32x3w"},
    (DEEPSEEK, "bfloat16"): {"fwd": "sm90w", "dq": "sm90w", "dkv": "sm90w"}}
MODEL_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (1e-2, 1e-2)}
#: arch -> sequence length of its whole-model check (B=1).
MODEL_L = {ARCH: PROMPT, GEMMA: GEMMA_L, GEMMA320: PROMPT,
           REDUCED: REDUCED_L, MOE: PROMPT, ZAMBA: PROMPT, WHISPER: PROMPT,
           DEEPSEEK: PROMPT}
#: arch -> attention calls in its depth-2 forward (default 2): whisper's
#: two encoder layers, and two decoder layers of two calls each.
MODEL_CALLS = {WHISPER: 6}
#: arch -> the factor of phase 6's second bf16 rule.  At random init the
#: grads of whisper's last decoder layer's self-attention q and k are
#: rounding-dominated in bf16 (the bf16 oracle lies 6% from the fp32 one):
#: there the kernels' and the oracle's roundings are independent and of
#: one size, so the two bf16 paths lie about sqrt(2) times that apart,
#: and the kernels are held to lie no further from the fp32 oracle than
#: sqrt(2) times the bf16 oracle's distance (in fp32 every leaf holds
#: 1e-4).
BF16_INDEPENDENT = {WHISPER: math.sqrt(2.0)}


def model_config(arch: str):
    """The full-width config of a phase 6 ``arch`` (gemma2-2b at head dim
    320 for ``GEMMA320``; qwen3-1.7b's reduced config for ``REDUCED``;
    zamba2-7b with the shared block after every Mamba2 layer, so that its
    depth-2 cut runs the block twice; whisper-small with two encoder
    layers beside its two decoder layers)."""
    from repro_torch.configs import get_config, get_reduced

    if arch == WHISPER:
        return dataclasses.replace(get_config(WHISPER), encoder_layers=2)
    if arch == ZAMBA:
        return dataclasses.replace(get_config(ZAMBA), attn_every=1)
    if arch == REDUCED:
        return get_reduced(ARCH)
    if arch == GEMMA320:
        return dataclasses.replace(get_config(GEMMA), head_dim=320)
    return get_config(arch)


def model_runs(arch: str, dtype: str) -> dict:
    """A full-width, depth-2 ``forward_loss`` of ``arch`` and its backward
    at B=1, L=``MODEL_L[arch]`` in ``dtype`` (the same fp32 masters from
    seed 1; whisper's frames drawn with the batch), on the kernels and on
    ``impl="ref"``: ``{impl: (loss, grads, launches)}``, and under
    ``"scale"`` ``grad_scale`` of the leaves."""
    from torch.utils._pytree import tree_flatten, tree_unflatten

    from repro_torch import convert
    from repro_torch.core.runtime import Runtime
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.model import forward_loss, init_params

    cfg = dataclasses.replace(model_config(arch), num_layers=2, dtype=dtype)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(1))
    batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=MODEL_L[arch],
                                   global_batch=1, seed=1), cfg).batch(0)
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
    leaves, spec = tree_flatten(params)
    runs = {"scale": grad_scale(convert.tree_paths(params))}
    for impl in ("cuda", "ref"):
        reset_counts()
        xs = [x.detach().requires_grad_() for x in leaves]
        loss, _ = forward_loss(tree_unflatten(xs, spec), batch,
                               Runtime(impl=impl, device="cuda"), cfg)
        grads = [g.float() for g in torch.autograd.grad(loss, xs)]
        torch.cuda.synchronize()
        runs[impl] = (loss.item(), grads, launch_counts())
        del loss, xs
        torch.cuda.empty_cache()
    calls = MODEL_CALLS.get(arch, 2)
    want = expected_launches(calls, calls, MODEL_ROUTES[arch, dtype])
    check(runs["cuda"][2] == want,
          f"the {arch} {dtype} kernel run launched {runs['cuda'][2]}, "
          f"expected {want}")
    check(not any(runs["ref"][2].values()),
          f"the {arch} {dtype} ref run launched kernels: {runs['ref'][2]}")
    check(all(bool(torch.isfinite(g).all()) for g in runs["cuda"][1]),
          f"non-finite grads on the {arch} {dtype} kernels")
    return runs


def model_check(arch: str):
    """``arch``'s model on the kernels against the dense oracle, in fp32
    and in bf16.  Returns ``{dtype: (relative loss difference, worst
    norm-relative grad difference, the kernel run's launch counts)}``.

    fp32: the loss within 1e-5 relative and every grad leaf within 1e-4
    norm-relative of the fp32 oracle.  bf16: the loss within 1e-2 of the
    bf16 oracle, and every grad leaf within 1e-2 (norm-relative to the
    fp32 oracle's leaf) of the bf16 oracle's, or, where the bf16 oracle
    itself lies further than that from the fp32 oracle, no further from
    the bf16 oracle than the bf16 oracle lies from the fp32 oracle: the
    bf16 oracle's own rounding sets how finely the two bf16 paths can be
    compared.  A self-attention key bias (whisper's) is measured against
    its layer's key weight (``grad_scale``).  For an arch in
    ``BF16_INDEPENDENT`` a leaf may instead lie no further from the fp32
    oracle than that factor times the bf16 oracle's distance from it."""
    def rel(a, b, ref):
        return float((a - b).norm() / ref.norm().clamp_min(1e-30))

    out = {}
    r32 = model_runs(arch, "float32")
    (lk, gk, _), (lr, g32, _) = r32["cuda"], r32["ref"]
    scale = r32["scale"]
    loss_tol, grad_tol = MODEL_TOL["float32"]
    loss_rel = abs(lk - lr) / abs(lr)
    grad_rel = max(rel(a, b, g32[s]) for a, b, s in zip(gk, g32, scale))
    print(f"    float32: loss kernels {lk:.6f}, ref {lr:.6f}: relative "
          f"difference {loss_rel:.3e} (tol {loss_tol:g}); worst grad leaf "
          f"norm-relative difference {grad_rel:.3e} over {len(gk)} leaves "
          f"(tol {grad_tol:g}); routes {MODEL_ROUTES[arch, 'float32']}")
    check(loss_rel <= loss_tol and grad_rel <= grad_tol,
          f"the fp32 {arch} on the kernels disagrees with the dense oracle")
    out["float32"] = (loss_rel, grad_rel, r32["cuda"][2])
    del r32, gk
    torch.cuda.empty_cache()

    r16 = model_runs(arch, "bfloat16")
    (lk, gk, _), (lr, gr, _) = r16["cuda"], r16["ref"]
    loss_tol, grad_tol = MODEL_TOL["bfloat16"]
    loss_rel = abs(lk - lr) / abs(lr)
    # Per leaf: kernels vs bf16 oracle, bf16 oracle vs fp32 oracle, and
    # kernels vs fp32 oracle, each over the fp32 oracle's norm.
    leaf = [(rel(a, r, g32[s]), rel(r, t, g32[s]), rel(a, t, g32[s]))
            for a, r, t, s in zip(gk, gr, g32, scale)]
    worst = max(range(len(leaf)), key=lambda i: leaf[i][0])
    slack = BF16_INDEPENDENT.get(arch)
    missed = [k32 / r32_ for kr, r32_, k32 in leaf
              if kr > max(grad_tol, r32_)]
    ok = all(kr <= max(grad_tol, r32_) or (
        slack is not None and k32 <= max(grad_tol, slack * r32_))
        for kr, r32_, k32 in leaf)
    print(f"    bfloat16: loss kernels {lk:.6f}, bf16 ref {lr:.6f}: "
          f"relative difference {loss_rel:.3e} (tol {loss_tol:g}); worst "
          f"grad leaf (#{worst} of {len(leaf)}): kernels vs bf16 ref "
          f"{leaf[worst][0]:.3e}, where the bf16 ref lies {leaf[worst][1]:.3e}"
          f" from the fp32 ref (tol max({grad_tol:g}, that)); over all "
          f"leaves: kernels vs fp32 ref at most "
          f"{max(x[2] for x in leaf):.3e}, bf16 ref vs fp32 ref at most "
          f"{max(x[1] for x in leaf):.3e}, leaves over {grad_tol:g} "
          f"against the bf16 ref {sum(x[0] > grad_tol for x in leaf)}"
          + ("" if slack is None else
             f"; over the {len(missed)} leaves that miss that rule, the "
             f"kernels' distance from the fp32 ref at most "
             f"{max(missed, default=0.0):.3f} times the bf16 ref's (tol "
             f"{slack:.3f})")
          + f"; routes {MODEL_ROUTES[arch, 'bfloat16']}")
    check(loss_rel <= loss_tol and ok,
          f"the bf16 {arch} on the kernels disagrees with the dense oracle")
    out["bfloat16"] = (loss_rel, leaf[worst][0], r16["cuda"][2])
    return out


# ---------------------------------------------------------------------------
# Phase 7: training at full depth
# ---------------------------------------------------------------------------

def train_argv(arch: str) -> list:
    """``launch/train.py``'s arguments for phase 7: 3 steps of 2
    microbatches of 1 x 4096 tokens."""
    return ["--arch", arch, "--seq-len", str(PROMPT), "--global-batch",
            str(BATCH), "--grad-accum", "2", "--steps", "3"]


def visible_pairs(lq: int, lk: int, causal: bool, window,
                  mask_offset=None) -> int:
    """The (q, k) pairs a mask lets through, the band anchored at the
    bottom right as the kernels anchor it, or with query row 0 at key
    ``mask_offset``."""
    if not causal and window is None:
        return lq * lk
    off = lk - lq if mask_offset is None else mask_offset
    i = np.arange(lq, dtype=np.int64) + off
    hi = np.minimum(i, lk - 1) + 1
    lo = np.maximum(i - (window - 1), 0) if window else 0
    return int(np.clip(hi - lo, 0, None).sum())


def attn_widths(cfg) -> tuple:
    """(q / k width, v width) of a head: ``hd`` both, or MLA's ``d_qk``
    and ``d_v``."""
    if cfg.mla is None:
        return cfg.hd, cfg.hd
    return cfg.mla.d_qk, cfg.mla.d_v


def attn_weights(cfg) -> int:
    """One layer's attention matmul weights: GQA's q, k, v and o from the
    dims; MLA's ``wq``, ``kv_down``, ``kv_up`` and ``wo`` read from the
    reference's stacked tree (``convert.ref_param_shapes``; ``kv_norm`` is
    no matmul)."""
    if cfg.mla is None:
        return cfg.d_model * (2 * cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.hd
    from repro_torch import convert
    return sum(math.prod(shape[1:])
               for path, shape in convert.ref_param_shapes(cfg).items()
               if path[:3] == ("blocks", 0, "attn") and len(shape) == 3)


def train_flops(cfg, seq: int, tokens: int) -> float:
    """Model FLOPs of one training step (forward + backward = 3 forwards,
    no recompute): 2 per token per matmul weight, LM head included, plus
    the causal attention products (2 FLOPs a visible pair a head per
    column of QK^T at the q / k width and of PV at the v width; a local
    layer's window cuts its pairs).  An MoE layer counts the reference's
    active weights (``src/repro/analysis/roofline.py::count_params``): its
    router and its experts scaled by top_k / E, k of them a token."""
    m = cfg.moe
    ffn = (3 * cfg.d_model * cfg.d_ff if m is None else cfg.d_model
           * m.n_experts + 3 * cfg.d_model * m.d_ff * (m.top_k + m.n_shared))
    weights = cfg.num_layers * (attn_weights(cfg) + ffn) \
        + cfg.vocab * cfg.d_model
    pairs = sum(visible_pairs(seq, seq, True,
                              cfg.attn_kind(i % cfg.period).window)
                for i in range(cfg.num_layers))
    attn = 2 * sum(attn_widths(cfg)) * cfg.n_heads * pairs * (tokens // seq)
    return 3 * (2 * weights * tokens + attn)


def train_phase(argv: list, before=None):
    """``launch/train.py``'s path for ``argv`` through ``Trainer``;
    returns the record of the run (with ``before(trainer)``'s result under
    ``"before"``, called ahead of the first step) and the trainer."""
    from repro_torch.launch import train as launch_train

    plan, trainer = launch_train.make_trainer(launch_train.parse_args(argv))
    print("    " + plan.describe().replace("\n", "\n    "))
    first = before(trainer) if before is not None else None
    step_fn, steps = trainer.step_fn, []

    def counted(params, opt_state, batch):
        n0 = launch_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = step_fn(params, opt_state, batch)
        end.record()
        steps.append({"events": (start, end), "metrics": out[2],
                      "launches": launches_since(n0)})
        return out

    trainer.step_fn = counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses = trainer.run()
    torch.cuda.synchronize()
    totals = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    trainer.step_fn = step_fn
    ms = [a.elapsed_time(b) for a, b in (s["events"] for s in steps)]
    gnorms = [float(s["metrics"]["grad_norm"]) for s in steps]
    return {"losses": losses, "gnorms": gnorms, "step_ms": ms,
            "launches": [s["launches"] for s in steps], "totals": totals,
            "peak": peak, "plan": plan, "before": first}, trainer


def steady_steps(trainer, n: int) -> list:
    """``n`` more steps of ``trainer``'s step function on its next
    batches, each timed with CUDA events and no sync between steps (as in
    the trainer's loop); returns their milliseconds."""
    events = []
    for i in range(n):
        batch = trainer._to_device(trainer.data.batch(trainer.tcfg.num_steps
                                                      + i))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        trainer.params, trainer.opt_state, _ = trainer.step_fn(
            trainer.params, trainer.opt_state, batch)
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in events]


def training_run(arch: str, routes: dict, n_steady: int,
                 after=None) -> dict:
    """Phase 7 for one architecture: the 3 counted steps (finite losses,
    step 0 within 1.5 of ln(vocab), every launch of every step on its
    kernel's route in ``routes``), ``n_steady`` more timed steps and one
    profiled step; then ``after(trainer)``, whose result the record keeps
    under ``"after"``.  Returns the run's record; the trainer is freed."""
    argv = train_argv(arch)
    print(f"    {arch}: python -m repro_torch.launch.train {' '.join(argv)}")
    run, trainer = train_phase(argv)
    tcfg = run["plan"].cfg
    n_layers, accum = tcfg.num_layers, run["plan"].grad_accum
    losses = run["losses"]
    check(len(losses) == 3 and all(np.isfinite(losses)),
          f"{arch} training losses {losses}")
    check(abs(losses[0] - np.log(tcfg.vocab)) <= 1.5,
          f"{arch} step-0 loss {losses[0]} is not within 1.5 of ln(vocab) "
          f"= {np.log(tcfg.vocab):.2f}")
    fwd_per_step = {"none": 1, "scpp": 1, "full": 2}[tcfg.remat] \
        * n_layers * accum
    want = expected_launches(fwd_per_step, n_layers * accum, routes)
    check(all(step == want for step in run["launches"]),
          f"{arch} launches per step {run['launches']}, expected {want}")
    tokens_per_step = BATCH * PROMPT
    step_ms = statistics.median(run["step_ms"][1:])
    model_flops = train_flops(tcfg, PROMPT, tokens_per_step)
    print(f"    model FLOPs per step {model_flops / 1e12:.2f} TFLOP "
          f"(matmul weights and causal attention, forward + backward, no "
          f"recompute)")
    print(f"    losses {[round(x, 6) for x in losses]} (ln vocab "
          f"{np.log(tcfg.vocab):.4f}); grad norms "
          f"{[round(x, 6) for x in run['gnorms']]}")
    print(f"    kernel launches per step {run['launches'][0]} (remat "
          f"{tcfg.remat}); step times {[round(x, 2) for x in run['step_ms']]}"
          f" ms; median after 1 warm-up {step_ms:.2f} ms = "
          f"{tokens_per_step * 1e3 / step_ms:.0f} tokens/s, "
          f"{100 * model_flops / (step_ms * 1e-3) / PEAK_BF16_FLOPS:.2f}% of "
          f"989 TFLOP/s; peak memory {run['peak'] / 2**30:.2f} GiB")
    extra_ms = steady_steps(trainer, n_steady)
    steady = statistics.median(extra_ms)
    print(f"    {n_steady} more steps of the same trainer: "
          f"{[round(x, 2) for x in extra_ms]} ms, median {steady:.2f} ms = "
          f"{tokens_per_step * 1e3 / steady:.0f} tokens/s, "
          f"{100 * model_flops / (steady * 1e-3) / PEAK_BF16_FLOPS:.2f}% of "
          f"989 TFLOP/s; card right after: {smi_sample()}")
    batch = trainer._to_device(trainer.data.batch(3))
    prof, _ = profile_call(
        lambda: trainer.step_fn(trainer.params, trainer.opt_state, batch),
        top=12)
    print(f"    training step: {prof}")
    del batch
    if after is not None:
        run["after"] = after(trainer)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return run


def smi_sample() -> str:
    """The card's SM clock, power draw and temperature now."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()


def load_probe():
    """``scripts/mma_tf32_probe.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        "mma_tf32_probe", ROOT / "scripts" / "mma_tf32_probe.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def sdpa_backend(q, k, v):
    """The first SDPA backend (flash, cuDNN, memory-efficient, math) that
    runs causal attention forward and backward on these ``(B, H, L, D)``
    operands; flash attention stops at D 256."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    sdpa = torch.nn.functional.scaled_dot_product_attention
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]), warnings.catch_warnings():
                warnings.simplefilter("ignore")     # why a backend declined
                out = sdpa(q, k, v, is_causal=True)
                torch.autograd.grad(out, (q, k, v), torch.ones_like(out))
            torch.cuda.synchronize()
            return backend
        except RuntimeError:
            continue
    raise RuntimeError("chip_smoke: no SDPA backend ran")


def gemma_timings(gemma_full: dict) -> dict:
    """The kernels at gemma2-2b's training shape (phase 3's
    ``gemma2-full`` operands, causal, softcap 50) on the routes each dtype
    takes there (bf16: the three sm90w kernels; fp32: the three tf32x3w
    kernels): CUDA events around each kernel, the plain version, SDPA on
    repeated K/V in the same dtype (causal without a softcap: SDPA has
    none; the forward, and the backward alone as in the other rows) with
    its backend, and the bounds at the dtype's rate (fp32: three TF32
    passes at 495 TFLOP/s) and at the 67 TFLOP/s of fp32 off the tensor
    cores.  The three kernels are also timed without the softcap
    (``"nocap"``), the function SDPA computes, and every kernel and SDPA
    back to back (``"loop"``), the kernels with the softcap and without.
    Returns ``{dtype: {...}}``."""
    from torch.nn.attention import sdpa_kernel

    from repro_torch.kernels import flash_attention as fa

    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, do, (qf, kf, vf, dof, lse, dsum, p, band, doc) = \
            gemma_full[dtype]
        routes = routes_of(dtype, qf.shape[2])
        n0 = launch_counts()
        fwd_ms = cuda_ms(lambda: fa._fwd(qf, kf, vf, p, band=band, doc=doc))
        check(launches_since(n0) == expected_launches(9, 0, routes),
              f"the gemma2 forward timing left the {routes['fwd']} route")
        n0 = launch_counts()
        dq_ms = cuda_ms(lambda: fa._dq_cuda(qf, kf, vf, dof, lse, dsum, p,
                                            band, doc))
        dkv_ms = cuda_ms(lambda: fa._dkv_cuda(qf, kf, vf, dof, lse, dsum, p,
                                              band, doc))
        check(launches_since(n0) == expected_launches(0, 9, routes),
              f"the gemma2 backward timing left the routes {routes}")
        p0 = p._replace(softcap=0.0)
        out0, lse0 = fa._fwd_plain(qf, kf, vf, p0, band=band, doc=doc)
        dsum0 = (dof.float() * out0.float()).sum(dim=-1)
        del out0
        n0 = launch_counts()
        nocap = {
            "fwd": cuda_ms(lambda: fa._fwd(qf, kf, vf, p0, band=band,
                                           doc=doc)),
            "dq": cuda_ms(lambda: fa._dq_cuda(qf, kf, vf, dof, lse0, dsum0,
                                              p0, band, doc)),
            "dkv": cuda_ms(lambda: fa._dkv_cuda(qf, kf, vf, dof, lse0,
                                                dsum0, p0, band, doc))}
        check(launches_since(n0) == expected_launches(9, 9, routes),
              f"the gemma2 timing without softcap left the routes {routes}")
        n0 = launch_counts()
        loop = {}
        for cap_tag, pc, lse_c, dsum_c in (("", p, lse, dsum),
                                           ("_nocap", p0, lse0, dsum0)):
            loop["fwd" + cap_tag] = statistics.median(cuda_loop_times(
                lambda: fa._fwd(qf, kf, vf, pc, band=band, doc=doc)))
            for key, fn in (("dq", fa._dq_cuda), ("dkv", fa._dkv_cuda)):
                loop[key + cap_tag] = statistics.median(cuda_loop_times(
                    lambda: fn(qf, kf, vf, dof, lse_c, dsum_c, pc, band,
                               doc)))
        check(launches_since(n0) == expected_launches(206, 206, routes),
              f"the gemma2 back-to-back timing left the routes {routes}")
        del lse0, dsum0
        fwd_plain_ms = cuda_ms(lambda: fa._fwd_plain(qf, kf, vf, p,
                                                     band=band, doc=doc),
                               reps=5)
        out_p, _ = fa._fwd_plain(qf, kf, vf, p, band=band, doc=doc)
        bwd_plain_ms = cuda_ms(lambda: fa._bwd_plain(
            qf, kf, vf, out_p, lse, dof, p, band, doc), reps=5)
        del out_p
        group = q.shape[2] // k.shape[2]
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        dot = do.transpose(1, 2).contiguous()
        kr, vr = (t.detach().repeat_interleave(group, dim=1).requires_grad_()
                  for t in (kt, vt))
        backend = sdpa_backend(qt, kr, vr)
        with sdpa_kernel([backend]):
            def lib_fwd():
                return sdpa(qt.detach(), kr.detach(), vr.detach(),
                            is_causal=True)

            lib_fwd_ms = cuda_ms(lib_fwd)
            lib_fwd_loop = statistics.median(cuda_loop_times(lib_fwd))
            del kr, vr, lib_fwd
            sdpa_out = sdpa(qt, kt.repeat_interleave(group, dim=1),
                            vt.repeat_interleave(group, dim=1),
                            is_causal=True)

            def lib_grad():
                return torch.autograd.grad(sdpa_out, (qt, kt, vt), dot,
                                           retain_graph=True)

            lib_bwd = cuda_times(lib_grad, reps=21, warmup=3)
            lib_bwd_loop = statistics.median(cuda_loop_times(lib_grad))
        del sdpa_out, qt, kt, vt, dot, lib_grad
        torch.cuda.empty_cache()
        # fp32's rate: three TF32 passes at 495 TFLOP/s.
        tf32 = ((PEAK_TF32_FLOPS, 3) if dtype == torch.float32
                else (None, 1))
        tm = out[dtype] = {
            "fwd": (fwd_ms, *fwd_bound(q, k, dtype, *tf32)[:2],
                    fwd_bound(q, k, dtype, PEAK_FP32_FLOPS)[0]),
            "dq": (dq_ms, *bwd_bound(q, k, 3, dtype, *tf32)[:2],
                   bwd_bound(q, k, 3, dtype, PEAK_FP32_FLOPS)[0]),
            "dkv": (dkv_ms, *bwd_bound(q, k, 4, dtype, *tf32)[:2],
                    bwd_bound(q, k, 4, dtype, PEAK_FP32_FLOPS)[0]),
            "fwd_plain": fwd_plain_ms, "bwd_plain": bwd_plain_ms,
            "fwd_library": lib_fwd_ms, "fwd_library_loop": lib_fwd_loop,
            "bwd_library": statistics.median(lib_bwd),
            "bwd_library_loop": lib_bwd_loop,
            "backend": backend.name, "routes": routes, "nocap": nocap,
            "loop": loop}
        b, lq, hq, d = q.shape
        tag = "bf16" if dtype == torch.bfloat16 else "fp32"
        print(f"    gemma2-2b kernels at B={b} L={lq} Hq={hq} "
              f"Hkv={k.shape[2]} D={d} causal softcap {GEMMA_CAP:g} {tag}:")
        for key, label, flops in (
                ("fwd", "forward", fwd_bound(q, k, dtype)[2]),
                ("dq", "dq", bwd_bound(q, k, 3, dtype)[2]),
                ("dkv", "dk/dv", bwd_bound(q, k, 4, dtype)[2])):
            ms, bound, by, bound_fma = tm[key]
            rate = ("3 TF32 passes at 495 TFLOP/s" if tf32[1] == 3
                    else f"the {tag} rate")
            print(f"      {label} ({routes[key]}) kernel {ms:.4f} ms "
                  f"({flops / ms / 1e9:.1f} TFLOP/s); bound {bound:.4f} ms "
                  f"({by}: {flops / 1e9:.1f} GFLOP at {rate}; "
                  f"{100 * bound / ms:.2f}% of it); at 67 TFLOP/s of fp32 "
                  f"FMA {bound_fma:.4f} ms ({100 * bound_fma / ms:.1f}%); "
                  f"without the softcap {nocap[key]:.4f} ms "
                  f"({100 * bound / nocap[key]:.2f}% of the bound); back "
                  f"to back {loop[key]:.4f} ms, without the softcap "
                  f"{loop[key + '_nocap']:.4f}")
        print(f"      pair (dq + dk/dv) softcap {GEMMA_CAP:g}: "
              f"{dq_ms + dkv_ms:.4f} ms one call at a time, "
              f"{loop['dq'] + loop['dkv']:.4f} back to back; without it "
              f"{nocap['dq'] + nocap['dkv']:.4f} / "
              f"{loop['dq_nocap'] + loop['dkv_nocap']:.4f}")
        print(f"      plain forward {fwd_plain_ms:.4f} ms, plain backward "
              f"(dq, dk, dv in one call) {bwd_plain_ms:.4f} ms; sdpa "
              f"({backend.name}, repeated kv, no softcap) forward "
              f"{lib_fwd_ms:.4f} ms (back to back {lib_fwd_loop:.4f}), "
              f"backward alone median "
              f"{statistics.median(lib_bwd):.4f} ms over 21, min "
              f"{min(lib_bwd):.4f}, max {max(lib_bwd):.4f}; back to back "
              f"{lib_bwd_loop:.4f}")
    return out


def max_sm_clock_hz() -> float:
    """The card's maximum SM clock (nvidia-smi ``clocks.max.sm``), Hz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()
    return float(out[0]) * 1e6


def exp2_floor_ms(q) -> float:
    """The special-function unit's floor of a causal forward: one exp2 a
    visible score, 16 a clock an SM at the card's maximum SM clock."""
    b, lq, hq, _ = q.shape
    scores = b * hq * (lq * (lq + 1) // 2)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return scores / (16 * sms * max_sm_clock_hz()) * 1e3


def fwd_d32_timings(case) -> dict:
    """The forward at qwen3-1.7b's training shape at D 32 in bf16 (phase
    3's train-d32-full case), the sm90n route's width: the kernel (one call
    a timing, and back to back), its bounds (989 TFLOP/s, and 67 of the FMA
    cores) and the special-function unit's exp2 floor, the plain version
    and SDPA's forward (``enable_gqa``) on the same inputs."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v, _, (qf, kf, vf, _, _, _, p, band, doc) = case
    x = [qf, kf, vf]
    n0 = launch_counts()
    ms = cuda_ms(lambda: fa._fwd(*x, p, band=band, doc=doc))
    loop = statistics.median(cuda_loop_times(
        lambda: fa._fwd(*x, p, band=band, doc=doc)))
    check(launches_since(n0) == expected_launches(112, 0, {"fwd": "sm90n"}),
          "the bf16 D 32 forward timing left the sm90n route")
    plain = cuda_ms(lambda: fa._fwd_plain(*x, p, band=band, doc=doc),
                    reps=5)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True))
    lib_loop = statistics.median(cuda_loop_times(
        lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)))
    bound, by, flops = fwd_bound(q, k, torch.bfloat16)
    out = dict(ms=ms, loop=loop, bound=bound, by=by, flops=flops,
               bound_fma=fwd_bound(q, k, torch.bfloat16,
                                   PEAK_FP32_FLOPS)[0],
               exp2_floor=exp2_floor_ms(q), plain=plain, library=lib,
               library_loop=lib_loop)
    b_, lq, hq, _ = q.shape
    print(f"    forward (sm90n) at B={b_} L={lq} Hq={hq} Hkv={k.shape[2]} "
          f"D=32 causal bf16: kernel {ms:.4f} ms (back to back {loop:.4f}); "
          f"bound {bound:.4f} ms ({by}: {flops / 1e9:.1f} GFLOP at 989 "
          f"TFLOP/s; {100 * bound / ms:.2f}% of it, back to back "
          f"{100 * bound / loop:.2f}%); exp2 floor {out['exp2_floor']:.4f} "
          f"ms (one exp2 a score, 16 a clock an SM at the maximum SM clock; "
          f"{100 * out['exp2_floor'] / ms:.2f}% of it, back to back "
          f"{100 * out['exp2_floor'] / loop:.2f}%); at 67 TFLOP/s of fp32 "
          f"FMA {out['bound_fma']:.4f} ms; plain {plain:.4f} ms; "
          f"sdpa(enable_gqa) forward {lib:.4f} ms (back to back "
          f"{lib_loop:.4f})")
    return out


def d384_timings(gen: torch.Generator, dtype: torch.dtype) -> dict:
    """The three kernels at head dim 320 (padded to 384; bf16: the sm90w
    forward, dq and dk/dv; fp32: the tf32x3w forward, dq and dk/dv) at
    gemma2-2b's training shape (causal), each with softcap 50 and without
    (the function SDPA computes), one call a timing and back to back;
    their bounds (the function's FLOPs at D 320 at the dtype's rate: 989
    TFLOP/s in bf16, three TF32 passes at 495 in fp32; and at 67 of fp32
    off the tensor cores; the kernels' padded work is 384 / 320 of it),
    the plain version and SDPA
    on repeated K/V with the backend that runs at D 320 (no softcap),
    forward and backward alone, also both ways.  Returns ``{key: ...}``."""
    from torch.nn.attention import sdpa_kernel

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ops import _fold_chunk_args, _fold_pad

    b, l, hq, hkv, d = BATCH, PROMPT, GEMMA_HQ, GEMMA_HKV, 320
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                   .to(dtype)
                   for shape in ((b, l, hq, d), (b, l, hkv, d),
                                 (b, l, hkv, d), (b, l, hq, d)))
    qf, kf, vf, p, band, doc = _fold_chunk_args(q, k, v, causal=True,
                                                softcap=GEMMA_CAP)
    p0 = p._replace(softcap=0.0)
    dof = _fold_pad(do, qf.shape[2])
    stats = {}     # softcap -> the plain forward's (out, lse) and dsum
    for pc in (p, p0):
        out_c, lse_c = fa._fwd_plain(qf, kf, vf, pc, band=band, doc=doc)
        stats[pc.softcap] = (out_c, lse_c,
                             (dof.float() * out_c.float()).sum(dim=-1))
    routes = routes_of(dtype, qf.shape[2])
    check(routes == ({"fwd": "sm90w", "dq": "sm90w", "dkv": "sm90w"}
                     if dtype == torch.bfloat16 else
                     {"fwd": "tf32x3w", "dq": "tf32x3w",
                      "dkv": "tf32x3w"}),
          f"D 384 took the routes {routes}")

    def call(key, pc):
        _, lse_c, dsum_c = stats[pc.softcap]
        if key == "fwd":
            return lambda: fa._fwd(qf, kf, vf, pc, band=band, doc=doc)
        fn = fa._dq_cuda if key == "dq" else fa._dkv_cuda
        return lambda: fn(qf, kf, vf, dof, lse_c, dsum_c, pc, band, doc)

    # (key, "" or "_nocap") -> one call a timing, back to back
    ms, loop = {}, {}
    n0 = launch_counts()
    for key in ("fwd", "dq", "dkv"):
        for tag, pc in (("", p), ("_nocap", p0)):
            ms[key + tag] = cuda_ms(call(key, pc))
            loop[key + tag] = statistics.median(cuda_loop_times(call(key,
                                                                     pc)))
    check(launches_since(n0) == expected_launches(224, 224, routes),
          f"the D 384 timing left the routes {routes}")
    out, lse, _ = stats[p.softcap]
    plain = {"fwd": cuda_ms(lambda: fa._fwd_plain(qf, kf, vf, p, band=band,
                                                  doc=doc), reps=5),
             "bwd": cuda_ms(lambda: fa._bwd_plain(qf, kf, vf, out, lse, dof,
                                                  p, band, doc), reps=5)}
    del out, lse, stats
    group = hq // hkv
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    kr, vr = (t.detach().repeat_interleave(group, dim=1).requires_grad_()
              for t in (kt, vt))
    backend = sdpa_backend(qt, kr, vr)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    with sdpa_kernel([backend]):
        def lib_fwd_call():
            return sdpa(qt.detach(), kr.detach(), vr.detach(),
                        is_causal=True)

        sdpa_out = sdpa(qt, kt.repeat_interleave(group, dim=1),
                        vt.repeat_interleave(group, dim=1), is_causal=True)

        def lib_bwd_call():
            return torch.autograd.grad(sdpa_out, (qt, kt, vt), dot,
                                       retain_graph=True)

        lib = {"fwd": cuda_ms(lib_fwd_call),
               "bwd": cuda_ms(lib_bwd_call, reps=21, warmup=3)}
        lib_loop = {"fwd": statistics.median(cuda_loop_times(lib_fwd_call)),
                    "bwd": statistics.median(cuda_loop_times(lib_bwd_call))}
    del sdpa_out, qt, kt, vt, kr, vr, dot
    torch.cuda.empty_cache()
    res = {"backend": backend.name}
    tag = "bf16" if dtype == torch.bfloat16 else "fp32"
    # fp32's rate: three TF32 passes at 495 TFLOP/s.
    tf32 = (None, 1) if dtype == torch.bfloat16 else (PEAK_TF32_FLOPS, 3)
    rate = ("989 TFLOP/s" if tf32[1] == 1
            else "3 TF32 passes at 495 TFLOP/s")
    for key, n, label in (("fwd", None, "forward"), ("dq", 3, "dq"),
                          ("dkv", 4, "dk/dv")):
        if n is None:
            bound, by, flops = fwd_bound(q, k, dtype, *tf32)
            bound_fma = fwd_bound(q, k, dtype, PEAK_FP32_FLOPS)[0]
        else:
            bound, by, flops = bwd_bound(q, k, n, dtype, *tf32)
            bound_fma = bwd_bound(q, k, n, dtype, PEAK_FP32_FLOPS)[0]
        which = "fwd" if key == "fwd" else "bwd"
        res[key] = dict(ms=ms[key], loop=loop[key], nocap=ms[key + "_nocap"],
                        nocap_loop=loop[key + "_nocap"], bound=bound, by=by,
                        bound_fma=bound_fma, plain=plain[which],
                        library=lib[which], library_loop=lib_loop[which])
        print(f"    {label} ({routes[key]}) at B={b} L={l} Hq={hq} Hkv={hkv} "
              f"head dim 320 (padded 384) causal {tag}: softcap "
              f"{GEMMA_CAP:g} {ms[key]:.4f} ms (back to back "
              f"{loop[key]:.4f}), without the softcap "
              f"{ms[key + '_nocap']:.4f} ms (back to back "
              f"{loop[key + '_nocap']:.4f}; "
              f"{100 * bound / loop[key + '_nocap']:.2f}% of the bound, "
              f"which the padding to 384 raises 1.2x); bound {bound:.4f} ms "
              f"({by}: {flops / 1e9:.1f} GFLOP at D 320 at {rate}), at "
              f"67 TFLOP/s {bound_fma:.4f} ms")
    print(f"    pair (dq + dk/dv) {tag}: softcap {GEMMA_CAP:g} "
          f"{ms['dq'] + ms['dkv']:.4f} ms one call at a time, "
          f"{loop['dq'] + loop['dkv']:.4f} back to back; without it "
          f"{ms['dq_nocap'] + ms['dkv_nocap']:.4f} / "
          f"{loop['dq_nocap'] + loop['dkv_nocap']:.4f}")
    print(f"    plain forward {plain['fwd']:.4f} ms, plain backward (dq, dk, "
          f"dv) {plain['bwd']:.4f} ms; sdpa ({backend.name}, repeated kv, no "
          f"softcap) forward {lib['fwd']:.4f} ms (back to back "
          f"{lib_loop['fwd']:.4f}), backward alone {lib['bwd']:.4f} ms (back "
          f"to back {lib_loop['bwd']:.4f})")
    return res


def gemma_record(key, dtype, tpu_line, tpu_kernel, source, gemma, launches,
                 launches_in, errs) -> dict:
    """The kernels line's record of the ``key`` kernel (``fwd``, ``dq`` or
    ``dkv``) on the route ``dtype`` takes at gemma2-2b's width, with its
    times in ``dtype`` and, where the other dtype takes the same route,
    those too.  ``errs`` is (max |err|, lse or norm-relative err, cases)
    over every case of that route."""
    tm = gemma[dtype]
    route = tm["routes"][key]
    which = "fwd" if key == "fwd" else "bwd"
    ms, bound, by, bound_fma = tm[key]
    tag = "bf16" if dtype == torch.bfloat16 else "fp32"
    rec = {"name": f"flash_fwd_{route}" if key == "fwd"
           else f"flash_bwd_{key}_{route}",
           "route": "cuda", "kernel_route": route, "source": source,
           "replaces": f"src/repro/kernels/flash_attention.py:{tpu_line}",
           "tpu_kernel": tpu_kernel, "launches": launches,
           "launches_in": launches_in, "cases": errs[2],
           "max_abs_err": errs[0], "ms": ms,
           "plain_ms": tm[f"{which}_plain"], "bound_ms": bound,
           "bound_by": by, "bound_fma_ms": bound_fma,
           "library_ms": tm[f"{which}_library"],
           "library": f"sdpa {tm['backend']}, repeated kv, no softcap",
           "dtype": tag, "head_dim": GEMMA_D}
    rec["max_lse_err" if key == "fwd" else "max_norm_rel_err"] = errs[1]
    rec["softcap0_ms"] = tm["nocap"][key]
    rec.update(ms_back_to_back=tm["loop"][key],
               softcap0_ms_back_to_back=tm["loop"][key + "_nocap"],
               library_ms_back_to_back=tm[f"{which}_library_loop"])
    other = torch.float32 if dtype == torch.bfloat16 else torch.bfloat16
    to = gemma[other]
    if to["routes"][key] == route:
        otag = "fp32" if other == torch.float32 else "bf16"
        rec.update({f"{otag}_ms": to[key][0],
                    f"{otag}_plain_ms": to[f"{which}_plain"],
                    f"{otag}_bound_ms": to[key][1],
                    f"{otag}_library_ms": to[f"{which}_library"]})
    return rec


# ---------------------------------------------------------------------------
# Phase 9: 2D-Attention on eight ranks that share the card
# ---------------------------------------------------------------------------

MESH_WORLD = 8
#: (a): the attention op at B=1 and this global sequence (4,096 a rank).
MESH_S = 32768
#: name -> (q heads, kv heads, head dim, softcap, window): qwen3-1.7b's
#: attention, and gemma2-2b's with its softcap and local window.
MESH_SHAPES = {ARCH: (16, 8, 128, 0.0, None), GEMMA: (8, 4, 288, 50.0, 4096)}
#: (shape, hp, outer, inner, placement).  (8, 1, 1) repeats gemma2-2b's KV
#: heads (hp 8 > 4) and runs the sm90w / tf32x3w routes.
MESH_GRIDS = ((ARCH, 2, 2, 2, "head_first"), (ARCH, 2, 2, 2, "context_first"),
              (GEMMA, 8, 1, 1, "head_first"))
#: (b) and (c): qwen3-1.7b at depth 2, B=1 and this global sequence
#: (1,024 tokens a rank).  Eight ranks at 16,384 ran out of the card's
#: memory in (b): each holds the whole model, and a 2,048-token chunk of
#: fp32 logits over the 151,936-word vocabulary is 1.16 GiB.
MESH_MODEL_S = 8192
#: (c): the trainer's global sequence (512 tokens a rank).  At 8,192 its
#: eight ranks used 77.97 of the card's 79.18 GiB: each holds the fp32
#: masters and both AdamW moments (4.6 GiB at depth 2, most of it the
#: embedding table).
MESH_TRAIN_S = 4096
#: (c): trainer steps (3 until phase 18 needed the script's time).
MESH_TRAIN_STEPS = 2
MESH_DTYPES = (torch.float32, torch.bfloat16)
#: How long the ranks may take before the phase fails.
MESH_SECONDS = 900


def mesh_inputs(shape: str, dtype: torch.dtype) -> list:
    """The global logical q, k, v and dO of (a), drawn on the card from a
    seed: every process that draws them gets the same values."""
    hq, hkv, d, _, _ = MESH_SHAPES[shape]
    gen = torch.Generator(device="cuda").manual_seed(91)
    shapes = ((1, MESH_S, hq, d), (1, MESH_S, hkv, d), (1, MESH_S, hkv, d),
              (1, MESH_S, hq, d))
    return [torch.randn(sh, generator=gen, device="cuda").to(dtype)
            for sh in shapes]


def mesh_model(dtype: str):
    """(b)'s qwen3-1.7b at depth 2 in ``dtype`` and its fp32 masters from
    seed 1, on the card."""
    from repro_torch.models.model import init_params
    cfg = dataclasses.replace(model_config(ARCH), num_layers=2, dtype=dtype)
    return cfg, init_params(cfg, torch.Generator(device="cuda").manual_seed(1))


def mesh_model_batch(cfg, pc=None, coord=None) -> dict:
    """(b)'s batch: the global one (one process), or this rank's shard of
    it, zigzag-laid over ``pc.cp``, through the data pipeline."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, rank_slices
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=MESH_MODEL_S, global_batch=1,
                      seed=1, cp=1 if pc is None else pc.cp)
    shard = None if pc is None else rank_slices(dcfg, pc, coord)
    batch = SyntheticLM(dcfg, shard=shard).batch(0)
    return {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}


def mesh_loss_grads(params, batch, rt, cfg):
    """``forward_loss`` and its grads as fp32 leaves."""
    from torch.utils._pytree import tree_flatten, tree_unflatten

    from repro_torch.models.model import forward_loss
    leaves, spec = tree_flatten(params)
    xs = [x.detach().requires_grad_() for x in leaves]
    loss, _ = forward_loss(tree_unflatten(xs, spec), batch, rt, cfg)
    grads = list(torch.autograd.grad(loss, xs))
    for i, g in enumerate(grads):
        grads[i] = g.float()
    return loss.item(), grads


def mesh_references() -> dict:
    """One process on the card: (a)'s ``flash_attention`` over the global
    inputs with its autograd grads, per shape and dtype, and (b)'s
    ``forward_loss`` and grads, per dtype; all moved to host memory."""
    from repro_torch.core.runtime import Runtime
    from repro_torch.kernels.ops import flash_attention
    refs = {}
    for shape in MESH_SHAPES:
        _, _, _, softcap, window = MESH_SHAPES[shape]
        for dtype in MESH_DTYPES:
            q, k, v, do = mesh_inputs(shape, dtype)
            q, k, v = (x.requires_grad_() for x in (q, k, v))
            out = flash_attention(q, k, v, causal=True, window=window,
                                  softcap=softcap, impl="cuda")
            grads = torch.autograd.grad(out, (q, k, v), do)
            refs[shape, dtype] = [x.detach().cpu() for x in (out, *grads)]
            del q, k, v, do, out, grads
            torch.cuda.empty_cache()
    for dtype in ("float32", "bfloat16"):
        cfg, params = mesh_model(dtype)
        loss, grads = mesh_loss_grads(params, mesh_model_batch(cfg),
                                      Runtime(impl="cuda", device="cuda"),
                                      cfg)
        refs["model", dtype] = (loss, [g.cpu() for g in grads])
        del params, grads
        torch.cuda.empty_cache()
    return refs


def mesh_shard_path(tmp: Path, i: int, dtype, rank: int) -> Path:
    return tmp / f"a{i}-{str(dtype).split('.')[-1]}-rank{rank}.pt"


def mesh_attention_rank(i: int, dtype, tmp: Path) -> dict:
    """(a) on this rank: its shard of the global inputs (zigzag over cp,
    then its sequence piece), ``attention_2d`` and its backward on the
    kernels; launch counts per route checked; the shards written to
    ``tmp``."""
    import torch.distributed as dist

    from repro_torch.core.attention2d import Attn2DConfig, attention_2d
    from repro_torch.core.runtime import world_runtime
    from repro_torch.core.topology import ParallelConfig, seq_slice
    from repro_torch.core.zigzag import to_zigzag
    from repro_torch.kernels.ops import _d_pad
    grid = MESH_GRIDS[i]
    shape, hp, no, wi, placement = grid
    _, _, d, softcap, window = MESH_SHAPES[shape]
    pc = ParallelConfig(hp=hp, cp_outer=no, cp_inner=wi, placement=placement)
    rt = world_runtime(pc, impl="cuda", device="cuda")
    piece = seq_slice(pc, rt.coord, MESH_S)
    q, k, v, do = (to_zigzag(x, pc.cp)[:, piece].contiguous()
                   for x in mesh_inputs(shape, dtype))
    torch.cuda.empty_cache()
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    cfg = Attn2DConfig(hp=hp, n_out=no, w=wi, causal=True, window=window,
                       softcap=softcap, impl="cuda")
    routes, steps = routes_of(dtype, _d_pad(d)), no * wi
    ms = []
    for _ in range(2):      # the second call is timed: the first connects
        torch.cuda.synchronize()     # the groups' gloo pairs
        dist.barrier()
        reset_counts()
        t0 = time.perf_counter()
        out = attention_2d(q, k, v, cfg=cfg, rt=rt)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fwd = launch_counts()
        grads = torch.autograd.grad(out, (q, k, v), do)
        torch.cuda.synchronize()
        ms.append(((t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3))
        total = launch_counts()
        check(fwd == expected_launches(steps, 0, routes),
              f"rank {dist.get_rank()} {grid} {dtype}: the forward launched "
              f"{fwd}, expected {steps} on {routes['fwd']}")
        check(total == expected_launches(steps, steps, routes),
              f"rank {dist.get_rank()} {grid} {dtype}: launched {total}, "
              f"expected {steps} of each on {routes}")
    torch.save({"piece": (piece.start, piece.stop),
                **{n: x.detach().cpu() for n, x in
                   zip(("out", "dq", "dk", "dv"), (out, *grads))}},
               mesh_shard_path(tmp, i, dtype, dist.get_rank()))
    return {"fwd_ms": ms[-1][0], "bwd_ms": ms[-1][1],
            "first_ms": sum(ms[0]), "launches": total["flash_fwd"],
            "routes": routes}


def mesh_model_rank(dtype: str, tmp: Path) -> dict:
    """(b) on this rank: the shard's loss and grads on the (2, 2, 2) grid,
    grads summed over ranks; rank 0 writes them."""
    import torch.distributed as dist

    from repro_torch.core.runtime import all_reduce_, world_runtime
    from repro_torch.core.topology import ParallelConfig
    pc = ParallelConfig(hp=2, cp_outer=2, cp_inner=2)
    rt = world_runtime(pc, impl="cuda", device="cuda")
    cfg, params = mesh_model(dtype)
    batch = mesh_model_batch(cfg, pc, rt.coord)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss, grads = mesh_loss_grads(params, batch, rt, cfg)
    for g in grads:
        all_reduce_(g, rt)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    steps = 2 * pc.cp
    want = expected_launches(steps, steps, MODEL_ROUTES[ARCH, dtype])
    check(launch_counts() == want,
          f"rank {dist.get_rank()} {dtype} model: launched {launch_counts()}"
          f", expected {want}")
    if dist.get_rank() == 0:
        torch.save([g.cpu() for g in grads], tmp / f"b-{dtype}.pt")
    peak = torch.cuda.max_memory_allocated()
    del params, grads
    torch.cuda.empty_cache()
    return {"loss": loss, "ms": ms, "peak": peak}


def mesh_trainer_rank() -> dict:
    """(c) on this rank: ``launch/train.py``'s path for MESH_TRAIN_STEPS
    steps on the (2, 2, 2) grid at depth 2; per-step host milliseconds."""
    from repro_torch.launch import train as launch_train
    argv = ["--arch", ARCH, "--layers", "2", "--hp", "2", "--inner", "2",
            "--seq-len", str(MESH_TRAIN_S), "--global-batch", "1",
            "--steps", str(MESH_TRAIN_STEPS)]
    plan, trainer = launch_train.make_trainer(launch_train.parse_args(argv))
    step_fn, ms = trainer.step_fn, []

    def timed(params, opt_state, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step_fn(params, opt_state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        return out

    trainer.step_fn = timed
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses = trainer.run()
    return {"losses": losses, "step_ms": ms,
            "peak": torch.cuda.max_memory_allocated(),
            "describe": plan.describe(), "launches": launch_counts()}


def mesh_rank(rank: int, world: int, tmp: str):
    """One of phase 9's ranks: gloo by name, every rank on the one card,
    collectives staged through host memory."""
    import datetime

    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tmp = Path(tmp)
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp / "store"), world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=MESH_SECONDS))
    try:
        def note(what):
            if rank == 0:
                free, total = torch.cuda.mem_get_info()
                print(f"    rank 0: {what} done, peak "
                      f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
                      f"allocated, {torch.cuda.memory_reserved() / 2**30:.2f}"
                      f" GiB reserved; the card has "
                      f"{(total - free) / 2**30:.2f} GiB in use by all "
                      "processes", flush=True)

        res = {"attention": {}, "model": {}}
        for i in range(len(MESH_GRIDS)):
            for dtype in MESH_DTYPES:
                res["attention"][i, dtype] = mesh_attention_rank(i, dtype,
                                                                 tmp)
                dist.barrier()
                note(f"(a) {MESH_GRIDS[i]} {dtype}")
        for dtype in ("float32", "bfloat16"):
            res["model"][dtype] = mesh_model_rank(dtype, tmp)
            note(f"(b) {dtype}")
        torch.save(res, tmp / f"rank{rank}-ab.pt")
        mesh_chunk_rank(tmp)
        note("(13d)")
        res = {"trainer": mesh_trainer_rank()}
        note("(c)")
        torch.save(res, tmp / f"rank{rank}-c.pt")
    finally:
        dist.destroy_process_group()


def mesh_spawn(tmp: Path, fn=None, world: int = MESH_WORLD,
               seconds: int = MESH_SECONDS) -> str | None:
    """Run ``fn`` (default ``mesh_rank``) on ``world`` processes, each
    with the expandable-segments allocator (the allocators share the
    card).  Returns None, or what failed: a rank's error or the time
    limit.  Every process is gone on return."""
    import os

    import torch.multiprocessing as mp
    conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        ctx = mp.start_processes(fn or mesh_rank, args=(world, str(tmp)),
                                 nprocs=world, join=False,
                                 start_method="spawn")
    finally:
        if conf is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = conf
    deadline = time.monotonic() + seconds
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                return f"the ranks did not finish in {seconds} s"
    except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
        return f"a rank failed: {e}"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    return None


def mesh_results(tmp: Path, part: str,
                 world: int = MESH_WORLD) -> list | None:
    """Every rank's results of ``part`` ("ab" or "c"), or None where a
    rank did not get that far."""
    paths = [tmp / f"rank{r}-{part}.pt" for r in range(world)]
    if not all(p.exists() for p in paths):
        return None
    return [torch.load(p, weights_only=False) for p in paths]


def norm_rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def mesh_attention_check(tmp: Path, refs: dict, res: list) -> dict:
    """(a): every grid's out and dq / dk / dv, put together from the ranks'
    shards, against one process, norm-relative (fp32 2e-5, bf16 1e-2)."""
    from repro_torch.core.topology import ParallelConfig
    from repro_torch.core.zigzag import from_zigzag
    worst = {}
    for i, (shape, hp, no, wi, placement) in enumerate(MESH_GRIDS):
        pc = ParallelConfig(hp=hp, cp_outer=no, cp_inner=wi,
                            placement=placement)
        for dtype in MESH_DTYPES:
            parts = {}
            for r in range(MESH_WORLD):
                shard = torch.load(mesh_shard_path(tmp, i, dtype, r))
                parts[shard.pop("piece")] = shard
                mesh_shard_path(tmp, i, dtype, r).unlink()
            errs = {}
            for n, want in zip(("out", "dq", "dk", "dv"), refs[shape, dtype]):
                got = torch.cat([parts[p][n] for p in sorted(parts)], dim=1)
                errs[n] = norm_rel(from_zigzag(got, pc.cp), want)
            ms = [r["attention"][i, dtype] for r in res]
            print(f"    (a) {shape} B=1 S={MESH_S} hp={hp} outer={no} "
                  f"inner={wi} {placement} {str(dtype)[6:]}: norm-relative "
                  + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
                  + f" (tol {REL_TOL[dtype]:g}); {ms[0]['launches']} "
                  f"launches of each kernel a rank on {ms[0]['routes']}; "
                  f"per-rank forward ms {[round(m['fwd_ms'], 2) for m in ms]}"
                  f", backward ms {[round(m['bwd_ms'], 2) for m in ms]} "
                  f"(the first call, forward and backward: "
                  f"{[round(m['first_ms'], 1) for m in ms]})")
            check(max(errs.values()) <= REL_TOL[dtype],
                  f"phase 9 (a) {shape} {pc} {dtype} disagrees with one "
                  f"process: {errs}")
            worst[i, dtype] = max(errs.values())
    return worst


def mesh_model_check(tmp: Path, refs: dict, res: list) -> dict:
    """(b): the loss on every rank and the grads summed over ranks against
    one process.  fp32: loss 1e-5 relative, each leaf 1e-4 norm-relative.
    bf16 (phase 6's rule, with one process on the kernels as the
    reference): loss 1e-2; each leaf within 1e-2 of the one-process bf16
    leaf, or no further from it than that leaf lies from the one-process
    fp32 leaf (norm-relative to the fp32 leaf)."""
    def rel(a, b, ref):
        return float((a - b).norm() / ref.norm().clamp_min(1e-30))

    out = {}
    g32 = refs["model", "float32"][1]
    for dtype in ("float32", "bfloat16"):
        loss_ref, g_ref = refs["model", dtype]
        grads = torch.load(tmp / f"b-{dtype}.pt")
        losses = [r["model"][dtype]["loss"] for r in res]
        loss_tol, grad_tol = MODEL_TOL[dtype]
        loss_rel = max(abs(x - loss_ref) / abs(loss_ref) for x in losses)
        leaf = [(rel(a, r, t), rel(r, t, t)) for a, r, t in
                zip(grads, g_ref, g32)]
        worst = max(x[0] for x in leaf)
        ok = all(m <= (grad_tol if dtype == "float32"
                       else max(grad_tol, r32)) for m, r32 in leaf)
        peaks = [r["model"][dtype]["peak"] / 2**30 for r in res]
        print(f"    (b) {ARCH} depth 2 B=1 S={MESH_MODEL_S} (2, 2, 2) "
              f"{dtype}: loss {losses[0]:.6f} on every rank "
              f"{len(set(losses)) == 1}, one process {loss_ref:.6f}: "
              f"relative difference {loss_rel:.3e} (tol {loss_tol:g}); "
              f"worst grad leaf {worst:.3e} over {len(leaf)} leaves "
              f"(tol {grad_tol:g}"
              + ("" if dtype == "float32" else ", or the one-process bf16 "
                 f"leaf's distance from fp32, at most "
                 f"{max(x[1] for x in leaf):.3e}")
              + f"); per-rank ms "
              f"{[round(r['model'][dtype]['ms'], 1) for r in res]}, peak "
              f"GiB {[round(p, 2) for p in peaks]}")
        check(loss_rel <= loss_tol and ok,
              f"phase 9 (b) {dtype}: the mesh disagrees with one process")
        out[dtype] = (loss_rel, worst)
    return out


def mesh_trainer_check(res: list) -> dict:
    """(c): finite losses, the same on every rank, step 0 within 1.5 of
    ln(vocab)."""
    from repro_torch.configs import get_config
    runs = [r["trainer"] for r in res]
    losses = runs[0]["losses"]
    ln_v = float(np.log(get_config(ARCH).vocab))
    print("    " + runs[0]["describe"].replace("\n", "\n    "))
    print(f"    (c) trainer, {MESH_TRAIN_STEPS} steps: losses {losses}; the same on every "
          f"rank {all(r['losses'] == losses for r in runs)}; ln(vocab) "
          f"{ln_v:.4f}; launches a rank {runs[0]['launches']['flash_fwd']} "
          f"forward, {runs[0]['launches']['flash_bwd_dq']} dq, "
          f"{runs[0]['launches']['flash_bwd_dkv']} dk/dv")
    for r, run in enumerate(runs):
        print(f"    (c) rank {r}: step ms "
              f"{[round(x, 1) for x in run['step_ms']]}, peak "
              f"{run['peak'] / 2**30:.2f} GiB")
    check(len(losses) == MESH_TRAIN_STEPS and all(np.isfinite(losses)),
          f"phase 9 (c): losses {losses}")
    check(all(r["losses"] == losses for r in runs),
          "phase 9 (c): the ranks' losses differ")
    check(abs(losses[0] - ln_v) <= 1.5,
          f"phase 9 (c): step 0 loss {losses[0]} is not near ln(vocab)")
    return {"losses": losses, "step_ms": [r["step_ms"] for r in runs],
            "peak": [r["peak"] for r in runs]}


def mesh_phase(smi: str) -> dict:
    """Phase 9: the references in this process, then the eight ranks, then
    the comparisons."""
    import tempfile
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    refs = mesh_references()
    torch.cuda.empty_cache()
    print(f"    one-process references in {time.perf_counter() - t0:.1f} s")
    print(f"    this process holds {torch.cuda.memory_allocated() / 2**30:.2f}"
          " GiB on the card while the ranks run")
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_"))
    try:
        t0 = time.perf_counter()
        failed = mesh_spawn(tmp)
        print(f"    {MESH_WORLD} ranks ran in {time.perf_counter() - t0:.1f}"
              f" s, started included; times below are gloo with host-staged "
              f"collectives, {MESH_WORLD} processes sharing one card ({smi})"
              ", not NCCL figures")
        out = {}
        ab = mesh_results(tmp, "ab")
        if ab is not None:      # (a) and (b) are checked even if (c) failed
            out["attention"] = mesh_attention_check(tmp, refs, ab)
            out["model"] = mesh_model_check(tmp, refs, ab)
        check(failed is None, f"phase 9: {failed}")
        out["trainer"] = mesh_trainer_check(mesh_results(tmp, "c"))
        out["chunk"] = mesh_chunk_check(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# Phase 10: hybrid ZeRO on four ranks that share the card
# ---------------------------------------------------------------------------

ZERO_WORLD = 4
#: (dp, hp, outer, inner), head-first: every ZeRO extent of qwen3-1.7b's
#: large leaves is 4 under dp_sp.
ZERO_GRID = (2, 1, 1, 2)
#: (a): depth 2, fp32, lr 1e-2 (the parameters move), dp_sp against
#: replica; (b): full depth, bf16, phase 7's OptConfig and sequences.
ZERO_LR = dict(lr=1e-2, warmup_steps=1, total_steps=3)
ZERO_MODES_A = ("dp_sp", "replica")
#: (b) against phase 7: each step's loss, and the loss's fall from the
#: first step to the last, within this (absolute).  The fall is about
#: 1.5e-2 and the two runs met within 1.9e-4 on an NVIDIA H100 80GB HBM3
#: at 700 W, so a step that moved the parameters wrongly, or not at all,
#: shows.
ZERO_LOSS_TOL = 2e-3
#: (b): no rank may hold more at its peak (GiB, allocated).
ZERO_PEAK_GIB = 12.0
#: (c): the pinned host <-> device copy, this many bytes, median of 5.
COPY_BYTES = 1 << 30
ZERO_SECONDS = 900


def zero_pc():
    from repro_torch.core.topology import ParallelConfig
    dp, hp, no, wi = ZERO_GRID
    return ParallelConfig(dp=dp, hp=hp, cp_outer=no, cp_inner=wi,
                          placement="head_first")


def zero_trainer(cfg, zero: str, opt: dict, seed: int = 0,
                 steps: int = 3, ckpt_dir=None):
    """``build_plan`` + ``Trainer`` on the phase's grid: ``steps`` steps
    of global batch 2 (one sequence a data rank) at S=4096; with
    ``ckpt_dir``, a checkpoint at step ``ZERO_CKPT_AT``."""
    from repro_torch.core.plan import build_plan
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    plan = build_plan(cfg, zero_pc(), OptConfig(**opt), device="cuda",
                      impl="cuda", zero=zero, seq_len=PROMPT,
                      global_batch=BATCH)
    return plan, Trainer(plan, plan.data_config(PROMPT, BATCH),
                         TrainerConfig(num_steps=steps, seed=seed,
                                       ckpt_dir=ckpt_dir,
                                       ckpt_every=ZERO_CKPT_AT))


def zero_run(plan, trainer) -> dict:
    """Run ``trainer`` with the launch counts set to 0 just before and
    read just after; per-step host ms (synchronised), grad norms, peak
    memory, and this rank's master and moment bytes per leaf.  Each step's
    memory marks, in bytes allocated: at its start, the peak of its
    forward, at the forward's end and the step's peak."""
    from torch.utils._pytree import tree_flatten

    from repro_torch.train import train_step
    step_fn, ms, gnorms, marks = trainer.step_fn, [], [], []
    forward_loss = train_step.forward_loss

    def marked(*a, **kw):
        out = forward_loss(*a, **kw)
        marks[-1].update(fwd_peak=torch.cuda.max_memory_allocated(),
                         fwd_end=torch.cuda.memory_allocated())
        return out

    def timed(params, opt_state, batch):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        marks.append({"start": torch.cuda.memory_allocated()})
        t0 = time.perf_counter()
        out = step_fn(params, opt_state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        marks[-1]["peak"] = torch.cuda.max_memory_allocated()
        gnorms.append(float(out[2]["grad_norm"]))
        return out

    trainer.step_fn = timed
    train_step.forward_loss = marked
    reset_counts()
    try:
        losses = trainer.run()
    finally:
        train_step.forward_loss = forward_loss
    launches = launch_counts()
    trainer.step_fn = step_fn
    leaves = [tree_flatten(t)[0] for t in (trainer.params,
                                           trainer.opt_state["m"],
                                           trainer.opt_state["v"])]
    free, total = torch.cuda.mem_get_info()
    return {"losses": losses, "gnorms": gnorms, "step_ms": ms,
            "peak": max(m["peak"] for m in marks), "marks": marks,
            "card_in_use": total - free, "launches": launches,
            "numel": [[x.numel() for x in t] for t in leaves],
            "extent": [plan.zero.extent(i) for i in range(len(leaves[0]))],
            "full": [math.prod(p.shape) for p in plan.zero.places],
            "describe": plan.describe(), "mem": plan.mem,
            "budget": plan.memory_budget}


def zero_rank(rank: int, world: int, tmp: str):
    """One of phase 10's ranks: gloo by name on the one card, collectives
    staged through host memory.  (a) then (b); results to ``tmp``."""
    import datetime

    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tmp = Path(tmp)
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp / "store"), world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=ZERO_SECONDS))
    try:
        from torch.utils._pytree import tree_flatten

        from repro_torch.core.plan import plan_memory
        from repro_torch.core.zero import gather_params
        res, full = {"a": {}}, None
        cfg_a = dataclasses.replace(model_config(ARCH), num_layers=2,
                                    dtype="float32")
        for mode in ZERO_MODES_A:
            # dp_sp saves at step ZERO_CKPT_AT: phase 12 (c) restores it
            plan, trainer = zero_trainer(
                cfg_a, mode, ZERO_LR,
                ckpt_dir=str(tmp / "ckpt") if mode == "dp_sp" else None)
            res["a"][mode] = zero_run(plan, trainer)
            # every rank gathers (a collective); rank 0 keeps both trees
            params = tree_flatten(gather_params(trainer.params, plan))[0]
            if rank == 0 and full is None:
                full = [x.cpu() for x in params]
            elif rank == 0:
                res["a"]["worst"] = [
                    (float((a.cpu() - b).abs().max()),
                     float(((a.cpu() - b).abs() > 1e-5).float().mean()))
                    for a, b in zip(params, full)]
            del plan, trainer, params
            gc.collect()
            torch.cuda.empty_cache()
        del full
        torch.save(res, tmp / f"rank{rank}-a.pt")
        plan, trainer = zero_trainer(model_config(ARCH), "dp_sp",
                                     dict(lr=3e-4, total_steps=3))
        res = {"b": zero_run(plan, trainer)}
        res["b"]["auto"] = plan_memory(
            plan.cfg, plan.pc, memory_budget_gb=plan.memory_budget / 1e9,
            seq_len=PROMPT, global_batch=BATCH)
        torch.save(res, tmp / f"rank{rank}-b.pt")
        del plan, trainer, res
        gc.collect()
        torch.cuda.empty_cache()
        plan, trainer = zero_trainer(model_config(ARCH), "auto",
                                     dict(lr=3e-4, total_steps=3), steps=1)
        res = {"b2": zero_run(plan, trainer)}
        res["b2"]["mode"] = plan.zero_mode
        torch.save(res, tmp / f"rank{rank}-b2.pt")
    finally:
        dist.destroy_process_group()


def copy_rates() -> dict:
    """(c): the pinned host <-> device copy of ``COPY_BYTES``, each way,
    median of 5 after a warm-up, timed with CUDA events; bytes/s."""
    host = torch.empty(COPY_BYTES, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(COPY_BYTES, dtype=torch.uint8, device="cuda")
    out = {}
    for name, dst, src in (("h2d", dev, host), ("d2h", host, dev)):
        ms = statistics.median(cuda_times(
            lambda: dst.copy_(src, non_blocking=True), reps=5, warmup=1))
        out[name] = COPY_BYTES / (ms * 1e-3)
    del host, dev
    torch.cuda.empty_cache()
    return out


def zero_phase(smi: str, ckpt_dir: Path) -> dict:
    """Phase 10: the four ranks, then their checks, then (c).  (b)'s
    losses are held to phase 7's later (``zero_vs_phase7``).  (a)'s
    dp_sp checkpoint is moved to ``ckpt_dir`` for phase 12 (c)."""
    import tempfile

    from repro_torch.configs import get_config
    gc.collect()
    torch.cuda.empty_cache()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_zero_"))
    try:
        t0 = time.perf_counter()
        failed = mesh_spawn(tmp, zero_rank, ZERO_WORLD, ZERO_SECONDS)
        print(f"    {ZERO_WORLD} ranks ran in {time.perf_counter() - t0:.1f} "
              f"s, started included; times below are gloo with host-staged "
              f"collectives, {ZERO_WORLD} processes sharing one card ({smi})"
              ", not NCCL figures")
        a = mesh_results(tmp, "a", ZERO_WORLD)
        b = mesh_results(tmp, "b", ZERO_WORLD)
        b2 = mesh_results(tmp, "b2", ZERO_WORLD)
        if (tmp / "ckpt").exists():   # phase 12 (c) restores it
            shutil.move(str(tmp / "ckpt"), str(ckpt_dir))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(failed is None and a is not None and b is not None
          and b2 is not None, f"phase 10: {failed}")
    routes = MODEL_ROUTES[ARCH, "float32"]
    for mode in ZERO_MODES_A:
        runs = [r["a"][mode] for r in a]
        r0 = runs[0]
        steps = 2 * zero_pc().cp * 3          # layers x ring steps x steps
        print(f"    (a) {ARCH} depth 2 fp32 zero={mode}: losses "
              f"{r0['losses']}, grad norms "
              f"{[round(x, 6) for x in r0['gnorms']]}; per-rank step ms "
              f"{[[round(x, 1) for x in r['step_ms']] for r in runs]}, peak "
              f"GiB {[round(r['peak'] / 2**30, 2) for r in runs]}")
        check(all(r["losses"] == r0["losses"] for r in runs),
              f"phase 10 (a) {mode}: the ranks' losses differ")
        check(all(r["launches"] == expected_launches(steps, steps, routes)
                  for r in runs),
              f"phase 10 (a) {mode}: launched {r0['launches']}, expected "
              f"{steps} of each on {routes}")
    sharded, replica = a[0]["a"]["dp_sp"], a[0]["a"]["replica"]
    rel = max(abs(x - y) / abs(y) for x, y in zip(sharded["losses"],
                                                   replica["losses"]))
    worst = a[0]["a"]["worst"]
    exact = all(
        all(n * e == f for n, e, f in zip(numel, r["a"]["dp_sp"]["extent"],
                                          r["a"]["dp_sp"]["full"]))
        for r in a for numel in r["a"]["dp_sp"]["numel"])
    quarter = sum(f for f, e in zip(sharded["full"], sharded["extent"])
                  if e == ZERO_WORLD)
    print(f"    (a) dp_sp against replica: losses relative "
          f"{rel:.3e} (tol 1e-5); gathered params: worst |diff| "
          f"{max(w[0] for w in worst):.3e} (tol 2e-3), worst share of a "
          f"leaf over 1e-5 {max(w[1] for w in worst):.2e} (tol 1e-3); "
          f"each rank holds 1/extent of every leaf's masters, m and v: "
          f"{exact}; {quarter} of {sum(sharded['full'])} params on leaves "
          f"of extent {ZERO_WORLD}; master + moment bytes a rank "
          f"{12 * sum(sharded['numel'][0]) / 2**30:.3f} GiB (dp_sp) "
          f"against {12 * sum(replica['numel'][0]) / 2**30:.3f} GiB "
          f"(replica)")
    check(rel <= 1e-5, f"phase 10 (a): losses {sharded['losses']} against "
          f"{replica['losses']}")
    check(all(w[0] <= 2e-3 and w[1] <= 1e-3 for w in worst),
          f"phase 10 (a): gathered params disagree: {worst}")
    check(exact and max(sharded["extent"]) == ZERO_WORLD,
          "phase 10 (a): a rank's shards are not 1/extent of the leaves")
    runs = [r["b"] for r in b]
    r0 = runs[0]
    n_layers = get_config(ARCH).num_layers
    steps = n_layers * zero_pc().cp * 3
    routes = MODEL_ROUTES[ARCH, "bfloat16"]
    auto = r0["auto"]
    print("    " + r0["describe"].replace("\n", "\n    "))
    print(f"    (b) {ARCH} full depth bf16 zero=dp_sp: losses "
          f"{r0['losses']}, grad norms {[round(x, 6) for x in r0['gnorms']]}"
          f"; per-rank step ms "
          f"{[[round(x, 1) for x in r['step_ms']] for r in runs]}; peak "
          f"allocated GiB {[round(r['peak'] / 2**30, 2) for r in runs]}; "
          f"the card {r0['card_in_use'] / 2**30:.2f} GiB in use by all "
          f"processes; plan_memory at this budget "
          f"({r0['budget'] / 1e9:.2f} GB a rank): dp_sp total_dev "
          f"{r0['mem']['total_dev'] / 1e9:.2f} GB (state "
          f"{r0['mem']['state_dev'] / 1e9:.2f}, compute copy "
          f"{r0['mem']['half_dev'] / 1e9:.2f}, activations "
          f"{r0['mem']['act_dev'] / 1e9:.2f}); \"auto\" picks "
          f"{auto[1]} (total_dev {auto[3]['total_dev'] / 1e9:.2f} GB, "
          f"fits {auto[3]['fits']})")
    check(len(r0["losses"]) == 3 and all(np.isfinite(r0["losses"])),
          f"phase 10 (b): losses {r0['losses']}")
    check(all(r["losses"] == r0["losses"] for r in runs),
          "phase 10 (b): the ranks' losses differ")
    check(all(r["launches"] == expected_launches(steps, steps, routes)
              for r in runs),
          f"phase 10 (b): launched {r0['launches']}, expected {steps} of "
          f"each on {routes}")
    peak = max(r["peak"] for r in runs)
    print("    (b) " + zero_memory_items(r0, get_config(ARCH)))
    check(peak <= ZERO_PEAK_GIB * 2**30,
          f"phase 10 (b): a rank peaked at {peak / 2**30:.2f} GiB, above "
          f"{ZERO_PEAK_GIB} GiB")
    runs = [r["b2"] for r in b2]
    r1 = runs[0]
    steps = n_layers * zero_pc().cp
    print(f"    (b') {ARCH} full depth bf16 zero=\"auto\": picks "
          f"{r1['mode']!r} (extent {max(r1['extent'])}); loss "
          f"{r1['losses']}; per-rank step ms "
          f"{[[round(x, 1) for x in r['step_ms']] for r in runs]}; peak "
          f"allocated GiB {[round(r['peak'] / 2**30, 2) for r in runs]} "
          f"against a budget of {r1['budget'] / 2**30:.2f} GiB "
          f"({r1['budget'] / 1e9:.2f} GB) a rank; plan_memory total_dev "
          f"{r1['mem']['total_dev'] / 1e9:.2f} GB; the card "
          f"{r1['card_in_use'] / 2**30:.2f} GiB in use")
    print("    (b') " + zero_memory_items(r1, get_config(ARCH)))
    check(all(r["mode"] == auto[1] for r in runs),
          f"phase 10 (b'): \"auto\" picked {r1['mode']}, plan_memory "
          f"{auto[1]}")
    check(len(r1["losses"]) == 1 and np.isfinite(r1["losses"][0])
          and all(r["losses"] == r1["losses"] for r in runs),
          f"phase 10 (b'): losses {[r['losses'] for r in runs]}")
    check(all(r["launches"] == expected_launches(steps, steps, routes)
              for r in runs),
          f"phase 10 (b'): launched {r1['launches']}, expected {steps} of "
          f"each on {routes}")
    check(all(r["peak"] <= r["budget"] for r in runs),
          "phase 10 (b'): a rank's peak exceeds its budget")
    rates = copy_rates()
    print(f"    (c) pinned copies of {COPY_BYTES / 2**30:.0f} GiB, median of "
          f"5: host to device {rates['h2d'] / 1e9:.2f} GB/s, device to host "
          f"{rates['d2h'] / 1e9:.2f} GB/s ({smi})")
    return {"a": (rel, worst), "b": r0, "c": rates,
            "dp_sp_losses": sharded["losses"]}


def zero_memory_items(r: dict, cfg) -> str:
    """A rank's peak beside ``plan_memory``'s estimate, with the step's
    memory marks (at its start, the forward's end and peak, the step's
    peak; the step whose peak is highest) and the sizes the step holds
    beyond the estimate's state and compute copy: its compute-dtype grad
    shards, the tied table gathered for the forward and its whole grad,
    one layer gathered, and one loss chunk's fp32 logits with their
    compute-dtype grad (the loss's backward)."""
    n = sum(r["numel"][0])
    mem, mark = r["mem"], max(r["marks"], key=lambda m: m["peak"])
    layer = cfg.d_model * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.hd \
        + cfg.n_heads * cfg.hd * cfg.d_model + 3 * cfg.d_model * cfg.d_ff
    chunk = min(cfg.loss_chunk, PROMPT * BATCH // ZERO_WORLD)
    table = 2 * cfg.vocab * cfg.d_model
    items = {"grad shards": 2 * n, "tied table gathered": table,
             "its whole grad": table, "one layer gathered": 2 * layer,
             "a loss chunk's fp32 logits and their bf16 grad":
                 6 * chunk * cfg.vocab}

    def gb(x):
        return f"{x / 1e9:.2f}"

    return (f"peak {gb(r['peak'])} GB ({r['peak'] / 2**30:.2f} GiB) against "
            f"plan_memory's total_dev {gb(mem['total_dev'])} GB (state "
            f"{gb(mem['state_dev'])}, compute copy {gb(mem['half_dev'])}, "
            f"activations {gb(mem['act_dev'])}); measured in the step: "
            f"{gb(mark['start'])} GB at its start (the state, held between "
            f"steps), {gb(mark['fwd_end'])} at the forward's end "
            f"(+{gb(mark['fwd_end'] - mark['start'])}: the compute-dtype "
            f"shards, the tied table, the saved activations), "
            f"{gb(mark['fwd_peak'])} the forward's peak, {gb(mark['peak'])} "
            f"the step's peak (+{gb(mark['peak'] - mark['fwd_end'])} over "
            f"the forward's end); sizes beyond the estimate's state and "
            f"compute copy: " + ", ".join(f"{k} {gb(v)}" for k, v in
                                          items.items()) + " GB")


def zero_vs_phase7(zero: dict, run: dict):
    """(b)'s losses against phase 7's (one device, the same seed,
    OptConfig and two sequences): each, and their fall over the three
    steps, within ``ZERO_LOSS_TOL``."""
    got, want = zero["b"]["losses"], run["losses"]
    diff = max(abs(x - y) for x, y in zip(got, want))
    fall, fall_want = got[0] - got[-1], want[0] - want[-1]
    print(f"    phase 10 (b) against phase 7: losses {got} against {want}, "
          f"worst |diff| {diff:.3e}; fall over the steps {fall:.6f} "
          f"against {fall_want:.6f} (tol {ZERO_LOSS_TOL:g} on both)")
    check(diff <= ZERO_LOSS_TOL and abs(fall - fall_want) <= ZERO_LOSS_TOL,
          "phase 10 (b) disagrees with phase 7")


# ---------------------------------------------------------------------------
# Phase 11: packed documents on one card
# ---------------------------------------------------------------------------

#: (a): one ``PackedLM`` sequence of L=4096, documents of this mean length
#: (``build_plan``'s range around it: 512 to 2048 tokens).
PACKED_MEAN_DOC = 1024


class DocLaunches:
    """Counts the forward launches and the backward pairs that carry a
    doc-start table, while the context is open."""

    def __enter__(self):
        from repro_torch.kernels import flash_attention as fa
        self.fa, self.fwd, self.bwd = fa, 0, 0
        self.real = fa._fwd_cuda, fa._bwd_cuda

        def fwd(*a):
            self.fwd += a[-1] is not None
            return self.real[0](*a)

        def bwd(*a):
            self.bwd += a[-1] is not None
            return self.real[1](*a)

        fa._fwd_cuda, fa._bwd_cuda = fwd, bwd
        return self

    def __exit__(self, *exc):
        self.fa._fwd_cuda, self.fa._bwd_cuda = self.real


def packed_runs(dtype: str) -> dict:
    """Depth-2 qwen3-1.7b at full width in ``dtype``: ``forward_loss`` and
    its grads on one packed sequence of ``build_plan``'s packed source
    (mean document ``PACKED_MEAN_DOC``), its launches (and those with a doc
    table), then the token-weighted sum over its documents of one unpacked
    run each, all on the kernels.  Returns the packed ``(loss, grads)``, the
    summed ``(loss, grads)``, the packed run's launches and the document
    lengths."""
    from torch.utils._pytree import tree_flatten, tree_unflatten

    from repro_torch.configs import get_config
    from repro_torch.core.plan import build_plan
    from repro_torch.models.model import forward_loss, init_params

    cfg = dataclasses.replace(get_config(ARCH), num_layers=2, dtype=dtype)
    plan = build_plan(cfg, device="cuda", impl="cuda", seq_len=PROMPT,
                      global_batch=1, packed=True,
                      mean_doc_len=PACKED_MEAN_DOC)
    data = plan.data_source(PROMPT, 1, seed=1)
    leaves, spec = tree_flatten(
        init_params(cfg, torch.Generator(device="cuda").manual_seed(1)))

    def run(batch):
        xs = [x.detach().requires_grad_() for x in leaves]
        loss, _ = forward_loss(
            tree_unflatten(xs, spec),
            {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()},
            plan.rt, plan.cfg)
        grads = [g.double() for g in torch.autograd.grad(loss, xs)]
        return loss.item(), grads

    reset_counts()
    with DocLaunches() as docs_seen:
        packed = run(data.batch(0))
        torch.cuda.synchronize()
    launches = launch_counts()
    docs = data.documents(0)[0]
    total, loss_sum, grad_sum = 0.0, 0.0, None
    for d in docs:
        n = float((d["labels"] >= 0).sum())
        loss, grads = run({k: d[k][None] for k in ("tokens", "labels",
                                                   "positions")})
        total += n
        loss_sum += n * loss
        grads = [n * g for g in grads]
        grad_sum = grads if grad_sum is None else [
            a.add_(g) for a, g in zip(grad_sum, grads)]
        del grads
    torch.cuda.synchronize()
    return {"packed": packed,
            "indep": (loss_sum / total, [g / total for g in grad_sum]),
            "launches": launches, "doc": (docs_seen.fwd, docs_seen.bwd),
            "lengths": [len(d["tokens"]) for d in docs]}


def packed_check() -> dict:
    """(a): packed against the K independent runs, fp32 then bf16, and the
    launches of each packed run: exactly 2 forward, dq and dk/dv on the
    dtype's route, each with the doc table."""
    def rel(a, b, ref):
        return float((a - b).norm() / ref.norm().clamp_min(1e-300))

    out = {}
    for dtype in ("float32", "bfloat16"):
        r = packed_runs(dtype)
        routes = MODEL_ROUTES[ARCH, dtype]
        check(r["launches"] == expected_launches(2, 2, routes)
              and r["doc"] == (2, 2),
              f"phase 11 (a) {dtype}: the packed run launched "
              f"{r['launches']}, {r['doc']} with a doc table; expected 2 "
              f"of each on {routes}, all with one")
        (lp, gp), (li, gi) = r["packed"], r["indep"]
        loss_rel = abs(lp - li) / abs(li)
        if dtype == "float32":
            grad_rel = [rel(a, b, b) for a, b in zip(gp, gi)]
            ok = loss_rel <= 1e-5 and max(grad_rel) <= 1e-4
            rule = "loss 1e-5 relative, each leaf 1e-4 norm-relative"
            g32 = gi
        else:
            # Phase 6's rule: each leaf within 1e-2 of the bf16 reference
            # (the independent runs), or no further than that reference
            # lies from fp32's, all over the fp32 reference's norm.
            grad_rel = [rel(a, b, t) for a, b, t in zip(gp, gi, g32)]
            own = [rel(b, t, t) for b, t in zip(gi, g32)]
            ok = loss_rel <= 1e-2 and all(
                x <= max(1e-2, o) for x, o in zip(grad_rel, own))
            rule = ("loss 1e-2 relative, each leaf within max(1e-2, the "
                    "bf16 reference's distance from fp32's "
                    f"(at most {max(own):.3e})) norm-relative")
        print(f"    {dtype}: {len(r['lengths'])} documents of "
              f"{r['lengths']} tokens (a pad tail of "
              f"{PROMPT - sum(r['lengths'])}); packed loss {lp:.6f}, K "
              f"independent runs {li:.6f}: relative {loss_rel:.3e}; worst "
              f"grad leaf norm-relative {max(grad_rel):.3e} over "
              f"{len(gp)} leaves ({rule}); launches {r['doc'][0]} forward "
              f"and {r['doc'][1]} dq + dk/dv pairs with the doc table, on "
              f"{routes}")
        check(ok, f"phase 11 (a) {dtype}: packed disagrees with the K "
                  "independent runs")
        out[dtype] = (loss_rel, max(grad_rel))
        del r, gp, gi
        torch.cuda.empty_cache()
    return out


def packed_training(run7: dict) -> tuple:
    """(b): ``launch/train.py``'s path with ``--pack``: finite losses, step
    0 within 1.5 of ln(vocab), every step's launches on the sm90 route
    (as phase 7's); step ms, tokens/s and peak beside phase 7's.  Returns
    the record and the first step's doc table, ``(2, 4096)``."""
    argv = train_argv(ARCH) + ["--pack"]
    print(f"    python -m repro_torch.launch.train {' '.join(argv)}")
    run, trainer = train_phase(argv)
    tcfg, accum = run["plan"].cfg, run["plan"].grad_accum
    losses = run["losses"]
    check(len(losses) == 3 and all(np.isfinite(losses)),
          f"phase 11 (b): losses {losses}")
    check(abs(losses[0] - np.log(tcfg.vocab)) <= 1.5,
          f"phase 11 (b): step-0 loss {losses[0]} is not within 1.5 of "
          f"ln(vocab) = {np.log(tcfg.vocab):.2f}")
    want = expected_launches(tcfg.num_layers * accum,
                             tcfg.num_layers * accum,
                             MODEL_ROUTES[ARCH, "bfloat16"])
    check(all(step == want for step in run["launches"]),
          f"phase 11 (b): launches per step {run['launches']}, expected "
          f"{want}")
    doc = trainer.data.batch(0)["doc_start"].reshape(-1, PROMPT)
    tokens = BATCH * PROMPT
    ms, ms7 = (statistics.median(r["step_ms"][1:]) for r in (run, run7))
    print(f"    losses {[round(x, 6) for x in losses]} (ln vocab "
          f"{np.log(tcfg.vocab):.4f}); step times "
          f"{[round(x, 2) for x in run['step_ms']]} ms; median after 1 "
          f"warm-up {ms:.2f} ms = {tokens * 1e3 / ms:.0f} tokens/s (pad "
          f"included) against phase 7's unpacked {ms7:.2f} ms = "
          f"{tokens * 1e3 / ms7:.0f} tokens/s; peak "
          f"{run['peak'] / 2**30:.2f} GiB against phase 7's "
          f"{run7['peak'] / 2**30:.2f}; first step's documents "
          f"{trainer.data.boundaries(0)}")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return run, torch.as_tensor(doc, device="cuda")


def packed_timings(case, doc_table, phase8: dict) -> dict:
    """(c): one call of each kernel at qwen3-1.7b's training shape in bf16
    (phase 3's train-full operands) with (b)'s first doc table and the
    K-tile skip, beside phase 8's causal times; the bound counts the pairs
    this table leaves visible.  The forward is checked against its plain
    version first."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ops import _fold_chunk_args, _fold_pad

    q, k, v, do, _ = case
    qf, kf, vf, p, band, doc = _fold_chunk_args(q, k, v, causal=True,
                                                q_doc_start=doc_table)
    dof = _fold_pad(do, qf.shape[2])
    out, lse = fa._fwd(qf, kf, vf, p, band=band, doc=doc)
    want, _ = fa._fwd_plain(qf, kf, vf, p, band=band, doc=doc)
    err = float((out.float() - want.float()).norm() / want.float().norm())
    check(err <= REL_TOL[torch.bfloat16],
          f"phase 11 (c): the packed forward lies {err:.3e} from its plain "
          "version")
    dsum = (dof.float() * out.float()).sum(dim=-1)
    n0 = launch_counts()
    t = {"fwd": cuda_ms(lambda: fa._fwd(qf, kf, vf, p, band=band,
                                        doc=doc)),
         "dq": cuda_ms(lambda: fa._dq_cuda(qf, kf, vf, dof, lse, dsum, p,
                                           band, doc)),
         "dkv": cuda_ms(lambda: fa._dkv_cuda(qf, kf, vf, dof, lse, dsum, p,
                                             band, doc))}
    check(launches_since(n0) == expected_launches(
        9, 9, MODEL_ROUTES[ARCH, "bfloat16"]),
          f"phase 11 (c): the timings launched {launches_since(n0)}")
    lq = q.shape[1]
    starts = doc_table.cpu().numpy()
    pairs = sum(int((np.arange(lq) - row + 1).sum()) for row in starts)
    frac = pairs / (q.shape[0] * lq * (lq + 1) // 2)
    bounds = {"fwd": fwd_bound(q, k, torch.bfloat16)[0] * frac,
              "dq": bwd_bound(q, k, 3, torch.bfloat16)[0] * frac,
              "dkv": bwd_bound(q, k, 4, torch.bfloat16)[0] * frac}
    print(f"    one call each (CUDA events, median of 7) at B={q.shape[0]} "
          f"L={lq} Hq={q.shape[2]} Hkv={k.shape[2]} D={q.shape[3]} bf16 "
          f"on (b)'s first doc table ({frac:.3f} of the causal pairs "
          f"visible, the K-tile skip on), forward checked against its "
          f"plain version ({err:.2e} norm-relative): " + "; ".join(
              f"{key} {t[key]:.4f} ms (phase 8 causal {phase8[key]:.4f}; "
              f"bound {bounds[key]:.4f})" for key in t))
    return {"ms": t, "frac": frac, "bound": bounds}


# ---------------------------------------------------------------------------
# Phase 12: checkpoints
# ---------------------------------------------------------------------------

#: (a): ``launch/train.py``'s path at phase 7's shape cut to this depth,
#: this many steps, the interrupted run saving at this step.
CKPT_LAYERS, CKPT_STEPS, CKPT_AT = 4, 4, 2
#: (c): phase 10 (a)'s dp_sp run saves at this step of its three.
ZERO_CKPT_AT = 2
#: (d): the launch that gets SIGTERM: its depth and steps, and how long
#: each launch may take.
PREEMPT_LAYERS, PREEMPT_STEPS, PREEMPT_SECONDS = 2, 8, 300


def ckpt_argv(steps: int, ckpt_dir=None, layers: int = CKPT_LAYERS) -> list:
    """Phase 7's arguments at ``layers`` deep for ``steps`` steps, with a
    checkpoint directory saving every ``CKPT_AT`` steps."""
    argv = train_argv(ARCH)[:-2] + ["--steps", str(steps), "--layers",
                                    str(layers)]
    if ckpt_dir is not None:
        argv += ["--ckpt-dir", str(ckpt_dir), "--save-every", str(CKPT_AT)]
    return argv


def resume_check(tmp: Path) -> dict:
    """(a): two uninterrupted runs (their distance is the tolerance), a
    run stopped after ``CKPT_AT`` steps with a checkpoint there, and a
    fresh trainer that resumes from it and runs the rest."""
    from repro_torch.launch import train as launch_train

    def run(argv, stop=None):
        _, tr = launch_train.make_trainer(launch_train.parse_args(argv))
        start = tr.start_step
        if stop is not None:
            tr.tcfg.num_steps = stop
        losses = tr.run()
        del tr
        gc.collect()
        torch.cuda.empty_cache()
        return start, losses

    t0 = time.perf_counter()
    full = [run(ckpt_argv(CKPT_STEPS))[1] for _ in range(2)]
    apart = max(abs(a - b) for a, b in zip(*full))
    d = tmp / "resume"
    _, first = run(ckpt_argv(CKPT_STEPS, d), stop=CKPT_AT)
    saved = sorted(p.name for p in d.iterdir())
    start, rest = run(ckpt_argv(CKPT_STEPS, d))
    got = first + rest
    diff = max(abs(a - b) for a, b in zip(got, full[0]))
    print(f"    (a) {ARCH} depth {CKPT_LAYERS} bf16 through launch/train.py"
          f" ({' '.join(ckpt_argv(CKPT_STEPS, 'DIR'))}): uninterrupted "
          f"losses {full[0]} and {full[1]} (apart by {apart:.3e}); "
          f"stopped after {CKPT_AT} steps {first}, saved {saved}; resumed "
          f"at step {start}: {rest}; the stitched run lies {diff:.3e} from "
          f"the first uninterrupted one; {time.perf_counter() - t0:.1f} s")
    check(saved == [f"step_{CKPT_AT:08d}"] and start == CKPT_AT,
          f"phase 12 (a): saved {saved}, resumed at {start}")
    check(len(got) == CKPT_STEPS and all(np.isfinite(got))
          and diff <= apart,
          f"phase 12 (a): resumed losses {got} against {full[0]} (the two "
          f"uninterrupted runs lie {apart:.3e} apart)")
    return {"apart": apart, "diff": diff}


def full_depth_save(trainer, tmp: Path) -> dict:
    """(b): one ``save_async`` of phase 7's full-depth trainer state: its
    blocking stall (the pinned buffers' allocation apart from the copy)
    beside ``plan_memory``'s estimate, the write's rate, then the state
    zeroed and restored from the files, bit for bit the snapshot."""
    from torch.utils._pytree import tree_flatten

    from repro_torch import convert
    from repro_torch.runtime.checkpoint import (CheckpointManager,
                                                shard_parts, state_leaves)
    plan = trainer.plan
    need = plan.mem["ckpt_bytes_host"]
    free = shutil.disk_usage(tmp).free
    print(f"    (b) {free / 1e9:.1f} GB free under {tmp}; the checkpoint "
          f"needs {need / 1e9:.2f} GB")
    check(free > 1.2 * need, f"phase 12 (b): {free / 1e9:.1f} GB free, "
          f"{need / 1e9:.2f} GB needed")
    d = tmp / "full"
    mgr = CheckpointManager(str(d), plan=plan, keep=1)
    state = trainer._state()
    step = trainer.opt_state["step"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.save_async(state, step)
    t1 = time.perf_counter()
    mgr.flush()
    t2 = time.perf_counter()
    snap = dict(mgr.last_snapshot)
    files = list((d / f"step_{step:08d}").iterdir())
    nbytes = sum(p.stat().st_size for p in files)
    leaves = [x for x in tree_flatten([trainer.params, trainer.opt_state["m"],
                                       trainer.opt_state["v"]])[0]]
    with torch.no_grad():
        for x in leaves:
            x.zero_()
    trainer.opt_state["step"] = 0
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    mgr.restore(state)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    trees = {"params": tree_flatten(trainer.params)[0],
             "m": tree_flatten(trainer.opt_state["m"])[0],
             "v": tree_flatten(trainer.opt_state["v"])[0]}
    refs, leaves = convert.ref_leaf_map(plan.cfg), state_leaves(plan)
    same = trainer.opt_state["step"] == step
    for n, buf in mgr._buffers.items():       # the snapshot, leaf by leaf
        for slot, i in shard_parts(leaves[n], 0, plan):
            x = trees[leaves[n].tree][i]
            want = buf if slot is None else buf[slot]
            same = same and torch.equal(x.t() if refs[i].transposed else x,
                                        want.to(x.device))
    out = {"stall_s": t1 - t0, "alloc_s": snap["alloc_s"],
           "copy_s": snap["copy_s"], "bytes": snap["bytes"],
           "predicted_s": plan.mem["ckpt_stall_s"], "write_s": t2 - t1,
           "file_bytes": nbytes, "restore_s": t4 - t3}
    print(f"    (b) {ARCH} full depth, one card: save_async of "
          f"{snap['bytes'] / 1e9:.2f} GB (masters and both moments; "
          f"plan_memory's ckpt_bytes_host {need / 1e9:.2f} GB) blocked "
          f"{out['stall_s']:.3f} s: pinned buffers allocated in "
          f"{out['alloc_s']:.3f} s (once; later saves reuse them), the "
          f"device -> host copy {out['copy_s']:.3f} s = "
          f"{snap['bytes'] / out['copy_s'] / 1e9:.2f} GB/s against "
          f"plan_memory's ckpt_stall_s {out['predicted_s']:.3f} s; the "
          f"writer thread wrote {len(files)} files, {nbytes / 1e9:.2f} GB, "
          f"in {out['write_s']:.2f} s after it returned = "
          f"{nbytes / out['write_s'] / 1e9:.2f} GB/s (to the page cache "
          f"and disk of {tmp}); restore into the zeroed state "
          f"{out['restore_s']:.2f} s (warm read), bit for bit the "
          f"snapshot: {same}")
    check(same, "phase 12 (b): the restored state is not the snapshot")
    del mgr
    gc.collect()
    shutil.rmtree(d, ignore_errors=True)
    return out


def elastic_check(ckpt_dir: Path, zero_losses: list) -> dict:
    """(c): phase 10 (a)'s four ranks saved their dp_sp run at step
    ``ZERO_CKPT_AT``; one process on the card restores it and runs the
    rest, within 1e-5 of the four ranks' losses."""
    from repro_torch.core.plan import build_plan
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = dataclasses.replace(model_config(ARCH), num_layers=2,
                              dtype="float32")
    plan = build_plan(cfg, opt=OptConfig(**ZERO_LR), device="cuda",
                      impl="cuda", seq_len=PROMPT, global_batch=BATCH)
    t0 = time.perf_counter()
    tr = Trainer(plan, plan.data_config(PROMPT, BATCH),
                 TrainerConfig(num_steps=3, ckpt_dir=str(ckpt_dir)))
    restore_s = time.perf_counter() - t0
    man = tr.ckpter.manifest()
    losses = tr.run()
    want = zero_losses[ZERO_CKPT_AT:]
    diff = max(abs(a - b) for a, b in zip(losses, want))
    shards = max(e["shards"] for e in man["leaves"])
    print(f"    (c) phase 10 (a)'s dp_sp checkpoint (plan {man['plan']}, "
          f"{sum(e['shards'] for e in man['leaves'])} shard files, at most "
          f"{shards} a leaf, {man['bytes_per_host'] / 1e9:.3f} GB a rank): "
          f"one process resumed at step {tr.start_step} (trainer built and "
          f"restored in {restore_s:.2f} s), losses {losses} against the four"
          f" ranks' {want}: |diff| {diff:.3e} (tol 1e-5)")
    check(tr.start_step == ZERO_CKPT_AT and shards > 1
          and man["plan"]["zero_extent"] == ZERO_WORLD,
          f"phase 12 (c): start {tr.start_step}, manifest {man['plan']}")
    check(len(losses) == len(want) and diff <= 1e-5,
          f"phase 12 (c): {losses} against {want}")
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return {"diff": diff}


def preempt_check(tmp: Path) -> dict:
    """(d): SIGTERM to a ``launch/train.py`` process once it has logged
    step 0: it exits 0 with a checkpoint at the next step boundary, and a
    relaunch resumes there."""
    import os
    import queue
    import signal
    import threading
    d = tmp / "preempt"
    argv = [sys.executable, "-m", "repro_torch.launch.train"] + ckpt_argv(
        PREEMPT_STEPS, d, PREEMPT_LAYERS)[:-2] + ["--save-every", "1000"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.Popen(argv, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines: queue.Queue = queue.Queue()
    reader = threading.Thread(
        target=lambda: [lines.put(x) for x in proc.stdout], daemon=True)
    reader.start()
    out, signalled = [], None
    try:
        deadline = time.monotonic() + PREEMPT_SECONDS
        while signalled is None and time.monotonic() < deadline:
            try:
                line = lines.get(timeout=1)
            except queue.Empty:
                if proc.poll() is not None:
                    break
                continue
            out.append(line)
            if "step 0 loss" in line:
                proc.send_signal(signal.SIGTERM)
                signalled = time.perf_counter() - t0
        rc = proc.wait(timeout=max(deadline - time.monotonic(), 1))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    reader.join(timeout=10)
    while not lines.empty():
        out.append(lines.get())
    text = "".join(out)
    saved = sorted(p.name for p in d.iterdir()) if d.exists() else []
    at = [int(x) for x in re.findall(r"checkpoint at step (\d+)", text)]
    print(f"    (d) {' '.join(argv[1:])}: SIGTERM {signalled and round(signalled, 1)}"
          f" s after the start (once step 0 was logged); exit code {rc}; "
          f"it saved {saved} (logged: step {at})")
    check(signalled is not None and rc == 0 and len(at) == 1
          and saved == [f"step_{at[0]:08d}"] and 0 < at[0] < PREEMPT_STEPS,
          f"phase 12 (d): rc {rc}, saved {saved}; output:\n{text[-3000:]}")
    res = subprocess.run(argv, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=PREEMPT_SECONDS)
    starts = re.findall(r"start step: (\d+)", res.stdout)
    losses = re.findall(r"losses: \[(.*)\]", res.stdout)
    n = len(losses[0].split(",")) if losses and losses[0] else 0
    print(f"    (d) the relaunch: exit code {res.returncode}, start step "
          f"{starts}, {n} steps; {time.perf_counter() - t0:.1f} s for both")
    check(res.returncode == 0 and starts == [str(at[0])]
          and n == PREEMPT_STEPS - at[0],
          f"phase 12 (d): the relaunch: rc {res.returncode}, starts "
          f"{starts}, {n} losses; stderr:\n{res.stderr[-3000:]}")
    shutil.rmtree(d, ignore_errors=True)
    return {"at": at[0], "signalled_s": signalled}


# ---------------------------------------------------------------------------
# Phase 13: the FPDT chunk pipeline
# ---------------------------------------------------------------------------

#: (a): qwen3-1.7b's attention at B=1, 16 / 8 heads, D 128, in C chunks;
#: bf16 at CHUNK_S, fp32 at CHUNK_S32.
CHUNK_S, CHUNK_S32, CHUNK_C = 32768, 8192, 4
#: Document starts as fractions of the sequence: every boundary but the
#: first falls inside a chunk, so documents straddle the chunk edges.
CHUNK_DOC_AT = (0.0, 0.18, 0.43, 0.61, 0.79, 0.93)
#: (d): phase 9's (2, 2, 2) head-first ranks, fp32, this sequence, in
#: this many chunks.
MESH_CHUNK_S, MESH_CHUNK_C = 8192, 2


def chunk_doc(s: int):
    """A ``(1, s)`` doc-start table on the card: documents starting at
    ``CHUNK_DOC_AT`` of ``s``."""
    starts = [int(f * s) for f in CHUNK_DOC_AT]
    lengths = np.diff(starts + [s])
    return torch.as_tensor(np.repeat(starts, lengths)[None],
                           dtype=torch.int32, device="cuda")


def chunk_inputs(s: int, dtype) -> list:
    """q, k, v and dO at qwen3-1.7b's attention shape, from a seed."""
    hq, hkv, d, _, _ = MESH_SHAPES[ARCH]
    gen = torch.Generator(device="cuda").manual_seed(27)
    return [torch.randn(sh, generator=gen, device="cuda").to(dtype)
            for sh in ((1, s, hq, d), (1, s, hkv, d), (1, s, hkv, d),
                       (1, s, hq, d))]


def chunk_budget(q, k, chunks: int) -> int:
    """The double-buffer schedule's device bytes: a chunk of q, dO and out
    and its fp32 lse, beside two chunks each of k and v."""
    sc = q.shape[1] // chunks
    qb = q[:, :sc].numel() * q.element_size()
    kb = k[:, :sc].numel() * k.element_size()
    lse = q.shape[0] * q.shape[2] * sc * 4
    return 3 * qb + lse + 4 * kb


def chunk_case(s: int, dtype, with_doc: bool) -> dict:
    """(a)-(c) at one shape: the resident op with autograd, then the chunk
    pipeline under a manager whose budget is the double-buffer schedule's,
    its launches counted a call; both timed."""
    from repro_torch.core.attention2d import (Attn2DConfig, ChunkedAttention,
                                              attention_2d)
    from repro_torch.runtime.offload import OffloadManager
    q, k, v, do = chunk_inputs(s, dtype)
    doc = chunk_doc(s) if with_doc else None
    cfg = Attn2DConfig(impl="cuda")
    routes = routes_of(dtype, 128)
    pairs = CHUNK_C * (CHUNK_C + 1) // 2

    def resident():
        x = [t.detach().requires_grad_() for t in (q, k, v)]
        out = attention_2d(*x, cfg=cfg, doc_start=doc)
        return [out.detach(), *torch.autograd.grad(out, x, do)]

    want = resident()
    mgr = OffloadManager(budget_bytes=chunk_budget(q, k, CHUNK_C))

    def chunked():
        ca = ChunkedAttention(cfg, chunks=CHUNK_C, offload=mgr)
        out = ca.forward(q, k, v, doc_start=doc)
        return [out, *ca.vjp(do)]

    reset_counts()
    ca = ChunkedAttention(cfg, chunks=CHUNK_C, offload=mgr)
    out = ca.forward(q, k, v, doc_start=doc)
    torch.cuda.synchronize()
    fwd = launch_counts()
    got = [out, *ca.vjp(do)]
    torch.cuda.synchronize()
    total = launch_counts()
    check(fwd == expected_launches(pairs, 0, routes)
          and total == expected_launches(pairs, pairs, routes),
          f"phase 13 (b) S={s} {dtype}: launched {fwd} then {total}, "
          f"expected {pairs} of each on {routes}")
    names = ("out", "dq", "dk", "dv")
    if dtype == torch.float32:
        errs = {n: float((g.double() - w.double()).abs().max())
                for n, g, w in zip(names, got, want)}
        atol, rtol = BWD_TOL[torch.float32]
        ok = errs["out"] <= TOL[torch.float32] and all(
            torch.allclose(g, w, atol=atol, rtol=rtol)
            for g, w in zip(got[1:], want[1:]))
        rule = (f"max |err|: out tol {TOL[torch.float32]:g}, grads allclose"
                f" atol {atol:g} rtol {rtol:g}")
    else:
        errs = {n: norm_rel(g, w) for n, g, w in zip(names, got, want)}
        ok = max(errs.values()) <= 2e-2
        rule = "norm-relative, tol 2e-2"
    stats = mgr.stats()
    del got, want, out, ca
    torch.cuda.empty_cache()

    def host_ms(fn, reps=3):
        times = []
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times[1:])

    t_chunk, t_res = host_ms(chunked), host_ms(resident)
    # Where one call's host time goes: each manager method's seconds
    # (``put`` and ``accumulate`` block until their copy is home, so they
    # also wait for the kernels queued before them), and a profiled call.
    spent = {}
    for name in ("put", "accumulate", "prefetch", "get", "release"):
        real = getattr(mgr, name)

        def timed(*a, _real=real, _name=name):
            t0 = time.perf_counter()
            out = _real(*a)
            spent[_name] = spent.get(_name, 0.0) + time.perf_counter() - t0
            return out
        setattr(mgr, name, timed)
    chunked()
    torch.cuda.synchronize()
    for name in spent:
        delattr(mgr, name)
    prof = profile_call(chunked, top=4)[0] if not with_doc else None
    return {"errs": errs, "ok": ok, "rule": rule, "stats": stats,
            "budget": mgr.budget_bytes, "launches": total, "ms": t_chunk,
            "resident_ms": t_res, "routes": routes,
            "spent_ms": {k: v * 1e3 for k, v in spent.items()},
            "profile": prof}


def h2d_rate(dtype=torch.bfloat16) -> float:
    """The manager's host -> device path on one k chunk of (a)'s bf16
    shape (``put``, then ``prefetch`` + ``get`` and a sync, host clock),
    median of 5; bytes/s."""
    from repro_torch.runtime.offload import OffloadManager
    hkv, d = MESH_SHAPES[ARCH][1], MESH_SHAPES[ARCH][2]
    x = torch.randn(1, CHUNK_S // CHUNK_C, hkv, d, device="cuda").to(dtype)
    mgr = OffloadManager()
    mgr.put("k", x)
    times = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.prefetch("k")
        mgr.get("k")
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        mgr.release("k")
    return x.numel() * x.element_size() / statistics.median(times[1:])


def chunk_phase(smi: str) -> dict:
    """Phase 13 (a)-(c) on one card."""
    from repro_torch.core.plan import OFFLOAD_WIRE_BYTES_PER_S
    out = {}
    for s, dtype in ((CHUNK_S, torch.bfloat16), (CHUNK_S32, torch.float32)):
        for with_doc in (False, True):
            t0 = time.perf_counter()
            r = chunk_case(s, dtype, with_doc)
            st = r["stats"]
            tag = "bf16" if dtype == torch.bfloat16 else "fp32"
            print(f"    (a) B=1 S={s} 16 / 8 heads D 128 {tag} C={CHUNK_C}"
                  f"{' with a doc table across the chunk edges' if with_doc else ''}"
                  f": against the resident attention_2d "
                  + ", ".join(f"{n} {e:.3e}" for n, e in r["errs"].items())
                  + f" ({r['rule']}); (b) launches a call "
                  f"{ {k: v for k, v in r['launches'].items() if v} } on "
                  f"{r['routes']}; (c) stalls {st['stalls']}, waits "
                  f"{st['waits']}, peak device {st['peak_device_bytes'] / 1e6:.2f}"
                  f" MB within the double-buffer budget "
                  f"{r['budget'] / 1e6:.2f} MB, h2d "
                  f"{st['h2d_bytes'] / 1e9:.3f} GB, d2h "
                  f"{st['d2h_bytes'] / 1e9:.3f} GB; forward + vjp "
                  f"{r['ms']:.2f} ms against the resident forward + backward"
                  f" {r['resident_ms']:.2f} ms (host clock, synced, median "
                  f"of 3); host ms in the manager's methods (one call): "
                  + ", ".join(f"{k} {v:.1f}" for k, v in
                              r["spent_ms"].items())
                  + (f"; profiled: {r['profile']}" if r["profile"] else "")
                  + f"; {time.perf_counter() - t0:.1f} s ({smi})")
            check(r["ok"], f"phase 13 (a) S={s} {tag} doc={with_doc}: "
                  f"{r['errs']}")
            check(st["stalls"] == 0
                  and st["peak_device_bytes"] <= r["budget"],
                  f"phase 13 (c) S={s} {tag}: {st} against the budget "
                  f"{r['budget']}")
            out[s, tag, with_doc] = r
    rate = h2d_rate()
    print(f"    (c) the manager's host -> device copy of one bf16 k chunk "
          f"({CHUNK_S // CHUNK_C} x 8 x 128): {rate / 1e9:.2f} GB/s (median"
          f" of 5, host clock) against plan_memory's "
          f"OFFLOAD_WIRE_BYTES_PER_S {OFFLOAD_WIRE_BYTES_PER_S / 1e9:.2f} "
          f"GB/s")
    out["h2d"] = rate
    return out


def mesh_chunk_rank(tmp: Path) -> dict:
    """Phase 13 (d) on this rank of phase 9's (2, 2, 2) head-first grid:
    the resident op (its zigzag shard) and the chunk pipeline (its pieces
    of the chunks) on the fp32 inputs with a doc table; written to
    ``tmp``."""
    import torch.distributed as dist

    from repro_torch.core.attention2d import (attention_2d, attn2d_config,
                                              chunked_attention_2d,
                                              to_chunk_layout)
    from repro_torch.core.runtime import world_runtime
    from repro_torch.core.topology import ParallelConfig, seq_slice
    from repro_torch.core.zigzag import to_zigzag
    from repro_torch.runtime.offload import OffloadManager
    pc = ParallelConfig(hp=2, cp_outer=2, cp_inner=2)
    rt = world_runtime(pc, impl="cuda", device="cuda")
    cfg = attn2d_config(pc, impl="cuda")
    q, k, v, do = chunk_inputs(MESH_CHUNK_S, torch.float32)
    doc = chunk_doc(MESH_CHUNK_S)
    piece = seq_slice(pc, rt.coord, MESH_CHUNK_S)
    x = [to_zigzag(t, pc.cp)[:, piece].contiguous() for t in (q, k, v)]
    x = [t.requires_grad_() for t in x]
    res = attention_2d(*x, cfg=cfg, rt=rt,
                       doc_start=to_zigzag(doc, pc.cp)[:, piece].contiguous())
    resident = [res.detach(), *torch.autograd.grad(
        res, x, to_zigzag(do, pc.cp)[:, piece].contiguous())]
    lay = lambda t: to_chunk_layout(t, MESH_CHUNK_C, pc, rt.coord)  # noqa
    mgr = OffloadManager()
    reset_counts()
    out, vjp = chunked_attention_2d(lay(q), lay(k), lay(v), cfg=cfg,
                                    chunks=MESH_CHUNK_C, rt=rt,
                                    doc_start=lay(doc), offload=mgr)
    chunked = [out, *vjp(lay(do))]
    torch.cuda.synchronize()
    launches = launch_counts()
    torch.save({"coord": rt.coord, "resident": [t.cpu() for t in resident],
                "chunked": [t.cpu() for t in chunked], "stats": mgr.stats(),
                "launches": launches},
               tmp / f"chunk-rank{dist.get_rank()}.pt")
    del q, k, v, do, x, res, resident, out, chunked
    torch.cuda.empty_cache()
    return {}


def mesh_chunk_check(tmp: Path) -> dict:
    """Phase 13 (d): the chunked op and the resident one, each put
    together from the eight ranks, norm-relative within phase 9's fp32
    bound; no rank stalled; each rank launched ``n_out * w`` kernels of
    each kind a chunk pair."""
    from repro_torch.core.attention2d import from_chunk_layout
    from repro_torch.core.topology import ParallelConfig
    from repro_torch.core.zigzag import from_zigzag
    pc = ParallelConfig(hp=2, cp_outer=2, cp_inner=2)
    res = [torch.load(tmp / f"chunk-rank{r}.pt", weights_only=False)
           for r in range(MESH_WORLD)]
    order = sorted(res, key=lambda r: (r["coord"].outer, r["coord"].inner,
                                       r["coord"].head))
    errs = {}
    for n, name in enumerate(("out", "dq", "dk", "dv")):
        chunked = from_chunk_layout([(r["coord"], r["chunked"][n])
                                     for r in res], MESH_CHUNK_C, pc)
        resident = from_zigzag(torch.cat([r["resident"][n] for r in order],
                                         dim=1), pc.cp)
        errs[name] = norm_rel(chunked, resident)
    pairs = MESH_CHUNK_C * (MESH_CHUNK_C + 1) // 2
    want = expected_launches(pairs * pc.cp, pairs * pc.cp,
                             routes_of(torch.float32, 128))
    stalls = [r["stats"]["stalls"] for r in res]
    print(f"    [13] (d) the chunk pipeline on phase 9's (2, 2, 2) "
          f"head-first ranks, fp32, B=1 S={MESH_CHUNK_S} C={MESH_CHUNK_C} "
          f"with a doc table across the chunk edge, against the resident "
          f"op: norm-relative " + ", ".join(f"{n} {e:.3e}" for n, e in
                                             errs.items())
          + f" (tol {REL_TOL[torch.float32]:g}); stalls {stalls}; "
          f"launches a rank {res[0]['launches']}")
    check(max(errs.values()) <= REL_TOL[torch.float32],
          f"phase 13 (d): the chunked op disagrees: {errs}")
    check(all(s == 0 for s in stalls)
          and all(r["launches"] == want for r in res),
          f"phase 13 (d): stalls {stalls}, launches "
          f"{[r['launches'] for r in res]}, expected {want}")
    return errs


# ---------------------------------------------------------------------------
# Phase 14: the MoE family (qwen3-moe-30b-a3b)
# ---------------------------------------------------------------------------

#: (d) and (e): four gloo ranks on the card, (dp, hp, outer, inner) =
#: MOE_GRID (EP = 4: 32 experts a rank), B=1, S=MOE_S.
MOE_WORLD = 4
MOE_GRID = (1, 2, 1, 2)
MOE_S = 4096
MOE_SECONDS = 600
#: (d)'s loss is sum(y * w) + MOE_AUX_SCALE * aux, so the aux's grads show
#: beside those of the product.
MOE_AUX_SCALE = 1e3
#: (d)'s bounds, phase 9's: y and the aux norm-relative (fp32 2e-5, bf16
#: 1e-2), each grad leaf norm-relative (fp32 1e-4, bf16 1e-2).
MOE_TOL = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (1e-2, 1e-2)}


def moe_pc():
    from repro_torch.core.topology import ParallelConfig
    dp, hp, no, wi = MOE_GRID
    return ParallelConfig(dp=dp, hp=hp, cp_outer=no, cp_inner=wi,
                          placement="head_first")


def moe_routing_agreement() -> list:
    """(a)'s depth-2 model on the kernels, one forward in fp32 and one in
    bf16 from the same masters and batch: per layer, the share of fp32's
    (token, k) choices that bf16 also makes."""
    from repro_torch.core.runtime import Runtime
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import model as M

    cfg = dataclasses.replace(model_config(MOE), num_layers=2,
                              dtype="float32")
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(1))
    batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=MODEL_L[MOE],
                                   global_batch=1, seed=1)).batch(0)
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
    real, choices = M.moe_apply, []

    def recording(p, x, rt, m, seq_sharded=True):
        logits = x.reshape(-1, x.shape[-1]).float() @ p["router"].float()
        choices.append(logits.topk(m.top_k, dim=-1).indices)
        return real(p, x, rt, m, seq_sharded)

    M.moe_apply = recording
    try:
        with torch.no_grad():
            for dtype in ("float32", "bfloat16"):
                M.forward_loss(params, batch,
                               Runtime(impl="cuda", device="cuda"),
                               dataclasses.replace(cfg, dtype=dtype))
    finally:
        M.moe_apply = real
    check(len(choices) == 4, f"recorded {len(choices)} routings, expected 4")
    return [float((a[:, :, None] == b[:, None, :]).any(-1).float().mean())
            for a, b in zip(choices[:2], choices[2:])]


def moe_drop_shares(trainer) -> list:
    """Each layer's share of dropped (token, k) assignments in one forward
    of ``trainer``'s params on its next batch's first microbatch."""
    from repro_torch.models import moe
    from repro_torch.models.model import forward_loss

    batch = trainer._to_device(trainer.data.batch(trainer.tcfg.num_steps))
    if trainer.plan.grad_accum > 1:
        batch = {k: v[0] for k, v in batch.items()}
    moe.DROPS = []
    try:
        with torch.no_grad():
            forward_loss(trainer.params, batch, trainer.rt, trainer.cfg)
        drops = [(int(d), n) for d, n in moe.DROPS]
    finally:
        moe.DROPS = None
    return [d / n for d, n in drops]


def moe_training() -> dict:
    """(b): ``launch/train.py --arch qwen3-moe-30b-a3b --layers 4`` at
    phase 7's shape (bf16, scpp): 3 finite losses, step 0 within 1.5 of
    ln(vocab), every step's launches exactly 8 forward, dq and dk/dv on
    sm90; step ms, tokens/s, MFU on the active weights, peak memory, each
    layer's share of dropped assignments and one profiled step."""
    argv = train_argv(MOE) + ["--layers", str(MOE_LAYERS)]
    print(f"    (b) python -m repro_torch.launch.train {' '.join(argv)}")
    run, trainer = train_phase(argv)
    tcfg, accum = run["plan"].cfg, run["plan"].grad_accum
    losses = run["losses"]
    check(len(losses) == 3 and all(np.isfinite(losses)),
          f"phase 14 (b): losses {losses}")
    check(abs(losses[0] - np.log(tcfg.vocab)) <= 1.5,
          f"phase 14 (b): step-0 loss {losses[0]} is not within 1.5 of "
          f"ln(vocab) = {np.log(tcfg.vocab):.2f}")
    want = expected_launches(tcfg.num_layers * accum,
                             tcfg.num_layers * accum,
                             MODEL_ROUTES[MOE, "bfloat16"])
    check(all(step == want for step in run["launches"]),
          f"phase 14 (b): launches per step {run['launches']}, expected "
          f"{want}")
    tokens = BATCH * PROMPT
    step_ms = statistics.median(run["step_ms"][1:])
    flops = train_flops(tcfg, PROMPT, tokens)
    drops = moe_drop_shares(trainer)
    batch = trainer._to_device(trainer.data.batch(3))
    prof, _ = profile_call(
        lambda: trainer.step_fn(trainer.params, trainer.opt_state, batch),
        top=12)
    del batch
    print(f"    losses {[round(x, 6) for x in losses]} (ln vocab "
          f"{np.log(tcfg.vocab):.4f}); grad norms "
          f"{[round(x, 6) for x in run['gnorms']]}; launches per step "
          f"{run['launches'][0]}")
    print(f"    step times {[round(x, 2) for x in run['step_ms']]} ms; median "
          f"after 1 warm-up {step_ms:.2f} ms = {tokens * 1e3 / step_ms:.0f} "
          f"tokens/s; {flops / 1e12:.2f} TFLOP a step on the active weights "
          f"= {100 * flops / (step_ms * 1e-3) / PEAK_BF16_FLOPS:.2f}% MFU of "
          f"989 TFLOP/s; peak memory {run['peak'] / 2**30:.2f} GiB")
    print(f"    dropped share of the (token, k) assignments by layer (one "
          f"microbatch of {PROMPT} tokens, capacity factor "
          f"{tcfg.moe.capacity_factor}): {[round(x, 5) for x in drops]}")
    print(f"    training step: {prof}")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return {"run": run, "step_ms": step_ms, "flops": flops, "drops": drops}


def moe_serving() -> dict:
    """(c): greedy fixed-batch serving at depth 4, bf16: 2 prompts of 4096
    tokens, 32 generated; tokens in the vocab, 4 forward launches on sm90
    in the prefill and none in decode; prefill ms and decode ms a step."""
    from repro_torch.configs import get_config
    from repro_torch.core.runtime import Runtime
    from repro_torch.launch import serve
    from repro_torch.models.decode import decode_step, grow_caches, prefill
    from repro_torch.models.model import init_params

    cfg = dataclasses.replace(get_config(MOE), num_layers=MOE_LAYERS)
    rt = Runtime(impl="auto", device="cuda")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         cast=True)
    tokens = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (BATCH, PROMPT)), device="cuda")
    rec = {"prefill_launches": []}
    fns = counted_fns(cfg, rt, rec)
    serve.generate(params, cfg, rt, tokens[:, :256], gen=2, fns=fns)
    rec["prefill_launches"].clear()
    reset_counts()
    out = serve.generate(params, cfg, rt, tokens, gen=GEN, fns=fns)
    torch.cuda.synchronize()
    launches = launch_counts()
    check(rec["prefill_launches"] == [MOE_LAYERS]
          and launches["fwd_sm90"] == launches["flash_fwd"] == MOE_LAYERS
          and launches["flash_bwd_dq"] == launches["flash_bwd_dkv"] == 0,
          f"phase 14 (c): launches {launches}, prefill "
          f"{rec['prefill_launches']}; expected {MOE_LAYERS} forward on sm90")
    check(tuple(out.shape) == (BATCH, GEN)
          and bool(((out >= 0) & (out < cfg.vocab)).all())
          and bool(torch.isfinite(rec["logits"]).all()),
          f"phase 14 (c): tokens {out.shape} outside the vocab or "
          "non-finite logits")
    with torch.inference_mode():
        def run_prefill():
            return prefill(params, {"tokens": tokens}, rt, cfg)

        prefill_ms = cuda_ms(run_prefill, reps=5)
        logits, caches = run_prefill()
        caches = grow_caches(cfg, caches, 1)
        tok = logits[:, -1].argmax(-1)[:, None]
        del logits
        decode_ms = cuda_ms(lambda: decode_step(params, caches, tok, PROMPT,
                                                rt, cfg))
    print(f"    (c) tokens[0, :12] = {out[0, :12].tolist()}; prefill "
          f"{prefill_ms:.4f} ms ({BATCH * PROMPT * 1e3 / prefill_ms:.0f} "
          f"prompt tok/s), decode step at position {PROMPT} "
          f"{decode_ms:.4f} ms ({BATCH * 1e3 / decode_ms:.1f} tok/s at batch "
          f"{BATCH}); launches {rec['prefill_launches']} in the prefill")
    del params, caches, tok
    gc.collect()
    torch.cuda.empty_cache()
    return {"prefill_ms": prefill_ms, "decode_ms": decode_ms}


def moe_layer_rank(rank: int) -> dict:
    """(d) on one rank: ``moe_apply`` at full width on this rank's shard of
    B=1, S=MOE_S, fp32 and bf16, the loss ``sum(y * w)`` summed over the
    world plus ``MOE_AUX_SCALE`` times the aux (a mean over the world), the
    grads summed over the world.  Rank 0 then applies the port's
    ``moe_apply`` on one device to every rank's shard and holds y, the aux
    and the summed grads to it."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core.runtime import (Runtime, all_gather, all_reduce_,
                                          sum_over_world, world_runtime)
    from repro_torch.core.topology import rank_coords, seq_slice
    from repro_torch.models import moe

    pc = moe_pc()
    rt = world_runtime(pc, impl="cuda", device="cuda")
    m = get_config(MOE).moe
    gen = torch.Generator(device="cuda").manual_seed(7)
    base = moe.init_moe(gen, m, device="cuda")
    x = torch.randn((1, MOE_S, m.d_model), generator=gen, device="cuda")
    w = torch.randn((1, MOE_S, m.d_model), generator=gen, device="cuda")
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        leaves = {k: v.detach().to(dtype).requires_grad_()
                  for k, v in base.items()}
        sl = seq_slice(pc, rt.coord, MOE_S)
        moe.DROPS = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y, aux = moe.moe_apply(leaves, x[:, sl].to(dtype), rt, m)
        loss = sum_over_world((y.float() * w[:, sl]).sum(), rt) \
            + MOE_AUX_SCALE * aux
        loss.backward()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        dropped = sum(int(d) for d, _ in moe.DROPS) / (
            sum(n for _, n in moe.DROPS))
        moe.DROPS = None
        grads = {k: all_reduce_(v.grad.float(), rt) for k, v in
                 leaves.items()}
        ys = all_gather(y.detach(), dist.group.WORLD, rt, dim=0)
        res = {"ms": ms, "dropped": dropped, "aux": aux.item()}
        if rank == 0:
            one = Runtime(impl="cuda", device="cuda")
            ref = {k: v.detach().clone().requires_grad_() for k, v in
                   leaves.items()}
            y_err, auxes = [], []
            for r in range(MOE_WORLD):
                sl_r = seq_slice(pc, rank_coords(pc, r), MOE_S)
                y_r, aux_r = moe.moe_apply(ref, x[:, sl_r].to(dtype), one,
                                           m)
                ((y_r.float() * w[:, sl_r]).sum()
                 + MOE_AUX_SCALE * aux_r / MOE_WORLD).backward()
                y_err.append(norm_rel(ys[r:r + 1].float(),
                                      y_r.detach().float()))
                auxes.append(aux_r.item())
            res.update(
                y_err=max(y_err),
                aux_err=abs(res["aux"] - np.mean(auxes)) / np.mean(auxes),
                grad_err={k: norm_rel(grads[k], ref[k].grad.float())
                          for k in grads})
            del ref
        out[dtype] = res
        del leaves, grads, ys, y, aux, loss
        torch.cuda.empty_cache()
    return out


def moe_trainer_rank() -> dict:
    """(e) on one rank: two steps of the mesh trainer at depth 1, full
    width, bf16, under ``dp_sp`` on MOE_GRID, B=1, S=MOE_S."""
    from repro_torch.configs import get_config
    from repro_torch.core.plan import build_plan
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = dataclasses.replace(get_config(MOE), num_layers=1)
    plan = build_plan(cfg, moe_pc(), OptConfig(lr=3e-4, total_steps=2),
                      device="cuda", impl="cuda", zero="dp_sp",
                      seq_len=MOE_S, global_batch=1)
    trainer = Trainer(plan, plan.data_config(MOE_S, 1),
                      TrainerConfig(num_steps=2))
    res = zero_run(plan, trainer)
    return {k: res[k] for k in ("losses", "step_ms", "peak", "launches",
                                "card_in_use", "mem", "budget")}


def moe_rank(rank: int, world: int, tmp: str):
    """One of phase 14's ranks: gloo by name on the one card, host-staged
    collectives; (d), then (e); results to ``tmp``."""
    import datetime

    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tmp = Path(tmp)
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp / "store"), world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=MOE_SECONDS))
    try:
        res = {"layer": moe_layer_rank(rank)}
        gc.collect()
        torch.cuda.empty_cache()
        res["trainer"] = moe_trainer_rank()
        torch.save(res, tmp / f"rank{rank}-moe.pt")
    finally:
        dist.destroy_process_group()


def moe_mesh() -> dict:
    """(d) and (e) on ``MOE_WORLD`` spawned ranks; checks and prints."""
    import tempfile

    from repro_torch.configs import get_config
    with tempfile.TemporaryDirectory(prefix="chip_smoke_moe_") as d:
        tmp = Path(d)
        failed = mesh_spawn(tmp, moe_rank, MOE_WORLD, MOE_SECONDS)
        res = mesh_results(tmp, "moe", MOE_WORLD)
    check(failed is None and res is not None, f"phase 14 (d)/(e): {failed}")
    for dtype, (y_tol, g_tol) in MOE_TOL.items():
        r0 = res[0]["layer"][dtype]
        tag = "fp32" if dtype == torch.float32 else "bf16"
        worst = max(r0["grad_err"].values())
        print(f"    (d) {tag}: y per shard norm-rel {r0['y_err']:.3e} (tol "
              f"{y_tol:g}), aux rel {r0['aux_err']:.3e} (tol {y_tol:g}), "
              f"grads summed over the ranks norm-rel "
              + ", ".join(f"{k} {v:.3e}" for k, v in r0["grad_err"].items())
              + f" (tol {g_tol:g}); dropped shares by rank "
              f"{[round(r['layer'][dtype]['dropped'], 5) for r in res]}; "
              f"forward + backward per rank "
              f"{[round(r['layer'][dtype]['ms'], 1) for r in res]} ms (gloo, "
              "host-staged)")
        check(r0["y_err"] <= y_tol and r0["aux_err"] <= y_tol
              and worst <= g_tol,
              f"phase 14 (d) {tag}: the mesh disagrees with one process")
    losses = [r["trainer"]["losses"] for r in res]
    check(all(len(x) == 2 and all(np.isfinite(x)) for x in losses)
          and all(x == losses[0] for x in losses),
          f"phase 14 (e): losses {losses}")
    check(abs(losses[0][0] - np.log(get_config(MOE).vocab)) <= 1.5,
          f"phase 14 (e): step-0 loss {losses[0][0]} is not near ln(vocab)")
    for r, rr in enumerate(res):
        t = rr["trainer"]
        print(f"    (e) rank {r}: losses {[round(x, 6) for x in t['losses']]}"
              f", steps {[round(x, 1) for x in t['step_ms']]} ms (gloo, "
              f"host-staged), peak {t['peak'] / 2**30:.2f} GiB beside "
              f"plan_memory's {t['mem']['total_dev'] / 1e9:.2f} GB (state "
              f"{t['mem']['state_dev'] / 1e9:.2f} + compute copy "
              f"{t['mem']['half_dev'] / 1e9:.2f} + activations "
              f"{t['mem']['act_dev'] / 1e9:.2f}) of a "
              f"{t['budget'] / 1e9:.2f} GB budget; launches "
              f"{ {k: v for k, v in t['launches'].items() if v} }")
    return res


def sm90_trio_timings(fwd_case, bwd_case, phase: str) -> dict:
    """The sm90 trio on phases 2-3's operands of one bf16 causal shape
    (qwen3-moe's ``moe-full-bf16``, zamba2's ``zamba2-full-bf16``): each
    kernel one call at a time and back to back, beside the plain version,
    SDPA with ``enable_gqa`` (forward; backward alone) and the bounds.
    ``phase`` names the phase in a failure."""
    from repro_torch.kernels import flash_attention as fa

    sdpa = torch.nn.functional.scaled_dot_product_attention
    q, k, v, (qf, kf, vf, p, band, doc) = fwd_case
    t = {}
    n0 = launch_counts()
    t["fwd"] = cuda_ms(lambda: fa._fwd(qf, kf, vf, p, band=band, doc=doc))
    t["fwd_loop"] = statistics.median(cuda_loop_times(
        lambda: fa._fwd(qf, kf, vf, p, band=band, doc=doc)))
    check(launches_since(n0) == expected_launches(112, 0, {"fwd": "sm90"}),
          f"{phase}: the forward timing launched {launches_since(n0)}")
    t["fwd_plain"] = cuda_ms(lambda: fa._fwd_plain(qf, kf, vf, p, band=band,
                                                   doc=doc), reps=5)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    t["fwd_library"] = cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                            enable_gqa=True))
    t["fwd_library_loop"] = statistics.median(cuda_loop_times(
        lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)))
    t["fwd_bound"] = fwd_bound(q, k, torch.bfloat16)
    _, _, _, do, (qf, kf, vf, dof, lse, dsum, p, band, doc) = bwd_case
    n0 = launch_counts()
    t["dq"] = cuda_ms(lambda: fa._dq_cuda(qf, kf, vf, dof, lse, dsum, p,
                                          band, doc))
    t["dkv"] = cuda_ms(lambda: fa._dkv_cuda(qf, kf, vf, dof, lse, dsum, p,
                                            band, doc))
    t["dq_loop"] = statistics.median(cuda_loop_times(
        lambda: fa._dq_cuda(qf, kf, vf, dof, lse, dsum, p, band, doc)))
    t["dkv_loop"] = statistics.median(cuda_loop_times(
        lambda: fa._dkv_cuda(qf, kf, vf, dof, lse, dsum, p, band, doc)))
    check(launches_since(n0) == expected_launches(
        0, 112, {"dq": "sm90", "dkv": "sm90"}),
        f"{phase}: the backward timing launched {launches_since(n0)}")
    out_p, lse_p = fa._fwd_plain(qf, kf, vf, p, band=band, doc=doc)
    t["bwd_plain"] = cuda_ms(lambda: fa._bwd_plain(
        qf, kf, vf, out_p, lse_p, dof, p, band, doc), reps=5)
    del out_p, lse_p
    qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))
    dot = do.transpose(1, 2).contiguous()
    o = sdpa(qg, kg, vg, is_causal=True, enable_gqa=True)

    def grad():
        return torch.autograd.grad(o, (qg, kg, vg), dot, retain_graph=True)

    t["bwd_library"] = statistics.median(cuda_times(grad, reps=21,
                                                    warmup=3))
    t["bwd_library_loop"] = statistics.median(cuda_loop_times(grad))
    del o, qg, kg, vg, dot, qt, kt, vt
    t["dq_bound"] = bwd_bound(q, k, 3, torch.bfloat16)
    t["dkv_bound"] = bwd_bound(q, k, 4, torch.bfloat16)
    print(f"    sm90 at B={q.shape[0]} L={q.shape[1]} Hq={q.shape[2]} "
          f"Hkv={k.shape[2]} D={q.shape[3]} causal bf16: forward "
          f"{t['fwd']:.4f} ms (b2b {t['fwd_loop']:.4f}; bound "
          f"{t['fwd_bound'][0]:.4f}, {t['fwd_bound'][2] / 1e9:.1f} GFLOP; "
          f"plain {t['fwd_plain']:.4f}; sdpa(enable_gqa) "
          f"{t['fwd_library']:.4f}, b2b {t['fwd_library_loop']:.4f}); dq "
          f"{t['dq']:.4f} (b2b {t['dq_loop']:.4f}; bound "
          f"{t['dq_bound'][0]:.4f}), dk/dv {t['dkv']:.4f} (b2b "
          f"{t['dkv_loop']:.4f}; bound {t['dkv_bound'][0]:.4f}); plain "
          f"backward {t['bwd_plain']:.4f}; sdpa(enable_gqa) backward alone "
          f"{t['bwd_library']:.4f}, b2b {t['bwd_library_loop']:.4f}")
    torch.cuda.empty_cache()
    return t


def moe_phase(moe_fwd, moe_bwd) -> dict:
    """Phase 14, (d) and (e) first (their ranks want the card to
    themselves), then the kernels at qwen3-moe's shape, (a), (b), (c)."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    mesh = moe_mesh()
    t_mesh = time.perf_counter()
    kernels = sm90_trio_timings(moe_fwd, moe_bwd, "phase 14")
    print(f"    (a) {MOE} at B=1 L={MODEL_L[MOE]}, depth 2, full width:")
    model = model_check(MOE)
    agree = moe_routing_agreement()
    print(f"    (a) share of fp32's (token, k) routing choices that bf16 "
          f"also makes, by layer: {[round(x, 5) for x in agree]} (bf16 "
          "rounding upstream of the router flips near-tied choices)")
    torch.cuda.empty_cache()
    t_a = time.perf_counter()
    train = moe_training()
    t_b = time.perf_counter()
    serve = moe_serving()
    t_c = time.perf_counter()
    print(f"    phase 14 seconds: {t_c - t0:.1f} ((d)+(e) {t_mesh - t0:.1f}, "
          f"kernel timings and (a) {t_a - t_mesh:.1f}, (b) {t_b - t_a:.1f}, "
          f"(c) {t_c - t_b:.1f})")
    return {"mesh": mesh, "kernels": kernels, "model": model,
            "agree": agree, "train": train, "serve": serve}


# ---------------------------------------------------------------------------
# Phase 15: the SSM and hybrid families (falcon-mamba-7b, zamba2-7b)
# ---------------------------------------------------------------------------

#: (a): the scans at full width, B=1, SCAN_S tokens, fp32, against the
#: step-by-step recurrence, norm-relative (fp32 sums in another order).
SCAN_S = 1024
SCAN_TOL = 2e-5
#: (e): four gloo ranks on the card, (dp, hp, outer, inner) = SSM_GRID
#: (four sequence ranks, head among them), B=1, S=SSM_S, fp32; phase 9's
#: fp32 bounds (y and x's grad 2e-5, each leaf's summed grad 1e-4).
SSM_WORLD = 4
SSM_GRID = (1, 2, 1, 2)
SSM_S = 4096
SSM_SECONDS = 600
SSM_TOL = (2e-5, 1e-4)
#: (d): decode steps after a prefill of PROMPT tokens, held to a prefill
#: of PROMPT + SSM_DECODE (a multiple of both configs' 16-token segment):
#: in bf16 at full depth by the last logits' cosine (bf16 rounds the two
#: paths' different sums apart: 0.9988 at falcon-mamba's 64 layers), in
#: fp32 at the training depth elementwise, by the reference's
#: ``test_decode_matches_incremental_forward`` bounds (atol = rtol = 2e-3).
SSM_DECODE = 16
SSM_COS = 0.995
SSM_FP32_TOL = 2e-3


def ssm_dims(kind: str):
    """The full configs' Mamba1 (falcon-mamba-7b) or Mamba2 (zamba2-7b)
    dims."""
    from repro_torch.configs import get_config
    return get_config(FALCON).ssm1 if kind == "mamba1" \
        else get_config(ZAMBA).ssm2


def scan_inputs(kind: str, gen: torch.Generator, s: int):
    """(a)'s operands at full width, B=1: dt (softplus of N(0, 1)), B and
    C N(0, 1), x N(0, 1), and the config's decay at init (Mamba1: -1 ..
    -16 a channel; Mamba2: -exp(N(0, 1)) a head, its init being -1)."""
    m = ssm_dims(kind)
    n = m.d_state
    if kind == "mamba1":
        width, a = (m.d_inner,), -torch.arange(
            1, n + 1, dtype=torch.float32, device="cuda").repeat(
                m.d_inner, 1)
        x_shape = (1, s, m.d_inner)
    else:
        width = (m.n_heads,)
        a = -torch.exp(torch.randn(m.n_heads, generator=gen, device="cuda"))
        x_shape = (1, s, m.n_heads, m.head_dim)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    dt = torch.nn.functional.softplus(rand(1, s, *width))
    return dt, rand(1, s, n), rand(1, s, n), rand(*x_shape), a


def scan_plain(kind: str, dt, bm, cm, x, a):
    """The recurrence one token at a time: ``(y, h after the last)``."""
    ys, h = [], None
    for t in range(dt.shape[1]):
        if kind == "mamba1":
            u = (dt[:, t] * x[:, t])[..., None] * bm[:, t, None, :]
            dec = torch.exp(dt[:, t, :, None] * a)
            h = u if h is None else dec * h + u
            ys.append(torch.einsum("bdn,bn->bd", h, cm[:, t]))
        else:
            u = (dt[:, t, :, None] * x[:, t])[..., None] \
                * bm[:, t, None, None, :]
            dec = torch.exp(dt[:, t] * a)[..., None, None]
            h = u if h is None else dec * h + u
            ys.append(torch.einsum("bhdn,bn->bhd", h, cm[:, t]))
    return torch.stack(ys, 1), h


def scan_check() -> dict:
    """(a): ``_mamba1_scan`` and ``_mamba2_scan`` at full width against the
    step-by-step recurrence on the same operands: y and the final state
    norm-relative within SCAN_TOL; each one's ms (the scan forward, and
    forward + backward; the recurrence's forward)."""
    from repro_torch.models import ssm

    gen = torch.Generator(device="cuda").manual_seed(5)
    out = {}
    for kind, scan in (("mamba1", ssm._mamba1_scan),
                       ("mamba2", ssm._mamba2_scan)):
        m = ssm_dims(kind)
        # the segment the layer runs (``mamba2_apply``'s closed form takes
        # SSD_SEG tokens)
        seg = m.seg if kind == "mamba1" else max(m.seg, ssm.SSD_SEG)
        dt, bm, cm, x, a = scan_inputs(kind, gen, SCAN_S)
        with torch.no_grad():
            y, h = scan(dt, bm, cm, x, a, seg)
            y_p, h_p = scan_plain(kind, dt, bm, cm, x, a)
            ms = cuda_ms(lambda: scan(dt, bm, cm, x, a, seg), reps=5)
            plain_ms = cuda_ms(lambda: scan_plain(kind, dt, bm, cm, x, a),
                               reps=3, warmup=1)
        y_err, h_err = norm_rel(y, y_p), norm_rel(h, h_p)
        ops = [t.detach().requires_grad_() for t in (dt, bm, cm, x)]
        w = torch.randn(y.shape, generator=gen, device="cuda")

        def fwd_bwd():
            yy, hh = scan(*ops, a, seg)
            torch.autograd.grad((yy * w).sum() + hh.sum(), ops)

        fb_ms = cuda_ms(fwd_bwd, reps=5)
        print(f"    (a) {kind} scan at B=1 S={SCAN_S} width "
              f"{tuple(x.shape[2:])} N={m.d_state} seg {seg} fp32: y "
              f"norm-rel {y_err:.3e}, final state {h_err:.3e} (tol "
              f"{SCAN_TOL:g}) against the recurrence a token at a time; "
              f"scan {ms:.3f} ms, forward + backward {fb_ms:.3f} ms, the "
              f"recurrence {plain_ms:.1f} ms")
        check(y_err <= SCAN_TOL and h_err <= SCAN_TOL,
              f"phase 15 (a): the {kind} scan disagrees with the recurrence")
        out[kind] = dict(y_err=y_err, h_err=h_err, ms=ms, fwd_bwd_ms=fb_ms,
                         plain_ms=plain_ms)
        del dt, bm, cm, x, y, h, y_p, h_p, ops
        torch.cuda.empty_cache()
    return out


def ssm_flops(cfg, seq: int, tokens: int) -> float:
    """Model FLOPs of one training step of an SSM or hybrid config
    (forward + backward = 3 forwards, no recompute): 2 per token per
    matmul weight (the Mamba projections, the conv taps, the shared
    block's weights once an application, the LM head), plus the shared
    block's causal attention products; the scans' elementwise work is
    left out (about 1% of a Mamba1 layer's)."""
    from repro_torch import convert
    from repro_torch.models.model import hybrid_groups

    uses = hybrid_groups(cfg)[0] if cfg.family == "hybrid" else 0
    weights = 0
    for path, shape in convert.port_leaves(cfg):
        if len(shape) < 2 or path[0] == "embed":
            continue
        weights += math.prod(shape) * (uses if path[0] == "shared_attn"
                                       else 1)
    pairs = seq * (seq + 1) // 2
    attn = 4 * cfg.hd * cfg.n_heads * pairs * uses * (tokens // seq)
    return 3 * (2 * weights * tokens + attn)


def ssm_training(arch: str, layers: int, routes: dict | None) -> dict:
    """(b) / (c): ``launch/train.py --arch ARCH --layers N`` at phase 7's
    shape (bf16, scpp): 3 finite losses, step 0 within 1.5 of ln(vocab),
    every step's flash launches those of the shared block's applications
    (none for the SSM family) on ``routes``; step ms, tokens/s, MFU,
    peak memory and one profiled step."""
    from repro_torch.models.model import hybrid_groups

    argv = train_argv(arch) + ["--layers", str(layers)]
    print(f"    python -m repro_torch.launch.train {' '.join(argv)}")
    run, trainer = train_phase(argv)
    tcfg, accum = run["plan"].cfg, run["plan"].grad_accum
    losses = run["losses"]
    check(len(losses) == 3 and all(np.isfinite(losses)),
          f"phase 15 {arch}: losses {losses}")
    check(abs(losses[0] - np.log(tcfg.vocab)) <= 1.5,
          f"phase 15 {arch}: step-0 loss {losses[0]} is not within 1.5 of "
          f"ln(vocab) = {np.log(tcfg.vocab):.2f}")
    uses = hybrid_groups(tcfg)[0] * accum if tcfg.family == "hybrid" else 0
    want = expected_launches(uses, uses, routes or {})
    check(all(step == want for step in run["launches"]),
          f"phase 15 {arch}: launches per step {run['launches']}, expected "
          f"{want}")
    tokens = BATCH * PROMPT
    step_ms = statistics.median(run["step_ms"][1:])
    flops = ssm_flops(tcfg, PROMPT, tokens)
    batch = trainer._to_device(trainer.data.batch(3))
    prof, _ = profile_call(
        lambda: trainer.step_fn(trainer.params, trainer.opt_state, batch),
        top=10)
    del batch
    print(f"    losses {[round(x, 6) for x in losses]} (ln vocab "
          f"{np.log(tcfg.vocab):.4f}); grad norms "
          f"{[round(x, 6) for x in run['gnorms']]}; flash launches per step "
          f"{ {k: v for k, v in run['launches'][0].items() if v} }")
    print(f"    step times {[round(x, 2) for x in run['step_ms']]} ms; median "
          f"after 1 warm-up {step_ms:.2f} ms = {tokens * 1e3 / step_ms:.0f} "
          f"tokens/s; {flops / 1e12:.2f} TFLOP a step = "
          f"{100 * flops / (step_ms * 1e-3) / PEAK_BF16_FLOPS:.2f}% MFU of "
          f"989 TFLOP/s; peak memory {run['peak'] / 2**30:.2f} GiB")
    print(f"    training step: {prof}")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return {"run": run, "step_ms": step_ms, "flops": flops,
            "launches": run["launches"][0]}


def incremental_logits(params, cfg, rt, tokens, frames=None):
    """The last logits of SSM_DECODE decode steps of the known tokens
    after a prefill of all but those, the mean ms of a step, and the last
    logits of a prefill of all of ``tokens`` (over ``frames`` for the
    encoder-decoder family)."""
    from repro_torch.models.decode import decode_step, grow_caches, prefill

    s = tokens.shape[1] - SSM_DECODE
    extra = {} if frames is None else {"frames": frames}
    with torch.inference_mode():
        _, caches = prefill(params, {"tokens": tokens[:, :s], **extra}, rt,
                            cfg)
        caches = grow_caches(cfg, caches, SSM_DECODE)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for i in range(SSM_DECODE):
            logits, caches = decode_step(params, caches,
                                         tokens[:, s + i:s + i + 1], s + i,
                                         rt, cfg)
        t1.record()
        torch.cuda.synchronize()
        del caches
        full, _ = prefill(params, {"tokens": tokens, **extra}, rt, cfg)
    return (logits[:, -1].float(), t0.elapsed_time(t1) / SSM_DECODE,
            full[:, -1].float())


def no_drop(cfg):
    """``cfg`` with an MoE capacity that takes every assignment (E / top_k:
    an expert may take every token).  A prefill of thousands of tokens
    drops the assignments past an expert's capacity (the reference's
    capacity routing, the batch's last tokens first), and a one-token
    decode step never does, so decode equals the incremental forward only
    where the prefill dropped nothing."""
    if cfg.moe is None:
        return cfg
    m = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.n_experts / m.top_k))


def dropped(fn):
    """``fn()`` and the MoE assignments it dropped, summed over its
    ``moe_apply`` calls, with each call's dropped share."""
    from repro_torch.models import moe
    moe.DROPS = []
    try:
        out = fn()
        drops = [(int(d), n) for d, n in moe.DROPS]
    finally:
        moe.DROPS = None
    return out, sum(d for d, _ in drops), [d / n for d, n in drops]


def fp32_incremental(arch: str, layers: int) -> float:
    """(d)'s fp32 check at the training depth: the worst of ``|decode -
    prefill| / (atol + rtol |prefill|)`` over the last logits (at most 1
    passes); an MoE config routes every assignment (``no_drop``)."""
    from repro_torch.configs import get_config
    from repro_torch.core.runtime import Runtime
    from repro_torch.models.model import init_params

    cfg = no_drop(dataclasses.replace(get_config(arch), num_layers=layers,
                                      dtype="float32"))
    gen = torch.Generator(device="cuda").manual_seed(2)
    params = init_params(cfg, gen)
    tokens = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab, (BATCH, PROMPT + SSM_DECODE)), device="cuda")
    frames = (torch.randn((BATCH, cfg.enc_frames, cfg.d_model),
                          generator=gen, device="cuda")
              if cfg.family == "encdec" else None)
    (dec, _, full), n_dropped, _ = dropped(lambda: incremental_logits(
        params, cfg, Runtime(impl="auto", device="cuda"), tokens, frames))
    check(n_dropped == 0, f"{arch}: the fp32 check dropped {n_dropped} MoE "
          "assignments")
    worst = float(((dec - full).abs()
                   / (SSM_FP32_TOL + SSM_FP32_TOL * full.abs())).max())
    print(f"    (d) {arch} at depth {layers} in fp32: {SSM_DECODE} decode "
          f"steps against a prefill of {PROMPT + SSM_DECODE}: max|d| "
          f"{float((dec - full).abs().max()):.3e}, worst share of the "
          f"reference's bound (atol = rtol = {SSM_FP32_TOL:g}) {worst:.3e}")
    check(worst <= 1.0, f"{arch}: fp32 decode strays from the incremental "
          "forward")
    del params
    torch.cuda.empty_cache()
    return worst


def serving(arch: str, layers: int, phase: str, route: str) -> dict:
    """(d): greedy fixed-batch serving at full depth in bf16 through
    ``launch/serve.py``'s ``generate``, 2 prompts of 4096 tokens, 32
    generated: tokens in the vocab, each attention layer's forward
    launched once on ``route`` in the prefill (none for the SSM family;
    the shared block's uses for the hybrid one); prefill ms, decode ms a
    step, peak memory; SSM_DECODE decode steps of known tokens after the
    prefill against a prefill of the longer prompt (the last logits'
    cosine at least SSM_COS, and their argmax); then ``fp32_incremental``
    at depth ``layers``.  For an MoE config the prefill's dropped share of
    the assignments by layer and the decode's cosine at the config's
    capacity are printed, and the decode is checked where no assignment
    is dropped (``no_drop``)."""
    from repro_torch.configs import get_config
    from repro_torch.core.runtime import Runtime
    from repro_torch.launch import serve
    from repro_torch.models.decode import prefill
    from repro_torch.models.model import hybrid_groups, init_params

    cfg = get_config(arch)
    rt = Runtime(impl="auto", device="cuda")
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         cast=True)
    weights = torch.cuda.memory_allocated()
    tokens = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (BATCH, PROMPT + SSM_DECODE)), device="cuda")
    prompt = tokens[:, :PROMPT]
    uses = (hybrid_groups(cfg)[0] if cfg.family == "hybrid" else
            0 if cfg.family == "ssm" else cfg.num_layers)
    rec = {"prefill_launches": []}
    fns = counted_fns(cfg, rt, rec)
    serve.generate(params, cfg, rt, prompt[:, :256], gen=2, fns=fns)
    rec["prefill_launches"].clear()
    reset_counts()
    out = serve.generate(params, cfg, rt, prompt, gen=GEN, fns=fns)
    torch.cuda.synchronize()
    launches = launch_counts()
    check(rec["prefill_launches"] == [uses]
          and launches[f"fwd_{route}"] == launches["flash_fwd"] == uses
          and launches["flash_bwd_dq"] == launches["flash_bwd_dkv"] == 0,
          f"{phase} {arch}: launches {launches}, prefill "
          f"{rec['prefill_launches']}; expected {uses} forward on {route}")
    check(tuple(out.shape) == (BATCH, GEN)
          and bool(((out >= 0) & (out < cfg.vocab)).all())
          and bool(torch.isfinite(rec["logits"]).all()),
          f"{phase} {arch}: tokens {out.shape} outside the vocab or "
          "non-finite logits")
    with torch.inference_mode():
        prefill_ms = cuda_ms(lambda: prefill(params, {"tokens": prompt}, rt,
                                             cfg), reps=3, warmup=0)
    a, decode_ms, b = incremental_logits(params, cfg, rt, tokens)
    peak = torch.cuda.max_memory_allocated()
    cos = torch.nn.functional.cosine_similarity(a, b, dim=-1)
    res = {}
    if cfg.moe is not None:
        with torch.inference_mode():
            _, _, drops = dropped(lambda: prefill(params, {"tokens": prompt},
                                                  rt, cfg))
        res = {"cos_dropping": cos.tolist(), "drops": drops}
        note = (f"; the prefill's dropped share of the MoE assignments by "
                f"layer at capacity factor {cfg.moe.capacity_factor} "
                f"{[round(x, 5) for x in drops]}, and with those drops the "
                f"decode steps give cosine "
                f"{[round(float(c), 6) for c in cos]}")
        (a, _, b), n_dropped, _ = dropped(lambda: incremental_logits(
            params, no_drop(cfg), rt, tokens))
        cos = torch.nn.functional.cosine_similarity(a, b, dim=-1)
        note += (f"; with every assignment routed (capacity factor "
                 f"{no_drop(cfg).moe.capacity_factor:.4f}; {n_dropped} "
                 "dropped)")
        check(n_dropped == 0, f"{phase} {arch}: {n_dropped} dropped")
    else:
        note = ""
    same = (a.argmax(-1) == b.argmax(-1)).tolist()
    print(f"    (d) {arch} at depth {cfg.num_layers}: tokens[0, :8] = "
          f"{out[0, :8].tolist()}; prefill of {BATCH} x {PROMPT} "
          f"{prefill_ms:.2f} ms ({BATCH * PROMPT * 1e3 / prefill_ms:.0f} "
          f"prompt tok/s), decode {decode_ms:.3f} ms a step (mean of "
          f"{SSM_DECODE}); weights {weights / 2**30:.2f} GiB, peak "
          f"{peak / 2**30:.2f} GiB; launches {rec['prefill_launches']} in "
          f"the prefill{note}; {SSM_DECODE} decode steps against a prefill "
          f"of {PROMPT + SSM_DECODE}: cosine "
          f"{[round(float(c), 6) for c in cos]}, argmax equal {same}")
    check(float(cos.min()) >= SSM_COS,
          f"{phase} {arch}: decode strays from the incremental "
          f"forward: cosine {cos.tolist()}")
    del params, a, b
    gc.collect()
    torch.cuda.empty_cache()
    return {"prefill_ms": prefill_ms, "decode_ms": decode_ms, "peak": peak,
            "weights": weights, "cos": cos.tolist(), "argmax_equal": same,
            "launches": launches, "fp32": fp32_incremental(arch, layers),
            **res}


def ssm_pc():
    from repro_torch.core.topology import ParallelConfig
    dp, hp, no, wi = SSM_GRID
    return ParallelConfig(dp=dp, hp=hp, cp_outer=no, cp_inner=wi,
                          placement="head_first")


def ssm_layer_rank(rank: int) -> dict:
    """(e) on one rank: each layer at full width on this rank's piece of
    B=1, S=SSM_S in fp32, ``sum(y * w)`` summed over the world (twice, the
    second timed), the leaves' grads summed over the world; y and x's grad
    gathered.  Rank 0 then
    runs the layer on one device over the whole sequence and holds y, x's
    grad and the summed leaf grads to it."""
    import torch.distributed as dist
    from torch.utils._pytree import tree_flatten, tree_unflatten

    from repro_torch.core.runtime import (Runtime, all_gather, all_reduce_,
                                          sum_over_world, world_runtime)
    from repro_torch.core.topology import rank_coords, seq_slice
    from repro_torch.models import ssm

    pc = ssm_pc()
    rt = world_runtime(pc, impl="cuda", device="cuda")
    sl = seq_slice(pc, rt.coord, SSM_S)
    out = {}
    for kind, init, apply in (("mamba1", ssm.init_mamba1, ssm.mamba1_apply),
                              ("mamba2", ssm.init_mamba2, ssm.mamba2_apply)):
        m = ssm_dims(kind)
        gen = torch.Generator(device="cuda").manual_seed(11)
        base = init(gen, m, device="cuda")
        x = torch.randn((1, SSM_S, m.d_model), generator=gen, device="cuda")
        w = torch.randn((1, SSM_S, m.d_model), generator=gen, device="cuda")
        leaves, spec = tree_flatten(base)
        leaves = [t.requires_grad_() for t in leaves]
        for _ in range(2):                   # the second call is timed
            for t in leaves:
                t.grad = None
            xs = x[:, sl].clone().requires_grad_()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = apply(tree_unflatten(leaves, spec), xs, rt, m)
            sum_over_world((y * w[:, sl]).sum(), rt).backward()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        grads = [all_reduce_(t.grad, rt) for t in leaves]
        ys = all_gather(y.detach(), dist.group.WORLD, rt, dim=1)
        dxs = all_gather(xs.grad, dist.group.WORLD, rt, dim=1)
        res = {"ms": ms}
        if rank == 0:
            ref = [t.detach().clone().requires_grad_() for t in leaves]
            xr = x.clone().requires_grad_()
            yr = apply(tree_unflatten(ref, spec), xr,
                       Runtime(impl="cuda", device="cuda"), m)
            (yr * w).sum().backward()
            order = [seq_slice(pc, rank_coords(pc, r), SSM_S)
                     for r in range(SSM_WORLD)]
            want_y = torch.cat([yr.detach()[:, s] for s in order], 1)
            want_dx = torch.cat([xr.grad[:, s] for s in order], 1)
            res.update(y_err=norm_rel(ys, want_y),
                       dx_err=norm_rel(dxs, want_dx),
                       grad_err=max(norm_rel(g, r.grad)
                                    for g, r in zip(grads, ref)))
            del ref, xr, yr
        out[kind] = res
        del base, leaves, grads, ys, dxs, y, xs
        torch.cuda.empty_cache()
    return out


def ssm_rank(rank: int, world: int, tmp: str):
    """One of phase 15 (e)'s ranks: gloo by name on the one card,
    host-staged collectives; then phase 16 (e)'s whisper layer pair,
    phase 17 (e)'s reduced deepseek-v2-lite on the same grid and phase 18
    (c)'s decode on its grids (the ranks are spawned once for all four);
    results to ``tmp``."""
    import datetime

    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tmp = Path(tmp)
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp / "store"), world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=SSM_SECONDS))
    try:
        res = {"layer": ssm_layer_rank(rank)}
        gc.collect()
        torch.cuda.empty_cache()
        res["encdec"] = encdec_layer_rank(rank)
        gc.collect()
        torch.cuda.empty_cache()
        res["mla"] = mla_layer_rank(rank)
        gc.collect()
        torch.cuda.empty_cache()
        res["serve"] = serve_mesh_rank(rank)
        torch.save(res, tmp / f"rank{rank}-ssm.pt")
    finally:
        dist.destroy_process_group()


def ssm_mesh() -> dict:
    """(e) on ``SSM_WORLD`` spawned ranks; checks and prints."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ssm_") as d:
        tmp = Path(d)
        failed = mesh_spawn(tmp, ssm_rank, SSM_WORLD, SSM_SECONDS)
        res = mesh_results(tmp, "ssm", SSM_WORLD)
    check(failed is None and res is not None, f"phase 15 (e): {failed}")
    y_tol, g_tol = SSM_TOL
    for kind in ("mamba1", "mamba2"):
        r0 = res[0]["layer"][kind]
        print(f"    (e) {kind} at full width on {SSM_WORLD} sequence ranks "
              f"{SSM_GRID}, B=1 S={SSM_S} fp32: y norm-rel "
              f"{r0['y_err']:.3e}, x grad {r0['dx_err']:.3e} (tol "
              f"{y_tol:g}), worst leaf grad summed over the ranks "
              f"{r0['grad_err']:.3e} (tol {g_tol:g}) against one process; "
              f"forward + backward per rank "
              f"{[round(r['layer'][kind]['ms'], 1) for r in res]} ms (gloo, "
              "host-staged)")
        check(r0["y_err"] <= y_tol and r0["dx_err"] <= y_tol
              and r0["grad_err"] <= g_tol,
              f"phase 15 (e) {kind}: the mesh disagrees with one process")
    return res


def ssm_phase(zamba_fwd, zamba_bwd) -> dict:
    """Phase 15, (e) first (its ranks want the card to themselves), then
    (a), the sm90 trio at zamba2's shape, zamba2's depth-2 model check,
    (b), (c) and (d)."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    mesh = ssm_mesh()
    t_e = time.perf_counter()
    scans = scan_check()
    kernels = sm90_trio_timings(zamba_fwd, zamba_bwd, "phase 15")
    print(f"    (c) {ZAMBA} at B=1 L={MODEL_L[ZAMBA]}, depth 2 with the "
          "shared block after each layer, full width:")
    model = model_check(ZAMBA)
    torch.cuda.empty_cache()
    t_a = time.perf_counter()
    print(f"    (b) {FALCON} at depth {FALCON_LAYERS}:")
    falcon = ssm_training(FALCON, FALCON_LAYERS, None)
    t_b = time.perf_counter()
    print(f"    (c) {ZAMBA} at depth {ZAMBA_LAYERS}:")
    zamba = ssm_training(ZAMBA, ZAMBA_LAYERS, MODEL_ROUTES[ZAMBA,
                                                           "bfloat16"])
    t_c = time.perf_counter()
    serve = {arch: serving(arch, layers, "phase 15 (d)", "sm90")
             for arch, layers in ((FALCON, FALCON_LAYERS),
                                  (ZAMBA, ZAMBA_LAYERS))}
    t_d = time.perf_counter()
    print(f"    phase 15 seconds: {t_d - t0:.1f} ((e) {t_e - t0:.1f}, (a), "
          f"the kernel timings and the model check {t_a - t_e:.1f}, (b) "
          f"{t_b - t_a:.1f}, (c) {t_c - t_b:.1f}, (d) {t_d - t_c:.1f})")
    return {"mesh": mesh, "scans": scans, "kernels": kernels, "model": model,
            "falcon": falcon, "zamba": zamba, "serve": serve}


# ---------------------------------------------------------------------------
# Phase 16: the encoder-decoder family (whisper-small) and the last two
# dense configs (chameleon-34b, gemma3-12b)
# ---------------------------------------------------------------------------

#: (a): name -> (b, lq, lk, hq, hkv, d, keyword arguments, V's width), the
#: shapes the new paths give the kernels: whisper's encoder (non-causal), its
#: cross-attention (non-causal, Lq != Lk) and its decoder (causal), one
#: training microbatch each; chameleon-34b's (GQA group 8 at D 128);
#: gemma3-12b's local (window 1024) and global layers (D 240, padded to
#: 256).
ENCDEC_SHAPES = {
    "whisper-enc": (1, WHISPER_F, WHISPER_F, 12, 12, 64,
                    dict(causal=False), 64),
    "whisper-cross": (1, PROMPT, WHISPER_F, 12, 12, 64, dict(causal=False),
                      64),
    "whisper-dec": (1, PROMPT, PROMPT, 12, 12, 64, dict(causal=True), 64),
    "chameleon": (1, PROMPT, PROMPT, 64, 8, 128, dict(causal=True), 128),
    "gemma3-local": (1, PROMPT, PROMPT, 16, 8, 240,
                     dict(causal=True, window=1024), 240),
    "gemma3-global": (1, PROMPT, PROMPT, 16, 8, 240, dict(causal=True), 240),
}


def shape_bound(shape: tuple, key: str, dtype=torch.bfloat16):
    """(bound ms, bound_by, FLOP, FLOP issued) of one kernel (``key`` fwd,
    dq or dkv) at an (a) shape: the visible pairs' products at their true
    widths (QK^T and dQ / dK at D; PV, dP and dV at V's width, whose
    zero-padded columns need no work), 2 FLOPs a column, at 989 TFLOP/s,
    or the bytes it must move (q, k and their grads at D; v, dO and the
    output at V's width, read or written once; lse and dsum) at 3.35
    TB/s; and the FLOPs the kernel issues with every product at D."""
    b, lq, lk, hq, hkv, d, kw, dv = shape
    pairs = visible_pairs(lq, lk, kw["causal"], kw.get("window"),
                          kw.get("mask_offset"))
    widths = {"fwd": (d, dv), "dq": (d, dv, d), "dkv": (d, dv, dv, d)}[key]
    flops = 2 * b * hq * pairs * sum(widths)
    issued = 2 * b * hq * pairs * d * len(widths)
    item = dtype.itemsize
    q, o = b * lq * hq * d * item, b * lq * hq * dv * item
    k, v = b * lk * hkv * d * item, b * lk * hkv * dv * item
    rows = b * hq * lq * 4
    nbytes = {"fwd": q + o + k + v + rows,
              "dq": 2 * q + o + k + v + 2 * rows,
              "dkv": q + o + 2 * k + 2 * v + 2 * rows}[key]
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, issued)


def sdpa_call(q, k, v, kw):
    """SDPA on the (a) case's inputs in its layout (B, H, L, D), V at its
    own width: the causal flag, or a boolean band for a window or a band
    off the diagonal (anchored as the kernels anchor it, or at
    ``mask_offset``); GQA by ``enable_gqa``; the case's scale."""
    sdpa = functools.partial(
        torch.nn.functional.scaled_dot_product_attention,
        enable_gqa=q.shape[1] != k.shape[1], scale=kw.get("scale"))
    lq, lk = q.shape[2], k.shape[2]
    off = kw.get("mask_offset", lk - lq)
    if kw.get("window") or (kw["causal"] and off):
        i = torch.arange(lq, device="cuda")[:, None] + off
        j = torch.arange(lk, device="cuda")[None]
        mask = (j <= i) & (j > i - (kw.get("window") or lk + lq))
        return lambda: sdpa(q, k, v, attn_mask=mask)
    return lambda: sdpa(q, k, v, is_causal=kw["causal"])


def shape_kernels(shapes: dict, gen: torch.Generator, phase: str) -> dict:
    """(a): each shape of ``shapes`` (``ENCDEC_SHAPES``' layout) in fp32
    and bf16 through ``check_kernel`` and ``check_bwd`` (the routes:
    tf32x3 / tf32x3w in fp32, sm90 / sm90w in bf16; phases 2 and 3's
    bounds), v and dO drawn at V's width and zero-padded to D as
    ``mla_apply`` pads them; then in bf16 each kernel's ms one call at a
    time beside its plain version, SDPA on the unpadded V (forward;
    backward alone, from SDPA's own forward) and its bound.  Returns
    ``{name: {...}}`` and the worst errors by route."""
    from repro_torch.kernels import flash_attention as fa

    def rand(*shape, d, dtype):
        x = torch.randn(shape, generator=gen, device="cuda")
        return torch.nn.functional.pad(x, (0, d - shape[-1])).to(dtype)

    out, worst = {}, {}
    for name, shape in shapes.items():
        b, lq, lk, hq, hkv, d, kw, dv = shape
        for dtype in (torch.float32, torch.bfloat16):
            tag = "fp32" if dtype == torch.float32 else "bf16"
            q, k, v, do = (rand(b, lq, hq, d, d=d, dtype=dtype),
                           rand(b, lk, hkv, d, d=d, dtype=dtype),
                           rand(b, lk, hkv, dv, d=d, dtype=dtype),
                           rand(b, lq, hq, dv, d=d, dtype=dtype))
            route, err, lse_err, _ = check_kernel(f"{name}-{tag}", q, k, v,
                                                  kw)
            routes, errs, folded = check_bwd(f"{name}-{tag}", q, k, v, do,
                                             kw)
            d_pad = folded[0].shape[2]
            want = ("sm90" if dtype == torch.bfloat16 else "tf32x3") + (
                "" if d_pad <= 128 else "w")
            check(route == routes["dq"] == routes["dkv"] == want,
                  f"{phase} (a) {name}-{tag}: routes {route}, {routes}; "
                  f"expected {want}")
            for key, e in (("fwd", (err, lse_err)),
                           ("dq", errs["dq"]),
                           ("dkv", tuple(max(a, c) for a, c in
                                         zip(errs["dk"], errs["dv"])))):
                w = worst.setdefault((route if key == "fwd" else
                                      routes[key], key), [0.0, 0.0, 0])
                w[0], w[1], w[2] = max(w[0], e[0]), max(w[1], e[1]), w[2] + 1
            if dtype == torch.float32:
                del q, k, v, do, folded
                torch.cuda.empty_cache()
                continue
            qf, kf, vf, dof, lse, dsum, p, band, doc = folded
            t = {"route": route, "d_pad": d_pad}
            n0 = launch_counts()
            t["fwd"] = cuda_ms(lambda: fa._fwd(qf, kf, vf, p, band=band,
                                               doc=doc))
            t["dq"] = cuda_ms(lambda: fa._dq_cuda(qf, kf, vf, dof, lse,
                                                  dsum, p, band, doc))
            t["dkv"] = cuda_ms(lambda: fa._dkv_cuda(qf, kf, vf, dof, lse,
                                                    dsum, p, band, doc))
            check(launches_since(n0) == expected_launches(9, 9, {
                "fwd": route, **routes}),
                f"{phase} (a) {name}: the timings launched "
                f"{launches_since(n0)}")
            t["fwd_plain"] = cuda_ms(lambda: fa._fwd_plain(
                qf, kf, vf, p, band=band, doc=doc), reps=3)
            out_p, lse_p = fa._fwd_plain(qf, kf, vf, p, band=band, doc=doc)
            t["bwd_plain"] = cuda_ms(lambda: fa._bwd_plain(
                qf, kf, vf, out_p, lse_p, dof, p, band, doc), reps=3)
            del out_p, lse_p
            qt, kt = (x.transpose(1, 2).contiguous() for x in (q, k))
            vt, dot = (x[..., :dv].transpose(1, 2).contiguous()
                       for x in (v, do))
            t["library"] = "sdpa" + (
                " enable_gqa" if hq != hkv else "") + (
                ", a boolean band mask" if kw.get("window") else "") + (
                f", V unpadded ({dv})" if dv != d else "")
            try:
                call = sdpa_call(qt, kt, vt, kw)
                t["fwd_library"] = cuda_ms(call)
                qg, kg, vg = (x.detach().requires_grad_()
                              for x in (qt, kt, vt))
                o = sdpa_call(qg, kg, vg, kw)()
                t["bwd_library"] = cuda_ms(lambda: torch.autograd.grad(
                    o, (qg, kg, vg), dot, retain_graph=True))
                del o, qg, kg, vg
            except RuntimeError as e:        # no SDPA backend takes it
                t["fwd_library"] = t["bwd_library"] = None
                t["library"] += f": none ran ({str(e).splitlines()[0][:80]})"
            for key in ("fwd", "dq", "dkv"):
                t[f"{key}_bound"] = shape_bound(shape, key)
            t["pairs"] = visible_pairs(lq, lk, kw["causal"],
                                       kw.get("window"))
            lib = (f"sdpa ({t['library']}) {t['fwd_library']:.4f} / "
                   f"backward {t['bwd_library']:.4f}"
                   if t["fwd_library"] is not None else
                   f"sdpa: {t['library']}")
            work = {key: f"bound {t[key + '_bound'][0]:.4f}, "
                         f"{t[key + '_bound'][2] / 1e9:.1f} GFLOP" + (
                             f" at the true widths, "
                             f"{t[key + '_bound'][3] / 1e9:.1f} issued"
                             if dv != d else "")
                    for key in ("fwd", "dq", "dkv")}
            print(f"    {name} B={b} Lq={lq} Lk={lk} Hq={hq} Hkv={hkv} "
                  f"D={d}" + (f" (V {dv} padded)" if dv != d else "")
                  + f" {kw} bf16 on {route}: forward {t['fwd']:.4f} ms "
                  f"({work['fwd']}), dq {t['dq']:.4f} ({work['dq']}), "
                  f"dk/dv {t['dkv']:.4f} ({work['dkv']}); plain forward "
                  f"{t['fwd_plain']:.4f}, backward {t['bwd_plain']:.4f}; "
                  f"{lib}; {t['pairs']} visible pairs a head")
            out[name] = t
            del q, k, v, do, qt, kt, vt, dot, folded, qf, kf, vf, dof
            torch.cuda.empty_cache()
    return {"shapes": out, "worst": worst}


def grad_scale(paths: list) -> list:
    """Per leaf, the leaf whose grad norm scales its comparison: itself,
    except a self-attention key bias, whose true grad is zero (the softmax
    ignores a shift of every key, so what is left is rounding): its
    layer's key weight."""
    index = {p: i for i, p in enumerate(paths)}
    return [index[p[:-1] + ("w",)] if p[-3:] == ("attn", "wk", "b") else i
            for i, p in enumerate(paths)]


def whisper_flops(cfg, seq: int, frames: int, batch: int) -> float:
    """Model FLOPs of one whisper training step (forward + backward = 3
    forwards, no recompute): 2 per token per matmul weight (the encoder's
    on the frames; the decoder's self-attention, cross q / o and MLP on
    the tokens, its cross k / v on the frames; the LM head), plus the
    attention products: the encoder's non-causal pairs, the decoder's
    causal ones and the cross pairs."""
    d, f = cfg.d_model, cfg.d_ff
    tokens, n_frames = batch * seq, batch * frames
    enc = cfg.encoder_layers * (4 * d * d + 2 * d * f) * n_frames
    dec = cfg.num_layers * ((6 * d * d + 2 * d * f) * tokens
                            + 2 * d * d * n_frames)
    weights = enc + dec + cfg.vocab * d * tokens
    per_head = 4 * cfg.hd * cfg.n_heads * batch
    attn = per_head * (cfg.encoder_layers * frames * frames
                       + cfg.num_layers * (seq * (seq + 1) // 2
                                           + seq * frames))
    return 3 * (2 * weights + attn)


def oracle_loss(trainer) -> float:
    """The first step's loss from the trainer's initial parameters with
    the dense oracle (``impl="ref"``) in place of the kernels: each
    microbatch's loss weighted by its valid tokens, as the step weighs
    them."""
    from repro_torch.core.runtime import Runtime
    from repro_torch.models.model import forward_loss

    batch = trainer._to_device(trainer.data.batch(trainer.start_step))
    accum = trainer.plan.grad_accum
    rt = Runtime(impl="ref", device="cuda")
    parts = []
    with torch.no_grad():
        for i in range(accum):
            mb = {k: v[i] for k, v in batch.items()} if accum > 1 else batch
            _, m = forward_loss(trainer.params, mb, rt, trainer.cfg)
            parts.append((float(m["loss"]), float(m["n_tokens"])))
    del batch
    torch.cuda.empty_cache()
    return sum(x * n for x, n in parts) / sum(n for _, n in parts)


def encdec_training(arch: str, layers: int | None, routes: dict,
                    phase: str = "phase 16 (c)") -> dict:
    """(c): ``launch/train.py --arch ARCH [--layers N]`` at phase 7's
    shape (bf16, scpp): 3 finite losses, step 0 within 1e-2 of the same
    step on the dense oracle (``oracle_loss``; at random init gemma3's
    tied, scaled embedding and chameleon's untied head lie well above
    ln(vocab), so phase 7's ln(vocab) check does not apply), every step's
    launches exactly one forward, dq and dk/dv an attention call on
    ``routes`` (whisper: the encoder's, the decoder's and the
    cross-attention's); step ms, tokens/s, MFU, peak memory and one
    profiled step."""
    argv = train_argv(arch) + ([] if layers is None
                               else ["--layers", str(layers)])
    from torch.utils._pytree import tree_flatten

    print(f"    python -m repro_torch.launch.train {' '.join(argv)}")
    run, trainer = train_phase(argv, before=oracle_loss)
    tcfg, accum = run["plan"].cfg, run["plan"].grad_accum
    losses, oracle = run["losses"], run["before"]
    check(len(losses) == 3 and all(np.isfinite(losses)),
          f"{phase} {arch}: losses {losses}")
    check(abs(losses[0] - oracle) <= MODEL_TOL["bfloat16"][0] * abs(oracle),
          f"{phase} {arch}: step-0 loss {losses[0]} against the dense "
          f"oracle's {oracle}")
    calls = (tcfg.encoder_layers + 2 * tcfg.num_layers
             if tcfg.family == "encdec" else tcfg.num_layers) * accum
    want = expected_launches(calls, calls, routes)
    check(all(step == want for step in run["launches"]),
          f"{phase} {arch}: launches per step {run['launches']}, "
          f"expected {want}")
    tokens = BATCH * PROMPT
    step_ms = statistics.median(run["step_ms"][1:])
    flops = (whisper_flops(tcfg, PROMPT, tcfg.enc_frames, BATCH)
             if tcfg.family == "encdec"
             else train_flops(tcfg, PROMPT, tokens))
    batch = trainer._to_device(trainer.data.batch(3))
    prof, _ = profile_call(
        lambda: trainer.step_fn(trainer.params, trainer.opt_state, batch),
        top=10)
    del batch
    n_params = sum(x.numel() for x in tree_flatten(trainer.params)[0])
    print(f"    {n_params / 1e9:.3f} B parameters; losses "
          f"{[round(x, 6) for x in losses]} (step 0 on the dense oracle "
          f"{oracle:.6f}; ln vocab {np.log(tcfg.vocab):.4f}); grad norms "
          f"{[round(x, 6) for x in run['gnorms']]}; flash launches per step "
          f"{ {k: v for k, v in run['launches'][0].items() if v} }")
    print(f"    step times {[round(x, 2) for x in run['step_ms']]} ms; median "
          f"after 1 warm-up {step_ms:.2f} ms = {tokens * 1e3 / step_ms:.0f} "
          f"tokens/s; {flops / 1e12:.2f} TFLOP a step = "
          f"{100 * flops / (step_ms * 1e-3) / PEAK_BF16_FLOPS:.2f}% MFU of "
          f"989 TFLOP/s; peak memory {run['peak'] / 2**30:.2f} GiB")
    print(f"    training step: {prof}")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return {"run": run, "step_ms": step_ms, "flops": flops,
            "launches": run["launches"][0], "n_params": n_params}


def whisper_serving() -> dict:
    """(d): greedy fixed-batch serving of whisper-small at full depth in
    bf16 through ``launch/serve.py``'s ``generate``: 2 prompts of 4096
    tokens over 1536 frames each (drawn with a ``torch.Generator``), 32
    generated: tokens in the vocab, one sm90 forward an attention call in
    the prefill (12 encoder, 12 decoder, 12 cross) and none in decode;
    prefill ms, decode ms a step, peak memory; SSM_DECODE decode steps of
    known tokens after the prefill against a prefill of the longer prompt
    (the last logits' cosine at least SSM_COS, and their argmax), and in
    fp32 at full depth within the reference's decode-test bounds."""
    from repro_torch.configs import get_config
    from repro_torch.core.runtime import Runtime
    from repro_torch.launch import serve
    from repro_torch.models.decode import prefill
    from repro_torch.models.model import init_params

    cfg = get_config(WHISPER)
    rt = Runtime(impl="auto", device="cuda")
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, gen, cast=True)
    weights = torch.cuda.memory_allocated()
    frames = torch.randn((BATCH, cfg.enc_frames, cfg.d_model),
                         generator=gen, device="cuda")
    tokens = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (BATCH, PROMPT + SSM_DECODE)), device="cuda")
    prompt = tokens[:, :PROMPT]
    calls = cfg.encoder_layers + 2 * cfg.num_layers
    rec = {"prefill_launches": []}
    fns = counted_fns(cfg, rt, rec)
    serve.generate(params, cfg, rt, prompt[:, :256], frames, gen=2, fns=fns)
    rec["prefill_launches"].clear()
    reset_counts()
    out = serve.generate(params, cfg, rt, prompt, frames, gen=GEN, fns=fns)
    torch.cuda.synchronize()
    launches = launch_counts()
    check(rec["prefill_launches"] == [calls]
          and launches["fwd_sm90"] == launches["flash_fwd"] == calls
          and launches["flash_bwd_dq"] == launches["flash_bwd_dkv"] == 0,
          f"phase 16 (d): launches {launches}, prefill "
          f"{rec['prefill_launches']}; expected {calls} forward on sm90")
    check(tuple(out.shape) == (BATCH, GEN)
          and bool(((out >= 0) & (out < cfg.vocab)).all())
          and bool(torch.isfinite(rec["logits"]).all()),
          "phase 16 (d): tokens outside the vocab or non-finite logits")
    with torch.inference_mode():
        prefill_ms = cuda_ms(lambda: prefill(
            params, {"tokens": prompt, "frames": frames}, rt, cfg), reps=3,
            warmup=1)
    a, decode_ms, b = incremental_logits(params, cfg, rt, tokens, frames)
    peak = torch.cuda.max_memory_allocated()
    cos = torch.nn.functional.cosine_similarity(a, b, dim=-1)
    same = (a.argmax(-1) == b.argmax(-1)).tolist()
    print(f"    (d) {WHISPER} at depth {cfg.encoder_layers} + "
          f"{cfg.num_layers}: tokens[0, :8] = {out[0, :8].tolist()}; "
          f"prefill of {BATCH} x {PROMPT} tokens over {cfg.enc_frames} "
          f"frames {prefill_ms:.2f} ms "
          f"({BATCH * PROMPT * 1e3 / prefill_ms:.0f} prompt tok/s), decode "
          f"{decode_ms:.3f} ms a step (mean of {SSM_DECODE}); weights "
          f"{weights / 2**30:.2f} GiB, peak {peak / 2**30:.2f} GiB; "
          f"{SSM_DECODE} decode steps against a prefill of "
          f"{PROMPT + SSM_DECODE}: cosine "
          f"{[round(float(c), 6) for c in cos]}, argmax equal {same}; "
          f"launches {rec['prefill_launches']} in the prefill")
    check(float(cos.min()) >= SSM_COS,
          f"phase 16 (d): decode strays from the incremental forward: "
          f"cosine {cos.tolist()}")
    del params, a, b
    gc.collect()
    torch.cuda.empty_cache()
    return {"prefill_ms": prefill_ms, "decode_ms": decode_ms, "peak": peak,
            "weights": weights, "cos": cos.tolist(), "argmax_equal": same,
            "launches": launches,
            "fp32": fp32_incremental(WHISPER, get_config(WHISPER).num_layers)}


def encdec_layer_rank(rank: int) -> dict:
    """(e) on one of phase 15 (e)'s ranks (``SSM_GRID``): whisper-small at
    full width with one encoder and one decoder layer, fp32, B=1, S=4096
    tokens over 1536 frames: this
    rank's shard of the batch (zigzag tokens, a contiguous piece of the
    frames) through ``forward_loss`` on the mesh (twice, the second
    timed), the grads summed over the ranks.  Rank 0 then runs the whole
    batch in one process and holds the loss and the grads to it."""
    from torch.utils._pytree import tree_flatten, tree_unflatten

    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.core.runtime import Runtime, all_reduce_, world_runtime
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, rank_slices
    from repro_torch.models.model import forward_loss, init_params

    pc = ssm_pc()
    rt = world_runtime(pc, impl="cuda", device="cuda")
    cfg = dataclasses.replace(get_config(WHISPER), num_layers=1,
                              encoder_layers=1, dtype="float32")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(3))
    leaves, spec = tree_flatten(params)

    def run(batch, rt):
        xs = [x.detach().requires_grad_() for x in leaves]
        loss, _ = forward_loss(tree_unflatten(xs, spec), batch, rt, cfg)
        return loss.item(), list(torch.autograd.grad(loss, xs))

    def batch_of(pc_, shard):
        dcfg = DataConfig(vocab=cfg.vocab, seq_len=PROMPT, global_batch=1,
                          seed=4, cp=pc_.cp)
        b = SyntheticLM(dcfg, cfg, shard=shard).batch(0)
        return {k: torch.as_tensor(v, device="cuda") for k, v in b.items()}

    batch = batch_of(pc, rank_slices(DataConfig(
        vocab=cfg.vocab, seq_len=PROMPT, global_batch=1, cp=pc.cp), pc,
        rt.coord))
    for _ in range(2):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = run(batch, rt)
        grads = [all_reduce_(g, rt) for g in grads]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    res = {"loss": loss, "ms": ms, "launches": launch_counts()}
    if rank == 0:
        from repro_torch.core.topology import ParallelConfig
        loss1, want = run(batch_of(ParallelConfig(), None),
                          Runtime(impl="cuda", device="cuda"))
        scale = grad_scale(convert.tree_paths(params))
        res.update(loss_one=loss1, grad_err=max(
            float((g - w).double().norm()
                  / want[s].double().norm().clamp_min(1e-30))
            for g, w, s in zip(grads, want, scale)))
    return res


def encdec_mesh(ranks: list) -> list:
    """(e)'s checks and prints, from phase 15 (e)'s ranks' results."""
    res = [r["encdec"] for r in ranks]
    loss_tol, grad_tol = MODEL_TOL["float32"]
    r0 = res[0]
    losses = [r["loss"] for r in res]
    loss_rel = max(abs(x - r0["loss_one"]) / abs(r0["loss_one"])
                   for x in losses)
    print(f"    (e) {WHISPER} with one encoder and one decoder layer at full "
          f"width on {SSM_WORLD} ranks {SSM_GRID} (phase 15's), B=1 "
          f"S={PROMPT} over "
          f"{WHISPER_F} frames, fp32: loss {losses[0]:.6f} on every rank "
          f"{len(set(losses)) == 1}, one process {r0['loss_one']:.6f}: "
          f"relative difference {loss_rel:.3e} (tol {loss_tol:g}); worst "
          f"grad leaf summed over the ranks {r0['grad_err']:.3e} (tol "
          f"{grad_tol:g}); launches a rank "
          f"{ {k: v for k, v in r0['launches'].items() if v} }; forward + "
          f"backward per rank {[round(r['ms'], 1) for r in res]} "
          "ms (gloo, host-staged)")
    check(loss_rel <= loss_tol and r0["grad_err"] <= grad_tol,
          "phase 16 (e): the mesh disagrees with one process")
    return res


def encdec_phase(ssm_ranks: list) -> dict:
    """Phase 16: (e)'s checks on what phase 15 (e)'s ranks ran, then (a),
    (b), (c) and (d)."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    mesh = encdec_mesh(ssm_ranks)
    t_e = time.perf_counter()
    kernels = shape_kernels(ENCDEC_SHAPES,
                            torch.Generator(device="cuda").manual_seed(16),
                            "phase 16")
    t_a = time.perf_counter()
    print(f"    (b) {WHISPER} at B=1 L={MODEL_L[WHISPER]} over {WHISPER_F} "
          "frames, depth 2 + 2, full width:")
    model = model_check(WHISPER)
    torch.cuda.empty_cache()
    t_b = time.perf_counter()
    train = {}
    for arch, layers in ((WHISPER, None), (CHAMELEON, CHAMELEON_LAYERS),
                         (GEMMA3, GEMMA3_LAYERS)):
        print(f"    (c) {arch}" + ("" if layers is None
                                     else f" at depth {layers}") + ":")
        train[arch] = encdec_training(arch, layers,
                                      MODEL_ROUTES[arch, "bfloat16"])
    t_c = time.perf_counter()
    serve = whisper_serving()
    t_d = time.perf_counter()
    print(f"    phase 16 seconds: {t_d - t0:.1f} ((e) {t_e - t0:.1f}, (a) "
          f"{t_a - t_e:.1f}, (b) {t_b - t_a:.1f}, (c) {t_c - t_b:.1f}, (d) "
          f"{t_d - t_c:.1f})")
    return {"mesh": mesh, "kernels": kernels, "model": model,
            "train": train, "serve": serve}


def encdec_records(kernels: list, encdec: dict):
    """Phase 16's part of the kernels' record: each sm90 and sm90w
    kernel's times at the new paths' shapes on its route (bf16) and its
    launches in one (c) training step of each config that runs it; the
    tf32x3 trio's launches in (b)'s fp32 whisper run."""
    ek = encdec["kernels"]["shapes"]
    for rec in kernels:
        route = rec["kernel_route"]
        if "_d384" in rec["name"] or route not in ("sm90", "sm90w",
                                                   "tf32x3"):
            continue
        key = ("fwd" if rec["tpu_kernel"] == "_fwd_kernel"
               else "dq" if "_dq_" in rec["name"] else "dkv")
        if route == "tf32x3":
            rec["whisper_fp32_model_launches"] = encdec["model"][
                "float32"][2][f"{key}_{route}"]
            continue
        plain = "fwd_plain" if key == "fwd" else "bwd_plain"
        library = "fwd_library" if key == "fwd" else "bwd_library"
        rec["phase16"] = {
            name: {"ms": t[key], "plain_ms": t[plain],
                   "bound_ms": t[f"{key}_bound"][0],
                   "bound_by": t[f"{key}_bound"][1],
                   "library_ms": t[library], "library": t["library"],
                   "shape": "B={} Lq={} Lk={} Hq={} Hkv={} D={} {}".format(
                       *ENCDEC_SHAPES[name])}
            for name, t in ek.items() if t["route"] == route}
        rec["phase16_launches"] = {
            arch: r["launches"][f"{key}_{route}"]
            for arch, r in encdec["train"].items()
            if r["launches"][f"{key}_{route}"]}


# ---------------------------------------------------------------------------
# Phase 17: MLA (deepseek-v2-lite-16b)
# ---------------------------------------------------------------------------

#: (a): MLA's training shape, one microbatch: 16 heads of q / k at d_qk
#: 192, V at d_v 128 zero-padded to 192 (as ``mla_apply`` pads it), a GQA
#: group of 1, causal, scale 1/sqrt(192).
MLA_SHAPES = {"mla": (1, PROMPT, PROMPT, MLA_HQ, MLA_HQ, MLA_DQK,
                      dict(causal=True, scale=1.0 / MLA_DQK ** 0.5), MLA_DV)}


def mla_layer_rank(rank: int) -> dict:
    """(e) on one of phase 15 (e)'s ranks (``SSM_GRID``): reduced
    deepseek-v2-lite (4 MLA heads of d_qk 24, two a rank over head; the
    zigzag ring over inner; 8 experts, two a rank) in fp32, the aux weight
    0, B=1, S=4096: this rank's shard of the batch through ``forward_loss``
    on the mesh (twice, the second timed), the grads summed over the
    ranks.  Rank 0 then runs the whole batch in one process and holds the
    loss and the grads to it."""
    from torch.utils._pytree import tree_flatten, tree_unflatten

    from repro_torch.configs import get_reduced
    from repro_torch.core.runtime import Runtime, all_reduce_, world_runtime
    from repro_torch.core.topology import ParallelConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, rank_slices
    from repro_torch.models.model import forward_loss, init_params

    pc = ssm_pc()
    rt = world_runtime(pc, impl="cuda", device="cuda")
    cfg = get_reduced(DEEPSEEK)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           aux_weight=0.0))
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(5))
    leaves, spec = tree_flatten(params)

    def run(batch, rt):
        xs = [x.detach().requires_grad_() for x in leaves]
        loss, _ = forward_loss(tree_unflatten(xs, spec), batch, rt, cfg)
        return loss.item(), list(torch.autograd.grad(loss, xs))

    def batch_of(pc_, shard):
        dcfg = DataConfig(vocab=cfg.vocab, seq_len=PROMPT, global_batch=1,
                          seed=6, cp=pc_.cp)
        b = SyntheticLM(dcfg, cfg, shard=shard).batch(0)
        return {k: torch.as_tensor(v, device="cuda") for k, v in b.items()}

    batch = batch_of(pc, rank_slices(DataConfig(
        vocab=cfg.vocab, seq_len=PROMPT, global_batch=1, cp=pc.cp), pc,
        rt.coord))
    for _ in range(2):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = run(batch, rt)
        grads = [all_reduce_(g, rt) for g in grads]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    res = {"loss": loss, "ms": ms, "launches": launch_counts()}
    if rank == 0:
        loss1, want = run(batch_of(ParallelConfig(), None),
                          Runtime(impl="cuda", device="cuda"))
        res.update(loss_one=loss1, grad_err=max(
            float((g - w).double().norm()
                  / w.double().norm().clamp_min(1e-30))
            for g, w in zip(grads, want)))
    return res


def mla_mesh(ranks: list) -> list:
    """(e)'s checks and prints, from phase 15 (e)'s ranks' results: the
    loss within 1e-5 and each leaf's grad summed over the ranks within
    1e-4 norm-relative of one process."""
    res = [r["mla"] for r in ranks]
    loss_tol, grad_tol = MODEL_TOL["float32"]
    r0 = res[0]
    losses = [r["loss"] for r in res]
    loss_rel = max(abs(x - r0["loss_one"]) / abs(r0["loss_one"])
                   for x in losses)
    print(f"    (e) reduced {DEEPSEEK} on {SSM_WORLD} ranks {SSM_GRID} "
          f"(phase 15's), B=1 S={PROMPT}, fp32: loss {losses[0]:.6f} on every"
          f" rank {len(set(losses)) == 1}, one process {r0['loss_one']:.6f}: "
          f"relative difference {loss_rel:.3e} (tol {loss_tol:g}); worst "
          f"grad leaf summed over the ranks {r0['grad_err']:.3e} (tol "
          f"{grad_tol:g}); launches a rank "
          f"{ {k: v for k, v in r0['launches'].items() if v} }; forward + "
          f"backward per rank {[round(r['ms'], 1) for r in res]} ms (gloo, "
          "host-staged)")
    check(loss_rel <= loss_tol and r0["grad_err"] <= grad_tol,
          "phase 17 (e): the mesh disagrees with one process")
    return res


def mla_phase(ssm_ranks: list) -> dict:
    """Phase 17: (e)'s checks on what phase 15 (e)'s ranks ran, then (a),
    (b), (c) and (d)."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    mesh = mla_mesh(ssm_ranks)
    t_e = time.perf_counter()
    kernels = shape_kernels(MLA_SHAPES,
                            torch.Generator(device="cuda").manual_seed(17),
                            "phase 17")
    t_a = time.perf_counter()
    print(f"    (b) {DEEPSEEK} at B=1 L={MODEL_L[DEEPSEEK]}, depth 2, full "
          "width:")
    model = model_check(DEEPSEEK)
    torch.cuda.empty_cache()
    t_b = time.perf_counter()
    print(f"    (c) {DEEPSEEK} at depth {DEEPSEEK_LAYERS}:")
    train = encdec_training(DEEPSEEK, DEEPSEEK_LAYERS,
                            MODEL_ROUTES[DEEPSEEK, "bfloat16"],
                            "phase 17 (c)")
    cfg = train["run"]["plan"].cfg
    pairs = visible_pairs(PROMPT, PROMPT, True, None) * BATCH \
        * cfg.num_layers * MLA_HQ
    true_attn = 3 * 2 * (MLA_DQK + MLA_DV) * pairs
    issued = 2 * MLA_DQK * (2 + 3 + 4) * pairs
    print(f"    attention a step: {true_attn / 1e12:.3f} TFLOP at the true "
          f"widths (QK^T at {MLA_DQK}, PV at {MLA_DV}; in the MFU above), "
          f"{issued / 1e12:.3f} TFLOP issued by the kernels (forward 2, dq "
          f"3, dk/dv 4 products at {MLA_DQK}, V padded); the MFU counts "
          f"{attn_weights(cfg) / 1e6:.2f} M MLA weights a layer "
          "(convert.ref_param_shapes)")
    t_c = time.perf_counter()
    serve = serving(DEEPSEEK, DEEPSEEK_LAYERS, "phase 17 (d)", "sm90w")
    t_d = time.perf_counter()
    print(f"    phase 17 seconds: {t_d - t0:.1f} ((e) {t_e - t0:.1f}, (a) "
          f"{t_a - t_e:.1f}, (b) {t_b - t_a:.1f}, (c) {t_c - t_b:.1f}, (d) "
          f"{t_d - t_c:.1f})")
    return {"mesh": mesh, "kernels": kernels, "model": model,
            "train": train, "serve": serve}


def mla_records(kernels: list, mla: dict):
    """Phase 17's part of the kernels' record: each sm90w kernel's times at
    MLA's shape (bf16), its launches in one (c) training step and in the
    (d) prefill; each tf32x3w kernel's launches in (b)'s fp32 run."""
    t = mla["kernels"]["shapes"]["mla"]
    for rec in kernels:
        route = rec["kernel_route"]
        if "_d384" in rec["name"] or route not in ("sm90w", "tf32x3w"):
            continue
        key = ("fwd" if rec["tpu_kernel"] == "_fwd_kernel"
               else "dq" if "_dq_" in rec["name"] else "dkv")
        worst = mla["kernels"]["worst"][route, key]
        if route == "tf32x3w":
            rec.update(mla_fp32_model_launches=mla["model"]["float32"][2][
                f"{key}_{route}"], mla_max_abs_err=worst[0])
            continue
        plain = "fwd_plain" if key == "fwd" else "bwd_plain"
        library = "fwd_library" if key == "fwd" else "bwd_library"
        rec.update(
            mla_launches=mla["train"]["launches"][f"{key}_{route}"],
            mla_launches_in=f"phase 17 (c): one step of {DEEPSEEK} at depth "
                            f"{DEEPSEEK_LAYERS}",
            mla_prefill_launches=mla["serve"]["launches"][f"{key}_{route}"],
            mla_ms=t[key],
            mla_plain_ms=t[plain], mla_bound_ms=t[f"{key}_bound"][0],
            mla_bound_by=t[f"{key}_bound"][1],
            mla_gflop_issued=t[f"{key}_bound"][3] / 1e9,
            mla_library_ms=t[library], mla_library=t["library"],
            mla_max_abs_err=worst[0],
            mla_shape=f"B=1 L={PROMPT} Hq={MLA_HQ} Hkv={MLA_HQ} q/k "
                      f"D={MLA_DQK} V {MLA_DV} padded, causal bf16")


# ---------------------------------------------------------------------------
# Phase 18: serving on the paged engine and on the mesh
# ---------------------------------------------------------------------------

#: (a): the stream: ENGINE_REQUESTS requests, phase 4's two 4096-token
#: prompts second and fifth in the queue, the others of lengths drawn from
#: ENGINE_SEED in ENGINE_LENS; GEN tokens each, ENGINE_SLOTS slots, pages
#: of ENGINE_PAGE, chunks of ENGINE_CHUNK.
ENGINE_REQUESTS, ENGINE_SLOTS, ENGINE_PAGE, ENGINE_CHUNK = 8, 4, 16, 512
ENGINE_SEED, ENGINE_LENS = 18, (256, 4096)
ENGINE_COS = 0.999
#: (b): fp32 at full width and depth 2, two prompts of this length, this
#: many tokens; where the engine's greedy tokens part from generate's, the
#: step's two top logits must lie within ENGINE_TIE (a near tie).
ENGINE_FP32_ARCHS = (ARCH, GEMMA, DEEPSEEK)
ENGINE_FP32_LEN, ENGINE_FP32_GEN, ENGINE_TIE = 1024, 16, 1e-4
#: (c): (arch, (dp, hp, outer, inner)) on phase 15's four ranks, depth 2,
#: prefill BATCH x PROMPT, this many decode steps; fp32 within the
#: reference's 1e-3, bf16 cosine at least SERVE_MESH_COS, of one process.
SERVE_MESH = ((ARCH, (1, 2, 2, 1)), (DEEPSEEK, (1, 4, 1, 1)))
SERVE_MESH_STEPS, SERVE_MESH_TOL, SERVE_MESH_COS = 8, 1e-3, 0.999


def engine_kernel() -> dict:
    """The sm90 forward at the engine's chunk shape (B=1, Lq 512 at start
    3584 of a 4096-token prompt, Lk = nbv * 16 = 4096 gathered keys, 16 / 8
    heads of 128, causal with mask_offset 3584, bf16) through
    ``check_kernel`` (phase 2's bounds, one launch on the route), timed
    beside its plain version, SDPA on the same band and the bound of the
    visible pairs (``shape_bound``)."""
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(18)
    lq, lk, hq, hkv, d = ENGINE_CHUNK, PROMPT, 16, 8, 128
    kw = dict(causal=True, mask_offset=lk - lq, kv_valid_len=lk)
    q, k, v = (torch.randn((1, n, h, d), generator=gen, device="cuda",
                           dtype=torch.bfloat16)
               for n, h in ((lq, hq), (lk, hkv), (lk, hkv)))
    route, err, lse_err, (qf, kf, vf, p, band, doc) = check_kernel(
        "engine-chunk", q, k, v, kw)
    check(route == "sm90", f"phase 18: the chunk shape's route is {route}")
    ms = cuda_ms(lambda: fa._fwd(qf, kf, vf, p, band=band, doc=doc))
    plain_ms = cuda_ms(lambda: fa._fwd_plain(qf, kf, vf, p, band=band,
                                             doc=doc), reps=5)
    library_ms = cuda_ms(sdpa_call(
        *(x.transpose(1, 2).contiguous() for x in (q, k, v)), kw))
    bound, by, flops, _ = shape_bound((1, lq, lk, hq, hkv, d, kw, d), "fwd")
    print(f"    (a) flash_fwd sm90 at the engine's chunk shape (B=1 Lq={lq} "
          f"Lk={lk} Hq={hq} Hkv={hkv} D={d}, causal, mask_offset {lk - lq}, "
          f"bf16): max|err| {err:.3e}, lse {lse_err:.3e} against the plain "
          f"version; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
          f"(boolean band, enable_gqa) {library_ms:.4f} ms; bound "
          f"{bound:.4f} ms ({by}: {flops / 1e9:.1f} GFLOP at 989 TFLOP/s), "
          f"{100 * bound / ms:.1f}% of it")
    return {"ms": ms, "plain": plain_ms, "library": library_ms,
            "bound": bound, "by": by, "err": err}


def engine_stream(phase4: dict) -> dict:
    """(a): qwen3-1.7b at full width and depth, bf16 (phase 4's weights),
    through ``ServeEngine`` with ``serve_spec`` from the plan: after
    ``warmup``, the stream of ENGINE_REQUESTS requests, GEN tokens each.
    Checks the token counts, the pool free at the end, exactly one sm90
    forward a layer a prefill chunk and no backward, and the first token's
    logits of phase 4's two prompts against phase 4's ``generate``."""
    from repro_torch.configs import get_config
    from repro_torch.core.plan import build_plan
    from repro_torch.models.model import cast_params_once, init_params
    from repro_torch.serve import SamplingParams, ServeEngine

    cfg = get_config(ARCH)
    plan = build_plan(cfg, device="cuda", seq_len=PROMPT + GEN,
                      global_batch=ENGINE_SLOTS)
    params = cast_params_once(
        init_params(cfg, torch.Generator(device="cuda").manual_seed(0)), cfg)
    torch.cuda.empty_cache()
    spec = plan.serve_spec(page_size=ENGINE_PAGE, max_batch=ENGINE_SLOTS,
                           max_seq_len=PROMPT + GEN,
                           prefill_chunk=ENGINE_CHUNK)
    eng = ServeEngine(plan, params, spec)
    eng.warmup(prompt_lens=(ENGINE_CHUNK,), max_new=2)
    rng = np.random.default_rng(ENGINE_SEED)
    prompts = [rng.integers(0, cfg.vocab, size=int(n)) for n in
               rng.integers(*ENGINE_LENS, size=ENGINE_REQUESTS - 2)]
    prompts.insert(1, phase4["tokens"][0])
    prompts.insert(4, phase4["tokens"][1])
    firsts, t_first, ticks = {}, {}, []
    start_fn, fused_fn = eng._start, eng._fused

    def start(logits, slot, plen):      # the first token, synchronised
        rid = eng.sched.slots[slot].rid
        firsts[rid] = logits.float().clone()
        start_fn(logits, slot, plen)
        torch.cuda.synchronize()
        t_first[rid] = time.perf_counter()

    def fused(nbv, do_sample):          # a decode tick between two events
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fused_fn(nbv, do_sample)
        e1.record()
        ticks.append((len(eng._decoding), e0, e1))

    eng._start, eng._fused = start, fused
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    rids = [eng.submit(p, SamplingParams(), max_new_tokens=GEN)
            for p in prompts]
    res = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    chunks = sum(-(-len(p) // ENGINE_CHUNK) for p in prompts)
    toks = [res["requests"][r]["tokens"] for r in rids]
    check(all(len(t) == GEN for t in toks)
          and all(0 <= x < cfg.vocab for t in toks for x in t),
          f"phase 18 (a): token counts {[len(t) for t in toks]}")
    check(eng.alloc.free_blocks == spec.num_blocks
          and all(s is None for s in eng.sched.slots),
          f"phase 18 (a): {eng.alloc.free_blocks} of {spec.num_blocks} "
          "blocks free at the end")
    want = expected_launches(chunks * cfg.num_layers, 0, {"fwd": "sm90"})
    check(launches == want, f"phase 18 (a): launched {launches}, expected "
          f"{chunks * cfg.num_layers} sm90 forwards ({chunks} chunks x "
          f"{cfg.num_layers} layers)")
    cos = [float(torch.nn.functional.cosine_similarity(
        firsts[rids[i]][0], phase4["logits"][j].cuda(), dim=0))
        for i, j in ((1, 0), (4, 1))]
    ttft = sorted(t_first[r] - t0 for r in rids)
    by_slots = {}
    for n, e0, e1 in ticks:
        by_slots.setdefault(n, []).append(e0.elapsed_time(e1))
    tick_ms = {n: statistics.median(t) for n, t in sorted(by_slots.items())}
    p99 = ttft[min(len(ttft) - 1, int(len(ttft) * 0.99))]
    print(f"    (a) {ARCH} full depth bf16, {ENGINE_REQUESTS} requests of "
          f"{sorted(len(p) for p in prompts)} prompt tokens, {GEN} "
          f"generated each, {ENGINE_SLOTS} slots, page {ENGINE_PAGE}, chunk "
          f"{ENGINE_CHUNK}, {spec.num_blocks} blocks (serve_spec): "
          f"{res['generated']} tokens in {wall:.3f} s "
          f"({res['generated'] / wall:.2f} tok/s, "
          f"{sum(len(p) for p in prompts) / wall:.0f} prompt tok/s); TTFT "
          f"p50 {ttft[len(ttft) // 2]:.3f} s p99 {p99:.3f} s (queueing "
          f"included, first tokens synchronised); a decode tick's ms by "
          f"active slots (median, CUDA events) "
          f"{ {n: round(t, 2) for n, t in tick_ms.items()} } over "
          f"{ {n: len(t) for n, t in sorted(by_slots.items())} } ticks; "
          f"{res['engine_steps']} engine steps, decode traces "
          f"{eng.decode_traces}, prefill keys {len(eng.prefill_traces)}; "
          f"peak {peak / 2**30:.2f} GiB; launches {chunks} chunks x "
          f"{cfg.num_layers} = {launches['fwd_sm90']} sm90 forwards, no "
          f"backward; first-token logits of phase 4's prompts against its "
          f"generate: cosine {[round(c, 6) for c in cos]}")
    check(min(cos) >= ENGINE_COS, f"phase 18 (a): cosine {cos}")
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return {"tok_s": res["generated"] / wall, "ttft_p50": ttft[len(ttft) // 2],
            "ttft_p99": p99, "tick_ms": tick_ms, "peak": peak,
            "launches": launches["fwd_sm90"], "chunks": chunks, "cos": cos,
            "wall": wall}


def decode_run(params, cfg, rt, tokens, steps: int, forced=None) -> dict:
    """``generate``'s loop, timed: the prefill of ``tokens`` (B, S), the
    caches grown by ``steps``, then ``steps`` decode steps, greedy or of
    the ``forced`` tokens (B, steps).  Returns the logits each token is
    drawn from ``(steps + 1, B, V)`` on the host, the tokens fed, the
    prefill's launches (the counts set to 0 just before it), the
    decode's, and their ms."""
    from repro_torch.models.decode import decode_step, grow_caches, prefill
    from repro_torch.models.model import cast_params_once

    params = cast_params_once(params, cfg)
    s = tokens.shape[1]
    with torch.inference_mode():
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        logits, caches = prefill(params, {"tokens": tokens}, rt, cfg)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        launches = launch_counts()
        caches = grow_caches(cfg, caches, steps, rt)
        lgs, toks = [logits[:, -1].float()], []
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        for i in range(steps):
            toks.append(lgs[-1].argmax(-1) if forced is None
                        else forced[:, i].cuda())
            lg, caches = decode_step(params, caches, toks[-1][:, None],
                                     s + i, rt, cfg)
            lgs.append(lg[:, -1].float())
        torch.cuda.synchronize()
        t3 = time.perf_counter()
    return {"logits": torch.stack(lgs).cpu(),
            "tokens": torch.stack(toks, 1).cpu(), "launches": launches,
            "decode_launches": launches_since(launches),
            "prefill_ms": (t1 - t0) * 1e3,
            "decode_ms": (t3 - t2) * 1e3 / max(steps, 1)}


def engine_fp32() -> dict:
    """(b): each of ENGINE_FP32_ARCHS at full width, depth 2, fp32 (MoE
    routing every assignment, ``no_drop``): the engine's greedy tokens
    against ``generate``'s on two prompts; where they part, the step's two
    top logits in ``generate`` must be a near tie."""
    from repro_torch.configs import get_config
    from repro_torch.core.plan import build_plan
    from repro_torch.models.model import init_params
    from repro_torch.serve import SamplingParams, ServeEngine

    out = {}
    for arch in ENGINE_FP32_ARCHS:
        cfg = no_drop(dataclasses.replace(get_config(arch), num_layers=2,
                                          dtype="float32"))
        plan = build_plan(cfg, device="cuda")
        params = init_params(cfg, torch.Generator(device="cuda").manual_seed(2))
        tokens = torch.as_tensor(np.random.default_rng(3).integers(
            0, cfg.vocab, (BATCH, ENGINE_FP32_LEN)), device="cuda")
        logits = decode_run(params, cfg, plan.rt, tokens,
                            ENGINE_FP32_GEN - 1)["logits"]
        want = logits.argmax(-1).T
        spec = plan.serve_spec(page_size=ENGINE_PAGE, max_batch=BATCH,
                               max_seq_len=ENGINE_FP32_LEN + ENGINE_FP32_GEN,
                               prefill_chunk=ENGINE_CHUNK)
        eng = ServeEngine(plan, params, spec)
        reset_counts()
        rids = [eng.submit(t.cpu().numpy(), SamplingParams(),
                           max_new_tokens=ENGINE_FP32_GEN) for t in tokens]
        res = eng.run()
        launches = {k: v for k, v in launch_counts().items() if v}
        parts = []
        for b, rid in enumerate(rids):
            got, ref = res["requests"][rid]["tokens"], want[b].tolist()
            t = next((i for i, (x, y) in enumerate(zip(got, ref)) if x != y),
                     None)
            if t is None:
                parts.append(None)
                continue
            top2 = logits[t, b].topk(2).values
            gap = float(top2[0] - top2[1])
            parts.append((t, gap))
            check(gap <= ENGINE_TIE, f"phase 18 (b) {arch}: request {b} "
                  f"parts from generate at step {t} where the top two "
                  f"logits lie {gap:.3e} apart")
        print(f"    (b) {arch} depth 2 fp32, 2 x {ENGINE_FP32_LEN} prompt "
              f"tokens, {ENGINE_FP32_GEN} generated: the engine's tokens "
              + ("equal generate's" if all(p is None for p in parts) else
                 f"part from generate's at (step, top-2 gap) {parts}")
              + f"; engine launches {launches}")
        out[arch] = {"parts": parts, "launches": launches}
        del eng, params
        gc.collect()
        torch.cuda.empty_cache()
    return out


def serve_mesh_config(arch: str, dtype: str):
    from repro_torch.configs import get_config
    return no_drop(dataclasses.replace(get_config(arch), num_layers=2,
                                       dtype=dtype))


def serve_mesh_prompts(cfg):
    """(c)'s prompts: BATCH x PROMPT tokens from seed 5, on the card."""
    return torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab, (BATCH, PROMPT)), device="cuda")


def serve_mesh_rank(rank: int) -> dict:
    """(c) on one of phase 15's ranks: each SERVE_MESH grid in fp32 and
    bf16 at full width and depth 2 (the weights from seed 4, as the one
    process draws them); rank 0 keeps the logits and tokens."""
    from repro_torch.core.runtime import world_runtime
    from repro_torch.core.topology import ParallelConfig
    from repro_torch.models.model import init_params

    out = {}
    for arch, (dp, hp, no, wi) in SERVE_MESH:
        pc = ParallelConfig(dp=dp, hp=hp, cp_outer=no, cp_inner=wi)
        rt = world_runtime(pc, impl="cuda", device="cuda")
        for dtype in ("float32", "bfloat16"):
            cfg = serve_mesh_config(arch, dtype)
            params = init_params(cfg,
                                 torch.Generator(device="cuda").manual_seed(4))
            r = decode_run(params, cfg, rt, serve_mesh_prompts(cfg),
                           SERVE_MESH_STEPS)
            if rank:
                del r["logits"], r["tokens"]
            out[arch, dtype] = r
            del params
            gc.collect()
            torch.cuda.empty_cache()
    return out


def serve_mesh_check(ranks: list) -> dict:
    """(c)'s checks against one process on the card, teacher-forced with
    the ranks' tokens: fp32 within SERVE_MESH_TOL, bf16 cosine at least
    SERVE_MESH_COS on the prefill's and every decode step's logits; every
    rank's prefill launches exactly the ring's forwards (layers x cp) on
    the dtype's route, decode none."""
    from repro_torch.core.runtime import Runtime
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models.model import init_params

    out = {}
    for arch, grid in SERVE_MESH:
        cp = grid[2] * grid[3]
        for dtype in ("float32", "bfloat16"):
            cfg = serve_mesh_config(arch, dtype)
            res = [r["serve"][arch, dtype] for r in ranks]
            params = init_params(cfg,
                                 torch.Generator(device="cuda").manual_seed(4))
            one = decode_run(params, cfg, Runtime(impl="auto", device="cuda"),
                             serve_mesh_prompts(cfg), SERVE_MESH_STEPS,
                             forced=res[0]["tokens"])
            del params
            torch.cuda.empty_cache()
            a, b = res[0]["logits"].double(), one["logits"].double()
            d = cfg.mla.d_qk if cfg.mla is not None else cfg.hd
            route = fa.fwd_route(cfg.compute_dtype, ops._d_pad(d))
            want = expected_launches(cfg.num_layers * cp, 0, {"fwd": route})
            ok_launch = all(r["launches"] == want and not any(
                r["decode_launches"].values()) for r in res)
            if dtype == "float32":
                err = float((a - b).abs().max())
                ok, what = err <= SERVE_MESH_TOL, f"max|d| {err:.3e}"
            else:
                err = float(torch.nn.functional.cosine_similarity(
                    a, b, dim=-1).min())
                ok, what = err >= SERVE_MESH_COS, f"worst cosine {err:.6f}"
            print(f"    (c) {arch} depth 2 {dtype} on {SSM_WORLD} ranks "
                  f"(dp, hp, outer, inner) = {grid}, prefill {BATCH} x "
                  f"{PROMPT} over the contiguous ring and {SERVE_MESH_STEPS}"
                  f" decode steps against one process: {what}; launches a "
                  f"rank {[r['launches'][f'fwd_{route}'] for r in res]} "
                  f"(want {cfg.num_layers} layers x cp {cp} on {route}), "
                  f"none in decode; per-rank prefill ms "
                  f"{[round(r['prefill_ms'], 1) for r in res]}, decode ms a "
                  f"step {[round(r['decode_ms'], 2) for r in res]} (gloo, "
                  f"host-staged); one process {one['prefill_ms']:.1f} / "
                  f"{one['decode_ms']:.2f} ms")
            check(ok and ok_launch, f"phase 18 (c) {arch} {dtype}: {what}, "
                  f"launches {[r['launches'] for r in res]}")
            out[arch, dtype] = {"err": err, "route": route,
                                "launches": res[0]["launches"][f"fwd_{route}"],
                                "prefill_ms": [r["prefill_ms"] for r in res],
                                "decode_ms": [r["decode_ms"] for r in res]}
    return out


def serve_phase(phase4: dict, ssm_ranks: list) -> dict:
    """Phase 18: (a) the chunk kernel and the engine stream, (b) the fp32
    engines against generate, (c) the checks of what phase 15's ranks
    ran."""
    t0 = time.perf_counter()
    kernel = engine_kernel()
    stream = engine_stream(phase4)
    t_a = time.perf_counter()
    fp32 = engine_fp32()
    t_b = time.perf_counter()
    mesh = serve_mesh_check(ssm_ranks)
    t_c = time.perf_counter()
    print(f"    phase 18 seconds: {t_c - t0:.1f} ((a) {t_a - t0:.1f}, (b) "
          f"{t_b - t_a:.1f}, (c) {t_c - t_b:.1f} here, its ranks in phase "
          "15)")
    return {"kernel": kernel, "stream": stream, "fp32": fp32, "mesh": mesh}


def serve_records(kernels: list, serve: dict):
    """Phase 18's part of the kernels' record: the sm90 forward's launches
    in the engine stream and its times at the chunk shape; each forward
    route's launches a rank in (c)'s mesh prefill."""
    by_route = {}
    for (arch, dtype), r in serve["mesh"].items():
        by_route.setdefault(r["route"], []).append(
            (f"{arch} {dtype}", r["launches"]))
    for rec in kernels:
        if rec["tpu_kernel"] != "_fwd_kernel" or "_d384" in rec["name"]:
            continue
        route = rec["kernel_route"]
        if route == "sm90":
            k, s = serve["kernel"], serve["stream"]
            rec.update(engine_launches=s["launches"],
                       engine_launches_in=f"phase 18 (a): {s['chunks']} "
                       f"prefill chunks of the engine stream",
                       engine_chunk_ms=k["ms"], engine_chunk_plain_ms=k["plain"],
                       engine_chunk_bound_ms=k["bound"],
                       engine_chunk_bound_by=k["by"],
                       engine_chunk_library_ms=k["library"],
                       engine_chunk_shape=f"B=1 Lq={ENGINE_CHUNK} Lk={PROMPT}"
                       f" Hq=16 Hkv=8 D=128 causal mask_offset "
                       f"{PROMPT - ENGINE_CHUNK} bf16")
        if route in by_route:
            rec["mesh_prefill_launches"] = dict(by_route[route])
            rec["mesh_prefill_in"] = ("phase 18 (c): a rank's prefill at "
                                      "depth 2")


_START = time.perf_counter()


def clock() -> str:
    """The script's seconds so far, to lead a phase's header."""
    return f"({time.perf_counter() - _START:.1f} s)"


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import tempfile
    # phase 12's checkpoints, the one of phase 10 (a) included
    ckpt_root = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    try:
        return run_phases(ckpt_root)
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)


def run_phases(ckpt_root: Path) -> int:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.core.runtime import Runtime
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve
    from repro_torch.models.decode import decode_step, grow_caches, prefill
    from repro_torch.models.model import cast_params_once, init_params

    # -- phase 1 ------------------------------------------------------------
    smi = smi_line()
    print(clock(),
          f"[1] card: {smi}")
    nvcc = shutil.which("nvcc") or (
        "/usr/local/cuda/bin/nvcc"
        if Path("/usr/local/cuda/bin/nvcc").exists() else None)
    print(f"    python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  nvcc {nvcc}  "
          f"triton {importlib.util.find_spec('triton') is not None}  "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"    allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    probe = load_probe()
    with ThreadPoolExecutor(1) as pool:
        probe_lib = pool.submit(probe.build)
        records = build.build_all(SOURCES)
        probe_lib = probe_lib.result()
    print(f"    built the {len(SOURCES)} libraries and the mma.sync TF32 "
          f"probe in parallel in {time.perf_counter() - t0:.2f} s")
    for lib_name, record in records.items():
        print(f"    {record['path'].name}: nvcc {record['seconds']:.2f} s")
        for name, regs, spills in ptxas_summary(record["log"]):
            print(f"    ptxas {name}: {regs} registers, {spills} bytes "
                  "spilled")

    # -- phase 9, run here: its eight ranks need nearly all of the card's
    # memory, and this process holds nothing on it yet -----------------------
    print(clock(),
          f"[9] 2D-Attention on {MESH_WORLD} ranks sharing the card (gloo by "
          "name, host-staged collectives): the attention op, the depth-2 "
          "model and the trainer against one process")
    mesh_phase(smi)
    reset_counts()

    # -- phase 10, run here for the same reason ------------------------------
    print(clock(),
          f"[10] hybrid ZeRO on {ZERO_WORLD} ranks sharing the card (gloo by "
          f"name, host-staged collectives) on (dp, hp, outer, inner) = "
          f"{ZERO_GRID}: dp_sp against replica at depth 2 in fp32, full "
          "depth in bf16, and the pinned host <-> device copy rates")
    zero = zero_phase(smi, ckpt_root / "zero")
    reset_counts()

    # -- phase 2 ------------------------------------------------------------
    print(clock(),
          "[2] forward kernels (bf16: sm90n route at D in "
          f"{fa.SM90N_FWD_D}, sm90 at D in {fa.SM90_FWD_D}, sm90w at D in "
          f"{fa.SM90W_FWD_D}; fp32: tf32x3 route at D in {fa.TF32X3_D}, "
          f"tf32x3w route at D in {fa.WIDE_D}) against their plain version")
    gen = torch.Generator(device="cuda").manual_seed(0)
    # route -> [max |out err|, max |lse err|, cases]; the sm90w forward at
    # D 384 (its own source) apart as "sm90w384".
    fwd_worst = {r: [0.0, 0.0, 0] for r in ("sm90n", "sm90", "sm90w",
                                             "sm90w384", "tf32x3",
                                             "tf32x3w")}
    full = {}
    for name, q, k, v, kw in kernel_cases(gen):
        route, err, lse_err, folded = check_kernel(name, q, k, v, kw)
        d_pad = folded[0].shape[2]
        if q.dtype == torch.bfloat16:
            want = ("sm90n" if d_pad <= 32 else "sm90" if d_pad <= 128
                    else "sm90w")
        else:
            want = "tf32x3" if d_pad <= 128 else "tf32x3w"
        check(route == want,
              f"{name}: padded D {d_pad} took the {route} route")
        w = fwd_worst["sm90w384" if route == "sm90w" and d_pad == 384
                      else route]
        w[0], w[1], w[2] = max(w[0], err), max(w[1], lse_err), w[2] + 1
        if name.startswith("prefill-full-"):
            full[q.dtype] = (q, k, v, folded)
        if name == "moe-full-bf16":
            moe_fwd = (q, k, v, folded)
        if name == "zamba2-full-bf16":
            zamba_fwd = (q, k, v, folded)
        del q, k, v, folded
    check(all(w[2] > 0 for w in fwd_worst.values()),
          "a forward route ran no case")
    print("    " + "; ".join(
        f"{r} ({n} cases) worst out max|err| {e:.3e}, lse max|err| {le:.3e}"
        for r, (e, le, n) in fwd_worst.items()))
    torch.cuda.empty_cache()

    # -- phase 3 ------------------------------------------------------------
    print(clock(),
          "[3] dq and dk/dv kernels (sm90w route for bf16 at D in "
          f"{fa.SM90W_BWD_D}, tf32x3w route for fp32 at D in {fa.WIDE_D}, sm90 "
          f"route for bf16 at D in {fa.SM90_BWD_D}, sm90n route for bf16 at "
          f"D in {fa.SM90N_BWD_D}, tf32x3 route for fp32 at D in "
          f"{fa.TF32X3_D}) against their plain version")
    # (route, kernel) -> [max |err|, norm-relative err, cases]
    worst = {rk: [0.0, 0.0, 0] for rk in BWD_KERNELS}
    bwd_passed, bwd_full, narrow_full, gemma_full = 0, None, None, {}
    for name, q, k, v, do, kw in bwd_cases(gen):
        routes, errs, folded = check_bwd(name, q, k, v, do, kw)
        at_384 = folded[0].shape[2] == 384
        for label, (err, rel) in errs.items():
            key = "dq" if label == "dq" else "dkv"
            route = routes[key]
            w = worst["sm90w384" if route == "sm90w" and at_384 else route,
                      key]
            w[0], w[1] = max(w[0], err), max(w[1], rel)
            w[2] += label != "dv"
        wide = folded[0].shape[2] > 128
        bf16 = q.dtype == torch.bfloat16
        tc = bf16 and folded[0].shape[2] in fa.SM90W_BWD_D
        check(routes["dq"] == routes["dkv"] == ("sm90w" if tc else "tf32x3w")
              if wide else routes["dq"] == routes["dkv"] not in ("sm90w",
                                                                 "tf32x3w"),
              f"{name}: padded D {folded[0].shape[2]} took the routes "
              f"{routes}")
        check(bf16 or routes["dq"] == ("tf32x3w" if wide else "tf32x3"),
              f"{name}: an fp32 case took the routes {routes}")
        check(not bf16 or (folded[0].shape[2] in fa.SM90N_BWD_D)
              == (routes["dq"] == "sm90n"),
              f"{name}: padded D {folded[0].shape[2]} took the routes "
              f"{routes}")
        bwd_passed += 1
        if name == "train-full-bf16":
            bwd_full = (q, k, v, do, folded)
        if name == "moe-full-bf16":
            moe_bwd = (q, k, v, do, folded)
        if name == "zamba2-full-bf16":
            zamba_bwd = (q, k, v, do, folded)
        if name == "train-d32-full-bf16":
            narrow_full = (q, k, v, do, folded)
        if name.startswith("gemma2-full-"):
            gemma_full[q.dtype] = (q, k, v, do, folded)
        del q, k, v, do, folded
        torch.cuda.empty_cache()
    check(all(w[2] > 0 for w in worst.values()),
          "a backward kernel's route ran no case")
    print(f"    {bwd_passed} cases passed: " + "; ".join(
        f"{r} {key} ({n} cases) worst max|err| {e:.3e}, norm-rel {rel:.3e}"
        for (r, key), (e, rel, n) in worst.items()))

    # -- phase 4 ------------------------------------------------------------
    print(clock(),
          f"[4] serving {ARCH}: batch {BATCH} x {PROMPT} prompt tokens, "
          f"{GEN} generated")
    cfg = get_config(ARCH)
    rt = Runtime(impl="auto", device="cuda")
    params = cast_params_once(
        init_params(cfg, torch.Generator(device="cuda").manual_seed(0)), cfg)
    torch.cuda.empty_cache()
    rng = np.random.default_rng(1)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (BATCH, PROMPT)),
                             device="cuda")
    rec = {"prefill_launches": []}
    fns = counted_fns(cfg, rt, rec)
    serve.generate(params, cfg, rt, tokens[:, :256], gen=2, fns=fns)  # warm-up
    rec["prefill_launches"].clear()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = serve.generate(params, cfg, rt, tokens, gen=GEN, fns=fns)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    serve_launches = launch_counts()
    launches = serve_launches["flash_fwd"]
    peak = torch.cuda.max_memory_allocated()
    check(rec["prefill_launches"] == [cfg.num_layers],
          f"prefill launched the kernel {rec['prefill_launches']} times, "
          f"expected [{cfg.num_layers}]")
    check(launches == serve_launches["fwd_sm90"] == cfg.num_layers,
          f"generate launched the forward kernel {launches} times, "
          f"{serve_launches['fwd_sm90']} on the sm90 route; expected "
          f"{cfg.num_layers} on it")
    check(serve_launches["flash_bwd_dq"] == serve_launches["flash_bwd_dkv"]
          == 0, f"serving launched a backward kernel: {serve_launches}")
    check(tuple(out.shape) == (BATCH, GEN), f"tokens shape {out.shape}")
    check(bool(((out >= 0) & (out < cfg.vocab)).all()),
          "generated tokens outside the vocabulary")
    logits_k = rec["logits"][:, -1]
    check(bool(torch.isfinite(logits_k).all()), "non-finite logits")
    print(f"    tokens[0, :12] = {out[0, :12].tolist()}")
    print(f"    kernel launches in generate: {serve_launches} "
          f"(prefill: {rec['prefill_launches']})")
    with torch.inference_mode():
        n0 = fa.FWD_LAUNCHES
        logits_r, _ = prefill(params, {"tokens": tokens},
                              Runtime(impl="ref", device="cuda"), cfg)
        check(fa.FWD_LAUNCHES == n0, "the ref prefill launched the kernel")
    logits_r = logits_r[:, -1]
    cos = torch.nn.functional.cosine_similarity(logits_k, logits_r, dim=-1)
    dmax = float((logits_k - logits_r).abs().max())
    print(f"    last-token logits, kernel vs plain attention: cosine "
          f"{[round(float(c), 6) for c in cos]}  max|d| {dmax:.4e}")
    check(float(cos.min()) >= 0.999, f"logit cosine {cos.tolist()} < 0.999")
    # phase 18 (a) holds the engine's first tokens of these prompts to them
    phase4 = {"tokens": tokens.cpu().numpy(), "logits": logits_k.cpu()}
    del logits_r
    torch.cuda.empty_cache()

    # -- phase 5 ------------------------------------------------------------
    print(clock(),
          "[5] serving timings (CUDA events, 2 warm-ups, then the median of "
          "7; 5 for the plain version and prefill) and where the time goes")
    probe_tflops = probe.measure(probe_lib)["best_tflops"]
    print(f"    mma.sync m16n8k8 TF32 probe (scripts/mma_tf32_probe.py): "
          f"best {probe_tflops:.1f} TFLOP/s of TF32 "
          f"({100 * probe_tflops * 1e12 / PEAK_TF32_FLOPS:.1f}% of 495)")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fwd_timings = {}
    # The sm90 kernel on the bf16 operands, the tf32x3 kernel on the same
    # shape in fp32; each one call at a time and back to back, beside the
    # plain version and SDPA in its dtype.
    for route, dtype in (("sm90", torch.bfloat16),
                         ("tf32x3", torch.float32)):
        q, k, v, (qf, kf, vf, p, band, doc) = full[dtype]
        n0 = launch_counts()
        kernel_ms = cuda_ms(lambda: fa._fwd(qf, kf, vf, p, band=band,
                                            doc=doc))
        loop_ms = statistics.median(cuda_loop_times(
            lambda: fa._fwd(qf, kf, vf, p, band=band, doc=doc)))
        moved = launches_since(n0)   # 2 + 7 one at a time, 3 + 5 x 20 b2b
        check(moved == expected_launches(112, 0, {"fwd": route}),
              f"the {route} forward timing launched {moved}")
        plain_ms = cuda_ms(lambda: fa._fwd_plain(qf, kf, vf, p, band=band,
                                                 doc=doc), reps=5)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        library_ms = cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                          enable_gqa=True))
        group = q.shape[2] // k.shape[2]
        kr, vr = (x.repeat_interleave(group, dim=1) for x in (kt, vt))
        library_rep_ms = cuda_ms(lambda: sdpa(qt, kr, vr, is_causal=True))
        del kr, vr, qt, kt, vt
        # fp32's rate: three TF32 passes at 495 TFLOP/s.
        tf32 = ((PEAK_TF32_FLOPS, 3) if dtype == torch.float32
                else (None, 1))
        bound_ms, bound_by, flops = fwd_bound(q, k, dtype, *tf32)
        fwd_timings[route] = dict(ms=kernel_ms, loop=loop_ms, plain=plain_ms,
                                  library=library_ms,
                                  library_rep=library_rep_ms, bound=bound_ms,
                                  by=bound_by)
        b, lq, hq, d = q.shape
        tag = "bf16" if dtype == torch.bfloat16 else "fp32"
        print(f"    flash_fwd {route} at B={b} L={lq} Hq={hq} "
              f"Hkv={k.shape[2]} D={d} causal {tag}: kernel "
              f"{kernel_ms:.4f} ms (back to back {loop_ms:.4f}), plain "
              f"{plain_ms:.4f} ms, sdpa(enable_gqa) {library_ms:.4f} ms, "
              f"sdpa(repeated kv) {library_rep_ms:.4f} ms")
        line = (f"    {route}: bound {bound_ms:.4f} ms ({bound_by}: "
                f"{flops / 1e9:.1f} GFLOP")
        if dtype == torch.float32:
            ceiling = 3 * flops / (probe_tflops * 1e12) * 1e3
            bound_fma = fwd_bound(q, k, dtype, PEAK_FP32_FLOPS)[0]
            fwd_timings[route].update(probe_ceiling=ceiling,
                                      bound_fma=bound_fma)
            line += (f" x 3 TF32 passes at 495 TFLOP/s); at the probe's "
                     f"{probe_tflops:.1f} TFLOP/s {ceiling:.4f} ms; at 67 "
                     f"TFLOP/s of fp32 FMA {bound_fma:.4f} ms")
        else:
            line += " at 989 TFLOP/s)"
        print(line + f"; kernel at {flops / kernel_ms / 1e9:.1f} TFLOP/s, "
              f"{100 * bound_ms / kernel_ms:.2f}% of the bound, back to "
              f"back {100 * bound_ms / loop_ms:.2f}%")
    del full
    torch.cuda.empty_cache()
    with torch.inference_mode():
        def run_prefill():
            return prefill(params, {"tokens": tokens}, rt, cfg)

        prefill_ms = cuda_ms(run_prefill, reps=5)
        logits, caches = run_prefill()
        caches = grow_caches(cfg, caches, 1)
        tok = logits[:, -1].argmax(-1)[:, None]
        del logits

        def run_step():
            # Writes the same cache slot each call (the cache is pre-sized).
            return decode_step(params, caches, tok, PROMPT, rt, cfg)

        decode_ms = cuda_ms(run_step)
    print(f"    serving: prefill {prefill_ms:.4f} ms "
          f"({BATCH * PROMPT * 1e3 / prefill_ms:.0f} prompt tok/s), "
          f"decode step at position {PROMPT} {decode_ms:.4f} ms "
          f"({BATCH * 1e3 / decode_ms:.1f} tok/s at batch {BATCH}); "
          f"one generate (host clock) {wall:.3f} s "
          f"({BATCH * GEN / wall:.1f} generated tok/s), "
          f"peak memory in generate {peak / 2**30:.2f} GiB")
    with torch.inference_mode():
        pf_prof, _ = profile_call(run_prefill)
        dec_prof, _ = profile_call(run_step)
    for label, prof in (("prefill", pf_prof), ("decode step", dec_prof)):
        print(f"    {label}: {prof}")
    del caches, params, tok
    torch.cuda.empty_cache()

    # -- phase 6 ------------------------------------------------------------
    print(clock(),
          f"[6] whole model: full width at depth 2, fp32 and bf16, "
          "forward_loss + backward on the kernels and on the dense oracle")
    model = {}
    for arch in (ARCH, GEMMA, GEMMA320, REDUCED):
        print(f"    {arch} at B=1 L={MODEL_L[arch]}:")
        model[arch] = model_check(arch)
        torch.cuda.empty_cache()

    # -- phase 7 ------------------------------------------------------------
    print(clock(),
          "[7] training at full depth through launch/train.py's path")
    run = training_run(ARCH, MODEL_ROUTES[ARCH, "bfloat16"], 5,
                       after=lambda tr: full_depth_save(tr, ckpt_root))
    zero_vs_phase7(zero, run)
    gemma_run = training_run(GEMMA, MODEL_ROUTES[GEMMA, "bfloat16"], 3)

    # -- phase 8 ------------------------------------------------------------
    print(clock(),
          "[8] backward timings at qwen3-1.7b's training shape, then the "
          "kernels above D 128 at gemma2-2b's, and at head dim 320")
    b, lq, hq, _ = bwd_full[0].shape
    timings = {}
    # The sm90 kernels on phase 3's train-full bf16 operands and the tf32x3
    # kernels on the same operands in fp32, at D=128; the sm90n kernels,
    # which serve bf16 at D 16 / 32, on phase 3's train-d32-full case (the
    # same shape at D 32).  Each beside the plain version and SDPA's
    # backward in the same dtype, all from the plain forward's (out, lse)
    # at that dtype and width; each kernel and SDPA also timed back to back
    # (``cuda_loop_times``).
    for route, dtype, dh, case in (("sm90", torch.bfloat16, 128, bwd_full),
                                   ("tf32x3", torch.float32, 128, bwd_full),
                                   ("sm90n", torch.bfloat16, 32,
                                    narrow_full)):
        q, k, v, do, (qf, kf, vf, dof, _, _, p, band, doc) = case
        x = [t[..., :dh].to(dtype).contiguous() for t in (qf, kf, vf, dof)]
        out_x, lse_x = fa._fwd_plain(x[0], x[1], x[2], p, band=band, doc=doc)
        dsum_x = (x[3].float() * out_x.float()).sum(dim=-1)
        n0 = launch_counts()
        dq_ms = cuda_ms(lambda: fa._dq_cuda(x[0], x[1], x[2], x[3], lse_x,
                                            dsum_x, p, band, doc))
        dkv_ms = cuda_ms(lambda: fa._dkv_cuda(x[0], x[1], x[2], x[3], lse_x,
                                              dsum_x, p, band, doc))
        moved = launches_since(n0)          # 2 warm-ups + 7 timed, each
        check(moved == expected_launches(0, 9, {"dq": route, "dkv": route}),
              f"the {route} timing launched {moved}")
        n0 = launch_counts()
        loop = {"dq": statistics.median(cuda_loop_times(
            lambda: fa._dq_cuda(x[0], x[1], x[2], x[3], lse_x, dsum_x, p,
                                band, doc))),
                "dkv": statistics.median(cuda_loop_times(
                    lambda: fa._dkv_cuda(x[0], x[1], x[2], x[3], lse_x,
                                         dsum_x, p, band, doc)))}
        moved = launches_since(n0)          # 3 warm-ups + 5 x 20, each
        check(moved == expected_launches(0, 103, {"dq": route,
                                                  "dkv": route}),
              f"the {route} back-to-back timing launched {moved}")
        bwd_plain_ms = cuda_ms(lambda: fa._bwd_plain(
            x[0], x[1], x[2], out_x, lse_x, x[3], p, band, doc), reps=5)
        del out_x, lse_x, dsum_x, x
        qt, kt, vt = (t[..., :dh].to(dtype).transpose(1, 2).contiguous()
                      .requires_grad_() for t in (q, k, v))
        dot = do[..., :dh].to(dtype).transpose(1, 2).contiguous()
        group = hq // kt.shape[1]
        lib = {}
        for how in ("enable_gqa", "repeated kv")[:2 if route == "tf32x3"
                                                 else 1]:
            if how == "enable_gqa":
                sdpa_out = sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
            else:   # K/V repeated in the graph: its backward sums the group
                sdpa_out = sdpa(qt, kt.repeat_interleave(group, dim=1),
                                vt.repeat_interleave(group, dim=1),
                                is_causal=True)
            def grad():
                return torch.autograd.grad(sdpa_out, (qt, kt, vt), dot,
                                           retain_graph=True)

            lib[how] = cuda_times(grad, reps=21, warmup=3)
            loop[how] = statistics.median(cuda_loop_times(grad))
            del sdpa_out, grad
        del qt, kt, vt, dot
        torch.cuda.empty_cache()
        qd = q[..., :dh]
        if route == "tf32x3":
            bounds = {n: bwd_bound(qd, k, n, dtype, PEAK_TF32_FLOPS, 3)
                      for n in (3, 4)}
            fma_bounds = {n: bwd_bound(qd, k, n, dtype)[0] for n in (3, 4)}
        else:
            bounds = {n: bwd_bound(qd, k, n, dtype) for n in (3, 4)}
        tm = timings[route] = dict(
            dq=(dq_ms, *bounds[3][:2]), dkv=(dkv_ms, *bounds[4][:2]),
            plain=bwd_plain_ms, dh=dh, extra={}, loop=loop,
            library={how: statistics.median(ts) for how, ts in lib.items()})
        tag = "bf16" if dtype == torch.bfloat16 else "fp32"
        print(f"    {route} at B={b} L={lq} Hq={hq} Hkv={k.shape[2]} D={dh} "
              f"causal {tag}:")
        for key, label, n, ms in (("dq", "dq", 3, dq_ms),
                                  ("dkv", "dk/dv", 4, dkv_ms)):
            bound, by, flops = bounds[n]
            line = (f"      {label} kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} "
                    f"TFLOP/s, one pass counted); bound {bound:.4f} ms "
                    f"({by}: {flops / 1e9:.1f} GFLOP")
            if route == "tf32x3":
                ceiling = 3 * flops / (probe_tflops * 1e12) * 1e3
                tm["extra"][key] = dict(bound_fma_ms=fma_bounds[n],
                                       probe_ceiling_ms=ceiling)
                line += (f" x 3 TF32 passes at 495 TFLOP/s; "
                         f"{100 * bound / ms:.1f}% of it); at the probe's "
                         f"{probe_tflops:.1f} TFLOP/s {ceiling:.4f} ms; the "
                         f"bound at 67 TFLOP/s of fp32 FMA "
                         f"{fma_bounds[n]:.4f} ms")
            else:
                line += f"; {100 * bound / ms:.1f}% of it)"
            print(line)
        print(f"      plain backward (dq, dk, dv in one call) "
              f"{bwd_plain_ms:.4f} ms; " + "; ".join(
                  f"sdpa({how}) backward alone (one forward, then "
                  f"autograd.grad with retain_graph) median "
                  f"{statistics.median(ts):.4f} ms over 21, min "
                  f"{min(ts):.4f}, max {max(ts):.4f}"
                  for how, ts in lib.items()))
        print(f"      back to back (20 calls between two events, median of "
              f"5): dq {loop['dq']:.4f} ms, dk/dv {loop['dkv']:.4f} ms; "
              + "; ".join(f"sdpa({how}) backward {loop[how]:.4f} ms"
                          for how in lib))
    gemma = gemma_timings(gemma_full)
    fwd_d32 = fwd_d32_timings(narrow_full)
    del gemma_full
    torch.cuda.empty_cache()
    d384 = d384_timings(gen, torch.bfloat16)
    d384_fp32 = d384_timings(gen, torch.float32)

    # -- phase 11 -----------------------------------------------------------
    print(clock(),
          f"[11] packed documents on one card: (a) depth 2 at full width, "
          f"one {PROMPT}-token sequence of documents of mean "
          f"{PACKED_MEAN_DOC} against K independent runs; (b) full-depth "
          f"training with --pack; (c) the kernels on (b)'s doc table")
    packed_check()
    packed_run, doc_table = packed_training(run)
    packed_timings(bwd_full, doc_table,
                   {"fwd": fwd_timings["sm90"]["ms"],
                    "dq": timings["sm90"]["dq"][0],
                    "dkv": timings["sm90"]["dkv"][0]})

    # -- phase 12 -----------------------------------------------------------
    print(clock(),
          f"[12] checkpoints: (a) resume through launch/train.py at depth "
          f"{CKPT_LAYERS}; (b) ran in phase 7 (one save_async of the "
          f"full-depth state); (c) one process restores phase 10 (a)'s "
          f"four-rank checkpoint; (d) SIGTERM to a launch/train.py process")
    t12 = time.perf_counter()
    resume_check(ckpt_root)
    t_a = time.perf_counter()
    elastic_check(ckpt_root / "zero", zero["dp_sp_losses"])
    t_c = time.perf_counter()
    preempt_check(ckpt_root)
    print(f"    phase 12 seconds: (a) {t_a - t12:.1f}, (c) {t_c - t_a:.1f}, "
          f"(d) {time.perf_counter() - t_c:.1f}; (b) "
          f"{sum(run['after'][k] for k in ('stall_s', 'write_s', 'restore_s')):.1f}"
          f" in phase 7 ({smi})")

    # -- phase 13 -----------------------------------------------------------
    print(clock(),
          f"[13] the FPDT chunk pipeline on one card: qwen3-1.7b's attention "
          f"at B=1, bf16 S={CHUNK_S} and fp32 S={CHUNK_S32}, C={CHUNK_C}, "
          f"against the resident op ((d) ran in phase 9)")
    t13 = time.perf_counter()
    chunk = chunk_phase(smi)
    print(f"    phase 13 seconds: {time.perf_counter() - t13:.1f}")
    chunk_launches = {"sm90": chunk[CHUNK_S, "bf16", False]["launches"],
                      "tf32x3": chunk[CHUNK_S32, "fp32", False]["launches"]}

    # -- phase 14 -----------------------------------------------------------
    print(clock(),
          f"[14] the MoE family, {MOE}: (d) moe_apply and (e) two steps of "
          f"the mesh trainer on {MOE_WORLD} ranks sharing the card on (dp, "
          f"hp, outer, inner) = {MOE_GRID}; the sm90 trio at its shape; (a) "
          f"depth 2 at full width against the dense oracle; (b) training "
          f"and (c) serving at depth {MOE_LAYERS}")
    moe = moe_phase(moe_fwd, moe_bwd)
    del moe_fwd, moe_bwd
    moe_launches = moe["train"]["run"]["launches"][0]

    # -- phase 15 -----------------------------------------------------------
    print(clock(),
          f"[15] the SSM and hybrid families, {FALCON} and {ZAMBA}: (e) "
          f"both layers (and phase 16 (e)'s whisper layer pair and 17 "
          f"(e)'s reduced {DEEPSEEK}) on "
          f"{SSM_WORLD} ranks sharing the card on (dp, hp, outer, inner) = "
          f"{SSM_GRID}; (a) the scans against the "
          f"recurrence; the sm90 trio at zamba2's shape and its depth-2 "
          f"model check; (b) and (c) training at depth {FALCON_LAYERS} and "
          f"{ZAMBA_LAYERS}; (d) serving both at full depth")
    ssm_res = ssm_phase(zamba_fwd, zamba_bwd)
    del zamba_fwd, zamba_bwd

    # -- phase 16 -----------------------------------------------------------
    print(clock(),
          f"[16] the encoder-decoder family and the last dense configs: (e) "
          f"one whisper layer pair on {SSM_WORLD} ranks sharing the card on "
          f"(dp, hp, outer, inner) = {SSM_GRID}, run by phase 15's ranks; (a) "
          f"the kernels at "
          f"the shapes of {WHISPER}, {CHAMELEON} and {GEMMA3}; (b) "
          f"{WHISPER} at depth 2 + 2 against the dense oracle; (c) training "
          f"{WHISPER} at full depth, {CHAMELEON} at depth "
          f"{CHAMELEON_LAYERS} and {GEMMA3} at depth {GEMMA3_LAYERS}; (d) "
          f"serving {WHISPER} at full depth")
    encdec = encdec_phase(ssm_res["mesh"])

    # -- phase 17 -----------------------------------------------------------
    print(clock(),
          f"[17] MLA, {DEEPSEEK}: (e) the reduced model on {SSM_WORLD} ranks "
          f"sharing the card on (dp, hp, outer, inner) = {SSM_GRID}, run by "
          f"phase 15's ranks; (a) the sm90w / tf32x3w trio at MLA's shape "
          f"(D {MLA_DQK}, V padded from {MLA_DV}, group 1); (b) depth 2 "
          f"against the dense oracle; (c) training at depth "
          f"{DEEPSEEK_LAYERS}; (d) serving at full depth, absorbed decode")
    mla = mla_phase(ssm_res["mesh"])

    # -- phase 18 -----------------------------------------------------------
    print(clock(),
          f"[18] serving: (a) {ARCH} at full depth through the paged engine "
          f"({ENGINE_REQUESTS} requests, {ENGINE_SLOTS} slots, chunks of "
          f"{ENGINE_CHUNK}) and the forward kernel at its chunk shape; (b) "
          f"the engine against generate in fp32 at depth 2; (c) decode on "
          f"{SSM_WORLD} ranks (run by phase 15's) against one process")
    serve18 = serve_phase(phase4, ssm_res["mesh"])

    def bwd_record(route, key, tpu_line, tpu_kernel, source):
        ms, bound, by = timings[route][key]
        label = f"{key}_{route}"
        if route == "tf32x3":   # this slice's path: phase 6's fp32 model
            launches, path = (model[ARCH]["float32"][2][label],
                              "phase 6 fp32 model")
        elif route == "sm90n":  # phase 6's reduced bf16 model (D 16)
            launches, path = (model[REDUCED]["bfloat16"][2][label],
                              "phase 6 reduced qwen3-1.7b bf16 model")
        else:
            launches, path = run["totals"][label], "phase 7 training step"
        rec = {"name": f"flash_bwd_{key}_{route}", "route": "cuda",
               "kernel_route": route, "source": source,
               "replaces": f"src/repro/kernels/flash_attention.py:{tpu_line}",
               "tpu_kernel": tpu_kernel, "launches": launches,
               "launches_in": path, "cases": worst[route, key][2],
               "max_abs_err": worst[route, key][0],
               "max_norm_rel_err": worst[route, key][1], "ms": ms,
               "plain_ms": timings[route]["plain"], "bound_ms": bound,
               "bound_by": by,
               "library_ms": timings[route]["library"]["enable_gqa"],
               "ms_back_to_back": timings[route]["loop"][key],
               "library_ms_back_to_back": timings[route]["loop"][
                   "enable_gqa"],
               "dtype": "fp32" if route == "tf32x3" else "bf16",
               "head_dim": timings[route]["dh"]}
        if route == "tf32x3":
            rec.update(timings[route]["extra"][key],
                       probe_tflops=probe_tflops,
                       library_repeated_kv_ms=timings[route]["library"][
                           "repeated kv"])
        return rec

    def fwd_record(route, source):
        """The sm90 forward's record (launches in phase 7's bf16 training
        step) or the tf32x3 forward's (phase 6's fp32 model run, its
        path), with its phase-5 times."""
        t = fwd_timings[route]
        rec = {"name": f"flash_fwd_{route}", "route": "cuda",
                "kernel_route": route, "source": source,
                "replaces": "src/repro/kernels/flash_attention.py:145",
                "tpu_kernel": "_fwd_kernel",
                "launches": (run["totals"] if route == "sm90" else
                             model[ARCH]["float32"][2])[f"fwd_{route}"],
                "launches_in": ("phase 7 training step" if route == "sm90"
                                else "phase 6 fp32 model"),
                "serve_launches": serve_launches[f"fwd_{route}"],
                "model_fp32_launches": model[ARCH]["float32"][2][
                    f"fwd_{route}"],
                "cases": fwd_worst[route][2],
                "max_abs_err": fwd_worst[route][0],
                "max_lse_err": fwd_worst[route][1], "ms": t["ms"],
                "ms_back_to_back": t["loop"],
                "plain_ms": t["plain"], "bound_ms": t["bound"],
                "bound_by": t["by"], "library_ms": t["library"],
                "library": "sdpa enable_gqa",
                "library_repeated_kv_ms": t["library_rep"],
                "dtype": "bf16" if route == "sm90" else "fp32",
                "head_dim": 128}
        if route == "tf32x3":
            rec.update(probe_tflops=probe_tflops,
                       probe_ceiling_ms=t["probe_ceiling"],
                       bound_fma_ms=t["bound_fma"])
        return rec

    def narrow_fwd_record():
        """The sm90n forward's record: its times at D 32 (phase 8), its
        launches in phase 6's reduced bf16 model run."""
        t = fwd_d32
        return {"name": "flash_fwd_sm90n", "route": "cuda",
                "kernel_route": "sm90n",
                "source": csrc + "flash_fwd_sm90_narrow.cu",
                "replaces": "src/repro/kernels/flash_attention.py:145",
                "tpu_kernel": "_fwd_kernel",
                "launches": model[REDUCED]["bfloat16"][2]["fwd_sm90n"],
                "launches_in": "phase 6 reduced qwen3-1.7b bf16 model",
                "cases": fwd_worst["sm90n"][2],
                "max_abs_err": fwd_worst["sm90n"][0],
                "max_lse_err": fwd_worst["sm90n"][1], "ms": t["ms"],
                "ms_back_to_back": t["loop"], "plain_ms": t["plain"],
                "bound_ms": t["bound"], "bound_by": t["by"],
                "exp2_floor_ms": t["exp2_floor"],
                "bound_fma_ms": t["bound_fma"], "library_ms": t["library"],
                "library_ms_back_to_back": t["library_loop"],
                "library": "sdpa enable_gqa", "dtype": "bf16", "head_dim": 32}

    def d384_record(key, tpu_line, tpu_kernel, source, errs):
        """The record of an sm90w kernel at D 384: its times at head dim 320
        (phase 8), its launches in phase 6's gemma2-2b head-dim-320 bf16
        model run; ``errs`` as ``gemma_record``'s."""
        r = d384[key]
        rec = {"name": ("flash_fwd_sm90w_d384" if key == "fwd"
                        else f"flash_bwd_{key}_sm90w_d384"),
               "route": "cuda", "kernel_route": "sm90w",
               "source": csrc + source,
               "replaces": f"src/repro/kernels/flash_attention.py:{tpu_line}",
               "tpu_kernel": tpu_kernel,
               "launches": model[GEMMA320]["bfloat16"][2][f"{key}_sm90w"],
               "launches_in": "phase 6 gemma2-2b head dim 320 bf16 model",
               "cases": errs[2], "max_abs_err": errs[0], "ms": r["ms"],
               "ms_back_to_back": r["loop"], "softcap0_ms": r["nocap"],
               "softcap0_ms_back_to_back": r["nocap_loop"],
               "plain_ms": r["plain"], "bound_ms": r["bound"],
               "bound_by": r["by"], "bound_fma_ms": r["bound_fma"],
               "library_ms": r["library"],
               "library_ms_back_to_back": r["library_loop"],
               "library": f"sdpa {d384['backend']}, repeated kv, no softcap",
               "dtype": "bf16", "head_dim": 320, "padded_head_dim": 384}
        rec["max_lse_err" if key == "fwd" else "max_norm_rel_err"] = errs[1]
        return rec

    csrc = "src/repro_torch/kernels/csrc/"
    kernels = [
        fwd_record("sm90", csrc + "flash_fwd_sm90.cu"),
        narrow_fwd_record(),
        fwd_record("tf32x3", csrc + "flash_fwd_tf32x3.cu"),
        *(bwd_record(route, key, line, tpu, csrc + source)
          for route, source in (("sm90", "flash_bwd_sm90.cu"),
                                ("tf32x3", "flash_bwd_tf32x3.cu"),
                                ("sm90n", "flash_bwd_sm90_narrow.cu"))
          for key, line, tpu in (("dq", 289, "_dq_kernel"),
                                 ("dkv", 331, "_dkv_kernel"))),
        # gemma2-2b's width: the bf16 training step's kernels (sm90w),
        # then the tf32x3w forward, dq and dk/dv, which serve fp32 there
        # (phase 6's gemma2-2b fp32 run).
        *(gemma_record(key, dtype, line, tpu, csrc + source, gemma,
                       launches, where, errs)
          for key, dtype, line, tpu, source, launches, where, errs in (
              ("fwd", torch.bfloat16, 145, "_fwd_kernel",
               "flash_fwd_sm90_wide.cu", gemma_run["totals"]["fwd_sm90w"],
               "phase 7 gemma2-2b training", fwd_worst["sm90w"]),
              ("dq", torch.bfloat16, 289, "_dq_kernel",
               "flash_dq_sm90_wide.cu", gemma_run["totals"]["dq_sm90w"],
               "phase 7 gemma2-2b training", worst["sm90w", "dq"]),
              ("dkv", torch.bfloat16, 331, "_dkv_kernel",
               "flash_dkv_sm90_wide.cu", gemma_run["totals"]["dkv_sm90w"],
               "phase 7 gemma2-2b training", worst["sm90w", "dkv"]),
              ("fwd", torch.float32, 145, "_fwd_kernel",
               "flash_fwd_tf32x3_wide.cu",
               model[GEMMA]["float32"][2]["fwd_tf32x3w"],
               "phase 6 gemma2-2b fp32 model", fwd_worst["tf32x3w"]),
              ("dq", torch.float32, 289, "_dq_kernel",
               "flash_bwd_tf32x3_wide.cu",
               model[GEMMA]["float32"][2]["dq_tf32x3w"],
               "phase 6 gemma2-2b fp32 model", worst["tf32x3w", "dq"]),
              ("dkv", torch.float32, 331, "_dkv_kernel",
               "flash_bwd_tf32x3_wide.cu",
               model[GEMMA]["float32"][2]["dkv_tf32x3w"],
               "phase 6 gemma2-2b fp32 model", worst["tf32x3w", "dkv"]))),
        # D 384 (head dim 320): phase 6's gemma2-2b head-dim-320 bf16 run.
        d384_record("fwd", 145, "_fwd_kernel", "flash_fwd_sm90_d384.cu",
                    fwd_worst["sm90w384"]),
        d384_record("dq", 289, "_dq_kernel", "flash_bwd_sm90_d384.cu",
                    worst["sm90w384", "dq"]),
        d384_record("dkv", 331, "_dkv_kernel", "flash_bwd_sm90_d384.cu",
                    worst["sm90w384", "dkv"])]
    # The tf32x3w rows also carry their times at head dim 320 (padded 384),
    # their launches in phase 6's head-dim-320 fp32 run and the mma.sync
    # probe's ceiling.
    for rec in kernels:
        if rec["kernel_route"] == "tf32x3w":
            key = ("fwd" if rec["tpu_kernel"] == "_fwd_kernel"
                   else "dq" if "_dq_" in rec["name"] else "dkv")
            r = d384_fp32[key]
            rec.update(
                probe_tflops=probe_tflops,
                probe_ceiling_ms=rec["bound_ms"] * PEAK_TF32_FLOPS / 1e12
                / probe_tflops,
                d320_launches=model[GEMMA320]["float32"][2][
                    f"{key}_tf32x3w"],
                d320_ms=r["ms"], d320_ms_back_to_back=r["loop"],
                d320_softcap0_ms=r["nocap"],
                d320_softcap0_ms_back_to_back=r["nocap_loop"],
                d320_bound_ms=r["bound"], d320_plain_ms=r["plain"],
                d320_library_ms=r["library"],
                d320_library_ms_back_to_back=r["library_loop"])
    # The chunk pipeline's launches in one forward + vjp (phase 13 (b)).
    for rec in kernels:
        route = rec["kernel_route"]
        if route in chunk_launches and "_d384" not in rec["name"]:
            key = ("fwd" if rec["tpu_kernel"] == "_fwd_kernel"
                   else "dq" if "_dq_" in rec["name"] else "dkv")
            rec["chunk_pipeline_launches"] = chunk_launches[route][
                f"{key}_{route}"]
            rec["chunk_pipeline_in"] = (
                f"phase 13 (b): one forward + vjp at B=1 S="
                f"{CHUNK_S if route == 'sm90' else CHUNK_S32} C={CHUNK_C}")
    # qwen3-moe-30b-a3b (phase 14): the sm90 trio's launches in a depth-4
    # bf16 training step and its times at the MoE shape (D 64, group 8);
    # the tf32x3 trio's launches in (a)'s fp32 depth-2 model run.
    mk = moe["kernels"]
    for rec in kernels:
        route = rec["kernel_route"]
        if route not in ("sm90", "tf32x3") or "_d384" in rec["name"]:
            continue
        key = ("fwd" if rec["tpu_kernel"] == "_fwd_kernel"
               else "dq" if "_dq_" in rec["name"] else "dkv")
        if route == "tf32x3":
            rec["moe_fp32_model_launches"] = moe["model"]["float32"][2][
                f"{key}_{route}"]
            continue
        plain = mk["fwd_plain"] if key == "fwd" else mk["bwd_plain"]
        library = "fwd_library" if key == "fwd" else "bwd_library"
        rec.update(
            moe_launches=moe_launches[f"{key}_{route}"],
            moe_launches_in=f"phase 14 (b): one step of {MOE} at depth "
                            f"{MOE_LAYERS}",
            moe_ms=mk[key], moe_ms_back_to_back=mk[f"{key}_loop"],
            moe_plain_ms=plain, moe_bound_ms=mk[f"{key}_bound"][0],
            moe_bound_by=mk[f"{key}_bound"][1],
            moe_library_ms=mk[library],
            moe_library_ms_back_to_back=mk[f"{library}_loop"],
            moe_shape=f"B={BATCH} L={PROMPT} Hq={MOE_HQ} Hkv={MOE_HKV} "
                      f"D={MOE_D} causal bf16")
    # zamba2-7b (phase 15): the sm90 trio's launches in a depth-7 bf16
    # training step and its times at the shared block's shape (D 112
    # padded to 128, no GQA); the tf32x3 trio's launches in the fp32
    # depth-2 model run.
    zk = ssm_res["kernels"]
    zamba_launches = ssm_res["zamba"]["launches"]
    for rec in kernels:
        route = rec["kernel_route"]
        if route not in ("sm90", "tf32x3") or "_d384" in rec["name"]:
            continue
        key = ("fwd" if rec["tpu_kernel"] == "_fwd_kernel"
               else "dq" if "_dq_" in rec["name"] else "dkv")
        if route == "tf32x3":
            rec["zamba2_fp32_model_launches"] = ssm_res["model"]["float32"][
                2][f"{key}_{route}"]
            continue
        plain = zk["fwd_plain"] if key == "fwd" else zk["bwd_plain"]
        library = "fwd_library" if key == "fwd" else "bwd_library"
        rec.update(
            zamba2_launches=zamba_launches[f"{key}_{route}"],
            zamba2_launches_in=f"phase 15 (c): one step of {ZAMBA} at depth "
                               f"{ZAMBA_LAYERS}",
            zamba2_ms=zk[key], zamba2_ms_back_to_back=zk[f"{key}_loop"],
            zamba2_plain_ms=plain, zamba2_bound_ms=zk[f"{key}_bound"][0],
            zamba2_bound_by=zk[f"{key}_bound"][1],
            zamba2_library_ms=zk[library],
            zamba2_library_ms_back_to_back=zk[f"{library}_loop"],
            zamba2_shape=f"B=1 L={PROMPT} Hq={ZAMBA_HQ} Hkv={ZAMBA_HQ} "
                         f"D={ZAMBA_D} causal bf16")
    encdec_records(kernels, encdec)
    mla_records(kernels, mla)
    serve_records(kernels, serve18)
    print(f"    script seconds: {time.perf_counter() - _START:.1f}")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
