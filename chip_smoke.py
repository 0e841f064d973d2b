#!/usr/bin/env python3
"""Drive the PyTorch port (paddle_tpu_torch) on one CUDA card and check it.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, in the order they run: 1, 2, 3, 3b (float32, then bfloat16), 3c,
3d, 3e, 3f, 4, 5 (float32, then bfloat16), 7, 8, 9, 10, 11, 11b, 12, 13,
13a in bfloat16, 14, 15, 16, 17, 6 (each one that fails raises, and the script
exits non-zero; each phase's header gives its start in seconds):

1. The card: ``nvidia-smi`` name and power limit, torch and CUDA
   versions.
2. Build every kernel in ``paddle_tpu_torch/kernels/csrc`` with nvcc (one
   process per source, started together) and print the build seconds.
3. The paged decode kernel K4 against its plain PyTorch version on the
   card, at the full-width decode shapes, at one odd shape and at a long
   context (17 to 4,096 tokens a slot over a 256-block table, which K4
   cuts into context splits), float32 and int8: the largest absolute
   difference must stay within the stated tolerance, and the split
   context must be bit-identical on a rerun.  Then, at the decode shape
   and the long context, the kernel and one library call
   (``scaled_dot_product_attention`` on pre-gathered K/V, a yardstick
   the port never calls) are timed by device time (the torch profiler)
   with CUDA-event times beside them, and the plain version with CUDA
   events, cycling through enough input copies that every launch reads
   its K/V from device memory rather than the 50 MB L2, and set beside
   the memory bound.
4. The decode slice end to end at Transformer-base width (vocab 32000,
   d_model 512, 8 heads, d_ffn 2048, 6 layers, max_seq_len 256; random
   weights from ``init_params(seed=7)``): a ``DecodeEngine`` with 8 slots
   serves 12 requests that join and leave mid-batch.  Every greedy
   stream must equal the argmax of the port's own full re-forward on
   the card, token for token, with logits within ``LOGITS_TOL``; the
   kernel must have been launched exactly ``n_layer x decode steps``
   times.  A second, timed run gives tokens/s, decode-step ms and TTFT;
   a shorter int8-cache run follows.  The profiled run prints K4's
   device time and share of the device's busy time.
3b. The flash-attention kernels K1 (forward), K2 (dq) and K3 (dk/dv)
   against their plain versions at the training shapes (B=32, H=8,
   T=256, D=64, ragged key masks): not causal, causal and cross
   (Tq != Tk), dropout 0 and 0.1, an all-masked row at a length that
   is not a multiple of 128, head dims 32 and 128, and lengths that are
   multiples of neither 32 nor 64; K2/K3 bit-identical on a rerun.
   K2's and K3's registers, shared memory and resident blocks an SM
   are printed.  Then each kernel, its plain version and the library
   yardstick (``scaled_dot_product_attention`` forward, and its
   autograd backward, on the same inputs and the same dropout rate)
   are timed with CUDA events beside the bound, with dropout 0.1
   (causal and not) and at rate 0, the same function as SDPA's without
   dropout; SDPA's backward computes dq, dk, dv and its own delta, so
   it is set beside the port's whole backward, delta + K2 + K3, with
   the names of the kernels it ran (its backend).  Last, K1 (causal,
   no dropout) against SDPA with ``is_causal=True`` at the long context
   the reference's ``impl="auto"`` sends to its kernel (B=4, H=8,
   T=8192, D=64): equal within 1e-4; delta + K2 + K3 against SDPA's
   backward there within 1e-4 of max|ref|; all timed.
   Then the same kernels' bfloat16 mode (``flash_attn_fwd_bf16.cu``,
   ``flash_attn_bwd_bf16.cu``) on bfloat16 q, k, v, dO: against the
   plain bfloat16 version at the training shapes (ragged masks, dropout
   0 and 0.1, causal and not, an all-masked row, head dims 32 and 128,
   odd lengths), K2/K3 from the plain forward's lse and delta, within
   ``FLASH_BF16_REL`` and ``FLASH_BF16_LSE``; K1/K2/K3 bit-identical on
   a rerun; at ``bench_flash_attention_long``'s two shapes (B=4, T=8192,
   causal, (H, D) = (8, 64) and (4, 128)) against the float32 kernels on
   the same inputs upcast, within ``FLASH_BF16_VS_F32_REL``; at the bf16
   ring's pair (B=1, H=4, 4,096 x 4,096, D=128, ragged keys) against the
   plain bfloat16 version: K2/K3, and K1 not causal with dropout 0.1 and
   as the causal diagonal at rate 0, each timed beside SDPA bf16's
   forward with the same mask.  K2's own delta (the backward passes none; K2
   computes rowsum(dO * O) for its rows and hands it to K3) is held to
   ``flash_attention_delta`` within the float32 sum-order bound
   (``delta_bound``).  Timed at the training shape (dropout 0.1), at the
   two long shapes and at the ring's pair beside the bound at the
   bfloat16 rate, SDPA in bfloat16 and the float32 kernels (not at the
   pair).  The SASS of ``flash_attn_fwd_bf16.cu`` and
   ``flash_attn_bwd_bf16.cu`` (``cuobjdump -sass``) must hold ``HGMMA``
   (``wgmma``) and ``UTMALDG`` (TMA loads) in every K1, K2 and K3
   kernel: the counts are logged.  K1's registers, shared memory, blocks
   an SM and local bytes are logged at head dims 32, 64 and 128, with and
   without dropout; a spill (local bytes) fails the phase, and so does a
   wgmma group that ptxas serializes or waits for in K1 (C7512, C7515,
   C7517 in ptxas' report: this run's build's, or, where the library was
   current, a build of the same source made for the check), or stack or
   spill bytes in any K1 instantiation, the ring's included (every flash
   library's registers and spills are logged).  The ring entries of K1-K3
   (``flash_attention_*_ring``, one launch a hop) are held against their
   plain loops on the card at 200-row shards (``RING_ENTRY_CASES``), and
   each kernel's first hop gives the same bits in one launch a pair as in
   one launch for the hop.
5. The training slice: Transformer-base through Program ->
   append_backward -> Executor.run with ``attention_impl="pallas"``.
   First a 2-layer program at full width (B=4, T=64, dropout 0) runs one
   step on the card and one on the CPU from the same copied starting
   values: the loss and every parameter gradient must agree.  Then the
   full model (6+6 layers, d_model 512, vocab 32000, T=256, B=32,
   dropout 0.1) trains 12 steps on one seeded batch: the loss must stay
   finite, K1, K2 and K3 must each launch exactly 18 times a step, and
   no gradient may re-run its forward.  Step ms, tokens/s, peak memory
   and one profiled step follow.  Then the same with the bench's
   ``dtype="bfloat16"`` (``bench.py:253-276``): bfloat16 weights and
   embeddings, float32 activations after the embedding's add of the
   float32 positional table, so the attention inputs are float32 and
   the 18 launches a step of each of K1-K3 must be the float32 kernels
   (the profiled step counts the kernels by name, none bfloat16); the
   2-layer card-vs-CPU step holds each bfloat16 gradient within
   ``FLASH_BF16_REL`` of max|ref| and each float32 one within
   ``TRAIN_GRAD_TOL``.
3c. The fused LSTM kernels K6 (forward) and K7 (backward) against their
   plain versions at the stacked LSTM's bench shape (B=128, T=128,
   H=512), with ragged lengths 16..128 and with full lengths, at an odd
   shape and at B=1024 (K6's and K7's batch groups take turns), and K6
   alone at H=1024 (8 units a block, a width K7 does not take); K6 and K7
   within their split-TF32 bounds; both bit-identical on a rerun.  Then each kernel, its plain version and the library
   yardstick (cuDNN through ``torch.nn.LSTM``, forward and its autograd
   backward, full lengths; cuDNN computes the input projection inside,
   so the port's ``mul`` + bias + K6, and their grads + K7, are timed
   beside it) are timed with CUDA events beside the bound (split TF32's
   rate for both), K6 also by its device time (torch profiler), ragged
   and full, and K7's three launches (the gates, the recurrence, dW) by
   their device time.
3d. The sparse-embedding kernels K9 (the multi-table gather) and K10
   (the row-wise lazy update) against their plain versions, bit for bit,
   at DeepFM's bench shape (2048 x 26 ids from randint(0, 1e6) with
   seed 0, field 1 repeating field 0; tables [1e6, 10] and [1e6, 1])
   and at an odd shape (H=23, D=5, n=17): K9 with out-of-range ids (NaN
   rows), an empty batch, int32 ids, 3 and 4 tables (widths 10, 1, 3,
   16), tables that start at row 1 and a skewed batch, one launch a
   call and bit-identical on a rerun; K10 for Adam, momentum (plain and
   Nesterov) and adagrad, also on a skewed batch (Zipf ids, the hottest
   a tenth of the batch), with rows the batch does not touch unchanged,
   plus a dyadic case that must be exact.  Then each kernel, its plain
   version and a library yardstick the port never calls
   (``F.embedding`` per table; ``torch.optim.SparseAdam.step`` on a
   coalesced gradient of the same rows) are timed by device time,
   cycling 32 id batches, beside the byte bound and the 32-byte-sector
   bound, each with its wall per call in a loop; K9 also on the skewed
   batch; K10 also with the sort in front, the DeepFM step's pair (one
   sort, both tables' K10) and on the skewed batch.
3e. The fused GRU kernels K8a (forward) and K8b (backward) against
   their plain versions at machine translation's shape (B=64, T=32,
   H=256) with full and ragged (8..32) lengths, at an odd shape (B=5,
   T=7, H=96) and at T=1; both must be bit-identical on a rerun.
   The ``gru`` op with ``is_reverse``, H0 and a LastH cotangent runs
   K8a/K8b against its plain scan at the path's shape.  Then each
   kernel's device time (torch profiler; K8b's three launches, the gates,
   the recurrence and dw, also one by one), its plain version and cuDNN's
   GRU (``torch.nn.GRU``, TF32 off; a different function: it applies the
   reset gate after the recurrent product) are set beside the bound (at
   split TF32's rate, the float32 rate's beside it).  K8a and K8b are
   held to their own ``K8A_FWD_ATOL`` and ``K8B_GRAD_REL``.
7. The stacked-LSTM slice: ``models/stacked_lstm.py`` (dict 30000, emb
   512, hid 512, 3 layers, the middle one reversed, Adam) through
   ``layers.data(lod_level=1)`` -> ``Adam.minimize`` -> Executor.run.
   First one step at full width with a small ragged batch (B=8, T=32) on
   the card and on the CPU from the same copied starting values: the
   loss and every parameter gradient must agree.  Then the bench
   configuration (B=128, T=128, ragged ``words@LEN`` from a seed) trains
   12 steps on one batch: the loss must stay finite, K6 and K7 must each
   launch exactly 3 times a step, and no gradient may re-run its
   forward.  Step ms, tokens/s, peak memory and one profiled step follow,
   with the device time of K6 and of K7's three launches and their
   shares of the step's kernel time.
8. The DeepFM slice: ``models/deepfm.py`` (13 dense features, 26 sparse
   fields into ``ctr.sparse_emb`` [1e6, 10] and ``ctr.sparse_w1`` [1e6,
   1] with ``is_sparse=True``, MLP 400-400-400, Adam lr 1e-4) through
   ``Adam.minimize`` -> Executor.run with ``FLAGS_sparse_fused_kernel``
   on.  First one step at full width with B=64 on the card and on the
   CPU from the same copied starting values: the loss, every gradient,
   and both tables and their moments after the step agree.  Then the
   bench configuration (B=2048, one seeded batch) trains 12 steps: the
   loss must stay finite, K9 must launch once a step and K10 twice, the
   two K10 launches must share one sort of the step's ids, and no
   gradient may re-run its forward.  The same 12 steps with the flag
   off (the masked-dense update) must give the same tables.  Step ms,
   samples/s, peak memory and one profiled step follow for both.
9. The machine-translation slice: ``models/machine_translation.py`` at
   its defaults (vocab 10000/10000, emb 256, hid 256, T=32; a bi-GRU
   encoder of two ``gru`` ops and a ``static_rnn`` attention decoder of
   33 ops a step, Adam) through ``Adam.minimize`` -> Executor.run.
   First one step at full width with B=8 on the card and on the CPU
   from the same copied starting values: the loss and every parameter
   gradient agree, the ``dec.*`` ones that only ``static_rnn_grad``
   reaches included.  Then B=64 with ragged source and target masks
   (8..32 tokens) trains 12 steps on one batch: the loss must stay
   finite and fall, K8a and K8b must each launch exactly twice a step,
   and no gradient may re-run its forward.  Step ms, tokens/s, peak
   memory and one profiled step follow, with K8a's and K8b's shares of
   its device busy time.
3f. The fused-dequant int8 FC K5 against its plain version at the int8
   Transformer's four bucket-8 shapes (M = 2048: [512 -> 512],
   [512 -> 2048] with relu, [2048 -> 512], [512 -> 32000]), an odd shape
   (M=5, K=37, N=11) and one row, every act of the epilogue ("", relu,
   sigmoid, tanh, gelu) with a dynamic and a calibrated activation
   scale: "" and relu bit for bit, the others within 1e-6 of max|ref|.
   Then the kernel's device time (profiler; each weight's K-major copy
   made before, as on the path), its tile and occupancy, its plain version and two library yardsticks the port
   never calls (``torch._int_mm`` plus the epilogue in torch ops, and
   the float32 ``torch.matmul`` of the same layer) beside the bound,
   cycling inputs past the L2, and the sums over one bucket-8 dispatch.
10. The int8 serving slice: Transformer-base (vocab 32000/32000, d_model
   512, 8 heads, d_ffn 2048, ``attention_impl="base"``, dropout 0.1 that
   the predictor runs as identities) through ``io.save_inference_model``
   -> ``AnalysisConfig.enable_int8()`` -> ``create_predictor`` ->
   ``ModelManager`` with buckets (1, 2, 4, 8).  First a 2 + 2-layer
   model at full width, B=2, T=64, on the card and on the CPU from one
   saved directory: equal stamped programs; every stamped op's K5
   output equal, bit for bit, to its plain version on the CPU given the
   same input; float32 logits within 1e-4 of max|ref|; every stamped
   op's activation codes equal up to the first op where one differs,
   and there at most 0.1% of them apart, each by one (a rounding tie);
   int8 logits within the int8 error itself (RMS no more than sqrt(2) x
   int8 vs float32 on the CPU: each flipped code moves later codes).
   Then the full model (6 + 6 layers, T=256) loaded twice,
   float32 and int8, serves 128 single-row requests with ragged masks
   from 4 client threads, two in flight each: every request answered, K5 launched exactly
   97 times an int8 dispatch and never in the float32 arm, every float32
   reply within 1e-4 of ``Predictor.run`` of its row alone.  Printed,
   not gated: the argmax disagreement of int8 against float32
   (``quant_accuracy_delta``), QPS, p50/p99, the bucket-8 dispatch ms,
   peak memory and one profiled int8 dispatch with K5's share of its
   device busy time.
11. Machine-translation beam inference: ``models/machine_translation.py``
   with ``mode="infer"`` at its defaults (vocab 10000/10000, emb 256, hid
   256, T=32, beam 4): the training program's startup values go through
   ``io.save_params`` and ``io.load_params`` into the beam-search program
   on the card and on the CPU.  One source sentence with a ragged mask
   (21 of 32 tokens) is decoded through the ``while`` op, 32 iterations
   of embedding, attention, the GRU cell, a 10,000-way log-softmax,
   ``beam_search`` and three ``array_write``s, then
   ``beam_search_decode``.  K8a is first held against its plain version
   at the decode's shape (B=1, T=32, H=256), ragged and full, within
   ``K8A_FWD_ATOL``, bit-identical on a rerun.  In the decode K8a must
   launch exactly twice (the encoder's two ``gru`` ops) and K8b never;
   ``beam_search`` on the card's step-0 candidates and
   ``beam_search_decode`` on the card's arrays equal their CPU runs on
   copies of the same inputs bit for bit.  Then the CPU decodes along
   the card's path (each step's ``beam_search`` computes its own
   selection, then hands on the card's): at every step the CPU's own
   scores for the card's picks, sorted, must equal the CPU's own
   selected scores within ``MT_TIE_REL`` of |s| (where the two sides
   select differently, a tie under float noise on one side's scores),
   the card's selected scores must equal the CPU's for the same picks
   within ``MT_TIE_REL`` of |s| at all 32 steps, and the backtracked ids
   and lengths must be equal.  Printed, not gated: the decode's wall ms
   (one host read of the loop condition an iteration) and the device
   busy time of one profiled decode, with K8a's share.
11b. ``decode.PagedBeamDecoder`` on phase 4's LM (``init_params(seed=7)``):
   beam 4, a 32-token prompt, 64 steps, with copy-on-write forking of
   shared blocks and with the eager-copy baseline.  The two give the same
   ids, scores and lengths bit for bit; COW forks at least once and makes
   fewer block copies; no block leaks, after the decode or after
   ``close()``; K4 launches exactly ``n_layer x (steps - 1)`` times a
   decode, over block tables in which lanes share blocks.  K4 is held
   against its plain version on one beam step's own inputs (the last
   step's six layers, where lanes' block tables share blocks after the
   forks) within ``KERNEL_TOL``, bit-identical on a rerun.  Each final
   hypothesis's accumulated scores equal the cumulative log-softmax of
   the port's own ``full_logits`` re-forward along it within
   ``BEAM_TOKEN_TOL`` a token.  Printed, not gated: beam tokens/s, step
   ms, forks and copies, and one profiled decode's device busy time with
   K4's share.
12. The convolutional models, which launch no hand-written kernel (the
   reference runs conv, pool and batch norm through XLA; the port
   through torch's cuDNN calls): K1-K10's launch counters must not move
   over the phase.  First ResNet-50 at (3, 224, 224), B=2, one step on
   the card and on the CPU from the same copied start, NHWC and NCHW:
   in float64 the loss and every parameter and running stat within
   ``CONV_F64_TOL``; in float32 the loss within ``CONV_LOSS_TOL`` and
   the whole update within twice the CPU's own float32 error (against
   its float64 step) plus ``CONV_UPDATE_FLOOR``, the worst tensor
   printed.  Then the bench's ResNet-50 (``bench.py:236-250``: B=256,
   1000 classes, Momentum 0.9, lr 0.1) in bfloat16 NHWC, float32 NHWC
   and float32 NCHW, 12 steps on one seeded batch put on the card once:
   losses finite; step ms, images/s, peak memory and one profiled step (busy,
   idle share, top kernels, and cuDNN's NCHW<->NHWC conversion kernels
   counted: none may run in the bfloat16 NHWC step, where the entry's
   transpose is the one layout copy).  MNIST (B=512, Adam) 12 steps:
   losses finite and falling.  Last the float32 NCHW ResNet-50 (batch
   statistics as running stats) through ``save_inference_model`` ->
   ``create_predictor`` with ``fuse_conv_bn`` (53 folds) and
   ``add_pass("convert_to_nhwc")``: softmax within ``CONV_INFER_TOL`` of
   max|ref| of the predictor with ``ir_optim`` off, on a batch of 32;
   dispatch ms of both.
13. Ring attention (K11, ``kernels/attention.py: ring_attention``: the
   hop route over the ring entries of K1-K3, one launch of each a hop on
   each device, the merges and gradient sums in their epilogues) and the
   multi-device plane's first slice.  13a: at ``bench_ring_shard``'s shapes (``bench.py:728``:
   B=1, H=4, D=128, a 4,096-token shard a device, sp=4 over one card, so
   T=16,384; float32; ragged key masks), causal and not, dropout 0 and
   0.1: the ring against the plain ring (``ring_attention_ref``,
   forward and autograd backward) on the card and, at rate 0, against
   single K1/K2/K3 launches over the whole sequence, within phase 3b's
   tolerances; K1, K2 and K3 each launch exactly sp (4) times a ring,
   causal or not (a hop's one launch).  Device times (the profiler) of
   the ring's forward and backward with their kernels' share and the
   walk's rest (the pair seeds, the float32 delta), beside the summed
   pair bounds;
   CUDA-event times of a diagonal pair and an off-diagonal full pair
   (the two hop kinds the bench reports), of SDPA over the whole 16,384
   tokens (forward and autograd backward, a yardstick the port never
   calls) and of the plain ring.  The same in bfloat16 (the bench's
   dtype; a phase of its own, "13a, bfloat16", after 13c) over the
   bfloat16 K1-K3, dropout 0.1 (timed) and causal at rate 0, within
   phase 3b's bfloat16 tolerances (``RING_BF16_WHOLE_REL`` against
   whole-sequence launches), with the same exact launch counts; its
   dropout case, counted from 0, is the bfloat16 kernels' main-path
   run.  13b:
   Transformer-base with ``attention_impl="ring"`` through
   ``ParallelExecutor`` with ``mesh_shape={"sp": 4}`` over four entries
   of the card.  First a 2-layer full-width step (B=2, T=512, dropout 0)
   on the card and on the CPU (``["cpu"] * 4``) from the same copied
   start, and the same step with ``impl="pallas"`` on the card: loss,
   attention outputs and every gradient agree (``RING_GRAD_L2`` says
   why the gradients are held in relative L2); the CPU's own spread
   (its ring against ``impl="xla"``) is printed beside.  Then the full
   model (6+6 layers, T=4096, B=2, dropout 0.1) trains 4 steps: losses
   finite, K1, K2 and K3 exactly 72 launches a step each (6 x 4
   encoder, 6 x 4 causal decoder, 6 x 4 cross), no gradient re-runs
   its forward; step ms, tokens/s, peak memory and one profiled step.
   One more step copies the inputs of three ring ops (the first
   encoder self-attention, causal decoder self-attention and
   cross-attention: 1,024-token pairs at D=64, the padding masks, the
   step's seed, dropout 0.1); on each, the ring over K1-K3 against the
   plain ring, forward and autograd backward, within phase 3b's
   tolerances, its forward bit-identical to the step's output.  Then
   the same model with ``impl="pallas"`` beside it (18 launches a
   step).  13c: with two or more cards, 13a's checks with the shards
   on distinct cards (the hops copy K/V and the dk/dv accumulators
   between cards; 16 launches of each kernel a ring, 10 causal, on four
   cards), bit-identical to the one-card ring; with one card, one line
   says it was not run.
   Run it alone with ``python3 -c "import chip_smoke as c; from
   paddle_tpu_torch.platform import get_device; c.run_ring(get_device(),
   c.nvidia_smi_line())"`` from the root (about three minutes).
14. ``Executor.run_steps`` and the deferred fetches at phase 5's
   configuration (Transformer-base 6+6, d_model 512, vocab 32000, B=32,
   T=256, dropout 0.1, float32, ``attention_impl="pallas"``), over 24
   distinct seeded batches (K=24, ``bench.py:268``'s ``scan_steps``),
   after one warm-up step on a throwaway copy, three ways from one
   copied start (the startup's tensors and its generator's state): (a) 24 ``run(..., sync=True)`` calls, (b) 24
   ``run()`` calls whose deferred losses are read after the 24th, (c)
   one ``run_steps`` over the stacked feeds.  The 24 losses, every
   tensor of the scope after step 24 and the generator's state must be
   bit for bit equal across the three; K1, K2 and K3 must each launch
   exactly 18 x 24 = 432 times in (c), and no gradient may re-run its
   forward; in (b) all 24 fetches must still be pending after the 24th
   ``run``, and the first read must materialize all 24 in one batch
   with one synchronisation.  Printed, not gated: each arm's wall a step
   (host clock), its synchronizing calls a step (torch's sync debug
   mode, with the lines that made them; it does not see an event's
   wait, so the deferred read's one synchronisation is counted by
   ``LazyFetch.syncs``) and its peak memory (also above what the arm
   found allocated: the earlier arms' scopes stay), and the
   device idle share of a profiled 2-step ``run_steps``.
15. The trainable control flow at machine translation's width (B=64,
   T=32, H=256).  This phase runs no TPU kernel (the sub-blocks' cells
   take their plain versions, as in the reference), and no hand-written
   kernel's counter may move over it.  15a: the ``while`` recurrence
   h = tanh(h w + x_t) of ``tests/test_decode.py:72`` with
   ``max_iters`` = T, its training form (the masked scan) and
   ``while_grad``: loss, x@GRAD and w@GRAD on the card against the same
   recurrence as a ``StaticRNN`` on the card (the reference's own bar,
   ``CF_GRAD_TOL``) and against the port on the CPU from the same
   weights (``TRAIN_GRAD_TOL`` of max|ref|), also with the condition
   false at T/2 (an early exit) and true for 2T iterations (truncated at
   the bound); one training run with a card-resident feed and deferred
   fetches must make no synchronizing call (sync debug mode).  15b:
   ``tests/test_contrib_decoder.py``'s model (a ``sequence_pool``
   encoder, a ``StateCell`` fc cell, ``TrainingDecoder`` over
   ``DynamicRNN``, Adam) at vocab 10000/10000, emb 256, hid 256, T=32,
   its token loss masked by ragged target lengths (8..32): one step at
   B=8 on the card and on the CPU from copied starts (the loss and every
   gradient within ``TRAIN_GRAD_TOL``), then 12 steps at B=64 on one
   batch (loss finite and falling; step ms and peak memory printed).
   15c: ``conditional_block`` with the flag 1 and 0, and ``IfElse`` on
   each row's sign: forward and gradients, card against CPU.
16. The book models (``models/book.py``) and the op rules they brought.
   16a: each of the 24 new op types (the 18 sequence ops, ``warpctc``,
   ``ctc_align``, ``linear_chain_crf``, ``crf_decoding``, ``cos_sim``,
   ``arg_max``) and the 7 nested (``SeqLen2``) forms on the card and on
   the CPU from the same seeded inputs, forward and the gradient of
   sum(out * cot) through autograd: integer outputs exactly, float ones
   within ``BOOK_OP_REL`` of max|ref|; no kernel launches.  16b: the five
   book cases, 5 SGD steps each on the card and on the CPU from the
   CPU startup's values: fit_a_line, word2vec dense and sparse (four
   lookups of one table: four ``SelectedRows`` into ``sum``) and the
   recommender at ``book.py``'s default widths, losses within
   ``BOOK_LOSS_RTOL`` and no hand-written kernel launched; SRL at the
   book's width (word_dim 32, hidden_dim 512 so H=128, depth 8, B=10,
   ragged lengths up to T=64, CoNLL-05's vocabularies): K6 and K7
   exactly 8 launches a step each (the eligibility gate must pass; no
   scan), each LSTM op and grad of the first step replayed on CPU copies
   of its own inputs at phase 7's gates (``K6_FWD_ATOL``,
   ``K7_GRAD_REL``), losses and the CRF transition within 1e-4, the
   LSTM weights after the steps within ``K7_GRAD_REL`` of max|ref|, the
   frozen ``emb`` table unchanged.  Each case prints its wall median a
   step (``sync=True``), a profiled step's busy time and idle share,
   its synchronizing calls a step and its peak memory.  Then K6 and K7
   at SRL's shape against their plain versions, by device time beside
   their bounds and cuDNN's LSTM, and ``linear_chain_crf`` forward +
   backward's device time there.  Alone: ``python3 -c "import
   chip_smoke as c; from paddle_tpu_torch.kernels import _build; from
   paddle_tpu_torch.platform import get_device; _build.build_all();
   c.run_book(get_device(), c.nvidia_smi_line())"``.
17. The refcounted decode plane at Transformer-base width (vocab 32000,
   d_model 512, 8 heads, d_ffn 2048, 6 layers, max_seq_len 512,
   ``init_params(seed=7)``), the bench's ``decode_prefix`` traffic
   (``bench.py:1631-1830``).  17a: 64 greedy requests of 480 tokens
   (416 shared, 64 unique; block 32, 16 slots, prefill bucket 512,
   8 new tokens each), request 0 to completion first, then 63 at once
   (submitted under the engine's lock, so the schedule is a function
   of the traffic), prefix cache on and off: saved prefill tokens
   exactly 63 x 416 and block hits 63 x 13, tokens equal under the
   near-tie rule (a token may differ only where the truth run's logits
   put the two within ``LOGITS_TOL``; counted; that stream is compared
   no further), no leaked block, K4 exactly n_layer x decode steps in
   each engine; TTFT, prefill ms and tokens/s both ways, and each
   engine's wall attributed (phase and capacity attribution on; the
   scheduler thread's host time in admission, the chain hash, prefill,
   ``_register_prefix`` and decode steps); then the prefix-on engine
   with an int8 cache (every hit's suffix prefill dequantizes the
   gathered blocks) on the card and on the CPU with the same weights
   and schedule: saved tokens and hits exact in both, decode steps and
   prefills equal, the card's tokens equal the CPU's under the
   near-tie rule; K4's device time a launch in a profiled prefix-on
   run beside its bound at the run's own contexts.
   17b: 24 greedy streams (prompt 16, 112 new tokens; block 16, 16
   slots, buckets 16-128) through a 97-block pool, submitted under the
   engine's lock, overcommit against full reservation, float32 and
   int8 caches: at least one preemption and one resume, every stream
   finishes by length, no leak, K4 n_layer x steps; float32 tokens
   equal the reserved run's under the near-tie rule; int8 (whose
   tokens depend on block history in the reference's design, so the
   reserved run is no truth for it): the same overcommit run on the
   CPU must take the card's decode steps, preemptions, resumes and
   re-prefilled tokens exactly, and the card's tokens must equal the
   CPU's under the near-tie rule
   (``check_int8_overcommit_against_cpu``); the departures from the
   reserved run are recorded, first tokens equal
   (``check_int8_against_reserved``); slot occupancy over the loaded
   window (up to the last admission sweep that found a queue) and the
   re-prefilled tokens.
   17c: the float32 overcommit leg with phase, memory, tenant and
   capacity attribution on and one injected ``oom:decode_step``: each
   request's three phases sum to its wall, the KV pool's attributed
   bytes equal ``cache.nbytes`` and the ledger reconciles with
   ``torch.cuda.memory_stats``, every tenant's resident KV returns to
   0, ``oom_recovered`` is 1 and the tokens still equal the reserved
   run's under the near-tie rule.  17d: on the overcommit engines' own
   pools, ``_copy_block`` forks 8 blocks of every pool (the int8 scale
   pools included), each copy bit-equal to its source and no other
   block touched.  Alone: ``python3 -c "import chip_smoke as c; from
   paddle_tpu_torch.kernels import _build; from paddle_tpu_torch.platform
   import get_device; _build.build_all(); c.run_refcounted(get_device(),
   c.nvidia_smi_line())"``.
6. (last) One JSON line listing each kernel: launches on the main path,
   max error, its time, the plain version's, the library call's and the
   bound; K4's row adds its launches in a paged beam decode and K8a's
   and K8b's their launches in an MT beam decode; K11's row is the
   ring's (route "cuda" through K1-K3: its launches are theirs in 13b's
   steps, its time the ring's forward + backward at 13a's shape, its
   error the worst of 13a's and 13b's path checks; its ``bf16_*`` keys
   the bfloat16 ring's).  The bfloat16 K1-K3 rows' launches are those
   of 13a's bfloat16 ring (a ring op's 4 each).  The float32 K1-K3 rows
   add their launches in phase 14's 24-step ``run_steps``
   (``run_steps_launches``, 432 each); K6 and K7 add their launches a
   step of SRL (``srl_launches``, 8) and their device times at SRL's
   shape beside its bound and cuDNN's (``srl_ms``, ``srl_bound_ms``,
   ``srl_library_ms``).

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Details also go to ``chiprun_out/chip_smoke.json``.  Without a CUDA
device, or outside a checkout of the repository, the script exits
non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import warnings

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")

# H100 SXM data-sheet peaks the bounds are computed against
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12          # float32 outside the tensor cores
# float32 products in split TF32 (K1, K7): three TF32 tensor-core
# products each, so a third of the 495 TFLOP/s TF32 peak
TF32X3_OPS_PER_S = 495e12 / 3
L2_BYTES = 50 << 20

# kernel vs its plain version on the same inputs: both sum float32 in
# different orders over at most 4,096 positions of O(1) values
KERNEL_TOL = {"float32": 1e-5, "int8": 1e-5}
# paged decode vs the full causal re-forward: same weights and math,
# different matmul shapes and summation orders over 6 layers
LOGITS_TOL = 1e-3
# flash kernels vs their plain versions (|d| <= atol + rtol * |ref|):
# float32 sums over at most 320 keys in different orders; the gradients
# are sums of products of those, hence the wider bound
FLASH_FWD_TOL = (2e-5, 1e-5)
FLASH_GRAD_TOL = (1e-4, 1e-4)
# one training step, card vs CPU, per parameter gradient:
# max|d| <= TRAIN_GRAD_TOL * max|ref| (float32 GEMMs and reductions in
# other orders through 2 layers, a 32000-way softmax and the backward)
TRAIN_GRAD_TOL = 1e-3
TRAIN_LOSS_TOL = 1e-5          # relative
TRAIN = dict(src_vocab=32000, tgt_vocab=32000, max_len=256, d_model=512,
             n_head=8, d_ffn=2048, n_layer=6, dropout=0.1,
             attention_impl="pallas")
TRAIN_B, TRAIN_STEPS = 32, 12
FLASH_TIME_SHAPE = (32, 8, 256, 64)   # B, H, T, D of the training path
# the long context the reference's impl="auto" sends to its flash kernel
# (paddle_tpu/ops/attention_ops.py:43-58): bench.py:603-606's seq-8k cell,
# causal, D=64
FLASH_LONG_SHAPE = (4, 8, 8192, 64)
# K1 vs SDPA (is_causal) there: the same causal softmax, both summing up
# to 8192 keys in float32-equivalent arithmetic in different orders
FLASH_LONG_TOL = 1e-4
# K2/K3 vs SDPA's backward (is_causal) there: max|d| <= FLASH_LONG_GRAD_REL
# * max|ref| for each of dq, dk, dv (both float32-equivalent, summing up
# to 8192 rows or keys in different orders, each from its own forward's
# lse)
FLASH_LONG_GRAD_REL = 1e-4
# bfloat16 K1-K3 against the plain bfloat16 version on the same inputs
# (K2/K3 from the plain forward's lse and delta): the kernel rounds p
# against its own 64-key tile's running max, the plain version against
# the reference's logical tile's, and both sum float32 in other orders,
# so a p or a ds may round to the neighbouring bfloat16: max|d| <=
# FLASH_BF16_REL * max|ref| (one rounding of the largest value) for out,
# dq, dk, dv; the LSE within FLASH_BF16_LSE, plus, where the mass sums
# the rounded p (the ones lane: D < 128 and no dropout), half an ulp of
# each p in each version, 2^-8 / ln 2
FLASH_BF16_REL = 2.0 ** -7
FLASH_BF16_LSE = 1e-4
FLASH_BF16_CASES = ("self", "self_dropout", "causal_dropout",
                    "causal_t200_all_masked_row", "self_d128_dropout",
                    "causal_d32_dropout", "cross_tq100_tk77_causal_dropout")
# bfloat16 K1-K3 against the float32 kernels on the same inputs upcast:
# the reference's own bar for its bfloat16 gradients against float32
# attention (tests/test_attention.py: test_pallas_bwd_bf16_grad_precision),
# max|d| / max|ref| < 0.02, for out, dq, dk and dv
FLASH_BF16_VS_F32_REL = 0.02
# bench.py:586-712 bench_flash_attention_long's shapes: B=4, T=8192,
# causal, (H, D) = (8, 64) and (4, 128), bfloat16
FLASH_LONG_BF16_SHAPES = ((4, 8, 8192, 64), (4, 4, 8192, 128))
# the bf16 ring's pair at bench_ring_shard's shape (bench.py:713-779): B=1,
# H=4, 4,096-token q and kv shards, D=128, ragged keys, not causal
FLASH_RING_PAIR_BF16 = (1, 4, 4096, 128)
BF16_OPS_PER_S = 989e12        # dense bf16 tensor-core peak

# The recurrent kernels (K6, K7, K8a, K8b) vs their plain versions on the
# same inputs.  They multiply in split TF32 and are held tighter than the
# bounds of a float32 recurrence, 1e-4 absolute on the states and 1e-3 of
# max|ref| on the gradients (max|d| <= bound * max|ref|), which one TF32
# product a term would meet or miss by a slim margin only.
# K6: the CPU model of its arithmetic reaches 2.3e-7..3.9e-7 at the
# bench's widths, one TF32 product a term 1.2e-4..1.8e-4
# (tests/test_torch_rnn_kernel.py)
K6_FWD_ATOL = 1e-5
# K7: it reached 5.8e-5 of max|ref| at the bench shape on an H100; the
# same backward with one TF32 product a term reaches 3.1e-4 on the CPU
# model (tests/test_torch_rnn_kernel.py)
K7_GRAD_REL = 1.5e-4
LSTM_TIME_SHAPE = (128, 128, 512)   # B, T, H of the stacked LSTM's bench
LSTM_TRAIN = dict(dict_dim=30000, class_dim=2, emb_dim=512, hid_dim=512,
                  stacked_num=3, lr=0.002)
LSTM_B, LSTM_T, LSTM_STEPS = 128, 128, 12
LSTM_SHORTEST = 16             # ragged batches keep 16..T steps a row

# K9 is a copy and K10's float32 math is written without FMA contraction
# in the plain version's order: both must equal their plain versions bit
# for bit (0 ulp)
SPARSE_ULP = 0
SPARSE_ROWS, SPARSE_FIELDS, SPARSE_EMBED = 1_000_000, 26, 10
DEEPFM = dict(dense_dim=13, sparse_fields=SPARSE_FIELDS,
              sparse_dim=SPARSE_ROWS, embed_dim=SPARSE_EMBED, lr=1e-4)
DEEPFM_B, DEEPFM_STEPS, DEEPFM_PARITY_B = 2048, 12, 64
DEEPFM_TABLES = ("ctr.sparse_emb", "ctr.sparse_w1")
# the tables after one step, card vs CPU: max|d| <= DEEPFM_TABLE_TOL *
# max|update|.  Adam's first step is lr_eff * 0.1 g / (0.0316 |g| + eps),
# which magnifies the gradients' float32 noise near g = 0 by up to
# 0.1 lr_eff / eps
DEEPFM_TABLE_TOL = 1e-2
# flag on vs off after 12 steps (rtol, atol): the reference's own bound
# for the fused and masked-dense paths (tests/test_sparse.py)
DEEPFM_FLAG_TOL = (1e-6, 1e-7)
SPARSE_TIME_SETS = 32          # id batches cycled so rows come from HBM
SPARSE_HOT_SHARE = 0.1         # the skewed batch: its hottest id's share

# K8a: the CPU model of its arithmetic reaches 3.0e-7..3.9e-7 at machine
# translation's shape on four seeds, one TF32 product a term
# 1.4e-4..1.6e-4; K8b: its model reaches 1.7e-7..4.6e-7 of max|ref|, one
# TF32 product a term 2.4e-4..2.8e-4 (tests/test_torch_gru_kernel.py)
K8A_FWD_ATOL = 1e-5
K8B_GRAD_REL = 2e-5
# K8b's three launches (csrc/gru_bwd.cu): (A) the gates, (B) the
# recurrence, (C) dw; profiler event names contain these
K8B_LAUNCHES = ("gru_bwd_gates", "gru_bwd_recurrence", "gru_bwd_dw")
GRU_CASES = {  # name: (B, T, H, shortest row or None for full lengths)
    "mt_full": (64, 32, 256, None),
    "mt_ragged": (64, 32, 256, 8),
    "odd": (5, 7, 96, 1),
    "t1": (3, 1, 64, None),
}
GRU_TIME_SHAPE = (64, 32, 256)    # B, T, H of machine translation's path
MT_TRAIN = dict(src_vocab=10000, tgt_vocab=10000, emb_dim=256, hid=256,
                max_len=32)       # models/machine_translation.py defaults
MT_B, MT_STEPS, MT_PARITY_B = 64, 12, 8
MT_SHORTEST = 8                # ragged masks keep 8..T tokens a row
# machine translation's beam inference (mode="infer" at the defaults): one
# source sentence of MT_INFER_LEN live tokens of T, timed over MT_DECODES
MT_BEAM, MT_INFER_LEN, MT_DECODES = 4, 21, 5
# card vs CPU along the card's path: the selected scores agree within
# MT_TIE_REL * |s| (float32 GEMMs and a 10,000-way softmax in other
# orders: one ulp is 6e-8 of |s|); where the two sides select
# differently, the CPU's own scores for the two selections must be that
# close (a tie under float noise)
MT_TIE_REL = 1e-5

# K5 vs its plain version: "" and relu bit for bit (exact int32 sums,
# the epilogue's rounded multiply then add); sigmoid, tanh and gelu
# within INT8_FC_REL * max|ref| (the card's and torch's transcendentals)
INT8_FC_REL = 1e-6
INT8_OPS_PER_S = 1.979e15      # dense int8 tensor-core peak
INT8_ACTS = ("", "relu", "sigmoid", "tanh", "gelu")
# the int8 Transformer's K5 shapes at bucket 8 (M = 8 x 256): M, K, N and
# the path's act, and how many launches of each a dispatch makes
INT8_SHAPES = {"proj": (2048, 512, 512, ""),
               "ffn1": (2048, 512, 2048, "relu"),
               "ffn2": (2048, 2048, 512, ""),
               "vocab": (2048, 512, 32000, "")}
INT8_DISPATCH_SHAPES = {"proj": 72, "ffn1": 12, "ffn2": 12, "vocab": 1}
INT8_LAUNCHES = 97             # stamped ops of the 6 + 6-layer model
INT8_CHECK = {**INT8_SHAPES, "odd": (5, 37, 11, ""), "m1": (1, 512, 512, "")}
# the serving slice: the bench's serving Transformer at full width
SERVE = dict(src_vocab=32000, tgt_vocab=32000, d_model=512, n_head=8,
             d_ffn=2048, dropout=0.1, attention_impl="base")
SERVE_T, SERVE_LAYERS = 256, 6
SERVE_REQUESTS, SERVE_CLIENTS, SERVE_BUCKETS = 128, 4, (1, 2, 4, 8)
# float32 logits, card vs CPU, and an f32 reply vs Predictor.run of its
# row alone: other GEMM tilings and sum orders over the layers.  (The
# int8 logits are held to the int8 error itself: check_int8_against_cpu)
SERVE_F32_TOL = 1e-4
# int8 card vs CPU: the share of a stamped op's activation codes that may
# flip (each by one) at the first op where the two runs' codes differ
FLIP_FRAC = 1e-3
FULL = dict(vocab=32000, d_model=512, n_head=8, d_ffn=2048, n_layer=6,
            max_seq_len=256)
SLOTS, BLOCK_TOKENS, BUCKETS = 8, 16, (16, 32, 64, 128)
# PagedBeamDecoder on the decode slice's LM: beam width, prompt, steps
BEAM_WIDTH, BEAM_PROMPT, BEAM_STEPS = 4, 32, 64
# a hypothesis's accumulated score vs the re-forward's cumulative
# log-softmax: a token's log-softmax moves by at most twice its logits'
# difference (LOGITS_TOL), so at token t the sums agree within
# BEAM_TOKEN_TOL * (t + 1)
BEAM_TOKEN_TOL = 2 * LOGITS_TOL
# phase 12: ResNet-50 at the bench's configuration (bench.py:236-250:
# B=256, (3, 224, 224), 1000 classes, Momentum 0.9, lr 0.1) in bfloat16
# NHWC (the bench's) and float32 NHWC and NCHW (peaks 32-40 GB of the
# card's 80); MNIST at bench.py:570-582's B=512
CONV_IMAGE, CONV_CLASSES, CONV_B, CONV_STEPS = (3, 224, 224), 1000, 256, 12
CONV_CONFIGS = (("resnet50_bf16_nhwc", "bfloat16", "NHWC"),
                ("resnet50_f32_nhwc", "float32", "NHWC"),
                ("resnet50_f32_nchw", "float32", "NCHW"))
MNIST_IMAGE, MNIST_B = (1, 28, 28), 512
# cuDNN's NCHW <-> NHWC conversion kernels
LAYOUT_KERNELS = ("nchwToNhwc", "nhwcToNchw")
# one ResNet-50 step, card vs CPU, from the same copied start, at the
# full resolution and B=2.  A step's float32 update is ~2e-2 (relative
# L2) from its float64 one on either device (printed each run): deep
# batch-norm biases and the filters of dead channels (a channel whose
# batch variance is ~0 normalises rounding noise) have gradients that
# cancel and move by a tenth of their own scale, and at (3, 32, 32) the
# last stage's batch norms see B values a channel, so the float32 loss
# itself is noisy.  So the per-tensor check is made in float64: card =
# CPU within CONV_F64_TOL (float64's rounding, amplified as float32's
# is, stays far below it); in float32 the loss within CONV_LOSS_TOL
# relative (the precedent of phases 5-9) and the whole update within
# twice the CPU's own float32 error plus CONV_UPDATE_FLOOR
CONV_PARITY = dict(B=2, image=(3, 224, 224), classes=10)
CONV_F64_TOL = 1e-8
CONV_LOSS_TOL = 1e-5
CONV_UPDATE_FLOOR = 1e-4
# the predictor: fuse_conv_bn folds every conv + batch-norm pair of
# ResNet-50 (53); softmax with the passes vs without, float32 products in
# other orders and the folded filters' roundings
CONV_INFER_B, CONV_FOLDS, CONV_INFER_TOL = 32, 53, 1e-4
# phase 13a: ring attention (K11) at bench_ring_shard's shapes
# (bench.py:728): a 4,096-token shard a device, sp = 4, so a global
# sequence of 16,384; B=1, H=4, D=128, float32 and bfloat16 (the
# bench's); ragged key masks (each row keeps a prefix of
# 3/4..all of the keys, so the last shard is partly masked)
RING_SP = 4
RING_SHAPE = (1, 4, 16384, 128)
RING_CASES = {"full": (False, 0.0), "full_dropout": (False, 0.1),
              "causal": (True, 0.0), "causal_dropout": (True, 0.1)}
# and in bfloat16, the bench's dtype: the path's dropout (its launches
# the bfloat16 kernels' main-path count) and causal at rate 0 (held to
# whole-sequence launches too)
RING_BF16_CASES = {"full_dropout": (False, 0.1), "causal": (True, 0.0)}
# the bfloat16 ring against single whole-sequence launches: the ring
# rounds each pair's out (or dq, dk, dv) to bfloat16 before its float32
# merge (or sum), as the reference's does, so each of the sp pairs adds
# up to half an ulp of max|ref|, 2^-8 * max|ref|, and the final cast one
# more
RING_BF16_WHOLE_REL = (RING_SP + 1) * 2.0 ** -8
# phase 13b: Transformer-base with attention_impl="ring" through
# ParallelExecutor on {"sp": 4} over one card: a 2-layer full-width step
# at T=512 against the CPU and against impl="pallas", then the full model
# at T=4096, B=2, dropout 0.1
RING_PARITY = dict(TRAIN, n_layer=2, max_len=512, dropout=0.0,
                   attention_impl="ring")
RING_PARITY_B = 2
# The 2-layer step's gates: the loss within TRAIN_LOSS_TOL; the attention
# ops' outputs within RING_ATTN_TOL * max|ref| (the forward is continuous
# in float32 noise); each gradient within RING_GRAD_L2 in relative L2
# norm.  Phase 5's max|d| <= 1e-3 * max|ref| does not hold at T=512: the
# CPU's ring and its plain softmax chain (impl="xla"), two float32 orders
# of the same attention, already differ by 5.8e-3 of max|ref| on
# dec.0.ffn.fc1.w (a ReLU whose pre-activation is within float32 noise of
# 0 flips, and a whole token's term enters or leaves that row of the
# gradient), by 5.0e-4 in relative L2 (printed by this phase each run);
# RING_GRAD_L2 is ten times that, far below what a wrong pair, mask or
# shard order gives (O(1)).
RING_ATTN_TOL = 1e-4
RING_GRAD_L2 = 5e-3
RING_TRAIN = dict(TRAIN, max_len=4096, attention_impl="ring")
# phase 14: run_steps over K stacked batches (bench.py:268's scan_steps)
STEPS_K = 24
STEPS_PROFILE_K = 2            # the profiled run_steps (idle share)
# phase 15: the trainable control flow at machine translation's width
CF_B, CF_T, CF_H = GRU_TIME_SHAPE
# the while recurrence against the same recurrence as a StaticRNN on the
# card: the reference's own bar (tests/test_decode.py:131-133)
CF_LOSS_RTOL = 1e-5
CF_GRAD_TOL = (1e-4, 1e-6)     # rtol, atol
# the contrib decoder model (tests/test_contrib_decoder.py) at MT's width
DEC = dict(vocab=10000, emb=256, hid=256, T=32)
DEC_PARITY_B, DEC_B, DEC_STEPS = 8, 64, 12
RING_TRAIN_B, RING_TRAIN_STEPS = 2, 4
# phase 16: the book models.  16a: each new op type's rule on the card
# against the same rule on the CPU: float outputs and gradients within
# 1e-5 of max|ref| (the card's own float32 reductions and atomics),
# integer outputs exactly
BOOK_OP_REL = 1e-5
BOOK_STEPS = 5
BOOK_LOSS_RTOL = 1e-4          # every step's loss, card vs CPU, relative
SRL_CRF_RTOL = 1e-4            # SRL's CRF transition after the steps
# label_semantic_roles at the book's width: CoNLL-05's vocabularies as the
# book's chapter gives them (they set only the tables' rows), the book's
# batch of 10, sentences up to 64 words
SRL_WORD_DICT = 44068
SRL_PRED_DICT = 3162
SRL_LABEL_DICT = 59
SRL_MARK_DICT = 2
SRL_B, SRL_T = 10, 64
SRL_SHORTEST = 8               # ragged batches keep 8..SRL_T words a row
SRL = dict(word_dict=SRL_WORD_DICT, pred_dict=SRL_PRED_DICT,
           mark_dict=SRL_MARK_DICT, label_dict=SRL_LABEL_DICT,
           max_len=SRL_T, word_dim=32, hidden_dim=512, depth=8, lr=0.01)


def log(*a) -> None:
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def paged_inputs(S, H, D, bs, MB, N, cls, quantized, seed, dev):
    """Random paged K/V, queries and per-slot block tables (a random
    permutation of the usable blocks, as the allocator would hand
    them out)."""
    from paddle_tpu_torch.kernels.quant import kv_quantize
    g = torch.Generator(device=dev).manual_seed(seed)
    k = torch.randn(N, bs, H, D, generator=g, device=dev)
    v = torch.randn(N, bs, H, D, generator=g, device=dev)
    q = torch.randn(S, H, D, generator=g, device=dev)
    perm = torch.randperm(N - 1, generator=g, device=dev)[:S * MB] + 1
    bt = perm.reshape(S, MB).to(torch.int32).contiguous()
    cl = torch.tensor(cls, dtype=torch.int32, device=dev)
    if not quantized:
        return dict(q=q, k_cache=k, v_cache=v, block_tables=bt,
                    context_lens=cl)
    ks = k.abs().amax(dim=(1, 3)).contiguous()
    vs = v.abs().amax(dim=(1, 3)).contiguous()
    return dict(q=q, k_cache=kv_quantize(k, ks[:, None, :]),
                v_cache=kv_quantize(v, vs[:, None, :]), block_tables=bt,
                context_lens=cl, k_scale=ks, v_scale=vs)


def work(inp) -> dict:
    """Bytes and operations the call needs for these inputs: each
    position t < context_len read once per head (K and V rows, plus a
    scale per touched block and head when int8), q read, out written."""
    S, H, D = inp["q"].shape
    bs = inp["k_cache"].shape[1]
    cl = inp["context_lens"].tolist()
    tokens = sum(cl)
    blocks = sum(max(-(-c // bs), 1) for c in cl)
    elem = inp["k_cache"].element_size()
    nbytes = (2 * tokens * H * D * elem + 2 * S * H * D * 4
              + blocks * 4 + S * 4)
    ops = 4 * tokens * H * D
    if "k_scale" in inp:
        nbytes += 2 * blocks * H * 4
        ops += 2 * tokens * H * D          # dequant multiplies
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return {"bytes": nbytes, "ops": ops,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def gathered(inp):
    """Dense [S, H, T, D] K/V (dequantized) and the attend mask, for the
    library yardstick; made outside its timing."""
    bt = inp["block_tables"].long()
    S, MB = bt.shape
    k, v = inp["k_cache"][bt], inp["v_cache"][bt]    # [S, MB, bs, H, D]
    if "k_scale" in inp:
        k = k.float() * (inp["k_scale"][bt][:, :, None, :, None] / 127.0)
        v = v.float() * (inp["v_scale"][bt][:, :, None, :, None] / 127.0)
    bs, H, D = k.shape[2:]
    k = k.reshape(S, MB * bs, H, D).permute(0, 2, 1, 3).contiguous()
    v = v.reshape(S, MB * bs, H, D).permute(0, 2, 1, 3).contiguous()
    pos = torch.arange(MB * bs, device=k.device)
    mask = (pos[None, :] < inp["context_lens"][:, None])[:, None, None, :]
    return inp["q"][:, :, None, :].contiguous(), k, v, mask


def time_ms(fn, sets, iters=300, warmup=10) -> float:
    """Mean ms per call over ``iters`` calls, cycling input sets so the
    K/V of each call is not in L2 (CUDA events, after ``warmup`` calls)."""
    for i in range(warmup):
        fn(sets[i % len(sets)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(sets[i % len(sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# profiler sessions whose device records disagree with the other
# sessions of their measurement (logged as they happen, listed in
# chiprun_out/chip_smoke.json)
PROFILER_LOSSES = []


def device_ms_by_name(fn, sets, iters, names, expect=None) -> dict:
    """Mean device time per call over ``iters`` calls (after warm-up) of
    the CUDA kernels and copies whose names contain each of ``names``
    (None: all of them): the median over three torch profiler sessions,
    or over the whole ones of more after a loss.
    The profiler drops a session's device records now and then, all of
    them or some, whether the session waits before or after its work
    (``profiler_loss.py`` measures how often; on some hosts most short
    sessions lose a block of records); a loss only lowers a session's
    sum.  A session is whole when it holds as many records as the most
    any session held and, for each name of ``expect`` (name -> records
    one call makes, its launches), ``iters`` times that many: then a
    loss that every session suffers alike is seen too.  Sessions run
    until three are whole (five at most, eight with ``expect``) and the
    median is over the whole ones; where none is, over those with the
    most records, logged as lossy.  Sessions that disagree are logged
    and listed in ``PROFILER_LOSSES``; a name with no time raises."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    expect = expect or {}
    for i in range(5):
        fn(sets[i % len(sets)])
    per = {name: [] for name in names}
    counts, named = [], []

    def median(v):
        return sorted(v)[len(v) // 2]

    def whole():
        return [i for i, c in enumerate(counts) if c == max(counts) and all(
            named[i][n] >= iters * k for n, k in expect.items())]

    for session in range(8 if expect else 5):
        if session >= 3 and len(whole()) >= 3 and (expect or (
                len(set(counts)) == 1
                and all(median(v) > 0 for v in per.values()))):
            break
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(sets[i % len(sets)])
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        counts.append(len(events))
        named.append({n: sum(n in e.name for e in events) for n in expect})
        for name in names:
            per[name].append(sum(
                e.time_range.end - e.time_range.start for e in events
                if name is None or name in e.name) / iters / 1e3)
    keep = whole()
    if not keep:
        keep = [i for i, c in enumerate(counts) if c == max(counts)]
        where = (f"{names} over {iters} calls: no session holds every record "
                 f"of {expect}: {named}; device records {counts}")
        PROFILER_LOSSES.append(where)
        log(f"  profiler lossy ({where}); taking the median of the "
            f"{len(keep)} with the most")
    elif len(set(counts)) > 1 or len(keep) < len(counts):
        where = f"{names} over {iters} calls: device records {counts}"
        PROFILER_LOSSES.append(where)
        log(f"  profiler sessions disagree ({where}); taking the median of "
            f"the {len(keep)} whole ones")
    out = {}
    for name in names:
        out[name] = median([per[name][i] for i in keep])
        if not out[name] > 0:
            raise AssertionError(f"the profiler recorded no device time for "
                                 f"{name or 'the call'} in most of "
                                 f"{len(per[name])} sessions")
    return out


def device_ms(fn, sets, iters=100, name=None) -> float:
    """Mean device time per call over ``iters`` calls (after warm-up):
    the duration of the CUDA kernels and copies the torch profiler
    records, only those whose name contains ``name`` when given.  Unlike
    ``time_ms`` it does not count the device waiting for the host, which
    is most of the time for a kernel of a few microseconds."""
    return device_ms_by_name(fn, sets, iters, [name])[name]


# K4's shapes: the decode plane's (8 slots, Transformer-base's heads, 256
# positions), an odd one, and the long-context timing case (not a path of
# the decode plane, which keeps max_seq_len 256): the contexts a
# long-context request brings, 17 to 4,096 tokens, one of exactly 4,096 and
# one of 4,095, over a table of 256 blocks that K4 cuts into context splits
PAGED_SHAPES = {
    "decode": dict(S=SLOTS, H=8, D=64, bs=BLOCK_TOKENS, MB=16, N=129,
                   cls=[1, 15, 16, 17, 256, 100, 200, 64]),
    "odd": dict(S=3, H=2, D=16, bs=4, MB=4, N=13, cls=[1, 7, 16]),
    "long": dict(S=SLOTS, H=8, D=64, bs=BLOCK_TOKENS, MB=256,
                 N=SLOTS * 256 + 1,
                 cls=[17, 4096, 4095, 1000, 2500, 333, 3800, 64]),
}
K4_KERNELS = "paged_decode"   # the kernel and, for split tables, the merge


def time_paged(A, F, shape, quantized, dev) -> dict:
    """K4, its plain version and SDPA on pre-gathered dense K/V at one
    shape, cycling input sets past the 50 MB L2: device time (the torch
    profiler's median of three sessions) for K4 and SDPA, CUDA-event
    times beside them, and the bound from these contexts."""
    one = paged_inputs(**shape, quantized=quantized, seed=3, dev=dev)
    kv_bytes = sum(t.numel() * t.element_size()
                   for t in (one["k_cache"], one["v_cache"]))
    n_sets = max(2, math.ceil(2 * L2_BYTES / kv_bytes))
    sets = [paged_inputs(**shape, quantized=quantized, seed=10 + i, dev=dev)
            for i in range(n_sets)]
    dense = [gathered(s) for s in sets]
    kernel = lambda s: A.decode_attention(**s)                  # noqa: E731
    sdpa = lambda d: F.scaled_dot_product_attention(            # noqa: E731
        d[0], d[1], d[2], attn_mask=d[3])
    out = {"ms": device_ms(kernel, sets, name=K4_KERNELS),
           "event_ms": time_ms(kernel, sets),
           "plain_ms": time_ms(lambda s: A.paged_attention_ref(**s), sets,
                               iters=50 if shape["MB"] <= 16 else 5),
           "library_ms": device_ms(sdpa, dense),
           "library_event_ms": time_ms(sdpa, dense),
           "splits": A.decode_splits(shape["S"], shape["H"], shape["D"],
                                     shape["bs"], shape["MB"], quantized,
                                     dev),
           "input_sets": n_sets, **work(one)}
    del sets, dense
    torch.cuda.empty_cache()
    return out


def check_and_time_paged_attention(dev) -> dict:
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import attention as A
    out = {}
    for dtype in ("float32", "int8"):
        quantized = dtype == "int8"
        err = 0.0
        for seed, (name, shape) in enumerate(PAGED_SHAPES.items()):
            inp = paged_inputs(**shape, quantized=quantized, seed=seed + 1,
                               dev=dev)
            got = A.decode_attention(**inp)
            torch.cuda.synchronize()
            ref = A.paged_attention_ref(**inp)
            e = (got - ref).abs().max().item()
            log(f"  {dtype} {name} S={shape['S']} H={shape['H']} "
                f"D={shape['D']} bs={shape['bs']} MB={shape['MB']}: "
                f"max|kernel - plain| = {e!r} (tolerance "
                f"{KERNEL_TOL[dtype]})")
            if not math.isfinite(e) or e > KERNEL_TOL[dtype]:
                raise AssertionError(
                    f"paged decode attention ({dtype}, {name}) disagrees "
                    f"with its plain version: {e} > {KERNEL_TOL[dtype]}")
            err = max(err, e)
            if name == "long":   # the splits merge in a fixed order
                again = A.decode_attention(**inp)
                if not torch.equal(got, again):
                    raise AssertionError(f"K4 ({dtype}) is not bit-identical "
                                         f"on a rerun at the long context")
            del inp, got, ref
        out[dtype] = {"max_abs_err": err,
                      **time_paged(A, F, PAGED_SHAPES["decode"], quantized,
                                   dev),
                      "long": time_paged(A, F, PAGED_SHAPES["long"],
                                         quantized, dev)}
        for name, r in (("decode", out[dtype]), ("long", out[dtype]["long"])):
            log(f"  {dtype} {name}: kernel {r['ms']!r} ms device "
                f"({r['event_ms']!r} CUDA events, {r['splits']} splits), "
                f"sdpa {r['library_ms']!r} ms device "
                f"({r['library_event_ms']!r} events), plain "
                f"{r['plain_ms']!r} ms, bound {r['bound_ms']!r} ms "
                f"({r['bound_by']}, {r['bytes']} bytes)")
    return out


# ---------------------------------------------------------------------------
# phase 3d: the sparse-embedding kernels against their plain versions
# ---------------------------------------------------------------------------

def sparse_ids(seed):
    """A DeepFM id batch as bench.py makes it (randint(0, sparse_dim)
    from a seed), with forced duplicates: field 1 repeats field 0."""
    ids = np.random.RandomState(seed).randint(
        0, SPARSE_ROWS, (DEEPFM_B, SPARSE_FIELDS))
    ids[:, 1] = ids[:, 0]
    return ids.astype("int64")


@functools.lru_cache(maxsize=None)
def zipf_p(H, top):
    """Zipf frequencies over ranks 1..H, p_k proportional to k^-s, with s
    set so that the first covers a ``top`` share."""
    k = np.arange(1, H + 1, dtype=np.float64)
    lo, hi = 0.0, 8.0
    for _ in range(60):   # the first rank's share grows with s
        s = (lo + hi) / 2
        lo, hi = (lo, s) if 1.0 / np.sum(k ** -s) > top else (s, hi)
    p = k ** -s
    return p / p.sum()


def zipf_ids(n, H, seed, top=SPARSE_HOT_SHARE):
    """n ids in [0, H) drawn with ``zipf_p`` frequencies (the hottest id
    a ``top`` share of the batch), the ranks spread over the rows by a
    seeded permutation."""
    rs = np.random.RandomState(seed)
    return rs.permutation(H)[rs.choice(H, n, p=zipf_p(H, top))].astype("int64")


def bits_equal(a, b) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def max_ulps(a, b) -> int:
    """Largest distance in float32 units in the last place (NaN rows
    must match as NaN)."""
    if a.shape != b.shape or not torch.equal(torch.isnan(a),
                                             torch.isnan(b)):
        return 1 << 31
    if a.numel() == 0:
        return 0
    ia = a.view(torch.int32).long()
    ib = b.view(torch.int32).long()
    # map the sign-magnitude bits onto a monotone integer line
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    d = (ia - ib).abs()
    return int(d[~torch.isnan(a)].max().item()) if d.numel() else 0


def abs_err(a, b) -> float:
    finite = torch.isfinite(a) & torch.isfinite(b)
    return float((a[finite] - b[finite]).abs().max().item()) \
        if finite.any() else 0.0


def sectors(rows, width: int) -> int:
    """32-byte sectors the float32 rows ``rows`` of a [H, width] table
    span (each counted once)."""
    start = rows.long() * width * 4
    first, last = start // 32, (start + width * 4 - 1) // 32
    spans = [first + k for k in range(int((last - first).max()) + 1)]
    keep = torch.cat([s[s <= last] for s in spans])
    return int(torch.unique(keep).numel())


def bound(nbytes, ops, ops_per_s=F32_OPS_PER_S) -> dict:
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return {"bytes": nbytes, "ops": ops, "bound_ms": max(t_b, t_o) * 1e3,
            "bound_by": "bytes" if t_b >= t_o else "operations"}


def gather_work(tables, ids) -> dict:
    """K9's least work on these ids: the ids read (4 or 8 bytes each),
    each touched row of each table read once, the outputs written; and
    the same with the touched rows counted as the 32-byte sectors they
    span."""
    n = ids.numel()
    id_b = ids.element_size() * n
    uniq = torch.unique(ids)
    rows_b = sum(uniq.numel() * t.shape[1] * 4 for t in tables)
    out_b = sum(n * t.shape[1] * 4 for t in tables)
    sec_b = sum(sectors(uniq, t.shape[1]) * 32 for t in tables)
    w = bound(id_b + rows_b + out_b, 0)
    w["sector_bytes"] = id_b + sec_b + out_b
    w["sector_bound_ms"] = w["sector_bytes"] / HBM_BYTES_PER_S * 1e3
    return w


UPDATE_OPS = {"adam": 14, "momentum": 4, "adagrad": 7}   # per element


def update_work(ids, width, kind, n_tables) -> dict:
    """K10's least work: ids and values read once, each touched row of
    each table read and written once; the merge's adds plus the math per
    unique element; and the sector count of the touched rows."""
    n = ids.numel()
    uniq = torch.unique(ids)
    u = uniq.numel()
    nbytes = 8 * n + n * width * 4 + 2 * n_tables * u * width * 4
    ops = (n - u) * width + UPDATE_OPS[kind] * u * width
    w = bound(nbytes, ops)
    w["unique_rows"] = u
    w["sector_bytes"] = (8 * n + n * width * 4
                         + 2 * n_tables * sectors(uniq, width) * 32)
    w["sector_bound_ms"] = w["sector_bytes"] / HBM_BYTES_PER_S * 1e3
    return w


SPARSE_HYPER = {"adam": dict(beta1=0.9, beta2=0.999, eps=1e-8),
                "momentum": dict(mu=0.9, nesterov=False),
                "nesterov": dict(mu=0.9, nesterov=True),
                "adagrad": dict(eps=1e-6)}


def update_tables(kind, H, D, g):
    """Random tables for ``kind``: p, then the moments (m2 and the
    adagrad moment non-negative)."""
    p = torch.randn(H, D, generator=g, device=g.device) * 0.01
    m1 = torch.randn(H, D, generator=g, device=g.device) * 1e-3
    m2 = torch.rand(H, D, generator=g, device=g.device) * 1e-6
    return {"adam": [p, m1, m2], "momentum": [p, m1], "nesterov": [p, m1],
            "adagrad": [p, m2]}[kind]


def check_update(S, sr, tables, lr, kind) -> tuple:
    """K10 and its plain version on copies of ``tables``: bit-equal, and
    the rows the batch does not touch unchanged.  Returns (ulps, abs)."""
    base = "momentum" if kind == "nesterov" else kind
    got = [t.clone() for t in tables]
    S.rowwise_update(sr, got, lr, base, **SPARSE_HYPER[kind])
    torch.cuda.synchronize()
    want = [t.clone() for t in tables]
    S.rowwise_update_ref(*S.sorted_segments(sr.rows, sr.height), sr.values,
                         want, lr, base, **SPARSE_HYPER[kind])
    H = tables[0].shape[0]
    touched = torch.zeros(H, dtype=torch.bool, device=lr.device)
    touched[torch.where(sr.rows < 0, sr.rows + H, sr.rows)] = True
    ulps = max(max_ulps(a, b) for a, b in zip(got, want))
    err = max(abs_err(a, b) for a, b in zip(got, want))
    for a, t in zip(got, tables):
        if not torch.equal(a[~touched], t[~touched]):
            raise AssertionError(f"K10 ({kind}) wrote rows the batch does "
                                 "not touch")
    if ulps > SPARSE_ULP:
        raise AssertionError(f"K10 ({kind}) differs from its plain version "
                             f"by {ulps} ulp > {SPARSE_ULP}")
    return ulps, err


def check_dyadic(S, dev) -> None:
    """Integer-valued inputs, power-of-two lr and mu: every operation is
    exact, so K10 must equal a float64 walk over the batch."""
    from paddle_tpu_torch.core.selected_rows import SelectedRows
    rs = np.random.RandomState(4)
    H, D = 23, 5
    rows = rs.randint(0, H, 9)
    rows[1] = rows[0]
    vals = rs.randint(-8, 8, (9, D)).astype("float32")
    p = rs.randint(-16, 16, (H, D)).astype("float32")
    v = rs.randint(-16, 16, (H, D)).astype("float32")
    tp = torch.tensor(p, device=dev)
    tv = torch.tensor(v, device=dev)
    S.rowwise_update(SelectedRows(torch.tensor(rows, device=dev),
                                  torch.tensor(vals, device=dev), H),
                     [tp, tv], torch.tensor(0.5, device=dev), "momentum",
                     mu=0.5, nesterov=False)
    pr, vr, merged = p.astype("float64"), v.astype("float64"), {}
    for r, g in zip(rows, vals):
        merged[int(r)] = merged.get(int(r), 0) + g.astype("float64")
    for r, g in merged.items():
        vr[r] = 0.5 * vr[r] + g
        pr[r] = pr[r] - 0.5 * vr[r]
    if not (np.array_equal(tp.cpu().numpy(), pr)
            and np.array_equal(tv.cpu().numpy(), vr)):
        raise AssertionError("K10 is not exact on dyadic inputs")


def time_sparse(S, dev) -> dict:
    """K9 and K10 (Adam on both DeepFM tables) at the bench shape,
    cycling SPARSE_TIME_SETS id batches so the touched rows come from
    device memory; beside their plain versions and the library
    yardsticks (F.embedding per table; torch.optim.SparseAdam.step on a
    coalesced gradient of the same rows), which the port never calls.
    ``ms``/``plain_ms``/``library_ms`` are device time per call
    (``device_ms``: the kernel alone, and every kernel of the plain and
    library calls); the ``*_wall_ms`` figures are CUDA-event times of a
    loop of calls, which the host's launch rate paces at these sizes.
    K10 is also timed with the sort in front (``with_sort_ms``), as the
    DeepFM step's pair (``update_step``: one sort shared by both tables'
    K10, and a sort each beside it) and on a skewed batch
    (``update_skewed``: Zipf ids, the hottest a tenth of the batch)."""
    import torch.nn.functional as F
    from paddle_tpu_torch.core.selected_rows import SelectedRows
    g = torch.Generator(device=dev).manual_seed(21)
    H, D = SPARSE_ROWS, SPARSE_EMBED
    emb = torch.randn(H, D, generator=g, device=dev) * 0.01
    w1 = torch.randn(H, 1, generator=g, device=dev) * 0.01
    ids = [torch.tensor(sparse_ids(100 + i), device=dev)
           for i in range(SPARSE_TIME_SETS)]
    idx = list(range(SPARSE_TIME_SETS))
    w = gather_work([emb, w1], ids[0])
    kernel = lambda x: S.fused_gather([emb, w1], x)  # noqa: E731
    plain = lambda x: S.fused_gather_ref([emb, w1], x)  # noqa: E731
    lib = lambda x: (F.embedding(x, emb), F.embedding(x, w1))  # noqa: E731
    w.update(ms=device_ms(kernel, ids, name="sparse_gather_kernel"),
             plain_ms=device_ms(plain, ids), library_ms=device_ms(lib, ids),
             wall_ms=time_ms(kernel, ids), plain_wall_ms=time_ms(
                 plain, ids, iters=50), library_wall_ms=time_ms(lib, ids))
    out = {"gather": w}
    hot = [torch.tensor(zipf_ids(DEEPFM_B * SPARSE_FIELDS, H, 300 + i),
                        device=dev) for i in range(SPARSE_TIME_SETS)]
    w = gather_work([emb, w1], hot[0])
    w.update(ms=device_ms(kernel, hot, name="sparse_gather_kernel"),
             library_ms=device_ms(lib, hot))
    out["gather_skewed"] = w
    del emb, w1, hot
    lr = torch.tensor(1e-4, device=dev)
    hyper = SPARSE_HYPER["adam"]
    widths = {"update_emb": D, "update_w1": 1}
    tabs = {n: update_tables("adam", H, width, g) for n, width in widths.items()}
    srs = {n: [SelectedRows(x.reshape(-1), torch.randn(
        x.numel(), width, generator=g, device=dev) * 1e-3, H) for x in ids]
        for n, width in widths.items()}
    segs = [S.sorted_segments(x.reshape(-1), H) for x in ids]
    for name, width in widths.items():
        t, sr = tabs[name], srs[name]
        param = torch.nn.Parameter(t[0].clone())
        opt = torch.optim.SparseAdam([param], lr=1e-4)
        grads = [torch.sparse_coo_tensor(s.rows[None], s.values, (H, width),
                                         check_invariants=True).coalesce()
                 for s in sr]

        def lib_step(gr):
            param.grad = gr
            opt.step()
        kernel = lambda i: S.rowwise_update_sorted(  # noqa: E731
            *segs[i], sr[i].values, t, lr, "adam", **hyper)
        wrapper = lambda i: S.rowwise_update(  # noqa: E731
            sr[i], t, lr, "adam", **hyper)
        plain = lambda i: S.rowwise_update_ref(  # noqa: E731
            *segs[i], sr[i].values, t, lr, "adam", **hyper)
        w = update_work(ids[0], width, "adam", 3)
        w.update(ms=device_ms(kernel, idx, name="sparse_update_kernel"),
                 with_sort_ms=device_ms(wrapper, idx),
                 plain_ms=device_ms(plain, idx, iters=20),
                 library_ms=device_ms(lib_step, grads),
                 wall_ms=time_ms(kernel, idx),
                 with_sort_wall_ms=time_ms(wrapper, idx),
                 plain_wall_ms=time_ms(plain, idx, iters=20),
                 library_wall_ms=time_ms(lib_step, grads, iters=100))
        out[name] = w
        del grads, param, opt

    def step(i, memo):   # both tables' updates from one id batch
        for n in widths:
            S.rowwise_update(srs[n][i], tabs[n], lr, "adam", memo, **hyper)
    shared = lambda i: step(i, {})  # noqa: E731
    apart = lambda i: step(i, None)  # noqa: E731
    out["update_step"] = {
        "ms": device_ms(shared, idx), "sort_each_ms": device_ms(apart, idx),
        "wall_ms": time_ms(shared, idx), "sort_each_wall_ms": time_ms(apart,
                                                                       idx)}
    del srs, segs
    # the skewed batch, Adam on the [1e6, 10] table
    hot = [torch.tensor(zipf_ids(DEEPFM_B * SPARSE_FIELDS, H, 300 + i),
                        device=dev) for i in range(4)]
    vals = [torch.randn(x.numel(), D, generator=g, device=dev) * 1e-3
            for x in hot]
    hsegs = [S.sorted_segments(x, H) for x in hot]
    t = tabs["update_emb"]
    kernel = lambda i: S.rowwise_update_sorted(  # noqa: E731
        *hsegs[i], vals[i], t, lr, "adam", **hyper)
    wrapper = lambda i: S.rowwise_update(  # noqa: E731
        SelectedRows(hot[i], vals[i], H), t, lr, "adam", **hyper)
    counts = torch.unique(hot[0], return_counts=True)[1]
    w = update_work(hot[0], D, "adam", 3)
    w.update(ms=device_ms(kernel, list(range(4)), name="sparse_update_kernel"),
             with_sort_ms=device_ms(wrapper, list(range(4))),
             hot_share=int(counts.max().item()) / hot[0].numel())
    out["update_skewed"] = w
    del tabs, hot, vals, hsegs
    return out


def check_and_time_sparse(dev) -> dict:
    from paddle_tpu_torch.core.selected_rows import SelectedRows
    from paddle_tpu_torch.kernels import sparse as S
    g = torch.Generator(device=dev).manual_seed(20)
    err = {"gather": 0.0, "update": 0.0}
    # K9: the bench batch, with out-of-range ids, an odd shape, empty
    emb = torch.randn(SPARSE_ROWS, SPARSE_EMBED, generator=g, device=dev)
    w1 = torch.randn(SPARSE_ROWS, 1, generator=g, device=dev)
    bench = torch.tensor(sparse_ids(0), device=dev)
    bad = bench.clone()
    bad[0, :6] = torch.tensor([-1, -SPARSE_ROWS, SPARSE_ROWS,
                               -SPARSE_ROWS - 1, 1 << 40, SPARSE_ROWS - 1])
    odd = [torch.randn(23, 5, generator=g, device=dev),
           torch.randn(23, 1, generator=g, device=dev)]
    odd_ids = torch.randint(-30, 30, (17,), generator=g, device=dev)
    # two more tables of widths 3 and 16, and the four tables each
    # starting at row 1 of a table one row taller
    more = [torch.randn(SPARSE_ROWS, d, generator=g, device=dev)
            for d in (3, 16)]
    shifted = [torch.randn(SPARSE_ROWS + 1, t.shape[1], generator=g,
                           device=dev)[1:] for t in [emb, w1] + more]
    skewed = torch.tensor(zipf_ids(bench.numel(), SPARSE_ROWS, 7),
                          device=dev)
    cases = {"bench": ([emb, w1], bench), "out_of_range": ([emb, w1], bad),
             "odd": (odd, odd_ids),
             "empty": (odd, torch.zeros(0, dtype=torch.int64, device=dev)),
             "int32_ids": ([emb, w1], bad.to(torch.int32)),
             "three_tables": ([emb, w1, more[0]], bench),
             "four_tables": ([emb, w1] + more, bad),
             "row_1_starts": (shifted, bench.to(torch.int32)),
             "skewed": ([emb, w1], skewed)}
    for name, (tabs, ids) in cases.items():
        n0 = S.fused_gather.launches
        got = S.fused_gather(tabs, ids)
        torch.cuda.synchronize()
        want = S.fused_gather_ref(tabs, ids)
        if S.fused_gather.launches - n0 != (1 if ids.numel() else 0):
            raise AssertionError(f"K9 launches at {name}")
        again = S.fused_gather(tabs, ids)
        for a, b, c in zip(got, want, again):
            if not bits_equal(a, b):
                raise AssertionError(f"K9 differs from its plain version at "
                                     f"{name}: {max_ulps(a, b)} ulp")
            if not bits_equal(c, a):
                raise AssertionError(f"K9 is not bit-identical on a rerun "
                                     f"at {name}")
            err["gather"] = max(err["gather"], abs_err(a, b))
        log(f"  K9 {name} n={ids.numel()} {ids.dtype} ids, tables "
            f"{[tuple(t.shape) for t in tabs]}: bit-equal to the plain "
            f"version and on a rerun")
    del emb, w1, more, shifted, cases
    # K10: every math variant at the bench shape, an odd one and on the
    # skewed batch
    lr = torch.tensor(1e-4, device=dev)
    for kind in ("adam", "momentum", "nesterov", "adagrad"):
        for name, (H, D, ids) in {
                "bench": (SPARSE_ROWS, SPARSE_EMBED, bench.reshape(-1)),
                "bench_w1": (SPARSE_ROWS, 1, bench.reshape(-1)),
                "skewed": (SPARSE_ROWS, SPARSE_EMBED, skewed),
                "odd": (23, 5, torch.randint(-23, 23, (17,), generator=g,
                                             device=dev))}.items():
            vals = torch.randn(ids.numel(), D, generator=g, device=dev) \
                * 1e-3
            tabs = update_tables(kind, H, D, g)
            ulps, e = check_update(S, SelectedRows(ids, vals, H), tabs, lr,
                                   kind)
            err["update"] = max(err["update"], e)
            log(f"  K10 {kind} {name} n={ids.numel()} table [{H}, {D}]: "
                f"{ulps} ulp from the plain version, untouched rows "
                f"unchanged")
            del tabs, vals
    check_dyadic(S, dev)
    log("  K10 dyadic momentum: exact")
    out = {"max_abs_err": err, **time_sparse(S, dev)}
    for n in ("gather", "update_emb", "update_w1"):
        r = out[n]
        extra = (f", with the sort {r['with_sort_ms']!r} ms (wall "
                 f"{r['with_sort_wall_ms']!r})" if "with_sort_ms" in r
                 else "")
        log(f"  {n} device ms: kernel {r['ms']!r}{extra}, plain "
            f"{r['plain_ms']!r}, library {r['library_ms']!r}; bound "
            f"{r['bound_ms']!r} ({r['bound_by']}, {r['bytes']} bytes), "
            f"sector bound {r['sector_bound_ms']!r} ({r['sector_bytes']} "
            f"bytes); wall ms per call in a loop: kernel {r['wall_ms']!r},"
            f" plain {r['plain_wall_ms']!r}, library "
            f"{r['library_wall_ms']!r}")
    r = out["gather_skewed"]
    log(f"  gather on the skewed batch, device ms: kernel {r['ms']!r}, "
        f"library {r['library_ms']!r}; bound {r['bound_ms']!r}, sector "
        f"bound {r['sector_bound_ms']!r}")
    r = out["update_step"]
    log(f"  the DeepFM step's updates (both tables), device ms: one shared "
        f"sort + K10 x2 {r['ms']!r} (wall {r['wall_ms']!r}), a sort each "
        f"{r['sort_each_ms']!r} (wall {r['sort_each_wall_ms']!r})")
    r = out["update_skewed"]
    log(f"  update_emb on the skewed batch (hottest id {r['hot_share']!r} "
        f"of it, {r['unique_rows']} unique rows), device ms: kernel "
        f"{r['ms']!r}, with the sort {r['with_sort_ms']!r}; bound "
        f"{r['bound_ms']!r}, sector bound {r['sector_bound_ms']!r}")
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 3e: the fused GRU kernels against their plain versions
# ---------------------------------------------------------------------------

def gru_inputs(dev, B, T, H, seed, lo=None):
    """Random xproj, w (scaled 1/sqrt(H)), h0, the cotangent dhs and a
    [B, T] mask whose rows keep a prefix of lo..T steps (all T when lo is
    None)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    xproj = torch.randn(B, T, 3 * H, generator=g, device=dev) * 0.5
    w = torch.randn(H, 3 * H, generator=g, device=dev) / math.sqrt(H)
    h0 = torch.randn(B, H, generator=g, device=dev) * 0.1
    lens = (torch.full((B,), T, device=dev) if lo is None else
            torch.randint(lo, T + 1, (B,), generator=g, device=dev))
    mask = (torch.arange(T, device=dev)[None] < lens[:, None]).float()
    dhs = torch.randn(B, T, H, generator=g, device=dev)
    return dict(args=(xproj, w, h0, mask), dhs=dhs, lens=lens)


def gru_work(x) -> dict:
    """The least work of K8a and K8b on these inputs, per live (row,
    step) (a masked step needs none): K8a the two products h·w_uz and
    (r ⊙ h)·w_c, 2·H·3H operations; K8b the gate recompute (2·H·3H),
    drh = db·w_c^T (2·H·H), da·w_uz^T (2·2H·H) and dW (2·H·3H), 18·H²;
    both at split TF32's rate (their products' arithmetic), with the
    float32 rate's bound beside it (``fma_bound_ms``); each input read
    once and each output written once."""
    xproj = x["args"][0]
    B, T, H3 = xproj.shape
    H = H3 // 3
    live = int(x["args"][3].sum().item())
    f4 = 4
    xb, wb, sb = B * T * H3 * f4, H * H3 * f4, B * H * f4
    mb, hb = B * T * f4, B * T * H * f4
    rows = {"fwd": (2 * live * H * H3, xb + wb + sb + mb + hb),
            "bwd": (18 * live * H * H,
                    xb + wb + sb + mb + 2 * hb + xb + wb + sb)}
    out = {}
    for name, (ops, nbytes) in rows.items():
        out[name] = {**bound(nbytes, ops, TF32X3_OPS_PER_S),
                     "live_steps": live,
                     "fma_bound_ms": bound(nbytes, ops)["bound_ms"]}
    return out


def time_cudnn_gru(dev, B, T, H) -> dict:
    """The library yardstick, never called by the port: one cuDNN GRU
    layer (``torch.nn.GRU``, TF32 off) over a [B, T, H] input, forward
    and its autograd backward (input, weights), full lengths, device
    time.  It computes a different function: cuDNN applies the reset
    gate after the recurrent product, r ⊙ (W_hn h + b_hn), where the
    reference applies it before, (r ⊙ h) W_c; and it projects the input
    inside."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        gru = torch.nn.GRU(H, H, batch_first=True).to(dev)
        x = torch.randn(B, T, H, device=dev, requires_grad=True)
        dy = torch.randn(B, T, H, device=dev)
        wrt = [x, *gru.parameters()]
        fwd = device_ms(lambda _: gru(x), [None], iters=20)
        both = device_ms(lambda _: torch.autograd.grad(gru(x)[0], wrt, dy),
                         [None], iters=20)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    return {"fwd": fwd, "bwd": both - fwd}


def time_gru(R, dev) -> dict:
    """K8a/K8b at machine translation's shape with ragged lengths 8..32:
    device time from the profiler (``device_ms``; K8b's three launches
    also one by one) and wall per call from CUDA events, the plain
    versions (CUDA events) and cuDNN's GRU (a different function, device
    time) beside the bound."""
    B, T, H = GRU_TIME_SHAPE
    x = gru_inputs(dev, B, T, H, seed=80, lo=MT_SHORTEST)
    a, dhs = x["args"], x["dhs"]
    hs = R.gru_fused(*a)
    work = gru_work(x)
    runs = {"fwd": (lambda _: R.gru_fused(*a), lambda _: R.gru_ref(*a),
                    "gru_fwd_recurrence"),
            "bwd": (lambda _: R.gru_fused_grad(*a, hs, dhs),
                    lambda _: R.gru_grad_ref(*a, hs, dhs), "gru_bwd")}
    cudnn = time_cudnn_gru(dev, B, T, H)
    for k, (kernel, plain, name) in runs.items():
        work[k].update(ms=device_ms(kernel, [None], iters=20, name=name),
                       wall_ms=time_ms(kernel, [None], iters=20),
                       plain_ms=time_ms(plain, [None], iters=3),
                       library_ms=cudnn[k])
    work["bwd"]["launch_ms"] = device_ms_by_name(runs["bwd"][0], [None], 20,
                                                 K8B_LAUNCHES)
    return work


def check_gru_op_reversed(R, dev) -> float:
    """The gru op and its grad rule on the card at the path's shape with
    ``is_reverse``, ragged lengths, H0 and a LastH cotangent: K8a/K8b
    (attr absent) against the plain scan (``use_pallas_kernel`` False).
    Returns the worst max|d|/max|ref| of the gradients."""
    from paddle_tpu_torch.core import registry
    B, T, H = GRU_TIME_SHAPE
    x = gru_inputs(dev, B, T, H, seed=81, lo=MT_SHORTEST)
    xproj, w, h0, _ = x["args"]
    ins = {"Input": [xproj], "Weight": [w], "H0": [h0],
           "SeqLen": [x["lens"].int()]}
    op = registry.get("gru")
    n = (R.gru_fused.launches, R.gru_fused_grad.launches)
    outs = {}
    for name, attrs in (("kernel", {"is_reverse": True}),
                        ("plain", {"is_reverse": True,
                                   "use_pallas_kernel": False})):
        fwd = op.lower(None, ins, attrs)
        gin = {**ins, **fwd, "Hidden@GRAD": [x["dhs"]],
               "LastH@GRAD": [x["dhs"][:, 0] * 0.5]}
        outs[name] = (fwd, op.grad(None, gin, attrs))
    if (R.gru_fused.launches, R.gru_fused_grad.launches) != (n[0] + 1,
                                                             n[1] + 1):
        raise AssertionError("the reversed gru op did not launch K8a/K8b")
    (fk, gk), (fp, gp) = outs["kernel"], outs["plain"]
    for slot in ("Hidden", "LastH"):
        e = (fk[slot][0] - fp[slot][0]).abs().max().item()
        if not (math.isfinite(e) and e <= K8A_FWD_ATOL):
            raise AssertionError(f"reversed gru op {slot}: {e} > "
                                 f"{K8A_FWD_ATOL}")
    worst = 0.0
    for slot in ("Input@GRAD", "Weight@GRAD", "H0@GRAD"):
        ref = gp[slot][0]
        ratio = ((gk[slot][0] - ref).abs().max()
                 / ref.abs().max().clamp(min=1e-30)).item()
        if not ratio <= K8B_GRAD_REL:
            raise AssertionError(f"reversed gru op {slot}: max|d|/max|ref| "
                                 f"{ratio} > {K8B_GRAD_REL}")
        worst = max(worst, ratio)
    return worst


def check_and_time_gru(dev) -> dict:
    from paddle_tpu_torch.kernels import rnn as R
    errs = {"fwd": 0.0, "bwd": 0.0}
    for i, (name, (B, T, H, lo)) in enumerate(GRU_CASES.items()):
        x = gru_inputs(dev, B, T, H, seed=70 + i, lo=lo)
        a, dhs = x["args"], x["dhs"]
        hs = R.gru_fused(*a)
        hs_again = R.gru_fused(*a)
        grads = R.gru_fused_grad(*a, hs, dhs)
        again = R.gru_fused_grad(*a, hs, dhs)
        torch.cuda.synchronize()
        if not torch.equal(hs, hs_again):
            raise AssertionError(f"K8a is not bit-identical on a rerun at "
                                 f"{name}")
        if not all(torch.equal(p, q) for p, q in zip(grads, again)):
            raise AssertionError(f"K8b is not bit-identical on a rerun at "
                                 f"{name}")
        e_f = (hs - R.gru_ref(*a)).abs().max().item()
        if not (math.isfinite(e_f) and e_f <= K8A_FWD_ATOL):
            raise AssertionError(f"K8a disagrees with its plain version at "
                                 f"{name}: {e_f} > {K8A_FWD_ATOL}")
        # the plain backward on the kernel's own hs: K8b checked alone
        e_b, worst_ratio = 0.0, 0.0
        for gname, got, ref in zip(("dxproj", "dw", "dh0"), grads,
                                   R.gru_grad_ref(*a, hs, dhs)):
            d = (got - ref).abs().max().item()
            ratio = d / max(ref.abs().max().item(), 1e-30)
            if not (torch.isfinite(got).all() and ratio <= K8B_GRAD_REL):
                raise AssertionError(
                    f"K8b {gname} disagrees with its plain version at {name}"
                    f": max|d| / max|ref| = {ratio} > {K8B_GRAD_REL}")
            e_b, worst_ratio = max(e_b, d), max(worst_ratio, ratio)
        log(f"  {name} B={B} T={T} H={H}: max|kernel - plain| hs {e_f!r} "
            f"(tolerance {K8A_FWD_ATOL}), gradients {e_b!r} (worst "
            f"max|d|/max|ref| {worst_ratio!r}, tolerance {K8B_GRAD_REL}); "
            f"forward and backward bit-identical on a rerun")
        errs["fwd"], errs["bwd"] = max(errs["fwd"], e_f), max(errs["bwd"],
                                                            e_b)
    rev = check_gru_op_reversed(R, dev)
    B, T, H = GRU_TIME_SHAPE
    log(f"  gru op, is_reverse, H0, B={B} T={T} H={H} ragged: kernel vs "
        f"plain scan, worst gradient max|d|/max|ref| {rev!r}")
    out = {"max_abs_err": errs, "reversed_op_grad_ratio": rev,
           **time_gru(R, dev)}
    for n in ("fwd", "bwd"):
        r = out[n]
        rate = f"split TF32; float32 FMA {r['fma_bound_ms']!r} ms"
        log(f"  {n}: kernel {r['ms']!r} ms of device time ({r['wall_ms']!r} "
            f"ms a call by CUDA events), plain {r['plain_ms']!r} ms, cuDNN "
            f"GRU (TF32 off; a different function, reset after the product) "
            f"{r['library_ms']!r} ms, bound {r['bound_ms']!r} ms "
            f"({r['bound_by']} at {rate}; {r['ops']} ops, {r['bytes']} "
            f"bytes)")
    log(f"    K8b by launch, device ms: {out['bwd']['launch_ms']!r}")
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 4: the decode slice end to end
# ---------------------------------------------------------------------------

def request_load(n, seed):
    """n requests: prompts of 3..120 tokens, budgets of 4..64; even ones
    greedy, odd ones seeded top-k/temperature."""
    from paddle_tpu_torch.decode import SamplingParams
    rng = np.random.RandomState(seed)
    load = []
    for i in range(n):
        p = rng.randint(0, FULL["vocab"], int(rng.randint(3, 121)))
        budget = int(rng.randint(4, 65))
        sp = (SamplingParams(max_new_tokens=budget) if i % 2 == 0 else
              SamplingParams(max_new_tokens=budget, temperature=0.8,
                             top_k=int(rng.choice([0, 8, 40])),
                             seed=1000 + i))
        load.append((p.astype(np.int32), sp))
    return load


def serve(engine, load) -> dict:
    """Submit the whole load at once; one consumer thread per stream
    stamps its tokens.  Returns the handles and the timings."""
    stamps = [[] for _ in load]
    handles, threads, errors = [], [], []

    def consume(i, h):
        try:
            for _ in h:
                stamps[i].append(time.perf_counter())
        except Exception as e:   # noqa: BLE001 — re-raised below
            errors.append(e)

    t0 = time.perf_counter()
    submitted = []
    for i, (p, sp) in enumerate(load):
        submitted.append(time.perf_counter())
        h = engine.submit(p, sp)
        handles.append(h)
        th = threading.Thread(target=consume, args=(i, h), daemon=True)
        th.start()
        threads.append(th)
    for th in threads:
        th.join(timeout=600)
        if th.is_alive():
            raise TimeoutError("a decode stream did not finish")
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    results = [h.result(timeout=10) for h in handles]
    n_tok = sum(r["n_tokens"] for r in results)
    ttft = [s[0] - t for s, t in zip(stamps, submitted)]
    tbt = [b - a for s in stamps for a, b in zip(s, s[1:])]
    return {"handles": handles, "results": results, "wall_s": wall,
            "tokens": n_tok, "tokens_per_s": n_tok / wall,
            "ttft_ms": [x * 1e3 for x in ttft],
            "tbt_ms": [x * 1e3 for x in tbt]}


def run_counted(engine, load, A):
    """Serve ``load`` with the kernel's launch count set to 0 just
    before and read just after; it must equal n_layer x decode steps."""
    steps0 = engine.stats.steps.value
    engine.stats.step_ms.reset()       # drop the warm-up's steps
    A.decode_attention.launches = 0
    res = serve(engine, load)
    launches = A.decode_attention.launches
    steps = engine.stats.steps.value - steps0
    want = engine.model.config.n_layer * steps
    log(f"  kernel launches {launches}, decode steps {steps}, "
        f"n_layer x steps = {want}")
    if steps == 0 or launches != want:
        raise AssertionError(f"paged decode attention launched {launches} "
                             f"times, expected {want}")
    res.update(launches=launches, steps=steps)
    return res


def check_greedy_against_reforward(lm, load, res) -> dict:
    """Each greedy stream against one causal re-forward of prompt +
    generated tokens on the card: logits within LOGITS_TOL, tokens
    equal.  A position where the re-forward's top two logits are
    closer than LOGITS_TOL is a tie either token may win; it is
    counted, and teacher forcing continues with the engine's token."""
    worst, ties, checked = 0.0, 0, 0
    for (p, sp), h, r in zip(load, res["handles"], res["results"]):
        if sp.temperature > 0:
            continue
        toks = r["tokens"]
        seq = torch.tensor([list(p) + toks[:-1]], device=lm.device)
        with torch.inference_mode():
            ref = lm.full_logits(seq)[0, len(p) - 1:].float().cpu().numpy()
        got = np.stack(h.logits)
        if got.shape != ref.shape or not np.isfinite(got).all():
            raise AssertionError(f"bad captured logits {got.shape}")
        worst = max(worst, float(np.abs(got - ref).max()))
        for t, tok in enumerate(toks):
            checked += 1
            best = int(ref[t].argmax())
            if best != tok:
                if ref[t, best] - ref[t, tok] > LOGITS_TOL:
                    raise AssertionError(
                        f"greedy stream diverged at token {t}: engine "
                        f"{tok}, re-forward {best} (gap "
                        f"{ref[t, best] - ref[t, tok]})")
                ties += 1
    if worst > LOGITS_TOL:
        raise AssertionError(f"paged-decode logits differ from the "
                             f"re-forward by {worst} > {LOGITS_TOL}")
    log(f"  greedy: {checked} tokens equal the re-forward argmax "
        f"({ties} near-ties), max |logits diff| {worst!r} "
        f"(tolerance {LOGITS_TOL})")
    return {"greedy_tokens_checked": checked, "near_ties": ties,
            "max_logits_diff": worst}


def pctl(xs, q) -> float:
    return float(np.percentile(np.asarray(xs), q * 100)) if xs else 0.0


def summary(engine, res) -> dict:
    return {"tokens": res["tokens"], "wall_s": res["wall_s"],
            "tokens_per_s": res["tokens_per_s"],
            "decode_steps": res["steps"], "kernel_launches": res["launches"],
            "step_ms_mean": engine.stats.step_ms.sum
            / max(engine.stats.step_ms.count, 1),
            "step_ms_p50_bucketed": engine.stats.step_ms.percentile(0.5),
            "step_ms_p99_bucketed": engine.stats.step_ms.percentile(0.99),
            "tbt_ms_p50": pctl(res["tbt_ms"], 0.5),
            "tbt_ms_p90": pctl(res["tbt_ms"], 0.9),
            "tbt_ms_p99": pctl(res["tbt_ms"], 0.99),
            "tbt_samples": len(res["tbt_ms"]),
            "ttft_ms_p50": pctl(res["ttft_ms"], 0.5),
            "ttft_samples": len(res["ttft_ms"])}


def profile_serve(engine, load) -> dict:
    """Where the time of one served load goes on the card: the device's
    busy time (union of kernel intervals from the torch profiler) over
    the wall, K4's device time and share of it, and the kernels that take
    the most device time.  If the
    profiler records no device activity the numbers are reported as not
    measured."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = serve(engine, load)
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        return {"device_busy": "not measured"}
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for a, b in spans[1:]:
        if a > cur_e:
            busy, cur_s, cur_e = busy + cur_e - cur_s, a, b
        else:
            cur_e = max(cur_e, b)
    busy += cur_e - cur_s
    window_us = (spans[-1][1] - spans[0][0])
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            t, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.end - e.time_range.start,
                               n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    k4 = sum(t for n, (t, _) in by_name.items() if K4_KERNELS in n)
    return {"wall_ms": res["wall_s"] * 1e3,
            "device_window_ms": window_us / 1e3,
            "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / window_us,
            "k4_ms": k4 / 1e3,
            "k4_launches": sum(c for n, (_, c) in by_name.items()
                               if K4_KERNELS in n),
            "k4_share_of_busy": k4 / busy,
            "kernels_launched": len(spans),
            "top_kernels": [{"name": n[:120], "ms": t / 1e3, "count": c}
                            for n, (t, c) in top]}


def run_slice(dev, card: str) -> dict:
    from paddle_tpu_torch.decode import DecodeEngine, LMConfig, TransformerLM
    from paddle_tpu_torch.kernels import attention as A
    t0 = time.perf_counter()
    lm = TransformerLM(LMConfig(**FULL), device=dev)
    lm.init_params(seed=7)
    log(f"  model built in {time.perf_counter() - t0:.1f} s "
        f"({sum(p.numel() for p in lm.parameters())} parameters)")
    load = request_load(12, seed=0)
    out = {}
    eng = DecodeEngine(lm, name="smoke_f32", max_slots=SLOTS,
                       block_tokens=BLOCK_TOKENS, prefill_buckets=BUCKETS,
                       capture_logits=True, device=dev)
    try:
        eng.generate(np.arange(20, dtype=np.int32), max_new_tokens=4)
        res = run_counted(eng, load, A)
        out["parity"] = check_greedy_against_reforward(lm, load, res)
        first = [r["tokens"][0] for r in res["results"]]
        checked_tokens = [r["tokens"] for r in res["results"]]
    finally:
        eng.close()
    # the timed run: same load, no logits readback
    eng = DecodeEngine(lm, name="smoke_f32_timed", max_slots=SLOTS,
                       block_tokens=BLOCK_TOKENS, prefill_buckets=BUCKETS,
                       device=dev)
    try:
        eng.generate(np.arange(20, dtype=np.int32), max_new_tokens=4)
        res = run_counted(eng, load, A)
        out["float32"] = summary(eng, res)
        out["float32"]["same_tokens_as_checked_run"] = (
            [r["tokens"] for r in res["results"]] == checked_tokens)
        log(f"  float32 [{card}]: {json.dumps(out['float32'])}")
        out["profile"] = profile_serve(eng, load)
    finally:
        eng.close()
    prof = out["profile"]
    log(f"  profiled run [{card}]: " + json.dumps(
        {k: v for k, v in prof.items() if k != "top_kernels"}))
    for k in prof.get("top_kernels", []):
        log(f"    {k['ms']:.3f} ms  x{k['count']}  {k['name']}")
    # int8 KV cache, shorter
    short = load[:6]
    eng = DecodeEngine(lm, name="smoke_int8", max_slots=SLOTS,
                       block_tokens=BLOCK_TOKENS, prefill_buckets=BUCKETS,
                       cache_dtype="int8", device=dev)
    try:
        eng.generate(np.arange(20, dtype=np.int32), max_new_tokens=4)
        res = run_counted(eng, short, A)
        for r, (p, sp), f in zip(res["results"], short, first):
            toks = r["tokens"]
            if len(toks) != sp.max_new_tokens or \
                    not all(0 <= t < FULL["vocab"] for t in toks):
                raise AssertionError(f"bad int8 stream {toks}")
            # the first token samples inside prefill on fresh float32
            # K/V: exact whatever the cache stores
            if toks[0] != f:
                raise AssertionError(f"int8 first token {toks[0]} != "
                                     f"float32 first token {f}")
        out["int8"] = summary(eng, res)
        same = sum(a["tokens"] == b for a, b in
                   zip(res["results"], checked_tokens))
        out["int8"]["streams_equal_to_float32"] = same
    finally:
        eng.close()
    log(f"  int8 [{card}]: {json.dumps(out['int8'])}")
    return out


# ---------------------------------------------------------------------------
# phase 3b: the flash-attention kernels against their plain versions
# ---------------------------------------------------------------------------

def flash_inputs(dev, B, H, Tq, Tk, D, seed, all_masked=False):
    """Random q/k/v/dO, a ragged [B, Tk] key mask (each row keeps a
    prefix of 1..Tk keys, as padded batches do) and an int32 seed."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, H, Tq, D, generator=g, device=dev)
    k = torch.randn(B, H, Tk, D, generator=g, device=dev)
    v = torch.randn(B, H, Tk, D, generator=g, device=dev)
    do = torch.randn(B, H, Tq, D, generator=g, device=dev)
    lens = torch.randint(1, Tk + 1, (B,), generator=g, device=dev)
    mask = (torch.arange(Tk, device=dev)[None] < lens[:, None]).float()
    if all_masked:
        mask[-1] = 0.0
    seed_t = torch.tensor([seed * 7919 + 1], dtype=torch.int32, device=dev)
    return dict(q=q, k=k, v=v, do=do, mask=mask, seed=seed_t)


def flash_run(A, x, causal, rate):
    """K1, then K2 and K3 on its LSE; returns every output."""
    out, lse = A.flash_attention_fwd(x["q"], x["k"], x["v"], x["mask"],
                                     causal, None, rate, x["seed"])
    delta = A.flash_attention_delta(out, x["do"])
    dq = A.flash_attention_bwd_dq(x["q"], x["k"], x["v"], x["mask"], lse,
                                  delta, x["do"], causal, None, rate,
                                  x["seed"])
    dk, dv = A.flash_attention_bwd_dkv(x["q"], x["k"], x["v"], x["mask"],
                                       lse, delta, x["do"], causal, None,
                                       rate, x["seed"])
    return dict(out=out, lse=lse, dq=dq, dk=dk, dv=dv)


def flash_plain(A, x, causal, rate):
    out, lse = A.flash_attention_ref(x["q"], x["k"], x["v"], x["mask"],
                                     causal, None, rate, x["seed"])
    dq, dk, dv = A.flash_attention_bwd_ref(x["q"], x["k"], x["v"],
                                           x["mask"], out, lse, x["do"],
                                           causal, None, rate, x["seed"])
    return dict(out=out, lse=lse, dq=dq, dk=dk, dv=dv)


def worst(got, ref, tol) -> float:
    """max |got - ref|; raises when any element exceeds atol + rtol|ref|."""
    atol, rtol = tol
    d = (got - ref).abs()
    if not torch.isfinite(got).all() or \
            (d > atol + rtol * ref.abs()).any():
        raise AssertionError(f"max |d| {d.max().item()} beyond "
                             f"{atol} + {rtol} |ref|")
    return d.max().item()


FLASH_CASES = {  # name: (B, H, Tq, Tk, D, causal, rate, all-masked row)
    "self": (32, 8, 256, 256, 64, False, 0.0, False),
    "self_dropout": (32, 8, 256, 256, 64, False, 0.1, False),
    "causal_dropout": (32, 8, 256, 256, 64, True, 0.1, False),
    "cross_tk320_dropout": (32, 8, 256, 320, 64, False, 0.1, False),
    "causal_t200_all_masked_row": (4, 8, 200, 200, 64, True, 0.1, True),
    # the head dims of the kernels' other widths (the seq-8k cell: 128)
    "self_d128_dropout": (8, 8, 256, 256, 128, False, 0.1, False),
    "causal_d32_dropout": (32, 8, 256, 256, 32, True, 0.1, False),
    # lengths that are multiples of neither 32 nor 64
    "cross_tq100_tk77_causal_dropout": (8, 8, 100, 77, 64, True, 0.1, False),
    "cross_tq77_tk100_dropout": (8, 8, 77, 100, 64, False, 0.1, False),
}
# the cases whose K2/K3 outputs must be bit-identical on a rerun
FLASH_RERUN = ("self_dropout", "causal_dropout")


def flash_work(x, causal) -> dict:
    """The least work of one call of each kernel on these inputs: the
    (query, key) pairs the data needs (unmasked keys, causal-allowed),
    4 / 6 / 8 operations per pair per head dim for K1 / K2 / K3, at the
    split-TF32 rate for float32 q, k, v and the bf16 tensor-core rate for
    bfloat16 ones, and each input read once, each output written once
    (q, k, v, dO and the outputs in their dtype, mask, lse and delta
    float32)."""
    B, H, Tq, D = x["q"].shape
    Tk = x["k"].shape[2]
    valid = x["mask"] > 0                                     # [B, Tk]
    if causal:
        allowed = (torch.arange(Tq, device=valid.device)[:, None]
                   >= torch.arange(Tk, device=valid.device)[None])
        pairs = int((allowed[None] & valid[:, None]).sum().item()) * H
    else:
        pairs = int(valid.sum().item()) * Tq * H
    f4, el = 4, x["q"].element_size()
    qb = B * H * Tq * D * el
    kb = B * H * Tk * D * el
    rowb = B * H * Tq * f4
    maskb = B * Tk * f4
    rows = {
        "fwd": (4 * D * pairs, qb + 2 * kb + maskb + qb + rowb),
        "bwd_dq": (6 * D * pairs, 2 * qb + 2 * kb + maskb + 2 * rowb + qb),
        "bwd_dkv": (8 * D * pairs, 2 * qb + 2 * kb + maskb + 2 * rowb
                    + 2 * kb),
    }
    # K1, K2 and K3 multiply in split TF32, or in bf16
    rate = (BF16_OPS_PER_S if x["q"].dtype == torch.bfloat16
            else TF32X3_OPS_PER_S)
    return {name: bound(nbytes, ops, rate)
            for name, (ops, nbytes) in rows.items()}


def flash_kernel_names(dtype) -> dict:
    """The profiler names of K1, K2, K3 for q's dtype."""
    tag = "_bf16" if dtype == torch.bfloat16 else ""
    return {"fwd": f"flash_fwd{tag}_kernel",
            "bwd_dq": f"flash_bwd_dq{tag}_kernel",
            "bwd_dkv": f"flash_bwd_dkv{tag}_kernel"}


def flash_as(x, dtype) -> dict:
    """x with q, k, v and dO in ``dtype`` (the mask and seed as they
    are)."""
    return {n: t.to(dtype) if n in ("q", "k", "v", "do") else t
            for n, t in x.items()}


def rel_err(got, ref, bar, what) -> float:
    """max|got - ref| / max|ref|; raises past ``bar`` or where got is not
    finite."""
    g, r = got.float(), ref.float()
    e = ((g - r).abs().max() / r.abs().max().clamp(min=1e-30)).item()
    if not (torch.isfinite(g).all() and e <= bar):
        raise AssertionError(f"{what}: max|d| / max|ref| {e} > {bar}")
    return e


def bf16_lse_tol(D, rate) -> float:
    """FLASH_BF16_LSE, plus the ones lane's share where the mass sums
    the rounded p."""
    lane = D < 128 and rate == 0.0
    return FLASH_BF16_LSE + (2.0 ** -8 / math.log(2.0) if lane else 0.0)


def flash_bwd(A, x, lse, out, causal, rate):
    """FlashAttentionFn.backward's device work: K2 given the forward's
    out in place of delta (the bfloat16 kernel computes delta itself; for
    float32 the wrapper takes the torch reduction), then K3 on that
    delta."""
    dq, delta = A.flash_attention_bwd_dq(
        x["q"], x["k"], x["v"], x["mask"], lse, None, x["do"], causal,
        None, rate, x["seed"], out=out)
    dk, dv = A.flash_attention_bwd_dkv(x["q"], x["k"], x["v"], x["mask"],
                                       lse, delta, x["do"], causal, None,
                                       rate, x["seed"])
    return dq, dk, dv


def delta_bound(out, do) -> float:
    """How far two float32 sums of rowsum(dO * O) in different orders
    may lie apart: D * 2^-23 * the largest row's sum of |dO * O|."""
    terms = (out.float() * do.float()).abs().sum(-1)
    return out.shape[-1] * 2.0 ** -23 * terms.max().item()


def check_own_delta(A, x, lse, out, causal, rate, label) -> float:
    """K2's own delta (the backward's) against flash_attention_delta;
    raises past delta_bound.  Returns max|d|."""
    _, delta = A.flash_attention_bwd_dq(
        x["q"], x["k"], x["v"], x["mask"], lse, None, x["do"], causal,
        None, rate, x["seed"], out=out)
    want = A.flash_attention_delta(out, x["do"])
    d = (delta - want).abs().max().item()
    tol = delta_bound(out, x["do"])
    if not (math.isfinite(d) and d <= tol):
        raise AssertionError(f"{label}: K2's delta off by {d} > {tol}")
    return d


def sass_counts(lib: str) -> dict:
    """{kernel function: {"HGMMA": n, "UTMALDG": n}} in the SASS of a
    built kernel library (``cuobjdump -sass``)."""
    from paddle_tpu_torch.kernels import _build
    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", _build.lib_path(lib)],
                          capture_output=True, text=True, check=True).stdout
    out, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            out[fn] = {"HGMMA": 0, "UTMALDG": 0}
        elif fn is not None:
            for op in ("HGMMA", "UTMALDG"):
                out[fn][op] += op in line
    return out


def ptxas_report(name: str) -> str:
    """nvcc's and ptxas' report on ``csrc/<name>.cu``: that of this run's
    build, else (the library was current before the run) that of a build
    of the same source with the same flags into a temporary directory."""
    from paddle_tpu_torch.kernels import _build
    if name in _build.build_info:
        return _build.build_info[name]["log"]
    with tempfile.TemporaryDirectory() as d:
        out = subprocess.run(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o",
             os.path.join(d, f"lib{name}.so"),
             os.path.join(_build.CSRC_DIR, f"{name}.cu")],
            capture_output=True, text=True, check=True)
    return out.stdout + out.stderr


def ptxas_entries(report: str) -> dict:
    """Per kernel entry of a ptxas report: registers a thread, stack
    frame and spill bytes, and whether it is a ring instantiation (the
    flash kernels' last template argument, RING, true)."""
    out = {}
    for chunk in report.split("Compiling entry function '")[1:]:
        name = chunk.split("'")[0]
        nums = {k: re.search(pat, chunk) for k, pat in (
            ("registers", r"Used (\d+) registers"),
            ("stack", r"(\d+) bytes stack frame"),
            ("spill_stores", r"(\d+) bytes spill stores"),
            ("spill_loads", r"(\d+) bytes spill loads"))}
        out[name] = {k: int(m.group(1)) if m else 0 for k, m in nums.items()}
        out[name]["ring"] = bool(re.search(r"Lb1EEEv", name))
    return out


def top_kernels(fn, n=2) -> list:
    """Names of the ``n`` CUDA kernels with the most device time in one
    call of ``fn`` (which SDPA backend ran)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    per = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per[e.name] = per.get(e.name, 0) + e.time_range.end - \
                e.time_range.start
    return sorted(per, key=per.get, reverse=True)[:n]


def flash_bwd_occupancy(A, D, Tq, Tk, dtype=torch.float32) -> dict:
    """K2's and K3's registers a thread, shared memory a block and
    resident blocks an SM (the occupancy query of flash_attn_bwd.cu, or
    of flash_attn_bwd_bf16.cu for bfloat16, which needs no lengths)."""
    import ctypes
    from paddle_tpu_torch.kernels import _build
    bf16 = dtype == torch.bfloat16
    lib = "flash_attn_bwd_bf16" if bf16 else "flash_attn_bwd"
    fn = getattr(_build.load(lib), f"{lib}_occupancy")
    args = (D,) if bf16 else (D, Tq, Tk)
    fn.argtypes = [ctypes.c_int] * (len(args) + 1) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 8)()
    err = fn(*args, torch.cuda.current_device(), out)
    if err != 0:
        raise RuntimeError(f"{lib}_occupancy: cudaError {err}")
    keys = ("registers", "static_smem", "dynamic_smem", "blocks_per_sm")
    return {name: {k: out[4 * i + j] for j, k in enumerate(keys)}
            for i, name in enumerate(("bwd_dq", "bwd_dkv"))}


def flash_fwd_bf16_occupancy(D) -> dict:
    """The bfloat16 K1's registers a thread, shared memory a block,
    resident blocks an SM and local (spill) bytes a thread at head dim D,
    for the kernel D takes without dropout and the one with dropout
    (``flash_attn_fwd_bf16_occupancy``)."""
    import ctypes
    from paddle_tpu_torch.kernels import _build
    fn = _build.load("flash_attn_fwd_bf16").flash_attn_fwd_bf16_occupancy
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 10)()
    err = fn(D, torch.cuda.current_device(), out)
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd_bf16_occupancy: cudaError {err}")
    keys = ("registers", "static_smem", "dynamic_smem", "blocks_per_sm",
            "local_bytes")
    return {name: {k: out[5 * i + j] for j, k in enumerate(keys)}
            for i, name in enumerate(("no_dropout", "dropout"))}


def time_flash(A, dev, causal, rate, dtype=torch.float32) -> dict:
    """Kernel, plain and library times at the main path's shape, q, k,
    v, dO in ``dtype``, cycling input sets so each launch reads its K/V
    from device memory.  ``ms`` is device time (the profiler): a kernel
    shorter than its wrapper's host time leaves the card idle between
    launches, which CUDA events around a loop of calls (``event_ms``)
    count."""
    import torch.nn.functional as F
    B, H, T, D = FLASH_TIME_SHAPE
    one = flash_as(flash_inputs(dev, B, H, T, T, D, seed=40), dtype)
    set_bytes = sum(one[n].numel() * one[n].element_size()
                    for n in ("q", "k", "v", "do"))
    n_sets = max(2, math.ceil(2 * L2_BYTES / set_bytes))
    sets = [flash_as(flash_inputs(dev, B, H, T, T, D, seed=41 + i), dtype)
            for i in range(n_sets)]
    for s in sets:
        s["out"], s["lse"] = A.flash_attention_fwd(
            s["q"], s["k"], s["v"], s["mask"], causal, None, rate, s["seed"])
        s["delta"] = A.flash_attention_delta(s["out"], s["do"])
        s["bias"] = s["mask"][:, None, None, :] > 0
        if causal:
            tri = torch.ones(T, T, dtype=torch.bool, device=dev).tril()
            s["bias"] = s["bias"] & tri
    args = lambda s: (s["q"], s["k"], s["v"], s["mask"])  # noqa: E731
    calls = {
        "fwd": lambda s: A.flash_attention_fwd(*args(s), causal, None, rate,
                                               s["seed"]),
        "bwd_dq": lambda s: A.flash_attention_bwd_dq(
            *args(s), s["lse"], s["delta"], s["do"], causal, None, rate,
            s["seed"]),
        "bwd_dkv": lambda s: A.flash_attention_bwd_dkv(
            *args(s), s["lse"], s["delta"], s["do"], causal, None, rate,
            s["seed"]),
        # the port's whole backward (delta + K2 + K3), the function SDPA's
        # autograd backward computes with its own delta
        "bwd": lambda s: flash_bwd(A, s, s["lse"], s["out"], causal, rate),
    }
    kernel = {**flash_kernel_names(dtype), "bwd": None}
    plain = {
        "fwd": lambda s: A.flash_attention_ref(*args(s), causal, None, rate,
                                               s["seed"]),
        "bwd_dq": lambda s: A._bwd_ref(
            *args(s), s["lse"], s["delta"], s["do"], causal, D ** -0.5,
            rate, s["seed"], True, False),
        "bwd_dkv": lambda s: A._bwd_ref(
            *args(s), s["lse"], s["delta"], s["do"], causal, D ** -0.5,
            rate, s["seed"], False, True),
    }
    # library yardstick (never called by the port): SDPA forward, and the
    # autograd backward of one SDPA call (dq, dk and dv together), at the
    # same dropout rate (its own random bits)
    for s in sets:
        s["leaves"] = [s[n].clone().requires_grad_(True)
                       for n in ("q", "k", "v")]
        s["sdpa"] = F.scaled_dot_product_attention(
            *s["leaves"], attn_mask=s["bias"], dropout_p=rate)
    lib = {
        "fwd": lambda s: F.scaled_dot_product_attention(
            s["q"], s["k"], s["v"], attn_mask=s["bias"], dropout_p=rate),
        "bwd": lambda s: torch.autograd.grad(
            s["sdpa"], s["leaves"], s["do"], retain_graph=True),
    }
    event = {n: time_ms(fn, sets, iters=100) for n, fn in calls.items()}
    dev_ms = {n: device_ms(fn, sets, iters=50, name=kernel[n])
              for n, fn in calls.items()}
    lib_event = {n: time_ms(fn, sets, iters=50) for n, fn in lib.items()}
    lib_dev = {n: device_ms(fn, sets, iters=50) for n, fn in lib.items()}
    plain_ms = {n: time_ms(fn, sets, iters=10) for n, fn in plain.items()}
    backend = top_kernels(lambda: lib["bwd"](sets[0]))
    for s in sets:
        del s["sdpa"], s["leaves"]
    work = flash_work(one, causal)
    res = {}
    for n in calls:
        ln = "fwd" if n == "fwd" else "bwd"
        res[n] = {"ms": dev_ms[n], "event_ms": event[n],
                  "library_ms": lib_dev[ln], "library_event_ms": lib_event[ln],
                  "input_sets": n_sets}
        if n in work:
            res[n].update(plain_ms=plain_ms[n], **work[n])
    res["bwd"].update(sdpa_bwd_kernels=backend,
                      bound_ms=work["bwd_dq"]["bound_ms"]
                      + work["bwd_dkv"]["bound_ms"])
    return res

def time_flash_long(A, dev) -> dict:
    """K1 (causal, float32, no dropout, no key mask) and SDPA with
    ``is_causal=True`` at FLASH_LONG_SHAPE: K1 held to SDPA's output (the
    same function; the plain version's [T, T] scores would take 8.6 GB),
    then both timed beside the bound.  q, k and v take 201 MB, past the
    L2, so no input cycling is needed."""
    import torch.nn.functional as F
    B, H, T, D = FLASH_LONG_SHAPE
    g = torch.Generator(device=dev).manual_seed(45)
    q, k, v = (torch.randn(B, H, T, D, generator=g, device=dev)
               for _ in range(3))
    out, _ = A.flash_attention_fwd(q, k, v, None, True)
    ref = F.scaled_dot_product_attention(q, k, v, is_causal=True)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    if not (math.isfinite(err) and err <= FLASH_LONG_TOL):
        raise AssertionError(f"K1 disagrees with SDPA at {FLASH_LONG_SHAPE}:"
                             f" {err} > {FLASH_LONG_TOL}")
    del out, ref
    ms = time_ms(lambda _: A.flash_attention_fwd(q, k, v, None, True),
                 [None], iters=10)
    lib = time_ms(lambda _: F.scaled_dot_product_attention(
        q, k, v, is_causal=True), [None], iters=10)
    pairs = B * H * (T * (T + 1) // 2)
    row = B * H * T * D * 4
    nbytes = 4 * row + B * H * T * 4          # q, k, v, out; lse
    out = {"shape": list(FLASH_LONG_SHAPE), "max_abs_err_vs_sdpa": err,
           "ms": ms, "library_ms": lib,
           **bound(nbytes, 4 * D * pairs, TF32X3_OPS_PER_S)}
    # K2/K3 (delta + K2 + K3 from K1's out and lse) against SDPA's
    # autograd backward, the same function
    do = torch.randn(B, H, T, D, generator=g, device=dev)
    x = dict(q=q, k=k, v=v, do=do, mask=None, seed=None)
    o, lse = A.flash_attention_fwd(q, k, v, None, True)
    got = flash_bwd(A, x, lse, o, True, 0.0)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    sdpa = F.scaled_dot_product_attention(*leaves, is_causal=True)
    ref = torch.autograd.grad(sdpa, leaves, do, retain_graph=True)
    torch.cuda.synchronize()
    rel = {n: ((a - b).abs().max() / b.abs().max()).item()
           for n, a, b in zip(("dq", "dk", "dv"), got, ref)}
    if not all(math.isfinite(r) and r <= FLASH_LONG_GRAD_REL
               for r in rel.values()):
        raise AssertionError(f"K2/K3 disagree with SDPA's backward at "
                             f"{FLASH_LONG_SHAPE}: max|d|/max|ref| {rel} > "
                             f"{FLASH_LONG_GRAD_REL}")
    del got, ref
    bwd_ms = time_ms(lambda _: flash_bwd(A, x, lse, o, True, 0.0), [None],
                     iters=5)
    lib_bwd = time_ms(lambda _: torch.autograd.grad(
        sdpa, leaves, do, retain_graph=True), [None], iters=5)
    # delta reads dO and O and writes [B*H, T]; K2 reads q, k, v, dO, lse,
    # delta and writes dq; K3 reads the same and writes dk, dv
    bwd_bytes = (2 * row + B * H * T * 4) + (5 * row + 2 * B * H * T * 4) \
        + (6 * row + 2 * B * H * T * 4)
    out["bwd"] = {"max_rel_err_vs_sdpa": rel, "ms": bwd_ms,
                  "library_ms": lib_bwd,
                  "sdpa_bwd_kernels": top_kernels(lambda: torch.autograd.grad(
                      sdpa, leaves, do, retain_graph=True)),
                  **bound(bwd_bytes, 14 * D * pairs, TF32X3_OPS_PER_S)}
    return out


def check_and_time_flash(dev) -> dict:
    from paddle_tpu_torch.kernels import attention as A
    errs = {"fwd": 0.0, "bwd_dq": 0.0, "bwd_dkv": 0.0}
    for i, (name, (B, H, Tq, Tk, D, causal, rate, all_masked)) in \
            enumerate(FLASH_CASES.items()):
        x = flash_inputs(dev, B, H, Tq, Tk, D, seed=i + 1,
                         all_masked=all_masked)
        got = flash_run(A, x, causal, rate)
        torch.cuda.synchronize()
        ref = flash_plain(A, x, causal, rate)
        e = {"fwd": max(worst(got["out"], ref["out"], FLASH_FWD_TOL),
                        worst(got["lse"], ref["lse"], FLASH_FWD_TOL)),
             "bwd_dq": worst(got["dq"], ref["dq"], FLASH_GRAD_TOL),
             "bwd_dkv": max(worst(got["dk"], ref["dk"], FLASH_GRAD_TOL),
                            worst(got["dv"], ref["dv"], FLASH_GRAD_TOL))}
        log(f"  {name} B={B} H={H} Tq={Tq} Tk={Tk} D={D} causal={causal} "
            f"dropout={rate}: max|kernel - plain| out/lse {e['fwd']!r}, "
            f"dq {e['bwd_dq']!r}, dk/dv {e['bwd_dkv']!r} (tolerance "
            f"{FLASH_FWD_TOL} / {FLASH_GRAD_TOL} as atol, rtol)")
        for n in errs:
            errs[n] = max(errs[n], e[n])
        if name in FLASH_RERUN:
            again = flash_bwd(A, x, got["lse"], got["out"], causal, rate)
            torch.cuda.synchronize()
            if not all(torch.equal(a, got[n])
                       for a, n in zip(again, ("dq", "dk", "dv"))):
                raise AssertionError(f"{name}: K2/K3 differ on a rerun")
            log(f"  {name}: K2/K3 bit-identical on a rerun")
            del again
        del x, got, ref
    out = {"max_abs_err": errs, "occupancy": {}}
    for D in (32, 64, 128):
        occ = out["occupancy"][f"D{D}"] = flash_bwd_occupancy(A, D, 256, 256)
        for n, o in occ.items():
            log(f"  {n} D={D} T=256: {o['registers']} registers a thread, "
                f"{o['static_smem']} + {o['dynamic_smem']} bytes of shared "
                f"memory a block, {o['blocks_per_sm']} blocks "
                f"({4 * o['blocks_per_sm']} warps) an SM")
    for label, causal, rate in (("self_dropout", False, 0.1),
                                ("causal_dropout", True, 0.1),
                                ("self", False, 0.0)):
        t = time_flash(A, dev, causal, rate)
        out[label] = t
        for n, r in t.items():
            if n == "bwd":
                continue
            log(f"  {label} {n}: kernel {r['ms']!r} ms device "
                f"({r['event_ms']!r} by events), plain {r['plain_ms']!r} ms, "
                f"sdpa {r['library_ms']!r} ms device "
                f"({r['library_event_ms']!r}), bound {r['bound_ms']!r} ms "
                f"({r['bound_by']}, {r['ops']} ops, {r['bytes']} bytes)")
        r = t["bwd"]
        log(f"  {label} backward, delta + K2 + K3: {r['ms']!r} ms device "
            f"({r['event_ms']!r} by events), sdpa autograd backward "
            f"{r['library_ms']!r} ms device ({r['library_event_ms']!r}; its "
            f"top kernels {[k[:60] for k in r['sdpa_bwd_kernels']]}), bound "
            f"of K2 + K3 {r['bound_ms']!r} ms")
        torch.cuda.empty_cache()
    r = out["long_causal"] = time_flash_long(A, dev)
    log(f"  long_causal fwd B,H,T,D={r['shape']}: max|K1 - sdpa| "
        f"{r['max_abs_err_vs_sdpa']!r} (tolerance {FLASH_LONG_TOL}), kernel "
        f"{r['ms']!r} ms, sdpa (is_causal) {r['library_ms']!r} ms, bound "
        f"{r['bound_ms']!r} ms ({r['bound_by']})")
    b = r["bwd"]
    log(f"  long_causal bwd: max|d|/max|ref| vs sdpa {b['max_rel_err_vs_sdpa']}"
        f" (tolerance {FLASH_LONG_GRAD_REL}), delta + K2 + K3 {b['ms']!r} ms, "
        f"sdpa autograd backward {b['library_ms']!r} ms (its top kernels "
        f"{[k[:60] for k in b['sdpa_bwd_kernels']]}), bound {b['bound_ms']!r} ms "
        f"({b['bound_by']})")
    torch.cuda.empty_cache()
    return out


def flash_long_bf16(A, dev, shape) -> dict:
    """At one of ``bench_flash_attention_long``'s shapes (causal, no mask,
    no dropout; the plain version's [T, T] scores do not fit): the
    bfloat16 K1, then delta + K2 + K3 from its out and lse, against the
    float32 kernels on the same inputs upcast (FLASH_BF16_VS_F32_REL);
    then each timed by CUDA events (launches of milliseconds) beside its
    bound at the bf16 rate, the float32 kernel's time and SDPA in
    bfloat16 (``is_causal``; its one autograd backward against delta +
    K2 + K3)."""
    import torch.nn.functional as F
    B, H, T, D = shape
    g = torch.Generator(device=dev).manual_seed(46 + D)
    x16 = {n: torch.randn(B, H, T, D, generator=g, device=dev).bfloat16()
           for n in ("q", "k", "v", "do")}
    xs = {"bf16": dict(x16, mask=None, seed=None),
          "f32": dict(flash_as(x16, torch.float32), mask=None, seed=None)}
    res = {}
    for key, x in xs.items():
        out, lse = A.flash_attention_fwd(x["q"], x["k"], x["v"], None, True)
        dq, dk, dv = flash_bwd(A, x, lse, out, True, 0.0)
        res[key] = dict(out=out, lse=lse, dq=dq, dk=dk, dv=dv)
    torch.cuda.synchronize()
    rel = {n: rel_err(res["bf16"][n], res["f32"][n], FLASH_BF16_VS_F32_REL,
                      f"bf16 {n} vs f32 at {list(shape)}")
           for n in ("out", "dq", "dk", "dv")}
    lse_d = (res["bf16"]["lse"] - res["f32"]["lse"]).abs().max().item()
    times = {}
    for key, x in xs.items():
        o, lse = res[key]["out"], res[key]["lse"]
        delta = A.flash_attention_delta(o, x["do"])
        bargs = (x["q"], x["k"], x["v"], None, lse, delta, x["do"], True)
        times[key] = {
            "fwd": time_ms(lambda _: A.flash_attention_fwd(
                x["q"], x["k"], x["v"], None, True), [None], iters=5,
                warmup=2),
            "bwd_dq": time_ms(lambda _: A.flash_attention_bwd_dq(*bargs),
                              [None], iters=3, warmup=1),
            "bwd_dkv": time_ms(lambda _: A.flash_attention_bwd_dkv(*bargs),
                               [None], iters=3, warmup=1),
            "bwd": time_ms(lambda _: flash_bwd(A, x, lse, o, True, 0.0),
                           [None], iters=3, warmup=1)}
    del res
    leaves = [x16[n].clone().requires_grad_(True) for n in ("q", "k", "v")]
    sdpa = F.scaled_dot_product_attention(*leaves, is_causal=True)
    lib = {"fwd": time_ms(lambda _: F.scaled_dot_product_attention(
        x16["q"], x16["k"], x16["v"], is_causal=True), [None], iters=5,
        warmup=2),
        "bwd": time_ms(lambda _: torch.autograd.grad(
            sdpa, leaves, x16["do"], retain_graph=True), [None], iters=3,
            warmup=1)}
    backend = top_kernels(lambda: torch.autograd.grad(
        sdpa, leaves, x16["do"], retain_graph=True))
    del sdpa, leaves
    pairs = B * H * (T * (T + 1) // 2)
    row, rowf = B * H * T * D * 2, B * H * T * 4
    work = {"fwd": (4 * D * pairs, 4 * row + rowf),
            "bwd_dq": (6 * D * pairs, 5 * row + 2 * rowf),
            "bwd_dkv": (8 * D * pairs, 6 * row + 2 * rowf)}
    out = {"shape": list(shape), "max_rel_err_vs_f32": rel,
           "max_lse_diff_vs_f32": lse_d, "sdpa_bwd_kernels": backend}
    for n, (ops, nbytes) in work.items():
        out[n] = {"ms": times["bf16"][n], "f32_ms": times["f32"][n],
                  **bound(nbytes, ops, BF16_OPS_PER_S)}
    out["fwd"]["library_ms"] = lib["fwd"]
    out["bwd"] = {"ms": times["bf16"]["bwd"], "f32_ms": times["f32"]["bwd"],
                  "library_ms": lib["bwd"],
                  "bound_ms": out["bwd_dq"]["bound_ms"]
                  + out["bwd_dkv"]["bound_ms"]}
    return out


def flash_ring_pair_bf16(A, dev) -> dict:
    """K2/K3 at the bf16 ring's pair (FLASH_RING_PAIR_BF16): against the
    plain bfloat16 version from the plain forward's lse and delta
    (FLASH_BF16_REL), K2's own delta within delta_bound; then K2 and K3
    alone and the backward (K2 with its own delta, then K3) by device
    time, cycling input sets past the L2, beside the bound at the bf16
    rate and SDPA bf16's autograd backward with the same key mask."""
    import torch.nn.functional as F
    B, H, T, D = FLASH_RING_PAIR_BF16
    n_sets = max(2, math.ceil(2 * L2_BYTES / (4 * B * H * T * D * 2)))
    sets = []
    for i in range(n_sets):
        s = flash_as(flash_inputs(dev, B, H, T, T, D, seed=70 + i),
                     torch.bfloat16)
        s["seed"] = None
        s["out"], s["lse"] = A.flash_attention_fwd(s["q"], s["k"], s["v"],
                                                   s["mask"], False)
        s["delta"] = A.flash_attention_delta(s["out"], s["do"])
        sets.append(s)
    x = sets[0]
    args = (x["q"], x["k"], x["v"], x["mask"])
    r_out, r_lse = A.flash_attention_ref(*args, False)
    r_delta = A.flash_attention_delta(r_out, x["do"])
    bargs = (*args, r_lse, r_delta, x["do"], False)
    got = (A.flash_attention_bwd_dq(*bargs),
           *A.flash_attention_bwd_dkv(*bargs))
    want = A._bwd_ref(*args, r_lse, r_delta, x["do"], False, D ** -0.5, 0.0,
                      None, True, True)
    torch.cuda.synchronize()
    out = {"shape": [B, H, T, T, D], "input_sets": n_sets,
           "max_rel_err": {n: rel_err(a, b, FLASH_BF16_REL,
                                      f"bf16 ring pair {n}")
                           for n, a, b in zip(("dq", "dk", "dv"), got,
                                              want)},
           "delta_max_abs_err": check_own_delta(A, x, r_lse, r_out, False,
                                                0.0, "bf16 ring pair")}
    del got, want, r_out, r_lse, r_delta
    sargs = lambda s: (s["q"], s["k"], s["v"], s["mask"])  # noqa: E731
    calls = {
        "bwd_dq": lambda s: A.flash_attention_bwd_dq(
            *sargs(s), s["lse"], s["delta"], s["do"], False),
        "bwd_dkv": lambda s: A.flash_attention_bwd_dkv(
            *sargs(s), s["lse"], s["delta"], s["do"], False),
        "bwd": lambda s: flash_bwd(A, s, s["lse"], s["out"], False, 0.0)}
    names = {**flash_kernel_names(torch.bfloat16), "bwd": None}
    ms = {n: device_ms(fn, sets, iters=20, name=names[n])
          for n, fn in calls.items()}
    for s in sets:
        s["leaves"] = [s[n].clone().requires_grad_(True)
                       for n in ("q", "k", "v")]
        s["sdpa"] = F.scaled_dot_product_attention(
            *s["leaves"], attn_mask=s["mask"][:, None, None, :] > 0)
    lib = device_ms(lambda s: torch.autograd.grad(
        s["sdpa"], s["leaves"], s["do"], retain_graph=True), sets, iters=20)
    backend = top_kernels(lambda: torch.autograd.grad(
        sets[0]["sdpa"], sets[0]["leaves"], sets[0]["do"],
        retain_graph=True))
    work = flash_work(x, False)
    for n in ("bwd_dq", "bwd_dkv"):
        out[n] = {"ms": ms[n], **work[n]}
    out["bwd"] = {"ms": ms["bwd"], "library_ms": lib,
                  "sdpa_bwd_kernels": backend,
                  "bound_ms": work["bwd_dq"]["bound_ms"]
                  + work["bwd_dkv"]["bound_ms"]}
    for s in sets:
        del s["sdpa"], s["leaves"]
    out["fwd"] = flash_ring_pair_fwd_bf16(A, dev, sets)
    del sets
    return out


def flash_ring_pair_fwd_bf16(A, dev, sets) -> dict:
    """K1 at the bf16 ring's pair: not causal with dropout 0.1 (an
    off-diagonal hop) and the causal diagonal at rate 0, against the plain
    bfloat16 version (FLASH_BF16_REL, bf16_lse_tol), then by device time
    beside the bound at the bf16 rate and SDPA bf16's forward with the
    same key mask (and the causal triangle)."""
    import torch.nn.functional as F
    _, _, T, D = sets[0]["q"].shape
    seed = torch.tensor([71], dtype=torch.int32, device=dev)
    tri = torch.ones(T, T, dtype=torch.bool, device=dev).tril()
    res = {}
    for label, causal, rate in (("full_dropout", False, 0.1),
                                ("diagonal", True, 0.0)):
        sd = seed if rate > 0.0 else None
        x = sets[0]
        args = (x["q"], x["k"], x["v"], x["mask"], causal, None, rate, sd)
        got, got_lse = A.flash_attention_fwd(*args)
        want, want_lse = A.flash_attention_ref(*args)
        torch.cuda.synchronize()
        rel = rel_err(got, want, FLASH_BF16_REL,
                      f"bf16 ring pair K1 {label}")
        lse_e = (got_lse - want_lse).abs().max().item()
        if not lse_e <= bf16_lse_tol(D, rate):
            raise AssertionError(f"bf16 ring pair K1 {label}: LSE off by "
                                 f"{lse_e} > {bf16_lse_tol(D, rate)}")
        del got, got_lse, want, want_lse
        for s in sets:
            s["bias"] = s["mask"][:, None, None, :] > 0
            if causal:
                s["bias"] = s["bias"] & tri
        ms = device_ms(lambda s: A.flash_attention_fwd(
            s["q"], s["k"], s["v"], s["mask"], causal, None, rate, sd), sets,
            iters=20, name=flash_kernel_names(torch.bfloat16)["fwd"])
        lib = device_ms(lambda s: F.scaled_dot_product_attention(
            s["q"], s["k"], s["v"], attn_mask=s["bias"], dropout_p=rate),
            sets, iters=20)
        for s in sets:
            del s["bias"]
        res[label] = {"causal": causal, "rate": rate, "max_rel_err": rel,
                      "lse_max_abs_diff": lse_e, "ms": ms, "library_ms": lib,
                      **flash_work(x, causal)["fwd"]}
    return res


# the ring entries at the entry level: B, H, sp and a shard of S rows, S
# a multiple of neither K1's 64/128-key tiles nor the backward's 64; the
# cases (dtype, D, dropout rate) reach each bfloat16 K1 tiling (128-key
# tiles at D=64 without dropout, 64-key ones with it or at D=128)
RING_ENTRY_SHAPE = (2, 2, 4, 200)
RING_ENTRY_CASES = ((torch.float32, 64, 0.1), (torch.bfloat16, 64, 0.0),
                    (torch.bfloat16, 128, 0.1))


def ring_entry_walk(A, x, sp, causal, rate, plain, fwd=None):
    """Every hop of a ring on one card through the ring entries (or,
    ``plain``, their plain loops, run on the card's tensors): K1's hops
    to (out, lse); given ``fwd`` = (out, lse), K2's and K3's hops from
    them to (dq, dk, dv)."""
    q, k, v, m, do = (x[n] for n in ("q", "k", "v", "mask", "do"))
    B, H, T, D = q.shape
    f32 = q.dtype == torch.float32
    seeds = A._seed_grid(x["seed"], sp)
    sm = float(1.0 / math.sqrt(D))
    hops = [h[0][1] for h in A.ring_hops([q.device] * sp, causal)]
    acc = (lambda t: t) if f32 else (  # noqa: E731
        lambda t: torch.empty(t.shape, device=t.device))
    if fwd is None:
        run = A._fwd_ring_plain if plain else A.flash_attention_fwd_ring
        out = torch.empty_like(q)
        lse = torch.empty(B * H, T, device=q.device)
        o_acc = acc(out)
        for pairs in hops:
            run(q, k, v, m, seeds, pairs, o_acc, lse, out, sm, rate)
        return out, lse
    out, lse = fwd
    delta = (A.flash_attention_delta(out, do) if f32
             else torch.empty(B * H, T, device=q.device))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    dq_acc, dk_acc, dv_acc = acc(dq), acc(dk), acc(dv)
    for t, pairs in enumerate(hops):
        own = out if (not f32 and t == 0) else None
        if plain:
            A._dq_ring_plain(q, k, v, m, seeds, pairs, lse, delta, do, dq_acc,
                             dq, sm, rate, own)
            A._dkv_ring_plain(q, k, v, m, seeds, pairs, lse, delta, do,
                              dk_acc, dv_acc, dk, dv, sm, rate)
        else:
            A.flash_attention_bwd_dq_ring(q, k, v, m, seeds, pairs, lse,
                                          delta, do, dq_acc, dq, sm, rate,
                                          out=own)
            A.flash_attention_bwd_dkv_ring(q, k, v, m, seeds, pairs, lse,
                                           delta, do, dk_acc, dv_acc, dk, dv,
                                           sm, rate)
    return dq, dk, dv


def check_ring_entries(A, dev) -> dict:
    """Phase 3b's ring-entry check: the ring entries of K1, K2 and K3
    (one launch a hop) against their plain loops on the same inputs, at
    RING_ENTRY_SHAPE (shards of 200 rows), RING_ENTRY_CASES, causal and
    not, ragged keys: K1's out and lse after the last
    hop, then K2/K3 from the plain forward's (out, lse) to dq, dk, dv,
    within phase 3b's tolerances.  Then each kernel's first hop with one
    launch a pair against the whole table's one launch: bit for bit (a
    pair's arithmetic does not depend on the grid it shares)."""
    B, H, sp, S = RING_ENTRY_SHAPE
    res = {}
    for dtype, D, rate in RING_ENTRY_CASES:
        for causal in (False, True):
            name = f"{str(dtype)[6:]}_d{D}_{'causal' if causal else 'full'}"
            x = flash_as(flash_inputs(dev, B, H, sp * S, sp * S, D,
                                      seed=150 + D + causal), dtype)
            got = ring_entry_walk(A, x, sp, causal, rate, False)
            ref = ring_entry_walk(A, x, sp, causal, rate, True)
            gb = ring_entry_walk(A, x, sp, causal, rate, False, fwd=ref)
            rb = ring_entry_walk(A, x, sp, causal, rate, True, fwd=ref)
            torch.cuda.synchronize()
            if not torch.equal(got[1] > 1e29, ref[1] > 1e29):
                raise AssertionError(f"ring entries {name}: empty rows "
                                     f"differ")
            has = ref[1] < 1e29
            lse_err = (got[1][has] - ref[1][has]).abs().max().item()
            if dtype == torch.float32:
                e = {"out": worst(got[0], ref[0], FLASH_FWD_TOL)}
                for n, a, b in zip(("dq", "dk", "dv"), gb, rb):
                    e[n] = worst(a, b, FLASH_GRAD_TOL)
                lse_tol = FLASH_FWD_TOL[0]
            else:
                e = {"out": rel_err(got[0], ref[0], FLASH_BF16_REL,
                                    f"ring entries {name} out")}
                for n, a, b in zip(("dq", "dk", "dv"), gb, rb):
                    e[n] = rel_err(a, b, FLASH_BF16_REL,
                                   f"ring entries {name} {n}")
                lse_tol = bf16_lse_tol(D, rate)
            if not lse_err <= lse_tol:
                raise AssertionError(f"ring entries {name}: lse off by "
                                     f"{lse_err} > {lse_tol}")
            e["lse"] = lse_err
            res[name] = {"max_err": e, "grid_independent":
                         ring_entry_grid_check(A, x, sp, causal)}
            log(f"  ring entries {name} (B,H={B},{H}, sp={sp}, S={S}, "
                f"dropout {rate}): vs plain {e}; first hop one launch a "
                f"pair = one launch a hop, bit for bit")
            del x, got, ref, gb, rb
    return res


def ring_entry_grid_check(A, x, sp, causal) -> bool:
    """K1's, K2's and K3's first hop through one launch of the whole
    table and through one launch a pair, on zeroed buffers: every
    output bit for bit equal, else raises."""
    q, k, v, m, do = (x[n] for n in ("q", "k", "v", "mask", "do"))
    B, H, T, D = q.shape
    seeds = A._seed_grid(x["seed"], sp)
    sm = float(1.0 / math.sqrt(D))
    hop0 = A.ring_hops([q.device] * sp, causal)[0][0][1]
    f32 = q.dtype == torch.float32
    runs = []
    for tables in ([hop0], [[p] for p in hop0]):
        z = lambda t, dt=torch.float32: torch.zeros(  # noqa: E731
            t.shape, dtype=dt, device=q.device)
        out, o_acc, lse = z(q, q.dtype), z(q), torch.zeros(
            B * H, T, device=q.device)
        delta = torch.zeros(B * H, T, device=q.device)
        g = {n: z(t, q.dtype) for n, t in (("dq", q), ("dk", k), ("dv", v))}
        ga = {n: z(t) for n, t in (("dq", q), ("dk", k), ("dv", v))}
        for tb in tables:
            A.flash_attention_fwd_ring(q, k, v, m, seeds, tb, o_acc, lse,
                                       out, sm, 0.1)
        kl = lse.masked_fill(lse < -1e29, 1e30)  # every row in kernel form
        if f32:
            delta.copy_(A.flash_attention_delta(out, do))
        for tb in tables:
            A.flash_attention_bwd_dq_ring(q, k, v, m, seeds, tb, kl, delta,
                                          do, ga["dq"], g["dq"], sm, 0.1,
                                          out=None if f32 else out)
        for tb in tables:
            A.flash_attention_bwd_dkv_ring(q, k, v, m, seeds, tb, kl, delta,
                                           do, ga["dk"], ga["dv"], g["dk"],
                                           g["dv"], sm, 0.1)
        torch.cuda.synchronize()
        runs.append([out, o_acc, lse, delta, *g.values(), *ga.values()])
    same = [torch.equal(a, b) for a, b in zip(*runs)]
    if not all(same):
        raise AssertionError(f"ring entries: one launch a pair differs from "
                             f"the hop's one launch: {same}")
    return True


def check_and_time_flash_bf16(dev, flash) -> dict:
    """Phase 3b's bfloat16 part (module doc); ``flash`` is the float32
    part's result, whose kernel times at the same shape stand beside."""
    from paddle_tpu_torch.kernels import attention as A
    errs = {"fwd": 0.0, "bwd_dq": 0.0, "bwd_dkv": 0.0}
    abs_errs = dict(errs)
    delta_errs = {}
    for i, name in enumerate(FLASH_BF16_CASES):
        B, H, Tq, Tk, D, causal, rate, all_masked = FLASH_CASES[name]
        x = flash_as(flash_inputs(dev, B, H, Tq, Tk, D, seed=100 + i,
                                  all_masked=all_masked), torch.bfloat16)
        args = (x["q"], x["k"], x["v"], x["mask"])
        out, lse = A.flash_attention_fwd(*args, causal, None, rate, x["seed"])
        r_out, r_lse = A.flash_attention_ref(*args, causal, None, rate,
                                             x["seed"])
        # K2/K3 from the plain forward's lse and delta: they then round
        # where the plain version rounds
        delta = A.flash_attention_delta(r_out, x["do"])
        bargs = (*args, r_lse, delta, x["do"], causal, None, rate, x["seed"])
        dq = A.flash_attention_bwd_dq(*bargs)
        dk, dv = A.flash_attention_bwd_dkv(*bargs)
        torch.cuda.synchronize()
        r_dq, r_dk, r_dv = A._bwd_ref(*args, r_lse, delta, x["do"], causal,
                                      D ** -0.5, rate, x["seed"], True, True)
        lse_e = (lse - r_lse).abs().max().item()
        if not lse_e <= bf16_lse_tol(D, rate):
            raise AssertionError(f"{name}: bf16 LSE off by {lse_e} > "
                                 f"{bf16_lse_tol(D, rate)}")
        pairs = {"fwd": ((out, r_out),), "bwd_dq": ((dq, r_dq),),
                 "bwd_dkv": ((dk, r_dk), (dv, r_dv))}
        e = {n: max(rel_err(a, b, FLASH_BF16_REL, f"{name} {n}")
                    for a, b in ps) for n, ps in pairs.items()}
        # the backward's own delta, from K2
        delta_errs[name] = check_own_delta(A, x, r_lse, r_out, causal, rate,
                                           f"bf16 {name}")
        for n, ps in pairs.items():
            errs[n] = max(errs[n], e[n])
            abs_errs[n] = max([abs_errs[n]] + [
                (a.float() - b.float()).abs().max().item() for a, b in ps])
        log(f"  bf16 {name} B={B} H={H} Tq={Tq} Tk={Tk} D={D} causal="
            f"{causal} dropout={rate}: max|kernel - plain| / max|plain| out "
            f"{e['fwd']!r}, dq {e['bwd_dq']!r}, dk/dv {e['bwd_dkv']!r} "
            f"(tolerance {FLASH_BF16_REL}); LSE {lse_e!r} (tolerance "
            f"{bf16_lse_tol(D, rate)!r}); K2's own delta {delta_errs[name]!r} "
            f"(within delta_bound)")
        if name in FLASH_RERUN:
            again = (*A.flash_attention_fwd(*args, causal, None, rate,
                                            x["seed"]),
                     A.flash_attention_bwd_dq(*bargs),
                     *A.flash_attention_bwd_dkv(*bargs))
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(
                    again, (out, lse, dq, dk, dv))):
                raise AssertionError(f"bf16 {name}: K1/K2/K3 differ on a "
                                     f"rerun")
            log(f"  bf16 {name}: K1/K2/K3 bit-identical on a rerun")
            del again
        del x, out, lse, r_out, r_lse, dq, dk, dv, r_dq, r_dk, r_dv
    res = {"max_rel_err": errs, "max_abs_err": abs_errs,
           "delta_max_abs_err": delta_errs, "occupancy": {},
           "fwd_occupancy": {},
           "sass": {**sass_counts("flash_attn_fwd_bf16"),
                    **sass_counts("flash_attn_bwd_bf16")}}
    for fn, n in res["sass"].items():
        log(f"  bf16 SASS {fn}: {n['HGMMA']} HGMMA, {n['UTMALDG']} UTMALDG")
    for k in ("flash_fwd_bf16_kernel", "flash_bwd_dq_bf16_kernel",
              "flash_bwd_dkv_bf16_kernel"):
        fns = [n for fn, n in res["sass"].items() if k in fn]
        if not fns or not all(n["HGMMA"] and n["UTMALDG"] for n in fns):
            raise AssertionError(f"{k}: no wgmma (HGMMA) or no TMA load "
                                 f"(UTMALDG) in its SASS: {fns}")
    # K1's wgmma groups run whole: ptxas reports each group it serializes
    # or waits for (C7512, C7515, C7517) when it builds the library
    serial = [ln.strip() for ln in ptxas_report("flash_attn_fwd_bf16")
              .splitlines()
              if any(c in ln for c in ("C7512", "C7515", "C7517"))]
    res["fwd_wgmma_serialized"] = len(serial)
    if serial:
        raise AssertionError("flash_attn_fwd_bf16: ptxas serializes or "
                             f"waits on wgmma groups: {serial[:2]}")
    log("  bf16 fwd: ptxas reports no serialized wgmma group")
    # every K1 instantiation, the ring's included, keeps 0 local bytes
    ents = res["fwd_ptxas"] = ptxas_entries(
        ptxas_report("flash_attn_fwd_bf16"))
    ring = [e for e in ents.values() if e["ring"]]
    local = {n: e for n, e in ents.items()
             if e["stack"] or e["spill_stores"] or e["spill_loads"]}
    if not ring or local:
        raise AssertionError(f"flash_attn_fwd_bf16: {len(ring)} ring "
                             f"instantiations; local bytes in {local}")
    log(f"  bf16 fwd: {len(ents)} instantiations ({len(ring)} ring), "
        f"registers {sorted({e['registers'] for e in ents.values()})}, 0 "
        f"stack and spill bytes in every one")
    for lib in ("flash_attn_bwd_bf16", "flash_attn_fwd", "flash_attn_bwd"):
        ents = res[f"ptxas_{lib}"] = ptxas_entries(ptxas_report(lib))
        for kind in (False, True):
            e = [x for x in ents.values() if x["ring"] == kind]
            log(f"  {lib} {'ring' if kind else 'plain'} instantiations: "
                f"{len(e)}, registers {sorted({x['registers'] for x in e})}"
                f", spill stores {sorted({x['spill_stores'] for x in e})} "
                f"bytes")
    for D in (32, 64, 128):
        occ = res["fwd_occupancy"][f"D{D}"] = flash_fwd_bf16_occupancy(D)
        for n, o in occ.items():
            log(f"  bf16 fwd D={D} {n}: {o['registers']} registers a thread, "
                f"{o['static_smem']} + {o['dynamic_smem']} bytes of shared "
                f"memory a block, {o['blocks_per_sm']} blocks an SM, "
                f"{o['local_bytes']} local bytes a thread")
            if o["local_bytes"] or o["blocks_per_sm"] < 1:
                raise AssertionError(f"bf16 K1 D={D} {n}: spills "
                                     f"({o['local_bytes']} local bytes) or "
                                     f"does not fit an SM: {o}")
    for D in (32, 64, 128):
        occ = res["occupancy"][f"D{D}"] = flash_bwd_occupancy(
            A, D, 256, 256, torch.bfloat16)
        for n, o in occ.items():
            log(f"  bf16 {n} D={D}: {o['registers']} registers a thread, "
                f"{o['static_smem']} + {o['dynamic_smem']} bytes of shared "
                f"memory a block, {o['blocks_per_sm']} blocks an SM")
    t = res["self_dropout"] = time_flash(A, dev, False, 0.1, torch.bfloat16)
    for n, r in t.items():
        f32_ms = flash["self_dropout"][n]["ms"]
        r["f32_ms"] = f32_ms
        if n == "bwd":
            log(f"  bf16 self_dropout backward, delta + K2 + K3: {r['ms']!r} "
                f"ms device ({r['event_ms']!r} by events; f32 {f32_ms!r}), "
                f"sdpa bf16 autograd backward {r['library_ms']!r} ms device "
                f"(its top kernels {[k[:60] for k in r['sdpa_bwd_kernels']]})"
                f", bound of K2 + K3 {r['bound_ms']!r} ms")
            continue
        log(f"  bf16 self_dropout {n}: kernel {r['ms']!r} ms device "
            f"({r['event_ms']!r} by events; f32 kernel {f32_ms!r}), plain "
            f"{r['plain_ms']!r} ms, sdpa bf16 {r['library_ms']!r} ms device, "
            f"bound {r['bound_ms']!r} ms ({r['bound_by']}, {r['ops']} ops, "
            f"{r['bytes']} bytes)")
    torch.cuda.empty_cache()
    res["long"] = {}
    for shape in FLASH_LONG_BF16_SHAPES:
        r = res["long"]["x".join(map(str, shape))] = flash_long_bf16(
            A, dev, shape)
        log(f"  bf16 long B,H,T,D={r['shape']} causal: max|bf16 - f32| / "
            f"max|f32| {r['max_rel_err_vs_f32']} (tolerance "
            f"{FLASH_BF16_VS_F32_REL}), LSE {r['max_lse_diff_vs_f32']!r}")
        for n in ("fwd", "bwd_dq", "bwd_dkv", "bwd"):
            k = r[n]
            log(f"    {n}: bf16 {k['ms']!r} ms, f32 {k['f32_ms']!r}, bound "
                f"{k['bound_ms']!r} ({k.get('bound_by', 'K2 + K3')})"
                + (f", sdpa bf16 {k['library_ms']!r}" if "library_ms" in k
                   else ""))
        torch.cuda.empty_cache()
    res["ring_entries"] = check_ring_entries(A, dev)
    torch.cuda.empty_cache()
    r = res["ring_pair"] = flash_ring_pair_bf16(A, dev)
    log(f"  bf16 ring pair B,H,Tq,Tk,D={r['shape']}: max|kernel - plain| / "
        f"max|plain| {r['max_rel_err']} (tolerance {FLASH_BF16_REL}), K2's "
        f"own delta {r['delta_max_abs_err']!r}")
    for label, k in r["fwd"].items():
        log(f"    fwd {label} (causal {k['causal']}, dropout {k['rate']}): "
            f"max|K1 - plain| / max|plain| {k['max_rel_err']!r}, LSE "
            f"{k['lse_max_abs_diff']!r}; {k['ms']!r} ms device, sdpa bf16 "
            f"{k['library_ms']!r}, bound {k['bound_ms']!r} ({k['bound_by']})")
    for n in ("bwd_dq", "bwd_dkv"):
        log(f"    {n}: {r[n]['ms']!r} ms device, bound {r[n]['bound_ms']!r} "
            f"({r[n]['bound_by']})")
    log(f"    delta + K2 + K3: {r['bwd']['ms']!r} ms device, sdpa bf16 "
        f"autograd backward {r['bwd']['library_ms']!r} (its top kernels "
        f"{[k[:60] for k in r['bwd']['sdpa_bwd_kernels']]})")
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 3c: the fused LSTM kernels against their plain versions
# ---------------------------------------------------------------------------

def lstm_inputs(dev, B, T, H, seed, lo=None):
    """Random xproj, w (scaled 1/sqrt(H)), h0/c0, cotangents dhs/dcs and a
    [B, T] mask whose rows keep a prefix of lo..T steps (all T when lo is
    None)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    xproj = torch.randn(B, T, 4 * H, generator=g, device=dev) * 0.5
    w = torch.randn(H, 4 * H, generator=g, device=dev) / math.sqrt(H)
    h0 = torch.randn(B, H, generator=g, device=dev) * 0.1
    c0 = torch.randn(B, H, generator=g, device=dev) * 0.1
    lens = (torch.full((B,), T, device=dev) if lo is None else
            torch.randint(lo, T + 1, (B,), generator=g, device=dev))
    mask = (torch.arange(T, device=dev)[None] < lens[:, None]).float()
    dhs = torch.randn(B, T, H, generator=g, device=dev)
    dcs = torch.randn(B, T, H, generator=g, device=dev)
    return dict(args=(xproj, w, h0, c0, mask), dhs=dhs, dcs=dcs)


def lstm_work(x) -> dict:
    """The least work of K6 and K7 on these inputs: 2 * H * 4H float32
    operations per live (row, step) for K6, three times that for K7
    (gate recompute, dh_prev and dW; a masked step needs none), both at
    the split-TF32 rate, and each input read once, each output written
    once."""
    xproj = x["args"][0]
    B, T, H4 = xproj.shape
    H = H4 // 4
    live = int(x["args"][4].sum().item())
    f4 = 4
    xb, wb, sb = B * T * H4 * f4, H * H4 * f4, B * H * f4
    mb, hb = B * T * f4, B * T * H * f4
    rows = {"fwd": (2 * live * H * H4, xb + wb + 2 * sb + mb + 2 * hb,
                    TF32X3_OPS_PER_S),
            "bwd": (6 * live * H * H4,
                    xb + wb + 2 * sb + mb + 4 * hb + xb + wb + 2 * sb,
                    TF32X3_OPS_PER_S)}
    return {name: {**bound(nbytes, ops, rate), "live_steps": live}
            for name, (ops, nbytes, rate) in rows.items()}


# K6's one launch (csrc/lstm_fwd.cu) and K7's three: (A) the gates, (B)
# the recurrence, (C) dW; profiler event names contain these
K6_KERNEL = "lstm_fwd_recurrence"
K7_LAUNCHES = ("lstm_bwd_gates", "lstm_bwd_recurrence", "lstm_bwd_dw")

LSTM_CASES = {  # name: (B, T, H, shortest row or None for full lengths)
    "bench_ragged": (128, 128, 512, LSTM_SHORTEST),
    "bench_full": (128, 128, 512, None),
    "odd": (3, 17, 40, 1),
    # more batch groups than the card holds side by side: they take turns
    "wide_batch": (1024, 8, 512, 1),
    # K6 at 8 units a block; K7 does not take this width (K6 alone)
    "wide_h": (128, 16, 1024, 1),
}


def time_cudnn(dev, B, T, H, tf32: bool) -> dict:
    """The library yardstick, never called by the port: one cuDNN LSTM
    layer (``torch.nn.LSTM``) over a [B, T, H] input, forward and its
    autograd backward (input, weights), full lengths."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        lstm = torch.nn.LSTM(H, H, batch_first=True).to(dev)
        x = torch.randn(B, T, H, device=dev, requires_grad=True)
        dy = torch.randn(B, T, H, device=dev)
        fwd = time_ms(lambda _: lstm(x), [None], iters=20)
        wrt = [x, *lstm.parameters()]
        both = time_ms(lambda _: torch.autograd.grad(lstm(x)[0], wrt, dy),
                       [None], iters=20)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    # the backward alone: forward + backward less the forward
    return {"fwd": fwd, "bwd": both - fwd}


def time_lstm(R, dev) -> dict:
    """K6/K7 and their plain versions at the bench shape with ragged
    lengths (the training path's data), K6/K7 at full lengths beside
    cuDNN, and the port's whole layer at full lengths (x @ Wx + b then
    K6; K7 then the projection's dWx, dx and db) beside cuDNN, which
    computes the input projection inside.  xproj alone is 134 MB, past
    the 50 MB L2, so no input cycling is needed."""
    B, T, H = LSTM_TIME_SHAPE
    out = {}
    for label, lo in (("ragged", LSTM_SHORTEST), ("full", None)):
        x = lstm_inputs(dev, B, T, H, seed=70, lo=lo)
        a, dhs, dcs = x["args"], x["dhs"], x["dcs"]
        hs, cs = R.lstm_fused(*a)
        work = lstm_work(x)
        # K6 by its device time, CUDA events beside it
        work["fwd"]["ms"] = device_ms(lambda _: R.lstm_fused(*a), [None],
                                      20, name=K6_KERNEL)
        work["fwd"]["event_ms"] = time_ms(lambda _: R.lstm_fused(*a),
                                          [None], iters=20)
        work["bwd"]["ms"] = time_ms(lambda _: R.lstm_fused_grad(
            *a, hs, cs, dhs, dcs), [None], iters=20)
        # K7's three launches by their device time
        work["bwd"]["launch_ms"] = device_ms_by_name(
            lambda _: R.lstm_fused_grad(*a, hs, cs, dhs, dcs), [None], 20,
            K7_LAUNCHES)
        if label == "ragged":
            work["fwd"]["plain_ms"] = time_ms(lambda _: R.lstm_ref(*a),
                                              [None], iters=3)
            work["bwd"]["plain_ms"] = time_ms(lambda _: R.lstm_grad_ref(
                *a, hs, cs, dhs, dcs), [None], iters=3)
        out[label] = work
    # the whole layer: projection + K6, and K7 + the projection's grads
    g = torch.Generator(device=dev).manual_seed(71)
    xin = torch.randn(B, T, H, generator=g, device=dev)
    wx = torch.randn(H, 4 * H, generator=g, device=dev) / math.sqrt(H)
    bias = torch.randn(4 * H, generator=g, device=dev) * 0.1
    w = torch.randn(H, 4 * H, generator=g, device=dev) / math.sqrt(H)
    zeros = torch.zeros(B, H, device=dev)
    ones = torch.ones(B, T, device=dev)
    dy = torch.randn(B, T, H, generator=g, device=dev)
    dc = torch.zeros(B, T, H, device=dev)

    def layer_fwd(_):
        xp = (xin.reshape(-1, H) @ wx + bias).reshape(B, T, 4 * H)
        return xp, R.lstm_fused(xp, w, zeros, zeros, ones)

    xp, (hs, cs) = layer_fwd(None)

    def layer_bwd(_):
        dxp = R.lstm_fused_grad(xp, w, zeros, zeros, ones, hs, cs, dy,
                                dc)[0].reshape(-1, 4 * H)
        return (xin.reshape(-1, H).t() @ dxp, dxp @ wx.t(), dxp.sum(0))

    layer = {"fwd": time_ms(layer_fwd, [None], iters=20),
             "bwd": time_ms(layer_bwd, [None], iters=20)}
    cudnn = time_cudnn(dev, B, T, H, tf32=False)
    cudnn_tf32 = time_cudnn(dev, B, T, H, tf32=True)
    for k in ("fwd", "bwd"):
        for label in ("ragged", "full"):
            out[label][k]["library_ms"] = cudnn[k]
        out["full"][k].update(port_layer_ms=layer[k],
                              library_tf32_ms=cudnn_tf32[k])
    return out


def check_and_time_lstm(dev) -> dict:
    from paddle_tpu_torch.kernels import rnn as R
    errs = {"fwd": 0.0, "bwd": 0.0}
    for i, (name, (B, T, H, lo)) in enumerate(LSTM_CASES.items()):
        x = lstm_inputs(dev, B, T, H, seed=60 + i, lo=lo)
        a = x["args"]
        hs, cs = R.lstm_fused(*a)
        torch.cuda.synchronize()
        ref_h, ref_c = R.lstm_ref(*a)
        e_f = max((hs - ref_h).abs().max().item(),
                  (cs - ref_c).abs().max().item())
        if not (math.isfinite(e_f) and e_f <= K6_FWD_ATOL):
            raise AssertionError(f"K6 disagrees with its plain version at "
                                 f"{name}: {e_f} > {K6_FWD_ATOL}")
        # K6's K-slices add in a fixed order: a rerun gives the same bits
        if not all(torch.equal(p, q) for p, q in zip((hs, cs),
                                                     R.lstm_fused(*a))):
            raise AssertionError(f"K6 is not bit-identical on a rerun at "
                                 f"{name}")
        if not R.lstm_eligible(B, T, H, torch.float32, R.kernel_capacity(
                "lstm_bwd", B, H, dev), "lstm_bwd"):
            log(f"  {name} B={B} T={T} H={H}: max|kernel - plain| hs/cs "
                f"{e_f!r} (tolerance {K6_FWD_ATOL}); bit-identical on a "
                f"rerun (K6 alone: K7 does not take H={H})")
            errs["fwd"] = max(errs["fwd"], e_f)
            del x, hs, cs, ref_h, ref_c
            continue
        grads = R.lstm_fused_grad(*a, hs, cs, x["dhs"], x["dcs"])
        torch.cuda.synchronize()
        # the plain backward on the kernel's own hs/cs: K7 checked alone
        ref_g = R.lstm_grad_ref(*a, hs, cs, x["dhs"], x["dcs"])
        e_b, worst_ratio = 0.0, 0.0
        for gname, got, ref in zip(("dxproj", "dw", "dh0", "dc0"), grads,
                                   ref_g):
            d = (got - ref).abs().max().item()
            ratio = d / max(ref.abs().max().item(), 1e-30)
            if not (torch.isfinite(got).all() and ratio <= K7_GRAD_REL):
                raise AssertionError(
                    f"K7 {gname} disagrees with its plain version at {name}"
                    f": max|d| / max|ref| = {ratio} > {K7_GRAD_REL}")
            e_b, worst_ratio = max(e_b, d), max(worst_ratio, ratio)
        # dW's splits add in a fixed order: a rerun gives the same bits
        again = R.lstm_fused_grad(*a, hs, cs, x["dhs"], x["dcs"])
        if not all(torch.equal(p, q) for p, q in zip(grads, again)):
            raise AssertionError(f"K7 is not bit-identical on a rerun at "
                                 f"{name}")
        del again
        log(f"  {name} B={B} T={T} H={H}: max|kernel - plain| hs/cs "
            f"{e_f!r} (tolerance {K6_FWD_ATOL}), gradients {e_b!r} "
            f"(worst max|d|/max|ref| {worst_ratio!r}, tolerance "
            f"{K7_GRAD_REL}); forward and backward bit-identical on a "
            f"rerun")
        errs["fwd"], errs["bwd"] = max(errs["fwd"], e_f), max(errs["bwd"],
                                                            e_b)
        del x, hs, cs, grads, ref_h, ref_c, ref_g
    out = {"max_abs_err": errs, **time_lstm(R, dev)}
    for label in ("ragged", "full"):
        for n, r in out[label].items():
            extra = "".join(f", {k} {r[k]!r} ms" for k in (
                "event_ms", "plain_ms", "port_layer_ms", "library_tf32_ms")
                if k in r)
            kind = "device" if n == "fwd" else "CUDA events"
            log(f"  {label} {n}: kernel {r['ms']!r} ms ({kind}), cuDNN (TF32 "
                f"off) "
                f"{r['library_ms']!r} ms{extra}, bound {r['bound_ms']!r} ms "
                f"({r['bound_by']}, {r['ops']} ops, {r['bytes']} bytes)")
            if "launch_ms" in r:
                log(f"    K7 by launch, device ms: {r['launch_ms']!r}")
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 5: Transformer training through Program -> Executor.run
# ---------------------------------------------------------------------------

def build_transformer(cfg: dict, seed: int = 3):
    """The port's Transformer training program (models/transformer.py):
    (main, startup, avg_cost, sorted parameter names)."""
    from paddle_tpu_torch.core import unique_name
    from paddle_tpu_torch.core.program import Program, program_guard
    from paddle_tpu_torch.models import transformer
    main, startup = Program(), Program()
    main.random_seed = startup.random_seed = seed
    with program_guard(main, startup), unique_name.guard():
        _, loss, _ = transformer.build(**cfg)
    return main, startup, loss, sorted(p.name for p in main.all_parameters())


def train_feed(B: int, T: int, vocab: int, seed: int) -> dict:
    """One seeded batch: token ids and ragged [B, T] masks (each row a
    prefix of T/2..T tokens), as bench.py makes its data."""
    rs = np.random.RandomState(seed)
    m = np.zeros((B, T), "float32")
    for b in range(B):
        m[b, : rs.randint(T // 2, T + 1)] = 1
    return {"src_ids": rs.randint(0, vocab, (B, T)).astype("int64"),
            "tgt_ids": rs.randint(0, vocab, (B, T)).astype("int64"),
            "lbl_ids": rs.randint(0, vocab, (B, T)).astype("int64"),
            "src_mask": m, "tgt_mask": m.copy()}


def flash_launches(A) -> tuple:
    return (A.flash_attention_fwd.launches, A.flash_attention_bwd_dq.launches,
            A.flash_attention_bwd_dkv.launches)


def reset_flash_launches(A) -> None:
    A.flash_attention_fwd.launches = 0
    A.flash_attention_bwd_dq.launches = 0
    A.flash_attention_bwd_dkv.launches = 0


def check_train_step_against_cpu(dev, dtype="float32") -> dict:
    """One step of a 2-layer full-width program (B=4, T=64, dropout 0)
    on the card and on the CPU from the same copied starting values:
    the loss and every parameter gradient agree (the kernels against
    their plain versions through append_backward).  With ``dtype``
    bfloat16 (the bench's), a bfloat16 gradient is held within
    FLASH_BF16_REL of max|ref| (one rounding of the largest value: each
    is a float32 sum rounded once), a float32 one within
    TRAIN_GRAD_TOL."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.kernels import attention as A
    cfg = dict(TRAIN, n_layer=2, max_len=64, dropout=0.0, dtype=dtype)
    main, startup, loss, params = build_transformer(cfg)
    init = fluid.Scope()
    fluid.Executor("cpu").run(startup, scope=init)
    values = init.to_numpy()
    feed = train_feed(4, 64, cfg["tgt_vocab"], seed=5)
    fetch = [loss.name] + [p + "@GRAD" for p in params]
    bf16 = {p for p in params if init.find_var(p).dtype == torch.bfloat16}
    out = {}
    for name, device in (("cpu", "cpu"), ("gpu", dev)):
        scope = fluid.Scope()
        scope.load_numpy(values, device=device)
        n0 = flash_launches(A)
        out[name] = fluid.Executor(device).run(main, feed=feed,
                                               fetch_list=fetch, scope=scope)
        out[name + "_launches"] = tuple(
            b - a for a, b in zip(n0, flash_launches(A)))
    # one launch per attention block: encoder self, decoder self, cross
    want = 3 * cfg["n_layer"] if torch.device(dev).type == "cuda" else 0
    if out["gpu_launches"] != (want,) * 3 or \
            out["cpu_launches"] != (0, 0, 0):
        raise AssertionError(f"flash launches card {out['gpu_launches']}, "
                             f"CPU {out['cpu_launches']}; expected {want} "
                             f"each on the card and none on the CPU")
    l_cpu, l_gpu = float(out["cpu"][0]), float(out["gpu"][0])
    loss_rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    if not math.isfinite(l_gpu) or loss_rel > TRAIN_LOSS_TOL:
        raise AssertionError(f"loss card {l_gpu} vs CPU {l_cpu}")
    ratios = {}
    for name, g, r in zip(params, out["gpu"][1:], out["cpu"][1:]):
        g, r = np.asarray(g, np.float32), np.asarray(r, np.float32)
        tol = FLASH_BF16_REL if name in bf16 else TRAIN_GRAD_TOL
        scale = float(np.abs(r).max())
        ratios[name] = float(np.abs(g - r).max()) / max(scale, 1e-30)
        if not np.isfinite(g).all() or ratios[name] > tol:
            raise AssertionError(f"gradient of {name}: max|d| / max|ref| = "
                                 f"{ratios[name]} > {tol}")
    worst_p = max(ratios, key=ratios.get)
    log(f"  2-layer {dtype} step, card vs CPU: loss {l_gpu!r} vs {l_cpu!r} "
        f"(rel {loss_rel!r}), {len(params)} gradients ({len(bf16)} "
        f"bfloat16), worst max|d|/max|ref| {ratios[worst_p]!r} ({worst_p}; "
        f"tolerance {TRAIN_GRAD_TOL}, bfloat16 {FLASH_BF16_REL})")
    return {"loss_gpu": l_gpu, "loss_cpu": l_cpu, "loss_rel_diff": loss_rel,
            "n_grads": len(params), "n_bf16_grads": len(bf16),
            "worst_grad_ratio": ratios[worst_p],
            "worst_grad_param": worst_p}


def profile_step(exe, main, feed, loss, focus, count=()) -> dict:
    """One training step under the torch profiler (``profile_call``)."""
    return profile_call(lambda: exe.run(main, feed=feed, fetch_list=[loss],
                                        sync=True), focus, count)


def profile_call(run, focus, count=()) -> dict:
    """One call of ``run`` (a training step, a serving dispatch) under
    the torch profiler: device busy time over its window, the device
    time of the kernels whose names contain each of ``focus`` and their
    share, and the kernels with the most device time.  One more call
    runs first inside the same profiler session and is left out (the
    device events from the moment the measured call's
    ``record_function`` span opens are kept): a session can drop its
    first device event, which would otherwise be the call's first
    kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
        with record_function("chip_smoke.profiled_step"):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    # the span itself also shows on the device's timeline (a user
    # annotation): it marks the start and is no kernel
    marks = [e.time_range.start for e in prof.events()
             if e.name == "chip_smoke.profiled_step"]
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and e.name != "chip_smoke.profiled_step"
              and marks and e.time_range.start >= min(marks)]
    if not events:
        return {"device_busy": "not measured"}
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for a, b in spans[1:]:
        if a > cur_e:
            busy, cur_s, cur_e = busy + cur_e - cur_s, a, b
        else:
            cur_e = max(cur_e, b)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    by_name = {}
    for e in events:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.end - e.time_range.start, n + 1)
    total = sum(t for t, _ in by_name.values())
    copies = sum(t for n, (t, _) in by_name.items()
                 if n.startswith(("Memcpy", "Memset")))
    named = {k: sum(t for n, (t, _) in by_name.items() if k in n)
             for k in focus}
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return {"wall_ms": wall * 1e3, "device_window_ms": window / 1e3,
            "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / window,
            # the host's time before the first kernel and after the last
            # (a fetch's copy into numpy) is outside the device window
            "device_idle_share_of_wall": 1.0 - busy / (wall * 1e6),
            "kernels_launched": len(events),
            "kernel_ms_total": total / 1e3,
            # copies and memsets (a fetch's copy to the host leads a
            # serving dispatch), inside kernel_ms_total
            "copy_ms": copies / 1e3,
            "focus_ms": {k: v / 1e3 for k, v in named.items()},
            "focus_share_of_kernel_time": sum(named.values()) / total,
            "focus_share_of_busy": {k: v / busy for k, v in named.items()},
            "counted": {k: {"launches": sum(c for n, (_, c)
                                            in by_name.items() if k in n),
                            "ms": sum(t for n, (t, _) in by_name.items()
                                      if k in n) / 1e3}
                        for k in count},
            "top_kernels": [{"name": n[:120], "ms": t / 1e3, "count": c}
                            for n, (t, c) in top]}


def run_training(dev, card: str, dtype="float32") -> dict:
    """Phase 5 (module doc) in ``dtype``: the 2-layer parity, then the
    full model's steps; in bfloat16 the profiled step's flash kernels
    must all be the float32 ones."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import lowering
    from paddle_tpu_torch.kernels import attention as A
    out = {"dtype": dtype,
           "parity": check_train_step_against_cpu(dev, dtype)}
    t0 = time.perf_counter()
    main, startup, loss, params = build_transformer(dict(TRAIN, dtype=dtype))
    n_ops = len(main.global_block.ops)
    exe = fluid.Executor(dev)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    n_params = sum(scope.find_var(p).numel() for p in params)
    log(f"  Transformer-base {dtype} program: {n_ops} ops, {n_params} "
        f"parameters, built and initialized on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    feed = train_feed(TRAIN_B, TRAIN["max_len"], TRAIN["tgt_vocab"], seed=11)
    torch.cuda.reset_peak_memory_stats()
    lowering.grad_recomputes = 0
    reset_flash_launches(A)
    losses, step_ms = [], []
    with fluid.scope_guard(scope):
        for _ in range(TRAIN_STEPS):
            t = time.perf_counter()
            (l,) = exe.run(main, feed=feed, fetch_list=[loss], sync=True)
            step_ms.append((time.perf_counter() - t) * 1e3)
            losses.append(float(l))
    launches = flash_launches(A)
    recomputes = lowering.grad_recomputes
    # 18 a step at 6+6 layers: encoder self, decoder self and cross
    want = (3 * TRAIN["n_layer"] * TRAIN_STEPS
            if torch.device(dev).type == "cuda" else 0)
    log(f"  {TRAIN_STEPS} steps: launches K1/K2/K3 {launches} (expected "
        f"{want} each), grad recomputes {recomputes}")
    if launches != (want, want, want) or recomputes != 0:
        raise AssertionError(f"flash launches {launches} (want {want} each),"
                             f" grad recomputes {recomputes} (want 0)")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    steady = step_ms[2:]
    med = float(np.median(steady))
    tokens = TRAIN_B * TRAIN["max_len"]
    out.update({
        "ops": n_ops, "parameters": n_params, "steps": TRAIN_STEPS,
        "losses": losses, "step_ms": step_ms, "step_ms_median": med,
        "target_tokens_per_s": tokens / (med / 1e3),
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "launches": launches, "grad_recomputes": recomputes})
    log(f"  training {dtype} [{card}]: step ms median {med!r} (steps 3.."
        f"{TRAIN_STEPS}"
        f", all {[round(x, 2) for x in step_ms]}), target tokens/s "
        f"{out['target_tokens_per_s']!r}, loss {losses[0]!r} -> "
        f"{losses[-1]!r}, max memory allocated "
        f"{out['max_memory_allocated']} bytes")
    f32_names = tuple(flash_kernel_names(torch.float32).values())
    bf16_names = tuple(flash_kernel_names(torch.bfloat16).values())
    with fluid.scope_guard(scope):
        prof = profile_step(exe, main, feed, loss, f32_names,
                            count=f32_names + bf16_names)
    out["profile"] = prof
    log(f"  profiled {dtype} step [{card}]: " + json.dumps(
        {k: v for k, v in prof.items() if k != "top_kernels"}))
    # the bench's bfloat16 program feeds float32 q, k, v to its attention
    # (the positional add promotes): its 18 launches a step of each
    # (counted above) are the float32 kernels.  By name in the profiled
    # step: none bfloat16, each float32 one present (a session that loses
    # records can only lower a count)
    by_name = {n: c["launches"] for n, c in prof.get("counted", {}).items()}
    out["kernels_by_name"] = by_name or "not measured"
    log(f"  profiled {dtype} step: flash kernels by name "
        f"{out['kernels_by_name']}")
    if by_name and (any(by_name[n] for n in bf16_names)
                    or not all(by_name[n] for n in f32_names)):
        raise AssertionError(f"{dtype} step: flash kernels by name {by_name}"
                             f", expected float32 ones only")
    for k in prof.get("top_kernels", []):
        log(f"    {k['ms']:.3f} ms  x{k['count']}  {k['name']}")
    del scope, exe
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 7: stacked-LSTM training through Program -> Executor.run
# ---------------------------------------------------------------------------

def build_stacked_lstm(seed: int = 3):
    """The port's stacked-LSTM training program (models/stacked_lstm.py):
    (main, startup, avg_cost, sorted parameter names)."""
    from paddle_tpu_torch.core import unique_name
    from paddle_tpu_torch.core.program import Program, program_guard
    from paddle_tpu_torch.models import stacked_lstm
    main, startup = Program(), Program()
    main.random_seed = startup.random_seed = seed
    with program_guard(main, startup), unique_name.guard():
        _, loss, _ = stacked_lstm.build(**LSTM_TRAIN)
    return main, startup, loss, sorted(p.name for p in main.all_parameters())


def lstm_feed(B: int, T: int, seed: int, shortest: int) -> dict:
    """One seeded batch: word ids [B, T, 1], ragged lengths
    shortest..T (``words@LEN``) and binary labels."""
    rs = np.random.RandomState(seed)
    return {"words": rs.randint(0, LSTM_TRAIN["dict_dim"], (B, T, 1))
            .astype("int64"),
            "words@LEN": rs.randint(shortest, T + 1, B).astype("int64"),
            "label": rs.randint(0, LSTM_TRAIN["class_dim"], (B, 1))
            .astype("int64")}


def lstm_launches(R) -> tuple:
    return R.lstm_fused.launches, R.lstm_fused_grad.launches


def check_lstm_step_against_cpu(dev) -> dict:
    """One step of the full-width stacked LSTM with a small ragged batch
    (B=8, T=32, a length-1 row) on the card and on the CPU from the same
    copied starting values: the loss and every parameter gradient agree
    (K6/K7 against their plain versions through append_backward)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.kernels import rnn as R
    main, startup, loss, params = build_stacked_lstm()
    init = fluid.Scope()
    fluid.Executor("cpu").run(startup, scope=init)
    values = init.to_numpy()
    feed = lstm_feed(8, 32, seed=5, shortest=1)
    feed["words@LEN"][0] = 1
    fetch = [loss.name] + [p + "@GRAD" for p in params]
    out = {}
    for name, device in (("cpu", "cpu"), ("gpu", dev)):
        scope = fluid.Scope()
        scope.load_numpy(values, device=device)
        n0 = lstm_launches(R)
        out[name] = fluid.Executor(device).run(main, feed=feed,
                                               fetch_list=fetch, scope=scope)
        out[name + "_launches"] = tuple(
            b - a for a, b in zip(n0, lstm_launches(R)))
    n_lstm = LSTM_TRAIN["stacked_num"]
    if out["gpu_launches"] != (n_lstm, n_lstm) or \
            out["cpu_launches"] != (0, 0):
        raise AssertionError(f"K6/K7 launches card {out['gpu_launches']}, "
                             f"CPU {out['cpu_launches']}; expected {n_lstm} "
                             f"each on the card and none on the CPU")
    l_cpu, l_gpu = float(out["cpu"][0]), float(out["gpu"][0])
    loss_rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    if not math.isfinite(l_gpu) or loss_rel > TRAIN_LOSS_TOL:
        raise AssertionError(f"loss card {l_gpu} vs CPU {l_cpu}")
    ratios = {}
    for name, g, r in zip(params, out["gpu"][1:], out["cpu"][1:]):
        scale = float(np.abs(r).max())
        ratios[name] = float(np.abs(g - r).max()) / max(scale, 1e-30)
        if not np.isfinite(g).all() or ratios[name] > TRAIN_GRAD_TOL:
            raise AssertionError(f"gradient of {name}: max|d| / max|ref| = "
                                 f"{ratios[name]} > {TRAIN_GRAD_TOL}")
    worst_p = max(ratios, key=ratios.get)
    log(f"  full-width step B=8 T=32, card vs CPU: loss {l_gpu!r} vs "
        f"{l_cpu!r} (rel {loss_rel!r}), {len(params)} gradients, worst "
        f"max|d|/max|ref| {ratios[worst_p]!r} ({worst_p}; tolerance "
        f"{TRAIN_GRAD_TOL})")
    return {"loss_gpu": l_gpu, "loss_cpu": l_cpu, "loss_rel_diff": loss_rel,
            "n_grads": len(params), "worst_grad_ratio": ratios[worst_p],
            "worst_grad_param": worst_p}


def run_stacked_lstm(dev, card: str) -> dict:
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import lowering
    from paddle_tpu_torch.kernels import rnn as R
    out = {"parity": check_lstm_step_against_cpu(dev)}
    t0 = time.perf_counter()
    main, startup, loss, params = build_stacked_lstm()
    n_ops = len(main.global_block.ops)
    exe = fluid.Executor(dev)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    n_params = sum(scope.find_var(p).numel() for p in params)
    log(f"  stacked-LSTM program: {n_ops} ops, {n_params} parameters, built "
        f"and initialized on the card in {time.perf_counter() - t0:.1f} s")
    feed = lstm_feed(LSTM_B, LSTM_T, seed=11, shortest=LSTM_SHORTEST)
    torch.cuda.reset_peak_memory_stats()
    lowering.grad_recomputes = 0
    R.lstm_fused.launches = R.lstm_fused_grad.launches = 0
    losses, step_ms = [], []
    with fluid.scope_guard(scope):
        for _ in range(LSTM_STEPS):
            t = time.perf_counter()
            (l,) = exe.run(main, feed=feed, fetch_list=[loss], sync=True)
            step_ms.append((time.perf_counter() - t) * 1e3)
            losses.append(float(l))
    launches = lstm_launches(R)
    recomputes = lowering.grad_recomputes
    want = LSTM_TRAIN["stacked_num"] * LSTM_STEPS
    log(f"  {LSTM_STEPS} steps: launches K6/K7 {launches} (expected {want} "
        f"each), grad recomputes {recomputes}")
    if launches != (want, want) or recomputes != 0:
        raise AssertionError(f"K6/K7 launches {launches} (want {want} each), "
                             f"grad recomputes {recomputes} (want 0)")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    med = float(np.median(step_ms[2:]))
    tokens = LSTM_B * LSTM_T
    out.update({
        "ops": n_ops, "parameters": n_params, "steps": LSTM_STEPS,
        "live_tokens": int(feed["words@LEN"].sum()),
        "losses": losses, "step_ms": step_ms, "step_ms_median": med,
        "tokens_per_s": tokens / (med / 1e3),
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "launches": launches, "grad_recomputes": recomputes})
    log(f"  training [{card}]: step ms median {med!r} (steps 3..{LSTM_STEPS}"
        f", all {[round(x, 2) for x in step_ms]}), tokens/s (padding "
        f"counted) {out['tokens_per_s']!r}, loss {losses[0]!r} -> "
        f"{losses[-1]!r}, max memory allocated "
        f"{out['max_memory_allocated']} bytes")
    with fluid.scope_guard(scope):
        prof = profile_step(exe, main, feed, loss, (K6_KERNEL,) + K7_LAUNCHES)
    if "focus_ms" in prof:
        k7 = sum(prof["focus_ms"][n] for n in K7_LAUNCHES)
        prof["k6_ms"] = prof["focus_ms"][K6_KERNEL]
        prof["k7_ms"] = k7
        prof["k6_share_of_kernel_time"] = (prof["k6_ms"]
                                           / prof["kernel_ms_total"])
        prof["k7_share_of_kernel_time"] = k7 / prof["kernel_ms_total"]
        log(f"  K6 {prof['k6_ms']!r} ms ({prof['k6_share_of_kernel_time']!r}"
            f" of the step's kernel time), K7 {k7!r} ms "
            f"({prof['k7_share_of_kernel_time']!r})")
    out["profile"] = prof
    log(f"  profiled step [{card}]: " + json.dumps(
        {k: v for k, v in prof.items() if k != "top_kernels"}))
    for k in prof.get("top_kernels", []):
        log(f"    {k['ms']:.3f} ms  x{k['count']}  {k['name']}")
    del scope, exe
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 8: DeepFM sparse-embedding training through Executor.run
# ---------------------------------------------------------------------------

def build_deepfm(seed: int = 3):
    """The port's DeepFM training program (models/deepfm.py): (main,
    startup, avg_cost, sorted parameter names)."""
    from paddle_tpu_torch.core import unique_name
    from paddle_tpu_torch.core.program import Program, program_guard
    from paddle_tpu_torch.models import deepfm
    main, startup = Program(), Program()
    main.random_seed = startup.random_seed = seed
    with program_guard(main, startup), unique_name.guard():
        _, loss, _ = deepfm.build(**DEEPFM)
    return main, startup, loss, sorted(p.name for p in main.all_parameters())


def deepfm_feed(B: int, seed: int) -> dict:
    """One seeded batch as bench.py makes DeepFM's (dense randn, ids
    randint(0, sparse_dim), labels randint(0, 2))."""
    rs = np.random.RandomState(seed)
    return {"dense": rs.randn(B, DEEPFM["dense_dim"]).astype("float32"),
            "sparse": rs.randint(0, SPARSE_ROWS, (B, SPARSE_FIELDS))
            .astype("int64"),
            "label": rs.randint(0, 2, (B, 1)).astype("float32")}


def sparse_launches(S) -> tuple:
    """K9's and K10's launches and the sorts in front of K10."""
    return (S.fused_gather.launches, S.rowwise_update.launches,
            S.sorted_segments.launches)


def table_state(names) -> list:
    """The tables and their Adam moments and powers."""
    return sorted(n for n in names if n.startswith(DEEPFM_TABLES))


def ratio(got, ref) -> float:
    return float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()),
                                                1e-30)


def check_deepfm_step_against_cpu(dev) -> dict:
    """One flag-on step at full width (sparse_dim 1e6, B=64) on the card
    and on the CPU from the same copied starting values: the loss, every
    gradient, and both tables and their moments after the step agree."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core.selected_rows import SelectedRows
    from paddle_tpu_torch.kernels import sparse as S
    main, startup, loss, params = build_deepfm()
    init = fluid.Scope()
    fluid.Executor("cpu").run(startup, scope=init)
    values = init.to_numpy()
    state = table_state(values)
    feed = deepfm_feed(DEEPFM_PARITY_B, seed=5)
    fetch = [loss.name] + [p + "@GRAD" for p in params]
    out = {}
    fluid.set_flags({"sparse_fused_kernel": True})
    try:
        for name, device in (("cpu", "cpu"), ("gpu", dev)):
            scope = fluid.Scope()
            scope.load_numpy(values, device=device)
            n0 = sparse_launches(S)
            res = fluid.Executor(device).run(main, feed=feed,
                                             fetch_list=fetch, scope=scope)
            out[name + "_launches"] = tuple(
                b - a for a, b in zip(n0, sparse_launches(S)))
            out[name] = [r.values.cpu().numpy()
                         if isinstance(r, SelectedRows) else r for r in res]
            out[name + "_rows"] = [r.rows.cpu().numpy() for r in res
                                   if isinstance(r, SelectedRows)]
            out[name + "_state"] = scope.to_numpy(state)
    finally:
        fluid.set_flags({"sparse_fused_kernel": False})
    # one K9 launch for both tables, one K10 launch per table, one sort
    # for both (the CPU sorts too, and launches no kernel)
    want = (1, 2, 1) if torch.device(dev).type == "cuda" else (0, 0, 1)
    if out["gpu_launches"] != want or out["cpu_launches"] != (0, 0, 1):
        raise AssertionError(f"K9/K10 launches and sorts card "
                             f"{out['gpu_launches']}, CPU "
                             f"{out['cpu_launches']}; expected {want} on the "
                             f"card and (0, 0, 1) on the CPU")
    if not all(np.array_equal(a, b) for a, b in zip(out["gpu_rows"],
                                                    out["cpu_rows"])):
        raise AssertionError("sparse gradient rows differ card vs CPU")
    l_cpu, l_gpu = float(out["cpu"][0]), float(out["gpu"][0])
    loss_rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    if not math.isfinite(l_gpu) or loss_rel > TRAIN_LOSS_TOL:
        raise AssertionError(f"loss card {l_gpu} vs CPU {l_cpu}")
    ratios = {}
    for name, g, r in zip(params, out["gpu"][1:], out["cpu"][1:]):
        ratios[name] = ratio(g, r)
        if not np.isfinite(g).all() or ratios[name] > TRAIN_GRAD_TOL:
            raise AssertionError(f"gradient of {name}: max|d| / max|ref| = "
                                 f"{ratios[name]} > {TRAIN_GRAD_TOL}")
    state_ratios = {}
    for name in state:
        got, ref = out["gpu_state"][name], out["cpu_state"][name]
        if name in DEEPFM_TABLES:
            upd = ref - values[name]
            state_ratios[name] = ratio(got - values[name], upd)
            tol = DEEPFM_TABLE_TOL
        else:
            state_ratios[name] = ratio(got, ref)
            tol = TRAIN_GRAD_TOL
        if not np.isfinite(got).all() or state_ratios[name] > tol:
            raise AssertionError(f"{name} after the step: {state_ratios[name]}"
                                 f" > {tol}")
    worst_p = max(ratios, key=ratios.get)
    log(f"  full-width step B={DEEPFM_PARITY_B}, card vs CPU: loss "
        f"{l_gpu!r} vs {l_cpu!r} (rel {loss_rel!r}), {len(params)} "
        f"gradients, worst max|d|/max|ref| {ratios[worst_p]!r} ({worst_p}; "
        f"tolerance {TRAIN_GRAD_TOL}); tables and moments "
        f"{json.dumps(state_ratios)} (tables: max|d| / max|update|, "
        f"tolerance {DEEPFM_TABLE_TOL}; moments {TRAIN_GRAD_TOL})")
    return {"loss_gpu": l_gpu, "loss_cpu": l_cpu, "loss_rel_diff": loss_rel,
            "n_grads": len(params), "worst_grad_ratio": ratios[worst_p],
            "worst_grad_param": worst_p, "state_ratios": state_ratios}


def train_deepfm(exe, main, loss, feed, scope, flag: bool) -> dict:
    """DEEPFM_STEPS steps with FLAGS_sparse_fused_kernel = ``flag`` and
    the launch counts set to 0 just before and read just after."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import lowering
    from paddle_tpu_torch.kernels import sparse as S
    fluid.set_flags({"sparse_fused_kernel": flag})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lowering.grad_recomputes = 0
    S.fused_gather.launches = S.rowwise_update.launches = 0
    S.sorted_segments.launches = 0
    losses, step_ms = [], []
    with fluid.scope_guard(scope):
        for _ in range(DEEPFM_STEPS):
            t = time.perf_counter()
            (l,) = exe.run(main, feed=feed, fetch_list=[loss], sync=True)
            step_ms.append((time.perf_counter() - t) * 1e3)
            losses.append(float(l))
    launches = sparse_launches(S)
    recomputes = lowering.grad_recomputes
    on_card = torch.device(exe.device).type == "cuda"
    # one sort a step, shared by the two tables' K10 launches
    want = ((DEEPFM_STEPS, 2 * DEEPFM_STEPS, DEEPFM_STEPS) if flag and on_card
            else (0, 0, 0))
    log(f"  flag {'on' if flag else 'off'}, {DEEPFM_STEPS} steps: launches "
        f"K9/K10 and sorts {launches} (expected {want}), grad recomputes "
        f"{recomputes}")
    if launches != want or recomputes != 0:
        raise AssertionError(f"K9/K10 launches and sorts {launches} (want "
                             f"{want}), grad recomputes {recomputes} (want 0)")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    med = float(np.median(step_ms[2:]))
    return {"losses": losses, "step_ms": step_ms, "step_ms_median": med,
            "samples_per_s": DEEPFM_B / (med / 1e3),
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "launches": launches, "grad_recomputes": recomputes}


def run_deepfm(dev, card: str) -> dict:
    import paddle_tpu_torch as fluid
    out = {"parity": check_deepfm_step_against_cpu(dev)}
    t0 = time.perf_counter()
    main, startup, loss, params = build_deepfm()
    n_ops = len(main.global_block.ops)
    exe = fluid.Executor(dev)
    init = fluid.Scope()
    exe.run(startup, scope=init)
    start = init.to_numpy()
    del init
    n_params = sum(start[p].size for p in params)
    log(f"  DeepFM program: {n_ops} ops, {n_params} parameters, built and "
        f"initialized on the card in {time.perf_counter() - t0:.1f} s")
    feed = deepfm_feed(DEEPFM_B, seed=0)
    state = table_state(start)
    tables = {}
    try:
        for flag in (True, False):
            scope = fluid.Scope()
            scope.load_numpy(start, device=dev)
            run = train_deepfm(exe, main, loss, feed, scope, flag)
            tables[flag] = scope.to_numpy(state)
            key = "fused" if flag else "masked_dense"
            log(f"  training, {key} [{card}]: step ms median "
                f"{run['step_ms_median']!r} (steps 3..{DEEPFM_STEPS}, all "
                f"{[round(x, 2) for x in run['step_ms']]}), samples/s "
                f"{run['samples_per_s']!r}, loss {run['losses'][0]!r} -> "
                f"{run['losses'][-1]!r}, max memory allocated "
                f"{run['max_memory_allocated']} bytes")
            with fluid.scope_guard(scope):
                # "Sort": the sort's kernels (cub's radix sort)
                run["profile"] = profile_step(
                    exe, main, feed, loss,
                    ("sparse_gather_kernel", "sparse_update_kernel", "Sort"))
            prof = run["profile"]
            log(f"  profiled step, {key} [{card}]: " + json.dumps(
                {k: v for k, v in prof.items() if k != "top_kernels"}))
            for k in prof.get("top_kernels", []):
                log(f"    {k['ms']:.3f} ms  x{k['count']}  {k['name']}")
            out[key] = run
            del scope
    finally:
        fluid.set_flags({"sparse_fused_kernel": False})
    rtol, atol = DEEPFM_FLAG_TOL
    diffs = {}
    for name in state:
        a, b = tables[True][name], tables[False][name]
        diffs[name] = float(np.abs(a - b).max())
        if name in DEEPFM_TABLES and not np.allclose(a, b, rtol=rtol,
                                                     atol=atol):
            raise AssertionError(f"{name}: flag on and off differ by "
                                 f"{diffs[name]} (rtol {rtol}, atol {atol})")
    log(f"  flag on vs off after {DEEPFM_STEPS} steps, max|d|: "
        f"{json.dumps(diffs)} (tables within rtol {rtol}, atol {atol})")
    out.update({"ops": n_ops, "parameters": n_params,
                "flag_on_vs_off_max_abs": diffs})
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 9: machine-translation training through Executor.run
# ---------------------------------------------------------------------------

def build_mt(seed: int = 3):
    """The port's machine-translation training program
    (models/machine_translation.py at its defaults): (main, startup,
    avg_cost, sorted parameter names)."""
    from paddle_tpu_torch.core import unique_name
    from paddle_tpu_torch.core.program import Program, program_guard
    from paddle_tpu_torch.models import machine_translation
    main, startup = Program(), Program()
    main.random_seed = startup.random_seed = seed
    with program_guard(main, startup), unique_name.guard():
        _, loss = machine_translation.build(**MT_TRAIN)
    return main, startup, loss, sorted(p.name for p in main.all_parameters())


def mt_feed(B: int, seed: int) -> dict:
    """One seeded batch: source, target and label ids and ragged [B, T]
    source and target masks (each row a prefix of 8..T tokens)."""
    rs = np.random.RandomState(seed)
    T, V = MT_TRAIN["max_len"], MT_TRAIN["tgt_vocab"]
    t = np.arange(T)[None, :]
    masks = [(t < rs.randint(MT_SHORTEST, T + 1, (B, 1))).astype("float32")
             for _ in range(2)]
    return {"src_ids": rs.randint(0, V, (B, T)).astype("int64"),
            "tgt_ids": rs.randint(0, V, (B, T)).astype("int64"),
            "lbl_ids": rs.randint(0, V, (B, T)).astype("int64"),
            "src_mask": masks[0], "tgt_mask": masks[1]}


def gru_launches(R) -> tuple:
    return R.gru_fused.launches, R.gru_fused_grad.launches


def check_mt_step_against_cpu(dev) -> dict:
    """One step of the full-width machine-translation program with a
    small ragged batch (B=8) on the card and on the CPU from the same
    copied starting values: the loss and every parameter gradient agree,
    the dec.* ones included, which only static_rnn_grad reaches (K8a/K8b
    and the sub-block tape against the plain versions)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.kernels import rnn as R
    main, startup, loss, params = build_mt()
    init = fluid.Scope()
    fluid.Executor("cpu").run(startup, scope=init)
    values = init.to_numpy()
    feed = mt_feed(MT_PARITY_B, seed=5)
    fetch = [loss.name] + [p + "@GRAD" for p in params]
    out = {}
    for name, device in (("cpu", "cpu"), ("gpu", dev)):
        scope = fluid.Scope()
        scope.load_numpy(values, device=device)
        n0 = gru_launches(R)
        out[name] = fluid.Executor(device).run(main, feed=feed,
                                               fetch_list=fetch, scope=scope)
        out[name + "_launches"] = tuple(
            b - a for a, b in zip(n0, gru_launches(R)))
    if out["gpu_launches"] != (2, 2) or out["cpu_launches"] != (0, 0):
        raise AssertionError(f"K8a/K8b launches card {out['gpu_launches']}, "
                             f"CPU {out['cpu_launches']}; expected 2 each on "
                             f"the card and none on the CPU")
    l_cpu, l_gpu = float(out["cpu"][0]), float(out["gpu"][0])
    loss_rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    if not math.isfinite(l_gpu) or loss_rel > TRAIN_LOSS_TOL:
        raise AssertionError(f"loss card {l_gpu} vs CPU {l_cpu}")
    ratios = {}
    for name, g, r in zip(params, out["gpu"][1:], out["cpu"][1:]):
        scale = float(np.abs(r).max())
        ratios[name] = float(np.abs(g - r).max()) / max(scale, 1e-30)
        if not (scale > 0 and np.isfinite(g).all()
                and ratios[name] <= TRAIN_GRAD_TOL):
            raise AssertionError(f"gradient of {name}: max|ref| {scale}, "
                                 f"max|d| / max|ref| = {ratios[name]} "
                                 f"(tolerance {TRAIN_GRAD_TOL})")
    worst_p = max(ratios, key=ratios.get)
    dec = [p for p in params if p.startswith("dec.")]
    worst_dec = max(dec, key=ratios.get)
    log(f"  full-width step B={MT_PARITY_B} T={MT_TRAIN['max_len']}, card "
        f"vs CPU: loss {l_gpu!r} vs {l_cpu!r} (rel {loss_rel!r}), "
        f"{len(params)} gradients, all non-zero, worst max|d|/max|ref| "
        f"{ratios[worst_p]!r} ({worst_p}; tolerance {TRAIN_GRAD_TOL}); "
        f"{len(dec)} dec.* gradients through static_rnn_grad, worst "
        f"{ratios[worst_dec]!r} ({worst_dec})")
    return {"loss_gpu": l_gpu, "loss_cpu": l_cpu, "loss_rel_diff": loss_rel,
            "n_grads": len(params), "grad_ratios": ratios,
            "worst_grad_ratio": ratios[worst_p], "worst_grad_param": worst_p}


def run_machine_translation(dev, card: str) -> dict:
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import lowering
    from paddle_tpu_torch.kernels import rnn as R
    out = {"parity": check_mt_step_against_cpu(dev)}
    t0 = time.perf_counter()
    main, startup, loss, params = build_mt()
    n_ops = [len(b.ops) for b in main.blocks]
    exe = fluid.Executor(dev)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    n_params = sum(scope.find_var(p).numel() for p in params)
    log(f"  machine-translation program: {n_ops} ops (top-level block, "
        f"decoder step), {n_params} parameters, built and initialized on "
        f"the card in {time.perf_counter() - t0:.1f} s")
    feed = mt_feed(MT_B, seed=11)
    torch.cuda.reset_peak_memory_stats()
    lowering.grad_recomputes = 0
    R.gru_fused.launches = R.gru_fused_grad.launches = 0
    losses, step_ms = [], []
    with fluid.scope_guard(scope):
        for _ in range(MT_STEPS):
            t = time.perf_counter()
            (l,) = exe.run(main, feed=feed, fetch_list=[loss], sync=True)
            step_ms.append((time.perf_counter() - t) * 1e3)
            losses.append(float(l))
    launches = gru_launches(R)
    recomputes = lowering.grad_recomputes
    want = 2 * MT_STEPS         # the two encoder directions a step
    log(f"  {MT_STEPS} steps: launches K8a/K8b {launches} (expected {want} "
        f"each), grad recomputes {recomputes}")
    if launches != (want, want) or recomputes != 0:
        raise AssertionError(f"K8a/K8b launches {launches} (want {want} "
                             f"each), grad recomputes {recomputes} (want 0)")
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"training loss not finite and falling: "
                             f"{losses}")
    med = float(np.median(step_ms[2:]))
    tokens = MT_B * MT_TRAIN["max_len"]
    out.update({
        "ops": n_ops, "parameters": n_params, "steps": MT_STEPS,
        "live_target_tokens": int(feed["tgt_mask"].sum()),
        "losses": losses, "step_ms": step_ms, "step_ms_median": med,
        "tokens_per_s": tokens / (med / 1e3),
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "launches": launches, "grad_recomputes": recomputes})
    log(f"  training [{card}]: step ms median {med!r} (steps 3..{MT_STEPS}"
        f", all {[round(x, 2) for x in step_ms]}), tokens/s (padding "
        f"counted) {out['tokens_per_s']!r}, loss {losses[0]!r} -> "
        f"{losses[-1]!r}, max memory allocated "
        f"{out['max_memory_allocated']} bytes")
    with fluid.scope_guard(scope):
        prof = profile_step(exe, main, feed, loss,
                            ("gru_fwd_recurrence",) + K8B_LAUNCHES)
    out["profile"] = prof
    log(f"  profiled step [{card}]: " + json.dumps(
        {k: v for k, v in prof.items() if k != "top_kernels"}))
    if "focus_ms" in prof:
        k8b = sum(prof["focus_ms"][k] for k in K8B_LAUNCHES)
        log(f"  K8b {k8b!r} ms of the step's {prof['device_busy_ms']!r} ms "
            f"of device busy time ({k8b / prof['device_busy_ms']:.2%}; "
            f"K8a {prof['focus_share_of_busy']['gru_fwd_recurrence']:.2%})")
    for k in prof.get("top_kernels", []):
        log(f"    {k['ms']:.3f} ms  x{k['count']}  {k['name']}")
    del scope, exe
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 3f: the fused-dequant int8 FC (K5) against its plain version
# ---------------------------------------------------------------------------

def int8_case(dev, M, K, N, seed):
    """Random float32 activations x [M, K], a weight [K, N] (scaled
    1/sqrt(K)) quantized per out channel as the quantize_int8 pass does,
    and a bias [N]."""
    from paddle_tpu_torch.kernels import quant as Q
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(M, K, generator=g, device=dev)
    w = torch.randn(K, N, generator=g, device=dev) / math.sqrt(K)
    q, s = Q.quantize_weight(w.cpu().numpy())
    b = torch.randn(N, generator=g, device=dev) * 0.1
    return x, torch.from_numpy(q).to(dev), torch.from_numpy(s).to(dev), b


def int8_work(M, K, N) -> dict:
    """K5's least work: int8 codes read once (M*K + K*N bytes), the
    float32 scales and bias (8N) and the float32 output (4MN), against
    2MNK int8 operations at the H100's dense int8 tensor-core peak."""
    nbytes = M * K + K * N + 4 * M * N + 8 * N
    ops = 2 * M * N * K
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S
    return {"bytes": nbytes, "ops": ops, "bound_ms": max(t_b, t_o) * 1e3,
            "bound_by": "bytes" if t_b >= t_o else "operations"}


def check_int8_fc(Q, dev) -> dict:
    """K5 against its plain version at the path's four shapes, an odd
    shape and one row, every act with a dynamic and a calibrated scale:
    bit for bit for "" and relu, within INT8_FC_REL * max|ref|
    otherwise.  Returns the largest |kernel - plain| per act."""
    errs = {a or "none": 0.0 for a in INT8_ACTS}
    for i, (name, (M, K, N, _)) in enumerate(INT8_CHECK.items()):
        x, q, s, b = int8_case(dev, M, K, N, seed=90 + i)
        for act in INT8_ACTS:
            for in_scale in (0.0, 4.0):
                got = Q.int8_fc(x, q, s, in_scale, b, act)
                want = Q.int8_fc_plain(x, q, s, in_scale, b, act)
                torch.cuda.synchronize()
                d = (got - want).abs().max().item()
                tol = (0.0 if act in ("", "relu")
                       else INT8_FC_REL * want.abs().max().item())
                if not (torch.isfinite(got).all() and d <= tol):
                    raise AssertionError(
                        f"K5 disagrees with its plain version at {name} "
                        f"[{M}, {K}] x [{K}, {N}], act {act!r}, in_scale "
                        f"{in_scale}: max|d| {d} > {tol}")
                errs[act or "none"] = max(errs[act or "none"], d)
        del x, q, s, b
        log(f"  {name} [{M}, {K}] x [{K}, {N}]: every act, dynamic and "
            f"calibrated scale: '' and relu bit for bit, sigmoid/tanh/gelu "
            f"within {INT8_FC_REL} * max|ref|")
    return errs


def int8_config(M, N, K, dev) -> dict:
    """The tile and occupancy K5 takes at this shape
    (``int8_fc_config``)."""
    import ctypes
    from paddle_tpu_torch.kernels import _build
    fn = _build.load("int8_fc").int8_fc_config
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    v = (ctypes.c_int * 6)()
    err = fn(M, N, K, dev.index, v)
    if err != 0:
        raise RuntimeError(f"int8_fc_config: cudaError {err}")
    keys = ("tile_m", "tile_n", "blocks", "blocks_per_sm", "registers",
            "smem_bytes")
    out = dict(zip(keys, v))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out["waves"] = out["blocks"] / (sms * out["blocks_per_sm"])
    return out


def time_int8_fc(Q, dev) -> dict:
    """K5 at the path's four bucket-8 shapes with the path's acts and the
    dynamic scale, each weight's K-major copy made (by its first launch)
    before the timing, as on the int8 path: the kernel's device time
    (profiler, K5 alone), the wrapper's (quantize + K5) device time, the plain
    version, and two library yardsticks the port never calls:
    ``torch._int_mm`` (cuBLASLt int8 -> int32) plus the same epilogue in
    torch ops, and the float32 ``torch.matmul`` the float32 predictor
    pays for the layer; with the tile and occupancy K5 takes.
    Inputs are cycled so every launch reads its weight from device
    memory rather than L2."""
    out = {}
    for i, (name, (M, K, N, act)) in enumerate(INT8_SHAPES.items()):
        per_set = 4 * M * K + 2 * K * N + 4 * K * N
        n_sets = max(2, min(32, -(-3 * L2_BYTES // per_set)))
        sets = [int8_case(dev, M, K, N, seed=120 + 40 * i + j)
                for j in range(n_sets)]
        w32 = [q.float() * (s / 127.0) for _, q, s, _ in sets]
        pre = [Q._quantize_act(x, 0.0) for x, *_ in sets]

        def kernel(k):
            x, q, s, b = sets[k]
            return Q.int8_fc(x, q, s, 0.0, b, act)

        def plain(st):
            x, q, s, b = st
            return Q.int8_fc_plain(x, q, s, 0.0, b, act)

        def int_mm(k, qw):
            xq, sx = pre[k]
            acc = torch._int_mm(xq, qw).float()
            _, _, s, b = sets[k]
            return Q._epilogue(acc, Q._dequant_scale(sx, s), b, act)

        row = int8_work(M, K, N)
        row["config"] = int8_config(M, N, K, dev)
        idx = list(range(n_sets))
        for k in idx:   # each weight's K-major copy
            kernel(k)
        row["ms"] = device_ms(kernel, idx, iters=20, name="int8_fc_kernel")
        row["wrapper_ms"] = device_ms(kernel, idx, iters=20)
        row["wall_ms"] = time_ms(kernel, idx, iters=20)
        row["plain_ms"] = time_ms(lambda k: plain(sets[k]), idx, iters=3)
        try:
            row["library_ms"] = device_ms(
                lambda k: int_mm(k, sets[k][1]), idx, iters=20)
            row["library"] = "torch._int_mm + epilogue"
        except RuntimeError as e:   # cuBLASLt may want the weight K-major
            cm = [st[1].t().contiguous().t() for st in sets]
            try:
                row["library_ms"] = device_ms(lambda k: int_mm(k, cm[k]),
                                              idx, iters=20)
                row["library"] = "torch._int_mm (K-major weight) + epilogue"
            except RuntimeError as e2:
                row["library_ms"] = None
                row["library"] = f"torch._int_mm refused: {e}; {e2}"[:300]
        row["f32_matmul_ms"] = device_ms(
            lambda k: torch.matmul(sets[k][0], w32[k]), idx, iters=20)
        row.update(M=M, K=K, N=N, act=act, launches_per_dispatch=
                   INT8_DISPATCH_SHAPES[name], input_sets=n_sets)
        out[name] = row
        log(f"  {name} [{M}, {K}] x [{K}, {N}] {act or 'no act'}: kernel "
            f"{row['ms']!r} ms of device time (with the activation "
            f"quantization {row['wrapper_ms']!r} ms; {row['wall_ms']!r} ms "
            f"a call by CUDA events), plain {row['plain_ms']!r} ms, "
            f"{row['library']} {row['library_ms']!r} ms, float32 matmul "
            f"{row['f32_matmul_ms']!r} ms, bound {row['bound_ms']!r} ms "
            f"({row['bound_by']}, {row['ops']} ops, {row['bytes']} bytes); "
            f"occupancy {json.dumps(row['config'])}")
        del sets, w32, pre
        torch.cuda.empty_cache()
    summed = {k: sum(r[k] * r["launches_per_dispatch"] for r in out.values())
              for k in ("ms", "wrapper_ms", "plain_ms", "bound_ms",
                        "f32_matmul_ms")}
    summed["library_ms"] = (None if any(r["library_ms"] is None
                                        for r in out.values()) else
                            sum(r["library_ms"] * r["launches_per_dispatch"]
                                for r in out.values()))
    out["dispatch_sum"] = summed
    log("  summed over one bucket-8 dispatch's "
        f"{sum(INT8_DISPATCH_SHAPES.values())} launches: " + json.dumps(
            {k: v for k, v in summed.items()}))
    if summed["library_ms"] is not None:
        log(f"  a dispatch: K5 {summed['ms']!r} ms against torch._int_mm + "
            f"epilogue {summed['library_ms']!r} ms "
            f"({summed['library_ms'] / summed['ms']:.2f}x); K5 faster at "
            + ", ".join(f"{n} {r['library_ms'] > r['ms']}"
                        for n, r in out.items() if n != "dispatch_sum"))
    return out


def check_and_time_int8_fc(dev) -> dict:
    from paddle_tpu_torch.kernels import quant as Q
    errs = check_int8_fc(Q, dev)
    out = {"max_abs_err": errs, **time_int8_fc(Q, dev)}
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 10: int8 serving of Transformer-base through ModelManager
# ---------------------------------------------------------------------------

def save_serving_model(dirname: str, n_layer: int, T: int, place,
                       seed: int = 5):
    """Build the port's Transformer inference program (the bench's
    serving model: attention_impl "base", dropout 0.1) at full width
    with ``n_layer`` + ``n_layer`` layers and T-token feeds, initialize
    it from ``seed`` on ``place``, and save it with
    ``io.save_inference_model``."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import unique_name
    from paddle_tpu_torch.models.transformer import transformer
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup), unique_name.guard():
        src = L.data("src_ids", [T], dtype="int64")
        tgt = L.data("tgt_ids", [T], dtype="int64")
        sm = L.data("src_mask", [T])
        tm = L.data("tgt_mask", [T])
        logits = transformer(src, tgt, sm, tm, n_layer=n_layer, max_len=T,
                             **SERVE)
    scope, exe = fluid.Scope(), fluid.Executor(place)
    with fluid.scope_guard(scope):
        exe.run(startup)
        fluid.io.save_inference_model(
            dirname, ["src_ids", "tgt_ids", "src_mask", "tgt_mask"],
            [logits], exe, main_program=main)
    del scope, exe


def serving_rows(n: int, T: int, seed: int) -> list:
    """``n`` single-row requests: token ids and ragged masks (a prefix of
    T/2..T live tokens, source and target drawn apart) from ``seed``."""
    rs = np.random.RandomState(seed)
    rows = []
    for _ in range(n):
        ls, lt = rs.randint(T // 2, T + 1, 2)
        pos = np.arange(T)[None, :]
        rows.append({
            "src_ids": rs.randint(0, SERVE["src_vocab"], (1, T)
                                  ).astype("int64"),
            "tgt_ids": rs.randint(0, SERVE["tgt_vocab"], (1, T)
                                  ).astype("int64"),
            "src_mask": (pos < ls).astype("float32"),
            "tgt_mask": (pos < lt).astype("float32")})
    return rows


def int8_predictor(d: str, int8: bool, cpu: bool = False):
    from paddle_tpu_torch.inference import AnalysisConfig, create_predictor
    cfg = AnalysisConfig(d)
    if cpu:
        cfg.disable_gpu()
    if int8:
        cfg.enable_int8()
    return create_predictor(cfg)


def rms_rel(got, want) -> float:
    return float(np.sqrt(np.mean((got - want) ** 2))
                 / np.sqrt(np.mean(want ** 2)))


def stamped_io(pred, feed) -> tuple:
    """The stamped ops of ``pred``'s int8 program, with the input X and
    the output each took in ``pred``'s run on ``feed``, as numpy."""
    ops = [op for op in pred.program().global_block.ops
           if op.attrs.get("quant_int8")]
    names = [op.inputs["X"][0] for op in ops] + \
        [op.outputs["Out"][0] for op in ops]
    vals = pred._exe.run(pred.program(), feed=feed, fetch_list=names,
                         scope=pred._scope, sync=True)
    return ops, vals[:len(ops)], vals[len(ops):]


def replay_stamped_ops(Q, host, ops, xs, outs) -> int:
    """Every stamped op of the card's run, replayed on the CPU: the op's
    plain version (``int8_fc_plain`` with the host predictor's weights)
    on the very input the card gave the op must equal the card's K5
    output bit for bit (the path's acts are "" and relu).  Returns the
    number of ops replayed."""
    for op, x, out in zip(ops, xs, outs):
        xnc = int(op.attrs.get("x_num_col_dims", 1))
        xm = torch.from_numpy(x.reshape(int(np.prod(x.shape[:xnc])), -1))
        wt = {s: host._scope.find_var(op.inputs[s][0])
              for s in ("WInt8", "WScale")}
        bias = (host._scope.find_var(op.inputs["Bias"][0]).reshape(-1)
                if op.type == "fused_fc" else None)
        act = (op.attrs.get("act", "") or "") if op.type == "fused_fc" \
            else ""
        want = Q.int8_fc_plain(xm, wt["WInt8"], wt["WScale"],
                               float(op.attrs.get("in_scale", 0.0)), bias,
                               act).numpy()
        if not np.array_equal(out.reshape(want.shape), want):
            raise AssertionError(
                f"K5 on the card and the plain version on the CPU differ on "
                f"the same input at {op.type} {op.outputs['Out'][0]}: "
                f"max|d| {np.abs(out.reshape(want.shape) - want).max()}")
    return len(ops)


def first_flip(Q, ops, xs_card, xs_host) -> list:
    """Each stamped op's activation quantized as K5's launch quantizes
    it, from the card's run and from the CPU's, in program order: the
    codes must be equal up to the first op where one differs, and there
    at most FLIP_FRAC of them may differ, each by one (a rounding tie
    broken the other way).  Returns the flipped codes per op."""
    flips = []
    for op, a, b in zip(ops, xs_card, xs_host):
        s = float(op.attrs.get("in_scale", 0.0))
        d = (Q._quantize_act(torch.from_numpy(a), s)[0].int()
             - Q._quantize_act(torch.from_numpy(b), s)[0].int())
        n = int((d != 0).sum())
        if n and not any(flips):
            move = int(d.abs().max())
            if move != 1 or n > FLIP_FRAC * d.numel():
                raise AssertionError(
                    f"int8 card vs CPU: the first op whose codes differ, "
                    f"{op.outputs['Out'][0]}, has {n} of {d.numel()} codes "
                    f"apart, by up to {move}: not a rounding tie")
        flips.append(n)
    return flips


def check_int8_against_cpu(Q, dev) -> dict:
    """A 2 + 2-layer Transformer at full width, one saved model loaded
    through create_predictor on the card and on the CPU (the plain
    versions), float32 and int8, same weights; B=2, T=64.

    - the stamped int8 programs are equal;
    - every stamped op, replayed on the CPU on the input the card gave
      it, equals the card's K5 output bit for bit (``replay_stamped_ops``);
    - the float32 logits agree within SERVE_F32_TOL * max|ref|;
    - each stamped op's activation codes are equal on the card and the
      CPU up to the first op where a code differs, and there at most
      FLIP_FRAC of them differ, each by one (``first_flip``): an
      activation one float32 rounding apart (the card's GEMMs and
      softmax sum in other orders) crosses a rounding tie.  A wrong
      int8 wiring moves most codes of the next op;
    - the int8 logits: each flipped code moves the next op's activation
      by up to a code's weight, so later codes flip too (the per-op
      counts are printed), and two int8 runs whose float32 parts round
      apart become two draws of the int8 error around the float32
      answer.  The card's int8 logits are held to the CPU's within
      sqrt(2) times the RMS difference of the CPU's int8 and float32
      logits on the same rows."""
    import tempfile
    T = 64
    with tempfile.TemporaryDirectory() as d:
        save_serving_model(d, 2, T, "cpu")
        preds = {(dv, q8): int8_predictor(d, q8, cpu=dv == "cpu")
                 for dv in ("card", "cpu") for q8 in (False, True)}
    card, host = preds[("card", True)], preds[("cpu", True)]
    if json.dumps(card.program().to_dict()) != \
            json.dumps(host.program().to_dict()):
        raise AssertionError("the card's and the CPU's int8 programs differ")
    stamped = sum(1 for op in card.program().global_block.ops
                  if op.attrs.get("quant_int8"))
    rows = serving_rows(2, T, seed=3)
    feed = {n: np.concatenate([r[n] for r in rows]) for n in card.feed_names}
    n0 = Q.int8_fc.launches
    (got,) = card.run(feed)
    launches = Q.int8_fc.launches - n0
    logits = {k: p.run(feed)[0] for k, p in preds.items()}
    ops, xs, outs = stamped_io(card, feed)
    replayed = replay_stamped_ops(Q, host, ops, xs, outs)
    flips = first_flip(Q, ops, xs, stamped_io(host, feed)[1])
    want, f32_card, f32_cpu = (logits[("cpu", True)], logits[("card", False)],
                               logits[("cpu", False)])
    out = {"stamped_ops": stamped, "launches": launches,
           "ops_replayed_bit_equal": replayed,
           "first_flip_op": next((i for i, n in enumerate(flips) if n), None),
           "codes_flipped_per_op": flips,
           "f32_max_rel_err": float(np.abs(f32_card - f32_cpu).max()
                                    / np.abs(f32_cpu).max()),
           "int8_max_rel_err": float(np.abs(got - want).max()
                                     / np.abs(want).max()),
           "int8_rms_rel_err": rms_rel(got, want),
           "int8_vs_f32_rms_rel_on_cpu": rms_rel(want, f32_cpu),
           "int8_argmax_agreement": float(np.mean(got.argmax(-1)
                                                  == want.argmax(-1)))}
    log(f"  2+2 layers at full width, B=2, T={T}: {stamped} stamped ops "
        f"(equal programs), {launches} K5 launches, {replayed} ops equal to "
        f"their plain versions on the CPU bit for bit; codes flipped card vs "
        f"CPU per op: {flips}; logits card vs CPU: "
        + json.dumps({k: v for k, v in out.items() if "err" in k or "rel" in k
                      or "agree" in k}))
    if launches != stamped or not np.isfinite(got).all():
        raise AssertionError(f"int8 card: {launches} K5 launches for "
                             f"{stamped} stamped ops")
    if not out["f32_max_rel_err"] <= SERVE_F32_TOL:
        raise AssertionError(f"f32 card vs CPU: {out['f32_max_rel_err']}")
    bound = math.sqrt(2.0) * out["int8_vs_f32_rms_rel_on_cpu"]
    if not out["int8_rms_rel_err"] <= bound:
        raise AssertionError(f"int8 card vs CPU RMS {out['int8_rms_rel_err']}"
                             f" exceeds sqrt(2) x the int8 error {bound}")
    return out


def serve_arm(mgr, name: str, rows: list, Q) -> dict:
    """Send ``rows`` from SERVE_CLIENTS threads through ``mgr`` (model
    ``name``), each thread two requests at a time (``submit`` both, then
    wait), so up to 8 are in flight and the top bucket fills;
    per-request latency from its submit, QPS over the whole burst, K5
    launches and the batcher's counters.  K5's count is set to 0 just
    before and read just after."""
    lat, outs, errs = {}, {}, []

    def client(k):
        mine = list(range(k, len(rows), SERVE_CLIENTS))
        for j in range(0, len(mine), 2):
            pair = mine[j:j + 2]
            t = time.perf_counter()
            try:
                futs = [mgr.submit(name, rows[i]) for i in pair]
                for i, f in zip(pair, futs):
                    outs[i] = f.result(timeout=600)[0]
                    lat[i] = (time.perf_counter() - t) * 1e3
            except Exception as e:
                errs.append(f"{pair}: {e!r}")
                return

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(SERVE_CLIENTS)]
    # the host-clock ms of each Predictor.run the batcher makes
    pred = mgr._route(name).predictor
    run, runs_ms = pred.run, []

    def timed_run(feed):
        t = time.perf_counter()
        try:
            return run(feed)
        finally:
            runs_ms.append((time.perf_counter() - t) * 1e3)

    pred.run = timed_run
    Q.int8_fc.launches = 0
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    launches = Q.int8_fc.launches
    del pred.run
    snap = mgr.servingz()["models"][f"{name}@1"]
    lats = sorted(lat.values())
    return {"outs": outs, "errors": errs, "answered": len(outs),
            "run_ms": runs_ms, "run_ms_median": float(np.median(runs_ms)),
            "launches": launches, "batches": snap["batches"],
            "padded_rows": snap["padded_rows"], "wall_s": wall,
            "qps": len(outs) / wall,
            "p50_ms": pctl(lats, 0.50) if lats else None,
            "p99_ms": pctl(lats, 0.99) if lats else None,
            "avg_batch_occupancy": snap["avg_batch_occupancy"]}


def dispatch_ms(pred, rows: list, reps: int = 5) -> float:
    """Median host-clock ms of ``Predictor.run`` on a bucket-8 batch
    (the fetch copies the logits to the host: the synchronise)."""
    feed = {n: np.concatenate([r[n] for r in rows[:8]])
            for n in pred.feed_names}
    pred.run(feed)
    ts = []
    for _ in range(reps):
        t = time.perf_counter()
        pred.run(feed)
        ts.append((time.perf_counter() - t) * 1e3)
    return float(np.median(ts))


def run_int8_serving(dev, card: str) -> dict:
    import tempfile
    from paddle_tpu_torch.kernels import quant as Q
    from paddle_tpu_torch.serving import ModelManager
    out = {"cpu_check": check_int8_against_cpu(Q, dev)}
    T = SERVE_T
    rows = serving_rows(SERVE_REQUESTS, T, seed=17)
    with tempfile.TemporaryDirectory() as d:
        t = time.perf_counter()
        save_serving_model(d, SERVE_LAYERS, T, dev)
        out["save_s"] = time.perf_counter() - t
        mgr = ModelManager()
        try:
            arms = {}
            for name, int8 in (("f32", False), ("int8", True)):
                t = time.perf_counter()
                sm = mgr.load(name, "1", predictor=int8_predictor(d, int8),
                              buckets=SERVE_BUCKETS, activate=True,
                              max_delay_ms=5.0, max_queue_rows=4096)
                load_s = time.perf_counter() - t
                stamped = sum(1 for op in sm.predictor.program()
                              .global_block.ops if op.attrs.get("quant_int8"))
                torch.cuda.reset_peak_memory_stats()
                res = serve_arm(mgr, name, rows, Q)
                res.update(load_s=load_s, stamped_ops=stamped,
                           max_memory_allocated=
                           torch.cuda.max_memory_allocated(),
                           dispatch_ms_bucket8=dispatch_ms(sm.predictor,
                                                           rows))
                arms[name] = res
                log(f"  {name}: {res['answered']}/{len(rows)} answered from "
                    f"{SERVE_CLIENTS} threads in {res['batches']} batches "
                    f"(occupancy {res['avg_batch_occupancy']}), QPS "
                    f"{res['qps']!r}, p50 {res['p50_ms']!r} ms, p99 "
                    f"{res['p99_ms']!r} ms, Predictor.run in the batcher "
                    f"{res['run_ms_median']!r} ms median (all "
                    f"{[round(x, 1) for x in res['run_ms']]}), bucket-8 "
                    f"dispatch alone {res['dispatch_ms_bucket8']!r} ms, K5 "
                    f"launches "
                    f"{res['launches']}, {stamped} stamped ops, peak "
                    f"{res['max_memory_allocated']} bytes, load {load_s:.1f} s")
            f32, q8 = arms["f32"], arms["int8"]
            for name, a in arms.items():
                if a["errors"] or a["answered"] != len(rows):
                    raise AssertionError(f"{name}: {a['answered']} of "
                                         f"{len(rows)} answered: "
                                         f"{a['errors'][:3]}")
            if f32["launches"] != 0:
                raise AssertionError(f"the f32 arm launched K5 "
                                     f"{f32['launches']} times")
            if q8["stamped_ops"] != INT8_LAUNCHES or \
                    q8["launches"] != INT8_LAUNCHES * q8["batches"]:
                raise AssertionError(
                    f"K5 launched {q8['launches']} times in "
                    f"{q8['batches']} int8 dispatches ({q8['stamped_ops']} "
                    f"stamped ops; want {INT8_LAUNCHES} a dispatch)")
            # every f32 reply against Predictor.run of its row alone
            pred = mgr._route("f32").predictor
            worst = 0.0
            for i, r in enumerate(rows):
                (want,) = pred.run(r)
                got = f32["outs"][i]
                ratio = float(np.abs(got - want).max()
                              / np.abs(want).max())
                if not (np.isfinite(got).all() and ratio <= SERVE_F32_TOL):
                    raise AssertionError(f"f32 reply {i} vs its row alone: "
                                         f"max|d|/max|ref| {ratio}")
                worst = max(worst, ratio)
            live = np.concatenate([r["tgt_mask"][0] for r in rows]) > 0
            a32 = np.concatenate([f32["outs"][i][0].argmax(-1)
                                  for i in range(len(rows))])
            a8 = np.concatenate([q8["outs"][i][0].argmax(-1)
                                 for i in range(len(rows))])
            out["quant_accuracy_delta"] = float(np.mean(a32 != a8))
            out["quant_accuracy_delta_live"] = float(
                np.mean(a32[live] != a8[live]))
            out["f32_reply_vs_alone_max_rel"] = worst
            log(f"  f32 replies vs Predictor.run of each row alone: worst "
                f"max|d|/max|ref| {worst!r} (tolerance {SERVE_F32_TOL})")
            log(f"  quant_accuracy_delta (argmax of int8 vs f32 on the same "
                f"rows, printed, not gated; the reference's bar is 0.05): "
                f"{out['quant_accuracy_delta']!r} over all positions, "
                f"{out['quant_accuracy_delta_live']!r} over live target "
                f"positions")
            pred8 = mgr._route("int8").predictor
            feed8 = {n: np.concatenate([r[n] for r in rows[:8]])
                     for n in pred8.feed_names}
            prof = profile_call(lambda: pred8.run(feed8),
                                ("int8_fc_kernel",))
            out["profile_int8_dispatch"] = prof
            log(f"  profiled int8 dispatch at bucket 8 [{card}]: " +
                json.dumps({k: v for k, v in prof.items()
                            if k != "top_kernels"}))
            if "focus_ms" in prof:
                log(f"  K5 {prof['focus_ms']['int8_fc_kernel']!r} ms of the "
                    f"dispatch's {prof['device_busy_ms']!r} ms of device "
                    f"busy time ("
                    f"{prof['focus_share_of_busy']['int8_fc_kernel']:.2%})")
            for k in prof.get("top_kernels", []):
                log(f"    {k['ms']:.3f} ms  x{k['count']}  {k['name']}")
            for a in arms.values():
                del a["outs"]
            out["arms"] = arms
        finally:
            mgr.close()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 11: machine-translation beam inference through While
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def captured_inputs(op_type: str, store: list, grad: bool = False):
    """Copy the inputs of every call of ``op_type``'s rule (its explicit
    grad rule with ``grad``) into ``store`` while the block runs, in
    call order (the rule itself runs unchanged)."""
    from paddle_tpu_torch.core import registry
    opdef = registry.get(op_type)
    attr = "grad" if grad else "lower"
    rule = getattr(opdef, attr)

    def capture(ctx, ins, attrs):
        store.append(({s: [None if v is None else v.detach().clone()
                           for v in vs]
                       for s, vs in ins.items()}, dict(attrs)))
        return rule(ctx, ins, attrs)

    setattr(opdef, attr, capture)
    try:
        yield
    finally:
        setattr(opdef, attr, rule)


def rule_card_vs_cpu(op_type: str, ins: dict, attrs: dict) -> list:
    """``op_type``'s rule on the card's inputs and on CPU copies of them:
    every output must be equal bit for bit.  Returns the output slots."""
    from paddle_tpu_torch.core import registry
    rule = registry.get(op_type).lower
    card = rule(None, ins, attrs)
    host = rule(None, {s: [v.cpu() for v in vs] for s, vs in ins.items()},
                attrs)
    if sorted(card) != sorted(host):
        raise AssertionError(f"{op_type}: output slots {sorted(card)} on "
                             f"the card, {sorted(host)} on the CPU")
    for slot in card:
        a, b = card[slot][0].cpu(), host[slot][0]
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"{op_type} {slot}: the card's rule and "
                                 f"the CPU's differ on the same inputs")
    return sorted(card)


def build_mt_infer(seed: int = 3):
    """The port's machine-translation beam-search program
    (models/machine_translation.py mode="infer" at its defaults): (main,
    startup, the BeamDecodeResult, the fetch names: sentence ids, scores,
    lengths, then the three per-step TensorArrays)."""
    from paddle_tpu_torch.core import unique_name
    from paddle_tpu_torch.core.program import Program, program_guard
    from paddle_tpu_torch.models import machine_translation
    main, startup = Program(), Program()
    main.random_seed = startup.random_seed = seed
    with program_guard(main, startup), unique_name.guard():
        _, decode, _ = machine_translation.build(
            mode="infer", beam_size=MT_BEAM, **MT_TRAIN)
    (bsd,) = [op for op in main.global_block.ops
              if op.type == "beam_search_decode"]
    arrays = [bsd.input(s)[0] for s in ("Ids", "Parents", "Scores")]
    fetch = [decode.ids.name, decode.scores.name,
             decode.cand_len.name] + arrays
    return main, startup, fetch


def mt_infer_feed(seed: int) -> dict:
    """One source sentence with a ragged mask (MT_INFER_LEN of T tokens),
    the [beam, V] candidate iota and the 0/-inf beam seed."""
    rs = np.random.RandomState(seed)
    T, V = MT_TRAIN["max_len"], MT_TRAIN["tgt_vocab"]
    return {"src_ids": rs.randint(3, MT_TRAIN["src_vocab"],
                                  (1, T)).astype("int64"),
            "src_mask": (np.arange(T) < MT_INFER_LEN)[None]
            .astype("float32"),
            "cand_ids": np.tile(np.arange(V, dtype="int64"), (MT_BEAM, 1)),
            "beam_seed": np.array([[0.0]] + [[-np.inf]] * (MT_BEAM - 1),
                                  "float32")}


def check_k8a_at_infer_shape(R, dev) -> float:
    """K8a against its plain version at the MT decode's shape (B=1,
    T=32, H=256), ragged and full, bit-identical on a rerun."""
    worst = 0.0
    for i, lo in enumerate((MT_SHORTEST, None)):
        x = gru_inputs(dev, 1, MT_TRAIN["max_len"], MT_TRAIN["hid"],
                       seed=90 + i, lo=lo)
        hs = R.gru_fused(*x["args"])
        again = R.gru_fused(*x["args"])
        torch.cuda.synchronize()
        if not torch.equal(hs, again):
            raise AssertionError("K8a is not bit-identical on a rerun at "
                                 "B=1")
        e = (hs - R.gru_ref(*x["args"])).abs().max().item()
        if not (math.isfinite(e) and e <= K8A_FWD_ATOL):
            raise AssertionError(f"K8a disagrees with its plain version at "
                                 f"B=1: {e} > {K8A_FWD_ATOL}")
        worst = max(worst, e)
    return worst


def beam_pick_scores(ins: dict, end_id: int, ids, parents):
    """One side's own scores for a selection (``ids``, ``parents``: [BW]
    global lanes) among its ``beam_search`` candidates (``ins``: the
    rule's inputs as numpy): a live lane's candidate (parent, id) scores
    ``Scores[parent, column of id]``, a finished lane offers only end_id
    at its frozen ``PreScores``.  Raises if a pick is no candidate."""
    pre_ids = ins["PreIds"].reshape(-1)
    pre_scores = ins["PreScores"].reshape(-1)
    out = np.empty(len(ids), ins["Scores"].dtype)
    for j, (k, p) in enumerate(zip(ids, parents)):
        if pre_ids[p] == end_id:
            if k != end_id:
                raise AssertionError(f"lane {j}: id {k} from finished "
                                     f"lane {p}")
            out[j] = pre_scores[p]
            continue
        col = np.flatnonzero(ins["Ids"][p] == k)
        if col.size == 0:
            raise AssertionError(f"lane {j}: id {k} is no candidate of "
                                 f"lane {p}")
        out[j] = ins["Scores"][p, col].max()
    return out


def judge_beam_step(ins: dict, beam: int, end_id: int, own, other):
    """One ``beam_search`` step scored on one side: ``own`` is the side's
    own selection on its inputs ``ins`` and ``other`` the other side's
    selection at the same step, each (ids [BW], parents [BW], scores
    [BW]).  Both selections are scored by this side's candidates; per
    source group, the other's sorted scores against the own selected
    ones give the gap, max |d| / |s| (0 where equal, -inf included).
    Returns (this side's scores for the other's picks, the gap, whether
    the selections differ)."""
    ids, parents = np.asarray(other[0]), np.asarray(other[1])
    bw = len(ids)
    group = np.arange(bw) // beam
    if not (parents // beam == group).all():
        raise AssertionError(f"parents {parents} leave their source group")
    picks = set(zip(parents.tolist(), ids.tolist()))
    if len(picks) != bw:
        raise AssertionError(f"a candidate is selected twice: {picks}")
    forced = beam_pick_scores(ins, end_id, ids, parents)
    mine = np.asarray(own[2]).reshape(-1)
    gap = 0.0
    for g in range(bw // beam):
        a = mine[g * beam:(g + 1) * beam]
        b = np.sort(forced[g * beam:(g + 1) * beam])[::-1]
        same = a == b
        if not (same | (np.isfinite(a) & np.isfinite(b))).all():
            return forced, math.inf, True
        d = np.where(same, 0.0, np.abs(a - b) / np.maximum(np.abs(a), 1e-30))
        gap = max(gap, float(d.max()))
    differs = not (np.array_equal(np.asarray(own[0]).reshape(-1), ids)
                   and np.array_equal(np.asarray(own[1]).reshape(-1),
                                      parents))
    return forced, gap, differs


@contextlib.contextmanager
def beam_search_forced(sel_ids, sel_parents, rel: float, log_steps: list):
    """While the block runs, the port's ``beam_search`` rule computes its
    own selection at step t, judges the other side's (``sel_ids[t]``,
    ``sel_parents[t]``) by :func:`judge_beam_step` (the gap must stay
    within ``rel``) and hands on the other side's picks with its own
    scores for them.  Appends (step, differs, gap) to ``log_steps``."""
    from paddle_tpu_torch.core import registry
    opdef = registry.get("beam_search")
    rule = opdef.lower

    def forced(ctx, ins, attrs):
        t = len(log_steps)
        outs = rule(ctx, ins, attrs)
        own = [outs[s][0].reshape(-1).cpu().numpy()
               for s in ("SelectedIds", "ParentIdx", "SelectedScores")]
        np_ins = {s: v[0].cpu().numpy() for s, v in ins.items()}
        ids = np.asarray(sel_ids[t]).reshape(-1).astype(np.int64)
        par = np.asarray(sel_parents[t]).reshape(-1).astype(np.int64)
        scores, gap, differs = judge_beam_step(
            np_ins, int(attrs["beam_size"]), int(attrs["end_id"]), own,
            (ids, par))
        log_steps.append((t, differs, gap))
        if not gap <= rel:
            raise AssertionError(
                f"step {t}: the selections differ and it is no near tie: "
                f"this side scores the other's picks {scores}, its own "
                f"{own[2]} (gap {gap} of |s|, tolerance {rel})")
        like = outs["SelectedScores"][0]
        return {"SelectedIds": [torch.as_tensor(ids).reshape(-1, 1)
                                .to(outs["SelectedIds"][0])],
                "SelectedScores": [torch.as_tensor(scores).reshape(
                    like.shape).to(like)],
                "ParentIdx": [torch.as_tensor(par)
                              .to(outs["ParentIdx"][0])]}

    opdef.lower = forced
    try:
        yield
    finally:
        opdef.lower = rule


def run_mt_beam(dev, card: str) -> dict:
    """Phase 11 (module doc)."""
    import shutil
    import tempfile

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.kernels import rnn as R
    out = {"k8a_max_abs_err_b1": check_k8a_at_infer_shape(R, dev)}
    log(f"  K8a at B=1, T={MT_TRAIN['max_len']}, H={MT_TRAIN['hid']} "
        f"(ragged and full) vs its plain version: max|d| "
        f"{out['k8a_max_abs_err_b1']!r} (tolerance {K8A_FWD_ATOL}), "
        f"bit-identical on a rerun")
    os.makedirs(OUT_DIR, exist_ok=True)
    ckpt = tempfile.mkdtemp(prefix="mt_params_", dir=OUT_DIR)
    try:
        t0 = time.perf_counter()
        train, tstart, _, params = build_mt()
        exe = fluid.Executor(dev)
        scope = fluid.Scope()
        exe.run(tstart, scope=scope)
        with fluid.scope_guard(scope):
            fluid.io.save_params(exe, ckpt, main_program=train)
        del scope
        main, startup, fetch = build_mt_infer()
        runs = {}
        for name, device in (("gpu", dev), ("cpu", "cpu")):
            e = fluid.Executor(device)
            s = fluid.Scope()
            e.run(startup, scope=s)
            with fluid.scope_guard(s):
                fluid.io.load_params(e, ckpt, main_program=main)
            runs[name] = (e, s)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.synchronize()
    n_ops = [len(b.ops) for b in main.blocks]
    log(f"  beam-search program: {n_ops} ops (top-level block, while "
        f"body), {len(params)} parameters saved from the training "
        f"program's startup and loaded on the card and on the CPU in "
        f"{time.perf_counter() - t0:.1f} s")
    feed = mt_infer_feed(seed=17)
    exe, scope = runs["gpu"]
    exe.run(main, feed=feed, fetch_list=fetch, scope=scope)   # warm-up
    # the main path: one decode with the launch counts set to 0
    bs_in, bsd_in = [], []
    R.gru_fused.launches = R.gru_fused_grad.launches = 0
    with captured_inputs("beam_search", bs_in), \
            captured_inputs("beam_search_decode", bsd_in):
        got = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    launches = gru_launches(R)
    log(f"  one decode: K8a/K8b launches {launches} (expected (2, 0))")
    if launches != (2, 0):
        raise AssertionError(f"K8a/K8b launched {launches} times in a "
                             f"decode, expected (2, 0)")
    ids, scores, cand_len = got[:3]
    T = MT_TRAIN["max_len"]
    if ids.shape != (MT_BEAM, T) or scores.shape != (MT_BEAM, T) or \
            not np.isfinite(scores).all() or \
            not ((ids >= 0) & (ids < MT_TRAIN["tgt_vocab"])).all():
        raise AssertionError(f"bad decode: ids {ids.shape}, scores "
                             f"{scores.shape}")
    # the two rules of the loop, card vs CPU on the card's own inputs
    slots = {"beam_search": rule_card_vs_cpu("beam_search", *bs_in[0]),
             "beam_search_decode": rule_card_vs_cpu("beam_search_decode",
                                                    *bsd_in[0])}
    log(f"  beam_search on the step-0 candidates ({MT_BEAM} x "
        f"{MT_TRAIN['tgt_vocab']}) and beam_search_decode on the card's "
        f"arrays: card = CPU bit for bit ({slots})")
    # the whole decode, card vs CPU: the CPU decodes along the card's
    # path, judging each of the card's selections on its own scores
    cexe, cscope = runs["cpu"]
    judged = []
    with beam_search_forced(got[3], got[4], MT_TIE_REL, judged):
        host = cexe.run(main, feed=feed, fetch_list=fetch, scope=cscope)
    if len(judged) != T:
        raise AssertionError(f"{len(judged)} beam_search steps on the CPU, "
                             f"expected {T}")
    if not (np.array_equal(ids, host[0])
            and np.array_equal(cand_len, host[2])):
        raise AssertionError("the CPU's backtrack along the card's "
                             "selections differs from the card's")
    sc_g, sc_c = got[5][:T], host[5][:T]
    same = sc_g == sc_c
    rel = float(np.max(np.where(same, 0.0, np.abs(sc_g - sc_c)
                                / np.abs(sc_c))))
    if not rel <= MT_TIE_REL:
        raise AssertionError(f"selected scores card vs CPU differ by "
                             f"{rel} of |s| (tolerance {MT_TIE_REL})")
    differ = [t for t, d, _ in judged if d]
    gap = max(g for _, _, g in judged)
    steps_equal = differ[0] if differ else T
    log(f"  card vs CPU along the card's path ({T} steps): the CPU's own "
        f"selection equals the card's for the first {steps_equal} steps, "
        f"differs at steps {differ}; worst gap between the CPU's scores "
        f"of the two selections {gap!r} of |s|; selected scores within "
        f"{rel!r} of |s| (tolerance {MT_TIE_REL} for both); ids and "
        f"lengths equal")
    # timed decodes (host clock to a synchronised end)
    ms = []
    R.gru_fused.launches = R.gru_fused_grad.launches = 0
    for _ in range(MT_DECODES):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        exe.run(main, feed=feed, fetch_list=fetch[:3], scope=scope,
                sync=True)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t1) * 1e3)
    if gru_launches(R) != (2 * MT_DECODES, 0):
        raise AssertionError(f"K8a/K8b launches {gru_launches(R)} over "
                             f"{MT_DECODES} decodes")
    med = float(np.median(ms))
    out.update({"launches": launches, "rule_slots": slots,
                "steps_equal": steps_equal, "steps_differing": differ,
                "tie_gap": gap, "score_rel_diff": rel, "decode_ms": ms,
                "decode_ms_median": med,
                "loop_condition_reads": T,
                "ids": ids.tolist(), "cand_len": cand_len.tolist()})
    log(f"  decode [{card}]: wall ms median {med!r} over {MT_DECODES} "
        f"(all {[round(x, 2) for x in ms]}), {T} iterations, one host "
        f"read of the loop condition each")
    prof = profile_call(
        lambda: exe.run(main, feed=feed, fetch_list=fetch[:3], scope=scope,
                        sync=True),
        ("gru_fwd_recurrence",))
    out["profile"] = prof
    log(f"  profiled decode [{card}]: " + json.dumps(
        {k: v for k, v in prof.items() if k != "top_kernels"}))
    if "focus_ms" in prof:
        log(f"  K8a {prof['focus_ms']['gru_fwd_recurrence']!r} ms of the "
            f"decode's {prof['device_busy_ms']!r} ms of device busy time "
            f"({prof['focus_share_of_busy']['gru_fwd_recurrence']:.2%})")
    for k in prof.get("top_kernels", []):
        log(f"    {k['ms']:.3f} ms  x{k['count']}  {k['name']}")
    del runs, exe, scope, cexe, cscope
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 11b: PagedBeamDecoder over the paged KV cache
# ---------------------------------------------------------------------------

def check_beam_against_reforward(lm, prompt, res) -> float:
    """Each final hypothesis's per-token accumulated scores against the
    cumulative log-softmax of one causal re-forward of prompt +
    hypothesis on the card: |d| at token t within BEAM_TOKEN_TOL * (t+1).
    Returns the worst |d| / (t+1)."""
    P, worst = len(prompt), 0.0
    for j in range(res.ids.shape[0]):
        n = int(res.cand_len[j])
        hyp = res.ids[j, :n]
        seq = torch.tensor([list(prompt) + list(hyp[:-1])], device=lm.device)
        with torch.inference_mode():
            logits = lm.full_logits(seq)[0, P - 1:].double()
        logp = torch.log_softmax(logits, dim=-1).cpu().numpy()
        want = np.cumsum(logp[np.arange(n), hyp])
        d = np.abs(res.scores[j, :n] - want) / np.arange(1, n + 1)
        if not (np.isfinite(res.scores[j, :n]).all()
                and d.max() <= BEAM_TOKEN_TOL):
            raise AssertionError(
                f"beam lane {j}: accumulated scores differ from the "
                f"re-forward's cumulative log-softmax by {d.max()} a token "
                f"(tolerance {BEAM_TOKEN_TOL})")
        worst = max(worst, float(d.max()))
    return worst


@contextlib.contextmanager
def k4_beam_calls(store: list, keep: int):
    """While the block runs, copy the inputs and output of the decode
    model's K4 calls into ``store``, keeping the last ``keep`` (the call
    itself runs unchanged)."""
    from paddle_tpu_torch.decode import model as M
    fn = M.decode_attention

    def spy(*a, **k):
        out = fn(*a, **k)
        store.append(([x.clone() for x in a], out.clone()))
        del store[:-keep]
        return out

    M.decode_attention = spy
    try:
        yield
    finally:
        M.decode_attention = fn


def check_k4_on_beam_step(A, calls) -> dict:
    """K4 against its plain version on one beam step's own inputs (one
    call a layer): within KERNEL_TOL, and its output in the decode
    bit-identical to a rerun.  The lanes' block tables must share
    blocks within their contexts."""
    worst, shared = 0.0, 0
    for (q, kc, vc, bt, cl), out in calls:
        bs = kc.shape[1]
        n = ((cl.long() + bs - 1) // bs).tolist()
        seen = {}
        for lane, m in enumerate(n):
            for b in bt[lane, :m].tolist():
                seen[b] = seen.get(b, 0) + 1
        shared = max(shared, sum(c > 1 for c in seen.values()))
        got = A.decode_attention(q, kc, vc, bt, cl)
        torch.cuda.synchronize()
        if not (torch.equal(got, out) and torch.equal(
                got, A.decode_attention(q, kc, vc, bt, cl))):
            raise AssertionError("K4 is not bit-identical on a rerun of a "
                                 "beam step")
        e = (got - A.paged_attention_ref(q, kc, vc, bt, cl)).abs().max()
        e = e.item()
        if not (math.isfinite(e) and e <= KERNEL_TOL["float32"]):
            raise AssertionError(f"K4 disagrees with its plain version on "
                                 f"a beam step: {e} > "
                                 f"{KERNEL_TOL['float32']}")
        worst = max(worst, e)
    if not shared:
        raise AssertionError("no block is shared between the beam step's "
                             "lanes")
    return {"max_abs_err": worst, "layers": len(calls),
            "shared_blocks": shared, "slots": int(calls[0][0][0].shape[0]),
            "context": int(calls[0][0][4].max())}


def run_paged_beam(dev, card: str) -> dict:
    """Phase 11b (module doc)."""
    from paddle_tpu_torch.decode import (LMConfig, PagedBeamDecoder,
                                         TransformerLM)
    from paddle_tpu_torch.kernels import attention as A
    lm = TransformerLM(LMConfig(**FULL), device=dev)
    lm.init_params(seed=7)
    prompt = np.random.RandomState(19).randint(
        0, FULL["vocab"], BEAM_PROMPT).astype(np.int32)
    want = FULL["n_layer"] * (BEAM_STEPS - 1)
    out, results = {}, {}
    for mode, share in (("cow", True), ("eager", False)):
        dec = PagedBeamDecoder(lm, beam_size=BEAM_WIDTH,
                               end_id=FULL["vocab"] - 1, name=f"smoke_{mode}",
                               block_tokens=BLOCK_TOKENS, share_prefix=share)
        try:
            dec.decode(prompt, max_steps=4)               # warm-up
            forks0, copies0 = dec.cow_forks, dec.block_copies
            torch.cuda.synchronize()
            A.decode_attention.launches = 0
            t0 = time.perf_counter()
            res = dec.decode(prompt, max_steps=BEAM_STEPS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = A.decode_attention.launches
            leaked = dec.leaked()
            if launches != want or leaked != 0:
                raise AssertionError(
                    f"{mode}: K4 launched {launches} times (expected "
                    f"n_layer x (steps - 1) = {want}), {leaked} blocks "
                    f"leaked")
            out[mode] = {"wall_ms": wall * 1e3,
                         "step_ms": wall * 1e3 / BEAM_STEPS,
                         "beam_tokens_per_s": BEAM_WIDTH * BEAM_STEPS / wall,
                         "cow_forks": dec.cow_forks - forks0,
                         "block_copies": dec.block_copies - copies0,
                         "k4_launches": launches, "leaked": leaked}
            if share:
                out["profile"] = profile_call(
                    lambda: dec.decode(prompt, max_steps=BEAM_STEPS),
                    (K4_KERNELS,))
                calls = []
                with k4_beam_calls(calls, FULL["n_layer"]):
                    dec.decode(prompt, max_steps=BEAM_STEPS)
                out["k4_beam_step"] = check_k4_on_beam_step(A, calls)
                del calls
                log(f"  K4 on the last beam step's own inputs (S="
                    f"{out['k4_beam_step']['slots']} lanes, context "
                    f"{out['k4_beam_step']['context']}, "
                    f"{out['k4_beam_step']['shared_blocks']} blocks shared "
                    f"between lanes, {FULL['n_layer']} layers) vs its plain "
                    f"version: max|d| {out['k4_beam_step']['max_abs_err']!r} "
                    f"(tolerance {KERNEL_TOL['float32']}), bit-identical on "
                    f"a rerun")
            results[mode] = res
        finally:
            dec.close()
        if dec.leaked() != 0:
            raise AssertionError(f"{mode}: blocks leaked after close()")
        log(f"  {mode} [{card}]: " + json.dumps(out[mode]))
    cow, eager = results["cow"], results["eager"]
    if not (np.array_equal(cow.ids, eager.ids)
            and np.array_equal(cow.scores, eager.scores)
            and np.array_equal(cow.cand_len, eager.cand_len)):
        raise AssertionError("COW forking and eager copies disagree")
    if not (out["cow"]["cow_forks"] >= 1 and out["cow"]["block_copies"]
            < out["eager"]["block_copies"]):
        raise AssertionError(f"COW: {out['cow']['cow_forks']} forks, "
                             f"{out['cow']['block_copies']} block copies "
                             f"against eager's "
                             f"{out['eager']['block_copies']}")
    out["reforward_worst_per_token"] = check_beam_against_reforward(
        lm, prompt, cow)
    out["ids"] = cow.ids.tolist()
    log(f"  COW = eager bit for bit (ids, scores, lengths) over "
        f"{BEAM_STEPS} steps, beam {BEAM_WIDTH}; K4 {want} launches a "
        f"decode each; re-forward: accumulated scores within "
        f"{out['reforward_worst_per_token']!r} a token (tolerance "
        f"{BEAM_TOKEN_TOL})")
    prof = out["profile"]
    log(f"  profiled COW decode [{card}]: " + json.dumps(
        {k: v for k, v in prof.items() if k != "top_kernels"}))
    if "focus_ms" in prof:
        log(f"  K4 {prof['focus_ms'][K4_KERNELS]!r} ms of the decode's "
            f"{prof['device_busy_ms']!r} ms of device busy time "
            f"({prof['focus_share_of_busy'][K4_KERNELS]:.2%})")
    for k in prof.get("top_kernels", []):
        log(f"    {k['ms']:.3f} ms  x{k['count']}  {k['name']}")
    del lm
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 12: the convolutional models through Executor.run and the predictor
# ---------------------------------------------------------------------------

def kernel_launches() -> dict:
    """Every hand-written kernel's launch counter (K1-K10)."""
    from paddle_tpu_torch.kernels import attention as A
    from paddle_tpu_torch.kernels import quant as Q
    from paddle_tpu_torch.kernels import rnn as R
    from paddle_tpu_torch.kernels import sparse as S
    return {"K1": A.flash_attention_fwd.launches,
            "K2": A.flash_attention_bwd_dq.launches,
            "K3": A.flash_attention_bwd_dkv.launches,
            "K4": A.decode_attention.launches, "K5": Q.int8_fc.launches,
            "K6": R.lstm_fused.launches, "K7": R.lstm_fused_grad.launches,
            "K8a": R.gru_fused.launches, "K8b": R.gru_fused_grad.launches,
            "K9": S.fused_gather.launches, "K10": S.rowwise_update.launches}


def build_conv(module, seed=1, **kw):
    """A model's training program (``module.build(**kw)``), fresh names,
    random weights from the startup's seed."""
    from paddle_tpu_torch.core import unique_name
    from paddle_tpu_torch.core.program import Program, program_guard
    main, startup = Program(), Program()
    main.random_seed = startup.random_seed = seed
    with program_guard(main, startup), unique_name.guard():
        feeds, loss, _ = module.build(**kw)
    return main, startup, loss, feeds


def conv_batch(feeds, B, image, classes, seed) -> dict:
    """One seeded synthetic batch, as bench.py makes it."""
    rs = np.random.RandomState(seed)
    return {feeds[0]: rs.randn(B, *image).astype(np.float32),
            feeds[1]: rs.randint(0, classes, (B, 1)).astype(np.int64)}


def conv_forward_flop(main) -> int:
    """The forward's convolution and fc FLOP an image (2 x MACs), from
    the program's shapes: a conv output element takes C_in/groups x kh x
    kw MACs, an fc output element its K."""
    blk = main.global_block
    total = 0
    for op in blk.ops:
        if op.type == "conv2d":
            w = blk.var(op.input("Filter")[0]).shape
            out = blk.var(op.output("Output")[0]).shape
            total += 2 * int(np.prod(out[1:])) * w[1] * w[2] * w[3]
        elif op.type == "mul":
            w = blk.var(op.input("Y")[0]).shape
            total += 2 * w[0] * w[1]
    return total


def train_conv(dev, card: str, name: str, build, image, classes, B, steps,
               dtype="float32", count=()) -> dict:
    """``steps`` steps of a training program on one seeded batch on the
    card (the batch put on the card once, in the program's dtype, as
    bench.py's device_put): losses finite, step ms (median of steps 3 on,
    host clock, the loss fetch the synchronise), images/s, peak memory,
    one profiled step."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops._util import torch_dtype
    main, startup, loss, feeds = build()
    exe, scope = fluid.Executor(dev), fluid.Scope()
    exe.run(startup, scope=scope)
    batch = conv_batch(feeds, B, image, classes, seed=3)
    feed = {feeds[0]: torch.from_numpy(batch[feeds[0]]).to(dev).to(
                torch_dtype(dtype)),
            feeds[1]: torch.from_numpy(batch[feeds[1]]).to(dev)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    with fluid.scope_guard(scope):
        for _ in range(steps):
            t = time.perf_counter()
            (l,) = exe.run(main, feed=feed, fetch_list=[loss], sync=True)
            step_ms.append((time.perf_counter() - t) * 1e3)
            losses.append(float(np.asarray(l, np.float32)))
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{name}: training loss not finite: {losses}")
    med = float(np.median(step_ms[2:]))
    flop = 3 * conv_forward_flop(main) * B
    out = {"B": B, "ops": len(main.global_block.ops), "steps": steps,
           "losses": losses, "step_ms": step_ms, "step_ms_median": med,
           "images_per_s": B / (med / 1e3),
           "train_flop_per_step": flop,
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    with fluid.scope_guard(scope):
        out["profile"] = profile_step(exe, main, feed, loss, (), count)
    prof = out["profile"]
    log(f"  {name} B={B} [{card}]: step ms median {med!r} (steps 3..{steps}"
        f", all {[round(x, 2) for x in step_ms]}), images/s "
        f"{out['images_per_s']!r}, loss {losses[0]!r} -> {losses[-1]!r}, "
        f"max memory allocated {out['max_memory_allocated']} bytes; "
        f"{flop / 1e12:.3f} TFLOP a step (3 x the forward's convs and fc)")
    log(f"  {name} profiled step [{card}]: " + json.dumps(
        {k: v for k, v in prof.items() if k != "top_kernels"}))
    for k in prof.get("top_kernels", []):
        log(f"    {k['ms']:.3f} ms  x{k['count']}  {k['name']}")
    del scope, exe, feed
    torch.cuda.empty_cache()
    return out


def conv_step(main, loss, values, feed, names, device, dtype) -> tuple:
    """One training step from ``values`` on ``device`` in ``dtype`` (the
    float32 values and image feed cast; a float64 feed goes in as a
    tensor, which the executor takes as it is): the loss and ``names``'
    values after the step, float64 on the host."""
    import paddle_tpu_torch as fluid
    scope = fluid.Scope()
    scope.load_numpy({n: v.astype(dtype) if v.dtype == np.float32 else v
                      for n, v in values.items()}, device=device)
    if dtype == np.float64:
        feed = {n: torch.from_numpy(v.astype(dtype) if v.dtype == np.float32
                                    else v) for n, v in feed.items()}
    (l,) = fluid.Executor(device).run(main, feed=feed, fetch_list=[loss],
                                      scope=scope)
    after = scope.to_numpy(names)
    return float(l), {n: np.asarray(v, np.float64) for n, v in after.items()}


def check_conv_step_against_cpu(dev, card: str, layout) -> dict:
    """One ResNet-50 step at CONV_PARITY on the card and on the CPU from
    the same copied start, in float64 and in float32.  float64: the loss
    and every parameter and batch-norm running stat after the step
    within CONV_F64_TOL (relative; per tensor, of max|ref|).  float32:
    the loss within CONV_LOSS_TOL relative, and the step's update of all
    of them as one vector within twice the CPU's own float32 error
    (relative L2 against its float64 step) plus CONV_UPDATE_FLOOR; the
    worst tensor is recorded."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import resnet
    P = CONV_PARITY
    main, startup, loss, feeds = build_conv(
        resnet, class_dim=P["classes"], image_shape=P["image"], depth=50,
        lr=0.1, layout=layout)
    init = fluid.Scope()
    fluid.Executor("cpu").run(startup, scope=init)
    values = init.to_numpy()
    names = sorted(p.name for p in main.all_parameters()) + sorted(
        n for n in values if n.endswith((".mean", ".variance")))
    feed = conv_batch(feeds, P["B"], P["image"], P["classes"], seed=5)
    runs = {side: conv_step(main, loss, values, feed, names, device, dt)
            for side, device, dt in (("cpu", "cpu", np.float32),
                                     ("cpu64", "cpu", np.float64),
                                     ("gpu", dev, np.float32),
                                     ("gpu64", dev, np.float64))}

    def update(side):
        return np.concatenate([(runs[side][1][n] - values[n]).ravel()
                               for n in names])

    def worst(a, b):
        r = {n: float(np.abs(runs[a][1][n] - runs[b][1][n]).max())
             / max(float(np.abs(runs[b][1][n]).max()), 1e-300)
             for n in names}
        n = max(r, key=r.get)
        return r[n], n

    out = {"loss_rel_diff_f64": abs(runs["gpu64"][0] - runs["cpu64"][0])
           / abs(runs["cpu64"][0]),
           "loss_rel_diff": abs(runs["gpu"][0] - runs["cpu"][0])
           / abs(runs["cpu"][0]),
           "loss_gpu": runs["gpu"][0], "loss_cpu": runs["cpu"][0]}
    out["worst_f64"], out["worst_f64_name"] = worst("gpu64", "cpu64")
    out["worst_f32"], out["worst_f32_name"] = worst("gpu", "cpu")
    u64 = update("cpu64")
    rel = {key: float(np.linalg.norm(update(side) - base)
                      / np.linalg.norm(base))
           for key, side, base in (("gpu", "gpu", update("cpu")),
                                   ("cpu", "cpu", u64),
                                   ("gpu_vs_f64", "gpu", u64))}
    out.update(update_rel_diff=rel["gpu"], cpu_f32_update_err=rel["cpu"],
               gpu_f32_update_err=rel["gpu_vs_f64"])
    bound = 2 * rel["cpu"] + CONV_UPDATE_FLOOR
    if not (out["loss_rel_diff_f64"] <= CONV_F64_TOL
            and out["worst_f64"] <= CONV_F64_TOL
            and math.isfinite(out["loss_gpu"])
            and out["loss_rel_diff"] <= CONV_LOSS_TOL
            and rel["gpu"] <= bound
            and not torch.backends.cudnn.allow_tf32):
        raise AssertionError(f"ResNet-50 {layout}, card vs CPU: {out} "
                             f"(float64 tolerance {CONV_F64_TOL}, loss "
                             f"{CONV_LOSS_TOL}, update {bound})")
    log(f"  ResNet-50 {layout} B={P['B']} {P['image']}, card vs CPU, one "
        f"step [{card}] (TF32 off): float64 loss rel "
        f"{out['loss_rel_diff_f64']!r}, {len(names)} parameters and "
        f"running stats worst max|d|/max|ref| {out['worst_f64']!r} "
        f"({out['worst_f64_name']}; tolerance {CONV_F64_TOL})")
    log(f"  float32 loss {runs['gpu'][0]!r} vs {runs['cpu'][0]!r} (rel "
        f"{out['loss_rel_diff']!r}, tolerance {CONV_LOSS_TOL}), update "
        f"rel L2 {rel['gpu']!r} (bound {bound!r}: the CPU's float32 "
        f"update is {rel['cpu']!r} from its float64 one, the card's "
        f"{rel['gpu_vs_f64']!r}), worst tensor max|d|/max|ref| "
        f"{out['worst_f32']!r} ({out['worst_f32_name']})")
    return out


def build_resnet_infer(seed=1):
    """ResNet-50 float32 NCHW's inference program (data -> softmax), the
    training program's parameter names."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import unique_name
    from paddle_tpu_torch.core.program import Program, program_guard
    from paddle_tpu_torch.models import resnet
    main, startup = Program(), Program()
    main.random_seed = startup.random_seed = seed
    with program_guard(main, startup), unique_name.guard():
        data = fluid.layers.data("data", list(CONV_IMAGE))
        predict = resnet.resnet(data, CONV_CLASSES, 50, "NCHW")
    return main, startup, predict


def run_conv_inference(dev, card: str, d: str) -> dict:
    """The float32 NCHW ResNet-50 through save_inference_model ->
    create_predictor: ir_optim on (fuse_conv_bn a default pass) plus
    add_pass("convert_to_nhwc") against ir_optim off, on one batch of
    CONV_INFER_B."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.inference import AnalysisConfig, create_predictor
    main, startup, predict = build_resnet_infer()
    exe, scope = fluid.Executor(dev), fluid.Scope()
    exe.run(startup, scope=scope)
    x = np.random.RandomState(29).randn(CONV_INFER_B, *CONV_IMAGE).astype(
        np.float32)
    # running stats: one training-mode forward with momentum 0 takes the
    # batch's own (with the startup's 0 and 1, the activations of a random
    # 53-layer net grow layer by layer and the softmax saturates)
    bns = [op for op in main.global_block.ops if op.type == "batch_norm"]
    for op in bns:
        op.set_attr("momentum", 0.0)
    exe.run(main, feed={"data": x}, fetch_list=[predict], scope=scope)
    for op in bns:
        op.set_attr("momentum", 0.9)
    with fluid.scope_guard(scope):
        fluid.io.save_inference_model(d, ["data"], [predict], exe,
                                      main_program=main)
    plain_cfg = AnalysisConfig(d)
    plain_cfg.switch_ir_optim(False)
    cfg = AnalysisConfig(d)
    cfg.add_pass("convert_to_nhwc")
    plain_cfg.place = cfg.place = dev
    plain, opt = create_predictor(plain_cfg), create_predictor(cfg)
    ops_before = [op.type for op in plain.program().global_block.ops]
    ops_after = opt.program().global_block.ops
    folds = (ops_before.count("batch_norm")
             - [op.type for op in ops_after].count("batch_norm"))
    converted = sum(1 for op in ops_after
                    if op.type in ("conv2d", "pool2d", "batch_norm")
                    and op.attr("data_layout") == "NHWC")
    out = {"folds": folds, "converted": converted,
           "conv_bn_pairs": ops_before.count("batch_norm")}
    res = {}
    for name, pred in (("plain", plain), ("optimized", opt)):
        (res[name],) = pred.run({"data": x})
        times = []
        for _ in range(5):
            t = time.perf_counter()
            pred.run({"data": x})
            times.append((time.perf_counter() - t) * 1e3)
        out[f"{name}_dispatch_ms"] = float(np.median(times))
    ref = res["plain"]
    err = float(np.abs(res["optimized"] - ref).max()) / float(
        np.abs(ref).max())
    out["max_rel_err"] = err
    out["softmax_max"] = float(ref.max())
    if not (np.isfinite(res["optimized"]).all() and err <= CONV_INFER_TOL
            and folds == CONV_FOLDS):
        raise AssertionError(f"ResNet-50 predictor: softmax max|d|/max|ref| "
                             f"{err} (tolerance {CONV_INFER_TOL}), {folds} "
                             f"folds (expected {CONV_FOLDS})")
    log(f"  ResNet-50 predictor B={CONV_INFER_B} [{card}]: fuse_conv_bn "
        f"folded {folds} conv+BN pairs, convert_to_nhwc converted "
        f"{converted} ops; softmax (largest {out['softmax_max']!r}) vs "
        f"ir_optim off max|d|/max|ref| {err!r} (tolerance "
        f"{CONV_INFER_TOL}); dispatch ms "
        f"{out['optimized_dispatch_ms']!r} (passes) vs "
        f"{out['plain_dispatch_ms']!r} (ir_optim off)")
    del plain, opt, scope, exe
    torch.cuda.empty_cache()
    return out


def run_conv(dev, card: str) -> dict:
    """Phase 12 (module doc)."""
    from paddle_tpu_torch.models import mnist, resnet
    before = kernel_launches()
    out = {"parity": {layout: check_conv_step_against_cpu(dev, card, layout)
                      for layout in ("NHWC", "NCHW")}}
    for name, dtype, layout in CONV_CONFIGS:
        out[name] = train_conv(
            dev, card, f"ResNet-50 {dtype} {layout}",
            lambda: build_conv(resnet, class_dim=CONV_CLASSES,
                               image_shape=CONV_IMAGE, depth=50, lr=0.1,
                               dtype=dtype, layout=layout),
            CONV_IMAGE, CONV_CLASSES, CONV_B, CONV_STEPS, dtype,
            count=LAYOUT_KERNELS)
        # the bench's configuration keeps NHWC from the entry's transpose
        # on; in float32 cuDNN picks some NCHW FMA kernels for NHWC
        # tensors and converts around them: reported, not gated
        counted = out[name]["profile"].get("counted", {})
        if name == CONV_CONFIGS[0][0] and any(v["launches"]
                                              for v in counted.values()):
            raise AssertionError(f"{name}: cuDNN layout conversions in the "
                                 f"profiled step: {counted}")
    mn = train_conv(dev, card, "MNIST", lambda: build_conv(mnist),
                    MNIST_IMAGE, 10, MNIST_B, CONV_STEPS)
    if not mn["losses"][-1] < mn["losses"][0]:
        raise AssertionError(f"MNIST loss not falling: {mn['losses']}")
    out["mnist"] = mn
    with tempfile.TemporaryDirectory() as d:   # ~100 MB of weights
        out["inference"] = run_conv_inference(dev, card, d)
    after = kernel_launches()
    out["kernel_launches"] = {k: after[k] - before[k] for k in after}
    if any(out["kernel_launches"].values()):
        raise AssertionError(f"a hand-written kernel launched on the "
                             f"convolutional path: {out['kernel_launches']}")
    log(f"  no hand-written kernel launched in phase 12 (K1-K10 counters "
        f"{out['kernel_launches']})")
    return out



# ---------------------------------------------------------------------------
# phase 13: ring attention (K11) and Transformer-base on a mesh's sp axis
# ---------------------------------------------------------------------------

def ring_launches(A, devices, causal: bool) -> int:
    """K1 launches of one ring forward (and K2's, K3's of its backward):
    one a hop on each device holding a pair of the hop (``ring_hops``):
    sp on one card, causal or not; 16, or 10 causal, on four cards."""
    return sum(len(h) for h in A.ring_hops(devices, causal))


def ring_inputs(dev, seed) -> dict:
    """q, k, v, dO at RING_SHAPE, a ragged [B, T] key mask and an int32
    seed, from a seeded generator on the card."""
    B, H, T, D = RING_SHAPE
    g = torch.Generator(device=dev).manual_seed(seed)
    x = {n: torch.randn(B, H, T, D, generator=g, device=dev)
         for n in ("q", "k", "v", "do")}
    lens = torch.randint(3 * T // 4, T + 1, (B,), generator=g, device=dev)
    x["mask"] = (torch.arange(T, device=dev)[None] < lens[:, None]).float()
    x["seed"] = torch.tensor([seed * 7919 + 1], dtype=torch.int32,
                             device=dev)
    return x


def ring_work(x, causal) -> dict:
    """The ring's least work: the sum of ``flash_work``'s bounds over the
    (q-shard, kv-shard) pairs it launches, the diagonal causal under
    ``causal``: {"fwd": K1's, "bwd": K2's + K3's}."""
    B, H, T, D = x["q"].shape
    S = T // RING_SP
    out = {"fwd": {"bound_ms": 0.0, "ops": 0, "bytes": 0},
           "bwd": {"bound_ms": 0.0, "ops": 0, "bytes": 0}}
    by = {}
    for i in range(RING_SP):
        for j in range(RING_SP):
            if causal and j > i:
                continue
            pair = {"q": x["q"][:, :, i * S:(i + 1) * S],
                    "k": x["k"][:, :, j * S:(j + 1) * S],
                    "mask": x["mask"][:, j * S:(j + 1) * S]}
            w = flash_work(pair, causal and i == j)
            for key, parts in (("fwd", ("fwd",)),
                               ("bwd", ("bwd_dq", "bwd_dkv"))):
                for part in parts:
                    for f in ("bound_ms", "ops", "bytes"):
                        out[key][f] += w[part][f]
                    by[w[part]["bound_by"]] = by.get(
                        w[part]["bound_by"], 0) + w[part]["bound_ms"]
    for key in out:
        out[key]["bound_by"] = max(by, key=by.get)
    return out


def ring_run(A, devices, x, causal, rate, plain=False, sm_scale=None):
    """The ring over ``devices``' shards, its forward, then its autograd
    backward on ``x["do"]`` (``ring_attention``, or ``ring_attention_ref``
    with ``plain``): out, dq, dk, dv."""
    fn = A.ring_attention_ref if plain else A.ring_attention
    leaves = [x[n].clone().requires_grad_(True) for n in ("q", "k", "v")]
    out = fn(*leaves, x["mask"], devices, causal, sm_scale, rate, x["seed"])
    dq, dk, dv = torch.autograd.grad(out, leaves, x["do"])
    return dict(out=out.detach(), dq=dq, dk=dk, dv=dv)


def ring_errors(got, ref, label, bf16_rel=FLASH_BF16_REL) -> dict:
    """max|got - ref| of each output within phase 3b's tolerances (for
    bfloat16 outputs max|d| <= ``bf16_rel`` * max|ref|)."""
    names = ("out", "dq", "dk", "dv")
    if got["out"].dtype == torch.bfloat16:
        for n in names:
            rel_err(got[n], ref[n], bf16_rel, f"{label} {n}")
        e = {n: (got[n].float() - ref[n].float()).abs().max().item()
             for n in names}
        tol = f"{bf16_rel} of max|ref|"
    else:
        e = {"out": worst(got["out"], ref["out"], FLASH_FWD_TOL)}
        for n in ("dq", "dk", "dv"):
            e[n] = worst(got[n], ref[n], FLASH_GRAD_TOL)
        tol = f"{FLASH_FWD_TOL} / {FLASH_GRAD_TOL} as atol, rtol"
    mag = {n: ref[n].float().abs().max().item() for n in e}
    log(f"  {label}: max|d| out {e['out']!r}, dq {e['dq']!r}, dk "
        f"{e['dk']!r}, dv {e['dv']!r} (tolerance {tol}; max|ref| {mag})")
    return e


def check_ring_case(A, devices, x, causal, rate, time_plain,
                    timed=True) -> dict:
    """One 13a case: the ring over K1-K3 against the plain ring on the
    card and, at rate 0, against single launches of K1, K2 and K3 over
    the whole sequence (with dropout the ring keys each pair's bits on
    its pair seed and a single launch keys them on the one seed: other
    bits, not comparable); the launch counts; then, if ``timed``, device
    times."""
    import torch.nn.functional as F
    T = RING_SHAPE[2]
    S = T // RING_SP
    n0 = flash_launches(A)
    got = ring_run(A, devices, x, causal, rate)
    torch.cuda.synchronize()
    launches = tuple(b - a for a, b in zip(n0, flash_launches(A)))
    want = ring_launches(A, devices, causal)
    if launches != (want,) * 3:
        raise AssertionError(f"ring launches K1/K2/K3 {launches}, expected "
                             f"{want} each (sp = {RING_SP}, causal "
                             f"{causal}: one a hop)")
    res = {"launches": launches}
    ref = ring_run(A, devices, x, causal, rate, plain=True)
    torch.cuda.synchronize()
    res["max_abs_err"] = ring_errors(got, ref, "ring vs plain ring")
    del ref
    if rate == 0.0:
        w_out, w_lse = A.flash_attention_fwd(x["q"], x["k"], x["v"],
                                             x["mask"], causal)
        delta = A.flash_attention_delta(w_out, x["do"])
        bargs = (x["q"], x["k"], x["v"], x["mask"], w_lse, delta, x["do"],
                 causal)
        whole = {"out": w_out, "dq": A.flash_attention_bwd_dq(*bargs)}
        whole["dk"], whole["dv"] = A.flash_attention_bwd_dkv(*bargs)
        torch.cuda.synchronize()
        res["max_abs_err_vs_whole"] = ring_errors(
            got, whole, f"ring vs single K1/K2/K3 launches over T={T}",
            RING_BF16_WHOLE_REL)
        del whole, w_out, w_lse, delta
    del got
    if not timed:
        torch.cuda.empty_cache()
        return res
    # RingAttentionFn's forward and backward bodies (the hop route),
    # called on this thread (the autograd engine would run the backward
    # on its own)
    devices = tuple(devices)
    sm = float(1.0 / math.sqrt(RING_SHAPE[3]))
    args = (x["mask"], x["seed"], devices, causal, sm, rate)
    saved = A._ring_hop_forward(x["q"], x["k"], x["v"], *args)

    def fwd(_):
        return A._ring_hop_forward(x["q"], x["k"], x["v"], *args)

    def bwd(_):
        return A._ring_hop_backward(x["q"], x["k"], x["v"], x["mask"],
                                    x["seed"], *saved, x["do"], devices,
                                    causal, sm, rate)
    kn = flash_kernel_names(x["q"].dtype)
    kf = device_ms_by_name(fwd, [None], 3, [None, kn["fwd"]],
                           {kn["fwd"]: want})
    kb = device_ms_by_name(bwd, [None], 3, [None, kn["bwd_dq"],
                                            kn["bwd_dkv"]],
                           {kn["bwd_dq"]: want, kn["bwd_dkv"]: want})
    res["fwd"] = {"ms": kf[None], "kernel_ms": kf[kn["fwd"]],
                  "event_ms": time_ms(fwd, [None], iters=3)}
    res["bwd"] = {"ms": kb[None],
                  "kernel_ms": kb[kn["bwd_dq"]] + kb[kn["bwd_dkv"]],
                  "event_ms": time_ms(bwd, [None], iters=3)}
    for n in ("fwd", "bwd"):
        # the walk's rest (the pair seeds, the float32 delta, buffers):
        # the ring's device time beside its kernels'
        res[n]["overhead_ms"] = res[n]["ms"] - res[n]["kernel_ms"]
    work = ring_work(x, causal)
    for n in ("fwd", "bwd"):
        res[n].update(work[n])
    del saved
    # the two hop kinds bench_ring_shard reports: a diagonal pair (causal
    # under causal) and an off-diagonal full pair, forward and K2 + K3
    hops = {}
    for kind, c in (("diagonal", causal), ("offdiag", False)):
        # q shard 1 against its own K/V shard, or against shard 0
        sl = slice(0, S) if kind == "offdiag" else slice(S, 2 * S)
        px = {"q": x["q"][:, :, S:2 * S].contiguous(),
              "k": x["k"][:, :, sl].contiguous(),
              "v": x["v"][:, :, sl].contiguous(),
              "mask": x["mask"][:, sl].contiguous(),
              "do": x["do"][:, :, S:2 * S].contiguous(), "seed": x["seed"]}
        o, lse = A.flash_attention_fwd(px["q"], px["k"], px["v"],
                                       px["mask"], c, None, rate, px["seed"])
        pw = flash_work(px, c)
        # CUDA events: a launch of ~1 ms beside ~20 us of host work
        hops[kind] = {
            "causal": c,
            "fwd_ms": time_ms(lambda _: A.flash_attention_fwd(
                px["q"], px["k"], px["v"], px["mask"], c, None, rate,
                px["seed"]), [None], iters=5),
            "bwd_ms": time_ms(lambda _: flash_bwd(A, px, lse, o, c, rate),
                              [None], iters=5),
            "fwd_bound_ms": pw["fwd"]["bound_ms"],
            "bwd_bound_ms": pw["bwd_dq"]["bound_ms"]
            + pw["bwd_dkv"]["bound_ms"]}
    res["hops"] = hops
    # library yardstick (the port never calls it): SDPA over the whole
    # sequence, forward and its autograd backward, same mask and rate
    bias = x["mask"][:, None, None, :] > 0
    if causal:
        bias = bias & torch.ones(T, T, dtype=torch.bool, device=bias.device
                                 ).tril()
    leaves = [x[n].clone().requires_grad_(True) for n in ("q", "k", "v")]
    sdpa = F.scaled_dot_product_attention(*leaves, attn_mask=bias,
                                          dropout_p=rate)
    res["library_fwd_ms"] = time_ms(
        lambda _: F.scaled_dot_product_attention(
            x["q"], x["k"], x["v"], attn_mask=bias, dropout_p=rate),
        [None], iters=3)
    res["library_bwd_ms"] = time_ms(
        lambda _: torch.autograd.grad(sdpa, leaves, x["do"],
                                      retain_graph=True), [None], iters=3)
    res["library_ms"] = res["library_fwd_ms"] + res["library_bwd_ms"]
    del sdpa, leaves, bias
    if time_plain:
        # seconds a call: one warm-up, one timed call
        res["plain_ms"] = time_ms(
            lambda _: ring_run(A, devices, x, causal, rate, plain=True),
            [None], iters=1, warmup=1)
    torch.cuda.empty_cache()
    return res


def check_and_time_ring(dev, dtype=torch.float32) -> dict:
    """Phase 13a (module doc): four mesh positions on the one card, q,
    k, v, dO in ``dtype``.  In bfloat16 (RING_BF16_CASES) the launch
    counts are set to 0 just before the dropout case, the bfloat16
    kernels' main-path run, and read after it (``main_path_launches``)."""
    from paddle_tpu_torch.kernels import attention as A
    devices = [dev] * RING_SP
    bf16 = dtype == torch.bfloat16
    out = {}
    cases = RING_BF16_CASES if bf16 else RING_CASES
    for i, (name, (causal, rate)) in enumerate(cases.items()):
        x = flash_as(ring_inputs(dev, seed=(70 if bf16 else 60) + i), dtype)
        if bf16 and rate > 0:
            reset_flash_launches(A)
        # the plain ring (seconds a call) is timed in the dropout cases,
        # the path's rate; in bfloat16 only that case is timed at all
        r = out[name] = check_ring_case(A, devices, x, causal, rate,
                                        time_plain=rate > 0,
                                        timed=not bf16 or rate > 0)
        if bf16 and rate > 0:
            out["main_path_launches"] = r["launches"]
        if "fwd" not in r:
            log(f"  {name} {dtype} B,H,T,D={list(RING_SHAPE)} sp={RING_SP} "
                f"causal={causal} dropout={rate}: launches {r['launches']} "
                f"(checked, not timed)")
            continue
        f, b = r["fwd"], r["bwd"]
        log(f"  {name} {dtype} B,H,T,D={list(RING_SHAPE)} sp={RING_SP} "
            f"causal={causal} dropout={rate}: launches {r['launches']}; "
            f"forward {f['ms']!r} ms device ({f['event_ms']!r} by events), K1 "
            f"{f['kernel_ms']!r}, the walk's rest {f['overhead_ms']!r}, bound "
            f"{f['bound_ms']!r} ({f['bound_by']}); backward {b['ms']!r} ms "
            f"({b['event_ms']!r}), K2+K3 {b['kernel_ms']!r}, the walk's rest "
            f"{b['overhead_ms']!r}, bound {b['bound_ms']!r}; "
            f"SDPA over T={RING_SHAPE[2]} fwd {r['library_fwd_ms']!r} + bwd "
            f"{r['library_bwd_ms']!r} ms; plain ring "
            f"{r.get('plain_ms', 'not timed')!r} ms")
        for kind, h in r["hops"].items():
            log(f"    {kind} pair (causal={h['causal']}): K1 "
                f"{h['fwd_ms']!r} ms (bound {h['fwd_bound_ms']!r}), delta "
                f"+ K2 + K3 {h['bwd_ms']!r} ms (bound of K2 + K3 "
                f"{h['bwd_bound_ms']!r})")
        del x
    return out


def check_ring_on_distinct_cards(dev) -> dict:
    """Phase 13c: the 13a checks with the four shards on distinct cards
    (cycling over those present), float32 with dropout and causal, and
    bfloat16 with dropout, each result bit-identical to the one-card
    ring's on the same inputs, and the wall ms of a forward +
    backward."""
    n = torch.cuda.device_count()
    if n < 2:
        log(f"  phase 13c not run: {n} CUDA device here (the shards on "
            f"distinct cards need two or more)")
        return {"run": False, "device_count": n}
    from paddle_tpu_torch.kernels import attention as A
    devices = [torch.device("cuda", i % n) for i in range(RING_SP)]
    one, many = [dev] * RING_SP, devices
    out = {"run": True, "devices": [str(d) for d in devices]}
    for i, name in enumerate(("full_dropout", "causal", "bf16_full_dropout")):
        causal, rate = RING_CASES[name.replace("bf16_", "")]
        x = ring_inputs(dev, seed=80 + i)
        if name.startswith("bf16"):
            x = flash_as(x, torch.bfloat16)
        n0 = flash_launches(A)
        got = ring_run(A, many, x, causal, rate)
        for d in set(devices):
            torch.cuda.synchronize(d)
        launches = tuple(b - a for a, b in zip(n0, flash_launches(A)))
        if launches != (ring_launches(A, many, causal),) * 3:
            raise AssertionError(f"13c {name}: launches {launches}")
        base = ring_run(A, one, x, causal, rate)
        same = {k: bool(torch.equal(got[k], base[k])) for k in got}
        if not all(same.values()):
            raise AssertionError(f"13c {name}: distinct cards differ from "
                                 f"one card: {same}")
        ref = ring_run(A, many, x, causal, rate, plain=True)
        err = ring_errors(got, ref, f"13c {name} on {out['devices']} vs "
                                    f"plain")
        del ref, base

        def step():
            ring_run(A, many, x, causal, rate)
            for d in set(devices):
                torch.cuda.synchronize(d)
        step()
        t0 = time.perf_counter()
        for _ in range(3):
            step()
        wall = (time.perf_counter() - t0) / 3 * 1e3
        t0 = time.perf_counter()
        for _ in range(3):
            ring_run(A, one, x, causal, rate)
            torch.cuda.synchronize()
        wall_one = (time.perf_counter() - t0) / 3 * 1e3
        out[name] = {"launches": launches, "bit_identical_to_one_card": same,
                     "max_abs_err": err, "wall_ms": wall,
                     "one_card_wall_ms": wall_one}
        log(f"  13c {name}: bit-identical to one card, forward + backward "
            f"{wall!r} ms wall on {len(set(devices))} cards, {wall_one!r} ms "
            f"on one")
        del x, got
        torch.cuda.empty_cache()
    return out


def ring_executor(main, places, scope, loss):
    import paddle_tpu_torch as fluid
    return fluid.ParallelExecutor(
        loss_name=loss.name, main_program=main, scope=scope, places=places,
        build_strategy=fluid.BuildStrategy(mesh_shape={"sp": RING_SP}))


def step_diff(got, ref, params, n_attn, label, gate=True) -> dict:
    """Card vs CPU (or two impls) for one step's fetches: [loss] +
    gradients + the attention ops' outputs.  Gated (``gate``): the loss
    within TRAIN_LOSS_TOL relative, each attention output within
    RING_ATTN_TOL * max|ref|, each gradient within RING_GRAD_L2 in
    relative L2 norm; the max|d| / max|ref| of each gradient is printed,
    not gated (module constants say why)."""
    l_got, l_ref = float(got[0]), float(ref[0])
    loss_rel = abs(l_got - l_ref) / abs(l_ref)
    grads = list(zip(params, got[1:len(params) + 1],
                     ref[1:len(params) + 1]))
    attn = list(zip(got[len(params) + 1:], ref[len(params) + 1:]))
    if len(attn) != n_attn:
        raise AssertionError(f"{label}: {len(attn)} attention outputs")
    l2 = {n: float(np.linalg.norm(g - r)) / max(float(np.linalg.norm(r)),
                                                1e-30)
          for n, g, r in grads}
    mx = {n: float(np.abs(g - r).max()) / max(float(np.abs(r).max()), 1e-30)
          for n, g, r in grads}
    at = max(float(np.abs(g - r).max()) / float(np.abs(r).max())
             for g, r in attn)
    w2, wm = max(l2, key=l2.get), max(mx, key=mx.get)
    log(f"  {label}: loss {l_got!r} vs {l_ref!r} (rel {loss_rel!r}); "
        f"{n_attn} attention outputs, worst max|d|/max|ref| {at!r}; "
        f"{len(params)} gradients, worst relative L2 {l2[w2]!r} ({w2}), "
        f"worst max|d|/max|ref| {mx[wm]!r} ({wm})")
    bad = [n for n, g, _ in grads if not np.isfinite(g).all()
           or l2[n] > RING_GRAD_L2]
    if gate and (not math.isfinite(l_got) or loss_rel > TRAIN_LOSS_TOL
                 or at > RING_ATTN_TOL or bad):
        raise AssertionError(
            f"{label}: loss rel {loss_rel} (tolerance {TRAIN_LOSS_TOL}), "
            f"attention outputs {at} ({RING_ATTN_TOL}), gradients beyond "
            f"relative L2 {RING_GRAD_L2}: {[(n, l2[n]) for n in bad][:6]}")
    return {"loss": l_got, "loss_ref": l_ref, "loss_rel_diff": loss_rel,
            "attention_max_rel": at, "worst_grad_l2": l2[w2],
            "worst_grad_l2_param": w2, "worst_grad_max_ratio": mx[wm],
            "worst_grad_max_param": wm}


def check_ring_step_against_cpu(dev) -> dict:
    """One step of a 2-layer full-width ring program (B=2, T=512,
    dropout 0) through ParallelExecutor on {"sp": 4} over the card and
    over the CPU, from the same copied start: the loss, the attention
    outputs and every gradient agree (``step_diff``); the same step with
    impl="pallas" (Executor, the card) agrees too, since the ring
    composes the same attention.  The CPU's own float32 spread, its ring
    against the plain softmax chain (impl="xla"), is printed beside."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.kernels import attention as A
    cfg = RING_PARITY
    feed = train_feed(RING_PARITY_B, cfg["max_len"], cfg["tgt_vocab"],
                      seed=5)
    out, got, values = {}, {}, None
    for name, impl, places in (("cpu", "ring", ["cpu"] * RING_SP),
                               ("gpu", "ring", [dev] * RING_SP),
                               ("pallas", "pallas", [dev]),
                               ("cpu_xla", "xla", ["cpu"])):
        main, startup, loss, params = build_transformer(
            dict(cfg, attention_impl=impl))
        if values is None:
            init = fluid.Scope()
            fluid.Executor("cpu").run(startup, scope=init)
            values, names = init.to_numpy(), params
        if params != names:
            raise AssertionError(f"the {impl} program's parameters differ")
        attn = [op.output("Out")[0] for op in main.global_block.ops
                if op.type == "fused_attention"]
        fetch = [loss.name] + [p + "@GRAD" for p in params] + attn
        scope = fluid.Scope()
        scope.load_numpy(values, device=places[0])
        n0 = flash_launches(A)
        if impl == "ring":
            got[name] = ring_executor(main, places, scope, loss).run(
                fetch_list=fetch, feed=feed)
        else:
            got[name] = fluid.Executor(places[0]).run(
                main, feed=feed, fetch_list=fetch, scope=scope)
        out[name + "_launches"] = tuple(
            b - a for a, b in zip(n0, flash_launches(A)))
    want = (cfg["n_layer"] * 3 * ring_launches(A, [dev] * RING_SP, False)
            if torch.device(dev).type == "cuda" else 0)
    if out["gpu_launches"] != (want,) * 3 or \
            out["cpu_launches"] != (0, 0, 0):
        raise AssertionError(f"ring launches card {out['gpu_launches']}, "
                             f"CPU {out['cpu_launches']}; expected {want} "
                             f"each on the card and none on the CPU")
    n_attn = 3 * cfg["n_layer"]
    out["cpu_own_spread"] = step_diff(
        got["cpu"], got["cpu_xla"], names, n_attn,
        "the CPU's own spread, ring vs the plain chain (impl=xla)",
        gate=False)
    out["card_vs_cpu"] = step_diff(got["gpu"], got["cpu"], names, n_attn,
                                   "2-layer ring step, card vs CPU")
    out["ring_vs_pallas"] = step_diff(got["gpu"], got["pallas"], names,
                                      n_attn, "2-layer step on the card, "
                                      "ring vs pallas")
    return out


@contextlib.contextmanager
def ring_op_calls(store: dict, at: dict):
    """While the block runs, copy the inputs and output of the ring ops'
    calls of ``ring_attention`` at the positions ``at`` (name -> index of
    the call within the block) into ``store``; every call runs unchanged.
    Yields a one-element list holding the number of calls so far."""
    import inspect
    from paddle_tpu_torch.kernels import attention as A
    fn = A.ring_attention
    sig = inspect.signature(fn)
    names = {i: name for name, i in at.items()}
    n = [0]

    def spy(*a, **kw):
        out = fn(*a, **kw)
        if n[0] in names:
            b = sig.bind(*a, **kw)
            b.apply_defaults()
            c = dict(b.arguments)
            store[names[n[0]]] = {
                "q": c["q"].detach().clone(), "k": c["k"].detach().clone(),
                "v": c["v"].detach().clone(), "mask": c["kv_mask"].clone(),
                "seed": c["dropout_seed"].clone(),
                "devices": list(c["devices"]), "causal": c["causal"],
                "sm_scale": c["sm_scale"], "rate": c["dropout_rate"],
                "out": out.detach().clone()}
        n[0] += 1
        return out

    A.ring_attention = spy
    try:
        yield n
    finally:
        A.ring_attention = fn


def ring_dropout_grid(A, seed, B, H, Tq, Tk, sp, causal, rate, dtype,
                      device):
    """The ring's dropout multipliers over the whole [B, H, Tq, Tk]: pair
    (i, j)'s block keyed on its pair seed, as the kernels' tile hash;
    pairs the ring leaves out (above the diagonal under causal) stay 0."""
    Sq, Sk = Tq // sp, Tk // sp
    out = torch.zeros(B, H, Tq, Tk, dtype=dtype, device=device)
    for i in range(sp):
        for j in range(sp):
            if causal and j > i:
                continue
            s = A._pair_seed(seed, i, j).reshape(1)
            out[:, :, i * Sq:(i + 1) * Sq, j * Sk:(j + 1) * Sk] = \
                A.tile_dropout_ref(s, B, H, Sq, Sk, rate, device)[..., :Sk]
    return out


def attention_whole(q, k, v, mask, drop, causal, sm_scale):
    """softmax(q k^T * sm_scale, masks) * drop @ v in q's dtype: the
    ring's function as one softmax over every key, without its pairs
    (every row needs a valid key)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * sm_scale
    s = s.masked_fill(~(mask[:, None, None, :] > 0), -math.inf)
    if causal:
        Tq, Tk = s.shape[-2:]
        tri = torch.ones(Tq, Tk, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~tri, -math.inf)
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1) * drop, v)


def ring_float64(A, c, x) -> dict:
    """The ring op ``c``'s function on ``x`` in float64, forward and
    autograd backward (``attention_whole`` with the ring's dropout bits):
    out, dq, dk, dv."""
    B, H, Tq, _ = x["q"].shape
    drop = ring_dropout_grid(A, x["seed"], B, H, Tq, x["k"].shape[2],
                             len(c["devices"]), c["causal"], c["rate"],
                             torch.float64, x["q"].device)
    leaves = [x[n].double().requires_grad_(True) for n in ("q", "k", "v")]
    out = attention_whole(*leaves, x["mask"].double(), drop, c["causal"],
                          c["sm_scale"])
    g = torch.autograd.grad(out, leaves, x["do"].double())
    return dict(out=out.detach(), dq=g[0], dk=g[1], dv=g[2])


def check_ring_on_path(A, calls) -> dict:
    """K11 on the path's own inputs, copied from one T=4096 ring step
    (``ring_op_calls``): an encoder self-attention, a causal decoder
    self-attention and a cross-attention (1,024 x 1,024-token pairs at
    D=64, the model's padding masks, the step's seed and rate).  The
    ring over K1-K3 against the plain ring, forward and autograd
    backward, within FLASH_FWD_TOL / FLASH_GRAD_TOL; its forward must be
    bit-identical to the step's own output.  The cotangent is a seeded
    unit normal: the step's own is of the loss's 1 / (B * T) scale, next
    to which FLASH_GRAD_TOL's absolute part would check nothing."""
    out = {}
    for name, c in calls.items():
        if c["causal"] != (name == "decoder_self"):
            raise AssertionError(f"ring call {name}: causal {c['causal']}")
        g = torch.Generator(device=c["q"].device).manual_seed(97)
        x = {n: c[n] for n in ("q", "k", "v", "mask", "seed")}
        x["do"] = torch.randn(c["out"].shape, generator=g,
                              device=c["q"].device)
        got = ring_run(A, c["devices"], x, c["causal"], c["rate"],
                       sm_scale=c["sm_scale"])
        torch.cuda.synchronize()
        if not torch.equal(got["out"], c["out"]):
            raise AssertionError(
                f"ring call {name}: a rerun on the step's inputs differs "
                f"from the step's output by "
                f"{(got['out'] - c['out']).abs().max().item()}")
        ref = ring_run(A, c["devices"], x, c["causal"], c["rate"],
                       plain=True, sm_scale=c["sm_scale"])
        torch.cuda.synchronize()
        B, H, T, D = c["q"].shape
        err = ring_errors(
            got, ref, f"{name} (B,H,T,D {[B, H, T, D]}, sp "
                      f"{len(c['devices'])}, causal {c['causal']}, "
                      f"dropout {c['rate']}) vs plain ring")
        # both against the same function in float64: how much of their
        # difference is each one's own float32 error
        r64 = ring_float64(A, c, x)
        e64 = {who: {n: ((r[n].double() - r64[n]).abs().max()
                         / r64[n].abs().max()).item() for n in r64}
               for who, r in (("ring", got), ("plain_ring", ref))}
        log(f"    vs float64, max|d| / max|ref64|: ring {e64['ring']}, "
            f"plain ring {e64['plain_ring']}")
        out[name] = {"max_abs_err": err, "shape": [B, H, T, D],
                     "causal": c["causal"], "rate": c["rate"],
                     "masked_key_share": float(1 - c["mask"].mean()),
                     "vs_float64": e64}
        del got, ref, x, r64
    return out


def train_arm(dev, card, impl) -> dict:
    """Transformer-base at RING_TRAIN's T=4096 with ``impl``: "ring"
    through ParallelExecutor on {"sp": 4} over the card (K1-K3 counted
    from 0 just before the steps), "pallas" through Executor."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import lowering
    from paddle_tpu_torch.kernels import attention as A
    cfg = dict(RING_TRAIN, attention_impl=impl)
    main, startup, loss, params = build_transformer(cfg)
    scope = fluid.Scope()
    fluid.Executor(dev).run(startup, scope=scope)
    if impl == "ring":
        exe = ring_executor(main, [dev] * RING_SP, scope, loss)
        run = lambda: exe.run(fetch_list=[loss], feed=feed,  # noqa: E731
                              sync=True)
    else:
        exe = fluid.Executor(dev)
        run = lambda: exe.run(main, feed=feed, fetch_list=[loss],  # noqa
                              scope=scope, sync=True)
    feed = train_feed(RING_TRAIN_B, cfg["max_len"], cfg["tgt_vocab"],
                      seed=11)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lowering.grad_recomputes = 0
    reset_flash_launches(A)
    losses, step_ms = [], []
    for _ in range(RING_TRAIN_STEPS):
        t = time.perf_counter()
        (l,) = run()
        step_ms.append((time.perf_counter() - t) * 1e3)
        losses.append(float(l))
    launches = flash_launches(A)
    recomputes = lowering.grad_recomputes
    n = cfg["n_layer"]
    per_step = (n * (2 * ring_launches(A, [dev] * RING_SP, False)
                     + ring_launches(A, [dev] * RING_SP, True))
                if impl == "ring" else 3 * n)
    want = per_step * RING_TRAIN_STEPS
    log(f"  {impl}: {RING_TRAIN_STEPS} steps, launches K1/K2/K3 {launches} "
        f"(expected {want} each, {per_step} a step), grad recomputes "
        f"{recomputes}")
    if launches != (want,) * 3 or recomputes != 0:
        raise AssertionError(f"{impl}: flash launches {launches} (want {want}"
                             f" each), grad recomputes {recomputes} (want 0)")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{impl}: non-finite training loss: {losses}")
    med = float(np.median(step_ms[2:]))
    res = {"steps": RING_TRAIN_STEPS, "losses": losses, "step_ms": step_ms,
           "step_ms_median": med,
           "tokens_per_s": RING_TRAIN_B * cfg["max_len"] / (med / 1e3),
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "launches": launches, "launches_per_step": per_step,
           "grad_recomputes": recomputes}
    log(f"  {impl} [{card}]: step ms median {med!r} (steps 3..."
        f"{RING_TRAIN_STEPS}, all {[round(v, 2) for v in step_ms]}), "
        f"tokens/s {res['tokens_per_s']!r}, loss {losses[0]!r} -> "
        f"{losses[-1]!r}, max memory allocated "
        f"{res['max_memory_allocated']} bytes")
    prof = profile_call(run, ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                              "flash_bwd_dkv_kernel"))
    res["profile"] = prof
    log(f"  profiled {impl} step [{card}]: " + json.dumps(
        {k: v for k, v in prof.items() if k != "top_kernels"}))
    for k in prof.get("top_kernels", []):
        log(f"    {k['ms']:.3f} ms  x{k['count']}  {k['name']}")
    if impl == "ring":
        # one more step, its ring ops' inputs copied: the first layer's
        # three kinds (the encoder's layers run first, then the decoder's,
        # each a causal self-attention and a cross-attention)
        calls = {}
        at = {"encoder_self": 0, "decoder_self": n, "cross": n + 1}
        with ring_op_calls(calls, at) as count:
            run()
        if count[0] != 3 * n or set(calls) != set(at):
            raise AssertionError(f"ring step: {count[0]} ring op calls "
                                 f"(expected {3 * n}), copied "
                                 f"{sorted(calls)}")
        res["path_check"] = check_ring_on_path(A, calls)
        del calls
    del scope, exe, run
    torch.cuda.empty_cache()
    return res


def run_ring(dev, card: str) -> dict:
    """Phase 13 (module doc): 13a, 13b, 13c."""
    log("  13a: the ring over K1-K3 at bench_ring_shard's shapes")
    out = {"kernel": check_and_time_ring(dev)}
    log("  13b: Transformer-base through ParallelExecutor, mesh {'sp': 4}")
    out["parity"] = check_ring_step_against_cpu(dev)
    out["ring"] = train_arm(dev, card, "ring")
    out["pallas"] = train_arm(dev, card, "pallas")
    log(f"  ring vs pallas at T={RING_TRAIN['max_len']}: step ms "
        f"{out['ring']['step_ms_median']!r} vs "
        f"{out['pallas']['step_ms_median']!r}")
    log("  13c: the shards on distinct cards")
    out["distinct_cards"] = check_ring_on_distinct_cards(dev)
    return out


# ---------------------------------------------------------------------------
# phase 14: run_steps and deferred fetches at Transformer-base width
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def counting_syncs():
    """Count the synchronizing CUDA calls made inside (torch's sync debug
    mode, "warn"): yields a dict whose ``n`` and ``where`` (the Python
    lines that made them) are filled when the block ends."""
    box = {"n": 0, "where": {}}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield box
        finally:
            torch.cuda.set_sync_debug_mode(0)
    for w in caught:
        if "synchroniz" in str(w.message):
            box["n"] += 1
            at = f"{os.path.relpath(w.filename, HERE)}:{w.lineno}"
            box["where"][at] = box["where"].get(at, 0) + 1


def copy_scope(src, dev):
    """A scope holding device copies of ``src``'s tensors and a
    generator in ``src``'s generator's state: one copied start."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core.executor import RNG_STATE_VAR
    dst = fluid.Scope()
    for n, v in src.vars.items():
        if isinstance(v, torch.Tensor):
            dst.set_var(n, v.clone())
    g = src.find_var(RNG_STATE_VAR)
    if isinstance(g, torch.Generator):
        h = torch.Generator(device=dev)
        h.set_state(g.get_state())
        dst.set_var(RNG_STATE_VAR, h)
    return dst


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def scopes_differ(a, b) -> list:
    """The names whose tensors (or generator states) are not bit for bit
    equal in scopes ``a`` and ``b``."""
    from paddle_tpu_torch.core.executor import RNG_STATE_VAR
    out = [n for n in sorted(set(a.vars) | set(b.vars))
           if n != RNG_STATE_VAR and not (
               isinstance(a.vars.get(n), torch.Tensor)
               and isinstance(b.vars.get(n), torch.Tensor)
               and a.vars[n].dtype == b.vars[n].dtype
               and a.vars[n].shape == b.vars[n].shape
               and torch.equal(bits(a.vars[n]), bits(b.vars[n])))]
    ga, gb = a.find_var(RNG_STATE_VAR), b.find_var(RNG_STATE_VAR)
    if (ga is None) != (gb is None) or (
            ga is not None and not torch.equal(ga.get_state(),
                                               gb.get_state())):
        out.append(RNG_STATE_VAR)
    return out


def run_steps_phase(dev, card: str) -> dict:
    """Phase 14 (module doc): 24 steps three ways from one copied start,
    bit for bit; K1-K3 launches, deferred reads and syncs counted."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import lowering
    from paddle_tpu_torch.core.executor import LazyFetch
    from paddle_tpu_torch.kernels import attention as A
    main, startup, loss, _ = build_transformer(TRAIN)
    exe = fluid.Executor(dev)
    start = fluid.Scope()
    exe.run(startup, scope=start)
    T, V = TRAIN["max_len"], TRAIN["tgt_vocab"]
    feeds = [train_feed(TRAIN_B, T, V, seed=1000 + i) for i in range(STEPS_K)]
    stacked = {k: np.stack([f[k] for f in feeds]) for k in feeds[0]}
    # one step on a throwaway copy first: the plan, the executor's
    # constants and the libraries' first calls are no arm's cost
    exe.run(main, feed=feeds[0], fetch_list=[loss],
            scope=copy_scope(start, dev), sync=True)
    lowering.grad_recomputes = 0
    out, scopes, losses = {"K": STEPS_K}, {}, {}

    def arm(name, body):
        scope = scopes[name] = copy_scope(start, dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # the earlier arms' scopes stay for the comparison: the peak is
        # also given above what is allocated when the arm starts
        held = torch.cuda.memory_allocated()
        n0 = flash_launches(A)
        t0 = time.perf_counter()
        with counting_syncs() as syncs:
            losses[name] = body(scope)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = tuple(b - a for a, b in zip(n0, flash_launches(A)))
        peak = torch.cuda.max_memory_allocated()
        out[name] = {"wall_ms_per_step": wall * 1e3 / STEPS_K,
                     "launches": launches,
                     "syncs": syncs["n"],
                     "syncs_per_step": syncs["n"] / STEPS_K,
                     "sync_sites": syncs["where"],
                     "max_memory_allocated": peak,
                     "peak_above_start": peak - held}
        log(f"  ({name}) [{card}]: {out[name]['wall_ms_per_step']!r} ms a "
            f"step (host clock, {STEPS_K} steps), K1/K2/K3 launches "
            f"{launches}, {syncs['n']} synchronizing calls "
            f"({out[name]['syncs_per_step']!r} a step) at {syncs['where']}, "
            f"max memory allocated {peak} ({peak - held} above the "
            f"{held} held at the arm's start)")

    def synced(scope):
        return [exe.run(main, feed=f, fetch_list=[loss], scope=scope,
                        sync=True)[0] for f in feeds]

    deferred = {}

    def lazy(scope):
        got = [exe.run(main, feed=f, fetch_list=[loss], scope=scope)[0]
               for f in feeds]
        deferred["all_pending"] = all(isinstance(g, LazyFetch) and g.pending
                                      for g in got)
        b0, s0 = LazyFetch.batches, LazyFetch.syncs
        float(got[0])                   # the first read
        deferred["batches"] = LazyFetch.batches - b0
        deferred["syncs"] = LazyFetch.syncs - s0
        deferred["read_by_first"] = sum(not g.pending for g in got)
        return [np.asarray(g) for g in got]

    def scanned(scope):
        (stack,) = exe.run_steps(main, feed=stacked, fetch_list=[loss],
                                 scope=scope)
        return list(stack)

    arm("a_run_sync", synced)
    arm("b_run_deferred", lazy)
    arm("c_run_steps", scanned)
    recomputes = lowering.grad_recomputes
    out["deferred"] = deferred
    out["losses"] = [float(x) for x in losses["a_run_sync"]]
    log(f"  (b) deferred: all {STEPS_K} pending before the first read "
        f"{deferred['all_pending']}; the first read materialized "
        f"{deferred['read_by_first']} in {deferred['batches']} batch with "
        f"{deferred['syncs']} synchronisation")
    want = (3 * TRAIN["n_layer"] * STEPS_K
            if torch.device(dev).type == "cuda" else 0)
    if out["c_run_steps"]["launches"] != (want,) * 3 or recomputes != 0:
        raise AssertionError(
            f"run_steps: K1/K2/K3 launches {out['c_run_steps']['launches']} "
            f"(want {want} each), grad recomputes {recomputes} (want 0)")
    if not (deferred["all_pending"] and deferred["batches"] == 1
            and deferred["syncs"] == (torch.device(dev).type == "cuda")
            and deferred["read_by_first"] == STEPS_K):
        raise AssertionError(f"deferred fetches: {deferred}")
    ref = np.asarray(losses["a_run_sync"], np.float32)
    for name in ("b_run_deferred", "c_run_steps"):
        got = np.asarray(losses[name], np.float32).reshape(ref.shape)
        if not np.array_equal(got.view(np.uint32), ref.view(np.uint32)):
            raise AssertionError(f"{name}: losses differ from (a): "
                                 f"{got.tolist()} vs {ref.tolist()}")
        bad = scopes_differ(scopes["a_run_sync"], scopes[name])
        if bad:
            raise AssertionError(f"{name}: state after step {STEPS_K} "
                                 f"differs from (a) in {bad[:8]} "
                                 f"({len(bad)} names)")
    if not all(math.isfinite(x) for x in out["losses"]):
        raise AssertionError(f"non-finite losses {out['losses']}")
    n_state = sum(isinstance(v, torch.Tensor)
                  for v in scopes["a_run_sync"].vars.values())
    out["state_tensors_equal"] = n_state
    log(f"  {STEPS_K} losses and {n_state} state tensors and the generator "
        f"bit for bit equal across (a), (b), (c); losses "
        f"{out['losses'][0]!r} .. {out['losses'][-1]!r}; grad recomputes "
        f"{recomputes}")
    scope = scopes["c_run_steps"]
    part = {k: v[:STEPS_PROFILE_K] for k, v in stacked.items()}
    prof = profile_call(lambda: exe.run_steps(main, feed=part,
                                              fetch_list=[loss],
                                              scope=scope),
                        tuple(flash_kernel_names(torch.float32).values()))
    out["c_run_steps"]["profile"] = {k: v for k, v in prof.items()
                                     if k != "top_kernels"}
    log(f"  profiled run_steps of {STEPS_PROFILE_K} steps [{card}]: "
        + json.dumps(out["c_run_steps"]["profile"]))
    del scopes, scope, start, exe
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 15: the trainable control flow at machine translation's width
# ---------------------------------------------------------------------------

def cf_program(kind: str, trips: int, w0):
    """The recurrence h = tanh(h w + x_t) of tests/test_decode.py:72 at
    [CF_B, CF_T, CF_H]: ``kind`` "while" runs ``trips`` iterations of a
    While(max_iters=CF_T) (fewer: an early exit; more: truncated at the
    bound), "static_rnn" all CF_T steps.  (main, startup, fetch)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import unique_name
    from paddle_tpu_torch.core.program import Program, program_guard
    L = fluid.layers
    main, startup = Program(), Program()
    with program_guard(main, startup), unique_name.guard():
        x = L.data("x", [CF_T, CF_H], stop_gradient=False)
        w = L.create_parameter(
            [CF_H, CF_H], "float32", name="w",
            default_initializer=fluid.initializer.NumpyArrayInitializer(w0))
        if kind == "while":
            xt = L.transpose(x, perm=[1, 0, 2])
            h = L.fill_constant([CF_B, CF_H], "float32", 0.0)
            i = L.fill_constant([1], "int64", 0)
            n = L.fill_constant([1], "int64", trips)
            cond = L.less_than(i, n)
            with L.While(cond, max_iters=CF_T).block():
                x_t = L.array_read(xt, i)
                L.assign(L.tanh(L.elementwise_add(L.mul(h, w), x_t)), h)
                L.increment(i, 1)
                L.less_than(i, n, cond=cond)
            last = h
        else:
            rnn = L.StaticRNN()
            with rnn.step():
                x_t = rnn.step_input(x)
                mem = rnn.memory(shape=[CF_H], batch_ref=x_t,
                                 init_value=0.0)
                new = L.tanh(L.elementwise_add(L.mul(mem, w), x_t))
                rnn.update_memory(mem, new)
                rnn.step_output(new)
            last = L.squeeze(L.slice(rnn(), axes=[1], starts=[CF_T - 1],
                                     ends=[CF_T]), [1])
        loss = L.mean(L.square(last))
        fluid.append_backward(loss)
    return main, startup, [loss.name, "x@GRAD", "w@GRAD"]


def cf_run(main, startup, fetch, feed, device):
    """Run ``main`` once on ``device`` from its startup's values."""
    import paddle_tpu_torch as fluid
    exe, scope = fluid.Executor(device), fluid.Scope()
    exe.run(startup, scope=scope)
    return exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                   sync=True)


def cf_close(got, ref, label, rtol, atol) -> float:
    """Each of ``got`` within rtol/atol of ``ref``; returns the worst
    max|d| / max|ref|."""
    worst = 0.0
    for name, g, r in zip(("loss", "x@GRAD", "w@GRAD"), got, ref):
        g, r = np.asarray(g, np.float32), np.asarray(r, np.float32)
        if not (np.isfinite(g).all() and np.allclose(g, r, rtol=rtol,
                                                     atol=atol)):
            raise AssertionError(f"{label}: {name} max|d| "
                                 f"{np.abs(g - r).max()!r} (rtol {rtol}, "
                                 f"atol {atol})")
        worst = max(worst, float(np.abs(g - r).max())
                    / max(float(np.abs(r).max()), 1e-30))
    return worst


def check_training_while(dev, card: str) -> dict:
    """Phase 15a: the training while against the StaticRNN on the card
    and against the port on the CPU; an early exit and a truncation; no
    host read in the training form."""
    rs = np.random.RandomState(15)
    w0 = (rs.randn(CF_H, CF_H) / np.sqrt(CF_H)).astype("float32")
    x = rs.randn(CF_B, CF_T, CF_H).astype("float32")
    out = {}
    scan = cf_run(*cf_program("static_rnn", CF_T, w0), {"x": x}, dev)
    for label, trips in (("full", CF_T), ("early_exit", CF_T // 2),
                         ("truncated", 2 * CF_T)):
        prog = cf_program("while", trips, w0)
        card_out = cf_run(*prog, {"x": x}, dev)
        cpu_out = cf_run(*prog, {"x": x}, "cpu")
        r = {"vs_cpu": cf_close(card_out, cpu_out, f"{label} card vs CPU",
                                TRAIN_GRAD_TOL, 1e-6),
             "loss": float(card_out[0])}
        if trips >= CF_T:   # all CF_T steps: the StaticRNN's recurrence
            r["vs_static_rnn"] = cf_close(card_out, scan,
                                          f"{label} while vs StaticRNN",
                                          *CF_GRAD_TOL)
        out[label] = r
        if label == "full":
            cpu_full = cpu_out
    # no host read: a card-resident feed, deferred fetches, the plan built
    import paddle_tpu_torch as fluid
    main, startup, fetch = cf_program("while", CF_T, w0)
    exe, scope = fluid.Executor(dev), fluid.Scope()
    exe.run(startup, scope=scope)
    xd = torch.from_numpy(x).to(dev)
    exe.run(main, feed={"x": xd}, fetch_list=fetch, scope=scope, sync=True)
    torch.cuda.synchronize()
    with counting_syncs() as syncs:
        got = exe.run(main, feed={"x": xd}, fetch_list=fetch, scope=scope)
    out["syncs_in_run"] = syncs["n"]
    out["sync_sites"] = syncs["where"]
    shown = {k: v for k, v in out.items()
             if k not in ("syncs_in_run", "sync_sites")}
    log(f"  15a while h = tanh(h w + x_t), B={CF_B} T={CF_T} H={CF_H} "
        f"[{card}]: {json.dumps(shown)}; synchronizing calls in one "
        f"training run with a card-resident feed: {syncs['n']} "
        f"{syncs['where']}")
    if syncs["n"]:
        raise AssertionError(f"the training while read the card from the "
                             f"host: {syncs['where']}")
    cf_close(got, cpu_full, "card-resident feed vs CPU", TRAIN_GRAD_TOL,
             1e-6)
    return out


def build_decoder(seed: int = 3):
    """tests/test_contrib_decoder.py's model at DEC's width, its token
    loss masked by the target lengths: (main, startup, loss, params)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.contrib.decoder import (InitState, StateCell,
                                                  TrainingDecoder)
    from paddle_tpu_torch.core import unique_name
    from paddle_tpu_torch.core.program import Program, program_guard
    L = fluid.layers
    V, E, H, T = DEC["vocab"], DEC["emb"], DEC["hid"], DEC["T"]
    main, startup = Program(), Program()
    main.random_seed = startup.random_seed = seed
    with program_guard(main, startup), unique_name.guard():
        src = L.data("src", [1], dtype="int64", lod_level=1)
        tgt = L.data("tgt", [1], dtype="int64", lod_level=1)
        lbl = L.data("lbl", [T, 1], dtype="int64")
        lmask = L.data("lbl_mask", [T, 1])
        enc = L.sequence_pool(L.embedding(
            src, [V, E], param_attr=fluid.ParamAttr(name="dec.src_emb")),
            "first")
        h0 = L.fc(enc, H, act="tanh",
                  param_attr=fluid.ParamAttr(name="dec.h0.w"),
                  bias_attr=fluid.ParamAttr(name="dec.h0.b"))
        cell = StateCell(inputs={"x": None},
                         states={"h": InitState(init=h0)}, out_state="h")

        @cell.state_updater
        def updater(c):
            c.set_state("h", L.fc(
                L.concat([c.get_input("x"), c.get_state("h")], axis=1), H,
                act="tanh", param_attr=fluid.ParamAttr(name="dec.cell.w"),
                bias_attr=fluid.ParamAttr(name="dec.cell.b")))

        decoder = TrainingDecoder(cell)
        tgt_emb = L.embedding(tgt, [V, E],
                              param_attr=fluid.ParamAttr(name="dec.tgt_emb"))
        with decoder.block():
            cur = decoder.step_input(tgt_emb)
            decoder.state_cell.compute_state(inputs={"x": cur})
            decoder.state_cell.update_states()
            decoder.output(L.fc(decoder.state_cell.get_state("h"), V,
                                act="softmax",
                                param_attr=fluid.ParamAttr(name="dec.out.w"),
                                bias_attr=fluid.ParamAttr(name="dec.out.b")))
        tok = L.elementwise_mul(L.cross_entropy(decoder(), lbl), lmask)
        loss = L.mean(tok)
        fluid.optimizer.Adam(5e-3).minimize(loss)
    return main, startup, loss, sorted(p.name for p in main.all_parameters())


def decoder_feed(B: int, seed: int) -> dict:
    """The copy task of tests/test_contrib_decoder.py:66 at DEC's width:
    ragged target lengths (MT_SHORTEST..T), labels masked past them."""
    rs = np.random.RandomState(seed)
    V, T = DEC["vocab"], DEC["T"]
    src = rs.randint(2, V, (B, T)).astype("int64")
    tgt = np.zeros((B, T), "int64")
    lbl = np.zeros((B, T, 1), "int64")
    tgt[:, 1:] = src[:, :1]
    lbl[:, :-1, 0] = src[:, :1]
    lbl[:, -1, 0] = 1
    tlen = rs.randint(MT_SHORTEST, T + 1, (B,)).astype("int64")
    mask = (np.arange(T)[None, :] < tlen[:, None]).astype("float32")
    return {"src": src[..., None], "src@LEN": np.full((B,), T, "int64"),
            "tgt": tgt[..., None], "tgt@LEN": tlen, "lbl": lbl,
            "lbl_mask": mask[..., None]}


def check_training_decoder(dev, card: str) -> dict:
    """Phase 15b: one step card vs CPU from copied starts, then DEC_STEPS
    steps at DEC_B."""
    import paddle_tpu_torch as fluid
    main, startup, loss, params = build_decoder()
    init = fluid.Scope()
    fluid.Executor("cpu").run(startup, scope=init)
    values = init.to_numpy()
    feed = decoder_feed(DEC_PARITY_B, seed=5)
    fetch = [loss.name] + [p + "@GRAD" for p in params]
    got = {}
    for name, device in (("cpu", "cpu"), ("gpu", dev)):
        scope = fluid.Scope()
        scope.load_numpy(values, device=device)
        got[name] = fluid.Executor(device).run(main, feed=feed,
                                               fetch_list=fetch, scope=scope,
                                               sync=True)
    l_cpu, l_gpu = float(got["cpu"][0]), float(got["gpu"][0])
    loss_rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    if not math.isfinite(l_gpu) or loss_rel > TRAIN_LOSS_TOL:
        raise AssertionError(f"decoder loss card {l_gpu} vs CPU {l_cpu}")
    ratios = {}
    for name, g, r in zip(params, got["gpu"][1:], got["cpu"][1:]):
        scale = float(np.abs(r).max())
        ratios[name] = float(np.abs(g - r).max()) / max(scale, 1e-30)
        if not (scale > 0 and np.isfinite(g).all()
                and ratios[name] <= TRAIN_GRAD_TOL):
            raise AssertionError(f"decoder gradient of {name}: max|ref| "
                                 f"{scale}, ratio {ratios[name]}")
    worst = max(ratios, key=ratios.get)
    out = {"parity": {"loss_gpu": l_gpu, "loss_cpu": l_cpu,
                      "loss_rel_diff": loss_rel, "n_grads": len(params),
                      "worst_grad_ratio": ratios[worst],
                      "worst_grad_param": worst}}
    log(f"  15b decoder step B={DEC_PARITY_B}, card vs CPU: loss "
        f"{l_gpu!r} vs {l_cpu!r} (rel {loss_rel!r}), {len(params)} "
        f"gradients, worst max|d|/max|ref| {ratios[worst]!r} ({worst}; "
        f"tolerance {TRAIN_GRAD_TOL})")
    exe, scope = fluid.Executor(dev), fluid.Scope()
    exe.run(startup, scope=scope)
    feed = decoder_feed(DEC_B, seed=11)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for _ in range(DEC_STEPS):
        t = time.perf_counter()
        (l,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                       sync=True)
        step_ms.append((time.perf_counter() - t) * 1e3)
        losses.append(float(l))
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"decoder loss not finite and falling: "
                             f"{losses}")
    med = float(np.median(step_ms[2:]))
    out.update({"losses": losses, "step_ms": step_ms, "step_ms_median": med,
                "max_memory_allocated": torch.cuda.max_memory_allocated()})
    log(f"  15b decoder training B={DEC_B} [{card}]: step ms median {med!r} "
        f"(steps 3..{DEC_STEPS}, all {[round(x, 2) for x in step_ms]}), "
        f"loss {losses[0]!r} -> {losses[-1]!r}, max memory allocated "
        f"{out['max_memory_allocated']} bytes")
    return out


def cond_programs(flag_kind: str):
    """Phase 15c's programs at [CF_B, CF_H]: "cond" a conditional_block
    that replaces y = fc(x) by 3 fc2(x) when the fed flag holds, "ifelse"
    an IfElse on the sign of each row's sum.  (main, startup, fetch)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import unique_name
    from paddle_tpu_torch.core.program import Program, program_guard
    L = fluid.layers
    main, startup = Program(), Program()
    main.random_seed = startup.random_seed = 5
    with program_guard(main, startup), unique_name.guard():
        x = L.data("x", [CF_H], stop_gradient=False)
        if flag_kind == "cond":
            c = L.data("c", [1], append_batch_size=False)
            y = L.fc(x, CF_H, act="tanh",
                     param_attr=fluid.ParamAttr(name="cf.w1"))
            with L.ConditionalBlock([L.cast(c, "bool")]).block():
                L.assign(L.scale(L.fc(x, CF_H, param_attr=fluid.ParamAttr(
                    name="cf.w2")), scale=3.0), y)
        else:
            cond = L.less_than(L.reduce_sum(x, dim=1, keep_dim=True),
                               L.fill_constant([CF_B, 1], "float32", 0.0))
            ie = L.IfElse(cond)
            with ie.true_block():
                ie.output(L.fc(ie.input(x), CF_H, act="tanh",
                               param_attr=fluid.ParamAttr(name="cf.w1")))
            with ie.false_block():
                ie.output(L.square(ie.input(x)))
            (y,) = ie()
        loss = L.mean(L.square(y))
        fluid.append_backward(loss)
    params = sorted(p.name for p in main.all_parameters())
    return main, startup, [loss.name, y.name, "x@GRAD"] + \
        [p + "@GRAD" for p in params]


def check_cond_and_ifelse(dev, card: str) -> dict:
    """Phase 15c: conditional_block (flag 1 and 0) and IfElse, forward
    and gradients, card against CPU from copied starts."""
    import paddle_tpu_torch as fluid
    rs = np.random.RandomState(7)
    x = rs.randn(CF_B, CF_H).astype("float32")
    out = {}
    for label, kind, extra in (("cond_1", "cond", {"c": np.ones(1, "float32")}),
                               ("cond_0", "cond", {"c": np.zeros(1, "float32")}),
                               ("ifelse", "ifelse", {})):
        main, startup, fetch = cond_programs(kind)
        init = fluid.Scope()
        fluid.Executor("cpu").run(startup, scope=init)
        values = init.to_numpy()
        res = {}
        for name, device in (("cpu", "cpu"), ("gpu", dev)):
            scope = fluid.Scope()
            scope.load_numpy(values, device=device)
            res[name] = fluid.Executor(device).run(
                main, feed=dict(extra, x=x), fetch_list=fetch, scope=scope,
                sync=True)
        worst = 0.0
        for name, g, r in zip(fetch, res["gpu"], res["cpu"]):
            g, r = np.asarray(g, np.float32), np.asarray(r, np.float32)
            scale = float(np.abs(r).max())
            ratio = float(np.abs(g - r).max()) / max(scale, 1e-30)
            if not np.isfinite(g).all() or (scale > 0
                                            and ratio > TRAIN_GRAD_TOL) \
                    or (scale == 0 and np.abs(g).max() > 0):
                raise AssertionError(f"15c {label}: {name} card vs CPU "
                                     f"max|d|/max|ref| {ratio}")
            worst = max(worst, ratio)
        out[label] = {"worst_ratio": worst, "fetches": len(fetch),
                      "loss": float(res["gpu"][0])}
    log(f"  15c conditional_block and IfElse, B={CF_B} H={CF_H}, card vs "
        f"CPU [{card}]: {json.dumps(out)} (tolerance {TRAIN_GRAD_TOL} of "
        f"max|ref|)")
    return out


def run_control_flow(dev, card: str) -> dict:
    """Phase 15 (module doc): no hand-written kernel may launch."""
    before = kernel_launches()
    out = {"while": check_training_while(dev, card),
           "decoder": check_training_decoder(dev, card),
           "cond": check_cond_and_ifelse(dev, card)}
    moved = {k: v - before[k] for k, v in kernel_launches().items()
             if v != before[k]}
    if moved:
        raise AssertionError(f"phase 15 launched kernels: {moved}")
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 16: the book models and their op rules
# ---------------------------------------------------------------------------

def book_op_cases() -> dict:
    """Phase 16a's cases: name -> (op type, {slot: [numpy arrays]},
    attrs, [(slot, j) float inputs to differentiate]).  Each of the 24
    op types the book models brought (18 sequence ops, the 4 CTC/CRF
    ops, cos_sim, arg_max) and the 7 nested forms, at the book paths'
    widths: sequences B=16, T=64, D=32; the CRF at SRL's B=10, T=64, 59
    tags; cos_sim at the recommender's 200-wide towers."""
    rs = np.random.RandomState(16)

    def f(*shape):
        return rs.randn(*shape).astype("float32")

    def i(lo, hi, *shape):
        return rs.randint(lo, hi, shape).astype("int64")

    B, T, D = 16, 64, 32
    lens = i(1, T + 1, B)
    lens[:2] = (T, 0)                       # a full row and an empty one
    lens2 = i(0, 9, 4, 6)                   # nested [B=4, S=6], W=8
    C, L = 32, 16
    ctc_logit_len = i(L + 1, T + 1, 8)
    ctc_logit_len[0] = T
    crf_lens = i(4, SRL_T + 1, SRL_B)
    crf_lens[0] = SRL_T
    cases = {
        "sequence_softmax": ("sequence_softmax",
                             {"X": [f(B, T)], "SeqLen": [lens]}, {},
                             [("X", 0)]),
        "sequence_expand": ("sequence_expand", {"X": [f(B, D)],
                                                "Y": [f(B, T, D)]}, {},
                            [("X", 0)]),
        "sequence_reverse": ("sequence_reverse", {"X": [f(B, T, D)],
                                                  "SeqLen": [lens]}, {},
                             [("X", 0)]),
        "sequence_concat": ("sequence_concat", {"X": [f(B, T, D),
                                                      f(B, 16, D)]}, {},
                            [("X", 0), ("X", 1)]),
        "sequence_first_step": ("sequence_first_step", {"X": [f(B, T, D)]},
                                {}, [("X", 0)]),
        "sequence_conv": ("sequence_conv", {"X": [f(B, T, D)],
                                            "Filter": [f(3 * D, D)],
                                            "SeqLen": [lens]},
                          {"contextLength": 3, "contextStart": -1,
                           "contextStride": 1}, [("X", 0), ("Filter", 0)]),
        "sequence_slice": ("sequence_slice", {
            "X": [f(B, T, D)], "Offset": [i(0, T // 2, B, 1)],
            "Length": [i(0, T // 2 + 1, B, 1)]}, {}, [("X", 0)]),
        "sequence_erase": ("sequence_erase", {"X": [i(0, 6, B, T, 1)],
                                              "SeqLen": [lens]},
                           {"tokens": [0, 3]}, []),
        "sequence_enumerate": ("sequence_enumerate", {"X": [i(0, 50, B, T)],
                                                      "SeqLen": [lens]},
                               {"win_size": 3, "pad_value": -1}, []),
        "sequence_expand_as": ("sequence_expand_as", {
            "X": [f(B, D)], "Y": [f(B, T, 8)], "SeqLen": [lens]}, {},
            [("X", 0)]),
        "sequence_pad": ("sequence_pad", {"X": [f(B, T, D)], "PadValue": [
            np.array([-1.5], "float32")], "SeqLen": [lens]},
            {"padded_length": T + 8}, [("X", 0)]),
        "sequence_unpad": ("sequence_unpad", {"X": [f(B, T, D)],
                                              "Length": [lens]}, {},
                           [("X", 0)]),
        "sequence_reshape": ("sequence_reshape", {"X": [f(B, T, D)],
                                                  "SeqLen": [lens]},
                             {"new_dim": 2 * D}, [("X", 0)]),
        "row_conv": ("row_conv", {"X": [f(B, T, D)], "Filter": [f(4, D)],
                                  "SeqLen": [lens]}, {},
                     [("X", 0), ("Filter", 0)]),
        "sequence_mask": ("sequence_mask", {"X": [lens]},
                          {"maxlen": T, "out_dtype": "int64"}, []),
        "im2sequence": ("im2sequence", {"X": [f(4, 3, 32, 32)]},
                        {"kernels": [3, 3], "strides": [2, 2],
                         "paddings": [1, 1, 2, 0]}, [("X", 0)]),
        "sequence_scatter": ("sequence_scatter", {
            "X": [f(B, 40, D)], "Ids": [i(0, 40, B, T)],
            "Updates": [f(B, T, D)], "SeqLen": [lens]}, {},
            [("X", 0), ("Updates", 0)]),
        "lod_reset": ("lod_reset", {"X": [f(B, T, D)], "TargetLenTensor": [
            i(0, T + 1, B)]}, {}, [("X", 0)]),
        "warpctc": ("warpctc", {"Logits": [f(8, T, C)],
                                "Label": [i(1, C, 8, L)],
                                "LogitsLength": [ctc_logit_len],
                                "LabelLength": [i(0, L + 1, 8)]},
                    {"blank": 0}, [("Logits", 0)]),
        "ctc_align": ("ctc_align", {"Input": [i(0, 5, B, T)],
                                    "InputLength": [lens]},
                      {"blank": 0, "merge_repeated": True}, []),
        "linear_chain_crf": ("linear_chain_crf", {
            "Emission": [f(SRL_B, SRL_T, SRL_LABEL_DICT)],
            "Transition": [f(SRL_LABEL_DICT + 2, SRL_LABEL_DICT) * 0.5],
            "Label": [i(0, SRL_LABEL_DICT, SRL_B, SRL_T, 1)],
            "Length": [crf_lens]}, {},
            [("Emission", 0), ("Transition", 0)]),
        "crf_decoding": ("crf_decoding", {
            "Emission": [f(SRL_B, SRL_T, SRL_LABEL_DICT)],
            "Transition": [f(SRL_LABEL_DICT + 2, SRL_LABEL_DICT) * 0.5],
            "Length": [crf_lens]}, {}, []),
        "cos_sim": ("cos_sim", {"X": [f(32, 200)], "Y": [f(32, 200)]}, {},
                    [("X", 0), ("Y", 0)]),
        "arg_max": ("arg_max", {"X": [f(B, T, C)]}, {"axis": -1}, []),
    }
    for name, attrs in (("pool_sum", {"pooltype": "SUM"}),
                        ("pool_max", {"pooltype": "MAX"}),
                        ("softmax", {}), ("reverse", {}),
                        ("first_step", {}), ("last_step", {}),
                        ("pad", {"padded_length": 10}), ("unpad", {})):
        op = ("sequence_pool" if name.startswith("pool")
              else "sequence_" + name)
        ins = {"X": [f(4, 6, 8) if name == "softmax" else f(4, 6, 8, D)],
               "SeqLen2": [lens2]}
        if name == "pad":
            ins["PadValue"] = [np.array([0.5], "float32")]
        if name == "unpad":
            ins["Length"] = [lens2]
        cases["nested_" + name] = (op, ins, attrs, [("X", 0)])
    return cases


def run_rule_with_grads(op, ins, attrs, wrt, device, cots) -> tuple:
    """``op``'s rule on copies of ``ins`` on ``device``: its outputs and,
    for the float inputs ``wrt``, the gradient of sum(out * cot) over
    the float outputs (autograd through the rule), as host arrays."""
    from paddle_tpu_torch.core import registry
    tins = {k: [torch.from_numpy(np.array(a)).to(device) for a in v]
            for k, v in ins.items()}
    leaves = []
    for slot, j in wrt:
        tins[slot][j] = tins[slot][j].requires_grad_(True)
        leaves.append(tins[slot][j])
    with torch.enable_grad():
        outs = registry.get(op).lower(None, tins, attrs)
        got = {k: v[0].detach().cpu().numpy() for k, v in outs.items()}
        if not leaves:
            return got, []
        loss = sum((outs[k][0].float() * torch.from_numpy(c).to(device))
                   .sum() for k, c in cots.items())
        grads = torch.autograd.grad(loss, leaves)
    return got, [g.cpu().numpy() for g in grads]


def check_book_ops(dev, card: str) -> dict:
    """Phase 16a: every case of :func:`book_op_cases` on the card against
    the same rule on the CPU from the same inputs, forward and gradient:
    integer outputs exactly, float ones within ``BOOK_OP_REL`` of
    max|ref|; no hand-written kernel launches."""
    before = kernel_launches()
    out, types = {}, set()
    for name, (op, ins, attrs, wrt) in book_op_cases().items():
        types.add(op)
        host, _ = run_rule_with_grads(op, ins, attrs, [], "cpu", {})
        rs = np.random.RandomState(17)
        cots = {k: rs.randn(*v.shape).astype("float32")
                for k, v in sorted(host.items())
                if np.issubdtype(v.dtype, np.floating)}
        host, hgrads = run_rule_with_grads(op, ins, attrs, wrt, "cpu", cots)
        got, ggrads = run_rule_with_grads(op, ins, attrs, wrt, dev, cots)
        errs = {}
        pairs = [(s, got[s], host[s]) for s in sorted(host)] + [
            (f"{s}[{j}]@GRAD", g, h)
            for (s, j), g, h in zip(wrt, ggrads, hgrads)]
        for slot, g, h in pairs:
            if g.shape != h.shape or g.dtype != h.dtype:
                raise AssertionError(f"16a {name} {slot}: card {g.dtype} "
                                     f"{g.shape}, CPU {h.dtype} {h.shape}")
            if not np.issubdtype(h.dtype, np.floating):
                if not np.array_equal(g, h):
                    raise AssertionError(f"16a {name} {slot}: integer "
                                         f"outputs differ card vs CPU")
                errs[slot] = 0
                continue
            d = float(np.abs(g.astype(np.float64) - h).max()) if h.size else 0.
            scale = float(np.abs(h).max()) if h.size else 0.
            if not (np.isfinite(g).all() and d <= BOOK_OP_REL * scale):
                raise AssertionError(f"16a {name} {slot}: max|card - CPU| "
                                     f"{d} > {BOOK_OP_REL} * max|ref| "
                                     f"{scale}")
            errs[slot] = d / scale if scale else 0.0
        out[name] = {"op": op, "max_rel_err": max(errs.values()),
                     "by_slot": errs}
        log(f"  16a {name} ({op}): worst max|card - CPU| / max|ref| "
            f"{out[name]['max_rel_err']!r} over {sorted(errs)}")
    moved = {k: v - before[k] for k, v in kernel_launches().items()
             if v != before[k]}
    if moved:
        raise AssertionError(f"phase 16a launched kernels: {moved}")
    log(f"  16a [{card}]: {len(out)} cases of {len(types)} op types, card "
        f"vs CPU within {BOOK_OP_REL} of max|ref|, integers exact")
    return {"cases": out, "op_types": sorted(types)}


BOOK_CASES = {  # name: (build function, kwargs, batch)
    "fit_a_line": ("build_fit_a_line", {}, 64),
    "word2vec": ("build_word2vec", {}, 64),
    "word2vec_sparse": ("build_word2vec", {"is_sparse": True}, 64),
    "recommender": ("build_recommender", {}, 32),
    "label_semantic_roles": ("build_label_semantic_roles", SRL, SRL_B),
}


def build_book(case: str, seed: int = 3):
    """The port's book program ``case`` (models/book.py): (main,
    startup, loss, sorted parameter names)."""
    from paddle_tpu_torch.core import unique_name
    from paddle_tpu_torch.core.program import Program, program_guard
    from paddle_tpu_torch.models import book
    fn, kw, _ = BOOK_CASES[case]
    main, startup = Program(), Program()
    main.random_seed = startup.random_seed = seed
    with program_guard(main, startup), unique_name.guard():
        _, loss, _ = getattr(book, fn)(**kw)
    return main, startup, loss, sorted(p.name for p in main.all_parameters())


def book_feed(case: str, seed: int) -> dict:
    """One seeded batch of ``case`` at the widths of models/book.py's
    defaults (SRL: the book's vocabularies, ragged lengths
    SRL_SHORTEST..SRL_T with one full row)."""
    rs = np.random.RandomState(seed)
    B = BOOK_CASES[case][2]

    def ids(hi, *shape):
        return rs.randint(0, hi, shape).astype("int64")

    if case == "fit_a_line":
        x = rs.randn(B, 13).astype("float32")
        w = np.arange(1, 14, dtype="float32") / 13.0
        return {"x": x, "y": (x @ w)[:, None].astype("float32")}
    if case.startswith("word2vec"):
        return {n: ids(2000, B, 1) for n in ("firstw", "secondw", "thirdw",
                                             "forthw", "nextw")}
    if case == "recommender":
        return {"user_id": ids(100, B, 1), "gender_id": ids(2, B, 1),
                "age_id": ids(7, B, 1), "job_id": ids(21, B, 1),
                "movie_id": ids(200, B, 1),
                "category_id": ids(19, B, 4, 1),
                "category_id@LEN": rs.randint(1, 5, B).astype("int64"),
                "movie_title": ids(500, B, 10, 1),
                "movie_title@LEN": rs.randint(3, 11, B).astype("int64"),
                "score": rs.randint(1, 6, (B, 1)).astype("float32")}
    lens = rs.randint(SRL_SHORTEST, SRL_T + 1, B).astype("int64")
    lens[0] = SRL_T
    d = {}
    words = ("word_data", "ctx_n2_data", "ctx_n1_data", "ctx_0_data",
             "ctx_p1_data", "ctx_p2_data")
    for n, hi in ([(w, SRL_WORD_DICT) for w in words]
                  + [("verb_data", SRL_PRED_DICT),
                     ("mark_data", SRL_MARK_DICT),
                     ("target", SRL_LABEL_DICT)]):
        d[n] = ids(hi, B, SRL_T, 1)
        d[n + "@LEN"] = lens
    return d


def check_srl_lstms(fwd_calls: list, bwd_calls: list) -> dict:
    """SRL's eight ``lstm`` ops and their grads of one card step, each
    replayed on CPU copies of its own inputs (the plain K6/K7): Hidden
    and Cell within ``K6_FWD_ATOL``, every gradient within
    ``K7_GRAD_REL`` of max|ref| (phase 7's gates)."""
    from paddle_tpu_torch.core import registry
    opdef = registry.get("lstm")
    e_f, r_b = 0.0, 0.0
    for ins, attrs in fwd_calls:
        card = opdef.lower(None, ins, attrs)
        host = opdef.lower(None, {s: [v.cpu() for v in vs]
                                  for s, vs in ins.items()}, attrs)
        for slot in ("Hidden", "Cell"):
            e_f = max(e_f, (card[slot][0].cpu() - host[slot][0]).abs()
                      .max().item())
    for ins, attrs in bwd_calls:
        card = opdef.grad(None, ins, attrs)
        host = opdef.grad(None, {s: [None if v is None else v.cpu()
                                     for v in vs] for s, vs in ins.items()},
                          attrs)
        for slot, vals in host.items():
            for g, h in zip(card[slot], vals):
                if h is None:
                    continue
                d = (g.cpu() - h).abs().max().item()
                r_b = max(r_b, d / max(h.abs().max().item(), 1e-30))
    if not (e_f <= K6_FWD_ATOL and r_b <= K7_GRAD_REL):
        raise AssertionError(
            f"SRL's LSTMs on their own card inputs: K6 max|d| {e_f} "
            f"(gate {K6_FWD_ATOL}), K7 max|d|/max|ref| {r_b} (gate "
            f"{K7_GRAD_REL})")
    return {"k6_max_abs_err": e_f, "k7_max_rel_err": r_b,
            "fwd_calls": len(fwd_calls), "bwd_calls": len(bwd_calls)}


def train_book(dev, card: str, case: str) -> dict:
    """Phase 16b, one case: BOOK_STEPS SGD steps on the card and on the
    CPU from one copied start (the CPU's startup): every loss within
    ``BOOK_LOSS_RTOL``; SRL: K6 and K7 exactly ``depth`` launches a
    step each on the card and none on the CPU, its eight LSTMs on
    their own inputs at phase 7's gates, the CRF transition and the
    LSTM weights card vs CPU, the frozen ``emb`` table unchanged; every
    other case launches no hand-written kernel.  Then the step's wall
    median (sync=True), a profiled step, the synchronizing calls a step
    and the peak memory."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import lowering
    from paddle_tpu_torch.kernels import rnn as R
    srl = case == "label_semantic_roles"
    main, startup, loss, params = build_book(case)
    init = fluid.Scope()
    fluid.Executor("cpu").run(startup, scope=init)
    values = init.to_numpy()
    feed = book_feed(case, seed=160)
    lstm_w = sorted(op.inputs["Weight"][0] for op in main.global_block.ops
                    if op.type == "lstm")
    runs, fwd_calls, bwd_calls = {}, [], []
    for name, device in (("cpu", "cpu"), ("gpu", dev)):
        scope = fluid.Scope()
        scope.load_numpy(values, device=device)
        exe = fluid.Executor(device)
        losses, walls, per_step = [], [], []
        if name == "gpu":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        lowering.grad_recomputes = 0
        before = kernel_launches()
        for step in range(BOOK_STEPS):
            n0 = lstm_launches(R)
            t0 = time.perf_counter()
            with contextlib.ExitStack() as stack:
                if name == "gpu" and step == 0 and srl:
                    stack.enter_context(captured_inputs("lstm", fwd_calls))
                    stack.enter_context(captured_inputs("lstm", bwd_calls,
                                                        grad=True))
                (l,) = exe.run(main, feed=feed, fetch_list=[loss],
                               scope=scope, sync=True)
            walls.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(np.asarray(l)))
            per_step.append(tuple(b - a for a, b in zip(n0,
                                                        lstm_launches(R))))
        moved = {k: v - before[k] for k, v in kernel_launches().items()
                 if v != before[k]}
        runs[name] = dict(losses=losses, walls=walls, per_step=per_step,
                          moved=moved, scope=scope, exe=exe,
                          recomputes=lowering.grad_recomputes,
                          final=scope.to_numpy(params))
    cpu, gpu = runs["cpu"], runs["gpu"]
    out = {"steps": BOOK_STEPS, "batch": BOOK_CASES[case][2],
           "losses_gpu": gpu["losses"], "losses_cpu": cpu["losses"]}
    rel = [abs(a - b) / abs(b) for a, b in zip(gpu["losses"], cpu["losses"])]
    out["loss_rel_diff"] = max(rel)
    if not (all(math.isfinite(x) for x in gpu["losses"])
            and out["loss_rel_diff"] <= BOOK_LOSS_RTOL):
        raise AssertionError(f"16b {case}: losses card {gpu['losses']} vs "
                             f"CPU {cpu['losses']} (worst rel "
                             f"{out['loss_rel_diff']} > {BOOK_LOSS_RTOL})")
    if gpu["recomputes"] or cpu["recomputes"]:
        raise AssertionError(f"16b {case}: a grad op re-ran its forward")
    if cpu["moved"]:
        raise AssertionError(f"16b {case}: kernels launched on the CPU: "
                             f"{cpu['moved']}")
    if srl:
        depth = SRL["depth"]
        if any(s != (depth, depth) for s in gpu["per_step"]) or \
                set(gpu["moved"]) - {"K6", "K7"}:
            raise AssertionError(
                f"16b SRL: K6/K7 launches a step {gpu['per_step']} (want "
                f"{depth} each; the eligibility gate must pass at B="
                f"{SRL_B}, H={SRL['hidden_dim'] // 4}), other kernels "
                f"{gpu['moved']}")
        out["lstm_launches_per_step"] = list(gpu["per_step"][0])
        out["lstm_on_path"] = check_srl_lstms(fwd_calls, bwd_calls)
        del fwd_calls[:], bwd_calls[:]
        crf = "crfw"
        d = np.abs(gpu["final"][crf] - cpu["final"][crf]).max()
        out["crf_transition_rel_diff"] = float(
            d / np.abs(cpu["final"][crf]).max())
        w_rel = {n: float(np.abs(gpu["final"][n] - cpu["final"][n]).max()
                          / np.abs(cpu["final"][n]).max()) for n in lstm_w}
        upd_rel = {n: float(np.abs(gpu["final"][n] - cpu["final"][n]).max()
                            / np.abs(cpu["final"][n] - values[n]).max())
                   for n in lstm_w}
        out.update(lstm_weight_rel_diff=max(w_rel.values()),
                   lstm_update_rel_diff=max(upd_rel.values()))
        frozen = all(np.array_equal(r["final"]["emb"], values["emb"])
                     for r in (cpu, gpu))
        if not (out["crf_transition_rel_diff"] <= SRL_CRF_RTOL
                and out["lstm_weight_rel_diff"] <= K7_GRAD_REL and frozen):
            raise AssertionError(
                f"16b SRL after {BOOK_STEPS} steps: crfw card vs CPU "
                f"{out['crf_transition_rel_diff']} of max|ref| (gate "
                f"{SRL_CRF_RTOL}), LSTM weights {w_rel} (gate "
                f"{K7_GRAD_REL}), emb unchanged {frozen}")
    elif gpu["moved"]:
        raise AssertionError(f"16b {case}: hand-written kernels launched: "
                             f"{gpu['moved']}")
    exe, scope = gpu["exe"], gpu["scope"]
    out["step_ms"] = gpu["walls"]
    out["step_ms_median"] = float(np.median(gpu["walls"][1:]))
    out["cpu_step_ms_median"] = float(np.median(cpu["walls"][1:]))
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    torch.cuda.synchronize()
    with counting_syncs() as syncs:
        for _ in range(2):
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                    sync=True)
    out["syncs_per_step"] = syncs["n"] / 2
    out["sync_sites"] = syncs["where"]
    with fluid.scope_guard(scope):
        prof = profile_step(exe, main, feed, loss,
                            (K6_KERNEL,) + K7_LAUNCHES if srl else ())
    out["profile"] = {k: v for k, v in prof.items() if k != "top_kernels"}
    out["top_kernels"] = prof.get("top_kernels", [])[:6]
    log(f"  16b {case} [{card}]: B={out['batch']}, losses card "
        f"{[round(x, 6) for x in gpu['losses']]} (worst rel vs CPU "
        f"{out['loss_rel_diff']!r}); step ms median {out['step_ms_median']!r}"
        f" (CPU {out['cpu_step_ms_median']!r}), busy "
        f"{prof.get('device_busy_ms')!r} ms, idle share "
        f"{prof.get('device_idle_share')!r}, kernels "
        f"{prof.get('kernels_launched')}, syncs a step "
        f"{out['syncs_per_step']!r} {syncs['where']}, peak "
        f"{out['max_memory_allocated']} bytes")
    if srl:
        log(f"    SRL: K6/K7 {out['lstm_launches_per_step']} a step; on "
            f"their own inputs {json.dumps(out['lstm_on_path'])}; crfw rel "
            f"{out['crf_transition_rel_diff']!r}, LSTM weights rel "
            f"{out['lstm_weight_rel_diff']!r} (of the update "
            f"{out['lstm_update_rel_diff']!r}); K6/K7 in the profiled step "
            f"{prof.get('focus_ms')}")
    del runs
    return out


def time_srl_shapes(dev) -> dict:
    """K6 and K7 at SRL's shape (B=10, T=64, H=128, ragged) against their
    plain versions (phase 7's gates), by device time beside their bounds
    and cuDNN's LSTM (TF32 off; CUDA events, a different function: full
    lengths, input projection inside); ``linear_chain_crf`` forward +
    autograd backward at SRL's shape by device time."""
    from paddle_tpu_torch.core import registry
    from paddle_tpu_torch.kernels import rnn as R
    B, T, H = SRL_B, SRL_T, SRL["hidden_dim"] // 4
    x = lstm_inputs(dev, B, T, H, seed=161, lo=SRL_SHORTEST)
    a, dhs, dcs = x["args"], x["dhs"], x["dcs"]
    hs, cs = R.lstm_fused(*a)
    ref_h, ref_c = R.lstm_ref(*a)
    e_f = max((hs - ref_h).abs().max().item(), (cs - ref_c).abs().max().item())
    grads = R.lstm_fused_grad(*a, hs, cs, dhs, dcs)
    ref_g = R.lstm_grad_ref(*a, hs, cs, dhs, dcs)
    r_b = max((g - r).abs().max().item() / max(r.abs().max().item(), 1e-30)
              for g, r in zip(grads, ref_g))
    if not (e_f <= K6_FWD_ATOL and r_b <= K7_GRAD_REL):
        raise AssertionError(f"K6/K7 at SRL's shape: {e_f} (gate "
                             f"{K6_FWD_ATOL}), {r_b} (gate {K7_GRAD_REL})")
    work = lstm_work(x)
    # K6 and K7's three launches in one set of profiler sessions
    k = device_ms_by_name(lambda _: (R.lstm_fused(*a), R.lstm_fused_grad(
        *a, hs, cs, dhs, dcs)), [None], 20, (K6_KERNEL,) + K7_LAUNCHES)
    k7 = {n: k[n] for n in K7_LAUNCHES}
    work["fwd"]["ms"] = k[K6_KERNEL]
    work["bwd"].update(ms=sum(k7.values()), launch_ms=k7)
    cudnn = time_cudnn(dev, B, T, H, tf32=False)
    for k in ("fwd", "bwd"):
        work[k]["library_ms"] = cudnn[k]
    work["fwd"]["max_abs_err"], work["bwd"]["max_rel_err"] = e_f, r_b
    rs = np.random.RandomState(162)
    C = SRL_LABEL_DICT
    lens = torch.from_numpy(rs.randint(SRL_SHORTEST, T + 1, B)).to(dev)
    em = torch.from_numpy(rs.randn(B, T, C).astype("float32")).to(dev)
    tr = torch.from_numpy(rs.randn(C + 2, C).astype("float32")).to(dev)
    lab = torch.from_numpy(rs.randint(0, C, (B, T, 1))).to(dev)
    rule = registry.get("linear_chain_crf").lower

    def crf(_):
        e, t = em.requires_grad_(True), tr.requires_grad_(True)
        ll = rule(None, {"Emission": [e], "Transition": [t], "Label": [lab],
                         "Length": [lens]}, {})["LogLikelihood"][0]
        return torch.autograd.grad(ll.sum(), (e, t))

    # one call a profiler session: the host's post-processing of a
    # call's ~6,000 profiler records takes about half a second
    crf_ms = device_ms(crf, [None], 1)
    crf_wall = time_ms(crf, [None], iters=3, warmup=1)
    out = {"shape": [B, T, H], "lstm": work,
           "crf_fwd_bwd_ms": crf_ms, "crf_fwd_bwd_wall_ms": crf_wall}
    for k, r in work.items():
        log(f"  SRL's shape B={B} T={T} H={H} {k}: kernel {r['ms']!r} ms "
            f"(device), bound {r['bound_ms']!r} ms ({r['bound_by']}), cuDNN "
            f"{r['library_ms']!r} ms (CUDA events)")
    log(f"  linear_chain_crf forward + backward at B={B} T={T} C={C}: "
        f"{crf_ms!r} ms device time, {crf_wall!r} ms wall")
    return out


def run_book(dev, card: str) -> dict:
    """Phase 16 (module doc); each part's seconds go to ``seconds``."""
    seconds = {}

    def part(name, fn, *args):
        t0 = time.perf_counter()
        r = fn(*args)
        torch.cuda.empty_cache()
        seconds[name] = time.perf_counter() - t0
        return r

    out = {"ops": part("16a", check_book_ops, dev, card)}
    for case in BOOK_CASES:
        out[case] = part(case, train_book, dev, card, case)
    out["srl_shape"] = part("srl_shape", time_srl_shapes, dev)
    out["seconds"] = seconds
    log(f"  phase 16's parts, seconds: {json.dumps(seconds)}")
    return out


# ---------------------------------------------------------------------------
# phase 17: the refcounted decode plane at Transformer-base width
# ---------------------------------------------------------------------------

# the bench's decode_prefix traffic (bench.py:1631-1830) at Transformer-
# base width with a 512-token context: 17a's shared prefix and 17b's
# overcommit leg
REFC = dict(FULL, max_seq_len=512)
PFX_BS, PFX_SLOTS, PFX_N, PFX_SHARED, PFX_UNIQ = 32, 16, 64, 416, 64
PFX_NEW, PFX_BUCKETS = 8, (512,)
OC_BS, OC_SLOTS, OC_N, OC_PROMPT, OC_NEW = 16, 16, 24, 16, 112
OC_POOL = 1 + (OC_N // 2) * (-(-(OC_PROMPT + OC_NEW) // OC_BS))   # 97
OC_BUCKETS = (16, 32, 64, 128)
OC_OOM_STEP = 40               # 17c: the injected out-of-memory step
CHECK_FLAGS = ("phase_attribution", "memory_attribution",
               "tenant_accounting", "capacity_attribution")
ATTRIBUTION_FLAGS = ("phase_attribution", "capacity_attribution")  # 17a


def near_tie_compare(truth, got, label) -> dict:
    """Streams of ``got`` against ``truth`` (lists of (tokens, logits)):
    tokens equal, except that a token may differ where the truth run's
    logits put its token and the other within ``LOGITS_TOL`` (phase 4's
    rule); such a tie is counted and that stream is compared no
    further.  Any other difference raises."""
    checked = ties = 0
    for i, ((a, al), b) in enumerate(zip(truth, got)):
        if len(a) != len(b):
            raise AssertionError(f"{label}: stream {i} has {len(b)} "
                                 f"tokens, the truth run {len(a)}")
        for k, (x, y) in enumerate(zip(a, b)):
            checked += 1
            if x == y:
                continue
            gap = float(al[k][x] - al[k][y])
            if gap > LOGITS_TOL:
                raise AssertionError(
                    f"{label}: stream {i} diverged at token {k}: {y} "
                    f"against the truth run's {x} (gap {gap!r} > "
                    f"{LOGITS_TOL})")
            ties += 1
            break
    return {"tokens_checked": checked, "near_ties": ties}


def serve_staged(engine, prompts, max_new) -> dict:
    """17a's protocol (the bench's): request 0 runs to completion, so
    its prefill registers the shared blocks, then the rest are offered
    at once; a consumer thread a stream stamps its first token.  The
    rest are submitted under the engine's lock, so its first admission
    sweep sees them all and the schedule (which blocks each stream
    gets, and when) is a function of the traffic alone."""
    from paddle_tpu_torch.decode import SamplingParams
    first = [None] * len(prompts)
    t_sub = [0.0] * len(prompts)
    errors = []

    def consume(i, h):
        try:
            for _ in h:
                if first[i] is None:
                    first[i] = time.perf_counter()
        except Exception as e:   # noqa: BLE001 — re-raised below
            errors.append(e)
    t0 = time.perf_counter()
    handles, threads = [], []

    def offer(i, p):
        t_sub[i] = time.perf_counter()
        h = engine.submit(p, SamplingParams(max_new_tokens=max_new))
        handles.append(h)
        th = threading.Thread(target=consume, args=(i, h), daemon=True)
        th.start()
        threads.append(th)
        return h, th
    h, th = offer(0, prompts[0])
    h.result(timeout=600)
    th.join(timeout=60)
    with engine._lock:
        for i, p in enumerate(prompts[1:], 1):
            offer(i, p)
    for th in threads:
        th.join(timeout=600)
        if th.is_alive():
            raise TimeoutError("a decode stream did not finish")
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    results = [h.result(timeout=10) for h in handles]
    n_tok = sum(r["n_tokens"] for r in results)
    return {"handles": handles, "results": results, "wall_s": wall,
            "tokens_per_s": n_tok / wall,
            "ttft_ms": [(f - s) * 1e3 for f, s in zip(first, t_sub)]}


@contextlib.contextmanager
def k4_contexts(lm, store: list):
    """Record each decode step's context lengths (positions + 1 a
    lane) while the caller serves: a wrapper on ``decode_logits``."""
    orig = lm.decode_logits

    def wrapped(kc, vc, tokens, positions, *a, **kw):
        store.append((positions.cpu().numpy() + 1, kc.shape))
        return orig(kc, vc, tokens, positions, *a, **kw)
    lm.decode_logits = wrapped
    try:
        yield
    finally:
        del lm.decode_logits


def k4_step_bound(cl, shape, quantized) -> dict:
    """K4's bound for one launch over lanes of context ``cl``: each
    lane's K and V rows read once (and, int8, their blocks' scale rows),
    q read and the output written once; the QK and PV products."""
    _, _, bs, H, D = shape
    S = len(cl)
    item = 1 if quantized else 4
    rows = int(cl.sum())
    nbytes = rows * H * D * item * 2 + 2 * S * H * D * 4 + S * 4
    if quantized:
        nbytes += int((-(-cl // bs)).sum()) * H * 4 * 2
    return bound(nbytes, 2 * 2 * rows * H * D)


def time_calls(obj, names, acc: dict) -> None:
    """Add each call's host wall to ``acc[name]`` = [seconds, calls,
    longest call's seconds]: a wrapper on each named method of ``obj``
    (an instance attribute, which shadows the class's method)."""
    for n in names:
        orig = getattr(obj, n)

        def wrapped(*a, _orig=orig, _n=n, **kw):
            t0 = time.perf_counter()
            try:
                return _orig(*a, **kw)
            finally:
                dt = time.perf_counter() - t0
                s = acc.setdefault(_n, [0.0, 0, 0.0])
                s[0] += dt
                s[1] += 1
                s[2] = max(s[2], dt)
        setattr(obj, n, wrapped)


def scheduler_breakdown(eng, acc: dict, wall: float) -> dict:
    """Where a 17a engine's wall went: its scheduler thread's host time
    in admission (the prefix match's chain hash inside it), in prefill
    dispatches (``_register_prefix`` and its chain hash inside them) and
    in decode steps; the rest of the wall (the thread waiting for
    traffic); and the per-request phases and capacity components that
    the engine's own hooks recorded (FLAGS_phase_attribution,
    FLAGS_capacity_attribution)."""
    z = eng.decodez()
    spent = sum(acc.get(n, (0.0,))[0] for n in
                ("_admissible_locked", "_prefill", "_decode_step"))
    return {"host_s": {n.strip("_"): {"s": s, "calls": c, "max_s": m}
                       for n, (s, c, m) in acc.items()},
            "other_s": wall - spent,
            "phases_mean_ms": {k: v["mean_ms"] for k, v in
                               z["phases"]["phases"].items()},
            "capacity_busy_ms": {k: v["busy_ms"] for k, v in
                                 z["capacity"]["components"].items()}}


def prefix_engine(lm, name, on, dtype="float32", capture=True):
    """A 17a engine on ``lm``'s device (block 32, 16 slots, bucket 512)."""
    from paddle_tpu_torch.decode import DecodeEngine
    return DecodeEngine(lm, name=name, max_slots=PFX_SLOTS,
                        block_tokens=PFX_BS, prefill_buckets=PFX_BUCKETS,
                        max_queue=PFX_N + 4, capture_logits=capture,
                        cache_dtype=dtype, prefix_cache=on, device=lm.device)


def serve_prefix(eng, prompts, A, label) -> tuple:
    """One 17a engine through the shared-prefix traffic: its record and
    streams (tokens, logits), after its gates: no leaked block; K4
    launched n_layer x decode steps on the card and never on the CPU;
    with the prefix cache, saved prefill tokens 63 x 416 and block hits
    63 x 13 exactly."""
    cuda = eng.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    A.decode_attention.launches = 0
    res = serve_staged(eng, prompts, PFX_NEW)
    launches = A.decode_attention.launches
    steps = eng.stats.steps.value
    on = eng.prefix is not None
    rec = {"tokens_per_s": res["tokens_per_s"],
           "wall_s": res["wall_s"],
           "ttft_ms_mean": float(np.mean(res["ttft_ms"])),
           "ttft_ms_p50": pctl(res["ttft_ms"], 0.5),
           "prefill_ms_mean": eng.stats.prefill_ms.sum
           / max(eng.stats.prefill_ms.count, 1),
           "prefills": eng.stats.prefills.value,
           "decode_steps": steps, "k4_launches": launches,
           "leaked": eng.cache.allocator.leaked(
               eng.prefix.parked_blocks if on else 0)}
    if on:
        ps = eng._pstats
        rec.update(saved_prefill_tokens=ps.saved_prefill_tokens.value,
                   prefix_hits=ps.prefix_hits.value,
                   prefix_lookups=ps.prefix_lookups.value,
                   prefix_inserts=ps.prefix_inserts.value,
                   collisions=eng.prefix.collisions)
    want = REFC["n_layer"] * steps if cuda else 0
    if steps == 0 or launches != want or rec["leaked"] != 0:
        raise AssertionError(f"{label}: K4 launched {launches} times over "
                             f"{steps} decode steps (expected {want}), "
                             f"{rec['leaked']} blocks leaked")
    saved, hits = (PFX_N - 1) * PFX_SHARED, (PFX_N - 1) * (PFX_SHARED
                                                           // PFX_BS)
    if on and (rec["saved_prefill_tokens"] != saved
               or rec["prefix_hits"] != hits):
        raise AssertionError(f"{label}: saved {rec['saved_prefill_tokens']}"
                             f" tokens and {rec['prefix_hits']} hits, "
                             f"expected exactly {saved} and {hits}")
    return rec, [(r["tokens"], h.logits)
                 for r, h in zip(res["results"], res["handles"])]


def run_prefix_int8(lm, cpu_lm, A, prompts, card) -> dict:
    """17a, int8: the prefix-on engine with an int8 cache, so each hit's
    suffix prefill dequantizes the gathered context per block, on the
    card and on the CPU (the port's plain K4; the same weights and the
    same deterministic schedule, so each stream meets the same block
    history in both runs): saved tokens and hits exact in both, decode
    steps and prefills equal, and the card's tokens equal the CPU's
    under the near-tie rule."""
    recs, runs = {}, {}
    for where, m in (("card", lm), ("cpu", cpu_lm)):
        eng = prefix_engine(m, f"smoke_prefix_int8_{where}", True, "int8",
                            capture=where == "cpu")
        try:
            recs[where], runs[where] = serve_prefix(
                eng, prompts, A, f"17a int8 {where}")
        finally:
            eng.close()
    for k in ("decode_steps", "prefills"):
        if recs["card"][k] != recs["cpu"][k]:
            raise AssertionError(f"17a int8: {k} {recs['card'][k]} on the "
                                 f"card, {recs['cpu'][k]} on the CPU")
    out = {"card": recs["card"],
           "cpu": {k: recs["cpu"][k] for k in ("wall_s", "decode_steps",
                                               "prefills")},
           "parity": near_tie_compare(runs["cpu"],
                                      [t for t, _ in runs["card"]],
                                      "17a int8 card vs CPU")}
    log(f"  17a int8 [{card}]: {json.dumps(out)}")
    return out


def run_prefix_leg(dev, lm, cpu_lm, A, card) -> dict:
    """17a: the shared-prefix traffic, prefix cache off and on (float32,
    with each engine's wall attributed), then int8 with the cache on,
    on the card against the CPU."""
    from paddle_tpu_torch.core import flags
    rng = np.random.RandomState(3)
    shared = rng.randint(0, REFC["vocab"], PFX_SHARED).astype(np.int32)
    prompts = [np.concatenate([shared, rng.randint(
        0, REFC["vocab"], PFX_UNIQ).astype(np.int32)])
        for _ in range(PFX_N)]
    out, runs = {}, {}
    saved = flags.get_flags(list(ATTRIBUTION_FLAGS))
    flags.set_flags({k: True for k in ATTRIBUTION_FLAGS})
    try:
        for on in (False, True):
            key = "prefix_on" if on else "prefix_off"
            # both capture logits (the same readbacks in both timed
            # runs); the truth run's (prefix off) judge near-ties
            eng = prefix_engine(lm, f"smoke_{key}", on)
            acc = {}
            time_calls(eng, ("_admissible_locked", "_prefill",
                             "_register_prefix", "_decode_step"), acc)
            if on:
                time_calls(eng.prefix, ("chain_keys",), acc)
            try:
                rec, runs[key] = serve_prefix(eng, prompts, A, f"17a {key}")
                rec["scheduler"] = scheduler_breakdown(eng, acc,
                                                       rec["wall_s"])
            finally:
                eng.close()
            out[key] = rec
            log(f"  17a {key} [{card}]: {json.dumps(rec)}")
    finally:
        flags.set_flags(saved)
    out["parity"] = near_tie_compare(
        runs["prefix_off"], [t for t, _ in runs["prefix_on"]],
        "17a prefix on vs off")
    log(f"  17a: saved {out['prefix_on']['saved_prefill_tokens']} prefill "
        f"tokens and {out['prefix_on']['prefix_hits']} block hits "
        f"exactly; prefix on = off under the near-tie rule: "
        f"{json.dumps(out['parity'])}")
    out["int8"] = run_prefix_int8(lm, cpu_lm, A, prompts, card)
    # K4's device time inside the decode window, a fresh prefix-on
    # engine under the profiler; contexts recorded a step
    eng = prefix_engine(lm, "smoke_prefix_prof", True, capture=False)
    ctx = []
    try:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        with k4_contexts(lm, ctx), profile(
                activities=[ProfilerActivity.CPU,
                            ProfilerActivity.CUDA]) as prof:
            serve_staged(eng, prompts, PFX_NEW)
            torch.cuda.synchronize()
    finally:
        eng.close()
    k4 = [e for e in prof.events() if e.device_type == DeviceType.CUDA
          and K4_KERNELS in e.name]
    k4_ms = sum(e.time_range.end - e.time_range.start for e in k4) / 1e3
    n = REFC["n_layer"] * len(ctx)
    bounds = [k4_step_bound(cl, shape, False) for cl, shape in ctx]
    bound_ms = sum(b["bound_ms"] for b in bounds) / max(len(bounds), 1)
    live = [cl[cl > 1] for cl, _ in ctx]
    out["k4"] = {"launches": n, "device_records": len(k4),
                 "ms_per_launch": k4_ms / max(n, 1) if k4 else
                 "not measured",
                 "bound_ms_per_launch": bound_ms,
                 "bound_by": bounds[0]["bound_by"] if bounds else None,
                 "context_mean": float(np.mean(np.concatenate(live)))
                 if live else 0.0,
                 "live_lanes_mean": float(np.mean([len(x) for x in live]))}
    log(f"  17a K4 in the profiled decode window [{card}]: "
        f"{json.dumps(out['k4'])}")
    out["prefill_paths"] = time_prefill_paths(dev, lm, prompts[1])
    log(f"  17a prefill dispatches alone [{card}]: " + json.dumps(
        {k: ({kk: vv for kk, vv in v.items() if kk != "wall_ms"}
             if isinstance(v, dict) else v)
         for k, v in out["prefill_paths"].items()}))
    return out


def time_prefill_paths(dev, lm, prompt) -> dict:
    """17a's two prefill dispatches alone, recorded: the full prefill of
    the 480-token prompt on the 512 bucket, and the suffix prefill of
    its last 64 tokens over the 13 resident blocks (bucket 64): host
    wall a call (synchronized, 20 calls after 3), and the device busy
    time and kernel count of one profiled call each; with the host's
    cost of the chain hash over the prompt (``PrefixCache.chain_keys``,
    run by admission's ``match`` and by ``_register_prefix``)."""
    from paddle_tpu_torch.decode import BlockAllocator, PagedKVCache
    from paddle_tpu_torch.decode import PrefixCache
    cfg = lm.config
    MB = cfg.max_seq_len // PFX_BS
    cache = PagedKVCache(cfg.n_layer, cfg.n_head, cfg.head_dim, MB + 1,
                         PFX_BS, device=dev)
    kc, vc = cache.state()
    table = torch.arange(1, MB + 1, dtype=torch.int32, device=dev)
    L, start = len(prompt), PFX_SHARED
    full = torch.zeros((1, PFX_BUCKETS[0]), dtype=torch.int32, device=dev)
    full[0, :L] = torch.from_numpy(prompt).to(dev)
    sfx = torch.zeros((1, L - start), dtype=torch.int32, device=dev)
    sfx[0] = torch.from_numpy(prompt[start:]).to(dev)
    z = torch.zeros((), dtype=torch.int64, device=dev)
    temp = torch.zeros((), device=dev)

    def run_full():
        return lm.prefill(kc, vc, full, torch.tensor(L, device=dev), table,
                          z, temp, z)

    def run_sfx():
        return lm.prefill_suffix(kc, vc, sfx, torch.tensor(start, device=dev),
                                 torch.tensor(L, device=dev), table, z, temp,
                                 z)
    out = {}
    with torch.inference_mode():
        for name, fn in (("prefill", run_full), ("prefill_suffix", run_sfx)):
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            walls = []
            for _ in range(20):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            prof = profile_call(fn, ())
            out[name] = {"wall_ms_median": float(np.median(walls)),
                         "wall_ms": walls,
                         "device_busy_ms": prof.get("device_busy_ms"),
                         "kernels_launched": prof.get("kernels_launched"),
                         "top_kernels": prof.get("top_kernels", [])[:4]}
    pc = PrefixCache(BlockAllocator(MB + 1), PFX_BS, model_key="smoke")
    toks = [int(t) for t in prompt]
    t0 = time.perf_counter()
    for _ in range(20):
        pc.chain_keys(toks)
    out["chain_keys_ms"] = (time.perf_counter() - t0) * 1e3 / 20
    return out


def record_resumes(eng) -> list:
    """Log each resume's (rid, tokens kept at preemption): a wrapper on
    the engine's partial prefill."""
    seen = []
    orig = eng._prefill_partial

    def wrapped(i, slot, req, t0):
        if req.resume_tokens is not None:
            seen.append((req.rid, list(req.resume_tokens)))
        return orig(i, slot, req, t0)
    eng._prefill_partial = wrapped
    return seen


def occupancy_recorder(eng):
    """Slot occupancy from the lane counters (FLAGS_phase_attribution):
    over the whole run, and over the loaded window, which ends at the
    last admission sweep that found a queue (a wrapper on the engine's
    admission reads the counters there)."""
    lat = eng.stats.latency()
    start = (lat.live_slot_steps.value, lat.pad_slot_steps.value)
    last = [start]
    orig = eng._admissible_locked

    def wrapped():
        if eng._pending:
            last[0] = (lat.live_slot_steps.value, lat.pad_slot_steps.value)
        return orig()
    eng._admissible_locked = wrapped

    def finish() -> dict:
        live, pad = (last[0][k] - start[k] for k in (0, 1))
        whole_live = lat.live_slot_steps.value - start[0]
        whole_pad = lat.pad_slot_steps.value - start[1]
        return {"loaded_occupancy": live / max(live + pad, 1),
                "loaded_lane_steps": live + pad,
                "occupancy": whole_live / max(whole_live + whole_pad, 1)}
    return finish


def run_overcommit(lm, A, dtype, overcommit, name, prompts,
                   hooks=False) -> dict:
    """One 17b/17c run on ``lm``'s device: the 24 streams through the
    97-block pool, all submitted under the engine's lock, so the
    schedule (admissions, growth, preemptions) is a function of the
    traffic alone.  The truth runs capture their logits: full
    reservation, and every run on the CPU."""
    from paddle_tpu_torch.decode import DecodeEngine, SamplingParams
    from paddle_tpu_torch.distributed import faults
    from paddle_tpu_torch.observability import memory, tenant
    cuda = lm.device.type == "cuda"
    eng = DecodeEngine(lm, name=name, max_slots=OC_SLOTS,
                       block_tokens=OC_BS, num_blocks=OC_POOL,
                       prefill_buckets=OC_BUCKETS, max_queue=OC_N + 4,
                       capture_logits=not (overcommit and cuda),
                       cache_dtype=dtype, overcommit=overcommit,
                       device=lm.device)
    resumes = record_resumes(eng) if overcommit else []
    try:
        if cuda:
            torch.cuda.synchronize()
        A.decode_attention.launches = 0
        if hooks:
            faults.inject(f"oom:decode_step:n={OC_OOM_STEP},times=1")
        finish = occupancy_recorder(eng)
        t0 = time.perf_counter()
        with eng._lock:
            hs = [eng.submit(p, SamplingParams(max_new_tokens=OC_NEW),
                             tenant=f"t{i % 4}" if hooks else None)
                  for i, p in enumerate(prompts)]
        res = [h.result(timeout=600) for h in hs]
        if not eng.drain(timeout=60):
            raise AssertionError(f"{name}: the engine did not drain")
        wall = time.perf_counter() - t0
        occ = finish()
        launches = A.decode_attention.launches
        steps = eng.stats.steps.value
        rec = {"wall_s": wall,
               "tokens_per_s": sum(r["n_tokens"] for r in res) / wall,
               "decode_steps": steps, "k4_launches": launches,
               "leaked": eng.cache.allocator.leaked(),
               "finish": sorted(set(r["finish"] for r in res)), **occ}
        if overcommit:
            ps = eng._pstats
            rec.update(preempts=ps.preempts.value,
                       resumes=ps.preempt_resumes.value,
                       reprefill_tokens=ps.reprefill_tokens.value,
                       resumed_streams=len({r for r, _ in resumes}))
        if hooks:
            rec["hooks"] = check_hooks(eng, memory, tenant)
        elif overcommit and cuda:   # 17d, on the pools the streams used
            rec["block_copy"] = check_block_copy(eng)
    finally:
        if hooks:
            faults.clear()
        eng.close()
    want = REFC["n_layer"] * steps if cuda else 0
    if steps == 0 or launches != want or rec["leaked"] != 0 or \
            rec["finish"] != ["length"]:
        raise AssertionError(f"{name}: K4 launched {launches} times over "
                             f"{steps} decode steps (expected {want}), "
                             f"{rec['leaked']} blocks leaked, finishes "
                             f"{rec['finish']}")
    if overcommit and (rec["preempts"] < 1 or rec["resumes"] < 1):
        raise AssertionError(f"{name}: {rec['preempts']} preemptions, "
                             f"{rec['resumes']} resumes (expected >= 1)")
    streams = [(r["tokens"], h.logits) for r, h in zip(res, hs)]
    return {"rec": rec, "streams": streams, "resumes": resumes}


def check_hooks(eng, memory, tenant) -> dict:
    """17c's gates on the hooks (module doc, phase 17c)."""
    lat = eng.stats.latency()
    samples = list(lat.phases._ring)
    worst = 0.0
    for s in samples:
        if list(s["phases"]) != ["queue", "prefill", "decode"]:
            raise AssertionError(f"17c: phases {list(s['phases'])}")
        worst = max(worst, abs(sum(s["phases"].values()) - s["total_ms"]))
    if len(samples) != OC_N or worst > 5e-3:
        raise AssertionError(f"17c: {len(samples)} phase samples, the "
                             f"phases sum to the wall within {worst} ms")
    torch.cuda.synchronize()
    led = memory.ledger(set_gauges=False)
    in_use = int(torch.cuda.memory_stats(eng.device)[
        "allocated_bytes.all.current"])
    pool = led["pools"][f"decode_kv.{eng.name}"]
    d = led["devices"][memory.device_key(eng.device)]
    if pool["reserved"] != eng.cache.nbytes or \
            d["attributed"] + d["unattributed_bytes"] != \
            d["bytes_in_use"] or d["bytes_in_use"] != in_use:
        raise AssertionError(f"17c: the ledger {d} (pool {pool['reserved']}"
                             f", cache {eng.cache.nbytes}) does not "
                             f"reconcile with memory_stats {in_use}")
    resident = {t: v["resident_kv_bytes"]
                for t, v in tenant.meter().snapshot()["tenants"].items()}
    if any(resident.values()):
        raise AssertionError(f"17c: resident KV bytes left {resident}")
    from paddle_tpu_torch.observability import stats
    rec_n = stats.default_registry().to_dict().get(
        f"decode.{eng.name}.oom_recovered")
    oom = memory.last_oom()
    if rec_n != 1 or oom is None or \
            oom["top_holders"][0]["pool"] != f"decode_kv.{eng.name}":
        raise AssertionError(f"17c: oom_recovered {rec_n}, last OOM "
                             f"{oom and oom['top_holders']}")
    z = eng.decodez()
    return {"phase_samples": len(samples), "phase_sum_worst_ms": worst,
            "pool_bytes": pool["reserved"], "bytes_in_use": in_use,
            "unattributed_bytes": d["unattributed_bytes"],
            "tenants_resident_kv_bytes": resident, "oom_recovered": rec_n,
            "oom_top_holder": oom["top_holders"][0],
            "goodput": z["goodput"], "capacity": {
                k: z["capacity"][k] for k in ("completed", "binding_phase")
                if k in z["capacity"]}}


def check_block_copy(eng, n=8) -> dict:
    """17d: fork ``n`` blocks of every pool with ``_copy_block`` on the
    card (after the streams ended): each copy bit-equal to its source,
    scales included, every other block untouched."""
    g = torch.Generator(device=eng.device).manual_seed(17)
    for a in eng.cache.state():
        if a.dtype == torch.int8:
            a.copy_(torch.randint(-127, 128, a.shape, generator=g,
                                  device=a.device, dtype=torch.int8))
        else:
            a.copy_(torch.rand(a.shape, generator=g, device=a.device)
                    * 4 - 2)
    before = [a.clone() for a in eng.cache.state()]
    nb = eng.cache.num_blocks
    src = list(range(1, 1 + n))
    dst = list(range(nb - n, nb))
    for s, d in zip(src, dst):
        eng._copy_block(s, d)
    torch.cuda.synchronize()
    for a, b in zip(eng.cache.state(), before):
        ai = a.view(torch.int8) if a.dtype == torch.int8 else \
            a.view(torch.int32)
        bi = b.view(torch.int8) if b.dtype == torch.int8 else \
            b.view(torch.int32)
        if not torch.equal(ai[:, dst], bi[:, src]):
            raise AssertionError(f"17d: a forked block of a "
                                 f"{a.dtype} pool differs from its source")
        keep = [i for i in range(nb) if i not in dst]
        if not torch.equal(ai[:, keep], bi[:, keep]):
            raise AssertionError("17d: a block copy touched another block")
    return {"blocks": n, "pools": len(before),
            "dtypes": sorted({str(a.dtype) for a in before}),
            "bit_equal": True}


def run_overcommit_leg(lm, cpu_lm, A, card) -> dict:
    """17b (both dtypes, int8 also on the CPU), 17c and 17d."""
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.observability import capacity, memory, tenant
    rng = np.random.RandomState(11)
    prompts = [rng.randint(0, REFC["vocab"], OC_PROMPT).astype(np.int32)
               for _ in range(OC_N)]
    out = {}
    saved = flags.get_flags(list(CHECK_FLAGS) + ["memory_audit_interval_s"])
    flags.set_flags({"phase_attribution": True})   # the lane counters
    try:
        truth = {}
        for dtype in ("float32", "int8"):
            full = run_overcommit(lm, A, dtype, False,
                                  f"smoke_reserved_{dtype}", prompts)
            oc = run_overcommit(lm, A, dtype, True,
                                f"smoke_overcommit_{dtype}", prompts)
            truth[dtype] = full["streams"]
            got = [t for t, _ in oc["streams"]]
            rec = {"reserved": full["rec"], "overcommit": oc["rec"]}
            if dtype == "float32":
                rec["parity"] = near_tie_compare(
                    full["streams"], got, f"17b {dtype}")
            else:
                rec["against_reserved"] = check_int8_against_reserved(
                    oc, full)
                rec["parity"], rec["cpu"] = \
                    check_int8_overcommit_against_cpu(cpu_lm, A, oc, prompts)
            out[dtype] = rec
            log(f"  17b {dtype} [{card}]: " + json.dumps(rec))
        # 17c: the f32 overcommit leg with the hooks on and one OOM
        flags.set_flags({k: True for k in CHECK_FLAGS})
        flags.set_flags({"memory_audit_interval_s": 0.0})
        hooked = run_overcommit(lm, A, "float32", True,
                                "smoke_overcommit_hooks", prompts,
                                hooks=True)
        rec = hooked["rec"]
        rec["parity"] = near_tie_compare(
            truth["float32"], [t for t, _ in hooked["streams"]], "17c")
        out["hooks"] = rec
        log(f"  17c [{card}]: " + json.dumps(rec))
    finally:
        flags.set_flags(saved)
        memory.reset()
        tenant.reset()
        capacity.reset()
    return out


def check_int8_overcommit_against_cpu(cpu_lm, A, oc, prompts) -> tuple:
    """17b, int8, the gate: the same overcommit run on the CPU (the
    port's plain K4 on the same weights and the same schedule, so each
    stream meets the same block history, resumes included) must take
    the card's decode steps, preemptions, resumes and re-prefilled
    tokens exactly, and the card's tokens must equal the CPU's under
    the near-tie rule."""
    twin = run_overcommit(cpu_lm, A, "int8", True, "smoke_overcommit_cpu",
                          prompts)
    keys = ("decode_steps", "preempts", "resumes", "reprefill_tokens")
    card = {k: oc["rec"][k] for k in keys}
    cpu = {k: twin["rec"][k] for k in keys}
    if card != cpu:
        raise AssertionError(f"17b int8: the card's schedule {card} != the "
                             f"CPU's {cpu}")
    parity = near_tie_compare(twin["streams"],
                              [t for t, _ in oc["streams"]],
                              "17b int8 card vs CPU")
    return parity, dict(cpu, wall_s=twin["rec"]["wall_s"])


def check_int8_against_reserved(oc, full) -> dict:
    """17b, int8, recorded beside the gate
    (``check_int8_overcommit_against_cpu``): two properties of the reference's int8 cache, which the port keeps
    (``ROADMAP.md`` queue 3), make a stream's tokens depend on its
    blocks' history, so the overcommit run cannot be held to the
    reserved run token for token: a block handed to a stream keeps its
    last owner's scale, which the decode step's append takes as a floor
    (``max(old, amax)``), and a resumed stream's re-prefill quantizes
    its blocks once at their final scales where the uninterrupted
    stream requantized them as each scale grew.  The first token of
    every stream samples inside prefill on fresh float32 K/V, so it
    must equal the reserved run's; the rest is reported: streams equal,
    ending in a near-tie, or departing further (with the gap, and
    whether it was resumed)."""
    resumed = {rid for rid, _ in oc["resumes"]}
    equal, ties, departed = 0, 0, []
    for i, ((a, al), (b, _)) in enumerate(zip(full["streams"],
                                              oc["streams"])):
        if a[0] != b[0]:
            raise AssertionError(f"17b int8: stream {i}'s first token "
                                 f"{b[0]} != the reserved run's {a[0]}")
        k = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if k is None:
            equal += 1
        elif float(al[k][a[k]] - al[k][b[k]]) <= LOGITS_TOL:
            ties += 1
        else:
            departed.append({"stream": i, "token": k,
                             "gap": float(al[k][a[k]] - al[k][b[k]]),
                             "resumed": i + 1 in resumed})
    return {"first_tokens_equal": len(full["streams"]),
            "streams_equal": equal, "streams_near_tie": ties,
            "streams_departed": departed}


def warm_up(dev, lm) -> None:
    """Out of every timed window: the first calls of the prefill, the
    suffix prefill and the decode step (the library's lazy loading), on
    throwaway engines of both cache dtypes."""
    from paddle_tpu_torch.decode import DecodeEngine
    eng = DecodeEngine(lm, name="smoke_refc_warm", max_slots=PFX_SLOTS,
                       block_tokens=PFX_BS, prefill_buckets=PFX_BUCKETS,
                       prefix_cache=True, device=dev)
    try:
        w = np.full(480, 1, np.int32)
        eng.generate(w, max_new_tokens=4)
        w[416:] = 2                    # 17a's 13-block hit, suffix 64
        eng.generate(w, max_new_tokens=4)
    finally:
        eng.close()
    for dtype in ("float32", "int8"):
        eng = DecodeEngine(lm, name=f"smoke_refc_warm_{dtype}",
                           max_slots=OC_SLOTS, block_tokens=OC_BS,
                           prefill_buckets=OC_BUCKETS, cache_dtype=dtype,
                           overcommit=True, device=dev)
        try:
            eng.generate(np.arange(1, 1 + OC_PROMPT, dtype=np.int32),
                         max_new_tokens=OC_BS + 2)
        finally:
            eng.close()


def run_refcounted(dev, card: str) -> dict:
    """Phase 17 (module doc)."""
    from paddle_tpu_torch.decode import LMConfig, TransformerLM
    from paddle_tpu_torch.kernels import attention as A
    t0 = time.perf_counter()
    lm = TransformerLM(LMConfig(**REFC), device=dev)
    lm.init_params(seed=7)
    # the int8 legs' truth: the same weights on the CPU
    cpu_lm = TransformerLM(LMConfig(**REFC), device="cpu")
    cpu_lm.init_params(seed=7)
    warm_up(dev, lm)
    out = {"warm_s": time.perf_counter() - t0,
           "prefix": run_prefix_leg(dev, lm, cpu_lm, A, card)}
    out["prefix_s"] = time.perf_counter() - t0
    out["overcommit"] = run_overcommit_leg(lm, cpu_lm, A, card)
    out["seconds"] = time.perf_counter() - t0
    del lm, cpu_lm
    torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to check",
              file=sys.stderr)
        return 1
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import attention as A
    from paddle_tpu_torch.platform import get_device
    t_start = time.perf_counter()
    starts = {}

    def phase(title: str) -> None:
        """The phase's header, with the seconds since the start."""
        at = starts[title.split(":")[0]] = time.perf_counter() - t_start
        log(f"== phase {title} (at {at:.1f} s)")

    dev = get_device()
    card = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    phase("1: the card")
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {kind}, count {torch.cuda.device_count()}")

    phase("2: build the kernels")
    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"  built {sorted(built)} in {time.perf_counter() - t0:.2f} s")
    for name in built:
        for line in _build.build_info[name]["log"].splitlines():
            if "registers" in line or "spill" in line or "C7515" in line:
                log(f"  {name}: {line.strip()}")

    phase("3: kernels against their plain versions")
    kern = check_and_time_paged_attention(dev)

    phase("3b: flash-attention kernels against their plain versions")
    flash = check_and_time_flash(dev)
    phase("3b, bfloat16: the flash kernels' bfloat16 mode")
    flash_bf16 = check_and_time_flash_bf16(dev, flash)

    phase("3c: fused LSTM kernels against their plain versions")
    lstm_k = check_and_time_lstm(dev)

    phase("3d: sparse-embedding kernels against their plain versions")
    sparse_k = check_and_time_sparse(dev)

    phase("3e: fused GRU kernels against their plain versions")
    gru_k = check_and_time_gru(dev)

    phase("3f: the int8 FC kernel against its plain version")
    int8_k = check_and_time_int8_fc(dev)

    phase("4: the decode slice end to end")
    e2e = run_slice(dev, card)

    phase("5: Transformer-base training through Executor.run")
    train = run_training(dev, card)
    phase("5, bfloat16: the bench's dtype")
    train_bf16 = run_training(dev, card, "bfloat16")

    phase("7: stacked-LSTM training through Executor.run")
    lstm_train = run_stacked_lstm(dev, card)

    phase("8: DeepFM sparse-embedding training through Executor.run")
    deepfm_train = run_deepfm(dev, card)

    phase("9: machine-translation training through Executor.run")
    mt_train = run_machine_translation(dev, card)

    phase("10: int8 serving of Transformer-base through ModelManager")
    serving = run_int8_serving(dev, card)

    phase("11: machine-translation beam inference through While")
    mt_beam = run_mt_beam(dev, card)

    phase("11b: PagedBeamDecoder over the paged KV cache")
    paged_beam = run_paged_beam(dev, card)

    phase("12: convolutional training and inference through "
          "Executor.run")
    conv = run_conv(dev, card)

    phase("13: ring attention (K11) and Transformer-base on a "
          "mesh's sp axis")
    ring = run_ring(dev, card)

    phase("13a, bfloat16: the ring over the bfloat16 K1-K3")
    ring["kernel_bf16"] = check_and_time_ring(dev, torch.bfloat16)

    phase("14: run_steps and deferred fetches at Transformer-base width")
    steps = run_steps_phase(dev, card)

    phase("15: the trainable control flow at machine translation's width")
    control_flow = run_control_flow(dev, card)

    phase("16: the book models through Executor.run")
    book = run_book(dev, card)

    phase("17: the refcounted decode plane at Transformer-base width")
    refc = run_refcounted(dev, card)

    phase("6: kernels")
    rows = []
    # K4 at the decode shape by device time (SDPA's too); the long
    # context beside it
    for dtype, key in (("float32", "float32"), ("int8", "int8")):
        k = kern[dtype]
        rows.append({
            "name": f"paged_decode_attn_{dtype}", "route": "cuda",
            "source": "paddle_tpu_torch/kernels/csrc/paged_decode_attn.cu",
            "replaces": "paddle_tpu/kernels/attention.py:948",
            "launches": e2e[key]["kernel_launches"],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "event_ms": k["event_ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"],
            "long_ms": k["long"]["ms"],
            "long_bound_ms": k["long"]["bound_ms"],
            "long_library_ms": k["long"]["library_ms"]})
        if dtype == "float32":   # the paged beam decode (phase 11b)
            rows[-1]["beam_launches"] = paged_beam["cow"]["k4_launches"]
        # phase 17: K4 on shared prefix blocks (17a), on tables that grow
        # and on re-prefilled, resumed streams (17b, 17c)
        oc = refc["overcommit"]
        rows[-1]["refcounted_launches"] = {
            "overcommit": oc[dtype]["overcommit"]["k4_launches"],
            "reserved": oc[dtype]["reserved"]["k4_launches"]}
        if dtype == "float32":
            rows[-1]["refcounted_launches"].update(
                prefix_on=refc["prefix"]["prefix_on"]["k4_launches"],
                prefix_off=refc["prefix"]["prefix_off"]["k4_launches"],
                hooks=oc["hooks"]["k4_launches"])
            rows[-1]["prefix_ms_per_launch"] = \
                refc["prefix"]["k4"]["ms_per_launch"]
            rows[-1]["prefix_bound_ms_per_launch"] = \
                refc["prefix"]["k4"]["bound_ms_per_launch"]
        else:
            rows[-1]["refcounted_launches"]["prefix_on"] = \
                refc["prefix"]["int8"]["card"]["k4_launches"]
    names = {"fwd": ("flash_attn_fwd", "flash_attn_fwd.cu", 226, 0),
             "bwd_dq": ("flash_attn_bwd_dq", "flash_attn_bwd.cu", 459, 1),
             "bwd_dkv": ("flash_attn_bwd_dkv", "flash_attn_bwd.cu", 507, 2)}
    for key, (name, src, line, i) in names.items():
        t = flash["self_dropout"][key]   # the main path's most common shape
        row = {
            "name": name, "route": "cuda",
            "source": f"paddle_tpu_torch/kernels/csrc/{src}",
            "replaces": f"paddle_tpu/kernels/attention.py:{line}",
            "launches": train["launches"][i],
            "run_steps_launches": steps["c_run_steps"]["launches"][i],
            "max_abs_err": flash["max_abs_err"][key], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]}
        if key != "fwd":
            # SDPA's one backward call computes dq, dk, dv and its delta:
            # it stands against the pair, delta + K2 + K3
            row.update(library_ms_is_for="delta + K2 + K3",
                       pair_ms=flash["self_dropout"]["bwd"]["ms"])
        rows.append(row)
    # the bfloat16 mode: launches from 13a's bfloat16 ring (counted from
    # 0), errors against the plain bfloat16 version, times at the
    # training shape (dropout 0.1) beside SDPA in bfloat16 and the
    # float32 kernel, and at bench_flash_attention_long's two shapes
    src = {"fwd": "flash_attn_fwd_bf16.cu", "bwd_dq": "flash_attn_bwd_bf16.cu",
           "bwd_dkv": "flash_attn_bwd_bf16.cu"}
    for key, (name, _, line, i) in names.items():
        t = flash_bf16["self_dropout"][key]
        row = {
            "name": f"{name}_bf16", "route": "cuda",
            "source": f"paddle_tpu_torch/kernels/csrc/{src[key]}",
            "replaces": f"paddle_tpu/kernels/attention.py:{line}",
            "launches": ring["kernel_bf16"]["main_path_launches"][i],
            "max_abs_err": flash_bf16["max_abs_err"][key],
            "max_rel_err": flash_bf16["max_rel_err"][key], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "f32_ms": t["f32_ms"]}
        if key != "fwd":
            row.update(library_ms_is_for="delta + K2 + K3",
                       pair_ms=flash_bf16["self_dropout"]["bwd"]["ms"])
        for label, r in flash_bf16["long"].items():
            row[f"long_{label}"] = {k: r[key][k] for k in
                                    ("ms", "f32_ms", "bound_ms")}
            if key == "fwd":
                row[f"long_{label}"]["library_ms"] = r["fwd"]["library_ms"]
        r = flash_bf16["ring_pair"]
        if key != "fwd":
            row["ring_pair"] = {"ms": r[key]["ms"],
                                "bound_ms": r[key]["bound_ms"],
                                "pair_ms": r["bwd"]["ms"],
                                "library_ms": r["bwd"]["library_ms"]}
        else:
            row["ring_pair"] = {label: {k: v[k] for k in (
                "ms", "bound_ms", "library_ms", "max_rel_err")}
                for label, v in r["fwd"].items()}
            row["occupancy"] = flash_bf16["fwd_occupancy"]
        kernel = flash_kernel_names(torch.bfloat16)[key]
        row["sass"] = {fn: n for fn, n in flash_bf16["sass"].items()
                       if kernel in fn}
        rows.append(row)
    for i, (key, line) in enumerate((("fwd", 69), ("bwd", 91))):
        t = lstm_k["ragged"][key]   # the training path's ragged lengths
        s = book["srl_shape"]["lstm"][key]   # SRL's B=10, T=64, H=128
        rows.append({
            "name": f"lstm_{key}", "route": "cuda",
            "source": f"paddle_tpu_torch/kernels/csrc/lstm_{key}.cu",
            "replaces": f"paddle_tpu/kernels/rnn.py:{line}",
            "launches": lstm_train["launches"][i],
            "max_abs_err": lstm_k["max_abs_err"][key], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            # phase 16: launches a step of SRL at the book's width
            "srl_launches": book["label_semantic_roles"][
                "lstm_launches_per_step"][i],
            "srl_ms": s["ms"], "srl_bound_ms": s["bound_ms"],
            "srl_library_ms": s["library_ms"]})
    # K10 at the larger table's shape ([1e6, 10], Adam), one launch
    for name, key, line, i in (("sparse_gather", "gather", 176, 0),
                               ("sparse_update", "update_emb", 256, 1)):
        t = sparse_k[key]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"paddle_tpu_torch/kernels/csrc/{name}.cu",
            "replaces": f"paddle_tpu/kernels/sparse.py:{line}",
            "launches": deepfm_train["fused"]["launches"][i],
            "max_abs_err": sparse_k["max_abs_err"][key.split("_")[0]],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
        # wall per call in a loop, beside the library call's
        rows[-1].update(wall_ms=t["wall_ms"],
                        library_wall_ms=t["library_wall_ms"])
        if name == "sparse_gather":   # skewed ids
            rows[-1].update(skewed_ms=sparse_k["gather_skewed"]["ms"])
        if name == "sparse_update":   # the DeepFM step's pair; skewed ids
            rows[-1].update(step_ms=sparse_k["update_step"]["ms"],
                            skewed_ms=sparse_k["update_skewed"]["ms"])
    # K8a/K8b at the path's shape and ragged lengths; library: cuDNN's
    # GRU, a different function (reset after the product)
    for i, (key, line) in enumerate((("fwd", 272), ("bwd", 288))):
        t = gru_k[key]
        row = {
            "name": f"gru_{key}", "route": "cuda",
            "source": f"paddle_tpu_torch/kernels/csrc/gru_{key}.cu",
            "replaces": f"paddle_tpu/kernels/rnn.py:{line}",
            "launches": mt_train["launches"][i],
            "max_abs_err": gru_k["max_abs_err"][key], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]}
        row["fma_bound_ms"] = t["fma_bound_ms"]   # bound at split TF32's rate
        # an MT beam decode (phase 11): K8a at B=1, K8b never
        row["mt_infer_launches"] = mt_beam["launches"][i]
        if key == "bwd":   # three launches
            row["launch_ms"] = t["launch_ms"]
        rows.append(row)
    # K5 at the path's most common shape (72 of a dispatch's 97
    # launches); every shape and the per-dispatch sums are in the json
    t = int8_k["proj"]
    rows.append({
        "name": "int8_fc", "route": "cuda",
        "source": "paddle_tpu_torch/kernels/csrc/int8_fc.cu",
        "replaces": "paddle_tpu/kernels/quant.py:167",
        "launches": serving["arms"]["int8"]["launches"],
        "max_abs_err": max(int8_k["max_abs_err"].values()),
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "dispatch_ms": int8_k["dispatch_sum"]["ms"],
        "dispatch_library_ms": int8_k["dispatch_sum"]["library_ms"]})
    # K11: no kernel of its own, the ring over K1-K3 (its launches are
    # theirs in phase 13b's steps); at bench_ring_shard's shape, dropout
    # 0.1 as on the path; library: SDPA over the whole 16,384 tokens
    r = ring["kernel"]["full_dropout"]
    errs = [e for c in RING_CASES for k in ("max_abs_err",
                                             "max_abs_err_vs_whole")
            for e in ring["kernel"][c].get(k, {}).values()]
    path = ring["ring"]["path_check"]
    path_errs = [e for c in path.values() for e in c["max_abs_err"].values()]
    rows.append({
        "name": "ring_attention", "route": "cuda",
        "source": "paddle_tpu_torch/kernels/attention.py",
        "composes": ["paddle_tpu_torch/kernels/csrc/flash_attn_fwd.cu",
                     "paddle_tpu_torch/kernels/csrc/flash_attn_bwd.cu",
                     "paddle_tpu_torch/kernels/csrc/flash_attn_fwd_bf16.cu",
                     "paddle_tpu_torch/kernels/csrc/flash_attn_bwd_bf16.cu"],
        "replaces": "paddle_tpu/kernels/attention.py:767",
        "launches": sum(ring["ring"]["launches"]),
        "launches_by_kernel": dict(zip(("K1", "K2", "K3"),
                                       ring["ring"]["launches"])),
        "max_abs_err": max(errs + path_errs),
        "path_max_abs_err": max(path_errs),
        "ms": r["fwd"]["ms"] + r["bwd"]["ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["fwd"]["bound_ms"] + r["bwd"]["bound_ms"],
        "bound_by": r["fwd"]["bound_by"], "library_ms": r["library_ms"],
        "fwd_ms": r["fwd"]["ms"], "bwd_ms": r["bwd"]["ms"],
        "overhead_ms": r["fwd"]["overhead_ms"] + r["bwd"]["overhead_ms"]})
    # the ring in bfloat16 over the bfloat16 K1-K3, dropout 0.1
    rb = ring["kernel_bf16"]["full_dropout"]
    rows[-1].update({
        "bf16_launches": sum(ring["kernel_bf16"]["main_path_launches"]),
        "bf16_max_abs_err": max(
            e for c in RING_BF16_CASES for k in ("max_abs_err",
                                                 "max_abs_err_vs_whole")
            for e in ring["kernel_bf16"][c].get(k, {}).values()),
        "bf16_ms": rb["fwd"]["ms"] + rb["bwd"]["ms"],
        "bf16_plain_ms": rb["plain_ms"],
        "bf16_bound_ms": rb["fwd"]["bound_ms"] + rb["bwd"]["bound_ms"],
        "bf16_bound_by": rb["fwd"]["bound_by"],
        "bf16_library_ms": rb["library_ms"]})
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "kind": kind, "torch": torch.__version__,
                   "cuda": torch.version.cuda, "build_s": built,
                   "kernels": kern, "flash": flash, "lstm": lstm_k,
                   "sparse": sparse_k, "gru": gru_k, "slice": e2e,
                   "flash_bf16": flash_bf16,
                   "training": train, "training_bf16": train_bf16,
                   "lstm_training": lstm_train,
                   "deepfm_training": deepfm_train,
                   "mt_training": mt_train, "int8_fc": int8_k,
                   "int8_serving": serving, "mt_beam": mt_beam,
                   "paged_beam": paged_beam, "conv": conv, "ring": ring,
                   "run_steps": steps, "control_flow": control_flow,
                   "book": book, "decode_refcounted": refc,
                   "profiler_losses": PROFILER_LOSSES,
                   "phase_starts_s": starts,
                   "seconds": time.perf_counter() - t_start}, f, indent=1)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
