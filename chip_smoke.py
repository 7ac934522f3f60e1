#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

  python3 chip_smoke.py

Phases, each raising on failure (exit code nonzero, no result line):

  1. print the card's name and power limit (nvidia-smi);
  2. build the kernels of every TPU kernel row from the nine sources of
     ``src/repro_torch/csrc`` (nvcc, sm_90a, one process per source, all
     started together), and beside them a library of planted faults
     (copies of pack.cu, quantize.cu and codec.cu, each with one line
     changed, under build/planted);
  3. hold each serving kernel against its plain PyTorch version at yi-6b
     shapes: K3 amax / K4 quantize on a stacked (32, 4096, 11008) f32
     leaf, and on qwen2.5-14b's (48, 5120) QKV-bias stack with all-zero
     layers (the 1e-30 scale floor and codes 0, bitwise); K2 page gather bitwise through both entry points (one pool,
     and a layer's K and V in one launch, one launch a call) at the
     serving cell's 4 x 8-page table and gemma2-2b's 4 x 264 pages,
     timed in CUDA graphs beside index_select (two of them for K and V);
     K1 dequant-matmul at M in
     {1, 4, 32} for every projection shape of yi-6b and gemma2-2b and
     every code type, at every projection shape of gemma3-4b and
     qwen2.5-14b (its untied head among them) in int8, the code type of
     their serving weights, and at ragged shapes across its row tiles (M 5 to
     100; packed rows of no whole 16 bytes among them), on tensor cores
     for bf16 activations against int8, int16 and 2/3/4/6-bit packed
     lanes, within one bf16 ulp (plus a floor near zero set from the
     measured fp32 summation-order noise; a dropped K row, on int8 codes
     and on 4-bit lanes, must fail that gate), and the same sums in
     float32 on CUDA cores within the floor; timed at every int8 shape
     with its kernel/library factor, every lane width at (4096, 11008),
     M = 4 and 32, with its factor and share of the bound, and the
     CUDA-core route at float32 activations against int8 codes; K1t,
     the transposed product of the tied head, at gemma2-2b's (256000,
     2304) table on tensor cores for bf16 activations against every code
     type (int8 at k_x = 6 at M in {1, 4}, also at gemma3-4b's (262144,
     2560) table, timed there at M 1 and 4 and on CUDA cores at M 4;
     int16 and 2/3/4/6-bit rows at M = 4) and at ragged V, d and M past
     one n8 tile, in the same tier
     (a dropped d column must fail it), the same sums in float32 on its
     CUDA-core route within the floor at every case (a dropped d column
     must fail that gate too); timed at M = 1 and 4 for every code type
     with its kernel/library factor and share of the bound, and the
     CUDA-core route (int8 at M = 1, 4, 8, 4-bit lanes at M = 4) beside
     the fp32 torch.matmul; #17 flash
     attention on the four cases of tests/test_kernels.py (float32,
     3xTF32 on tensor cores), gemma2-2b's prefill (B 1, S 8192, 8 heads
     over 4, hd 256) as a local (window 4096) and a global layer (softcap
     50) in bf16 and in float32, a ragged Sq/Skv in both, and the global
     layer without the softcap in both, within rtol 1e-4 / atol 1e-5
     (float32) or one bf16 ulp plus 1e-5 (a window off by one must fail
     it, in both), two calls bitwise equal, timed beside
     scaled_dot_product_attention: is_causal where it computes the same
     function (no softcap), else with a boolean mask and without the
     softcap; then
     the training kernels bitwise on the stacked (8, 4096, 11008) w_gate
     leaf and the (64000, 4096) embedding: K15 Adam+EF moments (m', v',
     Delta+e, the amax word), K16 EF quantize (codes, residual), K11 log
     dequantize, and the Q_x round trip as training runs it: K3 over the
     whole leaf as one row, K4 to int16 codes at k_x = 7, K12 uniform
     dequantize; then the wire kernels bitwise: K7 fused EF encode
     (payload rows, residual) and K6 fused decode (a scale per row, into
     rows or a flat leaf) over n_rows {1, 2, 4}, chunks {1, 7, 1000003},
     log k_g {2, 4, 6, 8, 30, 126}, uniform wire k_x {3, 6, 7, 14} and
     zero input, and at the w_gate stack for log:6 and uniform:7; the
     adaptive plan's new lanes at the w_gate stack, bitwise and timed:
     K7 and K6 at log:2, log:30, log:126 and uniform_amax:14:w16, #10
     and K11 at log:30 and log:126 (the reference's deep decision points
     and levels, grids.log_grid_table), and #5 timed at every lane width
     (3-, 6-, 8- and 16-bit lanes beside the ternary, log:6 and uniform:7
     timings below); then the
     baselines' kernels bitwise: #5 fused encode (log, uniform with the
     absolute and the amax scale, ternary on uniforms from one seeded
     generator; zero input) with K6 on its rows (the ternary kind), #14
     blockwise quantize and #8 blockwise encode at blocks {1, 32, 64, 256,
     1024, 4096}, over the same n_rows and chunks, and at the w_gate stack
     (timed at blocks 256 and 64); then the last three kernels bitwise:
     #10 log quantize at k_g {1, 2, 4, 6, 8, 30, 126} (random, zero and
     decision-point inputs), #13 ternary quantize (uniforms from one
     seeded generator, u = p exactly among them, x = 0, a zero scale) and
     #9 lane pack/unpack at every width over rows {1, 2, 4} x chunks
     {1, 7, 1000003}, each at the w_gate stack too, and the planted
     faults (#9's lane bias off by one, #13 comparing u <= p, K7 with
     one code off by one in the last vector of a chunk on 6-bit lanes)
     must fail those gates; time each kernel, its plain version and a one-call
     PyTorch yardstick where there is one (none for #9, #10, #13); then
     the reference's threefry draws (no Pallas kernel: XLA's threefry
     behind jax.random): rt_threefry_uniform bitwise its plain version at
     n 1, 3, 4099, 2^20 + 7, at an offset output and a start past 2^32,
     rt_threefry_keys bitwise at 1, 12 and 300 leaves for both chains,
     then the uniforms bitwise and timed at the w_gate stack (360.7 M
     elements; torch.rand, Philox, beside it for information) and both
     key launches timed at the cell's 12 leaves; then Model.init's and
     the sampling step's draws: rt_threefry_trunc_normal over the w_gate
     stack's 8 layer keys in one launch (slabs of the first and last
     4096 elements of layers 0 and 7 bitwise the plain version, as for
     a 32-layer wq stack and the embedding under one key; timed beside
     it and trunc_normal_) and rt_threefry_categorical with its fold at
     yi-6b's (4, 64000) and (1, 64000) (phase 4's decode step and first
     tokens), (4, 262144) and (4, 152064), greedy and sampled tokens and
     the keys written back bitwise the plain step over 64 seeded steps
     (ties planted), timed in a CUDA graph beside the plain step and
     argmax(logits / t - log(-log(rand))); then
     the MoE family's shapes: K12 through ``QuantizedLeaf.dequantize`` on
     a code-resident (2, 64, 2048, 1408) int8 stack (a sliced layer's
     184,549,376 codes one row, a view of the 4-D codes), alone and with
     the pending bf16 cast, bitwise its plain version; K1 at the routers'
     shapes ((4 or 128) x 2048 x 64, x 5120 x 16) on tensor cores; timed;
  4. serve full-width yi-6b (random weights from a seed): Model.init
     (the reference's key tree, each stacked leaf one truncated-normal
     launch; its seconds beside a trunc_normal_ init of the same tree),
     quantize_params(k_x=6), a paged ServeSession (page 16, 4 slots,
     chunked prefill 32) answering 8 requests of 64-token prompts with
     16 new tokens each, half of them sampled at temperature 0.8 (the
     sampling step eager, captured and replayed; the tokens equal an
     eager session's; the kernel bitwise its plain step on the session's
     own logits, temperatures and keys); the kernels' launch counts are read around this
     run and every one must be > 0 (the categorical kernel's among them),
     with no plain version on the card (every K2 launch gathering a
     layer's K and V; the Gumbel draw never plain); the decode step's and
     the chunk's wall and device time and device operations;
     then one decode step on identical state through the kernels and
     through the plain versions: relative L2 of the logits within
     SHALLOW_LIMIT for the bf16 step cut to 1 and 2 layers and within
     F32_LIMIT for the full-depth step in float32 activations (at full
     depth in bf16, fp32 summation order alone moves the logits by
     ~3e-2, which is printed, with a float64-summed step, not gated);
     the session's decode step must have been one CUDA graph (a capture,
     replays); then, in a session of 4 slots past 32-token prompts, one
     greedy step eager and through a fresh capture and replay from
     identical state, bitwise in logits, tokens and cache, and each way's
     wall time, device time, operations and idle share, and the same for
     the sampled step (every slot at temperature 0.8, the keys too);
     4b. the same for full-width gemma2-2b (26 layers, tied head, k_x = 6),
     in slots of 4224 positions, with a ninth request of 4200 prompt
     tokens: K1, K1t (on tensor cores only), K2, K3 and K4 launched, no
     plain version on the card, the same logits gates (depth 1 is a
     local layer, depth 2 adds a global one), and at position 4200 the
     windowed and the global model's logits must differ (the window is
     live), with the depth-2 gate there too;
     4g. the same for full-width gemma3-4b (34 layers, tied head of
     262144 rows, 5:1 local:global with window 1024, qk-norm with random
     weights, post-norms), slots of 1120 positions and a ninth request
     of 1100 prompt tokens: K1, K1t, K2, K3, K4, the gates, the window
     live at position 1100, and the local RoPE base live (the logits
     differ with one base for every layer);
     4h. the same for full-width qwen2.5-14b (48 layers, d 5120, untied
     head of 152064 columns, random QKV biases quantized per layer), its
     weights quantized leaf by leaf (each float32 leaf dropped once its
     codes exist) and the peak memory printed;
     4c. #17 through its entry point over one gemma2-2b prefill of 8192
     tokens (26 layers with their windows), in bf16 (route "tc") and
     then in float32 (route "tc32", 3xTF32), each route's count at 0
     before;
     4d. yi-6b cut to 4 layers served from 4-bit packed lanes
     (quantize_params(k_x=2, pack=True)), 4 requests: K1 on tensor cores
     only (its packed-lane instances; no CUDA-core launch), K2, K3, K4
     launched, no plain version on the card; decode and chunk wall and
     device time and, in 4d-4f alike, the session's decode step eager
     and graphed (one step bitwise);
     4e. the same cut served in float32 activations against int8 codes:
     K1's CUDA-core route only, the decode step's logits within F32_LIMIT
     of the plain step at the cut's depth;
     4f. gemma2-2b's widths cut to 4 layers served the same way in
     float32: K1's and K1t's CUDA-core routes only, the same logits gate;
     4i. gemma2-2b's widths cut to 4 layers, 6 requests admitted chunked,
     whole (one Model.prefill each, fixed lanes) and injected (fixed
     lanes and paged): every mode the chunked session's tokens, the
     whole and injected decode steps graphed, their kernels launched
     and no plain version on the card;
     4j. deepseek-moe-16b at full width and depth (28 layers, d 2048, 64
     routed experts top-6, 2 shared, expert d_ff 1408, vocab 102400),
     phase 4's protocol: 67.5 GB of float32 quantized leaf by leaf (the
     start-up peak printed), K1, K2, K3, K4 and K12 launched, no plain
     version on the card (the at-use dequantize included), the decode
     step graphed; one eager decode step launches K12 once a layer for
     each at-use leaf (the three expert stacks, the norms) and for the
     embedding rows, K1 for each projection (the router, N = 64, and the
     shared experts among them) and the head, nothing plain; the decode
     step eager and graphed bitwise; kernels-vs-plain logits gated on
     the tokens whose routed expert sets agree at every layer (a bf16
     ulp in a router logit flips a route), at depth 1 and 2 in bf16
     (SHALLOW_LIMIT) and at MOE_F32_LAYERS layers in float32
     (F32_LIMIT), the share that agree printed; one dropped K row in the
     plain products must fail the float32 gate;
     4k. the same for llama4-maverick-400b-a17b at its widths (d 5120, 40
     heads over 8, expert and shared d_ff 8192, vocab 202048, top-1)
     cut to MAVERICK_LAYERS layers of MAVERICK_EXPERTS routed experts
     (its 128 experts are 64.4 GB of float32 a layer);
     4l. mamba2-2.7b at full width and depth (64 SSD layers, 10.8 GB of
     float32 quantized leaf by leaf at k_x = 6), bf16, fixed lanes, 4
     slots, prefill chunk SSM_CHUNK, 16 new tokens: six 256-token
     prompts (chunked) and a 100-token one (injected) in one session, a
     128-token one in a ``prefill="whole"`` session; gates: K1, K1t (the
     tied head), K3, K4 and K12 launched, no plain version on the card,
     the admission modes of the SSD chunk rule, the decode step graphed
     and bitwise its eager step, kernels-vs-plain logits at depth 1 and
     2 in bf16 (SHALLOW_LIMIT) and at SSM_F32_LAYERS in float32
     (F32_LIMIT), one K row dropped from the plain in_proj failing the
     float32 gate; readings: the step eager and graphed, a chunk, tok/s,
     resident codes, the SSM state a slot, the start-up peak, the SSD
     recurrence's device ms; phase 3 also holds and times K1 at the
     family's in_proj/out_proj shapes (int8, 3/4/6-bit lanes) and K1t
     over its two tied heads;
     4m. the same for hymba-1.5b at 32 layers, paged (K2 too), with a
     HYMBA_LONG_PROMPT-token prompt past the local layers' 1024 window:
     one decode step there changes its logits without the window and
     without the meta prefix;
     4n. whisper-small at full width and depth (12 encoder and 12
     decoder layers, tied head of 51865 rows), bf16, quantize_params(
     k_x=6) leaf by leaf, through the model API (no session serves the
     family, in either package): ``prefill_encoder`` over
     ``batch_for_model``'s audio (4, 1500, 768), a 64-token prompt a
     slot through ``decode_step`` a token at a time, 16 greedy tokens,
     then a paged run of 8 steps; gates: K1, K1t, K2, K3, K4 and K12
     launched, no plain version on the card, no host sync after the
     first step, the paged logits those of the fixed lanes, kernels-vs-
     plain logits at depth 1 and 2 in bf16 (SHALLOW_LIMIT) and of the
     encoder prefill and a step at full depth in float32 (F32_LIMIT),
     one K row dropped from the plain ``xattn.k`` failing the float32
     gate, the decode step eager and as one captured CUDA graph bitwise;
     readings: the encoder prefill's device ms, the step eager and
     graphed, tok/s, resident codes, the cross cache a slot, the
     start-up peak; phase 3 also holds and times K1 at whisper's
     projections (M = 4, 1500, 6000), K1t over its head (M = 1, 4) and
     #17 bidirectional at its encoder's (4, 1500, 1500, 12/12, 64);
  5. train full-width yi-6b cut to 8 layers (fp32 parameters and state,
     bf16 activations) with Algorithm 1 through ``qadam`` and
     ``TrainSession.from_optimizer``: 12 steps of 2 x 1024 tokens; gates:
     finite losses, the mean of the last 3 below the first, K3, K4, K11,
     K12, K15 and K16 launched, no plain version on the card, no host
     sync in steps 2-12 beyond the one loss harvest; then, on the
     trained state, every leaf's Q_x forward copy and one update on
     captured gradients through the kernels and through the plain
     versions, bitwise equal in the forward copy, m, v, e and the new
     parameters; print the
     step's wall and device time, its time by kernel, tokens/s and peak
     memory;
     5b. the Algorithm 1 baselines on the same cut and batches, 8 steps
     each through ``TrainSession.from_optimizer``: ``ef_sgdm(alpha=1e-3,
     beta=0.9, grad_q="blockwise:256")`` (#14) and
     ``terngrad_sgd(alpha=1e-3)`` (K3, #13, the threefry keys and
     uniforms), with the phase-5 gates and a captured-gradient update
     bitwise through the kernels and the plain versions (the same key),
     then ``wquan(k_x=7, absolute=False)`` of the trained parameters
     (K3, K4, K12, bitwise); then ``terngrad_sgd`` with
     ``scan_chunk=4`` (one capture, one replay) bitwise the step-by-step
     session under deterministic algorithms (losses and every state
     tensor), the threefry kernels launched and no plain version on the
     card, its graphed step timed with the draws' share and its peak
     (yi-6b cut to CUT_LAYERS layers, as phase 7);
     5c. the phase-5 session with ``scan_chunk=4``: the first chunk
     eager, the next captured as one CUDA graph and replayed, 12 steps
     (3 dispatches, 1 capture, 2 replays), against the same session step
     by step, both under deterministic algorithms: losses and parameters
     bitwise (else within the trajectory tier, the difference printed);
     the training kernels launched, no plain version on the card; the
     step's wall and device time, idle share and peak memory beside
     phase 5's;
  6. train the same cut of yi-6b with Algorithms 2+3 through
     ``launch.train``'s path, in process: ``make_process_group`` (one
     NCCL rank), ``make_train_step(model, group, TrainConfig(alpha=1e-3,
     beta=0.99, theta=0.999, grad_k=6, weight_k=7, weight_absolute=True,
     mode="qadam"))``, ``TrainSession.from_artifacts``, 12 steps of the
     same batches; gates: the phase-5 gates with K7 and K6 (each kind)
     and K15 launched, the bytes the collectives move equal to
     ``comm_bytes_per_step``, one update on captured gradients bitwise
     through the kernels, the plain versions and Algorithm 1's
     ``qadam.update``, and Algorithms 2+3 at one worker against
     Algorithm 1 (the slice-2 session) from the same initialization,
     under torch's deterministic algorithms: bitwise losses and
     parameters, else within the reference's drift with the
     nondeterministic operations named; print wall and device time, the
     device time by phase (broadcast, forward+backward,
     update+exchange, master update), the wire kernels' time, peak
     memory and state bytes;
  7. the baselines the same way, each through ``launch.train``'s path on
     the same rank and batches, yi-6b cut to CUT_LAYERS layers (cut
     from 8 for the perf phase's time), 8 steps (MODE_RUNS): ``dp_adam``
     (fp32 both channels; K15), ``efadam`` (grad_k=6, weight_k=7, amax
     weights; K15, K3, K7 and K6), ``terngrad`` and ``ef_sgd`` (fp32
     broadcast, alpha 1e-3; #5 ternary with K3 and K6 ternary, #14 and
     #9 for ef_sgd's exchange rows), with
     the gates of phase 6 (the captured-gradient update through the
     kernels and the plain versions, TernGrad on the same uniforms), and
     ``terngrad`` with ``scan_chunk=4`` as in 5b (each step's t from the
     session's device step table); then
     ``dp_adam`` bitwise ``qadam`` with both channels in float32 and
     ``efadam`` with a float32 broadcast bitwise ``qadam``, under
     deterministic algorithms;
     6b. on the same rank, yi-6b at full width cut to CKPT_LAYERS = 1
     layer (an 11.2 GB state), 8 steps under deterministic algorithms: 4 steps, a checkpoint (pinned
     host copy on a side stream, the writer thread), 4 more; a new
     session resumed from the checkpoint (leaf by leaf into its own
     state's tensors, no device bytes added) for 4 more, bitwise the
     first run's losses and state; a checkpoint with ``ckpt_codec=
     "uniform_amax:7"`` (#5 with K3's amax, then K6 on restore, at most
     one leaf beside the state): masters and count exact, m, v and e
     bitwise the plain versions' codec round trip; then ``scan_chunk=4``
     with the step's collectives in the graph, bitwise the first run;
     bytes written, seconds to save and restore and the device bytes a
     restore adds, in a temp dir deleted at the end;
     6c. llava-next-mistral-7b's decoder at full width cut to 4 layers on
     embedding input (``batch_for_model``'s stub of the vision tower),
     through ``launch.train``'s path on the same rank, 4 steps: finite
     losses, K15, K7 and K6 launched, no plain version, no steady host
     sync, the bytes moved equal to ``comm_bytes_per_step`` and a
     captured-gradient update bitwise through the kernels and the plain
     versions (the losses are printed, not gated to fall: random
     embeddings say nothing of the targets, and the reference's
     trajectory on this stub is flat over its first steps too);
     6d. the adaptive mode (``repro_torch.adapt``) on the same rank,
     yi-6b cut to CUT_LAYERS layers (cut from 8): a fixed plan with
     every lane of WIDTH_SPECS on two leaves, 3 steps through the kernels bitwise the same steps through the plain
     versions (deterministic algorithms), every lane's kernels launched,
     its byte accounting exact against payloads encoded on the card
     (#5, #14, #9); ``bit_plan=None`` bitwise the qadam mode; then the
     launcher's ``--adaptive`` path, ``AdaptiveController`` with every
     count at 0 just before it: 12 steps, a replan every 4, scan_chunk 4
     (a CUDA graph a window, the new plan captured after each swap),
     budget 0.6: a replan at least, each swap leaving the state's
     tensors and bits as they were, one host sync a window, no plain
     version, every kernel of the plans' lanes launched, every plan's
     accounting exact; printed: each plan's exchange bytes a step
     against log:6's 954,238,976, its step wall and device ms and wire
     kernels with the plan installed again (its capture: what a
     revisited plan costs), capture seconds, peak bytes;
     6e. the hierarchical topology and the model axis on the same rank,
     yi-6b at full width cut to 2 layers, through
     ``repro_torch.launch.train``'s ``main`` under deterministic
     algorithms: the flat run and ``--topology 1x1`` (the tiered path on
     a (pod=1, data=1, model=1) grid, every count at 0 just before it),
     3 steps each: losses, master, m, v and e bitwise, K15, K7 and K6
     launched, no plain version; the per-tier bytes (inter equal to the
     flat wire's total, intra the float32 gradient gather and the
     broadcast's fan-out); ``quantized_gather_shard`` (the int8 gather,
     K3, K4, K12) on the 2-layer w_gate stack at one shard bitwise its
     plain version, its launches and ms; then ``--data 1 --model 1
     --model-gather-quant 8`` 2 steps; each run's step device ms beside
     phase 6's; no garbage collection in 6d's end or 6e: 6d's session,
     closed and dropped, must leave no more than CLOSE_SLACK bytes
     allocated beyond the level before 6d;
     6f. deepseek-moe-16b at full width cut to MOE_TRAIN_LAYERS layers
     (about 1.6 B parameters), Algorithms 2+3 ``qadam`` on the same rank
     through phase 6's gates, MOE_TRAIN_STEPS steps of 2 x 1024 tokens
     (capacity 240); one forward/backward each with the einsum and the
     sort dispatch from the same weights: float32 losses within the
     reference's rtol 1e-5, both times (bf16 and float32); the aux
     loss's share of the loss; a ``--model 1`` step through the
     launcher, where no token exchange runs;
     6g. mamba2-2.7b cut to 8 layers and hymba-1.5b cut to 4, widths
     unchanged, through phase 6f's gates (SSM_TRAIN_STEPS steps each);
     the SSD scan's device ms alone at the forward's shapes beside the
     step's phases; ``launch.train`` at mamba2 x 2 layers flat and with
     ``--model 1`` and ``cp_exchange="ladder"``, bitwise equal;
     6h. whisper-small at full width and depth through phase 6f's gates,
     ENCDEC_TRAIN_STEPS steps of 2 x 448 tokens and 2 x 1500 frames;
     ``launch.train`` flat and with ``--data 1 --model 1``, 2 steps each,
     bitwise equal;
     6i. (after the NCCL rank closes) ``launch.train`` with the
     reference's multi-host flags, ``--multihost --coordinator
     127.0.0.1:<free port> --num-processes 1 --process-id 0`` (its own
     NCCL group over a TCP rendezvous), one step of yi-6b x 2 layers
     bitwise the flat one-rank run (losses and state);
     4o. (on the same NCCL rank, after 6h) sharded serving
     (``dist.serve.make_serve_step`` over ``make_grid(data=1,
     model=1)``, ``ServeConfig(weight_k=8)``): gemma2-2b at full width
     and depth, its float32 tree the rank's one model shard (at one
     shard the layout replicates every leaf but the MoE expert stacks,
     so its step gathers nothing); 6 decode steps bitwise the local
     ``decode_step`` on the round-tripped tree, the
     paged mesh decode (a scrambled table) bitwise the fixed-lane one,
     a ``ServeSession(decode_fn=step)`` draining 4 requests with the
     tokens of a batch-synchronous loop over the step and its decode
     step one CUDA graph, kind "prefill" bitwise ``Model.prefill``;
     hymba-1.5b, whisper-small (``prefill_encoder`` under the step's
     context) and deepseek-moe-16b (its expert stacks through the int8
     gather's Q_x round trip: K3, K4, K12) at full width cut to 2
     layers, bitwise; K2, K3, K4, K12
     launched, no plain version on the card; the step eager and graphed
     (bitwise), its wall and device ms, the gather kernels' share, the
     start-up peak;
  8. every leaf of the cut's initial parameters through
     ``Codec.encode`` -> ``WireBuffer.decode`` for log:6, the uniform:7
     wire (absolute and amax), TernGrad and blockwise:256: #5 (each
     kind), #8 and K6 launched, no plain version on the card, buffer
     bytes ``codec.wire_nbytes``, bitwise the plain versions;
  9. the paper's comparison protocol, ``examples/paper_repro_torch.py``
     (8 workers, PAPER_STEPS steps, one seed), in its default mode and
     in ``--mode efadam``: every accuracy finite, #13 and #14 (and in
     efadam mode #10) launched, no plain version on the card; print the
     accuracy table; then ``--adaptive`` (the fixed log:6 arm against
     the adaptive arm, PAPER_ADAPT_STEPS steps, a replan every
     PAPER_ADAPT_EVERY) and the fixed arm on log:30 and log:126
     (PAPER_DEEP_STEPS steps each,
     #10 and K11 at the deep grids launched);
  perf. the performance tooling (``repro_torch.perf``): (a) the tuners:
     ``tune_mm_cols`` at yi-6b's (4, 4096, 11008) and hymba-1.5b's (4,
     1600, 6482) int8 projections (every candidate plan's ms, the
     winner, the installed plan held in K1's tier against the plain
     version), ``tune_enc_rows`` on a log:6 round trip and K7, #5 and K6
     bitwise at every blocks-an-SM value against the default's; (b) a
     ``perf.trace`` of a few graphed decode steps of yi-6b cut to 2
     layers, the Chrome trace holding the ``annotate`` names and K1's
     kernel; (c) the warm start: ``launch.serve`` (smoke widths) in a
     subprocess with a fresh ``--aot-dir`` and the library from the
     build cache (``aot_saves`` 1), then with ``--no-compile-cache`` and
     nvcc out of reach (off PATH, CUDA_HOME an empty directory):
     ``aot_loads`` 1, ``compilations`` 0, the same tokens, both start-up
     seconds; a touched copy of gather_pages.cu rebuilt in a scratch
     cache seeded with the build's objects: exactly one object compiled;
     (d) the exchange buckets on phase 6's cut (one NCCL rank):
     ``tune_exchange_buckets`` over PERF_BUCKETS, losses and state
     bitwise across sizes, the times and the overlap (each bucket's
     bytes and the backward's device ms left after it launched, from
     CUDA events on the backward's stream); and a
     ``scan_chunk`` session (the step one CUDA graph) bitwise between 0
     and 1 MiB buckets; (e) the three examples
     (``examples/*_torch.py``) as subprocesses on the card at small
     sizes, each exiting 0;
  10. print one ``{"kernels": [...]}`` line (each kernel's launches by
     path; every kernel launched on some path), the card line again, and
     the last line ``{"ok": true,
     "device": {...}}``.

Each phase prints its seconds, and the total at the end. It imports
nothing of JAX or of the JAX package. Detailed tables are also written
to ``results/chip_smoke.json``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

# cuBLAS is deterministic only with a fixed workspace (phase 6 runs two
# trainings under torch.use_deterministic_algorithms); set before CUDA
# starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

HERE = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
BF16_FLOPS = 989e12              # dense bf16 tensor-core peak
YI = dict(L=32, d=4096, H=32, K=4, hd=128, f=11008, V=64000)
GEMMA = dict(d=2304, V=256000)   # gemma2-2b's tied (vocab, d_model) table
GEMMA3_HEAD = (262144, 2560)     # gemma3-4b's tied (vocab, d_model) table
# gemma3-4b's serving cell: a prompt past its 1024 window, in slots of
# GEMMA3_MAX_SEQ positions (a multiple of 16 above it and 16 new tokens)
GEMMA3_LONG_PROMPT, GEMMA3_MAX_SEQ = 1100, 1120
# the gemma2-2b serving cell's one long request: a prompt past the window,
# in a session whose slots hold max_seq positions (a multiple of 16 above
# the prompt and its 16 new tokens)
GEMMA_LONG_PROMPT, GEMMA_MAX_SEQ = 4200, 4224
# decode-logits limits, kernels vs plain versions (rel L2), set from the
# readings in PERF.md: the bf16 step cut to 1 and 2 layers, and the
# full-depth step in float32 activations
SHALLOW_LIMIT = 1e-2
F32_LIMIT = 5e-5
# the training cell: yi-6b's widths, depth cut to 8 layers so that the
# fp32 parameters, m, v, e, the Q_x forward copy and the gradients
# (24 B per parameter) fit one 80 GB card
TRAIN_LAYERS, TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 8, 1024, 2, 12
# phases 7 and 6d: the same widths cut to 2 layers (from 8), for the perf
# phase's seconds
CUT_LAYERS = 2
TRAIN_OPT = dict(alpha=1e-3, grad_q="log:6", weight_q="uniform_amax:7",
                 weight_q_min_numel=2 ** 14)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bound_ms(nbytes: float, flops: float = 0.0):
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn(i)`` over ``iters`` calls (CUDA events)."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def print_ptxas(log: str) -> None:
    """One line per kernel instance from nvcc's ``-Xptxas -v`` output:
    registers, and spill bytes where there are any."""
    name, spill = "", ""
    for line in log.splitlines():
        if "Function properties for " in line:
            name = line.split("Function properties for ")[-1].strip()
        elif "bytes spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            spill = (f", {nums[1]} B spill stores, {nums[2]} B spill loads"
                     if nums[1] or nums[2] else "")
        elif "Used " in line and " registers" in line and name:
            regs = line.split("Used ")[1].split(" registers")[0]
            at = name.find("_kernel")   # mangled: template args follow
            print(f"  ptxas: {regs:>3} registers{spill}  "
                  f"{name[max(0, at - 16):at + 44]}")
            name = ""


def graph_ms(torch, fn, variants: int = 1, replays: int = 20) -> float:
    """Device time of one ``fn(i)`` with the host out of the way: the
    calls for i < variants are captured in a CUDA graph, which is then
    replayed (rotating variants keep the L2 cache from holding inputs)."""
    for i in range(variants):
        fn(i)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(variants):
            fn(i)
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    end.synchronize()
    del g
    return start.elapsed_time(end) / (replays * variants)


def profile_ms(torch, fn, steps: int = 3, with_launches: bool = False):
    """Device time per call of ``fn()`` by kernel, from torch.profiler:
    (total device ms, [(kernel name, device ms)] largest first), and with
    ``with_launches`` the device operations (kernels, copies, fills) a
    call runs, counted from the same trace."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    rows, n_ops = [], 0
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0)
        if t and getattr(e, "device_type", None) is not None and \
                "CUDA" in str(e.device_type):
            rows.append((e.key, t / steps / 1e3))
            n_ops += e.count
    rows.sort(key=lambda r: -r[1])
    if with_launches:
        return sum(t for _, t in rows), rows, n_ops / steps
    return sum(t for _, t in rows), rows


def bf16_ulp(torch, x):
    a = x.abs().to(torch.float32).clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


# K1's floor below one bf16 ulp, in units of sqrt(K) 2^-24 |x*w|_2: set
# from the fp32 summation-order noise measured between the kernel and
# the plain product (PERF.md, K1 parity).
K1_FLOOR = 8.0


def k1_noise_unit(torch, MM, x, codes, scale, kw):
    """sqrt(K) 2^-24 |x*w|_2 per output, |x*w|_2 the L2 norm of the K
    products summed into it: the scale of fp32 summation-order noise."""
    w = MM.dequant_codes(codes, scale, k_x=kw["k_x"], n=kw["n"],
                         pack_bits=kw["pack_bits"], w_dtype="float32",
                         cast_dtype=kw["cast_dtype"]).float()
    t = (x.float() ** 2 @ w ** 2).sqrt()
    return x.shape[-1] ** 0.5 * 2.0 ** -24 * t


def k1_tolerance(torch, ulp_of, unit):
    """One bf16 ulp of the plain product, plus a floor for outputs that
    cancel to near zero, where a bf16 ulp is finer than the fp32
    summation-order noise of two orders of the same K products."""
    return bf16_ulp(torch, ulp_of.float()) + K1_FLOOR * unit


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_quantize(torch, K, dev):
    L, d, f = YI["L"], YI["d"], YI["f"]
    g = torch.Generator(device=dev).manual_seed(11)
    x = torch.empty((L, d * f), dtype=torch.float32, device=dev)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=g)
    x.mul_(0.02)
    a_k = K.amax_rows(x, backend="cuda")
    a_p = K.amax_rows(x, backend="torch")
    if not torch.equal(a_k, a_p):
        raise AssertionError("K3 amax differs from its plain version")
    s = torch.clamp_min(a_k, 1e-30)
    c_k = K.uniform_quantize_rows(x, s, 6, backend="cuda")
    c_p = K.uniform_quantize_rows(x, s, 6, backend="torch")
    if not torch.equal(c_k, c_p):
        raise AssertionError("K4 uniform quantize differs from its plain "
                             "version")
    del c_p
    # qwen2.5-14b's stacked QKV bias at init: every layer zero but one, so
    # K3 gives amax 0, the scale its 1e-30 floor and K4 codes 0 (no NaN),
    # bitwise the plain versions
    zb = torch.zeros((48, 5120), dtype=torch.float32, device=dev)
    zb[1].normal_(generator=g)
    za = torch.clamp_min(K.amax_rows(zb, backend="cuda"), 1e-30)
    zc = K.uniform_quantize_rows(zb, za, 6, backend="cuda")
    zp = K.uniform_quantize_rows(zb, torch.clamp_min(
        K.amax_rows(zb, backend="torch"), 1e-30), 6, backend="torch")
    if not (torch.equal(zc, zp) and float(za[0]) == float(
            torch.tensor(1e-30, dtype=torch.float32)) and not zc[0].any()
            and zc[1].any()):
        raise AssertionError("K3/K4 on an all-zero layer: scale "
                             f"{float(za[0])}, codes differ from the plain "
                             "versions or are not 0")
    xb = x.numel() * 4
    rows = []
    t_k = cuda_ms(torch, lambda i: K.amax_rows(x, backend="cuda"), 5, 1)
    t_p = cuda_ms(torch, lambda i: K.amax_rows(x, backend="torch"), 5, 1)
    t_l = cuda_ms(torch, lambda i: x.abs().amax(-1), 5, 1)
    b, by = bound_ms(xb + 4 * L)
    rows.append(dict(name="amax_rows", route="cuda",
                     source="src/repro_torch/csrc/quantize.cu",
                     replaces="src/repro/comm/kernels.py:482",
                     max_abs_err=float((a_k - a_p).abs().max()), ms=t_k,
                     plain_ms=t_p, bound_ms=b, bound_by=by, library_ms=t_l,
                     shape=[L, d * f]))
    t_k = cuda_ms(torch, lambda i: K.uniform_quantize_rows(
        x, s, 6, backend="cuda"), 5, 1)
    t_p = cuda_ms(torch, lambda i: K.uniform_quantize_rows(
        x, s, 6, backend="torch"), 5, 1)
    b, by = bound_ms(xb + 4 * L + x.numel())
    rows.append(dict(name="uniform_quantize_rows", route="cuda",
                     source="src/repro_torch/csrc/quantize.cu",
                     replaces="src/repro/comm/kernels.py:545",
                     max_abs_err=0.0, ms=t_k, plain_ms=t_p, bound_ms=b,
                     bound_by=by, library_ms=None, shape=[L, d * f]))
    return rows


# K2's tables: the serving cell's (yi-6b: 4 slots x 8 pages of 16 tokens x
# 4 heads x 128 dims, bf16, 16 KB a page) and gemma2-2b's 4224-position
# slots (4 x 264 pages of 16 x 4 x 256, 32 KB a page; 34.6 MB a pool)
GATHER_TABLES = {"yi": dict(slots=4, npag=8, hd=128),
                 "gemma2": dict(slots=4, npag=264, hd=256)}
GATHER_CALLS = 8


def check_gather(torch, paged, dev):
    """K2 through both entry points at both tables, bitwise the plain
    gathers (sentinel ids past the pool clamp inside the kernel), timed in
    CUDA graphs of GATHER_CALLS calls: one pool against ``index_select``
    (one call computes the same function), a layer's K and V in one
    launch against two ``index_select`` calls. Returns the two
    kernels-line rows and the timing table."""
    table, rows = [], {}
    for name, t in GATHER_TABLES.items():
        slots, npag, hd = t["slots"], t["npag"], t["hd"]
        num_pages = slots * npag + 8
        g = torch.Generator(device=dev).manual_seed(12 + npag)
        pk, pv = (torch.randn((num_pages, 16, YI["K"], hd), generator=g,
                              device=dev).to(torch.bfloat16) for _ in "kv")
        perm = torch.randperm(num_pages, generator=g, device=dev)
        tab = perm[:slots * npag].reshape(slots, npag).to(torch.int32)
        tab[1, npag // 2:] = num_pages          # RELEASED sentinel tail
        tab[3, :] = num_pages                   # a released slot
        n0, kv0 = paged.launches, paged.launches_kv
        a = paged.gather_pages(pk, tab, backend="cuda")
        ka, va = paged.gather_pages_kv(pk, pv, tab, backend="cuda")
        if (paged.launches, paged.launches_kv) != (n0 + 2, kv0 + 1):
            raise AssertionError(f"K2 at the {name} table: "
                                 f"{paged.launches - n0} launches for two "
                                 f"calls")
        kb = paged.gather_pages(pk, tab, backend="torch")
        vb = paged.gather_pages(pv, tab, backend="torch")
        if not (torch.equal(a, kb) and torch.equal(ka, kb)
                and torch.equal(va, vb)):
            raise AssertionError(f"K2 differs from its plain version at the "
                                 f"{name} table")
        del kb, vb, ka, va
        flat = torch.clamp(tab, 0, num_pages - 1).reshape(-1).long()
        view = a.numel() * a.element_size()
        del a
        # GATHER_CALLS calls a graph: a call at the small table takes about
        # as long as the host's replay of a one-call graph
        one = dict(
            ms=graph_ms(torch, lambda i: paged.gather_pages(
                pk, tab, backend="cuda"), GATHER_CALLS),
            plain_ms=graph_ms(torch, lambda i: paged.gather_pages(
                pk, tab, backend="torch"), GATHER_CALLS),
            library_ms=graph_ms(torch, lambda i: torch.index_select(
                pk, 0, flat), GATHER_CALLS),
            eager_ms=cuda_ms(torch, lambda i: paged.gather_pages(
                pk, tab, backend="cuda")))
        one["bound_ms"], one["bound_by"] = bound_ms(2 * view + tab.numel() * 4)
        kv = dict(
            ms=graph_ms(torch, lambda i: paged.gather_pages_kv(
                pk, pv, tab, backend="cuda"), GATHER_CALLS),
            plain_ms=graph_ms(torch, lambda i: paged.gather_pages_kv(
                pk, pv, tab, backend="torch"), GATHER_CALLS),
            two_index_select_ms=graph_ms(torch, lambda i: (
                torch.index_select(pk, 0, flat),
                torch.index_select(pv, 0, flat)), GATHER_CALLS),
            eager_ms=cuda_ms(torch, lambda i: paged.gather_pages_kv(
                pk, pv, tab, backend="cuda")))
        kv["bound_ms"], kv["bound_by"] = bound_ms(4 * view + tab.numel() * 4)
        for entry, r in (("gather_pages", one), ("gather_pages_kv", kv)):
            r.update(name=entry, table=name, shape=[slots, npag, 16,
                                                    YI["K"], hd],
                     share_of_bound=r["bound_ms"] / r["ms"])
            table.append(r)
        rows[name] = (one, kv)
        del pk, pv
        torch.cuda.empty_cache()
    base = dict(route="cuda", source="src/repro_torch/csrc/gather_pages.cu",
                replaces="src/repro/serve/paged.py:74", max_abs_err=0.0)
    one, kv = rows["yi"][0], rows["gemma2"][1]
    # the one-pool entry point at the serving cell's table; the K+V entry
    # point at gemma2's (no one PyTorch call gathers two pools)
    out = [dict(base, name="gather_pages", ms=one["ms"],
                plain_ms=one["plain_ms"], bound_ms=one["bound_ms"],
                bound_by=one["bound_by"], library_ms=one["library_ms"],
                shape=one["shape"]),
           dict(base, name="gather_pages_kv", ms=kv["ms"],
                plain_ms=kv["plain_ms"], bound_ms=kv["bound_ms"],
                bound_by=kv["bound_by"], library_ms=None, shape=kv["shape"],
                two_index_select_ms=kv["two_index_select_ms"])]
    return out, table


# the code kinds of phase 3: (k_x, packed lane bits or 0)
CODE_KINDS = {"int8": (6, 0), "int16": (7, 0), "p2": (0, 2), "p3": (1, 3),
              "p4": (2, 4), "p6": (4, 6)}
PACKED_KINDS = ("p2", "p3", "p4", "p6")


def _codes(torch, B, g, dev, kind, Kd, N):
    """Random codes of one kind: (k_x, pack_bits, codes)."""
    k_x, bits = CODE_KINDS[kind]
    lim = 2 ** k_x
    c = torch.randint(-lim, lim + 1, (Kd, N), generator=g, device=dev,
                      dtype=torch.int32)
    if kind == "int8":
        return k_x, 0, c.to(torch.int8)
    if kind == "int16":
        return k_x, 0, c.to(torch.int16)
    return k_x, bits, B.pack_rows(c, bits)


# K1's main-path shapes (K, N): yi-6b's wq/wo, wk/wv, w_gate/w_up, w_down,
# head; gemma2-2b's wq, wk/wv, w_gate/w_up, w_down, wo
GEMMA_K1_SHAPES = [(2304, 2048), (2304, 1024), (2304, 9216), (9216, 2304),
                   (2048, 2304)]


def k1_shapes():
    d, f, V, hK = YI["d"], YI["f"], YI["V"], YI["K"] * YI["hd"]
    return [(d, d), (d, hK), (d, f), (f, d), (d, V)] + GEMMA_K1_SHAPES


# the serving slice of gemma3-4b and qwen2.5-14b (K, N), held and timed at
# int8, the code type their k_x = 6 weights take: gemma3's wq (q is 2048
# wide), wk/wv, wo, w_gate/w_up, w_down; qwen's wq/wo, wk/wv, w_gate/w_up,
# w_down and its untied head
NEW_K1_SHAPES = [(2560, 2048), (2560, 1024), (2048, 2560), (2560, 10240),
                 (10240, 2560), (5120, 5120), (5120, 1024), (5120, 13824),
                 (13824, 5120), (5120, 152064)]


# the CUDA-core route's timed shapes (K, N): yi-6b's w_gate, gemma2-2b's
# wq, wk/wv and w_down
FMA_TIMED_SHAPES = [(YI["d"], YI["f"]), (2304, 2048), (2304, 1024),
                    (9216, 2304)]


def check_matmul(torch, MM, B, dev):
    """K1 at every (M, K, N, code type) of the serving paths (yi-6b's and
    gemma2-2b's projections at M in {1, 4, 32}, and ragged shapes across
    the tensor-core route's row tiles, rows of packed lanes of no whole 16
    bytes among them), on tensor cores (bf16 activations, int8, int16 and
    2/3/4/6-bit lanes) held to the tier, and the same sums in float32 on
    CUDA cores at M = 4 and 32 (one CUDA-core launch a call); a dropped
    K row must fail the bf16 tier at M = 4 and the float32 tier at M = 32
    (int8 and 4-bit lanes); the timing table at int8 with each shape's
    kernel/library factor, every lane width at (4096, 11008), M = 4 and
    32, and the CUDA-core route at float32 activations against int8 codes
    at M = 4 and 32 over FMA_TIMED_SHAPES, with its fp32 FMA floor on CUDA
    cores. Returns the three kernels-line rows, the case table, the
    timings and the noise readings."""
    g = torch.Generator(device=dev).manual_seed(13)
    d, f = YI["d"], YI["f"]
    shapes = k1_shapes()
    kinds = ("int8", "int16") + PACKED_KINDS
    cases = [(M, Kd, N, kind) for M in (1, 4, 32) for (Kd, N) in shapes
             for kind in kinds]
    cases += [(M, 1000, 1001, kind) for M in (5, 16, 17, 33, 64, 100)
              for kind in kinds]   # ragged, across the row tiles
    cases += [(M, Kd, N, "int8") for M in (1, 4, 32)
              for (Kd, N) in NEW_K1_SHAPES]
    table, worst, noise = [], {"tc": 0.0, "tc_packed": 0.0, "fma": 0.0}, {}
    scale = torch.tensor(0.0371, device=dev)
    for M, Kd, N, kind in cases:
        k_x, pb, codes = _codes(torch, B, g, dev, kind, Kd, N)
        x = (torch.randn((M, Kd), generator=g, device=dev)).to(torch.bfloat16)
        kw = dict(k_x=k_x, n=N, pack_bits=pb, cast_dtype="bfloat16")
        route = MM.route(x.dtype, codes.dtype, pb, "float32", "bfloat16")
        a = MM.dequant_matmul(x, codes, scale, backend="cuda", **kw)
        b = MM.dequant_matmul(x, codes, scale, backend="torch", **kw)
        diff = (a.float() - b.float()).abs()
        unit = k1_noise_unit(torch, MM, x, codes, scale, kw)
        tol = k1_tolerance(torch, b, unit)
        if a.dtype != torch.bfloat16 or not bool((diff <= tol).all()):
            over = (diff - bf16_ulp(torch, b.float())) / unit
            raise AssertionError(f"K1 ({route}) at M={M} K={Kd} N={N} "
                                 f"{kind}: beyond one bf16 ulp of the plain "
                                 f"product + floor (max abs "
                                 f"{float(diff.max())}, "
                                 f"{float(over.max())} floor units)")
        if route != "tc":
            raise AssertionError(f"K1 on bf16 activations, {kind} codes, "
                                 f"took the {route} route")
        err = float(diff.max())
        key = "tc_packed" if pb else "tc"
        worst[key] = max(worst[key], err)
        # beyond one ulp, in floor units (the floor is K1_FLOOR of them)
        over = float(((diff - bf16_ulp(torch, b.float())).clamp_min(0)
                      / unit).max())
        n = noise.setdefault(Kd, dict(K=Kd, max_abs_err=0.0, bf16_over_ulp=0.0,
                                      f32_noise=0.0))
        n["max_abs_err"] = max(n["max_abs_err"], err)
        n["bf16_over_ulp"] = max(n["bf16_over_ulp"], over)
        table.append(dict(M=M, K=Kd, N=N, codes=kind, route=route,
                          max_abs_err=err, over_ulp_units=over))
        if M in (4, 32) or (Kd == 1000 and M == 5):
            # the same sums in fp32 activations (the CUDA-core route): the
            # summation-order noise itself, in the same units
            xf = x.float()
            kf = dict(kw, cast_dtype=None)
            n_fma = MM.launches_fma
            b32 = MM.dequant_matmul(xf, codes, scale, backend="torch", **kf)
            d32 = (MM.dequant_matmul(xf, codes, scale, backend="cuda", **kf)
                   - b32).abs()
            if MM.launches_fma != n_fma + 1:
                raise AssertionError(f"K1 on float32 activations at M={M} "
                                     f"K={Kd} N={N} {kind}: "
                                     f"{MM.launches_fma - n_fma} CUDA-core "
                                     f"launches for one call")
            unit32 = k1_noise_unit(torch, MM, xf, codes, scale, kf)
            n["f32_noise"] = max(n["f32_noise"], float((d32 / unit32).max()))
            worst["fma"] = max(worst["fma"], float(d32.max()))
            # the CUDA-core route's gate: float32 outputs within the floor
            # (two fp32 orders of the same products)
            if not bool((d32 <= K1_FLOOR * unit32).all()):
                raise AssertionError(f"K1 (fma) at M={M} K={Kd} N={N} "
                                     f"{kind}, float32: beyond {K1_FLOOR:g} "
                                     f"units of fp32 summation noise")
            if M == 32 and kind in ("int8", "p4") and Kd != 1000:
                # the float32 gate's upper reading: one K row dropped
                w32 = MM.dequant_codes(codes, scale, k_x=k_x, n=N,
                                       pack_bits=pb, w_dtype="float32",
                                       cast_dtype=None)
                fd = ((xf[:, :-1] @ w32[:-1]) - b32).abs()
                seen = float((fd > K1_FLOOR * unit32).float().mean())
                if seen == 0.0:
                    raise AssertionError(f"K1 float32 gate blind to a "
                                         f"dropped K row at M=32 K={Kd} "
                                         f"N={N} {kind}")
                n["f32_fault_caught"] = min(n.get("f32_fault_caught", 1.0),
                                            seen)
            if M == 4 and kind in ("int8", "p4") and Kd != 1000:
                # the upper reading: one K row dropped from the plain sum
                w = MM.dequant_codes(codes, scale, k_x=k_x, n=N, pack_bits=pb,
                                     w_dtype="float32", cast_dtype="bfloat16")
                bad = (x[:, :-1].float() @ w[:-1].float()).to(torch.bfloat16)
                fd = (bad.float() - b.float()).abs()
                seen = float((fd > tol).float().mean())
                if seen == 0.0:
                    raise AssertionError(f"K1 gate blind to a dropped K row "
                                         f"at K={Kd} N={N}")
                n["fault_max_abs"] = max(n.get("fault_max_abs", 0.0),
                                         float(fd.max()))
                n["fault_caught"] = min(n.get("fault_caught", 1.0), seen)
    # timing at the path's shapes, four weight copies in rotation so the
    # 50 MB L2 does not hold the codes between calls
    timed = []

    def time_case(M, Kd, N, kind, x_dtype=torch.bfloat16):
        """Kernel, plain and library times of one shape; the library is
        torch.matmul on the dequantized weight in the activations' type
        (bf16; float32 with TF32 off on the CUDA-core route)."""
        k_x, pb = CODE_KINDS[kind]
        cast = "bfloat16" if x_dtype == torch.bfloat16 else None
        ws = [_codes(torch, B, g, dev, kind, Kd, N)[2] for _ in range(4)]
        wf = [MM.dequant_codes(w, scale, k_x=k_x, n=N, pack_bits=pb,
                               w_dtype="float32",
                               cast_dtype=cast) for w in ws]
        x = torch.randn((M, Kd), generator=g, device=dev).to(x_dtype)
        kw = dict(k_x=k_x, n=N, pack_bits=pb, cast_dtype=cast)
        t_k = graph_ms(torch, lambda i: MM.dequant_matmul(
            x, ws[i], scale, backend="cuda", **kw), 4)
        t_p = graph_ms(torch, lambda i: MM.dequant_matmul(
            x, ws[i], scale, backend="torch", **kw), 4, 5)
        t_l = graph_ms(torch, lambda i: torch.matmul(x, wf[i]), 4)
        t_e = cuda_ms(torch, lambda i: MM.dequant_matmul(
            x, ws[i % 4], scale, backend="cuda", **kw))
        nbytes = ws[0].numel() * ws[0].element_size()
        xb = x.element_size()
        bnd, by = bound_ms(nbytes + xb * M * Kd + xb * M * N + 4,
                           2.0 * M * Kd * N)
        route = MM.route(x.dtype, ws[0].dtype, pb, "float32", cast)
        return dict(M=M, K=Kd, N=N, codes=kind, route=route,
                    x_dtype=str(x_dtype).split(".")[-1], ms=t_k,
                    plain_ms=t_p, library_ms=t_l, eager_ms=t_e, bound_ms=bnd,
                    bound_by=by, factor=t_k / t_l, share_of_bound=bnd / t_k,
                    gbs=nbytes / t_k / 1e6)

    for M in (4, 32, 1):
        for Kd, N in shapes + NEW_K1_SHAPES:
            timed.append(time_case(M, Kd, N, "int8"))
    for kind in PACKED_KINDS:   # every lane width on tensor cores
        for M in (4, 32):
            timed.append(time_case(M, d, f, kind))
    # the CUDA-core route where it serves: float32 activations, at the
    # decode step's and the chunk's M, yi-6b's w_gate and gemma2-2b's
    # projections, each beside the fp32 torch.matmul (TF32 off) and its
    # FMA floor on CUDA cores
    fma_timed = [time_case(M, Kd, N, "int8", torch.float32)
                 for M in (4, 32) for Kd, N in FMA_TIMED_SHAPES]
    for r in fma_timed:
        r["floor_fp32_cores_ms"] = 2.0 * r["M"] * r["K"] * r["N"] / \
            FP32_FLOPS * 1e3
        r["share_of_fp32_floor"] = max(r["floor_fp32_cores_ms"],
                                       r["bound_ms"]) / r["ms"]
    timed += fma_timed
    fma = fma_timed[0]
    fma32 = next(r for r in fma_timed if (r["M"], r["K"], r["N"]) ==
                 (32, d, f))
    slow_f = max(fma_timed, key=lambda r: r["factor"])
    tc_timed = [r for r in timed if r["route"] == "tc"
                and r["codes"] == "int8"]
    rep = next(r for r in tc_timed if (r["M"], r["K"], r["N"]) == (4, d, f))
    m32 = next(r for r in tc_timed if (r["M"], r["K"], r["N"]) == (32, d, f))
    slow = max(tc_timed, key=lambda r: r["factor"])
    packed = [r for r in timed if r["codes"] in PACKED_KINDS]
    if any(r["route"] != "tc" for r in packed):
        raise AssertionError("packed lanes timed off the tensor-core route")
    p4 = next(r for r in packed if r["codes"] == "p4" and r["M"] == 4)
    p4_32 = next(r for r in packed if r["codes"] == "p4" and r["M"] == 32)
    slow_p = max(packed, key=lambda r: r["factor"])
    row_tc = dict(name="dequant_matmul_tc", route="cuda",
                  source="src/repro_torch/csrc/dequant_matmul.cu",
                  replaces="src/repro/comm/matmul.py:166",
                  max_abs_err=worst["tc"], ms=rep["ms"],
                  plain_ms=rep["plain_ms"], bound_ms=rep["bound_ms"],
                  bound_by=rep["bound_by"], library_ms=rep["library_ms"],
                  shape=[4, d, f], m32_ms=m32["ms"],
                  m32_library_ms=m32["library_ms"],
                  worst_factor=slow["factor"],
                  worst_shape=[slow["M"], slow["K"], slow["N"]])
    row_tcp = dict(name="dequant_matmul_tc_packed", route="cuda",
                   source="src/repro_torch/csrc/dequant_matmul.cu",
                   replaces="src/repro/comm/matmul.py:166",
                   max_abs_err=worst["tc_packed"], ms=p4["ms"],
                   plain_ms=p4["plain_ms"], bound_ms=p4["bound_ms"],
                   bound_by=p4["bound_by"], library_ms=p4["library_ms"],
                   shape=[4, d, f, "p4"], m32_ms=p4_32["ms"],
                   m32_library_ms=p4_32["library_ms"],
                   worst_factor=slow_p["factor"],
                   worst_shape=[slow_p["M"], slow_p["K"], slow_p["N"],
                                slow_p["codes"]])
    row_fma = dict(name="dequant_matmul", route="cuda",
                   source="src/repro_torch/csrc/dequant_matmul.cu",
                   replaces="src/repro/comm/matmul.py:166",
                   max_abs_err=worst["fma"], ms=fma["ms"],
                   plain_ms=fma["plain_ms"], bound_ms=fma["bound_ms"],
                   bound_by=fma["bound_by"], library_ms=fma["library_ms"],
                   shape=[4, d, f, "int8", "float32"],
                   floor_fp32_cores_ms=fma["floor_fp32_cores_ms"],
                   m32_ms=fma32["ms"], m32_library_ms=fma32["library_ms"],
                   m32_floor_fp32_cores_ms=fma32["floor_fp32_cores_ms"],
                   worst_factor=slow_f["factor"],
                   worst_shape=[slow_f["M"], slow_f["K"], slow_f["N"]])
    return ([row_tc, row_tcp, row_fma], table, timed,
            sorted(noise.values(), key=lambda r: r["K"]))


def check_matmul_t(torch, MM, B, dev):
    """K1t (``x @ W.T`` from code rows, the tied head) at gemma2-2b's head
    shape (256000 rows of 2304 codes) and at ragged shapes: bf16
    activations on the tensor-core route for every code type (int8,
    int16, 2/3/4/6-bit rows) at M in {1, 4} (and past one n8 tile), within
    K1's tier, each call moving ``t_launches_tc``; a dropped d column must
    fail the gate; the same sums in float32 activations on the CUDA-core
    route (every case: each code type at the head and at the ragged V, d
    and M) within the floor, each call moving ``t_launches_fma``, where a
    dropped d column must fail too. Timed: int8, int16 and every lane
    width at M = 1 and 4 on tensor cores, with the kernel/library factor
    and the share of the bound, and the CUDA-core route at float32
    activations (int8 at M = 1, 4 and 8, 4-bit lanes at M = 4) beside the
    fp32 ``torch.matmul`` (TF32 off). Returns the two kernels-line rows,
    the case table and the timings."""
    g = torch.Generator(device=dev).manual_seed(17)
    d, V = GEMMA["d"], GEMMA["V"]
    kinds = ("int8", "int16") + PACKED_KINDS
    cases = [(M, V, d, "int8") for M in (1, 4)]
    cases += [(M,) + GEMMA3_HEAD + ("int8",) for M in (1, 4)]
    cases += [(4, V, d, kind) for kind in kinds[1:]]
    cases += [(M, 1001, n, kind) for M, n in ((5, d), (5, 37), (17, 1000))
              for kind in kinds]   # ragged V and d, M past one n8 tile
    scale = torch.tensor(0.0371, device=dev)
    table, worst = [], {"tc": 0.0, "fma": 0.0}
    for M, rows, n, kind in cases:
        k_x, pb, codes = _codes(torch, B, g, dev, kind, rows, n)
        x = torch.randn((M, n), generator=g, device=dev).to(torch.bfloat16)
        kw = dict(k_x=k_x, n=n, pack_bits=pb, cast_dtype="bfloat16",
                  transpose=True)
        route = MM.route(x.dtype, codes.dtype, pb, "float32", "bfloat16")
        n0 = (MM.t_launches_tc, MM.t_launches_fma)
        a = MM.dequant_matmul(x, codes, scale, backend="cuda", **kw)
        if route != "tc" or (MM.t_launches_tc, MM.t_launches_fma) != (
                n0[0] + 1, n0[1]):
            raise AssertionError(f"K1t on bf16 activations, {kind} rows, "
                                 f"took the {route} route")
        b = MM.dequant_matmul(x, codes, scale, backend="torch", **kw)
        w = MM.dequant_codes(codes, scale, k_x=k_x, n=n, pack_bits=pb,
                             w_dtype="float32",
                             cast_dtype="bfloat16").float()
        unit = n ** 0.5 * 2.0 ** -24 * (x.float() ** 2 @ (w ** 2).T).sqrt()
        tol = k1_tolerance(torch, b, unit)
        diff = (a.float() - b.float()).abs()
        if a.dtype != torch.bfloat16 or a.shape != (M, rows) or not bool(
                (diff <= tol).all()):
            raise AssertionError(f"K1t (tc) at M={M} V={rows} d={n} {kind}: "
                                 f"beyond one bf16 ulp of the plain product "
                                 f"+ floor (max abs {float(diff.max())})")
        over = float(((diff - bf16_ulp(torch, b.float())).clamp_min(0)
                      / unit).max())
        row = dict(M=M, V=rows, d=n, codes=kind, route=route,
                   max_abs_err=float(diff.max()), over_ulp_units=over)
        worst["tc"] = max(worst["tc"], row["max_abs_err"])
        # the same sums in fp32 activations (the CUDA-core route), held
        # within the floor: summation-order noise in the same units
        kf = dict(kw, cast_dtype=None)
        n0 = MM.t_launches_fma
        x32 = x.float()
        p32 = MM.dequant_matmul(x32, codes, scale, backend="torch", **kf)
        w32 = MM.dequant_codes(codes, scale, k_x=k_x, n=n, pack_bits=pb,
                               w_dtype="float32", cast_dtype=None)
        u32 = n ** 0.5 * 2.0 ** -24 * (x32 ** 2 @ (w32 ** 2).T).sqrt()
        d32 = (MM.dequant_matmul(x32, codes, scale, backend="cuda", **kf)
               - p32).abs()
        if MM.t_launches_fma != n0 + 1 or not bool(
                (d32 <= K1_FLOOR * u32).all()):
            raise AssertionError(f"K1t (fma) at M={M} V={rows} d={n} "
                                 f"{kind}, float32: beyond {K1_FLOOR:g} "
                                 f"units of fp32 summation noise")
        row["f32_noise"] = float((d32 / u32).max())
        worst["fma"] = max(worst["fma"], float(d32.max()))
        if rows in (V, GEMMA3_HEAD[0]) and kind in ("int8", "p4"):
            bad32 = x32[:, :-1] @ w32[:, :-1].T
            seen32 = float(((bad32 - p32).abs() > K1_FLOOR * u32).float()
                           .mean())
            if seen32 == 0.0:
                raise AssertionError(f"K1t float32 gate blind to a dropped d "
                                     f"column at M={M} {kind}")
            row["f32_fault_caught"] = seen32
            del bad32
        del x32, p32, w32, u32, d32
        if rows in (V, GEMMA3_HEAD[0]) and kind in ("int8", "p4"):
            # the planted fault: the last d column dropped from the sum
            bad = (x[:, :-1].float() @ w[:, :-1].T).to(torch.bfloat16)
            seen = float(((bad.float() - b.float()).abs() > tol).float()
                         .mean())
            if seen == 0.0:
                raise AssertionError(f"K1t gate blind to a dropped d column "
                                     f"at M={M} {kind}")
            row["fault_caught"] = seen
        table.append(row)
        del codes, w, a, b, unit, tol, diff
    torch.cuda.empty_cache()

    def time_case(M, kind, x_dtype=torch.bfloat16, V=V, d=d):
        """Kernel, plain and library times at a head (gemma2's unless
        given); the library is torch.matmul on the dequantized weight in
        the activations' type."""
        k_x, pb = CODE_KINDS[kind]
        cast = "bfloat16" if x_dtype == torch.bfloat16 else None
        codes = _codes(torch, B, g, dev, kind, V, d)[2]
        wf = MM.dequant_codes(codes, scale, k_x=k_x, n=d, pack_bits=pb,
                              w_dtype="float32", cast_dtype=cast)
        x = torch.randn((M, d), generator=g, device=dev).to(x_dtype)
        kw = dict(k_x=k_x, n=d, pack_bits=pb, cast_dtype=cast,
                  transpose=True)
        t_k = cuda_ms(torch, lambda i: MM.dequant_matmul(
            x, codes, scale, backend="cuda", **kw), 20, 3)
        t_p = cuda_ms(torch, lambda i: MM.dequant_matmul(
            x, codes, scale, backend="torch", **kw), 3, 1)
        t_l = cuda_ms(torch, lambda i: torch.matmul(x, wf.T), 20, 3)
        nbytes = codes.numel() * codes.element_size()
        xb = x.element_size()
        bnd, by = bound_ms(nbytes + xb * M * d + xb * M * V + 4,
                           2.0 * M * d * V)
        route = MM.route(x_dtype, codes.dtype, pb, "float32", cast)
        del codes, wf
        return dict(M=M, V=V, d=d, codes=kind, route=route,
                    x_dtype=str(x_dtype).split(".")[-1], ms=t_k,
                    plain_ms=t_p, library_ms=t_l, bound_ms=bnd, bound_by=by,
                    factor=t_k / t_l, share_of_bound=bnd / t_k,
                    gbs=nbytes / t_k / 1e6)
    timed = [time_case(M, kind) for kind in kinds for M in (1, 4)]
    g3 = {M: time_case(M, "int8", V=GEMMA3_HEAD[0], d=GEMMA3_HEAD[1])
          for M in (1, 4)}
    timed += list(g3.values())
    if any(r["route"] != "tc" for r in timed):
        raise AssertionError("K1t bf16 timed off the tensor-core route")
    f32 = {(kind, M): time_case(M, kind, torch.float32)
           for kind, M in (("int8", 1), ("int8", 4), ("int8", 8), ("p4", 4))}
    g3_f32 = time_case(4, "int8", torch.float32, V=GEMMA3_HEAD[0],
                       d=GEMMA3_HEAD[1])
    timed += list(f32.values()) + [g3_f32]
    fma = f32[("int8", 4)]
    torch.cuda.empty_cache()
    at = {(r["codes"], r["M"]): r for r in timed if r["route"] == "tc"
          and r["V"] == V}
    rep, slow = at[("int8", 4)], max(at.values(), key=lambda r: r["factor"])
    row_tc = dict(name="dequant_matmul_t_tc", route="cuda",
                  source="src/repro_torch/csrc/dequant_matmul.cu",
                  replaces="src/repro/comm/matmul.py:150",
                  max_abs_err=worst["tc"], ms=rep["ms"],
                  plain_ms=rep["plain_ms"], bound_ms=rep["bound_ms"],
                  bound_by=rep["bound_by"], library_ms=rep["library_ms"],
                  shape=[4, V, d], m1_ms=at[("int8", 1)]["ms"],
                  p4_ms=at[("p4", 4)]["ms"],
                  p4_library_ms=at[("p4", 4)]["library_ms"],
                  gemma3_ms=g3[4]["ms"], gemma3_m1_ms=g3[1]["ms"],
                  gemma3_library_ms=g3[4]["library_ms"],
                  gemma3_bound_ms=g3[4]["bound_ms"],
                  worst_factor=slow["factor"],
                  worst_case=[slow["codes"], slow["M"]])
    row_fma = dict(name="dequant_matmul_t", route="cuda",
                   source="src/repro_torch/csrc/dequant_matmul.cu",
                   replaces="src/repro/comm/matmul.py:150",
                   max_abs_err=worst["fma"], ms=fma["ms"],
                   plain_ms=fma["plain_ms"], bound_ms=fma["bound_ms"],
                   bound_by=fma["bound_by"], library_ms=fma["library_ms"],
                   shape=[4, V, d, "int8", "float32"],
                   m1_ms=f32[("int8", 1)]["ms"], m8_ms=f32[("int8", 8)]["ms"],
                   p4_ms=f32[("p4", 4)]["ms"],
                   p4_bound_ms=f32[("p4", 4)]["bound_ms"],
                   gemma3_ms=g3_f32["ms"],
                   gemma3_library_ms=g3_f32["library_ms"],
                   gemma3_bound_ms=g3_f32["bound_ms"])
    return [row_tc, row_fma], table, timed


def visible_pairs(Sq, Skv, *, causal, window, q_offset):
    """(query, key) pairs a flash-attention call attends, per head."""
    n = 0
    for i in range(Sq):
        p = q_offset + i
        hi = min(Skv, p + 1) if causal else Skv
        lo = max(0, p - window + 1) if window else 0
        n += max(0, hi - lo)
    return n


FLASH_CASES = [   # tests/test_kernels.py:135-145, gemma2-2b prefill, ragged
    ("causal", dict(B=2, Sq=256, Skv=256, H=4, K=2, hd=64, causal=True,
                    window=0, softcap=None)),
    ("suffix", dict(B=1, Sq=128, Skv=384, H=8, K=2, hd=32, causal=True,
                    window=0, softcap=None, q_offset=256)),
    ("swa_softcap", dict(B=1, Sq=256, Skv=256, H=2, K=2, hd=64, causal=True,
                         window=96, softcap=50.0)),
    ("bidirectional", dict(B=2, Sq=128, Skv=128, H=4, K=4, hd=128,
                           causal=False, window=0, softcap=None)),
    ("gemma2_local", dict(B=1, Sq=8192, Skv=8192, H=8, K=4, hd=256,
                          causal=True, window=4096, softcap=50.0, bf16=True)),
    ("gemma2_global", dict(B=1, Sq=8192, Skv=8192, H=8, K=4, hd=256,
                           causal=True, window=0, softcap=50.0, bf16=True)),
    ("ragged", dict(B=1, Sq=1000, Skv=1500, H=8, K=4, hd=256, causal=True,
                    window=700, softcap=50.0, q_offset=500, bf16=True)),
    # like for like: the global layer without the softcap, which
    # scaled_dot_product_attention(is_causal=True) computes; in bf16
    # (route "tc") and float32 (route "tc32", 3xTF32)
    ("gemma2_global_nocap", dict(B=1, Sq=8192, Skv=8192, H=8, K=4, hd=256,
                                 causal=True, window=0, softcap=None,
                                 bf16=True)),
    ("gemma2_global_f32", dict(B=1, Sq=8192, Skv=8192, H=8, K=4, hd=256,
                               causal=True, window=0, softcap=None)),
    # the float32 route at gemma2's layers as phase 4c runs them, and ragged
    ("gemma2_local_f32", dict(B=1, Sq=8192, Skv=8192, H=8, K=4, hd=256,
                              causal=True, window=4096, softcap=50.0)),
    ("gemma2_global_cap_f32", dict(B=1, Sq=8192, Skv=8192, H=8, K=4, hd=256,
                                   causal=True, window=0, softcap=50.0)),
    ("ragged_f32", dict(B=1, Sq=1000, Skv=1500, H=8, K=4, hd=256,
                        causal=True, window=700, softcap=50.0,
                        q_offset=500)),
]
# the float32 route's fp32-accurate floors at gemma2's global layer: 3 x
# its FLOPs at the H100 SXM's 494.7 TFLOP/s TF32 (tensor cores, 3xTF32)
# and 1 x at 66.9 TFLOP/s fp32 (CUDA cores); data sheet, 700 W
TF32_FLOPS, FP32_FLOPS = 494.7e12, 66.9e12


def flash_tolerance(torch, b):
    """float32: rtol 1e-4 / atol 1e-5; bfloat16: one bf16 ulp of the plain
    result plus 1e-5 (both sum in fp32 in orders of their own)."""
    if b.dtype == torch.bfloat16:
        return bf16_ulp(torch, b.float()) + 1e-5
    return 1e-5 + 1e-4 * b.abs()


def check_flash(torch, FA, dev):
    """#17 against its plain version on every FLASH_CASES entry (bf16 on
    route "tc", float32 on route "tc32", both tensor cores), timed with its
    bound, plain time and a PyTorch yardstick: where the case has no
    softcap, window or offset, scaled_dot_product_attention(is_causal=True)
    computes the same function (like for like); elsewhere the reading is
    scaled_dot_product_attention with a boolean mask and without the
    softcap (no PyTorch call applies one), labelled as such. A window off
    by one in the plain version must fail the gate at gemma2's local
    layer, in bf16 and in float32. Returns the two kernels-line rows and
    the case table."""
    import torch.nn.functional as F
    g = torch.Generator(device=dev).manual_seed(19)
    table, rows = [], {}
    for name, c in FLASH_CASES:
        dt = torch.bfloat16 if c.get("bf16") else torch.float32
        q = torch.randn((c["B"], c["Sq"], c["H"], c["hd"]), generator=g,
                        device=dev).to(dt)
        k, v = (torch.randn((c["B"], c["Skv"], c["K"], c["hd"]), generator=g,
                            device=dev).to(dt) for _ in range(2))
        kw = dict(causal=c["causal"], window=c["window"],
                  softcap=c["softcap"], q_offset=c.get("q_offset", 0))
        n0 = getattr(FA, "launches_" + FA.route(dt))
        a = FA.flash_attention(q, k, v, backend="cuda", **kw)
        if getattr(FA, "launches_" + FA.route(dt)) != n0 + 1:
            raise AssertionError(f"#17 {name}: off the {FA.route(dt)} route")
        a2 = FA.flash_attention(q, k, v, backend="cuda", **kw)
        b = FA.flash_attention(q, k, v, backend="torch", **kw)
        diff = (a.float() - b.float()).abs()
        tol = flash_tolerance(torch, b)
        if a.dtype != dt or a.shape != q.shape or not bool(
                (diff <= tol).all()):
            raise AssertionError(f"#17 {name}: beyond its tier of the plain "
                                 f"version (max abs {float(diff.max())})")
        if not torch.equal(a, a2):
            raise AssertionError(f"#17 {name}: two calls differ")
        row = dict(case=name, route=FA.route(dt),
                   max_abs_err=float(diff.max()),
                   shape=[c["B"], c["Sq"], c["Skv"], c["H"], c["K"],
                          c["hd"]], dtype=str(dt).split(".")[-1],
                   causal=c["causal"], window=c["window"],
                   softcap=c["softcap"], q_offset=kw["q_offset"])
        if name in ("gemma2_local", "gemma2_local_f32"):
            bad = FA.flash_attention(q, k, v, backend="torch",
                                     **dict(kw, window=c["window"] + 1))
            seen = float(((bad.float() - b.float()).abs() > tol).float()
                         .mean())
            if seen == 0.0:
                raise AssertionError("#17 gate blind to a window off by one")
            row["fault_caught"] = seen
            del bad
        del a, a2, b
        pairs = visible_pairs(c["Sq"], c["Skv"], causal=c["causal"],
                              window=c["window"], q_offset=kw["q_offset"])
        flops = 4.0 * c["hd"] * pairs * c["B"] * c["H"]
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, flops)
        big = c["Sq"] >= 4096
        row["ms"] = cuda_ms(torch, lambda i: FA.flash_attention(
            q, k, v, backend="cuda", **kw), 5 if big else 20, 1)
        row["plain_ms"] = cuda_ms(torch, lambda i: FA.flash_attention(
            q, k, v, backend="torch", **kw), 2 if big else 5, 1)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa = F.scaled_dot_product_attention
        same = (c["softcap"] is None and not c["window"] and
                not kw["q_offset"] and c["causal"] and c["Sq"] == c["Skv"])
        if same:
            row["library"] = "same function (is_causal)"
            row["library_ms"] = cuda_ms(torch, lambda i: sdpa(
                qt, kt, vt, is_causal=True, enable_gqa=True),
                5 if big else 20, 1)
        else:
            row["library"] = "boolean mask, no softcap"
            vis = FA._visible(c["Sq"], c["Skv"], causal=c["causal"],
                              window=c["window"], q_offset=kw["q_offset"],
                              device=dev)
            row["library_ms"] = cuda_ms(torch, lambda i: sdpa(
                qt, kt, vt, attn_mask=vis, enable_gqa=True),
                5 if big else 20, 1)
            del vis
        row["gflops_per_s"] = flops / row["ms"] / 1e6
        table.append(row)
        rows[name] = row
        del q, k, v, qt, kt, vt

    def krow(name, case, **extra):
        r = rows[case]
        return dict(name=name, route="cuda",
                    source="src/repro_torch/csrc/flash_attention.cu",
                    replaces="src/repro/kernels/flash_attention.py:76",
                    max_abs_err=max(t["max_abs_err"] for t in table
                                    if t["route"] == r["route"]),
                    ms=r["ms"], plain_ms=r["plain_ms"],
                    bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                    library_ms=r["library_ms"], shape=r["shape"], **extra)
    glob, local = rows["gemma2_global"], rows["gemma2_local"]
    f32 = rows["gemma2_global_f32"]
    flops = f32["gflops_per_s"] * f32["ms"] * 1e6
    return [krow("flash_attention_tc", "gemma2_global_nocap",
                 softcap_ms=glob["ms"],
                 masked_library_ms=glob["library_ms"],
                 local_ms=local["ms"]),
            krow("flash_attention_tc32", "gemma2_global_f32",
                 softcap_ms=rows["gemma2_global_cap_f32"]["ms"],
                 local_ms=rows["gemma2_local_f32"]["ms"],
                 floor_3xtf32_ms=3 * flops / TF32_FLOPS * 1e3,
                 floor_fp32_cores_ms=flops / FP32_FLOPS * 1e3,
                 tf32_tflops=3 * flops / f32["ms"] / 1e9)], table


# ---------------------------------------------------------------------------
# phase 3, training kernels: K15, K16, K11, K12 against their plain versions
# ---------------------------------------------------------------------------

def bits_equal(torch, a, b) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


def check_training_kernels(torch, dev):
    """K15/K16/K11/K12 bitwise against their plain versions on the
    stacked w_gate leaf of the 8-layer cell and on the embedding, with a
    seeded optimizer state; times at both shapes. Returns the four kernel
    rows (w_gate shape) and a table of every timing."""
    import numpy as np
    from repro_torch.comm import kernels as K
    from repro_torch.kernels import adam_ef as A
    from repro_torch.opt import engine as E
    d, f, V = YI["d"], YI["f"], YI["V"]
    theta_t = np.float32(1.0) - np.float32(0.999) / np.float32(3.0)
    hp = E.hyperparams(np.float32(1e-3), 0.99, theta_t, 1e-5, dev)
    table, rows = [], None
    for leaf, shape in (("w_gate", (TRAIN_LAYERS, d, f)), ("embed", (V, d))):
        gen = torch.Generator(device=dev).manual_seed(21)
        g, m, v, e = (torch.randn(shape, generator=gen, device=dev) * s
                      for s in (1e-2, 1e-3, 1e-2, 1e-6))
        v.mul_(v)
        n = g.numel()
        a = A.adam_moments(g, m, v, e, hp, backend="cuda")
        b = A.adam_moments(g, m, v, e, hp, backend="torch")
        for what, x, y in zip(("m'", "v'", "Delta+e", "amax"), a, b):
            if not bits_equal(torch, x, y):
                raise AssertionError(f"K15 {what} differs from its plain "
                                     f"version on {leaf}")
        del b
        m2, v2, de, amax = a
        del m2, v2
        scale = E.amax_scale(amax)
        ck, ek = A.ef_quantize(de, scale, 6, backend="cuda")
        cp, ep = A.ef_quantize(de, scale, 6, backend="torch")
        if not (bits_equal(torch, ck, cp) and bits_equal(torch, ek, ep)):
            raise AssertionError(f"K16 differs from its plain version on "
                                 f"{leaf}")
        del cp, ep
        dk = K.log_dequantize(ck, -scale, 6, backend="cuda")
        if not bits_equal(torch, dk, K.log_dequantize(ck, -scale, 6,
                                                      backend="torch")):
            raise AssertionError(f"K11 differs from its plain version on "
                                 f"{leaf}")
        # the leaf's Q_x round trip as forward_params runs it
        # (uniform_amax:7): K3 over the whole leaf as one row, K4 to int16
        # codes at k_x = 7, K12 back to float32
        x2 = m.reshape(1, -1)
        ak = K.amax_rows(x2, backend="cuda")
        if not bits_equal(torch, ak, K.amax_rows(x2, backend="torch")):
            raise AssertionError(f"K3 differs from its plain version on the "
                                 f"whole {leaf} leaf")
        qs = E.amax_scale(ak)
        qc = K.uniform_quantize_rows(x2, qs, 7, backend="cuda")
        if qc.dtype != torch.int16 or not bits_equal(
                torch, qc, K.uniform_quantize_rows(x2, qs, 7,
                                                   backend="torch")):
            raise AssertionError(f"K4 (int16, k_x = 7) differs from its "
                                 f"plain version on the whole {leaf} leaf")
        uk = K.uniform_dequantize_rows(qc, qs, 7, backend="cuda")
        if not bits_equal(torch, uk, K.uniform_dequantize_rows(
                qc, qs, 7, backend="torch")):
            raise AssertionError(f"K12 differs from its plain version on "
                                 f"{leaf}")
        del uk, ak
        t = {}
        t["adam_moments"] = (
            cuda_ms(torch, lambda i: A.adam_moments(g, m, v, e, hp,
                                                    backend="cuda"), 5, 1),
            cuda_ms(torch, lambda i: A.adam_moments(g, m, v, e, hp,
                                                    backend="torch"), 3, 1),
            None, bound_ms(28 * n + 16 + 4))
        # no one PyTorch call computes K15; its max-fold alone, timed for
        # results/chip_smoke.json and kept out of the kernels line
        fold_ms = cuda_ms(torch, lambda i: de.abs().amax(), 5, 1)
        t["ef_quantize"] = (
            cuda_ms(torch, lambda i: A.ef_quantize(de, scale, 6,
                                                   backend="cuda"), 5, 1),
            cuda_ms(torch, lambda i: A.ef_quantize(de, scale, 6,
                                                   backend="torch"), 3, 1),
            None, bound_ms(9 * n + 4))
        t["log_dequantize"] = (
            cuda_ms(torch, lambda i: K.log_dequantize(ck, scale, 6,
                                                      backend="cuda"), 5, 1),
            cuda_ms(torch, lambda i: K.log_dequantize(ck, scale, 6,
                                                      backend="torch"), 3, 1),
            None, bound_ms(5 * n + 4 + 16 * 4))
        t["uniform_dequantize_rows"] = (
            cuda_ms(torch, lambda i: K.uniform_dequantize_rows(
                qc, qs, 7, backend="cuda"), 5, 1),
            cuda_ms(torch, lambda i: K.uniform_dequantize_rows(
                qc, qs, 7, backend="torch"), 3, 1),
            None, bound_ms(6 * n + 4))
        for name, (ms, plain, lib, (bnd, by)) in t.items():
            table.append(dict(name=name, leaf=leaf, shape=list(shape), ms=ms,
                              plain_ms=plain, library_ms=lib, bound_ms=bnd,
                              bound_by=by, gbs=None))
            if name == "adam_moments":
                table[-1]["amax_fold_library_ms"] = fold_ms
        if rows is None:
            src = {"adam_moments": ("src/repro_torch/csrc/adam_ef.cu",
                                    "src/repro/kernels/adam_ef.py:42"),
                   "ef_quantize": ("src/repro_torch/csrc/adam_ef.cu",
                                   "src/repro/kernels/adam_ef.py:70"),
                   "log_dequantize": ("src/repro_torch/csrc/dequantize.cu",
                                      "src/repro/comm/kernels.py:524"),
                   "uniform_dequantize_rows": (
                       "src/repro_torch/csrc/dequantize.cu",
                       "src/repro/comm/kernels.py:571")}
            rows = [dict(name=name, route="cuda", source=src[name][0],
                         replaces=src[name][1], max_abs_err=0.0, ms=ms,
                         plain_ms=plain, bound_ms=bnd, bound_by=by,
                         library_ms=lib, shape=list(shape))
                    for name, (ms, plain, lib, (bnd, by)) in t.items()]
        del g, m, v, e, de, amax, ck, ek, dk, qc, x2, a
        torch.cuda.empty_cache()
    return rows, table


# ---------------------------------------------------------------------------
# phase 3, the reference's threefry draws (no Pallas kernel: XLA's threefry
# behind jax.random.uniform and jax.random.fold_in / split)
# ---------------------------------------------------------------------------

# H100 SXM: the dispatch ceiling, one warp instruction a clock on each of an
# SM's 4 schedulers (128 lanes an SM, the float32 datapath's width) on 132
# SMs at the 1.98 GHz that gives the data sheet's 67 TFLOP/s of float32.
# No instruction of any type issues faster; the 64 int32 ALU lanes an SM
# alone would give half this rate, but ptxas moves integer adds onto the
# FMA pipe (IMAD), so the kernel can run past that half rate
DISPATCH_OPS_PER_S = 132 * 4 * 32 * 1.98e9
# operations a uniform: threefry2x32-20 (2 key adds, 20 rounds of add,
# rotate and xor, five injections of two adds: 72 int32), the 64-bit
# counter's add (2), the fold, the shift and the or (3), the float
# subtraction and max (2)
THREEFRY_UNIFORM_OPS = 79
THREEFRY = dict(source="src/repro_torch/csrc/threefry.cu", route="cuda")


def train_leaves(torch) -> int:
    """The leaves of the training cell's model (yi-6b x TRAIN_LAYERS)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.tree import tree_leaves
    cfg = dataclasses.replace(get_config("yi-6b"), n_layers=TRAIN_LAYERS)
    return len(tree_leaves(Model(cfg).init(device="meta")))


def int_bound_ms(nbytes: float, ops: float):
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / DISPATCH_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def check_threefry(torch, dev, n_leaves: int):
    """rt_threefry_uniform and rt_threefry_keys bitwise against their
    plain versions (``core.threefry``): the uniforms at n 1, 3, 4099 and
    2^20 + 7, aligned and at an offset output, from leaf 1 of a table and
    at a start past 2^32; the keys of both chains at 1, ``n_leaves`` and
    300 leaves (Algorithm 1's key advanced in place three times); then the
    uniforms at the 8-layer w_gate stack's 360.7 M elements, bitwise and
    timed beside the plain version and ``torch.rand`` (Philox: not the
    same function, for information), and both key launches timed at
    ``n_leaves``. Returns the two kernel rows."""
    from repro_torch.core import threefry as TF
    from repro_torch.kernels import prng as P
    table = torch.stack([TF.prng_key(s, dev) for s in (0, 7, 2 ** 31 - 1)])
    for n in (1, 3, 4099, 2 ** 20 + 7):
        buf = torch.empty(n + 1, device=dev)
        for leaf, start in ((0, 0), (1, 0), (2, 2 ** 32 - 3)):
            want = P.uniform(table, leaf, n, start, backend="torch")
            for got in (P.uniform(table, leaf, n, start, backend="cuda"),
                        P.uniform(table, leaf, n, start, backend="cuda",
                                  out=buf[1:])):
                if not bits_equal(torch, got, want):
                    raise AssertionError(f"threefry uniform differs from "
                                         f"its plain version (n {n}, leaf "
                                         f"{leaf}, start {start})")
    for L in (1, n_leaves, 300):
        for t in (1, 2 ** 31 + 5):
            tt = torch.tensor([t], dtype=torch.int64, device=dev)
            for worker in (0, 3):
                if not bits_equal(torch, P.step_keys(9, tt, L, worker,
                                                     backend="cuda"),
                                  P.step_keys(9, tt, L, worker,
                                              backend="torch")):
                    raise AssertionError(f"threefry keys (distributed "
                                         f"chain) differ at L {L}, t {t}")
        ka, kb = TF.prng_key(11, dev), TF.prng_key(11, dev)
        for _ in range(3):
            if not (bits_equal(torch, P.advance_keys(ka, L, backend="cuda"),
                               P.advance_keys(kb, L, backend="torch"))
                    and bits_equal(torch, ka, kb)):
                raise AssertionError(f"threefry keys (Algorithm 1's chain) "
                                     f"differ at L {L}")
    # the w_gate stack: bitwise, then timed
    n = TRAIN_LAYERS * YI["d"] * YI["f"]
    keys = P.step_keys(0, torch.tensor([3], dtype=torch.int64, device=dev),
                       n_leaves, 0)
    got = P.uniform(keys, 1, n, backend="cuda")
    want = P.uniform(keys, 1, n, backend="torch")
    if not bits_equal(torch, got, want):
        raise AssertionError("threefry uniform differs from its plain "
                             "version at the w_gate stack")
    del want
    torch.cuda.empty_cache()
    ms = cuda_ms(torch, lambda i: P.uniform(keys, 1, n, backend="cuda",
                                            out=got), 10, 2)
    plain = cuda_ms(torch, lambda i: P.uniform(keys, 1, n, backend="torch",
                                               out=got), 2, 1)
    gen = torch.Generator(device=dev).manual_seed(0)
    lib = cuda_ms(torch, lambda i: torch.rand(n, generator=gen, device=dev,
                                              out=got), 10, 2)
    bnd, by = int_bound_ms(4 * n, THREEFRY_UNIFORM_OPS * n)
    rows = [dict(name="threefry_uniform", replaces=(
        "src/repro/core/quantizers.py:132"), max_abs_err=0.0, ms=ms,
        plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=lib,
        shape=[n], **THREEFRY)]
    del got
    torch.cuda.empty_cache()
    tt = torch.tensor([3], dtype=torch.int64, device=dev)
    key = TF.prng_key(0, dev)
    # the key launches' device time in a CUDA graph (one launch is far
    # shorter than its host call); the plain versions eagerly
    k_ms = {
        "dist": (graph_ms(torch, lambda i: P.step_keys(
            0, tt, n_leaves, 0, backend="cuda")),
            cuda_ms(torch, lambda i: P.step_keys(
                0, tt, n_leaves, 0, backend="torch"), 5, 1)),
        "alg1": (graph_ms(torch, lambda i: P.advance_keys(
            key, n_leaves, backend="cuda")),
            cuda_ms(torch, lambda i: P.advance_keys(
                key, n_leaves, backend="torch"), 5, 1))}
    # the distributed chain: three threefry a leaf, 8 B a leaf written, t
    # read; each a 72-operation threefry
    bnd, by = int_bound_ms(8 * n_leaves + 8, 3 * 72 * n_leaves)
    rows.append(dict(name="threefry_keys", replaces=(
        "src/repro/dist/step.py:517"), max_abs_err=0.0, ms=k_ms["dist"][0],
        plain_ms=k_ms["dist"][1], bound_ms=bnd, bound_by=by,
        library_ms=None, shape=[n_leaves, 2],
        alg1_ms=k_ms["alg1"][0], alg1_plain_ms=k_ms["alg1"][1], **THREEFRY))
    return rows


# operations a truncated normal: the uniform's 77 (threefry 72, the
# counter's 2, the shift, or and subtraction 3), the affine and its max
# (3), u*u (1), log1pf (20, libdevice's), the branch's compare, select,
# subtraction and sqrtf (4), the polynomial's 8 multiplies and 8 adds with
# the coefficients' select (17), and p*u, sqrt2, the two clamps and the std
# (5)
TRUNC_NORMAL_OPS = 127
# operations a scored logit of the sampling step: the threefry (72), the
# counter (1), the float (3), u's add and max (2), two logf (2 x 14), two
# negations (2), the IEEE division (9), the add (1), the two running
# argmaxes (6)
CATEGORICAL_OPS = 124
# the sampling step at yi-6b's shapes first (phase 4's decode step of 4
# slots and its first tokens, one slot), then the widest vocabularies
CATEGORICAL_SHAPES = [(4, 64000), (1, 64000), (4, 262144), (4, 152064)]
CATEGORICAL_STEPS = 64
SLAB = 4096


def trunc_normal_slabs(torch, P, keys, n, got, what):
    """The first and last SLAB elements of the first and last row of
    ``got``, drawn by the kernel under ``keys`` ((2,) or (L, 2)), bitwise
    the plain version's draws of the same elements."""
    table = keys.reshape(-1, 2)
    rows = got.reshape(table.shape[0], n)
    for l in sorted({0, table.shape[0] - 1}):
        for start in (0, n - SLAB):
            want = P.trunc_normal(table[l:l + 1], (SLAB,), 0.02, start,
                                  backend="torch")
            if not bits_equal(torch, rows[l, start:start + SLAB], want[0]):
                raise AssertionError(f"threefry trunc_normal differs from "
                                     f"its plain version ({what}, row {l}, "
                                     f"elements {start}..)")
    if not bool(torch.isfinite(got).all()) or \
            float(got.abs().max()) >= 0.04:
        raise AssertionError(f"threefry trunc_normal out of its range "
                             f"({what})")


def check_prng_draws(torch, dev):
    """rt_threefry_trunc_normal at yi-6b's leaf forms: the 8-layer w_gate
    stack (one launch over 8 layer keys), a 32-layer wq stack and the
    embedding under its one key ((2,), one row); slabs of the first and
    last SLAB elements of the first and last row bitwise the plain
    version; the w_gate stack timed beside the plain version and
    ``torch.nn.init.trunc_normal_`` (Philox: another function, the
    yardstick). rt_threefry_categorical at CATEGORICAL_SHAPES over
    CATEGORICAL_STEPS seeded steps: greedy tokens, sampled tokens and the
    keys written back bitwise the plain step; timed (a CUDA graph of the
    two launches) beside the plain step and ``argmax(logits / t -
    log(-log(rand)))``. Returns the two kernel rows, the sampling step's
    at yi-6b's decode shape (4, 64000)."""
    from repro_torch.core import threefry as TF
    from repro_torch.kernels import prng as P
    for what, keys, n in (
            ("wq, 32 layers", TF.split(TF.prng_key(1), YI["L"]),
             YI["d"] * YI["H"] * YI["hd"]),
            ("embed, one key", TF.prng_key(2), YI["V"] * YI["d"])):
        keys = keys.to(dev)
        got = P.trunc_normal(keys, (n,), 0.02, backend="cuda")
        trunc_normal_slabs(torch, P, keys, n, got, what)
        del got
    L, n = TRAIN_LAYERS, YI["d"] * YI["f"]
    keys = TF.split(TF.prng_key(0), L).to(dev)
    got = P.trunc_normal(keys, (n,), 0.02, backend="cuda")
    trunc_normal_slabs(torch, P, keys, n, got, "w_gate, 8 layers")
    ms = cuda_ms(torch, lambda i: P.trunc_normal(keys, (n,), 0.02,
                                                 backend="cuda", out=got),
                 5, 1)
    plain = cuda_ms(torch, lambda i: P.trunc_normal(
        keys, (n,), 0.02, backend="torch", out=got), 1, 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    lib = cuda_ms(torch, lambda i: torch.nn.init.trunc_normal_(
        got, 0.0, 0.02, -0.04, 0.04, generator=gen), 5, 1)
    bnd, by = int_bound_ms(4 * L * n, TRUNC_NORMAL_OPS * L * n)
    rows = [dict(name="threefry_trunc_normal", replaces=(
        "src/repro/models/model.py:44"), max_abs_err=0.0, ms=ms,
        plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=lib,
        shape=[L, n], **THREEFRY)]
    del got
    torch.cuda.empty_cache()

    cat = []
    for B, V in CATEGORICAL_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(V)
        temp = torch.tensor([0.8, 0.0, 1.0, 0.5][:B], device=dev)
        ka = TF.split(TF.prng_key(V), B).to(dev)
        kb = ka.clone()
        for step in range(CATEGORICAL_STEPS):
            lg = 4 * torch.randn(B, V, generator=gen, device=dev)
            lg[:, V // 3] = lg[:, V - 5] = float(lg.max()) + 1.0
            ga, sa = P.categorical_step(lg, temp, ka, backend="cuda")
            gb, sb = P.categorical_step(lg, temp, kb, backend="torch")
            if not (bits_equal(torch, ga, gb) and bits_equal(torch, sa, sb)
                    and bits_equal(torch, ka, kb)):
                raise AssertionError(f"threefry categorical differs from "
                                     f"its plain step at ({B}, {V}), step "
                                     f"{step}")
        ms = graph_ms(torch, lambda i: P.categorical_step(
            lg, temp, ka, backend="cuda"))
        plain = cuda_ms(torch, lambda i: P.categorical_step(
            lg, temp, kb, backend="torch"), 5, 1)
        lib = graph_ms(torch, lambda i: torch.argmax(
            lg / temp.clamp_min(1e-6)[:, None]
            - torch.log(-torch.log(torch.rand(B, V, device=dev))), -1))
        bnd, by = int_bound_ms(4 * B * V + 40 * B, CATEGORICAL_OPS * B * V)
        cat.append(dict(shape=[B, V], ms=ms, plain_ms=plain,
                        library_ms=lib, bound_ms=bnd, bound_by=by))
    top = cat[0]
    rows.append(dict(name="threefry_categorical", replaces=(
        "src/repro/serve/session.py:480"), max_abs_err=0.0, ms=top["ms"],
        plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
        bound_by=top["bound_by"], library_ms=top["library_ms"],
        shape=top["shape"], shapes=cat, **THREEFRY))
    return rows


# ---------------------------------------------------------------------------
# phase 3, the MoE family's shapes: K12 on an expert stack, K1 at routers
# ---------------------------------------------------------------------------

DEEPSEEK_STACK = (64, 2048, 1408)       # one layer's w_gate: E, d, fe
ROUTER_SHAPES = [(4, 2048, 64), (128, 2048, 64), (4, 5120, 16),
                 (128, 5120, 16)]     # M, K = d_model, N = experts


def check_moe_shapes(torch, dev, MM):
    """K12 through ``QuantizedLeaf.dequantize`` on a code-resident
    (2, 64, 2048, 1408) int8 stack: layer 1's row of 184,549,376 codes
    is a view of the 4-D codes (no copy), one launch, bitwise the plain
    version; alone and with the pending bf16 cast (the decode step's
    at-use dequantize). K1 at the routers' shapes on tensor cores within
    one bf16 ulp plus the floor. Both timed in CUDA graphs beside their
    plain versions, bounds and (K1) ``torch.matmul``."""
    from repro_torch.comm import kernels as K
    from repro_torch.serve import quantized as Q
    g = torch.Generator(device=dev).manual_seed(29)
    codes = torch.randint(-64, 65, (2,) + DEEPSEEK_STACK, generator=g,
                          device=dev).to(torch.int8)
    scale = torch.rand(2, generator=g, device=dev) + 0.01
    leaf = Q.QuantizedLeaf(codes=codes, scale=scale, k_x=6,
                           shape=tuple(codes.shape), dtype="float32")
    one = leaf.layer(1)
    rows, _ = Q.code_rows(one.codes, one.scale)
    if rows.data_ptr() != codes[1].data_ptr() or rows.shape != (
            1, math.prod(DEEPSEEK_STACK)):
        raise AssertionError(f"K12's rows of a sliced stack are no view: "
                             f"{tuple(rows.shape)}")
    table = []
    n = rows.numel()
    for what, lf, out_b in (("K12", one, 4),
                            ("K12 + bf16 cast", one.astype(torch.bfloat16),
                             2)):
        k0 = K.dequantize_launches
        a = lf.dequantize()
        if K.dequantize_launches != k0 + 1 or not bits_equal(
                torch, a, lf.dequantize(backend="torch")):
            raise AssertionError(f"{what} on the expert stack: launches "
                                 f"{K.dequantize_launches - k0}, or not "
                                 f"bitwise its plain version")
        # bytes: the codes read, float32 written; the cast reads that and
        # writes bf16
        nbytes = n * (1 + 4) + (n * (4 + out_b) if out_b == 2 else 0)
        bnd, by = bound_ms(nbytes)
        table.append(dict(name="uniform_dequantize_rows", what=what,
                          shape=list(DEEPSEEK_STACK), codes=n,
                          ms=graph_ms(torch, lambda i: lf.dequantize(), 1,
                                      10),
                          plain_ms=graph_ms(torch, lambda i: lf.dequantize(
                              backend="torch"), 1, 5),
                          library_ms=None, bound_ms=bnd, bound_by=by))
        del a
    del codes, leaf, one, rows
    torch.cuda.empty_cache()
    for M, Kd, N in ROUTER_SHAPES:
        cs = [torch.randint(-64, 65, (Kd, N), generator=g, device=dev).to(
            torch.int8) for _ in range(4)]
        c = cs[0]
        s = torch.tensor(0.0371, device=dev)
        x = torch.randn(M, Kd, generator=g, device=dev).to(torch.bfloat16)
        kw = dict(k_x=6, n=N, cast_dtype="bfloat16")
        a = MM.dequant_matmul(x, c, s, backend="cuda", **kw)
        b = MM.dequant_matmul(x, c, s, backend="torch", **kw)
        unit = k1_noise_unit(torch, MM, x, c, s, dict(kw, pack_bits=0))
        tol = k1_tolerance(torch, b, unit)
        if not bool(((a.float() - b.float()).abs() <= tol).all()):
            raise AssertionError(f"K1 at the router shape {(M, Kd, N)} "
                                 f"beyond one bf16 ulp plus the floor")
        ws = [MM.dequant_codes(ci, s, k_x=6, n=N, pack_bits=0,
                               w_dtype="float32", cast_dtype="bfloat16")
              for ci in cs]
        bnd, by = bound_ms(Kd * N + 2 * M * Kd + 2 * M * N, 2 * M * Kd * N)
        # in CUDA graphs over 4 sets of codes, as phase 3's K1 table
        table.append(dict(
            name="dequant_matmul_tc", what="router", shape=[M, Kd, N],
            ms=graph_ms(torch, lambda i: MM.dequant_matmul(
                x, cs[i], s, backend="cuda", **kw), 4),
            plain_ms=graph_ms(torch, lambda i: MM.dequant_matmul(
                x, cs[i], s, backend="torch", **kw), 4, 5),
            library_ms=graph_ms(torch, lambda i: torch.matmul(x, ws[i]), 4),
            bound_ms=bnd, bound_by=by))
    return table


# ---------------------------------------------------------------------------
# phase 3, wire kernels: K7 fused EF encode and K6 fused decode
# ---------------------------------------------------------------------------

WIRE_CODECS = [("log", 2), ("log", 4), ("log", 6), ("log", 8),
               ("log", 30), ("log", 126),
               ("uniform", 3), ("uniform", 6), ("uniform", 7),
               ("uniform", 14)]


def wire_codec(kind, k, absolute=True):
    from repro_torch.comm import codec as CD
    return CD.LogCodec(k_g=k) if kind == "log" else \
        CD.uniform_wire_codec(k, absolute)


def check_wire_kernels(torch, dev):
    """K7 and K6 bitwise against their plain versions over n_rows in
    {1, 2, 4} (a distinct scale per decoded row, the last row short),
    chunk lengths {1, 7, 1000003}, the log grid at k_g {2, 4, 6, 8} and
    the uniform wire at k_x {3, 6, 7} (its +/-2^k_x clip), all-zero
    input, K6 straight into a flat leaf; then at the 8-layer w_gate
    stack for log:6 (the update exchange: Delta+e against its amax) and
    uniform:7 (the weight broadcast: weights against 0.5), bitwise and
    timed against their bounds. Returns the four kernel rows and the
    timing table."""
    from repro_torch.comm import kernels as K
    from repro_torch.opt import engine as E
    cases = 0
    for kind, k in WIRE_CODECS:
        codec = wire_codec(kind, k)
        for c in (1, 7, 1000003):
            for n_rows in (1, 2, 4):
                n = n_rows * c - (n_rows - 1)
                gen = torch.Generator(device=dev).manual_seed(
                    n_rows * 100 + c + k)
                x = torch.randn(n, generator=gen, device=dev) * (
                    1.0 if kind == "log" else 0.3)
                scale = (E.amax_scale(x.abs().amax()) if kind == "log"
                         else torch.tensor(0.5, device=dev))
                for zero in (False, True) if c == 7 else (False,):
                    if zero:
                        x.zero_()
                        if kind == "log":
                            scale = E.amax_scale(x.abs().amax())
                    enc = [K.ef_encode_rows(x, scale, codec, n_rows,
                                            backend=b)
                           for b in ("cuda", "torch")]
                    if not all(bits_equal(torch, a, b)
                               for a, b in zip(*enc)):
                        raise AssertionError(
                            f"K7 {codec.spec} differs from its plain version "
                            f"(n_rows={n_rows}, c={c}, zero={zero})")
                    scales = (torch.rand(n_rows, generator=gen, device=dev)
                              + 0.5) * scale
                    dk = K.decode_rows(enc[0][0], scales, codec, c,
                                       backend="cuda")
                    out = torch.full((n,), float("nan"), device=dev)
                    K.decode_rows(enc[0][0], scales, codec, c,
                                  backend="cuda", out=out)
                    if not (bits_equal(torch, dk, K.decode_rows(
                            enc[0][0], scales, codec, c, backend="torch"))
                            and bits_equal(torch, out, dk.reshape(-1)[:n])):
                        raise AssertionError(
                            f"K6 {codec.spec} differs from its plain version "
                            f"(n_rows={n_rows}, c={c}, zero={zero})")
                    cases += 1
    # the w_gate stack of the 8-layer cell, as the main path gives it at
    # one worker: one payload row
    d, f = YI["d"], YI["f"]
    n = TRAIN_LAYERS * d * f
    gen = torch.Generator(device=dev).manual_seed(31)
    x = torch.empty(n, device=dev)
    table, rows = [], []
    # the card's own write rate at K6's output bytes: fill_ over the same
    # float32 stack, a yardstick for K6's share of its bound (a reading)
    fill_ms = cuda_ms(torch, lambda i: x.fill_(0.0), 5, 1)
    table.append(dict(name="fill_", spec="yardstick", input="zeros",
                      shape=[n], ms=fill_ms, plain_ms=fill_ms,
                      bound_ms=bound_ms(4 * n)[0], bound_by="bytes",
                      share_of_bound=bound_ms(4 * n)[0] / fill_ms,
                      gbs=4 * n / fill_ms / 1e6))
    for kind, k, src in (("log", 6, "Delta+e"), ("uniform", 7, "weights")):
        codec = wire_codec(kind, k)
        if kind == "log":
            torch.randn(n, generator=gen, out=x).mul_(1e-3)
            scale = E.amax_scale(x.abs().amax())
        else:
            torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0,
                                        generator=gen).mul_(0.02)
            scale = torch.tensor(0.5, device=dev)
        pk, ek = K.ef_encode_rows(x, scale, codec, 1, backend="cuda")
        pp, ep = K.ef_encode_rows(x, scale, codec, 1, backend="torch")
        if not (bits_equal(torch, pk, pp) and bits_equal(torch, ek, ep)):
            raise AssertionError(f"K7 {codec.spec} differs from its plain "
                                 f"version at the w_gate stack")
        del pp, ep
        scales = scale.reshape(1)
        out = torch.empty(n, device=dev)
        K.decode_rows(pk, scales, codec, n, backend="cuda", out=out)
        if not bits_equal(torch, out, K.decode_rows(
                pk, scales, codec, n, backend="torch").reshape(-1)):
            raise AssertionError(f"K6 {codec.spec} differs from its plain "
                                 f"version at the w_gate stack")
        nbytes = pk.numel()
        t = {}
        t["ef_encode_rows"] = (
            cuda_ms(torch, lambda i: K.ef_encode_rows(x, scale, codec, 1,
                                                      backend="cuda",
                                                      out=ek), 5, 1),
            cuda_ms(torch, lambda i: K.ef_encode_rows(x, scale, codec, 1,
                                                      backend="torch"), 2, 1),
            bound_ms(8 * n + nbytes + 4))
        t["decode_rows"] = (
            cuda_ms(torch, lambda i: K.decode_rows(pk, scales, codec, n,
                                                   backend="cuda", out=out),
                    5, 1),
            cuda_ms(torch, lambda i: K.decode_rows(pk, scales, codec, n,
                                                   backend="torch"), 2, 1),
            bound_ms(nbytes + 4 * n + 4))
        for name, (ms, plain, (bnd, by)) in t.items():
            table.append(dict(name=f"{name}_{kind}", spec=codec.spec,
                              input=src, shape=[n], ms=ms, plain_ms=plain,
                              bound_ms=bnd, bound_by=by,
                              share_of_bound=bnd / ms,
                              gbs=(bnd * 1e-3 * HBM_BYTES_PER_S) / ms / 1e6))
            rows.append(dict(
                name=f"{name}_{kind}", route="cuda",
                source="src/repro_torch/csrc/codec.cu",
                replaces=("src/repro/comm/kernels.py:356"
                          if name == "ef_encode_rows"
                          else "src/repro/comm/kernels.py:286"),
                max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=bnd,
                bound_by=by, library_ms=None, shape=[n]))
        del pk, ek, out
    del x
    torch.cuda.empty_cache()
    return rows, table, cases


# ---------------------------------------------------------------------------
# phase 3, the baselines' kernels: #5 fused encode, K6 ternary, #14, #8
# ---------------------------------------------------------------------------

ENCODE_CODECS = ([("log", k, True) for k in (2, 4, 6, 8, 30, 126)]
                 + [("uniform", k, a) for k in (3, 6, 7, 14)
                    for a in (True, False)]
                 + [("ternary", 0, False)])


def encode_codec(kind, k, absolute):
    from repro_torch.comm import codec as CD
    return CD.TernaryCodec() if kind == "ternary" else \
        wire_codec(kind, k, absolute)


# #14 and #8 at every shape of their layout: a lane holding 4 blocks, a
# block across 8 and 16 lanes, the warp, 8 and 32 chunks of a lane
BLOCKWISE_BLOCKS = (1, 32, 64, 256, 1024, 4096)


def check_encode_kernels(torch, dev):
    """#5 (each kind, the absolute and the amax scale, the ternary kind
    on uniforms from one seeded generator on both sides, zero input),
    K6 on its rows (the ternary kind new), #14 and #8 bitwise against
    their plain versions over n_rows {1, 2, 4} x chunks {1, 7, 1000003};
    then at the 8-layer w_gate stack: #5 ternary, log:6 and uniform:7
    (amax scales), K6 ternary, #14 and #8, bitwise and timed against
    their bounds, the plain versions and, for #5's amax launch,
    ``x.abs().amax()``. Returns
    the kernel rows, the timing table and the count of cases."""
    from repro_torch.comm import kernels as K
    cases = 0
    for c in (1, 7, 1000003):
        for n_rows in (1, 2, 4):
            n = n_rows * c - (n_rows - 1)
            gen = torch.Generator(device=dev).manual_seed(n_rows * 100 + c)
            x = torch.randn(n, generator=gen, device=dev)
            u = torch.rand(n, generator=gen, device=dev)
            for zero in (False, True) if c == 7 else (False,):
                if zero:
                    x.zero_()
                for kind, k, absolute in ENCODE_CODECS:
                    codec = encode_codec(kind, k, absolute)
                    enc = [K.encode_rows(x, codec, n_rows, u=u, backend=b)
                           for b in ("cuda", "torch")]
                    if not all(bits_equal(torch, a, b)
                               for a, b in zip(*enc)):
                        raise AssertionError(
                            f"#5 {codec.spec} differs from its plain version "
                            f"(n_rows={n_rows}, c={c}, zero={zero})")
                    scales = (torch.rand(n_rows, generator=gen, device=dev)
                              + 0.5) * enc[0][1]
                    if not bits_equal(torch, K.decode_rows(
                            enc[0][0], scales, codec, c, backend="cuda"),
                            K.decode_rows(enc[0][0], scales, codec, c,
                                          backend="torch")):
                        raise AssertionError(
                            f"K6 {codec.spec} differs from its plain version "
                            f"(n_rows={n_rows}, c={c}, zero={zero})")
                    cases += 1
                for fn in (K.blockwise_quantize, K.blockwise_encode):
                    for blk in BLOCKWISE_BLOCKS:
                        if not all(bits_equal(torch, a, b) for a, b in zip(
                                fn(x, blk, backend="cuda"),
                                fn(x, blk, backend="torch"))):
                            raise AssertionError(
                                f"{fn.__name__} differs from its plain "
                                f"version (n={n}, block {blk}, zero={zero})")
                        cases += 1
    # the w_gate stack of the 8-layer cell, as the main paths give it at
    # one worker: the terngrad gradient (one payload row), ef_sgd's
    # Delta+e, a leaf through Codec.encode
    d, f = YI["d"], YI["f"]
    n = TRAIN_LAYERS * d * f
    nb = -(-n // K.BLOCK)
    gen = torch.Generator(device=dev).manual_seed(41)
    x = torch.randn(n, generator=gen, device=dev).mul_(1e-3)
    u = torch.rand(n, generator=gen, device=dev)
    tern, log6 = encode_codec("ternary", 0, False), wire_codec("log", 6)
    table, rows = [], []
    t = {}
    # no one PyTorch call computes #5; its first launch's yardstick, for
    # the table and kept out of the kernels line
    amax_ms = cuda_ms(torch, lambda i: x.abs().amax(), 5, 1)
    for name, codec, ubytes in (("encode_rows_ternary", tern, 4),
                                ("encode_rows_log", log6, 0),
                                ("encode_rows_uniform",
                                 wire_codec("uniform", 7, False), 0)):
        pk, sk = K.encode_rows(x, codec, 1, u=u, backend="cuda")
        pp, sp = K.encode_rows(x, codec, 1, u=u, backend="torch")
        if not (bits_equal(torch, pk, pp) and bits_equal(torch, sk, sp)):
            raise AssertionError(f"#5 {codec.spec} differs from its plain "
                                 f"version at the w_gate stack")
        del pp
        nbytes = pk.numel()
        t[name] = (codec.spec,
                   cuda_ms(torch, lambda i: K.encode_rows(
                       x, codec, 1, u=u, backend="cuda"), 5, 1),
                   cuda_ms(torch, lambda i: K.encode_rows(
                       x, codec, 1, u=u, backend="torch"), 2, 1),
                   None, bound_ms((4 + 4 + ubytes) * n + nbytes + 4))
        if name == "encode_rows_ternary":
            scales = sk.reshape(1)
            out = torch.empty(n, device=dev)
            K.decode_rows(pk, scales, codec, n, backend="cuda", out=out)
            if not bits_equal(torch, out, K.decode_rows(
                    pk, scales, codec, n, backend="torch").reshape(-1)):
                raise AssertionError("K6 ternary differs from its plain "
                                     "version at the w_gate stack")
            t["decode_rows_ternary"] = (
                codec.spec,
                cuda_ms(torch, lambda i: K.decode_rows(
                    pk, scales, codec, n, backend="cuda", out=out), 5, 1),
                cuda_ms(torch, lambda i: K.decode_rows(
                    pk, scales, codec, n, backend="torch"), 2, 1),
                None, bound_ms(nbytes + 4 * n + 4))
            del out
        del pk
    for name, fn, out_bytes in (("blockwise_quantize", K.blockwise_quantize,
                                 n),
                                ("blockwise_encode", K.blockwise_encode,
                                 -(-n // 4))):
        for blk in (256, 64):
            a, b = fn(x, blk, backend="cuda"), fn(x, blk, backend="torch")
            if not all(bits_equal(torch, p, q) for p, q in zip(a, b)):
                raise AssertionError(f"{name} differs from its plain version "
                                     f"at the w_gate stack, block {blk}")
            del a, b
            nbk = -(-n // blk)
            t[name if blk == 256 else f"{name}_b{blk}"] = (
                f"blockwise:{blk}",
                cuda_ms(torch, lambda i: fn(x, blk, backend="cuda"), 5, 1),
                cuda_ms(torch, lambda i: fn(x, blk, backend="torch"), 2, 1),
                None, bound_ms(4 * n + out_bytes + 4 * nbk))
    src = {"encode_rows": ("src/repro_torch/csrc/codec.cu",
                           "src/repro/comm/kernels.py:203"),
           "decode_rows": ("src/repro_torch/csrc/codec.cu",
                           "src/repro/comm/kernels.py:286"),
           "blockwise_quantize": ("src/repro_torch/csrc/blockwise.cu",
                                  "src/repro/comm/kernels.py:618"),
           "blockwise_encode": ("src/repro_torch/csrc/blockwise.cu",
                                "src/repro/comm/kernels.py:408")}
    for name, (spec, ms, plain, lib, (bnd, by)) in t.items():
        table.append(dict(name=name, spec=spec, shape=[n], ms=ms,
                          plain_ms=plain, library_ms=lib, bound_ms=bnd,
                          bound_by=by, share_of_bound=bnd / ms,
                          gbs=(bnd * 1e-3 * HBM_BYTES_PER_S) / ms / 1e6))
        if name.startswith("encode_rows"):
            table[-1]["amax_library_ms"] = amax_ms
        if name.endswith("_b64"):     # a reading beside its kernel's row
            continue
        source, replaces = src[name.rsplit("_", 1)[0] if name.startswith(
            ("encode_rows", "decode_rows")) else name]
        rows.append(dict(name=name, route="cuda", source=source,
                         replaces=replaces, max_abs_err=0.0, ms=ms,
                         plain_ms=plain, bound_ms=bnd, bound_by=by,
                         library_ms=lib, shape=[n]))
    del x, u
    torch.cuda.empty_cache()
    return rows, table, cases


# ---------------------------------------------------------------------------
# phase 3, the last three kernels: #10 log quantize, #13 ternary quantize,
# #9 lane pack/unpack; their planted faults
# ---------------------------------------------------------------------------

# the planted faults, each a text edit of one line of the kernels' sources
# (built into a library of their own under build/planted, never the
# port's): #9 packs with its lane bias off by one, #13 compares u <= p,
# K7 and #5 on 6-bit lanes put the last code of a chunk's last float4 (the
# last vector of a full chunk) one above its value
PLANTED = {"grids.cuh": ("val |= ((unsigned int)(codes[j] + bias) & mask)",
                         "val |= ((unsigned int)(codes[j] + bias + 1) & "
                         "mask)"),
           "quantize.cu": ("return u < p ?", "return u <= p ?"),
           "codec.cu": ("f = field4<BITS>(cd);",
                        "f = field4<BITS>(cd) + (BITS == 6 && i == nf4 - 1 "
                        "? 1ull << 18 : 0ull);"),
           "pack.cu": None}
PLANTED_SOURCES = ("pack.cu", "quantize.cu", "codec.cu")


def start_planted_build(build):
    """Start nvcc on the planted copies of PLANTED_SOURCES (with their
    edited grids.cuh), one process each, beside the port's own build;
    returns what ``finish_planted_build`` waits for."""
    out = build.BUILD_DIR / "planted"
    out.mkdir(parents=True, exist_ok=True)
    for name, edit in PLANTED.items():
        text = (build.CSRC / name).read_text()
        if edit is not None:
            if text.count(edit[0]) != 1:
                raise AssertionError(f"planted fault: {edit[0]!r} is not one "
                                     f"line of {name}")
            text = text.replace(edit[0], edit[1])
        (out / name).write_text(text)
    procs = []
    for src in PLANTED_SOURCES:
        obj = out / (src[:-3] + ".o")
        procs.append((obj, subprocess.Popen(
            [build.nvcc_path(), *build.CFLAGS, "-I", str(out), "-c",
             str(out / src), "-o", str(obj)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    return out, procs


def finish_planted_build(build, started):
    """Wait for the planted objects, link them and load the library with
    the port's C signatures."""
    import ctypes
    out, procs = started
    for obj, proc in procs:
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"planted build of {obj.name} failed:\n{text}")
    so = out / "libplanted.so"
    subprocess.run([build.nvcc_path(), *build.ARCH_FLAGS, "-shared", "-o",
                    str(so), *(str(o) for o, _ in procs), "-lcudart"],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in build.SIGNATURES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return lib


def through(build, lib, fn):
    """``fn()`` with the wrappers launching ``lib``'s kernels."""
    saved = build._lib
    build._lib = lib
    try:
        return fn()
    finally:
        build._lib = saved


LOG_KG = (1, 2, 4, 6, 8, 30, 126)
PACK_BITS = (2, 3, 4, 6, 8, 16)


def check_slice6_kernels(torch, dev, build, planted):
    """#10, #13 and #9 bitwise against their plain versions: #10 at k_g
    LOG_KG on random, zero and decision-point inputs; #13 on uniforms from
    one seeded generator, u = p exactly among them, x = 0 and a zero
    scale; #9 at every lane width over R {1, 2, 4} x c {1, 7, 1000003}
    (each code type); then each at the 8-layer w_gate stack (#9 at ef_sgd's
    2-bit lanes, and at 16 bits), timed against its bound and its plain
    version. The planted faults (``planted``: the lane bias off by one,
    u <= p, K7's 6-bit code off by one) must fail the same gates (K7's:
    the gate of check_wire_kernels, payload and residual bitwise).
    Returns the kernel rows, the timing table, the count of cases and the
    faults' readings."""
    from repro_torch.comm import codec as CD
    from repro_torch.comm import kernels as K
    from repro_torch.opt import grids
    cases = 0
    for n in (1, 7, 1000003):
        gen = torch.Generator(device=dev).manual_seed(60 + n)
        x = torch.randn(n, generator=gen, device=dev)
        x[::11] = 0.0
        for k_g in LOG_KG:
            t = torch.tensor(grids.log_thresholds(k_g), device=dev)
            pts = torch.cat([t, -t, torch.nextafter(t, torch.zeros_like(t))])
            xs = (x, torch.zeros_like(x), pts)
            for xx in xs:
                for s in (xx.abs().amax().clamp_min(1e-30),
                          torch.tensor(1.0, device=dev)):
                    if not bits_equal(torch, K.log_quantize(
                            xx, s, k_g, backend="cuda"), K.log_quantize(
                            xx, s, k_g, backend="torch")):
                        raise AssertionError(f"#10 differs from its plain "
                                             f"version (k_g={k_g}, n={n})")
                    cases += 1
        u = torch.rand(n, generator=gen, device=dev)
        s = x.abs().amax()
        u[1::3] = (x.abs() / s)[1::3]          # u == p: code 0
        for xx, ss in ((x, s), (torch.zeros_like(x), s),
                       (x, torch.tensor(0.0, device=dev))):
            if not bits_equal(torch, K.ternary_quantize(
                    xx, u, ss, backend="cuda"), K.ternary_quantize(
                    xx, u, ss, backend="torch")):
                raise AssertionError(f"#13 differs from its plain version "
                                     f"(n={n})")
            cases += 1
        for bits in PACK_BITS:
            lim = 2 ** (bits - 1)
            for rows in (1, 2, 4):
                for dt in (torch.int8, torch.int16):
                    if bits == 16 and dt == torch.int8:
                        continue
                    codes = torch.randint(-lim, lim, (rows, n), generator=gen,
                                          device=dev).to(dt)
                    pk = K.pack_rows(codes, bits, backend="cuda")
                    uk = K.unpack_rows(pk, bits, n, backend="cuda")
                    if not (bits_equal(torch, pk, K.pack_rows(
                            codes, bits, backend="torch")) and bits_equal(
                            torch, uk, K.unpack_rows(
                                pk, bits, n, backend="torch").contiguous())
                            and torch.equal(uk.to(torch.int32),
                                            codes.to(torch.int32))):
                        raise AssertionError(f"#9 at {bits} bits differs "
                                             f"from its plain version "
                                             f"(R={rows}, c={n}, {dt})")
                    cases += 1
    # the planted faults must fail the gates that pass above
    gen = torch.Generator(device=dev).manual_seed(67)
    codes = torch.randint(-2, 2, (2, 1000003), generator=gen,
                          device=dev).to(torch.int8)
    fp = through(build, planted, lambda: K.pack_rows(codes, 2,
                                                     backend="cuda"))
    pp = K.pack_rows(codes, 2, backend="torch")
    x = torch.randn(1000003, generator=gen, device=dev)
    s = x.abs().amax()
    u = torch.rand(1000003, generator=gen, device=dev)
    u[::5] = (x.abs() / s)[::5]
    ft = through(build, planted, lambda: K.ternary_quantize(
        x, u, s, backend="cuda"))
    tp = K.ternary_quantize(x, u, s, backend="torch")
    # K7 at log:30 (6-bit lanes) on x at one row and at three rows
    log30 = CD.get_codec("log:30")
    k7 = {}
    for n_rows in (1, 3):
        fk = through(build, planted, lambda: K.ef_encode_rows(
            x, s, log30, n_rows, backend="cuda"))
        pk = K.ef_encode_rows(x, s, log30, n_rows, backend="torch")
        k7[n_rows] = (float((fk[0] != pk[0]).float().mean()),
                      bits_equal(torch, fk[0], pk[0])
                      and bits_equal(torch, fk[1], pk[1]))
    faults = {"pack_bias_off_by_one": float((fp != pp).float().mean()),
              "ternary_u_le_p": float((ft != tp).float().mean()),
              "k7_6bit_last_vector": k7[1][0],
              "k7_6bit_last_vector_3_rows": k7[3][0]}
    if (bits_equal(torch, fp, pp) or bits_equal(torch, ft, tp)
            or k7[1][1] or k7[3][1]):
        raise AssertionError(f"a planted fault passed its gate: {faults}")
    del fp, pp, ft, tp, codes, fk, pk

    # the w_gate stack of the 8-layer cell
    d, f = YI["d"], YI["f"]
    n = TRAIN_LAYERS * d * f
    x = torch.randn(n, generator=gen, device=dev).mul_(1e-3)
    u = torch.rand(n, generator=gen, device=dev)
    s = x.abs().amax()
    t = {}
    ck = K.log_quantize(x, s, 6, backend="cuda")
    if not bits_equal(torch, ck, K.log_quantize(x, s, 6, backend="torch")):
        raise AssertionError("#10 differs from its plain version at the "
                             "w_gate stack")
    t["log_quantize"] = ("log:6", cuda_ms(torch, lambda i: K.log_quantize(
        x, s, 6, backend="cuda"), 5, 1), cuda_ms(torch, lambda i: (
            K.log_quantize(x, s, 6, backend="torch")), 2, 1),
        bound_ms(5 * n + 4), "src/repro_torch/csrc/quantize.cu",
        "src/repro/comm/kernels.py:501")
    del ck
    ck = K.ternary_quantize(x, u, s, backend="cuda")
    if not bits_equal(torch, ck, K.ternary_quantize(x, u, s,
                                                    backend="torch")):
        raise AssertionError("#13 differs from its plain version at the "
                             "w_gate stack")
    t["ternary_quantize"] = ("terngrad", cuda_ms(
        torch, lambda i: K.ternary_quantize(x, u, s, backend="cuda"), 5, 1),
        cuda_ms(torch, lambda i: K.ternary_quantize(
            x, u, s, backend="torch"), 2, 1), bound_ms(9 * n + 4),
        "src/repro_torch/csrc/quantize.cu", "src/repro/comm/kernels.py:595")
    del u
    # #9 on 2-bit codes of the stack (the ternary codes just made), one
    # row: ef_sgd's exchange packs its sign codes so at one worker
    c2 = ck.reshape(1, n)
    del x
    p2 = K.pack_rows(c2, 2, backend="cuda")
    if not (bits_equal(torch, p2, K.pack_rows(c2, 2, backend="torch"))
            and bits_equal(torch, K.unpack_rows(p2, 2, n, backend="cuda"),
                           K.unpack_rows(p2, 2, n, backend="torch")
                           .contiguous())):
        raise AssertionError("#9 (2 bits) differs from its plain version at "
                             "the w_gate stack")
    nb2 = p2.numel()
    t["pack_rows"] = ("2-bit lanes", cuda_ms(torch, lambda i: K.pack_rows(
        c2, 2, backend="cuda"), 5, 1), cuda_ms(torch, lambda i: K.pack_rows(
            c2, 2, backend="torch"), 2, 1), bound_ms(n + nb2),
        "src/repro_torch/csrc/pack.cu", "src/repro/comm/kernels.py:436")
    t["unpack_rows"] = ("2-bit lanes", cuda_ms(
        torch, lambda i: K.unpack_rows(p2, 2, n, backend="cuda"), 5, 1),
        cuda_ms(torch, lambda i: K.unpack_rows(p2, 2, n, backend="torch"),
                2, 1), bound_ms(nb2 + n), "src/repro_torch/csrc/pack.cu",
        "src/repro/comm/kernels.py:457")
    del c2, p2, ck
    torch.cuda.empty_cache()
    c16 = torch.randint(-2 ** 15, 2 ** 15, (1, n), generator=gen,
                        device=dev).to(torch.int16)
    p16 = K.pack_rows(c16, 16, backend="cuda")
    if not (bits_equal(torch, p16, K.pack_rows(c16, 16, backend="torch"))
            and bits_equal(torch, K.unpack_rows(p16, 16, n, backend="cuda"),
                           c16)):
        raise AssertionError("#9 (16 bits) differs from its plain version at "
                             "the w_gate stack")
    sixteen = dict(pack_ms=cuda_ms(torch, lambda i: K.pack_rows(
        c16, 16, backend="cuda"), 5, 1), unpack_ms=cuda_ms(
        torch, lambda i: K.unpack_rows(p16, 16, n, backend="cuda"), 5, 1),
        pack_plain_ms=cuda_ms(torch, lambda i: K.pack_rows(
            c16, 16, backend="torch"), 2, 1), bound_ms=bound_ms(4 * n)[0])
    del c16, p16
    torch.cuda.empty_cache()
    table, rows = [], []
    for name, (spec, ms, plain, (bnd, by), src, rep) in t.items():
        table.append(dict(name=name, spec=spec, shape=[n], ms=ms,
                          plain_ms=plain, library_ms=None, bound_ms=bnd,
                          bound_by=by,
                          gbs=(bnd * 1e-3 * HBM_BYTES_PER_S) / ms / 1e6))
        rows.append(dict(name=name, route="cuda", source=src, replaces=rep,
                         max_abs_err=0.0, ms=ms, plain_ms=plain,
                         bound_ms=bnd, bound_by=by, library_ms=None,
                         shape=[n]))
    table.append(dict(name="pack_rows/unpack_rows", spec="16-bit lanes",
                      shape=[n], **sixteen))
    return rows, table, cases, faults


# ---------------------------------------------------------------------------
# phase 3, the adaptive plan's lanes besides log:6: K7, K6 at log:2 (3-bit
# lanes), log:30, log:126 (the reference's deep decision points and
# levels) and the 14-bit uniform lane on 16-bit lanes; #10, K11 at the
# deep grids; #5 at every lane width
# ---------------------------------------------------------------------------

DEEP_SPECS = ("log:2", "log:30", "log:126", "uniform_amax:14:w16")
DEEP_LOG = ("log:30", "log:126")    # #10 and K11 timed here
# #5 at the lane widths check_encode_kernels does not time (ternary,
# log:6 and the uniform:7 wire there): a reading each, no kernels row
ENCODE_WIDTH_SPECS = ("log:2", "log:30", "log:126", "uniform_amax:14:w16")
# K7 on the 2-bit lanes no main path gives it: a reading, no kernels row
K7_READING_SPECS = ("uniform:1:w2",)


def lane_row(name, spec):
    """The kernels line's name of a kernel at one of the new lanes."""
    return f"{name}@{spec}"


def check_deep_lanes(torch, dev):
    """At the 8-layer w_gate stack (Delta+e-like values, 1e-3 randn, the
    amax scale): K7 and K6 at each of DEEP_SPECS, #10 and K11 at
    DEEP_LOG, each bitwise its plain version and timed against its bound
    and its plain version; #5 at ENCODE_WIDTH_SPECS, bitwise and timed
    (with its K3 launch, and K3 alone beside it); K7 at K7_READING_SPECS,
    bitwise and timed. Returns the kernel rows and the table."""
    from repro_torch.comm import codec as CD
    from repro_torch.comm import kernels as K
    from repro_torch.opt import engine as E
    d, f = YI["d"], YI["f"]
    n = TRAIN_LAYERS * d * f
    gen = torch.Generator(device=dev).manual_seed(32)
    x = torch.randn(n, generator=gen, device=dev).mul_(1e-3)
    scale = E.amax_scale(x.abs().amax())
    rows, table = [], []

    def add(name, spec, ms, plain, bnd_by, src, rep_line):
        bnd, by = bnd_by
        table.append(dict(name=name, spec=spec, shape=[n], ms=ms,
                          plain_ms=plain, bound_ms=bnd, bound_by=by,
                          share_of_bound=bnd / ms,
                          gbs=(bnd * 1e-3 * HBM_BYTES_PER_S) / ms / 1e6))
        rows.append(dict(name=lane_row(name, spec), route="cuda",
                         source=src, replaces=rep_line, max_abs_err=0.0,
                         ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                         library_ms=None, shape=[n]))
    for spec in DEEP_SPECS:
        codec = CD.get_codec(spec)
        pk, ek = K.ef_encode_rows(x, scale, codec, 1, backend="cuda")
        pp, ep = K.ef_encode_rows(x, scale, codec, 1, backend="torch")
        if not (bits_equal(torch, pk, pp) and bits_equal(torch, ek, ep)):
            raise AssertionError(f"K7 {spec} differs from its plain version "
                                 f"at the w_gate stack")
        del pp, ep
        scales = scale.reshape(1)
        out = torch.empty(n, device=dev)
        K.decode_rows(pk, scales, codec, n, backend="cuda", out=out)
        if not bits_equal(torch, out, K.decode_rows(
                pk, scales, codec, n, backend="torch").reshape(-1)):
            raise AssertionError(f"K6 {spec} differs from its plain version "
                                 f"at the w_gate stack")
        nb = pk.numel()
        add("ef_encode_rows", spec,
            cuda_ms(torch, lambda i: K.ef_encode_rows(
                x, scale, codec, 1, backend="cuda", out=ek), 5, 1),
            cuda_ms(torch, lambda i: K.ef_encode_rows(
                x, scale, codec, 1, backend="torch"), 2, 1),
            bound_ms(8 * n + nb + 4), "src/repro_torch/csrc/codec.cu",
            "src/repro/comm/kernels.py:356")
        add("decode_rows", spec,
            cuda_ms(torch, lambda i: K.decode_rows(
                pk, scales, codec, n, backend="cuda", out=out), 5, 1),
            cuda_ms(torch, lambda i: K.decode_rows(
                pk, scales, codec, n, backend="torch"), 2, 1),
            bound_ms(nb + 4 * n + 4), "src/repro_torch/csrc/codec.cu",
            "src/repro/comm/kernels.py:286")
        del pk, ek, out
        torch.cuda.empty_cache()
        if spec not in DEEP_LOG:
            continue
        k = codec.k
        ck = K.log_quantize(x, scale, k, backend="cuda")
        if not bits_equal(torch, ck, K.log_quantize(x, scale, k,
                                                    backend="torch")):
            raise AssertionError(f"#10 {spec} differs from its plain version "
                                 f"at the w_gate stack")
        dk = K.log_dequantize(ck, scale, k, backend="cuda")
        if not bits_equal(torch, dk, K.log_dequantize(ck, scale, k,
                                                      backend="torch")):
            raise AssertionError(f"K11 {spec} differs from its plain version "
                                 f"at the w_gate stack")
        del dk
        add("log_quantize", spec,
            cuda_ms(torch, lambda i: K.log_quantize(x, scale, k,
                                                    backend="cuda"), 5, 1),
            cuda_ms(torch, lambda i: K.log_quantize(x, scale, k,
                                                    backend="torch"), 2, 1),
            bound_ms(5 * n + 4), "src/repro_torch/csrc/quantize.cu",
            "src/repro/comm/kernels.py:501")
        add("log_dequantize", spec,
            cuda_ms(torch, lambda i: K.log_dequantize(ck, scale, k,
                                                      backend="cuda"), 5, 1),
            cuda_ms(torch, lambda i: K.log_dequantize(ck, scale, k,
                                                      backend="torch"), 2, 1),
            bound_ms(5 * n + 4), "src/repro_torch/csrc/dequantize.cu",
            "src/repro/comm/kernels.py:524")
        del ck
        torch.cuda.empty_cache()
    for spec in K7_READING_SPECS:
        codec = CD.get_codec(spec)
        pk, ek = K.ef_encode_rows(x, scale, codec, 1, backend="cuda")
        pp, ep = K.ef_encode_rows(x, scale, codec, 1, backend="torch")
        if not (bits_equal(torch, pk, pp) and bits_equal(torch, ek, ep)):
            raise AssertionError(f"K7 {spec} differs from its plain version "
                                 f"at the w_gate stack")
        nb = pk.numel()
        del pk, pp, ep
        ms = cuda_ms(torch, lambda i: K.ef_encode_rows(
            x, scale, codec, 1, backend="cuda", out=ek), 5, 1)
        bnd, by = bound_ms(8 * n + nb + 4)
        table.append(dict(
            name="ef_encode_rows", spec=spec, shape=[n], ms=ms,
            plain_ms=cuda_ms(torch, lambda i: K.ef_encode_rows(
                x, scale, codec, 1, backend="torch"), 2, 1),
            bound_ms=bnd, bound_by=by, share_of_bound=bnd / ms,
            gbs=(bnd * 1e-3 * HBM_BYTES_PER_S) / ms / 1e6))
        del ek
        torch.cuda.empty_cache()
    amax_ms = cuda_ms(torch, lambda i: K.amax_rows(x.reshape(1, -1),
                                                   backend="cuda"), 5, 1)
    for spec in ENCODE_WIDTH_SPECS:
        codec = CD.get_codec(spec)
        pk, sk = K.encode_rows(x, codec, 1, backend="cuda")
        pp, sp = K.encode_rows(x, codec, 1, backend="torch")
        if not (bits_equal(torch, pk, pp) and bits_equal(torch, sk, sp)):
            raise AssertionError(f"#5 {spec} differs from its plain version "
                                 f"at the w_gate stack")
        nb = pk.numel()
        del pk, pp
        ms = cuda_ms(torch, lambda i: K.encode_rows(x, codec, 1,
                                                    backend="cuda"), 5, 1)
        bnd, by = bound_ms(8 * n + nb + 4)
        launch_bnd = bound_ms(4 * n + nb + 4)[0]
        table.append(dict(
            name="encode_rows", spec=spec, shape=[n], ms=ms,
            plain_ms=cuda_ms(torch, lambda i: K.encode_rows(
                x, codec, 1, backend="torch"), 2, 1),
            bound_ms=bnd, bound_by=by, share_of_bound=bnd / ms,
            gbs=(bnd * 1e-3 * HBM_BYTES_PER_S) / ms / 1e6,
            amax_ms=amax_ms, encode_launch_ms=ms - amax_ms,
            encode_launch_bound_ms=launch_bnd))
        torch.cuda.empty_cache()
    del x
    torch.cuda.empty_cache()
    return rows, table


def by_spec_launches(K):
    """The new lanes' launches so far (``comm.kernels.by_spec``), by the
    kernels line's row names."""
    names = {"ef_encode": "ef_encode_rows", "decode": "decode_rows",
             "log_quantize": "log_quantize",
             "log_dequantize": "log_dequantize"}
    return {lane_row(names[kern], spec): K.by_spec[kern].get(spec, 0)
            for kern in names for spec in DEEP_SPECS
            if spec in DEEP_LOG or kern in ("ef_encode", "decode")}


def clear_by_spec(K):
    for d in K.by_spec.values():
        d.clear()


# ---------------------------------------------------------------------------
# phase 5: Algorithm 1 training of full-width yi-6b cut to 8 layers
# ---------------------------------------------------------------------------

TRAIN_COUNTERS = {"threefry_keys": ("P", "keys_launches"),
                  "amax_rows": ("K", "amax_launches"),
                  "uniform_quantize_rows": ("K", "quantize_launches"),
                  "uniform_dequantize_rows": ("K", "dequantize_launches"),
                  "log_dequantize": ("K", "log_dequantize_launches"),
                  "adam_moments": ("A", "moments_launches"),
                  "ef_quantize": ("A", "ef_quantize_launches")}
UPDATE_KERNELS = ("adam_moments_kernel", "ef_quantize_kernel",
                  "log_dequantize_kernel")
QX_KERNELS = ("amax_rows_kernel", "uniform_quantize_kernel",
              "uniform_dequantize_kernel")


def run_watched(torch, sess, steps: int):
    """``sess.run(steps)`` with every step's loss kept (device tensors,
    read after the run) and the synchronizing operations that torch's
    sync debug mode reports counted at each step's start and around each
    loss harvest."""
    import warnings
    losses, starts, harvests, caught = [], [], [], []

    def nsync():
        return sum("synchroniz" in str(w.message) for w in caught)

    program_step, program_harvest = sess._program.step, sess.harvest_losses

    def step(state, batch, hp=None, t=None):
        starts.append(nsync())
        state, metrics = program_step(state, batch, hp, t)
        losses.append(metrics["loss"])
        return state, metrics

    def harvest():
        n0 = nsync()
        out = program_harvest()
        harvests.append(nsync() - n0)
        return out

    sess._program.step, sess.harvest_losses = step, harvest
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            sess.run(steps)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            total = nsync()
    finally:
        torch.cuda.set_sync_debug_mode("default")
        sess._program.step = program_step
        del sess.harvest_losses
    return dict(losses=[float(x) for x in torch.stack(losses).cpu()],
                starts=starts, harvests=harvests, syncs=total, run_s=run_s,
                messages=sorted({str(w.message)[:160] for w in caught}))


def check_run(w, stats, launches, plain, what: str, steps: int,
              falling: bool = True) -> None:
    """The gates of a training run: finite losses whose last-3 mean is
    below the first (unless ``falling`` is off), every kernel of the path
    launched, no plain version on the card, and from the start of step 2
    on no synchronizing operation but the final loss harvest's own (two
    session reads in all: after the first and the last step)."""
    vals = w["losses"]
    if len(vals) != steps or not all(math.isfinite(x) for x in vals):
        raise AssertionError(f"{what} losses not finite: {vals}")
    if falling and not sum(vals[-3:]) / 3 < vals[0]:
        raise AssertionError(f"{what} loss did not fall: {vals}")
    if any(n == 0 for n in launches.values()):
        raise AssertionError(f"a {what} kernel never launched: {launches}")
    if plain:
        raise AssertionError(f"{plain} plain-version calls on the card "
                             f"({what})")
    steady = w["syncs"] - w["starts"][1] - w["harvests"][-1]
    if stats["syncs"] != 2 or len(w["harvests"]) != 2 or steady:
        raise AssertionError(f"{what}: host syncs in steady state: {steady} "
                             f"beyond the harvest (stats {stats}, at step "
                             f"starts {w['starts']} of {w['syncs']}): "
                             f"{w['messages']}")


def step_phases(torch, opt, p, s, grads_at, fields=("m", "v", "e")):
    """One Algorithm 1 step's phases on the device (CUDA events; the
    device is busy through the step): the Q_x forward copy, forward +
    backward, the update's kernels, apply_updates; on a copy of the
    state's ``fields`` (those the update writes in place), the mean of two
    rounds after a warm one."""
    from repro_torch.core.qadam import apply_updates
    from repro_torch.tree import tree_leaves

    def flat(tree):     # a tree's leaves as a flat dict, in one order
        return dict(enumerate(tree_leaves(tree)))

    s = s._replace(key=s.key.clone(), **{f: {k: t.clone() for k, t in flat(
        getattr(s, f)).items()} for f in fields})
    phases = {"forward_params": 0.0, "forward_backward": 0.0, "update": 0.0,
              "apply_updates": 0.0}
    for rep in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        fp = opt.forward_params(p, None)
        ev[1].record()
        grads = grads_at(fp)
        del fp
        ev[2].record()
        upd, _ = opt.update(dict(enumerate(grads)), s)
        del grads
        ev[3].record()
        apply_updates(flat(p), upd)
        ev[4].record()
        del upd
        ev[4].synchronize()
        if rep:      # the first round warms up
            for i, k in enumerate(phases):
                phases[k] += ev[i].elapsed_time(ev[i + 1]) / 2
    return phases


def train(torch, dev, mods):
    from repro_torch.configs import get_config
    from repro_torch.core.qadam import (QAdamConfig, QAdamState,
                                        apply_updates, qadam)
    from repro_torch.data.pipeline import batch_for_model
    from repro_torch.models.model import Model
    from repro_torch.train.session import (SessionConfig, TrainSession,
                                           stage_batch)
    from repro_torch.tree import tree_leaves, tree_unflatten
    K, A = mods["K"], mods["A"]
    cfg = dataclasses.replace(get_config("yi-6b"), n_layers=TRAIN_LAYERS)
    model = Model(cfg)
    ocfg = QAdamConfig(**TRAIN_OPT)
    opt = qadam(ocfg)

    def loss_fn(p, b):
        ls, nt = model.loss(p, b)
        return ls / nt

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # the main path, with every count at 0 just before it
    for mod, attr in TRAIN_COUNTERS.values():
        setattr(mods[mod], attr, 0)
    K.plain_on_cuda = A.plain_on_cuda = mods["P"].plain_on_cuda = 0
    params = model.init(seed=0, device=dev)
    n_params = sum(p.numel() for p in tree_leaves(params))
    sess = TrainSession.from_optimizer(
        opt, loss_fn, params, batch_for_model(cfg, TRAIN_SEQ, TRAIN_BATCH,
                                              seed=0),
        SessionConfig(log_every=TRAIN_STEPS), log=lambda *_: None)
    del params
    w = run_watched(torch, sess, TRAIN_STEPS)
    peak = torch.cuda.max_memory_allocated()
    launches = {name: getattr(mods[mod], attr)
                for name, (mod, attr) in TRAIN_COUNTERS.items()}
    plain = K.plain_on_cuda + A.plain_on_cuda + mods["P"].plain_on_cuda
    stats = dict(sess.stats)
    vals = w["losses"]
    check_run(w, stats, launches, plain, "training", TRAIN_STEPS)

    # wall time per steady step, then the device's share by kernel
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sess.run(3)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / 3 * 1e3
    dev_ms, by_kernel = profile_ms(torch, lambda: sess.run(1), steps=2)
    upd_ms = sum(t for k, t in by_kernel if any(n in k for n in
                                                 UPDATE_KERNELS))
    qx_ms = sum(t for k, t in by_kernel if any(n in k for n in QX_KERNELS))

    # one update on captured gradients, kernels against plain versions
    state = sess.state
    p, s = state["params"], state["opt"]
    state_bytes = sum(t.numel() * t.element_size() for t in
                      tree_leaves(p) + tree_leaves(s.m) + tree_leaves(s.v)
                      + tree_leaves(s.e))
    batch = stage_batch(next(batch_for_model(cfg, TRAIN_SEQ, TRAIN_BATCH,
                                             seed=1)), dev)

    def grads_at(fp):
        leaves = [l.detach().requires_grad_() for l in tree_leaves(fp)]
        with torch.enable_grad():
            return torch.autograd.grad(loss_fn(tree_unflatten(fp, leaves),
                                               batch), leaves)

    grads = grads_at(opt.forward_params(p, s))
    for g, pl, m, v, e in zip(grads, tree_leaves(p), tree_leaves(s.m),
                              tree_leaves(s.v), tree_leaves(s.e)):
        # Q_x of the trained leaf (K3, K4, K12 on a large one)
        fk, fp = (qadam(dataclasses.replace(ocfg, backend=backend))
                  .forward_params({"x": pl})["x"]
                  for backend in ("cuda", "torch"))
        if not bits_equal(torch, fk, fp):
            raise AssertionError(f"captured-state forward_params through the "
                                 f"kernels differs from the plain versions "
                                 f"(leaf {tuple(pl.shape)})")
        del fk, fp
        outs = []
        for backend in ("cuda", "torch"):
            # update consumes its state (in place): each side gets a copy
            sub = QAdamState(count=s.count, m={"x": m.clone()},
                             v={"x": v.clone()}, e={"x": e.clone()},
                             key=s.key.clone())
            u, s2 = qadam(dataclasses.replace(ocfg, backend=backend)).update(
                {"x": g}, sub)
            outs.append((apply_updates({"x": pl}, u)["x"], s2.m["x"],
                         s2.v["x"], s2.e["x"]))
        for what, a, b in zip(("params", "m", "v", "e"), *outs):
            if not bits_equal(torch, a, b):
                raise AssertionError(f"captured-gradient update: {what} "
                                     f"through the kernels differs from the "
                                     f"plain versions (leaf {tuple(g.shape)})")
        del outs
    del grads
    phases = step_phases(torch, opt, p, s, grads_at)
    sess.close()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    return dict(launches=launches, losses=vals, stats=stats,
                syncs_at_step_starts=w["starts"],
                syncs_by_harvest=w["harvests"], sync_warnings=w["syncs"],
                sync_messages=w["messages"], run_s=w["run_s"],
                step_wall_ms=wall_ms, step_device_ms=dev_ms,
                device_idle=1 - dev_ms / wall_ms,
                update_kernels_ms=upd_ms, qx_kernels_ms=qx_ms,
                step_kernels=by_kernel[:16], phases_ms=phases,
                tokens_per_s=tokens / wall_ms
                * 1e3, peak_bytes=peak, state_bytes=state_bytes,
                n_params=n_params)


# ---------------------------------------------------------------------------
# phase 5b: the Algorithm 1 baselines on the same cut
# ---------------------------------------------------------------------------

# the baselines' learning rates, at which the loss falls over
# BASELINE_STEPS steps at this cut (the distributed twins' of phase 7)
EF_SGDM_ALPHA, TERNGRAD_SGD_ALPHA = 1e-3, 1e-3
BASELINE_STEPS = 8
ALG1_BASELINES = {
    # name: (optimizer of core.qadam on a backend, its kernels' counters,
    # its update kernels' names in the profile)
    "ef_sgdm": (lambda Q, b=None: Q.ef_sgdm(
        alpha=EF_SGDM_ALPHA, beta=0.9, grad_q="blockwise:256", backend=b),
        {"blockwise_quantize": ("K", "blockwise_quantize_launches"),
         "threefry_keys": ("P", "keys_launches")},
        ("blockwise_kernel",)),
    "terngrad_sgd": (lambda Q, b=None: Q.terngrad_sgd(
        alpha=TERNGRAD_SGD_ALPHA, backend=b),
        {"amax_rows": ("K", "amax_launches"),
         "ternary_quantize": ("K", "ternary_quantize_launches"),
         "threefry_keys": ("P", "keys_launches"),
         "threefry_uniform": ("P", "uniform_launches")},
        ("amax_rows_kernel", "ternary_quantize_kernel", "threefry")),
}
WQUAN_COUNTERS = {"amax_rows": ("K", "amax_launches"),
                  "uniform_quantize_rows": ("K", "quantize_launches"),
                  "uniform_dequantize_rows": ("K", "dequantize_launches")}


def alg1_baselines(torch, dev, mods):
    """Phase 5b: ``ef_sgdm`` (blockwise:256, beta 0.9) and
    ``terngrad_sgd`` through ``TrainSession.from_optimizer`` on the
    slice-2 cut, BASELINE_STEPS steps each, with the phase-5 gates (their
    kernels launched: #14; K3 and #13), the step's wall and device time,
    its phases and peak memory; one update on captured gradients from the
    trained state through the kernels and the plain versions (the same
    uniforms), bitwise; then ``wquan(params, k_x=7, absolute=False)`` on
    the trained parameters (K3, K4, K12 launched, bitwise the plain
    versions)."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.core import qadam as Q
    from repro_torch.data.pipeline import batch_for_model
    from repro_torch.models.model import Model
    from repro_torch.train.session import (SessionConfig, TrainSession,
                                           stage_batch)
    from repro_torch.tree import tree_leaves, tree_unflatten
    K, A = mods["K"], mods["A"]
    cfg = dataclasses.replace(get_config("yi-6b"), n_layers=TRAIN_LAYERS)
    model = Model(cfg)

    def loss_fn(p, b):
        ls, nt = model.loss(p, b)
        return ls / nt

    out = {}
    for name, (make, counters, kernels) in ALG1_BASELINES.items():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        # the main path, with every count at 0 just before it
        for mod, attr in counters.values():
            setattr(mods[mod], attr, 0)
        K.plain_on_cuda = A.plain_on_cuda = mods["P"].plain_on_cuda = 0
        opt = make(Q)
        sess = TrainSession.from_optimizer(
            opt, loss_fn, model.init(seed=0, device=dev),
            batch_for_model(cfg, TRAIN_SEQ, TRAIN_BATCH, seed=0),
            SessionConfig(log_every=BASELINE_STEPS), log=lambda *_: None)
        w = run_watched(torch, sess, BASELINE_STEPS)
        peak = torch.cuda.max_memory_allocated()
        launches = {k: getattr(mods[mod], attr)
                    for k, (mod, attr) in counters.items()}
        plain = K.plain_on_cuda + A.plain_on_cuda + mods["P"].plain_on_cuda
        stats = dict(sess.stats)
        check_run(w, stats, launches, plain, name, BASELINE_STEPS)
        res = dict(launches=launches, losses=w["losses"], stats=stats,
                   syncs_at_step_starts=w["starts"],
                   syncs_by_harvest=w["harvests"], run_s=w["run_s"],
                   peak_bytes=peak, alpha=(EF_SGDM_ALPHA if name == "ef_sgdm"
                                           else TERNGRAD_SGD_ALPHA))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sess.run(3)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / 3 * 1e3
        dev_ms, by_kernel = profile_ms(torch, lambda: sess.run(1), steps=2)
        res.update(step_wall_ms=wall_ms, step_device_ms=dev_ms,
                   device_idle=1 - dev_ms / wall_ms,
                   tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / wall_ms * 1e3,
                   quantizer_kernels_ms=sum(t for k, t in by_kernel if any(
                       n in k for n in kernels)),
                   step_kernels=by_kernel[:12])
        # one update on captured gradients, kernels against plain versions
        p, s = sess.state["params"], sess.state["opt"]
        batch = stage_batch(next(batch_for_model(cfg, TRAIN_SEQ, TRAIN_BATCH,
                                                 seed=1)), dev)

        def grads_at(fp):
            leaves = [l.detach().requires_grad_() for l in tree_leaves(fp)]
            with torch.enable_grad():
                return torch.autograd.grad(loss_fn(
                    tree_unflatten(fp, leaves), batch), leaves)

        grads = grads_at(p)
        for g, m, v, e in zip(grads, tree_leaves(s.m), tree_leaves(s.v),
                              tree_leaves(s.e)):
            outs = []
            for backend in ("cuda", "torch"):
                sub = s._replace(m={"x": m.clone()}, v={"x": v.clone()},
                                 e={"x": e.clone()}, key=s.key.clone())
                u, s2 = make(Q, backend).update({"x": g}, sub)
                outs.append((u["x"], s2.m["x"], s2.v["x"], s2.e["x"]))
            for what, a, b in zip(("update", "m", "v", "e"), *outs):
                if not bits_equal(torch, a, b):
                    raise AssertionError(
                        f"{name}: captured-gradient update ({what}) through "
                        f"the kernels differs from the plain versions (leaf "
                        f"{tuple(g.shape)})")
            del outs
        del grads
        res["phases_ms"] = step_phases(
            torch, opt, p, s, grads_at,
            fields=("m", "e") if name == "ef_sgdm" else ())
        out[name] = res
        if name == "terngrad_sgd":
            # WQuan on the trained parameters, counts at 0 just before it
            torch.cuda.synchronize()
            for mod, attr in WQUAN_COUNTERS.values():
                setattr(mods[mod], attr, 0)
            K.plain_on_cuda = 0
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            q = Q.wquan(p, k_x=7, absolute=False)
            ev[1].record()
            ev[1].synchronize()
            wl = {k: getattr(mods[mod], attr)
                  for k, (mod, attr) in WQUAN_COUNTERS.items()}
            if any(n == 0 for n in wl.values()) or K.plain_on_cuda:
                raise AssertionError(f"wquan: kernels {wl}, plain versions "
                                     f"on the card {K.plain_on_cuda}")
            for a, b in zip(tree_leaves(q), tree_leaves(p)):
                if not (bits_equal(torch, a, Q.wquan(
                        {"x": b}, k_x=7, absolute=False,
                        backend="torch")["x"]) and bool(
                        torch.isfinite(a).all())):
                    raise AssertionError(f"wquan through the kernels differs "
                                         f"from the plain versions (leaf "
                                         f"{tuple(b.shape)})")
            rel = math.sqrt(sum(float(((a.double() - b.double()) ** 2).sum())
                                for a, b in zip(tree_leaves(q),
                                                tree_leaves(p)))
                            / sum(float((b.double() ** 2).sum())
                                  for b in tree_leaves(p)))
            out["wquan"] = dict(launches=wl, ms=ev[0].elapsed_time(ev[1]),
                                rel_l2_to_trained=rel)
            del q
        sess.close()
        del sess, p, s, opt
    gc.collect()
    torch.cuda.empty_cache()
    # the graphed run at phase 7's depth, for the script's seconds
    # (tools/terngrad_probe.py times it at TRAIN_LAYERS)
    cut = Model(dataclasses.replace(cfg, n_layers=CUT_LAYERS))

    def cut_loss(p, b):
        ls, nt = cut.loss(p, b)
        return ls / nt
    out["terngrad_sgd"]["graph"] = terngrad_graph(
        torch, dev, mods, lambda chunk: TrainSession.from_optimizer(
            ALG1_BASELINES["terngrad_sgd"][0](Q), cut_loss,
            cut.init(seed=0, device=dev),
            batch_for_model(cut.cfg, TRAIN_SEQ, TRAIN_BATCH, seed=0),
            SessionConfig(log_every=BASELINE_STEPS, scan_chunk=chunk),
            log=lambda *_: None), BASELINE_STEPS,
        f"terngrad_sgd x {CUT_LAYERS} layers")
    return out


# ---------------------------------------------------------------------------
# phase 5c: Algorithm 1 with scan chunks, one CUDA graph a chunk
# ---------------------------------------------------------------------------

GRAPH_CHUNK = 4


def all_losses(sess, steps: int):
    """``sess.run(steps)``; every step's loss, from the session's own
    harvests (and one after the run)."""
    got = {}
    harvest = sess.harvest_losses

    def keep():
        out = harvest()
        got.update(out)
        return out
    sess.harvest_losses = keep
    try:
        sess.run(steps)
    finally:
        del sess.harvest_losses
    got.update(harvest())
    return [got[s] for s in sorted(got)]


def trajectory(torch, la, lb, pa, pb):
    """Two runs' losses and parameter lists: bitwise, and the largest
    loss rel difference and the parameters' rel L2 distance."""
    bitwise = la == lb and all(bits_equal(torch, a, b)
                               for a, b in zip(pa, pb))
    num = den = 0.0
    for a, b in zip(pa, pb):
        num += float(((a.double() - b.double()) ** 2).sum())
        den += float((b.double() ** 2).sum())
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(la, lb))
    return dict(bitwise=bitwise, loss_rel=loss_rel,
                param_rel_l2=(num / den) ** 0.5)


def terngrad_graph(torch, dev, mods, make, steps: int, what: str):
    """TernGrad under CUDA graphs: ``make(chunk)``'s session ``steps``
    steps step by step and with ``scan_chunk=GRAPH_CHUNK`` (one eager
    chunk, one capture, replays), both under deterministic algorithms:
    every loss and every state tensor bitwise (the eager run's state held
    on the host); one capture; the threefry kernels launched in the
    graphed run (counts at 0 just before it: the captured launches count
    once, replays not at all) and no plain version on the card; then the
    graphed step's wall and device ms over whole replays, its draws'
    device ms (the threefry kernels) and the run's peak bytes."""
    import gc
    from repro_torch.train.session import _tensor_leaves
    K, A, P = mods["K"], mods["A"], mods["P"]
    with deterministic(torch):
        ref = make(1)
        ref_losses = all_losses(ref, steps)
        ref_state = [(k, x.cpu()) for k, x in _tensor_leaves(ref.state)]
        ref.close()
        del ref
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        P.keys_launches = P.uniform_launches = 0
        K.plain_on_cuda = A.plain_on_cuda = P.plain_on_cuda = 0
        sess = make(GRAPH_CHUNK)
        losses = all_losses(sess, steps)
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = {"threefry_keys": P.keys_launches,
                "threefry_uniform": P.uniform_launches}
    plain = K.plain_on_cuda + A.plain_on_cuda + P.plain_on_cuda
    got = _tensor_leaves(sess.state)
    bitwise = losses == ref_losses and [k for k, _ in got] == [
        k for k, _ in ref_state] and all(
        bits_equal(torch, x.cpu(), y) for (_, x), (_, y) in
        zip(got, ref_state))
    del ref_state, got
    stats = dict(sess.stats)
    if not bitwise or stats["graph_captures"] != 1 or \
            stats["graph_replays"] != steps // GRAPH_CHUNK - 1 or \
            min(launches.values()) == 0 or plain:
        raise AssertionError(f"{what} with scan_chunk={GRAPH_CHUNK}: "
                             f"bitwise the step-by-step run {bitwise} "
                             f"(losses {losses} vs {ref_losses}), stats "
                             f"{stats}, launches {launches}, plain {plain}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sess.run(2 * GRAPH_CHUNK)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / (2 * GRAPH_CHUNK) * 1e3
    dev_ms, by_kernel = profile_ms(torch, lambda: sess.run(GRAPH_CHUNK),
                                   steps=2)
    dev_ms /= GRAPH_CHUNK
    draw_ms = sum(t for k, t in by_kernel if "threefry" in k) / GRAPH_CHUNK
    sess.close()
    del sess
    gc.collect()
    torch.cuda.empty_cache()
    return dict(chunk=GRAPH_CHUNK, steps=steps, losses=losses,
                bitwise=bitwise, stats=stats, launches=launches,
                peak_bytes=peak, step_wall_ms=wall, step_device_ms=dev_ms,
                device_idle=1 - dev_ms / wall, draw_ms=draw_ms,
                step_kernels=[(k, t / GRAPH_CHUNK) for k, t in
                              by_kernel[:8]])


def graph_train(torch, dev, mods):
    """Phase 5c: phase 5's session with ``scan_chunk=GRAPH_CHUNK`` (one
    CUDA-graph replay a chunk after an eager first chunk) against the
    same session step by step, both under deterministic algorithms:
    bitwise losses and parameters, else within the trajectory tier with
    the difference printed; three dispatches, one capture, two replays;
    every training kernel launched (counts at 0 before the chunked run;
    the captured launches count once, replays not at all), no plain
    version on the card; then wall and device time a step and peak
    memory."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.core.qadam import QAdamConfig, qadam
    from repro_torch.data.pipeline import batch_for_model
    from repro_torch.models.model import Model
    from repro_torch.train.session import SessionConfig, TrainSession
    from repro_torch.tree import tree_leaves
    K, A = mods["K"], mods["A"]
    cfg = dataclasses.replace(get_config("yi-6b"), n_layers=TRAIN_LAYERS)
    model = Model(cfg)
    opt = qadam(QAdamConfig(**TRAIN_OPT))

    def loss_fn(p, b):
        ls, nt = model.loss(p, b)
        return ls / nt

    def session(chunk):
        return TrainSession.from_optimizer(
            opt, loss_fn, model.init(seed=0, device=dev),
            batch_for_model(cfg, TRAIN_SEQ, TRAIN_BATCH, seed=0),
            SessionConfig(log_every=TRAIN_STEPS, scan_chunk=chunk),
            log=lambda *_: None)

    torch.cuda.empty_cache()
    with deterministic(torch) as caught:
        ref = session(1)
        t0 = time.perf_counter()
        ref_losses = all_losses(ref, TRAIN_STEPS)
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t0
        ref_params = [p.clone() for p in tree_leaves(ref.state["params"])]
        ref.close()
        del ref
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        # the main path, with every count at 0 just before it
        for mod, attr in TRAIN_COUNTERS.values():
            setattr(mods[mod], attr, 0)
        K.plain_on_cuda = A.plain_on_cuda = mods["P"].plain_on_cuda = 0
        sess = session(GRAPH_CHUNK)
        t0 = time.perf_counter()
        losses = all_losses(sess, TRAIN_STEPS)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    launches = {name: getattr(mods[mod], attr)
                for name, (mod, attr) in TRAIN_COUNTERS.items()}
    plain = K.plain_on_cuda + A.plain_on_cuda + mods["P"].plain_on_cuda
    stats = dict(sess.stats)
    peak = torch.cuda.max_memory_allocated()
    tr = trajectory(torch, losses, ref_losses,
                    tree_leaves(sess.state["params"]), ref_params)
    # the peak holds the step-by-step run's parameters, kept to compare
    ref_bytes = sum(p.numel() * p.element_size() for p in ref_params)
    del ref_params
    res = dict(chunk=GRAPH_CHUNK, steps=TRAIN_STEPS, losses=losses,
               per_step_losses=ref_losses, stats=stats, launches=launches,
               run_s=run_s, per_step_run_s=ref_s, peak_bytes=peak,
               peak_less_reference_bytes=peak - ref_bytes,
               nondeterministic=sorted({str(w.message)[:200] for w in caught
                                        if "deterministic" in
                                        str(w.message)}), **tr)
    if not all(math.isfinite(x) for x in losses) or len(losses) != \
            TRAIN_STEPS:
        raise AssertionError(f"graph training losses: {losses}")
    if (stats["dispatches"], stats["graph_captures"],
            stats["graph_replays"]) != (3, 1, 2):
        raise AssertionError(f"scan_chunk={GRAPH_CHUNK} over {TRAIN_STEPS} "
                             f"steps: not 3 dispatches, 1 capture, 2 "
                             f"replays: {stats}")
    if any(n == 0 for n in launches.values()) or plain:
        raise AssertionError(f"graph training: launches {launches}, plain "
                             f"{plain}")
    if not tr["bitwise"] and not (tr["loss_rel"] <= LOSS_RTOL and
                                  tr["param_rel_l2"] <= PARAM_REL_L2):
        raise AssertionError(f"scan_chunk={GRAPH_CHUNK} vs step by step: "
                             f"{res}")

    # wall and device time a step over whole replays
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sess.run(2 * GRAPH_CHUNK)
    torch.cuda.synchronize()
    res["step_wall_ms"] = ((time.perf_counter() - t0) / (2 * GRAPH_CHUNK)
                           * 1e3)
    dev_ms, by_kernel = profile_ms(torch, lambda: sess.run(GRAPH_CHUNK),
                                   steps=2)
    res["step_device_ms"] = dev_ms / GRAPH_CHUNK
    res["device_idle"] = 1 - res["step_device_ms"] / res["step_wall_ms"]
    res["step_kernels"] = [(k, t / GRAPH_CHUNK) for k, t in by_kernel[:8]]
    res["tokens_per_s"] = TRAIN_BATCH * TRAIN_SEQ / res["step_wall_ms"] * 1e3
    res["replays_after_timing"] = sess.stats["graph_replays"]
    sess.close()
    del sess
    gc.collect()
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 6: Algorithms 2+3, the distributed step on one NCCL rank
# ---------------------------------------------------------------------------

DIST_TC = dict(alpha=1e-3, beta=0.99, theta=0.999, grad_k=6, weight_k=7,
               weight_absolute=True, mode="qadam")
DIST_COUNTERS = {"ef_encode_rows_log": ("K", "ef_encode_log_launches"),
                 "ef_encode_rows_uniform": ("K", "ef_encode_uniform_launches"),
                 "decode_rows_log": ("K", "decode_log_launches"),
                 "decode_rows_uniform": ("K", "decode_uniform_launches"),
                 "adam_moments": ("A", "moments_launches")}
# the Alg 2+3 == Alg 1 gate's steps, and its Q_x threshold: above the
# (8, 4096) norm leaves, whose weights (1.0) lie past the absolute grid's
# 0.5, where Alg 1's residency codes reach +128 and the wire clips to +127
EQ_STEPS, EQ_MIN_NUMEL = 4, 2 ** 16
LOSS_RTOL, PARAM_REL_L2 = 2.3e-4, 4e-6   # the reference's own drift


def _wire_kernel_ms(by_kernel):
    """Device ms per step of the wire kernels by name and kind (K7 and #5
    are ``encode_kernel<bits, kind, ef>``, K6 ``decode_kernel<bits,
    kind>``, kind 0 log, 1 uniform, 2 ternary; #14 and #8
    ``blockwise_kernel<log2 block, pack>``), and of NCCL's kernels."""
    import re
    kinds = ("log", "uniform", "ternary")
    out = {}
    for name, t in by_kernel:
        m = re.search(r"(encode|decode)_kernel<(\d+), ?(\d)"
                      r"(?:, ?(true|false))?>", name)
        b = re.search(r"blockwise_kernel<\d+, ?(true|false)>", name)
        if m:
            op = "ef_encode" if m.group(4) == "true" else m.group(1)
            key = f"{op}_{kinds[int(m.group(3))]}"
        elif b:
            key = ("blockwise_encode" if b.group(1) == "true"
                   else "blockwise_quantize")
        elif "nccl" in name.lower():
            key = "nccl"
        else:
            continue
        out[key] = out.get(key, 0.0) + t
    return out


def dist_run(torch, dev, mods, group, model, cfg, tc, counters, steps,
             what, alg1=None, falling=True, seq=TRAIN_SEQ):
    """One distributed training run through ``launch.train``'s path
    (``make_train_step`` + ``TrainSession.from_artifacts`` on ``group``,
    one NCCL rank) and its gates: the phase-5 gates with the ``counters``
    kernels launched (every count at 0 just before the run), the bytes
    the collectives move equal to ``comm_bytes_per_step`` (scale side
    channels counted apart), and one update on captured gradients from
    the trained state, every leaf, bitwise through the kernels and the
    plain versions (the same uniforms on both sides) and, with ``alg1``
    (a ``QAdamConfig``), through Algorithm 1's ``qadam.update``. Batches
    of TRAIN_BATCH x ``seq`` tokens. Prints nothing; returns the
    readings."""
    import gc
    import torch.distributed as dist
    from repro_torch.core import threefry
    from repro_torch.core.qadam import (QAdamConfig, QAdamState, _alpha_t,
                                        _theta_t, apply_updates, qadam)
    from repro_torch.data.pipeline import batch_for_model
    from repro_torch.dist import collectives as C
    from repro_torch.dist import step as DS
    from repro_torch.dist.modes import WorkerCtx, get_mode
    from repro_torch.opt import engine
    from repro_torch.train.loop import comm_bytes_per_step
    from repro_torch.train.session import (SessionConfig, TrainSession,
                                           stage_batch)
    from repro_torch.tree import sorted_leaf_index, tree_leaves, tree_map
    K, A = mods["K"], mods["A"]
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    res = {"backend": dist.get_backend(group),
           "world_size": dist.get_world_size(group), "tc": dict(
               (k, v) for k, v in dataclasses.asdict(tc).items()
               if k != "topology")}
    art = DS.make_train_step(model, group, tc)
    comm = comm_bytes_per_step(art, tc)
    torch.cuda.reset_peak_memory_stats()
    # the main path, with every count at 0 just before it
    for mod, attr in counters.values():
        setattr(mods[mod], attr, 0)
    K.plain_on_cuda = A.plain_on_cuda = mods["P"].plain_on_cuda = 0
    sess = TrainSession.from_artifacts(
        art, batch_for_model(cfg, seq, TRAIN_BATCH, seed=0),
        SessionConfig(log_every=steps), seed=0, device=dev,
        log=lambda *_: None)
    w = run_watched(torch, sess, steps)
    peak = torch.cuda.max_memory_allocated()
    launches = {name: getattr(mods[mod], attr)
                for name, (mod, attr) in counters.items()}
    res.update(launches=launches, amax_launches=K.amax_launches)
    check_run(w, dict(sess.stats), launches,
              K.plain_on_cuda + A.plain_on_cuda + mods["P"].plain_on_cuda,
              what, steps, falling)
    res.update(losses=w["losses"], stats=dict(sess.stats),
               syncs_at_step_starts=w["starts"],
               syncs_by_harvest=w["harvests"], sync_warnings=w["syncs"],
               sync_messages=w["messages"], run_s=w["run_s"],
               peak_bytes=peak, comm=comm)

    # wall time per steady step, the device's share by kernel
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sess.run(3)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / 3 * 1e3
    dev_ms, by_kernel = profile_ms(torch, lambda: sess.run(1), steps=2)
    res.update(step_wall_ms=wall_ms, step_device_ms=dev_ms,
               device_idle=1 - dev_ms / wall_ms,
               tokens_per_s=TRAIN_BATCH * seq / wall_ms * 1e3,
               step_kernels=by_kernel[:20],
               wire_kernels_ms=_wire_kernel_ms(by_kernel),
               update_kernel_ms=sum(t for k, t in by_kernel
                                    if "adam_moments_kernel" in k))

    # device time by phase (CUDA events at the step's marks; the
    # update's marks alternate per leaf), one warm step then one, on the
    # single pass (exchange_bucket_bytes 0: with buckets the update and
    # exchange run inside the backward and are no phases of their own),
    # so the four phases read as in runs before buckets
    events = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append((name, ev))

    program_step = sess._program.step
    one_pass = DS.make_train_step(model, group, dataclasses.replace(
        tc, exchange_bucket_bytes=0))
    one_pass.prepare(dev)

    def marked_step(state, batch, hp=None, t=None):
        mark("start")
        return one_pass.step_fn(state, batch, mark=mark, hp=hp, t=t)
    sess._program.step = marked_step
    try:
        sess.run(1)
        events.clear()
        sess.run(1)
    finally:
        sess._program.step = program_step
    events[-1][1].synchronize()
    phases = {"broadcast": 0.0, "forward_backward": 0.0,
              "update_exchange": 0.0, "master_update": 0.0}
    for (_, a), (name, b) in zip(events, events[1:]):
        phases[name] += a.elapsed_time(b)
    res["phases_ms"] = phases
    del one_pass

    # the payload bytes the collectives move in one step against the
    # accounting; the scale side channels (per tensor, per block) apart
    moved = {"exchange": 0, "broadcast": 0, "side": 0}
    saved = {k: getattr(C, k) for k in ("exchange_rows", "reduce_rows",
                                        "gather_rows", "gather_side")}

    def counted(fn, key, after):
        def call(x, grp):
            out = fn(x, grp)
            moved[key] += (out if after else x).nbytes
            return out
        return call
    C.exchange_rows = counted(saved["exchange_rows"], "exchange", False)
    C.reduce_rows = counted(saved["reduce_rows"], "exchange", False)
    C.gather_rows = counted(saved["gather_rows"], "broadcast", True)
    C.gather_side = counted(saved["gather_side"], "side", True)
    try:
        sess.run(1)
    finally:
        for k, fn in saved.items():
            setattr(C, k, fn)
    res["moved_bytes"] = dict(moved)
    if (moved["exchange"], moved["broadcast"]) != (
            comm["update_exchange_bytes"], comm["weight_broadcast_bytes"]):
        raise AssertionError(f"{what}: collectives moved {moved}, accounting "
                             f"says {comm}")

    # one update on captured gradients from the trained state: the step's
    # updater through the kernels and through the plain versions (and
    # Algorithm 1's qadam.update), each on its own copy, bitwise
    state = sess.state
    def leaves_of(tree):     # in the layout's order
        return tree_leaves(tree_map(lambda _, x: x, art.layout.shapes,
                                    tree))
    keys = [k for k in state if k != "count"]
    res["state_bytes"] = sum(x.numel() * x.element_size() for k in keys
                             for x in leaves_of(state[k]))
    masters, ms_, vs_, es_ = (leaves_of(state[k])
                              for k in ("master", "m", "v", "e"))
    res["n_params"] = sum(x.numel() for x in masters)
    batch = stage_batch(next(batch_for_model(cfg, seq, TRAIN_BATCH,
                                             seed=1)), dev)
    xs = art.broadcast(state)
    _, grads = art.loss_and_grads(xs, batch)
    del xs
    metas = tree_leaves(DS._leaf_meta(art.layout, 1))
    draw_index = sorted_leaf_index(art.layout.shapes)
    mode = get_mode(tc.mode)
    upd = {b: mode.make_updater(
        dataclasses.replace(tc, backend=b), WorkerCtx(
            group=group, n_workers=1, backend=b, tiers=art.tiers))
        for b in ("cuda", "torch")}
    t = state["count"] + 1
    sched = QAdamConfig(alpha=tc.alpha, beta=tc.beta, theta=tc.theta,
                        eps=tc.eps, schedule=tc.schedule)
    hp = engine.hyperparams(_alpha_t(sched, t), tc.beta, _theta_t(sched, t),
                            tc.eps, dev)
    for i, meta in enumerate(metas):
        # a leaf the loss does not use (llava's embedding table) has no
        # gradient: zeros, as the step's update takes it
        g = (torch.zeros(meta.numel, dtype=torch.float32, device=dev)
             if grads[i] is None else grads[i].reshape(-1))
        grads[i] = None

        def draw(n, i=draw_index[i]):
            return DS.draw_uniform(tc.seed, t, i, 0, n, dev)
        new = {}
        for b in ("cuda", "torch"):
            copy = [x.clone() for x in (masters[i], ms_[i], vs_[i], es_[i])]
            upd[b](g.clone(), copy[1], copy[2], copy[3], copy[0], meta, hp,
                   draw=draw)
            new[b] = copy
            if b == "torch":
                if not all(bits_equal(torch, x, y)
                           for x, y in zip(new["cuda"], copy)):
                    raise AssertionError(
                        f"{what}: captured-gradient update through the "
                        f"kernels differs from the plain versions (leaf "
                        f"{meta.shape})")
                del new["torch"], copy
        if alg1 is not None:
            sub = QAdamState(count=state["count"],
                             m={"x": ms_[i].clone()}, v={"x": vs_[i].clone()},
                             e={"x": es_[i].clone()},
                             key=threefry.prng_key(0, dev))
            u, s2 = qadam(alg1).update({"x": g}, sub)
            ref = (apply_updates({"x": masters[i]}, u)["x"], s2.m["x"],
                   s2.v["x"], s2.e["x"])
            if not all(bits_equal(torch, x, y)
                       for x, y in zip(new["cuda"], ref)):
                raise AssertionError(f"captured-gradient update of Alg 2+3 "
                                     f"differs from Algorithm 1's (leaf "
                                     f"{meta.shape})")
            del sub, u, s2, ref
        del new, g
    del grads, state, masters, ms_, vs_, es_
    sess.close()
    del sess, art
    gc.collect()
    torch.cuda.empty_cache()
    return res


def dist_train(torch, dev, mods, group, model, cfg):
    """Phase 6: the paper's qadam on one NCCL rank (DIST_TC), with the
    captured-gradient update also held against Algorithm 1's, and then
    Algorithms 2+3 at one worker against Algorithm 1."""
    from repro_torch.core.qadam import QAdamConfig
    from repro_torch.dist.step import TrainConfig
    tc = TrainConfig(**DIST_TC)
    qcfg = QAdamConfig(alpha=tc.alpha, beta=tc.beta, theta=tc.theta,
                       eps=tc.eps, grad_q=f"log:{tc.grad_k}")
    res = dist_run(torch, dev, mods, group, model, cfg, tc, DIST_COUNTERS,
                   TRAIN_STEPS, "distributed", alg1=qcfg)
    if res["backend"] != "nccl" or res["world_size"] != 1:
        raise AssertionError(f"expected one NCCL rank: {res}")
    res["equivalence"] = equivalence(torch, dev, group, model, cfg)
    return res


LLAVA_LAYERS, LLAVA_STEPS = 4, 4


def llava_train(torch, dev, mods, group):
    """Phase 6c: llava-next-mistral-7b's decoder at full width cut to
    LLAVA_LAYERS layers, on embedding input (the vision tower's stub,
    ``batch_for_model``'s embeds), trained through ``launch.train``'s path
    on the phase-6 NCCL rank (``dist_run`` with DIST_TC, LLAVA_STEPS
    steps of 2 x 1024 positions): finite losses, K15, K7 and K6
    launched, no plain version on the card, no steady host sync, the
    bytes moved equal to ``comm_bytes_per_step``, and one
    captured-gradient update bitwise through the kernels and the plain
    versions. The losses are not gated to fall: random embeddings carry
    nothing of the targets, and the reference's own trajectory on this
    stub stays flat over its first steps."""
    from repro_torch.configs import get_config
    from repro_torch.dist.step import TrainConfig
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(get_config("llava-next-mistral-7b"),
                              n_layers=LLAVA_LAYERS)
    res = dist_run(torch, dev, mods, group, Model(cfg), cfg,
                   TrainConfig(**DIST_TC), DIST_COUNTERS, LLAVA_STEPS,
                   "llava training", falling=False)
    res["layers"] = LLAVA_LAYERS
    print(f"phase 6c: llava-next-mistral-7b x {LLAVA_LAYERS} layers on "
          f"embeddings, one NCCL rank: losses "
          f"{', '.join(f'{x:.4f}' for x in res['losses'])}; "
          f"{LLAVA_STEPS} steps in {res['run_s']:.3f} s; step wall "
          f"{res['step_wall_ms']:.3f} ms, device {res['step_device_ms']:.3f} "
          f"ms (idle {res['device_idle']:.1%}); launches {res['launches']}; "
          f"peak {res['peak_bytes']} B; captured-gradient update bitwise",
          flush=True)
    return res


# ---------------------------------------------------------------------------
# phase 6d: the adaptive mode on one NCCL rank (repro_torch.adapt)
# ---------------------------------------------------------------------------

# every lane of repro_torch.adapt.WIDTH_SPECS on two of the cut's 12
# leaves (the reference's leaf order: blocks/attn k, o, q, v, ln1, ln2,
# mlp w_down, w_gate, w_up, embed, final_norm, unembed)
ADAPT_PLAN = ("blockwise:256", "log:2", "log:6", "log:30", "log:126",
              "uniform_amax:14:w16") * 2
ADAPT_FIXED_STEPS = 3
ADAPT_STEPS, ADAPT_EVERY, ADAPT_CHUNK, ADAPT_BUDGET = 12, 4, 4, 0.6
# what may stay allocated after 6d's session closes, beside its level
# before 6d: device tables its plans made once for the process (the log
# grids' levels and decision points), a few KB each; a session or a graph
# left behind is GBs
CLOSE_SLACK = 2 ** 21


def allocated_without_workspaces(torch) -> int:
    """The allocated bytes once cuBLAS has given back its workspaces
    (32 MiB a stream it ran on, cuBLAS and cuBLASLt each, kept by the
    caching allocator for the process; a first capture stream adds
    64 MiB)."""
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    return torch.cuda.memory_allocated()
ADAPT_COUNTERS = {"ef_encode_rows_log": ("K", "ef_encode_log_launches"),
                  "ef_encode_rows_uniform": ("K", "ef_encode_uniform_launches"),
                  "decode_rows_log": ("K", "decode_log_launches"),
                  "decode_rows_uniform": ("K", "decode_uniform_launches"),
                  "adam_moments": ("A", "moments_launches"),
                  "blockwise_quantize": ("K", "blockwise_quantize_launches"),
                  "pack_rows": ("K", "pack_launches"),
                  "unpack_rows": ("K", "unpack_launches"),
                  "encode_rows_log": ("K", "encode_log_launches"),
                  "encode_rows_uniform": ("K", "encode_uniform_launches"),
                  "amax_rows": ("K", "amax_launches")}
# the kernels each lane's leaves launch in a step (besides K15)
LANE_KERNELS = {"log": ("ef_encode_rows_log", "decode_rows_log"),
                "uniform": ("ef_encode_rows_uniform", "decode_rows_uniform"),
                "blockwise": ("blockwise_quantize", "pack_rows",
                              "unpack_rows")}


def _plan_counts(plan):
    counts = {}
    for spec in plan or ("log:6",) * 12:
        counts[spec] = counts.get(spec, 0) + 1
    return counts


def _zero_counts(mods, counters):
    for mod, attr in counters.values():
        setattr(mods[mod], attr, 0)
    mods["K"].plain_on_cuda = mods["A"].plain_on_cuda = 0
    clear_by_spec(mods["K"])


def _counts(mods, counters):
    out = {name: getattr(mods[mod], attr)
           for name, (mod, attr) in counters.items()}
    out.update(by_spec_launches(mods["K"]))
    return out


def _lanes_launched(launches, plans, what):
    """Every kernel of every lane in ``plans`` launched, K15 too."""
    from repro_torch.comm.codec import get_codec
    need = {"adam_moments"}
    for plan in plans:
        for spec in plan:
            codec = get_codec(spec)
            need.update(LANE_KERNELS[codec.kind])
            if spec in DEEP_SPECS:
                need.update(lane_row(n, spec) for n in
                            ("ef_encode_rows", "decode_rows"))
    idle = sorted(n for n in need if not launches.get(n))
    if idle:
        raise AssertionError(f"{what}: kernels of its lanes never "
                             f"launched: {idle} ({launches})")


def _fingerprint(torch, state):
    """An exact fingerprint of a state: every tensor's int32 words summed
    in int64 (a swap that moved, freed or rewrote a tensor changes it)."""
    from repro_torch.train.session import _tensor_leaves
    return [(k, x.data_ptr(), int(x.view(torch.int32).sum(
        dtype=torch.int64))) for k, x in _tensor_leaves(state)]


def adaptive_train(torch, dev, mods, group, model, cfg):
    """Phase 6d: the adaptive mode on the phase-6 cut, one NCCL rank.

    1. A fixed plan with every lane of WIDTH_SPECS (ADAPT_PLAN):
       ADAPT_FIXED_STEPS steps through the kernels bitwise the same steps
       through the plain versions (losses, masters; deterministic
       algorithms), every lane's kernels launched, and its accounting
       exact against payloads encoded on the card.
    2. ``bit_plan=None`` bitwise the qadam mode (EQ_STEPS steps).
    3. The main path: ``AdaptiveController`` (the launcher's
       ``--adaptive``), ADAPT_STEPS steps, a replan every ADAPT_EVERY,
       scan_chunk ADAPT_CHUNK (a CUDA graph a window), budget
       ADAPT_BUDGET, verify on, every count at 0 just before: a replan at
       least, the state's tensors and bits untouched by each swap, one
       host sync a window, no plain version on the card, every kernel of
       the plans' lanes launched. Then each plan's steady step (wall,
       device, its kernels) with the plan installed again (the cost of a
       revisited plan: a capture), the peak bytes over all of it."""
    import gc
    from repro_torch.adapt.controller import (AdaptConfig, AdaptiveController,
                                              verify_accounting)
    from repro_torch.data.pipeline import batch_for_model
    from repro_torch.dist.step import TrainConfig, make_train_step
    from repro_torch.train.session import SessionConfig, _tensor_leaves
    from repro_torch.train.loop import comm_bytes_per_step
    K, A = mods["K"], mods["A"]
    res = {}
    base = dict(DIST_TC, mode="adaptive")
    fixed = TrainConfig(**base, bit_plan=ADAPT_PLAN)
    # the fixed log:6 wire's bytes a step at this cut (qadam's)
    qadam_tc = TrainConfig(**DIST_TC)
    fixed_log6 = comm_bytes_per_step(make_train_step(model, group, qadam_tc),
                                     qadam_tc)["update_exchange_bytes"]
    res["fixed_log6_bytes"] = fixed_log6
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    allocated_before = allocated_without_workspaces(torch)

    # 1. the fixed plan, kernels against plain versions
    with deterministic(torch):
        _zero_counts(mods, ADAPT_COUNTERS)
        lk, pk = _session_run(torch, dev, group, model, cfg, fixed,
                              ADAPT_FIXED_STEPS)
        fixed_launches = _counts(mods, ADAPT_COUNTERS)
        if K.plain_on_cuda + A.plain_on_cuda:
            raise AssertionError("6d: a plain version ran in the fixed "
                                 "plan's kernel run")
        lp, pp = _session_run(torch, dev, group, model, cfg,
                              dataclasses.replace(fixed, backend="torch"),
                              ADAPT_FIXED_STEPS)
    bitwise = lk == lp and all(bits_equal(torch, a, b)
                               for a, b in zip(pk, pp))
    del pk, pp
    if not bitwise:
        raise AssertionError(f"6d: the fixed plan through the kernels is not "
                             f"bitwise its plain run: {lk} vs {lp}")
    _lanes_launched(fixed_launches, [ADAPT_PLAN], "6d fixed plan")
    art = make_train_step(model, group, fixed)
    acc = verify_accounting(art, fixed, dev)
    del art
    res.update(fixed_plan=list(ADAPT_PLAN), fixed_losses=lk,
               fixed_launches=fixed_launches, fixed_accounting=acc)

    # 2. no plan: the qadam mode, bitwise
    res["no_plan_vs_qadam"] = pair_equivalence(
        torch, dev, group, model, cfg, TrainConfig(**base),
        TrainConfig(**DIST_TC))

    # 3. the controller, its swaps watched from a subclass (nothing is
    # stored on the session: a closure there would make a reference
    # cycle that keeps the session's memory until a collection)
    class Watched(AdaptiveController):
        def _swap(self, plan, step: int):
            before = _fingerprint(torch, self.session.state)
            torch.cuda.synchronize()
            t = time.perf_counter()
            super()._swap(plan, step)
            self.swaps.append(dict(
                step=self.session.step, s=time.perf_counter() - t,
                bitwise=_fingerprint(torch, self.session.state) == before))

    torch.cuda.empty_cache()
    ctl = Watched(
        model, group, TrainConfig(**DIST_TC),
        batch_for_model(cfg, TRAIN_SEQ, TRAIN_BATCH, seed=0),
        AdaptConfig(budget_ratio=ADAPT_BUDGET, replan_every=ADAPT_EVERY),
        SessionConfig(log_every=0, scan_chunk=ADAPT_CHUNK), seed=0,
        device=dev, log=lambda *_: None, verify=True)
    ctl.swaps = swaps = []
    sess = ctl.session
    ptrs = [x.data_ptr() for _, x in _tensor_leaves(sess.state)]
    torch.cuda.synchronize()
    _zero_counts(mods, ADAPT_COUNTERS)
    t0 = time.perf_counter()
    ctl.run(ADAPT_STEPS)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = _counts(mods, ADAPT_COUNTERS)
    plain = K.plain_on_cuda + A.plain_on_cuda + mods["P"].plain_on_cuda
    stats = dict(ctl.stats)            # before the losses' own harvest
    losses = [v for _, v in sess.harvest_losses()]
    plans = [e["bit_plan"] for e in ctl.plan_log]
    if ctl.replans < 1 or not swaps or not all(w["bitwise"] for w in swaps):
        raise AssertionError(f"6d: replans {ctl.replans}, swaps {swaps}")
    if [x.data_ptr() for _, x in _tensor_leaves(sess.state)] != ptrs:
        raise AssertionError("6d: a swap replaced the state's tensors")
    windows = math.ceil(ADAPT_STEPS / ADAPT_EVERY)
    if stats["syncs"] != windows:
        raise AssertionError(f"6d: {stats['syncs']} host syncs for "
                             f"{windows} windows")
    if plain:
        raise AssertionError(f"6d: {plain} plain-version calls on the card")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"6d losses not finite: {losses}")
    _lanes_launched(launches, [p or ("log:6",) for p in plans], "6d")
    for e in ctl.plan_log:
        if e["verify"]["measured"] != e["comm"]["update_exchange_bytes"]:
            raise AssertionError(f"6d accounting: {e['verify']}")
    capture_s = sess.capture_seconds
    res.update(launches=launches, losses=losses, stats=stats, run_s=run_s,
               replans=ctl.replans, swaps=swaps, capture_s=capture_s,
               plans=[dict(step=e["step"], bit_plan=(
                   list(e["bit_plan"]) if e["bit_plan"] else None),
                   exchange_bytes=e["comm"]["update_exchange_bytes"],
                   broadcast_bytes=e["comm"]["weight_broadcast_bytes"],
                   vs_log6=e["comm"]["update_exchange_bytes"]
                   / fixed_log6) for e in ctl.plan_log],
               ema_snapshot=ctl.ema.snapshot().tolist())

    # each plan's steady step, the plan installed again (a capture)
    per_plan = []
    for e in ctl.plan_log:
        tc = dataclasses.replace(ctl.tc, bit_plan=e["bit_plan"])
        ctl.tc, ctl.art = tc, make_train_step(model, group, tc)
        n_cap = len(sess.capture_seconds)
        sess.swap_artifacts(ctl.art)
        torch.cuda.synchronize()
        t = time.perf_counter()
        sess.run(ADAPT_CHUNK)          # the capture and a replay
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t
        t = time.perf_counter()
        sess.run(2 * ADAPT_CHUNK)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) / (2 * ADAPT_CHUNK) * 1e3
        dev_ms, by_kernel = profile_ms(
            torch, lambda: sess.run(ADAPT_CHUNK), steps=1)
        per_plan.append(dict(
            step=e["step"], step_wall_ms=wall_ms,
            step_device_ms=dev_ms / ADAPT_CHUNK,
            device_idle=1 - dev_ms / ADAPT_CHUNK / wall_ms,
            revisit_capture_s=sess.capture_seconds[n_cap:],
            revisit_first_dispatch_s=first_s,
            wire_kernels_ms=_wire_kernel_ms(
                [(k, t / ADAPT_CHUNK) for k, t in by_kernel]),
            step_kernels=[(k, t / ADAPT_CHUNK) for k, t in by_kernel[:12]]))
    res["per_plan"] = per_plan
    res["peak_bytes"] = torch.cuda.max_memory_allocated()
    held = torch.cuda.memory_allocated()
    ctl.close()
    del ctl, sess
    # no collection: close() drops the graphs and the session keeps no
    # reference cycle, so the state and the graphs' buffers go here
    after = allocated_without_workspaces(torch)
    res.update(allocated_before=allocated_before, allocated_held=held,
               allocated_after_close=after)
    if after - allocated_before > CLOSE_SLACK:
        raise AssertionError(f"6d: {after - allocated_before} B still "
                             f"allocated after the session closed "
                             f"({allocated_before} B before 6d)")
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 6e: the hierarchical topology and the model axis on one NCCL rank
# (no garbage collection: every session it and 6d make is freed when
# dropped)
# ---------------------------------------------------------------------------

# yi-6b at full width cut to 2 layers, through launch.train's main
HIER_LAYERS, HIER_STEPS, MGQ_STEPS = 2, 3, 2
GATHER_COUNTERS = {"amax_rows": ("K", "amax_launches"),
                   "uniform_quantize_rows": ("K", "quantize_launches"),
                   "uniform_dequantize_rows": ("K", "dequantize_launches")}


def _launch(torch, mods, counters, *flags, arch="yi-6b",
            layers=HIER_LAYERS, seq=TRAIN_SEQ):
    """``launch.train.main`` on the current NCCL rank for ``arch`` cut to
    ``layers`` with the phase's flags, TRAIN_BATCH x ``seq`` tokens a
    step, every count of ``counters`` at 0 just before it: (its result,
    the counts, plain-version calls on the card, its output)."""
    import io
    from repro_torch.launch import train as launch
    K, A = mods["K"], mods["A"]
    for mod, attr in counters.values():
        setattr(mods[mod], attr, 0)
    K.plain_on_cuda = A.plain_on_cuda = mods["P"].plain_on_cuda = 0
    argv = ["--arch", arch, "--layers", str(layers), "--seq",
            str(seq), "--global-batch", str(TRAIN_BATCH),
            "--grad-bits", "6", "--weight-bits", "7", "--weight-absolute",
            "--log-every", "1", "--device", "cuda", *flags]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        r = launch.main(argv)
    torch.cuda.synchronize()
    launches = {n: getattr(mods[m], a) for n, (m, a) in counters.items()}
    return r, launches, K.plain_on_cuda + A.plain_on_cuda, out.getvalue()


def _step_device_ms(torch, dev, r, cfg):
    """Device ms of one more step of a launcher run's session state."""
    from repro_torch.data.pipeline import batch_for_model
    from repro_torch.train.session import SessionConfig, TrainSession
    sess = TrainSession.from_artifacts(
        r["art"], batch_for_model(cfg, TRAIN_SEQ, TRAIN_BATCH, seed=7),
        SessionConfig(log_every=1), state=r["state"], device=dev,
        log=lambda *_: None)
    try:
        ms, by_kernel = profile_ms(torch, lambda: sess.run(1), steps=2)
    finally:
        sess.close()
    return ms, by_kernel[:8]


def hier_train(torch, dev, mods):
    """Phase 6e (see the module docstring)."""
    from repro_torch.configs import get_config
    from repro_torch.dist import collectives as C
    from repro_torch.tree import tree_leaves
    K = mods["K"]
    cfg = dataclasses.replace(get_config("yi-6b"), n_layers=HIER_LAYERS)
    torch.cuda.empty_cache()
    res = {"layers": HIER_LAYERS, "steps": HIER_STEPS,
           "allocated_at_start": torch.cuda.memory_allocated()}
    keys = ("master", "m", "v", "e")
    with deterministic(torch):
        flat, _, _, _ = _launch(torch, mods, DIST_COUNTERS,
                                "--steps", str(HIER_STEPS))
    # the flat run's state on the host: the 1x1 run is held against it
    # with one run's state on the card
    host = {k: [x.to("cpu", copy=True) for x in tree_leaves(
        flat["state"][k])] for k in keys}
    fl, fc = [h["loss"] for h in flat["history"]], flat["comm"]
    res["flat_step_device_ms"], _ = _step_device_ms(torch, dev, flat, cfg)
    del flat
    torch.cuda.empty_cache()
    with deterministic(torch):
        hier, launches, plain, hier_log = _launch(
            torch, mods, DIST_COUNTERS, "--steps", str(HIER_STEPS),
            "--topology", "1x1")
    if not hier["art"].tiers.hierarchical:
        raise AssertionError("--topology 1x1 did not take the tiered path")
    if min(launches.values()) == 0 or plain:
        raise AssertionError(f"1x1: kernels not launched or a plain "
                             f"version ran: {launches}, plain {plain}")
    hl = [h["loss"] for h in hier["history"]]
    same = fl == hl and all(
        bits_equal(torch, x.cpu(), y) for k in keys
        for x, y in zip(tree_leaves(hier["state"][k]), host[k]))
    if not same or not all(math.isfinite(x) for x in hl):
        raise AssertionError(f"1x1 is not bitwise the flat run: {hl} vs {fl}")
    del host
    tiers = hier["comm"]["tiers"]
    n_params = sum(x.numel() for x in tree_leaves(hier["state"]["master"]))
    if tiers["inter"]["total"] != fc["total_bytes"] or \
            tiers["intra"]["grad_reduce"] != 4 * n_params:
        raise AssertionError(f"tier bytes {tiers} against flat {fc}")
    res.update(losses=hl, flat_losses=fl, launches=launches, bitwise=same,
               tiers=tiers, flat_comm={k: fc[k] for k in (
                   "update_exchange_bytes", "weight_broadcast_bytes",
                   "total_bytes")}, n_params=n_params,
               log=hier_log.splitlines()[:3])
    res["step_device_ms"], res["step_kernels"] = _step_device_ms(
        torch, dev, hier, cfg)
    del hier
    torch.cuda.empty_cache()

    # the int8 gather at one shard on the w_gate stack: K3, K4, K12
    d, f = cfg.d_model, cfg.d_ff
    gen = torch.Generator(device=dev).manual_seed(3)
    w = torch.randn((HIER_LAYERS, d, f), generator=gen, device=dev) * 0.02
    for mod, attr in GATHER_COUNTERS.values():
        setattr(mods[mod], attr, 0)
    K.plain_on_cuda = 0
    got = C.quantized_gather_shard(w, 1, 1, 8, False, backend="cuda")
    torch.cuda.synchronize()
    glaunch = {n: getattr(mods[m], a) for n, (m, a) in
               GATHER_COUNTERS.items()}
    if min(glaunch.values()) == 0 or K.plain_on_cuda:
        raise AssertionError(f"int8 gather: {glaunch}, plain "
                             f"{K.plain_on_cuda}")
    want = C.quantized_gather_shard(w, 1, 1, 8, False, backend="torch")
    if not bits_equal(torch, got, want):
        raise AssertionError("the int8 gather differs from its plain "
                             "version")
    n = w.numel()
    res["gather"] = dict(
        shape=list(w.shape), launches=glaunch,
        ms=cuda_ms(torch, lambda i: C.quantized_gather_shard(
            w, 1, 1, 8, False, backend="cuda"), 5, 1),
        plain_ms=cuda_ms(torch, lambda i: C.quantized_gather_shard(
            w, 1, 1, 8, False, backend="torch"), 3, 1),
        bound_ms=bound_ms(8 * n)[0])
    del w, got, want
    torch.cuda.empty_cache()

    mgq, _, plain, _ = _launch(torch, mods, DIST_COUNTERS, "--steps",
                               str(MGQ_STEPS), "--data", "1", "--model",
                               "1", "--model-gather-quant", "8")
    ml = [h["loss"] for h in mgq["history"]]
    if plain or len(ml) != MGQ_STEPS or not all(math.isfinite(x)
                                                 for x in ml):
        raise AssertionError(f"--model-gather-quant 8: losses {ml}, plain "
                             f"{plain}")
    res["mgq_losses"] = ml
    res["mgq_step_device_ms"], _ = _step_device_ms(torch, dev, mgq, cfg)
    del mgq
    torch.cuda.empty_cache()
    return res


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def multihost_train(torch, dev, mods):
    """Phase 6i: ``launch.train`` with the reference's multi-host flags
    (``--multihost --coordinator 127.0.0.1:<free port> --num-processes 1
    --process-id 0``: its own NCCL group over a TCP rendezvous) for one
    step of yi-6b cut to HIER_LAYERS layers, bitwise the flat one-rank run
    (its losses and its state), under deterministic algorithms; no
    process group exists before either run."""
    from repro_torch.tree import tree_leaves
    import torch.distributed as dist
    if dist.is_initialized():
        raise AssertionError("6i needs no process group before it")
    keys = ("master", "m", "v", "e")
    with deterministic(torch):
        flat, _, _, _ = _launch(torch, mods, DIST_COUNTERS, "--steps", "1")
        host = {k: [x.to("cpu", copy=True) for x in tree_leaves(
            flat["state"][k])] for k in keys}
        fl = [h["loss"] for h in flat["history"]]
        del flat
        torch.cuda.empty_cache()
        port = free_port()
        mh, launches, plain, log = _launch(
            torch, mods, DIST_COUNTERS, "--steps", "1", "--multihost",
            "--coordinator", f"127.0.0.1:{port}", "--num-processes", "1",
            "--process-id", "0")
    ml = [h["loss"] for h in mh["history"]]
    same = ml == fl and all(
        bits_equal(torch, x.cpu(), y) for k in keys
        for x, y in zip(tree_leaves(mh["state"][k]), host[k]))
    if not same or plain or min(launches.values()) == 0 or \
            not all(math.isfinite(x) for x in ml):
        raise AssertionError(f"--multihost is not bitwise the flat run: "
                             f"{ml} vs {fl}; launches {launches}, plain "
                             f"{plain}")
    if dist.is_initialized():
        raise AssertionError("the launcher left its process group open")
    del mh, host
    torch.cuda.empty_cache()
    return dict(losses=ml, flat_losses=fl, bitwise=same, port=port,
                layers=HIER_LAYERS, log=log.splitlines()[:2])


# ---------------------------------------------------------------------------
# phase 6b: the distributed session's checkpoints and resume
# ---------------------------------------------------------------------------

# 6b's cut: full-width yi-6b at CKPT_LAYERS layers (an 11.2 GB state; 8
# layers and 30.5 GB until the MoE phases needed the time, 2 layers and
# 13.9 GB until the encoder-decoder phases did)
CKPT_LAYERS, CKPT_STEPS, CKPT_CODEC = 1, 8, "uniform_amax:7"
CKPT_COUNTERS = {"amax_rows": ("K", "amax_launches"),
                 "encode_rows_uniform": ("K", "encode_uniform_launches"),
                 "decode_rows_uniform": ("K", "decode_uniform_launches")}


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(r, f))
               for r, _, fs in os.walk(path) for f in fs)


def release_pinned(torch) -> None:
    """Hand the pinned host pool's free blocks back to the system (a
    checkpoint's host copy of the state is cached there)."""
    empty = getattr(torch._C, "_host_emptyCache", None)
    if empty is not None:
        empty()


def ckpt_resume(torch, dev, mods, group, model, cfg):
    """Phase 6b: Algorithms 2+3 (DIST_TC) on one NCCL rank, full-width
    yi-6b cut to CKPT_LAYERS layers (``model``, ``cfg``), CKPT_STEPS
    steps, under deterministic algorithms. Run B runs half the
    steps, checkpoints (pinned host copy on a side stream, the writer
    thread) and runs the rest; its final state goes to the host. A new
    session resumes from the checkpoint, the device holding its state
    and nothing more, and runs the rest: losses and state bitwise run
    B's. Then a checkpoint of that state with ``ckpt_codec=CKPT_CODEC``
    (#5 with K3's amax on the moments) restored by a new session (K6, at
    most one leaf beside the state): masters and count exact, m, v and e
    bitwise the plain versions' codec round trip. Then
    ``scan_chunk=GRAPH_CHUNK`` on the same rank (the step's collectives
    captured in the graph): losses and state bitwise run B's. Written
    into a temp dir deleted at the end; prints the bytes written, the
    seconds to save and restore and the device bytes a restore adds."""
    import gc
    import shutil
    import tempfile
    from repro_torch.comm.codec import get_codec
    from repro_torch.data.pipeline import batch_for_model
    from repro_torch.dist.step import TrainConfig, make_train_step
    from repro_torch.train.session import (SessionConfig, TrainSession,
                                           _replaced, _tensor_leaves)
    K = mods["K"]
    art = make_train_step(model, group, TrainConfig(**DIST_TC))
    half = CKPT_STEPS // 2

    def session(**kw):
        kw.setdefault("log_every", 1)
        return TrainSession.from_artifacts(
            art, batch_for_model(cfg, TRAIN_SEQ, TRAIN_BATCH, seed=0),
            SessionConfig(**kw), seed=0, device=dev, log=lambda *_: None)

    def same(sess, host, count, moments=None) -> bool:
        """The session's state against the host copy, leaf by leaf;
        ``moments``: m, v and e compared with that round trip."""
        if sess.state["count"] != count:
            return False
        for key, x in _tensor_leaves(sess.state):
            want = host[key].to(dev)
            if moments is not None and \
                    key.split("/", 1)[0] in ("m", "v", "e"):
                want = moments(want)
            if not bits_equal(torch, x, want):
                print(f"6b: {key} differs", flush=True)
                return False
        return True

    def restore(sess, step):
        """resume() from ``step``; (seconds, device bytes it added at its
        peak)."""
        before = _tensor_leaves(sess.state)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        found = sess.resume()
        torch.cuda.synchronize()
        took = time.perf_counter() - t0
        if found != step or _replaced(before, sess.state):
            raise AssertionError(f"resume: step {found}, replaced "
                                 f"{_replaced(before, sess.state)}")
        return took, torch.cuda.max_memory_allocated() - base

    gc.collect()
    torch.cuda.empty_cache()
    release_pinned(torch)
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    res = {"free_disk_bytes": shutil.disk_usage(root).free}
    try:
        with deterministic(torch):
            d1 = os.path.join(root, "plain")
            b = session(ckpt_dir=d1)
            b.run(half)
            t0 = time.perf_counter()
            b.checkpoint()
            res["checkpoint_call_s"] = time.perf_counter() - t0
            b.wait_for_checkpoints()
            res["save_s"] = time.perf_counter() - t0
            res["bytes_written"] = dir_bytes(d1)
            release_pinned(torch)
            b.run(CKPT_STEPS - half)
            la = [h["loss"] for h in b.history]
            host = {k: x.cpu() for k, x in _tensor_leaves(b.state)}
            count = b.state["count"]
            res["state_bytes"] = sum(x.numel() * x.element_size()
                                     for x in host.values())
            res["largest_leaf_bytes"] = max(x.numel() * x.element_size()
                                            for x in host.values())
            b.close()
            del b
            gc.collect()
            torch.cuda.empty_cache()
            # a new session resumes and runs the rest
            c = session(ckpt_dir=d1)
            res["restore_s"], res["restore_added_bytes"] = restore(c, half)
            shutil.rmtree(d1)
            c.run(CKPT_STEPS - half)
            lc = [h["loss"] for h in c.history]
            res.update(losses=la, resumed_losses=lc, resumed_from=half)
            if lc != la[half:] or not same(c, host, count) or \
                    res["restore_added_bytes"] > 0:
                raise AssertionError(f"resumed run not bitwise the unbroken "
                                     f"one, or the restore held more than "
                                     f"the state: {res}")
            # the moments through the codec, encoded and decoded on the card
            for mod, attr in CKPT_COUNTERS.values():
                setattr(mods[mod], attr, 0)
            K.plain_on_cuda = 0
            d2 = os.path.join(root, "codec")
            c.cfg.ckpt_dir, c.cfg.ckpt_codec = d2, CKPT_CODEC
            t0 = time.perf_counter()
            c.checkpoint()
            c.wait_for_checkpoints()
            res["codec_save_s"] = time.perf_counter() - t0
            res["codec_bytes_written"] = dir_bytes(d2)
            release_pinned(torch)
            c.close()
            del c
            gc.collect()
            torch.cuda.empty_cache()
            r = session(ckpt_dir=d2)
            res["codec_restore_s"], res["codec_restore_added_bytes"] = \
                restore(r, CKPT_STEPS)
            launches = {name: getattr(mods[mod], attr)
                        for name, (mod, attr) in CKPT_COUNTERS.items()}
            res["launches"] = launches
            if any(n == 0 for n in launches.values()) or K.plain_on_cuda:
                raise AssertionError(f"codec checkpoint: launches "
                                     f"{launches}, plain {K.plain_on_cuda}")
            if res["codec_restore_added_bytes"] > \
                    2 * res["largest_leaf_bytes"]:
                raise AssertionError(f"codec restore held more than one "
                                     f"leaf beside the state: {res}")
            cd = get_codec(CKPT_CODEC)
            if not same(r, host, count, lambda x: cd.encode(
                    x, backend="torch").decode(backend="torch")):
                raise AssertionError("codec checkpoint: not the plain round "
                                     "trip")
            r.close()
            del r
            gc.collect()
            torch.cuda.empty_cache()
            # scan chunks on the same rank: the collectives in the graph
            e = session(scan_chunk=GRAPH_CHUNK, log_every=GRAPH_CHUNK)
            le = all_losses(e, CKPT_STEPS)
            res["chunk_losses"] = le
            res["chunk_stats"] = dict(e.stats)
            if le != la or not same(e, host, count) or (
                    e.stats["graph_captures"], e.stats["graph_replays"]) != (
                    1, CKPT_STEPS // GRAPH_CHUNK - 1):
                raise AssertionError(f"distributed scan_chunk="
                                     f"{GRAPH_CHUNK} not bitwise step by "
                                     f"step: {res}")
            e.close()
            del e, host
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 7: the baselines, each through launch.train's path on one NCCL rank
# ---------------------------------------------------------------------------

# the SGD baselines' learning rates, at which the loss falls over
# MODE_STEPS steps at this cut (PERF.md, section 4)
TERNGRAD_ALPHA, EF_SGD_ALPHA = 1e-3, 1e-3
MODE_STEPS = 8
_ADAM = dict(alpha=1e-3, beta=0.99, theta=0.999)
MODE_RUNS = {
    # fp32 both channels: the yardstick
    "dp_adam": (dict(_ADAM, grad_k=None, weight_k=None, mode="dp_adam"),
                {"adam_moments": ("A", "moments_launches")}),
    # the paper's wire plus server EF; amax weights (the absolute grid
    # clips the norm weights at +/-0.496 and would grow es by 0.504 a
    # step, ROADMAP queue 3)
    "efadam": (dict(_ADAM, grad_k=6, weight_k=7, weight_absolute=False,
                    mode="efadam"),
               {"adam_moments": ("A", "moments_launches"),
                "amax_rows": ("K", "amax_launches"),
                "ef_encode_rows_log": ("K", "ef_encode_log_launches"),
                "ef_encode_rows_uniform": ("K", "ef_encode_uniform_launches"),
                "decode_rows_log": ("K", "decode_log_launches"),
                "decode_rows_uniform": ("K", "decode_uniform_launches")}),
    "terngrad": (dict(alpha=TERNGRAD_ALPHA, grad_k=None, weight_k=None,
                      mode="terngrad"),
                 {"amax_rows": ("K", "amax_launches"),
                  "encode_rows_ternary": ("K", "encode_ternary_launches"),
                  "decode_rows_ternary": ("K", "decode_ternary_launches"),
                  "threefry_keys": ("P", "keys_launches"),
                  "threefry_uniform": ("P", "uniform_launches")}),
    "ef_sgd": (dict(alpha=EF_SGD_ALPHA, beta=0.9, grad_k=None, weight_k=None,
                    mode="ef_sgd"),
               {"blockwise_quantize": ("K", "blockwise_quantize_launches"),
                "pack_rows": ("K", "pack_launches"),
                "unpack_rows": ("K", "unpack_launches")}),
}
# ef_sgd's update + exchange with the plain lane pack on the card, before
# #9, at the 8-layer cut (NVIDIA H100 80GB HBM3 at 700 W; PERF.md section
# 5), printed beside this run's as a finding, not a gate
EF_SGD_UPDATE_MS_PLAIN_PACK = 175.001
# the equivalences: a baseline and qadam, bitwise at one worker
MODE_EQUIV = (("dp_adam", dict(_ADAM, grad_k=None, weight_k=None,
                               mode="dp_adam"),
               dict(_ADAM, grad_k=None, weight_k=None, mode="qadam")),
              ("efadam", dict(_ADAM, grad_k=6, weight_k=None, mode="efadam"),
               dict(_ADAM, grad_k=6, weight_k=None, mode="qadam")))


def modes_train(torch, dev, mods, group, model, cfg):
    """Phase 7: each baseline of MODE_RUNS through ``dist_run`` (its
    gates), then MODE_EQUIV's two equivalences."""
    from repro_torch.data.pipeline import batch_for_model
    from repro_torch.dist.step import TrainConfig, make_train_step
    from repro_torch.train.session import SessionConfig, TrainSession
    out = {}
    for name, (kw, counters) in MODE_RUNS.items():
        out[name] = dist_run(torch, dev, mods, group, model, cfg,
                             TrainConfig(**kw), counters, MODE_STEPS, name)
        r = out[name]
        if name == "terngrad":
            art = make_train_step(model, group, TrainConfig(**kw))
            r["graph"] = terngrad_graph(
                torch, dev, mods, lambda chunk: TrainSession.from_artifacts(
                    art, batch_for_model(cfg, TRAIN_SEQ, TRAIN_BATCH, seed=0),
                    SessionConfig(log_every=MODE_STEPS, scan_chunk=chunk),
                    seed=0, device=dev, log=lambda *_: None), MODE_STEPS,
                name)
            del art
            print_terngrad_graph(name, r["graph"])
        print(f"{name}: losses {', '.join(f'{x:.4f}' for x in r['losses'])}; "
              f"wall {r['step_wall_ms']:.3f} ms, device "
              f"{r['step_device_ms']:.3f} ms (idle {r['device_idle']:.1%}), "
              f"{r['tokens_per_s']:.1f} tok/s; phases "
              + ", ".join(f"{k} {v:.3f}" for k, v in r["phases_ms"].items())
              + f" ms; peak {r['peak_bytes']} B; state {r['state_bytes']} B; "
              f"launches {r['launches']}; moved {r['moved_bytes']} (comm "
              f"exchange {r['comm']['update_exchange_bytes']}, broadcast "
              f"{r['comm']['weight_broadcast_bytes']}); stats {r['stats']}; "
              f"wire kernels ms/step {r['wire_kernels_ms']}; "
              f"captured-gradient update bitwise", flush=True)
        for kname, t in r["step_kernels"][:8]:
            print(f"  {t:9.4f} ms  {kname[:90]}")
        if name == "ef_sgd":
            print(f"ef_sgd update+exchange through #9 (the single pass, "
                  f"yi-6b x {cfg.n_layers} layers): "
                  f"{r['phases_ms']['update_exchange']:.3f} ms a step (with "
                  f"the plain lane pack on the card at the 8-layer cut, not "
                  f"comparable at another depth: "
                  f"{EF_SGD_UPDATE_MS_PLAIN_PACK} ms); a finding, not a gate",
                  flush=True)
    out["equivalences"] = {}
    for name, a, b in MODE_EQUIV:
        eq = pair_equivalence(torch, dev, group, model, cfg,
                              TrainConfig(**a), TrainConfig(**b))
        out["equivalences"][name] = eq
        print(f"{name} ({a}) vs qadam ({b}), {eq['steps']} steps: bitwise "
              f"{eq['bitwise']}; losses {eq['losses']}", flush=True)
    return out


def print_terngrad_graph(name, g):
    print(f"{name} with scan_chunk={g['chunk']} on the card ({g['steps']} "
          f"steps): bitwise the step-by-step run {g['bitwise']}; stats "
          f"{g['stats']}; launches {g['launches']}; graphed step wall "
          f"{g['step_wall_ms']:.3f} ms, device {g['step_device_ms']:.3f} ms "
          f"(idle {g['device_idle']:.1%}), the draws (threefry kernels) "
          f"{g['draw_ms']:.3f} ms ({g['draw_ms'] / g['step_device_ms']:.1%} "
          f"of the device step); peak {g['peak_bytes']} B", flush=True)
    for kname, t in g["step_kernels"]:
        print(f"  {t:9.4f} ms  {kname[:90]}")


def _session_run(torch, dev, group, model, cfg, tc, steps):
    """``steps`` steps of ``tc`` from ``model.init(seed=0)``: the losses
    and the master leaves (on the host)."""
    import gc
    from repro_torch.data.pipeline import batch_for_model
    from repro_torch.dist.step import make_train_step
    from repro_torch.train.session import SessionConfig, TrainSession
    from repro_torch.tree import tree_leaves, tree_map
    art = make_train_step(model, group, tc)
    sess = TrainSession.from_artifacts(
        art, batch_for_model(cfg, TRAIN_SEQ, TRAIN_BATCH, seed=0),
        SessionConfig(log_every=1), seed=0, device=dev, log=lambda *_: None)
    sess.run(steps)
    losses = [h["loss"] for h in sess.history]
    params = [x.cpu() for x in tree_leaves(tree_map(
        lambda _, x: x, art.layout.shapes, sess.state["master"]))]
    sess.close()
    del sess, art
    gc.collect()
    torch.cuda.empty_cache()
    return losses, params


def pair_equivalence(torch, dev, group, model, cfg, tc_a, tc_b):
    """Two distributed configurations that must agree bit for bit at one
    worker, EQ_STEPS steps each from the same initialization under
    torch's deterministic algorithms: losses and parameters."""
    with deterministic(torch):
        la, pa = _session_run(torch, dev, group, model, cfg, tc_a, EQ_STEPS)
        lb, pb = _session_run(torch, dev, group, model, cfg, tc_b, EQ_STEPS)
    bitwise = la == lb and all(bits_equal(torch, x, y)
                               for x, y in zip(pa, pb))
    out = dict(bitwise=bitwise, steps=EQ_STEPS, losses=la, other_losses=lb)
    if not bitwise:
        raise AssertionError(f"{tc_a.mode} vs {tc_b.mode}: not bitwise: {out}")
    return out


@contextlib.contextmanager
def deterministic(torch):
    """torch's deterministic algorithms (warnings, not errors, where an
    operation has none; uninitialized memory left unfilled); yields the
    list of warnings caught."""
    import warnings
    import torch.utils.deterministic as det
    fill = det.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True, warn_only=True)
    det.fill_uninitialized_memory = False
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield caught
    finally:
        torch.use_deterministic_algorithms(False)
        det.fill_uninitialized_memory = fill


def equivalence(torch, dev, group, model, cfg):
    """Algorithms 2+3 at one worker against Algorithm 1 (the reference's
    own bar, tests/test_dist_step.py): the distributed step and the
    slice-2 session (qadam, weight_q="uniform:7") from the same
    initialization and batches, EQ_STEPS steps each, with torch's
    deterministic algorithms. Bitwise losses and parameters; where they
    differ, the reference's drift (losses rel LOSS_RTOL, parameters rel
    L2 PARAM_REL_L2) with the nondeterministic operations torch names."""
    from repro_torch.core.qadam import QAdamConfig, qadam
    from repro_torch.data.pipeline import batch_for_model
    from repro_torch.dist.step import TrainConfig
    from repro_torch.train.session import SessionConfig, TrainSession
    from repro_torch.tree import tree_leaves
    with deterministic(torch) as caught:
        dist_losses, dist_params = _session_run(
            torch, dev, group, model, cfg,
            TrainConfig(**DIST_TC, weight_q_min_numel=EQ_MIN_NUMEL), EQ_STEPS)

        def loss_fn(p, b):
            ls, nt = model.loss(p, b)
            return ls / nt
        opt = qadam(QAdamConfig(
            alpha=DIST_TC["alpha"], beta=DIST_TC["beta"],
            theta=DIST_TC["theta"], grad_q=f"log:{DIST_TC['grad_k']}",
            weight_q=f"uniform:{DIST_TC['weight_k']}",
            weight_q_min_numel=EQ_MIN_NUMEL))
        ref = TrainSession.from_optimizer(
            opt, loss_fn, model.init(seed=0, device=dev),
            batch_for_model(cfg, TRAIN_SEQ, TRAIN_BATCH, seed=0),
            SessionConfig(log_every=1), log=lambda *_: None)
        ref.run(EQ_STEPS)
        ref_losses = [h["loss"] for h in ref.history]
        bitwise = dist_losses == ref_losses
        num = den = 0.0
        for a, b in zip(dist_params, tree_leaves(ref.state["params"])):
            a = a.to(dev)
            b = b.reshape(-1)
            bitwise = bitwise and bits_equal(torch, a, b)
            num += float(((a.double() - b.double()) ** 2).sum())
            den += float((b.double() ** 2).sum())
            del a
        ref.close()
        del ref, dist_params
    nondet = sorted({str(w.message)[:200] for w in caught
                     if "deterministic" in str(w.message)})
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(dist_losses,
                                                        ref_losses))
    out = dict(bitwise=bitwise, steps=EQ_STEPS, min_numel=EQ_MIN_NUMEL,
               dist_losses=dist_losses, alg1_losses=ref_losses,
               loss_rel=loss_rel, param_rel_l2=(num / den) ** 0.5,
               nondeterministic=nondet)
    if not bitwise and not (loss_rel <= LOSS_RTOL and
                            out["param_rel_l2"] <= PARAM_REL_L2):
        raise AssertionError(f"Alg 2+3 at one worker vs Algorithm 1: {out}")
    if not bitwise and not nondet:
        raise AssertionError(f"Alg 2+3 vs Algorithm 1 not bitwise, and torch "
                             f"names no nondeterministic operation: {out}")
    return out


# ---------------------------------------------------------------------------
# phase 8: Codec.encode / WireBuffer.decode over the cell's parameters
# ---------------------------------------------------------------------------

WIRE_SPECS = ("log:6", "uniform:7:wire", "uniform_amax:7:wire", "terngrad",
              "blockwise:256")
WIRE_COUNTERS = {"amax_rows": ("K", "amax_launches"),
                 "encode_rows_log": ("K", "encode_log_launches"),
                 "encode_rows_uniform": ("K", "encode_uniform_launches"),
                 "encode_rows_ternary": ("K", "encode_ternary_launches"),
                 "blockwise_encode": ("K", "blockwise_encode_launches"),
                 "decode_rows_log": ("K", "decode_log_launches"),
                 "decode_rows_uniform": ("K", "decode_uniform_launches"),
                 "decode_rows_ternary": ("K", "decode_ternary_launches")}


def wire_buffers(torch, dev, mods, model):
    """Every leaf of the 8-layer cell's initial parameters (seed 0)
    through ``Codec.encode`` -> ``WireBuffer`` -> ``decode`` for each of
    WIRE_SPECS (uniforms from ``draw_uniform`` for TernGrad): #5 (each
    kind; K3 first where the scale is an amax), #8 and K6 launched (counts
    at 0 just before), no plain version on the card, each buffer's bytes
    ``codec.wire_nbytes``; each leaf also through the plain versions,
    bitwise (payloads, scales, decoded leaves)."""
    from repro_torch.comm import codec as CD
    from repro_torch.dist.step import draw_uniform
    from repro_torch.tree import tree_leaves
    K = mods["K"]
    params = tree_leaves(model.init(seed=0, device=dev))
    for mod, attr in WIRE_COUNTERS.values():
        setattr(mods[mod], attr, 0)
    K.plain_on_cuda = 0
    out = {"leaves": len(params), "bytes": {}}
    for spec in WIRE_SPECS:
        codec = CD.get_codec(spec)
        total = 0
        for i, p in enumerate(params):
            u = draw_uniform(0, 1, i, 0, p.numel(), dev) \
                if codec.stochastic else None
            wb = codec.encode(p, u=u)
            y = wb.decode()
            if wb.nbytes != codec.wire_nbytes(p.numel()) or \
                    y.shape != p.shape or not bool(torch.isfinite(y).all()):
                raise AssertionError(f"{spec}: a wire buffer of leaf "
                                     f"{tuple(p.shape)} is malformed")
            total += wb.nbytes
            # the comparison's plain calls are not the path's
            plain = K.plain_on_cuda
            wp = codec.encode(p, u=u, backend="torch")
            if not (bits_equal(torch, wb.payload, wp.payload)
                    and bits_equal(torch, wb.scale, wp.scale)
                    and bits_equal(torch, y, wp.decode(backend="torch"))):
                raise AssertionError(f"{spec}: Codec.encode/decode through "
                                     f"the kernels differs from the plain "
                                     f"versions (leaf {tuple(p.shape)})")
            K.plain_on_cuda = plain
            del wb, y, wp, u
        out["bytes"][spec] = total
    launches = {name: getattr(mods[mod], attr)
                for name, (mod, attr) in WIRE_COUNTERS.items()}
    out["launches"] = launches
    if any(n == 0 for n in launches.values()):
        raise AssertionError(f"a wire-buffer kernel never launched: "
                             f"{launches}")
    if K.plain_on_cuda:
        raise AssertionError(f"{K.plain_on_cuda} plain-version calls on the "
                             f"card (wire buffers)")
    del params
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 9: the paper's comparison protocol on the card
# ---------------------------------------------------------------------------

# 25 (was 300, then 150 for phases 6d, 4l, 4m and 6g, then 50 until
# phases 4 and 6i needed the time)
PAPER_STEPS = 25
PAPER_COUNTERS = {"amax_rows": ("K", "amax_launches"),
                  "uniform_quantize_rows": ("K", "quantize_launches"),
                  "uniform_dequantize_rows": ("K", "dequantize_launches"),
                  "log_dequantize": ("K", "log_dequantize_launches"),
                  "log_quantize": ("K", "log_quantize_launches"),
                  "ternary_quantize": ("K", "ternary_quantize_launches"),
                  "blockwise_quantize": ("K", "blockwise_quantize_launches"),
                  "adam_moments": ("A", "moments_launches"),
                  "ef_quantize": ("A", "ef_quantize_launches")}
# the kernels each mode's run must launch
PAPER_NEEDS = {"qadam": ("ternary_quantize", "blockwise_quantize",
                         "adam_moments", "ef_quantize", "log_dequantize",
                         "amax_rows", "uniform_quantize_rows",
                         "uniform_dequantize_rows"),
               "efadam": ("log_quantize", "log_dequantize", "amax_rows",
                          "adam_moments", "ef_quantize")}


PARITY_STEPS = 3     # steps of each method held kernel against plain


def paper_parity(torch, dev, ex):
    """Every method of both modes at the protocol's shapes (the MLP's
    leaves, batch 128): PARITY_STEPS steps of one worker, each step's
    Q_x weights (``forward_params``) and its update on the captured
    gradients (update, m, v, e) through the kernels and through the plain
    versions, bitwise; where the method has a server codec, that codec's
    ``compute_scale``/``quantize``/``dequantize`` on the update it would
    broadcast, bitwise; WQuan after training, bitwise. Returns the
    tensors compared per method."""
    from repro_torch.core import threefry
    data = ex.classification_dataset(ex.ClsDataConfig(seed=1), device=dev)
    xtr, ytr = data[0], data[1]
    p0 = ex.mlp_init(0, xtr.shape[1], ex.HIDDEN, int(ytr.max()) + 1, dev)
    backends = ("cuda", "torch")

    def same(what, a, b):
        if not bits_equal(torch, a, b):
            raise AssertionError(f"paper protocol: {what} through the "
                                 f"kernels differs from the plain versions "
                                 f"(shape {tuple(a.shape)})")

    def clone(d):
        return {k: v.clone() for k, v in d.items()}

    compared = {}
    for mode in ("qadam", "efadam"):
        for name, (kind, kw, wq_after, srv_q, _) in ex.methods(mode).items():
            opts = {b: ex.build(kind, dict(kw, backend=b)) for b in backends}
            codec = ex.get_codec(srv_q) if srv_q else None
            params = clone(p0)
            state = opts["cuda"].init(params)
            state = state._replace(key=threefry.fold_in(
                state.key.cpu(), 3).to(dev))
            batches = ex.classification_batches(xtr, ytr, 128, seed=3)
            n = 0
            for _ in range(PARITY_STEPS):
                x, y = next(batches)
                fp = {b: opts[b].forward_params(params, state)
                      for b in backends}
                for k in params:
                    same(f"{name}: Q_x of {k}", fp["cuda"][k], fp["torch"][k])
                g = ex._grads(fp["cuda"], x, y)
                outs = {}
                for b in backends:
                    st = state._replace(m=clone(state.m), v=clone(state.v),
                                        e=clone(state.e),
                                        key=state.key.clone())
                    outs[b] = opts[b].update(g, st, params)
                (uc, sc), (ut, st) = outs["cuda"], outs["torch"]
                for k in params:
                    same(f"{name}: update of {k}", uc[k], ut[k])
                    for f in ("m", "v", "e"):
                        same(f"{name}: {f} of {k}", getattr(sc, f)[k],
                             getattr(st, f)[k])
                    n += 5
                    if codec is None:
                        continue
                    sent = {}
                    for b in backends:
                        scale = codec.compute_scale(uc[k], backend=b)
                        codes = codec.quantize(uc[k], scale, backend=b)
                        sent[b] = (scale, codes,
                                   codec.dequantize(codes, scale, backend=b))
                    for what, a, c in zip(("scale", "codes", "dequantized"),
                                          sent["cuda"], sent["torch"]):
                        same(f"{name}: server {srv_q} {what} of {k}", a, c)
                    n += 3
                state = sc
                params = ex.apply_updates(params, uc)
            if wq_after is not None:
                wq = {b: ex.wquan(params, k_x=wq_after, absolute=False,
                                  backend=b) for b in backends}
                for k in params:
                    same(f"{name}: WQuan of {k}", wq["cuda"][k],
                         wq["torch"][k])
                    n += 1
            compared[name] = n
    return compared


def paper_protocol(torch, dev, mods):
    """``examples/paper_repro_torch.py``'s comparison, PAPER_STEPS steps,
    one seed, 8 workers, in its default mode and ``--mode efadam``, each
    with every count at 0 just before it; gates: every method's kernels
    bitwise their plain versions at the protocol's shapes first
    (``paper_parity``), every method's accuracy finite, PAPER_NEEDS's
    kernels launched, no plain version on the card."""
    import importlib.util
    K, A = mods["K"], mods["A"]
    spec = importlib.util.spec_from_file_location(
        "paper_repro_torch", os.path.join(HERE, "examples",
                                          "paper_repro_torch.py"))
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    out = {"parity": paper_parity(torch, dev, ex)}
    for mode in ("qadam", "efadam"):
        for mod, attr in PAPER_COUNTERS.values():
            setattr(mods[mod], attr, 0)
        K.plain_on_cuda = A.plain_on_cuda = mods["P"].plain_on_cuda = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = ex.compare(mode, steps=PAPER_STEPS, seeds=1, workers=8,
                          device=dev, log=lambda line: print(
                              f"  paper {mode}: {line}", flush=True))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = {k: getattr(mods[mod], attr)
                    for k, (mod, attr) in PAPER_COUNTERS.items()}
        plain = K.plain_on_cuda + A.plain_on_cuda + mods["P"].plain_on_cuda
        if not all(math.isfinite(a) for _, a, _ in rows):
            raise AssertionError(f"paper {mode}: an accuracy is not finite: "
                                 f"{rows}")
        if any(launches[k] == 0 for k in PAPER_NEEDS[mode]) or plain:
            raise AssertionError(f"paper {mode}: kernels {launches}, plain "
                                 f"versions on the card {plain}")
        out[mode] = dict(rows=rows, launches=launches, run_s=run_s,
                         steps=PAPER_STEPS, seeds=1, workers=8)
    out["adaptive"] = paper_adaptive(torch, dev, mods, ex)
    return out


# 24 steps in two plans, 10 on the deep lanes (50, 25, 20 until phases 4
# and 6i needed the time)
PAPER_ADAPT_STEPS, PAPER_ADAPT_EVERY, PAPER_DEEP_STEPS = 24, 12, 10


def paper_adaptive(torch, dev, mods, ex):
    """``paper_repro_torch.py --adaptive``: the fixed log:6 arm against
    the adaptive arm (PAPER_ADAPT_STEPS steps, a replan every
    PAPER_ADAPT_EVERY, budget ADAPT_BUDGET, one seed, 8 workers), then the
    fixed arm on the deep lanes (``run_quantized(fixed_spec=...)``,
    PAPER_DEEP_STEPS steps each: #10 and K11 at log:30 and log:126), every
    count at 0 just before; gates: finite losses, the deep lanes' #10 and
    K11 launched, no plain version on the card."""
    from repro_torch.data.pipeline import ClsDataConfig, classification_dataset
    K, A = mods["K"], mods["A"]
    for mod, attr in PAPER_COUNTERS.values():
        setattr(mods[mod], attr, 0)
    K.plain_on_cuda = A.plain_on_cuda = mods["P"].plain_on_cuda = 0
    clear_by_spec(K)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results, summary = ex.run_adaptive_compare(
        steps=PAPER_ADAPT_STEPS, seeds=1, workers=8, budget=ADAPT_BUDGET,
        replan_every=PAPER_ADAPT_EVERY, device=dev,
        log=lambda line: print(f"  paper adaptive: {line}", flush=True))
    data = classification_dataset(ClsDataConfig(seed=1), device=dev)
    deep = {}
    for spec in ("log:30", "log:126"):
        p0 = ex.mlp_init(0, data[2].shape[1], ex.HIDDEN,
                         int(data[1].max()) + 1, dev)
        _, info = ex.run_quantized(PAPER_DEEP_STEPS, data, p0, seed=0,
                                   n_workers=8, fixed_spec=spec)
        deep[spec] = dict(final_test_loss=info["final_test_loss"],
                          bytes_per_step=info["bytes_per_step"])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {k: getattr(mods[mod], attr)
                for k, (mod, attr) in PAPER_COUNTERS.items()}
    launches.update(by_spec_launches(K))
    plain = K.plain_on_cuda + A.plain_on_cuda + mods["P"].plain_on_cuda
    need = [lane_row(n, s) for n in ("log_quantize", "log_dequantize")
            for s in ("log:30", "log:126")]
    losses = [r["loss"] for r in results.values()] + [
        d["final_test_loss"] for d in deep.values()]
    if plain or any(not launches[k] for k in need) or \
            not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"paper adaptive: launches {launches}, plain "
                             f"versions on the card {plain}, losses "
                             f"{losses}")
    return dict(summary=summary, launches=launches, run_s=run_s, deep=deep,
                steps=PAPER_ADAPT_STEPS, replan_every=PAPER_ADAPT_EVERY,
                plan_log=results["adaptive"]["plan_log"],
                arms={k: {f: v[f] for f in ("loss", "acc", "bytes_per_step")}
                      for k, v in results.items()})


# ---------------------------------------------------------------------------
# phase 4: full-width serving
# ---------------------------------------------------------------------------

def first_layers(blocks, n: int):
    """The first ``n`` layers of a scan-stacked subtree (QuantizedLeafs
    keep their per-layer scales)."""
    from repro_torch.serve.quantized import is_qleaf, tree_map_with_path
    return tree_map_with_path(
        lambda _, l: dataclasses.replace(
            l, codes=l.codes[:n], scale=l.scale[:n],
            shape=(n,) + tuple(l.shape[1:])) if is_qleaf(l) else l[:n],
        blocks)


def window_live(torch, dev, model, qparams, gather, prompt, max_seq):
    """Prefill ``prompt`` (longer than the window) into a fresh one-slot
    paged cache, then one decode step past the window's reach with the
    config's per-layer windows and with every window 0: the logits must
    differ (the local layers' mask bites at its real width). Also the
    depth-2 kernels-vs-plain gate at that position, and the step's time at
    that view."""
    from repro_torch.models.model import Model
    cfg = model.cfg
    n = len(prompt)
    cache = model.init_cache(1, max_seq, page_pool=(max_seq // 16, 16),
                             device=dev)
    cache["ptab"].copy_(torch.arange(max_seq // 16, dtype=torch.int32,
                                     device=dev)[None])
    toks = torch.tensor(prompt, dtype=torch.int32, device=dev)[None]
    for c0 in range(0, n, 512):
        chunk = torch.zeros((1, 512), dtype=torch.int32, device=dev)
        m = min(512, n - c0)
        chunk[:, :m] = toks[:, c0:c0 + m]
        model.decode_chunk(qparams, {"token": chunk}, cache,
                           torch.tensor([c0], device=dev),
                           torch.tensor([m], device=dev), gather)
    tok = toks[:, -1:].contiguous()
    pos = torch.full((1,), n, dtype=torch.int32, device=dev)

    def clone(depth=None):
        return {k: (v if k == "ptab" or depth is None else v[:depth]).clone()
                for k, v in cache.items()}
    la, _ = model.decode_step(qparams, {"token": tok}, clone(), pos, gather)
    glob = Model(dataclasses.replace(cfg, window=None))
    lg, _ = glob.decode_step(qparams, {"token": tok}, clone(), pos, gather)
    if torch.equal(la, lg):
        raise AssertionError(f"decode at position {n}: the windowed and the "
                             f"global model give the same logits")
    rel_win = float((la - lg).norm() / lg.norm())
    rel_base = None
    if cfg.rope_theta_local is not None:
        # the local layers' RoPE base is live: one base for every layer
        one = Model(dataclasses.replace(cfg, rope_theta_local=None))
        lb1, _ = one.decode_step(qparams, {"token": tok}, clone(), pos, gather)
        if torch.equal(la, lb1):
            raise AssertionError(f"decode at position {n}: the local RoPE "
                                 f"base {cfg.rope_theta_local} and the "
                                 f"global {cfg.rope_theta} give the same "
                                 f"logits")
        rel_base = float((la - lb1).norm() / lb1.norm())
    mdl = Model(dataclasses.replace(cfg, n_layers=2))
    qp = dict(qparams, blocks=first_layers(qparams["blocks"], 2))
    a, _ = mdl.decode_step(qp, {"token": tok}, clone(2), pos, gather)
    b, _ = mdl.decode_step(qp, {"token": tok}, clone(2), pos, gather,
                           backend="torch")
    rel2 = float((a - b).norm() / b.norm())
    if rel2 > SHALLOW_LIMIT:
        raise AssertionError(f"decode logits at depth 2, position {n}: "
                             f"kernels vs plain rel L2 {rel2} > "
                             f"{SHALLOW_LIMIT}")
    step_ms = cuda_ms(torch, lambda i: model.decode_step(
        qparams, {"token": tok}, cache, pos, gather), 5, 1)
    base = ("" if rel_base is None else
            f"; local base {cfg.rope_theta_local:g} vs {cfg.rope_theta:g} "
            f"everywhere {rel_base:.4e}")
    print(f"{cfg.name} at position {n} (window {cfg.window}): logits rel L2 "
          f"windowed vs global {rel_win:.4e}{base}; depth-2 kernels vs plain "
          f"{rel2:.4e} (limit {SHALLOW_LIMIT}); decode step, 1 slot, view "
          f"{max_seq}: {step_ms:.3f} ms", flush=True)
    return dict(long_position=n, logits_rel_l2_window_vs_global=rel_win,
                logits_rel_l2_local_base_vs_global=rel_base,
                logits_rel_l2_depth2_long=rel2, step_ms=step_ms)


def zero_serving_counts(MM, paged, K):
    """Every count of the serving paths' kernels, and of their plain
    versions on the card, at 0."""
    from repro_torch.kernels import prng as P
    from repro_torch.serve import quantized as Q
    MM.launches = MM.launches_tc = MM.launches_tc_packed = 0
    MM.launches_fma = MM.t_launches = MM.t_launches_tc = 0
    MM.t_launches_fma = 0
    paged.launches = paged.launches_kv = 0
    K.amax_launches = K.quantize_launches = K.dequantize_launches = 0
    MM.plain_on_cuda = paged.plain_on_cuda = K.plain_on_cuda = 0
    Q.plain_on_cuda = 0
    P.trunc_normal_launches = P.categorical_launches = P.plain_on_cuda = 0


def serving_plain(MM, paged, K) -> int:
    """Plain-version calls on the card since the counts were zeroed: the
    serving kernels', the at-use dequantize's (K12 bypassed) and the
    threefry draws' (the weights' truncated normal, the sampling step)."""
    from repro_torch.kernels import prng as P
    from repro_torch.serve import quantized as Q
    return (MM.plain_on_cuda + paged.plain_on_cuda + K.plain_on_cuda
            + Q.plain_on_cuda + P.plain_on_cuda)


# profiled calls of a serving phase's decode step and chunk: one, since
# the profiler's bookkeeping of an eager call's thousands of operations,
# not the card, sets these calls' cost (with three, half of phase 4l's
# seconds)
PROFILED_CALLS = 1


def decode_timings(torch, dev, model, qparams, gather, prompts, max_seq):
    """Prefill each prompt (a multiple of 32 tokens) into its slot of a
    fresh paged cache of ``max_seq`` positions a slot, then time one
    32-token chunk (slot 0) and one decode step (every slot): CUDA events
    around the host's calls (the step's wall on the device's clock) and
    the profiler's device time, with the device operations (kernels,
    copies, fills) each runs. Returns (timings, cache, tok, pos), the last
    three the decode step's inputs."""
    slots, plen = len(prompts), len(prompts[0])
    cache = model.init_cache(slots, max_seq,
                             page_pool=(slots * max_seq // 16, 16),
                             device=dev)
    npag = max_seq // 16
    cache["ptab"].copy_(torch.arange(slots * npag, dtype=torch.int32,
                                     device=dev).reshape(slots, npag))
    prompt = torch.tensor(prompts, dtype=torch.int32, device=dev)
    lane = lambda s: {"pk": cache["pk"], "pv": cache["pv"],
                      "ptab": cache["ptab"][s:s + 1]}
    for s in range(slots):
        for c0 in range(0, plen, 32):
            model.decode_chunk(qparams, {"token": prompt[s:s + 1, c0:c0 + 32]},
                               lane(s), torch.tensor([c0], device=dev),
                               torch.tensor([32], device=dev), gather)
    c32 = torch.tensor([32], device=dev)

    def chunk():
        return model.decode_chunk(qparams, {"token": prompt[0:1, 32:64]},
                                  lane(0), c32, c32, gather)
    tok = prompt[:, -1:].contiguous()
    pos = torch.full((slots,), plen, dtype=torch.int32, device=dev)

    def step():
        return model.decode_step(qparams, {"token": tok}, cache, pos, gather)
    chunk_ms = cuda_ms(torch, lambda i: chunk(), 5, 1)
    chunk_dev_ms, _, chunk_ops = profile_ms(torch, chunk, PROFILED_CALLS,
                                            with_launches=True)
    step_ms = cuda_ms(torch, lambda i: step(), 10, 2)
    step_dev_ms, step_kernels, step_ops = profile_ms(torch, step,
                                                     PROFILED_CALLS,
                                                     with_launches=True)
    return (dict(chunk_ms=chunk_ms, chunk_device_ms=chunk_dev_ms,
                 chunk_device_ops=chunk_ops, decode_step_ms=step_ms,
                 decode_step_device_ms=step_dev_ms,
                 decode_step_device_ops=step_ops,
                 decode_step_kernels=step_kernels[:12]),
            cache, tok, pos)


def randomize_extras(torch, params, dev, seed=5):
    """QKV biases N(0, 0.5^2) and qk-norm weights 1 + N(0, 0.3^2) from a
    seeded generator, in place of init's zeros and ones, which would hide
    a missing or swapped term."""
    g = torch.Generator(device=dev).manual_seed(seed)
    attn = params["blocks"]["attn"]
    for name, base, sd in (("bq", 0.0, 0.5), ("bk", 0.0, 0.5),
                           ("bv", 0.0, 0.5), ("q_norm", 1.0, 0.3),
                           ("k_norm", 1.0, 0.3)):
        if name in attn:
            attn[name] = base + sd * torch.randn(attn[name].shape,
                                                 generator=g, device=dev)


class LogitsTap:
    """A model whose decode steps also copy their logits into ``buf``: a
    captured step records the copy, so a replay's logits can be read."""

    def __init__(self, model, buf):
        self.model, self.buf = model, buf

    def decode_step(self, *args, **kw):
        logits, cache = self.model.decode_step(*args, **kw)
        self.buf.copy_(logits)
        return logits, cache

    def __getattr__(self, name):
        return getattr(self.model, name)


def decode_graph_vs_eager(torch, dev, model, qparams, prompts, max_new=64,
                          paged=True, max_seq=128, chunk=32, sample=False):
    """The session's decode step eager and as its CUDA graph: a session
    of len(prompts) slots (``max_seq`` positions each, paged with page 16
    or fixed lanes, prefill chunk ``chunk``) past its prompts' chunks; from identical state one greedy step eager
    and one through a fresh capture and replay must give bitwise the same
    logits, tokens and state (cache included); then each way's wall
    (CUDA events around the host's calls), device time and operations
    (profiler), and idle share, the slots decoding throughout. With
    ``sample`` the sampling step (every slot at temperature 0.8, the
    categorical kernel and its fold) in place of the greedy one, and that
    kernel bitwise its plain step on the session's own logits,
    temperatures and keys."""
    from repro_torch.serve.session import Request, ServeSession
    slots = len(prompts)
    sess = ServeSession(model, qparams, slots=slots, max_seq=max_seq,
                        paged=paged, page_size=16, prefill_chunk=chunk,
                        seed=0, device=dev)
    for p in prompts:
        sess.submit(Request(prompt=p, max_new_tokens=max_new,
                            temperature=0.8 if sample else 0.0))
    while sess._prefill_q:
        sess.step()
    buf = torch.empty((slots, model.cfg.vocab_size), dtype=torch.float32,
                      device=dev)
    sess.model = LogitsTap(model, buf)
    sess._graphs.clear()              # the next capture records the tap
    tensors = [t for _, t in sess._state_tensors()]
    snap = [t.clone() for t in tensors]
    sess._decode(sample)
    eager = [t.clone() for t in tensors] + [buf.clone()]
    for t, v in zip(tensors, snap):
        t.copy_(v)
    del snap
    sess._warm.add(sample)
    sess._dispatch(sample)             # capture, then replay
    got = tensors + [buf]
    bad = [name for (name, _), a, b in zip(
        sess._state_tensors() + [("logits", None)], got, eager)
        if not torch.equal(a, b)]
    if bad:
        raise AssertionError(f"{model.cfg.name}: the graphed decode step "
                             f"differs from the eager one in {bad}")
    del eager
    if sample:      # the kernel on the session's own logits, temps, keys
        from repro_torch.kernels import prng as P
        st = sess._state
        ka, kb = st["rng"].clone(), st["rng"].clone()
        ga, sa = P.categorical_step(buf, st["temp"], ka, backend="cuda")
        gb, sb = P.categorical_step(buf, st["temp"], kb, backend="torch")
        if not (torch.equal(ga, gb) and torch.equal(sa, sb)
                and torch.equal(ka, kb)):
            raise AssertionError(f"{model.cfg.name}: the sampling kernel "
                                 f"differs from its plain step on the "
                                 f"session's logits {tuple(buf.shape)}")
    graph = sess._graphs[sample]
    e_ms = cuda_ms(torch, lambda i: sess._decode(sample), 8, 1)
    g_ms = cuda_ms(torch, lambda i: graph.replay(), 8, 1)
    e_dev, e_kernels, e_ops = profile_ms(torch, lambda: sess._decode(sample),
                                         PROFILED_CALLS, with_launches=True)
    g_dev, _, g_ops = profile_ms(torch, graph.replay, PROFILED_CALLS,
                                 with_launches=True)
    active = int(sess._state["active"].sum())
    if active != slots:
        raise AssertionError(f"{active} of {slots} slots active while timed")
    out = dict(eager_ms=e_ms, eager_device_ms=e_dev, eager_device_ops=e_ops,
               eager_idle=1 - e_dev / e_ms, graph_ms=g_ms,
               graph_device_ms=g_dev, graph_device_ops=g_ops,
               graph_idle=1 - g_dev / g_ms, bitwise=True,
               eager_kernels=e_kernels[:8],
               position=int(sess._state["pos"][0]))
    del sess, graph
    torch.cuda.empty_cache()
    return out


def init_yardstick_s(torch, dev, model) -> float:
    """Seconds of the yardstick init: ``model``'s tree with every weight
    drawn by ``torch.nn.init.trunc_normal_`` (Philox) times its std,
    ones and zeros as ``Model.init`` has them; the tree dropped after."""
    from repro_torch.tree import tree_leaves
    shapes = tree_leaves(model.init(device="meta"))
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tree = []
    for m in shapes:
        t = torch.empty(m.shape, dtype=torch.float32, device=dev)
        torch.nn.init.trunc_normal_(t, 0.0, 0.02, -0.04, 0.04, generator=gen)
        tree.append(t)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    del tree
    torch.cuda.empty_cache()
    return dt


def serve(torch, dev, mods, arch="yi-6b", max_seq=128, long_plen=0,
          sampled=False):
    """Serve full-width ``arch`` (phase 4: yi-6b; phase 4b: gemma2-2b with
    one ``long_plen``-token request past its window, in a session of
    ``max_seq`` positions a slot; 4g: gemma3-4b likewise, its local RoPE
    base checked too; 4h: qwen2.5-14b), the weights quantized leaf by leaf
    as the launcher does (each float32 leaf dropped once its codes
    exist), random QKV biases and qk-norm weights where the model has
    them; then the decode gates and the decode step eager and graphed.
    ``sampled`` (phase 4): half the requests at temperature 0.8, so the
    sampling step runs eager, then captured and replayed (the categorical
    kernel and its fold), the tokens equal an eager session's, and the
    sampled step is timed beside the greedy one; ``Model.init``'s seconds
    through the truncated-normal kernel beside a ``trunc_normal_`` init
    of the same tree."""
    MM, paged, K = mods["MM"], mods["paged"], mods["K"]
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import quantize_in_place
    from repro_torch.models.model import Model
    from repro_torch.serve.quantized import make_dequant_gather, params_nbytes
    from repro_torch.serve.session import Request, ServeSession
    import numpy as np

    from repro_torch.kernels import prng as P
    cfg = get_config(arch)
    model = Model(cfg)
    slots, n_req, plen, max_new = 4, 8, 64, 16
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=[int(t) for t in rng.integers(
        1, cfg.vocab_size, size=plen)], max_new_tokens=max_new,
        temperature=0.8 if sampled and i % 2 else 0.0)
        for i in range(n_req)]
    yard_s = init_yardstick_s(torch, dev, model) if sampled else None
    if long_plen:
        reqs.append(Request(prompt=[int(t) for t in rng.integers(
            1, cfg.vocab_size, size=long_plen)], max_new_tokens=max_new))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # the main path, with every kernel count at 0 just before it
    zero_serving_counts(MM, paged, K)
    t0 = time.perf_counter()
    params = model.init(seed=0, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    randomize_extras(torch, params, dev)
    fp_bytes = params_nbytes(params)
    qparams = quantize_in_place(params, k_x=6, pack=True)
    del params
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    peak_start = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    q_bytes = params_nbytes(qparams)
    sess = ServeSession(model, qparams, slots=slots, max_seq=max_seq,
                        paged=True, page_size=16, prefill_chunk=32, seed=0,
                        device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    handles = [sess.submit(r) for r in reqs]
    results = sess.drain()
    torch.cuda.synchronize()
    t_serve = time.perf_counter() - t1
    # bf16 activations against int8 codes: K1 on tensor cores only; the
    # cache view of a layer one K2 launch (K and V)
    launches = {"dequant_matmul_tc": MM.launches_tc,
                "gather_pages": paged.launches,
                "gather_pages_kv": paged.launches_kv,
                "amax_rows": K.amax_launches,
                "uniform_quantize_rows": K.quantize_launches,
                "threefry_trunc_normal": P.trunc_normal_launches}
    if sampled:
        launches["threefry_categorical"] = P.categorical_launches
        if not sess._graphs.get(True):
            raise AssertionError(f"{arch}: the sampling step was not "
                                 f"graphed: {sess.stats}")
    if MM.launches_fma or MM.launches_tc_packed:
        raise AssertionError(f"{arch}: K1's CUDA-core route launched "
                             f"{MM.launches_fma} times, its packed-lane "
                             f"instances {MM.launches_tc_packed} times on "
                             f"bf16 int8 codes")
    if paged.launches != paged.launches_kv:
        raise AssertionError(f"{arch}: {paged.launches - paged.launches_kv} "
                             f"K2 launches gathered one pool")
    if cfg.tie_embeddings:      # the tied head runs K1t, on tensor cores
        launches["dequant_matmul_t_tc"] = MM.t_launches_tc
        if MM.t_launches_fma or MM.t_launches != MM.t_launches_tc:
            raise AssertionError(f"{arch}: K1t's CUDA-core route launched "
                                 f"{MM.t_launches_fma} times in bf16 serving")
    elif MM.t_launches:
        raise AssertionError(f"{arch}: K1t launched on an untied head")
    plain = serving_plain(MM, paged, K)

    if any(n == 0 for n in launches.values()):
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    if plain:
        raise AssertionError(f"{plain} plain-version calls on the card")
    if not (sess.stats["captures"] and sess.stats["replays"]):
        raise AssertionError(f"{arch}: the decode step was not graphed: "
                             f"{sess.stats}")
    for h in handles:
        r = results[h]
        if len(r.tokens) != max_new or r.finish_reason != "length":
            raise AssertionError(f"request {h}: {len(r.tokens)} tokens, "
                                 f"{r.finish_reason}")
    n_tok = sum(len(results[h].tokens) for h in handles)
    gather = make_dequant_gather()
    out = {}
    if sampled:
        # the same requests through an eager session: the same tokens
        eager = ServeSession(model, qparams, slots=slots, max_seq=max_seq,
                             paged=True, page_size=16, prefill_chunk=32,
                             seed=0, device=dev)
        eager._dispatch = eager._decode
        hs = [eager.submit(r) for r in reqs]
        er = eager.drain()
        if [er[h].tokens for h in hs] != [results[h].tokens for h in handles]:
            raise AssertionError(f"{arch}: the graphed session's sampled "
                                 f"tokens differ from the eager session's")
        del eager, er
        out.update(init_s=t_init, init_yardstick_s=yard_s,
                   sampled_requests=sum(r.temperature > 0 for r in reqs))
    if long_plen:
        out.update(window_live(torch, dev, model, qparams, gather,
                               reqs[-1].prompt, max_seq))
        out["decode_step_long_view_ms"] = out.pop("step_ms")
        out["view_len"] = max_seq
        max_seq = 128        # the timings and gates below at yi's view

    # one decode step and one chunk, timed, on a fresh cache
    tm, cache, tok, pos = decode_timings(
        torch, dev, model, qparams, gather,
        [reqs[i].prompt for i in range(slots)], max_seq)
    dg = decode_graph_vs_eager(torch, dev, model, qparams,
                               [reqs[i].prompt[:32] for i in range(slots)])
    print(f"{arch} session decode step, 4 slots at position "
          f"{dg['position']}: eager {dg['eager_ms']:.3f} ms wall, "
          f"{dg['eager_device_ms']:.3f} ms device (idle "
          f"{dg['eager_idle']:.1%}, {dg['eager_device_ops']:.0f} operations);"
          f" CUDA graph {dg['graph_ms']:.3f} ms wall, "
          f"{dg['graph_device_ms']:.3f} ms device (idle "
          f"{dg['graph_idle']:.1%}, {dg['graph_device_ops']:.0f} "
          f"operations); one step bitwise eager vs graphed (logits, tokens, "
          f"cache)", flush=True)
    if sampled:
        ds = decode_graph_vs_eager(torch, dev, model, qparams,
                                   [reqs[i].prompt[:32] for i in
                                    range(slots)], sample=True)
        out["decode_graph_sampled"] = ds
        print(f"{arch} session sampled decode step (every slot at "
              f"temperature 0.8): eager {ds['eager_ms']:.3f} ms wall, "
              f"{ds['eager_device_ms']:.3f} ms device; CUDA graph "
              f"{ds['graph_ms']:.3f} ms wall, {ds['graph_device_ms']:.3f} ms "
              f"device (idle {ds['graph_idle']:.1%}); greedy step graphed "
              f"{dg['graph_ms']:.3f} / {dg['graph_device_ms']:.3f}; one step "
              f"bitwise eager vs graphed (keys too); Model.init "
              f"{t_init:.3f} s through the truncated-normal kernel, a "
              f"trunc_normal_ init of the same tree {yard_s:.3f} s; graphed "
              f"session tokens equal the eager session's "
              f"({out['sampled_requests']} of {len(reqs)} requests "
              f"sampled)", flush=True)

    # identical state through the kernels and through the plain versions
    def rel_l2(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    def both(mdl, qp, cache_of):
        """Logits of one decode step through the kernels and through the
        plain versions, each on its own copy of the state."""
        la, _ = mdl.decode_step(qp, {"token": tok}, cache_of(), pos, gather)
        lb, _ = mdl.decode_step(qp, {"token": tok}, cache_of(), pos, gather,
                                backend="torch")
        return la, lb

    def clone():
        return {k: v.clone() for k, v in cache.items()}
    la, lb = both(model, qparams, clone)
    if not bool(torch.isfinite(la).all()) or la.shape != (slots, cfg.vocab_size):
        raise AssertionError("decode logits not finite or misshapen")
    rel = rel_l2(la, lb)
    agree = float((la.argmax(-1) == lb.argmax(-1)).float().mean())

    # Gates where summation-order noise has not compounded: the bf16 step
    # cut to its first 1 and 2 layers, and the full-depth step in float32
    # activations (the same kernels' f32 instances).
    shallow = {}
    for n in (1, 2):
        mdl = Model(dataclasses.replace(cfg, n_layers=n))
        qp = dict(qparams, blocks=first_layers(qparams["blocks"], n))
        a, b = both(mdl, qp, lambda: {k: (v[:n] if k != "ptab" else v).clone()
                                      for k, v in cache.items()})
        shallow[n] = rel_l2(a, b)
        if shallow[n] > SHALLOW_LIMIT:
            raise AssertionError(f"decode logits at depth {n}: kernels vs "
                                 f"plain rel L2 {shallow[n]} > {SHALLOW_LIMIT}")
    m32 = Model(dataclasses.replace(cfg, dtype="float32"))

    def clone32():
        return {k: v.float() if v.is_floating_point() else v.clone()
                for k, v in cache.items()}
    a32, b32 = both(m32, qparams, clone32)
    rel32 = rel_l2(a32, b32)
    if rel32 > F32_LIMIT:
        raise AssertionError(f"float32 decode logits: kernels vs plain rel "
                             f"L2 {rel32} > {F32_LIMIT}")

    # readings, not gates: float64 sums in the plain product (how far two
    # fp32 summation orders drift apart over 32 bf16 layers on their own),
    # and a planted fault (one K row dropped from every plain projection)
    plain32 = MM._matmul_torch

    def plain64(x2, codes, scale, transpose=False, **kw):
        w = MM.dequant_codes(codes, scale, **kw).double()
        return (x2.double() @ (w.T if transpose else w)).to(
            MM._out_dtype(x2.dtype, kw["w_dtype"], kw["cast_dtype"]))

    def dropped_row(x2, codes, scale, transpose=False, **kw):
        w = MM.dequant_codes(codes, scale, **kw).float()
        w = w.T if transpose else w
        return (x2[:, :-1].float() @ w[:-1]).to(
            MM._out_dtype(x2.dtype, kw["w_dtype"], kw["cast_dtype"]))
    try:
        MM._matmul_torch = plain64
        lc, _ = model.decode_step(qparams, {"token": tok}, clone(), pos,
                                  gather, backend="torch")
        MM._matmul_torch = dropped_row
        lf, _ = m32.decode_step(qparams, {"token": tok}, clone32(), pos,
                                gather, backend="torch")
    finally:
        MM._matmul_torch = plain32
    rel_k64, rel_p64 = rel_l2(la, lc), rel_l2(lb, lc)
    rel_fault = rel_l2(lf, b32)
    print(f"{arch} decode logits rel L2, kernels vs plain: bf16 {rel:.4e} (argmax "
          f"agreement {agree:.3f}), bf16 at depth 1 {shallow[1]:.4e} and 2 "
          f"{shallow[2]:.4e} (limit {SHALLOW_LIMIT}), float32 {rel32:.4e} "
          f"(limit {F32_LIMIT}); readings: bf16 vs float64 sums kernels "
          f"{rel_k64:.4e} plain {rel_p64:.4e}; float32 with one K row "
          f"dropped {rel_fault:.4e}", flush=True)
    return dict(out, **tm, arch=arch, launches=launches, tokens=n_tok,
                decode_graph=dg, layers=cfg.n_layers,
                serve_s=t_serve,
                tok_per_s=n_tok / t_serve, startup_s=t_quant,
                resident_bytes=q_bytes, fp32_bytes=fp_bytes,
                peak_startup_bytes=peak_start,
                peak_bytes=torch.cuda.max_memory_allocated(),
                logits_rel_l2=rel, logits_rel_l2_kernels_vs_f64=rel_k64,
                logits_rel_l2_plain_vs_f64=rel_p64, argmax_agreement=agree,
                logits_rel_l2_depth1=shallow[1],
                logits_rel_l2_depth2=shallow[2], logits_rel_l2_f32=rel32,
                logits_rel_l2_f32_row_dropped=rel_fault,
                stats=dict(sess.stats))


# phase 4d: code-resident serving at 4-bit packed lanes (k_x = 2), K1 on
# tensor cores; yi-6b's widths cut to PACKED_LAYERS layers. Phase 4e: the
# same cut served in float32 activations against int8 codes, the path of
# K1's CUDA-core route; phase 4f: gemma2-2b's widths cut the same way in
# float32, the path of K1t's CUDA-core route (the tied head)
PACKED_LAYERS = 4
# phases 4e and 4f before K1's CUDA-core route was redesigned: the decode
# step's and the chunk's device ms (NVIDIA H100 80GB HBM3 at 700 W;
# PERF.md section 5), printed beside this run's as a finding, not a gate
F32_SERVE_BEFORE = {"yi-6b": (2.087, 6.591), "gemma2-2b": (1.950, 3.785)}


def serve_packed(torch, dev, mods, arch="yi-6b", dtype="bfloat16"):
    """Serve full-width ``arch`` cut to PACKED_LAYERS layers, 4 requests of
    64-token prompts, 16 new tokens each, through the paged session; the
    counts at 0 just before and read just after. bfloat16 (phase 4d):
    weights resident as 4-bit lanes (``quantize_params(k_x=2,
    pack=True)``), K1 on tensor cores only. float32 (phases 4e, 4f): int8
    codes (k_x = 6), K1 (and a tied head's K1t) on CUDA cores only. Then
    the decode step's and the chunk's wall and device time, and the
    session's decode step eager and graphed (``decode_graph_vs_eager``)."""
    MM, paged, K = mods["MM"], mods["paged"], mods["K"]
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.serve.quantized import (make_dequant_gather,
                                             params_nbytes, quantize_params)
    from repro_torch.serve.session import Request, ServeSession
    import numpy as np

    packed = dtype == "bfloat16"
    cfg = dataclasses.replace(get_config(arch), n_layers=PACKED_LAYERS,
                              dtype=dtype)
    model = Model(cfg)
    slots, plen, max_new = 4, 64, 16
    rng = np.random.default_rng(1)
    reqs = [Request(prompt=[int(t) for t in rng.integers(
        1, cfg.vocab_size, size=plen)], max_new_tokens=max_new)
        for _ in range(slots)]
    torch.cuda.synchronize()
    zero_serving_counts(MM, paged, K)
    params = model.init(seed=0, device=dev)
    qparams = quantize_params(params, k_x=2 if packed else 6, pack=True)
    del params
    sess = ServeSession(model, qparams, slots=slots, max_seq=128,
                        paged=True, page_size=16, prefill_chunk=32, seed=0,
                        device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    handles = [sess.submit(r) for r in reqs]
    results = sess.drain()
    torch.cuda.synchronize()
    t_serve = time.perf_counter() - t0
    k1 = ("dequant_matmul_tc_packed" if packed else "dequant_matmul")
    launches = {k1: MM.launches_tc_packed if packed else MM.launches_fma,
                "gather_pages": paged.launches,
                "gather_pages_kv": paged.launches_kv,
                "amax_rows": K.amax_launches,
                "uniform_quantize_rows": K.quantize_launches}
    if packed:
        launches["dequant_matmul_tc"] = MM.launches_tc
    if cfg.tie_embeddings:       # float32: K1t's CUDA-core route only
        launches["dequant_matmul_t"] = MM.t_launches_fma
    if MM.t_launches_tc or MM.t_launches != MM.t_launches_fma or (
            MM.t_launches and (packed or not cfg.tie_embeddings)):
        raise AssertionError(f"{arch} {dtype}: K1t launched {MM.t_launches} "
                             f"times ({MM.t_launches_tc} on tensor cores)")
    plain = serving_plain(MM, paged, K)
    what = "packed serving" if packed else "float32 serving"
    if any(n == 0 for n in launches.values()):
        raise AssertionError(f"{what}: a kernel of the path never "
                             f"launched: {launches}")
    # one K1 route only: tensor cores for bf16 on packed lanes, CUDA cores
    # for float32
    other = MM.launches_fma if packed else MM.launches_tc
    if plain or other or (packed and MM.launches_tc != MM.launches_tc_packed):
        raise AssertionError(f"{what}: {plain} plain calls on the card, "
                             f"{MM.launches_fma} CUDA-core and "
                             f"{MM.launches_tc} tensor-core K1 calls "
                             f"({MM.launches_tc_packed} on packed lanes)")
    for h in handles:
        if len(results[h].tokens) != max_new:
            raise AssertionError(f"{what}: request {h} gave "
                                 f"{len(results[h].tokens)} tokens")
    n_tok = sum(len(results[h].tokens) for h in handles)
    gather = make_dequant_gather()
    tm, cache, tok, pos = decode_timings(torch, dev, model, qparams, gather,
                                         [r.prompt for r in reqs], 128)
    tm["decode_graph"] = dg = decode_graph_vs_eager(
        torch, dev, model, qparams, [r.prompt[:32] for r in reqs])
    tm["k1_step_device_ms"] = sum(
        t for name, t in tm["decode_step_kernels"]
        if "k1_fma_kernel" in name or "k1_fold_kernel" in name
        or "k1_tc_kernel" in name)
    extra = ""
    if not packed:
        # the decode step's logits at the cut's full depth, kernels vs
        # plain versions, each on its own copy of the state
        la, _ = model.decode_step(qparams, {"token": tok},
                                  {k: v.clone() for k, v in cache.items()},
                                  pos, gather)
        lb, _ = model.decode_step(qparams, {"token": tok},
                                  {k: v.clone() for k, v in cache.items()},
                                  pos, gather, backend="torch")
        rel = float((la - lb).norm() / lb.norm())
        if not bool(torch.isfinite(la).all()) or rel > F32_LIMIT:
            raise AssertionError(f"{what} ({arch}): decode logits kernels vs "
                                 f"plain rel L2 {rel} > {F32_LIMIT}")
        tm["logits_rel_l2_f32"] = rel
        was = F32_SERVE_BEFORE[arch]
        extra = (f"; logits rel L2 kernels vs plain {rel:.4e} (limit "
                 f"{F32_LIMIT}); K1 in the step {tm['k1_step_device_ms']:.4f} "
                 f"ms; before the CUDA-core redesign: step device "
                 f"{was[0]:.3f} ms, chunk device {was[1]:.3f} ms")
    print(f"{what} ({arch} x {PACKED_LAYERS} layers, "
          f"{'4-bit lanes' if packed else 'int8 codes'}): {n_tok} tokens in "
          f"{t_serve:.3f} s; resident {params_nbytes(qparams)} B; launches "
          f"{launches}; decode step {tm['decode_step_ms']:.3f} ms (device "
          f"{tm['decode_step_device_ms']:.3f} ms, "
          f"{tm['decode_step_device_ops']:.0f} device operations), chunk "
          f"{tm['chunk_ms']:.3f} ms (device {tm['chunk_device_ms']:.3f} ms, "
          f"{tm['chunk_device_ops']:.0f} operations){extra}; session decode "
          f"step eager {dg['eager_ms']:.3f} ms wall, {dg['eager_device_ms']:.3f}"
          f" ms device (idle {dg['eager_idle']:.1%}), CUDA graph "
          f"{dg['graph_ms']:.3f} ms wall, {dg['graph_device_ms']:.3f} ms "
          f"device (idle {dg['graph_idle']:.1%}), one step bitwise",
          flush=True)
    return dict(tm, launches=launches, tokens=n_tok, serve_s=t_serve,
                resident_bytes=params_nbytes(qparams), layers=PACKED_LAYERS,
                dtype=dtype)


# phase 4i: the admission modes, gemma2-2b's widths cut to 4 layers
ADMISSION_LAYERS = 4


def serve_admission(torch, dev, mods):
    """Phase 4i: gemma2-2b's widths cut to ADMISSION_LAYERS layers (k_x =
    6), 6 requests (64-token prompts and a 1-token one, 16 new tokens)
    on 4 slots admitted chunked (the reference's default), whole (one
    ``Model.prefill`` a request, fixed lanes) and injected (the prompt
    through the graphed decode step; fixed lanes and paged): every mode
    gives the chunked session's tokens. The counts are at 0 before the
    whole and injected runs: K1 and K1t on tensor cores, K3, K4 (and K2
    for the paged run) launched, no plain version on the card."""
    MM, paged, K = mods["MM"], mods["paged"], mods["K"]
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.serve.quantized import quantize_params
    from repro_torch.serve.session import Request, ServeSession
    import numpy as np
    cfg = dataclasses.replace(get_config("gemma2-2b"),
                              n_layers=ADMISSION_LAYERS)
    model = Model(cfg)
    rng = np.random.default_rng(2)
    reqs = [Request(prompt=[int(t) for t in rng.integers(
        1, cfg.vocab_size, size=64 if i < 5 else 1)], max_new_tokens=16)
        for i in range(6)]
    torch.cuda.synchronize()
    zero_serving_counts(MM, paged, K)
    qparams = quantize_params(model.init(seed=0, device=dev), k_x=6,
                              pack=True)
    runs = {}
    for name, kw in (("chunked", dict(prefill="chunked")),
                     ("whole", dict(prefill="whole")),
                     ("inject", dict(prefill="inject")),
                     ("inject_paged", dict(prefill="inject", paged=True,
                                           page_size=16))):
        sess = ServeSession(model, qparams, slots=4, max_seq=128, seed=0,
                            prefill_chunk=32, device=dev, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hs = [sess.submit(r) for r in reqs]
        res = sess.drain()
        torch.cuda.synchronize()
        runs[name] = dict(tokens=[res[h].tokens for h in hs],
                          serve_s=time.perf_counter() - t0,
                          stats=dict(sess.stats))
        del sess
    want = runs["chunked"]["tokens"]
    bad = [k for k, r in runs.items() if r["tokens"] != want]
    if bad or any(len(t) != 16 for t in want):
        raise AssertionError(f"admission modes {bad} give other tokens than "
                             f"chunked admission")
    for k in ("whole", "inject", "inject_paged"):
        st = runs[k]["stats"]
        if st["chunk_dispatches"] or not (st["captures"] and st["replays"]):
            raise AssertionError(f"{k} admission: {st}")
    launches = {"dequant_matmul_tc": MM.launches_tc,
                "dequant_matmul_t_tc": MM.t_launches_tc,
                "gather_pages": paged.launches,
                "gather_pages_kv": paged.launches_kv,
                "amax_rows": K.amax_launches,
                "uniform_quantize_rows": K.quantize_launches}
    plain = serving_plain(MM, paged, K)
    if any(n == 0 for n in launches.values()) or plain or MM.launches_fma:
        raise AssertionError(f"admission runs: launches {launches}, "
                             f"{MM.launches_fma} CUDA-core K1, {plain} "
                             f"plain-version calls on the card")
    print(f"phase 4i (gemma2-2b x {ADMISSION_LAYERS} layers, 6 requests on "
          f"4 slots): whole and injected admission (fixed lanes and paged) "
          f"give the chunked session's tokens; " + "; ".join(
              f"{k} {r['serve_s']:.3f} s, {r['stats']['dispatches']} decode "
              f"dispatches, {r['stats']['chunk_dispatches']} chunks, "
              f"{r['stats']['captures']} captures, {r['stats']['replays']} "
              f"replays" for k, r in runs.items())
          + f"; launches {launches}", flush=True)
    return dict(runs=runs, launches=launches, layers=ADMISSION_LAYERS)


# ---------------------------------------------------------------------------
# phases 4j and 4k: the MoE family served; phase 6f: trained
# ---------------------------------------------------------------------------

# 4k: llama4-maverick at its widths, cut to 2 layers of 16 routed experts
# (its 128 experts are 64.4 GB of float32 a layer); the float32 gates of
# both phases at MOE_F32_LAYERS layers at most
MAVERICK_LAYERS, MAVERICK_EXPERTS, MOE_F32_LAYERS = 2, 16, 4


@contextlib.contextmanager
def route_tap():
    """Every ``layers.moe_route`` call's expert sets (T, k), each token's
    ascending (the order within a set does not change the layer's
    terms), in call order (one a layer of a decode step), appended to
    the yielded list."""
    from repro_torch.models import layers as L
    calls, route = [], L.moe_route

    def tapped(params, xt, mcfg, backend=None):
        out = route(params, xt, mcfg, backend)
        calls.append(out[2].sort(dim=1).values)
        return out
    L.moe_route = tapped
    try:
        yield calls
    finally:
        L.moe_route = route


def routed_gate(torch, a, b, ra, rb):
    """Kernels-vs-plain logits (B, V) gated on the tokens whose expert
    sets agree at every layer (a bf16 ulp in a router logit can flip a
    route, and a flipped route is another function, not noise): (rel L2
    over those tokens or inf where none agree, the share of tokens that
    agree, the share of (token, layer) sets that agree)."""
    same = torch.stack([(x == y).all(dim=1) for x, y in zip(ra, rb)])
    tok = same.all(dim=0)
    share, pairs = float(tok.float().mean()), float(same.float().mean())
    if not bool(tok.any()):
        return float("inf"), share, pairs
    a, b = a[tok].float(), b[tok].float()
    return float((a - b).norm() / b.norm()), share, pairs


def _moe_counts(qparams, cfg):
    """What one eager decode step launches: K12 once a layer for every
    code-resident leaf the layer dequantizes at use (the three expert
    stacks among them) and once for the embedding rows; K1 once a layer
    for every code-resident projection (attention, router, shared
    experts) and once for the head."""
    from repro_torch.serve.quantized import (_fused_ok, is_qleaf,
                                             layer_slice,
                                             tree_map_with_path)
    kinds = {"fused": [], "at_use": []}

    def one(path, leaf):
        if is_qleaf(leaf):
            fused = _fused_ok(path, leaf, "blocks")
            kinds["fused" if fused else "at_use"].append("/".join(path))
        return leaf
    tree_map_with_path(one, layer_slice(qparams["blocks"], 0))
    L = cfg.n_layers
    k12 = L * len(kinds["at_use"]) + is_qleaf(qparams["embed"])
    k1 = L * len(kinds["fused"]) + is_qleaf(qparams["unembed"])
    return k12, k1, kinds


def serve_moe(torch, dev, mods, arch, layers=None, experts=None):
    """Phase 4j (deepseek-moe-16b at full width and depth) and 4k
    (llama4-maverick at its widths, cut to ``layers`` and ``experts``):
    phase 4's protocol (quantize_params(k_x=6) leaf by leaf, paged,
    page 16, 4 slots, chunk 32, 8 requests of 64-token prompts, 16 new
    tokens, bf16), every count at 0 just before it, no plain version on
    the card. Then: one eager decode step launches K12 for every at-use
    dequantize (3 expert stacks a layer) and K1 for every projection
    (the router and shared experts among them), nothing plain; the
    decode step eager and graphed bitwise; kernels-vs-plain logits
    gated on the tokens whose routes agree at every layer, at depth 1
    and 2 in bf16 and at MOE_F32_LAYERS in float32, where one dropped K
    row in the plain products must fail the gate."""
    MM, paged, K = mods["MM"], mods["paged"], mods["K"]
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import quantize_in_place
    from repro_torch.models.model import Model
    from repro_torch.serve.quantized import make_dequant_gather, params_nbytes
    from repro_torch.serve.session import Request, ServeSession
    import numpy as np

    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    if experts:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_experts=experts))
    model = Model(cfg)
    slots, n_req, plen, max_new = 4, 8, 64, 16
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=[int(t) for t in rng.integers(
        1, cfg.vocab_size, size=plen)], max_new_tokens=max_new)
        for _ in range(n_req)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # the main path, with every kernel count at 0 just before it
    zero_serving_counts(MM, paged, K)
    t0 = time.perf_counter()
    params = model.init(seed=0, device=dev)
    fp_bytes = params_nbytes(params)
    qparams = quantize_in_place(params, k_x=6, pack=True)
    del params
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    peak_start = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    q_bytes = params_nbytes(qparams)
    sess = ServeSession(model, qparams, slots=slots, max_seq=128,
                        paged=True, page_size=16, prefill_chunk=32, seed=0,
                        device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    handles = [sess.submit(r) for r in reqs]
    results = sess.drain()
    torch.cuda.synchronize()
    t_serve = time.perf_counter() - t1
    launches = {"dequant_matmul_tc": MM.launches_tc,
                "gather_pages": paged.launches,
                "gather_pages_kv": paged.launches_kv,
                "amax_rows": K.amax_launches,
                "uniform_quantize_rows": K.quantize_launches,
                "uniform_dequantize_rows": K.dequantize_launches}
    plain = serving_plain(MM, paged, K)
    if any(n == 0 for n in launches.values()) or plain or \
            MM.launches_fma or MM.launches_tc_packed or MM.t_launches:
        raise AssertionError(f"{arch}: launches {launches}, {plain} plain "
                             f"calls on the card, K1 CUDA-core "
                             f"{MM.launches_fma}, packed "
                             f"{MM.launches_tc_packed}, K1t {MM.t_launches}")
    if not (sess.stats["captures"] and sess.stats["replays"]):
        raise AssertionError(f"{arch}: the decode step was not graphed: "
                             f"{sess.stats}")
    for h in handles:
        r = results[h]
        if len(r.tokens) != max_new or r.finish_reason != "length":
            raise AssertionError(f"request {h}: {len(r.tokens)} tokens, "
                                 f"{r.finish_reason}")
    n_tok = sum(len(results[h].tokens) for h in handles)
    stats = dict(sess.stats)
    del sess
    gather = make_dequant_gather()
    plain_gather = make_dequant_gather(backend="torch")
    tm, cache, tok, pos = decode_timings(
        torch, dev, model, qparams, gather,
        [reqs[i].prompt for i in range(slots)], 128)

    # one eager decode step: what it launches
    want_k12, want_k1, kinds = _moe_counts(qparams, cfg)
    zero_serving_counts(MM, paged, K)
    model.decode_step(qparams, {"token": tok},
                      {k: v.clone() for k, v in cache.items()}, pos, gather)
    torch.cuda.synchronize()
    step_k12, step_k1 = K.dequantize_launches, MM.launches_tc
    if (step_k12, step_k1) != (want_k12, want_k1) or \
            serving_plain(MM, paged, K) or \
            "moe/router" not in kinds["fused"] or not all(
                f"moe/{n}" in kinds["at_use"]
                for n in ("w_gate", "w_up", "w_down")):
        raise AssertionError(f"{arch} eager decode step: K12 {step_k12} "
                             f"(want {want_k12}), K1 {step_k1} (want "
                             f"{want_k1}), plain "
                             f"{serving_plain(MM, paged, K)}; {kinds}")
    dg = decode_graph_vs_eager(torch, dev, model, qparams,
                               [reqs[i].prompt[:32] for i in range(slots)])

    # kernels against plain versions, gated where the routes agree
    def both(mdl, qp, cache_of):
        with route_tap() as ra:
            la, _ = mdl.decode_step(qp, {"token": tok}, cache_of(), pos,
                                    gather)
        with route_tap() as rb:
            lb, _ = mdl.decode_step(qp, {"token": tok}, cache_of(), pos,
                                    plain_gather, backend="torch")
        return la, lb, ra, rb

    def cut(n, dtype=None):
        c = dataclasses.replace(cfg, n_layers=n)
        if dtype:
            c = dataclasses.replace(c, dtype=dtype)
        qp = dict(qparams, blocks=first_layers(qparams["blocks"], n))

        def cache_of():
            return {k: (v if k == "ptab" else v[:n].to(
                torch.float32 if dtype else v.dtype)).clone()
                for k, v in cache.items()}
        return Model(c), qp, cache_of

    la, lb, ra, rb = both(model, qparams,
                          lambda: {k: v.clone() for k, v in cache.items()})
    if not bool(torch.isfinite(la).all()) or la.shape != (slots,
                                                          cfg.vocab_size):
        raise AssertionError("decode logits not finite or misshapen")
    full = routed_gate(torch, la, lb, ra, rb)
    gates = {}
    for n, dt, limit in ((1, None, SHALLOW_LIMIT), (2, None, SHALLOW_LIMIT),
                         (min(MOE_F32_LAYERS, cfg.n_layers), "float32",
                          F32_LIMIT)):
        mdl, qp, cache_of = cut(n, dt)
        a, b, ra, rb = both(mdl, qp, cache_of)
        rel, share, pairs = routed_gate(torch, a, b, ra, rb)
        key = f"{dt or 'bf16'}@{n}"
        gates[key] = dict(rel_l2=rel, tokens_agree=share,
                          sets_agree=pairs, limit=limit)
        if not rel <= limit:
            raise AssertionError(f"{arch} decode logits {key}: kernels vs "
                                 f"plain rel L2 {rel} over the {share:.0%} "
                                 f"of tokens whose routes agree > {limit}")
    # the planted fault: one K row dropped from every plain projection, in
    # the float32 gate's setting; it must fail that gate
    plain32 = MM._matmul_torch

    def dropped_row(x2, codes, scale, transpose=False, **kw):
        w = MM.dequant_codes(codes, scale, **kw).float()
        w = w.T if transpose else w
        return (x2[:, :-1].float() @ w[:-1]).to(
            MM._out_dtype(x2.dtype, kw["w_dtype"], kw["cast_dtype"]))
    mdl, qp, cache_of = cut(min(MOE_F32_LAYERS, cfg.n_layers), "float32")
    try:
        MM._matmul_torch = dropped_row
        a, b, ra, rb = both(mdl, qp, cache_of)
    finally:
        MM._matmul_torch = plain32
    fault = routed_gate(torch, a, b, ra, rb)
    if fault[0] <= F32_LIMIT:
        raise AssertionError(f"{arch}: a dropped K row passes the float32 "
                             f"gate: {fault}")
    print(f"{cfg.name} ({cfg.n_layers} layers, {cfg.moe.n_experts} experts "
          f"top-{cfg.moe.top_k}): eager decode step launches K12 "
          f"{step_k12} = {cfg.n_layers} x {len(kinds['at_use'])} at-use "
          f"leaves ({', '.join(kinds['at_use'])}) + the embedding rows, K1 "
          f"{step_k1} ({', '.join(kinds['fused'])} a layer + the head); "
          f"logits kernels vs plain where the routes agree: "
          + "; ".join(f"{k} rel L2 {g['rel_l2']:.4e} (limit {g['limit']}) "
                      f"over {g['tokens_agree']:.0%} of tokens, "
                      f"{g['sets_agree']:.1%} of (token, layer) sets agree"
                      for k, g in gates.items())
          + f"; full depth bf16 {full[0]:.4e} over {full[1]:.0%} of "
          f"tokens ({full[2]:.1%} of sets agree); float32 with one K row "
          f"dropped {fault[0]:.4e} over {fault[1]:.0%} (caught)",
          flush=True)
    print(f"{cfg.name} session decode step, 4 slots at position "
          f"{dg['position']}: eager {dg['eager_ms']:.3f} ms wall, "
          f"{dg['eager_device_ms']:.3f} ms device (idle "
          f"{dg['eager_idle']:.1%}); CUDA graph {dg['graph_ms']:.3f} ms "
          f"wall, {dg['graph_device_ms']:.3f} ms device (idle "
          f"{dg['graph_idle']:.1%}); bitwise eager vs graphed; by kernel "
          f"(eager): " + ", ".join(f"{n[:60]} {t:.3f}"
                                   for n, t in dg["eager_kernels"][:5]),
          flush=True)
    out = dict(tm, arch=cfg.name, layers=cfg.n_layers,
               experts=cfg.moe.n_experts, launches=launches, tokens=n_tok,
               serve_s=t_serve, tok_per_s=n_tok / t_serve,
               startup_s=t_quant, resident_bytes=q_bytes, fp32_bytes=fp_bytes,
               peak_startup_bytes=peak_start,
               peak_bytes=torch.cuda.max_memory_allocated(), stats=stats,
               decode_graph=dg, step_k12=step_k12, step_k1=step_k1,
               at_use=kinds["at_use"], fused=kinds["fused"], gates=gates,
               full_depth_bf16=full, fault_f32=fault)
    del qparams, cache, dg
    torch.cuda.empty_cache()
    return out


MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS = 2, 4


def moe_train(torch, dev, mods, group):
    """Phase 6f: deepseek-moe-16b at full width cut to MOE_TRAIN_LAYERS
    layers (about 1.6 B parameters), Algorithms 2+3 ``qadam`` on the one
    NCCL rank, 2 x 1024 tokens a step (capacity 240), MOE_TRAIN_STEPS
    steps through ``dist_run`` (its gates: kernels launched, no plain
    version, no steady host sync, collective bytes, the captured-gradient
    update bitwise kernels vs plain); then one forward/backward each with
    ``dispatch="einsum"`` and ``"sort"`` from the same weights: losses
    within the reference's sort-vs-einsum tolerance (rtol 1e-5) in
    float32, both times in bf16; the aux loss's share of the loss; one
    ``--model 1`` step through the launcher, where no token exchange
    runs (one shard)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import batch_for_model
    from repro_torch.dist import collectives as CL
    from repro_torch.dist.step import TrainConfig, make_train_step
    from repro_torch.models.model import Model
    from repro_torch.train.session import stage_batch
    base = dataclasses.replace(get_config("deepseek-moe-16b"),
                               n_layers=MOE_TRAIN_LAYERS)
    tc = TrainConfig(**DIST_TC)
    res = dist_run(torch, dev, mods, group, Model(base), base, tc,
                   DIST_COUNTERS, MOE_TRAIN_STEPS, "6f")
    batch = stage_batch(next(batch_for_model(base, TRAIN_SEQ, TRAIN_BATCH,
                                             seed=1)), dev)

    # the aux loss's share of the loss at the initial weights
    model = Model(base)
    params = model.init(seed=0, device=dev)
    with torch.no_grad():
        _, aux = model.forward_with_aux(params, batch)
        s, n = model.loss(params, batch)
    res.update(aux=float(aux), loss_sum=float(s), tokens=float(n),
               aux_share=float(aux) / float(s))
    del params

    # the two dispatches from the same weights: float32 losses, bf16 times
    disp = {}
    for dtype in ("float32", "bfloat16"):
        for name in ("einsum", "sort"):
            cfg = dataclasses.replace(base, dtype=dtype, moe=dataclasses.replace(
                base.moe, dispatch=name))
            art = make_train_step(Model(cfg), group, tc)
            state = art.init_state(0, dev)
            xs = art.broadcast(state)
            del state
            times = []
            for _ in range(2):      # the first call's one-time costs apart
                torch.cuda.synchronize()
                t = time.perf_counter()
                loss, grads = art.loss_and_grads(xs, batch)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
                del grads
            disp[f"{name}_{dtype}"] = dict(loss=float(loss),
                                           fwd_bwd_ms=times[-1])
            del xs, art
            torch.cuda.empty_cache()
    for dtype in ("float32", "bfloat16"):
        e, o = disp[f"einsum_{dtype}"]["loss"], disp[f"sort_{dtype}"]["loss"]
        disp[f"rel_{dtype}"] = abs(o - e) / abs(e)
    if not disp["rel_float32"] <= 1e-5:
        raise AssertionError(f"6f: sort vs einsum losses in float32: {disp}")
    res["dispatch"] = disp

    # one --model 1 step: one shard, so no token exchange
    calls = []
    exchange = CL._exchange_experts

    def counted(*a, **kw):
        calls.append(1)
        return exchange(*a, **kw)
    CL._exchange_experts = counted
    try:
        m1, launches, plain, log = _launch(
            torch, mods, DIST_COUNTERS, "--steps", "1", "--model", "1",
            arch="deepseek-moe-16b", layers=MOE_TRAIN_LAYERS)
    finally:
        CL._exchange_experts = exchange
    ml = [h["loss"] for h in m1["history"]]
    if plain or calls or len(ml) != 1 or not math.isfinite(ml[0]):
        raise AssertionError(f"6f --model 1: losses {ml}, plain {plain}, "
                             f"token exchanges {len(calls)}")
    res.update(model1_loss=ml[0], model1_exchanges=len(calls),
               model1_grid=log.splitlines()[0])
    del m1
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# the SSM and hybrid family: phase 3's new shapes, phases 4l, 4m and 6g
# ---------------------------------------------------------------------------

# K1's new shapes (K, N): mamba2-2.7b's in_proj (2 d_inner + 2 d_state +
# heads wide) and out_proj, hymba-1.5b's in_proj (6,482 wide: no whole 3-
# or 6-bit packing group) and out_proj; the tied heads (V, d) of K1t
SSM_K1_SHAPES = [(2560, 10576), (5120, 2560), (1600, 6482), (3200, 1600)]
SSM_HEADS = [(50280, 2560), (32001, 1600)]
SSM_K1_KINDS = ("int8", "p3", "p4", "p6")


def timed_row(torch, row, kernel, plain, library, variants=4):
    """``row`` with the device ms of ``kernel(i)``, ``plain(i)`` and
    ``library(i)`` in CUDA graphs over ``variants`` inputs, and the
    kernel/library factor."""
    row.update(ms=graph_ms(torch, kernel, variants),
               plain_ms=graph_ms(torch, plain, variants, 5),
               library_ms=graph_ms(torch, library, variants))
    row["factor"] = row["ms"] / row["library_ms"]
    return row


def k1_rows(torch, dev, MM, B, K, g, shapes, kinds, Ms):
    """K1 on tensor cores for bf16 activations at every (K, N) of
    ``shapes``, code kind of ``kinds`` (int8, or packed lanes
    round-tripped through #9 bitwise first: pack then unpack gives the
    codes back) and M of ``Ms``, within one bf16 ulp plus the floor; each
    timed over 4 sets of codes beside its plain version, ``torch.matmul``
    of the dequantized bf16 weights and its bound."""
    scale = torch.tensor(0.0371, device=dev)
    table = []
    for Kd, N in shapes:
        for kind in kinds:
            k_x, bits = CODE_KINDS[kind]
            lim = 2 ** k_x
            raw = [torch.randint(-lim, lim + 1, (Kd, N), generator=g,
                                 device=dev, dtype=torch.int32)
                   for _ in range(4)]
            if kind == "int8":
                cs, pb = [r.to(torch.int8) for r in raw], 0
            else:
                cs, pb = [B.pack_rows(r, bits) for r in raw], bits
                mine = K.pack_rows(raw[0].to(torch.int8), bits,
                                   backend="cuda")
                back = K.unpack_rows(mine, bits, N, backend="cuda")
                if not torch.equal(mine, cs[0]) or not torch.equal(
                        back.to(torch.int32), raw[0]):
                    raise AssertionError(f"#9 lanes at {(Kd, N)} {kind}: "
                                         f"not bitwise the plain packing, or "
                                         f"the round trip changed codes")
            del raw
            kw = dict(k_x=k_x, n=N, pack_bits=pb, cast_dtype="bfloat16")
            ws = [MM.dequant_codes(c, scale, k_x=k_x, n=N, pack_bits=pb,
                                   w_dtype="float32", cast_dtype="bfloat16")
                  for c in cs]
            for M in Ms:
                x = torch.randn(M, Kd, generator=g, device=dev).to(
                    torch.bfloat16)
                n0 = (MM.launches_tc, MM.launches_tc_packed)
                a = MM.dequant_matmul(x, cs[0], scale, backend="cuda", **kw)
                if (MM.launches_tc - n0[0], MM.launches_tc_packed - n0[1]) \
                        != (1, int(pb > 0)):
                    raise AssertionError(f"K1 at {(M, Kd, N)} {kind}: not "
                                         f"one tensor-core launch")
                b = MM.dequant_matmul(x, cs[0], scale, backend="torch", **kw)
                tol = k1_tolerance(torch, b, k1_noise_unit(
                    torch, MM, x, cs[0], scale, kw))
                diff = (a.float() - b.float()).abs()
                if a.shape != (M, N) or not bool((diff <= tol).all()):
                    raise AssertionError(f"K1 at {(M, Kd, N)} {kind}: beyond "
                                         f"one bf16 ulp plus the floor (max "
                                         f"abs {float(diff.max())})")
                code_bytes = cs[0].numel() * cs[0].element_size()
                bnd, by = bound_ms(code_bytes + 2 * M * Kd + 2 * M * N,
                                   2 * M * Kd * N)
                table.append(timed_row(torch, dict(
                    name=("dequant_matmul_tc_packed" if pb else
                          "dequant_matmul_tc"), what="K1", shape=[M, Kd, N],
                    codes=kind, max_abs_err=float(diff.max()), bound_ms=bnd,
                    bound_by=by),
                    lambda i: MM.dequant_matmul(x, cs[i], scale,
                                                backend="cuda", **kw),
                    lambda i: MM.dequant_matmul(x, cs[i], scale,
                                                backend="torch", **kw),
                    lambda i: torch.matmul(x, ws[i])))
                del a, b, x, diff, tol
            del cs, ws
    return table


def k1t_rows(torch, dev, MM, g, V, d, Ms):
    """K1t over a tied head of int8 codes (V, d) at every M of ``Ms``, on
    tensor cores, within one bf16 ulp plus the floor; each timed over 4
    sets of codes beside its plain version, ``torch.matmul`` of the
    dequantized bf16 table's transpose and its bound."""
    scale = torch.tensor(0.0371, device=dev)
    cs = [torch.randint(-64, 65, (V, d), generator=g, device=dev).to(
        torch.int8) for _ in range(4)]
    kw = dict(k_x=6, n=d, pack_bits=0, cast_dtype="bfloat16", transpose=True)
    ws = [MM.dequant_codes(c, scale, k_x=6, n=d, pack_bits=0,
                           w_dtype="float32", cast_dtype="bfloat16")
          for c in cs]
    table = []
    for M in Ms:
        x = torch.randn(M, d, generator=g, device=dev).to(torch.bfloat16)
        n0 = MM.t_launches_tc
        a = MM.dequant_matmul(x, cs[0], scale, backend="cuda", **kw)
        if MM.t_launches_tc != n0 + 1:
            raise AssertionError(f"K1t at the ({V}, {d}) head, M = {M}: not "
                                 f"one tensor-core launch")
        b = MM.dequant_matmul(x, cs[0], scale, backend="torch", **kw)
        w = ws[0].float()
        unit = d ** 0.5 * 2.0 ** -24 * (x.float() ** 2 @ (w ** 2).T).sqrt()
        diff = (a.float() - b.float()).abs()
        if a.shape != (M, V) or not bool(
                (diff <= k1_tolerance(torch, b, unit)).all()):
            raise AssertionError(f"K1t at the ({V}, {d}) head, M = {M}: "
                                 f"beyond one bf16 ulp plus the floor")
        bnd, by = bound_ms(V * d + 2 * M * d + 2 * M * V, 2 * M * V * d)
        table.append(timed_row(torch, dict(
            name="dequant_matmul_t_tc", what="K1t head", shape=[M, V, d],
            codes="int8", max_abs_err=float(diff.max()), bound_ms=bnd,
            bound_by=by),
            lambda i: MM.dequant_matmul(x, cs[i], scale, backend="cuda",
                                        **kw),
            lambda i: MM.dequant_matmul(x, cs[i], scale, backend="torch",
                                        **kw),
            lambda i: torch.matmul(x, ws[i].T)))
        del a, b, w, unit, diff, x
    del cs, ws
    return table


def check_ssm_shapes(torch, dev, MM, B, K):
    """K1 at the SSM family's projection shapes, M = 4, on tensor cores
    for bf16 activations against int8 codes and 3-, 4- and 6-bit packed
    lanes (``k1_rows``); K1t over the 50,280- and 32,001-row tied heads
    at M = 4 (int8) in the same tier (``k1t_rows``)."""
    g = torch.Generator(device=dev).manual_seed(31)
    table = k1_rows(torch, dev, MM, B, K, g, SSM_K1_SHAPES, SSM_K1_KINDS,
                    (4,))
    for V, d in SSM_HEADS:
        table += k1t_rows(torch, dev, MM, g, V, d, (4,))
    torch.cuda.empty_cache()
    return table


SSM_CHUNK = 128            # prefill_chunk of phases 4l and 4m
SSM_MAX_SEQ = {"mamba2-2.7b": 512, "hymba-1.5b": 1408}
SSM_F32_LAYERS = 4         # the float32 logits gate's depth
HYMBA_LONG_PROMPT = 1280   # past the local layers' 1024 window


def ssm_decode_timings(torch, dev, model, qparams, gather, prompts,
                       max_seq, paged):
    """Prefill each prompt (SSM_CHUNK tokens) into its slot of a fresh
    cache (paged or fixed lanes; the SSM state and conv tail per slot)
    by one chunk each, keep a copy, then time one SSM_CHUNK-token chunk
    (slot 0) and one decode step (every slot), as ``decode_timings``
    does. Returns (timings, the copy, tok, pos)."""
    slots = len(prompts)
    pool = (slots * max_seq // 16, 16) if paged else None
    cache = model.init_cache(slots, max_seq, page_pool=pool, device=dev)
    if paged:
        npag = max_seq // 16
        cache["ptab"].copy_(torch.arange(slots * npag, dtype=torch.int32,
                                         device=dev).reshape(slots, npag))
    prompt = torch.tensor(prompts, dtype=torch.int32, device=dev)

    def lane(s):
        return {k: (v if k in ("pk", "pv") else v[s:s + 1] if k == "ptab"
                    else v[:, s:s + 1]) for k, v in cache.items()}
    c0 = torch.tensor([0], device=dev)
    cn = torch.tensor([SSM_CHUNK], device=dev)
    for s in range(slots):
        model.decode_chunk(qparams, {"token": prompt[s:s + 1]}, lane(s), c0,
                           cn, gather)
    base = {k: v.clone() for k, v in cache.items()}

    def chunk():
        return model.decode_chunk(qparams, {"token": prompt[1:2]}, lane(0),
                                  cn, cn, gather)
    tok = prompt[:, -1:].contiguous()
    pos = torch.full((slots,), SSM_CHUNK, dtype=torch.int32, device=dev)

    def step():
        return model.decode_step(qparams, {"token": tok}, cache, pos, gather)
    chunk_ms = cuda_ms(torch, lambda i: chunk(), 5, 1)
    chunk_dev_ms, _, chunk_ops = profile_ms(torch, chunk, PROFILED_CALLS,
                                            with_launches=True)
    step_ms = cuda_ms(torch, lambda i: step(), 10, 2)
    step_dev_ms, step_kernels, step_ops = profile_ms(torch, step,
                                                     PROFILED_CALLS,
                                                     with_launches=True)
    del cache
    return (dict(chunk_ms=chunk_ms, chunk_device_ms=chunk_dev_ms,
                 chunk_device_ops=chunk_ops, decode_step_ms=step_ms,
                 decode_step_device_ms=step_dev_ms,
                 decode_step_device_ops=step_ops,
                 decode_step_kernels=step_kernels[:12]),
            base, tok, pos)


def ssd_scan_ms(torch, dev, cfg, B, S, dtype):
    """The SSD scan alone at the shapes a layer gives it, device ms by the
    profiler: ``ssd_chunked`` over B x S tokens forward, and forward with
    its backward (S > 1), or one ``ssd_step`` of B slots (S == 1). Inputs
    random, xdt, B and C in ``dtype``, the log decay float32 negative."""
    from repro_torch.models import layers as L
    s = cfg.ssm
    H, P, G, N = cfg.n_ssm_heads, s.head_dim, s.n_groups, s.d_state
    g = torch.Generator(device=dev).manual_seed(41)

    def rnd(*shape, dt=dtype):
        return torch.randn(shape, generator=g, device=dev).to(dt)
    a = -torch.rand((B, S, H), generator=g, device=dev) * 0.1
    if S == 1:     # a few microseconds: averaged over many calls
        h = rnd(B, H, P, N, dt=torch.float32)
        args = (rnd(B, H, P), a[:, 0], rnd(B, G, N), rnd(B, G, N))
        return {"step": profile_ms(torch, lambda: L.ssd_step(h, *args),
                                   50)[0]}
    xdt, Bm, Cm = rnd(B, S, H, P), rnd(B, S, G, N), rnd(B, S, G, N)
    out = {"forward": profile_ms(torch, lambda: L.ssd_chunked(
        xdt, a, Bm, Cm, chunk=s.chunk))[0]}
    leaves = [t.clone().requires_grad_() for t in (xdt, a, Bm, Cm)]

    def fwd_bwd():
        with torch.enable_grad():
            y, f = L.ssd_chunked(*leaves, chunk=s.chunk)
            torch.autograd.grad((y.float().sum() + f.sum()), leaves)
    out["forward_backward"] = profile_ms(torch, fwd_bwd)[0]
    return out


def ssm_live(torch, dev, model, qparams, gather, prompt, max_seq):
    """hymba-1.5b: prefill ``prompt`` (past the 1024 window) into a fresh
    one-slot paged cache by SSM_CHUNK-token chunks, then one decode step
    with the config, with every window 0, and without the meta prefix
    (``meta_tokens=0``): each must change the logits (the window and the
    prefix bite at their real widths)."""
    from repro_torch.models.model import Model
    cfg = model.cfg
    n = len(prompt)
    cache = model.init_cache(1, max_seq, page_pool=(max_seq // 16, 16),
                             device=dev)
    cache["ptab"].copy_(torch.arange(max_seq // 16, dtype=torch.int32,
                                     device=dev)[None])
    toks = torch.tensor(prompt, dtype=torch.int32, device=dev)[None]
    for c0 in range(0, n, SSM_CHUNK):
        model.decode_chunk(qparams, {"token": toks[:, c0:c0 + SSM_CHUNK]},
                           cache, torch.tensor([c0], device=dev),
                           torch.tensor([SSM_CHUNK], device=dev), gather)
    tok = toks[:, -1:].contiguous()
    pos = torch.full((1,), n, dtype=torch.int32, device=dev)
    out = {}
    la, _ = model.decode_step(qparams, {"token": tok},
                              {k: v.clone() for k, v in cache.items()}, pos,
                              gather)
    for name, change in (("window", dict(window=None)),
                         ("meta", dict(meta_tokens=0))):
        other = Model(dataclasses.replace(cfg, **change))
        lo, _ = other.decode_step(qparams, {"token": tok},
                                  {k: v.clone() for k, v in cache.items()},
                                  pos, gather)
        if torch.equal(la, lo):
            raise AssertionError(f"{cfg.name} at position {n}: the logits "
                                 f"do not change without the {name}")
        out[f"logits_rel_l2_without_{name}"] = float(
            (la - lo).norm() / lo.norm())
    del cache
    return out


def serve_ssm(torch, dev, mods, arch):
    """Phase 4l (mamba2-2.7b) and 4m (hymba-1.5b), full width and depth,
    bf16, ``quantize_params(k_x=6)`` leaf by leaf, 4 slots, prefill_chunk
    SSM_CHUNK, 16 new tokens a request, every count at 0 just before the
    main path. mamba2: fixed lanes; six 256-token prompts (chunked) and a
    100-token one (injected) in one session, and a 128-token prompt in a
    ``prefill="whole"`` session. hymba: paged (page 16); a 1280-token
    prompt (chunked, past the window), six of 256 and one of 100
    (injected). Gates: every kernel of the path launched (K1, K1t for the
    tied head, K12 for the at-use leaves and the embedding rows, K3 and
    K4 at quantize time, K2 for hymba's pages), no plain version on the
    card, the admission modes the SSD chunk rule picks, the decode step
    graphed, bitwise eager; kernels-vs-plain logits at depth 1 and 2 in
    bf16 and at SSM_F32_LAYERS in float32, where one K row dropped from
    the plain in_proj must fail the gate; hymba's window and meta prefix
    live at the long prompt. Readings: the decode step eager and graphed,
    the chunk, tok/s, resident codes, the SSM state a slot, the start-up
    peak, the SSD recurrence's device ms a step."""
    MM, paged, K = mods["MM"], mods["paged"], mods["K"]
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import quantize_in_place
    from repro_torch.models.model import Model
    from repro_torch.serve.quantized import make_dequant_gather, params_nbytes
    from repro_torch.serve.session import Request, ServeSession
    import numpy as np

    cfg = get_config(arch)
    model = Model(cfg)
    is_paged = cfg.arch_type == "hybrid"
    slots, max_new, max_seq = 4, 16, SSM_MAX_SEQ[arch]
    secs, t_mark = {}, [time.perf_counter()]

    def mark(name):
        """Seconds since the last mark, by part of the phase."""
        torch.cuda.synchronize()
        now = time.perf_counter()
        secs[name] = now - t_mark[0]
        t_mark[0] = now
    rng = np.random.default_rng(0)

    def req(n):
        return Request(prompt=[int(t) for t in rng.integers(
            1, cfg.vocab_size, size=n)], max_new_tokens=max_new)
    reqs = ([req(HYMBA_LONG_PROMPT)] if is_paged else []) + \
        [req(256) for _ in range(6)] + [req(100)]
    whole = [] if is_paged else [req(128)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # the main path, with every kernel count at 0 just before it
    zero_serving_counts(MM, paged, K)
    t0 = time.perf_counter()
    params = model.init(seed=0, device=dev)
    fp_bytes = params_nbytes(params)
    qparams = quantize_in_place(params, k_x=6, pack=True)
    del params
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    peak_start = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    q_bytes = params_nbytes(qparams)
    sess = ServeSession(model, qparams, slots=slots, max_seq=max_seq,
                        paged=is_paged, page_size=16,
                        prefill_chunk=SSM_CHUNK, seed=0, device=dev)
    modes = [sess._admission_mode(len(r.prompt)) for r in reqs]
    ssm_slot_bytes = sess._state["cache"]["ssm"][:, 0].nbytes
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    handles = [sess.submit(r) for r in reqs]
    results = sess.drain()
    stats = dict(sess.stats)
    del sess
    if whole:
        ws = ServeSession(model, qparams, slots=1, max_seq=max_seq,
                          prefill="whole", seed=0, device=dev)
        modes += [ws._admission_mode(len(r.prompt)) for r in whole]
        hw = [ws.submit(r) for r in whole]
        done = ws.drain()
        results.update({len(handles) + i: done[h] for i, h in enumerate(hw)})
        stats["whole"] = dict(ws.stats)
        del ws
    torch.cuda.synchronize()
    t_serve = time.perf_counter() - t1
    mark("quantize_and_serve")
    launches = {"dequant_matmul_tc": MM.launches_tc,
                "dequant_matmul_t_tc": MM.t_launches_tc,
                "amax_rows": K.amax_launches,
                "uniform_quantize_rows": K.quantize_launches,
                "uniform_dequantize_rows": K.dequantize_launches}
    if is_paged:
        launches["gather_pages_kv"] = paged.launches_kv
    plain = serving_plain(MM, paged, K)
    want_modes = ({"chunked", "inject"} if is_paged
                  else {"chunked", "inject", "whole"})
    if any(n == 0 for n in launches.values()) or plain or \
            MM.launches_fma or MM.launches_tc_packed or MM.t_launches_fma \
            or paged.launches != paged.launches_kv:
        raise AssertionError(f"{arch}: launches {launches}, {plain} plain "
                             f"calls on the card, K1 CUDA-core "
                             f"{MM.launches_fma}, packed "
                             f"{MM.launches_tc_packed}, K1t CUDA-core "
                             f"{MM.t_launches_fma}, K2 one pool "
                             f"{paged.launches - paged.launches_kv}")
    if set(modes) != want_modes:
        raise AssertionError(f"{arch}: admission modes {modes}")
    if not (stats["captures"] and stats["replays"]):
        raise AssertionError(f"{arch}: the decode step was not graphed: "
                             f"{stats}")
    for h, r in results.items():
        if len(r.tokens) != max_new or r.finish_reason != "length":
            raise AssertionError(f"request {h}: {len(r.tokens)} tokens, "
                                 f"{r.finish_reason}")
    n_tok = sum(len(r.tokens) for r in results.values())
    gather = make_dequant_gather()
    plain_gather = make_dequant_gather(backend="torch")
    out = {}
    if is_paged:
        out.update(ssm_live(torch, dev, model, qparams, gather,
                            reqs[0].prompt, max_seq))
        mark("window_and_meta")

    short = [r.prompt[:SSM_CHUNK] for r in reqs[-1 - slots:-1]]
    tm, base, tok, pos = ssm_decode_timings(torch, dev, model, qparams,
                                            gather, short, 256, is_paged)
    mark("timings")
    dg = decode_graph_vs_eager(torch, dev, model, qparams, short,
                               paged=is_paged, max_seq=256, chunk=SSM_CHUNK)
    mark("graph_vs_eager")
    scan = ssd_scan_ms(torch, dev, cfg, slots, 1, torch.bfloat16)

    def both(mdl, qp, cache_of):
        la, _ = mdl.decode_step(qp, {"token": tok}, cache_of(), pos, gather)
        lb, _ = mdl.decode_step(qp, {"token": tok}, cache_of(), pos,
                                plain_gather, backend="torch")
        return la, lb

    def rel_l2(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    def cut(n, dtype=None):
        c = dataclasses.replace(cfg, n_layers=n)
        if dtype:
            c = dataclasses.replace(c, dtype=dtype)
        qp = dict(qparams, blocks=first_layers(qparams["blocks"], n))

        def cache_of():
            return {k: (v if k == "ptab" else v[:n].to(
                torch.float32 if dtype else v.dtype)).clone()
                for k, v in base.items()}
        return Model(c), qp, cache_of

    la, lb = both(model, qparams, lambda: {k: v.clone()
                                           for k, v in base.items()})
    if not bool(torch.isfinite(la).all()) or la.shape != (slots,
                                                          cfg.vocab_size):
        raise AssertionError(f"{arch}: decode logits not finite or "
                             f"misshapen")
    gates = {"bf16@full": rel_l2(la, lb)}
    for n, dt, limit in ((1, None, SHALLOW_LIMIT), (2, None, SHALLOW_LIMIT),
                         (SSM_F32_LAYERS, "float32", F32_LIMIT)):
        a, b = both(*cut(n, dt))
        key = f"{dt or 'bf16'}@{n}"
        gates[key] = rel_l2(a, b)
        if not gates[key] <= limit:
            raise AssertionError(f"{arch} decode logits {key}: kernels vs "
                                 f"plain rel L2 {gates[key]} > {limit}")
    # the planted fault: one K row dropped from the plain in_proj, in the
    # float32 gate's setting; it must fail that gate
    width = 2 * cfg.d_inner + 2 * cfg.ssm.n_groups * cfg.ssm.d_state \
        + cfg.n_ssm_heads
    plain32 = MM._matmul_torch

    def dropped_row(x2, codes, scale, transpose=False, **kw):
        if transpose or kw["n"] != width:
            return plain32(x2, codes, scale, transpose=transpose, **kw)
        w = MM.dequant_codes(codes, scale, **kw).float()
        return (x2[:, :-1].float() @ w[:-1]).to(
            MM._out_dtype(x2.dtype, kw["w_dtype"], kw["cast_dtype"]))
    mdl, qp, cache_of = cut(SSM_F32_LAYERS, "float32")
    b32 = mdl.decode_step(qp, {"token": tok}, cache_of(), pos, plain_gather,
                          backend="torch")[0]
    try:
        MM._matmul_torch = dropped_row
        lf, _ = mdl.decode_step(qp, {"token": tok}, cache_of(), pos,
                                plain_gather, backend="torch")
    finally:
        MM._matmul_torch = plain32
    fault = rel_l2(lf, b32)
    mark("gates")
    if not fault > F32_LIMIT:
        raise AssertionError(f"{arch}: one K row dropped from in_proj "
                             f"passes the float32 gate ({fault})")
    busy = dg["graph_device_ms"]
    print(f"{cfg.name} ({cfg.n_layers} layers): admission {modes}; served "
          f"{n_tok} tokens in {t_serve:.3f} s ({n_tok / t_serve:.2f} tok/s); "
          f"resident codes {q_bytes} B of {fp_bytes} B float32; SSM state "
          f"{ssm_slot_bytes} B a slot; start-up peak {peak_start} B; "
          f"launches {launches}; logits kernels vs plain: "
          + ", ".join(f"{k} {v:.4e}" for k, v in gates.items())
          + f" (limits {SHALLOW_LIMIT}, {F32_LIMIT}); in_proj's K row "
          f"dropped {fault:.4e} (caught)"
          + "".join(f"; {k} {v:.4e}" for k, v in out.items()), flush=True)
    print(f"{cfg.name} session decode step, 4 slots at position "
          f"{dg['position']}: eager {dg['eager_ms']:.3f} ms wall, "
          f"{dg['eager_device_ms']:.3f} ms device (idle "
          f"{dg['eager_idle']:.1%}, {dg['eager_device_ops']:.0f} "
          f"operations); CUDA graph {dg['graph_ms']:.3f} ms wall, "
          f"{busy:.3f} ms device (idle {dg['graph_idle']:.1%}); bitwise "
          f"eager vs graphed; a {SSM_CHUNK}-token chunk "
          f"{tm['chunk_ms']:.3f} ms ({tm['chunk_device_ms']:.3f} device); "
          f"the SSD recurrence {scan['step']:.4f} ms a layer, "
          f"{scan['step'] * cfg.n_layers:.3f} ms a step "
          f"({scan['step'] * cfg.n_layers / busy:.1%} of the graphed "
          f"step); seconds by part: "
          + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()), flush=True)
    for name, t in tm["decode_step_kernels"][:8]:
        print(f"  {t:9.4f} ms  {name[:90]}")
    res = dict(out, **tm, arch=cfg.name, layers=cfg.n_layers,
               launches=launches, tokens=n_tok, serve_s=t_serve,
               tok_per_s=n_tok / t_serve, startup_s=t_quant,
               resident_bytes=q_bytes, fp32_bytes=fp_bytes,
               ssm_state_bytes_per_slot=ssm_slot_bytes,
               peak_startup_bytes=peak_start,
               peak_bytes=torch.cuda.max_memory_allocated(), stats=stats,
               admission=modes, decode_graph=dg, gates=gates,
               fault_in_proj_f32=fault, ssd_step_ms_per_layer=scan["step"],
               seconds=secs)
    del qparams, base
    torch.cuda.empty_cache()
    return res


# mamba2 at 8 layers (16 until phases 4 and 6i needed the time)
SSM_TRAIN = (("mamba2-2.7b", 8), ("hymba-1.5b", 4))
SSM_TRAIN_STEPS = 4


def ssm_train(torch, dev, mods, group):
    """Phase 6g: mamba2-2.7b cut to 8 layers and hymba-1.5b cut to 4
    (``_pattern(4)``), widths unchanged, Algorithms 2+3 ``qadam`` on the
    one NCCL rank, 2 x 1024 tokens a step, SSM_TRAIN_STEPS steps each
    through ``dist_run`` (6f's gates); the SSD scan's own device ms at
    the forward's shapes (forward, and with its backward) beside the
    step's phases; then ``launch.train`` at mamba2 x 2 layers, 2 steps,
    flat and ``--model 1`` with ``cp_exchange="ladder"``: bitwise equal
    (one shard: no exchange runs). The losses are gated finite, not
    falling: 4 steps from random weights move mamba2's loss by less than
    its step-to-step spread."""
    from repro_torch import configs
    from repro_torch.configs import get_config
    from repro_torch.configs.hymba_1p5b import _pattern
    from repro_torch.dist.step import TrainConfig
    from repro_torch.models.model import Model
    from repro_torch.tree import tree_leaves
    res, secs = {}, {}
    for arch, layers in SSM_TRAIN:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch), n_layers=layers)
        if cfg.pattern is not None:
            cfg = dataclasses.replace(cfg, pattern=_pattern(layers))
        r = dist_run(torch, dev, mods, group, Model(cfg), cfg,
                     TrainConfig(**DIST_TC), DIST_COUNTERS, SSM_TRAIN_STEPS,
                     f"6g {arch}", falling=False)
        scan = ssd_scan_ms(torch, dev, cfg, TRAIN_BATCH, TRAIN_SEQ,
                           torch.bfloat16)
        r["ssd_scan_ms_per_layer"] = scan
        # a step runs the scan's forward twice (the forward, and its
        # recompute under the per-block checkpoint) and its backward once
        r["ssd_scan_ms_step"] = (scan["forward"] + scan["forward_backward"]
                                 ) * layers
        r["ssd_scan_share"] = r["ssd_scan_ms_step"] / r["step_device_ms"]
        res[arch] = r
        torch.cuda.empty_cache()
        secs[arch] = time.perf_counter() - t0

    # --model 1 with the ladder exchange against the flat run, bitwise
    ladder = dict(get_config=configs.get_config)

    def with_ladder(arch, smoke=False):
        cfg = ladder["get_config"](arch, smoke)
        return dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, cp_exchange="ladder"))
    t0 = time.perf_counter()
    flat, _, plain_a, _ = _launch(torch, mods, DIST_COUNTERS, "--steps",
                                  "2", arch="mamba2-2.7b", layers=2)
    configs.get_config = with_ladder
    try:
        m1, _, plain_b, log = _launch(torch, mods, DIST_COUNTERS, "--steps",
                                      "2", "--model", "1",
                                      arch="mamba2-2.7b", layers=2)
    finally:
        configs.get_config = ladder["get_config"]
    la = [h["loss"] for h in flat["history"]]
    lb = [h["loss"] for h in m1["history"]]
    same = la == lb and all(bits_equal(torch, x, y) for x, y in zip(
        tree_leaves(flat["state"]["master"]),
        tree_leaves(m1["state"]["master"])))
    if plain_a or plain_b or not same or not all(map(math.isfinite, la)):
        raise AssertionError(f"6g --model 1 (ladder) vs flat: losses {la} "
                             f"vs {lb}, bitwise {same}, plain "
                             f"{plain_a + plain_b}")
    res["model1"] = dict(losses=la, bitwise=same,
                         grid=log.splitlines()[0])
    secs["model1"] = time.perf_counter() - t0
    res["seconds"] = secs
    del flat, m1
    torch.cuda.empty_cache()
    for arch, layers in SSM_TRAIN:
        r = res[arch]
        s = r["ssd_scan_ms_per_layer"]
        print(f"6g {arch} x {layers} layers ({r['n_params']} parameters), "
              f"qadam, one NCCL rank: losses "
              + ", ".join(f"{x:.4f}" for x in r["losses"])
              + f"; step wall {r['step_wall_ms']:.3f} ms, device "
              f"{r['step_device_ms']:.3f} ms (idle {r['device_idle']:.1%}), "
              f"{r['tokens_per_s']:.1f} tok/s; phases "
              + ", ".join(f"{k} {v:.3f}" for k, v in r["phases_ms"].items())
              + f" ms; the SSD scan a layer: forward {s['forward']:.4f} ms, "
              f"forward+backward {s['forward_backward']:.4f} ms; a step "
              f"(forward, recompute, backward over {layers} layers) "
              f"{r['ssd_scan_ms_step']:.3f} ms, {r['ssd_scan_share']:.1%} "
              f"of the step's device time; peak "
              f"{r['peak_bytes']} B; launches {r['launches']}; "
              f"captured-gradient update bitwise", flush=True)
        for name, t in r["step_kernels"][:8]:
            print(f"  {t:9.4f} ms  {name[:90]}")
    print(f"6g --model 1 with cp_exchange=ladder bitwise the flat run "
          f"(mamba2 x 2 layers, 2 steps: {res['model1']['losses']}); "
          f"{res['model1']['grid']}; seconds by part: "
          + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()), flush=True)
    launches = {}
    for arch, _ in SSM_TRAIN:
        for k, v in res[arch]["launches"].items():
            launches[k] = launches.get(k, 0) + v
    res["launches"] = launches
    return res


def print_shape_rows(title, table):
    """One line a row of a family's K1, K1t (and #17) shape table."""
    print(title, flush=True)
    for t in table:
        print(f"  {t['what']} {t['shape']} {t['codes']}: {t['ms']:.4f} ms "
              f"plain {t['plain_ms']:.4f} library {t['library_ms']:.4f} "
              f"(kernel/library {t['factor']:.2f}) bound {t['bound_ms']:.4f} "
              f"({t['bound_by']}, {t['bound_ms'] / t['ms']:.1%}); max abs "
              f"err {t['max_abs_err']:.3e}", flush=True)


# ---------------------------------------------------------------------------
# the encoder-decoder family: whisper-small (phases 3, 4n, 6h)
# ---------------------------------------------------------------------------

WHISPER = dict(L=12, d=768, f=3072, V=51865, Sa=1500, H=12, hd=64)
# K1 at whisper's projections: M = 4 is the decode step's slots, M = 1500
# and 6000 the encoder and the cross K/V fill over one and four slots'
# frames
ENCDEC_K1_SHAPES = [(768, 768), (768, 3072), (3072, 768)]
ENCDEC_K1_M = (4, 1500, 6000)
ENCDEC_HEAD_M = (1, 4)


def check_encdec_shapes(torch, dev, MM, B, K, FA):
    """K1 on tensor cores (bf16 activations, int8 codes at k_x = 6) at
    whisper-small's projection shapes for every M of ENCDEC_K1_M
    (``k1_rows``); K1t over the (51865, 768) tied head at M = 1 and 4
    (``k1t_rows``); #17 bidirectional at the encoder's self-attention,
    (4, 1500, 1500, 12/12, 64) in bf16, within its tier, timed beside
    its plain version, its bound and ``scaled_dot_product_attention``
    without a mask, which computes the same function."""
    import torch.nn.functional as F
    g = torch.Generator(device=dev).manual_seed(37)
    table = k1_rows(torch, dev, MM, B, K, g, ENCDEC_K1_SHAPES, ("int8",),
                    ENCDEC_K1_M)
    table += k1t_rows(torch, dev, MM, g, WHISPER["V"], WHISPER["d"],
                      ENCDEC_HEAD_M)
    Bn, S, H, hd = 4, WHISPER["Sa"], WHISPER["H"], WHISPER["hd"]
    q, k, v = (torch.randn((Bn, S, H, hd), generator=g, device=dev).to(
        torch.bfloat16) for _ in range(3))
    fkw = dict(causal=False, window=0, softcap=None)
    n0 = FA.launches_tc
    a = FA.flash_attention(q, k, v, backend="cuda", **fkw)
    if FA.launches_tc != n0 + 1:
        raise AssertionError("#17 at whisper's encoder: off the tc route")
    b = FA.flash_attention(q, k, v, backend="torch", **fkw)
    diff = (a.float() - b.float()).abs()
    if not bool((diff <= flash_tolerance(torch, b)).all()):
        raise AssertionError(f"#17 at whisper's encoder: beyond its tier "
                             f"(max abs {float(diff.max())})")
    bnd, by = bound_ms(4 * q.numel() * q.element_size(),
                       4.0 * hd * S * S * Bn * H)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    row = dict(name="flash_attention_tc", what="#17 encoder",
               shape=[Bn, S, S, H, H, hd], codes="bf16",
               max_abs_err=float(diff.max()), bound_ms=bnd, bound_by=by,
               ms=cuda_ms(torch, lambda i: FA.flash_attention(
                   q, k, v, backend="cuda", **fkw), 20, 2),
               plain_ms=cuda_ms(torch, lambda i: FA.flash_attention(
                   q, k, v, backend="torch", **fkw), 5, 1),
               library_ms=cuda_ms(torch, lambda i:
                                  F.scaled_dot_product_attention(qt, kt, vt),
                                  20, 2))
    row["factor"] = row["ms"] / row["library_ms"]
    table.append(row)
    del q, k, v, qt, kt, vt, a, b, diff
    torch.cuda.empty_cache()
    return table


def graphed_ms(torch, fn, replays: int = 10) -> float:
    """Device ms of one ``fn()`` captured as a CUDA graph (warmed up on a
    side stream, as a captured backward needs) and replayed ``replays``
    times between CUDA events: the device's time with the host out of
    the way."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    end.synchronize()
    del g
    return start.elapsed_time(end) / replays


def attention_ms(torch, dev, cfg, B, Sq, Skv, causal=False, backward=False):
    """The family's plain attention (``layers.attention``) alone at the
    shapes a layer gives it, bf16 inputs, device ms (``graphed_ms``): the
    forward, and with ``backward`` (forward, forward with its backward)."""
    from repro_torch.models import layers as L
    g = torch.Generator(device=dev).manual_seed(43)

    def rnd(S):
        return torch.randn((B, S, cfg.n_heads, cfg.head_dim_), generator=g,
                           device=dev).to(torch.bfloat16)
    q, k, v = rnd(Sq), rnd(Skv), rnd(Skv)
    q_pos = torch.arange(Sq, device=dev) if causal else None
    fwd = graphed_ms(torch, lambda: L.attention(q, k, v, q_pos=q_pos,
                                                causal=causal))
    if not backward:
        return fwd
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]

    def fwd_bwd():
        with torch.enable_grad():
            out = L.attention(*leaves, q_pos=q_pos, causal=causal)
            torch.autograd.grad(out.float().sum(), leaves)
    return fwd, graphed_ms(torch, fwd_bwd)


def layernorm_ms(torch, dev, shape):
    """``layers.layernorm`` alone on a bf16 activation of ``shape``,
    device ms (``graphed_ms``)."""
    from repro_torch.models import layers as L
    x = torch.randn(shape, device=dev).to(torch.bfloat16)
    w, b = torch.ones(shape[-1], device=dev), torch.zeros(shape[-1],
                                                          device=dev)
    return graphed_ms(torch, lambda: L.layernorm(x, w, b, 1e-6), 50)


ENCDEC_SLOTS, ENCDEC_MAX_SEQ = 4, 448      # 448: whisper's text context
ENCDEC_PROMPT, ENCDEC_NEW, ENCDEC_PAGED_STEPS = 64, 16, 8


class _Steps:
    """``model.decode_step`` over a fixed-shape state: the token and
    position buffers and the cache, updated in place, so the step can be
    captured once as a CUDA graph and replayed; ``logits`` is a copy of
    the last step's."""

    def __init__(self, torch, model, qparams, gather, cache, slots, dev):
        self.model, self.qparams, self.gather = model, qparams, gather
        self.cache = cache
        self.tok = torch.zeros((slots, 1), dtype=torch.int32, device=dev)
        self.pos = torch.zeros((slots,), dtype=torch.int32, device=dev)
        self.logits = torch.zeros((slots, model.cfg.vocab_size),
                                  dtype=torch.float32, device=dev)

    def __call__(self):
        out, _ = self.model.decode_step(self.qparams, {"token": self.tok},
                                        self.cache, self.pos, self.gather)
        self.logits.copy_(out)

    def tensors(self):
        return [self.tok, self.pos, self.logits] + list(self.cache.values())


def graph_vs_eager(torch, steps, name="whisper-small"):
    """One decode step eager and through a fresh capture and replay from
    identical state: logits and cache bitwise; then each way's wall (CUDA
    events around the host's calls), device time and operations
    (profiler), idle share and the Q_x kernels' (K3, K4, K12) device
    time, and the graph."""
    ts = steps.tensors()
    snap = [t.clone() for t in ts]

    def restore():
        for t, v in zip(ts, snap):
            t.copy_(v)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        steps()                       # warm-up off the capture stream
    torch.cuda.current_stream().wait_stream(side)
    restore()
    steps()
    eager = [t.clone() for t in ts]
    restore()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        steps()
    graph.replay()
    bad = [i for i, (a, b) in enumerate(zip(ts, eager))
           if not torch.equal(a, b)]
    if bad:
        raise AssertionError(f"{name}'s graphed decode step differs from "
                             f"the eager one in state tensors {bad}")
    del eager
    out = dict(eager_ms=cuda_ms(torch, lambda i: steps(), 8, 1),
               graph_ms=cuda_ms(torch, lambda i: graph.replay(), 8, 1))
    out["eager_device_ms"], out["eager_kernels"], out["eager_device_ops"] = \
        profile_ms(torch, steps, PROFILED_CALLS, with_launches=True)
    out["graph_device_ms"], _, out["graph_device_ops"] = profile_ms(
        torch, graph.replay, PROFILED_CALLS, with_launches=True)
    out["qx_kernels_ms"] = sum(t for n, t in out["eager_kernels"]
                               if any(k in n for k in QX_KERNELS))
    out["eager_kernels"] = out["eager_kernels"][:10]
    out["eager_idle"] = 1 - out["eager_device_ms"] / out["eager_ms"]
    out["graph_idle"] = 1 - out["graph_device_ms"] / out["graph_ms"]
    restore()
    del snap
    return out, graph


def serve_encdec(torch, dev, mods):
    """Phase 4n: whisper-small at full width and depth (12 + 12 layers),
    bf16, ``quantize_params(k_x=6)`` leaf by leaf, served through the
    model API (the reference's serving path of the family: no session
    takes it), every count at 0 just before the main path:
    ``prefill_encoder`` over ``batch_for_model``'s audio (4, 1500, 768)
    into fixed lanes of ENCDEC_MAX_SEQ positions, then a 64-token prompt
    a slot fed through ``decode_step`` a token at a time, then 16 greedy
    tokens; then the paged variant (page 16) for ENCDEC_PAGED_STEPS
    steps. Gates: K1, K1t, K3, K4, K12 (the embedding rows) and K2 (the
    paged run) launched, no plain version on the card, no host sync
    after the first step (torch's sync debug mode), finite logits, the
    paged steps' logits those of the fixed lanes; kernels-vs-plain
    logits of one step at depth 1 and 2 in bf16 (SHALLOW_LIMIT) and of
    ``prefill_encoder`` (its cross caches too) and one step at full
    depth in float32 (F32_LIMIT), where one K row dropped from every
    layer's ``xattn.k`` in the plain run must fail the gates; the decode
    step eager and as
    one captured CUDA graph, bitwise. Readings: the encoder prefill's
    device ms, the step eager and graphed (wall, device, operations),
    tok/s, resident codes, the cross cache a slot, the start-up peak."""
    import warnings
    import numpy as np
    MM, paged, K = mods["MM"], mods["paged"], mods["K"]
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import batch_for_model
    from repro_torch.launch.serve import quantize_in_place
    from repro_torch.models.model import Model
    from repro_torch.serve.quantized import make_dequant_gather, params_nbytes

    cfg = get_config("whisper-small")
    model = Model(cfg)
    slots, Sa = ENCDEC_SLOTS, cfg.encoder_seq
    secs, t_mark = {}, [time.perf_counter()]

    def mark(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        secs[name] = now - t_mark[0]
        t_mark[0] = now
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(
        1, cfg.vocab_size, size=(slots, ENCDEC_PROMPT)).astype(np.int32)).to(
        dev)
    audio = torch.from_numpy(next(batch_for_model(
        cfg, ENCDEC_PROMPT, slots, seed=0))["audio"]).to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # the main path, with every kernel count at 0 just before it
    zero_serving_counts(MM, paged, K)
    t0 = time.perf_counter()
    params = model.init(seed=0, device=dev)
    fp_bytes = params_nbytes(params)
    qparams = quantize_in_place(params, k_x=6, pack=True)
    del params
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    peak_start = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    q_bytes = params_nbytes(qparams)
    gather = make_dequant_gather()
    cache = model.init_cache(slots, ENCDEC_MAX_SEQ, device=dev,
                             encoder_seq_local=Sa)
    cross_slot = cache["ck"][:, 0].nbytes + cache["cv"][:, 0].nbytes
    steps = _Steps(torch, model, qparams, gather, cache, slots, dev)
    caught = []
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    model.prefill_encoder(qparams, audio, cache, gather)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t1
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t2 = time.perf_counter()
            for t in range(ENCDEC_PROMPT + ENCDEC_NEW):
                if t < ENCDEC_PROMPT:
                    steps.tok.copy_(prompt[:, t:t + 1])
                else:
                    steps.tok.copy_(steps.logits.argmax(-1, keepdim=True))
                steps()
                steps.pos.add_(1)
                if t == 0:
                    first = len(caught)
                if t == ENCDEC_PROMPT - 1:
                    torch.cuda.synchronize()
                    t3 = time.perf_counter()
            torch.cuda.synchronize()
            t4 = time.perf_counter()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message)[:160] for w in caught[first:]
             if "synchroniz" in str(w.message)]
    t_prompt, t_new = t3 - t2, t4 - t3
    logits = steps.logits.clone()
    # the paged variant: the same audio and prompt into a page pool
    pcache = model.init_cache(slots, ENCDEC_MAX_SEQ, device=dev,
                              encoder_seq_local=Sa,
                              page_pool=(slots * ENCDEC_MAX_SEQ // 16, 16))
    npag = ENCDEC_MAX_SEQ // 16
    pcache["ptab"].copy_(torch.arange(slots * npag, dtype=torch.int32,
                                      device=dev).reshape(slots, npag))
    model.prefill_encoder(qparams, audio, pcache, gather)
    lanes = model.init_cache(slots, ENCDEC_MAX_SEQ, device=dev,
                             encoder_seq_local=Sa)
    lanes["ck"].copy_(pcache["ck"])
    lanes["cv"].copy_(pcache["cv"])
    paged_rel, paged_bitwise = 0.0, True
    for t in range(ENCDEC_PAGED_STEPS):
        tok, pos = prompt[:, t:t + 1], torch.full((slots,), t,
                                                  dtype=torch.int32,
                                                  device=dev)
        lp, _ = model.decode_step(qparams, {"token": tok}, pcache, pos,
                                  gather)
        lf, _ = model.decode_step(qparams, {"token": tok}, lanes, pos, gather)
        paged_bitwise &= bool(torch.equal(lp, lf))
        paged_rel = max(paged_rel, float((lp - lf).norm() / lf.norm()))
    del pcache, lanes
    mark("main_path")
    launches = {"dequant_matmul_tc": MM.launches_tc,
                "dequant_matmul_t_tc": MM.t_launches_tc,
                "gather_pages_kv": paged.launches_kv,
                "amax_rows": K.amax_launches,
                "uniform_quantize_rows": K.quantize_launches,
                "uniform_dequantize_rows": K.dequantize_launches}
    plain = serving_plain(MM, paged, K)
    if any(n == 0 for n in launches.values()) or plain or \
            MM.launches_fma or MM.launches_tc_packed or MM.t_launches_fma \
            or paged.launches != paged.launches_kv:
        raise AssertionError(f"whisper-small: launches {launches}, {plain} "
                             f"plain calls on the card, K1 CUDA-core "
                             f"{MM.launches_fma}, packed "
                             f"{MM.launches_tc_packed}, K1t CUDA-core "
                             f"{MM.t_launches_fma}, K2 one pool "
                             f"{paged.launches - paged.launches_kv}")
    if syncs:
        raise AssertionError(f"whisper-small: {len(syncs)} host syncs after "
                             f"the first decode step: {sorted(set(syncs))}")
    if not bool(torch.isfinite(logits).all()) or logits.shape != (
            slots, cfg.vocab_size):
        raise AssertionError("whisper-small: decode logits not finite or "
                             "misshapen")
    if not paged_rel <= SHALLOW_LIMIT:
        raise AssertionError(f"whisper-small: paged logits rel L2 "
                             f"{paged_rel} from the fixed lanes'")

    # readings: the encoder prefill and the decode step, eager and graphed
    enc_ms, enc_kernels = profile_ms(
        torch, lambda: model.prefill_encoder(qparams, audio, cache, gather), 2)
    enc_wall = cuda_ms(torch, lambda i: model.prefill_encoder(
        qparams, audio, cache, gather), 3, 1)
    dg, graph = graph_vs_eager(torch, steps)
    del graph
    # what the plain parts take: the cross-attention and the layernorms
    # of a decode step, the encoder's self-attention and K1 in the prefill
    L_, d = cfg.n_layers, cfg.d_model
    shares = dict(
        step_cross_attention_ms=L_ * attention_ms(torch, dev, cfg, slots, 1,
                                                  Sa),
        step_layernorm_ms=(3 * L_ + 1) * layernorm_ms(torch, dev,
                                                      (slots, 1, d)),
        prefill_attention_ms=cfg.encoder_layers * attention_ms(
            torch, dev, cfg, slots, Sa, Sa),
        prefill_layernorm_ms=(2 * cfg.encoder_layers + 1) * layernorm_ms(
            torch, dev, (slots, Sa, d)),
        prefill_k1_ms=sum(t for n, t in enc_kernels if "k1_" in n))
    for key, whole in (("step", dg["graph_device_ms"]), ("prefill", enc_ms)):
        for part in ("cross_attention", "attention", "layernorm", "k1"):
            if f"{key}_{part}_ms" in shares:
                shares[f"{key}_{part}_share"] = \
                    shares[f"{key}_{part}_ms"] / whole
    mark("timings")

    # gates: one decode step through the kernels and the plain versions
    plain_gather = make_dequant_gather(backend="torch")

    def rel_l2(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    def step_of(mdl, qp, c, backend=None):
        return mdl.decode_step(qp, {"token": steps.tok}, c, steps.pos,
                               plain_gather if backend else gather,
                               backend=backend)[0]
    gates = {}
    for n in (1, 2):
        mdl = Model(dataclasses.replace(cfg, n_layers=n))
        qp = dict(qparams, blocks=first_layers(qparams["blocks"], n))
        a = step_of(mdl, qp, {k: v[:n].clone() for k, v in cache.items()})
        b = step_of(mdl, qp, {k: v[:n].clone() for k, v in cache.items()},
                    "torch")
        gates[f"bf16@{n}"] = rel_l2(a, b)
        if not gates[f"bf16@{n}"] <= SHALLOW_LIMIT:
            raise AssertionError(f"whisper-small decode logits at depth {n}:"
                                 f" kernels vs plain rel L2 "
                                 f"{gates[f'bf16@{n}']} > {SHALLOW_LIMIT}")
    a = step_of(model, qparams, {k: v.clone() for k, v in cache.items()})
    b = step_of(model, qparams, {k: v.clone() for k, v in cache.items()},
                "torch")
    gates["bf16@full"] = rel_l2(a, b)
    # float32 at full depth: the encoder prefill and one step, each path
    # from the same self-attention lanes
    m32 = Model(dataclasses.replace(cfg, dtype="float32"))

    def f32_path(qp, backend=None):
        """float32 logits of one step after ``prefill_encoder``, and the
        cross caches it wrote."""
        c = {k: v.to(torch.float32, copy=True) for k, v in cache.items()}
        m32.prefill_encoder(qp, audio, c, plain_gather if backend else gather,
                            backend=backend)
        return step_of(m32, qp, c, backend), c["ck"], c["cv"]

    def f32_gates(got, want):
        return {name: rel_l2(a, b) for name, a, b in zip(
            ("f32@full", "f32_ck", "f32_cv"), got, want)}
    want = f32_path(qparams, "torch")
    gates.update(f32_gates(f32_path(qparams), want))
    over = {k: v for k, v in gates.items() if k.startswith("f32")
            and not v <= F32_LIMIT}
    if over:
        raise AssertionError(f"whisper-small float32 prefill_encoder and "
                             f"decode step: kernels vs plain rel L2 {over} "
                             f"> {F32_LIMIT}")
    # the planted fault: one K row dropped from every layer's xattn.k in
    # the plain run; it must fail the float32 gates (the cross cache's:
    # random weights leave the cross-attention's softmax near uniform, so
    # the logits barely see the keys)
    xk = qparams["blocks"]["xattn"]["k"]
    codes = xk.codes.clone()
    codes[:, -1, :] = 0
    blocks = dict(qparams["blocks"], xattn=dict(
        qparams["blocks"]["xattn"], k=dataclasses.replace(xk, codes=codes)))
    faults = f32_gates(f32_path(dict(qparams, blocks=blocks), "torch"), want)
    fault = max(faults.values())
    del codes, blocks, want
    if not fault > F32_LIMIT:
        raise AssertionError(f"whisper-small: one K row dropped from "
                             f"xattn.k passes the float32 gate ({fault})")
    mark("gates")
    n_new = slots * ENCDEC_NEW
    res = dict(arch=cfg.name, layers=cfg.n_layers,
               encoder_layers=cfg.encoder_layers, launches=launches,
               startup_s=t_quant, prefill_encoder_s=t_prefill,
               prompt_s=t_prompt, new_s=t_new, tokens=n_new,
               tok_per_s=n_new / t_new,
               prompt_tok_per_s=slots * ENCDEC_PROMPT / t_prompt,
               resident_bytes=q_bytes, fp32_bytes=fp_bytes,
               cross_cache_bytes_per_slot=cross_slot,
               peak_startup_bytes=peak_start,
               peak_bytes=torch.cuda.max_memory_allocated(),
               encoder_prefill_device_ms=enc_ms,
               encoder_prefill_ms=enc_wall,
               encoder_prefill_kernels=enc_kernels[:10],
               decode_graph=dg, gates=gates, fault_xattn_k_f32=faults,
               shares=shares,
               paged_rel_l2=paged_rel, paged_bitwise=paged_bitwise,
               seconds=secs)
    print(f"whisper-small ({cfg.n_layers} + {cfg.encoder_layers} layers): "
          f"prefill_encoder of {slots} x {Sa} frames {t_prefill:.3f} s at "
          f"first ({enc_wall:.3f} ms warm, {enc_ms:.3f} ms device); "
          f"{ENCDEC_PROMPT} prompt tokens a slot in {t_prompt:.3f} s, "
          f"{ENCDEC_NEW} greedy in {t_new:.3f} s ({n_new / t_new:.2f} "
          f"tok/s); resident codes {q_bytes} B of {fp_bytes} B float32; "
          f"cross cache {cross_slot} B a slot; start-up peak {peak_start} B; "
          f"launches {launches}; no host sync after the first step; paged "
          f"vs fixed lanes rel L2 {paged_rel:.3e} (bitwise "
          f"{paged_bitwise}); logits kernels vs plain: "
          + ", ".join(f"{k} {v:.4e}" for k, v in gates.items())
          + f" (limits {SHALLOW_LIMIT}, {F32_LIMIT}); xattn.k's K row "
          f"dropped: " + ", ".join(f"{k} {v:.4e}" for k, v in faults.items())
          + " (caught)", flush=True)
    print(f"whisper-small decode step, {slots} slots at position "
          f"{ENCDEC_PROMPT + ENCDEC_NEW}: eager {dg['eager_ms']:.3f} ms wall, "
          f"{dg['eager_device_ms']:.3f} ms device (idle "
          f"{dg['eager_idle']:.1%}, {dg['eager_device_ops']:.0f} "
          f"operations); CUDA graph {dg['graph_ms']:.3f} ms wall, "
          f"{dg['graph_device_ms']:.3f} ms device (idle "
          f"{dg['graph_idle']:.1%}, {dg['graph_device_ops']:.0f} "
          f"operations); bitwise eager vs graphed; plain parts alone: "
          + ", ".join(f"{k} {v:.4g}" for k, v in shares.items())
          + "; seconds by part: "
          + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()), flush=True)
    for name, t in dg["eager_kernels"][:8]:
        print(f"  step {t:9.4f} ms  {name[:90]}")
    for name, t in enc_kernels[:6]:
        print(f"  prefill_encoder {t:9.4f} ms  {name[:80]}")
    del qparams, cache, steps, audio
    torch.cuda.empty_cache()
    return res


ENCDEC_TRAIN_SEQ, ENCDEC_TRAIN_STEPS = 448, 4


def host_ops(torch, fn, top=8):
    """The host's time in one ``fn()`` by operator, from torch.profiler's
    CPU activity after a warm call: (total self ms, [(operator, self ms,
    calls)] largest first)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count)
                   for e in prof.key_averages()), key=lambda r: -r[1])
    return sum(r[1] for r in rows), rows[:top]


def encdec_train(torch, dev, mods, group):
    """Phase 6h: whisper-small at full width and depth through
    ``launch.train``'s path on the one NCCL rank, Algorithms 2+3
    ``qadam``, ENCDEC_TRAIN_STEPS steps of TRAIN_BATCH x 448 tokens beside
    TRAIN_BATCH x 1500 audio frames, through phase 6's gates (finite
    losses, K15, K7 and K6 launched, no plain version, no steady host
    sync, the bytes moved equal to ``comm_bytes_per_step``, a
    captured-gradient update bitwise through the kernels and the plain
    versions); then ``launch.train`` flat and with ``--data 1 --model 1``
    (the model axis at one shard: the frames and tokens stay whole),
    2 steps each, bitwise equal; then where the host's time goes in a
    step of the flat run's session, by operator; and the plain attention
    alone at the step's shapes."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import batch_for_model
    from repro_torch.dist.step import TrainConfig
    from repro_torch.models.model import Model
    from repro_torch.train.session import SessionConfig, TrainSession
    from repro_torch.tree import tree_leaves
    cfg = get_config("whisper-small")
    t0 = time.perf_counter()
    r = dist_run(torch, dev, mods, group, Model(cfg), cfg,
                 TrainConfig(**DIST_TC), DIST_COUNTERS, ENCDEC_TRAIN_STEPS,
                 "6h whisper-small", falling=False, seq=ENCDEC_TRAIN_SEQ)
    secs = {"dist_run": time.perf_counter() - t0}
    t0 = time.perf_counter()
    kw = dict(arch="whisper-small", layers=cfg.n_layers,
              seq=ENCDEC_TRAIN_SEQ)
    flat, _, plain_a, _ = _launch(torch, mods, DIST_COUNTERS, "--steps", "2",
                                  **kw)
    m1, _, plain_b, log = _launch(torch, mods, DIST_COUNTERS, "--steps", "2",
                                  "--data", "1", "--model", "1", **kw)
    la = [h["loss"] for h in flat["history"]]
    lb = [h["loss"] for h in m1["history"]]
    same = la == lb and all(bits_equal(torch, x, y) for x, y in zip(
        tree_leaves(flat["state"]["master"]),
        tree_leaves(m1["state"]["master"])))
    if plain_a or plain_b or not same or not all(map(math.isfinite, la)):
        raise AssertionError(f"6h --data 1 --model 1 vs flat: losses {la} vs "
                             f"{lb}, bitwise {same}, plain "
                             f"{plain_a + plain_b}")
    secs["model1"] = time.perf_counter() - t0
    sess = TrainSession.from_artifacts(
        flat["art"], batch_for_model(cfg, ENCDEC_TRAIN_SEQ, TRAIN_BATCH,
                                     seed=7),
        SessionConfig(log_every=1), state=flat["state"], device=dev,
        log=lambda *_: None)
    try:
        r["host_ms"], r["host_ops"] = host_ops(torch, lambda: sess.run(1))
    finally:
        sess.close()
    del sess
    # the plain attention of a step alone: the encoder's, the decoder's
    # causal one and the cross-attention, each run forward twice (the
    # forward, and its recompute under the per-block checkpoint) and
    # backward once, over every layer
    Sa, S, n = cfg.encoder_seq, ENCDEC_TRAIN_SEQ, cfg.n_layers
    att = {name: attention_ms(torch, dev, cfg, TRAIN_BATCH, sq, skv,
                              causal=causal, backward=True)
           for name, sq, skv, causal in (("encoder", Sa, Sa, False),
                                         ("decoder", S, S, True),
                                         ("cross", S, Sa, False))}
    r["attention_ms_per_layer"] = att
    r["attention_ms_step"] = n * sum(f + fb for f, fb in att.values())
    r["attention_share"] = r["attention_ms_step"] / r["step_device_ms"]
    r.update(model1=dict(losses=la, bitwise=same, grid=log.splitlines()[0]),
             seconds=secs, seq=ENCDEC_TRAIN_SEQ, frames=cfg.encoder_seq)
    del flat, m1
    torch.cuda.empty_cache()
    print(f"6h whisper-small ({cfg.n_layers} + {cfg.encoder_layers} layers, "
          f"{r['n_params']} parameters), qadam, one NCCL rank, {TRAIN_BATCH} "
          f"x {ENCDEC_TRAIN_SEQ} tokens and {TRAIN_BATCH} x "
          f"{cfg.encoder_seq} frames: losses "
          + ", ".join(f"{x:.4f}" for x in r["losses"])
          + f"; step wall {r['step_wall_ms']:.3f} ms, device "
          f"{r['step_device_ms']:.3f} ms (idle {r['device_idle']:.1%}), "
          f"{r['tokens_per_s']:.1f} tok/s; phases "
          + ", ".join(f"{k} {v:.3f}" for k, v in r["phases_ms"].items())
          + f" ms; the plain attention alone (forward, forward+backward a "
          f"layer: " + ", ".join(f"{k} {f:.3f}/{fb:.3f}" for k, (f, fb) in
                                  r["attention_ms_per_layer"].items())
          + f" ms) {r['attention_ms_step']:.3f} ms a step, "
          f"{r['attention_share']:.1%} of its device time; peak "
          f"{r['peak_bytes']} B; launches {r['launches']}; "
          f"captured-gradient update bitwise; --data 1 --model 1 bitwise "
          f"the flat run ({la}; {r['model1']['grid']}); the host's "
          f"{r['host_ms']:.1f} ms of a step by operator (self ms, calls): "
          + ", ".join(f"{k} {t:.1f}/{n}" for k, t, n in r["host_ops"])
          + "; seconds "
          + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()), flush=True)
    for name, t in r["step_kernels"][:10]:
        print(f"  {t:9.4f} ms  {name[:90]}")
    return r


# sharded serving (phase 4o): one card holds one model shard
MESH_SLOTS = 4
MESH_MAX_SEQ = 64
MESH_STEPS = 6
MESH_PAGE = 16
MESH_K_X = 8
MESH_PROMPT = 6
MESH_NEW = 4
MESH_CUT = 2          # hymba-1.5b, whisper-small, deepseek-moe-16b layers
MESH_CUTS = ("hymba-1.5b", "whisper-small", "deepseek-moe-16b")
MESH_COUNTERS = {"gather_pages_kv": ("paged", "launches_kv"),
                 "amax_rows": ("K", "amax_launches"),
                 "uniform_quantize_rows": ("K", "quantize_launches"),
                 "uniform_dequantize_rows": ("K", "dequantize_launches")}


def _mesh_round_trip(torch, step, params):
    """The tree a one-shard gather gives: every leaf the layout shards
    through a local Q_x round trip (K3, K4, K12), one scale a leaf. At
    one shard the layout replicates every leaf but the MoE expert
    stacks (as the reference's), so only those change."""
    from repro_torch.dist import collectives as C
    from repro_torch.dist import sharding as SH
    from repro_torch.tree import tree_map

    def one(p, d, s):
        ax = SH.axis_of(d, s)
        return p if ax is None else C.quantized_gather_shard(
            p, ax, 1, MESH_K_X, False)
    return tree_map(one, params, step.layout.dims, step.layout.stacked)


def _mesh_decode(torch, step, params, cache, toks):
    out = []
    for t in range(toks.shape[1]):
        lg, _ = step(params, {"token": toks[:, t:t + 1]}, cache, t)
        out.append(lg.clone())
    return out


class _MeshSteps(_Steps):
    """:class:`_Steps` through a ``dist.serve`` decode step."""

    def __init__(self, torch, step, params, cache, dev):
        super().__init__(torch, step.model, params, None, cache, MESH_SLOTS,
                         dev)
        self.step = step
        self.tok.fill_(1)
        self.pos.fill_(MESH_STEPS)

    def __call__(self):
        out, _ = self.step(self.qparams, {"token": self.tok}, self.cache,
                           self.pos)
        self.logits.copy_(out)


def _mesh_graph(torch, step, params, cache, dev, name):
    """The mesh decode step eager and graphed (``graph_vs_eager``), and
    the weight gather alone (the step context's "static" pass) as a CUDA
    graph, with its share of the graphed step's time (CUDA events: the
    profiler has dropped an eager step's events on a long run). A layout
    that shards no leaf gathers nothing: 0."""
    from repro_torch.dist import sharding as SH
    from repro_torch.tree import tree_leaves
    dg, graph = graph_vs_eager(torch, _MeshSteps(torch, step, params, cache,
                                                 dev), name)
    del graph
    moves = any(d != SH.REPLICATED for d in tree_leaves(step.layout.dims))
    dg["gather_ms"] = graph_ms(
        torch, lambda i: step.ctx.gather(params, "static"), 1, 5) \
        if moves else 0.0
    dg["gather_share"] = dg["gather_ms"] / dg["graph_ms"]
    return dg


def serve_mesh(torch, dev, mods):
    """Phase 4o: sharded serving at Nm = 1 (``dist.serve``) on the one
    NCCL rank (``make_grid(data=1, model=1)``): gemma2-2b at full width
    and depth (26 layers, its 10.5 GB float32 tree the rank's one model
    shard) through ``make_serve_step`` with ``ServeConfig(weight_k=8)``,
    then hymba-1.5b, whisper-small and deepseek-moe-16b at full width
    cut to MESH_CUT layers, every count at 0 just before the main path.
    At one shard the layout replicates every leaf but the expert stacks
    (the reference's ``build_layout``), so the int8 gather round-trips
    deepseek's expert stacks only (K3, K4, K12) and gemma2's step is the
    float32 decode with no gather: gemma2's mesh
    decode of MESH_STEPS steps over fixed lanes and over a page pool
    (page MESH_PAGE, a scrambled table), a ``ServeSession(decode_fn=
    step)`` draining MESH_SLOTS requests and its batch-synchronous loop,
    the kind "prefill" step; hymba's and deepseek's mesh decode;
    whisper's ``prefill_encoder`` under the step's context, then its
    mesh decode.
    Gates: the mesh decode bitwise the local ``decode_step`` on the tree
    after a per-leaf Q_x round trip (what one shard's gather is), the
    paged mesh decode bitwise the fixed-lane one, the session's greedy
    tokens those of the loop, the mesh prefill bitwise ``Model.prefill``
    on the round-tripped tree, whisper's cross caches bitwise; K2, K3,
    K4 and K12 launched, no plain version on the card; the decode step
    eager and as one captured CUDA graph, bitwise (gemma2's and
    deepseek's). Readings: each of those steps' eager and graphed wall
    and device ms, the gather alone and its share of the graphed step,
    the start-up peak and the peak."""
    MM, paged, K = mods["MM"], mods["paged"], mods["K"]
    from repro_torch.configs import get_config
    from repro_torch.dist.serve import ServeConfig, make_serve_step
    from repro_torch.launch.mesh import make_grid
    from repro_torch.models.model import Model
    from repro_torch.serve.quantized import params_nbytes
    from repro_torch.serve.session import Request, ServeSession

    grid = make_grid(data=1, model=1, device="cuda")
    sc = ServeConfig(weight_k=MESH_K_X, worker_axes=("data",))
    torch.cuda.synchronize()
    allocated_at_start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(0)
    B, S = MESH_SLOTS, MESH_MAX_SEQ
    cfg = get_config("gemma2-2b")
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(seed=0, device=dev)
    fp_bytes = params_nbytes(params)
    step, _, _ = make_serve_step(model, grid, sc, "decode")
    pstep, _, _ = make_serve_step(model, grid, sc, "prefill")
    shard = step.shard_params(params)          # one shard: the tree
    toks = torch.randint(1, cfg.vocab_size, (B, MESH_STEPS), generator=gen,
                         device=dev, dtype=torch.int32)
    ptoks = torch.randint(1, cfg.vocab_size, (B, 32), generator=gen,
                          device=dev, dtype=torch.int32)
    cuts = {}
    for arch in MESH_CUTS:
        c = get_config(arch)
        c = dataclasses.replace(c, n_layers=MESH_CUT, encoder_layers=(
            MESH_CUT if c.encoder_layers else c.encoder_layers))
        m = Model(c)
        p = m.init(seed=1, device=dev)
        cuts[arch] = (c, m, p, make_serve_step(m, grid, sc, "decode")[0])
    audio = torch.randn((B, cuts["whisper-small"][0].encoder_seq,
                         cuts["whisper-small"][0].d_model), generator=gen,
                        device=dev)

    # the main path, with every kernel count at 0 just before it
    zero_serving_counts(MM, paged, K)
    cache = step.init_cache(B, S, device=dev)
    mesh = _mesh_decode(torch, step, shard, cache, toks)
    torch.cuda.synchronize()
    startup_s = time.perf_counter() - t0
    peak_startup = torch.cuda.max_memory_allocated()
    npag = S // MESH_PAGE
    whole = model.init_cache(B, S, page_pool=(B * npag, MESH_PAGE),
                             device=dev)
    perm = torch.randperm(B * npag, generator=gen, device=dev)
    whole["ptab"].copy_(perm.to(torch.int32).reshape(B, npag))
    pcache = step.shard_cache(whole)
    del whole
    paged_logits = _mesh_decode(torch, step, shard, pcache, toks)
    del pcache
    prompts = [[int(x) for x in row] for row in
               toks[:, :MESH_PROMPT].cpu().numpy()]
    loop_cache = step.init_cache(B, S, device=dev)
    cur = toks[:, :1]
    loop = [[] for _ in range(B)]
    for t in range(MESH_PROMPT + MESH_NEW - 1):
        lg, _ = step(shard, {"token": cur}, loop_cache, t)
        nxt = torch.argmax(lg, dim=-1).to(torch.int32)
        if t + 1 < MESH_PROMPT:
            cur = toks[:, t + 1:t + 2]
        else:
            for i, v in enumerate(nxt.tolist()):
                loop[i].append(v)
            cur = nxt[:, None]
    del loop_cache
    sess = ServeSession(model, shard, slots=B, max_seq=S, decode_fn=step,
                        device=dev)
    hs = [sess.submit(Request(prompt=p, max_new_tokens=MESH_NEW))
          for p in prompts]
    res = sess.drain()
    session_tokens = [res[h].tokens for h in hs]
    sess_stats = dict(sess.stats)
    del sess
    pf_logits, pf_cache = pstep(shard, {"tokens": ptoks})
    hy_c, _, hy_p, hy_step = cuts["hymba-1.5b"]
    hy_cache = hy_step.init_cache(B, S, device=dev)
    hy_mesh = _mesh_decode(torch, hy_step, hy_step.shard_params(hy_p),
                           hy_cache, toks % hy_c.vocab_size)
    wh_c, _, wh_p, wh_step = cuts["whisper-small"]
    wh_cache = wh_step.init_cache(B, S, device=dev,
                                  encoder_seq=wh_c.encoder_seq)
    wh_shard = wh_step.shard_params(wh_p)
    wh_step.prefill_encoder(wh_shard, audio, wh_cache)
    wh_cross = {k: wh_cache[k].clone() for k in ("ck", "cv")}
    wh_mesh = _mesh_decode(torch, wh_step, wh_shard, wh_cache,
                           toks % wh_c.vocab_size)
    ds_c, _, ds_p, ds_step = cuts["deepseek-moe-16b"]
    ds_cache = ds_step.init_cache(B, S, device=dev)
    ds_shard = ds_step.shard_params(ds_p)
    ds_mesh = _mesh_decode(torch, ds_step, ds_shard, ds_cache,
                           toks % ds_c.vocab_size)
    torch.cuda.synchronize()
    launches = {name: getattr({"paged": paged, "K": K}[m], attr)
                for name, (m, attr) in MESH_COUNTERS.items()}
    plain = serving_plain(MM, paged, K)
    if any(n == 0 for n in launches.values()) or plain:
        raise AssertionError(f"phase 4o: launches {launches}, {plain} "
                             f"plain calls on the card")

    # the comparisons, outside the counted run
    qp = _mesh_round_trip(torch, step, params)
    local_cache = model.init_cache(B, S, device=dev)
    for t in range(MESH_STEPS):
        lg, _ = model.decode_step(qp, {"token": toks[:, t:t + 1]},
                                  local_cache, t)
        if not torch.equal(lg, mesh[t]):
            raise AssertionError(f"gemma2-2b mesh decode step {t} is not "
                                 f"the local decode on the round-tripped "
                                 f"tree (max abs "
                                 f"{float((lg - mesh[t]).abs().max())})")
    del local_cache
    for t in range(MESH_STEPS):
        if not torch.equal(paged_logits[t], mesh[t]):
            raise AssertionError(f"gemma2-2b paged mesh decode step {t} is "
                                 f"not the fixed-lane mesh decode")
    if session_tokens != loop:
        raise AssertionError(f"mesh session tokens {session_tokens} are "
                             f"not the batch-synchronous loop's {loop}")
    if sess_stats["captures"] < 1 or sess_stats["replays"] < 1:
        raise AssertionError(f"the mesh session's decode step ran no CUDA "
                             f"graph: {sess_stats}")
    want_lg, want_cache = model.prefill(qp, {"tokens": ptoks},
                                        max_seq_local=32)
    if not torch.equal(pf_logits, want_lg) or any(
            not torch.equal(pf_cache[k], want_cache[k]) for k in want_cache):
        raise AssertionError("gemma2-2b mesh prefill is not Model.prefill "
                             "on the round-tripped tree")
    del want_lg, want_cache, pf_logits, pf_cache
    for name, (c, m, p, st), got, extra in (
            ("hymba-1.5b", cuts["hymba-1.5b"], hy_mesh, None),
            ("whisper-small", cuts["whisper-small"], wh_mesh, wh_cross),
            ("deepseek-moe-16b", cuts["deepseek-moe-16b"], ds_mesh, None)):
        q = _mesh_round_trip(torch, st, p)
        lc = m.init_cache(B, S, device=dev,
                          encoder_seq_local=c.encoder_seq or 0)
        if extra is not None:
            m.prefill_encoder(q, audio, lc)
            if any(not torch.equal(lc[k], extra[k]) for k in extra):
                raise AssertionError(f"{name}: the mesh prefill_encoder's "
                                     f"cross caches are not the local ones")
        for t in range(MESH_STEPS):
            lg, _ = m.decode_step(q, {"token": toks[:, t:t + 1]
                                      % c.vocab_size}, lc, t)
            if not torch.equal(lg, got[t]):
                raise AssertionError(f"{name} mesh decode step {t} is not "
                                     f"the local decode")
        del q, lc
    del qp
    for x in mesh + [paged_logits[-1], hy_mesh[-1], wh_mesh[-1],
                     ds_mesh[-1]]:
        if not bool(torch.isfinite(x).all()):
            raise AssertionError("phase 4o: logits not finite")

    # readings: gemma2's and deepseek's mesh decode steps, eager and
    # graphed
    dg = _mesh_graph(torch, step, shard, cache, dev, "gemma2-2b (4o)")
    dd = _mesh_graph(torch, ds_step, ds_shard, ds_cache, dev,
                     "deepseek-moe-16b (4o)")
    peak = torch.cuda.max_memory_allocated()
    del cache, shard, params, cuts, hy_cache, wh_cache, mesh, paged_logits
    del ds_cache, ds_shard
    return dict(arch="gemma2-2b", layers=cfg.n_layers, slots=B, max_seq=S,
                weight_k=MESH_K_X, fp32_bytes=fp_bytes,
                launches=launches, session_stats=sess_stats,
                session_tokens=session_tokens, startup_s=startup_s,
                peak_startup_bytes=peak_startup, peak_bytes=peak,
                allocated_at_start=allocated_at_start,
                cut_layers=MESH_CUT, decode_graph=dg,
                moe_decode_graph=dd,
                moe_expert_bytes=sum(ds_p["blocks"]["moe"][k].nbytes
                                     for k in ("w_gate", "w_up", "w_down")))


def flash_path(torch, dev, FA):
    """#17 through its entry point as a caller runs it (no model calls it,
    in either package): the attention of one gemma2-2b prefill of 8192
    tokens, all 26 layers with their windows (local 4096, global), in bf16
    (route "tc"), then in float32 (route "tc32", 3xTF32), the counts at 0
    just before each. Returns the launch counts and times."""
    from repro_torch.configs import get_config
    cfg = get_config("gemma2-2b")
    g = torch.Generator(device=dev).manual_seed(23)
    S, H, K, hd = 8192, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    out = dict(layers=cfg.n_layers, seq=S)
    for dt, key, count in ((torch.bfloat16, "flash_attention_tc", "tc"),
                           (torch.float32, "flash_attention_tc32", "tc32")):
        q = torch.randn((1, S, H, hd), generator=g, device=dev).to(dt)
        k, v = (torch.randn((1, S, K, hd), generator=g, device=dev).to(dt)
                for _ in range(2))
        torch.cuda.synchronize()
        FA.launches = FA.launches_tc = FA.launches_tc32 = 0
        FA.plain_on_cuda = 0
        t0 = time.perf_counter()
        outs = [FA.flash_attention(q, k, v, causal=True, window=w,
                                   softcap=cfg.attn_softcap)
                for w in cfg.layer_windows()]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = FA.launches_tc if count == "tc" else FA.launches_tc32
        if n != cfg.n_layers or FA.launches != n or FA.plain_on_cuda:
            raise AssertionError(f"flash path ({dt}): {n} launches of the "
                                 f"{count} route, {FA.launches} in all, "
                                 f"{FA.plain_on_cuda} plain calls on the "
                                 f"card")
        if not all(bool(torch.isfinite(o).all()) for o in outs):
            raise AssertionError("flash path: non-finite attention outputs")
        tag = "bf16" if dt == torch.bfloat16 else "f32"
        # a second pass, outside the counted path: its outputs reuse the
        # first pass's memory, so the wall is the attention's, not the
        # allocator's
        del outs
        t0 = time.perf_counter()
        outs = [FA.flash_attention(q, k, v, causal=True, window=w,
                                   softcap=cfg.attn_softcap)
                for w in cfg.layer_windows()]
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        out[f"launches_{tag}"] = {key: n}
        out[f"wall_ms_{tag}"] = wall * 1e3
        out[f"warm_wall_ms_{tag}"] = warm * 1e3
        print(f"flash path: gemma2-2b prefill attention, {cfg.n_layers} "
              f"layers at S {S} in {tag}: {wall * 1e3:.1f} ms wall "
              f"(second pass {warm * 1e3:.1f} ms); launches "
              f"{{{key!r}: {n}}}", flush=True)
        del q, k, v, outs
    return out


# ---------------------------------------------------------------------------
# phase perf: the performance tooling (repro_torch.perf)
# ---------------------------------------------------------------------------

# K1's tuner shapes: yi-6b's w_gate and hymba-1.5b's in_proj at 4 rows,
# int8 codes (k_x = 6)
PERF_MM_SHAPES = (("yi-6b w_gate", 4, 4096, 11008),
                  ("hymba-1.5b in_proj", 4, 1600, 6482))
PERF_BUCKETS = (0, 1 << 20, 4 << 20, 16 << 20)
PERF_BUCKET_STEPS = 8


def perf_tuners(torch, dev, mods):
    """(a) ``tune_mm_cols`` at PERF_MM_SHAPES, each installed plan held
    in K1's tier against the plain version (then removed), and
    ``tune_enc_rows`` with K7, #5 and K6 bitwise at every candidate."""
    from repro_torch.comm import codec as CD
    from repro_torch.perf import autotune as AT
    MM, K = mods["MM"], mods["K"]
    res = {"mm": [], "enc": {}}
    for name, m, k, n in PERF_MM_SHAPES:
        r = AT.tune_mm_cols(m=m, k=k, n=n, k_x=6, iters=20, install=True,
                            device=dev)
        x, codes, scale = AT.k1_operands(m, k, n, 6, dev, seed=3)
        kw = dict(k_x=6, n=n, pack_bits=0, w_dtype="float32",
                  cast_dtype="bfloat16")
        tc0 = MM.launches_tc
        got = MM.dequant_matmul(x, codes, scale, **kw)
        if MM.launches_tc != tc0 + 1:
            raise AssertionError(f"{name}: K1's tensor-core route did not "
                                 "launch")
        want = MM.dequant_matmul(x, codes, scale, backend="torch", **kw)
        unit = k1_noise_unit(torch, MM, x, codes, scale, kw)
        err = (got.float() - want.float()).abs()
        over = (err - bf16_ulp(torch, want.float())).clamp_min(0) / unit
        if not bool((err <= k1_tolerance(torch, want, unit)).all()):
            raise AssertionError(f"{name}: the tuned K1 plan {r['best']} is "
                                 f"outside K1's tier (beyond one ulp "
                                 f"{float(over.max()):.3f} units)")
        MM.set_mm_cols(None, key=r["key"])
        res["mm"].append(dict(
            name=name, m=m, k=k, n=n, best=list(r["best"]),
            default=list(r["default"]),
            ms={f"{t}x{sl}": v * 1e3 for (t, sl), v in
                r["timings_s"].items()},
            best_ms=r["timings_s"][r["best"]] * 1e3,
            default_ms=r["timings_s"][r["default"]] * 1e3,
            max_abs_err=float(err.max()),
            over_ulp_units=float(over.max())))
    r = AT.tune_enc_rows("log:6", numel=1 << 22, iters=10, install=False,
                         device=dev)
    res["enc"] = dict(ms={b: t * 1e3 for b, t in r["timings_s"].items()},
                      best=r["best"])
    # every blocks-an-SM value writes the default's bits
    gen = torch.Generator(device=dev).manual_seed(4)
    cases = []
    for spec in ("log:6", "uniform_amax:7:w8"):
        codec = CD.get_codec(spec)
        for n_rows, numel in ((1, 1000003), (3, 4096 * 37 + 5),
                              (5, 11008 * 7 + 1)):
            x = torch.randn(numel, generator=gen, device=dev)
            cases.append((codec, n_rows, x))

    def outputs():
        out = []
        for codec, n_rows, x in cases:
            payload, scale = K.encode_rows(x, codec, n_rows)          # #5
            e = torch.empty_like(x)
            ef_payload, _ = K.ef_encode_rows(x, scale.reshape(1), codec,
                                             n_rows, out=e)           # K7
            c = -(-x.numel() // n_rows)
            dec = K.decode_rows(payload, scale.reshape(1).expand(
                n_rows).contiguous(), codec, c)                       # K6
            out.append((payload, ef_payload, e, dec))
        return out
    base = outputs()
    for b in AT.CANDIDATE_ROWS:
        K.set_enc_rows(b)
        try:
            got = outputs()
        finally:
            K.set_enc_rows(None)
        for (codec, n_rows, _), g, w in zip(cases, got, base):
            if not all(bits_equal(torch, a, c) for a, c in zip(g, w)):
                raise AssertionError(f"{codec.spec} n_rows={n_rows}: "
                                     f"{b} blocks an SM changed a bit")
    res["enc"]["bitwise_values"] = list(AT.CANDIDATE_ROWS)
    return res


def perf_trace(torch, dev, mods):
    """(b) A ``perf.trace`` of yi-6b cut to 2 layers serving 4 requests
    (its decode step one CUDA graph after the eager warm-up): the trace
    file holds the scopes' names and K1's tensor-core kernel."""
    import shutil
    from repro_torch import perf
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.serve.quantized import quantize_params
    from repro_torch.serve.session import Request, ServeSession
    import numpy as np
    cfg = dataclasses.replace(get_config("yi-6b"), n_layers=2)
    model = Model(cfg)
    qparams = quantize_params(model.init(seed=0, device=dev), k_x=6)
    rng = np.random.default_rng(2)
    reqs = [Request(prompt=[int(t) for t in rng.integers(
        1, cfg.vocab_size, size=32)], max_new_tokens=8) for _ in range(4)]
    sess = ServeSession(model, qparams, slots=4, max_seq=64, paged=True,
                        page_size=16, device=dev)
    out = os.path.join(HERE, "build", "perf_trace")
    shutil.rmtree(out, ignore_errors=True)
    with perf.trace(out) as d:
        with perf.annotate("perf:submit"):
            handles = [sess.submit(r) for r in reqs]
        with perf.annotate("perf:drain"):
            results = sess.drain()
        torch.cuda.synchronize()
    runs = perf.profiling.trace_runs(d)
    path = os.path.join(runs[-1], "trace.json")
    text = open(path).read()
    found = {k: k in text for k in ("perf:submit", "perf:drain",
                                     "k1_tc_kernel")}
    if not all(found.values()):
        raise AssertionError(f"trace {path} lacks {found}")
    tokens = sum(len(results[h].tokens) for h in handles)
    return dict(trace_bytes=os.path.getsize(path), found=found,
                tokens=tokens, stats=dict(sess.stats),
                trace=os.path.relpath(path, HERE))


def _serve_run(env, args):
    """``launch.serve`` in a subprocess: (start-up s, stats, tokens)."""
    import ast
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           "yi-6b", "--smoke", "--quantized", "--paged", "--requests", "2",
           "--max-new", "8"] + args
    t0 = time.perf_counter()
    out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=300, cwd=HERE)
    wall = time.perf_counter() - t0
    if out.returncode:
        raise AssertionError(f"{' '.join(args)}: exit {out.returncode}\n"
                             f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    startup = stats = None
    tokens = []
    for line in out.stdout.splitlines():
        if line.startswith("start-up "):
            startup = float(line.split()[1].rstrip("s"))
        if "stats={" in line:
            stats = ast.literal_eval(line.split("stats=")[1].split("}")[0]
                                     + "}")
        if line.strip().startswith("req"):
            tokens.append(line.split(":", 1)[1].split("[")[1]
                          .split("]")[0])
    return dict(startup_s=startup, wall_s=wall, stats=stats, tokens=tokens)


def perf_warm_start(torch, dev, build):
    """(c) The AOT warm start without the toolkit and the per-object
    build cache."""
    import shutil
    aot_dir = os.path.join(HERE, "build", "perf_aot")
    shutil.rmtree(aot_dir, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    env.pop("REPRO_COMPILE_CACHE", None)
    cold = _serve_run(env, ["--aot-dir", aot_dir])
    if cold["stats"]["aot_saves"] != 1 or cold["stats"]["compilations"]:
        raise AssertionError(f"first start: {cold['stats']} (want one "
                             "save, the library from the build cache)")
    # nvcc out of reach: no PATH entry holds it and CUDA_HOME is an
    # empty directory (so build.nvcc_path's /usr/local/cuda default is
    # not taken either)
    empty = os.path.join(HERE, "build", "perf_no_toolkit")
    os.makedirs(empty, exist_ok=True)
    path = [p for p in env.get("PATH", "").split(os.pathsep)
            if p and not os.path.exists(os.path.join(p, "nvcc"))]
    bare = dict(env, PATH=os.pathsep.join(path), CUDA_HOME=empty)
    import shutil as sh
    if sh.which("nvcc", path=bare["PATH"]) or os.path.exists(
            os.path.join(empty, "bin", "nvcc")):
        raise AssertionError("nvcc is still reachable")
    warm = _serve_run(bare, ["--no-compile-cache", "--aot-dir", aot_dir])
    st = warm["stats"]
    if (st["aot_loads"], st["compilations"]) != (1, 0):
        raise AssertionError(f"warm start without nvcc: {st}")
    if warm["tokens"] != cold["tokens"]:
        raise AssertionError(f"tokens differ: {warm['tokens']} vs "
                             f"{cold['tokens']}")
    # one touched source: one object rebuilt, in a scratch cache seeded
    # with the build's objects
    scratch = Path(HERE) / "build" / "perf_one_object"
    shutil.rmtree(scratch, ignore_errors=True)
    src, cache = scratch / "csrc", scratch / "cache"
    shutil.copytree(build.CSRC, src)
    cache.mkdir(parents=True)
    for o in Path(build.cache_dir()).glob("*.o"):
        shutil.copy2(o, cache / o.name)
    with open(src / "gather_pages.cu", "a") as f:
        f.write("\n// touched\n")
    t0 = time.perf_counter()
    _, compiled, linked, _, _ = build.build_library(cache, csrc=src)
    rebuild_s = time.perf_counter() - t0
    if compiled != ["gather_pages.cu"] or not linked:
        raise AssertionError(f"one touched source rebuilt {compiled} "
                             f"(linked {linked})")
    shutil.rmtree(scratch, ignore_errors=True)
    return dict(cold=cold, warm=warm, rebuilt=compiled,
                rebuild_s=rebuild_s, aot_files=sorted(os.listdir(aot_dir)))


def perf_buckets(torch, dev, mods, group, model, cfg):
    """(d) ``tune_exchange_buckets`` on phase 6's cut, losses and state
    bitwise across sizes; then a ``scan_chunk`` session bitwise between
    0 and 1 MiB buckets."""
    from repro_torch.data.pipeline import batch_for_model
    from repro_torch.dist.step import TrainConfig, make_train_step
    from repro_torch.perf.autotune import tune_exchange_buckets
    from repro_torch.train.session import (SessionConfig, TrainSession,
                                           stage_batch)
    tc = TrainConfig(**DIST_TC)
    batch = stage_batch(next(batch_for_model(cfg, TRAIN_SEQ, TRAIN_BATCH,
                                             seed=0)), dev)
    # two sweeps, the second in the reverse order (a sweep's first
    # candidate meets a cold allocator)
    reps = [tune_exchange_buckets(
        model, group, tc, batch, candidates=order,
        steps=PERF_BUCKET_STEPS, warmup=1, device=dev,
        state_digest=lambda st: [v for _, _, v in _fingerprint(torch, st)])
        for order in (PERF_BUCKETS, PERF_BUCKETS[::-1])]
    rep = reps[0]
    base = rep["losses"][0]
    for r in reps:
        for b in r["losses"]:
            if r["losses"][b] != base or r["digests"][b] != \
                    rep["digests"][0]:
                raise AssertionError(f"bucket {b}: losses {r['losses'][b]} "
                                     f"vs {base}, or the state differs")
    overlap = {}
    for b, ov in rep["overlap"].items():
        if not ov:
            overlap[b] = "one pass after the backward"
            continue
        first = ov["buckets"][0]
        overlap[b] = dict(buckets=len(ov["buckets"]),
                          ran_from_hooks=ov["in_backward"],
                          bytes_overlapped=ov["bytes_overlapped"],
                          bytes_total=ov["bytes_total"],
                          first_bytes=first["bytes"],
                          first_backward_ms_left=round(
                              first["backward_ms_left"], 3),
                          ms_left=[round(r["backward_ms_left"], 3)
                                   for r in ov["buckets"]])
    # inside a CUDA graph: scan_chunk=2, 4 steps (one eager dispatch, one
    # capture + replay), 0 against 1 MiB buckets
    chunked = {}
    for b in (0, 1 << 20):
        art = make_train_step(model, group, dataclasses.replace(
            tc, exchange_bucket_bytes=b))
        sess = TrainSession.from_artifacts(
            art, batch_for_model(cfg, TRAIN_SEQ, TRAIN_BATCH, seed=0),
            SessionConfig(log_every=2, scan_chunk=2, prefetch=0),
            seed=0, device=dev, log=lambda *_: None)
        try:
            sess.run(4)
            losses = [h["loss"] for h in sess.history if "loss" in h]
            chunked[b] = (losses, [v for _, _, v in
                                   _fingerprint(torch, sess.state)],
                          dict(sess.stats))
        finally:
            sess.close()
        del sess, art
        torch.cuda.empty_cache()
    if chunked[0][:2] != chunked[1 << 20][:2]:
        raise AssertionError(f"scan_chunk graphs: buckets 0 and 1 MiB "
                             f"differ: {chunked[0][0]} vs "
                             f"{chunked[1 << 20][0]}")
    ms = {b: [r["timings_s"][b] * 1e3 for r in reps] for b in PERF_BUCKETS}
    steps_ms = {b: [t * 1e3 for r in reps for t in r["step_s"][b]]
                for b in PERF_BUCKETS}
    spread = {b: (min(v), max(v)) for b, v in steps_ms.items()}
    mean = {b: sum(v) / len(v) for b, v in ms.items()}
    best = min(mean, key=mean.get)
    return dict(ms=ms, spread_ms=spread, best=best,
                speedup=mean[tc.exchange_bucket_bytes]
                / mean[best], speedup_vs_one_pass=mean[0] / mean[best],
                buckets=rep["buckets"], losses=base, overlap=overlap,
                chunked_losses=chunked[0][0],
                chunked_stats=chunked[1 << 20][2])


PERF_EXAMPLES = (
    ("quickstart_torch.py", ["--steps", "20", "--chunk", "5"]),
    ("serve_quantized_torch.py", []),
    ("train_lm_distributed_torch.py", ["--steps", "20", "--seq", "64",
                                       "--global-batch", "4",
                                       "--layers", "2"]),
)


def perf_examples():
    """(e) The three examples as subprocesses on the card, all started
    together, each exiting 0."""
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    procs = []
    for name, args in PERF_EXAMPLES:
        procs.append((name, time.perf_counter(), subprocess.Popen(
            [sys.executable, os.path.join(HERE, "examples", name)] + args,
            env=env, cwd=HERE, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    res = {}
    for name, t0, proc in procs:
        try:
            text, _ = proc.communicate(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
        if proc.returncode:
            raise AssertionError(f"{name}: exit {proc.returncode}\n"
                                 f"{text[-3000:]}")
        res[name] = dict(s=time.perf_counter() - t0,
                         last=text.strip().splitlines()[-1][:200])
    return res


def perf_phase(torch, dev, mods, build, model, cfg):
    """Phase perf: (a)-(e) above, each part's seconds."""
    from repro_torch.launch.mesh import close_process_group, make_process_group
    res, secs = {}, {}
    t = time.perf_counter()
    res["tuners"] = perf_tuners(torch, dev, mods)
    secs["a"] = time.perf_counter() - t
    t = time.perf_counter()
    res["trace"] = perf_trace(torch, dev, mods)
    secs["b"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    t = time.perf_counter()
    res["warm_start"] = perf_warm_start(torch, dev, build)
    secs["c"] = time.perf_counter() - t
    t = time.perf_counter()
    group = make_process_group("cuda")
    try:
        res["buckets"] = perf_buckets(torch, dev, mods, group, model, cfg)
    finally:
        close_process_group()
    secs["d"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    t = time.perf_counter()
    res["examples"] = perf_examples()
    secs["e"] = time.perf_counter() - t
    res["seconds"] = secs
    return res


def print_perf(pf, card):
    t = pf["tuners"]
    for r in t["mm"]:
        print(f"perf (a) tune_mm_cols {r['name']} (M {r['m']}, K {r['k']}, "
              f"N {r['n']}, int8): " + ", ".join(
                  f"{k} {v:.4f}" for k, v in r["ms"].items())
              + f" ms (tile_n x slices); k1_plan's {r['default']} "
              f"{r['default_ms']:.4f} ms, tuned {r['best']} "
              f"{r['best_ms']:.4f} ms; max abs err {r['max_abs_err']:.3e} "
              f"vs the plain version, beyond one ulp "
              f"{r['over_ulp_units']:.3f} units (floor {K1_FLOOR:g})",
              flush=True)
    e = t["enc"]
    print(f"perf (a) tune_enc_rows log:6 round trip (#5 + K6, 2^22): "
          + ", ".join(f"{b} {v:.4f}" for b, v in e["ms"].items())
          + f" ms by blocks an SM, best {e['best']}; K7, #5 and K6 "
          f"bitwise at {e['bitwise_values']}", flush=True)
    tr = pf["trace"]
    print(f"perf (b) trace {tr['trace']} ({tr['trace_bytes']} B): "
          f"{tr['found']}; {tr['tokens']} tokens; stats {tr['stats']}",
          flush=True)
    w = pf["warm_start"]
    print(f"perf (c) warm start: first start-up {w['cold']['startup_s']}"
          f" s (wall {w['cold']['wall_s']:.1f} s, stats "
          f"{w['cold']['stats']}); without nvcc {w['warm']['startup_s']} s "
          f"(wall {w['warm']['wall_s']:.1f} s, stats {w['warm']['stats']});"
          f" tokens equal; touched gather_pages.cu: rebuilt {w['rebuilt']} "
          f"in {w['rebuild_s']:.1f} s; card {card}", flush=True)
    b = pf["buckets"]
    print(f"perf (d) exchange buckets (yi-6b x {TRAIN_LAYERS} layers, one "
          f"NCCL rank, {PERF_BUCKET_STEPS} steps each timed by CUDA events, "
          f"a sweep and its reverse; mean / mean, least-most step): "
          + ", ".join(
              f"{k} B {v[0]:.2f} / {v[1]:.2f} ms, {b['spread_ms'][k][0]:.2f}"
              f"-{b['spread_ms'][k][1]:.2f} ({b['buckets'][k]} buckets)"
              for k, v in b["ms"].items())
          + f"; best {b['best']} (the default's time over the best's "
          f"{b['speedup']:.3f}, one pass's over the best's "
          f"{b['speedup_vs_one_pass']:.3f}); losses and "
          f"state bitwise across sizes ({b['losses']}); overlap "
          f"{b['overlap']}; scan_chunk=2 graphs bitwise 0 vs 1 MiB "
          f"(losses {b['chunked_losses']}, stats {b['chunked_stats']})",
          flush=True)
    for name, r in pf["examples"].items():
        print(f"perf (e) {name}: exit 0 in {r['s']:.1f} s: {r['last']}",
              flush=True)
    print("perf seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in pf["seconds"].items()), flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port is measured on a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch import build
    from repro_torch.comm import bits as B
    from repro_torch.comm import kernels as K
    from repro_torch.comm import matmul as MM
    from repro_torch.kernels import adam_ef as A
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import prng
    from repro_torch.serve import paged

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)
    dev = torch.device("cuda")
    card = card_line()
    print(card, flush=True)
    phase_s = {}
    t_start = time.perf_counter()

    def timed(name, fn, *args, **kw):
        """Run one phase and print its seconds."""
        t = time.perf_counter()
        out = fn(*args, **kw)
        phase_s[name] = time.perf_counter() - t
        print(f"phase {name}: {phase_s[name]:.1f} s (total "
              f"{time.perf_counter() - t_start:.1f} s; allocated "
              f"{torch.cuda.memory_allocated()} B)", flush=True)
        return out

    t0 = time.perf_counter()
    planted_build = start_planted_build(build)
    try:
        build.library()
    finally:   # the planted nvcc processes end before anything else
        planted = finish_planted_build(build, planted_build)
    phase_s["2"] = time.perf_counter() - t0
    print(f"build (with the planted-fault library beside it): "
          f"{phase_s['2']:.1f} s", flush=True)
    print_ptxas(build.build_log)

    t3 = time.perf_counter()
    rows = check_quantize(torch, K, dev)
    torch.cuda.empty_cache()
    g_rows, g_table = check_gather(torch, paged, dev)
    rows += g_rows
    mm_rows, mm_table, mm_timed, mm_noise = check_matmul(torch, MM, B, dev)
    torch.cuda.empty_cache()
    mt_rows, mt_table, mt_timed = check_matmul_t(torch, MM, B, dev)
    rows[:0] = mm_rows + mt_rows
    torch.cuda.empty_cache()
    fa_rows, fa_table = check_flash(torch, FA, dev)
    rows += fa_rows
    torch.cuda.empty_cache()
    print(f"kernel checks passed ({len(mm_table)} K1 cases, "
          f"{len(mt_table)} K1t cases, {len(fa_table)} #17 cases)",
          flush=True)
    for t in mt_table:
        extra = "".join(f", {k} {t[k]:.4g}" for k in (
            "f32_noise", "fault_caught", "f32_fault_caught") if k in t)
        print(f"  K1t ({t['route']}) M={t['M']} V={t['V']} d={t['d']} "
              f"{t['codes']}: max abs err {t['max_abs_err']:.4e}, beyond one "
              f"ulp {t['over_ulp_units']:.3f} units (floor {K1_FLOOR:g})"
              f"{extra}", flush=True)
    for t in mt_timed:
        print(f"  K1t ({t['route']}) M={t['M']} V={t['V']} d={t['d']} "
              f"{t['codes']} {t['x_dtype']}: {t['ms']:.4f} ms ({t['gbs']:.0f} "
              f"GB/s, {t['share_of_bound']:.1%} of bound) plain "
              f"{t['plain_ms']:.4f} library {t['library_ms']:.4f} (kernel/"
              f"library {t['factor']:.2f}) bound {t['bound_ms']:.4f} "
              f"({t['bound_by']})", flush=True)
    for t in fa_table:
        fault = (f"; window off by one caught at {t['fault_caught']:.1%}"
                 if "fault_caught" in t else "")
        print(f"  #17 {t['case']} {t['shape']} {t['dtype']} ({t['route']}) "
              f"window {t['window']} softcap {t['softcap']}: max abs err "
              f"{t['max_abs_err']:.3e}; {t['ms']:.4f} ms "
              f"({t['gflops_per_s']:.0f} GFLOP/s) plain {t['plain_ms']:.4f} "
              f"library ({t['library']}) {t['library_ms']:.4f} bound "
              f"{t['bound_ms']:.4f} ({t['bound_by']}){fault}", flush=True)
    for n in mm_noise:
        fault = (f"; one dropped K row: max abs {n['fault_max_abs']:.4e}, "
                 f"caught at {n['fault_caught']:.1%} of outputs"
                 if "fault_max_abs" in n else "")
        if "f32_fault_caught" in n:
            fault += (f"; in float32 at M = 32 caught at "
                      f"{n['f32_fault_caught']:.1%}")
        print(f"  K1 K={n['K']}: max abs err {n['max_abs_err']:.4e}; beyond "
              f"one ulp {n['bf16_over_ulp']:.3f} and f32 summation noise "
              f"{n['f32_noise']:.3f} units of sqrt(K) 2^-24 |x*w|_2 (floor "
              f"{K1_FLOOR:g}){fault}", flush=True)

    t_rows, t_table = check_training_kernels(torch, dev)
    w_rows, w_table, w_cases = check_wire_kernels(torch, dev)
    print(f"wire kernels K7 K6 bitwise against their plain versions "
          f"({w_cases} cases and the w_gate stack)", flush=True)
    for t in w_table:
        print(f"  {t['name']} {t['spec']} {t['input']} {t['shape']}: "
              f"{t['ms']:.4f} ms ({t['gbs']:.0f} GB/s, "
              f"{t['share_of_bound']:.1%} of bound) plain "
              f"{t['plain_ms']:.4f} bound {t['bound_ms']:.4f} "
              f"({t['bound_by']})", flush=True)
    print("training kernels K15 K16 K11 K12, and K3 K4 at the Q_x round "
          "trip's whole-leaf shapes, bitwise against their plain versions",
          flush=True)
    for t in t_table:
        lib = (f" library {t['library_ms']:.4f}" if t["library_ms"]
               is not None else "")
        if "amax_fold_library_ms" in t:
            lib += f" (max-fold alone {t['amax_fold_library_ms']:.4f})"
        print(f"  {t['name']} {t['leaf']} {t['shape']}: {t['ms']:.4f} ms "
              f"plain {t['plain_ms']:.4f}{lib} bound {t['bound_ms']:.4f} "
              f"({t['bound_by']})", flush=True)

    e_rows, e_table, e_cases = check_encode_kernels(torch, dev)
    print(f"baseline kernels #5 (log, uniform, ternary), K6 ternary, #14, #8 "
          f"bitwise against their plain versions ({e_cases} cases and the "
          f"w_gate stack)", flush=True)
    for t in e_table:
        lib = (f" (amax launch's yardstick x.abs().amax() "
               f"{t['amax_library_ms']:.4f})" if "amax_library_ms" in t
               else "")
        print(f"  {t['name']} {t['spec']} {t['shape']}: {t['ms']:.4f} ms "
              f"({t['gbs']:.0f} GB/s, {t['share_of_bound']:.1%} of bound) "
              f"plain {t['plain_ms']:.4f} bound {t['bound_ms']:.4f} "
              f"({t['bound_by']}){lib}", flush=True)

    dl_rows, dl_table = check_deep_lanes(torch, dev)
    print(f"the adaptive plan's lanes: K7, K6 ({', '.join(DEEP_SPECS)}), "
          f"#10, K11 ({', '.join(DEEP_LOG)}), #5 "
          f"({', '.join(ENCODE_WIDTH_SPECS)}), K7 "
          f"({', '.join(K7_READING_SPECS)}) bitwise against their plain "
          f"versions at the w_gate stack", flush=True)
    for t in dl_table:
        launch = (f"; K3 alone {t['amax_ms']:.4f}, the encode launch "
                  f"{t['encode_launch_ms']:.4f} (its bound "
                  f"{t['encode_launch_bound_ms']:.4f})" if "amax_ms" in t
                  else "")
        print(f"  {t['name']} {t['spec']} {t['shape']}: {t['ms']:.4f} ms "
              f"({t['gbs']:.0f} GB/s, {t['share_of_bound']:.1%} of bound) "
              f"plain {t['plain_ms']:.4f} bound {t['bound_ms']:.4f} "
              f"({t['bound_by']}){launch}", flush=True)

    s_rows, s_table, s_cases, s_faults = check_slice6_kernels(
        torch, dev, build, planted)
    print(f"#10 log quantize, #13 ternary quantize and #9 lane pack/unpack "
          f"bitwise against their plain versions ({s_cases} cases and the "
          f"w_gate stack); planted faults caught: lane bias off by one at "
          f"{s_faults['pack_bias_off_by_one']:.1%} of payload bytes, u <= p "
          f"at {s_faults['ternary_u_le_p']:.2%} of codes, K7's 6-bit code "
          f"off by one at {s_faults['k7_6bit_last_vector']:.3%} of payload "
          f"bytes ({s_faults['k7_6bit_last_vector_3_rows']:.3%} at 3 rows)",
          flush=True)
    for t in s_table:
        if "ms" in t:
            print(f"  {t['name']} {t['spec']} {t['shape']}: {t['ms']:.4f} ms "
                  f"({t['gbs']:.0f} GB/s) plain {t['plain_ms']:.4f} bound "
                  f"{t['bound_ms']:.4f} ({t['bound_by']}) library none",
                  flush=True)
        else:
            print(f"  {t['name']} {t['spec']} {t['shape']}: pack "
                  f"{t['pack_ms']:.4f} ms, unpack {t['unpack_ms']:.4f} ms, "
                  f"pack plain {t['pack_plain_ms']:.4f}, bound each way "
                  f"{t['bound_ms']:.4f} (bytes)", flush=True)

    tf_rows = check_threefry(torch, dev, train_leaves(torch))
    tu, tk = tf_rows
    print(f"threefry (the reference's draws; no Pallas kernel): uniforms and "
          f"both key chains bitwise against their plain versions; uniforms "
          f"at {tu['shape'][0]} elements {tu['ms']:.4f} ms "
          f"({tu['bound_ms'] / tu['ms']:.1%} of its {tu['bound_ms']:.4f} ms "
          f"bound, {tu['bound_by']}) plain {tu['plain_ms']:.4f} torch.rand "
          f"(Philox, not the same function) {tu['library_ms']:.4f}; keys at "
          f"{tk['shape'][0]} leaves: distributed chain {tk['ms']:.4f} ms "
          f"(plain {tk['plain_ms']:.4f}), Algorithm 1's {tk['alg1_ms']:.4f} "
          f"(plain {tk['alg1_plain_ms']:.4f}), bound {tk['bound_ms']:.6f}",
          flush=True)
    pd_rows = check_prng_draws(torch, dev)
    tn, tc_ = pd_rows
    print(f"threefry draws of Model.init and of sampling (no Pallas kernel: "
          f"XLA's truncated_normal and categorical): trunc normal at "
          f"{tn['shape']} bitwise its plain version on slabs (and a "
          f"32-layer wq stack, the embedding under one key), "
          f"{tn['ms']:.4f} ms ({tn['bound_ms'] / tn['ms']:.1%} of its "
          f"{tn['bound_ms']:.4f} ms bound, {tn['bound_by']}) plain "
          f"{tn['plain_ms']:.4f} trunc_normal_ (Philox, not the same "
          f"function) {tn['library_ms']:.4f}; categorical bitwise its plain "
          f"step over {CATEGORICAL_STEPS} steps:", flush=True)
    for t in tc_["shapes"]:
        print(f"  categorical {t['shape']}: {t['ms']:.4f} ms (graphed; "
              f"{t['bound_ms'] / t['ms']:.1%} of its {t['bound_ms']:.4f} ms "
              f"bound, {t['bound_by']}) plain {t['plain_ms']:.4f} "
              f"argmax(logits / t - log(-log(rand))) {t['library_ms']:.4f}",
              flush=True)
    tf_rows += pd_rows
    torch.cuda.empty_cache()
    moe_table = check_moe_shapes(torch, dev, MM)
    print("the MoE family's shapes: K12 on a code-resident deepseek-moe-16b "
          "expert stack (a sliced layer's codes a view, bitwise its plain "
          "version), K1 at the routers' shapes (one bf16 ulp plus the floor)",
          flush=True)
    for t in moe_table:
        lib = (f" library {t['library_ms']:.4f}" if t["library_ms"]
               is not None else "")
        print(f"  {t['name']} ({t['what']}) {t['shape']}: {t['ms']:.4f} ms "
              f"plain {t['plain_ms']:.4f}{lib} bound {t['bound_ms']:.4f} "
              f"({t['bound_by']}, {t['bound_ms'] / t['ms']:.1%})",
              flush=True)
    torch.cuda.empty_cache()
    ssm_table = check_ssm_shapes(torch, dev, MM, B, K)
    print_shape_rows(
        "the SSM family's shapes: K1 (tensor cores, M = 4) at mamba2's and "
        "hymba's in_proj/out_proj in int8 and 3/4/6-bit lanes (#9's round "
        "trip bitwise on the ragged 6,482), K1t over the 50,280- and "
        "32,001-row tied heads, within one bf16 ulp plus the floor",
        ssm_table)
    encdec_table = check_encdec_shapes(torch, dev, MM, B, K, FA)
    print_shape_rows(
        "the encoder-decoder family's shapes: K1 (tensor cores, int8) at "
        "whisper-small's projections for M = 4 (decode) and M = 1500, 6000 "
        "(encoder, cross K/V fill), K1t over its (51865, 768) tied head, "
        "within one bf16 ulp plus the floor; #17 bidirectional at the "
        "encoder's (4, 1500, 1500, 12/12, 64) in bf16 beside SDPA",
        encdec_table)

    phase_s["3"] = time.perf_counter() - t3
    print(f"phase 3: {phase_s['3']:.1f} s", flush=True)

    mods = {"K": K, "A": A, "P": prng}
    smods = {"MM": MM, "paged": paged, "K": K}
    res = timed("4", serve, torch, dev, smods, sampled=True)
    torch.cuda.empty_cache()
    gem = timed("4b", serve, torch, dev, smods, arch="gemma2-2b",
                max_seq=GEMMA_MAX_SEQ, long_plen=GEMMA_LONG_PROMPT)
    torch.cuda.empty_cache()
    g3 = timed("4g", serve, torch, dev, smods, arch="gemma3-4b",
               max_seq=GEMMA3_MAX_SEQ, long_plen=GEMMA3_LONG_PROMPT)
    torch.cuda.empty_cache()
    qw = timed("4h", serve, torch, dev, smods, arch="qwen2.5-14b")
    torch.cuda.empty_cache()
    fp = timed("4c", flash_path, torch, dev, FA)
    torch.cuda.empty_cache()
    pk = timed("4d", serve_packed, torch, dev, smods)
    torch.cuda.empty_cache()
    pf = timed("4e", serve_packed, torch, dev, smods, dtype="float32")
    torch.cuda.empty_cache()
    pg = timed("4f", serve_packed, torch, dev, smods, arch="gemma2-2b",
               dtype="float32")
    torch.cuda.empty_cache()
    ad = timed("4i", serve_admission, torch, dev, smods)
    torch.cuda.empty_cache()
    ds16 = timed("4j", serve_moe, torch, dev, smods, "deepseek-moe-16b")
    torch.cuda.empty_cache()
    mav = timed("4k", serve_moe, torch, dev, smods,
                "llama4-maverick-400b-a17b", layers=MAVERICK_LAYERS,
                experts=MAVERICK_EXPERTS)
    torch.cuda.empty_cache()
    m2 = timed("4l", serve_ssm, torch, dev, smods, "mamba2-2.7b")
    torch.cuda.empty_cache()
    hy = timed("4m", serve_ssm, torch, dev, smods, "hymba-1.5b")
    torch.cuda.empty_cache()
    wh = timed("4n", serve_encdec, torch, dev, smods)
    torch.cuda.empty_cache()
    tr = timed("5", train, torch, dev, mods)
    bl = timed("5b", alg1_baselines, torch, dev, mods)
    gt = timed("5c", graph_train, torch, dev, mods)
    print(f"phase 5c: scan_chunk={gt['chunk']} over {gt['steps']} steps: "
          f"bitwise step by step {gt['bitwise']} (loss rel "
          f"{gt['loss_rel']:.3e}, parameters rel L2 "
          f"{gt['param_rel_l2']:.3e}); stats {gt['stats']}", flush=True)
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import close_process_group, make_process_group
    from repro_torch.models.model import Model
    cfg8 = dataclasses.replace(get_config("yi-6b"), n_layers=TRAIN_LAYERS)
    model8 = Model(cfg8)
    group = make_process_group("cuda")    # one NCCL rank, a local store
    try:
        ds = timed("6", dist_train, torch, dev, mods, group, model8, cfg8)
        cfg_cut = dataclasses.replace(cfg8, n_layers=CUT_LAYERS)
        model_cut = Model(cfg_cut)
        md = timed("7", modes_train, torch, dev, mods, group, model_cut,
                   cfg_cut)
        torch.cuda.empty_cache()
        cfg_ck = dataclasses.replace(cfg8, n_layers=CKPT_LAYERS)
        ck = timed("6b", ckpt_resume, torch, dev, mods, group,
                   Model(cfg_ck), cfg_ck)
        lv = timed("6c", llava_train, torch, dev, mods, group)
        a6 = timed("6d", adaptive_train, torch, dev, mods, group, model_cut,
                   cfg_cut)
        torch.cuda.empty_cache()
        h6 = timed("6e", hier_train, torch, dev, mods)
        f6 = timed("6f", moe_train, torch, dev, mods, group)
        torch.cuda.empty_cache()
        g6 = timed("6g", ssm_train, torch, dev, mods, group)
        torch.cuda.empty_cache()
        w6 = timed("6h", encdec_train, torch, dev, mods, group)
        torch.cuda.empty_cache()
        so = timed("4o", serve_mesh, torch, dev, smods)
        torch.cuda.empty_cache()
    finally:
        close_process_group()
    mh = timed("6i", multihost_train, torch, dev, mods)
    print(f"multi-host flags (6i, yi-6b x {mh['layers']} layers, "
          f"--multihost --coordinator 127.0.0.1:{mh['port']} "
          f"--num-processes 1 --process-id 0): one step bitwise the flat "
          f"one-rank run (loss {mh['losses']} vs {mh['flat_losses']}, "
          f"state bitwise)", flush=True)
    wb = timed("8", wire_buffers, torch, dev, mods, model8)
    print(f"wire buffers: {wb['leaves']} leaves x {len(WIRE_SPECS)} codecs "
          f"through Codec.encode/decode, bitwise the plain versions; bytes "
          f"{wb['bytes']}; launches {wb['launches']}", flush=True)
    torch.cuda.empty_cache()
    pp = timed("9", paper_protocol, torch, dev, mods)
    parity = pp.pop("parity")
    pa = pp.pop("adaptive")
    print(f"paper protocol: every method's kernels bitwise their plain "
          f"versions at the MLP's shapes over {PARITY_STEPS} steps "
          f"(tensors compared: {parity})", flush=True)
    for mode, r in pp.items():
        print(f"paper protocol ({mode}, {r['steps']} steps, {r['workers']} "
              f"workers, seed 0) in {r['run_s']:.1f} s; launches "
              f"{r['launches']}; test accuracy:", flush=True)
        for name, acc, _ in r["rows"]:
            print(f"  {name:28s} {acc * 100:.2f} %", flush=True)
    print(f"paper protocol --adaptive ({pa['steps']} steps, replan every "
          f"{pa['replan_every']}, seed 0, 8 workers) in {pa['run_s']:.1f} s: "
          f"arms {pa['arms']}; adaptive/fixed bytes "
          f"{pa['summary']['bytes_ratio']:.4f}, loss parity "
          f"{pa['summary']['loss_parity']:.4f}; deep fixed lanes "
          f"{pa['deep']}; launches {pa['launches']}", flush=True)
    for e in pa["plan_log"]:
        print(f"  plan @{e['step']}: {e['plan']} "
              f"({e['bytes_per_step']} B/step)", flush=True)
    perf_res = timed("perf", perf_phase, torch, dev, dict(mods, MM=MM),
                     build, model8, cfg8)
    print_perf(perf_res, card)
    rows += t_rows + w_rows + dl_rows + e_rows + s_rows + tf_rows
    for r in rows:
        by_path = {"serve": res["launches"].get(r["name"], 0),
                   "serve_gemma2": gem["launches"].get(r["name"], 0),
                   "serve_gemma3": g3["launches"].get(r["name"], 0),
                   "serve_qwen": qw["launches"].get(r["name"], 0),
                   "serve_admission": ad["launches"].get(r["name"], 0),
                   "serve_deepseek": ds16["launches"].get(r["name"], 0),
                   "serve_maverick": mav["launches"].get(r["name"], 0),
                   "train_moe": f6["launches"].get(r["name"], 0),
                   "serve_mamba2": m2["launches"].get(r["name"], 0),
                   "serve_hymba": hy["launches"].get(r["name"], 0),
                   "train_ssm": g6["launches"].get(r["name"], 0),
                   "serve_whisper": wh["launches"].get(r["name"], 0),
                   "serve_mesh": so["launches"].get(r["name"], 0),
                   "train_whisper": w6["launches"].get(r["name"], 0),
                   "train_llava": lv["launches"].get(r["name"], 0),
                   "flash": fp["launches_bf16"].get(r["name"], 0),
                   "flash_f32": fp["launches_f32"].get(r["name"], 0),
                   "serve_packed": pk["launches"].get(r["name"], 0),
                   "serve_f32": pf["launches"].get(r["name"], 0),
                   "serve_gemma2_f32": pg["launches"].get(r["name"], 0),
                   "train": tr["launches"].get(r["name"], 0),
                   "train_graph": gt["launches"].get(r["name"], 0),
                   "dist": ds["launches"].get(r["name"], 0),
                   "dist_ckpt": ck["launches"].get(r["name"], 0),
                   "adaptive": a6["launches"].get(r["name"], 0),
                   "adaptive_fixed_plan": a6["fixed_launches"].get(
                       r["name"], 0)}
        by_path.update({f"alg1_{m}": bl[m]["launches"].get(r["name"], 0)
                        for m in ALG1_BASELINES})
        by_path["wquan"] = bl["wquan"]["launches"].get(r["name"], 0)
        by_path["alg1_terngrad_sgd_graph"] = bl["terngrad_sgd"]["graph"][
            "launches"].get(r["name"], 0)
        by_path["terngrad_graph"] = md["terngrad"]["graph"][
            "launches"].get(r["name"], 0)
        by_path.update({m: md[m]["launches"].get(r["name"], 0)
                        for m in MODE_RUNS})
        by_path["wire"] = wb["launches"].get(r["name"], 0)
        by_path["hier_1x1"] = h6["launches"].get(r["name"], 0)
        by_path["int8_gather"] = h6["gather"]["launches"].get(r["name"], 0)
        by_path.update({f"paper_{m}": pp[m]["launches"].get(r["name"], 0)
                        for m in pp})
        by_path["paper_adaptive"] = pa["launches"].get(r["name"], 0)
        r["launches"] = sum(by_path.values())
        r["launches_by_path"] = by_path
    idle = [r["name"] for r in rows if r["launches"] == 0]
    if idle:
        raise AssertionError(f"kernels no main path launched: {idle}")
    for sv in (res, gem, g3, qw):
        print(f"{sv['arch']} ({sv['layers']} layers): served {sv['tokens']} "
              f"tokens in "
              f"{sv['serve_s']:.3f} s ({sv['tok_per_s']:.2f} tok/s); decode "
              f"step {sv['decode_step_ms']:.3f} ms, chunk "
              f"{sv['chunk_ms']:.3f} ms (device {sv['chunk_device_ms']:.3f} "
              f"ms); resident {sv['resident_bytes']} B vs "
              f"fp32 {sv['fp32_bytes']} B; peak {sv['peak_bytes']} B "
              f"(start-up {sv['peak_startup_bytes']} B); logits rel L2 "
              f"{sv['logits_rel_l2']:.3e}, argmax agreement "
              f"{sv['argmax_agreement']:.3f}; launches {sv['launches']}; "
              f"stats {sv['stats']}", flush=True)
        busy = sv["decode_step_device_ms"] / sv["decode_step_ms"]
        print(f"{sv['arch']} decode step: {sv['decode_step_device_ms']:.3f} ms "
              f"of device work in {sv['decode_step_ms']:.3f} ms (device idle "
              f"{1 - busy:.1%}), {sv['decode_step_device_ops']:.0f} device "
              f"operations a step (chunk: {sv['chunk_device_ops']:.0f}); by "
              f"kernel:", flush=True)
        for name, t in sv["decode_step_kernels"]:
            print(f"  {t:9.4f} ms  {name[:90]}")
    for t in mm_timed:
        floor = (f"; fp32 FMA floor {t['floor_fp32_cores_ms']:.4f} "
                 f"({t['share_of_fp32_floor']:.1%} of the larger floor)"
                 if "floor_fp32_cores_ms" in t else "")
        print(f"  K1 ({t['route']}) M={t['M']} K={t['K']} N={t['N']} "
              f"{t['codes']} {t['x_dtype']}: {t['ms']:.4f} ms ({t['gbs']:.0f} "
              f"GB/s, {t['share_of_bound']:.1%} of bound) plain "
              f"{t['plain_ms']:.4f} library {t['library_ms']:.4f} (kernel/"
              f"library {t['factor']:.2f}) bound {t['bound_ms']:.4f} eager "
              f"call {t['eager_ms']:.4f}{floor}")
    tf = mm_rows[2]
    print(f"  K1 (fma, float32) worst kernel/library factor "
          f"{tf['worst_factor']:.2f} at M, K, N = {tf['worst_shape']}; M = 4 "
          f"(4096, 11008) {tf['ms']:.4f} ms, M = 32 {tf['m32_ms']:.4f} ms "
          f"(library {tf['m32_library_ms']:.4f}, fp32 FMA floor "
          f"{tf['m32_floor_fp32_cores_ms']:.4f})")
    tp = mm_rows[1]
    print(f"  K1 (tc, packed lanes) worst kernel/library factor "
          f"{tp['worst_factor']:.2f} at {tp['worst_shape']}; 4-bit M = 4 "
          f"{tp['ms']:.4f} ms ({tp['bound_ms'] / tp['ms']:.1%} of its "
          f"{tp['bound_ms']:.4f} ms bound), library {tp['library_ms']:.4f}")
    for t in g_table:
        lib = (f"index_select {t['library_ms']:.4f}" if "library_ms" in t
               else f"two index_select {t['two_index_select_ms']:.4f}")
        print(f"  K2 {t['name']} at the {t['table']} table {t['shape']}: "
              f"graph {t['ms']:.4f} ms ({t['share_of_bound']:.1%} of its "
              f"{t['bound_ms']:.4f} ms bound) plain {t['plain_ms']:.4f} "
              f"{lib}; eager call {t['eager_ms']:.4f}")
    tc = mm_rows[0]
    print(f"  K1 (tc) worst kernel/library factor {tc['worst_factor']:.2f} at "
          f"M, K, N = {tc['worst_shape']}; M = 32 (4096, 11008) "
          f"{tc['m32_ms']:.4f} ms, library {tc['m32_library_ms']:.4f}")
    ft = fa_rows[0]
    print(f"  #17 (tc) gemma2 global: {ft['softcap_ms']:.4f} ms with the "
          f"softcap (masked SDPA without it {ft['masked_library_ms']:.4f}), "
          f"{ft['ms']:.4f} ms without (SDPA is_causal "
          f"{ft['library_ms']:.4f}); local {ft['local_ms']:.4f} ms")
    f3 = fa_rows[1]
    print(f"  #17 (tc32, 3xTF32) gemma2 global without the softcap: "
          f"{f3['ms']:.4f} ms ({f3['tf32_tflops']:.1f} TFLOP/s of TF32 MMA "
          f"work), SDPA is_causal in float32 {f3['library_ms']:.4f}; floors "
          f"3xTF32 {f3['floor_3xtf32_ms']:.4f}, fp32 CUDA cores "
          f"{f3['floor_fp32_cores_ms']:.4f}; with the softcap "
          f"{f3['softcap_ms']:.4f}, local {f3['local_ms']:.4f} ms")
    t1 = mt_rows[0]
    t2 = mt_rows[1]
    print(f"  K1t (fma, float32) gemma2 head int8 M = 4 {t2['ms']:.4f} ms "
          f"({t2['bound_ms'] / t2['ms']:.1%} of its {t2['bound_ms']:.4f} ms "
          f"bound), M = 1 {t2['m1_ms']:.4f}, M = 8 {t2['m8_ms']:.4f}, "
          f"library {t2['library_ms']:.4f}; 4-bit M = 4 {t2['p4_ms']:.4f} "
          f"({t2['p4_bound_ms'] / t2['p4_ms']:.1%} of its bound)")
    print(f"  K1t (tc) gemma2 head int8 M = 4 {t1['ms']:.4f} ms "
          f"({t1['bound_ms'] / t1['ms']:.1%} of its {t1['bound_ms']:.4f} ms "
          f"bound), M = 1 {t1['m1_ms']:.4f}, library {t1['library_ms']:.4f}; "
          f"4-bit M = 4 {t1['p4_ms']:.4f} (library "
          f"{t1['p4_library_ms']:.4f}); worst kernel/library factor "
          f"{t1['worst_factor']:.2f} at {t1['worst_case']}")

    print(f"trained yi-6b x {TRAIN_LAYERS} layers ({tr['n_params']} "
          f"parameters): losses {', '.join(f'{x:.4f}' for x in tr['losses'])}"
          f"; {TRAIN_STEPS} steps in {tr['run_s']:.3f} s; stats "
          f"{tr['stats']}; sync-debug warnings {tr['sync_warnings']} "
          f"(at step starts {tr['syncs_at_step_starts']}, by harvest "
          f"{tr['syncs_by_harvest']}); launches {tr['launches']}", flush=True)
    print(f"train step: wall {tr['step_wall_ms']:.3f} ms, device "
          f"{tr['step_device_ms']:.3f} ms (device idle "
          f"{tr['device_idle']:.1%}), {tr['tokens_per_s']:.1f} tok/s; update "
          f"kernels K15+K16+K11 {tr['update_kernels_ms']:.3f} ms, Q_x "
          f"kernels K3+K4+K12 {tr['qx_kernels_ms']:.3f} ms "
          f"({(tr['update_kernels_ms'] + tr['qx_kernels_ms']) / tr['step_device_ms']:.1%}"
          f" of device time); peak {tr['peak_bytes']} B; state "
          f"{tr['state_bytes']} B; by kernel:", flush=True)
    for name, t in tr["step_kernels"]:
        print(f"  {t:9.4f} ms  {name[:90]}")
    print("train step phases (CUDA events): " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in tr["phases_ms"].items()), flush=True)
    for name in ALG1_BASELINES:
        b = bl[name]
        print(f"{name} (alpha {b['alpha']:g}): losses "
              f"{', '.join(f'{x:.4f}' for x in b['losses'])}; wall "
              f"{b['step_wall_ms']:.3f} ms, device {b['step_device_ms']:.3f} "
              f"ms (idle {b['device_idle']:.1%}), {b['tokens_per_s']:.1f} "
              f"tok/s; quantizer kernels {b['quantizer_kernels_ms']:.3f} ms; "
              f"phases " + ", ".join(f"{k} {v:.3f}" for k, v in
                                    b["phases_ms"].items())
              + f" ms; peak {b['peak_bytes']} B; launches {b['launches']}; "
              f"stats {b['stats']}; captured-gradient update bitwise",
              flush=True)
        for kname, t in b["step_kernels"][:6]:
            print(f"  {t:9.4f} ms  {kname[:90]}")
    print_terngrad_graph(f"terngrad_sgd (yi-6b x {CUT_LAYERS} layers)",
                         bl["terngrad_sgd"]["graph"])
    wq = bl["wquan"]
    print(f"wquan(k_x=7, amax) of the trained parameters: {wq['ms']:.3f} ms; "
          f"launches {wq['launches']}; rel L2 to the trained weights "
          f"{wq['rel_l2_to_trained']:.3e}; bitwise the plain versions",
          flush=True)

    print(f"distributed (Algorithms 2+3, {ds['world_size']} "
          f"{ds['backend']} rank): losses "
          f"{', '.join(f'{x:.4f}' for x in ds['losses'])}; {TRAIN_STEPS} "
          f"steps in {ds['run_s']:.3f} s; stats {ds['stats']}; sync-debug "
          f"warnings {ds['sync_warnings']} (at step starts "
          f"{ds['syncs_at_step_starts']}, by harvest "
          f"{ds['syncs_by_harvest']}); launches {ds['launches']} (K3 "
          f"{ds['amax_launches']})", flush=True)
    c = ds["comm"]
    print(f"dist step: wall {ds['step_wall_ms']:.3f} ms, device "
          f"{ds['step_device_ms']:.3f} ms (device idle "
          f"{ds['device_idle']:.1%}), {ds['tokens_per_s']:.1f} tok/s; "
          f"phases " + ", ".join(f"{k} {v:.3f} ms" for k, v in
                                 ds["phases_ms"].items())
          + f"; wire kernels ms/step {ds['wire_kernels_ms']}; K15 "
          f"{ds['update_kernel_ms']:.3f} ms; peak {ds['peak_bytes']} B; "
          f"state {ds['state_bytes']} B ({ds['n_params']} parameters); "
          f"comm/step exchange {c['update_exchange_bytes']} B broadcast "
          f"{c['weight_broadcast_bytes']} B (moved {ds['moved_bytes']}); "
          f"the broadcast residual K7 writes and the step drops: "
          f"{4 * ds['n_params']} B; by kernel:", flush=True)
    for name, t in ds["step_kernels"]:
        print(f"  {t:9.4f} ms  {name[:90]}")
    eq = ds["equivalence"]
    print(f"Alg 2+3 at one worker vs Algorithm 1 ({eq['steps']} steps, Q_x "
          f"from {eq['min_numel']} elements): bitwise {eq['bitwise']}; "
          f"losses {eq['dist_losses']} vs {eq['alg1_losses']} (rel "
          f"{eq['loss_rel']:.3e}), parameters rel L2 "
          f"{eq['param_rel_l2']:.3e}; nondeterministic operations "
          f"{eq['nondeterministic']}; captured-gradient update bitwise "
          f"(kernels, plain versions, Algorithm 1)", flush=True)

    print(f"Algorithm 1 with scan_chunk={gt['chunk']} (one CUDA graph a "
          f"chunk after an eager one): losses "
          f"{', '.join(f'{x:.4f}' for x in gt['losses'])} (step by step "
          f"{', '.join(f'{x:.4f}' for x in gt['per_step_losses'])}); bitwise "
          f"{gt['bitwise']}, loss rel {gt['loss_rel']:.3e}, parameters rel "
          f"L2 {gt['param_rel_l2']:.3e}; nondeterministic operations "
          f"{gt['nondeterministic']}; {gt['steps']} steps in "
          f"{gt['run_s']:.3f} s (step by step {gt['per_step_run_s']:.3f} "
          f"s); stats {gt['stats']}; launches {gt['launches']}", flush=True)
    print(f"graph train step: wall {gt['step_wall_ms']:.3f} ms, device "
          f"{gt['step_device_ms']:.3f} ms (device idle "
          f"{gt['device_idle']:.1%}), {gt['tokens_per_s']:.1f} tok/s "
          f"(phase 5: wall {tr['step_wall_ms']:.3f}, device "
          f"{tr['step_device_ms']:.3f}, idle {tr['device_idle']:.1%}); "
          f"peak {gt['peak_less_reference_bytes']} B beside the step-by-step "
          f"run's parameters ({gt['peak_bytes']} B with them; phase 5: "
          f"{tr['peak_bytes']} B); "
          f"by kernel:", flush=True)
    for name, t in gt["step_kernels"]:
        print(f"  {t:9.4f} ms  {name[:90]}")
    print(f"distributed checkpoints (yi-6b x {CKPT_LAYERS} layers, one "
          f"NCCL rank, {CKPT_STEPS} steps): state {ck['state_bytes']} B "
          f"(largest leaf {ck['largest_leaf_bytes']} B); resumed from step "
          f"{ck['resumed_from']} bitwise the unbroken run (losses "
          f"{', '.join(f'{x:.4f}' for x in ck['losses'])}); wrote "
          f"{ck['bytes_written']} B in {ck['save_s']:.2f} s (checkpoint() "
          f"returned in {ck['checkpoint_call_s'] * 1e3:.1f} ms), restored in "
          f"{ck['restore_s']:.2f} s adding {ck['restore_added_bytes']} B on "
          f"the device; {CKPT_CODEC} moments: "
          f"{ck['codec_bytes_written']} B in {ck['codec_save_s']:.2f} s, "
          f"restored in {ck['codec_restore_s']:.2f} s adding "
          f"{ck['codec_restore_added_bytes']} B, the plain round trip "
          f"bitwise, launches {ck['launches']}; scan_chunk={GRAPH_CHUNK} "
          f"bitwise step by step, stats {ck['chunk_stats']}; free disk "
          f"{ck['free_disk_bytes']} B", flush=True)

    print(f"adaptive (6d, yi-6b x {CUT_LAYERS} layers, one NCCL rank): "
          f"fixed plan {ADAPT_FIXED_STEPS} steps bitwise its plain run "
          f"(losses {', '.join(f'{x:.4f}' for x in a6['fixed_losses'])}), "
          f"accounting exact ({a6['fixed_accounting']['measured']} B); "
          f"bit_plan=None bitwise qadam ({a6['no_plan_vs_qadam']['steps']} "
          f"steps); controller {ADAPT_STEPS} steps, replan every "
          f"{ADAPT_EVERY}, scan_chunk {ADAPT_CHUNK}, budget {ADAPT_BUDGET}: "
          f"{a6['replans']} replans in {a6['run_s']:.2f} s, swaps "
          f"{a6['swaps']}, captures {a6['capture_s']} s; losses "
          f"{', '.join(f'{x:.4f}' for x in a6['losses'])}; stats "
          f"{a6['stats']}; peak {a6['peak_bytes']} B; launches "
          f"{a6['launches']}", flush=True)
    for p, q in zip(a6["plans"], a6["per_plan"]):
        print(f"  plan @{p['step']}: exchange {p['exchange_bytes']} B/step "
              f"({p['vs_log6']:.4f} of log:6's "
              f"{a6['fixed_log6_bytes']}); step wall "
              f"{q['step_wall_ms']:.3f} ms, device {q['step_device_ms']:.3f} "
              f"ms (idle {q['device_idle']:.1%}); revisited: capture "
              f"{q['revisit_capture_s']} s, first dispatch "
              f"{q['revisit_first_dispatch_s']:.2f} s; wire kernels "
              f"{q['wire_kernels_ms']}; lanes "
              f"{_plan_counts(p['bit_plan'])}", flush=True)

    g6 = h6["gather"]
    print(f"hierarchical (6e, yi-6b x {h6['layers']} layers, one NCCL rank, "
          f"launch.train main): --topology 1x1 {h6['steps']} steps bitwise "
          f"the flat run {h6['bitwise']} (losses "
          f"{', '.join(f'{x:.4f}' for x in h6['losses'])}); launches "
          f"{h6['launches']}; per-tier bytes a step: inter "
          f"{h6['tiers']['inter']} (flat wire total "
          f"{h6['flat_comm']['total_bytes']}), intra {h6['tiers']['intra']}"
          f"; step device ms: 1x1 {h6['step_device_ms']:.3f}, flat "
          f"{h6['flat_step_device_ms']:.3f}, --model-gather-quant 8 "
          f"{h6['mgq_step_device_ms']:.3f} (losses "
          f"{', '.join(f'{x:.4f}' for x in h6['mgq_losses'])}); phase 6 "
          f"at {TRAIN_LAYERS} layers {ds['step_device_ms']:.3f}; "
          f"allocated on the card at its start "
          f"{h6['allocated_at_start']} B; int8 "
          f"gather {g6['shape']} at one shard bitwise its plain version: "
          f"{g6['ms']:.4f} ms, plain {g6['plain_ms']:.4f}, bound "
          f"{g6['bound_ms']:.4f} (bytes), launches {g6['launches']}",
          flush=True)
    for name, t in h6["step_kernels"]:
        print(f"  {t:9.4f} ms  {name[:90]}")

    for sv in (ds16, mav):
        dg = sv["decode_graph"]
        print(f"{sv['arch']} ({sv['layers']} layers, {sv['experts']} "
              f"experts): served {sv['tokens']} tokens in "
              f"{sv['serve_s']:.3f} s ({sv['tok_per_s']:.2f} tok/s); "
              f"resident {sv['resident_bytes']} B vs fp32 "
              f"{sv['fp32_bytes']} B; start-up peak "
              f"{sv['peak_startup_bytes']} B (quantized in "
              f"{sv['startup_s']:.1f} s), peak {sv['peak_bytes']} B; "
              f"decode step eager {dg['eager_ms']:.3f} ms wall / "
              f"{dg['eager_device_ms']:.3f} device, graphed "
              f"{dg['graph_ms']:.3f} / {dg['graph_device_ms']:.3f} (idle "
              f"{dg['graph_idle']:.1%}); chunk {sv['chunk_ms']:.3f} ms wall "
              f"/ {sv['chunk_device_ms']:.3f} device; launches "
              f"{sv['launches']}; stats {sv['stats']}", flush=True)
    dg = so["decode_graph"]
    print(f"sharded serving (4o, dist.serve at Nm = 1, one NCCL rank): "
          f"{so['arch']} ({so['layers']} layers, {so['fp32_bytes']} B of "
          f"float32 shard), ServeConfig(weight_k={so['weight_k']}), "
          f"{so['slots']} slots x {so['max_seq']}: mesh decode bitwise the "
          f"local decode on the round-tripped tree, paged bitwise fixed, "
          f"session tokens {so['session_tokens']} == the loop's, prefill "
          f"bitwise; hymba-1.5b, whisper-small and deepseek-moe-16b x "
          f"{so['cut_layers']} layers bitwise; gemma2 decode step (no "
          f"gather at one shard) eager {dg['eager_ms']:.3f} ms wall "
          f"/ {dg['eager_device_ms']:.3f} device, graphed "
          f"{dg['graph_ms']:.3f} / {dg['graph_device_ms']:.3f} (idle "
          f"{dg['graph_idle']:.1%}); start-up {so['startup_s']:.1f} s, peak "
          f"{so['peak_startup_bytes']} B (allocated at the phase's start "
          f"{so['allocated_at_start']} B), peak {so['peak_bytes']} B; "
          f"launches {so['launches']}; session stats {so['session_stats']}; "
          f"card {card}", flush=True)
    for name, t in dg["eager_kernels"]:
        print(f"  {t:9.4f} ms  {name[:90]}")
    dd = so["moe_decode_graph"]
    print(f"sharded serving (4o): deepseek-moe-16b x {so['cut_layers']} "
          f"layers, its expert stacks ({so['moe_expert_bytes']} B of "
          f"float32) through the int8 gather's Q_x round trip each step: "
          f"decode step eager {dd['eager_ms']:.3f} ms wall / "
          f"{dd['eager_device_ms']:.3f} device, graphed {dd['graph_ms']:.3f}"
          f" / {dd['graph_device_ms']:.3f} (idle {dd['graph_idle']:.1%}); "
          f"the gather alone (a CUDA graph) {dd['gather_ms']:.3f} ms, "
          f"{dd['gather_share']:.1%} of the graphed step; K3+K4+K12 in the "
          f"eager step's profile {dd['qx_kernels_ms']:.3f} ms", flush=True)
    for name, t in dd["eager_kernels"]:
        print(f"  {t:9.4f} ms  {name[:90]}")
    fd = f6["dispatch"]
    print(f"MoE training (6f, deepseek-moe-16b x {MOE_TRAIN_LAYERS} layers, "
          f"{f6['n_params']} parameters, one NCCL rank, {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} tokens): losses "
          f"{', '.join(f'{x:.4f}' for x in f6['losses'])}; step wall "
          f"{f6['step_wall_ms']:.3f} ms, device {f6['step_device_ms']:.3f} "
          f"ms (idle {f6['device_idle']:.1%}), {f6['tokens_per_s']:.1f} "
          f"tok/s; phases " + ", ".join(f"{k} {v:.3f}" for k, v in
                                        f6["phases_ms"].items())
          + f" ms; peak {f6['peak_bytes']} B; aux {f6['aux']:.6f} of the "
          f"loss sum {f6['loss_sum']:.2f} ({f6['aux_share']:.3e}); "
          f"forward+backward einsum {fd['einsum_bfloat16']['fwd_bwd_ms']:.1f}"
          f" ms, sort {fd['sort_bfloat16']['fwd_bwd_ms']:.1f} ms (bf16; "
          f"loss rel {fd['rel_bfloat16']:.2e}), float32 einsum "
          f"{fd['einsum_float32']['fwd_bwd_ms']:.1f}, sort "
          f"{fd['sort_float32']['fwd_bwd_ms']:.1f} ms (loss rel "
          f"{fd['rel_float32']:.2e}, limit 1e-5); --model 1 "
          f"({f6['model1_grid']}): loss {f6['model1_loss']:.4f}, token "
          f"exchanges {f6['model1_exchanges']} (one shard: no all-to-all); "
          f"launches {f6['launches']}; by kernel:", flush=True)
    for name, t in f6["step_kernels"][:12]:
        print(f"  {t:9.4f} ms  {name[:90]}")
    print(f"6d's session closed and dropped without a collection: allocated "
          f"{a6['allocated_before']} B before 6d, {a6['allocated_held']} B "
          f"with the session, {a6['allocated_after_close']} B after",
          flush=True)

    out_dir = os.path.join(HERE, "results")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as fh:
        json.dump(dict(card=card, kernels=rows, k1_cases=mm_table,
                       k1_noise=mm_noise, k1_timed=mm_timed, serve=res,
                       k1t_cases=mt_table, k1t_timed=mt_timed,
                       flash_cases=fa_table, serve_gemma2=gem, flash_path=fp,
                       serve_packed=pk, serve_f32=pf,
                       serve_gemma2_f32=pg,
                       gather_timed=g_table,
                       train_kernels=t_table, train=tr,
                       wire_kernels=w_table, dist=ds,
                       encode_kernels=e_table, modes=md, wire_buffers=wb,
                       slice6_kernels=s_table, planted_faults=s_faults,
                       alg1_baselines=bl, paper=pp, train_graph=gt,
                       dist_ckpt=ck, serve_gemma3=g3, serve_qwen=qw,
                       serve_admission=ad, train_llava=lv, adaptive=a6,
                       deep_lanes=dl_table, paper_adaptive=pa, hier=h6,
                       moe_shapes=moe_table, serve_deepseek=ds16,
                       serve_maverick=mav, train_moe=f6,
                       ssm_shapes=ssm_table, serve_mamba2=m2,
                       serve_hymba=hy, train_ssm=g6,
                       encdec_shapes=encdec_table, serve_whisper=wh,
                       train_whisper=w6, serve_mesh=so, perf=perf_res,
                       multihost=mh,
                       phase_s=phase_s),
                  fh, indent=1)
    print("seconds by phase: " + ", ".join(f"{k} {v:.1f}" for k, v in
                                           phase_s.items())
          + f"; total {time.perf_counter() - t_start:.1f}", flush=True)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
