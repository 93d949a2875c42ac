#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It builds the hand-written kernels from ``src/repro_torch/kernels/csrc`` with
``nvcc`` (all sources at once), then:

1. kernel phase — calls each kernel's wrapper on the card at the shapes the
   main path gives it, holds the result against the kernel's plain PyTorch
   version on the same inputs, and times kernel, plain version and, where one
   exists, the single PyTorch call computing the same function (CUDA events,
   warmed up, median of 10; for every kernel at its main path's shapes
   also the kernel's own device time from ``torch.profiler``, which leaves
   out the host's launch overhead that the event time of a decode-sized
   call includes (for K4, where the profiler records too few of the
   kernel's launches, one call's time among 10 replayed from one captured
   CUDA graph instead, marked ``device_ms_by``), for
   K4 SDPA's device time beside its event time, and for K3 also a call's
   time among 10 enqueued back to back, which needs no profiler); K4's
   ``"dh"`` form (``Smoke.dh_phase``) at rank 0's local shapes of the
   sharded decode path, ``d_head`` split by hand into the model axis's 16
   slices, the slices' partial logits summed in f32 for the all-reduce,
   ``dh_logits`` timed beside the library's f32 product (``torch.baddbmm``
   with ``out_dtype=torch.float32``; its device time too), each call's form
   counted (the ring form on the cache's layout, every call), one launch a
   call of each kernel; rows at shapes
   that no path of the smoke runs carry a ``launches_note`` in the
   kernels line;
2. path phase — runs the LM serving path (``repro_torch.launch.serve_lm.
   generate`` at full width and depth on qwen3-0.6b, zamba2-7b,
   rwkv6-1.6b, gemma2-9b, stablelm-3b and starcoder2-15b: batch 8, a
   512-token prompt, 32 greedy steps, K4 on every attention call, K5 on
   every Mamba-2 layer, K6 on every RWKV-6 layer; gemma2-9b also a window
   run past its local layers' window of 4096; then mixtral-8x22b and grok-1-314b at full width, cut in depth, and
   qwen2-vl-2b and musicgen-medium on embeddings: below; every decode step
   one replay of the captured step, ``serve_lm.DecodeGraph``, the
   counterpart of the reference's ``jax.jit(decode_step)``, its K4/K5/K6
   launches counted through the replays), each model freed
   before the next, then wordcount, PageRank,
   k-means, π, GMM and kNN through ``BlazeSession(device="cuda")`` with
   ``engine="pallas"``, and fig. 6's hand-fused k-means through
   ``repro_torch.kernels.ops.kmeans_assign``, at the paper's sizes (cut
   where one card or the time limit forces it), checks each result against
   an independent reference, and counts the kernel launches each job made;
3. program phase — the same six jobs and fig. 6's hand-fused loop as fused
   programs (``session.program`` + ``run_loop``, ``engine="pallas"``,
   ``unroll`` = the job's iterations) on the path phase's data, every
   dispatch one replay of a captured CUDA graph;
4. tuning phase — wordcount (K2), PageRank, k-means and GMM (K1) as
   ``session.program(..., tune=True)`` on the same data, and PageRank's
   contribution sum as a per-op ``map_reduce(tune=True)`` called twice;
5. stream phase — k-means, PageRank and wordcount out of core
   (``session.chunked``: pinned host blocks streamed through one captured
   graph, ``run_stream``), checkpointed and resumed;
6. wire phase — PageRank and k-means at 4 shards stacked on the card with
   ``wire="none" | "bf16" | "int8"``, per op and as programs;
7. multinode phase — the ``("node", "data")`` topology: the 8 shards
   stacked on the card as (1x8), (2x4) and (4x2) node rows
   (``launch.mesh.make_node_data_mesh``), on (2x4) and (4x2) with the
   hierarchical collectives and flat: PageRank, k-means and wordcount per
   op and as programs, PageRank and k-means also with ``wire="int8"``,
   fig. 6's hand-fused step (K3 on each shard's points, the partials
   reduced over the mesh) as a program, one k-means ``run_stream`` on
   (2x4), the exactness law, the byte accounting, and a transient
   ``collective.inter`` fault retried;
8. fault phase — the supervisor under injected faults (``core.faults``), on
   the data above: a per-op PageRank dispatch retried, per-op wordcount
   degraded from K2 to eager, the k-means program (K1 and K3) degraded at
   its third dispatch and captured again, a fault inside a first capture
   retried, the k-means stream under read, dispatch and checkpoint faults
   and resumed after a fatal one, wordcount escalated out of a hash target a
   rung too small; supervision's own cost with no rule armed.  Every
   other phase must end with no retry, no degraded node and no escalation
   in any session it made (supervision would otherwise let a kernel that
   fails to launch fall back to eager unseen);
9. serve phase — the query server (``repro_torch.serve.BlazeServer``, its
   session on the card, a resident program's phase 1 under sync-debug
   ``"error"``) over the path phase's data
   (``edges``, ``lines``, ``points``, and ``gmm_points`` for GMM), the six
   prepared queries in process and through ``BlazeClient``, then the
   reference's three serving fault cases on a server of their own;
9b. examples phase — the six port copies of ``examples/``
   (``examples_torch/``), each ``main([])`` in this process on the card (its
   default), the launch counts set to 0 just before and read just after,
   held against ``run(device="cpu")`` of the same script at the same sizes:
   quickstart's π hits, word counts, Σ v² and nearest points exactly, and
   its scaled sum exactly (integers times powers of 2, every partial sum
   below 2^24 of that power: f32 adds them without rounding in any order);
   data_mining's PageRank within 1e-5, k-means' centres within 1e-4 and
   inertia within rtol 1e-4, GMM's log-likelihood within rtol 1e-5 and
   parameters within 1e-4, the iterations equal and kNN's rows exactly
   (``tests/test_torch_algorithms.py``'s tolerances); streaming_aggregation's
   counts and histogram exactly, K2 launched; serve_queries' 18 replies
   within ``tests/test_torch_serve.py``'s tolerances, 6 compiles;
   serve_lm's logits within ``EXAMPLE_LM_TOL`` wherever both runs had taken
   the same tokens, a token differing only at a near-tie of the CPU's
   (top-2 within twice that), K4 (its f32 form: the reduced configs are f32),
   K5 and K6 on every call; train_lm's 300 steps on the card (its first
   the warm-up, then one capture of the step and 299 replays of it), its
   first loss within rtol 1e-5 of the CPU's and its second within one
   AdamW step's reach (``Smoke.first_step_reach``), K4's f32 form on every
   forward and remat recompute, counted through the replays; its ms a step
   beside an eager twin's (``TRAIN_LM_EAGER_STEPS`` steps of ``jit=False``
   in the same run); and K4 at train_lm's attention shape as a row of the
   kernel phase;
10. process phase — the topology across processes, after every other phase
   so that none sees a process group: an NCCL group of world size 1 in
   this process (``init_process_group("nccl", store=FileStore)``), the
   mesh ``make_node_data_mesh(None, n_shards=8)`` (one node row of 8
   shards carrying the group, ``core.collectives.ProcessCollectives``), on
   the path phase's data: the exactness law, PageRank, k-means, wordcount
   and kNN per op, the law, PageRank, k-means and fig. 6's step as
   programs, PageRank and k-means also with ``wire="int8"``.  Each result
   is held against the multinode phase's (1x8) in-process one (integer
   sums, counts and kNN's rows the same bits, floats within that phase's
   own tolerances), each program's captured graph is read node by node
   beside its twin's, captured on an in-process (1x8) mesh with the group
   up (NCCL's copies inside it, through libcuda's graph calls), and the
   walls are printed beside (1x8)'s; a twin whose capture fails raises
   naming the plan node and the eager NCCL work done just before it.  Then
   the stream phase's jobs at its sizes on that process mesh and on the
   in-process (1x8) mesh (``Smoke.process_stream``): ``mode="stream"``
   k-means and PageRank, the streamed word count, PageRank and word count
   per op over the blocks, every word count exactly the per-op one and the
   floats within the stream phase's bounds on both meshes, each job's epoch
   on both, and a k-means stream and a streamed word count checkpointed at
   epoch 2 on one mesh and resumed on the other, both ways, against the
   uninterrupted run.  Then
   ``dp_train`` across processes (``Smoke.dp_train_process``): qwen3-0.6b
   at full width and depth, 2 local shards of a 4 x 1024-token batch, 2
   steps under ``wire="none"`` and ``"int8"`` on the process mesh, bit for
   bit the same steps on the in-process ``data_mesh(2)``.  The group is
   torn down in a ``finally``;
11. shard phase — the LM stack sharded over a ``DeviceMesh``
   (``distributed/sharding.py``, ``launch/dryrun.py``), after the process
   phase: (a) on a (1, 1) ``("data", "model")`` mesh over an NCCL group of
   one brought up here, qwen3-0.6b at full width and depth: 2 sharded
   train steps of 2 × 4096 tokens (``dryrun.make_train_step``) against
   ``runtime.train_loop.make_train_step`` from the same state (losses and
   parameters bit for bit, or, where not, the losses within
   ``TRAIN_LOSS_RTOL`` with the largest parameter difference printed), then
   a prefill of 8 × 512 tokens and 8 decode steps through the sharded steps,
   whose greedy tokens must equal ``generate``'s, K4 counted on both;
   then (``Smoke.shard_resume``) ``runtime.train_loop.train`` over the
   ``DTensor`` tree on the same mesh: 3 steps of the same batches with a
   checkpoint every 2 (each save written shard by shard, ~7 GB), once
   uninterrupted and once crashed at step 2 and resumed, whose losses and
   saved state must equal the uninterrupted run's bit for bit (the bytes
   each save held are cloned on the card as it is written); the step-2
   checkpoint restored onto the sharded tree and into a plain tree on the
   card, both bit for bit what was saved; one sharded and one unsharded
   step from those restores (bit for bit the uninterrupted run's last
   step, and each other's, or, where not, within ``TRAIN_LOSS_RTOL``); each
   save's bytes and seconds, each restore's seconds, K4 counted; at most
   two checkpoints on disk, in a temporary directory removed after;
   (b) in a child process (``python3 chip_smoke.py --shard-rank0 OUT``),
   rank 0 of the 16 × 16 production mesh over a fake group of 256 ranks
   (``make_production_mesh(device="cuda")``; collectives move nothing, so
   gathered buffers hold no values and no result is checked): for qwen3-0.6b
   ``train_4k`` (K4 on its heads) and gemma2-9b ``decode_32k`` (the
   ``"dh"`` layout: K4's ``"dh"`` form, ``dh_logits`` and ``dh_softmax_pv``
   once a layer, no K4 launch and no plain call), the dry run's record of
   the cell on ``"cuda"``, then the cell's step once on rank 0's real local
   shards (random, made shard by shard: ``dryrun.build_cell(make=...)``),
   its peak device memory held to the dry run's (``SHARD_MEM_SLACK``,
   below), then once more timed (rank 0's compute alone), K4 and the
   ``"dh"`` form counted (the latter by form too: every call in the ring
   form, the cache read in place through bulk copies).

Between the LM serving paths and the data-mining phases runs the train
phase: LM training through ``repro_torch.runtime.train_loop.train``.  First
the kernels' gradients at one layer's full-width training shapes (K4 at
qwen3-0.6b's, K5 at zamba2-7b's, K6 at rwkv6-1.6b's, a micro-batch of 2
sequences of 4096 tokens) and K4's forward at qwen3's training shape as a
row of the kernel phase; then qwen3-0.6b at full width and depth (random
weights from seed 0): 8 steps of 4 sequences of 4096 Zipf tokens
(``TokenPipeline``) in 2 micro-batches, remat on, ``AdamW`` with
``warmup_cosine(3e-4, 1, 8)``, a checkpoint at the end, K4 on every
attention call (forward and the remat recompute; the backward recomputes
``attention_ref``), through ``train(jit=True)``: the first step the
warm-up, then one capture of the step (``TrainGraph``) and 7 replays; the
same step from the same parameters and batches as the eager twin twice
and captured again (``Smoke.train_twins``, ``TRAIN_TWIN_STEPS`` steps
each), an eager step and a replay under ``torch.profiler``; and a crash at
step 6 with a checkpoint every 4 steps, resumed from step 4 through a new
capture.

K4 (``flash_attention``) is held against ``attention_ref``, which
materialises the f32 logits.  Both compute each logit as an f32 dot product
of length D, within ``γ = (D + 2)·u·scale·‖q_i‖·max_j ‖k_j‖`` of the exact
one (Cauchy–Schwarz on ``Σ|q_d k_d|``), plus ``4u·softcap`` for the
``tanh``; shifting every logit of a row by at most ``ε = 2γ + 8u·softcap``
moves each softmax weight by a factor within ``e^{±2ε}``, and each version
sums the row's ``n`` live terms in f32 (``n·u`` of the sum each; the decode
form's merge of its partials adds a few roundings, inside the ``+4``).  So
an output may differ by ``max|v| · (2ε + 2(n + 4)u)``, with ``max|v|`` over
the head's values; a bf16 output adds one bf16 step, ``2^-7·|out|``, where
the two f32 results round to neighbours.  The bf16 forms also round each
``p`` to bf16 (relative ``2^-9``) for the ``p·v`` product while ``l`` sums
the f32 ``p``: that moves the output by at most ``2^-9·Σ_j p_j|v_j| / l``,
and ``2^-8·attention_ref(q, k, |v|)`` bounds it with a factor 2 to spare.
At every shape the check must reject a zero output, the kernel's own output
with the first live 64-key block dropped, and with the last live 64-key
block dropped (a lost decode split; where that block holds fewer than 32
live keys, as at a window's edge, the last 64 live keys).  The decode form is also held, within
the same tolerance, against ``flash_decode_plain``, its arithmetic in plain
PyTorch with the kernel's own splits.

K4's ``"dh"`` form is held to ``attention_ref`` on the whole tensors within
the same tolerance: each slice's partial logits are f32 dot products of
``D / 16`` terms and their sum one of ``D`` terms in another order (the
same ``(D + 2)u`` bound), its weights stay in f32 (inside the bf16 term),
and each slice of the output rounds to bf16 once.  It must reject a zero
output, the sum with one slice's partial left out, and the output with the
last live 64-key block dropped (the rule above).  Over 32768 keys of
independent normal inputs the weights spread so thin that an output is
within the tolerance's ``n·u·max|v|`` term of zero (a zero output passes
but for a few elements) and losing one 64-key block moves them less; so
the check's queries are scaled by 3 (peaked weights, as a trained model's)
and the keys of that last block doubled (a recent block the rows attend
to).  ``dh_softmax_pv`` is also held to ``dh_softmax_pv_tiled``, its
arithmetic in plain PyTorch with the kernel's own splits, on the card: each
is within that tolerance of the exact output (the tiled form's f32 sums and
``exp``/``tanh`` obey the same bounds), so the two lie within twice it of
each other.

K5 (``ssd_scan``) and K6 (``rwkv6_scan``) are held against their plain
chunked versions and against the float64 step-by-step oracles (``ssd_ref``;
``rwkv6_ref`` on the decay floored as the chunked forms floor it, the
floorless distance printed beside it), every output element within
``2^-7·|ref| + c·bound``.  ``A``, the oracle run on absolute values (``|x|,
|B|, |C|, |h0|``; ``|r|, |k|, |v|, |u|, |S0|``), bounds the sum of the
magnitudes of the terms that make up each element.  Both f32 forms sum those
terms in other orders, which costs at most ``u·A`` per addition on the
longest chain: ``2d`` for the two dot products over the state width ``d``,
``2L`` for the sums over a chunk of ``L`` steps, ``16`` for the products,
exponentials and the final adds, and per chunk carried ``L + 8``: ``τ₀ =
u·(2d + 2L + 16 + nch·(L + 8))``, ``nch`` the kernel's 64-step chunks and
``L`` the longer of the two forms' chunks.  K5's prefill form runs its
products on the tensor cores with f32 operands split into bf16 parts,
which adds ``ssd_tc_tau(d) = 2·2^-18 + u·(d + 64 + 3)`` to ``τ₀`` (the
split residues of the two products a term crosses, and the tensor cores'
sums rounding toward zero; derived in ``csrc/ssd_scan.cu``); its decode
form is f32 FMAs.  K6's prefill form likewise adds ``rwkv6_tc_tau(d) =
4·2^-18 + u·(d + 64 + 3)`` (one product with both operands split, one with
one; derived in ``csrc/rwkv6_scan.cu``); its decode form is f32 FMAs.  Both
kernels take their exponentials with ``expf`` (no ``ex2.approx``), so they
add no term beyond ``τ₀``'s.  Each decay factor is the
exponential of a difference of running sums of ``a·dt`` (K5) or ``log w``
(K6) inside a chunk, and an error in that exponent is a relative error of
the term it scales.  K5's forms both take the running sum in order (the
kernel in one thread, the plain version with ``torch.cumsum`` along a
non-innermost dimension), so the rounding shared by ``Δ_l`` and ``Δ_s``
cancels in ``Δ_l − Δ_s``: a term carried from step ``s`` to step ``t``
(across chunk boundaries too) has its exponent off by at most ``u·Σ_{s<j≤t}
w_j``, ``w_j = |Δ_j| + 2|a·dt_j|`` (the running sum's rounding at ``j``, the
product's and the subtraction's), with ``Δ_j`` the running sum from the
start of ``j``'s chunk of ``L`` steps (it contains the kernel's shorter
chunk).  A term that decays fast is small wherever that weight is large,
so K5's bound is per term: ``bound = τ·A + u·E`` (``τ = τ₀``, plus the
tensor-core term for the prefill form), where ``E`` is the recurrence run
on absolute values that also carries every term's magnitude times its
accumulated weight (``ssd_bound``).  K6's kernel factors
its decay as ``exp(λ_l − c)·exp(c − λ_s)`` (``c = λ_T/2`` in the prefill
form), so its exponents carry the running sum's whole error: ``bound = τ·A``
per ``(b, h)`` (``rwkv6_bound``), ``τ = τ₀ + u·nch·3·L·D`` (plus the
tensor-core term for the prefill form), with
``D`` the largest magnitude a running sum of ``log w`` reaches in a chunk of
this run's data (its decay is slow, so ``τ`` stays below 1e-4).  The kernel
and the plain version may each be ``bound`` off, and each rounds its bf16
output once (half a bf16 step, ``2^-8·|y|``), hence ``c = 2.1`` against the
plain version and ``c = 1.1`` against the oracle (the margin also covers
``e^δ − 1 <= δ·e^δ`` for an exponent off by ``δ``), and ``2^-7·|ref|`` for
a bf16 output.  At every shape the check must reject a zero output and the
kernel's output with the carried state dropped: at the middle chunk
boundary for a prefill (the second half from a zero state), from a zero
state for a decode step; K5's must also reject the kernel's output with the
heads of fast decay (``|a| >= 8``, about half of them) scaled by 1.05.

The shard phase's memory bound.  The dry run's peak is the largest sum of
live local storages' bytes (``launch.dryrun.DispatchCounter``), exactly the
sizes the step requests; the card's ``requested_bytes.all.peak`` counts the same requests
before the caching allocator rounds them, so the two differ only by what
the card allocates or holds and the fake run does not: cuBLAS's and
cuBLASLt's workspaces (32 MiB each, allocated through PyTorch's allocator,
one pair a thread: a backward runs on the autograd engine's device thread),
K4's decode-form workspace (none on these cells), and the output buffers of
collectives that the real group holds until they are waited on (a fake
tensor holds no buffer).  The requested peak must lie within ``[dry − 16
MiB, dry + SHARD_MEM_SLACK + 2 × the cell's largest collective output]``
(``SHARD_MEM_SLACK``: two threads' workspaces, 128 MiB; the 16 MiB below
for tensors a fake implementation allocates where the kernel reuses a
buffer).  The first bound, 96 MiB of workspaces alone, held the decode
cell (+64 MiB measured) and failed the train cell (+320 MiB: its
largest collective output is 128 MiB, a gathered activation), so it was
widened after that run.  ``max_memory_allocated`` is
printed beside it: each block rounds up to 512 bytes, and a large request
may take a cached block up to 1 MiB larger (the allocator splits a block
only when more than 1 MiB would remain), so it exceeds the requested peak
by at most 1 MiB a live block.

The LM path's f32 logits must agree with the plain path (``attn_impl=
"ref"``, ``scan_impl="chunked"``, teacher-forced along the same tokens) and
with a teacher-forced ``forward`` within ``LM_LOGIT_TOL[arch]`` (max) and
``LM_LOGIT_RMS_TOL[arch]`` (root mean square); greedy tokens must be the
plain path's argmax wherever its top-2 logits lie more than twice the max
tolerance apart.  Each tolerance is the bf16 model's own rounding noise with
a margin: its decode steps and the teacher-forced forward, the same sums in
other orders with the same kernels, differ at these configurations on an
H100 (logits' standard deviation 0.64, 1.0, 1.0) by 0.054 (qwen3-0.6b),
0.986 (zamba2-7b; RMS 0.150) and 0.173 (rwkv6-1.6b; RMS 0.030), against
the plain path by 0.058, 0.963 (RMS 0.141) and 0.192 (RMS 0.035); the
tolerances 0.15, 2.5 (RMS 0.4) and 0.5 (RMS 0.1) are 2.5–3 times the
larger.  81 random bf16 layers amplify rounding that far, so for zamba2-7b
and rwkv6-1.6b the check that tells a faulty kernel from the plain path is
made in f32: the same models built in f32 (batch 2, 512-token prompt, 8
steps) took decode within 5.6e-4 (zamba2-7b) and 5.8e-5 (rwkv6-1.6b) of the
forward on an H100, their f32 rounding noise; ``LM_F32_TOL`` (2e-3 and
2e-4, 3.5 times those) holds the kernel path there against both the
forward and the plain path teacher-forced along its tokens, and greedy
tokens must be the plain path's argmax wherever its top-2 logits lie more
than twice that apart.  A fault of a kernel or of the decode path (a state
carried wrong, a conv tail or a shift row off by a step) moves the logits
by far more.  The dense three served at full depth (logits' standard
deviation 1.20, 1.00, 1.00) took decode within 0.129 (gemma2-9b), 0.0937
(stablelm-3b) and 0.108 (starcoder2-15b) of the forward on an H100, and
the plain path within 0.140, 0.105 and 0.108: ``LM_LOGIT_TOL`` 0.35, 0.28
and 0.3 are 2.7, 3.0 and 2.8 times that noise (2.5, 2.7, 2.8 times the
plain path's).  gemma2's window run took 0.117 against the forward and
0.121 against the plain path, within the same tolerance.  Their f32 checks
(``F32_LAYERS``: gemma2-9b and starcoder2-15b at 2 layers, whose f32
weights beside the bf16 model's would not fit at full depth; stablelm-3b
whole) took decode within 2.83e-5, 1.99e-5 and 2.41e-5 of the forward and
the plain path within 1.82e-5, 1.26e-5 and 1.81e-5: ``LM_F32_TOL`` 1e-4,
7e-5 and 8.5e-5 are 3.5 times the forward's.

The MoE models run at full width, mixtral-8x22b cut to its first 8 of 56
layers (2.50 B parameters a layer: 40.9 GB of bf16 weights with the
embedding and head, where 56 layers would be 281 GB) and grok-1-314b to 4
of 64 (4.92 B a layer: 42.6 GB): batch 8, 512-token prompts, 32 greedy
steps through ``generate``, at the published ``capacity_factor`` 1.25.
``RouteLog`` records every MoE call's routes (the smoke wraps
``models.moe.moe_apply``, which the blocks call through the module).
The plain path's attention differs from K4's bf16 forms by rounding, which
moves router probabilities by ~1e-2 at most and flips a top-2 choice
wherever a token's 2nd and 3rd probabilities lie that close: ~1,500 of
mixtral's 32,768 prefill token-layers flip, and a flipped token's expert
output changes entirely.  So routes are compared with ``compare_routes``:
a flip must sit at a near-tie (both runs' gaps between the k-th and
(k+1)-th probability within twice the layer's largest probability
difference over the tokens the flips have not reached), a kept choice may
differ only behind a flip earlier in its group, and logits are held only
where no flip or knock-on lies at their position or before in any layer.
End to end in bf16 that leaves no logit of the kernel path clean against
the plain path (0 of 264 measured on an H100): the plain path runs the
prefill alone, and its routes are held to the flip rule (all of layer 0's
flips, where nothing is tainted, among them).  Decode against the
teacher-forced forward at ``capacity_factor = E / k``, where nothing can
drop, must leave at least an eighth of its logits clean (a quarter or more
measured) within ``LM_LOGIT_TOL``.  The step-local check: each decode step
of the kernel path against the plain path's step from a copy of the same
caches, where a step's 64 token-layers flip a few times at most; its
logits must agree within ``LM_LOGIT_TOL`` (0.25: 3 times the 0.082
measured on an H100).
And in f32 at 2 layers (``lm_moe_f32``: batch 2, 512-token prompts, 8
steps; mixtral also batch 1, a 4608-token prompt) routes flip nowhere
measured, and the kernel path must agree with the plain path and decode
with the forward within ``LM_F32_TOL`` (1e-4: 3.3 times the 3.0e-5
measured).  mixtral's window run (batch 1, a 4608-token prompt, 16 steps)
must call K4 with every key of the 4625-row cache in the prefill (keys past
the window masked) and ``window + 1 = 4097`` keys at offset 4096 in every
step (``attn_apply``'s view of the cache), held as above.  gemma2-9b's
window run (``lm_window_run``, the same traffic after its 545-row path,
whose window masks nothing) must call K4 so in its local layers and, in its
global ones, with every key of the cache at the step's offset; a dense
model's window run is held by ``dense_checks`` (the plain path and the
forward) within ``LM_LOGIT_TOL``.  qwen2-vl-2b and
musicgen-medium run at full width, cut to half their depth
(``EMBED_LAYERS``: 14 of 28 and 24 of 48 layers), on random ``[8, 512, d]``
prompts and 32 ``[8, 1, d]`` steps (``serve_lm.serve_embeddings``),
against the plain path and the forward within ``LM_LOGIT_TOL`` (0.25 and
0.35: 2.7 and 2.8 times the 0.093 and 0.126 measured); qwen2-vl also runs
one forward at distinct ``(t, h, w)`` triples (a 16 × 16 image, then text)
against the plain path's, whose logits must move further from the text
positions' than that error.

Every LM path above (and the examples phase's serve_lm) decodes through the
captured step, with no NCCL group up (the shard phase's ``generate`` runs
eager: its group is up).  Its launches and forms are counted where they
happen (``lm_launches``): the wrappers count the prefill's calls and the
step's warm-up and capture, and the decode graph's replays
(``serve_lm.stats``) count the captured step's launches once a replay;
each is held to its exact count, and the path's launches (the kernels
line's ``launches``, ``launches_by`` its two parts) are their sum.  A
replay's profile must show each K4/K5/K6 kernel the step captured as
many times a replay.  Each path adds two checks: its
logits against an eager run (``capture=False``) of the same model and
inputs within the path's tolerance (``LM_LOGIT_TOL``, ``LM_F32_TOL`` in f32,
``EXAMPLE_LM_TOL``), each row up to its first differing token, a token
differing only at the eager run's near-tie (``held_to_eager``: K4's decode
form sizes its split from the cache in the graph and from the offset
eagerly, and mixtral's window run reads the whole cache there and the
window's view eagerly, so bits may differ); and two replays of one step
from the same snapshot of the caches must give the same bits
(``graph_step``, which also times a replay: event ms and the card's busy
ms beside the eager step's).  The MoE paths record routes on an eager run
(a replay calls no Python) and hold the captured run to it; in mixtral's
and gemma2's window runs the captured step's K4 calls (warm-up and
capture) must see the whole 4625-row cache with the offset on the device.
K4's decode form with that offset (``kernel_attention_at``) is held to
``attention_ref`` and to ``flash_decode_plain`` on the same offset within
``attention_tolerance`` at the qwen3, zamba2, mixtral window, gemma2 local,
stablelm, starcoder2, gemma2 and gemma2 window (local and global) decode
shapes over
the whole cache, at the path's last offset and at offsets whose live tiles
are fewer than the static grid's splits (the kernel spreads the live tiles
over the splits it has); at qwen3's heads over a 32768-row cache, an early
offset's device ms is printed beside the host offset's.

The train phase holds each kernel's forward at its training shape to the
bounds above against the plain version, and its gradients, from one
upstream gradient, to the plain route's (the plain version under
autograd): the kernel route's backward recomputes that same plain version
on the same saved inputs, so the two are the same operations in the same
order, equal bit for bit unless a library call picks another order of its
f32 sums at run time; each gradient must lie within ``2^-20`` of its
largest magnitude, and whether it was bit-equal is printed.  The output of
the kernel route must carry the autograd helper's ``grad_fn``, and the
check must launch the kernel once.  The training run must launch K4 28
layers × 2 micro-batches × 2 (forward, remat recompute) × 8 steps = 896
times, all in the bf16 prefill form, counted through the replays
(``ran_launches``: the wrappers' calls in the warm-up and the capture, less
the capture's, which launch nothing, plus the replays'), with one capture
and 7 replays; its losses must be finite and the
last below the first; its first loss must lie within ``TRAIN_LOSS_RTOL``
(2e-3) relative of the same step's loss on the plain path (``attn_impl=
"ref"``, the same parameters and micro-batches): the serving path's logits
differ from the plain path's by up to 0.058 at single positions (above),
and the loss averages 16,384 of them.  The captured twin's losses,
parameters, moments and step must equal the first eager twin's bit for
bit, or lie no further from them than the second eager twin's do (an
atomic sum in a backward may order its adds differently between runs);
both differences are printed.  The restart must report one restart, step
8 and 10 steps run (6, then 4 from the step-4 checkpoint), 2 captures and
8 replays.  It prints the losses, the median step (steps 2–8: the
replays) and tokens a second, ``train_mfu`` (model FLOPs ``6·N·tokens``
plus causal attention, no remat recompute, over 989 TFLOP/s), the capture
seconds, the peak memory allocated and reserved, each save's bytes and
seconds, the free disk before the restart, the twins' step ms, and the
profiled eager step's and replay's busy share and top kernels.

Tolerances: integer results, min/max and hash-table layouts are exact.  A
float sum is accumulated in f32 by atomics, in an order the kernel does not
fix, while the plain version accumulates in float64.  Key ``k`` may differ by
``1e-5 |sum_k| + max(1e-5, m_k u) sum_k |v|``, where ``u = 2^-24`` and
``m_k`` counts the f32 additions that reach the key along the kernel's own
accumulation, so ``m_k u sum_k |v|`` is the worst-case error of f32
summation in any order: ``m_k`` is the key's pair count where pairs add
into the output in any grouping (K2: a warp's fold, a CTA's table of hot
keys, the deposit of each partial; K1's global form adds the CTAs
that flush their tables of hot keys), in K1's shared form the most pairs
any one CTA adds into the key plus the CTAs that merge their partials, and
in K1's register form the most elements one thread's slot folds into the
key in registers, plus the folds into the CTA's shared copy (a warp's
shuffle tree and one fold per warp and slot, or one per slot of the CTA on
that column) and the CTAs that merge (``Smoke.fold_additions``).  At the
main path's shapes, and for K1's sums at a 64-key shape that takes its
shared form, the check also proves that it bites: a zero result and the
kernel's result on a stream with every 50th pair dropped must both fail it.
K1's other dtypes and reducers (i32 sum, min and max exactly; bf16 sum;
f32 prod; f32 max with NaN on live and dropped lanes) run on 5 keys (the
register form) and on 64 (the shared form); the run fails unless every
form of K1 was held against the plain version, and the ``kernels`` line
lists the forms each kernel was checked in (``checked_forms``).  A device
time whose profile recorded fewer of the kernel's launches than were made
is printed as null.

K3 (``kmeans_assign``) must give the plain version's assignment wherever
the nearest centre is not a near tie (``kernels.kmeans_assign.near_ties``:
best and second-best ``d²`` within ``8·2^-24`` of their scale); flips below
that are counted and printed.  Its ``[Σx | count]`` is a float sum as above,
held against float64 sums under the kernel's own assignment, with ``m_k``
counted along its form's accumulation (``Smoke.kmeans_additions``: at the
paper's shape the stream form's longest chain, ``stream_additions``: the
most points one consumer thread adds into the key's running sums, its
tiles' and the head's or tail's, plus lane 0's 5-level shuffle tree, 7
additions of the 8 warps in order and ``blocks − 1`` of the CTAs in order).
The stream form adds in a fixed order, so a second call must give the same
bits; views of the points that start 1, 2 and 3 points in (the kernel
peels a head of 1 to 3 points off each) are held against the plain version
alike.

PageRank (5 iterations) and k-means (5 iterations) run with both engines
against references written here that accumulate in float64.  Page ``p``'s
score may differ from the reference by ``score_p (1e-4 + iters in_deg_p
u)``: the second term bounds the f32 rounding of the page's own in-link sum,
the first covers what reaches the page through its in-links and the sink
total.  The script prints the share of pages whose tolerance is below the
contribution of their smallest in-link, so that losing any one in-link
fails the check.  k-means centres are within ``1e-4`` and inertia within
``1e-4`` relative of the reference.  Fig. 6's hand-fused step (K3) and one
``map_reduce`` step (K1) on the same centres agree within the sum of the two
kernels' tolerances plus, per key, the mass of the points whose nearest
centre is a near tie between the two distance formulas; 5 Lloyd steps of K3
meet the k-means reference within ``1e-4``.  GMM (5 rounds, 10^7 points) is
held against a float64 EM on the card that follows ``gmm_em_reference``:
log-likelihood within ``1e-5`` relative, α within ``1e-4`` and μ and Σ
within ``1e-3`` absolute.  K1's register form folds ~1,600 values a slot
(~330 a key) into its partials in registers, then ~114 slots of a CTA per
cell into its shared copy and 270 CTAs into the output (op 5's 9-wide
rows): at most m ≈ 710 additions a sum, a worst case of m·u ≈ 4e-5 of each
sum (~4e-4 in μ, whose entries are O(1–5)) and a random walk of ~√m·u ≈
2e-6; 1e-3 sits above both.
kNN's 100 distances are within ``1e-5`` relative of a float64 ``torch.topk``
of all distances, and its neighbour set is the same except for rows whose
distance ties the 100th.

K2 runs in one launch a call: the check fails on another count, and on any
host sync inside the call (``torch.cuda.set_sync_debug_mode("error")``); it
reads the rounds the kernel ran from ``hash_aggregate.rounds`` and the lanes
left after the pre-combine and after each round from
``hash_aggregate.lanes``, from which ``design_bytes_ms`` counts what this
design moves.  Besides wordcount's combine and merge, an ``init=`` merge of
f32 sums and unique keys past the table's room, K2 runs 64 keys × 5
shuffled copies into 16 slots (overflow must be 240 raw lanes) and one key
on a quarter of 2^22 lanes beside unique keys.  K6 runs its prefill and its
decode form, each call's form recorded; the run fails unless both were
checked, and the LM phase requires rwkv6's 792 K6 calls to be 24 prefill +
768 decode.

K1's global form (PageRank) is also timed in turns with ``index_add_``,
``ROUNDS`` rounds of the median of ``REPS`` each, the median and spread of
both printed, and once on as many ids drawn uniformly over the keys.

The program phase runs each program twice from the same initial state (the
carry reset in place before each): the first ``run_loop`` discovers the
plan, warms up and captures its graphs, the second only replays them, and
must launch no kernel outside a graph; the run fails if a dispatch ran
without a graph.  It prints per job both wall times, the loop's dispatches
and host syncs, the captures and replays, the plan's collectives an
iteration, each graph's kernel launches a replay (recorded at capture by
the wrappers' counts, counted once a replay), the largest capture's peak
device memory and the device memory the program's graphs reserved in their
one shared pool.  Each result is held against the same reference, with the same
tolerance, as its per-op run, and against the per-op result: wordcount's
table as a dict exactly, π exactly, kNN's neighbour set exactly (ties of
the 100th distance aside), fig. 6's centres bit for bit (K3's stream form
adds in a fixed order); PageRank per page within the per-op tolerance,
k-means' centres within 1e-4 and inertia 1e-4 relative, GMM within its
per-op tolerances (the float sums of the two runs are the same sums, in
the atomics' order).

The wire phase holds each result within 2e-2 relative of its float64
reference, the reference package's own wire tolerance
(``tests/test_mapreduce.py``), except where one int8 scale spans values of
very different sizes, by the reference's design.  Per op, int8 PageRank
rounds most pages' sums to 0 and lands far from the float64 scores; it is
held instead to ``pagerank_int8_emulation``, the same shared-scale wire
computed in float64 apart from the engine: each page within one lattice
step an iteration (``Σ_t step_t``) plus ``1e-5`` of its score, and at
least 90% of the pages within ``1e-3`` relative (a page moves by a step
only where an f32 partial lies within its rounding error of a lattice
boundary, and the pages it feeds).  k-means' centres with int8, in both
modes, are held per centre to ``kmeans_int8_reach`` (the counts, and in a
program the inertia, share the scale of the coordinate sums).  It prints
the shuffle payload of the three wires (PageRank's must be 4, 2 and 1
bytes a page a shard) and shows the int8 residual carried: 5 iterations
that accumulate PageRank's contribution sums at fixed scores land closer to
5 times the float64 sums than the same program with its residual reset
after every dispatch, and the sum plus the shards' residuals telescopes
to them within ``5·exact·(1e-4 + 5·in_deg·u)`` a page.  5 PageRank
iterations with and without the carry are printed, not checked: the
carry re-injects last round's error, which a power iteration does not
always cancel.

The multinode phase holds every float job to the tolerance its per-op
run has against the float64 reference (PageRank per page, k-means' centres
1e-4 and inertia 1e-4 relative), word counts exactly, fig. 6 on the mesh
to the k-means reference within 1e-4, and the (2x4) stream to the
in-memory (2x4) program within 1e-4 (centres) and 1e-4 relative
(inertia).  Its int8 runs are held to the wire phase's bounds with the
addends of the one narrowed hop: ``n_nodes`` node partials on the
hierarchical wire, 8 shard partials on the flat one (per op, PageRank to
``pagerank_int8_emulation`` over that many contiguous blocks, the node's
rows being contiguous; k-means to ``kmeans_int8_reach``; int8 PageRank
programs within 2e-2 relative); both errors are printed beside each other.
The exactness law: a dense ``map_reduce`` of 2^22 rows of integers in [0,
4) keyed ``i % 64`` (every partial and total an integer below 2^24) gives
the same bits hierarchical and flat, on all three topologies, per op and
as a program (3 iterations, divided by 3), and equals a NumPy int64 sum.
The dense op's ``intra_bytes``/``inter_bytes`` must equal
``reduce_edge_bytes``; wordcount's shuffle must put ``(S − S/nodes)/S`` of
its payload on inter-node links within one byte.  K1, K2 and K3 must each
run on every topology (the wrappers' launches and the graph replays', both
printed, and the replays); every session ends with 0 retries, 0 degraded
nodes and 0 escalations.  A transient ``collective.inter`` fault (the inter
hop of the first hierarchical reduce a session runs) on (2x4) must be
retried once with a balanced ledger: on the law's op the result is the
fault-free bits; on per-op PageRank, whose float sums K1's global form adds
by atomics (two fault-free runs need not share bits), each page within its
per-op tolerance of the fault-free (2x4) run.  Wall times per op and per
replay are printed for each topology beside the (1x8) run's (single
samples, the card's name and power limit beside them).

The tuning phase runs each job's program with ``tune=True``: every variant
(variant ``j`` pins each node to its ``j``-th candidate, ``cost``'s grids)
is built, dispatched, timed over one replay and freed; the run fails unless
every variant that pins the kernel launched it inside its graph, in a form
it pinned, and no all-eager variant did.  It prints each variant's replay
time and the winner per job, and the peak memory reserved over the phase.
Each tuned result is held to the per-op (untuned) result and reference as
in the program phase.  Besides, in the kernel phase, every K1 candidate at
k-means', PageRank's and GMM's main-path shapes is held against the plain
version within the float-sum tolerance counted along that launch (its form
and grid), and every pinned K2 candidate at wordcount's combine against the
plain version slot for slot; their kernel times are printed.  The per-op
``map_reduce(tune=True)`` must measure its candidates once and hit the
cache on its second call; its results (and an untuned run's) are held to a
float64 sum within the tolerance counted from each page's in-links plus
every CTA's flush.  The winners are saved, loaded into a fresh session,
and every job run again there with ``tune=True`` must measure nothing.

The stream phase holds the k-means points in blocks of ``2^24`` rows (6
blocks, the last padded), the R-MAT edges and the token lines in 8 blocks,
in pinned host memory.  The drivers (``kmeans``/``pagerank`` with
``mode="stream"``, chunked ``wordcount`` per op and as a program) and each
stream program run 5 epochs with prefetch on and off; k-means and PageRank
are held to the per-op results with the program phase's tolerances (the
blocks reassociate the float sums), word counts exactly.  It prints the
pinned host-to-device rate (one plain copy of one block), each epoch's
time beside the blocks' bytes over that rate and beside the in-memory
program's replay of one iteration, and the device memory the stream adds
at its peak after the first epoch, which must stay under two blocks (the
static buffer and the staging one) plus the state and the carry plus what
the graph's pool reserved; every block must be a replay with its K1 (K2:
two) launches inside the graph and none outside.  A run checkpointed every
epoch and resumed from its epoch-2 checkpoint in a new program must equal
the uninterrupted run: word counts exactly, k-means' centres within 1e-4.

The serve phase sends 72 requests from 3 tenants (``serve_traffic``): the
first of each query alone (its capture), the other 66 while dispatch is
paused, then released at once (``max_batch`` 8), with one more request
over HTTP while the queue is full, which must get a typed ``QUEUE_FULL``
429 within 2 s.  It fails unless every request succeeds, the server
compiled 6 times (one a plan, whatever ``iters`` the requests sent),
``cache_hits + compiles == dispatched_plans``, a batch served several
requests and one deduplicated another.  ``strict_phase_1`` runs the
dispatch of every program that has dispatched before under
``torch.cuda.set_sync_debug_mode("error")``, so a host sync there fails its
request; the groups that ran so must number the cache hits.  Word counts
must equal the path phase's
exactly and π's counts the hand-rolled count at the served sample count
(``SERVE_PI_SAMPLES``: 2^30 samples would reserve a 43 GB graph pool
beside the other five resident programs).  Each distinct float request is
held against ``run_direct`` on a fresh session on the card with the program
phase's tolerances (PageRank per page within the per-op tolerance at its
iterations, and against the float64 reference; k-means centres 1e-4,
inertia 1e-4 relative, seed 0 at 5 iterations against the per-op reference
too; GMM log-likelihood 1e-5 relative, α 1e-4, μ and Σ 1e-3; kNN distances
1e-5 relative, the rows equal but for ties of the 100th): the two runs are
the same sums in the atomics' order.  As ``run_direct`` lowers the same
program, GMM is also held to the same tolerances against a float64 EM from
the request's initial means, and kNN against a float64 ``torch.topk`` of
every distance to the query point.  One HTTP round trip a query, paired
with an in-process request of the same parameters (so both carry one
execution's payload: float sums by atomics differ from run to run), must
decode bit for bit to the in-process result.  The served requests must
launch K1 and K2, in the wrappers (discovery, warm-up, capture) and in the
graph replays, counted from 0 just before the traffic and read just after
its last HTTP round trip, before the checks run anything; the served
k-means step is one ``[K, dim+2]`` MapReduce and runs no K3.  It prints each query's p50 and p99 latency over the released
burst and the burst's requests a second, each batch's wall time beside its
executions' replays (one replay of each plan timed alone, times the
iterations), the first request's latency beside a hit's, each resident
program's graph pool and their total, and the launches.  The fault cases:
a transient ``dispatch`` fault retried, a ``kernel.segment`` fault
degrading the k-means program at 10^8 points (captured again, the
follow-up request a hit with no new compile), and shutdown answering a
held backlog with ``SHUTDOWN``, each ledger balanced; every other session
of the phase must end with no retry and no degraded node.

Output: after the build, the count of tensor-core instructions (``HGMMA``,
``HMMA``) in K4's and K5's libraries (``cuobjdump -sass``; none in K4's
fails the run, K5's is printed only); one line per check (K1's, K4's and
K5's with the form each call took), then a ``{"kernels": [...]}`` summary
line (with each K1, K4, K5 and K6 call's form, the forms its path's calls
took, the program phase's launches by kernel and form, the multinode
phase's by topology (K1–K3: the wrappers' and the graph replays') and the
serve phase's), the script's total seconds, the card's name and power limit,
and as the last line
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero.
Without CUDA, or without the rest of the repository beside it, it exits 2 and
prints no result.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

START = time.perf_counter()
ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores (data sheet)
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core rate (data sheet)
# K4's kernels, for the profiler: the f32 form, the bf16 prefill form, and
# the bf16 decode form's split and combine kernels.
K4_KERNELS = ("flash_kernel", "flash_prefill_kernel", "flash_decode_kernel",
              "flash_combine_kernel")
# LM path logits, per model: kernel path vs plain path and forward (docstring)
# K4's "dh" form: the partial logits' kernel and the weights-times-v kernel
# (its splits merged inside it).
DH_KERNELS = ("dh_logits_kernel", "dh_softmax_pv_kernel")
# kernels-line rows at shapes that no path of the smoke runs (the "dh" form
# at qwen3-0.6b's and musicgen-medium's decode_32k slices; the path runs
# gemma2-9b's)
CHECK_ONLY_SHAPES = tuple(f"{kernel}@{shape}" for kernel in ("dh_logits", "dh_softmax_pv")
                          for shape in ("qwen3", "musicgen"))
# The library's partial logits (torch.baddbmm in f32) against dh_logits': both
# sum Dl exact products of bf16 values in f32, in other orders (~1e-6 here).
DH_LIBRARY_TOL = 1e-4
K5_KERNELS = ("ssd_step_kernel", "ssd_chunk_kernel")  # K5's decode and prefill forms
K6_KERNELS = ("rwkv6_step_kernel", "rwkv6_chunk_kernel")  # K6's decode and prefill forms
# The kernels one call of each form a decode step takes launches (by
# core.program.launch_counts' names): a captured step's replay must show them.
STEP_KERNELS = {"flash_attention/f32": ("flash_kernel",),
                "flash_attention/bf16-decode": ("flash_decode_kernel", "flash_combine_kernel"),
                "ssd_scan/decode": ("ssd_step_kernel",),
                "rwkv6_scan/decode": ("rwkv6_step_kernel",)}
LM_LOGIT_TOL = {"qwen3-0.6b": 0.15, "zamba2-7b": 2.5, "rwkv6-1.6b": 0.5,
                "mixtral-8x22b": 0.25, "grok-1-314b": 0.25, "qwen2-vl-2b": 0.25,
                "musicgen-medium": 0.35, "gemma2-9b": 0.35, "stablelm-3b": 0.28,
                "starcoder2-15b": 0.3}
LM_LOGIT_RMS_TOL = {"zamba2-7b": 0.4, "rwkv6-1.6b": 0.1}  # RMS of the same differences
LM_F32_TOL = {"zamba2-7b": 2e-3, "rwkv6-1.6b": 2e-4,  # f32: vs plain path and forward
              "mixtral-8x22b": 1e-4, "grok-1-314b": 1e-4, "gemma2-9b": 1e-4,
              "stablelm-3b": 7e-5, "starcoder2-15b": 8.5e-5}
# The models served at full width and depth (each freed before the next);
# the f32 check's depth where the f32 weights would not fit beside the bf16
# model's (whole stages: gemma2's is a local and a global layer)
LM_ARCHS = ("qwen3-0.6b", "zamba2-7b", "rwkv6-1.6b", "gemma2-9b", "stablelm-3b",
            "starcoder2-15b")
F32_LAYERS = {"gemma2-9b": 2, "starcoder2-15b": 2}
# The examples phase's serve_lm (reduced configs: f32) against its CPU run:
# the f32 tolerances above, qwen3's that of the other attention-only models
EXAMPLE_LM_TOL = {"qwen3-0.6b": LM_F32_TOL["mixtral-8x22b"],
                  "zamba2-7b": LM_F32_TOL["zamba2-7b"], "rwkv6-1.6b": LM_F32_TOL["rwkv6-1.6b"]}
# The MoE models at full width, cut to their first MOE_LAYERS layers
# (module docstring), their f32 check's layers, and mixtral's window run
# (batch, prompt, steps); the models fed by a frontend's embeddings, at full
# width, cut to half their depth (28 and 48 layers) to keep the smoke within
# its time limit.
MOE_LAYERS = {"mixtral-8x22b": 8, "grok-1-314b": 4}
MOE_F32_LAYERS = 2
WINDOW_RUN = (1, 4608, 16)
EMBED_LAYERS = {"qwen2-vl-2b": 14, "musicgen-medium": 24}
EMBED_ARCHS = tuple(EMBED_LAYERS)
REPS = 10
ROUNDS = 5  # K1 global form against index_add_, in turns
STREAM_BLOCK_ROWS = 1 << 24  # k-means points a streamed block (6 blocks of 10^8)
# The fault phase's stream bound: STREAM_SPREAD_FACTOR times the largest
# distance from the first fault-free stream of STREAM_SPREAD_RUNS more (K1's
# atomics merge in no fixed order), never below that many f32 steps of the
# centres; it must reject the same stream with one block counted twice.  The
# factor comes from profiling/capture_probe.py's 30 streams on an H100 (the
# same program again, a fresh program, a fresh one under the faults): 1 to 5
# steps of the centres' magnitude (0.48-2.26e-6), faulted no wider than
# fault-free; at 16 the least bound (16 steps, 8.5e-6) is 2.4x the worst
# distance seen (3.58e-6), and 16x that distance (5.7e-5) is 2.0x under the
# doubled block's shift (1.16e-4).
STREAM_SPREAD_RUNS = 5
STREAM_SPREAD_FACTOR = 16
# Timed epochs a job and mesh in the process phase's streams (after one that
# captures the program's graph).
PROCESS_STREAM_EPOCHS = 3
FORMED = ("flash_attention", "segment_reduce", "ssd_scan", "rwkv6_scan")  # count by form
# The serve phase: π's samples (the path phase's 2^30 would take a 35 GB
# graph pool beside the other five resident programs) and kNN's query points.
SERVE_PI_SAMPLES = 1 << 28
KNN_QUERIES = ([0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [-2.0, 0.5, 1.0], [2.0, -1.0, 0.0])
# The train phase: qwen3-0.6b, 8 steps of 4 sequences of train_4k's 4096
# tokens in 2 micro-batches, and its first loss against the plain path's
# (module docstring).
TRAIN_BATCH, TRAIN_SEQ, TRAIN_ACCUM, TRAIN_STEPS = 4, 4096, 2, 8
TRAIN_LOSS_RTOL = 2e-3
# Steps of each of the train phase's twins (eager twice, then captured: its
# warm-up, the capture and the replays), and of train_lm's eager twin.
TRAIN_TWIN_STEPS = 3
TRAIN_LM_EAGER_STEPS = 20
# The shard phase (module docstring, 11): (a) train steps (batch, tokens,
# steps) and the serving run (batch, prompt, decode steps) at qwen3-0.6b's
# full size; (b) the production-mesh cells rank 0 runs; the memory bound.
SHARD_ARCH = "qwen3-0.6b"
SHARD_TRAIN = (2, 4096, 2)
# The shard phase's resume (Smoke.shard_resume): steps, a checkpoint every
# so many steps, the step the second run crashes at.
SHARD_RESUME = (3, 2, 2)
SHARD_SERVE = (8, 512, 8)
SHARD_CELLS = (("qwen3-0.6b", "train_4k"), ("gemma2-9b", "decode_32k"))
SHARD_MEM_SLACK = 128 << 20
# The kernels rank 0's cells count: K4 and its "dh" form's two.
RANK0_COUNTED = ("flash_attention", "dh_logits", "dh_softmax_pv")
# The process phase's dp_train (module docstring, 10): qwen3-0.6b (SHARD_ARCH)
# at full size, a global batch of 4 x 1024 tokens over 2 local shards, 2
# steps a wire
DP_TRAIN = (4, 1024, 2, 2)
DP_WIRES = ("none", "int8")
F32_U = 2.0 ** -24  # unit roundoff of float32


def attention_tolerance(q, k, v, want, n_keys, **kw):
    """Per output element, what K4 and ``attention_ref`` may differ by
    (module docstring): ``max|v| · (2ε + 2(n + 4)u)`` per row, ``ε =
    2(D + 2)·u·scale·‖q_i‖·max_j‖k_j‖ + 8u·softcap``; for bf16 outputs
    plus one bf16 step ``2^-7·|want|`` and the probabilities' bf16 rounding
    ``2^-8·attention_ref(q, k, |v|)``.  ``kw`` are the call's masking
    arguments (``causal``, ``window``, ``softcap``, ``q_offset``)."""
    import torch
    from repro_torch.kernels.ref import attention_ref

    b, hq, sq, d = q.shape
    rep = hq // k.shape[1]
    qn = q.float().norm(dim=-1, keepdim=True)                      # [B, Hq, Sq, 1]
    kmax = k.float().norm(dim=-1).amax(-1).repeat_interleave(rep, 1)  # [B, Hq]
    vmax = v.float().abs().amax((-1, -2)).repeat_interleave(rep, 1)   # [B, Hq]
    eps = (2 * (d + 2) * F32_U / d ** 0.5 * qn * kmax[:, :, None, None]
           + 8 * F32_U * kw.get("softcap", 0.0))
    tol = vmax[:, :, None, None] * (2 * eps + 2 * (n_keys + 4) * F32_U)
    if q.dtype == torch.bfloat16:
        tol = (tol + 2.0 ** -7 * want.float().abs()
               + 2.0 ** -8 * attention_ref(q.float(), k.float(), v.float().abs(), **kw))
    return tol



def pass_launches(cfg) -> dict:
    """K4's, K5's and K6's calls in one pass over ``cfg``'s layers (a
    prefill or a decode step): K4 on every attention layer, K5 on every
    Mamba-2 layer, K6 on every RWKV-6 layer."""
    from repro_torch.configs.base import MAMBA2, RWKV6
    from repro_torch.models import model as M

    kinds = M.layer_kinds(cfg)
    n_ssm, n_rwkv = kinds.count(MAMBA2), kinds.count(RWKV6)
    return {"flash_attention": len(kinds) - n_ssm - n_rwkv, "ssd_scan": n_ssm,
            "rwkv6_scan": n_rwkv}


def decode_weight_bytes(params, cfg, batch):
    """The weight bytes one decode step of ``batch`` rows reads: every
    weight once, but of an untied embedding table only the ``batch`` rows it
    gathers (none when a frontend feeds the embeddings)."""
    from repro_torch.models import model as M

    nbytes = lambda t: t.numel() * t.element_size()  # noqa: E731
    total = sum(nbytes(t) for t in M._leaves(params))
    if not cfg.tie_embeddings:
        table = params["embed"]
        total -= nbytes(table) - (batch * nbytes(table[0]) if cfg.embed_inputs else 0)
    return total


class RouteLog:
    """While active, every call of ``repro_torch.models.moe.moe_apply`` (the
    MoE blocks call it through the module) also records its routing
    (``moe.routes`` on the call's input, the same arithmetic): ``probs [B,
    S, E]``, ``top_e`` and ``kept [B, S, k]`` per call, in call order."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from repro_torch.models import moe as MOE

        self.moe, self.orig = MOE, MOE.moe_apply
        orig, calls = self.orig, self.calls

        def recorded(params, cfg, x, *, dispatch_groups=1):
            r = MOE.routes(params, cfg, x, dispatch_groups=dispatch_groups)
            b, s = x.shape[:2]
            calls.append({key: r[key].reshape(b, s, -1) for key in ("probs", "top_e", "kept")})
            return orig(params, cfg, x, dispatch_groups=dispatch_groups)

        MOE.moe_apply = recorded
        return self

    def __exit__(self, *exc):
        self.moe.moe_apply = self.orig

    def head(self, n_calls):
        """A log of the first ``n_calls`` calls alone (a prefill's)."""
        log = RouteLog()
        log.calls = self.calls[:n_calls]
        return log

    def trace(self, n_layers):
        """Per MoE layer ``{"probs" [B, T, E], "top_e", "kept" [B, T, k]}``
        over every position the calls saw (a prefill's, then each step's),
        and each step's position count."""
        import torch

        lens = [c["top_e"].shape[1] for c in self.calls[::n_layers]]
        layers = [{key: torch.cat([c[key] for c in self.calls[j::n_layers]], 1)
                   for key in ("probs", "top_e", "kept")} for j in range(n_layers)]
        return layers, lens


def route_gap(probs, k):
    """Each token's gap between its k-th and (k+1)-th router probability."""
    import torch

    p = torch.sort(probs, dim=-1, descending=True).values
    return p[..., k - 1] - p[..., k]


def compare_routes(a, b, lens, k, rows_per_group=None):
    """Two runs' route traces (``RouteLog.trace``) over the same positions:
    where their routes differ, which positions' logits they leave clean, and
    whether every flip sits at a near-tie (module docstring).

    A *flip* is a token whose set of top-``k`` experts differs.  A *knock-on*
    is a token whose experts agree but whose set of kept experts differs: a
    flip earlier in the same group's token order moved its rank within an
    expert's capacity (``lens``: each call's positions, to find the calls;
    ``None`` when no choice can drop: one call per layer, and a knock-on
    is then unexplained; ``rows_per_group``: the rows of a group, all by
    default, fewer where each row is a step of its own).  A token
    is *tainted* at layer ``l`` when a flip or knock-on of its row lies at
    a layer below ``l`` at its position or before (attention carries it
    there).  ``delta[l]``: the largest router-probability difference of
    layer ``l`` over its untainted tokens that did not flip, in every call.  A flip of an
    untainted token is a near-tie flip when both runs' gaps between the
    k-th and (k+1)-th probability are within ``2·delta[l]`` (for experts
    ``i`` and ``j`` to swap, ``p_i − p_j`` changes sign, which moves it by at
    most ``|Δp_i| + |Δp_j|``); any other fails the run.  ``clean [B, T]``:
    no difference in any layer at that position or before: a logit there is
    computed from the same routes in both runs."""
    import torch

    diffs, flips, knock_on, unexplained = [], [], 0, []
    for j, (la, lb) in enumerate(zip(a, b)):
        flip = (la["top_e"].sort(-1).values != lb["top_e"].sort(-1).values).any(-1)
        kept_a = torch.where(la["kept"], la["top_e"], -1).sort(-1).values
        kept_b = torch.where(lb["kept"], lb["top_e"], -1).sort(-1).values
        kept = (kept_a != kept_b).any(-1) & ~flip
        rows = rows_per_group or flip.shape[0]
        t0 = 0
        for c, n in enumerate(lens if lens is not None else [flip.shape[1]]):
            for r0 in range(0, flip.shape[0], rows):
                # the call's group: its tokens in row-major order
                f = flip[r0:r0 + rows, t0:t0 + n].reshape(-1)
                kk = kept[r0:r0 + rows, t0:t0 + n].reshape(-1)
                if bool(kk.any()) and (lens is None or not bool(f.any())
                                       or int(f.nonzero()[0]) > int(kk.nonzero()[0])):
                    row, pos = divmod(int(kk.nonzero()[0]), n)
                    unexplained.append({
                        "layer": j, "call": c, "row": r0 + row, "pos": t0 + pos,
                        "flips": int(f.sum()), "knock_ons": int(kk.sum())})
            t0 += n
        knock_on += int(kept.sum())
        flips.append(flip)
        diffs.append(flip | kept)
    d = torch.stack(diffs)  # [L, B, T]
    below = torch.cat([torch.zeros_like(d[:1]), d.int().cumsum(0)[:-1] > 0])
    tainted = below.int().cummax(dim=2).values.bool()
    deltas, checked, worst, bad = [], 0, 0.0, []
    for j, (la, lb) in enumerate(zip(a, b)):
        dp = (la["probs"] - lb["probs"]).abs().amax(-1)
        ok = ~tainted[j] & ~d[j]
        delta = float(dp[ok].max()) if bool(ok.any()) else 0.0
        deltas.append(delta)
        mine = flips[j] & ~tainted[j]
        if bool(mine.any()):
            gaps = torch.maximum(route_gap(la["probs"], k), route_gap(lb["probs"], k))[mine]
            checked += int(mine.sum())
            worst = max(worst, float(gaps.max()) / max(delta, 1e-30))
            if bool((gaps > 2 * delta).any()):
                bad.append({"layer": j, "gaps": gaps[gaps > 2 * delta][:5].tolist(),
                            "delta": delta})
    clean = ~d.any(0).int().cummax(dim=1).values.bool()
    return {"flips": int(sum(int(f.sum()) for f in flips)), "checked_flips": checked,
            "knock_on": knock_on, "worst_gap_over_delta": worst, "delta_max": max(deltas),
            "not_near_tie": bad, "unexplained_knock_on": unexplained[:5], "clean": clean}


def ssd_tc_tau(n):
    """K5's prefill form on the tensor cores (``csrc/ssd_scan.cu``): every
    term of ``y`` or ``h_T`` crosses at most two products with an f32 operand
    split into bf16 parts, each off by at most ``2^-18`` of the term (two
    parts in the bf16 model; three in the f32 model, far less), and at most
    two tensor-core sums (``n`` over the state, 64 over a chunk) that round
    toward zero, one more ``u`` per addition than ``τ₀`` counts, plus ``3u``
    for the products of the smaller parts, summed first: ``2·2^-18 + u·(n +
    64 + 3)``."""
    return 2 * 2.0 ** -18 + F32_U * (n + 64 + 3)


def ssd_bound(x, dt, a, bm, cm, h0, L):
    """Per element of ``(y, h_T)``, K5's rounding bound ``τ·A + u·E`` (module
    docstring), from one float64 pass of the recurrence over absolute values:
    ``A`` carries every term's magnitude, ``E`` every term's magnitude times
    the weights ``w_j = |Δ_j| + 2|a·dt_j|`` of the steps it has been decayed
    across (``Δ_j`` the running sum of ``a·dt`` from the start of ``j``'s
    chunk of ``L`` steps); ``τ = τ₀`` for the decode form and ``τ₀ +
    ssd_tc_tau(N)`` for the prefill form.  Returns the bound and ``τ``."""
    import torch

    f = torch.float64
    b, s, h, p = x.shape
    grp, n = bm.shape[2], bm.shape[3]
    rep = h // grp
    ad = a.to(f) * dt.to(f)  # [B, S, H], every entry <= 0
    nw = -(-s // L)
    run = torch.nn.functional.pad(ad.abs(), [0, 0, 0, nw * L - s]).unflatten(
        1, (nw, L)).cumsum(2).flatten(1, 2)[:, :s]
    weight = run + 2 * ad.abs()
    decay = torch.exp(ad)
    dx = (dt.to(f)[..., None] * x.to(f)).abs()
    ba = bm.to(f).abs().repeat_interleave(rep, dim=2)
    ca = cm.to(f).abs().repeat_interleave(rep, dim=2)
    amag = (h0.to(f).abs() if h0 is not None
            else torch.zeros((b, h, p, n), dtype=f, device=x.device))
    emag = torch.zeros_like(amag)
    ya, ye = [], []
    for t in range(s):
        d = decay[:, t, :, None, None]
        emag = d * (emag + weight[:, t, :, None, None] * amag)
        amag = d * amag + dx[:, t, :, :, None] * ba[:, t, :, None, :]
        ya.append(torch.einsum("bhpn,bhn->bhp", amag, ca[:, t]))
        ye.append(torch.einsum("bhpn,bhn->bhp", emag, ca[:, t]))
    nch = -(-s // 64)
    tau = F32_U * (2 * n + 2 * L + 16 + nch * (L + 8))
    if s > 1:
        tau += ssd_tc_tau(n)
    bound = (tau * torch.stack(ya, 1) + F32_U * torch.stack(ye, 1),
             tau * amag + F32_U * emag)
    return bound, tau


def rwkv6_tc_tau(d):
    """K6's prefill form on the tensor cores (``csrc/rwkv6_scan.cu``): every
    term of ``y`` or ``S_T`` crosses at most two products with f32 operands
    split into bf16 parts, one with both operands split (off by at most
    ``3·2^-18`` of the term: the dropped pair of small parts and the two
    residues) and one with one (``2^-18``; three parts in the f32 model, far
    less), and at most two tensor-core sums (``d`` over the channels, 64
    over a chunk) that round toward zero, one more ``u`` per addition than
    ``τ₀`` counts, plus ``3u`` for the products of the smaller parts, summed
    first: ``4·2^-18 + u·(d + 64 + 3)``."""
    return 4 * 2.0 ** -18 + F32_U * (d + 64 + 3)


def window_decay(logw, L):
    """K6's ``D`` per ``(b, h)``: the largest magnitude that a running sum of
    the log-decay ``logw [B, S, H, K]`` (every entry <= 0) reaches inside a
    chunk of ``L`` steps, over the chunks and channels of this run's data
    (all entries share one sign, so a whole chunk's sum bounds every partial
    sum in it, and the chunks of ``L`` contain those of the kernel's shorter
    ones)."""
    import torch

    s = logw.shape[1]
    nw = -(-s // L)
    sums = torch.nn.functional.pad(logw.abs().double(), [0, 0, 0, 0, 0, nw * L - s])
    return sums.unflatten(1, (nw, L)).sum(2).amax(3).amax(1)  # [B, H]


def scan_tau(s, d, L, decay):
    """K6's ``τ = u·(2d + 2L + 16 + nch·(L + 8 + 3·L·D))`` per ``(b, h)``
    (module docstring), ``nch`` the kernel's 64-step chunks."""
    nch = -(-s // 64)
    return F32_U * (2 * d + 2 * L + 16 + nch * (L + 8 + 3 * L * decay))


def rwkv6_bound(r, k, v, w, u, s0):
    """Per element of ``(y, S_T)``, K6's rounding bound ``τ·A`` per ``(b,
    h)`` (module docstring) for a call of the kernel's default chunk (64):
    ``A`` the float64 oracle on absolute values and the floored decay, ``τ =
    scan_tau`` plus, for the prefill form (``S > 1``), ``rwkv6_tc_tau(K)``.
    Returns the bound, ``τ [B, H]`` and the floored ``log w`` in float64."""
    import torch
    from repro_torch.kernels.ref import rwkv6_ref
    from repro_torch.kernels.rwkv6_scan import decay_floor

    s, kd = r.shape[1], r.shape[3]
    logw = torch.clamp_min(torch.log(torch.clamp_min(w.double(), 1e-30)),
                           decay_floor(64, s))
    L = min(64, s)
    tau = scan_tau(s, kd, L, window_decay(logw, L))
    if s > 1:
        tau = tau + rwkv6_tc_tau(kd)
    f64 = [t.double().abs() for t in (r, k, v, u, s0)]
    absolute = rwkv6_ref(*f64[:3], torch.exp(logw), f64[3], init_state=f64[4])
    bound = (tau[:, None, :, None] * absolute[0], tau[:, :, None, None] * absolute[1])
    return bound, tau, logw


def stream_additions(assign, n, d, k, offset, blocks):
    """Per key ``[K, 1]``: the f32 additions on the longest chain into the
    key in K3's stream form (``csrc/kmeans_assign.cu``) for ``n`` points of
    ``d`` floats starting ``offset`` floats past 16 bytes, over ``blocks``
    CTAs: the most points one consumer thread adds into the key's running
    sums (its tiles' points, then the head and tail it takes;
    ``kernels.kmeans_assign.stream_threads``), plus lane 0's 5-level
    shuffle tree, the ``STREAM_WARPS − 1`` additions of the warps in order
    and the ``blocks − 1`` of the CTAs in order.  ``kmeans_assign_tiled``
    in ``tests/test_torch_ops.py`` counts the same chain along its own
    walk of the tiles."""
    import torch
    from repro_torch.kernels.kmeans_assign import STREAM_WARPS, stream_threads

    lanes = blocks * 32 * STREAM_WARPS
    thread = stream_threads(n, d, offset, blocks, device=assign.device)
    per_thread = torch.bincount(assign.long() * lanes + thread,
                                minlength=k * lanes).view(k, lanes)
    return (per_thread.amax(1) + 5 + (STREAM_WARPS - 1) + (blocks - 1))[:, None]


def pagerank_int8_emulation(edges, deg, n, shards, iters, damping=0.85):
    """PageRank's per-op ``wire="int8"`` iteration in float64, written
    apart from the engine: ``edges`` split into ``shards`` contiguous blocks
    as ``distribute`` splits them, each block's incoming sums ``p_s``, one
    scale for every shard and page, ``step = max|p| / 127``, each partial
    rounded to that lattice (half to even) and the lattice summed, then
    Eq. 1 with the sink total.  Returns ``(scores [n] float64, [step_t])``
    on ``edges``' device.

    The port's f32 partials round to the same lattice points as these,
    except where one lies within its sums' f32 error of a rounding
    boundary: that page (and, through the links, a few it feeds) moves by
    a lattice step.  Hence the bound the run holds each page to:
    ``Σ_t step_t`` plus ``1e-5`` of the score for the f32 arithmetic."""
    import torch

    f = torch.float64
    src, dst = edges[:, 0].long(), edges[:, 1].long()
    inv = 1.0 / torch.clamp(deg.to(f), min=1.0)
    sink = deg == 0
    per = -(-edges.shape[0] // shards)
    row = torch.arange(edges.shape[0], device=edges.device) // per * n + dst
    s = torch.full((n,), 1.0 / n, dtype=f, device=edges.device)
    steps = []
    for _ in range(iters):
        part = torch.zeros(shards * n, dtype=f, device=s.device).index_add_(
            0, row, s[src] * inv[src])
        step = max(float(part.abs().max()) / 127.0, 1e-30)
        lattice = torch.clamp(torch.round(part / step), -127, 127).view(shards, n).sum(0)
        s = (1 - damping) / n + damping * (lattice * step + s[sink].sum() / n)
        steps.append(step)
    return s, steps


def kmeans_int8_reach(x, c, shards, iters, program):
    """What the int8 wire may move each k-means centre by, ``[K, 1]``: each
    shard's ``[K, W]`` partial (``[Σx | count]``, and the inertia column in
    a program) crosses on one int8 lattice whose step is its largest entry
    over 127, so each sum and count of the total may be off by ``S·step``
    an iteration, and centre ``k``, ``Σx / N_k``, by ``S·step·(1 +
    max|c_k|) / (N_k − S·step)``; a program's carried residual re-injects
    the step before, twice that; summed over the iterations.  The partials
    are taken at the float64 reference's final centres ``c``; ``x`` splits
    into ``shards`` contiguous blocks."""
    import torch

    n, d = x.shape
    c = torch.as_tensor(c, device=x.device)
    d2, assign = ((c[None] - x[:, None, :]) ** 2).sum(-1).min(1)
    vals = [x.double(), torch.ones((n, 1), dtype=torch.float64, device=x.device)]
    if program:
        vals.append(d2.double()[:, None])
    vals = torch.cat(vals, 1)
    shard = torch.arange(n, device=x.device) // -(-n // shards)
    k = c.shape[0]
    parts = torch.zeros((shards * k, vals.shape[1]), dtype=torch.float64,
                        device=x.device).index_add_(0, shard * k + assign, vals)
    step = shards * float(parts.abs().max()) / 127.0
    counts = parts.view(shards, k, -1)[:, :, d].sum(0)
    reach = (2 if program else 1) * step * (1 + c.double().abs().amax(1)) / (counts - step)
    return iters * reach.cpu().numpy()[:, None]


def serve_traffic() -> list[tuple[str, str, dict]]:
    """The serve phase's 72 requests: 3 tenants × 24, each tenant's i-th
    request of kind ``i % 6``, its parameters varied by round and tenant
    (PageRank's ``iters`` 3, 5 or 7; k-means' seed 0–2 with ``iters`` 5, 3,
    5; kNN's query point one of four), so some requests repeat exactly."""
    work = []
    for t in range(3):
        for i in range(24):
            j = i // 6 + t
            q, p = (
                ("pagerank", {"engine": "pallas", "iters": (3, 5, 7)[j % 3]}),
                ("wordcount", {"engine": "pallas", "iters": 1}),
                ("kmeans", {"engine": "pallas", "k": 5, "seed": j % 3,
                            "iters": (5, 3, 5)[j % 3]}),
                ("gmm", {"engine": "pallas", "k": 5, "dataset": "gmm_points", "iters": 5}),
                ("knn", {"k": 100, "query": list(KNN_QUERIES[j % 4])}),
                ("pi", {"engine": "pallas", "n_samples": SERVE_PI_SAMPLES, "iters": 1}),
            )[i % 6]
            work.append((f"tenant{t}", q, p))
    return work


def ran_launches(launch: dict, key: str) -> int:
    """The launches of ``key`` (a wrapper, or ``"<wrapper>/<form>"``) in a
    run that ``Smoke.read_launch_counts`` read, the training graphs counted
    by what ran: the wrappers' count, plus the decode and training graphs'
    replays', less what the training captures recorded (a training capture
    follows a warm-up that is a real step, so its wrapper calls launch
    nothing that ran; a decode path counts its capture's calls with the
    wrappers', ``Smoke.lm_launches``)."""
    name, _, form = key.partition("/")
    wrappers = launch[f"{name} forms"].get(form, 0) if form else launch[name]
    graphs = launch.get("train_graph", {})
    return (wrappers + launch.get("decode_graph", {}).get("replay_launches", {}).get(key, 0)
            + graphs.get("replay_launches", {}).get(key, 0)
            - graphs.get("capture_launches", {}).get(key, 0))


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke.py: src/repro_torch not found beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device is available", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--shard-rank0"]:  # the shard phase's child (b)
        shard_rank0(sys.argv[2])
        return 0
    Smoke(torch).run()
    return 0


def shard_maker(cfg, dev):
    """``make(local, dtype)`` for ``dryrun.build_cell``: rank 0's random
    local shards on ``dev`` from one generator (seed 7), floats uniform in
    [0, 0.02) (values are not checked: kept small and finite; filled in
    place, so no f32 temporaries beside the shards count in the step's
    peak), integers token ids of ``cfg``'s vocabulary."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(7)

    def make(local, dtype):
        if dtype.is_floating_point:
            return torch.empty(local, dtype=dtype, device=dev).uniform_(0.0, 0.02,
                                                                         generator=gen)
        return torch.randint(0, cfg.vocab, local, generator=gen, device=dev, dtype=dtype)

    return make


def shard_rank0(out_path: str, device: str = "cuda") -> None:
    """The shard phase's part (b), in a process of its own (module
    docstring, 11): for each of ``SHARD_CELLS``, the dry run's record on
    ``device``, then rank 0 of the 16 × 16 mesh over a fake group of 256
    ranks running the cell's step on real local shards; the records to
    ``out_path`` as JSON."""
    import tempfile

    import torch
    import torch.distributed as dist
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_production_mesh

    dev = torch.device(device)
    out, failures = {}, []
    for arch, shape_name in SHARD_CELLS:
        key = f"{arch} {shape_name}"
        t0 = time.perf_counter()
        rec = D.run_cell(arch, shape_name, multi_pod=False, out_dir=tempfile.mkdtemp(),
                         force=True, device=device)
        if not rec["ok"]:
            failures.append(f"shard {key}: the dry run failed: {rec['error']}")
            continue
        dry_s = time.perf_counter() - t0
        cfg, shape = D.get_arch(arch), D.SHAPES[shape_name]
        make = shard_maker(cfg, dev)
        D.fake_group(256)
        try:
            mesh = make_production_mesh(device=device)
            if dev.type == "cuda":
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            cell = D.build_cell(cfg, shape, mesh, make=make)
            for name in RANK0_COUNTED:
                getattr(FA, name).launches = 0
                getattr(FA, name).forms = dict.fromkeys(getattr(FA, name).forms, 0)
            dh = ops.attention.dh_plain_calls
            cell.step(*cell.args)
            launches = {name: getattr(FA, name).launches for name in RANK0_COUNTED}
            dh_forms = {name: dict(getattr(FA, name).forms) for name in RANK0_COUNTED[1:]}
            dh = ops.attention.dh_plain_calls - dh
            if dev.type == "cuda":
                torch.cuda.synchronize()
                stats = torch.cuda.memory_stats()
                requested = stats["requested_bytes.all.peak"]
                allocated = torch.cuda.max_memory_allocated()
            else:  # a rehearsal on the CPU measures no device
                requested = allocated = rec["memory"]["peak_bytes_per_device"]
            t1 = time.perf_counter()
            cell.step(*cell.args)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t1) * 1e3
        finally:
            dist.destroy_process_group()
        dry = rec["memory"]["peak_bytes_per_device"]
        # the workspaces, and two collective outputs held until their wait
        # (module docstring)
        held = SHARD_MEM_SLACK + 2 * rec["collectives"]["largest_output_bytes"]
        bound = [dry - (16 << 20), dry + held]
        if not bound[0] <= requested <= bound[1]:
            failures.append(f"shard {key}: the card's requested peak {requested} B is "
                            f"outside {bound} of the dry run's {dry} B")
        n_attn = sum(k in D.M._ATTN_KINDS for k in D.M.layer_kinds(cfg))
        model = mesh.shape[-1]
        dh_layout = shape.is_decode and cfg.n_kv_heads % model and cfg.d_head % model == 0
        # train: each layer's forward and its remat recompute; "dh": no K4,
        # each layer's call one launch of each "dh" wrapper on the card (the
        # plain pair on the CPU)
        k4 = 0 if dh_layout else 2 * n_attn if shape.kind == "train" else n_attn
        dh_kernels = n_attn if dh_layout and dev.type == "cuda" else 0
        want = ({"flash_attention": k4, "dh_logits": dh_kernels, "dh_softmax_pv": dh_kernels},
                n_attn if dh_layout and not dh_kernels else 0)
        if (launches, dh) != want:
            failures.append(f"shard {key}: launched {launches} with {dh} plain 'dh' "
                            f"attention calls, not {want}")
        # the "dh" kernels read the cache in place: the ring form, every call
        want_forms = {name: {"ring": dh_kernels, "element": 0} for name in dh_forms}
        if dh_forms != want_forms:
            failures.append(f"shard {key}: 'dh' forms {dh_forms}, not {want_forms}")
        out[key] = {"dry_peak_bytes": dry,
                    "dry_memtracker_peak_bytes": rec["memory"]["memtracker_peak_bytes"],
                    "card_requested_peak_bytes": requested,
                    "card_allocated_peak_bytes": allocated,
                    "card_minus_dry_bytes": requested - dry,
                    "bound_bytes": bound,
                    "step_ms": step_ms, "launches": launches,
                    "k4_launches": launches["flash_attention"], "dh_plain_calls": dh,
                    "dh_forms": dh_forms,
                    "dry_flops_per_device": rec["cost"]["flops_per_device"],
                    "dry_collectives": rec["collectives"], "dry_run_s": rec["run_s"],
                    "dry_total_s": dry_s, "serving": rec["serving"],
                    "values_checked": False}
        del cell
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    print(json.dumps({"shard_rank0": out}), flush=True)
    if failures:
        raise AssertionError("\n".join(failures))
    with open(out_path, "w") as f:
        json.dump(out, f)


#: CUgraphNodeType values (cuda.h) by name
GRAPH_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph",
                    5: "empty", 6: "wait_event", 7: "event_record", 8: "sem_signal",
                    9: "sem_wait", 10: "mem_alloc", 11: "mem_free", 12: "batch_mem_op",
                    13: "conditional"}


def graph_nodes(graph):
    """A kept CUDA graph's nodes counted by type, and its kernel nodes by
    function name (the first 40 characters), read through libcuda's graph calls
    (``cuGraphGetNodes``, ``cuGraphNodeGetType``, ``cuFuncGetName``)."""
    import collections
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(raw, None, ctypes.byref(count)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * count.value)()
    if cu.cuGraphGetNodes(raw, nodes, ctypes.byref(count)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    kinds, names = collections.Counter(), collections.Counter()
    params = (ctypes.c_byte * 256)()  # CUDA_KERNEL_NODE_PARAMS_v2, func first
    for node in nodes:
        kind = ctypes.c_int(-1)
        cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind))
        kinds[GRAPH_NODE_TYPES.get(kind.value, str(kind.value))] += 1
        if kind.value == 0 and cu.cuGraphKernelNodeGetParams_v2(
                ctypes.c_void_p(node), params) == 0:
            func, name = ctypes.c_void_p.from_buffer(params, 0), ctypes.c_char_p()
            if func.value and cu.cuFuncGetName(ctypes.byref(name), func) == 0:
                names[name.value.decode()[:40]] += 1
    return dict(kinds), dict(names)


def last_graph_nodes(prog):
    """``(u, graph_nodes(...))`` of the program's graph of the most
    iterations a dispatch, for its last state signature."""
    u = max(n for sig, n in prog._graphs if sig == prog._last_sig)
    return u, graph_nodes(prog._graphs[(prog._last_sig, u)].graph)


class Smoke:
    def __init__(self, torch):
        self.torch = torch
        self.dev = torch.device("cuda")
        # Full f32 in every product (PyTorch's default for matmul, not for
        # cuDNN): TF32 keeps ~3 digits and would move near-tie margins.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.summary: dict[str, dict] = {}
        self.path_launches: dict[str, dict] = {}
        # The per-op path's results and references, which the program and
        # wire phases are held against.
        self.per_op: dict[str, object] = {}
        self.program_launches: dict[str, dict] = {}  # job -> replays' launches
        # job -> (build(sess, tune), run, units, check) of the program phase
        self.program_specs: dict[str, tuple] = {}
        self.candidates_checked: dict[str, int] = {}  # kernel check -> candidates held
        # (phase, SessionStats) of every session a phase made, and the phase
        # running (check_supervision)
        self.session_stats: list = []
        self.phase = "setup"
        self.fault_totals: dict[str, int] = {}  # fault phase: dispositions, injected
        self.fault_launches: dict[str, int] = {}  # fault phase: kernel launches
        self.serve_launches: dict = {}  # serve phase: wrappers' and graph replays' launches
        # program job -> its two runs' walls [first, replay] and the first's
        # launches outside a graph (discovery, warm-up, capture)
        self.program_runs: dict[str, dict] = {}
        # multinode phase: kernel -> topology -> {"wrappers", "graph_replays"}
        self.multinode_launches: dict[str, dict] = {}
        # the multinode phase's (1x8) results, walls, law bits and checks,
        # which the process phase is held against
        self.mn_1x8: dict = {}
        # process phase: kernel -> {"wrappers", "graph_replays"}
        self.process_launches: dict[str, dict] = {}
        self.process_stream_launches: dict[str, dict] = {}
        # shard phase: "train" / "serve" -> launch counts, "resume" -> run ->
        # launch counts, "rank0" -> cell -> K4
        self.shard_launches: dict[str, dict] = {}
        # examples phase: example -> launch counts of its main([]) on the card
        self.example_launches: dict[str, dict] = {}
        self.dp_train_launches: dict[str, int] = {}  # process phase: K4, per wire

    # -- measurement helpers -------------------------------------------------

    def sync(self):
        self.torch.cuda.synchronize()

    def time_ms(self, fn) -> float:
        """Median over REPS of one call's device time (CUDA events), after
        two warm-up calls."""
        torch = self.torch
        for _ in range(2):
            fn()
        times = []
        for _ in range(REPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        self.sync()
        return statistics.median(times)

    def back_to_back_ms(self, fn) -> float:
        """One call's time over REPS calls enqueued back to back between two
        CUDA events, after two warm-up calls: the host enqueues a call while
        the card runs the one before, so where a call's device time exceeds
        the host's work for it, its launch overhead drops out.  Needs no
        profiler (which records no launch at all in some windows of a long
        run)."""
        torch = self.torch
        for _ in range(2):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / REPS

    def graph_replay_ms(self, fn) -> float:
        """One call's time among REPS calls captured in one CUDA graph and
        replayed between two CUDA events, after a warm-up call on a side
        stream: the host's launch overhead drops out, as in the profiler's
        device time, for a call whose launches the profiler did not record."""
        torch = self.torch
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        self.sync()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(REPS):
                fn()
        graph.replay()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        del graph
        return start.elapsed_time(end) / REPS

    def device_busy_ms(self, fn, names=(), expect=None) -> dict | None:
        """Mean device time of one call, for each kernel named in ``names``
        and all others together (``torch.profiler``, kernel and copy
        intervals on the card, over REPS calls after one warm-up); the event
        time less their total is time the card waits on the host; ``events``
        counts the named kernels' launches the profiler recorded.  With
        ``expect`` (the named launches one call makes; or a dict of each
        name's, every name not in it 0), a profile that did not record REPS
        times that many is partial: it keeps only its ``events`` and
        ``expected`` counts and a ``total`` of None, so no undercounted time
        is reported.  None where the profiler records no device activity."""
        torch = self.torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        fn()
        self.sync()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                fn()
            self.sync()
        busy: dict[str, float] = {}
        by_name = dict.fromkeys(names, 0)
        for evt in prof.events():
            if evt.device_type != DeviceType.CUDA:
                continue
            name = next((k for k in names if k in evt.name), "other")
            if name != "other":
                by_name[name] += 1
            busy[name] = busy.get(name, 0.0) + evt.time_range.elapsed_us() / 1e3 / REPS
        if not busy:
            return None
        events = sum(by_name.values())
        if isinstance(expect, dict):
            events = {k: n for k, n in by_name.items() if n}
            expect = {k: n for k, n in expect.items() if n}
            want = {k: n * REPS for k, n in expect.items()}
        else:
            want = None if expect is None else expect * REPS
        if expect is not None and events != want:
            print(json.dumps({"partial_profile": list(names), "events": events,
                              "expected": want}), flush=True)
            return {"total": None, "events": events, "expected": want}
        busy["total"] = sum(busy.values())
        busy["events"] = events
        return busy

    def compare(self, what, got, want, *, exact, abs_sum=None, count=None,
                must_fail=False) -> float:
        """Check ``got`` against ``want``, exactly or (float sums) within the
        tolerance above from each key's ``abs_sum`` and f32 addition
        ``count``; return the max abs error.  With ``must_fail`` the check
        must reject ``got`` instead."""
        torch = self.torch
        got, want = got.double(), want.double()
        if not torch.equal(torch.isnan(got), torch.isnan(want)):
            raise AssertionError(f"{what}: NaN positions differ")
        got, want = got.nan_to_num(0.0), want.nan_to_num(0.0)
        err = (got - want).abs()
        max_err = float(err.max()) if err.numel() else 0.0
        if exact:
            ok = max_err == 0.0
        else:
            rel = torch.clamp(count.double() * F32_U, min=1e-5)
            tol = 1e-5 * want.abs() + rel * abs_sum.double()
            ok = bool((err <= tol).all())
        if must_fail:
            if ok:
                raise AssertionError(f"{what}: a wrong result passed the check")
        elif not ok:
            raise AssertionError(f"{what}: max abs error {max_err} over tolerance")
        return max_err

    def record(self, key, **fields):
        self.summary[key] = fields
        print(json.dumps({"check": key, **fields}), flush=True)

    # -- kernel phase -------------------------------------------------------

    def fold_additions(self, ids, k, form, blocks, threads, v=1, tables=False):
        """Per key ``[K, 1]``: the f32 additions that reach it in a kernel
        that strides ``blocks`` CTAs of ``threads`` over the pairs (the
        ``m_k`` of the tolerance above), from this run's ids.  ``"global"``:
        every pair of the key adds into the output (with ``tables``, K1's,
        into the output or a CTA's table of hot keys, plus the CTAs that
        flush their tables).  ``"shared"``: the most pairs one
        CTA adds into the key, plus the CTAs that merge.  ``"registers"``
        (K1, ``v`` values a pair): the most elements one slot folds into the
        key, plus the folds into the CTA's shared copy (a warp's 5-level
        shuffle tree and one fold per warp and slot when ``v`` divides 4,
        else one per slot of the CTA on that column) and the CTAs that
        merge."""
        torch = self.torch
        n = ids.shape[0]
        live = (ids >= 0) & (ids < k)
        if form == "global":
            flushes = blocks if tables else 0
            return (torch.bincount(ids[live].long(), minlength=k) + flushes)[:, None]
        if form == "shared":
            cta = (torch.arange(n, device=self.dev) % (blocks * threads)) // threads
            per_cta = torch.bincount((ids.long() * blocks + cta)[live],
                                     minlength=k * blocks).view(k, blocks)
            return (per_cta.amax(1) + blocks)[:, None]
        from repro_torch.kernels.segment_reduce import SLOTS

        slots = SLOTS * blocks * threads
        per_slot = torch.zeros(k, dtype=torch.long, device=self.dev)
        rows = torch.arange(n, device=self.dev)[live]
        key = ids[live].long() * slots
        for c in range(v):  # element e = i·v + c sits in slot (e // 4) % T · 4 + e % 4
            e = rows * v + c
            slot = (e // SLOTS) % (blocks * threads) * SLOTS + e % SLOTS
            per_slot = torch.maximum(per_slot, torch.bincount(
                key + slot, minlength=k * slots).view(k, slots).amax(1))
        merge = (5 + threads // 32 * (SLOTS // v) if SLOTS % v == 0
                 else -(-SLOTS * threads // v))
        return (per_slot + merge + blocks)[:, None]

    def segment_additions(self, ids, n, v, k):
        """``fold_additions`` for K1's launch at this shape."""
        from repro_torch.kernels._build import sm_count
        from repro_torch.kernels.segment_reduce import THREADS, launch_shape

        form, blocks = launch_shape(n, v, k, sm_count(self.dev.index or 0))
        return self.fold_additions(ids, k, form, blocks, THREADS, v, tables=True)

    def kmeans_additions(self, assign, x, k):
        """Per key ``[K, 1]``: the f32 additions that reach it in K3 on the
        points ``x``.  The stream form: ``stream_additions``.  The shared and
        global forms fold point by point, as K1 does (``fold_additions``)."""
        from repro_torch.kernels.kmeans_assign import THREADS, launch_shape

        n, d = x.shape
        form, blocks = launch_shape(n, d, k, self.dev)
        if form != "stream":
            return self.fold_additions(assign, k, form, blocks, THREADS)
        return stream_additions(assign, n, d, k, x.data_ptr() // 4, blocks)

    def check_kmeans(self, key, x, c, x1, ties, got):
        """Hold K3's ``got = (assign, stats)`` on the points ``x`` against the
        plain version: assignments equal away from ``ties``, the sums within
        the float-sum tolerance (under the kernel's own assignment where a
        near tie flipped one).  Returns ``(max_abs_err, flips, want_stats,
        abs_sum, count)``."""
        from repro_torch.kernels.kmeans_assign import kmeans_assign_plain
        from repro_torch.kernels.segment_reduce import segment_reduce_plain

        got_a, got_s = got
        k = c.shape[0]
        want_a, want_s = kmeans_assign_plain(x, c)
        self.sync()
        differ = got_a != want_a
        if bool((differ & ~ties).any()):
            raise AssertionError(f"{key}: {int((differ & ~ties).sum())} decided "
                                 "assignments differ from the plain version")
        flips = int(differ.sum())
        if flips:  # hold the sums against the kernel's own assignment
            want_s = segment_reduce_plain(got_a, x1, k)
        abs_sum = segment_reduce_plain(got_a, x1.abs(), k)
        count = self.kmeans_additions(got_a, x, k)
        err = self.compare(key, got_s, want_s, exact=False, abs_sum=abs_sum,
                           count=count)
        return err, flips, want_s, abs_sum, count

    def kernel_kmeans(self, key, x, c, x1):
        """K3 against its plain version at fig. 6's shape; ``x1`` is
        ``[x | 1]``.  Also: a second call equal bit for bit, views of the
        points that start 1, 2 and 3 points in (12, 24 and 36 bytes past
        the buffer's start, so the kernel peels a head), and the device
        time."""
        torch = self.torch
        from repro_torch.kernels.kmeans_assign import (
            kmeans_assign, kmeans_assign_plain, launch_shape, near_ties)

        n, d = x.shape
        k = c.shape[0]
        form, _ = launch_shape(n, d, k, self.dev)
        got_a, got_s = kmeans_assign(x, c)
        ties = near_ties(x, c)
        err, flips, want_s, abs_sum, count = self.check_kmeans(
            key, x, c, x1, ties, (got_a, got_s))
        again_a, again_s = kmeans_assign(x, c)
        self.sync()
        if not (torch.equal(again_a, got_a) and torch.equal(again_s, got_s)):
            raise AssertionError(f"{key}: a second call differs from the first")
        del again_a, again_s
        # The check must reject a zero result and one that lost every 50th
        # point.
        self.compare(key + " zeros", torch.zeros_like(got_s), want_s, exact=False,
                     abs_sum=abs_sum, count=count, must_fail=True)
        keep = torch.arange(n, device=self.dev) % 50 != 0
        _, lost = kmeans_assign(x[keep].contiguous(), c)
        self.sync()
        self.compare(key + " 2% points lost", lost, want_s, exact=False,
                     abs_sum=abs_sum, count=count, must_fail=True)
        del keep, lost
        views = {}
        for start in (1, 2, 3):
            xs = x[start:]
            view_err, view_flips, *_ = self.check_kmeans(
                f"{key} from point {start}", xs, c, x1[start:], ties[start:],
                kmeans_assign(xs, c))
            views[start] = {"max_abs_err": view_err, "flips": view_flips}
        nbytes = n * d * 4 + n * 4 + k * (2 * d + 1) * 4
        bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ops = 2 * n * k * d / F32_OPS_PER_S * 1e3
        self.record(
            key, kernel="kmeans_assign", form=form, shape=[[n, d], [k, d]],
            max_abs_err=err, near_ties=int(ties.sum()), flips=flips,
            max_rel_tol=float(torch.clamp(count.double() * F32_U, min=1e-5).max()),
            repeat_bit_equal=True, views=views,
            ms=self.time_ms(lambda: kmeans_assign(x, c)),
            device_ms=self.device_busy_ms(lambda: kmeans_assign(x, c),
                                          names=("kmeans_assign",), expect=1),
            back_to_back_ms=self.back_to_back_ms(lambda: kmeans_assign(x, c)),
            plain_ms=self.time_ms(lambda: kmeans_assign_plain(x, c)),
            library_ms=None,
            bound_ms=max(bound_bytes, bound_ops),
            bound_by="bytes" if bound_bytes >= bound_ops else "operations",
        )

    def kernel_segment(self, key, ids, vals, k, reducer, shape, main_path,
                       must_fail=None):
        """K1 against its plain version; with ``must_fail`` (by default at the
        main path's shapes) also the proof that the check bites; at the main
        path's shapes the device time, and ``index_add_`` (for
        a global-form shape timed in turns with the kernel, ``ROUNDS`` rounds
        of the median of ``REPS``, and the kernel again on as many ids drawn
        uniformly over the keys)."""
        torch = self.torch
        from repro_torch.core.cost import acc_dtype, use_matmul
        from repro_torch.kernels._build import sm_count
        from repro_torch.kernels.segment_reduce import (
            launch_shape, segment_reduce, segment_reduce_plain)

        got = segment_reduce(ids, vals, k, reducer=reducer)
        want = segment_reduce_plain(ids, vals, k, reducer=reducer)
        float_sum = use_matmul(reducer, acc_dtype(vals.dtype))
        n, v = vals.shape
        form, _ = launch_shape(n, v, k, sm_count(self.dev.index or 0))
        abs_sum = count = None
        if float_sum:
            abs_sum = segment_reduce_plain(ids, vals.abs(), k, reducer="sum")
            count = self.segment_additions(ids, n, v, k)
        self.sync()
        err = self.compare(key, got, want, exact=not float_sum, abs_sum=abs_sum,
                           count=count)
        extra = {}
        if main_path if must_fail is None else must_fail:
            # The check must reject a zero result and a result that lost
            # every 50th live pair.
            self.compare(key + " zeros", torch.zeros_like(got), want,
                         exact=not float_sum, abs_sum=abs_sum, count=count,
                         must_fail=True)
            live = (ids >= 0) & (ids < k)
            lossy = torch.where(live & ((live.cumsum(0) - 1) % 50 == 0), -1, ids)
            lost = segment_reduce(lossy.to(torch.int32), vals, k, reducer=reducer)
            self.sync()
            self.compare(key + " 2% pairs lost", lost, want, exact=not float_sum,
                         abs_sum=abs_sum, count=count, must_fail=True)
            if float_sum:
                extra["max_rel_tol"] = float(torch.clamp(
                    count.double() * F32_U, min=1e-5).max())
        nbytes = n * 4 + n * v * vals.element_size() + k * v * 4
        bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3

        def kernel():
            return segment_reduce(ids, vals, k, reducer=reducer)

        bound_ops = n * v / F32_OPS_PER_S * 1e3
        library_ms = None
        ms = None
        if main_path:
            out = torch.zeros((k, v), dtype=vals.dtype, device=self.dev)

            def library():
                return out.index_add_(0, ids, vals)

            extra["device_ms"] = self.device_busy_ms(kernel, names=("segment_reduce",),
                                                     expect=1)
            if form == "global":
                # Kernel and index_add_ in turns (kernel first in even rounds).
                rounds = {"kernel": [], "library": []}
                for r in range(ROUNDS):
                    order = ("kernel", "library") if r % 2 == 0 else ("library", "kernel")
                    for name in order:
                        rounds[name].append(self.time_ms(kernel if name == "kernel"
                                                         else library))
                ms = statistics.median(rounds["kernel"])
                library_ms = statistics.median(rounds["library"])
                extra["rounds_ms"] = rounds
                extra["spread_ms"] = {name: max(t) - min(t) for name, t in rounds.items()}
                uniform = torch.randint(0, k, (n,), generator=torch.Generator(
                    device=self.dev).manual_seed(3), device=self.dev, dtype=torch.int32)
                extra["uniform_ids_ms"] = self.time_ms(
                    lambda: segment_reduce(uniform, vals, k, reducer=reducer))
                extra["uniform_ids_library_ms"] = self.time_ms(
                    lambda: out.index_add_(0, uniform, vals))
                del uniform
            else:
                library_ms = self.time_ms(library)
        self.record(
            key, kernel="segment_reduce", form=form, shape=shape, max_abs_err=err,
            ms=ms if ms is not None else self.time_ms(kernel),
            plain_ms=self.time_ms(
                lambda: segment_reduce_plain(ids, vals, k, reducer=reducer)),
            library_ms=library_ms,
            bound_ms=max(bound_bytes, bound_ops),
            bound_by="bytes" if bound_bytes >= bound_ops else "operations",
            **extra,
        )

    def segment_candidates(self, key, ids, vals, k):
        """Every tuning candidate of K1 at this main-path shape (each valid
        form at each measured CTAs an SM, ``cost.dense_tuning_candidates``)
        held against the plain version within the float-sum tolerance,
        counted along that launch's own accumulation; each call's form
        checked; the candidates' times (median of ``REPS``) printed."""
        torch = self.torch
        from repro_torch.core import cost
        from repro_torch.kernels._build import sm_count
        from repro_torch.kernels.segment_reduce import (
            THREADS, launch_shape, segment_reduce, segment_reduce_plain)

        n, v = vals.shape
        sms = sm_count(self.dev.index or 0)
        want = segment_reduce_plain(ids, vals, k)
        abs_sum = segment_reduce_plain(ids, vals.abs(), k)
        counts, times, errs = {}, {}, {}
        for c in cost.dense_tuning_candidates(k, v, "sum", vals.dtype)[1:]:
            form, blocks = launch_shape(n, v, k, sms, form=c.form, ctas_per_sm=c.ctas_per_sm)
            if (form, blocks) not in counts:
                counts[(form, blocks)] = self.fold_additions(ids, k, form, blocks, THREADS,
                                                             v, tables=True)

            def call(c=c):
                return segment_reduce(ids, vals, k, form=c.form, ctas_per_sm=c.ctas_per_sm)

            before = segment_reduce.forms[form]
            got = call()
            self.sync()
            if segment_reduce.forms[form] != before + 1:
                raise AssertionError(f"{key} {c.describe()}: not launched in its form")
            errs[c.describe()] = self.compare(f"{key} {c.describe()}", got, want, exact=False,
                                              abs_sum=abs_sum, count=counts[(form, blocks)])
            times[c.describe()] = self.time_ms(call)
            del got
        del want, abs_sum, counts
        print(json.dumps({"candidates": key, "kernel_ms": times, "max_abs_err": errs}),
              flush=True)
        self.candidates_checked[key] = len(times)

    def hash_candidates(self, key, keys, vals, key_range):
        """Every pinned tuning candidate of K2 at this main-path shape
        (``cost.hash_tuning_candidates``: table capacity, probe depth and
        table of hot keys) against the plain version, slot for slot; the
        candidates' times printed."""
        from repro_torch.core import cost
        from repro_torch.kernels.hash_combine import hash_aggregate, hash_aggregate_plain

        times, plain = {}, {}
        for c in cost.hash_tuning_candidates(vals.shape[1], "sum", vals.dtype,
                                             key_range=key_range)[1:]:
            if c.table_cap not in plain:
                plain = {c.table_cap: hash_aggregate_plain(keys, vals, c.table_cap,
                                                           max_probes=c.probe_depth)}

            def call(c=c):
                return hash_aggregate(keys, vals, c.table_cap, max_probes=c.probe_depth,
                                      table_bits=c.table_bits)

            got = call()
            self.sync()
            for part, a, b in zip(("keys", "vals", "overflow"), got, plain[c.table_cap]):
                self.compare(f"{key} {c.describe()} {part}", a, b, exact=True)
            times[c.describe()] = self.time_ms(call)
            del got
        print(json.dumps({"candidates": key, "kernel_ms": times}), flush=True)
        self.candidates_checked[key] = len(times)

    def kernel_hash(self, key, keys, vals, cap, shape, *, reducer="sum",
                    init=None, max_probes=None, expect_overflow=False,
                    profile=False):
        """K2 against its plain version: keys and overflow slot for slot,
        values exactly or (f32 sums) within the count tolerance; one launch a
        call and no host sync inside it (``torch.cuda.set_sync_debug_mode``
        raises on any); the rounds it ran (``hash_aggregate.rounds``) and the
        lanes it compacted (``hash_aggregate.lanes``)."""
        torch = self.torch
        from repro_torch.core.cost import acc_dtype, use_matmul
        from repro_torch.kernels.hash_combine import (
            EMPTY_KEY, hash_aggregate, hash_aggregate_plain)

        self.sync()
        launches0, rounds0 = hash_aggregate.launches, int(hash_aggregate.rounds)
        torch.cuda.set_sync_debug_mode("error")
        try:
            gk, gv, go = hash_aggregate(keys, vals, cap, reducer=reducer, init=init,
                                        max_probes=max_probes)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        if hash_aggregate.launches != launches0 + 1:
            raise AssertionError(f"{key}: {hash_aggregate.launches - launches0} "
                                 "launches, not 1")
        lanes = hash_aggregate.lanes.tolist()
        rounds = int(hash_aggregate.rounds) - rounds0
        wk, wv, wo = hash_aggregate_plain(keys, vals, cap, reducer=reducer,
                                          init=init, max_probes=max_probes)
        float_sum = use_matmul(reducer, acc_dtype(vals.dtype))
        abs_sum = count = None
        if float_sum:
            ones = torch.ones_like(vals, dtype=torch.int32)
            abs_init = count_init = None
            if init is not None:
                live0 = (init[0] != EMPTY_KEY)[:, None].expand_as(init[1])
                abs_init = (init[0], init[1].abs(), init[2])
                count_init = (init[0], live0.to(torch.int32), init[2])
            _, abs_sum, _ = hash_aggregate_plain(
                keys, vals.abs(), cap, init=abs_init, max_probes=max_probes)
            _, count, _ = hash_aggregate_plain(
                keys, ones, cap, init=count_init, max_probes=max_probes)
        self.sync()
        # The tables must agree slot for slot, and so must the overflow.
        self.compare(key + " keys", gk, wk, exact=True)
        self.compare(key + " overflow", go, wo, exact=True)
        err = self.compare(key + " vals", gv, wv, exact=not float_sum,
                           abs_sum=abs_sum, count=count)
        if expect_overflow != (int(go) > 0):
            raise AssertionError(f"{key}: overflow {int(go)}")
        n, v = vals.shape
        live = int((keys != EMPTY_KEY).sum())
        if lanes[rounds] != 0 and rounds != len(lanes) - 1:
            raise AssertionError(f"{key}: {rounds} rounds left {lanes[rounds]} lanes")
        table_bytes = cap * (4 + v * 4)
        nbytes = n * 4 + live * v * vals.element_size() + table_bytes
        if init is not None:
            nbytes += table_bytes  # the table merged into is read once
        bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ops = live * v / F32_OPS_PER_S * 1e3
        # What this design moves: the pairs once; the compacted lanes (key,
        # count, row index, partial) written once and their partials read
        # once; each round reads its lanes' keys twice and the rest once, and
        # writes the survivors' key, count and index; claim[] is set once.
        compacted = lanes[0]
        design_bytes = (n * 4 + live * v * vals.element_size() + compacted * (12 + 8 * v)
                        + sum(16 * lanes[r] + 12 * lanes[r + 1] for r in range(rounds))
                        + cap * 4 + table_bytes)

        def call():
            return hash_aggregate(keys, vals, cap, reducer=reducer, init=init,
                                  max_probes=max_probes)

        extra = {}
        if profile:
            busy = self.device_busy_ms(call, names=("hash_aggregate_kernel",), expect=1)
            extra["device_ms"] = busy and busy["total"]
        self.record(
            key, kernel="hash_aggregate", shape=shape, max_abs_err=err,
            overflow=int(go), rounds=rounds, lanes_compacted=compacted,
            lanes_after_round=lanes[1:rounds + 1], ms=self.time_ms(call),
            plain_ms=self.time_ms(lambda: hash_aggregate_plain(
                keys, vals, cap, reducer=reducer, init=init,
                max_probes=max_probes)),
            library_ms=None,
            bound_ms=max(bound_bytes, bound_ops),
            bound_by="bytes" if bound_bytes >= bound_ops else "operations",
            design_bytes_ms=design_bytes / HBM_BYTES_PER_S * 1e3,
            **extra,
        )

    def kernel_phase(self, data):
        torch = self.torch
        from repro_torch.core import cost
        from repro_torch.core.mapreduce import bucket_by_dest
        from repro_torch.kernels.hash_combine import EMPTY_KEY, hash_aggregate

        dev = self.dev
        # K1 at k-means' shape: 10^8 points, dim 3, k 5 -> [5, 4] (sums | count)
        x = data["points"]
        c = data["init_centers"]
        ids = torch.argmin(((x[:, None, :] - c[None]) ** 2).sum(-1), 1).to(torch.int32)
        vals = torch.cat([x, torch.ones((x.shape[0], 1), device=dev)], 1)
        self.kernel_segment("segment_reduce@kmeans", ids, vals, c.shape[0], "sum",
                            [list(vals.shape), [c.shape[0], 4]], True)
        self.segment_candidates("segment_reduce@kmeans", ids, vals, c.shape[0])
        # K3 at fig. 6's shape: the same points against the same centres
        self.kernel_kmeans("kmeans_assign@fig6", x, c, vals)
        # Other dtypes and reducers on the first 2^22 of those pairs, with
        # every 5th id out of range (dropped) and NaN on some dropped lanes:
        # on k-means' 5 keys (the register form), then spread over 64 keys
        # (the shared form; keys 60-63 get no pair, and half the dropped
        # lanes carry an id past the range), where the sums must also reject
        # a zero result and lost pairs.
        n = 1 << 22
        row = torch.arange(n, device=dev)
        dropped = row % 5 == 0
        vi = vals[:n].round().to(torch.int32)
        sign = torch.where(vals[:n, :1] > 0, 1.0, -1.0).expand(-1, 4).contiguous()
        spread = torch.where(row % 10 == 0, -1, 67)
        for kr, sid, tag in ((c.shape[0], torch.where(dropped, -1, ids[:n]), ""),
                             (64, torch.where(dropped, spread, ids[:n] * 12 + row % 12),
                              " k64")):
            sid = sid.to(torch.int32).contiguous()
            sv = vals[:n].clone()
            sv[::10, 0] = float("nan")  # rows 0, 10, ... are dropped lanes
            sv[5::10, 2] = float("nan")  # and rows 5, 15, ...
            shape = [[n, 4], [kr, 4]]
            sums = tag != ""
            for reducer in ("sum", "min", "max"):
                self.kernel_segment(f"segment_reduce i32 {reducer}{tag}", sid, vi, kr,
                                    reducer, shape, False, sums and reducer == "sum")
            self.kernel_segment(f"segment_reduce bf16 sum{tag}", sid, sv.bfloat16(), kr,
                                "sum", shape, False, sums)
            self.kernel_segment(f"segment_reduce f32 prod{tag}", sid, sign, kr, "prod",
                                shape, False)
            sv[1::10, 1] = float("nan")  # a live lane's NaN must reach its key
            self.kernel_segment(f"segment_reduce f32 max nan{tag}", sid, sv, kr, "max",
                                shape, False)
        del vals, vi, sign, sv, sid, ids, row, dropped, spread
        # K1 at PageRank MR2's shape: every edge -> [2^20, 1]
        edges, deg, n_pages = data["edges"], data["deg"], data["n_pages"]
        src, dst = edges[:, 0].long(), edges[:, 1].contiguous()
        contrib = (1.0 / n_pages) / torch.clamp(deg[src], min=1).float()
        self.kernel_segment("segment_reduce@pagerank", dst, contrib[:, None].contiguous(),
                            n_pages, "sum", [[edges.shape[0], 1], [n_pages, 1]], True)
        self.segment_candidates("segment_reduce@pagerank", dst,
                                contrib[:, None].contiguous(), n_pages)
        del src, dst, contrib
        # K1 at GMM op 5's shape, on round 1's memberships (σ = I, α = 1/k):
        # every point emits its k weighted outer products -> [k, d·d]
        xg = data["gmm_points"]
        k = data["gmm_k"]
        diff = xg[:, None, :] - xg[:k][None]
        w = torch.softmax(-0.5 * (diff ** 2).sum(-1), dim=1)
        outer = w[:, :, None, None] * diff[:, :, :, None] * diff[:, :, None, :]
        gv = outer.reshape(-1, xg.shape[1] ** 2).contiguous()
        gid = torch.arange(k, dtype=torch.int32, device=dev).repeat(xg.shape[0])
        del diff, w, outer
        self.kernel_segment("segment_reduce@gmm", gid, gv, k, "sum",
                            [list(gv.shape), [k, gv.shape[1]]], True)
        self.segment_candidates("segment_reduce@gmm", gid, gv, k)
        del gid, gv
        torch.cuda.empty_cache()
        from repro_torch.kernels.segment_reduce import FORMS as K1_FORMS

        checked = {rec["form"] for rec in self.summary.values()
                   if rec.get("kernel") == "segment_reduce"}
        if checked != set(K1_FORMS):
            raise AssertionError(f"K1 forms checked: {sorted(checked)}, want {K1_FORMS}")

        # K2 at wordcount's shapes: pre-shuffle combine, then the merge
        tokens = data["tokens"]
        vocab = data["vocab"]
        keys = torch.where(tokens >= 0, tokens, EMPTY_KEY).reshape(-1).contiguous()
        ones = torch.ones((keys.shape[0], 1), dtype=torch.int32, device=dev)
        cap = cost.table_capacity(keys.shape[0], vocab)
        probes = cost.choose_probe_depth(keys.shape[0], cap)
        self.kernel_hash("hash_aggregate@wordcount-combine", keys, ones, cap,
                         [[keys.shape[0], 1], [cap, 1]], max_probes=probes,
                         profile=True)
        self.hash_candidates("hash_aggregate@wordcount-combine", keys, ones, vocab)
        tk, tv, _ = hash_aggregate(keys, ones, cap, max_probes=probes)
        bk, bv, _ = bucket_by_dest(tk, tv, tk != EMPTY_KEY, 1, cap, 0)
        target_cap = max(64, 4 * vocab)
        init = (torch.full((target_cap,), EMPTY_KEY, dtype=torch.int32, device=dev),
                torch.zeros((target_cap, 1), dtype=torch.int32, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev))
        merge_probes = max(16, cost.choose_probe_depth(cap, target_cap))
        self.kernel_hash("hash_aggregate@wordcount-merge", bk[0], bv[0], target_cap,
                         [[cap, 1], [target_cap, 1]], init=init,
                         max_probes=merge_probes, profile=True)
        # An init= merge into a table that already holds keys, f32 sums
        g = torch.Generator(device="cpu").manual_seed(0)
        k1 = torch.randint(0, 50_000, (1 << 20,), generator=g, dtype=torch.int32).to(dev)
        v1 = torch.randn((1 << 20, 2), generator=g).to(dev)
        first = hash_aggregate(k1, v1, 1 << 17)
        self.kernel_hash("hash_aggregate init merge f32", k1.flip(0).contiguous(),
                         v1, 1 << 17, [[1 << 20, 2], [1 << 17, 2]], init=first)
        # Overflow: more distinct keys than slots, counted and never silent
        k2 = torch.arange(1 << 16, dtype=torch.int32, device=dev)
        self.kernel_hash("hash_aggregate overflow", k2, torch.ones((1 << 16, 1), device=dev),
                         1 << 12, [[1 << 16, 1], [1 << 12, 1]], max_probes=16,
                         expect_overflow=True)
        # Overflow under duplicates counts raw lanes, not partials: 64 keys ×
        # 5 shuffled copies into 16 slots, 16 probes, leave 48 keys, 240 lanes.
        k3 = torch.arange(64, dtype=torch.int32).repeat(5)[torch.randperm(320, generator=g)]
        self.kernel_hash("hash_aggregate overflow duplicates", k3.to(dev),
                         torch.ones((320, 1), dtype=torch.int32, device=dev), 16,
                         [[320, 1], [16, 1]], max_probes=16, expect_overflow=True)
        if self.summary["hash_aggregate overflow duplicates"]["overflow"] != 240:
            raise AssertionError("hash_aggregate: 240 raw lanes should overflow")
        # One hot key on a quarter of 2^22 lanes (Zipf 1.3's top word) beside
        # unique keys.
        n4 = 1 << 22
        hot = torch.rand(n4, generator=g) < 0.25
        k4 = torch.where(hot, 7, torch.randperm(n4, generator=g).to(torch.int32) + 1000)
        cap4 = 1 << 23  # load 0.38
        self.kernel_hash("hash_aggregate hot key", k4.to(torch.int32).to(dev),
                         torch.ones((n4, 1), dtype=torch.int32, device=dev), cap4,
                         [[n4, 1], [cap4, 1]], max_probes=64)
        del k3, k4, hot
        torch.cuda.empty_cache()

    # -- K4: flash attention -------------------------------------------------

    def kernel_attention(self, key, q, k, v, *, q_offset, window=None, softcap=0.0):
        """K4 against ``attention_ref`` (and the decode form against
        ``flash_decode_plain`` too) at one shape of the LM path: the check,
        the proof that it bites (a zero output, and the kernel's own output
        with the first or the last live 64-key block dropped, must all
        fail), the form the call took, and kernel, plain and library times."""
        torch = self.torch
        from repro_torch.kernels import _build
        from repro_torch.kernels import flash_attention as FA
        from repro_torch.kernels.ref import attention_ref

        flash_attention = FA.flash_attention
        kw = dict(causal=True, window=window, softcap=softcap)
        before = dict(flash_attention.forms)
        got = flash_attention(q, k, v, q_offset=q_offset, **kw)
        form = next(f for f, n in flash_attention.forms.items() if n != before[f])
        want = attention_ref(q, k, v, q_offset=q_offset, **kw)
        self.sync()
        b, hq, sq, d = q.shape
        hkv, skv = k.shape[1], k.shape[2]
        qpos = torch.arange(sq, device=self.dev)[:, None] + q_offset
        kpos = torch.arange(skv, device=self.dev)[None, :]
        live = kpos <= qpos
        if window is not None:
            live &= kpos > qpos - window
        n_keys = live.sum(1)                                            # [Sq]
        tol = attention_tolerance(q, k, v, want, n_keys[None, None, :, None].double(),
                                  q_offset=q_offset, **kw)

        def check(what, out, must_fail=False):
            err = (out.float() - want.float()).abs()
            ok = bool((err <= tol).all()) and not bool(out.isnan().any())
            if must_fail and ok:
                raise AssertionError(f"{what}: a wrong result passed the check")
            if not must_fail and not ok:
                raise AssertionError(f"{what}: max abs error {float(err.max())} over "
                                     f"tolerance (max {float(tol.max())})")
            return float(err.max())

        err = check(key, got)
        splits = None
        if form == "bf16-decode":
            t_lo, t_hi = FA.key_tiles(sq, skv, q_offset, True, window)
            splits, _ = FA.decode_splits(b, hkv, t_hi - t_lo, _build.sm_count(q.device.index))
            check(key + " vs flash_decode_plain", FA.flash_decode_plain(
                q, k, v, splits=splits, q_offset=q_offset, **kw))
        check(key + " zeros", torch.zeros_like(got), must_fail=True)
        seen = live.any(0).nonzero()[:, 0]
        lo = int(seen[0]) // 64 * 64 + 64  # past the first live 64-key block
        dropped = flash_attention(q, k[:, :, lo:], v[:, :, lo:], q_offset=q_offset - lo,
                                  **kw)
        self.sync()
        check(key + " first key block dropped", dropped, must_fail=True)
        hi = int(seen[-1]) // 64 * 64  # the last live 64-key block starts here
        if int(seen[-1]) + 1 - hi < 32:  # a block of a few keys (a window's edge)
            hi = int(seen[-1]) + 1 - 64  # drop the last 64 live keys instead
        dropped = flash_attention(q, k[:, :, :hi], v[:, :, :hi], q_offset=q_offset, **kw)
        self.sync()
        check(key + " last key block dropped", dropped, must_fail=True)

        library_ms = library_device_ms = None
        if softcap == 0.0:  # SDPA has no softcap
            import torch.nn.functional as F
            # causal alone (SDPA's fastest form) unless the offset or the
            # window masks more: a window of at least Sq keys masks nothing
            bites = window is not None and window < sq
            mask = None if q_offset == 0 and not bites else live

            def sdpa():
                return F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, is_causal=mask is None, enable_gqa=True)

            library_ms = self.time_ms(sdpa)
            library_device_ms = (busy := self.device_busy_ms(sdpa, names=())) and busy["total"]
        # Bound: q, the keys and values some row sees, and the output, each
        # moved once; 4·D flops per live (query, key) pair.
        nbytes = (2 * q.numel() + 2 * b * hkv * len(seen) * d) * q.element_size()
        flops = 4 * b * hq * int(n_keys.sum()) * d
        peak = BF16_OPS_PER_S if q.dtype == torch.bfloat16 else F32_OPS_PER_S
        bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ops = flops / peak * 1e3

        def call():
            return flash_attention(q, k, v, q_offset=q_offset, **kw)

        busy = self.device_busy_ms(call, names=K4_KERNELS,
                                   expect=2 if form == "bf16-decode" else 1)
        device_ms, device_ms_by = busy and busy["total"], "profiler"
        if device_ms is None:  # the profiler recorded too few launches
            device_ms, device_ms_by = self.graph_replay_ms(call), "graph replay"
        self.record(
            key, kernel="flash_attention", form=form, splits=splits,
            shape=[list(q.shape), list(k.shape), str(q.dtype).split(".")[-1]],
            q_offset=q_offset, window=window, softcap=softcap, max_abs_err=err,
            max_tol=float(tol.max()), ms=self.time_ms(call),
            device_ms=device_ms, device_ms_by=device_ms_by,
            plain_ms=self.time_ms(lambda: attention_ref(q, k, v, q_offset=q_offset, **kw)),
            library_ms=library_ms, library_device_ms=library_device_ms,
            bound_ms=max(bound_bytes, bound_ops),
            bound_by="bytes" if bound_bytes >= bound_ops else "operations",
            peak_ops_per_s=peak,
        )

    def kernel_attention_at(self, key, q, k, v, offsets, *, window=None, softcap=0.0,
                            timed=False):
        """K4's decode form with the offset read from device memory (one
        0-d int32 tensor, refilled for each offset) at a decode shape of the
        captured path, over the whole cache: at each offset held against
        ``attention_ref`` and ``flash_decode_plain`` (on the same device
        offset, the static split) within ``attention_tolerance``, which a zero
        output must fail; the grid is static and each offset's live tiles
        spread over it, so where they are fewer than the splits the last
        splits are empty.  With ``timed``, each offset's device ms beside
        the host offset's (the split sized from the live tiles).  The first
        offset (the path's last step) is recorded with its times and bound,
        as ``kernel_attention`` records a row; with ``key`` None nothing is
        recorded and the offsets' checks are returned."""
        torch = self.torch
        from repro_torch.kernels import _build
        from repro_torch.kernels import flash_attention as FA
        from repro_torch.kernels.ref import attention_ref

        flash_attention = FA.flash_attention
        kw = dict(causal=True, window=window, softcap=softcap)
        b, hq, sq, d = q.shape
        hkv, skv = k.shape[1], k.shape[2]
        splits, _ = FA.decode_splits(b, hkv, FA.static_tiles(sq, skv, window),
                                     _build.sm_count(q.device.index))
        at = torch.zeros((), dtype=torch.int32, device=self.dev)
        checks = []
        for off in offsets:
            at.fill_(off)
            before = dict(flash_attention.forms)
            got = flash_attention(q, k, v, q_offset=at, **kw)
            if flash_attention.forms["bf16-decode"] != before["bf16-decode"] + 1:
                raise AssertionError(f"{key}: the call did not take the decode form")
            want = attention_ref(q, k, v, q_offset=off, **kw)
            kpos = torch.arange(skv, device=self.dev)[None, :]
            qpos = torch.arange(sq, device=self.dev)[:, None] + off
            live = kpos <= qpos
            if window is not None:
                live &= kpos > qpos - window
            n_keys = live.sum(1)
            tol = attention_tolerance(q, k, v, want, n_keys[None, None, :, None].double(),
                                      q_offset=off, **kw)
            plain = FA.flash_decode_plain(q, k, v, splits=splits, q_offset=at, **kw)
            self.sync()
            errs = {}
            for what, other in (("attention_ref", want), ("flash_decode_plain", plain)):
                err = (got.float() - other.float()).abs()
                errs[what] = float(err.max())
                if not bool((err <= tol).all()) or bool(got.isnan().any()):
                    raise AssertionError(f"{key} at offset {off}: max abs error {errs[what]} "
                                         f"against {what} over tolerance")
            if bool(((torch.zeros_like(got).float() - want.float()).abs() <= tol).all()):
                raise AssertionError(f"{key} at offset {off}: a zero output passed the check")
            t_lo, t_hi = FA.key_tiles(sq, skv, off, True, window)
            live_per = max(1, -(-(t_hi - t_lo) // splits))  # the kernel's, from the offset
            checks.append({"q_offset": off, "live_tiles": t_hi - t_lo,
                           "splits": splits, "tiles_per_split": live_per,
                           "empty_splits": sum(i * live_per >= t_hi - t_lo
                                               for i in range(splits)),
                           "max_abs_err": errs["attention_ref"],
                           "vs_plain": errs["flash_decode_plain"]})
            if timed:
                for what, o in (("device_ms", at), ("host_offset_device_ms", off)):
                    busy = self.device_busy_ms(
                        lambda o=o: flash_attention(q, k, v, q_offset=o, **kw),
                        names=K4_KERNELS, expect=2)
                    checks[-1][what] = busy and busy["total"]
        if key is None:
            return checks
        off = offsets[0]
        at.fill_(off)
        qpos = torch.arange(sq, device=self.dev)[:, None] + off
        kpos = torch.arange(skv, device=self.dev)[None, :]
        live = kpos <= qpos
        if window is not None:
            live &= kpos > qpos - window
        library_ms = library_device_ms = None
        if softcap == 0.0:
            import torch.nn.functional as F

            def sdpa():
                return F.scaled_dot_product_attention(q, k, v, attn_mask=live, enable_gqa=True)

            library_ms = self.time_ms(sdpa)
            library_device_ms = (busy := self.device_busy_ms(sdpa, names=())) and busy["total"]
        seen = int(live.any(0).sum())
        nbytes = (2 * q.numel() + 2 * b * hkv * seen * d) * q.element_size()
        flops = 4 * b * hq * int(live.sum()) * d
        bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ops = flops / BF16_OPS_PER_S * 1e3
        self.record(
            key, kernel="flash_attention", form="bf16-decode", offset="device",
            splits=splits, shape=[list(q.shape), list(k.shape), str(q.dtype).split(".")[-1]],
            q_offset=off, window=window, softcap=softcap,
            max_abs_err=max(c["max_abs_err"] for c in checks), offsets=checks,
            ms=self.time_ms(lambda: flash_attention(q, k, v, q_offset=at, **kw)),
            device_ms=(busy := self.device_busy_ms(
                lambda: flash_attention(q, k, v, q_offset=at, **kw),
                names=K4_KERNELS, expect=2)) and busy["total"],
            plain_ms=self.time_ms(lambda: attention_ref(q, k, v, q_offset=off, **kw)),
            library_ms=library_ms, library_device_ms=library_device_ms,
            bound_ms=max(bound_bytes, bound_ops),
            bound_by="bytes" if bound_bytes >= bound_ops else "operations",
            peak_ops_per_s=BF16_OPS_PER_S)

    def attention_phase(self):
        """K4 at the LM path's shapes: qwen3-0.6b's prefill (q ``[8, 16, 512,
        128]`` bf16 against the ``[8, 545, 8, 128]`` KV cache, offset 0) and
        decode (one query at offset 543), both reading the cache in place;
        zamba2-7b's (q ``[8, 32, 512, 112]`` over ``[8, 545, 32, 112]``, then
        one query at offset 543); gemma2-9b's local layer (``[1, 16, 2048,
        256]``, Hkv 8, window 1024, softcap 50) in f32 and bf16, and its bf16
        decode (one query at offset 2047 over the same keys); mixtral-8x22b's
        prefill and decode (q ``[8, 48, 512, 128]``, then one query at offset
        543, over ``[8, 545, 8, 128]``, window 4096), its window run's prefill
        (q ``[1, 48, 4608, 128]`` over the 4625-row cache) and last decode
        step (one query at offset 4096 over the view of rows 527–4623);
        grok-1-314b's (mixtral's shapes, no window); qwen2-vl-2b's (q ``[8,
        12, 512, 128]`` over ``[8, 545, 2, 128]``, then one query at offset
        543); musicgen-medium's (q ``[8, 24, 512, 64]`` over ``[8, 545, 24,
        64]``, then one query at offset 543).  The decode form with its offset
        on the device (``kernel_attention_at``) at the captured path's qwen3,
        zamba2, mixtral window run and gemma2 local decode shapes, over the
        whole cache; and at qwen3's heads over a 32768-row cache (batch 8 and
        1, offsets 4095 and 32767), its device ms beside the host offset's.
        Then the dense models' rows (``attention_dense_rows``)."""
        torch = self.torch
        g = torch.Generator(device=self.dev).manual_seed(0)

        def randn(*shape, dtype):
            return torch.randn(shape, generator=g, device=self.dev).to(dtype)

        bf16 = torch.bfloat16
        ck = randn(8, 545, 8, 128, dtype=bf16)  # [B, S_max, Hkv, D], as cached
        cv = randn(8, 545, 8, 128, dtype=bf16)
        q = randn(8, 512, 16, 128, dtype=bf16).transpose(1, 2)
        self.kernel_attention("flash_attention@qwen3-prefill", q, ck.transpose(1, 2),
                              cv.transpose(1, 2), q_offset=0)
        q = randn(8, 1, 16, 128, dtype=bf16).transpose(1, 2)
        self.kernel_attention("flash_attention@qwen3-decode", q, ck.transpose(1, 2),
                              cv.transpose(1, 2), q_offset=543)
        self.kernel_attention_at("flash_attention@qwen3-decode-at", q, ck.transpose(1, 2),
                                 cv.transpose(1, 2), (543, 100, 0))
        # qwen3's heads over a 32768-row cache, at an early offset (64 live
        # tiles of the grid's 512) and the last: the device offset's time
        # beside the host offset's, at batch 8 and 1
        del ck, cv
        for b in (8, 1):
            ck = randn(b, 32768, 8, 128, dtype=bf16)
            cv = randn(b, 32768, 8, 128, dtype=bf16)
            q = randn(b, 1, 16, 128, dtype=bf16).transpose(1, 2)
            self.record(f"flash_attention@qwen3-decode-at 32k cache b{b}",
                        offsets=self.kernel_attention_at(
                            None, q, ck.transpose(1, 2), cv.transpose(1, 2), (4095, 32767),
                            timed=True))
            del ck, cv, q
        # zamba2-7b's shared attention: 32 heads of 112 (MHA) over its cache
        ck = randn(8, 545, 32, 112, dtype=bf16)
        cv = randn(8, 545, 32, 112, dtype=bf16)
        q = randn(8, 512, 32, 112, dtype=bf16).transpose(1, 2)
        self.kernel_attention("flash_attention@zamba2-prefill", q, ck.transpose(1, 2),
                              cv.transpose(1, 2), q_offset=0)
        q = randn(8, 1, 32, 112, dtype=bf16).transpose(1, 2)
        self.kernel_attention("flash_attention@zamba2-decode", q, ck.transpose(1, 2),
                              cv.transpose(1, 2), q_offset=543)
        self.kernel_attention_at("flash_attention@zamba2-decode-at", q, ck.transpose(1, 2),
                                 cv.transpose(1, 2), (543, 64))
        del ck, cv, q
        for dtype in (torch.float32, bf16):
            q = randn(1, 16, 2048, 256, dtype=dtype)
            k = randn(1, 8, 2048, 256, dtype=dtype)
            v = randn(1, 8, 2048, 256, dtype=dtype)
            name = "f32" if dtype == torch.float32 else "bf16"
            self.kernel_attention(f"flash_attention@gemma2-local {name}", q, k, v,
                                  q_offset=0, window=1024, softcap=50.0)
        self.kernel_attention("flash_attention@gemma2-local-decode bf16", q[:, :, -1:],
                              k, v, q_offset=2047, window=1024, softcap=50.0)
        self.kernel_attention_at("flash_attention@gemma2-local-decode-at bf16",
                                 q[:, :, -1:], k, v, (2047, 1100, 500), window=1024,
                                 softcap=50.0)
        del q, k, v
        # mixtral-8x22b: 48 query heads over 8 kv heads of 128, window 4096
        ck = randn(8, 545, 8, 128, dtype=bf16)
        cv = randn(8, 545, 8, 128, dtype=bf16)
        q = randn(8, 512, 48, 128, dtype=bf16).transpose(1, 2)
        self.kernel_attention("flash_attention@mixtral-prefill", q, ck.transpose(1, 2),
                              cv.transpose(1, 2), q_offset=0, window=4096)
        q = randn(8, 1, 48, 128, dtype=bf16).transpose(1, 2)
        self.kernel_attention("flash_attention@mixtral-decode", q, ck.transpose(1, 2),
                              cv.transpose(1, 2), q_offset=543, window=4096)
        # grok-1-314b: the same heads with no window
        q = randn(8, 512, 48, 128, dtype=bf16).transpose(1, 2)
        self.kernel_attention("flash_attention@grok-prefill", q, ck.transpose(1, 2),
                              cv.transpose(1, 2), q_offset=0)
        q = randn(8, 1, 48, 128, dtype=bf16).transpose(1, 2)
        self.kernel_attention("flash_attention@grok-decode", q, ck.transpose(1, 2),
                              cv.transpose(1, 2), q_offset=543)
        # qwen2-vl-2b: 12 query heads over 2 kv heads of 128
        ck = randn(8, 545, 2, 128, dtype=bf16)
        cv = randn(8, 545, 2, 128, dtype=bf16)
        q = randn(8, 512, 12, 128, dtype=bf16).transpose(1, 2)
        self.kernel_attention("flash_attention@qwen2vl-prefill", q, ck.transpose(1, 2),
                              cv.transpose(1, 2), q_offset=0)
        q = randn(8, 1, 12, 128, dtype=bf16).transpose(1, 2)
        self.kernel_attention("flash_attention@qwen2vl-decode", q, ck.transpose(1, 2),
                              cv.transpose(1, 2), q_offset=543)
        # its window run: a 4608-token prompt in a 4625-row cache, then the
        # last step's view of the window + 1 rows it may see (start 527)
        b, plen, steps = WINDOW_RUN
        rows = plen + steps + 1
        ck = randn(b, rows, 8, 128, dtype=bf16)
        cv = randn(b, rows, 8, 128, dtype=bf16)
        q = randn(b, plen, 48, 128, dtype=bf16).transpose(1, 2)
        self.kernel_attention("flash_attention@mixtral-window-prefill", q,
                              ck.transpose(1, 2), cv.transpose(1, 2), q_offset=0,
                              window=4096)
        start = plen + steps - 1 + 1 - 4097
        q = randn(b, 1, 48, 128, dtype=bf16).transpose(1, 2)
        self.kernel_attention("flash_attention@mixtral-window-decode", q,
                              ck[:, start:start + 4097].transpose(1, 2),
                              cv[:, start:start + 4097].transpose(1, 2), q_offset=4096,
                              window=4096)
        # the captured step's call: the whole cache, the offset on the device
        self.kernel_attention_at("flash_attention@mixtral-window-decode-at", q,
                                 ck.transpose(1, 2), cv.transpose(1, 2),
                                 (plen + steps - 1, 4200, 1000), window=4096)
        # musicgen-medium: 24 MHA heads of 64
        ck = randn(8, 545, 24, 64, dtype=bf16)
        cv = randn(8, 545, 24, 64, dtype=bf16)
        q = randn(8, 512, 24, 64, dtype=bf16).transpose(1, 2)
        self.kernel_attention("flash_attention@musicgen-prefill", q, ck.transpose(1, 2),
                              cv.transpose(1, 2), q_offset=0)
        q = randn(8, 1, 24, 64, dtype=bf16).transpose(1, 2)
        self.kernel_attention("flash_attention@musicgen-decode", q, ck.transpose(1, 2),
                              cv.transpose(1, 2), q_offset=543)
        del ck, cv, q
        self.attention_dense_rows()
        torch.cuda.empty_cache()

    def attention_dense_rows(self):
        """K4 at the shapes of the dense models served at full depth:
        stablelm-3b's prefill (q ``[8, 32, 512, 80]`` over ``[8, 545, 32,
        80]``), starcoder2-15b's (q ``[8, 48, 512, 128]`` over ``[8, 545, 4,
        128]``) and gemma2-9b's (q ``[8, 16, 512, 256]`` over ``[8, 545, 8,
        256]``, window 4096, softcap 50), each with its decode at offset 543
        and its captured decode (the offset on the device, over the whole
        cache); gemma2's window run: the prefill (q ``[1, 16, 4608, 256]``
        over the 4625-row cache) local and global, the eager local decode
        over the view of rows 527–4623, and the captured decode over the
        whole cache, local and global."""
        torch = self.torch
        g = torch.Generator(device=self.dev).manual_seed(0)

        def randn(*shape, dtype):
            return torch.randn(shape, generator=g, device=self.dev).to(dtype)

        bf16 = torch.bfloat16
        # the dense models served at full depth: stablelm-3b (32 MHA heads of
        # 80: the prefill pads D to 128, the decode to 96), starcoder2-15b
        # (48 query heads over 4 kv heads: 12 rows a kv head in the decode
        # form) and gemma2-9b (16 over 8 heads of 256, softcap 50; its local
        # layers' window of 4096 masks nothing in 545 rows), each prefill,
        # the eager run's decode at offset 543 and the captured step's over
        # the whole cache with the offset on the device
        for name, hq, hkv, d, window, cap in (("stablelm", 32, 32, 80, None, 0.0),
                                              ("starcoder2", 48, 4, 128, None, 0.0),
                                              ("gemma2", 16, 8, 256, 4096, 50.0)):
            ck = randn(8, 545, hkv, d, dtype=bf16)
            cv = randn(8, 545, hkv, d, dtype=bf16)
            q = randn(8, 512, hq, d, dtype=bf16).transpose(1, 2)
            self.kernel_attention(f"flash_attention@{name}-prefill", q, ck.transpose(1, 2),
                                  cv.transpose(1, 2), q_offset=0, window=window, softcap=cap)
            q = randn(8, 1, hq, d, dtype=bf16).transpose(1, 2)
            self.kernel_attention(f"flash_attention@{name}-decode", q, ck.transpose(1, 2),
                                  cv.transpose(1, 2), q_offset=543, window=window,
                                  softcap=cap)
            self.kernel_attention_at(f"flash_attention@{name}-decode-at", q,
                                     ck.transpose(1, 2), cv.transpose(1, 2), (543, 100, 0),
                                     window=window, softcap=cap)
        # gemma2-9b's window run: the 4608-token prompt in a 4625-row cache,
        # local (window 4096) and global; the eager run's local decode over
        # the view of the window + 1 rows (start 527); the captured step's
        # over the whole cache, local and global
        b, plen, steps = WINDOW_RUN
        rows = plen + steps + 1
        ck = randn(b, rows, 8, 256, dtype=bf16)
        cv = randn(b, rows, 8, 256, dtype=bf16)
        q = randn(b, plen, 16, 256, dtype=bf16).transpose(1, 2)
        for name, window in (("gemma2-window-prefill", 4096),
                             ("gemma2-window-global-prefill", None)):
            self.kernel_attention(f"flash_attention@{name}", q, ck.transpose(1, 2),
                                  cv.transpose(1, 2), q_offset=0, window=window,
                                  softcap=50.0)
        start = plen + steps - 1 + 1 - 4097
        q = randn(b, 1, 16, 256, dtype=bf16).transpose(1, 2)
        self.kernel_attention("flash_attention@gemma2-window-decode", q,
                              ck[:, start:start + 4097].transpose(1, 2),
                              cv[:, start:start + 4097].transpose(1, 2), q_offset=4096,
                              window=4096, softcap=50.0)
        for name, window in (("gemma2-window-decode-at", 4096),
                             ("gemma2-window-global-decode-at", None)):
            self.kernel_attention_at(f"flash_attention@{name}", q, ck.transpose(1, 2),
                                     cv.transpose(1, 2), (plen + steps - 1, 4200, 1000),
                                     window=window, softcap=50.0)
        del ck, cv, q

    # -- K4's "dh" form -----------------------------------------------------

    def kernel_dh(self, key, q, ck, cv, n_slices, *, start=0, window=None, softcap=0.0):
        """K4's ``"dh"`` form at one shape of the sharded decode path (module
        docstring): ``q [B, Hq, Sq, D]`` and a cache ``ck, cv [B, S, Hkv, D]``
        whose rows ``[start, S)`` the step reads, query row ``i`` at ``S -
        start - Sq + i``; ``d_head`` split by hand into ``n_slices`` ranks'
        contiguous shards ``[B, S, Hkv, D / n_slices]``, each read through
        its transposed view.  ``dh_logits`` on each shard, the partial logits
        summed in f32 (the all-reduce), ``dh_softmax_pv`` on each, the slices
        concatenated and held to ``attention_ref`` on the whole tensors within
        ``attention_tolerance``; a zero output, the sum with one slice's
        partial left out, and the last live 64-key block dropped (a lost
        split) must all fail; every call takes the ring form (one launch
        each, counted by form), and ``dh_softmax_pv``'s output is held to
        ``dh_softmax_pv_tiled`` within twice the tolerance (module
        docstring).
        Records a row per kernel: kernel and device
        times on one shard, bound, the plain function's time on one shard;
        for ``dh_logits`` the library's time, one ``torch.baddbmm(...,
        out_dtype=torch.float32, beta=0, alpha=scale)`` over contiguous
        copies of the shard's q and k (made outside the timing; its result
        held to the kernel's within ``DH_LIBRARY_TOL``); none computes
        ``dh_softmax_pv``'s (a softcap over summed logits)."""
        torch = self.torch
        from repro_torch.kernels import flash_attention as FA
        from repro_torch.kernels.ref import (
            attention_from_logits,
            attention_logits,
            attention_ref,
        )

        b, hq, sq, d = q.shape
        hkv, skv = ck.shape[2], ck.shape[1] - start
        dl, scale = d // n_slices, 1.0 / d ** 0.5
        off = skv - sq
        kw = dict(causal=True, window=window, softcap=softcap, q_offset=off)
        qpos = torch.arange(sq, device=self.dev)[:, None] + off
        kpos = torch.arange(skv, device=self.dev)[None, :]
        live = kpos <= qpos
        if window is not None:
            live &= kpos > qpos - window
        seen = live.any(0).nonzero()[:, 0]
        hi = int(seen[-1]) // 64 * 64  # the last live 64-key block starts here
        if int(seen[-1]) + 1 - hi < 32:  # a block of a few keys (a window's edge)
            hi = int(seen[-1]) + 1 - 64  # the last 64 live keys instead
        # That block's keys doubled: rows attend to it as a decode step attends
        # to a recent block, so losing it moves the output past the tolerance.
        ck[:, start + hi:start + int(seen[-1]) + 1] *= 2
        # each rank's cache shard [B, S, Hkv, Dl], read from row `start` as
        # [B, Hkv, S - start, Dl] in place, as the model reads it
        sl = [slice(i * dl, (i + 1) * dl) for i in range(n_slices)]
        shards = [(q[..., s], ck[..., s].contiguous()[:, start:].transpose(1, 2),
                   cv[..., s].contiguous()[:, start:].transpose(1, 2)) for s in sl]

        def summed(drop=None):
            total = None
            for i, (qs, ks, _) in enumerate(shards):
                if i != drop:
                    part = FA.dh_logits(qs, ks, scale)
                    total = part if total is None else total.add_(part)
            return total

        def outputs(logits, keys=None):
            return torch.cat([FA.dh_softmax_pv(logits[..., :keys], vs[:, :, :keys], **kw)
                              for _, _, vs in shards], -1)

        wrappers = {name: getattr(FA, name) for name in ("dh_logits", "dh_softmax_pv")}
        before = {name: (fn.launches, dict(fn.forms)) for name, fn in wrappers.items()}
        logits = summed()
        got = outputs(logits)
        forms = {}
        for name, fn in wrappers.items():
            forms[name] = {f: n - before[name][1][f] for f, n in fn.forms.items()}
            ran = n_slices if self.dev.type == "cuda" else 0  # the CPU runs the plain pair
            if (fn.launches - before[name][0], forms[name]) != (
                    ran, {"ring": ran, "element": 0}):
                raise AssertionError(f"{key}: {name} launched {fn.launches - before[name][0]} "
                                     f"times by form {forms[name]}, not {n_slices} ring")
        k_all, v_all = ck[:, start:].transpose(1, 2), cv[:, start:].transpose(1, 2)
        want = attention_ref(q, k_all, v_all, **kw)
        self.sync()
        n_keys = live.sum(1)
        tol = attention_tolerance(q, k_all, v_all, want,
                                  n_keys[None, None, :, None].double(), **kw)

        def check(what, out, must_fail=False):
            err = (out.float() - want.float()).abs()
            ok = bool((err <= tol).all()) and not bool(out.isnan().any())
            if must_fail and ok:
                raise AssertionError(f"{what}: a wrong result passed the check")
            if not must_fail and not ok:
                raise AssertionError(f"{what}: max abs error {float(err.max())} over "
                                     f"tolerance (max {float(tol.max())})")
            return float(err.max())

        err = check(key, got)
        # the kernel's arithmetic in plain PyTorch, its own splits: both
        # within tol of the exact output, so within 2·tol of each other
        from repro_torch.kernels._build import sm_count
        sms = sm_count(self.dev.index or 0) if self.dev.type == "cuda" else 132
        tiled = torch.cat([FA.dh_softmax_pv_tiled(logits, vs, sm_count=sms, **kw)
                           for _, _, vs in shards], -1)
        tiled_err = float((got.float() - tiled.float()).abs().max())
        if not bool(((got.float() - tiled.float()).abs() <= 2 * tol).all()):
            raise AssertionError(f"{key}: dh_softmax_pv differs from dh_softmax_pv_tiled by "
                                 f"{tiled_err}, over twice the tolerance")
        del tiled
        check(key + " zeros", torch.zeros_like(got), must_fail=True)
        check(key + " one slice's partial left out", outputs(summed(drop=n_slices - 1)),
              must_fail=True)
        check(key + " last key block dropped", outputs(logits, keys=hi), must_fail=True)
        self.sync()
        del want, tol, k_all, v_all

        qs, ks, vs = shards[0]
        es = q.element_size()
        n_live = len(seen)
        pairs = int(n_keys.sum())
        # the library's partial logits: per (batch row, kv head) one product
        # of its rep·Sq query rows [rep·Sq, Dl] by its keys [Dl, Skv], in f32
        lib_q = qs.contiguous().view(b * hkv, hq // hkv * sq, dl)
        lib_k = ks.contiguous().view(b * hkv, skv, dl).transpose(1, 2)
        lib_out = torch.empty((b * hkv, hq // hkv * sq, skv), device=self.dev)

        def library_logits():
            return torch.baddbmm(lib_out, lib_q, lib_k, out_dtype=torch.float32, beta=0,
                                 alpha=scale)

        lib_err = float((library_logits().view(b, hq, sq, skv)
                         - FA.dh_logits(qs, ks, scale)).abs().max())
        if not lib_err <= DH_LIBRARY_TOL:
            raise AssertionError(f"{key}: the library's partial logits differ from "
                                 f"dh_logits' by {lib_err} (over {DH_LIBRARY_TOL})")
        rows = {
            "dh_logits": (
                lambda: FA.dh_logits(qs, ks, scale),
                lambda: attention_logits(qs, ks, scale), library_logits,
                (b * hq * sq * dl + b * hkv * skv * dl) * es + b * hq * sq * skv * 4,
                2 * b * hq * sq * skv * dl, 1),
            "dh_softmax_pv": (
                lambda: FA.dh_softmax_pv(logits, vs, **kw),
                lambda: attention_from_logits(logits, vs, q.dtype, **kw), None,
                b * hq * sq * n_live * 4 + (b * hkv * n_live + b * hq * sq) * dl * es,
                2 * b * hq * pairs * dl, 1),
        }
        for kernel, (fn, plain, library, nbytes, flops, launches) in rows.items():
            bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            bound_ops = flops / F32_OPS_PER_S * 1e3
            busy = self.device_busy_ms(fn, names=DH_KERNELS, expect=launches)
            self.record(
                f"{kernel}@{key}", kernel=kernel, form="dh",
                shape=[list(q.shape), [b, hkv, skv, d], str(q.dtype).split(".")[-1]],
                slices=n_slices, d_slice=dl, q_offset=off, window=window, softcap=softcap,
                dh_forms=forms[kernel], max_abs_err=err,
                **({"tiled_max_abs_diff": tiled_err} if kernel == "dh_softmax_pv" else {}),
                ms=self.time_ms(fn), device_ms=busy and busy["total"],
                plain_ms=self.time_ms(plain),
                library_ms=library and self.time_ms(library),
                library_device_ms=library and (
                    lib_busy := self.device_busy_ms(library, names=())) and lib_busy["total"],
                **({"library_max_abs_diff": lib_err} if library else {}),
                bound_ms=max(bound_bytes, bound_ops),
                bound_by="bytes" if bound_bytes >= bound_ops else "operations",
                peak_ops_per_s=F32_OPS_PER_S)

    def dh_phase(self):
        """K4's ``"dh"`` form at the sharded decode path's shapes on rank 0 of
        the 16 × 16 mesh (module docstring), local batch 8, bf16, ``d_head``
        split into the model axis's 16 slices: gemma2-9b's global layer (q
        ``[8, 16, 1, 256]`` over a 32768-row cache of 8 kv heads, softcap 50)
        and local layer (the last 4097 rows, window 4096, offset 4096),
        qwen3-0.6b's (``[8, 16, 1, 128]``, 8 kv heads) and musicgen-medium's
        (``[8, 24, 1, 64]``, 24 kv heads), each query scaled by 3 (peaked
        weights, as a trained model's are)."""
        torch = self.torch
        g = torch.Generator(device=self.dev).manual_seed(3)

        def randn(*shape):
            return torch.randn(shape, generator=g, device=self.dev).to(torch.bfloat16)

        for key, hq, hkv, d, start, window, softcap in (
                ("gemma2-global", 16, 8, 256, 0, None, 50.0),
                ("gemma2-local", 16, 8, 256, 32768 - 4097, 4096, 50.0),
                ("qwen3", 16, 8, 128, 0, None, 0.0),
                ("musicgen", 24, 24, 64, 0, None, 0.0)):
            ck, cv = randn(8, 32768, hkv, d), randn(8, 32768, hkv, d)
            q = (randn(8, 1, hq, d) * 3).transpose(1, 2)
            self.kernel_dh(key, q, ck, cv, 16, start=start, window=window, softcap=softcap)
            del ck, cv, q
            torch.cuda.empty_cache()

    # -- K5 and K6: the recurrent scans --------------------------------------

    def scan_check(self, key, got, plain, oracle, bound, bf16, wrong):
        """Hold ``got = (y, state)`` against the plain version's and the
        float64 oracle's within ``2^-7·|ref| + c·bound`` (``bound`` per
        element of each output, module docstring; c = 2.1 against the plain
        version, 1.1 against the oracle; the ``2^-7`` term for bf16 outputs
        only), and show that each check rejects every ``(y, state)`` in
        ``wrong``.  Returns the max abs errors and the largest
        error/tolerance ratios, of ``y`` and of the state."""
        def within(out, want, c):
            errs, ratios, fine = [], [], True
            for i, (o, w, bd) in enumerate(zip(out, want, bound)):
                tol = c * bd
                if i == 0 and bf16:
                    tol = tol + 2.0 ** -7 * w.double().abs()
                err = (o.double() - w.double()).abs()
                fine = fine and bool((err <= tol).all()) and not bool(o.isnan().any())
                errs.append(float(err.max()))
                ratios.append(float((err / tol.clamp(min=1e-300)).max()))
            return fine, errs, ratios

        res = {}
        for name, want, c in (("plain", plain, 2.1), ("oracle", oracle, 1.1)):
            fine, errs, ratios = within(got, want, c)
            if not fine:
                raise AssertionError(f"{key}: y and state off the {name} version by "
                                     f"{errs} (error/tolerance up to {ratios})")
            res[name] = {"y": errs[0], "state": errs[1], "err_over_tol": ratios}
            for what, out in wrong.items():
                if within(out, want, c)[0]:
                    raise AssertionError(f"{key}: {what} passed the check against the "
                                         f"{name} version")
        errs = within(plain, oracle, 1.1)[1]
        res["plain_vs_oracle"] = {"y": errs[0], "state": errs[1]}
        return res

    def record_scan(self, key, kernel, shape, errs, nbytes, flops, bf16, time_kernel,
                    time_plain, **extra):
        """Record a K5/K6 check with its times and its bound: ``nbytes`` and
        ``flops`` (the recurrence's 4 flops per state element a step) over
        the card's rates for the input type."""
        bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ops = flops / (BF16_OPS_PER_S if bf16 else F32_OPS_PER_S) * 1e3
        names = {"ssd_scan": K5_KERNELS, "rwkv6_scan": K6_KERNELS}[kernel]
        busy = self.device_busy_ms(time_kernel, names=names, expect=1)
        self.record(
            key, kernel=kernel, shape=shape, max_abs_err=errs["plain"]["y"], errors=errs,
            ms=self.time_ms(time_kernel), device_ms=busy and busy["total"],
            plain_ms=self.time_ms(time_plain),
            library_ms=None, bound_ms=max(bound_bytes, bound_ops),
            bound_by="bytes" if bound_bytes >= bound_ops else "operations",
            bytes=nbytes, flops=flops, **extra)

    def kernel_ssd(self, key, x, dt, a, bm, cm, h0):
        """K5 against ``ssd_scan_plain`` and the float64 ``ssd_ref`` at one
        shape of the zamba2 path; the checks must reject a zero output, the
        kernel's output with the state dropped at the middle chunk boundary
        (decode: from a zero state), and the kernel's output with the heads
        of fast decay (``|a| >= 8``) scaled by 1.05.  Returns the final
        state."""
        torch = self.torch
        from repro_torch.kernels.ref import ssd_ref
        from repro_torch.kernels.ssd_scan import form, ssd_scan, ssd_scan_plain

        b, s, h, p = x.shape
        n = bm.shape[3]
        got = ssd_scan(x, dt, a, bm, cm, init_state=h0)
        plain = ssd_scan_plain(x, dt, a, bm, cm, init_state=h0)
        f64 = [t.double() for t in (x, dt, a, bm, cm, h0)]
        oracle = ssd_ref(*f64[:5], init_state=f64[5])
        if s > 1:
            m = s // 2
            y1, _ = ssd_scan(x[:, :m], dt[:, :m], a, bm[:, :m], cm[:, :m], init_state=h0)
            y2, h2 = ssd_scan(x[:, m:], dt[:, m:], a, bm[:, m:], cm[:, m:])
            dropped = (torch.cat([y1, y2], 1), h2)
        else:
            dropped = ssd_scan(x, dt, a, bm, cm)
        fast = 1.0 + 0.05 * (a.abs() >= 8).float()
        scaled = ((got[0].float() * fast[:, None]).to(got[0].dtype),
                  got[1] * fast[:, None, None])
        self.sync()
        bound, tau = ssd_bound(x, dt, a, bm, cm, h0, min(128, s))
        bf16 = x.dtype == torch.bfloat16
        errs = self.scan_check(key, got, plain, oracle, bound, bf16, {
            "a zero output": tuple(torch.zeros_like(t) for t in got),
            "the state dropped": dropped,
            "the fast-decay heads scaled by 1.05": scaled})
        del oracle, bound, dropped, scaled, f64
        nbytes = (2 * x.numel() * x.element_size() + dt.numel() * 4 + a.numel() * 4
                  + 2 * bm.numel() * bm.element_size() + 2 * h0.numel() * 4)
        self.record_scan(
            key, "ssd_scan", [list(x.shape), list(bm.shape), str(x.dtype).split(".")[-1]],
            errs, nbytes, 4 * b * s * h * p * n, bf16,
            lambda: ssd_scan(x, dt, a, bm, cm, init_state=h0),
            lambda: ssd_scan_plain(x, dt, a, bm, cm, init_state=h0),
            tau=tau, form=form(s))
        return got[1]

    def kernel_rwkv6(self, key, r, k, v, w, u, s0):
        """K6 against ``rwkv6_scan_plain`` and the float64 ``rwkv6_ref`` on
        the floored decay at one shape of the rwkv6 path (and, for the
        record, both against the floorless ``rwkv6_ref``); the checks must
        reject a zero output and the state dropped as for K5.  Returns the
        final state."""
        torch = self.torch
        from repro_torch.kernels.ref import rwkv6_ref
        from repro_torch.kernels.rwkv6_scan import (
            decay_floor, form, rwkv6_scan, rwkv6_scan_plain)

        b, s, h, kd = r.shape
        vd = v.shape[-1]
        before = dict(rwkv6_scan.forms)
        got = rwkv6_scan(r, k, v, w, u, init_state=s0)
        kind = next(f for f, n in rwkv6_scan.forms.items() if n != before[f])
        if kind != form(s):
            raise AssertionError(f"{key}: the call took the {kind} form")
        plain = rwkv6_scan_plain(r, k, v, w, u, init_state=s0)
        floor = decay_floor(64, s)
        clamped = int((torch.log(torch.clamp_min(w.double(), 1e-30)) < floor).sum())
        bound, tau, logw = rwkv6_bound(r, k, v, w, u, s0)
        f64 = [t.double() for t in (r, k, v, w, u, s0)]
        oracle = rwkv6_ref(*f64[:3], torch.exp(logw), f64[4], init_state=f64[5])
        floorless = rwkv6_ref(*f64[:5], init_state=f64[5])
        if s > 1:
            m = s // 2
            y1, _ = rwkv6_scan(r[:, :m], k[:, :m], v[:, :m], w[:, :m], u, init_state=s0)
            y2, s2 = rwkv6_scan(r[:, m:], k[:, m:], v[:, m:], w[:, m:], u)
            dropped = (torch.cat([y1, y2], 1), s2)
        else:
            dropped = rwkv6_scan(r, k, v, w, u)
        self.sync()
        bf16 = r.dtype == torch.bfloat16
        errs = self.scan_check(key, got, plain, oracle, bound, bf16, {
            "a zero output": tuple(torch.zeros_like(t) for t in got),
            "the state dropped": dropped})
        errs["floorless_oracle"] = {
            name: float((out[0].double() - floorless[0]).abs().max())
            for name, out in (("kernel", got), ("plain", plain))}
        del oracle, bound, floorless, dropped, f64, logw
        nbytes = ((r.numel() + k.numel() + 2 * v.numel()) * r.element_size()
                  + w.numel() * 4 + u.numel() * 4 + 2 * s0.numel() * 4)
        self.record_scan(
            key, "rwkv6_scan", [list(r.shape), list(v.shape), str(r.dtype).split(".")[-1]],
            errs, nbytes, 4 * b * s * h * kd * vd, bf16,
            lambda: rwkv6_scan(r, k, v, w, u, init_state=s0),
            lambda: rwkv6_scan_plain(r, k, v, w, u, init_state=s0),
            max_tau=float(tau.max()), floor=floor, floor_clamped=clamped, form=kind)
        return got[1]

    def scan_phase(self):
        """K5 at zamba2-7b's shapes: x ``[8, 512, 112, 64]``, B and C ``[8,
        512, 2, 64]`` bf16 as strided views of one ``[8, 512, 7424]`` conv
        output, ``dt = softplus(N(0, 1))`` f32 and ``a = −[1 … 16]`` as
        ``mamba_init`` sets it, from the zero state of a fresh cache (the
        prefill), then one step from the state it left (decode).  K6 at
        rwkv6-1.6b's: r, k, v ``[8, 512, 32, 64]`` bf16 ``N(0, 1)``, ``w =
        exp(−exp(−6 + 0.6·N(0, 1)))`` f32 (``w0 = −6`` plus the adapter's
        spread), ``u = 0.1·N(0, 1)``, likewise prefill then one step."""
        torch = self.torch
        g = torch.Generator(device=self.dev).manual_seed(1)
        bf16 = torch.bfloat16

        def randn(*shape):
            return torch.randn(shape, generator=g, device=self.dev)

        b, h, p, grp, n = 8, 112, 64, 2, 64
        a = -torch.exp(torch.log(torch.linspace(1.0, 16.0, h, device=self.dev)))
        state = torch.zeros((b, h, p, n), device=self.dev)
        for key, s in (("ssd_scan@zamba2-prefill", 512), ("ssd_scan@zamba2-decode", 1)):
            conv = randn(b, s, h * p + 2 * grp * n).to(bf16)
            x = conv[..., :h * p].unflatten(-1, (h, p))
            bm = conv[..., h * p:h * p + grp * n].unflatten(-1, (grp, n))
            cm = conv[..., h * p + grp * n:].unflatten(-1, (grp, n))
            dt = torch.nn.functional.softplus(randn(b, s, h))
            state = self.kernel_ssd(key, x, dt, a, bm, cm, state)
        b, h, kd = 8, 32, 64
        u = 0.1 * randn(h, kd)
        state = torch.zeros((b, h, kd, kd), device=self.dev)
        for key, s in (("rwkv6_scan@rwkv6-prefill", 512), ("rwkv6_scan@rwkv6-decode", 1)):
            r, k, v = (randn(b, s, h, kd).to(bf16) for _ in range(3))
            w = torch.exp(-torch.exp(-6.0 + 0.6 * randn(b, s, h, kd)))
            state = self.kernel_rwkv6(key, r, k, v, w, u, state)
        del state
        from repro_torch.kernels.rwkv6_scan import FORMS as K6_FORMS

        checked = {rec["form"] for rec in self.summary.values()
                   if rec.get("kernel") == "rwkv6_scan"}
        if checked != set(K6_FORMS):
            raise AssertionError(f"K6 forms checked: {sorted(checked)}, want {K6_FORMS}")
        torch.cuda.empty_cache()

    # -- path phase ---------------------------------------------------------

    def kernel_wrappers(self) -> dict:
        """The kernel wrappers by name (each counts its launches): K1-K6 and
        K4's "dh" form's two."""
        from repro_torch.kernels.flash_attention import dh_logits, dh_softmax_pv, flash_attention
        from repro_torch.kernels.hash_combine import hash_aggregate
        from repro_torch.kernels.kmeans_assign import kmeans_assign
        from repro_torch.kernels.rwkv6_scan import rwkv6_scan
        from repro_torch.kernels.segment_reduce import segment_reduce
        from repro_torch.kernels.ssd_scan import ssd_scan

        return {"segment_reduce": segment_reduce, "hash_aggregate": hash_aggregate,
                "kmeans_assign": kmeans_assign, "flash_attention": flash_attention,
                "dh_logits": dh_logits, "dh_softmax_pv": dh_softmax_pv,
                "ssd_scan": ssd_scan, "rwkv6_scan": rwkv6_scan}

    def zero_launch_counts(self):
        """Every wrapper's launch count to 0, K2's rounds and the counts by
        form too, and the LM decode and training graphs' captures and
        replays."""
        from repro_torch.launch import serve_lm
        from repro_torch.runtime import train_loop

        wrappers = self.kernel_wrappers()
        for fn_ in wrappers.values():
            fn_.launches = 0
        wrappers["hash_aggregate"].rounds.reset()
        for name in FORMED:
            wrappers[name].forms = dict.fromkeys(wrappers[name].forms, 0)
        serve_lm.stats.reset()
        train_loop.stats.reset()

    def read_launch_counts(self) -> dict:
        """Every wrapper's launch count, K2's rounds and the counts by form;
        under ``decode_graph`` the LM decode graphs' captures, replays and
        the launches those replays made (``serve_lm.stats``: no wrapper runs
        in a replay, so the wrappers do not count them); under
        ``train_graph`` the same of the training steps' graphs
        (``train_loop.stats``), and the launches their captures recorded
        (:func:`ran_launches`)."""
        from repro_torch.launch import serve_lm
        from repro_torch.runtime import train_loop

        wrappers = self.kernel_wrappers()
        launches = {name: fn_.launches for name, fn_ in wrappers.items()}
        launches["hash_aggregate rounds"] = int(wrappers["hash_aggregate"].rounds)
        for name in FORMED:
            launches[f"{name} forms"] = dict(wrappers[name].forms)
        st = serve_lm.stats
        launches["decode_graph"] = {"captures": st.captures, "replays": st.replays,
                                    "replay_launches": dict(st.replay_launches)}
        st = train_loop.stats
        launches["train_graph"] = {"captures": st.captures, "replays": st.replays,
                                   "replay_launches": dict(st.replay_launches),
                                   "capture_launches": dict(st.capture_launches)}
        return launches

    def drive(self, name, fn, units):
        """Run ``fn`` with the launch counts set to 0 just before; return its
        result, the wall time and the launches it made."""
        self.sync()
        self.zero_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        self.sync()
        wall = time.perf_counter() - t0
        launches = self.read_launch_counts()
        print(json.dumps({"path": name, "wall_s": wall, "units": units,
                          "units_per_s": units / wall, "launches": launches}),
              flush=True)
        return out, wall, launches

    def path_phase(self, data):
        torch = self.torch
        import numpy as np
        from repro_torch.core import BlazeSession
        from repro_torch.core.algorithms import estimate_pi, kmeans, pagerank, wordcount
        from repro_torch.core.algorithms.pi import handrolled_count

        sess = BlazeSession(device=self.dev)
        # wordcount: hash target, pre-shuffle combine + merge through K2
        lines = data["lines_np"]
        hm, _, wc_launch = self.drive(
            "wordcount", lambda: wordcount(lines, engine="pallas",
                                           vocab_size=data["vocab"], session=sess),
            int(lines.size))
        keys, vals = hm.items()
        got = np.zeros(data["vocab"], np.int64)
        got[keys] = vals
        tokens = data["tokens"]
        want = torch.bincount(tokens[tokens >= 0].long(), minlength=data["vocab"])
        if hm.total_overflow() or not np.array_equal(got, want.cpu().numpy()):
            raise AssertionError("wordcount differs from torch.bincount")
        self.path_launches["wordcount"] = wc_launch
        self.per_op["wordcount"] = got

        # PageRank: 5 iterations, both engines against a float64 reference
        edges_np, n_pages = data["edges_np"], data["n_pages"]
        pr, _, pr_launch = self.drive(
            "pagerank", lambda: pagerank(edges_np, n_pages, tol=0.0, max_iters=5,
                                         engine="pallas", session=sess),
            5 * len(edges_np))
        pe, _, _ = self.drive(
            "pagerank eager", lambda: pagerank(edges_np, n_pages, tol=0.0,
                                               max_iters=5, engine="eager",
                                               session=sess),
            5 * len(edges_np))
        ref, pr_tol, covered = self.pagerank_reference(data, 5, damping=0.85)
        pr_rel = {}
        for name, res in (("pallas", pr), ("eager", pe)):
            err = (torch.from_numpy(res.scores).to(self.dev).double() - ref).abs()
            pr_rel[name] = float((err / ref).max())
            if not bool((err <= pr_tol).all()):
                raise AssertionError(f"pagerank {name}: a page is over its tolerance")
        if pr.compiles != 3:
            raise AssertionError(f"pagerank: compiles {pr.compiles}")
        self.path_launches["pagerank"] = pr_launch
        self.per_op["pagerank"] = (pr.scores, ref, pr_tol)

        # k-means: 5 iterations, pallas against a float64-accumulated loop
        pts = data["points_np"]
        init = data["init_centers"].cpu().numpy()
        km, _, km_launch = self.drive(
            "kmeans", lambda: kmeans(pts, 5, init_centers=init, tol=0.0,
                                     max_iters=5, engine="pallas", session=sess),
            5 * len(pts))
        ref_c, ref_inertia = self.kmeans_reference(data["points"], data["init_centers"], 5)
        km_err = float(np.abs(km.centers - ref_c).max())
        if (km_err > 1e-4 or abs(km.inertia - ref_inertia) > 1e-4 * ref_inertia
                or km.compiles != 2):
            raise AssertionError(f"kmeans: centre error {km_err}, inertia "
                                 f"{km.inertia} vs {ref_inertia}")
        self.path_launches["kmeans"] = km_launch
        self.per_op["kmeans"] = (km, ref_c, ref_inertia)
        # The eager engine's f32 scatter-add, for the record (not checked).
        ke, _, _ = self.drive(
            "kmeans eager", lambda: kmeans(pts, 5, init_centers=init, tol=0.0,
                                           max_iters=5, engine="eager", session=sess),
            5 * len(pts))
        print(json.dumps({"kmeans_eager_centre_error": float(
            np.abs(ke.centers - ref_c).max())}), flush=True)

        # π: 2^30 samples, the static-key fast path, exact count
        n = data["pi_samples"]
        pi, _, _ = self.drive("pi", lambda: estimate_pi(n, engine="pallas",
                                                        session=sess), n)
        hand = 4.0 * handrolled_count(n, self.dev) / n
        if pi != hand:
            raise AssertionError("pi differs from the hand-rolled count")
        self.per_op["pi"] = (pi, hand)
        results = {
            "pagerank_max_rel_err": pr_rel,
            "pagerank_max_rel_tol": float((pr_tol / ref).max()),
            "pagerank_pages_covered": covered,
            "kmeans_centre_err": km_err,
            "kmeans_inertia": km.inertia, "pi": pi,
            "wordcount_distinct": int(len(keys)),
            "compiles": {"pagerank": pr.compiles, "kmeans": km.compiles},
        }
        results.update(self.fig6_path(sess, data))
        results.update(self.gmm_path(sess, data))
        results.update(self.knn_path(sess, data))
        print(json.dumps({"path_results": results}), flush=True)
        kernels = {"wordcount": "hash_aggregate", "kmeans fig6": "kmeans_assign",
                   "lm zamba2-7b": "ssd_scan", "lm rwkv6-1.6b": "rwkv6_scan",
                   "train qwen3-0.6b": "flash_attention",
                   **{f"lm {arch}": "flash_attention" for arch in (
                       "qwen3-0.6b", "gemma2-9b", "stablelm-3b", "starcoder2-15b",
                       *MOE_LAYERS, *EMBED_ARCHS)},
                   "lm mixtral window": "flash_attention", "lm gemma2 window": "flash_attention"}
        for name, launch in self.path_launches.items():
            kernel = kernels.get(name, "segment_reduce")
            if launch[kernel] == 0:
                raise AssertionError(f"{name} launched no {kernel}")

    def fig6_path(self, sess, data):
        """Fig. 6: the hand-fused assignment step (K3, through the kernel-ops
        entry point) against one ``map_reduce`` step (K1) on the same
        centres, then 5 Lloyd steps of each on the points already on the
        card, timed alike."""
        torch = self.torch
        import numpy as np
        from repro_torch.core import DistVector
        from repro_torch.core.algorithms.kmeans import assign_mapper
        from repro_torch.kernels import ops
        from repro_torch.kernels.kmeans_assign import near_ties
        from repro_torch.kernels.segment_reduce import segment_reduce_plain

        x, c0 = data["points"], data["init_centers"]
        n, d = x.shape
        k = c0.shape[0]
        pts_v = DistVector(x, n)

        def mr_step(c):
            target = torch.zeros((k, d + 1), dtype=torch.float32, device=self.dev)
            return sess.map_reduce(pts_v, assign_mapper, "sum", target,
                                   engine="pallas", env=c)

        a3, s3 = ops.kmeans_assign(x, c0, impl="auto")
        s1 = mr_step(c0)
        self.sync()
        # Tolerance: both kernels' float-sum bounds, plus the mass of every
        # point whose nearest centre the two distance formulas may decide
        # differently (such a point moves [x | 1] between two keys).
        x1 = torch.cat([x, torch.ones((n, 1), device=self.dev)], 1)
        abs_sum = segment_reduce_plain(a3, x1.abs(), k).double()
        m = self.kmeans_additions(a3, x, k) + self.segment_additions(a3, n, d + 1, k)
        ties = near_ties(x, c0, with_norm_x=True)
        tie_mass = x1[ties].abs().double().sum(0)
        tol = 1e-5 * s1.double().abs() + m.double() * F32_U * abs_sum + tie_mass
        err = (s3.double() - s1.double()).abs()
        if not bool((err <= tol).all()):
            raise AssertionError(f"fig6: K3 and map_reduce statistics differ by "
                                 f"{float(err.max())}")
        del x1, abs_sum

        def lloyd(step):
            def run():
                c = c0
                for _ in range(5):
                    s = step(c)
                    c = s[:, :d] / torch.clamp(s[:, d:], min=1.0)
                return c
            return run

        c3, _, launch = self.drive("kmeans fig6 hand-fused",
                                   lloyd(lambda c: ops.kmeans_assign(x, c)[1]), 5 * n)
        self.path_launches["kmeans fig6"] = launch
        self.per_op["kmeans fig6"] = c3
        c1, _, _ = self.drive("kmeans fig6 map_reduce", lloyd(mr_step), 5 * n)
        ref_c, _ = self.kmeans_reference(x, c0, 5)
        errs = [float(np.abs(c.cpu().numpy() - ref_c).max()) for c in (c3, c1)]
        if max(errs) > 1e-4:
            raise AssertionError(f"fig6: centre errors {errs} over 1e-4")
        return {"fig6_stats_err": float(err.max()), "fig6_near_ties": int(ties.sum()),
                "fig6_centre_err": {"hand_fused": errs[0], "map_reduce": errs[1]}}

    def gmm_path(self, sess, data):
        """Fig. 7: 5 EM rounds of ``gmm_em`` (pallas: K1 on ops 3–5), held
        against a float64 EM on the card; the eager engine for the record."""
        import numpy as np
        from repro_torch.core.algorithms import gmm_em

        pts, k = data["gmm_points_np"], data["gmm_k"]
        init = pts[:k].copy()
        g, _, launch = self.drive(
            "gmm", lambda: gmm_em(pts, k, init_mu=init, tol=0.0, max_iters=5,
                                  engine="pallas", session=sess), 5 * len(pts))
        self.path_launches["gmm"] = launch
        if g.compiles != 4 or g.iterations != 5:
            raise AssertionError(f"gmm: compiles {g.compiles}, rounds {g.iterations}")
        if launch["segment_reduce"] != 3 * 5:
            raise AssertionError(f"gmm: K1 launched {launch['segment_reduce']} "
                                 "times, not 3 per round")
        ge, _, _ = self.drive(
            "gmm eager", lambda: gmm_em(pts, k, init_mu=init, tol=0.0, max_iters=5,
                                        engine="eager", session=sess), 5 * len(pts))
        ref = self.gmm_reference(data["gmm_points"], k, 5)

        def errors(res):
            got = {"alpha": res.alpha, "mu": res.mu, "sigma": res.sigma}
            out = {name: float(np.abs(got[name] - ref[name]).max()) for name in got}
            out["ll_rel"] = abs(res.log_likelihood - ref["ll"]) / abs(ref["ll"])
            return out

        err = errors(g)
        if (err["ll_rel"] > 1e-5 or err["alpha"] > 1e-4
                or max(err["mu"], err["sigma"]) > 1e-3):
            raise AssertionError(f"gmm: errors {err} against the float64 EM")
        self.per_op["gmm"] = (g, ref, errors)
        return {"gmm_err": err, "gmm_eager_err": errors(ge),
                "gmm_log_likelihood": g.log_likelihood}

    def gmm_reference(self, x, k, iters, mu0=None):
        """EM by ``gmm_em_reference``'s update rules, in float64 on the card,
        from ``mu0`` as means (by default the first ``k`` points), unit
        covariances and equal weights."""
        torch = self.torch
        import math

        x = x.double()
        n, d = x.shape
        eye = torch.eye(d, dtype=torch.float64, device=self.dev)
        alpha = torch.full((k,), 1.0 / k, dtype=torch.float64, device=self.dev)
        mu = x[:k].clone() if mu0 is None else mu0.double()
        sigma = eye.repeat(k, 1, 1)
        for _ in range(iters):
            prec = torch.linalg.inv(sigma)
            logdet = torch.linalg.slogdet(sigma)[1]
            diff = x[:, None, :] - mu[None]
            maha = torch.einsum("nkd,kde,nke->nk", diff, prec, diff)
            logw = (-0.5 * (d * math.log(2 * math.pi) + logdet)[None] - 0.5 * maha
                    + torch.log(alpha)[None])
            ll = torch.logsumexp(logw, 1).sum()
            w = torch.softmax(logw, 1)
            nk = torch.clamp(w.sum(0), min=1e-8)
            mu = (w.T @ x) / nk[:, None]
            diff = x[:, None, :] - mu[None]
            sigma = (torch.einsum("nk,nkd,nke->kde", w, diff, diff) / nk[:, None, None]
                     + 1e-4 * eye)
            alpha = nk / n
        return {"alpha": alpha.cpu().numpy(), "mu": mu.cpu().numpy(),
                "sigma": sigma.cpu().numpy(), "ll": float(ll)}

    def knn_path(self, sess, data):
        """Fig. 8: 100 nearest neighbours of the origin by the ``topk``
        container, against a float64 ``torch.topk`` of every distance."""
        import numpy as np
        from repro_torch.core.algorithms import knn

        pts, k = data["knn_points_np"], 100
        q = np.zeros(pts.shape[1], np.float32)
        res, _, _ = self.drive("knn", lambda: knn(pts, q, k, session=sess), len(pts))
        want, want_rows, kth = self.knn_reference(data["knn_points"], q, k)
        got = np.sort(res.distances.astype(np.float64))
        rel = float((np.abs(got - want) / want).max())
        if rel > 1e-5:
            raise AssertionError(f"knn: distances off by {rel} relative")
        # Same neighbour set, except rows whose distance ties the k-th.
        got_rows = {tuple(r) for r in res.neighbors.tolist()}
        for row in got_rows ^ want_rows:
            if float(((np.asarray(row, np.float64) - q) ** 2).sum()) != kth:
                raise AssertionError("knn: a neighbour differs from the float64 top-k")
        self.per_op["knn"] = (res, want, want_rows, kth)
        return {"knn_dist_rel_err": rel, "knn_kth_distance": float(want[-1]),
                "knn_set_differences": len(got_rows ^ want_rows)}

    def knn_reference(self, x, q, k):
        """The ``k`` rows of ``x`` nearest to ``q`` by a float64
        ``torch.topk`` of every squared distance (summed a column at a time,
        so no float64 copy of ``x`` is made): their distances ascending, the
        rows as a set of tuples, and the k-th squared distance."""
        torch = self.torch

        d2 = torch.zeros(len(x), dtype=torch.float64, device=self.dev)
        for j, qj in enumerate(q.tolist()):
            d2 += (x[:, j].double() - qj) ** 2
        best = torch.topk(d2, k, largest=False)
        rows = {tuple(r) for r in x[best.indices].cpu().numpy().tolist()}
        return best.values.sqrt().cpu().numpy(), rows, float(best.values[-1])

    # -- program phase ------------------------------------------------------

    def program_job(self, name, prog, run, units):
        """Run ``run`` (a ``run_loop`` over ``prog`` from the job's initial
        state) twice through ``drive``, the carry reset before each: the
        first captures the graphs, the second only replays them and must
        launch no kernel outside them.  Prints both wall times, the second
        loop's dispatches and host syncs, the captures and replays, the
        plan's collectives an iteration, each graph's launches a replay, the
        largest capture's peak bytes and what all the graphs' shared pool
        reserved; returns the second run's result."""
        walls = []
        for i in range(2):
            prog.reset_carry()
            (out, info), wall, launch = self.drive(
                f"{name} program" + (" replay" if i else ""), run, units)
            walls.append(wall)
            if i == 0:
                first_launch = launch
        st = prog.stats
        eager = {k: launch[k] for k in ("segment_reduce", "hash_aggregate", "kmeans_assign")}
        if not (st.captures >= 1 and st.replays == st.dispatches >= 2) or any(eager.values()):
            raise AssertionError(f"{name} program: {st.captures} captures, {st.replays} "
                                 f"replays of {st.dispatches} dispatches, launches "
                                 f"outside a graph on replay {eager}")
        print(json.dumps({"program": name, "wall_s_first": walls[0],
                          "wall_s_replay": walls[1], "dispatches": info.dispatches,
                          "host_syncs": info.host_syncs, "captures": st.captures,
                          "replays": st.replays,
                          "collectives_per_iter": prog.plan.collectives_per_iter,
                          "launches_per_replay": {str(u): la for u, la in
                                                  st.captured_launches.items()},
                          "pool_peak_bytes": st.pool_peak_bytes,
                          "pool_reserved_bytes": st.pool_reserved_bytes}), flush=True)
        self.program_launches[name] = dict(st.replay_launches)
        self.program_runs[name] = {"walls": walls, "first_launches": first_launch}
        return out

    def program_phase(self, data):
        """The six jobs and fig. 6's hand-fused k-means as programs
        (``session.program`` + ``run_loop``, ``engine="pallas"``, ``unroll``
        = the job's iterations) on the path phase's data, each dispatch a
        CUDA graph replay; each result held against the same reference as
        its per-op run and against the per-op result (module docstring)."""
        torch = self.torch
        import importlib
        import types

        import numpy as np
        from repro_torch.core import BlazeSession, DistVector
        from repro_torch.kernels import ops

        alg = {m: importlib.import_module("repro_torch.core.algorithms." + m)
               for m in ("gmm", "kmeans", "knn", "pagerank", "pi", "wordcount")}
        dev = self.dev
        results = {}

        def job(name, build, run, units, check):
            # kept for the tuning phase, which runs them as tuned programs
            self.program_specs[name] = (build, run, units, check)
            sess = BlazeSession(device=dev)
            prog, state = build(sess)
            out = self.program_job(name, prog, lambda: run(sess, prog, state), units)
            results[name] = check(out)
            del prog, state, out
            torch.cuda.empty_cache()

        # wordcount: the hash target's table threaded through the program
        lines = data["lines_np"]
        vocab = data["vocab"]

        def wc_build(sess, tune=False):
            hm = sess.make_dist_hashmap(max(64, 4 * vocab), (), torch.int32, "sum")
            step, state = alg["wordcount"]._program_step(
                DistVector(data["tokens"], lines.shape[0]), hm, vocab, "pallas")
            prog = sess.program(step, tune=tune)
            prog.target = hm
            return prog, state

        def wc_run(sess, prog, state):
            _, info = sess.run_loop(prog, state, max_iters=1)
            return prog.hash_result(prog.target), info

        def wc_check(hm):
            keys, vals = hm.items()
            got = np.zeros(vocab, np.int64)
            got[keys] = vals
            if hm.total_overflow() or not np.array_equal(got, self.per_op["wordcount"]):
                raise AssertionError("wordcount program differs from per-op")
            return {"distinct": int(len(keys))}

        job("wordcount", wc_build, wc_run, int(lines.size), wc_check)

        # PageRank: 5 iterations, one dispatch; sink and contribution batched
        n_pages, edges = data["n_pages"], data["edges"]
        scores0 = torch.full((n_pages,), 1.0 / n_pages, device=dev)

        def pr_build(sess, tune=False):
            step, state0 = alg["pagerank"]._program_step(
                DistVector(edges, edges.shape[0]), data["deg"], n_pages, 0.85, "pallas",
                "none")
            return sess.program(step, tune=tune), state0(scores0)

        def pr_run(sess, prog, state):
            return sess.run_loop(prog, state, cond=lambda s: float(s["delta"]) < 0.0,
                                 max_iters=5, unroll=5)

        def pr_check(out):
            per_op, ref, tol = self.per_op["pagerank"]
            got = out["scores"].double()
            if not bool(((got - ref).abs() <= tol).all()):
                raise AssertionError("pagerank program: a page is over its tolerance")
            d = (got - torch.from_numpy(per_op).to(dev).double()).abs()
            if not bool((d <= tol).all()):
                raise AssertionError("pagerank program differs from per-op")
            return {"max_rel_err": float(((got - ref).abs() / ref).max()),
                    "max_diff_per_op": float(d.max())}

        job("pagerank", pr_build, pr_run, 5 * edges.shape[0], pr_check)

        # k-means: 5 iterations in one dispatch, then the inertia probe
        pts, c0 = data["points"], data["init_centers"]

        def km_build(sess, tune=False):
            step, state0 = alg["kmeans"]._program_step(
                DistVector(pts, pts.shape[0]), c0.shape[0], pts.shape[1], "pallas", "none")
            return sess.program(step, tune=tune), state0(c0)

        def km_run(sess, prog, state):
            out, info = sess.run_loop(prog, state, cond=lambda s: float(s["move"]) < 0.0,
                                      max_iters=5, unroll=5)
            return (out["centers"], float(prog(out, 1)["inertia"])), info

        def km_check(out):
            centers, inertia = out[0].cpu().numpy(), out[1]
            km, ref_c, ref_inertia = self.per_op["kmeans"]
            errs = (float(np.abs(centers - ref_c).max()),
                    float(np.abs(centers - km.centers).max()))
            if (max(errs) > 1e-4 or abs(inertia - ref_inertia) > 1e-4 * ref_inertia
                    or abs(inertia - km.inertia) > 1e-4 * km.inertia):
                raise AssertionError(f"kmeans program: centre errors {errs}, inertia "
                                     f"{inertia} vs {ref_inertia} and {km.inertia}")
            return {"centre_err": errs[0], "centre_diff_per_op": errs[1],
                    "inertia": inertia}

        job("kmeans", km_build, km_run, 5 * pts.shape[0], km_check)

        # π: the static-key fast path, one dispatch
        n_pi = data["pi_samples"]

        def pi_build(sess):
            step, state = alg["pi"]._program_step(n_pi, "pallas", dev)
            return sess.program(step), state

        def pi_run(sess, prog, state):
            return sess.run_loop(prog, state, max_iters=1)

        def pi_check(out):
            pi = 4.0 * float(out["counts"][0]) / n_pi
            if (pi, pi) != self.per_op["pi"]:
                raise AssertionError("pi program differs from per-op and the "
                                     "hand-rolled count")
            return {"pi": pi}

        job("pi", pi_build, pi_run, n_pi, pi_check)

        # GMM: 5 EM rounds in one dispatch, two collectives a round
        gpts, k = data["gmm_points"], data["gmm_k"]
        n, d = gpts.shape

        def gmm_build(sess, tune=False):
            rows = torch.cat([gpts, torch.zeros((n, k), device=dev)], 1)
            step, state0 = alg["gmm"]._program_step(DistVector(rows, n), k, d, n, "pallas")
            init = gpts[:k].cpu().numpy()
            return sess.program(step, tune=tune), state0(np.full(k, 1.0 / k, np.float32), init,
                                              np.tile(np.eye(d, dtype=np.float32), (k, 1, 1)))

        def gmm_run(sess, prog, state):
            return sess.run_loop(prog, state, max_iters=5, unroll=5,
                                 cond=lambda s: abs(float(s["ll"]) - float(s["prev_ll"])) < 0.0)

        def gmm_check(out):
            g, _ref, errors = self.per_op["gmm"]
            got = types.SimpleNamespace(
                alpha=out["alpha"].cpu().numpy(), mu=out["mu"].cpu().numpy(),
                sigma=out["sigma"].cpu().numpy(), log_likelihood=float(out["ll"]))
            err = errors(got)
            diff = {name: float(np.abs(getattr(got, name) - getattr(g, name)).max())
                    for name in ("alpha", "mu", "sigma")}
            diff["ll_rel"] = abs(got.log_likelihood - g.log_likelihood) / abs(g.log_likelihood)
            for e in (err, diff):
                if (e["ll_rel"] > 1e-5 or e["alpha"] > 1e-4
                        or max(e["mu"], e["sigma"]) > 1e-3):
                    raise AssertionError(f"gmm program: errors {err}, against per-op {diff}")
            return {"err": err, "diff_per_op": diff}

        job("gmm", gmm_build, gmm_run, 5 * n, gmm_check)

        # kNN: the topk container's plan inside one dispatch
        kx = data["knn_points"]

        def knn_build(sess):
            step = alg["knn"]._program_step(DistVector(kx, kx.shape[0]), 100, "auto")
            state = {"q": torch.zeros(kx.shape[1], device=dev),
                     "neighbors": torch.zeros((100, kx.shape[1]), device=dev),
                     "scores": torch.full((100,), float("-inf"), device=dev)}
            return sess.program(step), state

        def knn_run(sess, prog, state):
            return sess.run_loop(prog, state, max_iters=1)

        def knn_check(out):
            res, want, want_rows, kth = self.per_op["knn"]
            dist = np.sort(np.sqrt(np.maximum(-out["scores"].cpu().numpy(), 0.0))
                           .astype(np.float64))
            rel = float((np.abs(dist - want) / want).max())
            rows = {tuple(r) for r in out["neighbors"].cpu().numpy().tolist()}
            per_op_rows = {tuple(r) for r in res.neighbors.tolist()}
            for row in (rows ^ want_rows) | (rows ^ per_op_rows):
                if float((np.asarray(row, np.float64) ** 2).sum()) != kth:
                    raise AssertionError("knn program: a neighbour differs")
            if rel > 1e-5:
                raise AssertionError(f"knn program: distances off by {rel} relative")
            return {"dist_rel_err": rel}

        job("knn", knn_build, knn_run, kx.shape[0], knn_check)

        # fig. 6's hand-fused k-means (K3) as a program: 5 Lloyd steps a replay
        def fig6_build(sess):
            def step(ctx, s):
                st = ops.kmeans_assign(pts, s["c"])[1]
                return {"c": st[:, :pts.shape[1]] / torch.clamp(st[:, pts.shape[1]:], min=1.0)}

            return sess.program(step), {"c": c0}

        def fig6_run(sess, prog, state):
            return sess.run_loop(prog, state, max_iters=5, unroll=5)

        def fig6_check(out):
            if not torch.equal(out["c"], self.per_op["kmeans fig6"]):
                raise AssertionError("fig6 program: centres differ from the eager "
                                     "hand-fused loop's bits")
            return {"bit_equal": True}

        job("kmeans fig6", fig6_build, fig6_run, 5 * pts.shape[0], fig6_check)
        print(json.dumps({"program_results": results}), flush=True)

    # -- tuning phase ----------------------------------------------------------

    def tuning_phase(self, data):
        """Measured autotuning at the paper's sizes: wordcount (K2, its key
        range the vocabulary), PageRank (K1's global form against eager),
        k-means (K1's register form) and GMM (three K1 nodes, one variant
        set) as ``session.program(..., tune=True)`` programs on the path
        phase's data, each variant built, dispatched, timed over a replay
        and freed; each tuned result held to the per-op (untuned) one as in
        the program phase; a per-op ``map_reduce(tune=True)`` called twice
        (one measurement, then a cache hit); the winners saved and loaded
        into a fresh session, which measures nothing."""
        torch = self.torch
        import tempfile

        from repro_torch.core import BlazeSession, DistVector
        from repro_torch.core.algorithms.pagerank import contrib_mapper

        dev = self.dev
        self.sync()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        jobs = (("wordcount", "hash_aggregate"), ("pagerank", "segment_reduce"),
                ("kmeans", "segment_reduce"), ("gmm", "segment_reduce"))
        results, winners = {}, {}
        saved = tempfile.mkdtemp(prefix="blaze-tuning-")
        path = f"{saved}/tuning.json"
        store = BlazeSession(device=dev)  # collects every job's winners
        for name, kernel in jobs:
            build, run, units, check = self.program_specs[name]
            sess = BlazeSession(device=dev)
            prog, state = build(sess, tune=True)
            (out, _info), wall, launch = self.drive(f"{name} tuned program",
                                                    lambda: run(sess, prog, state), units)
            if not prog.tune_walls or launch[kernel] == 0:
                raise AssertionError(f"{name}: no variant measured or no {kernel} launched")
            variants = []
            for ov, vwall, la in prog.tune_walls:
                pallas = [c for c in ov.values() if c.engine == "pallas"]
                ran = la.get(kernel, 0)
                forms = {k.split("/")[1] for k, n in la.items()
                         if k.startswith(kernel + "/") and n}
                if (ran > 0) != bool(pallas) or not forms <= {c.form for c in pallas}:
                    raise AssertionError(f"{name}: variant {[c.describe() for c in ov.values()]}"
                                         f" launched {la}")
                variants.append({"configs": sorted({c.describe() for c in ov.values()}),
                                 "replay_s": vwall, "launches": la.get(kernel, 0)})
            won = {tk: cfg.describe() for tk, cfg in sess.tuning.items()}
            applied = sorted({n.tuned.describe() for n in prog.plan.mapreduce_nodes()
                              if n.tuned is not None})
            res = check(out)
            results[name] = {"tuned_wall_s": wall, "measurements": sess.stats.tune_measurements,
                             "winners": applied, "result": res}
            winners[name] = won
            print(json.dumps({"tuning": name, "variants": variants, "winner": applied,
                              "winner_replay_s": min(v["replay_s"] for v in variants),
                              "tuned_wall_s": wall}), flush=True)
            for tk, cfg in sess.tuning.items():
                store.tuning.put(tk, cfg)
            self.add_phase_launches(name, sess.stats.graph_launches)
            del prog, state, out, sess
            torch.cuda.empty_cache()

        # Per op: PageRank's contribution sum, tuned twice: one measurement
        # of K1's global form against eager, then a cache hit.
        edges, deg, n_pages = data["edges"], data["deg"], data["n_pages"]
        env = (torch.full((n_pages,), 1.0 / n_pages, device=dev), deg)
        ev = DistVector(edges, edges.shape[0])

        def contrib(sess, tune):
            return sess.map_reduce(ev, contrib_mapper, "sum",
                                   torch.zeros(n_pages, device=dev), engine="pallas",
                                   env=env, tune=tune)

        sess = BlazeSession(device=dev)
        (first, _, launch) = self.drive("pagerank contribution tuned", lambda: contrib(sess, True),
                                        edges.shape[0])
        measured = sess.stats.tune_measurements
        hits = sess.tuning.hits
        second = contrib(sess, True)
        from repro_torch.core import cost

        n_cands = len(cost.dense_tuning_candidates(n_pages, 1, "sum", torch.float32))
        if (measured != n_cands or sess.stats.tune_measurements != measured
                or sess.tuning.hits <= hits or launch["segment_reduce"] == 0):
            raise AssertionError(f"per-op tuning: {measured} then "
                                 f"{sess.stats.tune_measurements} measurements")
        untuned = contrib(BlazeSession(device=dev), False)
        dst, src = edges[:, 1].long(), edges[:, 0].long()
        want = torch.zeros(n_pages, dtype=torch.float64, device=dev).index_add_(
            0, dst, (env[0][src] / torch.clamp(deg[src], min=1)).double())
        # any form's additions: the in-links, plus every CTA's table flush
        from repro_torch.kernels._build import sm_count

        count = (torch.bincount(dst, minlength=n_pages) + 8 * sm_count(dev.index or 0))
        errs = [self.compare(f"pagerank contribution {tag}", got, want, exact=False,
                             abs_sum=want, count=count)
                for tag, got in (("tuned", first), ("cache hit", second), ("untuned", untuned))]
        (_, op_cfg), = sess.tuning.items()
        for tk, cfg in sess.tuning.items():
            store.tuning.put(tk, cfg)
        print(json.dumps({"tuning": "pagerank contribution per op",
                          "candidates": [(e["config"], e["wall_s"]) for e in sess.tune_log],
                          "winner": op_cfg.describe(), "measurements": measured,
                          "second_call_measurements": sess.stats.tune_measurements - measured,
                          "max_abs_err": errs}), flush=True)
        del first, second, untuned, want, count, sess

        # Saved, then loaded into a fresh session: nothing is measured again.
        store.save_tuning(path)
        fresh = BlazeSession(device=dev)
        loaded = fresh.load_tuning(path)
        for name, _kernel in jobs:
            build, run, units, check = self.program_specs[name]
            prog, state = build(fresh, tune=True)
            (out, _), _, _ = self.drive(f"{name} loaded tuning", lambda: run(fresh, prog, state),
                                        units)
            check(out)
            if not any(n.tuned is not None and n.tuned.source == "measured"
                       for n in prog.plan.mapreduce_nodes()):
                raise AssertionError(f"{name}: the loaded winner was not applied")
            self.add_phase_launches(name, fresh.stats.graph_launches)
            fresh.stats.graph_launches = {}
            del prog, state, out
            torch.cuda.empty_cache()
        contrib(fresh, True)
        if fresh.stats.tune_measurements:
            raise AssertionError(f"loaded tuning measured {fresh.stats.tune_measurements}")
        peak = torch.cuda.max_memory_reserved(dev)
        print(json.dumps({"tuning_results": results, "tuning_entries_loaded": loaded,
                          "loaded_session_measurements": fresh.stats.tune_measurements,
                          "tuning_peak_reserved_bytes": peak}), flush=True)
        import shutil

        shutil.rmtree(saved, ignore_errors=True)
        del fresh, store
        torch.cuda.empty_cache()

    def add_phase_launches(self, job, launches):
        """Add a tuning or stream session's graph replays' launches to the
        job's program launches (the kernels line's ``program_launches``)."""
        mine = self.program_launches.setdefault(job, {})
        for k, n in launches.items():
            mine[k] = mine.get(k, 0) + n

    # -- stream phase ------------------------------------------------------------

    def stream_epochs(self, name, sess, prog, state, epochs, prefetch, n_blocks):
        """``epochs`` one-epoch ``run_stream`` calls, each timed to a
        synchronised end; the first of a fresh program builds and captures.
        Every block must be a replay of the program's one graph."""
        times = []
        replays0 = prog.stats.replays
        for _ in range(epochs):
            self.sync()
            t0 = time.perf_counter()
            state, info = sess.run_stream(prog, state, max_epochs=1, prefetch=prefetch)
            self.sync()
            times.append(time.perf_counter() - t0)
            if info.dispatches != n_blocks or info.compiles > 1:
                raise AssertionError(f"{name}: {info.dispatches} dispatches, "
                                     f"{info.compiles} compiles an epoch")
        if prog.stats.replays - replays0 != epochs * n_blocks or prog.stats.captures != 1:
            raise AssertionError(f"{name}: {prog.stats.replays - replays0} replays for "
                                 f"{epochs * n_blocks} blocks, {prog.stats.captures} captures")
        return state, times

    def replay_ms(self, prog, state):
        """One in-memory dispatch's wall time, replay only (after a first
        that captures), in ms."""
        prog(state, 1)
        self.sync()
        t0 = time.perf_counter()
        prog(state, 1)
        self.sync()
        return (time.perf_counter() - t0) * 1e3

    def stream_phase(self, data):
        """Out of core at the paper's sizes: the k-means points in blocks of
        2^24 rows (6 blocks, the last padded), the R-MAT edges and the
        wordcount token lines in 8 blocks each, held in pinned host memory;
        ``mode="stream"`` k-means and PageRank and chunked wordcount (per op
        and as a program), with prefetch on and off, held to the per-op
        results as the program phase holds them (integers exactly); a run
        checkpointed every epoch and resumed from its epoch-2 checkpoint in
        a new program held to the uninterrupted run; the pinned
        host-to-device rate; each epoch's time beside the blocks' bytes over
        that rate and beside the in-memory program's replay of one
        iteration; the device memory the stream adds at its peak, against
        two blocks (the static buffer and the staging one) plus the state
        plus what the graph's pool reserved."""
        torch = self.torch
        import importlib
        import shutil
        import tempfile

        import numpy as np
        from repro_torch.core import BlazeSession, DistVector
        from repro_torch.core.algorithms import kmeans, pagerank, wordcount

        alg = {m: importlib.import_module("repro_torch.core.algorithms." + m)
               for m in ("kmeans", "pagerank", "wordcount")}
        dev = self.dev
        sess = BlazeSession(device=dev)
        lines, vocab = data["lines_np"], data["vocab"]
        edges_np, n_pages = data["edges_np"], data["n_pages"]
        pts_np, c0 = data["points_np"], data["init_centers"]
        t0 = time.perf_counter()
        km_c = sess.chunked(pts_np, STREAM_BLOCK_ROWS)
        pr_c = sess.chunked(edges_np, -(-len(edges_np) // 8))
        wc_c = sess.chunked(lines, -(-len(lines) // 8))
        if (km_c.n_blocks, pr_c.n_blocks, wc_c.n_blocks) != (
                -(-len(pts_np) // STREAM_BLOCK_ROWS), 8, 8) or km_c.n_blocks < 2:
            raise AssertionError("stream: block counts")
        if not all(c.stats()["pinned"] for c in (km_c, pr_c, wc_c)):
            raise AssertionError("stream: host blocks are not pinned")
        chunk_s = time.perf_counter() - t0
        # The pinned host-to-device rate: one plain copy of one block.
        host = km_c.block_tensor(0)
        dst = torch.empty(host.shape, dtype=host.dtype, device=dev)
        h2d_ms = self.time_ms(lambda: dst.copy_(host, non_blocking=True))
        rate = km_c.block_nbytes / (h2d_ms / 1e3)
        del dst
        print(json.dumps({"stream_setup_s": chunk_s, "h2d_block_bytes": km_c.block_nbytes,
                          "h2d_ms": h2d_ms, "h2d_gb_per_s": rate / 1e9}), flush=True)
        results = {}
        km_ref, ref_c, ref_inertia = self.per_op["kmeans"]
        pr_per_op, pr_ref, pr_tol = self.per_op["pagerank"]

        def km_ok(tag, centers, inertia=None):
            centers = centers.cpu().numpy() if hasattr(centers, "cpu") else centers
            errs = (float(np.abs(centers - ref_c).max()),
                    float(np.abs(centers - km_ref.centers).max()))
            bad = max(errs) > 1e-4
            if inertia is not None:
                bad |= (abs(inertia - ref_inertia) > 1e-4 * ref_inertia
                        or abs(inertia - km_ref.inertia) > 1e-4 * km_ref.inertia)
            if bad:
                raise AssertionError(f"kmeans {tag}: centre errors {errs}, inertia {inertia}")
            return errs[1]

        def pr_ok(tag, scores):
            got = torch.as_tensor(scores).to(dev).double()
            d = (got - torch.from_numpy(pr_per_op).to(dev).double()).abs()
            if not (bool(((got - pr_ref).abs() <= pr_tol).all()) and bool((d <= pr_tol).all())):
                raise AssertionError(f"pagerank {tag}: a page is over its tolerance")
            return float(d.max())

        def wc_ok(tag, hm, times=1):
            keys, vals = hm.items()
            got = np.zeros(vocab, np.int64)
            got[keys] = vals
            if hm.total_overflow() or not np.array_equal(got, times * self.per_op["wordcount"]):
                raise AssertionError(f"wordcount {tag} differs from per-op")
            return int(len(keys))

        # -- the drivers, as a user calls them --------------------------------
        km, _, launch = self.drive("kmeans stream", lambda: kmeans(
            km_c, 5, init_centers=c0.cpu().numpy(), tol=0.0, max_iters=5, engine="pallas",
            mode="stream", session=sess), 5 * len(pts_np))
        results["kmeans_driver_centre_diff"] = km_ok("stream driver", km.centers, km.inertia)
        if launch["segment_reduce"] == 0 or km.program_compiles != 1:
            raise AssertionError("kmeans stream: no K1 launched or not one capture")
        self.add_phase_launches("kmeans", sess.stats.graph_launches)
        sess.stats.graph_launches = {}
        pr, _, launch = self.drive("pagerank stream", lambda: pagerank(
            pr_c, n_pages, tol=0.0, max_iters=5, engine="pallas", mode="stream",
            session=sess), 5 * len(edges_np))
        results["pagerank_driver_diff"] = pr_ok("stream driver", pr.scores)
        if launch["segment_reduce"] == 0 or pr.iterations != 5:
            raise AssertionError("pagerank stream: no K1 launched")
        self.add_phase_launches("pagerank", sess.stats.graph_launches)
        sess.stats.graph_launches = {}
        hm, _, launch = self.drive("wordcount chunked per op", lambda: wordcount(
            wc_c, engine="pallas", vocab_size=vocab, session=sess), int(lines.size))
        results["wordcount_per_op_distinct"] = wc_ok("chunked per op", hm)
        if launch["hash_aggregate"] != 2 * wc_c.n_blocks:
            raise AssertionError(f"wordcount chunked: {launch['hash_aggregate']} K2 calls")
        wres, _, launch = self.drive("wordcount stream program", lambda: wordcount(
            wc_c, engine="pallas", vocab_size=vocab, mode="program", session=sess),
            int(lines.size))
        results["wordcount_program_distinct"] = wc_ok("stream program", wres.counts)
        if launch["hash_aggregate"] == 0 or wres.dispatches != wc_c.n_blocks:
            raise AssertionError("wordcount stream program: no K2 launched")
        self.add_phase_launches("wordcount", sess.stats.graph_launches)
        del km, pr, hm, wres, sess
        torch.cuda.empty_cache()

        # -- epochs, prefetch on and off, the memory the stream adds ----------
        epochs = 5

        def km_make(s2):
            step, st0 = alg["kmeans"]._stream_step(km_c, 5, 3, "pallas", "none", dev)
            return (s2.program(step), st0(c0),
                    lambda prog, st: km_ok("stream epochs", st["centers"]))

        def pr_make(s2):
            deg = torch.from_numpy(alg["pagerank"].block_degrees(pr_c, n_pages)).to(dev)
            step, st0 = alg["pagerank"]._stream_step(pr_c, deg, n_pages, 0.85, "pallas",
                                                     "none", dev)
            return (s2.program(step), st0(torch.full((n_pages,), 1.0 / n_pages, device=dev)),
                    lambda prog, st: pr_ok("stream epochs", st["scores"].cpu().numpy()))

        def wc_make(s2):
            hm = s2.make_dist_hashmap(max(64, 4 * vocab), (), torch.int32, "sum")
            step, st = alg["wordcount"]._program_step(wc_c, hm, vocab, "pallas")
            return (s2.program(step), st,
                    lambda prog, _st: wc_ok("stream epochs", prog.hash_result(hm), epochs))

        specs = {"kmeans": (km_c, km_make, "segment_reduce", 1),
                 "pagerank": (pr_c, pr_make, "segment_reduce", 1),
                 "wordcount": (wc_c, wc_make, "hash_aggregate", 2)}
        for name, (cv, make, kernel, per_block) in specs.items():
            for prefetch in (True, False):
                s2 = BlazeSession(device=dev)
                self.sync()
                base0 = torch.cuda.memory_allocated(dev)
                prog, state, check = make(s2)
                state, first = self.stream_epochs(name, s2, prog, state, 1, prefetch,
                                                  cv.n_blocks)
                torch.cuda.reset_peak_memory_stats(dev)
                (state, times), _, launch = self.drive(
                    f"{name} stream epochs prefetch={prefetch}",
                    lambda: self.stream_epochs(name, s2, prog, state, epochs - 1, prefetch,
                                               cv.n_blocks), epochs - 1)
                peak = torch.cuda.max_memory_allocated(dev) - base0
                if launch[kernel]:
                    raise AssertionError(f"{name} stream: {kernel} ran outside a graph")
                per_replay = prog.stats.captured_launches[1].get(kernel, 0)
                if per_replay != per_block:
                    raise AssertionError(f"{name} stream: {per_replay} {kernel} a block")
                state_bytes = sum(x.numel() * x.element_size() for x in state.values())
                carry = prog._carry[prog._last_sig]
                state_bytes += sum(t.keys.nbytes + t.vals.nbytes + t.overflow.nbytes
                                   for t in carry.tables.values())
                bound = 2 * cv.block_nbytes + state_bytes + prog.stats.pool_reserved_bytes
                if prefetch and peak > bound:
                    raise AssertionError(f"{name} stream: peak {peak} over {bound}")
                diff = check(prog, state)
                rec = {"stream": name, "prefetch": prefetch, "blocks": cv.n_blocks,
                       "block_bytes": cv.block_nbytes, "first_epoch_s": first[0],
                       "epoch_s": times, "epoch_median_s": statistics.median(times),
                       "bound_s": cv.n_blocks * cv.block_nbytes / rate,
                       "dataset_bytes": cv.n_blocks * cv.block_nbytes,
                       "peak_added_bytes": peak, "peak_bound_bytes": bound,
                       "state_bytes": state_bytes,
                       "pool_reserved_bytes": prog.stats.pool_reserved_bytes,
                       "launches_per_block": per_replay, "check": diff}
                results[f"{name} prefetch={prefetch}"] = {
                    k: rec[k] for k in ("epoch_median_s", "bound_s", "peak_added_bytes")}
                print(json.dumps(rec), flush=True)
                self.add_phase_launches(name, s2.stats.graph_launches)
                del prog, s2, state, check
                torch.cuda.empty_cache()

        # -- resume from the epoch-2 checkpoint in a new program --------------
        ckpt = tempfile.mkdtemp(prefix="blaze-ckpt-")
        s3 = BlazeSession(device=dev)
        step, st0 = alg["kmeans"]._stream_step(km_c, 5, 3, "pallas", "none", dev)
        full, _ = s3.run_stream(s3.program(step), st0(c0), max_epochs=epochs)
        s3.run_stream(s3.program(step), st0(c0), max_epochs=2, checkpoint=ckpt,
                      checkpoint_every=1)
        got, info = s3.run_stream(s3.program(step), st0(c0), max_epochs=epochs,
                                  checkpoint=ckpt, checkpoint_every=1, resume=True)
        km_diff = float((got["centers"] - full["centers"]).abs().max())
        if info.resumed_from != 2 or km_diff > 1e-4:
            raise AssertionError(f"kmeans resume: from {info.resumed_from}, {km_diff} off")
        km_ok("resumed", got["centers"])
        shutil.rmtree(ckpt, ignore_errors=True)
        ckpt = tempfile.mkdtemp(prefix="blaze-ckpt-")

        def wc_stream(n_epochs, resume=False):
            hm = s3.make_dist_hashmap(max(64, 4 * vocab), (), torch.int32, "sum")
            wstep, wstate = alg["wordcount"]._program_step(wc_c, hm, vocab, "pallas")
            prog = s3.program(wstep)
            _, winfo = s3.run_stream(prog, wstate, max_epochs=n_epochs, checkpoint=ckpt,
                                     checkpoint_every=1, resume=resume)
            return prog.hash_result(hm), winfo

        wfull, _ = wc_stream(3)
        shutil.rmtree(ckpt, ignore_errors=True)
        ckpt = tempfile.mkdtemp(prefix="blaze-ckpt-")
        wc_stream(2)
        wgot, winfo = wc_stream(3, resume=True)
        if winfo.resumed_from != 2 or wgot.to_dict() != wfull.to_dict():
            raise AssertionError("wordcount resume differs from the uninterrupted run")
        wc_ok("resumed", wgot, times=3)
        shutil.rmtree(ckpt, ignore_errors=True)
        for k, n in s3.stats.graph_launches.items():
            self.add_phase_launches("wordcount" if k.startswith("hash") else "kmeans", {k: n})
        results["resume"] = {"kmeans_centre_diff": km_diff, "kmeans_resumed_from": 2,
                             "wordcount_equal": True, "wordcount_resumed_from": 2}
        del s3, full, got, wfull, wgot
        torch.cuda.empty_cache()

        # -- the in-memory programs' replay of one iteration, for comparison ---
        inmem = {}
        s4 = BlazeSession(device=dev)
        step, st0 = alg["kmeans"]._program_step(DistVector(data["points"], len(pts_np)),
                                                5, 3, "pallas", "none")
        inmem["kmeans"] = self.replay_ms(s4.program(step), st0(c0))
        step, st0 = alg["pagerank"]._program_step(
            DistVector(data["edges"], len(edges_np)), data["deg"], n_pages, 0.85, "pallas",
            "none")
        inmem["pagerank"] = self.replay_ms(
            s4.program(step), st0(torch.full((n_pages,), 1.0 / n_pages, device=dev)))
        hm = s4.make_dist_hashmap(max(64, 4 * vocab), (), torch.int32, "sum")
        step, state = alg["wordcount"]._program_step(
            DistVector(data["tokens"], lines.shape[0]), hm, vocab, "pallas")
        inmem["wordcount"] = self.replay_ms(s4.program(step), state)
        del s4
        torch.cuda.empty_cache()
        print(json.dumps({"stream_results": results, "in_memory_replay_ms": inmem}),
              flush=True)

    # -- fault phase ------------------------------------------------------------

    def fault_ledger(self, name, **want):
        """The registry's ledger after one check: balanced, with the
        dispositions ``want``; added to ``self.fault_totals`` and reset (each
        check's ``at=`` rules count hits from 1)."""
        from repro_torch.core import faults

        snap = faults.snapshot()
        got = {k: v for k, v in snap["dispositions"].items() if v}
        if not snap["balanced"] or got != want:
            raise AssertionError(f"faults {name}: ledger {snap}, want {want}")
        for k, v in snap["dispositions"].items():
            self.fault_totals[k] = self.fault_totals.get(k, 0) + v
        self.fault_totals["injected"] = (self.fault_totals.get("injected", 0)
                                         + snap["injected_total"])
        faults.reset(env=False)
        return got

    def fault_launches_add(self, launches):
        for k in ("segment_reduce", "hash_aggregate", "kmeans_assign"):
            self.fault_launches[k] = self.fault_launches.get(k, 0) + launches.get(k, 0)

    def fault_phase(self, data):
        """The supervisor on the card, under injected faults, on the data of
        the earlier phases (module docstring, 8).  Each check's ledger must
        balance with the dispositions it expects; results are held to the
        fault-free run of the same call within the tolerance the program
        phase uses for it (the wordcount counts and the escalated hash map
        exactly).  Prints the drop and the recapture of a degraded program,
        its captures and the pool's reservation before and after, and the
        medians of per-op PageRank and of a k-means program replay with
        supervision on (the default) and off (``retry=None``), in turns."""
        torch = self.torch
        import importlib
        import shutil
        import tempfile

        import numpy as np
        from repro_torch.core import BlazeSession, DistVector, faults
        from repro_torch.core.algorithms import pagerank, wordcount
        from repro_torch.core.algorithms.wordcount import wordcount_mapper
        from repro_torch.kernels import ops

        km_alg = importlib.import_module("repro_torch.core.algorithms.kmeans")
        dev = self.dev
        t_phase = time.perf_counter()
        faults.reset(env=False)
        res = {}

        def sync_ms(fn):
            self.sync()
            t0 = time.perf_counter()
            out = fn()
            self.sync()
            return out, (time.perf_counter() - t0) * 1e3

        # -- a per-op PageRank dispatch retried (K1's global form) ------------
        edges_np, n_pages = data["edges_np"], data["n_pages"]
        _, _, pr_tol = self.per_op["pagerank"]
        sess = BlazeSession(device=dev)
        clean = pagerank(edges_np, n_pages, tol=0.0, max_iters=1, engine="pallas",
                         session=sess)
        faults.configure("dispatch", at=1)
        pr, _, launch = self.drive("faults pagerank retry", lambda: pagerank(
            edges_np, n_pages, tol=0.0, max_iters=1, engine="pallas", session=sess),
            len(edges_np))
        self.fault_launches_add(launch)
        diff = (torch.from_numpy(pr.scores).to(dev).double()
                - torch.from_numpy(clean.scores).to(dev).double()).abs()
        if sess.stats.retries != 1 or not bool((diff <= pr_tol).all()) or \
                launch["segment_reduce"] == 0:
            raise AssertionError(f"faults retry: {sess.stats.retries} retries, "
                                 f"{float(diff.max())} off, {launch['segment_reduce']} K1")
        res["retry"] = {"retries": sess.stats.retries, "max_diff": float(diff.max()),
                        "ledger": self.fault_ledger("retry", retried=1)}
        del sess

        # -- per-op wordcount degraded from K2 to eager -------------------------
        vocab = data["vocab"]
        prefix = data["lines_np"][: 1 << 16]  # 2^22 tokens: eager takes ~7.5 s at 2^27
        want = np.bincount(prefix[prefix >= 0], minlength=vocab)

        def counts(hm):
            keys, vals = hm.items()
            got = np.zeros(vocab, np.int64)
            got[keys] = vals
            return got

        sess = BlazeSession(device=dev)
        clean = counts(wordcount(prefix, engine="pallas", vocab_size=vocab, session=sess))
        faults.configure("kernel.hash", at=1)
        (hm, st), _, launch = self.drive("faults wordcount degrade", lambda: wordcount(
            prefix, engine="pallas", vocab_size=vocab, return_stats=True, session=sess),
            int(prefix.size))
        compiles0 = sess.stats.compiles
        hm2, st2 = wordcount(prefix, engine="pallas", vocab_size=vocab, return_stats=True,
                             session=sess)
        if not (st.engine == "eager" and st.degraded_engine == "pallas"
                and st2.degraded_engine == "pallas" and st2.cache_hits == 1
                and sess.stats.compiles == compiles0 and launch["hash_aggregate"] == 0
                and np.array_equal(counts(hm), clean) and np.array_equal(clean, want)
                and np.array_equal(counts(hm2), want)):
            raise AssertionError(f"faults degrade: {st.engine} from {st.degraded_engine}, "
                                 f"follow-up {st2.compiles} compiles, "
                                 f"{launch['hash_aggregate']} K2 launches")
        res["per_op_degrade"] = {"tokens": int(prefix.size), "engine": st.engine,
                                 "degraded_engine": st.degraded_engine,
                                 "follow_up_compiles": st2.compiles,
                                 "ledger": self.fault_ledger("per-op degrade", degraded=1)}
        del sess, hm, hm2

        # -- the k-means program (K1 and K3) degraded at its third dispatch -----
        # Twice: on all 10^8 points for the cost (the centres are then the
        # eager engine's, whose f32 counts stop at 2^24: ROADMAP Queue 3 item
        # 3), and on a 2^20-point prefix for the result.
        pts, c0 = data["points"], data["init_centers"]

        def both_step(x):
            km_step, km0 = km_alg._program_step(DistVector(x, x.shape[0]), 5, 3, "pallas",
                                                "none")

            def both(ctx, s):
                out = km_step(ctx, {k: s[k] for k in ("centers", "move", "inertia")})
                st = ops.kmeans_assign(x, s["c3"])[1]
                out["c3"] = st[:, :3] / torch.clamp(st[:, 3:], min=1.0)
                return out

            return both, km_step, km0

        def loop(sess, prog, km0, marks=None):
            state, walls = dict(km0(c0), c3=c0), []
            for i in range(5):
                if marks is not None and i == 2:
                    marks["before"] = (prog.stats.captures, torch.cuda.memory_reserved(dev),
                                       dict(prog.stats.captured_launches[1]))
                state, ms = sync_ms(lambda s=state: sess.supervised(
                    lambda: prog(s, 1), program=prog))
                walls.append(ms)
            return state, walls

        def degrade_run(x, tag):
            both, km_step, km0 = both_step(x)
            sess = BlazeSession(device=dev)
            want, clean_walls = loop(sess, sess.program(both), km0)
            del sess
            torch.cuda.empty_cache()
            sess = BlazeSession(device=dev)
            prog = sess.program(both)
            timings = {"degrade_ms": [], "discover_ms": [], "capture_ms": []}

            def timed(name, fn):
                def run(*a, **kw):
                    t0 = time.perf_counter()
                    out = fn(*a, **kw)
                    timings[name].append((time.perf_counter() - t0) * 1e3)
                    return out
                return run

            prog.degrade = timed("degrade_ms", prog.degrade)
            prog._discover = timed("discover_ms", prog._discover)
            prog._capture = timed("capture_ms", prog._capture)
            marks = {}
            faults.configure("kernel.segment", at=3)
            (got, walls), _, launch = self.drive(f"faults kmeans program degrade {tag}",
                                                 lambda: loop(sess, prog, km0, marks),
                                                 5 * x.shape[0])
            self.fault_launches_add(launch)
            self.fault_launches_add(prog.stats.replay_launches)
            caps0, reserved0, launches0 = marks["before"]
            after = dict(prog.stats.captured_launches[1])
            errs = {k: float((got[k] - want[k]).abs().max()) for k in ("centers", "c3")}
            if not (prog.stats.degradations == 1 and prog.stats.graphs_dropped == 1
                    and caps0 == 1 and prog.stats.captures == 2
                    and torch.equal(got["c3"], want["c3"])
                    and launches0.get("segment_reduce") and launches0.get("kmeans_assign")
                    and not after.get("segment_reduce") and after.get("kmeans_assign")):
                raise AssertionError(f"faults program degrade {tag}: {prog.stats}, errors "
                                     f"{errs}, launches {launches0} -> {after}")
            rec = {"points": int(x.shape[0]), "centre_err": errs, "dispatch_ms": walls,
                   "fault_free_dispatch_ms": clean_walls,
                   "degrade_drop_ms": timings["degrade_ms"],
                   "rediscover_ms": timings["discover_ms"][-1],
                   "recapture_ms": timings["capture_ms"][-1],
                   "graph_captures": [caps0, prog.stats.captures],
                   "reserved_bytes": [reserved0, torch.cuda.memory_reserved(dev)],
                   "launches_per_replay": [launches0, after],
                   "ledger": self.fault_ledger(f"program degrade {tag}", degraded=1)}
            print(json.dumps({"fault_program_degrade": rec}), flush=True)
            del sess, prog
            torch.cuda.empty_cache()
            return rec, want, km_step, km0

        res["program_degrade_cost"], want_km, km_step, km0 = degrade_run(pts, "all")
        rec, _, _, _ = degrade_run(pts[: 1 << 20], "prefix")
        if rec["centre_err"]["centers"] > 1e-4:
            raise AssertionError(f"faults program degrade: centres {rec['centre_err']} off")
        res["program_degrade"] = rec

        # -- a fault inside a fresh program's first capture, retried ---------------
        sess = BlazeSession(device=dev)
        prog = sess.program(km_step)
        faults.configure("collective", at=1)
        out, _ = sess.run_loop(prog, km0(c0), max_iters=5, unroll=5)
        torch.cuda.synchronize()  # raises if the failed capture left the context bad
        err = float((out["centers"] - want_km["centers"]).abs().max())
        if prog.stats.captures != 1 or err > 1e-4:
            raise AssertionError(f"faults capture: {prog.stats.captures} captures, {err} off")
        self.fault_launches_add(prog.stats.replay_launches)
        res["capture_fault"] = {"captures": prog.stats.captures, "centre_err": err,
                                "ledger": self.fault_ledger("capture", retried=1)}
        del sess, prog
        torch.cuda.empty_cache()

        # -- the k-means stream under faults, then a crash and a resume -----------
        sess = BlazeSession(device=dev)
        km_c = sess.chunked(data["points_np"], STREAM_BLOCK_ROWS)
        sstep, s0 = km_alg._stream_step(km_c, 5, 3, "pallas", "none", dev)
        clean_prog = sess.program(sstep)
        clean, _ = sess.run_stream(clean_prog, s0(c0), max_epochs=3)
        # K1's CTAs merge their sums with atomics in no fixed order, so two
        # fault-free streams differ by a few f32 steps of the centres.  The
        # faulted stream is one more such run, held against ``clean``: the
        # bound is STREAM_SPREAD_FACTOR times the largest distance from
        # ``clean`` of STREAM_SPREAD_RUNS more fault-free runs (the spread of
        # that very distance, not one sample of it), and never below that
        # many f32 steps of the centres' magnitude.
        spread_runs = []
        for _ in range(STREAM_SPREAD_RUNS):
            again, _ = sess.run_stream(clean_prog, s0(c0), max_epochs=3)
            spread_runs.append(float((again["centers"] - clean["centers"]).abs().max()))
        spread = max(spread_runs)
        scale = float(clean["centers"].abs().max())
        stream_bound = STREAM_SPREAD_FACTOR * max(
            spread, float(torch.finfo(torch.float32).eps) * scale)
        # Must fail: the last epoch with one block counted twice.  Its
        # centres come from the per-block partials at the last epoch's input
        # centres (two epochs of the same stream), block 0's added again.
        two, _ = sess.run_stream(clean_prog, s0(c0), max_epochs=2)
        parts = [sess.map_reduce(
            DistVector(km_c.block_view(b).data, km_c.block_true_rows(b)),
            km_alg.assign_inertia_mapper, "sum", torch.zeros(5, 5, device=dev),
            engine="pallas", env=two["centers"]) for b in range(km_c.n_blocks)]
        acc = torch.stack(parts).sum(0)

        def refined(a):
            return a[:, :3] / torch.clamp(a[:, 3:4], min=1.0)

        doubled_shift = float((refined(acc + parts[0]) - refined(acc)).abs().max())
        if not stream_bound < doubled_shift:
            raise AssertionError(f"faults stream: the bound {stream_bound} does not reject "
                                 f"a block counted twice ({doubled_shift})")
        del clean_prog, parts
        ckpt = tempfile.mkdtemp(prefix="blaze-ckpt-")
        faults.configure("prefetch.read", at=2)
        faults.configure("dispatch", at=3)
        faults.configure("checkpoint.write", at=1)
        prog = sess.program(sstep)
        got, info = sess.run_stream(prog, s0(c0), max_epochs=3, checkpoint=ckpt,
                                    checkpoint_every=1)
        self.fault_launches_add(prog.stats.replay_launches)
        stream_err = float((got["centers"] - clean["centers"]).abs().max())
        print(json.dumps({"fault_stream_bound": {
            "fault_free_spread": spread, "fault_free_runs": spread_runs,
            "factor": STREAM_SPREAD_FACTOR, "bound": stream_bound,
            "faulted_distance": stream_err, "doubled_block_shift": doubled_shift}}),
            flush=True)
        if stream_err > stream_bound or info.dispatches != 3 * km_c.n_blocks:
            raise AssertionError(f"faults stream: {stream_err} off, bound {stream_bound} "
                                 f"(fault-free spread {spread}), {info.dispatches} blocks")
        ledger = self.fault_ledger("stream", retried=3)
        shutil.rmtree(ckpt, ignore_errors=True)
        ckpt = tempfile.mkdtemp(prefix="blaze-ckpt-")
        faults.configure("dispatch", at=2 * km_c.n_blocks + 2, fatal=True)  # in epoch 3
        try:
            sess.run_stream(sess.program(sstep), s0(c0), max_epochs=3, checkpoint=ckpt,
                            checkpoint_every=1)
        except faults.FatalFault:
            pass
        else:
            raise AssertionError("faults stream: the fatal fault did not propagate")
        crash = self.fault_ledger("crash", fatal=1)
        resumed, rinfo = sess.run_stream(sess.program(sstep), s0(c0), max_epochs=3,
                                         checkpoint=ckpt, checkpoint_every=1, resume=True)
        resume_err = float((resumed["centers"] - clean["centers"]).abs().max())
        if rinfo.resumed_from != 2 or resume_err > 1e-4:
            raise AssertionError(f"faults resume: from {rinfo.resumed_from}, {resume_err} off")
        shutil.rmtree(ckpt, ignore_errors=True)
        res["stream"] = {"blocks": km_c.n_blocks, "centre_err": stream_err,
                         "fault_free_spread": spread, "fault_free_runs": spread_runs,
                         "centre_scale": scale, "bound": stream_bound,
                         "doubled_block_shift": doubled_shift,
                         "ledger": ledger, "crash_ledger": crash,
                         "resumed_from": rinfo.resumed_from, "resume_err": resume_err}
        del sess, prog, km_c
        torch.cuda.empty_cache()

        # -- wordcount escalated out of a hash target a rung too small -----------
        sess = BlazeSession(device=dev, escalate_overflow=True)
        distinct = int((want > 0).sum())
        cap = 1 << (distinct.bit_length() - 1)
        cap = cap // 2 if cap >= distinct else cap
        hm = sess.make_dist_hashmap(cap, (), torch.int32, "sum")
        tokens = data["tokens"][: prefix.shape[0]]
        (out, st), _, launch = self.drive("faults wordcount escalate", lambda: sess.map_reduce(
            DistVector(tokens, prefix.shape[0]), wordcount_mapper, "sum", hm,
            engine="pallas", key_range=vocab, return_stats=True), int(prefix.size))
        self.fault_launches_add(launch)
        if not (st.escalations >= 1 and out.total_overflow() == 0
                and np.array_equal(counts(out), want) and launch["hash_aggregate"] > 0):
            raise AssertionError(f"faults escalate: {st.escalations} escalations, "
                                 f"{out.total_overflow()} dropped")
        res["escalation"] = {"distinct": distinct, "capacity": [cap, out.capacity_per_shard],
                             "escalations": st.escalations,
                             "host_syncs": sess.stats.host_syncs,
                             "ledger": self.fault_ledger("escalation")}
        del sess, hm, out

        # -- supervision's cost with no rule armed, supervised and not, in turns --
        # End to end: 20 runs each, interleaved.  Directly: the host time of
        # the supervised wrapper around a dispatch that does nothing, against
        # the bare call, which is all that retry=None takes away.
        sessions = {"supervised": BlazeSession(device=dev),
                    "unsupervised": BlazeSession(device=dev, retry=None)}
        order = ("supervised", "unsupervised", "unsupervised", "supervised") * 10
        pr_ms = {k: [] for k in sessions}
        for k in order:
            pr_ms[k].append(sync_ms(lambda: pagerank(
                edges_np, n_pages, tol=0.0, max_iters=5, engine="pallas",
                session=sessions[k]))[1])
        pr_dispatches = sessions["supervised"].stats.dispatches // len(pr_ms["supervised"])
        progs = {k: s.program(km_step) for k, s in sessions.items()}
        state = km0(c0)
        for k, p_ in progs.items():
            sessions[k].run_loop(p_, state, max_iters=1)  # captures
        rp_ms = {k: [] for k in sessions}
        for k in order:
            rp_ms[k].append(sync_ms(lambda: sessions[k].run_loop(progs[k], state,
                                                                  max_iters=1))[1])
        sup = sessions["supervised"]
        node = types.SimpleNamespace(engine="pallas", degraded_from=None)
        noop = (None, None)
        calls = 100_000
        wrap_us = {"supervised": [], "bare": []}
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(calls):
                sup._dispatch_supervised(lambda: noop, node)
            wrap_us["supervised"].append((time.perf_counter() - t0) / calls * 1e6)
            t0 = time.perf_counter()
            for _ in range(calls):
                (lambda: noop)()
            wrap_us["bare"].append((time.perf_counter() - t0) / calls * 1e6)
        per_call_us = (statistics.median(wrap_us["supervised"])
                       - statistics.median(wrap_us["bare"]))

        def spread(v):
            q = statistics.quantiles(v, n=4)
            return {"median": statistics.median(v), "q1": q[0], "q3": q[2],
                    "min": min(v), "max": max(v)}

        res["overhead"] = {
            "runs_each": len(order) // 2,
            "pagerank_per_op_5_iters_ms": {k: spread(v) for k, v in pr_ms.items()},
            "pagerank_per_op_runs_ms": pr_ms,
            "pagerank_supervised_dispatches_per_run": pr_dispatches,
            "kmeans_replay_ms": {k: spread(v) for k, v in rp_ms.items()},
            "kmeans_replay_runs_ms": rp_ms,
            "wrapper_us_per_call": {k: statistics.median(v) for k, v in wrap_us.items()},
            "wrapper_added_us_per_dispatch": per_call_us,
            "wrapper_added_ms_per_pagerank_run": per_call_us * pr_dispatches / 1e3}
        del sessions, progs
        torch.cuda.empty_cache()
        res["totals"] = dict(self.fault_totals)
        res["balanced"] = (self.fault_totals.get("injected", 0) == sum(
            v for k, v in self.fault_totals.items() if k != "injected"))
        if not res["balanced"] or faults.snapshot()["injected_total"]:
            raise AssertionError(f"faults: the ledger does not balance: {self.fault_totals}")
        res["phase_s"] = time.perf_counter() - t_phase
        return res

    # -- serve phase -----------------------------------------------------------

    def serve_phase(self, data):
        """The query server on the card (module docstring, 9): one
        ``BlazeServer`` over the path phase's data, a resident program's
        phase 1 under sync-debug ``"error"`` (``strict_phase_1``), 72
        requests of 3 tenants, the first of each query alone (its capture),
        the other 66 submitted while dispatch is paused and released at
        once; one HTTP round trip a query and the queue saturated.  The
        launch counts are the served traffic's own: set to 0 just before it
        and read just after it, before the checks (``serve_checks``) and the
        timed replays run anything.  Then the reference's three serving
        fault cases on a server of their own.  Returns the phase's
        results."""
        torch = self.torch
        import gc
        import threading

        import numpy as np
        from repro_torch.core import faults
        from repro_torch.serve import BlazeClient, BlazeServer, RemoteServeError

        dev = self.dev
        t_phase = time.perf_counter()
        faults.reset(env=False)
        gc.collect()
        torch.cuda.empty_cache()
        work = serve_traffic()
        first = {}  # query -> the tenant-0 params of its first request
        for _t, q, p in work:
            first.setdefault(q, p)
        burst = [w for w in work if not (w[0] == "tenant0" and first[w[1]] is w[2])]
        srv = BlazeServer(device=dev, max_queue=len(burst), per_tenant_inflight=24,
                          max_batch=8)
        strict = self.strict_phase_1(srv)
        srv.register_dataset("edges", data["edges_np"], n_pages=data["n_pages"])
        srv.register_dataset("lines", data["lines_np"], vocab_size=data["vocab"])
        srv.register_dataset("points", data["points_np"])
        srv.register_dataset("gmm_points", data["gmm_points_np"])
        batches, finished = [], {}
        execute, finish = srv._execute_batch, srv._finish

        def timed(batch):
            t0 = time.perf_counter()
            execute(batch)
            batches.append({"wall_ms": (time.perf_counter() - t0) * 1e3,
                            "groups": [(r.query, r.params.get("iters", 1))
                                       for r in batch if r.meta.get("cache") != "dedup"],
                            "size": len(batch)})

        def finished_at(req, *, ok):
            # the dispatcher accounts a request just before releasing it
            finished[req.id] = time.perf_counter()
            return finish(req, ok=ok)

        srv._execute_batch, srv._finish = timed, finished_at
        srv.start()
        self.sync()
        self.zero_launch_counts()
        srv.session.stats.graph_launches = {}
        res = {}
        try:
            # -- the first request of each query, alone: its capture ----------
            first_ms = {}
            for q, p in first.items():
                t0 = time.perf_counter()
                _r, meta = srv.submit_and_wait("tenant0", q, p)
                first_ms[q] = (time.perf_counter() - t0) * 1e3
                if meta["cache"] != "compile":
                    raise AssertionError(f"serve: the first {q} request was a {meta['cache']}")
            # -- the burst: 66 requests, dispatch paused, then released -------
            srv.pause_dispatch()
            reqs = [(q, p, srv.submit(t, q, p)) for t, q, p in burst]
            t0 = time.perf_counter()
            try:
                BlazeClient(srv.url, tenant="probe").query("pi", first["pi"])
                raise AssertionError("serve: a full queue admitted a request")
            except RemoteServeError as e:
                full_ms = (time.perf_counter() - t0) * 1e3
                if (e.code, e.status) != ("QUEUE_FULL", 429) or full_ms > 2000:
                    raise AssertionError(f"serve: saturation gave {e.code} {e.status} "
                                         f"in {full_ms} ms") from e
            t_release = time.perf_counter()
            srv.resume_dispatch()
            for q, _p, r in reqs:
                if not r.done.wait(600) or r.error is not None:
                    raise AssertionError(f"serve: a {q} request failed: {r.error}")
            burst_s = max(finished[r.id] for *_x, r in reqs) - t_release
            st = srv.stats.snapshot()
            if (st["compiles"] != 6 or st["cache_hits"] + st["compiles"] != st["dispatched_plans"]
                    or st["batched_dispatches"] < 1 or st["dedup_hits"] < 1
                    or st["completed"] != len(work) or srv.session.stats.program_compiles != 6):
                raise AssertionError(f"serve: stats after the traffic {st}")
            latency = {}
            for q in first:
                lat = [(finished[r.id] - r.t_submit) * 1e3 for q2, _p, r in reqs if q2 == q]
                latency[q] = {"n": len(lat), "p50_ms": float(np.percentile(lat, 50)),
                              "p99_ms": float(np.percentile(lat, 99))}
            # -- a hit of each query, alone ------------------------------------
            hit_ms = {}
            for q, p in first.items():
                t0 = time.perf_counter()
                _r, meta = srv.submit_and_wait("tenant0", q, p)
                hit_ms[q] = (time.perf_counter() - t0) * 1e3
                if meta["cache"] != "hit":
                    raise AssertionError(f"serve: a repeated {q} request was a {meta['cache']}")
            # -- one HTTP round trip a query, deduplicated with an in-process
            # request, so both carry one execution's payload -----------------
            srv.pause_dispatch()
            inproc = {q: srv.submit("inproc", q, p) for q, p in first.items()}
            http, errors = {}, []

            def call(q, p):
                try:
                    http[q] = BlazeClient(srv.url, tenant="http").query(q, p)
                except Exception as e:  # noqa: BLE001 — reported below
                    errors.append(e)

            threads = [threading.Thread(target=call, args=qp) for qp in first.items()]
            for th in threads:
                th.start()
            deadline = time.perf_counter() + 30
            while srv.queue_depth < 2 * len(first) and time.perf_counter() < deadline:
                time.sleep(0.01)
            srv.resume_dispatch()
            for th in threads:
                th.join(600)
            if errors or len(http) != len(first):
                raise AssertionError(f"serve: HTTP round trips failed: {errors}")
            for q, r in inproc.items():
                if not r.done.wait(600) or r.error is not None:
                    raise AssertionError(f"serve: in-process {q} failed: {r.error}")
                got, meta = http[q]
                if meta["cache"] != "dedup":
                    raise AssertionError(f"serve: the HTTP {q} request was a {meta['cache']}")
                for key, want in r.result.items():
                    g = got[key]
                    same = (g == want if isinstance(want, float) else
                            np.asarray(g).dtype == want.dtype and
                            np.asarray(g).tobytes() == want.tobytes())
                    if not same:
                        raise AssertionError(f"serve: HTTP {q} {key} differs from in-process")
            res["http_bit_equal"] = sorted(http)
            # -- the served traffic's launches and strict groups, read before
            # the checks and the timed replays launch anything ------------
            launches = self.read_launch_counts()
            launches["graph_replays"] = dict(srv.session.stats.graph_launches)
            served = srv.stats.snapshot()
            strict_groups = strict["groups"]
            res.update(self.serve_checks(data, srv, reqs))
            res["replays"] = self.serve_replays(srv, first, batches)
            snap = srv.stats_snapshot()
        finally:
            srv.stop()
        for kernel in ("segment_reduce", "hash_aggregate"):
            if not launches[kernel] or not launches["graph_replays"].get(kernel):
                raise AssertionError(f"serve: the served requests launched no {kernel}")
        if strict_groups != served["cache_hits"] or not strict_groups:
            raise AssertionError(f"serve: {strict_groups} groups ran phase 1 under "
                                 f"sync-debug, {served['cache_hits']} cache hits")
        if srv.session.stats.retries or srv.session.stats.degraded_nodes:
            raise AssertionError("serve: the traffic retried or degraded")
        self.serve_launches = launches
        res.update({
            "requests": served["completed"],
            "rejected_queue_full": served["rejected_queue_full"],
            "compiles": served["compiles"], "cache_hits": served["cache_hits"],
            "dispatched_plans": served["dispatched_plans"], "dispatches": served["dispatches"],
            "batched_dispatches": served["batched_dispatches"],
            "coalesced_queries": served["coalesced_queries"],
            "dedup_hits": served["dedup_hits"],
            "queue_full_ms": full_ms, "burst_requests": len(burst), "burst_s": burst_s,
            "burst_qps": len(burst) / burst_s, "latency": latency,
            "first_request_ms": first_ms, "hit_ms": hit_ms,
            "pools": {r["query"]: r["pool_reserved_bytes"] for r in snap["resident"]},
            "pool_reserved_bytes": snap["pool_reserved_bytes"],
            "launches": launches,
            "phase1_strict_sync_groups": strict_groups})
        del srv
        gc.collect()
        torch.cuda.empty_cache()
        self.phase = "serve faults"
        res["faults"] = self.serve_fault_cases(data)
        res["phase_s"] = time.perf_counter() - t_phase
        print(json.dumps({"serve": res}), flush=True)
        return res

    def strict_phase_1(self, srv):
        """Wrap ``srv.session.supervised`` so that the dispatch of a
        resident program (one that has dispatched before, with no fault rule
        armed: a first dispatch captures and a degradation recaptures, both
        of which synchronise) runs under sync-debug ``"error"``: a host sync
        in that phase 1 raises and fails its requests.  Returns the count of
        groups that ran so, ``{"groups": n}``."""
        torch = self.torch
        from repro_torch.core import faults

        strict = {"groups": 0}
        supervised = srv.session.supervised

        def strict_supervised(attempt, *, program=None, **kw):
            if program is None or not program.stats.dispatches or faults.registry.armed:
                return supervised(attempt, program=program, **kw)
            strict["groups"] += 1
            prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                return supervised(attempt, program=program, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(prev)

        srv.session.supervised = strict_supervised
        return strict

    def serve_checks(self, data, srv, reqs):
        """The served results: word counts against the path phase's exactly,
        π's counts against the hand-rolled count exactly, and every distinct
        float request against ``run_direct`` on a fresh session on the card
        and against a plain reference of its own (PageRank per page within
        the per-op tolerance, and against the float64 reference; k-means
        centres 1e-4 and inertia 1e-4 relative, seed 0's centres against the
        per-op reference too; GMM log-likelihood 1e-5 relative, α 1e-4, μ and
        Σ 1e-3, and the same against a float64 EM from the request's initial
        means; kNN distances 1e-5 relative and the same rows but for ties of
        the 100th, and the same against a float64 ``torch.topk`` of every
        distance)."""
        torch = self.torch
        import gc

        import numpy as np
        from repro_torch.core import BlazeSession
        from repro_torch.core.algorithms.pi import handrolled_count
        from repro_torch.serve import run_direct
        from repro_torch.serve.queries import canonical_params

        dev = self.dev
        served = {}
        for q, p, r in reqs:
            served.setdefault((q, canonical_params(p)), (q, p, r.result))
        out = {"checked": {}}
        fresh = BlazeSession(device=dev)
        hand = {}
        for (q, _c), (_q, p, got) in served.items():
            if q == "wordcount":
                dense = np.zeros(data["vocab"], np.int64)
                dense[got["keys"]] = got["counts"]
                if not np.array_equal(dense, self.per_op["wordcount"]):
                    raise AssertionError("serve: word counts differ from the path phase's")
                out["wordcount_distinct"] = int(len(got["keys"]))
                continue
            if q == "pi":
                n = p["n_samples"]
                hand.setdefault(n, handrolled_count(n, dev))
                if int(got["counts"][0]) != hand[n] or got["pi"] != 4.0 * hand[n] / n:
                    raise AssertionError("serve: pi differs from the hand-rolled count")
                out["pi"] = got["pi"]
                continue
            want = run_direct(fresh, srv.datasets, q, p)
            if q == "pagerank":
                ref, tol, _ = self.pagerank_reference(data, p["iters"], 0.85)
                g = torch.from_numpy(got["scores"]).to(dev).double()
                d = (g - torch.from_numpy(want["scores"]).to(dev).double()).abs()
                if not (bool((d <= tol).all()) and bool(((g - ref).abs() <= tol).all())):
                    raise AssertionError(f"serve: pagerank {p} over its tolerance")
                err = {"max_diff_direct": float(d.max()),
                       "max_rel_err": float(((g - ref).abs() / ref).max())}
            elif q == "kmeans":
                err = {"centre_diff_direct": float(np.abs(got["centers"] - want["centers"]).max()),
                       "inertia_rel_diff": abs(got["inertia"] - want["inertia"]) / want["inertia"]}
                if p["seed"] == 0 and p["iters"] == 5:
                    _km, ref_c, _ri = self.per_op["kmeans"]
                    err["centre_err_ref"] = float(np.abs(got["centers"] - ref_c).max())
                if max(err["centre_diff_direct"], err.get("centre_err_ref", 0.0)) > 1e-4 \
                        or err["inertia_rel_diff"] > 1e-4:
                    raise AssertionError(f"serve: kmeans {p}: {err}")
            elif q == "gmm":
                x = data["gmm_points"]
                idx = np.random.RandomState(p.get("seed", 0)).choice(len(x), p["k"],
                                                                      replace=False)
                ref = self.gmm_reference(x, p["k"], p["iters"],
                                         mu0=x[torch.from_numpy(idx).to(dev)])
                ref["log_likelihood"] = ref.pop("ll")
                err = {}
                for tag, w in (("", want), ("_ref", ref)):
                    e = {k: float(np.abs(got[k] - w[k]).max()) for k in ("alpha", "mu", "sigma")}
                    e["ll_rel"] = (abs(got["log_likelihood"] - w["log_likelihood"])
                                   / abs(w["log_likelihood"]))
                    if (e["ll_rel"] > 1e-5 or e["alpha"] > 1e-4
                            or max(e["mu"], e["sigma"]) > 1e-3):
                        raise AssertionError(f"serve: gmm {p}{tag}: {e}")
                    err.update({k + tag: v for k, v in e.items()})
            else:  # knn
                qv = np.asarray(p["query"], np.float64)
                g = np.sort(got["distances"].astype(np.float64))
                rows = {tuple(x) for x in got["neighbors"].tolist()}
                ref_d, ref_rows, _ = self.knn_reference(data["points"], qv, p["k"])
                err = {}
                for tag, w, wrows in (
                        ("_direct", np.sort(want["distances"].astype(np.float64)),
                         {tuple(x) for x in want["neighbors"].tolist()}),
                        ("_ref", ref_d, ref_rows)):
                    err["dist_rel_diff" + tag] = float(
                        (np.abs(g - w) / np.maximum(w, 1e-30)).max())
                    kth = max(float(g[-1]), float(w[-1])) ** 2
                    for row in rows ^ wrows:
                        if abs(float(((np.asarray(row, np.float64) - qv) ** 2).sum()) - kth) \
                                > 1e-5 * kth:
                            raise AssertionError(f"serve: knn {p}: a neighbour differs{tag}")
                    if err["dist_rel_diff" + tag] > 1e-5:
                        raise AssertionError(f"serve: knn {p}: {err}")
            out["checked"].setdefault(q, []).append({"params": p, **err})
            del want
            gc.collect()
            torch.cuda.empty_cache()
        del fresh
        gc.collect()
        torch.cuda.empty_cache()
        return out

    def serve_replays(self, srv, first, batches):
        """One replay of each resident plan timed alone (CUDA events around
        one dispatch of the program, from the state a one-iteration ``run``
        returned: no per-request host work inside), and each batch's wall
        time beside the sum of its executions' replays (iterations × that
        plan's replay)."""
        torch = self.torch
        replay_ms = {}
        with srv.session.lock:
            for prep in srv._programs.values():
                q = prep.plan_key[0]
                prep.program.reset_carry()
                out = prep.run({**first[q], "iters": 1})
                state = out["state"] if q == "wordcount" else out
                self.sync()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                prep.program(state, 1)
                end.record()
                end.synchronize()
                replay_ms[q] = start.elapsed_time(end)
        rows = []
        for b in batches:
            if b["size"] < 2:
                continue
            est = sum(replay_ms[q] * (1 if q == "knn" else it) for q, it in b["groups"])
            rows.append({"size": b["size"], "executions": len(b["groups"]),
                         "query": b["groups"][0][0], "wall_ms": b["wall_ms"],
                         "replays_ms": est})
        print(json.dumps({"serve_batches": rows, "replay_ms": replay_ms}), flush=True)
        return {"replay_ms": replay_ms, "batches": rows}

    def serve_fault_cases(self, data):
        """The reference's three serving fault cases on a server of their
        own (``tests/test_faults.py``'s ``serve`` cases): a transient
        ``dispatch`` fault retried; a ``kernel.segment`` fault degrading the
        k-means program at 10^8 points, which captures again, the follow-up
        request a hit with no new compile; shutdown draining a held backlog
        with typed ``SHUTDOWN``.  Each ledger balanced."""
        import numpy as np
        from repro_torch.core import faults
        from repro_torch.serve import BlazeServer

        dev = self.dev
        out = {}
        srv = BlazeServer(device=dev, max_batch=4)
        srv.register_dataset("points", data["points_np"])
        with srv:
            q = {"engine": "pallas", "n_samples": 1 << 20, "iters": 2}
            r0, _ = srv.submit_and_wait("t", "pi", q)
            faults.configure("dispatch", at=1)
            r1, m1 = srv.submit_and_wait("t", "pi", q)
            rec = srv.stats_snapshot()["recovery"]
            if (int(r1["counts"][0]) != int(r0["counts"][0]) or rec["retried_batches"] != 1
                    or m1["cache"] != "hit"):
                raise AssertionError(f"serve faults: retry {rec}, {m1}")
            out["retry"] = {"ledger": self.fault_ledger("serve retry", retried=1),
                            "retried_batches": rec["retried_batches"]}
            kq = {"engine": "pallas", "k": 5, "iters": 3, "seed": 0}
            c0, _ = srv.submit_and_wait("t", "kmeans", kq)
            prog = next(p.program for p in srv._programs.values() if p.plan_key[0] == "kmeans")
            before = dict(prog.stats.captured_launches[1])
            faults.configure("kernel.segment", at=1)
            t0 = time.perf_counter()
            c1, m1 = srv.submit_and_wait("t", "kmeans", kq)
            degrade_ms = (time.perf_counter() - t0) * 1e3
            compiles0 = srv.session.stats.program_compiles
            t0 = time.perf_counter()
            c2, m2 = srv.submit_and_wait("t", "kmeans", kq)
            follow_ms = (time.perf_counter() - t0) * 1e3
            rec = srv.stats_snapshot()["recovery"]
            if (m2["cache"] != "hit" or srv.session.stats.program_compiles != compiles0
                    or rec["degraded_batches"] != 1 or rec["session_degraded_nodes"] != 1
                    or prog.stats.captures != 2
                    or "segment_reduce" in prog.stats.captured_launches[1]
                    or not np.isfinite(c2["centers"]).all()):
                raise AssertionError(f"serve faults: degrade {rec}, {m1}, {m2}, "
                                     f"{prog.stats.captured_launches}")
            out["degrade"] = {
                "ledger": self.fault_ledger("serve degrade", degraded=1),
                "degrading_request_ms": degrade_ms, "follow_up_ms": follow_ms,
                "captures": prog.stats.captures,
                "launches_per_replay": [before, dict(prog.stats.captured_launches[1])],
                # eager's f32 counts at 10^8 points (ROADMAP Queue 3 item 3)
                "centre_diff_eager": float(np.abs(c2["centers"] - c0["centers"]).max())}
        srv = BlazeServer(device=dev, max_batch=4)
        srv.start()
        srv.pause_dispatch()
        reqs = [srv.submit("t", "pi", {"n_samples": 1 << 20}) for _ in range(5)]
        srv.stop(drain_timeout=2.0)
        snap = srv.stats.snapshot()
        if (not all(r.done.is_set() and r.error is not None and r.error.code == "SHUTDOWN"
                    for r in reqs)
                or snap["queued"] or snap["submitted"] != snap["completed"] + snap["failed"]):
            raise AssertionError(f"serve faults: shutdown {snap}")
        faults_snap = faults.snapshot()
        if faults_snap["injected_total"] or not faults_snap["balanced"]:
            raise AssertionError(f"serve faults: shutdown ledger {faults_snap}")
        out["shutdown"] = {"drained": len(reqs), "failed": snap["failed"]}
        return out

    def check_supervision(self):
        """Every session the other phases made ended with no retry, no
        degraded node and no escalation."""
        seen = {}
        for phase, st in self.session_stats:
            if phase in ("fault", "serve faults", "multinode faults"):
                continue
            agg = seen.setdefault(phase, {"sessions": 0, "retries": 0, "degraded_nodes": 0,
                                          "escalations": 0})
            agg["sessions"] += 1
            for k in ("retries", "degraded_nodes", "escalations"):
                agg[k] += getattr(st, k)
        print(json.dumps({"supervision": seen}), flush=True)
        bad = {p: a for p, a in seen.items()
               if a["retries"] or a["degraded_nodes"] or a["escalations"]}
        if bad:
            raise AssertionError(f"supervision retried or degraded outside the fault "
                                 f"phase: {bad}")
        return seen

    # -- wire phase -----------------------------------------------------------

    def wire_phase(self, data):
        """PageRank and k-means at 4 shards stacked on the card with
        ``wire="bf16"`` and ``"int8"``, per op and as programs, each within
        2e-2 relative of its float64 reference; the shuffle payload of all
        three wires; and the int8 residual carried in a program (module
        docstring)."""
        torch = self.torch
        import importlib

        import numpy as np
        from repro_torch.core import BlazeSession, DistVector
        from repro_torch.core.algorithms import kmeans, pagerank

        pr_mod = importlib.import_module("repro_torch.core.algorithms.pagerank")
        dev = self.dev
        edges_np, n_pages = data["edges_np"], data["n_pages"]
        pts_np = data["points_np"]
        init = data["init_centers"].cpu().numpy()
        _, pr_ref, pr_tol = self.per_op["pagerank"]
        _, km_ref, _ = self.per_op["kmeans"]
        out = {"payload_bytes": {}, "rel_err": {}}
        for wire in ("none", "bf16", "int8"):
            for mode in ("per_op",) if wire == "none" else ("per_op", "program"):
                tag = f"wire={wire} {mode}"
                sess = BlazeSession(device=dev, n_shards=4)
                pr, _, pr_launch = self.drive(
                    f"pagerank {tag}", lambda: pagerank(
                        edges_np, n_pages, tol=0.0, max_iters=5, engine="pallas",
                        wire=wire, mode=mode, unroll=5, session=sess),
                    5 * len(edges_np))
                km, _, km_launch = self.drive(
                    f"kmeans {tag}", lambda: kmeans(
                        pts_np, 5, init_centers=init, tol=0.0, max_iters=5,
                        engine="pallas", wire=wire, mode=mode, unroll=5, session=sess),
                    5 * len(pts_np))
                if mode == "program":
                    if not sess.stats.graph_replays == sess.stats.program_dispatches > 0:
                        raise AssertionError(f"{tag}: a program dispatch ran without a graph")
                    k1 = sess.stats.graph_launches.get("segment_reduce", 0)
                else:
                    k1 = min(pr_launch["segment_reduce"], km_launch["segment_reduce"])
                if k1 == 0:
                    raise AssertionError(f"{tag}: K1 did not run")
                ref = pr_ref.cpu().numpy()
                rel = (float(np.abs(pr.scores - ref).max() / ref.max()),
                       float(np.abs(km.centers - km_ref).max() / np.abs(km_ref).max()))
                out["rel_err"][tag] = {"pagerank": rel[0], "kmeans": rel[1]}
                if wire == "int8" and mode == "per_op":  # against the wire's emulation
                    emu, steps = pagerank_int8_emulation(data["edges"], data["deg"],
                                                         n_pages, 4, 5)
                    err = (torch.from_numpy(pr.scores).to(dev).double() - emu).abs()
                    share = float((err / (sum(steps) + 1e-5 * emu)).max())
                    agree = float((err <= 1e-3 * emu).double().mean())
                    out["rel_err"][tag].update(
                        pagerank_share_of_bound=share, pagerank_pages_agreeing=agree,
                        pagerank_emulation_vs_float64=float(
                            (emu - pr_ref).abs().max() / pr_ref.max()))
                    if share > 1.0 or agree < 0.9:
                        raise AssertionError(f"{tag}: PageRank off its int8 emulation "
                                             f"({share} of the bound, {agree} of the "
                                             f"pages within 1e-3)")
                    rel = (0.0, rel[1])  # held to the emulation, not to 2e-2
                if wire == "int8":  # per centre, within the lattice's reach
                    reach = kmeans_int8_reach(data["points"], km_ref, 4, 5,
                                              mode == "program")
                    share = float((np.abs(km.centers - km_ref) / reach).max())
                    out["rel_err"][tag]["kmeans_share_of_reach"] = share
                    rel = (rel[0], share * 2e-2)
                if max(rel) > 2e-2:
                    raise AssertionError(f"{tag}: {out['rel_err'][tag]} over the tolerance")
                if mode == "per_op":
                    out["payload_bytes"][wire] = {"pagerank": pr.shuffle_bytes_per_iter,
                                                  "kmeans": km.shuffle_bytes_per_iter}
                del pr, km, sess
                torch.cuda.empty_cache()
        pb = out["payload_bytes"]
        if not (pb["int8"]["pagerank"] * 4 == pb["bf16"]["pagerank"] * 2
                == pb["none"]["pagerank"] == 4 * 4 * n_pages):
            raise AssertionError(f"pagerank payload bytes {pb}")

        # The int8 residual is carried: 5 iterations that accumulate
        # PageRank's contribution sums at fixed scores land closer to 5x the
        # float64 sums than the same program with its residual reset after
        # every dispatch, and acc + the shards' residuals telescope to them.
        sess = BlazeSession(device=dev, n_shards=4)
        edges_v = sess.distribute(edges_np)
        deg = data["deg"]
        scores = torch.full((n_pages,), 1.0 / n_pages, device=dev)
        src, dst = data["edges"][:, 0].long(), data["edges"][:, 1].long()
        exact = torch.zeros(n_pages, dtype=torch.float64, device=dev).index_add_(
            0, dst, scores.double()[src] / torch.clamp(deg[src], min=1).double())
        in_deg = torch.bincount(dst, minlength=n_pages).double()

        def step(ctx, s):
            inc = ctx.map_reduce(edges_v, pr_mod.contrib_mapper, "sum",
                                 torch.zeros(n_pages, device=dev), engine="pallas",
                                 wire="int8", env=(scores, deg))
            return {"acc": s["acc"] + inc}

        errs = {}
        for carried in (True, False):
            prog = sess.program(step)
            state = {"acc": torch.zeros(n_pages, device=dev)}
            for _ in range(5):
                state = prog(state, 1)
                if not carried:
                    prog.reset_carry()
            acc = state["acc"].double()
            errs[carried] = float((acc - 5 * exact).abs().max())
            if carried:
                (res,) = prog.export_carry(state)["residual"]
                tele = (acc + res.double().sum(0) - 5 * exact).abs()
                if not bool((tele <= 5 * exact * (1e-4 + 5 * in_deg * F32_U)).all()):
                    raise AssertionError("int8 program: acc + residual does not "
                                         "telescope to 5x the exact sums")
        if not errs[True] < errs[False]:
            raise AssertionError(f"int8 program: the carried residual is no closer "
                                 f"({errs[True]} against {errs[False]})")
        out["int8_accumulated_err"] = {"carried": errs[True], "reset": errs[False]}

        # For the record: 5 PageRank iterations with and without the carry.
        step, state0 = pr_mod._program_step(edges_v, deg, n_pages, 0.85, "pallas", "int8")
        ref = pr_ref
        pr_errs = {}
        for carried in (True, False):
            prog = sess.program(step)
            state = state0(scores)
            for _ in range(5):
                state = prog(state, 1)
                if not carried:
                    prog.reset_carry()
            e = (state["scores"].double() - ref).abs()
            pr_errs["carried" if carried else "reset"] = {"max": float(e.max()),
                                                          "sum": float(e.sum())}
        out["int8_pagerank_err"] = pr_errs
        del sess, prog, edges_v
        torch.cuda.empty_cache()
        print(json.dumps({"wire_results": out}), flush=True)

    # -- multinode phase ------------------------------------------------------

    def multinode_phase(self, data):
        """The ``("node", "data")`` topology on the card (module docstring,
        7): the 8 shards stacked on the card as (1x8), (2x4) and (4x2),
        ``engine="pallas"``, the path phase's data.  Per topology, and on
        (2x4) and (4x2) hierarchical and flat: PageRank, k-means and
        wordcount per op and as programs, PageRank and k-means also with
        ``wire="int8"``, fig. 6's hand-fused step (K3 on each shard, the
        partials reduced over the mesh) as a program, and the exactness law
        (integer-valued rows: the same bits everywhere); one k-means
        ``run_stream`` on (2x4); the byte accounting; K1, K2 and K3's
        launches and the graph replays per topology; a transient
        ``collective.inter`` fault retried on (2x4)."""
        torch = self.torch
        import functools
        import importlib

        import numpy as np
        from repro_torch.core import BlazeSession, DistVector, faults
        from repro_torch.core.algorithms import kmeans, pagerank, wordcount
        from repro_torch.core.mapreduce import make_collectives, reduce_edge_bytes
        from repro_torch.core.reducers import get_reducer
        from repro_torch.kernels import ops
        from repro_torch.launch.mesh import make_node_data_mesh

        alg = {m: importlib.import_module("repro_torch.core.algorithms." + m)
               for m in ("kmeans", "pagerank", "wordcount")}
        dev = self.dev
        t_phase = time.perf_counter()
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()[0]
        kernels = ("segment_reduce", "hash_aggregate", "kmeans_assign")
        edges_np, n_pages = data["edges_np"], data["n_pages"]
        edges_v = DistVector(data["edges"], edges_np.shape[0])
        scores0 = torch.full((n_pages,), 1.0 / n_pages, device=dev)
        pts, c0 = data["points"], data["init_centers"]
        n_pts, dim = pts.shape
        pts_v = DistVector(pts, n_pts)
        init = c0.cpu().numpy()
        lines, vocab = data["lines_np"], data["vocab"]
        tokens_v = DistVector(data["tokens"], lines.shape[0])
        _, pr_ref, pr_tol = self.per_op["pagerank"]
        km_ref, ref_c, ref_inertia = self.per_op["kmeans"]

        # The exactness law's rows: integers in [0, 4), 2^22 rows keyed
        # i % 64, so every partial and total is an integer below 2^24.
        g = torch.Generator(device=dev).manual_seed(0)
        law_rows = torch.randint(0, 4, (1 << 22, 4), generator=g, device=dev).float()
        law_v = DistVector(law_rows, law_rows.shape[0])
        law_oracle = law_rows.cpu().numpy().astype(np.int64).reshape(-1, 64, 4).sum(0)

        def law_mapper(i, x, emit):
            emit(i % 64, x)

        def law_step(ctx, s):
            t = ctx.map_reduce(law_v, law_mapper, "sum", torch.zeros(64, 4, device=dev),
                               engine="pallas")
            return {"acc": s["acc"] + t}

        def pr_check(tag, scores, wire, mode, shards):
            got = torch.as_tensor(scores).to(dev).double()
            rel = float(((got - pr_ref).abs() / pr_ref).max())
            if wire == "none":
                if not bool(((got - pr_ref).abs() <= pr_tol).all()):
                    raise AssertionError(f"multinode pagerank {tag}: a page is over its "
                                         "tolerance")
                return {"max_rel_err": rel}
            if mode == "program":  # the wire phase's 2e-2
                err = float((got - pr_ref).abs().max() / pr_ref.max())
                if err > 2e-2:
                    raise AssertionError(f"multinode pagerank {tag}: {err} over 2e-2")
                return {"max_rel_err": rel, "float64_rel_err": err}
            emu, steps = pagerank_int8_emulation(data["edges"], data["deg"], n_pages, shards, 5)
            err = (got - emu).abs()
            share = float((err / (sum(steps) + 1e-5 * emu)).max())
            agree = float((err <= 1e-3 * emu).double().mean())
            if share > 1.0 or agree < 0.9:
                raise AssertionError(f"multinode pagerank {tag}: off its int8 emulation "
                                     f"({share} of the bound, {agree} within 1e-3)")
            return {"max_rel_err": rel, "share_of_emulation_bound": share,
                    "pages_agreeing": agree,
                    "float64_rel_err": float((got - pr_ref).abs().max() / pr_ref.max())}

        def km_check(tag, centers, inertia, wire, mode, shards):
            centers = centers.cpu().numpy() if hasattr(centers, "cpu") else centers
            err = float(np.abs(centers - ref_c).max())
            if wire == "int8":
                reach = kmeans_int8_reach(pts, ref_c, shards, 5, mode == "program")
                share = float((np.abs(centers - ref_c) / reach).max())
                if share > 1.0:
                    raise AssertionError(f"multinode kmeans {tag}: {share} of the int8 reach")
                return {"centre_err": err, "share_of_int8_reach": share}
            if err > 1e-4 or abs(inertia - ref_inertia) > 1e-4 * ref_inertia:
                raise AssertionError(f"multinode kmeans {tag}: centre error {err}, inertia "
                                     f"{inertia} vs {ref_inertia}")
            return {"centre_err": err, "inertia_rel_err": abs(inertia - ref_inertia)
                    / ref_inertia}

        def wc_check(tag, hm):
            keys, vals = hm.items()
            got = np.zeros(vocab, np.int64)
            got[keys] = vals
            if hm.total_overflow() or not np.array_equal(got, self.per_op["wordcount"]):
                raise AssertionError(f"multinode wordcount {tag} differs from per-op")
            return {"distinct": int(len(keys))}

        results = {"card": card, "topologies": {}, "graph_replays": {}}
        law_bits, km_program, pr_clean = {}, {}, {}
        for n_nodes in (1, 2, 4):
            mesh = make_node_data_mesh(n_nodes, n_shards=8, device=dev)
            topo = f"{n_nodes}x{8 // n_nodes}"
            counts = {k: {"wrappers": 0, "graph_replays": 0} for k in kernels}
            replays = 0
            res_t = results["topologies"][topo] = {}
            for hier in ((True,) if n_nodes == 1 else (True, False)):
                tag = f"{topo} {'hier' if hier else 'flat'}"
                sess = BlazeSession(mesh=mesh)
                if not hier:  # every op and program of this session flat
                    sess.map_reduce = functools.partial(sess.map_reduce, hierarchical=False)
                    sess.program = functools.partial(sess.program, hierarchical=False)
                shards = n_nodes if hier and n_nodes > 1 else 8  # addends of the narrowed hop
                r = res_t["hier" if hier else "flat"] = {"walls": {}, "checks": {}}

                def per_op(name, fn, units):
                    out, wall, launch = self.drive(f"multinode {tag} {name}", fn, units)
                    r["walls"].setdefault(name, {})["per_op_s"] = wall
                    for k in kernels:
                        counts[k]["wrappers"] += launch[k]
                    return out

                def program(name, prog, run, units):
                    nonlocal replays
                    key = f"multinode {tag} {name}"
                    out = self.program_job(key, prog, run, units)
                    first, replay = self.program_runs[key]["walls"]
                    r["walls"].setdefault(name, {}).update(
                        program_first_s=first, program_replay_s=replay)
                    for k in kernels:
                        counts[k]["wrappers"] += self.program_runs[key]["first_launches"][k]
                        counts[k]["graph_replays"] += prog.stats.replay_launches.get(k, 0)
                    replays += prog.stats.replays
                    return out

                # the exactness law, per op and as a program; its bytes
                got, st = per_op("law", lambda: sess.map_reduce(
                    law_v, law_mapper, "sum", torch.zeros(64, 4, device=dev),
                    engine="pallas", return_stats=True), law_rows.shape[0])
                st = st.finalize()
                want_bytes = reduce_edge_bytes(256, 4, 4, 8, n_nodes, hier)
                if (st.intra_bytes, st.inter_bytes) != want_bytes:
                    raise AssertionError(f"multinode {tag}: law bytes {st}, want {want_bytes}")
                if ("hier" in st.collective) != (hier and n_nodes > 1):
                    raise AssertionError(f"multinode {tag}: collective {st.collective}")
                prog = sess.program(law_step)
                state0 = {"acc": torch.zeros(64, 4, device=dev)}
                acc = program("law", prog, lambda: sess.run_loop(prog, state0, max_iters=3,
                                                                  unroll=3), 3 * law_rows.shape[0])
                law_bits[f"{tag} per_op"] = got
                law_bits[f"{tag} program"] = acc["acc"] / 3
                if not (np.array_equal(got.cpu().numpy(), law_oracle)
                        and np.array_equal(acc["acc"].cpu().numpy(), 3 * law_oracle)):
                    raise AssertionError(f"multinode {tag}: the law's sums differ from NumPy")
                r["bytes"] = {"dense": {"collective": st.collective, "intra": st.intra_bytes,
                                        "inter": st.inter_bytes}}
                del prog

                # PageRank, k-means, wordcount per op; PageRank, k-means int8
                for wire in ("none", "int8"):
                    pr = per_op(f"pagerank {wire}", lambda: pagerank(
                        edges_np, n_pages, tol=0.0, max_iters=5, engine="pallas", wire=wire,
                        session=sess), 5 * len(edges_np))
                    r["checks"][f"pagerank {wire} per_op"] = pr_check(
                        tag, pr.scores, wire, "per_op", shards)
                    if wire == "none" and topo == "2x4" and hier:
                        pr_clean["scores"] = pr.scores
                    km = per_op(f"kmeans {wire}", lambda: kmeans(
                        pts_v, 5, init_centers=init, tol=0.0, max_iters=5, engine="pallas",
                        wire=wire, session=sess), 5 * n_pts)
                    r["checks"][f"kmeans {wire} per_op"] = km_check(
                        tag, km.centers, km.inertia, wire, "per_op", shards)
                    if topo == "1x8":
                        self.mn_1x8[f"pagerank {wire} per_op"] = pr.scores
                        self.mn_1x8[f"kmeans {wire} per_op"] = (km.centers, km.inertia)
                hm, st = per_op("wordcount", lambda: wordcount(
                    lines, engine="pallas", vocab_size=vocab, return_stats=True,
                    session=sess), int(lines.size))
                r["checks"]["wordcount per_op"] = wc_check(tag, hm)
                st = st.finalize()
                frac = (8 - 8 // n_nodes) / 8
                if (abs(st.inter_bytes - frac * st.shuffle_payload_bytes) > 1
                        or abs(st.intra_bytes + st.inter_bytes - st.shuffle_payload_bytes) > 1):
                    raise AssertionError(f"multinode {tag}: hash bytes {st}")
                r["bytes"]["hash"] = {"collective": st.collective, "intra": st.intra_bytes,
                                      "inter": st.inter_bytes}
                del hm

                # the same jobs as programs, unroll = their iterations
                for wire in ("none", "int8"):
                    step, s0 = alg["pagerank"]._program_step(edges_v, data["deg"], n_pages,
                                                             0.85, "pallas", wire)
                    prog = sess.program(step)
                    out = program(f"pagerank {wire}", prog, lambda: sess.run_loop(
                        prog, s0(scores0), cond=lambda s: float(s["delta"]) < 0.0,
                        max_iters=5, unroll=5), 5 * len(edges_np))
                    r["checks"][f"pagerank {wire} program"] = pr_check(
                        tag, out["scores"], wire, "program", shards)
                    if topo == "1x8":
                        self.mn_1x8[f"pagerank {wire} program"] = out["scores"]
                    step, s0 = alg["kmeans"]._program_step(pts_v, 5, dim, "pallas", wire)
                    prog = sess.program(step)

                    def km_run(prog=prog, s0=s0):
                        out, info = sess.run_loop(prog, s0(c0), cond=lambda s: float(
                            s["move"]) < 0.0, max_iters=5, unroll=5)
                        return (out["centers"], float(prog(out, 1)["inertia"])), info

                    centers, inertia = program(f"kmeans {wire}", prog, km_run, 5 * n_pts)
                    r["checks"][f"kmeans {wire} program"] = km_check(
                        tag, centers, inertia, wire, "program", shards)
                    if topo == "1x8":
                        self.mn_1x8[f"kmeans {wire} program"] = (centers, inertia)
                    if wire == "none":
                        km_program[tag] = (centers, inertia)
                    del prog
                hm = sess.make_dist_hashmap(max(64, 4 * vocab), (), torch.int32, "sum")
                step, s0 = alg["wordcount"]._program_step(tokens_v, hm, vocab, "pallas")
                prog = sess.program(step)

                def wc_run(prog=prog, s0=s0, hm=hm):
                    _, info = sess.run_loop(prog, s0, max_iters=1)
                    return prog.hash_result(hm), info

                r["checks"]["wordcount program"] = wc_check(
                    tag, program("wordcount", prog, wc_run, int(lines.size)))
                del prog, hm

                # fig. 6's hand-fused step on the mesh: K3 on each shard's
                # points, the [K, D+1] partials reduced over the mesh
                per = n_pts // 8
                coll = make_collectives(mesh)
                total = get_reducer("sum")

                def fig6_step(ctx, s, hier=hier, coll=coll):
                    parts = torch.stack([ops.kmeans_assign(pts[i * per:(i + 1) * per],
                                                           s["c"])[1] for i in range(8)])
                    st = coll.reduce(parts, total, hier=hier)
                    return {"c": st[:, :dim] / torch.clamp(st[:, dim:], min=1.0)}

                prog = sess.program(fig6_step)
                out = program("fig6", prog, lambda: sess.run_loop(
                    prog, {"c": c0}, max_iters=5, unroll=5), 5 * n_pts)
                err = float(np.abs(out["c"].cpu().numpy() - ref_c).max())
                if err > 1e-4:
                    raise AssertionError(f"multinode fig6 {tag}: centre error {err}")
                r["checks"]["fig6 program"] = {"centre_err": err}
                if topo == "1x8":
                    self.mn_1x8["fig6 program"] = out["c"]
                del prog, out

                if topo == "2x4" and hier:  # one k-means stream against the in-memory run
                    km_c = sess.chunked(data["points_np"], STREAM_BLOCK_ROWS)
                    ks = per_op("kmeans stream", lambda: kmeans(
                        km_c, 5, init_centers=init, tol=0.0, max_iters=5, engine="pallas",
                        mode="stream", session=sess), 5 * n_pts)
                    mem_c, mem_inertia = km_program[tag]
                    err = float(np.abs(ks.centers - mem_c.cpu().numpy()).max())
                    if err > 1e-4 or abs(ks.inertia - mem_inertia) > 1e-4 * mem_inertia:
                        raise AssertionError(f"multinode stream {tag}: {err} from the "
                                             f"in-memory run, inertia {ks.inertia} vs "
                                             f"{mem_inertia}")
                    r["checks"]["kmeans stream"] = {"centre_diff_in_memory": err}
                    del km_c, ks
                print(json.dumps({"multinode": tag, **r}), flush=True)
                del sess
                torch.cuda.empty_cache()
            for k in kernels:
                if counts[k]["wrappers"] + counts[k]["graph_replays"] == 0:
                    raise AssertionError(f"multinode {topo}: {k} did not run")
                self.multinode_launches.setdefault(k, {})[topo] = counts[k]
            if replays == 0:
                raise AssertionError(f"multinode {topo}: no graph replay")
            results["graph_replays"][topo] = replays

        self.mn_1x8.update(law=law_bits, law_rows=law_rows, checks=(pr_check, km_check, wc_check),
                           walls=results["topologies"]["1x8"]["hier"]["walls"])
        # The law: the same bits hierarchical and flat, on every topology,
        # per op and as a program.
        first = law_bits["1x8 hier per_op"]
        if not all(torch.equal(first, b) for b in law_bits.values()):
            raise AssertionError("multinode: the exactness law's bits differ")
        results["law_bit_equal"] = sorted(law_bits)
        for wire in ("none", "int8"):
            results[f"hier_vs_flat_{wire}"] = {
                topo: {h: {k: v for k, v in res_t[h]["checks"].items()
                           if k.startswith(("pagerank " + wire, "kmeans " + wire))}
                       for h in res_t}
                for topo, res_t in results["topologies"].items() if topo != "1x8"}
        results["walls_vs_1x8"] = {
            f"{topo} {h}": {job: {k: v / results["topologies"]["1x8"]["hier"]["walls"][job][k]
                                  for k, v in w.items()}
                            for job, w in res_t[h]["walls"].items()
                            if job in results["topologies"]["1x8"]["hier"]["walls"]}
            for topo, res_t in results["topologies"].items() for h in res_t}

        # A transient collective.inter fault on (2x4), retried: the law's op
        # gives the fault-free bits; per-op PageRank (float sums by K1's
        # atomics, which two fault-free runs need not share) stays within
        # its per-page tolerance of the fault-free run.
        self.phase = "multinode faults"
        mesh = make_node_data_mesh(2, n_shards=8, device=dev)
        fast = faults.RetryPolicy(attempts=3, backoff_s=0.0, multiplier=1.0, deadline_s=None)
        fault = {}
        for name in ("law", "pagerank"):
            faults.reset(env=False)
            sess = BlazeSession(mesh=mesh, retry=fast)
            faults.configure("collective.inter", at=1)
            if name == "law":
                got = sess.map_reduce(law_v, law_mapper, "sum", torch.zeros(64, 4, device=dev),
                                      engine="pallas")
                ok = torch.equal(got, law_bits["2x4 hier per_op"])
                diff = 0.0
            else:
                pr = pagerank(edges_np, n_pages, tol=0.0, max_iters=5, engine="pallas",
                              session=sess)
                d = (torch.from_numpy(pr.scores).to(dev).double()
                     - torch.from_numpy(pr_clean["scores"]).to(dev).double()).abs()
                ok, diff = bool((d <= pr_tol).all()), float(d.max())
            snap = faults.snapshot()
            fault[name] = {"retries": sess.stats.retries, "max_diff": diff,
                           "injected": snap["injected"], "balanced": snap["balanced"],
                           "retried": snap["dispositions"]["retried"]}
            if not (ok and sess.stats.retries == 1 and snap["balanced"]
                    and snap["dispositions"]["retried"] == 1
                    and snap["injected"] == {"collective.inter": 1}):
                raise AssertionError(f"multinode collective.inter {name}: {fault[name]}")
            del sess
        faults.reset(env=False)
        results["collective_inter_fault"] = fault
        self.phase = "multinode"
        results["multinode_s"] = time.perf_counter() - t_phase
        torch.cuda.empty_cache()
        print(json.dumps({"multinode_results": results}, default=str), flush=True)

    # -- examples phase ------------------------------------------------------

    def example(self, name):
        """``examples_torch/<name>.py`` as a module."""
        import importlib.util

        spec = importlib.util.spec_from_file_location(
            f"examples_torch_{name}", ROOT / "examples_torch" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def examples_phase(self):
        """The six port copies of the examples (module docstring, 9b): each
        ``main([])`` in this process, on the card (its default), with the
        launch counts set to 0 just before and read just after, held against
        ``run(device="cpu", ...)`` of the same script on the same sizes
        (module docstring, the examples phase's checks), train_lm on its first
        two steps only; K4's f32
        form at train_lm's attention shape as a row of the kernel phase."""
        torch = self.torch
        import numpy as np
        from repro_torch.configs.base import get_arch
        from repro_torch.launch.serve_lm import generate
        from repro_torch.models import model as M

        t_phase = time.perf_counter()
        argv = [] if self.dev.type == "cuda" else ["--device", str(self.dev)]
        out = {}

        def drive(name):
            mod = self.example(name)
            self.sync()
            self.zero_launch_counts()
            t0 = time.perf_counter()
            res = mod.main(argv)
            self.sync()
            wall = time.perf_counter() - t0
            launch = self.read_launch_counts()
            self.example_launches[name] = launch
            t0 = time.perf_counter()
            cpu = (mod.run(device="cpu", steps=2, horizon=300) if name == "train_lm"
                   else mod.run(device="cpu"))
            out[name] = {"wall_s": wall, "cpu_wall_s": time.perf_counter() - t0,
                         "launches": {k: v for k, v in launch.items() if (
                             any(v.values()) if isinstance(v, dict) else v)}}
            return mod, res, cpu, launch

        def fail(name, what):
            raise AssertionError(f"examples {name}: {what}")

        # quickstart: integer results exactly; the scaled sum exactly too
        # (module docstring)
        _, res, cpu, _ = drive("quickstart")
        for key in ("pi_hits", "word_counts", "squares", "total"):
            if res[key] != cpu[key]:
                fail("quickstart", f"{key} {res[key]} on the card, {cpu[key]} on the CPU")
        if not np.array_equal(res["closest"], cpu["closest"]):
            fail("quickstart", "the 5 nearest points differ")
        out["quickstart"]["results"] = {"pi_hits": res["pi_hits"], "total": res["total"],
                                        "compiles": res["session"]["compiles"]}

        # data_mining: PageRank 1e-5, k-means 1e-4 / rtol 1e-4, GMM rtol 1e-5 /
        # 1e-4, kNN's rows exactly, iterations equal
        _, res, cpu, _ = drive("data_mining")
        checks = {}
        for key in ("pagerank", "pagerank_program", "kmeans", "gmm"):
            if res[key].iterations != cpu[key].iterations:
                fail("data_mining", f"{key}: {res[key].iterations} iterations on the card, "
                                    f"{cpu[key].iterations} on the CPU")
        checks["pagerank"] = float(np.abs(res["pagerank"].scores - cpu["pagerank"].scores)
                                   .max())
        checks["pagerank_program"] = float(np.abs(res["pagerank_program"].scores
                                                  - cpu["pagerank_program"].scores).max())
        checks["kmeans_centres"] = float(np.abs(res["kmeans"].centers
                                                - cpu["kmeans"].centers).max())
        checks["kmeans_inertia_rel"] = abs(res["kmeans"].inertia - cpu["kmeans"].inertia) / abs(
            cpu["kmeans"].inertia)
        checks["gmm_ll_rel"] = abs(res["gmm"].log_likelihood - cpu["gmm"].log_likelihood) / abs(
            cpu["gmm"].log_likelihood)
        checks["gmm_params"] = max(float(np.abs(getattr(res["gmm"], k) - getattr(cpu["gmm"], k))
                                         .max()) for k in ("alpha", "mu", "sigma"))
        lim = {"pagerank": 1e-5, "pagerank_program": 1e-5, "kmeans_centres": 1e-4,
               "kmeans_inertia_rel": 1e-4, "gmm_ll_rel": 1e-5, "gmm_params": 1e-4}
        for key, err in checks.items():
            if not err <= lim[key]:
                fail("data_mining", f"{key} off the CPU run by {err}, limit {lim[key]}")
        if not np.array_equal(res["knn"].neighbors, cpu["knn"].neighbors):
            fail("data_mining", "the 100 nearest neighbours differ")
        out["data_mining"]["results"] = {**checks, "limits": lim, "knn": "bit_equal",
                                         "iterations": {k: res[k].iterations for k in (
                                             "pagerank", "pagerank_program", "kmeans", "gmm")}}

        # streaming_aggregation: counts and histogram exactly; K2 launched
        _, res, cpu, launch = drive("streaming_aggregation")
        if res["counts"] != cpu["counts"] or not np.array_equal(res["hist"], cpu["hist"]):
            fail("streaming_aggregation", "counts or histogram differ from the CPU run")
        info = res["info"]
        if self.dev.type == "cuda" and launch["hash_aggregate"] == 0:
            fail("streaming_aggregation", "K2 was not launched")
        out["streaming_aggregation"]["results"] = {
            "distinct": res["distinct"], "overflow": res["overflow"],
            "compiles": info.compiles, "dispatches": info.dispatches,
            "host_syncs": info.host_syncs}

        # serve_queries: tests/test_torch_serve.py's tolerances, every reply
        _, res, cpu, _ = drive("serve_queries")
        worst = {}
        for key, (got, _meta) in res["results"].items():
            want = cpu["results"][key][0]
            q = key[1]
            if q == "pi":
                errs = {"pi": abs(got["pi"] - want["pi"])}
                lim = {"pi": 0.0}
            elif q == "wordcount":
                same = (np.array_equal(got["keys"], want["keys"])
                        and np.array_equal(got["counts"], want["counts"]))
                errs, lim = {"differ": 0.0 if same else 1.0}, {"differ": 0.0}
            elif q == "pagerank":
                errs = {"scores": float(np.abs(np.asarray(got["scores"])
                                               - np.asarray(want["scores"])).max()),
                        "delta": abs(got["delta"] - want["delta"])}
                lim = {"scores": 1e-5, "delta": 1e-5}
            elif q == "kmeans":
                errs = {"centres": float(np.abs(np.asarray(got["centers"])
                                                - np.asarray(want["centers"])).max()),
                        "inertia_rel": abs(got["inertia"] - want["inertia"])
                        / abs(want["inertia"])}
                lim = {"centres": 1e-4, "inertia_rel": 1e-4}
            elif q == "gmm":
                errs = {"params": max(float(np.abs(np.asarray(got[k]) - np.asarray(want[k]))
                                            .max()) for k in ("alpha", "mu", "sigma")),
                        "ll_rel": abs(got["log_likelihood"] - want["log_likelihood"])
                        / abs(want["log_likelihood"])}
                lim = {"params": 1e-4, "ll_rel": 1e-5}
            else:
                rows = ({tuple(r) for r in np.asarray(got["neighbors"]).tolist()}
                        == {tuple(r) for r in np.asarray(want["neighbors"]).tolist()})
                d = np.sort(np.asarray(got["distances"]))
                dw = np.sort(np.asarray(want["distances"]))
                errs = {"rows": 0.0 if rows else 1.0,
                        "dist_rel": float((np.abs(d - dw) / np.maximum(np.abs(dw), 1e-30))
                                          .max())}
                lim = {"rows": 0.0, "dist_rel": 1e-6}
            for k, err in errs.items():
                worst[f"{q} {k}"] = max(worst.get(f"{q} {k}", 0.0), err)
                if not err <= lim[k]:
                    fail("serve_queries", f"{key} {k} off the CPU run by {err}, "
                                          f"limit {lim[k]}")
        snap = res["stats"]
        if snap["compiles"] != 6 or snap["completed"] != 18:
            fail("serve_queries", f"{snap['completed']} queries, {snap['compiles']} compiles")
        out["serve_queries"]["results"] = {
            "worst": worst, "compiles": snap["compiles"], "cache_hits": snap["cache_hits"],
            "batched_dispatches": snap["batched_dispatches"], "p50_ms": snap["p50_ms"],
            "p99_ms": snap["p99_ms"], "throughput_qps": snap["throughput_qps"]}

        # serve_lm: K4 on every attention call, K5 on every Mamba-2 layer, K6
        # on every RWKV-6 layer, in the prefill and in every step; tokens and
        # logits against the CPU run (EXAMPLE_LM_TOL)
        mod, res, cpu, launch = drive("serve_lm")
        steps = mod.GEN
        layers = {"flash_attention": 0, "ssd_scan": 0, "rwkv6_scan": 0}
        lm = {}
        for arch in mod.ARCHS:
            for kernel, n in pass_launches(get_arch(arch).reduced()).items():
                layers[kernel] += n
            tol = EXAMPLE_LM_TOL[arch]
            a, b = res[arch], cpu[arch]
            if not torch.equal(a["prompts"], b["prompts"]):
                fail("serve_lm", f"{arch}: the prompts differ")
            ta, tb = a["tokens"], b["tokens"]
            worst, compared, first_diff = 0.0, 0, []
            for row in range(ta.shape[0]):
                diff = (ta[row] != tb[row]).nonzero()
                n_same = int(diff[0]) if len(diff) else ta.shape[1]
                # logits 0..n_same are taken after the same tokens on both
                la, lb = a["logits"][row, :n_same + 1], b["logits"][row, :n_same + 1]
                worst = max(worst, float((la - lb).abs().max()))
                compared += la.shape[0]
                if n_same < ta.shape[1]:  # the CPU's own top-2 must be a near-tie
                    top2 = torch.topk(lb[n_same], 2).values
                    if float(top2[0] - top2[1]) > 2 * tol:
                        fail("serve_lm", f"{arch} row {row}: token {n_same} differs from "
                                         f"the CPU run's, which was decided")
                    first_diff.append(n_same)
            if worst > tol:
                fail("serve_lm", f"{arch}: logits off the CPU run by {worst}, tolerance {tol}")
            lm[arch] = {"logit_err": worst, "tol": tol, "logits_compared": compared,
                        "first_token_differences": first_diff, "decode_s": a["seconds"],
                        "tok_per_s": ta.numel() / a["seconds"]}
        if self.dev.type == "cuda":  # reduced configs: K4's f32 form
            out["serve_lm"]["counted"] = self.lm_launches(
                "examples serve_lm", launch, layers, steps, models=len(mod.ARCHS), f32=True)
        # its steps were replays of the captured step: each arch against an
        # eager run on the card, and two replays of one step
        for arch in mod.ARCHS:
            c = get_arch(arch).reduced()
            p = M.map_tree(lambda t: t.to(self.dev), M.init(torch.Generator().manual_seed(0), c))
            prompts = res[arch]["prompts"].to(self.dev)
            etoks, _, elogits = generate(c, p, prompts, mod.MAX_LEN, steps, return_logits=True,
                                         capture=False)
            got = (res[arch]["tokens"].to(self.dev), res[arch]["logits"].to(self.dev))
            lm[arch]["captured_vs_eager"] = self.held_to_eager(
                f"examples serve_lm {arch}", got, (etoks, elogits), EXAMPLE_LM_TOL[arch])
            lm[arch].update(self.graph_step(p, c, prompts, etoks[:, -1:], steps, timed=False))
            del p
        out["serve_lm"]["results"] = lm

        # K4's f32 form at train_lm's attention shape (a micro-batch of 4
        # sequences of 256 tokens, 8 query heads over 4 kv heads of 64)
        mod = self.example("train_lm")
        cfg = mod.config()
        g = torch.Generator(device=self.dev).manual_seed(0)
        mb = 8 // 2  # the default batch over its 2 micro-batches
        q = torch.randn(mb, cfg.n_heads, 256, cfg.d_head, generator=g, device=self.dev)
        k = torch.randn(mb, cfg.n_kv_heads, 256, cfg.d_head, generator=g, device=self.dev)
        v = torch.randn(mb, cfg.n_kv_heads, 256, cfg.d_head, generator=g, device=self.dev)
        self.kernel_attention("flash_attention@train_lm f32", q, k, v, q_offset=0)
        del q, k, v

        # train_lm: 300 steps on the card; its first two losses against the
        # CPU's (first_step_reach); K4's f32 form on every attention call of
        # the forward and the remat recompute
        mod, res, cpu, launch = drive("train_lm")
        self.path_launches["example train_lm"] = launch
        n_k4 = cfg.n_layers * 2 * 2 * 300  # (forward + recompute) x micro-batches x steps
        # counted through the replays: the wrappers count the warm-up and the
        # capture, the training graph the 299 replays (ran_launches)
        if self.dev.type == "cuda" and (
                ran_launches(launch, "flash_attention") != n_k4
                or ran_launches(launch, "flash_attention/f32") != n_k4
                or (res.captures, res.replays) != (1, 299)):
            fail("train_lm", f"K4 launched {ran_launches(launch, 'flash_attention')} times "
                             f"({launch['flash_attention forms']}, {launch['train_graph']}), "
                             f"not {n_k4} in f32; {res.captures} captures, {res.replays} "
                             "replays")
        err0 = abs(res.losses[0] - cpu.losses[0])
        if err0 > 1e-5 * abs(cpu.losses[0]):
            fail("train_lm", f"first loss {res.losses[0]} on the card, {cpu.losses[0]} on "
                             "the CPU")
        bound = self.first_step_reach(mod, cfg)
        err1 = abs(res.losses[1] - cpu.losses[1])
        if err1 > bound + 1e-5 * abs(cpu.losses[1]):
            fail("train_lm", f"second loss {res.losses[1]} on the card, {cpu.losses[1]} on "
                             f"the CPU, bound {bound}")
        # its eager twin in the same run: the first TRAIN_LM_EAGER_STEPS
        # steps of the same job with jit=False
        t0 = time.perf_counter()
        eager = mod.run(device=self.dev, steps=TRAIN_LM_EAGER_STEPS, horizon=300, jit=False)
        eager_wall = time.perf_counter() - t0
        n = TRAIN_LM_EAGER_STEPS
        out["train_lm"]["results"] = {
            "losses_first_last": [res.losses[0], res.losses[-1]],
            "cpu_losses": cpu.losses, "loss0_err": err0, "loss1_err": err1,
            "loss1_bound": bound, "steps": res.final_step,
            "captures": res.captures, "replays": res.replays, "capture_s": res.capture_s,
            "median_step_ms": res.straggler["median_s"] * 1e3,
            "p99_step_ms": res.straggler["p99_s"] * 1e3,
            "eager_twin": {
                "steps": n, "wall_s": eager_wall, "captures": eager.captures,
                "median_step_ms": statistics.median(eager.step_times[1:]) * 1e3,
                "p99_step_ms": eager.straggler["p99_s"] * 1e3,
                # the captured run's first steps against the twin's
                "captured_median_step_ms": statistics.median(res.step_times[1:n]) * 1e3,
                "loss_max_abs_diff": max(abs(a - b) for a, b in zip(res.losses, eager.losses)),
                "losses_bit_equal": res.losses[:n] == eager.losses}}

        for name, r in out.items():
            print(json.dumps({"example": name, **r}, default=str), flush=True)
        self.examples_s = time.perf_counter() - t_phase
        print(json.dumps({"examples_s": self.examples_s}), flush=True)
        torch.cuda.empty_cache()

    def first_step_reach(self, mod, cfg):
        """How far one AdamW step can move train_lm's second loss between two
        devices: each parameter moves by at most ``lr(1)`` on either, so they
        differ by at most ``2·lr(1)`` an entry, and the loss by at most
        ``2·lr(1)·‖∇L‖₁`` to first order; twice that for the second-order
        term.  ``∇L`` at the seeded weights on step 1's batch."""
        torch = self.torch
        from repro_torch.data.pipeline import TokenPipeline
        from repro_torch.models import model as M
        from repro_torch.optim.adamw import warmup_cosine
        from repro_torch.runtime.train_loop import value_and_grad

        params = M.map_tree(lambda t: t.to(self.dev),
                            M.init(torch.Generator().manual_seed(0), cfg))
        batch = TokenPipeline(cfg, batch=8, seq_len=256, seed=0).device_batch(1, self.dev)
        _, grads = value_and_grad(params, lambda p, x, y: M.loss_fn(p, cfg, x, y),
                                  batch["inputs"], batch["labels"])
        g1 = sum(float(g.abs().sum()) for g in M.distinct_leaves(grads))
        lr1 = float(warmup_cosine(3e-4, 300 // 10, 300)(torch.tensor(1)))
        del params, grads
        return 2 * (2 * lr1 * g1)

    def process_phase(self, data):
        """The topology across processes on one card (module docstring, 10):
        an NCCL group of world size 1 brought up here, the (1x8) mesh that
        carries it, the jobs of the multinode phase's (1x8) row, each held
        against that row's in-process result.  Each program runs twice with
        the group up: first its twin on an in-process (1x8) mesh, then on
        the process mesh; both keep their captured graphs
        (``Program.keep_graph``), which are read node by node
        (``graph_nodes``): the process graph must hold at least one memcpy
        node beyond the twin's for each collective of the plan (with one
        rank NCCL moves an all-gather or all-to-all as a device copy,
        ``ncclLaunchOneRank``; with more ranks, an NCCL kernel), and the
        nodes by type and the NCCL-named kernels are printed.  The twins
        also capture in-process programs beside a live NCCL group, the case
        of ROADMAP Queue 3 item 17."""
        torch = self.torch
        import gc
        import importlib
        import shutil
        import tempfile

        import numpy as np
        import torch.distributed as dist
        from repro_torch.core import BlazeSession, DistVector, data_mesh
        from repro_torch.core.algorithms import kmeans, knn, pagerank, wordcount
        from repro_torch.core.collectives import gather_rows
        from repro_torch.core.mapreduce import make_collectives
        from repro_torch.core.reducers import get_reducer
        from repro_torch.kernels import ops
        from repro_torch.launch.mesh import make_node_data_mesh

        alg = {m: importlib.import_module("repro_torch.core.algorithms." + m)
               for m in ("kmeans", "pagerank")}
        dev = self.dev
        t_phase = time.perf_counter()
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()[0]
        kernels = ("segment_reduce", "hash_aggregate", "kmeans_assign")
        ref = self.mn_1x8
        pr_check, km_check, wc_check = ref["checks"]
        edges_np, n_pages = data["edges_np"], data["n_pages"]
        edges_v = DistVector(data["edges"], edges_np.shape[0])
        scores0 = torch.full((n_pages,), 1.0 / n_pages, device=dev)
        pts, c0 = data["points"], data["init_centers"]
        n_pts, dim = pts.shape
        pts_v = DistVector(pts, n_pts)
        init = c0.cpu().numpy()
        lines, vocab = data["lines_np"], data["vocab"]
        kpts = data["knn_points_np"]
        q = np.zeros(kpts.shape[1], np.float32)
        law_rows = ref["law_rows"]
        law_v = DistVector(law_rows, law_rows.shape[0])
        _, _, pr_tol = self.per_op["pagerank"]
        _, ref_c, _ = self.per_op["kmeans"]

        def law_mapper(i, x, emit):
            emit(i % 64, x)

        def law_step(ctx, s):
            t = ctx.map_reduce(law_v, law_mapper, "sum", torch.zeros(64, 4, device=dev),
                               engine="pallas")
            return {"acc": s["acc"] + t}

        counts = {k: {"wrappers": 0, "graph_replays": 0} for k in kernels}
        r = {"card": card, "walls": {}, "walls_vs_1x8": {}, "checks": {}, "graphs": {}}
        store = tempfile.mkdtemp(prefix="blaze-store-")
        # NCCL for the card (gloo for a rehearsal on the CPU)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.FileStore(os.path.join(store, "s"), 1),
                                world_size=1, rank=0)
        gc.collect()
        torch.cuda.empty_cache()
        r["device_memory_at_start"] = {"allocated": torch.cuda.memory_allocated(dev),
                                       "reserved": torch.cuda.memory_reserved(dev),
                                       "free": torch.cuda.mem_get_info(dev)[0]}
        # the twins of the process programs, on the in-process (1x8) mesh
        # (data_mesh: make_node_data_mesh would honour the group, even of one)
        tsess = BlazeSession(mesh=data_mesh(8, device=dev))
        if tsess.mesh.process:
            raise AssertionError("process: the twins' mesh carries the group")
        try:
            mesh = make_node_data_mesh(None, n_shards=8, device=dev)
            if not (mesh.process and (mesh.n_nodes, mesh.n_local, mesh.n_ranks) == (1, 8, 1)):
                raise AssertionError(f"process: the mesh is {mesh}")
            # NCCL brings its communicator up at the group's first
            # collective: time that one alone, so no job's wall holds it
            t0 = time.perf_counter()
            gather_rows(mesh, torch.zeros(1, device=dev))
            self.sync()
            r["communicator_s"] = time.perf_counter() - t0
            # the NCCL work of this phase so far, in order (a failed twin
            # capture names the last)
            nccl_work = ["gather_rows: the communicator's bring-up"]
            sess = BlazeSession(mesh=mesh)

            def per_op(name, fn, units):
                out, wall, launch = self.drive(f"process {name}", fn, units)
                nccl_work.append(f"per op {name}")
                r["walls"].setdefault(name, {})["per_op_s"] = wall
                for k in kernels:
                    counts[k]["wrappers"] += launch[k]
                return out

            def program(name, build, run, units, per_iter=None):
                """``build(session)`` twice: first on the in-process (1x8)
                mesh (the twin: run once, its graph read), then on the
                process mesh through ``program_job``; both with the group
                up.  Each graph's nodes are read (``graph_nodes``) and the
                process graph must hold a memcpy node beyond the twin's for
                each collective of its plan: NCCL moves a one-rank
                all-gather or all-to-all as a device copy.  ``run(session,
                prog)`` gives the job; ``per_iter``: the collectives an
                iteration where the plan does not see them (fig. 6's
                own)."""
                twin = build(tsess)
                twin.keep_graph = True
                try:
                    run(tsess, twin)()
                except Exception as e:  # ROADMAP Queue 3 item 17: name what to bisect
                    raise AssertionError(
                        f"process {name}: the in-process twin's capture failed at plan node "
                        f"{getattr(e, 'plan_node', 'unknown')}; the eager NCCL work just "
                        f"before it: {nccl_work[-1]} (of {len(nccl_work)} NCCL jobs this "
                        f"phase: {nccl_work}): {e}") from e
                theirs = last_graph_nodes(twin)[1][0]
                del twin
                prog = build(sess)
                prog.keep_graph = True
                key = f"process {name}"
                out = self.program_job(key, prog, run(sess, prog), units)
                nccl_work.append(f"program {name}: eager warm-up, capture, replays")
                first, replay = self.program_runs[key]["walls"]
                r["walls"].setdefault(name, {}).update(program_first_s=first,
                                                       program_replay_s=replay)
                for k in kernels:
                    counts[k]["wrappers"] += self.program_runs[key]["first_launches"][k]
                    counts[k]["graph_replays"] += prog.stats.replay_launches.get(k, 0)
                u, (mine, mine_names) = last_graph_nodes(prog)
                want = u * (prog.plan.collectives_per_iter if per_iter is None else per_iter)
                copies = mine.get("memcpy", 0) - theirs.get("memcpy", 0)
                r["graphs"][name] = {
                    "u": u, "collectives": want, "nodes": mine, "nodes_1x8": theirs,
                    "memcpy_beyond_1x8": copies,
                    "nccl_kernel_nodes": sum(n for k, n in mine_names.items()
                                             if "nccl" in k.lower())}
                if copies < want:
                    raise AssertionError(f"process {name}: the graph holds {copies} memcpy "
                                         f"nodes beyond the (1x8) graph's, under the plan's "
                                         f"{want} collectives: {r['graphs'][name]}")
                del prog
                return out

            # per op: the law, PageRank and k-means (none, int8), wordcount, kNN
            got = per_op("law", lambda: sess.map_reduce(
                law_v, law_mapper, "sum", torch.zeros(64, 4, device=dev), engine="pallas"),
                law_rows.shape[0])
            if not torch.equal(got, ref["law"]["1x8 hier per_op"]):
                raise AssertionError("process law per op: not the (1x8) bits")
            r["checks"]["law per_op"] = "bit_equal"
            for wire in ("none", "int8"):
                pr = per_op(f"pagerank {wire}", lambda: pagerank(
                    edges_np, n_pages, tol=0.0, max_iters=5, engine="pallas", wire=wire,
                    session=sess), 5 * len(edges_np))
                chk = pr_check("process", pr.scores, wire, "per_op", 8)
                chk["max_diff_1x8"] = float(np.abs(
                    pr.scores - ref[f"pagerank {wire} per_op"]).max())
                r["checks"][f"pagerank {wire} per_op"] = chk
                km = per_op(f"kmeans {wire}", lambda: kmeans(
                    pts_v, 5, init_centers=init, tol=0.0, max_iters=5, engine="pallas",
                    wire=wire, session=sess), 5 * n_pts)
                chk = km_check("process", km.centers, km.inertia, wire, "per_op", 8)
                chk["centre_diff_1x8"] = float(np.abs(
                    km.centers - ref[f"kmeans {wire} per_op"][0]).max())
                r["checks"][f"kmeans {wire} per_op"] = chk
            hm = per_op("wordcount", lambda: wordcount(
                lines, engine="pallas", vocab_size=vocab, session=sess), int(lines.size))
            r["checks"]["wordcount per_op"] = wc_check("process", hm)
            del hm
            knn_1x8 = knn(kpts, q, 100, session=tsess)  # the in-process (1x8) mesh
            nn = per_op("knn", lambda: knn(kpts, q, 100, session=sess), len(kpts))
            if not (np.array_equal(nn.neighbors, knn_1x8.neighbors)
                    and np.array_equal(nn.distances, knn_1x8.distances)):
                raise AssertionError("process knn: not the (1x8) neighbours")
            r["checks"]["knn per_op"] = "bit_equal"

            # programs: the law, PageRank and k-means (none, int8), fig. 6
            s0 = {"acc": torch.zeros(64, 4, device=dev)}
            acc = program("law", lambda ss: ss.program(law_step),
                          lambda ss, prog: lambda: ss.run_loop(prog, s0, max_iters=3, unroll=3),
                          3 * law_rows.shape[0])
            if not torch.equal(acc["acc"] / 3, ref["law"]["1x8 hier program"]):
                raise AssertionError("process law program: not the (1x8) bits")
            r["checks"]["law program"] = "bit_equal"
            for wire in ("none", "int8"):
                step, ps0 = alg["pagerank"]._program_step(edges_v, data["deg"], n_pages, 0.85,
                                                          "pallas", wire)
                st0 = ps0(scores0)
                out = program(f"pagerank {wire}", lambda ss, step=step: ss.program(step),
                              lambda ss, prog, st0=st0: lambda: ss.run_loop(
                                  prog, st0, cond=lambda s: float(s["delta"]) < 0.0,
                                  max_iters=5, unroll=5), 5 * len(edges_np))
                chk = pr_check("process", out["scores"], wire, "program", 8)
                chk["max_diff_1x8"] = float((out["scores"] - ref[f"pagerank {wire} program"])
                                            .abs().max())
                r["checks"][f"pagerank {wire} program"] = chk
                step, ks0 = alg["kmeans"]._program_step(pts_v, 5, dim, "pallas", wire)
                st0 = ks0(c0)

                def km_run(ss, prog, st0=st0):
                    def run():
                        out, info = ss.run_loop(prog, st0, cond=lambda s: float(
                            s["move"]) < 0.0, max_iters=5, unroll=5)
                        return (out["centers"], float(prog(out, 1)["inertia"])), info
                    return run

                centers, inertia = program(f"kmeans {wire}",
                                           lambda ss, step=step: ss.program(step),
                                           km_run, 5 * n_pts)
                chk = km_check("process", centers, inertia, wire, "program", 8)
                chk["centre_diff_1x8"] = float((centers - ref[f"kmeans {wire} program"][0])
                                               .abs().max())
                r["checks"][f"kmeans {wire} program"] = chk
            per = n_pts // 8
            total = get_reducer("sum")

            def fig6_build(ss):
                m = ss.mesh
                coll = make_collectives(m)
                first = m.rank * m.n_local  # this process's shards of the points

                def fig6_step(ctx, s):
                    parts = torch.stack([ops.kmeans_assign(
                        pts[(first + i) * per:(first + i + 1) * per], s["c"])[1]
                        for i in range(m.n_local)])
                    st = coll.reduce(parts, total)
                    return {"c": st[:, :dim] / torch.clamp(st[:, dim:], min=1.0)}

                return ss.program(fig6_step)

            f0 = {"c": c0}
            out = program("fig6", fig6_build, lambda ss, prog: lambda: ss.run_loop(
                prog, f0, max_iters=5, unroll=5), 5 * n_pts, per_iter=1)
            err = float(np.abs(out["c"].cpu().numpy() - ref_c).max())
            if err > 1e-4:
                raise AssertionError(f"process fig6: centre error {err}")
            r["checks"]["fig6 program"] = {"centre_err": err, "centre_diff_1x8": float(
                (out["c"] - ref["fig6 program"]).abs().max())}
            t0 = time.perf_counter()
            r["stream"] = self.process_stream(data, sess, tsess)
            r["stream_s"] = time.perf_counter() - t0
            del sess, tsess
            gc.collect()
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            r["dp_train"] = self.dp_train_process()
            r["dp_train_s"] = time.perf_counter() - t0
        finally:
            dist.destroy_process_group()
            shutil.rmtree(store, ignore_errors=True)
        for job, w in r["walls"].items():
            if job in ref["walls"]:
                r["walls_vs_1x8"][job] = {k: v / ref["walls"][job][k] for k, v in w.items()
                                          if k in ref["walls"][job]}
        for k in kernels:
            if counts[k]["wrappers"] + counts[k]["graph_replays"] == 0:
                raise AssertionError(f"process: {k} did not run")
        self.process_launches = counts
        r["launches"] = counts
        r["process_s"] = time.perf_counter() - t_phase
        torch.cuda.empty_cache()
        print(json.dumps({"process_results": r}, default=str), flush=True)

    def process_stream(self, data, sess, isess) -> dict:
        """The stream phase's jobs on the process mesh (module docstring,
        10): its host arrays at their sizes (k-means' points in blocks of
        ``STREAM_BLOCK_ROWS``, the R-MAT edges and the token lines in 8
        blocks each) made chunked on the process mesh of ``sess`` (the
        rank's rows of every block: with one rank, all of them) and on the
        in-process (1x8) mesh of ``isess``.  On each mesh: ``mode="stream"``
        k-means and PageRank and the streamed word count through the
        drivers, the launch counts set to 0 just before; per op over the
        blocks, PageRank (a dense target) and word count (a hash target).
        Word counts must equal the per-op counts exactly on both meshes;
        k-means' centres and inertia and PageRank's scores are held to the
        stream phase's bounds on both (K1's shared and global forms fold
        with atomics, so the meshes need not agree bit for bit; their
        largest difference is printed).  Then each job's epoch, one capture
        epoch and ``PROCESS_STREAM_EPOCHS`` timed ones a mesh, printed side
        by side; and a k-means stream and a streamed word count
        checkpointed at epoch 2 on one mesh and resumed on the other, both
        ways, against the uninterrupted run (k-means' centres within 1e-4,
        the counts exactly).  The kernels line's ``process_stream_launches``
        holds K1's and K2's launches on the process mesh (the wrappers' and
        the graph replays'); either one at 0 fails the run."""
        torch = self.torch
        import importlib
        import shutil
        import tempfile

        import numpy as np
        from repro_torch.core.algorithms import kmeans, pagerank, wordcount

        alg = {m: importlib.import_module("repro_torch.core.algorithms." + m)
               for m in ("kmeans", "pagerank", "wordcount")}
        dev = self.dev
        pts_np, c0 = data["points_np"], data["init_centers"]
        init = c0.cpu().numpy()
        dim = pts_np.shape[1]
        edges_np, n_pages = data["edges_np"], data["n_pages"]
        lines, vocab = data["lines_np"], data["vocab"]
        km_ref, ref_c, ref_inertia = self.per_op["kmeans"]
        pr_per_op, pr_ref, pr_tol = self.per_op["pagerank"]
        meshes = {"process": sess, "1x8": isess}
        out = {"epoch_median_s": {}, "checks": {}, "diff_process_vs_1x8": {}}
        t0 = time.perf_counter()
        chunks = {name: {"kmeans": s.chunked(pts_np, STREAM_BLOCK_ROWS),
                         "pagerank": s.chunked(edges_np, -(-len(edges_np) // 8)),
                         "wordcount": s.chunked(lines, -(-len(lines) // 8))}
                  for name, s in meshes.items()}
        out["chunk_s"] = time.perf_counter() - t0
        for name, ch in chunks.items():
            for job, c in ch.items():
                if (c.n_blocks != (-(-len(pts_np) // STREAM_BLOCK_ROWS) if job == "kmeans"
                                   else 8) or c.local_rows != c.block_rows
                        or (c.mesh is sess.mesh) != (name == "process")
                        or not c.stats()["pinned"]):
                    raise AssertionError(f"process stream: {name} {job} blocks")

        def km_err(tag, centers, inertia=None):
            errs = (float(np.abs(centers - ref_c).max()),
                    float(np.abs(centers - km_ref.centers).max()))
            if max(errs) > 1e-4 or (inertia is not None and
                                    abs(inertia - ref_inertia) > 1e-4 * ref_inertia):
                raise AssertionError(f"process stream kmeans {tag}: centre errors {errs}, "
                                     f"inertia {inertia} against {ref_inertia}")
            return errs[1]

        def pr_err(tag, scores):
            got = torch.as_tensor(scores).to(dev).double()
            d = (got - torch.from_numpy(pr_per_op).to(dev).double()).abs()
            if not (bool(((got - pr_ref).abs() <= pr_tol).all()) and bool((d <= pr_tol).all())):
                raise AssertionError(f"process stream pagerank {tag}: a page is over its "
                                     "tolerance")
            return float(d.max())

        def wc_counts(tag, hm, times=1):
            keys, vals = hm.items()
            got = np.zeros(vocab, np.int64)
            got[keys] = vals
            if hm.total_overflow() or not np.array_equal(got, times * self.per_op["wordcount"]):
                raise AssertionError(f"process stream wordcount {tag} differs from per-op")
            return got

        counts = {k: {"wrappers": 0, "graph_replays": 0}
                  for k in ("segment_reduce", "hash_aggregate")}
        res = {}
        for name, s in meshes.items():
            ch = chunks[name]

            def jobs():
                return (kmeans(ch["kmeans"], 5, init_centers=init, tol=0.0, max_iters=5,
                               engine="pallas", mode="stream", session=s),
                        pagerank(ch["pagerank"], n_pages, tol=0.0, max_iters=5,
                                 engine="pallas", mode="stream", session=s),
                        wordcount(ch["wordcount"], engine="pallas", vocab_size=vocab,
                                  mode="program", session=s),
                        pagerank(ch["pagerank"], n_pages, tol=0.0, max_iters=5,
                                 engine="pallas", session=s),
                        wordcount(ch["wordcount"], engine="pallas", vocab_size=vocab,
                                  session=s))

            s.stats.graph_launches = {}
            (km, pr, wc, pr_op, wc_op), wall, launch = self.drive(
                f"process stream {name}", jobs,
                6 * len(pts_np) + 10 * len(edges_np) + 2 * int(lines.size))
            if name == "process":
                for k in counts:
                    counts[k]["wrappers"] += launch[k]
                    counts[k]["graph_replays"] += sum(
                        n for key, n in s.stats.graph_launches.items()
                        if key.split("/")[0] == k)
            res[name] = (km.centers, km.inertia, pr.scores, wc_counts(f"{name} stream", wc.counts),
                         pr_op.scores, wc_counts(f"{name} per op", wc_op))
            out["checks"][name] = {
                "kmeans_centre_diff": km_err(name, km.centers, km.inertia),
                "pagerank_diff": pr_err(name, pr.scores),
                "pagerank_per_op_diff": pr_err(f"{name} per op", pr_op.scores),
                "wordcount": "equal per op", "wall_s": wall}
            del km, pr, wc, pr_op, wc_op
        for k, c in counts.items():
            if c["wrappers"] + c["graph_replays"] == 0:
                raise AssertionError(f"process stream: {k} did not run on the process mesh")
        (pc, pi, ps, pw, pso, pwo), (ic, ii, is_, iw, iso, iwo) = res["process"], res["1x8"]
        if not (np.array_equal(pw, iw) and np.array_equal(pwo, iwo)):
            raise AssertionError("process stream: word counts differ from the (1x8) mesh's")
        out["diff_process_vs_1x8"] = {
            "kmeans_centres": float(np.abs(pc - ic).max()), "kmeans_inertia": abs(pi - ii),
            "pagerank": float(np.abs(ps - is_).max()),
            "pagerank_per_op": float(np.abs(pso - iso).max()), "wordcount": 0}

        # -- each job's epoch on each mesh ------------------------------------
        def make(job, s):
            ch = chunks["process" if s is sess else "1x8"]
            if job == "kmeans":
                step, st0 = alg["kmeans"]._stream_step(ch["kmeans"], 5, dim, "pallas",
                                                       "none", dev)
                return s.program(step), st0(c0)
            if job == "pagerank":
                deg = torch.from_numpy(alg["pagerank"].block_degrees(ch["pagerank"],
                                                                     n_pages)).to(dev)
                step, st0 = alg["pagerank"]._stream_step(ch["pagerank"], deg, n_pages, 0.85,
                                                         "pallas", "none", dev)
                return s.program(step), st0(torch.full((n_pages,), 1.0 / n_pages, device=dev))
            hm = s.make_dist_hashmap(max(64, 4 * vocab), (), torch.int32, "sum")
            step, st = alg["wordcount"]._program_step(ch["wordcount"], hm, vocab, "pallas")
            return s.program(step), st, hm

        for job in ("kmeans", "pagerank", "wordcount"):
            for name, s in meshes.items():
                prog, state = make(job, s)[:2]
                n_blocks = chunks[name][job].n_blocks
                state, _ = self.stream_epochs(f"process {job}", s, prog, state, 1, True,
                                              n_blocks)
                _, times = self.stream_epochs(f"process {job}", s, prog, state,
                                              PROCESS_STREAM_EPOCHS, True, n_blocks)
                out["epoch_median_s"].setdefault(job, {})[name] = statistics.median(times)
                del prog, state
        out["epoch_process_vs_1x8"] = {
            job: m["process"] / m["1x8"] for job, m in out["epoch_median_s"].items()}

        # -- a checkpoint at epoch 2 on one mesh, resumed on the other ---------
        def km_run(s, epochs, **kw):
            prog, st = make("kmeans", s)
            return s.run_stream(prog, st, max_epochs=epochs, **kw)

        def wc_run(s, epochs, **kw):
            prog, st, hm = make("wordcount", s)
            _, info = s.run_stream(prog, st, max_epochs=epochs, **kw)
            return wc_counts(f"after {epochs} epochs", prog.hash_result(hm), epochs), info

        full, _ = km_run(isess, 5)
        wfull, _ = wc_run(isess, 3)
        resumes = {}
        for writer, reader in (("process", "1x8"), ("1x8", "process")):
            d = tempfile.mkdtemp(prefix="blaze-ckpt-")
            try:
                km_run(meshes[writer], 2, checkpoint=os.path.join(d, "km"),
                       checkpoint_every=2)
                got, info = km_run(meshes[reader], 5, checkpoint=os.path.join(d, "km"),
                                   resume=True)
                diff = float((got["centers"] - full["centers"]).abs().max())
                if info.resumed_from != 2 or diff > 1e-4:
                    raise AssertionError(f"process stream: k-means written on {writer}, "
                                         f"resumed on {reader}: from {info.resumed_from}, "
                                         f"{diff} off")
                km_err(f"resumed on {reader}", got["centers"].cpu().numpy())
                wc_run(meshes[writer], 2, checkpoint=os.path.join(d, "wc"),
                       checkpoint_every=2)
                wgot, winfo = wc_run(meshes[reader], 3, checkpoint=os.path.join(d, "wc"),
                                     resume=True)
                if winfo.resumed_from != 2 or not np.array_equal(wgot, wfull):
                    raise AssertionError(f"process stream: word count written on {writer}, "
                                         f"resumed on {reader}, differs")
            finally:
                shutil.rmtree(d, ignore_errors=True)
            resumes[f"{writer} -> {reader}"] = {"kmeans_centre_diff": diff,
                                                "wordcount": "equal", "resumed_from": 2}
        out["resume"] = resumes
        out["launches"] = counts
        self.process_stream_launches = counts
        del chunks, full
        torch.cuda.empty_cache()
        print(json.dumps({"process_stream": out}, default=str), flush=True)
        return out

    def dp_train_process(self):
        """``dp_train`` across processes on the card (module docstring, 10):
        qwen3-0.6b at full width and depth, ``DP_TRAIN``'s global batch from
        ``TokenPipeline``, 2 local shards on the process mesh (the NCCL group
        of one this phase brought up), against the same steps on the
        in-process ``data_mesh(2)`` from the same seeded state, under each
        wire of ``DP_WIRES``: losses, parameters, AdamW state and residuals
        bit for bit.  Prints each run's step ms, K4 launches, the gradient's
        wire bytes per device and the peak memory."""
        torch = self.torch
        from repro_torch.configs.base import get_arch
        from repro_torch.core.containers import data_mesh
        from repro_torch.data.pipeline import TokenPipeline
        from repro_torch.distributed.dp_train import (
            grad_wire_bytes,
            init_residuals,
            make_dp_train_step,
        )
        from repro_torch.launch.mesh import make_node_data_mesh
        from repro_torch.models import model as M
        from repro_torch.optim.adamw import AdamW

        cfg = get_arch(SHARD_ARCH)
        b, seq, n_local, steps = DP_TRAIN
        pipe = TokenPipeline(cfg, batch=b, seq_len=seq, seed=0)
        meshes = {"process": make_node_data_mesh(None, n_shards=n_local, device=self.dev),
                  "in_process": data_mesh(n_local, device=self.dev)}
        if not meshes["process"].process or meshes["in_process"].process:
            raise AssertionError(f"process dp_train: meshes {meshes}")

        def train(mesh, wire):
            params = M.init(torch.Generator(device=self.dev).manual_seed(0), cfg)
            opt = AdamW(lr=3e-4)
            ostate = opt.init(params)
            resid = init_residuals(params, mesh)
            step = make_dp_train_step(lambda p, x, y: M.loss_fn(p, cfg, x, y), opt, mesh,
                                      wire=wire, cfg=cfg)
            self.sync()
            torch.cuda.reset_peak_memory_stats(self.dev)
            self.zero_launch_counts()
            losses, ms = [], []
            for i in range(steps):
                batch = pipe.device_batch(i, self.dev)
                t0 = time.perf_counter()
                params, ostate, resid, loss = step(params, ostate, resid, batch)
                self.sync()
                ms.append((time.perf_counter() - t0) * 1e3)
                losses.append(loss)
            launch = self.read_launch_counts()
            trees = {"params": M.distinct_leaves(params),
                     "opt": [*M.distinct_leaves(ostate["m"]), *M.distinct_leaves(ostate["v"]),
                             ostate["step"]],
                     "resid": M.distinct_leaves(resid), "losses": losses}
            stats = {"step_ms": ms, "losses": [float(x) for x in losses],
                     "k4_launches": launch["flash_attention"],
                     "k4_forms": {f: n for f, n in launch["flash_attention forms"].items() if n},
                     "peak_bytes": torch.cuda.max_memory_allocated(self.dev)}
            return trees, stats, params

        out = {"arch": cfg.name, "batch": b, "seq": seq, "n_local": n_local, "steps": steps}
        for wire in DP_WIRES:
            got, st, params = train(meshes["process"], wire)
            out[wire] = {"process": st,
                         "grad_wire_bytes": grad_wire_bytes(params, wire, cfg)}
            del params
            want, st, _ = train(meshes["in_process"], wire)
            out[wire]["in_process"] = st
            differ = [k for k in got if len(got[k]) != len(want[k]) or not all(
                torch.equal(x, y) for x, y in zip(got[k], want[k]))]
            del got, want
            torch.cuda.empty_cache()
            if differ:
                raise AssertionError(f"process dp_train {wire}: {differ} differ from the "
                                     "in-process run's")
            if self.dev.type == "cuda" and (
                    out[wire]["process"]["k4_launches"] == 0
                    or out[wire]["process"]["k4_launches"] != st["k4_launches"]):
                raise AssertionError(f"process dp_train {wire}: K4 launches "
                                     f"{out[wire]['process']['k4_launches']} against "
                                     f"{st['k4_launches']} in process")
            out[wire]["bit_equal"] = True
        self.dp_train_launches = {w: out[w]["process"]["k4_launches"] for w in DP_WIRES}
        print(json.dumps({"process_dp_train": out}), flush=True)
        return out

    def shard_phase(self):
        """The LM stack sharded over a ``DeviceMesh`` (module docstring, 11):
        (a) qwen3-0.6b at full width and depth on a (1, 1) mesh over an NCCL
        group of one, trained and served through the sharded steps against
        the unsharded ones; (b) rank 0 of the production mesh in a child
        process (:func:`shard_rank0`)."""
        import shutil
        import tempfile

        torch = self.torch
        import torch.distributed as dist
        from repro_torch import convert
        from repro_torch.configs.base import get_arch
        from repro_torch.data.pipeline import TokenPipeline
        from repro_torch.distributed import sharding as SH
        from repro_torch.launch import dryrun as D
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.launch.serve_lm import generate
        from repro_torch.models import model as M
        from repro_torch.optim.adamw import AdamW
        from repro_torch.runtime.train_loop import make_train_step

        dev = self.dev
        t_phase = time.perf_counter()
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()[0]
        cfg = get_arch(SHARD_ARCH)
        n_attn = sum(k in M._ATTN_KINDS for k in M.layer_kinds(cfg))
        batch, seq, steps = SHARD_TRAIN
        pipe = TokenPipeline(cfg, batch=batch, seq_len=seq, seed=1)
        r = {"card": card, "arch": cfg.name, "mesh": "1x1 data x model, NCCL group of one"}
        store = tempfile.mkdtemp(prefix="blaze-store-")
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.FileStore(os.path.join(store, "s"), 1),
                                world_size=1, rank=0)
        try:
            mesh = make_mesh((1, 1), ("data", "model"), device=dev)
            mi = SH.make_mesh_info(mesh)
            opt = AdamW(lr=3e-4)

            def to_mesh(tree):
                return convert.distribute(tree, SH.batch_pspecs(cfg, tree, mi), mesh)

            # -- (a) training: sharded against unsharded, the same state -------
            params = M.init(torch.Generator(device=dev).manual_seed(0), cfg)
            state = opt.init(params)
            pspecs = SH.param_pspecs(cfg, params, mi)
            sp = convert.distribute(M.map_tree(lambda t: t.detach().clone(), params), pspecs, mesh)
            ss = convert.distribute(M.map_tree(lambda t: t.clone(), state),
                               SH.opt_pspecs(pspecs, state), mesh)
            step = D.make_train_step(cfg, opt, par=M.ParallelCfg(dispatch_groups=mi.dp_size))
            # the step updates sp and ss in place
            losses, train_s, launch = self.drive(
                "shard train qwen3-0.6b", lambda: [
                    float(step(sp, ss, to_mesh(pipe.device_batch(i, dev)))[2].to_local())
                    for i in range(steps)], batch * seq * steps)
            plain_step = make_train_step(cfg, opt, device=dev)
            self.sync()
            t0 = time.perf_counter()
            want = [float(plain_step(params, state, pipe.device_batch(i, dev))[2])
                    for i in range(steps)]
            self.sync()
            plain_train_s = time.perf_counter() - t0
            pairs = list(zip(M.distinct_leaves(sp), M.distinct_leaves(params)))
            bit_equal = losses == want and all(torch.equal(a.to_local(), b) for a, b in pairs)
            param_diff = max(float((a.to_local().detach().float() - b.float()).abs().max())
                             for a, b in pairs)
            loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
            if not bit_equal and loss_err > TRAIN_LOSS_RTOL:
                raise AssertionError(f"shard train: losses {losses} against {want}")
            if launch["flash_attention"] != 2 * n_attn * steps:
                raise AssertionError(f"shard train: K4 launched {launch['flash_attention']} "
                                     f"times, not {2 * n_attn * steps}")
            r["train"] = {
                "tokens": batch * seq * steps, "losses": losses, "unsharded_losses": want,
                "bit_equal": bit_equal, "max_loss_rel_err": loss_err,
                "max_param_abs_diff": param_diff, "wall_s": train_s,
                "unsharded_wall_s": plain_train_s,
                "k4_launches": launch["flash_attention"],
                "why_not_bit_equal": None if bit_equal else (
                    "the sharded step reaches the same kernels through local_map and "
                    "DTensor, whose ops may pick other f32 summation orders")}
            self.shard_launches = {"train": launch}
            del sp, ss, params, state, pairs
            torch.cuda.empty_cache()
            r["resume"] = self.shard_resume(cfg, mesh, mi, n_attn, card)
            torch.cuda.empty_cache()

            # -- (a) serving: prefill + decode through the sharded steps -------
            sb, plen, gen = SHARD_SERVE
            max_len = plen + gen + 1
            params = M.init(torch.Generator(device=dev).manual_seed(0), cfg)
            prompts = torch.randint(0, cfg.vocab, (sb, plen), device=dev,
                                    generator=torch.Generator(device=dev).manual_seed(2))
            self.sync()
            t0 = time.perf_counter()
            with torch.no_grad():  # eager: no capture while an NCCL group is up
                want_toks, _ = generate(cfg, params, prompts, max_len, gen, capture=False)
            self.sync()
            plain_serve_s = time.perf_counter() - t0
            sp = convert.distribute(params, SH.param_pspecs(cfg, params, mi, serving=True), mesh)
            prefill, decode = D.make_serve_steps(cfg, mi, sb,
                                                 par=M.ParallelCfg(dispatch_groups=1))
            caches = convert.distribute(M.make_caches(cfg, sb, max_len, dev),
                                   SH.cache_pspecs(cfg, sb, max_len, mi, kind="prefill"),
                                   mesh)

            def serve():
                logits, c = prefill(sp, to_mesh({"t": prompts})["t"], caches)
                c = SH.reshard(c, SH.cache_pspecs(cfg, sb, max_len, mi))
                toks = []
                for i in range(gen):
                    toks.append(logits.full_tensor().argmax(-1)[:, None])
                    logits, c = decode(sp, to_mesh({"t": toks[-1]})["t"], c, plen + i)
                return torch.cat(toks, 1)

            toks, serve_s, launch = self.drive("shard serve qwen3-0.6b", serve, sb * gen)
            if not torch.equal(toks, want_toks):
                raise AssertionError(f"shard serve: {int((toks != want_toks).sum())} of "
                                     f"{toks.numel()} tokens differ from generate's")
            if launch["flash_attention"] != n_attn * (1 + gen):
                raise AssertionError(f"shard serve: K4 launched {launch['flash_attention']} "
                                     f"times, not {n_attn * (1 + gen)}")
            r["serve"] = {"batch": sb, "prompt": plen, "steps": gen, "tokens_equal": True,
                          "wall_s": serve_s, "generate_wall_s": plain_serve_s,
                          "k4_launches": launch["flash_attention"]}
            self.shard_launches["serve"] = launch
            del sp, caches, params
        finally:
            dist.destroy_process_group()
            shutil.rmtree(store, ignore_errors=True)
        torch.cuda.empty_cache()

        # -- (b) rank 0 of the production mesh, in a child process ------------
        out = os.path.join(tempfile.mkdtemp(prefix="blaze-shard-"), "rank0.json")
        t0 = time.perf_counter()
        child = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--shard-rank0",
                                out], capture_output=True, text=True, timeout=900)
        if child.returncode != 0:
            raise AssertionError(f"shard rank 0: the child failed ({child.returncode}):\n"
                                 f"{child.stdout[-3000:]}\n{child.stderr[-4000:]}")
        with open(out) as f:
            r["rank0"] = json.load(f)
        r["rank0_s"] = time.perf_counter() - t0
        self.shard_launches["rank0"] = {k: v["launches"] for k, v in r["rank0"].items()}
        self.path_launches["shard rank0 gemma2-9b decode_32k"] = \
            r["rank0"]["gemma2-9b decode_32k"]["launches"]
        r["shard_s"] = time.perf_counter() - t_phase
        print(json.dumps({"shard_results": r}), flush=True)

    def shard_resume(self, cfg, mesh, mi, n_attn: int, card: str) -> dict:
        """``train`` over the ``DTensor`` tree of qwen3-0.6b on the (1, 1)
        mesh, saved, crashed, resumed and restored (module docstring, 11)."""
        import shutil
        import tempfile

        torch = self.torch
        from torch.distributed.tensor import DTensor
        from torch.utils import _pytree as pytree

        from repro_torch import convert
        from repro_torch.checkpoint.manager import CheckpointManager
        from repro_torch.data.pipeline import TokenPipeline
        from repro_torch.distributed import sharding as SH
        from repro_torch.models import model as M
        from repro_torch.optim.adamw import AdamW
        from repro_torch.runtime import train_loop as T

        t_sub = time.perf_counter()
        dev = self.dev
        batch, seq, _ = SHARD_TRAIN
        steps, every, crash_at = SHARD_RESUME
        pipe = TokenPipeline(cfg, batch=batch, seq_len=seq, seed=1)
        params = M.init(torch.Generator(device=dev).manual_seed(0), cfg)
        sp = convert.distribute(params, SH.param_pspecs(cfg, params, mi), mesh)
        del params
        # What each save held, cloned on the card as the save runs (on the
        # (1, 1) mesh a leaf's local shard is the whole leaf).
        saved: dict = {}
        real_save = CheckpointManager.save

        def save(mgr, step, tree, **kw):
            saved[(os.path.basename(mgr.dir), step)] = [
                (t.to_local() if isinstance(t, DTensor) else t).detach().clone()
                for t in pytree.tree_leaves(tree)]
            return real_save(mgr, step, tree, **kw)

        def same(a, b) -> bool:
            return len(a) == len(b) > 0 and all(torch.equal(x, y) for x, y in zip(a, b))

        def local(tree) -> list:
            return [t.to_local() if isinstance(t, DTensor) else t
                    for t in pytree.tree_leaves(tree)]

        tmp = tempfile.mkdtemp(prefix="blaze-shard-ckpt-")
        out = {"card": card, "arch": cfg.name, "mesh": "1x1 data x model, NCCL group of one",
               "batch": batch, "seq": seq, "steps": steps, "ckpt_every": every,
               "crash_at_step": crash_at}
        CheckpointManager.save = save
        try:
            kw = dict(steps=steps, batch=batch, seq_len=seq, pipeline=pipe, ckpt_every=every,
                      params=sp)
            whole, whole_s, launch_w = self.drive(
                "shard resume: train uninterrupted",
                lambda: T.train(cfg, ckpt_dir=os.path.join(tmp, "whole"),
                                optimizer=AdamW(lr=3e-4), **kw), batch * seq * steps)
            ckpt_bytes = whole.checkpoints[-1]["bytes"]
            saved.pop(("whole", every))
            shutil.rmtree(os.path.join(tmp, "whole"))  # at most two checkpoints on disk
            free = shutil.disk_usage(tmp).free
            if free < 2.5 * ckpt_bytes:
                raise AssertionError(f"shard resume: {free} bytes free in {tmp}, two "
                                     f"checkpoints of {ckpt_bytes} bytes need more")
            crash, crash_s, launch_c = self.drive(
                "shard resume: train crashed and resumed",
                lambda: T.train(cfg, ckpt_dir=os.path.join(tmp, "crash"),
                                crash_at_step=crash_at, optimizer=AdamW(lr=3e-4), **kw),
                batch * seq * (steps + crash_at - every))
        finally:
            CheckpointManager.save = real_save
        try:
            if (crash.restarts, crash.final_step, crash.steps_run) != (
                    1, steps, steps + crash_at - every):
                raise AssertionError(f"shard resume: restarts {crash.restarts}, final step "
                                     f"{crash.final_step}, steps run {crash.steps_run}")
            want_losses = whole.losses[:crash_at] + whole.losses[every:]
            if crash.losses != want_losses:
                raise AssertionError(f"shard resume: losses {crash.losses} against the "
                                     f"uninterrupted run's {want_losses}")
            final = saved.pop(("whole", steps))
            if not same(saved.pop(("crash", steps)), final):
                raise AssertionError("shard resume: the resumed run's final state differs "
                                     "from the uninterrupted run's")
            for name, launch, n_steps in (("uninterrupted", launch_w, steps),
                                          ("crashed", launch_c, crash.steps_run)):
                if launch["flash_attention"] != 2 * n_attn * n_steps:
                    raise AssertionError(f"shard resume ({name}): K4 launched "
                                         f"{launch['flash_attention']} times, not "
                                         f"{2 * n_attn * n_steps}")

            # The step-2 checkpoint onto the sharded tree and into a plain one.
            mgr = CheckpointManager(os.path.join(tmp, "crash"))
            opt = AdamW(lr=3e-4)
            state = opt.init(sp)  # the global shapes, plain
            like_s = T._ckpt_tree(sp, convert.distribute(
                state, SH.opt_pspecs(SH.param_pspecs(cfg, sp, mi), state), mesh))
            like_p = T._ckpt_tree(M.map_tree(lambda t: t.to_local(), sp), state)
            self.sync()
            t0 = time.perf_counter()
            got_s = mgr.restore(every, like_s)
            self.sync()
            restore_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            got_p = mgr.restore(every, like_p)
            self.sync()
            restore_p = time.perf_counter() - t0
            want = saved.pop(("crash", every))
            placed = all(isinstance(a, DTensor) and a.placements == b.placements
                         for a, b in zip(pytree.tree_leaves(got_s), pytree.tree_leaves(like_s)))
            if not (placed and same(local(got_s), want)):
                raise AssertionError("shard resume: the step-2 checkpoint restored onto the "
                                     "sharded tree differs from what was saved")
            if not same(local(got_p), want) or any(
                    isinstance(t, DTensor) or t.device.type != dev.type
                    for t in pytree.tree_leaves(got_p)):
                raise AssertionError("shard resume: the step-2 checkpoint restored into a "
                                     "plain tree on the card differs from what was saved")
            del want, like_s, like_p, state

            # One sharded and one unsharded step from those restores.
            b = pipe.device_batch(every, dev)
            sstep = T.make_sharded_train_step(cfg, opt,
                                              par=M.ParallelCfg(dispatch_groups=mi.dp_size))
            (_, _, sloss), sstep_s, launch_s = self.drive(
                "shard resume: sharded step from the checkpoint",
                lambda: sstep(got_s["params"], got_s["opt"], b), batch * seq)
            pstep = T.make_train_step(cfg, AdamW(lr=3e-4), device=dev)
            (_, _, ploss), pstep_s, launch_p = self.drive(
                "shard resume: unsharded step from the checkpoint",
                lambda: pstep(got_p["params"], got_p["opt"], b), batch * seq)
            sloss, ploss = float(sloss.to_local()), float(ploss)
            if not same(local(got_s), final):
                raise AssertionError("shard resume: the sharded step from the step-2 "
                                     "checkpoint differs from the uninterrupted run's")
            step_bit_equal = sloss == ploss and same(local(got_s), local(got_p))
            step_err = abs(sloss - ploss) / abs(ploss)
            if not step_bit_equal and step_err > TRAIN_LOSS_RTOL:
                raise AssertionError(f"shard resume: the unsharded step's loss {ploss} "
                                     f"against the sharded step's {sloss}")
            for name, launch in (("sharded", launch_s), ("unsharded", launch_p)):
                if launch["flash_attention"] != 2 * n_attn:
                    raise AssertionError(f"shard resume ({name} step): K4 launched "
                                         f"{launch['flash_attention']} times, not "
                                         f"{2 * n_attn}")
            del got_s, got_p, final
        finally:
            saved.clear()
            shutil.rmtree(tmp, ignore_errors=True)
        saves = [c for c in whole.checkpoints + crash.checkpoints if c["kind"] == "save"]
        out.update({
            "losses": whole.losses, "crashed_losses": crash.losses, "bit_equal": True,
            "restarts": crash.restarts, "steps_run": crash.steps_run,
            "wall_s": {"uninterrupted": whole_s, "crashed": crash_s},
            "step_s": {"uninterrupted": whole.step_times, "crashed": crash.step_times},
            "saves": [{"step": c["step"], "bytes": c["bytes"], "seconds": c["seconds"],
                       "gb_per_s": c["bytes"] / c["seconds"] / 1e9} for c in saves],
            "restores": {"train": [c["seconds"] for c in crash.checkpoints
                                   if c["kind"] == "restore"],
                         "sharded_s": restore_s, "plain_s": restore_p},
            "step_from_checkpoint": {
                "sharded_loss": sloss, "unsharded_loss": ploss, "bit_equal": step_bit_equal,
                "loss_rel_err": step_err, "sharded_s": sstep_s, "unsharded_s": pstep_s,
                "why_not_bit_equal": None if step_bit_equal else (
                    "the sharded step reaches the same kernels through local_map and "
                    "DTensor, whose ops may pick other f32 summation orders")},
            "k4_launches": {"uninterrupted": launch_w["flash_attention"],
                            "crashed": launch_c["flash_attention"],
                            "sharded_step": launch_s["flash_attention"],
                            "unsharded_step": launch_p["flash_attention"]}})
        self.shard_launches["resume"] = {"uninterrupted": launch_w, "crashed": launch_c,
                                         "sharded_step": launch_s, "unsharded_step": launch_p}
        out["resume_s"] = time.perf_counter() - t_sub
        print(json.dumps({"shard_resume": out}), flush=True)
        return out

    def lm_path(self, arch):
        """The LM serving path: ``repro_torch.launch.serve_lm.generate`` on
        ``arch`` at full width and depth in bf16 (random weights from seed
        0): batch 8, a 512-token prompt, 32 greedy decode steps, K4 on every
        attention call, K5 on every Mamba-2 layer and K6 on every RWKV-6
        layer, in the prefill and in every step; every step one replay of
        the captured step (``serve_lm.DecodeGraph``; the launches counted
        through the replays).  Held against the same
        model and weights on the plain path (``attn_impl="ref"``,
        ``scan_impl="chunked"``) teacher-forced along the same tokens, and
        against the teacher-forced ``forward`` (``dense_checks``; module
        docstring); against an eager run (``capture=False``,
        ``held_to_eager``); two replays of one step from the same caches must
        give the same bits (``graph_step``).  Then, for the archs
        ``LM_F32_TOL`` names, the f32 check (``lm_f32_check``), and for a
        model with a window (gemma2-9b) the window run (``lm_window_run``)."""
        torch = self.torch
        from repro_torch.configs.base import get_arch
        from repro_torch.launch.serve_lm import generate
        from repro_torch.models import model as M
        from repro_torch.models.attention import KVCache

        cfg = get_arch(arch)
        tol = LM_LOGIT_TOL[arch]
        b, plen, steps = 8, 512, 32
        max_len = plen + steps + 1
        if self.dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        g = torch.Generator(device=self.dev).manual_seed(0)
        params = M.init(g, cfg)
        prompts = torch.randint(0, cfg.vocab, (b, plen), generator=g, device=self.dev)
        (toks, decode_s, logits), _, launch = self.drive(
            f"lm {arch}", lambda: generate(cfg, params, prompts, max_len, steps,
                                           return_logits=True), b * steps)
        self.path_launches[f"lm {arch}"] = launch
        # K4 on every attention call, K5 on every Mamba-2 layer, K6 on every
        # RWKV-6 layer, in the prefill and in every step (each replay's
        # launches those of the captured step)
        counted = self.lm_launches(f"lm {arch}", launch, pass_launches(cfg), steps)
        if not bool(torch.isfinite(logits).all()) or toks.shape != (b, steps):
            raise AssertionError(f"lm {arch}: non-finite logits or a wrong token shape")

        checks, hidden = self.dense_checks(f"lm {arch}", params, cfg, prompts, toks, logits,
                                           tol, LM_LOGIT_RMS_TOL.get(arch, tol))
        f32 = self.lm_f32_check(arch) if arch in LM_F32_TOL else {}
        etoks, eager_s, elogits = generate(cfg, params, prompts, max_len, steps,
                                           return_logits=True, capture=False)
        eager = self.held_to_eager(f"lm {arch}", (toks, logits), (etoks, elogits), tol)
        del etoks, elogits

        caches = M.make_caches(cfg, b, max_len, self.dev)
        prefill_ms = self.time_ms(lambda: M.prefill(params, cfg, prompts, caches))
        # One decode step: event time against the card's busy time (the
        # rest is the card waiting on the host's eager dispatch).
        tok = toks[:, -1:]
        step_ms = self.time_ms(lambda: M.decode_step(params, cfg, tok, caches, max_len - 1))
        step_busy = self.device_busy_ms(
            lambda: M.decode_step(params, cfg, tok, caches, max_len - 1),
            names=(*K4_KERNELS, *K5_KERNELS, *K6_KERNELS))
        graph = self.graph_step(params, cfg, prompts, tok, steps)
        # The vocab head: bf16 operands, f32 result (logits_fn) against the
        # naive f32 upcast of both operands.
        last = hidden[:, -1]
        head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        head_ms = self.time_ms(lambda: M.logits_fn(params, cfg, last))
        upcast_ms = self.time_ms(lambda: last.float() @ head.float())
        # A decode step reads every weight once (zamba2's shared block once
        # per application; ``decode_weight_bytes``), the cached K/V rows so
        # far, and reads and writes every recurrent state (Mamba's conv tail
        # and SSD state, RWKV's shift rows and wkv state).
        nbytes = lambda t: t.numel() * t.element_size()  # noqa: E731
        weight_bytes = decode_weight_bytes(params, cfg, b)
        if "shared_attn" in params:
            per_use = sum(nbytes(t) for t in M._leaves(params["shared_attn"]))
            weight_bytes = (weight_bytes - per_use
                            + per_use * sum(p is params["shared_attn"]
                                            for p in params["layers"]))
        kv = [c for c in caches if isinstance(c, KVCache)]
        kv_bytes = sum(nbytes(c.k) + nbytes(c.v) for c in kv)
        row_bytes = kv_bytes // max_len
        kv_read = sum((plen + i + 1) * row_bytes for i in range(steps)) / steps
        state_bytes = sum(nbytes(t) for c in caches if not isinstance(c, KVCache)
                          for t in c)
        res = {
            "arch": cfg.name, "params": M.param_count(params),
            "batch": b, "prompt": plen, "steps": steps,
            "prefill_ms": prefill_ms,
            "decode_ms_per_step": decode_s / steps * 1e3,
            "eager_decode_ms_per_step": eager_s / steps * 1e3,
            "decode_step_event_ms": step_ms, "decode_step_device_ms": step_busy,
            **graph, "captured_vs_eager": eager,
            "head_ms": head_ms, "head_f32_upcast_ms": upcast_ms,
            "tok_per_s": b * steps / decode_s,
            "kv_cache_bytes": kv_bytes, "state_cache_bytes": state_bytes,
            "decode_bound_ms": (weight_bytes + kv_read + 2 * state_bytes)
            / HBM_BYTES_PER_S * 1e3,
            **checks, "logit_tol": tol, **f32, "launches": counted,
            # the run's peak device memory (the window run's apart)
            "peak_allocated_bytes": (torch.cuda.max_memory_allocated()
                                     if self.dev.type == "cuda" else None),
        }
        del caches, hidden, last
        if cfg.window:  # gemma2: its local layers past their window
            res["window_run"] = self.lm_window_run(params, cfg)
        return res

    def dense_checks(self, name, params, cfg, prompts, toks, logits, tol, rms_tol):
        """A ``generate`` run of a model with no MoE layer (``logits [B, n +
        1, V]`` after ``prompts [B, P]``, along ``toks [B, n]``) against the
        plain path (``attn_impl="ref"``, ``scan_impl="chunked"``)
        teacher-forced along the same tokens, and against the teacher-forced
        ``forward`` with the kernels (decode against it is the model's own
        rounding noise): each max within ``tol``, each RMS within
        ``rms_tol``; greedy tokens must be the plain path's argmax wherever
        its top-2 logits lie more than ``2·tol`` apart.  Prints the errors
        before it fails; returns them and the forward's hidden states."""
        torch = self.torch
        from repro_torch.models import model as M

        plen, steps = prompts.shape[1], toks.shape[1]
        ref = self.teacher_forced(params, cfg, prompts, toks, plen + steps + 1,
                                  attn_impl="ref", scan_impl="chunked")
        top2 = torch.topk(ref[:, :steps], 2, dim=-1).values
        near = (top2[..., 0] - top2[..., 1]) <= 2 * tol
        differ = ref[:, :steps].argmax(-1) != toks
        del top2
        hidden, _, _ = M.forward(params, cfg, torch.cat([prompts, toks], 1))
        fwd = M.logits_fn(params, cfg, hidden[:, plen - 1:plen + steps])
        res = {"logit_err_vs_plain": float((logits - ref).abs().max()),
               "logit_err_vs_forward": float((logits - fwd).abs().max()),
               "logit_rms": [float((logits - x).pow(2).mean().sqrt()) for x in (ref, fwd)],
               "logit_std": float(logits.std()),
               "near_tie_rows": int(near.any(1).sum()),
               "token_differences": int(differ.sum()),
               "decided_token_differences": int((differ & ~near).sum())}
        del ref, fwd
        print(json.dumps({"lm_check": name, **res, "tol": tol, "rms_tol": rms_tol}),
              flush=True)
        if res["decided_token_differences"]:
            raise AssertionError(f"{name}: a decided greedy token differs from the plain "
                                 "path")
        if (max(res["logit_err_vs_plain"], res["logit_err_vs_forward"]) > tol
                or max(res["logit_rms"]) > rms_tol):
            raise AssertionError(f"{name}: logits off by {res['logit_err_vs_plain']} "
                                 f"(plain path) and {res['logit_err_vs_forward']} (forward), "
                                 f"tolerance {tol}; RMS {res['logit_rms']}, tolerance "
                                 f"{rms_tol}")
        return res, hidden

    def lm_f32_check(self, arch):
        """``arch`` built in f32 (random weights from seed 0; at
        ``F32_LAYERS`` layers where it names the arch, else at full depth;
        batch 2, a 512-token prompt, 8 greedy steps through ``generate``,
        the same kernels, K4 in its f32 form on every attention call): max
        |kernel path − plain path| of the logits, the plain path
        (``attn_impl="ref"``, ``scan_impl="chunked"``) teacher-forced along
        the same tokens, and max |decode − teacher-forced forward|, both
        within ``LM_F32_TOL``.  With f32 rounding in place of bf16's, a
        fault of a kernel or of the decode path (a state carried wrong, a
        conv tail or shift row off by one) shows here far above rounding,
        and greedy tokens must be the plain path's argmax wherever its top-2
        logits lie more than ``2·LM_F32_TOL`` apart.  The run decodes
        through the captured step, held to an eager run within
        ``LM_F32_TOL``; two replays of one step must give the same bits."""
        torch = self.torch
        import dataclasses
        from repro_torch.configs.base import get_arch
        from repro_torch.launch.serve_lm import generate
        from repro_torch.models import model as M

        tol = LM_F32_TOL[arch]
        f32 = dict(param_dtype="float32", compute_dtype="float32")
        cfg = (self.cut_config(arch, F32_LAYERS[arch], **f32) if arch in F32_LAYERS
               else dataclasses.replace(get_arch(arch), **f32))
        b, plen, steps = 2, 512, 8
        g = torch.Generator(device=self.dev).manual_seed(0)
        params = M.init(g, cfg)
        prompts = torch.randint(0, cfg.vocab, (b, plen), generator=g, device=self.dev)
        (toks, _, logits), _, launch = self.drive(
            f"lm {arch} f32", lambda: generate(cfg, params, prompts, plen + steps + 1, steps,
                                               return_logits=True), b * steps)
        self.lm_launches(f"lm {arch} f32", launch, pass_launches(cfg), steps, f32=True)
        eager = self.held_to_eager(f"lm {arch} f32", (toks, logits), generate(
            cfg, params, prompts, plen + steps + 1, steps, return_logits=True,
            capture=False)[::2], tol)
        graph = self.graph_step(params, cfg, prompts, toks[:, -1:], steps, timed=False)
        ref = self.teacher_forced(params, cfg, prompts, toks, plen + steps + 1,
                                  attn_impl="ref", scan_impl="chunked")
        hidden, _, _ = M.forward(params, cfg, torch.cat([prompts, toks], 1))
        fwd = M.logits_fn(params, cfg, hidden[:, plen - 1:plen + steps])
        top2 = torch.topk(ref[:, :steps], 2, dim=-1).values
        decided = (top2[..., 0] - top2[..., 1]) > 2 * tol
        res = {"f32_layers": cfg.n_layers,
               "f32_vs_plain": float((logits - ref).abs().max()),
               "f32_decode_vs_forward": float((logits - fwd).abs().max()),
               "f32_decided_tokens": int(decided.sum()),
               "f32_decided_token_differences": int(
                   ((ref[:, :steps].argmax(-1) != toks) & decided).sum()),
               "f32_captured_vs_eager_err": eager["captured_vs_eager_err"],
               "f32_replay_bit_equal": graph["replay_bit_equal"], "f32_tol": tol}
        del params, hidden, ref, fwd
        torch.cuda.empty_cache()
        print(json.dumps({"lm_check": f"{arch} f32", **res}), flush=True)
        if max(res["f32_vs_plain"], res["f32_decode_vs_forward"]) > tol:
            raise AssertionError(f"lm {arch}: in f32, logits off the plain path by "
                                 f"{res['f32_vs_plain']} and off the forward by "
                                 f"{res['f32_decode_vs_forward']}, tolerance {tol}")
        if res["f32_decided_token_differences"]:
            raise AssertionError(f"lm {arch}: in f32, a decided greedy token differs "
                                 "from the plain path")
        return res

    # -- MoE and the embedding-input models ----------------------------------

    def lm_launches(self, name, launch, layers, steps, *, captured=True, models=1,
                    f32=False):
        """Hold an LM run's launches (``drive``'s ``launch``) to what its
        ``steps`` decode steps a model must make, and return them.
        ``layers`` maps K4, K5 and K6 to their calls in one pass over the
        layers (the prefill, or one step), summed over the ``models`` the
        run serves.  A captured run's wrappers count three passes a model
        (the prefill, the step's warm-up and its capture: each wrapper counts
        where it launches, and a replay calls none), its decode graph
        ``steps`` replays and their launches the ``steps`` other passes
        (``launch["decode_graph"]``); an eager run's wrappers count all ``1 +
        steps`` and it captures nothing.  K4 takes its f32 form throughout
        with ``f32``, else its bf16 prefill form in the prefill and its
        decode form in every step; K5 and K6 their prefill and decode forms.
        The result's ``path`` is each kernel's launches on the path, by form
        too: the wrappers' plus the decode graph replays'."""
        graphs = launch["decode_graph"]
        dec = 2 if captured else steps  # the decode passes the wrappers count
        want_graphs = (models, models * steps) if captured else (0, 0)
        n = {k: layers.get(k, 0) for k in ("flash_attention", "ssd_scan", "rwkv6_scan")}
        wrappers = {k: c * (1 + dec) for k, c in n.items()}
        k4 = n["flash_attention"]
        forms = {"flash_attention": ({"f32": k4 * (1 + dec), "bf16-prefill": 0,
                                      "bf16-decode": 0} if f32 else
                                     {"f32": 0, "bf16-prefill": k4, "bf16-decode": k4 * dec}),
                 **{k: {"decode": n[k] * dec, "prefill": n[k]}
                    for k in ("ssd_scan", "rwkv6_scan")}}
        decode_form = {"flash_attention": "f32" if f32 else "bf16-decode",
                       "ssd_scan": "decode", "rwkv6_scan": "decode"}
        replays = {}
        if captured:
            for k, c in n.items():
                if c:
                    replays[k] = replays[f"{k}/{decode_form[k]}"] = c * steps
        got = {k: launch[k] for k in wrappers}
        got_forms = {k: launch[f"{k} forms"] for k in forms}
        got_graphs = (graphs["captures"], graphs["replays"])
        if (got, got_forms, got_graphs, graphs["replay_launches"]) != (
                wrappers, forms, want_graphs, replays):
            raise AssertionError(
                f"{name}: wrappers {got} {got_forms}, decode graph captures and replays "
                f"{got_graphs} launching {graphs['replay_launches']}; want {wrappers} "
                f"{forms}, {want_graphs} launching {replays}")
        path = {k: got[k] + replays.get(k, 0) for k in got}
        path_forms = {k: {f: c + replays.get(f"{k}/{f}", 0) for f, c in fs.items()}
                      for k, fs in got_forms.items()}
        return {"path": path, "path_forms": path_forms, "wrappers": got,
                "wrapper_forms": got_forms, "decode_graph_captures": got_graphs[0],
                "decode_graph_replays": got_graphs[1], "replay_launches": replays,
                "counted_as": "wrappers + decode graph replays"}

    def teacher_forced(self, params, cfg, first, rest, max_len, **kw):
        """Prefill ``first`` (tokens ``[B, P]`` or embeds ``[B, P, d]``), then
        one decode step on each ``rest[:, i:i + 1]``: the f32 logits ``[B,
        n + 1, V]`` (the prefill's first)."""
        from repro_torch.models import model as M

        caches = M.make_caches(cfg, first.shape[0], max_len, self.dev)
        out = [M.prefill(params, cfg, first, caches, **kw)[0]]
        for i in range(rest.shape[1]):
            out.append(M.decode_step(params, cfg, rest[:, i:i + 1], caches,
                                     first.shape[1] + i, **kw)[0])
        return self.torch.stack(out, 1)

    def held_to_eager(self, name, got, want, tol):
        """A run through the captured step (``got``: tokens ``[B, n]`` or
        None for embedding inputs, logits ``[B, n + 1, V]``) against an eager
        run of the same model and inputs (``want``): the decode form's splits
        come from the cache in one and from the offset in the other, so bits
        may differ.  Each row's logits up to its first differing token (they
        follow the same tokens) within ``tol``; a token may differ only where
        the eager run's top-2 logits lie within ``2·tol``."""
        (ta, la), (tb, lb) = got, want
        if la.shape != lb.shape or not bool(self.torch.isfinite(la).all()):
            raise AssertionError(f"{name}: captured logits {tuple(la.shape)} against "
                                 f"{tuple(lb.shape)}, or not finite")
        worst, compared, first = 0.0, 0, []
        for row in range(la.shape[0]):
            n_same = la.shape[1] - 1
            if ta is not None:
                diff = (ta[row] != tb[row]).nonzero()
                n_same = int(diff[0]) if len(diff) else ta.shape[1]
            worst = max(worst, float((la[row, :n_same + 1] - lb[row, :n_same + 1])
                                     .abs().max()))
            compared += min(n_same + 1, la.shape[1])
            if ta is not None and n_same < ta.shape[1]:
                top2 = self.torch.topk(lb[row, n_same], 2).values
                if float(top2[0] - top2[1]) > 2 * tol:
                    raise AssertionError(f"{name} row {row}: captured token {n_same} "
                                         "differs from the eager run's, which was decided")
                first.append(n_same)
        res = {"captured_vs_eager_err": worst, "captured_vs_eager_bit_equal": bool(
            self.torch.equal(la, lb)), "logits_compared": compared,
            "first_token_differences": first, "tol": tol}
        print(json.dumps({"lm_check": name, "pair": "captured_vs_eager", **res}), flush=True)
        if worst > tol:
            raise AssertionError(f"{name}: captured logits off the eager run's by {worst}, "
                                 f"tolerance {tol}")
        return res

    def graph_step(self, params, cfg, first, step_in, steps, timed=True):
        """The captured decode step (``serve_lm.DecodeGraph``) after a
        prefill of ``first``, at the run's last position (as the eager
        step's timing): two replays from the same snapshot of the caches must
        give the same bits; with ``timed``, a replay's event ms and the card's
        busy ms (each replay after a ``seek`` back to that position), the
        profile holding each K4/K5/K6 kernel the captured step launches as
        many times a replay as it was captured (``STEP_KERNELS``; asked twice
        before it fails, as a profile may miss launches)."""
        torch = self.torch
        from repro_torch.launch.serve_lm import DecodeGraph
        from repro_torch.models import model as M

        b, plen = first.shape[:2]
        max_len = plen + steps + 1
        caches = M.make_caches(cfg, b, max_len, self.dev)
        M.prefill(params, cfg, first, caches)
        pos = max_len - 1
        self.sync()
        t0 = time.perf_counter()
        graph = DecodeGraph(cfg, params, caches, step_in, pos,
                            capture=self.dev.type == "cuda")
        self.sync()
        res = {"capture_s": time.perf_counter() - t0}
        live = [t for c in caches for t in c]
        snap = [t.clone() for t in live]
        once = graph.step(step_in).clone()
        for t, u in zip(live, snap):
            t.copy_(u)
        graph.seek(pos)
        if not torch.equal(graph.step(step_in), once):
            raise AssertionError(f"{cfg.name}: two replays of one decode step from the same "
                                 "caches differ")
        res["replay_bit_equal"] = True
        del snap, once
        if timed:
            def replay():
                graph.seek(pos)
                return graph.step(step_in)

            res["captured_step_event_ms"] = self.time_ms(replay)
            expect = {}
            for form, n in graph.captured_launches.items():
                for name in STEP_KERNELS.get(form, ()):
                    expect[name] = expect.get(name, 0) + n
            if not expect:
                raise AssertionError(f"{cfg.name}: the captured step launched no kernel: "
                                     f"{graph.captured_launches}")
            for _ in range(2):
                busy = self.device_busy_ms(replay, names=(*K4_KERNELS, *K5_KERNELS,
                                                          *K6_KERNELS), expect=expect)
                if busy is not None and busy["total"] is not None:
                    break
            else:
                raise AssertionError(f"{cfg.name}: a replay's profile shows the kernels "
                                     f"{busy and busy['events']}, not the captured step's "
                                     f"{expect} a replay")
            res["captured_step_device_ms"] = busy
            res["captured_launches"] = graph.captured_launches
        del graph, caches, live
        torch.cuda.empty_cache()
        return res

    @staticmethod
    def masked_err(got, want, rows):
        """max |got − want| over the ``[B, n]`` positions ``rows`` holds (None
        where it holds none)."""
        err = (got - want).abs().amax(-1)[rows]
        return float(err.max()) if err.numel() else None

    def routes_checked(self, name, runs, n_layers, k, plen, tol):
        """Hold pairs of runs' logits ``[B, n + 1, V]`` (positions ``plen −
        1`` on) where their routes leave them clean, within ``tol``, and at
        least a share of them clean; every flip must be a near-tie flip
        (``compare_routes``).  ``runs``: label -> (logits, RouteLog, logits,
        RouteLog, lens, share), the logs None for a model without MoE layers
        (every logit held), the logits None to hold the routes alone."""
        out = {}
        for label, (la, ra, lb, rb, lens, share) in runs.items():
            if ra is not None:
                cmp = compare_routes(ra.trace(n_layers)[0], rb.trace(n_layers)[0], lens, k)
                clean = cmp.pop("clean")[:, plen - 1:]
            else:
                cmp, clean = {}, self.torch.ones(la.shape[:2], dtype=bool, device=self.dev)
            if la is not None:
                clean = clean[:, :la.shape[1]]
                err = self.masked_err(la, lb, clean)
                out[label] = {"logit_err": err, "clean_logits": int(clean.sum()),
                              "of": clean.numel(), "min_clean_share": share}
            out[label] = {**out.get(label, {}), **cmp}
            print(json.dumps({"lm_check": name, "pair": label, "tol": tol, **out[label]}),
                  flush=True)
            if cmp.get("not_near_tie") or cmp.get("unexplained_knock_on"):
                raise AssertionError(f"{name} {label}: a route flip away from a near-tie, "
                                     "or a kept choice that differs with no flip before "
                                     "it in its group")
            if la is not None and (int(clean.sum()) < share * clean.numel()
                                   or (err is not None and err > tol)):
                raise AssertionError(f"{name} {label}: {int(clean.sum())} of {clean.numel()} "
                                     f"logits clean (at least a share {share} needed), "
                                     f"logits off by {err}, tolerance {tol}")
        return out

    def step_local(self, params, cfg, toks, first, caches_len, tol, n_layers):
        """Each decode step of the kernel path against the plain path's step
        from a copy of the same caches: the two share every earlier step,
        so a step's routes differ only at that step's own near-ties.  The
        steps' routes are compared together (``compare_routes``, each
        (step, row) a row of its own, a step's rows one group); a (step,
        row) whose routes differ is left out of the logits."""
        torch = self.torch
        from repro_torch.models import model as M
        from repro_torch.models.attention import KVCache

        b, plen = first.shape[0], first.shape[1]
        caches = M.make_caches(cfg, b, caches_len, self.dev)
        M.prefill(params, cfg, first, caches)
        logits, routes = {"kernel": [], "plain": []}, {"kernel": [], "plain": []}
        for i in range(toks.shape[1]):
            copy = [KVCache(c.k.clone(), c.v.clone()) for c in caches]
            for path, cache, kw in (("plain", copy, {"attn_impl": "ref"}),
                                    ("kernel", caches, {})):
                with RouteLog() as log:
                    out, _ = M.decode_step(params, cfg, toks[:, i:i + 1], cache, plen + i,
                                           **kw)
                logits[path].append(out)
                routes[path].append(log.trace(n_layers)[0])
            del copy

        def stacked(traces):
            return [{key: torch.cat([t[j][key] for t in traces]) for key in traces[0][j]}
                    for j in range(n_layers)]

        cmp = compare_routes(stacked(routes["kernel"]), stacked(routes["plain"]), [1],
                             cfg.top_k, rows_per_group=b)
        rows = cmp.pop("clean")[:, 0].reshape(len(logits["kernel"]), b)
        err = self.masked_err(torch.stack(logits["kernel"]), torch.stack(logits["plain"]),
                              rows)
        res = {"step_local_err": err, "step_local_clean": int(rows.sum()),
               "step_local_of": rows.numel(),
               **{f"step_local_{k}": v for k, v in cmp.items()}}
        if cmp["not_near_tie"] or cmp["unexplained_knock_on"]:
            raise AssertionError(f"step-local check: a route flip away from a near-tie, or "
                                 f"an unexplained knock-on: {res}")
        if err is None or err > tol:
            raise AssertionError(f"step-local check: {res}, tolerance {tol}")
        return res

    def block_shares(self, params, cfg, step):
        """The card's busy ms of one decode step's MoE blocks and attention
        blocks, each replayed alone on the inputs ``step()`` gave them (the
        attention rewrites the same cache rows)."""
        from repro_torch.models import attention as A
        from repro_torch.models import moe as MOE

        calls = {"moe": [], "attn": []}
        orig = {"moe": MOE.moe_apply, "attn": A.attn_apply}

        def rec(kind):
            def wrapped(*args, **kwargs):
                calls[kind].append((args, kwargs))
                return orig[kind](*args, **kwargs)
            return wrapped

        MOE.moe_apply, A.attn_apply = rec("moe"), rec("attn")
        try:
            step()
        finally:
            MOE.moe_apply, A.attn_apply = orig["moe"], orig["attn"]
        self.sync()
        out = {}
        for kind, fn in orig.items():
            if calls[kind]:
                busy = self.device_busy_ms(
                    lambda: [fn(*a, **kw) for a, kw in calls[kind]],
                    names=K4_KERNELS if kind == "attn" else ())
                out[f"{kind}_busy_ms"] = busy and busy["total"]
        return out

    def lm_timings(self, params, cfg, first, step_in, steps):
        """Prefill ms, one decode step's event ms and the card's busy ms by
        kernel (K4 apart), the MoE and attention blocks' busy ms, and the
        step's byte bound: every weight read once (the dense ``[E, C, d]``
        experts compute every expert each step) but an untied embedding
        table, of which a step gathers ``B`` rows (none when a frontend feeds
        the embeddings), and the cached K/V rows of the run's mean step
        (``first``: the prompt, then ``steps`` steps); and the captured
        step's (``graph_step``)."""
        from repro_torch.models import model as M

        b, plen = first.shape[:2]
        max_len = plen + steps + 1
        caches = M.make_caches(cfg, b, max_len, self.dev)
        res = {"prefill_ms": self.time_ms(lambda: M.prefill(params, cfg, first, caches))}

        def step():
            return M.decode_step(params, cfg, step_in, caches, max_len - 1)

        res["decode_step_event_ms"] = self.time_ms(step)
        res["decode_step_device_ms"] = self.device_busy_ms(step, names=K4_KERNELS)
        res.update(self.block_shares(params, cfg, step))
        res.update(self.graph_step(params, cfg, first, step_in, steps))
        nbytes = lambda t: t.numel() * t.element_size()  # noqa: E731
        kv = sum(nbytes(c.k) + nbytes(c.v) for c in caches)
        kv_read = kv / max_len * sum(plen + i + 1 for i in range(steps)) / steps
        weight = decode_weight_bytes(params, cfg, b)
        res.update(kv_cache_bytes=kv, weight_read_bytes=weight,
                   decode_bound_ms=(weight + kv_read) / HBM_BYTES_PER_S * 1e3)
        return res

    def cut_config(self, arch, layers, **kw):
        """``arch`` cut to its first ``layers`` layers, whole stages (a stage
        is one block in the MoE, embedding-fed and dense models, a local and
        a global layer in gemma2-9b's), with ``kw`` replaced."""
        import dataclasses
        from repro_torch.configs.base import get_arch

        cfg = get_arch(arch)
        per = len(cfg.stage_pattern)
        if layers % per or cfg.tail_pattern:
            raise ValueError(f"{arch}: {layers} layers are not whole stages of {per}")
        return dataclasses.replace(cfg, n_layers=layers, n_stages=layers // per, **kw)

    def param_counts(self, params, cfg):
        """Total and active parameters of the cut model, and of the model at
        its published depth (every layer alike, so its layers scale)."""
        from repro_torch.configs.base import get_arch
        from repro_torch.models import model as M

        full_layers = get_arch(cfg.name).n_layers
        total, active = M.param_count(params), M.active_param_count(params, cfg)
        layer = {"layers": params["layers"][:1]}
        per, per_active = M.param_count(layer), M.active_param_count(layer, cfg)
        n = len(params["layers"])
        return {"params": total, "active_params": active,
                "params_full_depth": total + (full_layers - n) * per,
                "active_params_full_depth": active + (full_layers - n) * per_active}

    def moe_checks(self, name, params, cfg, prompts, toks, logits, routes, tol):
        """A ``generate`` run's logits ``[B, n + 1, V]`` and routes (its
        ``RouteLog``) against the plain path, and, at ``capacity_factor = E /
        k`` where nothing can drop, decode teacher-forced along the same
        tokens against the forward (``routes_checked``).  In f32 the plain
        path runs teacher-forced along the run's tokens and at least half
        the logits of each pair must be clean.  In bf16 near-ties flip all
        through the prefill and leave no logit of the run clean, so the
        plain path runs the prefill alone and its routes are held (every
        flip of an untainted token, all of layer 0's among them, at a
        near-tie); at least an eighth of decode's logits must be clean
        against the forward; and the step-local check holds the steps'."""
        torch = self.torch
        import dataclasses
        from repro_torch.models import model as M

        n, (b, plen) = len(params["layers"]), prompts.shape
        max_len = plen + toks.shape[1] + 1
        f32 = cfg.cdtype == torch.float32
        with RouteLog() as rp:
            if f32:
                plain = (logits, routes, self.teacher_forced(
                    params, cfg, prompts, toks, max_len, attn_impl="ref"), rp,
                    routes.trace(n)[1], 0.5)
            else:
                M.prefill(params, cfg, prompts, M.make_caches(cfg, b, plen, self.dev),
                          attn_impl="ref")
                plain = (None, routes.head(n), None, rp, [plen], 0.0)
        nodrop = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
        with RouteLog() as rd:
            dec = self.teacher_forced(params, nodrop, prompts, toks[:, :-1], max_len)
        with RouteLog() as rf:
            hidden, _, _ = M.forward(params, nodrop, torch.cat([prompts, toks[:, :-1]], 1))
        fwd = M.logits_fn(params, cfg, hidden[:, plen - 1:])
        del hidden
        res = {"checks": self.routes_checked(name, {
            "kernel_vs_plain" if f32 else "prefill_routes_vs_plain": plain,
            "decode_vs_forward": (dec, rd, fwd, rf, None, 0.5 if f32 else 0.125)},
            n, cfg.top_k, plen, tol)}
        del plain, dec, fwd
        if not f32:
            local = self.step_local(params, cfg, toks, prompts, max_len, tol, n)
            print(json.dumps({"lm_check": name, **local}), flush=True)
            res.update(local)
        return res

    def lm_moe_path(self, arch):
        """An MoE model (module docstring) at full width and ``MOE_LAYERS``
        layers in bf16 (random weights from seed 0): ``generate`` for batch
        8, 512-token prompts, 32 greedy steps, K4 on every attention call,
        routes recorded on every MoE call of an eager run (``capture=False``:
        a replay calls no Python), held by ``moe_checks``; then the main
        path's run through the captured step, its launches counted through
        the replays, held to the eager run (``held_to_eager``); mixtral also
        takes the window run; then the f32 check."""
        torch = self.torch
        from repro_torch.launch.serve_lm import generate
        from repro_torch.models import model as M

        n = MOE_LAYERS[arch]
        cfg = self.cut_config(arch, n)
        tol = LM_LOGIT_TOL[arch]
        b, plen, steps = 8, 512, 32
        max_len = plen + steps + 1
        g = torch.Generator(device=self.dev).manual_seed(0)
        params = M.init(g, cfg)
        prompts = torch.randint(0, cfg.vocab, (b, plen), generator=g, device=self.dev)
        with RouteLog() as rk:
            (toks, eager_s, logits), _, launch = self.drive(
                f"lm {arch} eager", lambda: generate(cfg, params, prompts, max_len, steps,
                                                     return_logits=True, capture=False),
                b * steps)
        self.lm_launches(f"lm {arch} eager", launch, {"flash_attention": n}, steps,
                         captured=False)
        (ctoks, decode_s, clogits), _, launch = self.drive(
            f"lm {arch}", lambda: generate(cfg, params, prompts, max_len, steps,
                                           return_logits=True), b * steps)
        self.path_launches[f"lm {arch}"] = launch
        counted = self.lm_launches(f"lm {arch}", launch, {"flash_attention": n}, steps)
        if not bool(torch.isfinite(logits).all()) or toks.shape != (b, steps):
            raise AssertionError(f"lm {arch}: non-finite logits or a wrong token shape")
        eager = self.held_to_eager(f"lm {arch}", (ctoks, clogits), (toks, logits), tol)
        del ctoks, clogits
        kept = torch.stack([t["kept"] for t in rk.trace(n)[0]])  # [L, B, T, k]
        res = {"arch": cfg.name, "layers": n, **self.param_counts(params, cfg),
               "batch": b, "prompt": plen, "steps": steps,
               "dropped_share": {"prefill": float((~kept[:, :, :plen]).float().mean()),
                                 "steps": float((~kept[:, :, plen:]).float().mean())},
               **self.moe_checks(f"lm {arch}", params, cfg, prompts, toks, logits, rk, tol),
               "logit_tol": tol, "logit_std": float(logits.std()),
               "launches": counted, "captured_vs_eager": eager}
        res.update(decode_ms_per_step=decode_s / steps * 1e3, tok_per_s=b * steps / decode_s,
                   eager_decode_ms_per_step=eager_s / steps * 1e3)
        res.update(self.lm_timings(params, cfg, prompts, toks[:, -1:], steps))
        if arch == "mixtral-8x22b":
            res["window_run"] = self.lm_window_run(params, cfg)
        del params
        torch.cuda.empty_cache()
        res["f32"] = self.lm_moe_f32(arch)
        return res

    def lm_window_run(self, params, cfg):
        """A window run of a model with local layers (mixtral-8x22b: every
        layer; gemma2-9b: a local and a global layer a stage): batch 1, a
        4608-token prompt (a local layer's keys beyond the window masked in
        the prefill), 16 greedy steps.  An eager run first: each step's
        local layers read the last ``window + 1`` cache rows through
        ``attn_apply``'s view, so every local decode call of K4 must see
        ``window + 1`` keys at offset ``window``, and every global one the
        whole cache at the step's offset.  Then the main path's run through
        the captured step, whose K4 calls (the warm-up's and the capture's)
        must see the whole cache with the offset on the device, local layers
        with their window; held to the eager run (``held_to_eager``).  An
        MoE model's eager run records its routes and is held by
        ``moe_checks``; a dense one's by ``dense_checks``."""
        torch = self.torch
        from repro_torch.configs.base import ATTN_LOCAL, ATTN_LOCAL_MOE
        from repro_torch.kernels import ops
        from repro_torch.launch.serve_lm import generate
        from repro_torch.models import model as M

        name = f"lm {cfg.name.split('-')[0]} window"
        tol = LM_LOGIT_TOL[cfg.name]
        b, plen, steps = WINDOW_RUN
        w = cfg.window
        local = [k in (ATTN_LOCAL, ATTN_LOCAL_MOE) for k in M.layer_kinds(cfg)]
        n = len(local)
        max_len = plen + steps + 1
        g = torch.Generator(device=self.dev).manual_seed(1)
        prompts = torch.randint(0, cfg.vocab, (b, plen), generator=g, device=self.dev)
        seen, kernel = [], ops._flash_kernel
        # each layer's K4 call, (Sq, Skv, q_offset, window), in the prefill
        prefill = [(plen, max_len, 0, w if lw else None) for lw in local]

        def shapes(q, k, v, **kw):
            off = kw["q_offset"]
            seen.append((q.shape[2], k.shape[2],
                         "device" if isinstance(off, torch.Tensor) else off, kw["window"]))
            return kernel(q, k, v, **kw)

        ops._flash_kernel = shapes
        routes = RouteLog() if cfg.is_moe else None
        try:
            with routes or contextlib.nullcontext():
                (toks, eager_s, logits), _, launch = self.drive(
                    f"{name} eager", lambda: generate(
                        cfg, params, prompts, max_len, steps, return_logits=True,
                        capture=False), b * steps)
            self.lm_launches(f"{name} eager", launch, {"flash_attention": n}, steps,
                             captured=False)
            eager_calls = prefill + [(1, w + 1, w, w) if lw else (1, max_len, plen + i, None)
                                     for i in range(steps) for lw in local]
            if seen != eager_calls:
                raise AssertionError(f"{name}: K4 calls saw (Sq, Skv, q_offset, window) "
                                     f"{sorted(set(seen), key=str)}, not "
                                     f"{sorted(set(eager_calls), key=str)}")
            seen.clear()
            (ctoks, decode_s, clogits), _, launch = self.drive(
                name, lambda: generate(cfg, params, prompts, max_len, steps,
                                       return_logits=True), b * steps)
        finally:
            ops._flash_kernel = kernel
        self.path_launches[name] = launch
        counted = self.lm_launches(name, launch, {"flash_attention": n}, steps)
        # the prefill, then the warm-up's and the capture's calls of the step
        captured_calls = prefill + [(1, max_len, "device", w if lw else None)
                                    for lw in local] * 2
        if seen != captured_calls:
            raise AssertionError(f"{name}, captured: K4 calls saw (Sq, Skv, q_offset, "
                                 f"window) {sorted(set(seen), key=str)}, not "
                                 f"{sorted(set(captured_calls), key=str)}")
        eager = self.held_to_eager(name, (ctoks, clogits), (toks, logits), tol)
        del ctoks, clogits
        if routes:
            res = self.moe_checks(name, params, cfg, prompts, toks, logits, routes, tol)
        else:
            res, hidden = self.dense_checks(name, params, cfg, prompts, toks, logits, tol,
                                            LM_LOGIT_RMS_TOL.get(cfg.name, tol))
            del hidden
        caches = M.make_caches(cfg, b, max_len, self.dev)
        res.update(
            batch=b, prompt=plen, steps=steps, k4_calls=len(seen), decode_keys=w + 1,
            local_layers=sum(local), global_layers=n - sum(local),
            decode_ms_per_step=decode_s / steps * 1e3,
            eager_decode_ms_per_step=eager_s / steps * 1e3,
            launches=counted, captured_vs_eager=eager,
            prefill_ms=self.time_ms(lambda: M.prefill(params, cfg, prompts, caches)),
            decode_step_event_ms=self.time_ms(lambda: M.decode_step(
                params, cfg, toks[:, -1:], caches, max_len - 1)))
        del caches
        res.update(self.graph_step(params, cfg, prompts, toks[:, -1:], steps))
        torch.cuda.empty_cache()
        return res

    def lm_moe_f32(self, arch):
        """``arch`` in f32 at ``MOE_F32_LAYERS`` layers (random weights from
        seed 0; batch 2, a 512-token prompt, 8 greedy steps; for mixtral also
        batch 1, a 4608-token prompt, 8 steps: the window view), held by
        ``moe_checks`` (no step-local check) within ``LM_F32_TOL`` where the
        routes leave the logits clean; f32 rounding leaves far fewer
        near-ties than bf16's, and at least half the logits must be clean.
        Those runs are eager (routes recorded); each is run again through the
        captured step, held to it within ``LM_F32_TOL``, and two replays of
        one step must give the same bits."""
        torch = self.torch
        from repro_torch.launch.serve_lm import generate
        from repro_torch.models import model as M

        cfg = self.cut_config(arch, MOE_F32_LAYERS, param_dtype="float32",
                              compute_dtype="float32")
        g = torch.Generator(device=self.dev).manual_seed(0)
        params = M.init(g, cfg)
        out = {}
        runs = [(2, 512, 8)] + ([(1, WINDOW_RUN[1], 8)] if cfg.window else [])
        for b, plen, steps in runs:
            prompts = torch.randint(0, cfg.vocab, (b, plen), generator=g, device=self.dev)
            with RouteLog() as rk:
                toks, _, logits = generate(cfg, params, prompts, plen + steps + 1, steps,
                                           return_logits=True, capture=False)
            key = f"b{b}_p{plen}"
            out[key] = self.moe_checks(f"lm {arch} f32 {key}", params, cfg, prompts, toks,
                                       logits, rk, LM_F32_TOL[arch])
            out[key]["captured_vs_eager"] = self.held_to_eager(
                f"lm {arch} f32 {key}", generate(cfg, params, prompts, plen + steps + 1,
                                                 steps, return_logits=True)[::2],
                (toks, logits), LM_F32_TOL[arch])
            out[key].update(self.graph_step(params, cfg, prompts, toks[:, -1:], steps,
                                            timed=False))
        del params
        torch.cuda.empty_cache()
        return {"layers": MOE_F32_LAYERS, "tol": LM_F32_TOL[arch], **out}

    def mrope_positions(self, b, s):
        """``(t, h, w)`` triples ``[3, B, S]``: a 16 × 16 image's patches at
        ``t = 0`` (row, column), then text whose three coordinates all
        continue from 16; row ``i`` starts ``i`` later."""
        torch = self.torch

        i = torch.arange(s, device=self.dev)
        img = i < 256
        pos = torch.stack([torch.where(img, 0, i - 240), torch.where(img, i // 16, i - 240),
                           torch.where(img, i % 16, i - 240)])
        return (pos[:, None, :] + torch.arange(b, device=self.dev)[None, :, None]).long()

    def lm_embed_path(self, arch):
        """A model fed by a frontend's embeddings (qwen2-vl-2b, musicgen-
        medium) at full width and ``EMBED_LAYERS`` layers in bf16 (random
        weights and embeddings from seed 0): ``serve_embeddings`` of ``[8, 512, d]``
        prompts, then 32 steps on ``[8, 1, d]`` embeddings, K4 on every
        attention call, every step a replay of the captured step; held
        against the plain path along the same embeddings, against the
        teacher-forced forward and against an eager run (``capture=False``).
        qwen2-vl also takes one forward with distinct ``(t, h, w)`` triples
        against the plain path's."""
        torch = self.torch
        from repro_torch.launch.serve_lm import serve_embeddings
        from repro_torch.models import model as M

        cfg = self.cut_config(arch, EMBED_LAYERS[arch])
        tol = LM_LOGIT_TOL[arch]
        b, plen, steps = 8, 512, 32
        max_len = plen + steps + 1
        g = torch.Generator(device=self.dev).manual_seed(0)
        params = M.init(g, cfg)
        emb = torch.randn((b, plen + steps, cfg.d_model), generator=g,
                          device=self.dev).to(cfg.cdtype)
        first, rest = emb[:, :plen], emb[:, plen:]
        (logits, decode_s), _, launch = self.drive(
            f"lm {arch}", lambda: serve_embeddings(cfg, params, first, rest, max_len),
            b * steps)
        self.path_launches[f"lm {arch}"] = launch
        counted = self.lm_launches(f"lm {arch}", launch, {"flash_attention": cfg.n_layers},
                                   steps)
        if not bool(torch.isfinite(logits).all()) or logits.shape != (b, steps + 1, cfg.vocab):
            raise AssertionError(f"lm {arch}: non-finite logits or a wrong shape")
        eager_logits, eager_s = serve_embeddings(cfg, params, first, rest, max_len,
                                                 capture=False)
        eager = self.held_to_eager(f"lm {arch}", (None, logits), (None, eager_logits), tol)
        del eager_logits
        ref = self.teacher_forced(params, cfg, first, rest, max_len, attn_impl="ref")
        hidden, _, _ = M.forward(params, cfg, emb)
        fwd = M.logits_fn(params, cfg, hidden[:, plen - 1:])
        del hidden
        checks = self.routes_checked(f"lm {arch}", {
            "kernel_vs_plain": (logits, None, ref, None, None, 1.0),
            "decode_vs_forward": (logits, None, fwd, None, None, 1.0)}, 0, 0, plen, tol)
        del ref, fwd
        res = {"arch": cfg.name, **self.param_counts(params, cfg),
               "batch": b, "prompt": plen, "steps": steps, "checks": checks,
               "logit_tol": tol, "logit_std": float(logits.std()),
               "launches": counted, "captured_vs_eager": eager,
               "eager_decode_ms_per_step": eager_s / steps * 1e3}
        if cfg.mrope_sections is not None:
            pos = self.mrope_positions(b, plen)
            got = M.logits_fn(params, cfg, M.forward(params, cfg, first, positions=pos)[0][:, -32:])
            want = M.logits_fn(params, cfg, M.forward(params, cfg, first, positions=pos,
                                                      attn_impl="ref")[0][:, -32:])
            text = M.logits_fn(params, cfg, M.forward(params, cfg, first)[0][:, -32:])
            res["mrope_err"] = float((got - want).abs().max())
            res["mrope_vs_text_positions"] = float((got - text).abs().max())
            print(json.dumps({"lm_check": f"{arch} mrope", "logit_err": res["mrope_err"],
                              "tol": tol, "vs_text_positions": res["mrope_vs_text_positions"]}),
                  flush=True)
            if res["mrope_err"] > tol or res["mrope_vs_text_positions"] <= res["mrope_err"]:
                raise AssertionError(f"lm {arch}: M-RoPE forward off the plain path by "
                                     f"{res['mrope_err']} (tolerance {tol}), or text "
                                     "positions moved the logits less than that")
            del got, want, text
        res.update(decode_ms_per_step=decode_s / steps * 1e3, tok_per_s=b * steps / decode_s)
        res.update(self.lm_timings(params, cfg, first, rest[:, -1:], steps))
        del params
        torch.cuda.empty_cache()
        return res

    def pagerank_reference(self, data, iters, damping):
        """PageRank as the driver defines it, accumulated in float64; return
        the scores, each page's tolerance (see the module docstring) and the
        share of linked-to pages whose tolerance is below their smallest
        in-link's contribution."""
        torch = self.torch
        n = data["n_pages"]
        src, dst = data["edges"][:, 0].long(), data["edges"][:, 1].long()
        deg = data["deg"].double()
        inv = 1.0 / torch.clamp(deg, min=1.0)
        s = torch.full((n,), 1.0 / n, dtype=torch.float64, device=self.dev)
        for _ in range(iters):
            prev = s
            sink = s[deg == 0].sum()
            incoming = torch.zeros_like(s).index_add_(0, dst, s[src] * inv[src])
            s = (1.0 - damping) / n + damping * (incoming + sink / n)
        in_deg = torch.bincount(dst, minlength=n).double()
        tol = s * (1e-4 + iters * in_deg * F32_U)
        smallest = torch.full_like(s, float("inf")).scatter_reduce_(
            0, dst, damping * prev[src] * inv[src], reduce="amin")
        linked = in_deg > 0
        covered = float((tol[linked] < smallest[linked]).double().mean())
        return s, tol, covered

    def kmeans_reference(self, x, centers, iters):
        """k-means with the mapper's f32 distances and argmin, and per-centre
        sums accumulated in float64."""
        torch = self.torch
        k = centers.shape[0]
        c = centers.clone()
        ones = torch.ones((x.shape[0], 1), dtype=torch.float64, device=self.dev)
        for _ in range(iters):
            assign = torch.argmin(((c[None] - x[:, None, :]) ** 2).sum(-1), 1)
            sums = torch.zeros((k, x.shape[1] + 1), dtype=torch.float64,
                               device=self.dev)
            sums.index_add_(0, assign, torch.cat([x.double(), ones], 1))
            c = (sums[:, :-1] / sums[:, -1:].clamp(min=1.0)).float()
        d2 = ((c[None] - x[:, None, :]) ** 2).sum(-1).min(1).values
        return c.cpu().numpy(), float(d2.double().sum())

    # -- train phase ----------------------------------------------------------

    def grad_check(self, key, wrapper, kernel_route, plain_route, inputs, forward_ok,
                   flops, nbytes, library=None):
        """One kernel's gradient at a training shape: the kernel route's output
        (``kernel_route``, through ``kernels.ops``) must carry the autograd
        helper's ``grad_fn`` and agree with the plain route's (``plain_route``,
        the plain version under autograd) within the forward's bound
        (``forward_ok`` raises otherwise); from one upstream gradient, its
        gradients must equal the plain route's within ``2^-20`` of each
        gradient's largest magnitude (module docstring).  Records the launches
        the check made and the forward-plus-backward times of both routes and
        of ``library`` (the one PyTorch call computing the same function), with
        the bound of ``flops`` and ``nbytes`` (fwd + bwd) on the card."""
        torch = self.torch
        wants = [t for t in inputs if t is not None and t.requires_grad]
        before = wrapper.launches
        got = kernel_route(*inputs)
        y = got[0] if isinstance(got, tuple) else got
        if "_KernelGrad" not in type(y.grad_fn).__name__:
            raise AssertionError(f"{key}: the kernel route's output has grad_fn "
                                 f"{y.grad_fn!r}, not the autograd helper's")
        plain = plain_route(*inputs)
        yp = plain[0] if isinstance(plain, tuple) else plain
        fwd_err = forward_ok(y.detach(), yp.detach())
        g = torch.randn(yp.shape, generator=torch.Generator(device=self.dev).manual_seed(5),
                        device=self.dev).to(yp.dtype)
        got_grads = torch.autograd.grad(y, wants, g)
        want_grads = torch.autograd.grad(yp, wants, g)
        launches = wrapper.launches - before
        if launches != 1:
            raise AssertionError(f"{key}: the kernel route launched {launches} times")
        errs, bit_equal = [], True
        for a, b in zip(got_grads, want_grads):
            err = float((a.float() - b.float()).abs().max())
            if not bool(torch.isfinite(a).all()) or err > 2.0 ** -20 * float(
                    b.float().abs().max()):
                raise AssertionError(f"{key}: gradients off the plain route's by {err}")
            errs.append(err)
            bit_equal = bit_equal and torch.equal(a, b)
        del got, plain, y, yp, got_grads, want_grads

        def fwd_bwd(route):
            def run():
                out = route(*inputs)
                torch.autograd.grad(out[0] if isinstance(out, tuple) else out, wants, g)
            return run

        before = wrapper.launches
        ms = self.time_ms(fwd_bwd(kernel_route))
        timed_launches = wrapper.launches - before
        bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ops = flops / BF16_OPS_PER_S * 1e3
        self.record(key, kernel=wrapper.__name__, shape=[list(t.shape) for t in inputs
                                                         if t is not None],
                    forward_max_abs_err=fwd_err, grad_max_abs_err=errs,
                    grad_bit_equal=bit_equal, launches_in_check=launches + timed_launches,
                    ms=ms, plain_ms=self.time_ms(fwd_bwd(plain_route)),
                    library_ms=self.time_ms(fwd_bwd(library)) if library else None,
                    bound_ms=max(bound_bytes, bound_ops),
                    bound_by="bytes" if bound_bytes >= bound_ops else "operations",
                    flops=flops, bytes=nbytes)
        torch.cuda.empty_cache()

    def train_grad_checks(self):
        """The three kernels' gradients at one layer's full-width training
        shapes (``grad_check``), a micro-batch of 2 sequences of
        ``TRAIN_SEQ`` (4096) tokens: K4 at qwen3-0.6b's (q ``[2, 16, 4096,
        128]`` bf16 over k, v ``[2, 8, 4096, 128]``, causal, read through
        ``[B, S, H, D]`` views as the model passes them), K5 at zamba2-7b's
        (x ``[2, 4096, 112, 64]``, B and C ``[2, 4096, 2, 64]`` bf16 views of
        one conv output, from the zero state) and K6 at rwkv6-1.6b's (r, k, v
        ``[2, 4096, 32, 64]`` bf16); each forward is held to its bound
        against the plain version, each gradient to the plain route's."""
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.kernels import ops
        from repro_torch.kernels.flash_attention import flash_attention
        from repro_torch.kernels.ref import attention_ref
        from repro_torch.kernels.rwkv6_scan import rwkv6_scan, rwkv6_scan_plain
        from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain

        gen = torch.Generator(device=self.dev).manual_seed(4)
        bf16 = torch.bfloat16

        def randn(*shape, dtype=torch.float32, grad=True):
            t = torch.randn(shape, generator=gen, device=self.dev).to(dtype)
            return t.requires_grad_(grad)

        # K4: causal self-attention of one layer of one micro-batch
        b, s, hq, hkv, d = 2, TRAIN_SEQ, 16, 8, 128
        q = randn(b, s, hq, d, dtype=bf16).transpose(1, 2)
        k = randn(b, s, hkv, d, dtype=bf16).transpose(1, 2)
        v = randn(b, s, hkv, d, dtype=bf16).transpose(1, 2)
        n_keys = torch.arange(1, s + 1, device=self.dev, dtype=torch.float64)

        def attn_ok(got, want):
            tol = attention_tolerance(q.detach(), k.detach(), v.detach(), want,
                                      n_keys[None, None, :, None], causal=True, q_offset=0)
            err = (got.float() - want.float()).abs()
            if not bool((err <= tol).all()):
                raise AssertionError(f"K4 train forward off by {float(err.max())}")
            return float(err.max())

        pairs = b * hq * s * (s + 1) // 2  # live (query, key) pairs
        self.grad_check(
            "flash_attention@qwen3-train grad", flash_attention,
            lambda *t: ops.attention(*t, causal=True, impl="pallas"),
            lambda *t: attention_ref(*t, causal=True), (q, k, v), attn_ok,
            flops=3 * 4 * pairs * d,
            nbytes=(4 * q.numel() + 4 * k.numel()) * 2,
            library=lambda *t: F.scaled_dot_product_attention(*t, is_causal=True,
                                                              enable_gqa=True))
        del q, k, v
        # K5: the SSD scan of one zamba2 Mamba-2 layer of one micro-batch
        b, h, p, grp, n = 2, 112, 64, 2, 64
        conv = randn(b, s, h * p + 2 * grp * n, dtype=bf16)
        x = conv[..., :h * p].unflatten(-1, (h, p))
        bm = conv[..., h * p:h * p + grp * n].unflatten(-1, (grp, n))
        cm = conv[..., h * p + grp * n:].unflatten(-1, (grp, n))
        dt = F.softplus(randn(b, s, h, grad=False)).requires_grad_()
        a = (-torch.linspace(1.0, 16.0, h, device=self.dev)).requires_grad_()
        (ybound, _), _ = ssd_bound(x.detach(), dt.detach(), a.detach(), bm.detach(),
                                   cm.detach(), None, 128)

        def ssd_ok(got, want):
            err = (got.double() - want.double()).abs()
            if not bool((err <= 2.0 ** -7 * want.double().abs() + 2.1 * ybound).all()):
                raise AssertionError(f"K5 train forward off by {float(err.max())}")
            return float(err.max())

        self.grad_check(
            "ssd_scan@zamba2-train grad", ssd_scan,
            lambda *t: ops.ssd(*t, impl="pallas"),
            lambda *t: ssd_scan_plain(*t), (x, dt, a, bm, cm), ssd_ok,
            flops=3 * 4 * b * s * h * p * n,
            nbytes=2 * (conv.numel() * 2 + dt.numel() * 4) + 2 * x.numel() * 2)
        del conv, x, bm, cm, dt, a, ybound
        # K6: the wkv scan of one rwkv6 layer of one micro-batch
        b, h, kd = 2, 32, 64
        r, kk, vv = (randn(b, s, h, kd, dtype=bf16) for _ in range(3))
        w = torch.exp(-torch.exp(-6.0 + 0.6 * randn(b, s, h, kd, grad=False)))
        w.requires_grad_()
        u = (0.1 * randn(h, kd, grad=False)).requires_grad_()
        (rbound, _), _, _ = rwkv6_bound(r.detach(), kk.detach(), vv.detach(), w.detach(),
                                        u.detach(), torch.zeros((b, h, kd, kd),
                                                                device=self.dev))

        def rwkv6_ok(got, want):
            err = (got.double() - want.double()).abs()
            if not bool((err <= 2.0 ** -7 * want.double().abs() + 2.1 * rbound).all()):
                raise AssertionError(f"K6 train forward off by {float(err.max())}")
            return float(err.max())

        self.grad_check(
            "rwkv6_scan@rwkv6-train grad", rwkv6_scan,
            lambda *t: ops.rwkv6(*t, impl="pallas"),
            lambda *t: rwkv6_scan_plain(*t), (r, kk, vv, w, u), rwkv6_ok,
            flops=3 * 4 * b * s * h * kd * kd,
            nbytes=2 * (3 * r.numel() * 2 + w.numel() * 4) + 2 * vv.numel() * 2)
        del r, kk, vv, w, u, rbound
        torch.cuda.empty_cache()

    def busy_share(self, fn):
        """One call of ``fn`` under ``torch.profiler``: its wall time (host
        clock, synchronised), the card's busy time (the CUDA kernel and copy
        intervals, which one stream runs one at a time) and the eight kernels
        that took the most of it.  None where the profiler records no device
        activity."""
        torch = self.torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        self.sync()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            self.sync()
            wall = time.perf_counter() - t0
        by_name: dict[str, float] = {}
        for evt in prof.events():
            if evt.device_type == DeviceType.CUDA:
                ms = evt.time_range.elapsed_us() / 1e3
                by_name[evt.name] = by_name.get(evt.name, 0.0) + ms
        if not by_name:
            return None
        busy = sum(by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        return {"wall_ms": wall * 1e3, "busy_ms": busy, "busy_share": busy / (wall * 1e3),
                "top_kernels_ms": {name[:80]: ms for name, ms in top}}

    def train_twins(self, cfg, params, pipe, accum):
        """The training step from ``params`` over the pipeline's first
        ``TRAIN_TWIN_STEPS`` batches three ways: the eager twin
        (``TrainGraph(capture=False)``) twice, then captured (the warm-up,
        the capture, replays).  The captured run's losses, parameters,
        moments and step must equal the first eager run's bit for bit, or
        lie no further from them than the second's do.  Each step's host ms
        (the batch copied in, the step, the loss read on the host), and one
        eager step and one replay under the profiler."""
        torch = self.torch
        from repro_torch.models import model as M
        from repro_torch.optim.adamw import AdamW, warmup_cosine
        from repro_torch.runtime.train_loop import TrainGraph, make_train_step

        batches = [pipe.device_batch(i, self.dev) for i in range(TRAIN_TWIN_STEPS)]

        def run(capture):
            opt = AdamW(lr=warmup_cosine(3e-4, 1, TRAIN_STEPS))
            p = M.map_tree(lambda t: t.detach().clone(), params)
            state = opt.init(p)
            graph = TrainGraph(make_train_step(cfg, opt, grad_accum=accum, device=self.dev),
                               p, state, batches[0], capture=capture, name=cfg.name)
            losses, ms = [], []
            for b in batches:
                self.sync()
                t0 = time.perf_counter()
                losses.append(float(graph.step(b)))
                ms.append((time.perf_counter() - t0) * 1e3)
            bits = (M.distinct_leaves(p) + M.distinct_leaves(state["m"])
                    + M.distinct_leaves(state["v"]) + [state["step"]])
            return losses, ms, bits, graph

        @torch.no_grad()
        def diff(a, b):
            if a[0] == b[0] and all(torch.equal(x, y) for x, y in zip(a[2], b[2])):
                return 0.0
            return max([abs(x - y) for x, y in zip(a[0], b[0])]
                       + [float((x.float() - y.float()).abs().max())
                          for x, y in zip(a[2], b[2])])

        capture = self.dev.type == "cuda"
        eager = run(False)
        again = run(False)
        eager_vs_eager = diff(eager, again)
        del again
        torch.cuda.empty_cache()
        got = run(capture)
        captured_vs_eager = diff(got, eager)
        out = {"steps": TRAIN_TWIN_STEPS, "captured_vs_eager": captured_vs_eager,
               "eager_vs_eager": eager_vs_eager, "bit_equal": captured_vs_eager == 0.0,
               "eager_losses": eager[0], "captured_losses": got[0],
               "eager_step_ms": eager[1], "captured_step_ms": got[1],
               "replays": got[3].replays, "captured_launches": got[3].captured_launches}
        print(json.dumps({"train_twins": out}), flush=True)
        if not captured_vs_eager <= eager_vs_eager:
            raise AssertionError(f"train: the captured step is {captured_vs_eager} off the "
                                 f"eager twin's, which is {eager_vs_eager} off itself")
        if capture and (got[3].replays != TRAIN_TWIN_STEPS - 1
                        or not got[3].captured_launches):
            raise AssertionError(f"train twins: {got[3].replays} replays, captured launches "
                                 f"{got[3].captured_launches}")
        # One eager step and one replay of the same job under the profiler:
        # the card's busy share and where its time goes.
        out["profiled_step"] = self.busy_share(lambda: eager[3].step(batches[0]))
        out["profiled_replay"] = self.busy_share(lambda: got[3].step(batches[0]))
        del eager, got, batches
        torch.cuda.empty_cache()
        return out

    def train_phase(self):
        """LM training on the card (module docstring): the kernels' gradient
        checks, K4's forward at the training shape, then qwen3-0.6b at full
        width and depth through ``repro_torch.runtime.train_loop.train`` (8
        steps of 4 × 4096 tokens in 2 micro-batches, remat, AdamW with
        ``warmup_cosine(3e-4, 1, 8)``, a checkpoint at the end; the step
        captured once and replayed), its eager and captured twins
        (:meth:`train_twins`), and a crash at step 6 resumed from the
        step-4 checkpoint through a new capture."""
        import shutil
        import tempfile

        torch = self.torch
        from repro_torch.configs.base import get_arch
        from repro_torch.data.pipeline import TokenPipeline
        from repro_torch.models import model as M
        from repro_torch.optim.adamw import AdamW, warmup_cosine
        from repro_torch.runtime.train_loop import train

        t_phase = time.perf_counter()
        self.train_grad_checks()
        gen = torch.Generator(device=self.dev).manual_seed(6)
        mb = TRAIN_BATCH // TRAIN_ACCUM
        q = torch.randn((mb, TRAIN_SEQ, 16, 128), generator=gen, device=self.dev).to(
            torch.bfloat16).transpose(1, 2)
        k, v = (torch.randn((mb, TRAIN_SEQ, 8, 128), generator=gen, device=self.dev).to(
            torch.bfloat16).transpose(1, 2) for _ in range(2))
        self.kernel_attention("flash_attention@qwen3-train", q, k, v, q_offset=0)
        del q, k, v
        torch.cuda.empty_cache()

        cfg = get_arch("qwen3-0.6b")
        batch, seq, accum, steps = TRAIN_BATCH, TRAIN_SEQ, TRAIN_ACCUM, TRAIN_STEPS
        pipe = TokenPipeline(cfg, batch=batch, seq_len=seq)
        params = M.init(torch.Generator(device=self.dev).manual_seed(0), cfg)
        # The first step's loss on the plain path (attention_ref) from the
        # same parameters and batch, micro-batch by micro-batch as the step.
        first = pipe.device_batch(0, self.dev)
        mb = batch // accum
        with torch.no_grad():
            ref_loss = sum(float(M.loss_fn(params, cfg, first["inputs"][i * mb:(i + 1) * mb],
                                           first["labels"][i * mb:(i + 1) * mb],
                                           attn_impl="ref"))
                           for i in range(accum)) / accum
        del first
        torch.cuda.empty_cache()
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()[0]
        results = {"card": card, "arch": cfg.name, "params": M.param_count(params),
                   "batch": batch, "seq": seq, "grad_accum": accum, "steps": steps}
        tmp = tempfile.mkdtemp(prefix="blaze_train_")
        try:
            torch.cuda.reset_peak_memory_stats()
            self.sync()
            self.zero_launch_counts()
            t0 = time.perf_counter()
            res = train(cfg, steps=steps, batch=batch, seq_len=seq, pipeline=pipe,
                        ckpt_dir=os.path.join(tmp, "run"), ckpt_every=steps,
                        optimizer=AdamW(lr=warmup_cosine(3e-4, 1, steps)),
                        grad_accum=accum, params=params, jit=True, device=self.dev)
            self.sync()
            wall = time.perf_counter() - t0
            launch = self.read_launch_counts()
            self.path_launches["train qwen3-0.6b"] = launch
            peak = torch.cuda.max_memory_allocated()
            peak_reserved = torch.cuda.max_memory_reserved()
            n_layers = len(M.layer_kinds(cfg))
            want = n_layers * accum * 2 * steps  # forward + remat recompute
            ran = ran_launches(launch, "flash_attention")
            ran_forms = {f: ran_launches(launch, f"flash_attention/{f}")
                         for f in launch["flash_attention forms"]}
            if ran != want or ran_forms != {"f32": 0, "bf16-prefill": want, "bf16-decode": 0}:
                raise AssertionError(f"train: K4 launched {ran} times ({ran_forms}; "
                                     f"{launch['train_graph']}), not {want} in the bf16 "
                                     "prefill form")
            graphed = self.dev.type == "cuda"
            if (res.captures, res.replays) != ((1, steps - 1) if graphed else (0, 0)):
                raise AssertionError(f"train: {res.captures} captures and {res.replays} "
                                     f"replays in {steps} steps")
            losses = res.losses
            if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
                raise AssertionError(f"train: losses {losses} not finite and falling")
            loss_err = abs(losses[0] - ref_loss)
            if loss_err > TRAIN_LOSS_RTOL * abs(ref_loss):
                raise AssertionError(f"train: first loss {losses[0]} off the plain path's "
                                     f"{ref_loss} by more than {TRAIN_LOSS_RTOL} relative")
            step_s = statistics.median(res.step_times[1:])
            tokens = batch * seq
            hd, nh = cfg.d_head, cfg.n_heads
            attn_flops = 3 * 4 * batch * nh * (seq * (seq + 1) // 2) * hd * n_layers
            model_flops = 6 * M.param_count(params) * tokens + attn_flops
            results.update(
                losses=losses, first_loss_plain_path=ref_loss, first_loss_err=loss_err,
                first_loss_rtol=TRAIN_LOSS_RTOL, wall_s=wall, step_s=res.step_times,
                median_step_ms=step_s * 1e3, tokens_per_s=tokens / step_s,
                model_flops_per_step=model_flops,
                train_mfu=model_flops / step_s / BF16_OPS_PER_S,
                peak_memory_bytes=peak, peak_reserved_bytes=peak_reserved,
                checkpoints=res.checkpoints, captures=res.captures, replays=res.replays,
                capture_s=res.capture_s, k4_launches=ran,
                k4_launches_by={"wrappers": launch["flash_attention"],
                                "train_graph": launch["train_graph"]},
                expected_k4_launches=want)
            print(json.dumps({"train_run": {k: results[k] for k in (
                "losses", "median_step_ms", "tokens_per_s", "train_mfu", "capture_s",
                "peak_memory_bytes", "peak_reserved_bytes", "checkpoints")}}), flush=True)
            shutil.rmtree(os.path.join(tmp, "run"))
            torch.cuda.empty_cache()
            # The same step eager twice and captured, from the same state:
            # bits, step ms, and an eager step's and a replay's busy share.
            twins = self.train_twins(cfg, params, pipe, accum)
            results["twins"] = twins
            results["profiled_step"] = twins.pop("profiled_step")
            results["profiled_replay"] = twins.pop("profiled_replay")
            twins["train_run_vs_captured_twin"] = max(
                abs(a - b) for a, b in zip(losses, twins["captured_losses"]))

            # A crash at step 6, resumed from the step-4 checkpoint.
            ckpt = res.checkpoints[-1]["bytes"]
            free = shutil.disk_usage(tmp).free
            results["disk_free_before_restart"] = free
            if free < 2.5 * ckpt:
                raise AssertionError(f"train restart: {free} bytes free in {tmp}, the two "
                                     f"checkpoints of {ckpt} bytes need {2 * ckpt}")
            t0 = time.perf_counter()
            crash = train(cfg, steps=steps, batch=batch, seq_len=seq, pipeline=pipe,
                          ckpt_dir=os.path.join(tmp, "crash"), ckpt_every=4,
                          crash_at_step=6, optimizer=AdamW(lr=warmup_cosine(3e-4, 1, steps)),
                          grad_accum=accum, jit=True, device=self.dev)
            results["restart"] = {
                "wall_s": time.perf_counter() - t0, "restarts": crash.restarts,
                "final_step": crash.final_step, "steps_run": crash.steps_run,
                "captures": crash.captures, "replays": crash.replays,
                "capture_s": crash.capture_s, "checkpoints": crash.checkpoints,
                "final_loss_vs_uninterrupted": crash.losses[-1] - losses[-1]}
            # steps 0-5 (step 0 the warm-up), then 4-7 from the step-4
            # checkpoint (step 4 the warm-up)
            if (crash.restarts, crash.final_step, crash.steps_run) != (1, 8, 10) or (
                    (crash.captures, crash.replays) != ((2, 8) if graphed else (0, 0))):
                raise AssertionError(f"train restart: {results['restart']}")
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        del params
        torch.cuda.empty_cache()
        results["train_s"] = time.perf_counter() - t_phase
        return results

    # -- data ---------------------------------------------------------------

    def make_data(self):
        torch = self.torch
        import numpy as np
        from repro_torch.data.synthetic import cluster_points, rmat_edges, zipf_corpus

        t0 = time.perf_counter()
        dev = self.dev
        data = {}
        # wordcount: 2^27 tokens in 64-token lines, vocab 2^19
        lines, _ = zipf_corpus(1 << 21, 64, 1 << 19, seed=0)
        data.update(lines_np=lines, vocab=1 << 19,
                    tokens=torch.from_numpy(lines).to(dev))
        # PageRank: R-MAT scale 20, 16 edges per node
        edges = rmat_edges(20, 16, seed=0)
        data.update(edges_np=edges, n_pages=1 << 20,
                    edges=torch.from_numpy(edges).to(dev),
                    deg=torch.from_numpy(np.bincount(edges[:, 0], minlength=1 << 20)
                                         .astype(np.int32)).to(dev))
        # k-means: 10^8 points, dim 3, k 5
        pts, _ = cluster_points(100_000_000, 3, 5, seed=0)
        init = pts[np.random.RandomState(0).choice(4096, 5, replace=False)]
        data.update(points_np=pts, points=torch.from_numpy(pts).to(dev),
                    init_centers=torch.from_numpy(init).to(dev))
        # GMM: 10^7 points, dim 3, 5 components (fig. 7's shape)
        gpts, _ = cluster_points(10_000_000, 3, 5, seed=1)
        data.update(gmm_points_np=gpts, gmm_points=torch.from_numpy(gpts).to(dev),
                    gmm_k=5)
        # kNN: 10^8 points, dim 4, 3 clusters, 100 neighbours of the origin
        kpts, _ = cluster_points(100_000_000, 4, 3, seed=2)
        data.update(knn_points_np=kpts, knn_points=torch.from_numpy(kpts).to(dev))
        data["pi_samples"] = 1 << 30
        self.sync()
        print(json.dumps({"data_s": time.perf_counter() - t0}), flush=True)
        return data

    # -- the run ------------------------------------------------------------

    def tensor_core_sass(self):
        """Count the tensor-core instructions (``HGMMA`` for ``wgmma``,
        ``HMMA`` for ``mma.sync``) in the machine code (``cuobjdump -sass``)
        of the built K4 and K5 libraries; fail if K4's has none (K5's count
        is printed only)."""
        from repro_torch.kernels import _build

        cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
        counts = {}
        for name in ("flash_attention", "ssd_scan"):
            sass = subprocess.run([str(cuobjdump), "-sass", str(_build.library_path(name))],
                                  capture_output=True, text=True, check=True).stdout
            ops = re.findall(r"\b(HGMMA|HMMA)\.", sass)
            counts[name] = {op: ops.count(op) for op in ("HGMMA", "HMMA")}
        print(json.dumps({"tensor_core_sass": counts}), flush=True)
        if not sum(counts["flash_attention"].values()):
            raise AssertionError("K4's library holds no tensor-core instruction")

    def track_sessions(self):
        """Record every ``BlazeSession`` a phase makes (its stats), for
        ``check_supervision``; disarm any ambient fault rule."""
        from repro_torch.core import faults
        from repro_torch.core import session as session_mod

        faults.reset(env=False)
        init = session_mod.BlazeSession.__init__

        def tracked(sess, *args, **kwargs):
            init(sess, *args, **kwargs)
            self.session_stats.append((self.phase, sess.stats))

        session_mod.BlazeSession.__init__ = tracked

    def run(self):
        torch = self.torch
        from repro_torch.kernels import _build

        self.track_sessions()
        t0 = time.perf_counter()
        _build.build(["segment_reduce", "hash_combine", "kmeans_assign",
                      "flash_attention", "flash_attention_dh", "ssd_scan", "rwkv6_scan"])
        print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)

        def done(part):  # where the run's seconds go, part by part
            print(json.dumps({"done": part, "elapsed_s": time.perf_counter() - START}),
                  flush=True)

        self.tensor_core_sass()
        self.attention_phase()
        done("attention")
        self.dh_phase()
        done("dh")
        self.scan_phase()
        done("scan")
        for arch in LM_ARCHS:  # each model is freed before the next phase
            print(json.dumps({"lm_results": self.lm_path(arch)}), flush=True)
            torch.cuda.empty_cache()
            done(f"lm {arch}")
        for arch in MOE_LAYERS:
            print(json.dumps({"lm_results": self.lm_moe_path(arch)}), flush=True)
            done(f"lm {arch}")
        for arch in EMBED_ARCHS:
            print(json.dumps({"lm_results": self.lm_embed_path(arch)}), flush=True)
            done(f"lm {arch}")
        self.phase = "train"
        print(json.dumps({"train_results": self.train_phase()}), flush=True)
        done("train")
        data = self.make_data()
        done("data")
        for name in ("kernel", "path", "program", "tuning", "stream", "wire", "multinode"):
            self.phase = name
            getattr(self, f"{name}_phase")(data)
            done(name)
        self.phase = "fault"
        fault_results = self.fault_phase(data)
        done("fault")
        self.phase = "serve"
        self.serve_phase(data)
        done("serve")
        self.phase = "examples"
        self.examples_phase()
        done("examples")
        self.phase = "process"
        self.process_phase(data)
        done("process")
        self.phase = "shard"
        self.shard_phase()
        done("shard")
        fault_results["other_phases"] = self.check_supervision()
        print(json.dumps({"faults": fault_results}), flush=True)
        kernels = []
        sources = {
            "segment_reduce": ("src/repro_torch/kernels/csrc/segment_reduce.cu",
                               "src/repro/kernels/segment_reduce.py:164"),
            "hash_aggregate": ("src/repro_torch/kernels/csrc/hash_combine.cu",
                               "src/repro/kernels/hash_combine.py:194"),
            "kmeans_assign": ("src/repro_torch/kernels/csrc/kmeans_assign.cu",
                              "src/repro/kernels/kmeans_assign.py:54"),
            "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                                "src/repro/kernels/flash_attention.py:100"),
            "dh_logits": ("src/repro_torch/kernels/csrc/flash_attention_dh.cu",
                          "src/repro/kernels/flash_attention.py:135"),
            "dh_softmax_pv": ("src/repro_torch/kernels/csrc/flash_attention_dh.cu",
                              "src/repro/kernels/flash_attention.py:135"),
            "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                         "src/repro/kernels/ssd_scan.py:74"),
            "rwkv6_scan": ("src/repro_torch/kernels/csrc/rwkv6_scan.cu",
                           "src/repro/kernels/rwkv6_scan.py:73"),
        }
        programs = {"segment_reduce@kmeans": "kmeans", "segment_reduce@pagerank": "pagerank",
                    "segment_reduce@gmm": "gmm",
                    "hash_aggregate@wordcount-combine": "wordcount",
                    "hash_aggregate@wordcount-merge": "wordcount",
                    "kmeans_assign@fig6": "kmeans fig6"}
        runs = {"segment_reduce@kmeans": "kmeans",
                "segment_reduce@pagerank": "pagerank",
                "segment_reduce@gmm": "gmm",
                "hash_aggregate@wordcount-combine": "wordcount",
                "hash_aggregate@wordcount-merge": "wordcount",
                "kmeans_assign@fig6": "kmeans fig6",
                "flash_attention@qwen3-prefill": "lm qwen3-0.6b",
                "flash_attention@qwen3-decode": "lm qwen3-0.6b",
                "flash_attention@qwen3-decode-at": "lm qwen3-0.6b",
                "flash_attention@gemma2-local f32": "lm gemma2-9b",
                "flash_attention@gemma2-local bf16": "lm gemma2-9b",
                "flash_attention@gemma2-local-decode bf16": "lm gemma2-9b",
                "flash_attention@gemma2-local-decode-at bf16": "lm gemma2-9b",
                "flash_attention@qwen3-train": "train qwen3-0.6b",
                "flash_attention@zamba2-prefill": "lm zamba2-7b",
                "flash_attention@zamba2-decode": "lm zamba2-7b",
                "flash_attention@zamba2-decode-at": "lm zamba2-7b",
                "ssd_scan@zamba2-prefill": "lm zamba2-7b",
                "ssd_scan@zamba2-decode": "lm zamba2-7b",
                "rwkv6_scan@rwkv6-prefill": "lm rwkv6-1.6b",
                "rwkv6_scan@rwkv6-decode": "lm rwkv6-1.6b",
                "flash_attention@mixtral-prefill": "lm mixtral-8x22b",
                "flash_attention@mixtral-decode": "lm mixtral-8x22b",
                "flash_attention@mixtral-window-prefill": "lm mixtral window",
                "flash_attention@mixtral-window-decode": "lm mixtral window",
                "flash_attention@mixtral-window-decode-at": "lm mixtral window",
                "flash_attention@grok-prefill": "lm grok-1-314b",
                "flash_attention@grok-decode": "lm grok-1-314b",
                "flash_attention@qwen2vl-prefill": "lm qwen2-vl-2b",
                "flash_attention@qwen2vl-decode": "lm qwen2-vl-2b",
                "flash_attention@musicgen-prefill": "lm musicgen-medium",
                "flash_attention@musicgen-decode": "lm musicgen-medium",
                **{f"flash_attention@{model}-{shape}": f"lm {arch}"
                   for model, arch in (("stablelm", "stablelm-3b"),
                                       ("starcoder2", "starcoder2-15b"),
                                       ("gemma2", "gemma2-9b"))
                   for shape in ("prefill", "decode", "decode-at")},
                **{f"flash_attention@gemma2-window-{shape}": "lm gemma2 window"
                   for shape in ("prefill", "global-prefill", "decode", "decode-at",
                                 "global-decode-at")},
                "flash_attention@train_lm f32": "example train_lm",
                # the "dh" form's main path: rank 0's gemma2-9b decode step
                **{f"{kernel}@{shape}": "shard rank0 gemma2-9b decode_32k"
                   for kernel in ("dh_logits", "dh_softmax_pv")
                   for shape in ("gemma2-global", "gemma2-local", "qwen3", "musicgen")}}
        for key, path in runs.items():
            rec = self.summary[key]
            source, replaces = sources[rec["kernel"]]
            busy = rec.get("device_ms")  # K2 records it per kernel
            # an LM path's launches: the wrappers' (its prefill, its decode
            # step's warm-up and capture) plus its decode graph's replays'
            # (a train path: what ran, ran_launches)
            counts = self.path_launches[path]
            replayed = counts.get("decode_graph", {}).get("replay_launches", {})
            trained = counts.get("train_graph", {})
            path_forms = counts.get(f"{rec['kernel']} forms")
            if path_forms:
                path_forms = {f: ran_launches(counts, f"{rec['kernel']}/{f}")
                              for f in path_forms}
            kernels.append({
                "name": key, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": ran_launches(counts, rec["kernel"]),
                **({"launches_by": {"wrappers": counts[rec["kernel"]],
                                    "decode_graph_replays": replayed[rec["kernel"]]}}
                   if rec["kernel"] in replayed else {}),
                **({"launches_by": {
                    "wrappers": counts[rec["kernel"]],
                    "train_capture_recorded": trained["capture_launches"][rec["kernel"]],
                    "train_graph_replays": trained["replay_launches"][rec["kernel"]]}}
                   if rec["kernel"] in trained.get("replay_launches", {}) else {}),
                "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
                "device_ms": busy["total"] if isinstance(busy, dict) else busy,
                **({"device_ms_by": rec["device_ms_by"]} if "device_ms_by" in rec else {}),
                "shape": rec["shape"], **({"form": rec["form"]} if "form" in rec else {}),
                **({"checked_forms": checked} if (checked := sorted({
                    r["form"] for r in self.summary.values()
                    if r.get("kernel") == rec["kernel"] and "form" in r})) else {}),
                **({"path_forms": path_forms} if path_forms else {}),
                "candidates_checked": self.candidates_checked.get(key),
                # a shape that no path of the smoke runs: `launches` is its
                # kernel's count on the path named, at that path's shapes
                **({"launches_note": f"{path} at its own shapes; this shape is a check only"}
                   if key in CHECK_ONLY_SHAPES else {}),
                # the program, tuning and stream phases' launches (graph
                # replays), by form too
                "program_launches": {k: n for k, n in self.program_launches.get(
                    programs.get(key), {}).items()
                    if k.split("/")[0] == rec["kernel"]} or None,
                # the fault phase's launches of the kernel (its graph replays
                # included), on every path of that phase together
                "fault_launches": self.fault_launches.get(rec["kernel"]),
                # the multinode phase's, by topology: the wrappers' and the
                # graph replays'
                "multinode_launches": self.multinode_launches.get(rec["kernel"]),
                # the process phase's (an NCCL group of one, the (1x8) mesh
                # across processes): the wrappers' and the graph replays'
                "process_launches": self.process_launches.get(rec["kernel"]),
                # its streams on the process mesh (K1, K2): the wrappers' and
                # the graph replays'
                "process_stream_launches": self.process_stream_launches.get(rec["kernel"]),
                # the shard phase's: (a) train, train's resume (Smoke.shard_resume)
                # and serve on the (1x1) mesh, (b) rank 0 of the production
                # mesh's cells (K4 and its "dh" form only counted there)
                "shard_launches": {
                    "train": self.shard_launches["train"][rec["kernel"]],
                    "serve": self.shard_launches["serve"][rec["kernel"]],
                    "resume": {k: v[rec["kernel"]]
                               for k, v in self.shard_launches["resume"].items()},
                    "rank0": ({cell: n[rec["kernel"]]
                               for cell, n in self.shard_launches["rank0"].items()}
                              if rec["kernel"] in RANK0_COUNTED else None)},
                # the examples phase's: each example's main([]) on the card,
                # its graphs' replays counted (ran_launches)
                "examples_launches": {name: ran_launches(n, rec["kernel"]) for name, n in
                                      self.example_launches.items() if n[rec["kernel"]]},
                # the process phase's dp_train (K4 only), per wire
                "dp_train_launches": (self.dp_train_launches
                                      if rec["kernel"] == "flash_attention" else None),
                # the serve phase's: the wrappers' (discovery, warm-up,
                # capture) and its graph replays', by form too
                "serve_launches": {
                    "wrappers": self.serve_launches[rec["kernel"]],
                    "graph_replays": {k: n for k, n in
                                      self.serve_launches["graph_replays"].items()
                                      if k.split("/")[0] == rec["kernel"]}},
            })
        print(json.dumps({"kernels": kernels}), flush=True)
        print(json.dumps({"total_s": time.perf_counter() - START}), flush=True)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        )
        print(smi.stdout.strip().splitlines()[0], flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
