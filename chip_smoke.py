"""Drive the PyTorch/CUDA port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py
    python3 chip_smoke.py --delay-line   # phase 3f(a) alone
    python3 chip_smoke.py --tune         # phase 3g alone
    python3 chip_smoke.py --fleet        # phase 3h alone
    python3 chip_smoke.py --sharded      # phase 3i alone
    python3 chip_smoke.py --train        # phase 5b alone
    python3 chip_smoke.py --moe          # phase 5c alone
    python3 chip_smoke.py --mla          # phase 5d alone
    python3 chip_smoke.py --recurrent    # phase 5e alone
    python3 chip_smoke.py --encdec       # phase 5f alone
    python3 chip_smoke.py --dryrun       # phase 5g alone
    python3 chip_smoke.py --tp           # phase 5h alone

Run from the root of a checkout, on a machine with a CUDA card, nvcc and
PyTorch built for CUDA. Phases, each of which raises (and so exits non-zero)
on failure:

1. Build the CUDA kernels from src/repro_torch/kernels/csrc (nvcc) and print
   the build time and the card (name and power limit from nvidia-smi).
2. Hold each kernel against its plain PyTorch version on the card at the
   shapes the serving path gives it (N=2500 padded to 2560, E=256,
   hold_steps=5, K=8, W from make_coupling_matrix(2500, seed=0)): rk4_chunk
   with lanes frozen, retired and admitted mid-chunk (and again with a bf16
   W), rk4_fused with n_inner=5, field_tiled at c = 0, dt/2 and dt with an
   f32 and a bf16 W, and again at the paper's largest N = 10^4 (padded to
   10048; W made on the card from a torch.Generator, zero diagonal, scaled
   like make_coupling_matrix), and one rk4_tiled_step (four field_tiled
   launches with the stage algebra in their epilogue) at N = 2500 for each
   W. Prints each kernel's error, its time, the plain version's time, one
   torch.matmul over the same coupling products (a yardstick only) and the
   bound, the share of the bound, the time over the library's, the launch
   configuration of the work split (blocks, cluster size = contraction
   slices, tile rows, rounds or waves) and ptxas's registers, stack and
   spills for the kernel, read from the build log; for rk4_tiled_step its
   time beside four field_tiled launches; rk4_chunk and rk4_fused also on
   the card's time (queued_ms, below) as card_ms; round_bf16_kernel (the bf16
   operand of a bf16-W stage) bit-equal to torch's cast. The field_tiled,
   rk4_tiled_step and round_bf16 rows (and their plain and library calls)
   are timed with the calls queued back to back behind a device-side sleep
   that must outlast the host's queuing, the card's time without the
   host's between launches (queued_ms), and per call too (single_call_ms);
   the others per call with CUDA events (time_ms). Each STO row is held a
   second time on the coupling's share of the result alone, f(W) - f(0),
   and a plain version with a fault planted in the product (none of it;
   one contraction slice of the split dropped or summed twice) must fail
   that measure (and, for rk4_chunk, the row's atol).
3. Serve 512 NARMA-10 sessions (16-40 ticks, per-tenant params on some
   lanes, a readout on every session) through ReservoirEngine with
   backend chunk, fused and tiled, and tiled again with a bf16 coupling
   (precision="bf16_coupling", which launches round_bf16), launch counters
   set to 0 before each run and read after it; check every result is
   finite, and the chunk and the tiled runs against interpret=True runs (the
   plain versions) of the same engine. Prints what impl="auto" resolves to
   at N = 2500, E = 256.
3b. Online learning on the same 512 sessions, each now with its NARMA-10
   targets (its readout warm-starts the learned weights, LEARN_WASHOUT
   ticks before the first update): engines with backend chunk and
   learn="rls" (launches rk4_chunk), tiled and learn="lms" (field_tiled) and
   scan and learn="rls" (the exact oracle: no STO kernel), counters set to 0
   before each run. Every session returns a finite learned readout and
   online NMSE; its learned W must be bit-equal to a replay of its
   harvested states through rls_chunk / lms_chunk at the engine's width
   (E = 256, the session in its own lane, blocks aligned to its admission,
   the other lanes masked) and within ORACLE_RTOL of fit_rls / fit_lms at
   E = 1; the scan run's states within STATE_ATOL of the chunk run's.
   Prints each run's sessions/s and peak device memory, and the learn
   tail's time per chunk (CUDA events) beside the chunk's, with a profiler
   table of the tail's device kernels.
   Then the host trace of one chunk and one tiled engine run (a second
   call after the timed one): spans wrapped around the engine's boundary
   methods, its CompiledSim's tick_chunk, the readout and the host copies,
   in this script only. It prints each span's exclusive ms a chunk without
   the profiler, then, under torch.profiler, the device's busy share and the
   top host operations of each span by self CPU time.
3c. The paper's ladder: ms per RK4 step of integrate_python_loop,
   integrate_scan and the fused kernel (CompiledSim.integrate, impl="fused",
   E = 1) at N = 1, 100, 1000, 2500 and 10^4 (W from a torch.Generator), on
   the card and on the host CPU (device="cpu", the kernel's plain version).
3d. The engine's lifecycle at N = 2500, E = 256, K = 8, each check with
   its max difference, the contract that held (bit-equal or within
   tolerance), its time and its kernel launches: (1) a step() loop against
   run(chunk_ticks=1) on chunk and tiled, 64 sessions, step() launching its
   kernel; (2) 32 push streams (open=True) fed their second half through
   append_ticks at a later boundary, then close_session, against each
   served in one piece, an all-idle boundary launching nothing; (3) 4 of 16
   RLS learners behind chunk checkpointed after two chunks and restored into
   a second engine of the same width, and snapshot_sessions after every
   chunk of a live engine (bit-equal required), against an uninterrupted
   run (states within STATE_ATOL, W and predictions within ORACLE_RTOL of
   their max); (4) autoscale=True between 64 and 256 slots (backend auto)
   under a burst of 512 sessions and a lull of 8 more one chunk apart: grows
   and shrinks, the impl at each width, cold rescales and their stall, peak
   memory, every session within STATE_ATOL of a fixed E = 256 run; again
   with learn="rls" (8 learned W within ORACLE_RTOL of fit_rls at E = 1);
   (5) the launcher, `repro_torch.launch.serve --mode reservoir` at N = 2500,
   256 slots, 512 sessions of 40 ticks, with and without --learn rls. The
   autoscaling engines run with the plan cache's prewarm thread (the
   default), and a cold rescale's stall now includes the new width's warmup
   chunk.
3e. The plan cache and the persisted dispatch table at the same shapes:
   (a) compile_plan(aot=True) for chunk, fused and tiled (f32) and tiled
   (bf16_coupling): its time, and no launch; (b) two child processes
   (`chip_smoke.py --cache-child DIR`) with compilation_cache_dir set to one
   fresh directory: the first builds the kernel library there with nvcc,
   the second only loads it (BUILD_LOG None); each prints its build/load
   time and, on a fresh process, the first three warmup chunks of tiled
   (after aot) and of fused (without); (c) two engines over one spec and
   plan share one CompiledSim, PLAN_CACHE's CacheStats, and the structural
   hash's time on the card's spec, first and memoized; (d) 3d.4's
   autoscale run from an empty cache with prewarm=True and with
   prewarm=False (bit-equal to each other; against the fixed E = 256 run as
   3d.4 holds it), then warm-started from 128 slots after prewarm(block=
   True) (both rescales warm): per run the cold and warm rescales, their
   stall (with the allocator segments and gc pauses of the call that
   rescaled), the warmup chunks' time, per rescale the first chunk's launch
   (host ms) and device ms (CUDA events) at the new width beside the
   medians of the later chunks there, peak memory, prewarm_errors empty;
   (e) PLAN_CACHE.measure at N = 2500, E = 256, f32 and bf16_coupling
   (per-impl ms; a second call hits the memo), save_table to a temporary
   file, clear the table, load_table: choose_impl returns each measured
   winner and an auto engine launches the winner's kernel; the table is
   cleared again for the later phases.
3f. The physics families at the same shapes (time_multiplexed:
   make_time_multiplexed_spec(2500, hold_steps=5); array_transient:
   readout_window 3, the reference smoke's): (a) tm_delay_line against its
   plain version, bit-equal required: one K = 2 chunk at N = 256 through
   tm_chunk against tm_chunk_planes on the card (lanes frozen), one tick at
   N = 2500 against the plain version on the card (every lane) and on the
   host CPU (lanes 0-7), lanes 0-63 masked; its division bit-equal to
   __fdiv_rn over the lanes' numerators x every f32 denominator in
   [2^-32, 2] (sto_step.tm_quotient_sweep); its time per call and on the
   card, the plain version's, the roofline bound and the chain bound: the
   step loop's dependency chain recounted from its SASS
   (tools/sto_sass_mix.py delay_line_chain: FADD, FMUL and the division as
   compiled, MUFU.RCP and its FFMAs) priced at the latencies of those ops
   measured on the card by sto_step.tm_latencies (one warp, clock64) and
   at the SM clock measured beside them (null where the toolkit has no
   cuobjdump); (b) the 512 sessions through each engine of FAMILY_RUNS
   (time_multiplexed chunk with an f32 and a bf16 feedback W;
   array_transient fused, tiled, tiled with a bf16 W, chunk), each
   launching exactly its impl's kernels: sessions/s, a chunk's CUDA-event
   ms and the device's busy share, for time_multiplexed the chunk's
   feedback products and kernel launches apart; array_transient fused and
   tiled against their interpret=True runs (STATE_ATOL), time_multiplexed
   chunk against its interpret=True run at N = 256 (bit-equal); (c)
   readout_window = 1 against phase 3's coupled fused and tiled runs
   (bit-equal or the difference); (d) a tiled coupled-array RLS engine
   serving the 512 sessions and, carrying their specs, 32 time_multiplexed
   and 32 array_transient tenants and one learner of each family: 2
   sub-engines, every tenant bit-equal to a dedicated engine of its spec
   at the sub-engine's width, each learner bit-equal to its replay there
   (check_learned), the coupled sessions against phase 3's tiled run; the
   spec-carrying submits' host time (each hashes its spec).
3g. Tune (repro_torch.tune) at the same shapes, 200-tick NARMA-10
   candidates (the reference bench's TUNE_TICKS) with online RLS: (a) a
   random search of 512 over drive_current, spectral_radius and a
   structural learn_reg choice (1e-4 / 1e-2, one engine each) under chunk
   and under tiled: candidates/s, the best assignment, PLAN_CACHE's
   compiles (two per impl; the cache cleared first), launches (the impl's
   kernel only) and peak memory; (b) the chunk search again with its seed:
   the trial history bit-identical, no compile; (c) REPLAYS trials of the stable
   regime (learn_reg 1e-2) each served alone on a fresh engine of the same
   plan and width in the lane it was evaluated in (learn_nmse bit-equal),
   and on the E = 1 scan oracle on the card (within NMSE_ORACLE_RTOL); a
   search on an interpret=True plan launches nothing; (d) seconds a
   candidate of a search over 256 lanes and of one lane at a time
   (SEQ_BUDGET candidates), each warmed first, and their ratio (printed only); (e) a
   256-slot RLS engine with 192 co-tenants where tenant 0 calls
   submit_autotuned with 64 probes on the spare lanes, under chunk and
   tiled: no probe sid in pop_results, the winner frozen into the
   session's params, max_retained restored, every co-tenant's states,
   final_m, learned W and learn_nmse bit-equal to the same tenants served
   without it; (f) the launcher with --learn rls --autotune-budget 8, which
   must print its `washout autotune:` line.
3h. The fleet (repro_torch.serve.fleet) at the same shapes, replicas built
   by make_engine (backend chunk) through fleet_engine, which loads the
   kernel library and, in a replica child, fails if that ran nvcc: (a) two
   LocalReplicas behind FleetFrontend serve FLEET_SESSIONS (64) of phase
   3's 512 sessions (the same ones throughout 3h) through submit_stream /
   drain_results (stepped from the front end's executor thread), each
   session bit-equal to phase 3's one engine of the same width
   (a session that is not is printed with its gap and lanes and held
   bit-equal to its replay alone in its fleet lane); (b) two ProcessReplicas
   that share the build directory the parent built: each child's spawn to
   ready, its first three chunks (RPC round trips) beside its engine's median
   chunk, the card's free memory before the spawn and with both ready, the
   sessions held to (a)'s results, each child's backend and kernel
   launches (through the stats RPC); (c) failover with checkpoint_every=2:
   one child hangs at its chunk 2 (rpc_timeout_s trips), the other crashes
   at chunk 3, both respawn: the respawn times, the time from the hung
   chunk's send to the replacement's first chunk, fault_stats(), every
   session held to (b)'s results; (d) one RLS learner checkpointed after two
   chunks out of one process replica into the other (P and W through the
   pipe), bit-equal to the learners served unmoved on one engine; (e)
   sessions/s of one engine, two local and two process replicas by the host
   clock (no claim); (f) the launcher's --fleet with two local replicas
   on the card (process replicas are (b)-(d)'s) serving FLEET_SESSIONS
   sessions, which must say that
   admission control is off (the committed BENCH_serve.json is a CPU grid). `python3 chip_smoke.py
   --fleet` runs it alone.
3i. Sharded plans (ExecPlan(mesh=DeviceMesh), api/sharded.py) in a child
   process (`chip_smoke.py --sharded-child`, rank 0 of a world of one:
   RANK / WORLD_SIZE / LOCAL_RANK set by the parent, a FileStore, NCCL;
   NCCL runs no two ranks on one card), so that its process group never
   reaches the phases after it. It prints the NCCL version, the backend and
   the init time, then at the reservoir cell's shapes: (a) on a (1, 1) mesh
   ("data", "model") a tick_chunk with lanes frozen, retired and admitted
   mid-chunk, the same with learn="rls" at learn_reg LEARN_REG (m, states,
   P, W, preds), drive_batch over a per-lane series, integrate(20) and tick,
   each bit-equal to the unsharded impl="scan" sim, and drive_batch over a
   shared series within SHARED_ATOL (another contraction); the all-gathers a
   chunk (K x hold x 4, +1 for a learning chunk's feature block) and the RLS
   run's peak memory; (b) the same on a 1-D mesh ("data",) with model_axis
   None (no gather); (c) precision="bf16_coupling" on the mesh against the
   f32 mesh plan within BF16_STATE_ATOL, norm_error within BF16_NORM_ATOL;
   a chunk's ms sharded against unsharded scan (CUDA events), rk4_chunk's
   for context, the gather events of one chunk under torch.profiler; (d) a
   ReservoirEngine on the sharded sim serving the 512 NARMA-10 sessions,
   each bit-equal to an engine on the unsharded scan sim, sessions/s by the
   host clock; (e) the mesh plan's plan-cache key stable across two
   compile_plan calls and distinct from the unsharded one.
   `python3 chip_smoke.py --sharded` runs it alone.
4. Hold the flash-attention kernel against its plain version at the shapes
   h2o-danube-1.8b's prefill gives it (B=1, H=32, KVH=8, D=80, causal,
   window 4096; bf16 at Sq=Sk=129, 1024, 4608 and Sq=512 < Sk=1536; f32 at
   Sq=Sk=1024 without a window), at 4608 once more without the window (row
   4b), and at gemma-7b's (H = KVH = 16, D = 256, Sq = Sk = 4096, causal;
   row 4c). Each case is held by two measures: the largest absolute error,
   and the largest over rows (one position of one head) of max|out -
   plain| / max|plain|, which is scale-free, so a 4096-key row (|out| ~
   0.03) counts as much as a one-key row (|out| ~ 1). At 4608 the plain
   version with a fault planted (the window one key too wide; the KV tile
   holding the window's first key dropped) must fail the row measure, which
   shows the check can see a wrong band. Prints the bf16 kernel's tile (the
   library's against the Python mirror), ptxas's registers and spills for
   every instantiation, and per case the tile plan (blocks, KV tiles per
   SM; the Python mirror's, on a line of its own), the errors, the kernel's card time (queued_ms) and per-call time,
   the plain version's, the bound and one scaled_dot_product_attention call
   (a yardstick only): with the explicit band mask where there is a window
   (PyTorch's masked path), else is_causal under the flash backend (K/V
   repeated outside the timed call if that backend refuses enable_gqa),
   naming the backend that ran.
5. Serve 8 requests (prompts of 4608 ... 129 tokens, 32 new tokens each)
   through the LM Engine at the full width of h2o-danube-1.8b (24 layers,
   d_model 2560, bf16, random weights from seed 0) with 4 slots, counters
   set to 0 before the run: every request returns 32 tokens in [0, vocab),
   the flash kernel launched 24 x 8 times and no STO kernel. Then each
   request alone (its own prefill, then decode), teacher-forced on the
   engine's tokens, in two geometries: in the engine's (slot 0 of a 4-row
   cache, the other slots idle) every step's chosen token must be the
   argmax (a logit gap of exactly 0); at batch 1, a second witness that
   shares no decode geometry with the engine, each chosen token's logit
   within LOGIT_MARGIN of the step's maximum. Prints prefill and decode tokens/s, the
   peak device memory, one 4608-token prefill's time (CUDA events) and,
   from a profiler trace of it, the flash kernel's share of its device time.
5b. Training (repro_torch.train, launch.steps, optim, data) on the card,
   each check raising on failure: (a) at a reduced config (f32, d_model 320,
   4 heads: head dim 80, one the flash kernel takes), from the same weights
   and an AdamW state two CPU steps warmed, the loss, every gradient leaf,
   the global norm and the AdamW update on the same clipped gradients match
   the host CPU's within TRAIN_RTOL, and so do the whole make_train_step's
   loss and grad norm, its updated leaves within TRAIN_STEP_RTOL (and a step
   with the wrong step index, without the clip or on bf16 parameters beyond
   it), with no flash launch;
   (b) h2o-danube-1.8b at full width (24 layers, d_model 2560, bf16, remat
   on, AdamW, SyntheticTokens seed 0, batch 4 x 512, lr 1e-3, warmup 5) for
   TRAIN_STEPS = 10 steps: every loss and grad norm
   finite, the mean of the last 5 losses
   LOSS_DROP below the first 5's; ms a step (CUDA events), tokens/s, peak
   device memory; 3 more steps split into forward + backward, global norm +
   clip and the AdamW update beside its bytes bound; one step under
   torch.profiler (busy share, top device ops); one checkpoint of the
   trained tree's first 2 layers (~3 GB, under build/) written from a host
   copy, the device tree freed, read back on the host bit-equal, its GB and
   seconds printed, then removed; (c) at RESUME_LAYERS = 1 layer (2 until PR
   26; full width), 12 steps with a checkpoint every 4 and a crash injected at
   step 9, relaunched: it resumes at step 8 and its losses are within
   RESUME_RTOL of an uninterrupted run's (bit-equal or not printed); (d) on
   (b)'s first batch, loss_fn under torch.no_grad() launches the flash
   kernel once a layer (24), the TRAIN_STEPS steps none, and the two losses agree
   within ROUTING_RTOL; (e) in a child process (`chip_smoke.py
   --train-child`, rank 0 of an NCCL world of one over a FileStore,
   CUBLAS_WORKSPACE_CONFIG set), 4 steps at RESUME_LAYERS layers on a (1, 1) ("data",
   "model") mesh bit-equal to the run without a mesh under
   torch.use_deterministic_algorithms(True), in losses and final
   parameters (read from each run's final checkpoint), the all-reduces
   counted; whether the run without deterministic algorithms is bit-equal
   to the run with them, and a step's ms with and without them; (f) `python -m repro_torch.train.watchdog -- python -m
   repro_torch.launch.train --arch h2o-danube-1.8b --reduced --steps 8
   --batch 2 --seq 16 --ckpt-every 2 --fail-at-step 5 --device cuda` exits 0
   with step_00000007 its last checkpoint. (e)'s child and (f)'s processes,
   which mostly start up, run beside (c). Prints the phase's seconds.
5c. MoE (models/moe.py), run after phase 5 (whose tree is freed) and before
   5b: (a) one MoE layer of qwen2-moe-a2.7b at full width (make_moe from
   seed 0, bf16: 60 experts, top-4, capacity factor 1.25, router chunk 512,
   a 5632-wide shared SwiGLU) on 4097 normalised hidden states (8 router
   chunks and a remainder of 1) and on a 4-row decode batch, the card's
   apply_moe and moe.route against the host CPU's on the same tensors:
   top-k flips at most MOE_MAX_FLIPS, each a near-tie (f32 probability gap
   under MOE_FLIP_GAP), every token whose routing differs touching a
   flipped expert; y within MOE_Y_RTOL on the tokens whose routing agrees,
   aux within MOE_AUX_RTOL; the share of (token, k) pairs dropped per
   chunk; (b) the flash kernel at qwen2-moe's heads (H = KVH = 16, D = 128,
   4608 tokens, causal, no window) against its plain version by phase 4's
   two measures, beside SDPA's flash backend; (c) 8 requests (phase 5's
   prompts, 32 new tokens each) through the Engine at qwen2-moe-a2.7b's
   full width, cut in depth to its first MOE_SERVE_LAYERS = 2 of 24 layers
   (bf16, random weights from seed 0, 4 slots, capacity 4640),
   counters set to 0 before the run: 32 tokens in [0, vocab) each, flash
   launched 2 x 8 times, no STO kernel; a second engine
   run bit-equal token for token; then the config at capacity factor
   num_experts / top_k (no drops) served again and held to phase 5's
   teacher-forced witness (the request alone in the engine's 4-row
   geometry: every gap 0; at batch 1 within LOGIT_MARGIN); prefill and
   decode tokens/s, peak memory, the init's seconds and peak; (d) one
   4608-token prefill and one batch-4 decode step timed with CUDA events
   beside their bounds (the reference's dispatch as run, and what this
   run's tokens need), each traced once with profiler spans that this
   script puts around the MoE layer's parts (router, each einsum, the
   shared expert, the layer): device ms per part beside the flash kernel's;
   (e) a reduced qwen2-moe (f32, capacity factor 1.25) on the card against
   the host CPU over two steps (loss, ce, aux, every gradient leaf, the
   router's, the global norm within TRAIN_RTOL), then 2 layers at full
   width, 5 AdamW steps at batch 2 x 512: every loss and aux finite, aux >
   0, the router's gradient finite and not zero; ms a step, peak memory.
   Prints the phase's seconds. `python3 chip_smoke.py --moe` runs it alone.
5d. MLA (models/attention.py: make_mla, mla_forward, mla_decode and the
   latent cache), run after phase 5c (whose tree is freed): (a) one MLA layer
   of deepseek-v2-lite-16b at full width (make_mla from seed 0, bf16: r 512,
   dn 128, dr 64, dv 128, 16 heads) on normalised hidden states, the card's
   against the host CPU's on the same tensors by phase 4's two measures
   (MLA_Y_RTOL, MLA_CACHE_RTOL): mla_forward over MLA_TOKENS tokens (y,
   c_kv, k_rope; on the card through flash_bf16<192>, one launch), then
   mla_decode on a 4-row batch at MLA_DECODE_POS over a CAPACITY-row latent
   cache filled from a seed (y and the written rows; the cache written in
   place at exactly those rows, every other row bit-equal); (b) the flash
   kernel at deepseek's prefill call (H = KVH = 16, D = dn + dr = 192, v's
   last 64 columns zero, 4608 tokens, causal) against its plain version by
   phase 4's two measures, the output's pad columns exactly 0, beside SDPA
   (its flash backend, or the backend that ran if that one refuses D = 192),
   with the bound as launched and with P.V at v's own width; (c) 8 requests
   (phase 5's prompts, 32 new tokens each) through the Engine at
   deepseek-v2-lite-16b's full width, cut in depth to MLA_SERVE_LAYERS = 2
   of 27 layers (the dense prefix and one MoE period; bf16,
   random weights from seed 0, 4 slots, capacity 4640), counters set to 0
   before the run: 32 tokens in [0, vocab) each, flash launched 2 x 8
   times, no STO kernel,
   the latent cache's bytes those of cache_specs; a second engine run
   bit-equal token for token; then the config at capacity factor
   num_experts / top_k (no drops) served again and held to phase 5's
   teacher-forced witness (the 4-row geometry: every gap 0; batch 1 within
   LOGIT_MARGIN up to a request's first changed expert set); prefill and
   decode tokens/s, peak memory, the init's seconds and peak; (d) one
   4608-token prefill and one batch-4 decode step timed with CUDA events
   beside their bounds, each traced once with profiler spans that this
   script puts around MLA's parts (q projection + rope, wkv_a + norm + rope,
   the decompression einsums, the absorbed einsums and softmax, wo) and the
   MoE layer: device ms per part beside the flash kernel's. Prints the
   phase's seconds. `python3 chip_smoke.py --mla` runs it alone.
5e. The recurrent mixers (models/mamba.py, models/xlstm.py), run after phase
   5d (whose tree is freed): (a) one Mamba layer of jamba-1.5-large at full
   width (make_mamba from seed 0, bf16: d_model 8192, d_inner 16384, d_state
   16, dt_rank 512, chunk 64) on normalised hidden states, the card against
   the host CPU on the same tensors by phase 4's two measures
   (MAMBA_Y_RTOL, MAMBA_STATE_RTOL, MAMBA_TAIL_RTOL; h's row measure over
   the row's largest term magnitude, as it sums terms of both signs):
   mamba_forward over
   MAMBA_TOKENS = 1024 + 37 tokens (y, h, conv_tail; the last chunk padded),
   mamba_decode on a 4-row batch with states from a seed (y and the cache,
   written in place: the same tensors, the tail shifted by a row); chunks of
   64 against one chunk of the whole sequence on the card
   (MAMBA_CHUNK_RTOL); a 4608-token prefill and a batch-4 decode step timed
   on the card (CUDA events), beside their bounds, and on the host CPU (the
   prefill there at MAMBA_TOKENS tokens: the run held above); (b)
   the flash kernel at jamba's attention call (H 64, KVH 8: a GQA group of
   8, D 128, no RoPE, 4608 tokens, causal) against its plain version by
   phase 4's two measures, beside SDPA's flash backend, with its bound; (c)
   jamba cut in depth to its period's first 4 layer specs (num_layers 4: 3
   Mamba layers, the attention layer, 2 MoE and 2 MLP channel mixers, 23.0 B
   parameters, ~46 GB in bf16; the whole 72-layer model, 398.6 B, fits no
   card; the cut is jamba_cut(), not a registered config) served at full
   width: 8 requests (phase 5's prompts, 32 new tokens each), random weights
   from seed 0, 4 slots, capacity 4640, counters set to 0 before the run:
   tokens in [0, vocab), flash launched 1 x 8 times, no STO kernel; a second
   run bit-equal; 4 requests admitted into a fresh engine, each slot's h and
   conv_tail bit-equal to its lone prefill's; the config at capacity factor
   num_experts / top_k (no drops) held to phase 5's teacher-forced witness
   in the engine's 4-row geometry (every gap 0); prefill and decode tokens/s,
   peak memory, the init's seconds and peak; one 4608-token prefill and one
   batch-4 decode step timed with CUDA events beside their bounds, each
   traced once with profiler spans that this script puts around Mamba's
   parts (in_proj, the conv, x_proj + norms + dt, the scan with its C
   einsum, the gate with out_proj) and the MoE layer, beside the flash
   kernel's device time; (d) xlstm-125m whole (12 blocks, bf16, seed 0): one
   mLSTM and one sLSTM block on the card against the host CPU (XLSTM_RTOL
   by both measures, the mLSTM prefill's c and n over their terms'
   magnitudes; the forward over XLSTM_TOKENS tokens with its cache, the
   decode writing
   its states in place), then 8 requests served as in (c): no kernel
   launched (xLSTM launches no TPU kernel's counterpart), a second run
   bit-equal, each request rerun alone in the 4-row geometry exact at every
   step, tokens/s, peak memory, and the prefill's ms at the longest prompt
   run (phase 5's prompts at an eighth of their lengths, XLSTM_PROMPTS: the
   sLSTM blocks run a Python loop over the tokens); (e) reduced jamba and
   reduced xlstm-125m (f32) on the card against the host CPU over two steps
   from the same weights: the loss within TRAIN_RTOL, every gradient leaf
   within RECURRENT_GRAD_RTOL (autograd through the plain ops: neither
   mixer has a kernel).
   Prints the phase's seconds. `python3 chip_smoke.py --recurrent` runs it
   alone.
5f. The encoder-decoder and embedding-input paths (models/transformer.py:
   encode, cross-attention, inputs_embeds), run after phase 5e (whose tree
   is freed) and before 5b: (a) the flash kernel at this slice's new shapes
   against its plain version by phase 4's two measures, beside SDPA's flash
   backend (no mask where the call has none), with its bound, at the shapes
   (b) and (c) launch it: whisper's encoder (B 1, H = KVH = 8, D 64, 1500 x
   1500, bidirectional), its decoder's self prefill (B 1, 4 x 4, causal),
   its cross prefill (B 1, Sq 4, Sk 1500) and a cross decode step (B 4, Sq
   1), and llava's prefill (B 1, 2992 rows, causal, H 32, KVH 8, D 128);
   (b) whisper-base
   whole at full width (6 encoder and 6 decoder layers, bf16, weights from
   seed 0; the conv frontend stubbed: LM_SLOTS requests of WHISPER_FRAMES =
   1500 frames, 30 s of audio, 0.02 x normal from seed 0), the four
   start-of-transcript ids as the prompt, WHISPER_NEW = 220 greedy tokens,
   4 slots: each request prefilled alone and spliced into slot i of a 4-row
   cache with enc_seq 1500 (the Engine prefills token prompts only, so
   _serve_lockstep runs its loop), then lock-step decode; counters set to 0
   before the run, flash's counted by call site as well (_launches_by_site):
   flash launched exactly 18 times a prefill (6 encoder, 6 self, 6 cross)
   and 6 a decode step (cross), no STO kernel; a second run
   bit-equal; each request rerun alone in the 4-row geometry (phase 5's
   witness, given the frames) exact at every step; one request through the
   whole model on the card against the host CPU (the prefill's logits, every
   self and cross k / v, WHISPER_CPU_STEPS decode steps' logits;
   ENCDEC_CACHE_RTOL, ENCDEC_LOGIT_RTOL by both measures); prefill rows/s and
   decode tokens/s, a prefill's and a decode step's ms beside their bounds,
   each traced once (the busy share); (c) llava-next-mistral-7b at full width
   (32 layers, bf16, seed 0): a 512-token prefill from inputs_embeds =
   embed_tokens(tokens) bit-equal to the token prefill (logits and caches);
   its first decoder layer on the card against the host CPU over
   LLAVA_LAYER_TOKENS tokens (y, k, v); LM_SLOTS requests of
   LLAVA_IMAGE_ROWS = 2928 stub image rows (LLaVA-NeXT's anyres layout of a
   672 x 672 image) and 64 text rows, LLAVA_NEW = 32 new tokens, served as in
   (b): flash launched exactly 32 times a prefill, the 4-row witness exact,
   rows/s and tokens/s, the prefill's and a decode step's ms beside their
   bounds, traced; (d) reduced whisper (remat on) and reduced llava at head
   dim 64, f32, the loss and every gradient leaf on the card against the
   host CPU within TRAIN_RTOL, no flash launch under grad. Prints the
   phase's seconds by part. `python3 chip_smoke.py --encdec` runs it alone.
5g. The dry run and the roofline (launch/dryrun.py, launch/costs.py,
   launch/roofline.py on launch/mesh.HW), held against the card where phases
   5 and 5b run: (b), inside phase 5, its 4608-token prefill dry-run on fake
   CUDA tensors (the flash wrapper reports its launches and the band's FLOPs
   and launches nothing): as many flash launches as one real prefill's
   LAUNCHES, and the roofline's terms beside the measured prefill; (a),
   inside 5b(b), 5b's training cell (full width, bf16, remat, AdamW, batch 4
   x 512) dry-run on fake CUDA tensors against one more real step under
   FlopCounterMode after reset_peak_memory_stats(): FLOPs equal, argument
   bytes equal to the parameters, state, batch and step index held, no
   all-reduce on either side, the predicted peak (argument bytes + the
   counted temp peak) within PEAK_RTOL of max_memory_allocated() less what
   was allocated before the step outside its arguments; the roofline's
   terms, 5b's median step over the dominant term and model FLOPs / bf16
   peak / the median step; (c), beside 5b(c), two children: `python -m
   repro_torch.launch.dryrun --reservoir` (256 fake ranks of the (32, 8)
   production mesh, N = 16 384, E = 8 192, 100 RK4 steps; its record and
   terms printed, 402 all-gathers, the global state's bytes on every rank)
   and `chip_smoke.py --dryrun-child` (an NCCL world of one: a sharded
   tick_chunk at 3i's shapes and a data-parallel train step at 1 layer on a
   (1, 1) mesh on the card, then the same calls dry-run over a fake group of
   one: as many all-gathers and all-reduces). `python3 chip_smoke.py
   --dryrun` runs it alone (training and serving h2o-danube-1.8b itself).
5h. Tensor parallelism (distributed/tensor_parallel.py) on two ranks of card
   0 (`chip_smoke.py --tp-child DIR`, a gloo world of two over a FileStore:
   NCCL runs no two ranks on one card; gloo stages CUDA tensors through the
   host, so its times are printed as such and claim no speed), beside 5b(c)
   with 5g(c)'s children. The ranks first compute the one-rank references
   (rank 0 (a) and (d), rank 1 (b)), then each runs a (1, 2) ("data",
   "model") mesh from the same init(0) draws, holding its blocks against
   their slices: (a) h2o-danube-1.8b whole, a TP_PROMPT-token prefill at
   TP_ROWS rows and TP_NEW teacher-fed decode steps through
   make_serve_steps: the flash kernel launched once a layer a prefill on
   each rank's heads (H 16, KVH 4; also against its plain version there),
   every call's last-position logits within TP_LOGIT_RTOL, greedy tokens off
   one rank's argmax counted, each within TP_FLIP_GAP there; (b) 3 AdamW
   steps at 2 layers of 5b's cell: losses and grad norms within
   TP_LOSS_RTOL, init(0) blocks equal to the one-rank draws' slices, every
   leaf's update within TP_UPDATE_RTOL of one rank's, replicated leaves
   bit-equal across the ranks; (c) each call's all-reduces on "model" read
   with costs.CostMode equal on both ranks and to the dry run's over a fake
   (1, 2) group; (d) qwen2-moe-a2.7b at 2 layers (30 experts a rank), bf16,
   served as (a) with TP_MOE_NEW steps: flash also against its plain version
   at the rank's heads (H 8, KVH 8); the routing the same on both ranks,
   its router logits within TP_ROUTE_RTOL of one rank's, tokens routed
   otherwise counted per layer and each a near-tie; the logits within
   TP_LOGIT_RTOL of one rank run with the mesh's routing; peak memory a
   rank beside one rank's.
   `python3 chip_smoke.py --tp` runs it alone.
6. Print the kernels line (the STO kernels, tm_delay_line and flash, whose
   row carries its qwen2_moe, deepseek_v2_lite, jamba and encdec entries),
   the card line and, last, the contract line {"ok": true, "device": {...}}.

Without a card, or outside a checkout, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import contextlib
import gc
import io
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py needs a CUDA card (torch.cuda.is_available() is False)")

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

from repro_torch.api import (  # noqa: E402
    ExecPlan,
    SimSpec,
    compile_plan,
    enable_persistent_cache,
    make_array_transient_spec,
    make_spec,
    make_time_multiplexed_spec,
)
from repro_torch.api import compiled  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import constants, coupling, integrators, sto, tasks  # noqa: E402
from repro_torch.core.ensemble import broadcast_params  # noqa: E402
from repro_torch.core.reservoir import Readout, fit_lms, fit_rls  # noqa: E402
from repro_torch.kernels import _build, ops, sto_step  # noqa: E402
from repro_torch.kernels import rls as krls  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.models import build_model, counting, transformer  # noqa: E402
from repro_torch.serve.engine import Engine, Request, _splice_cache  # noqa: E402
from repro_torch.serve.reservoir import ReservoirEngine, StreamSession  # noqa: E402

N, E, HOLD, K = 2500, 256, 5, 8
N_LARGE = 10000  # the paper's largest reservoir (its 23.8x GPU factor)
DT = constants.DT
SESSIONS = 512
SOURCE = {
    "rk4_chunk": "src/repro_torch/kernels/csrc/sto_rk4.cu",
    "rk4_fused": "src/repro_torch/kernels/csrc/sto_rk4.cu",
    "field_tiled": "src/repro_torch/kernels/csrc/sto_rk4.cu",
    "round_bf16": "src/repro_torch/kernels/csrc/sto_rk4.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "tm_delay_line": "src/repro_torch/kernels/csrc/sto_delay_line.cu",
}
# the Pallas kernel each CUDA kernel replaces
REPLACES = {
    "rk4_chunk": "src/repro/kernels/sto_step.py:237",
    "rk4_fused": "src/repro/kernels/sto_step.py:95",
    "field_tiled": "src/repro/kernels/sto_step.py:167",
    # the bf16 cast of the stage x-plane inside _field_tiled_kernel
    "round_bf16": "src/repro/kernels/sto_step.py:185",
    "flash_attention": "src/repro/kernels/flash_attention.py:35",
    # plain jnp, no Pallas kernel: the node loop of the time-multiplexed chunk
    # body, which XLA compiles into one device loop on the TPU
    "tm_delay_line": "src/repro/kernels/ref.py:233",
}
STO_KERNELS = ("rk4_chunk", "rk4_fused", "field_tiled", "round_bf16")
# tolerances, kernel vs plain version on the same inputs:
STATE_ATOL = 1e-4  # f32 state over one chunk (FP32 sums in another order)
# bf16-W state: both versions round the x-plane operand to bf16 and sum the
# exact products in f32, so they differ as the f32 ones do (3.0e-7 read on an
# H100 for either W)
BF16_ATOL = 1e-5
# the coupling's share of the state, f(W) - f(0), kernel vs plain version,
# relative to its largest magnitude: here the coupling moves the live lanes
# by ~2.3e-3 over a chunk and f32 rounding moves that share by ~3e-4 of
# itself (a float64 run of the plain version on the CPU), while a
# contraction slice dropped or summed twice moves it by ~0.4 of itself
COUPLING_RTOL = 2e-3
SLOPE_RTOL = 1e-5  # field_tiled slopes (~1e10 Oe/s) relative to their max
# The coupling's share of field_tiled's slopes (~2.4e7 of ~1e10 Oe/s) and of
# one rk4_tiled_step's state (~2.4e-4) is held to COUPLING_RTOL as well: f32
# rounding moves those shares by ~1.4e-4 and ~3.1e-4 of themselves (a
# float64 run of the plain versions on the CPU, either W), a contraction
# slice dropped by ~1/C.
# flash attention vs its plain version: bf16 3e-2 (the reference's bf16
# flash test; bf16 probabilities in P.V), f32 5e-6 (its f32 tests); and per
# row, max|err| / max|plain| (row_rel_err): in bf16 the two may round the
# row's largest element to neighbouring values, at most 2^-7 = 7.8e-3 of
# it, so 1e-2 admits that and no second ulp; in f32 ~6x the 3.5e-6 read on
# an H100 at 1024 keys.
FLASH_ATOL = {torch.bfloat16: 3e-2, torch.float32: 5e-6}
FLASH_RTOL = {torch.bfloat16: 1e-2, torch.float32: 2e-5}

# phase 3b, online learning: every session's first LEARN_WASHOUT ticks update
# nothing; RLS starts from P = I / LEARN_REG, NLMS steps by LEARN_MU
LEARN_WASHOUT = 4
LEARN_REG = 1e-2
LEARN_MU = 0.5
# a learned W against the E = 1 oracle on the card (fit_rls / fit_lms over
# the session's harvested states), relative to max |W|: the two may take
# other GEMM and reduction orders. f32 rounding alone moves RLS's W by up to
# 4.3e-5 of max |W| and NLMS's by 1.4e-7 (f32 against f64 on a CPU, six of
# these sessions at N = 2500); these limits are ~10x and ~35x that. An
# H100 read 1.45e-4 and 2.5e-7 over the 512 sessions.
ORACLE_RTOL = {"rls": 5e-4, "lms": 5e-6}
# phase 3c, the paper's ladder: ms per RK4 step at these N
LADDER_N = (1, 100, 1000, 2500, 10000)
# phase 3g, tune: NARMA-10 candidates of the reference bench's TUNE_TICKS
# (benchmarks/serve_throughput.py:409), each engine one learn_reg of TUNE_REGS
# (RLS at the default 1e-6 is ill-conditioned at N = 2500)
TUNE_TICKS = 200
TUNE_WASHOUT = 50
TUNE_BUDGET = 512
TUNE_REGS = (1e-4, 1e-2)
# the stable regime (the reference bench's grid: drive current 1-3 mA,
# spectral radius 0.3-0.9), where a lane's fitness is comparable across
# widths and implementations; replays and the oracle use learn_reg 1e-2
STABLE_CURRENT = (1e-3, 3e-3)
STABLE_A_CP = (0.3, 0.9)
ORACLE_REG = 1e-2
# the first REPLAYS of them (16 until phase 3h joined the script, 8 until
# phase 3i did, 4 until phase 5d did: the E = 1 oracle costs 4.3-6.7 s each
# on an H100)
REPLAYS = 2
# a replayed trial's learn_nmse against the E = 1 scan oracle on the card,
# relative: f32 rounding alone moves it by up to 1.39e-3 on the first 16
# candidates 3g(c) replays (f32 against f64 scan on a CPU, N = 2500, learn_reg 1e-2;
# 5e-6 at 2.2 mA, 1e-3 near 3 mA, the edge of the stable regime; 3.2x at
# learn_reg 1e-4, which is why the oracle holds 1e-2 only); ~7x that
NMSE_ORACLE_RTOL = 1e-2
SEQ_BUDGET = 4  # 16 until phase 3i joined the script, 8 until phase 5d did
AUTOTUNE_TENANTS = 192
AUTOTUNE_BUDGET = 64
AUTOTUNE_WASHOUT = 40

# the LM path: h2o-danube-1.8b at full width
LM_ARCH = "h2o-danube-1.8b"
PROMPTS = (4608, 4097, 2048, 1536, 1024, 777, 512, 129)
MAX_NEW = 32
LM_SLOTS = 4
CAPACITY = 4640
# (Sq, Sk, dtype, window) of the flash phase; 4608 exceeds the window
FLASH_CASES = (
    (129, 129, torch.bfloat16, 4096),
    (1024, 1024, torch.bfloat16, 4096),
    (4608, 4608, torch.bfloat16, 4096),
    (1024, 1024, torch.float32, 0),
    (512, 1536, torch.bfloat16, 4096),
)
# row 4b: h2o-danube's longest prefill without the window, beside SDPA's
# flash backend; row 4c: gemma-7b's heads (H = KVH = 16, D = 256)
FLASH_NO_WINDOW = (4608, 4608, torch.bfloat16, 0)
GEMMA_ARCH = "gemma-7b"
GEMMA_CASE = (4096, 4096, torch.bfloat16, 0)
# Engine vs each request alone, teacher-forced. Decoding in the engine's
# geometry (4 rows, the request in one), the lone run's row meets the same
# GEMM shapes and every step's arithmetic is row-wise, so it must agree bit
# for bit: every gap between the step's maximum logit and the chosen
# token's is 0 (read on an H100 over three weight seeds and three attention
# kernels). Decoding at batch 1, cuBLAS takes other GEMMs and rounds
# differently (2-10 of 256 steps flipped, gaps up to 4.4e-2, on the same
# runs), so that witness only bounds the gap.
LOGIT_MARGIN = 0.05
# device-side sleep ahead of a queued timing (queued_ms): ~20 ms at the
# H100's 1.98 GHz, longer than the host takes to queue the timed calls
SLEEP_CYCLES = 40_000_000
# LLG epilogue + stage algebra, FLOPs per (oscillator, lane, stage)
EPILOGUE_FLOPS = sto_step.EPILOGUE_FLOPS
# published peaks (NVIDIA H100 data sheet, dense; launch/mesh.HW_VARIANTS,
# which the roofline reads): FP32 outside the tensor cores, bf16 tensor
# cores, HBM bandwidth
PEAKS = {  # name fragment -> (fp32 FLOP/s, bf16 tensor FLOP/s, bytes/s)
    frag: (hw["peak_flops_f32"], hw["peak_flops_bf16"], hw["hbm_bw"])
    for frag, hw in mesh_mod.HW_VARIANTS.items()
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def peaks(name: str):
    for frag, vals in PEAKS.items():
        if frag in name:
            return vals
    raise AssertionError("unreachable")


def bound_ms(name, gemm_flops, epi_flops, nbytes, bf16):
    fp32, tensor, bw = peaks(name)
    t_ops = gemm_flops / (tensor if bf16 else fp32) + epi_flops / fp32
    t_bytes = nbytes / bw
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def time_ms(fn, reps):
    """Median ms of fn over reps, each timed with CUDA events, after one
    untimed call."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return sorted(times)[len(times) // 2]


def queued_ms(fn, reps, batches=3):
    """ms per call of fn, the card's time: `reps` calls queued back to back
    behind a device-side sleep (torch.cuda._sleep), so the card runs them
    without waiting for the host between launches; the median of `batches`
    batches, after one untimed call. A batch counts only if the card was
    still asleep when the host had queued its last call (the event after the
    sleep not yet reached); otherwise it runs again behind a sleep twice as
    long, and after four doublings this raises. Returns (ms per call, the
    host's ms to queue one call, the longest sleep's ms): host x reps stays
    under the sleep. A full launch queue (~1000 launches) stalls the host as
    well, so reps x the launches of one call stay below that."""
    fn()
    torch.cuda.synchronize()
    times, host, slept = [], [], []
    cycles = SLEEP_CYCLES
    for _ in range(batches):
        while True:
            asleep, start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(3))
            asleep.record()
            torch.cuda._sleep(cycles)
            start.record()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            queued = time.perf_counter() - t0
            woke = start.query()
            stop.record()
            stop.synchronize()
            if not woke:
                break
            assert cycles < 16 * SLEEP_CYCLES, (
                f"queuing {reps} calls took the host {1e3 * queued:.3f} ms, longer than a "
                f"{asleep.elapsed_time(start):.3f} ms sleep"
            )
            cycles *= 2
        host.append(1e3 * queued / reps)
        slept.append(asleep.elapsed_time(start))
        assert host[-1] * reps < slept[-1], (host[-1], reps, slept[-1])
        times.append(start.elapsed_time(stop) / reps)
    return sorted(times)[batches // 2], max(host), max(slept)


def ptxas_info(log, fragment):
    """Registers, stack and spills ptxas printed for the entry function whose
    mangled name holds `fragment`; None without a build log (cached build)."""
    if not log:
        return None
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and fragment in line:
            block = []
            for nxt in lines[i + 1 :]:
                if "Compiling entry function" in nxt:
                    break
                block.append(nxt)
            text = "\n".join(block)
            num = lambda pat: int(m.group(1)) if (m := re.search(pat, text)) else None  # noqa: E731
            return dict(
                registers=num(r"Used (\d+) registers"),
                stack_bytes=num(r"(\d+) bytes stack frame"),
                spill_store_bytes=num(r"(\d+) bytes spill stores"),
                spill_load_bytes=num(r"(\d+) bytes spill loads"),
            )
    raise AssertionError(f"no ptxas entry for {fragment} in the build log")


# rk4_coop_kernel<float> and <__nv_bfloat16>, field_stage_kernel<...>, as
# mangled in the build log
COOP_MANGLED = {
    torch.float32: "rk4_coop_kernelIf",
    torch.bfloat16: "rk4_coop_kernelI13__nv_bfloat16",
}
FIELD_MANGLED = {
    torch.float32: "field_stage_kernelIf",
    torch.bfloat16: "field_stage_kernelI13__nv_bfloat16",
}


def launch_config(w_dtype):
    """The work split rk4_chunk / rk4_fused launch at the padded serving
    shape, with the kernel's resources."""
    split = sto_step.coop_launch_config(
        ops._round_up(N, ops.BLOCK_N), E, w_dtype, torch.device("cuda")
    )
    return dict(
        blocks=split.blocks,
        cluster=split.cluster,
        slices=split.cluster,
        clusters=split.clusters,
        tile_rows=split.rows,
        tiles=split.items,
        rounds=split.rounds,
        dynamic_smem_bytes=sto_step.coop_smem_bytes(w_dtype),
        ptxas=ptxas_info(_build.BUILD_LOG, COOP_MANGLED[w_dtype]),
    )


def field_launch_config(n_p, w_dtype):
    """The work split field_tiled / rk4_tiled_step launch at a padded N."""
    split = sto_step.field_launch_config(n_p, E, w_dtype, torch.device("cuda"))
    return dict(
        blocks=split.blocks,
        cluster=split.cluster,
        slices=split.cluster,
        clusters=split.clusters,
        resident_clusters=split.resident,
        tile_rows=split.rows,
        tiles=split.items,
        waves=split.waves,
        dynamic_smem_bytes=sto_step.field_smem_bytes(w_dtype),
        ptxas=ptxas_info(_build.BUILD_LOG, FIELD_MANGLED[w_dtype]),
    )


def kernel_inputs(dev):
    """The serving path's padded operands: N=2500 -> 2560, E=256."""
    g = torch.Generator().manual_seed(0)
    w = torch.as_tensor(coupling.make_coupling_matrix(N, seed=0))
    m = constants.initial_magnetization(N, device="cpu").expand(E, N, 3)
    m = m + 0.05 * torch.randn((E, N, 3), generator=g)
    m = m / m.norm(dim=-1, keepdim=True)
    pv = kref.pack_params(constants.default_params(device="cpu"), E)
    h = 0.5 * torch.rand((K, N, E), generator=g)
    m, w, pv, _, _, _ = ops._pad_planes(ops.to_planes(m), w, pv, None, ops.BLOCK_N, ops.BLOCK_E)
    n_p = m.shape[1]
    h = torch.nn.functional.pad(h, (0, 0, 0, n_p - N))
    # lanes 0-63 frozen for the whole chunk, 64-95 retire after tick 3,
    # 96-127 admitted at tick 4, the rest live throughout
    mask = torch.ones((K, E))
    mask[:, :64] = 0
    mask[4:, 64:96] = 0
    mask[:4, 96:128] = 0
    return [t.to(dev).contiguous() for t in (m, w, pv, h, mask)]


def device_inputs(n_p, n, dev, seed=0):
    """Operands for n oscillators padded to n_p, made on the card from a
    torch.Generator: W zero on the diagonal and past n, U[-1, 1] elsewhere
    scaled by sqrt(3 / n), which puts its spectral radius near 1 by the
    circular law (make_coupling_matrix reaches 1 through eigenvalues; a
    kernel's time does not depend on W's spectrum); m near the initial
    state; default params; a drive h in [0, 0.5). Returns (m (3, n_p, E), W,
    params, h (n_p, E))."""
    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.zeros((n_p, n_p), device=dev)
    w[:n, :n] = (2.0 * torch.rand((n, n), generator=g, device=dev) - 1.0) * math.sqrt(3.0 / n)
    w.fill_diagonal_(0.0)
    m = constants.initial_magnetization(n, device=dev).expand(E, n, 3)
    m = m + 0.05 * torch.randn((E, n, 3), generator=g, device=dev)
    m = ops.to_planes(m / m.norm(dim=-1, keepdim=True))
    m = torch.nn.functional.pad(m, (0, 0, 0, n_p - n)).contiguous()
    pv = kref.pack_params(constants.default_params(device=dev), E).contiguous()
    h = torch.zeros((n_p, E), device=dev)
    h[:n] = 0.5 * torch.rand((n, E), generator=g, device=dev)
    return m, w, pv, h


def coupling_check(label, kern, plain, w_k, atol=None, launch_config=None):
    """The coupling product's share of the result, f(W) - f(0), kernel vs
    plain version (COUPLING_RTOL); then the plain version with a fault
    planted in the product (none of it; the last rank's contraction slice
    of the launch's split dropped, or summed twice) must fail this measure,
    which shows it can see a split fault, and, where `atol` is given, the
    row's absolute tolerance too. Over one hold window (rk4_fused) a dropped
    slice moves the state by less than STATE_ATOL, so there only the
    coupling measure can see it. `launch_config` gives the split (the
    cooperative kernel's by default)."""
    n_p = w_k.shape[0]
    config = launch_config or sto_step.coop_launch_config
    split = config(n_p, E, w_k.dtype, torch.device("cuda"))
    zero = torch.zeros_like(w_k)
    p0 = plain(zero)
    d_plain = plain(w_k) - p0
    scale = d_plain.abs().max().item()
    rel = lambda d: (d - d_plain).abs().max().item() / scale  # noqa: E731
    err = rel(kern(w_k) - kern(zero))
    assert err <= COUPLING_RTOL, f"{label}: coupling share differs by {err} (relative)"
    k0, k1 = next(sto_step.coop_block_work(split, n_p, E, split.cluster - 1)).k
    faults = {}
    for fault, gain in (("coupling dropped", None), ("last slice dropped", 0.0),
                        ("last slice summed twice", 2.0)):
        w_f = zero if gain is None else w_k.clone()
        if gain is not None:
            w_f[:, k0:k1] *= gain
        d = plain(w_f) - p0
        faults[fault] = dict(coupling_rel_err=rel(d), max_abs_err=(d - d_plain).abs().max().item())
        assert faults[fault]["coupling_rel_err"] > COUPLING_RTOL, (label, fault, faults[fault])
        assert atol is None or faults[fault]["max_abs_err"] > atol, (label, fault, faults[fault])
    return dict(coupling_rel_err=err, coupling_max=scale, coupling_faults=faults)


def _flat(*ts):
    return torch.cat([t.flatten() for t in ts])


def check_kernels(name):
    dev = torch.device("cuda")
    m, w, pv, h, mask = kernel_inputs(dev)
    e = E
    state_bytes = 3 * N * e * 4
    plane = N * e * 4
    rows = {}

    # -- rk4_chunk, f32 and bf16 W --------------------------------------------
    for wdt, tol in ((torch.float32, STATE_ATOL), (torch.bfloat16, BF16_ATOL)):
        w_k = w.to(wdt)
        mk, sk = sto_step.rk4_chunk(m, w_k, pv, DT, HOLD, h, mask)
        mp, sp = kref.rk4_chunk_planes(m, w_k, pv, DT, HOLD, h, mask > 0.5)
        torch.cuda.synchronize()
        err = max((mk - mp).abs().max().item(), (sk - sp).abs().max().item())
        assert err <= tol, f"rk4_chunk ({wdt}) differs from its plain version by {err}"
        assert torch.equal(mk[:, :, :64], m[:, :, :64]), "frozen lanes changed"
        assert torch.equal(sk[:, :, :64], m[0, :, :64].expand(K, -1, -1)), "frozen states"
        assert all(torch.equal(sk[t, :, 64:96], sk[3, :, 64:96]) for t in range(4, K)), (
            "lanes retired after tick 3 moved"
        )
        assert all(torch.equal(sk[t, :, 96:128], m[0, :, 96:128]) for t in range(4)), (
            "lanes admitted at tick 4 moved before it"
        )
        assert not torch.equal(sk[4, :, 96:128], m[0, :, 96:128]), "admitted lanes never ran"
        coupling = coupling_check(
            f"rk4_chunk ({wdt})",
            lambda w_: _flat(*sto_step.rk4_chunk(m, w_, pv, DT, HOLD, h, mask)),
            lambda w_: _flat(*kref.rk4_chunk_planes(m, w_, pv, DT, HOLD, h, mask > 0.5)),
            w_k, tol,
        )
        gemm = 2.0 * N * N * e * 4 * HOLD * K
        epi = EPILOGUE_FLOPS * N * e * 4 * HOLD * K
        nbytes = N * N * w_k.element_size() + 2 * state_bytes + 10 * e * 4 + 2 * K * plane + K * e * 4
        b_ms, b_by = bound_ms(name, gemm, epi, nbytes, wdt == torch.bfloat16)
        x = torch.rand((w.shape[0], 4 * HOLD * K * e), device=dev).to(wdt)
        chunk = lambda: sto_step.rk4_chunk(m, w_k, pv, DT, HOLD, h, mask)  # noqa: E731
        row = dict(
            max_abs_err=err,
            ms=time_ms(chunk, 5),
            card_ms=queued_ms(chunk, 5)[0],
            plain_ms=time_ms(lambda: kref.rk4_chunk_planes(m, w_k, pv, DT, HOLD, h, mask > 0.5), 3),
            bound_ms=b_ms,
            bound_by=b_by,
            library_ms=time_ms(lambda: torch.matmul(w_k, x), 5),
        )
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["vs_library"] = row["ms"] / row["library_ms"]
        row.update(coupling)
        row["launch"] = launch_config(wdt)
        del x
        if wdt == torch.float32:
            rows["rk4_chunk"] = row
        else:
            rows["rk4_chunk"]["bf16_w"] = row
        print(f"kernel rk4_chunk W={wdt}: " + json.dumps(row), flush=True)

    # -- rk4_fused, n_inner = hold_steps -------------------------------------
    h0 = h[0].contiguous()
    mf = sto_step.rk4_fused(m, w, pv, DT, n_inner=HOLD, h_in=h0)
    mfp = kref.rk4_multi_step_planes(m, w, pv, DT, HOLD, h0)
    torch.cuda.synchronize()
    err = (mf - mfp).abs().max().item()
    assert err <= STATE_ATOL, f"rk4_fused differs from its plain version by {err}"
    coupling = coupling_check(
        "rk4_fused",
        lambda w_: sto_step.rk4_fused(m, w_, pv, DT, n_inner=HOLD, h_in=h0),
        lambda w_: kref.rk4_multi_step_planes(m, w_, pv, DT, HOLD, h0),
        w,
    )
    gemm = 2.0 * N * N * e * 4 * HOLD
    epi = EPILOGUE_FLOPS * N * e * 4 * HOLD
    nbytes = N * N * 4 + 2 * state_bytes + 10 * e * 4 + plane
    b_ms, b_by = bound_ms(name, gemm, epi, nbytes, False)
    x = torch.rand((w.shape[0], 4 * HOLD * e), device=dev)
    fused_fn = lambda: sto_step.rk4_fused(m, w, pv, DT, n_inner=HOLD, h_in=h0)  # noqa: E731
    rows["rk4_fused"] = dict(
        max_abs_err=err,
        ms=time_ms(fused_fn, 10),
        card_ms=queued_ms(fused_fn, 20)[0],
        plain_ms=time_ms(lambda: kref.rk4_multi_step_planes(m, w, pv, DT, HOLD, h0), 5),
        bound_ms=b_ms,
        bound_by=b_by,
        library_ms=time_ms(lambda: torch.matmul(w, x), 10),
    )
    fused = rows["rk4_fused"]
    fused["share_of_bound"] = fused["bound_ms"] / fused["ms"]
    fused["vs_library"] = fused["ms"] / fused["library_ms"]
    fused.update(coupling)
    fused["launch"] = launch_config(torch.float32)
    print("kernel rk4_fused: " + json.dumps(fused), flush=True)

    # -- field_tiled (f32, bf16 W) and rk4_tiled_step at N = 2500 ------------
    rows["field_tiled"] = field_rows(name, m, w, pv, h0, N, step=True)
    rows["round_bf16"] = round_row(name, m[0].contiguous())
    # the tiled impl over one chunk through ops: lanes frozen, retired, admitted
    args = (m, w, pv, DT, HOLD, h, mask > 0.5)
    mt, st = ops.sto_rk4_tick_chunk_planes(*args, impl="tiled")
    mp, sp = ops.sto_rk4_tick_chunk_planes(*args, impl="tiled", interpret=True)
    torch.cuda.synchronize()
    err = max((mt - mp).abs().max().item(), (st - sp).abs().max().item())
    assert err <= STATE_ATOL, f"tiled chunk differs from its plain version by {err}"
    assert torch.equal(mt[:, :, :64], m[:, :, :64]), "tiled: frozen lanes changed"
    assert all(torch.equal(st[t, :, 64:96], st[3, :, 64:96]) for t in range(4, K)), (
        "tiled: lanes retired after tick 3 moved"
    )
    assert all(torch.equal(st[t, :, 96:128], m[0, :, 96:128]) for t in range(4)), (
        "tiled: lanes admitted at tick 4 moved before it"
    )
    rows["field_tiled"]["tiled_chunk"] = dict(max_abs_err=err, atol=STATE_ATOL, frozen_lanes="exact")
    print("tiled chunk (K=8, hold 5) vs plain: " + json.dumps(rows["field_tiled"]["tiled_chunk"]),
          flush=True)
    del mt, st, mp, sp
    del m, w, pv, h, mask, h0
    torch.cuda.empty_cache()
    # -- field_tiled at the paper's largest N ----------------------------------
    n_p = ops._round_up(N_LARGE, ops.BLOCK_N)
    m, w, pv, h = device_inputs(n_p, N_LARGE, dev)
    large = field_rows(name, m, w, pv, h, N_LARGE, step=False)
    rows["field_tiled"][f"n{N_LARGE}"] = large
    rows["field_tiled"][f"n{N_LARGE}_bf16_w"] = large.pop("bf16_w")
    del m, w, pv, h
    torch.cuda.empty_cache()
    return rows


def field_rows(name, m, w, pv, h0, n, step):
    """field_tiled at c = 0, dt/2 and dt for an f32 and a bf16 W at n
    oscillators (m, W, h padded), each held against its plain version by
    SLOPE_RTOL and by the coupling's share, timed, with its bound and split;
    with `step`, one rk4_tiled_step too, held by STATE_ATOL (f32) or
    BF16_ATOL and the coupling's share, and timed beside four field_tiled
    launches. Returns the f32 row with the bf16 row under "bf16_w"."""
    e, n_p = E, m.shape[1]
    kprev = kref.llg_field_planes(m, w, pv, h0)
    yx = (m[0] + 0.5 * DT * kprev[0]).contiguous()
    out = {}
    for wdt in (torch.float32, torch.bfloat16):
        label = f"field_tiled N={n} W={str(wdt).split('.')[-1]}"
        w_k = w.to(wdt)
        errs, rel = [], []
        for c in (0.0, 0.5 * DT, DT):
            yc = (m[0] + c * kprev[0]).contiguous()
            kt = sto_step.field_tiled(m, yc, kprev, w_k, pv, c, h_in=h0)
            ktp = sto_step.field_tiled_plain(m, yc, kprev, w_k, pv, c, h0)
            torch.cuda.synchronize()
            errs.append((kt - ktp).abs().max().item())
            rel.append(errs[-1] / ktp.abs().max().item())
            assert rel[-1] <= SLOPE_RTOL, f"{label} (c={c}) differs by {rel[-1]} (relative)"
        del kt, ktp, yc
        coupling = coupling_check(
            label,
            lambda w_: sto_step.field_tiled(m, yx, kprev, w_, pv, 0.5 * DT, h_in=h0),
            lambda w_: sto_step.field_tiled_plain(m, yx, kprev, w_, pv, 0.5 * DT, h0),
            w_k, launch_config=sto_step.field_launch_config,
        )
        # one stage: W, m, k_prev and the drive and x-plane read, k written
        gemm, epi = 2.0 * n * n * e, EPILOGUE_FLOPS * n * e
        nbytes = n * n * w_k.element_size() + 3 * (3 * n * e * 4) + 2 * n * e * 4 + 10 * e * 4
        b_ms, b_by = bound_ms(name, gemm, epi, nbytes, wdt == torch.bfloat16)
        x = yx.to(wdt)
        kern = lambda: sto_step.field_tiled(m, yx, kprev, w_k, pv, 0.5 * DT, h_in=h0)  # noqa: E731
        before = sto_step.LAUNCHES["round_bf16"]
        kern()
        rounds = sto_step.LAUNCHES["round_bf16"] - before
        assert rounds == (wdt == torch.bfloat16), f"{label}: round_bf16 launched {rounds} times"
        ms, host_ms, sleep_ms = queued_ms(kern, 50)
        row = dict(
            max_abs_err=max(errs),
            max_rel_err=max(rel),
            ms=ms,
            plain_ms=queued_ms(
                lambda: sto_step.field_tiled_plain(m, yx, kprev, w_k, pv, 0.5 * DT, h0), 10
            )[0],
            bound_ms=b_ms,
            bound_by=b_by,
            library_ms=queued_ms(lambda: torch.matmul(w_k, x), 50)[0],
            timing="queued_ms: 50 calls behind a device-side sleep",
            host_queue_ms=host_ms,
            sleep_ms=sleep_ms,
            single_call_ms=time_ms(kern, 20),
        )
        # the tensor-rate operations beside a bytes bound (bf16)
        row["ops_bound_ms"] = 1e3 * (gemm / peaks(name)[1 if wdt == torch.bfloat16 else 0]
                                     + epi / peaks(name)[0])
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["vs_library"] = row["ms"] / row["library_ms"]
        row.update(coupling)
        row["launch"] = field_launch_config(n_p, wdt)
        del x
        if step:
            tol = STATE_ATOL if wdt == torch.float32 else BF16_ATOL
            before = dict(sto_step.LAUNCHES)
            st = sto_step.rk4_tiled_step(m, w_k, pv, DT, h_in=h0)
            launches = sto_step.LAUNCHES["field_tiled"] - before["field_tiled"]
            rounds = sto_step.LAUNCHES["round_bf16"] - before["round_bf16"]
            sp = sto_step.rk4_tiled_step_plain(m, w_k, pv, DT, h0)
            torch.cuda.synchronize()
            err = (st - sp).abs().max().item()
            assert err <= tol, f"rk4_tiled_step W={wdt} differs from its plain version by {err}"
            assert launches == 4, f"rk4_tiled_step launched field_tiled {launches} times"
            assert rounds == (wdt == torch.bfloat16), f"rk4_tiled_step: round_bf16 x{rounds}"
            del st, sp
            stepc = coupling_check(
                f"rk4_tiled_step W={wdt}",
                lambda w_: sto_step.rk4_tiled_step(m, w_, pv, DT, h_in=h0),
                lambda w_: sto_step.rk4_tiled_step_plain(m, w_, pv, DT, h0),
                w_k, launch_config=sto_step.field_launch_config,
            )
            step_fn = lambda: sto_step.rk4_tiled_step(m, w_k, pv, DT, h_in=h0)  # noqa: E731
            st_ms, st_host, st_sleep = queued_ms(step_fn, 50)
            row["rk4_tiled_step"] = dict(
                max_abs_err=err,
                atol=tol,
                field_tiled_launches=launches,
                round_bf16_launches=rounds,
                ms=st_ms,
                four_field_tiled_ms=4 * row["ms"],
                over_four_field_tiled_us=1e3 * (st_ms - 4 * row["ms"]),
                # ~170 torch launches a call: 3 calls stay inside the card's launch queue
                plain_ms=queued_ms(lambda: sto_step.rk4_tiled_step_plain(m, w_k, pv, DT, h0), 3)[0],
                host_queue_ms=st_host,
                sleep_ms=st_sleep,
                single_call_ms=time_ms(step_fn, 20),
                **stepc,
            )
        del w_k
        print(f"kernel {label}: " + json.dumps(row), flush=True)
        out[wdt] = row
    out[torch.float32]["bf16_w"] = out[torch.bfloat16]
    return out[torch.float32]


def round_row(name, x):
    """round_bf16_kernel on the tiled step's (N, E) x-plane against torch's
    cast, which also rounds to nearest even: bit-equal. Timed queued, as the
    field_tiled rows; the plain version and the library call are both
    x.to(bf16), timed apart."""
    y = sto_step._round_bf16(x)
    ref = x.to(torch.bfloat16)
    torch.cuda.synchronize()
    err = (y.float() - ref.float()).abs().max().item()
    assert torch.equal(y, ref), f"round_bf16 differs from torch's cast by {err}"
    # each value read in f32 and written in bf16; one conversion a value
    b_ms, b_by = bound_ms(name, 0.0, x.numel(), x.numel() * (4 + 2), False)
    ms, host_ms, sleep_ms = queued_ms(lambda: sto_step._round_bf16(x), 50)
    row = dict(
        max_abs_err=err,
        ms=ms,
        plain_ms=queued_ms(lambda: x.to(torch.bfloat16), 50)[0],
        bound_ms=b_ms,
        bound_by=b_by,
        library_ms=queued_ms(lambda: x.to(torch.bfloat16), 50)[0],
        timing="queued_ms: 50 calls behind a device-side sleep",
        host_queue_ms=host_ms,
        sleep_ms=sleep_ms,
        shape=list(x.shape),
    )
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    row["vs_library"] = row["ms"] / row["library_ms"]
    print("kernel round_bf16: " + json.dumps(row), flush=True)
    return row


def plain_bshd(q, k, v, window, causal=True):
    t = lambda x: x.transpose(1, 2)  # noqa: E731
    return t(fa.flash_attention_plain(t(q), t(k), t(v), causal, window))


def row_rel_err(out, ref):
    """The largest over rows (one position of one head) of max|out - ref| /
    max|ref|; rows of ref that are all zero count against 1e-30."""
    o, r = out.float(), ref.float()
    return ((o - r).abs().amax(-1) / r.abs().amax(-1).clamp_min(1e-30)).max().item()


def plain_masked(q, k, v, mask):
    """Plain attention (model layout, f32 sums) under an explicit (Sq, Sk)
    key mask, for the planted faults."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    qg = q.float().reshape(b, sq, kvh, h // kvh, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * d**-0.5
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("bhgqk,bkhd->bqhgd", p, v.float()).reshape(b, sq, h, d).to(q.dtype)


def check_planted_faults(q, k, v, ref, window, dtype):
    """The plain version with a wrong band must fail the row measure: the
    window one key too wide, and the KV tile holding each row's first
    window key dropped (a loop that starts one tile late)."""
    sq, sk = q.shape[1], k.shape[1]
    bk = fa.kv_tile(q.shape[-1])
    qi = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    ki = torch.arange(sk, device=q.device)[None, :]
    first = qi - window + 1
    band = (ki <= qi) & (ki >= first)
    faults = {
        "window one key too wide": (ki <= qi) & (ki >= first - 1),
        "edge tile dropped": band & ~((first > 0) & (ki // bk == first // bk)),
    }
    out = {}
    for label, mask in faults.items():
        bad = plain_masked(q, k, v, mask)
        out[label] = dict(row_rel_err=row_rel_err(bad, ref),
                          max_abs_err=(bad.float() - ref.float()).abs().max().item())
        del bad
        assert out[label]["row_rel_err"] > FLASH_RTOL[dtype], (
            f"planted fault '{label}' passes the row measure: {out[label]}"
        )
    print(f"flash {sq}x{sk} planted faults vs plain (each must exceed rtol "
          f"{FLASH_RTOL[dtype]}): " + json.dumps(out), flush=True)
    return out


def flash_config(name):
    """The bf16 kernel's tile as the library reports it, against the Python
    mirror, and ptxas's registers and spills for every instantiation."""
    import ctypes

    out = {}
    for d in fa.HEAD_DIMS:
        cfg = (ctypes.c_int * 4)()
        assert _build.load().flash_bf16_config(d, cfg) == 0, d
        mirror = [fa.ROWS, fa.kv_tile(d), fa.ring_depth(d), fa.smem_bytes(d)]
        assert list(cfg) == mirror, f"flash_bf16<{d}>: library {list(cfg)} != mirror {mirror}"
        out[d] = dict(rows=cfg[0], kv_tile=cfg[1], ring=cfg[2], dynamic_smem_bytes=cfg[3],
                      ptxas_bf16=ptxas_info(_build.BUILD_LOG, f"flash_bf16ILi{d}E"),
                      ptxas_f32=ptxas_info(_build.BUILD_LOG, f"flash_f32ILi{d}E"))
    print(f"flash kernel tiles and ptxas ({name}): " + json.dumps(out), flush=True)
    return out


def tile_summary(h, kvh, d, sq, sk, window, batch=1, causal=True):
    """The bf16 kernel's launch at one shape as the Python mirror
    (fa.tile_plan, fa.tile_work) plans it: worked out here, not read from
    the card, so it is printed on a line of its own and kept out of the
    kernels line."""
    plan = fa.tile_plan(h // kvh, sq, d)
    work = list(fa.tile_work(plan, batch, kvh, sq, sk, causal, window))
    tiles = [w.kv1 - w.kv0 for w in work]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return dict(positions_per_tile=plan.positions, heads_per_tile=plan.heads, blocks=len(work),
                waves_one_block_an_sm=len(work) / sms, kv_tile=plan.kv_tile, ring=plan.ring,
                kv_tiles=sum(tiles), kv_tiles_per_sm=sum(tiles) / sms, kv_tiles_min=min(tiles),
                kv_tiles_max=max(tiles), first_launched=tiles[0],
                computed_flop=4.0 * d * fa.ROWS * plan.kv_tile * sum(tiles))


def sdpa_flash(qt, kt, vt, causal=True):
    """SDPA with is_causal (Sq = Sk), or without a mask, and the backend that
    ran: for bf16 the flash backend, with enable_gqa where it takes it, else
    K/V repeated here, outside the call that is timed; for f32 (which that
    backend refuses) PyTorch's own choice."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    sdpa = torch.nn.functional.scaled_dot_product_attention
    g = qt.shape[1] // kt.shape[1]
    if qt.dtype != torch.bfloat16:
        return lambda: sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True), "PyTorch's default"
    try:
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
            try:
                sdpa(qt, kt, vt, is_causal=causal, enable_gqa=g > 1)
                fn = lambda: sdpa(qt, kt, vt, is_causal=causal, enable_gqa=g > 1)  # noqa: E731
                how = "flash backend" + (", enable_gqa" if g > 1 else "")
            except RuntimeError:
                kr, vr = (x.repeat_interleave(g, dim=1) for x in (kt, vt))
                fn = lambda: sdpa(qt, kr, vr, is_causal=causal)  # noqa: E731
                how = "flash backend, K/V repeated outside the timed call"
                fn()
    except RuntimeError as err:  # the flash backend refuses these inputs (a head dim)
        fn = lambda: sdpa(qt, kt, vt, is_causal=causal, enable_gqa=g > 1)  # noqa: E731
        return fn, ("PyTorch's default choice: the flash backend refused these inputs ("
                    + str(err).strip().splitlines()[0][:160] + ")")

    def run():
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
            return fn()

    return run, how


def flash_case(name, arch, sq, sk, dtype, window, head_dim=None, v_dim=None, batch=1,
               causal=True):
    """One flash case: the kernel vs its plain version, timed beside the plain
    version and one SDPA call, with its bound and tile plan. head_dim
    overrides the config's (MLA's dn + dr); with v_dim, v's columns from
    v_dim on are zero (MLA's padded v), and so must the output's be; batch
    rows and causal=False (an encoder's or a cross-attention's call: no
    mask) as the caller's path gives them."""
    dev = torch.device("cuda")
    cfg = get_config(arch)
    h, kvh, d = cfg.num_heads, cfg.num_kv_heads, head_dim or cfg.head_dim
    fp32, tensor, bw = peaks(name)
    g = torch.Generator(device=dev).manual_seed(sq * 7 + sk + d)
    q = torch.randn((batch, sq, h, d), generator=g, device=dev).to(dtype)
    k = torch.randn((batch, sk, kvh, d), generator=g, device=dev).to(dtype)
    v = torch.randn((batch, sk, kvh, d), generator=g, device=dev).to(dtype)
    if v_dim is not None:
        v[..., v_dim:] = 0
    out = fa.flash_attention_bshd(q, k, v, causal=causal, window=window)
    ref = plain_bshd(q, k, v, window, causal)
    torch.cuda.synchronize()
    if v_dim is not None:
        pad = out[..., v_dim:]
        assert torch.equal(pad, torch.zeros_like(pad)), (
            f"flash {arch} {sq}x{sk}: v's zero columns {v_dim}: came back non-zero "
            f"(max {pad.float().abs().max().item()})")
    err = (out.float() - ref.float()).abs().max().item()
    rel = row_rel_err(out, ref)
    assert err <= FLASH_ATOL[dtype] and rel <= FLASH_RTOL[dtype], (
        f"flash {arch} {sq}x{sk} {dtype}: max abs error {err} (atol {FLASH_ATOL[dtype]}), "
        f"row error {rel} (rtol {FLASH_RTOL[dtype]})"
    )
    faults = None
    if sq > window > 0:  # the band bites
        faults = check_planted_faults(q, k, v, ref, window, dtype)
    flops = 4.0 * batch * h * d * fa.band_pairs(sq, sk, causal, window)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    rate = tensor if dtype == torch.bfloat16 else fp32
    t_ops, t_bytes = flops / rate, nbytes / bw
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if window:
        qi = torch.arange(sq, device=dev)[:, None] + (sk - sq)
        ki = torch.arange(sk, device=dev)[None, :]
        mask = (ki <= qi) & (ki > qi - window)
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=mask, enable_gqa=True
        )
        how = "explicit band mask (PyTorch's masked path)"
    else:
        sdpa, how = sdpa_flash(qt, kt, vt, causal)
    lib = sdpa().transpose(1, 2)
    torch.cuda.synchronize()
    lib_err = (lib.float() - ref.float()).abs().max().item()
    del ref, lib
    kern = lambda: fa.flash_attention_bshd(q, k, v, causal=causal, window=window)  # noqa: E731
    ms, host_ms, sleep_ms = queued_ms(kern, 50)
    case = dict(
        arch=arch, batch=batch, heads=h, kv_heads=kvh, head_dim=d, sq=sq, sk=sk,
        causal=causal, dtype=str(dtype).split(".")[-1], window=window, max_abs_err=err,
        row_rel_err=rel, atol=FLASH_ATOL[dtype], rtol=FLASH_RTOL[dtype],
        ms=ms,
        single_call_ms=time_ms(kern, 20),
        plain_ms=time_ms(lambda: plain_bshd(q, k, v, window, causal), 3),
        bound_ms=1e3 * max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        library_ms=queued_ms(sdpa, 20)[0],
        library=how,
        library_max_abs_err=lib_err,
        timing="ms and library_ms: queued_ms (calls behind a device-side sleep); "
               "single_call_ms: CUDA events around one call",
        host_queue_ms=host_ms,
        sleep_ms=sleep_ms,
    )
    case["share_of_bound"] = case["bound_ms"] / case["ms"]
    case["vs_library"] = case["ms"] / case["library_ms"]
    if v_dim is not None:  # the FLOPs of P.V at v's own width, no padded columns
        pairs = batch * fa.band_pairs(sq, sk, causal, window)
        case["v_dim"] = v_dim
        case["gflop_as_launched"] = flops / 1e9
        case["gflop_v_own_width"] = 2.0 * h * pairs * (d + v_dim) / 1e9
        case["bound_ms_v_own_width"] = max(1e3 * 1e9 * case["gflop_v_own_width"] / rate,
                                           1e3 * t_bytes)
        case["pad_columns_exactly_zero"] = True
    if dtype == torch.bfloat16:
        plan = tile_summary(h, kvh, d, sq, sk, window, batch, causal)
        print(f"flash {arch} {sq}x{sk} tile plan (the Python mirror fa.tile_plan / "
              f"fa.tile_work, not read from the card): " + json.dumps(plan), flush=True)
    if faults:
        case["planted_faults"] = faults
    print("kernel flash_attention: " + json.dumps(case), flush=True)
    del q, k, v, out
    torch.cuda.empty_cache()
    return case


def check_flash(name):
    """The flash kernel vs its plain version at h2o-danube's prefill shapes
    and gemma-7b's. Returns the kernels-line row: the 4608-token bf16 case's
    numbers (row 4), the largest error over the cases, row 4b under
    "no_window", row 4c under "gemma_7b" and every case under "cases"."""
    config = flash_config(name)
    cases = [flash_case(name, LM_ARCH, *c) for c in FLASH_CASES]
    no_window = flash_case(name, LM_ARCH, *FLASH_NO_WINDOW)
    gemma = flash_case(name, GEMMA_ARCH, *GEMMA_CASE)
    main = next(c for c in cases if c["sq"] == max(PROMPTS) and c["dtype"] == "bfloat16")
    keys = ("ms", "single_call_ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library",
            "share_of_bound")
    row = {k: main[k] for k in keys}
    every = cases + [no_window, gemma]
    row["max_abs_err"] = max(c["max_abs_err"] for c in every)
    row["row_rel_err"] = max(c["row_rel_err"] for c in every)
    row["no_window"] = {k: no_window[k] for k in keys}
    row["gemma_7b"] = {k: gemma[k] for k in keys}
    row["config"] = config
    row["cases"] = every
    return row


def _prompt_len(batch):
    """Rows of a prefill batch's decoder input: its tokens, or its
    inputs_embeds."""
    return (batch["tokens"] if "tokens" in batch else batch["inputs_embeds"]).shape[1]


def teacher_forced_margins(model, params, cfg, req, tokens, rows=LM_SLOTS, stop=None,
                           inputs=None, capacity=CAPACITY):
    """Run `req` alone, teacher-forced on `tokens`, decoding `rows` rows with
    the request in row 0. At rows = LM_SLOTS this is the engine's decode
    geometry: the prefill spliced into slot 0 of a zeroed cache of
    `capacity` rows, the other slots idle at position 0, as the engine's
    idle slots are; every operation of a decode step is row-wise, so the
    request's row meets the same kernels (the same GEMM shapes) as in the
    engine and should agree with it bit for bit. At rows = 1 the prefill's
    cache is padded to `capacity`. `inputs`, where given, is the prefill
    batch in place of req's token prompt (whisper's encoder frames beside its
    tokens, whose cross cache then has the frames' rows; llava's
    inputs_embeds). Per step, the gap between the step's maximum logit and
    the chosen token's (0 where the chosen token is the argmax); with
    `stop`, the run ends after the first decode step at which stop() is true,
    and that step's gap is not taken."""
    batch = inputs if inputs is not None else {"tokens": req.prompt[None].cuda()}
    n = _prompt_len(batch)
    last, seq_cache = model.prefill(params, batch)
    if rows == 1:
        caches = transformer.pad_caches(cfg, seq_cache, capacity)
    else:
        kw = {"enc_seq": batch["encoder_frames"].shape[1]} if "encoder_frames" in batch else {}
        caches = transformer.tree_map(
            lambda spec: torch.zeros(spec.shape, dtype=spec.dtype, device="cuda"),
            model.cache_specs(rows, capacity, **kw),
        )
        _splice_cache(caches, seq_cache, 0)
    step_tokens = torch.zeros((rows, 1), dtype=torch.long, device="cuda")
    pos = torch.zeros((rows,), dtype=torch.long, device="cuda")
    logits, gaps = last[0, -1, : cfg.vocab_size], []
    for j, tok in enumerate(tokens):
        assert torch.isfinite(logits).all(), f"request {getattr(req, 'rid', req)}: logits not finite"
        gaps.append((logits.max() - logits[tok]).item())
        if j + 1 < len(tokens):
            step_tokens[0, 0] = tok
            pos[0] = n + j
            lg, caches = model.decode_step(params, step_tokens, caches, pos)
            logits = lg[0, -1, : cfg.vocab_size]
            if stop is not None and stop():
                break
    return gaps


def serve_lm(name_power):
    """Phase 5; returns the flash kernel's launches in the engine run."""
    cfg = get_config(LM_ARCH)
    model = build_model(cfg, device="cuda")
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    sizes = []
    transformer.tree_map(lambda t: sizes.append(t.numel()), params)
    n_params = sum(sizes)
    print(
        f"lm {LM_ARCH}: {n_params} parameters (count_params {counting.count_params(cfg)}), "
        f"init on the card {time.perf_counter() - t0:.3f} s",
        flush=True,
    )
    rng = np.random.default_rng(0)
    reqs = [
        Request(i, torch.from_numpy(rng.integers(0, cfg.vocab_size, n)), MAX_NEW)
        for i, n in enumerate(PROMPTS)
    ]
    # warm-up (cuBLAS handles, allocator) on two short requests, not counted
    Engine(cfg, params, num_slots=2, capacity=64, device="cuda").run(
        [Request(0, reqs[-1].prompt[:32], 2), Request(1, reqs[-1].prompt[:16], 2)]
    )
    eng = Engine(cfg, params, num_slots=LM_SLOTS, capacity=CAPACITY, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sto_step.reset_launches()
    t0 = time.perf_counter()
    results = eng.run(list(reqs))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(sto_step.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    assert sorted(results) == [r.rid for r in reqs], f"served {sorted(results)}"
    for r in reqs:
        toks = results[r.rid]
        assert len(toks) == MAX_NEW and all(0 <= t < cfg.vocab_size for t in toks), (r.rid, toks)
    want = cfg.num_layers * len(PROMPTS)
    assert launches["flash_attention"] == want, f"flash launches {launches} != {want}"
    assert not any(launches[k] for k in STO_KERNELS), f"STO kernels launched: {launches}"
    st = eng.stats
    print(
        f"serve lm {LM_ARCH}: {len(reqs)} requests, {sum(map(len, results.values()))} tokens in "
        f"{seconds:.3f} s; prefill {st.prefill_tokens} tokens in {st.prefill_seconds:.3f} s = "
        f"{st.prefill_tokens / st.prefill_seconds:.1f} tok/s; decode {st.decode_steps} steps, "
        f"{st.decode_tokens} tokens in {st.decode_seconds:.3f} s = "
        f"{st.decode_tokens / st.decode_seconds:.1f} tok/s; peak memory {peak / 2**30:.3f} GiB; "
        f"launches {launches} ({name_power})",
        flush=True,
    )

    for rows, limit in ((LM_SLOTS, 0.0), (1, LOGIT_MARGIN)):
        gaps = [g for r in reqs
                for g in teacher_forced_margins(model, params, cfg, r, results[r.rid], rows)]
        worst, off = max(gaps), sum(g > 0 for g in gaps)
        print(f"serve lm vs each request alone (teacher-forced, {rows}-row decode): worst logit "
              f"margin {worst:.4e} (at most {limit}); steps off the argmax {off} of {len(gaps)}",
              flush=True)
        assert worst <= limit, f"engine vs per-request margin {worst} > {limit} ({rows} rows)"

    # one 4608-token prefill: its time (CUDA events), then where its device
    # time goes, the flash kernel's share measured inside it (profiler)
    batch = {"tokens": reqs[0].prompt[None].cuda()}
    prefill_ms = time_ms(lambda: model.prefill(params, batch), 3)
    print(f"prefill {len(reqs[0].prompt)} tokens: {prefill_ms:.3f} ms ({name_power})", flush=True)
    dryrun_prefill_check(cfg, model, params, reqs[0].prompt, prefill_ms, name_power)
    busy_us, flash_us = trace("prefill 4608 tokens", lambda: model.prefill(params, batch),
                              name_power, match="flash")
    print(
        f"prefill {len(reqs[0].prompt)} tokens, traced: flash kernel {flash_us / 1e3:.3f} ms of "
        f"{busy_us / 1e3:.3f} ms device time = {100 * flash_us / busy_us:.1f} % ({name_power})",
        flush=True,
    )
    tokens = torch.ones((LM_SLOTS, 1), dtype=torch.long, device="cuda")
    pos = torch.tensor([n - 1 for n in PROMPTS[:LM_SLOTS]], device="cuda")  # a full batch
    decode_ms = time_ms(lambda: model.decode_step(params, tokens, eng.caches, pos), 5)
    print(f"decode step, batch {LM_SLOTS}, capacity {CAPACITY}: {decode_ms:.3f} ms ({name_power})",
          flush=True)
    trace(f"decode step batch {LM_SLOTS}", lambda: model.decode_step(params, tokens, eng.caches, pos),
          name_power)
    return launches["flash_attention"]


def trace(label, fn, name_power, top=8, match=None):
    """torch.profiler over one call of fn after a warm-up: host wall time,
    the device's busy time (sum of kernel self times, one stream) and share,
    and the kernels that take the most device time. The profiler adds host
    overhead, so the busy share is a lower bound. Returns the busy time and
    the device time of the kernels whose name holds `match` (us)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    dev_us = lambda e: getattr(e, "self_device_time_total", None) or getattr(  # noqa: E731
        e, "self_cuda_time_total", 0.0
    )
    # device-side events only (kernels, memcpy, memset): an operator's own
    # device time repeats that of the kernels it launched
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    busy_us = sum(dev_us(e) for e in events)
    kernels = sorted(events, key=dev_us, reverse=True)[:top]
    print(
        f"trace {label}: wall {wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms "
        f"({100 * busy_us / wall_us:.1f} %), {sum(e.count for e in events)} device ops; top: "
        + "; ".join(f"{e.key[:60]} x{e.count} {dev_us(e) / 1e3:.3f} ms" for e in kernels)
        + f" ({name_power})",
        flush=True,
    )
    matched = sum(dev_us(e) for e in events if match and match in e.key)
    return busy_us, matched


def make_sessions(rng, learn=False):
    """512 NARMA-10 streams of 16-40 ticks (disjoint windows of one series),
    per-tenant params on every fourth, a readout (random, from the seed) on
    every one; with learn, each also carries its NARMA-10 targets (the
    readout then warm-starts the learned weights)."""
    base = constants.default_params(device="cpu")
    u_all, y_all = tasks.narma_series(SESSIONS * 40, order=10, seed=0)
    sessions = []
    for sid in range(SESSIONS):
        t = int(rng.integers(16, 41))
        u = u_all[sid * 40 : sid * 40 + t]
        params = None
        if sid % 4 == 0:
            params = base._replace(
                current=torch.tensor(rng.uniform(2.0e-3, 3.0e-3)),
                a_in=torch.tensor(rng.uniform(0.5, 1.5)),
            )
        w_out = rng.normal(0.0, 1.0 / math.sqrt(N), (N + 1, 1)).astype(np.float32)
        sess = StreamSession(sid=sid, u_seq=u, params=params, readout=Readout(torch.from_numpy(w_out), 0))
        if learn:
            sess.targets = y_all[sid * 40 : sid * 40 + t]
            sess.learn_washout = LEARN_WASHOUT
        sessions.append(sess)
    return sessions


def serve(spec, backend, interpret=False, precision=None):
    eng = ReservoirEngine(
        spec, num_slots=E, chunk_ticks=K, backend=backend, interpret=interpret,
        precision=precision, device="cuda",
    )
    sessions = make_sessions(np.random.default_rng(0))
    sto_step.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = eng.run(sessions)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(sto_step.LAUNCHES)
    assert len(results) == SESSIONS, f"{backend}: {len(results)} of {SESSIONS} sessions returned"
    for sess in sessions:
        r = results[sess.sid]
        assert r.error is None, r.error
        assert r.states.shape == (sess.u_seq.shape[0], N), (sess.sid, r.states.shape)
        assert r.outputs.shape == (sess.u_seq.shape[0], 1)
        for a in (r.states, r.outputs, r.final_m):
            assert np.isfinite(a).all(), f"{backend}: session {sess.sid} not finite"
    return results, seconds, launches, sessions


def serve_learning(spec, backend, learn, name_power):
    """One learning engine run over the 512 sessions, launch counters set to
    0 before it; every session returns finite states, predictions, learned
    readout and online NMSE. Returns (results, sessions, launches)."""
    eng = ReservoirEngine(
        spec, num_slots=E, chunk_ticks=K, backend=backend, learn=learn,
        learn_reg=LEARN_REG, learn_mu=LEARN_MU, device="cuda",
    )
    sessions = make_sessions(np.random.default_rng(0), learn=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sto_step.reset_launches()
    t0 = time.perf_counter()
    results = eng.run(sessions)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(sto_step.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    del eng
    torch.cuda.empty_cache()
    assert len(results) == SESSIONS, f"{backend}/{learn}: {len(results)} of {SESSIONS} sessions"
    for sess in sessions:
        r = results[sess.sid]
        t = sess.u_seq.shape[0]
        assert r.error is None, r.error
        assert r.learned_readout is not None and r.learned_readout.w_out.shape == (N + 1, 1)
        assert r.predictions.shape == (t, 1) and r.states.shape == (t, N)
        for a in (r.states, r.predictions, r.learned_readout.w_out.numpy()):
            assert np.isfinite(a).all(), f"{backend}/{learn}: session {sess.sid} not finite"
        assert r.learn_nmse is not None and np.isfinite(r.learn_nmse), (sess.sid, r.learn_nmse)
    nmse = np.median([results[s.sid].learn_nmse for s in sessions])
    print(
        f"serve backend={backend} learn={learn}: {SESSIONS} sessions in {seconds:.3f} s = "
        f"{SESSIONS / seconds:.1f} sessions/s, median online NMSE {nmse:.4f}, peak memory "
        f"{peak / 2**30:.3f} GiB, launches {launches} ({name_power})",
        flush=True,
    )
    return results, sessions, launches


def replay(group, results, learn):
    """The learned W of each (slot, session) in `group` again, from its
    harvested states, at the engine's width E on the card: each session in
    the lane it was served in, its ticks in blocks of K from its admission
    (a session is admitted at a chunk boundary), its readout as the warm
    start, its first LEARN_WASHOUT ticks masked, every other lane masked.
    Rows past a session's end hold zeros where the engine's frozen lane
    held its last state: a masked row's gain is exactly 0, so neither
    reaches the lane's P or W."""
    s_dim = N + 1
    if learn == "rls":
        p, w = krls.rls_init(E, s_dim, 1, LEARN_REG, torch.float32, device="cuda")
    else:
        p, w = None, krls.lms_init(E, s_dim, 1, torch.float32, device="cuda")
    rows = K * max(-(-sess.u_seq.shape[0] // K) for _, sess in group)
    xb = torch.zeros((rows, E, s_dim))
    y = torch.zeros((rows, E, 1))
    lmask = torch.zeros((rows, E), dtype=torch.bool)
    for slot, sess in group:
        t = sess.u_seq.shape[0]
        xb[:t, slot, :N] = torch.from_numpy(results[sess.sid].states)
        xb[:t, slot, N] = 1.0
        y[:t, slot] = torch.from_numpy(sess.targets)
        lmask[LEARN_WASHOUT:t, slot] = True
        w[slot] = sess.readout.w_out.cuda()
    xb, y, lmask = xb.cuda(), y.cuda(), lmask.cuda()
    for c in range(0, rows, K):
        if learn == "rls":
            p, w, _ = krls.rls_chunk(p, w, xb[c : c + K], y[c : c + K], lmask[c : c + K], 1.0)
        else:
            w, _ = krls.lms_chunk(w, xb[c : c + K], y[c : c + K], lmask[c : c + K], LEARN_MU)
    w = w.cpu()
    return {sess.sid: w[slot] for slot, sess in group}


def check_learned(results, sessions, learn, label):
    """Every session's learned W: bit-equal to its replay at the engine's
    width (sessions that shared a lane replay in turns; one session once
    more alone), and within ORACLE_RTOL of the E = 1 oracle."""
    by_slot = {}
    for sess in sessions:
        by_slot.setdefault(results[sess.sid].slot, []).append(sess)
    replayed = {}
    for r in range(max(map(len, by_slot.values()))):
        replayed.update(replay([(k, v[r]) for k, v in by_slot.items() if len(v) > r], results, learn))
    first = sessions[0]
    replayed_alone = replay([(results[first.sid].slot, first)], results, learn)[first.sid]
    assert torch.equal(replayed_alone, replayed[first.sid]), f"{label}: lone replay differs"
    worst = 0.0
    for sess in sessions:
        w = results[sess.sid].learned_readout.w_out
        assert torch.equal(w, replayed[sess.sid]), (
            f"{label}: session {sess.sid} learned W differs from its engine-width replay by "
            f"{(w - replayed[sess.sid]).abs().max().item():.3e}"
        )
        states = torch.from_numpy(results[sess.sid].states).cuda()
        w0 = sess.readout.w_out
        if learn == "rls":
            one = fit_rls(states, sess.targets, washout=LEARN_WASHOUT, reg=LEARN_REG, block=K, w0=w0)
        else:
            one = fit_lms(states, sess.targets, washout=LEARN_WASHOUT, mu=LEARN_MU, w0=w0)
        one = one.w_out.cpu()
        worst = max(worst, ((w - one).abs().max() / one.abs().max()).item())
    assert worst <= ORACLE_RTOL[learn], f"{label}: learned W vs E=1 oracle {worst} > {ORACLE_RTOL[learn]}"
    print(
        f"learn {label}: {len(sessions)} learned W bit-equal to their replay at E={E} "
        f"({len(by_slot)} lanes); worst max|W - W(E=1 oracle)| / max|W| {worst:.3e} "
        f"(at most {ORACLE_RTOL[learn]})",
        flush=True,
    )


def tail_times(spec, impl, learn, name_power):
    """CUDA-event ms of one K-tick chunk at the serving shape, inference
    only and learning, and of the learn tail alone on that chunk's states,
    beside the tail's bound: its inputs read once and outputs written once
    (RLS: P in and P' out; NLMS: the features, W in and W' out) over the
    card's memory rate."""
    kw = dict(impl=impl, ensemble=E, chunk_ticks=K)
    infer = compile_plan(spec, ExecPlan(**kw), device="cuda")
    learner = compile_plan(
        spec, ExecPlan(learn=learn, learn_reg=LEARN_REG, learn_mu=LEARN_MU, **kw), device="cuda"
    )
    g = torch.Generator(device="cuda").manual_seed(0)
    m = ops.to_planes(spec.m0.expand(E, N, 3)).contiguous()
    u = 0.5 * torch.rand((K, E, 1), generator=g, device="cuda")
    y = torch.rand((K, E, 1), generator=g, device="cuda")
    mask = torch.ones((K, E), dtype=torch.bool, device="cuda")
    p, w = learner.init_learn_state()
    _, states = infer.tick_chunk(m, u, lane_mask=mask)
    if learn == "rls":
        tail = lambda: compiled._learn_chunk_tail(states, y, mask, p, w, 1.0)  # noqa: E731
        nbytes = 2 * p.numel() * p.element_size()
    else:
        tail = lambda: compiled._lms_chunk_tail(states, y, mask, w, LEARN_MU)  # noqa: E731
        nbytes = 4 * (K * E * (N + 1) + 2 * w.numel())
    infer_ms = time_ms(lambda: infer.tick_chunk(m, u, lane_mask=mask), 3)
    learn_ms = time_ms(
        lambda: learner.tick_chunk(m, u, lane_mask=mask, targets=y, learn_state=(p, w)), 3
    )
    tail_ms = time_ms(tail, 3)
    trace(f"learn tail {learn}", tail, name_power, top=6)
    bound = 1e3 * nbytes / peaks(torch.cuda.get_device_name(0))[2]
    print(
        f"learn tail {learn} behind impl={impl} at N={N}, E={E}, K={K}: chunk {infer_ms:.3f} ms "
        f"inference only, {learn_ms:.3f} ms learning; tail alone {tail_ms:.3f} ms = "
        f"{100 * tail_ms / learn_ms:.1f} % of the learning chunk (bound {bound:.3f} ms, bytes) "
        f"({name_power})",
        flush=True,
    )


def learning_phase(spec, name_power):
    """Phase 3b: online learning on the card, and the scan oracle."""
    runs = {}
    for backend, learn, kern in (("chunk", "rls", "rk4_chunk"), ("tiled", "lms", "field_tiled"),
                                 ("scan", "rls", None)):
        results, sessions, launches = serve_learning(spec, backend, learn, name_power)
        if kern is None:
            assert not any(launches.values()), f"scan launched STO kernels: {launches}"
        else:
            assert launches[kern] > 0, f"{backend}/{learn} never launched {kern}: {launches}"
        check_learned(results, sessions, learn, f"{backend}/{learn}")
        runs[backend] = results
    worst = max(
        np.abs(runs["scan"][s.sid].states - runs["chunk"][s.sid].states).max() for s in sessions
    )
    assert worst <= STATE_ATOL, f"scan vs chunk states {worst} > {STATE_ATOL}"
    print(f"serve scan vs chunk (learning runs): max |state| diff {worst:.3e} (atol {STATE_ATOL})",
          flush=True)
    del runs
    tail_times(spec, "chunk", "rls", name_power)
    tail_times(spec, "tiled", "lms", name_power)
    torch.cuda.empty_cache()


def ladder_spec(n, spec, dev):
    """A solo SimSpec of n oscillators on dev: W from make_coupling_matrix
    below N, the smoke's spec's at N, and from a torch.Generator on dev as
    device_inputs makes it above N or at N without a spec."""
    if n == N and spec is not None:
        w = spec.w_cp.to(dev)
    elif n < N:
        w = torch.as_tensor(coupling.make_coupling_matrix(n, seed=0)).to(dev)
    else:
        g = torch.Generator(device=dev).manual_seed(0)
        w = (2.0 * torch.rand((n, n), generator=g, device=dev) - 1.0) * math.sqrt(3.0 / n)
        w.fill_diagonal_(0.0)
    return SimSpec(
        params=constants.default_params(device=dev),
        w_cp=w,
        w_in=torch.as_tensor(coupling.make_input_matrix(n, 1, seed=1)).to(dev),
        m0=constants.initial_magnetization(n, device=dev),
        dt=DT,
        hold_steps=HOLD,
    )


def ladder(spec, name_power):
    """Phase 3c: ms per RK4 step of integrate_python_loop, integrate_scan and
    the fused kernel (CompiledSim.integrate, impl="fused", E = 1; on the host
    CPU its plain version) over LADDER_N, on the card and on the host CPU."""
    line = {}
    for dev in ("cuda", "cpu"):
        for n in LADDER_N:
            sp = ladder_spec(n, spec, dev)
            steps = 40 if dev == "cuda" else (5 if n > N else 20)
            field = lambda m, _, sp=sp: sto.llg_field(m, sp.params, sp.w_cp)  # noqa: E731
            sim = compile_plan(sp, ExecPlan(impl="fused"), device=dev)
            runs = {
                "python_loop": lambda: integrators.integrate_python_loop(field, sp.m0, DT, steps),
                "scan": lambda: integrators.integrate_scan(field, sp.m0, DT, steps),
                "fused": lambda: sim.integrate(steps),
            }
            for name, fn in runs.items():
                fn()
                if dev == "cuda":
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn()
                if dev == "cuda":
                    torch.cuda.synchronize()
                ms = 1e3 * (time.perf_counter() - t0) / steps
                m_t = out if name == "python_loop" else out[0]
                assert torch.isfinite(m_t).all(), (dev, n, name)
                line[(dev, n, name)] = ms
            del sp, sim, runs
    cols = ("python_loop", "scan", "fused")
    for dev, label in (("cuda", "card"), ("cpu", "host CPU")):
        print(
            f"ladder ms per RK4 step, {label} (python loop / scan / fused kernel): "
            + "; ".join(f"N={n} " + " / ".join(f"{line[(dev, n, c)]:.4f}" for c in cols) for n in LADDER_N)
            + (f" ({name_power})" if dev == "cuda" else f" ({os.cpu_count()} CPUs)"),
            flush=True,
        )
    print(
        "ladder card over host CPU (python loop / scan / fused): "
        + "; ".join(
            f"N={n} " + " / ".join(f"{line[('cpu', n, c)] / line[('cuda', n, c)]:.2f}x" for c in cols)
            for n in LADDER_N
        )
        + f" ({name_power})",
        flush=True,
    )


# -- phase 3: where the engine's host time goes --------------------------------
# engine method -> span label; the script wraps these on one engine instance
# (and tick_chunk on its CompiledSim, the readout and host-copy helpers in the
# engine's module) for the traced runs only: the engine carries no spans
ENGINE_SPANS = {
    "_assemble_chunk": "assemble",
    "_retire_finishers": "retire",
    "_admit_pending": "admit",
    "_launch_chunk": "launch (upload, masks)",
    "_harvest_chunk": "harvest (slicing)",
    "_scan_for_nonfinite": "nan guard",
    "_finalize_awaiting": "finalize",
}
# the STO kernels' symbols, as the profiler names their launches
STO_KERNEL_SYMBOLS = ("rk4_coop_kernel", "field_stage_kernel", "round_bf16_kernel")
SPAN_ORDER = ("assemble", "retire", "admit", "launch (upload, masks)", "tick_chunk", "readout",
              "host copy", "host copy wait", "harvest (slicing)", "nan guard", "finalize")


class Spans:
    """Inclusive and exclusive perf_counter seconds per label, each wrapped
    call also a torch.profiler.record_function span."""

    def __init__(self):
        self.incl, self.excl, self.calls, self.stack = {}, {}, {}, []

    def wrap(self, label, fn):
        from torch.profiler import record_function

        def inner(*args, **kwargs):
            self.stack.append(0.0)
            t0 = time.perf_counter()
            try:
                with record_function(label):
                    return fn(*args, **kwargs)
            finally:
                dt = time.perf_counter() - t0
                child = self.stack.pop()
                self.incl[label] = self.incl.get(label, 0.0) + dt
                self.excl[label] = self.excl.get(label, 0.0) + dt - child
                self.calls[label] = self.calls.get(label, 0) + 1
                if self.stack:
                    self.stack[-1] += dt

        return inner


def instrument(eng, spans):
    """Wrap one engine's boundary methods, its CompiledSim's tick_chunk and
    the engine module's readout and host-copy helpers in `spans`. Returns a
    function that restores the module's helpers and the CompiledSim (which
    PLAN_CACHE shares with every engine of the same spec and plan)."""
    from repro_torch.serve import reservoir as mod

    for meth, label in ENGINE_SPANS.items():
        setattr(eng, meth, spans.wrap(label, getattr(eng, meth)))
    eng.sim.tick_chunk = spans.wrap("tick_chunk", eng.sim.tick_chunk)
    readout, base = mod._apply_readouts_chunk, mod._HostCopy

    class TracedHostCopy(base):
        def __init__(self, tensors):
            spans.wrap("host copy", base.__init__)(self, tensors)

        def numpy(self):
            return spans.wrap("host copy wait", base.numpy)(self)

    mod._apply_readouts_chunk = spans.wrap("readout", readout)
    mod._HostCopy = TracedHostCopy

    def restore():
        mod._apply_readouts_chunk, mod._HostCopy = readout, base
        del eng.sim.tick_chunk

    return restore


def traced_run(spec, backend, sessions, profiled):
    """One engine run of `sessions` with the spans on, under torch.profiler
    when `profiled`. Returns (spans, wall seconds, chunks, profiler or None)."""
    from torch.profiler import ProfilerActivity, profile

    eng = ReservoirEngine(spec, num_slots=E, chunk_ticks=K, backend=backend, device="cuda")
    spans = Spans()
    restore = instrument(eng, spans)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if profiled else None
    try:
        torch.cuda.synchronize()
        if prof is not None:
            prof.__enter__()
        t0 = time.perf_counter()
        eng.run(sessions)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
        restore()
    return spans, wall, spans.calls.get("tick_chunk", 0), prof


def host_ops_by_span(prof, top=3):
    """The profiler's host operations by self CPU time (us), each charged to
    the innermost span label above it ("outside" when none is)."""
    labels = set(SPAN_ORDER)
    by = {}
    for ev in prof.events():
        if ev.name in labels or getattr(ev, "device_type", None) is None:
            continue
        if str(ev.device_type).endswith("CUDA"):
            continue
        up, label = getattr(ev, "cpu_parent", None), "outside"
        while up is not None:
            if up.name in labels:
                label = up.name
                break
            up = getattr(up, "cpu_parent", None)
        key = (label, ev.name)
        by[key] = by.get(key, 0.0) + ev.self_cpu_time_total
    out = {}
    for (label, name), us in sorted(by.items(), key=lambda kv: -kv[1]):
        out.setdefault(label, [])
        if len(out[label]) < top:
            out[label].append((name, us))
    return out


def trace_engine(spec, backend, name_power):
    """Phase 3's host trace of one engine run: first with the spans alone
    (perf_counter, exclusive ms per chunk of each span; the rest of the wall
    is the run loop outside every span), then again under torch.profiler:
    the device's busy share and the top host operations of each span by
    self CPU time. Returns the exclusive seconds per span of the first run."""
    make = lambda: make_sessions(np.random.default_rng(0))  # noqa: E731
    spans, wall, chunks, _ = traced_run(spec, backend, make(), False)
    spans.excl["outside every span"] = wall - sum(spans.excl.values())
    print(
        f"trace engine {backend}: {chunks} chunks in {1e3 * wall:.3f} ms = "
        f"{1e3 * wall / chunks:.3f} ms a chunk (no profiler); exclusive ms a chunk: "
        + "; ".join(f"{k} {1e3 * spans.excl[k] / chunks:.3f}" for k in (*SPAN_ORDER, "outside every span")
                    if k in spans.excl)
        + f" ({name_power})",
        flush=True,
    )
    _, pwall, _, prof = traced_run(spec, backend, make(), True)
    from torch.autograd import DeviceType

    dev_us = lambda e: getattr(e, "self_device_time_total", None) or getattr(  # noqa: E731
        e, "self_cuda_time_total", 0.0
    )
    # the spans' record_function labels also appear on the device timeline,
    # spanning the device work they enqueued: left out, or it counts twice
    device = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                     and dev_us(e) > 0 and e.key not in SPAN_ORDER), key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in device)
    kernel = sum(dev_us(e) for e in device if any(k in e.key for k in STO_KERNEL_SYMBOLS))
    print(
        f"trace engine {backend} (profiler): wall {1e3 * pwall:.3f} ms, device busy "
        f"{busy / 1e3:.3f} ms ({100 * busy / (1e6 * pwall):.1f} %), of which the STO kernel "
        f"{kernel / 1e3:.3f} ms; top device ops: "
        + "; ".join(f"{e.key[:48]} x{e.count} {dev_us(e) / 1e3:.3f} ms" for e in device[:6])
        + "; top host ops by self CPU time per span: "
        + " | ".join(
            f"{label}: " + ", ".join(f"{n} {us / 1e3:.3f} ms" for n, us in ops)
            for label, ops in host_ops_by_span(prof).items()
        )
        + f" ({name_power})",
        flush=True,
    )
    return spans.excl, chunks


# -- phase 3d: the engine's lifecycle at full width ---------------------------------


class Check:
    """Time one lifecycle check on the card and count its kernel launches."""

    def __init__(self, label):
        self.label = label

    def __enter__(self):
        torch.cuda.synchronize()
        sto_step.reset_launches()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.seconds = time.perf_counter() - self.t0
        self.launches = {k: v for k, v in sto_step.LAUNCHES.items() if v}
        return False


def same_results(got, want, sids, w_outs=None, learn=False):
    """(max |diff| of states and final_m, of outputs, of learned W and of
    predictions relative to their max magnitude, bit-equal?) over `sids`;
    each held within STATE_ATOL, STATE_ATOL x ||w_out||_1 and, for learners,
    ORACLE_RTOL["rls"]."""
    ds = do = dw = dp = 0.0
    exact = True
    for sid in sids:
        a, b = got[sid], want[sid]
        assert a.error is None and b.error is None, (a.error, b.error)
        pairs = [(a.states, b.states), (a.final_m, b.final_m)]
        for x, y in pairs:
            ds = max(ds, float(np.abs(x - y).max()))
            exact = exact and np.array_equal(x, y)
        if w_outs is not None:
            do_s = float(np.abs(a.outputs - b.outputs).max())
            assert do_s <= STATE_ATOL * np.abs(w_outs[sid]).sum(), (sid, do_s)
            do, exact = max(do, do_s), exact and np.array_equal(a.outputs, b.outputs)
        if learn:
            wa, wb = a.learned_readout.w_out, b.learned_readout.w_out
            dw = max(dw, ((wa - wb).abs().max() / wb.abs().max()).item())
            dp = max(dp, float(np.abs(a.predictions - b.predictions).max() / np.abs(b.predictions).max()))
            exact = exact and torch.equal(wa, wb) and np.array_equal(a.predictions, b.predictions)
    assert ds <= STATE_ATOL, f"states/final_m differ by {ds} > {STATE_ATOL}"
    assert max(dw, dp) <= ORACLE_RTOL["rls"], f"learned W / predictions differ by {dw} / {dp}"
    return ds, do, max(dw, dp), exact


def held(exact):
    return "bit-equal" if exact else "within tolerance"


def w_outs_of(sessions):
    return {s.sid: s.readout.w_out.numpy() for s in sessions}


def step_check(spec, backend, kernel, name_power):
    """3d.1: a step() loop against run(chunk_ticks=1), 64 sessions at E."""
    rng_sessions = lambda: make_sessions(np.random.default_rng(0))[:64]  # noqa: E731
    ran = ReservoirEngine(spec, num_slots=E, chunk_ticks=1, backend=backend, device="cuda").run(
        rng_sessions()
    )
    eng = ReservoirEngine(spec, num_slots=E, backend=backend, device="cuda")
    sessions = rng_sessions()
    for s in sessions:
        eng.submit(s)
    ticks = 0
    with Check("step") as c:
        while eng.scheduler.has_work():
            eng.step()
            ticks += 1
    assert c.launches.get(kernel, 0) > 0, f"step() on {backend} never launched {kernel}: {c.launches}"
    ds, do, _, exact = same_results(eng.results, ran, [s.sid for s in sessions], w_outs_of(sessions))
    print(
        f"3d.1 step() vs run(chunk_ticks=1), backend={backend}: 64 sessions, {ticks} ticks in "
        f"{c.seconds:.3f} s, max |state| diff {ds:.3e}, max |output| diff {do:.3e}: {held(exact)}; "
        f"launches {c.launches} ({name_power})",
        flush=True,
    )


def push_check(spec, name_power):
    """3d.2: 32 push streams, their first half at submit, the rest through
    append_ticks at a later boundary, against each served in one piece."""
    kw = dict(num_slots=E, chunk_ticks=K, backend="chunk", device="cuda")
    whole = make_sessions(np.random.default_rng(0))[:32]
    w_outs = w_outs_of(whole)
    want = ReservoirEngine(spec, **kw).run(whole)
    eng = ReservoirEngine(spec, **kw)
    parts = make_sessions(np.random.default_rng(0))[:32]
    rests = {}
    with Check("push") as c:
        for s in parts:
            half = s.u_seq.shape[0] // 2
            rests[s.sid] = s.u_seq[half:]
            s.u_seq, s.open = s.u_seq[:half], True
            eng.submit(s)
        eng.run()  # every stream idle and resident
        ticks = eng.tick_count
        assert not eng.step_chunk() and eng.tick_count == ticks, "an all-idle boundary advanced"
        assert not eng.results and len(eng.scheduler.running) == 32
        for s in parts:
            eng.append_ticks(s.sid, rests[s.sid])
            eng.close_session(s.sid)
        got = eng.run()
    ds, do, _, exact = same_results(got, want, [s.sid for s in whole], w_outs)
    print(
        f"3d.2 push streams: 32 sessions in two pushes vs one piece (chunk, E={E}, K={K}): "
        f"{c.seconds:.3f} s, max |state| diff {ds:.3e}, max |output| diff {do:.3e}: "
        f"{held(exact)}; launches {c.launches} ({name_power})",
        flush=True,
    )


def checkpoint_check(spec, name_power):
    """3d.3: RLS learners behind chunk checkpointed after two chunks and
    restored into a second engine of the same width; and snapshots after
    every chunk of a live engine. Both against an uninterrupted run."""
    kw = dict(num_slots=E, chunk_ticks=K, backend="chunk", learn="rls", learn_reg=LEARN_REG,
              device="cuda")
    make = lambda: make_sessions(np.random.default_rng(0), learn=True)[:16]  # noqa: E731
    want = ReservoirEngine(spec, **kw).run(make())
    with Check("checkpoint") as c:
        src = ReservoirEngine(spec, **kw)
        sessions = make()
        for s in sessions:
            src.submit(s)
        src.step_chunk()
        src.step_chunk()
        moved = [s.sid for s in sessions if s.u_seq.shape[0] > 2 * K][-4:]
        ckpts = [src.checkpoint_session(sid) for sid in moved]
        dst = ReservoirEngine(spec, **kw)
        for ck in ckpts:
            assert ck.t == 2 * K and ck.P.shape == (N + 1, N + 1)
            dst.restore_session(ck)
        got = {**src.run(), **dst.run()}
        del src, dst
    assert sorted(got) == sorted(want)
    slots = [(want[sid].slot, got[sid].slot) for sid in moved]
    ds, _, dw, exact = same_results(got, want, sorted(want), learn=True)
    print(
        f"3d.3 checkpoint/restore: 4 of 16 RLS learners after {2 * K} ticks, lanes "
        f"{slots} (before, after): {c.seconds:.3f} s, max |state| diff {ds:.3e}, learned W and "
        f"predictions {dw:.3e} of their max: {held(exact)}; launches {c.launches} ({name_power})",
        flush=True,
    )
    with Check("snapshot") as c:
        eng = ReservoirEngine(spec, **kw)
        for s in make():
            eng.submit(s)
        snaps = 0
        while eng.step_chunk():
            snaps += len(eng.snapshot_sessions())
        got = eng.results
        del eng
    ds, _, dw, exact = same_results(got, want, sorted(want), learn=True)
    assert exact, f"a snapshot perturbed the streams: states {ds}, W {dw}"
    print(
        f"3d.3 snapshot_sessions after every chunk ({snaps} checkpoints): {c.seconds:.3f} s, "
        f"every stream bit-equal to the unsnapshotted run; launches {c.launches} ({name_power})",
        flush=True,
    )
    torch.cuda.empty_cache()


def autoscale_run(spec, learn, name_power, prewarm=True, start=E // 4, warm_start=False):
    """One autoscaling engine (E / 4 ... E slots from `start`, backend auto)
    under a burst of 512 sessions, then a lull in which 8 more arrive one
    chunk apart; warm_start: `prewarm(block=True)` before serving. Returns
    (results, sessions, stats, widths seen, peak GiB, Check, calls, prewarm
    errors); calls holds, for each step_chunk call that launched a chunk,
    (width, rescaled, cold, stall s, the launch's host s, the launched
    chunk's device ms from CUDA events around it, the caching allocator's
    new segments (cudaMalloc calls) and the garbage collector's pause s
    during the call)."""
    kw = dict(learn=learn, learn_reg=LEARN_REG) if learn else {}
    eng = ReservoirEngine(spec, num_slots=start, chunk_ticks=K, autoscale=True,
                          min_slots=E // 4, max_slots=E, device="cuda", prewarm=prewarm, **kw)
    if warm_start:
        eng.prewarm(block=True)
    sessions = make_sessions(np.random.default_rng(0), learn=bool(learn))
    late = make_sessions(np.random.default_rng(0), learn=bool(learn))[:8]
    for i, s in enumerate(late):
        s.sid = SESSIONS + i
    widths = [(eng.num_slots, eng.backend)]
    calls, launched = [], []
    launch = eng._launch_chunk

    def timed_launch(plan):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t0 = time.perf_counter()
        ev[0].record()
        launch(plan)
        ev[1].record()
        launched.append((time.perf_counter() - t0, ev))

    eng._launch_chunk = timed_launch

    gc_pause = [0.0, 0.0]  # seconds so far, start of the running collection

    def on_gc(phase, info):
        if phase == "start":
            gc_pause[1] = time.perf_counter()
        else:
            gc_pause[0] += time.perf_counter() - gc_pause[1]

    def segments():
        return torch.cuda.memory_stats().get("segment.all.allocated", 0)

    def step():
        w0, st = eng.num_slots, eng.scheduler.stats
        cold0, stall0, seg0, gc0 = st.cold_rescales, st.rescale_stall_s, segments(), gc_pause[0]
        launched.clear()
        more = eng.step_chunk()
        if launched:
            calls.append((eng.num_slots, eng.num_slots != w0, st.cold_rescales != cold0,
                          st.rescale_stall_s - stall0, *launched[0], segments() - seg0,
                          gc_pause[0] - gc0))
        if widths[-1] != (eng.num_slots, eng.backend):
            widths.append((eng.num_slots, eng.backend))
        return more

    torch.cuda.reset_peak_memory_stats()
    gc.callbacks.append(on_gc)
    try:
        with Check(f"autoscale {learn}") as c:
            for s in sessions:
                eng.submit(s)
            while step():
                pass
            for s in late:
                eng.submit(s)
                step()
            while step():
                pass
            if eng._prewarm_thread is not None:
                eng._prewarm_thread.join()
    finally:
        gc.callbacks.remove(on_gc)
    peak = torch.cuda.max_memory_allocated() / 2**30
    calls = [(*c[:5], c[5][0].elapsed_time(c[5][1]), *c[6:]) for c in calls]
    results, stats, errors = eng.results, eng.stats(), list(eng.prewarm_errors)
    del eng._launch_chunk  # the wrapper holds the engine: no cycle keeps its planes alive
    del eng
    torch.cuda.empty_cache()
    assert len(results) == SESSIONS + 8, len(results)
    assert stats.grows >= 1 and stats.shrinks >= 1, (stats.grows, stats.shrinks)
    return results, sessions + late, stats, widths, peak, c, calls, errors


def autoscale_check(spec, name_power):
    """3d.4: autoscale under a burst and a lull, against one fixed-width
    E = 256 run; then once more with learn="rls". Returns the fixed run's
    results."""
    fixed_sessions = make_sessions(np.random.default_rng(0))
    late = make_sessions(np.random.default_rng(0))[:8]
    for i, s in enumerate(late):
        s.sid = SESSIONS + i
    fixed = ReservoirEngine(spec, num_slots=E, chunk_ticks=K, device="cuda").run(fixed_sessions + late)
    for learn in (None, "rls"):
        results, sessions, stats, widths, peak, c, _, errors = autoscale_run(spec, learn, name_power)
        assert not errors, errors
        ds, do, _, exact = same_results(
            results, fixed, [s.sid for s in sessions], None if learn else w_outs_of(sessions)
        )
        outs = "states and final_m only" if learn else f"max |output| diff {do:.3e}"
        extra = ""
        if learn:
            worst = 0.0
            for s in sessions[:8]:
                r = results[s.sid]
                one = fit_rls(torch.from_numpy(r.states).cuda(), s.targets, washout=LEARN_WASHOUT,
                              reg=LEARN_REG, block=K, w0=s.readout.w_out).w_out.cpu()
                w = r.learned_readout.w_out
                assert np.isfinite(w.numpy()).all()
                worst = max(worst, ((w - one).abs().max() / one.abs().max()).item())
            assert worst <= ORACLE_RTOL["rls"], worst
            extra = f", learned W vs the E=1 oracle (8 sessions) {worst:.3e} of max|W|"
        print(
            f"3d.4 autoscale learn={learn}: {len(results)} sessions in {c.seconds:.3f} s, widths "
            + " -> ".join(f"{e} ({impl})" for e, impl in widths)
            + f", grows {stats.grows}, shrinks {stats.shrinks}, cold rescales "
            f"{stats.cold_rescales}, warm {stats.warm_rescales}, stall {stats.rescale_stall_s:.4f} s, "
            f"peak memory {peak:.3f} GiB; vs fixed E={E}: max |state| diff {ds:.3e}, {outs}: "
            f"{held(exact)}{extra}; launches {c.launches} ({name_power})",
            flush=True,
        )
    return fixed


def launcher_check(name_power, extras=([], ["--learn", "rls"]), label="3d.5"):
    """3d.5: the port's launcher in reservoir mode at the full width (3g(f):
    with --autotune-budget, whose `washout autotune:` line must print)."""
    from repro_torch.launch import serve as launch_serve

    argv = ["--mode", "reservoir", "--n", str(N), "--slots", str(E), "--sessions", str(SESSIONS),
            "--ticks", "40", "--hold-steps", str(HOLD), "--chunk-ticks", str(K)]
    for extra in extras:
        out = io.StringIO()
        with Check("launcher") as c, contextlib.redirect_stdout(out):
            results = launch_serve.main(argv + extra)
        print(out.getvalue(), end="", flush=True)
        assert len(results) == SESSIONS, len(results)
        for r in results.values():
            assert r.error is None and np.isfinite(r.final_m).all()
            if extra:
                assert np.isfinite(r.learn_nmse) and r.predictions.shape == (40, 1)
            else:
                assert r.outputs.shape == (30, 1) and np.isfinite(r.outputs).all()
        if "--autotune-budget" in extra:
            budget = extra[extra.index("--autotune-budget") + 1]
            assert f"washout autotune: {budget} probes on the live engine" in out.getvalue()
        print(f"{label} launcher {' '.join(argv + extra)}: {c.seconds:.3f} s, launches "
              f"{c.launches} ({name_power})", flush=True)


def lifecycle_phase(spec, name_power):
    """Phase 3d: the engine's lifecycle at N = 2500, E = 256, K = 8."""
    t0 = time.perf_counter()
    step_check(spec, "chunk", "rk4_chunk", name_power)
    step_check(spec, "tiled", "field_tiled", name_power)
    push_check(spec, name_power)
    checkpoint_check(spec, name_power)
    fixed = autoscale_check(spec, name_power)
    launcher_check(name_power)
    print(f"phase 3d: {time.perf_counter() - t0:.1f} s", flush=True)
    return fixed

# -- phase 3e: the plan cache and the persisted dispatch table ----------------------

# impl -> the kernel its engine launches (the winner of a measurement)
IMPL_KERNEL = {"chunk": "rk4_chunk", "fused": "rk4_fused", "tiled": "field_tiled"}


def cache_child(directory):
    """Phase 3e(b)'s child process: pin the kernel build directory to
    `directory`, build or load the library there, then pay the first
    dispatch of tiled (after aot) and of fused (without) at the smoke's
    shapes (N = 2500, E = 256, K = 8), three warmup chunks each. Prints one
    JSON object."""
    out = {}
    t0 = time.perf_counter()
    assert enable_persistent_cache(directory), directory
    _build.load()
    out["load_s"] = time.perf_counter() - t0
    out["nvcc"] = _build.BUILD_LOG is not None
    # the smoke's shapes; W from a generator on the card (make_coupling_matrix
    # takes seconds of host time at N = 2500, and the values change nothing
    # measured here)
    spec = ladder_spec(N, None, "cuda")
    torch.cuda.synchronize()
    for impl, aot in (("tiled", True), ("fused", False)):
        t0 = time.perf_counter()
        sim = compile_plan(
            spec, ExecPlan(impl=impl, ensemble=E, chunk_ticks=K, aot=aot,
                           compilation_cache_dir=directory), device="cuda",
        )
        compile_s = time.perf_counter() - t0
        warmups = []
        for _ in range(3):
            t0 = time.perf_counter()
            sim.warmup()
            warmups.append(time.perf_counter() - t0)
        out[impl] = dict(aot=aot, compile_s=compile_s, warmups_s=warmups)
    out["launches"] = {k: v for k, v in sto_step.LAUNCHES.items() if v}
    print(json.dumps(out), flush=True)


def cache_children(name_power):
    """3e(b): two processes pointed at one fresh directory: the first builds
    the library there with nvcc, the second only loads it."""
    import shutil
    import tempfile

    where = tempfile.mkdtemp(prefix="kernel-cache-", dir=str(_build.BUILD_DIR.parent))
    try:
        runs = []
        for _ in range(2):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--cache-child", where],
                capture_output=True, text=True, timeout=600,
            )
            wall = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(f"cache child failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
            runs.append((wall, json.loads(proc.stdout.strip().splitlines()[-1])))
    finally:
        shutil.rmtree(where, ignore_errors=True)
    (wall_a, a), (wall_b, b) = runs
    assert a["nvcc"] and not b["nvcc"], (a["nvcc"], b["nvcc"])
    for label, wall, r in (("first process (nvcc into the fresh directory)", wall_a, a),
                           ("second process (loads the library built there)", wall_b, b)):
        print(
            f"3e(b) {label}: process {wall:.3f} s, build/load {r['load_s']:.3f} s; "
            + "; ".join(
                f"{impl}{' after aot' if r[impl]['aot'] else ''}: compile_plan "
                f"{1e3 * r[impl]['compile_s']:.3f} ms, warmup chunks "
                + " / ".join(f"{1e3 * x:.3f}" for x in r[impl]["warmups_s"]) + " ms"
                for impl in ("tiled", "fused")
            )
            + f"; launches {r['launches']} ({name_power})",
            flush=True,
        )


def rescale_costs(calls):
    """Per rescale: (width, cold?, stall ms, the first chunk's launch host ms
    and device ms at the new width, the medians of the later chunks at that
    width (host, device), how many, the rescaling call's new allocator
    segments and gc pause ms)."""
    med = lambda xs: sorted(xs)[len(xs) // 2] if xs else float("nan")  # noqa: E731
    out = []
    for i, (width, rescaled, cold, stall, host, dev_ms, segs, gc_s) in enumerate(calls):
        if not rescaled:
            continue
        later = [c for j, c in enumerate(calls) if c[0] == width and not c[1] and j > i]
        out.append((width, cold, 1e3 * stall, 1e3 * host, dev_ms,
                    med([1e3 * c[4] for c in later]), med([c[5] for c in later]), len(later),
                    segs, 1e3 * gc_s))
    return out


def plan_cache_phase(spec, fixed, name_power):
    """Phase 3e: the plan cache and the persisted dispatch table at N = 2500,
    E = 256, K = 8."""
    from repro_torch.api import PLAN_CACHE
    from repro_torch.api import cache as plan_cache
    from repro_torch.kernels import dispatch_table

    t_phase = time.perf_counter()
    # (a) aot: the library, launch configuration and shared-memory attribute
    # without a launch
    for impl, precision in (("chunk", None), ("fused", None), ("tiled", None),
                            ("tiled", "bf16_coupling")):
        sto_step.reset_launches()
        t0 = time.perf_counter()
        compile_plan(spec, ExecPlan(impl=impl, ensemble=E, chunk_ticks=K, precision=precision,
                                    aot=True), device="cuda")
        seconds = time.perf_counter() - t0
        launched = {k: v for k, v in sto_step.LAUNCHES.items() if v}
        assert not launched, f"aot launched {launched}"
        print(f"3e(a) compile_plan(impl={impl}, precision={precision}, aot=True): "
              f"{1e3 * seconds:.3f} ms, launches 0 ({name_power})", flush=True)

    # (b) a cold nvcc build into a fresh directory against a load from it
    cache_children(name_power)

    # (c) two engines over one spec and plan share one CompiledSim; the
    # structural hash of the card's spec, and a lookup given that digest
    # (an engine hashes its template once and passes it to every rescale's
    # and prewarm's lookups)
    t0 = time.perf_counter()
    digest = plan_cache.spec_structural_hash(spec)
    hash_s = time.perf_counter() - t0
    probe = ExecPlan(impl="chunk", ensemble=E, chunk_ticks=K)
    t0 = time.perf_counter()
    PLAN_CACHE.is_warm(spec, probe, device="cuda", spec_hash=digest)
    lookup_s = time.perf_counter() - t0
    print(f"3e(c) spec_structural_hash of the N={N} spec on the card: {1e3 * hash_s:.3f} ms "
          f"(W copied off the card and hashed); a PLAN_CACHE lookup given the digest "
          f"{1e6 * lookup_s:.1f} us ({name_power})", flush=True)
    before = PLAN_CACHE.stats.snapshot()
    a = ReservoirEngine(spec, num_slots=E, chunk_ticks=K, backend="chunk", device="cuda")
    b = ReservoirEngine(spec, num_slots=E, chunk_ticks=K, backend="chunk", device="cuda")
    assert a.sim is b.sim
    print(f"3e(c) two engines, one CompiledSim; PLAN_CACHE after phases 3-3d: {before}; "
          f"entries {len(PLAN_CACHE)}; after the two engines: hits "
          f"{PLAN_CACHE.stats.hits - before['hits']} more", flush=True)
    del a, b

    # (d) 3d.4's autoscale run with and without the prewarm thread, each from
    # an empty cache; then from E / 2 slots after prewarm(block=True), so that
    # both rescales land on prewarmed buckets
    got = {}
    for prewarm, start in ((True, E // 4), (False, E // 4), ("warm start", E // 2)):
        PLAN_CACHE.clear()
        w0 = PLAN_CACHE.stats.warmup_seconds
        results, sessions, stats, widths, peak, c, calls, errors = autoscale_run(
            spec, None, name_power, prewarm=bool(prewarm), start=start,
            warm_start=prewarm == "warm start",
        )
        assert not errors, f"prewarm errors: {errors}"
        got[prewarm] = results
        ds, do, _, exact = same_results(results, fixed, [s.sid for s in sessions],
                                        w_outs_of(sessions))
        costs = "; ".join(
            f"-> {w} ({'cold' if cold else 'warm'}): stall {stall:.3f} ms (the call made "
            f"{segs} new allocator segments, gc paused {gc_ms:.3f} ms), first chunk's launch "
            f"{host:.3f} ms host / {dev:.3f} ms device vs the later {k} at {w}: {h_med:.3f} / "
            f"{d_med:.3f} ms (medians)"
            for w, cold, stall, host, dev, h_med, d_med, k, segs, gc_ms in rescale_costs(calls)
        )
        print(
            f"3e(d) autoscale prewarm={prewarm}, from {start} slots: {c.seconds:.3f} s, widths "
            + " -> ".join(f"{e} ({impl})" for e, impl in widths)
            + f", cold rescales {stats.cold_rescales}, warm {stats.warm_rescales}, stall "
            f"{1e3 * stats.rescale_stall_s:.3f} ms, warmup chunks "
            f"{1e3 * (PLAN_CACHE.stats.warmup_seconds - w0):.3f} ms, prewarm_errors []; "
            f"per rescale: {costs}; peak memory {peak:.3f} GiB; vs fixed "
            f"E={E}: max |state| diff "
            f"{ds:.3e}, max |output| diff {do:.3e}: {held(exact)}; launches {c.launches} "
            f"({name_power})",
            flush=True,
        )
    sids = sorted(got[True])
    for sid in sids:
        x, y = got[True][sid], got[False][sid]
        assert all(np.array_equal(p, q) for p, q in ((x.states, y.states), (x.final_m, y.final_m),
                                                    (x.outputs, y.outputs))), sid
    print(f"3e(d) prewarm=True vs prewarm=False: {len(sids)} sessions bit-equal", flush=True)
    warm = [c[1] for c in rescale_costs(calls)]
    assert warm and not any(warm), "a rescale of the warm-started engine was cold"

    # (e) the measured dispatch table: per-impl ms, the memo, save / load
    import tempfile

    winners = {}
    for precision in (None, "bf16_coupling"):
        h0 = PLAN_CACHE.stats.measure_hits
        t0 = time.perf_counter()
        timings = PLAN_CACHE.measure(N, E, dt=DT, chunk_ticks=K, precision=precision,
                                     device="cuda")
        seconds = time.perf_counter() - t0
        assert "failed" not in timings, timings
        again = PLAN_CACHE.measure(N, E, dt=DT, chunk_ticks=K, precision=precision,
                                   device="cuda")
        assert again is timings and PLAN_CACHE.stats.measure_hits == h0 + 1
        winners[precision] = min(timings, key=timings.get)
        print(f"3e(e) PLAN_CACHE.measure N={N} E={E} K={K} precision={precision}: "
              + ", ".join(f"{k} {1e3 * v:.3f} ms" for k, v in timings.items())
              + f" a chunk of 8-step holds -> {winners[precision]} ({seconds:.3f} s; the "
              f"second call hit the memo) ({name_power})", flush=True)
    with tempfile.TemporaryDirectory(dir=str(_build.BUILD_DIR.parent)) as tmp:
        path = dispatch_table.save_table(os.path.join(tmp, "dispatch_table.cuda.json"), "cuda")
        ops.clear_latency_table()
        assert ops.choose_impl(N, E, platform="cuda") == ("fused" if ops.fused_fits_l2(
            ops._round_up(N, ops.BLOCK_N), E) else "tiled")
        loaded = dispatch_table.load_table(path, platform="cuda")
    for precision, winner in winners.items():
        assert ops.choose_impl(N, E, platform="cuda", precision=precision) == winner
        sto_step.reset_launches()
        eng = ReservoirEngine(spec, num_slots=E, chunk_ticks=K, precision=precision,
                              device="cuda")
        assert eng.backend == winner, (eng.backend, winner)
        eng.run(make_sessions(np.random.default_rng(0))[:32])
        torch.cuda.synchronize()
        assert sto_step.LAUNCHES[IMPL_KERNEL[winner]] > 0, dict(sto_step.LAUNCHES)
        print(f"3e(e) after save_table / clear / load_table ({loaded} entries): choose_impl "
              f"precision={precision} -> {winner}; an auto engine launched "
              f"{IMPL_KERNEL[winner]} x{sto_step.LAUNCHES[IMPL_KERNEL[winner]]}", flush=True)
        del eng
    # a memo hit after the table was cleared registers the measured winner again
    ops.clear_latency_table()
    h0 = PLAN_CACHE.stats.measure_hits
    for precision, winner in winners.items():
        PLAN_CACHE.measure(N, E, dt=DT, chunk_ticks=K, precision=precision, device="cuda")
        assert ops.choose_impl(N, E, platform="cuda", precision=precision) == winner
    assert PLAN_CACHE.stats.measure_hits == h0 + len(winners)
    print(f"3e(e) after clear_latency_table, a PLAN_CACHE.measure memo hit registered "
          f"{winners} again", flush=True)
    ops.clear_latency_table()  # the later phases keep the L2 rule
    print(f"3e(c) PLAN_CACHE at the end of phase 3e: {PLAN_CACHE.stats.snapshot()}", flush=True)
    print(f"phase 3e: {time.perf_counter() - t_phase:.1f} s", flush=True)


# -- phase 3f: the physics families and mixed-spec tenancy at full width -----------

# 3f(a) and the interpret engine check run the delay line's plain body, eager
# torch on the card (~N x hold_steps RK4 steps of ~240 launches a tick), at
# this N; the kernel is held at the full N too
TM_SMALL_N = 256
TM_CPU_LANES = 8  # lanes of the full-N tick held against the host CPU
# array_transient's readout window (the reference smoke's, benchmarks/run.py:91)
AT_WINDOW = 3
# the ops of one RK4 step of one lane in the kernel (4 x 51 in the field, 18 in
# the stage updates, 21 in the combination), for the roofline bound
STEP_OPS = sto_step.STEP_OPS
# the family engines' expected kernels: (topology, impl, precision) -> kernels
FAMILY_RUNS = (
    ("time_multiplexed", "chunk", None, ("tm_delay_line",)),
    ("time_multiplexed", "chunk", "bf16_coupling", ("tm_delay_line",)),
    ("array_transient", "fused", None, ("rk4_fused",)),
    ("array_transient", "tiled", None, ("field_tiled",)),
    ("array_transient", "tiled", "bf16_coupling", ("field_tiled", "round_bf16")),
    ("array_transient", "chunk", None, ()),
)


def max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    )
    return 1e6 * float(out.stdout.strip().splitlines()[0])


def delay_line_inputs(n, dev, seed=0):
    """One tick's operands at n virtual nodes x E lanes: snapshots near the
    initial state, per-lane params (the current varied per lane), node
    drives in [0, 0.5)."""
    g = torch.Generator().manual_seed(seed)
    m = constants.initial_magnetization(n, device="cpu").expand(E, n, 3)
    m = m + 0.05 * torch.randn((E, n, 3), generator=g)
    m = ops.to_planes(m / m.norm(dim=-1, keepdim=True)).contiguous()
    params = broadcast_params(
        constants.default_params(device="cpu"), E, current=2e-3 + 1e-3 * torch.rand(E, generator=g)
    )
    pv = kref.pack_params(params, E)
    h = 0.5 * torch.rand((n, E), generator=g)
    return m.to(dev), pv.to(dev).contiguous(), h.to(dev)


def event_ms(fn):
    """(fn's result, ms of one call by CUDA events)."""
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    stop.synchronize()
    return out, start.elapsed_time(stop)


def plain_delay_line_graphed(s0, h_t, pvec, dt, hold_steps):
    """kref.tm_delay_line_plain, its RK4 step (kref.rk4_step_planes, the
    plain version's own ops) captured once as a CUDA graph and replayed N x
    hold_steps times: the same kernels in the same order on the same
    operands, so the same bits, at one host launch a step where the eager
    loop pays ~240. Returns the snapshots (3, N, E)."""
    dt_c = torch.full((), float(dt), dtype=s0.dtype)
    w_zero = torch.zeros((1, 1), dtype=s0.dtype, device=s0.device)
    s = s0.reshape(3, 1, -1).clone()
    h = h_t[0:1].clone()
    side = torch.cuda.Stream()  # warm the step up off the capture stream, as CUDA graphs ask
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kref.rk4_step_planes(s.clone(), w_zero, pvec, dt_c, h)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):  # capture records the step; s still holds s0
        s.copy_(kref.rk4_step_planes(s, w_zero, pvec, dt_c, h))
    snaps = torch.empty((3, h_t.shape[0], s.shape[-1]), dtype=s.dtype, device=s.device)
    for j in range(h_t.shape[0]):
        h.copy_(h_t[j:j + 1])
        for _ in range(hold_steps):
            graph.replay()
        snaps[:, j].copy_(s[:, 0])
    return snaps


def delay_line_check(name, name_power):
    """3f(a): tm_delay_line against its plain version. One K = 2 chunk at
    N = 256 (tm_chunk against tm_chunk_planes on the card, lanes frozen all
    chunk or for its second tick); one tick at N = 2500 against the plain
    version on the card (every lane) and on the host CPU (lanes 0-7), and
    with lanes 0-63 masked. Bit-equal required. The N = 2500 tick's plain
    version on the card replays its RK4 step from a CUDA graph
    (plain_delay_line_graphed; plain_ms is that replay's). Returns the
    kernel's row."""
    dev = torch.device("cuda")
    n, k = TM_SMALL_N, 2
    spec_s = make_time_multiplexed_spec(n, hold_steps=HOLD, device="cuda")
    m, pv, _ = delay_line_inputs(n, dev)
    g = torch.Generator(device=dev).manual_seed(1)
    hb = 0.5 * torch.rand((k, n, E), generator=g, device=dev)
    mask = torch.ones((k, E), dtype=torch.bool, device=dev)
    mask[:, :32] = False
    mask[1, 32:64] = False
    (mk, sk), kern_ms = event_ms(lambda: sto_step.tm_chunk(m, spec_s.w_cp, pv, DT, HOLD, hb, mask))
    (mp, sp), plain_ms = event_ms(
        lambda: kref.tm_chunk_planes(m, spec_s.w_cp, pv, DT, HOLD, hb, mask)
    )
    err = max((mk - mp).abs().max().item(), (sk - sp).abs().max().item())
    assert torch.equal(mk, mp) and torch.equal(sk, sp), f"tm_chunk differs from its plain body by {err}"
    assert torch.equal(mk[:, :, :32], m[:, :, :32]), "tm_chunk: frozen lanes changed"
    print(
        f"3f(a) tm_chunk vs tm_chunk_planes on the card, N={n}, E={E}, K={k}, hold {HOLD}: "
        f"max |diff| {err:.3e}, bit-equal, frozen lanes exact; kernel {kern_ms:.3f} ms, plain "
        f"{plain_ms / 1e3:.3f} s ({name_power})",
        flush=True,
    )
    del mk, sk, mp, sp
    m, pv, h = delay_line_inputs(N, dev, seed=2)
    kern = lambda: sto_step.tm_delay_line(m, h, pv, DT, HOLD)  # noqa: E731
    out = kern()
    # the plain version's step replayed from a CUDA graph (45-62 s eager)
    plain, plain_ms = event_ms(lambda: plain_delay_line_graphed(m[:, N - 1], h, pv, DT, HOLD))
    err = (out - plain).abs().max().item()
    assert torch.equal(out, plain), f"tm_delay_line differs from its plain version by {err}"
    lanes = TM_CPU_LANES
    t0 = time.perf_counter()
    cpu = kref.tm_delay_line_plain(
        m[:, N - 1, :lanes].cpu(), h[:, :lanes].cpu(), pv[:, :lanes].cpu(), DT, HOLD
    )
    cpu_s = time.perf_counter() - t0
    cpu_err = (out[:, :, :lanes].cpu() - cpu).abs().max().item()
    assert torch.equal(out[:, :, :lanes].cpu(), cpu), f"tm_delay_line vs the host CPU: {cpu_err}"
    frozen = torch.ones(E, device=dev)
    frozen[:64] = 0.0
    out_m = sto_step.tm_delay_line(m, h, pv, DT, HOLD, frozen)
    assert torch.equal(out_m[:, :, :64], m[:, :, :64]), "tm_delay_line: frozen lanes changed"
    assert torch.equal(out_m[:, :, 64:], out[:, :, 64:]), "tm_delay_line: a mask moved live lanes"
    # the kernel's division against __fdiv_rn: the lanes' numerators (hs_coef)
    # against every f32 denominator in [2^-32, 2], the inline division's range up to 2
    hs = pv[kref.PARAM_LAYOUT.index("hs_coef")].contiguous()
    t0 = time.perf_counter()
    div_bad, div_pairs = sto_step.tm_quotient_sweep(hs, 95 << 23, 0x40000001)
    div_s = time.perf_counter() - t0
    assert div_bad == 0, f"tm_delay_line's division differs from __fdiv_rn in {div_bad} quotients"
    ms = time_ms(kern, 5)
    card_ms = queued_ms(kern, 6)[0]
    steps = N * HOLD
    nbytes = 4 * (7 * N * E + 10 * E)  # m in and out, h; params
    b_ms, b_by = bound_ms(name, 0.0, float(STEP_OPS) * steps * E, nbytes, False)
    chain = delay_line_chain(steps, card_ms)
    row = dict(
        max_abs_err=err, ms=ms, card_ms=card_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, share_of_bound=b_ms / ms, cpu_lanes=lanes, cpu_max_abs_err=cpu_err,
        cpu_plain_s=cpu_s, bit_equal=True, frozen_lanes="exact", division_pairs=div_pairs,
        chain_bound_ms=chain["bound_ms"],
        share_of_chain_bound=None if chain["bound_ms"] is None else chain["bound_ms"] / card_ms,
        ptxas=ptxas_info(_build.BUILD_LOG, "tm_delay_line_kernel"),
    )
    print(
        f"3f(a) tm_delay_line at N={N}, E={E}, hold {HOLD} (one tick, {steps} RK4 steps a lane): "
        f"vs plain on the card max |diff| {err:.3e}, bit-equal; lanes 0-{lanes - 1} vs plain on "
        f"the host CPU {cpu_err:.3e}, bit-equal ({cpu_s:.3f} s); lanes 0-63 masked: exact; "
        f"its division bit-equal to __fdiv_rn over {div_pairs} pairs (the {hs.numel()} lanes' "
        f"hs_coef x every f32 in [2^-32, 2]; {div_s:.2f} s); "
        f"kernel {ms:.4f} ms per call, {card_ms:.4f} ms card, plain {plain_ms:.3f} ms on the "
        f"card (its RK4 step replayed from a CUDA graph); roofline bound {b_ms:.5f} ms ({b_by}), "
        f"{100 * b_ms / card_ms:.2f} % of the card time; chain bound "
        + (f"{chain['bound_ms']:.4f} ms, {100 * chain['bound_ms'] / card_ms:.1f} % of the card "
           "time" if chain["bound_ms"] is not None else "not measured")
        + f"; ptxas {row['ptxas']} "
        f"({name_power})",
        flush=True,
    )
    return row


def delay_line_chain(steps, card_ms):
    """The delay line's chain bound: the fast step loop's dependency chain
    recounted from the library's SASS and priced at the latencies measured
    on the card (sto_step.tm_latencies), both by
    tools/sto_sass_mix.delay_line_chain, over `steps` RK4 steps at the SM
    clock measured beside the latencies. Prints the latencies, the recount
    and the bound beside the kernel's card time; returns them (the bound
    None where the toolkit has no cuobjdump)."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools"))
    import sto_sass_mix

    lat = sto_step.tm_latencies()
    head = (
        "3f(a) tm_delay_line chain: latencies measured on the card, cycles from one result to "
        "the next (one warp, clock64): "
        + ", ".join(f"{k} {v:.2f}" for k, v in lat.items() if k != "clock_ghz")
        + f"; SM clock over those chains {lat['clock_ghz']:.3f} GHz (nvidia-smi max "
        f"{max_sm_clock_hz() / 1e9:.3f})"
    )
    if sto_sass_mix.cuobjdump() is None:
        print(f"{head}; no cuobjdump in the toolkit: the chain bound is not measured", flush=True)
        return dict(bound_ms=None, cycles_per_step=None, latencies=lat, sass=None)
    t0 = time.perf_counter()
    sass = sto_sass_mix.delay_line_chain(_build.build(), lat)
    sass_s = time.perf_counter() - t0
    cycles = sass["cycles_per_step"]
    bound = steps * cycles / (1e6 * lat["clock_ghz"])
    print(
        f"{head}; the fast step loop's SASS ({sass['instructions']} instructions, "
        f"{sass['steps']} step(s) a pass; {sass['control']}; divisions as (refining FFMAs, "
        f"instructions from MUFU.RCP to the quotient's first use) {sass['divisions'][:4]}; "
        f"recounted in {sass_s:.2f} s): chain ops a step {sass['chain_per_step']}, priced at "
        + ", ".join(f"{k} {v:.2f}" for k, v in sass["latency"].items())
        + f" (MUFU.RCP: the quotient less its refining FFMAs) = {cycles:.1f} cycles a step; "
        f"chain bound {steps} steps x {cycles:.1f} cycles at {lat['clock_ghz']:.3f} GHz = "
        f"{bound:.4f} ms; the kernel's card time {card_ms:.4f} ms = {card_ms / bound:.3f}x the "
        f"chain bound",
        flush=True,
    )
    return dict(bound_ms=bound, cycles_per_step=cycles, latencies=lat, sass=sass)


def delay_line_only():
    """`chip_smoke.py --delay-line`: build the kernels and run phase 3f(a)
    alone; tools/plant_faults.py --kernel delay runs it against each planted
    fault, which it must catch."""
    name_power = card_line()
    _build.load()
    delay_line_check(torch.cuda.get_device_name(0), name_power)
    print("3f(a) held", flush=True)


def chunk_time(spec, impl, precision, label, name_power, match=None):
    """CUDA-event ms of one K-tick chunk of `impl` at E lanes, all live, and
    the device's busy share of one chunk under the profiler."""
    sim = compile_plan(
        spec, ExecPlan(impl=impl, ensemble=E, chunk_ticks=K, precision=precision), device="cuda"
    )
    g = torch.Generator(device="cuda").manual_seed(0)
    m = ops.to_planes(spec.m0.expand(E, N, 3)).contiguous()
    u = 0.5 * torch.rand((K, E, 1), generator=g, device="cuda")
    mask = torch.ones((K, E), dtype=torch.bool, device="cuda")
    fn = lambda: sim.tick_chunk(m, u, lane_mask=mask)  # noqa: E731
    ms = time_ms(fn, 3)
    busy_us, matched_us = trace(label, fn, name_power, top=4, match=match)
    return ms, busy_us, matched_us


def tm_split(spec, precision):
    """A time-multiplexed chunk's parts by CUDA events: K feedback products
    (kref.tm_feedback, torch.matmul) and K tm_delay_line launches."""
    dev = torch.device("cuda")
    w = spec.w_cp.to(torch.bfloat16) if precision else spec.w_cp
    m, pv, h = delay_line_inputs(N, dev, seed=3)
    hb = h[None].expand(K, N, E).contiguous()
    gemm_ms = time_ms(lambda: [kref.tm_feedback(hb[t], w, m[0], pv) for t in range(K)], 3)
    h_t = kref.tm_feedback(hb[0], w, m[0], pv)
    kern_ms = time_ms(lambda: [sto_step.tm_delay_line(m, h_t, pv, DT, HOLD) for _ in range(K)], 3)
    return gemm_ms, kern_ms


def family_engines(specs, name_power):
    """3f(b): 512 sessions through each family engine of FAMILY_RUNS, each
    launching exactly its impl's kernels; its chunk's CUDA-event ms and the
    device's busy share; the time-multiplexed chunk split into its feedback
    products and its kernel launches. Returns the tm_delay_line launches of
    the f32 time-multiplexed run and the results by run."""
    runs, tm_launches = {}, None
    for topology, impl, precision, kernels in FAMILY_RUNS:
        spec = specs[topology]
        results, seconds, launches, _ = serve(spec, impl, precision=precision)
        launched = {k for k, v in launches.items() if v}
        assert launched == set(kernels), f"{topology}/{impl}/{precision}: launched {launches}"
        if topology == "time_multiplexed" and precision is None:
            tm_launches = launches["tm_delay_line"]
        label = f"{topology} {impl}" + (f" {precision}" if precision else "")
        symbol = {"tm_delay_line": "tm_delay_line_kernel", "rk4_fused": "rk4_coop_kernel",
                  "field_tiled": "field_stage_kernel"}.get(kernels[0] if kernels else None)
        ms, busy_us, kern_us = chunk_time(spec, impl, precision, label, name_power, match=symbol)
        extra = ""
        if topology == "time_multiplexed":
            gemm_ms, kern_ms = tm_split(spec, precision)
            extra = (f"; a chunk's {K} feedback products {gemm_ms:.3f} ms, its {K} kernel "
                     f"launches {kern_ms:.3f} ms (CUDA events, apart)")
        print(
            f"3f(b) {label}: {SESSIONS} sessions in {seconds:.3f} s = {SESSIONS / seconds:.1f} "
            f"sessions/s; chunk {ms:.3f} ms (CUDA events), device busy {busy_us / 1e3:.3f} ms of "
            f"it under the profiler, its kernel {kern_us / 1e3:.3f} ms{extra}; launches "
            f"{ {k: v for k, v in launches.items() if v} } ({name_power})",
            flush=True,
        )
        runs[topology, impl, precision] = results
    return tm_launches, runs


def interpret_checks(specs, runs, name_power):
    """3f(b): array_transient on fused and tiled against its interpret=True
    run at full width (STATE_ATOL); time_multiplexed on chunk against its
    interpret=True run at N = 256, 32 sessions of 1-2 ticks (bit-equal)."""
    sessions = make_sessions(np.random.default_rng(0))
    for impl in ("fused", "tiled"):
        ref, seconds, launches, _ = serve(specs["array_transient"], impl, interpret=True)
        assert not any(launches.values()), f"interpret run launched kernels: {launches}"
        ds, do, _, exact = same_results(
            runs["array_transient", impl, None], ref, [s.sid for s in sessions], w_outs_of(sessions)
        )
        print(
            f"3f(b) array_transient {impl} vs interpret (plain versions), N={N}: max |state| diff "
            f"{ds:.3e} (atol {STATE_ATOL}), max |output| diff {do:.3e}: {held(exact)}; plain run "
            f"{SESSIONS / seconds:.1f} sessions/s",
            flush=True,
        )
    n = TM_SMALL_N
    spec_s = make_time_multiplexed_spec(n, hold_steps=HOLD, device="cuda")
    rng = np.random.default_rng(4)
    rows = [(sid, rng.uniform(0.0, 0.5, (1 + sid % 2, 1)).astype(np.float32),
             rng.normal(0.0, 1.0 / math.sqrt(n), (n + 1, 1)).astype(np.float32)) for sid in range(32)]
    got = {}
    for interpret in (False, True):
        eng = ReservoirEngine(spec_s, num_slots=64, chunk_ticks=2, backend="chunk",
                              interpret=interpret, device="cuda")
        sto_step.reset_launches()
        t0 = time.perf_counter()
        got[interpret] = eng.run([StreamSession(sid=sid, u_seq=u, readout=Readout(torch.from_numpy(w), 0))
                                  for sid, u, w in rows])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        assert (sto_step.LAUNCHES["tm_delay_line"] > 0) != interpret, dict(sto_step.LAUNCHES)
    ds, do, _, exact = same_results(got[False], got[True], [r[0] for r in rows],
                                    {sid: w for sid, _, w in rows})
    assert exact, f"time_multiplexed chunk vs interpret at N={n}: {ds}, {do}"
    print(f"3f(b) time_multiplexed chunk vs interpret (plain body), N={n}, 32 sessions: bit-equal "
          f"(plain run {seconds:.3f} s) ({name_power})", flush=True)


def window_one_check(served, name_power):
    """3f(c): array_transient with readout_window = 1 against the coupled
    array (phase 3's runs) at full width under fused and tiled."""
    spec = make_array_transient_spec(N, readout_window=1, hold_steps=HOLD, seed=0, device="cuda")
    sessions = make_sessions(np.random.default_rng(0))
    for impl in ("fused", "tiled"):
        results, seconds, launches, _ = serve(spec, impl)
        ds, do, _, exact = same_results(results, served[impl], [s.sid for s in sessions],
                                        w_outs_of(sessions))
        print(
            f"3f(c) array_transient window 1 vs coupled_array, {impl}, N={N}: max |state| diff "
            f"{ds:.3e}, max |output| diff {do:.3e}: {held(exact)}; {SESSIONS / seconds:.1f} "
            f"sessions/s, launches { {k: v for k, v in launches.items() if v} } ({name_power})",
            flush=True,
        )


def tenant_sessions(seed, sid0, spec, count=32):
    """`count` NARMA-10 inference tenants and one RLS learner of one spec,
    sids from sid0 (the learner last)."""
    tenants = make_sessions(np.random.default_rng(seed))[:count]
    learner = make_sessions(np.random.default_rng(seed + 1), learn=True)[0]
    for i, sess in enumerate(tenants + [learner]):
        sess.sid, sess.spec = sid0 + i, spec
    return tenants + [learner]


def mixed_tenancy(spec, specs, served, name_power):
    """3f(d): a tiled coupled-array learning engine (RLS) serving the 512
    sessions, 32 time_multiplexed and 32 array_transient tenants and one
    RLS learner of each family, each carrying its spec: 2 sub-engines; every
    tenant bit-equal to a dedicated engine of its spec at the sub-engine's
    width, each learner bit-equal to its replay there; the coupled sessions
    against phase 3's tiled run."""
    kw = dict(num_slots=E, chunk_ticks=K, learn="rls", learn_reg=LEARN_REG, device="cuda")
    eng = ReservoirEngine(spec, backend="tiled", **kw)
    coupled = make_sessions(np.random.default_rng(0))
    family = {"time_multiplexed": (5, 10000), "array_transient": (7, 20000)}
    tenants = [
        sess for topology, (seed, sid0) in family.items()
        for sess in tenant_sessions(seed, sid0, specs[topology])
    ]
    submitted = coupled + tenants
    for sess in coupled:
        eng.submit(sess)
    # each spec-carrying submit hashes its spec (the structural hash copies
    # W off the card), as the reference's does; the first of each family
    # also builds its sub-engine
    t0 = time.perf_counter()
    for sess in tenants[:1] + tenants[33:34]:
        eng.submit(sess)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for sess in tenants[1:33] + tenants[34:]:
        eng.submit(sess)
    rest_s = time.perf_counter() - t0
    print(
        f"3f(d) submit: the first tenant of each family {first_s:.3f} s (hash + sub-engine), "
        f"the other {len(tenants) - 2} tenants {rest_s:.3f} s, "
        f"{1e3 * rest_s / (len(tenants) - 2):.2f} ms a submit (hash) ({name_power})",
        flush=True,
    )
    subs = {sub.res.topology: sub for sub in eng._subengines.values()}
    assert eng.stats().sub_engines == 2 and sorted(subs) == sorted(family), eng.stats()
    with Check("mixed") as c:
        results = eng.run()
    assert sorted(results) == sorted(s.sid for s in submitted), len(results)
    ds, do, _, exact = same_results(results, served["tiled"], [s.sid for s in coupled],
                                    w_outs_of(coupled))
    print(
        f"3f(d) mixed tenancy: {SESSIONS} coupled + 2 x 33 family sessions on a tiled RLS engine "
        f"in {c.seconds:.3f} s, 2 sub-engines ({', '.join(f'{t}: {s.backend} at E={s.num_slots}' for t, s in subs.items())}), "
        f"launches {c.launches}; the coupled sessions vs phase 3's tiled run: max |state| diff "
        f"{ds:.3e}: {held(exact)} ({name_power})",
        flush=True,
    )
    for topology, (seed, sid0) in family.items():
        sub = subs[topology]
        sessions = tenant_sessions(seed, sid0, None)
        dedicated = ReservoirEngine(specs[topology], backend=sub.backend, **dict(kw, num_slots=sub.num_slots))
        with Check(topology) as c:
            want = dedicated.run(sessions)
        learner = sessions[-1]
        ds, do, dw, exact = same_results(results, want, [s.sid for s in sessions[:-1]],
                                         w_outs_of(sessions[:-1]))
        dsl, _, dwl, exact_l = same_results(results, want, [learner.sid], w_outs_of([learner]),
                                            learn=True)
        assert exact and exact_l, f"{topology} tenants vs a dedicated engine: {ds} {do} {dsl} {dwl}"
        check_learned(results, [learner], "rls", f"3f(d) {topology} tenant")
        print(
            f"3f(d) {topology} tenants (32 + 1 learner) vs a dedicated {sub.backend} engine at "
            f"E={sub.num_slots}: states, final_m, outputs, predictions and learned W bit-equal; "
            f"dedicated run {c.seconds:.3f} s, launches {c.launches} ({name_power})",
            flush=True,
        )


def families_phase(served, name, name_power):
    """Phase 3f. Returns the tm_delay_line kernel row."""
    t0 = time.perf_counter()
    row = delay_line_check(name, name_power)
    parts = {"a": round(time.perf_counter() - t0, 1)}
    specs = {
        "time_multiplexed": make_time_multiplexed_spec(N, hold_steps=HOLD, device="cuda"),
        "array_transient": make_array_transient_spec(
            N, readout_window=AT_WINDOW, hold_steps=HOLD, seed=0, device="cuda"
        ),
    }
    row["launches"], runs = family_engines(specs, name_power)
    interpret_checks(specs, runs, name_power)
    del runs
    parts["b"] = round(time.perf_counter() - t0 - sum(parts.values()), 1)
    window_one_check(served, name_power)
    parts["c"] = round(time.perf_counter() - t0 - sum(parts.values()), 1)
    mixed_tenancy(make_spec(N, n_in=1, seed=0, hold_steps=HOLD, device="cuda"), specs, served,
                  name_power)
    parts["d"] = round(time.perf_counter() - t0 - sum(parts.values()), 1)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 3f: {time.perf_counter() - t0:.1f} s (seconds by part {json.dumps(parts)}); "
          f"kernel tm_delay_line: " + json.dumps(row), flush=True)
    return row



# -- phase 3g: tune at full width ---------------------------------------------------------


def tune_space(structural=True):
    """3g's lane knobs, and with `structural` the learn_reg choice (one engine
    each)."""
    from repro_torch.tune import Choice, Float, SearchSpace

    knobs = {"drive_current": Float(0.5e-3, 4.5e-3), "spectral_radius": Float(0.2, 1.2)}
    if structural:
        knobs["learn_reg"] = Choice(TUNE_REGS)
    return SearchSpace(knobs)


def tune_plan(impl, ensemble=None, **kw):
    return ExecPlan(impl=impl, ensemble=ensemble or E, chunk_ticks=K, learn="rls", **kw)


def tune_history(result):
    """(trial id, assignment, engine key, fitness bits) of every trial."""
    return [(t.trial_id, tuple(sorted(t.assignment.items())), t.engine_key,
             np.float64(t.fitness).tobytes()) for t in result.trials]


def candidate_session(task, assignment, sid=0):
    """One candidate alone, as tune_spec submits it."""
    params = constants.default_params(device="cpu")._replace(
        current=float(assignment["current"]), a_cp=float(assignment["a_cp"])
    )
    return StreamSession(sid=sid, u_seq=task.u_seq.copy(), targets=task.targets.copy(),
                         params=params, learn_washout=task.learn_washout, collect_states=False)


class SlotLog:
    """The lane each finished session was served in, from every
    ReservoirEngine.pop_results call inside the block (wrapped in this
    script only)."""

    def __enter__(self):
        self.slots = {}
        pop = self._pop = ReservoirEngine.pop_results

        def recording(eng):
            out = pop(eng)
            self.slots.update({sid: r.slot for sid, r in out.items()})
            return out

        ReservoirEngine.pop_results = recording
        return self

    def __exit__(self, *exc):
        ReservoirEngine.pop_results = self._pop
        return False


def tune_search(spec, task, impl, kernel, label, name_power):
    """3g(a) / (b): the random search of TUNE_BUDGET candidates over E lanes,
    two engines (learn_reg). Returns (result, lane of each trial, compiles)."""
    from repro_torch.api import PLAN_CACHE
    from repro_torch.tune import tune_spec

    c0 = PLAN_CACHE.stats.compiles
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with SlotLog() as log, Check(label) as c:
        result = tune_spec(spec, task, tune_space(), budget=TUNE_BUDGET, plan=tune_plan(impl),
                           seed=0, device="cuda")
    peak = torch.cuda.max_memory_allocated() / 2**30
    compiles = PLAN_CACHE.stats.compiles - c0
    assert len(result.trials) == TUNE_BUDGET, len(result.trials)
    assert c.launches.get(kernel, 0) > 0, f"{impl} search never launched {kernel}: {c.launches}"
    assert set(c.launches) == {kernel}, f"{impl} search launched other kernels: {c.launches}"
    keys = sorted({t.engine_key for t in result.trials})
    assert keys == sorted(f"learn_reg={r!r}" for r in TUNE_REGS), keys
    best = result.best
    assert best.ok, best
    finite = sum(t.ok for t in result.trials)
    per_key = {k: min((t.fitness for t in result.trials if t.engine_key == k and t.ok),
                      default=float("nan")) for k in keys}
    print(
        f"3g(a) {label}: {TUNE_BUDGET} candidates ({finite} finite) of {TUNE_TICKS} ticks in "
        f"{c.seconds:.3f} s = {TUNE_BUDGET / c.seconds:.1f} candidates/s; engines {keys}, best "
        f"fitness per engine {per_key}; best trial {best.trial_id} {best.assignment} fitness "
        f"{best.fitness!r}; PLAN_CACHE compiles {compiles}, stats {PLAN_CACHE.stats.snapshot()}; "
        f"launches {c.launches}; peak memory {peak:.3f} GiB ({name_power})",
        flush=True,
    )
    return result, log.slots, compiles


def replay_check(spec, task, result, slots, impl, oracle_nmse, name_power):
    """3g(c): REPLAYS trials of the stable regime (learn_reg 1e-2), each
    served alone on a fresh engine of the search's plan and width in the lane
    it was evaluated in: learn_nmse bit-equal to the trial's; then against
    the E = 1 scan oracle on the card, within NMSE_ORACLE_RTOL. The oracle's
    NMSE per assignment is kept in `oracle_nmse` (both impls replay the same
    candidates)."""
    from repro_torch.api import PLAN_CACHE

    picks = [
        t for t in result.trials
        if t.ok and t.assignment["learn_reg"] == ORACLE_REG
        and STABLE_CURRENT[0] <= t.assignment["current"] <= STABLE_CURRENT[1]
        and STABLE_A_CP[0] <= t.assignment["a_cp"] <= STABLE_A_CP[1]
    ][:REPLAYS]
    assert len(picks) == REPLAYS, len(picks)
    plan = tune_plan(impl, learn_reg=ORACLE_REG)
    with Check("replay") as c:
        for t in picks:
            eng = ReservoirEngine(PLAN_CACHE.get_or_compile(spec, plan, device="cuda"))
            slot = slots[t.trial_id]
            eng.store.free_slots = lambda slot=slot: [slot]  # the trial's lane
            eng.submit(candidate_session(task, t.assignment))
            got = eng.run()[0]
            assert got.slot == slot, (got.slot, slot)
            assert got.learn_nmse == t.fitness, (t.trial_id, got.learn_nmse, t.fitness)
            del eng
            gc.collect()
    oracle = ExecPlan(impl="scan", ensemble=1, chunk_ticks=K, learn="rls", learn_reg=ORACLE_REG)
    gaps = []
    with Check("oracle") as co:
        for t in picks:
            key = (t.assignment["current"], t.assignment["a_cp"])
            if key not in oracle_nmse:
                eng = ReservoirEngine(PLAN_CACHE.get_or_compile(spec, oracle, device="cuda"))
                eng.submit(candidate_session(task, t.assignment))
                oracle_nmse[key] = eng.run()[0].learn_nmse
            want = oracle_nmse[key]
            gaps.append((abs(t.fitness - want) / abs(want), t.assignment["current"], t.assignment["a_cp"]))
    worst = max(gaps)
    assert not co.launches, co.launches
    print(
        f"3g(c) replay {impl}: {REPLAYS} stable trials (learn_reg {ORACLE_REG}) served alone in "
        f"their lanes at E={E}: learn_nmse bit-equal ({c.seconds:.3f} s, launches {c.launches}); "
        f"vs the E=1 scan oracle on the card: |nmse diff| / nmse max {worst[0]:.3e} (at current "
        f"{worst[1]:.4g} A, a_cp {worst[2]:.4g}), median {np.median([g[0] for g in gaps]):.3e} "
        f"(rtol {NMSE_ORACLE_RTOL}; {co.seconds:.3f} s) ({name_power})",
        flush=True,
    )
    assert worst[0] <= NMSE_ORACLE_RTOL, f"{impl}: learn_nmse {worst} of the scan oracle's"


def interpret_search(spec, task, name_power):
    """3g: a search on an interpret=True plan (the kernels' plain versions)
    launches no kernel."""
    from repro_torch.tune import tune_spec

    with Check("interpret") as c:
        result = tune_spec(spec, task, tune_space(False), budget=16,
                           plan=tune_plan("chunk", interpret=True, learn_reg=ORACLE_REG),
                           seed=3, device="cuda")
    assert len(result.trials) == 16 and all(t.ok for t in result.trials)
    assert not c.launches, f"an interpret search launched kernels: {c.launches}"
    print(f"3g interpret=True search: 16 candidates in {c.seconds:.3f} s, launches {c.launches} "
          f"({name_power})", flush=True)


def vectorized_vs_sequential(spec, task, name_power):
    """3g(d): seconds per candidate of a search over E lanes (budget E) and
    of one lane at a time (budget SEQ_BUDGET), each warmed first; printed,
    not held to anything."""
    from repro_torch.tune import tune_spec

    per = {}
    for label, width, budget in (("vectorized", E, E), ("sequential", 1, SEQ_BUDGET)):
        plan = tune_plan("chunk", ensemble=width, learn_reg=ORACLE_REG)
        tune_spec(spec, task, tune_space(False), budget=1, plan=plan, seed=9, device="cuda")
        with Check(label) as c:
            result = tune_spec(spec, task, tune_space(False), budget=budget, plan=plan, seed=1,
                               device="cuda")
        assert len(result.trials) == budget and result.sequential == (width == 1)
        per[label] = c.seconds / budget
        print(f"3g(d) {label} (ensemble={width}): {budget} candidates in {c.seconds:.3f} s, "
              f"{per[label]:.4f} s a candidate, launches {c.launches} ({name_power})", flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    print(f"3g(d) sequential / vectorized seconds a candidate: "
          f"{per['sequential'] / per['vectorized']:.2f} ({name_power})", flush=True)


def autotune_tenants(count):
    """`count` NARMA-10 learners of TUNE_TICKS ticks, sids 1..count."""
    out = []
    for sid in range(1, count + 1):
        u, y = tasks.narma_series(TUNE_TICKS, order=10, seed=sid)
        out.append(StreamSession(sid=sid, u_seq=u.astype(np.float32), targets=y.astype(np.float32),
                                 learn_washout=TUNE_WASHOUT, collect_states=True))
    return out


def autotune_live(spec, impl, kernel, name_power):
    """3g(e): tenant 0 tuned on a live E-slot RLS engine whose spare lanes
    its AUTOTUNE_BUDGET probes fill, beside AUTOTUNE_TENANTS co-tenants;
    every co-tenant bit-equal to the same tenants served without it."""
    from repro_torch.api import PLAN_CACHE

    plan = tune_plan(impl, learn_reg=ORACLE_REG)
    alone = ReservoirEngine(PLAN_CACHE.get_or_compile(spec, plan, device="cuda"))
    want = alone.run(autotune_tenants(AUTOTUNE_TENANTS))
    del alone
    eng = ReservoirEngine(PLAN_CACHE.get_or_compile(spec, plan, device="cuda"), max_retained=1000)
    for s in autotune_tenants(AUTOTUNE_TENANTS):
        eng.submit(s)
    u, y = tasks.narma_series(TUNE_TICKS, order=10, seed=0)
    tuned = StreamSession(sid=0, u_seq=u.astype(np.float32), targets=y.astype(np.float32),
                          learn_washout=AUTOTUNE_WASHOUT, collect_states=False)
    with Check("autotune") as c:
        probe = eng.submit_autotuned(tuned, tune_space(False), budget=AUTOTUNE_BUDGET, seed=0)
        t_probe = time.perf_counter() - c.t0
        while eng.step_chunk():
            pass
        got = eng.pop_results()
    del eng
    assert c.launches.get(kernel, 0) > 0, c.launches
    assert len(probe.trials) == AUTOTUNE_BUDGET and all(t.engine_key == "live" for t in probe.trials)
    assert sorted(got) == list(range(AUTOTUNE_TENANTS + 1)), "a probe sid reached pop_results"
    win = probe.best.assignment
    assert (float(tuned.params.current), float(tuned.params.a_cp)) == (win["current"], win["a_cp"])
    worst, exact = 0.0, True
    for sid, b in want.items():
        a = got[sid]
        assert a.error is None and b.error is None, (a.error, b.error)
        worst = max(worst, float(np.abs(a.states - b.states).max()),
                    float(np.abs(a.final_m - b.final_m).max()),
                    (a.learned_readout.w_out - b.learned_readout.w_out).abs().max().item(),
                    abs(a.learn_nmse - b.learn_nmse))
        exact = exact and np.array_equal(a.states, b.states) and np.array_equal(a.final_m, b.final_m) \
            and torch.equal(a.learned_readout.w_out, b.learned_readout.w_out) \
            and a.learn_nmse == b.learn_nmse
    print(
        f"3g(e) washout autotune {impl}: {AUTOTUNE_BUDGET} probes beside {AUTOTUNE_TENANTS} "
        f"co-tenants at E={E} in {t_probe:.3f} s, then served in {c.seconds - t_probe:.3f} s; "
        f"winner {win} probe nmse {probe.best.fitness!r}, tenant 0 full-stream nmse "
        f"{got[0].learn_nmse!r}; no probe sid in pop_results; max_retained restored (1000); "
        f"co-tenants vs served without the tuned tenant: max diff {worst:.3e} "
        f"({'bit-equal' if exact else 'NOT bit-equal'}); launches {c.launches} ({name_power})",
        flush=True,
    )
    assert exact, f"{impl}: probe lanes perturbed a co-tenant by {worst}"


def tune_phase(spec, name_power):
    """Phase 3g: tune at N = 2500, E = 256 under chunk and tiled."""
    from repro_torch.api import PLAN_CACHE
    from repro_torch.tune import narma_task

    t0 = time.perf_counter()
    PLAN_CACHE.clear()
    task = narma_task(t=TUNE_TICKS, order=10, seed=0, learn_washout=TUNE_WASHOUT)
    runs = {}
    for impl, kernel in (("chunk", "rk4_chunk"), ("tiled", "field_tiled")):
        runs[impl] = tune_search(spec, task, impl, kernel, f"random search {impl}", name_power)
        assert runs[impl][2] == len(TUNE_REGS), f"{impl}: {runs[impl][2]} compiles"
    alike = tune_history(runs["chunk"][0]) == tune_history(runs["tiled"][0])
    print(f"3g(a) chunk vs tiled trial histories: {'bit-identical' if alike else 'differ'} "
          "(printed, not held)", flush=True)
    again, _, compiles = tune_search(spec, task, "chunk", "rk4_chunk", "rerun chunk", name_power)
    assert compiles == 0, f"the rerun compiled {compiles} plans"
    same = tune_history(again) == tune_history(runs["chunk"][0])
    print(f"3g(b) rerun with seed 0: trial ids, assignments, engine keys and fitness "
          f"{'bit-identical' if same else 'DIFFER'}", flush=True)
    assert same, "the rerun's trial history differs"
    del again
    oracle_nmse = {}
    for impl in ("chunk", "tiled"):
        result, slots, _ = runs.pop(impl)
        replay_check(spec, task, result, slots, impl, oracle_nmse, name_power)
    interpret_search(spec, task, name_power)
    vectorized_vs_sequential(spec, task, name_power)
    for impl, kernel in (("chunk", "rk4_chunk"), ("tiled", "field_tiled")):
        autotune_live(spec, impl, kernel, name_power)
        gc.collect()
        torch.cuda.empty_cache()
    launcher_check(name_power, extras=(["--learn", "rls", "--autotune-budget", "8"],), label="3g(f)")
    print(f"3g PLAN_CACHE: {PLAN_CACHE.stats.snapshot()}", flush=True)
    print(f"phase 3g: {time.perf_counter() - t0:.1f} s", flush=True)


def tune_only():
    """`chip_smoke.py --tune`: build the kernels and run phase 3g alone."""
    name_power = card_line()
    _build.load()
    tune_phase(make_spec(N, n_in=1, seed=0, hold_steps=HOLD, device="cuda"), name_power)
    print("3g held", flush=True)


# ---------------------------------------------------------------------------
# phase 3h: the fleet
# ---------------------------------------------------------------------------

# the replicas' engine, at the reservoir cell's shapes (make_engine's seeds
# give phase 3's spec: make_spec(N, n_in=1, seed=0, hold_steps=HOLD))
FLEET_KW = dict(n=N, num_slots=E, hold_steps=HOLD, seed=0, backend="chunk", chunk_ticks=K,
                device="cuda")
FLEET_REPLICAS = 2
# the sessions 3h serves (the first of phase 3's 512; all 512 until phase 5d
# joined the script): the fleet's host costs (a submit hashes its spec) grow
# with the sessions, its failover and migration checks do not
FLEET_SESSIONS = 64
# a process replica's reply deadline: far above a chunk (~0.03-0.25 s) and a
# snapshot of 256 sessions (~100 MB of host data); the hung child trips it
FLEET_RPC_TIMEOUT_S = 10.0


class LaunchCountingEngine(ReservoirEngine):
    """A replica's engine whose stats also carry this process's kernel
    launches (an attribute beside EngineStats' fields, so a process
    replica's child reports its own counts through the stats RPC)."""

    def stats(self):
        st = super().stats()
        st.launches = {k: v for k, v in _build.LAUNCHES.items() if v}
        return st


def fleet_engine(**kw):
    """Phase 3h's replica factory (module level: spawn pickles it):
    `make_engine`, then the kernel library loaded. In a replica child it
    raises (the ready handshake answers with the error) if loading ran
    nvcc: the fleet's parent built the library for its children."""
    import multiprocessing

    from repro_torch.serve.fleet import make_engine

    eng = make_engine(**kw)
    eng.__class__ = LaunchCountingEngine  # the same engine, stats with launches
    _build.load()
    if multiprocessing.parent_process() is not None and _build.BUILD_LOG is not None:
        raise RuntimeError(f"a replica child ran nvcc in {_build.BUILD_DIR}")
    return eng


def fleet_sessions(learn=False):
    return make_sessions(np.random.default_rng(0), learn=learn)[:FLEET_SESSIONS]


def replay_in_lane(spec, sess, slot, learn=None):
    """One session served alone on a fresh engine of the replicas' width,
    admitted into `slot` (the lane it had in the fleet)."""
    eng = ReservoirEngine(spec, num_slots=E, chunk_ticks=K, backend="chunk", learn=learn,
                          device="cuda")
    eng.store.free_slots = lambda slot=slot: [slot]
    return eng.run([sess])[sess.sid]


def hold_fleet(label, got, want, spec, learn=False):
    """Every session of `got` bit-equal to `want` (states, final_m, outputs;
    a learner's W and predictions too). A session that is not is printed
    with its gap and both lanes, and then held bit-equal to its replay alone
    in its fleet lane at the engine's width: a lane's bits then depend on
    its lane, not on the fleet. Returns the sessions held by replay."""
    assert sorted(got) == sorted(want), f"{label}: {len(got)} vs {len(want)} sessions"
    sessions = {s.sid: s for s in fleet_sessions(learn)}
    off = []
    for sid in sorted(want):
        a, b = got[sid], want[sid]
        assert a.error is None, (sid, a.error)
        same = all(np.array_equal(x, y) for x, y in (
            (a.states, b.states), (a.final_m, b.final_m), (a.outputs, b.outputs)))
        if learn:
            same = same and torch.equal(a.learned_readout.w_out, b.learned_readout.w_out)
            same = same and np.array_equal(a.predictions, b.predictions)
        if not same:
            off.append(sid)
    for sid in off:
        a, b = got[sid], want[sid]
        gap = max(float(np.abs(a.states - b.states).max()), float(np.abs(a.final_m - b.final_m).max()))
        print(f"{label}: session {sid} differs by {gap:.3e} (lane {a.slot} in the fleet, "
              f"{b.slot} in the reference run): held to its replay in lane {a.slot}", flush=True)
        assert gap <= STATE_ATOL, (sid, gap)
        r = replay_in_lane(spec, sessions[sid], a.slot, learn="rls" if learn else None)
        assert np.array_equal(a.states, r.states) and np.array_equal(a.final_m, r.final_m), (
            f"{label}: session {sid} differs from its replay in lane {a.slot}")
    return off


def fleet_local(spec, want, name_power):
    """3h(a): two LocalReplicas behind FleetFrontend, the 512 sessions
    through submit_stream / drain_results (local replicas stepped from the
    front end's executor thread)."""
    import asyncio

    from repro_torch.serve.fleet import FleetFrontend, FleetRouter, start_fleet

    router = FleetRouter()
    reps = start_fleet(FLEET_REPLICAS, "local", factory=fleet_engine, **FLEET_KW)
    for r in reps:
        router.add_replica(r)

    async def serve_all():
        async with FleetFrontend(router) as fleet:
            for s in fleet_sessions():
                await fleet.submit_stream(N, s.u_seq, readout=s.readout, params=s.params,
                                          sid=s.sid)
            got = await fleet.drain_results()
            stats = fleet.stats()[N]
            return got, stats

    with Check("fleet local") as c:
        got, stats = asyncio.run(serve_all())
    assert all(st.backend == "chunk" for st in stats), [st.backend for st in stats]
    assert c.launches.get("rk4_chunk", 0) > 0 and set(c.launches) == {"rk4_chunk"}, c.launches
    off = hold_fleet("3h(a)", got, want, spec)
    print(f"3h(a) {FLEET_REPLICAS} local replicas behind FleetFrontend (N={N}, E={E}, K={K}, "
          f"chunk): {FLEET_SESSIONS} sessions in {c.seconds:.3f} s = {FLEET_SESSIONS / c.seconds:.1f} "
          f"sessions/s, {FLEET_SESSIONS - len(off)} bit-equal to one engine, {len(off)} held to their "
          f"replay; per replica {[st.session_ticks for st in stats]} session-ticks, backends "
          f"{[st.backend for st in stats]}; launches {c.launches} ({name_power})", flush=True)
    return got, FLEET_SESSIONS / c.seconds


def spawn_replicas(kw, faults=(None, None)):
    """Process replicas (the factory fleet_engine), spawned together after the
    parent built the kernel library for them; returns (replicas, each one's
    seconds from the spawn to its ready handshake, the kw they were given)."""
    from repro_torch.serve.fleet import ProcessReplica
    from repro_torch.serve.fleet import replica as replica_mod

    kw = replica_mod._share_kernel_library(kw)
    t0 = time.perf_counter()
    reps = [ProcessReplica(fleet_engine, _defer_ready=True, rpc_timeout_s=FLEET_RPC_TIMEOUT_S,
                           faults=f, **kw) for f in faults]
    ready = []
    for r in reps:
        r.wait_ready()
        ready.append(time.perf_counter() - t0)
    return reps, ready, kw


def fleet_process(spec, want, name_power):
    """3h(b): two ProcessReplicas sharing the build directory the parent
    built; each child's spawn-to-ready time, its first chunks against later
    ones, the card's free memory before and after; the 512 sessions held to
    3h(a)'s results."""
    from repro_torch.serve.fleet import FleetRouter

    free0, total = torch.cuda.mem_get_info()
    reps, ready, kw = spawn_replicas(dict(FLEET_KW))
    free1, _ = torch.cuda.mem_get_info()
    router = FleetRouter()
    for r in reps:
        router.add_replica(r)
    t0 = time.perf_counter()
    for s in fleet_sessions():
        router.submit(N, s)
    # each child's first chunks, one replica at a time, then the overlapped pump
    chunk_s = [[] for _ in reps]
    for _ in range(3):
        for i, r in enumerate(reps):
            t1 = time.perf_counter()
            r.run_for(1)
            chunk_s[i].append(time.perf_counter() - t1)
    got = router.drain()
    seconds = time.perf_counter() - t0
    stats = [r.stats() for r in reps]
    router.close()
    assert all(st.backend == "chunk" for st in stats), [st.backend for st in stats]
    for st in stats:
        assert st.launches.get("rk4_chunk", 0) > 0 and set(st.launches) == {"rk4_chunk"}, st.launches
    off = hold_fleet("3h(b)", got, want, spec)
    print(f"3h(b) {FLEET_REPLICAS} process replicas sharing {kw['compilation_cache_dir']} (no "
          f"child ran nvcc): spawn to ready {', '.join(f'{x:.3f}' for x in ready)} s; first "
          f"chunks (RPC round trip, ms) "
          + "; ".join(" / ".join(f"{1e3 * x:.3f}" for x in c) for c in chunk_s)
          + f"; later chunks median {[round(1e3 * st.chunk_median_s, 3) for st in stats]} ms "
          f"(the child's engine clock); card memory free {free0 / 2**30:.2f} GiB before the "
          f"spawn, {free1 / 2**30:.2f} GiB with both children ready (of {total / 2**30:.2f}; "
          f"{(free0 - free1) / 2**30:.2f} GiB for the two); {FLEET_SESSIONS} sessions in {seconds:.3f} s "
          f"= {FLEET_SESSIONS / seconds:.1f} sessions/s, {FLEET_SESSIONS - len(off)} bit-equal to 3h(a), "
          f"{len(off)} held to their replay; backends {[st.backend for st in stats]}, each "
          f"child's launches {[st.launches for st in stats]} ({name_power})", flush=True)
    return got, FLEET_SESSIONS / seconds


def fleet_failover(spec, want, name_power):
    """3h(c): checkpoint_every=2; replica 1's child hangs at its chunk 2 (its
    rpc deadline trips), replica 0's crashes at chunk 3; both respawn. Every
    session held to 3h(b)'s results."""
    from repro_torch.serve.fleet import Fault, FaultPlan, FleetRouter, start_fleet

    plans = (FaultPlan((Fault("crash", at_chunk=3),)), FaultPlan((Fault("hang", at_chunk=2),)))
    reps, ready, kw = spawn_replicas(dict(FLEET_KW), faults=plans)
    sent, first_reply, respawn_s = {}, {}, []

    def instrument(rep):
        """Record when `rep` was last sent a chunk and its first reply."""
        launch, wait = rep.run_for_async, rep.run_for_wait

        def run_for_async(n=1):
            sent[id(rep)] = time.perf_counter()
            return launch(n)

        def run_for_wait():
            out = wait()
            first_reply.setdefault(id(rep), time.perf_counter())
            return out

        rep.run_for_async, rep.run_for_wait = run_for_async, run_for_wait
        return rep

    respawned = []

    def respawn():
        t0 = time.perf_counter()
        (r,) = start_fleet(1, "process", factory=fleet_engine,
                           rpc_timeout_s=FLEET_RPC_TIMEOUT_S, **kw)
        respawn_s.append(time.perf_counter() - t0)
        respawned.append(r)
        return instrument(r)

    router = FleetRouter(checkpoint_every=2)
    for r in reps:
        router.add_replica(instrument(r), respawn=respawn)
    hung = reps[1]
    for s in fleet_sessions():
        router.submit(N, s)
    t0 = time.perf_counter()
    got = router.drain()
    seconds = time.perf_counter() - t0
    faults = router.fault_stats()
    backends = [st.backend for col in router.stats().values() for st in col]
    router.close()
    assert faults["replica_deaths"] == 2 and faults["failovers"] == 2, faults
    assert faults["sessions_lost"] == 0 and faults["sessions_recovered"] > 0, faults
    assert backends == ["chunk", "chunk"], backends
    # the hung child's replacement is the first respawn (chunk 2 precedes chunk 3)
    hang_to_first = first_reply[id(respawned[0])] - sent[id(hung)]
    off = hold_fleet("3h(c)", got, want, spec)
    print(f"3h(c) failover, checkpoint_every=2: replica 1 hung at chunk 2 (rpc_timeout_s "
          f"{FLEET_RPC_TIMEOUT_S}), replica 0 crashed at chunk 3; respawns "
          f"{', '.join(f'{x:.3f}' for x in respawn_s)} s; from the hung chunk's send to the "
          f"respawned replica's first chunk {hang_to_first:.3f} s; fault_stats {faults}; "
          f"{FLEET_SESSIONS} sessions in {seconds:.3f} s, {FLEET_SESSIONS - len(off)} bit-equal to the run "
          f"without faults, {len(off)} held to their replay ({name_power})", flush=True)


def fleet_migration(spec, name_power):
    """3h(d): one RLS learner checkpointed mid-stream out of one process
    replica into the other (P and W through the pipe), against the 16
    learners served unmoved on one engine in this process."""
    from repro_torch.serve.fleet import FleetRouter

    kw = dict(FLEET_KW, learn="rls")
    make = lambda: fleet_sessions(learn=True)[:16]  # noqa: E731
    want = ReservoirEngine(spec, num_slots=E, chunk_ticks=K, backend="chunk", learn="rls",
                           device="cuda").run(make())
    gc.collect()
    torch.cuda.empty_cache()  # the children allocate their own P
    reps, _, _ = spawn_replicas(kw)
    router = FleetRouter()
    for r in reps:
        router.add_replica(r)
    sessions = make()
    for s in sessions:
        reps[0].submit(s)
        router._affinity[s.sid] = reps[0]  # every learner starts on replica 0
    router.run_for(2)
    moved = max(sessions, key=lambda s: s.u_seq.shape[0]).sid
    t0 = time.perf_counter()
    dst = router.migrate(moved, dst=reps[1])
    migrate_s = time.perf_counter() - t0
    got = router.drain()
    stats = [r.stats() for r in reps]
    router.close()
    assert dst is reps[1] and all(st.backend == "chunk" and st.learn == "rls" for st in stats)
    a, b = got[moved], want[moved]
    gaps = (float(np.abs(a.states - b.states).max()),
            float((a.learned_readout.w_out - b.learned_readout.w_out).abs().max()),
            float(np.abs(a.predictions - b.predictions).max()))
    exact = (np.array_equal(a.states, b.states) and np.array_equal(a.final_m, b.final_m)
             and torch.equal(a.learned_readout.w_out, b.learned_readout.w_out)
             and np.array_equal(a.predictions, b.predictions))
    print(f"3h(d) RLS learner {moved} ({b.states.shape[0]} ticks) migrated after {2 * K} ticks "
          f"from replica 0 (lane {b.slot} unmoved) to replica 1 (lane {a.slot}), P "
          f"({N + 1} x {N + 1}) and W through the pipe: migrate {migrate_s:.3f} s; states / W / "
          f"predictions differ by {gaps[0]:.3e} / {gaps[1]:.3e} / {gaps[2]:.3e}: "
          f"{'bit-equal' if exact else 'DIFFER'}; the other 15 learners "
          f"{'bit-equal' if all(np.array_equal(got[s].states, want[s].states) for s in want) else 'differ'}"
          f" ({name_power})", flush=True)
    assert exact, f"the migrated learner differs from the unmoved one: {gaps}"


def fleet_launcher(name_power):
    """3h(f): the launcher's --fleet with two local replicas on the card (its
    default device; 3h(b)-(d) hold process replicas, which take ~19 s each to
    spawn): it serves every session and says that admission control is off,
    BENCH_serve.json being a CPU grid."""
    from repro_torch.launch import serve as launch_serve

    argv = ["--mode", "reservoir", "--fleet", "--replicas", "2", "--transport", "local",
            "--checkpoint-every", "2", "--n", str(N), "--slots", str(E), "--sessions", str(FLEET_SESSIONS),
            "--ticks", "40", "--hold-steps", str(HOLD), "--chunk-ticks", str(K), "--backend", "chunk"]
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        results = launch_serve.main(argv)
    seconds = time.perf_counter() - t0
    print(out.getvalue(), end="", flush=True)
    assert len(results) == FLEET_SESSIONS and all(r.error is None for r in results.values())
    assert ("planner: BENCH_serve.json was measured on cpu, not cuda — admission control "
            "disabled") in out.getvalue(), out.getvalue()
    assert "planner-predicted capacity" not in out.getvalue()
    print(f"3h(f) launcher {' '.join(argv)}: {seconds:.3f} s ({name_power})", flush=True)


def fleet_phase(spec, name_power):
    """Phase 3h: the fleet at the reservoir cell's shapes."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    want, seconds, launches, _ = serve(spec, "chunk")
    engine_rate = SESSIONS / seconds
    want = {s.sid: want[s.sid] for s in fleet_sessions()}
    parts, t1 = {}, time.perf_counter()

    def lap(part):
        nonlocal t1
        parts[part] = round(time.perf_counter() - t1, 1)
        t1 = time.perf_counter()

    local, local_rate = fleet_local(spec, want, name_power)
    lap("a")
    proc, proc_rate = fleet_process(spec, local, name_power)
    lap("b")
    fleet_failover(spec, proc, name_power)
    lap("c")
    fleet_migration(spec, name_power)
    lap("d")
    fleet_launcher(name_power)
    lap("f")
    print(f"3h(e) sessions/s by the host clock, {FLEET_SESSIONS} sessions, N={N}, E={E}, K={K}, "
          f"chunk: 1 engine {engine_rate:.1f} ({SESSIONS} sessions; launches {launches['rk4_chunk']} rk4_chunk), "
          f"{FLEET_REPLICAS} local replicas {local_rate:.1f}, {FLEET_REPLICAS} process replicas "
          f"{proc_rate:.1f} (no claim; {name_power})", flush=True)
    print(f"phase 3h: {time.perf_counter() - t0:.1f} s; seconds by part {json.dumps(parts)}",
          flush=True)


def fleet_only():
    """`chip_smoke.py --fleet`: build the kernels and run phase 3h alone."""
    name_power = card_line()
    _build.load()
    fleet_phase(make_spec(N, n_in=1, seed=0, hold_steps=HOLD, device="cuda"), name_power)
    print("3h held", flush=True)


# phase 3i, sharded plans: one rank on the one card (NCCL runs no two ranks
# on one card; the multi-rank decompositions are checked over gloo on the
# CPU, tests/test_torch_sharded.py)
SHARDED_T = 8  # drive_batch samples
# precision="bf16_coupling" on the mesh against the f32 mesh plan: the
# reference's bounds (tests/test_sharded_ensemble.py) on the state and on
# norm_error
BF16_STATE_ATOL = 5e-2
BF16_NORM_ATOL = 1e-4
# a shared drive series is contracted once a sample ('ni,i->n') where scan
# contracts it per lane: another op, held to the reference tests' sharded
# tolerance (tests/test_api_plan.py)
SHARED_ATOL = 1e-6


def _same(label, got, want):
    """Bit-equal, or raise with the largest difference."""
    if not torch.equal(got, want):
        diff = (got.double() - want.double()).abs().max().item()
        raise AssertionError(f"3i {label}: not bit-equal (max |diff| {diff:.3e})")


def _sharded_refs(spec, scan, scan_rls, inputs):
    """The unsharded impl="scan" results every mesh is held to."""
    m0, u, mask, y, u_lanes, u_shared = inputs
    refs = {"chunk": scan.tick_chunk(m0, u, mask)}
    refs["rls"] = scan_rls.tick_chunk(m0, u, mask, targets=y,
                                      learn_state=scan_rls.init_learn_state())
    refs["drive_lanes"] = scan.drive_batch(u_lanes)
    refs["drive_shared"] = scan.drive_batch(u_shared)
    refs["integrate"] = scan.integrate(20)[0]
    refs["tick"] = scan.tick(m0, u[0], mask[0])
    torch.cuda.synchronize()
    return refs


def _sharded_plan(mesh, **kw):
    model = "model" if "model" in mesh.mesh_dim_names else None
    return ExecPlan(ensemble=E, chunk_ticks=K, mesh=mesh, model_axis=model, **kw)


def sharded_checks(label, spec, mesh, refs, inputs, name_power):
    """3i(a)/(b): every entry point of a mesh plan against the unsharded
    scan's results, bit for bit (the shared-series drive to SHARED_ATOL)."""
    from repro_torch.api import sharded

    m0, u, mask, y, u_lanes, u_shared = inputs
    sim = compile_plan(spec, _sharded_plan(mesh), device="cuda")
    sim_rls = compile_plan(spec, _sharded_plan(mesh, learn="rls", learn_reg=LEARN_REG),
                           device="cuda")
    assert sim.impl == "scan" and sim.device.type == "cuda", (sim.impl, sim.device)
    t0 = time.perf_counter()
    sharded.GATHERS["all_gather"] = 0
    m, states = sim.tick_chunk(m0, u, mask)
    gathers = sharded.GATHERS["all_gather"]
    _same(f"{label} tick_chunk m", m, refs["chunk"][0])
    _same(f"{label} tick_chunk states", states, refs["chunk"][1])
    _same(f"{label} frozen lane", m[:, :, 0], m0[:, :, 0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**30  # the scan results held for the checks
    sharded.GATHERS["all_gather"] = 0
    out = sim_rls.tick_chunk(m0, u, mask, targets=y, learn_state=sim_rls.init_learn_state())
    torch.cuda.synchronize()
    gathers_rls = sharded.GATHERS["all_gather"]
    peak = torch.cuda.max_memory_allocated() / 2**30 - held
    want = refs["rls"]
    for name, a, b in (("m", out[0], want[0]), ("states", out[1], want[1]),
                       ("P", out[2][0], want[2][0]), ("W", out[2][1], want[2][1]),
                       ("preds", out[3], want[3])):
        _same(f"{label} RLS {name}", a, b)
    del out
    for name, a, b in zip(("mT", "states"), sim.drive_batch(u_lanes), refs["drive_lanes"]):
        _same(f"{label} drive_batch per lane {name}", a, b)
    shared = 0.0
    for a, b in zip(sim.drive_batch(u_shared), refs["drive_shared"]):
        shared = max(shared, (a - b).abs().max().item())
    assert shared <= SHARED_ATOL, f"3i {label} drive_batch shared series: {shared} > {SHARED_ATOL}"
    _same(f"{label} integrate(20)", sim.integrate(20)[0], refs["integrate"])
    for name, a, b in zip(("m", "states"), sim.tick(m0, u[0], mask[0]), refs["tick"]):
        _same(f"{label} tick {name}", a, b)
    print(
        f"3i{label} mesh {tuple(mesh.shape)} {mesh.mesh_dim_names}, model_axis "
        f"{sim.plan.model_axis}: tick_chunk (lanes frozen, retired, admitted) bit-equal, "
        f"{gathers} all-gathers; RLS chunk (learn_reg {LEARN_REG}) m, states, P, W, preds "
        f"bit-equal, {gathers_rls} all-gathers, peak {peak:.3f} GiB above the {held:.3f} GiB "
        f"held before it; drive_batch per lane "
        f"bit-equal, shared series max |diff| {shared:.3e} (atol {SHARED_ATOL}); integrate(20) "
        f"and tick bit-equal; {time.perf_counter() - t0:.1f} s ({name_power})",
        flush=True,
    )
    return sim, gathers, gathers_rls


def sharded_child():
    """Phase 3i in a process of its own (`chip_smoke.py --sharded-child`, as
    a torchrun rank: RANK, WORLD_SIZE, LOCAL_RANK from the environment), so
    that its process group never outlives the phase."""
    import shutil
    import tempfile

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.api import plan_cache_key, sharded

    rank, world, local = (int(os.environ[k]) for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"))
    torch.cuda.set_device(local)
    name_power = card_line()
    t_phase = time.perf_counter()
    store_dir = tempfile.mkdtemp(prefix="sharded-store-")
    try:
        t0 = time.perf_counter()
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(store_dir, "store"), world),
                                rank=rank, world_size=world)
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        probe = torch.empty(4, device="cuda")
        dist.all_gather_into_tensor(probe, torch.ones(4, device="cuda"),
                                    group=mesh.get_group("model"))  # the communicator's first use
        torch.cuda.synchronize()
        init_ms = 1e3 * (time.perf_counter() - t0)
        nccl = torch.cuda.nccl.version()
        nccl = ".".join(map(str, nccl)) if isinstance(nccl, tuple) else str(nccl)
        print(f"3i NCCL {nccl}, backend {dist.get_backend(mesh.get_group('model'))}, world "
              f"{world}, mesh {tuple(mesh.shape)} {mesh.mesh_dim_names}: init_process_group + "
              f"init_device_mesh + first all-gather {init_ms:.1f} ms ({name_power})", flush=True)

        spec = make_spec(N, n_in=1, seed=0, hold_steps=HOLD, device="cuda")
        rng = np.random.default_rng(11)
        dev = torch.device("cuda")
        u = torch.as_tensor(rng.uniform(0.0, 0.5, (K, E, 1)), dtype=torch.float32, device=dev)
        mask = torch.ones((K, E), dtype=torch.bool, device=dev)
        mask[:, 0] = False  # frozen
        mask[K // 2:, 1] = False  # retired mid-chunk
        mask[: K // 2, 2] = False  # admitted mid-chunk
        y = torch.as_tensor(rng.normal(size=(K, E, 1)), dtype=torch.float32, device=dev)
        u_lanes = torch.as_tensor(rng.uniform(0.0, 0.5, (SHARDED_T, E, 1)), dtype=torch.float32,
                                  device=dev)
        u_shared = u_lanes[:, 0]
        m0 = ops.to_planes(spec.m0.expand(E, N, 3)).contiguous()
        inputs = (m0, u, mask, y, u_lanes, u_shared)
        scan = compile_plan(spec, ExecPlan(impl="scan", ensemble=E, chunk_ticks=K), device="cuda")
        scan_rls = compile_plan(spec, ExecPlan(impl="scan", ensemble=E, chunk_ticks=K, learn="rls",
                                               learn_reg=LEARN_REG), device="cuda")
        refs = _sharded_refs(spec, scan, scan_rls, inputs)

        # (a) the (1, 1) mesh; (b) a 1-D mesh without a model axis
        sim, gathers, gathers_rls = sharded_checks("(a)", spec, mesh, refs, inputs, name_power)
        want = K * HOLD * 4
        assert gathers == want and gathers_rls == want + 1, (gathers, gathers_rls, want)
        mesh1 = init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
        sim1, gathers1, _ = sharded_checks("(b)", spec, mesh1, refs, inputs, name_power)
        assert gathers1 == 0, gathers1
        del refs

        # (c) bf16 coupling on the mesh against the f32 mesh plan
        bf = compile_plan(spec, _sharded_plan(mesh, precision="bf16_coupling"), device="cuda")
        f32_m, f32_s = sim.tick_chunk(m0, u, mask)
        bf_m, bf_s = bf.tick_chunk(m0, u, mask)
        f32_i, bf_i = sim.integrate(50)[0], bf.integrate(50)[0]
        err = max((bf_m - f32_m).abs().max().item(), (bf_s - f32_s).abs().max().item(),
                  (bf_i - f32_i).abs().max().item())
        nerr = max(sto.norm_error(ops.from_planes(bf_m, (E,))).item(), sto.norm_error(bf_i).item())
        assert 0.0 < err < BF16_STATE_ATOL and nerr < BF16_NORM_ATOL, (err, nerr)
        print(f"3i(c) precision=bf16_coupling on the mesh (gather dtype {bf._gather_dtype}) "
              f"against f32: tick_chunk and integrate(50) max |state diff| {err:.3e} (< "
              f"{BF16_STATE_ATOL}), norm_error {nerr:.3e} (< {BF16_NORM_ATOL}) ({name_power})",
              flush=True)
        del f32_m, f32_s, bf_m, bf_s, f32_i, bf_i

        # a chunk's time, sharded against unsharded scan (CUDA events), and
        # rk4_chunk's for context; the gathers of one chunk under the profiler
        _build.load()
        chunk = compile_plan(spec, ExecPlan(impl="chunk", ensemble=E, chunk_ticks=K), device="cuda")
        runs = (("scan", scan), ("sharded", sim), ("sharded_1d", sim1), ("scan2", scan),
                ("rk4_chunk", chunk))
        ms = {name: time_ms(lambda s=s: s.tick_chunk(m0, u, mask), 3) for name, s in runs}
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            sim.tick_chunk(m0, u, mask)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
        dev_us = lambda e: getattr(e, "self_device_time_total", None) or getattr(  # noqa: E731
            e, "self_cuda_time_total", 0.0)
        gather_events = {e.key: (e.count, round(e.cpu_time_total / 1e3, 3), round(dev_us(e) / 1e3, 3))
                         for e in prof.key_averages()
                         if "gather" in e.key.lower() or "nccl" in e.key.lower()}
        print(f"3i chunk ms (K={K}, hold {HOLD}, N={N}, E={E}, CUDA events, median of 3, in "
              f"turns): scan {ms['scan']:.3f} / {ms['scan2']:.3f}, sharded (1, 1) "
              f"{ms['sharded']:.3f} ({ms['sharded'] / ms['scan']:.3f}x), sharded 1-D (no gather) "
              f"{ms['sharded_1d']:.3f}, rk4_chunk {ms['rk4_chunk']:.3f} (context); all-gathers a "
              f"chunk {gathers} (+1 a learning chunk); one (1, 1) chunk under torch.profiler: wall "
              f"{wall:.3f} ms, gather events (count, host ms, device ms) {gather_events} "
              f"({name_power})", flush=True)

        # (d) the engine on the sharded sim against one on the unsharded scan
        served = {}
        for name, s in (("sharded", sim), ("scan", scan)):
            eng = ReservoirEngine(s)
            sessions = make_sessions(np.random.default_rng(0))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            served[name] = eng.run(sessions)
            torch.cuda.synchronize()
            served[name + "_s"] = time.perf_counter() - t0
        assert len(served["sharded"]) == SESSIONS, len(served["sharded"])
        for sess in sessions:
            a, b = served["sharded"][sess.sid], served["scan"][sess.sid]
            assert a.error is None, a.error
            for field in ("states", "outputs", "final_m"):
                assert np.array_equal(getattr(a, field), getattr(b, field)), (sess.sid, field)
        print(f"3i(d) ReservoirEngine on the sharded sim: {SESSIONS} NARMA-10 sessions bit-equal "
              f"to an engine on the unsharded scan sim (states, outputs, final_m); sessions/s "
              f"(host clock) sharded {SESSIONS / served['sharded_s']:.1f}, scan "
              f"{SESSIONS / served['scan_s']:.1f} ({name_power})", flush=True)
        del served

        # (e) the plan cache's key
        plan = _sharded_plan(mesh)
        keys = [plan_cache_key(compile_plan(spec, plan, device="cuda").plan) for _ in range(2)]
        unkey = plan_cache_key(scan.plan)
        assert keys[0] == keys[1] and keys[0] != unkey, (keys, unkey)
        print(f"3i(e) plan_cache_key of the mesh plan stable across two compile_plan calls and "
              f"distinct from the unsharded scan's: mesh entry {keys[0][6]}", flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(store_dir, ignore_errors=True)
    print(f"phase 3i child: {time.perf_counter() - t_phase:.1f} s", flush=True)


def sharded_phase(name_power):
    """Phase 3i: sharded plans on the card, in a child process that runs as
    rank 0 of a world of one (a FileStore: no network)."""
    t0 = time.perf_counter()
    env = dict(os.environ, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--sharded-child"],
                          capture_output=True, text=True, timeout=900, env=env)
    sys.stdout.write(proc.stdout)
    sys.stdout.flush()
    if proc.returncode != 0:
        raise RuntimeError(f"sharded child failed ({proc.returncode}):\n{proc.stderr[-6000:]}")
    print(f"phase 3i: {time.perf_counter() - t0:.1f} s ({name_power})", flush=True)


def sharded_only():
    """`chip_smoke.py --sharded`: build the kernels and run phase 3i alone."""
    name_power = card_line()
    _build.load()
    sharded_phase(name_power)
    print("3i held", flush=True)



# -- phase 5b: training on the card -----------------------------------------------

# (b) 10 steps (20 before phase 5e was added, cut to pay for its seconds)
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 512, 4, 10
TRAIN_LR, TRAIN_WARMUP = 1e-3, 5
TRAIN_SPLIT_STEPS = 3  # steps timed piece by piece after the TRAIN_STEPS (CUDA events)
# (a) one step on the card against the same step on the host CPU, relative to
# each leaf's largest magnitude: f32 and TF32 off on both sides, sums in other
# orders (cuBLAS, the backward's atomics); the CPU tests hold the port's step
# to the reference's at the same bound
TRAIN_RTOL = 1e-5
# (a) the whole make_train_step's worst updated leaf against the CPU's: AdamW
# divides each gradient element by the root of its second moment, so an
# element whose gradient is small against its leaf's f32 rounding moves by
# more than that rounding (8.9e-5 and 1.17e-4 read on the H100). Below the
# controls that must fail it: the step with the wrong step index, without the
# clip, or on bf16 parameters.
TRAIN_STEP_RTOL = 5e-4
# (b) the reference's test (tests/test_train_substrate.py:114-123): the mean
# of the last 5 losses at least this far below the mean of the first 5
LOSS_DROP = 0.2
# (c) a resumed run against the uninterrupted one: the reference's bound
# (tests/test_train_substrate.py:139); the backward's atomics (the embedding
# gather's index_put) make the card's steps not bit-reproducible by default
RESUME_RTOL = 2e-4
# (c), (e) full width at 1 layer (2 before phase 5e, cut to pay for it): a
# checkpoint of ~2.3 GB, not ~18
RESUME_LAYERS = 1
# (b)'s checkpoint holds the trained tree's first 2 layers (~3 GB): the same
# save / restore code as the whole ~18 GB tree, which took ~52-70 s a call
CKPT_LAYERS = 2
# (d) the loss through the flash kernel (no_grad) against the einsum path
# (grad) at full width: bf16 activations, f32 softmax on both sides
ROUTING_RTOL = 5e-3
# the AdamW walk's bytes a parameter: read p and g (bf16), mu and nu (f32),
# write p, mu and nu
ADAMW_BYTES = 2 + 2 + 4 + 4 + 2 + 4 + 4
HBM_BYTES_PER_S = mesh_mod.HW["hbm_bw"]


def _train_cfg(layers=None):
    import dataclasses

    cfg = get_config(LM_ARCH)
    return cfg if layers is None else dataclasses.replace(cfg, num_layers=layers)


def _first_periods(t, n):
    """A parameter tree, or a state tree of such trees, cut to its first n
    periods (every leaf under "stack" sliced to [:n])."""
    from repro_torch import tree

    if isinstance(t, dict):
        return {k: tree.tree_map(lambda x: x[:n], v) if k == "stack" else _first_periods(v, n)
                for k, v in t.items()}
    return t


def _train_loop(ckpt_dir, **kw):
    from repro_torch.train import LoopConfig

    base = dict(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, lr=TRAIN_LR, warmup=TRAIN_WARMUP,
                log_every=0, ckpt_dir=ckpt_dir)
    return LoopConfig(**dict(base, **kw))


def _rel(a, b):
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def _worst(got, want):
    """(worst relative error, its leaf's name) over two trees, each leaf
    relative to its largest magnitude."""
    from repro_torch import tree

    errs = [(_rel(a, b), tree.keystr(p))
            for (p, a), b in zip(tree.leaves_with_path(got), tree.leaves(want))]
    return max(errs)


def train_card_vs_cpu(name_power):
    """5b(a): the card against the host CPU from the same weights and AdamW
    state, at a reduced config (f32, d_model 320, 4 heads: head dim 80,
    which the flash kernel takes, so its counter would show a step that
    reached it). Two CPU steps warm the state first. Held within
    TRAIN_RTOL: the loss and every gradient leaf, the global norm, and the
    AdamW update given the same clipped gradients (the card's, on both). The
    whole make_train_step is then run on each side, its loss and grad norm
    held within TRAIN_RTOL and its worst updated leaf within
    TRAIN_STEP_RTOL; three faulty steps on the card (step index 3 for 2, no
    clip, bf16 parameters) must each land above TRAIN_STEP_RTOL."""
    import dataclasses

    from repro_torch import tree
    from repro_torch.configs import reduce_config
    from repro_torch.data import DataConfig, SyntheticTokens, to_device
    from repro_torch.launch import steps
    from repro_torch.optim import clip_by_global_norm, global_norm

    cfg = reduce_config(get_config(LM_ARCH), d_model=320)
    data = SyntheticTokens(DataConfig(cfg.vocab_size, 128, TRAIN_BATCH, seed=0))
    kw = dict(lr=TRAIN_LR, warmup=TRAIN_WARMUP, total_steps=100)
    step_cpu, opt, model = steps.make_train_step(cfg, device="cpu", **kw)
    step_gpu, _, model_gpu = steps.make_train_step(cfg, device="cuda", **kw)
    params = model.init(0)
    state = opt.init(params, device="cpu")
    for s in range(2):
        params, state, _ = step_cpu(params, state, to_device(data.batch(s), "cpu"), torch.tensor(s))
    copy = lambda t, dev: tree.tree_map(lambda x: x.to(dev).clone(), t)  # noqa: E731
    b_cpu, b_gpu = to_device(data.batch(2), "cpu"), to_device(data.batch(2), "cuda")

    # the gradients, the norm and the clip
    fa.LAUNCHES["flash_attention"] = 0
    p_gpu = copy(params, "cuda")
    loss_gpu, g_gpu = steps.loss_and_grads(model_gpu, p_gpu, b_gpu)
    loss_cpu, g_cpu = steps.loss_and_grads(model, copy(params, "cpu"), b_cpu)
    gn_gpu, gn_cpu = global_norm(g_gpu), global_norm(g_cpu)
    g_gpu = clip_by_global_norm(g_gpu, 1.0, gn_gpu)
    errs = {"loss": _rel(loss_gpu, loss_cpu), "grad_norm": _rel(gn_gpu, gn_cpu)}
    errs["grads"], grad_leaf = _worst(g_gpu, clip_by_global_norm(g_cpu, 1.0, gn_cpu))
    # the AdamW update on the same clipped gradients
    s_gpu = copy(state, "cuda")
    opt.update(p_gpu, g_gpu, s_gpu, torch.tensor(2, device="cuda"))
    p_ref, s_ref = copy(params, "cpu"), copy(state, "cpu")
    opt.update(p_ref, copy(g_gpu, "cpu"), s_ref, torch.tensor(2))
    errs["update"], update_leaf = _worst({"p": p_gpu, "s": s_gpu}, {"p": p_ref, "s": s_ref})

    # the whole step on each side, then the controls on the card
    two = torch.tensor(2, device="cuda")
    p_gpu, s_gpu, m_gpu = step_gpu(copy(params, "cuda"), copy(state, "cuda"), b_gpu, two)
    torch.cuda.synchronize()
    flash = fa.LAUNCHES["flash_attention"]
    controls = {"step index 3": step_gpu(copy(params, "cuda"), copy(state, "cuda"), b_gpu,
                                         torch.tensor(3, device="cuda"))[:2]}
    p_nc, s_nc = copy(params, "cuda"), copy(state, "cuda")
    controls["no clip"] = opt.update(p_nc, steps.loss_and_grads(model_gpu, p_nc, b_gpu)[1],
                                     s_nc, two)
    step_bf16 = steps.make_train_step(dataclasses.replace(cfg, dtype="bfloat16"),
                                      device="cuda", **kw)[0]
    p_bf, s_bf = step_bf16(tree.tree_map(lambda x: x.to("cuda", torch.bfloat16), params),
                           copy(state, "cuda"), b_gpu, two)[:2]
    controls["bf16 parameters"] = (tree.tree_map(torch.Tensor.float, p_bf), s_bf)
    params, state, m_cpu = step_cpu(params, state, b_cpu, torch.tensor(2))
    errs["step_loss"] = _rel(m_gpu["loss"], m_cpu["loss"])
    errs["step_grad_norm"] = _rel(m_gpu["grad_norm"], m_cpu["grad_norm"])
    step_err, step_leaf = _worst({"p": p_gpu, "s": s_gpu}, {"p": params, "s": state})
    control_errs = {k: _worst({"p": p, "s": st}, {"p": params, "s": state})[0]
                    for k, (p, st) in controls.items()}
    print(f"5b(a) reduced {cfg.name} (d_model {cfg.d_model}, head dim {cfg.head_dim}, f32), the "
          f"card vs the host CPU from the same weights and state (relative, at most "
          f"{TRAIN_RTOL}): loss {errs['loss']:.3e}, grad norm {errs['grad_norm']:.3e}, worst "
          f"gradient leaf {errs['grads']:.3e} ({grad_leaf}); AdamW update on the same gradients, "
          f"worst leaf {errs['update']:.3e} ({update_leaf}); the whole step: loss "
          f"{errs['step_loss']:.3e}, grad norm {errs['step_grad_norm']:.3e}, worst updated leaf "
          f"{step_err:.3e} ({step_leaf}; at most {TRAIN_STEP_RTOL}); controls, each above it: "
          + ", ".join(f"{k} {v:.3e}" for k, v in control_errs.items())
          + f"; flash launches {flash} ({name_power})", flush=True)
    assert flash == 0, f"a train step launched the flash kernel {flash} times"
    assert max(errs.values()) <= TRAIN_RTOL, errs
    assert step_err <= TRAIN_STEP_RTOL, (step_err, step_leaf)
    assert min(control_errs.values()) > TRAIN_STEP_RTOL, control_errs


def _split_step(model, opt, params, state, batch, step):
    """One train step in its three parts, each timed with CUDA events:
    forward + backward, the global norm and clip, the AdamW update (the
    sequence make_train_step runs without compression). Returns ms each."""
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.optim import clip_by_global_norm, global_norm

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    _, grads = loss_and_grads(model, params, batch)
    ev[1].record()
    gnorm = global_norm(grads)
    grads = clip_by_global_norm(grads, 1.0, gnorm)
    ev[2].record()
    opt.update(params, grads, state, torch.tensor(step, device="cuda"))
    ev[3].record()
    ev[3].synchronize()
    return [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]


def train_full_width(name_power):
    """5b(b) and (d): h2o-danube-1.8b at full width (bf16, remat on,
    AdamW): the routing check, TRAIN_STEPS steps, the step's split, a profiled step,
    then one checkpoint written and read back bit-equal on the host."""
    import shutil
    import tempfile

    from repro_torch import tree
    from repro_torch.data import DataConfig, SyntheticTokens, to_device
    from repro_torch.launch import steps
    from repro_torch.train import restore_checkpoint, save_checkpoint

    cfg = _train_cfg()
    assert cfg.remat and cfg.dtype == "bfloat16", (cfg.remat, cfg.dtype)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    train_step, opt, model = steps.make_train_step(cfg, lr=TRAIN_LR, warmup=TRAIN_WARMUP,
                                                   total_steps=100, device="cuda")
    assert opt.name == steps.default_optimizer(cfg) == "adamw", opt.name
    params = model.init(0)
    state = opt.init(params, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree.leaves(params))
    print(f"5b {LM_ARCH}: {n_params} parameters ({cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, remat {cfg.remat}, {cfg.dtype}), AdamW state "
          f"{sum(t.numel() * 4 for t in tree.leaves(state)) / 1e9:.2f} GB; init "
          f"{time.perf_counter() - t0:.3f} s; batch {TRAIN_BATCH} x {TRAIN_SEQ} tokens",
          flush=True)
    data = SyntheticTokens(DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0))

    # (d) the routing repair on the step's first batch
    batch = to_device(data.batch(0), "cuda")
    fa.LAUNCHES["flash_attention"] = 0
    with torch.no_grad():
        flash_loss, _ = model.loss_fn(params, batch)
    torch.cuda.synchronize()
    no_grad_launches = fa.LAUNCHES["flash_attention"]

    # (b) TRAIN_STEPS steps, each timed with CUDA events
    fa.LAUNCHES["flash_attention"] = 0
    hist, step_ms = [], []
    for step in range(TRAIN_STEPS):
        batch = to_device(data.batch(step), "cuda")
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        params, state, metrics = train_step(params, state, batch,
                                            torch.tensor(step, device="cuda"))
        stop.record()
        stop.synchronize()
        step_ms.append(start.elapsed_time(stop))
        hist.append((float(metrics["loss"]), float(metrics["grad_norm"])))
    step_launches = fa.LAUNCHES["flash_attention"]
    peak = torch.cuda.max_memory_allocated()
    grad_loss = hist[0][0]
    print(f"5b(d) routing at full width, batch 0: loss_fn under no_grad {float(flash_loss):.6f} "
          f"with {no_grad_launches} flash launches (one a layer: {cfg.num_layers}); the train "
          f"step's loss under grad {grad_loss:.6f} with {step_launches} flash launches over "
          f"{TRAIN_STEPS} steps; relative gap {abs(float(flash_loss) - grad_loss) / abs(grad_loss):.3e} "
          f"(at most {ROUTING_RTOL}) ({name_power})", flush=True)
    assert no_grad_launches == cfg.num_layers, no_grad_launches
    assert step_launches == 0, step_launches
    assert abs(float(flash_loss) - grad_loss) <= ROUTING_RTOL * abs(grad_loss)
    losses = [h[0] for h in hist]
    assert all(math.isfinite(a) and math.isfinite(g) for a, g in hist), hist
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    print(f"5b(b) {TRAIN_STEPS} steps: losses {' '.join(f'{x:.4f}' for x in losses)}; grad norms "
          f"{' '.join(f'{g:.3f}' for _, g in hist)}; mean of the first 5 {first:.4f}, of the last "
          f"5 {last:.4f} (must fall by {LOSS_DROP})", flush=True)
    assert last < first - LOSS_DROP, (first, last)
    steady = sorted(step_ms[5:])
    med = steady[len(steady) // 2]
    print(f"5b(b) ms a step (CUDA events, steps 5-{TRAIN_STEPS - 1}): median {med:.3f}, min "
          f"{steady[0]:.3f}, max {steady[-1]:.3f}; first step {step_ms[0]:.3f}; "
          f"{TRAIN_BATCH * TRAIN_SEQ / (med / 1e3):.1f} tokens/s; peak device memory "
          f"{peak / 2**30:.3f} GiB ({name_power})", flush=True)

    # the step's split, then one profiled step
    splits = []
    for i in range(TRAIN_SPLIT_STEPS):
        step = TRAIN_STEPS + i
        batch = to_device(data.batch(step), "cuda")
        splits.append(_split_step(model, opt, params, state, batch, step))
    fwd_bwd, clip, update = (sorted(x)[len(x) // 2] for x in zip(*splits))
    bound = n_params * ADAMW_BYTES / HBM_BYTES_PER_S * 1e3
    print(f"5b(b) a step's split (CUDA events, median of {TRAIN_SPLIT_STEPS}): forward + backward "
          f"{fwd_bwd:.3f} ms, global norm + clip {clip:.3f} ms, AdamW update {update:.3f} ms "
          f"against its bytes bound {bound:.3f} ms ({ADAMW_BYTES} B a parameter at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s: {100 * bound / update:.1f} %) ({name_power})",
          flush=True)
    counter = [TRAIN_STEPS + TRAIN_SPLIT_STEPS]
    dryrun_train_check(cfg, train_step, params, state, data, counter, med, name_power)

    def one_step():
        nonlocal params, state
        batch = to_device(data.batch(counter[0]), "cuda")
        params, state, _ = train_step(params, state, batch,
                                      torch.tensor(counter[0], device="cuda"))
        counter[0] += 1

    trace("train step (full width)", one_step, name_power, top=10)
    last_step = counter[0] - 1

    # one checkpoint of the trained tree's first CKPT_LAYERS periods (the
    # embedding, head and final norm whole): written from a host copy (the
    # device-to-host copy timed apart), the device tree freed, read back on
    # the host, bit-equal, under the checkout's build/ (a cache .gitignore
    # lists), not TMPDIR, which may be memory
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(prefix="train-ckpt-", dir=build)
    try:
        t0 = time.perf_counter()
        host = tree.tree_map(lambda t: t.cpu(), _first_periods({"p": params, "s": state},
                                                               CKPT_LAYERS))
        d2h = time.perf_counter() - t0
        del params, state, batch
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        path = save_checkpoint(ckpt_dir, last_step, host["p"], host["s"], extra={"data_seed": 0})
        write = time.perf_counter() - t0
        size = sum(f.stat().st_size for f in path.iterdir())
        template = transformer.param_template(_train_cfg(CKPT_LAYERS))
        t0 = time.perf_counter()
        p2, s2, _, step = restore_checkpoint(ckpt_dir, None, template,
                                             opt.init(template, device="meta"), device="cpu")
        read = time.perf_counter() - t0
        bits = lambda t: t.view(torch.int16 if t.element_size() == 2 else torch.int32)  # noqa: E731
        same = all(a.dtype == b.dtype and torch.equal(bits(a), bits(b))
                   for a, b in zip(tree.leaves(host), tree.leaves({"p": p2, "s": s2})))
        print(f"5b(b) checkpoint of step {step} ({CKPT_LAYERS} of {cfg.num_layers} layers): "
              f"{size / 1e9:.3f} GB; device-to-host copy "
              f"{d2h:.3f} s, write {write:.3f} s ({size / 1e9 / write:.2f} GB/s), read on the host "
              f"{read:.3f} s ({size / 1e9 / read:.2f} GB/s); bit-equal {same} ({name_power})",
              flush=True)
        assert same, "the checkpoint did not read back bit-equal"
        del host, p2, s2
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    gc.collect()
    return {"ms": med, "peak": peak}


def train_resume(name_power):
    """5b(c): full width at RESUME_LAYERS layers, 12 steps with a checkpoint
    every 4 and a crash at step 9, relaunched; against an uninterrupted run."""
    import shutil
    import tempfile

    from repro_torch.train import train

    cfg = _train_cfg(RESUME_LAYERS)
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    root = tempfile.mkdtemp(prefix="train-resume-", dir=build)
    try:
        t0 = time.perf_counter()
        ref = train(cfg, _train_loop(os.path.join(root, "ref"), total_steps=12, ckpt_every=0,
                                     resume=False), device="cuda")
        t_ref = time.perf_counter() - t0
        loop = _train_loop(os.path.join(root, "ft"), total_steps=12, ckpt_every=4, fail_at_step=9)
        t0 = time.perf_counter()
        try:
            train(cfg, loop, device="cuda")
            raise AssertionError("the injected failure did not fire")
        except RuntimeError as exc:
            assert "injected failure at step 9" in str(exc), exc
        t_crash = time.perf_counter() - t0
        t0 = time.perf_counter()
        hist = train(cfg, loop, device="cuda")
        t_resume = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    assert [h["step"] for h in hist] == [8, 9, 10, 11], [h["step"] for h in hist]
    want = {h["step"]: h["loss"] for h in ref}
    gaps = [abs(h["loss"] - want[h["step"]]) / abs(want[h["step"]]) for h in hist]
    got = " ".join(f"{h['loss']:.6f}" for h in hist)
    ref_losses = " ".join(f"{want[h['step']]:.6f}" for h in hist)
    print(f"5b(c) crash at step 9 and resume at {RESUME_LAYERS} layers, full width: resumed at "
          f"step {hist[0]['step']}; losses {got} against {ref_losses}; largest relative gap "
          f"{max(gaps):.3e} (at most {RESUME_RTOL}), bit-equal {max(gaps) == 0.0}; uninterrupted "
          f"run {t_ref:.1f} s, crashed run {t_crash:.1f} s, resumed run {t_resume:.1f} s "
          f"({name_power})", flush=True)
    assert max(gaps) <= RESUME_RTOL, gaps


def train_child():
    """5b(e) in a process of its own (`chip_smoke.py --train-child`, rank 0
    of an NCCL world of one: RANK / WORLD_SIZE / LOCAL_RANK and
    CUBLAS_WORKSPACE_CONFIG set by the parent, a FileStore), so that its
    process group and its deterministic mode never reach the phases after
    it."""
    import shutil
    import tempfile

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import tree
    from repro_torch.data import DataConfig, SyntheticTokens, to_device
    from repro_torch.launch import steps
    from repro_torch.train import restore_checkpoint, train, train_loop

    rank, world, local = (int(os.environ[k]) for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"))
    torch.cuda.set_device(local)
    name_power = card_line()
    cfg = _train_cfg(RESUME_LAYERS)
    root = tempfile.mkdtemp(prefix="train-dp-")
    make = steps.make_train_step
    template = transformer.param_template(cfg)
    opt_template = make(cfg, device="cuda")[1].init(template, device="meta")
    try:
        t0 = time.perf_counter()
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(root, "store"), world),
                                rank=rank, world_size=world)
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        init_ms = 1e3 * (time.perf_counter() - t0)

        def run(tag, mesh=None):  # the losses, and the parameters from the final checkpoint
            ckpt_dir = os.path.join(root, tag)
            hist = train(cfg, _train_loop(ckpt_dir, total_steps=4, ckpt_every=5),
                         mesh=mesh, device="cuda")
            params = restore_checkpoint(ckpt_dir, 3, template, opt_template, device="cpu")[0]
            shutil.rmtree(ckpt_dir)
            return [h["loss"] for h in hist], tree.leaves(params)

        same = lambda a, b: a[0] == b[0] and all(  # noqa: E731
            torch.equal(x, y) for x, y in zip(a[1], b[1]))
        plain = run("plain")
        torch.use_deterministic_algorithms(True)
        det = run("det")
        before = train_loop.COLLECTIVES["all_reduce"]
        dp = run("dp", mesh)
        reduces = train_loop.COLLECTIVES["all_reduce"] - before
        print(f"5b(e) NCCL world of one, mesh {tuple(mesh.shape)} {mesh.mesh_dim_names}, init "
              f"{init_ms:.1f} ms; {RESUME_LAYERS} layers at full width, 4 steps: the run without "
              f"deterministic algorithms bit-equal to the run with "
              f"torch.use_deterministic_algorithms(True) {same(plain, det)}; the "
              f"(1, 1) mesh run bit-equal to the run without a mesh {same(dp, det)} (losses "
              f"{' '.join(f'{x:.6f}' for x in dp[0])}); {reduces} all-reduces over the data "
              f"group ({name_power})", flush=True)
        assert same(dp, det), "the (1, 1) mesh run is not bit-equal to the run without a mesh"
        assert reduces == 4 * (2 + len(dp[1])), reduces  # a step: mask sum, loss, each leaf

        # a step's cost with and without deterministic algorithms, in turns
        step, opt, model = make(cfg, lr=TRAIN_LR, warmup=TRAIN_WARMUP, total_steps=100,
                                device="cuda")
        params = model.init(0)
        state = opt.init(params, device="cuda")
        batch = to_device(SyntheticTokens(DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH))
                          .batch(0), "cuda")
        zero = torch.tensor(0, device="cuda")
        ms = {}
        for tag, flag in (("off", False), ("on", True), ("on2", True), ("off2", False)):
            torch.use_deterministic_algorithms(flag)
            ms[tag] = time_ms(lambda: step(params, state, batch, zero), 5)
        print(f"5b(e) ms a step at {RESUME_LAYERS} layers (CUDA events, median of 5, in turns): "
              f"deterministic algorithms off {ms['off']:.3f} / {ms['off2']:.3f}, on "
              f"{ms['on']:.3f} / {ms['on2']:.3f} ({name_power})", flush=True)
    finally:
        torch.use_deterministic_algorithms(False)
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(root, ignore_errors=True)


def _run_beside(cmd, **kw):
    """Start subprocess.run(cmd, capture_output=True, text=True, **kw) on a
    thread; returns wait(), which joins it and returns (the completed
    process, its seconds), or raises what the run raised."""
    import threading

    done = {}

    def run():
        t0 = time.perf_counter()
        try:
            done["proc"] = subprocess.run(cmd, capture_output=True, text=True, **kw)
        except BaseException as e:  # noqa: BLE001 (re-raised by wait)
            done["error"] = e
        done["seconds"] = time.perf_counter() - t0

    thread = threading.Thread(target=run)
    thread.start()

    def wait():
        thread.join()
        if "error" in done:
            raise done["error"]
        return done["proc"], done["seconds"]

    return wait


def train_dp_phase():
    """Start 5b(e)'s child (train_child); returns finish(), which waits for
    it, prints its output and raises if it failed."""
    env = dict(os.environ, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
               CUBLAS_WORKSPACE_CONFIG=":4096:8")
    wait = _run_beside([sys.executable, os.path.abspath(__file__), "--train-child"],
                       timeout=600, env=env)

    def finish():
        proc, seconds = wait()
        sys.stdout.write(proc.stdout)
        sys.stdout.flush()
        if proc.returncode != 0:
            raise RuntimeError(f"train child failed ({proc.returncode}):\n{proc.stderr[-6000:]}")
        print(f"5b(e): {seconds:.1f} s, beside 5b(c) and 5b(f)", flush=True)

    return finish


def train_launcher(name_power):
    """5b(f): tests/test_watchdog.py:13-36 on the card, the port's launcher
    under the port's watchdog. Starts the watchdog's process tree and
    returns finish(), which waits for it and checks it."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="train-watchdog-")
    ckpt = os.path.join(root, "ckpt")
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    cmd = [sys.executable, "-m", "repro_torch.train.watchdog", "--heartbeat",
           os.path.join(ckpt, "heartbeat.json"), "--stall-s", "300", "--max-restarts", "2", "--",
           sys.executable, "-m", "repro_torch.launch.train", "--arch", LM_ARCH, "--reduced",
           "--steps", "8", "--batch", "2", "--seq", "16", "--ckpt-every", "2",
           "--fail-at-step", "5", "--device", "cuda", "--ckpt-dir", ckpt]
    wait = _run_beside(cmd, timeout=600, env=dict(os.environ, PYTHONPATH=src))

    def finish():
        try:
            proc, seconds = wait()
            steps_ = sorted(d for d in os.listdir(ckpt) if d.startswith("step_")) if os.path.isdir(
                ckpt) else []
        finally:
            shutil.rmtree(root, ignore_errors=True)
        restarts = [ln for ln in proc.stderr.splitlines() if ln.startswith("[watchdog]")]
        print(f"5b(f) watchdog -- launch.train --fail-at-step 5 --device cuda: exit "
              f"{proc.returncode}, {restarts}, checkpoints {steps_}, "
              f"{proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ''}; "
              f"{seconds:.1f} s, beside 5b(c) and 5b(e) ({name_power})", flush=True)
        assert proc.returncode == 0, proc.stderr[-4000:]
        assert steps_ and steps_[-1] == "step_00000007", steps_

    return finish


def train_phase(name_power):
    """Phase 5b: training on the card. 5b(e)'s child and 5b(f)'s process
    tree, which spend most of their time starting up, run beside 5b(c), as
    do 5g(c)'s two children and phases 5h's and 5i's two ranks each (5b(c)
    holds a resumed run's losses: a correctness check, whose seconds only
    inform)."""
    t0 = time.perf_counter()
    train_card_vs_cpu(name_power)
    train_full_width(name_power)
    gc.collect()
    torch.cuda.empty_cache()
    finish_launcher = train_launcher(name_power)
    try:
        finish_dp = train_dp_phase()
        try:
            finish_dryrun = dryrun_children(name_power)
            try:
                finish_tp = tp_children(name_power)
                try:
                    finish_tp5i = tp_mixers_children(name_power)
                    try:
                        train_resume(name_power)
                    finally:
                        finish_tp5i()
                finally:
                    finish_tp()
            finally:
                finish_dryrun()
        finally:
            finish_dp()
    finally:
        finish_launcher()
    print(f"phase 5b (with 5g(a), 5g(c), 5h and 5i): {time.perf_counter() - t0:.1f} s "
          f"({name_power})", flush=True)


def train_only():
    """`chip_smoke.py --train`: build the kernels and run phase 5b alone."""
    name_power = card_line()
    print(f"card: {name_power}", flush=True)
    _build.load()
    train_phase(name_power)
    print("5b held", flush=True)


# -- phase 5g: the dry run and the roofline against the card -------------------------

# (a) the dry run's predicted peak (its argument bytes plus its temp peak, the
# live storages the step allocates at once) against the step's
# max_memory_allocated(), on the basis dryrun_train_check prints
PEAK_RTOL = 0.10


def _dry_record(rec, arch, cell):
    """A one-rank dry-run record as launch/roofline.roofline reads it."""
    return dict(rec, arch=arch, shape=cell.name, mesh="card", devices=1)


def _roofline_line(rf, measured_ms, what):
    bound_ms = 1e3 * max(rf["t_compute_s"], rf["t_memory_s"], rf["t_collective_s"])
    return (f"roofline on the card's HW: compute {1e3 * rf['t_compute_s']:.3f} ms, memory "
            f"{1e3 * rf['t_memory_s']:.3f} ms, collective {1e3 * rf['t_collective_s']:.3f} ms, "
            f"dominant {rf['dominant']}; {what} {measured_ms:.3f} ms = "
            f"{measured_ms / bound_ms:.2f}x the dominant term; useful FLOPs (model / counted) "
            f"{rf['useful_ratio']:.3f}")


def dryrun_train_check(cfg, train_step, params, state, data, counter, step_ms, name_power):
    """5g(a): 5b's training cell (full width, bf16, remat, AdamW, batch
    TRAIN_BATCH x TRAIN_SEQ) dry-run on fake CUDA tensors, against one more
    real step (batch counter[0], which it advances) run under
    FlopCounterMode after reset_peak_memory_stats(): FLOPs equal, argument
    bytes equal to the bytes of the parameters, AdamW state, batch and step
    index held, no all-reduce on either side (no mesh; the (1, 1) mesh's
    are held in --dryrun-child), and the predicted peak within PEAK_RTOL of
    the measured one. Then the roofline on the card's HW beside 5b's
    median step."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import ShapeCell
    from repro_torch.data import to_device
    from repro_torch.launch import costs, dryrun, roofline
    from repro_torch.train import train_loop

    t_phase = time.perf_counter()
    cell = ShapeCell("5b", TRAIN_SEQ, TRAIN_BATCH, "train")
    t0 = time.perf_counter()
    rec = dryrun.lower_step(cfg, cell, device="cuda")
    dry_s = time.perf_counter() - t0
    batch = to_device(data.batch(counter[0]), "cuda")
    step_t = torch.tensor(counter[0], device="cuda")
    held = costs.storage_bytes((params, state, batch, step_t))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    reduces = train_loop.COLLECTIVES["all_reduce"]
    with FlopCounterMode(display=False) as counter_mode:
        train_step(params, state, batch, step_t)
    torch.cuda.synchronize()
    counter[0] += 1
    peak = torch.cuda.max_memory_allocated()
    reduces = train_loop.COLLECTIVES["all_reduce"] - reduces
    # basis: the step's peak above what was allocated before it that is not
    # its arguments (the allocator's rounding to 512-byte blocks and the
    # cuBLAS workspaces included)
    measured = peak - (before - held)
    predicted = rec["argument_size_in_bytes"] + rec["temp_size_in_bytes"]
    card_flops = counter_mode.get_total_flops()
    dry_reduces = rec["collectives"]["all-reduce"]["count"]
    gap = abs(predicted - measured) / measured
    print(f"5g(a) {LM_ARCH} train step ({TRAIN_BATCH} x {TRAIN_SEQ}, remat, AdamW) dry-run on "
          f"fake CUDA tensors in {dry_s:.1f} s: FLOPs {rec['hlo_flops']:.6e} (bf16 "
          f"{rec['flops']['bf16']:.6e}, f32 {rec['flops']['f32']:.6e}) against "
          f"FlopCounterMode's {card_flops:.6e} on the card's step; argument bytes "
          f"{rec['argument_size_in_bytes']} against {held} held; all-reduces {dry_reduces} "
          f"against train_loop.COLLECTIVES' {reduces}; predicted peak {predicted / 2**30:.3f} GiB "
          f"(arguments {rec['argument_size_in_bytes'] / 2**30:.3f} + temp "
          f"{rec['temp_size_in_bytes'] / 2**30:.3f}) against the step's "
          f"{measured / 2**30:.3f} GiB (max_memory_allocated {peak / 2**30:.3f} GiB less the "
          f"{(before - held) / 2**30:.3f} GiB allocated before the step outside its arguments): "
          f"{measured - predicted} bytes, {100 * gap:.4f} % apart (at most "
          f"{100 * PEAK_RTOL:.0f} %); eager bytes {rec['hlo_bytes']:.6e}, the most by "
          f"{ {k: f'{v:.4e}' for k, v in rec['top_bytes'].items()} } ({name_power})", flush=True)
    assert rec["hlo_flops"] == card_flops, (rec["hlo_flops"], card_flops)
    assert rec["argument_size_in_bytes"] == held, (rec["argument_size_in_bytes"], held)
    assert dry_reduces == reduces == 0, (dry_reduces, reduces)
    assert gap <= PEAK_RTOL, (predicted, measured)
    hw = mesh_mod.hw_for(torch.cuda.get_device_name(0))
    rf = roofline.roofline(_dry_record(rec, LM_ARCH, cell), cfg, cell, hw)
    mfu = rf["model_flops_dev"] / hw["peak_flops_bf16"] / (step_ms / 1e3)
    print(f"5g(a) {_roofline_line(rf, step_ms, '5b median step')}; model FLOPs "
          f"{rf['model_flops_dev']:.6e} / bf16 peak / the median step = {100 * mfu:.2f} % "
          f"({name_power}); 5g(a) {time.perf_counter() - t_phase:.1f} s", flush=True)


def dryrun_prefill_check(cfg, model, params, prompt, prefill_ms, name_power):
    """5g(b): phase 5's 4608-token prefill dry-run on fake CUDA tensors: its
    flash launches equal to one real prefill's LAUNCHES (one a layer), its
    roofline beside the measured ms."""
    from repro_torch.configs import ShapeCell
    from repro_torch.launch import dryrun, roofline

    t0 = time.perf_counter()
    cell = ShapeCell("5", len(prompt), 1, "prefill")
    rec = dryrun.lower_step(cfg, cell, device="cuda")
    dry_s = time.perf_counter() - t0
    batch = {"tokens": prompt[None].to("cuda", torch.int32)}
    n0 = fa.LAUNCHES["flash_attention"]
    with torch.no_grad():
        model.prefill(params, batch)
    torch.cuda.synchronize()
    real = fa.LAUNCHES["flash_attention"] - n0
    flash = rec["kernels"]["flash_attention"]
    rf = roofline.roofline(_dry_record(rec, LM_ARCH, cell), cfg, cell,
                           mesh_mod.hw_for(torch.cuda.get_device_name(0)))
    print(f"5g(b) prefill {len(prompt)} tokens dry-run on fake CUDA tensors in {dry_s:.1f} s: "
          f"flash launches {flash['launches']} (FLOPs {flash['flops']:.6e}) against the card's "
          f"{real}; FLOPs {rec['hlo_flops']:.6e}, eager bytes {rec['hlo_bytes']:.6e}; "
          f"{_roofline_line(rf, prefill_ms, 'phase 5 prefill')} ({name_power}); 5g(b) "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    assert flash["launches"] == real == cfg.num_layers, (flash, real)


def dryrun_child():
    """5g(c) and 5g(a)'s collectives in a process of its own (`chip_smoke.py
    --dryrun-child`, rank 0 of an NCCL world of one over a FileStore, as 3i
    and 5b(e)): a sharded tick_chunk at 3i's shapes and a data-parallel
    train step at RESUME_LAYERS layers on a (1, 1) mesh on the card, their
    all-gathers (api.sharded.GATHERS) and all-reduces
    (train_loop.COLLECTIVES) counted; then, the NCCL group destroyed, the
    same two calls on fake CUDA tensors over a fake group of one, whose
    counted collectives must be as many."""
    import shutil
    import tempfile

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.api import sharded
    from repro_torch.configs import ShapeCell
    from repro_torch.core.constants import STOParams
    from repro_torch.data import DataConfig, SyntheticTokens, to_device
    from repro_torch.launch import costs, dryrun, steps
    from repro_torch.train import train_loop

    rank, world, local = (int(os.environ[k]) for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"))
    torch.cuda.set_device(local)
    name_power = card_line()
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="dryrun-store-")
    cfg = _train_cfg(RESUME_LAYERS)
    try:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(root, "store"), world),
                                rank=rank, world_size=world)
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        spec = make_spec(N, n_in=1, seed=0, hold_steps=HOLD, device="cuda")
        sim = compile_plan(spec, _sharded_plan(mesh), device="cuda")
        u = torch.full((K, E, 1), 0.25, device="cuda")
        mask = torch.ones((K, E), dtype=torch.bool, device="cuda")
        m0 = ops.to_planes(spec.m0.expand(E, N, 3)).contiguous()
        g0 = sharded.GATHERS["all_gather"]
        sim.tick_chunk(m0, u, mask)
        torch.cuda.synchronize()
        gathers = sharded.GATHERS["all_gather"] - g0
        del sim, m0
        dp = train_loop.DataParallel(mesh, TRAIN_BATCH)
        step, opt, model = steps.make_train_step(cfg, device="cuda", grad_sync=dp.sync)
        params = model.init(0)
        state = opt.init(params, device="cuda")
        batch = to_device(SyntheticTokens(DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH))
                          .batch(0), "cuda", dp.batch_slice)
        r0 = train_loop.COLLECTIVES["all_reduce"]
        step(params, state, batch, torch.tensor(0, device="cuda"))
        torch.cuda.synchronize()
        reduces = train_loop.COLLECTIVES["all_reduce"] - r0
        del params, state, batch, model, opt, step
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(root, ignore_errors=True)

    t0 = time.perf_counter()
    with dryrun.fake_world(1):
        fmesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        with dryrun.fake_mode():
            f32 = dict(dtype=torch.float32, device="cuda")
            args = (STOParams(*(torch.empty((E, 1), **f32) for _ in STOParams._fields)),
                    torch.empty((N, N), **f32), torch.empty((N, 1), **f32),
                    torch.empty((E, N, 3), **f32), torch.empty((K, E, 1), **f32),
                    torch.ones((K, E), dtype=torch.bool, device="cuda"), DT, HOLD)
            _, chunk = costs.measure(sharded.tick_chunk_sharded, fmesh, *args, mesh=fmesh)
        train = dryrun.lower_step(cfg, ShapeCell("5b(e)", TRAIN_SEQ, TRAIN_BATCH, "train"),
                                  fmesh, "cuda")
    dry_gathers = chunk["collectives"]["all-gather"]["count"]
    dry_reduces = train["collectives"]["all-reduce"]["count"]
    print(f"5g(c) (1, 1) mesh, NCCL world of one: a sharded tick_chunk at N={N}, E={E}, K={K}, "
          f"hold {HOLD} ran {gathers} all-gathers on the card, its dry run counts {dry_gathers} "
          f"({chunk['collectives']['all-gather']['bytes']} bytes); a data-parallel train step at "
          f"{RESUME_LAYERS} layer(s), full width, ran {reduces} all-reduces, its dry run counts "
          f"{dry_reduces} ({train['collectives']['all-reduce']['bytes']} bytes); dry runs "
          f"{time.perf_counter() - t0:.1f} s ({name_power})", flush=True)
    assert dry_gathers == gathers == K * HOLD * 4, (dry_gathers, gathers)
    assert dry_reduces == reduces > 0, (dry_reduces, reduces)
    print(f"5g child: {time.perf_counter() - t_phase:.1f} s", flush=True)


def dryrun_children(name_power):
    """Start 5g(c)'s children beside the caller's work: the production
    reservoir dry run (`python -m repro_torch.launch.dryrun --reservoir`:
    256 fake ranks, N = 16 384, E = 8 192, the reference's 100 RK4 steps)
    and --dryrun-child. Returns finish(), which waits for both, prints
    their output and the reservoir record's roofline on the card's HW, and
    raises if either failed or miscounted."""
    from repro_torch.launch import roofline

    here = os.path.dirname(os.path.abspath(__file__))
    wait_res = _run_beside(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--reservoir"],
        timeout=600, cwd=here, env=dict(os.environ, PYTHONPATH=os.path.join(here, "src")))
    env = dict(os.environ, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1")
    wait_child = _run_beside([sys.executable, os.path.abspath(__file__), "--dryrun-child"],
                             timeout=600, env=env)

    def finish():
        proc, seconds = wait_child()
        res, res_s = wait_res()
        sys.stdout.write(proc.stdout)
        if proc.returncode != 0:
            raise RuntimeError(f"dry-run child failed ({proc.returncode}):\n{proc.stderr[-6000:]}")
        if res.returncode != 0:
            raise RuntimeError(f"the reservoir dry run failed ({res.returncode}):\n"
                               f"{res.stderr[-6000:]}")
        rec = json.loads(res.stdout.strip().splitlines()[-1])
        n, e = 16_384, 8_192
        state = 4 * (len(constants.STOParams._fields) * e + n * n + e * n * 3)
        t = roofline.terms(rec, mesh_mod.hw_for(torch.cuda.get_device_name(0)))
        print(f"5g(c) python -m repro_torch.launch.dryrun --reservoir ({res_s:.1f} s, "
              f"{rec['run_s']} s in the run): {json.dumps(rec)}", flush=True)
        print(f"5g(c) reservoir on the production mesh {rec['mesh']} ({rec['devices']} ranks), "
              f"{rec['n_steps']} steps, per rank: {rec['flops']['f32']:.6e} f32 FLOPs, "
              f"{rec['hlo_bytes']:.6e} eager bytes, all-gathers "
              f"{rec['collectives']['all-gather']['count']} "
              f"({rec['collectives']['all-gather']['bytes'] / 2**30:.3f} GiB; by mesh dim "
              f"{rec['collective_bytes_by_dim']}), arguments "
              f"{rec['argument_size_in_bytes'] / 2**30:.3f} GiB (the global state on every rank), "
              f"temp {rec['temp_size_in_bytes'] / 2**30:.3f} GiB; terms on the card's HW: compute "
              f"{1e3 * t['compute']:.3f} ms, memory {1e3 * t['memory']:.3f} ms, collective "
              f"{1e3 * t['collective']:.3f} ms ({name_power}); the child {seconds:.1f} s",
              flush=True)
        assert rec["devices"] == 256 and rec["mesh"] == "pod32x8", rec["mesh"]
        assert rec["collectives"]["all-gather"]["count"] == 4 * 100 + 2
        assert rec["argument_size_in_bytes"] == state, (rec["argument_size_in_bytes"], state)

    return finish


def dryrun_only():
    """`chip_smoke.py --dryrun`: build the kernels and run phase 5g alone,
    with h2o-danube-1.8b trained and served here instead of in 5b and 5
    (5b's median over steps 1-3 of 4)."""
    from repro_torch.data import DataConfig, SyntheticTokens, to_device
    from repro_torch.launch import steps

    name_power = card_line()
    print(f"card: {name_power}", flush=True)
    _build.load()
    finish = dryrun_children(name_power)
    try:
        cfg = _train_cfg()
        train_step, opt, model = steps.make_train_step(cfg, lr=TRAIN_LR, warmup=TRAIN_WARMUP,
                                                       total_steps=100, device="cuda")
        params = model.init(0)
        state = opt.init(params, device="cuda")
        data = SyntheticTokens(DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0))
        step_ms = []
        for step in range(4):
            batch = to_device(data.batch(step), "cuda")
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            train_step(params, state, batch, torch.tensor(step, device="cuda"))
            stop.record()
            stop.synchronize()
            step_ms.append(start.elapsed_time(stop))
        dryrun_train_check(cfg, train_step, params, state, data, [4], sorted(step_ms[1:])[1],
                           name_power)
        del params, state, batch
        gc.collect()
        torch.cuda.empty_cache()
        serve_params = build_model(cfg, "cuda").init(torch.Generator(device="cuda").manual_seed(0))
        prompt = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                                    PROMPTS[0]))
        batch = {"tokens": prompt[None].cuda()}
        prefill_ms = time_ms(lambda: model.prefill(serve_params, batch), 3)
        dryrun_prefill_check(cfg, model, serve_params, prompt, prefill_ms, name_power)
    finally:
        finish()
    print("5g held", flush=True)


# -- phase 5h: tensor parallelism, two ranks on one card over gloo -----------------

# (a) h2o-danube-1.8b whole: a TP_PROMPT-token prefill at TP_ROWS rows, then
# TP_NEW decode steps fed teacher tokens; (b) its TP_TRAIN_STEPS AdamW steps
# at TP_TRAIN_LAYERS layers (5b's batch, sequence, lr, warmup and remat);
# (d) qwen2-moe-a2.7b cut to TP_MOE_LAYERS layers, in its config's bf16, the
# same prefill and TP_MOE_NEW decode steps
TP_PROMPT, TP_ROWS, TP_NEW = 512, 4, 16
TP_TRAIN_LAYERS, TP_TRAIN_STEPS = 2, 3
TP_MOE_LAYERS, TP_MOE_NEW = 2, 8
# the two ranks against one rank, bf16 on both sides. A row-parallel product
# is two bf16 GEMMs (each rounded to bf16) summed in f32 and rounded once
# more, where one rank rounds one GEMM once, so the residual stream and what
# follows carry one bf16 rounding more a row-parallel layer.
# Read on an H100 80GB HBM3 at 700 W: (a) 1.82e-2 and 1.85e-2 on the two
# ranks' blocks, one greedy token of 64 off one rank's argmax at a gap of
# 1.49e-2; (d) 1.09e-2 and 1.05e-2; (b) losses 1.38e-5, grad norms 1.11e-4.
TP_LOGIT_RTOL = 5e-2  # max |logit - one rank's| / max |one rank's|, bf16, ~2.7x the reading
TP_FLIP_GAP = LOGIT_MARGIN  # a greedy token off one rank's argmax: its gap there (phase 5's)
TP_LOSS_RTOL = 1e-3  # losses and grad norms, relative, ~9x the reading
# (b) every leaf's update, ||(leaf - init) - one rank's|| / ||one rank's||
# over the rank's block: a step that skipped the update reads 1, one that
# took a fourth step 1.02 (a CPU run at reduced width, f32, whose sound
# reading is 5e-6). In bf16 an update of a few ulps of a leaf rounds either
# way: read 7.79e-2 and 7.43e-2 (the embedding), ~3.2x below the limit
TP_UPDATE_RTOL = 0.25
# (d): two bf16 runs whose router inputs are roundings apart can send a
# token to another top-4 of 60 experts where its 4th and 5th router logits
# nearly tie, and that token's output then differs by more than a rounding.
# So (d) runs one rank with the mesh's experts (moe.assign), its sums
# otherwise its own, and holds against it the mesh's logits at
# TP_LOGIT_RTOL and every moe.route call: the router logits' drift (the
# most a difference of two of a token's logits moved, over every token)
# against the largest spread of a token's logits, a relative measure as
# TP_LOGIT_RTOL's; and a token whose top-4 on one rank would have differed
# must have its 4th-5th gap there within the same share of the spread (a
# near-tie). Read: a drift of 8.36e-3 of the spread (about two bf16
# roundings, 2^-8 each); 106 of 4096 prefill tokens and 2 of 32 decode
# tokens whose own top-4 would differ, gaps up to 2.0e-2 (2.8e-3 of the
# spread); against one rank's own routing the logits read 6.74e-2 and
# 6.93e-2. The limit, eight roundings, is ~3.7x the drift read.
TP_ROUTE_RTOL = 2**-5
TP_DEVICE = "cuda"


def _tp_cfgs():
    """(a)'s, (b)'s and (d)'s configs."""
    import dataclasses

    return (get_config(LM_ARCH), _train_cfg(TP_TRAIN_LAYERS),
            dataclasses.replace(get_config(MOE_ARCH), num_layers=TP_MOE_LAYERS))


def _tp_sync(dev):
    if dev == "cuda":
        torch.cuda.synchronize()


def _tp_peak_reset(dev):
    if dev == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def _tp_peak(dev):
    return torch.cuda.max_memory_allocated() if dev == "cuda" else 0


@contextlib.contextmanager
def _tp_routing(force=None):
    """Record every moe.route call: (log probs (T, E) f32, its own top-k
    experts (T, K)) on the host, in call order. With `force` (another run's
    records) each call then takes that run's experts (moe.assign)."""
    from repro_torch.models import moe

    real, calls = moe.route, []

    def spy(p, cfg_moe, x):
        r = real(p, cfg_moe, x)
        calls.append((r.probs.log().cpu(), r.top_e.cpu()))
        if force is not None:
            r = moe.assign(r.probs, force[len(calls) - 1][1].to(x.device), r.cap)
        return r

    moe.route = spy
    try:
        yield calls
    finally:
        moe.route = real


def _tp_new(cfg):
    """5h's decode steps for cfg: TP_MOE_NEW where it has an MoE config."""
    return TP_NEW if cfg.moe is None else TP_MOE_NEW


def _tp_serve_run(cfg, mesh, dev, force=None, prompt=TP_PROMPT, new=None, frames=0, count=True):
    """One prefill of `prompt` tokens at TP_ROWS rows (with `frames`
    encoder frames for an encoder-decoder arch) and the decode steps
    (teacher tokens, make_serve_steps' greedy token beside each), on one
    rank (mesh None) or on the mesh; every input from numpy seed 0, weights
    init(0); MoE routing replayed from `force` where given. Returns the
    last-position logits of each call (f32, on the host; the rank's vocab
    block on the mesh), the greedy tokens, the flash launches of the prefill
    and the (H, KVH) of each, the route calls (MoE) and how many the
    prefill made, host ms (gloo-staged on the mesh), peak bytes and, on the
    mesh (with `count`), each call's collectives on "model" under
    costs.CostMode."""
    from repro_torch.launch import costs, steps
    from repro_torch.models import attention

    if new is None:
        new = _tp_new(cfg)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (TP_ROWS, prompt))).to(dev)
    teacher = torch.from_numpy(rng.integers(0, cfg.vocab_size, (TP_ROWS, new))).to(dev)
    batch = {"tokens": tokens}
    if frames:
        batch["encoder_frames"] = torch.from_numpy(
            0.02 * rng.standard_normal((TP_ROWS, frames, cfg.d_model))).to(dev,
                                                                          transformer._dtype_of(cfg))
    _tp_peak_reset(dev)
    params = build_model(cfg, dev, mesh).init(0)
    prefill, decode = steps.make_serve_steps(cfg, dev, mesh)
    heads = []
    launch = attention.flash_attention_bshd

    def spy(q, k, v, **kw):
        heads.append((q.shape[2], k.shape[2]))
        return launch(q, k, v, **kw)

    with _tp_routing(force) as routes:
        attention.flash_attention_bshd = spy
        try:
            sto_step.reset_launches()
            t0 = time.perf_counter()
            last, caches = prefill(params, batch)
            _tp_sync(dev)
            prefill_ms = 1e3 * (time.perf_counter() - t0)
            launches = sto_step.LAUNCHES["flash_attention"]
        finally:
            attention.flash_attention_bshd = launch
        n_prefill_routes = len(routes)
        caches = transformer.pad_caches(cfg, caches, prompt + new, mesh)
        logits, toks = [last[:, -1].float().cpu()], []
        t0 = time.perf_counter()
        for i in range(new):
            pos = torch.full((TP_ROWS,), prompt + i, dtype=torch.int32, device=dev)
            tok, lg, caches = decode(params, {"tokens": teacher[:, i:i + 1], "caches": caches,
                                              "pos": pos})
            logits.append(lg[:, -1].float().cpu())
            toks.append(tok.cpu())
        _tp_sync(dev)
    rec = dict(logits=torch.stack(logits), toks=torch.stack(toks), launches=launches, heads=heads,
               prefill_ms=prefill_ms, decode_ms=1e3 * (time.perf_counter() - t0) / new,
               peak=_tp_peak(dev), routes=routes, n_prefill_routes=n_prefill_routes, prompt=prompt)
    if mesh is not None and count:
        _, c = costs.measure(prefill, params, batch, mesh=mesh)
        rec["prefill_reduces"] = c["collective_counts_by_dim"].get("model", 0)
        pos = torch.full((TP_ROWS,), prompt + new - 1, dtype=torch.int32, device=dev)
        _, c = costs.measure(decode, params, {"tokens": teacher[:, :1], "caches": caches,
                                              "pos": pos}, mesh=mesh)
        rec["decode_reduces"] = c["collective_counts_by_dim"].get("model", 0)
    return rec


def _tp_train_run(cfg, mesh, dev, batch_rows=TRAIN_BATCH, seq=TRAIN_SEQ):
    """TP_TRAIN_STEPS AdamW steps of 5b's cell (or of batch_rows x seq
    tokens) from init(0) on one rank or on the mesh. Returns the losses, grad norms, host ms a step, peak bytes and
    every leaf after the last step (on the host; the rank's blocks on the
    mesh), and on the mesh the init(0) blocks and one more step's
    all-reduces on "model"."""
    from repro_torch import tree
    from repro_torch.data import DataConfig, SyntheticTokens, to_device
    from repro_torch.launch import costs, steps

    step, opt, model = steps.make_train_step(cfg, lr=TRAIN_LR, warmup=TRAIN_WARMUP,
                                             total_steps=100, device=dev, mesh=mesh)
    _tp_peak_reset(dev)
    params = model.init(0)
    init = [t.to("cpu", copy=True) for t in tree.leaves(params)] if mesh is not None else None
    state = opt.init(params, device=dev)
    data = SyntheticTokens(DataConfig(cfg.vocab_size, seq, batch_rows))
    losses, norms, ms = [], [], []
    for s in range(TP_TRAIN_STEPS):
        batch = to_device(data.batch(s), dev)
        t0 = time.perf_counter()
        params, state, met = step(params, state, batch, torch.tensor(s, device=dev))
        _tp_sync(dev)
        ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
    rec = dict(losses=losses, norms=norms, ms=ms, peak=_tp_peak(dev), init=init,
               leaves=[t.to("cpu", copy=True) for t in tree.leaves(params)])
    if mesh is not None:
        _, c = costs.measure(step, params, state, batch, torch.tensor(TP_TRAIN_STEPS, device=dev),
                             mesh=mesh)
        rec["train_reduces"] = c["collective_counts_by_dim"].get("model", 0)
    return rec


def _tp_hold_serve(tag, cfg, got, want, rank, name_power, against="one rank", launches=None,
                   heads=None, rtol=None, phase="5h"):
    """A rank's serving run against one rank's: its vocab block of every
    call's last-position logits (within `rtol`, TP_LOGIT_RTOL by default),
    its greedy tokens (flips and their gaps in one rank's logits), the flash
    launches (`launches`, a layer each by default) and heads a prefill
    (`heads`, the rank's (H, KVH) by default)."""
    rtol = TP_LOGIT_RTOL if rtol is None else rtol
    n = got["logits"].shape[-1]
    ref = want["logits"][..., rank * n:(rank + 1) * n]
    err = float((got["logits"] - ref).abs().max() / ref.abs().max())
    ref_tok = want["logits"][1:].argmax(dim=-1)
    flips = (got["toks"] != ref_tok).nonzero().tolist()
    full = want["logits"][1:]
    gaps = [float(full[s, r].max() - full[s, r, got["toks"][s, r]]) for s, r in flips]
    local = (cfg.num_heads // 2, cfg.num_kv_heads // 2) if heads is None else heads
    launches = cfg.num_layers if launches is None else launches
    print(f"{phase}{tag} rank {rank}, {cfg.name} ({cfg.num_layers} layers, full width, {cfg.dtype}) "
          f"on a (1, 2) mesh over gloo against {against}: prefill {got['prompt']} tokens x "
          f"{TP_ROWS} rows and {got['toks'].shape[0]} teacher-fed decode steps; logits (vocab "
          f"block {n} of {cfg.padded_vocab}) max |diff| / max |one rank's| {err:.3e} (at most "
          f"{rtol}); greedy tokens off one rank's argmax {len(flips)} of "
          f"{got['toks'].numel()}, gaps {[f'{g:.3e}' for g in gaps]} (at most {TP_FLIP_GAP}); "
          f"flash launches a prefill "
          f"{got['launches']} (expected {launches}) on (H, KVH) {sorted(set(got['heads']))}; "
          f"host ms, gloo staging the all-reduces through the host (no speed claim): prefill "
          f"{got['prefill_ms']:.1f} (one rank {want['prefill_ms']:.1f}), a decode step "
          f"{got['decode_ms']:.1f} (one rank {want['decode_ms']:.1f}); peak "
          f"{got['peak'] / 2**30:.3f} GiB, one rank {want['peak'] / 2**30:.3f} GiB "
          f"({name_power})", flush=True)
    assert got["launches"] == launches, (got["launches"], launches)
    assert set(got["heads"]) == ({local} if launches else set()), (got["heads"], local)
    assert err <= rtol, (tag, err)
    assert all(g <= TP_FLIP_GAP for g in gaps), (tag, gaps)


def _tp_hold_routing(cfg, got, want, rank, mesh, phase="5h(d)"):
    """(d)'s routing on the mesh against one rank's run with the mesh's
    routing (`want`, whose calls hold what the rank's own top-k would have
    been), call by call: the same on both ranks; the router logits' drift
    within TP_ROUTE_RTOL of the largest spread; per layer the tokens whose
    own top-k differs, each a near-tie in the one-rank run."""
    import torch.distributed as dist

    assert (len(got["routes"]), got["n_prefill_routes"]) == (
        len(want["routes"]), want["n_prefill_routes"]), (len(got["routes"]), len(want["routes"]))
    experts = torch.cat([e.reshape(-1) for _, e in got["routes"]]).to(TP_DEVICE)
    lo, hi = experts.clone(), experts.clone()
    dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=mesh.get_group("model"))
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=mesh.get_group("model"))
    assert torch.equal(lo, hi), "the two ranks routed differently"
    k, n_pre = cfg.moe.top_k, got["n_prefill_routes"]
    n_layers = (sum(s.mlp == "moe" for s in cfg.prefix)
                + cfg.num_periods * sum(s.mlp == "moe" for s in cfg.period))  # routed layers
    drift, spread = 0.0, 0.0
    off = {(kind, layer): [] for kind in ("prefill", "decode") for layer in range(n_layers)}
    for i, ((lp, e), (lp1, e1)) in enumerate(zip(got["routes"], want["routes"])):
        where = (("prefill", i // (n_pre // n_layers)) if i < n_pre
                 else ("decode", (i - n_pre) % n_layers))
        d = lp - lp1
        drift = max(drift, float((d.amax(-1) - d.amin(-1)).max()))
        spread = max(spread, float((lp1.amax(-1) - lp1.amin(-1)).max()))
        ranked = lp1.sort(dim=-1, descending=True).values
        for t in (e.sort(-1).values != e1.sort(-1).values).any(-1).nonzero()[:, 0].tolist():
            off[where].append(float(ranked[t, k - 1] - ranked[t, k]))
    gaps = sorted(g for v in off.values() for g in v)
    tokens = sum(int(e.shape[0]) for _, e in want["routes"][:n_pre // n_layers])
    print(f"{phase} rank {rank}, {cfg.name}'s routing on the mesh against one rank with the "
          f"mesh's routing: "
          f"the same on both ranks; "
          f"router logits' drift {drift:.3e} of the largest spread {spread:.3e} "
          f"({drift / spread:.3e}, at most {TP_ROUTE_RTOL:.3e}); tokens whose top-{k} experts "
          f"on one rank would differ, per layer (of {tokens} a prefill layer, {TP_ROWS} a decode "
          f"step's): "
          + "; ".join(f"{kind} layer {layer} {len(v)}" for (kind, layer), v in off.items())
          + f"; their gaps between the {k}th and {k + 1}th logit there "
          f"{[f'{g:.3e}' for g in gaps]} "
          f"(each at most {TP_ROUTE_RTOL:.3e} of the spread, {TP_ROUTE_RTOL * spread:.3e})",
          flush=True)
    assert drift <= TP_ROUTE_RTOL * spread, (drift, spread)
    assert all(g <= TP_ROUTE_RTOL * spread for g in gaps), (gaps, spread)


def _tp_dry_counts(dev):
    """(a), (b) and (d)'s calls dry-run over a fake (1, 2) group on fake
    tensors: {call: all-reduces on "model"}."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import ShapeCell
    from repro_torch.launch import dryrun

    serve_cfg, train_cfg, moe_cfg = _tp_cfgs()
    cells = {
        "prefill": (serve_cfg, ShapeCell("5h", TP_PROMPT, TP_ROWS, "prefill")),
        "decode": (serve_cfg, ShapeCell("5h", TP_PROMPT + TP_NEW, TP_ROWS, "decode")),
        "train": (train_cfg, ShapeCell("5h", TRAIN_SEQ, TRAIN_BATCH, "train")),
        "moe_prefill": (moe_cfg, ShapeCell("5h", TP_PROMPT, TP_ROWS, "prefill")),
        "moe_decode": (moe_cfg, ShapeCell("5h", TP_PROMPT + TP_MOE_NEW, TP_ROWS, "decode")),
    }
    with dryrun.fake_world(2):
        fmesh = init_device_mesh(dev, (1, 2), mesh_dim_names=("data", "model"))
        return {tag: dryrun.lower_step(cfg, cell, fmesh, dev)["collective_counts_by_dim"].get(
            "model", 0) for tag, (cfg, cell) in cells.items()}


def _tp_hold_updates(cfg, b, want, mesh, dev):
    """(b)'s leaves on the mesh against one rank's: the init(0) blocks equal
    to the one-rank draws' slices and replicated leaves bit-equal across the
    ranks (asserted); returns the worst leaf update's (||diff|| / ||one
    rank's||, its leaf)."""
    import torch.distributed as dist

    from repro_torch import tree
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed import tensor_parallel as tp

    template = transformer.param_template(cfg)
    specs = tree.leaves(shd.param_specs(mesh, template))
    whole_init = [t.cpu() for t in tree.leaves(build_model(cfg, dev).init(0))]
    errs = []
    for (path, _), got, init, whole, w0, s in zip(tree.leaves_with_path(template), b["leaves"],
                                                  b["init"], want["leaves"], whole_init, specs):
        name = tree.keystr(path)
        assert torch.equal(init, tp.block(w0, s, mesh)), name
        ref = tp.block(whole, s, mesh).double() - init.double()
        diff, scale = float((got.double() - init.double() - ref).norm()), float(ref.norm())
        errs.append((diff / scale if scale else (0.0 if diff == 0 else math.inf), name))
        if tp.model_dim(s) is None:  # replicated: bit-equal across the ranks
            x = got.to(dev).float()
            lo, hi = x.clone(), x.clone()
            dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=mesh.get_group("model"))
            dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=mesh.get_group("model"))
            assert torch.equal(lo, x) and torch.equal(hi, x), f"{name} differs across the ranks"
    return max(errs)


def tp_child(out_dir):
    """Phase 5h's ranks (`chip_smoke.py --tp-child DIR`, RANK 0 or 1 of a gloo
    world of two over a FileStore in DIR, both on card 0: NCCL runs no two
    ranks on one card). Before the group exists, the one-rank references,
    split over the two (rank 0: (a), (d) and (c)'s dry runs over a fake
    group; rank 1: (b)), saved in DIR; then on a (1, 2) ("data", "model")
    mesh (a) to (d), each rank held against the slices of the references
    ((d)'s logits against one rank run with the mesh's routing); the
    collective counts go to DIR/rank{r}.json."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    rank, dev = int(os.environ["RANK"]), TP_DEVICE
    if dev == "cuda":
        torch.cuda.set_device(0)
    name_power = card_line()
    t_child = time.perf_counter()
    serve_cfg, train_cfg, moe_cfg = _tp_cfgs()
    t0 = time.perf_counter()
    if rank == 0:
        t1 = time.perf_counter()
        dry = _tp_dry_counts(dev)
        with open(os.path.join(out_dir, "dry0.json"), "w") as f:
            json.dump(dry, f)
        t_dry = time.perf_counter() - t1
        ref = {"a": _tp_serve_run(serve_cfg, None, dev), "d": _tp_serve_run(moe_cfg, None, dev)}
    else:
        ref = {"b": _tp_train_run(train_cfg, None, dev)}
    torch.save(ref, os.path.join(out_dir, f"ref{rank}.pt"))
    del ref
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter() - t0
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(out_dir, "store"), 2),
                            rank=rank, world_size=2)
    try:
        mesh = init_device_mesh(dev, (1, 2), mesh_dim_names=("data", "model"))
        dist.barrier()
        ref = {}
        for r in (0, 1):
            ref.update(torch.load(os.path.join(out_dir, f"ref{r}.pt")))

        # the kernel at the heads a rank launches it on, against its plain version
        for cfg in (serve_cfg, moe_cfg) if dev == "cuda" else ():
            g = torch.Generator(device="cuda").manual_seed(rank)
            h, kvh, d = cfg.num_heads // 2, cfg.num_kv_heads // 2, cfg.head_dim
            q, k, v = (torch.randn((TP_ROWS, TP_PROMPT, n, d), generator=g, device="cuda")
                       .to(torch.bfloat16) for n in (h, kvh, kvh))
            err = float((fa.flash_attention_bshd(q, k, v, causal=True,
                                                 window=cfg.sliding_window).float()
                         - plain_bshd(q, k, v, cfg.sliding_window).float()).abs().max())
            print(f"5h rank {rank}: flash_bf16<{d}> at {cfg.name}'s H {h}, KVH {kvh}, "
                  f"B {TP_ROWS}, {TP_PROMPT} tokens, window {cfg.sliding_window}, against its "
                  f"plain version: max |err| {err:.3e} (at most {FLASH_ATOL[torch.bfloat16]})",
                  flush=True)
            assert err <= FLASH_ATOL[torch.bfloat16], err
            del q, k, v

        t0 = time.perf_counter()
        a = _tp_serve_run(serve_cfg, mesh, dev)
        _tp_hold_serve("(a)", serve_cfg, a, ref["a"], rank, name_power)
        del a["logits"]
        gc.collect()
        d_run = _tp_serve_run(moe_cfg, mesh, dev)
        forced = _tp_serve_run(moe_cfg, None, dev, force=d_run["routes"])
        _tp_hold_routing(moe_cfg, d_run, forced, rank, mesh)
        n = d_run["logits"].shape[-1]
        own = ref["d"]["logits"][..., rank * n:(rank + 1) * n]
        print(f"5h(d) rank {rank}: logits against one rank with its own routing "
              f"{float((d_run['logits'] - own).abs().max() / own.abs().max()):.3e} (not held: "
              f"a token routed otherwise changes the tokens after it)", flush=True)
        forced.update(prefill_ms=ref["d"]["prefill_ms"], decode_ms=ref["d"]["decode_ms"],
                      peak=ref["d"]["peak"])
        _tp_hold_serve("(d)", moe_cfg, d_run, forced, rank, name_power,
                       against="one rank with the mesh's routing")
        del forced
        gc.collect()
        b = _tp_train_run(train_cfg, mesh, dev)
        want = ref["b"]
        worst = _tp_hold_updates(train_cfg, b, want, mesh, dev)
        loss_err = max(abs(x - y) / abs(y) for x, y in zip(b["losses"], want["losses"]))
        norm_err = max(abs(x - y) / abs(y) for x, y in zip(b["norms"], want["norms"]))
        print(f"5h(b) rank {rank}, {train_cfg.name} at {TP_TRAIN_LAYERS} layers, full width, "
              f"{TP_TRAIN_STEPS} AdamW steps (batch {TRAIN_BATCH} x {TRAIN_SEQ}, remat) on the "
              f"mesh against one rank: losses {' '.join(f'{x:.6f}' for x in b['losses'])} "
              f"against {' '.join(f'{x:.6f}' for x in want['losses'])} (largest relative gap "
              f"{loss_err:.3e}), grad norms largest relative gap {norm_err:.3e} (at most "
              f"{TP_LOSS_RTOL}); init(0) blocks equal to the one-rank draws' slices; every "
              f"leaf's update after step {TP_TRAIN_STEPS}, ||diff|| / ||one rank's||: worst "
              f"{worst[0]:.3e} ({worst[1]}; at most {TP_UPDATE_RTOL}; a skipped update reads "
              f"1); replicated leaves bit-equal across the ranks; host ms a step, gloo-staged "
              f"(no speed claim) {' '.join(f'{x:.1f}' for x in b['ms'])} (one rank "
              f"{' '.join(f'{x:.1f}' for x in want['ms'])}); peak {b['peak'] / 2**30:.3f} GiB, "
              f"one rank {want['peak'] / 2**30:.3f} GiB ({name_power})", flush=True)
        assert loss_err <= TP_LOSS_RTOL and norm_err <= TP_LOSS_RTOL, (loss_err, norm_err)
        assert worst[0] <= TP_UPDATE_RTOL, worst
        counts = {"prefill": a["prefill_reduces"], "decode": a["decode_reduces"],
                  "train": b["train_reduces"], "moe_prefill": d_run["prefill_reduces"],
                  "moe_decode": d_run["decode_reduces"]}
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(counts, f)
        print(f"5h rank {rank}: references {t_ref:.1f} s"
              + (f" (the dry runs {t_dry:.1f} s of them)" if rank == 0 else "")
              + f", the mesh's runs "
              f"{time.perf_counter() - t0:.1f} s, the child {time.perf_counter() - t_child:.1f} s "
              f"({name_power})", flush=True)
    finally:
        dist.destroy_process_group()


def _tp_ranks(flag, label, name_power):
    """Start a tensor-parallel phase's two ranks (`chip_smoke.py FLAG DIR`,
    RANK 0 and 1, on card 0) beside the caller's work; returns finish(),
    which waits for them, prints their output and holds the ranks'
    collectives on "model" a call (DIR/rank{r}.json, costs.CostMode on the
    card) equal to each other and to the dry run's (DIR/dry*.json, over a
    fake (1, 2) group on fake tensors). `label` names the phase and the
    part that prints the counts ("5h(c)")."""
    import glob
    import shutil
    import tempfile

    phase = label.split("(")[0]
    root = tempfile.mkdtemp(prefix=f"tp{phase}-")
    t0 = time.perf_counter()
    waits = [_run_beside([sys.executable, os.path.abspath(__file__), flag, root],
                         timeout=900, env=dict(os.environ, RANK=str(r), WORLD_SIZE="2",
                                               LOCAL_RANK="0"))
             for r in (0, 1)]

    def finish():
        try:
            procs = [w() for w in waits]
            for r, (proc, seconds) in enumerate(procs):
                sys.stdout.write(proc.stdout)
                sys.stdout.flush()
                if proc.returncode != 0:
                    raise RuntimeError(f"{phase} rank {r} failed ({proc.returncode}):\n"
                                       f"{proc.stderr[-6000:]}")
            counts, dry = [], {}
            for r in (0, 1):
                with open(os.path.join(root, f"rank{r}.json")) as f:
                    counts.append(json.load(f))
            for path in sorted(glob.glob(os.path.join(root, "dry*.json"))):
                with open(path) as f:
                    dry.update(json.load(f))
        finally:
            shutil.rmtree(root, ignore_errors=True)
        print(f"{label} collectives on \"model\" a call, costs.CostMode on the card (rank 0 / "
              f"rank 1) against the dry run over a fake (1, 2) group: "
              + "; ".join(f"{t} {counts[0][t]} / {counts[1][t]} vs {dry[t]}" for t in sorted(dry)),
              flush=True)
        for t in dry:
            assert counts[0][t] == counts[1][t] == dry[t] > 0, (t, counts, dry)
        print(f"phase {phase}: {time.perf_counter() - t0:.1f} s, its two ranks "
              f"{max(s for _, s in procs):.1f} s ({name_power})", flush=True)

    return finish


def tp_children(name_power):
    """Start phase 5h's two ranks (tp_child) beside the caller's work;
    returns finish() (_tp_ranks'): 5h(c) holds their all-reduces on "model"
    equal to rank 0's dry run's."""
    return _tp_ranks("--tp-child", "5h(c)", name_power)


def tp_only():
    """`chip_smoke.py --tp`: build the kernels and run phases 5h and 5i alone,
    their ranks beside each other."""
    name_power = card_line()
    print(f"card: {name_power}", flush=True)
    _build.load()
    finish_5h = tp_children(name_power)
    try:
        tp_mixers_children(name_power)()
    finally:
        finish_5h()
    print("5h and 5i held", flush=True)


# -- phase 5i: tensor parallelism for MLA, Mamba, xLSTM and whisper ---------------

# two gloo ranks of a (1, 2) ("data", "model") mesh on card 0, a spawn of its
# own beside 5h's (`chip_smoke.py --tp-mixers-child DIR`): (e) deepseek-v2-lite
# cut to its dense prefix layer and one MoE layer (32 experts a rank), the
# latent cache over the sequence; (f) jamba-1.5-large cut to its period's
# first layer spec (Mamba and the dense MLP at d 8 192, d_inner 16 384); (g)
# xlstm-125m whole, a prefill at each of 5e's XLSTM_PROMPTS lengths and
# TP5I_XLSTM_NEW decode steps after each, and TP_TRAIN_STEPS AdamW steps at
# TP5I_TRAIN_ROWS x TP5I_TRAIN_SEQ; (h) whisper-base whole, WHISPER_FRAMES
# frames and 4 prompt tokens, served under REPRO_KV_SEQ_SHARD=auto (kv
# heads) and =1 (self and cross caches over the sequence). (j) counts every
# call's collectives on "model" as 5h(c) does.
TP5I_MLA_LAYERS = 2
TP5I_JAMBA_SPECS = 1
TP5I_XLSTM_NEW = 4
TP5I_WHISPER_NEW = 16
TP5I_TRAIN_ROWS, TP5I_TRAIN_SEQ = 4, 64
# (e), (f), (h) hold the logits at TP_LOGIT_RTOL and (e)'s routing at
# TP_ROUTE_RTOL, 5h's bounds with 5h's basis: a row-parallel product's two
# bf16 GEMMs summed in f32 carry one bf16 rounding more a layer than one
# rank's GEMM. (g) runs xlstm-125m in f32: its recurrence amplifies that one
# rounding beyond those bounds (a CPU rehearsal at reduced width in bf16 read
# 5.2e-2 on the logits and 1.3e-2 on the grad norms; in f32 one rounding of
# every parameter moves its gradient leaves by 6.3e-5, tools/
# recurrent_grad_margin.py), so in f32 the ranks differ from one rank by sums
# in another order alone; its logits, losses and grad norms are held at 5h's
# TP_LOGIT_RTOL and TP_LOSS_RTOL, each leaf's update at TP_UPDATE_RTOL.


def _tp5i_cfgs():
    """(e)'s, (f)'s, (g)'s and (h)'s configs."""
    import dataclasses

    jamba = get_config(JAMBA_ARCH)
    return (dataclasses.replace(get_config(MLA_ARCH), num_layers=TP5I_MLA_LAYERS),
            dataclasses.replace(jamba, period=jamba.period[:TP5I_JAMBA_SPECS],
                                num_layers=TP5I_JAMBA_SPECS),
            dataclasses.replace(get_config(XLSTM_ARCH), dtype="float32"), get_config(WHISPER_ARCH))


def _tp5i_dry_counts(dev, parts):
    """The 5i calls of `parts` ("e" ... "h") dry-run over a fake (1, 2)
    group on fake tensors: {call: collectives on "model"}. (g)'s prefill at
    its shortest prompt: the count does not depend on the length, and the
    sLSTM's loop over the tokens runs op by op on fake tensors too."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import ShapeCell
    from repro_torch.launch import dryrun

    mla, jamba, xlstm, whisper = _tp5i_cfgs()
    w_new = len(WHISPER_PROMPT) + TP5I_WHISPER_NEW
    cells = {
        "e_prefill": (mla, ShapeCell("5i", TP_PROMPT, TP_ROWS, "prefill"), "auto"),
        "e_decode": (mla, ShapeCell("5i", TP_PROMPT + _tp_new(mla), TP_ROWS, "decode"), "auto"),
        "f_prefill": (jamba, ShapeCell("5i", TP_PROMPT, TP_ROWS, "prefill"), "auto"),
        "f_decode": (jamba, ShapeCell("5i", TP_PROMPT + _tp_new(jamba), TP_ROWS, "decode"),
                     "auto"),
        "g_prefill": (xlstm, ShapeCell("5i", XLSTM_PROMPTS[-1], TP_ROWS, "prefill"), "auto"),
        "g_decode": (xlstm, ShapeCell("5i", XLSTM_PROMPTS[-1] + TP5I_XLSTM_NEW, TP_ROWS,
                                      "decode"), "auto"),
        "g_train": (xlstm, ShapeCell("5i", TP5I_TRAIN_SEQ, TP5I_TRAIN_ROWS, "train"), "auto"),
        "h_prefill": (whisper, ShapeCell("5i", len(WHISPER_PROMPT), TP_ROWS, "prefill"), "auto"),
        "h_decode": (whisper, ShapeCell("5i", w_new, TP_ROWS, "decode"), "auto"),
        "h_prefill_seq": (whisper, ShapeCell("5i", len(WHISPER_PROMPT), TP_ROWS, "prefill"), "1"),
        "h_decode_seq": (whisper, ShapeCell("5i", w_new, TP_ROWS, "decode"), "1"),
    }
    out = {}
    with dryrun.fake_world(2):
        fmesh = init_device_mesh(dev, (1, 2), mesh_dim_names=("data", "model"))
        for tag, (cfg, cell, kv) in cells.items():
            if tag[0] not in parts:
                continue
            with _kv_mode(kv):
                rec = dryrun.lower_step(cfg, cell, fmesh, dev, enc_seq=WHISPER_FRAMES)
            out[tag] = rec["collective_counts_by_dim"].get("model", 0)
    return out


@contextlib.contextmanager
def _kv_mode(mode):
    """REPRO_KV_SEQ_SHARD set to `mode` inside the block."""
    before = os.environ.get("REPRO_KV_SEQ_SHARD")
    os.environ["REPRO_KV_SEQ_SHARD"] = mode
    try:
        yield
    finally:
        if before is None:
            os.environ.pop("REPRO_KV_SEQ_SHARD")
        else:
            os.environ["REPRO_KV_SEQ_SHARD"] = before


def _tp5i_refs(rank, dev):
    """The one-rank references of the parts a rank holds (rank 0: (e) and
    (h); rank 1: (f) and (g)), with each part's seconds."""
    mla, jamba, xlstm, whisper = _tp5i_cfgs()
    ref, seconds = {}, {}
    t0 = time.perf_counter()
    if rank == 0:
        ref["e"] = _tp_serve_run(mla, None, dev)
        seconds["e"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        for kv in ("auto", "1"):
            with _kv_mode(kv):
                ref["h_" + kv] = _tp_serve_run(whisper, None, dev, prompt=len(WHISPER_PROMPT),
                                               new=TP5I_WHISPER_NEW, frames=WHISPER_FRAMES)
        seconds["h"] = time.perf_counter() - t0
    else:
        ref["f"] = _tp_serve_run(jamba, None, dev)
        seconds["f"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref["g"] = [_tp_serve_run(xlstm, None, dev, prompt=n, new=TP5I_XLSTM_NEW)
                    for n in XLSTM_PROMPTS]
        ref["g_train"] = _tp_train_run(xlstm, None, dev, TP5I_TRAIN_ROWS, TP5I_TRAIN_SEQ)
        seconds["g"] = time.perf_counter() - t0
    ref["seconds_" + str(rank)] = seconds
    return ref


def _tp5i_flash(rank, name_power):
    """The kernel at the heads a rank launches it on in (e) and (h), against
    its plain version: MLA's D 192 at H 8 (v zero-padded from 128), causal;
    whisper's encoder (1500 x 1500, bidirectional), self prefill (4 x 4,
    causal) and cross prefill (4 x 1500, unmasked) at H 4, D 64."""
    mla, _, _, whisper = _tp5i_cfgs()
    g = torch.Generator(device="cuda").manual_seed(rank)
    hw = whisper.num_heads // 2
    cases = (("MLA prefill", mla.num_heads // 2, TP_PROMPT, TP_PROMPT, 192, True),
             ("whisper encoder", hw, WHISPER_FRAMES, WHISPER_FRAMES, whisper.head_dim, False),
             ("whisper self prefill", hw, len(WHISPER_PROMPT), len(WHISPER_PROMPT),
              whisper.head_dim, True),
             ("whisper cross prefill", hw, len(WHISPER_PROMPT), WHISPER_FRAMES, whisper.head_dim,
              False))
    for label, h, sq, sk, d, causal in cases:
        q = torch.randn((TP_ROWS, sq, h, d), generator=g, device="cuda").to(torch.bfloat16)
        k, v = (torch.randn((TP_ROWS, sk, h, d), generator=g, device="cuda").to(torch.bfloat16)
                for _ in range(2))
        if label == "MLA prefill":
            v[..., mla.mla.v_head_dim:] = 0
        err = float((fa.flash_attention_bshd(q, k, v, causal=causal, window=0).float()
                     - plain_bshd(q, k, v, 0, causal).float()).abs().max())
        print(f"5i rank {rank}: flash_bf16<{d}> at {label}'s shapes on a rank's heads: H = KVH "
              f"{h}, B {TP_ROWS}, {sq} x {sk}, {'causal' if causal else 'no mask'}, against its "
              f"plain version: max |err| {err:.3e} (at most {FLASH_ATOL[torch.bfloat16]}) "
              f"({name_power})", flush=True)
        assert err <= FLASH_ATOL[torch.bfloat16], (label, err)


def _tp5i_peaks(tag, got, want):
    return (f"{tag} peak {got['peak'] / 2**30:.3f} GiB a rank, one rank "
            f"{want['peak'] / 2**30:.3f} GiB")


def tp_mixers_child(out_dir):
    """Phase 5i's ranks (`chip_smoke.py --tp-mixers-child DIR`, RANK 0 or 1
    of a gloo world of two over a FileStore in DIR, both on card 0). Before
    the group exists, the one-rank references and (j)'s dry runs over a fake
    group, split over the two (rank 0: (e) and (h), the dry runs of (e), (g)
    and (h); rank 1: (f) and (g), the dry runs of (f)); then
    on a (1, 2) ("data", "model") mesh (e) to (h), each rank held against the
    slices of the references ((e)'s logits against one rank run with the
    mesh's routing); the collective counts go to DIR/rank{r}.json."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    rank, dev = int(os.environ["RANK"]), TP_DEVICE
    if dev == "cuda":
        torch.cuda.set_device(0)
    name_power = card_line()
    t_child = time.perf_counter()
    mla, jamba, xlstm, whisper = _tp5i_cfgs()
    t0 = time.perf_counter()
    with open(os.path.join(out_dir, f"dry{rank}.json"), "w") as f:
        json.dump(_tp5i_dry_counts(dev, "egh" if rank == 0 else "f"), f)
    t_dry = time.perf_counter() - t0
    torch.save(_tp5i_refs(rank, dev), os.path.join(out_dir, f"ref{rank}.pt"))
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter() - t0
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(out_dir, "store"), 2),
                            rank=rank, world_size=2)
    try:
        mesh = init_device_mesh(dev, (1, 2), mesh_dim_names=("data", "model"))
        dist.barrier()
        ref = {}
        for r in (0, 1):
            ref.update(torch.load(os.path.join(out_dir, f"ref{r}.pt")))
        if dev == "cuda":
            _tp5i_flash(rank, name_power)
        counts, seconds = {}, {}

        t0 = time.perf_counter()
        e_run = _tp_serve_run(mla, mesh, dev)
        forced = _tp_serve_run(mla, None, dev, force=e_run["routes"])
        _tp_hold_routing(mla, e_run, forced, rank, mesh, phase="5i(e)")
        n = e_run["logits"].shape[-1]
        own = ref["e"]["logits"][..., rank * n:(rank + 1) * n]
        print(f"5i(e) rank {rank}: logits against one rank with its own routing "
              f"{float((e_run['logits'] - own).abs().max() / own.abs().max()):.3e} (not held: "
              f"a token routed otherwise changes the tokens after it)", flush=True)
        forced.update(prefill_ms=ref["e"]["prefill_ms"], decode_ms=ref["e"]["decode_ms"],
                      peak=ref["e"]["peak"])
        _tp_hold_serve("(e)", mla, e_run, forced, rank, name_power, phase="5i",
                       against="one rank with the mesh's routing (the latent cache over the "
                               "sequence)")
        counts.update(e_prefill=e_run["prefill_reduces"], e_decode=e_run["decode_reduces"])
        peaks = [_tp5i_peaks("(e)", e_run, ref["e"])]
        del e_run, forced
        gc.collect()
        seconds["e"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        f_run = _tp_serve_run(jamba, mesh, dev)
        _tp_hold_serve("(f)", jamba, f_run, ref["f"], rank, name_power, phase="5i", launches=0)
        counts.update(f_prefill=f_run["prefill_reduces"], f_decode=f_run["decode_reduces"])
        peaks.append(_tp5i_peaks("(f)", f_run, ref["f"]))
        del f_run
        gc.collect()
        seconds["f"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        last = len(XLSTM_PROMPTS) - 1  # counted at the shortest prompt, as the dry run
        for i, (n_tok, want) in enumerate(zip(XLSTM_PROMPTS, ref["g"])):
            g_run = _tp_serve_run(xlstm, mesh, dev, prompt=n_tok, new=TP5I_XLSTM_NEW,
                                  count=i == last)
            _tp_hold_serve("(g)", xlstm, g_run, want, rank, name_power, phase="5i", launches=0)
            if i == 0:  # the longest prompt's
                peaks.append(_tp5i_peaks("(g) serving", g_run, want))
            if i == last:
                counts.update(g_prefill=g_run["prefill_reduces"],
                              g_decode=g_run["decode_reduces"])
        b = _tp_train_run(xlstm, mesh, dev, TP5I_TRAIN_ROWS, TP5I_TRAIN_SEQ)
        want = ref["g_train"]
        worst = _tp_hold_updates(xlstm, b, want, mesh, dev)
        loss_err = max(abs(x - y) / abs(y) for x, y in zip(b["losses"], want["losses"]))
        norm_err = max(abs(x - y) / abs(y) for x, y in zip(b["norms"], want["norms"]))
        print(f"5i(g) rank {rank}, {xlstm.name} whole ({xlstm.dtype}), {TP_TRAIN_STEPS} AdamW "
              f"steps (batch {TP5I_TRAIN_ROWS} x {TP5I_TRAIN_SEQ}) on the mesh against one rank: "
              f"losses {' '.join(f'{x:.6f}' for x in b['losses'])} against "
              f"{' '.join(f'{x:.6f}' for x in want['losses'])} (largest relative gap "
              f"{loss_err:.3e}), grad norms largest relative gap {norm_err:.3e} (at most "
              f"{TP_LOSS_RTOL}); init(0) blocks equal to the one-rank draws' slices; every "
              f"leaf's update, ||diff|| / ||one rank's||: worst {worst[0]:.3e} ({worst[1]}; at "
              f"most {TP_UPDATE_RTOL}); replicated leaves bit-equal across the ranks; host ms a "
              f"step, gloo-staged (no speed claim) {' '.join(f'{x:.1f}' for x in b['ms'])} (one "
              f"rank {' '.join(f'{x:.1f}' for x in want['ms'])}) ({name_power})", flush=True)
        assert loss_err <= TP_LOSS_RTOL and norm_err <= TP_LOSS_RTOL, (loss_err, norm_err)
        assert worst[0] <= TP_UPDATE_RTOL, worst
        counts["g_train"] = b["train_reduces"]
        peaks.append(f"(g) training peak {b['peak'] / 2**30:.3f} GiB a rank, one rank "
                     f"{want['peak'] / 2**30:.3f} GiB")
        del b
        gc.collect()
        seconds["g"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        layers = whisper.encoder_layers + 2 * whisper.num_layers  # encoder, self, cross
        for kv, tag in (("auto", ""), ("1", "_seq")):
            with _kv_mode(kv):
                h_run = _tp_serve_run(whisper, mesh, dev, prompt=len(WHISPER_PROMPT),
                                      new=TP5I_WHISPER_NEW, frames=WHISPER_FRAMES)
            _tp_hold_serve(f"(h) REPRO_KV_SEQ_SHARD={kv}", whisper, h_run, ref["h_" + kv], rank,
                           name_power, phase="5i", launches=layers,
                           heads=(whisper.num_heads // 2, whisper.num_kv_heads // 2))
            counts.update({"h_prefill" + tag: h_run["prefill_reduces"],
                           "h_decode" + tag: h_run["decode_reduces"]})
            peaks.append(_tp5i_peaks(f"(h) {kv}", h_run, ref["h_" + kv]))
            del h_run
        seconds["h"] = time.perf_counter() - t0

        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(counts, f)
        print(f"5i rank {rank}: " + "; ".join(peaks) + f" ({name_power})", flush=True)
        ref_s = ref["seconds_" + str(rank)]
        print(f"5i rank {rank}: references {t_ref:.1f} s ("
              + ", ".join(f"{k} {v:.1f}" for k, v in ref_s.items())
              + f", the dry runs {t_dry:.1f}"
              + "), the mesh's parts " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items())
              + f" s, the child {time.perf_counter() - t_child:.1f} s ({name_power})",
              flush=True)
    finally:
        dist.destroy_process_group()


def tp_mixers_children(name_power):
    """Start phase 5i's two ranks (tp_mixers_child) beside the caller's
    work; returns finish() (_tp_ranks'): (j) holds their collectives on
    "model" equal to each other and to the dry runs' the two ranks made."""
    return _tp_ranks("--tp-mixers-child", "5i(j)", name_power)


# -- phase 5c: MoE, qwen2-moe-a2.7b at full width ----------------------------------

MOE_ARCH = "qwen2-moe-a2.7b"
MOE_TOKENS = 4097  # (a): 8 router chunks of 512 and a remainder of 1
# (a) the card's routing against the host CPU's: the router runs in f32 on
# both sides (TF32 off), its logits a dot over d_model = 2048 summed in
# another order (~1e-7 of a probability apart), so a (token, k) choice may
# flip only where two probabilities lie closer than that; a flip moves later
# tokens' slots in the two experts it touches, and those tokens are left out
# of the y comparison. At most MOE_MAX_FLIPS flips, each with an f32
# probability gap under MOE_FLIP_GAP (~100x the rounding).
MOE_MAX_FLIPS = 4
MOE_FLIP_GAP = 1e-5
# (a) y on the tokens whose routing agrees, relative to max |y|: the card's
# and the host's bf16 products round each of the four expert products (and
# the shared expert's) to bf16 from f32 sums in other orders, so an element
# may land a bf16 ulp or two away, at most 2^-7 of its value each (one ulp
# at max |y|, 5.95e-3, read on the CPU against the reference at the reduced
# width); aux from f32 probabilities
MOE_Y_RTOL = 2.0**-6
MOE_AUX_RTOL = 1e-5
# (b) flash at qwen2-moe's heads (H = KVH = 16, D = 128), its longest prompt
MOE_FLASH_CASE = (4608, 4608, torch.bfloat16, 0)
# (e) 2 layers at full width, AdamW, batch 2 x 512
MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS, MOE_TRAIN_BATCH = 2, 5, 2
# (c), (d) qwen2-moe served at full width cut in depth to its first
# MOE_SERVE_LAYERS of 24 layers (cut to pay for phase 5e's seconds)
MOE_SERVE_LAYERS = 2


def moe_routing_check(name_power):
    """5c(a): one MoE layer at full width (make_moe from seed 0, bf16), on a
    4097-token sequence of normalised hidden states and on a 4-row decode
    batch: the card's apply_moe and routing against the host CPU's, on the
    same tensors."""
    from repro_torch.models import layers, moe

    cfg = get_config(MOE_ARCH)
    dev = torch.device("cuda")
    p = moe.make_moe(torch.Generator(device=dev).manual_seed(0), cfg, torch.bfloat16)
    p_host = transformer.tree_map(lambda t: t.cpu(), p)
    g = torch.Generator(device=dev).manual_seed(1)
    norm = {"scale": torch.ones(cfg.d_model, dtype=torch.bfloat16, device=dev)}
    for label, shape in (("prefill", (1, MOE_TOKENS)), ("decode", (LM_SLOTS, 1))):
        x = layers.apply_norm(norm, torch.randn(shape + (cfg.d_model,), generator=g,
                                                device=dev).to(torch.bfloat16))
        x_host = x.cpu()
        t0 = time.perf_counter()
        y, aux = moe.apply_moe(p, cfg, x)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        y_host, aux_host = moe.apply_moe(p_host, cfg, x_host)
        host_s = time.perf_counter() - t0
        flat, flat_host = x.reshape(-1, cfg.d_model), x_host.reshape(-1, cfg.d_model)
        n = flat.shape[0]
        chunk = min(cfg.moe.router_chunk, n)
        bounds = [(lo, min(lo + chunk, n)) for lo in range(0, n, chunk)]
        flips, agree, drops = [], torch.ones(n, dtype=torch.bool), []
        for lo, hi in bounds:
            r, rh = moe.route(p, cfg.moe, flat[lo:hi]), moe.route(p_host, cfg.moe, flat_host[lo:hi])
            top_e, keep = r.top_e.cpu(), r.keep.cpu()
            moved = set()
            for t, k in (top_e != rh.top_e).nonzero().tolist():
                a, b = int(top_e[t, k]), int(rh.top_e[t, k])
                flips.append(dict(token=lo + t, k=k, card=a, host=b,
                                  gap=abs(float(rh.probs[t, a] - rh.probs[t, b]))))
                moved |= {a, b}
            same = (top_e == rh.top_e).all(-1) & (keep == rh.keep).all(-1)
            # a token whose routing differs must have an expert a flip touched
            for t in (~same).nonzero().flatten().tolist():
                assert moved & set(rh.top_e[t].tolist()), (
                    f"{label} chunk {lo}:{hi} token {t}: routing differs with no flip: card "
                    f"{top_e[t].tolist()} {keep[t].tolist()}, host {rh.top_e[t].tolist()} "
                    f"{rh.keep[t].tolist()}")
            agree[lo:hi] = same
            drops.append(round(float((~rh.keep).float().mean()), 4))
            assert r.cap == rh.cap
        y_err = ((y.cpu().float() - y_host.float()).reshape(n, -1)[agree].abs().max()
                 / y_host.float().abs().max()).item()
        aux_err = abs(float(aux) - float(aux_host)) / abs(float(aux_host))
        print(f"5c(a) {label}: {n} tokens, {len(bounds)} router chunks (cap "
              f"{[max(1, math.ceil((hi - lo) * cfg.moe.top_k / cfg.moe.num_experts * cfg.moe.capacity_factor)) for lo, hi in bounds]}); "
              f"card vs host CPU: top-k flips {len(flips)} (at most {MOE_MAX_FLIPS}, each gap "
              f"under {MOE_FLIP_GAP}) {json.dumps(flips)}; tokens whose routing agrees "
              f"{int(agree.sum())} of {n}; y on them max|err| / max|y| {y_err:.3e} (at most "
              f"{MOE_Y_RTOL:.3e}); aux {float(aux):.6f} vs {float(aux_host):.6f}, relative "
              f"{aux_err:.3e} (at most {MOE_AUX_RTOL}); share of (token, k) pairs dropped by "
              f"capacity per chunk {drops}; apply_moe card {card_s:.3f} s (first call), host CPU "
              f"{host_s:.3f} s ({name_power})", flush=True)
        assert len(flips) <= MOE_MAX_FLIPS and all(f["gap"] < MOE_FLIP_GAP for f in flips), flips
        assert y_err <= MOE_Y_RTOL, y_err
        assert aux_err <= MOE_AUX_RTOL, aux_err
        assert torch.isfinite(y).all()
    del p, p_host


class _EinsumSpans:
    """torch for models/moe.py, with each einsum inside a profiler span
    named by its equation (phase 5c(d)'s split only)."""

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def einsum(eq, *ops):
        with torch.profiler.record_function(f"moe einsum {eq}"):
            return torch.einsum(eq, *ops)


class _SharedSpan:
    """models.layers for models/moe.py, apply_mlp (the shared expert) in a span."""

    def __getattr__(self, name):
        from repro_torch.models import layers

        return getattr(layers, name)

    @staticmethod
    def apply_mlp(*a, **kw):
        from repro_torch.models import layers

        with torch.profiler.record_function("moe shared expert"):
            return layers.apply_mlp(*a, **kw)


@contextlib.contextmanager
def moe_spans():
    """Profiler spans around the MoE layer's parts, put in by this script for
    a traced call: the router (moe.route: f32 product, softmax, sort,
    cumsum), each einsum, the shared expert, the whole apply_moe."""
    from repro_torch.models import moe

    saved = (moe.torch, moe.layers, moe.route, moe.apply_moe)
    route, apply_moe = moe.route, moe.apply_moe

    def spanned(label, fn):
        def call(*a, **kw):
            with torch.profiler.record_function(label):
                return fn(*a, **kw)
        return call

    moe.torch, moe.layers = _EinsumSpans(), _SharedSpan()
    moe.route = spanned("moe router", route)
    moe.apply_moe = spanned("moe layer", apply_moe)
    try:
        yield
    finally:
        moe.torch, moe.layers, moe.route, moe.apply_moe = saved


MOE_SPLIT = {  # span label prefix -> the split's part
    "moe einsum ecd,edf->ecf": "expert einsums",
    "moe einsum ecf,efd->ecd": "expert einsums",
    "moe einsum tec,td->ecd": "one-hot dispatch / combine einsums",
    "moe einsum tec,ecd->td": "one-hot dispatch / combine einsums",
    "moe einsum tk,tke->te": "one-hot dispatch / combine einsums",
    "moe router": "router + top-k + cumsum",
    "moe shared expert": "shared expert",
    "moe layer": "MoE layer, all",
}


def span_split(tag, label, fn, spans, split_map, name_power, parts, rest):
    """fn traced once under the `spans` context: the device time under each
    span of split_map (label -> the split's part), the flash kernel's, and the
    device's busy time; `parts` are the disjoint parts that, with flash, leave
    the rest of the busy time to `rest`. Each part but a whole layer's names
    its top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with spans():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
    self_us = lambda e: getattr(e, "self_device_time_total", None) or getattr(  # noqa: E731
        e, "self_cuda_time_total", 0.0)
    # the spans show up twice: on the host (their ops' kernels, summed
    # through the children) and as device-side annotations, which span the
    # idle gaps too; the split reads the first, the busy sum skips the second
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA and self_us(e) > 0
               and e.key not in split_map]
    busy = sum(self_us(e) for e in kernels) / 1e3

    def kernels_under(e):  # (name, us) of every kernel an op or its children launched
        own = [(k.name, k.duration) for k in e.kernels
               if k.name not in split_map and "flash" not in k.name]
        return own + [kd for c in e.cpu_children for kd in kernels_under(c)]

    split, tops = {}, {}
    for e in prof.events():
        part = split_map.get(e.name)
        if part and e.device_type == DeviceType.CPU:
            for kname, us in kernels_under(e):
                split[part] = split.get(part, 0.0) + us / 1e3
                if not part.endswith(", all"):
                    key = (part, kname[:50])
                    tops[key] = tops.get(key, 0.0) + us / 1e3
    split["flash kernel"] = sum(self_us(e) for e in kernels if "flash" in e.key) / 1e3
    split[rest] = busy - sum(split.get(p, 0.0) for p in parts) - split["flash kernel"]
    print(f"{tag} {label}, traced: wall {wall_ms:.3f} ms, device busy {busy:.3f} ms "
          f"({100 * busy / wall_ms:.1f} %), {sum(e.count for e in kernels)} device ops; device ms "
          f"by part: {json.dumps({k: round(v, 3) for k, v in split.items()})} ({name_power})",
          flush=True)
    for part in sorted({p for p, _ in tops}):
        top = sorted(((ms, k) for (p, k), ms in tops.items() if p == part), reverse=True)[:3]
        print(f"{tag} {label}, {part}: top kernels "
              + "; ".join(f"{k} {ms:.3f} ms" for ms, k in top), flush=True)
    return split


def moe_split(label, fn, name_power):
    """fn traced once under moe_spans: the device time under each span of
    MOE_SPLIT, the flash kernel's, and the device's busy time."""
    return span_split("5c(d)", label, fn, moe_spans, MOE_SPLIT, name_power,
                      parts=("MoE layer, all",),
                      rest="other (attention projections, norms, RoPE, head, casts)")


@contextlib.contextmanager
def route_spy(record):
    """Call record(routing) on every routed chunk (moe.route wrapped by this
    script)."""
    from repro_torch.models import moe

    route = moe.route

    def spy(*a, **kw):
        r = route(*a, **kw)
        record(r)
        return r

    moe.route = spy
    try:
        yield
    finally:
        moe.route = route


def kept(out):
    """A route_spy record: (the experts that kept at least one token, the
    (token, k) pairs kept) of each chunk, appended to `out`."""
    return lambda r: out.append((int(r.top_e[r.keep].unique().numel()), int(r.keep.sum())))


def moe_prefill_bounds(cfg, prompt, kept):
    """A prefill's operations bound two ways (ms): the reference's dispatch as
    the port runs it (every expert's capacity slots, filled or not, and the
    one-hot dispatch and combine products), and what the tokens need (the
    expert SwiGLU of each kept (token, k) pair, `kept` summed over the
    layers' chunks, and no dispatch products); bf16 products at the tensor
    peak, the f32 router and head at the FP32 peak. Also the first's TFLOP."""
    fp32, tensor, _ = peaks(torch.cuda.get_device_name(0))
    m, d, h, kvh, hd = cfg.moe, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    e, f, fs = m.num_experts, m.d_ff_expert, m.d_ff_expert * m.num_shared
    algo = 0.0
    f32 = 2 * d * cfg.padded_vocab / cfg.num_layers  # the last position's head
    for lo in range(0, prompt, m.router_chunk):
        t = min(m.router_chunk, prompt - lo)
        c = max(1, math.ceil(t * m.top_k / e * m.capacity_factor))
        algo += 3 * 2 * e * c * d * f + 2 * 2 * t * e * c * d
        f32 += 2 * t * d * e
    need = 3 * 2 * kept * d * f / cfg.num_layers
    common = (3 * 2 * prompt * d * fs + 2 * prompt * d * (h + 2 * kvh) * hd
              + 2 * prompt * h * hd * d + 4 * h * hd * fa.band_pairs(prompt, prompt, True, 0))
    ms = lambda bf16: 1e3 * cfg.num_layers * (bf16 / tensor + f32 / fp32)  # noqa: E731
    return ms(algo + common), ms(need + common), cfg.num_layers * (algo + common + f32) / 1e12


def moe_decode_bounds(cfg, rows, pos, used):
    """A decode step's bytes bound two ways (ms, GB): every weight once as the
    reference's dispatch reads it (all experts; the embedding's `rows` rows
    only; the f32 router), and only the experts the step kept (`used`, per
    MoE layer), with the cache rows each sequence needs (pos + 1: k and v, or
    an MLA layer's c_kv and k_rope) on both."""
    _, _, bw = peaks(torch.cuda.get_device_name(0))
    m, d = cfg.moe, cfg.d_model
    n_moe = sum(spec.mlp == "moe" for spec in cfg.layer_kinds())
    expert = 3 * d * m.d_ff_expert * 2
    weights = (counting.count_params(cfg) - cfg.padded_vocab * d) * 2 + rows * d * 2
    weights += n_moe * d * m.num_experts * 2  # the router is f32
    if cfg.mla is not None:
        row = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
    else:
        row = 2 * cfg.num_kv_heads * cfg.head_dim
    cache = cfg.num_layers * int(sum(pos + 1)) * row * 2
    algo = weights + cache
    need = algo - expert * (n_moe * m.num_experts - sum(u for u, _ in used))
    return 1e3 * algo / bw, 1e3 * need / bw, algo / 1e9, need / 1e9


def no_drop_witness(model, params, cfg, reqs, results, tag="5c(c)"):
    """5c(c)'s witness at a dropless capacity: each request alone,
    teacher-forced on the engine's tokens. In the engine's 4-row geometry
    every step's gap must be 0 (as phase 5's). At batch 1 the request's
    hidden states round otherwise (other GEMM shapes), and a top-k choice
    whose probabilities lie within that rounding flips, changing the layer's
    output for that token and every later step's cache: so each step is held
    within LOGIT_MARGIN up to the first decode step whose routing differs
    from the 4-row run's (row 0, any layer), with the flip's f32 probability
    gap in the 4-row run, and the batch-1 replay ends there (the steps after
    a flip are not held, so they are not run)."""
    layers_ = sum(spec.mlp == "moe" for spec in cfg.layer_kinds())  # routed chunks a step
    gaps4, held, flips, reordered = [], [], [], 0
    for r in reqs:
        toks = results[r.rid]
        r4, r1, flip = [], [], []
        with route_spy(lambda q: r4.append((q.top_e[0].clone(), q.probs[0].clone()))):
            g4 = teacher_forced_margins(model, params, cfg, r, toks, LM_SLOTS)
        e4 = torch.stack([e for e, _ in r4])
        n_prefill = len(r4) - layers_ * (len(toks) - 1)

        def record(q):
            i = len(r1)
            r1.append(q.top_e[0].clone())
            if not flip and i >= n_prefill and set(r1[i].tolist()) != set(e4[i].tolist()):
                flip.append(i)

        with route_spy(record):
            g1 = teacher_forced_margins(model, params, cfg, r, toks, 1, stop=lambda: bool(flip))
        e1 = torch.stack(r1)
        assert torch.equal(e4[:n_prefill], e1[:n_prefill]), f"request {r.rid}: prefills differ"
        # a flip changes the chosen set; an order change alone moves no expert
        # (no drops) and only the order of the combine's sum
        n = len(e1)
        same_set = (e4[:n].sort(-1).values == e1.sort(-1).values).all(-1)
        reordered += int(((e4[:n] != e1).any(-1) & same_set).sum())
        cut = len(toks)
        if flip:
            i = flip[0]
            cut = (i - n_prefill) // layers_ + 1  # gaps[cut] is the first step after the flip
            a = sorted(set(e4[i].tolist()) - set(e1[i].tolist()))
            b = sorted(set(e1[i].tolist()) - set(e4[i].tolist()))
            p = r4[i][1]
            flips.append(dict(rid=r.rid, step=cut - 1, layer=(i - n_prefill) % layers_,
                              card4=a, card1=b,
                              prob_gap=float((p[a].max() - p[b].min()).abs())))
        assert len(g1) == cut, (r.rid, len(g1), cut)
        gaps4 += g4
        held += g1
    worst4, worst_held = max(gaps4), max(held)
    print(f"{tag} no drops, vs each request alone (teacher-forced): 4-row decode worst logit "
          f"margin {worst4:.4e} (must be 0), steps off the argmax {sum(g > 0 for g in gaps4)} of "
          f"{len(gaps4)}; 1-row decode worst margin before a routing flip {worst_held:.4e} (at "
          f"most {LOGIT_MARGIN}) over {len(held)} steps, {sum(g > 0 for g in held)} off the "
          f"argmax; {len(flips)} of {len(reqs)} requests flip a top-k choice against the 4-row "
          f"run (the first flip each; the 1-row replay ends there) {json.dumps(flips)}, "
          f"{reordered} layer steps up to it reorder the same k experts", flush=True)
    assert worst4 == 0.0, f"no-drop engine vs the 4-row rerun: margin {worst4}"
    assert worst_held <= LOGIT_MARGIN, f"no-drop engine vs batch 1 before a flip: {worst_held}"


def moe_engine_run(cfg, params, reqs):
    eng = Engine(cfg, params, num_slots=LM_SLOTS, capacity=CAPACITY, device="cuda")
    torch.cuda.synchronize()
    sto_step.reset_launches()
    t0 = time.perf_counter()
    results = eng.run(list(reqs))
    torch.cuda.synchronize()
    return eng, results, time.perf_counter() - t0, dict(sto_step.LAUNCHES)


def moe_serve(name_power):
    """5c(c) and (d): qwen2-moe-a2.7b served at full width; returns the
    flash launches of the engine run and the tree's peak memory."""
    import dataclasses

    from repro_torch import tree

    cfg = dataclasses.replace(get_config(MOE_ARCH), num_layers=MOE_SERVE_LAYERS)
    model = build_model(cfg, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s, init_peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated()
    n_params = sum(t.numel() for t in tree.leaves(params))
    print(f"5c(c) {MOE_ARCH} at {cfg.num_layers} of {get_config(MOE_ARCH).num_layers} layers: "
          f"{n_params} parameters (count_params {counting.count_params(cfg)}, "
          f"active {counting.count_params(cfg, active_only=True)}), init on the card "
          f"{init_s:.3f} s, peak {init_peak / 2**30:.3f} GiB ({name_power})", flush=True)
    rng = np.random.default_rng(0)
    reqs = [Request(i, torch.from_numpy(rng.integers(0, cfg.vocab_size, n)), MAX_NEW)
            for i, n in enumerate(PROMPTS)]
    Engine(cfg, params, num_slots=2, capacity=64, device="cuda").run(
        [Request(0, reqs[-1].prompt[:32], 2), Request(1, reqs[-1].prompt[:16], 2)])
    torch.cuda.reset_peak_memory_stats()
    eng, results, seconds, launches = moe_engine_run(cfg, params, reqs)
    peak = torch.cuda.max_memory_allocated()
    assert sorted(results) == [r.rid for r in reqs], f"served {sorted(results)}"
    for r in reqs:
        toks = results[r.rid]
        assert len(toks) == MAX_NEW and all(0 <= t < cfg.vocab_size for t in toks), (r.rid, toks)
    want = cfg.num_layers * len(PROMPTS)
    assert launches["flash_attention"] == want, f"flash launches {launches} != {want}"
    assert not any(launches[k] for k in STO_KERNELS), f"STO kernels launched: {launches}"
    st = eng.stats
    print(f"5c(c) serve {MOE_ARCH}: {len(reqs)} requests, {sum(map(len, results.values()))} "
          f"tokens in {seconds:.3f} s; prefill {st.prefill_tokens} tokens in "
          f"{st.prefill_seconds:.3f} s = {st.prefill_tokens / st.prefill_seconds:.1f} tok/s; "
          f"decode {st.decode_steps} steps, {st.decode_tokens} tokens in {st.decode_seconds:.3f} s "
          f"= {st.decode_tokens / st.decode_seconds:.1f} tok/s; peak memory {peak / 2**30:.3f} GiB; "
          f"launches {launches} ({name_power})", flush=True)
    del eng
    eng, again, _, _ = moe_engine_run(cfg, params, reqs)
    same = all(again[r.rid] == results[r.rid] for r in reqs)
    print(f"5c(c) a second engine run on the same requests bit-equal, token for token: {same}",
          flush=True)
    assert same, "the second engine run differs"

    # (d) where the time goes: one 4608-token prefill and one batch-4 decode step
    prompt = max(PROMPTS)
    batch = {"tokens": reqs[0].prompt[None].cuda()}
    prefill_ms = time_ms(lambda: model.prefill(params, batch), 3)
    used = []
    with route_spy(kept(used)):
        model.prefill(params, batch)
    bound, bound_need, tflop = moe_prefill_bounds(cfg, prompt, sum(k for _, k in used))
    print(f"5c(d) prefill {prompt} tokens: {prefill_ms:.3f} ms (CUDA events, median of 3); "
          f"operations bound {bound:.3f} ms as the reference's dispatch computes it ({tflop:.2f} "
          f"TFLOP; {100 * bound / prefill_ms:.1f} %), {bound_need:.3f} ms for what the tokens "
          f"need (kept pairs' experts only, no one-hot products) ({name_power})", flush=True)
    moe_split(f"prefill {prompt} tokens", lambda: model.prefill(params, batch), name_power)
    # a full batch on the second run's cache, each row its slot's last token
    tokens, caches = eng.next_tokens.clone(), eng.caches
    pos = torch.tensor([n - 1 for n in PROMPTS[:LM_SLOTS]], device="cuda")
    decode_ms = time_ms(lambda: model.decode_step(params, tokens, caches, pos), 5)
    used = []
    with route_spy(kept(used)):
        model.decode_step(params, tokens, caches, pos)
    bound, bound_need, gb, gb_need = moe_decode_bounds(cfg, LM_SLOTS, pos.cpu(), used)
    print(f"5c(d) decode step, batch {LM_SLOTS}, capacity {CAPACITY}: {decode_ms:.3f} ms (CUDA "
          f"events, median of 5); bytes bound {bound:.3f} ms ({gb:.2f} GB: every weight once, "
          f"all {cfg.moe.num_experts} experts a layer as the reference's dispatch reads them, the "
          f"cache rows up to each position; {100 * bound / decode_ms:.1f} %), {bound_need:.3f} ms "
          f"({gb_need:.2f} GB) for the experts the step kept ({min(used)[0]}-{max(used)[0]} a "
          f"layer, {sum(u for u, _ in used)} in all) ({name_power})", flush=True)
    moe_split(f"decode step batch {LM_SLOTS}",
              lambda: model.decode_step(params, tokens, caches, pos), name_power)
    del caches, eng

    # the no-drop witness: capacity num_experts / top_k keeps every token
    m = cfg.moe
    cfg_nd = dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.num_experts / m.top_k))
    model_nd = build_model(cfg_nd, device="cuda")
    eng, results_nd, seconds, launches = moe_engine_run(cfg_nd, params, reqs)
    del eng
    assert launches["flash_attention"] == want, launches
    changed = sum(results_nd[r.rid] != results[r.rid] for r in reqs)
    print(f"5c(c) capacity factor {cfg_nd.moe.capacity_factor} (no drops): {len(reqs)} requests "
          f"in {seconds:.3f} s; {changed} of {len(reqs)} requests' tokens differ from the "
          f"capacity-{m.capacity_factor} run", flush=True)
    no_drop_witness(model_nd, params, cfg_nd, reqs, results_nd)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches=want, peak=peak, init_peak=init_peak, prefill_ms=prefill_ms,
                decode_ms=decode_ms)


def moe_train(name_power):
    """5c(e): a reduced qwen2-moe (f32, capacity 1.25) on the card against the
    host CPU over two steps; then 2 layers at full width, 5 AdamW steps."""
    import dataclasses

    from repro_torch import tree
    from repro_torch.configs import reduce_config
    from repro_torch.data import DataConfig, SyntheticTokens, to_device
    from repro_torch.launch import steps
    from repro_torch.optim import global_norm

    base = reduce_config(get_config(MOE_ARCH))
    cfg = dataclasses.replace(base, moe=dataclasses.replace(base.moe, capacity_factor=1.25))
    data = SyntheticTokens(DataConfig(cfg.vocab_size, 64, 4, seed=0))
    kw = dict(lr=TRAIN_LR, warmup=TRAIN_WARMUP, total_steps=100)
    step_cpu, opt, model = steps.make_train_step(cfg, device="cpu", **kw)
    model_gpu = steps.make_train_step(cfg, device="cuda", **kw)[2]
    params = model.init(0)
    state = opt.init(params, device="cpu")
    errs = {}
    for s in range(2):
        b_cpu, b_gpu = to_device(data.batch(s), "cpu"), to_device(data.batch(s), "cuda")
        p_gpu = tree.tree_map(lambda t: t.cuda(), params)
        with torch.no_grad():
            met_gpu, met_cpu = model_gpu.loss_fn(p_gpu, b_gpu)[1], model.loss_fn(params, b_cpu)[1]
        loss_gpu, g_gpu = steps.loss_and_grads(model_gpu, p_gpu, b_gpu)
        loss_cpu, g_cpu = steps.loss_and_grads(model, params, b_cpu)
        e = {"loss": _rel(loss_gpu, loss_cpu), "ce": _rel(met_gpu["ce"], met_cpu["ce"]),
             "aux": _rel(met_gpu["aux"], met_cpu["aux"]),
             "grad_norm": _rel(global_norm(g_gpu), global_norm(g_cpu))}
        e["grads"], leaf = _worst(g_gpu, g_cpu)
        e["router_grad"] = _rel(g_gpu["stack"][0]["mlp"]["router"]["kernel"],
                                g_cpu["stack"][0]["mlp"]["router"]["kernel"])
        errs[s] = (e, leaf, float(met_cpu["aux"]))
        params, state, _ = step_cpu(params, state, b_cpu, torch.tensor(s))
    print(f"5c(e) reduced {cfg.name} (f32, capacity factor 1.25, router chunk "
          f"{cfg.moe.router_chunk}), the card vs the host CPU from the same weights, two steps "
          f"(relative, at most {TRAIN_RTOL}): "
          + "; ".join(f"step {s}: " + ", ".join(f"{k} {v:.3e}" for k, v in e.items())
                      + f" (worst gradient leaf {leaf}), aux {aux:.6f}"
                      for s, (e, leaf, aux) in errs.items()) + f" ({name_power})", flush=True)
    assert all(max(e.values()) <= TRAIN_RTOL for e, _, _ in errs.values()), errs

    # 2 layers at full width: 5 AdamW steps, each step's aux read off forward_logits
    cfg = dataclasses.replace(get_config(MOE_ARCH), num_layers=MOE_TRAIN_LAYERS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    train_step, opt, model = steps.make_train_step(cfg, device="cuda", **kw)
    params = model.init(0)
    state = opt.init(params, device="cuda")
    data = SyntheticTokens(DataConfig(cfg.vocab_size, TRAIN_SEQ, MOE_TRAIN_BATCH, seed=0))
    auxes, forward = [], transformer.forward_logits

    def spy(*a, **k):
        out = forward(*a, **k)
        auxes.append(out[1].detach())
        return out

    hist, step_ms = [], []
    transformer.forward_logits = spy
    try:
        for s in range(MOE_TRAIN_STEPS):
            batch = to_device(data.batch(s), "cuda")
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            params, state, met = train_step(params, state, batch, torch.tensor(s, device="cuda"))
            stop.record()
            stop.synchronize()
            step_ms.append(start.elapsed_time(stop))
            hist.append((float(met["loss"]), float(met["grad_norm"])))
    finally:
        transformer.forward_logits = forward
    peak = torch.cuda.max_memory_allocated()
    _, grads = steps.loss_and_grads(model, params, to_device(data.batch(MOE_TRAIN_STEPS), "cuda"))
    router = grads["stack"][0]["mlp"]["router"]["kernel"].float()
    aux = [float(a) for a in auxes]
    print(f"5c(e) {MOE_TRAIN_LAYERS} layers at full width (bf16, remat {cfg.remat}, AdamW), "
          f"batch {MOE_TRAIN_BATCH} x {TRAIN_SEQ}: losses {' '.join(f'{x:.4f}' for x, _ in hist)}; "
          f"grad norms {' '.join(f'{g:.3f}' for _, g in hist)}; aux {' '.join(f'{a:.4f}' for a in aux)}; "
          f"router gradient max |g| {router.abs().max().item():.3e}; ms a step (CUDA events) "
          f"{' '.join(f'{x:.1f}' for x in step_ms)}; peak memory {peak / 2**30:.3f} GiB "
          f"({name_power})", flush=True)
    assert len(aux) == MOE_TRAIN_STEPS, len(aux)
    assert all(math.isfinite(x) and math.isfinite(g) for x, g in hist), hist
    assert all(math.isfinite(a) and a > 0 for a in aux), aux
    assert torch.isfinite(router).all() and router.abs().max() > 0, "router gradient"
    del params, state, grads
    gc.collect()
    torch.cuda.empty_cache()


def moe_phase(name, name_power):
    """Phase 5c: MoE. Returns the flash kernel's qwen2-moe row (D = 128) with
    the engine run's launches."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    moe_routing_check(name_power)
    flash = flash_case(name, MOE_ARCH, *MOE_FLASH_CASE)
    served = moe_serve(name_power)
    moe_train(name_power)
    seconds = time.perf_counter() - t0
    print(f"phase 5c: {seconds:.1f} s ({name_power})", flush=True)
    keys = ("ms", "single_call_ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library",
            "share_of_bound", "max_abs_err", "row_rel_err")
    return dict({k: flash[k] for k in keys}, launches=served["launches"])


def moe_only():
    """`chip_smoke.py --moe`: build the kernels and run phase 5c alone."""
    name_power = card_line()
    print(f"card: {name_power}", flush=True)
    _build.load()
    moe_phase(torch.cuda.get_device_name(0), name_power)
    print("5c held", flush=True)


# -- phase 5d: MLA (deepseek-v2-lite-16b at full width) -------------------------------

MLA_ARCH = "deepseek-v2-lite-16b"
MLA_TOKENS = 1024  # (a): the host CPU's einsum over 16 x 1024^2 logits stays within seconds
MLA_DECODE_POS = (17, 1023, 2500, 4600)  # (a): a 4-row decode over a CAPACITY-row cache
# (a) the card against the host CPU on the same tensors, by phase 4's two
# measures: the largest absolute error (held at the rtol times the host's
# largest magnitude) and the row measure. c_kv and k_rope are one bf16 GEMM's
# output normed or roped in f32 and cast back, so an element may land a bf16
# ulp or two away (2^-8 of it each); the host CPU's bf16 against its own f32
# reads 6.0e-3 / 7.0e-3 of a row at this width.
MLA_CACHE_RTOL = 2.0**-6
# y: four bf16 roundings in the chain (q, c_kv, the decompressed k and v, the
# attention output) and, on the card, the flash kernel's bf16 probabilities
# (phase 4's 1e-2 a row); the host CPU's bf16 against f32 reads 7.3e-3
# (prefill) and 3.4e-3 (the absorbed decode).
MLA_Y_RTOL = 2.0**-5
# (b) flash at deepseek's heads (H = KVH = 16) and MLA's concat head dim dn +
# dr = 192, v zero-padded from dv = 128, its longest prompt
MLA_FLASH_CASE = (4608, 4608, torch.bfloat16, 0)
# (c), (d) deepseek-v2-lite served at full width cut in depth to its dense
# prefix layer and the first MLA_SERVE_LAYERS - 1 of its 26 MoE periods (cut
# to pay for phase 5e's seconds: every layer kind it has)
MLA_SERVE_LAYERS = 2


# The row measure of a recurrent state over its terms' magnitudes (_held's
# `terms`). Each term is weighted by the exponential of a sum of logits that
# bf16 products round (Mamba: exp(A * the sum of dt since the token, dt from
# dt_proj); mLSTM: exp(i + the sum of log sigmoid(f)), the gates from w_if),
# so a term moves by its exponent's absolute error, a bf16 rounding of each
# logit accumulated over the tokens: 1e-2 to 3e-2 of the term where the
# exponent reaches a few units. Read (chip_smoke.py --recurrent, NVIDIA H100
# 80GB HBM3, 700.00 W): Mamba's h 1.3e-2 (prefill), 2.0e-2 (decode), 9.4e-3
# (chunk 64 against one chunk); the mLSTM prefill's c 3.0e-2, n 3.7e-3. The
# limit is twice the largest.
STATE_TERMS_RTOL = 2.0**-4


def _held(label, got, want, rtol, tag="5d(a)", terms=None):
    """got (card) against want (host CPU) by phase 4's two measures; raises.
    `terms`, where given, are the magnitudes of the terms that want sums: a
    recurrent state sums terms of both signs over the tokens, which can
    cancel within a row to a small fraction of them while the row carries
    their rounding. The row measure is then each row's max|got - want| over
    the row's largest term magnitude, not over its largest element, held at
    STATE_TERMS_RTOL."""
    g, w = got.detach().float().cpu(), want.detach().float().cpu()
    err, scale = (g - w).abs().max().item(), w.abs().max().item()
    if terms is None:
        rel, row_rtol = row_rel_err(g, w), rtol
    else:
        den = terms.detach().float().cpu().amax(-1).clamp_min(1e-30)
        rel, row_rtol = ((g - w).abs().amax(-1) / den).max().item(), STATE_TERMS_RTOL
    assert err <= rtol * scale and rel <= row_rtol, (
        f"{tag} {label}: max abs error {err} (at most {rtol * scale}), row error {rel} "
        f"(at most {row_rtol})")
    return dict(max_abs_err=err, atol=rtol * scale, row_rel_err=rel, rtol=row_rtol,
                row_scale="row" if terms is None else "terms")


def _mamba_terms(p, cfg, x, h0=None, tail=None):
    """The magnitudes of the terms that Mamba's state sums: its recurrence
    h_t = da_t * h_{t-1} + |dbx_t| over x's tokens from |h0| (or zeros), in
    f32 on x's device (da > 0, so each term enters by its magnitude)."""
    from repro_torch.models import layers, mamba

    di = p["in_proj"]["kernel"].shape[1] // 2
    x1 = layers.dense(p["in_proj"], x)[..., :di]
    xc, _ = mamba._conv_causal(p["conv_w"], p["conv_b"], x1, tail)
    da, dbx, _ = mamba._ssm_inputs(p, cfg, torch.nn.functional.silu(xc))
    h = h0.abs() if h0 is not None else torch.zeros_like(da[:, 0])
    for t in range(da.shape[1]):
        h = torch.addcmul(dbx[:, t].abs(), da[:, t], h)
    return h


def _mlstm_terms(p, cfg, x):
    """The magnitudes of the terms that an mLSTM prefill's c and n sum:
    _mlstm_state_from_seq over |k| and |v| (its weights are positive)."""
    from repro_torch.models import layers, xlstm

    q, k, v, i_pre, f_pre, _, tail, _ = xlstm._mlstm_qkvgates(
        p, cfg, layers.apply_norm(p["norm"], x))
    st = xlstm._mlstm_state_from_seq(q, k.abs(), v.abs(), i_pre, f_pre, tail)
    return {"c": st["c"], "n": st["n"]}


def _hidden(cfg, g, dev):
    """(*shape) -> normalised bf16 hidden states (B, S, d_model) from g."""
    from repro_torch.models import layers

    norm = {"scale": torch.ones(cfg.d_model, dtype=torch.bfloat16, device=dev)}
    return lambda *shape: layers.apply_norm(norm, torch.randn(
        shape + (cfg.d_model,), generator=g, device=dev).to(torch.bfloat16))


def mla_layer_check(name_power):
    """5d(a): one MLA layer at full width (make_mla from seed 0, bf16) on
    normalised hidden states: mla_forward over MLA_TOKENS tokens (on the card
    through flash_bf16<192>) and mla_decode on a 4-row batch at
    MLA_DECODE_POS over a CAPACITY-row latent cache filled from a seed, the
    card against the host CPU on the same tensors; the cache written in place
    at exactly those rows."""
    from repro_torch.models import attention

    cfg = get_config(MLA_ARCH)
    dev = torch.device("cuda")
    p = attention.make_mla(torch.Generator(device=dev).manual_seed(0), cfg, torch.bfloat16)
    p_host = transformer.tree_map(lambda t: t.cpu(), p)
    g = torch.Generator(device=dev).manual_seed(1)
    hidden = _hidden(cfg, g, dev)
    x = hidden(1, MLA_TOKENS)
    positions = torch.arange(MLA_TOKENS, device=dev)[None]
    sto_step.reset_launches()
    t0 = time.perf_counter()
    y, cache = attention.mla_forward(p, cfg, x, positions, return_cache=True)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = sto_step.LAUNCHES["flash_attention"]
    assert launches == 1, f"mla_forward on the card launched flash {launches} times"
    t0 = time.perf_counter()
    y_h, cache_h = attention.mla_forward(p_host, cfg, x.cpu(), positions.cpu(), return_cache=True)
    host_s = time.perf_counter() - t0
    pre = {"y": _held("prefill y", y, y_h, MLA_Y_RTOL)}
    for k in ("c_kv", "k_rope"):
        pre[k] = _held(f"prefill {k}", cache[k], cache_h[k], MLA_CACHE_RTOL)
    print(f"5d(a) mla_forward, {MLA_TOKENS} tokens (flash_bf16<192>, {launches} launch) vs the "
          f"host CPU's einsum path: {json.dumps(pre)}; card {card_s:.3f} s (first call), host CPU "
          f"{host_s:.3f} s ({name_power})", flush=True)

    r, dr = cfg.mla.kv_lora_rank, cfg.mla.qk_rope_head_dim
    latent = lambda w: torch.randn((LM_SLOTS, CAPACITY, w), generator=g,  # noqa: E731
                                   device=dev).to(torch.bfloat16)
    cache = {"c_kv": latent(r), "k_rope": latent(dr)}
    before = {k: v.clone() for k, v in cache.items()}
    cache_h = {k: v.cpu().clone() for k, v in cache.items()}
    xd = hidden(LM_SLOTS, 1)
    pos = torch.tensor(MLA_DECODE_POS, device=dev)
    t0 = time.perf_counter()
    yd, out = attention.mla_decode(p, cfg, xd, cache, pos)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    assert out is cache, "mla_decode returned another cache"
    yd_h, _ = attention.mla_decode(p_host, cfg, xd.cpu(), cache_h, pos.cpu())
    dec = {"y": _held("decode y", yd, yd_h, MLA_Y_RTOL)}
    rows = torch.arange(LM_SLOTS, device=dev)
    written = torch.zeros((LM_SLOTS, CAPACITY), dtype=torch.bool, device=dev)
    written[rows, pos] = True
    for k in ("c_kv", "k_rope"):
        assert torch.equal(cache[k][~written], before[k][~written]), f"5d(a) {k}: a row moved"
        assert not torch.equal(cache[k][written], before[k][written]), f"5d(a) {k}: not written"
        dec[k] = _held(f"decode {k} rows", cache[k][rows, pos], cache_h[k][rows.cpu(), pos.cpu()],
                       MLA_CACHE_RTOL)
    print(f"5d(a) mla_decode, {LM_SLOTS} rows at positions {list(MLA_DECODE_POS)} over a "
          f"{CAPACITY}-row latent cache vs the host CPU: {json.dumps(dec)}; the cache written in "
          f"place at exactly those rows, every other row bit-equal; card {card_s:.3f} s (first "
          f"call) ({name_power})", flush=True)
    for t in (y, yd):
        assert torch.isfinite(t).all()
    del p, p_host, cache, before, cache_h


class _MlaTorchSpans:
    """torch for models/attention.py, each einsum and the absorbed decode's
    softmax inside a profiler span (phase 5d(d)'s split only)."""

    LABELS = {"bsr,rhd->bshd": "mla decompression einsums"}

    def __getattr__(self, name):
        return getattr(torch, name)

    @classmethod
    def einsum(cls, eq, *ops):
        with torch.profiler.record_function(cls.LABELS.get(eq, "mla absorbed einsums + softmax")):
            return torch.einsum(eq, *ops)

    @staticmethod
    def softmax(*a, **kw):
        with torch.profiler.record_function("mla absorbed einsums + softmax"):
            return torch.softmax(*a, **kw)


@contextlib.contextmanager
def mla_spans(mla):
    """Profiler spans around MLA's parts and the MoE layer, put in by this
    script for a traced call: the q projection and its rope (_mla_qsplit),
    wkv_a with the latent's norm and the rope key, the decompression einsums
    (prefill), the absorbed einsums and softmax (decode), wo, and apply_moe as
    a whole (`mla`: the config's MLAConfig). The flash kernel is read by its
    name."""
    from repro_torch.models import attention, moe

    saved = (attention.torch, attention._mla_qsplit, attention.dense, attention.row_dense,
             attention.apply_norm, attention.apply_rope, moe.apply_moe)
    qsplit, dense, row_dense, apply_norm, apply_rope, apply_moe = saved[1:]
    in_q = []

    def span(label, fn, *a, **kw):
        with torch.profiler.record_function(label):
            return fn(*a, **kw)

    def q_part(*a, **kw):
        in_q.append(True)
        try:
            return span("mla q projection + rope", qsplit, *a, **kw)
        finally:
            in_q.pop()

    def dense_part(p, x):
        if in_q:  # inside the q span
            return dense(p, x)
        latent = p["kernel"].shape[-1] == mla.kv_lora_rank + mla.qk_rope_head_dim
        return span("mla wkv_a + norm + rope" if latent else "mla wo", dense, p, x)

    def rope_part(x, ang):
        return apply_rope(x, ang) if in_q else span("mla wkv_a + norm + rope", apply_rope, x, ang)

    attention.torch = _MlaTorchSpans()
    attention._mla_qsplit = q_part
    attention.dense = dense_part
    attention.row_dense = lambda *a, **kw: span("mla wo", row_dense, *a, **kw)
    attention.apply_norm = lambda *a, **kw: span("mla wkv_a + norm + rope", apply_norm, *a, **kw)
    attention.apply_rope = rope_part
    moe.apply_moe = lambda *a, **kw: span("moe layer", apply_moe, *a, **kw)
    try:
        yield
    finally:
        (attention.torch, attention._mla_qsplit, attention.dense, attention.row_dense,
         attention.apply_norm, attention.apply_rope, moe.apply_moe) = saved


MLA_SPLIT = {  # span label -> the split's part
    "mla q projection + rope": "q projection + rope",
    "mla wkv_a + norm + rope": "wkv_a + norm + rope",
    "mla decompression einsums": "decompression einsums",
    "mla absorbed einsums + softmax": "absorbed einsums + softmax",
    "mla wo": "wo",
    "moe layer": "MoE layer, all",
}


def mla_split(cfg, label, fn, name_power):
    """fn traced once under mla_spans: device ms by MLA_SPLIT's parts."""
    return span_split("5d(d)", label, fn, lambda: mla_spans(cfg.mla), MLA_SPLIT, name_power,
                      parts=tuple(MLA_SPLIT.values()),
                      rest="other (embedding, norms, the dense prefix MLP, head, casts)")
def mla_prefill_bounds(cfg, prompt, kept):
    """A prefill's operations bound (ms) two ways, as moe_prefill_bounds: MLA
    as the port launches it (q, wkv_a, the decompression, attention at the
    concat head dim on both products, wo) with the reference's MoE dispatch
    (every expert's capacity slots and the one-hot products), and with only
    the kept pairs' experts; bf16 products at the tensor peak, the f32 router
    and head at the FP32 peak. Also the first's TFLOP, and the attention's
    GFLOP a layer as launched and with P.V at v's own width."""
    fp32, tensor, _ = peaks(torch.cuda.get_device_name(0))
    m, d, h, t = cfg.moe, cfg.d_model, cfg.num_heads, prompt
    r, dn, dr, dv = (cfg.mla.kv_lora_rank, cfg.mla.qk_nope_head_dim, cfg.mla.qk_rope_head_dim,
                     cfg.mla.v_head_dim)
    pairs = fa.band_pairs(t, t, True, 0)
    attn, attn_own = 4 * h * (dn + dr) * pairs, 2 * h * pairs * (dn + dr + dv)
    mla = (2 * t * d * h * (dn + dr) + 2 * t * d * (r + dr) + 2 * t * r * h * (dn + dv)
           + 2 * t * h * dv * d + attn)
    n_moe = sum(spec.mlp == "moe" for spec in cfg.layer_kinds())
    e, f, fs = m.num_experts, m.d_ff_expert, m.d_ff_expert * m.num_shared
    algo, router = 0.0, 0.0
    for lo in range(0, t, m.router_chunk):
        c = min(m.router_chunk, t - lo)
        cap = max(1, math.ceil(c * m.top_k / e * m.capacity_factor))
        algo += 3 * 2 * e * cap * d * f + 2 * 2 * c * e * cap * d
        router += 2 * c * d * e
    need = 3 * 2 * kept * d * f
    common = cfg.num_layers * mla + n_moe * 3 * 2 * t * d * fs + 3 * 2 * t * d * cfg.d_ff
    f32 = n_moe * router + 2 * d * cfg.padded_vocab  # the router; the last position's head
    ms = lambda bf16: 1e3 * (bf16 / tensor + f32 / fp32)  # noqa: E731
    return (ms(n_moe * algo + common), ms(need + common), (n_moe * algo + common + f32) / 1e12,
            attn / 1e9, attn_own / 1e9)


def mla_serve(name_power):
    """5d(c) and (d): deepseek-v2-lite-16b served at full width; returns the
    flash launches of the engine run and the timings."""
    import dataclasses

    from repro_torch import tree

    cfg = dataclasses.replace(get_config(MLA_ARCH), num_layers=MLA_SERVE_LAYERS)
    model = build_model(cfg, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s, init_peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated()
    n_params = sum(t.numel() for t in tree.leaves(params))
    print(f"5d(c) {MLA_ARCH} at {cfg.num_layers} of {get_config(MLA_ARCH).num_layers} layers: "
          f"{n_params} parameters (count_params {counting.count_params(cfg)}, "
          f"active {counting.count_params(cfg, active_only=True)}), init on the card "
          f"{init_s:.3f} s, peak {init_peak / 2**30:.3f} GiB ({name_power})", flush=True)
    rng = np.random.default_rng(0)
    reqs = [Request(i, torch.from_numpy(rng.integers(0, cfg.vocab_size, n)), MAX_NEW)
            for i, n in enumerate(PROMPTS)]
    Engine(cfg, params, num_slots=2, capacity=64, device="cuda").run(
        [Request(0, reqs[-1].prompt[:32], 2), Request(1, reqs[-1].prompt[:16], 2)])
    torch.cuda.reset_peak_memory_stats()
    eng, results, seconds, launches = moe_engine_run(cfg, params, reqs)
    peak = torch.cuda.max_memory_allocated()
    assert sorted(results) == [r.rid for r in reqs], f"served {sorted(results)}"
    for r in reqs:
        toks = results[r.rid]
        assert len(toks) == MAX_NEW and all(0 <= t < cfg.vocab_size for t in toks), (r.rid, toks)
    want = cfg.num_layers * len(PROMPTS)
    assert launches["flash_attention"] == want, f"flash launches {launches} != {want}"
    assert not any(launches[k] for k in STO_KERNELS), f"STO kernels launched: {launches}"
    spec_bytes = sum(math.prod(sp.shape) * 2 for sp in tree.leaves(model.cache_specs(
        LM_SLOTS, CAPACITY)))
    cache_bytes = sum(t.numel() * t.element_size() for t in tree.leaves(eng.caches))
    keys = sorted({k for layer in eng.caches["stack"] for k in layer["self"]})
    assert cache_bytes == spec_bytes and keys == ["c_kv", "k_rope"], (cache_bytes, spec_bytes, keys)
    st = eng.stats
    print(f"5d(c) serve {MLA_ARCH}: {len(reqs)} requests, {sum(map(len, results.values()))} "
          f"tokens in {seconds:.3f} s; prefill {st.prefill_tokens} tokens in "
          f"{st.prefill_seconds:.3f} s = {st.prefill_tokens / st.prefill_seconds:.1f} tok/s; "
          f"decode {st.decode_steps} steps, {st.decode_tokens} tokens in {st.decode_seconds:.3f} s "
          f"= {st.decode_tokens / st.decode_seconds:.1f} tok/s; peak memory {peak / 2**30:.3f} GiB; "
          f"the latent cache ({keys}) {cache_bytes / 1e9:.3f} GB = cache_specs' "
          f"{spec_bytes / 1e9:.3f} GB; launches {launches} ({name_power})", flush=True)
    del eng
    eng, again, _, _ = moe_engine_run(cfg, params, reqs)
    same = all(again[r.rid] == results[r.rid] for r in reqs)
    print(f"5d(c) a second engine run on the same requests bit-equal, token for token: {same}",
          flush=True)
    assert same, "the second engine run differs"

    # (d) where the time goes: one 4608-token prefill and one batch-4 decode step
    prompt = max(PROMPTS)
    batch = {"tokens": reqs[0].prompt[None].cuda()}
    prefill_ms = time_ms(lambda: model.prefill(params, batch), 3)
    used = []
    with route_spy(kept(used)):
        model.prefill(params, batch)
    bound, bound_need, tflop, attn_gflop, attn_own = mla_prefill_bounds(
        cfg, prompt, sum(k for _, k in used))
    print(f"5d(d) prefill {prompt} tokens: {prefill_ms:.3f} ms (CUDA events, median of 3); "
          f"operations bound {bound:.3f} ms as the port launches MLA and the reference's dispatch "
          f"computes the MoE ({tflop:.2f} TFLOP; {100 * bound / prefill_ms:.1f} %), "
          f"{bound_need:.3f} ms for what the tokens need (kept pairs' experts only); attention "
          f"{attn_gflop:.1f} GFLOP a layer as launched (QK and PV at {cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim}), "
          f"{attn_own:.1f} with PV at v's {cfg.mla.v_head_dim} ({name_power})", flush=True)
    mla_split(cfg, f"prefill {prompt} tokens", lambda: model.prefill(params, batch), name_power)
    tokens, caches = eng.next_tokens.clone(), eng.caches
    pos = torch.tensor([n - 1 for n in PROMPTS[:LM_SLOTS]], device="cuda")
    decode_ms = time_ms(lambda: model.decode_step(params, tokens, caches, pos), 5)
    used = []
    with route_spy(kept(used)):
        model.decode_step(params, tokens, caches, pos)
    bound, bound_need, gb, gb_need = moe_decode_bounds(cfg, LM_SLOTS, pos.cpu(), used)
    print(f"5d(d) decode step, batch {LM_SLOTS}, capacity {CAPACITY}: {decode_ms:.3f} ms (CUDA "
          f"events, median of 5); bytes bound {bound:.3f} ms ({gb:.2f} GB: every weight once, "
          f"all {cfg.moe.num_experts} experts a layer as the reference's dispatch reads them, the "
          f"latent rows up to each position; {100 * bound / decode_ms:.1f} %), {bound_need:.3f} ms "
          f"({gb_need:.2f} GB) for the experts the step kept ({min(used)[0]}-{max(used)[0]} a "
          f"layer, {sum(u for u, _ in used)} in all) ({name_power})", flush=True)
    mla_split(cfg, f"decode step batch {LM_SLOTS}",
              lambda: model.decode_step(params, tokens, caches, pos), name_power)
    del caches, eng

    # the no-drop witness: capacity num_experts / top_k keeps every token
    m = cfg.moe
    cfg_nd = dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.num_experts / m.top_k))
    model_nd = build_model(cfg_nd, device="cuda")
    t_nd = time.perf_counter()
    eng, results_nd, seconds, launches = moe_engine_run(cfg_nd, params, reqs)
    del eng
    assert launches["flash_attention"] == want, launches
    changed = sum(results_nd[r.rid] != results[r.rid] for r in reqs)
    print(f"5d(c) capacity factor {cfg_nd.moe.capacity_factor} (no drops): {len(reqs)} requests "
          f"in {seconds:.3f} s; {changed} of {len(reqs)} requests' tokens differ from the "
          f"capacity-{m.capacity_factor} run", flush=True)
    no_drop_witness(model_nd, params, cfg_nd, reqs, results_nd, tag="5d(c)")
    witness_s = time.perf_counter() - t_nd
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches=want, peak=peak, init_peak=init_peak, prefill_ms=prefill_ms,
                decode_ms=decode_ms, witness_s=witness_s)


def mla_phase(name, name_power):
    """Phase 5d: MLA. Returns the flash kernel's deepseek-v2-lite row (D =
    192) with the engine run's launches."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    mla_layer_check(name_power)
    cfg = get_config(MLA_ARCH)
    flash = flash_case(name, MLA_ARCH, *MLA_FLASH_CASE,
                       head_dim=cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim,
                       v_dim=cfg.mla.v_head_dim)
    t1 = time.perf_counter()
    served = mla_serve(name_power)
    seconds = time.perf_counter() - t0
    print(f"phase 5d: {seconds:.1f} s ((a) and (b) {t1 - t0:.1f} s, (c) and (d) "
          f"{seconds - (t1 - t0):.1f} s, of which the no-drop run and its witness "
          f"{served['witness_s']:.1f} s) ({name_power})", flush=True)
    keys = ("ms", "single_call_ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library",
            "share_of_bound", "max_abs_err", "row_rel_err", "head_dim", "v_dim",
            "bound_ms_v_own_width")
    return dict({k: flash[k] for k in keys}, launches=served["launches"])


def mla_only():
    """`chip_smoke.py --mla`: build the kernels and run phase 5d alone."""
    name_power = card_line()
    print(f"card: {name_power}", flush=True)
    _build.load()
    if _build.BUILD_LOG:
        print(_build.BUILD_LOG.strip(), flush=True)
    flash_config(torch.cuda.get_device_name(0))
    mla_phase(torch.cuda.get_device_name(0), name_power)
    print("5d held", flush=True)


# -- phase 5e: the recurrent mixers: jamba's Mamba at full width, xlstm-125m whole ------

JAMBA_ARCH = "jamba-1.5-large-398b"
XLSTM_ARCH = "xlstm-125m"
# (c) the depth cut: jamba's period cut to its first 4 layer specs (3 Mamba
# layers, the attention layer, 2 MoE and 2 MLP channel mixers: every layer
# kind jamba has), num_layers 4: 23.0 B parameters, ~46 GB in bf16. The
# whole 72-layer model (398.6 B) fits no card.
JAMBA_SPECS = 4
MAMBA_TOKENS = 1024 + 37  # (a): 16 chunks of 64 and a remainder of 37 (27 padded steps)
# (a) the card against the host CPU on the same tensors, by phase 4's two
# measures. y: the chain rounds to bf16 at in_proj, the conv and its silu,
# x_proj, the three norms, dt_proj and the gated output before out_proj,
# each GEMM's f32 sums in another order on each side (an element a bf16 ulp
# or two, 2^-8 of it each, apart), and the f32 scan carries those
# differences along 1061 steps; as MLA_Y_RTOL. h: the f32 state built from
# those bf16 inputs, alike; its row measure is over the row's largest term
# magnitude (_held's `terms`, from _mamba_terms): a channel's state is a sum
# over the tokens of terms of both signs, which can cancel to a small
# fraction of the terms whose rounding it carries (a card reading found a
# row at 9.4e-2 of its own largest element with the whole tensor within
# 4.0e-3 of its largest, about one bf16 rounding, 2^-8).
# conv_tail: the last K - 1 rows of in_proj's bf16 output, one GEMM: as
# MLA_CACHE_RTOL.
MAMBA_Y_RTOL = 2.0**-5
MAMBA_STATE_RTOL = 2.0**-5
MAMBA_TAIL_RTOL = 2.0**-6
# (a) chunks of 64 against one chunk of the whole sequence, on the card: the
# f32 recurrence runs step by step in the same order either way; x_proj,
# dt_proj and the C product run at another row count (64 against 1061),
# which may round a bf16 value or an f32 sum otherwise: two bf16 ulps.
MAMBA_CHUNK_RTOL = 2.0**-6
# (d) one xLSTM block (bf16) on the card against the host CPU: the up, q, k,
# v, gate and down products and the norms round to bf16 (a bf16 ulp or two
# apart), and the f32 states and the mLSTM's parallel form sum them in
# another order; as MAMBA_Y_RTOL. The f32 states (c, n, m; sLSTM's h) alike;
# the mLSTM prefill's c and n, sums over the tokens as Mamba's h is, by the
# row measure over their terms' magnitudes (_mlstm_terms).
XLSTM_TOKENS = 1024
XLSTM_RTOL = 2.0**-5
# (d) xlstm-125m serves phase 5's prompts cut to an eighth of their lengths
# (576 ... 16 tokens): the sLSTM blocks run a Python loop over the tokens,
# ~0.39 ms a token a block on the card (a 4608-token prefill of the whole
# model 5.3 s), so phase 5's 14 731 prompt tokens cost 17 s a run and the
# engine runs and the witness ~70 s (a run with the whole prompts)
XLSTM_PROMPTS = tuple(n // 8 for n in PROMPTS)
# (b) flash at jamba's attention layer: H 64, KVH 8 (a GQA group of 8), D 128,
# no RoPE (pos_type "none"), its longest prompt
JAMBA_FLASH_CASE = (4608, 4608, torch.bfloat16, 0)


def jamba_cut():
    """jamba-1.5-large with its period cut to its first JAMBA_SPECS layer
    specs and num_layers JAMBA_SPECS (one period), at full width."""
    import dataclasses

    full = get_config(JAMBA_ARCH)
    return dataclasses.replace(full, period=full.period[:JAMBA_SPECS], num_layers=JAMBA_SPECS)


def _host_ms(fn, reps=1):
    """Median host-clock ms of fn on the host CPU over reps calls."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return sorted(times)[len(times) // 2]


def _states_from_seed(spec, g, dev):
    """A cache dict for a TensorSpec dict, every leaf normal draws from g."""
    return {k: torch.randn(s.shape, generator=g, device=dev).to(s.dtype) for k, s in spec.items()}


def mamba_layer_bounds(cfg, t, rows):
    """A full-width Mamba layer's bounds (ms): a t-token prefill by
    operations (the four bf16 products; the f32 scan, ~7 operations a token
    and state element: dA, dBx, the step, the C product), and a rows-row
    decode step by bytes (every weight once, h read and written in f32, the
    conv tail)."""
    from repro_torch.models import mamba

    fp32, tensor, bw = peaks(torch.cuda.get_device_name(0))
    mc, di, dtr = mamba._dims(cfg)
    d, ds = cfg.d_model, mc.d_state
    gemm = 2 * t * (d * 2 * di + di * (dtr + 2 * ds) + dtr * di + di * d)
    prefill = 1e3 * (gemm / tensor + 7 * t * di * ds / fp32)
    weights = 2 * (d * 2 * di + mc.d_conv * di + di * (dtr + 2 * ds) + dtr * di + di * d
                   + 3 * di + dtr + 2 * ds) + 4 * di * ds
    state = rows * (2 * 4 * di * ds + 2 * 2 * (mc.d_conv - 1) * di)
    return prefill, 1e3 * (weights + state) / bw


def mamba_layer_check(name_power):
    """5e(a): one Mamba layer of jamba at full width (make_mamba from seed 0,
    bf16: d_model 8192, d_inner 16384, d_state 16, dt_rank 512, chunk 64) on
    normalised hidden states: mamba_forward over MAMBA_TOKENS tokens (y, h,
    conv_tail) and mamba_decode on a 4-row batch with states from a seed (y
    and the cache written in place), the card against the host CPU on the
    same tensors; chunks of 64 against one chunk of the whole sequence on the
    card; the prefill (phase 5's longest prompt) and the decode step timed on
    the card (CUDA events), the decode step on the host CPU too (host clock);
    the host CPU's prefill time is that of its MAMBA_TOKENS-token run above
    (a 4608-token host run took 26-41 s of the script, and no check read it)."""
    import dataclasses

    from repro_torch.models import mamba

    cfg = get_config(JAMBA_ARCH)
    dev = torch.device("cuda")
    p = mamba.make_mamba(torch.Generator(device=dev).manual_seed(0), cfg, torch.bfloat16)
    p_host = transformer.tree_map(lambda t: t.cpu(), p)
    g = torch.Generator(device=dev).manual_seed(1)
    hidden = _hidden(cfg, g, dev)
    x = hidden(1, MAMBA_TOKENS)
    sto_step.reset_launches()
    t0 = time.perf_counter()
    y, cache = mamba.mamba_forward(p, cfg, x, return_cache=True)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    assert not any(sto_step.LAUNCHES.values()), dict(sto_step.LAUNCHES)
    t0 = time.perf_counter()
    y_h, cache_h = mamba.mamba_forward(p_host, cfg, x.cpu(), return_cache=True)
    host_s = time.perf_counter() - t0
    terms = _mamba_terms(p, cfg, x)
    pre = {"y": _held("prefill y", y, y_h, MAMBA_Y_RTOL, "5e(a)"),
           "h": _held("prefill h", cache["h"], cache_h["h"], MAMBA_STATE_RTOL, "5e(a)", terms),
           "conv_tail": _held("prefill conv_tail", cache["conv_tail"], cache_h["conv_tail"],
                              MAMBA_TAIL_RTOL, "5e(a)")}
    whole = dataclasses.replace(cfg, mamba=dataclasses.replace(cfg.mamba, chunk=MAMBA_TOKENS))
    y1, c1 = mamba.mamba_forward(p, whole, x, return_cache=True)
    chunked = {"y": _held("chunk 64 vs one chunk: y", y, y1, MAMBA_CHUNK_RTOL, "5e(a)"),
               "h": _held("chunk 64 vs one chunk: h", cache["h"], c1["h"], MAMBA_CHUNK_RTOL,
                          "5e(a)", terms)}
    for t in (y, cache["h"], y1):
        assert torch.isfinite(t).all()
    del y1, c1, y_h, cache_h, terms
    print(f"5e(a) mamba_forward, {MAMBA_TOKENS} tokens (chunks of {cfg.mamba.chunk}, "
          f"{-MAMBA_TOKENS % cfg.mamba.chunk} padded steps), no kernel launched, vs the host CPU: "
          f"{json.dumps(pre)}; chunks of {cfg.mamba.chunk} vs one chunk of {MAMBA_TOKENS} on the "
          f"card: {json.dumps(chunked)}; card {card_s:.3f} s (first call), host CPU {host_s:.3f} s "
          f"({name_power})", flush=True)

    cache = _states_from_seed(mamba.mamba_cache_spec(cfg, LM_SLOTS, torch.bfloat16), g, dev)
    before = {k: v.clone() for k, v in cache.items()}
    leaves = dict(cache)
    cache_h = {k: v.cpu().clone() for k, v in cache.items()}
    xd = hidden(LM_SLOTS, 1)
    yd, out = mamba.mamba_decode(p, cfg, xd, cache)
    assert out is cache and all(cache[k] is leaves[k] for k in leaves), "not in place"
    yd_h, _ = mamba.mamba_decode(p_host, cfg, xd.cpu(), cache_h)
    terms = _mamba_terms(p, cfg, xd, before["h"], before["conv_tail"])
    dec = {"y": _held("decode y", yd, yd_h, MAMBA_Y_RTOL, "5e(a)"),
           "h": _held("decode h", cache["h"], cache_h["h"], MAMBA_STATE_RTOL, "5e(a)", terms),
           "conv_tail": _held("decode conv_tail", cache["conv_tail"], cache_h["conv_tail"],
                              MAMBA_TAIL_RTOL, "5e(a)")}
    shifted = torch.equal(cache["conv_tail"][:, :-1], before["conv_tail"][:, 1:])
    assert shifted and not torch.equal(cache["h"], before["h"]), "decode wrote no new state"
    print(f"5e(a) mamba_decode, {LM_SLOTS} rows, states from a seed, vs the host CPU: "
          f"{json.dumps(dec)}; h and conv_tail written in place (the same tensors; the tail "
          f"shifted by one row) ({name_power})", flush=True)

    xl = hidden(1, max(PROMPTS))
    prefill_ms = time_ms(lambda: mamba.mamba_forward(p, cfg, xl), 3)
    decode_ms = time_ms(lambda: mamba.mamba_decode(p, cfg, xd, cache), 5)
    cache_h = {k: v.cpu().clone() for k, v in cache.items()}
    host_decode_ms = _host_ms(lambda: mamba.mamba_decode(p_host, cfg, xd.cpu(), cache_h), 3)
    pb, db = mamba_layer_bounds(cfg, max(PROMPTS), LM_SLOTS)
    print(f"5e(a) one Mamba layer at full width: prefill {max(PROMPTS)} tokens {prefill_ms:.3f} ms "
          f"on the card (CUDA events, median of 3; operations bound {pb:.3f} ms, "
          f"{100 * pb / prefill_ms:.1f} %), the host CPU {1e3 * host_s:.3f} ms for "
          f"{MAMBA_TOKENS} tokens (one call); "
          f"decode step, batch {LM_SLOTS}: {decode_ms:.3f} ms on the card (median of 5; bytes "
          f"bound {db:.4f} ms, {100 * db / decode_ms:.1f} %), {host_decode_ms:.3f} ms on the host "
          f"CPU (median of 3) ({name_power})", flush=True)
    del p, p_host, cache, before, cache_h
    gc.collect()
    torch.cuda.empty_cache()
    return dict(prefill_ms=prefill_ms, host_prefill_ms=1e3 * host_s, decode_ms=decode_ms,
                host_decode_ms=host_decode_ms)


class _MambaTorchSpans:
    """torch for models/mamba.py, each einsum (the C product of a prefill
    chunk; decode's) inside the scan's profiler span (phase 5e(c)'s split
    only)."""

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def einsum(eq, *ops):
        with torch.profiler.record_function("mamba scan + C einsum"):
            return torch.einsum(eq, *ops)


@contextlib.contextmanager
def mamba_spans(cfg):
    """Profiler spans around Mamba's parts and the MoE layer, put in by this
    script for a traced call: in_proj, the causal conv, x_proj with the three
    norms and dt (_ssm_inputs: also dA and dBx), the scan with the C
    einsum (_chunk_states and the einsums), the skip and gate with out_proj,
    and apply_moe as a whole. The flash kernel is read by its name."""
    from repro_torch.models import mamba, moe

    saved = (mamba.torch, mamba.whole_cols, mamba.row_dense, mamba._conv_causal,
             mamba._ssm_inputs, mamba._chunk_states, mamba._gate_output, moe.apply_moe)
    _, whole_cols, row_dense, conv, ssm, states, gate, apply_moe = saved
    in_ssm = []

    def span(label, fn, *a, **kw):
        with torch.profiler.record_function(label):
            return fn(*a, **kw)

    def ssm_part(*a, **kw):
        in_ssm.append(True)
        try:
            return span("mamba x_proj + norms + dt", ssm, *a, **kw)
        finally:
            in_ssm.pop()

    def row_part(*a, **kw):  # x_proj inside its span, else out_proj
        return row_dense(*a, **kw) if in_ssm else span("mamba gate + out_proj", row_dense, *a,
                                                       **kw)

    mamba.torch = _MambaTorchSpans()
    mamba.whole_cols = lambda *a, **kw: span("mamba in_proj", whole_cols, *a, **kw)
    mamba.row_dense = row_part
    mamba._conv_causal = lambda *a, **kw: span("mamba conv", conv, *a, **kw)
    mamba._ssm_inputs = ssm_part
    mamba._chunk_states = lambda *a, **kw: span("mamba scan + C einsum", states, *a, **kw)
    mamba._gate_output = lambda *a, **kw: span("mamba gate + out_proj", gate, *a, **kw)
    moe.apply_moe = lambda *a, **kw: span("moe layer", apply_moe, *a, **kw)
    try:
        yield
    finally:
        (mamba.torch, mamba.whole_cols, mamba.row_dense, mamba._conv_causal, mamba._ssm_inputs,
         mamba._chunk_states, mamba._gate_output, moe.apply_moe) = saved


MAMBA_SPLIT = {  # span label -> the split's part
    "mamba in_proj": "in_proj",
    "mamba conv": "conv",
    "mamba x_proj + norms + dt": "x_proj + norms + dt",
    "mamba scan + C einsum": "scan + C einsum",
    "mamba gate + out_proj": "gate + out_proj",
    "moe layer": "MoE layers, all",
}


def jamba_split(cfg, label, fn, name_power):
    """fn traced once under mamba_spans: device ms by MAMBA_SPLIT's parts."""
    return span_split("5e(c)", label, fn, lambda: mamba_spans(cfg), MAMBA_SPLIT, name_power,
                      parts=tuple(MAMBA_SPLIT.values()),
                      rest="other (the attention layer's projections, the MLPs, silu, norms, "
                           "embedding, head, casts)")


def jamba_prefill_bound(cfg, t):
    """A t-token prefill of the cut jamba by operations (ms, TFLOP), as the
    port runs it: the Mamba layers' products (bf16) and scans (f32), the
    attention layer's projections and flash, the MLPs, the MoE layers as the
    reference's dispatch computes them (every capacity slot, the one-hot
    products; the router in f32), the last position's f32 head."""
    from repro_torch.models import mamba

    fp32, tensor, _ = peaks(torch.cuda.get_device_name(0))
    mc, di, dtr = mamba._dims(cfg)
    d, ds, m = cfg.d_model, mc.d_state, cfg.moe
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    layer_bf16 = {
        "mamba": 2 * t * (d * 2 * di + di * (dtr + 2 * ds) + dtr * di + di * d),
        "attn": 2 * t * d * (h + 2 * kvh) * hd + 2 * t * h * hd * d
                + 4 * h * hd * fa.band_pairs(t, t, True, 0),
        "mlp": 3 * 2 * t * d * cfg.d_ff,
        "moe": 0.0,
    }
    router = 0.0
    for lo in range(0, t, m.router_chunk):
        c = min(m.router_chunk, t - lo)
        cap = max(1, math.ceil(c * m.top_k / m.num_experts * m.capacity_factor))
        layer_bf16["moe"] += (3 * 2 * m.num_experts * cap * d * m.d_ff_expert
                              + 2 * 2 * c * m.num_experts * cap * d)
        router += 2 * c * d * m.num_experts
    bf16 = f32 = 0.0
    for spec in cfg.layer_kinds():
        bf16 += layer_bf16[spec.mixer] + layer_bf16[spec.mlp]
        f32 += 7 * t * di * ds if spec.mixer == "mamba" else 0.0
        f32 += router if spec.mlp == "moe" else 0.0
    f32 += 2 * d * cfg.padded_vocab
    return 1e3 * (bf16 / tensor + f32 / fp32), (bf16 + f32) / 1e12


def jamba_decode_bound(cfg, params, rows, pos):
    """A rows-row decode step's bytes bound (ms, GB): every weight of the
    tree once (all 16 experts a MoE layer, as the reference's dispatch reads
    them; the embedding's `rows` rows only), the attention layer's k / v rows
    up to each position, each Mamba layer's h (f32) read and written and its
    conv tail."""
    from repro_torch import tree
    from repro_torch.models import mamba

    _, _, bw = peaks(torch.cuda.get_device_name(0))
    mc, di, _ = mamba._dims(cfg)
    weights = sum(t.numel() * t.element_size() for t in tree.leaves(params))
    weights -= (cfg.padded_vocab - rows) * cfg.d_model * 2
    kinds = [spec.mixer for spec in cfg.layer_kinds()]
    kv = kinds.count("attn") * int(sum(pos + 1)) * 2 * cfg.num_kv_heads * cfg.head_dim * 2
    states = kinds.count("mamba") * rows * (2 * 4 * di * mc.d_state + 2 * 2 * (mc.d_conv - 1) * di)
    total = weights + kv + states
    return 1e3 * total / bw, total / 1e9


def jamba_splice_check(cfg, params):
    """Four requests admitted into the slots of a fresh engine: each slot's
    h and conv_tail in every Mamba layer bit-equal to its lone prefill's."""
    model = build_model(cfg, device="cuda")
    rng = np.random.default_rng(5)
    reqs = [Request(i, torch.from_numpy(rng.integers(0, cfg.vocab_size, n)), 2)
            for i, n in enumerate(PROMPTS[LM_SLOTS:])]
    eng = Engine(cfg, params, num_slots=LM_SLOTS, capacity=CAPACITY, device="cuda")
    checked = 0
    for slot, r in enumerate(reqs):
        eng._admit(r, slot)
        _, alone = model.prefill(params, {"tokens": r.prompt[None].cuda()})
        for layer, lone, spec in zip(eng.caches["stack"], alone["stack"], cfg.period):
            if spec.mixer == "mamba":
                for k in ("h", "conv_tail"):
                    assert torch.equal(layer["self"][k][:, slot], lone["self"][k][:, 0]), (slot, k)
                    checked += 1
    del eng
    return checked


def jamba_serve(name_power):
    """5e(c): the cut jamba served at full width; returns the flash launches
    of the engine run and the timings."""
    import dataclasses

    from repro_torch import tree

    cfg = jamba_cut()
    model = build_model(cfg, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s, init_peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated()
    n_params = sum(t.numel() for t in tree.leaves(params))
    print(f"5e(c) {JAMBA_ARCH} cut to period[:{JAMBA_SPECS}] "
          f"({', '.join(f'{s.mixer}+{s.mlp}' for s in cfg.period)}), num_layers {cfg.num_layers}: "
          f"{n_params} parameters (count_params {counting.count_params(cfg)}; the whole "
          f"{get_config(JAMBA_ARCH).num_layers}-layer model "
          f"{counting.count_params(get_config(JAMBA_ARCH))}), init on the card {init_s:.3f} s, "
          f"peak {init_peak / 2**30:.3f} GiB ({name_power})", flush=True)
    rng = np.random.default_rng(0)
    reqs = [Request(i, torch.from_numpy(rng.integers(0, cfg.vocab_size, n)), MAX_NEW)
            for i, n in enumerate(PROMPTS)]
    Engine(cfg, params, num_slots=2, capacity=64, device="cuda").run(
        [Request(0, reqs[-1].prompt[:32], 2), Request(1, reqs[-1].prompt[:16], 2)])
    torch.cuda.reset_peak_memory_stats()
    eng, results, seconds, launches = moe_engine_run(cfg, params, reqs)
    peak = torch.cuda.max_memory_allocated()
    assert sorted(results) == [r.rid for r in reqs], f"served {sorted(results)}"
    for r in reqs:
        toks = results[r.rid]
        assert len(toks) == MAX_NEW and all(0 <= t < cfg.vocab_size for t in toks), (r.rid, toks)
    want = sum(spec.mixer == "attn" for spec in cfg.layer_kinds()) * len(PROMPTS)
    assert launches["flash_attention"] == want, f"flash launches {launches} != {want}"
    assert not any(launches[k] for k in STO_KERNELS), f"STO kernels launched: {launches}"
    st = eng.stats
    print(f"5e(c) serve the cut {JAMBA_ARCH}: {len(reqs)} requests, "
          f"{sum(map(len, results.values()))} tokens in {seconds:.3f} s; prefill "
          f"{st.prefill_tokens} tokens in {st.prefill_seconds:.3f} s = "
          f"{st.prefill_tokens / st.prefill_seconds:.1f} tok/s; decode {st.decode_steps} steps, "
          f"{st.decode_tokens} tokens in {st.decode_seconds:.3f} s = "
          f"{st.decode_tokens / st.decode_seconds:.1f} tok/s; peak memory {peak / 2**30:.3f} GiB; "
          f"launches {launches} (flash_bf16<128> at H {cfg.num_heads}, KVH {cfg.num_kv_heads}: a "
          f"GQA group of {cfg.num_heads // cfg.num_kv_heads}) ({name_power})", flush=True)
    del eng
    eng, again, _, _ = moe_engine_run(cfg, params, reqs)
    same = all(again[r.rid] == results[r.rid] for r in reqs)
    print(f"5e(c) a second engine run on the same requests bit-equal, token for token: {same}",
          flush=True)
    assert same, "the second engine run differs"
    checked = jamba_splice_check(cfg, params)
    print(f"5e(c) splice: {LM_SLOTS} requests admitted into {LM_SLOTS} slots, each slot's h and "
          f"conv_tail in every Mamba layer bit-equal to its lone prefill's ({checked} leaves)",
          flush=True)

    # (c) where the time goes: one 4608-token prefill and one batch-4 decode step
    prompt = max(PROMPTS)
    batch = {"tokens": reqs[0].prompt[None].cuda()}
    prefill_ms = time_ms(lambda: model.prefill(params, batch), 3)
    bound, tflop = jamba_prefill_bound(cfg, prompt)
    print(f"5e(c) prefill {prompt} tokens: {prefill_ms:.3f} ms (CUDA events, median of 3); "
          f"operations bound {bound:.3f} ms as the port runs it ({tflop:.2f} TFLOP; the MoE "
          f"layers as the reference's dispatch computes them; {100 * bound / prefill_ms:.1f} %) "
          f"({name_power})", flush=True)
    jamba_split(cfg, f"prefill {prompt} tokens", lambda: model.prefill(params, batch), name_power)
    tokens, caches = eng.next_tokens.clone(), eng.caches
    pos = torch.tensor([n - 1 for n in PROMPTS[:LM_SLOTS]], device="cuda")
    decode_ms = time_ms(lambda: model.decode_step(params, tokens, caches, pos), 5)
    bound, gb = jamba_decode_bound(cfg, params, LM_SLOTS, pos.cpu())
    print(f"5e(c) decode step, batch {LM_SLOTS}, capacity {CAPACITY}: {decode_ms:.3f} ms (CUDA "
          f"events, median of 5); bytes bound {bound:.3f} ms ({gb:.2f} GB: every weight once, all "
          f"{cfg.moe.num_experts} experts a MoE layer, the k / v rows up to each position, the "
          f"Mamba states; {100 * bound / decode_ms:.1f} %) ({name_power})", flush=True)
    jamba_split(cfg, f"decode step batch {LM_SLOTS}",
                lambda: model.decode_step(params, tokens, caches, pos), name_power)
    del caches, eng

    # the no-drop witness: capacity num_experts / top_k keeps every token
    m = cfg.moe
    cfg_nd = dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.num_experts / m.top_k))
    model_nd = build_model(cfg_nd, device="cuda")
    t_nd = time.perf_counter()
    eng, results_nd, seconds, launches = moe_engine_run(cfg_nd, params, reqs)
    del eng
    assert launches["flash_attention"] == want, launches
    changed = sum(results_nd[r.rid] != results[r.rid] for r in reqs)
    print(f"5e(c) capacity factor {cfg_nd.moe.capacity_factor} (no drops): {len(reqs)} requests "
          f"in {seconds:.3f} s; {changed} of {len(reqs)} requests' tokens differ from the "
          f"capacity-{m.capacity_factor} run", flush=True)
    gaps = [gap for r in reqs for gap in teacher_forced_margins(
        model_nd, params, cfg_nd, r, results_nd[r.rid], LM_SLOTS)]
    print(f"5e(c) no drops, vs each request alone (teacher-forced, {LM_SLOTS}-row decode): worst "
          f"logit margin {max(gaps):.4e} (must be 0), steps off the argmax "
          f"{sum(g > 0 for g in gaps)} of {len(gaps)}", flush=True)
    assert max(gaps) == 0.0, f"no-drop jamba engine vs the 4-row rerun: margin {max(gaps)}"
    witness_s = time.perf_counter() - t_nd
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches=want, peak=peak, init_peak=init_peak, prefill_ms=prefill_ms,
                decode_ms=decode_ms, witness_s=witness_s)


def xlstm_layer_check(name_power):
    """5e(d): one mLSTM and one sLSTM block of xlstm-125m at full width
    (make_mlstm / make_slstm from seed 0, bf16) on normalised hidden states:
    the forward over XLSTM_TOKENS tokens with its cache (mLSTM: out, c, n, m,
    conv_tail; sLSTM: out, c, n, m, h) and the decode on a 4-row batch with
    states from a seed (out and the states, written in place), the card
    against the host CPU on the same tensors."""
    from repro_torch.models import xlstm

    cfg = get_config(XLSTM_ARCH)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    hidden = _hidden(cfg, g, dev)
    for block in ("mlstm", "slstm"):
        make = getattr(xlstm, f"make_{block}")
        fwd, dec = getattr(xlstm, f"{block}_forward"), getattr(xlstm, f"{block}_decode")
        spec = getattr(xlstm, f"{block}_cache_spec")(cfg, LM_SLOTS, torch.bfloat16)
        p = make(torch.Generator(device=dev).manual_seed(0), cfg, torch.bfloat16)
        p_host = transformer.tree_map(lambda t: t.cpu(), p)
        x = hidden(1, XLSTM_TOKENS)
        sto_step.reset_launches()
        t0 = time.perf_counter()
        out, cache = fwd(p, cfg, x, return_cache=True)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        assert not any(sto_step.LAUNCHES.values()), dict(sto_step.LAUNCHES)
        t0 = time.perf_counter()
        out_h, cache_h = fwd(p_host, cfg, x.cpu(), return_cache=True)
        host_s = time.perf_counter() - t0
        pre = {"out": _held(f"{block} prefill out", out, out_h, XLSTM_RTOL, "5e(d)")}
        terms = _mlstm_terms(p, cfg, x) if block == "mlstm" else {}
        for k in spec:
            pre[k] = _held(f"{block} prefill {k}", cache[k], cache_h[k], XLSTM_RTOL, "5e(d)",
                           terms.get(k))
        del terms
        cache = _states_from_seed(spec, g, dev)
        leaves = dict(cache)
        cache_h = {k: v.cpu().clone() for k, v in cache.items()}
        xd = hidden(LM_SLOTS, 1)
        yd, got = dec(p, cfg, xd, cache)
        assert got is cache and all(cache[k] is leaves[k] for k in leaves), "not in place"
        yd_h, _ = dec(p_host, cfg, xd.cpu(), cache_h)
        step = {"out": _held(f"{block} decode out", yd, yd_h, XLSTM_RTOL, "5e(d)")}
        for k in spec:
            step[k] = _held(f"{block} decode {k}", cache[k], cache_h[k], XLSTM_RTOL, "5e(d)")
        print(f"5e(d) {block} block, card vs the host CPU: forward over {XLSTM_TOKENS} tokens "
              f"{json.dumps(pre)}; decode, {LM_SLOTS} rows, states from a seed, written in place "
              f"{json.dumps(step)}; forward card {card_s:.3f} s (first call), host CPU "
              f"{host_s:.3f} s ({name_power})", flush=True)
        del p, p_host, cache, cache_h


def xlstm_serve(name_power):
    """5e(d): xlstm-125m whole (12 blocks) served at full width: 8 requests
    (XLSTM_PROMPTS: phase 5's prompts at an eighth of their lengths, 32 new
    tokens each), 4 slots, capacity 4640; no
    kernel launched; a second run bit-equal; each request rerun alone in the
    engine's 4-row geometry (phase 5's witness) exact at every step; the
    prefill's ms at the longest prompt."""
    from repro_torch import tree

    cfg = get_config(XLSTM_ARCH)
    model = build_model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(t.numel() for t in tree.leaves(params))
    rng = np.random.default_rng(0)
    reqs = [Request(i, torch.from_numpy(rng.integers(0, cfg.vocab_size, n)), MAX_NEW)
            for i, n in enumerate(XLSTM_PROMPTS)]
    Engine(cfg, params, num_slots=2, capacity=64, device="cuda").run(
        [Request(0, reqs[-1].prompt[:32], 2), Request(1, reqs[-1].prompt[:16], 2)])
    torch.cuda.reset_peak_memory_stats()
    eng, results, seconds, launches = moe_engine_run(cfg, params, reqs)
    peak = torch.cuda.max_memory_allocated()
    assert sorted(results) == [r.rid for r in reqs], f"served {sorted(results)}"
    for r in reqs:
        toks = results[r.rid]
        assert len(toks) == MAX_NEW and all(0 <= t < cfg.vocab_size for t in toks), (r.rid, toks)
    assert not any(launches.values()), f"xLSTM launched kernels: {launches}"
    st = eng.stats
    print(f"5e(d) serve {XLSTM_ARCH} ({cfg.num_layers} blocks, {n_params} parameters, count_params "
          f"{counting.count_params(cfg)}): {len(reqs)} requests (prompts {list(XLSTM_PROMPTS)}), "
          f"{sum(map(len, results.values()))} tokens in {seconds:.3f} s; prefill "
          f"{st.prefill_tokens} tokens in {st.prefill_seconds:.3f} s = "
          f"{st.prefill_tokens / st.prefill_seconds:.1f} tok/s; decode {st.decode_steps} steps, "
          f"{st.decode_tokens} tokens in {st.decode_seconds:.3f} s = "
          f"{st.decode_tokens / st.decode_seconds:.1f} tok/s; peak memory {peak / 2**30:.3f} GiB; "
          f"launches {launches}: xLSTM launches no TPU kernel's counterpart (its mixers are "
          f"plain ops, as in the reference) ({name_power})", flush=True)
    del eng
    _, again, _, _ = moe_engine_run(cfg, params, reqs)
    same = all(again[r.rid] == results[r.rid] for r in reqs)
    print(f"5e(d) a second engine run on the same requests bit-equal, token for token: {same}",
          flush=True)
    assert same, "the second engine run differs"
    gaps = [gap for r in reqs
            for gap in teacher_forced_margins(model, params, cfg, r, results[r.rid], LM_SLOTS)]
    print(f"5e(d) vs each request alone (teacher-forced, {LM_SLOTS}-row decode): worst logit "
          f"margin {max(gaps):.4e} (must be 0), steps off the argmax {sum(g > 0 for g in gaps)} "
          f"of {len(gaps)}", flush=True)
    assert max(gaps) == 0.0, f"xlstm engine vs the 4-row rerun: margin {max(gaps)}"
    batch = {"tokens": reqs[0].prompt[None].cuda()}
    prefill_ms = time_ms(lambda: model.prefill(params, batch), 1)
    print(f"5e(d) {XLSTM_ARCH} prefill {len(reqs[0].prompt)} tokens (the longest prompt run): "
          f"{prefill_ms:.3f} ms (CUDA events, one call after one untimed; the sLSTM blocks a "
          f"Python loop over the tokens) ({name_power})", flush=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(peak=peak, prefill_ms=prefill_ms)


# (e) the recurrent archs' gradients, card against host CPU: the loss within
# TRAIN_RTOL, every gradient leaf within RECURRENT_GRAD_RTOL relative to its
# largest magnitude (TRAIN_RTOL holds the dense family's). Basis
# (tools/recurrent_grad_margin.py --device cuda, NVIDIA H100 80GB HBM3,
# 700.00 W): these gradients are that sensitive. One f32 rounding of every
# parameter moves the host CPU's own leaves by up to 6.3e-5, and the card
# against the host CPU reads up to 1.0e-4 (xlstm; jamba 1.6e-5) over seeds
# 0-4 and two steps. The subtlest planted fault (sLSTM's normaliser clamp
# dropped) reads 0.22. The limit sits 5x above the one, 440x below the other.
RECURRENT_GRAD_RTOL = 5e-4


def recurrent_train(name_power):
    """5e(e): reduced jamba and reduced xlstm-125m (f32) on the card against
    the host CPU over two steps from the same weights: the loss within
    TRAIN_RTOL, every gradient leaf within RECURRENT_GRAD_RTOL. Neither mixer
    has a kernel, so this holds the autograd of the plain ops on the card."""
    from repro_torch import tree
    from repro_torch.configs import reduce_config
    from repro_torch.data import DataConfig, SyntheticTokens, to_device
    from repro_torch.launch import steps

    for arch in (JAMBA_ARCH, XLSTM_ARCH):
        cfg = reduce_config(get_config(arch))
        data = SyntheticTokens(DataConfig(cfg.vocab_size, 64, 4, seed=0))
        kw = dict(lr=TRAIN_LR, warmup=TRAIN_WARMUP, total_steps=100)
        step_cpu, opt, model = steps.make_train_step(cfg, device="cpu", **kw)
        model_gpu = steps.make_train_step(cfg, device="cuda", **kw)[2]
        params = model.init(0)
        state = opt.init(params, device="cpu")
        errs = {}
        sto_step.reset_launches()
        for s in range(2):
            b_cpu, b_gpu = to_device(data.batch(s), "cpu"), to_device(data.batch(s), "cuda")
            loss_gpu, g_gpu = steps.loss_and_grads(
                model_gpu, tree.tree_map(lambda t: t.cuda(), params), b_gpu)
            loss_cpu, g_cpu = steps.loss_and_grads(model, params, b_cpu)
            grads, leaf = _worst(g_gpu, g_cpu)
            errs[s] = (_rel(loss_gpu, loss_cpu), grads, leaf, float(loss_cpu))
            params, state, _ = step_cpu(params, state, b_cpu, torch.tensor(s))
        print(f"5e(e) reduced {cfg.name} (f32), the card vs the host CPU from the same weights, "
              f"two steps (relative; the loss at most {TRAIN_RTOL}, each gradient leaf at most "
              f"{RECURRENT_GRAD_RTOL}): "
              + "; ".join(f"step {s}: loss {a:.3e} (loss {ls:.4f}), worst gradient leaf {g:.3e} "
                          f"({leaf})" for s, (a, g, leaf, ls) in errs.items())
              + f"; launches {dict(sto_step.LAUNCHES)} ({name_power})", flush=True)
        assert all(a <= TRAIN_RTOL and g <= RECURRENT_GRAD_RTOL
                   for a, g, _, _ in errs.values()), errs
        assert not any(sto_step.LAUNCHES.values()), dict(sto_step.LAUNCHES)


def recurrent_phase(name, name_power):
    """Phase 5e: the recurrent mixers. Returns the flash kernel's jamba row
    (H 64, KVH 8, D 128) with the engine run's launches."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    layer = mamba_layer_check(name_power)
    flash = flash_case(name, JAMBA_ARCH, *JAMBA_FLASH_CASE)
    t1 = time.perf_counter()
    served = jamba_serve(name_power)
    t2 = time.perf_counter()
    xlstm_layer_check(name_power)
    xl = xlstm_serve(name_power)
    t3 = time.perf_counter()
    recurrent_train(name_power)
    seconds = time.perf_counter() - t0
    print(f"phase 5e: {seconds:.1f} s ((a) and (b) {t1 - t0:.1f} s, (c) {t2 - t1:.1f} s, of which "
          f"the no-drop run and its witness {served['witness_s']:.1f} s, (d) {t3 - t2:.1f} s, (e) "
          f"{seconds - (t3 - t0):.1f} s); the Mamba layer's prefill {layer['prefill_ms']:.3f} ms "
          f"({max(PROMPTS)} tokens) / {layer['host_prefill_ms']:.3f} ms on the host CPU "
          f"({MAMBA_TOKENS} tokens), decode {layer['decode_ms']:.3f} / "
          f"{layer['host_decode_ms']:.3f} ms; xlstm-125m prefill {xl['prefill_ms']:.3f} ms "
          f"({name_power})", flush=True)
    keys = ("ms", "single_call_ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library",
            "share_of_bound", "max_abs_err", "row_rel_err", "heads", "kv_heads", "head_dim")
    return dict({k: flash[k] for k in keys}, launches=served["launches"])


def recurrent_only():
    """`chip_smoke.py --recurrent`: build the kernels and run phase 5e alone."""
    name_power = card_line()
    print(f"card: {name_power}", flush=True)
    _build.load()
    if _build.BUILD_LOG:
        print(_build.BUILD_LOG.strip(), flush=True)
    flash_config(torch.cuda.get_device_name(0))
    recurrent_phase(torch.cuda.get_device_name(0), name_power)
    print("5e held", flush=True)


WHISPER_ARCH = "whisper-base"
LLAVA_ARCH = "llava-next-mistral-7b"
# (b) whisper-base whole: LM_SLOTS requests of 30 s of audio each (whisper's
# n_audio_ctx, 1500 encoder frames after its conv frontend, which the config
# stubs: frames drawn 0.02 x normal from seed 0), the four start-of-transcript
# ids (<|startoftranscript|> <|en|> <|transcribe|> <|notimestamps|>) and
# WHISPER_NEW greedy tokens, so that prompt and output fill half of whisper's
# 448-token text context
WHISPER_FRAMES = 1500
WHISPER_PROMPT = (50258, 50259, 50359, 50363)
WHISPER_NEW = 220
WHISPER_CAPACITY = len(WHISPER_PROMPT) + WHISPER_NEW
WHISPER_CPU_STEPS = 8  # (b): decode steps held against the host CPU
# (c) llava-next-mistral-7b: LM_SLOTS requests of one 672 x 672 image in
# LLaVA-NeXT's anyres layout (a 576-row base image, then a 2 x 2 grid of 24 x
# 24-row tiles with a newline row after each of its 48 rows: 576 + 2304 + 48
# rows; stub embeddings 0.02 x normal, the embed table's scale) and 64 text
# rows (embed_tokens of seeded ids); LLAVA_NEW new tokens
LLAVA_IMAGE_ROWS = 576 + 4 * 576 + 48
LLAVA_TEXT_ROWS = 64
LLAVA_NEW = 32
LLAVA_PATH_TOKENS = 512  # (c): inputs_embeds vs the token path
LLAVA_LAYER_TOKENS = 128  # (c): one full-width layer on the host CPU in bf16 within seconds
# (a) flash at the shapes (b) and (c) launch it: (label, arch, sq, sk,
# batch, causal). Each request is prefilled alone (B 1); decode runs the
# LM_SLOTS rows in lock-step.
ENCDEC_FLASH_CASES = (
    ("whisper_encoder", WHISPER_ARCH, WHISPER_FRAMES, WHISPER_FRAMES, 1, False),
    ("whisper_self_prefill", WHISPER_ARCH, len(WHISPER_PROMPT), len(WHISPER_PROMPT), 1, True),
    ("whisper_cross_prefill", WHISPER_ARCH, len(WHISPER_PROMPT), WHISPER_FRAMES, 1, False),
    ("whisper_cross_decode", WHISPER_ARCH, 1, WHISPER_FRAMES, LM_SLOTS, False),
    ("llava_prefill", LLAVA_ARCH, LLAVA_IMAGE_ROWS + LLAVA_TEXT_ROWS,
     LLAVA_IMAGE_ROWS + LLAVA_TEXT_ROWS, 1, True),
)
# (b), (c) the card against the host CPU on the same bf16 weights and inputs,
# by phase 4's two measures. A cache leaf (k or v of a layer) is one bf16
# product of a residual stream that every layer before it rounds to bf16,
# each product's f32 sums in another order on each side (an element a bf16
# ulp or two apart, 2^-8 of it each), and on the card the flash kernel's bf16
# probabilities (phase 4's 1e-2 a row): as MLA_Y_RTOL. The logits take the
# whole chain (whisper: 6 encoder and 6 decoder layers, the cross caches and
# the tied head), twice that.
ENCDEC_CACHE_RTOL = 2.0**-5
ENCDEC_LOGIT_RTOL = 2.0**-4


def _serve_lockstep(model, params, cfg, batches, new, capacity, enc_seq=None):
    """The Engine's loop for prefill batches that the Engine does not take
    (it prefills token prompts only): each request prefilled alone, as the
    Engine admits, and spliced (_splice_cache) into slot i of a zeroed cache
    of LM_SLOTS rows, then new - 1 greedy decode steps in lock-step, the
    tokens read to the host every step as the Engine reads them. Returns the
    tokens per request and the host seconds of the prefills and the decode
    steps (each ending in a device-to-host read) and the caches."""
    assert len(batches) == LM_SLOTS
    kw = {} if enc_seq is None else {"enc_seq": enc_seq}
    caches = transformer.tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype, device="cuda"),
                                  model.cache_specs(LM_SLOTS, capacity, **kw))
    toks = torch.zeros((LM_SLOTS, 1), dtype=torch.long, device="cuda")
    t0 = time.perf_counter()
    for i, batch in enumerate(batches):
        last, seq_cache = model.prefill(params, batch)
        _splice_cache(caches, seq_cache, i)
        toks[i, 0] = int(torch.argmax(last[0, -1, : cfg.vocab_size]))
    out = [toks[:, 0].tolist()]
    t1 = time.perf_counter()
    pos = torch.tensor([_prompt_len(b) for b in batches], device="cuda")
    for j in range(new - 1):
        logits, caches = model.decode_step(params, toks, caches, pos + j)
        toks = torch.argmax(logits[:, -1, : cfg.vocab_size], dim=-1)[:, None]
        out.append(toks[:, 0].tolist())
    t2 = time.perf_counter()
    return [[step[i] for step in out] for i in range(LM_SLOTS)], t1 - t0, t2 - t1, caches


@contextlib.contextmanager
def _launches_by_site():
    """Count the flash kernel's launches by the attention call that made them:
    while active, attention.attn_forward and attn_decode (the functions the
    layers call) are wrapped to add the change of LAUNCHES["flash_attention"]
    across each call to the yielded dict, under "encoder" (attn_forward, no
    mask, no kv_x), "self_prefill" (attn_forward, causal), "cross_prefill"
    (attn_forward with kv_x), "self_decode" or "cross_decode"."""
    from repro_torch.models import attention

    sites = dict.fromkeys(("encoder", "self_prefill", "cross_prefill", "self_decode",
                           "cross_decode"), 0)
    fwd, dec = attention.attn_forward, attention.attn_decode

    def counted(fn, site):
        def call(*args, **kw):
            before = sto_step.LAUNCHES["flash_attention"]
            out = fn(*args, **kw)
            sites[site(kw)] += sto_step.LAUNCHES["flash_attention"] - before
            return out
        return call

    attention.attn_forward = counted(fwd, lambda kw: "cross_prefill" if kw.get(
        "kv_x") is not None else "self_prefill" if kw.get("causal", True) else "encoder")
    attention.attn_decode = counted(
        dec, lambda kw: "cross_decode" if kw.get("cross") else "self_decode")
    try:
        yield sites
    finally:
        attention.attn_forward, attention.attn_decode = fwd, dec


def _tree_bytes(tree_):
    from repro_torch import tree

    return sum(t.numel() * t.element_size() for t in tree.leaves(tree_))


def whisper_bounds(cfg, params, name, s, se, rows, pos):
    """whisper-base's bounds (ms, by): one request's prefill (s prompt
    tokens, se frames) by operations (every product and attention pair of
    the encoder and decoder, the head at the last position) or bytes (the
    weights but dec_pos's unused rows, the frames, the caches written), and a
    rows-row decode step at positions `pos` by bytes (the decoder's weights,
    the tied head, the self k / v rows up to each position, the cross
    caches) or operations."""
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.num_heads * cfg.head_dim
    kvd = cfg.num_kv_heads * cfg.head_dim
    proj = 2 * d * hd + 2 * d * kvd  # q, o and k, v
    enc = cfg.encoder_layers * (2 * se * (proj + 2 * d * f) + 4 * hd * se * se)
    cross = 2 * s * 2 * d * hd + 2 * se * 2 * d * kvd + 4 * hd * s * se
    dec = cfg.num_layers * (2 * s * (proj + 2 * d * f) + 4 * hd * fa.band_pairs(s, s, True, 0)
                            + cross)
    flops = enc + dec + 2 * d * cfg.padded_vocab
    weights = _tree_bytes(params) - _tree_bytes(params["dec_pos"])
    caches = 2 * cfg.num_layers * 2 * (s + se) * kvd
    pre = bound_ms(name, flops, 0, weights + 2 * (s * d + se * d) + caches, True)
    dec_weights = _tree_bytes(params["stack"]) + _tree_bytes(params["embed"])
    kv = sum(2 * 2 * (int(q) + 1) * kvd for q in pos) * cfg.num_layers
    cross_kv = 2 * 2 * rows * se * kvd * cfg.num_layers
    step_flops = rows * (cfg.num_layers * 2 * (proj + 2 * d * hd + 2 * d * f)
                         + 2 * d * cfg.padded_vocab)
    return pre, bound_ms(name, step_flops, 0, dec_weights + kv + cross_kv, True)


def llava_bounds(cfg, params, name, s, rows, pos):
    """llava's bounds (ms, by): a prefill of s rows by operations (its
    products, the causal attention pairs, the head at the last position) or
    bytes (every weight once but the unused embed table, the caches written);
    a rows-row decode step by bytes (every weight, the k / v rows up to each
    position) or operations."""
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.num_heads * cfg.head_dim
    kvd = cfg.num_kv_heads * cfg.head_dim
    layer = 2 * d * hd + 2 * d * kvd + 3 * d * f
    flops = cfg.num_layers * (2 * s * layer + 4 * hd * fa.band_pairs(s, s, True, 0))
    flops += 2 * d * cfg.padded_vocab
    weights = _tree_bytes(params) - _tree_bytes(params["embed"])
    pre = bound_ms(name, flops, 0, weights + 2 * s * d + 2 * cfg.num_layers * 2 * s * kvd, True)
    kv = sum(2 * 2 * (int(q) + 1) * kvd for q in pos) * cfg.num_layers
    step_flops = rows * (cfg.num_layers * 2 * layer + 2 * d * cfg.padded_vocab)
    return pre, bound_ms(name, step_flops, 0, _tree_bytes(params) + kv, True)


def _init_full(cfg, tag, name_power):
    """cfg's model on the card, weights from seed 0; prints the init."""
    from repro_torch import tree

    model = build_model(cfg, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree.leaves(params))
    print(f"{tag} {cfg.name}: {n_params} parameters (count_params {counting.count_params(cfg)}), "
          f"bf16, init on the card {time.perf_counter() - t0:.3f} s, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB ({name_power})", flush=True)
    return model, params


def _serve_checks(tag, model, params, cfg, batches, new, capacity, want, enc_seq=None):
    """Serve `batches` (_serve_lockstep) after a short warm-up: every request
    `new` tokens in [0, vocab), exactly `want` flash launches and no STO
    kernel; returns (tokens, prefill s, decode s, launches, peak bytes,
    flash launches by call site)."""
    warm = [{k: (v[:, :64] if k == "inputs_embeds" else v) for k, v in b.items()} for b in batches]
    _serve_lockstep(model, params, cfg, warm, 2, capacity, enc_seq)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sto_step.reset_launches()
    with _launches_by_site() as sites:
        tokens, pre_s, dec_s, _ = _serve_lockstep(model, params, cfg, batches, new, capacity,
                                                  enc_seq)
    torch.cuda.synchronize()
    launches = dict(sto_step.LAUNCHES)
    assert sum(sites.values()) == launches["flash_attention"], (
        f"{tag} flash launches outside the attention calls: {sites} vs {launches}")
    for i, toks in enumerate(tokens):
        assert len(toks) == new and all(0 <= t < cfg.vocab_size for t in toks), (tag, i, toks)
    assert launches["flash_attention"] == want, f"{tag} flash launches {launches} != {want}"
    assert not any(launches[k] for k in STO_KERNELS), f"{tag} STO kernels launched: {launches}"
    return tokens, pre_s, dec_s, launches, torch.cuda.max_memory_allocated(), sites


def _witness(tag, model, params, cfg, batches, tokens, capacity):
    """Each request alone, teacher-forced in the 4-row geometry (phase 5's
    witness): every step's gap must be 0."""
    gaps = [gap for i, b in enumerate(batches) for gap in teacher_forced_margins(
        model, params, cfg, i, tokens[i], LM_SLOTS, inputs=b, capacity=capacity)]
    print(f"{tag} vs each request alone (teacher-forced, {LM_SLOTS}-row decode): worst logit "
          f"margin {max(gaps):.4e} (must be 0), steps off the argmax {sum(g > 0 for g in gaps)} "
          f"of {len(gaps)}", flush=True)
    assert max(gaps) == 0.0, f"{tag}: lock-step run vs the 4-row rerun: margin {max(gaps)}"


def _timed_steps(tag, model, params, cfg, batch, caches, pos, bounds, name_power):
    """One prefill of `batch` and one decode step over `caches` at `pos`,
    timed with CUDA events beside their bounds, each traced once (the
    device's busy share). Returns (prefill ms, decode ms)."""
    prefill_ms = time_ms(lambda: model.prefill(params, batch), 3)
    (pre_b, pre_by), (dec_b, dec_by) = bounds
    print(f"{tag} prefill of one request: {prefill_ms:.3f} ms (CUDA events, median of 3); "
          f"{pre_by} bound {pre_b:.4f} ms ({100 * pre_b / prefill_ms:.1f} %) ({name_power})",
          flush=True)
    trace(f"{tag} prefill", lambda: model.prefill(params, batch), name_power)
    tokens = torch.ones((LM_SLOTS, 1), dtype=torch.long, device="cuda")
    decode_ms = time_ms(lambda: model.decode_step(params, tokens, caches, pos), 5)
    print(f"{tag} decode step, batch {LM_SLOTS}: {decode_ms:.3f} ms (CUDA events, median of 5); "
          f"{dec_by} bound {dec_b:.4f} ms ({100 * dec_b / decode_ms:.1f} %) ({name_power})",
          flush=True)
    trace(f"{tag} decode step batch {LM_SLOTS}",
          lambda: model.decode_step(params, tokens, caches, pos), name_power)
    return prefill_ms, decode_ms


def whisper_vs_host(model, params, cfg, batch, tokens, name_power):
    """5f(b): one request through the whole model on the card and on the
    host CPU (the same bf16 weights and frames): the prefill's last logits,
    every layer's self and cross k / v, then WHISPER_CPU_STEPS decode steps
    teacher-forced on the card's tokens, each step's logits."""
    from repro_torch import tree

    p_host = transformer.tree_map(lambda t: t.cpu(), params)
    m_host = build_model(cfg, device="cpu")
    b_host = {k: v.cpu() for k, v in batch.items()}
    t0 = time.perf_counter()
    last_h, cache_h = m_host.prefill(p_host, b_host)
    host_s = time.perf_counter() - t0
    last_c, cache_c = model.prefill(params, batch)
    out = {"prefill logits": _held("prefill logits", last_c, last_h, ENCDEC_LOGIT_RTOL, "5f(b)")}
    for (path, a), b in zip(tree.leaves_with_path(cache_c), tree.leaves(cache_h)):
        label = "/".join(map(str, path))
        out[label] = _held(label, a, b, ENCDEC_CACHE_RTOL, "5f(b)")
    cache_c = transformer.pad_caches(cfg, cache_c, WHISPER_CAPACITY)
    cache_h = transformer.pad_caches(cfg, cache_h, WHISPER_CAPACITY)
    n, steps = _prompt_len(batch), []
    for j in range(WHISPER_CPU_STEPS):
        tok = torch.tensor([[tokens[j]]])
        pos = torch.tensor([n + j])
        lg_c, cache_c = model.decode_step(params, tok.cuda(), cache_c, pos.cuda())
        lg_h, cache_h = m_host.decode_step(p_host, tok, cache_h, pos)
        steps.append(_held(f"decode step {j} logits", lg_c, lg_h, ENCDEC_LOGIT_RTOL, "5f(b)"))
    worst = max(out.values(), key=lambda r: r["row_rel_err"] / r["rtol"])
    print(f"5f(b) {cfg.name} whole, card vs the host CPU (one request; bf16 weights and frames): "
          f"prefill logits {json.dumps(out['prefill logits'])}; {len(out) - 1} cache leaves, the "
          f"worst by its share of the bound {json.dumps(worst)}; {WHISPER_CPU_STEPS} decode steps' "
          f"logits, worst row error {max(r['row_rel_err'] for r in steps):.3e}, max abs error "
          f"{max(r['max_abs_err'] for r in steps):.3e} (rtol {ENCDEC_LOGIT_RTOL}); the host CPU's "
          f"prefill {host_s:.3f} s ({name_power})", flush=True)
    del p_host, cache_h


def whisper_serve(name_power):
    """5f(b): whisper-base whole at full width, served by _serve_lockstep."""
    cfg = get_config(WHISPER_ARCH)
    clock = [time.perf_counter()]
    model, params = _init_full(cfg, "5f(b)", name_power)
    g = torch.Generator(device="cuda").manual_seed(0)
    frames = (0.02 * torch.randn((LM_SLOTS, WHISPER_FRAMES, cfg.d_model), generator=g,
                                 device="cuda")).to(torch.bfloat16)
    prompt = torch.tensor([WHISPER_PROMPT], device="cuda")
    batches = [{"encoder_frames": frames[i:i + 1], "tokens": prompt} for i in range(LM_SLOTS)]
    per_prefill = cfg.encoder_layers + 2 * cfg.num_layers
    want = per_prefill * LM_SLOTS + cfg.num_layers * (WHISPER_NEW - 1)
    tokens, pre_s, dec_s, launches, peak, sites = _serve_checks(
        "5f(b)", model, params, cfg, batches, WHISPER_NEW, WHISPER_CAPACITY, want, WHISPER_FRAMES)
    want_sites = dict(encoder=cfg.encoder_layers * LM_SLOTS, self_prefill=cfg.num_layers * LM_SLOTS,
                      cross_prefill=cfg.num_layers * LM_SLOTS, self_decode=0,
                      cross_decode=cfg.num_layers * (WHISPER_NEW - 1))
    assert sites == want_sites, f"5f(b) flash launches by call site {sites} != {want_sites}"
    pre_rows = LM_SLOTS * (WHISPER_FRAMES + len(WHISPER_PROMPT))
    dec_tokens = LM_SLOTS * (WHISPER_NEW - 1)
    print(f"5f(b) serve {cfg.name}: {LM_SLOTS} requests of {WHISPER_FRAMES} frames and "
          f"{len(WHISPER_PROMPT)} prompt tokens, {WHISPER_NEW} new tokens each, {LM_SLOTS} slots "
          f"(each prefilled alone and spliced, then lock-step decode); prefill {pre_rows} rows "
          f"(frames and tokens) in {pre_s:.3f} s = {pre_rows / pre_s:.1f} rows/s "
          f"({LM_SLOTS / pre_s:.2f} requests/s); decode {WHISPER_NEW - 1} steps, {dec_tokens} "
          f"tokens in {dec_s:.3f} s = {dec_tokens / dec_s:.1f} tok/s; peak memory "
          f"{peak / 2**30:.3f} GiB; launches {launches} ({per_prefill} a prefill: "
          f"{cfg.encoder_layers} encoder, {cfg.num_layers} self, {cfg.num_layers} cross; "
          f"{cfg.num_layers} a decode step: cross); flash launches by call site {sites} "
          f"({name_power})", flush=True)
    again = _serve_lockstep(model, params, cfg, batches, WHISPER_NEW, WHISPER_CAPACITY,
                            WHISPER_FRAMES)
    print(f"5f(b) a second run on the same requests bit-equal, token for token: "
          f"{again[0] == tokens}", flush=True)
    assert again[0] == tokens, "5f(b): the second run differs"
    caches = again[3]
    clock.append(time.perf_counter())
    _witness("5f(b)", model, params, cfg, batches, tokens, WHISPER_CAPACITY)
    clock.append(time.perf_counter())
    whisper_vs_host(model, params, cfg, batches[0], tokens[0], name_power)
    clock.append(time.perf_counter())
    pos = torch.full((LM_SLOTS,), WHISPER_CAPACITY - 2, device="cuda")
    bounds = whisper_bounds(cfg, params, torch.cuda.get_device_name(0), len(WHISPER_PROMPT),
                            WHISPER_FRAMES, LM_SLOTS, pos.tolist())
    prefill_ms, decode_ms = _timed_steps("5f(b)", model, params, cfg, batches[0], caches, pos,
                                         bounds, name_power)
    clock.append(time.perf_counter())
    del params, caches
    gc.collect()
    torch.cuda.empty_cache()
    parts = dict(zip(("init and both runs", "witness", "host CPU", "timed and traced"),
                     (round(b - a, 1) for a, b in zip(clock, clock[1:]))))
    return dict(launches={f"whisper_{k}": n for k, n in sites.items()}, prefill_ms=prefill_ms,
                decode_ms=decode_ms, parts=parts)


def llava_layer_check(cfg, params, name_power):
    """5f(c): the first decoder layer of llava at full width (bf16) on
    LLAVA_LAYER_TOKENS normalised hidden states, the card against the host
    CPU: the output and its k / v cache."""
    lp = transformer.tree_map(lambda t: t[0], params["stack"][0])
    lp_host = transformer.tree_map(lambda t: t.cpu(), lp)
    spec = cfg.period[0]
    x = _hidden(cfg, torch.Generator(device="cuda").manual_seed(1), "cuda")(1, LLAVA_LAYER_TOKENS)
    pos = torch.arange(LLAVA_LAYER_TOKENS, device="cuda")[None]
    sto_step.reset_launches()
    y, _, cache = transformer._layer_forward(lp, cfg, spec, x, pos, mode="prefill")
    assert sto_step.LAUNCHES["flash_attention"] == 1, dict(sto_step.LAUNCHES)
    t0 = time.perf_counter()
    y_h, _, cache_h = transformer._layer_forward(lp_host, cfg, spec, x.cpu(), pos.cpu(),
                                                 mode="prefill")
    host_s = time.perf_counter() - t0
    out = {"y": _held("layer y", y, y_h, ENCDEC_CACHE_RTOL, "5f(c)")}
    for k in ("k", "v"):
        out[k] = _held(f"layer {k}", cache["self"][k], cache_h["self"][k], ENCDEC_CACHE_RTOL,
                       "5f(c)")
    print(f"5f(c) one {cfg.name} decoder layer at full width, card vs the host CPU over "
          f"{LLAVA_LAYER_TOKENS} tokens (flash_bf16<{cfg.head_dim}> on the card): "
          f"{json.dumps(out)}; the host CPU {host_s:.3f} s ({name_power})", flush=True)


def llava_serve(name_power):
    """5f(c): llava-next-mistral-7b at full width: the inputs_embeds path
    against the token path, its layer against the host CPU, then
    LM_SLOTS requests of image and text rows served by _serve_lockstep."""
    from repro_torch import tree
    from repro_torch.models import layers

    cfg = get_config(LLAVA_ARCH)
    clock = [time.perf_counter()]
    model, params = _init_full(cfg, "5f(c)", name_power)
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, LLAVA_PATH_TOKENS))).cuda()
    by_tokens = model.prefill(params, {"tokens": ids})
    by_embeds = model.prefill(params, {"inputs_embeds": layers.embed_tokens(params["embed"], ids)})
    leaves = list(zip(tree.leaves(list(by_tokens)), tree.leaves(list(by_embeds))))
    same = all(torch.equal(a, b) for a, b in leaves)
    print(f"5f(c) a {LLAVA_PATH_TOKENS}-token prefill from inputs_embeds = embed_tokens(tokens) "
          f"bit-equal to the token prefill (logits and {len(leaves) - 1} cache leaves): {same}",
          flush=True)
    assert same, "5f(c): the inputs_embeds path differs from the token path"
    del by_tokens, by_embeds, leaves
    llava_layer_check(cfg, params, name_power)
    clock.append(time.perf_counter())
    g = torch.Generator(device="cuda").manual_seed(0)
    image = (0.02 * torch.randn((LM_SLOTS, LLAVA_IMAGE_ROWS, cfg.d_model), generator=g,
                                device="cuda")).to(torch.bfloat16)
    text = torch.from_numpy(rng.integers(0, cfg.vocab_size, (LM_SLOTS, LLAVA_TEXT_ROWS))).cuda()
    embeds = torch.cat([image, layers.embed_tokens(params["embed"], text)], dim=1)
    batches = [{"inputs_embeds": embeds[i:i + 1]} for i in range(LM_SLOTS)]
    rows = LLAVA_IMAGE_ROWS + LLAVA_TEXT_ROWS
    capacity = rows + LLAVA_NEW
    want = cfg.num_layers * LM_SLOTS
    tokens, pre_s, dec_s, launches, peak, sites = _serve_checks(
        "5f(c)", model, params, cfg, batches, LLAVA_NEW, capacity, want)
    want_sites = dict.fromkeys(sites, 0)
    want_sites["self_prefill"] = want
    assert sites == want_sites, f"5f(c) flash launches by call site {sites} != {want_sites}"
    dec_tokens = LM_SLOTS * (LLAVA_NEW - 1)
    print(f"5f(c) serve {cfg.name}: {LM_SLOTS} requests of {LLAVA_IMAGE_ROWS} image rows (anyres "
          f"672 x 672) and {LLAVA_TEXT_ROWS} text rows, {LLAVA_NEW} new tokens each, {LM_SLOTS} "
          f"slots; prefill {LM_SLOTS * rows} rows in {pre_s:.3f} s = "
          f"{LM_SLOTS * rows / pre_s:.1f} rows/s; decode {LLAVA_NEW - 1} steps, {dec_tokens} "
          f"tokens in {dec_s:.3f} s = {dec_tokens / dec_s:.1f} tok/s; peak memory "
          f"{peak / 2**30:.3f} GiB; launches {launches} ({cfg.num_layers} a prefill; decode "
          f"attends through the einsum path); flash launches by call site {sites} "
          f"({name_power})", flush=True)
    clock.append(time.perf_counter())
    _witness("5f(c)", model, params, cfg, batches, tokens, capacity)
    clock.append(time.perf_counter())
    caches = transformer.tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype, device="cuda"),
                                  model.cache_specs(LM_SLOTS, capacity))
    pos = torch.full((LM_SLOTS,), capacity - 2, device="cuda")
    bounds = llava_bounds(cfg, params, torch.cuda.get_device_name(0), rows, LM_SLOTS,
                          pos.tolist())
    prefill_ms, decode_ms = _timed_steps("5f(c)", model, params, cfg, batches[0], caches, pos,
                                         bounds, name_power)
    clock.append(time.perf_counter())
    del params, caches, embeds, batches
    gc.collect()
    torch.cuda.empty_cache()
    parts = dict(zip(("init, path and layer checks", "serve", "witness", "timed and traced"),
                     (round(b - a, 1) for a, b in zip(clock, clock[1:]))))
    return dict(launches=sites["self_prefill"], prefill_ms=prefill_ms, decode_ms=decode_ms,
                parts=parts)


def encdec_train(name_power):
    """5f(d): reduced whisper (remat on: the encoder's gradient through the
    checkpointed period's cross-attention) and reduced llava (inputs_embeds),
    head dim 64 (one the flash kernel takes), f32: the loss and every
    gradient leaf on the card against the host CPU's within TRAIN_RTOL (a k
    bias, whose gradient is 0 in exact arithmetic, against the tree's
    largest magnitude), no flash launch under grad."""
    import dataclasses

    from repro_torch import tree
    from repro_torch.configs import reduce_config
    from repro_torch.launch import steps
    from repro_torch.models import layers

    for arch in (WHISPER_ARCH, LLAVA_ARCH):
        cfg = dataclasses.replace(reduce_config(get_config(arch)), head_dim=64, remat=True)
        model, model_gpu = build_model(cfg, device="cpu"), build_model(cfg, device="cuda")
        params = model.init(0)
        g = torch.Generator().manual_seed(2)
        tokens = torch.randint(0, cfg.vocab_size, (4, 64), generator=g)
        batch = {"labels": torch.randint(0, cfg.vocab_size, (4, 64), generator=g)}
        if cfg.encoder_layers:
            batch.update(encoder_frames=0.02 * torch.randn(4, 96, cfg.d_model, generator=g),
                         tokens=tokens)
        else:
            batch["inputs_embeds"] = layers.embed_tokens(params["embed"], tokens)
        sto_step.reset_launches()
        loss_gpu, g_gpu = steps.loss_and_grads(
            model_gpu, tree.tree_map(lambda t: t.cuda(), params),
            {k: v.cuda() for k, v in batch.items()})
        launches = dict(sto_step.LAUNCHES)
        loss_cpu, g_cpu = steps.loss_and_grads(model, params, batch)
        scale = max(float(b.abs().max()) for b in tree.leaves(g_cpu))
        worst, leaf = 0.0, None
        for (path, b), a in zip(tree.leaves_with_path(g_cpu), tree.leaves(g_gpu)):
            den = scale if path[-2:] == ("wk", "bias") else max(float(b.abs().max()), 1e-30)
            rel = float((a.cpu().double() - b.double()).abs().max()) / den
            if rel > worst:
                worst, leaf = rel, tree.path_str(path)
        loss_rel = _rel(loss_gpu, loss_cpu)
        print(f"5f(d) reduced {cfg.name} (f32, head dim 64, remat), the card vs the host CPU "
              f"from the same weights (relative, each at most {TRAIN_RTOL}): loss {loss_rel:.3e} "
              f"(loss {float(loss_cpu):.4f}), worst gradient leaf {worst:.3e} ({leaf}); launches "
              f"{launches} ({name_power})", flush=True)
        assert loss_rel <= TRAIN_RTOL and worst <= TRAIN_RTOL, (cfg.name, loss_rel, worst, leaf)
        assert not any(launches.values()), launches


def encdec_phase(name, name_power):
    """Phase 5f: whisper's encoder and cross-attention, and embedding input.
    Returns the flash kernel's rows at this slice's shapes, with the
    launches of the serving runs."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    flash = {label: flash_case(name, arch, sq, sk, torch.bfloat16, 0, batch=b, causal=causal)
             for label, arch, sq, sk, b, causal in ENCDEC_FLASH_CASES}
    t1 = time.perf_counter()
    wh = whisper_serve(name_power)
    t2 = time.perf_counter()
    ll = llava_serve(name_power)
    t3 = time.perf_counter()
    encdec_train(name_power)
    seconds = time.perf_counter() - t0
    print(f"phase 5f: {seconds:.1f} s ((a) {t1 - t0:.1f} s, (b) {t2 - t1:.1f} s "
          f"{json.dumps(wh['parts'])}, (c) {t3 - t2:.1f} s {json.dumps(ll['parts'])}, (d) "
          f"{seconds - (t3 - t0):.1f} s); whisper-base prefill "
          f"{wh['prefill_ms']:.3f} ms, decode step {wh['decode_ms']:.3f} ms; llava prefill "
          f"{ll['prefill_ms']:.3f} ms, decode step {ll['decode_ms']:.3f} ms ({name_power})",
          flush=True)
    keys = ("ms", "single_call_ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library",
            "share_of_bound", "max_abs_err", "row_rel_err", "batch", "heads", "kv_heads",
            "head_dim", "sq", "sk", "causal")
    out = {label: {k: case[k] for k in keys} for label, case in flash.items()}
    for label in out:
        out[label]["launches"] = ll["launches"] if label.startswith("llava") else wh[
            "launches"][label]
    return out


def encdec_only():
    """`chip_smoke.py --encdec`: build the kernels and run phase 5f alone."""
    name_power = card_line()
    print(f"card: {name_power}", flush=True)
    _build.load()
    if _build.BUILD_LOG:
        print(_build.BUILD_LOG.strip(), flush=True)
    flash_config(torch.cuda.get_device_name(0))
    encdec_phase(torch.cuda.get_device_name(0), name_power)
    print("5f held", flush=True)


def main():
    name_power = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"card: {name_power}", flush=True)

    t0 = time.perf_counter()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.3f} s ({_build.BUILD_DIR})", flush=True)
    if _build.BUILD_LOG:
        print(_build.BUILD_LOG.strip(), flush=True)

    t0 = time.perf_counter()
    rows = check_kernels(name)
    print(f"phase 2: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()

    spec = make_spec(N, n_in=1, seed=0, hold_steps=HOLD, device="cuda")
    impl_kernel = {"chunk": "rk4_chunk", "fused": "rk4_fused", "tiled": "field_tiled"}
    served = {}
    for backend, kern in impl_kernel.items():
        results, seconds, launches, sessions = serve(spec, backend)
        assert launches[kern] > 0, f"backend {backend} never launched {kern}: {launches}"
        assert launches["round_bf16"] == 0, f"f32 W rounded to bf16: {launches}"
        rows[kern]["launches"] = launches[kern]
        served[backend] = results
        print(
            f"serve backend={backend}: {SESSIONS} sessions in {seconds:.3f} s = "
            f"{SESSIONS / seconds:.1f} sessions/s, launches {launches} ({name_power})",
            flush=True,
        )
    # the tiled engine with a bf16 coupling: field_tiled and round_bf16
    _, seconds, launches, _ = serve(spec, "tiled", precision="bf16_coupling")
    assert launches["field_tiled"] > 0 and launches["round_bf16"] > 0, launches
    # a hold window rounds m^x once: its later steps take stage 4's bf16 plane
    assert launches["field_tiled"] == 4 * HOLD * launches["round_bf16"], launches
    rows["round_bf16"]["launches"] = launches["round_bf16"]
    rows["field_tiled"]["bf16_w"]["launches"] = launches["field_tiled"]
    print(
        f"serve backend=tiled precision=bf16_coupling: {SESSIONS} sessions in {seconds:.3f} s = "
        f"{SESSIONS / seconds:.1f} sessions/s, launches {launches} ({name_power})",
        flush=True,
    )

    print(f"phase 3 serving: {time.perf_counter() - t0:.1f} s", flush=True)
    # phase 3's host trace: where a chunk's time outside the kernel goes
    t0 = time.perf_counter()
    for backend in ("chunk", "tiled"):
        trace_engine(spec, backend, name_power)
    print(f"phase 3 host trace: {time.perf_counter() - t0:.1f} s", flush=True)

    # the chunk and tiled runs against the plain versions of the same engine
    t0 = time.perf_counter()
    for backend in ("chunk", "tiled"):
        ref, seconds, launches, sessions = serve(spec, backend, interpret=True)
        assert not any(launches.values()), f"interpret run launched kernels: {launches}"
        worst_state = worst_out = 0.0
        for sess in sessions:
            a, b = served[backend][sess.sid], ref[sess.sid]
            ds = np.abs(a.states - b.states).max()
            dm = np.abs(a.final_m - b.final_m).max()
            do = np.abs(a.outputs - b.outputs).max()
            # outputs: |dy| <= ||w_out||_1 * max|dx|
            out_tol = STATE_ATOL * np.abs(sess.readout.w_out.numpy()).sum()
            assert max(ds, dm) <= STATE_ATOL, (
                f"session {sess.sid}: {backend} vs plain state {ds}, {dm}"
            )
            assert do <= out_tol, f"session {sess.sid}: {backend} vs plain output {do} > {out_tol}"
            worst_state, worst_out = max(worst_state, ds, dm), max(worst_out, do)
        print(
            f"serve {backend} vs interpret (plain versions): max |state| diff {worst_state:.3e} "
            f"(atol {STATE_ATOL}), max |output| diff {worst_out:.3e}; plain run "
            f"{SESSIONS / seconds:.1f} sessions/s",
            flush=True,
        )
    print(f"phase 3 interpret runs: {time.perf_counter() - t0:.1f} s", flush=True)
    print(
        f"impl='auto' at N={N}, E={E}: f32 W -> {ops.choose_impl(N, E, platform='cuda')}, "
        f"bf16 W -> {ops.choose_impl(N, E, platform='cuda', precision='bf16_coupling')} "
        f"(fused_fits_l2: {ops.fused_fits_l2(ops._round_up(N, ops.BLOCK_N), E)})",
        flush=True,
    )
    t0 = time.perf_counter()
    learning_phase(spec, name_power)
    ladder(spec, name_power)
    print(f"phases 3b-3c: {time.perf_counter() - t0:.1f} s", flush=True)
    fixed = lifecycle_phase(spec, name_power)
    plan_cache_phase(spec, fixed, name_power)
    rows["tm_delay_line"] = families_phase(served, name, name_power)
    del served
    tune_phase(spec, name_power)
    fleet_phase(spec, name_power)
    sharded_phase(name_power)

    t0 = time.perf_counter()
    rows["flash_attention"] = check_flash(name)
    print(f"phase 4: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    rows["flash_attention"]["launches"] = serve_lm(name_power)
    print(f"phase 5: {time.perf_counter() - t0:.1f} s", flush=True)
    rows["flash_attention"]["qwen2_moe"] = moe_phase(name, name_power)
    rows["flash_attention"]["deepseek_v2_lite"] = mla_phase(name, name_power)
    rows["flash_attention"]["jamba"] = recurrent_phase(name, name_power)
    rows["flash_attention"]["encdec"] = encdec_phase(name, name_power)
    train_phase(name_power)

    kernels = [
        dict(name=k, route="cuda", source=SOURCE[k], replaces=REPLACES[k], **rows[k])
        for k in (*STO_KERNELS, "tm_delay_line", "flash_attention")
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(name_power, flush=True)
    device = {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cache-child"]:
        cache_child(sys.argv[2])
    elif sys.argv[1:2] == ["--delay-line"]:
        delay_line_only()
    elif sys.argv[1:2] == ["--tune"]:
        tune_only()
    elif sys.argv[1:2] == ["--fleet"]:
        fleet_only()
    elif sys.argv[1:2] == ["--sharded"]:
        sharded_only()
    elif sys.argv[1:2] == ["--sharded-child"]:
        sharded_child()
    elif sys.argv[1:2] == ["--train"]:
        train_only()
    elif sys.argv[1:2] == ["--moe"]:
        moe_only()
    elif sys.argv[1:2] == ["--mla"]:
        mla_only()
    elif sys.argv[1:2] == ["--recurrent"]:
        recurrent_only()
    elif sys.argv[1:2] == ["--encdec"]:
        encdec_only()
    elif sys.argv[1:2] == ["--train-child"]:
        train_child()
    elif sys.argv[1:2] == ["--dryrun"]:
        dryrun_only()
    elif sys.argv[1:2] == ["--dryrun-child"]:
        dryrun_child()
    elif sys.argv[1:2] == ["--tp"]:
        tp_only()
    elif sys.argv[1:2] == ["--tp-child"]:
        tp_child(sys.argv[2])
    elif sys.argv[1:2] == ["--tp-mixers-child"]:
        tp_mixers_child(sys.argv[2])
    else:
        main()
