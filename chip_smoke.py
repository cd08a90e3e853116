#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / CUDA port.

    python3 chip_smoke.py

    python3 chip_smoke.py --only paged,ragged    # a subset of the groups

Needs one CUDA card and the CUDA toolkit (``nvcc``); builds every kernel
under ``neuronx_distributed_inference_tpu_torch/csrc/`` from source (one
nvcc per source, all started together), then:

  1. environment: the card's name and power limit (nvidia-smi), torch and
     CUDA versions, whether ``torch.bmm`` takes ``out_dtype`` (the bf16
     attention cores' fp32-output product), whether ``torch._grouped_mm``
     (the MoE block's ragged product) runs in bf16 and in fp32, kernel
     build seconds;
  2. each kernel against its plain-PyTorch twin on the card, over the case
     matrix of the TPU kernel's tests, at the serving paths' shapes: the
     paged decode kernel, the contiguous decode kernel and the flash
     prefill kernel; then each decode kernel's fused merge: 23 calls,
     eager and under CUDA-graph replay, give one output bit for bit, the
     merge counters end at 0, and every split count 1-64 agrees with the
     twin;
  3. the paged path, bf16, Llama-3.2-1B geometry at full depth with random
     weights from seed 0, after ``serving.warmup.precompile`` captured its
     T = 1 step into a CUDA graph: ``PagedCausalLMApplication.generate`` of
     64 new tokens for 4 prompts; no steady-state incident; the paged
     kernel's launches (eager launches plus graph replays x the launches
     each graph holds) must equal layers x decode steps, and every decode
     step's logits must agree with the
     same app and weights built with ``attn_block_tkg_kernel_enabled=False``
     (the gather path) fed the same tokens;
  4. paged serving, fp32 (TF32 off inside the phase), same geometry: 6
     requests with
     staggered admission through ``PagedEngineAdapter``; each stream must
     equal that prompt's single-request ``generate`` (a first difference is
     accepted only at a near-tie of the reference's top-2 logits, and
     printed);
  5. paged timings: kernel, plain twin and the SDPA yardstick as device
     time (CUDA-graph replay between CUDA events), prefill and decode steps
     on the host clock of a precompiled app (decode replays its graph), and
     a torch.profiler trace of the decode steps (device time by kernel,
     device idle share);
  6. the contiguous path (the README's entry point), bf16, Mistral-7B-v0.1
     geometry at full width cut to 8 of its 32 layers with random
     weights from seed 0:
     ``CausalLMApplication.generate`` of 64 new tokens for 4 prompts with
     ``attn_kernel_enabled=True``, after ``precompile`` (decode replays a
     graph); the flash kernel's launches must equal layers x prefill calls
     and the contiguous decode kernel's (replays counted) layers x decode
     steps, and the prefill and every decode step's logits must agree with
     the same app and weights built with both kernels off, fed the same
     tokens (both bf16 apps held to an fp32 app, TF32 off for it); then its
     timings as in 5, the decode step timed with the decode kernel on and
     off (the port's default for window-less models);
  7. the window bites: full width, 4 layers, ``sliding_window=512``, the
     same prompts and checks as 6;
  8. contiguous serving, fp32 (TF32 off inside the phase), full width, 8
     layers: 6 requests
     with staggered admission through ``ContinuousBatchingAdapter``
     (decode on the gather path), each stream held to the single-request
     static ``generate`` (decode on the kernel) as in 4;
  9. ragged serving, bf16, Llama-3.1-8B geometry at full width and depth
     with random weights from seed 0:
     ``ServingEngine(PagedEngineAdapter(app, ragged=True,
     prefill_chunk_tokens=512))`` over a paged app (batch 8, seq_len 4096,
     block 32, prefix caching) serves 8 requests (37-1900 prompt tokens,
     48 new tokens each), four submitted at once and one more every 4
     passes, so mixed passes (decode rows plus prefill chunks) and
     all-decode passes both occur. Gates: every pass makes at most one
     ragged dispatch and one blocking fetch and no standalone prefill
     dispatch; the paged kernel's launches equal 32 x the all-decode
     ragged steps (head_dim 128); every stream holds 48 in-vocab tokens
     and finished on length. Prints the passes by kind, host ms per pass
     of each kind, time to first token, the pad waste, a torch.profiler
     trace of 8 all-decode and 4 mixed passes (device ms by kernel, device
     idle share), and the paged kernel at the served cache's shapes;
 10. ragged serving, fp32 (TF32 off), Llama-3.1-8B width, 4 layers: the
     same submissions with 24 new tokens through the ragged engine, the
     two-phase (non-ragged) engine and single-request ``generate`` on the
     same weights; the ragged streams must equal both (a first difference
     only at a near-tie of the reference's top-2 logits, printed), and the
     launch gate of 9 holds (fp32 pages: the kernel's CUDA-core route);
 11. the front door: phase 9's prompts as concurrent SSE requests through
     ``ServingFrontend``, held to an in-process replay;
 12. speculative and seeded sampled serving, bf16, Llama-3.1-8B at full
     width and depth, phase 9's geometry, prompts and schedule: (a) greedy
     ``SelfDraftProposer(3)`` on the ragged path over phase 9's app; (b) a
     fresh app with seeded sampling (top_k 50, top_p 0.9, temperature
     0.7, stream_seed 1234) served without speculation, with
     ``SelfDraftProposer(3)`` on the ragged path and on the two-phase
     path. Gates: at most one ragged dispatch, one verify dispatch and one
     blocking fetch a pass; the paged kernel's launches equal 32 x the
     T = 1 steps (the draft loop's steps and every width-1 pass, replays
     counted); ``precompile`` captured the coupled T = 1 step and the
     draft loop, and no steady-state incident; the sampled run without
     speculation replays a graph on every all-decode pass; every stream
     holds 48 in-vocab tokens and finished on length; a stream with
     speculation may first part from its twin without speculation (served
     on the same prefix-warm cache) only at a near-tie: two tokens, or two
     neighbours in the candidate order the coupled draw hangs its noise
     on, within twice the card's logit spread between two paths at that
     position (``check_twins``, printed).
     Prints the accept rate, tokens per row per pass, host ms per pass,
     TTFT, a torch.profiler trace of 4 speculative passes (device ms by
     kernel, idle share) with the coupled sampler's device time, and the
     paged kernel at the served cache's shapes;
 13. fp32 identity (TF32 off), Llama-3.1-8B width, 4 layers: phase 10's
     submissions (24 new tokens), greedy and seeded sampled, each served
     eagerly on the two-phase path without speculation (the reference),
     two-phase with ``SelfDraftProposer(3)``, ragged with it, ragged with
     ``PerturbedSelfDraftProposer(3, corrupt_at=1)`` and ragged with
     ``set_speculation_shed`` toggled mid-run: every stream equals the
     reference (a first difference only at a near-tie, printed); the
     perturbed proposer accepts exactly 1 draft per row of every
     full-width step; shed passes make no draft dispatch.

 14. the MoE group, Qwen3-30B-A3B (48 layers, hidden 2048, 32 q / 4 kv
     heads: GQA group 8, head_dim 128, 128 experts of which 8 per token,
     expert width 768, vocab 151936) with random weights from seed 0:
     (a) the three kernels at that geometry against their twins (the
     paged kernel at batch 8 over bf16 and fp32 pages, the contiguous
     decode kernel at batch 4 over S 4096, flash at batch 4, S 2048), each
     timed beside its twin, SDPA and its bound; (b) ``moe_block`` at full
     width on 64 tokens (dense path, and ragged forced) and 4096 tokens
     (ragged), fp32 (TF32 off) and bf16, held to a straightforward fp32
     loop over each token's selected experts with its own routing, dense
     and ragged held to each other, and the device time of each path;
     (c) phase 9's engine, schedule and prompts at full width, 12 of the
     48 layers (built only once earlier groups
     freed the card) with phase 9's gates (one dispatch and one fetch a
     pass, paged launches = 12 x all-decode steps, no incident, full
     streams) and the
     MoE blocks' share of the traced passes; (d) phase 10 at 4 layers
     (fp32, TF32 off: ragged == graphs == two-phase == ``generate``) and
     the bf16 4-layer app's prefill and decode logits against the fp32
     app; (e) ``TpuQwen3MoeForCausalLM`` at full depth with
     ``attn_kernel_enabled=True`` after ``precompile`` (64 new tokens, 4
     prompts): flash launches = 48 x 1 prefill, contiguous-decode
     launches = 48 x 63 steps, logits against the kernels-off app; then
     phase 6's checks (against an fp32 app) at a 4-layer cut. Each part
     prints its peak device memory.
 15. the GPT-OSS group, gpt-oss-20b (24 layers alternating sliding,
     window 128, and full attention; hidden 2880, 64 q / 8 kv heads of
     head_dim 64: GQA group 8; learned sinks, q/k/v and o biases, YaRN
     RoPE; 32 experts of width 2880, 4 per token, clamped swiglu with
     biases; vocab 201088) with random weights from seed 0, the sinks
     N(0, 1) and every bias N(0, 0.02) from the seed too: (a) the paged
     kernel at its heads (batch 8, phase 9's lens) with a sink at window
     128 and window 0, over bf16 and fp32 pages, against its twin, timed
     beside the twin, SDPA over the pre-gathered window with the sink as
     one extra zero key whose additive mask is its logit, and the bound
     of the keys inside each row's window; (b) phase 9's engine, schedule
     and prompts at full width and depth (42 GB of bf16 weights) with
     phase 9's gates (one dispatch and one fetch a pass, paged launches
     = 24 x all-decode steps, every local layer's launch at window 128
     and every global one's at 0, both with the layer's sink; no
     incident, full streams), the MoE blocks' share and the kernel over
     the served cache at a local and a global layer; (c) at an 8-layer
     cut, the kernel app and the gather app
     (``attn_block_tkg_kernel_enabled=False``), both bf16, held to an
     fp32 app (TF32 off) over phase 10's decode steps; (d) phase 10 at 4
     layers (fp32: ragged == graphs == two-phase == ``generate``).
 16. the long-context group (the mixed and rolling caches, windowed
     context encoding), random weights from seed 0: (a) the contiguous
     decode kernel over gpt-oss-20b's global stack (12 layers, B 4, S
     32768, Hq 64 over Hkv 8, D 64, a sink, window 0, lens 300-2100) and
     the flash kernel at Mistral-7B-v0.1's heads at window 4096 over S
     8192, B 2, each against its twin, timed beside the twin, SDPA and its
     bound; (b) gpt-oss-20b through ``TpuGptOssForCausalLM`` (the
     contiguous app) at full width cut to LONG_OSS_LAYERS (4) layers,
     ``seq_len`` 32768, so the
     mixed per-layer cache (global rows of 32768 slots, local rows rolling
     at 128), batch 4, prompts of 200-2000 tokens, 128 new tokens, after
     ``precompile``: decode-kernel launches = 6 x decode steps, each at a
     global layer's stack index with window 0 and its sink, no incident;
     prefill and decode step times, peak memory, the cache's bytes beside
     the uniform cache's, the stream agreement with the uniform cache (a
     count); (c) (b)'s weights behind ``ContinuousBatchingAdapter`` (phase
     9's 8 requests over batch 4 through the adapter's own add / step /
     release loop; ``ServingEngine`` takes the paged adapter surface
     only): decode-kernel launches = global layers x the passes that
     hold all four rows (identity rows; other passes gather), full
     streams, TTFT,
     the agreement with each request's ``generate`` (a count), and each
     stream held to (b)'s weights on a static app fed its tokens (the
     logit-deficit gate of 19 (b)); (d)
     Mistral-7B-v0.1 at full width cut to 8 layers with
     the rolling cache (``seq_len`` 16384, 4096 slots), batch 2, prompts
     of 5000 and 6000 tokens, 64 new: flash launches = 8 x 1 prefill at
     window 4096, no
     decode-kernel launch (the gather path over the rolling slots), step
     times, cache bytes beside the full cache's, agreement with
     ``rolling_kv_cache=False`` (a count); (e) windowed context encoding
     (``windowed_context_encoding=2048``, full rows): one 12000-token
     prompt in 6 windows, 32 new tokens, prefill time, peak memory and
     window count, agreement with the one-shot prefill on a 4000-token
     cut (a count); (f) fp32 4-layer cuts (TF32 off), each pair equal
     token for token (a first difference only at a near-tie): mixed
     against uniform cache, continuous batching against ``generate``,
     rolling against full rows, windowed against one-shot.
 17. the MLA group, Moonlight-16B-A3B (DeepSeek-V3 architecture: 27
     layers, the first dense, 26 MoE of 64 experts of width 1408, 6 per
     token, 2 shared; hidden 2048, 16 heads of multi-head latent
     attention, K heads 128 + 64 (rope) wide, V heads 128, latent 512;
     vocab 163840) with random weights from seed 0 (router biases N(0,
     0.02)): (a) one full-width layer (the dense one), fp32, prefill and 8
     decode steps held to a plain fp32 MLA written from the published
     equations in HF's rope convention, with a control (the rope head
     unrotated) that must part; (b) ``TpuDeepseekForCausalLM`` at full
     width cut to 4 layers (the dense one and 3 MoE),
     bf16, batch 4, ``seq_len`` 4096, phase 3's prompts, 64 new tokens,
     ``attn_kernel_enabled=True``, after ``precompile``: both kernel gates
     refuse MLA and none of the three kernels launches, no incident,
     cache K (14, 4, 16, 192, 4096) and V (14, 4, 16, 4096, 128); weight
     and cache bytes, peak memory, prefill and decode times,
     the decode steps' device profile and a breakdown by part; (c) (b)'s
     weights behind ``ContinuousBatchingAdapter`` with phase 9's 8
     requests over batch 4: host ms per pass, admission and TTFT, the
     streams; (d) fp32 (TF32 off) at 4 layers (1 dense + 3 MoE): graphs ==
     eager == the chunked side-buffer loop == the adapter's streams
     against ``generate``, token for token; and the bf16 8-layer cut held
     to the fp32 cut by the relative RMS of teacher-forced decode logits,
     with a control (the rope pairing flipped) that must part.
 18. the quantization group (quantized and low-rank weights), random weights
     from seed 0: (a) one gpt-oss-20b expert stack (MXFP4) and one Llama-3.1-8B
     MLP layer (int8 per-channel, fp8 blockwise) quantized on the card and on
     the CPU by the same function (codes and scales equal), then
     ``dequantize``, ``qlinear``, ``qmatmul`` and ``qeinsum`` on the card held
     to the fp64 product of the dequantized weight (TF32 off), each with a
     control that applies the scales along the wrong axis; (b) gpt-oss-20b with
     in-graph MXFP4 experts at full width cut to 4 layers on
     phase 15's engine (its gates; paged launches = 4 x all-decode steps;
     weight bytes equal to the geometry's; the MoE blocks' share); (c)
     Llama-3.1-8B cut to 16 layers with int8 per-channel weights and the
     scaled fp8 KV cache on phase 9's engine (its gates, paged launches = 16
     x all-decode steps over
     fp8 pages, the largest stored value under e4m3's 448, the kernel held to
     its twin over the served fp8 pages and timed); (d) in bf16 (gpt-oss at
     (b)'s cut, Llama at (c)'s) the teacher-forced logits of each
     quantized model against the unquantized one on the same draws (a reading,
     with the flipped-scale control), then fp32 4-layer cuts (MXFP4 gpt-oss,
     int8 + fp8 cache Llama, fp8-blockwise Llama) where the ragged engine,
     ``generate`` on graphs, ``generate`` eager and an unquantized app holding
     the dequantized weights give the same streams, its logits within
     TOL_QUANT_TWIN_REL and the control beyond TOL_QUANT_CONTROL_REL; (e)
     Llama-3.2-1B with ``mlp_low_rank`` 512 and int8 factors at full width cut
     to 4 layers on the paged app (``generate`` after
     ``precompile``, paged launches = 4 x 63, MLP bytes against
     ``compression_report``), and at a 4-layer fp32 cut full rank against the
     dense app (streams equal, logits within TOL_LOW_RANK_FULL_REL, the
     half-rank control parting).
 19. the dense group (Gemma-2, Gemma-3, Phi-4, Granite, OLMo-2, Qwen2),
     random weights from seed 0: (a) the paged kernel at Gemma-2-27B's
     heads (32 q / 16 kv of 128: GQA group 2), B 4, lens 300-7000, with
     soft-cap 50 at window 4096 and 0, and the contiguous kernel over a
     Gemma-2 mixed cache's global stack (S 8192, soft-cap 50), bf16, q
     and keys drawn so most scores exceed the cap (the share is gated):
     each against its twin, the kernel without its cap parting from the
     capped twin, then timed beside the twin, SDPA without the cap and
     the bytes bound; (b) Gemma-2-27B at full width cut to 8 of its 46
     layers (its bf16 weights gated equal to the geometry's)
     on phase 9's engine
     at batch 4, ``seq_len`` 8192, six requests of 37-6000 tokens (two
     past the 4096 window), 48 new tokens: phase 9's gates (one dispatch
     and one fetch a pass, paged launches = 8 x all-decode steps, no
     incident, full streams), every local layer's launch at window 4096
     and every global one's at 0, all at soft-cap 50, and every served
     stream held to ``generate`` fed its tokens (each served token within
     TOL_SERVED_DEFICIT_BF16 logit stds of the top logit, and within
     TOL_SERVED_MEAN_DEFICIT_BF16 on average); (c) the same at
     Gemma-3-27B's width cut to 6 layers (one 6-layer pattern: window
     1024, the dual rope, the (1 + w) q/k norms, no cap), prompts past
     1024; (d) fp32 (TF32 off) 4-layer cuts of all six geometries: the
     paged kernel path against the gather path on the same weights and
     tokens (logits within TOL_DENSE_PATHS_FP32_REL, argmax equal), the
     ragged engine's streams equal ``generate``'s, then
     ``TpuGemma2ForCausalLM`` at ``seq_len`` 8192 on a 5000-token prompt
     (the mixed per-layer cache): contiguous-kernel launches = global
     layers x decode steps at window 0 and soft-cap 50, the stream equal
     to the uniform cache's.
 20. the MoE-families group (Llama4 text, DBRX), random weights from seed
     0: (a) the paged and the contiguous decode kernels at DBRX's heads
     (48 q over 8 kv of 128: GQA group 6, run on the 8-wide
     instantiation), B 4, lens 300-7000, over bf16 and scaled fp8 pages /
     caches, and flash at those heads (B 2, S 2048): each against its
     twin, then timed beside the twin, SDPA and the bound; (b)
     Llama-4-Scout's text widths (hidden 5120, 40 q / 8 kv heads of 128,
     16 experts of 8192, top 1, a shared expert, vocab 202048, llama3
     rope, chunk 8192, every 4th layer NoPE, the q/k norm, the
     temperature) cut to 4 layers (its bf16 weights gated equal to the
     geometry's) on phase 9's engine at batch 4, ``seq_len``
     16384, six requests of 37-9000 tokens (one past the 8192 chunk, one
     whose decode crosses it), 48 new tokens: phase 9's gates with the
     paged kernel launched 0 times (the chunk gates, latent fault 1) and
     the streams held to ``generate`` as in 19 (b); (c) Scout's widths at
     Maverick's interleave (layers 1 and 3 MoE), 4 layers, fp32, the
     attention chunk cut to 64: the ragged engine's streams equal the
     contiguous ``generate``'s, the paged logits within
     TOL_MOE_FAMILIES_PATHS_FP32_REL, no kernel launch; (d) DBRX
     (databricks/dbrx-instruct: d_model 6144, 16 experts of 10752, top
     4, ``clip_qkv`` 8, LayerNorm, vocab 100352) cut to 4 layers on
     phase 9's engine at batch 4, ``seq_len`` 8192: phase 9's
     gates, every layer's paged launch at window 0 and G 6, the kernel
     held to its twin over the served cache, the streams held to
     ``generate``; (e) DBRX at 2 layers, fp32, ``W_qkv`` drawn so the
     clip bites (the share gated): ``TpuDbrxForCausalLM`` (flash and the
     contiguous kernel at G 6, launches counted) against the ragged
     engine's streams and the paged logits, and a control without the
     clip that must part.
 21. the contrib-MoE group (GLM-4-MoE, Phi-3.5-MoE, OLMoE, GraniteMoE,
     dots.llm1), random weights from seed 0, every bias (q/k/v, o, the
     LayerNorms', the lm-head's, the router's correction) N(0, 0.02):
     (a) both decode kernels at the new GQA groups against their twins,
     B 4: G 12 at GLM-4.5-Air's heads (96 q over 8 kv of 128, the 16-wide
     instantiation) over bf16, scaled fp8 and fp32 pages / caches of 8192
     slots, G 3 at head_dim 64 with granite's scale 1/64, G 1 at OLMoE's
     heads, each with a control (the twin at KV head h // (G + 1)) that
     must part on bf16, and flash at G 12 and G 3 / D 64 (B 2, S 2048);
     each timed beside its twin, SDPA and the bound; (b) GLM-4.5-Air
     (zai-org/GLM-4.5-Air: hidden 4096, partial rotary 0.5, q/k/v bias,
     128 experts of 1408, top 8, one shared, sigmoid router with the
     correction bias, the first layer dense) cut to 6 layers (bf16
     weights gated equal to the geometry's) on 20 (d)'s engine
     and schedule: phase 9's gates, every paged launch at G 12 and window
     0, the streams held to ``generate`` as in 20 (b); (c) Phi-3.5-MoE
     (microsoft/Phi-3.5-MoE-instruct: 16 experts of 6400, top 2,
     sparsemixer, biased LayerNorms, q/k/v/o and lm-head biases, window
     131072; its longrope lists left out, ``seq_len`` 4096) cut to 4
     layers, batch 4: every launch at G 4 and window 131072;
     (d) OLMoE-1B-7B-0924 (G 1, 64 experts, top 8 unnormalised) and (e)
     granite-3.0-3b-a800m (G 3, head_dim 64, the multipliers) cut to 8
     layers each on phase 9's engine at batch 8, with (b)'s gates; (f) fp32
     (TF32 off) cuts of the five geometries (dots.llm1's
     rednote-hilab/dots.llm1.inst only here): 19 (d)'s gates on the paged
     app, then the family's contiguous app (flash and the decode kernel,
     after ``precompile``) on the same weights, its streams equal the
     paged app's and its launches exact (Phi-3.5-MoE's cut at window 256
     takes the rolling cache: flash only).
 22. speculation on the contiguous app, bf16, Llama-3.1-8B at full width
     cut to 16 layers (``LLAMA_CUT``) with random weights from seed 0 and 4 Medusa-1 heads
     (batch 4, ``seq_len`` 4096, both kernels, four prompts of 64-1024
     tokens, 48 new tokens, k 4): (a) ``SpeculativeDecoder`` with a
     Llama-3.2-1B-shaped draft, then with the target as its own draft;
     (b) ``EagleDecoder`` and ``EagleTreeDecoder`` (depth 4, branch 4, 16
     nodes) over a 1-layer EAGLE draft at the target's width (``fc``
     (8192, 4096); the target's embeddings and lm head); (c)
     ``MedusaDecoder``, ``MedusaTreeDecoder`` (DEFAULT_TREE) and
     ``DynamicTreeDecoder`` (branch 4, 16 nodes). Each decoder's step is
     one CUDA graph: after a warm run, the contiguous decode kernel's
     launches must equal the draft's layers x its T = 1 steps x the
     replays (16 x 4 fused, 16 x 4 self, 1 x 4 EAGLE, 1 x 4 the EAGLE
     tree's rollout, 0 Medusa), none eager, and every stream is held to
     greedy decode on the same weights fed its tokens
     (``teacher_deficits``: each token within TOL_SERVED_DEFICIT_BF16
     logit stds of the top, TOL_SERVED_MEAN_DEFICIT_BF16 on average, the
     control beyond). Prints tokens per step and accept rates, ms per
     fused step against a plain decode step, a torch.profiler trace of
     4 fused steps, and B2 at the 1B draft's shapes (D 64, G 4) and the
     EAGLE draft's (D 128, 1 layer) against its twin, its bound and
     SDPA. (d) the same weights in a paged app on phase 9's engine and
     schedule (32 new tokens) with ``MedusaProposer(4)``, then
     ``EagleProposer(draft, 4)``: at most one ragged dispatch and one
     blocking fetch a pass, paged launches = 16 x the width-1 all-decode
     passes, full streams held to ``generate`` (``served_vs_generate``);
     prints accept rates and host ms per pass. (e) fp32 (TF32 off) cuts
     at 4 layers of (a)-(d): every stream greedy's (a first difference
     only at a near-tie, printed), launches exact, and self-speculation's
     first step emits k + 1 on every row (later steps read the draft
     KV the reference's loop leaves unwritten after a fully accepted
     step; printed).
 23. multi-LoRA serving, the ``lora`` group: Llama-3.1-8B at full width
     cut to 16 layers (``LLAMA_CUT``), bf16, on phase 9's engine and schedule with a
     ``LoraAdapterPool`` (``max_loras`` 4: slot 0 and three usable; rank
     16; all seven projections targeted; five adapters of random N(0,
     0.07) factors, each gated to move the last prompt position's logits
     by at least one logit std). (a) the 8 requests spread over the five
     adapters and two base rows, the first four naming four adapters
     together (the engine admits what fits and requeues the rest; the
     pool must evict, spill and restore), each stream held to a
     contiguous app sharing the served
     weights and slots, fed the stream, under the request's adapter
     (``teacher_deficits``: 2.5 / 0.7 stds), and the control (each
     stream under another adapter) failing that gate; (b) one ragged
     dispatch and one fetch a pass, every all-decode pass a replay of a
     captured graph (the LoRA one where a live row has an adapter, else
     the LoRA-free one), paged launches = 16 x those passes, no capture
     after ``precompile``; (c) a resident adapter's slot written in place
     between passes: two fresh requests tagged with it hit the pool,
     replay the same graphs and are held to the new factors (the old as
     the control); (d) fp32 (TF32 off) at 4 layers: the served streams
     equal each request's single-adapter paged ``generate``; served
     again, each under another adapter with the prefix cache on, every
     prompt token is computed and the streams equal that adapter's
     ``generate``; base rows of the LoRA build a LoRA-free build's, a
     failed swap (the fault
     point, and a write failing half-way) leaves every slot's factors
     equal, and the contiguous app's ``generate(adapter_ids=)`` (flash
     and the contiguous decode kernel, launches exact) equals the
     streams; (e) host ms per all-decode and mixed pass with adapters,
     then on the same schedule with every row under one adapter and with
     base rows only (every graph replayed LoRA-free), profiled: the
     deltas' device ms; swap seconds and bytes, and the paged kernel at
     the served shapes.
 24. the KV cache's host tier, the ``tier`` group, on phase 9's app (or
     one built the same way): (a) a ``HostKVSpillTier`` of 1024 blocks
     (4 MiB each) on the ragged engine; phase 9's prompts served, cold
     prompts of 1900 tokens until every full block of theirs left the
     pool through the LRU and was spilled, then the prompts again: every
     restored block read back bit for bit, exactly the uncovered suffixes
     computed, the streams held to ``teacher_deficits`` (2.5 / 0.7 stds)
     with a control (other prompts' payloads under the right hashes) that
     must fail, paged launches = 32 x one-column passes, no capture or
     incident; spills, restores, host bytes, ms per spill and per restore
     call, TTFT restored against recomputed, the paged kernel at the
     restored shapes; (b) four requests of 300-1900 tokens handed off
     after their first token through the JSON wire form to a second paged
     app sharing the weights (its own pool, tier and graphs), 32 tokens
     decoded there: bytes equal, the suffixes computed, graph replays,
     the deficit gate and its control, record bytes and encode / decode
     ms; (c) phase 9's engine runs the native allocator, and (a)'s
     allocator calls replayed through the native and the Python one give
     equal results (host us per call); (d) fp32 at 4 layers (TF32 off):
     restored and handed-off streams equal the single engine's; an fp8
     (e4m3) pool's restores read back bit for bit.
 25. the decode pipeline, the ``pipeline`` group: Llama-3.2-1B at full
     width and depth, bf16, random weights from seed 0, phase 3's four
     prompt lengths each twice at batch 8 (``seq_len`` 2048, no prefix
     caching), served by ``PagedEngineAdapter`` (two-phase; its T = 1
     graph runs the paged kernel) and ``ContinuousBatchingAdapter`` (all
     8 rows every step: the identity rows, so the contiguous decode
     kernel) over the same weights, each after ``precompile``: (a)
     ``pipeline_depth=1`` streams equal ``pipeline_depth=0``'s token for
     token; (b) every pipelined ``_dispatch_decode`` runs under
     ``torch.cuda.set_sync_debug_mode("error")`` (wrapped by the phase)
     and no staging fill of the graphs waits on the card; each kernel's
     launches = layers x the pipelined dispatches, replays counted, and
     the kernel is held to its twin and timed at the served shapes; (c)
     host ms a step, device ms a dispatch (CUDA events around each
     dispatch) and the card's idle share at depths 0 and 1, untraced, and
     on the continuous-batching adapter again with the identity rule off
     (the gather path at the full batch); (d)
     with a registry on the app and the adapter: ``nxdi_run_seconds`` has
     host and device parts (``paged``, ``decode``),
     ``nxdi_device_sampled_rows_total`` equals the rows dispatched,
     ``nxdi_dispatch_depth`` reads 1 with a step in flight and 0 after
     ``flush``, and the ``nxdi_host_overlap_seconds`` median; (e)
     ``telemetry.observatory.analyze_app`` over the paged app: the cache
     untouched, the ``w1xb8`` decode graph's flops within
     TOL_OBSERVATORY_FLOPS_REL of the analytic count (weights and lm head
     times rows, plus the paged kernel's formula), its bytes at least the
     weights', the captured graph's capture seconds and pool bytes, the
     H100's figures in the roofline; (f) a continuous batch with a free
     row (row 0 pads it: the gather path) gives equal streams at both
     depths, and neither app records a steady-state incident; the group
     within its 60 s budget.
 26. the contrib dense group, ``contrib_dense``: Pythia-6.9B
     (EleutherAI/pythia-6.9b: 32 layers, 32 heads of 128 over 32 KV
     heads, rotary over 32 of 128, the parallel residual, a plain gelu MLP
     with biases, biased LayerNorms, vocab 50432, untied) and BLOOM-7B1
     (bigscience/bloom-7b1: 30 layers, 32 heads of 128, ALiBi, the
     embeddings' LayerNorm, vocab 250880, tied), random weights from seed
     0, every bias N(0, 0.02), BLOOM's ALiBi slopes its published ones:
     the specs as the geometries say, and with both kernels asked for no
     kernel gate admits BLOOM (each does without ``alibi``); (a) the paged
     kernel at Pythia's heads (B 8, G 1, D 128, lens 37-2000) within one
     bf16 ulp of its twin, a control (the twin at KV head h // 2) parting,
     timed beside the twin, SDPA over the pre-gathered KV and the bound;
     (b) Pythia at full width and depth on phase 9's engine and mix at
     ``seq_len`` 2048 (batch 8, chunk 512, 48 new tokens): phase 19's
     gates, every paged launch at G 1, launches = 32 x the all-decode
     steps, the kernel held to its twin at the served cache's shapes and
     timed, the streams held to ``generate``; (c) BLOOM at full width cut
     to 10 layers on the same engine and mix with the decode kernel and
     flash
     forced on: the same gates with no launch or capture of any of the
     three kernels, and a control (a 2-layer cut with ``alibi`` taken off)
     that launches the paged kernel at every layer of every decode step;
     (d) fp32 (TF32 off) 2-layer cuts of both on the contiguous app with
     both kernels asked for, after ``precompile``: Pythia launches flash
     once a layer and the decode kernel at every layer of every step, each
     held to its twin and timed at those shapes, BLOOM launches nothing
     (its control without ``alibi`` launches both), and each app's
     streams equal the kernels-off app's; the group within its 90 s
     budget.
 27. the second contrib dense group, ``contrib_dense2``: StarCoder
     (bigcode/starcoder: GPT-BigCode, 48 heads of 128 over one KV head,
     G 48), Command-R7B (CohereForAI/c4ai-command-r7b-12-2024: Cohere2, G
     4, window 4096 on three layers of four and NoPE on the fourth),
     Falcon-7B (G 71 at head_dim 64) and GPT-Neo-1.3B (global and local
     layers, window 256), random weights from seed 0, every bias N(0,
     0.02): the specs as the geometries say and every decode gate
     admitting them (no group term); (a) both decode kernels at G 48 / D
     128 and G 71 / D 64 over one KV head (3 and 5 chunks of at most 16
     query heads in one launch: the paged kernel at B 8, lens 37-2000,
     block 32, over bf16, fp32 and scaled fp8 pages; the contiguous one at
     B 4, S 2048, over bf16 and fp32 caches), each within one bf16 ulp
     (bf16 out) or 1e-4 (fp32) of its twin, a control (the twin's heads
     shifted by one chunk) parting on bf16, timed beside the twin, SDPA
     and the bound; (b) StarCoder at full width cut to 10 of 40 layers on
     phase 9's engine and mix: phase 19's gates, every paged launch at G
     48, launches = layers x the all-decode steps, the kernel held to its
     twin at the served shapes and timed, the streams held to
     ``generate``; (c) Command-R7B at full width cut to 8 of 32 layers on
     phase 19's engine and mix (batch 4, ``seq_len`` 8192, six requests of
     37-6000 tokens): the same gates at G 4, each launch at its layer's
     window (4096 sliding, 0 NoPE), timed at a sliding and a NoPE layer;
     (d) fp32 2-layer cuts of StarCoder, Falcon-7B and GPT-Neo-1.3B on the
     contiguous app with both kernels asked for, as 26 (d): StarCoder and
     Falcon launch flash once a layer and the decode kernel at every layer
     of every step (G 48, G 71), GPT-Neo the decode kernel at its global
     layer only (its local layer rolls on the mixed cache; no flash under
     a layer pattern), each kernel held to its twin at those shapes, the
     streams equal the kernels-off app's; the group within its 90 s
     budget.

 28. tensor parallelism (group ``tp``), Qwen2.5-72B widths (hidden 8192,
     64 q / 8 KV heads of 128, intermediate 29568, vocab 152064, q/k/v
     biases) cut to 2 of 80 layers, random weights from seed 0: (a) world
     size 1 over NCCL in this process: phase 9's ragged engine and mix on
     the app over the mesh (its T = 1 graphs captured with the model's
     collectives inside) and on the same weights without a process group:
     streams bit for bit equal, paged launches = 2 x the all-decode steps;
     host and device ms, idle share; (b) two ranks spawned on the one card
     over gloo (``parallel.mesh.spawn_world``, every step eager; rank 0
     plans, rank 1 follows its dispatch records): each rank's weight bytes
     at most 0.51 of (a)'s plus its replicated leaves, Hq 32 / Hkv 4 a
     rank (its cache and every paged launch at group 8), launches = 2 x
     the all-decode steps on both ranks, the streams held to (a)'s weights
     by the teacher-deficit gate with its shifted control; the paged
     kernel at the ranks' shapes; (c) an fp32 2-layer cut on the
     contiguous app at tp 2 with both kernels asked for: tokens equal tp
     1, logits within atol 2e-3 / rtol 1e-3, flash once a layer and the
     decode kernel at every layer of every step on each rank's local heads
     (timed there), and the int8 ring's stream holds the fp32 collectives'
     tokens with decode logits within 3% of theirs.
 29. expert parallelism (group ``ep``), Qwen3-235B-A22B widths (hidden
     4096, 64 q / 4 KV heads of 128, 128 experts of 1536 of which 8 per
     token, vocab 151936) cut to 2 of 94 layers, random weights from seed
     0, two ranks spawned on the one card over gloo, every step eager:
     (a) ep 2 (``tp_degree=2, ep_degree=2``): phase 9's ragged engine and
     mix; each rank's expert bytes at most 0.51 of the model's, Hq 32 /
     Hkv 2 a rank (every paged launch at group 16), launches = 2 x the
     all-decode steps on both ranks, one all-reduce a MoE block, the
     streams held to a one-process app of the same weights by the
     teacher-deficit gate with its shifted control; the paged kernel at
     the ranks' shapes (rank 1 idle between two barriers); (b) the same
     with ``moe_tkg_ep_degree=1``: each rank's hybrid copy (every expert,
     half the intermediate) as many bytes as its stored experts, the same
     gates; (c) fp32 2-layer cuts at tp 2 (ep 1): Qwen3-235B-A22B with
     both kernels asked for and Moonlight-16B-A3B (MLA): tokens equal tp
     1, logits within atol 2e-3 / rtol 1e-3; on Qwen3-235B-A22B flash once
     a layer and the contiguous decode kernel at every layer of every
     step on each rank's local heads (timed there), Moonlight no launch.
 30. attention data parallelism and the cp axis (group ``dp``),
     Qwen2.5-72B widths, random weights from seed 0, every rank on the
     one card over gloo, every step eager: (a) dp 2 x tp 2
     (``tp_degree=4, attention_dp_degree=2``, four ranks), 4 of 80 layers:
     phase 9's ragged engine and mix, each replica running its 4 rows of
     a step and writing every row's K/V into its pages; Hq 32 / Hkv 4 a
     rank, paged launches = 4 x the all-decode steps on every rank, each
     at a replica's rows, the streams held to a one-process app of the
     same weights by the teacher-deficit gate with its shifted control;
     the paged kernel at a replica's rows (the other ranks idle between
     two barriers) beside its bound and SDPA; (b) ``tp_degree=4,
     cp_degree=2`` with SP and flash decoding on the contiguous app, one
     8192-token prompt: no kernel launch on any rank, half of the slots a
     rank, the stream held to the one-process app by the deficit gate and
     printed beside ``tp_degree=2``'s, time to the first token at both,
     the cp gathers' bytes; (c) fp32 2-layer cuts with both kernels asked
     for: at dp 2 x tp 2 flash once a layer and the contiguous decode
     kernel at every layer of every step on each replica's 2 rows (timed
     there), and the reference's combined mesh (``tp_degree=8`` with cp
     2, dp 2, SP and flash decoding; eight ranks, Qwen2.5-7B's widths) with
     no launch; tokens equal tp 1 and logits within atol 2e-3 / rtol 1e-3
     in both.

The fp32 comparisons (phases 2, 4, 8, 10, 13, 14, 15, 16, 17, 18, 19, 20,
21, 22, 23, 24, 26, 27, 28, 29, 30 and the fp32 app of 6)
turn TF32 off inside :func:`fp32_exact`, which restores the previous
flags.

Every line before the last is one JSON object; the last line is
``{"ok": true, "device": {...}}``. Any failed phase raises, so the script
exits non-zero and prints no last line. Without a CUDA card it exits 2.
``--only`` runs a subset of the phase groups (kernels: 2; paged: 3-5;
pipeline: 25; contig: 6-8; ragged: 9, 11, 10; tier: 24 — alone, it
builds phase 9's app; spec: 12, 13, 22 — alone, 12 (a) builds its own
app; moe: 14; oss: 15; long: 16; mla: 17; quant: 18; dense: 19;
moe_families: 20; contrib_moe: 21; lora: 23; contrib_dense: 26;
contrib_dense2: 27; tp: 28; ep: 29) and then prints no ``ok`` line.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

# Llama-3.2-1B (HF config.json of meta-llama/Llama-3.2-1B)
LLAMA_3_2_1B = dict(
    model_type="llama", hidden_size=2048, intermediate_size=8192,
    num_hidden_layers=16, num_attention_heads=32, num_key_value_heads=8,
    head_dim=64, vocab_size=128256, rms_norm_eps=1e-5, rope_theta=500000.0,
    rope_scaling={"rope_type": "llama3", "factor": 32.0,
                  "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                  "original_max_position_embeddings": 8192},
    max_position_embeddings=131072, hidden_act="silu",
    tie_word_embeddings=True)

# Mistral-7B-v0.1 (HF config.json of mistralai/Mistral-7B-v0.1)
MISTRAL_7B = dict(
    model_type="mistral", hidden_size=4096, intermediate_size=14336,
    num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
    vocab_size=32000, rms_norm_eps=1e-5, rope_theta=10000.0,
    sliding_window=4096, max_position_embeddings=32768, hidden_act="silu",
    tie_word_embeddings=False)

PROMPT_LENS = (37, 300, 900, 1500)      # phase 3 prompts (batch 4)
NEW_TOKENS = 64
SERVE_LENS = (23, 57, 101, 150, 77, 190)  # phases 4 and 8 requests
SERVE_TOKENS = 32
MISTRAL_LENS = (37, 300, 900, 1900)     # phases 6-7 prompts (ctx bucket 2048)
MISTRAL_SEQ = 4096

# Llama-3.1-8B (HF config.json of meta-llama/Llama-3.1-8B)
LLAMA_3_1_8B = dict(
    model_type="llama", hidden_size=4096, intermediate_size=14336,
    num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
    head_dim=128, vocab_size=128256, rms_norm_eps=1e-5, rope_theta=500000.0,
    rope_scaling={"rope_type": "llama3", "factor": 8.0,
                  "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                  "original_max_position_embeddings": 8192},
    max_position_embeddings=131072, hidden_act="silu",
    tie_word_embeddings=False)
# Qwen3-30B-A3B (HF config.json of Qwen/Qwen3-30B-A3B): 48 layers, 128
# experts of which 8 route per token, every layer MoE
QWEN3_30B_A3B = dict(
    model_type="qwen3_moe", hidden_size=2048, intermediate_size=6144,
    moe_intermediate_size=768, num_hidden_layers=48, num_attention_heads=32,
    num_key_value_heads=4, head_dim=128, vocab_size=151936,
    num_experts=128, num_experts_per_tok=8, norm_topk_prob=True,
    decoder_sparse_step=1, mlp_only_layers=[], rms_norm_eps=1e-6,
    rope_theta=1000000.0, max_position_embeddings=40960, hidden_act="silu",
    sliding_window=None, tie_word_embeddings=False)
# gpt-oss-20b (HF config.json of openai/gpt-oss-20b): 24 layers
# alternating sliding (window 128) / full attention, learned sinks, q/k/v
# and o biases, YaRN, 32 experts of which 4 per token, clamped swiglu
GPT_OSS_20B = dict(
    model_type="gpt_oss", hidden_size=2880, intermediate_size=2880,
    num_hidden_layers=24, num_attention_heads=64, num_key_value_heads=8,
    head_dim=64, vocab_size=201088, rms_norm_eps=1e-5, rope_theta=150000.0,
    rope_scaling={"rope_type": "yarn", "factor": 32.0, "beta_fast": 32.0,
                  "beta_slow": 1.0, "truncate": False,
                  "original_max_position_embeddings": 4096},
    max_position_embeddings=131072, initial_context_length=4096,
    sliding_window=128,
    layer_types=["sliding_attention", "full_attention"] * 12,
    num_local_experts=32, num_experts_per_tok=4, experts_per_token=4,
    swiglu_limit=7.0, attention_bias=True, hidden_act="silu",
    tie_word_embeddings=False)
OSS_CHECK_LAYERS = 8           # 15 (c): the cut whose fp32 twin fits
MOE_TOKENS = (64, 4096)        # phase 14 (b): B·T at the dense threshold
#                                and of a mixed pass (8 rows x 512)
# 14 (e): the cut whose fp32 twin runs phase 6's rule (8 layers fit; 4
#   keep the whole script's time with phase 21 in it)
MOE_CONTIG_CHECK_LAYERS = 4
# depth cuts for phase 29's room (the whole script took 1121.8 s with it
#   on an H100 before them, moe 135.4 s of it, contig 81.0, tp 61.3;
#   PERF.md §4), each keeping its phase's per-layer shapes and gates:
#   14 (c) Qwen3-30B-A3B served at 24 of 48 layers; phases 6 and 7
#   Mistral-7B-v0.1 at 16 of 32; 28 (a), (b) Qwen2.5-72B at 4 of 80
#   (TP_SERVE_LAYERS). 14 (e) at 16 layers saved 3 s (logits-bound) and
#   stays at 48. For phase 30's room (the whole script at 928.85 s before
#   it, its group 92.85 s: PERF.md §4), each again keeping its phase's
#   shapes and gates: 14 (c) at 12 layers, phases 6 and 7 at 8, 16 (b),
#   (c) gpt-oss-20b at 4, 18 (b), (d) at 4, 18 (e) at 4, 21 (b)
#   GLM-4.5-Air at 6, 28 (a), (b) and 29 (a), (b) at 2.
MOE_SERVE_LAYERS = 12
CONTIG_MAIN_LAYERS = 8
# depth cuts for the room of phases 23, 24, 26 and 27, each keeping its
# phase's per-layer shapes and gates: 16 (d), (e) Mistral-7B-v0.1 at 8 of
# 32 layers; 17 (b), (c) Moonlight at 4 of 27 (the dense layer and 3
# MoE); 18 (b), (d) gpt-oss-20b MXFP4 at 8 of 24; 18 (e) the low-rank
# Llama-3.2-1B at 8 of 16; 19 (b) Gemma-2-27B at 8 of 46 (4 local /
# global pairs)
LONG_MISTRAL_LAYERS = 8
MLA_CUT = 4
QUANT_OSS_LAYERS = 4
QUANT_LOW_RANK_LAYERS = 4
GEMMA2_CUT = 8
# for phase 24's room: Llama-3.1-8B at 16 of its 32 layers in 18 (c), the
#   Llama reading of 18 (d), 22 (a)-(d) and 23 (a)-(c), (e), each phase's
#   per-layer shapes and gates kept (12
#   (b)'s sampled twin check is tuned to the full depth's logits: at 16
#   layers a twin's first difference fell outside the top-k)
LLAMA_CUT = 16
# phases 9-10: the ragged engine (batch 8, one spare block per row)
RAGGED = dict(lens=(37, 300, 900, 1900, 123, 640, 1500, 64), seq_len=4096,
              chunk=512, block=32)
RAGGED_TOKENS = 48                      # phases 9 and 12
RAGGED_CHECK_TOKENS = 24                # phases 10 and 13
SPEC_K = 3                              # phases 12-13: drafts per step
# phase 16: gpt-oss-20b on the contiguous app past its 128-token window
# (the mixed per-layer cache), Mistral-7B-v0.1 past its 4096-token window
# (the rolling cache) and windowed context encoding
OSS_LONG = dict(seq_len=32768, lens=(200, 700, 1300, 2000), new_tokens=128)
# 16 (b), (c): gpt-oss-20b cut to 4 layers (2 global, 2 local) of its
#   24, to keep the whole script's time with phases 21, 27 and 30 in it
LONG_OSS_LAYERS = 4
MISTRAL_ROLL = dict(seq_len=16384, lens=(5000, 6000), new_tokens=64)
MISTRAL_WCTE = dict(seq_len=16384, window=2048, len=12000, new_tokens=32,
                    one_shot_len=4000)
# Moonlight-16B-A3B (HF config.json of moonshotai/Moonlight-16B-A3B,
# model_type deepseek_v3): 27 layers, the first dense (intermediate 11264),
# 26 MoE (64 experts of 1408, 6 per token, 2 shared); MLA with kv_lora_rank
# 512, no q-LoRA, K heads 128 + 64 (rope) wide, V heads 128; sigmoid
# routing, routed scaling 2.446; no rope scaling
MOONLIGHT_16B = dict(
    model_type="deepseek_v3", hidden_size=2048, intermediate_size=11264,
    moe_intermediate_size=1408, num_hidden_layers=27, num_attention_heads=16,
    num_key_value_heads=16, n_routed_experts=64, n_shared_experts=2,
    num_experts_per_tok=6, first_k_dense_replace=1, moe_layer_freq=1,
    n_group=1, topk_group=1, norm_topk_prob=True, routed_scaling_factor=2.446,
    scoring_func="sigmoid", topk_method="noaux_tc", kv_lora_rank=512,
    q_lora_rank=None, qk_nope_head_dim=128, qk_rope_head_dim=64,
    v_head_dim=128, vocab_size=163840, rms_norm_eps=1e-5, rope_theta=50000.0,
    rope_scaling=None, max_position_embeddings=8192, hidden_act="silu",
    attention_bias=False, tie_word_embeddings=False)
MLA_SEQ = 4096                          # 17 (b), (c): the cache's rows
MLA_PLAIN_LENS = (37, 300)              # 17 (a): batch 2
MLA_PLAIN_STEPS = 8                     # 17 (a): decode steps compared
MLA_CHECK_LAYERS = (4, 8)               # 17 (d): fp32 identity, bf16 vs fp32
MLA_CHECK_TOKENS = 32
LONG_DECODE_LENS = (300, 900, 1500, 2100)   # 16 (a): B2's rows
LONG_CHECK_LAYERS = 4                       # 16 (f): the fp32 cuts
LONG_CHECK_TOKENS = 32
SPEC_SAMPLING = dict(do_sample=True, top_k=50, top_p=0.9, temperature=0.7,
                     stream_seed=1234)

# Phase 18: quantized and low-rank weights. gpt-oss-20b's experts (and
# o_proj) in-graph MXFP4, as the reference's quantized=True,
# quantization_dtype="mxfp4"; Llama-3.1-8B's o_proj and MLP int8
# per-channel (or fp8 blockwise at a cut)
MXFP4_WEIGHTS = dict(quantized=True, quantization_dtype="mxfp4")
INT8_WEIGHTS = dict(quantized=True, quantization_dtype="int8",
                    quantization_type="per_channel_symmetric")
FP8_BLOCK_WEIGHTS = dict(quantized=True, quantization_dtype="fp8",
                         quantization_type="blockwise_symmetric")
# 18 (c) the scaled fp8 (e4m3) KV cache. With random weights N(0, 0.02)
#   and unit-RMS normed inputs every K / V entry is ~N(0, (0.02 x
#   sqrt(4096))^2) = N(0, 1.28^2) (RoPE keeps norms); the largest of the
#   ~1e9 entries a run stores sits near 6.2 sigma ~ 8. The power-of-two
#   scale 2^-5 stores it near 256, under e4m3's 448 with 1.75x to spare,
#   and keeps every |x| >= 2^-4 a normal e4m3 value (x / s >= 2).
QUANT_KV_SCALE = 2.0 ** -5
FP8_KV = dict(kv_cache_dtype="float8_e4m3fn", kv_cache_quant=True,
              kv_cache_scale=QUANT_KV_SCALE)
QUANT_LOW_RANK = 512                   # 18 (e): Llama-3.2-1B's MLP rank
QUANT_CHECK_LAYERS = 4                 # 18 (d), (e): the fp32 cuts
QUANT_LENS = (37, 120, 300, 500)       # 18 (d), (e): batch 4, bucket 512
QUANT_CHECK_TOKENS = 16
QUANT_BF16_TOKENS = 16                 # 18 (d): teacher-forced steps

# Phase 19: the dense families. Geometries written from the published HF
# config.json files (random weights from seed 0).
# Gemma-2-27B (google/gemma-2-27b): 46 layers alternating sliding (window
# 4096) and full attention from a sliding layer 0 (the file has no
# layer_types: the family's default pattern of 2), 32 q / 16 kv heads of
# 128 (G 2), query_pre_attn_scalar 144, soft-caps 50 (attention) and 30
# (final logits), gelu-tanh, tied embeddings: 27.23 B parameters
GEMMA2_27B = dict(
    model_type="gemma2", hidden_size=4608, intermediate_size=36864,
    num_hidden_layers=46, num_attention_heads=32, num_key_value_heads=16,
    head_dim=128, vocab_size=256000, query_pre_attn_scalar=144,
    sliding_window=4096, attn_logit_softcapping=50.0,
    final_logit_softcapping=30.0, hidden_act="gelu_pytorch_tanh",
    hidden_activation="gelu_pytorch_tanh", rms_norm_eps=1e-6,
    rope_theta=10000.0, max_position_embeddings=8192,
    tie_word_embeddings=True)
# Gemma-3-27B, text (the text_config of google/gemma-3-27b-it, model_type
# gemma3_text): 62 layers, 5 sliding (window 1024) to 1 full, 32 q / 16
# kv heads of 128, query_pre_attn_scalar 168, the global layers' rope at
# 1e6 linear x8, the local ones' at 1e4, per-head (1 + w) q/k norms, no
# soft-caps, tied
GEMMA3_27B = dict(
    model_type="gemma3_text", hidden_size=5376, intermediate_size=21504,
    num_hidden_layers=62, num_attention_heads=32, num_key_value_heads=16,
    head_dim=128, vocab_size=262208, query_pre_attn_scalar=168,
    sliding_window=1024, sliding_window_pattern=6, rope_theta=1000000.0,
    rope_scaling={"rope_type": "linear", "factor": 8.0},
    rope_local_base_freq=10000.0, final_logit_softcapping=None,
    attn_logit_softcapping=None, hidden_activation="gelu_pytorch_tanh",
    rms_norm_eps=1e-6, max_position_embeddings=131072,
    tie_word_embeddings=True)
# Phi-4 (microsoft/phi-4, model_type phi3): 40 layers, 40 q / 10 kv heads
# of 128 (G 4), no rope scaling
PHI_4 = dict(
    model_type="phi3", hidden_size=5120, intermediate_size=17920,
    num_hidden_layers=40, num_attention_heads=40, num_key_value_heads=10,
    vocab_size=100352, rope_theta=250000.0, rms_norm_eps=1e-5,
    max_position_embeddings=16384, original_max_position_embeddings=16384,
    rope_scaling=None, hidden_act="silu", tie_word_embeddings=False)
# Granite-3.1-8B-instruct (ibm-granite/granite-3.1-8b-instruct): 40
# layers, 32 q / 8 kv heads of 128, IBM's multipliers, tied
GRANITE_3_1_8B = dict(
    model_type="granite", hidden_size=4096, intermediate_size=12800,
    num_hidden_layers=40, num_attention_heads=32, num_key_value_heads=8,
    vocab_size=49155, embedding_multiplier=12.0,
    attention_multiplier=0.0078125, residual_multiplier=0.22,
    logits_scaling=16.0, rope_theta=10000000.0, rms_norm_eps=1e-5,
    max_position_embeddings=131072, attention_bias=False,
    hidden_act="silu", tie_word_embeddings=True)
# OLMo-2-1124-7B (allenai/OLMo-2-1124-7B): 32 layers, 32 q / 32 kv heads
# of 128 (G 1), post-norm with full-width q/k norms
OLMO2_7B = dict(
    model_type="olmo2", hidden_size=4096, intermediate_size=11008,
    num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=32,
    vocab_size=100352, rope_theta=500000.0, rms_norm_eps=1e-6,
    max_position_embeddings=4096, attention_bias=False, hidden_act="silu",
    tie_word_embeddings=False)
# Qwen2.5-7B (Qwen/Qwen2.5-7B): 28 layers, 28 q / 4 kv heads of 128 (G 7),
# q/k/v biases, no sliding window
QWEN2_5_7B = dict(
    model_type="qwen2", hidden_size=3584, intermediate_size=18944,
    num_hidden_layers=28, num_attention_heads=28, num_key_value_heads=4,
    vocab_size=152064, rope_theta=1000000.0, rms_norm_eps=1e-6,
    max_position_embeddings=131072, use_sliding_window=False,
    sliding_window=131072, max_window_layers=28, hidden_act="silu",
    tie_word_embeddings=False)
DENSE_GEOMETRIES = {"gemma2_27b": GEMMA2_27B, "gemma3_27b": GEMMA3_27B,
                    "phi_4": PHI_4, "granite_3_1_8b": GRANITE_3_1_8B,
                    "olmo2_7b": OLMO2_7B, "qwen2_5_7b": QWEN2_5_7B}
# 19 (b): batch 4, 8192 slots a row, six requests, two past the 4096 window
DENSE_SERVE = dict(lens=(37, 300, 1500, 4500, 6000, 900), seq_len=8192,
                   chunk=512, block=32)
# 19 (c): Gemma-3-27B cut to one 6-layer pattern (5 local, 1 global; for
#   phase 26's room), prompts past 1024
GEMMA3_CUT = 6
GEMMA3_SERVE = dict(lens=(37, 300, 1500, 2500, 1100, 640), seq_len=4096,
                    chunk=512, block=32)
# 19 (a): the kernels' rows; q and keys at this std put |scores| mostly
#   above the cap: at scale 144 ** -0.5 a score is N(0, (0.94 x 12^2)^2),
#   |s| > 50 for ~70% of the keys (gate: more than DENSE_CAPPED_SHARE)
DENSE_KERNEL_LENS = (300, 2100, 4500, 7000)
DENSE_QK_STD = 12.0
DENSE_CAPPED_SHARE = 0.5
# 19 (d): the fp32 cuts (batch 4, bucket 512) and the Gemma-2 contiguous
#   app past its window
DENSE_CHECK_LAYERS = 4
DENSE_CHECK = dict(lens=(37, 120, 300, 500), seq_len=2048, chunk=512,
                   block=32)
DENSE_CHECK_TOKENS = 16
GEMMA2_LONG = dict(seq_len=8192, len=5000, new_tokens=16)

# Phase 20: Llama4 text and DBRX. Geometries written from the published
# HF config.json files (random weights from seed 0).
# Llama-4-Scout-17B-16E, text_config (meta-llama/Llama-4-Scout-17B-16E,
# model_type llama4_text): 48 layers, every 4th NoPE, the others chunked
# at 8192; 40 q / 8 kv heads of 128 (G 5); 16 experts of 8192, top 1, a
# shared expert, every layer MoE (interleave step 1; the dense MLP width
# 16384 serves Maverick's interleave); llama3 rope at 5e5, factor 16; the
# q/k norm; temperature tuning at floor_scale 8192, attn_scale 0.1
LLAMA4_SCOUT = dict(
    model_type="llama4_text", hidden_size=5120, intermediate_size=8192,
    intermediate_size_mlp=16384, num_hidden_layers=48,
    num_attention_heads=40, num_key_value_heads=8, head_dim=128,
    vocab_size=202048, num_local_experts=16, num_experts_per_tok=1,
    interleave_moe_layer_step=1, no_rope_layer_interval=4,
    attention_chunk_size=8192, attn_temperature_tuning=True,
    floor_scale=8192, attn_scale=0.1, use_qk_norm=True, rms_norm_eps=1e-5,
    rope_theta=500000.0,
    rope_scaling={"rope_type": "llama3", "factor": 16.0,
                  "low_freq_factor": 1.0, "high_freq_factor": 1.0,
                  "original_max_position_embeddings": 8192},
    max_position_embeddings=10485760, hidden_act="silu",
    attention_bias=False, tie_word_embeddings=False)
# DBRX (databricks/dbrx-instruct): 40 layers, d_model 6144, 48 q / 8 kv
# heads of 128 (G 6), clip_qkv 8, rope at 5e5, 16 experts of 10752, top
# 4, LayerNorm, untied; ``num_hidden_layers`` mirrors ``n_layers`` for
# the helpers that read it
DBRX_INSTRUCT = dict(
    model_type="dbrx", d_model=6144, n_heads=48, n_layers=40,
    num_hidden_layers=40, vocab_size=100352, max_seq_len=32768,
    attn_config={"kv_n_heads": 8, "clip_qkv": 8.0, "rope_theta": 500000.0},
    ffn_config={"ffn_hidden_size": 10752, "moe_num_experts": 16,
                "moe_top_k": 4, "moe_normalize_expert_weights": 1},
    tie_word_embeddings=False)
# 20 (b): Scout cut to 4 layers (layer 3 NoPE), batch 4, 16384 slots a
#   row; one prompt past the 8192 chunk and one whose decode crosses it
LLAMA4_CUT = 4
LLAMA4_SERVE = dict(lens=(37, 300, 1500, 8170, 9000, 900), seq_len=16384,
                    chunk=512, block=32)
# 20 (c): Scout's widths at Maverick's interleave (layers 1 and 3 MoE,
#   layer 3 NoPE), fp32, 4 layers, the attention chunk cut to 64 so short
#   prompts cross chunks
LLAMA4_CHECK_LAYERS = 4
LLAMA4_CHECK_CHUNK = 64
# 20 (d): DBRX cut to 4 layers, the same schedule shape below 8192
DBRX_CUT = 4
DBRX_SERVE = dict(lens=(37, 300, 1500, 4500, 7000, 900), seq_len=8192,
                  chunk=512, block=32)
# 20 (e): DBRX at 2 layers, fp32; W_qkv drawn at this std so that ~30% of
#   q/k/v values exceed clip_qkv 8 (LayerNorm'd inputs: std 0.1 x
#   sqrt(6144) = 7.8); the gate wants at least DBRX_CLIP_SHARE
DBRX_CHECK_LAYERS = 2
DBRX_QKV_STD = 0.1
DBRX_CLIP_SHARE = 0.01
MOE_FAMILIES_CHECK = dict(lens=(37, 120, 300, 500), seq_len=2048,
                          chunk=512, block=32)
MOE_FAMILIES_CHECK_TOKENS = 16
# 20 (a): the decode kernels at DBRX's heads, and the scale of their fp8
#   pages (N(0, 1) values stored as x / 0.5)
G6_KERNEL_LENS = (300, 2100, 4500, 7000)
G6_FP8_SCALE = 0.5

# Phase 21: the contrib MoE families. Geometries written from the
# published HF config.json files (random weights from seed 0).
# GLM-4.5-Air (zai-org/GLM-4.5-Air, model_type glm4_moe): 46 layers, the
# first dense (10944 wide); 96 q / 8 kv heads of 128 (G 12), partial rotary
# 0.5, q/k/v bias, no q/k norm; 128 routed experts of 1408, top 8, one
# shared, the sigmoid router with the correction bias, one group; rope 1e6
GLM_45_AIR = dict(
    model_type="glm4_moe", hidden_size=4096, intermediate_size=10944,
    moe_intermediate_size=1408, num_hidden_layers=46,
    num_attention_heads=96, num_key_value_heads=8, head_dim=128,
    partial_rotary_factor=0.5, attention_bias=True, use_qk_norm=False,
    n_routed_experts=128, num_experts_per_tok=8, n_shared_experts=1,
    first_k_dense_replace=1, n_group=1, topk_group=1, norm_topk_prob=True,
    routed_scaling_factor=1.0, vocab_size=151552, rms_norm_eps=1e-5,
    rope_theta=1000000.0, max_position_embeddings=131072,
    hidden_act="silu", tie_word_embeddings=False)
# Phi-3.5-MoE (microsoft/Phi-3.5-MoE-instruct): 32 layers, 32 q / 8 kv
# heads of 128 (G 4), q/k/v and o biases, LayerNorm with bias, the lm-head
# bias; 16 experts of 6400, top 2, sparsemixer (router_jitter_noise 0.01);
# window 131072. Its longrope lists are not in the repository: rope_scaling
# None, run at seq_len <= original_max_position_embeddings (4096)
PHI_35_MOE = dict(
    model_type="phimoe", hidden_size=4096, intermediate_size=6400,
    num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
    num_local_experts=16, num_experts_per_tok=2, router_jitter_noise=0.01,
    input_jitter_noise=0.01, attention_bias=True, lm_head_bias=True,
    sliding_window=131072, vocab_size=32064, rms_norm_eps=1e-5,
    rope_theta=10000.0, rope_scaling=None,
    original_max_position_embeddings=4096, max_position_embeddings=131072,
    hidden_act="silu", tie_word_embeddings=False)
# OLMoE-1B-7B-0924 (allenai/OLMoE-1B-7B-0924): 16 layers, 16 q / 16 kv
# heads of 128 (G 1), full-width q/k norm; 64 experts of 1024, top 8,
# not renormalised
OLMOE_1B_7B = dict(
    model_type="olmoe", hidden_size=2048, intermediate_size=1024,
    num_hidden_layers=16, num_attention_heads=16, num_key_value_heads=16,
    num_experts=64, num_experts_per_tok=8, norm_topk_prob=False,
    vocab_size=50304, rms_norm_eps=1e-5, rope_theta=10000.0,
    max_position_embeddings=4096, hidden_act="silu",
    tie_word_embeddings=False)
# granite-3.0-3b-a800m (ibm-granite/granite-3.0-3b-a800m-instruct): 32
# layers, 24 q / 8 kv heads of 64 (G 3); 40 experts of 512, top 8; the
# multipliers (attention 1/64 as the softmax scale); tied, vocab 49155
GRANITE_3B_MOE = dict(
    model_type="granitemoe", hidden_size=1536, intermediate_size=512,
    num_hidden_layers=32, num_attention_heads=24, num_key_value_heads=8,
    num_local_experts=40, num_experts_per_tok=8, embedding_multiplier=12.0,
    attention_multiplier=0.015625, residual_multiplier=0.22,
    logits_scaling=6.0, vocab_size=49155, rms_norm_eps=1e-6,
    rope_theta=10000.0, max_position_embeddings=4096, hidden_act="silu",
    tie_word_embeddings=True)
# dots.llm1 (rednote-hilab/dots.llm1.inst): 62 layers, the first dense
# (10944 wide); 32 q / 32 kv heads of 128 (G 1), full rotary, the
# per-head q/k norm; 128 experts of 1408, top 6, two shared, sigmoid with
# the correction bias, routed scaling 2.5. ~142B parameters: fp32 cuts
# only
DOTS_LLM1 = dict(
    model_type="dots1", hidden_size=4096, intermediate_size=10944,
    moe_intermediate_size=1408, num_hidden_layers=62,
    num_attention_heads=32, num_key_value_heads=32, head_dim=128,
    n_routed_experts=128, num_experts_per_tok=6, n_shared_experts=2,
    first_k_dense_replace=1, n_group=1, topk_group=1, norm_topk_prob=True,
    routed_scaling_factor=2.5, attention_bias=False, vocab_size=152064,
    rms_norm_eps=1e-5, rope_theta=10000000.0, max_position_embeddings=32768,
    hidden_act="silu", tie_word_embeddings=False)
# 21 (b): GLM-4.5-Air cut to 6 layers (1 dense + 5 MoE), on 20 (d)'s
#   schedule (batch 4, 8192 slots a row)
GLM_CUT = 6
GLM_SERVE = DBRX_SERVE
# 21 (c): Phi-3.5-MoE cut to 4 layers (for phase 26's room), batch 4,
#   4096 slots
PHI_CUT = 4
PHI_SERVE = dict(lens=(37, 300, 1500, 3900, 2500, 900), seq_len=4096,
                 chunk=512, block=32)
# 21 (d), (e): OLMoE-1B-7B-0924 at full depth and granite-3.0-3b-a800m
#   at 8 of its 32 layers (for phase 26's room) on phase 9's schedule
#   (batch 8)
GRANITE_MOE_CUT = 8
# 21 (f): the fp32 cuts (each MoE geometry's first dense layer kept), the
#   Phi cut's window small enough to bite at 21 (f)'s prompts
CONTRIB_CHECK_LAYERS = {"glm4_moe": 2, "phimoe": 2, "olmoe": 4,
                        "granitemoe": 4, "dots1": 2}
CONTRIB_CHECK = dict(DENSE_CHECK, chunk=128)
PHI_CHECK_WINDOW = 256
# 21 (a): the decode kernels at the new groups (bf16 activations over
#   bf16, scaled fp8 or fp32 pages / caches; fp32 runs fp32 activations),
#   B 4 at each geometry's served lens; flash at G 12 and G 3 / D 64
CONTRIB_KERNEL_CASES = {
    "glm_air_g12_bf16": dict(hq=96, hkv=8, d=128, s=8192,
                             lens=G6_KERNEL_LENS, dtype="bfloat16"),
    "glm_air_g12_fp8": dict(hq=96, hkv=8, d=128, s=8192,
                            lens=G6_KERNEL_LENS, dtype="float8_e4m3fn",
                            kv_scale=G6_FP8_SCALE),
    "glm_air_g12_fp32": dict(hq=96, hkv=8, d=128, s=8192,
                             lens=G6_KERNEL_LENS, dtype="float32"),
    "granite_g3_d64_bf16": dict(hq=24, hkv=8, d=64, s=4096,
                                lens=(300, 900, 1900, 4000),
                                dtype="bfloat16", scale=0.015625),
    "olmoe_g1_bf16": dict(hq=16, hkv=16, d=128, s=4096,
                          lens=(300, 900, 1900, 4000), dtype="bfloat16"),
}
CONTRIB_FLASH_CASES = {
    "glm_air_g12": dict(hq=96, hkv=8, d=128),
    "granite_g3_d64": dict(hq=24, hkv=8, d=64, scale=0.015625),
}

# Tolerances, with their reasons:
# kernel vs twin, bf16 out: both accumulate in fp32 and round the output
#   to bf16 once; one bf16 ulp at |o| < 2 is <= 7.8e-3.
TOL_KERNEL_BF16 = 1e-2
# kernel vs twin, fp32 out: fp32 sums in another order (split-K online
#   softmax vs one softmax) differ by ~1e-6 relative.
TOL_KERNEL_FP32 = 1e-4


def tol_flash_bf16(inputs) -> float:
    """Flash kernel vs twin, bf16 out: both compute in fp32 and round the
    output to bf16 once, so they differ by at most one bf16 ulp of the
    output; each output is a convex combination of value rows, so |o| <=
    max |v|, and the ulp there is 2^(floor(log2 max|v|) - 7)."""
    vmax = inputs["v"].float().abs().max().item()
    return 2.0 ** (math.floor(math.log2(vmax)) - 7)


def tol_decode_bf16(out) -> float:
    """Decode kernel vs twin, bf16 out, bounded by the output itself: both
    accumulate in fp32 and round the output to bf16 once, so they differ
    by at most one bf16 ulp of the largest output, 2^(floor(log2
    max|o|) - 7)."""
    omax = out.float().abs().max().item()
    return 2.0 ** (math.floor(math.log2(omax)) - 7)
# decode logits, kernel app vs gather app, bf16: the gather path rounds
#   the softmax probabilities to bf16 before the value product (the
#   kernel keeps them fp32) and every layer's output is rounded to bf16;
#   logits have std ~0.9 here and bf16 spacing 1.6e-2 at |x| in [2, 4).
TOL_LOGITS_BF16 = 0.25
# the contiguous path (prefill and decode logits): the same two roundings
#   differ between the kernel app and the kernels-off app, and over 32
#   layers at 4096 width they move the logits by ~0.4 at a logit std of
#   ~1.3 (measured), so a fixed bound says little. Both bf16 apps are
#   held to an fp32 app on the same (upcast) weights and tokens instead:
#   the kernels keep the probabilities in fp32, so the kernel app's mean
#   |logit error| must be no larger than the kernels-off app's, up to
#   this factor for rounding noise between the two.
TOL_CONTIG_VS_FP32 = 1.25
# fp32 serving: batched and single-row matmuls may take different kernels;
#   a stream may first differ only where its token's logit sits closer
#   than this to the reference's top logit (so the top two are as close).
NEAR_TIE = 1e-3

# 14 (b) the MoE layer vs the fp32 loop reference, fp32 with TF32 off:
#   sums of 2048- and 768-long products taken in another order; their
#   rounding is ~1e-6 of outputs of |y| < 1 (1e-4 leaves a wide margin and
#   still catches a wrong affinity, ~1e-2).
TOL_MOE_FP32 = 1e-4
# bf16: each product output, the GLU and y round at 2^-9 relative (about
#   four roundings: relative RMS ~sqrt(4) x 2^-9 = 4e-3); 2e-2 is 5x that,
#   while one of a token's 8 experts dropped or misweighted moves it by
#   more than 0.2.
TOL_MOE_BF16_REL = 2e-2
# the loop reference routes on its own (torch.topk); a token whose 8th and
#   9th expert probabilities are closer than this may pick either.
NEAR_TIE_ROUTER = 1e-6
# 14 (d) the bf16 4-layer app vs the fp32 app on the same weights: the
#   residual stream and every product round at 2^-9 over 4 layers (~1-2%
#   relative RMS of the logits); an expert near-tie flipped by that
#   rounding moves one token; 5e-2 bounds both, a wrong expert or head
#   leaves the logits uncorrelated (relative RMS ~1.4).
TOL_MOE_LOGITS_REL = 5e-2
# 14 (e) at full depth, the kernel app vs the kernels-off app, both bf16:
#   they round attention differently (probabilities bf16 vs fp32), the
#   router flips near-tie experts on those differences, and both compound
#   over 48 layers: relative RMS 0.0165 measured (NVIDIA H100 80GB HBM3,
#   700 W); 0.1 leaves 6x, while uncorrelated logits (a wrong head, a
#   wrong key) sit near 1.4. Phase 6's rule against an fp32 app runs at
#   the 8-layer cut.
TOL_MOE_CONTIG_DIRECT = 0.1
# 15 (a) the SDPA yardstick (the window pre-gathered, the sink as a zero
#   key whose additive mask is its logit) against the twin: the bf16 mask
#   rounds the sink logit (2^-9 relative) and SDPA rounds its output;
#   outputs are below ~4, so a few 1e-2 at most, while a sink left out or
#   put in the numerator moves outputs by 0.1-1 (sinks are N(0, 1)).
TOL_SDPA_YARDSTICK = 5e-2
# 16 (b), (d) at full depth, the mixed or rolling cache's decode logits vs
#   full rows' on the same weights and tokens, bf16, all on the gather
#   path: the layouts read the same keys in another slot order, and the
#   random-weight stack magnifies that rounding at every step (no growth
#   over the steps), gpt-oss's near-tie expert flips most. Measured
#   (NVIDIA H100 80GB HBM3, 700 W): relative RMS 0.190 (gpt-oss-20b, 127
#   steps) and 0.0386 (Mistral-7B-v0.1, 63 steps); the controls (full
#   rows with the window dropped, so keys outside it are read, as a
#   misplaced slot reads them) 0.891 and 1.283. Each limit sits near the
#   geometric mean of its two readings, a factor 2.2 and 5.7 from each.
#   The gpt-oss run is now an 8-layer cut (LONG_OSS_LAYERS): a
#   shallower stack magnifies less, so the reading falls and the limit
#   stays (PERF.md has the cut's reading and control).
TOL_LAYOUT_REL = {"long_oss_logits_vs_uniform": 0.4,
                  "long_rolling_logits_vs_full": 0.2}
# 17 (a) one Moonlight-width MLA layer (fp32, TF32 off) against a plain
#   fp32 MLA written from the published equations with HF's
#   permute-then-rotate_half rope (scores are invariant to the pairing, so
#   it checks the port's interleaved rope independently): the two sum in
#   other orders and take RoPE angles an fp32 ulp apart (~1e-6 of the
#   largest logit); 1e-4 of the largest logit leaves 100x, while the rope
#   head left unrotated (the control) or rotated at the wrong positions
#   moves the logits by whole percents.
TOL_MLA_PLAIN_REL = 1e-4
# 17 (d) the bf16 8-layer cut's teacher-forced decode logits against the
#   fp32 cut's on the same weights: relative RMS over every step; bf16
#   rounds every product (2^-9) and the sigmoid router over 64 experts
#   flips near-tie experts, compounding over the layers. Measured (NVIDIA
#   H100 80GB HBM3, 700 W): 0.161 over 31 steps (at most 0.310 in one
#   step); the control, the bf16 cut with the rope head's pairing flipped
#   (half instead of interleaved, the HF / reference convention mix-up),
#   0.929, and the rope head unrotated 0.872. The limit sits near the
#   geometric mean of reading and control, a factor 2.2 and 2.7 from
#   each.
TOL_MLA_BF16_REL = 0.35

# 18 (a) a quantized product on the card (fp32 in, TF32 off) against the
#   fp64 product of the dequantized weight: fp32 sums of 2880- to
#   14336-long products round at ~sqrt(K) x 6e-8 of the output's scale
#   (~1e-5 of the largest |y|); 1e-4 leaves 10x, while a scale applied
#   along the wrong axis (each check's control) moves outputs by whole
#   percents or more.
TOL_QUANT_PRODUCT_REL = 1e-4
# 18 (a) dequantize against the fp64 decode: int8 codes times an fp32
#   scale round once in fp32 (<= 2^-24 relative); MXFP4 values (two
#   significant bits times a power of two) are exact in bf16: 0.
TOL_DEQUANT_REL = 1e-6
# a control must part by more than this: 100x the product limit
TOL_QUANT_CONTROL_REL = 1e-2
# 18 (d) fp32 (TF32 off) 4-layer cuts: the quantized app and an
#   unquantized app holding its dequantized weights compute the same
#   function, except that an int8 / fp8 per-channel scale multiplies the
#   product instead of the weight (~1e-7 relative a product, ~1e-6 after
#   4 layers); MXFP4 and blockwise products dequantize first and run the
#   same GEMM. 1e-4 relative RMS of the teacher-forced logits leaves 100x;
#   the control (every scale flipped along its output axis) must part by
#   more than TOL_QUANT_CONTROL_REL.
TOL_QUANT_TWIN_REL = 1e-4
# 18 (e) full rank (2048) against the dense app at a 4-layer fp32 cut:
#   the fp32 SVD rebuilds each weight to ~1e-6 relative, ~1e-5 in the
#   logits after 4 layers; 1e-3 leaves 100x, while the same factors cut to
#   half rank (the control) drop half the spectrum (~0.5).
TOL_LOW_RANK_FULL_REL = 1e-3
# 19 (b), (c) a served bf16 stream against ``generate`` on the same app
#   and weights, fed the served tokens, in units of the step's logit std
#   over the vocabulary: the two batch rows differently (the engine mixes
#   prefill chunks and decode rows in one GEMM; generate runs rows
#   together), so bf16 rounding at full depth moves each logit by a
#   fraction of a std (phase 16's layout readings: relative RMS
#   0.04-0.19), and the served token may then sit below generate's top
#   logit by about that much where the two were close; a decode row
#   that rides a mixed pass also takes the gather path (probabilities
#   rounded to bf16) where generate's takes the kernel. A token the served
#   path chose wrongly (a wrong window, cap, rotation or norm) sits near
#   the random-token deficit, ~4.5 stds below the top of a 256K
#   vocabulary (the control, the next token id, reads it in each run).
#   Measured on Gemma-2-27B (NVIDIA H100 80GB HBM3, 700 W, 284 tokens):
#   max 1.68 stds, mean 0.10, argmax equal at 82% of the steps; control
#   mean 4.92. Each limit sits near the geometric mean of the reading and
#   the control: the worst token within 2.5 stds, the mean within 0.7.
TOL_SERVED_DEFICIT_BF16 = 2.5
TOL_SERVED_MEAN_DEFICIT_BF16 = 0.7
# 20 (b), (d): in an MoE model those rounding differences (the decode rows
#   of a mixed pass also take the ragged expert product, generate's T = 1
#   steps the dense all-experts one) reach the router, and where its k-th
#   and (k+1)-th expert scores are close the served pass may route a
#   token to another expert; with top-1 routing (Llama4) that token's
#   logits then move by whole stds. So a step beyond
#   TOL_SERVED_DEFICIT_BF16 passes only where the served pass's experts
#   at that token (recorded while serving, ServedRoutes) differ from
#   generate's at some MoE layer AND generate with the served experts
#   forced there puts the served token within TOL_SERVED_DEFICIT_BF16:
#   the flip must be seen and must account for the deficit. Every other
#   step keeps the limit, and the mean gate is unchanged. The reading
#   that called for it (Scout's 8-layer cut, NVIDIA H100 80GB HBM3,
#   700 W, 284 tokens): one step at 3.56 stds, position 8213 of the
#   8170-token request, where generate's top-1 router gap was 3.5e-4.
# 19 (d) the fp32 (TF32 off) cuts, kernel path against gather path on the
#   same weights and tokens: the paged kernel sums the same fp32 products
#   in another order (split-K online softmax against one softmax), ~1e-6
#   relative after 4 layers; 1e-4 relative RMS of the decode logits
#   leaves 100x, while a cap, window or rotation the kernel path dropped
#   moves them by whole percents.
TOL_DENSE_PATHS_FP32_REL = 1e-4
# 20 (c), (e) the fp32 (TF32 off) cuts, the paged app against the
#   contiguous app on the same weights and tokens: the same fp32 math in
#   other orders (the paged gather / the decode kernels against the
#   contiguous cache's reads), ~1e-6 relative after a few layers; 1e-4
#   relative RMS of the teacher-forced logits leaves 100x. 20 (e)'s clip
#   control must part by more than TOL_QUANT_CONTROL_REL (1e-2).
TOL_MOE_FAMILIES_PATHS_FP32_REL = 1e-4

# the H100 SXM data sheet's peaks, kept by the compiled-graph observatory
from neuronx_distributed_inference_tpu_torch.telemetry.observatory import \
    DEVICE_PEAKS  # noqa: E402

HBM_BYTES_PER_S = DEVICE_PEAKS["H100"]["hbm_gbps"] * 1e9
PEAK_FLOPS = {k: v * 1e12
              for k, v in DEVICE_PEAKS["H100"]["peak_tflops"].items()}


T_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line carries ``t_s``, the seconds since
    the script started."""
    if "phase" in obj:
        obj = dict(obj, t_s=round(time.perf_counter() - T_START, 3))
    print(json.dumps(obj), flush=True)


@contextlib.contextmanager
def fp32_exact():
    """TF32 off for an fp32 comparison; the previous flags come back
    after it."""
    import torch
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def bmm_out_dtype_available() -> bool:
    """Whether this torch multiplies bf16 into fp32 output on the card
    (``torch.bmm(..., out_dtype=torch.float32)``, the route of the bf16
    attention cores)."""
    import torch
    a = torch.ones((1, 2, 2), dtype=torch.bfloat16, device="cuda")
    try:
        out = torch.bmm(a, a, out_dtype=torch.float32)
    except (TypeError, RuntimeError, NotImplementedError):
        return False
    return out.dtype == torch.float32 and float(out[0, 0, 0]) == 2.0


def grouped_mm_available():
    """Whether this torch runs ``torch._grouped_mm`` (the MoE block's
    ragged product) on the card, per dtype, with a per-group loop's
    answer on two groups (one empty)."""
    import torch
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        a = torch.ones((4, 16), dtype=dt, device="cuda")
        w = torch.ones((3, 16, 8), dtype=dt, device="cuda")
        ends = torch.tensor([1, 1, 4], dtype=torch.int32, device="cuda")
        try:
            y = torch._grouped_mm(a, w, offs=ends)
        except (AttributeError, TypeError, RuntimeError,
                NotImplementedError):
            out[str(dt).replace("torch.", "")] = False
            continue
        out[str(dt).replace("torch.", "")] = bool((y.float() == 16).all())
    return out


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def build_kernels():
    """One nvcc per csrc/*.cu source, all started together."""
    import os
    from neuronx_distributed_inference_tpu_torch import _build
    names = sorted(f[:-3] for f in os.listdir(_build.CSRC_DIR)
                   if f.endswith(".cu"))
    with ThreadPoolExecutor(max_workers=len(names)) as ex:
        list(ex.map(_build.build, names))
    return {n: round(_build.BUILD_SECONDS[n], 2) for n in names}


def time_cuda(fn, calls: int = 100, reps: int = 7) -> float:
    """Device ms per call of ``fn``: ``calls`` calls captured in one CUDA
    graph, replayed ``reps`` times between CUDA events (median). The graph
    takes the host out of the measurement: eager calls of a small kernel
    wait on Python and launch latency, not on the card."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):                   # lazy init off the capture
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def time_eager(fn, calls: int = 200) -> float:
    """Host ms per call of ``fn`` called back to back, ending in a sync:
    what a caller pays, Python and launch overhead included."""
    import torch
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / calls


def time_host(fn, reps: int = 5) -> float:
    """Median ms of ``fn`` on the host clock; ``fn`` ends in a sync."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


# ---------------------------------------------------------------------------
# Phase 2: kernel against twin
# ---------------------------------------------------------------------------

def paged_inputs(gen, device, *, b, hq, hkv, d, bs, mb, lens, layers=1,
                 act_dtype, page_dtype, kv_scale=None):
    """Random q / new_k / new_v and a stacked page cache with each row's
    live pages scattered through a random block table (block 0 = null)."""
    import torch
    n = 1 + b * mb

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device)
    pages = []
    for _ in range(2):
        p = rnd(layers, n, bs, hkv, d)
        if kv_scale is not None:
            p = p / kv_scale
        pages.append(p.to(page_dtype))
    perm = torch.randperm(n - 1, generator=gen, device=device)[:b * mb] + 1
    table = torch.zeros((b, mb), dtype=torch.int32, device=device)
    for i, ln in enumerate(lens):
        live = -(-(int(ln) + 1) // bs)
        table[i, :live] = perm[i * mb:i * mb + live].to(torch.int32)
    return dict(q=rnd(b, hq, d).to(act_dtype), k_pages=pages[0],
                v_pages=pages[1], new_k=rnd(b, hkv, d).to(act_dtype),
                new_v=rnd(b, hkv, d).to(act_dtype),
                lens=torch.tensor(lens, dtype=torch.int32, device=device),
                block_table=table)


def kernel_cases(device):
    """(name, inputs, kwargs, tolerance) over the TPU kernel's test matrix
    at the serving path's shapes."""
    import torch
    gen = torch.Generator(device=device).manual_seed(1)
    slice_lens = [0, 1, 31, 32, 333, 1000, 1777, 2047]
    cases = []
    for dt, tol in ((torch.bfloat16, TOL_KERNEL_BF16),
                    (torch.float32, TOL_KERNEL_FP32)):
        tag = "bf16" if dt == torch.bfloat16 else "fp32"
        cases.append((f"llama3.2-1b_{tag}", paged_inputs(
            gen, device, b=8, hq=32, hkv=8, d=64, bs=32, mb=64,
            lens=slice_lens, act_dtype=dt, page_dtype=dt),
            dict(scale=64 ** -0.5), tol))
        cases.append((f"llama3.1-8b_{tag}", paged_inputs(
            gen, device, b=8, hq=32, hkv=8, d=128, bs=32, mb=64,
            lens=slice_lens, act_dtype=dt, page_dtype=dt),
            dict(scale=128 ** -0.5), tol))
    sink = torch.randn((32,), generator=gen, device=device)
    cases.append(("window_sink_softcap_bf16", paged_inputs(
        gen, device, b=8, hq=32, hkv=8, d=64, bs=32, mb=64, lens=slice_lens,
        act_dtype=torch.bfloat16, page_dtype=torch.bfloat16),
        dict(scale=64 ** -0.5, window=100, sink=sink, soft_cap=5.0),
        TOL_KERNEL_BF16))
    cases.append(("stacked_layers_bf16", paged_inputs(
        gen, device, b=8, hq=32, hkv=8, d=64, bs=32, mb=64, lens=slice_lens,
        layers=3, act_dtype=torch.bfloat16, page_dtype=torch.bfloat16),
        dict(scale=64 ** -0.5, layer=2), TOL_KERNEL_BF16))
    cases.append(("fp8_e4m3_pages_kv_scale", paged_inputs(
        gen, device, b=8, hq=32, hkv=8, d=64, bs=32, mb=64, lens=slice_lens,
        act_dtype=torch.bfloat16, page_dtype=torch.float8_e4m3fn,
        kv_scale=0.5), dict(scale=64 ** -0.5, kv_scale=0.5),
        TOL_KERNEL_BF16))
    return cases


def check_kernel_against_twin(inputs, kw):
    """max |kernel - twin| for one input set (both on the card)."""
    import torch
    from neuronx_distributed_inference_tpu_torch.ops import decode_attention
    kw = dict(kw)
    layer = kw.pop("layer", 0)
    args = (inputs["q"], inputs["k_pages"], inputs["v_pages"],
            inputs["new_k"], inputs["new_v"], layer, inputs["lens"],
            inputs["block_table"])
    got = decode_attention.paged_decode_attention(*args, **kw)
    torch.cuda.synchronize()
    want = decode_attention.paged_decode_attention_plain(*args, **kw)
    err = (got.float() - want.float()).abs().max().item()
    if not torch.isfinite(got.float()).all():
        raise AssertionError("kernel output is not finite")
    return err


def contiguous_inputs(gen, device, *, b, hq, hkv, d, s, lens, layers=1,
                      act_dtype, cache_dtype, kv_scale=None):
    """Random q / new_k / new_v and a stacked contiguous cache, K
    transposed (L, B, Hkv, D, S) and V (L, B, Hkv, S, D)."""
    import torch

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device)
    caches = []
    for shape in ((layers, b, hkv, d, s), (layers, b, hkv, s, d)):
        c = rnd(*shape)
        if kv_scale is not None:
            c = c / kv_scale
        caches.append(c.to(cache_dtype))
    return dict(q=rnd(b, hq, d).to(act_dtype), k_cache=caches[0],
                v_cache=caches[1], new_k=rnd(b, hkv, d).to(act_dtype),
                new_v=rnd(b, hkv, d).to(act_dtype),
                lens=torch.tensor(lens, dtype=torch.int32, device=device))


def decode_cases(device):
    """(name, inputs, kwargs, tolerance) for the contiguous decode kernel
    at Mistral-7B shapes (Hq 32, Hkv 8, D 128, S 4096, batch 4)."""
    import torch
    gen = torch.Generator(device=device).manual_seed(3)
    lens = [0, 517, 2048, 4095]
    mk = dict(b=4, hq=32, hkv=8, s=MISTRAL_SEQ, lens=lens)
    cases = []
    for dt, tol in ((torch.bfloat16, TOL_KERNEL_BF16),
                    (torch.float32, TOL_KERNEL_FP32)):
        tag = "bf16" if dt == torch.bfloat16 else "fp32"
        cases.append((f"mistral-7b_L2_{tag}", contiguous_inputs(
            gen, device, d=128, layers=2, act_dtype=dt, cache_dtype=dt,
            **mk), dict(scale=128 ** -0.5, layer=1), tol))
    cases.append(("d64_bf16", contiguous_inputs(
        gen, device, d=64, act_dtype=torch.bfloat16,
        cache_dtype=torch.bfloat16, **mk), dict(scale=64 ** -0.5),
        TOL_KERNEL_BF16))
    sink = torch.randn((32,), generator=gen, device=device)
    cases.append(("window1024_sink_softcap_bf16", contiguous_inputs(
        gen, device, d=128, act_dtype=torch.bfloat16,
        cache_dtype=torch.bfloat16, **mk),
        dict(scale=128 ** -0.5, window=1024, sink=sink, soft_cap=5.0),
        TOL_KERNEL_BF16))
    cases.append(("fp8_e4m3_cache_kv_scale", contiguous_inputs(
        gen, device, d=128, act_dtype=torch.bfloat16,
        cache_dtype=torch.float8_e4m3fn, kv_scale=0.5, **mk),
        dict(scale=128 ** -0.5, kv_scale=0.5), TOL_KERNEL_BF16))
    # S not a multiple of a 16-byte piece's keys: K loaded key by key
    cases.append(("s4095_bf16", contiguous_inputs(
        gen, device, d=128, act_dtype=torch.bfloat16,
        cache_dtype=torch.bfloat16, **dict(mk, s=MISTRAL_SEQ - 1)),
        dict(scale=128 ** -0.5, window=1024), TOL_KERNEL_BF16))
    return cases


def decode_args(inputs, kw):
    kw = dict(kw)
    layer = kw.pop("layer", 0)
    return (inputs["q"], inputs["k_cache"], inputs["v_cache"],
            inputs["new_k"], inputs["new_v"], layer, inputs["lens"]), kw


def check_decode_against_twin(inputs, kw):
    import torch
    from neuronx_distributed_inference_tpu_torch.ops import decode_attention
    args, kw = decode_args(inputs, kw)
    got = decode_attention.decode_attention_stacked(*args, **kw)
    torch.cuda.synchronize()
    want = decode_attention.decode_attention_stacked_plain(*args, **kw)
    if not torch.isfinite(got.float()).all():
        raise AssertionError("kernel output is not finite")
    return (got.float() - want.float()).abs().max().item()


def flash_cases(device):
    """(name, inputs, kwargs, tolerance) for the flash prefill kernel at
    Mistral-7B shapes (Hq 32, Hkv 8)."""
    import torch
    gen = torch.Generator(device=device).manual_seed(4)

    def qkv(b, s, d, dt):
        return {n: torch.randn((b, s, h, d), generator=gen,
                               device=device).to(dt)
                for n, h in (("q", 32), ("k", 8), ("v", 8))}
    bf = torch.bfloat16
    return [
        ("b2_s2048_d128_bf16", qkv(2, 2048, 128, bf),
         dict(scale=128 ** -0.5), tol_flash_bf16),
        ("window512_bf16", qkv(2, 2048, 128, bf),
         dict(scale=128 ** -0.5, window=512), tol_flash_bf16),
        ("softcap30_bf16", qkv(2, 2048, 128, bf),
         dict(scale=128 ** -0.5, soft_cap=30.0), tol_flash_bf16),
        ("d64_bf16", qkv(2, 2048, 64, bf), dict(scale=64 ** -0.5),
         tol_flash_bf16),
        ("s512_fp32", qkv(2, 512, 128, torch.float32),
         dict(scale=128 ** -0.5), TOL_KERNEL_FP32),
        ("s128_one_tile_bf16", qkv(4, 128, 128, bf),
         dict(scale=128 ** -0.5), tol_flash_bf16),
        ("window200_bf16", qkv(2, 2048, 128, bf),
         dict(scale=128 ** -0.5, window=200), tol_flash_bf16),
        ("softcap30_window200_bf16", qkv(2, 2048, 128, bf),
         dict(scale=128 ** -0.5, window=200, soft_cap=30.0),
         tol_flash_bf16),
        ("d64_window200_bf16", qkv(2, 1024, 64, bf),
         dict(scale=64 ** -0.5, window=200), tol_flash_bf16),
    ]


def check_flash_against_twin(inputs, kw):
    import torch
    from neuronx_distributed_inference_tpu_torch.ops import flash_attention
    args = (inputs["q"], inputs["k"], inputs["v"])
    got = flash_attention.flash_attention(*args, **kw)
    torch.cuda.synchronize()
    want = flash_attention.flash_attention_plain(*args, **kw)
    if not torch.isfinite(got.float()).all():
        raise AssertionError("kernel output is not finite")
    return (got.float() - want.float()).abs().max().item()


def check_fused_merge(phase, call, plain, splits_attr):
    """A fused decode kernel's merge: ``call()`` 3 times eagerly and 10
    times in one CUDA graph replayed twice gives the first output bit for
    bit (the merging block puts its counter back to 0), the counters end
    at 0, and every split count 1 to 64 (the wrapper's ``splits_attr``
    overridden) agrees with ``plain()``, the twin."""
    import torch
    from neuronx_distributed_inference_tpu_torch.ops import decode_attention
    first = call()
    same = [torch.equal(call(), first) for _ in range(2)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [call() for _ in range(10)]
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        same += [torch.equal(o, first) for o in outs]
    zero = int(decode_attention.merge_counters(first.device, 32).abs()
               .sum()) == 0
    want = plain()
    num_splits = getattr(decode_attention, splits_attr)
    errs = []
    try:
        for n in range(1, 65):
            setattr(decode_attention, splits_attr, lambda *a, n=n: n)
            errs.append((call().float() - want.float()).abs().max().item())
    finally:
        setattr(decode_attention, splits_attr, num_splits)
    emit({"phase": phase, "calls_identical": sum(same),
          "calls": len(same), "counters_zero": zero,
          "splits_checked": len(errs), "max_abs_err_over_splits": max(errs),
          "tol": TOL_KERNEL_BF16})
    if not (all(same) and zero and max(errs) <= TOL_KERNEL_BF16):
        raise AssertionError(f"{phase}: eager / graph outputs differ, "
                             "counters not reset, or a split count "
                             "disagrees with the twin")


def check_fused_merges(device):
    """Both decode kernels' fused merges (:func:`check_fused_merge`), each
    at its main path's decode shapes: paged B 4, Hq 32, Hkv 8, D 64, lens
    100/363/963/1563; contiguous B 4, Hq 32, Hkv 8, D 128, S 4096, lens
    100/363/963/1963; bf16."""
    import torch
    from neuronx_distributed_inference_tpu_torch.ops import decode_attention
    gen = torch.Generator(device=device).manual_seed(6)
    x = paged_inputs(gen, device, b=4, hq=32, hkv=8, d=64, bs=32, mb=64,
                     lens=[100, 363, 963, 1563], act_dtype=torch.bfloat16,
                     page_dtype=torch.bfloat16)
    args = (x["q"], x["k_pages"], x["v_pages"], x["new_k"], x["new_v"], 0,
            x["lens"], x["block_table"])
    check_fused_merge(
        "paged_fused_merge",
        lambda: decode_attention.paged_decode_attention(*args, scale=0.125),
        lambda: decode_attention.paged_decode_attention_plain(*args,
                                                              scale=0.125),
        "num_splits")
    gen = torch.Generator(device=device).manual_seed(7)
    x = contiguous_inputs(gen, device, b=4, hq=32, hkv=8, d=128,
                          s=MISTRAL_SEQ, lens=[100, 363, 963, 1963],
                          act_dtype=torch.bfloat16,
                          cache_dtype=torch.bfloat16)
    cargs, kw = decode_args(x, dict(scale=128 ** -0.5))
    check_fused_merge(
        "contiguous_fused_merge",
        lambda: decode_attention.decode_attention_stacked(*cargs, **kw),
        lambda: decode_attention.decode_attention_stacked_plain(*cargs,
                                                                **kw),
        "contiguous_num_splits")


KERNEL_NAMES = ("paged_decode_attention", "decode_attention_stacked",
                "flash_attention")


def reset_launches(apps=()):
    """Set every kernel's launch count to 0, and the graph replay counts
    of ``apps``."""
    from neuronx_distributed_inference_tpu_torch.models.cuda_graphs import \
        KERNELS
    for w in KERNELS.values():
        w.launches = 0
    for app in apps:
        if app.graphs is not None:
            app.graphs.reset_counts()


def kernel_counts(apps=()):
    """Each kernel's launches since :func:`reset_launches`: the eager
    launches its wrapper counted plus, for each app, its graphs' replays
    times the launches each graph holds."""
    from neuronx_distributed_inference_tpu_torch.models.cuda_graphs import \
        KERNELS
    return {name: KERNELS[name].launches + sum(
        app.graphs.replayed_launches(name) for app in apps
        if app.graphs is not None) for name in KERNEL_NAMES}


def graph_report(app):
    """The app's captured graphs: replays by signature and the kernel
    launches each holds, and its steady-state incidents."""
    g = app.graphs
    return {"captured": len(g),
            "replays": {str(k): n for k, n in g.replays.items()},
            "launches_per_replay": {str(k): g.kernel_launches(k)
                                    for k in g.signatures()},
            "incidents": app.warmup_state()["incidents"]}


def warm(app, phase, **kw):
    """``precompile`` the app (graphs for every T = 1 signature); emits
    the report's summary."""
    from neuronx_distributed_inference_tpu_torch.serving.warmup import \
        precompile
    rep = precompile(app, **kw)
    emit({"phase": phase + "_precompile", "n_graphs": rep["n_graphs"],
          "n_captured": rep["n_compiles"], "n_eager": rep["n_cache_loads"],
          "seconds": rep["total_seconds"],
          "captured": [[g["kind"], g["bucket"], round(g["seconds"], 3)]
                       for g in rep["graphs"] if g["outcome"] == "capture"]})
    if app.device.type == "cuda" and rep["n_compiles"] == 0:
        raise AssertionError(f"{phase}: precompile captured no graph")
    return rep


def check_no_incidents(phase, app):
    inc = app.warmup_state()["incidents"]
    if inc:
        raise AssertionError(f"{phase}: {len(inc)} steady-state incidents: "
                             f"{inc[:3]}")


def phase_kernels(device):
    with fp32_exact():
        return _phase_kernels(device)


def _phase_kernels(device):
    import torch
    results = {}
    for kernel, cases, check in (
            ("paged_decode_attention", kernel_cases, check_kernel_against_twin),
            ("decode_attention_stacked", decode_cases,
             check_decode_against_twin),
            ("flash_attention", flash_cases, check_flash_against_twin)):
        for name, inputs, kw, tol in cases(device):
            if callable(tol):
                tol = tol(inputs)
            err = check(inputs, kw)
            results[(kernel, name)] = err
            emit({"phase": "kernel_vs_twin", "kernel": kernel, "case": name,
                  "max_abs_err": err, "tol": tol})
            if not err <= tol:
                raise AssertionError(f"{kernel} {name}: max abs err {err} "
                                     f"> {tol}")
        torch.cuda.empty_cache()
    check_fused_merges(device)
    # comparison launches are not main-path launches
    reset_launches()
    return results


# ---------------------------------------------------------------------------
# Phase 3: main path
# ---------------------------------------------------------------------------

def mesh_degrees(mesh):
    """The TpuConfig degrees of ``mesh``: ``tp_degree`` counts every rank
    (dp·cp·ep·tp, as ``mesh_from_config`` reads it), and the cp, dp and ep
    extents; one rank without a mesh."""
    if mesh is None:
        return dict(tp_degree=1)
    return dict(tp_degree=mesh.size, ep_degree=mesh.ep, cp_degree=mesh.cp,
                attention_dp_degree=mesh.dp)


def make_app(hf, device, dtype, *, batch, seq_len, kernel=None,
             prefix_caching=True, output_logits=False, num_blocks=None,
             graphs=True, sampling=None, mesh=None, **tcfg_over):
    """A paged app of ``hf``'s geometry (``tcfg_over``: more TpuConfig
    fields, e.g. quantization or the KV cache dtype; ``mesh``: one rank of
    a mesh, at its degrees: :func:`mesh_degrees`)."""
    from neuronx_distributed_inference_tpu_torch.config import (
        OnDeviceSamplingConfig, TpuConfig)
    from neuronx_distributed_inference_tpu_torch.models.application import \
        PagedCausalLMApplication
    from neuronx_distributed_inference_tpu_torch.models.family import \
        get_family
    family = get_family(hf["model_type"])
    tcfg = TpuConfig(batch_size=batch, seq_len=seq_len, dtype=dtype,
                     is_block_kv_layout=True, pa_block_size=32,
                     pa_num_blocks=num_blocks,
                     is_prefix_caching=prefix_caching,
                     output_logits=output_logits,
                     attn_block_tkg_kernel_enabled=kernel,
                     on_device_sampling_config=(
                         OnDeviceSamplingConfig(**sampling) if sampling
                         else None),
                     **mesh_degrees(mesh), **tcfg_over)
    app = PagedCausalLMApplication(None, family.config_cls(tcfg, **hf),
                                   family, device=device, cuda_graphs=graphs,
                                   mesh=mesh)
    return app.init_cache()


def prompts_of(lens, vocab, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    width = max(lens)
    ids = np.zeros((len(lens), width), np.int64)
    mask = np.zeros((len(lens), width), np.int64)
    for i, n in enumerate(lens):
        ids[i, :n] = rng.integers(1, vocab, size=n)
        mask[i, :n] = 1
    return ids, mask


def init_weights(app, seed):
    """``init_random_weights(seed)``, then the leaves it leaves at zero
    drawn from the seed too, so their paths carry values: learned sinks
    N(0, 1), every bias (q/k/v, o, MLP, router, experts, the block and
    q/k norms') N(0, 0.02), in each layer stack (a mixed stack's
    ``moe_layers`` after ``layers``), then the final norm's, the
    embeddings' norm's and the lm-head's biases N(0, 0.02); ALiBi slopes
    (zeros in the random tree, as in the reference's) are the model's
    published ones. A model without such leaves keeps
    ``init_random_weights``' values. On a rank of a mesh each redrawn leaf
    is drawn whole and cut to the rank's slice (and its hybrid decode
    copy), so every rank holds the slice of the tp = 1 draw."""
    import torch
    from neuronx_distributed_inference_tpu_torch.models import model_base
    from neuronx_distributed_inference_tpu_torch.ops.attention import \
        alibi_slopes
    app.init_random_weights(seed)
    gen = torch.Generator(device=app.device).manual_seed(seed + 1)
    mesh = app.mesh if app.mesh is not None and app.mesh.mp > 1 else None
    specs = model_base.decoder_param_specs(app.full_spec) if mesh else {}

    def redraw(leaf, ps, std, name=None, node=None):
        if mesh is None:
            leaf.normal_(0.0, std, generator=gen)
            return
        full = torch.empty(ps.shape, dtype=leaf.dtype, device=leaf.device)
        full.normal_(0.0, std, generator=gen)
        # the rank's slice, and its hybrid decode copy where it has one
        for k, v in model_base.rank_leaves(app.full_spec, name, ps, full,
                                           mesh).items():
            (node[k] if node is not None else leaf).copy_(v)
    for stack in ("layers", "moe_layers"):
        layers = app.params.get(stack, {})
        for name in sorted(layers):
            if name == "sink":
                redraw(layers[name], specs.get(stack, {}).get(name), 1.0,
                       name, layers)
            elif name.endswith(("bias", "norm_b")):
                redraw(layers[name], specs.get(stack, {}).get(name), 0.02,
                       name, layers)
            elif name == "alibi_slopes":
                layers[name].copy_(torch.from_numpy(alibi_slopes(
                    layers[name].shape[1])).expand_as(layers[name]))
    for name in ("final_norm_b", "embed_norm_b", "lm_head_b"):
        if name in app.params:
            redraw(app.params[name], specs.get(name), 0.02, name,
                   app.params)
    return app


def phase_main_path(hf, device, on_card=True):
    import numpy as np
    app = make_app(hf, device, "bfloat16", batch=len(PROMPT_LENS),
                   seq_len=2048, output_logits=True)
    app.init_random_weights(0)
    ids, mask = prompts_of(PROMPT_LENS, hf["vocab_size"], seed=0)
    warm(app, "main_path")
    reset_launches([app])
    t0 = time.perf_counter()
    out = app.generate(ids, attention_mask=mask, max_new_tokens=NEW_TOKENS,
                       return_logits=True)
    gen_s = time.perf_counter() - t0
    launches = kernel_counts([app])["paged_decode_attention"]
    decode_steps = NEW_TOKENS - 1
    want = hf["num_hidden_layers"] * decode_steps if on_card else 0
    emit({"phase": "main_path", "generate_s": gen_s, "launches": launches,
          "expected_launches": want, "decode_steps": decode_steps,
          "graphs": graph_report(app),
          "generated_shape": list(out["generated"].shape)})
    check_no_incidents("main_path", app)
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != layers x "
                             f"decode steps {want}")
    gen = out["generated"]
    if gen.shape != (len(PROMPT_LENS), NEW_TOKENS) or not (
            (gen >= 0) & (gen < hf["vocab_size"])).all():
        raise AssertionError(f"bad generated tokens {gen.shape}")

    # the gather path, same weights, fed the kernel app's tokens
    ref = make_app(hf, device, "bfloat16", batch=len(PROMPT_LENS),
                   seq_len=2048, kernel=False, output_logits=True)
    ref.params = app.params
    ref_out = ref.generate(ids, attention_mask=mask,
                           max_new_tokens=NEW_TOKENS, return_logits=True,
                           teacher_tokens=gen[:, :decode_steps])
    errs = []
    for step in range(1, NEW_TOKENS):
        a, b = out["logits"][step], ref_out["logits"][step]
        if not np.isfinite(a).all():
            raise AssertionError(f"non-finite logits at decode step {step}")
        errs.append(float(np.abs(a - b).max()))
    worst = max(errs)
    emit({"phase": "main_path_vs_gather", "decode_steps_compared":
          len(errs), "max_abs_logit_diff": worst,
          "mean_step_max_diff": float(np.mean(errs)),
          "ref_logit_std": float(np.std(ref_out["logits"][1])),
          "tol": TOL_LOGITS_BF16})
    if not worst <= TOL_LOGITS_BF16:
        raise AssertionError(f"decode logits differ from the gather path "
                             f"by {worst} > {TOL_LOGITS_BF16}")
    return app, ids, mask, launches


# ---------------------------------------------------------------------------
# Phase 4: serving through the adapter, fp32
# ---------------------------------------------------------------------------

def near_tie_check(phase, s, got, want, prompt_len):
    """The first difference of a served stream from the reference
    ``generate`` (``want`` with per-step logits) is accepted only where the
    served token's logit sits within NEAR_TIE of the reference's top one
    (a near-tie); returns the case or None."""
    import numpy as np
    exp = want["generated"][0]
    diff = np.nonzero(got != exp)[0]
    if not diff.size:
        return None
    i = int(diff[0])
    # step 0 is the prefill: its logits cover the whole window
    lg = want["logits"][i][0, prompt_len - 1 if i == 0 else 0]
    lg = np.asarray(lg, np.float64)
    margin = float(lg.max() - lg[got[i]])
    case = {"seq_id": s, "first_diff_step": i, "margin": margin}
    emit({"phase": phase, **case, "bound": NEAR_TIE})
    if not margin < NEAR_TIE:
        raise AssertionError(f"stream {s} differs from generate at step {i}, "
                             f"its token {margin} below the top logit")
    return case


def serve_staggered(eng, prompts):
    """Admit prompts 0-1 at step 0, 2-3 at step 8, 4-5 at step 16; release
    each stream once it holds SERVE_TOKENS tokens. Returns (streams,
    engine steps)."""
    streams = {i: [] for i in range(len(prompts))}
    admit_at = {0: (0, 1), 8: (2, 3), 16: (4, 5)}
    step = 0
    while True:
        if step in admit_at:
            sids = list(admit_at[step])
            first = eng.add_requests(sids, [prompts[s] for s in sids])
            for s, t in first.items():
                streams[s].append(t)
        done = [s for s in eng.seqs if len(streams[s]) >= SERVE_TOKENS]
        if done:
            eng.release(done)
        if not eng.seqs and step > max(admit_at):
            break
        for s, t in eng.step().items():
            streams[s].append(t)
        step += 1
    return streams, step


def phase_serving(hf, device):
    with fp32_exact():
        _phase_serving(hf, device)


def _phase_serving(hf, device):
    import numpy as np
    from neuronx_distributed_inference_tpu_torch.serving import \
        PagedEngineAdapter
    app = make_app(hf, device, "float32", batch=8, seq_len=512)
    app.init_random_weights(0)
    ref = make_app(hf, device, "float32", batch=1, seq_len=512,
                   output_logits=True)
    ref.params = app.params
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, hf["vocab_size"], size=n).tolist()
               for n in SERVE_LENS]
    eng = PagedEngineAdapter(app)
    streams, step = serve_staggered(eng, prompts)
    near_ties = []
    for s, prompt in enumerate(prompts):
        want = ref.generate(np.asarray([prompt]),
                            max_new_tokens=SERVE_TOKENS, return_logits=True)
        ref.reset()
        case = near_tie_check("serving_near_tie", s,
                              np.asarray(streams[s][:SERVE_TOKENS]), want,
                              len(prompt))
        if case:
            near_ties.append(case)
    emit({"phase": "serving", "requests": len(prompts),
          "tokens_per_stream": SERVE_TOKENS, "engine_steps": step,
          "streams_identical": len(prompts) - len(near_ties),
          "near_ties": len(near_ties), "host_stats": eng.host_stats})


# ---------------------------------------------------------------------------
# Phase 5: timings
# ---------------------------------------------------------------------------

def kernel_bounds(inputs, window=0, sink=False):
    """Least time for the kernel's work on the H100: bytes (the live K/V
    rows, those inside each row's window when ``window`` > 0, q,
    new_k/new_v, out, lens, the table entries of the live pages, the
    sinks) over the HBM rate, and operations (QK and PV over the live keys
    plus the active token) over the peak rate of the page type; returns
    (ms, "bytes"|"operations")."""
    q, kp = inputs["q"], inputs["k_pages"]
    b, hq, d = q.shape
    bs, hkv = kp.shape[2], kp.shape[3]
    lens = [int(x) for x in inputs["lens"].tolist()]
    # the kernel reads prior keys kpos < lens with lens - kpos < window
    live = [min(n, window - 1) if window > 0 else n for n in lens]
    keys = sum(live)
    kv_bytes = 2 * keys * hkv * d * kp.element_size()
    act_bytes = (2 * b * hq * d + 2 * b * hkv * d) * q.element_size()
    pages = sum((n - 1) // bs - (n - k) // bs + 1
                for n, k in zip(lens, live) if k > 0)
    meta_bytes = 4 * b + 4 * pages + (4 * hq if sink else 0)
    bytes_ms = (kv_bytes + act_bytes + meta_bytes) / HBM_BYTES_PER_S * 1e3
    flops = 4 * (keys + b) * hq * d
    rate = PEAK_FLOPS.get(str(kp.dtype).replace("torch.", ""),
                          PEAK_FLOPS["bfloat16"])
    ops_ms = flops / rate * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                           "operations")


def sdpa_inputs(inputs, layer):
    """The same attention pre-gathered contiguously for
    ``scaled_dot_product_attention`` (the active token at slot lens[b])."""
    import torch
    kp, vp, table = inputs["k_pages"], inputs["v_pages"], inputs[
        "block_table"]
    b, hq, d = inputs["q"].shape
    mb, bs, hkv = table.shape[1], kp.shape[2], kp.shape[3]
    k = kp[layer][table.long()].reshape(b, mb * bs, hkv, d).clone()
    v = vp[layer][table.long()].reshape(b, mb * bs, hkv, d).clone()
    rows = torch.arange(b, device=k.device)
    lens = inputs["lens"].long()
    k[rows, lens] = inputs["new_k"]
    v[rows, lens] = inputs["new_v"]
    pos = torch.arange(mb * bs, device=k.device)[None, :]
    mask = (pos <= lens[:, None])[:, None, None, :]
    return (inputs["q"][:, :, None, :], k.transpose(1, 2).contiguous(),
            v.transpose(1, 2).contiguous(), mask)


def sdpa_window_inputs(inputs, layer, window, sink):
    """The paged attention with a window and a sink for
    ``scaled_dot_product_attention``: each row's keys inside its window
    (all of them when ``window`` is 0) pre-gathered from the pages, the
    active token last, left-padded to the longest row, then (with a
    ``sink``; None: no column) one zero key and zero value column whose
    additive float mask is the head's sink logit (it joins the denominator
    only). Returns (q (B, Hq, 1, D), k, v (B, Hkv, n + 1, D), mask (B, Hq,
    1, n + 1)), n + 1 -> n without a sink."""
    import torch
    kp, vp, table = inputs["k_pages"], inputs["v_pages"], inputs[
        "block_table"]
    q = inputs["q"]
    b, hq, d = q.shape
    bs, hkv = kp.shape[2], kp.shape[3]
    lens = inputs["lens"].long()
    longest = int(lens.max()) + 1
    n = min(window, longest) if window > 0 else longest
    pos = lens[:, None] - (n - 1) + torch.arange(n, device=q.device)[None]
    valid = pos >= 0
    if window > 0:
        valid &= lens[:, None] - pos < window
    rows = torch.arange(b, device=q.device)[:, None]
    slot = pos.clamp(min=0)
    page = table.long()[rows, slot // bs]
    k = kp[layer][page, slot % bs].to(q.dtype)           # (B, n, Hkv, D)
    v = vp[layer][page, slot % bs].to(q.dtype)
    k[:, -1] = inputs["new_k"]
    v[:, -1] = inputs["new_v"]
    extra = 0 if sink is None else 1
    zero = torch.zeros((b, extra, hkv, d), dtype=q.dtype, device=q.device)
    k = torch.cat([k, zero], 1).transpose(1, 2).contiguous()
    v = torch.cat([v, zero], 1).transpose(1, 2).contiguous()
    mask = torch.zeros((b, hq, 1, n + extra), dtype=q.dtype,
                       device=q.device)
    mask[..., :n].masked_fill_(~valid[:, None, None, :], float("-inf"))
    if sink is not None:
        mask[..., n] = sink.to(q.dtype)[None, :, None]
    return q[:, :, None, :], k, v, mask


def contiguous_sdpa_inputs(inputs, layer, window=0):
    """The contiguous decode attention for ``scaled_dot_product_attention``
    (no sink, soft-cap or kv_scale; each lens[b] < S): K and V of layer
    ``layer`` as (B, Hkv, S, D) copies with the last dimension contiguous
    (SDPA's fused backends need stride(-1) == 1; the cache holds K
    transposed), the active token at slot lens[b], and a boolean mask of
    the keys at or before it (within ``window`` when it is > 0)."""
    import torch
    k = inputs["k_cache"][layer].transpose(2, 3).contiguous()
    v = inputs["v_cache"][layer].clone()
    b, s = k.shape[0], k.shape[2]
    rows = torch.arange(b, device=k.device)
    lens = inputs["lens"].long()
    k[rows, :, lens] = inputs["new_k"].to(k.dtype)
    v[rows, :, lens] = inputs["new_v"].to(v.dtype)
    pos = torch.arange(s, device=k.device)[None, :]
    live = pos <= lens[:, None]
    if window > 0:
        live &= lens[:, None] - pos < window
    return inputs["q"][:, :, None, :], k, v, live[:, None, None, :]


def device_kernels(fn):
    """(host ms, {kernel name: device ms}) of one ``fn()`` traced with
    ``torch.profiler`` (CUDA activity only)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    per = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0) or 0
        if us > 0:
            per[ev.key] = per.get(ev.key, 0.0) + us / 1e3
    return wall, per


def profile_decode(prefill_only, prefill_and_decode, steps: int):
    """Device time by kernel and the device's idle share over ``steps``
    decode steps: the trace of prefill + decode minus the trace of the
    prefill alone."""
    try:
        w0, p0 = device_kernels(prefill_only)
        w1, p1 = device_kernels(prefill_and_decode)
    except RuntimeError as e:        # the profiler is optional equipment
        emit({"phase": "decode_profile", "measured": False,
              "reason": str(e)[:200]})
        return
    busy = sum(p1.values()) - sum(p0.values())
    wall = w1 - w0
    per_step = {n: (p1[n] - p0.get(n, 0.0)) / steps for n in p1}
    top = sorted(per_step.items(), key=lambda kv: -kv[1])[:8]
    emit({"phase": "decode_profile", "measured": busy > 0,
          "steps": steps, "host_ms_per_step": wall / steps,
          "device_busy_ms_per_step": busy / steps,
          "device_idle_share": (1 - busy / wall) if busy > 0 else None,
          "top_kernels_ms_per_step": [[n[:80], ms] for n, ms in top],
          "prefill": profile_summary_of(w0, p0)})


def profile_summary_of(wall, per, n=8):
    """Host ms, device busy ms, idle share and the top ``n`` kernels of
    one :func:`device_kernels` trace."""
    busy = sum(per.values())
    return {"host_ms": wall, "device_busy_ms": busy,
            "device_idle_share": (1 - busy / wall) if busy > 0 else None,
            "top_kernels_ms": [[k[:80], ms] for k, ms in sorted(
                per.items(), key=lambda kv: -kv[1])[:n]]}


def phase_timings(hf, device, app, ids, mask, launches):
    b = len(PROMPT_LENS)
    timing_app = make_app(hf, device, "bfloat16", batch=b, seq_len=2048,
                          prefix_caching=False)
    timing_app.params = app.params
    warm(timing_app, "timings")

    def gen(n):
        timing_app.generate(ids, attention_mask=mask, max_new_tokens=n)
        timing_app.reset()
    prefill_ms = time_host(lambda: gen(1))
    k = 32
    decode_ms = (time_host(lambda: gen(1 + k)) - prefill_ms) / k
    profile_decode(lambda: gen(1), lambda: gen(1 + k), k)
    check_no_incidents("timings", timing_app)

    # the kernel at the main path's decode shapes, over the main path's
    # own cache and tables (positions after its last decode step)
    pos = [n + NEW_TOKENS - 1 for n in PROMPT_LENS]
    table = app.kv_mgr.block_table_array(range(b), app._bt_width(b))
    t = time_paged_kernel(app, table, pos, device, seed=2)
    emit({"phase": "timings", "prefill_ms_per_prompt": prefill_ms / b,
          "prefill_ms_batch": prefill_ms, "prompt_lens": list(PROMPT_LENS),
          "decode_ms_per_step_batch4": decode_ms, **t["report"],
          "launches": launches})
    return [paged_kernel_entry(t, launches, "paged_generate")]


def time_paged_kernel(app, table, pos, device, seed: int, layer=None):
    """The paged kernel over ``app``'s own cache and block ``table`` at
    lens ``pos`` (``layer``, default the last, with that layer's window,
    sink and attention soft-cap; random q and active token): held to its
    twin, then timed by CUDA-graph replay beside the twin, SDPA over the
    pre-gathered KV (with the window and the sink column where the layer
    has them; no library call takes the soft-cap, so SDPA runs without
    it) and the bound."""
    import torch
    import torch.nn.functional as F
    from neuronx_distributed_inference_tpu_torch.ops import decode_attention
    spec = app.spec
    b = len(pos)
    gen_t = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen_t,
                           device=device).to(torch.bfloat16)
    # the cache's heads (a rank's own on a mesh)
    hq, hkv = spec.gqa.num_q_heads, spec.gqa.num_kv_heads
    inputs = dict(
        q=rnd(b, hq, spec.head_dim),
        new_k=rnd(b, hkv, spec.head_dim),
        new_v=rnd(b, hkv, spec.head_dim),
        k_pages=app.cache["k"], v_pages=app.cache["v"],
        lens=torch.tensor(pos, dtype=torch.int32, device=device),
        block_table=torch.as_tensor(table, device=device))
    layer = spec.num_layers - 1 if layer is None else layer
    window = spec.window(spec.is_local(layer))
    sink = app.params["layers"]["sink"][layer] if spec.attn_sink else None
    kw = dict(scale=spec.scale)
    if window or sink is not None:
        kw.update(window=window, sink=sink)
    if spec.kv_scale is not None:
        kw.update(kv_scale=spec.kv_scale)
    if spec.attn_soft_cap is not None:
        kw.update(soft_cap=spec.attn_soft_cap)
    err = check_kernel_against_twin(dict(inputs), dict(kw, layer=layer))
    args = (inputs["q"], inputs["k_pages"], inputs["v_pages"],
            inputs["new_k"], inputs["new_v"], layer, inputs["lens"],
            inputs["block_table"])
    # one bf16 ulp of the largest output where the served values exceed
    # 2 (Gemma's (1 + w) norms double them), else TOL_KERNEL_BF16
    tol = max(TOL_KERNEL_BF16, tol_decode_bf16(
        decode_attention.paged_decode_attention_plain(*args, **kw)))
    if not err <= tol:
        raise AssertionError(f"kernel at main-path shapes: {err} > {tol}")
    kernel_ms = time_cuda(
        lambda: decode_attention.paged_decode_attention(*args, **kw))
    kernel_eager_ms = time_eager(
        lambda: decode_attention.paged_decode_attention(*args, **kw))
    plain_ms = time_cuda(
        lambda: decode_attention.paged_decode_attention_plain(*args, **kw),
        calls=20)
    # SDPA takes no fp8: it attends over the pages dequantized (layers up
    # to ``layer`` only) and pre-gathered
    plain = dict(inputs, **{n: dequantized_pages(inputs[n], layer,
                                                 spec.kv_scale)
                            for n in ("k_pages", "v_pages")})
    if window or sink is not None:
        q4, k4, v4, m4 = sdpa_window_inputs(plain, layer, window, sink)
    else:
        q4, k4, v4, m4 = sdpa_inputs(plain, layer)
    library_ms = time_cuda(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=m4, scale=spec.scale, enable_gqa=True))
    bound_ms, bound_by = kernel_bounds(inputs, window, sink is not None)
    bs = app.kv_mgr.spec.block_size
    return {"err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "report": {
                "kernel_us": kernel_ms * 1e3, "bound_us": bound_ms * 1e3,
                "kernel_eager_us": kernel_eager_ms * 1e3,
                "splits": decode_attention.num_splits(
                    b, hkv, int(table.shape[1]), bs,
                    spec.head_dim, spec.gqa.q_per_kv),
                "plain_us": plain_ms * 1e3, "library_us": library_ms * 1e3,
                "max_abs_err": err, "tol": tol, "kernel_shape": {
                    "B": b, "Hq": hq, "Hkv": hkv,
                    "D": spec.head_dim, "Bs": bs, "lens": list(pos),
                    "table_width": int(table.shape[1]), "layer": layer,
                    "window": window, "sink": sink is not None,
                    "soft_cap": spec.attn_soft_cap}}}


def dequantized_pages(pages, layer, kv_scale):
    """``pages`` as they are, or for a scaled fp8 cache (``kv_scale``) a
    bf16 copy of its layers up to ``layer`` times the scale."""
    import torch
    if kv_scale is None:
        return pages
    return pages[:layer + 1].to(torch.bfloat16) * kv_scale


def paged_kernel_entry(t, launches, path):
    """The paged kernel's object of the ``{"kernels": [...]}`` line;
    ``path`` names the run whose launches it counts."""
    return {"name": "paged_decode_attention", "route": "cuda",
            "source": "neuronx_distributed_inference_tpu_torch/csrc/"
                      "paged_decode_attention.cu",
            "replaces": "neuronx_distributed_inference_tpu/ops/"
                        "decode_attention.py:336",
            "launches": launches, "max_abs_err": t["err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "path": path, "shape": t["report"]["kernel_shape"]}


def contiguous_kernel_entries(times, decode_launches, flash_launches,
                              path):
    """The contiguous decode and flash kernels' objects of the
    ``{"kernels": [...]}`` line from :func:`dbrx_fp32_kernels`' ``times``
    and the launches of the run ``path`` names."""
    out = []
    for kind, kname, src, line, launches in (
            ("contig", "decode_attention_stacked", "decode_attention.cu",
             "decode_attention.py:41", decode_launches),
            ("flash", "flash_attention", "flash_attention.cu",
             "flash_attention.py:28", flash_launches)):
        t = times[kind]
        out.append({
            "name": kname, "route": "cuda",
            "source": "neuronx_distributed_inference_tpu_torch/csrc/" + src,
            "replaces": "neuronx_distributed_inference_tpu/ops/" + line,
            "launches": launches, "max_abs_err": t["err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "path": path, "shape": t["shape"]})
    return out


# ---------------------------------------------------------------------------
# Phases 6-8: the contiguous path
# ---------------------------------------------------------------------------

def make_contiguous_app(hf, device, dtype, *, batch, seq_len, kernels=True,
                        output_logits=False, cb=False, decode_kernel=None,
                        rolling=False, wcte=None, graphs=True, mesh=None,
                        **tcfg_over):
    """``CausalLMApplication`` over the family of ``hf["model_type"]``
    (what the family's ``Tpu*ForCausalLM`` entry builds). kernels=True:
    the flash prefill kernel (``attn_kernel_enabled``) and the decode
    kernel by default admission (``decode_kernel`` False: the decode
    kernel off); False: both off (mha prefill, gather decode).
    ``rolling``: ``rolling_kv_cache`` (False: full rows; None: the rolling
    cache where the window is below ``seq_len``); ``wcte``:
    ``windowed_context_encoding``; ``graphs`` False: every step eager
    (no CUDA graph captured); ``tcfg_over``: more TpuConfig fields (phase
    23's ``lora_config``); ``mesh``: one rank of a tensor-parallel mesh."""
    from neuronx_distributed_inference_tpu_torch.config import TpuConfig
    from neuronx_distributed_inference_tpu_torch.models.application import \
        CausalLMApplication
    from neuronx_distributed_inference_tpu_torch.models.family import \
        get_family
    family = get_family(hf["model_type"])
    tcfg = TpuConfig(batch_size=batch, seq_len=seq_len, dtype=dtype,
                     attn_kernel_enabled=kernels,
                     attn_block_tkg_kernel_enabled=(decode_kernel if kernels
                                                    else False),
                     rolling_kv_cache=rolling, output_logits=output_logits,
                     is_continuous_batching=cb,
                     windowed_context_encoding=wcte,
                     **mesh_degrees(mesh), **tcfg_over)
    app = CausalLMApplication(None, family.config_cls(tcfg, **hf), family,
                              device=device, cuda_graphs=graphs, mesh=mesh)
    return app.init_cache()


def _upcast(params):
    """The parameter tree in fp32 (same values as the bf16 tree)."""
    if isinstance(params, dict):
        return {k: _upcast(v) for k, v in params.items()}
    return params.float()


def phase_contiguous(hf, device, phase: str):
    """Generate with both kernels, check their launch counts, then hold
    the prefill and every decode step's logits against the kernels-off app
    on the same weights and tokens. Returns (app, ids, mask, counts)."""
    import numpy as np
    import torch
    layers = hf["num_hidden_layers"]
    app = make_contiguous_app(hf, device, "bfloat16",
                              batch=len(MISTRAL_LENS), seq_len=MISTRAL_SEQ,
                              output_logits=True)
    app.init_random_weights(0)
    ids, mask = prompts_of(MISTRAL_LENS, hf["vocab_size"], seed=0)
    warm(app, phase)
    reset_launches([app])
    t0 = time.perf_counter()
    out = app.generate(ids, attention_mask=mask, max_new_tokens=NEW_TOKENS,
                       return_logits=True)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    counts = kernel_counts([app])
    decode_steps = NEW_TOKENS - 1
    want = {"paged_decode_attention": 0,
            "decode_attention_stacked": layers * decode_steps,
            "flash_attention": layers * 1}
    gen = out["generated"]
    emit({"phase": phase, "generate_s": gen_s, "launches": counts,
          "expected_launches": want, "decode_steps": decode_steps,
          "prefill_calls": 1, "sliding_window": hf.get("sliding_window"),
          "layers": layers, "graphs": graph_report(app),
          "generated_shape": list(gen.shape)})
    check_no_incidents(phase, app)
    if counts != want:
        raise AssertionError(f"kernel launches {counts} != {want}")
    if gen.shape != (len(MISTRAL_LENS), NEW_TOKENS) or not (
            (gen >= 0) & (gen < hf["vocab_size"])).all():
        raise AssertionError(f"bad generated tokens {gen.shape}")

    logits = {"kernels": out["logits"]}
    for name, dtype in (("kernels_off", "bfloat16"),
                        ("fp32_reference", "float32")):
        ref = make_contiguous_app(hf, device, dtype,
                                  batch=len(MISTRAL_LENS),
                                  seq_len=MISTRAL_SEQ, kernels=False,
                                  output_logits=True)
        ref.params = (app.params if dtype == "bfloat16"
                      else _upcast(app.params))
        with (fp32_exact() if dtype == "float32"
              else contextlib.nullcontext()):
            logits[name] = ref.generate(
                ids, attention_mask=mask, max_new_tokens=NEW_TOKENS,
                return_logits=True, teacher_tokens=gen[:, :decode_steps])[
                    "logits"]
        del ref
        torch.cuda.empty_cache()
    real = np.arange(out["logits"][0].shape[1])[None, :] < np.asarray(
        MISTRAL_LENS)[:, None]                      # (B, bucket)

    def diffs(a_name, b_name):
        """(prefill max, decode max, mean over every compared logit) of
        |a - b|: prefill at the real positions, decode steps 1..63."""
        a, b = logits[a_name], logits[b_name]
        pre = np.abs(a[0] - b[0])[real]
        dec = np.stack([np.abs(a[i] - b[i]) for i in range(1, NEW_TOKENS)])
        n = pre.size + dec.size
        return (float(pre.max()), float(dec.max()),
                float((pre.sum(dtype=np.float64)
                       + dec.sum(dtype=np.float64)) / n))
    for name in logits:
        if not all(np.isfinite(x).all() for x in logits[name]):
            raise AssertionError(f"{phase}: non-finite {name} logits")
    direct = diffs("kernels", "kernels_off")
    k32 = diffs("kernels", "fp32_reference")
    o32 = diffs("kernels_off", "fp32_reference")
    emit({"phase": phase + "_logits",
          "kernels_vs_kernels_off": {"prefill_max": direct[0],
                                     "decode_max": direct[1],
                                     "mean": direct[2]},
          "kernels_vs_fp32": {"prefill_max": k32[0], "decode_max": k32[1],
                              "mean": k32[2]},
          "kernels_off_vs_fp32": {"prefill_max": o32[0],
                                  "decode_max": o32[1], "mean": o32[2]},
          "fp32_logit_std": float(np.std(logits["fp32_reference"][1])),
          "decode_steps_compared": decode_steps,
          "factor": TOL_CONTIG_VS_FP32})
    if not k32[2] <= TOL_CONTIG_VS_FP32 * o32[2]:
        raise AssertionError(
            f"{phase}: the kernel app's mean |logit error| vs fp32 {k32[2]} "
            f"exceeds {TOL_CONTIG_VS_FP32} x the kernels-off app's {o32[2]}")
    return app, ids, mask, counts


def phase_contiguous_serving(hf, device):
    with fp32_exact():
        _phase_contiguous_serving(hf, device)


def _phase_contiguous_serving(hf, device):
    import numpy as np
    from neuronx_distributed_inference_tpu_torch.serving import \
        ContinuousBatchingAdapter
    app = make_contiguous_app(hf, device, "float32", batch=8, seq_len=512,
                              cb=True)
    app.init_random_weights(0)
    ref = make_contiguous_app(hf, device, "float32", batch=1, seq_len=512,
                              output_logits=True)
    ref.params = app.params
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, hf["vocab_size"], size=n).tolist()
               for n in SERVE_LENS]
    reset_launches([app])
    eng = ContinuousBatchingAdapter(app)
    streams, step = serve_staggered(eng, prompts)
    served = kernel_counts([app])
    near_ties = []
    for s, prompt in enumerate(prompts):
        want = ref.generate(np.asarray([prompt]),
                            max_new_tokens=SERVE_TOKENS, return_logits=True)
        ref.reset()
        case = near_tie_check("cb_serving_near_tie", s,
                              np.asarray(streams[s][:SERVE_TOKENS]), want,
                              len(prompt))
        if case:
            near_ties.append(case)
    emit({"phase": "cb_serving", "layers": hf["num_hidden_layers"],
          "requests": len(prompts), "tokens_per_stream": SERVE_TOKENS,
          "engine_steps": step, "launches_while_serving": served,
          "streams_identical": len(prompts) - len(near_ties),
          "near_ties": len(near_ties), "host_stats": eng.host_stats})
    if served["flash_attention"] == 0:
        raise AssertionError("continuous-batching prefill never ran the "
                             "flash kernel")


def peak_flops(x) -> float:
    """The card's peak rate for ``x``'s dtype: fp32 runs on the CUDA
    cores, bf16 (and fp8 pages, widened to bf16) on the tensor cores."""
    return PEAK_FLOPS.get(str(x.dtype).replace("torch.", ""),
                          PEAK_FLOPS["bfloat16"])


def decode_bounds(inputs, sink=False):
    """Least time for the contiguous decode kernel's work on the H100:
    bytes (each live K/V row once, q, new_k/new_v, out, lens, the fp32
    sinks) over the HBM rate and operations (QK and PV over the live keys
    plus the active token) over the peak rate of q's dtype; returns (ms,
    "bytes"|"operations")."""
    q, kc = inputs["q"], inputs["k_cache"]
    b, hq, d = q.shape
    hkv = kc.shape[2]
    keys = sum(int(x) for x in inputs["lens"].tolist())
    nbytes = (2 * keys * hkv * d * kc.element_size()
              + (2 * b * hq * d + 2 * b * hkv * d) * q.element_size()
              + 4 * b + (4 * hq if sink else 0))
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 4 * (keys + b) * hq * d / peak_flops(q) * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                           "operations")


def flash_bounds(q, k, window: int = 0):
    """Least time for the flash kernel's causal work: operations 4 * B *
    Hq * D * sum_q min(q + 1, window) keys (the keys each query attends)
    over the peak rate of q's dtype, and bytes (q, k, v read once,
    out written once) over the HBM rate."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    if 0 < window < s:
        keys = window * (window + 1) // 2 + (s - window) * window
    else:
        keys = s * (s + 1) // 2
    ops_ms = (4 * b * hq * d * keys / peak_flops(q) * 1e3)
    bytes_ms = ((2 * b * s * hq * d + 2 * b * s * hkv * d)
                * q.element_size() / HBM_BYTES_PER_S * 1e3)
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                              "bytes")


def phase_contiguous_timings(hf, device, app, ids, mask, counts):
    """Prefill and decode step times of the Mistral app, the decode
    profile, and each kernel at the main path's shapes: device time,
    bound, plain twin, and the PyTorch yardstick (SDPA)."""
    import torch
    import torch.nn.functional as F
    from neuronx_distributed_inference_tpu_torch.ops import (
        decode_attention, flash_attention)
    spec = app.spec
    b = len(MISTRAL_LENS)
    k = 32
    # the decode step with the decode kernel (default admission) and
    # without it (the gather + mha_hl), on the same weights, timed in turns
    # (on, off, off, on): the number the port's default for window-less
    # models is chosen from
    apps = {}
    for tag, dk in (("kernel_on", None), ("kernel_off", False)):
        apps[tag] = make_contiguous_app(hf, device, "bfloat16", batch=b,
                                        seq_len=MISTRAL_SEQ,
                                        decode_kernel=dk)
        apps[tag].params = app.params
        warm(apps[tag], "contiguous_steps_" + tag)

    def gen(tag, n):
        apps[tag].generate(ids, attention_mask=mask, max_new_tokens=n)
        torch.cuda.synchronize()
    steps = {tag: [] for tag in apps}
    prefill = {tag: [] for tag in apps}
    for tag in ("kernel_on", "kernel_off", "kernel_off", "kernel_on"):
        pre = time_host(lambda: gen(tag, 1), reps=3)
        prefill[tag].append(pre)
        steps[tag].append((time_host(lambda: gen(tag, 1 + k), reps=3)
                           - pre) / k)
    for tag in apps:
        emit({"phase": "contiguous_steps", "decode_kernel": tag,
              "prefill_ms_per_prompt": statistics.mean(prefill[tag]) / b,
              "prefill_ms_batch": statistics.mean(prefill[tag]),
              "prompt_lens": list(MISTRAL_LENS), "ctx_bucket": 2048,
              "decode_ms_per_step_batch4": statistics.mean(steps[tag]),
              "decode_ms_per_turn": steps[tag]})
        profile_decode(lambda: gen(tag, 1), lambda: gen(tag, 1 + k), k)
        check_no_incidents("contiguous_steps_" + tag, apps[tag])
    del apps
    torch.cuda.empty_cache()

    # contiguous decode kernel over the main path's own cache (positions
    # after its last decode step), last layer
    gen_t = torch.Generator(device=device).manual_seed(5)
    hq, hkv, d = spec.num_q_heads, spec.num_kv_heads, spec.head_dim

    def rnd(*shape):
        return torch.randn(shape, generator=gen_t,
                           device=device).to(torch.bfloat16)
    pos = [n + NEW_TOKENS - 1 for n in MISTRAL_LENS]
    dec = dict(q=rnd(b, hq, d), k_cache=app.cache["k"],
               v_cache=app.cache["v"], new_k=rnd(b, hkv, d),
               new_v=rnd(b, hkv, d),
               lens=torch.tensor(pos, dtype=torch.int32, device=device))
    layer = spec.num_layers - 1
    dkw = dict(scale=spec.scale, window=spec.sliding_window, layer=layer)
    dec_err = check_decode_against_twin(dec, dkw)
    if not dec_err <= TOL_KERNEL_BF16:
        raise AssertionError(f"decode kernel at main-path shapes: {dec_err}")
    args, kw = decode_args(dec, dkw)
    dec_ms = time_cuda(
        lambda: decode_attention.decode_attention_stacked(*args, **kw))
    dec_plain_ms = time_cuda(
        lambda: decode_attention.decode_attention_stacked_plain(*args, **kw),
        calls=10)
    # SDPA over D-contiguous copies of the layer, active token at lens[b]
    q4, kk, vv, smask = contiguous_sdpa_inputs(dec, layer,
                                               spec.sliding_window)
    dec_lib_ms = time_cuda(lambda: F.scaled_dot_product_attention(
        q4, kk, vv, attn_mask=smask, scale=spec.scale, enable_gqa=True))
    del kk, vv
    dec_bound, dec_by = decode_bounds(dec)

    # flash kernel at the main path's prefill shapes (batch 4, bucket 2048)
    s = 2048
    fq = torch.randn((b, s, hq, d), generator=gen_t,
                     device=device).to(torch.bfloat16)
    fk = torch.randn((b, s, hkv, d), generator=gen_t,
                     device=device).to(torch.bfloat16)
    fv = torch.randn((b, s, hkv, d), generator=gen_t,
                     device=device).to(torch.bfloat16)
    fkw = dict(scale=spec.scale, window=spec.sliding_window)
    fl_err = check_flash_against_twin(dict(q=fq, k=fk, v=fv), fkw)
    if not fl_err <= tol_flash_bf16(dict(v=fv)):
        raise AssertionError(f"flash kernel at main-path shapes: {fl_err}")
    fl_ms = time_cuda(lambda: flash_attention.flash_attention(fq, fk, fv,
                                                              **fkw),
                      calls=5, reps=5)
    fl_plain_ms = time_cuda(lambda: flash_attention.flash_attention_plain(
        fq, fk, fv, **fkw), calls=2, reps=3)
    tq, tk, tv = (x.transpose(1, 2).contiguous() for x in (fq, fk, fv))
    fl_lib_ms = time_cuda(lambda: F.scaled_dot_product_attention(
        tq, tk, tv, is_causal=True, scale=spec.scale, enable_gqa=True),
        calls=5, reps=5)
    fl_bound, fl_by = flash_bounds(fq, fk, spec.sliding_window)
    emit({"phase": "contiguous_timings",
          "decode": {"kernel_us": dec_ms * 1e3, "bound_us": dec_bound * 1e3,
                     "plain_us": dec_plain_ms * 1e3,
                     "library_us": dec_lib_ms * 1e3,
                     "splits": decode_attention.contiguous_num_splits(
                         b, hkv, MISTRAL_SEQ, d),
                     "launches_per_step": spec.num_layers,
                     "max_abs_err": dec_err, "shape": {
                         "B": b, "Hq": hq, "Hkv": hkv, "D": d,
                         "S": MISTRAL_SEQ, "lens": pos}},
          "flash": {"kernel_us": fl_ms * 1e3, "bound_us": fl_bound * 1e3,
                    "plain_us": fl_plain_ms * 1e3,
                    "library_us": fl_lib_ms * 1e3,
                    "launches_per_prefill": spec.num_layers,
                    "max_abs_err": fl_err, "shape": {
                        "B": b, "S": s, "Hq": hq, "Hkv": hkv, "D": d}}})
    src = "neuronx_distributed_inference_tpu_torch/csrc/"
    jax_ops = "neuronx_distributed_inference_tpu/ops/"
    return [
        {"name": "decode_attention_stacked", "route": "cuda",
         "source": src + "decode_attention.cu",
         "replaces": jax_ops + "decode_attention.py:41",
         "launches": counts["decode_attention_stacked"],
         "max_abs_err": dec_err, "ms": dec_ms, "plain_ms": dec_plain_ms,
         "bound_ms": dec_bound, "bound_by": dec_by,
         "library_ms": dec_lib_ms},
        {"name": "flash_attention", "route": "cuda",
         "source": src + "flash_attention.cu",
         "replaces": jax_ops + "flash_attention.py:28",
         "launches": counts["flash_attention"], "max_abs_err": fl_err,
         "ms": fl_ms, "plain_ms": fl_plain_ms, "bound_ms": fl_bound,
         "bound_by": fl_by, "library_ms": fl_lib_ms}]


# ---------------------------------------------------------------------------
# Phases 9-10: the ragged engine
# ---------------------------------------------------------------------------

def make_ragged_app(hf, device, dtype, cfg, *, batch=8,
                    output_logits=False, graphs=True, sampling=None,
                    prefix_caching=True, kernel=None, **tcfg_over):
    """The paged app of phases 9-15: seq_len ``cfg["seq_len"]``, block
    ``cfg["block"]`` and a pool of every row's blocks plus one spare per
    row."""
    per_row = cfg["seq_len"] // cfg["block"] + 1
    return make_app(hf, device, dtype, batch=batch, seq_len=cfg["seq_len"],
                    output_logits=output_logits, num_blocks=batch * per_row,
                    graphs=graphs, sampling=sampling,
                    prefix_caching=prefix_caching, kernel=kernel,
                    **tcfg_over)


def ragged_engine(app, ragged, cfg):
    from neuronx_distributed_inference_tpu_torch.serving import \
        PagedEngineAdapter
    from neuronx_distributed_inference_tpu_torch.serving.engine import \
        ServingEngine
    return ServingEngine(PagedEngineAdapter(
        app, ragged=ragged, prefill_chunk_tokens=cfg["chunk"]))


def stats_delta(ad, before):
    """The adapter's integer host counters since ``before``."""
    return {k: ad.host_stats[k] - before.get(k, 0)
            for k in ad.host_stats if isinstance(ad.host_stats[k], int)}


def pass_kind(d) -> str:
    """idle (no dispatch), mixed (prefill rows or a prefill dispatch) or
    decode (an all-decode pass)."""
    if d.get("ragged_dispatches", d["dispatches"]) == 0:
        return "idle"
    if d.get("ragged_rows_prefill", d["prefill_dispatches"]) > 0:
        return "mixed"
    return "decode"


def serve_schedule(eng, prompts, new_tokens, sync, profile=None,
                   snapshot=None, adapters=None, off_clock=None):
    """Submit prompts 0-3 at pass 0, then one more every 4 passes, and run
    passes until the engine drains. ``profile(p, expect_mixed)`` returns
    True to run pass ``p`` under ``device_kernels``; ``snapshot()`` runs
    before each pass; ``adapters[i]``: request i's LoRA adapter name (None:
    the base model). Returns (streams, per-pass records, seconds from
    submit to first token per request). The profiler's own start-up and
    trace processing around a traced pass are taken off the clock that
    times to first token are read on, and so are the seconds
    ``off_clock()`` counts (a check's, cumulative)."""
    ad = eng.adapter
    streams, t_sub, ttft, recs = [], [], {}, []
    excluded = 0.0                  # seconds of profiler overhead so far
    checks = off_clock() if off_clock else 0.0
    p = 0
    while len(streams) < len(prompts) or eng.has_work:
        due = 4 if p == 0 else (1 if p % 4 == 0 else 0)
        for _ in range(min(due, len(prompts) - len(streams))):
            t_sub.append(time.perf_counter() - excluded)
            i = len(streams)
            streams.append(eng.submit(
                prompts[i], new_tokens,
                adapter=adapters[i] if adapters else None))
        expect_mixed = bool(ad.pending_prefill_ids) or eng.queue.depth > 0
        if snapshot is not None:
            snapshot()
        before = dict(ad.host_stats)
        traced = profile is not None and profile(p, expect_mixed)
        t0 = time.perf_counter()
        per = None
        if traced:
            wall, per = device_kernels(eng.run_pass)
            end = time.perf_counter()
            # the pass took ``wall``; the rest of the call was profiler
            overhead = (end - t0) - wall / 1e3
            now = end - excluded - overhead
            excluded += overhead
        else:
            eng.run_pass()
            sync()
            wall = (time.perf_counter() - t0) * 1e3
            if off_clock:
                now_checks = off_clock()
                excluded += now_checks - checks
                wall -= 1e3 * (now_checks - checks)
                checks = now_checks
            now = time.perf_counter() - excluded
        d = stats_delta(ad, before)
        recs.append({"pass": p, "kind": pass_kind(d), "ms": wall,
                     "traced": traced, "device": per, "delta": d})
        for i, st in enumerate(streams):
            if i not in ttft and st.n_tokens:
                ttft[i] = now - t_sub[i]
        p += 1
        if p > 100 * len(prompts):
            raise AssertionError("the engine made no progress")
    return streams, recs, ttft


def check_streams(phase, streams, new_tokens, vocab):
    """Gate: every stream holds exactly ``new_tokens`` in-vocab tokens and
    finished on length."""
    for i, st in enumerate(streams):
        toks = st.tokens
        if (len(toks) != new_tokens or st.finish_reason != "length"
                or not all(0 <= t < vocab for t in toks)):
            raise AssertionError(
                f"{phase}: stream {i} has {len(toks)} tokens, finish "
                f"{st.finish_reason!r}")


def check_ragged_passes(phase, recs, launches, layers):
    """Gates (a) and (b): at most one ragged dispatch and one blocking
    fetch a pass, no standalone prefill dispatch, and the paged kernel
    launched ``layers`` times per single-token ragged step (width 1:
    every all-decode pass, and a mixed pass whose prefill rows are one
    token each, as a late request's fully cached prompt leaves it).
    Returns (those steps, the launches they make)."""
    for r in recs:
        d = r["delta"]
        if (d["ragged_dispatches"] > 1 or d["blocking_fetches"] > 1
                or d["prefill_dispatches"] != 0):
            raise AssertionError(f"{phase}: pass {r['pass']} made {d}")

    def single_token(d):
        rows = (d["ragged_rows_decode"] + d["ragged_rows_verify"]
                + d["ragged_rows_prefill"] + d["ragged_pad_rows"])
        return (d["ragged_dispatches"] == 1 and rows > 0
                and d["ragged_padded_tokens"] == rows)
    decode_steps = sum(1 for r in recs if single_token(r["delta"]))
    return decode_steps, layers * decode_steps


def pass_summary(recs, kind):
    ms = [r["ms"] for r in recs if r["kind"] == kind and not r["traced"]]
    return {"passes": sum(1 for r in recs if r["kind"] == kind),
            "timed": len(ms),
            "median_ms": statistics.median(ms) if ms else None,
            "mean_ms": statistics.fmean(ms) if ms else None,
            "min_ms": min(ms) if ms else None,
            "max_ms": max(ms) if ms else None}


def profile_summary(recs, kind):
    """Device ms by kernel per pass and the device idle share over the
    traced passes of one kind."""
    traced = [r for r in recs if r["traced"] and r["kind"] == kind]
    if not traced:
        return {"passes": 0}
    per, wall = {}, 0.0
    for r in traced:
        wall += r["ms"]
        for n, ms in r["device"].items():
            per[n] = per.get(n, 0.0) + ms
    busy = sum(per.values())
    top = sorted(per.items(), key=lambda kv: -kv[1])[:10]
    n = len(traced)
    return {"passes": n, "measured": busy > 0,
            "host_ms_per_pass": wall / n,
            "device_busy_ms_per_pass": busy / n,
            "device_idle_share": (1 - busy / wall) if busy > 0 else None,
            "top_kernels_ms_per_pass": [[k[:80], ms / n] for k, ms in top]}


def phase_ragged_serving(hf, device, cfg=RAGGED, new_tokens=RAGGED_TOKENS,
                         on_card=True, phase="ragged_serving",
                         fp32_gemm_ms=0.0, before_pass=None,
                         kernel_layers=(-1,), tcfg_over=None, after=None,
                         kernel=True):
    """Phase 9 (and 14 (c) as ``phase="moe_serving"``, 15 (b) as
    ``"oss_serving"``): the ragged engine at full width and depth, bf16.
    ``fp32_gemm_ms``: the fp32 GEMM time a traced mixed pass may take (0
    for a dense model; the MoE router is fp32 by design);
    ``before_pass(p)`` runs before pass ``p``; ``kernel_layers``: the
    layers at which the paged kernel is timed over the served cache (one
    kernel entry each); ``tcfg_over``: more make_ragged_app arguments
    (phase 18's quantized weights and fp8 cache, phase 19's batch);
    ``after(app, prompts, streams)`` runs last (phase 19's check of the
    streams against ``generate``); ``kernel`` False: the model takes no
    kernel (phase 20's Llama4), so the paged kernel must launch 0 times.
    Returns (app, prompts, kernel entries, per-pass records)."""
    import numpy as np
    import torch
    app = make_ragged_app(hf, device, "bfloat16", cfg, **(tcfg_over or {}))
    init_weights(app, 0)
    if tcfg_over:
        check_weight_bytes(phase, app)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, hf["vocab_size"], size=n).tolist()
               for n in cfg["lens"]]
    warm(app, phase, chunk_tokens=cfg["chunk"])
    eng = ragged_engine(app, True, cfg)
    ad = eng.adapter
    snap = {}

    passes = iter(range(1 << 30))

    def snapshot():
        if before_pass is not None:
            before_pass(next(passes))
        # the served cache's decode shapes, while every row is live
        full = min(len(prompts), app.tpu_config.batch_size)
        if len(ad.seqs) == full and not ad.pending_prefill_ids:
            live = sorted(ad.seqs)
            snap["table"] = app.kv_mgr.block_table_array(
                live, app._bt_width_for(live))
            snap["pos"] = [ad.seqs[s].position for s in live]
            snap["ids"] = [ad.seqs[s].last_token for s in live]
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    reset_launches([app])
    streams, recs, ttft = serve_schedule(eng, prompts, new_tokens, sync,
                                         pass_profile(on_card), snapshot)
    launches = kernel_counts([app])["paged_decode_attention"]
    layers = hf["num_hidden_layers"]
    decode_steps, want = check_ragged_passes(phase, recs, launches,
                                             layers)
    want = want if on_card and kernel else 0
    st = ad.host_stats
    emit({"phase": phase, "layers": layers,
          "allocator": app.kv_mgr.allocator_kind,
          "requests": len(prompts), "prompt_lens": list(cfg["lens"]),
          "new_tokens": new_tokens, "passes": len(recs),
          "passes_by_kind": {k: sum(1 for r in recs if r["kind"] == k)
                             for k in ("mixed", "decode", "idle")},
          "ragged_steps": st["ragged_steps"],
          "launches": launches, "expected_launches": want,
          "host_ms_mixed": pass_summary(recs, "mixed"),
          "host_ms_decode": pass_summary(recs, "decode"),
          "pass_log": [[r["pass"], r["kind"], round(r["ms"], 3),
                        r["traced"]] for r in recs],
          "ttft_s": [ttft.get(i) for i in range(len(prompts))],
          "ragged_pad_waste": 1 - st["ragged_real_tokens"]
          / max(st["ragged_padded_tokens"], 1),
          "graphs": graph_report(app) if app.graphs is not None else None,
          "host_stats": st})
    emit({"phase": phase + "_profile_decode",
          **profile_summary(recs, "decode")})
    mixed = profile_summary(recs, "mixed")
    emit({"phase": phase + "_profile_mixed", **mixed})
    check_no_incidents(phase, app)
    if on_card and app.kv_mgr.allocator_kind != "native":
        from neuronx_distributed_inference_tpu_torch import native
        raise AssertionError(f"{phase}: the engine runs the Python block "
                             f"allocator ({native.load_error})")
    if launches != want:
        raise AssertionError(f"{phase}: paged kernel launches "
                             f"{launches} != {want} ({layers} x "
                             f"{decode_steps} all-decode ragged steps "
                             f"with the kernel: {kernel})")
    check_streams(phase, streams, new_tokens, hf["vocab_size"])
    fp32_gemms = [(k, ms) for k, ms in mixed.get("top_kernels_ms_per_pass",
                                                 ()) if "f32f32" in k]
    if sum(ms for _, ms in fp32_gemms) > fp32_gemm_ms:
        raise AssertionError(f"{phase}: the mixed pass runs fp32 x fp32 "
                             f"GEMMs {fp32_gemms} (allowed: {fp32_gemm_ms} "
                             "ms)")
    entries = []
    for layer in kernel_layers if on_card else ():
        t = time_paged_kernel(app, snap["table"], snap["pos"], device,
                              seed=9, layer=layer % layers)
        emit({"phase": phase + "_kernel_timings", **t["report"],
              "launches": launches})
        entries.append(paged_kernel_entry(t, launches, phase))
    if after is not None:
        after(app, prompts, streams)
    return app, prompts, entries, recs


async def _sse_generate(host, port, i, prompt, new_tokens):
    """One ``POST /v1/generate`` SSE request: (tokens, seconds from the
    request's write to its first token event, the done event)."""
    r, w = await asyncio.open_connection(host, port)
    body = json.dumps({"prompt": prompt, "max_new_tokens": new_tokens,
                       "request_id": f"q{i}"}).encode()
    t0 = time.perf_counter()
    w.write(b"POST /v1/generate HTTP/1.1\r\nContent-Length: "
            + str(len(body)).encode() + b"\r\n\r\n" + body)
    await w.drain()
    toks, first, done = [], None, None
    while True:
        line = await r.readline()
        if not line:
            break
        if line.startswith(b"data: "):
            ev = json.loads(line[6:])
            if "token" in ev:
                if first is None:
                    first = time.perf_counter() - t0
                toks.append(ev["token"])
            else:
                done = ev
    w.close()
    return toks, first, done


async def _http_get(host, port, path):
    r, w = await asyncio.open_connection(host, port)
    w.write(f"GET {path} HTTP/1.1\r\n\r\n".encode())
    await w.drain()
    data = (await r.read()).decode()
    w.close()
    return data.split("\r\n\r\n", 1)[1]


def front_door_engine(app, cfg):
    """The engine of phase 11: the ragged adapter under an SLO tracker
    whose targets (TTFT 30 s, TPOT 1 s) this run keeps, and a degradation
    controller that may drop the ragged dispatch (it does not act while
    the targets hold)."""
    from neuronx_distributed_inference_tpu_torch.resilience import \
        DegradationController
    from neuronx_distributed_inference_tpu_torch.serving import \
        PagedEngineAdapter
    from neuronx_distributed_inference_tpu_torch.serving.engine import \
        ServingEngine
    from neuronx_distributed_inference_tpu_torch.telemetry.slo import (
        SLOPolicy, SLOTracker)
    return ServingEngine(
        PagedEngineAdapter(app, ragged=True,
                           prefill_chunk_tokens=cfg["chunk"]),
        slo=SLOTracker(SLOPolicy(targets={"ttft": 30.0, "tpot": 1.0})),
        degradation=DegradationController(drop_ragged=True))


def phase_front_door(hf, device, app, prompts, cfg=RAGGED,
                     new_tokens=RAGGED_TOKENS, on_card=True):
    """Phase 11: the prompts as concurrent SSE requests through
    ``ServingFrontend`` on phase 9's precompiled app; the streams held to
    an in-process ``run_pass`` replay of the same submissions."""
    import torch
    from neuronx_distributed_inference_tpu_torch import telemetry
    from neuronx_distributed_inference_tpu_torch.serving.engine import \
        ServingFrontend
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    eng = front_door_engine(app, cfg)
    ad = eng.adapter
    recs, sched = [], []
    submit, run_pass = eng.submit, eng.run_pass

    def logged_submit(*a, **kw):
        stream = submit(*a, **kw)
        sched.append((stream.request_id, len(recs)))
        return stream

    def logged_pass():
        before = dict(ad.host_stats)
        t0 = time.perf_counter()
        n = run_pass()
        sync()
        d = stats_delta(ad, before)
        recs.append({"pass": len(recs), "kind": pass_kind(d),
                     "ms": (time.perf_counter() - t0) * 1e3,
                     "traced": False, "delta": d})
        return n
    eng.submit, eng.run_pass = logged_submit, logged_pass

    async def serve():
        fe = ServingFrontend(eng)
        host, port = await fe.start()
        got = await asyncio.gather(*[
            _sse_generate(host, port, i, p, new_tokens)
            for i, p in enumerate(prompts)])
        routes = {path: await _http_get(host, port, path)
                  for path in ("/metrics", "/v1/debug/memory",
                               "/v1/debug/state")}
        blocks = ad.debug_state()["blocks"]
        await fe.stop()
        return got, routes, blocks
    telemetry.enable()
    try:
        reset_launches([app])
        got, routes, blocks = asyncio.run(serve())
        launches = kernel_counts([app])["paged_decode_attention"]
    finally:
        telemetry.disable()
    layers = hf["num_hidden_layers"]
    decode_steps, want = check_ragged_passes("front_door", recs, launches,
                                             layers)
    want = want if on_card else 0

    # the same submissions, at the same passes, served in-process
    ref = front_door_engine(app, cfg)
    at = {}
    for rid, p in sched:
        at.setdefault(p, []).append(rid)
    ref_streams = {}
    p = 0
    while p <= max(at) or ref.has_work:
        for rid in at.get(p, ()):
            ref_streams[rid] = ref.submit(prompts[int(rid[1:])], new_tokens,
                                          request_id=rid)
        ref.run_pass()
        p += 1
        if p > 100 * len(prompts):
            raise AssertionError("front_door: the replay made no progress")
    sse = {f"q{i}": g[0] for i, g in enumerate(got)}
    same = [rid for rid in sse if sse[rid] == ref_streams[rid].tokens]
    metrics = routes["/metrics"]
    recompiles = [line for line in metrics.splitlines()
                  if line.startswith("nxdi_steady_state_recompiles_total")]
    state = json.loads(routes["/v1/debug/state"])["engine"]
    memory = json.loads(routes["/v1/debug/memory"])
    emit({"phase": "front_door", "requests": len(prompts),
          "new_tokens": new_tokens, "passes": len(recs),
          "passes_by_kind": {k: sum(1 for r in recs if r["kind"] == k)
                             for k in ("mixed", "decode", "idle")},
          "streams_equal_in_process": len(same),
          "ttft_s_client": [g[1] for g in got],
          "finish": [g[2] and g[2].get("reason") for g in got],
          "host_ms_mixed": pass_summary(recs, "mixed"),
          "host_ms_decode": pass_summary(recs, "decode"),
          "launches": launches, "expected_launches": want,
          "steady_state_recompiles_lines": recompiles,
          "memory_blocks": memory["kv"]["blocks"], "adapter_blocks": blocks,
          "warmup": state.get("warmup"),
          "slo_ttft": state["slo"]["tenants"].get("default", {}).get("ttft"),
          "degradation": state["degradation"],
          "submitted_at_pass": sched})
    if len(same) != len(prompts):
        raise AssertionError(f"front_door: {len(prompts) - len(same)} SSE "
                             "streams differ from the in-process replay")
    if ("# TYPE nxdi_steady_state_recompiles_total counter" not in metrics
            or any(float(x.rsplit(" ", 1)[1]) != 0.0 for x in recompiles)):
        raise AssertionError("front_door: /metrics does not show "
                             "nxdi_steady_state_recompiles_total at 0")
    if memory["kv"]["blocks"] != blocks:
        raise AssertionError("front_door: /v1/debug/memory does not "
                             "reconcile with the adapter's blocks")
    warm_state = state.get("warmup") or {}
    if (warm_state.get("incidents") or not warm_state.get("precompile")
            or on_card and not warm_state.get("cuda_graphs", {}).get(
                "captured")):
        raise AssertionError(f"front_door: /v1/debug/state warmup "
                             f"{warm_state}")
    if launches != want:
        raise AssertionError(f"front_door: paged kernel launches "
                             f"{launches} != {layers} x {decode_steps}")


def phase_ragged_fp32(hf, device, cfg=RAGGED,
                      new_tokens=RAGGED_CHECK_TOKENS, on_card=True,
                      phase="ragged_fp32"):
    """Phase 10 (and 14 (d) as ``phase="moe_fp32"``): eager ragged vs
    graph ragged vs two-phase engine vs ``generate``, fp32, TF32 off."""
    with fp32_exact():
        _phase_ragged_fp32(hf, device, cfg, new_tokens, on_card, phase)


def _ragged_run(phase, app, prompts, new_tokens, cfg, sync, layers,
                on_card, snapshot_of=None, kernel=True):
    """Serve the phase-9 schedule on ``app``'s ragged engine
    (``snapshot_of(adapter)`` makes the per-pass snapshot callback); gates
    (a), (b) with replays counted (``kernel`` False: no launch at all).
    Returns (streams, passes, launches, all-decode steps)."""
    reset_launches([app])
    eng = ragged_engine(app, True, cfg)
    snapshot = snapshot_of(eng.adapter) if snapshot_of else None
    streams, recs, _ = serve_schedule(eng, prompts, new_tokens, sync,
                                      snapshot=snapshot)
    launches = kernel_counts([app])["paged_decode_attention"]
    decode_steps, want = check_ragged_passes(phase, recs, launches, layers)
    want = want if on_card and kernel else 0
    check_streams(phase, streams, new_tokens, app.spec.vocab_size)
    if launches != want:
        raise AssertionError(f"{phase}: paged kernel launches {launches} "
                             f"!= {layers} x {decode_steps}")
    return streams, recs, launches, decode_steps


def _phase_ragged_fp32(hf, device, cfg, new_tokens, on_card, phase):
    import numpy as np
    import torch
    app = make_ragged_app(hf, device, "float32", cfg, graphs=False)
    init_weights(app, 0)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, hf["vocab_size"], size=n).tolist()
               for n in cfg["lens"]]
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    layers = hf["num_hidden_layers"]
    streams, recs, launches, decode_steps = _ragged_run(
        phase, app, prompts, new_tokens, cfg, sync, layers, on_card)
    ragged = [np.asarray(s.tokens) for s in streams]
    # the same schedule on a precompiled app: all-decode passes replay
    gapp = make_ragged_app(hf, device, "float32", cfg)
    gapp.params = app.params
    warm(gapp, phase + "_graphs", chunk_tokens=cfg["chunk"])
    snap = {}

    def snapshot_of(ad):
        def snapshot():
            # the last all-decode state with the most live rows
            if (not ad.seqs or ad.pending_prefill_ids
                    or len(ad.seqs) < len(snap.get("rows", ((), ()))[1])):
                return
            live = sorted(ad.seqs)
            snap["rows"] = (
                gapp.kv_mgr.block_table_array(live,
                                              gapp._bt_width_for(live)),
                [ad.seqs[s].position for s in live],
                [ad.seqs[s].last_token for s in live])
        return snapshot
    g_streams, g_recs, g_launches, g_steps = _ragged_run(
        phase + "_graphs", gapp, prompts, new_tokens, cfg, sync, layers,
        on_card, snapshot_of)
    check_no_incidents(phase + "_graphs", gapp)
    graphs = [np.asarray(s.tokens) for s in g_streams]
    two = make_ragged_app(hf, device, "float32", cfg)
    two.params = app.params
    two_streams, _, _ = serve_schedule(ragged_engine(two, False, cfg),
                                       prompts, new_tokens, sync)
    check_streams(phase + "_two_phase", two_streams, new_tokens,
                  hf["vocab_size"])
    del two
    ref = make_ragged_app(hf, device, "float32", cfg, batch=1,
                          output_logits=True)
    ref.params = app.params
    near_ties = []
    for i, prompt in enumerate(prompts):
        want_i = ref.generate(np.asarray([prompt]),
                              max_new_tokens=new_tokens, return_logits=True)
        ref.reset()
        runs = (("ragged", ragged[i]), ("graphs", graphs[i]),
                ("two_phase", np.asarray(two_streams[i].tokens)))
        cases = [near_tie_check(f"{phase}_{name}_near_tie", i, got,
                                want_i, len(prompt))
                 for name, got in runs]
        # the runs agree with each other up to where one of them leaves
        # generate at a near-tie
        first = [c["first_diff_step"] for c in cases if c]
        for name, got in runs[1:]:
            diff = np.nonzero(ragged[i] != got)[0]
            if diff.size and (not first or int(diff[0]) < min(first)):
                raise AssertionError(f"{phase}: stream {i} ragged and "
                                     f"{name} differ at step "
                                     f"{int(diff[0])}")
        near_ties += [c for c in cases if c]
    step = check_captured_step(hf, device, cfg, app, gapp, snap["rows"],
                               on_card)
    emit({"phase": phase, "layers": layers,
          "requests": len(prompts), "new_tokens": new_tokens,
          "passes": len(recs), "launches": launches,
          "expected_launches": layers * decode_steps if on_card else 0,
          "all_decode_ragged_steps": decode_steps,
          "graph_run": {"passes": len(g_recs), "launches": g_launches,
                        "all_decode_ragged_steps": g_steps,
                        "graphs": graph_report(gapp)
                        if gapp.graphs is not None else None},
          "streams_identical_to_generate": 3 * len(prompts) - len(near_ties),
          "near_ties": near_ties, "captured_vs_eager_step": step})


def check_captured_step(hf, device, cfg, app, gapp, snap, on_card):
    """A T = 1 paged step replayed from its graph against the same step
    run eagerly, on the same weights, cache and inputs (the live rows of
    the graph run's last all-decode state; slots -1, so nothing is
    written): identical tokens; returns the max |logit| difference."""
    import numpy as np
    table, pos, ids = snap
    b = len(pos)
    apps = []
    for graphs in (True, False):
        a = make_ragged_app(hf, device, "float32", cfg, output_logits=True,
                            graphs=graphs)
        a.params = app.params
        a.cache = gapp.cache
        apps.append(a)
    args = (np.asarray(ids, np.int32)[:, None],
            np.asarray(pos, np.int32)[:, None],
            np.full((b, 1), -1, np.int32), table, np.zeros((b,), np.int32))
    outs = [apps[0]._run_paged(*args) for _ in range(2)]  # capture, replay
    want = apps[1]._run_paged(*args)
    same = all(np.array_equal(o["tokens"].cpu().numpy(),
                              want["tokens"].cpu().numpy()) for o in outs)
    diff = max(float((o["logits"] - want["logits"]).abs().max())
               for o in outs)
    res = {"tokens_identical": same, "max_abs_logit_diff": diff,
           "captured": len(apps[0].graphs) if apps[0].graphs is not None
           else 0}
    if not same or (on_card and not res["captured"]):
        raise AssertionError(f"captured T = 1 step vs eager: {res}")
    return res


# ---------------------------------------------------------------------------
# Phases 12-13: speculative and seeded sampled serving
# ---------------------------------------------------------------------------

def spec_engine(app, path, cfg, proposer=None):
    """A ServingEngine over ``app`` on the ragged or the two-phase path,
    with ``proposer`` as its speculation (None: none)."""
    from neuronx_distributed_inference_tpu_torch.serving import \
        PagedEngineAdapter
    from neuronx_distributed_inference_tpu_torch.serving.engine import \
        ServingEngine
    return ServingEngine(PagedEngineAdapter(
        app, ragged=path == "ragged", speculation=proposer,
        prefill_chunk_tokens=cfg["chunk"]))


@contextlib.contextmanager
def counting_t1_steps(app):
    """Count the T = 1 forwards ``app`` runs inside the block (each runs
    the paged kernel once a layer): every ``_run_*`` call whose grid is
    one token wide, and every step of the draft loop. The wrappers read
    only the host arrays' shapes."""
    import numpy as np
    counts = {"t1_steps": 0, "draft_steps": 0}
    width = {"_run_paged": lambda a: np.shape(a[0])[1],
             "_run_ragged": lambda a: np.shape(a[1])[1],
             "_run_spec_verify": lambda a: np.shape(a[1])[1]}

    def wrap(name):
        fn = getattr(app, name)

        def wrapped(*a, **kw):
            if name == "_run_spec_draft":
                counts["draft_steps"] += a[4]
                counts["t1_steps"] += a[4]
            elif width[name](a) == 1:
                counts["t1_steps"] += 1
            return fn(*a, **kw)
        setattr(app, name, wrapped)
    names = list(width) + ["_run_spec_draft"]
    for name in names:
        wrap(name)
    try:
        yield counts
    finally:
        for name in names:
            del app.__dict__[name]


def spec_widths():
    from neuronx_distributed_inference_tpu_torch.modules import autobucketing
    return autobucketing.spec_width_buckets(SPEC_K + 1)


def serve_spec(phase, app, prompts, path, proposer, cfg, new_tokens, sync,
               on_card, profile=None, snapshot_of=None, shed_at=None):
    """Serve the phase-9 schedule on ``app`` through ``path`` with
    ``proposer``; gates: at most one ragged dispatch, one verify dispatch
    and one blocking fetch a pass (the ragged path: no standalone prefill
    dispatch), the paged kernel launched once a layer per T = 1 step
    (replays counted), every stream full and in vocab. ``shed_at(p)``
    returns the speculation shed flag for pass ``p``;
    ``snapshot_of(adapter)`` makes the per-pass snapshot callback. Returns
    a summary
    with the streams, the pass records and the adapter."""
    layers = app.spec.num_layers
    reset_launches([app])
    eng = spec_engine(app, path, cfg, proposer)
    ad = eng.adapter
    if shed_at is not None:
        run_pass = eng.run_pass
        n = [0]

        def shed_pass():
            ad.set_speculation_shed(shed_at(n[0]))
            n[0] += 1
            return run_pass()
        eng.run_pass = shed_pass
    snapshot = snapshot_of(ad) if snapshot_of else None
    with counting_t1_steps(app) as counts:
        streams, recs, ttft = serve_schedule(eng, prompts, new_tokens, sync,
                                             profile, snapshot)
    launches = kernel_counts([app])["paged_decode_attention"]
    for r in recs:
        d = r["delta"]
        if (d.get("ragged_dispatches", 0) > 1 or d["blocking_fetches"] > 1
                or d.get("spec_verify_dispatches", 0) > 1
                or path == "ragged" and d["prefill_dispatches"] != 0):
            raise AssertionError(f"{phase}: pass {r['pass']} made {d}")
    want = layers * counts["t1_steps"] if on_card else 0
    check_streams(phase, streams, new_tokens, app.spec.vocab_size)
    if launches != want:
        raise AssertionError(f"{phase}: paged kernel launches {launches} "
                             f"!= {layers} x {counts['t1_steps']} T = 1 "
                             "steps")
    st = ad.host_stats
    out = {"phase": phase, "path": path,
           "proposer": getattr(proposer, "name", None),
           "requests": len(prompts), "new_tokens": new_tokens,
           "passes": len(recs),
           "passes_by_kind": {k: sum(1 for r in recs if r["kind"] == k)
                              for k in ("mixed", "decode", "idle")},
           "launches": launches, "expected_launches": want,
           "t1_steps": counts["t1_steps"],
           "draft_steps": counts["draft_steps"],
           "host_ms_mixed": pass_summary(recs, "mixed"),
           "host_ms_decode": pass_summary(recs, "decode"),
           "ttft_s": [ttft.get(i) for i in range(len(prompts))]}
    if proposer is not None:
        drafted = st["spec_drafted_tokens"]
        rows = sum(r["delta"].get("ragged_rows_verify", 0) for r in recs)
        out.update({
            "spec_steps": st["spec_steps"],
            "draft_dispatches": st["spec_draft_dispatches"],
            "drafted": drafted, "accepted": st["spec_accepted_tokens"],
            "accept_rate": (st["spec_accepted_tokens"] / drafted
                            if drafted else None),
            "tokens_per_row_per_pass": ((st["spec_accepted_tokens"] + rows)
                                        / rows if rows else None)})
    return {"summary": out, "streams": [list(s.tokens) for s in streams],
            "recs": recs, "adapter": ad}


def _scores(logits, sampling, position, seed=0):
    """Per-token scores of the choice at ``position``: the logits
    (greedy), or the coupled draw's perturbed scores log p + g (-inf off
    the truncated distribution), over the vocabulary."""
    import torch
    from neuronx_distributed_inference_tpu_torch.config import \
        OnDeviceSamplingConfig
    from neuronx_distributed_inference_tpu_torch.ops import sampling as so
    lg = torch.as_tensor(logits, dtype=torch.float32)[None]
    if not sampling:
        return lg[0]
    sc = OnDeviceSamplingConfig(**sampling)
    probs, idx = so.truncated_probs(lg, so._config_params(sc, 1, "cpu"),
                                    sc.global_topk)
    keys = so.stream_keys(sc.stream_seed, torch.tensor([seed]),
                          torch.tensor([position]))
    score = torch.where(probs > 0,
                        torch.log(probs) + so.gumbel(keys, probs.shape[-1]),
                        torch.full_like(probs, float("-inf")))
    out = torch.full_like(lg[0], float("-inf"))
    out[idx[0]] = score[0]
    return out


def first_difference(lapp, prompt, want, got, j, sampling):
    """The choice at token ``j`` where a stream (``got``) first leaves its
    twin (``want``), recomputed on ``lapp`` (``output_logits``, no prefix
    cache) by two paths: a prefill of the L = len(prompt) + j tokens
    before it (logits at position L - 1), and a prefill of L - 1 tokens
    plus one decode step (the paged kernel) fed token L - 1. Returns the
    two paths' max |logit| difference (the spread of the card's
    arithmetic there) and, on the prefill path, the two chosen tokens'
    score gap and the least logit gap between neighbours in the order the
    draw depends on: the two tokens (greedy), or every candidate the
    truncation keeps and the first one it drops (the coupled draw hangs
    its gumbel noise on the candidates' RANKS, so two neighbours that
    swap move the noise between tokens)."""
    import numpy as np
    import torch
    ids = list(prompt) + list(want[:j])
    n = len(ids)
    full = lapp.generate(np.asarray([ids]), max_new_tokens=1,
                         return_logits=True)["logits"][0][0, n - 1]
    lapp.reset()
    step = lapp.generate(np.asarray([ids[:-1]]), max_new_tokens=2,
                         return_logits=True,
                         teacher_tokens=np.asarray([[ids[-1]]]))
    lapp.reset()
    spread = float(np.abs(step["logits"][1][0, 0] - full).max())
    sc = _scores(full, sampling, n - 1)
    order = torch.as_tensor(full).argsort(descending=True)
    rank = {int(t): int((order == t).nonzero()[0, 0])
            for t in (want[j], got[j])}
    logits = torch.as_tensor(full)[order]
    if sampling:
        kept = int(torch.isfinite(sc).sum())
        top = max(kept, *rank.values()) + 1
        neighbour = float((logits[:top - 1] - logits[1:top]).min())
    else:
        neighbour = abs(float(full[want[j]] - full[got[j]]))
    return {"gap": float(sc[want[j]] - sc[got[j]]),
            "neighbour_logit_gap": neighbour, "logit_spread": spread,
            "tokens": [int(want[j]), int(got[j])],
            "ranks": [rank[int(want[j])], rank[int(got[j])]],
            "finite": bool(torch.isfinite(sc[got[j]]))}


def check_twins(phase, want, got, prompts, lapp, sampling, bound=None):
    """Each stream of ``got`` against its twin in ``want``. A first
    difference is printed with its recomputed gaps and accepted only at a
    near-tie: the chosen token is on the truncated distribution, and
    either the two tokens' score gap or the least neighbour logit gap of
    :func:`first_difference` is below ``bound`` — or, with ``bound`` None
    (the bf16 runs), below twice the two recompute paths' logit spread at
    that position (divided by the temperature for the score gap): each
    run's logits sit within about one spread of the others', so only a
    pair closer than two spreads can swap."""
    cases = []
    temp = sampling["temperature"] if sampling else 1.0
    for i, (w, g) in enumerate(zip(want, got)):
        j = next((k for k, (a, b) in enumerate(zip(w, g)) if a != b), None)
        if j is None:
            continue
        case = {"stream": i, "first_diff_token": j,
                **first_difference(lapp, prompts[i], w, g, j, sampling)}
        tol = bound if bound is not None else 2 * case["logit_spread"]
        case["bound_logits"] = tol
        emit({"phase": phase + "_first_difference", **case})
        cases.append(case)
        near = (abs(case["gap"]) < tol / temp
                or case["neighbour_logit_gap"] < tol)
        if not (case["finite"] and near):
            raise AssertionError(f"{phase}: stream {i} first differs at "
                                 f"token {j}: {case}")
    return cases


def coupled_sampler_ms(app, rows, width):
    """Device ms of one coupled draw over (rows, width) logits of the
    app's vocabulary (CUDA-graph replay)."""
    import torch
    from neuronx_distributed_inference_tpu_torch.ops import sampling as so
    dev = app.device
    gen = torch.Generator(device=dev).manual_seed(4)
    logits = 3 * torch.randn((rows, width, app.spec.vocab_size),
                             generator=gen, device=dev)
    seeds = torch.arange(rows, dtype=torch.int32, device=dev)
    pos = torch.arange(rows * width, dtype=torch.int32,
                       device=dev).view(rows, width) + 100
    sc = app.tpu_config.on_device_sampling_config
    return time_cuda(lambda: so.coupled_sample(logits, sc, None, seeds, pos),
                     calls=20)


def phase_spec_greedy(hf, device, app=None, cfg=RAGGED,
                      new_tokens=RAGGED_TOKENS, on_card=True):
    """Phase 12 (a): greedy self-draft on the ragged path over phase 9's
    app (its prefix cache holds the prompts), or over a fresh one."""
    import numpy as np
    import torch
    from neuronx_distributed_inference_tpu_torch.serving.speculation import \
        SelfDraftProposer
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, hf["vocab_size"], size=n).tolist()
               for n in cfg["lens"]]
    if app is None:
        app = make_ragged_app(hf, device, "bfloat16", cfg)
        app.init_random_weights(0)
    # phase 9 declared steady state: an operator re-warming for the draft
    # loops leaves it first, or the new captures count as incidents
    app.declare_steady_state(False)
    warm(app, "spec_greedy", chunk_tokens=cfg["chunk"],
         spec_widths=spec_widths())
    greedy = serve_spec("spec_greedy", app, prompts, "ragged",
                        SelfDraftProposer(SPEC_K), cfg, new_tokens, sync,
                        on_card)
    check_no_incidents("spec_greedy", app)
    emit(greedy["summary"])


def phase_spec_sampled(hf, device, cfg=RAGGED, new_tokens=RAGGED_TOKENS,
                       on_card=True):
    """Phase 12 (b): a fresh seeded sampled app served without
    speculation, with self-draft on the ragged path and on the two-phase
    path. Returns the paged kernel's entry of the kernels line (its
    launches those of the ragged speculative run)."""
    import numpy as np
    import torch
    from neuronx_distributed_inference_tpu_torch.serving.speculation import \
        SelfDraftProposer
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, hf["vocab_size"], size=n).tolist()
               for n in cfg["lens"]]
    app = make_ragged_app(hf, device, "bfloat16", cfg,
                          sampling=SPEC_SAMPLING)
    app.init_random_weights(0)
    rep = warm(app, "spec_sampled", chunk_tokens=cfg["chunk"],
               spec_widths=spec_widths())
    captured = {(g["kind"], g["bucket"]) for g in rep["graphs"]
                if g["outcome"] == "capture"}
    if on_card and not {("ragged", 1), ("paged", 1),
                        ("spec_draft", SPEC_K)} <= captured:
        raise AssertionError(f"spec_sampled: precompile captured "
                             f"{sorted(captured)}")
    plain = serve_spec("spec_sampled_plain", app, prompts, "ragged", None,
                       cfg, new_tokens, sync, on_card)
    decode_passes = plain["summary"]["passes_by_kind"]["decode"]
    coupled_replays = sum(
        n for sig, n in (app.graphs.replays.items()
                         if app.graphs is not None else ())
        if sig[0] == "ragged" and sig[1] == 1 and "coupled" in sig[2])
    plain["summary"]["coupled_graph_replays"] = coupled_replays
    emit(plain["summary"])
    if on_card and coupled_replays != decode_passes:
        raise AssertionError(f"spec_sampled_plain: {coupled_replays} "
                             f"coupled graph replays for {decode_passes} "
                             "all-decode passes")
    # the twin of the speculative runs: the same prefix-warm cache state
    twin = serve_spec("spec_sampled_plain_warm", app, prompts, "ragged",
                      None, cfg, new_tokens, sync, on_card)
    emit(twin["summary"])
    traced = [0]
    snap = {}

    def profile(p, expect_mixed):
        if not on_card or expect_mixed or p < 8 or traced[0] >= 4:
            return False
        traced[0] += 1
        return True
    def snapshot_of(ad):
        def snapshot():
            # the served cache's decode shapes, while all rows are live
            if len(ad.seqs) == len(prompts) and not ad.pending_prefill_ids:
                live = sorted(ad.seqs)
                snap["table"] = app.kv_mgr.block_table_array(
                    live, app._bt_width_for(live))
                snap["pos"] = [ad.seqs[s].position for s in live]
        return snapshot
    ragged = serve_spec("spec_sampled_ragged", app, prompts, "ragged",
                        SelfDraftProposer(SPEC_K), cfg, new_tokens, sync,
                        on_card, profile, snapshot_of)
    launches = ragged["summary"]["launches"]
    prof = profile_summary(ragged["recs"], "decode")
    two = serve_spec("spec_sampled_two_phase", app, prompts, "two_phase",
                     SelfDraftProposer(SPEC_K), cfg, new_tokens, sync,
                     on_card)
    check_no_incidents("spec_sampled", app)
    lapp = make_ragged_app(hf, device, "bfloat16", cfg, batch=1,
                           output_logits=True, graphs=False,
                           sampling=SPEC_SAMPLING, prefix_caching=False)
    lapp.params = app.params
    for run in (ragged, two):
        run["summary"]["first_differences"] = check_twins(
            run["summary"]["phase"], twin["streams"], run["streams"],
            prompts, lapp, SPEC_SAMPLING)
        emit(run["summary"])
    del lapp
    sampler = {}
    if on_card:
        sampler = {"verify_rows_x4_ms": coupled_sampler_ms(app, 8, SPEC_K
                                                           + 1),
                   "decode_rows_ms": coupled_sampler_ms(app, 8, 1)}
    busy = prof.get("device_busy_ms_per_pass")
    emit({"phase": "spec_profile", **prof, "coupled_sampler": sampler,
          "coupled_sampler_share": (sampler["verify_rows_x4_ms"] / busy
                                    if busy and sampler else None)})
    if not on_card:
        return []
    t = time_paged_kernel(app, snap["table"], snap["pos"], device, seed=12)
    emit({"phase": "spec_kernel_timings", **t["report"],
          "launches": launches})
    return [paged_kernel_entry(t, launches, "spec_sampled_ragged")]


def phase_spec_fp32(hf, device, cfg=RAGGED, new_tokens=RAGGED_CHECK_TOKENS,
                    on_card=True):
    """Phase 13: fp32 identity across five serving modes, TF32 off."""
    with fp32_exact():
        _phase_spec_fp32(hf, device, cfg, new_tokens, on_card)


def _phase_spec_fp32(hf, device, cfg, new_tokens, on_card):
    import numpy as np
    import torch
    from neuronx_distributed_inference_tpu_torch.serving.speculation import (
        PerturbedSelfDraftProposer, SelfDraftProposer)
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, hf["vocab_size"], size=n).tolist()
               for n in cfg["lens"]]
    params = None
    for sampling in (None, SPEC_SAMPLING):
        tag = "spec_fp32_" + ("sampled" if sampling else "greedy")
        ref_app = make_ragged_app(hf, device, "float32", cfg, graphs=False,
                                  sampling=sampling)
        if params is None:
            ref_app.init_random_weights(0)
            params = ref_app.params
        ref_app.params = params
        ref = serve_spec(tag + "_eager", ref_app, prompts, "two_phase",
                         None, cfg, new_tokens, sync, on_card)
        emit(ref["summary"])
        del ref_app
        app = make_ragged_app(hf, device, "float32", cfg, sampling=sampling)
        app.params = params
        warm(app, tag, chunk_tokens=cfg["chunk"], spec_widths=spec_widths())
        lapp = make_ragged_app(hf, device, "float32", cfg, batch=1,
                               output_logits=True, graphs=False,
                               sampling=sampling, prefix_caching=False)
        lapp.params = params
        modes = (("two_phase_self", "two_phase", SelfDraftProposer(SPEC_K),
                  None),
                 ("ragged_self", "ragged", SelfDraftProposer(SPEC_K), None),
                 ("ragged_perturbed", "ragged",
                  PerturbedSelfDraftProposer(SPEC_K, corrupt_at=1), None),
                 ("ragged_shed", "ragged", SelfDraftProposer(SPEC_K),
                  lambda p: 6 <= p < 14))
        results = {}
        for name, path, proposer, shed_at in modes:
            run = serve_spec(f"{tag}_{name}", app, prompts, path, proposer,
                             cfg, new_tokens, sync, on_card,
                             shed_at=shed_at)
            run["summary"]["first_differences"] = check_twins(
                f"{tag}_{name}", ref["streams"], run["streams"], prompts,
                lapp, sampling, NEAR_TIE)
            results[name] = run
            emit(run["summary"])
        check_no_incidents(tag, app)
        full = [r["delta"] for r in results["ragged_perturbed"]["recs"]
                if r["delta"].get("ragged_rows_verify")
                and r["delta"]["spec_drafted_tokens"]
                == SPEC_K * r["delta"]["ragged_rows_verify"]]
        bad = [d for d in full if d["spec_accepted_tokens"]
               != d["ragged_rows_verify"]]
        if not full or bad:
            raise AssertionError(f"{tag}: the perturbed proposer accepted "
                                 f"{bad[:2]} on full-width steps "
                                 f"({len(full)} of them)")
        shed = [r["delta"] for r in results["ragged_shed"]["recs"]
                if 6 <= r["pass"] < 14]
        if any(d.get("spec_draft_dispatches", 0) for d in shed):
            raise AssertionError(f"{tag}: a shed pass made a draft "
                                 "dispatch")
        emit({"phase": tag, "reference_passes": len(ref["recs"]),
              "full_width_perturbed_steps": len(full),
              "shed_passes": len(shed),
              "streams_equal_reference": {
                  n: sum(a == b for a, b in zip(ref["streams"],
                                                r["streams"]))
                  for n, r in results.items()}})
        del app, lapp, results
        if on_card:
            torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 14: the MoE group, Qwen3-30B-A3B
# ---------------------------------------------------------------------------

def free_card():
    """Collect the apps an earlier part dropped (an app and its graphs
    hold reference cycles, so ``del`` alone may leave their tensors
    allocated), drop cuBLAS's per-stream workspaces (every timing and
    capture stream got one) and return the cached blocks to the card."""
    import gc

    import torch
    gc.collect()
    if hasattr(torch._C, "_cuda_clearCublasWorkspaces"):
        torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()


def memory_note(phase):
    """The phase's peak device memory since the last reset, then reset."""
    import torch
    emit({"phase": phase + "_memory",
          "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
          "memory_allocated_gb": torch.cuda.memory_allocated() / 1e9})
    torch.cuda.reset_peak_memory_stats()


def time_events(fn, calls: int = 10, reps: int = 5) -> float:
    """ms per call of ``fn`` called eagerly ``calls`` times between two
    CUDA events (median of ``reps``): device time while the host keeps
    ahead of the card, host time when it does not."""
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def timed_kernel(call, plain, sdpa, bounds, err, shape, plain_calls=20,
                 calls=100, reps=7):
    """One kernel's numbers at one shape: CUDA-graph replay time of the
    kernel, its twin and the SDPA yardstick, and the bound."""
    bound_ms, bound_by = bounds
    ms = time_cuda(call, calls=calls, reps=reps)
    return {"ms": ms, "plain_ms": time_cuda(plain, calls=plain_calls,
                                            reps=min(reps, 3)),
            "library_ms": time_cuda(sdpa, calls=calls, reps=reps),
            "bound_ms": bound_ms, "bound_by": bound_by, "err": err,
            "shape": shape}


def phase_moe_kernels(device):
    with fp32_exact():
        return _phase_moe_kernels(device)


def _phase_moe_kernels(device):
    """14 (a): the three kernels at the Qwen3-30B-A3B geometry (Hq 32 over
    Hkv 4: GQA group 8, D 128), each against its twin at the tolerances
    of phase 2, then timed (bf16) beside its twin, SDPA and its bound."""
    import torch
    import torch.nn.functional as F
    from neuronx_distributed_inference_tpu_torch.ops import (
        decode_attention, flash_attention)
    spec = QWEN3_30B_A3B
    hq, hkv = spec["num_attention_heads"], spec["num_key_value_heads"]
    d = spec["head_dim"]
    scale = d ** -0.5
    gen = torch.Generator(device=device).manual_seed(11)
    bf16, fp32 = torch.bfloat16, torch.float32
    out = {}

    def gate(kernel, case, err, tol):
        emit({"phase": "moe_kernel_vs_twin", "kernel": kernel, "case": case,
              "geometry": {"Hq": hq, "Hkv": hkv, "D": d},
              "max_abs_err": err, "tol": tol})
        if not err <= tol:
            raise AssertionError(f"{kernel} {case} at G = {hq // hkv}: "
                                 f"max abs err {err} > {tol}")

    # the paged kernel: batch 8 at phase 9's lens mid-run (prompt + 24)
    lens = [n + RAGGED_TOKENS // 2 for n in RAGGED["lens"]]
    for tag, dt, tol in (("bf16", bf16, TOL_KERNEL_BF16),
                         ("fp32", fp32, TOL_KERNEL_FP32)):
        x = paged_inputs(gen, device, b=8, hq=hq, hkv=hkv, d=d, bs=32,
                         mb=64, lens=lens, act_dtype=dt, page_dtype=dt)
        err = check_kernel_against_twin(x, dict(scale=scale))
        gate("paged_decode_attention", "qwen3_30b_a3b_" + tag, err, tol)
        args = (x["q"], x["k_pages"], x["v_pages"], x["new_k"], x["new_v"],
                0, x["lens"], x["block_table"])
        q4, k4, v4, m4 = sdpa_inputs(x, 0)
        out["paged_" + tag] = timed_kernel(
            lambda: decode_attention.paged_decode_attention(*args,
                                                            scale=scale),
            lambda: decode_attention.paged_decode_attention_plain(
                *args, scale=scale),
            lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=m4, scale=scale, enable_gqa=True),
            kernel_bounds(x), err, {"B": 8, "Hq": hq, "Hkv": hkv, "D": d,
                                    "Bs": 32, "lens": lens,
                                    "page_dtype": tag})
        del x, q4, k4, v4
    # the contiguous decode kernel: batch 4 over S 4096 at phase 6's lens
    # after its last decode step (14 (e)), and the edge lens in fp32
    for tag, dt, tol, lens_c in (
            ("bf16", bf16, TOL_KERNEL_BF16,
             [n + NEW_TOKENS - 1 for n in MISTRAL_LENS]),
            ("fp32", fp32, TOL_KERNEL_FP32, [0, 517, 2048, 4095])):
        x = contiguous_inputs(gen, device, b=4, hq=hq, hkv=hkv, d=d,
                              s=MISTRAL_SEQ, lens=lens_c, act_dtype=dt,
                              cache_dtype=dt)
        kw = dict(scale=scale)
        err = check_decode_against_twin(x, kw)
        gate("decode_attention_stacked", "qwen3_30b_a3b_" + tag, err, tol)
        if tag == "bf16":
            args, kw = decode_args(x, kw)
            q4, kk, vv, m4 = contiguous_sdpa_inputs(x, 0)
            out["decode"] = timed_kernel(
                lambda: decode_attention.decode_attention_stacked(*args,
                                                                  **kw),
                lambda: decode_attention.decode_attention_stacked_plain(
                    *args, **kw),
                lambda: F.scaled_dot_product_attention(
                    q4, kk, vv, attn_mask=m4, scale=scale,
                    enable_gqa=True),
                decode_bounds(x), err, {"B": 4, "Hq": hq, "Hkv": hkv,
                                        "D": d, "S": MISTRAL_SEQ,
                                        "lens": lens_c}, plain_calls=10)
            del q4, kk, vv
        del x
    # the flash kernel: batch 4 at the 2048 bucket (14 (e)'s prefill)
    for tag, dt, s, tol in (("bf16", bf16, 2048, tol_flash_bf16),
                            ("fp32", fp32, 512, TOL_KERNEL_FP32)):
        fq, fk, fv = (torch.randn((4, s, h, d), generator=gen,
                                  device=device).to(dt)
                      for h in (hq, hkv, hkv))
        kw = dict(scale=scale)
        err = check_flash_against_twin(dict(q=fq, k=fk, v=fv), kw)
        gate("flash_attention", f"qwen3_30b_a3b_s{s}_{tag}", err,
             tol(dict(v=fv)) if callable(tol) else tol)
        if tag == "bf16":
            tq, tk, tv = (t.transpose(1, 2).contiguous()
                          for t in (fq, fk, fv))
            out["flash"] = timed_kernel(
                lambda: flash_attention.flash_attention(fq, fk, fv, **kw),
                lambda: flash_attention.flash_attention_plain(fq, fk, fv,
                                                              **kw),
                lambda: F.scaled_dot_product_attention(
                    tq, tk, tv, is_causal=True, scale=scale,
                    enable_gqa=True),
                flash_bounds(fq, fk), err, {"B": 4, "S": s, "Hq": hq,
                                            "Hkv": hkv, "D": d},
                plain_calls=2, calls=5, reps=5)
            del tq, tk, tv
        del fq, fk, fv
    for name, t in out.items():
        emit({"phase": "moe_kernel_timings", "kernel": name,
              "kernel_us": t["ms"] * 1e3, "bound_us": t["bound_ms"] * 1e3,
              "bound_by": t["bound_by"], "plain_us": t["plain_ms"] * 1e3,
              "library_us": t["library_ms"] * 1e3,
              "max_abs_err": t["err"], "shape": t["shape"]})
    # comparison launches are not main-path launches
    reset_launches()
    torch.cuda.empty_cache()
    return out


def moe_layer_weights(device, dtype, seed):
    """One Qwen3-30B-A3B MoE layer at full width: an fp32 router (H, E)
    and bf16 experts (E, H, I) / (E, I, H), normal(0, 0.02), from
    ``seed``; ``dtype`` fp32 upcasts the same experts."""
    import torch
    h, e = QWEN3_30B_A3B["hidden_size"], QWEN3_30B_A3B["num_experts"]
    i = QWEN3_30B_A3B["moe_intermediate_size"]
    gen = torch.Generator(device=device).manual_seed(seed)

    def draw(*shape, dt=torch.bfloat16):
        return torch.empty(shape, dtype=dt, device=device).normal_(
            0.0, 0.02, generator=gen)
    w = {"router": draw(h, e, dt=torch.float32),
         "expert_gate": draw(e, h, i), "expert_up": draw(e, h, i),
         "expert_down": draw(e, i, h)}
    return {k: (v if k == "router" else v.to(dtype)) for k, v in w.items()}


def moe_loop_reference(moe, x, w):
    """A straightforward fp32 MoE of every token, independent of
    ``modules/moe.py``: its own routing (softmax over the fp32 logits,
    ``torch.topk``, renormalised), then each token's selected experts'
    GLUs summed with its affinities, walked expert by expert (each over
    the tokens that chose it). Returns (y (N, H) fp32, the (N, k) expert
    ids, the sorted probabilities)."""
    import torch
    import torch.nn.functional as F
    xf = x.reshape(-1, x.shape[-1]).float()
    probs = torch.softmax(xf @ w["router"].float(), dim=-1)
    vals, idx = torch.topk(probs, moe.top_k, dim=-1)
    vals = vals / vals.sum(dim=-1, keepdim=True)
    y = torch.zeros_like(xf)
    for e in range(moe.num_experts):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        h = xf[tok]
        o = (F.silu(h @ w["expert_gate"][e].float())
             * (h @ w["expert_up"][e].float())) @ w["expert_down"][e].float()
        y.index_add_(0, tok, o * vals[tok, slot, None])
    return y, idx, torch.sort(probs, dim=-1, descending=True).values


def rel_rms(a, b) -> float:
    """||a - b|| / ||b|| over all elements, in fp64."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def phase_moe_layer(device):
    """14 (b): ``moe_block`` at full width (E 128, k 8, I 768, H 2048) on
    64 tokens (the dense path, and the ragged path forced) and 4096
    tokens (the ragged path), in fp32 (TF32 off) and bf16, held to
    :func:`moe_loop_reference`; dense and ragged held to each other on the
    same 64 tokens; device times of each path. Returns the times."""
    import dataclasses

    import torch
    from neuronx_distributed_inference_tpu_torch.modules import moe as tmoe
    cfg = QWEN3_30B_A3B
    moe = tmoe.MoESpec(num_experts=cfg["num_experts"],
                       top_k=cfg["num_experts_per_tok"],
                       intermediate_size=cfg["moe_intermediate_size"])
    ragged = dataclasses.replace(moe, dense_max_tokens=0)
    h = cfg["hidden_size"]
    gen = torch.Generator(device=device).manual_seed(12)
    xs = {n: torch.randn((n // 8, 8, h), generator=gen, device=device)
          for n in MOE_TOKENS}
    times = {}
    for tag, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        w = moe_layer_weights(device, dt, seed=13)
        with (fp32_exact() if dt == torch.float32
              else contextlib.nullcontext()):
            for n, x in xs.items():
                x = x.to(dt)
                ref, ref_idx, sorted_p = moe_loop_reference(moe, x, w)
                _, idx = tmoe.route(moe, x, w["router"])
                idx = idx.reshape(-1, moe.top_k)
                same = (torch.sort(idx, -1).values
                        == torch.sort(ref_idx, -1).values).all(-1)
                gap = sorted_p[:, moe.top_k - 1] - sorted_p[:, moe.top_k]
                flips = ~same
                if bool((gap[flips] > NEAR_TIE_ROUTER).any()):
                    raise AssertionError(f"moe_layer {tag} {n}: routing "
                                         "differs from the reference away "
                                         "from a near-tie")
                runs = {"ragged": ragged} if n > moe.dense_max_tokens else {
                    "dense": moe, "ragged": ragged}
                got = {}
                for path, spec in runs.items():
                    y = tmoe.moe_block(spec, x, w).reshape(-1, h).float()
                    if not torch.isfinite(y).all():
                        raise AssertionError(f"moe_layer: non-finite {path}")
                    got[path] = y
                    errs = {"max_abs_err": float(
                        (y - ref)[same].abs().max()),
                        "rel_rms": rel_rms(y[same], ref[same])}
                    emit({"phase": "moe_layer", "dtype": tag, "tokens": n,
                          "path": path, **errs,
                          "routing_near_ties": int(flips.sum()),
                          "ref_abs_max": float(ref.abs().max())})
                    bad = (errs["max_abs_err"] > TOL_MOE_FP32 if tag == "fp32"
                           else errs["rel_rms"] > TOL_MOE_BF16_REL)
                    if bad:
                        raise AssertionError(
                            f"moe_layer {tag} {n} {path}: {errs} (tol "
                            f"{TOL_MOE_FP32} abs fp32, {TOL_MOE_BF16_REL} "
                            "relative RMS bf16)")
                if len(got) == 2:
                    d = {"max_abs_diff": float((got["dense"]
                                                - got["ragged"]).abs().max()),
                         "rel_rms": rel_rms(got["dense"], got["ragged"])}
                    emit({"phase": "moe_layer_dense_vs_ragged", "dtype": tag,
                          "tokens": n, **d})
                    bad = (d["max_abs_diff"] > TOL_MOE_FP32 if tag == "fp32"
                           else d["rel_rms"] > TOL_MOE_BF16_REL)
                    if bad:
                        raise AssertionError(f"moe_layer {tag}: dense and "
                                             f"ragged paths differ: {d}")
        if tag == "bf16":
            small, big = MOE_TOKENS
            x8 = xs[small][:, :1].to(dt).contiguous()   # (8, 1, H): decode
            xs_dt = {n: x.to(dt) for n, x in xs.items()}
            times = {
                "dense_8_tokens_ms": time_cuda(
                    lambda: tmoe.moe_block(moe, x8, w), calls=20),
                f"dense_{small}_tokens_ms": time_cuda(
                    lambda: tmoe.moe_block(moe, xs_dt[small], w), calls=20),
                f"ragged_{small}_tokens_eager_ms": time_events(
                    lambda: tmoe.moe_block(ragged, xs_dt[small], w)),
                f"ragged_{big}_tokens_eager_ms": time_events(
                    lambda: tmoe.moe_block(moe, xs_dt[big], w)),
            }
            e, i = moe.num_experts, moe.intermediate_size
            emit({"phase": "moe_layer_timings", **times,
                  "dense_bytes_bound_ms": 3 * e * h * i * 2
                  / HBM_BYTES_PER_S * 1e3,
                  f"ragged_{big}_ops_bound_ms": 3 * 2 * big * moe.top_k
                  * h * i / PEAK_FLOPS["bfloat16"] * 1e3})
        del w
        torch.cuda.empty_cache()
    return times


class MoETimer:
    """CUDA events around every eager ``moe_block`` call (router, experts
    and combine of one layer), grouped by engine pass. Graph replays run
    no Python and record nothing; nothing is recorded while a graph is
    being captured."""

    def __init__(self):
        self.spans = {}
        self.current = None

    def __enter__(self):
        import torch
        from neuronx_distributed_inference_tpu_torch.modules import moe
        self._moe, self._orig = moe, moe.moe_block

        def timed(*a, **k):
            if (self.current is None
                    or torch.cuda.is_current_stream_capturing()):
                return self._orig(*a, **k)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = self._orig(*a, **k)
            end.record()
            self.spans.setdefault(self.current, []).append((start, end))
            return out
        moe.moe_block = timed
        return self

    def __exit__(self, *exc):
        self._moe.moe_block = self._orig

    def before_pass(self, p):
        self.current = p

    def ms(self, p) -> float:
        spans = self.spans.get(p, ())
        for _, end in spans:
            end.synchronize()
        return sum(s.elapsed_time(e) for s, e in spans)


def phase_moe_serving(device, layer_times):
    """14 (c): the ragged engine serving Qwen3-30B-A3B at full width
    (MOE_SERVE_LAYERS of its 48 layers), bf16, phase 9's schedule, with
    the MoE blocks' share (:func:`serve_with_moe_share`, all-decode
    passes estimated from 14 (b)'s dense 8-token block). Returns the
    paged kernel's entry."""
    dense = layer_times.get("dense_8_tokens_ms")
    return serve_with_moe_share(
        dict(QWEN3_30B_A3B, num_hidden_layers=MOE_SERVE_LAYERS), device,
        "moe_serving", lambda app: dense)


def serve_with_moe_share(hf, device, phase, dense_ms_of, kernel_layers=(-1,),
                         tcfg_over=None):
    """:func:`phase_ragged_serving` of an MoE model at full width and
    depth, bf16, phase 9's schedule, on a card with nothing else on it;
    the MoE blocks' share of each traced mixed pass (CUDA events around
    each eager block) and, for the all-decode passes (graph replays),
    ``dense_ms_of(app)`` (the device ms of one dense 8-token block) x
    layers over the pass's device time (``tcfg_over``: more TpuConfig
    fields). Returns the paged kernel's entries."""
    import torch
    from neuronx_distributed_inference_tpu_torch.serving import \
        PagedEngineAdapter
    from neuronx_distributed_inference_tpu_torch.serving.warmup import \
        memory_ledger
    check_card_empty(phase)
    layers = hf["num_hidden_layers"]
    experts = hf.get("num_experts") or hf["num_local_experts"]
    # the fp32 router's GEMM per mixed pass (8 x 512 rows x H x E x
    # layers) at the fp32 peak, times 4 for a CUDA-core kernel's reach;
    # an fp32 attention or expert product is 100x that
    router_ms = (4 * 2 * 8 * RAGGED["chunk"] * hf["hidden_size"]
                 * experts * layers / PEAK_FLOPS["float32"] * 1e3)
    with MoETimer() as timer:
        app, _, entries, recs = phase_ragged_serving(
            hf, device, cfg=RAGGED, on_card=device.type == "cuda",
            phase=phase, fp32_gemm_ms=router_ms,
            before_pass=timer.before_pass, kernel_layers=kernel_layers,
            tcfg_over=tcfg_over)
        timer.current = None
        mixed = []
        for r in recs:
            if r["traced"] and r["kind"] == "mixed":
                busy = sum(r["device"].values())
                moe_ms = timer.ms(r["pass"])
                mixed.append({"pass": r["pass"], "moe_ms": moe_ms,
                              "device_busy_ms": busy,
                              "moe_share": moe_ms / busy if busy else None})
    decode = [sum(r["device"].values()) for r in recs
              if r["traced"] and r["kind"] == "decode"]
    per_decode = statistics.fmean(decode) if decode else None
    dense = dense_ms_of(app)
    ledger = memory_ledger(PagedEngineAdapter(app, ragged=True))
    emit({"phase": phase + "_moe_share", "mixed_passes": mixed,
          "decode_device_ms_per_pass": per_decode,
          "dense_8_tokens_ms": dense,
          "decode_moe_ms_est": dense * layers if dense else None,
          "decode_moe_share_est": (dense * layers / per_decode
                                   if dense and per_decode else None),
          "ledger_model_gb": ledger["model_bytes"] / 1e9,
          "ledger_kv_pool_gb": ledger["kv"]["pool_bytes"] / 1e9,
          "weight_bytes": param_bytes(app.params)})
    memory_note(phase)
    del app
    free_card()
    return entries


def check_card_empty(phase):
    """Before a 61 GB app: what earlier parts left on the card must be
    below 2 GiB, less than the smallest app of the script (Llama-3.2-1B,
    2.5 GB of weights), so no earlier app is still alive."""
    import torch
    free_card()
    base = torch.cuda.memory_allocated()
    emit({"phase": phase + "_start", "memory_allocated_gb": base / 1e9})
    if base > 2 ** 31:
        raise AssertionError(f"{phase}: {base / 1e9:.2f} GB still "
                             "allocated before the 61 GB app is built")
    torch.cuda.reset_peak_memory_stats()


def phase_moe_bf16_vs_fp32(hf, device):
    """14 (d), second half: the bf16 4-layer paged app's prefill and
    decode logits against an fp32 app on the same (upcast) weights, fed
    the bf16 app's tokens: relative RMS error within TOL_MOE_LOGITS_REL."""
    import numpy as np
    import torch
    lens = RAGGED["lens"][:4]
    ids, mask = prompts_of(lens, hf["vocab_size"], seed=3)
    app = make_ragged_app(hf, device, "bfloat16", RAGGED, batch=len(lens),
                          output_logits=True, graphs=False)
    app.init_random_weights(0)
    out = app.generate(ids, attention_mask=mask,
                       max_new_tokens=RAGGED_CHECK_TOKENS, return_logits=True)
    ref = make_ragged_app(hf, device, "float32", RAGGED, batch=len(lens),
                          output_logits=True, graphs=False)
    ref.params = _upcast(app.params)
    del app
    torch.cuda.empty_cache()
    with fp32_exact():
        want = ref.generate(ids, attention_mask=mask,
                            max_new_tokens=RAGGED_CHECK_TOKENS,
                            return_logits=True,
                            teacher_tokens=out["generated"][:, :-1])
    del ref
    torch.cuda.empty_cache()
    real = np.arange(out["logits"][0].shape[1])[None, :] < np.asarray(
        lens)[:, None]
    got = [out["logits"][0][real]] + out["logits"][1:]
    ref_l = [want["logits"][0][real]] + want["logits"][1:]
    if not all(np.isfinite(a).all() for a in got):
        raise AssertionError("moe_bf16_vs_fp32: non-finite bf16 logits")
    num = sum(float(np.square(a.astype(np.float64) - b).sum())
              for a, b in zip(got, ref_l))
    den = sum(float(np.square(b.astype(np.float64)).sum()) for b in ref_l)
    rel = (num / den) ** 0.5
    pre = float(np.abs(got[0] - ref_l[0]).max())
    dec = max(float(np.abs(a - b).max()) for a, b in zip(got[1:], ref_l[1:]))
    emit({"phase": "moe_bf16_vs_fp32", "layers": hf["num_hidden_layers"],
          "prompt_lens": list(lens), "decode_steps": len(got) - 1,
          "rel_rms": rel, "prefill_max_abs": pre, "decode_max_abs": dec,
          "fp32_logit_std": float(np.std(ref_l[1])),
          "tol_rel_rms": TOL_MOE_LOGITS_REL})
    if not rel <= TOL_MOE_LOGITS_REL:
        raise AssertionError(f"moe_bf16_vs_fp32: relative RMS {rel} > "
                             f"{TOL_MOE_LOGITS_REL}")


def phase_moe_contiguous(hf, device, kernel_times):
    """14 (e): ``TpuQwen3MoeForCausalLM`` at full width and depth, bf16,
    ``attn_kernel_enabled=True``, after ``precompile``: 64 new tokens for
    phase 6's 4 prompts; flash launches = layers x 1 prefill and
    contiguous-decode launches (replays counted) = layers x 63 steps; the
    logits against the same app with both kernels off fed the same tokens
    (relative RMS within TOL_MOE_CONTIG_DIRECT). Phase 6's rule against
    an fp32 app runs at a MOE_CONTIG_CHECK_LAYERS-layer cut. Returns the decode and flash
    entries of the kernels line (14 (a)'s times, this run's launches)."""
    import numpy as np
    import torch
    from neuronx_distributed_inference_tpu_torch.config import TpuConfig
    from neuronx_distributed_inference_tpu_torch.models.qwen3_moe import (
        Qwen3MoeInferenceConfig, TpuQwen3MoeForCausalLM)
    layers = hf["num_hidden_layers"]
    b = len(MISTRAL_LENS)
    check_card_empty("moe_contiguous")
    tcfg = TpuConfig(batch_size=b, seq_len=MISTRAL_SEQ, dtype="bfloat16",
                     attn_kernel_enabled=True, output_logits=True)
    app = TpuQwen3MoeForCausalLM(None, Qwen3MoeInferenceConfig(tcfg, **hf),
                                 device=device)
    app.init_random_weights(0).init_cache()
    ids, mask = prompts_of(MISTRAL_LENS, hf["vocab_size"], seed=0)
    warm(app, "moe_contiguous")
    reset_launches([app])
    t0 = time.perf_counter()
    out = app.generate(ids, attention_mask=mask, max_new_tokens=NEW_TOKENS,
                       return_logits=True)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    counts = kernel_counts([app])
    steps = NEW_TOKENS - 1
    on_card = device.type == "cuda"
    want = {"paged_decode_attention": 0,
            "decode_attention_stacked": layers * steps if on_card else 0,
            "flash_attention": layers if on_card else 0}
    gen = out["generated"]
    emit({"phase": "moe_contiguous", "entry": "TpuQwen3MoeForCausalLM",
          "layers": layers, "generate_s": gen_s, "launches": counts,
          "expected_launches": want,
          "graphs": graph_report(app) if app.graphs is not None else None,
          "generated_shape": list(gen.shape)})
    check_no_incidents("moe_contiguous", app)
    if counts != want:
        raise AssertionError(f"moe_contiguous: launches {counts} != {want}")
    if gen.shape != (b, NEW_TOKENS) or not (
            (gen >= 0) & (gen < hf["vocab_size"])).all():
        raise AssertionError(f"moe_contiguous: bad tokens {gen.shape}")
    # the kernels-off app on the same weights; the kernel app's cache and
    # graphs go first (full-vocabulary prefill logits are 7.5 GB a call)
    app.cache = None
    free_card()
    off = make_contiguous_app(hf, device, "bfloat16", batch=b,
                              seq_len=MISTRAL_SEQ, kernels=False,
                              output_logits=True)
    off.params = app.params
    ref = off.generate(ids, attention_mask=mask, max_new_tokens=NEW_TOKENS,
                       return_logits=True, teacher_tokens=gen[:, :steps])
    del off
    real = np.arange(out["logits"][0].shape[1])[None, :] < np.asarray(
        MISTRAL_LENS)[:, None]
    a = [out["logits"][0][real]] + out["logits"][1:]
    r = [ref["logits"][0][real]] + ref["logits"][1:]
    if not all(np.isfinite(x).all() for x in a + r):
        raise AssertionError("moe_contiguous: non-finite logits")
    rel = logits_rel_rms(a, r)
    emit({"phase": "moe_contiguous_vs_kernels_off", "layers": layers,
          "rel_rms": rel, "prefill_max_abs": float(np.abs(a[0] - r[0]).max()),
          "decode_max_abs": max(float(np.abs(x - y).max())
                                for x, y in zip(a[1:], r[1:])),
          "logit_std": float(np.std(r[1])), "tol": TOL_MOE_CONTIG_DIRECT})
    if not rel <= TOL_MOE_CONTIG_DIRECT:
        raise AssertionError(f"moe_contiguous: kernel and kernels-off "
                             f"logits part by relative RMS {rel}")
    memory_note("moe_contiguous")
    del app, out, ref
    free_card()
    phase_contiguous(dict(hf, num_hidden_layers=MOE_CONTIG_CHECK_LAYERS),
                     device, "moe_contiguous_cut")
    memory_note("moe_contiguous_cut")
    free_card()
    src = "neuronx_distributed_inference_tpu_torch/csrc/"
    jax_ops = "neuronx_distributed_inference_tpu/ops/"
    entries = []
    for name, key, fn in (("decode_attention_stacked", "decode",
                           "decode_attention.py:41"),
                          ("flash_attention", "flash",
                           "flash_attention.py:28")):
        t = kernel_times[key]
        entries.append({
            "name": name, "route": "cuda",
            "source": src + ("decode_attention.cu" if key == "decode"
                             else "flash_attention.cu"),
            "replaces": jax_ops + fn, "launches": counts[name],
            "max_abs_err": t["err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "path": "moe_contiguous", "shape": t["shape"]})
    return entries


def phase_moe(device):
    """Group ``moe`` (phase 14 (a)-(e)); returns its kernels-line
    entries."""
    import torch
    torch.cuda.reset_peak_memory_stats()
    kernel_times = phase_moe_kernels(device)
    memory_note("moe_kernels")
    layer_times = phase_moe_layer(device)
    memory_note("moe_layer")
    entries = phase_moe_serving(device, layer_times)
    phase_ragged_fp32(dict(QWEN3_30B_A3B, num_hidden_layers=4), device,
                      cfg=RAGGED, on_card=device.type == "cuda",
                      phase="moe_fp32")
    free_card()
    phase_moe_bf16_vs_fp32(dict(QWEN3_30B_A3B, num_hidden_layers=4), device)
    memory_note("moe_fp32")
    free_card()
    entries += phase_moe_contiguous(QWEN3_30B_A3B, device, kernel_times)
    return entries


# ---------------------------------------------------------------------------
# Phase 15: the GPT-OSS group, gpt-oss-20b
# ---------------------------------------------------------------------------

def oss_cut(layers):
    """gpt-oss-20b cut to its first ``layers`` layers (their layer types
    with them)."""
    return dict(GPT_OSS_20B, num_hidden_layers=layers,
                layer_types=GPT_OSS_20B["layer_types"][:layers])


def phase_oss_kernels(device):
    with fp32_exact():
        return _phase_oss_kernels(device)


def _phase_oss_kernels(device):
    """15 (a): the paged kernel at gpt-oss-20b's heads (Hq 64 over Hkv 8,
    D 64), batch 8 at phase 9's lens mid-run, with a sink, at window 128
    (a local layer) and 0 (a global one), over bf16 and fp32 pages:
    against its twin at phase 2's tolerances, then timed beside the twin,
    SDPA over the pre-gathered window with the sink column (itself held
    to the twin) and the bound of the keys inside each row's window."""
    import torch
    import torch.nn.functional as F
    from neuronx_distributed_inference_tpu_torch.ops import decode_attention
    cfg = GPT_OSS_20B
    hq, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    d = cfg["head_dim"]
    scale = d ** -0.5
    gen = torch.Generator(device=device).manual_seed(15)
    sink = torch.randn((hq,), generator=gen, device=device)
    lens = [n + RAGGED_TOKENS // 2 for n in RAGGED["lens"]]
    out = {}
    for tag, dt, tol in (("bf16", torch.bfloat16, TOL_KERNEL_BF16),
                         ("fp32", torch.float32, TOL_KERNEL_FP32)):
        x = paged_inputs(gen, device, b=8, hq=hq, hkv=hkv, d=d, bs=32,
                         mb=64, lens=lens, act_dtype=dt, page_dtype=dt)
        args = (x["q"], x["k_pages"], x["v_pages"], x["new_k"], x["new_v"],
                0, x["lens"], x["block_table"])
        for window in (cfg["sliding_window"], 0):
            kw = dict(scale=scale, window=window, sink=sink)
            err = check_kernel_against_twin(x, kw)
            twin = decode_attention.paged_decode_attention_plain(*args, **kw)
            q4, k4, v4, m4 = sdpa_window_inputs(x, 0, window, sink)
            sdpa = F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=m4, scale=scale, enable_gqa=True)
            sdpa_err = float((sdpa[:, :, 0].float()
                              - twin.float()).abs().max())
            case = f"gpt_oss_20b_window{window}_sink_{tag}"
            emit({"phase": "oss_kernel_vs_twin",
                  "kernel": "paged_decode_attention", "case": case,
                  "geometry": {"Hq": hq, "Hkv": hkv, "D": d},
                  "max_abs_err": err, "tol": tol,
                  "sdpa_vs_twin_max_abs": sdpa_err,
                  "sdpa_tol": TOL_SDPA_YARDSTICK})
            if not err <= tol:
                raise AssertionError(f"paged kernel {case}: max abs err "
                                     f"{err} > {tol}")
            if not sdpa_err <= TOL_SDPA_YARDSTICK:
                raise AssertionError(f"SDPA yardstick {case} computes "
                                     f"another function: {sdpa_err}")
            out[(tag, window)] = timed_kernel(
                lambda: decode_attention.paged_decode_attention(*args, **kw),
                lambda: decode_attention.paged_decode_attention_plain(
                    *args, **kw),
                lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, attn_mask=m4, scale=scale, enable_gqa=True),
                kernel_bounds(x, window, sink=True), err,
                {"B": 8, "Hq": hq, "Hkv": hkv, "D": d, "Bs": 32,
                 "lens": lens, "window": window, "sink": True,
                 "page_dtype": tag})
            del twin, q4, k4, v4, m4, sdpa
        del x, args
    for (tag, window), t in out.items():
        emit({"phase": "oss_kernel_timings",
              "kernel": "paged_decode_attention", "page_dtype": tag, "window": window,
              "kernel_us": t["ms"] * 1e3, "bound_us": t["bound_ms"] * 1e3,
              "bound_by": t["bound_by"], "plain_us": t["plain_ms"] * 1e3,
              "library_us": t["library_ms"] * 1e3,
              "max_abs_err": t["err"], "shape": t["shape"]})
    # comparison launches are not main-path launches
    reset_launches()
    torch.cuda.empty_cache()
    return out


def oss_dense_block_ms(app):
    """Device ms of one dense ``moe_block`` of ``app`` (layer 0's experts)
    on 8 tokens, as an all-decode pass runs it in each layer."""
    import torch
    from neuronx_distributed_inference_tpu_torch.models import model_base
    from neuronx_distributed_inference_tpu_torch.modules import moe
    if app.device.type != "cuda":
        return None
    w = model_base._layer_slice(app.params["layers"], 0)
    gen = torch.Generator(device=app.device).manual_seed(16)
    x8 = torch.randn((8, 1, app.spec.hidden_size), generator=gen,
                     device=app.device).to(app.spec.dtype)
    return time_cuda(lambda: moe.moe_block(app.spec.moe, x8, w), calls=20)


def phase_oss_kernel_vs_gather(hf, device):
    """15 (c): the kernel path against the gather path at a cut of
    gpt-oss-20b, bf16: paged ``generate`` of phase 10's new tokens for 4
    of phase 9's prompts (the window of 128 bites on the local layers);
    the paged kernel's launches = layers x decode steps; then the same app
    with ``attn_block_tkg_kernel_enabled=False`` and an fp32 app (TF32
    off) on the same (upcast) weights are fed the kernel app's tokens.
    Over the decode steps, the kernel app's mean |logit error| against
    the fp32 app must be within TOL_CONTIG_VS_FP32 of the gather app's."""
    import numpy as np
    import torch
    lens = RAGGED["lens"][:4]
    ids, mask = prompts_of(lens, hf["vocab_size"], seed=4)
    new = RAGGED_CHECK_TOKENS
    steps = new - 1
    layers = hf["num_hidden_layers"]
    on_card = device.type == "cuda"
    app = make_ragged_app(hf, device, "bfloat16", RAGGED, batch=len(lens),
                          output_logits=True, graphs=False)
    init_weights(app, 0)
    reset_launches([app])
    out = app.generate(ids, attention_mask=mask, max_new_tokens=new,
                       return_logits=True)
    launches = kernel_counts([app])["paged_decode_attention"]
    want = layers * steps if on_card else 0
    gen = out["generated"]
    logits = {"kernel": out["logits"][1:]}
    del out
    if launches != want:
        raise AssertionError(f"oss_kernel_vs_gather: paged kernel launches "
                             f"{launches} != {layers} x {steps}")
    if gen.shape != (len(lens), new) or not (
            (gen >= 0) & (gen < hf["vocab_size"])).all():
        raise AssertionError(f"oss_kernel_vs_gather: bad tokens {gen.shape}")
    params = app.params
    del app
    for name, dtype in (("gather", "bfloat16"), ("fp32_reference",
                                                 "float32")):
        ref = make_ragged_app(hf, device, dtype, RAGGED, batch=len(lens),
                              output_logits=True, graphs=False, kernel=False)
        if dtype == "float32":
            ref.params = _upcast(params)
            del params
            if on_card:
                free_card()
        else:
            ref.params = params
        with (fp32_exact() if dtype == "float32"
              else contextlib.nullcontext()):
            logits[name] = ref.generate(
                ids, attention_mask=mask, max_new_tokens=new,
                return_logits=True, teacher_tokens=gen[:, :steps])[
                    "logits"][1:]
        del ref
    for name, steps_logits in logits.items():
        if not all(np.isfinite(x).all() for x in steps_logits):
            raise AssertionError(f"oss_kernel_vs_gather: non-finite {name}")

    def mean_abs(a, b):
        return float(sum(np.abs(x - y).sum(dtype=np.float64)
                         for x, y in zip(logits[a], logits[b]))
                     / sum(x.size for x in logits[a]))
    k32 = mean_abs("kernel", "fp32_reference")
    g32 = mean_abs("gather", "fp32_reference")
    emit({"phase": "oss_kernel_vs_gather", "layers": layers,
          "prompt_lens": list(lens), "decode_steps": steps,
          "launches": launches, "expected_launches": want,
          "kernel_vs_gather_max": max(float(np.abs(x - y).max()) for x, y
                                      in zip(logits["kernel"],
                                             logits["gather"])),
          "kernel_vs_fp32_mean": k32, "gather_vs_fp32_mean": g32,
          "fp32_logit_std": float(np.std(logits["fp32_reference"][0])),
          "factor": TOL_CONTIG_VS_FP32})
    if not k32 <= TOL_CONTIG_VS_FP32 * g32:
        raise AssertionError(
            f"oss_kernel_vs_gather: the kernel app's mean |logit error| vs "
            f"fp32 {k32} exceeds {TOL_CONTIG_VS_FP32} x the gather app's "
            f"{g32}")


class PagedArgsSpy:
    """The distinct (layer, window, sink given) of the paged kernel's
    launches while it is active, eager launches and launches recorded into
    a CUDA graph alike (a replay repeats what its capture recorded); on
    the CPU, of its plain twin's calls; in ``caps`` the distinct
    (layer, soft-cap), in ``groups`` the distinct GQA groups (query
    heads per KV head) and in ``ints`` the launches' distinct integer
    arguments (kernel launches only). It listens where the wrapper hands its arguments
    to the launch, so the wrapper and its counts stay as they are."""

    WRAPPER = "paged_decode_attention"
    # the launch's int arguments: [b, layer, pages, bs, hkv, g, d, mb,
    # splits, window]
    LAYER, GROUP, WINDOW = 1, 5, 9

    def __enter__(self):
        from neuronx_distributed_inference_tpu_torch.ops import \
            decode_attention as da
        self._da = da
        self._split_k = da._split_k
        self._plain_name = self.WRAPPER + "_plain"
        self._plain = getattr(da, self._plain_name)
        wrapper = getattr(da, self.WRAPPER)
        self.calls = set()
        self.caps = set()
        self.groups = set()
        self.ints = set()

        def split_k(wrapper_, fn, q, hkv, splits, ptrs, ints, sink, *a, **k):
            if wrapper_ is wrapper:
                self.ints.add(tuple(int(x) for x in ints))
                self.calls.add((ints[self.LAYER], ints[self.WINDOW],
                                sink is not None))
                self.caps.add((ints[self.LAYER], k.get("soft_cap")))
                self.groups.add(ints[self.GROUP])
            return self._split_k(wrapper_, fn, q, hkv, splits, ptrs, ints,
                                 sink, *a, **k)

        def plain(*a, **k):
            self.calls.add((int(a[5]), int(k.get("window", 0)),
                            k.get("sink") is not None))
            self.caps.add((int(a[5]), k.get("soft_cap")))
            self.groups.add(a[0].shape[1] // a[3].shape[1])
            return self._plain(*a, **k)
        da._split_k = split_k
        setattr(da, self._plain_name, plain)
        return self

    def __exit__(self, *exc):
        self._da._split_k = self._split_k
        setattr(self._da, self._plain_name, self._plain)


class ContiguousArgsSpy(PagedArgsSpy):
    """The same over the contiguous decode kernel (layer = the index in
    the stack it reads)."""

    WRAPPER = "decode_attention_stacked"
    # [b, layer, hkv, g, d, s_len, splits, window]
    LAYER, GROUP, WINDOW = 1, 3, 7


class FlashShapes:
    """The (q shape, k shape, dtype) of every flash-kernel launch while
    active, read where the wrapper checks the kernel's shape gate
    (``check_kernel_shapes``, on the launch path only), so the wrapper
    and its counts stay as they are."""

    def __enter__(self):
        from neuronx_distributed_inference_tpu_torch.ops import \
            flash_attention as fa
        self._fa, self._check = fa, fa.check_kernel_shapes
        self.calls = []

        def check(q, k, v, *a, **kw):
            self.calls.append((tuple(q.shape), tuple(k.shape), q.dtype))
            return self._check(q, k, v, *a, **kw)
        fa.check_kernel_shapes = check
        return self

    def __exit__(self, *exc):
        self._fa.check_kernel_shapes = self._check


def check_layer_args(phase, calls, hf):
    """Gate: every layer's paged-kernel calls took that layer's window
    (the sliding window on local layers, 0 on global ones) and its
    sink."""
    window = hf["sliding_window"]
    want = {(i, window if t == "sliding_attention" else 0, True)
            for i, t in enumerate(hf["layer_types"])}
    emit({"phase": phase + "_kernel_args",
          "calls": sorted(calls), "expected": sorted(want)})
    if calls != want:
        raise AssertionError(f"{phase}: paged kernel calls by (layer, "
                             f"window, sink) {sorted(calls - want)[:4]} "
                             f"beside {sorted(want - calls)[:4]}")


def phase_oss(device):
    """Group ``oss`` (phase 15 (a)-(d)); returns its kernels-line
    entries: the paged kernel over the served cache at a local and a
    global layer, with this run's launches."""
    import torch
    torch.cuda.reset_peak_memory_stats()
    phase_oss_kernels(device)
    memory_note("oss_kernels")
    with PagedArgsSpy() as spy:
        entries = serve_with_moe_share(GPT_OSS_20B, device, "oss_serving",
                                       oss_dense_block_ms,
                                       kernel_layers=(-2, -1))
    check_layer_args("oss_serving", spy.calls, GPT_OSS_20B)
    phase_oss_kernel_vs_gather(oss_cut(OSS_CHECK_LAYERS), device)
    memory_note("oss_kernel_vs_gather")
    free_card()
    phase_ragged_fp32(oss_cut(4), device, cfg=RAGGED,
                      on_card=device.type == "cuda", phase="oss_fp32")
    memory_note("oss_fp32")
    free_card()
    return entries


# ---------------------------------------------------------------------------
# Phase 16: the long-context group (the mixed and rolling caches, windowed
# context encoding)
# ---------------------------------------------------------------------------

def n_global_layers(hf):
    return sum(t == "full_attention" for t in hf["layer_types"])


def contiguous_sdpa_sink_inputs(inputs, layer, sink):
    """The contiguous decode attention with a sink and no window for
    ``scaled_dot_product_attention``: each row's live keys (slots up to
    the longest row's active token, the active token at slot lens[b])
    copied out with the last dimension contiguous, then one zero key and
    zero value whose additive float mask is the head's sink logit (it
    joins the denominator only). Returns (q (B, Hq, 1, D), k, v (B, Hkv,
    n + 1, D), mask (B, Hq, 1, n + 1))."""
    import torch
    q = inputs["q"]
    b, hq, d = q.shape
    lens = inputs["lens"].long()
    n = int(lens.max()) + 1
    k = inputs["k_cache"][layer][..., :n].transpose(2, 3).contiguous()
    v = inputs["v_cache"][layer][:, :, :n].clone()
    rows = torch.arange(b, device=q.device)
    k[rows, :, lens] = inputs["new_k"].to(k.dtype)
    v[rows, :, lens] = inputs["new_v"].to(v.dtype)
    zero = torch.zeros((b, k.shape[1], 1, d), dtype=k.dtype,
                       device=q.device)
    k = torch.cat([k, zero], 2)
    v = torch.cat([v, zero], 2)
    live = torch.arange(n, device=q.device)[None, :] <= lens[:, None]
    mask = torch.zeros((b, hq, 1, n + 1), dtype=q.dtype, device=q.device)
    mask[..., :n].masked_fill_(~live[:, None, None, :], float("-inf"))
    mask[..., n] = sink.to(q.dtype)[None, :, None]
    return q[:, :, None, :], k, v, mask


def phase_long_kernels(device):
    with fp32_exact():
        return _phase_long_kernels(device)


def _phase_long_kernels(device):
    """16 (a): the contiguous decode kernel (B2) over gpt-oss-20b's
    global stack (12 layers, B 4, S 32768, Hq 64 over Hkv 8, D 64, a sink,
    window 0, lens 300-2100) and the flash kernel (B3) at Mistral-7B-v0.1's
    heads (Hq 32 over Hkv 8, D 128) at window 4096 over S 8192, B 2, each
    against its twin, then timed beside the twin, SDPA at the same shapes
    (the decode's live keys with the sink as a zero key whose additive
    mask is its logit; flash's window as a boolean mask) and its bound
    (bytes for B2, operations for B3)."""
    import torch
    import torch.nn.functional as F
    from neuronx_distributed_inference_tpu_torch.ops import (
        decode_attention, flash_attention)
    out = {}
    hf = GPT_OSS_20B
    hq, hkv, d = (hf["num_attention_heads"], hf["num_key_value_heads"],
                  hf["head_dim"])
    layers = n_global_layers(hf)
    b = len(LONG_DECODE_LENS)
    gen = torch.Generator(device=device).manual_seed(16)
    x = contiguous_inputs(gen, device, b=b, hq=hq, hkv=hkv, d=d,
                          s=OSS_LONG["seq_len"], lens=list(LONG_DECODE_LENS),
                          layers=layers, act_dtype=torch.bfloat16,
                          cache_dtype=torch.bfloat16)
    # sinks at 7 +- 1: with these rows' denominators (~N e^0.5, 500-3500)
    # each sink holds a tenth to two thirds of its row's softmax mass, so
    # a sink dropped (the control below), or added once a split, moves
    # the output by far more than the tolerance
    sink = 7.0 + torch.randn((hq,), generator=gen, device=device)
    scale = d ** -0.5
    args, dkw = decode_args(x, dict(scale=scale, window=0, sink=sink,
                                    layer=layers - 1))
    got = decode_attention.decode_attention_stacked(*args, **dkw)
    torch.cuda.synchronize()
    twin = decode_attention.decode_attention_stacked_plain(*args, **dkw)
    if not torch.isfinite(got.float()).all():
        raise AssertionError("decode kernel output is not finite")
    err = float((got.float() - twin.float()).abs().max())
    tol = tol_decode_bf16(twin)
    no_sink = decode_attention.decode_attention_stacked(
        *args, **dict(dkw, sink=None))
    control = float((no_sink.float() - twin.float()).abs().max())
    q4, k4, v4, m4 = contiguous_sdpa_sink_inputs(x, layers - 1, sink)
    sdpa = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=m4,
                                          scale=scale, enable_gqa=True)
    sdpa_err = float((sdpa[:, :, 0].float() - twin.float()).abs().max())
    emit({"phase": "long_kernel_vs_twin",
          "kernel": "decode_attention_stacked",
          "case": "gpt_oss_20b_global_stack_sink",
          "max_abs_err": err, "tol": tol,
          "max_abs_out": float(twin.float().abs().max()),
          "control_no_sink_max_abs": control,
          "sdpa_vs_twin_max_abs": sdpa_err, "sdpa_tol": TOL_SDPA_YARDSTICK})
    del got, no_sink
    if not err <= tol:
        raise AssertionError(f"decode kernel over the mixed global stack: "
                             f"max abs err {err} > {tol}")
    if not control > tol:
        raise AssertionError(f"the sink moves the output by {control}, "
                             f"within the tolerance {tol}: the check "
                             "cannot see it")
    if not sdpa_err <= TOL_SDPA_YARDSTICK:
        raise AssertionError(f"decode SDPA yardstick computes another "
                             f"function: {sdpa_err}")
    out["decode"] = timed_kernel(
        lambda: decode_attention.decode_attention_stacked(*args, **dkw),
        lambda: decode_attention.decode_attention_stacked_plain(*args,
                                                                **dkw),
        lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=m4, scale=scale, enable_gqa=True),
        decode_bounds(x, sink=True), err,
        {"B": b, "Hq": hq, "Hkv": hkv, "D": d, "S": OSS_LONG["seq_len"],
         "layers": layers, "lens": list(LONG_DECODE_LENS), "window": 0,
         "sink": True, "splits": decode_attention.contiguous_num_splits(
             b, hkv, OSS_LONG["seq_len"], d)})
    del x, args, twin, q4, k4, v4, m4, sdpa
    torch.cuda.empty_cache()

    mc = MISTRAL_7B
    hq, hkv = mc["num_attention_heads"], mc["num_key_value_heads"]
    d = mc["hidden_size"] // hq
    window = mc["sliding_window"]
    b, s = 2, 8192
    qkv = [torch.randn((b, s, h, d), generator=gen, device=device).to(
        torch.bfloat16) for h in (hq, hkv, hkv)]
    fkw = dict(scale=d ** -0.5, window=window)

    def plain():
        # row by row: one row's fp32 scores are 8.6 GB
        return [flash_attention.flash_attention_plain(
            *(t[i:i + 1] for t in qkv), **fkw) for i in range(b)]
    got = flash_attention.flash_attention(*qkv, **fkw)
    torch.cuda.synchronize()
    want = torch.cat(plain())
    if not torch.isfinite(got.float()).all():
        raise AssertionError("flash kernel output is not finite")
    ferr = float((got.float() - want.float()).abs().max())
    ftol = tol_flash_bf16(dict(v=qkv[2]))
    tq, tk, tv = (t.transpose(1, 2).contiguous() for t in qkv)
    pos = torch.arange(s, device=device)
    wmask = ((pos[None, :] <= pos[:, None])
             & (pos[:, None] - pos[None, :] < window))
    sdpa = F.scaled_dot_product_attention(tq, tk, tv, attn_mask=wmask,
                                          scale=fkw["scale"],
                                          enable_gqa=True)
    sdpa_err = float((sdpa.transpose(1, 2).float() - want.float()).abs()
                     .max())
    emit({"phase": "long_kernel_vs_twin", "kernel": "flash_attention",
          "case": "mistral_7b_window4096_s8192", "max_abs_err": ferr,
          "tol": ftol, "sdpa_vs_twin_max_abs": sdpa_err,
          "sdpa_tol": TOL_SDPA_YARDSTICK})
    if not ferr <= ftol:
        raise AssertionError(f"flash kernel at window {window}: max abs "
                             f"err {ferr} > {ftol}")
    if not sdpa_err <= TOL_SDPA_YARDSTICK:
        raise AssertionError(f"flash SDPA yardstick computes another "
                             f"function: {sdpa_err}")
    del got, want, sdpa
    out["flash"] = timed_kernel(
        lambda: flash_attention.flash_attention(*qkv, **fkw), plain,
        lambda: F.scaled_dot_product_attention(
            tq, tk, tv, attn_mask=wmask, scale=fkw["scale"],
            enable_gqa=True),
        flash_bounds(qkv[0], qkv[1], window), ferr,
        {"B": b, "S": s, "Hq": hq, "Hkv": hkv, "D": d, "window": window},
        plain_calls=1, calls=5, reps=5)
    for key, t in out.items():
        emit({"phase": "long_kernel_timings", "kernel": key,
              "kernel_us": t["ms"] * 1e3, "bound_us": t["bound_ms"] * 1e3,
              "bound_by": t["bound_by"], "plain_us": t["plain_ms"] * 1e3,
              "library_us": t["library_ms"] * 1e3,
              "max_abs_err": t["err"], "shape": t["shape"]})
    del qkv, tq, tk, tv, wmask
    # comparison launches are not main-path launches
    reset_launches()
    free_card()
    return out


def kv_cache_bytes(spec, tcfg, layers=None):
    """Bytes of full K and V rows of ``layers`` (default: every layer) at
    ``tcfg.seq_len`` slots: the uniform cache the rolling or mixed one
    replaces."""
    layers = spec.num_layers if layers is None else layers
    item = {"bfloat16": 2, "float32": 4}[tcfg.dtype]
    return (2 * layers * tcfg.kv_cache_batch_size * spec.gqa.num_kv_heads
            * spec.head_dim * tcfg.seq_len * item)


def cache_bytes(app):
    return sum(t.numel() * t.element_size() for t in app.cache.values())


def make_pattern_app(hf, device, dtype, *, batch, seq_len, cb=False,
                     output_logits=False, **spec):
    """The family's contiguous entry point, ``TpuGptOssForCausalLM`` or
    ``TpuGemma2ForCausalLM`` (the mixed per-layer cache above
    ``sliding_window``), its cache made after ``spec``'s fields replace
    the spec's (``mixed_kv=False``: the uniform cache)."""
    import dataclasses
    from neuronx_distributed_inference_tpu_torch.config import TpuConfig
    from neuronx_distributed_inference_tpu_torch.models.family import \
        get_family
    from neuronx_distributed_inference_tpu_torch.models.gemma2 import \
        TpuGemma2ForCausalLM
    from neuronx_distributed_inference_tpu_torch.models.gpt_oss import \
        TpuGptOssForCausalLM
    entry = {"gpt_oss": TpuGptOssForCausalLM,
             "gemma2": TpuGemma2ForCausalLM}[hf["model_type"]]
    cls = get_family(hf["model_type"]).config_cls
    app = entry(None, cls(TpuConfig(
        batch_size=batch, seq_len=seq_len, dtype=dtype,
        is_continuous_batching=cb, output_logits=output_logits), **hf),
        device=device)
    app.spec = dataclasses.replace(app.spec, **spec)
    return app.init_cache()


def step_times(app, ids, mask, k=32):
    """(prefill ms, decode ms per step) of ``app.generate`` on the host
    clock (decode replays its graph), and the decode steps' device
    profile."""
    import torch

    def gen(n):
        app.generate(ids, attention_mask=mask, max_new_tokens=n)
        torch.cuda.synchronize()
    pre = time_host(lambda: gen(1), reps=3)
    step = (time_host(lambda: gen(1 + k), reps=3) - pre) / k
    profile_decode(lambda: gen(1), lambda: gen(1 + k), k)
    return pre, step


def agreement(a, b):
    """(streams equal, tokens equal before each row's first difference)
    of two (B, T) token arrays."""
    import numpy as np
    same = [int(np.argmin(x == y)) if (x != y).any() else len(x)
            for x, y in zip(a, b)]
    return sum(n == a.shape[1] for n in same), same


def decode_logits(app, ids, mask, tokens):
    """The decode steps' logits (a list of (B, 1, V) arrays) of ``app``
    fed ``tokens`` (B, T) after the prompt: T - 1 teacher-forced steps."""
    return app.generate(ids, attention_mask=mask,
                        max_new_tokens=tokens.shape[1], return_logits=True,
                        teacher_tokens=tokens[:, :-1])["logits"][1:]


def logits_rel_rms(got, ref):
    """Relative RMS of two lists of arrays, over all their elements."""
    import numpy as np
    num = sum(float(np.square(x.astype(np.float64) - y).sum())
              for x, y in zip(got, ref))
    den = sum(float(np.square(y.astype(np.float64)).sum()) for y in ref)
    return (num / den) ** 0.5


def layout_gate(phase, build, ids, mask, tokens):
    """Gate: the decode-step logits of ``build("layout")`` (the rolling or
    mixed cache) against ``build("full")`` (full rows) on the same weights
    fed the same ``tokens``, within TOL_LAYOUT_REL[phase] relative RMS; the
    control ``build("control")`` (full rows, window dropped) must part
    from full rows by more than the limit. Each app is built, read and
    dropped in turn."""
    import numpy as np
    lg = {}
    for kind in ("full", "layout", "control"):
        app = build(kind)
        lg[kind] = decode_logits(app, ids, mask, tokens)
        del app
        free_card()
    if not all(np.isfinite(x).all() for v in lg.values() for x in v):
        raise AssertionError(f"{phase}: non-finite logits")
    rel = logits_rel_rms(lg["layout"], lg["full"])
    control = logits_rel_rms(lg["control"], lg["full"])
    by_step = [logits_rel_rms([x], [y])
               for x, y in zip(lg["layout"], lg["full"])]
    tol = TOL_LAYOUT_REL[phase]
    emit({"phase": phase, "steps": len(lg["full"]), "rel_rms": rel,
          "control_rel_rms": control, "rel_rms_first_step": by_step[0],
          "rel_rms_step_max": max(by_step),
          "decode_max_abs": max(float(np.abs(x - y).max())
                                for x, y in zip(lg["layout"], lg["full"])),
          "logit_std": float(np.std(lg["full"][0])), "tol": tol})
    if not rel <= tol:
        raise AssertionError(f"{phase}: the layout's logits part from full "
                             f"rows' by relative RMS {rel}")
    if not control > tol:
        raise AssertionError(f"{phase}: the control parts by only {control}"
                             ": the gate cannot see a layout fault")


def phase_long_oss(hf, device):
    """16 (b): gpt-oss-20b through ``TpuGptOssForCausalLM`` at full width
    (``hf``: cut to LONG_OSS_LAYERS layers), bf16, ``seq_len`` 32768: the
    mixed per-layer cache (the global layers' rows of 32768 slots, the
    local ones rolling at 128), batch 4, prompts of 200-2000 tokens, 128
    new tokens each, after ``precompile``. Gates: the contiguous decode
    kernel launched (global layers) x the
    decode steps (replays counted), every launch at a global layer's
    stack index with window 0 and its sink; no flash launch (a layer
    pattern); no incident; full in-vocab streams. Prints prefill and
    decode step times (host clock and device), peak memory, the cache's
    bytes beside the uniform cache's, and the stream agreement with the
    uniform cache on the same weights (a count: bf16 rounds the two
    layouts' attention differently); then holds the mixed cache's logits
    to the uniform cache's (``layout_gate``; all on the
    gather path, so the two differ only in the order of the local layers'
    keys). Returns (app, launches)."""
    import torch
    cfg = OSS_LONG
    lens, new = cfg["lens"], cfg["new_tokens"]
    n_global = n_global_layers(hf)
    app = make_pattern_app(hf, device, "bfloat16", batch=len(lens),
                           seq_len=cfg["seq_len"])
    if not (app.spec.mixed_kv and set(app.cache) == {"k", "v", "k_l",
                                                       "v_l"}):
        raise AssertionError("long_oss: the app did not take the mixed "
                             "per-layer cache")
    init_weights(app, 0)
    ids, mask = prompts_of(lens, hf["vocab_size"], seed=16)
    # the spy sees the launches the capture records, and eager ones
    with ContiguousArgsSpy() as spy:
        warm(app, "long_oss")
        reset_launches([app])
        t0 = time.perf_counter()
        out = app.generate(ids, attention_mask=mask, max_new_tokens=new)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
    counts = kernel_counts([app])
    steps = new - 1
    want = {"paged_decode_attention": 0,
            "decode_attention_stacked": n_global * steps,
            "flash_attention": 0}
    gen = out["generated"]
    calls = {(g, 0, True) for g in range(n_global)}
    emit({"phase": "long_oss", "entry": "TpuGptOssForCausalLM",
          "seq_len": cfg["seq_len"], "prompt_lens": list(lens),
          "new_tokens": new, "generate_s": gen_s, "launches": counts,
          "expected_launches": want,
          "kernel_args": sorted(spy.calls),
          "cache_bytes": cache_bytes(app),
          "uniform_cache_bytes": kv_cache_bytes(app.spec, app.tpu_config),
          "local_stack_bytes": sum(
              app.cache[k].numel() * app.cache[k].element_size()
              for k in ("k_l", "v_l")),
          "graphs": graph_report(app) if app.graphs is not None else None})
    check_no_incidents("long_oss", app)
    if counts != want:
        raise AssertionError(f"long_oss: launches {counts} != {want}")
    if spy.calls != calls:
        raise AssertionError(f"long_oss: decode kernel calls by (stack "
                             f"layer, window, sink) {sorted(spy.calls)}")
    if gen.shape != (len(lens), new) or not (
            (gen >= 0) & (gen < hf["vocab_size"])).all():
        raise AssertionError(f"long_oss: bad tokens {gen.shape}")
    pre, step = step_times(app, ids, mask)
    emit({"phase": "long_oss_steps", "prefill_ms_batch": pre,
          "decode_ms_per_step_batch4": step,
          "prompt_lens": list(lens), "ctx_bucket": 2048})
    memory_note("long_oss")
    uni = make_pattern_app(hf, device, "bfloat16", batch=len(lens),
                           seq_len=cfg["seq_len"], mixed_kv=False)
    uni.params = app.params
    ref = uni.generate(ids, attention_mask=mask,
                       max_new_tokens=new)["generated"]
    equal, prefix = agreement(gen, ref)
    emit({"phase": "long_oss_vs_uniform_bf16", "streams_equal": equal,
          "streams": len(lens), "equal_prefix_tokens": prefix,
          "new_tokens": new, "gate": False})
    del uni, ref
    free_card()

    def build(kind):
        spec = {"layout": {}, "full": dict(mixed_kv=False),
                "control": dict(mixed_kv=False, sliding_window=0)}[kind]
        a = make_pattern_app(hf, device, "bfloat16", batch=len(lens),
                             seq_len=cfg["seq_len"], output_logits=True,
                             decode_kernel=False, **spec)
        a.params = app.params
        return a
    layout_gate("long_oss_logits_vs_uniform", build, ids, mask, gen)
    return app, counts


def serve_cb(ad, prompts, new_tokens, sync):
    """Phase 9's submission schedule over a ``ContinuousBatchingAdapter``
    driven through its own ``add_requests`` / ``step`` / ``release``
    (``ServingEngine`` takes the paged adapter surface only, in both
    packages): four requests at pass 0, one more every 4 passes, each
    admitted into the lowest free row as rows free up; a stream is
    released once it holds ``new_tokens``. Returns (streams, per-pass
    records, seconds from submit to first token per request)."""
    streams = [[] for _ in prompts]
    queue, t_sub, ttft, recs, owner = [], {}, {}, [], {}
    nxt, p = 0, 0
    while nxt < len(prompts) or queue or ad.seqs:
        due = 4 if p == 0 else (1 if p % 4 == 0 else 0)
        for _ in range(min(due, len(prompts) - nxt)):
            t_sub[nxt] = time.perf_counter()
            queue.append(nxt)
            nxt += 1
        t0 = time.perf_counter()
        admit = []
        while queue and len(admit) < len(ad.free_slots):
            admit.append(queue.pop(0))
        if admit:
            rows = ad.free_slots[:len(admit)]
            first = ad.add_requests(rows, [prompts[i] for i in admit])
            now = time.perf_counter()
            for row, i in zip(rows, admit):
                owner[row] = i
                streams[i].append(first[row])
                ttft[i] = now - t_sub[i]
        done = [r for r in ad.seqs if len(streams[owner[r]]) >= new_tokens]
        if done:
            ad.release(done)
        rows = len(ad.seqs)
        if ad.seqs:
            for row, tok in ad.step().items():
                streams[owner[row]].append(tok)
        sync()
        recs.append({"pass": p, "kind": "admit" if admit else "decode",
                     "ms": (time.perf_counter() - t0) * 1e3,
                     "rows": rows, "traced": False})
        p += 1
        if p > 100 * len(prompts):
            raise AssertionError("the adapter made no progress")
    return [s[:new_tokens] for s in streams], recs, ttft


def phase_long_oss_serving(hf, device, app):
    """16 (c): (b)'s weights behind ``ContinuousBatchingAdapter`` (the app
    built with ``is_continuous_batching=True``, after ``precompile``):
    phase 9's 8 requests of 37-1900 tokens over batch 4, 48 new tokens
    each. A pass that holds all four rows (the identity rows, in order)
    takes the decode kernel on the global stack, one launch a global
    layer; any other pass gathers the rows by seq_id (the reference's
    continuous batching always gathers). Gates: decode-kernel launches =
    global layers x full passes, full in-vocab streams, no incident, and
    each stream held to (b)'s weights on a static app (the decode kernel)
    fed its tokens: every token within TOL_SERVED_DEFICIT_BF16 logit stds
    of the top logit, within TOL_SERVED_MEAN_DEFICIT_BF16 on average
    (:func:`teacher_deficits`, :func:`deficit_gate`). Prints passes by
    kind, host ms per pass, TTFT, and how many streams equal each
    request's single-request ``generate`` on (b)'s app (a count: bf16
    rounds the gather and kernel paths differently)."""
    import numpy as np
    import torch
    lens, new = RAGGED["lens"], RAGGED_TOKENS
    cb = make_pattern_app(hf, device, "bfloat16", batch=len(OSS_LONG["lens"]),
                          seq_len=OSS_LONG["seq_len"], cb=True)
    cb.params = app.params
    warm(cb, "long_oss_cb")
    from neuronx_distributed_inference_tpu_torch.serving import \
        ContinuousBatchingAdapter
    ad = ContinuousBatchingAdapter(cb)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, hf["vocab_size"], size=n).tolist()
               for n in lens]
    reset_launches([cb])
    streams, recs, ttft = serve_cb(ad, prompts, new, torch.cuda.synchronize)
    counts = kernel_counts([cb])
    check_no_incidents("long_oss_cb", cb)
    for i, st in enumerate(streams):
        if len(st) != new or not all(0 <= t < hf["vocab_size"] for t in st):
            raise AssertionError(f"long_oss_cb: stream {i} has {len(st)} "
                                 "tokens")
    full = sum(1 for r in recs if r["rows"] == len(OSS_LONG["lens"]))
    want_launches = n_global_layers(hf) * full
    if counts["decode_attention_stacked"] != want_launches:
        raise AssertionError(f"long_oss_cb: decode kernel launched "
                             f"{counts} times, not {want_launches} (global "
                             f"layers x {full} full passes)")
    want = np.stack([app.generate(np.asarray([p]), max_new_tokens=new)[
        "generated"][0] for p in prompts])
    equal, prefix = agreement(np.asarray(streams), want)
    emit({"phase": "long_oss_cb", "requests": len(prompts),
          "prompt_lens": list(lens), "new_tokens": new,
          "passes": {k: pass_summary(recs, k) for k in ("admit", "decode")},
          "ttft_s": [ttft[i] for i in range(len(prompts))],
          "launches": counts, "full_passes": full, "host_stats": {
              k: v for k, v in ad.host_stats.items() if isinstance(v, int)},
          "streams_equal_generate_bf16": equal,
          "equal_prefix_tokens": prefix, "gate": "deficit"})
    del ad, cb
    free_card()
    ref = make_pattern_app(hf, device, "bfloat16",
                           batch=len(OSS_LONG["lens"]),
                           seq_len=OSS_LONG["seq_len"], output_logits=True)
    ref.params = app.params
    deficit_gate("long_oss_cb", teacher_deficits(ref, prompts, streams),
                 exact=False)
    del ref
    free_card()


def phase_long_rolling(hf, device):
    """16 (d): Mistral-7B-v0.1 at full width and depth, bf16, ``seq_len``
    16384 with the rolling cache (4096 slots a row),
    ``attn_kernel_enabled=True``, batch 2, prompts of 5000 and 6000
    tokens, 64 new tokens, after ``precompile``. Gates: flash launched
    once a layer (the prefill at window 4096 over the 8192 bucket; only
    each row's last 4096 positions land), no decode kernel launch (the
    rolling cache takes the gather path, as the reference's gate says);
    no incident; full streams. Prints prefill and decode step times, the
    cache's bytes beside the full cache's, and the stream agreement with
    ``rolling_kv_cache=False`` (a count); then holds the rolling cache's
    logits to full rows' at full depth (``layout_gate``; the full-row
    apps take the gather path too, so the two differ only in the order
    of the keys). Returns the flash launches."""
    import dataclasses

    import torch
    cfg = MISTRAL_ROLL
    lens, new = cfg["lens"], cfg["new_tokens"]
    layers = hf["num_hidden_layers"]
    app = make_contiguous_app(hf, device, "bfloat16", batch=len(lens),
                              seq_len=cfg["seq_len"], rolling=None)
    if not (app.spec.rolling_window
            and app.cache["v"].shape[3] == hf["sliding_window"]):
        raise AssertionError("long_rolling: no rolling cache")
    app.init_random_weights(0)
    ids, mask = prompts_of(lens, hf["vocab_size"], seed=17)
    warm(app, "long_rolling")
    reset_launches([app])
    t0 = time.perf_counter()
    out = app.generate(ids, attention_mask=mask, max_new_tokens=new)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    counts = kernel_counts([app])
    want = {"paged_decode_attention": 0, "decode_attention_stacked": 0,
            "flash_attention": layers}
    gen = out["generated"]
    emit({"phase": "long_rolling", "seq_len": cfg["seq_len"],
          "slots": hf["sliding_window"], "prompt_lens": list(lens),
          "new_tokens": new, "generate_s": gen_s, "launches": counts,
          "expected_launches": want, "cache_bytes": cache_bytes(app),
          "full_cache_bytes": kv_cache_bytes(app.spec, app.tpu_config),
          "graphs": graph_report(app) if app.graphs is not None else None})
    check_no_incidents("long_rolling", app)
    if counts != want:
        raise AssertionError(f"long_rolling: launches {counts} != {want}")
    if gen.shape != (len(lens), new) or not (
            (gen >= 0) & (gen < hf["vocab_size"])).all():
        raise AssertionError(f"long_rolling: bad tokens {gen.shape}")
    pre, step = step_times(app, ids, mask)
    emit({"phase": "long_rolling_steps", "prefill_ms_batch": pre,
          "decode_ms_per_step_batch2": step,
          "prompt_lens": list(lens), "ctx_bucket": 8192})
    memory_note("long_rolling")
    full = make_contiguous_app(hf, device, "bfloat16", batch=len(lens),
                               seq_len=cfg["seq_len"])
    full.params = app.params
    ref = full.generate(ids, attention_mask=mask,
                        max_new_tokens=new)["generated"]
    equal, prefix = agreement(gen, ref)
    emit({"phase": "long_rolling_vs_full_bf16", "streams_equal": equal,
          "streams": len(lens), "equal_prefix_tokens": prefix,
          "new_tokens": new, "gate": False})
    del full, ref
    free_card()

    def build(kind):
        a = make_contiguous_app(
            hf, device, "bfloat16", batch=len(lens), seq_len=cfg["seq_len"],
            rolling=None if kind == "layout" else False,
            decode_kernel=None if kind == "layout" else False,
            output_logits=True)
        if kind == "control":
            a.spec = dataclasses.replace(a.spec, sliding_window=0)
        a.params = app.params
        return a
    layout_gate("long_rolling_logits_vs_full", build, ids, mask, gen)
    del app
    free_card()
    return counts["flash_attention"]


class CountCalls:
    """Counts the calls of ``owner.name`` while active."""

    def __init__(self, owner, name):
        self.owner, self.name, self.n = owner, name, 0

    def __enter__(self):
        self.fn = getattr(self.owner, self.name)

        def wrapped(*a, **k):
            self.n += 1
            return self.fn(*a, **k)
        setattr(self.owner, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.fn)


def phase_long_windowed(hf, device):
    """16 (e): windowed context encoding at Mistral-7B-v0.1 width and
    depth, bf16, ``seq_len`` 16384 with full rows
    (``rolling_kv_cache=False``), ``windowed_context_encoding=2048``: one
    prompt of 12000 tokens prefilled in 6 windows of 2048 (each a
    2048-token decode step over the cache, eager), then 32 new tokens.
    Prints the prefill time, the peak memory and the window count, and
    how many tokens a 4000-token cut of the prompt generates alike
    windowed and one-shot (a count)."""
    import torch
    from neuronx_distributed_inference_tpu_torch.models import model_base
    cfg = MISTRAL_WCTE
    app = make_contiguous_app(hf, device, "bfloat16", batch=1,
                              seq_len=cfg["seq_len"], wcte=cfg["window"])
    app.init_random_weights(0)
    ids, mask = prompts_of((cfg["len"],), hf["vocab_size"], seed=18)
    torch.cuda.reset_peak_memory_stats()
    with CountCalls(model_base, "token_generation_multi") as calls:
        t0 = time.perf_counter()
        first = app.generate(ids, attention_mask=mask, max_new_tokens=1)
        torch.cuda.synchronize()
        pre_s = time.perf_counter() - t0
    windows = calls.n
    peak = torch.cuda.max_memory_allocated() / 1e9
    app.reset()
    emit({"phase": "long_windowed_profile",
          **profile_summary_of(*device_kernels(lambda: app.generate(
              ids, attention_mask=mask, max_new_tokens=1)))})
    app.reset()
    out = app.generate(ids, attention_mask=mask,
                       max_new_tokens=cfg["new_tokens"])
    gen = out["generated"]
    want_windows = -(-cfg["len"] // cfg["window"])
    emit({"phase": "long_windowed", "prompt_len": cfg["len"],
          "window": cfg["window"], "windows": windows,
          "prefill_ms": pre_s * 1e3, "peak_memory_gb": peak,
          "new_tokens": cfg["new_tokens"],
          "first_token_equal": bool(first["generated"][0, 0] == gen[0, 0])})
    if windows != want_windows:
        raise AssertionError(f"long_windowed: {windows} windows, expected "
                             f"{want_windows}")
    if gen.shape != (1, cfg["new_tokens"]) or not (
            (gen >= 0) & (gen < hf["vocab_size"])).all():
        raise AssertionError(f"long_windowed: bad tokens {gen.shape}")
    cut = ids[:, :cfg["one_shot_len"]]
    cut_mask = mask[:, :cfg["one_shot_len"]]
    app.reset()
    win = app.generate(cut, attention_mask=cut_mask,
                       max_new_tokens=cfg["new_tokens"])["generated"]
    one = make_contiguous_app(hf, device, "bfloat16", batch=1,
                              seq_len=cfg["seq_len"])
    one.params = app.params
    ref = one.generate(cut, attention_mask=cut_mask,
                       max_new_tokens=cfg["new_tokens"])["generated"]
    equal, prefix = agreement(win, ref)
    emit({"phase": "long_windowed_vs_one_shot_bf16",
          "prompt_len": cfg["one_shot_len"], "streams_equal": equal,
          "equal_prefix_tokens": prefix, "gate": False})
    del one, app
    memory_note("long_windowed")
    free_card()


def check_equal_streams(phase, got, want, logit_at):
    """Gate: ``got`` (B, T) equals ``want`` token for token; a row may
    first differ only where ``got``'s token sits within NEAR_TIE of the
    reference's top logit at that step (``logit_at(row, step)``, asked
    for only when a row differs). Returns the near ties."""
    import numpy as np
    got, want = np.asarray(got), np.asarray(want)
    ties = []
    for i in range(len(want)):
        if not (got[i] != want[i]).any():
            continue
        j = int(np.argmax(got[i] != want[i]))
        row = np.asarray(logit_at(i, j), np.float64)
        margin = float(row.max() - row[got[i, j]])
        ties.append({"row": i, "first_diff_step": j, "margin": margin})
        if not margin < NEAR_TIE:
            raise AssertionError(f"{phase}: row {i} differs at step {j}, "
                                 f"its token {margin} below the top logit")
    emit({"phase": phase, "streams": len(want), "tokens": want.shape[1],
          "streams_equal": len(want) - len(ties), "near_ties": ties,
          "near_tie_bound": NEAR_TIE})
    return ties


def batch_logit_at(make_ref, ids, mask, want):
    """``logit_at`` over one batch ``generate`` of a reference app with
    logits output, fed the reference's own tokens (built on first use)."""
    import numpy as np
    memo = {}
    lens = np.asarray(mask).sum(axis=1)

    def at(i, j):
        if "logits" not in memo:
            memo["logits"] = make_ref().generate(
                ids, attention_mask=mask, max_new_tokens=want.shape[1],
                return_logits=True, teacher_tokens=want[:, :-1])["logits"]
        lg = memo["logits"]
        return lg[0][i, lens[i] - 1] if j == 0 else lg[j][i, 0]
    return at


def prompt_logit_at(make_ref, prompts, want):
    """``logit_at`` over single-request ``generate`` calls (one per row,
    built on first use)."""
    import numpy as np
    memo = {}

    def at(i, j):
        if i not in memo:
            ref = memo.setdefault("app", make_ref())
            memo[i] = ref.generate(
                np.asarray([prompts[i]]), max_new_tokens=want.shape[1],
                return_logits=True, teacher_tokens=want[i:i + 1, :-1])[
                    "logits"]
            ref.reset()
        lg = memo[i]
        return lg[0][0, len(prompts[i]) - 1] if j == 0 else lg[j][0, 0]
    return at


def phase_long_fp32(device):
    with fp32_exact():
        _phase_long_fp32(device)


def _phase_long_fp32(device):
    """16 (f): fp32 cuts at LONG_CHECK_LAYERS layers (TF32 off), each
    pair equal token for token over LONG_CHECK_TOKENS new tokens (a first
    difference only at a near-tie of the reference's top-2 logits,
    printed): gpt-oss-20b's mixed cache against the uniform cache on (b)'s
    prompts; ``ContinuousBatchingAdapter`` on the mixed cache against
    each request's ``generate`` on (c)'s schedule; Mistral-7B-v0.1's
    rolling cache against ``rolling_kv_cache=False`` on (d)'s prompts;
    windowed context encoding against the one-shot prefill on (e)'s
    prompt cut to MISTRAL_WCTE["one_shot_len"] tokens."""
    import numpy as np
    import torch
    from neuronx_distributed_inference_tpu_torch.serving import \
        ContinuousBatchingAdapter
    n, new = LONG_CHECK_LAYERS, LONG_CHECK_TOKENS
    hf = oss_cut(n)
    lens, seq = OSS_LONG["lens"], OSS_LONG["seq_len"]
    b = len(lens)
    ids, mask = prompts_of(lens, hf["vocab_size"], seed=16)
    mix = make_pattern_app(hf, device, "float32", batch=b, seq_len=seq)
    init_weights(mix, 0)
    got = mix.generate(ids, attention_mask=mask,
                       max_new_tokens=new)["generated"]

    def oss_ref(**kw):
        ref = make_pattern_app(hf, device, "float32", batch=b, seq_len=seq,
                               **kw)
        ref.params = mix.params
        return ref
    want = oss_ref(mixed_kv=False).generate(
        ids, attention_mask=mask, max_new_tokens=new)["generated"]
    check_equal_streams("long_fp32_mixed_vs_uniform", got, want,
                        batch_logit_at(lambda: oss_ref(
                            mixed_kv=False, output_logits=True), ids, mask,
                            want))
    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, hf["vocab_size"], size=k).tolist()
               for k in RAGGED["lens"]]
    ad = ContinuousBatchingAdapter(oss_ref(cb=True))
    streams, _, _ = serve_cb(ad, prompts, new, torch.cuda.synchronize)
    del ad
    want = np.stack([mix.generate(np.asarray([p]), max_new_tokens=new)[
        "generated"][0] for p in prompts])
    check_equal_streams("long_fp32_cb_vs_generate", np.asarray(streams),
                        want, prompt_logit_at(
                            lambda: oss_ref(output_logits=True), prompts,
                            want))
    del mix
    free_card()

    hf = dict(MISTRAL_7B, num_hidden_layers=n)
    lens, seq = MISTRAL_ROLL["lens"], MISTRAL_ROLL["seq_len"]
    ids, mask = prompts_of(lens, hf["vocab_size"], seed=17)
    roll = make_contiguous_app(hf, device, "float32", batch=len(lens),
                               seq_len=seq, rolling=None)
    roll.init_random_weights(0)
    got = roll.generate(ids, attention_mask=mask,
                        max_new_tokens=new)["generated"]

    def mistral_ref(batch, **kw):
        ref = make_contiguous_app(hf, device, "float32", batch=batch,
                                  seq_len=seq, **kw)
        ref.params = roll.params
        return ref
    want = mistral_ref(len(lens)).generate(
        ids, attention_mask=mask, max_new_tokens=new)["generated"]
    check_equal_streams("long_fp32_rolling_vs_full", got, want,
                        batch_logit_at(lambda: mistral_ref(
                            len(lens), output_logits=True), ids, mask, want))
    cfg = MISTRAL_WCTE
    ids, mask = prompts_of((cfg["len"],), hf["vocab_size"], seed=18)
    ids = ids[:, :cfg["one_shot_len"]]
    mask = mask[:, :cfg["one_shot_len"]]
    got = mistral_ref(1, wcte=cfg["window"]).generate(
        ids, attention_mask=mask, max_new_tokens=new)["generated"]
    want = mistral_ref(1).generate(ids, attention_mask=mask,
                                   max_new_tokens=new)["generated"]
    check_equal_streams("long_fp32_windowed_vs_one_shot", got, want,
                        batch_logit_at(lambda: mistral_ref(
                            1, output_logits=True), ids, mask, want))
    del roll
    free_card()


def phase_long(device):
    """Group ``long`` (phase 16 (a)-(f)); returns its kernels-line
    entries: the contiguous decode kernel at (a)'s times with (b)'s
    launches, flash at (a)'s times with (d)'s launches."""
    import torch
    torch.cuda.reset_peak_memory_stats()
    times = phase_long_kernels(device)
    memory_note("long_kernels")
    check_card_empty("long_oss")
    hf = oss_cut(LONG_OSS_LAYERS)
    app, counts = phase_long_oss(hf, device)
    phase_long_oss_serving(hf, device, app)
    memory_note("long_oss_cb")
    del app
    free_card()
    mistral = dict(MISTRAL_7B, num_hidden_layers=LONG_MISTRAL_LAYERS)
    flash_launches = phase_long_rolling(mistral, device)
    phase_long_windowed(mistral, device)
    phase_long_fp32(device)
    memory_note("long_fp32")
    src = "neuronx_distributed_inference_tpu_torch/csrc/"
    jax_ops = "neuronx_distributed_inference_tpu/ops/"
    entries = []
    for name, key, fn, launches, path in (
            ("decode_attention_stacked", "decode", "decode_attention.py:41",
             counts["decode_attention_stacked"], "long_oss"),
            ("flash_attention", "flash", "flash_attention.py:28",
             flash_launches, "long_rolling")):
        t = times[key]
        entries.append({
            "name": name, "route": "cuda",
            "source": src + ("decode_attention.cu" if key == "decode"
                             else "flash_attention.cu"),
            "replaces": jax_ops + fn, "launches": launches,
            "max_abs_err": t["err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "path": path, "shape": t["shape"]})
    return entries


# ---------------------------------------------------------------------------
# Phase 17: DeepSeek's multi-head latent attention and mixed stack
# ---------------------------------------------------------------------------

def make_mla_app(hf, device, dtype, *, batch, seq_len, cb=False,
                 output_logits=False, graphs=True, chunk=1):
    """``TpuDeepseekForCausalLM`` (the contiguous app) with
    ``attn_kernel_enabled=True``: the kernel gates, not the config, keep
    MLA off the kernels. ``graphs=False``: the same app with every step
    eager."""
    from neuronx_distributed_inference_tpu_torch.config import TpuConfig
    from neuronx_distributed_inference_tpu_torch.models.application import \
        CausalLMApplication
    from neuronx_distributed_inference_tpu_torch.models.deepseek import (
        DeepseekFamily, DeepseekInferenceConfig, TpuDeepseekForCausalLM)
    cfg = DeepseekInferenceConfig(TpuConfig(
        batch_size=batch, seq_len=seq_len, dtype=dtype,
        attn_kernel_enabled=True, is_continuous_batching=cb,
        output_logits=output_logits, decode_chunk_tokens=chunk), **hf)
    app = (TpuDeepseekForCausalLM(None, cfg, device=device) if graphs
           else CausalLMApplication(None, cfg, DeepseekFamily,
                                    device=device, cuda_graphs=False))
    return app.init_cache()


def mla_plain_logits(hf, params, ids, rotate=True):
    """fp32 logits (T, V) of a 1-layer DeepSeek model (its one dense
    layer) on one row of token ids at positions 0..T-1, written from the
    published MLA equations with no port module: q = h Wq split into nope
    and rope parts; the latent c and the shared rope key from h Wkv_a;
    per-head nope keys and values from RMSNorm(c) Wkv_b; the rope parts
    rotated in HF's convention (each head's pairs permuted to halves,
    then rotate_half with cos/sin of cat(freqs, freqs)); causal softmax at
    scale 1/sqrt(nope + rope); o_proj, residual, dense GLU, residual,
    final RMSNorm, lm_head. ``rotate=False`` leaves the rope parts
    unrotated (the control). Weights are read from the parameter tree in
    its (in, out) layout."""
    import torch
    w = {k: v[0].float() for k, v in params["layers"].items()}
    nh, eps = hf["num_attention_heads"], hf["rms_norm_eps"]
    dn, dr, dv = (hf["qk_nope_head_dim"], hf["qk_rope_head_dim"],
                  hf["v_head_dim"])
    r = hf["kv_lora_rank"]

    def rms(x, g):
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * g

    def rope(x, cos, sin):                  # x (T, heads, dr)
        x = x.reshape(*x.shape[:-1], dr // 2, 2).transpose(-1, -2).reshape(
            x.shape)
        rot = torch.cat([-x[..., dr // 2:], x[..., :dr // 2]], dim=-1)
        return x * cos[:, None] + rot * sin[:, None]
    t = ids.shape[0]
    x = params["embed"][ids].float()
    h = rms(x, w["input_norm"])
    q = (h @ w["q_proj"]).reshape(t, nh, dn + dr)
    ckv = h @ w["kv_a_proj"]
    kv = (rms(ckv[:, :r], w["kv_a_norm"]) @ w["kv_b_proj"]).reshape(
        t, nh, dn + dv)
    inv = 1.0 / (hf["rope_theta"] ** (torch.arange(
        0, dr, 2, device=x.device).float() / dr))
    freqs = torch.arange(t, device=x.device).float()[:, None] * inv[None]
    emb = torch.cat([freqs, freqs], dim=-1)
    cos, sin = ((emb.cos(), emb.sin()) if rotate
                else (torch.ones_like(emb), torch.zeros_like(emb)))
    q = torch.cat([q[..., :dn], rope(q[..., dn:], cos, sin)], dim=-1)
    k_pe = rope(ckv[:, None, r:], cos, sin).expand(t, nh, dr)
    k = torch.cat([kv[..., :dn], k_pe], dim=-1)
    scores = torch.einsum("thd,shd->hts", q, k) * (dn + dr) ** -0.5
    causal = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()
    p = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    attn = torch.einsum("hts,shd->thd", p, kv[..., dn:]).reshape(t, nh * dv)
    x = x + attn @ w["o_proj"]
    h = rms(x, w["post_norm"])
    x = x + (torch.nn.functional.silu(h @ w["gate_proj"])
             * (h @ w["up_proj"])) @ w["down_proj"]
    return rms(x, params["final_norm"].float()) @ params["lm_head"].float()


def phase_mla_plain(device):
    with fp32_exact():
        _phase_mla_plain(device)


def _phase_mla_plain(device):
    """17 (a): one Moonlight-width layer (the dense layer 0, MLA) in fp32
    (TF32 off): the prefill's logits at every real position and
    MLA_PLAIN_STEPS decode steps' logits, each within TOL_MLA_PLAIN_REL of
    the largest logit of :func:`mla_plain_logits` on the same weights and
    tokens; the control (the reference's rope head unrotated) must part by
    more."""
    import numpy as np
    import torch
    hf = dict(MOONLIGHT_16B, num_hidden_layers=1)
    lens, steps = MLA_PLAIN_LENS, MLA_PLAIN_STEPS
    app = make_mla_app(hf, device, "float32", batch=len(lens), seq_len=512,
                       output_logits=True)
    init_weights(app, 0)
    ids, mask = prompts_of(lens, hf["vocab_size"], seed=17)
    out = app.generate(ids, attention_mask=mask, max_new_tokens=steps + 1,
                       return_logits=True)
    gen = out["generated"]
    errs, control, peak = [], [], 0.0
    for i, n in enumerate(lens):
        seq = torch.as_tensor(np.concatenate([ids[i, :n], gen[i, :steps]]),
                              device=device)
        with torch.no_grad():
            ref = mla_plain_logits(hf, app.params, seq).cpu().numpy()
            ctl = mla_plain_logits(hf, app.params, seq,
                                   rotate=False).cpu().numpy()
        got = np.concatenate([out["logits"][0][i, :n]]
                             + [out["logits"][j][i] for j in
                                range(1, steps + 1)])
        want = ref[:n + steps]
        peak = max(peak, float(np.abs(want).max()))
        errs.append(float(np.abs(got - want).max()))
        control.append(float(np.abs(ctl[:n + steps] - want).max()))
    rel, ctl_rel = max(errs) / peak, min(control) / peak
    emit({"phase": "mla_plain", "layers": 1, "prompt_lens": list(lens),
          "decode_steps": steps, "max_abs_err": max(errs),
          "max_abs_logit": peak, "rel_err": rel,
          "control_rel_err": ctl_rel, "tol_rel": TOL_MLA_PLAIN_REL,
          "gates": {"decode_kernel": decode_gate(app.spec),
                    "flash_prefill": flash_gate(app.spec, 512)}})
    if not rel <= TOL_MLA_PLAIN_REL:
        raise AssertionError(f"mla_plain: the MLA layer parts from the plain "
                             f"equations by {rel} of the largest logit")
    if not ctl_rel > TOL_MLA_PLAIN_REL:
        raise AssertionError(f"mla_plain: the control parts by only "
                             f"{ctl_rel}: the gate cannot see a rope fault")
    del app
    free_card()


def decode_gate(spec) -> bool:
    from neuronx_distributed_inference_tpu_torch.ops import decode_attention
    return decode_attention.supports(spec, 1)


def flash_gate(spec, bucket) -> bool:
    from neuronx_distributed_inference_tpu_torch.models import model_base
    return model_base.use_flash_prefill(spec, bucket)


def param_bytes(params) -> int:
    if isinstance(params, dict):
        return sum(param_bytes(v) for v in params.values())
    return params.numel() * params.element_size()


def mla_bytes_predicted(hf, batch, seq_len, item=2):
    """(weight bytes, cache bytes) from the geometry: the parameter count
    of the spec's tree, and K (nope + rope) plus V per token, layer and
    head."""
    h, v, nh = hf["hidden_size"], hf["vocab_size"], hf["num_attention_heads"]
    dn, dr, dv = (hf["qk_nope_head_dim"], hf["qk_rope_head_dim"],
                  hf["v_head_dim"])
    r = hf["kv_lora_rank"]
    layers, nd = hf["num_hidden_layers"], hf["first_k_dense_replace"]
    attn = (2 * h + h * nh * (dn + dr) + h * (r + dr) + r
            + r * nh * (dn + dv) + nh * dv * h)
    dense = 3 * h * hf["intermediate_size"]
    ie, e = hf["moe_intermediate_size"], hf["n_routed_experts"]
    moe = (h * e + e + 3 * e * h * ie
           + 3 * h * ie * hf["n_shared_experts"])
    n = (2 * v * h + h + layers * attn + nd * dense
         + (layers - nd) * moe)
    cache = layers * batch * nh * (dn + dr + dv) * seq_len * item
    # the router and its bias are fp32
    return n * item + (layers - nd) * (h * e + e) * (4 - item), cache


class RangeTimer:
    """``torch.profiler.record_function`` ranges around named functions
    (module, attribute, range) while it is entered, so a trace can sum the
    device time of the kernels each range launched."""

    def __init__(self, targets):
        self.targets = targets

    def __enter__(self):
        from torch.profiler import record_function
        self._orig = []
        for owner, name, label in self.targets:
            fn = getattr(owner, name)
            self._orig.append((owner, name, fn))

            def wrapped(*a, _fn=fn, _label=label, **k):
                with record_function(_label):
                    return _fn(*a, **k)
            setattr(owner, name, wrapped)
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self._orig:
            setattr(owner, name, fn)


def mla_decode_breakdown(app, ids, mask, steps):
    """Device ms per decode step by part, from a trace of ``steps`` eager
    decode steps (``app`` without graphs; the kernels of each part summed
    under a range): the MoE blocks (router, expert products, shared
    experts, combine), the dense layer's MLP, the MLA projections and
    rope, the attention cores (score and value products, mask, softmax:
    the gather path reads the cache's layer views in place), the cache
    writes, the lm_head and the rest (norms, o_proj, residuals, the
    sampler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from neuronx_distributed_inference_tpu_torch.models import model_base
    from neuronx_distributed_inference_tpu_torch.modules import kv_cache
    from neuronx_distributed_inference_tpu_torch.modules import moe
    from neuronx_distributed_inference_tpu_torch.ops import attention
    labels = ("mlp", "moe_block", "mla_projections", "attention_core",
              "cache_write", "lm_head")
    targets = [(model_base, "_mlp_block", "mlp"),
               (moe, "moe_block", "moe_block"),
               (model_base, "_mla_qkv", "mla_projections"),
               (attention, "mha_hl", "attention_core"),
               (attention, "mha_decode_merged", "attention_core"),
               (kv_cache, "write_tokens_at_layer", "cache_write"),
               (model_base, "_lm_head", "lm_head")]

    def trace(n):
        app.generate(ids, attention_mask=mask, max_new_tokens=1)
        torch.cuda.synchronize()
        with RangeTimer(targets), profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            app.generate(ids, attention_mask=mask, max_new_tokens=n)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        # host-side events only: a range's device time is the kernels it
        # and its children launched (its device-side annotation of the
        # same name spans the gaps between them too)
        by = dict.fromkeys(labels, 0.0)
        busy = 0.0
        for ev in prof.events():
            if ev.device_type != DeviceType.CPU:
                continue
            if ev.name in by:
                by[ev.name] += ev.device_time_total / 1e3
            if ev.cpu_parent is None:
                busy += ev.device_time_total / 1e3
        return wall, busy, by
    try:
        w0, b0, p0 = trace(1)
        w1, b1, p1 = trace(1 + steps)
    except RuntimeError as e:           # the profiler is optional equipment
        emit({"phase": "mla_decode_breakdown", "measured": False,
              "reason": str(e)[:200]})
        return
    per = {k: (p1[k] - p0[k]) / steps for k in labels}
    # the "mlp" range holds the MoE blocks: what is left is the dense
    # layer's MLP
    per["dense_mlp"] = per.pop("mlp") - per["moe_block"]
    busy = (b1 - b0) / steps
    per["rest"] = busy - sum(per.values())
    emit({"phase": "mla_decode_breakdown", "measured": busy > 0,
          "steps": steps, "eager_host_ms_per_step": (w1 - w0) / steps,
          "device_busy_ms_per_step": busy, "device_ms_per_step": per})


def phase_mla_generate(hf, device):
    """17 (b): Moonlight-16B-A3B through ``TpuDeepseekForCausalLM`` at
    full width (the MLA_CUT cut), bf16, ``seq_len`` MLA_SEQ, batch 4, prompts
    PROMPT_LENS, NEW_TOKENS new tokens, ``attn_kernel_enabled=True``,
    after ``precompile`` (decode replays graphs). Gates: both kernel
    gates say no and none of the three kernels launches; no incident;
    cache K (L, 4, 16, 192, S) and V (L, 4, 16, S, 128); full in-vocab
    streams. Prints weight and cache bytes beside the geometry's, peak
    memory, prefill and decode step times, the decode steps' device
    profile (graph replays) and a breakdown by part (eager steps).
    Returns the app."""
    import torch
    check_card_empty("mla_generate")
    torch.cuda.reset_peak_memory_stats()
    lens, new = PROMPT_LENS, NEW_TOKENS
    app = make_mla_app(hf, device, "bfloat16", batch=len(lens),
                       seq_len=MLA_SEQ)
    init_weights(app, 0)
    ids, mask = prompts_of(lens, hf["vocab_size"], seed=0)
    warm(app, "mla_generate")
    reset_launches([app])
    t0 = time.perf_counter()
    out = app.generate(ids, attention_mask=mask, max_new_tokens=new)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    counts = kernel_counts([app])
    gen = out["generated"]
    shapes = {k: list(app.cache[k].shape) for k in ("k", "v")}
    layers, nh = hf["num_hidden_layers"], hf["num_attention_heads"]
    dk = hf["qk_nope_head_dim"] + hf["qk_rope_head_dim"]
    want_shapes = {"k": [layers, len(lens), nh, dk, MLA_SEQ],
                   "v": [layers, len(lens), nh, MLA_SEQ, hf["v_head_dim"]]}
    w_pred, c_pred = mla_bytes_predicted(hf, len(lens), MLA_SEQ)
    emit({"phase": "mla_generate", "entry": "TpuDeepseekForCausalLM",
          "seq_len": MLA_SEQ, "prompt_lens": list(lens), "new_tokens": new,
          "generate_s": gen_s, "launches": counts,
          "gates": {"decode_kernel": decode_gate(app.spec),
                    "flash_prefill": flash_gate(app.spec, 2048)},
          "cache_shapes": shapes, "weight_bytes": param_bytes(app.params),
          "weight_bytes_geometry": w_pred, "cache_bytes": cache_bytes(app),
          "cache_bytes_geometry": c_pred,
          "graphs": graph_report(app) if app.graphs is not None else None})
    check_no_incidents("mla_generate", app)
    if any(counts.values()):
        raise AssertionError(f"mla_generate: kernel launches {counts} on "
                             "the MLA path")
    if decode_gate(app.spec) or flash_gate(app.spec, 2048):
        raise AssertionError("mla_generate: a kernel gate admits MLA")
    if shapes != want_shapes:
        raise AssertionError(f"mla_generate: cache shapes {shapes}")
    if gen.shape != (len(lens), new) or not (
            (gen >= 0) & (gen < hf["vocab_size"])).all():
        raise AssertionError(f"mla_generate: bad tokens {gen.shape}")
    pre, step = step_times(app, ids, mask)
    emit({"phase": "mla_generate_steps", "prefill_ms_batch": pre,
          "decode_ms_per_step_batch4": step, "prompt_lens": list(lens),
          "ctx_bucket": 2048})
    eager = make_mla_app(hf, device, "bfloat16", batch=len(lens),
                         seq_len=MLA_SEQ, graphs=False)
    eager.params = app.params
    mla_decode_breakdown(eager, ids, mask, 8)
    del eager
    free_card()
    memory_note("mla_generate")
    return app


def phase_mla_serving(hf, device, app):
    """17 (c): (b)'s weights behind ``ContinuousBatchingAdapter`` (an app
    built with ``is_continuous_batching=True``, after ``precompile``):
    phase 9's 8 requests of 37-1900 tokens over batch 4, RAGGED_TOKENS new
    tokens each, through the adapter's add / step / release loop. Gates:
    no kernel launch, full in-vocab streams, no incident. Prints host ms
    per decode pass and per admission, TTFT per request and the streams
    (bf16 equality with ``generate`` is not gated: the admission prefill
    runs at other buckets, so other GEMMs and other expert flips; 17 (d)
    holds the streams in fp32)."""
    import numpy as np
    import torch
    from neuronx_distributed_inference_tpu_torch.serving import \
        ContinuousBatchingAdapter
    lens, new = RAGGED["lens"], RAGGED_TOKENS
    cb = make_mla_app(hf, device, "bfloat16", batch=len(PROMPT_LENS),
                      seq_len=MLA_SEQ, cb=True)
    cb.params = app.params
    warm(cb, "mla_cb")
    ad = ContinuousBatchingAdapter(cb)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, hf["vocab_size"], size=n).tolist()
               for n in lens]
    reset_launches([cb])
    streams, recs, ttft = serve_cb(ad, prompts, new, torch.cuda.synchronize)
    counts = kernel_counts([cb])
    check_no_incidents("mla_cb", cb)
    emit({"phase": "mla_cb", "requests": len(prompts),
          "prompt_lens": list(lens), "new_tokens": new,
          "passes": {k: pass_summary(recs, k) for k in ("admit", "decode")},
          "ttft_s": [ttft[i] for i in range(len(prompts))],
          "launches": counts, "streams": streams, "host_stats": {
              k: v for k, v in ad.host_stats.items() if isinstance(v, int)}})
    for i, st in enumerate(streams):
        if len(st) != new or not all(0 <= t < hf["vocab_size"] for t in st):
            raise AssertionError(f"mla_cb: stream {i} has {len(st)} tokens")
    if any(counts.values()):
        raise AssertionError(f"mla_cb: kernel launches {counts}")
    del ad, cb
    memory_note("mla_cb")


def phase_mla_fp32(device):
    with fp32_exact():
        _phase_mla_fp32(device)


def _phase_mla_fp32(device):
    """17 (d), TF32 off: (1) a MLA_CHECK_LAYERS[0]-layer cut (1 dense + 3
    MoE), fp32: ``generate`` replaying graphs (after ``precompile``),
    eager ``generate``, the chunked side-buffer decode loop
    (``decode_chunk_tokens`` 4) and ``ContinuousBatchingAdapter`` streams
    of phase 9's requests against each request's ``generate``, all equal
    token for token (a first difference only at a near-tie of the
    reference's top-2 logits, printed); (2) the MLA_CHECK_LAYERS[1]-layer
    cut in bf16 held to the same cut in fp32 by the relative RMS of
    teacher-forced decode logits (TOL_MLA_BF16_REL), with the control (the
    bf16 cut with the rope pairing flipped) parting by more; the bf16 cut
    with the rope head unrotated is printed beside it."""
    import dataclasses

    import numpy as np
    import torch
    from neuronx_distributed_inference_tpu_torch.serving import \
        ContinuousBatchingAdapter
    n, new = MLA_CHECK_LAYERS[0], MLA_CHECK_TOKENS
    hf = dict(MOONLIGHT_16B, num_hidden_layers=n)
    lens = PROMPT_LENS
    b = len(lens)
    ids, mask = prompts_of(lens, hf["vocab_size"], seed=0)
    g = make_mla_app(hf, device, "float32", batch=b, seq_len=MLA_SEQ)
    init_weights(g, 0)
    warm(g, "mla_fp32", declare_steady=False)
    got = g.generate(ids, attention_mask=mask,
                     max_new_tokens=new)["generated"]

    def ref(**kw):
        a = make_mla_app(hf, device, "float32", batch=b, seq_len=MLA_SEQ,
                         **kw)
        a.params = g.params
        return a
    want = ref(graphs=False).generate(ids, attention_mask=mask,
                                      max_new_tokens=new)["generated"]
    logit_at = batch_logit_at(lambda: ref(graphs=False, output_logits=True),
                              ids, mask, want)
    check_equal_streams("mla_fp32_graphs_vs_eager", got, want, logit_at)
    chunked = ref(chunk=4).generate(ids, attention_mask=mask,
                                    max_new_tokens=new)["generated"]
    check_equal_streams("mla_fp32_chunked_vs_eager", chunked, want,
                        logit_at)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, hf["vocab_size"], size=k).tolist()
               for k in RAGGED["lens"]]
    ad = ContinuousBatchingAdapter(ref(cb=True))
    streams, _, _ = serve_cb(ad, prompts, new, torch.cuda.synchronize)
    del ad
    single = np.stack([g.generate(np.asarray([p]), max_new_tokens=new)[
        "generated"][0] for p in prompts])
    check_equal_streams("mla_fp32_cb_vs_generate", np.asarray(streams),
                        single, prompt_logit_at(
                            lambda: ref(output_logits=True), prompts,
                            single))
    del g
    free_card()

    n = MLA_CHECK_LAYERS[1]
    hf = dict(MOONLIGHT_16B, num_hidden_layers=n)
    bf = make_mla_app(hf, device, "bfloat16", batch=b, seq_len=MLA_SEQ,
                      output_logits=True)
    init_weights(bf, 0)
    tokens = bf.generate(ids, attention_mask=mask,
                         max_new_tokens=new)["generated"]
    lg = {"bf16": decode_logits(bf, ids, mask, tokens)}
    for kind in ("control", "unrotated"):
        ctl = make_mla_app(hf, device, "bfloat16", batch=b, seq_len=MLA_SEQ,
                           output_logits=True)
        if kind == "control":
            ctl.spec = dataclasses.replace(ctl.spec, rope_interleaved=False)
        else:
            ctl._inv_freq.zero_()
        ctl.params = bf.params
        lg[kind] = decode_logits(ctl, ids, mask, tokens)
        del ctl
    fp = make_mla_app(hf, device, "float32", batch=b, seq_len=MLA_SEQ,
                      output_logits=True)
    fp.params = _upcast(bf.params)
    del bf
    free_card()
    lg["fp32"] = decode_logits(fp, ids, mask, tokens)
    del fp
    free_card()
    if not all(np.isfinite(x).all() for v in lg.values() for x in v):
        raise AssertionError("mla_bf16_vs_fp32: non-finite logits")
    rel = logits_rel_rms(lg["bf16"], lg["fp32"])
    control = logits_rel_rms(lg["control"], lg["fp32"])
    emit({"phase": "mla_bf16_vs_fp32", "layers": n,
          "steps": len(lg["fp32"]), "rel_rms": rel,
          "control_rel_rms": control,
          "unrotated_rel_rms": logits_rel_rms(lg["unrotated"], lg["fp32"]),
          "rel_rms_by_step_max": max(logits_rel_rms([x], [y]) for x, y in
                                     zip(lg["bf16"], lg["fp32"])),
          "logit_std": float(np.std(lg["fp32"][0])),
          "tol": TOL_MLA_BF16_REL})
    if not rel <= TOL_MLA_BF16_REL:
        raise AssertionError(f"mla_bf16_vs_fp32: relative RMS {rel}")
    if not control > TOL_MLA_BF16_REL:
        raise AssertionError(f"mla_bf16_vs_fp32: the control parts by only "
                             f"{control}: the gate cannot see a rope fault")


def phase_mla(device):
    """Group ``mla`` (phase 17 (a)-(d)). Its path launches none of the
    three kernels (both gates turn MLA away, as the reference's do), so it
    adds no kernels-line entry."""
    import torch
    torch.cuda.reset_peak_memory_stats()
    phase_mla_plain(device)
    memory_note("mla_plain")
    hf = dict(MOONLIGHT_16B, num_hidden_layers=MLA_CUT)
    app = phase_mla_generate(hf, device)
    phase_mla_serving(hf, device, app)
    del app
    free_card()
    phase_mla_fp32(device)
    memory_note("mla_fp32")


# ---------------------------------------------------------------------------
# Phase 18: quantized and low-rank weights
# ---------------------------------------------------------------------------

def sync_card(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize()


def quant_tree(fn, params):
    """``params`` with every quantized leaf-group replaced by
    ``fn(leaf)``."""
    if isinstance(params, dict):
        if "qweight" in params:
            return fn(params)
        return {k: quant_tree(fn, v) for k, v in params.items()}
    return params


def flipped_scales(params):
    """The control of 18 (d): every scale reversed along its output axis
    (each output channel gets another channel's scale)."""
    return quant_tree(lambda q: dict(q, scale=q["scale"].flip(-1)), params)


def dequantized_params(params, dtype):
    """The unquantized twin's tree: every quantized leaf-group decoded to
    ``dtype`` (``quantization.dequantize``)."""
    from neuronx_distributed_inference_tpu_torch.modules import quantization
    return quant_tree(lambda q: quantization.dequantize(q, dtype), params)


def quant_bytes_predicted(app):
    """Weight bytes from the geometry: each leaf of the spec's tree in its
    dtype, a leaf the quantization converts as its codes (1 byte a value,
    or half a byte for MXFP4) plus fp32 scales (one per output channel, or
    per group of the contraction axis for MXFP4 and blockwise), a low-rank
    leaf as its two factors."""
    from neuronx_distributed_inference_tpu_torch.models import model_base
    from neuronx_distributed_inference_tpu_torch.modules import quantization
    spec = app.spec
    q, lr = spec.quant, spec.low_rank

    def quantized(lead, k, n):
        m = math.prod(lead)
        if q.dtype == quantization.MXFP4:
            return m * (k * n // 2 + 4 * (k // q.group_size) * n)
        groups = {quantization.PER_TENSOR: 1.0 / n,
                  quantization.PER_CHANNEL: 1,
                  quantization.BLOCKWISE: k // q.group_size}[q.scheme]
        return m * (k * n + int(4 * groups * n))

    def leaf(name, ps):
        item = ps.dtype.itemsize
        *lead, k, n = (1, 1) + tuple(ps.shape)
        if lr is not None and lr.converts(name):
            r = min(lr.rank, k, n)
            if q is not None and q.converts(name):
                return quantized(lead, k, r) + quantized(lead, r, n)
            return math.prod(lead) * (k + n) * r * item
        if q is not None and q.converts(name):
            return quantized(lead, k, n)
        return math.prod(ps.shape) * item

    def walk(node, name=""):
        if isinstance(node, dict):
            return sum(walk(v, k) for k, v in node.items())
        return leaf(name, node)
    return walk(model_base.decoder_param_specs(spec))


def rel_max(got, want) -> float:
    """max |got - want| over max |want| (fp64)."""
    g, w = got.double(), want.double()
    return float((g - w).abs().max() / w.abs().max().clamp_min(1e-300))


def fp4_decode_fp64(leaf):
    """An independent fp64 decode of an MXFP4 leaf-group (codes unpacked
    by slicing, the 16-value table, each scale repeated over its group)."""
    import torch
    from neuronx_distributed_inference_tpu_torch.modules import quantization
    q, scale = leaf["qweight"], leaf["scale"]
    *lead, kh, n = q.shape
    codes = torch.empty((*lead, 2 * kh, n), dtype=torch.long,
                        device=q.device)
    codes[..., 0::2, :] = (q & 0x0F).long()
    codes[..., 1::2, :] = (q >> 4).long()
    table = torch.as_tensor(quantization._FP4_VALUES, dtype=torch.float64,
                            device=q.device)
    group = 2 * kh // scale.shape[-2]
    return table[codes] * scale.double().repeat_interleave(group, dim=-2)


def phase_quant_products(device):
    with fp32_exact():
        _phase_quant_products(device)


def _phase_quant_products(device):
    """18 (a): one gpt-oss-20b expert stack (MXFP4) and one Llama-3.1-8B
    MLP layer (int8 per-channel and fp8 blockwise), bf16 draws from seed
    0, quantized on the card and on the CPU by the same port function
    (codes and scales must be equal); then ``dequantize``, ``qlinear``,
    ``qmatmul`` and ``qeinsum`` on the card held to the fp64 product of
    the dequantized weight (TF32 off), each beside a control that applies
    the scales along the wrong axis."""
    import torch
    from neuronx_distributed_inference_tpu_torch.modules import quantization
    gen = torch.Generator(device=device).manual_seed(0)

    def draw(*shape):
        return torch.empty(shape, dtype=torch.bfloat16,
                           device=device).normal_(0.0, 0.02, generator=gen)
    e, h = GPT_OSS_20B["num_local_experts"], GPT_OSS_20B["hidden_size"]
    i = GPT_OSS_20B["intermediate_size"]
    lh, li = LLAMA_3_1_8B["hidden_size"], LLAMA_3_1_8B["intermediate_size"]
    weights = {"oss_expert_gate": draw(e, h, i), "oss_expert_up": draw(
        e, h, i), "oss_expert_down": draw(e, i, h),
        "llama_gate_proj": draw(lh, li), "llama_up_proj": draw(lh, li),
        "llama_down_proj": draw(li, lh)}
    specs = {"mxfp4": quantization.QuantSpec(quantization.MXFP4),
             "int8_channel": quantization.QuantSpec(),
             "fp8_blockwise": quantization.QuantSpec(
                 quantization.FP8, quantization.BLOCKWISE)}
    leaves, rows = {}, []
    for name, w in weights.items():
        for sname in (("mxfp4",) if name.startswith("oss")
                      else ("int8_channel", "fp8_blockwise")):
            spec = specs[sname]
            sync_card(device)
            t0 = time.perf_counter()
            card = quantization.quantize_tensor(w, spec)
            sync_card(device)
            card_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            cpu = quantization.quantize_tensor(w.cpu(), spec)
            cpu_s = time.perf_counter() - t0

            def raw(t):
                return t.view(torch.uint8) if t.element_size() == 1 else t
            codes = int((raw(card["qweight"]).cpu()
                         != raw(cpu["qweight"])).sum())
            scales = int((card["scale"].cpu() != cpu["scale"]).sum())
            rows.append({"weight": name, "scheme": sname,
                         "shape": list(w.shape), "card_s": card_s,
                         "cpu_s": cpu_s, "codes": card["qweight"].numel(),
                         "differing_codes": codes,
                         "differing_scales": scales})
            if codes or scales:
                raise AssertionError(f"quant_products: {name} {sname}: "
                                     f"{codes} codes, {scales} scales "
                                     "differ between the card and the CPU")
            leaves[(name, sname)] = card
            del cpu
    emit({"phase": "quant_quantizers", "weights": rows})
    x = torch.randn((8, lh), generator=gen, device=device)
    checks = []

    def check(name, got, want, control, tol):
        err, ctl = rel_max(got, want), rel_max(control, want)
        checks.append({"check": name, "rel_err": err, "control_rel": ctl,
                       "tol": tol, "control_min": TOL_QUANT_CONTROL_REL})
        return err <= tol and ctl > TOL_QUANT_CONTROL_REL

    ok = True
    # int8 per-channel: codes x scale (1, N); the control puts the first K
    # of the N channel scales along the contraction axis
    leaf = leaves[("llama_gate_proj", "int8_channel")]
    q, s = leaf["qweight"].double(), leaf["scale"].double()
    w64 = q * s
    wrong = q * s.reshape(-1)[:lh, None]
    ok &= check("dequantize_int8_channel",
                quantization.dequantize(leaf, torch.float32), w64, wrong,
                TOL_DEQUANT_REL)
    ok &= check("qlinear_int8_channel", quantization.qlinear(x, leaf),
                x.double() @ w64, x.double() @ wrong, TOL_QUANT_PRODUCT_REL)
    # fp8 blockwise (down_proj, K = 14336 in groups of 32)
    leaf = leaves[("llama_down_proj", "fp8_blockwise")]
    q = leaf["qweight"].double()
    s = leaf["scale"].double()
    w64 = q * s.repeat_interleave(32, dim=0)
    # the control applies the group scales to the wrong contraction groups
    wrong = q * s.flip(0).repeat_interleave(32, dim=0)
    xd = torch.randn((8, li), generator=gen, device=device)
    ok &= check("qlinear_fp8_blockwise", quantization.qlinear(xd, leaf),
                xd.double() @ w64, xd.double() @ wrong,
                TOL_QUANT_PRODUCT_REL)
    # MXFP4 expert stack (K = N = 2880): the control reads the group
    # scales transposed (group of output channels, contraction channel)
    leaf = leaves[("oss_expert_gate", "mxfp4")]
    w64 = fp4_decode_fp64(leaf)
    sc = leaf["scale"].double()                          # (E, K/32, N)
    vals = w64 / sc.repeat_interleave(32, dim=-2)
    wrong = vals * sc.transpose(-1, -2).repeat_interleave(32, dim=-1)
    ok &= check("dequantize_mxfp4",
                quantization.dequantize(leaf, torch.bfloat16), w64, wrong,
                0.0)
    xe = x[:, :h].contiguous()
    ok &= check("qmatmul_mxfp4_experts",
                quantization.qmatmul(xe[None], leaf),
                xe.double()[None] @ w64, xe.double()[None] @ wrong,
                TOL_QUANT_PRODUCT_REL)
    ok &= check("qeinsum_mxfp4_experts",
                quantization.qeinsum("th,ehi->tei", xe, leaf),
                torch.einsum("th,ehi->tei", xe.double(), w64),
                torch.einsum("th,ehi->tei", xe.double(), wrong),
                TOL_QUANT_PRODUCT_REL)
    emit({"phase": "quant_products", "checks": checks})
    if not ok:
        raise AssertionError(f"quant_products: {checks}")


def phase_quant_oss(device):
    """18 (b): gpt-oss-20b at full width, cut to QUANT_OSS_LAYERS, with
    in-graph MXFP4 experts (and ``o_proj``), bf16, on phase 15's engine,
    schedule and prompts (:func:`serve_with_moe_share`: phase 9's gates,
    the paged kernel's launches = layers x all-decode steps, the MoE
    blocks' share, the
    kernel over the served cache at a local and a global layer); weight
    bytes against the geometry's. Returns the kernels-line entries."""
    hf = oss_cut(QUANT_OSS_LAYERS)
    with PagedArgsSpy() as spy:
        entries = serve_with_moe_share(
            hf, device, "quant_oss_serving", oss_dense_block_ms,
            kernel_layers=(-2, -1), tcfg_over=MXFP4_WEIGHTS)
    check_layer_args("quant_oss_serving", spy.calls, hf)
    return entries


def check_weight_bytes(phase, app):
    """Gate: the app's weight bytes equal the geometry's
    (:func:`quant_bytes_predicted`); emits both."""
    got, want = param_bytes(app.params), quant_bytes_predicted(app)
    emit({"phase": phase + "_weight_bytes", "weight_bytes": got,
          "predicted_bytes": want, "weight_gb": got / 1e9})
    if got != want:
        raise AssertionError(f"{phase}: weight bytes {got} != the "
                             f"geometry's {want}")


def phase_quant_llama(device):
    """18 (c): Llama-3.1-8B at full width, cut to LLAMA_CUT layers, with
    int8 per-channel weights and the scaled fp8 KV cache
    (``kv_cache_scale`` 2^-5), bf16, on phase 9's engine, schedule and
    prompts (phase 9's gates; the paged kernel over fp8 pages, its
    launches = the layers x all-decode steps); weight
    and cache bytes, the largest stored |K/V| against e4m3's 448, and the
    kernel held to its twin and timed over the served fp8 pages. Returns
    the kernels-line entry."""
    import torch
    check_card_empty("quant_llama_serving")
    app, _, entries, _ = phase_ragged_serving(
        dict(LLAMA_3_1_8B, num_hidden_layers=LLAMA_CUT), device, cfg=RAGGED,
        on_card=device.type == "cuda", phase="quant_llama_serving",
        tcfg_over=dict(INT8_WEIGHTS, **FP8_KV))
    stored = max(float(app.cache[k].float().abs().max()) for k in ("k", "v"))
    emit({"phase": "quant_llama_cache", "cache_bytes": cache_bytes(app),
          "cache_dtype": str(app.cache["k"].dtype), "kv_scale":
          app.spec.kv_scale, "max_abs_stored": stored,
          "max_abs_kv": stored * app.spec.kv_scale, "e4m3_max": 448.0})
    if not (app.cache["k"].dtype == torch.float8_e4m3fn
            and stored < 448.0):
        raise AssertionError("quant_llama_cache: the fp8 cache saturated "
                             f"(largest stored |x| {stored})")
    memory_note("quant_llama_serving")
    del app
    free_card()
    return entries


def bf16_quant_drift(hf, device, weights, phase):
    """18 (d), bf16, at ``hf``'s depth: the teacher-forced decode logits of the
    quantized app against the unquantized app on the same draws (seed 0),
    fed the unquantized app's greedy tokens; the control is the quantized
    app with every scale flipped along its output axis. Apps are built,
    read and dropped in turn. Reported with their predictions (PERF.md):
    random-weight stacks magnify any perturbation, so this is a reading,
    and the gates are 18 (a) and the fp32 twins."""
    import numpy as np
    ids, mask = prompts_of(QUANT_LENS, hf["vocab_size"], seed=0)

    def build(**over):
        app = make_app(hf, device, "bfloat16", batch=len(QUANT_LENS),
                       seq_len=2048, output_logits=True, graphs=False,
                       **over)
        return init_weights(app, 0)
    plain = build()
    out = plain.generate(ids, attention_mask=mask,
                         max_new_tokens=QUANT_BF16_TOKENS + 1,
                         return_logits=True)
    tokens = out["generated"]
    ref = out["logits"][1:]
    del plain, out
    free_card()
    app = build(**weights)
    got = decode_logits(app, ids, mask, tokens)
    app.params = flipped_scales(app.params)
    control = decode_logits(app, ids, mask, tokens)
    del app
    free_card()
    if not all(np.isfinite(x).all() for x in got + control):
        raise AssertionError(f"{phase}: non-finite logits")
    emit({"phase": phase, "steps": len(ref),
          "rel_rms": logits_rel_rms(got, ref),
          "rel_rms_first_step": logits_rel_rms(got[:1], ref[:1]),
          "control_rel_rms": logits_rel_rms(control, ref),
          "argmax_agreement": float(np.mean([
              (a.argmax(-1) == b.argmax(-1)).mean()
              for a, b in zip(got, ref)])),
          "logit_std": float(np.std(ref[0]))})


def phase_quant_twin(hf, device, weights, phase):
    with fp32_exact():
        _phase_quant_twin(hf, device, weights, phase)


def _phase_quant_twin(hf, device, weights, phase):
    """18 (d) sharp check, fp32 (TF32 off), at a 4-layer cut: the
    quantized app Q against the unquantized app D holding Q's dequantized
    weights (the same function up to the scales' rounding). Q's ragged
    engine (graphs; paged launches = layers x all-decode steps), Q's
    ``generate`` replaying graphs and the same ``generate`` eager give the
    same streams; so do Q's and D's eager ``generate`` (a first difference
    only at a near-tie); D's teacher-forced logits are within
    TOL_QUANT_TWIN_REL relative RMS of Q's; the control (Q with every
    scale flipped) parts by more than TOL_QUANT_CONTROL_REL. With an fp8
    cache in ``weights`` the identity runs take it, while the twin pair
    runs over an fp32 cache: K and V an fp32 rounding apart may store
    values an e4m3 step apart, which would hide the weights' agreement."""
    import numpy as np
    import torch
    on_card = device.type == "cuda"
    kv = {k: v for k, v in weights.items() if k.startswith("kv_cache")}
    b = len(QUANT_LENS)

    def build(graphs=True, **over):
        return make_ragged_app(hf, device, "float32", RAGGED, batch=b,
                               output_logits=True, graphs=graphs, **over)
    q = init_weights(build(**weights), 0)
    ids, mask = prompts_of(QUANT_LENS, hf["vocab_size"], seed=0)
    prompts = [list(r[:n]) for r, n in zip(ids.tolist(), QUANT_LENS)]
    warm(q, phase, chunk_tokens=RAGGED["chunk"])
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    layers = hf["num_hidden_layers"]
    streams, recs, launches, steps = _ragged_run(
        phase, q, prompts, QUANT_CHECK_TOKENS, RAGGED, sync, layers,
        on_card)
    check_no_incidents(phase, q)
    g = build(**kv)
    g.params = q.params
    want = g.generate(ids, attention_mask=mask,
                      max_new_tokens=QUANT_CHECK_TOKENS, return_logits=True)
    del g
    e = build(graphs=False, **kv)
    e.params = q.params
    runs = {"ragged": (np.asarray([s.tokens for s in streams]), want),
            "eager": (e.generate(ids, attention_mask=mask,
                                 max_new_tokens=QUANT_CHECK_TOKENS)[
                                     "generated"], want)}
    if kv:
        e = build(graphs=False)
        e.params = q.params
        base = e.generate(ids, attention_mask=mask,
                          max_new_tokens=QUANT_CHECK_TOKENS,
                          return_logits=True)
    else:
        base = want
    d = build(graphs=False)
    d.params = dequantized_params(q.params, torch.float32)
    runs["dequantized_twin"] = (d.generate(
        ids, attention_mask=mask,
        max_new_tokens=QUANT_CHECK_TOKENS)["generated"], base)
    tokens = base["generated"]
    ref = decode_logits(d, ids, mask, tokens)
    got = base["logits"][1:]
    e.params = flipped_scales(q.params)
    control = decode_logits(e, ids, mask, tokens)
    lens = mask.sum(axis=1)
    ties = {}
    for name, (run, against) in runs.items():
        def logit_at(i, j, lg=against["logits"]):
            return lg[0][i, lens[i] - 1] if j == 0 else lg[j][i, 0]
        ties[name] = check_equal_streams(f"{phase}_{name}", run,
                                         against["generated"], logit_at)
    rel, ctl = logits_rel_rms(got, ref), logits_rel_rms(control, ref)
    emit({"phase": phase, "layers": layers, "launches": launches,
          "all_decode_ragged_steps": steps, "passes": len(recs),
          "twin_cache": "float32", "identity_cache": str(
              q.cache["k"].dtype).replace("torch.", ""),
          "twin_rel_rms": rel, "control_rel_rms": ctl,
          "tol": TOL_QUANT_TWIN_REL, "control_min": TOL_QUANT_CONTROL_REL,
          "near_ties": {k: len(v) for k, v in ties.items()}})
    if not rel <= TOL_QUANT_TWIN_REL:
        raise AssertionError(f"{phase}: the dequantized twin's logits part "
                             f"by relative RMS {rel}")
    if not ctl > TOL_QUANT_CONTROL_REL:
        raise AssertionError(f"{phase}: the control parts by only {ctl}: "
                             "the gate cannot see a misapplied scale")


def phase_quant_low_rank(device):
    """18 (e): Llama-3.2-1B at full width, cut to QUANT_LOW_RANK_LAYERS,
    with ``mlp_low_rank`` 512 and int8 weights (the factors quantized),
    bf16, on the paged app: ``generate`` of 64 new tokens for phase 3's
    prompts after ``precompile``, the paged kernel's launches = layers x
    63 decode steps;
    the MLP's bytes against ``compression_report``; decode step times. At
    a 4-layer fp32 cut, full rank (2048 = min(H, I)) gives the dense
    app's streams and logits within TOL_LOW_RANK_FULL_REL, and the
    control (the same factors cut to half rank) parts."""
    import torch
    from neuronx_distributed_inference_tpu_torch.modules import low_rank
    hf = dict(LLAMA_3_2_1B, num_hidden_layers=QUANT_LOW_RANK_LAYERS)
    h, i = hf["hidden_size"], hf["intermediate_size"]
    layers = hf["num_hidden_layers"]
    w = torch.randn((h, i), device=device) * 0.02
    t0 = time.perf_counter()
    full = low_rank.factorize_tensor(w, min(h, i))
    sync_card(device)
    svd_s = time.perf_counter() - t0
    rebuild = low_rank.reconstruction_error(w, full)
    del w, full
    app = make_app(hf, device, "bfloat16", batch=len(QUANT_LENS),
                   seq_len=2048, mlp_low_rank=QUANT_LOW_RANK,
                   **INT8_WEIGHTS)
    t0 = time.perf_counter()
    init_weights(app, 0)
    sync_card(device)
    init_s = time.perf_counter() - t0
    check_weight_bytes("quant_low_rank", app)
    mlp = sum(param_bytes(app.params["layers"][k])
              for k in ("gate_proj", "up_proj", "down_proj"))
    rep = low_rank.compression_report(h, i, layers, QUANT_LOW_RANK,
                                      bytes_per_param=1)
    ids, mask = prompts_of(QUANT_LENS, hf["vocab_size"], seed=0)
    warm(app, "quant_low_rank")
    reset_launches([app])
    out = app.generate(ids, attention_mask=mask, max_new_tokens=NEW_TOKENS)
    launches = kernel_counts([app])["paged_decode_attention"]
    want = layers * (NEW_TOKENS - 1) if device.type == "cuda" else 0
    check_no_incidents("quant_low_rank", app)
    pre, step = (step_times(app, ids, mask, k=16)
                 if device.type == "cuda" else (None, None))
    emit({"phase": "quant_low_rank", "rank": QUANT_LOW_RANK,
          "factorize_2048x8192_s": svd_s,
          "full_rank_rebuild_rel": rebuild, "init_s": init_s,
          "mlp_bytes": mlp, "report_low_rank_mlp_bytes":
          rep["low_rank_mlp_bytes"], "report_dense_mlp_bytes":
          rep["dense_mlp_bytes"], "scale_bytes": mlp
          - rep["low_rank_mlp_bytes"], "launches": launches,
          "expected_launches": want, "prefill_ms": pre,
          "decode_ms_per_step": step,
          "generated_shape": list(out["generated"].shape)})
    if launches != want:
        raise AssertionError(f"quant_low_rank: paged kernel launches "
                             f"{launches} != {want}")
    del app
    free_card()
    with fp32_exact():
        _quant_low_rank_full(hf, device)


def _quant_low_rank_full(hf, device):
    import numpy as np
    cut = dict(hf, num_hidden_layers=QUANT_CHECK_LAYERS)
    ids, mask = prompts_of(QUANT_LENS, hf["vocab_size"], seed=0)
    full_rank = min(hf["hidden_size"], hf["intermediate_size"])

    def build(**over):
        app = make_app(cut, device, "float32", batch=len(QUANT_LENS),
                       seq_len=2048, output_logits=True, **over)
        return init_weights(app, 0)
    dense = build()
    want = dense.generate(ids, attention_mask=mask,
                          max_new_tokens=QUANT_CHECK_TOKENS,
                          return_logits=True)
    tokens = want["generated"]
    full = build(mlp_low_rank=full_rank)
    got = full.generate(ids, attention_mask=mask,
                        max_new_tokens=QUANT_CHECK_TOKENS,
                        return_logits=True)
    lens = mask.sum(axis=1)

    def logit_at(i, j):
        lg = want["logits"]
        return lg[0][i, lens[i] - 1] if j == 0 else lg[j][i, 0]
    ties = check_equal_streams("quant_low_rank_full_rank", got["generated"],
                               tokens, logit_at)
    ref = want["logits"][1:]
    rel = logits_rel_rms(decode_logits(full, ids, mask, tokens), ref)
    half = full_rank // 2

    def cut_rank(leaf):
        if isinstance(leaf, dict) and "lr_u" in leaf:
            return {"lr_u": leaf["lr_u"][..., :half],
                    "lr_v": leaf["lr_v"][..., :half, :]}
        return leaf
    full.params = dict(full.params, layers={
        k: cut_rank(v) for k, v in full.params["layers"].items()})
    ctl = logits_rel_rms(decode_logits(full, ids, mask, tokens), ref)
    emit({"phase": "quant_low_rank_full_rank", "rank": full_rank,
          "rel_rms": rel, "control_rank": half, "control_rel_rms": ctl,
          "tol": TOL_LOW_RANK_FULL_REL, "control_min": TOL_QUANT_CONTROL_REL,
          "near_ties": len(ties), "finite": bool(np.isfinite(ref[0]).all())})
    if not rel <= TOL_LOW_RANK_FULL_REL:
        raise AssertionError(f"quant_low_rank_full_rank: relative RMS {rel}")
    if not ctl > TOL_QUANT_CONTROL_REL:
        raise AssertionError("quant_low_rank_full_rank: the half-rank "
                             f"control parts by only {ctl}")


def phase_quant(device):
    """Group ``quant`` (phase 18 (a)-(e)); returns its kernels-line
    entries: the paged kernel over gpt-oss-20b's served cache with MXFP4
    experts (a local and a global layer) and over Llama-3.1-8B's served
    fp8 pages."""
    import torch
    torch.cuda.reset_peak_memory_stats()
    phase_quant_products(device)
    memory_note("quant_products")
    free_card()
    entries = phase_quant_oss(device)
    entries += phase_quant_llama(device)
    bf16_quant_drift(oss_cut(QUANT_OSS_LAYERS), device, MXFP4_WEIGHTS,
                     "quant_oss_bf16")
    memory_note("quant_oss_bf16")
    bf16_quant_drift(dict(LLAMA_3_1_8B, num_hidden_layers=LLAMA_CUT), device,
                     INT8_WEIGHTS, "quant_llama_bf16")
    memory_note("quant_llama_bf16")
    for hf, weights, phase in (
            (oss_cut(QUANT_CHECK_LAYERS), MXFP4_WEIGHTS, "quant_oss_twin"),
            (dict(LLAMA_3_1_8B, num_hidden_layers=QUANT_CHECK_LAYERS),
             dict(INT8_WEIGHTS, **FP8_KV), "quant_llama_twin"),
            (dict(LLAMA_3_1_8B, num_hidden_layers=QUANT_CHECK_LAYERS),
             FP8_BLOCK_WEIGHTS, "quant_fp8_blockwise_twin")):
        phase_quant_twin(hf, device, weights, phase)
        memory_note(phase)
        free_card()
    phase_quant_low_rank(device)
    memory_note("quant_low_rank")
    free_card()
    return entries


# ---------------------------------------------------------------------------
# Phase 19: the dense families (Gemma-2, Gemma-3, Phi-3/4, Granite, OLMo-2,
# Qwen2) and the soft-capped attention
# ---------------------------------------------------------------------------

def dense_layer_types(hf):
    """A geometry's ``layer_types``, else every ``sliding_window_pattern``
    -th layer full (the Gemma families' default: 2 for Gemma-2, 6 for
    Gemma-3); None for a uniform geometry."""
    if "layer_types" in hf:
        return list(hf["layer_types"])
    if not hf["model_type"].startswith("gemma"):
        return None
    every = hf.get("sliding_window_pattern",
                   2 if hf["model_type"] == "gemma2" else 6)
    return ["sliding_attention" if (i + 1) % every else "full_attention"
            for i in range(hf["num_hidden_layers"])]


def dense_cut(hf, layers):
    """``hf`` cut to ``layers`` layers: the first ones with their types,
    or, where those hold no global layer (Gemma-3's first five are local),
    the ``layers`` ending at the first global one."""
    cut = dict(hf, num_hidden_layers=layers)
    types = dense_layer_types(hf)
    if types is None:
        return cut
    end = (layers if "full_attention" in types[:layers]
           else types.index("full_attention") + 1)
    cut["layer_types"] = types[end - layers:end]
    return cut


def phase_dense_kernels(device):
    with fp32_exact():
        return _phase_dense_kernels(device)


def masked_scores(q4, k4, mask, scale):
    """fp32 scores of the live keys: q4 (B, Hq, 1, D), k4 (B, Hkv, n, D),
    ``mask`` boolean (True = live) or additive (0 = live), broadcast over
    (B, Hq, 1, n)."""
    import torch
    g = q4.shape[1] // k4.shape[1]
    k = k4.float().repeat_interleave(g, dim=1)
    sc = (q4.float() @ k.transpose(-1, -2)) * scale
    live = mask if mask.dtype == torch.bool else mask == 0
    return sc[live.expand_as(sc)]


def _phase_dense_kernels(device):
    """19 (a): the paged kernel at Gemma-2-27B's heads (Hq 32 over Hkv
    16: G 2, D 128, scale 144 ** -0.5), B 4, lens 300-7000, soft-cap 50 at
    window 4096 (a local layer) and 0 (a global one), and the contiguous
    kernel over a Gemma-2 mixed cache's global stack (S 8192, window 0,
    soft-cap 50), bf16. q and keys are drawn at DENSE_QK_STD, so most
    scores exceed the cap (the share is printed and gated). Each kernel is
    held to its twin with the cap; the kernel without its cap (the
    control) must part from the capped twin by more than the tolerance.
    Then each is timed by CUDA-graph replay beside the twin, SDPA without
    the cap (no library call computes it: a yardstick of the attention's
    work, not of the function) and the bytes bound."""
    import torch
    import torch.nn.functional as F
    from neuronx_distributed_inference_tpu_torch.ops import decode_attention
    cfg = GEMMA2_27B
    hq, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    d = cfg["head_dim"]
    scale = cfg["query_pre_attn_scalar"] ** -0.5
    cap = cfg["attn_logit_softcapping"]
    lens = list(DENSE_KERNEL_LENS)
    b = len(lens)
    gen = torch.Generator(device=device).manual_seed(19)
    mb = -(-(max(lens) + 1) // 32)
    x = paged_inputs(gen, device, b=b, hq=hq, hkv=hkv, d=d, bs=32, mb=mb,
                     lens=lens, act_dtype=torch.bfloat16,
                     page_dtype=torch.bfloat16)
    for name in ("q", "k_pages", "new_k"):
        x[name] = (x[name].float() * DENSE_QK_STD).to(torch.bfloat16)
    args = (x["q"], x["k_pages"], x["v_pages"], x["new_k"], x["new_v"], 0,
            x["lens"], x["block_table"])
    out = {}
    for window in (cfg["sliding_window"], 0):
        kw = dict(scale=scale, window=window, soft_cap=cap)
        err = check_kernel_against_twin(x, kw)
        twin = decode_attention.paged_decode_attention_plain(*args, **kw)
        nocap = decode_attention.paged_decode_attention(
            *args, **dict(kw, soft_cap=None))
        control = float((nocap.float() - twin.float()).abs().max())
        q4, k4, v4, m4 = sdpa_window_inputs(x, 0, window, None)
        share = float((masked_scores(q4, k4, m4, scale).abs() > cap)
                      .float().mean())
        case = f"gemma2_27b_window{window}_softcap{cap:g}"
        emit({"phase": "dense_kernel_vs_twin",
              "kernel": "paged_decode_attention", "case": case,
              "geometry": {"Hq": hq, "Hkv": hkv, "D": d}, "lens": lens,
              "max_abs_err": err, "tol": TOL_KERNEL_BF16,
              "nocap_vs_capped_twin": control,
              "capped_score_share": share})
        if not err <= TOL_KERNEL_BF16:
            raise AssertionError(f"paged kernel {case}: max abs err {err}")
        if not control > TOL_KERNEL_BF16:
            raise AssertionError(f"paged kernel {case}: the uncapped "
                                 f"kernel stays within {control} of the "
                                 "capped twin: the cap never bites")
        if not share > DENSE_CAPPED_SHARE:
            raise AssertionError(f"{case}: only {share} of the scores "
                                 f"exceed the cap {cap}")
        out[("paged", window)] = timed_kernel(
            lambda: decode_attention.paged_decode_attention(*args, **kw),
            lambda: decode_attention.paged_decode_attention_plain(
                *args, **kw),
            lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=m4, scale=scale, enable_gqa=True),
            kernel_bounds(x, window), err,
            {"B": b, "Hq": hq, "Hkv": hkv, "D": d, "Bs": 32, "lens": lens,
             "window": window, "soft_cap": cap})
        del twin, nocap, q4, k4, v4, m4
    del x, args
    n_global = dense_layer_types(cfg).count("full_attention")
    c = contiguous_inputs(gen, device, b=b, hq=hq, hkv=hkv, d=d,
                          s=cfg["max_position_embeddings"], lens=lens,
                          layers=2, act_dtype=torch.bfloat16,
                          cache_dtype=torch.bfloat16)
    for name in ("q", "k_cache", "new_k"):
        c[name] = (c[name].float() * DENSE_QK_STD).to(torch.bfloat16)
    kw = dict(scale=scale, window=0, soft_cap=cap, layer=1)
    err = check_decode_against_twin(c, kw)
    dargs, dkw = decode_args(c, kw)
    twin = decode_attention.decode_attention_stacked_plain(*dargs, **dkw)
    nocap = decode_attention.decode_attention_stacked(
        *dargs, **dict(dkw, soft_cap=None))
    control = float((nocap.float() - twin.float()).abs().max())
    q4, k4, v4, m4 = contiguous_sdpa_inputs(c, 1)
    share = float((masked_scores(q4, k4, m4, scale).abs() > cap)
                  .float().mean())
    emit({"phase": "dense_kernel_vs_twin",
          "kernel": "decode_attention_stacked",
          "case": f"gemma2_27b_global_stack_softcap{cap:g}",
          "geometry": {"Hq": hq, "Hkv": hkv, "D": d,
                       "S": cfg["max_position_embeddings"],
                       "global_layers": n_global}, "lens": lens,
          "max_abs_err": err, "tol": TOL_KERNEL_BF16,
          "nocap_vs_capped_twin": control, "capped_score_share": share})
    if not err <= TOL_KERNEL_BF16:
        raise AssertionError(f"contiguous kernel with a cap: {err}")
    if not (control > TOL_KERNEL_BF16 and share > DENSE_CAPPED_SHARE):
        raise AssertionError(f"contiguous kernel: the cap does not bite "
                             f"({control}, share {share})")
    out[("contig", 0)] = timed_kernel(
        lambda: decode_attention.decode_attention_stacked(*dargs, **dkw),
        lambda: decode_attention.decode_attention_stacked_plain(*dargs,
                                                                **dkw),
        lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=m4, scale=scale, enable_gqa=True),
        decode_bounds(c), err,
        {"B": b, "Hq": hq, "Hkv": hkv, "D": d,
         "S": cfg["max_position_embeddings"], "lens": lens, "layer": 1,
         "window": 0, "soft_cap": cap})
    del c, twin, nocap, q4, k4, v4, m4
    for (kind, window), t in out.items():
        emit({"phase": "dense_kernel_timings",
              "kernel": ("paged_decode_attention" if kind == "paged"
                         else "decode_attention_stacked"),
              "window": window, "kernel_us": t["ms"] * 1e3,
              "bound_us": t["bound_ms"] * 1e3, "bound_by": t["bound_by"],
              "plain_us": t["plain_ms"] * 1e3,
              "library_us": t["library_ms"] * 1e3,
              "library": "SDPA without the soft-cap",
              "max_abs_err": t["err"], "shape": t["shape"]})
    # comparison launches are not main-path launches
    reset_launches()
    torch.cuda.empty_cache()
    return out


def check_dense_args(phase, spy, hf):
    """Gate: every layer's paged-kernel launches took that layer's window
    (the sliding window on local layers, 0 on global ones; the window on
    every layer of a uniform model), no sink, and the geometry's
    attention soft-cap."""
    types = dense_layer_types(hf)
    window = hf.get("sliding_window") or 0
    n = hf["num_hidden_layers"]
    cap = hf.get("attn_logit_softcapping")
    want = {(i, (window if types[i] == "sliding_attention" else 0)
             if types else window, False) for i in range(n)}
    want_caps = {(i, cap) for i in range(n)}
    by_kind = {}
    for i, w, _ in spy.calls:
        key = f"window{w}_softcap{cap}"
        by_kind[key] = by_kind.get(key, 0) + 1
    emit({"phase": phase + "_kernel_args", "layers_by_args": by_kind,
          "calls": sorted(spy.calls)[:8], "caps": sorted(spy.caps)[:4]})
    if spy.calls != want or spy.caps != want_caps:
        raise AssertionError(
            f"{phase}: paged kernel calls by (layer, window, sink) "
            f"{sorted(spy.calls ^ want)[:4]}, by (layer, soft-cap) "
            f"{sorted(spy.caps ^ want_caps)[:4]}")


class ServedRoutes:
    """Every MoE layer's top-k expert ids and affinities for every token
    the ragged engine serves while active, read where
    ``modules/moe.route`` returns them: an eager pass keeps them as they
    come; a T = 1 graph keeps the tensors its capture recorded (graph
    memory, rewritten by each replay), stacked after each replay of a
    dispatch (two copy kernels a decode pass; nothing in a dense model).
    Each dispatch keeps its rows' (seq_id, offset, width) and input ids.
    :meth:`experts` and :meth:`row_routes` read them back."""

    def __enter__(self):
        import numpy as np
        import torch
        from neuronx_distributed_inference_tpu_torch.models.cuda_graphs \
            import StepGraphs
        from neuronx_distributed_inference_tpu_torch.modules import \
            moe as moe_mod
        from neuronx_distributed_inference_tpu_torch.serving.ragged.path \
            import RaggedDispatchPath
        self._saved = ((moe_mod, "route", moe_mod.route),
                       (StepGraphs, "run", StepGraphs.run),
                       (RaggedDispatchPath, "_dispatch_ragged",
                        RaggedDispatchPath._dispatch_ragged))
        route, run, dispatch = (f for _, _, f in self._saved)
        self.dispatches = []
        cur = [None]                # the dispatch being run
        captured = {}               # (graphs, sig) -> the capture's ids
        in_graph = [None]           # the ids list of a capture, or []

        def spy_route(moe, h, router_w, router_bias=None):
            vals, idx = route(moe, h, router_w, router_bias)
            if in_graph[0] is not None:
                if torch.cuda.is_current_stream_capturing():
                    in_graph[0].append((vals, idx))
            elif cur[0] is not None:
                cur[0]["experts"].append(idx)
                cur[0]["vals"].append(vals)
            return vals, idx

        def spy_run(graphs, sig, fn, inputs):
            key = (id(graphs), sig)
            if sig not in graphs._graphs:
                captured[key] = []
            in_graph[0] = captured.get(key, [])
            try:
                out = run(graphs, sig, fn, inputs)
            finally:
                in_graph[0] = None
            if cur[0] is not None and captured.get(key):
                cur[0]["experts"] = list(torch.stack(
                    [i for _, i in captured[key]]))
                cur[0]["vals"] = list(torch.stack(
                    [v for v, _ in captured[key]]))
            return out

        def spy_dispatch(path, ids, pos, slots, bt, wid, emit, seeds, rows,
                         *more):
            cur[0] = {"rows": [(r.seq_id, r.offset, r.width) for r in rows],
                      "pos": np.asarray(pos)[:len(rows), 0].tolist(),
                      "ids": (np.asarray(ids) if isinstance(ids, np.ndarray)
                              else None), "experts": [], "vals": []}
            try:
                return dispatch(path, ids, pos, slots, bt, wid, emit, seeds,
                                rows, *more)
            finally:
                self.dispatches.append(cur[0])
                cur[0] = None
        moe_mod.route = spy_route
        StepGraphs.run = spy_run
        RaggedDispatchPath._dispatch_ragged = spy_dispatch
        return self

    def __exit__(self, *exc):
        for owner, name, f in self._saved:
            setattr(owner, name, f)

    def _seq_of(self, prompt):
        """The seq id of the request whose prompt is ``prompt``."""
        n = len(prompt)
        seq = None
        for d in self.dispatches:
            for b, (sid, off, w) in enumerate(d["rows"]):
                if (off == 0 and d["ids"] is not None
                        and d["ids"][b, :min(w, n)].tolist()
                        == list(prompt[:min(w, n)])):
                    seq = sid
        return seq

    def row_routes(self, prompt, n_moe):
        """The served routing of the request whose prompt is ``prompt``:
        per MoE layer, the affinities (P, k) and expert ids (P, k) of its
        positions 0 .. P - 1 (the last dispatch that served a position
        wins), and a (P,) mask of the positions recorded."""
        import torch
        seq = self._seq_of(prompt)
        rows = [(d, b, off, w) for d in self.dispatches
                for b, (sid, off, w) in enumerate(d["rows"])
                if sid == seq and len(d["experts"]) == n_moe]
        n_pos = max(off + w for _, _, off, w in rows)
        d0 = rows[0][0]
        k = d0["experts"][0].shape[-1]
        dev = d0["experts"][0].device
        vals = torch.zeros((n_moe, n_pos, k), device=dev)
        idx = torch.zeros((n_moe, n_pos, k), dtype=torch.long, device=dev)
        have = torch.zeros((n_pos,), dtype=torch.bool, device=dev)
        for d, b, off, w in rows:
            for layer in range(n_moe):
                vals[layer, off:off + w] = d["vals"][layer][b, :w].float()
                idx[layer, off:off + w] = d["experts"][layer][b, :w]
            have[off:off + w] = True
        return vals, idx, have

    def experts(self, prompt, position, n_moe):
        """The served top-k experts (one sorted list per MoE layer) of the
        request whose prompt is ``prompt`` at absolute ``position``, or
        None where no dispatch recorded them."""
        seq = self._seq_of(prompt)
        for d in reversed(self.dispatches):
            for b, (sid, off, w) in enumerate(d["rows"]):
                if sid != seq or not off <= position < off + w:
                    continue
                if d["pos"][b] != off or len(d["experts"]) != n_moe:
                    raise AssertionError(
                        f"served routes: row {b} at {d['pos'][b]} != {off},"
                        f" {len(d['experts'])} MoE calls != {n_moe}")
                return [sorted(e[b, position - off].tolist())
                        for e in d["experts"]]
        return None


def sparsemixer_forced(logits, idx, eps):
    """Phi-3.5-MoE's sparsemixer affinities (``modules/moe``'s inference
    routing) with the selection forced to the expert pairs ``idx`` (B, T,
    2), the first pick the one of the higher logit: each pick's masked
    softmax over the scores left at its turn, read at the forced expert;
    returned in ``idx``'s order."""
    import torch
    a, b = (torch.gather(logits, -1, idx[..., j:j + 1]) for j in (0, 1))
    hi = a >= b
    i1 = torch.where(hi, idx[..., 0:1], idx[..., 1:2])
    i2 = torch.where(hi, idx[..., 1:2], idx[..., 0:1])

    def pick(scores, i):
        mx = scores.max(dim=-1, keepdim=True).values
        factor = torch.maximum(logits.abs(), mx)
        masked = torch.where((mx - logits) / factor > 2 * eps,
                             torch.full_like(scores, float("-inf")), scores)
        return torch.gather(torch.softmax(masked, dim=-1), -1, i)
    v1 = pick(logits, i1)
    v2 = pick(logits.scatter(-1, i1, float("-inf")), i2)
    return torch.cat([torch.where(hi, v1, v2), torch.where(hi, v2, v1)],
                     dim=-1)


@contextlib.contextmanager
def cold_prefix(app):
    """The paged app with prefix caching off while active: a ``generate``
    computes every position of its prompt (none is served from blocks an
    earlier call left), in chunks from position 0."""
    alloc = app.kv_mgr.allocator
    was = alloc.enable_prefix_caching
    alloc.enable_prefix_caching = False
    try:
        yield app
    finally:
        alloc.enable_prefix_caching = was


def router_check_at(app, prompt, served, step, chunk, experts):
    """The reference's routing for the token whose logits give served
    step ``step`` (an eager single-row ``generate`` of ``prompt`` on a
    cold prefix (:func:`cold_prefix`), fed
    ``served``'s tokens, the app's graphs set aside so every router runs
    in Python): its top-k experts at each MoE layer and its smallest gap
    between the k-th and (k+1)-th expert score, and the served token's
    deficit there, in logit stds. Where they differ from ``experts`` (the
    served pass's, :class:`ServedRoutes`), the generate is run again with
    the served experts forced at that token (their affinities as
    ``modules/moe.route`` takes them), and the served token's deficit
    under it is returned as ``forced_deficit``."""
    import numpy as np
    import torch
    from neuronx_distributed_inference_tpu_torch.models import model_base
    from neuronx_distributed_inference_tpu_torch.modules import moe as moe_mod
    orig = moe_mod.route
    n_moe = sum(1 for *_, kind in model_base.layer_plan(app.spec)
                if kind == "moe")
    # step 0: the prompt's last token in the last prefill chunk's call;
    # step j > 0: decode step j's (T = 1) calls, the generate's last
    col = (len(prompt) - 1) % chunk if step == 0 else 0

    def forced_vals(moe, h, router_w, router_bias, idx):
        logits = h.float() @ router_w.float()
        if moe.router_act == "sparsemixer":
            return sparsemixer_forced(logits, idx, moe.sparsemixer_eps)
        if router_bias is not None and moe.router_bias_mode == "logits":
            logits = logits + router_bias
        scores = (torch.sigmoid(logits) if moe.router_act == "sigmoid"
                  else logits if moe.pre_softmax_topk
                  else torch.softmax(logits, dim=-1))
        vals = torch.gather(scores, -1, idx)
        if moe.pre_softmax_topk and moe.router_act != "sigmoid":
            vals = torch.softmax(vals, dim=-1)
        if moe.normalize_topk:
            vals = vals / torch.clamp(vals.sum(dim=-1, keepdim=True),
                                      min=1e-20)
        if moe.routed_scaling is not None:
            vals = vals * moe.routed_scaling
        return vals

    def run(force, first):
        calls = []

        def spy(moe, h, router_w, router_bias=None):
            vals, idx = orig(moe, h, router_w, router_bias)
            logits = h.float() @ router_w.float()
            scores = (torch.sigmoid(logits) if moe.router_act == "sigmoid"
                      else torch.softmax(logits, dim=-1))
            top = torch.topk(scores, moe.top_k + 1, dim=-1).values
            calls.append(((top[..., -2] - top[..., -1])[0, col].item(),
                          sorted(idx[0, col].tolist())))
            if force is not None and len(calls) > first:
                idx = idx.clone()
                idx[0, col] = torch.as_tensor(force[len(calls) - 1 - first],
                                              device=idx.device)
                vals = vals.clone()
                vals[0, col] = forced_vals(moe, h, router_w, router_bias,
                                           idx)[0, col]
            return vals, idx
        graphs, app.graphs = app.graphs, None
        moe_mod.route = spy
        try:
            with cold_prefix(app):
                lg = app.generate(
                    np.asarray([prompt]), max_new_tokens=step + 1,
                    return_logits=True,
                    teacher_tokens=(np.asarray([served[:step]])
                                    if step else None))["logits"]
                app.release()
        finally:
            moe_mod.route = orig
            app.graphs = graphs
        row = np.asarray(lg[step][0, col if step == 0 else 0],
                         np.float64)[:app.spec.vocab_size]
        return calls, float(row.max() - row[served[step]]) / row.std()
    calls, deficit = run(None, 0)
    last = calls[-n_moe:]
    out = {"router_gap": min(g for g, _ in last),
           "reference_experts": [e for _, e in last],
           "served_experts": experts, "deficit": deficit,
           "forced_deficit": None}
    if experts is not None and experts != out["reference_experts"]:
        _, out["forced_deficit"] = run(experts, len(calls) - n_moe)
    return out


def forced_route_deficits(app, prompt, served, routes, stats=None):
    """The served tokens' deficits (in logit stds, per step) under an
    eager single-row ``generate`` of ``prompt`` on a cold prefix (prefill
    in the app's chunks from position 0, fed ``served``'s tokens) with the served pass's routing
    imposed at every MoE layer of every position it recorded: ``routes``
    is :meth:`ServedRoutes.row_routes`' (affinities, expert ids, mask).
    What is left is the served path's difference from ``generate``
    outside the routers (attention, norms, biases, the expert products).
    Returns the deficits; ``stats`` (a dict) receives
    ``expert_pairs_differing_share``, the share of the recorded (position,
    MoE layer) pairs whose served experts differ from the ones
    ``generate``'s own router picks there (the routers' own reading)."""
    import numpy as np
    import torch
    from neuronx_distributed_inference_tpu_torch.modules import moe as moe_mod
    orig = moe_mod.route
    vals, idx, have = routes
    n = len(prompt)
    n_moe = vals.shape[0]
    # the forward under way: its first position; prefill forwards cover
    # consecutive chunks of the prompt (each as wide as its input), then
    # each decode step one position
    state = {"calls": 0, "start": 0, "next": 0, "decode": 0, "last": 0}
    pairs = {"differ": [], "seen": []}

    def spy(moe, h, router_w, router_bias=None):
        v, i = orig(moe, h, router_w, router_bias)
        layer = state["calls"] % n_moe
        state["calls"] += 1
        if layer == 0:
            if state["next"] < n:
                state["start"] = state["last"] = state["next"]
                state["next"] += h.shape[1]
            else:
                state["start"] = n + state["decode"]
                state["decode"] += 1
        start = state["start"]
        m = max(0, min(h.shape[1], vals.shape[1] - start))
        if m:
            on = have[start:start + m, None]
            own = i[0, :m].sort(dim=-1).values
            served = idx[layer, start:start + m].sort(dim=-1).values
            pairs["differ"].append(((own != served).any(dim=-1)
                                    & on[:, 0]).sum())
            pairs["seen"].append(on.sum())
            v, i = v.clone(), i.clone()
            v[0, :m] = torch.where(on, vals[layer, start:start + m],
                                   v[0, :m].float()).to(v.dtype)
            i[0, :m] = torch.where(on, idx[layer, start:start + m], i[0, :m])
        return v, i
    graphs, app.graphs = app.graphs, None
    moe_mod.route = spy
    try:
        with cold_prefix(app):
            lg = app.generate(np.asarray([prompt]),
                              max_new_tokens=len(served), return_logits=True,
                              teacher_tokens=np.asarray([served[:-1]])
                              )["logits"]
            app.release()
    finally:
        moe_mod.route = orig
        app.graphs = graphs
    if (state["decode"] != len(served) - 1
            or state["calls"] % n_moe):
        raise AssertionError(f"forced routes: {state['calls']} router calls,"
                             f" {state['decode']} decode steps for "
                             f"{len(served)} served tokens")
    out = []
    for j in range(len(served)):
        row = np.asarray(lg[j][0, n - 1 - state["last"]] if j == 0
                         else lg[j][0, 0], np.float64)
        row = row[:app.spec.vocab_size]
        out.append(float(row.max() - row[served[j]]) / row.std())
    seen = int(sum(int(x) for x in pairs["seen"]))
    if stats is not None:
        stats["expert_pairs_differing_share"] = (
            int(sum(int(x) for x in pairs["differ"])) / seen if seen
            else None)
    return out


def served_vs_generate(phase, chunk, routes=None):
    """``after`` of :func:`phase_ragged_serving`: each served stream held
    to ``generate`` of its prompt on the same app and weights, from a cold
    cache (no prefix reused), in batches of the app's rows, prefill in
    chunks of ``chunk`` as the engine's, fed the served tokens (teacher
    forcing). Gate: at every step the served token's logit is within
    TOL_SERVED_DEFICIT_BF16 logit stds of the top logit, and within
    TOL_SERVED_MEAN_DEFICIT_BF16 on average; the control, the token one id
    further, must sit beyond the first at most steps. In an MoE model a
    step beyond the first limit passes only where the served pass routed
    that token to other experts than ``generate`` did (``routes``, the
    :class:`ServedRoutes` of the serving run) and ``generate`` with the
    served experts forced there puts the served token back within it
    (:func:`router_check_at`). Where steps stay beyond it or the mean
    exceeds its limit (Phi-3.5-MoE: the sparsemixer's masks switch on
    rounding, and a switch at one position reaches every later one
    through the cache), each request concerned is run again with the
    served pass's routing imposed at every position
    (:func:`forced_route_deficits`), and both limits hold on those
    deficits: what the served path changes outside the routers."""
    import numpy as np
    from neuronx_distributed_inference_tpu_torch.models import model_base

    def check(app, prompts, streams):
        # the served cache goes first: two caches do not fit beside the
        # weights
        app.cache = None
        if app.device.type == "cuda":
            free_card()
        app.init_cache()
        rows = app.tpu_config.batch_size
        served = [np.asarray(st.tokens) for st in streams]
        deficits, controls, exact, per, over = [], [], 0, [], []
        spans = {}
        for lo in range(0, len(prompts), rows):
            part = list(range(lo, min(lo + rows, len(prompts))))
            width = max(len(prompts[i]) for i in part)
            ids = np.zeros((len(part), width), np.int64)
            mask = np.zeros_like(ids)
            for r, i in enumerate(part):
                ids[r, :len(prompts[i])] = prompts[i]
                mask[r, :len(prompts[i])] = 1
            want = np.stack([served[i] for i in part])
            lg = app.generate(ids, attention_mask=mask,
                              max_new_tokens=want.shape[1],
                              return_logits=True,
                              teacher_tokens=want[:, :-1])["logits"]
            # the prefill's logits are its last chunk's: a row whose
            # prompt ended in an earlier chunk has none for step 0
            last = ((width - 1) // chunk) * chunk if width > chunk else 0
            for r, i in enumerate(part):
                first = len(deficits)
                steps = []
                for j in range(want.shape[1]):
                    at = len(prompts[i]) - 1 - last
                    if j == 0 and at < 0:
                        continue
                    steps.append(j)
                    row = (lg[0][r, at] if j == 0
                           else lg[j][r, 0]).astype(np.float64)
                    row = row[:app.spec.vocab_size]
                    top, std = row.max(), row.std()
                    deficits.append(float(top - row[want[r, j]]) / std)
                    if deficits[-1] > TOL_SERVED_DEFICIT_BF16:
                        over.append((i, j, deficits[-1]))
                    controls.append(float(
                        top - row[(want[r, j] + 1) % row.shape[0]]) / std)
                    exact += int(np.argmax(row) == want[r, j])
                mine = deficits[first:]
                spans[i] = mine
                worst_j = steps[int(np.argmax(mine))]
                per.append({"prompt_len": len(prompts[i]),
                            "max_deficit": max(mine),
                            "mean_deficit": float(np.mean(mine)),
                            "steps_over_0.5": int(np.sum(
                                np.asarray(mine) > 0.5)),
                            "worst_step": worst_j,
                            "worst_position": len(prompts[i]) + worst_j - 1})
            app.release()
        worst, mean = max(deficits), float(np.mean(deficits))
        flips, unexplained = [], []
        n_moe = sum(1 for *_, kind in model_base.layer_plan(app.spec)
                    if kind == "moe")
        routed = bool(n_moe) and routes is not None
        for i, j, d in over:
            got = None
            if routed and mean <= TOL_SERVED_MEAN_DEFICIT_BF16:
                pos = len(prompts[i]) + j - 1
                got = router_check_at(
                    app, prompts[i], served[i], j, chunk,
                    routes.experts(prompts[i], pos, n_moe))
                flips.append({"request": i, "prompt_len": len(prompts[i]),
                              "step": j, "position": pos, "deficit": d,
                              **got})
            if (got is None or got["forced_deficit"] is None
                    or not got["forced_deficit"]
                    <= TOL_SERVED_DEFICIT_BF16):
                unexplained.append((i, d))
        forced, shares = {}, {}
        if routed and (unexplained
                       or not mean <= TOL_SERVED_MEAN_DEFICIT_BF16):
            for i in sorted({i for i, _ in unexplained}
                            | {i for i, ds in spans.items()
                               if np.mean(ds) > TOL_SERVED_MEAN_DEFICIT_BF16}):
                shares[i] = {}
                forced[i] = forced_route_deficits(
                    app, prompts[i], served[i],
                    routes.row_routes(prompts[i], n_moe), shares[i])
            unexplained = [(i, d) for i, d in unexplained
                           if i not in forced]
            unexplained += [(i, d) for i, ds in forced.items() for d in ds
                            if d > TOL_SERVED_DEFICIT_BF16]
        gated = [d for i in sorted(spans) for d in forced.get(i, spans[i])]
        gated_mean = float(np.mean(gated))
        far = float(np.mean(np.asarray(controls)
                            > TOL_SERVED_DEFICIT_BF16))
        emit({"phase": phase + "_vs_generate", "tokens": len(deficits),
              "argmax_equal": exact, "max_deficit": worst,
              "mean_deficit": mean, "bound": TOL_SERVED_DEFICIT_BF16,
              "mean_bound": TOL_SERVED_MEAN_DEFICIT_BF16,
              "control_share_beyond_bound": far,
              "control_mean_deficit": float(np.mean(controls)),
              "steps_over_bound": flips or [[i, j, d] for i, j, d in over],
              "by_request": per,
              "forced_routes": {str(i): {
                  "max_deficit": max(ds), "mean_deficit": float(np.mean(ds)),
                  "raw_max_deficit": max(spans[i]),
                  "raw_mean_deficit": float(np.mean(spans[i])),
                  "steps_over_bound": int(np.sum(np.asarray(ds)
                                                 > TOL_SERVED_DEFICIT_BF16)),
                  **shares[i]}
                  for i, ds in forced.items()},
              "gated_mean_deficit": gated_mean})
        if unexplained or not gated_mean <= TOL_SERVED_MEAN_DEFICIT_BF16:
            raise AssertionError(
                f"{phase}: served tokens sit up to "
                f"{max((d for _, d in unexplained), default=worst)} (mean "
                f"{gated_mean}) logit stds below generate's top logit, not "
                "explained by the served pass's routing")
        if not far > 0.5:
            raise AssertionError(f"{phase}: the control sits within the "
                                 f"bound at {1 - far:.2f} of the steps")
    return check


def phase_dense_serving(hf, device, cfg, phase, kernel_layers, kernel=True,
                        group=None, batch=4, tcfg_extra=None):
    """19 (b), (c): ``hf`` at full width on phase 9's engine and schedule,
    bf16, ``batch`` rows (4; phase 21's OLMoE and granite: 8), with
    ``cfg``'s seq_len, prompts and chunk, the app
    built with output logits and ``generate``'s prefill chunked as the
    engine's (``served_vs_generate``). Gates: phase 9's (one dispatch and
    one fetch a pass, paged launches = layers x all-decode steps, no
    incident, full streams), weight bytes equal the geometry's, every
    launch at its layer's window and soft-cap, the streams held to
    ``generate``. ``kernel`` False (phase 20's Llama4): the paged kernel
    launches 0 times and the spy sees no call; ``group``: every launch at
    this GQA group (phase 20's DBRX: 6; phase 21's: 12, 4, 1, 3);
    ``tcfg_extra``: more make_ragged_app arguments (phase 26's BLOOM: both
    kernels forced on). Returns the kernels-line entries
    (the paged kernel over the served cache at ``kernel_layers``)."""
    from neuronx_distributed_inference_tpu_torch.config import \
        ChunkedPrefillConfig
    on_card = device.type == "cuda"
    if on_card:
        check_card_empty(phase)
    with PagedArgsSpy() as spy, ServedRoutes() as routes:
        app, _, entries, recs = phase_ragged_serving(
            hf, device, cfg=cfg, phase=phase, kernel_layers=kernel_layers,
            on_card=on_card,
            tcfg_over=dict(batch=batch, output_logits=True,
                           is_chunked_prefill=True,
                           chunked_prefill_config=ChunkedPrefillConfig(
                               kernel_q_tile_size=cfg["chunk"]),
                           **(tcfg_extra or {})),
            after=served_vs_generate(phase, cfg["chunk"], routes),
            kernel=kernel)
    if kernel:
        check_dense_args(phase, spy, hf)
    emit({"phase": phase + "_kernel_spy", "calls": len(spy.calls),
          "groups": sorted(spy.groups), "expected_group": group,
          "kernel_expected": kernel})
    if not kernel and spy.calls:
        raise AssertionError(f"{phase}: the paged kernel was called at "
                             f"{sorted(spy.calls)[:4]}")
    if group is not None and spy.groups != {group}:
        raise AssertionError(f"{phase}: paged kernel groups "
                             f"{sorted(spy.groups)} != {{{group}}}")
    emit({"phase": phase + "_bytes",
          "weight_gb": param_bytes(app.params) / 1e9,
          "cache_gb": cache_bytes(app) / 1e9})
    del app
    if on_card:
        memory_note(phase)
        free_card()
    return entries


def dense_fp32_cut(name, hf, device, cfg=DENSE_CHECK):
    """19 (d), one geometry cut to DENSE_CHECK_LAYERS layers, fp32: the
    paged app's ``generate`` on the kernel path (paged launches = layers
    x decode steps) against the same weights on the gather path
    (``attn_block_tkg_kernel_enabled=False``) fed the kernel path's tokens:
    relative RMS of the decode logits within TOL_DENSE_PATHS_FP32_REL and
    the gather path's argmax equal to the kernel path's tokens (a near-tie
    only, printed); then the ragged engine's streams on the kernel app
    equal ``generate``'s (``cfg``: the prompts, cache and chunk). Returns
    (the kernel path's tokens, the prompts' ids, their mask)."""
    import numpy as np
    import torch
    new = DENSE_CHECK_TOKENS
    layers = hf["num_hidden_layers"]
    on_card = device.type == "cuda"
    ids, mask = prompts_of(cfg["lens"], hf["vocab_size"], seed=19)
    kapp = make_ragged_app(hf, device, "float32", cfg, batch=len(cfg["lens"]),
                           output_logits=True, graphs=False)
    init_weights(kapp, 0)
    reset_launches([kapp])
    out = kapp.generate(ids, attention_mask=mask, max_new_tokens=new,
                        return_logits=True)
    launches = kernel_counts([kapp])["paged_decode_attention"]
    want_launches = layers * (new - 1) if on_card else 0
    toks = np.asarray(out["generated"])
    gapp = make_ragged_app(hf, device, "float32", cfg,
                           batch=len(cfg["lens"]), output_logits=True,
                           graphs=False, kernel=False)
    gapp.params = kapp.params
    ref = gapp.generate(ids, attention_mask=mask, max_new_tokens=new,
                        return_logits=True, teacher_tokens=toks[:, :-1])
    del gapp
    lens = mask.sum(axis=1)

    def logit_at(i, j, lg=ref["logits"]):
        return lg[0][i, lens[i] - 1] if j == 0 else lg[j][i, 0]
    argmax = np.asarray([[int(np.argmax(logit_at(i, j)))
                          for j in range(new)] for i in range(len(lens))])
    check_equal_streams(f"dense_fp32_{name}_kernel_vs_gather", toks, argmax,
                        logit_at)
    a = np.stack(out["logits"][1:]).astype(np.float64)
    b = np.stack(ref["logits"][1:]).astype(np.float64)
    rel = float(np.linalg.norm(a - b) / np.linalg.norm(b))
    emit({"phase": f"dense_fp32_{name}", "layers": layers,
          "prompt_lens": list(cfg["lens"]), "decode_steps": new - 1,
          "launches": launches, "expected_launches": want_launches,
          "kernel_vs_gather_logits_rel_rms": rel,
          "tol": TOL_DENSE_PATHS_FP32_REL,
          "spec": {k: getattr(kapp.spec, k) for k in (
              "act", "norm_offset", "sandwich_norm", "norm_position",
              "qk_norm", "qk_norm_full", "residual_multiplier",
              "logits_divide", "logits_soft_cap", "attn_soft_cap",
              "embed_scale", "qkv_bias")}})
    if launches != want_launches:
        raise AssertionError(f"dense_fp32_{name}: paged launches "
                             f"{launches} != {want_launches}")
    if not rel <= TOL_DENSE_PATHS_FP32_REL:
        raise AssertionError(f"dense_fp32_{name}: kernel vs gather logits "
                             f"{rel}")
    prompts = [ids[i, :lens[i]].tolist() for i in range(len(lens))]
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    kapp.init_cache()
    streams, _, _, _ = _ragged_run(f"dense_fp32_{name}_ragged", kapp,
                                   prompts, new, cfg, sync, layers, on_card)
    check_equal_streams(f"dense_fp32_{name}_ragged_vs_generate",
                        np.asarray([s.tokens for s in streams]), toks,
                        lambda i, j, lg=out["logits"]: (
                            lg[0][i, lens[i] - 1] if j == 0
                            else lg[j][i, 0]))
    del kapp
    if on_card:
        free_card()
    return toks, ids, mask


def dense_gemma2_contiguous(hf, device):
    """19 (d): ``TpuGemma2ForCausalLM`` at DENSE_CHECK_LAYERS layers, fp32,
    ``seq_len`` 8192, one prompt past the window (GEMMA2_LONG): the mixed
    per-layer cache (global rows of 8192 slots, local rows rolling at
    4096), after ``precompile``; the contiguous decode kernel launches =
    global layers x decode steps (replays counted), each at its
    global-stack index, window 0, soft-cap 50; the stream equals the
    uniform cache's (``mixed_kv=False``, the kernel at
    window 4096 on the local layers). Returns the kernel's launches."""
    import numpy as np
    g = GEMMA2_LONG
    new = g["new_tokens"]
    ids, mask = prompts_of((g["len"],), hf["vocab_size"], seed=20)
    with ContiguousArgsSpy() as spy:
        mix = make_pattern_app(hf, device, "float32", batch=1,
                               seq_len=g["seq_len"])
        init_weights(mix, 0)
        # the T = 1 decode graph is captured here, not inside generate
        warm(mix, "dense_gemma2_contiguous")
        reset_launches([mix])
        got = mix.generate(ids, attention_mask=mask,
                           max_new_tokens=new)["generated"]
        launches = kernel_counts([mix])["decode_attention_stacked"]
    types = dense_layer_types(hf)
    n_global = types.count("full_attention")
    want_calls = {(j, 0, False) for j in range(n_global)}
    want_caps = {(j, hf["attn_logit_softcapping"]) for j in range(n_global)}
    on_card = device.type == "cuda"
    want_launches = n_global * (new - 1) if on_card else 0

    def ref(**kw):
        r = make_pattern_app(hf, device, "float32", batch=1,
                             seq_len=g["seq_len"], mixed_kv=False, **kw)
        r.params = mix.params
        return r
    want = ref().generate(ids, attention_mask=mask,
                          max_new_tokens=new)["generated"]
    emit({"phase": "dense_gemma2_contiguous", "layers":
          hf["num_hidden_layers"], "prompt_len": g["len"],
          "seq_len": g["seq_len"], "mixed_kv": mix.spec.mixed_kv,
          "cache_gb": cache_bytes(mix) / 1e9, "launches": launches,
          "expected_launches": want_launches,
          "calls": sorted(spy.calls), "caps": sorted(spy.caps)})
    if not mix.spec.mixed_kv:
        raise AssertionError("dense_gemma2_contiguous: no mixed cache")
    if (launches != want_launches or spy.calls != want_calls
            or spy.caps != want_caps):
        raise AssertionError(f"dense_gemma2_contiguous: launches "
                             f"{launches} (want {want_launches}), calls "
                             f"{sorted(spy.calls)}, caps {sorted(spy.caps)}")
    check_equal_streams("dense_gemma2_mixed_vs_uniform", got, want,
                        batch_logit_at(lambda: ref(output_logits=True), ids,
                                       mask, np.asarray(want)))
    del mix
    if on_card:
        free_card()
    return launches


def phase_dense_fp32(device):
    with fp32_exact():
        return _phase_dense_fp32(device)


def _phase_dense_fp32(device):
    """19 (d): every geometry's fp32 cut, then the Gemma-2 contiguous app
    past its window; returns the contiguous kernel's launches there."""
    for name, hf in DENSE_GEOMETRIES.items():
        dense_fp32_cut(name, dense_cut(hf, DENSE_CHECK_LAYERS), device)
        if device.type == "cuda":
            memory_note(f"dense_fp32_{name}")
    return dense_gemma2_contiguous(dense_cut(GEMMA2_27B, DENSE_CHECK_LAYERS),
                                   device)


def phase_dense(device):
    """Group ``dense`` (phase 19 (a)-(d)); returns its kernels-line
    entries: the paged kernel over Gemma-2-27B's served cache at a local
    and a global layer (with (b)'s launches), and the contiguous kernel at
    (a)'s Gemma-2 shapes with the launches of (d)'s
    ``TpuGemma2ForCausalLM`` run."""
    import torch
    torch.cuda.reset_peak_memory_stats()
    times = phase_dense_kernels(device)
    memory_note("dense_kernels")
    entries = phase_dense_serving(dense_cut(GEMMA2_27B, GEMMA2_CUT), device,
                                  DENSE_SERVE, "dense_gemma2", (-2, -1))
    entries += phase_dense_serving(dense_cut(GEMMA3_27B, GEMMA3_CUT),
                                   device, GEMMA3_SERVE, "dense_gemma3", ())
    launches = phase_dense_fp32(device)
    t = times[("contig", 0)]
    entries.append({
        "name": "decode_attention_stacked", "route": "cuda",
        "source": "neuronx_distributed_inference_tpu_torch/csrc/"
                  "decode_attention.cu",
        "replaces": "neuronx_distributed_inference_tpu/ops/"
                    "decode_attention.py:41",
        "launches": launches, "max_abs_err": t["err"], "ms": t["ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "library": "SDPA without the soft-cap",
        "path": "dense_gemma2_contiguous", "shape": t["shape"]})
    return entries


# ---------------------------------------------------------------------------
# Phase 20: Llama4 text and DBRX
# ---------------------------------------------------------------------------

def moe_families_cut(hf, layers, **over):
    """``hf`` cut to ``layers`` layers (DBRX's ``n_layers`` with it), with
    ``over`` replacing fields (phases 20 and 21)."""
    cut = dict(hf, num_hidden_layers=layers, **over)
    if "n_layers" in hf:
        cut["n_layers"] = layers
    return cut


def family_spec(hf, **tcfg):
    """The DecoderSpec ``hf``'s family resolves (no weights, no device)."""
    from neuronx_distributed_inference_tpu_torch.config import TpuConfig
    from neuronx_distributed_inference_tpu_torch.models.family import \
        get_family
    family = get_family(hf["model_type"])
    return family.build_spec(family.config_cls(
        TpuConfig(**dict(dict(batch_size=4, seq_len=8192), **tcfg)), **hf))


def check_moe_family_specs():
    """Gate: the specs of 20 (b) and (d) as the geometries say: Scout's
    cut NoPE at layers 3, 7, ... (the global layers), chunked at
    8192 elsewhere, every layer MoE, the q/k norm and the temperature;
    DBRX's LayerNorm, clip 8 and G 6. Both refused by every kernel gate
    but DBRX's, which both decode gates admit."""
    from neuronx_distributed_inference_tpu_torch.models import model_base
    from neuronx_distributed_inference_tpu_torch.ops import decode_attention
    scout = family_spec(moe_families_cut(LLAMA4_SCOUT, LLAMA4_CUT),
                        seq_len=LLAMA4_SERVE["seq_len"])
    dbrx = family_spec(moe_families_cut(DBRX_INSTRUCT, DBRX_CUT))
    got = {
        "llama4": {"layer_pattern": scout.layer_pattern,
                   "moe_pattern": scout.moe_pattern,
                   "stacks": sorted({k for k, *_ in
                                     model_base.layer_plan(scout)}),
                   "attn_chunk": scout.attn_chunk,
                   "attn_temp": scout.attn_temp,
                   "qk_l2_norm": scout.qk_l2_norm,
                   "rope": [scout.rope.scaling_type,
                            scout.rope.scaling_factor],
                   "group": scout.gqa.q_per_kv,
                   "decode_gate": decode_attention.supports(scout, 1),
                   "flash_gate": model_base.use_flash_prefill(scout, 512)},
        "dbrx": {"norm_type": dbrx.norm_type, "qkv_clip": dbrx.qkv_clip,
                 "group": dbrx.gqa.q_per_kv, "moe_top_k": dbrx.moe.top_k,
                 "decode_gate": decode_attention.supports(dbrx, 1)}}
    emit({"phase": "moe_families_specs", **got})
    nope = tuple(i not in (3, 7) for i in range(LLAMA4_CUT))
    ok = (scout.layer_pattern == nope
          and scout.moe_pattern == (True,) * LLAMA4_CUT
          and scout.attn_chunk == 8192 and scout.attn_temp == (8192.0, 0.1)
          and scout.qk_l2_norm and scout.nope_global
          and not got["llama4"]["decode_gate"]
          and dbrx.norm_type == "layernorm" and dbrx.qkv_clip == 8.0
          and dbrx.gqa.q_per_kv == 6 and got["dbrx"]["decode_gate"])
    if not ok:
        raise AssertionError(f"moe_families specs: {got}")


def _phase_moe_families_kernels(device):
    """20 (a): both decode kernels at DBRX's heads (48 q over 8 KV heads of
    128: G 6, which the kernels run on their 8-wide instantiation with two
    dead rows a group), B 4, lens 300-7000, over bf16 and scaled fp8
    pages (the paged kernel) and caches of 8192 slots (the contiguous
    one), each within one bf16 ulp of its twin's largest output, with a
    control (the twin reading KV head h // 8 for query head h) that must
    part beyond it; and the flash kernel at those heads (bf16, B 2, S
    2048) held to its twin. Each then timed by CUDA-graph replay beside
    the twin, SDPA over the same keys (dequantized for fp8) and the
    bound."""
    import torch
    import torch.nn.functional as F
    from neuronx_distributed_inference_tpu_torch.ops import (
        decode_attention, flash_attention)
    cfg = DBRX_INSTRUCT
    hq, hkv = cfg["n_heads"], cfg["attn_config"]["kv_n_heads"]
    d = cfg["d_model"] // hq
    scale = d ** -0.5
    lens = list(G6_KERNEL_LENS)
    b = len(lens)
    bf = torch.bfloat16
    gen = torch.Generator(device=device).manual_seed(20)
    mb = -(-(max(lens) + 1) // 32)
    geometry = {"Hq": hq, "Hkv": hkv, "D": d, "G": hq // hkv, "lens": lens}
    # the control: query head h read from KV head h // 8 (G 8's map), not
    # h // 6
    heads = torch.arange(hq, device=device) // 8

    def wrong_heads(x, *named):
        return [x[n].index_select(dim, heads) for n, dim in named]

    def g6_gate(kernel, tag, geometry, got, want, control):
        """Gate: the kernel within one bf16 ulp of the twin's largest
        output (tol_decode_bf16); on bf16 pages, the twin at the wrong
        head map (``control()``) parts from the kernel beyond it."""
        tol = tol_decode_bf16(want)
        err = (got.float() - want.float()).abs().max().item()
        ctl = (None if tag != "bf16" else
               (got.float() - control().float()).abs().max().item())
        emit({"phase": "moe_families_kernel_vs_twin", "kernel": kernel,
              "case": f"dbrx_g6_{tag}", "geometry": geometry,
              "max_abs_err": err, "tol": tol,
              "control_h_over_8_max_abs_err": ctl})
        if not (torch.isfinite(got.float()).all() and err <= tol):
            raise AssertionError(f"{kernel} at G 6 ({tag}): {err} > {tol}")
        if ctl is not None and not ctl > tol:
            raise AssertionError(f"{kernel} at G 6 ({tag}): the h // 8 "
                                 f"control sits within {tol} ({ctl})")
        return err
    out = {}
    for tag, dt, kv_scale in (("bf16", bf, None),
                              ("fp8", torch.float8_e4m3fn, G6_FP8_SCALE)):
        kw = dict(scale=scale)
        if kv_scale is not None:
            kw["kv_scale"] = kv_scale
        x = paged_inputs(gen, device, b=b, hq=hq, hkv=hkv, d=d, bs=32, mb=mb,
                         lens=lens, act_dtype=bf, page_dtype=dt,
                         kv_scale=kv_scale)
        args = (x["q"], x["k_pages"], x["v_pages"], x["new_k"], x["new_v"],
                0, x["lens"], x["block_table"])
        err = g6_gate(
            "paged_decode_attention", tag, geometry,
            decode_attention.paged_decode_attention(*args, **kw),
            decode_attention.paged_decode_attention_plain(*args, **kw),
            lambda: decode_attention.paged_decode_attention_plain(
                x["q"], *wrong_heads(x, ("k_pages", 3), ("v_pages", 3),
                                     ("new_k", 1), ("new_v", 1)),
                0, x["lens"], x["block_table"], **kw))
        q4, k4, v4, m4 = sdpa_inputs(dict(x, **{
            n: dequantized_pages(x[n], 0, kv_scale)
            for n in ("k_pages", "v_pages")}), 0)
        out[("paged", tag)] = timed_kernel(
            lambda: decode_attention.paged_decode_attention(*args, **kw),
            lambda: decode_attention.paged_decode_attention_plain(*args,
                                                                  **kw),
            lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=m4, scale=scale, enable_gqa=True),
            kernel_bounds(x), err,
            {"B": b, "Hq": hq, "Hkv": hkv, "D": d, "Bs": 32, "lens": lens,
             "pages": tag})
        del x, args, q4, k4, v4, m4
        c = contiguous_inputs(gen, device, b=b, hq=hq, hkv=hkv, d=d,
                              s=DBRX_SERVE["seq_len"], lens=lens,
                              act_dtype=bf, cache_dtype=dt,
                              kv_scale=kv_scale)
        dargs, dkw = decode_args(c, kw)
        err = g6_gate(
            "decode_attention_stacked", tag,
            dict(geometry, S=DBRX_SERVE["seq_len"]),
            decode_attention.decode_attention_stacked(*dargs, **dkw),
            decode_attention.decode_attention_stacked_plain(*dargs, **dkw),
            lambda: decode_attention.decode_attention_stacked_plain(
                c["q"], *wrong_heads(c, ("k_cache", 2), ("v_cache", 2),
                                     ("new_k", 1), ("new_v", 1)),
                0, c["lens"], **dkw))
        plain = c if kv_scale is None else dict(c, **{
            n: c[n].to(bf) * kv_scale for n in ("k_cache", "v_cache")})
        q4, k4, v4, m4 = contiguous_sdpa_inputs(plain, 0)
        out[("contig", tag)] = timed_kernel(
            lambda: decode_attention.decode_attention_stacked(*dargs,
                                                              **dkw),
            lambda: decode_attention.decode_attention_stacked_plain(
                *dargs, **dkw),
            lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=m4, scale=scale, enable_gqa=True),
            decode_bounds(c), err,
            {"B": b, "Hq": hq, "Hkv": hkv, "D": d,
             "S": DBRX_SERVE["seq_len"], "lens": lens, "cache": tag})
        del c, dargs, plain, q4, k4, v4, m4
    fx = {n: torch.randn((2, 2048, h, d), generator=gen,
                         device=device).to(bf)
          for n, h in (("q", hq), ("k", hkv), ("v", hkv))}
    err = check_flash_against_twin(fx, dict(scale=scale))
    tol = tol_flash_bf16(fx)
    emit({"phase": "moe_families_kernel_vs_twin",
          "kernel": "flash_attention", "case": "dbrx_g6_bf16_s2048",
          "geometry": {"Hq": hq, "Hkv": hkv, "D": d, "G": hq // hkv},
          "max_abs_err": err, "tol": tol})
    if not err <= tol:
        raise AssertionError(f"flash kernel at G 6: {err} > {tol}")
    qt, kt, vt = (fx[n].transpose(1, 2).contiguous() for n in "qkv")
    out[("flash", "bf16")] = timed_kernel(
        lambda: flash_attention.flash_attention(fx["q"], fx["k"], fx["v"],
                                                scale=scale),
        lambda: flash_attention.flash_attention_plain(
            fx["q"], fx["k"], fx["v"], scale=scale),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                               scale=scale, enable_gqa=True),
        flash_bounds(fx["q"], fx["k"]), err,
        {"B": 2, "S": 2048, "Hq": hq, "Hkv": hkv, "D": d},
        plain_calls=3, calls=20)
    del fx, qt, kt, vt
    names = {"paged": "paged_decode_attention",
             "contig": "decode_attention_stacked",
             "flash": "flash_attention"}
    for (kind, tag), t in out.items():
        emit({"phase": "moe_families_kernel_timings", "kernel": names[kind],
              "case": f"dbrx_g6_{tag}", "kernel_us": t["ms"] * 1e3,
              "bound_us": t["bound_ms"] * 1e3, "bound_by": t["bound_by"],
              "plain_us": t["plain_ms"] * 1e3,
              "library_us": t["library_ms"] * 1e3, "library": "SDPA",
              "max_abs_err": t["err"], "shape": t["shape"]})
    # comparison launches are not main-path launches
    reset_launches()
    torch.cuda.empty_cache()
    return out


def generate_logits_rel_rms(got, want, lens):
    """:func:`logits_rel_rms` of two ``generate`` logits lists over each
    row's last prompt token (the prefill's column ``lens[i] - 1``) and
    every decode step."""
    import numpy as np

    def pick(lg):
        return ([np.asarray(lg[0][i, n - 1]) for i, n in enumerate(lens)]
                + [np.asarray(x) for x in lg[1:]])
    return logits_rel_rms(pick(got), pick(want))


def _phase_llama4_fp32(device):
    """20 (c): Scout's widths at Maverick's interleave (layers 1 and 3
    MoE, layer 3 NoPE), 4 layers, fp32 (TF32 off), the attention chunk
    cut to 64 (prompts of 37-500 tokens cross chunks). The contiguous
    app's ``generate`` (``attn_kernel_enabled``; every gate refuses the
    chunk) against the paged app on the same weights: the paged
    ``generate`` fed the contiguous tokens within
    TOL_MOE_FAMILIES_PATHS_FP32_REL, and the ragged engine's streams equal
    the contiguous ones (a first difference only at a near-tie). No
    kernel launches on either app."""
    import numpy as np
    import torch
    hf = moe_families_cut(LLAMA4_SCOUT, LLAMA4_CHECK_LAYERS,
                          interleave_moe_layer_step=2,
                          attention_chunk_size=LLAMA4_CHECK_CHUNK)
    cfg = MOE_FAMILIES_CHECK
    new = MOE_FAMILIES_CHECK_TOKENS
    on_card = device.type == "cuda"
    ids, mask = prompts_of(cfg["lens"], hf["vocab_size"], seed=21)
    lens = mask.sum(axis=1)
    papp = make_ragged_app(hf, device, "float32", cfg, batch=len(lens),
                           output_logits=True, graphs=False)
    init_weights(papp, 0)
    spec = papp.spec
    if (spec.moe_pattern != (False, True, False, True)
            or spec.layer_pattern != (True, True, True, False)
            or spec.attn_chunk != LLAMA4_CHECK_CHUNK):
        raise AssertionError(f"llama4_fp32: spec {spec.moe_pattern} "
                             f"{spec.layer_pattern} {spec.attn_chunk}")
    capp = make_contiguous_app(hf, device, "float32", batch=len(lens),
                               seq_len=cfg["seq_len"], output_logits=True)
    capp.params = papp.params
    reset_launches([papp, capp])
    want = capp.generate(ids, attention_mask=mask, max_new_tokens=new,
                         return_logits=True)
    toks = np.asarray(want["generated"])
    got = papp.generate(ids, attention_mask=mask, max_new_tokens=new,
                        return_logits=True, teacher_tokens=toks[:, :-1])
    rel = generate_logits_rel_rms(got["logits"], want["logits"], lens)
    counts = kernel_counts([papp, capp])
    papp.init_cache()
    prompts = [ids[i, :lens[i]].tolist() for i in range(len(lens))]
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    streams, recs, launches, steps = _ragged_run(
        "llama4_fp32_ragged", papp, prompts, new, cfg, sync,
        hf["num_hidden_layers"], on_card, kernel=False)
    check_equal_streams("llama4_fp32_ragged_vs_contiguous",
                        np.asarray([st.tokens for st in streams]), toks,
                        lambda i, j, lg=want["logits"]: (
                            lg[0][i, lens[i] - 1] if j == 0
                            else lg[j][i, 0]))
    emit({"phase": "llama4_fp32", "layers": hf["num_hidden_layers"],
          "attention_chunk": LLAMA4_CHECK_CHUNK,
          "prompt_lens": list(cfg["lens"]), "new_tokens": new,
          "paged_vs_contiguous_logits_rel_rms": rel,
          "tol": TOL_MOE_FAMILIES_PATHS_FP32_REL, "generate_launches": counts,
          "ragged_launches": launches, "ragged_passes": len(recs),
          "all_decode_ragged_steps": steps})
    if not rel <= TOL_MOE_FAMILIES_PATHS_FP32_REL:
        raise AssertionError(f"llama4_fp32: paged vs contiguous logits "
                             f"{rel}")
    if any(counts.values()):
        raise AssertionError(f"llama4_fp32: kernel launches {counts}")
    del papp, capp, streams, recs
    if on_card:
        free_card()


def qkv_clip_share(app, ids, mask):
    """The share of layer 0's q/k/v values on the prompts' tokens beyond
    +-``qkv_clip`` (before the clamp)."""
    import torch
    from neuronx_distributed_inference_tpu_torch.ops.normalization import \
        layer_norm
    w = app.params["layers"]
    tok = torch.as_tensor(ids[mask.astype(bool)], device=app.device).long()
    h = layer_norm(app.params["embed"][tok], w["input_norm"][0], None,
                   app.spec.rms_eps)
    qkv = h @ w["qkv_proj"][0]
    return float((qkv.abs() > app.spec.qkv_clip).float().mean())


def _phase_dbrx_fp32(device):
    """20 (e): DBRX at 2 layers, fp32 (TF32 off), ``W_qkv`` drawn at
    DBRX_QKV_STD so the clamp bites (the share of layer 0's q/k/v values
    beyond 8 is gated at DBRX_CLIP_SHARE). ``TpuDbrxForCausalLM``'s app
    (flash prefill and the contiguous decode kernel at G 6, after
    ``precompile``) against the paged app on the same weights: the ragged
    engine's streams equal the contiguous ones (a first difference only at
    a near-tie; paged launches = layers x all-decode steps), the paged
    ``generate`` fed the contiguous tokens within
    TOL_MOE_FAMILIES_PATHS_FP32_REL, and the control without the clamp
    (``qkv_clip=None``) beyond TOL_QUANT_CONTROL_REL. Returns the
    contiguous app's (decode-kernel, flash) launches and
    :func:`dbrx_fp32_kernels`' numbers at its shapes."""
    import dataclasses

    import numpy as np
    import torch
    hf = moe_families_cut(DBRX_INSTRUCT, DBRX_CHECK_LAYERS)
    cfg = MOE_FAMILIES_CHECK
    new = MOE_FAMILIES_CHECK_TOKENS
    layers = hf["num_hidden_layers"]
    on_card = device.type == "cuda"
    ids, mask = prompts_of(cfg["lens"], hf["vocab_size"], seed=22)
    lens = mask.sum(axis=1)
    papp = make_ragged_app(hf, device, "float32", cfg, batch=len(lens),
                           output_logits=True, graphs=False)
    init_weights(papp, 0)
    gen = torch.Generator(device=device).manual_seed(23)
    papp.params["layers"]["qkv_proj"].normal_(0.0, DBRX_QKV_STD,
                                              generator=gen)
    share = qkv_clip_share(papp, ids, mask)
    with ContiguousArgsSpy() as spy:
        capp = make_contiguous_app(hf, device, "float32", batch=len(lens),
                                   seq_len=cfg["seq_len"],
                                   output_logits=True)
        capp.params = papp.params
        # the T = 1 decode graphs are captured here, not inside generate
        warm(capp, "dbrx_fp32_contiguous")
        reset_launches([capp])
        with FlashShapes() as flash:
            want = capp.generate(ids, attention_mask=mask,
                                 max_new_tokens=new, return_logits=True)
        counts = kernel_counts([capp])
    spec = capp.spec
    times = dbrx_fp32_kernels(
        device, spy.ints, flash.calls, [int(n) + new - 2 for n in lens],
        dict(scale=spec.scale, window=spec.sliding_window,
             soft_cap=spec.attn_soft_cap))
    toks = np.asarray(want["generated"])
    want_decode = layers * (new - 1) if on_card else 0
    want_flash = layers if on_card else 0

    def logit_at(i, j, lg=want["logits"]):
        return lg[0][i, lens[i] - 1] if j == 0 else lg[j][i, 0]
    papp.init_cache()
    prompts = [ids[i, :lens[i]].tolist() for i in range(len(lens))]
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    streams, recs, launches, steps = _ragged_run(
        "dbrx_fp32_ragged", papp, prompts, new, cfg, sync, layers, on_card)
    check_equal_streams("dbrx_fp32_ragged_vs_contiguous",
                        np.asarray([st.tokens for st in streams]), toks,
                        logit_at)
    papp.init_cache()
    got = papp.generate(ids, attention_mask=mask, max_new_tokens=new,
                        return_logits=True, teacher_tokens=toks[:, :-1])
    rel = generate_logits_rel_rms(got["logits"], want["logits"], lens)
    papp.init_cache()
    papp.spec = dataclasses.replace(papp.spec, qkv_clip=None)
    ctl = papp.generate(ids, attention_mask=mask, max_new_tokens=new,
                        return_logits=True, teacher_tokens=toks[:, :-1])
    control = generate_logits_rel_rms(ctl["logits"], want["logits"], lens)
    emit({"phase": "dbrx_fp32", "layers": layers,
          "prompt_lens": list(cfg["lens"]), "new_tokens": new,
          "qkv_std": DBRX_QKV_STD, "clipped_share": share,
          "clipped_share_min": DBRX_CLIP_SHARE,
          "paged_vs_contiguous_logits_rel_rms": rel,
          "tol": TOL_MOE_FAMILIES_PATHS_FP32_REL,
          "no_clip_control_rel_rms": control,
          "control_min": TOL_QUANT_CONTROL_REL,
          "contiguous_launches": counts,
          "expected": {"decode_attention_stacked": want_decode,
                       "flash_attention": want_flash},
          "contiguous_kernel_calls": sorted(spy.calls),
          "contiguous_kernel_groups": sorted(spy.groups),
          "ragged_paged_launches": launches,
          "all_decode_ragged_steps": steps})
    if not share >= DBRX_CLIP_SHARE:
        raise AssertionError(f"dbrx_fp32: only {share} of q/k/v beyond the "
                             "clip")
    if not rel <= TOL_MOE_FAMILIES_PATHS_FP32_REL:
        raise AssertionError(f"dbrx_fp32: paged vs contiguous logits {rel}")
    if not control > TOL_QUANT_CONTROL_REL:
        raise AssertionError(f"dbrx_fp32: without the clip the logits move "
                             f"by {control} only")
    if (counts["decode_attention_stacked"] != want_decode
            or counts["flash_attention"] != want_flash
            or spy.groups != {6}
            or spy.calls != {(i, 0, False) for i in range(layers)}):
        raise AssertionError(f"dbrx_fp32: contiguous launches {counts}, "
                             f"calls {sorted(spy.calls)}, groups "
                             f"{sorted(spy.groups)}")
    del papp, capp, streams, recs
    if on_card:
        free_card()
    return (counts["decode_attention_stacked"], counts["flash_attention"],
            times)


def dbrx_fp32_kernels(device, dec_ints, flash_calls, lens, fkw,
                      phase="dbrx_fp32", flash=True):
    """20 (e)'s two contiguous kernels (and 21 (f)'s, as ``phase``) at the
    shapes and dtype its main path gave them: the decode kernel (fp32, the CUDA-core route) at the
    launches' (B, Hkv, G, D, S) from ``dec_ints`` (the
    :class:`ContiguousArgsSpy` integers, B = the rows of ``lens``) with
    ``lens`` live keys, and the
    flash kernel at the first prefill launch's shapes from ``flash_calls``
    (:class:`FlashShapes`) with the arguments ``fkw`` the prefill passes
    it (the spec's scale, window and soft-cap); N(0, 1) inputs, each held
    to its twin within TOL_KERNEL_FP32 and timed beside the twin, SDPA
    and the bound (``flash`` False: a path that launches no flash, the
    decode kernel only). Returns {"contig": numbers, "flash": numbers}."""
    import torch
    import torch.nn.functional as F
    from neuronx_distributed_inference_tpu_torch.ops import (
        decode_attention, flash_attention)
    # the captures of every batch bucket; generate replays the one of
    # its rows
    geoms = {(i[0], i[2], i[3], i[4], i[5]) for i in dec_ints
             if i[0] == len(lens)}
    if len(geoms) != 1 or bool(flash_calls) != flash:
        raise AssertionError(f"{phase}: decode launch shapes {geoms}, "
                             f"{len(flash_calls)} flash calls")
    b, hkv, g, d, s_len = geoms.pop()
    gen = torch.Generator(device=device).manual_seed(24)
    f32 = torch.float32
    c = contiguous_inputs(gen, device, b=b, hq=hkv * g, hkv=hkv, d=d,
                          s=s_len, lens=lens, act_dtype=f32,
                          cache_dtype=f32)
    kw = dict(scale=d ** -0.5)
    err = check_decode_against_twin(c, kw)
    shape = {"B": b, "Hq": hkv * g, "Hkv": hkv, "D": d, "S": s_len,
             "lens": lens, "dtype": "float32"}
    emit({"phase": phase + "_kernel_vs_twin",
          "kernel": "decode_attention_stacked", **shape,
          "max_abs_err": err, "tol": TOL_KERNEL_FP32})
    if not err <= TOL_KERNEL_FP32:
        raise AssertionError(f"{phase}: contiguous kernel {err}")
    dargs, dkw = decode_args(c, kw)
    q4, k4, v4, m4 = contiguous_sdpa_inputs(c, 0)
    out = {"contig": timed_kernel(
        lambda: decode_attention.decode_attention_stacked(*dargs, **dkw),
        lambda: decode_attention.decode_attention_stacked_plain(*dargs,
                                                                **dkw),
        lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=m4, scale=kw["scale"], enable_gqa=True),
        decode_bounds(c), err, shape)}
    del c, dargs, q4, k4, v4, m4
    if flash:
        *shapes, dtype = flash_calls[0]
        shapes.append(shapes[1])                # v is shaped as k
        if dtype != f32:
            raise AssertionError(f"{phase}: flash called at {dtype}")
        fx = {n: torch.randn(sh, generator=gen, device=device, dtype=f32)
              for n, sh in zip("qkv", shapes)}
        err = check_flash_against_twin(fx, fkw)
        shape = dict(zip(("B", "S", "Hq", "D"), shapes[0]),
                     Hkv=shapes[1][2], dtype="float32")
        emit({"phase": phase + "_kernel_vs_twin",
              "kernel": "flash_attention", **shape, "kwargs": fkw,
              "max_abs_err": err, "tol": TOL_KERNEL_FP32})
        if not err <= TOL_KERNEL_FP32:
            raise AssertionError(f"{phase}: flash kernel {err}")
        qt, kt, vt = (fx[n].transpose(1, 2).contiguous() for n in "qkv")
        out["flash"] = timed_kernel(
            lambda: flash_attention.flash_attention(fx["q"], fx["k"],
                                                    fx["v"], **fkw),
            lambda: flash_attention.flash_attention_plain(
                fx["q"], fx["k"], fx["v"], **fkw),
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, scale=fkw["scale"],
                enable_gqa=True),
            flash_bounds(fx["q"], fx["k"], fkw.get("window") or 0), err,
            shape, plain_calls=3, calls=20)
    for kind, t in out.items():
        emit({"phase": phase + "_kernel_timings", "kernel": kind,
              "kernel_us": t["ms"] * 1e3, "bound_us": t["bound_ms"] * 1e3,
              "bound_by": t["bound_by"], "plain_us": t["plain_ms"] * 1e3,
              "library_us": t["library_ms"] * 1e3, "library": "SDPA",
              "max_abs_err": t["err"], "shape": t["shape"]})
    # comparison launches are not main-path launches
    reset_launches()
    return out


def phase_moe_families(device):
    """Group ``moe_families`` (phase 20 (a)-(e)); returns its kernels-line
    entries: the paged kernel over DBRX's served cache at G 6 (with (d)'s
    launches), and the contiguous decode and flash kernels with the
    launches of (e)'s fp32 ``TpuDbrxForCausalLM`` run and the numbers
    taken at that run's shapes and dtype (:func:`dbrx_fp32_kernels`)."""
    import torch
    torch.cuda.reset_peak_memory_stats()
    check_moe_family_specs()
    _phase_moe_families_kernels(device)
    memory_note("moe_families_kernels")
    phase_dense_serving(moe_families_cut(LLAMA4_SCOUT, LLAMA4_CUT), device,
                        LLAMA4_SERVE, "llama4_serving", (), kernel=False)
    with fp32_exact():
        _phase_llama4_fp32(device)
    memory_note("llama4_fp32")
    entries = phase_dense_serving(moe_families_cut(DBRX_INSTRUCT, DBRX_CUT),
                                  device, DBRX_SERVE, "dbrx_serving", (-1,),
                                  group=6)
    with fp32_exact():
        decode_launches, flash_launches, fp32_times = _phase_dbrx_fp32(
            device)
    memory_note("dbrx_fp32")
    for kind, name, src, line, launches in (
            ("contig", "decode_attention_stacked", "decode_attention.cu",
             "decode_attention.py:41", decode_launches),
            ("flash", "flash_attention", "flash_attention.cu",
             "flash_attention.py:28", flash_launches)):
        t = fp32_times[kind]
        entries.append({
            "name": name, "route": "cuda",
            "source": "neuronx_distributed_inference_tpu_torch/csrc/" + src,
            "replaces": "neuronx_distributed_inference_tpu/ops/" + line,
            "launches": launches, "max_abs_err": t["err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "path": "dbrx_fp32_contiguous", "shape": t["shape"]})
    return entries


# ---------------------------------------------------------------------------
# Phase 21: the contrib MoE families
# ---------------------------------------------------------------------------

def check_contrib_moe_specs():
    """Gate: the specs of 21 (b)-(f) as the geometries say: GLM-4.5-Air at
    G 12 with partial rotary 64 of 128, the q/k/v bias, the sigmoid router
    with the selection bias and one shared expert after one dense layer;
    Phi-3.5-MoE's biased LayerNorms, lm-head bias, sparsemixer top 2 and
    window 131072 (no rolling cache at 4096); OLMoE at G 1 with the
    full-width q/k norm and unnormalised top 8; granite at G 3, head_dim
    64, scale 1/64, ``pre_softmax_topk``; dots.llm1 at G 1 with full
    rotary, the per-head q/k norm and two shared experts. Every served
    geometry is admitted by the decode gate."""
    from neuronx_distributed_inference_tpu_torch.models import model_base
    from neuronx_distributed_inference_tpu_torch.ops import decode_attention
    glm = family_spec(moe_families_cut(GLM_45_AIR, GLM_CUT))
    phi = family_spec(moe_families_cut(PHI_35_MOE, PHI_CUT),
                      seq_len=PHI_SERVE["seq_len"])
    olmoe = family_spec(OLMOE_1B_7B, seq_len=RAGGED["seq_len"])
    gran = family_spec(GRANITE_3B_MOE, seq_len=RAGGED["seq_len"])
    dots = family_spec(moe_families_cut(DOTS_LLM1, CONTRIB_CHECK_LAYERS["dots1"]))

    def moe_of(spec):
        m = spec.moe
        return {"experts": m.num_experts, "top_k": m.top_k,
                "router": m.router_act, "normalize": m.normalize_topk,
                "pre_softmax_topk": m.pre_softmax_topk,
                "shared": m.shared_intermediate,
                "router_bias": m.has_router_bias}
    got = {
        name: {"group": spec.gqa.q_per_kv, "head_dim": spec.head_dim,
               "rotary_dim": spec.rope.rotary_dim, "scale": spec.scale,
               "stacks": sorted({k for k, *_ in
                                 model_base.layer_plan(spec)}),
               "qkv_bias": spec.qkv_bias, "o_bias": spec.o_bias,
               "qk_norm": spec.qk_norm, "qk_norm_full": spec.qk_norm_full,
               "norm": [spec.norm_type, spec.norm_bias],
               "lm_head_bias": spec.lm_head_bias,
               "window": spec.sliding_window,
               "rolling": spec.rolling_window, "moe": moe_of(spec),
               "decode_gate": decode_attention.supports(spec, 1)}
        for name, spec in (("glm4_moe", glm), ("phimoe", phi),
                           ("olmoe", olmoe), ("granitemoe", gran),
                           ("dots1", dots))}
    emit({"phase": "contrib_moe_specs", **got})
    ok = (glm.gqa.q_per_kv == 12 and glm.rope.rotary_dim == 64
          and glm.qkv_bias and not glm.qk_norm and glm.first_dense == 1
          and glm.moe.router_act == "sigmoid" and glm.moe.has_router_bias
          and glm.moe.shared_intermediate == 1408
          and phi.norm_type == "layernorm" and phi.norm_bias
          and phi.lm_head_bias and phi.qkv_bias and phi.o_bias
          and phi.moe.router_act == "sparsemixer"
          and phi.sliding_window == 131072 and not phi.rolling_window
          and olmoe.gqa.q_per_kv == 1 and olmoe.qk_norm_full
          and not olmoe.moe.normalize_topk
          and gran.gqa.q_per_kv == 3 and gran.head_dim == 64
          and gran.scale == 0.015625 and gran.moe.pre_softmax_topk
          and gran.tie_word_embeddings
          and dots.gqa.q_per_kv == 1 and dots.qk_norm
          and dots.rope.rotary_dim is None
          and dots.moe.shared_intermediate == 2 * 1408
          and all(v["decode_gate"] for v in got.values()))
    if not ok:
        raise AssertionError(f"contrib_moe specs: {got}")


def contrib_kernel_inputs(name, device, gen, kind):
    """21 (a)'s inputs of one case of CONTRIB_KERNEL_CASES for the paged
    (``kind`` "paged", block 32) or the contiguous ("contig") kernel, and
    the kernel's keyword arguments."""
    import torch
    c = CONTRIB_KERNEL_CASES[name]
    dt = getattr(torch, c["dtype"])
    act = torch.float32 if dt == torch.float32 else torch.bfloat16
    kv_scale = c.get("kv_scale")
    lens = list(c["lens"])
    geom = dict(b=len(lens), hq=c["hq"], hkv=c["hkv"], d=c["d"], lens=lens,
                act_dtype=act, kv_scale=kv_scale)
    if kind == "paged":
        x = paged_inputs(gen, device, bs=32, mb=-(-(max(lens) + 1) // 32),
                         page_dtype=dt, **geom)
    else:
        x = contiguous_inputs(gen, device, s=c["s"], cache_dtype=dt, **geom)
    kw = dict(scale=c.get("scale", c["d"] ** -0.5))
    if kv_scale is not None:
        kw["kv_scale"] = kv_scale
    return x, kw


def contrib_kernel_tol(want) -> float:
    """21 (a)'s gate: one bf16 ulp of the twin's largest output for a bf16
    output (tol_decode_bf16), TOL_KERNEL_FP32 for an fp32 one."""
    import torch
    return (TOL_KERNEL_FP32 if want.dtype == torch.float32
            else tol_decode_bf16(want))


def _phase_contrib_kernels(device):
    """21 (a): both decode kernels at each case of CONTRIB_KERNEL_CASES
    (G 12 at GLM-4.5-Air's heads over bf16, scaled fp8 and fp32 pages /
    caches of 8192 slots; G 3 at head_dim 64 with granite's scale 1/64;
    G 1 at OLMoE's heads; B 4), each within contrib_kernel_tol of its
    twin, with a control (the twin reading KV head h // (G + 1) for query
    head h) that must part beyond it on bf16 pages; flash at G 12 and at
    G 3 / D 64 (bf16, B 2, S 2048) within one bf16 ulp of its twin. Each
    then timed by CUDA-graph replay beside the twin, SDPA over the same
    keys (dequantized for fp8) and the bound. Returns {(kernel, case):
    numbers}."""
    import torch
    import torch.nn.functional as F
    from neuronx_distributed_inference_tpu_torch.ops import (
        decode_attention, flash_attention)
    gen = torch.Generator(device=device).manual_seed(21)
    out = {}

    def gate(kernel, name, geometry, got, want, control):
        tol = contrib_kernel_tol(want)
        err = (got.float() - want.float()).abs().max().item()
        ctl = (None if control is None else
               (got.float() - control().float()).abs().max().item())
        emit({"phase": "contrib_kernel_vs_twin", "kernel": kernel,
              "case": name, "geometry": geometry, "max_abs_err": err,
              "tol": tol, "control_h_over_g_plus_1_max_abs_err": ctl})
        if not (torch.isfinite(got.float()).all() and err <= tol):
            raise AssertionError(f"{kernel} {name}: {err} > {tol}")
        if ctl is not None and not ctl > tol:
            raise AssertionError(f"{kernel} {name}: the h // (G + 1) "
                                 f"control sits within {tol} ({ctl})")
        return err
    for name, c in CONTRIB_KERNEL_CASES.items():
        g = c["hq"] // c["hkv"]
        heads = torch.arange(c["hq"], device=device) // (g + 1)
        kv_scale = c.get("kv_scale")
        bf16 = c["dtype"] == "bfloat16"
        geometry = {"Hq": c["hq"], "Hkv": c["hkv"], "D": c["d"], "G": g,
                    "lens": list(c["lens"]), "pages": c["dtype"]}

        def wrong(x, *named):
            return [x[n].index_select(dim, heads) for n, dim in named]
        x, kw = contrib_kernel_inputs(name, device, gen, "paged")
        args = (x["q"], x["k_pages"], x["v_pages"], x["new_k"], x["new_v"],
                0, x["lens"], x["block_table"])
        err = gate(
            "paged_decode_attention", name, geometry,
            decode_attention.paged_decode_attention(*args, **kw),
            decode_attention.paged_decode_attention_plain(*args, **kw),
            (lambda: decode_attention.paged_decode_attention_plain(
                x["q"], *wrong(x, ("k_pages", 3), ("v_pages", 3),
                               ("new_k", 1), ("new_v", 1)),
                0, x["lens"], x["block_table"], **kw)) if bf16 else None)
        q4, k4, v4, m4 = sdpa_inputs(dict(x, **{
            n: dequantized_pages(x[n], 0, kv_scale).to(x["q"].dtype)
            for n in ("k_pages", "v_pages")}), 0)
        out[("paged", name)] = timed_kernel(
            lambda: decode_attention.paged_decode_attention(*args, **kw),
            lambda: decode_attention.paged_decode_attention_plain(*args,
                                                                  **kw),
            lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=m4, scale=kw["scale"],
                enable_gqa=True),
            kernel_bounds(x), err, dict(geometry, B=len(c["lens"]), Bs=32))
        del x, args, q4, k4, v4, m4
        x, kw = contrib_kernel_inputs(name, device, gen, "contig")
        dargs, dkw = decode_args(x, kw)
        err = gate(
            "decode_attention_stacked", name, dict(geometry, S=c["s"]),
            decode_attention.decode_attention_stacked(*dargs, **dkw),
            decode_attention.decode_attention_stacked_plain(*dargs, **dkw),
            (lambda: decode_attention.decode_attention_stacked_plain(
                x["q"], *wrong(x, ("k_cache", 2), ("v_cache", 2),
                               ("new_k", 1), ("new_v", 1)),
                0, x["lens"], **dkw)) if bf16 else None)
        plain = x if kv_scale is None else dict(x, **{
            n: x[n].to(torch.bfloat16) * kv_scale
            for n in ("k_cache", "v_cache")})
        q4, k4, v4, m4 = contiguous_sdpa_inputs(plain, 0)
        out[("contig", name)] = timed_kernel(
            lambda: decode_attention.decode_attention_stacked(*dargs,
                                                              **dkw),
            lambda: decode_attention.decode_attention_stacked_plain(
                *dargs, **dkw),
            lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=m4, scale=kw["scale"],
                enable_gqa=True),
            decode_bounds(x), err, dict(geometry, B=len(c["lens"]),
                                        S=c["s"]))
        del x, dargs, plain, q4, k4, v4, m4
    for name, c in CONTRIB_FLASH_CASES.items():
        d = c["d"]
        scale = c.get("scale", d ** -0.5)
        fx = {n: torch.randn((2, 2048, h, d), generator=gen,
                             device=device).to(torch.bfloat16)
              for n, h in (("q", c["hq"]), ("k", c["hkv"]),
                           ("v", c["hkv"]))}
        err = check_flash_against_twin(fx, dict(scale=scale))
        tol = tol_flash_bf16(fx)
        shape = {"B": 2, "S": 2048, "Hq": c["hq"], "Hkv": c["hkv"], "D": d,
                 "G": c["hq"] // c["hkv"], "scale": scale}
        emit({"phase": "contrib_kernel_vs_twin", "kernel": "flash_attention",
              "case": name, "geometry": shape, "max_abs_err": err,
              "tol": tol})
        if not err <= tol:
            raise AssertionError(f"flash kernel {name}: {err} > {tol}")
        qt, kt, vt = (fx[n].transpose(1, 2).contiguous() for n in "qkv")
        out[("flash", name)] = timed_kernel(
            lambda: flash_attention.flash_attention(
                fx["q"], fx["k"], fx["v"], scale=scale),
            lambda: flash_attention.flash_attention_plain(
                fx["q"], fx["k"], fx["v"], scale=scale),
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, scale=scale, enable_gqa=True),
            flash_bounds(fx["q"], fx["k"]), err, shape, plain_calls=3,
            calls=20)
        del fx, qt, kt, vt
    names = {"paged": "paged_decode_attention",
             "contig": "decode_attention_stacked",
             "flash": "flash_attention"}
    for (kind, name), t in out.items():
        emit({"phase": "contrib_kernel_timings", "kernel": names[kind],
              "case": name, "kernel_us": t["ms"] * 1e3,
              "bound_us": t["bound_ms"] * 1e3, "bound_by": t["bound_by"],
              "plain_us": t["plain_ms"] * 1e3,
              "library_us": t["library_ms"] * 1e3, "library": "SDPA",
              "max_abs_err": t["err"], "shape": t["shape"]})
    # comparison launches are not main-path launches
    reset_launches()
    torch.cuda.empty_cache()
    return out


def contrib_fp32_cut(name, hf, device, timed=False):
    """21 (f), one geometry cut to CONTRIB_CHECK_LAYERS layers, fp32 (TF32
    off): :func:`dense_fp32_cut`'s gates on the paged app (the kernel path
    against the gather path, the ragged engine's streams equal
    ``generate``'s; prefill chunks of 128, so the short rows' decode steps
    ride mixed passes on the gather path while the long rows prefill),
    then the family's contiguous ``CausalLMApplication``
    on the same weights (``attn_kernel_enabled``, after ``precompile``):
    its greedy streams equal the paged app's (a first difference only at a
    near-tie), flash launches = layers x 1 prefill and the decode kernel's
    (replays counted) = layers x decode steps, every launch at the
    geometry's group and window 0 — or, where the window puts the
    contiguous app on the rolling cache (Phi-3.5-MoE's cut), none (the
    gather path over the rolling slots). Returns the contiguous app's
    (decode launches, flash launches, and with ``timed`` the kernels'
    numbers at its shapes, :func:`dbrx_fp32_kernels`)."""
    import numpy as np
    import torch
    cfg = CONTRIB_CHECK
    new = DENSE_CHECK_TOKENS
    layers = hf["num_hidden_layers"]
    on_card = device.type == "cuda"
    toks, ids, mask = dense_fp32_cut(name, hf, device, cfg)
    lens = mask.sum(axis=1)
    with ContiguousArgsSpy() as spy:
        capp = make_contiguous_app(hf, device, "float32", batch=len(lens),
                                   seq_len=cfg["seq_len"],
                                   output_logits=True, rolling=None)
        init_weights(capp, 0)
        warm(capp, f"contrib_fp32_{name}_contiguous")
        reset_launches([capp])
        with FlashShapes() as flash:
            want = capp.generate(ids, attention_mask=mask,
                                 max_new_tokens=new, return_logits=True)
        counts = kernel_counts([capp])
    spec = capp.spec
    group = spec.gqa.q_per_kv
    rolling = spec.rolling_window
    want_decode = layers * (new - 1) if on_card and not rolling else 0
    want_flash = layers if on_card else 0
    want_calls = set() if rolling else {(i, 0, False) for i in range(layers)}
    emit({"phase": f"contrib_fp32_{name}_contiguous", "layers": layers,
          "rolling_window": rolling, "window": spec.sliding_window,
          "launches": counts,
          "expected": {"decode_attention_stacked": want_decode,
                       "flash_attention": want_flash},
          "decode_calls": sorted(spy.calls),
          "decode_groups": sorted(spy.groups),
          "flash_shapes": [list(map(str, c)) for c in flash.calls[:2]]})
    if (counts["decode_attention_stacked"] != want_decode
            or counts["flash_attention"] != want_flash
            or (on_card and spy.calls != want_calls)
            or (on_card and not rolling and spy.groups != {group})):
        raise AssertionError(f"contrib_fp32_{name}: contiguous launches "
                             f"{counts}, calls {sorted(spy.calls)}, groups "
                             f"{sorted(spy.groups)}")
    logits = want["logits"]
    check_equal_streams(
        f"contrib_fp32_{name}_contiguous_vs_paged",
        np.asarray(want["generated"]), toks,
        lambda i, j: (logits[0][i, lens[i] - 1] if j == 0
                      else logits[j][i, 0]))
    times = None
    if on_card and timed:
        times = dbrx_fp32_kernels(
            device, spy.ints, flash.calls, [int(n) + new - 2 for n in lens],
            dict(scale=spec.scale, window=spec.sliding_window,
                 soft_cap=spec.attn_soft_cap), phase=f"contrib_fp32_{name}")
    del capp
    if on_card:
        free_card()
    return (counts["decode_attention_stacked"], counts["flash_attention"],
            times)


def phase_contrib_fp32(device):
    with fp32_exact():
        return _phase_contrib_fp32(device)


def _phase_contrib_fp32(device):
    """21 (f): every geometry's fp32 cut (Phi-3.5-MoE's with
    PHI_CHECK_WINDOW), the kernels timed at GLM-4.5-Air's (G 12) and
    granite's (G 3 / D 64) shapes; returns {name: contrib_fp32_cut's
    result}."""
    out = {}
    for name, hf in (("glm4_moe", GLM_45_AIR), ("phimoe", PHI_35_MOE),
                     ("olmoe", OLMOE_1B_7B), ("granitemoe", GRANITE_3B_MOE),
                     ("dots1", DOTS_LLM1)):
        over = ({"sliding_window": PHI_CHECK_WINDOW} if name == "phimoe"
                else {})
        out[name] = contrib_fp32_cut(
            name, moe_families_cut(hf, CONTRIB_CHECK_LAYERS[name], **over),
            device, timed=name in ("glm4_moe", "granitemoe"))
        if device.type == "cuda":
            memory_note(f"contrib_fp32_{name}")
    return out


def phase_contrib_moe(device):
    """Group ``contrib_moe`` (phase 21 (a)-(f)); returns its kernels-line
    entries: the paged kernel over each served cache of (b)-(e) at its
    last layer (with that run's launches), and the contiguous decode and
    flash kernels at (f)'s GLM-4.5-Air (G 12) and granite (G 3 / D 64)
    cuts' shapes and dtype, with those runs' launches."""
    import torch
    torch.cuda.reset_peak_memory_stats()
    check_contrib_moe_specs()
    _phase_contrib_kernels(device)
    memory_note("contrib_kernels")
    entries = []
    for hf, cfg, phase, group, batch in (
            (moe_families_cut(GLM_45_AIR, GLM_CUT), GLM_SERVE, "glm_air_serving",
             12, 4),
            (moe_families_cut(PHI_35_MOE, PHI_CUT), PHI_SERVE, "phimoe_serving",
             4, 4),
            (OLMOE_1B_7B, RAGGED, "olmoe_serving", 1, 8),
            (moe_families_cut(GRANITE_3B_MOE, GRANITE_MOE_CUT), RAGGED,
             "granitemoe_serving", 3, 8)):
        entries += phase_dense_serving(hf, device, cfg, phase, (-1,),
                                       group=group, batch=batch)
    cuts = phase_contrib_fp32(device)
    for name in ("glm4_moe", "granitemoe"):
        decode_launches, flash_launches, times = cuts[name]
        entries += contiguous_kernel_entries(
            times, decode_launches, flash_launches,
            f"contrib_fp32_{name}_contiguous")
    return entries


# ---------------------------------------------------------------------------
# Phase 22: fused speculation, EAGLE, Medusa and token trees on the
# contiguous app; the Medusa and EAGLE proposers on the ragged engine
# ---------------------------------------------------------------------------

# (a)-(c): batch 4 on the contiguous app, seq_len 4096, k 4 drafts a step,
#   4 Medusa heads (Medusa-1: a ResBlock, then each head's lm head), the
#   EAGLE tree at depth 4, branch 4, 16 nodes
SPEC22 = dict(lens=(64, 300, 700, 1024), new_tokens=48, seq_len=4096, k=4,
              heads=4, depth=4, branch=4, nodes=16)
# (d): phase 9's eight requests on the ragged engine, 32 new tokens each
SPEC22_SERVE_TOKENS = 32
# (e): the fp32 cuts
SPEC22_CHECK_LAYERS = 4


def make_spec_app(hf, device, dtype, *, heads=0, output_logits=False,
                  spec=True):
    """The contiguous ``CausalLMApplication`` of phase 22: batch 4,
    ``seq_len`` 4096, both kernels on (``attn_kernel_enabled``), the
    prefill's hidden states out (``output_full_hidden``, EAGLE primes its
    draft from them), and with ``spec`` the speculation config (k drafts
    for the fused and EAGLE paths, ``heads`` + 1 candidates for Medusa);
    ``heads`` Medusa heads in the spec (and so in its weights)."""
    import dataclasses
    from neuronx_distributed_inference_tpu_torch.config import (
        SpeculationConfig, TpuConfig)
    from neuronx_distributed_inference_tpu_torch.models.application import \
        CausalLMApplication
    from neuronx_distributed_inference_tpu_torch.models.family import \
        get_family
    family = get_family(hf["model_type"])
    sc = (SpeculationConfig(speculation_length=SPEC22["k"],
                            medusa_speculation_length=SPEC22["heads"] + 1,
                            num_medusa_heads=SPEC22["heads"])
          if spec else None)
    tcfg = TpuConfig(batch_size=len(SPEC22["lens"]),
                     seq_len=SPEC22["seq_len"], dtype=dtype,
                     attn_kernel_enabled=True, output_logits=output_logits,
                     output_full_hidden=True, speculation_config=sc)
    app = CausalLMApplication(None, family.config_cls(tcfg, **hf), family,
                              device=device)
    if heads:
        app.spec = dataclasses.replace(app.spec, medusa_heads=heads)
    return app.init_cache()


def teacher_deficits(app, prompts, streams, adapter_ids=None):
    """Each stream held to the contiguous ``app`` (built with
    ``output_logits``; its plain greedy decode) fed that stream's tokens:
    the prompts in batches of the app's rows (a short batch repeats its
    first prompt), the prefill's last position and every decode step;
    ``adapter_ids[i]``: request i's LoRA slot (None: no adapters).
    Returns per request (deficits in logit stds, raw deficits, the
    control's deficits (the token one id further), argmax-equal steps)."""
    import dataclasses

    import numpy as np
    import torch
    from neuronx_distributed_inference_tpu_torch.models import model_base
    from neuronx_distributed_inference_tpu_torch.modules import \
        autobucketing
    rows = app.tpu_config.batch_size
    vocab = app.spec.vocab_size
    dev = app.device
    cfg = dataclasses.replace(app.tpu_config, output_logits=False)
    out = []
    for lo in range(0, len(prompts), rows):
        part = list(range(lo, min(lo + rows, len(prompts))))
        idx = part + [part[0]] * (rows - len(part))
        lens = np.asarray([len(prompts[i]) for i in idx], np.int32)
        bucket = autobucketing.get_target_bucket(app.ctx_buckets,
                                                 int(lens.max()))
        ids = np.zeros((rows, bucket), np.int32)
        for r, i in enumerate(idx):
            ids[r, :lens[r]] = prompts[i]
        served = np.stack([np.asarray(streams[i], np.int32) for i in idx])
        aids = (None if adapter_ids is None else
                np.asarray([adapter_ids[i] for i in idx], np.int32))
        app.reset()
        pos = torch.arange(bucket, dtype=torch.int32,
                           device=dev)[None].expand(rows, bucket)
        # the prefill without its full logits: the last position's only
        pre = model_base.context_encoding_step(
            app.spec, cfg, app.params, app.cache,
            torch.as_tensor(ids, device=dev), pos,
            torch.arange(rows, dtype=torch.int32, device=dev),
            torch.as_tensor(lens, device=dev), None, app.generator,
            app._inv_freq,
            None if aids is None else torch.as_tensor(aids, device=dev))
        lg = [model_base._lm_head(app.spec, app.params,
                                  pre["last_hidden"][:, None])[:, 0, :vocab]]
        p = lens.copy()
        for j in range(1, served.shape[1]):
            o = app._run_decode(served[:, j - 1:j], p[:, None],
                                adapter_ids=aids)
            lg.append(o["logits"][:, -1, :vocab])
            p = p + 1
        L = torch.stack(lg, dim=1).double()
        tok = torch.as_tensor(served, device=dev).long()
        top = L.max(dim=-1).values
        std = L.std(dim=-1, correction=0)
        raw = top - L.gather(-1, tok[..., None])[..., 0]
        ctl = top - L.gather(-1, ((tok + 1) % vocab)[..., None])[..., 0]
        am = (L.argmax(dim=-1) == tok)
        res = [x.cpu().numpy() for x in (raw / std, raw, ctl / std, am)]
        out += [tuple(x[r] for x in res) for r in range(len(part))]
        del L
    app.reset()
    return out


def deficit_gate(phase, per, exact):
    """Gate of a served or speculative stream set from
    :func:`teacher_deficits`. bf16 (``exact`` False): every token within
    TOL_SERVED_DEFICIT_BF16 logit stds of the top logit and within
    TOL_SERVED_MEAN_DEFICIT_BF16 on average, the control beyond the first
    at most steps (as ``served_vs_generate``). fp32 (``exact``): every
    token is greedy's, or sits within NEAR_TIE logits of the top (a
    near-tie, printed). Returns the emitted summary."""
    import numpy as np
    d = np.concatenate([x[0] for x in per])
    raw = np.concatenate([x[1] for x in per])
    ctl = np.concatenate([x[2] for x in per])
    am = np.concatenate([x[3] for x in per])
    ties = [(i, int(j), float(x[1][j])) for i, x in enumerate(per)
            for j in np.nonzero(x[1] > 0)[0]]
    far = float(np.mean(ctl > TOL_SERVED_DEFICIT_BF16))
    rep = {"phase": phase + "_vs_greedy", "tokens": int(d.size),
           "argmax_equal": int(am.sum()), "max_deficit": float(d.max()),
           "mean_deficit": float(d.mean()),
           "control_share_beyond_bound": far,
           "streams_equal_greedy": sum(int(x[3].all()) for x in per),
           "requests": len(per)}
    if exact:
        rep.update(near_ties=ties, bound_raw=NEAR_TIE)
    else:
        rep.update(bound=TOL_SERVED_DEFICIT_BF16,
                   mean_bound=TOL_SERVED_MEAN_DEFICIT_BF16)
    emit(rep)
    if exact:
        bad = [t for t in ties if not t[2] <= NEAR_TIE]
        if bad:
            raise AssertionError(f"{phase}: tokens off greedy decode beyond "
                                 f"a near-tie: {bad[:4]}")
        return rep
    if not (d.max() <= TOL_SERVED_DEFICIT_BF16
            and d.mean() <= TOL_SERVED_MEAN_DEFICIT_BF16):
        raise AssertionError(f"{phase}: tokens up to {d.max()} (mean "
                             f"{d.mean()}) logit stds below greedy's top")
    if not far > 0.5:
        raise AssertionError(f"{phase}: the control sits within the bound "
                             f"at {1 - far:.2f} of the steps")
    return rep


def spec_run(phase, dec, ids, mask, apps, new_tokens, layers_per_step,
             exact, ref, prompts, before_measure=None):
    """One decoder: a short warm run (the step's graph captured), the
    kernel counts and the decoder's replays zeroed, the measured run of
    ``new_tokens``, then the gates: the contiguous decode kernel's
    launches equal ``layers_per_step`` x the replayed steps (T = 1 draft
    steps inside the graph; none eager), and the streams held to greedy
    decode (:func:`deficit_gate`). ``before_measure()`` runs just before
    the measured run. Returns (result, launches, steps, gate summary)."""
    import torch
    for app in apps:
        app.reset()
    dec.generate(ids, max_new_tokens=8, attention_mask=mask)
    for app in apps:
        app.reset()
    on_card = dec.graphs is not None
    if before_measure is not None:
        before_measure()
    reset_launches()
    if on_card:
        dec.graphs.reset_counts()
    t0 = time.perf_counter()
    out = dec.generate(ids, max_new_tokens=new_tokens, attention_mask=mask)
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernel_counts()
    steps = sum(dec.graphs.replays.values()) if on_card else 0
    launches = counts["decode_attention_stacked"] + (
        dec.graphs.replayed_launches("decode_attention_stacked")
        if on_card else 0)
    want = layers_per_step * steps
    mean = out.get("mean_tokens_per_step", out.get("mean_accept"))
    k = dec.k if hasattr(dec, "k") else None
    emit({"phase": phase, "new_tokens": new_tokens, "steps": steps,
          "mean_tokens_per_step": mean,
          "accept_rate": ((mean - 1) / k) if k else None,
          "seconds": wall, "launches": launches, "expected_launches": want,
          "eager_decode_launches": counts["decode_attention_stacked"],
          "flash_launches": counts["flash_attention"]})
    if on_card and (launches != want
                    or counts["decode_attention_stacked"] != 0):
        raise AssertionError(f"{phase}: decode kernel launches {launches} "
                             f"!= {want} ({layers_per_step} x {steps} "
                             f"steps), eager {counts}")
    gate = deficit_gate(phase, teacher_deficits(
        ref, prompts, [list(r) for r in out["generated"]]), exact)
    return out, launches, steps, gate


def b2_entry(phase, device, cache, lens, spec, launches):
    """The contiguous decode kernel over ``cache``'s last layer at the
    rows' positions ``lens``, the query and the new token drawn at the
    cache's own scale (q . k of unit spread, the new value weighing like
    a cached one, so the output is the cached keys' doing): within one
    bf16 ulp of its twin's largest output (tol_decode_bf16), with two
    controls that must part from the kernel beyond that (the twin reading
    KV head h // (G + 1) for query head h; the twin over each row's first
    half of its keys); timed beside the twin and SDPA (D-contiguous
    copies), its bound; returns the kernels-line entry."""
    import torch
    import torch.nn.functional as F
    from neuronx_distributed_inference_tpu_torch.ops import decode_attention
    gen = torch.Generator(device=device).manual_seed(22)
    b = len(lens)
    hq, hkv, d = spec.num_q_heads, spec.num_kv_heads, spec.head_dim
    layer = cache["k"].shape[0] - 1
    live = min(int(x) for x in lens)
    ks = cache["k"][layer, :, :, :, :live].float().std().item()
    vs = cache["v"][layer, :, :, :live].float().std().item()

    def rnd(sd, *shape):
        return (torch.randn(shape, generator=gen, device=device)
                * sd).to(torch.bfloat16)
    dec = dict(q=rnd(1 / ks, b, hq, d), k_cache=cache["k"],
               v_cache=cache["v"], new_k=rnd(ks, b, hkv, d),
               new_v=rnd(vs, b, hkv, d),
               lens=torch.tensor([int(x) for x in lens], dtype=torch.int32,
                                 device=device))
    kw = dict(scale=spec.scale, layer=layer)
    args, kw2 = decode_args(dec, kw)
    got = decode_attention.decode_attention_stacked(*args, **kw2).float()
    want = decode_attention.decode_attention_stacked_plain(*args, **kw2)
    tol = tol_decode_bf16(want)
    err = (got - want.float()).abs().max().item()
    heads = torch.arange(hq, device=device) // (hq // hkv + 1)
    wrong = [x.index_select(dim, heads) for x, dim in (
        (cache["k"][layer:], 2), (cache["v"][layer:], 2),
        (dec["new_k"], 1), (dec["new_v"], 1))]
    ctl = {"control_h_over_g_plus_1_max_abs_err": (
        dec["q"], *wrong, 0, dec["lens"]),
        "control_half_keys_max_abs_err": (*args[:6], dec["lens"] // 2)}
    ctl = {n: (got - decode_attention.decode_attention_stacked_plain(
        *a, **kw2).float()).abs().max().item() for n, a in ctl.items()}
    del want, wrong
    if not (torch.isfinite(got).all() and err <= tol):
        raise AssertionError(f"{phase}: decode kernel vs twin {err} > {tol}")
    for n, c in ctl.items():
        if not c > tol:
            raise AssertionError(f"{phase}: {n} {c} sits within {tol}")
    q4, kk, vv, smask = contiguous_sdpa_inputs(dec, layer)
    t = timed_kernel(
        lambda: decode_attention.decode_attention_stacked(*args, **kw2),
        lambda: decode_attention.decode_attention_stacked_plain(*args,
                                                                **kw2),
        lambda: F.scaled_dot_product_attention(
            q4, kk, vv, attn_mask=smask, scale=spec.scale, enable_gqa=True),
        decode_bounds(dec), err,
        {"B": b, "Hq": hq, "Hkv": hkv, "D": d, "G": hq // hkv,
         "S": cache["k"].shape[4], "lens": [int(x) for x in lens],
         "layer": layer})
    emit({"phase": phase + "_kernel", "kernel_us": t["ms"] * 1e3,
          "plain_us": t["plain_ms"] * 1e3, "library_us": t["library_ms"] * 1e3,
          "bound_us": t["bound_ms"] * 1e3, "bound_by": t["bound_by"],
          "max_abs_err": err, "tol": tol, **ctl,
          "launches": launches, "shape": t["shape"]})
    del kk, vv
    return {"name": "decode_attention_stacked", "route": "cuda",
            "source": "neuronx_distributed_inference_tpu_torch/csrc/"
                      "decode_attention.cu",
            "replaces": "neuronx_distributed_inference_tpu/ops/"
                        "decode_attention.py:41",
            "launches": launches, "max_abs_err": err, "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]}


def step_timings(phase, dec, target, ids, mask):
    """Host ms of one replayed fused step (its fetch included) against
    one replayed plain decode step of the target (tokens fetched), 8 of
    each in turns (fused, plain, plain, fused), at positions past the
    prompts; then a torch.profiler trace of 4 fused steps."""
    import numpy as np
    b = ids.shape[0]
    pos = (mask.sum(axis=1) + 60).astype(np.int32)
    last = np.full((b,), 7, np.int32)
    sid = np.arange(b, dtype=np.int32)

    def fused():
        for _ in range(8):
            dec._step(last, pos, sid)

    def plain():
        for _ in range(8):
            target._run_decode(last[:, None], pos[:, None])["tokens"].cpu()
    t = {"fused": [], "plain": []}
    for tag in ("fused", "plain", "plain", "fused"):
        t[tag].append(time_host(fused if tag == "fused" else plain,
                                reps=3) / 8)
    wall, per = device_kernels(
        lambda: [dec._step(last, pos, sid) for _ in range(4)])
    prof = profile_summary_of(wall / 4, {n: ms / 4 for n, ms in per.items()})
    emit({"phase": phase + "_step_ms", "fused_ms_per_step": t["fused"],
          "plain_decode_ms_per_step": t["plain"],
          "profile_per_fused_step": prof})
    return t


def spec_decoders(device, target_hf, draft_hf, dtype, phase, timings):
    """(a)-(c) on one target's weights: fused speculation with a separate
    draft and with the target as its own draft, EAGLE (chain and tree),
    Medusa (chain, DEFAULT_TREE, the dynamic tree). ``timings``: the B2
    entries at the draft shapes, the step times and the profile (bf16 at
    full depth). Returns (kernel entries, the shared objects for (d))."""
    import dataclasses

    import numpy as np
    import torch
    from neuronx_distributed_inference_tpu_torch.models import speculation
    from neuronx_distributed_inference_tpu_torch.modules import kv_cache
    exact = dtype == "float32"
    k, heads = SPEC22["k"], SPEC22["heads"]
    target = make_spec_app(target_hf, device, dtype, heads=heads)
    target.init_random_weights(0)
    ref = make_spec_app(target_hf, device, dtype, output_logits=True,
                        spec=False)
    ref.params = target.params
    ids, mask = prompts_of(SPEC22["lens"], target_hf["vocab_size"],
                           seed=22)
    prompts = [list(ids[i, :n]) for i, n in enumerate(SPEC22["lens"])]
    new = SPEC22["new_tokens"]
    entries = []
    t_layers = target_hf["num_hidden_layers"]

    # (a) fused speculation: the Llama-3.2-1B-shaped draft, then the
    # target drafting for itself
    draft = make_spec_app(draft_hf, device, dtype, spec=False)
    draft.init_random_weights(0)
    dec = speculation.SpeculativeDecoder(target, draft)
    out, launches, steps, _ = spec_run(
        phase + "_fused", dec, ids, mask, (target, draft), new,
        draft_hf["num_hidden_layers"] * k, exact, ref, prompts)
    if timings:
        step_timings(phase + "_fused", dec, target, ids, mask)
        entries.append(b2_entry(phase + "_fused_draft", device, draft.cache,
                                mask.sum(axis=1) + new - 2, draft.spec,
                                launches))
    del dec, draft
    selfd = make_spec_app(target_hf, device, dtype, spec=False)
    selfd.params = target.params
    dec = speculation.SpeculativeDecoder(target, selfd)
    first_counts = []
    orig = dec._step

    def counting(last, pos, sid):
        toks, n = orig(last, pos, sid)
        first_counts.append(n.copy())
        return toks, n
    dec._step = counting
    out, launches, steps, _ = spec_run(
        phase + "_self", dec, ids, mask, (target, selfd), new,
        t_layers * k, exact, ref, prompts,
        before_measure=first_counts.clear)
    # the measured run's first step: every row's draft cache holds its
    # whole context, so in fp32 every draft is accepted
    first = first_counts[0]
    emit({"phase": phase + "_self_accept",
          "mean_tokens_per_step": out["mean_tokens_per_step"],
          "accept_rate": (out["mean_tokens_per_step"] - 1) / k,
          "first_step_emitted": first.tolist(),
          "emitted_per_step": [n.tolist() for n in first_counts]})
    if exact and not (first == k + 1).all():
        raise AssertionError(f"{phase}: fp32 self-speculation's first step "
                             f"emitted {first.tolist()}, not {k + 1}")
    del dec, selfd
    if device.type == "cuda":
        free_card()

    # (b) EAGLE: one decoder layer at the target's width plus fc (2H, H);
    # the embeddings and the lm head are the target's tensors
    dspec = dataclasses.replace(target.spec, num_layers=1, medusa_heads=0)
    dparams = speculation.init_eagle_draft_params(dspec, 1, device)
    dparams["embed"] = target.params["embed"]
    dparams["lm_head"] = target.params["lm_head"]
    if device.type == "cuda":
        free_card()
    dcache = kv_cache.init_cache(kv_cache.KVCacheSpec(
        num_layers=1, batch_size=len(SPEC22["lens"]),
        max_seq_len=SPEC22["seq_len"], num_kv_heads=dspec.num_kv_heads,
        head_dim=dspec.head_dim, dtype=dspec.kv_dtype), device)
    dec = speculation.EagleDecoder(target, dspec, dparams, dcache)
    out, launches, steps, _ = spec_run(
        phase + "_eagle", dec, ids, mask, (target,), new, k, exact, ref,
        prompts)
    if timings:
        entries.append(b2_entry(phase + "_eagle_draft", device, dcache,
                                mask.sum(axis=1) + new - 2, dspec,
                                launches))
    dec = speculation.EagleTreeDecoder(
        target, dspec, dparams, dcache, depth=SPEC22["depth"],
        branch_k=SPEC22["branch"], num_nodes=SPEC22["nodes"])
    spec_run(phase + "_eagle_tree", dec, ids, mask, (target,), new,
             SPEC22["depth"], exact, ref, prompts)
    del dec

    # (c) Medusa: 4 heads on the target's features; every step is a T > 1
    # verify, so the decode kernel launches 0 times
    for name, dec in (
            ("medusa", speculation.MedusaDecoder(target)),
            ("medusa_tree", speculation.MedusaTreeDecoder(target)),
            ("dynamic_tree", speculation.DynamicTreeDecoder(
                target, branch_k=SPEC22["branch"],
                num_nodes=SPEC22["nodes"]))):
        spec_run(phase + "_" + name, dec, ids, mask, (target,), new, 0,
                 exact, ref, prompts)
    del dec, ref
    return entries, target, dspec, dparams


def spec_serving(device, hf, dtype, phase, target, dspec, dparams):
    """(d): the target's weights in a paged app (batch 8, block 32,
    prefix caching) under ``ServingEngine(PagedEngineAdapter(app,
    ragged=True, prefill_chunk_tokens=512, speculation=P))`` for P =
    ``MedusaProposer(4)`` and ``EagleProposer(draft, 4)``: phase 9's
    eight requests and schedule, 32 new tokens. Gates: at most one ragged
    dispatch and one blocking fetch a pass, the paged kernel launched 32
    x the width-1 all-decode passes, full streams; bf16: the streams held
    to ``generate`` (``served_vs_generate``); fp32: equal to the ragged
    engine's without speculation (a first difference only at a near-tie
    of ``generate``'s logits)."""
    import dataclasses

    import numpy as np
    import torch
    from neuronx_distributed_inference_tpu_torch.config import \
        ChunkedPrefillConfig
    from neuronx_distributed_inference_tpu_torch.serving import \
        PagedEngineAdapter
    from neuronx_distributed_inference_tpu_torch.serving.engine import \
        ServingEngine
    from neuronx_distributed_inference_tpu_torch.serving.speculation import (
        EagleProposer, MedusaProposer)
    cfg = RAGGED
    exact = dtype == "float32"
    layers = hf["num_hidden_layers"]
    app = make_ragged_app(hf, device, dtype, cfg, output_logits=True,
                          is_chunked_prefill=True,
                          chunked_prefill_config=ChunkedPrefillConfig(
                              kernel_q_tile_size=cfg["chunk"]))
    app.spec = dataclasses.replace(app.spec,
                                   medusa_heads=SPEC22["heads"])
    app.params = target.params
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, hf["vocab_size"], size=n).tolist()
               for n in cfg["lens"]]
    new = SPEC22_SERVE_TOKENS
    sync = torch.cuda.synchronize if device.type == "cuda" else (
        lambda: None)
    ref_streams = None
    if exact:
        eng = ServingEngine(PagedEngineAdapter(
            app, ragged=True, prefill_chunk_tokens=cfg["chunk"]))
        streams, _, _ = serve_schedule(eng, prompts, new, sync)
        ref_streams = [list(s.tokens) for s in streams]
        app.release()
    for name, prop in (("medusa", MedusaProposer(SPEC22["heads"])),
                       ("eagle", EagleProposer(dspec, dparams,
                                               SPEC22["k"]))):
        # a cold cache: the last run's references left the prompts'
        # blocks in the prefix cache
        app.init_cache()
        eng = ServingEngine(PagedEngineAdapter(
            app, ragged=True, prefill_chunk_tokens=cfg["chunk"],
            speculation=prop))
        ad = eng.adapter
        reset_launches([app])
        streams, recs, ttft = serve_schedule(eng, prompts, new, sync)
        launches = kernel_counts([app])["paged_decode_attention"]
        check_ragged_passes(phase + "_" + name, recs, launches, layers)
        width1 = 0
        for r in recs:
            d = r["delta"]
            rows = (d["ragged_rows_decode"] + d["ragged_rows_verify"]
                    + d["ragged_rows_prefill"])
            if d["ragged_dispatches"] == 1 and d["ragged_rows_prefill"] == 0:
                pad_to = rows + d["ragged_pad_rows"]
                if d["ragged_padded_tokens"] == pad_to:
                    width1 += 1
                    r["kind"] = "decode_w1"
        st = ad.host_stats
        want = layers * width1 if device.type == "cuda" else 0
        emit({"phase": phase + "_" + name, "requests": len(prompts),
              "new_tokens": new, "passes": len(recs),
              "passes_by_kind": {k: sum(1 for r in recs if r["kind"] == k)
                                 for k in ("mixed", "decode", "decode_w1",
                                           "idle")},
              "launches": launches, "expected_launches": want,
              "accept_rate": st["spec_accepted_tokens"]
              / max(st["spec_drafted_tokens"], 1),
              "spec_drafted_tokens": st["spec_drafted_tokens"],
              "spec_accepted_tokens": st["spec_accepted_tokens"],
              "host_ms": {k: pass_summary(recs, k)
                          for k in ("mixed", "decode", "decode_w1")},
              "ttft_s": [ttft.get(i) for i in range(len(prompts))],
              "host_stats": {k: v for k, v in st.items()
                             if isinstance(v, int)}})
        if launches != want:
            raise AssertionError(f"{phase}_{name}: paged kernel launches "
                                 f"{launches} != {want} ({layers} x "
                                 f"{width1} width-1 all-decode passes)")
        check_streams(phase + "_" + name, streams, new, hf["vocab_size"])
        got = [list(s.tokens) for s in streams]
        app.release()
        if exact:
            check_equal_streams(phase + "_" + name + "_vs_plain", got,
                                ref_streams, paged_logit_at(
                                    app, prompts, ref_streams, cfg["chunk"]))
        else:
            served_vs_generate(phase + "_" + name, cfg["chunk"])(
                app, prompts, streams)
        del eng, ad, prop
    del app


def paged_logit_at(app, prompts, want, chunk):
    """``logit_at`` for :func:`check_equal_streams` over the paged app:
    its ``generate`` of request ``i`` (a cold prefix, fed ``want[i]``'s
    first ``j`` tokens), the logits of step ``j`` (step 0: the last
    prompt position, within the prefill's last chunk)."""
    import numpy as np

    def at(i, j):
        n = len(prompts[i])
        kw = ({} if j == 0 else
              {"teacher_tokens": np.asarray([want[i][:j]])})
        with cold_prefix(app):
            lg = app.generate(np.asarray([prompts[i]]), max_new_tokens=j + 1,
                              return_logits=True, **kw)["logits"]
            app.release()
        last = ((n - 1) // chunk) * chunk if n > chunk else 0
        row = lg[0][0, n - 1 - last] if j == 0 else lg[j][0, 0]
        return np.asarray(row)[:app.spec.vocab_size]
    return at


def phase_speculation(device):
    """Phase 22: (a)-(d) in bf16 at Llama-3.1-8B's full width, cut to
    LLAMA_CUT layers (the draft Llama-3.2-1B at full depth), then (e) the
    fp32 cuts (TF32 off) at 4
    layers. Returns the kernels-line entries (the contiguous decode kernel
    at the draft shapes)."""
    if device.type == "cuda":
        check_card_empty("speculation")
    hf = dict(LLAMA_3_1_8B, num_hidden_layers=LLAMA_CUT)
    entries, target, dspec, dparams = spec_decoders(
        device, hf, LLAMA_3_2_1B, "bfloat16", "spec22",
        device.type == "cuda")
    spec_serving(device, hf, "bfloat16", "spec22_serve", target,
                 dspec, dparams)
    del target, dparams
    if device.type == "cuda":
        memory_note("spec22")
        free_card()
    with fp32_exact():
        cut = dict(LLAMA_3_1_8B, num_hidden_layers=SPEC22_CHECK_LAYERS)
        _, target, dspec, dparams = spec_decoders(
            device, cut, dict(LLAMA_3_2_1B,
                              num_hidden_layers=SPEC22_CHECK_LAYERS),
            "float32", "spec22_fp32", False)
        spec_serving(device, cut, "float32", "spec22_fp32_serve", target,
                     dspec, dparams)
    del target, dparams
    if device.type == "cuda":
        free_card()
    return entries


# ---------------------------------------------------------------------------
# Phase 23: multi-LoRA serving
# ---------------------------------------------------------------------------

LORA_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                "up_proj", "down_proj")
# four slots (slot 0, the zero adapter, and three usable), rank 16, five
# registered adapters of random factors N(0, scale) from seeds 100-104
LORA23 = dict(max_loras=4, rank=16, adapters=5, scale=0.07)
# the adapters of RAGGED's 8 requests: l0 twice, l1-l4 once, two base rows.
# The first four, submitted together, name four adapters over three
# slots: the engine admits three (restoring l0 and l1, which the logit
# shift check left spilled, and evicting and spilling the residents) and
# requeues l3 until a slot is released; base rows and resident adapters
# submitted meanwhile are admitted at once
LORA_ROWS = ("l0", "l1", "l2", "l3", None, "l4", None, "l0")
LORA_SWAP_LENS = (200, 700)      # 23 (c): fresh prompts (no prefix hit)
LORA_SWAP_TOKENS = 24
LORA_SHIFT_MIN = 1.0             # an adapter moves the logits >= 1 std
LORA_CHECK_LAYERS = 4
LORA_CHECK_TOKENS = 24


def lora_config():
    from neuronx_distributed_inference_tpu_torch.config import \
        LoraServingConfig
    return LoraServingConfig(max_loras=LORA23["max_loras"],
                             max_lora_rank=LORA23["rank"],
                             target_modules=list(LORA_TARGETS))


def lora_arrays(app, seed, dtype):
    """One adapter in the ``lora_adapter_arrays`` layout ({module: (A (L,
    in, r), B (L, r, out))}), N(0, LORA23["scale"]) factors drawn on the
    host from ``seed``, in ``dtype``."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    lw = app.params["layers"]
    out = {}
    for mod in LORA_TARGETS:
        L, _, d_in, r = lw[f"lora_A_{mod}"].shape
        d_out = lw[f"lora_B_{mod}"].shape[3]
        out[mod] = tuple(
            (torch.randn(shape, generator=gen) * LORA23["scale"]).to(dtype)
            for shape in ((L, d_in, r), (L, r, d_out)))
    return out


def lora_pool(app, dtype):
    """The pool over ``app`` with adapters l0-l4 registered (seeds
    100-104), a host cache that holds all of them."""
    from neuronx_distributed_inference_tpu_torch.serving import \
        LoraAdapterPool
    pool = LoraAdapterPool(app, host_cache_adapters=LORA23["adapters"])
    for i in range(LORA23["adapters"]):
        pool.register_arrays(f"l{i}", lora_arrays(app, 100 + i, dtype))
    return pool


def lora_engine(app, pool, cfg):
    from neuronx_distributed_inference_tpu_torch.serving import \
        PagedEngineAdapter
    from neuronx_distributed_inference_tpu_torch.serving.engine import \
        ServingEngine
    return ServingEngine(PagedEngineAdapter(
        app, ragged=True, prefill_chunk_tokens=cfg["chunk"],
        lora_pool=pool))


def without_lora(params):
    """The parameter dict without its LoRA leaves (the same tensors)."""
    return {k: ({n: t for n, t in v.items() if not n.startswith("lora_")}
                if isinstance(v, dict) else v) for k, v in params.items()}


def other_adapter(name):
    """The control's adapter for a request: the next one (base rows l0)."""
    if name is None:
        return "l0"
    return f"l{(int(name[1:]) + 1) % LORA23['adapters']}"


def lora_groups(names, n_slots, rows):
    """Request indices in groups of at most ``rows`` requests naming at
    most ``n_slots`` adapters (they fit the pool at once)."""
    groups, cur, used = [], [], set()
    for i, n in enumerate(names):
        more = used | ({n} if n else set())
        if cur and (len(cur) == rows or len(more) > n_slots):
            groups.append(cur)
            cur, more = [], ({n} if n else set())
        cur.append(i)
        used = more
    return groups + ([cur] if cur else [])


def lora_scored(twin, pool, prompts, streams, names):
    """``teacher_deficits`` of each stream on the contiguous ``twin`` (it
    shares the served app's tensors, LoRA slots included) under the
    adapter ``names[i]`` (None: slot 0), the pool pinning each group's
    adapters while it is scored."""
    per = [None] * len(prompts)
    for group in lora_groups(names, pool.n_slots,
                             twin.tpu_config.batch_size):
        distinct = sorted({names[i] for i in group if names[i]})
        slots = {n: pool.acquire(n) for n in distinct}
        try:
            sub = teacher_deficits(
                twin, [prompts[i] for i in group],
                [streams[i] for i in group],
                adapter_ids=[slots.get(names[i], 0) for i in group])
        finally:
            for n in distinct:
                pool.release(n)
        for i, x in zip(group, sub):
            per[i] = x
    return per


def lora_control_fails(phase, per):
    """The control (each stream scored under another adapter) must fail
    the deficit gate."""
    return control_fails(phase, per, "under other adapters")


def control_fails(phase, per, what):
    """A control's streams (scored by :func:`teacher_deficits`) must fail
    the deficit gate; ``what`` names the control."""
    import numpy as np
    d = np.concatenate([x[0] for x in per])
    rep = {"phase": phase + "_control", "tokens": int(d.size),
           "max_deficit": float(d.max()), "mean_deficit": float(d.mean()),
           "bound": TOL_SERVED_DEFICIT_BF16,
           "mean_bound": TOL_SERVED_MEAN_DEFICIT_BF16}
    emit(rep)
    if (d.max() <= TOL_SERVED_DEFICIT_BF16
            and d.mean() <= TOL_SERVED_MEAN_DEFICIT_BF16):
        raise AssertionError(f"{phase}: the streams pass the gate {what} "
                             "too")
    return rep


def lora_logit_shift(phase, twin, pool, prompt):
    """How far each adapter moves the last prompt position's logits: the
    RMS of (adapter - base) over the base logits' std, each adapter in
    its own row of one prefill beside a base row; gated at
    LORA_SHIFT_MIN."""
    import dataclasses

    import numpy as np
    import torch
    from neuronx_distributed_inference_tpu_torch.models import model_base
    names = [f"l{i}" for i in range(LORA23["adapters"])]
    cfg = dataclasses.replace(twin.tpu_config, output_logits=False)
    rows = twin.tpu_config.batch_size
    dev = twin.device
    vocab = twin.spec.vocab_size
    ids = torch.as_tensor(np.tile(np.asarray(prompt, np.int32), (rows, 1)),
                          device=dev)
    pos = torch.arange(len(prompt), dtype=torch.int32,
                       device=dev)[None].expand(rows, -1)
    shifts = {}
    for lo in range(0, len(names), pool.n_slots):
        group = names[lo:lo + pool.n_slots]
        slots = [pool.acquire(n) for n in group]
        try:
            aids = np.zeros((rows,), np.int32)
            aids[1:1 + len(slots)] = slots
            twin.reset()
            pre = model_base.context_encoding_step(
                twin.spec, cfg, twin.params, twin.cache, ids, pos,
                torch.arange(rows, dtype=torch.int32, device=dev),
                torch.full((rows,), len(prompt), dtype=torch.int32,
                           device=dev), None, twin.generator,
                twin._inv_freq, torch.as_tensor(aids, device=dev))
            lg = model_base._lm_head(twin.spec, twin.params,
                                     pre["last_hidden"][:, None])[
                :, 0, :vocab].double()
        finally:
            for n in group:
                pool.release(n)
        std = float(lg[0].std())
        for j, n in enumerate(group):
            shifts[n] = float((lg[1 + j] - lg[0]).pow(2).mean().sqrt()) / std
    twin.reset()
    emit({"phase": phase + "_logit_shift", "scale": LORA23["scale"],
          "rank": LORA23["rank"], "targets": list(LORA_TARGETS),
          "shift_in_logit_stds": shifts, "bound": LORA_SHIFT_MIN})
    if not min(shifts.values()) >= LORA_SHIFT_MIN:
        raise AssertionError(f"{phase}: an adapter moves the logits by "
                             f"{min(shifts.values())} stds only")
    return shifts


def lora_replays(app):
    """(replays of the LoRA ragged W = 1 graphs, of the LoRA-free ones):
    the signature's last element says whether the step carried ids."""
    lora = base = 0
    for (kind, bucket, sig), n in app.graphs.replays.items():
        if kind == "ragged" and bucket == 1:
            if sig[-1]:
                lora += n
            else:
                base += n
    return lora, base


def pass_profile(on_card, decode=8, mixed=4):
    """The passes :func:`serve_schedule` traces: ``decode`` all-decode
    passes from pass 24 on and ``mixed`` mixed ones from pass 8 on (none
    off the card)."""
    traced = {"mixed": 0, "decode": 0}

    def profile(p, expect_mixed):
        kind, cap, start = (("mixed", mixed, 8) if expect_mixed
                            else ("decode", decode, 24))
        if not on_card or p < start or traced[kind] >= cap:
            return False
        traced[kind] += 1
        return True
    return profile


def phase_lora(device, on_card=True):
    """Phase 23 (a)-(c), (e): multi-LoRA serving at Llama-3.1-8B width,
    cut to LLAMA_CUT layers, bf16. Returns the paged kernel's entries."""
    import numpy as np
    import torch
    phase = "lora_serving"
    hf, cfg = dict(LLAMA_3_1_8B, num_hidden_layers=LLAMA_CUT), RAGGED
    layers = hf["num_hidden_layers"]
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    app = make_ragged_app(hf, device, "bfloat16", cfg,
                          lora_config=lora_config())
    init_weights(app, 0)
    pool = lora_pool(app, torch.bfloat16)
    twin = make_contiguous_app(hf, device, "bfloat16", batch=8,
                               seq_len=cfg["seq_len"], output_logits=True,
                               lora_config=lora_config())
    twin.params = app.params
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, hf["vocab_size"], size=n).tolist()
               for n in cfg["lens"]]
    shifts = lora_logit_shift(phase, twin, pool, prompts[1])
    warm(app, phase, chunk_tokens=cfg["chunk"])
    n_graphs = len(app.graphs) if app.graphs is not None else 0
    stats0 = dict(pool.stats)
    eng = lora_engine(app, pool, cfg)
    ad = eng.adapter
    snap = {}
    adapter_live = []       # per pass: a live row gathers an adapter

    def snapshot():
        adapter_live.append(any(ad._lora_slots.get(s) for s in ad.seqs))
        # the served cache's decode shapes: the last all-decode state with
        # the most live rows (capacity stalls keep some rows queued)
        if (not ad.seqs or ad.pending_prefill_ids
                or len(ad.seqs) < len(snap.get("pos", ()))):
            return
        live = sorted(ad.seqs)
        snap["table"] = app.kv_mgr.block_table_array(
            live, app._bt_width_for(live))
        snap["pos"] = [ad.seqs[s].position for s in live]
    reset_launches([app])
    # (a), (b): the mixed-adapter schedule
    streams, recs, ttft = serve_schedule(eng, prompts, RAGGED_TOKENS, sync,
                                         pass_profile(on_card), snapshot,
                                         adapters=LORA_ROWS)
    launches = kernel_counts([app])["paged_decode_attention"]
    decode_steps, want = check_ragged_passes(phase, recs, launches, layers)
    want = want if on_card else 0
    lora_g, base_g = (lora_replays(app) if app.graphs is not None
                      else (0, 0))
    # an all-decode pass of base rows only runs the LoRA-free graph
    base_steps = sum(1 for r in recs
                     if r["kind"] == "decode" and not adapter_live[r["pass"]])
    served_stats = {k: pool.stats[k] - stats0.get(k, 0)
                    for k in pool.stats}
    st = ad.host_stats
    emit({"phase": phase, "layers": layers, "requests": len(prompts),
          "adapters": list(LORA_ROWS), "new_tokens": RAGGED_TOKENS,
          "passes": len(recs),
          "passes_by_kind": {k: sum(1 for r in recs if r["kind"] == k)
                             for k in ("mixed", "decode", "idle")},
          "launches": launches, "expected_launches": want,
          "lora_graph_replays": lora_g, "lora_free_graph_replays": base_g,
          "base_only_decode_passes": base_steps,
          "graphs_after_warmup": n_graphs,
          "graphs_after_serving": len(app.graphs) if app.graphs else 0,
          "host_ms_mixed": pass_summary(recs, "mixed"),
          "host_ms_decode": pass_summary(recs, "decode"),
          "ttft_s": [ttft.get(i) for i in range(len(prompts))],
          "admission_retries": eng.stats["admission_retries"],
          "pool": served_stats,
          "swap_ms_mean": (1e3 * served_stats["swap_s"]
                           / max(served_stats["swaps"], 1)),
          "swap_bytes_mean": (served_stats["swap_bytes"]
                              / max(served_stats["swaps"], 1)),
          "host_stats": {k: v for k, v in st.items()
                         if isinstance(v, int)}})
    emit({"phase": phase + "_profile_decode",
          **profile_summary(recs, "decode")})
    emit({"phase": phase + "_profile_mixed",
          **profile_summary(recs, "mixed")})
    check_no_incidents(phase, app)
    if launches != want:
        raise AssertionError(f"{phase}: paged kernel launches {launches} "
                             f"!= {layers} x {decode_steps}")
    if on_card and (lora_g != decode_steps - base_steps
                    or base_g != base_steps
                    or len(app.graphs) != n_graphs):
        raise AssertionError(
            f"{phase}: {decode_steps} all-decode passes ({base_steps} of "
            f"base rows only), {lora_g} LoRA graph replays, {base_g} "
            f"LoRA-free ones, graphs {n_graphs} -> {len(app.graphs)}")
    if eng.stats["admission_retries"] < 1:
        raise AssertionError(f"{phase}: four adapters over three slots "
                             "never waited for a slot")
    check_streams(phase, streams, RAGGED_TOKENS, hf["vocab_size"])
    if not (served_stats["evictions"] and served_stats["spills"]
            and served_stats["restores"]):
        raise AssertionError(f"{phase}: the pool never evicted, spilled "
                             f"and restored: {served_stats}")
    toks = [s.tokens for s in streams]
    per = lora_scored(twin, pool, prompts, toks, LORA_ROWS)
    deficit_gate(phase, per, exact=False)
    lora_control_fails(phase, lora_scored(
        twin, pool, prompts, toks, [other_adapter(n) for n in LORA_ROWS]))
    entries = []
    if on_card:
        t = time_paged_kernel(app, snap["table"], snap["pos"], device,
                              seed=9)
        emit({"phase": phase + "_kernel_timings", **t["report"],
              "launches": launches})
        entries.append(paged_kernel_entry(t, launches, phase))
    # (c): a swap under the captured graphs
    phase_lora_swap(app, pool, twin, cfg, sync, on_card)
    # (e): the same schedule on the LoRA build with every row under l0
    # (the deltas on every pass, no capacity stall) and with base rows
    # only (every pass the LoRA-free step: the graphs a LoRA-free build
    # captures; (d) holds its streams to such a build in fp32), every
    # prompt computed in both (a cold prefix), so the two time the same
    # work
    base_runs = {}
    for name, names in (("one_adapter", ["l0"] * len(prompts)),
                        ("base_rows", None)):
        e = lora_engine(app, pool, cfg)
        reset_launches([app])
        with cold_prefix(app):
            s2, r2, t2 = serve_schedule(e, prompts, RAGGED_TOKENS, sync,
                                        pass_profile(on_card),
                                        adapters=names)
        check_streams(phase + "_" + name, s2, RAGGED_TOKENS,
                      hf["vocab_size"])
        steps = sum(1 for r in r2 if r["kind"] == "decode")
        replays = lora_replays(app) if app.graphs is not None else (0, 0)
        want_replays = (steps, 0) if names else (0, steps)
        if on_card and replays != want_replays:
            raise AssertionError(
                f"{phase}_{name}: (LoRA, LoRA-free) graph replays "
                f"{replays} over {steps} all-decode passes")
        prof = profile_summary(r2, "decode")
        host = pass_summary(r2, "decode")
        base_runs[name] = {
            "host_ms_mixed": pass_summary(r2, "mixed"),
            "host_ms_decode": host,
            "profile_decode": prof,
            "profile_mixed": profile_summary(r2, "mixed"),
            # the device's idle share against the untraced host clock
            # (the traced passes also carry the profiler's host cost)
            "decode_idle_share_untraced": (
                1 - prof["device_busy_ms_per_pass"] / host["median_ms"]
                if prof.get("measured") and host["median_ms"] else None),
            "graph_replays_lora_free": list(replays),
            "ttft_s": [t2.get(i) for i in range(len(prompts))]}
    delta = {}
    for kind in ("decode", "mixed"):
        a = base_runs["one_adapter"]["profile_" + kind]
        b = base_runs["base_rows"]["profile_" + kind]
        if a.get("measured") and b.get("measured"):
            delta[kind] = (a["device_busy_ms_per_pass"]
                           - b["device_busy_ms_per_pass"])
    emit({"phase": phase + "_base_rows", **base_runs,
          "lora_device_ms_per_pass": delta, "requests": len(prompts),
          "logit_shift_in_stds": shifts})
    if on_card:
        memory_note(phase)
    del twin
    return entries


def phase_lora_swap(app, pool, twin, cfg, sync, on_card):
    """23 (c): between passes the slot of a resident adapter X is written
    in place with new factors Y (a hot update of X); two fresh requests
    tagged X then hit the pool (no swap) and replay the captured LoRA
    graph, which must serve Y: their streams pass the deficit gate under
    Y and fail it under X (the control, X written back)."""
    import numpy as np
    import torch
    phase = "lora_swap"
    x = next(n for n, slot in sorted(pool._slots.items())
             if pool.pins(n) == 0)
    s = pool.slot_of(x)
    x_arrays = pool._slot_arrays(s)
    y_arrays = lora_arrays(app, 200, torch.bfloat16)
    nbytes = sum(a.numel() * a.element_size() + b.numel() * b.element_size()
                 for a, b in y_arrays.values())
    t0 = time.perf_counter()
    app.write_lora_slot(s, y_arrays)
    sync()
    swap_s = time.perf_counter() - t0
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, app.spec.vocab_size, size=n).tolist()
               for n in LORA_SWAP_LENS]
    n_graphs = len(app.graphs) if app.graphs is not None else 0
    stats0 = dict(pool.stats)
    reset_launches([app])
    eng = lora_engine(app, pool, cfg)
    streams, recs, _ = serve_schedule(eng, prompts, LORA_SWAP_TOKENS, sync,
                                      adapters=[x] * len(prompts))
    launches = kernel_counts([app])["paged_decode_attention"]
    decode_steps, want = check_ragged_passes(phase, recs, launches,
                                             app.spec.num_layers)
    check_streams(phase, streams, LORA_SWAP_TOKENS, app.spec.vocab_size)
    replays, _ = lora_replays(app) if app.graphs is not None else (0, 0)
    toks = [st.tokens for st in streams]
    per = lora_scored(twin, pool, prompts, toks, [x] * len(prompts))
    app.write_lora_slot(s, x_arrays)
    ctl = lora_scored(twin, pool, prompts, toks, [x] * len(prompts))
    emit({"phase": phase, "adapter": x, "slot": s, "swap_s": swap_s,
          "swap_bytes": nbytes, "passes": len(recs),
          "all_decode_passes": decode_steps,
          "lora_graph_replays": replays,
          "pool_misses": pool.stats["misses"] - stats0["misses"],
          "launches": launches,
          "expected_launches": want if on_card else 0})
    if on_card and (replays != decode_steps or not decode_steps
                    or len(app.graphs) != n_graphs
                    or launches != want):
        raise AssertionError(f"{phase}: {decode_steps} all-decode passes, "
                             f"{replays} LoRA graph replays, "
                             f"launches {launches} != {want}")
    if pool.stats["misses"] != stats0["misses"]:
        raise AssertionError(f"{phase}: the requests missed the pool")
    deficit_gate(phase, per, exact=False)
    lora_control_fails(phase, ctl)


def phase_lora_fp32(device, on_card=True):
    with fp32_exact():
        return _phase_lora_fp32(device, on_card)


def _phase_lora_fp32(device, on_card):
    """23 (d): fp32 (TF32 off) at 4 layers: the mixed-adapter schedule's
    streams equal each request's single-adapter ``generate`` (a first
    difference only at a near-tie); base rows of the LoRA build equal a
    LoRA-free build's; a failed swap leaves every slot's factors as they
    were; the contiguous app's ``generate(adapter_ids=)`` (flash and the
    contiguous decode kernel, launches exact) equals them too."""
    import numpy as np
    import torch
    from neuronx_distributed_inference_tpu_torch.resilience import (
        FAULTS, StepFailure)
    phase = "lora_fp32"
    hf = dict(LLAMA_3_1_8B, num_hidden_layers=LORA_CHECK_LAYERS)
    cfg, n = RAGGED, LORA_CHECK_TOKENS
    layers = hf["num_hidden_layers"]
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    app = make_ragged_app(hf, device, "float32", cfg,
                          lora_config=lora_config())
    init_weights(app, 0)
    pool = lora_pool(app, torch.float32)
    warm(app, phase, chunk_tokens=cfg["chunk"])
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, hf["vocab_size"], size=k).tolist()
               for k in cfg["lens"]]
    reset_launches([app])
    streams, recs, _ = serve_schedule(lora_engine(app, pool, cfg), prompts,
                                      n, sync, adapters=LORA_ROWS)
    launches = kernel_counts([app])["paged_decode_attention"]
    decode_steps, want = check_ragged_passes(phase, recs, launches, layers)
    want = want if on_card else 0
    check_streams(phase, streams, n, hf["vocab_size"])
    if launches != want:
        raise AssertionError(f"{phase}: paged kernel launches {launches} "
                             f"!= {want}")
    check_no_incidents(phase, app)
    served = [np.asarray(st.tokens) for st in streams]
    ref = make_ragged_app(hf, device, "float32", cfg, batch=1,
                          output_logits=True, lora_config=lora_config())
    ref.params = app.params

    def want_of(i, name):
        # the reference computes every prompt afresh (a cold prefix: ref
        # shares the served app's factors, but not its record of slot
        # writes that keys the prefix cache)
        slot = pool.acquire(name) if name else 0
        try:
            with cold_prefix(ref):
                w = ref.generate(np.asarray([prompts[i]]), max_new_tokens=n,
                                 return_logits=True,
                                 adapter_ids=np.asarray([slot]))
        finally:
            if name:
                pool.release(name)
        ref.reset()
        return w
    wants, ties = [], []
    for i, prompt in enumerate(prompts):
        w = want_of(i, LORA_ROWS[i])
        wants.append(w)
        case = near_tie_check(phase + "_near_tie", i, served[i], w,
                              len(prompt))
        if case:
            ties.append(case)
    # the prefix cache keyed by adapter: the same prompts served again,
    # each under another adapter (base rows under l0), with the prefix
    # cache on, compute every prompt token (no block written under
    # another adapter is served) and equal their own generate
    eng = lora_engine(app, pool, cfg)
    before = dict(eng.adapter.host_stats)
    others = [other_adapter(x) for x in LORA_ROWS]
    again, _, _ = serve_schedule(eng, prompts, n, sync, adapters=others)
    computed = (eng.adapter.host_stats["prefill_real_tokens"]
                - before["prefill_real_tokens"])
    check_streams(phase + "_other_adapters", again, n, hf["vocab_size"])
    other_ties = []
    for i, st in enumerate(again):
        case = near_tie_check(phase + "_other_adapters_near_tie", i,
                              np.asarray(st.tokens), want_of(i, others[i]),
                              len(prompts[i]))
        if case:
            other_ties.append(case)
    if computed != sum(len(p) for p in prompts):
        raise AssertionError(f"{phase}: under other adapters the engine "
                             f"computed {computed} of "
                             f"{sum(len(p) for p in prompts)} prompt tokens")
    del ref
    # base rows: the LoRA build against a LoRA-free build of the same
    # weights, bit for bit, every prompt computed in both (a cold prefix)
    with cold_prefix(app):
        base_l, _, _ = serve_schedule(lora_engine(app, pool, cfg), prompts,
                                      n, sync)
    plain = make_ragged_app(hf, device, "float32", cfg)
    plain.params = without_lora(app.params)
    base_f, _, _ = serve_schedule(ragged_engine(plain, True, cfg), prompts,
                                  n, sync)
    del plain
    if [s.tokens for s in base_l] != [s.tokens for s in base_f]:
        raise AssertionError(f"{phase}: base rows of the LoRA build differ "
                             "from the LoRA-free build")
    # a failed swap (the fault point, then a write that fails half-way)
    # leaves every slot's factors as they were
    lw = app.params["layers"]
    before = {k: v.clone() for k, v in lw.items() if k.startswith("lora_")}
    cold = next(f"l{i}" for i in range(LORA23["adapters"])
                if not pool.resident(f"l{i}"))
    failures = 0
    with FAULTS.inject("adapter_swap", nth=1, times=1):
        try:
            pool.acquire(cold)
        except StepFailure:
            failures += 1
    write = app.write_lora_slot

    def half(slot, arrays):
        write(slot, dict(list(arrays.items())[:3]))
        raise RuntimeError("the device write failed half-way")
    app.write_lora_slot = half
    try:
        pool.acquire(cold)
    except StepFailure:
        failures += 1
    finally:
        del app.write_lora_slot
    unchanged = all(torch.equal(lw[k], v) for k, v in before.items())
    if failures != 2 or not unchanged or pool.resident(cold):
        raise AssertionError(f"{phase}: failed swaps {failures}, factors "
                             f"unchanged {unchanged}")
    # the contiguous app under the same slots: flash prefill at the
    # 128-multiple bucket, the contiguous decode kernel on every step
    capp = make_contiguous_app(hf, device, "float32", batch=4,
                               seq_len=cfg["seq_len"],
                               lora_config=lora_config())
    capp.params = app.params
    ids0, mask0 = prompts_of([len(p) for p in prompts[:4]],
                             hf["vocab_size"], 0)
    capp.generate(ids0, attention_mask=mask0, max_new_tokens=3,
                  adapter_ids=np.zeros((4,), np.int32))   # captures
    capp.reset()
    reset_launches([capp])
    contiguous_ties = []
    calls = 0
    for group in lora_groups(LORA_ROWS, pool.n_slots, 4):
        # groups of at most three adapters, padded to the batch of 4 with
        # copies of their last row
        rows = tuple(group) + (group[-1],) * (4 - len(group))
        names = [LORA_ROWS[i] for i in rows]
        distinct = sorted({x for x in names if x})
        slots = {x: pool.acquire(x) for x in distinct}
        width = max(len(prompts[i]) for i in rows)
        ids = np.zeros((4, width), np.int64)
        mask = np.zeros((4, width), np.int64)
        for r, i in enumerate(rows):
            ids[r, :len(prompts[i])] = prompts[i]
            mask[r, :len(prompts[i])] = 1
        try:
            out = capp.generate(ids, attention_mask=mask, max_new_tokens=n,
                                adapter_ids=np.asarray(
                                    [slots.get(x, 0) for x in names]))
        finally:
            for x in distinct:
                pool.release(x)
        capp.reset()
        calls += 1
        for r, i in enumerate(group):
            case = near_tie_check(phase + "_contiguous_near_tie", i,
                                  out["generated"][r], wants[i],
                                  len(prompts[i]))
            if case:
                contiguous_ties.append(case)
    counts = kernel_counts([capp])
    want_counts = {"flash_attention": layers * calls if on_card else 0,
                   "decode_attention_stacked":
                       layers * (n - 1) * calls if on_card else 0}
    emit({"phase": phase, "layers": layers, "requests": len(prompts),
          "adapters": list(LORA_ROWS), "new_tokens": n,
          "passes": len(recs), "launches": launches,
          "expected_launches": want, "near_ties": ties,
          "streams_identical_to_generate": len(prompts) - len(ties),
          "other_adapters": list(others),
          "other_adapters_prompt_tokens_computed": computed,
          "other_adapters_near_ties": other_ties,
          "base_rows_equal_lora_free": True, "failed_swaps": failures,
          "contiguous_launches": counts, "contiguous_expected": want_counts,
          "contiguous_near_ties": contiguous_ties,
          "contiguous_identical_to_generate":
              len(prompts) - len(contiguous_ties)})
    if any(counts[k] != v for k, v in want_counts.items()):
        raise AssertionError(f"{phase}: contiguous launches {counts} != "
                             f"{want_counts}")
    if on_card:
        memory_note(phase)


def phase_lora_group(device):
    """The ``lora`` group: phase 23 (a)-(e)."""
    import torch
    entries = phase_lora(device)
    free_card()
    phase_lora_fp32(device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return entries


# ---------------------------------------------------------------------------
# Phase 24: the KV cache's host tier on phase 9's engine
# ---------------------------------------------------------------------------

# 24 (a): a block of phase 9's pool is 4 MiB (32 layers x 32 slots x 8
#   heads x 128 x 2 bytes x K and V); the tier's bound of 1024 blocks (4
#   GiB of host RAM) holds the 168 full blocks of phase 9's prompts and
#   the cold blocks the restore pass evicts in turn. Cold prompts of 1900
#   tokens (8 new) push every full block of the first pass out of the
#   pool's LRU (about 33k tokens at phase 9's 1031 usable blocks).
# 24 (b): four requests handed off to a decode app of batch 4.
TIER24 = dict(max_blocks=1024, cold_len=1900, cold_tokens=8, new_tokens=16,
              handoff_lens=(300, 700, 1300, 1900), handoff_tokens=32,
              decode_batch=4)
TIER_CHECK_LAYERS = 4                  # 24 (d): the fp32 and fp8 cuts
TIER_CHECK_TOKENS = 16


class TierProbe:
    """Wraps a tier adapter's spill hook and restore write: host ms per
    spill (its device-to-host read syncs the host) and per restore call
    (synchronized before the clock stops), and every restored block read
    back against its payload bit for bit, off the clock (``check_s``)."""

    def __init__(self, ad, sync):
        import torch
        self.spill_ms, self.restore_ms, self.bad = [], [], []
        self.blocks, self.check_s = 0, 0.0
        spill, apply = ad._spill_block, ad._apply_block_payloads

        def spill_block(blk, h):
            n = ad.host_stats["kv_spilled_blocks"]
            t0 = time.perf_counter()
            spill(blk, h)
            if ad.host_stats["kv_spilled_blocks"] > n:
                self.spill_ms.append(1e3 * (time.perf_counter() - t0))

        def apply_payloads(restores):
            t0 = time.perf_counter()
            apply(restores)
            sync()
            t1 = time.perf_counter()
            self.restore_ms.append(1e3 * (t1 - t0))
            cache = ad.app.cache
            idx = torch.tensor([b for b, _ in restores],
                               device=cache["k"].device)
            for name in ("k", "v"):
                got = cache[name].index_select(1, idx).cpu()
                want = torch.stack([p[name].view(torch.uint8)
                                    for _, p in restores], dim=1)
                if not torch.equal(got.view(torch.uint8), want):
                    self.bad.append((name, [b for b, _ in restores]))
            self.blocks += len(restores)
            self.check_s += time.perf_counter() - t1
        ad._spill_block = spill_block
        ad._apply_block_payloads = apply_payloads
        ad.app.kv_mgr.allocator.on_evict = spill_block

    def summary(self):
        import statistics as st

        def of(ms):
            return ({"calls": len(ms), "mean_ms": st.fmean(ms),
                     "median_ms": st.median(ms), "max_ms": max(ms)}
                    if ms else {"calls": 0})
        return {"spill": of(self.spill_ms), "restore": of(self.restore_ms),
                "restored_blocks_read_back": self.blocks,
                "read_back_mismatches": len(self.bad),
                "read_back_s": self.check_s}


ALLOC_CALLS = ("allocate", "extend", "free", "invalidate", "probe")


def record_allocator(alloc):
    """Record the outermost calls made to ``alloc`` (a Python
    ``BlockAllocator``): (method, copied arguments), until
    :func:`stop_recording`."""
    trace, depth = [], [0]
    for name in ALLOC_CALLS:
        def wrapped(*args, _fn=getattr(alloc, name), _name=name):
            if depth[0] == 0:
                trace.append((_name, tuple(
                    list(a) if isinstance(a, list) else a for a in args)))
            depth[0] += 1
            try:
                return _fn(*args)
            finally:
                depth[0] -= 1
        setattr(alloc, name, wrapped)
    return trace


def stop_recording(alloc):
    for name in ALLOC_CALLS:
        delattr(alloc, name)


def replay_allocator(phase, trace, num_blocks, block_size):
    """24 (c): the recorded calls through a fresh native and a fresh
    Python allocator: identical results, host us per call by method."""
    import statistics as st
    from neuronx_distributed_inference_tpu_torch.modules.block_kv_cache \
        import BlockAllocator, NativeBlockAllocator
    from neuronx_distributed_inference_tpu_torch.resilience.errors import \
        CapacityError
    outs, times = {}, {}
    for kind, cls in (("native", NativeBlockAllocator),
                      ("python", BlockAllocator)):
        a = cls(num_blocks, block_size)
        res, us = [], {}
        for name, args in trace:
            args = tuple(list(x) if isinstance(x, list) else x
                         for x in args)
            t0 = time.perf_counter()
            try:
                out = getattr(a, name)(*args)
            except CapacityError:
                out = "capacity"
            us.setdefault(name, []).append(
                1e6 * (time.perf_counter() - t0))
            res.append(out)
        outs[kind] = res
        times[kind] = {n: {"calls": len(v), "mean_us": st.fmean(v),
                           "median_us": st.median(v)}
                       for n, v in us.items()}
    same = outs["native"] == outs["python"]
    emit({"phase": phase + "_allocators", "calls": len(trace),
          "identical_results": same, "us_per_call": times})
    if not same:
        raise AssertionError(f"{phase}: the native allocator parts from the "
                             "Python one on the recorded calls")
    return times


def one_column_passes(recs):
    """Passes whose one ragged dispatch was one token wide (decode rows
    and one-token prefill chunks): those run the paged kernel."""
    n = 0
    for r in recs:
        d = r["delta"]
        rows = sum(d[k] for k in ("ragged_rows_decode", "ragged_rows_verify",
                                  "ragged_rows_prefill", "ragged_pad_rows"))
        n += d["ragged_dispatches"] == 1 and d["ragged_padded_tokens"] == rows
    return n


def tier_keys(prompts, block_size):
    """Every full block's tier key of ``prompts`` (base rows: from b"")."""
    from neuronx_distributed_inference_tpu_torch.serving.adapter import \
        tier_chain
    return [tier_chain(p, block_size, b"") for p in prompts]


def restore_suffix(prompts, block_size):
    """The prompt tokens an admission computes when every full block is
    restored: the partial block, or the last token (the cap)."""
    return sum(len(p) - min(len(p) // block_size * block_size, len(p) - 1)
               for p in prompts)


def rotated_payloads(keys, payloads):
    """The control's tier contents: each request's keys carry another
    request's payloads (the next request with full blocks: its block b,
    or its last block)."""
    out = {}
    for i, ks in enumerate(keys):
        j = next(j % len(keys) for j in range(i + 1, i + len(keys))
                 if payloads[j % len(keys)])
        for b, k in enumerate(ks):
            out[k] = payloads[j][min(b, len(payloads[j]) - 1)]
    return out


def tier_adapter(app, cfg, tier):
    from neuronx_distributed_inference_tpu_torch.serving import \
        PagedEngineAdapter
    return PagedEngineAdapter(app, ragged=True, kv_spill_tier=tier,
                              prefill_chunk_tokens=cfg["chunk"])


def serve_cold(eng, vocab, n_tokens, new_tokens, done, sync, seed=24):
    """Keep ``eng`` full of fresh random prompts of ``n_tokens`` until
    ``done()``, then drain. Returns (prompts served, passes)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    streams, passes = [], 0
    while not done():
        for _ in range(eng.adapter.free_capacity - eng.queue.depth):
            streams.append(eng.submit(
                rng.integers(1, vocab, size=n_tokens).tolist(), new_tokens))
        eng.run_pass()
        sync()
        passes += 1
        if passes > 400:
            raise AssertionError("cold traffic never evicted the prompts")
    eng.run_until_drained()
    return len(streams), passes


def phase_tier(device, app=None, on_card=True):
    """Phase 24 (a)-(c): the host-RAM spill tier, the handoff and the
    native allocator on phase 9's engine (Llama-3.1-8B, bf16, full width
    and depth; ``app``: phase 9's, else built). Returns the paged
    kernel's entries."""
    import numpy as np
    import torch
    from neuronx_distributed_inference_tpu_torch.serving.engine import \
        ServingEngine
    from neuronx_distributed_inference_tpu_torch.serving.fleet import \
        HostKVSpillTier
    phase = "tier"
    hf, cfg = LLAMA_3_1_8B, RAGGED
    layers, vocab = hf["num_hidden_layers"], hf["vocab_size"]
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    if app is None:
        app = make_ragged_app(hf, device, "bfloat16", cfg)
        init_weights(app, 0)
        warm(app, phase, chunk_tokens=cfg["chunk"])
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, vocab, size=n).tolist() for n in cfg["lens"]]
    mgr = app.kv_mgr
    bs = mgr.spec.block_size
    n_graphs = len(app.graphs) if app.graphs is not None else 0
    block_bytes = sum(t[:, 0].numel() * t.element_size()
                      for t in app.cache.values())
    tier = HostKVSpillTier(max_blocks=TIER24["max_blocks"])
    ad = tier_adapter(app, cfg, tier)
    probe = TierProbe(ad, sync)
    trace = record_allocator(mgr.allocator)
    eng = ServingEngine(ad)
    new = TIER24["new_tokens"]
    # (a) 1: the prompts, computed (the tier's allocator starts empty)
    _, _, ttft_recompute = serve_schedule(eng, prompts, new, sync)
    keys = tier_keys(prompts, bs)
    flat = [k for ks in keys for k in ks]
    # (a) 2: cold traffic until every full block left the pool, spilled
    t0 = time.perf_counter()
    n_cold, cold_passes = serve_cold(
        eng, vocab, TIER24["cold_len"], TIER24["cold_tokens"],
        lambda: (all(tier.contains(k) for k in flat) and not any(
            mgr.probe_cached_tokens(p)[0] for p in prompts)), sync)
    cold_s = time.perf_counter() - t0
    if not all(tier.contains(k) for k in flat):
        raise AssertionError(f"{phase}: spilled blocks left the tier")
    spilled_bytes = tier.nbytes
    stats_before = dict(tier.stats)
    real0 = ad.host_stats["prefill_real_tokens"]
    snap = {}

    def snapshot():
        # the restored cache's decode shapes: the last all-decode state
        # with the most live rows
        if (not ad.seqs or ad.pending_prefill_ids
                or len(ad.seqs) < len(snap.get("pos", ()))):
            return
        live = sorted(ad.seqs)
        snap["table"] = mgr.block_table_array(live, app._bt_width_for(live))
        snap["pos"] = [ad.seqs[s].position for s in live]
    # (a) 3: the prompts again, restored
    reset_launches([app])
    streams, recs, ttft_restore = serve_schedule(
        eng, prompts, new, sync, snapshot=snapshot,
        off_clock=lambda: probe.check_s)
    launches = kernel_counts([app])["paged_decode_attention"]
    check_ragged_passes(phase, recs, launches, layers)
    # a restored prompt whose full blocks cover it computes one token, so
    # a pass of such rows and decode rows is one column wide: the kernel
    decode_steps = one_column_passes(recs)
    want_launches = layers * decode_steps if on_card else 0
    computed = ad.host_stats["prefill_real_tokens"] - real0
    restored = tier.stats["restored"] - stats_before["restored"]
    stop_recording(mgr.allocator)  # (c) replays the calls up to here
    payloads = [[tier._pool[k] for k in ks] for ks in keys]
    emit({"phase": phase, "layers": layers, "requests": len(prompts),
          "max_blocks": TIER24["max_blocks"], "block_bytes": block_bytes,
          "cold_prompts": n_cold, "cold_passes": cold_passes,
          "cold_s": cold_s, "full_blocks": len(flat),
          "tier_stats": dict(tier.stats), "host_bytes": spilled_bytes,
          "restored_blocks": restored, "computed_prompt_tokens": computed,
          "expected_prompt_tokens": restore_suffix(prompts, bs),
          "ttft_recomputed_s": [ttft_recompute.get(i)
                                for i in range(len(prompts))],
          "ttft_restored_s": [ttft_restore.get(i)
                              for i in range(len(prompts))],
          "launches": launches, "expected_launches": want_launches,
          "one_column_passes": decode_steps,
          "all_decode_passes": sum(r["kind"] == "decode" for r in recs),
          "graphs": [n_graphs, len(app.graphs) if app.graphs else 0],
          **probe.summary()})
    check_streams(phase, streams, new, vocab)
    check_no_incidents(phase, app)
    if probe.bad or probe.blocks != len(flat) or restored != len(flat):
        raise AssertionError(f"{phase}: {probe.blocks} blocks restored of "
                             f"{len(flat)}, mismatched {probe.bad[:2]}")
    if computed != restore_suffix(prompts, bs):
        raise AssertionError(f"{phase}: {computed} prompt tokens computed "
                             "after the restore")
    if launches != want_launches:
        raise AssertionError(f"{phase}: paged kernel launches {launches} "
                             f"!= {layers} x {decode_steps}")
    if app.graphs is not None and len(app.graphs) != n_graphs:
        raise AssertionError(f"{phase}: graphs captured after the restore")
    twin = make_contiguous_app(hf, device, "bfloat16", batch=8,
                               seq_len=cfg["seq_len"], output_logits=True)
    twin.params = app.params
    toks = [s.tokens for s in streams]
    deficit_gate(phase, teacher_deficits(twin, prompts, toks), exact=False)
    # the control: every request's keys carry another request's payloads
    ctl_tier = HostKVSpillTier(max_blocks=TIER24["max_blocks"])
    ctl_tier.seed(rotated_payloads(keys, payloads))
    ctl = ServingEngine(tier_adapter(app, cfg, ctl_tier))
    with cold_prefix(app):
        ctl_streams, _, _ = serve_schedule(ctl, prompts, new, sync)
    if ctl_tier.stats["restored"] != len(flat):
        raise AssertionError(f"{phase}: the control restored "
                             f"{ctl_tier.stats['restored']} blocks")
    control_fails(phase, teacher_deficits(
        twin, prompts, [s.tokens for s in ctl_streams]),
        "with other prompts' payloads")
    entries = []
    if on_card:
        t = time_paged_kernel(app, snap["table"], snap["pos"], device,
                              seed=9)
        emit({"phase": phase + "_kernel_timings", **t["report"],
              "launches": launches})
        entries.append(paged_kernel_entry(t, launches, phase))
    # (c): the allocator calls of (a) through both allocators
    replay_allocator(phase, trace, mgr.spec.num_blocks, bs)
    del tier, payloads, ctl_tier
    phase_handoff(device, app, twin, sync, on_card)
    del twin
    if on_card:
        memory_note(phase)
    return entries


def first_tokens_then_capture(ad, sids, prompts):
    """Admit ``prompts`` on a ragged prefill adapter and hand each
    request off as soon as its first token lands: {sid: (first token,
    record, JSON wire string, encode ms)}."""
    from neuronx_distributed_inference_tpu_torch.serving.fleet import (
        capture_handoff, handoff_to_json)
    out = {}
    ad.add_requests(sids, prompts)
    steps = 0
    while len(out) < len(sids):
        for sid, toks in ad.step().items():
            if sid in out or not toks:
                continue
            rec = capture_handoff(ad, sid)
            t0 = time.perf_counter()
            wire = json.dumps(handoff_to_json(rec))
            out[sid] = (toks[0], rec, wire,
                        1e3 * (time.perf_counter() - t0))
        steps += 1
        if steps > 200:
            raise AssertionError("the prefill role made no progress")
    return out


def admit_records(ad, records, sids, new_tokens):
    """Admit handoff records on a ragged decode adapter and collect
    ``new_tokens`` tokens a request: {sid: tokens}."""
    from neuronx_distributed_inference_tpu_torch.serving.fleet import \
        admit_handoff
    for sid, rec in zip(sids, records):
        admit_handoff(ad, rec, sid)
    got = {s: [] for s in sids}
    steps = 0
    while any(len(v) < new_tokens for v in got.values()):
        for sid, toks in ad.step().items():
            got[sid].extend(toks)
        steps += 1
        if steps > 20 * new_tokens:
            raise AssertionError("the decode role made no progress")
    ad.release(sids)
    return {s: v[:new_tokens] for s, v in got.items()}


def phase_handoff(device, app, twin, sync, on_card):
    """24 (b): four requests prefilled on phase 9's app, handed off after
    their first token through the JSON wire form to a decode app that
    shares its weights (its own pool, tier and graphs), decoded there."""
    import numpy as np
    import torch
    from neuronx_distributed_inference_tpu_torch.serving import \
        PagedEngineAdapter
    from neuronx_distributed_inference_tpu_torch.serving.fleet import (
        HostKVSpillTier, handoff_from_json)
    phase = "tier_handoff"
    hf, cfg = LLAMA_3_1_8B, RAGGED
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, hf["vocab_size"], size=n).tolist()
               for n in TIER24["handoff_lens"]]
    sids = list(range(len(prompts)))
    dapp = make_ragged_app(hf, device, "bfloat16", cfg,
                           batch=TIER24["decode_batch"])
    dapp.params = app.params
    warm(dapp, phase, chunk_tokens=cfg["chunk"])
    n_graphs = len(dapp.graphs) if dapp.graphs is not None else 0
    bs = dapp.kv_mgr.spec.block_size
    pre = PagedEngineAdapter(app, ragged=True,
                             prefill_chunk_tokens=cfg["chunk"])
    got = first_tokens_then_capture(pre, sids, prompts)
    records, decode_ms, same_bytes = [], [], True
    for sid in sids:
        t0 = time.perf_counter()
        rec = handoff_from_json(json.loads(got[sid][2]))
        decode_ms.append(1e3 * (time.perf_counter() - t0))
        for a, b in zip(got[sid][1]["kv_blocks"], rec["kv_blocks"]):
            same_bytes &= a["hash"] == b["hash"] and all(
                torch.equal(a[n].view(torch.uint8), b[n].view(torch.uint8))
                for n in ("k", "v"))
        records.append(rec)
    tier = HostKVSpillTier(max_blocks=TIER24["max_blocks"])
    ad = tier_adapter(dapp, cfg, tier)
    probe = TierProbe(ad, sync)
    real0 = ad.host_stats["prefill_real_tokens"]
    n = TIER24["handoff_tokens"]
    if dapp.graphs is not None:
        dapp.graphs.reset_counts()
    decoded = admit_records(ad, records, sids, n)
    replays = (sum(dapp.graphs.replays.values())
               if dapp.graphs is not None else 0)
    computed = ad.host_stats["prefill_real_tokens"] - real0
    ctx = [p + [got[s][0]] for s, p in zip(sids, prompts)]
    n_blocks = sum(len(r["kv_blocks"]) for r in records)
    emit({"phase": phase, "requests": len(prompts),
          "prompt_lens": list(TIER24["handoff_lens"]),
          "record_bytes": [len(got[s][2]) for s in sids],
          "encode_ms": [got[s][3] for s in sids], "decode_ms": decode_ms,
          "blocks": n_blocks, "bytes_equal_after_wire": same_bytes,
          "computed_prompt_tokens": computed,
          "expected_prompt_tokens": restore_suffix(ctx, bs),
          "decoded_tokens": n, "graph_replays": replays,
          "graphs": [n_graphs, len(dapp.graphs) if dapp.graphs else 0],
          "tier_stats": dict(tier.stats), **probe.summary()})
    if not same_bytes or probe.bad or probe.blocks != n_blocks:
        raise AssertionError(f"{phase}: restored bytes differ from the "
                             f"captured ones ({probe.blocks} of {n_blocks} "
                             "blocks read back)")
    if computed != restore_suffix(ctx, bs):
        raise AssertionError(f"{phase}: {computed} prompt tokens computed "
                             "on the decode side")
    if on_card and (replays == 0 or len(dapp.graphs) != n_graphs):
        raise AssertionError(f"{phase}: {replays} graph replays, graphs "
                             f"{n_graphs} -> {len(dapp.graphs)}")
    check_no_incidents(phase, dapp)
    streams = [[got[s][0]] + decoded[s] for s in sids]
    deficit_gate(phase, teacher_deficits(twin, prompts, streams),
                 exact=False)
    # the control: each record's hashes carry another record's payloads
    keys = [[b["hash"] for b in r["kv_blocks"]] for r in records]
    pays = [[{"k": b["k"], "v": b["v"]} for b in r["kv_blocks"]]
            for r in records]
    rot = rotated_payloads(keys, pays)
    ctl_records = [dict(r, kv_blocks=[dict(b, **rot[b["hash"]])
                                      for b in r["kv_blocks"]])
                   for r in records]
    ctl_tier = HostKVSpillTier(max_blocks=TIER24["max_blocks"])
    with cold_prefix(dapp):
        ctl = admit_records(tier_adapter(dapp, cfg, ctl_tier), ctl_records,
                            sids, n)
    if ctl_tier.stats["restored"] != n_blocks:
        raise AssertionError(f"{phase}: the control restored "
                             f"{ctl_tier.stats['restored']} blocks")
    control_fails(phase, teacher_deficits(
        twin, prompts, [[got[s][0]] + ctl[s] for s in sids]),
        "with other requests' payloads")
    del dapp


def phase_tier_fp32(device, on_card=True):
    """24 (d): the restored and the handed-off greedy streams of an fp32
    4-layer cut (TF32 off) equal the single engine's exactly (a first
    difference only at a near-tie), and an fp8 (e4m3) pool's restore
    reads back bit for bit."""
    with fp32_exact():
        _phase_tier_fp32(device, on_card)


def evict_all(mgr, seed):
    """Push every LRU-resident block through the eviction hook: one
    pool-sized cold admission, aborted (its hashes purged)."""
    import numpy as np
    cold = np.random.default_rng(seed).integers(
        1, 1000, size=(mgr.spec.num_blocks - 1) * mgr.spec.block_size)
    mgr.begin_sequence(1 << 30, (cold + 10 ** 6).tolist())
    mgr.abort_sequence(1 << 30)
    if mgr.allocator._lru:
        raise AssertionError("the LRU was not drained")


def _phase_tier_fp32(device, on_card):
    import numpy as np
    import torch
    from neuronx_distributed_inference_tpu_torch.serving import \
        PagedEngineAdapter
    from neuronx_distributed_inference_tpu_torch.serving.fleet import (
        HostKVSpillTier, handoff_from_json)
    phase = "tier_fp32"
    hf = dict(LLAMA_3_1_8B, num_hidden_layers=TIER_CHECK_LAYERS)
    cfg = RAGGED
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, hf["vocab_size"], size=n).tolist()
               for n in cfg["lens"][:4]]
    sids = list(range(len(prompts)))
    n = TIER_CHECK_TOKENS
    app = make_ragged_app(hf, device, "float32", cfg, batch=4,
                          graphs=False, output_logits=True)
    init_weights(app, 0)

    def serve(ad):
        toks, _ = admit_and_collect(ad, sids, prompts, n)
        return [toks[s] for s in sids]
    single = serve(PagedEngineAdapter(app, ragged=True,
                                      prefill_chunk_tokens=cfg["chunk"]))
    tier = HostKVSpillTier(max_blocks=TIER24["max_blocks"])
    ad = tier_adapter(app, cfg, tier)
    probe = TierProbe(ad, sync)
    serve(ad)
    evict_all(app.kv_mgr, 5)
    restored = serve(ad)
    logit_at = paged_logit_at(app, prompts, single, cfg["chunk"])
    ties = check_equal_streams(phase + "_restored", restored, single,
                               logit_at)
    # the handoff: capture on app, admit on a second app (shared weights)
    dapp = make_ragged_app(hf, device, "float32", cfg, batch=4,
                           graphs=False)
    dapp.params = app.params
    pre = PagedEngineAdapter(app, ragged=True,
                             prefill_chunk_tokens=cfg["chunk"])
    with cold_prefix(app):
        got = first_tokens_then_capture(pre, sids, prompts)
    dtier = HostKVSpillTier(max_blocks=TIER24["max_blocks"])
    dad = tier_adapter(dapp, cfg, dtier)
    dprobe = TierProbe(dad, sync)
    decoded = admit_records(dad, [handoff_from_json(json.loads(got[s][2]))
                                  for s in sids], sids, n - 1)
    handed = [[got[s][0]] + decoded[s] for s in sids]
    ties += check_equal_streams(phase + "_handoff", handed, single,
                                logit_at)
    emit({"phase": phase, "layers": TIER_CHECK_LAYERS,
          "requests": len(prompts), "tokens": n, "near_ties": ties,
          "restore": probe.summary(), "handoff": dprobe.summary(),
          "tier_stats": dict(tier.stats), "decode_tier_stats":
              dict(dtier.stats)})
    if (probe.bad or dprobe.bad or not tier.stats["restored"]
            or not dtier.stats["restored"]):
        raise AssertionError(f"{phase}: restores {tier.stats}, "
                             f"{dtier.stats}, mismatched "
                             f"{(probe.bad + dprobe.bad)[:2]}")
    del app, dapp
    phase_tier_fp8(device, cfg, prompts, sync)


def admit_and_collect(ad, sids, prompts, new_tokens):
    """Admit ``prompts`` on a ragged adapter, collect ``new_tokens``
    tokens a request, release: ({sid: tokens}, steps)."""
    ad.add_requests(sids, prompts)
    got = {s: [] for s in sids}
    steps = 0
    while any(len(v) < new_tokens for v in got.values()):
        for sid, toks in ad.step().items():
            got[sid].extend(toks)
        steps += 1
        if steps > 20 * new_tokens + 50:
            raise AssertionError("the engine made no progress")
    ad.release(sids)
    return {s: v[:new_tokens] for s, v in got.items()}, steps


def phase_tier_fp8(device, cfg, prompts, sync):
    """24 (d): an fp8 (e4m3) pool (phase 18's scaled cache) spills and
    restores through its uint8 view: every restored block reads back bit
    for bit."""
    import torch
    from neuronx_distributed_inference_tpu_torch.serving.fleet import \
        HostKVSpillTier
    phase = "tier_fp8"
    hf = dict(LLAMA_3_1_8B, num_hidden_layers=TIER_CHECK_LAYERS)
    app = make_ragged_app(hf, device, "bfloat16", cfg, batch=4,
                          graphs=False, **FP8_KV)
    init_weights(app, 0)
    if app.cache["k"].dtype != torch.float8_e4m3fn:
        raise AssertionError(f"{phase}: cache is {app.cache['k'].dtype}")
    tier = HostKVSpillTier(max_blocks=TIER24["max_blocks"])
    ad = tier_adapter(app, cfg, tier)
    probe = TierProbe(ad, sync)
    sids = list(range(len(prompts)))
    first, _ = admit_and_collect(ad, sids, prompts, 4)
    evict_all(app.kv_mgr, 6)
    again, _ = admit_and_collect(ad, sids, prompts, 4)
    emit({"phase": phase, "dtype": str(app.cache["k"].dtype),
          "tier_stats": dict(tier.stats), **probe.summary()})
    if probe.bad or not probe.blocks:
        raise AssertionError(f"{phase}: {probe.blocks} blocks restored, "
                             f"mismatched {probe.bad[:2]}")
    del app


def phase_tier_group(device, app=None):
    """The ``tier`` group: phase 24 (a)-(d). Phase 9's app (``app``)
    replays its graphs again in phase 12, so the group frees memory
    without :func:`free_card`: dropping cuBLAS's workspaces would free
    the ones those graphs captured (an illegal address at their next
    replay, once the memory is returned to the card)."""
    import gc

    import torch
    entries = phase_tier(device, app)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    phase_tier_fp32(device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return entries


# ---------------------------------------------------------------------------
# Phase 25: the depth-1 decode pipeline, the run telemetry, the observatory
# ---------------------------------------------------------------------------

# phase 3's four prompt lengths, each twice, at batch 8; 24 decode calls a
# run; the telemetry runs take 6; the group's hard budget in seconds
PIPE25 = dict(lens=PROMPT_LENS * 2, batch=8, seq_len=2048, steps=24,
              tel_steps=6, budget_s=60.0)
TOL_OBSERVATORY_FLOPS_REL = 0.05     # 25 (e): the decode graph's count


class DispatchProbe:
    """Wraps an adapter's ``_dispatch_decode`` (the phase's, not the
    package's): ``timed`` records a CUDA event before and after each
    dispatch (an event is stamped when the stream reaches it, so an idle
    gap before a dispatch falls outside its window); ``guard`` runs each
    dispatch under ``torch.cuda.set_sync_debug_mode("error")`` (a
    host-device sync inside it raises). Counts the dispatches."""

    def __init__(self, ad, timed=False, guard=False):
        import torch
        self.events = []
        self.dispatches = 0
        inner = ad._dispatch_decode

        def wrapped(*a, **k):
            self.dispatches += 1
            if timed:
                e0 = torch.cuda.Event(enable_timing=True)
                e0.record()
            if guard:
                prev = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("error")
            try:
                out = inner(*a, **k)
            finally:
                if guard:
                    torch.cuda.set_sync_debug_mode(prev)
            if timed:
                e1 = torch.cuda.Event(enable_timing=True)
                e1.record()
                self.events.append((e0, e1))
            return out
        ad._dispatch_decode = wrapped

    def device(self):
        """(device ms a dispatch, the card's idle share from the first
        dispatch's start to the last one's end)."""
        busy = sum(a.elapsed_time(b) for a, b in self.events)
        span = self.events[0][0].elapsed_time(self.events[-1][1])
        return busy / len(self.events), 1.0 - busy / span


def pipeline_serve(ad, prompts, steps, sync):
    """Admit every prompt at once (rows 0..n-1), then ``steps`` calls of
    ``step()`` and a ``flush()``: ({row: tokens}, host ms a step call over
    the decode loop). A pipelined adapter delivers the same count: its
    first call returns nothing, ``flush`` the last step's tokens."""
    rows = list(range(len(prompts)))
    got = {s: [t] for s, t in ad.add_requests(rows, prompts).items()}
    sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        for s, t in ad.step().items():
            got[s].append(t)
    for s, t in ad.flush().items():
        got[s].append(t)
    sync()
    return got, (time.perf_counter() - t0) * 1e3 / steps


def decode_graph_flops(hf, rows, keys):
    """2 x the multiply-adds of one T = 1 step over ``rows`` (every
    layer's weights and the lm head), plus the paged kernel's formula (QK
    and PV over ``keys`` prior keys and the active token, each row, each
    layer)."""
    h, i = hf["hidden_size"], hf["intermediate_size"]
    hq, d = hf["num_attention_heads"], hf["head_dim"]
    q, kv = hq * d, hf["num_key_value_heads"] * d
    layers = hf["num_hidden_layers"]
    per_token = h * (q + 2 * kv) + q * h + 3 * h * i
    return (2 * rows * (layers * per_token + h * hf["vocab_size"])
            + layers * 4 * (rows * keys + rows) * hq * d)


def pipeline_telemetry(phase, app, cls, prompts, steps, sync, kind):
    """25 (d): a short pipelined run with a registry on the app and the
    adapter. ``nxdi_dispatch_depth`` reads 1 after each dispatch and 0
    after ``flush``; ``nxdi_run_seconds`` holds host and device parts for
    ``kind``; ``nxdi_device_sampled_rows_total`` per kind equals the rows
    the app's steps were given (counted by a spy on its ``_run_*``).
    Returns the overlap histogram's median bucket and mean (seconds)."""
    import numpy as np
    from neuronx_distributed_inference_tpu_torch.telemetry import (
        MetricsRegistry, metrics)
    reg = MetricsRegistry()
    rows = {}
    spied = {m: k for m, k in (("_run_paged", "paged"),
                               ("_run_prefill", "prefill"),
                               ("_run_decode", "decode"))
             if hasattr(app, m)}
    for meth, k in spied.items():
        inner = getattr(app, meth)

        def spy(ids, *a, _inner=inner, _k=k, **kw):
            b, t = (tuple(np.shape(ids)) + (1,))[:2]
            rows[_k] = rows.get(_k, 0) + b * (t if _k == "decode" else 1)
            return _inner(ids, *a, **kw)
        setattr(app, meth, spy)
    app.telemetry = reg
    ad = cls(app, pipeline_depth=1, telemetry=reg)
    try:
        engine = ad.engine_name
        ad.add_requests(list(range(len(prompts))), prompts)
        depth = []
        for _ in range(steps):
            ad.step()
            depth.append(reg.get(metrics.DISPATCH_DEPTH).get(engine=engine))
        ad.flush()
        depth.append(reg.get(metrics.DISPATCH_DEPTH).get(engine=engine))
        sync()
        ad.release(list(range(len(prompts))))
    finally:
        app.telemetry = None
        for meth in spied:
            delattr(app, meth)
    hist = reg.get(metrics.RUN_SECONDS)
    parts = {p: hist.count(kind=kind, part=p) for p in ("host", "device")}
    sampled = {k: reg.get(metrics.DEVICE_SAMPLED_ROWS_TOTAL).get(kind=k)
               for k in rows}
    over = reg.get(metrics.HOST_OVERLAP_SECONDS)
    n = over.count(engine=engine)
    out = {"dispatch_depth_after_each_step": depth,
           "run_seconds_counts": parts, "sampled_rows": sampled,
           "rows_dispatched": rows, "overlaps": n,
           "overlap_median_bucket_s": over.percentile(0.5, engine=engine),
           "overlap_mean_s": over.sum(engine=engine) / max(n, 1)}
    emit({"phase": phase + "_telemetry", **out})
    if depth != [1.0] * steps + [0.0]:
        raise AssertionError(f"{phase}: dispatch depth {depth}")
    if not (parts["host"] and parts["host"] == parts["device"]):
        raise AssertionError(f"{phase}: run seconds {parts} for {kind}")
    if sampled != {k: float(v) for k, v in rows.items()}:
        raise AssertionError(f"{phase}: sampled rows {sampled} != {rows}")
    if n != steps:
        raise AssertionError(f"{phase}: {n} overlaps for {steps} fetches")
    return out


def pipeline_cb_extra(app, prompts, cfg, sync, on_card):
    """25 (c), (f) on the continuous-batching app. (c) the full batch in
    order at both depths with the identity rule off (every step on the
    gather path, as the reference's continuous batching runs), timed as
    with it on. (f) a batch with a free row (the last prompt left out:
    row 0 pads it, the gather path) at both depths: equal streams, and no
    steady-state incident after ``precompile``."""
    from neuronx_distributed_inference_tpu_torch.serving import \
        ContinuousBatchingAdapter
    rows = list(range(len(prompts)))
    off = {}
    app._identity_rows = lambda sid, t=1: False
    try:
        for depth in (0, 1):
            ad = ContinuousBatchingAdapter(app, pipeline_depth=depth)
            probe = DispatchProbe(ad, timed=on_card)
            _, host_ms = pipeline_serve(ad, prompts, cfg["steps"], sync)
            ad.release(rows)
            dev_ms, idle = probe.device() if on_card else (None, None)
            off[depth] = {"host_ms_per_step": host_ms,
                          "device_ms_per_dispatch": dev_ms,
                          "idle_share": idle}
    finally:
        del app._identity_rows
    free = {}
    for depth in (0, 1):
        ad = ContinuousBatchingAdapter(app, pipeline_depth=depth)
        free[depth], _ = pipeline_serve(ad, prompts[:-1], cfg["tel_steps"],
                                        sync)
        ad.release(rows[:-1])
    emit({"phase": "pipeline_cb_rule_off", "timing": off,
          "free_row_streams_equal": free[0] == free[1]})
    if free[0] != free[1]:
        raise AssertionError("pipeline_cb_free_row: depth 1 streams part "
                             "from depth 0's")
    check_no_incidents("pipeline_cb_free_row", app)
    return off


def phase_pipeline(device, hf=LLAMA_3_2_1B, cfg=PIPE25, on_card=True):
    """Phase 25 (the ``pipeline`` group): Llama-3.2-1B at full width and
    depth, bf16, random weights from seed 0, batch 8, served by the paged
    adapter (two-phase; decode through the paged kernel) and the
    continuous-batching adapter (every step holds all 8 rows: the
    contiguous decode kernel), both over captured graphs. (a) streams at
    ``pipeline_depth=1`` equal depth 0's, token for token; (b) every
    pipelined dispatch runs under the sync debug mode "error", and no
    staging fill waits on the card; (c) host ms a step, device ms a
    dispatch (CUDA events) and the idle share at depths 0 and 1,
    untraced, and on the continuous-batching app with the identity rule
    off; (d) :func:`pipeline_telemetry`; (e) the observatory over the
    paged app; (f) a continuous batch with a free row (:func:`
    pipeline_cb_extra`), and no steady-state incident on either app.
    Returns the kernels-line entries of both decode kernels with this
    phase's launches (the guarded pipelined runs)."""
    import numpy as np
    import torch
    from neuronx_distributed_inference_tpu_torch.serving import (
        ContinuousBatchingAdapter, PagedEngineAdapter)
    from neuronx_distributed_inference_tpu_torch.telemetry import \
        observatory
    t_start = time.perf_counter()
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    rng = np.random.default_rng(25)
    prompts = [rng.integers(1, hf["vocab_size"], size=n).tolist()
               for n in cfg["lens"]]
    rows = list(range(len(prompts)))
    papp = make_app(hf, device, "bfloat16", batch=cfg["batch"],
                    seq_len=cfg["seq_len"], prefix_caching=False)
    papp.init_random_weights(0)
    capp = make_contiguous_app(hf, device, "bfloat16", batch=cfg["batch"],
                               seq_len=cfg["seq_len"], cb=True)
    capp.params = papp.params
    warm(papp, "pipeline_paged")
    warm(capp, "pipeline_cb")
    entries, timing = [], {}
    layers = hf["num_hidden_layers"]
    for name, app, cls, kernel in (
            ("paged", papp, PagedEngineAdapter, "paged_decode_attention"),
            ("cb", capp, ContinuousBatchingAdapter,
             "decode_attention_stacked")):
        phase = "pipeline_" + name
        streams, timing[name] = {}, {}
        for depth in (0, 1):
            ad = cls(app, pipeline_depth=depth)
            probe = DispatchProbe(ad, timed=on_card)
            streams[depth], host_ms = pipeline_serve(ad, prompts,
                                                     cfg["steps"], sync)
            ad.release(rows)
            dev_ms, idle = probe.device() if on_card else (None, None)
            timing[name][depth] = {
                "host_ms_per_step": host_ms,
                "host_ms_per_token": host_ms / len(rows),
                "device_ms_per_dispatch": dev_ms, "idle_share": idle,
                "dispatches": probe.dispatches}
        # (a), (b): depth 1 again under the guard; this run's launches
        ad = cls(app, pipeline_depth=1)
        probe = DispatchProbe(ad, guard=on_card)
        reset_launches([app])
        guarded, _ = pipeline_serve(ad, prompts, cfg["steps"], sync)
        launches = kernel_counts([app])[kernel]
        waits = app.graphs.staging_waits if app.graphs is not None else 0
        positions = [ad.seqs[s].position for s in rows]
        for depth, got in ((0, streams[0]), (1, streams[1]),
                           ("guarded", guarded)):
            for s in rows:
                if got[s] != streams[0][s]:
                    j = next(i for i, (a, b) in enumerate(
                        zip(got[s], streams[0][s])) if a != b)
                    raise AssertionError(
                        f"{phase}: depth {depth} stream {s} parts from "
                        f"depth 0 at token {j}")
            if any(len(got[s]) != cfg["steps"] + 1 for s in rows):
                raise AssertionError(f"{phase}: short stream at {depth}")
        want = layers * probe.dispatches if on_card else 0
        emit({"phase": phase, "streams_equal": True,
              "tokens_per_stream": cfg["steps"] + 1,
              "dispatches": probe.dispatches, "launches": launches,
              "expected_launches": want, "staging_waits": waits,
              "timing": timing[name],
              "host_stats": {k: v for k, v in ad.host_stats.items()
                             if isinstance(v, int)}})
        if launches != want:
            raise AssertionError(f"{phase}: {kernel} launches {launches} "
                                 f"!= layers x dispatches {want}")
        if waits:
            raise AssertionError(f"{phase}: {waits} staging fills waited")
        if on_card and name == "paged":
            table = papp.kv_mgr.block_table_array(rows, papp._bt_width(
                len(rows)))
            t = time_paged_kernel(papp, table, positions, device, seed=25)
            emit({"phase": phase + "_kernel", **t["report"],
                  "launches": launches})
            entries.append(paged_kernel_entry(t, launches, phase))
        elif on_card:
            entries.append(dict(b2_entry(phase, device, capp.cache,
                                         positions, capp.spec, launches),
                                path=phase))
        ad.release(rows)
        if name == "cb":
            timing[name]["rule_off"] = pipeline_cb_extra(
                app, prompts, cfg, sync, on_card)
        pipeline_telemetry(phase, app, cls, prompts, cfg["tel_steps"], sync,
                           "paged" if name == "paged" else "decode")
        check_no_incidents(phase, app)
    # (e) the observatory over the paged app: no state touched
    cache = {k: v.clone() for k, v in papp.cache.items()}
    rep = observatory.analyze_app(papp)
    for k, v in papp.cache.items():
        if not torch.equal(v, cache[k]):
            raise AssertionError(f"pipeline_observatory: cache {k} moved")
    del cache
    b = cfg["batch"]
    g = next(x for x in rep["graphs"]
             if (x["kind"], x["bucket"]) == ("paged", f"w1xb{b}"))
    want = decode_graph_flops(hf, b, papp.max_blocks
                              * papp.kv_mgr.spec.block_size)
    rel = abs(g["flops"] - want) / want
    weight_bytes = param_bytes(papp.params)
    emit({"phase": "pipeline_observatory", "totals": rep["totals"],
          "assumptions": rep["assumptions"], "device": rep["device"],
          "decode_graph": g, "analytic_flops": want, "flops_rel_err": rel,
          "tol": TOL_OBSERVATORY_FLOPS_REL, "weight_bytes": weight_bytes,
          "graphs": [[x["kind"], x["bucket"], x["compile_seconds"],
                      x["flops"], x["bytes_accessed"],
                      (x["memory"] or {}).get("peak_bytes")]
                     for x in rep["graphs"]]})
    if not rel <= TOL_OBSERVATORY_FLOPS_REL:
        raise AssertionError(f"pipeline_observatory: decode flops "
                             f"{g['flops']} vs analytic {want}")
    if not g["bytes_accessed"] >= weight_bytes:
        raise AssertionError("pipeline_observatory: bytes below the "
                             "weights'")
    if on_card:
        if not (g["compile_seconds"] > 0 and g["memory"]
                and g["memory"]["peak_bytes"] > 0):
            raise AssertionError("pipeline_observatory: the captured decode "
                                 f"graph reports {g['compile_seconds']} s, "
                                 f"{g['memory']}")
        for x in rep["graphs"]:
            if (x["memory"] is None) != (x["compile_seconds"] == 0.0):
                raise AssertionError(f"pipeline_observatory: {x}")
        h100 = DEVICE_PEAKS["H100"]
        if "H100" in rep["device"] and (
                rep["assumptions"]["hbm_gbps"] != h100["hbm_gbps"]
                or rep["assumptions"]["peak_tflops"]
                != h100["peak_tflops"]["bfloat16"]
                or g["roofline"] is None):
            raise AssertionError(f"pipeline_observatory: roofline "
                                 f"{rep['assumptions']}")
    seconds = time.perf_counter() - t_start
    emit({"phase": "pipeline_done", "seconds": seconds,
          "budget_s": cfg["budget_s"]})
    if on_card and seconds > cfg["budget_s"]:
        raise AssertionError(f"pipeline group took {seconds:.1f} s, over "
                             f"its budget of {cfg['budget_s']} s")
    return entries



# ---------------------------------------------------------------------------
# Phase 26: the contrib dense families. Geometries written from the
# published HF config.json files (random weights from seed 0).
# ---------------------------------------------------------------------------

# Pythia-6.9B (EleutherAI/pythia-6.9b, model_type gpt_neox): 32 layers, 32
# heads of 128 over 32 KV heads (G 1), rotary over 25% of each head (32 of
# 128) at base 10000, the parallel residual (its MLP norm over the block
# input), a plain gelu MLP of 16384 with biases, LayerNorms with biases
# (eps 1e-5), 2048 positions, an untied head over 50432 rows (the
# tokenizer's 50277 padded)
PYTHIA_6_9B = dict(
    model_type="gpt_neox", hidden_size=4096, intermediate_size=16384,
    num_hidden_layers=32, num_attention_heads=32, vocab_size=50432,
    rotary_pct=0.25, rotary_emb_base=10000, use_parallel_residual=True,
    hidden_act="gelu", layer_norm_eps=1e-5, max_position_embeddings=2048,
    tie_word_embeddings=False)
# BLOOM-7B1 (bigscience/bloom-7b1): 30 layers, 32 heads of 128 (G 1),
# ALiBi (no rotation), the embeddings' LayerNorm, a plain tanh-gelu MLP of
# 4 x 4096 with biases, LayerNorms with biases (eps 1e-5), the 250880-row
# table tied to the head; ``num_hidden_layers`` mirrors ``n_layer`` for
# the helpers that read it
BLOOM_7B1 = dict(
    model_type="bloom", hidden_size=4096, n_head=32, n_layer=30,
    num_hidden_layers=30, vocab_size=250880, layer_norm_epsilon=1e-5,
    tie_word_embeddings=True)
# (b), (c): phase 9's engine and mix on Pythia's 2048 positions; BLOOM
#   served at 10 of its 30 layers (every layer alike; the room of the
#   950 s target)
CONTRIB_DENSE_SERVE = dict(RAGGED, seq_len=2048)
BLOOM_SERVE_LAYERS = 10
# (a): the synthetic batch at Pythia's heads (B 8 over 2048 slots)
CONTRIB_DENSE_KERNEL_LENS = (37, 300, 640, 900, 1200, 1500, 1900, 2000)
# (d): the fp32 cuts on the contiguous app (batch 4, bucket 512)
CONTRIB_DENSE_CHECK_LAYERS = 2
CONTRIB_DENSE_BUDGET_S = 90


def bloom_cut(layers):
    """BLOOM-7B1 cut to ``layers`` layers (``n_layer`` with it)."""
    return dict(BLOOM_7B1, n_layer=layers, num_hidden_layers=layers)


def check_contrib_dense_specs():
    """Gate: Pythia-6.9B resolves to G 1 at head_dim 128, rotary 32 of 128,
    the parallel-dual block, a plain biased MLP, biased LayerNorms, an
    untied head, and the paged and contiguous decode gates admit it;
    BLOOM-7B1 to ALiBi without rotation, the embeddings' norm and a tied
    head, and with both kernels asked for (``decode_kernel`` and
    ``flash_prefill`` True) no gate admits it: not the decode kernels'
    ``supports``, not the paged branch's, not the contiguous decode
    branch's and not the flash prefill's; without ``alibi`` each
    does."""
    import dataclasses

    import torch
    from neuronx_distributed_inference_tpu_torch.models import model_base
    from neuronx_distributed_inference_tpu_torch.ops import decode_attention
    pythia = family_spec(PYTHIA_6_9B, seq_len=2048)
    bloom = family_spec(BLOOM_7B1, seq_len=2048, attn_kernel_enabled=True,
                        attn_block_tkg_kernel_enabled=True)
    cache = {"k": torch.empty((1, 4, 1, 1, 1), dtype=torch.bfloat16)}

    def gates(spec):
        return {"supports": decode_attention.supports(spec, 1),
                "paged": model_base.use_decode_kernel(spec, 1,
                                                      torch.bfloat16),
                "contiguous": model_base.use_contiguous_decode_kernel(
                    spec, 1, 4, cache, True),
                "flash": model_base.use_flash_prefill(spec, 512)}
    got = {name: {"group": spec.gqa.q_per_kv, "head_dim": spec.head_dim,
                  "rotary_dim": spec.rope.rotary_dim,
                  "block_style": spec.block_style, "mlp_glu": spec.mlp_glu,
                  "mlp_bias": spec.mlp_bias,
                  "norm": [spec.norm_type, spec.norm_bias],
                  "no_rope": spec.no_rope, "alibi": spec.alibi,
                  "embed_norm": spec.embed_norm,
                  "tied": spec.tie_word_embeddings,
                  "padded_vocab": spec.padded_vocab, "gates": gates(spec)}
           for name, spec in (("pythia_6_9b", pythia), ("bloom_7b1", bloom))}
    got["bloom_7b1_without_alibi"] = gates(dataclasses.replace(bloom,
                                                               alibi=False))
    emit({"phase": "contrib_dense_specs", **got})
    ok = (pythia.gqa.q_per_kv == 1 and pythia.head_dim == 128
          and pythia.rope.rotary_dim == 32
          and pythia.block_style == "parallel_dual" and not pythia.mlp_glu
          and pythia.mlp_bias and pythia.norm_bias
          and pythia.norm_type == "layernorm"
          and not pythia.tie_word_embeddings
          and pythia.padded_vocab == 50432
          and got["pythia_6_9b"]["gates"]["paged"]
          and got["pythia_6_9b"]["gates"]["contiguous"]
          and bloom.alibi and bloom.no_rope and bloom.embed_norm
          and bloom.tie_word_embeddings and bloom.padded_vocab == 250880
          and bloom.gqa.q_per_kv == 1 and bloom.head_dim == 128
          and bloom.flash_prefill and bloom.decode_kernel is True
          and not any(got["bloom_7b1"]["gates"].values())
          and all(got["bloom_7b1_without_alibi"].values()))
    if not ok:
        raise AssertionError(f"contrib_dense specs: {got}")


def _phase_contrib_dense_kernels(device):
    """26 (a): the paged kernel on a synthetic batch at Pythia's heads (B
    8, Hq = Hkv = 32, G 1, D 128, bf16 pages of 32, lens 37-2000), within
    one bf16 ulp of its twin (tol_decode_bf16), with a control (the twin
    reading KV head h // 2 for query head h) that must part beyond it;
    then timed by CUDA-graph replay beside the twin, SDPA over the
    pre-gathered KV and the bound."""
    import torch
    import torch.nn.functional as F
    from neuronx_distributed_inference_tpu_torch.ops import decode_attention
    gen = torch.Generator(device=device).manual_seed(26)
    lens = list(CONTRIB_DENSE_KERNEL_LENS)
    x = paged_inputs(gen, device, b=len(lens), hq=32, hkv=32, d=128, bs=32,
                     mb=-(-(max(lens) + 1) // 32), lens=lens,
                     act_dtype=torch.bfloat16, page_dtype=torch.bfloat16)
    kw = dict(scale=128 ** -0.5)
    args = (x["q"], x["k_pages"], x["v_pages"], x["new_k"], x["new_v"], 0,
            x["lens"], x["block_table"])
    got = decode_attention.paged_decode_attention(*args, **kw)
    want = decode_attention.paged_decode_attention_plain(*args, **kw)
    heads = torch.arange(32, device=device) // 2
    ctl = decode_attention.paged_decode_attention_plain(
        x["q"], x["k_pages"].index_select(3, heads),
        x["v_pages"].index_select(3, heads), x["new_k"].index_select(1, heads),
        x["new_v"].index_select(1, heads), 0, x["lens"], x["block_table"],
        **kw)
    tol = tol_decode_bf16(want)
    err = (got.float() - want.float()).abs().max().item()
    ctl_err = (got.float() - ctl.float()).abs().max().item()
    shape = {"B": len(lens), "Hq": 32, "Hkv": 32, "G": 1, "D": 128,
             "Bs": 32, "lens": lens, "pages": "bfloat16"}
    emit({"phase": "contrib_dense_kernel_vs_twin",
          "kernel": "paged_decode_attention", "shape": shape,
          "max_abs_err": err, "tol": tol,
          "control_h_over_2_max_abs_err": ctl_err})
    if not (torch.isfinite(got.float()).all() and err <= tol):
        raise AssertionError(f"contrib_dense kernel: {err} > {tol}")
    if not ctl_err > tol:
        raise AssertionError(f"contrib_dense kernel: the h // 2 control "
                             f"sits within {tol} ({ctl_err})")
    q4, k4, v4, m4 = sdpa_inputs(x, 0)
    t = timed_kernel(
        lambda: decode_attention.paged_decode_attention(*args, **kw),
        lambda: decode_attention.paged_decode_attention_plain(*args, **kw),
        lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=m4,
                                               scale=kw["scale"],
                                               enable_gqa=True),
        kernel_bounds(x), err, shape)
    emit({"phase": "contrib_dense_kernel_timings",
          "kernel": "paged_decode_attention", "kernel_us": t["ms"] * 1e3,
          "bound_us": t["bound_ms"] * 1e3, "bound_by": t["bound_by"],
          "plain_us": t["plain_ms"] * 1e3,
          "library_us": t["library_ms"] * 1e3, "library": "SDPA",
          "max_abs_err": err, "shape": shape})
    # comparison launches are not main-path launches
    reset_launches()
    del x, args, got, want, ctl, q4, k4, v4, m4
    torch.cuda.empty_cache()
    return t


def wrapper_counts():
    """Each kernel wrapper's (eager launches, launches recorded into CUDA
    graphs) so far: a graph replays only what a capture recorded, so no
    capture and no eager launch means no launch at all."""
    from neuronx_distributed_inference_tpu_torch.models.cuda_graphs import \
        KERNELS
    return {name: (KERNELS[name].launches, KERNELS[name].captured)
            for name in KERNEL_NAMES}


def bloom_serving(device):
    """26 (c): BLOOM-7B1 at full width, cut to BLOOM_SERVE_LAYERS layers,
    on the engine of (b), with the decode kernel and flash forced on: phase 19's gates with no
    paged-kernel launch (the spy sees no call), the streams held to
    ``generate``, and no launch or capture of any of the three kernel
    wrappers over the whole run. The control: a 2-layer cut at the same
    width, eager, with ``alibi`` taken off its spec, launches the paged
    kernel at both layers of every decode step."""
    import dataclasses
    before = wrapper_counts()
    reset_launches()
    phase_dense_serving(bloom_cut(BLOOM_SERVE_LAYERS), device,
                        CONTRIB_DENSE_SERVE, "bloom_serving", (),
                        kernel=False, group=None,
                        batch=8, tcfg_extra=dict(kernel=True,
                                                 attn_kernel_enabled=True))
    after = wrapper_counts()
    delta = {k: [after[k][0], after[k][1] - before[k][1]] for k in after}
    ctl = make_ragged_app(bloom_cut(2), device, "bfloat16",
                          CONTRIB_DENSE_SERVE, batch=4, graphs=False,
                          kernel=True)
    ctl.init_random_weights(1)
    ctl.spec = dataclasses.replace(ctl.spec, alibi=False)
    ids, mask = prompts_of(CONTRIB_DENSE_SERVE["lens"][:4],
                           BLOOM_7B1["vocab_size"], seed=26)
    reset_launches([ctl])
    ctl.generate(ids, attention_mask=mask, max_new_tokens=5)
    ctl_launches = kernel_counts([ctl])["paged_decode_attention"]
    want = 2 * 4 if device.type == "cuda" else 0
    emit({"phase": "bloom_serving_no_kernel",
          "launches_and_captures": delta,
          "control_without_alibi_paged_launches": ctl_launches,
          "control_expected": want})
    del ctl
    free_card()
    if any(v != [0, 0] for v in delta.values()):
        raise AssertionError(f"bloom_serving: kernel launches {delta}")
    if ctl_launches != want:
        raise AssertionError(f"bloom_serving: the control without ALiBi "
                             f"launched the paged kernel {ctl_launches} "
                             "times, not 8")


def contrib_dense_fp32_cut(name, hf, device):
    """26 (d), one geometry cut to CONTRIB_DENSE_CHECK_LAYERS layers, fp32
    (TF32 off), on the family's contiguous ``CausalLMApplication`` with
    both kernels asked for (``attn_kernel_enabled``, the decode kernel
    forced on), after ``precompile``: phase 19's four prompts, 16 new
    tokens. Pythia (and 27 (d)'s StarCoder and Falcon-7B) launch flash
    once a layer and the decode kernel at every layer of every decode step
    (replays counted); GPT-Neo (a layer pattern on the mixed cache)
    launches no flash and the decode kernel at its global layers only;
    each kernel launched is then held to its twin and timed at the
    launches' shapes (:func:`dbrx_fp32_kernels`); BLOOM launches neither.
    The greedy
    streams equal those of the same weights with both kernels off (a
    first difference only at a near-tie). BLOOM's control: the same app
    with ``alibi`` taken off its spec launches both kernels. Returns
    (decode launches, flash launches, kernel numbers or None)."""
    import dataclasses

    import numpy as np
    new = DENSE_CHECK_TOKENS
    layers = hf["num_hidden_layers"]
    cfg = DENSE_CHECK
    alibi = hf["model_type"] == "bloom"
    on_card = device.type == "cuda"
    ids, mask = prompts_of(cfg["lens"], hf["vocab_size"], seed=26)
    lens = mask.sum(axis=1)
    phase = f"contrib_dense_fp32_{name}"
    with ContiguousArgsSpy() as spy:
        capp = make_contiguous_app(hf, device, "float32", batch=len(lens),
                                   seq_len=cfg["seq_len"], decode_kernel=True,
                                   output_logits=True)
        init_weights(capp, 0)
        warm(capp, phase)
        reset_launches([capp])
        with FlashShapes() as flash:
            out = capp.generate(ids, attention_mask=mask, max_new_tokens=new,
                                return_logits=True)
        counts = kernel_counts([capp])
    # a layer pattern keeps flash off and, on the mixed cache, the decode
    # kernel on the global stack
    pattern = capp.spec.layer_pattern
    if pattern is not None and not capp.spec.mixed_kv:
        raise AssertionError(f"{phase}: a layer pattern on a uniform cache")
    dec_layers = layers - sum(map(bool, pattern or ()))
    flash_layers = 0 if pattern else layers
    want = ({"paged_decode_attention": 0, "decode_attention_stacked": 0,
             "flash_attention": 0} if alibi or not on_card else
            {"paged_decode_attention": 0,
             "decode_attention_stacked": dec_layers * (new - 1),
             "flash_attention": flash_layers})
    off = make_contiguous_app(hf, device, "float32", batch=len(lens),
                              seq_len=cfg["seq_len"], kernels=False,
                              output_logits=True)
    off.params = capp.params
    ref = off.generate(ids, attention_mask=mask, max_new_tokens=new,
                       return_logits=True)
    del off
    check_equal_streams(
        phase + "_kernels_vs_off", np.asarray(out["generated"]),
        np.asarray(ref["generated"]),
        lambda i, j, lg=ref["logits"]: (lg[0][i, lens[i] - 1] if j == 0
                                        else lg[j][i, 0]))
    control = None
    if alibi:
        ctl = make_contiguous_app(hf, device, "float32", batch=len(lens),
                                  seq_len=cfg["seq_len"], decode_kernel=True,
                                  graphs=False)
        ctl.spec = dataclasses.replace(ctl.spec, alibi=False)
        ctl.params = capp.params
        reset_launches([ctl])
        ctl.generate(ids, attention_mask=mask, max_new_tokens=4)
        control = kernel_counts([ctl])
        del ctl
    emit({"phase": phase, "layers": layers, "launches": counts,
          "expected": want, "decode_calls": sorted(spy.calls),
          "flash_shapes": [list(map(str, c)) for c in flash.calls[:2]],
          "control_without_alibi": control})
    if counts != want:
        raise AssertionError(f"{phase}: launches {counts} != {want}")
    if alibi and on_card and not (
            control["flash_attention"] == layers
            and control["decode_attention_stacked"] == layers * 3):
        raise AssertionError(f"{phase}: the control without ALiBi "
                             f"launched {control}")
    times = None
    if on_card and not alibi:
        spec = capp.spec
        times = dbrx_fp32_kernels(
            device, spy.ints, flash.calls, [int(n) + new - 2 for n in lens],
            dict(scale=spec.scale, window=spec.sliding_window,
                 soft_cap=spec.attn_soft_cap), phase=phase,
            flash=flash_layers > 0)
    del capp
    free_card()
    return (counts["decode_attention_stacked"], counts["flash_attention"],
            times)


def phase_contrib_dense(device):
    """Group ``contrib_dense`` (phase 26 (a)-(d)); returns its kernels-line
    entries: the paged kernel over Pythia's served cache at its last layer
    (with (b)'s launches), and the contiguous decode and flash kernels at
    Pythia's fp32 cut's shapes and dtype (with (d)'s launches)."""
    import torch
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    check_contrib_dense_specs()
    _phase_contrib_dense_kernels(device)
    memory_note("contrib_dense_kernels")
    entries = phase_dense_serving(PYTHIA_6_9B, device, CONTRIB_DENSE_SERVE,
                                  "pythia_serving", (-1,), group=1, batch=8)
    bloom_serving(device)
    with fp32_exact():
        cuts = {name: contrib_dense_fp32_cut(
            name, dict(hf, num_hidden_layers=CONTRIB_DENSE_CHECK_LAYERS),
            device) for name, hf in (
                ("pythia", PYTHIA_6_9B),
                ("bloom", bloom_cut(CONTRIB_DENSE_CHECK_LAYERS)))}
    decode_launches, flash_launches, times = cuts["pythia"]
    entries += contiguous_kernel_entries(times, decode_launches,
                                         flash_launches,
                                         "contrib_dense_fp32_pythia")
    seconds = time.perf_counter() - t0
    emit({"phase": "contrib_dense_done", "seconds": seconds,
          "budget_s": CONTRIB_DENSE_BUDGET_S})
    if seconds > CONTRIB_DENSE_BUDGET_S:
        raise AssertionError(f"contrib_dense group took {seconds:.1f} s, "
                             f"over its budget of {CONTRIB_DENSE_BUDGET_S} s")
    return entries


# ---------------------------------------------------------------------------
# Phase 27: the contrib hub's second dense wave, decode at any GQA group
# ---------------------------------------------------------------------------

# StarCoder (bigcode/starcoder): GPT-BigCode, 40 layers of 6144, 48 heads
# of 128 over one KV head (multi-query: G 48), an MLP of 24576 with biases
# (tanh gelu), biased LayerNorms, 8192 learned positions, the 49152-row
# table tied to the head; ``num_hidden_layers`` mirrors ``n_layer`` for the
# helpers that read it
STARCODER = dict(
    model_type="gpt_bigcode", n_embd=6144, n_head=48, n_layer=40,
    num_hidden_layers=40, n_inner=24576, n_positions=8192,
    vocab_size=49152, activation_function="gelu_pytorch_tanh",
    multi_query=True, layer_norm_epsilon=1e-5)
# Command-R7B (CohereForAI/c4ai-command-r7b-12-2024): 32 layers of 4096,
# 32 heads of 128 over 8 (G 4), an MLP of 14336, a window of 4096 on three
# layers of every four and NoPE on the fourth, the parallel-shared block,
# a bias-free LayerNorm, ``logit_scale`` 0.25, the 256000-row table tied
COMMAND_R7B = dict(
    model_type="cohere2", hidden_size=4096, intermediate_size=14336,
    num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
    head_dim=128, vocab_size=256000, layer_norm_eps=1e-5, logit_scale=0.25,
    rope_theta=50000.0, sliding_window=4096, max_position_embeddings=132096,
    layer_types=(["sliding_attention"] * 3 + ["full_attention"]) * 8,
    tie_word_embeddings=True)
# Falcon-7B (tiiuae/falcon-7b): 32 layers of 4544, 71 heads of 64 over one
# KV head (G 71), the parallel-shared block, no biases, vocab 65024
FALCON_7B = dict(
    model_type="falcon", hidden_size=4544, num_attention_heads=71,
    num_hidden_layers=32, vocab_size=65024, multi_query=True,
    parallel_attn=True, new_decoder_architecture=False, bias=False,
    alibi=False, layer_norm_epsilon=1e-5)
# GPT-Neo-1.3B (EleutherAI/gpt-neo-1.3B): 24 layers of 2048 alternating
# global and local (window 256), 16 heads of 128, learned positions,
# no 1/sqrt(D) scaling, vocab 50257
GPT_NEO_1_3B = dict(
    model_type="gpt_neo", hidden_size=2048, num_heads=16, num_layers=24,
    num_hidden_layers=24, attention_layers=["global", "local"] * 12,
    window_size=256, max_position_embeddings=2048, vocab_size=50257,
    activation_function="gelu_new", layer_norm_epsilon=1e-5)
# (a): the decode kernels at G 48 / D 128 and G 71 / D 64 (one KV head):
#   the paged kernel on phase 26's batch (B 8, lens 37-2000, block 32),
#   the contiguous one at B 4, S 2048; bf16 and fp32 activations over
#   caches of their dtype, and bf16 over scaled fp8 pages
WIDE_GROUPS = {"g48_d128": dict(hq=48, hkv=1, d=128),
               "g71_d64": dict(hq=71, hkv=1, d=64)}
WIDE_PAGE_DTYPES = ("bfloat16", "float32", "float8_e4m3fn")
WIDE_CACHE_DTYPES = ("bfloat16", "float32")
WIDE_CONTIG = dict(s=2048, lens=(300, 900, 1500, 2000))
WIDE_FP8_SCALE = 0.5
# (b): StarCoder on phase 9's engine and mix, 10 of its 40 layers (every
#   layer alike; the room of the 950 s target); (c) Command-R7B on phase
#   19's engine and mix, 8 of 32 layers (two of its 3:1 periods)
STARCODER_SERVE_LAYERS = 10
COMMAND_R_SERVE_LAYERS = 8
# (d): the fp32 cuts on the contiguous app (batch 4, bucket 512)
CONTRIB_DENSE2_CHECK_LAYERS = 2
CONTRIB_DENSE2_BUDGET_S = 90


def starcoder_cut(layers):
    """StarCoder cut to ``layers`` layers (``n_layer`` with it)."""
    return dict(STARCODER, n_layer=layers, num_hidden_layers=layers)


def gpt_neo_cut(layers):
    """GPT-Neo-1.3B cut to its first ``layers`` layers (global, local,
    ...)."""
    return dict(GPT_NEO_1_3B, num_layers=layers, num_hidden_layers=layers,
                attention_layers=GPT_NEO_1_3B["attention_layers"][:layers])


def check_contrib_dense2_specs():
    """Gate: StarCoder resolves to G 48 (one KV head) at head_dim 128 with
    learned positions and no rotation, Falcon-7B to G 71 at head_dim 64,
    Command-R7B to G 4 with the 3:1 sliding / NoPE pattern at window 4096
    and the parallel-shared block, GPT-Neo-1.3B to its alternating pattern
    at window 256 with ``attn_scale`` 1.0; and the decode kernels' gates
    (``supports``, the paged and the contiguous branches') admit each of
    them: no group term, as the reference's."""
    import torch
    from neuronx_distributed_inference_tpu_torch.models import model_base
    from neuronx_distributed_inference_tpu_torch.ops import decode_attention
    specs = {"starcoder": family_spec(STARCODER, seq_len=4096),
             "falcon_7b": family_spec(FALCON_7B, seq_len=2048),
             "command_r7b": family_spec(COMMAND_R7B, seq_len=8192),
             "gpt_neo_1_3b": family_spec(GPT_NEO_1_3B, seq_len=2048)}
    cache = {"k": torch.empty((1, 4, 1, 1, 1), dtype=torch.bfloat16)}
    got = {name: {
        "group": s.gqa.q_per_kv, "kv_heads": s.num_kv_heads,
        "head_dim": s.head_dim, "learned_pos": s.learned_pos,
        "no_rope": s.no_rope, "block_style": s.block_style,
        "window": s.sliding_window, "nope_global": s.nope_global,
        "pattern_local_layers": sum(map(bool, s.layer_pattern or ())),
        "attn_scale": s.attn_scale, "padded_vocab": s.padded_vocab,
        "chunks": decode_attention.group_chunks(s.gqa.q_per_kv),
        "gates": {"supports": decode_attention.supports(s, 1),
                  "paged": model_base.use_decode_kernel(s, 1,
                                                        torch.bfloat16),
                  "contiguous": model_base.use_contiguous_decode_kernel(
                      s, 1, 4, cache, True)}}
        for name, s in specs.items()}
    emit({"phase": "contrib_dense2_specs", **got})
    sc, fa, cr, neo = (specs[n] for n in ("starcoder", "falcon_7b",
                                          "command_r7b", "gpt_neo_1_3b"))
    ok = (sc.gqa.q_per_kv == 48 and sc.num_kv_heads == 1
          and sc.head_dim == 128 and sc.learned_pos == 8192 and sc.no_rope
          and sc.qkv_bias and not sc.mlp_glu and sc.tie_word_embeddings
          and fa.gqa.q_per_kv == 71 and fa.head_dim == 64
          and fa.block_style == "parallel_shared"
          and cr.gqa.q_per_kv == 4 and cr.sliding_window == 4096
          and cr.layer_pattern == tuple(
              t == "sliding_attention" for t in COMMAND_R7B["layer_types"])
          and cr.nope_global and cr.block_style == "parallel_shared"
          and cr.logits_divide == 4.0
          and neo.layer_pattern == (False, True) * 12
          and neo.sliding_window == 256 and neo.attn_scale == 1.0
          and all(all(v["gates"].values()) for v in got.values()))
    if not ok:
        raise AssertionError(f"contrib_dense2 specs: {got}")


def wide_kernel_inputs(group, dtype, device, gen, kind):
    """(a)'s inputs at WIDE_GROUPS[group] for the paged kernel (``kind``
    "paged": phase 26's batch, block 32) or the contiguous one
    ("contig": WIDE_CONTIG) over a cache of ``dtype`` (fp32 runs fp32
    activations, the rest bf16; fp8 scaled by WIDE_FP8_SCALE), and the
    kernel's keyword arguments."""
    import torch
    c = WIDE_GROUPS[group]
    dt = getattr(torch, dtype)
    act = torch.float32 if dt == torch.float32 else torch.bfloat16
    kv_scale = WIDE_FP8_SCALE if dt == torch.float8_e4m3fn else None
    kw = dict(scale=c["d"] ** -0.5)
    if kv_scale is not None:
        kw["kv_scale"] = kv_scale
    if kind == "paged":
        lens = list(CONTRIB_DENSE_KERNEL_LENS)
        return paged_inputs(gen, device, b=len(lens), bs=32,
                            mb=-(-(max(lens) + 1) // 32), lens=lens,
                            act_dtype=act, page_dtype=dt, kv_scale=kv_scale,
                            **c), kw
    lens = list(WIDE_CONTIG["lens"])
    return contiguous_inputs(gen, device, b=len(lens), s=WIDE_CONTIG["s"],
                             lens=lens, act_dtype=act, cache_dtype=dt,
                             kv_scale=kv_scale, **c), kw


def _phase_wide_group_kernels(device):
    """27 (a): both decode kernels at G 48 / D 128 and G 71 / D 64 over one
    KV head (3 and 5 chunks of at most 16 query heads, one launch), bf16
    and fp32 activations over caches of their dtype and (paged) bf16 over
    scaled fp8 pages, each within contrib_kernel_tol of its twin, with a
    control on bf16 (the twin's heads shifted by one chunk of 16, the
    output a chunk-offset fault would give) that must part beyond it; each
    then timed by CUDA-graph replay beside the twin, SDPA (``enable_gqa``)
    over the pre-gathered keys (dequantized for fp8) and the bound (K/V
    read once). Returns {(kind, case): numbers}."""
    import torch
    import torch.nn.functional as F
    from neuronx_distributed_inference_tpu_torch.ops import decode_attention
    gen = torch.Generator(device=device).manual_seed(27)
    out = {}
    da = decode_attention

    def gate(kernel, name, geometry, got, want):
        tol = contrib_kernel_tol(want)
        err = (got.float() - want.float()).abs().max().item()
        bf16 = want.dtype == torch.bfloat16
        ctl = ((got.float() - want.float().roll(16, dims=1)).abs().max()
               .item() if bf16 else None)
        emit({"phase": "contrib_dense2_kernel_vs_twin", "kernel": kernel,
              "case": name, "geometry": geometry, "max_abs_err": err,
              "tol": tol, "control_heads_shifted_16_max_abs_err": ctl})
        if not (torch.isfinite(got.float()).all() and err <= tol):
            raise AssertionError(f"{kernel} {name}: {err} > {tol}")
        if ctl is not None and not ctl > tol:
            raise AssertionError(f"{kernel} {name}: the shifted-heads "
                                 f"control sits within {tol} ({ctl})")
        return err
    for group, c in WIDE_GROUPS.items():
        g = c["hq"] // c["hkv"]
        geometry = dict(c, G=g, chunks=da.group_chunks(g))
        for dtype in WIDE_PAGE_DTYPES:
            name = f"{group}_{dtype}"
            x, kw = wide_kernel_inputs(group, dtype, device, gen, "paged")
            args = (x["q"], x["k_pages"], x["v_pages"], x["new_k"],
                    x["new_v"], 0, x["lens"], x["block_table"])
            shape = dict(geometry, B=len(x["lens"]), Bs=32, pages=dtype,
                         lens=list(CONTRIB_DENSE_KERNEL_LENS))
            err = gate("paged_decode_attention", name, shape,
                       da.paged_decode_attention(*args, **kw),
                       da.paged_decode_attention_plain(*args, **kw))
            q4, k4, v4, m4 = sdpa_inputs(dict(x, **{
                n: dequantized_pages(x[n], 0, kw.get("kv_scale")).to(
                    x["q"].dtype) for n in ("k_pages", "v_pages")}), 0)
            out[("paged", name)] = timed_kernel(
                lambda: da.paged_decode_attention(*args, **kw),
                lambda: da.paged_decode_attention_plain(*args, **kw),
                lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, attn_mask=m4, scale=kw["scale"],
                    enable_gqa=True),
                kernel_bounds(x), err, dict(shape, splits=da.num_splits(
                    len(x["lens"]), 1, x["block_table"].shape[1], 32,
                    c["d"], g)))
            del x, args, q4, k4, v4, m4
        for dtype in WIDE_CACHE_DTYPES:
            name = f"{group}_{dtype}"
            x, kw = wide_kernel_inputs(group, dtype, device, gen, "contig")
            dargs, dkw = decode_args(x, kw)
            shape = dict(geometry, B=len(WIDE_CONTIG["lens"]),
                         S=WIDE_CONTIG["s"], cache=dtype,
                         lens=list(WIDE_CONTIG["lens"]))
            err = gate("decode_attention_stacked", name, shape,
                       da.decode_attention_stacked(*dargs, **dkw),
                       da.decode_attention_stacked_plain(*dargs, **dkw))
            q4, k4, v4, m4 = contiguous_sdpa_inputs(x, 0)
            out[("contig", name)] = timed_kernel(
                lambda: da.decode_attention_stacked(*dargs, **dkw),
                lambda: da.decode_attention_stacked_plain(*dargs, **dkw),
                lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, attn_mask=m4, scale=kw["scale"],
                    enable_gqa=True),
                decode_bounds(x), err, dict(
                    shape, splits=da.contiguous_num_splits(
                        len(WIDE_CONTIG["lens"]), 1, WIDE_CONTIG["s"],
                        c["d"], g)))
            del x, dargs, q4, k4, v4, m4
    names = {"paged": "paged_decode_attention",
             "contig": "decode_attention_stacked"}
    for (kind, name), t in out.items():
        emit({"phase": "contrib_dense2_kernel_timings",
              "kernel": names[kind], "case": name,
              "kernel_us": t["ms"] * 1e3, "bound_us": t["bound_ms"] * 1e3,
              "bound_by": t["bound_by"], "plain_us": t["plain_ms"] * 1e3,
              "library_us": t["library_ms"] * 1e3, "library": "SDPA",
              "max_abs_err": t["err"], "shape": t["shape"]})
    # comparison launches are not main-path launches
    reset_launches()
    torch.cuda.empty_cache()
    return out


def phase_contrib_dense2(device):
    """Group ``contrib_dense2`` (phase 27 (a)-(d)); returns its kernels-line
    entries: the paged kernel over StarCoder's served cache at G 48 (with
    (b)'s launches) and over Command-R7B's at a sliding and a NoPE layer
    (with (c)'s), and the contiguous decode and flash kernels at
    StarCoder's fp32 cut's shapes and dtype (with (d)'s launches)."""
    import torch
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    check_contrib_dense2_specs()
    _phase_wide_group_kernels(device)
    memory_note("contrib_dense2_kernels")
    entries = phase_dense_serving(
        starcoder_cut(STARCODER_SERVE_LAYERS), device, RAGGED,
        "starcoder_serving", (-1,), group=48, batch=8)
    entries += phase_dense_serving(
        dense_cut(COMMAND_R7B, COMMAND_R_SERVE_LAYERS), device,
        DENSE_SERVE, "command_r7b_serving", (-2, -1), group=4)
    with fp32_exact():
        cuts = {name: contrib_dense_fp32_cut(name, hf, device) for name, hf
                in (("starcoder", starcoder_cut(
                        CONTRIB_DENSE2_CHECK_LAYERS)),
                    ("falcon_7b", dict(
                        FALCON_7B,
                        num_hidden_layers=CONTRIB_DENSE2_CHECK_LAYERS)),
                    ("gpt_neo_1_3b", gpt_neo_cut(
                        CONTRIB_DENSE2_CHECK_LAYERS)))}
    decode_launches, flash_launches, times = cuts["starcoder"]
    entries += contiguous_kernel_entries(times, decode_launches,
                                         flash_launches,
                                         "contrib_dense_fp32_starcoder")
    seconds = time.perf_counter() - t0
    emit({"phase": "contrib_dense2_done", "seconds": seconds,
          "budget_s": CONTRIB_DENSE2_BUDGET_S})
    if seconds > CONTRIB_DENSE2_BUDGET_S:
        raise AssertionError(
            f"contrib_dense2 group took {seconds:.1f} s, over its budget "
            f"of {CONTRIB_DENSE2_BUDGET_S} s")
    return entries


# ---------------------------------------------------------------------------
# Phase 28: tensor parallelism
# ---------------------------------------------------------------------------

# Qwen2.5-72B (HF config.json of Qwen/Qwen2.5-72B, written by hand; least
# certain: rms_norm_eps and max_position_embeddings)
QWEN25_72B = dict(
    model_type="qwen2", hidden_size=8192, intermediate_size=29568,
    num_hidden_layers=80, num_attention_heads=64, num_key_value_heads=8,
    vocab_size=152064, rms_norm_eps=1e-6, rope_theta=1000000.0,
    max_position_embeddings=32768, hidden_act="silu",
    tie_word_embeddings=False)
TP_SERVE_LAYERS = 2        # 80 -> 2: ~8.5 GB of bf16
#                            weights at tp 1
TP_CHECK_LAYERS = 2        # (c): the fp32 cut
TP_WORLD_TIMEOUT_S = 400   # the two spawned ranks, init and join
TP_BUDGET_S = 90
# (c): the suite's fp32 tolerance (tests/test_llama_golden.py:63) and the
# reference's pin of its int8-ring decode logits against the fp32
# collective stream (tests/test_quantized_collectives.py:163)
TOL_TP_FP32 = dict(atol=2e-3, rtol=1e-3)
TOL_TP_RING_INT8 = 0.03


class CollectiveSpy:
    """Counts the model's collectives (``parallel/collectives.all_reduce``
    and ``all_gather``, which the steps call by module attribute) by
    whether a CUDA graph was capturing when they were made."""

    def __enter__(self):
        import torch
        from neuronx_distributed_inference_tpu_torch.parallel import \
            collectives as coll
        self._coll = coll
        self._orig = {n: getattr(coll, n) for n in ("all_reduce",
                                                     "all_gather")}
        self.captured = {n: 0 for n in self._orig}
        self.eager = {n: 0 for n in self._orig}

        def spy(name):
            def call(*a, **k):
                box = (self.captured if torch.cuda.is_available()
                       and torch.cuda.is_current_stream_capturing()
                       else self.eager)
                box[name] += 1
                return self._orig[name](*a, **k)
            return call
        for n in self._orig:
            setattr(coll, n, spy(n))
        return self

    def __exit__(self, *exc):
        for n, fn in self._orig.items():
            setattr(self._coll, n, fn)


def tp_prompts(hf, cfg):
    import numpy as np
    rng = np.random.default_rng(2)
    return [rng.integers(1, hf["vocab_size"], size=n).tolist()
            for n in cfg["lens"]]


def tp_serve(app, prompts, cfg, new_tokens, phase, sync, profile=None,
             snap=None):
    """Phase 9's engine and schedule over ``app`` (``cfg``: its seq_len,
    chunk and prompts' lens): (streams, per-pass records, TTFT, the paged
    kernel's launches, the all-decode steps); ``snap`` (a dict) receives
    the served cache's decode shapes while every row is live."""
    eng = ragged_engine(app, True, cfg)
    ad = eng.adapter

    def snapshot():
        if snap is not None and len(ad.seqs) == len(prompts) \
                and not ad.pending_prefill_ids:
            live = sorted(ad.seqs)
            snap["table"] = app.kv_mgr.block_table_array(
                live, app._bt_width_for(live))
            snap["pos"] = [ad.seqs[s].position for s in live]
    reset_launches([app])
    streams, recs, ttft = serve_schedule(eng, prompts, new_tokens, sync,
                                         profile, snapshot)
    launches = kernel_counts([app])["paged_decode_attention"]
    steps, _ = check_ragged_passes(phase, recs, launches,
                                   app.spec.num_layers)
    check_streams(phase, streams, new_tokens, app.spec.vocab_size)
    return [list(st.tokens) for st in streams], recs, ttft, launches, steps


def _step_logits(logits, lens):
    """``generate``'s logits of every step as (B, V) host arrays: the
    prefill's at each row's last prompt position, then each decode
    step's."""
    import numpy as np
    first = _host(logits[0])
    out = [first[np.arange(len(lens)), np.asarray(lens) - 1]]
    return out + [_host(x)[:, -1] for x in logits[1:]]


def _sync(device):
    import torch
    return (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))


def tp_world1(hf, device, cfg, prompts, new_tokens, tmpdir):
    """28 (a): world size 1 in this process (NCCL on the card, gloo in a
    CPU rehearsal). Phase 9's ragged engine and mix on the app built over
    the mesh (bf16, graphs captured by ``precompile`` with the model's
    collectives inside) and on the same app built without a process
    group, on the same weights: the streams equal bit for bit; the paged
    kernel launches layers x the all-decode steps. Returns (the app
    without a group, its streams, the paged kernel's entry at these
    shapes or None off the card)."""
    import os

    import torch.distributed as dist
    from neuronx_distributed_inference_tpu_torch.parallel.mesh import (
        MeshConfig, build_mesh, initialize_distributed)
    phase = "tp_world1"
    on_card = device.type == "cuda"
    sync = _sync(device)
    ref = make_ragged_app(hf, device, "bfloat16", cfg)
    init_weights(ref, 0)
    warm(ref, phase + "_ref", chunk_tokens=cfg["chunk"])
    want, _, _, ref_launches, _ = tp_serve(ref, prompts, cfg, new_tokens,
                                           phase + "_ref", sync)
    initialize_distributed("nccl" if on_card else "gloo",
                           store=dist.FileStore(os.path.join(
                               tmpdir, "world1"), 1),
                           rank=0, world_size=1)
    try:
        mesh = build_mesh(MeshConfig(tp=1), device)
        app = make_ragged_app(hf, device, "bfloat16", cfg, mesh=mesh)
        app.params = ref.params
        with CollectiveSpy() as spy:
            warm(app, phase, chunk_tokens=cfg["chunk"])
        snap = {}
        got, recs, ttft, launches, steps = tp_serve(
            app, prompts, cfg, new_tokens, phase, sync,
            # 3 and 1 traced passes (each trace costs about a second)
            pass_profile(on_card, decode=3, mixed=1), snap)
        t = (time_paged_kernel(app, snap["table"], snap["pos"], device,
                               seed=9) if on_card else None)
    finally:
        dist.destroy_process_group()
    layers = hf["num_hidden_layers"]
    want_launches = layers * steps if on_card else 0
    emit({"phase": phase, "backend": mesh.backend, "tp": mesh.tp,
          "layers": layers, "passes": len(recs),
          "passes_by_kind": {k: sum(1 for r in recs if r["kind"] == k)
                             for k in ("mixed", "decode", "idle")},
          "launches": launches, "expected_launches": want_launches,
          "launches_without_group": ref_launches,
          "collectives_captured": spy.captured,
          "collectives_eager": spy.eager,
          "graphs": graph_report(app) if app.graphs is not None else None,
          "streams_equal": got == want,
          "host_ms_decode": pass_summary(recs, "decode"),
          "host_ms_mixed": pass_summary(recs, "mixed"),
          "ttft_s": [ttft.get(i) for i in range(len(prompts))]})
    emit({"phase": phase + "_profile_decode",
          **profile_summary(recs, "decode")})
    emit({"phase": phase + "_profile_mixed",
          **profile_summary(recs, "mixed")})
    check_no_incidents(phase, app)
    if launches != want_launches or ref_launches != launches:
        raise AssertionError(f"{phase}: paged launches {launches} (without "
                             f"a group {ref_launches}) != {want_launches}")
    # every captured step holds its collectives: the embedding's sum, two
    # row-parallel sums a layer, and the logits' gather
    made = spy.captured if on_card else spy.eager
    if not (made["all_reduce"] >= 1 + 2 * layers
            and made["all_gather"] >= 1):
        raise AssertionError(f"{phase}: collectives {made} (captured: "
                             f"{on_card})")
    if got != want:
        diff = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
        raise AssertionError(f"{phase}: stream {diff} differs from the app "
                             "without a process group")
    entry = None
    if on_card:
        emit({"phase": phase + "_kernel_timings", **t["report"],
              "launches": launches})
        entry = paged_kernel_entry(t, launches, phase)
    del app
    return ref, want, entry


def _host(x):
    import numpy as np
    return np.asarray(x.cpu() if hasattr(x, "cpu") else x)


def tp_rank(mesh, hf, cfg, prompts, new_tokens, cut, check_cfg, ids, mask,
            check_new):
    """28 (b) and (c) on one spawned rank (two ranks on one card over
    gloo, every step eager): rank 0 serves phase 9's engine and mix
    (``cfg``, ``prompts``) over the rank's slice of ``hf`` (Qwen2.5-72B:
    Hq 32, Hkv 4 a rank), the other follows; then the fp32 ``cut`` on the
    contiguous app with both kernels asked for, ``generate`` of ``ids``
    over the plain collectives, then over the int8 ring fed the plain
    stream's tokens (teacher forcing: both streams' logits at the same
    inputs). Returns each rank's numbers (rank 0's with the streams, each
    step's (B, V) logits and, on the card, the kernels' timings). Rank 0
    times the paged kernel while the other rank waits between two
    barriers, its card idle."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from neuronx_distributed_inference_tpu_torch.config import \
        CollectiveConfig
    from neuronx_distributed_inference_tpu_torch.models import model_base
    dev = mesh.device
    on_card = dev.type == "cuda"
    lead = mesh.leads
    out = {"rank": mesh.rank}
    app = make_ragged_app(hf, dev, "bfloat16", cfg, mesh=mesh,
                          graphs=False)
    init_weights(app, 0)
    specs = model_base.decoder_param_specs(app.full_spec)
    repl = 0
    for key, node in specs.items():
        for name, ps in (node.items() if isinstance(node, dict)
                         else [(None, node)]):
            if not ps.cuts:
                repl += param_bytes(app.params[key][name] if name
                                    else app.params[key])
    out.update(weight_bytes=param_bytes(app.params), replicated_bytes=repl,
               heads=[app.spec.gqa.num_q_heads, app.spec.gqa.num_kv_heads],
               cache_kv_heads=int(app.cache["k"].shape[3]))
    if lead:
        snap = {}
        with PagedArgsSpy() as spy:
            streams, recs, ttft, launches, steps = tp_serve(
                app, prompts, cfg, new_tokens, "tp_two_ranks", _sync(dev),
                snap=snap)
        app.stop_followers()
        # the follower's card falls idle before the timing (barrier 1) and
        # stays so until it ends (barrier 2)
        dist.barrier(group=mesh.group)
        out.update(streams=streams, launches=launches, steps=steps,
                   groups=sorted(spy.groups),
                   passes_by_kind={k: sum(1 for r in recs if r["kind"] == k)
                                   for k in ("mixed", "decode", "idle")},
                   host_ms_decode=pass_summary(recs, "decode"),
                   host_ms_mixed=pass_summary(recs, "mixed"),
                   ttft_s=[ttft.get(i) for i in range(len(prompts))],
                   dispatch=dict(app.dispatch_stats))
        if on_card:
            out["kernel"] = time_paged_kernel(app, snap["table"],
                                              snap["pos"], dev, seed=9)
        dist.barrier(group=mesh.group)
    else:
        reset_launches([app])
        app.follow()
        out["launches"] = kernel_counts([app])["paged_decode_attention"]
        if on_card:
            torch.cuda.synchronize(dev)
        dist.barrier(group=mesh.group)
        dist.barrier(group=mesh.group)
    del app
    if on_card:
        free_card()
    lens = [int(n) for n in mask.sum(axis=1)]
    with fp32_exact():
        capp = make_contiguous_app(cut, dev, "float32", batch=len(lens),
                                   seq_len=check_cfg["seq_len"],
                                   decode_kernel=True, output_logits=True,
                                   graphs=False, mesh=mesh)
        init_weights(capp, 0)
        reset_launches()
        with ContiguousArgsSpy() as cspy, FlashShapes() as flash:
            if lead:
                r = capp.generate(ids, attention_mask=mask,
                                  max_new_tokens=check_new,
                                  return_logits=True)
                capp.stop_followers()
            else:
                capp.follow()
        out["fp32_counts"] = kernel_counts()
        qapp = make_contiguous_app(
            cut, dev, "float32", batch=len(lens),
            seq_len=check_cfg["seq_len"], decode_kernel=True,
            output_logits=True, graphs=False, mesh=mesh,
            collective_config=CollectiveConfig(dtype="int8"))
        qapp.params = capp.params
        if lead:
            toks = np.asarray(r["generated"])
            q = qapp.generate(ids, attention_mask=mask,
                              max_new_tokens=check_new, return_logits=True,
                              teacher_tokens=toks[:, :-1])
            qapp.stop_followers()
            out.update(fp32_tokens=toks,
                       fp32_logits=_step_logits(r["logits"], lens),
                       int8_logits=_step_logits(q["logits"], lens),
                       flash_calls=[[list(c[0]), list(c[1])]
                                    for c in flash.calls])
            if on_card:
                spec = capp.spec
                out["fp32_times"] = dbrx_fp32_kernels(
                    dev, cspy.ints, flash.calls,
                    [n + check_new - 2 for n in lens],
                    dict(scale=spec.scale, window=spec.sliding_window,
                         soft_cap=spec.attn_soft_cap), phase="tp_fp32_cut")
        else:
            qapp.follow()
    return out


def tp_two_ranks_check(ref, hf, cfg, prompts, want_a, ranks):
    """28 (b)'s gates on the ranks' numbers: each rank's weight bytes at
    most 0.51 of (a)'s plus its replicated leaves, half of the heads a
    rank (its cache, and every paged launch at the model's group),
    launches = layers x the all-decode steps on both ranks, the streams
    held to (a)'s weights by the teacher-deficit gate (a contiguous app on
    (a)'s weights fed each stream) with its shifted control. Returns the
    paged kernel's entry at the ranks' shapes (None off the card)."""
    phase = "tp_two_ranks"
    on_card = ref.device.type == "cuda"
    lead = ranks[0]
    layers = ref.spec.num_layers
    g = ref.spec.gqa
    heads = [g.num_q_heads // len(ranks), g.num_kv_heads // len(ranks)]
    a_bytes = param_bytes(ref.params)
    want_launches = layers * lead["steps"] if on_card else 0
    emit({"phase": phase, "backend": "gloo", "tp": len(ranks),
          "layers": layers, "weight_gb_tp1": a_bytes / 1e9,
          "weight_gb_ranks": [r["weight_bytes"] / 1e9 for r in ranks],
          "replicated_gb_ranks": [r["replicated_bytes"] / 1e9
                                  for r in ranks],
          "heads_ranks": [r["heads"] for r in ranks],
          "cache_kv_heads": [r["cache_kv_heads"] for r in ranks],
          "launches_ranks": [r["launches"] for r in ranks],
          "expected_launches": want_launches, "groups": lead["groups"],
          "passes_by_kind": lead["passes_by_kind"],
          "host_ms_decode": lead["host_ms_decode"],
          "host_ms_mixed": lead["host_ms_mixed"],
          "ttft_s": lead["ttft_s"], "dispatch_records":
          lead["dispatch"]["records"], "dispatch_broadcast_us_each":
          1e6 * lead["dispatch"]["broadcast_s"]
          / max(lead["dispatch"]["records"], 1),
          "streams_equal_world1": lead["streams"] == want_a})
    for r in ranks:
        if r["weight_bytes"] > 0.51 * a_bytes + r["replicated_bytes"]:
            raise AssertionError(f"{phase}: rank {r['rank']} holds "
                                 f"{r['weight_bytes']} weight bytes of "
                                 f"{a_bytes}")
        if r["heads"] != heads or r["cache_kv_heads"] != heads[1]:
            raise AssertionError(f"{phase}: rank {r['rank']} heads "
                                 f"{r['heads']}, cache {r['cache_kv_heads']}")
        if r["launches"] != want_launches:
            raise AssertionError(f"{phase}: rank {r['rank']} launched the "
                                 f"paged kernel {r['launches']} times, "
                                 f"want {want_launches}")
    if lead["groups"] != [g.q_per_kv]:
        raise AssertionError(f"{phase}: paged launches at groups "
                             f"{lead['groups']}")
    teacher = make_contiguous_app(hf, ref.device, "bfloat16", batch=8,
                                  seq_len=cfg["seq_len"], output_logits=True)
    teacher.params = ref.params
    deficit_gate(phase, teacher_deficits(teacher, prompts, lead["streams"]),
                 exact=False)
    del teacher
    if not on_card:
        return None
    t = lead["kernel"]
    emit({"phase": phase + "_kernel_timings", **t["report"],
          "launches": lead["launches"]})
    return paged_kernel_entry(t, lead["launches"], phase)


def tp_fp32_check(device, cut, check_cfg, ids, mask, check_new, ranks):
    """28 (c)'s gates: the tp-2 fp32 cut's tokens equal the same weights'
    at tp 1 (this process, no group) and its logits within the suite's
    tolerance; each rank launched flash once a layer and the contiguous
    decode kernel at every layer of every decode step, on its local heads;
    the int8 ring's decode logits, fed the fp32 collectives' tokens, within
    the reference's pin of theirs (3% of the largest logit) and the same
    greedy choice but at a near-tie: an fp32 top-2 gap within twice the
    ring's largest deviation at that row and step (printed). Twice,
    because a flip needs the two tokens' logits to cross, and each may
    move by up to that deviation, the one up and the other down: the ring
    alone flips gaps up to 2x, and no wider. Returns the decode and flash
    kernels' entries at the ranks' shapes (none off the card)."""
    import numpy as np
    phase = "tp_fp32_cut"
    on_card = device.type == "cuda"
    lead = ranks[0]
    layers = cut["num_hidden_layers"]
    with fp32_exact():
        one = make_contiguous_app(cut, device, "float32", batch=len(ids),
                                  seq_len=check_cfg["seq_len"],
                                  decode_kernel=True, output_logits=True,
                                  graphs=False)
        init_weights(one, 0)
        r1 = one.generate(ids, attention_mask=mask, max_new_tokens=check_new,
                          return_logits=True)
        heads = [one.spec.gqa.num_q_heads // len(ranks),
                 one.spec.gqa.num_kv_heads // len(ranks)]
    del one
    if on_card:
        free_card()
    want_counts = {"paged_decode_attention": 0,
                   "decode_attention_stacked": (layers * (check_new - 1)
                                                if on_card else 0),
                   "flash_attention": layers if on_card else 0}
    got_t, want_t = lead["fp32_tokens"], np.asarray(r1["generated"])
    lens = mask.sum(axis=1)
    excess = max(float(np.max(np.abs(a - b) - TOL_TP_FP32["rtol"]
                              * np.abs(b)))
                 for a, b in zip(lead["fp32_logits"],
                                 _step_logits(r1["logits"], lens)))
    ring, flips = [], []
    for j, (a, b) in enumerate(zip(lead["int8_logits"][1:],
                                   lead["fp32_logits"][1:]), 1):
        ring.append(float(np.abs(a - b).max() / np.abs(b).max()))
        for i in np.nonzero(a.argmax(-1) != b.argmax(-1))[0]:
            top2 = np.sort(b[i])[-2:]
            dev = float(np.abs(a[i] - b[i]).max())
            flips.append((int(i), j, float(top2[1] - top2[0]), dev))
    emit({"phase": phase, "tp": len(ranks), "layers": layers,
          "counts_ranks": [r["fp32_counts"] for r in ranks],
          "expected_counts": want_counts,
          "flash_calls": lead["flash_calls"][:1],
          "tokens_equal_tp1": bool((got_t == want_t).all()),
          "max_logit_excess_over_rtol": excess, "tol": TOL_TP_FP32,
          "int8_decode_rel": ring, "int8_tol": TOL_TP_RING_INT8,
          "int8_argmax_flips": flips})
    for r in ranks:
        if r["fp32_counts"] != want_counts:
            raise AssertionError(f"{phase}: rank {r['rank']} launches "
                                 f"{r['fp32_counts']} != {want_counts}")
    if on_card:
        q_shape, k_shape = lead["flash_calls"][0]
        if [q_shape[2], k_shape[2]] != heads:
            raise AssertionError(f"{phase}: flash at {q_shape} / {k_shape}, "
                                 f"want heads {heads}")
    if not (got_t == want_t).all():
        raise AssertionError(f"{phase}: tokens at tp 2 differ from tp 1")
    if not excess <= TOL_TP_FP32["atol"]:
        raise AssertionError(f"{phase}: logits off tp 1 by {excess} over "
                             "the relative tolerance")
    if max(ring) >= TOL_TP_RING_INT8:
        raise AssertionError(f"{phase}: int8 ring decode logits {ring}")
    far = [f for f in flips if not f[2] <= 2 * f[3]]
    if far:
        raise AssertionError(f"{phase}: int8 ring parts from greedy beyond "
                             f"a near-tie: {far[:4]}")
    if not on_card:
        return []
    counts = lead["fp32_counts"]
    return contiguous_kernel_entries(
        lead["fp32_times"], counts["decode_attention_stacked"],
        counts["flash_attention"], phase)


def phase_tp(device, hf=None, cfg=RAGGED, new_tokens=RAGGED_TOKENS,
             cut=None, check_cfg=DENSE_CHECK, check_new=DENSE_CHECK_TOKENS):
    """Group ``tp`` (phase 28 (a)-(c)); returns its kernels-line entries:
    the paged kernel at (a)'s shapes (world size 1) and at (b)'s per-rank
    shapes, each with its run's launches, and the contiguous decode and
    flash kernels at (c)'s per-rank shapes with (c)'s launches. ``hf``,
    ``cut`` (default: Qwen2.5-72B at TP_SERVE_LAYERS and TP_CHECK_LAYERS),
    ``cfg``, ``check_cfg`` and the token counts let a CPU rehearsal run
    it at tiny widths."""
    import tempfile

    from neuronx_distributed_inference_tpu_torch.parallel.mesh import \
        spawn_world
    on_card = device.type == "cuda"
    t0 = time.perf_counter()
    if on_card:
        import torch
        torch.cuda.reset_peak_memory_stats()
    hf = hf or dict(QWEN25_72B, num_hidden_layers=TP_SERVE_LAYERS)
    cut = cut or dict(QWEN25_72B, num_hidden_layers=TP_CHECK_LAYERS)
    prompts = tp_prompts(hf, cfg)
    tmpdir = tempfile.mkdtemp(prefix="nxdi-tp-")
    ref, want_a, entry_a = tp_world1(hf, device, cfg, prompts, new_tokens,
                                     tmpdir)
    if on_card:
        memory_note("tp_world1")
    ids, mask = prompts_of(check_cfg["lens"], cut["vocab_size"], seed=28)
    t_spawn = time.perf_counter()
    # both ranks on this process's card (or the CPU in a rehearsal)
    rank_dev = f"cuda:{device.index or 0}" if on_card else "cpu"
    ranks = spawn_world(tp_rank, 2, "gloo", rank_dev, tmpdir,
                        TP_WORLD_TIMEOUT_S,
                        (hf, cfg, prompts, new_tokens, cut, check_cfg, ids,
                         mask, check_new))
    emit({"phase": "tp_world2_seconds",
          "seconds": time.perf_counter() - t_spawn})
    entry_b = tp_two_ranks_check(ref, hf, cfg, prompts, want_a, ranks)
    del ref
    if on_card:
        free_card()
    entries = [e for e in (entry_a, entry_b) if e is not None]
    entries += tp_fp32_check(device, cut, check_cfg, ids, mask, check_new,
                             ranks)
    if on_card:
        memory_note("tp")
    seconds = time.perf_counter() - t0
    emit({"phase": "tp_done", "seconds": seconds, "budget_s": TP_BUDGET_S})
    if on_card and seconds > TP_BUDGET_S:
        raise AssertionError(f"tp group took {seconds:.1f} s, over its "
                             f"budget of {TP_BUDGET_S} s")
    return entries


# ---------------------------------------------------------------------------
# Phase 29: expert parallelism
# ---------------------------------------------------------------------------

# Qwen3-235B-A22B (HF config.json of Qwen/Qwen3-235B-A22B, written by
# hand; least certain: rms_norm_eps and max_position_embeddings): 94
# layers, every one MoE, 128 experts of 1536 of which 8 route per token
QWEN3_235B_A22B = dict(
    model_type="qwen3_moe", hidden_size=4096, intermediate_size=12288,
    moe_intermediate_size=1536, num_hidden_layers=94, num_attention_heads=64,
    num_key_value_heads=4, head_dim=128, vocab_size=151936,
    num_experts=128, num_experts_per_tok=8, norm_topk_prob=True,
    decoder_sparse_step=1, mlp_only_layers=[], rms_norm_eps=1e-6,
    rope_theta=1000000.0, max_position_embeddings=40960, hidden_act="silu",
    sliding_window=None, tie_word_embeddings=False)
EP_SERVE_LAYERS = 2        # 94 -> 2: 9.66 GB of bf16 experts, 2.49 GB of
#                            embedding and head
EP_CHECK_LAYERS = 2        # (c): the fp32 cuts
EP_WORLD_TIMEOUT_S = 600   # the two spawned ranks, init and join
EP_BUDGET_S = 90
# (a), (b): a rank's share of the expert bytes at ep 2
EP_EXPERT_SHARE = 0.51


def pad_vocab_to(app, mp):
    """``app``'s full spec with the vocabulary padded as at ``mp`` ranks:
    a one-process app then draws the same weights from a seed as the
    ranks of that mesh (the padded rows shift every later draw)."""
    import dataclasses
    from neuronx_distributed_inference_tpu_torch.models import model_base
    app.full_spec = dataclasses.replace(
        app.full_spec, padded_vocab=model_base.pad_vocab(
            app.full_spec.vocab_size, mp))
    return app


def expert_bytes(params, suffix=""):
    """Bytes of a tree's expert weights (``expert_gate`` / ``_up`` /
    ``_down``; ``suffix`` "_tkg": their hybrid decode copies)."""
    from neuronx_distributed_inference_tpu_torch.modules.moe import \
        EXPERT_LEAVES
    return sum(param_bytes(node[name + suffix])
               for node in params.values() if isinstance(node, dict)
               for name in EXPERT_LEAVES if name + suffix in node)


def ep_serve_rank(mesh, hf, cfg, prompts, new_tokens, tkg):
    """29 (a) or, with ``tkg``, (b) on one rank of the ep-2 mesh (two
    ranks on one card over gloo, every step eager): rank 0 serves phase
    9's engine and mix, the other follows; the rank's expert bytes (and
    its hybrid copy's). In (a) rank 0 then times the paged kernel at its
    heads while the other rank waits between two barriers, its card
    idle."""
    import torch
    import torch.distributed as dist
    from neuronx_distributed_inference_tpu_torch.config import MoEConfig
    dev = mesh.device
    on_card = dev.type == "cuda"
    lead = mesh.leads
    over = ({} if not tkg else
            {"moe_config": MoEConfig(moe_tkg_ep_degree=1)})
    app = make_ragged_app(hf, dev, "bfloat16", cfg, mesh=mesh,
                          graphs=False, **over)
    init_weights(app, 0)
    out = {"rank": mesh.rank, "expert_bytes": expert_bytes(app.params),
           "tkg_bytes": expert_bytes(app.params, "_tkg"),
           "weight_bytes": param_bytes(app.params),
           "heads": [app.spec.gqa.num_q_heads, app.spec.gqa.num_kv_heads],
           "tkg_experts_local": app.spec.moe.tkg_experts_local}
    reset_launches([app])
    if lead:
        snap = {}
        with PagedArgsSpy() as spy, CollectiveSpy() as cspy:
            streams, recs, ttft, launches, steps = tp_serve(
                app, prompts, cfg, new_tokens,
                "ep_hybrid" if tkg else "ep_two_ranks", _sync(dev),
                snap=snap)
        app.stop_followers()
        dist.barrier(group=mesh.group)
        out.update(streams=streams, launches=launches, steps=steps,
                   groups=sorted(spy.groups), collectives=cspy.eager,
                   passes_by_kind={k: sum(1 for r in recs if r["kind"] == k)
                                   for k in ("mixed", "decode", "idle")},
                   host_ms_decode=pass_summary(recs, "decode"),
                   host_ms_mixed=pass_summary(recs, "mixed"),
                   ttft_s=[ttft.get(i) for i in range(len(prompts))])
        if on_card and not tkg:
            out["kernel"] = time_paged_kernel(app, snap["table"],
                                              snap["pos"], dev, seed=9)
        dist.barrier(group=mesh.group)
    else:
        app.follow()
        out["launches"] = kernel_counts([app])["paged_decode_attention"]
        if on_card:
            torch.cuda.synchronize(dev)
        dist.barrier(group=mesh.group)
        dist.barrier(group=mesh.group)
    del app
    if on_card:
        free_card()
    return out


def ep_fp32_rank(mesh, model, check_cfg, ids, mask, check_new, kernels):
    """29 (c) on one rank of the tp-2 mesh: the fp32 cut ``model`` on the
    contiguous app with both kernels asked for, ``generate`` of ``ids``
    (rank 0 drives); the kernels' launches and, on rank 0 where
    ``kernels``, the flash calls' shapes and the two kernels timed at the
    launches' shapes."""
    import numpy as np
    dev = mesh.device
    lead = mesh.leads
    lens = [int(n) for n in mask.sum(axis=1)]
    out = {}
    with fp32_exact():
        capp = make_contiguous_app(model, dev, "float32", batch=len(lens),
                                   seq_len=check_cfg["seq_len"],
                                   decode_kernel=True, output_logits=True,
                                   graphs=False, mesh=mesh)
        init_weights(capp, 0)
        reset_launches()
        with ContiguousArgsSpy() as cspy, FlashShapes() as flash:
            if lead:
                r = capp.generate(ids, attention_mask=mask,
                                  max_new_tokens=check_new,
                                  return_logits=True)
                capp.stop_followers()
            else:
                capp.follow()
        out["counts"] = kernel_counts()
        out["heads"] = [capp.spec.gqa.num_q_heads,
                        capp.spec.gqa.num_kv_heads]
        if lead:
            out.update(tokens=np.asarray(r["generated"]),
                       logits=_step_logits(r["logits"], lens),
                       flash_calls=[[list(c[0]), list(c[1])]
                                    for c in flash.calls])
            if kernels and dev.type == "cuda":
                spec = capp.spec
                out["times"] = dbrx_fp32_kernels(
                    dev, cspy.ints, flash.calls,
                    [n + check_new - 2 for n in lens],
                    dict(scale=spec.scale, window=spec.sliding_window,
                         soft_cap=spec.attn_soft_cap), phase="ep_fp32_cut")
    del capp
    return out


def ep_rank(mesh, hf, cfg, prompts, new_tokens, cuts, check_cfg, ids,
            mask, check_new):
    """Phase 29 on one spawned rank (the world's mesh is tp 2): (a) and
    (b) over the ep-2 mesh of the same two ranks (``MeshConfig(tp=1,
    ep=2)``: one expert half a rank), then (c)'s fp32 cuts over the tp-2
    mesh. Returns the rank's numbers."""
    from neuronx_distributed_inference_tpu_torch.parallel.mesh import (
        MeshConfig, build_mesh)
    ep_mesh = build_mesh(MeshConfig(tp=1, ep=2), mesh.device,
                         ranks=range(2))
    out = {"rank": mesh.rank, "mesh": [ep_mesh.ep, ep_mesh.tp]}
    for key, tkg in (("a", False), ("b", True)):
        out[key] = ep_serve_rank(ep_mesh, hf, cfg, prompts, new_tokens, tkg)
    for name, (model, kernels) in cuts.items():
        out[name] = ep_fp32_rank(mesh, model, check_cfg, ids, mask,
                                 check_new, kernels)
        if mesh.device.type == "cuda":
            free_card()
    return out


def ep_serving_check(hf, cfg, prompts, ranks, device):
    """29 (a), (b) gates: each rank's expert bytes at most EP_EXPERT_SHARE
    of the model's, (b)'s hybrid copy every expert at half the
    intermediate, half the heads a rank, launches = layers x the
    all-decode steps on both ranks at group 16, and both runs' streams
    held to a one-process app of the same weights by the teacher-deficit
    gate with its shifted control. Returns the paged kernel's entry at
    the ranks' shapes (None off the card)."""
    on_card = device.type == "cuda"
    layers = hf["num_hidden_layers"]
    whole = (3 * layers * hf["num_experts"] * hf["hidden_size"]
             * hf["moe_intermediate_size"] * 2)
    heads = [hf["num_attention_heads"] // 2, hf["num_key_value_heads"] // 2]
    teacher = pad_vocab_to(make_contiguous_app(
        hf, device, "bfloat16", batch=8, seq_len=cfg["seq_len"],
        output_logits=True), 2)
    init_weights(teacher, 0)
    entry = None
    for key, phase in (("a", "ep_two_ranks"), ("b", "ep_hybrid")):
        rk = [r[key] for r in ranks]
        lead = rk[0]
        want_launches = layers * lead["steps"] if on_card else 0
        emit({"phase": phase, "backend": "gloo", "mesh_ep_tp": ranks[0][
                  "mesh"], "layers": layers,
              "expert_gb_whole": whole / 1e9,
              "expert_gb_ranks": [r["expert_bytes"] / 1e9 for r in rk],
              "hybrid_copy_gb_ranks": [r["tkg_bytes"] / 1e9 for r in rk],
              "weight_gb_ranks": [r["weight_bytes"] / 1e9 for r in rk],
              "heads_ranks": [r["heads"] for r in rk],
              "launches_ranks": [r["launches"] for r in rk],
              "expected_launches": want_launches, "groups": lead["groups"],
              "collectives_rank0": lead["collectives"],
              "passes_by_kind": lead["passes_by_kind"],
              "host_ms_decode": lead["host_ms_decode"],
              "host_ms_mixed": lead["host_ms_mixed"],
              "ttft_s": lead["ttft_s"]})
        for r in rk:
            if r["expert_bytes"] > EP_EXPERT_SHARE * whole:
                raise AssertionError(f"{phase}: rank {r['rank']} holds "
                                     f"{r['expert_bytes']} expert bytes "
                                     f"of {whole}")
            if r["tkg_experts_local"] != (key == "b") or (
                    r["tkg_bytes"] != (r["expert_bytes"] if key == "b"
                                       else 0)):
                raise AssertionError(f"{phase}: rank {r['rank']} hybrid "
                                     f"copy of {r['tkg_bytes']} bytes")
            if r["heads"] != heads or r["launches"] != want_launches:
                raise AssertionError(f"{phase}: rank {r['rank']} heads "
                                     f"{r['heads']}, {r['launches']} paged "
                                     f"launches, want {want_launches}")
        if lead["groups"] != [heads[0] // heads[1]]:
            raise AssertionError(f"{phase}: paged launches at groups "
                                 f"{lead['groups']}")
        # the embedding's sum, then o_proj's and the MoE block's a layer
        n_red = lead["collectives"]["all_reduce"]
        if n_red % (1 + 2 * layers):
            raise AssertionError(f"{phase}: {n_red} all-reduces are not "
                                 f"whole steps of {1 + 2 * layers}")
        deficit_gate(phase, teacher_deficits(teacher, prompts,
                                             lead["streams"]), exact=False)
        if on_card and key == "a":
            t = lead["kernel"]
            emit({"phase": phase + "_kernel_timings", **t["report"],
                  "launches": lead["launches"]})
            entry = paged_kernel_entry(t, lead["launches"], phase)
    del teacher
    return entry


def ep_fp32_check(device, cuts, check_cfg, ids, mask, check_new, ranks):
    """29 (c) gates for each cut: tokens at tp 2 equal the same weights'
    at tp 1 (this process), logits within the suite's tolerance;
    Qwen3-235B-A22B launched flash once a layer and the contiguous decode
    kernel at every layer of every decode step on each rank's local
    heads, Moonlight (MLA) no kernel. Returns the decode and flash
    kernels' entries at the ranks' shapes (none off the card)."""
    import numpy as np
    on_card = device.type == "cuda"
    entries = []
    lens = mask.sum(axis=1)
    for name, (model, kernels) in cuts.items():
        phase = f"ep_fp32_{name}"
        rk = [r[name] for r in ranks]
        lead = rk[0]
        layers = model["num_hidden_layers"]
        with fp32_exact():
            one = pad_vocab_to(make_contiguous_app(
                model, device, "float32", batch=len(ids),
                seq_len=check_cfg["seq_len"], decode_kernel=True,
                output_logits=True, graphs=False), 2)
            init_weights(one, 0)
            r1 = one.generate(ids, attention_mask=mask,
                              max_new_tokens=check_new, return_logits=True)
            heads = [one.spec.gqa.num_q_heads // 2,
                     one.spec.gqa.num_kv_heads // 2]
        del one
        if on_card:
            free_card()
        on = on_card and kernels
        want = {"paged_decode_attention": 0,
                "decode_attention_stacked": (layers * (check_new - 1)
                                             if on else 0),
                "flash_attention": layers if on else 0}
        got_t, want_t = lead["tokens"], np.asarray(r1["generated"])
        excess = max(float(np.max(np.abs(a - b) - TOL_TP_FP32["rtol"]
                                  * np.abs(b)))
                     for a, b in zip(lead["logits"],
                                     _step_logits(r1["logits"], lens)))
        emit({"phase": phase, "tp": 2, "layers": layers,
              "counts_ranks": [r["counts"] for r in rk],
              "expected_counts": want, "heads_ranks": [r["heads"]
                                                       for r in rk],
              "flash_calls": lead["flash_calls"][:1],
              "tokens_equal_tp1": bool((got_t == want_t).all()),
              "max_logit_excess_over_rtol": excess, "tol": TOL_TP_FP32})
        for r in rk:
            if r["counts"] != want or r["heads"] != heads:
                raise AssertionError(f"{phase}: launches {r['counts']} != "
                                     f"{want}, heads {r['heads']}")
        if on:
            q_shape, k_shape = lead["flash_calls"][0]
            if [q_shape[2], k_shape[2]] != heads:
                raise AssertionError(f"{phase}: flash at {q_shape} / "
                                     f"{k_shape}, want heads {heads}")
        if not (got_t == want_t).all():
            raise AssertionError(f"{phase}: tokens at tp 2 differ from "
                                 "tp 1")
        if not excess <= TOL_TP_FP32["atol"]:
            raise AssertionError(f"{phase}: logits off tp 1 by {excess} "
                                 "over the relative tolerance")
        if on:
            c = lead["counts"]
            entries += contiguous_kernel_entries(
                lead["times"], c["decode_attention_stacked"],
                c["flash_attention"], phase)
    return entries


def phase_ep(device, hf=None, cfg=RAGGED, new_tokens=RAGGED_TOKENS,
             cuts=None, check_cfg=DENSE_CHECK, check_new=DENSE_CHECK_TOKENS):
    """Group ``ep`` (phase 29 (a)-(c)); returns its kernels-line entries:
    the paged kernel at (a)'s per-rank shapes with (a)'s launches, and the
    contiguous decode and flash kernels at (c)'s per-rank shapes with
    (c)'s launches. ``hf`` (default Qwen3-235B-A22B at EP_SERVE_LAYERS),
    ``cuts`` ({name: (model, kernels)}: Qwen3-235B-A22B and
    Moonlight-16B-A3B at EP_CHECK_LAYERS), ``cfg``, ``check_cfg`` and the
    token counts let a CPU rehearsal run it at tiny widths."""
    import tempfile

    from neuronx_distributed_inference_tpu_torch.parallel.mesh import \
        spawn_world
    on_card = device.type == "cuda"
    t0 = time.perf_counter()
    if on_card:
        import torch
        torch.cuda.reset_peak_memory_stats()
    hf = hf or dict(QWEN3_235B_A22B, num_hidden_layers=EP_SERVE_LAYERS)
    cuts = cuts or {
        "qwen3_235b": (dict(QWEN3_235B_A22B,
                            num_hidden_layers=EP_CHECK_LAYERS), True),
        "moonlight": (dict(MOONLIGHT_16B, num_hidden_layers=EP_CHECK_LAYERS),
                      False)}
    prompts = tp_prompts(hf, cfg)
    ids, mask = prompts_of(check_cfg["lens"], min(
        m["vocab_size"] for m, _ in cuts.values()), seed=29)
    tmpdir = tempfile.mkdtemp(prefix="nxdi-ep-")
    rank_dev = f"cuda:{device.index or 0}" if on_card else "cpu"
    ranks = spawn_world(ep_rank, 2, "gloo", rank_dev, tmpdir,
                        EP_WORLD_TIMEOUT_S,
                        (hf, cfg, prompts, new_tokens, cuts, check_cfg, ids,
                         mask, check_new))
    emit({"phase": "ep_world2_seconds", "seconds": time.perf_counter() - t0})
    entry = ep_serving_check(hf, cfg, prompts, ranks, device)
    if on_card:
        free_card()
    entries = [entry] if entry is not None else []
    entries += ep_fp32_check(device, cuts, check_cfg, ids, mask, check_new,
                             ranks)
    if on_card:
        memory_note("ep")
    seconds = time.perf_counter() - t0
    emit({"phase": "ep_done", "seconds": seconds, "budget_s": EP_BUDGET_S})
    if on_card and seconds > EP_BUDGET_S:
        raise AssertionError(f"ep group took {seconds:.1f} s, over its "
                             f"budget of {EP_BUDGET_S} s")
    return entries


# ---------------------------------------------------------------------------
# Phase 30: attention data parallelism and the cp axis
# ---------------------------------------------------------------------------

DP_SERVE_LAYERS = 4        # (a), (b): phase 28's Qwen2.5-72B cut
DP_CHECK_LAYERS = 2        # (c): the fp32 cuts
# (b): one long prompt, context-parallel prefill with SP, flash decoding
DP_LONG = dict(len=8192, new_tokens=8, seq_len=8448)
# (c2): the reference's combined mesh at world 8 (eight ranks on the one
#   card: Qwen2.5-7B's widths, as Qwen2.5-72B's fp32 cut takes ~8.5 GB a
#   rank at mp 2)
DP_WORLD_TIMEOUT_S = 600   # each spawned world, init and join
DP_BUDGET_S = 150


def dp_mesh(mesh, tp_degree, dp=1, cp=1):
    """The dp x cp x (tp_degree / (dp·cp)) mesh over the world's first
    ``tp_degree`` ranks (every rank calls it; the others get None)."""
    from neuronx_distributed_inference_tpu_torch.parallel.mesh import (
        MeshConfig, build_mesh)
    return build_mesh(MeshConfig(tp=tp_degree // (dp * cp), dp=dp, cp=cp),
                      mesh.device, ranks=range(tp_degree))


class GatherSpy:
    """The dp and cp gathers (``collectives.gather_dim`` over "dp" or "cp",
    which the steps call by module attribute): each one's output bytes,
    in order, by axis."""

    def __enter__(self):
        from neuronx_distributed_inference_tpu_torch.parallel import \
            collectives as coll
        self._coll, self._orig = coll, coll.gather_dim
        self.calls = {}

        def spy(x, mesh, axis="mp", dim=-1):
            out = self._orig(x, mesh, axis, dim)
            self.calls.setdefault(axis, []).append(
                out.numel() * out.element_size())
            return out
        coll.gather_dim = spy
        return self

    def __exit__(self, *exc):
        self._coll.gather_dim = self._orig


def _lead_generate(app, mesh, ids, mask, new, **kw):
    """The mesh's rank 0 runs ``generate`` and stops the followers, the
    others follow; returns rank 0's result (None elsewhere)."""
    if mesh.leads:
        r = app.generate(ids, attention_mask=mask, max_new_tokens=new, **kw)
        app.stop_followers()
        return r
    app.follow()
    return None


def dp_serve_rank(mesh, hf, cfg, prompts, new_tokens):
    """30 (a) on one rank of dp 2 x tp 2 (four ranks on the one card over
    gloo, every step eager): the mesh's rank 0 serves phase 9's engine and
    mix, each dp replica running its rows of every step, the others
    follow; then rank 0 times the paged kernel at its replica's rows and
    its heads while the others wait between two barriers."""
    import torch
    import torch.distributed as dist
    dev = mesh.device
    on_card = dev.type == "cuda"
    app = make_ragged_app(hf, dev, "bfloat16", cfg, mesh=mesh, graphs=False)
    init_weights(app, 0)
    out = {"index": mesh.index, "dp_rank": mesh.dp_rank,
           "weight_bytes": param_bytes(app.params),
           "heads": [app.spec.gqa.num_q_heads, app.spec.gqa.num_kv_heads]}
    reset_launches([app])
    with PagedArgsSpy() as spy, GatherSpy() as gat:
        if mesh.leads:
            snap = {}
            streams, recs, ttft, _, steps = tp_serve(
                app, prompts, cfg, new_tokens, "dp_serving", _sync(dev),
                snap=snap)
            app.stop_followers()
        else:
            app.follow()
    out.update(launches=kernel_counts([app])["paged_decode_attention"],
               rows=sorted({i[0] for i in spy.ints}), gathers=gat.calls)
    if on_card:
        torch.cuda.synchronize(dev)
    dist.barrier(group=mesh.world_group)
    if mesh.leads:
        out.update(streams=streams, steps=steps, groups=sorted(spy.groups),
                   passes_by_kind={k: sum(1 for r in recs if r["kind"] == k)
                                   for k in ("mixed", "decode", "idle")},
                   host_ms_decode=pass_summary(recs, "decode"),
                   host_ms_mixed=pass_summary(recs, "mixed"),
                   ttft_s=[ttft.get(i) for i in range(len(prompts))],
                   dispatch=dict(app.dispatch_stats))
        if on_card:
            # the replica's own rows of the served snapshot
            half = len(snap["pos"]) // mesh.dp
            out["kernel"] = time_paged_kernel(
                app, snap["table"][:half], snap["pos"][:half], dev, seed=9)
    dist.barrier(group=mesh.world_group)
    del app
    if on_card:
        free_card()
    return out


def dp_long_rank(mesh, hf, ids, new, seq_len):
    """30 (b) on one rank: the contiguous app (bf16, eager) at tp_degree 4
    with cp 2, SP and flash decoding over the four ranks: each cp rank
    embeds, norms and runs the MLP on its half of the prompt, attends its
    queries against the K/V gathered over cp, and holds half of every
    row's cache slots; then tp_degree 2 (cp 1) over the first two ranks
    on the same weights. Returns each run's tokens and time to the first
    token (rank 0), the kernels' launches and the cp gathers on every
    rank."""
    import numpy as np
    import torch
    dev = mesh.device
    on_card = dev.type == "cuda"
    out = {"index": mesh.index}
    mask = np.ones_like(ids)
    for name, sub in (("cp2", dp_mesh(mesh, 4, cp=2)),
                      ("tp2", dp_mesh(mesh, 2))):
        if sub is None:
            continue
        over = (dict(sequence_parallel_enabled=True,
                     flash_decoding_enabled=True) if sub.cp > 1 else {})
        app = make_contiguous_app(hf, dev, "bfloat16", batch=1,
                                  seq_len=seq_len, graphs=False, mesh=sub,
                                  **over)
        init_weights(app, 0)
        reset_launches()
        with GatherSpy() as gat:
            r = _lead_generate(app, sub, ids, mask, new)
        out[name] = {"counts": kernel_counts(), "gathers": gat.calls,
                     "slots": int(app.cache["v"].shape[3])}
        if r is not None:
            out[name].update(tokens=np.asarray(r["generated"])[0].tolist(),
                             ttft_s=r["ttft_s"])
        del app
        if on_card:
            torch.cuda.synchronize(dev)
            free_card()
    return out


def dp_fp32_rank(mesh, cut, ids, mask, new):
    """30 (c1) on one rank of dp 2 x tp 2: the fp32 contiguous cut with
    both kernels asked for: each replica prefills its two rows (the flash
    kernel on its heads) and decodes them (the contiguous decode kernel
    over its two cache rows). Rank 0 returns the tokens and each step's
    logits and, on the card, the kernels' timings at its shapes; every
    rank its launches and the kernels' row counts."""
    import numpy as np
    dev = mesh.device
    on_card = dev.type == "cuda"
    lens = [int(n) for n in mask.sum(axis=1)]
    out = {"index": mesh.index}
    with fp32_exact():
        app = make_contiguous_app(cut, dev, "float32", batch=len(lens),
                                  seq_len=DENSE_CHECK["seq_len"],
                                  decode_kernel=True, output_logits=True,
                                  graphs=False, mesh=mesh)
        init_weights(app, 0)
        reset_launches()
        with ContiguousArgsSpy() as cspy, FlashShapes() as flash:
            r = _lead_generate(app, mesh, ids, mask, new,
                               return_logits=True)
        out.update(counts=kernel_counts(),
                   decode_rows=sorted({i[0] for i in cspy.ints}),
                   flash_rows=sorted({c[0][0] for c in flash.calls}))
        if r is not None:
            out.update(tokens=np.asarray(r["generated"]),
                       logits=_step_logits(r["logits"], lens))
            if on_card:
                spec = app.spec
                half = len(lens) // mesh.dp
                out["times"] = dbrx_fp32_kernels(
                    dev, cspy.ints, flash.calls,
                    [n + new - 2 for n in lens[:half]],
                    dict(scale=spec.scale, window=spec.sliding_window,
                         soft_cap=spec.attn_soft_cap), phase="dp_fp32_cut")
    del app
    if on_card:
        free_card()
    return out


def dp_world4(mesh, hf, cfg, prompts, new_tokens, long_ids, long_new,
              long_seq, cut, ids, mask, new):
    """The four-rank world of 30 (a), (b) and (c1), in that order; (a)
    and (c1) over its dp 2 x tp 2 mesh."""
    dp2 = dp_mesh(mesh, 4, dp=2)
    return (dp_serve_rank(dp2, hf, cfg, prompts, new_tokens),
            dp_long_rank(mesh, hf, long_ids, long_new, long_seq),
            dp_fp32_rank(dp2, cut, ids, mask, new))


def dp_world8(mesh, cut, ids, mask, new):
    """30 (c2) on one rank of the reference's combined mesh (tp_degree 8:
    dp 2 x cp 2 x tp 2, the world's mesh) with SP and flash decoding,
    eight ranks on the one card: the fp32 cut with both kernels asked for
    (the gates keep both off)."""
    import numpy as np
    dev = mesh.device
    lens = [int(n) for n in mask.sum(axis=1)]
    out = {"index": mesh.index}
    with fp32_exact():
        app = make_contiguous_app(
            cut, dev, "float32", batch=len(lens),
            seq_len=DENSE_CHECK["seq_len"], decode_kernel=True,
            output_logits=True, graphs=False, mesh=mesh,
            sequence_parallel_enabled=True, flash_decoding_enabled=True)
        init_weights(app, 0)
        reset_launches()
        r = _lead_generate(app, mesh, ids, mask, new, return_logits=True)
        out["counts"] = kernel_counts()
        if r is not None:
            out.update(tokens=np.asarray(r["generated"]),
                       logits=_step_logits(r["logits"], lens))
    return out


def _fp32_tp1(cut, device, ids, mask, new):
    """The fp32 cut in this process, no mesh: (tokens, each step's
    logits)."""
    import numpy as np
    with fp32_exact():
        one = make_contiguous_app(cut, device, "float32", batch=len(ids),
                                  seq_len=DENSE_CHECK["seq_len"],
                                  decode_kernel=True, output_logits=True,
                                  graphs=False)
        init_weights(one, 0)
        r = one.generate(ids, attention_mask=mask, max_new_tokens=new,
                         return_logits=True)
    del one
    return (np.asarray(r["generated"]),
            _step_logits(r["logits"], mask.sum(axis=1)))


def _fp32_excess(got, want):
    import numpy as np
    return max(float(np.max(np.abs(a - b) - TOL_TP_FP32["rtol"]
                            * np.abs(b))) for a, b in zip(got, want))


def dp_serving_check(hf, cfg, prompts, ranks, device, seq_len):
    """30 (a)'s gates: every rank at half the heads (Qwen2.5-72B: Hq 32 /
    Hkv 4, G 8; the replicas hold the same slice), the
    paged kernel launched layers x the all-decode steps on every rank, on
    a replica's 4 rows; the streams held to a one-process run of the same
    weights by the teacher-deficit gate with its shifted control (the
    teacher: ``seq_len`` slots a row, (b)'s prompt's too). Returns (the
    paged kernel's entry or None, the teacher app)."""
    phase = "dp_serving"
    on_card = device.type == "cuda"
    lead = next(r for r in ranks if r["index"] == 0)
    layers = hf["num_hidden_layers"]
    want_launches = layers * lead["steps"] if on_card else 0
    emit({"phase": phase, "backend": "gloo", "dp": 2, "tp": 2,
          "layers": layers,
          "weight_gb_ranks": [r["weight_bytes"] / 1e9 for r in ranks],
          "heads_ranks": [r["heads"] for r in ranks],
          "launches_ranks": [r["launches"] for r in ranks],
          "kernel_rows_ranks": [r["rows"] for r in ranks],
          "expected_launches": want_launches, "groups": lead["groups"],
          "gathers_rank0": {k: [len(v), sum(v)]
                            for k, v in lead["gathers"].items()},
          "passes_by_kind": lead["passes_by_kind"],
          "host_ms_decode": lead["host_ms_decode"],
          "host_ms_mixed": lead["host_ms_mixed"],
          "ttft_s": lead["ttft_s"],
          "dispatch_records": lead["dispatch"]["records"]})
    heads = [hf["num_attention_heads"] // 2, hf["num_key_value_heads"] // 2]
    for r in ranks:
        if r["heads"] != heads:
            raise AssertionError(f"{phase}: rank {r['index']} heads "
                                 f"{r['heads']}")
        if r["launches"] != want_launches:
            raise AssertionError(f"{phase}: rank {r['index']} launched the "
                                 f"paged kernel {r['launches']} times, "
                                 f"want {want_launches}")
        if on_card and max(r["rows"]) > len(prompts) // 2:
            raise AssertionError(f"{phase}: rank {r['index']} launched at "
                                 f"{r['rows']} rows")
    if on_card and lead["groups"] != [heads[0] // heads[1]]:
        raise AssertionError(f"{phase}: paged launches at groups "
                             f"{lead['groups']}")
    teacher = make_contiguous_app(hf, device, "bfloat16", batch=8,
                                  seq_len=seq_len, output_logits=True)
    init_weights(teacher, 0)
    deficit_gate(phase, teacher_deficits(teacher, prompts, lead["streams"]),
                 exact=False)
    if not on_card:
        return None, teacher
    t = lead["kernel"]
    emit({"phase": phase + "_kernel_timings", **t["report"],
          "launches": lead["launches"]})
    return paged_kernel_entry(t, lead["launches"], phase), teacher


def dp_long_check(hf, teacher, long_prompt, ranks, seq_len):
    """30 (b)'s gates: no kernel launched on any rank under cp prefill,
    SP and flash decoding (the reference's gates); every cp rank holds
    half of the slots; the cp-2 stream held to the one-process teacher by
    the deficit gate (and printed beside the tp-2 run's); prefill ms at
    cp 2 against cp 1 and the cp gathers' bytes a layer."""
    phase = "dp_long_prefill"
    lead = next(r for r in ranks if r["index"] == 0)
    cp2, tp2 = lead["cp2"], lead["tp2"]
    layers = hf["num_hidden_layers"]
    # under SP: K and V a layer, then the last hidden states once
    cp = cp2["gathers"].get("cp", [])
    emit({"phase": phase, "prompt_tokens": len(long_prompt),
          "new_tokens": len(cp2["tokens"]),
          "ttft_ms_cp2": 1e3 * cp2["ttft_s"], "ttft_ms_tp2": 1e3 *
          tp2["ttft_s"],
          "counts_ranks": [r["cp2"]["counts"] for r in ranks],
          "slots_ranks": [r["cp2"]["slots"] for r in ranks],
          "cp_gathers_rank0": len(cp),
          "cp_gather_mb_rank0": sum(cp) / 1e6,
          "cp_kv_gather_mb_a_layer": sum(cp[:-1]) / 1e6 / max(layers, 1),
          "cp_hidden_gather_mb": cp[-1] / 1e6 if cp else 0.0,
          "tokens_equal_tp2": cp2["tokens"] == tp2["tokens"]})
    for r in ranks:
        if any(r["cp2"]["counts"].values()):
            raise AssertionError(f"{phase}: rank {r['index']} launched "
                                 f"{r['cp2']['counts']} under cp")
        if r["cp2"]["slots"] != seq_len // 2:
            raise AssertionError(f"{phase}: rank {r['index']} holds "
                                 f"{r['cp2']['slots']} slots")
    per = teacher_deficits(teacher, [long_prompt, long_prompt],
                           [cp2["tokens"], tp2["tokens"]])
    deficit_gate(phase, per[:1], exact=False)
    emit({"phase": phase + "_tp2_vs_greedy",
          "max_deficit": float(per[1][0].max()),
          "argmax_equal": int(per[1][3].sum())})


def dp_fp32_check(device, cut, cut8, ids, mask, new, ranks4, ranks8):
    """30 (c)'s gates: at dp 2 x tp 2 (c1) the tokens equal the cut's at
    tp 1 and the logits within the suite's tolerance, each rank launched
    flash once a layer and the contiguous decode kernel each layer of
    each decode step, on its replica's 2 rows; at the combined mesh (c2)
    the same against tp 1 with no kernel on any rank. Returns the decode
    and flash kernels' entries at (c1)'s shapes (none off the card)."""
    phase = "dp_fp32_cut"
    on_card = device.type == "cuda"
    layers = cut["num_hidden_layers"]
    rows = len(ids) // 2
    out = []
    for name, model, ranks, kernels in (("dp2_tp2", cut, ranks4, True),
                                        ("tp8_cp2_dp2", cut8, ranks8,
                                         False)):
        lead = next(r for r in ranks if r["index"] == 0)
        want_t, want_l = _fp32_tp1(model, device, ids, mask, new)
        excess = _fp32_excess(lead["logits"], want_l)
        want = {"paged_decode_attention": 0,
                "decode_attention_stacked": (layers * (new - 1)
                                             if on_card and kernels else 0),
                "flash_attention": layers if on_card and kernels else 0}
        emit({"phase": f"{phase}_{name}", "layers": layers,
              "counts_ranks": [r["counts"] for r in ranks],
              "expected_counts": want,
              "kernel_rows_ranks": [[r.get("decode_rows"),
                                     r.get("flash_rows")] for r in ranks],
              "tokens_equal_tp1": bool((lead["tokens"] == want_t).all()),
              "max_logit_excess_over_rtol": excess, "tol": TOL_TP_FP32})
        for r in ranks:
            if r["counts"] != want:
                raise AssertionError(f"{phase}_{name}: rank {r['index']} "
                                     f"launches {r['counts']} != {want}")
            if on_card and kernels and (r["decode_rows"] != [rows]
                                        or r["flash_rows"] != [rows]):
                raise AssertionError(f"{phase}_{name}: rank {r['index']} "
                                     f"kernels at rows {r['decode_rows']}, "
                                     f"{r['flash_rows']}")
        if not (lead["tokens"] == want_t).all():
            raise AssertionError(f"{phase}_{name}: tokens differ from tp 1")
        if not excess <= TOL_TP_FP32["atol"]:
            raise AssertionError(f"{phase}_{name}: logits off tp 1 by "
                                 f"{excess} over the relative tolerance")
        if on_card and kernels:
            c = lead["counts"]
            out += contiguous_kernel_entries(
                lead["times"], c["decode_attention_stacked"],
                c["flash_attention"], f"{phase}_{name}")
        if on_card:
            free_card()
    return out


def phase_dp(device, hf=None, cfg=RAGGED, new_tokens=RAGGED_TOKENS,
             cut=None, cut8=None, long=DP_LONG, check_cfg=DENSE_CHECK,
             check_new=DENSE_CHECK_TOKENS):
    """Group ``dp`` (phase 30 (a)-(c)); returns its kernels-line entries:
    the paged kernel at (a)'s per-rank shapes (a replica's rows, a rank's
    heads) with (a)'s launches, and the contiguous decode and flash
    kernels at (c1)'s per-rank shapes with (c1)'s launches. ``hf``,
    ``cut`` (default: Qwen2.5-72B at DP_SERVE_LAYERS and
    DP_CHECK_LAYERS), ``cut8`` (Qwen2.5-7B at DP_CHECK_LAYERS), ``cfg``,
    ``long``, ``check_cfg`` and the token counts let a CPU rehearsal run
    it at tiny widths."""
    import tempfile

    import numpy as np
    from neuronx_distributed_inference_tpu_torch.parallel.mesh import (
        MeshConfig, spawn_world)
    on_card = device.type == "cuda"
    t0 = time.perf_counter()
    if on_card:
        import torch
        torch.cuda.reset_peak_memory_stats()
    hf = hf or dict(QWEN25_72B, num_hidden_layers=DP_SERVE_LAYERS)
    cut = cut or dict(QWEN25_72B, num_hidden_layers=DP_CHECK_LAYERS)
    cut8 = cut8 or dict(QWEN2_5_7B, num_hidden_layers=DP_CHECK_LAYERS)
    prompts = tp_prompts(hf, cfg)
    long_prompt = np.random.default_rng(30).integers(
        1, hf["vocab_size"], size=long["len"]).tolist()
    long_ids = np.asarray([long_prompt], np.int64)
    ids, mask = prompts_of(check_cfg["lens"], min(
        cut["vocab_size"], cut8["vocab_size"]), seed=30)
    tmpdir = tempfile.mkdtemp(prefix="nxdi-dp-")
    rank_dev = f"cuda:{device.index or 0}" if on_card else "cpu"
    ranks = spawn_world(dp_world4, 4, "gloo", rank_dev, tmpdir,
                        DP_WORLD_TIMEOUT_S,
                        (hf, cfg, prompts, new_tokens, long_ids,
                         long["new_tokens"], long["seq_len"], cut, ids,
                         mask, check_new))
    t4 = time.perf_counter()
    emit({"phase": "dp_world4_seconds", "seconds": t4 - t0})
    ranks8 = spawn_world(dp_world8, 8, "gloo", rank_dev, tmpdir,
                         DP_WORLD_TIMEOUT_S, (cut8, ids, mask, check_new),
                         mesh_cfg=MeshConfig(tp=2, dp=2, cp=2))
    emit({"phase": "dp_world8_seconds",
          "seconds": time.perf_counter() - t4})
    entry, teacher = dp_serving_check(
        hf, cfg, prompts, [r[0] for r in ranks], device,
        max(cfg["seq_len"], long["seq_len"]))
    dp_long_check(hf, teacher, long_prompt, [r[1] for r in ranks],
                  long["seq_len"])
    del teacher
    if on_card:
        free_card()
    entries = [entry] if entry is not None else []
    entries += dp_fp32_check(device, cut, cut8, ids, mask, check_new,
                             [r[2] for r in ranks], ranks8)
    if on_card:
        memory_note("dp")
    seconds = time.perf_counter() - t0
    emit({"phase": "dp_done", "seconds": seconds, "budget_s": DP_BUDGET_S})
    if on_card and seconds > DP_BUDGET_S:
        raise AssertionError(f"dp group took {seconds:.1f} s, over its "
                             f"budget of {DP_BUDGET_S} s")
    return entries


GROUPS = ("kernels", "paged", "pipeline", "contig", "ragged", "tier",
          "spec", "moe", "oss", "long", "mla", "quant", "dense",
          "moe_families", "contrib_moe", "lora", "contrib_dense",
          "contrib_dense2", "tp", "ep", "dp")


def main(argv=None) -> int:
    import torch
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--only", default=",".join(GROUPS),
                        help="comma-separated phase groups: "
                             + ", ".join(GROUPS))
    args = parser.parse_args(argv)
    only = set(args.only.split(","))
    if not only <= set(GROUPS):
        parser.error(f"unknown groups {sorted(only - set(GROUPS))}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    device = torch.device("cuda")
    gpu = nvidia_smi()
    build_s = build_kernels()
    emit({"phase": "env", "gpu": gpu, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "bmm_out_dtype": bmm_out_dtype_available(),
          "grouped_mm": grouped_mm_available(), "build_s": build_s})
    kernels = []
    group_s = {"build": time.perf_counter() - t_start}
    last = [time.perf_counter()]

    def mark(group):
        now = time.perf_counter()
        group_s[group] = now - last[0]
        last[0] = now
    if "kernels" in only:
        phase_kernels(device)
        mark("kernels")
    if "paged" in only:
        app, ids, mask, launches = phase_main_path(LLAMA_3_2_1B, device)
        phase_serving(LLAMA_3_2_1B, device)
        kernels += phase_timings(LLAMA_3_2_1B, device, app, ids, mask,
                                 launches)
        del app
        torch.cuda.empty_cache()
        mark("paged")
    if "pipeline" in only:
        kernels += phase_pipeline(device)
        torch.cuda.empty_cache()
        mark("pipeline")
    if "contig" in only:
        mistral = dict(MISTRAL_7B, num_hidden_layers=CONTIG_MAIN_LAYERS)
        app, ids, mask, counts = phase_contiguous(mistral, device,
                                                  "contiguous_main_path")
        kernels += phase_contiguous_timings(mistral, device, app, ids,
                                            mask, counts)
        del app
        torch.cuda.empty_cache()
        phase_contiguous(dict(MISTRAL_7B, num_hidden_layers=4,
                              sliding_window=512), device, "window_bites")
        torch.cuda.empty_cache()
        phase_contiguous_serving(dict(MISTRAL_7B, num_hidden_layers=8),
                                 device)
        torch.cuda.empty_cache()
        mark("contig")
    app = None
    if "ragged" in only:
        app, prompts, entries, _ = phase_ragged_serving(LLAMA_3_1_8B,
                                                        device)
        kernels += entries
        phase_front_door(LLAMA_3_1_8B, device, app, prompts)
        if not {"tier", "spec"} & only:
            del app
            app = None
            torch.cuda.empty_cache()
        phase_ragged_fp32(dict(LLAMA_3_1_8B, num_hidden_layers=4), device)
        mark("ragged")
    if "tier" in only:
        kernels += phase_tier_group(device, app)
        mark("tier")
    if "spec" in only:
        phase_spec_greedy(LLAMA_3_1_8B, device, app)
        del app
        torch.cuda.empty_cache()
        kernels += phase_spec_sampled(LLAMA_3_1_8B, device)
        torch.cuda.empty_cache()
        phase_spec_fp32(dict(LLAMA_3_1_8B, num_hidden_layers=4), device)
        free_card()
        kernels += phase_speculation(device)
        mark("spec")
    if "moe" in only:
        free_card()
        kernels += phase_moe(device)
        mark("moe")
    if "oss" in only:
        free_card()
        kernels += phase_oss(device)
        mark("oss")
    if "long" in only:
        free_card()
        kernels += phase_long(device)
        mark("long")
    if "mla" in only:
        free_card()
        phase_mla(device)
        mark("mla")
    if "quant" in only:
        free_card()
        kernels += phase_quant(device)
        mark("quant")
    if "dense" in only:
        free_card()
        kernels += phase_dense(device)
        mark("dense")
    if "moe_families" in only:
        free_card()
        kernels += phase_moe_families(device)
        mark("moe_families")
    if "contrib_moe" in only:
        free_card()
        kernels += phase_contrib_moe(device)
        mark("contrib_moe")
    if "lora" in only:
        free_card()
        kernels += phase_lora_group(device)
        mark("lora")
    if "contrib_dense" in only:
        free_card()
        kernels += phase_contrib_dense(device)
        mark("contrib_dense")
    if "contrib_dense2" in only:
        free_card()
        kernels += phase_contrib_dense2(device)
        mark("contrib_dense2")
    if "tp" in only:
        free_card()
        kernels += phase_tp(device)
        mark("tp")
    if "ep" in only:
        free_card()
        kernels += phase_ep(device)
        mark("ep")
    if "dp" in only:
        free_card()
        kernels += phase_dp(device)
        mark("dp")
    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          "group_seconds": group_s})
    emit({"kernels": kernels})
    emit({"gpu": gpu})
    if only != set(GROUPS):
        return 0
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
