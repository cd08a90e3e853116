"""Canonical metric names + label sets — a STABLE contract; a copy of
``neuronx_distributed_inference_tpu/telemetry/metrics.py``.

Dashboards and tests key on these strings; treat renames as breaking
changes (README "Observability" documents each one). Helpers here build the
instruments with their canonical help text/labels so every call site agrees
on the schema.
"""

from __future__ import annotations

from .registry import DEFAULT_LATENCY_BUCKETS

# -- serving adapters (serving.py) -----------------------------------------
# engine label: "cb" (ContinuousBatchingAdapter) | "paged" (PagedEngineAdapter)
REQUEST_TTFT_SECONDS = "nxdi_request_ttft_seconds"
DECODE_STEP_SECONDS = "nxdi_decode_step_seconds"      # TPOT per step() call
REQUEST_TPOT_SECONDS = "nxdi_request_tpot_seconds"    # per-request mean TPOT
LIVE_BATCH_SIZE = "nxdi_live_batch_size"
LIVE_ROWS_TOTAL = "nxdi_live_rows_total"              # phase=prefill|decode
PAD_ROWS_TOTAL = "nxdi_pad_rows_total"                # phase=prefill|decode
REQUESTS_TOTAL = "nxdi_requests_total"                # event=added|released

# -- chunked prefill (serving.py PagedEngineAdapter) -------------------------
PREFILL_CHUNKS_TOTAL = "nxdi_prefill_chunks_total"      # engine
PREFILL_PAD_WASTE = "nxdi_prefill_pad_waste"            # engine

# -- serving engine (serving/engine/) ----------------------------------------
QUEUE_DEPTH = "nxdi_queue_depth"                        # tenant
QUEUE_WAIT_SECONDS = "nxdi_queue_wait_seconds"          # tenant, outcome

# -- decode pipeline (serving.py) --------------------------------------------
DISPATCH_DEPTH = "nxdi_dispatch_depth"                  # engine
HOST_OVERLAP_SECONDS = "nxdi_host_overlap_seconds"      # engine
STEPS_PER_FETCH = "nxdi_steps_per_fetch"                # engine

# -- serving resilience (serving.py + resilience/) --------------------------
PREEMPTIONS_TOTAL = "nxdi_preemptions_total"            # engine, reason, tenant
ADMISSION_ROLLBACKS_TOTAL = "nxdi_admission_rollbacks_total"   # engine
DEADLINE_EXPIRED_TOTAL = "nxdi_deadline_expired_total"  # engine, tenant
STEP_FAILURES_TOTAL = "nxdi_step_failures_total"        # engine, phase, tenant

# -- flight recorder + span ring (telemetry/trace.py, registry.py) -----------
TRACE_EVENTS_DROPPED_TOTAL = "nxdi_trace_events_dropped_total"  # ring

# -- compiled-graph observatory (telemetry/observatory.py) -------------------
COMPILE_SECONDS = "nxdi_compile_seconds"                # kind, bucket
GRAPH_FLOPS = "nxdi_graph_flops"                        # kind, bucket
GRAPH_BYTES = "nxdi_graph_bytes"                        # kind, bucket
GRAPH_PEAK_BYTES = "nxdi_graph_peak_bytes"              # kind, bucket

# -- sharding observatory: SPMD collective census ----------------------------
# kind here = COLLECTIVE kind (all_reduce|all_gather|reduce_scatter|
# collective_permute|all_to_all); comm = mesh-axis subset ("tp", "dp",
# "ep+tp", …) the replica groups ride
GRAPH_COLLECTIVES_TOTAL = "nxdi_graph_collectives_total"    # kind, comm
GRAPH_COLLECTIVE_BYTES = "nxdi_graph_collective_bytes"      # kind, comm

# -- application hot paths (models/application.py) --------------------------
# kind: prefill|decode|decode_loop|paged ; part: host|device
RUN_SECONDS = "nxdi_run_seconds"
GENERATED_TOKENS_TOTAL = "nxdi_generated_tokens_total"      # engine=cb|paged
DEVICE_SAMPLED_ROWS_TOTAL = "nxdi_device_sampled_rows_total"  # kind

# -- jit / bucketing (models/application.py, modules/autobucketing.py) ------
JIT_COMPILES_TOTAL = "nxdi_jit_compiles_total"        # kind, bucket
JIT_CACHE_HITS_TOTAL = "nxdi_jit_cache_hits_total"    # kind
BUCKET_SELECTED_TOTAL = "nxdi_bucket_selected_total"  # kind, bucket

# -- cold-start / steady-state compile discipline (serving/warmup.py) --------
STEADY_STATE_RECOMPILES_TOTAL = \
    "nxdi_steady_state_recompiles_total"              # kind, bucket

# -- HBM ledger (serving/warmup.py memory_ledger) ----------------------------
# state: used|free|unwritten|spilled (spilled = host-RAM tier residency,
# reported in the same account so the device + spill total is one read)
HBM_MODEL_BYTES = "nxdi_hbm_model_bytes"
HBM_KV_BYTES = "nxdi_hbm_kv_bytes"                    # state
KV_FRAGMENTATION_RATIO = "nxdi_kv_fragmentation_ratio"

# -- paged KV cache (modules/block_kv_cache.py) ------------------------------
KV_BLOCKS_TOTAL = "nxdi_kv_blocks_total"
KV_BLOCKS_IN_USE = "nxdi_kv_blocks_in_use"
KV_BLOCK_ALLOC_FAILURES_TOTAL = "nxdi_kv_block_alloc_failures_total"
PREFIX_CACHE_HIT_TOKENS_TOTAL = "nxdi_prefix_cache_hit_tokens_total"

# -- speculative serving (serving/speculation/) ------------------------------
RAGGED_ROWS_TOTAL = "nxdi_ragged_rows_total"     # engine, kind
RAGGED_PAD_WASTE = "nxdi_ragged_pad_waste"       # engine

SPEC_DRAFTED_TOKENS_TOTAL = "nxdi_spec_drafted_tokens_total"     # engine
SPEC_ACCEPTED_TOKENS_TOTAL = "nxdi_spec_accepted_tokens_total"   # engine
SPEC_ACCEPT_RATE = "nxdi_spec_accept_rate"                       # engine
SPEC_VERIFY_WIDTH = "nxdi_spec_verify_width"                     # engine

# -- fleet layer (serving/fleet/) --------------------------------------------
FLEET_ROUTED_TOTAL = "nxdi_fleet_routed_total"       # replica, affinity
FLEET_REQUEUES_TOTAL = "nxdi_fleet_requeues_total"   # replica
HANDOFFS_TOTAL = "nxdi_handoff_total"                # role=send|recv|migrate_*
FLEET_REPLICAS = "nxdi_fleet_replicas"               # state

# -- host-RAM KV spill tier (serving/fleet/kv_tier.py) -----------------------
KV_SPILL_BLOCKS_TOTAL = "nxdi_kv_spill_blocks_total"
KV_SPILL_EVICTIONS_TOTAL = "nxdi_kv_spill_evictions_total"
KV_SPILL_BYTES = "nxdi_kv_spill_bytes"
KV_RESTORE_BLOCKS_TOTAL = "nxdi_kv_restore_blocks_total"
KV_RESTORE_TOKENS_TOTAL = "nxdi_kv_restore_tokens_total"

# -- multi-LoRA adapter pool (serving/lora_pool.py) --------------------------
LORA_RESIDENCY_HITS_TOTAL = "nxdi_lora_residency_hits_total"
LORA_SWAPS_TOTAL = "nxdi_lora_swaps_total"           # adapter
LORA_SWAP_BYTES = "nxdi_lora_swap_bytes"

# -- per-tenant SLO plane (telemetry/slo.py) ---------------------------------
# signal: ttft|tpot|queue_wait ; window: short|long (policy window lengths)
SLO_ATTAINMENT = "nxdi_slo_attainment"               # tenant, signal, window
SLO_BURN_RATE = "nxdi_slo_burn_rate"                 # tenant, signal, window

# -- degradation controller (resilience/controller.py) -----------------------
# action: shed_speculation|tighten_admission|drop_ragged|shed_adapters
DEGRADED = "nxdi_degraded"                           # tenant, action

# -- degradations -----------------------------------------------------------
MOE_TKG_LOCAL_QUANT_DEGRADED_TOTAL = \
    "nxdi_moe_tkg_local_quant_degraded_total"


def ttft_histogram(reg):
    # tenant label: "" outside the multi-tenant serving engine (additive —
    # single-tenant dashboards aggregate over it unchanged)
    return reg.histogram(
        REQUEST_TTFT_SECONDS,
        "Time from request admission to its first generated token (s)",
        labels=("engine", "tenant"), buckets=DEFAULT_LATENCY_BUCKETS)


def decode_step_histogram(reg):
    return reg.histogram(
        DECODE_STEP_SECONDS,
        "Wall time of one engine decode step() call (s)",
        labels=("engine",), buckets=DEFAULT_LATENCY_BUCKETS)


def tpot_histogram(reg):
    return reg.histogram(
        REQUEST_TPOT_SECONDS,
        "Per-request mean time-per-output-token after the first token (s)",
        labels=("engine", "tenant"), buckets=DEFAULT_LATENCY_BUCKETS)


def queue_depth_gauge(reg):
    return reg.gauge(
        QUEUE_DEPTH,
        "Requests waiting in the serving engine's admission queue",
        labels=("tenant",))


def queue_wait_histogram(reg):
    return reg.histogram(
        QUEUE_WAIT_SECONDS,
        "Time a request spent queued before admission "
        "(outcome=admitted|expired|cancelled)",
        labels=("tenant", "outcome"), buckets=DEFAULT_LATENCY_BUCKETS)


def live_batch_gauge(reg):
    return reg.gauge(LIVE_BATCH_SIZE,
                     "Live rows submitted in the most recent engine call",
                     labels=("engine",))


def live_rows_counter(reg):
    return reg.counter(LIVE_ROWS_TOTAL,
                       "Live (non-pad) rows submitted to the device",
                       labels=("engine", "phase"))


def pad_rows_counter(reg):
    return reg.counter(
        PAD_ROWS_TOTAL,
        "Pad rows submitted to the device (pad-waste = pad/(pad+live))",
        labels=("engine", "phase"))


def requests_counter(reg):
    return reg.counter(REQUESTS_TOTAL, "Engine request lifecycle events",
                       labels=("engine", "event"))


def prefill_chunks_counter(reg):
    return reg.counter(
        PREFILL_CHUNKS_TOTAL,
        "Prompt chunks driven through the packed paged prefill path "
        "(one per sequence per packed chunk dispatch)",
        labels=("engine",))


def prefill_pad_waste_histogram(reg):
    return reg.histogram(
        PREFILL_PAD_WASTE,
        "Padded-token waste fraction of one packed prefill dispatch "
        "((padded - real) / padded over the rows x width grid; monolithic "
        "admission of skewed prompts pushes this toward 1)",
        labels=("engine",),
        buckets=(0.05, 0.1, 0.2, 0.4, 0.6, 0.8, 0.95))


def dispatch_depth_gauge(reg):
    return reg.gauge(
        DISPATCH_DEPTH,
        "Device decode dispatches in flight whose tokens have not been "
        "fetched to the host yet (0 = eager; pipeline_depth bounds it)",
        labels=("engine",))


def host_overlap_histogram(reg):
    return reg.histogram(
        HOST_OVERLAP_SECONDS,
        "Host wall time between a pipelined decode dispatch and its "
        "deferred token fetch — bookkeeping overlapped with device "
        "compute (s)",
        labels=("engine",), buckets=DEFAULT_LATENCY_BUCKETS)


def steps_per_fetch_histogram(reg):
    return reg.histogram(
        STEPS_PER_FETCH,
        "Device decode steps retired per blocking host fetch (1 = eager "
        "step(), k = step_many(k); _count is the fetches, _sum the steps)",
        labels=("engine",), buckets=(1, 2, 4, 8, 16, 32, 64))


def preemptions_counter(reg):
    # tenant label: "" outside the multi-tenant serving engine (additive —
    # single-tenant dashboards aggregate over it unchanged)
    return reg.counter(
        PREEMPTIONS_TOTAL,
        "Sequences evicted (recompute preemption); "
        "reason=grow|admission|scheduler",
        labels=("engine", "reason", "tenant"))


def admission_rollbacks_counter(reg):
    return reg.counter(
        ADMISSION_ROLLBACKS_TOTAL,
        "add_requests calls that failed and were rolled back atomically",
        labels=("engine",))


def deadline_expired_counter(reg):
    return reg.counter(
        DEADLINE_EXPIRED_TOTAL,
        "Requests that blew their per-request wall-clock deadline "
        "(counted once per request; tenant=\"\" outside the engine)",
        labels=("engine", "tenant"))


def step_failures_counter(reg):
    return reg.counter(
        STEP_FAILURES_TOTAL,
        "Device steps that raised and were rolled back (StepFailure); "
        "phase=prefill|decode (tenant=\"\" outside the engine or when the "
        "failed call mixed tenants)",
        labels=("engine", "phase", "tenant"))


def trace_events_dropped_counter(reg):
    return reg.counter(
        TRACE_EVENTS_DROPPED_TOTAL,
        "Events evicted from a bounded observability ring "
        "(ring=spans|trace) — nonzero means post-mortems are truncated",
        labels=("ring",))


def compile_seconds_gauge(reg):
    return reg.gauge(
        COMPILE_SECONDS,
        "AOT lower+compile wall time of one (kind, bucket) serving graph "
        "(s); the stats_line total tracks cold-start cost",
        labels=("kind", "bucket"))


def graph_flops_gauge(reg):
    return reg.gauge(
        GRAPH_FLOPS,
        "XLA cost_analysis flops of one compiled (kind, bucket) graph",
        labels=("kind", "bucket"))


def graph_bytes_gauge(reg):
    return reg.gauge(
        GRAPH_BYTES,
        "XLA cost_analysis bytes accessed of one compiled (kind, bucket) "
        "graph",
        labels=("kind", "bucket"))


def graph_peak_bytes_gauge(reg):
    return reg.gauge(
        GRAPH_PEAK_BYTES,
        "XLA memory_analysis peak bytes (arguments + outputs + temps) of "
        "one compiled (kind, bucket) graph",
        labels=("kind", "bucket"))


def graph_collectives_gauge(reg):
    return reg.gauge(
        GRAPH_COLLECTIVES_TOTAL,
        "Collective ops censused across an app's partitioned (post-SPMD) "
        "graphs; kind=all_reduce|all_gather|reduce_scatter|"
        "collective_permute|all_to_all, comm=the mesh-axis subset the "
        "replica groups ride, dtype=the wire payload element type "
        "(f32|s8|f8e4m3fn|...) (static census — loop bodies count once)",
        labels=("kind", "comm", "dtype"))


def graph_collective_bytes_gauge(reg):
    return reg.gauge(
        GRAPH_COLLECTIVE_BYTES,
        "Result-tensor payload bytes of the censused collectives "
        "(summed over an app's graph set per kind x comm x dtype)",
        labels=("kind", "comm", "dtype"))


def run_seconds_histogram(reg):
    return reg.histogram(
        RUN_SECONDS,
        "Application _run_* wall time, split host-prep vs device wait (s)",
        labels=("kind", "part"), buckets=DEFAULT_LATENCY_BUCKETS)


def generated_tokens_counter(reg):
    return reg.counter(GENERATED_TOKENS_TOTAL,
                       "Tokens generated for live requests (engine-observed; "
                       "excludes pad rows)",
                       labels=("engine",))


def device_sampled_rows_counter(reg):
    return reg.counter(
        DEVICE_SAMPLED_ROWS_TOTAL,
        "Rows sampled per device forward (includes pad rows; the gap to "
        "nxdi_generated_tokens_total is engine pad waste)",
        labels=("kind",))


def jit_compiles_counter(reg):
    return reg.counter(
        JIT_COMPILES_TOTAL,
        "First-time (kind, bucket, shape) graph builds — each one is a "
        "trace+compile (or persistent-cache load) stall",
        labels=("kind", "bucket"))


def jit_cache_hits_counter(reg):
    return reg.counter(JIT_CACHE_HITS_TOTAL,
                       "Executions that reused an already-built graph",
                       labels=("kind",))


def bucket_selected_counter(reg):
    return reg.counter(BUCKET_SELECTED_TOTAL,
                       "Host-side pad-target bucket selections",
                       labels=("kind", "bucket"))


def steady_state_recompiles_counter(reg):
    return reg.counter(
        STEADY_STATE_RECOMPILES_TOTAL,
        "Graph builds observed AFTER precompile() declared steady state — "
        "every one is a tracked incident (compile.unexpected on the "
        "flight recorder, attributed to the triggering request traces)",
        labels=("kind", "bucket"))


def hbm_model_bytes_gauge(reg):
    return reg.gauge(
        HBM_MODEL_BYTES,
        "Bytes held by the replica's model parameters (exact pytree "
        "leaf-byte sum — the static side of the HBM ledger)")


def hbm_kv_bytes_gauge(reg):
    return reg.gauge(
        HBM_KV_BYTES,
        "KV pool bytes by ledger state (used|free|unwritten device "
        "blocks; spilled = host-RAM tier residency in the same account)",
        labels=("state",))


def kv_fragmentation_ratio_gauge(reg):
    return reg.gauge(
        KV_FRAGMENTATION_RATIO,
        "Wasted slot fraction inside allocated KV blocks: 1 - live "
        "tokens / (blocks_in_use * block_size); 0 with nothing allocated")


def kv_blocks_total_gauge(reg):
    return reg.gauge(KV_BLOCKS_TOTAL,
                     "Usable KV cache blocks (excludes the null block)")


def kv_blocks_in_use_gauge(reg):
    return reg.gauge(KV_BLOCKS_IN_USE,
                     "KV cache blocks currently referenced by sequences")


def kv_alloc_failures_counter(reg):
    return reg.counter(KV_BLOCK_ALLOC_FAILURES_TOTAL,
                       "Block allocations that failed (cache exhausted)")


def prefix_hit_tokens_counter(reg):
    return reg.counter(PREFIX_CACHE_HIT_TOKENS_TOTAL,
                       "Prompt tokens served from the prefix cache")


def ragged_rows_counter(reg):
    return reg.counter(
        RAGGED_ROWS_TOTAL,
        "Rows packed into ragged unified dispatches, by kind: decode "
        "steps, prefill chunks, speculative verify windows and batch-pad "
        "rows (serving/ragged/)",
        labels=("engine", "kind"))


def ragged_pad_waste_gauge(reg):
    return reg.gauge(
        RAGGED_PAD_WASTE,
        "Padded-token waste fraction of the last ragged unified dispatch "
        "((padded - real) / padded over the rows x unified-width grid)",
        labels=("engine",))


def spec_drafted_counter(reg):
    return reg.counter(
        SPEC_DRAFTED_TOKENS_TOTAL,
        "Draft tokens proposed per speculative verify dispatch "
        "(accepted + rejected; excludes the always-emitted bonus token), "
        "split by verify mode (greedy | sampled)",
        labels=("engine", "mode"))


def spec_accepted_counter(reg):
    return reg.counter(
        SPEC_ACCEPTED_TOKENS_TOTAL,
        "Draft tokens the verify dispatch accepted (the gap to "
        "nxdi_spec_drafted_tokens_total is wasted draft work), split by "
        "verify mode (greedy | sampled)",
        labels=("engine", "mode"))


def spec_accept_rate_gauge(reg):
    return reg.gauge(
        SPEC_ACCEPT_RATE,
        "Per-step draft acceptance rate (accepted/drafted of the last "
        "speculative engine step; 1.0 under greedy or coupled-sampled "
        "self-drafting), split by verify mode (greedy | sampled)",
        labels=("engine", "mode"))


def spec_verify_width_histogram(reg):
    return reg.histogram(
        SPEC_VERIFY_WIDTH,
        "Bucketed candidate width (drafts + 1) of each speculative verify "
        "dispatch — width 1 means the step degenerated to eager decode",
        labels=("engine",), buckets=(1, 2, 4, 8, 16, 32))


def fleet_routed_counter(reg):
    return reg.counter(
        FLEET_ROUTED_TOTAL,
        "Requests routed to a replica by the fleet EngineRouter "
        "(affinity=warm when prefix-affinity picked the replica, cold "
        "when it fell through to least queue depth)",
        labels=("replica", "affinity"))


def fleet_requeues_counter(reg):
    return reg.counter(
        FLEET_REQUEUES_TOTAL,
        "In-flight requests requeued onto another replica after their "
        "replica failed or closed (labeled with the FAILED replica)",
        labels=("replica",))


def handoffs_counter(reg):
    return reg.counter(
        HANDOFFS_TOTAL,
        "Disaggregated prefill/decode handoffs (role=send on capture, "
        "role=recv on decode-side admission) and live decode->decode "
        "migrations (role=migrate_send / migrate_recv)",
        labels=("role",))


def fleet_replicas_gauge(reg):
    return reg.gauge(
        FLEET_REPLICAS,
        "Replicas in the fleet router's rotation by health state "
        "(healthy/draining/backing_off/probation/dead) — refreshed by "
        "every FleetAutoscaler evaluation",
        labels=("state",))


def kv_spill_blocks_counter(reg):
    return reg.counter(
        KV_SPILL_BLOCKS_TOTAL,
        "KV block payloads spilled from device to the host-RAM tier "
        "(on prefix-cache LRU eviction)")


def kv_spill_evictions_counter(reg):
    return reg.counter(
        KV_SPILL_EVICTIONS_TOTAL,
        "Block payloads evicted from the bounded host-RAM spill tier "
        "(oldest-touched first) — nonzero means the tier is undersized "
        "for the working set")


def kv_spill_bytes_gauge(reg):
    return reg.gauge(
        KV_SPILL_BYTES,
        "Host RAM currently held by the KV spill tier's block payloads")


def kv_restore_blocks_counter(reg):
    return reg.counter(
        KV_RESTORE_BLOCKS_TOTAL,
        "Spilled KV blocks restored to device by H2D copy at admission "
        "(each one replaces a recompute of block_size prompt tokens)")


def kv_restore_tokens_counter(reg):
    return reg.counter(
        KV_RESTORE_TOKENS_TOTAL,
        "Prompt tokens whose prefill recompute was replaced by a "
        "spill-tier restore")


def lora_residency_hits_counter(reg):
    return reg.counter(
        LORA_RESIDENCY_HITS_TOTAL,
        "Adapter acquisitions served by an already device-resident slot "
        "(no swap H2D traffic) — hits / (hits + swaps) is the pool's "
        "residency hit-rate")


def lora_swaps_counter(reg):
    return reg.counter(
        LORA_SWAPS_TOTAL,
        "Adapter swaps written into a stacked device slot (H2D), by "
        "adapter name — each swap pays the (A,B) factor upload the "
        "residency pool exists to amortize",
        labels=("adapter",))


def lora_swap_bytes_counter(reg):
    return reg.counter(
        LORA_SWAP_BYTES,
        "Bytes of stacked (A,B) LoRA factors uploaded to device slots by "
        "adapter swaps (cumulative H2D swap traffic)")


def slo_attainment_gauge(reg):
    return reg.gauge(
        SLO_ATTAINMENT,
        "Fraction of a tenant's requests meeting the signal's SLO target "
        "inside the window (signal=ttft|tpot|queue_wait, "
        "window=short|long; pull-time export from the SLO tracker)",
        labels=("tenant", "signal", "window"))


def slo_burn_rate_gauge(reg):
    return reg.gauge(
        SLO_BURN_RATE,
        "Error-budget burn rate inside the window: violation fraction / "
        "(1 - objective) — 1.0 means spending budget exactly as fast as "
        "the objective allows",
        labels=("tenant", "signal", "window"))


def degraded_gauge(reg):
    return reg.gauge(
        DEGRADED,
        "1 while the degradation controller holds the action active for "
        "the tenant (hysteresis-guarded; set on degrade.enter, cleared "
        "on degrade.exit), 0 after exit "
        "(action=shed_speculation|tighten_admission|drop_ragged|"
        "shed_adapters)",
        labels=("tenant", "action"))


def moe_tkg_degraded_counter(reg):
    return reg.counter(
        MOE_TKG_LOCAL_QUANT_DEGRADED_TOTAL,
        "tkg_experts_local requested but quantized expert weights kept the "
        "prefill layout (decode resharding skipped)")
