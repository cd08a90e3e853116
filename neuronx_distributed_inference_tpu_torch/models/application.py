"""Applications: the contiguous-cache ``CausalLMApplication`` and the
paged ``PagedCausalLMApplication`` built on it (counterpart:
``neuronx_distributed_inference_tpu/models/application.py`` —
``CausalLMApplication`` :52-1080: ``__init__`` :55, ``load_weights``
:106, ``init_random_weights`` :115, ``_put_params`` :127, ``init_cache``
:203, ``_check_decode_fits`` :263, ``_kv_bucket`` :277, ``warmup`` :323,
``_default_sampling_params`` :508, ``_run_prefill`` :515, ``_run_decode``
:613, ``_run_decode_loop`` :649, ``_generate_repadded`` :687,
``generate`` :780, ``reset`` :967; ``_finalize_generation`` :1105;
``PagedCausalLMApplication`` :1120-1626, its ``_run_ragged`` :1330).

Same host contract as the JAX applications. The contiguous app:
``init_cache``, ``_run_prefill``, ``_run_decode``, ``_run_decode_loop``,
``generate``, ``reset``; the paged app: ``_run_paged``,
``_run_paged_loop``, ``_run_ragged``, ``generate``, ``release``,
``reset``, with the host
owning the block allocator and tables. Step results are torch tensors
(read them with ``np.asarray(t.cpu())``). Windowed context encoding,
images, LoRA adapters and M-RoPE positions of the JAX ``generate`` are not
ported (the spec refuses their configs).

The KV cache is updated IN PLACE by every step. The JAX application
donated the cache buffers to each step, which made every step a
destructive update already; the port just does it without the copy.

Entry points run on ``cuda`` unless ``device="cpu"`` is passed; a missing
card raises (``device.resolve_device``).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Type

import numpy as np
import torch

from ..config import InferenceConfig, TpuConfig
from ..device import DeviceLike, resolve_device
from ..modules import autobucketing
from ..modules import kv_cache as kvc
from ..modules.block_kv_cache import (BlockKVCacheManager, BlockKVSpec,
                                      cut_cached_at_unwritten,
                                      slots_from_table)
from ..ops.sampling import prepare_sampling_params
from ..resilience.errors import CapacityError, ConfigurationError
from ..utils import checkpoint as ckpt
from ..utils.jax_params import tensor_from_numpy
from . import model_base
from .family import DecoderFamily, family_for_config


def _finalize_generation(input_ids: np.ndarray, collected, eos_ids,
                         ttft: float, seq_lens: np.ndarray) -> Dict[str, Any]:
    """Concat steps, fill past the first eos per row, assemble the result."""
    gen = np.concatenate(collected, axis=1)
    if eos_ids is not None:
        for i in range(gen.shape[0]):
            hits = np.where(np.isin(gen[i], eos_ids))[0]
            if hits.size:
                gen[i, hits[0] + 1:] = eos_ids[0]
    return {"sequences": np.concatenate([input_ids, gen], axis=1),
            "generated": gen, "ttft_s": ttft, "seq_lens": seq_lens}


class CausalLMApplication:
    """Contiguous-KV causal LM on one card: the cache holds
    ``kv_cache_batch_size`` rows of ``seq_len`` slots."""

    # per-row keys of a generate() result (the repad shim slices them)
    _row_keys = ("sequences", "generated", "seq_lens")

    def __init__(self, model_path: Optional[str], config: InferenceConfig,
                 family: Optional[Type[DecoderFamily]] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.model_path = model_path
        self.config = config
        self.tpu_config: TpuConfig = config.tpu_config
        self.family = family or family_for_config(config)
        self.spec = self.family.build_spec(config, tp_degree=1)
        self.params = None
        self.cache = None
        self.generator = torch.Generator(device=self.device).manual_seed(
            self.tpu_config.seed)
        self.ctx_buckets = autobucketing.context_encoding_buckets(
            self.tpu_config)
        self.tkg_buckets = autobucketing.token_generation_buckets(
            self.tpu_config)
        self.batch_buckets = autobucketing.batch_buckets(self.tpu_config)
        self._inv_freq = model_base.rope_inv_freq(self.spec, self.device)

    # -- weights -----------------------------------------------------------
    def load_weights(self, model_path: Optional[str] = None):
        """Load + convert a HF safetensors checkpoint onto the device."""
        sd = ckpt.load_state_dict(model_path or self.model_path)
        self._put_params(self.family.convert_hf_state_dict(sd, self.spec))
        return self

    def init_random_weights(self, seed: int = 0):
        """Synthetic weights made on the device from ``seed``."""
        self.params = model_base.init_params(self.spec, seed, self.device)
        return self

    def _put_params(self, host: Dict[str, Any]):
        host = model_base.fuse_qkv_host(host)
        dt = self.spec.dtype

        def put(node):
            if isinstance(node, dict):
                return {k: put(v) for k, v in node.items()}
            return tensor_from_numpy(np.asarray(node), self.device).to(dt)
        self.params = put(host)

    # -- cache -------------------------------------------------------------
    def init_cache(self):
        cfg = self.tpu_config
        self.cache = kvc.init_cache(kvc.KVCacheSpec(
            num_layers=self.spec.num_layers,
            batch_size=cfg.kv_cache_batch_size,
            max_seq_len=cfg.seq_len,
            num_kv_heads=self.spec.gqa.num_kv_heads,
            head_dim=self.spec.head_dim,
            dtype=self.spec.kv_dtype), self.device)
        return self

    # -- helpers -----------------------------------------------------------
    def _check_decode_fits(self, needed: int):
        """Decode writing KV slots up to ``needed - 1`` must stay inside
        the configured seq_len."""
        limit = self.tpu_config.seq_len
        if needed > limit:
            raise CapacityError(
                f"decode would write KV at position {needed - 1} past the "
                f"configured seq_len {limit}")

    def _kv_bucket(self, needed: int) -> Optional[int]:
        """Smallest decode bucket covering ``needed`` cache slots: the
        gather path reads cache[:bucket] only. None = the whole cache."""
        if len(self.tkg_buckets) <= 1:
            return None
        return autobucketing.get_target_bucket(self.tkg_buckets, needed)

    def _default_sampling_params(self, batch: int):
        sc = self.tpu_config.on_device_sampling_config
        if sc is None:
            return None
        return torch.as_tensor(prepare_sampling_params(
            batch, sc.top_k, sc.top_p, sc.temperature), device=self.device)

    def _t(self, x, dtype=torch.int32) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=dtype)
        return torch.as_tensor(np.asarray(x), dtype=dtype,
                               device=self.device)

    def _seq_ids(self, b: int, seq_ids) -> torch.Tensor:
        """Cache rows of a step; non-identity rows need continuous
        batching (the static graphs skip the row gather)."""
        if seq_ids is None:
            return torch.arange(b, dtype=torch.int32, device=self.device)
        if (not self.tpu_config.is_continuous_batching
                and not np.array_equal(np.asarray(seq_ids), np.arange(b))):
            raise ValueError("non-identity seq_ids require "
                             "is_continuous_batching=True")
        return self._t(seq_ids)

    # -- device steps ------------------------------------------------------
    def _run_prefill(self, input_ids, seq_lens, seq_ids=None,
                     sampling_params=None):
        """Prefill of a (B, bucket) right-padded window
        (``model_base.context_encoding_step``); the cache is written in
        place. Returns {"tokens", ["logits"]} on the device."""
        b, s = np.shape(input_ids)
        sid = self._seq_ids(b, seq_ids)
        pos = torch.arange(s, dtype=torch.int32,
                           device=self.device)[None, :].expand(b, s)
        if sampling_params is None:
            sampling_params = self._default_sampling_params(b)
        return model_base.context_encoding_step(
            self.spec, self.tpu_config, self.params, self.cache,
            self._t(input_ids), pos, sid, self._t(seq_lens),
            sampling_params, self.generator, self._inv_freq)

    def _run_decode(self, input_ids, position_ids, seq_ids=None,
                    sampling_params=None):
        """One decode step (``model_base.token_generation_step``)."""
        b, t = np.shape(input_ids)
        sid = self._seq_ids(b, seq_ids)
        needed = int(np.max(np.asarray(position_ids))) + t
        self._check_decode_fits(needed)
        if sampling_params is None:
            sampling_params = self._default_sampling_params(b)
        return model_base.token_generation_step(
            self.spec, self.tpu_config, self.params, self.cache,
            self._t(input_ids), self._t(position_ids), sid, sampling_params,
            self.generator, self._kv_bucket(needed), self._inv_freq)

    def _run_decode_loop(self, first_tokens, positions, num_steps: int,
                         seq_ids=None, sampling_params=None):
        """``num_steps`` decode steps with the tokens on the device
        (``model_base.decode_loop``)."""
        b = np.shape(first_tokens)[0]
        sid = self._seq_ids(b, seq_ids)
        needed = int(np.max(np.asarray(positions))) + num_steps
        self._check_decode_fits(needed)
        if sampling_params is None:
            sampling_params = self._default_sampling_params(b)
        return model_base.decode_loop(
            self.spec, self.tpu_config, self.params, self.cache,
            self._t(first_tokens), self._t(positions), sid, sampling_params,
            self.generator, num_steps=num_steps,
            kv_view=self._kv_bucket(needed), inv_freq=self._inv_freq)

    def warmup(self):
        """Run every bucket once (the shapes ``generate`` will run)."""
        if self.params is None:
            self.init_random_weights()
        if self.cache is None:
            self.init_cache()
        cfg = self.tpu_config
        b = cfg.ctx_batch_size
        for s in self.ctx_buckets:
            self._run_prefill(np.zeros((b, s), np.int32),
                              np.ones((b,), np.int32))
        chunk = max(cfg.decode_chunk_tokens, 1)
        starts = [1] if len(self.tkg_buckets) <= 1 else [
            max(bk - chunk, 1) for bk in self.tkg_buckets]
        warm_batches = sorted(set(self.batch_buckets)
                              | {cfg.tkg_batch_size or cfg.batch_size})
        for start in starts:
            for bb in warm_batches:
                if chunk > 1:
                    self._run_decode_loop(np.zeros((bb,), np.int32),
                                          np.full((bb,), start, np.int32),
                                          chunk)
                self._run_decode(np.zeros((bb, 1), np.int32),
                                 np.full((bb, 1), start, np.int32))
        return self

    # -- generation --------------------------------------------------------
    def _generate_repadded(self, input_ids: np.ndarray, **kw
                           ) -> Dict[str, Any]:
        """Batch-mismatch shim: b below a batch bucket pads by REPEATING
        ROW 0 (pad rows recompute row 0 and rewrite its cache rows with the
        same values); b above the compiled batch splits into batch-sized
        chunks run one after the other."""
        b_in = input_ids.shape[0]
        cfg = self.tpu_config
        per_row = ("attention_mask", "sampling_params", "teacher_tokens")

        def _batchful(k, x):
            return k in per_row and x is not None

        if b_in > cfg.batch_size:
            outs = []
            for lo in range(0, b_in, cfg.batch_size):
                hi = min(lo + cfg.batch_size, b_in)
                sub = {k: (np.asarray(v)[lo:hi] if _batchful(k, v) else v)
                       for k, v in kw.items()}
                outs.append(self.generate(input_ids[lo:hi], **sub))

            def _cat(key):
                arrs = [np.asarray(o[key]) for o in outs]
                if arrs[0].ndim == 1:
                    return np.concatenate(arrs)
                w = max(a.shape[1] for a in arrs)
                return np.concatenate(
                    [np.pad(a, ((0, 0), (0, w - a.shape[1]))) for a in arrs])

            merged = {key: _cat(key) for key in self._row_keys}
            merged["ttft_s"] = outs[0]["ttft_s"]
            if kw.get("return_logits") and "logits" in outs[0]:
                n_steps = max(len(o["logits"]) for o in outs)
                merged["logits"] = [
                    np.concatenate([np.asarray(
                        o["logits"][min(si, len(o["logits"]) - 1)])
                        for o in outs], axis=0)
                    for si in range(n_steps)]
            return merged

        pad = autobucketing.get_target_bucket(self.batch_buckets,
                                              b_in) - b_in

        def _pad0(k, x):
            if not _batchful(k, x):
                return x
            a = np.asarray(x)
            return np.concatenate([a, np.repeat(a[:1], pad, axis=0)])

        kw2 = {k: _pad0(k, v) for k, v in kw.items()}
        padded_ids = np.concatenate(
            [input_ids, np.repeat(input_ids[:1], pad, axis=0)])
        out = self.generate(padded_ids, **kw2)
        res = dict(out)
        for key in self._row_keys:
            res[key] = np.asarray(out[key])[:b_in]
        if "logits" in out:
            res["logits"] = [np.asarray(lg)[:b_in] for lg in out["logits"]]
        return res

    def generate(self, input_ids: np.ndarray,
                 attention_mask: Optional[np.ndarray] = None,
                 max_new_tokens: int = 128,
                 eos_token_id: Optional[int] = None,
                 sampling_params: Optional[np.ndarray] = None,
                 return_logits: bool = False,
                 teacher_tokens: Optional[np.ndarray] = None
                 ) -> Dict[str, Any]:
        """Greedy/sampled generation. input_ids (B, S) right-padded;
        attention_mask (B, S) marks real tokens. Returns sequences
        including the prompt (HF convention), ``generated``, ``seq_lens``,
        ``ttft_s`` and, with ``return_logits`` (and ``output_logits`` in
        the config), the logits of every step.

        ``teacher_tokens`` (B, T): feed these instead of the sampled tokens
        at decode steps 1..T (teacher forcing, for logit matching).

        Tokens stay on the device between steps; the eos check runs one
        chunk late, as the JAX app's overlapped fetch does."""
        input_ids = np.asarray(input_ids)
        b, s = input_ids.shape
        if b not in self.batch_buckets:
            return self._generate_repadded(
                input_ids, attention_mask=attention_mask,
                max_new_tokens=max_new_tokens, eos_token_id=eos_token_id,
                sampling_params=sampling_params, return_logits=return_logits,
                teacher_tokens=teacher_tokens)
        if attention_mask is None:
            attention_mask = np.ones_like(input_ids)
        seq_lens = attention_mask.astype(np.int32).sum(axis=1)
        if self.cache is None:
            self.init_cache()
        if self.params is None:
            raise RuntimeError("load_weights() or init_random_weights() "
                               "first")
        if sampling_params is not None:
            sampling_params = torch.as_tensor(np.asarray(sampling_params),
                                              device=self.device)
        if teacher_tokens is not None:
            teacher_tokens = np.asarray(teacher_tokens)
            max_new_tokens = min(max_new_tokens,
                                 teacher_tokens.shape[1] + 1)
        bucket = autobucketing.get_target_bucket(self.ctx_buckets, s)
        padded = np.zeros((b, bucket), input_ids.dtype)
        padded[:, :s] = input_ids
        if int(seq_lens.max()) + max_new_tokens > self.tpu_config.seq_len:
            max_new_tokens = self.tpu_config.seq_len - int(seq_lens.max())
            if max_new_tokens <= 0:
                raise ValueError("prompt exceeds seq_len")

        t0 = time.perf_counter()
        out = self._run_prefill(padded, seq_lens,
                                sampling_params=sampling_params)
        first = out["tokens"]
        logits_trace: List[np.ndarray] = (
            [out["logits"].cpu().numpy()]
            if return_logits and "logits" in out else [])
        eos_ids = (None if eos_token_id is None
                   else np.atleast_1d(np.asarray(eos_token_id, np.int64)))
        collected = [first[:, None]]
        pending = first[:, None]          # tokens not yet eos-checked
        ttft = None
        positions = seq_lens.astype(np.int32)
        n_generated = 1
        eos_seen = np.zeros((b,), bool) if eos_ids is not None else None
        chunk = max(self.tpu_config.decode_chunk_tokens, 1)
        while n_generated < max_new_tokens:
            remaining = max_new_tokens - n_generated
            n = chunk if remaining >= chunk else 1
            cur = collected[-1][:, -1]
            if teacher_tokens is not None:
                cur = teacher_tokens[:, n_generated - 1].astype(np.int32)
                n = 1
            if n == 1 or return_logits:
                o = self._run_decode(cur[:, None], positions[:, None],
                                     sampling_params=sampling_params)
                new = o["tokens"].reshape(b, 1)
                if return_logits and "logits" in o:
                    logits_trace.append(o["logits"].cpu().numpy())
                positions = positions + 1
                n_generated += 1
            else:
                new = self._run_decode_loop(
                    cur, positions, n,
                    sampling_params=sampling_params)["tokens"]
                positions = positions + n
                n_generated += n
            collected.append(new)
            if ttft is None:
                first.cpu()
                ttft = time.perf_counter() - t0
            if eos_seen is not None:
                eos_seen |= np.isin(pending.cpu().numpy(),
                                    eos_ids).any(axis=1)
                pending = new
                if eos_seen.all():
                    break
        if ttft is None:
            first.cpu()
            ttft = time.perf_counter() - t0
        collected = [np.asarray(c.cpu().numpy()) for c in collected]
        result = _finalize_generation(input_ids, collected, eos_ids, ttft,
                                      seq_lens)
        if return_logits:
            result["logits"] = logits_trace
        return result

    def reset(self):
        """Clear the KV cache between requests."""
        self.init_cache()
        return self


class PagedCausalLMApplication(CausalLMApplication):
    """Paged-KV (block layout) causal LM with prefix caching on one card."""

    _row_keys = CausalLMApplication._row_keys + ("cached_tokens",)

    def __init__(self, model_path: Optional[str], config: InferenceConfig,
                 family: Optional[Type[DecoderFamily]] = None,
                 device: DeviceLike = None):
        if not config.tpu_config.is_block_kv_layout:
            raise ConfigurationError("the paged application needs "
                                     "is_block_kv_layout=True")
        super().__init__(model_path, config, family, device)

    # -- cache -------------------------------------------------------------
    def init_cache(self):
        cfg = self.tpu_config
        bspec = BlockKVSpec(
            num_layers=self.spec.num_layers,
            num_blocks=cfg.pa_num_blocks + 1,    # +1: reserved null block 0
            block_size=cfg.pa_block_size,
            num_kv_heads=self.spec.gqa.num_kv_heads,
            head_dim=self.spec.head_dim,
            dtype=self.spec.kv_dtype,
        )
        self.kv_mgr = BlockKVCacheManager(
            bspec, self.device, enable_prefix_caching=cfg.is_prefix_caching)
        # the application owns the live cache tensors; the manager keeps the
        # allocator and the tables
        self.cache = self.kv_mgr.cache
        self.kv_mgr.cache = None
        self.max_blocks = bspec.blocks_for(cfg.seq_len)
        self._bt_buckets = autobucketing.block_table_buckets(
            cfg, self.max_blocks)
        return self

    # -- helpers -----------------------------------------------------------
    def _bt_width(self, b: int) -> int:
        return self._bt_width_for(range(b))

    def _bt_width_for(self, seq_ids) -> int:
        """Smallest block-table width bucket covering every live row."""
        live = max((len(self.kv_mgr.tables.get(i, ())) for i in seq_ids),
                   default=1)
        return autobucketing.get_target_bucket(self._bt_buckets,
                                               max(live, 1))

    # -- device steps ------------------------------------------------------
    def _run_paged(self, input_ids, position_ids, slot_mapping, block_table,
                   last_idx, sampling_params=None):
        """One paged step (``model_base.paged_forward_step``); the cache is
        written in place. Returns {"tokens", ["logits"]} on the device."""
        if sampling_params is None:
            sampling_params = self._default_sampling_params(
                np.shape(input_ids)[0])
        return model_base.paged_forward_step(
            self.spec, self.tpu_config, self.params, self.cache,
            self._t(input_ids), self._t(position_ids),
            self._t(slot_mapping), self._t(block_table), self._t(last_idx),
            sampling_params, self.generator, self._inv_freq)

    def _run_ragged(self, input_ids, position_ids, slot_mapping,
                    block_table, widths, emit_modes, sampling_params=None):
        """ONE ragged mixed step (``model_base.paged_ragged_step``): rows
        mix decode steps, prefill chunks and verify windows, each at its
        own offset over its own block table. The host arrays are numpy:
        the capacity check and the verify test read them without touching
        the device. The cache is written in place. Returns {"tokens",
        "num_emitted"} on the device."""
        pos = np.asarray(position_ids)
        wid = np.asarray(widths)
        emit = np.asarray(emit_modes)
        self._check_decode_fits(int(np.max(pos[:, 0] + wid)))
        if sampling_params is None:
            sampling_params = self._default_sampling_params(pos.shape[0])
        return model_base.paged_ragged_step(
            self.spec, self.tpu_config, self.params, self.cache,
            self._t(input_ids), self._t(pos), self._t(slot_mapping),
            self._t(block_table), self._t(wid), self._t(emit),
            sampling_params, self.generator, self._inv_freq,
            verify=bool((emit == model_base.EMIT_VERIFY).any()))

    def _run_paged_loop(self, first_tokens, positions, block_table,
                        num_steps: int, sampling_params=None):
        """``num_steps`` decode steps with in-device slot advance
        (``model_base.paged_decode_loop``); blocks for the horizon must be
        allocated already."""
        self._check_decode_fits(
            int(np.max(np.asarray(positions))) + num_steps)
        if sampling_params is None:
            sampling_params = self._default_sampling_params(
                np.shape(first_tokens)[0])
        return model_base.paged_decode_loop(
            self.spec, self.tpu_config, self.params, self.cache,
            self._t(first_tokens), self._t(positions),
            self._t(block_table), sampling_params, self.generator,
            num_steps=num_steps, inv_freq=self._inv_freq)

    def warmup(self):
        """Run the paged step once at each shape it will run (the prefill
        widths and the T=1 decode step). Every slot is negative, so nothing
        is written."""
        if self.params is None:
            self.init_random_weights()
        if self.cache is None:
            self.init_cache()
        cfg = self.tpu_config
        b = cfg.batch_size
        widths = {1}
        if cfg.is_chunked_prefill and cfg.chunked_prefill_config is not None:
            widths.add(cfg.chunked_prefill_config.kernel_q_tile_size)
        widths.update(self.ctx_buckets)
        chunk = max(cfg.decode_chunk_tokens, 1)
        for tw in self._bt_buckets:
            bt = np.zeros((b, tw), np.int32)   # null block only
            for w in sorted(widths):
                self._run_paged(np.zeros((b, w), np.int32),
                                np.zeros((b, w), np.int32),
                                np.full((b, w), -1, np.int32), bt,
                                np.zeros((b,), np.int32))
            if chunk > 1:
                self._run_paged_loop(np.zeros((b,), np.int32),
                                     np.zeros((b,), np.int32), bt, chunk)
        return self

    # -- generation --------------------------------------------------------
    def generate(self, input_ids: np.ndarray,
                 attention_mask: Optional[np.ndarray] = None,
                 max_new_tokens: int = 128,
                 eos_token_id: Optional[int] = None,
                 sampling_params: Optional[np.ndarray] = None,
                 return_logits: bool = False,
                 teacher_tokens: Optional[np.ndarray] = None
                 ) -> Dict[str, Any]:
        """Paged generation. input_ids (B, S) right-padded; attention_mask
        (B, S) marks real tokens. Prefix-cached prompt blocks are not
        recomputed. Returns sequences including the prompt (HF convention),
        ``generated``, ``cached_tokens`` and, with ``return_logits`` (and
        ``output_logits`` in the config), the per-step logits.

        ``teacher_tokens`` (B, T): feed these instead of the sampled tokens
        at decode steps 1..T (the contract of the JAX contiguous app's
        teacher forcing, for logit matching; the JAX paged app does not
        take it)."""
        if teacher_tokens is not None:
            teacher_tokens = np.asarray(teacher_tokens)
            max_new_tokens = min(max_new_tokens,
                                 teacher_tokens.shape[1] + 1)
        logits_trace: List[np.ndarray] = []
        input_ids = np.asarray(input_ids)
        b, s = input_ids.shape
        if b not in self.batch_buckets:
            return self._generate_repadded(
                input_ids, attention_mask=attention_mask,
                max_new_tokens=max_new_tokens, eos_token_id=eos_token_id,
                sampling_params=sampling_params, return_logits=return_logits,
                teacher_tokens=teacher_tokens)
        if attention_mask is None:
            attention_mask = np.ones_like(input_ids)
        seq_lens = attention_mask.astype(np.int32).sum(axis=1)
        if self.params is None:
            raise RuntimeError("load_weights() or init_random_weights() "
                               "first")
        if self.cache is None:
            self.init_cache()
        if sampling_params is not None:
            sampling_params = torch.as_tensor(np.asarray(sampling_params),
                                              device=self.device)
        eos_ids = (None if eos_token_id is None
                   else np.atleast_1d(np.asarray(eos_token_id, np.int64)))

        # --- allocate blocks; discover the cached prefix per row ---
        cfg = self.tpu_config
        chunked = (cfg.is_chunked_prefill
                   and cfg.chunked_prefill_config is not None)
        cached = np.zeros((b,), np.int32)
        bsz = self.kv_mgr.spec.block_size
        batch_fresh: set = set()      # blocks first written by THIS call
        for i in range(b):
            toks = input_ids[i, :seq_lens[i]].tolist()
            blocks, c = self.kv_mgr.begin_sequence(i, toks)
            if chunked:
                c = cut_cached_at_unwritten(blocks, c, bsz, batch_fresh)
            batch_fresh.update(blocks[c // bsz:])
            # always recompute >= 1 token so there are logits to sample
            cached[i] = min(c, seq_lens[i] - 1)
        bt = self.kv_mgr.block_table_array(range(b), self._bt_width(b))

        # --- prefill the uncached suffixes ---
        suffix_lens = seq_lens - cached
        t_max = int(suffix_lens.max())
        chunk_w = (cfg.chunked_prefill_config.kernel_q_tile_size
                   if chunked else 0)

        def _prefill_window(off_w, width, last_idx):
            ids_w = np.zeros((b, width), np.int32)
            pos_w = np.zeros((b, width), np.int32)
            for i in range(b):
                lo = cached[i] + off_w[i]
                n = int(np.clip(seq_lens[i] - lo, 0, width))
                ids_w[i, :n] = input_ids[i, lo:lo + n]
                pos_w[i] = lo + np.arange(width, dtype=np.int32)
            valid = (np.arange(width)[None, :]
                     < (seq_lens - cached - off_w)[:, None])
            # padded tail positions: negative slots write nothing
            slot_pos = np.where(valid, pos_w, -1)
            slots = slots_from_table(bt, slot_pos, bsz)
            return self._run_paged(ids_w, pos_w, slots, bt, last_idx,
                                   sampling_params)

        t0 = time.perf_counter()
        if chunk_w and t_max > chunk_w:
            n_chunks = -(-t_max // chunk_w)
            tokens = np.zeros((b, 1), np.int32)
            off = np.zeros((b,), np.int32)
            for _ in range(n_chunks):
                last_idx = np.clip(suffix_lens - 1 - off, 0, chunk_w - 1)
                out = _prefill_window(off, chunk_w, last_idx)
                toks = out["tokens"].cpu().numpy().reshape(b)
                final_here = ((suffix_lens - 1 >= off)
                              & (suffix_lens - 1 < off + chunk_w))
                tokens[final_here, 0] = toks[final_here]
                off = off + chunk_w
        else:
            bucket = autobucketing.get_target_bucket(self.ctx_buckets, t_max)
            out = _prefill_window(np.zeros((b,), np.int32), bucket,
                                  np.maximum(suffix_lens - 1, 0))
            tokens = out["tokens"].cpu().numpy().reshape(b, 1)
        ttft = time.perf_counter() - t0
        if return_logits and "logits" in out:
            logits_trace.append(out["logits"].cpu().numpy())

        collected = [tokens]
        positions = seq_lens.astype(np.int32)
        n_generated = 1
        eos_seen = np.zeros((b,), bool) if eos_ids is not None else None
        if eos_seen is not None:
            eos_seen |= np.isin(tokens[:, 0], eos_ids)
        # chunked paged decode: blocks for the whole chunk are allocated on
        # the host, then decode_chunk_tokens steps run with slots computed
        # on the device; return_logits / teacher forcing keep single steps
        chunk = (1 if (return_logits or teacher_tokens is not None)
                 else max(cfg.decode_chunk_tokens, 1))
        while n_generated < max_new_tokens:
            room = cfg.seq_len - int(positions.max())
            remaining = min(max_new_tokens - n_generated, room)
            steps = chunk if remaining >= chunk else 1
            steps = min(steps, remaining)
            if steps <= 0:
                break
            for i in range(b):
                self.kv_mgr.grow(i, steps)
            bt = self.kv_mgr.block_table_array(range(b), self._bt_width(b))
            cur = (teacher_tokens[:, n_generated - 1].astype(np.int32)
                   if teacher_tokens is not None
                   else collected[-1][:, -1].astype(np.int32))
            if steps == 1:
                pos = positions[:, None]
                slots = slots_from_table(bt, pos, bsz)
                o = self._run_paged(cur[:, None], pos, slots, bt,
                                    np.zeros((b,), np.int32),
                                    sampling_params)
                new = o["tokens"].cpu().numpy().reshape(b, 1)
                if return_logits and "logits" in o:
                    logits_trace.append(o["logits"].cpu().numpy())
            else:
                o = self._run_paged_loop(cur, positions, bt, steps,
                                         sampling_params)
                new = o["tokens"].cpu().numpy()
            collected.append(new)
            positions = positions + steps
            n_generated += steps
            if eos_seen is not None:
                eos_seen |= np.isin(new, eos_ids).any(axis=1)
                if eos_seen.all():
                    break

        result = _finalize_generation(input_ids, collected, eos_ids, ttft,
                                      seq_lens)
        result["cached_tokens"] = cached.copy()
        if return_logits:
            result["logits"] = logits_trace
        return result

    def release(self, seq_ids=None):
        """Return sequences' blocks to the allocator (prefix-cached blocks
        stay resident for reuse)."""
        ids = list(self.kv_mgr.tables) if seq_ids is None else list(seq_ids)
        for sid in ids:
            if sid in self.kv_mgr.tables:
                self.kv_mgr.end_sequence(sid)
        return self

    def reset(self):
        self.release()
        return self
