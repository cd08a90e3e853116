"""Fused speculative decoding on the contiguous cache (counterpart:
``neuronx_distributed_inference_tpu/models/speculation.py`` —
``draft_k_tokens`` :40, ``fused_speculation_step`` :57,
``SpeculativeDecoder`` :110; EAGLE :208-435 (``eagle_draft_param_specs``
:208, ``init_eagle_draft_params`` :221, ``eagle_forward`` :227,
``eagle_speculation_step`` :253, ``_prime_eagle_draft`` :322,
``_eagle_host_loop`` :335, ``EagleDecoder`` :378); Medusa :442-559
(``medusa_propose`` :442, ``medusa_propose_scored`` :448,
``medusa_speculation_step`` :464, ``MedusaDecoder`` :489); token trees
:567-1096 (``tree_forward`` :567, ``medusa_tree_step`` :589,
``MedusaTreeDecoder`` :645, ``build_lattice`` :754,
``dynamic_tree_select`` :777, ``dynamic_medusa_tree_step`` :799,
``DynamicTreeDecoder`` :883, ``eagle_propose_scored`` :967,
``eagle_tree_step`` :995, ``EagleTreeDecoder`` :1036)).

Greedy speculation emits the target's own choices, whatever was drafted,
so every decoder here gives the stream of plain greedy decode. The draft
side differs by mode: a separate draft application (fused speculation),
the EAGLE draft (one or a few decoder layers reading the target's hidden
state through ``fc``), or the Medusa heads on the target's features; a
token tree verifies several drafted paths in one target forward.

The caches are written IN PLACE (the reference returns the donated
caches). A step writes more slots than a row accepts: the draft k, the
verify k + 1, a tree its nodes. The next step rewrites those slots before
any query reads them, and until then the position mask hides them (a
query at position p reads slots < p, and the decode kernel's ``lens`` is
the step's position, never a stored length). Writes the reference pushes
to ``cache_len`` (the EAGLE refresh of the rejected columns, the tree
refresh's tail) are dropped, as the TPU's out-of-range scatter drops them.

Every draft step is a T = 1 decode over the contiguous cache with identity
rows, so it takes the contiguous decode kernel
(``csrc/decode_attention.cu``) wherever ``model_base.
use_contiguous_decode_kernel`` admits it; verifies and refreshes (T > 1)
take the gather path and ``mha``.

Where the reference jits one step, a decoder here runs it eagerly on the
CPU and, on the card, captures it once per (mode, batch, width) signature
into a CUDA graph (``models/cuda_graphs.StepGraphs``) and replays it: the
k draft steps, the verify, the acceptance and the refresh in one replay.
A failed capture raises. The graph's inputs are int32 (tokens, positions,
rows); the float state that crosses steps (EAGLE's previous hidden state,
the Medusa feature) lives in a device buffer per batch that the step
reads; the step returns the next value, copied into the buffer after the
replay (so the capture's eager warm-up runs, which repeat the step on the
same inputs, all read the same state). The host makes one fetch a step
(the emitted tokens with their counts). The graphs read the applications' parameter and cache
tensors: a decoder drops its graphs when either application's ``params``
or ``cache`` object is replaced.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import TpuConfig
from ..modules import kv_cache as kv_mod
from ..modules.token_tree import DEFAULT_TREE, TokenTree
from ..ops import decode_attention, sampling
from ..ops.normalization import rms_norm
from ..parallel.layers import ParamSpec
from . import model_base
from .cuda_graphs import StepGraphs
from .model_base import DecoderSpec

__all__ = [
    "draft_k_tokens", "fused_speculation_step", "SpeculativeDecoder",
    "eagle_draft_param_specs", "init_eagle_draft_params", "eagle_forward",
    "eagle_speculation_step", "EagleDecoder", "medusa_propose",
    "medusa_propose_scored", "medusa_speculation_step", "MedusaDecoder",
    "tree_forward", "medusa_tree_step", "MedusaTreeDecoder",
    "build_lattice", "dynamic_tree_select", "dynamic_medusa_tree_step",
    "DynamicTreeDecoder", "eagle_propose_scored", "eagle_tree_step",
    "EagleTreeDecoder", "tree_attention_mask",
]


def _no_logits(tpu_cfg: TpuConfig) -> TpuConfig:
    return (dataclasses.replace(tpu_cfg, output_logits=False)
            if tpu_cfg.output_logits else tpu_cfg)


def _top_k(x: torch.Tensor, k: int):
    """``sampling.top_k`` with int32 ids; at k = 1 the first maximum
    (``argmax``, the same tie order) without sorting the vocabulary."""
    if k == 1:
        idx = torch.argmax(x, dim=-1, keepdim=True)
        return torch.gather(x, -1, idx), idx.to(torch.int32)
    vals, idx = sampling.top_k(x, k)
    return vals, idx.to(torch.int32)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N) at one column per row idx (B,) -> (B,)."""
    return torch.gather(x, 1, idx.long()[:, None])[:, 0]


def _take_rows(h: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """h (B, N, H) at one column per row idx (B,) -> (B, H)."""
    return torch.gather(h, 1, idx.long()[:, None, None].expand(
        -1, 1, h.shape[-1]))[:, 0]


def _emitted(accepted: torch.Tensor, n_acc: torch.Tensor,
             bonus: torch.Tensor) -> torch.Tensor:
    """(B, W + 1): the W accepted-path tokens before ``n_acc``, then the
    bonus at ``n_acc``, then zeros (the reference's two-level where)."""
    b, w = accepted.shape
    idx = torch.arange(w + 1, device=accepted.device)[None, :]
    padded = torch.cat([accepted, torch.zeros_like(accepted[:, :1])], 1)
    return torch.where(idx < n_acc[:, None], padded,
                       torch.where(idx == n_acc[:, None], bonus[:, None],
                                   torch.zeros_like(padded))).to(torch.int32)


def _chain_accept(drafts: torch.Tensor, greedy: torch.Tensor):
    """Cumsum-of-mismatch acceptance (reference :88-91): drafts (B, k)
    against the target's choices at the k positions before them ->
    accepted count n_acc (B,) in [0, k] and the bonus, the target's choice
    at column n_acc."""
    k = drafts.shape[1]
    mismatch = (drafts != greedy[:, :k]).to(torch.int32)
    n_acc = (torch.cumsum(mismatch, dim=1) == 0).sum(dim=1)
    return n_acc, _take(greedy, n_acc)


def _arange_cols(base: torch.Tensor, n: int) -> torch.Tensor:
    """base (B,) -> (B, n) positions base + j."""
    return base[:, None] + torch.arange(n, dtype=base.dtype,
                                        device=base.device)[None, :]


# ---------------------------------------------------------------------------
# Fused draft / target speculation
# ---------------------------------------------------------------------------

def draft_k_tokens(spec: DecoderSpec, tpu_cfg: TpuConfig, params, cache,
                   first_token, positions, seq_ids, k: int,
                   inv_freq=None) -> torch.Tensor:
    """k greedy draft steps (reference :40-54, a ``lax.scan`` there): each
    a T = 1 ``token_generation_step`` writing its token's KV at its
    position. first_token, positions (B,): the last accepted token and its
    position. Returns the drafts (B, k) int32; the cache is written in
    place at [p, p + k)."""
    cfg = _no_logits(tpu_cfg)
    tok, pos = first_token, positions
    toks = []
    for _ in range(k):
        tok = model_base.token_generation_step(
            spec, cfg, params, cache, tok[:, None], pos[:, None], seq_ids,
            inv_freq=inv_freq)["tokens"]
        toks.append(tok)
        pos = pos + 1
    return torch.stack(toks, dim=1)


def fused_speculation_step(draft_spec: DecoderSpec, target_spec: DecoderSpec,
                           tpu_cfg: TpuConfig, draft_params, target_params,
                           draft_cache, target_cache, last_token, positions,
                           seq_ids, draft_inv_freq=None,
                           target_inv_freq=None) -> Dict[str, torch.Tensor]:
    """One fused speculation step (reference :57-107): k draft steps, the
    target's verify of all k + 1 candidates in one T = k + 1 forward,
    cumsum-of-mismatch acceptance and the bonus token. last_token (B,) at
    ``positions`` (B,). Returns {"tokens": (B, k + 1) (0 past the emitted
    prefix), "num_accepted": (B,) emitted per row (accepted + bonus),
    "logits_all": (B, k + 1, vocab) the verify's logits}; both caches are
    written in place."""
    k = tpu_cfg.speculation_length
    drafts = draft_k_tokens(draft_spec, tpu_cfg, draft_params, draft_cache,
                            last_token, positions, seq_ids, k,
                            draft_inv_freq)
    cand = torch.cat([last_token[:, None].to(torch.int32), drafts], dim=1)
    t_out = model_base.token_generation_multi(
        target_spec, tpu_cfg, target_params, target_cache, cand,
        _arange_cols(positions, k + 1), seq_ids, target_inv_freq)
    greedy = sampling.greedy_sample(t_out["logits_all"])
    n_acc, bonus = _chain_accept(drafts, greedy)
    return {"tokens": _emitted(drafts, n_acc, bonus),
            "num_accepted": (n_acc + 1).to(torch.int32),
            "logits_all": t_out["logits_all"]}


class _StepRunner:
    """A decoder's steps: eager on the CPU; on the card one captured CUDA
    graph per signature (``StepGraphs``), replayed afterwards. The graphs
    read the ``params`` / ``cache`` objects of the target application and
    of ``watched`` (a draft application or an EAGLE decoder): a replaced
    object drops every graph. The decode kernels' merge counters are
    pinned for the target's largest batch bucket at the most counters a
    row of the target or of ``draft_spec`` takes.
    ``state`` holds the float buffers
    that cross steps (one per name and shape), stable tensors that a
    captured graph reads."""

    def __init__(self, target_app, watched=(), draft_spec=None):
        cfg = target_app.tpu_config
        self.device = target_app.device
        self.apps = (target_app,) + tuple(watched)
        self.graphs: Optional[StepGraphs] = (
            StepGraphs(self.device) if self.device.type == "cuda" else None)
        self._rows = max(target_app.batch_buckets
                         + [cfg.kv_cache_batch_size or 0])
        self._counters = max(
            decode_attention.counters_per_row(s.gqa.num_kv_heads,
                                              s.gqa.q_per_kv)
            for s in (target_app.spec, draft_spec or target_app.spec))
        self._bound = None
        self.state: Dict[Tuple[str, int], torch.Tensor] = {}

    def _objects(self):
        return tuple((id(a.params), id(a.cache)) for a in self.apps)

    def buffer(self, name: str, shape, dtype) -> torch.Tensor:
        key = (name, tuple(shape), dtype)
        buf = self.state.get(key)
        if buf is None:
            buf = torch.zeros(shape, dtype=dtype, device=self.device)
            self.state[key] = buf
        return buf

    def run(self, sig, fn: Callable[[Dict[str, torch.Tensor]],
                                    Dict[str, torch.Tensor]],
            inputs: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        if self.graphs is None:
            return fn({k: (v if isinstance(v, torch.Tensor) else
                           torch.as_tensor(np.asarray(v), dtype=torch.int32))
                       .to(self.device, torch.int32)
                       for k, v in inputs.items()})
        objs = self._objects()
        if objs != self._bound:
            self.graphs.clear()
            self._bound = objs
        if not len(self.graphs):
            self.graphs.reserve(self._rows, self._counters)
        return self.graphs.run(sig, fn, inputs)


def _fetch(*tensors) -> np.ndarray:
    """The step's one blocking copy: int tensors (B,) or (B, n) side by
    side -> one (B, sum n) numpy array."""
    cols = [t.to(torch.int32).reshape(t.shape[0], -1) for t in tensors]
    return torch.cat(cols, dim=1).cpu().numpy()


def _prefill(app, input_ids: np.ndarray, seq_lens: np.ndarray):
    """The application's prefill of right-padded prompts at their own
    width, as the reference's decoders run it: no pad token past the
    widest prompt writes the cache, so the slots a draft loop leaves
    unwritten hold what the reference's hold."""
    if app.cache is None:
        app.init_cache()
    return app._run_prefill(input_ids, seq_lens)


def _prompt(input_ids, attention_mask):
    """(input_ids int32, seq_lens) of right-padded prompts."""
    input_ids = np.asarray(input_ids).astype(np.int32)
    if attention_mask is None:
        attention_mask = np.ones_like(input_ids)
    return input_ids, np.asarray(attention_mask).astype(np.int32).sum(axis=1)


def _host_loop(input_ids, first, seq_lens, max_new_tokens, eos_token_id,
               seq_len_cap, budget, step_fn, fill_eos=False):
    """The host loop shared by every decoder (reference :163-200,
    :335-375): ``step_fn(positions) -> (tokens (B, W), n_emit (B,))`` (one
    fetch) until every row has ``max_new_tokens`` or hit EOS, the last
    position plus ``budget`` staying below ``seq_len_cap``. Returns
    (generated (B, max_new_tokens), mean tokens per step); a short row is
    padded with its last token (``fill_eos``: with the first EOS id)."""
    b = input_ids.shape[0]
    eos_set = (None if eos_token_id is None else
               set(np.atleast_1d(np.asarray(eos_token_id)).tolist()))
    out_rows = [[int(first[i])] for i in range(b)]
    positions = seq_lens.astype(np.int32).copy()
    done = np.zeros((b,), bool)
    counts = []
    while (min(len(r) for r in out_rows) < max_new_tokens
           and int(positions.max()) + budget < seq_len_cap
           and not done.all()):
        toks, n_emit = step_fn(positions)
        counts.append(n_emit.copy())
        for i in range(b):
            if done[i]:
                continue
            for t in toks[i, :n_emit[i]].tolist():
                out_rows[i].append(int(t))
                if eos_set is not None and int(t) in eos_set:
                    done[i] = True
                    break
        positions = positions + n_emit.astype(np.int32)
    gen = np.zeros((b, max_new_tokens), np.int32)
    fill = (next(iter(eos_set)) if fill_eos and eos_set is not None
            else None)
    for i in range(b):
        row = out_rows[i][:max_new_tokens]
        gen[i, :len(row)] = row
        if len(row) < max_new_tokens:
            gen[i, len(row):] = row[-1] if fill is None else fill
    mean = float(np.mean(np.concatenate(counts))) if counts else 0.0
    return gen, mean


def _result(input_ids, gen, mean, key="mean_tokens_per_step"):
    return {"sequences": np.concatenate([input_ids, gen], axis=1),
            "generated": gen, key: mean}


class _Decoder:
    """What every decoder has: its step runner, and ``graphs``, the
    captured steps (None on the CPU)."""

    runner: _StepRunner

    @property
    def graphs(self) -> Optional[StepGraphs]:
        return self.runner.graphs


class SpeculativeDecoder(_Decoder):
    """Host orchestration of fused speculation (reference :110-200): a
    target and a draft ``CausalLMApplication`` with the same batch
    geometry, both prefilled, then one fused step per iteration (one CUDA
    graph per (batch, k) on the card). Rows advance by their own emitted
    counts, tracked per row."""

    def __init__(self, target_app, draft_app):
        self.target = target_app
        self.draft = draft_app
        cfg = target_app.tpu_config
        if (not cfg.speculation_config
                or cfg.speculation_config.speculation_length < 1):
            raise ValueError("target app needs "
                             "speculation_config.speculation_length >= 1")
        self.k = cfg.speculation_config.speculation_length
        self.runner = _StepRunner(target_app, (draft_app,), draft_app.spec)

    def _step(self, last, positions, seq_ids):
        t, d = self.target, self.draft

        def fn(x):
            out = fused_speculation_step(
                d.spec, t.spec, t.tpu_config, d.params, t.params, d.cache,
                t.cache, x["last"], x["pos"], x["sid"], d._inv_freq,
                t._inv_freq)
            return {"tokens": out["tokens"],
                    "num_accepted": out["num_accepted"]}
        out = self.runner.run(("fused", len(last), self.k), fn,
                              {"last": last, "pos": positions,
                               "sid": seq_ids})
        both = _fetch(out["tokens"], out["num_accepted"])
        return both[:, :-1], both[:, -1]

    def generate(self, input_ids: np.ndarray, max_new_tokens: int = 128,
                 eos_token_id: Optional[int] = None,
                 attention_mask: Optional[np.ndarray] = None
                 ) -> Dict[str, Any]:
        """Greedy speculative generation; the stream of greedy decode."""
        input_ids, seq_lens = _prompt(input_ids, attention_mask)
        b = input_ids.shape[0]
        t_out = _prefill(self.target, input_ids, seq_lens)
        _prefill(self.draft, input_ids, seq_lens)
        first = t_out["tokens"].cpu().numpy().astype(np.int32)
        state = {"last": first}
        seq_ids = np.arange(b, dtype=np.int32)

        def step_fn(positions):
            toks, n_emit = self._step(state["last"], positions, seq_ids)
            state["last"] = toks[np.arange(b), n_emit - 1].astype(np.int32)
            return toks, n_emit

        gen, mean = _host_loop(input_ids, first, seq_lens, max_new_tokens,
                               eos_token_id, self.target.tpu_config.seq_len,
                               self.k + 1, step_fn, fill_eos=True)
        return _result(input_ids, gen, mean)


# ---------------------------------------------------------------------------
# EAGLE
# ---------------------------------------------------------------------------

def eagle_draft_param_specs(draft_spec: DecoderSpec,
                            input_norm: bool = False) -> Dict[str, Any]:
    """The EAGLE draft's tree (reference :208-218): a small decoder plus
    the fusion ``fc`` (2H, H) mapping concat(embedding, previous hidden)
    to H, and with ``input_norm`` an RMSNorm ``fc_norm`` on the
    embedding."""
    specs = model_base.decoder_param_specs(draft_spec)
    H = draft_spec.hidden_size
    specs["fc"] = ParamSpec((2 * H, H), draft_spec.dtype)
    if input_norm:
        specs["fc_norm"] = ParamSpec((H,), draft_spec.dtype, "ones")
    return specs


def init_eagle_draft_params(draft_spec: DecoderSpec, seed: int,
                            device: torch.device,
                            input_norm: bool = False) -> Dict[str, Any]:
    """Random draft weights on ``device`` from one generator seeded with
    ``seed`` (as ``model_base.init_params``; not the JAX package's values
    for the same seed)."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def build(node, name):
        if isinstance(node, ParamSpec):
            return model_base.convert_leaf(draft_spec, name,
                                           node.initializer(gen, device))
        return {k: build(v, k) for k, v in sorted(node.items())}
    return build(eagle_draft_param_specs(draft_spec, input_norm), "")


def _refuse_learned_pos_draft(draft_spec: DecoderSpec):
    """The EAGLE draft embeds its tokens with no positions (reference
    :236), so a draft with a learned position table (GPT-2, openai-gpt)
    would skip it and propose from wrong features: refused."""
    if draft_spec.learned_pos:
        raise NotImplementedError("an EAGLE draft with a learned position "
                                  "table")


def eagle_forward(draft_spec: DecoderSpec, tpu_cfg: TpuConfig, params, cache,
                  tokens, prev_hidden, positions, seq_ids,
                  input_norm: bool = False, inv_freq=None):
    """The EAGLE draft forward (reference :227-250): token embeddings
    fused with the previous positions' hidden states through ``fc``, then
    the draft's layers, writing the draft KV at ``positions``. tokens,
    positions (B, T); prev_hidden (B, T, H), the feature of position - 1.
    A T = 1 step over identity rows takes the contiguous decode kernel.
    Returns {"logits": (B, T, vocab), "hidden": (B, T, H)}."""
    _refuse_learned_pos_draft(draft_spec)
    e = model_base._embed(draft_spec, params, tokens)
    if input_norm:
        e = rms_norm(e, params["fc_norm"], draft_spec.rms_eps)
    h0 = torch.cat([e, prev_hidden.to(e.dtype)], dim=-1) @ params["fc"]
    ai = model_base._decode_inputs(draft_spec, tpu_cfg, cache, positions,
                                   seq_ids, None, inv_freq)
    hidden = model_base.run_layers(draft_spec, params, cache, h0, ai,
                                   "decode")
    logits = model_base._lm_head(draft_spec, params, hidden)
    return {"logits": logits[..., :draft_spec.vocab_size], "hidden": hidden}


def _eagle_chain(draft_spec, tpu_cfg, draft_params, draft_cache, tok, hid,
                 positions, seq_ids, steps, input_norm, inv_freq,
                 top_k: int = 0):
    """``steps`` greedy T = 1 EAGLE draft steps from (tok, hid) at
    ``positions``. Returns the drafts (B, steps) and, with ``top_k``, each
    step's top-k ids and log-probabilities (B, steps, top_k)."""
    pos = positions
    toks, ids, lps = [], [], []
    for _ in range(steps):
        out = eagle_forward(draft_spec, tpu_cfg, draft_params, draft_cache,
                            tok[:, None], hid[:, None, :], pos[:, None],
                            seq_ids, input_norm, inv_freq)
        logits = out["logits"][:, -1, :]
        if top_k:
            lp, ix = _top_k(F.log_softmax(logits.float(), dim=-1),
                                  top_k)
            ids.append(ix)
            lps.append(lp)
            tok = ix[:, 0]
        else:
            tok = sampling.greedy_sample(logits)
        hid = out["hidden"][:, -1, :]
        toks.append(tok)
        pos = pos + 1
    drafts = torch.stack(toks, dim=1)
    if top_k:
        return drafts, torch.stack(ids, dim=1), torch.stack(lps, dim=1)
    return drafts


def eagle_speculation_step(draft_spec: DecoderSpec, target_spec: DecoderSpec,
                           tpu_cfg: TpuConfig, draft_params, target_params,
                           draft_cache, target_cache, last_token, prev_hidden,
                           positions, seq_ids, input_norm: bool = False,
                           draft_inv_freq=None, target_inv_freq=None):
    """One fused EAGLE step (reference :253-318): k draft steps, the
    target's verify, acceptance, then the draft-cache refresh with the
    verified pairs (slot p gets the token at p and the target's feature
    at p - 1; the columns past the accepted prefix are pushed to
    ``cache_len``, so they write nothing). last_token (B,) at
    ``positions``; prev_hidden (B, H) the target's feature at positions -
    1. Returns {"tokens", "num_emitted", "next_token", "next_hidden"};
    both caches are written in place."""
    k = tpu_cfg.speculation_length
    drafts = _eagle_chain(draft_spec, tpu_cfg, draft_params, draft_cache,
                          last_token, prev_hidden, positions, seq_ids, k,
                          input_norm, draft_inv_freq)
    cand = torch.cat([last_token[:, None].to(torch.int32), drafts], dim=1)
    cand_pos = _arange_cols(positions, k + 1)
    t_out = model_base.token_generation_multi(
        target_spec, tpu_cfg, target_params, target_cache, cand, cand_pos,
        seq_ids, target_inv_freq)
    greedy = sampling.greedy_sample(t_out["logits_all"])
    n_acc, bonus = _chain_accept(drafts, greedy)
    next_hidden = _take_rows(t_out["hidden"], n_acc)
    cache_len = kv_mod.cache_len_of(draft_cache)
    hid_seq = torch.cat([prev_hidden[:, None, :].to(t_out["hidden"].dtype),
                         t_out["hidden"][:, :k, :]], dim=1)
    idx = torch.arange(k + 1, device=cand.device)[None, :]
    refresh_pos = torch.where(idx <= n_acc[:, None], cand_pos,
                              torch.full_like(cand_pos, cache_len))
    eagle_forward(draft_spec, tpu_cfg, draft_params, draft_cache, cand,
                  hid_seq, refresh_pos, seq_ids, input_norm, draft_inv_freq)
    return {"tokens": _emitted(drafts, n_acc, bonus),
            "num_emitted": (n_acc + 1).to(torch.int32),
            "next_token": bonus, "next_hidden": next_hidden}


def _prime_eagle_draft(decoder, input_ids, hs, seq_lens, seq_ids):
    """Prime the draft cache over the prompts (reference :322-332): slot
    p <- (token p, target feature p - 1) for p in [1, len); positions at
    or past a row's length are pushed to ``cache_len`` (no write)."""
    b, s = input_ids.shape
    if s <= 1:
        return
    dev = decoder.target.device
    pos = np.broadcast_to(np.arange(1, s, dtype=np.int32), (b, s - 1))
    pos = np.where(pos < seq_lens[:, None], pos,
                   kv_mod.cache_len_of(decoder.draft_cache)).astype(np.int32)
    eagle_forward(decoder.draft_spec, decoder.target.tpu_config,
                  decoder.draft_params, decoder.draft_cache,
                  torch.as_tensor(input_ids[:, 1:], device=dev),
                  hs[:, :s - 1], torch.as_tensor(pos, device=dev),
                  torch.as_tensor(seq_ids, device=dev), decoder.input_norm,
                  decoder.draft_inv_freq)


class _EagleBase(_Decoder):
    """What the EAGLE decoders share: the draft, its rope table, the step
    runner and the prefill that primes the draft cache."""

    def __init__(self, target_app, draft_spec: DecoderSpec, draft_params,
                 draft_cache, input_norm: bool):
        self.target = target_app
        self.draft_spec = draft_spec
        self.draft_params = draft_params
        self.draft_cache = draft_cache
        self.input_norm = input_norm
        self.draft_inv_freq = model_base.rope_inv_freq(draft_spec,
                                                       target_app.device)
        self.runner = _StepRunner(target_app, (self,), draft_spec)

    # the runner watches these as it watches an application's
    @property
    def params(self):
        return self.draft_params

    @property
    def cache(self):
        return self.draft_cache

    def _start(self, input_ids, attention_mask):
        """Target prefill (its hidden states), the draft-cache priming and
        the per-batch previous-hidden buffer. Returns (input_ids,
        seq_lens, first tokens, seq_ids, hidden buffer)."""
        input_ids, seq_lens = _prompt(input_ids, attention_mask)
        b, s = input_ids.shape
        if not self.target.tpu_config.output_full_hidden:
            raise ValueError("target app needs output_full_hidden=True "
                             "(EAGLE primes the draft from prefill "
                             "hiddens)")
        seq_ids = np.arange(b, dtype=np.int32)
        t_out = _prefill(self.target, input_ids, seq_lens)
        hs = t_out["hidden_states"][:, :s]
        first = t_out["tokens"].cpu().numpy().astype(np.int32)
        _prime_eagle_draft(self, input_ids, hs, seq_lens, seq_ids)
        hid = self.runner.buffer("hidden", (b, hs.shape[-1]), hs.dtype)
        hid.copy_(_take_rows(hs, torch.as_tensor(seq_lens - 1,
                                                 device=hs.device)))
        return input_ids, seq_lens, first, seq_ids, hid


class EagleDecoder(_EagleBase):
    """Host orchestration of fused EAGLE speculation (reference :378-434).
    The reference's per-(seq, position) hidden-state buffer collapses to
    the (next token, next hidden) pair threaded between steps; the hidden
    half stays on the card in a buffer the step rewrites."""

    def __init__(self, target_app, draft_spec: DecoderSpec, draft_params,
                 draft_cache, input_norm: bool = False):
        _refuse_learned_pos_draft(draft_spec)
        cfg = target_app.tpu_config
        if (not cfg.speculation_config
                or cfg.speculation_config.speculation_length < 1):
            raise ValueError("speculation_config.speculation_length >= 1 "
                             "required")
        super().__init__(target_app, draft_spec, draft_params, draft_cache,
                         input_norm)
        self.k = cfg.speculation_config.speculation_length

    def generate(self, input_ids: np.ndarray, max_new_tokens: int = 128,
                 eos_token_id: Optional[int] = None,
                 attention_mask: Optional[np.ndarray] = None
                 ) -> Dict[str, Any]:
        input_ids, seq_lens, first, seq_ids, hid = self._start(
            input_ids, attention_mask)
        t = self.target
        state = {"root": first}

        def fn(x):
            out = eagle_speculation_step(
                self.draft_spec, t.spec, t.tpu_config, self.draft_params,
                t.params, self.draft_cache, t.cache, x["root"], hid,
                x["pos"], x["sid"], self.input_norm, self.draft_inv_freq,
                t._inv_freq)
            return {k: out[k] for k in ("tokens", "num_emitted",
                                        "next_token", "next_hidden")}

        def step_fn(positions):
            out = self.runner.run(("eagle", len(first), self.k), fn,
                                  {"root": state["root"], "pos": positions,
                                   "sid": seq_ids})
            hid.copy_(out["next_hidden"])
            both = _fetch(out["tokens"], out["num_emitted"],
                          out["next_token"])
            state["root"] = both[:, -1].astype(np.int32)
            return both[:, :-2], both[:, -2]

        gen, mean = _host_loop(input_ids, first, seq_lens, max_new_tokens,
                               eos_token_id, t.tpu_config.seq_len,
                               self.k + 1, step_fn)
        return _result(input_ids, gen, mean)


# ---------------------------------------------------------------------------
# Medusa
# ---------------------------------------------------------------------------

def medusa_propose(spec: DecoderSpec, params, hidden, top_k: int = 1):
    """The Medusa heads on (B, H) features (reference :442-445): head j
    (a ResBlock, then its lm head) predicts position + j + 2. Returns
    (B, M, top_k) token ids."""
    return medusa_propose_scored(spec, params, hidden, top_k)[0]


def medusa_propose_scored(spec: DecoderSpec, params, hidden, top_k: int = 1):
    """:func:`medusa_propose` with the log-probabilities (reference
    :448-461): (ids (B, M, k) int32, logprobs (B, M, k) fp32), ties in
    index order as ``lax.top_k``."""
    blocks = params["medusa_blocks"]
    h = hidden[:, None, :].to(blocks.dtype)
    r = h + F.silu(torch.einsum(
        "bmh,mhk->bmk", h.expand(h.shape[0], blocks.shape[0], h.shape[-1]),
        blocks) + params["medusa_bias"])
    logits = torch.einsum("bmh,mhv->bmv", r, params["medusa_lm"])
    logp = F.log_softmax(logits[..., :spec.vocab_size].float(), dim=-1)
    lp, idx = _top_k(logp, top_k)
    return idx, lp


def medusa_speculation_step(spec: DecoderSpec, tpu_cfg: TpuConfig, params,
                            cache, cand, positions, seq_ids, inv_freq=None):
    """One fused Medusa step (reference :464-486): verify the chain
    [last emitted, p1 .. p_{k-1}] in one forward, accept the matching
    prefix, emit the bonus and propose the next chain from the accepted
    position's feature. cand (B, k) at ``positions`` (B,)."""
    b, k = cand.shape
    out = model_base.token_generation_multi(
        spec, tpu_cfg, params, cache, cand, _arange_cols(positions, k),
        seq_ids, inv_freq)
    greedy = sampling.greedy_sample(out["logits_all"])
    n_acc, bonus = _chain_accept(cand[:, 1:], greedy)
    feat = _take_rows(out["hidden"], n_acc)
    props = medusa_propose(spec, params, feat)[:, :k - 1, 0]
    return {"tokens": _emitted(cand[:, 1:], n_acc, bonus),
            "num_emitted": (n_acc + 1).to(torch.int32),
            "next_cand": torch.cat([bonus[:, None], props], dim=1)}


class MedusaDecoder(_Decoder):
    """Host loop of Medusa speculation, chain mode (reference :489-559).
    The target's spec carries ``medusa_heads`` > 0 (its tree the heads)."""

    def __init__(self, target_app):
        self.target = target_app
        cfg = target_app.tpu_config
        sc = cfg.speculation_config
        if not sc or sc.medusa_speculation_length < 1:
            raise ValueError("speculation_config.medusa_speculation_length "
                             ">= 1 required")
        self.k = min(sc.medusa_speculation_length,
                     target_app.spec.medusa_heads + 1)
        self.runner = _StepRunner(target_app)

    def generate(self, input_ids: np.ndarray, max_new_tokens: int = 128,
                 eos_token_id: Optional[int] = None,
                 attention_mask: Optional[np.ndarray] = None
                 ) -> Dict[str, Any]:
        t = self.target
        input_ids, seq_lens = _prompt(input_ids, attention_mask)
        b = input_ids.shape[0]
        seq_ids = np.arange(b, dtype=np.int32)
        t_out = _prefill(t, input_ids, seq_lens)
        props = medusa_propose(t.spec, t.params, t_out["last_hidden"])
        cand = torch.cat([t_out["tokens"][:, None].to(torch.int32),
                          props[:, :self.k - 1, 0]], dim=1)
        first = t_out["tokens"].cpu().numpy().astype(np.int32)
        state = {"cand": cand}

        def fn(x):
            out = medusa_speculation_step(t.spec, t.tpu_config, t.params,
                                          t.cache, x["cand"], x["pos"],
                                          x["sid"], t._inv_freq)
            return out

        def step_fn(positions):
            out = self.runner.run(("medusa", b, self.k), fn,
                                  {"cand": state["cand"], "pos": positions,
                                   "sid": seq_ids})
            state["cand"] = out["next_cand"]
            both = _fetch(out["tokens"], out["num_emitted"])
            return both[:, :-1], both[:, -1]

        gen, mean = _host_loop(input_ids, first, seq_lens, max_new_tokens,
                               eos_token_id, t.tpu_config.seq_len, self.k,
                               step_fn)
        return _result(input_ids, gen, mean)


# ---------------------------------------------------------------------------
# Token trees
# ---------------------------------------------------------------------------

def _refuse_tree_target(spec: DecoderSpec):
    """Tree nodes sit at slots base + i with logical positions base +
    depth, and the reference embeds them with no positions (:580): an
    ALiBi bias over slot indices and a learned position table left out
    would both verify against wrong target logits, so both are refused."""
    if spec.alibi:
        raise NotImplementedError("token-tree speculation over ALiBi models")
    if spec.learned_pos:
        raise NotImplementedError("token-tree speculation over models with "
                                  "a learned position table")


def tree_forward(spec: DecoderSpec, tpu_cfg: TpuConfig, params, cache,
                 node_tokens, rope_positions, write_positions, seq_ids, mask,
                 inv_freq=None):
    """Forward over tree nodes with an explicit attention mask (reference
    :567-586): node i writes cache slot ``write_positions[:, i]`` (base +
    i) and attends per ``mask`` (B, N, S) (the committed prefix and its
    ancestors); RoPE takes the node's logical position (base + depth).
    The gather path (T = N > 1)."""
    if spec.layer_pattern is not None or spec.mixed_kv or spec.rolling_window:
        raise NotImplementedError("token-tree speculation over layer "
                                  "patterns or rolling / mixed caches")
    _refuse_tree_target(spec)
    ai = model_base.attn_inputs(spec, rope_positions, inv_freq)
    ai.update(seq_ids=seq_ids, positions=write_positions,
              identity=not tpu_cfg.is_continuous_batching, kv_view=None,
              side=None, use_kernel=False, mask=mask.bool())
    hidden = model_base.run_layers(
        spec, params, cache, model_base._embed(spec, params, node_tokens),
        ai, "decode")
    logits = model_base._lm_head(spec, params, hidden)
    return {"logits_all": logits[..., :spec.vocab_size], "hidden": hidden}


def _refresh_linear(spec, tpu_cfg, params, cache, root, tokens, n_acc,
                    base_pos, seq_ids, inv_freq):
    """The tree steps' cache refresh (reference :629-640): rewrite slots
    base .. base + n_acc + 1 with the linear accepted sequence [root,
    accepted .., bonus]; the tail columns are pushed to ``cache_len``."""
    refresh = torch.cat([root[:, None].to(torch.int32), tokens], dim=1)
    ridx = torch.arange(refresh.shape[1], device=refresh.device)[None, :]
    rpos = _arange_cols(base_pos, refresh.shape[1])
    rpos = torch.where(ridx <= (n_acc + 1)[:, None], rpos,
                       torch.full_like(rpos, kv_mod.cache_len_of(cache)))
    model_base.token_generation_multi(spec, tpu_cfg, params, cache, refresh,
                                      rpos, seq_ids, inv_freq)
    return refresh


def medusa_tree_step(spec: DecoderSpec, tpu_cfg: TpuConfig, params, cache,
                     node_tokens, base_pos, seq_ids, tree_mask, paths,
                     path_lens, depth, inv_freq=None):
    """One Medusa tree-verify step (reference :589-642). node_tokens (B,
    N), node 0 the last emitted token; tree_mask (B, N, S)
    (:func:`tree_attention_mask`); paths (P, D + 1) / path_lens (P,) of
    ``TokenTree.leaf_path_matrix``; depth (N,). Accepts the path with the
    most leading greedy matches, emits its tokens and the bonus, and
    returns the accepted node's feature."""
    b, n = node_tokens.shape
    rope_pos = base_pos[:, None] + depth[None, :]
    write_pos = _arange_cols(base_pos, n)
    out = tree_forward(spec, tpu_cfg, params, cache, node_tokens, rope_pos,
                       write_pos, seq_ids, tree_mask, inv_freq)
    greedy = sampling.greedy_sample(out["logits_all"])
    safe = paths.clamp(min=0).long()                         # (P, D+1)
    tok_at = node_tokens[:, safe]                            # (B, P, D+1)
    pred_at = greedy[:, safe]
    match = (tok_at[:, :, 1:] == pred_at[:, :, :-1]) & (paths[None, :, 1:]
                                                         >= 0)
    acc_len = torch.cumprod(match.to(torch.int32), dim=-1).sum(dim=-1)
    best = torch.argmax(acc_len, dim=-1)
    n_acc = _take(acc_len, best)
    best_path = safe[best]                                   # (B, D+1)
    path_toks = torch.gather(node_tokens, 1, best_path)
    path_pred = torch.gather(greedy, 1, best_path)
    bonus = _take(path_pred, n_acc)
    tokens = _emitted(path_toks[:, 1:], n_acc, bonus)
    feat = _take_rows(out["hidden"], _take(best_path, n_acc))
    _refresh_linear(spec, tpu_cfg, params, cache, node_tokens[:, 0], tokens,
                    n_acc, base_pos, seq_ids, inv_freq)
    return {"tokens": tokens, "num_emitted": (n_acc + 1).to(torch.int32),
            "bonus": bonus, "feature": feat}


def tree_attention_mask(ancestor: torch.Tensor, base_pos: torch.Tensor,
                        cache_len: int) -> torch.Tensor:
    """``TokenTree.attention_mask`` on the device: (B, N, S) where node i
    attends every slot < base and the slots base + j of its ancestors j
    (ancestor (B, N, N) or (N, N) bool, self included). Built from the
    positions on the device, so a replayed graph takes each replay's."""
    n = ancestor.shape[-1]
    slot = torch.arange(cache_len, device=base_pos.device)[None, None, :]
    j = slot - base_pos.long()[:, None, None]                # (B, 1, S)
    anc = (ancestor if ancestor.dim() == 3
           else ancestor[None].expand(base_pos.shape[0], n, n))
    tree = torch.gather(anc, 2, j.clamp(0, n - 1).expand(-1, n, -1))
    return (j < 0) | (tree & (j < n))


class MedusaTreeDecoder(_Decoder):
    """Host loop of Medusa TREE speculation (reference :645-742): the
    heads propose the top-w candidates of each level, the tree is
    verified in one forward and the best path wins. The next proposal is
    made at the start of the next step from the feature the step leaves
    in a device buffer (the reference proposes at the end of the step,
    from the same feature)."""

    def __init__(self, target_app, tree: Optional[TokenTree] = None):
        _refuse_tree_target(target_app.spec)
        self.target = target_app
        cfg = target_app.tpu_config
        sc = cfg.speculation_config
        if not sc or target_app.spec.medusa_heads < 1:
            raise ValueError("medusa heads required")
        if tree is None:
            tree = TokenTree.from_config(sc.token_tree_config
                                         or DEFAULT_TREE)
        if tree.max_depth > target_app.spec.medusa_heads:
            raise ValueError("tree deeper than medusa head count")
        self.tree = tree
        self.paths, self.path_lens = tree.leaf_path_matrix()
        self.max_width = int(tree.level_widths.max())
        dev = target_app.device
        self._t = {name: torch.as_tensor(x, device=dev) for name, x in (
            ("paths", self.paths), ("plens", self.path_lens),
            ("depth", tree.depth), ("anc", tree.ancestor_mask),
            ("dep_m1", np.maximum(tree.depth - 1, 0)),
            ("branch", tree.branch))}
        self.runner = _StepRunner(target_app)

    def _node_tokens(self, root, props):
        """(B, N) node tokens: node 0 the root, node i the proposal at
        (depth - 1, branch) (reference :669-678)."""
        t = self._t
        toks = props[:, t["dep_m1"].long(), t["branch"].long()]
        return torch.cat([root[:, None].to(torch.int32), toks[:, 1:]], 1)

    def generate(self, input_ids: np.ndarray, max_new_tokens: int = 128,
                 eos_token_id: Optional[int] = None,
                 attention_mask: Optional[np.ndarray] = None
                 ) -> Dict[str, Any]:
        t = self.target
        input_ids, seq_lens = _prompt(input_ids, attention_mask)
        b = input_ids.shape[0]
        seq_ids = np.arange(b, dtype=np.int32)
        t_out = _prefill(t, input_ids, seq_lens)
        first = t_out["tokens"].cpu().numpy().astype(np.int32)
        feat = self.runner.buffer("feature", t_out["last_hidden"].shape,
                                  t_out["last_hidden"].dtype)
        feat.copy_(t_out["last_hidden"])
        state = {"root": first}
        cache_len = t.tpu_config.seq_len
        tt = self._t

        def fn(x):
            props = medusa_propose(t.spec, t.params, feat, self.max_width)
            nodes = self._node_tokens(x["root"], props)
            mask = tree_attention_mask(tt["anc"], x["pos"], cache_len)
            out = medusa_tree_step(t.spec, t.tpu_config, t.params, t.cache,
                                   nodes, x["pos"], x["sid"], mask,
                                   tt["paths"], tt["plens"], tt["depth"],
                                   t._inv_freq)
            return {k: out[k] for k in ("tokens", "num_emitted", "bonus",
                                        "feature")}

        def step_fn(positions):
            out = self.runner.run(("medusa_tree", b), fn,
                                  {"root": state["root"], "pos": positions,
                                   "sid": seq_ids})
            feat.copy_(out["feature"])
            both = _fetch(out["tokens"], out["num_emitted"], out["bonus"])
            state["root"] = both[:, -1].astype(np.int32)
            return both[:, :-2], both[:, -2]

        gen, mean = _host_loop(input_ids, first, seq_lens, max_new_tokens,
                               eos_token_id, cache_len,
                               self.tree.num_nodes + 1, step_fn)
        return _result(input_ids, gen, mean)


def build_lattice(branch_k: int, depth: int):
    """Static numpy tables of the full k-ary lattice (reference :754-774):
    depth (N,), parent (N,), branch (N,), ancestor (N, N) incl. self,
    path (N, depth + 1) lattice ids from the root (-1 padded)."""
    nodes = [()]
    for d in range(depth):
        nodes += [p + (b,) for p in nodes if len(p) == d
                  for b in range(branch_k)]
    nodes = sorted(nodes, key=lambda p: (len(p), p))
    idx = {p: i for i, p in enumerate(nodes)}
    n = len(nodes)
    dep = np.array([len(p) for p in nodes], np.int32)
    par = np.array([idx[p[:-1]] if p else 0 for p in nodes], np.int32)
    br = np.array([p[-1] if p else 0 for p in nodes], np.int32)
    anc = np.zeros((n, n), bool)
    path = np.full((n, depth + 1), -1, np.int32)
    for i, p in enumerate(nodes):
        for d in range(len(p) + 1):
            anc[i, idx[p[:d]]] = True
            path[i, d] = idx[p[:d]]
    return dep, par, br, anc, path


def lattice_tensors(lat, device) -> Tuple[torch.Tensor, ...]:
    """:func:`build_lattice`'s tables on ``device`` (int64 indices, bool
    ancestors), moved once, before any graph capture."""
    dep, par, br, anc, path = lat
    return (torch.as_tensor(dep, device=device).long(),
            torch.as_tensor(par, device=device).long(),
            torch.as_tensor(br, device=device).long(),
            torch.as_tensor(anc, device=device),
            torch.as_tensor(path, device=device).long())


def dynamic_tree_select(lat, prop_logp, num_nodes: int):
    """The top-``num_nodes`` lattice nodes by joint log-probability
    (reference :777-796). ``lat`` = :func:`lattice_tensors`; prop_logp
    (B, D, k). Returns sel (B, M) lattice ids (root first, depth-sorted)
    and their scores."""
    dep, par, br, anc, path = lat
    n = dep.shape[0]
    edge_lp = torch.where(dep[None, :] > 0,
                          prop_logp[:, (dep - 1).clamp(min=0), br],
                          torch.zeros((), dtype=prop_logp.dtype,
                                      device=prop_logp.device))
    score = torch.einsum("bn,mn->bm", edge_lp, anc.to(edge_lp.dtype))
    _, sel = _top_k(score, num_nodes)
    sel = sel.long()
    order = torch.argsort(dep[sel] * n + sel, dim=-1)
    sel = torch.gather(sel, 1, order)
    return sel, torch.gather(score, 1, sel)


def dynamic_medusa_tree_step(spec: DecoderSpec, tpu_cfg: TpuConfig, params,
                             cache, root, prop_toks, prop_logp, base_pos,
                             seq_ids, lat, num_nodes: int, cache_len: int,
                             return_path_features: bool = False,
                             inv_freq=None):
    """One dynamic-tree verify step (reference :799-880): the tree is
    chosen on the device from the proposal scores, verified, and the
    deepest fully matching path accepted. root (B,) the last emitted
    token; prop_toks / prop_logp (B, D, k); ``lat`` = :func:`
    lattice_tensors`."""
    lat_dep, lat_par, lat_br, lat_anc, lat_path = lat
    b = root.shape[0]
    sel, _ = dynamic_tree_select(lat, prop_logp, num_nodes)
    m = sel.shape[1]
    dep_s = lat_dep[sel]                                     # (B, M)
    tok_lat = torch.where(
        lat_dep[None, :] > 0,
        prop_toks[:, (lat_dep - 1).clamp(min=0), lat_br],
        root[:, None].to(prop_toks.dtype))
    node_toks = torch.gather(tok_lat, 1, sel).to(torch.int32)
    anc_pair = lat_anc[sel[:, :, None], sel[:, None, :]]     # (B, M, M)
    mask = tree_attention_mask(anc_pair, base_pos, cache_len)
    rope_pos = base_pos[:, None] + dep_s.to(base_pos.dtype)
    write_pos = _arange_cols(base_pos, m)
    out = tree_forward(spec, tpu_cfg, params, cache, node_toks, rope_pos,
                       write_pos, seq_ids, mask, inv_freq)
    greedy = sampling.greedy_sample(out["logits_all"])
    inv = torch.zeros((b, lat_dep.shape[0]), dtype=torch.long,
                      device=sel.device).scatter_(
        1, sel, torch.arange(m, device=sel.device)[None].expand(b, m))
    par_slot = torch.gather(inv, 1, lat_par[sel])
    pred_at_parent = torch.gather(greedy, 1, par_slot)
    edge_ok = torch.where(dep_s > 0, node_toks == pred_at_parent,
                          torch.ones_like(node_toks, dtype=torch.bool))
    chain = torch.all(~anc_pair | edge_ok[:, None, :], dim=-1)
    cand_depth = torch.where(chain, dep_s, torch.full_like(dep_s, -1))
    best = torch.argmax(cand_depth, dim=-1)
    n_acc = _take(dep_s, best)
    bonus = _take(greedy, best)
    best_lat = _take(sel, best)
    path_lat = lat_path[best_lat].clamp(min=0)               # (B, D+1)
    path_slot = torch.gather(inv, 1, path_lat)
    path_toks = torch.gather(node_toks, 1, path_slot)
    tokens = _emitted(path_toks[:, 1:], n_acc, bonus)
    res = {"tokens": tokens, "num_emitted": (n_acc + 1).to(torch.int32),
           "bonus": bonus, "feature": _take_rows(out["hidden"], best)}
    _refresh_linear(spec, tpu_cfg, params, cache, root, tokens, n_acc,
                    base_pos, seq_ids, inv_freq)
    if return_path_features:
        res["path_features"] = torch.gather(
            out["hidden"], 1, path_slot[:, :, None].expand(
                -1, -1, out["hidden"].shape[-1]))
    return res


class DynamicTreeDecoder(_Decoder):
    """Host loop of DYNAMIC-tree Medusa speculation (reference
    :883-956): each step's tree follows the proposal distribution. The
    proposal is made at the start of each step from the feature the last
    step left on the device."""

    def __init__(self, target_app, branch_k: int = 4, num_nodes: int = 16):
        _refuse_tree_target(target_app.spec)
        self.target = target_app
        if target_app.spec.medusa_heads < 1:
            raise ValueError("medusa heads required")
        self.depth = target_app.spec.medusa_heads
        self.branch_k = branch_k
        self.num_nodes = num_nodes
        lat = build_lattice(branch_k, self.depth)
        if num_nodes > lat[0].shape[0]:
            raise ValueError("num_nodes exceeds the candidate lattice")
        self._lat = lattice_tensors(lat, target_app.device)
        self.runner = _StepRunner(target_app)

    def generate(self, input_ids: np.ndarray, max_new_tokens: int = 128,
                 eos_token_id: Optional[int] = None,
                 attention_mask: Optional[np.ndarray] = None):
        t = self.target
        input_ids, seq_lens = _prompt(input_ids, attention_mask)
        b = input_ids.shape[0]
        seq_ids = np.arange(b, dtype=np.int32)
        t_out = _prefill(t, input_ids, seq_lens)
        first = t_out["tokens"].cpu().numpy().astype(np.int32)
        feat = self.runner.buffer("feature", t_out["last_hidden"].shape,
                                  t_out["last_hidden"].dtype)
        feat.copy_(t_out["last_hidden"])
        state = {"root": first}
        cache_len = t.tpu_config.seq_len

        def fn(x):
            ptoks, plogp = medusa_propose_scored(t.spec, t.params, feat,
                                                 self.branch_k)
            out = dynamic_medusa_tree_step(
                t.spec, t.tpu_config, t.params, t.cache, x["root"], ptoks,
                plogp, x["pos"], x["sid"], self._lat, self.num_nodes,
                cache_len, inv_freq=t._inv_freq)
            return {k: out[k] for k in ("tokens", "num_emitted", "bonus",
                                        "feature")}

        def step_fn(positions):
            out = self.runner.run(("dynamic_tree", b), fn,
                                  {"root": state["root"], "pos": positions,
                                   "sid": seq_ids})
            feat.copy_(out["feature"])
            both = _fetch(out["tokens"], out["num_emitted"], out["bonus"])
            state["root"] = both[:, -1].astype(np.int32)
            return both[:, :-2], both[:, -2]

        gen, mean = _host_loop(input_ids, first, seq_lens, max_new_tokens,
                               eos_token_id, cache_len, self.num_nodes + 1,
                               step_fn)
        return _result(input_ids, gen, mean, key="mean_accept")


def eagle_propose_scored(draft_spec: DecoderSpec, tpu_cfg: TpuConfig,
                         draft_params, draft_cache, last_token, prev_hidden,
                         positions, seq_ids, depth: int, top_k: int,
                         input_norm: bool = False, inv_freq=None):
    """Chain-rollout tree proposals from the EAGLE draft (reference
    :967-992): ``depth`` greedy T = 1 draft steps, each recording the
    top-k ids and log-probabilities of its distribution. Returns
    (prop_toks (B, D, k), prop_logp (B, D, k)); the rollout's draft-KV
    writes are rewritten by the post-acceptance refresh."""
    _, ids, lps = _eagle_chain(draft_spec, tpu_cfg, draft_params,
                               draft_cache, last_token, prev_hidden,
                               positions, seq_ids, depth, input_norm,
                               inv_freq, top_k=top_k)
    return ids, lps


def eagle_tree_step(draft_spec: DecoderSpec, target_spec: DecoderSpec,
                    tpu_cfg: TpuConfig, draft_params, target_params,
                    draft_cache, target_cache, root, prev_hidden, base_pos,
                    seq_ids, lat, num_nodes: int, cache_len: int, depth: int,
                    branch_k: int, input_norm: bool = False,
                    draft_inv_freq=None, target_inv_freq=None):
    """One fused EAGLE token-tree step (reference :995-1033): the draft's
    rollout scores the lattice, the dynamic top-N tree is verified by the
    target in one forward, and both caches are refreshed with the
    accepted linear sequence (the draft's with the verified (token,
    feature) pairs). root (B,) at ``base_pos``; prev_hidden (B, H) the
    target's feature at base_pos - 1."""
    prop_toks, prop_logp = eagle_propose_scored(
        draft_spec, tpu_cfg, draft_params, draft_cache, root, prev_hidden,
        base_pos, seq_ids, depth, branch_k, input_norm, draft_inv_freq)
    res = dynamic_medusa_tree_step(
        target_spec, tpu_cfg, target_params, target_cache, root, prop_toks,
        prop_logp, base_pos, seq_ids, lat, num_nodes, cache_len,
        return_path_features=True, inv_freq=target_inv_freq)
    n_acc = res["num_emitted"] - 1
    refresh = torch.cat([root[:, None].to(torch.int32), res["tokens"]],
                        dim=1)
    hid_seq = torch.cat([prev_hidden[:, None, :].to(
        res["path_features"].dtype), res["path_features"]], dim=1)
    ridx = torch.arange(refresh.shape[1], device=refresh.device)[None, :]
    rpos = _arange_cols(base_pos, refresh.shape[1])
    rpos = torch.where(ridx <= (n_acc + 1)[:, None], rpos,
                       torch.full_like(rpos,
                                       kv_mod.cache_len_of(draft_cache)))
    eagle_forward(draft_spec, tpu_cfg, draft_params, draft_cache, refresh,
                  hid_seq, rpos, seq_ids, input_norm, draft_inv_freq)
    return {k: res[k] for k in ("tokens", "num_emitted", "bonus",
                                "feature")}


class EagleTreeDecoder(_EagleBase):
    """Host loop of EAGLE token-tree speculation (reference :1036-1096):
    the EAGLE draft proposes, the dynamic lattice picks the top-N tree,
    the target verifies it in one forward."""

    def __init__(self, target_app, draft_spec: DecoderSpec, draft_params,
                 draft_cache, depth: int = 4, branch_k: int = 4,
                 num_nodes: int = 16, input_norm: bool = False):
        _refuse_tree_target(target_app.spec)
        _refuse_learned_pos_draft(draft_spec)
        super().__init__(target_app, draft_spec, draft_params, draft_cache,
                         input_norm)
        self.depth = depth
        self.num_nodes = num_nodes
        self.branch_k = branch_k
        lat = build_lattice(branch_k, depth)
        if num_nodes > lat[0].shape[0]:
            raise ValueError("num_nodes exceeds the candidate lattice")
        self._lat = lattice_tensors(lat, target_app.device)

    def generate(self, input_ids: np.ndarray, max_new_tokens: int = 128,
                 eos_token_id: Optional[int] = None,
                 attention_mask: Optional[np.ndarray] = None
                 ) -> Dict[str, Any]:
        input_ids, seq_lens, first, seq_ids, hid = self._start(
            input_ids, attention_mask)
        t = self.target
        cache_len = t.tpu_config.seq_len
        state = {"root": first}

        def fn(x):
            out = eagle_tree_step(
                self.draft_spec, t.spec, t.tpu_config, self.draft_params,
                t.params, self.draft_cache, t.cache, x["root"], hid,
                x["pos"], x["sid"], self._lat, self.num_nodes, cache_len,
                self.depth, self.branch_k, self.input_norm,
                self.draft_inv_freq, t._inv_freq)
            return {k: out[k] for k in ("tokens", "num_emitted", "bonus",
                                        "feature")}

        def step_fn(positions):
            out = self.runner.run(("eagle_tree", len(first)), fn,
                                  {"root": state["root"], "pos": positions,
                                   "sid": seq_ids})
            hid.copy_(out["feature"])
            both = _fetch(out["tokens"], out["num_emitted"], out["bonus"])
            state["root"] = both[:, -1].astype(np.int32)
            return both[:, :-2], both[:, -2]

        budget = max(self.num_nodes, self.depth) + 2
        gen, mean = _host_loop(input_ids, first, seq_lens, max_new_tokens,
                               eos_token_id, cache_len, budget, step_fn)
        return _result(input_ids, gen, mean)
