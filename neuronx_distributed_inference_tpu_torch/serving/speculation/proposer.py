"""Draft proposers for speculative serving (counterpart:
``neuronx_distributed_inference_tpu/serving/speculation/proposer.py`` —
``DraftProposer`` :35, ``SelfDraftProposer`` :77,
``PerturbedSelfDraftProposer`` :94, ``MedusaProposer`` :118 and
``EagleProposer`` :186).

A proposer only guesses the target model's next ``k`` tokens per row; the
verifier checks every guess against the target in one dispatch, so the
delivered tokens are the target's own choices whatever was drafted. Bad
drafts cost acceptance rate, nothing else.

``propose`` returns the drafts as a DEVICE tensor, and they feed the
verify input on the device (``host_stats["blocking_fetches"]`` counts one
fetch per speculative step, the verify's). Proposers that keep
per-sequence state drop it in :meth:`DraftProposer.forget`, which the
adapter calls on release, preemption and rollback.

``MedusaProposer`` and ``EagleProposer`` (``wants_hidden``) feed on the
verify's hidden states: the verify dispatch returns them and
``on_verify`` keeps, per sequence, the feature at the bonus position. Their
device work runs through the verifier's ``_dispatch_propose`` and
``_dispatch_eagle_refresh``, which read no device value.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ...resilience.errors import ConfigurationError

__all__ = ["DraftProposer", "SelfDraftProposer",
           "PerturbedSelfDraftProposer", "MedusaProposer", "EagleProposer"]


class DraftProposer:
    """Base proposer: ``max_drafts`` bounds the candidate width the
    verifier budgets for (width = drafts + 1); ``wants_hidden`` asks the
    verify dispatch for its hidden states (B, W, H)."""

    name = "base"
    wants_hidden = False

    def __init__(self, k: int):
        if k < 1:
            raise ConfigurationError(
                f"speculation needs k >= 1 draft tokens, got {k}")
        self.max_drafts = int(k)

    def bind(self, adapter) -> None:
        """Called once when the adapter adopts this proposer."""

    def propose(self, ctx):
        """Draft up to ``ctx.num_drafts`` tokens per row: a
        (padded_batch, ctx.num_drafts) int32 device tensor, or None to sit
        the step out (it degenerates to a width-1 verify)."""
        raise NotImplementedError

    def on_verify(self, ctx, tokens, n_emit, hidden) -> None:
        """Post-verify feedback: ``tokens`` / ``n_emit`` are the fetched
        accept results of the live rows (numpy); ``hidden`` is the verify's
        (padded batch, W, H) device tensor (None unless
        ``wants_hidden``)."""

    def forget(self, seq_ids: Sequence[int]) -> None:
        """Drop per-sequence state (release / preemption / rollback)."""


class SelfDraftProposer(DraftProposer):
    """Greedy-k self-drafting, the baseline: the target model drafts its
    own continuation through the masked draft loop
    (``model_base.paged_spec_draft_loop``, k T = 1 paged steps in one
    captured graph on the card), so no extra weights. Under greedy (or
    the coupled sampled draw) a draft matches the verify's choice unless
    the two passes round differently (fp32 accepts every draft)."""

    name = "self_draft"

    def propose(self, ctx):
        if ctx.num_drafts < 1:
            return None
        return ctx.path._dispatch_spec_draft(ctx)


class PerturbedSelfDraftProposer(SelfDraftProposer):
    """Self-draft with draft column ``corrupt_at`` corrupted (+1 mod vocab,
    on the device): that draft can never equal the target's choice, so
    acceptance stops there — ``corrupt_at`` drafts accepted per full-width
    step. The fixed partial-accept fixture of the accept bookkeeping, the
    KV shrink and the rejection path."""

    name = "perturbed_self_draft"

    def __init__(self, k: int, corrupt_at: int = 1):
        super().__init__(k)
        if not 0 <= corrupt_at < k:
            raise ConfigurationError(
                f"corrupt_at must be in [0, {k}), got {corrupt_at}")
        self.corrupt_at = corrupt_at
        self._vocab: Optional[int] = None

    def bind(self, adapter) -> None:
        self._vocab = adapter.app.spec.vocab_size

    def propose(self, ctx):
        drafts = super().propose(ctx)
        if drafts is None or ctx.num_drafts <= self.corrupt_at:
            return drafts
        drafts = drafts.clone()
        col = drafts[:, self.corrupt_at]
        drafts[:, self.corrupt_at] = (col + 1) % self._vocab
        return drafts


def _gather_features(hidden, n_live: int, n_emit) -> torch.Tensor:
    """The feature at each live row's bonus column: (n_live, H) from the
    (padded batch, W, H) verify hidden states (no host read: ``n_emit`` is
    the fetched numpy count)."""
    idx = torch.as_tensor(np.asarray(n_emit, np.int64) - 1,
                          device=hidden.device)
    h = hidden[:n_live]
    return torch.gather(h, 1, idx[:, None, None].expand(
        -1, 1, h.shape[-1]))[:, 0]


class MedusaProposer(DraftProposer):
    """The Medusa heads of ``models/speculation.py`` as a serving proposer
    (chain mode, :func:`~...models.speculation.medusa_propose`): head j
    predicts the token j + 2 positions past the feature's, so the chain
    [head_0 .. head_{k-1}] drafted from the feature of position p - 1 lines
    up with candidate columns 1..k at positions p + 1 .. p + k.

    Per-row features come from the verify itself (``wants_hidden``): after
    each step the feature at the bonus position is stored per seq_id. A
    row with no feature yet (fresh admission: the chunked paged prefill
    exposes no hidden states) drafts from a zero feature, and while no
    live row has one the proposer sits the step out (a width-1 verify, on
    the ragged path an all-decode pass through the paged kernel); the
    verify's bonus both advances the row and seeds its feature."""

    name = "medusa"
    wants_hidden = True

    def __init__(self, k: int):
        super().__init__(k)
        self._feat: Dict[int, torch.Tensor] = {}
        self._app = None

    def bind(self, adapter) -> None:
        spec = adapter.app.spec
        if spec.medusa_heads < self.max_drafts:
            raise ConfigurationError(
                f"MedusaProposer(k={self.max_drafts}) needs >= k medusa "
                f"heads; the target spec has {spec.medusa_heads}")
        self._app = adapter.app

    def propose(self, ctx):
        if ctx.num_drafts < 1 or not any(s in self._feat for s in ctx.live):
            return None
        return ctx.path._dispatch_propose(self, ctx)

    def _propose_device(self, ctx):
        """Device work of one Medusa chain proposal (through the
        verifier's ``_dispatch_propose``)."""
        from ...models.speculation import medusa_propose
        app = self._app
        zero = torch.zeros((app.spec.hidden_size,), dtype=app.spec.dtype,
                           device=app.device)
        feats = [self._feat.get(s, zero) for s in ctx.live]
        feats += [feats[0]] * (ctx.padded_batch - len(feats))
        props = medusa_propose(app.spec, app.params, torch.stack(feats), 1)
        return props[:, :ctx.num_drafts, 0]

    def on_verify(self, ctx, tokens, n_emit, hidden) -> None:
        feat = _gather_features(hidden, len(ctx.live), n_emit)
        for i, s in enumerate(ctx.live):
            self._feat[s] = feat[i]

    def forget(self, seq_ids: Sequence[int]) -> None:
        for s in seq_ids:
            self._feat.pop(s, None)


class EagleProposer(DraftProposer):
    """The EAGLE draft of ``models/speculation.py`` as a serving proposer:
    a greedy chain rollout of a small fused draft model whose contiguous
    KV cache rows are keyed by a STABLE per-sequence slot (the draft
    steps take ``seq_ids``-addressed rows, so they stay on the gather
    path), and after every verify the draft cache is refreshed with the
    verified (token, target feature) pairs, as the fused path's refresh.

    The paged prefill exposes no prompt hidden states, so the draft cache
    is primed INCREMENTALLY from the verified feature stream instead of
    from a prefill pass: a fresh row's first drafts are uninformed (a low
    accept rate, never a wrong token). Rows leave the slot map on
    ``forget``."""

    name = "eagle"
    wants_hidden = True

    def __init__(self, draft_spec, draft_params, k: int,
                 input_norm: bool = False):
        super().__init__(k)
        self.draft_spec = draft_spec
        self.draft_params = draft_params
        self.input_norm = input_norm
        self._slots: Dict[int, int] = {}
        self._free: List[int] = []
        self._feat: Dict[int, torch.Tensor] = {}
        self.draft_cache = None

    def bind(self, adapter) -> None:
        from ...models import model_base
        from ...modules import kv_cache
        app = adapter.app
        cfg = app.tpu_config
        self._device = app.device
        self._seq_len = cfg.seq_len
        self._free = list(range(adapter.batch))
        ds = self.draft_spec
        self.draft_cache = kv_cache.init_cache(kv_cache.KVCacheSpec(
            num_layers=ds.num_layers, batch_size=adapter.batch,
            max_seq_len=cfg.seq_len, num_kv_heads=ds.gqa.num_kv_heads,
            head_dim=ds.head_dim, dtype=ds.kv_dtype), app.device)
        # seq_ids-addressed draft rows: the target's config is not
        # continuous batching (paged), so the flag is set on a copy
        self._draft_cfg = dataclasses.replace(cfg,
                                              is_continuous_batching=True)
        self._inv_freq = model_base.rope_inv_freq(ds, app.device)

    def _slot_of(self, sid: int) -> int:
        if sid not in self._slots:
            self._slots[sid] = self._free.pop()
        return self._slots[sid]

    def propose(self, ctx):
        if ctx.num_drafts < 1:
            return None
        return ctx.path._dispatch_propose(self, ctx)

    def _row_arrays(self, ctx):
        zero = torch.zeros((self.draft_spec.hidden_size,),
                           dtype=self.draft_spec.dtype, device=self._device)
        feats = [self._feat.get(s, zero) for s in ctx.live]
        sids = [self._slot_of(s) for s in ctx.live]
        pad = ctx.padded_batch - len(feats)
        feats += [feats[0]] * pad
        sids += [sids[0]] * pad
        return (torch.stack(feats),
                torch.as_tensor(np.asarray(sids, np.int32),
                                device=self._device))

    def _t(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.int32), device=self._device)

    def _propose_device(self, ctx):
        """The chain rollout: ``num_drafts`` T = 1 draft steps; a row
        past its own width - 1 drafts writes at ``seq_len`` (dropped) and
        keeps its token, feature and position."""
        from ...models.speculation import eagle_forward
        feats, sids = self._row_arrays(ctx)
        tok = self._t(ctx.first)
        hid, pos = feats, self._t(ctx.positions)
        widths = self._t(ctx.widths)
        toks = []
        for j in range(ctx.num_drafts):
            valid = j < widths - 1
            wpos = torch.where(valid, pos, torch.full_like(pos,
                                                           self._seq_len))
            out = eagle_forward(self.draft_spec, self._draft_cfg,
                                self.draft_params, self.draft_cache,
                                tok[:, None], hid[:, None, :],
                                wpos[:, None], sids, self.input_norm,
                                self._inv_freq)
            nxt = torch.argmax(out["logits"][:, -1, :], dim=-1).to(
                torch.int32)
            tok = torch.where(valid, nxt, tok)
            hid = torch.where(valid[:, None], out["hidden"][:, -1, :], hid)
            pos = torch.where(valid, pos + 1, pos)
            toks.append(tok)
        return torch.stack(toks, dim=1)

    def on_verify(self, ctx, tokens, n_emit, hidden) -> None:
        ctx.path._dispatch_eagle_refresh(self, ctx, hidden)
        feat = _gather_features(hidden, len(ctx.live), n_emit)
        for i, s in enumerate(ctx.live):
            self._feat[s] = feat[i]

    def _refresh_device(self, ctx, hidden) -> None:
        """The draft-cache refresh with the VERIFIED pairs: slot p + j gets
        (candidate token at p + j, target feature at p + j - 1); columns
        past each row's width are pushed to ``seq_len`` (dropped)."""
        from ...models.speculation import eagle_forward
        feats, sids = self._row_arrays(ctx)
        cand = ctx.cand                                # (Bp, W) device
        w = cand.shape[1]
        first = feats[:, None, :].to(hidden.dtype)
        hid_seq = (torch.cat([first, hidden[:, :w - 1, :]], dim=1)
                   if w > 1 else first)
        idx = torch.arange(w, device=self._device)[None, :]
        pos = self._t(ctx.positions)[:, None] + idx
        pos = torch.where(idx < self._t(ctx.widths)[:, None], pos,
                          torch.full_like(pos, self._seq_len))
        eagle_forward(self.draft_spec, self._draft_cfg, self.draft_params,
                      self.draft_cache, cand, hid_seq, pos, sids,
                      self.input_norm, self._inv_freq)

    def forget(self, seq_ids: Sequence[int]) -> None:
        for s in seq_ids:
            self._feat.pop(s, None)
            slot = self._slots.pop(s, None)
            if slot is not None:
                self._free.append(slot)
