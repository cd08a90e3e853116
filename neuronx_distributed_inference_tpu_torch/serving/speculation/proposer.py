"""Draft proposers for speculative serving (counterpart:
``neuronx_distributed_inference_tpu/serving/speculation/proposer.py`` —
``DraftProposer`` :35, ``SelfDraftProposer`` :77, and
``PerturbedSelfDraftProposer`` :94).

A proposer only guesses the target model's next ``k`` tokens per row; the
verifier checks every guess against the target in one dispatch, so the
delivered tokens are the target's own choices whatever was drafted. Bad
drafts cost acceptance rate, nothing else.

``propose`` returns the drafts as a DEVICE tensor, and they feed the
verify input on the device (``host_stats["blocking_fetches"]`` counts one
fetch per speculative step, the verify's). Proposers that keep
per-sequence state drop it in :meth:`DraftProposer.forget`, which the
adapter calls on release, preemption and rollback. ``MedusaProposer`` and
``EagleProposer`` wait for ``models/speculation.py``.
"""

from __future__ import annotations

from typing import Optional, Sequence

from ...resilience.errors import ConfigurationError

__all__ = ["DraftProposer", "SelfDraftProposer",
           "PerturbedSelfDraftProposer"]


class DraftProposer:
    """Base proposer: ``max_drafts`` bounds the candidate width the
    verifier budgets for (width = drafts + 1)."""

    name = "base"

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
        accept results of the live rows (numpy); ``hidden`` (the
        reference's verify features for Medusa / EAGLE) is None."""

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
