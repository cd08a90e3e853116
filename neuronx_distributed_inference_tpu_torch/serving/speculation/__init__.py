"""Speculative continuous batching on the paged engine (counterpart:
``neuronx_distributed_inference_tpu/serving/speculation/``).

* :mod:`.proposer` — the draft side: :class:`SelfDraftProposer` (the
  target model drafts its own continuation through the masked draft loop)
  and :class:`PerturbedSelfDraftProposer` (a corrupted draft column: a
  fixed partial accept rate); :class:`MedusaProposer` (the Medusa heads
  on the verify's features) and :class:`EagleProposer` (the EAGLE draft
  over its own slot-keyed contiguous cache, refreshed with the verified
  pairs), both from ``models/speculation.py``.
* :mod:`.verifier` — :class:`SpeculativeDecodePath`, the engine step:
  per-row widths on the ``autobucketing.spec_width_buckets`` ladder, one
  draft pass, ONE verify dispatch with acceptance on the device, KV grown
  for the window and shrunk to the accepted prefix.

Attach by constructing the adapter with ``speculation=``::

    eng = PagedEngineAdapter(app, speculation=SelfDraftProposer(k=3))
    eng.add_requests([0], [prompt])
    eng.step()        # -> {0: [t1, t2, t3, t4]} (accepted + bonus)

The delivered tokens are the target's own choices (greedy argmax, or the
seeded coupled draw), whatever the proposer drafts, so the streams equal
non-speculative decode; a bad proposer costs acceptance rate only.
"""

from .proposer import (DraftProposer, EagleProposer, MedusaProposer,
                       PerturbedSelfDraftProposer, SelfDraftProposer)
from .verifier import SpeculativeDecodePath, validate_spec_sampling

__all__ = [
    "DraftProposer", "SelfDraftProposer", "PerturbedSelfDraftProposer",
    "MedusaProposer", "EagleProposer",
    "SpeculativeDecodePath", "validate_spec_sampling",
]
