"""The fleet layer's KV side (counterpart:
``neuronx_distributed_inference_tpu/serving/fleet/``): the host-RAM KV
spill tier under an engine's device block pool (:class:`HostKVSpillTier`,
``kv_tier.py``) and the disaggregated prefill → decode handoff
(``handoff.py``). The router, live migration, the autoscaler, the load
generators and the metrics aggregator are later slices."""

from .handoff import (HANDOFF_SCHEMA, admit_handoff, capture_handoff,
                      handoff_from_json, handoff_to_json)
from .kv_tier import HostKVSpillTier

__all__ = ["HostKVSpillTier", "HANDOFF_SCHEMA", "capture_handoff",
           "admit_handoff", "handoff_to_json", "handoff_from_json"]
