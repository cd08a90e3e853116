"""Ragged unified dispatch of the port (counterpart:
``neuronx_distributed_inference_tpu/serving/ragged/``): ONE mixed
prefill+decode dispatch per engine step.

A :class:`~.planner.RaggedBatchPlanner` assembles the runnable work —
pending prefill chunks and live decode rows — into one row plan (per-row
offsets, widths, block tables and kind tags), and a
:class:`~.path.RaggedDispatchPath` runs it as ONE
``model_base.paged_ragged_step`` dispatch padded within the
``autobucketing.ragged_row_buckets`` ladder. Enable it with
``PagedEngineAdapter(app, ragged=True)``; ``ServingEngine.run_pass``
routes through the planner.
"""

from .planner import (KIND_DECODE, KIND_PREFILL, KIND_VERIFY,
                      RaggedBatchPlanner, RaggedPlan, RaggedRow)
from .path import RaggedDispatchPath

__all__ = ["RaggedBatchPlanner", "RaggedDispatchPath", "RaggedPlan",
           "RaggedRow", "KIND_DECODE", "KIND_PREFILL", "KIND_VERIFY"]
