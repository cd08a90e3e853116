"""The speculative paths' sampling-mode check (counterpart:
``neuronx_distributed_inference_tpu/serving/speculation/verifier.py`` —
``validate_spec_sampling`` :61-80)."""

from __future__ import annotations

from ...resilience.errors import ConfigurationError

__all__ = ["validate_spec_sampling"]


def validate_spec_sampling(sampling_config, where: str) -> str:
    """Resolve a speculative path's verify mode from the adapter's
    on-device sampling config: ``"greedy"`` (no config, or
    ``do_sample=False``) or ``"sampled"`` (seeded coupled sampling —
    ``do_sample=True`` with ``stream_seed`` set; the port's spec refuses
    such configs until the coupled draw is ported). UNSEEDED sampling is
    refused: without a stream seed every dispatch draws fresh noise, so
    verify could never reproduce the target draw a draft must match and
    the emitted stream would depend on batch composition."""
    if sampling_config is None or not sampling_config.do_sample:
        return "greedy"
    if sampling_config.stream_seed is None:
        raise ConfigurationError(
            f"{where} supports sampled speculation only for SEEDED "
            "streams: set on_device_sampling_config.stream_seed (coupled "
            "rejection sampling replays the per-position gumbel draw the "
            "draft must match). Supported: greedy (do_sample=False, no "
            "seed needed) and seeded sampling; unseeded do_sample is "
            "not.")
    return "sampled"
