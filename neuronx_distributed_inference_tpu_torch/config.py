"""Configuration of the port (counterpart:
``neuronx_distributed_inference_tpu/config.py`` — ``OnDeviceSamplingConfig``
:61, ``TpuConfig`` :229, ``InferenceConfig`` :529,
``load_pretrained_config`` :634).

Field names and JSON keys are the JAX package's, so one saved config file
drives both packages; dtype names resolve to torch dtypes instead of jnp
ones. The port runs the dense paged Llama path only: knobs of features it
does not run yet are kept (so configs round-trip) and refused where the
model spec is built (``models/model_base.spec_from_config``).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch

logger = logging.getLogger("nxdi_torch")

_DTYPE_MAP = {
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
    "float32": torch.float32,
    "fp32": torch.float32,
    "float16": torch.float16,
    "fp16": torch.float16,
    "int8": torch.int8,
    "float8_e4m3fn": torch.float8_e4m3fn,
    "float8_e5m2": torch.float8_e5m2,
}


def to_torch_dtype(dtype: Any) -> torch.dtype:
    """Resolve a dtype name (the JAX package's vocabulary) or a torch dtype."""
    if isinstance(dtype, str):
        if dtype not in _DTYPE_MAP:
            raise ValueError(f"unknown dtype {dtype!r}; expected one of "
                             f"{sorted(_DTYPE_MAP)}")
        return _DTYPE_MAP[dtype]
    return dtype


@dataclass
class OnDeviceSamplingConfig:
    """On-device sampling knobs (counterpart: config.py:61)."""

    do_sample: bool = False
    top_k: int = 1
    top_p: float = 1.0
    temperature: float = 1.0
    dynamic: bool = True
    deterministic: bool = False
    global_topk: int = 256
    on_device: bool = True
    # positionally coupled streams (ops/sampling.coupled_sample): every
    # draw keyed by (stream_seed, request seed, position); an int32 value
    stream_seed: Optional[int] = None

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclass
class ChunkedPrefillConfig:
    max_num_seqs: int = 8
    kernel_q_tile_size: int = 128
    kernel_kv_tile_size: int = 1024

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclass
class MoEConfig:
    capacity_factor: Optional[float] = None
    glu_mlp: bool = True
    glu_type: str = "glu"
    normalize_top_k_affinities: bool = True
    early_expert_affinity_modulation: bool = False
    fused_shared_experts: bool = False
    routed_scaling_factor: Optional[float] = None
    moe_tp_degree: Optional[int] = None
    moe_ep_degree: Optional[int] = None
    moe_cte_tp_degree: Optional[int] = None
    moe_cte_ep_degree: Optional[int] = None
    moe_tkg_tp_degree: Optional[int] = None
    moe_tkg_ep_degree: Optional[int] = None

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclass
class LoraServingConfig:
    max_loras: int = 1
    max_lora_rank: int = 16
    target_modules: Optional[List[str]] = None
    lora_ckpt_paths: Optional[Dict[str, str]] = None
    lora_dtype: str = "bfloat16"

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclass
class SpeculationConfig:
    speculation_length: int = 0
    spec_batch_size: Optional[int] = None
    enable_fused_speculation: bool = False
    enable_eagle_speculation: bool = False
    enable_eagle_draft_input_norm: bool = False
    is_eagle_draft: bool = False
    medusa_speculation_length: int = 0
    num_medusa_heads: int = 0
    token_tree_config: Optional[Dict[str, Any]] = None
    draft_model_path: Optional[str] = None
    draft_model_module: Optional[str] = None

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclass
class TensorCaptureConfig:
    capture_targets: List[str] = field(
        default_factory=lambda: ["layer_output"])

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclass
class TensorReplacementConfig:
    targets: List[str] = field(default_factory=list)
    source_path: Optional[str] = None
    layers: Optional[List[int]] = None

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclass
class CollectiveConfig:
    dtype: Optional[str] = None
    block: int = 32

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


_SUBCONFIG_TYPES = {
    "on_device_sampling_config": OnDeviceSamplingConfig,
    "chunked_prefill_config": ChunkedPrefillConfig,
    "moe_config": MoEConfig,
    "lora_config": LoraServingConfig,
    "speculation_config": SpeculationConfig,
    "tensor_capture_config": TensorCaptureConfig,
    "tensor_replacement_config": TensorReplacementConfig,
    "collective_config": CollectiveConfig,
}


@dataclass
class TpuConfig:
    """Runtime knobs (counterpart: config.py:229). The name is kept so a
    config saved by either package loads in the other; nothing here is
    specific to a TPU."""

    batch_size: int = 1
    ctx_batch_size: Optional[int] = None
    tkg_batch_size: Optional[int] = None
    max_batch_size: Optional[int] = None
    is_continuous_batching: bool = False
    seq_len: int = 128
    max_context_length: Optional[int] = None
    windowed_context_encoding: Optional[int] = None
    n_active_tokens: int = 1
    n_positions: Optional[int] = None

    dtype: str = "bfloat16"
    kv_cache_dtype: Optional[str] = None
    logits_dtype: str = "float32"
    rope_dtype: str = "float32"

    tp_degree: int = 1
    cp_degree: int = 1
    attention_dp_degree: int = 1
    pp_degree: int = 1
    ep_degree: int = 1
    mlp_cp_degree: int = 1
    sequence_parallel_enabled: bool = False
    vocab_parallel: bool = True
    world_size: Optional[int] = None
    start_rank_id: int = 0
    local_ranks_size: Optional[int] = None

    kv_cache_batch_size: Optional[int] = None
    kv_cache_padding_size: int = 0
    is_block_kv_layout: bool = False
    rolling_kv_cache: Optional[bool] = None
    pa_num_blocks: Optional[int] = None
    pa_block_size: int = 32
    is_prefix_caching: bool = False
    is_chunked_prefill: bool = False
    flash_decoding_enabled: bool = False

    enable_bucketing: bool = True
    buckets: Optional[List[int]] = None
    context_encoding_buckets: Optional[List[int]] = None
    token_generation_buckets: Optional[List[int]] = None
    bucket_n_active_tokens: bool = False
    enable_2d_bucketing: bool = False
    tkg_batch_buckets: Optional[List[int]] = None

    on_device_sampling_config: Optional[OnDeviceSamplingConfig] = None
    output_logits: bool = False
    output_full_hidden: bool = False

    speculation_config: Optional[SpeculationConfig] = None
    moe_config: Optional[MoEConfig] = None
    lora_config: Optional[LoraServingConfig] = None
    chunked_prefill_config: Optional[ChunkedPrefillConfig] = None
    tensor_capture_config: Optional[TensorCaptureConfig] = None
    tensor_replacement_config: Optional[TensorReplacementConfig] = None

    quantized: bool = False
    quantization_dtype: str = "int8"
    quantization_type: str = "per_channel_symmetric"
    quantized_checkpoints_path: Optional[str] = None
    modules_to_not_convert: Optional[List[str]] = None
    kv_cache_quant: bool = False
    kv_cache_scale: float = 1.0

    collective_config: Optional[CollectiveConfig] = None
    mlp_low_rank: Optional[int] = None

    attn_kernel_enabled: Optional[bool] = None
    qkv_kernel_enabled: bool = False
    mlp_kernel_enabled: bool = False
    attn_block_tkg_nki_kernel_enabled: bool = False
    # hand-written decode-attention kernels (ops/decode_attention.py);
    # None = the default admission, True = on where supports() holds,
    # False = never (gather path)
    attn_block_tkg_kernel_enabled: Optional[bool] = None

    async_mode: bool = False
    decode_chunk_tokens: int = 1

    rpl_reduce_dtype: Optional[str] = None
    cast_type: str = "config"
    save_sharded_checkpoint: bool = False
    skip_sharding: bool = False
    compile_cache_dir: Optional[str] = None
    seed: int = 0

    def __post_init__(self):
        if self.max_context_length is None:
            self.max_context_length = self.seq_len
        if self.max_batch_size is None:
            self.max_batch_size = self.batch_size
        if self.ctx_batch_size is None:
            self.ctx_batch_size = (1 if self.is_continuous_batching
                                   else self.batch_size)
        if self.tkg_batch_size is None:
            self.tkg_batch_size = self.batch_size
        if self.kv_cache_batch_size is None:
            self.kv_cache_batch_size = max(self.tkg_batch_size,
                                           self.max_batch_size)
        if self.kv_cache_dtype is None:
            self.kv_cache_dtype = self.dtype
        if self.n_positions is None:
            self.n_positions = self.seq_len
        if self.world_size is None:
            self.world_size = self.tp_degree * self.pp_degree
        if self.local_ranks_size is None:
            self.local_ranks_size = self.world_size
        self.validate()

    def validate(self):
        if self.seq_len < 1:
            raise ValueError("seq_len must be >= 1")
        if self.max_context_length > self.seq_len:
            raise ValueError(
                f"max_context_length ({self.max_context_length}) cannot "
                f"exceed seq_len ({self.seq_len})")
        # the parallel degrees as the counterpart checks them
        # (config.py:410-431)
        if self.cp_degree > 1 and self.tp_degree % self.cp_degree != 0:
            raise ValueError("cp_degree must divide tp_degree (cp shards "
                             "the tp axis during prefill)")
        if self.attention_dp_degree > 1:
            if self.tp_degree % self.attention_dp_degree != 0:
                raise ValueError("attention_dp_degree must divide tp_degree")
            if self.tkg_batch_size % self.attention_dp_degree != 0:
                raise ValueError("tkg_batch_size must be divisible by "
                                 "attention_dp_degree")
        if self.pp_degree > 1:
            raise ValueError("pp_degree > 1 is not supported")
        if self.mlp_cp_degree > 1 and (
                not self.sequence_parallel_enabled
                or self.mlp_cp_degree != max(self.cp_degree, 1)):
            raise ValueError(
                "mlp_cp_degree requires sequence_parallel_enabled and "
                "mlp_cp_degree == cp_degree: MLP context parallelism is "
                "realized as sequence-sharded MLP activations over the cp "
                "axis")
        if self.is_chunked_prefill and not self.is_block_kv_layout:
            raise ValueError("chunked prefill requires block KV layout")
        if self.is_prefix_caching and not self.is_block_kv_layout:
            raise ValueError("prefix caching requires block KV layout")
        if self.is_block_kv_layout and self.pa_num_blocks is None:
            self.pa_num_blocks = (
                self.kv_cache_batch_size
                * ((self.seq_len + self.pa_block_size - 1)
                   // self.pa_block_size))
        if self.mlp_low_rank is not None and self.mlp_low_rank < 1:
            from .resilience.errors import ConfigurationError
            raise ConfigurationError(
                f"mlp_low_rank must be >= 1, got {self.mlp_low_rank} "
                "(None disables the low-rank MLP)")
        sc = self.on_device_sampling_config
        if sc is not None and sc.stream_seed is not None \
                and not sc.do_sample:
            from .resilience.errors import ConfigurationError
            raise ConfigurationError(
                "on_device_sampling_config.stream_seed requires "
                "do_sample=True")

    @property
    def torch_dtype(self) -> torch.dtype:
        return to_torch_dtype(self.dtype)

    @property
    def torch_kv_dtype(self) -> torch.dtype:
        return to_torch_dtype(self.kv_cache_dtype)

    @property
    def speculation_length(self) -> int:
        return (self.speculation_config.speculation_length
                if self.speculation_config else 0)

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if dataclasses.is_dataclass(v):
                v = v.to_dict()
            out[f.name] = v
        return out

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TpuConfig":
        d = dict(d)
        known = {f.name for f in dataclasses.fields(cls)}
        for key, sub_cls in _SUBCONFIG_TYPES.items():
            if isinstance(d.get(key), dict):
                d[key] = sub_cls(**d[key])
        for k in [k for k in d if k not in known]:
            logger.warning("TpuConfig: ignoring unknown key %r", k)
            d.pop(k)
        return cls(**d)


NeuronConfig = TpuConfig


@dataclass
class MoETpuConfig(TpuConfig):
    """A TpuConfig that always carries an MoEConfig (counterpart:
    config.py:519; the reference's ``MoENeuronConfig``)."""

    def __post_init__(self):
        if self.moe_config is None:
            self.moe_config = MoEConfig()
        super().__post_init__()


class InferenceConfig:
    """A HF-style model config paired with a :class:`TpuConfig`
    (counterpart: config.py:529). HF attributes live directly on the
    object; JSON round-trip via :meth:`save` / :meth:`load`."""

    _NON_HF_KEYS = ("tpu_config",)

    def __init__(self, tpu_config: TpuConfig, load_config=None,
                 metadata=None, **kwargs):
        self.tpu_config = tpu_config
        self.metadata = metadata or {}
        if load_config is not None:
            if callable(load_config):
                load_config(self)
            else:
                for k, v in dict(load_config).items():
                    setattr(self, k, v)
        for k, v in kwargs.items():
            setattr(self, k, v)
        self.add_derived_config()
        self.validate_config()

    @property
    def neuron_config(self) -> TpuConfig:
        return self.tpu_config

    def add_derived_config(self):
        """Model families override to compute derived attributes."""

    def get_required_attributes(self) -> List[str]:
        return []

    def validate_config(self):
        missing = [a for a in self.get_required_attributes()
                   if not hasattr(self, a)]
        if missing:
            raise ValueError(
                f"InferenceConfig missing required attributes: {missing}")

    def get_text_config(self) -> "InferenceConfig":
        return self

    def to_dict(self) -> Dict[str, Any]:
        hf = {k: v for k, v in self.__dict__.items()
              if k not in self._NON_HF_KEYS and not k.startswith("_")
              and _json_safe(v)}
        return {"tpu_config": self.tpu_config.to_dict(), "hf_config": hf,
                "config_cls":
                    f"{type(self).__module__}:{type(self).__qualname__}"}

    def to_json_string(self) -> str:
        return json.dumps(self.to_dict(), indent=2, default=str,
                          sort_keys=True)

    def save(self, path: str):
        if os.path.isdir(path) or path.endswith(os.sep):
            os.makedirs(path, exist_ok=True)
            path = os.path.join(path, "tpu_inference_config.json")
        else:
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)
        with open(path, "w") as f:
            f.write(self.to_json_string())

    @classmethod
    def from_json_string(cls, s: str) -> "InferenceConfig":
        """The saved ``config_cls`` may name a class of either package;
        only its bare name is resolved, against the port's Llama config
        or ``cls``."""
        d = json.loads(s)
        config_cls = cls
        qual = d.get("config_cls", "").split(":")[-1]
        if qual == "LlamaInferenceConfig":
            from .models.llama.modeling_llama import LlamaInferenceConfig
            config_cls = LlamaInferenceConfig
        obj = config_cls.__new__(config_cls)
        obj.tpu_config = TpuConfig.from_dict(d["tpu_config"])
        obj.metadata = {}
        for k, v in d.get("hf_config", {}).items():
            setattr(obj, k, v)
        obj.add_derived_config()
        return obj

    @classmethod
    def load(cls, path: str) -> "InferenceConfig":
        if os.path.isdir(path):
            path = os.path.join(path, "tpu_inference_config.json")
        with open(path) as f:
            return cls.from_json_string(f.read())


def _json_safe(v) -> bool:
    try:
        json.dumps(v)
        return True
    except (TypeError, ValueError):
        return False


def load_pretrained_config(model_path: str):
    """A load_config callable reading a HF checkpoint dir's config.json
    (counterpart: config.py:634)."""

    def _load(cfg: InferenceConfig):
        with open(os.path.join(model_path, "config.json")) as f:
            hf = json.load(f)
        for k, v in hf.items():
            setattr(cfg, k, v)
        cfg.model_path = model_path

    return _load
