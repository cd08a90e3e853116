"""The PyTorch port stands alone: it imports neither jax nor the JAX
package, and its entry points never fall back to the CPU on their own."""

import os
import pkgutil
import re
import subprocess
import sys

import pytest

import neuronx_distributed_inference_tpu_torch as port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.dirname(port.__file__)
FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|neuronx_distributed_inference_tpu)\b")


SERVING_MODULES = [port.__name__ + "." + m for m in (
    "serving.adapter", "serving.ragged", "serving.ragged.planner",
    "serving.ragged.path", "serving.engine", "serving.engine.scheduler",
    "serving.engine.queue", "serving.engine.streams",
    "serving.speculation", "serving.speculation.verifier",
    "serving.speculation.proposer", "ops.sampling", "telemetry",
    "telemetry.registry",
    "telemetry.metrics", "telemetry.spans", "telemetry.trace",
    "telemetry.request_trace", "resilience.faults", "serving.warmup",
    "telemetry.slo", "resilience.controller", "serving.engine.frontend",
    "models.cuda_graphs", "modules.moe", "models.model_base",
    "models.family", "models.qwen3", "models.qwen3.modeling_qwen3",
    "models.qwen3_moe", "models.qwen3_moe.modeling_qwen3_moe",
    "models.mixtral", "models.mixtral.modeling_mixtral", "models.gpt_oss",
    "models.gpt_oss.modeling_gpt_oss", "modules.quantization", "ops.rope",
    "modules.low_rank", "utils.checkpoint", "models.application",
    "models.qwen2", "models.qwen2.modeling_qwen2", "models.granite",
    "models.granite.modeling_granite", "models.phi3",
    "models.phi3.modeling_phi3", "models.olmo2",
    "models.olmo2.modeling_olmo2", "models.gemma2",
    "models.gemma2.modeling_gemma2", "models.gemma3",
    "models.gemma3.modeling_gemma3", "models.llama4",
    "models.llama4.modeling_llama4", "models.dbrx",
    "models.dbrx.modeling_dbrx", "ops.normalization", "ops.attention",
    "models.contrib", "models.contrib2", "models.contrib3",
    "models.speculation", "modules.token_tree", "utils.hf_adapter",
    "parallel.mesh", "parallel.collectives", "parallel.layers",
    "parallel.dispatch", "config", "telemetry.observatory",
    "models.deepseek", "models.deepseek.modeling_deepseek")]


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [PORT_DIR], prefix=port.__name__ + "."))


def test_import_pulls_in_no_jax():
    """A fresh interpreter imports every module of the port; afterwards
    neither jax nor the JAX package is in sys.modules."""
    mods = _port_modules()
    assert set(SERVING_MODULES) <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith('jax.') or m == 'jaxlib'\n"
        "             or m == 'neuronx_distributed_inference_tpu'\n"
        "             or m.startswith('neuronx_distributed_inference_tpu.'))\n"
        "print(len(bad), bad[:5])\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("module", SERVING_MODULES)
def test_serving_module_imports_only_port_code(module):
    """Each module of the serving path imports, and every module it pulls
    in is the port's own, the standard library's or a dependency's —
    never the JAX package's (jax itself may already be loaded by this
    test process)."""
    import importlib
    mod = importlib.import_module(module)
    assert mod.__name__ == module
    src = open(mod.__file__).read()
    assert "neuronx_distributed_inference_tpu." not in "".join(
        line for line in src.splitlines(True)
        if line.lstrip().startswith(("import ", "from ")))


@pytest.mark.parametrize("root", ["package", "chip_smoke"])
def test_source_has_no_jax_import(root):
    files = ([os.path.join(REPO, "chip_smoke.py")] if root == "chip_smoke"
             else [os.path.join(d, f) for d, _, fs in os.walk(PORT_DIR)
                   for f in fs if f.endswith(".py")])
    assert files
    hits = []
    for path in files:
        with open(path) as f:
            for i, line in enumerate(f, 1):
                if FORBIDDEN.match(line):
                    hits.append(f"{path}:{i}: {line.strip()}")
    assert not hits, hits


def test_spawned_rank_modules_import_no_jax():
    """What a spawned rank imports — the port's mesh (whose ``_rank_main``
    each rank runs) and the tests' rank functions
    (``tests/torch_tp_ranks.py``) — pulls in neither jax nor the JAX
    package, so the reference runs in the test's own process only."""
    code = (
        "import sys\n"
        "import neuronx_distributed_inference_tpu_torch.parallel.mesh\n"
        "import torch_tp_ranks\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith('jax.') or m == 'jaxlib'\n"
        "             or m.startswith('neuronx_distributed_inference_tpu.'))\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO, os.path.join(REPO, "tests")]))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_default_device_raises_without_cuda():
    """No card here: the default device is an error, never a silent CPU
    run; ``device="cpu"`` is the explicit opt-in."""
    import torch
    from neuronx_distributed_inference_tpu_torch.config import TpuConfig
    from neuronx_distributed_inference_tpu_torch.models.application import \
        PagedCausalLMApplication
    from neuronx_distributed_inference_tpu_torch.models.llama import (
        LlamaFamily, LlamaInferenceConfig)
    from neuronx_distributed_inference_tpu_torch.utils.jax_params import \
        params_from_numpy
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA card; the default device is valid")
    hf = dict(model_type="llama", hidden_size=64, intermediate_size=128,
              num_hidden_layers=1, num_attention_heads=4,
              num_key_value_heads=2, vocab_size=256, rms_norm_eps=1e-5)
    cfg = LlamaInferenceConfig(TpuConfig(is_block_kv_layout=True,
                                         dtype="float32"), **hf)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedCausalLMApplication(None, cfg, LlamaFamily)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy({})
    app = PagedCausalLMApplication(None, cfg, LlamaFamily, device="cpu")
    assert app.device.type == "cpu"


def test_decode_attention_wrapper_refuses_bad_input():
    """The kernel wrapper raises on what the kernel does not take; CPU
    tensors take the plain twin (and do not count as launches)."""
    import torch
    from neuronx_distributed_inference_tpu_torch.ops import decode_attention
    b, hq, hkv, d, bs, mb = 2, 4, 2, 64, 8, 2
    q = torch.zeros(b, hq, d)
    pages = torch.zeros(1, 5, bs, hkv, d)
    nk = torch.zeros(b, hkv, d)
    lens = torch.tensor([3, 9], dtype=torch.int32)
    table = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    before = decode_attention.paged_decode_attention.launches
    out = decode_attention.paged_decode_attention(
        q, pages, pages, nk, nk, 0, lens, table, scale=d ** -0.5)
    assert out.shape == (b, hq, d)
    assert decode_attention.paged_decode_attention.launches == before
    bad = [
        dict(q=torch.zeros(b, hq, 32)),                      # head dim
        dict(lens=lens.long()),                              # lens dtype
        dict(block_table=table.long()),                      # table dtype
        dict(q=torch.zeros(b, 5, d)),                        # Hq % Hkv
        dict(layer=1),                                       # layer range
        dict(q=torch.zeros(b, d, hq).transpose(1, 2)),       # contiguity
        dict(new_k=torch.zeros(b, hkv, d, dtype=torch.bfloat16)),
    ]
    base = dict(q=q, k_pages=pages, v_pages=pages, new_k=nk, new_v=nk,
                layer=0, lens=lens, block_table=table)
    for over in bad:
        kw = dict(base, **over)
        with pytest.raises(ValueError):
            decode_attention.paged_decode_attention(
                kw["q"], kw["k_pages"], kw["v_pages"], kw["new_k"],
                kw["new_v"], kw["layer"], kw["lens"], kw["block_table"],
                scale=d ** -0.5)


@pytest.mark.parametrize("name", ["phimoe", "olmoe", "granitemoe",
                                  "glm4_moe", "dots1", "gpt2", "bloom",
                                  "lfm2", "falcon_h1"])
def test_get_family_resolves_the_ported_contrib_families_only(name):
    """``get_family`` resolves the contrib hub's five MoE families and its
    ported dense ones (gpt2, bloom, ...) to the port's own classes
    (``models/contrib``, ``contrib2``, ``contrib3``); a hub family the port
    does not carry yet (the hybrid lfm2 and falcon_h1: ROADMAP A14e) still
    raises ``KeyError``."""
    from neuronx_distributed_inference_tpu_torch.models.family import \
        get_family
    if name in ("lfm2", "falcon_h1"):
        with pytest.raises(KeyError, match=name):
            get_family(name)
        return
    fam = get_family(name)
    assert fam.__module__.startswith(port.__name__ + ".models.contrib")
    assert name in fam.family_names

