"""The Medusa and EAGLE serving proposers of the port and the verify
dispatches' hidden states (``want_hidden``), held to the JAX package's
(the pins of tests/test_spec_serving.py:331-462).

Geometry: the tiny fp32 Llama of ``tests/test_torch_ragged.py`` (hidden
64, 2 layers, 4 q / 2 kv heads of head_dim 16, vocab 512; block 8) at
batch 4 with 2 Medusa heads, so three live rows pad to the 4-row bucket,
and a 1-layer EAGLE draft at the target's width; the same numpy weights
in both packages (``test_torch_ragged._numpy_weights``, the draft through
``params_from_numpy``); TF32 off. Tolerances: hidden states atol=2e-3,
rtol=1e-3; every served stream EQUALS the JAX adapter's and the eager
(non-speculative) stream, token for token."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from neuronx_distributed_inference_tpu.config import TpuConfig as JTpuConfig
from neuronx_distributed_inference_tpu.models import model_base as jmb
from neuronx_distributed_inference_tpu.models import speculation as jspec
from neuronx_distributed_inference_tpu.models.application import \
    PagedCausalLMApplication as JPagedApp
from neuronx_distributed_inference_tpu.models.llama import (
    LlamaFamily as JLlamaFamily, LlamaInferenceConfig as JLlamaConfig)
from neuronx_distributed_inference_tpu.serving import \
    PagedEngineAdapter as JPagedEngineAdapter
from neuronx_distributed_inference_tpu.serving.speculation import (
    EagleProposer as JEagleProposer, MedusaProposer as JMedusaProposer,
    SelfDraftProposer as JSelfDraft)
from neuronx_distributed_inference_tpu_torch.config import TpuConfig
from neuronx_distributed_inference_tpu_torch.models.application import \
    PagedCausalLMApplication
from neuronx_distributed_inference_tpu_torch.models.llama import (
    LlamaFamily, LlamaInferenceConfig)
from neuronx_distributed_inference_tpu_torch.resilience import \
    ConfigurationError
from neuronx_distributed_inference_tpu_torch.serving import \
    PagedEngineAdapter
from neuronx_distributed_inference_tpu_torch.serving.speculation import (
    EagleProposer, MedusaProposer, SelfDraftProposer)
from neuronx_distributed_inference_tpu_torch.utils.jax_params import \
    params_from_numpy
from test_torch_ragged import HF, TCFG, _numpy_weights

TOL = dict(atol=2e-3, rtol=1e-3)
KW = dict(TCFG, batch_size=4, pa_num_blocks=48, is_prefix_caching=False)
RNG = np.random.default_rng(29)
PROMPTS = [RNG.integers(1, 500, size=n).tolist() for n in (6, 9, 7)]
WANT = 8
PATHS = ["two_phase", "ragged"]


@pytest.fixture(autouse=True)
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.fixture(scope="module")
def pair():
    """(JAX app, port app) at batch 4 with 2 Medusa heads, on the same
    numpy weights."""
    japp = JPagedApp(None, JLlamaConfig(JTpuConfig(**KW), **HF),
                     JLlamaFamily)
    japp.spec = dataclasses.replace(japp.spec, medusa_heads=2)
    japp.init_random_weights(0)
    host = _numpy_weights(japp, 7)
    japp._put_params(host)
    japp.init_cache()
    tapp = PagedCausalLMApplication(
        None, LlamaInferenceConfig(TpuConfig(**KW), **HF), LlamaFamily,
        device="cpu")
    tapp.spec = dataclasses.replace(tapp.spec, medusa_heads=2)
    tapp.params = params_from_numpy(host, device="cpu")
    tapp.init_cache()
    return japp, tapp


@pytest.fixture(scope="module")
def draft(pair):
    """A 1-layer EAGLE draft: (JAX spec, JAX params, port spec, port
    params)."""
    japp, tapp = pair
    jds = jmb.spec_from_config(japp.config, tp_degree=1, num_layers=1)
    jp = jspec.init_eagle_draft_params(jds, jax.random.PRNGKey(3),
                                       japp.mesh)
    tds = dataclasses.replace(tapp.spec, num_layers=1, medusa_heads=0)
    return jds, jp, tds, params_from_numpy(jax.tree.map(np.asarray, jp),
                                           device="cpu")


@pytest.fixture(scope="module")
def refs(pair):
    """The eager (non-speculative) streams of the port, held to JAX's and
    to the port's single-prompt ``generate``."""
    out = []
    for cls, app in zip((JPagedEngineAdapter, PagedEngineAdapter), pair):
        eng = cls(app)
        sids = list(range(len(PROMPTS)))
        res = eng.add_requests(sids, PROMPTS)
        got = {s: [res[s]] for s in sids}
        for _ in range(WANT - 1):
            for s, t in eng.step().items():
                got[s].append(t)
        eng.release(sids)
        out.append(got)
    assert out[1] == out[0]
    tapp = pair[1]
    for s, prompt in enumerate(PROMPTS):
        gen = tapp.generate(np.asarray([prompt]), max_new_tokens=WANT)
        tapp.release()
        assert gen["generated"][0].tolist() == out[1][s]
    return out[1]


def _proposer(side, kind, draft=None):
    if kind == "medusa":
        return (JMedusaProposer if side == "jax" else MedusaProposer)(2)
    jds, jp, tds, tp = draft
    if side == "jax":
        return JEagleProposer(jds, jp, 2)
    return EagleProposer(tds, tp, 2)


def _serve(eng, path, stagger):
    """Serve PROMPTS until every stream holds WANT tokens, the third
    admitted mid-decode when ``stagger``; returns (streams, per-step
    (verify dispatches, blocking fetches) deltas)."""
    sids = [0, 1, 2]
    first = sids[:2] if stagger else sids
    res = eng.add_requests(first, PROMPTS[:len(first)])
    got = {s: ([res[s]] if s in res else []) for s in sids}
    deltas, steps = [], 0
    while any(len(got[s]) < WANT for s in sids):
        if stagger and steps == 3:
            res = eng.add_requests([2], [PROMPTS[2]])
            got[2] += [res[2]] if 2 in res else []
        before = dict(eng.host_stats)
        for s, toks in eng.step().items():
            got[s].extend(toks if isinstance(toks, list) else [toks])
        deltas.append((eng.host_stats.get("spec_verify_dispatches", 0)
                       - before.get("spec_verify_dispatches", 0),
                       eng.host_stats["blocking_fetches"]
                       - before["blocking_fetches"]))
        steps += 1
        assert steps < 60, "speculative decode made no progress"
    return {s: got[s][:WANT] for s in sids}, deltas


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("kind", ["medusa", "eagle"])
def test_proposer_streams_match_jax_and_eager(pair, draft, refs, path, kind):
    """Three live rows of a 4-row bucket (the padded-batch feature
    plumbing), the third admitted mid-decode on the ragged path (its
    prefill chunk packs with the verify rows): the streams equal the JAX
    adapter's and the eager ones; one verify dispatch per two-phase step
    and one blocking fetch per ragged step; the per-sequence state (Medusa
    features, EAGLE slots) is seeded, then dropped on release."""
    streams = []
    for side, cls, app in (("jax", JPagedEngineAdapter, pair[0]),
                           ("port", PagedEngineAdapter, pair[1])):
        prop = _proposer(side, kind, draft)
        kw = {"ragged": True} if path == "ragged" else {}
        eng = cls(app, speculation=prop, **kw)
        got, deltas = _serve(eng, path, stagger=path == "ragged")
        held = prop._feat if kind == "medusa" else prop._slots
        assert held
        eng.release([0, 1, 2])
        assert (prop._feat if kind == "medusa" else prop._slots) == {}
        streams.append(got)
        if side == "port":
            if path == "ragged":
                assert all(f == 1 for _, f in deltas)
            else:
                assert all(v == 1 for v, _ in deltas)
    assert streams[1] == streams[0]
    assert streams[1] == refs


class _Recorder(SelfDraftProposer):
    """Self-draft that asks for the verify's hidden states and records
    them."""
    name = "recorder"
    wants_hidden = True

    def __init__(self, k):
        super().__init__(k)
        self.seen = []

    def on_verify(self, ctx, tokens, n_emit, hidden):
        self.seen.append(np.asarray(hidden)[:len(ctx.live)])


class _JRecorder(JSelfDraft):
    name = "recorder"
    wants_hidden = True

    def __init__(self, k):
        super().__init__(k)
        self.seen = []

    def on_verify(self, ctx, tokens, n_emit, hidden):
        self.seen.append(np.asarray(hidden)[:len(ctx.live)])


@pytest.mark.parametrize("path", PATHS)
def test_want_hidden_matches_jax(pair, path):
    """The hidden states of ``paged_spec_verify`` (two-phase) and
    ``paged_ragged_step`` (ragged) with ``want_hidden``, as the proposer
    receives them (the live rows, W columns), equal JAX's at every
    step."""
    seen = []
    for cls, rec, app in ((JPagedEngineAdapter, _JRecorder(3), pair[0]),
                          (PagedEngineAdapter, _Recorder(3), pair[1])):
        kw = {"ragged": True} if path == "ragged" else {}
        eng = cls(app, speculation=rec, **kw)
        _serve(eng, path, stagger=False)
        eng.release([0, 1, 2])
        seen.append(rec.seen)
    assert len(seen[1]) == len(seen[0]) >= 2
    for a, b in zip(seen[1], seen[0]):
        assert a.shape == b.shape and a.shape[1] in (1, 2, 4)
        np.testing.assert_allclose(a, b, **TOL)


def test_on_verify_failure_degrades_not_corrupts(pair, refs):
    """A Medusa proposer crashing in its feedback costs its per-sequence
    state only: the step's tokens are delivered, its features are
    dropped, and the next steps continue the eager stream."""
    class Flaky(MedusaProposer):
        name = "flaky"
        calls = 0
        forgotten = ()

        def on_verify(self, ctx, tokens, n_emit, hidden):
            Flaky.calls += 1
            if Flaky.calls == 2:
                raise RuntimeError("stateful proposer bug")
            super().on_verify(ctx, tokens, n_emit, hidden)

        def forget(self, seq_ids):
            Flaky.forgotten += tuple(seq_ids)
            super().forget(seq_ids)

    for path in PATHS:
        Flaky.calls, Flaky.forgotten = 0, ()
        kw = {"ragged": True} if path == "ragged" else {}
        eng = PagedEngineAdapter(pair[1], speculation=Flaky(2), **kw)
        got, _ = _serve(eng, path, stagger=False)
        eng.release([0, 1, 2])
        assert got == refs
        assert Flaky.calls >= 3
        assert {0, 1, 2} <= set(Flaky.forgotten)


def test_medusa_proposer_needs_heads(pair):
    with pytest.raises(ConfigurationError, match="medusa"):
        PagedEngineAdapter(pair[1], speculation=MedusaProposer(3))
