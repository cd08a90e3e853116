"""Helpers of the contrib model hub (counterpart:
``neuronx_distributed_inference_tpu/models/contrib.py`` — ``_SimpleConfig``
:23, ``_t`` :31, ``_ident`` :35, ``_vpad`` :686, ``_vpad1`` :692).

The hub's families are thin ``DecoderSpec`` mappings plus checkpoint
conversion over the shared layer machinery. The port carries the hub's
MoE families (``contrib2``: GraniteMoE, OLMoE, GLM-4-MoE, dots.llm1;
``contrib3``: Phi-3.5-MoE) and the helpers they share, kept here as the
port's own copies. The ten dense families of the reference's first hub
wave (gpt2, gpt_neox, falcon, starcoder2, phi, gemma, olmo, glm4,
stablelm, cohere) wait for ROADMAP A14e, with the knobs they need
(``mlp_bias``, plain MLPs, learned positions, parallel blocks)."""

from __future__ import annotations

from typing import List

import numpy as np

from ..config import InferenceConfig


class _SimpleConfig(InferenceConfig):
    """A config that only requires ``vocab_size``; the family's
    ``build_spec`` reads what it needs with defaults."""

    def get_required_attributes(self) -> List[str]:
        return ["vocab_size"]

    def get_text_config(self):
        return self


def _t(w):
    """A torch Linear weight (out, in) as the tree's (in, out)."""
    return np.ascontiguousarray(np.asarray(w).T)


def _ident(w):
    return np.asarray(w)


def _vpad(w: np.ndarray, padded: int) -> np.ndarray:
    """Rows (the vocabulary axis) zero-padded up to ``padded``."""
    if w.shape[0] < padded:
        w = np.pad(w, [(0, padded - w.shape[0])] + [(0, 0)] * (w.ndim - 1))
    return w


def _vpad1(b: np.ndarray, padded: int) -> np.ndarray:
    """A vocabulary-long bias zero-padded up to ``padded``."""
    if b.shape[0] < padded:
        b = np.pad(b, (0, padded - b.shape[0]))
    return b
