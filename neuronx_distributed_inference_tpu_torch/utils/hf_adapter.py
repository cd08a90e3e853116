"""HuggingFace ``generate()``-compatible adapter (counterpart:
``neuronx_distributed_inference_tpu/utils/hf_adapter.py`` —
``HuggingFaceGenerationAdapter`` :41-188, ``_assisted_generate``
:177-188).

Wraps a :class:`~..models.application.CausalLMApplication` so code written
against the HF transformers generation API runs unchanged:

  * torch tensors in, torch tensors out on the application's device (a
    plain ``sequences`` tensor, or a dict with ``return_dict_in_generate``);
  * LEFT padding (the HF decoder-only convention) is normalised at the
    boundary to the application's right-padded layout, and
    ``sequences[:, :s]`` gives back the caller's input block unchanged;
  * ``GenerationConfig`` (an object or a dict) and keyword arguments:
    max_new_tokens, max_length, do_sample, top_k, top_p, temperature,
    eos_token_id (one id or a list), pad_token_id.

Assisted decoding (``assistant_model``: another adapter, an application
or a prebuilt ``SpeculativeDecoder``) runs fused greedy speculation
(``models/speculation.py``) with the adapter's application as the target,
which needs ``speculation_config.speculation_length`` >= 1; its stream is
greedy decode's. The host loops live in the application's ``generate`` and
the decoder's; this module only adapts.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..ops.sampling import prepare_sampling_params

logger = logging.getLogger("nxdi_tpu_torch")


def _to_numpy(x):
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class HuggingFaceGenerationAdapter:
    """Duck-typed stand-in for a HF ``PreTrainedModel`` in generation
    code. ``app``: a weight-loaded application; ``generation_config``: an
    optional object or dict of HF generation defaults."""

    def __init__(self, app, generation_config=None):
        self.app = app
        self.config = app.config
        self.generation_config = generation_config
        self.device = app.device

    # HF code probes these
    @property
    def main_input_name(self):
        return "input_ids"

    def can_generate(self):
        return True

    def eval(self):
        return self

    def _resolve(self, name, kwargs, default=None):
        """A keyword argument, else the call's or the adapter's
        ``generation_config`` field, else ``default``."""
        if kwargs.get(name) is not None:
            return kwargs[name]
        gc = kwargs.get("generation_config") or self.generation_config
        if gc is not None:
            v = gc.get(name) if isinstance(gc, dict) else getattr(gc, name,
                                                                  None)
            if v is not None:
                return v
        return default

    @staticmethod
    def _normalize_padding(ids: np.ndarray, mask: np.ndarray):
        """LEFT-padded rows -> right-padded (the application's layout).
        Rows already right-padded or unpadded pass through unchanged.
        Returns (ids, mask, lens, any row left-padded)."""
        out_ids = np.zeros_like(ids)
        out_mask = np.zeros_like(mask)
        lens = mask.astype(np.int64).sum(axis=1)
        left_padded = False
        for i in range(ids.shape[0]):
            pos = np.nonzero(mask[i])[0]
            n = int(lens[i])
            if n and not np.array_equal(pos, np.arange(n)):
                left_padded = True
            out_ids[i, :n] = ids[i, pos]
            out_mask[i, :n] = 1
        return out_ids, out_mask, lens, left_padded

    def generate(self, input_ids=None, attention_mask=None,
                 assistant_model=None, return_dict_in_generate: bool = False,
                 **kwargs):
        """HF-compatible generation. Returns a LongTensor ``sequences``
        (the caller's input block, then the generated tokens, cut after
        the first eos and padded with ``pad_token_id``) on the
        application's device, or ``{"sequences": ...}`` with
        ``return_dict_in_generate``."""
        ids = _to_numpy(input_ids).astype(np.int64)
        if ids.ndim == 1:
            ids = ids[None, :]
        b, s = ids.shape
        mask = _to_numpy(attention_mask)
        mask = (np.ones_like(ids) if mask is None
                else mask.astype(np.int64))

        max_new = self._resolve("max_new_tokens", kwargs)
        if max_new is None:
            max_length = self._resolve("max_length", kwargs,
                                       self.app.tpu_config.seq_len)
            max_new = max(int(max_length) - s, 1)
        eos = self._resolve("eos_token_id", kwargs)
        if isinstance(eos, (list, tuple)) and not eos:
            eos = None
        pad_id = self._resolve("pad_token_id", kwargs)
        if pad_id is None:
            pad_id = ((eos[0] if isinstance(eos, (list, tuple)) else eos)
                      if eos is not None else 0)

        do_sample = bool(self._resolve("do_sample", kwargs, False))
        sampling_params = None
        if do_sample:
            sampling_params = prepare_sampling_params(
                b, self._resolve("top_k", kwargs, 0) or 0,
                self._resolve("top_p", kwargs, 1.0),
                self._resolve("temperature", kwargs, 1.0))

        r_ids, r_mask, _, _ = self._normalize_padding(ids, mask)
        if assistant_model is not None:
            if do_sample:
                logger.warning("assisted decoding is greedy-only; ignoring "
                               "do_sample/top_k/top_p/temperature")
            out = self._assisted_generate(assistant_model, r_ids, r_mask,
                                          int(max_new), eos)
        else:
            out = self.app.generate(
                r_ids, attention_mask=r_mask, max_new_tokens=int(max_new),
                eos_token_id=eos, sampling_params=sampling_params)
        gen = np.asarray(out["generated"])
        eos_arr = (np.atleast_1d(np.asarray(eos, dtype=np.int64))
                   if eos is not None else None)
        seqs = np.full((b, s + gen.shape[1]), pad_id, dtype=np.int64)
        seqs[:, :s] = ids
        for i in range(b):
            row = gen[i]
            if eos_arr is not None:
                hits = np.nonzero(np.isin(row, eos_arr))[0]
                if hits.size:
                    row = row[:hits[0] + 1]
            seqs[i, s:s + len(row)] = row
        result = torch.from_numpy(seqs).to(self.device)
        if return_dict_in_generate:
            d = {"sequences": result}
            if "mean_tokens_per_step" in out:
                d["mean_tokens_per_step"] = out["mean_tokens_per_step"]
            return d
        return result

    def _assisted_generate(self, assistant_model, r_ids, r_mask, max_new,
                           eos):
        """Assisted decoding (reference :177-188): the assistant is another
        adapter, an application, or a prebuilt ``SpeculativeDecoder``."""
        from ..models.speculation import SpeculativeDecoder
        if isinstance(assistant_model, SpeculativeDecoder):
            dec = assistant_model
        else:
            draft_app = getattr(assistant_model, "app", assistant_model)
            dec = SpeculativeDecoder(self.app, draft_app)
        return dec.generate(r_ids, max_new_tokens=max_new, eos_token_id=eos,
                            attention_mask=r_mask)

    __call__ = generate
