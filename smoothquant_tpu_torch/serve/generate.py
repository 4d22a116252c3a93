"""Generation: prefill, then one decode step per token, over per-layer
head-major KV caches (port of smoothquant_tpu/serve/generate.py:22-130).

The Generator serves every per-layer tree of a registered family (Llama,
Mistral, OPT, Bloom, Falcon, Mixtral): fp, simulated (quantize_model's, under `quant`),
packed (K6, or K8 / K9 for int8-container packs as `compute` picks) and the
real-INT8 OPT (models.opt_int8, with kv_dtype=torch.int8).  One
ForwardContext(quant, compute, attn) reaches every forward
(generate.py:44-64).  The prompt is prefilled on `prefill_params` (for
example promote_model_int8 of a plain nibble pack, whose int8 layout runs
K4) and every later token is decoded on `params`, over one KVCache or
QuantKVCache per layer (K11 as `attn` picks it: the int8 cache under
"auto", the fp one too under "kernel").  Stacked trees are refused, as the
JAX Generator cannot serve them either (its per-layer caches do not fit
the scan over a stacked tree): the ContinuousBatcher serves those.
Sampling happens on the device; only the (B,) token ids reach the host
each step.  A cache holds cache_kv_heads(cfg) heads: Falcon's
effective_kv_heads (one for multi-query), else num_key_value_heads or one
a query head.  The JAX Generator (generate.py:68) and batcher
(batching.py:61) read only num_key_value_heads, so they build a
multi-query Falcon's caches with a head a query head, write head 0 alone,
and attend to zeros: their Falcon tokens are not the model's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from smoothquant_tpu_torch._device import resolve_device
from smoothquant_tpu_torch.models.common import ForwardContext, KVCache, QuantKVCache


def cache_kv_heads(cfg) -> int:
    """The kv heads of a family's cache: effective_kv_heads where the
    config has it (Falcon), else num_key_value_heads, else the heads."""
    n = getattr(cfg, "effective_kv_heads", None)
    return n if n is not None else getattr(cfg, "num_key_value_heads",
                                            cfg.num_attention_heads)


@dataclasses.dataclass
class GenerationConfig:
    max_new_tokens: int = 64
    temperature: float = 0.0  # 0 → greedy
    eos_token_id: Optional[int] = None
    seed: int = 0


def sample_token(logits: torch.Tensor, temperature: float,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """logits (B, V) → token ids (B,): argmax at temperature 0, else a draw
    from softmax(logits / temperature) with the given torch.Generator (the
    JAX package's categorical draw with a PRNG key; the two give different
    numbers from one seed)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


class Generator:
    """Batch generation on top of a model module (needs forward, and a cfg
    with num_hidden_layers, num_attention_heads (num_key_value_heads or
    effective_kv_heads where the cache's differ), head_dim, dtype)."""

    def __init__(self, model_mod, params, cfg, quant=None, *, kv_dtype=None,
                 max_len: int = 2048, quant_kv: bool = False, compute: str = "auto",
                 attn: str = "auto", prefill_params=None, device="cuda",
                 forward_fn=None):
        """quant: the simulated path's recipe (a quantize_model tree).
        compute / attn: ForwardContext's (K8 / K9 for int8-container packs;
        K11 or the einsum).  prefill_params: an optional second per-layer
        tree used ONLY for the prompt prefill — e.g. promote_model_int8 of a
        plain nibble pack of the same weights — while decode keeps `params`.
        kv_dtype: the KVCache dtype, cfg's by default; torch.int8 holds the
        raw static-scale int8 k / v of models.opt_int8
        (generate.py:45,66-68).  forward_fn: (params, ids, caches) →
        (logits, caches) in place of mod.forward (generate.py:47-78), for
        example parallel.tp_packed.make_tp_decode_v2's step, which serves a
        tensor-parallel model over a head-sharded cache; where it carries
        `kv_heads` (that step does: the rank's heads) the caches hold that
        many heads."""
        self.mod, self.params, self.cfg = model_mod, params, cfg
        self.ctx = ForwardContext(quant=quant, compute=compute, attn=attn)
        self.prefill_params = params if prefill_params is None else prefill_params
        for tree in (self.params, self.prefill_params):
            if "stacked" in tree.get("layers", {}):
                raise NotImplementedError("the Generator runs per-layer trees")
        self.device = resolve_device(device)
        self.max_len = max_len
        self._cache_cls = QuantKVCache if quant_kv else KVCache
        self.kv_dtype = kv_dtype or cfg.torch_dtype
        self._n_kv = getattr(forward_fn, "kv_heads", None) or cache_kv_heads(cfg)
        self._forward = forward_fn or (lambda p, ids, caches: self.mod.forward(
            p, ids, self.cfg, ctx=self.ctx, caches=caches))

    def _new_caches(self, batch: int) -> list:
        cfg = self.cfg
        return [self._cache_cls.create(batch, self.max_len, self._n_kv, cfg.head_dim,
                                       self.kv_dtype, self.device)
                for _ in range(cfg.num_hidden_layers)]

    @torch.no_grad()
    def _step(self, params, ids: torch.Tensor, caches, temperature, rng):
        logits, caches = self._forward(params, ids, caches)
        return sample_token(logits[:, -1, :], temperature, rng), caches

    def generate(self, prompt_ids: np.ndarray, gen: GenerationConfig) -> np.ndarray:
        """prompt_ids (B, S) → (B, S + new) ids; after an EOS a row repeats
        EOS, and generation stops once every row has produced one."""
        prompt_ids = np.atleast_2d(np.asarray(prompt_ids))
        b, s = prompt_ids.shape
        if s + gen.max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt({s}) + max_new_tokens({gen.max_new_tokens}) exceeds "
                f"max_len({self.max_len})")
        rng = None
        if gen.temperature > 0.0:
            rng = torch.Generator(device=self.device).manual_seed(gen.seed)
        caches = self._new_caches(b)
        tok, caches = self._step(self.prefill_params,
                                 torch.as_tensor(prompt_ids, device=self.device),
                                 caches, gen.temperature, rng)
        out = [prompt_ids]
        done = np.zeros(b, bool)
        for step in range(gen.max_new_tokens):
            tok_np = tok.cpu().numpy()
            if gen.eos_token_id is not None:
                tok_np = np.where(done, gen.eos_token_id, tok_np)
                done |= tok_np == gen.eos_token_id
            out.append(tok_np[:, None])
            if step + 1 == gen.max_new_tokens or (
                    gen.eos_token_id is not None and done.all()):
                break
            tok, caches = self._step(self.params,
                                     torch.as_tensor(tok_np[:, None], device=self.device),
                                     caches, gen.temperature, rng)
        return np.concatenate(out, axis=1)
