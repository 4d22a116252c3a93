"""Continuous batching over a pool of per-slot KV caches (port of
smoothquant_tpu/serve/batching.py:31-411).

It takes every tree, pool and option the JAX batcher takes, for every
registered family (Llama and Mistral, OPT, Bloom, Falcon, Mixtral; a
cache holds generate.cache_kv_heads(cfg) heads, one for a multi-query
Falcon, where the JAX batcher builds a head a query head):

  * a fixed pool of `max_batch` slots with per-slot cache positions
    (batching.py:57-108).  A stacked decode tree (stack_layers) serves over
    ONE stacked pool, leading L axis, (L, B) positions: the fp head-major
    KVCache (quant_kv=False, the JAX default), the int8 head-major
    QuantKVCache (quant_kv=True) or the int8 S-major one (smajor=True).  A
    per-layer tree serves over a list of per-layer caches of the same three
    kinds, each with (B,) positions.  Llama's stacked decode runs K13 (fp
    trees) or K1 / K7 + K5 (packs) and K10 + K11 or K2 + K3; a stacked tree
    it declines, and every per-layer tree, runs the per-layer body (K6, K8
    / K9 by `compute`, K11 by `attn`, or the simulated linears under
    `quant`);
  * same-bucket admissions share one batched prefill on the prefill tree
    (`prefill_params`, per-layer or stacked; for example the int8 twin of
    promote_model_int8, whose linears run K4), written into one stacked
    batch cache (per-layer views of it for a per-layer tree), whose rows
    are scattered into the pool, cropped at max_len (batching.py:125-205);
  * rotary and learned positions use each slot's TRUE sequence position
    (seq_pos), the cache row its POOL position (pool_pos / the device pos)
    — they differ after a bucketed prefill;
  * padded and dead cache positions stay masked by the key-validity mask;
  * step() decodes one token, step_chunk(k) k tokens with the argmax on
    the device and one host fetch per chunk.

One ForwardContext(quant, compute, attn) reaches every forward; `attn` is
the port's addition (the JAX batcher takes its default, "auto").  JAX's
`interpret` has no counterpart: on CPU tensors every kernel wrapper runs its
plain version.

Prefill runs the lm_head on each row's last true position only
(forward_hidden, then lm_head_logits): every row's logits are independent
of the others, so the first tokens equal those of the JAX batcher, which
gathers them from the full (rows, S, V) logits.

Deliberate divergence: step() asserts that an active slot's pool position
lies inside the cache before marking it valid (the JAX batcher indexes the
host mask unchecked there).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from smoothquant_tpu_torch._device import resolve_device
from smoothquant_tpu_torch.serve.generate import cache_kv_heads
from smoothquant_tpu_torch.models.common import (
    ForwardContext,
    KVCache,
    QuantKVCache,
    SMajorQuantKVCache,
)


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray              # (S,) int
    max_new_tokens: int = 32
    eos_token_id: Optional[int] = None
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False


def _bucket(n: int, buckets=(32, 64, 128, 256, 512, 1024, 2048)) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt length {n} exceeds largest bucket")


def _fields(cache) -> tuple:
    """The tensors of a cache, positions excluded."""
    return ("k", "v") if isinstance(cache, KVCache) else ("k_q", "v_q", "k_scale", "v_scale")


def _s_axis(cache, name: str) -> int:
    """The S axis of a per-layer, per-slot field (slot axis removed): axis 0
    of the S-major values (S, H·D), axis 1 of the head-major (H, S, D)
    values and of every (H, S) scale tensor."""
    return 0 if isinstance(cache, SMajorQuantKVCache) and name in ("k_q", "v_q") else 1


class ContinuousBatcher:
    def __init__(self, model_mod, params, cfg, quant=None, *, max_batch: int = 4,
                 max_len: int = 512, kv_dtype=None, quant_kv: bool = False,
                 compute: str = "auto", attn: str = "auto", prefill_params=None,
                 smajor: bool = False, device="cuda"):
        if smajor and not quant_kv:
            raise ValueError("the S-major layout is int8-only (quant_kv=True)")
        self.mod, self.params, self.cfg = model_mod, params, cfg
        self.prefill_params = params if prefill_params is None else prefill_params
        self.ctx = ForwardContext(quant=quant, compute=compute, attn=attn)
        self.device = resolve_device(device)
        self.max_batch, self.max_len = max_batch, max_len
        self.kv_dtype = kv_dtype or cfg.torch_dtype
        self._cache_cls = (SMajorQuantKVCache if smajor
                           else QuantKVCache if quant_kv else KVCache)
        self._stacked = "stacked" in params.get("layers", {})
        self._prefill_stacked = "stacked" in self.prefill_params.get("layers", {})
        n_l = cfg.num_hidden_layers
        if self._stacked:
            self.caches = self._new_cache(max_batch, max_len, n_layers=n_l, per_slot=True)
        else:
            self.caches = [self._new_cache(max_batch, max_len, per_slot=True)
                           for _ in range(n_l)]
        self.key_valid = np.zeros((max_batch, max_len), bool)
        self.seq_pos = np.zeros(max_batch, np.int64)   # true sequence lengths
        # host mirror of the per-slot device cache positions: every decode
        # step advances every slot (dead ones too); admission resets a slot
        self.pool_pos = np.zeros(max_batch, np.int64)
        self.slot_req: list[Optional[Request]] = [None] * max_batch
        self.queue: list[Request] = []
        self._steps = 0

    def _new_cache(self, batch: int, length: int, n_layers=None, per_slot=False):
        cfg = self.cfg
        n_kv = cache_kv_heads(cfg)
        if self._cache_cls is SMajorQuantKVCache:
            return SMajorQuantKVCache.create(batch, length, n_kv, cfg.head_dim, self.device,
                                             n_layers=n_layers, per_slot=per_slot)
        return self._cache_cls.create(batch, length, n_kv, cfg.head_dim, self.kv_dtype,
                                      self.device, per_slot=per_slot, n_layers=n_layers)

    def _to_dev(self, a) -> torch.Tensor:
        return torch.as_tensor(a).to(self.device)

    def _pool_positions(self) -> torch.Tensor:
        """(B,) device positions of the pool (every layer holds the same)."""
        return self.caches.pos[0] if self._stacked else self.caches[0].pos

    # ------------------------------------------------------------ device

    @torch.no_grad()
    def _prefill(self, ids: np.ndarray, lens: np.ndarray):
        """First generated token of each row and the rows' stacked batch
        cache (positions aligned at 0): a stacked prefill tree fills it
        whole, a per-layer one through per-layer views of it (batching.py:
        125-149 creates per-layer caches and stacks them; here the stack
        exists first and needs no copy)."""
        cfg = self.cfg
        rows, bucket = ids.shape
        batch = self._new_cache(rows, bucket, n_layers=cfg.num_hidden_layers)
        caches = (batch if self._prefill_stacked else
                  [batch.layer(i, 0) for i in range(cfg.num_hidden_layers)])
        h, _ = self.mod.forward_hidden(self.prefill_params, self._to_dev(ids), cfg,
                                       caches=caches, ctx=self.ctx)
        idx = self._to_dev(np.clip(lens - 1, 0, bucket - 1))
        last = h[torch.arange(rows, device=self.device), idx]
        logits = self.mod.lm_head_logits(self.prefill_params, last[:, None], cfg, self.ctx)
        first = torch.argmax(logits[:, 0], dim=-1)
        return first.cpu().numpy(), batch

    def _scatter(self, batch, row: int, slot: int, new_pos: int) -> None:
        """Copy prefill row `row` of the stacked batch cache into pool slot
        `slot`, cropped at max_len on each field's S axis (batching.py:
        152-205), into the stacked pool or each layer's cache."""
        pools = [self.caches] if self._stacked else self.caches
        for i, pool in enumerate(pools):
            for name in _fields(pool):
                src, dst = getattr(batch, name), getattr(pool, name)
                src, dst = (src[:, row], dst[:, slot]) if self._stacked else (src[i, row],
                                                                               dst[slot])
                ax = _s_axis(pool, name) + self._stacked
                n = min(src.shape[ax], self.max_len)
                dst.narrow(ax, 0, n).copy_(src.narrow(ax, 0, n))
            if self._stacked:
                pool.pos[:, slot] = new_pos
            else:
                pool.pos[slot] = new_pos

    def _decode(self, tok: torch.Tensor, positions: torch.Tensor,
                key_valid: torch.Tensor) -> torch.Tensor:
        h, self.caches = self.mod.forward_hidden(
            self.params, tok[:, None], self.cfg, caches=self.caches,
            positions=positions[:, None], attn_mask=key_valid, ctx=self.ctx)
        logits = self.mod.lm_head_logits(self.params, h, self.cfg, self.ctx)
        return torch.argmax(logits[:, -1], dim=-1)

    # ------------------------------------------------------------ API

    def submit(self, req: Request) -> None:
        if len(req.prompt) + req.max_new_tokens > self.max_len:
            raise ValueError("request exceeds max_len")
        self.queue.append(req)

    def _admit(self) -> None:
        free = [s for s in range(self.max_batch) if self.slot_req[s] is None]
        # same-bucket admissions share one prefill; each pass starts from
        # the queue head, so no bucket starves
        while free and self.queue:
            head_bucket = _bucket(len(self.queue[0].prompt))
            batch: list[Request] = []
            rest: list[Request] = []
            for req in self.queue:
                if len(batch) < len(free) and _bucket(len(req.prompt)) == head_bucket:
                    batch.append(req)
                else:
                    rest.append(req)
            self.queue = rest
            n_rows = 1
            while n_rows < len(batch):
                n_rows *= 2
            ids = np.zeros((n_rows, head_bucket), np.int64)
            lens = np.ones((n_rows,), np.int64)
            for i, req in enumerate(batch):
                ids[i, : len(req.prompt)] = req.prompt
                lens[i] = len(req.prompt)
            first_toks, kv_batch = self._prefill(ids, lens)
            for i, req in enumerate(batch):
                slot = free.pop(0)
                s_true = len(req.prompt)
                self._scatter(kv_batch, i, slot, s_true)
                self.key_valid[slot, :] = False
                self.key_valid[slot, :s_true] = True
                self.seq_pos[slot] = s_true
                self.pool_pos[slot] = s_true
                self.slot_req[slot] = req
                self._emit(slot, int(first_toks[i]))

    def _emit(self, slot: int, token: int) -> None:
        req = self.slot_req[slot]
        req.generated.append(token)
        if token == req.eos_token_id or len(req.generated) >= req.max_new_tokens:
            req.done = True
            self.slot_req[slot] = None
            self.key_valid[slot, :] = False
            self.seq_pos[slot] = 0

    def _active_tokens(self):
        active = [s for s in range(self.max_batch) if self.slot_req[s] is not None]
        tok = np.zeros(self.max_batch, np.int64)
        for s in active:
            tok[s] = self.slot_req[s].generated[-1]
        return active, tok

    @torch.no_grad()
    def step(self) -> list[Request]:
        """Admit queued requests, run one decode step, return finished."""
        self._admit()
        active, tok = self._active_tokens()
        if not active:
            return []
        for s in active:
            assert self.pool_pos[s] < self.max_len, "active slot past the cache"
            self.key_valid[s, self.pool_pos[s]] = True
        next_tok = self._decode(self._to_dev(tok), self._to_dev(self.seq_pos),
                                self._to_dev(self.key_valid))
        self._steps += 1
        next_np = next_tok.cpu().numpy()
        self.pool_pos += 1
        finished = []
        for s in active:
            self.seq_pos[s] += 1
            req = self.slot_req[s]
            self._emit(s, int(next_np[s]))
            if req.done:
                finished.append(req)
        return finished

    @torch.no_grad()
    def step_chunk(self, k: int) -> list[Request]:
        """Admit, then decode k tokens with the argmax on the device and one
        host fetch; emits what k calls of step() would under greedy."""
        if k == 1:
            return self.step()
        self._admit()
        active, tok = self._active_tokens()
        if not active:
            return []
        tok_d = self._to_dev(tok)
        positions = self._to_dev(self.seq_pos)
        key_valid = self._to_dev(self.key_valid)
        cols = torch.arange(self.max_len, device=self.device)[None, :]
        toks = []
        for _ in range(k):
            # the incoming token's pool row becomes valid for every slot; a
            # dead slot's row past the cache simply matches no column
            key_valid |= cols == self._pool_positions()[:, None]
            tok_d = self._decode(tok_d, positions, key_valid)
            toks.append(tok_d)
            positions = positions + 1
        self._steps += k
        toks = torch.stack(toks).cpu().numpy()          # (k, B)
        for s in range(self.max_batch):
            lo = min(int(self.pool_pos[s]), self.max_len)
            hi = min(lo + k, self.max_len)
            self.key_valid[s, lo:hi] = True
        self.pool_pos += k
        for s in active:
            self.seq_pos[s] += k
        finished = []
        for s in active:
            req = self.slot_req[s]
            for t in range(k):
                self._emit(s, int(toks[t, s]))
                if req.done:
                    finished.append(req)
                    break
        return finished

    def run_to_completion(self, max_steps: int = 10_000,
                          chunk: int = 1) -> list[Request]:
        done = []
        for _ in range(max_steps):
            done.extend(self.step_chunk(chunk) if chunk > 1 else self.step())
            if not self.queue and all(r is None for r in self.slot_req):
                break
        return done
