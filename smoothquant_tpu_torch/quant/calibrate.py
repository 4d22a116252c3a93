"""Calibration: activation statistics from a tapped forward (port of
smoothquant_tpu/quant/calibrate.py).

A forward run with ForwardContext(taps=collector) reports every linear's
input and output through `tap_input` / `tap_output`; the collector reduces
them ON THE DEVICE to per-channel or scalar statistics.  The functions below run
one forward per batch under torch.no_grad(), bring that batch's statistics
to the host in one transfer, and accumulate there:

  * per-channel absmax of linear inputs   → smoothing scales (get_act_scales)
  * per-channel mean |x| of linear inputs → salience (get_calib_feat)
  * per-tensor absmax of inputs, outputs  → static INT8 scales
    (get_static_act_dict, get_static_decoder_layer_scales_opt)
"""

from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch


class TapCollector:
    """Reduced activation statistics of one forward: mode "absmax"
    (per-channel absmax of inputs), "mean_abs" (per-channel mean |x| of
    inputs) or "static" (scalar absmax of inputs and outputs)."""

    def __init__(self, mode: str = "absmax"):
        if mode not in ("absmax", "mean_abs", "static"):
            raise ValueError(f"unknown tap mode {mode!r}")
        self.mode = mode
        self.stats: dict = {}

    def tap_input(self, name: str, x: torch.Tensor) -> None:
        x2d = x.reshape(-1, x.shape[-1]).float().abs()
        if self.mode == "absmax":
            self.stats[name] = x2d.amax(dim=0)
        elif self.mode == "mean_abs":
            self.stats[name] = x2d.mean(dim=0)
        else:
            self.stats.setdefault(name, {})["input"] = x2d.amax()

    def tap_output(self, name: str, y: torch.Tensor) -> None:
        if self.mode == "static":
            self.stats.setdefault(name, {})["output"] = y.float().abs().amax()


def _to_host(stats: dict) -> dict:
    """The collector's tensors as numpy arrays, in one device→host copy."""
    leaves = []

    def walk(node):
        if isinstance(node, dict):
            for v in node.values():
                walk(v)
        else:
            leaves.append(node)

    walk(stats)
    if not leaves:
        return {}
    flat = torch.cat([t.reshape(-1) for t in leaves]).cpu().numpy()
    it = iter(np.split(flat, np.cumsum([t.numel() for t in leaves])[:-1]))

    def rebuild(node):
        if isinstance(node, dict):
            return {k: rebuild(v) for k, v in node.items()}
        return next(it).reshape(tuple(node.shape))

    return rebuild(stats)


def _run_batches(forward: Callable, params, batches: Iterable, mode: str):
    """Yield each batch's statistics (numpy).  forward(params, input_ids,
    collector) routes the collector into the model."""
    for input_ids in batches:
        col = TapCollector(mode)
        with torch.no_grad():
            forward(params, input_ids, col)
        yield _to_host(col.stats)


def get_act_scales(forward, params, batches) -> dict:
    """Per-channel absmax of every linear's input, the running max over
    batches (calibrate.py:79-88): {name: float32 (C,)}."""
    acc: dict = {}
    for stats in _run_batches(forward, params, batches, "absmax"):
        for name, v in stats.items():
            acc[name] = np.maximum(acc[name], v) if name in acc else v
    return acc


def get_calib_feat(forward, params, batches) -> dict:
    """Per-channel mean |x| of every linear's input, summed over batches
    (calibrate.py:91-103): {name: float64 (C,)}."""
    acc: dict = {}
    for stats in _run_batches(forward, params, batches, "mean_abs"):
        for name, v in stats.items():
            v = v.astype(np.float64)
            acc[name] = acc[name] + v if name in acc else v
    return acc


def get_static_act_dict(forward, params, batches) -> dict:
    """Running per-tensor absmax of each linear's input and output
    (calibrate.py:106-119): {name: {"input": float, "output": float}}."""
    acc: dict = {}
    for stats in _run_batches(forward, params, batches, "static"):
        for name, io in stats.items():
            slot = acc.setdefault(name, {})
            for k, v in io.items():
                slot[k] = max(slot.get(k, 0.0), float(v))
    return acc


def get_static_decoder_layer_scales_opt(act_dict: dict, num_layers: int) -> list[dict]:
    """The seven static scales of each OPT decoder layer, each a running
    per-tensor absmax over 127, as Python floats (calibrate.py:122-142)."""
    out = []
    for idx in range(num_layers):
        p = f"model.decoder.layers.{idx}"
        out.append({
            "attn_input_scale": act_dict[f"{p}.self_attn.q_proj"]["input"] / 127,
            "q_output_scale": act_dict[f"{p}.self_attn.q_proj"]["output"] / 127,
            "k_output_scale": act_dict[f"{p}.self_attn.k_proj"]["output"] / 127,
            "v_output_scale": act_dict[f"{p}.self_attn.v_proj"]["output"] / 127,
            "out_input_scale": act_dict[f"{p}.self_attn.out_proj"]["input"] / 127,
            "fc1_input_scale": act_dict[f"{p}.fc1"]["input"] / 127,
            "fc2_input_scale": act_dict[f"{p}.fc2"]["input"] / 127,
        })
    return out


def make_calib_batches(token_stream: np.ndarray, num_samples: int,
                       seq_len: int) -> list[np.ndarray]:
    """Cut a 1-D token stream into (1, seq_len) blocks (calibrate.py:145-159)."""
    blocks = []
    for i in range(num_samples):
        lo, hi = i * seq_len, (i + 1) * seq_len
        if hi > token_stream.shape[0]:
            break
        blocks.append(token_stream[lo:hi][None, :])
    return blocks
