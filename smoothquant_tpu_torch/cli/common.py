"""Shared CLI helpers (port of smoothquant_tpu/cli/common.py): token
streams, calibration batches on the device, model forward functions."""

from __future__ import annotations

import importlib
import time

import numpy as np
import torch

from smoothquant_tpu_torch._device import resolve_device


def add_device_arg(p) -> None:
    p.add_argument("--device", default="cuda",
                   help="where the model runs: cuda (default) or cpu")


def _require(name: str):
    try:
        return importlib.import_module(name)
    except ImportError:
        raise SystemExit(f"--dataset_path needs the {name!r} package, which is not "
                         f"installed; pass a pre-tokenized --tokens_path instead") from None


def load_token_stream(args) -> np.ndarray:
    """The evaluation token stream: --tokens_path (a pre-tokenized .npy) else
    --dataset_path + --tokenizer_path (WikiText-2-style text rows joined with
    "\\n\\n" and tokenized once, ppl_eval.py:38-40), whose packages
    (datasets, transformers) are imported only then."""
    if getattr(args, "tokens_path", None):
        return np.load(args.tokens_path).reshape(-1).astype(np.int32)
    if getattr(args, "dataset_path", None):
        datasets = _require("datasets")
        transformers = _require("transformers")
        tok = transformers.AutoTokenizer.from_pretrained(args.tokenizer_path or args.model_path)
        ds = datasets.load_dataset("json", data_files=args.dataset_path, split="train")
        text = "\n\n".join(r["text"] for r in ds)
        return np.asarray(tok(text).input_ids, np.int32)
    raise SystemExit("need --tokens_path or --dataset_path")


def forward_fn(arch: str, cfg, quant=None):
    """logits_fn(params, ids) and tapped_fn(params, ids, collector) of an
    architecture, on the port's ForwardContext."""
    from smoothquant_tpu_torch.models.common import ForwardContext
    from smoothquant_tpu_torch.models.registry import get_arch

    mod = get_arch(arch)

    def logits_fn(params, ids):
        ctx = ForwardContext(quant=quant) if quant else None
        return mod.forward(params, ids, cfg, ctx=ctx)[0]

    def tapped_fn(params, ids, collector):
        mod.forward(params, ids, cfg, ctx=ForwardContext(taps=collector))

    return logits_fn, tapped_fn


def calib_batches(tokens: np.ndarray, num_samples: int, seq_len: int,
                  device="cuda") -> list:
    """(1, seq_len) int64 calibration batches on `device`."""
    from smoothquant_tpu_torch.quant.calibrate import make_calib_batches

    dev = resolve_device(device)
    return [torch.as_tensor(b.astype(np.int64), device=dev)
            for b in make_calib_batches(tokens, num_samples, seq_len)]


class Stopwatch:
    """Seconds of named stages on `device`'s clock: each lap waits for the
    card's queue first."""

    def __init__(self, device):
        self.device = resolve_device(device)
        self.seconds: dict = {}
        self._t = time.perf_counter()

    def lap(self, name: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.seconds[name] = self.seconds.get(name, 0.0) + now - self._t
        self._t = now
