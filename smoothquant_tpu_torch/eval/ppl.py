"""WikiText-2-style perplexity (port of smoothquant_tpu/eval/ppl.py; the
reference's ppl_eval.py:32-62).

The token stream is cut into contiguous windows of `window` tokens; a
window's NLL is the mean shifted cross-entropy over its window − 1
positions TIMES `window`, and PPL = exp(Σ nll / (n_windows · window)).  The
window-not-window−1 multiplier is the reference's, kept so the numbers
compare with the published ones.

The model is logits_fn(input_ids (1, S) int64) → (1, S, V) logits; each
window is uploaded to the evaluator's device ("cuda" unless the caller
asks for the CPU) and run under torch.no_grad.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from smoothquant_tpu_torch._device import resolve_device


def window_nll(logits: torch.Tensor, targets: torch.Tensor, window: int) -> torch.Tensor:
    """Shifted cross-entropy of one window: the mean over S − 1 positions ×
    window, in float32 (ppl.py:23-29)."""
    logprobs = torch.log_softmax(logits[:, :-1, :].float(), dim=-1)
    nll = -logprobs.gather(-1, targets[:, 1:, None].to(torch.int64))[..., 0]
    return nll.mean() * window


class Evaluator:
    """Strided-window perplexity evaluator (ppl.py:32-74).

    tokens: the 1-D pre-tokenized stream; n_samples: number of windows
    (None → the whole stream, len // window); device: where each window's
    ids are uploaded, resolved here (raises when CUDA is asked for and
    absent)."""

    def __init__(self, tokens: np.ndarray, n_samples: Optional[int] = None,
                 window: int = 2048, device="cuda"):
        self.tokens = np.asarray(tokens).reshape(-1)
        self.window = window
        self.n_samples = n_samples
        self.device = resolve_device(device)

    def evaluate(self, logits_fn: Callable[[torch.Tensor], torch.Tensor],
                 verbose: bool = False) -> float:
        window = self.window
        n = self.n_samples or (self.tokens.shape[0] // window)
        if n * window > self.tokens.shape[0]:
            raise ValueError(
                f"need {n * window} tokens for {n} windows, have {self.tokens.shape[0]}")
        nlls = []
        with torch.no_grad():
            for i in range(n):
                ids = torch.as_tensor(
                    self.tokens[i * window:(i + 1) * window][None, :].astype(np.int64),
                    device=self.device)
                nlls.append(float(window_nll(logits_fn(ids), ids, window)))
                if verbose:
                    running = float(np.exp(np.sum(nlls) / ((i + 1) * window)))
                    print(f"  window {i + 1}/{n}  running ppl={running:.4f}", flush=True)
        return float(np.exp(np.sum(nlls) / (n * window)))
