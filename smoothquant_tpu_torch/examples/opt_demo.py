"""OPT W4A4 MixedQuant demo, the smoothquant_opt_demo.ipynb equivalent
(port of examples/opt_demo.py).

The whole pipeline on a local OPT checkpoint, or on a tiny random model
with --random: calibrate → smooth → W4A4 group quantization with salient
mixed precision → perplexity, the naive W4A4 blow-up (the reference
notebook's PPL 32997 observation) beside the mitigated recipe.

Usage:
  python -m smoothquant_tpu_torch.examples.opt_demo --random [--device cpu]
  python -m smoothquant_tpu_torch.examples.opt_demo --model_path /ckpts/opt-1.3b \\
      --tokens_path wikitext2_test.npy
"""

from __future__ import annotations

import argparse
import functools

import numpy as np


def main(argv=None) -> dict:
    """Runs the demo; returns the three perplexities (fp, naive, mitigated)."""
    import torch

    from smoothquant_tpu_torch._device import resolve_device
    from smoothquant_tpu_torch.cli.common import add_device_arg, forward_fn
    from smoothquant_tpu_torch.eval import Evaluator
    from smoothquant_tpu_torch.models import opt
    from smoothquant_tpu_torch.models.registry import quantize_model, smooth_lm
    from smoothquant_tpu_torch.quant import w4a4_group
    from smoothquant_tpu_torch.quant.calibrate import get_act_scales, get_calib_feat

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model_path", type=str, default=None)
    p.add_argument("--tokens_path", type=str, default=None)
    p.add_argument("--random", action="store_true",
                   help="tiny random model + synthetic tokens (no files needed)")
    p.add_argument("--group_size", type=int, default=128)
    p.add_argument("--salient_prop", type=float, default=0.05)
    p.add_argument("--alpha", type=float, default=0.5)
    p.add_argument("--n_samples", type=int, default=4)
    p.add_argument("--window", type=int, default=128)
    add_device_arg(p)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    if args.random:
        cfg = opt.OPTConfig.tiny()
        params = opt.init_params(torch.Generator(device=dev).manual_seed(0), cfg, dev)
        arch = "opt"
        tokens = np.random.default_rng(0).integers(
            0, cfg.vocab_size, size=(args.window * (args.n_samples + 1),)).astype(np.int32)
    else:
        if args.model_path is None:
            raise SystemExit("need --random or --model_path")
        from smoothquant_tpu_torch.cli.common import load_token_stream
        from smoothquant_tpu_torch.utils.hf_import import load_model

        arch, cfg, params = load_model(args.model_path, device=dev)
        tokens = load_token_stream(args)

    if args.window > cfg.max_position_embeddings:
        raise SystemExit(f"--window {args.window} exceeds model max positions "
                         f"{cfg.max_position_embeddings}")
    logits_fn, tapped = forward_fn(arch, cfg)
    ev = Evaluator(tokens, n_samples=args.n_samples, window=args.window, device=dev)
    calib_len = min(128, cfg.max_position_embeddings)
    n_calib = min(8, len(tokens) // calib_len)
    batches = [torch.as_tensor(tokens[i * calib_len:(i + 1) * calib_len][None].astype(np.int64),
                               device=dev) for i in range(n_calib)]

    print(f"== calibrating (absmax scales + salience importance) on {dev} ==")
    scales = get_act_scales(tapped, params, batches)
    feat = get_calib_feat(tapped, params, batches)

    ppl_fp = ev.evaluate(functools.partial(logits_fn, params))
    print(f"FP baseline PPL: {ppl_fp:.4f}")

    naive = w4a4_group(group_size=args.group_size)
    q_naive = quantize_model(arch, params, cfg, naive)
    ln, _ = forward_fn(arch, cfg, quant=naive)
    ppl_naive = ev.evaluate(functools.partial(ln, q_naive))
    print(f"naive W4A4 g{args.group_size} PPL: {ppl_naive:.4f}  "
          f"(reference saw 32997 on OPT-1.3B — smoothquant_opt_demo.ipynb)")

    smoothed = smooth_lm(arch, params, cfg, scales, alpha=args.alpha)
    mitigated = w4a4_group(group_size=args.group_size, salient_prop=args.salient_prop)
    q_mit = quantize_model(arch, smoothed, cfg, mitigated, input_feat=feat)
    lm, _ = forward_fn(arch, cfg, quant=mitigated)
    ppl_mit = ev.evaluate(functools.partial(lm, q_mit))
    print(f"smoothed + {args.salient_prop:.0%}-salient W4A4 PPL: {ppl_mit:.4f}")
    return {"fp": ppl_fp, "naive_w4a4": ppl_naive, "mitigated_w4a4": ppl_mit}


if __name__ == "__main__":
    main()
