"""Perplexity evaluation (port of smoothquant_tpu/cli/ppl_eval.py; the
reference's smoothquant/ppl_eval.py).

The reference's flags (ppl_eval.py:12-25: --alpha --model_path
--act_scales_path --n_samples --smooth --quantize) and the JAX CLI's
extended quantization knobs, among them the tri-state
--quantize_bmm_input with its per-arch default.  With --json the one JSON
line also carries the seconds of each stage (load, smooth, calibrate,
quantize, evaluate) on the card's clock.

Offline usage (no dataset download):
  python -m smoothquant_tpu_torch.cli.ppl_eval --model_path /ckpts/opt-125m \\
      --tokens_path wikitext2_test.npy --smooth --act_scales_path s.npz --quantize
"""

from __future__ import annotations

import argparse
import functools
import json

from smoothquant_tpu_torch.cli.common import add_device_arg


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--alpha", type=float, default=0.5)
    p.add_argument("--model_path", type=str, required=True)
    p.add_argument("--act_scales_path", type=str, default=None)
    p.add_argument("--n_samples", type=int, default=None)
    p.add_argument("--smooth", action="store_true")
    p.add_argument("--quantize", action="store_true")
    # extended knobs (the reference hard-codes these at ppl_eval.py:76-82)
    p.add_argument("--weight_quant", default="per_channel")
    p.add_argument("--act_quant", default="per_token")
    p.add_argument("--quant_bits", type=int, default=4)
    p.add_argument("--group_size", type=int, default=128)
    p.add_argument("--salient_prop", type=float, default=0.0)
    p.add_argument("--sort_strategy", choices=["max", "mean_std", "argmax"],
                   default="max",
                   help="sorted-group channel ranking (README.md:34-37)")
    p.add_argument("--saliency_metric", choices=["act", "weight"], default="act",
                   help="'act' = calibrated mean-abs activations (reference "
                        "run_experiments path); 'weight' = per-channel mean "
                        "|w| (salient_weights_analysis.py intent, no "
                        "calibration needed)")
    p.add_argument("--quantize_bmm_input", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="quantize q/k/v projection outputs (simulated int8 "
                        "attention BMM inputs). Default follows the "
                        "reference's per-arch signature defaults: True for "
                        "OPT/Falcon/Bloom, False for Llama/Mistral/Mixtral "
                        "(fake_quant.py:381,468,568,675)")
    p.add_argument("--calib_samples", type=int, default=32)
    p.add_argument("--calib_seq_len", type=int, default=512)
    p.add_argument("--window", type=int, default=2048)
    p.add_argument("--dtype", default=None)
    p.add_argument("--tokens_path", type=str, default=None)
    p.add_argument("--dataset_path", type=str, default=None)
    p.add_argument("--tokenizer_path", type=str, default=None)
    p.add_argument("--json", action="store_true", help="print result as JSON")
    add_device_arg(p)
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    from smoothquant_tpu_torch.cli.common import (
        Stopwatch,
        calib_batches,
        forward_fn,
        load_token_stream,
    )
    from smoothquant_tpu_torch.eval import Evaluator
    from smoothquant_tpu_torch.models.registry import get_arch, quantize_model, smooth_lm
    from smoothquant_tpu_torch.quant import QuantConfig
    from smoothquant_tpu_torch.quant.calibrate import get_calib_feat
    from smoothquant_tpu_torch.quant.saliency import weight_magnitude_importance
    from smoothquant_tpu_torch.quant.smooth import _get_path
    from smoothquant_tpu_torch.utils.hf_import import load_act_scales, load_model

    clock = Stopwatch(args.device)
    arch, cfg, params = load_model(args.model_path, dtype=args.dtype, device=args.device)
    tokens = load_token_stream(args)
    evaluator = Evaluator(tokens, n_samples=args.n_samples, window=args.window,
                          device=args.device)
    clock.lap("load")

    if args.smooth:
        if not args.act_scales_path:
            raise SystemExit("--smooth requires --act_scales_path")
        scales = load_act_scales(args.act_scales_path)
        params = smooth_lm(arch, params, cfg, scales, args.alpha)
    clock.lap("smooth")

    qcfg = None
    if args.quantize:
        if args.quantize_bmm_input is None:
            # the reference's per-arch defaults (fake_quant.py:381,468,568,675)
            args.quantize_bmm_input = arch in ("opt", "falcon", "bloom")
        qcfg = QuantConfig(
            weight_quant=args.weight_quant, act_quant=args.act_quant,
            quantize_bmm_input=args.quantize_bmm_input,
            salient_prop=args.salient_prop, quant_bits=args.quant_bits,
            group_size=args.group_size, alpha=args.alpha,
            sort_strategy=args.sort_strategy,
        )
        input_feat = None
        if args.salient_prop > 0:
            if args.saliency_metric == "weight":
                input_feat = {
                    key: weight_magnitude_importance(_get_path(params, path)["weight"])
                    for path, key, _ in get_arch(arch).quantizable_linears(cfg)
                }
            else:
                _, tapped = forward_fn(arch, cfg)
                batches = calib_batches(tokens, args.calib_samples, args.calib_seq_len,
                                        device=args.device)
                input_feat = get_calib_feat(tapped, params, batches)
        clock.lap("calibrate")
        params = quantize_model(arch, params, cfg, qcfg, input_feat=input_feat)
    clock.lap("quantize")

    logits_fn, _ = forward_fn(arch, cfg, quant=qcfg)
    ppl = evaluator.evaluate(functools.partial(logits_fn, params), verbose=not args.json)
    clock.lap("evaluate")
    if args.json:
        print(json.dumps({"model": args.model_path, "arch": arch, "ppl": ppl,
                          "smooth": args.smooth, "quantize": args.quantize,
                          "alpha": args.alpha, "seconds": clock.seconds}))
    else:
        print(f"Perplexity: {ppl}")


if __name__ == "__main__":
    main()
