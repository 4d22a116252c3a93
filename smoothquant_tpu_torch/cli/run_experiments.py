"""The flagship sweep (port of smoothquant_tpu/cli/run_experiments.py; the
reference's run_experiments/run_experiments.py).

For each (salient_prop × group_size) cell: a fresh W4A4 sorted-group
quantization with calibrated salience, WikiText-2-style perplexity and the
analytic model size; results.json as the JAX CLI writes it, and with
--plots (matplotlib imported only then) the two sweep plots.

  python -m smoothquant_tpu_torch.cli.run_experiments --model_path \\
      /ckpts/Llama-2-7b-hf --tokens_path wikitext2_test.npy --output_dir figures
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os

from smoothquant_tpu_torch.cli.common import add_device_arg


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model_path", type=str, required=True)
    p.add_argument("--group_sizes", type=int, nargs="+",
                   default=[4, 8, 16, 32, 64, 128, 256])
    p.add_argument("--salient_props", type=float, nargs="+",
                   default=[0.0, 0.01, 0.05, 0.1])
    p.add_argument("--quant_bits", type=int, default=4)
    p.add_argument("--sort", choices=["max", "mean_std", "argmax", "none"],
                   default="max",
                   help="group-quant channel ordering: 'max' = absmax-sorted "
                        "(reference default), 'mean_std' = mean+3·std, "
                        "'argmax' = position-of-absmax (README.md:34-37 "
                        "strategies), 'none' = unsorted — the README.md:55 "
                        "ablation")
    p.add_argument("--n_samples", type=int, default=40)
    p.add_argument("--window", type=int, default=2048)
    p.add_argument("--calib_samples", type=int, default=256)
    p.add_argument("--calib_seq_len", type=int, default=512)
    p.add_argument("--output_dir", type=str, default="figures")
    p.add_argument("--plots", action="store_true")
    p.add_argument("--dtype", default=None)
    p.add_argument("--tokens_path", type=str, default=None)
    p.add_argument("--calib_tokens_path", type=str, default=None,
                   help="separate calibration stream (reference uses wikitext VALIDATION)")
    p.add_argument("--dataset_path", type=str, default=None)
    p.add_argument("--tokenizer_path", type=str, default=None)
    add_device_arg(p)
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    import numpy as np

    from smoothquant_tpu_torch.cli.common import calib_batches, forward_fn, load_token_stream
    from smoothquant_tpu_torch.eval import Evaluator, bits_to_mib, count_params, get_model_size_bits
    from smoothquant_tpu_torch.models.registry import quantize_model
    from smoothquant_tpu_torch.quant import w4a4_group
    from smoothquant_tpu_torch.quant.calibrate import get_calib_feat
    from smoothquant_tpu_torch.utils.hf_import import load_model

    if args.plots:
        _matplotlib()      # refuse before the sweep, not after it
    arch, cfg, params = load_model(args.model_path, dtype=args.dtype, device=args.device)
    tokens = load_token_stream(args)
    calib_tokens = (np.load(args.calib_tokens_path).reshape(-1).astype(np.int32)
                    if args.calib_tokens_path else tokens)
    evaluator = Evaluator(tokens, n_samples=args.n_samples, window=args.window,
                          device=args.device)
    n_params = count_params(params)

    # calibrated importance once (the reference recalibrates each cell on
    # the same data: the same result)
    _, tapped = forward_fn(arch, cfg)
    batches = calib_batches(calib_tokens, args.calib_samples, args.calib_seq_len,
                            device=args.device)
    input_feat = get_calib_feat(tapped, params, batches)

    os.makedirs(args.output_dir, exist_ok=True)
    results = []
    for sp in args.salient_props:
        for g in args.group_sizes:
            # the reference sweep calls quantize_opt / llama_like with their
            # signature defaults for quantize_bmm_input: True for OPT-like
            # archs, False for llama-like (fake_quant.py:381,468)
            overrides = {"quant_bits": args.quant_bits,
                         "quantize_bmm_input": arch in ("opt", "falcon", "bloom")}
            if args.sort == "none":
                overrides.update(weight_quant="per_group_unsorted",
                                 act_quant="per_group_unsorted")
            else:
                overrides.update(sort_strategy=args.sort)
            qcfg = dataclasses.replace(w4a4_group(group_size=g, salient_prop=sp), **overrides)
            qparams = quantize_model(arch, params, cfg, qcfg,
                                     input_feat=input_feat if sp > 0 else None)
            logits_fn, _ = forward_fn(arch, cfg, quant=qcfg)
            ppl = evaluator.evaluate(functools.partial(logits_fn, qparams))
            del qparams
            size_mib = bits_to_mib(get_model_size_bits(n_params, args.quant_bits, sp, g))
            row = {"salient_prop": sp, "group_size": g, "ppl": ppl, "size_mib": size_mib}
            results.append(row)
            print(json.dumps(row), flush=True)

    out_json = os.path.join(args.output_dir, "results.json")
    with open(out_json, "w") as f:
        json.dump({"model": args.model_path, "arch": arch,
                   "quant_bits": args.quant_bits, "results": results}, f, indent=2)
    print(f"wrote {out_json}")

    if args.plots:
        _plot(results, args.output_dir)


def _matplotlib():
    try:
        import matplotlib
    except ImportError:
        raise SystemExit("--plots needs the 'matplotlib' package, which is not "
                         "installed; results.json holds the sweep") from None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _plot(results, output_dir: str) -> None:
    """PPL-vs-group-size and PPL-vs-size plots (run_experiments.py:192-253)."""
    plt = _matplotlib()
    props = sorted({r["salient_prop"] for r in results})
    fig, ax = plt.subplots(1, 2, figsize=(12, 5))
    for sp in props:
        rows = sorted((r for r in results if r["salient_prop"] == sp),
                      key=lambda r: r["group_size"])
        ax[0].plot([r["group_size"] for r in rows], [r["ppl"] for r in rows],
                   marker="o", label=f"salient={sp:g}")
        ax[1].plot([r["size_mib"] for r in rows], [r["ppl"] for r in rows],
                   marker="o", label=f"salient={sp:g}")
    ax[0].set_xscale("log", base=2)
    ax[0].set_xlabel("group size")
    ax[0].set_ylabel("perplexity")
    ax[1].set_xlabel("model size (MiB)")
    ax[1].set_ylabel("perplexity")
    for a in ax:
        a.set_yscale("log")
        a.legend()
        a.grid(True, alpha=0.3)
    fig.tight_layout()
    path = f"{output_dir}/ppl_sweep.png"
    fig.savefig(path, dpi=120)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
