"""Calibration-artifact producer (port of
smoothquant_tpu/cli/generate_act_scales.py; the reference's
examples/generate_act_scales.py).

Runs the tapped calibration pass over a local HF model and a token stream
and saves per-channel activation absmax scales (the --smooth input), in
the reference's torch .pt format or .npz.

  python -m smoothquant_tpu_torch.cli.generate_act_scales \\
      --model_path /ckpts/opt-1.3b --tokens_path tokens.npy \\
      --output_path act_scales.npz
"""

from __future__ import annotations

import argparse

from smoothquant_tpu_torch.cli.common import add_device_arg


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model_path", type=str, required=True)
    p.add_argument("--output_path", type=str, required=True,
                   help=".pt (torch, reference-compatible) or .npz")
    p.add_argument("--num_samples", type=int, default=512)
    p.add_argument("--seq_len", type=int, default=512)
    p.add_argument("--dtype", default=None)
    p.add_argument("--tokens_path", type=str, default=None)
    p.add_argument("--dataset_path", type=str, default=None)
    p.add_argument("--tokenizer_path", type=str, default=None)
    add_device_arg(p)
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    from smoothquant_tpu_torch.cli.common import calib_batches, forward_fn, load_token_stream
    from smoothquant_tpu_torch.quant.calibrate import get_act_scales
    from smoothquant_tpu_torch.utils.hf_import import load_model, save_act_scales

    arch, cfg, params = load_model(args.model_path, dtype=args.dtype, device=args.device)
    tokens = load_token_stream(args)
    _, tapped = forward_fn(arch, cfg)
    batches = calib_batches(tokens, args.num_samples, args.seq_len, device=args.device)
    if not batches:
        raise SystemExit("token stream too short for requested samples")
    scales = get_act_scales(tapped, params, batches)
    save_act_scales(scales, args.output_path)
    print(f"saved {len(scales)} activation scales to {args.output_path}")


if __name__ == "__main__":
    main()
