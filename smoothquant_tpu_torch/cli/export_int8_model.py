"""Real-INT8 OPT export (port of smoothquant_tpu/cli/export_int8_model.py;
the reference's examples/export_int8_model.py).

Pipeline (export_int8_model.py:16-56): load the fp OPT → smooth (α = 0.5)
→ static per-tensor scales → the int8 model → save, as an .npz both
packages load (utils/checkpoint.save_int8_opt).  --dtype is the weights'
dtype for the whole pipeline: float32 as the JAX CLI fixes it, or the
checkpoint's bfloat16 (the export chip_smoke.py holds this CLI to).

  python -m smoothquant_tpu_torch.cli.export_int8_model \\
      --model_path /ckpts/opt-1.3b --tokens_path tokens.npy \\
      --act_scales_path act_scales.npz --output_path opt-1.3b-int8.npz
"""

from __future__ import annotations

import argparse
import json

from smoothquant_tpu_torch.cli.common import add_device_arg


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model_path", type=str, required=True)
    p.add_argument("--output_path", type=str, required=True, help=".npz")
    p.add_argument("--act_scales_path", type=str, default=None)
    p.add_argument("--alpha", type=float, default=0.5)
    p.add_argument("--num_samples", type=int, default=512)
    p.add_argument("--seq_len", type=int, default=512)
    p.add_argument("--no_smooth", action="store_true")
    p.add_argument("--export_smoothed", action="store_true",
                   help="instead of the int8 model, save the smoothed FP "
                        "params + raw per-layer scales (the reference's "
                        "--export-FT FasterTransformer path, "
                        "export_int8_model.py:45-53)")
    p.add_argument("--dtype", default="float32",
                   help="the weights' dtype through the export (the JAX CLI "
                        "fixes float32)")
    p.add_argument("--tokens_path", type=str, default=None)
    p.add_argument("--dataset_path", type=str, default=None)
    p.add_argument("--tokenizer_path", type=str, default=None)
    add_device_arg(p)
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    from smoothquant_tpu_torch.cli.common import calib_batches, forward_fn, load_token_stream
    from smoothquant_tpu_torch.models import opt_int8
    from smoothquant_tpu_torch.models.registry import smooth_lm
    from smoothquant_tpu_torch.quant.calibrate import (
        get_act_scales,
        get_static_act_dict,
        get_static_decoder_layer_scales_opt,
    )
    from smoothquant_tpu_torch.utils.checkpoint import save_int8_opt, save_params
    from smoothquant_tpu_torch.utils.hf_import import load_act_scales, load_model

    arch, cfg, params = load_model(args.model_path, dtype=args.dtype, device=args.device)
    if arch != "opt":
        raise SystemExit(f"int8 export supports OPT only (got {arch})")
    tokens = load_token_stream(args)
    batches = calib_batches(tokens, args.num_samples, args.seq_len, device=args.device)
    _, tapped = forward_fn(arch, cfg)

    if not args.no_smooth:
        if args.act_scales_path:
            scales = load_act_scales(args.act_scales_path)
        else:
            scales = get_act_scales(tapped, params, batches)
        params = smooth_lm(arch, params, cfg, scales, args.alpha)

    act_dict = get_static_act_dict(tapped, params, batches)
    layer_scales = get_static_decoder_layer_scales_opt(act_dict, cfg.num_hidden_layers)
    if args.export_smoothed:
        save_params(params, args.output_path)
        scales_path = args.output_path.replace(".npz", "") + ".layer_scales.json"
        with open(scales_path, "w") as f:
            json.dump(layer_scales, f, indent=2)
        print(f"saved smoothed FP params to {args.output_path} "
              f"+ raw scales to {scales_path}")
    else:
        int8_params = opt_int8.from_float(params, cfg, layer_scales)
        save_int8_opt(int8_params, cfg, args.output_path)
        print(f"saved INT8 OPT model to {args.output_path}")


if __name__ == "__main__":
    main()
