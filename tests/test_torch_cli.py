"""The port's four CLIs (smoothquant_tpu_torch.cli) against the JAX
package's on the same tiny HF directories and token stream, each run
in-process through main([..., "--device", "cpu"]): ppl_eval's perplexity
(fp, smoothed, W8 / W4 per-channel, W4A4 groups with calibrated or weight
salience, both BMM-input settings); generate_act_scales' scales within
rel 1e-5; export_int8_model's file loaded by the other package, int8 codes
differing in at most 1e-4 of the elements; run_experiments' results.json
rows; the tri-state flag; the lazy imports of the dataset and plot paths.

Perplexity is held within rel 1e-4 wherever the activations are quantized
per token or in unsorted groups (the readings: 0 to 7e-7).  Sorted per-group
activations sort the columns of each call's (N, C) view by a key taken
over all N rows, so a last-bit difference of one activation (OPT's f32
LayerNorm and sum orders differ from XLA's: its fp perplexities part at
7e-7) can swap two columns whose keys nearly tie, and every row's groups
change; those recipes read 6e-5 to 1.4e-4 apart and are held within rel
1e-3 (a wrong quantizer moves perplexity by its whole effect)."""

import json
import os

import numpy as np
import pytest
import torch

pytest.importorskip("transformers")
pytest.importorskip("safetensors")

import jax  # noqa: E402,F401

from torch_io_helpers import write_hf_dir  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    return {f: write_hf_dir(str(root / f), f) for f in ("opt", "llama")}


@pytest.fixture(scope="module")
def tokens_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tokens") / "tokens.npy")
    np.save(path, np.random.default_rng(0).integers(0, 128, size=(4096,)).astype(np.int32))
    return path


def _json_line(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def _both(name, argv, capsys):
    """(port's JSON, JAX's JSON) of CLI `name` run on argv."""
    import importlib

    port = importlib.import_module(f"smoothquant_tpu_torch.cli.{name}")
    jax_cli = importlib.import_module(f"smoothquant_tpu.cli.{name}")
    port.main(argv + ["--device", "cpu"])
    got = _json_line(capsys.readouterr().out)
    jax_cli.main(argv)
    ref = _json_line(capsys.readouterr().out)
    return got, ref


@pytest.fixture(scope="module")
def act_scales(dirs, tokens_file, tmp_path_factory):
    from smoothquant_tpu.cli.generate_act_scales import main

    out = {}
    for f, d in dirs.items():
        path = str(tmp_path_factory.mktemp("scales") / f"{f}.npz")
        main(["--model_path", d, "--tokens_path", tokens_file, "--output_path", path,
              "--num_samples", "2", "--seq_len", "64", "--dtype", "float32"])
        out[f] = path
    return out


SORTED_ACT_TOL, PPL_TOL = 1e-3, 1e-4

PPL_CASES = {
    "fp": [],
    "w8": ["--quantize", "--quant_bits", "8"],
    "w4_per_channel_no_bmm": ["--quantize", "--no-quantize_bmm_input"],
    "w4a4_g16_act_salience": ["--quantize", "--weight_quant", "per_group", "--act_quant",
                              "per_group", "--group_size", "16", "--salient_prop", "0.1",
                              "--calib_samples", "2", "--calib_seq_len", "64"],
    "w4_g16_per_token_unsorted": ["--quantize", "--weight_quant", "per_group_unsorted",
                                  "--act_quant", "per_token", "--group_size", "16"],
    "w4a4_g16_unsorted": ["--quantize", "--weight_quant", "per_group_unsorted",
                          "--act_quant", "per_group_unsorted", "--group_size", "16"],
    "w4a4_g16_weight_salience": ["--quantize", "--weight_quant", "per_group",
                                 "--act_quant", "per_group", "--group_size", "16",
                                 "--salient_prop", "0.1", "--saliency_metric", "weight",
                                 "--sort_strategy", "mean_std", "--quantize_bmm_input"],
    "smooth_w8": ["--smooth", "--quantize", "--quant_bits", "8"],
}


@pytest.mark.parametrize("family", ["opt", "llama"])
@pytest.mark.parametrize("case", sorted(PPL_CASES))
def test_ppl_eval_matches_jax(dirs, tokens_file, act_scales, capsys, family, case):
    argv = ["--model_path", dirs[family], "--tokens_path", tokens_file, "--n_samples", "2",
            "--window", "64", "--dtype", "float32", "--json", *PPL_CASES[case]]
    if "--smooth" in argv:
        argv += ["--act_scales_path", act_scales[family]]
    got, ref = _both("ppl_eval", argv, capsys)
    assert {k: got[k] for k in ref if k != "ppl"} == {k: ref[k] for k in ref if k != "ppl"}
    assert np.isfinite(got["ppl"])
    act = argv[argv.index("--act_quant") + 1] if "--act_quant" in argv else "per_token"
    tol = SORTED_ACT_TOL if act == "per_group" else PPL_TOL
    assert abs(got["ppl"] - ref["ppl"]) <= tol * ref["ppl"], (got["ppl"], ref["ppl"])
    assert {"load", "smooth", "quantize", "evaluate"} <= set(got["seconds"])


@pytest.mark.parametrize("family", ["opt", "llama"])
@pytest.mark.parametrize("ext", ["npz", "pt"])
def test_generate_act_scales_matches_jax(dirs, tokens_file, tmp_path, capsys, family, ext):
    from smoothquant_tpu.cli.generate_act_scales import main as jmain
    from smoothquant_tpu.utils.hf_import import load_act_scales as jload
    from smoothquant_tpu_torch.cli.generate_act_scales import main

    paths = {k: str(tmp_path / f"{k}.{ext}") for k in ("port", "jax")}
    argv = ["--model_path", dirs[family], "--tokens_path", tokens_file,
            "--num_samples", "3", "--seq_len", "64", "--dtype", "float32"]
    main(argv + ["--output_path", paths["port"], "--device", "cpu"])
    jmain(argv + ["--output_path", paths["jax"]])
    assert "activation scales" in capsys.readouterr().out
    got, ref = jload(paths["port"]), jload(paths["jax"])
    assert sorted(got) == sorted(ref) and len(ref) > 0
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=0)


def _int8_codes(tree, jax_side):
    out = {}
    for i, lp in enumerate(tree["int8_layers"]):
        for p in ("q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2"):
            out[f"{i}.{p}"] = np.asarray(getattr(lp, p).w_q if jax_side
                                         else getattr(lp, p).w_q.numpy())
    return out


def test_export_int8_files_cross(dirs, tokens_file, tmp_path, act_scales, capsys):
    """Each package's export loads in the other; the int8 codes of the two
    exports differ in at most 1e-4 of the elements and by one code, the
    scales within rel 1e-5; the loaded models run."""
    import jax.numpy as jnp

    from smoothquant_tpu.cli.export_int8_model import main as jmain
    from smoothquant_tpu.models import opt_int8 as jint8
    from smoothquant_tpu.utils import checkpoint as jck
    from smoothquant_tpu_torch.cli.export_int8_model import main
    from smoothquant_tpu_torch.models import opt_int8 as tint8
    from smoothquant_tpu_torch.utils import checkpoint as tck

    paths = {k: str(tmp_path / f"{k}.npz") for k in ("port", "jax")}
    argv = ["--model_path", dirs["opt"], "--tokens_path", tokens_file,
            "--num_samples", "2", "--seq_len", "64"]
    main(argv + ["--output_path", paths["port"], "--device", "cpu"])
    jmain(argv + ["--output_path", paths["jax"]])
    assert capsys.readouterr().out.count("saved INT8 OPT model") == 2
    t_cfg, t_of_jax = tck.load_int8_opt(paths["jax"], device="cpu")
    j_cfg, j_of_port = jck.load_int8_opt(paths["port"])
    codes_t, codes_j = _int8_codes(t_of_jax, False), _int8_codes(j_of_port, True)
    diff = sum(int((codes_t[k].astype(np.int16) != codes_j[k]).sum()) for k in codes_t)
    n = sum(v.size for v in codes_t.values())
    assert diff <= 1e-4 * n, (diff, n)
    assert max(int(np.abs(codes_t[k].astype(np.int16) - codes_j[k]).max())
               for k in codes_t) <= 1
    for a, b in zip(t_of_jax["int8_layers"], j_of_port["int8_layers"]):
        for k in a.scales:
            assert abs(a.scales[k] - b.scales[k]) <= 1e-5 * abs(b.scales[k]), k
    ids = np.random.default_rng(2).integers(0, 128, size=(1, 8))
    logits, _ = tint8.forward(t_of_jax, torch.from_numpy(ids), t_cfg)
    jlogits, _ = jint8.forward(j_of_port, jnp.asarray(ids), j_cfg, interpret=True)
    assert torch.isfinite(logits).all() and np.isfinite(np.asarray(jlogits)).all()


def test_export_smoothed_and_act_scales_path(dirs, tokens_file, tmp_path, act_scales,
                                             capsys):
    """--export_smoothed writes the smoothed fp params (JAX loads them, they
    equal JAX's within f32 rounding) and the raw per-layer scales."""
    from smoothquant_tpu.cli.export_int8_model import main as jmain
    from smoothquant_tpu.utils import checkpoint as jck
    from smoothquant_tpu_torch.cli.export_int8_model import main

    paths = {k: str(tmp_path / f"{k}.npz") for k in ("port", "jax")}
    argv = ["--model_path", dirs["opt"], "--tokens_path", tokens_file, "--num_samples", "2",
            "--seq_len", "64", "--act_scales_path", act_scales["opt"], "--export_smoothed"]
    main(argv + ["--output_path", paths["port"], "--device", "cpu"])
    jmain(argv + ["--output_path", paths["jax"]])
    capsys.readouterr()
    got, ref = jck.load_params(paths["port"]), jck.load_params(paths["jax"])
    w = ("layers", "0", "fc1", "weight")
    a, b = got, ref
    for p in w:
        a, b = a[p], b[p]
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-7)
    scales = [json.load(open(p.replace(".npz", "") + ".layer_scales.json"))
              for p in (paths["port"], paths["jax"])]
    assert len(scales[0]) == len(scales[1]) == 2
    for s, r in zip(*scales):
        assert s.keys() == r.keys()
        for k in r:
            assert abs(s[k] - r[k]) <= 1e-5 * abs(r[k]), k


def test_run_experiments_results_match_jax(dirs, tokens_file, tmp_path, capsys):
    from smoothquant_tpu.cli.run_experiments import main as jmain
    from smoothquant_tpu_torch.cli.run_experiments import main

    outs = {k: str(tmp_path / k) for k in ("port", "jax")}
    argv = ["--model_path", dirs["opt"], "--tokens_path", tokens_file,
            "--group_sizes", "16", "32", "--salient_props", "0.0", "0.1",
            "--n_samples", "1", "--window", "64", "--calib_samples", "2",
            "--calib_seq_len", "64", "--dtype", "float32"]
    main(argv + ["--output_dir", outs["port"], "--device", "cpu"])
    jmain(argv + ["--output_dir", outs["jax"]])
    capsys.readouterr()
    got, ref = (json.load(open(os.path.join(outs[k], "results.json"))) for k in ("port", "jax"))
    assert {k: got[k] for k in ("model", "arch", "quant_bits")} == {
        k: ref[k] for k in ("model", "arch", "quant_bits")}
    assert len(got["results"]) == len(ref["results"]) == 4
    for g, r in zip(got["results"], ref["results"]):
        assert (g["salient_prop"], g["group_size"], g["size_mib"]) == (
            r["salient_prop"], r["group_size"], r["size_mib"])
        # run_experiments' recipe is W4A4 with sorted per-group activations
        assert abs(g["ppl"] - r["ppl"]) <= SORTED_ACT_TOL * r["ppl"], (g, r)


@pytest.mark.parametrize("name", ["ppl_eval", "generate_act_scales", "export_int8_model",
                                  "run_experiments"])
def test_parsers_take_the_jax_flags_and_device(name):
    """Every flag of the JAX CLI parses the same in the port's, and --device
    defaults to the card."""
    import importlib

    port = importlib.import_module(f"smoothquant_tpu_torch.cli.{name}").build_parser()
    ref = importlib.import_module(f"smoothquant_tpu.cli.{name}").build_parser()
    ours = {a.dest: a for a in port._actions}
    for a in ref._actions:
        assert a.dest in ours, a.dest
        assert ours[a.dest].option_strings == a.option_strings, a.dest
        if name != "export_int8_model" or a.dest != "dtype":
            assert ours[a.dest].default == a.default, a.dest
    assert ours["device"].default == "cuda"


def test_quantize_bmm_input_flag_tristate():
    from smoothquant_tpu_torch.cli.ppl_eval import build_parser

    p = build_parser()
    base = ["--model_path", "x"]
    assert p.parse_args(base).quantize_bmm_input is None
    assert p.parse_args(base + ["--quantize_bmm_input"]).quantize_bmm_input is True
    assert p.parse_args(base + ["--no-quantize_bmm_input"]).quantize_bmm_input is False


@pytest.mark.parametrize("family,default", [("opt", True), ("llama", False)])
def test_quantize_bmm_input_per_arch_default(dirs, tokens_file, capsys, monkeypatch,
                                             family, default):
    """Unset, the flag takes the reference's per-arch default: the recipe
    the port's ppl_eval builds quantizes BMM inputs for OPT, not Llama."""
    from smoothquant_tpu_torch.cli import ppl_eval
    from smoothquant_tpu_torch.models import registry

    seen = []
    real = registry.quantize_model
    monkeypatch.setattr(registry, "quantize_model",
                        lambda arch, p, cfg, qcfg, input_feat=None:
                        seen.append(qcfg) or real(arch, p, cfg, qcfg, input_feat))
    ppl_eval.main(["--model_path", dirs[family], "--tokens_path", tokens_file,
                   "--n_samples", "1", "--window", "64", "--quantize", "--json",
                   "--device", "cpu"])
    capsys.readouterr()
    assert [q.quantize_bmm_input for q in seen] == [default]


def _hide(monkeypatch, *names):
    """Make `names` unimportable (None in sys.modules), as on a machine
    without them."""
    import sys

    for n in list(sys.modules):
        if n.split(".")[0] in names:
            monkeypatch.delitem(sys.modules, n)
    for n in names:
        monkeypatch.setitem(sys.modules, n, None)


@pytest.mark.parametrize("missing", ["datasets", "transformers"])
def test_dataset_path_names_the_missing_package(monkeypatch, tmp_path, missing):
    from smoothquant_tpu_torch.cli.common import load_token_stream

    _hide(monkeypatch, missing)
    args = type("A", (), dict(tokens_path=None, dataset_path=str(tmp_path / "d.json"),
                              tokenizer_path=None, model_path=str(tmp_path)))()
    with pytest.raises(SystemExit, match=missing):
        load_token_stream(args)


def test_plots_need_matplotlib(dirs, tokens_file, tmp_path, monkeypatch):
    from smoothquant_tpu_torch.cli.run_experiments import main

    _hide(monkeypatch, "matplotlib")
    with pytest.raises(SystemExit, match="matplotlib"):
        main(["--model_path", dirs["opt"], "--tokens_path", tokens_file, "--plots",
              "--output_dir", str(tmp_path / "p"), "--device", "cpu"])


@pytest.mark.parametrize("stateful", [False, True])
def test_time_steps_chains_the_calls(stateful):
    """utils.benchtools.time_steps: warm-up runs, then per repeat a baseline
    and a longer run, each call's first argument carrying the previous
    output times zero (the value unchanged) and, stateful, the state
    threaded from call to call; a positive median per call."""
    from smoothquant_tpu_torch.utils.benchtools import time_steps

    seen, states = [], []
    x0 = torch.ones(4)

    def step(x, w, *state):
        seen.append(x.clone())
        y = x * w
        if stateful:
            states.append(int(state[0]))
            return y, state[0] + 1
        return y

    args = (x0, torch.full((4,), 2.0)) + ((torch.tensor(0),) if stateful else ())
    t = time_steps(step, args, iters=5, baseline_iters=2, repeats=3, stateful=stateful)
    assert t > 0
    assert len(seen) == (5 + 2) + 2 + 3 * (2 + 7)
    assert all(torch.allclose(s, x0, atol=1e-5) for s in seen)
    if stateful:
        assert states[:7] == list(range(7))


@pytest.mark.parametrize("name", ["ppl_eval", "generate_act_scales", "export_int8_model",
                                  "run_experiments"])
def test_runs_as_a_module(name):
    """python -m smoothquant_tpu_torch.cli.<name> parses its flags (--help
    names --device) without importing JAX."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import runpy, sys\n"
            "sys.modules['jax'] = None\n"
            f"sys.argv = ['{name}', '--help']\n"
            f"runpy.run_module('smoothquant_tpu_torch.cli.{name}', run_name='__main__')\n")
    run = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    assert "--device" in run.stdout and "--model_path" in run.stdout
