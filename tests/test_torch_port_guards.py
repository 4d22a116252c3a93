"""Guards of the port's rules, checked from its own files: no module of
smoothquant_tpu_torch, and neither chip_smoke.py nor the scripts that drive
the card, imports JAX or the JAX package; no entry point defaults to the
CPU; and the variant scripts' source edits still match the committed CUDA
sources (each edit exactly once), so the records of the designs not taken
build against the tree they ship with."""

import ast
import inspect
import os
import pkgutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import k5_pdl_race  # noqa: E402
import mlp_variants  # noqa: E402
import stream_variants  # noqa: E402

CSRC = os.path.join(ROOT, "smoothquant_tpu_torch", "kernels", "csrc")
SCRIPTS = ("mlp_variants", "s8_variants", "stream_variants", "attn_variants", "wg_variants",
           "stream_kinds_check", "act_variants", "k5_pdl_race", "io_probe")


def _port_modules():
    import smoothquant_tpu_torch

    return sorted(m.name for m in pkgutil.walk_packages(smoothquant_tpu_torch.__path__,
                                                        "smoothquant_tpu_torch."))


def test_port_chip_smoke_and_scripts_import_no_jax():
    """Every module of the port, chip_smoke.py and the card's scripts
    import in a fresh interpreter with no JAX, no JAX package module and no
    triton loaded, and no kernel built."""
    mods = _port_modules()
    assert len(mods) > 20
    code = (
        "import importlib, sys\n"
        f"sys.path[:0] = [{ROOT!r}, {os.path.join(ROOT, 'scripts')!r}]\n"
        f"for m in {mods + ['chip_smoke', *SCRIPTS]!r}:\n"
        "    importlib.import_module(m)\n"
        "from smoothquant_tpu_torch.kernels import _build\n"
        "assert _build._lib is None\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'triton', 'smoothquant_tpu')]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300, cwd=ROOT)


def _py_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    out += [os.path.join(ROOT, "scripts", f"{s}.py") for s in SCRIPTS]
    for d, _, files in os.walk(os.path.join(ROOT, "smoothquant_tpu_torch")):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_no_import_statement_names_jax():
    """No import statement in those files names jax or the JAX package
    (a lazy import inside a function would escape the fresh-interpreter
    check above)."""
    bad = []
    for path in _py_files():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) and not node.level
                     else [])
            bad += [(path, n) for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "smoothquant_tpu")]
    assert not bad, bad


def test_no_entry_point_defaults_to_the_cpu():
    """Every function of the port that takes a device defaults to the card
    (or to no default, or to its tensors' device): none to the CPU."""
    import importlib

    import torch

    from smoothquant_tpu_torch._device import resolve_device

    seen, bad = 0, []
    for name in _port_modules():
        mod = importlib.import_module(name)
        for fname, fn in inspect.getmembers(mod, inspect.isfunction):
            if fn.__module__ != name:
                continue
            for p in inspect.signature(fn).parameters.values():
                if p.name not in ("device", "dev"):
                    continue
                seen += 1
                d = p.default
                if (isinstance(d, str) and d.startswith("cpu")) or (
                        isinstance(d, torch.device) and d.type == "cpu"):
                    bad.append(f"{name}.{fname}")
    assert seen >= 5 and not bad, bad
    assert inspect.signature(resolve_device).parameters["device"].default == "cuda"


@pytest.mark.parametrize("name", sorted(mlp_variants.VARIANTS))
def test_mlp_variant_edits_apply(name):
    out = mlp_variants.variant_sources(name, CSRC)
    assert out
    assert set(out) <= {mlp_variants.SG, *mlp_variants.SOURCES}
    for f, text in out.items():
        with open(os.path.join(CSRC, f)) as fh:
            assert text != fh.read()
    if mlp_variants.SG in out:
        assert "stream_swiglu_kernel(" in out[mlp_variants.SG]
    if mlp_variants.MF in out:     # a launch taken out, or the chaining
        assert "sq_mlp_stream(" in out[mlp_variants.MF]


@pytest.mark.parametrize("name", sorted(stream_variants.VARIANTS))
def test_stream_variant_edits_apply(name):
    with open(os.path.join(CSRC, stream_variants.HEADER)) as f:
        text = f.read()
    assert stream_variants.apply_edits(text, stream_variants.VARIANTS[name]) != text


def test_k5_pdl_race_edit_applies():
    """The race script's one variant takes out exactly the consumers' wait
    before K5's f32 salient dot, and the committed source has that wait."""
    with open(os.path.join(CSRC, k5_pdl_race.HEADER)) as f:
        text = f.read()
    out = k5_pdl_race.apply_edits(text, k5_pdl_race.VARIANTS["no_consumer_wait"])
    assert out.count("griddep_wait();") == text.count("griddep_wait();") - 1
    assert "sg_salient_f32<NT>(acc, a, o0, l);" in out


def test_mlp_variants_host_options_are_the_wrappers():
    """The host variants pass options the wrappers take: K14's gate_up
    split, K16's body and plan; K14's launch options are source edits, not
    wrapper options."""
    import smoothquant_tpu_torch.kernels.mlp_fused as k14
    import smoothquant_tpu_torch.kernels.norm_quant as k16

    k14_args = inspect.signature(k14.mlp_swiglu_fused_stacked).parameters
    k16_args = inspect.signature(k16.norm_quant).parameters
    for name, opts in mlp_variants.HOST.items():
        for key in opts:
            if key == "k14_split":
                assert opts[key] in (1, 2, 4, 8)
                assert callable(k14.gate_up_split)
            elif key == "k16":
                for n, c in ((4, 2048), (2048, 2048), (3, 8192)):
                    w, r, pf = opts[key](n, c, k16.k16_plan(n, c))
                    assert w in (1, 2, 4, 8) and r >= 1 and w * r <= k16.MAX_WARPS
                    assert 32 * w * k16.CHUNKS * 8 >= c and pf in (True, False)
            elif name in mlp_variants.K16_VARIANTS:
                assert key in k16_args
            else:
                assert key in k14_args
    assert set(mlp_variants.HOST).isdisjoint(mlp_variants.VARIANTS)
    assert {"gate_up_only", "down_only", "unchained"} <= set(mlp_variants.VARIANTS)
    assert not {"chain", "parts"} & set(k14_args)
    with pytest.raises(ValueError, match="exactly once"):
        mlp_variants.apply_edits("int x;", [("int y;", "int z;")])


# ---------------------------------------------------------------- I/O and the CLI

IO_MODULES = ("smoothquant_tpu_torch.utils.checkpoint", "smoothquant_tpu_torch.utils.hf_import",
              "smoothquant_tpu_torch.utils.native", "smoothquant_tpu_torch.utils.benchtools",
              "smoothquant_tpu_torch.cli.common", "smoothquant_tpu_torch.cli.generate_act_scales",
              "smoothquant_tpu_torch.cli.export_int8_model", "smoothquant_tpu_torch.cli.ppl_eval",
              "smoothquant_tpu_torch.cli.run_experiments")
ABSENT_ON_THE_CARD = ("jax", "jaxlib", "smoothquant_tpu", "transformers", "safetensors",
                      "datasets", "ml_dtypes", "matplotlib")


def test_io_modules_run_without_the_packages_the_card_lacks(tmp_path):
    """In a fresh interpreter where JAX, transformers, safetensors, datasets,
    ml_dtypes and matplotlib cannot be imported, the new modules import,
    load_model reads a save_pretrained directory (safetensors shards), and
    load_packed_model, load_int8_opt and the CLIs' --tokens_path runs work."""
    pytest.importorskip("transformers")
    from transformers import OPTConfig, OPTForCausalLM

    d = tmp_path / "opt"
    OPTForCausalLM(OPTConfig(vocab_size=64, hidden_size=32, ffn_dim=64, num_hidden_layers=2,
                             num_attention_heads=4, max_position_embeddings=64)
                   ).save_pretrained(str(d), safe_serialization=True)
    import numpy as np

    np.save(str(tmp_path / "t.npy"), np.arange(512) % 64)
    code = (
        "import importlib, sys, os\n"
        f"for m in {ABSENT_ON_THE_CARD!r}:\n"
        "    sys.modules[m] = None\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        f"for m in {IO_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "from smoothquant_tpu_torch.utils import checkpoint, hf_import\n"
        "from smoothquant_tpu_torch.models.registry import pack_model\n"
        "from smoothquant_tpu_torch.quant.config import w4a4_group\n"
        f"arch, cfg, p = hf_import.load_model({str(d)!r}, dtype='bfloat16', device='cpu')\n"
        "assert arch == 'opt' and cfg.hidden_size == 32\n"
        "packed = pack_model('opt', p, cfg, w4a4_group(16), nibble=True, host_pack=True)\n"
        f"path = os.path.join({str(tmp_path)!r}, 'p.npz')\n"
        "checkpoint.save_packed_model(packed, path)\n"
        "back = checkpoint.load_packed_model(path, device='cpu')\n"
        "assert back['layers']['0']['fc1'].w_scales_t.dtype == packed['layers']['0']['fc1'].w_scales_t.dtype\n"
        "from smoothquant_tpu_torch.cli import export_int8_model, ppl_eval\n"
        f"out = os.path.join({str(tmp_path)!r}, 'i8.npz')\n"
        f"export_int8_model.main(['--model_path', {str(d)!r}, '--tokens_path', "
        f"{str(tmp_path / 't.npy')!r}, '--num_samples', '2', '--seq_len', '32', "
        "'--output_path', out, '--device', 'cpu'])\n"
        "cfg8, i8 = checkpoint.load_int8_opt(out, device='cpu')\n"
        "assert len(i8['int8_layers']) == 2\n"
        f"ppl_eval.main(['--model_path', {str(d)!r}, '--tokens_path', "
        f"{str(tmp_path / 't.npy')!r}, '--n_samples', '1', '--window', '64', '--quantize', "
        "'--json', '--device', 'cpu'])\n"
        "bad = [m for m in sys.modules if sys.modules[m] is not None and "
        f"m.split('.')[0] in {ABSENT_ON_THE_CARD!r}]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300, cwd=str(tmp_path))


def _cuda_entry_points(tmp_path):
    import numpy as np

    from smoothquant_tpu_torch.cli import common, export_int8_model, generate_act_scales
    from smoothquant_tpu_torch.cli import ppl_eval, run_experiments
    from smoothquant_tpu_torch.models import bloom, llama, opt
    from smoothquant_tpu_torch.utils import checkpoint, hf_import

    missing = str(tmp_path / "missing")
    cli = ["--model_path", missing, "--tokens_path", missing]
    return {
        "load_params": lambda: checkpoint.load_params(missing),
        "load_packed_model": lambda: checkpoint.load_packed_model(missing),
        "load_int8_opt": lambda: checkpoint.load_int8_opt(missing),
        "load_model": lambda: hf_import.load_model(missing),
        "llama.params_from_hf_state_dict":
            lambda: llama.params_from_hf_state_dict({}, llama.LlamaConfig.tiny()),
        "opt.params_from_hf_state_dict":
            lambda: opt.params_from_hf_state_dict({}, opt.OPTConfig.tiny()),
        "bloom.params_from_hf_state_dict":
            lambda: bloom.params_from_hf_state_dict({}, bloom.BloomConfig.tiny()),
        "calib_batches": lambda: common.calib_batches(np.arange(64), 1, 32),
        "generate_act_scales": lambda: generate_act_scales.main(cli + ["--output_path", "x"]),
        "export_int8_model": lambda: export_int8_model.main(cli + ["--output_path", "x"]),
        "ppl_eval": lambda: ppl_eval.main(cli),
        "run_experiments": lambda: run_experiments.main(cli),
    }


@pytest.mark.parametrize("name", ["load_params", "load_packed_model", "load_int8_opt",
                                  "load_model", "llama.params_from_hf_state_dict",
                                  "opt.params_from_hf_state_dict",
                                  "bloom.params_from_hf_state_dict", "calib_batches",
                                  "generate_act_scales", "export_int8_model", "ppl_eval",
                                  "run_experiments"])
def test_io_entry_points_raise_on_cuda_without_cuda(tmp_path, name):
    """Every new entry point runs on the card by default and raises where
    there is none, before it reads a file."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        _cuda_entry_points(tmp_path)[name]()


def test_packlib_is_the_port_own_copy():
    """The port builds its own packlib.cpp: every function of the JAX
    package's library is in it (test_torch_host_pack holds them to JAX's
    bit for bit), and it needs no OpenMP."""
    import re

    with open(os.path.join(ROOT, "csrc", "packlib.cpp")) as f:
        ref = f.read()
    with open(os.path.join(CSRC, "packlib.cpp")) as f:
        ours = f.read()
    names = re.findall(r"\nvoid ([a-z0-9_]+)\(", ref)
    assert len(names) == 5
    for name in names:
        assert re.search(rf"\nvoid {name}\(", ours), name
    assert "#pragma omp" not in ours and "<omp.h>" not in ours
    from smoothquant_tpu_torch.utils import native

    assert os.path.samefile(native.SRC, os.path.join(CSRC, "packlib.cpp"))
    assert "-fopenmp" not in native.CXX_FLAGS
