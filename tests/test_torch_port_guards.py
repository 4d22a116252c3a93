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
           "stream_kinds_check", "act_variants", "k5_pdl_race")


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
