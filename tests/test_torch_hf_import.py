"""The port's HF import (smoothquant_tpu_torch.utils.hf_import and the
families' config_from_hf / params_from_hf_state_dict) against the JAX
package's and against the HF torch models, on tiny directories written by
save_pretrained: F32, F16 and BF16 shards, a sharded directory and a
pytorch_model.bin one; its own safetensors reader against safetensors';
its config.json reader against AutoConfig on minimal files."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

pytest.importorskip("transformers")
pytest.importorskip("safetensors")

import jax  # noqa: E402,F401  (registers bfloat16 with numpy for safetensors.numpy)

from smoothquant_tpu.utils import hf_import as jhf  # noqa: E402
from smoothquant_tpu_torch.models import bloom, falcon, llama, mixtral, opt  # noqa: E402
from smoothquant_tpu_torch.utils import hf_import as thf  # noqa: E402
from torch_io_helpers import (  # noqa: E402
    VOCAB,
    assert_trees_bit_equal,
    hf_model,
    write_config,
    write_hf_dir,
)

DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16}
CASES = [("llama", "F32", "one"), ("llama", "BF16", "two"), ("llama", "F16", "bin"),
         ("mistral", "BF16", "one"), ("mistral", "F32", "two"),
         ("opt", "F16", "one"), ("opt", "BF16", "bin"), ("opt_proj", "F32", "two"),
         ("bloom", "F32", "one"), ("bloom", "BF16", "two"),
         ("falcon", "F32", "one"), ("falcon", "BF16", "two"), ("falcon_new", "F16", "bin"),
         ("mixtral", "F32", "one"), ("mixtral", "BF16", "two")]


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("hf")
    return {c: write_hf_dir(str(root / "-".join(c)), c[0], DTYPES[c[1]], c[2])
            for c in CASES}


@pytest.mark.parametrize("case", CASES, ids=["-".join(c) for c in CASES])
@pytest.mark.parametrize("dtype", [None, "float32"])
def test_config_and_params_match_jax(hf_dirs, case, dtype):
    d = hf_dirs[case]
    arch, cfg, params = thf.load_model(d, dtype=dtype, device="cpu")
    j_arch, j_cfg, j_params = jhf.load_model(d, dtype=dtype)
    assert arch == j_arch
    ours = dataclasses.asdict(cfg)
    theirs = dataclasses.asdict(j_cfg)
    assert ours == {k: theirs[k] for k in ours}
    assert_trees_bit_equal(params, j_params)
    want = torch.float32 if dtype == "float32" else torch.bfloat16
    assert all(t.dtype == want for t in _tensors(params))


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif tree is not None:
        yield tree


FORWARD = ["llama", "mistral", "opt", "opt_proj", "bloom", "falcon", "falcon_new", "mixtral"]


@pytest.mark.parametrize("family", FORWARD)
def test_forward_matches_hf_model(tmp_path, family):
    """The imported tree's logits against the HF torch model's, within
    atol 2e-4 / rtol 2e-3 (tests/test_cli.py:57-70)."""
    d = write_hf_dir(str(tmp_path / family), family)
    arch, cfg, params = thf.load_model(d, dtype="float32", device="cpu")
    mod = {"llama": llama, "mistral": llama, "opt": opt, "opt_proj": opt,
           "bloom": bloom, "falcon": falcon, "falcon_new": falcon, "mixtral": mixtral}[family]
    if family == "mistral":
        assert cfg.sliding_window == 8
    ids = torch.as_tensor(np.random.default_rng(1).integers(0, VOCAB, size=(2, 12)))
    with torch.no_grad():
        ref = hf_model(family)(ids).logits.float()
        got = mod.forward(params, ids, cfg)[0]
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-4, rtol=2e-3)


MINIMAL = {
    "llama_bare": {"architectures": ["LlamaForCausalLM"], "model_type": "llama"},
    "llama_kv_null": {"architectures": ["LlamaForCausalLM"], "model_type": "llama",
                      "num_attention_heads": 8, "num_key_value_heads": None,
                      "hidden_size": 512},
    "mistral_window_absent": {"architectures": ["MistralForCausalLM"],
                              "model_type": "mistral", "hidden_size": 1024},
    "mistral_window_null": {"architectures": ["MistralForCausalLM"],
                            "model_type": "mistral", "sliding_window": None,
                            "rope_theta": 1e6},
    "mistral_kv_null": {"architectures": ["MistralForCausalLM"], "model_type": "mistral",
                        "num_key_value_heads": None, "num_attention_heads": 16},
    "opt_bare": {"architectures": ["OPTForCausalLM"], "model_type": "opt",
                 "hidden_size": 2048},
    "opt_proj": {"architectures": ["OPTForCausalLM"], "model_type": "opt",
                 "hidden_size": 1024, "word_embed_proj_dim": 512,
                 "do_layer_norm_before": False},
    "bloom_n_embed": {"architectures": ["BloomForCausalLM"], "model_type": "bloom",
                      "n_embed": 4096, "n_layer": 30, "num_attention_heads": 32},
    "bloom_aliases": {"architectures": ["BloomForCausalLM"], "model_type": "bloom",
                      "hidden_size": 256, "num_hidden_layers": 3, "n_head": 4,
                      "layer_norm_epsilon": 1e-6},
    "bloom_bare": {"model_type": "bloom"},
    "falcon_bare": {"architectures": ["FalconForCausalLM"], "model_type": "falcon"},
    "falcon_n_embed": {"architectures": ["FalconForCausalLM"], "model_type": "falcon",
                       "n_embed": 8192, "num_attention_heads": 128, "num_kv_heads": 8,
                       "new_decoder_architecture": True, "num_hidden_layers": 60},
    "falcon_kv_null": {"model_type": "falcon", "num_kv_heads": None,
                       "multi_query": False, "parallel_attn": False, "bias": True},
    "mixtral_bare": {"architectures": ["MixtralForCausalLM"], "model_type": "mixtral"},
    "mixtral_kv_null": {"architectures": ["MixtralForCausalLM"], "model_type": "mixtral",
                        "num_key_value_heads": None, "num_attention_heads": 16,
                        "rope_theta": 1e4},
}


# the keys each family's config_from_hf reads
_LLAMA_KEYS = ("vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
               "num_attention_heads", "num_key_value_heads", "max_position_embeddings",
               "rms_norm_eps", "rope_theta", "tie_word_embeddings", "attention_bias",
               "mlp_bias", "sliding_window")
READ_KEYS = {
    "llama": _LLAMA_KEYS, "mistral": _LLAMA_KEYS,
    "opt": ("vocab_size", "hidden_size", "ffn_dim", "num_hidden_layers",
            "num_attention_heads", "max_position_embeddings", "word_embed_proj_dim",
            "do_layer_norm_before"),
    "bloom": ("vocab_size", "hidden_size", "n_layer", "n_head", "layer_norm_epsilon",
              "num_hidden_layers", "num_attention_heads"),
    "falcon": ("vocab_size", "hidden_size", "num_hidden_layers", "num_attention_heads",
               "num_kv_heads", "multi_query", "parallel_attn", "new_decoder_architecture",
               "bias", "alibi", "layer_norm_epsilon", "rope_theta", "tie_word_embeddings"),
    "mixtral": ("vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
                "num_attention_heads", "num_key_value_heads", "num_local_experts",
                "num_experts_per_tok", "max_position_embeddings", "rms_norm_eps",
                "rope_theta", "tie_word_embeddings", "sliding_window"),
}


@pytest.mark.parametrize("name", sorted(MINIMAL))
def test_minimal_config_json_gives_autoconfig_values(tmp_path, name):
    """A config.json with the optional keys dropped: the port's reader gives
    what AutoConfig gives — Mistral's window 4096 when absent, None when
    null; the head count for a null kv-head count; Bloom's n_embed and
    aliases; OPT's projection width; Falcon's n_embed and its kv-head count
    when null; Mixtral's defaults."""
    from transformers import AutoConfig

    from smoothquant_tpu.models.registry import get_arch as jget_arch
    from smoothquant_tpu_torch.models.registry import get_arch

    d = write_config(str(tmp_path / name), MINIMAL[name])
    arch = thf.detect_arch(d)
    assert arch == jhf.detect_arch(d)
    hf = AutoConfig.from_pretrained(d)
    ns = thf.read_hf_config(d)
    for key in READ_KEYS[arch]:
        assert getattr(ns, key, "absent") == getattr(hf, key, "absent"), key
    ours = get_arch(arch).config_from_hf(ns)
    theirs = jget_arch(arch).config_from_hf(hf)
    ref = dataclasses.asdict(theirs)
    assert dataclasses.asdict(ours) == {k: ref[k] for k in dataclasses.asdict(ours)}
    if name == "mistral_window_absent":
        assert ours.sliding_window == 4096
    if name == "mistral_window_null":
        assert ours.sliding_window is None


ST_CASES = {
    "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I8": torch.int8, "U8": torch.uint8, "I32": torch.int32, "I64": torch.int64,
}


def _st_tensors():
    gen = torch.Generator().manual_seed(3)
    out = {}
    for i, (name, dt) in enumerate(sorted(ST_CASES.items())):
        shape = [(3, 5), (7,), (2, 3, 4), (), (1, 9), (4, 4), (5,)][i]
        if dt.is_floating_point:
            out[f"t.{name}"] = torch.randn(shape, generator=gen).to(dt)
        else:
            out[f"t.{name}"] = torch.randint(0, 100, shape, generator=gen).to(dt)
    return out


def test_safetensors_reader_matches_safetensors(tmp_path):
    """Every dtype the reader maps, __metadata__ included, read as
    safetensors.torch.load_file reads it; the port's writer read back by
    safetensors; a dtype outside the map raises."""
    from safetensors import safe_open
    from safetensors.torch import load_file, save_file

    tensors = _st_tensors()
    path = str(tmp_path / "a.safetensors")
    save_file(tensors, path, metadata={"format": "pt", "note": "x"})
    got, ref = thf.read_safetensors(path), load_file(path)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
        assert torch.equal(got[k], ref[k]), k

    mine = str(tmp_path / "mine.safetensors")
    n = thf.write_safetensors(tensors, mine, metadata={"format": "pt"})
    assert n == os.path.getsize(mine)
    back = load_file(mine)
    with safe_open(mine, "pt") as f:
        assert f.metadata() == {"format": "pt"}
    for k in tensors:
        assert back[k].dtype == tensors[k].dtype and torch.equal(back[k], tensors[k]), k

    bad = str(tmp_path / "f64.safetensors")
    save_file({"x": torch.zeros(3, dtype=torch.float64)}, bad)
    with pytest.raises(ValueError, match="F64"):
        thf.read_safetensors(bad)


def test_state_dict_shards_in_sorted_order(tmp_path):
    """A name in two shards takes the later shard's tensor, as the JAX
    reader's sorted update does; a directory without weights raises."""
    from safetensors.torch import save_file

    d = tmp_path / "sh"
    d.mkdir()
    save_file({"w": torch.zeros(2), "a": torch.ones(1)}, str(d / "model-00002.safetensors"))
    save_file({"w": torch.ones(2)}, str(d / "model-00001.safetensors"))
    got = thf.load_state_dict(str(d))
    ref = jhf.load_state_dict(str(d))
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), ref[k])
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError):
        thf.load_state_dict(str(empty))


@pytest.mark.parametrize("arch", ["FalconForCausalLM", "MixtralForCausalLM"])
def test_unported_families_are_named_and_refused(tmp_path, arch):
    """Falcon and Mixtral, the families the JAX package registers beside the
    others, are named as JAX names them and ported: the registry resolves
    them and load_model reads the config; what it refuses is a Falcon with
    ALiBi positions (alibi: true), which the JAX module would run with
    rotary ones."""
    from smoothquant_tpu_torch.models.registry import get_arch

    d = write_config(str(tmp_path / arch), {"architectures": [arch],
                                            "model_type": arch[:-len("ForCausalLM")].lower()})
    assert thf.detect_arch(d) == jhf.detect_arch(d) == thf.ARCH_MAP[arch]
    mod = get_arch(thf.ARCH_MAP[arch])
    assert mod.config_from_hf(thf.read_hf_config(d)).num_hidden_layers == 32
    if arch == "FalconForCausalLM":
        d = write_config(str(tmp_path / "alibi"), {"architectures": [arch],
                                                   "model_type": "falcon", "alibi": True})
        with pytest.raises(NotImplementedError, match="ALiBi"):
            thf.load_model(d, device="cpu")


@pytest.mark.parametrize("family", ["falcon", "falcon_new", "mixtral"])
def test_load_model_is_params_from_hf_state_dict(tmp_path, family):
    """load_model of a written tiny directory is, bit for bit, the tree
    params_from_hf_state_dict builds from the model's own tensors."""
    d = write_hf_dir(str(tmp_path / family), family, torch.bfloat16, "two")
    arch, cfg, params = thf.load_model(d, device="cpu")
    mod = {"falcon": falcon, "mixtral": mixtral}[arch]
    state = {k: v.detach() for k, v in hf_model(family).to(torch.bfloat16).state_dict().items()}
    assert_trees_bit_equal(params, mod.params_from_hf_state_dict(state, cfg, device="cpu"))


def test_unknown_architecture_raises(tmp_path):
    d = write_config(str(tmp_path / "gpt2"), {"architectures": ["GPT2LMHeadModel"],
                                              "model_type": "gpt2"})
    with pytest.raises(ValueError, match="cannot detect"):
        thf.detect_arch(d)


def test_read_hf_config_of_a_saved_directory(hf_dirs):
    """The namespace of a save_pretrained directory holds AutoConfig's
    values for the family's keys."""
    from transformers import AutoConfig

    for case in CASES:
        d = hf_dirs[case]
        hf, ns = AutoConfig.from_pretrained(d), thf.read_hf_config(d)
        for key, val in json.load(open(os.path.join(d, "config.json"))).items():
            if key in ("architectures", "torch_dtype", "transformers_version", "dtype"):
                continue
            assert getattr(ns, key) == getattr(hf, key), (case, key)
