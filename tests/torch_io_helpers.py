"""Helpers of the port's I/O tests (test_torch_checkpoint, _hf_import,
_host_pack, _cli): tiny HF directories written by transformers'
save_pretrained, and trees of either package as numpy leaves compared bit
for bit."""

import dataclasses
import json
import os

import numpy as np
import torch

VOCAB = 128

HF_FAMILIES = {
    # name: (transformers config class, model class, config kwargs)
    "llama": ("LlamaConfig", "LlamaForCausalLM",
              dict(vocab_size=VOCAB, hidden_size=64, intermediate_size=96,
                   num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                   max_position_embeddings=64)),
    "mistral": ("MistralConfig", "MistralForCausalLM",
                dict(vocab_size=VOCAB, hidden_size=64, intermediate_size=128,
                     num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                     max_position_embeddings=64, sliding_window=8)),
    "opt": ("OPTConfig", "OPTForCausalLM",
            dict(vocab_size=VOCAB, hidden_size=64, ffn_dim=128, num_hidden_layers=2,
                 num_attention_heads=4, max_position_embeddings=64,
                 word_embed_proj_dim=64)),
    "opt_proj": ("OPTConfig", "OPTForCausalLM",
                 dict(vocab_size=VOCAB, hidden_size=64, ffn_dim=128, num_hidden_layers=2,
                      num_attention_heads=4, max_position_embeddings=64,
                      word_embed_proj_dim=32)),
    "bloom": ("BloomConfig", "BloomForCausalLM",
              dict(vocab_size=VOCAB, hidden_size=64, n_layer=2, n_head=4)),
    "falcon": ("FalconConfig", "FalconForCausalLM",
               dict(vocab_size=VOCAB, hidden_size=64, num_hidden_layers=2,
                    num_attention_heads=4, multi_query=True, parallel_attn=True,
                    new_decoder_architecture=False, bias=False)),
    "falcon_new": ("FalconConfig", "FalconForCausalLM",
                   dict(vocab_size=VOCAB, hidden_size=64, num_hidden_layers=2,
                        num_attention_heads=4, num_kv_heads=2,
                        new_decoder_architecture=True, bias=False)),
    "mixtral": ("MixtralConfig", "MixtralForCausalLM",
                dict(vocab_size=VOCAB, hidden_size=64, intermediate_size=96,
                     num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                     num_local_experts=4, num_experts_per_tok=2,
                     max_position_embeddings=64)),
}


def hf_model(family: str, seed: int = 0):
    """A tiny HF model of `family` in float32 with every parameter random
    (norm weights around 1), from `seed`."""
    import transformers

    cfg_cls, model_cls, kw = HF_FAMILIES[family]
    cfg = getattr(transformers, cfg_cls)(**kw)
    torch.manual_seed(seed)
    model = getattr(transformers, model_cls)(cfg).eval()
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            norm_weight = "norm" in name and name.endswith("weight")
            base = 1.0 if norm_weight else 0.0
            p.copy_(base + 0.05 * torch.randn(p.shape, generator=gen))
    return model


def write_hf_dir(path: str, family: str, dtype=torch.float32, layout: str = "one",
                 seed: int = 0) -> str:
    """save_pretrained of hf_model(family) in `dtype`: one safetensors
    shard ("one"), several ("two"), or pytorch_model.bin ("bin")."""
    model = hf_model(family, seed).to(dtype)
    kw = {"safe_serialization": layout != "bin"}
    if layout == "two":
        kw["max_shard_size"] = "60KB"
    model.save_pretrained(path, **kw)
    if layout == "two":
        assert len([f for f in os.listdir(path) if f.endswith(".safetensors")]) >= 2
    return path


def write_config(path: str, cfg: dict) -> str:
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfg, f)
    return path


def np_leaf(x) -> np.ndarray:
    """A leaf of either package as numpy; bfloat16 as its uint16 bits
    (dtype_name tells it from a uint16 leaf)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    if a.dtype.name == "bfloat16" or a.dtype == np.dtype("V2"):
        return a.view(np.uint16)
    return a


def dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    a = np.asarray(x)
    return "bfloat16" if a.dtype == np.dtype("V2") else a.dtype.name


def leaves(tree, prefix: str = "") -> dict:
    """{path: leaf} of a tree of dicts, lists, tuples and dataclasses (a
    PackedLinear's meta and the port's cast cache left out)."""
    out = {}
    if tree is None:
        return out
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(leaves(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(leaves(v, f"{prefix}{i}/"))
    elif dataclasses.is_dataclass(tree) and not type(tree).__name__ == "PackedMeta":
        for f in dataclasses.fields(tree):
            if f.name not in ("meta", "_sal_cast"):
                out.update(leaves(getattr(tree, f.name), f"{prefix}{f.name}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def assert_trees_bit_equal(got, ref, widen=("perm", "sal_perm", "sal_inv_perm",
                                            "salient_indices")):
    """Same paths, dtypes (index leaves int64 against int32 allowed) and
    bits in every leaf."""
    g, r = leaves(got), leaves(ref)
    assert sorted(g) == sorted(r), (sorted(set(g) ^ set(r)))
    for k in r:
        a, b = np_leaf(g[k]), np_leaf(r[k])
        if k.rsplit("/", 1)[-1] in widen:
            a, b = a.astype(np.int64), b.astype(np.int64)
        elif np.ndim(r[k]) == 0 and not isinstance(g[k], torch.Tensor):
            assert float(g[k]) == float(np.asarray(r[k])), k
            continue
        else:
            assert dtype_name(g[k]) == dtype_name(r[k]), (k, dtype_name(g[k]), dtype_name(r[k]))
        assert a.shape == b.shape, (k, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=k)
