"""Sharded packed checkpoints (utils.checkpoint.save_packed_model_sharded /
load_packed_model_sharded) against the JAX package's
(smoothquant_tpu/utils/checkpoint.py:149-285), both ways, bit for bit.

Trees: a v1 pack_model tree (per-layer int8 containers, every linear
"gather") and a pack_model_tp tree (the W4A4 nibble flagship recipe with
5 % salient: "none" column packs, "psum" row packs K-concatenated, the
per-channel int8 lm_head "gather", its weight K-major in the port), f32
compute so that the JAX loader reads the port's files.  The port loads
JAX's directory whole (the tree convert.params_from_numpy gives) and a
rank's shard (parallel.tp_packed.local_shard of that tree); its own
directory holds JAX's manifest and JAX's arrays, byte for byte, and JAX
loads it; two gloo ranks each load their shard of JAX's directory and
run make_tp_forward_v2 to JAX's TP logits."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smoothquant_tpu.models import llama as jllama
from smoothquant_tpu.models.registry import pack_model as jpack_model
from smoothquant_tpu.parallel import make_mesh as jmake_mesh
from smoothquant_tpu.parallel.tp_packed import make_tp_forward_v2 as jmake_tp_forward_v2
from smoothquant_tpu.parallel.tp_packed import pack_model_tp as jpack_model_tp
from smoothquant_tpu.quant import QuantConfig as JQuantConfig, w4a4_group as jw4a4_group
from smoothquant_tpu.utils import checkpoint as jck

from smoothquant_tpu_torch.parallel import mesh as tmesh
from smoothquant_tpu_torch.parallel import tp_packed as ttp
from smoothquant_tpu_torch.utils import checkpoint as tck
from smoothquant_tpu_torch.utils.convert import params_from_numpy

from test_torch_parallel_tp import np_tree
from torch_io_helpers import assert_trees_bit_equal

torch.set_num_threads(1)

TP = 2


def _cfg():
    return dataclasses.replace(jllama.LlamaConfig.tiny(), hidden_size=128,
                               intermediate_size=256, num_attention_heads=4,
                               num_key_value_heads=2)


@pytest.fixture(scope="module")
def trees():
    cfg = _cfg()
    params = jllama.init_params(jax.random.PRNGKey(0), cfg)
    feat = {key: np.random.default_rng(1).uniform(0.1, 1.0, size=(
        cfg.intermediate_size if "down_proj" in key else cfg.hidden_size,))
        for _, key, _ in jllama.quantizable_linears(cfg)}
    v1 = jpack_model("llama", params, cfg, jw4a4_group(group_size=32, salient_prop=0.05),
                     input_feat=feat, compute_dtype=jnp.float32)
    lm_q = JQuantConfig(weight_quant="per_channel", act_quant="per_token", quant_bits=8)
    v2 = jpack_model_tp("llama", params, cfg, jw4a4_group(group_size=32, salient_prop=0.05),
                        tp=TP, input_feat=feat, compute_dtype=jnp.float32, nibble=True,
                        lm_head_qcfg=lm_q)
    return cfg, {"v1": v1, "v2": v2}


def _files(d):
    return sorted(os.listdir(d))


@pytest.mark.parametrize("name", ["v1", "v2"])
def test_jax_directory_loads_in_the_port(trees, tmp_path, name):
    """JAX's directory, whole and shard by shard: the tree params_from_numpy
    carries across, and each rank's local_shard of it, bit for bit."""
    _, t = trees
    d = str(tmp_path / "jax")
    jck.save_packed_model_sharded(t[name], d, n_shards=TP)
    whole = params_from_numpy(np_tree(t[name]), "cpu")
    assert_trees_bit_equal(tck.load_packed_model_sharded(d, device="cpu"), whole)
    for r in range(TP):
        got = tck.load_packed_model_sharded(d, shard=r, device="cpu")
        assert_trees_bit_equal(got, ttp.local_shard(whole, r, TP))
    if name == "v2":
        lin = got["layers"]["0"]["mlp"]["down_proj"]
        assert lin.meta.tp_reduce == "psum" and lin.meta.nibble
        lm = got["lm_head"]
        assert lm.meta.tp_reduce == "gather" and lm.meta.layout == "identity"
        assert lm.w_qt.t().is_contiguous()          # K-major, as K4 reads it


@pytest.mark.parametrize("name", ["v1", "v2"])
def test_port_directory_is_jaxs(trees, tmp_path, name):
    """The port's directory of the same tree: JAX's files, manifest (metas
    and split axes) and every array byte for byte; JAX loads it whole and
    by shard to its own tree's arrays."""
    _, t = trees
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    jck.save_packed_model_sharded(t[name], jd, n_shards=TP)
    tck.save_packed_model_sharded(params_from_numpy(np_tree(t[name]), "cpu"), td, TP)
    assert _files(td) == _files(jd)
    with open(os.path.join(td, "manifest.json")) as f, \
            open(os.path.join(jd, "manifest.json")) as g:
        assert f.read() == g.read()
    for fn in _files(jd):
        if not fn.endswith(".npz"):
            continue
        with np.load(os.path.join(td, fn)) as a, np.load(os.path.join(jd, fn)) as b:
            assert list(a.files) == list(b.files)
            for k in b.files:
                assert a[k].dtype.str == b[k].dtype.str and a[k].shape == b[k].shape, k
                assert a[k].tobytes() == b[k].tobytes(), k
    for shard in (None, 1):
        back = jck.load_packed_model_sharded(td, shard=shard)
        ref = jck.load_packed_model_sharded(jd, shard=shard)
        for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(back),
                                    jax.tree_util.tree_leaves_with_path(ref)):
            assert pa == pb
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_ranks_run_the_tp_forward_from_jaxs_shards(trees, tmp_path):
    """Two gloo ranks each load only their shard of JAX's v2 directory and
    run make_tp_forward_v2 to JAX's TP logits (shard_map over the whole
    tree) within f32 accumulation order."""
    import torch_parallel_ranks as ranks

    cfg, t = trees
    d = str(tmp_path / "jax")
    jck.save_packed_model_sharded(t["v2"], d, n_shards=TP)
    ids = np.random.default_rng(2).integers(0, cfg.vocab_size, size=(2, 7))
    res = tmesh.launch(ranks.sharded_checkpoint_forward, TP, device="cpu",
                       args=(d, dataclasses.asdict(cfg), ids), timeout_s=60)
    fwd = jmake_tp_forward_v2(jllama, cfg, jmake_mesh(tp=TP, dp=4), interpret=True)(t["v2"])
    ref = np.asarray(fwd(t["v2"], jnp.asarray(ids)))
    for r in res:
        np.testing.assert_allclose(r, ref, atol=1e-4, rtol=1e-4)
