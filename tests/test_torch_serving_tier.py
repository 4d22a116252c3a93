"""The serving tier of the port (serve/cluster.py, serve/sim.py, the
examples) against the JAX package's on the CPU.

  * ClusterFrontend over 1 and 2 replicas of a tiny f32 Llama's batcher
    (the same numpy weights in both packages): each request routed to the
    same host, the same work-stealing moves (rebalance), the same tokens in
    both packages and on 1 and 2 hosts, the same per-host bookkeeping;
  * simulate_cluster and scaling_efficiency on the three traces at 1, 2
    and 4 hosts: the dicts equal to JAX's exactly (the traces draw from
    numpy's default_rng as JAX's do, the admission is the real batcher's);
  * each example's main with --device cpu."""

import jax
import numpy as np
import pytest
import torch

from smoothquant_tpu.models import llama as jllama
from smoothquant_tpu.serve import ClusterFrontend as JFrontend
from smoothquant_tpu.serve.batching import ContinuousBatcher as JBatcher
from smoothquant_tpu.serve.batching import Request as JRequest
from smoothquant_tpu.serve import sim as jsim
from smoothquant_tpu_torch.models import llama as tllama
from smoothquant_tpu_torch.serve import ClusterFrontend, ContinuousBatcher, Request
from smoothquant_tpu_torch.serve import sim as tsim
from smoothquant_tpu_torch.utils.convert import config_from, params_from_numpy

torch.set_num_threads(1)

MAX_LEN = 64


@pytest.fixture(scope="module")
def tiny_llama():
    jcfg = jllama.LlamaConfig.tiny()
    params = jax.tree.map(np.asarray, jllama.init_params(jax.random.PRNGKey(0), jcfg))
    return jcfg, config_from(tllama.LlamaConfig, jcfg), params


def _requests(cls, vocab):
    """One long request first (routed alone to host 0), then short ones:
    host 1 queues more than its slots while host 0 frees one, so work is
    stolen."""
    rng = np.random.default_rng(7)
    out = [cls(uid=0, prompt=rng.integers(0, vocab, size=(10,)), max_new_tokens=30)]
    for i, n in enumerate(rng.integers(3, 8, size=7)):
        out.append(cls(uid=i + 1, prompt=rng.integers(0, vocab, size=(int(n),)),
                       max_new_tokens=int(rng.integers(2, 6))))
    return out


def _serve(front, reqs):
    """Submit, then run to completion recording each rebalance's moves:
    (the host each uid was routed to, the moves, tokens by uid, the host
    holding each uid at the end, per-host steps and requests done)."""
    for r in reqs:
        front.submit(r)
    routed = {u: rep.host_id for rep in front.replicas for u in (r.uid for r in rep.requests)}
    moves, rebalance = [], front.rebalance
    front.rebalance = lambda: moves.append(rebalance()) or moves[-1]
    done = front.run_to_completion()
    assert len(done) == len(reqs) and all(r.done for r in reqs)
    held = {r.uid: rep.host_id for rep in front.replicas for r in rep.requests}
    books = [(rep.stats.steps, rep.stats.requests_done, rep.stats.tokens, rep.outstanding)
             for rep in front.replicas]
    return routed, moves, {r.uid: list(r.generated) for r in reqs}, held, books


@pytest.mark.parametrize("n_hosts", [1, 2])
def test_cluster_frontend_matches_jax(tiny_llama, n_hosts):
    """The port's ClusterFrontend against JAX's over the same tiny Llama:
    the same routing, stealing, tokens and bookkeeping; and the tokens of
    2 hosts those of 1."""
    jcfg, tcfg, params = tiny_llama
    tparams = params_from_numpy(params, "cpu")
    jparams = jax.tree.map(np.asarray, params)
    jf = JFrontend(lambda i: JBatcher(jllama, jparams, jcfg, max_batch=2, max_len=MAX_LEN),
                   n_hosts)
    tf = ClusterFrontend(lambda i: ContinuousBatcher(tllama, tparams, tcfg, max_batch=2,
                                                     max_len=MAX_LEN, device="cpu"), n_hosts)
    ref = _serve(jf, _requests(JRequest, jcfg.vocab_size))
    got = _serve(tf, _requests(Request, jcfg.vocab_size))
    assert got == ref
    routed, moves, tokens, _, _ = got
    if n_hosts == 2:
        assert set(routed.values()) == {0, 1} and sum(moves) > 0
        one = _serve(ClusterFrontend(lambda i: ContinuousBatcher(
            tllama, tparams, tcfg, max_batch=2, max_len=MAX_LEN, device="cpu"), 1),
            _requests(Request, jcfg.vocab_size))
        assert one[2] == tokens
    stats = tf.stats(baseline_tokens_per_s=1e12)
    assert stats["requests_done"] == 8 and stats["n_hosts"] == n_hosts
    assert stats["total_tokens"] == sum(len(t) for t in tokens.values())
    assert set(stats["per_host"]) == set(range(n_hosts))
    assert 0.0 <= stats["scaling_efficiency"] < 1.0


COST = dict(decode_step_s=0.009, prefill_s_per_token=2e-5, prefill_base_s=0.001)


@pytest.mark.parametrize("trace", ["skewed_trace", "uniform_trace", "bursty_trace"])
def test_simulation_equals_jax(trace):
    """simulate_cluster at 1, 2 and 4 hosts and scaling_efficiency at 2 and
    4 on each trace (48 requests, seed 3): every dict equal to JAX's."""
    tcost, jcost = tsim.CostModel(**COST), jsim.CostModel(**COST)
    for n in (1, 2, 4):
        got = tsim.simulate_cluster(n, getattr(tsim, trace)(48, seed=3), tcost)
        ref = jsim.simulate_cluster(n, getattr(jsim, trace)(48, seed=3), jcost)
        assert got == ref, (trace, n)
        if n > 1:
            got = tsim.scaling_efficiency(getattr(tsim, trace)(48, seed=3), tcost, n)
            ref = jsim.scaling_efficiency(getattr(jsim, trace)(48, seed=3), jcost, n)
            assert got == ref and 0.0 < got["scaling_efficiency"] <= 1.0 + 1e-9


def test_simulation_single_request_cannot_scale():
    """One request: a second host only idles, efficiency 0.5 (as JAX's
    test_sim pins it)."""
    trace = [tsim.Arrival(0.0, Request(uid=0, prompt=np.arange(16, dtype=np.int32),
                                       max_new_tokens=32))]
    r = tsim.scaling_efficiency(trace, tsim.CostModel(**COST), 2)
    assert abs(r["scaling_efficiency"] - 0.5) < 1e-6
    assert r["one_host"]["tokens"] == r["n_host"]["tokens"] == 32


def test_examples_run_on_the_cpu(capsys):
    """Each example's main with --device cpu: the serving demo's 4 requests
    and the cluster demo's 8 finish with 6 tokens in range, opt_demo
    --random gives three finite perplexities; without --device an example
    asks for the card, which this machine lacks."""
    from smoothquant_tpu_torch.examples import cluster_demo, opt_demo, serving_demo

    done = serving_demo.main(["--device", "cpu"])
    assert [r.uid for r in done] == [0, 1, 2, 3]
    out = cluster_demo.main(["--device", "cpu"])
    assert out["stats"]["requests_done"] == 8 and out["stats"]["n_hosts"] == 2
    for r in done + out["requests"]:
        assert r.done and len(r.generated) == 6 and all(0 <= t < 256 for t in r.generated)
    ppl = opt_demo.main(["--random", "--device", "cpu"])
    assert set(ppl) == {"fp", "naive_w4a4", "mitigated_w4a4"}
    assert all(np.isfinite(v) and v > 1 for v in ppl.values())
    assert "request 3: prompt[8]" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            serving_demo.main([])
