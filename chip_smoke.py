#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (smoothquant_tpu_torch) on one GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit, builds the port's kernels from
   csrc/ with nvcc (sm_90a) and prints ptxas' register / spill summary.
2. Builds the full-width 32-layer Llama-2-7B from a seeded generator on the
   card and packs it with the serving recipe (W4A4 g64, 5 % salient, bf16
   scales, fused qkv / gate_up over a shared residual basis, identity
   o_proj, int8 lm_head), then stacks the decode tree.
3. Holds every kernel against its plain PyTorch version at the serving
   path's shapes (one JSON line per kernel and shape): K1 in its three
   modes at the four decode linears (N = 4), K6 at the four prefill linears
   (N = 1024), K2 and K3 at B = 4, S = 512.  Times come from CUDA events
   around launches queued behind a busy-wait, so they are device time.
4. Checks the kernel path against the plain path (the CPU) on a small
   model: prefill and one decode step, logits within tolerance.
5. Serves requests through ContinuousBatcher(max_batch=4, max_len=512,
   quant_kv=True, smajor=True) with the launch counts reset just before and
   read just after, and fails unless every kernel launched as often as the
   path implies.  Prints serving, prefill and decode rates.
6. Prints the `kernels` JSON line, then the `ok` line as the last line.

Exits non-zero on any failure; without CUDA, or without the port package
beside it, it exits non-zero and prints no result.
"""

import json
import statistics
import subprocess
import sys
import time

SEED = 0
MAX_BATCH, MAX_LEN, PREFILL_N = 4, 512, 1024


def _die(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


# ---------------------------------------------------------------- timing


def device_ms(fn, n_iter: int, reps: int = 5) -> float:
    """Median device ms of one fn(i) call: the launches are queued behind a
    busy-wait kernel, so host enqueue gaps do not enter the events."""
    import torch

    for i in range(2):
        fn(i)
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(300_000_000)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for i in range(n_iter):
            fn(i)
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / n_iter)
    return statistics.median(out)


def _close(name, got, ref, rel):
    """max |got - ref| and a check against rel · max |ref|."""
    err = (got.float() - ref.float()).abs().max().item()
    tol = rel * ref.float().abs().max().item() + 1e-6
    if not err <= tol:
        raise AssertionError(f"{name}: max_abs_err {err} > tolerance {tol}")
    return err


# ---------------------------------------------------------------- model


def build_model(cfg, dev, seed, group_size=64, align_o=2048):
    """Random Llama packed with the serving recipe: (per-layer tree,
    stacked decode tree)."""
    import dataclasses

    import numpy as np
    import torch

    from smoothquant_tpu_torch.models import llama
    from smoothquant_tpu_torch.models.registry import pack_model
    from smoothquant_tpu_torch.quant.config import QuantConfig, w4a4_group

    qcfg = dataclasses.replace(w4a4_group(group_size=group_size, salient_prop=0.05),
                               scale_dtype="bfloat16")
    head = QuantConfig(weight_quant="per_channel", act_quant="per_token",
                       quant_bits=8)
    gen = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    feat = {key: rng.uniform(0.1, 1.0, size=(
        cfg.intermediate_size if "down_proj" in key else cfg.hidden_size,))
        for _, key, _ in llama.quantizable_linears(cfg)}
    packed = pack_model(
        "llama", llama.init_params(gen, cfg, dev), cfg, qcfg, input_feat=feat,
        nibble=True, lm_head_qcfg=head, align_k_groups=8, align_o=align_o,
        fuse=True, fold_perms=True, shared_residual_basis=True,
        identity_keys=("o_proj",))
    return packed, llama.stack_layers(packed, cfg)


def tree_to(node, dev):
    from smoothquant_tpu_torch.kernels.pack import PackedLinear

    if isinstance(node, PackedLinear):
        return node.to(dev)
    if isinstance(node, dict):
        return {k: tree_to(v, dev) for k, v in node.items()}
    return None if node is None else node.to(dev)


# ---------------------------------------------------------------- kernels

SOURCES = {
    "int4_group_matmul_stacked_rawx": (
        "smoothquant_tpu_torch/kernels/csrc/int4_group_matmul.cu",
        "smoothquant_tpu/kernels/int4_group_matmul.py:649"),
    "int4_group_matmul": (
        "smoothquant_tpu_torch/kernels/csrc/int4_group_matmul.cu",
        "smoothquant_tpu/kernels/int4_group_matmul.py:950"),
    "write_quant_cache_smajor": (
        "smoothquant_tpu_torch/kernels/csrc/attn_smajor.cu",
        "smoothquant_tpu/kernels/attn_smajor.py:340"),
    "decode_attention_smajor_stacked": (
        "smoothquant_tpu_torch/kernels/csrc/attn_smajor.cu",
        "smoothquant_tpu/kernels/attn_smajor.py:213"),
}


def _sites(st):
    sa, mlp = st["self_attn"], st["mlp"]
    return (("qkv", sa["qkv_proj"], "rms"), ("o", sa["o_proj"], "mask"),
            ("gate_up", mlp["gate_up_proj"], "rms"), ("down", mlp["down_proj"], None))


def check_rawx(stacked, dev, gen):
    """K1 vs plain at the four decode linears of the stacked tree (N=4)."""
    import torch

    from smoothquant_tpu_torch.kernels import int4_group_matmul as k1
    from smoothquant_tpu_torch.kernels.real_linear import _salient_gather
    from smoothquant_tpu_torch.utils import roofline

    rows = []
    for site, lin, mode in _sites(stacked["layers"]["stacked"]):
        m = lin.meta
        n_layers, half, o = lin.w_qt.shape
        c = m.in_features
        x = torch.randn((MAX_BATCH, c), generator=gen, device=dev).to(torch.bfloat16)
        norm = None
        x_sal = [None] * n_layers
        if mode == "rms":
            norm = (torch.rand((n_layers, c), generator=gen, device=dev) + 0.5
                    ).to(torch.bfloat16).float()
        elif mode == "mask":
            norm = lin.ns_mask
            x_sal = [_salient_gather(lin, x, lin.perm[i]) for i in range(n_layers)]
        kw = dict(group_size=m.group_size, act_bits=m.act_bits,
                  num_salient=m.num_salient, eps=1e-5, norm_kind=mode)
        args = lambda i: (i % n_layers, x, norm, lin.w_qt, lin.w_scales_t, lin.w_sal_t,
                          x_sal[i % n_layers])
        got = k1.int4_group_matmul_stacked_rawx(*args(3), **kw)
        ref = k1.rawx_plain(*args(3), **kw)
        torch.cuda.synchronize()
        err = _close(f"K1 {site}", got, ref, 1e-2)
        w_lib = [torch.randn((c, o), generator=gen, device=dev).to(torch.bfloat16)
                 for _ in range(4)]
        n_bytes, ops = roofline.rawx_cost(MAX_BATCH, c, o, 2 * half, m.group_size,
                                          lin.w_sal_t.shape[1], norm=mode is not None,
                                          x_sal_external=mode == "mask")
        b_ms, b_by = roofline.bound_ms(n_bytes, ops)
        rows.append(dict(
            kernel="int4_group_matmul_stacked_rawx", site=site, mode=mode or "raw",
            shape=[MAX_BATCH, c, o], max_err=err,
            kernel_ms=device_ms(lambda i: k1.int4_group_matmul_stacked_rawx(*args(i), **kw),
                                n_layers),
            plain_ms=device_ms(lambda i: k1.rawx_plain(*args(i), **kw), 4, reps=3),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=device_ms(lambda i: x @ w_lib[i % 4], 16),
            library="torch.matmul bf16 (N, C) @ (C, O), yardstick only"))
        del w_lib
        emit(rows[-1])
    return rows


def check_gmm(packed, cfg, dev, gen):
    """K6 vs plain at the four prefill linears of the per-layer tree."""
    import torch

    from smoothquant_tpu_torch.kernels import int4_group_matmul as k6
    from smoothquant_tpu_torch.kernels.pack import quantize_activations_packed_int
    from smoothquant_tpu_torch.kernels.real_linear import _identity_nibble_quantize
    from smoothquant_tpu_torch.utils import roofline

    n_layers = cfg.num_hidden_layers
    rows = []
    for site_i, site in enumerate(("qkv", "o", "gate_up", "down")):
        lins = [_sites({"self_attn": packed["layers"][str(i)]["self_attn"],
                        "mlp": packed["layers"][str(i)]["mlp"]})[site_i][1]
                for i in range(n_layers)]
        m = lins[0].meta
        x = torch.randn((PREFILL_N, m.in_features), generator=gen,
                        device=dev).to(torch.bfloat16)
        if m.layout == "identity":
            xq = _identity_nibble_quantize(lins[0], x, lins[0].perm, lins[0].ns_mask)
        else:
            xq = quantize_activations_packed_int(x, m)
        x_q, x_s, x_sal = xq
        args = lambda i: (x_q, x_s, lins[i % n_layers].w_qt, lins[i % n_layers].w_scales_t,
                          x_sal, lins[i % n_layers].w_sal_t)
        kw = dict(group_size=m.group_size)
        got = k6.int4_group_matmul(*args(0), **kw)
        ref = k6.int4_group_matmul_plain(*args(0), **kw)
        torch.cuda.synchronize()
        err = _close(f"K6 {site}", got, ref, 1e-2)
        half, o = lins[0].w_qt.shape
        c = m.in_features
        w_lib = [torch.randn((c, o), generator=gen, device=dev).to(torch.bfloat16)
                 for _ in range(2)]
        n_bytes, ops = roofline.gmm_cost(PREFILL_N, o, 2 * half, m.group_size,
                                         lins[0].w_sal_t.shape[0])
        b_ms, b_by = roofline.bound_ms(n_bytes, ops)
        rows.append(dict(
            kernel="int4_group_matmul", site=site, shape=[PREFILL_N, c, o], max_err=err,
            kernel_ms=device_ms(lambda i: k6.int4_group_matmul(*args(i), **kw), 8),
            plain_ms=device_ms(lambda i: k6.int4_group_matmul_plain(*args(i), **kw), 2,
                               reps=3),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=device_ms(lambda i: x @ w_lib[i % 2], 8),
            library="torch.matmul bf16 (N, C) @ (C, O), yardstick only"))
        del w_lib
        emit(rows[-1])
    return rows


def _random_cache(cfg, dev, gen):
    import torch

    from smoothquant_tpu_torch.models.common import SMajorQuantKVCache

    c = SMajorQuantKVCache.create(MAX_BATCH, MAX_LEN, cfg.num_key_value_heads,
                                  cfg.head_dim, dev, n_layers=cfg.num_hidden_layers)
    for t in (c.k_q, c.v_q):
        t.copy_(torch.randint(-127, 128, t.shape, generator=gen, device=dev,
                              dtype=torch.int8))
    for t in (c.k_scale, c.v_scale):
        t.copy_(torch.rand(t.shape, generator=gen, device=dev) * 0.02 + 0.005)
    return c


def check_write_cache(cfg, dev, gen):
    """K2 vs plain: bit-exact rows and scales, one position past S-1."""
    import torch

    from smoothquant_tpu_torch.kernels import attn_smajor as ka
    from smoothquant_tpu_torch.models.common import rotary_cos_sin
    from smoothquant_tpu_torch.utils import roofline

    h, d = cfg.num_key_value_heads, cfg.head_dim
    pos = torch.tensor([100, MAX_LEN - 1, MAX_LEN + 88, 0], device=dev, dtype=torch.int32)
    k = torch.randn((MAX_BATCH, h, d), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((MAX_BATCH, h, d), generator=gen, device=dev).to(torch.bfloat16)
    cos, sin = rotary_cos_sin(pos.long()[:, None], d)
    a = _random_cache(cfg, dev, gen)
    b = type(a)(a.k_q.clone(), a.v_q.clone(), a.k_scale.clone(), a.v_scale.clone(), a.pos)
    bufs = lambda c: (c.k_q, c.v_q, c.k_scale, c.v_scale)
    last = cfg.num_hidden_layers - 1
    ka.write_quant_cache_smajor(last, pos, k, v, cos, sin, *bufs(a))
    ka.write_quant_cache_smajor_plain(last, pos, k, v, cos, sin, *bufs(b))
    torch.cuda.synchronize()
    err = max(_close(f"K2 {n}", x, y, 0.0) for n, x, y in zip(
        ("k_q", "v_q", "k_scale", "v_scale"), bufs(a), bufs(b)))
    n_layers = cfg.num_hidden_layers
    n_bytes, ops = roofline.write_cache_cost(MAX_BATCH, h, d)
    b_ms, b_by = roofline.bound_ms(n_bytes, ops)
    row = dict(
        kernel="write_quant_cache_smajor", shape=[MAX_BATCH, h, d, MAX_LEN], max_err=err,
        kernel_ms=device_ms(lambda i: ka.write_quant_cache_smajor(
            i % n_layers, pos, k, v, cos, sin, *bufs(a)), n_layers),
        plain_ms=device_ms(lambda i: ka.write_quant_cache_smajor_plain(
            i % n_layers, pos, k, v, cos, sin, *bufs(b)), 8, reps=3),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, library=None)
    emit(row)
    return [row]


def check_decode_attention(cfg, dev, gen):
    """K3 vs plain over a random S-major cache with ragged valid lengths;
    SDPA over the dequantized bf16 cache as the yardstick."""
    import torch
    import torch.nn.functional as F

    from smoothquant_tpu_torch.kernels import attn_smajor as ka
    from smoothquant_tpu_torch.models.common import decode_bias
    from smoothquant_tpu_torch.utils import roofline

    h, n_kv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    c = _random_cache(cfg, dev, gen)
    pos = torch.tensor([100, 300, MAX_LEN - 1, 50], device=dev)
    bias = decode_bias(pos, MAX_BATCH, MAX_LEN, None)
    q = torch.randn((MAX_BATCH, h, d), generator=gen, device=dev).to(torch.bfloat16)
    args = lambda i: (i, q, c.k_q, c.v_q, bias, c.k_scale, c.v_scale)
    n_layers = cfg.num_hidden_layers
    got = ka.decode_attention_smajor_stacked(*args(n_layers - 1))
    ref = ka.decode_attention_smajor_plain(*args(n_layers - 1))
    torch.cuda.synchronize()
    err = _close("K3", got, ref, 1e-2)

    def deq(qv, sc):
        x = qv.reshape(MAX_BATCH, MAX_LEN, n_kv, d).transpose(1, 2).float()
        return (x * sc[..., None]).to(torch.bfloat16)

    n_lib = min(4, n_layers)
    kd = [deq(c.k_q[i], c.k_scale[i]) for i in range(n_lib)]
    vd = [deq(c.v_q[i], c.v_scale[i]) for i in range(n_lib)]
    valid = (bias == 0)[:, None, None, :]
    n_bytes, ops = roofline.decode_attn_cost(MAX_BATCH, h, n_kv, MAX_LEN, d,
                                             n_valid=int(valid.sum()))
    b_ms, b_by = roofline.bound_ms(n_bytes, ops)
    row = dict(
        kernel="decode_attention_smajor_stacked", shape=[MAX_BATCH, h, n_kv, MAX_LEN, d],
        max_err=err,
        kernel_ms=device_ms(lambda i: ka.decode_attention_smajor_stacked(
            *args(i % n_layers)), n_layers),
        plain_ms=device_ms(lambda i: ka.decode_attention_smajor_plain(
            *args(i % n_layers)), 8, reps=3),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=device_ms(lambda i: F.scaled_dot_product_attention(
            q[:, :, None], kd[i % n_lib], vd[i % n_lib], attn_mask=valid), 16),
        library="scaled_dot_product_attention over the dequantized bf16 cache, "
                "yardstick only")
    emit(row)
    return [row]


# ---------------------------------------------------------------- end to end


def reference_check(dev):
    """Kernel path (card) vs plain path (CPU) on a small model with the
    same weights: logits of a batched prefill and of one stacked decode
    step, f32 and bf16."""
    import dataclasses

    import torch

    from smoothquant_tpu_torch.models import llama
    from smoothquant_tpu_torch.models.common import SMajorQuantKVCache

    out = {}
    for dtype_name, rel in (("float32", 2e-2), ("bfloat16", 5e-2)):
        cfg = dataclasses.replace(
            llama.LlamaConfig.tiny(), hidden_size=512, intermediate_size=512,
            num_attention_heads=8, num_key_value_heads=8, num_hidden_layers=2,
            dtype=dtype_name)
        packed, stacked = build_model(cfg, "cpu", SEED, group_size=16, align_o=256)
        gen = torch.Generator().manual_seed(SEED + 1)
        prompt = torch.randint(0, cfg.vocab_size, (2, 12), generator=gen)
        logits = {}
        for name, d in (("plain", "cpu"), ("kernel", dev)):
            p, s = tree_to(packed, d), tree_to(stacked, d)
            cache = SMajorQuantKVCache.create(2, 128, cfg.num_key_value_heads,
                                              cfg.head_dim, d,
                                              n_layers=cfg.num_hidden_layers)
            h, _ = llama.forward_hidden(p, prompt.to(d), cfg, caches=[
                cache.layer(i) for i in range(cfg.num_hidden_layers)])
            pre = llama.lm_head_logits(p, h[:, -1:], cfg)
            cache.pos[:] = prompt.shape[1]
            mask = torch.zeros((2, 128), dtype=torch.bool, device=d)
            mask[:, :prompt.shape[1] + 1] = True
            step, _ = llama.forward(s, prompt[:, -1:].to(d), cfg, caches=cache,
                                    attn_mask=mask)
            logits[name] = torch.cat([pre, step], dim=1).cpu()
        got, ref = logits["kernel"], logits["plain"]
        if not (torch.isfinite(got).all() and got.shape == (2, 2, cfg.vocab_size)):
            raise AssertionError("reference check: non-finite or misshapen logits")
        out[dtype_name] = dict(
            max_abs_err=_close(f"reference check {dtype_name}", got, ref, rel),
            tolerance_rel_to_max=rel,
            argmax_agree=float((got.argmax(-1) == ref.argmax(-1)).float().mean()))
    return out


def serve(packed, stacked, cfg, dev):
    """Serve requests through the batcher; return metrics and launches."""
    import numpy as np
    import torch

    from smoothquant_tpu_torch.kernels import _build
    from smoothquant_tpu_torch.models import llama
    from smoothquant_tpu_torch.serve.batching import ContinuousBatcher, Request

    batcher = ContinuousBatcher(llama, stacked, cfg, max_batch=MAX_BATCH,
                                max_len=MAX_LEN, quant_kv=True,
                                prefill_params=packed, smajor=True, device=dev)
    prefill = {"calls": 0, "tokens": 0, "s": 0.0}
    inner = batcher._prefill

    def timed_prefill(ids, lens):
        t0 = time.perf_counter()
        r = inner(ids, lens)
        torch.cuda.synchronize()
        prefill["s"] += time.perf_counter() - t0
        prefill["calls"] += 1
        prefill["tokens"] += int(np.minimum(lens, ids.shape[1]).sum())
        return r

    batcher._prefill = timed_prefill
    rng = np.random.default_rng(SEED + 42)

    def make(n, uid0, new):
        return [Request(uid=uid0 + i, prompt=rng.integers(
            0, cfg.vocab_size, size=(int(rng.integers(100, 240)),)),
            max_new_tokens=new) for i in range(n)]

    for r in make(4, 1000, 8):                     # warm-up wave
        batcher.submit(r)
    batcher.run_to_completion(chunk=8)
    torch.cuda.synchronize()

    reqs = make(8, 0, 32)
    for r in reqs:
        batcher.submit(r)
    prefill.update(calls=0, tokens=0, s=0.0)
    steps0 = batcher._steps
    _build.reset_launches()
    t0 = time.perf_counter()
    batcher.run_to_completion(chunk=8)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    steps = batcher._steps - steps0
    toks = [t for r in reqs for t in r.generated]
    if not (all(r.done and len(r.generated) == 32 for r in reqs)
            and all(0 <= t < cfg.vocab_size for t in toks)):
        raise AssertionError("serving: unfinished request or token out of range")
    n_l = cfg.num_hidden_layers
    expect = {"int4_group_matmul_stacked_rawx": 4 * n_l * steps,
              "write_quant_cache_smajor": n_l * steps,
              "decode_attention_smajor_stacked": n_l * steps,
              "int4_group_matmul": 4 * n_l * prefill["calls"]}
    if launches != expect:
        raise AssertionError(f"launch counts {launches} != expected {expect}")

    steady = make(4, 2000, 64)                     # decode-only window
    for r in steady:
        batcher.submit(r)
    batcher.step_chunk(8)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(4):
        batcher.step_chunk(8)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t1
    trace = profile_decode(batcher, 4)
    batcher.run_to_completion(chunk=8)
    return dict(
        requests=len(reqs), generated_tokens=len(toks), decode_steps=steps,
        prefill_calls=prefill["calls"], serving_wall_s=wall,
        serving_tokens_per_s=len(toks) / wall,
        prefill_tokens_per_s=prefill["tokens"] / prefill["s"],
        decode_ms_per_step=1e3 * decode_s / 32,
        decode_tokens_per_s=32 * MAX_BATCH / decode_s, decode_trace=trace), launches


def profile_decode(batcher, k: int) -> dict:
    """Device time of k decode steps (all slots active) under
    torch.profiler: busy ms per step, the idle share of the wall time, and
    the kernels that take the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        batcher.step_chunk(k)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name: dict = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.time_range.elapsed_us()
    busy_ms = sum(by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return dict(steps=k, wall_ms_per_step=1e3 * wall / k, busy_ms_per_step=busy_ms / k,
                idle_share=1.0 - busy_ms / (1e3 * wall),
                top_ms_per_step=[[name[:60], us / 1e3 / k] for name, us in top])


def kernels_line(rows, launches):
    """One entry per kernel: K1 and K6 sum their four call sites (one
    layer's worth of work), the errors are the largest seen."""
    out = []
    for name, (src, replaces) in SOURCES.items():
        rs = [r for r in rows if r["kernel"] == name]
        lib = [r["library_ms"] for r in rs]
        bound = sum(r["bound_ms"] for r in rs)
        out.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches.get(name, 0),
            max_abs_err=max(r["max_err"] for r in rs),
            ms=sum(r["kernel_ms"] for r in rs), plain_ms=sum(r["plain_ms"] for r in rs),
            bound_ms=bound,
            bound_by=max(rs, key=lambda r: r["bound_ms"])["bound_by"],
            library_ms=None if None in lib else sum(lib),
            sites=[r.get("site", "all") for r in rs]))
    return {"kernels": out}


def main() -> int:
    try:
        import torch
    except ImportError:
        _die("torch is not installed")
    if not torch.cuda.is_available():
        _die("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    try:
        from smoothquant_tpu_torch.kernels import _build
        from smoothquant_tpu_torch.models import llama
        from smoothquant_tpu_torch.utils import roofline
    except ImportError as e:
        _die(f"the port package is not importable beside this script: {e}")

    dev = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    emit({"phase": "env", "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()})

    t0 = time.perf_counter()
    _build.lib()
    ptx = [ln.strip() for ln in _build.build_log.splitlines()
           if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "ptxas": ptx})

    cfg = llama.LlamaConfig.llama2_7b()
    t0 = time.perf_counter()
    packed, stacked = build_model(cfg, dev, SEED)
    torch.cuda.synchronize()
    emit({"phase": "model", "seconds": time.perf_counter() - t0,
          "layers": cfg.num_hidden_layers,
          "gib_allocated": torch.cuda.memory_allocated() / 2 ** 30,
          "decode_step_bytes": roofline.llama_decode_step_bytes(cfg)})

    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    rows = (check_rawx(stacked, dev, gen) + check_gmm(packed, cfg, dev, gen)
            + check_write_cache(cfg, dev, gen) + check_decode_attention(cfg, dev, gen))

    emit({"phase": "reference_check", **reference_check(dev)})

    metrics, launches = serve(packed, stacked, cfg, dev)
    emit({"phase": "serving", "card": card, **metrics, "launches": launches})

    emit(kernels_line(rows, launches))
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
