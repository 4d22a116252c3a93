"""Least-time bounds on an NVIDIA H100 for the port's kernels and for one
decode step of the packed Llama, the bf16 Llama, the int8 OPT and the
packed Bloom.

A bound is the larger of (bytes the function must move: each input read
once, each output written once) / HBM rate and (operations / the peak rate
of their type).  Peaks: NVIDIA's H100 SXM data sheet, dense, at the full
700 W power limit.

    python -m smoothquant_tpu_torch.utils.roofline
    # Llama-2-7B W4A4 (B = 4 and 64) / bf16, OPT-1.3B int8, BLOOM-7b1 W4A4 (B = 4 and 64)
"""

from __future__ import annotations

import json

H100_SXM = {
    "name": "H100 SXM",
    "hbm_bytes_per_s": 3.35e12,
    "ops_per_s": {"int8": 1979e12, "bf16": 989e12, "f32": 67e12},
}


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def bound_ms(n_bytes: float, ops: dict, chip=H100_SXM) -> tuple[float, str]:
    """(least time in ms, "bytes" or "operations") for the given work."""
    t_bytes = n_bytes / chip["hbm_bytes_per_s"]
    t_ops = sum(n / chip["ops_per_s"][kind] for kind, n in ops.items())
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def rawx_cost(n, c, o, kk, gs, k_s, *, x_bytes=2, scale_bytes=2, norm=True,
              x_sal_external=False):
    """K1 for one layer: x (N, C), the norm or mask row, nibble weights
    (kk/2, O), group scales (kk/gs, O), salient block (k_s, O), an external
    x_sal (N, k_s), out (N, O)."""
    b = (n * c * x_bytes + (c * 4 if norm else 0) + kk // 2 * o
         + kk // gs * o * scale_bytes + k_s * o * x_bytes
         + (n * k_s * x_bytes if x_sal_external else 0) + n * o * x_bytes)
    return b, {"int8": 2 * n * o * kk, "bf16": 2 * n * o * k_s}


def gmm_cost(n, o, kk, gs, k_s, *, x_bytes=2, scale_bytes=2):
    """K6, and K5 on one layer: x_q (N, kk) int8, x_scales (N, G) f32,
    nibble weights, scales, x_sal (N, k_s), salient block, out (N, O)."""
    g = kk // gs
    b = (n * kk + n * g * 4 + kk // 2 * o + g * o * scale_bytes
         + n * k_s * x_bytes + k_s * o * x_bytes + n * o * x_bytes)
    return b, {"int8": 2 * n * o * kk, "bf16": 2 * n * o * k_s}


H100_SMS, H100_FP32_LANES = 132, 128    # SMs; f32 lanes an SM issues to a clock
SCALING_INSTRS = 3                       # f32-pipe instructions a per-group scaling


def group_scaling_floor_ms(n, o, kk, gs, sm_clock_mhz: float, *, sms=H100_SMS,
                           lanes=H100_FP32_LANES) -> float:
    """Least time in ms of the per-group scaling that K5, K6 and K8 run on
    the CUDA cores: N·O·G scalings acc += ((p − 8Σx)·s_x)·s_w, each of
    SCALING_INSTRS f32-pipe instructions with no int → float conversion (an
    add of the magic number's bias is on the integer pipe), at sms × lanes
    lanes a clock of sm_clock_mhz (`nvidia-smi --query-gpu=clocks.max.sm`).
    Beside bound_ms, not in it: it is the floor of this algorithm, not of
    the function."""
    scalings = n * o * -(-kk // gs)
    return 1e3 * scalings * SCALING_INSTRS / (sms * lanes * sm_clock_mhz * 1e6)


def int_group_matmul_cost(n, o, kk, gs, k_s, *, x_bytes=2, scale_bytes=4, out_bytes=2):
    """K8, counted as the JAX CostEstimate counts it (int_group_matmul.py:
    167-173) at the unpadded shapes: x_q (N, K) and the weight (K, O) int8,
    x_scales (N, G) and w_scales (G, O), x_sal (N, k_s) and the salient block
    (k_s, O), out (N, O); int8 operations for the groups, bf16 (x_bytes 2)
    or f32 ones for the salient dot.  kk and k_s are the true widths (the
    pack pads both); the scales count the groups kk reaches."""
    g = -(-kk // gs)
    n_bytes = (n * kk + o * kk + n * g * 4 + o * g * scale_bytes
               + (n + o) * k_s * x_bytes + n * o * out_bytes)
    return n_bytes, {"int8": 2 * n * o * kk, _fp_kind(x_bytes): 2 * n * o * k_s}


def dual_path_matmul_cost(n, o, k_ns, gs, k_s, *, x_bytes=2, scale_bytes=4, out_bytes=2):
    """K9, counted as the JAX CostEstimate counts it (quant_matmul.py:237-243)
    at the unpadded shapes: x_ns (N, K_ns) and x_sal (N, k_s) in the compute
    dtype, the int8 weight (K_ns, O), its scales (max(K_ns // gs, 1), O),
    the salient block (k_s, O), out (N, O); every product in the compute
    dtype (bf16 on the tensor cores, f32 on the CUDA cores).  k_ns and k_s
    are the true widths (the pack pads both); the scales count the groups
    k_ns reaches."""
    g = -(-k_ns // gs)
    n_bytes = (n * (k_ns + k_s) * x_bytes + o * k_ns + o * g * scale_bytes
               + o * k_s * x_bytes + n * o * out_bytes)
    return n_bytes, {_fp_kind(x_bytes): 2 * n * o * (k_ns + k_s)}


def _fp_kind(x_bytes: int) -> str:
    return "bf16" if x_bytes == 2 else "f32"


def act_quant_cost(n, k_ns, gs, *, x_bytes=2):
    """K7a: x_ns (N, k_ns) in, x3 (G, N_pad, gs) int8 and xs_t (G, N_pad)
    f32 out; about three f32 operations an element (|x| and max, divide,
    round)."""
    n_pad = max(8, -(-n // 8) * 8)
    return (n * k_ns * x_bytes + n_pad * k_ns + k_ns // gs * n_pad * 4,
            {"f32": 3 * n * k_ns})


def norm_quant_acts_cost(n, c, k_ns, gs, k_s, *, x_bytes=2, sal_bytes=2, norm_row=True):
    """K7b: x (N, C), the f32 norm row (C,) in (K7a with the salient split:
    no norm row); x3 (G, N_pad, gs) int8, xs_t (G, N_pad) f32 and x_sal
    (N_pad, k_s) out; about five f32 operations an element (the square and
    sum, two products, |y| and max, divide, round — the rows' norm sums
    counted once)."""
    n_pad = max(8, -(-n // 8) * 8)
    return (n * c * x_bytes + (c * 4 if norm_row else 0) + n_pad * k_ns
            + k_ns // gs * n_pad * 4 + n_pad * k_s * sal_bytes, {"f32": 5 * n * c})


def write_cache_cost(b, h, d, *, x_bytes=2, rotary=True, q_heads=0, table_rows=None,
                     aligned=False):
    """K2 and K10: k, v (B, H, D), cos/sin (table_rows, D) f32 (with rotary;
    B rows by default), the positions (one with aligned); one int8 row and
    one f32 scale per (b, head) for k and for v; with q_heads, the queries
    (B, q_heads, D) read and written rotated.  The rotary's three f32
    operations an element (two products and a sum) go with its tables."""
    table_rows = b if table_rows is None else table_rows
    tables = 2 * table_rows * d * 4 if rotary else 0
    n_bytes = (2 * b * h * d * x_bytes + tables + (4 if aligned else b * 4)
               + 2 * (b * h * d + b * h * 4) + 2 * b * q_heads * d * x_bytes)
    return n_bytes, {"f32": (6 if rotary else 4) * b * h * d + 3 * b * q_heads * d}


def decode_attn_cost(b, h, n_kv, s, d, *, n_valid=None, x_bytes=2,
                     value_bytes=1, scale_bytes=4):
    """K3 / K11 over one layer: q, the (B, S) bias, out, and the k/v rows
    (value_bytes per element: 1 for the int8 cache, 2 for bf16) and their
    scales (scale_bytes: 4 for the int8 cache, 0 for an fp one) of the
    n_valid (slot, position) pairs the bias leaves unmasked (all B·S by
    default): a masked position adds exactly 0, so the least work skips it."""
    n_valid = b * s if n_valid is None else n_valid
    n_bytes = (2 * b * h * d * x_bytes + b * s * 4
               + n_valid * 2 * n_kv * (d * value_bytes + scale_bytes))
    return n_bytes, {"bf16": 4 * h * n_valid * d}


def fused_attn_cost(b, h, n_kv, s, d, pos, *, x_bytes=2, write=False):
    """K12 over one layer at aligned position pos: q and out (B, H, D), the
    new k / v (B, H_kv, D), the (B, D) f32 rotary tables and the position,
    the int8 k / v rows and f32 scales of the min(pos, S) positions below
    pos in every (slot, kv head) — the columns from pos on are masked and
    never read — and, for the write body, the row and scale it writes.
    Operations: q·k and p·v over those positions and the new one."""
    n_valid = b * min(pos, s)
    row = 2 * b * n_kv * (d + 4)
    n_bytes = (2 * b * h * d * x_bytes + 2 * b * n_kv * d * x_bytes + 2 * b * d * 4 + 4
               + n_valid * 2 * n_kv * (d + 4) + (row if write else 0))
    return n_bytes, {"bf16": 4 * h * (n_valid + b) * d}


def mlp_fused_cost(n, c, o1, kk1, k_s1, o2, kk2, k_s2, gs, *, x_bytes=2, scale_bytes=2,
                   norm=True):
    """K14 for one layer: rawx_cost of gate_up and of down combined, without
    the activations between them (they stay on the chip): x (N, C), the
    norm row, both linears' nibbles, group scales and salient blocks, out
    (N, O2)."""
    n_bytes = (n * c * x_bytes + (c * 4 if norm else 0)
               + kk1 // 2 * o1 + kk1 // gs * o1 * scale_bytes + k_s1 * o1 * x_bytes
               + kk2 // 2 * o2 + kk2 // gs * o2 * scale_bytes + k_s2 * o2 * x_bytes
               + n * o2 * x_bytes)
    return n_bytes, {"int8": 2 * n * (o1 * kk1 + o2 * kk2),
                     "bf16": 2 * n * (o1 * k_s1 + o2 * k_s2)}


def int8_prefill_cost(n, kk, o, k_s, *, sal_bytes=2, out_bytes=2):
    """K4: x8 (N, K), the int8 weight (K, O), s_x (N) and s_w (O) f32, the
    salient x (N, k_s) and block (k_s, O), out (N, O); int8 and bf16
    operations."""
    n_bytes = (n * kk + kk * o + 4 * (n + o) + (n + o) * k_s * sal_bytes
               + n * o * out_bytes)
    return n_bytes, {"int8": 2 * n * kk * o, "bf16": 2 * n * k_s * o}


def int8_prefill_rawx_cost(n, kk, o, k_s, *, n_masked=0, x_bytes=2, out_bytes=2):
    """K4's raw-x mode: the f32 mask (K,), the raw x and the int8 weight rows
    of the K − n_masked channels the mask keeps (a masked channel adds
    exactly 0, so the least work reads neither its x column nor its weight
    row), s_x and s_w, the salient x (N, k_s) and block (k_s, O) in x's
    dtype, out (N, O); int8 and salient-dtype operations, and the
    quantize's three f32 operations an element."""
    k_int = kk - n_masked
    n_bytes = (kk * 4 + n * k_int * x_bytes + k_int * o + 4 * (n + o)
               + (n + o) * k_s * x_bytes + n * o * out_bytes)
    return n_bytes, {"int8": 2 * n * k_int * o, _fp_kind(x_bytes): 2 * n * k_s * o,
                     "f32": 3 * n * k_int}


def fp_matmul_cost(n, kk, o, *, x_bytes=2):
    """K13: x (N, K), one layer's weight slab (K, O), out (N, O)."""
    return (n * kk + kk * o + n * o) * x_bytes, {"bf16": 2 * n * kk * o}


def int8_linear_cost(n, o, kk, *, out_bytes=4, bias=True):
    """K15a (smoothquant_tpu/utils/roofline.py:72): x (N, K) and w (O, K)
    int8, the f32 bias (O,), out (N, O) f32 or int8."""
    return (n * kk + o * kk + (4 * o if bias else 0) + n * o * out_bytes,
            {"int8": 2 * n * o * kk})


def int8_bmm_cost(batch, m, n, kk, *, out_bytes=4):
    """K15b: a (B, M, K) and b (B, N, K) int8, out (B, M, N) f32 or int8."""
    return (batch * (m * kk + n * kk + m * n * out_bytes),
            {"int8": 2 * batch * m * n * kk})


def norm_quant_cost(n, c, *, x_bytes=4):
    """K16: x (N, C), γ and β (C,) f32, out (N, C) int8; about eight f32
    operations an element (two sums, centre, square, scale, fma, quantize)."""
    return n * c * x_bytes + 2 * c * 4 + n * c, {"f32": 8 * n * c}


def opt_int8_decode_step_bytes(cfg, batch=4, max_len=1024, emb_bytes=2) -> dict:
    """Bytes one int8 OPT decode step must stream, as the JAX path runs it:
    every layer's int8 weights (q, k, v, out, fc1, fc2), f32 biases and
    LayerNorm rows, the WHOLE int8 k / v cache of every layer (the path
    masks it rather than cutting it to the filled length), and the bf16
    embedding matrix of the tied unembedding."""
    h, ffn = cfg.hidden_size, cfg.ffn_dim
    per_linear = {"q": h * h, "k": h * h, "v": h * h, "out": h * h,
                  "fc1": h * ffn, "fc2": ffn * h}
    layer_w = sum(per_linear.values()) + 4 * (5 * h + ffn) + 4 * 4 * h
    layer_kv = 2 * batch * max_len * h
    emb = cfg.vocab_size * cfg.embed_dim * emb_bytes
    total = cfg.num_hidden_layers * (layer_w + layer_kv) + emb
    return {"per_linear": per_linear, "layer_weights": layer_w, "layer_kv": layer_kv,
            "embedding": emb, "total": total, "bound_ms": bound_ms(total, {})[0]}


def llama_pack_shapes(cfg, group_size=64, salient_prop=0.05, align_k_groups=8,
                      align_o=2048):
    """(C, O_pad, kk, k_s) of the four packed linears that pack_model builds
    with the bench recipe (fused qkv / gate_up, identity o_proj)."""
    h, inter = cfg.hidden_size, cfg.intermediate_size
    kv = cfg.num_key_value_heads * cfg.head_dim
    step = 2 * group_size * align_k_groups

    def shape(c, o, identity=False):
        k = max(1, int(salient_prop * c)) if salient_prop > 0 else 0
        kk = (_ceil_to(c, step) if identity
              else _ceil_to(_ceil_to(max(c - k, 1), group_size), step))
        return c, _ceil_to(o, align_o), kk, _ceil_to(k, 128) if k else 0

    return {"qkv": shape(h, h + 2 * kv), "o": shape(h, h, identity=True),
            "gate_up": shape(h, 2 * inter), "down": shape(inter, h)}


def llama_decode_step_bytes(cfg, batch=4, max_len=512, group_size=64,
                            salient_prop=0.05, align_k_groups=8, align_o=2048,
                            scale_bytes=2, act_bytes=2) -> dict:
    """Bytes one decode step must stream: every packed weight byte (nibbles,
    group scales, bf16 salient blocks), the int8 KV cache and its scales,
    and the int8 lm_head with its f32 column scales."""
    per_linear = {}
    for name, (c, o, kk, k_s) in llama_pack_shapes(
            cfg, group_size, salient_prop, align_k_groups, align_o).items():
        per_linear[name] = {
            "nibbles": kk // 2 * o, "scales": kk // group_size * o * scale_bytes,
            "salient": k_s * o * act_bytes}
    layer_w = sum(sum(v.values()) for v in per_linear.values())
    kv = (2 * batch * max_len * cfg.num_key_value_heads * cfg.head_dim
          + 2 * batch * cfg.num_key_value_heads * max_len * 4)
    lm_head = cfg.hidden_size * cfg.vocab_size + cfg.vocab_size * 4
    total = cfg.num_hidden_layers * (layer_w + kv) + lm_head
    return {"per_linear": per_linear, "layer_weights": layer_w,
            "layer_kv": kv, "lm_head": lm_head, "total": total,
            "bound_ms": bound_ms(total, {})[0]}


def llama_bf16_decode_step_bytes(cfg, batch=4, max_len=512, w_bytes=2,
                                 kv_bytes=2) -> dict:
    """Bytes one step of the bf16 decode baseline must stream: every
    projection weight of every layer, the bf16 KV cache (a full cache, as
    llama_decode_step_bytes counts it) and the bf16 lm_head."""
    h, inter = cfg.hidden_size, cfg.intermediate_size
    kv = cfg.num_key_value_heads * cfg.head_dim
    per_linear = {"qkv": h * (h + 2 * kv) * w_bytes, "o": h * h * w_bytes,
                  "gate_up": h * 2 * inter * w_bytes, "down": inter * h * w_bytes}
    layer_w = sum(per_linear.values())
    layer_kv = 2 * batch * max_len * kv * kv_bytes
    lm_head = cfg.vocab_size * h * w_bytes
    total = cfg.num_hidden_layers * (layer_w + layer_kv) + lm_head
    return {"per_linear": per_linear, "layer_weights": layer_w, "layer_kv": layer_kv,
            "lm_head": lm_head, "total": total, "bound_ms": bound_ms(total, {})[0]}


def bloom_pack_shapes(cfg, group_size=64, salient_prop=0.05, align_k_groups=8, align_o=256):
    """(C, O, O_pad, kk, k_ns_true, k_s, n_sal) of Bloom's four packed
    linears, as pack_model builds them per layer (no identity layout)."""
    h = cfg.hidden_size
    step = 2 * group_size * align_k_groups

    def shape(c, o):
        k = max(1, int(salient_prop * c)) if salient_prop > 0 else 0
        kk = _ceil_to(_ceil_to(max(c - k, 1), group_size), step)
        return c, o, _ceil_to(o, align_o), kk, c - k, _ceil_to(k, 128) if k else 0, k

    return {"query_key_value": shape(h, 3 * h), "dense": shape(h, h),
            "dense_h_to_4h": shape(h, 4 * h), "dense_4h_to_h": shape(4 * h, h)}


def bloom_decode_step_bytes(cfg, batch=4, max_len=512, group_size=64, salient_prop=0.05,
                            align_k_groups=8, align_o=256, scale_bytes=4, act_bytes=2,
                            emb_bytes=2) -> dict:
    """Bytes one decode step of the packed Bloom must stream: every packed
    linear's nibbles, group scales and salient block (at the true widths:
    k_ns and num_salient, the pack pads both) and its bias, the LayerNorm
    rows, the int8 k / v cache of every layer with its f32 scales (the whole
    cache, as the Llama bound counts it), and the tied bf16 word embeddings
    the unembedding reads (vocab × hidden, every step)."""
    per_linear = {}
    for name, (c, o, _o_pad, _kk, k_ns, _k_s, n_sal) in bloom_pack_shapes(
            cfg, group_size, salient_prop, align_k_groups, align_o).items():
        per_linear[name] = {
            "nibbles": k_ns * o // 2, "scales": -(-k_ns // group_size) * o * scale_bytes,
            "salient": n_sal * o * act_bytes, "bias": o * act_bytes}
    h = cfg.hidden_size
    layer_w = sum(sum(v.values()) for v in per_linear.values()) + 4 * h * act_bytes
    kv = 2 * batch * max_len * h + 2 * batch * cfg.num_attention_heads * max_len * 4
    embedding = cfg.vocab_size * h * emb_bytes
    total = cfg.num_hidden_layers * (layer_w + kv) + embedding + 2 * h * act_bytes
    return {"per_linear": per_linear, "layer_weights": layer_w, "layer_kv": kv,
            "embedding": embedding, "total": total, "bound_ms": bound_ms(total, {})[0]}


if __name__ == "__main__":
    from smoothquant_tpu_torch.models.bloom import BloomConfig
    from smoothquant_tpu_torch.models.llama import LlamaConfig
    from smoothquant_tpu_torch.models.opt import OPTConfig

    cfg = LlamaConfig.llama2_7b()
    # BLOOM-7b1 (bigscience/bloom-7b1 config.json: hidden 4096, 30 layers, 32 heads)
    bloom_7b1 = BloomConfig(hidden_size=4096, num_hidden_layers=30, num_attention_heads=32)
    print(json.dumps({"w4a4": llama_decode_step_bytes(cfg),
                      "w4a4_b64": llama_decode_step_bytes(cfg, batch=64),
                      "bf16": llama_bf16_decode_step_bytes(cfg),
                      "opt_1_3b_int8": opt_int8_decode_step_bytes(OPTConfig.opt_1_3b()),
                      "bloom_7b1_w4a4": bloom_decode_step_bytes(bloom_7b1),
                      "bloom_7b1_w4a4_b64": bloom_decode_step_bytes(bloom_7b1, batch=64)},
                     indent=1))
