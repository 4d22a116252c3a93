"""chip_smoke.py's contract on a machine without a card: it exits non-zero
and prints no result, from the repo and from a directory that holds the
script alone."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_cuda(alone, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    script = os.path.join(ROOT, "chip_smoke.py")
    cwd = ROOT
    if alone:
        cwd = str(tmp_path)
        script = shutil.copy(script, cwd)
    run = subprocess.run([sys.executable, script], cwd=cwd, capture_output=True,
                         text=True, timeout=120)
    assert run.returncode != 0
    assert run.stdout == ""
    assert "cuda" in run.stderr.lower()


def test_opt_path_rehearsal_on_cpu(monkeypatch):
    """chip_smoke's OPT phases end to end on the CPU at a small size: the
    export, the K15a / K15b / K16 phases (the wrappers take their plain
    versions here), the reference check, the accuracy check, the prefill
    and the Generator; timing and the launch checks are stubbed (nothing
    launches on the CPU), the launch counts each phase expects recorded."""
    import dataclasses

    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from smoothquant_tpu_torch.models.opt import OPTConfig

    for name, value in dict(CALIB_SAMPLES=2, CALIB_LEN=32, OPT_BATCH=2, OPT_PROMPT=40,
                            OPT_NEW=4, OPT_MAX_LEN=128, OPT_SERVE_LEN=128, SERVE_REQUESTS=3,
                            SERVE_NEW=4, SERVE_PROMPT=(10, 40), OPT_IO_WINDOW=64,
                            K15A_EDGE_SHAPES=((3, 208, 77), (130, 200, 77))).items():
        monkeypatch.setattr(cs, name, value)
    monkeypatch.setattr(cs, "_launched", lambda key, fn: fn())   # plain versions count nothing
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda *a, **k: 0)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a, **k: None)
    monkeypatch.setattr(cs, "device_ms", lambda fn, n_iter, reps=5: (fn(0), 0.0)[1])
    monkeypatch.setattr(cs, "profile", lambda fn, steps: (
        fn(), {"idle_share": 0.5, "busy_ms_per_step": 0.0})[1])
    expected = {}
    monkeypatch.setattr(cs, "_check_launches",
                        lambda path, launches, expect: expected.setdefault(path, expect))
    printed = []
    monkeypatch.setattr(cs, "emit", printed.append)

    cfg = dataclasses.replace(OPTConfig.tiny(vocab_size=512), hidden_size=128, ffn_dim=256,
                              num_attention_heads=2)
    rows, launches = cs.run_opt(torch.device("cpu"), cfg, "card")
    assert sum(launches.values()) == 0
    by_kernel = {}
    for r in rows:
        by_kernel.setdefault(r["kernel"], []).append(r["site"])
        assert r["max_err"] == 0 and r["n_diff"] == 0
    assert len(by_kernel["int8_linear"]) == 12 and len(by_kernel["int8_bmm"]) == 4
    assert len(by_kernel["norm_quant"]) == 2
    # K16's row body, its plan per row count, the block body timed beside
    k16 = [r for r in rows if r["kernel"] == "norm_quant"]
    assert [r["plan"] for r in k16] == [[4, 1, True], [4, 1, True]]
    assert all("old_body_ms" in r for r in k16)
    # K15b's launches by body: QKᵀ and PV of a prefill on the qk and pv
    # bodies, of one query over the cache on the nk and kn GEMVs
    prefill = {"norm_quant": 4, "int8_linear": 12, "int8_bmm_qk": 2, "int8_bmm_pv": 2}
    step = {"norm_quant": 4, "int8_linear": 12, "int8_bmm_nk": 2, "int8_bmm_kn": 2}
    assert expected["int8 OPT prefill"] == prefill
    assert expected["int8 OPT decode step"] == step
    assert expected["int8 OPT generator"] == {
        k: prefill.get(k, 0) + 3 * step.get(k, 0) for k in {*prefill, *step}}
    assert [r["body"] for r in rows if r["kernel"] == "int8_bmm"] == [
        "qk", "pv", "nk_gemv", "kn_gemv"]
    assert all(r["old_body"] in ("tiles", "gemv") for r in rows if r["kernel"] == "int8_bmm")
    # K15a: the stream kind at the decode rows, the wgmma body at the
    # prefill's, PR 3's kernels timed beside
    assert [(r["body"], r["old_body"]) for r in rows if r["kernel"] == "int8_linear"] == (
        [("wg", "tiles")] * 6 + [("stream", "gemv")] * 6)
    phases = {p["phase"]: p for p in printed if "phase" in p}
    assert phases["k15a_edges"]["bit_exact_cases"] == {"stream": 3, "wg": 3}
    assert phases["k15a_row_crossover"]["rows"] == list(cs.K15A_CROSSOVER_N)
    assert set(phases["k15a_row_crossover"]["ms"][64]) == {"stream", "wg"}
    assert phases["opt_reference_check"]["float32"]["rel_norm_err"] < 5e-2
    # prompt, two warm-up steps, the counted step, three windows of 8, the profile
    assert phases["opt_generator"]["position_after"] == 40 + 2 + 1 + 3 * 8 + 4
    for s in ("tokens_40", "tokens_32"):
        assert 0.0 <= phases["opt_accuracy"][s]["top1_agree"] <= 1.0
    # the fp per-layer OPT through the batcher: no kernel, tokens held
    assert expected["serve_families opt"] == {}
    fam = phases["serve_families"]
    assert fam["family"] == "opt" and fam["tree"] == "per-layer fp"
    assert fam["tokens"]["requests"] == 3
    # cli_opt: the four CLIs on the export's weights as an HF directory, the
    # exported file bit for bit export_opt's, its Generator's tokens and
    # launches opt_generator's
    cli = phases["cli_opt"]
    assert cli["int8_bit_equal"] and cli["generator_tokens_identical"]
    assert expected["cli_opt generator"] == expected["int8 OPT generator"]
    assert set(cli["cli_s"]) == {"generate_act_scales", "export_int8_model", "ppl_eval",
                                 "run_experiments"}
    assert cli["cli_out"]["generate_act_scales"].startswith("saved ")
    assert cli["cli_out"]["export_int8_model"].startswith("saved INT8 OPT model")
    assert cli["cli_json"]["ppl_eval"]["smooth"] and cli["cli_json"]["ppl_eval"]["quantize"]
    assert [(r["group_size"], r["salient_prop"]) for r in cli["results"]] == [
        (64, 0.0), (128, 0.0), (64, 0.05), (128, 0.05)]


def test_slot_path_rehearsal_on_cpu(monkeypatch):
    """chip_smoke's phases of the 64-slot slice on the CPU at a small size
    (40 slots, 44 requests, 2 layers of hidden 512): the K1 phases at 16
    and 32 rows, K7a, K5 and K10 (the wrappers take their plain versions
    here), serving over the head-major pool with the promoted twin, and the
    B = 40 / B = 32 decode steps; timing and the launch checks are stubbed,
    the launch counts each path expects recorded."""
    import dataclasses

    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from smoothquant_tpu_torch.kernels import kv_write
    from smoothquant_tpu_torch.models.llama import LlamaConfig

    monkeypatch.setattr(cs, "SLOT_BATCH", 40)
    monkeypatch.setattr(cs, "SLOT_REQUESTS", 44)
    # K10's block-size sweep launches the row body itself, which the CPU has not
    monkeypatch.setattr(kv_write, "launch_rows", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a, **k: None)
    monkeypatch.setattr(cs, "device_ms", lambda fn, n_iter, reps=5: (fn(0), 0.0)[1])
    monkeypatch.setattr(cs, "profile", lambda fn, steps: (
        fn(), {"idle_share": 0.5, "busy_ms_per_step": 1.0})[1])
    expected = {}
    monkeypatch.setattr(cs, "_check_launches",
                        lambda path, launches, expect: expected.setdefault(path, expect))
    printed = []
    monkeypatch.setattr(cs, "emit", printed.append)

    cfg = dataclasses.replace(LlamaConfig.tiny(vocab_size=512), hidden_size=512,
                              intermediate_size=1024, num_attention_heads=4,
                              num_key_value_heads=4, dtype="bfloat16")
    cpu = torch.device("cpu")
    fp, packed, stacked = cs.build_model(cfg, cpu, cs.SEED)
    promoted = cs.build_promoted(fp, cfg, cs.SEED)
    gen = torch.Generator().manual_seed(1)
    # K4 at the promoted tree's sites (its wgmma body, the tiles timed
    # beside), and the Generator: prefill on the promoted tree, the int8
    # lm_head of each 4-row decode step on K4 too
    monkeypatch.setattr(cs, "PREFILL_N", 64)
    k4_rows = cs.check_int8_prefill(promoted, cfg, cpu, gen)
    assert [r["site"] for r in k4_rows] == ["qkv", "o", "gate_up", "down", "lm_head"]
    assert all(r["body"] == "wg" and r["max_err"] == 0 for r in k4_rows)
    for name, value in dict(GEN_PROMPT=24, GEN_NEW=3, GEN_MAX_LEN=32).items():
        monkeypatch.setattr(cs, name, value)
    cs.generator(packed, promoted, cfg, cpu)
    assert expected["generator"] == {"int8_prefill_matmul": 4 * 2 + 1 + 2,
                                     "int4_group_matmul": 4 * 2 * 2,
                                     "decode_attention_stacked": 2 * 2}
    rows = (cs.check_rawx(stacked, cpu, gen, 16) + cs.check_rawx(stacked, cpu, gen, 32)
            + cs.check_act_prep(stacked, cpu, gen) + cs.check_gmm_stacked(stacked, cpu, gen)
            + cs.check_write_cache_hm(cpu, gen, cs.SLOT_BATCH, cfg.num_key_value_heads,
                                      cfg.head_dim))
    kinds = {}
    for r in rows:
        kinds.setdefault(r["kernel"], []).append(r.get("site"))
        assert r["max_err"] == 0
    assert len(kinds["int4_group_matmul_stacked_rawx"]) == 8
    # each site's prep one launch of K7's row body: K7b at the fused-norm sites
    assert kinds["norm_quantize_acts_t"] == ["qkv", "gate_up"]
    assert kinds["quantize_acts_grouped_t"] == ["down"]
    assert all("old_route_ms" in r for r in rows
               if r["kernel"] in ("norm_quantize_acts_t", "quantize_acts_grouped_t"))
    assert kinds["int4_group_matmul_stacked"] == ["qkv", "o", "gate_up", "down", "qkv@rows"]
    assert len(kinds["write_quant_cache_stacked"]) == 1
    assert all("tiles_ms" in r for r in rows if r.get("body") == "stream"
               and r["kernel"] == "int4_group_matmul_stacked")
    assert all("old_body_ms" in r for r in rows if r["kernel"] == "int4_group_matmul_stacked_rawx")
    routes = cs.k1_vs_k5(stacked, cpu, gen)
    assert routes["rows"] == [1, 4, 8, 16, 32] and set(routes["by_rows"][32]["ms"]) == {
        "qkv", "o", "gate_up", "down"}

    metrics, launches = cs.serve(promoted, stacked, cfg, cpu, promoted=True, batch=40,
                                 smajor=False, n_requests=44, decode_window=True)
    assert sum(launches.values()) == 0
    # the int8 lm_head on K4 from PREFILL_KERNEL_MIN_TOKENS rows
    per_step = {"norm_quantize_acts_t": 4, "quantize_acts_grouped_t": 2,
                "int4_group_matmul_stacked": 8, "write_quant_cache_stacked": 2,
                "decode_attention_stacked": 2, "int8_prefill_matmul": 1}
    assert metrics["launches_per_step"] == per_step and metrics["pool"] == "head-major"
    steps = metrics["decode_steps"]
    assert steps >= 64                        # 44 requests of 32 tokens through 40 slots
    assert {k: v for k, v in expected["serving"].items() if k != "int8_prefill_matmul"} == {
        k: v * steps for k, v in per_step.items() if k != "int8_prefill_matmul"}
    assert expected["serving"]["int8_prefill_matmul"] >= steps
    assert metrics["generated_tokens"] == 44 * 32

    cs.slot_decode(stacked, cfg, cpu, "card")
    assert expected["head_major decode step B=40"] == per_step
    assert expected["s_major decode step B=40"] == {
        "norm_quantize_acts_t": 4, "quantize_acts_grouped_t": 2,
        "int4_group_matmul_stacked": 8, "write_quant_cache_smajor": 2,
        "decode_attention_smajor_stacked": 2, "int8_prefill_matmul": 1}
    assert expected["aligned_head_major decode step B=40"] == {
        "norm_quantize_acts_t": 4, "quantize_acts_grouped_t": 2,
        "int4_group_matmul_stacked": 8, "fused_attn": 2, "write_quant_cache_stacked": 2,
        "int8_prefill_matmul": 1}
    # above K1_MAX_TOKENS rows: K7b at the fused-norm sites, K7a at down, K5
    assert expected["head-major decode step B=32"] == {
        "norm_quantize_acts_t": 4, "quantize_acts_grouped_t": 2,
        "int4_group_matmul_stacked": 8, "write_quant_cache_stacked": 2,
        "decode_attention_stacked": 2, "int8_prefill_matmul": 1}
    phases = {p["phase"]: p for p in printed if "phase" in p}
    # position 448, two warm-up steps and the counted one, three windows of 8, the profile
    assert phases["slot_head_major_decode"]["positions"] == [448, 448 + 3 + 24 + 4]
    assert phases["slot_aligned_head_major_decode"]["positions"] == [448, 448 + 3 + 24 + 4]
    assert "device_busy" in phases["slot_aligned_head_major_vs_s_major"]


def test_aligned_path_rehearsal_on_cpu(monkeypatch):
    """chip_smoke's phases of the aligned head-major slice on the CPU at a
    small size (2 layers of hidden 512, 4 heads of 128, B = 4, 8 rows in
    place of 64): K12's three bodies (the write body's rows identical to
    K10's) and K14 at 4 and 8 rows (the wrappers take their plain versions
    here), then the B = 4 decode in the four compositions beside the
    S-major step; timing and the launch checks are stubbed, the launch
    counts each composition expects recorded."""
    import dataclasses

    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from smoothquant_tpu_torch.models import llama

    monkeypatch.setattr(cs, "SLOT_BATCH", 8)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(cs, "device_ms", lambda fn, n_iter, reps=5: (fn(0), 0.0)[1])
    monkeypatch.setattr(cs, "profile", lambda fn, steps: (
        fn(), {"idle_share": 0.5, "busy_ms_per_step": 1.0})[1])
    monkeypatch.setattr(cs, "_launched", lambda key, fn: fn())   # plain versions count nothing
    expected = {}
    monkeypatch.setattr(cs, "_check_launches",
                        lambda path, launches, expect: expected.setdefault(path, expect))
    printed = []
    monkeypatch.setattr(cs, "emit", printed.append)

    cfg = dataclasses.replace(llama.LlamaConfig.tiny(vocab_size=512), hidden_size=512,
                              intermediate_size=1024, num_attention_heads=4,
                              num_key_value_heads=4, dtype="bfloat16")
    cpu = torch.device("cpu")
    _, _, stacked = cs.build_model(cfg, cpu, cs.SEED)
    gen = torch.Generator().manual_seed(1)
    rows = cs.check_fused_attn(cfg, cpu, gen) + cs.check_mlp_fused(stacked, cpu, gen)
    assert [(r["kernel"], r["site"]) for r in rows] == [
        ("fused_attn", "flat"), ("fused_attn", "flat@8"), ("fused_attn", "write"),
        ("fused_attn", "gqa"), ("mlp_swiglu_fused_stacked", "mlp"),
        ("mlp_swiglu_fused_stacked", "mlp@8")]
    assert all(r["max_err"] == 0 for r in rows)
    assert rows[2]["cache_identical_to_k10"] and rows[3]["shape"][2] == 1
    assert all("flash_ms" in r and r["check_launches"] == 1 for r in rows[:4])
    assert [r["in_sum"] for r in rows] == [True, False, False, False, True, False]
    # K14 on its stream body, the cooperative body and the unfused route timed
    # beside
    assert all(r["body"] == "stream" and {"old_body_ms", "unfused_ms"} <= set(r)
               for r in rows[4:])

    cache = llama.stacked_caches(cfg, cs.MAX_BATCH, cs.MAX_LEN, pos=cs.DECODE_POS,
                                 quant_kv=True, smajor=True, device=cpu)
    step, _ = cs.aligned_decoder(stacked, cache, cfg, cpu, "w4a4 decode step",
                                 cs.step_launches(cfg, cs.MAX_BATCH, "smajor"))
    launches = cs.aligned_decode(stacked, step, cfg, cpu, "card")
    assert sum(launches.values()) == 0
    assert expected["aligned auto decode step"] == {
        "int4_group_matmul_stacked_rawx": 8, "fused_attn": 2, "write_quant_cache_stacked": 2,
        "int8_prefill_matmul": 1}
    assert expected["aligned fused decode step"] == {
        "int4_group_matmul_stacked_rawx": 8, "fused_attn": 2, "int8_prefill_matmul": 1}
    assert expected["aligned off decode step"] == {
        "int4_group_matmul_stacked_rawx": 8, "write_quant_cache_stacked": 2,
        "decode_attention_stacked": 2, "int8_prefill_matmul": 1}
    # K14's stream body: its gate_up and its down launch a layer
    assert expected["aligned auto_mlp decode step"] == {
        "int4_group_matmul_stacked_rawx": 4, "mlp_swiglu_fused_stacked": 2,
        "mlp_swiglu_fused_stacked_down": 2, "fused_attn": 2,
        "write_quant_cache_stacked": 2, "int8_prefill_matmul": 1}
    phases = {p["phase"]: p for p in printed if "phase" in p}
    for name in ("auto", "fused", "off", "auto_mlp"):
        assert phases[f"aligned_{name}_decode"]["positions"] == [448, 448 + 3 + 24 + 4]
    assert set(phases["aligned_vs_off"]) >= {"s_major", "auto", "fused", "off", "auto_mlp"}


def test_quickstart_path_rehearsal_on_cpu(monkeypatch):
    """chip_smoke's phases of the README quick start on the CPU at a small
    size (2 layers of hidden 512, bf16; calibration on 2 sequences of 32,
    2 prompts of 32 and 4 new tokens): calibration → smooth_lm →
    pack_model, the K8 and K9 phases and their variant sweep (the wrappers
    take their plain versions here), the int / dequant and K4 / _int_mm
    crossovers, and the Generator with its dequant prefill; timing and the launch checks are
    stubbed, the launch counts each path expects recorded."""
    import dataclasses

    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from smoothquant_tpu_torch.kernels.real_linear import INT_PATH_MAX_TOKENS
    from smoothquant_tpu_torch.models import llama

    for name, value in dict(QS_SAMPLES=2, QS_LEN=32, QS_BATCH=2, QS_PROMPT=32, QS_NEW=4,
                            CROSSOVER_N=(4, 16, 64)).items():
        monkeypatch.setattr(cs, name, value)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda *a, **k: 0)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a, **k: None)
    monkeypatch.setattr(cs, "device_ms", lambda fn, n_iter, reps=5: (fn(0), 0.0)[1])
    monkeypatch.setattr(cs, "profile", lambda fn, steps: (
        fn(), {"idle_share": 0.5, "busy_ms_per_step": 1.0})[1])
    expected = {}
    monkeypatch.setattr(cs, "_check_launches",
                        lambda path, launches, expect: expected.setdefault(path, expect))
    printed = []
    monkeypatch.setattr(cs, "emit", printed.append)

    cfg = dataclasses.replace(llama.LlamaConfig.tiny(vocab_size=512), hidden_size=512,
                              intermediate_size=1024, num_attention_heads=4,
                              num_key_value_heads=4, dtype="bfloat16")
    cpu = torch.device("cpu")
    fp = llama.init_params(torch.Generator().manual_seed(0), cfg, cpu)
    packed, seconds, calib = cs.build_quickstart(fp, cfg, cpu, n_samples=2, seq_len=32)
    assert set(seconds) == {"act_scales", "calib_feat", "smooth_lm", "pack_model"}
    assert set(calib) == {"smoothed", "feat"}
    q = packed["layers"]["0"]["self_attn"]["q_proj"]
    assert not q.meta.nibble and q.meta.group_size == 64 and q.meta.num_salient == 25
    # smoothing moved the q/k/v inputs' norm; o_proj stayed an unsmoothed pack
    assert not torch.equal(packed["layers"]["0"]["input_layernorm"]["weight"],
                           fp["layers"]["0"]["input_layernorm"]["weight"])

    single = cs.single_group_packs(fp)
    assert [p.meta.k_ns // p.meta.group_size for p in single.values()] == [1, 1]
    assert all(p.meta.layout == "permuted" for p in single.values())
    gen = torch.Generator().manual_seed(1)
    rows = (cs.check_int_group_matmul(packed, single, cpu, gen)
            + cs.check_dual_path_matmul(packed, single, cpu, gen))
    assert all(r["max_err"] == 0 for r in rows)
    k8 = [r["site"] for r in rows if r["kernel"] == "int_group_matmul"]
    k9 = [r["site"] for r in rows if r["kernel"] == "dual_path_matmul"]
    assert len(k8) == 22 and "down_nosal@64" in k8 and "gate_g1@512" in k8
    # the stream body's shapes are timed beside the tiles body's
    stream = [r for r in rows if r.get("body") == "stream"]
    assert stream and all("tiles_ms" in r for r in stream)
    assert k9 == [f"{b}@{n}" for b in ("grouped", "grouped_nosal", "colscale",
                                       "colscale_nosal") for n in (512, 2048)]
    assert sum(r["in_sum"] for r in rows) == 4

    assert cs.check_kernel_variants(cpu) == {"int_group_matmul": 0.0, "dual_path_matmul": 0.0}
    cross = cs.int_path_crossover(packed, cpu, gen)
    assert cross["rows"] == [4, 16, 64] and set(cross["ms"]) == {"gate", "down"}
    promoted = cs.build_promoted(fp, cfg, cs.SEED)
    k4 = cs.prefill_kernel_crossover(promoted, cfg, cpu, gen)
    assert set(k4["ms"]["down"][64]) == {"k4", "int_mm"}

    metrics, launches = cs.quickstart(fp, packed, cfg, cpu, "card")
    assert sum(launches.values()) == 0
    n_l = cfg.num_hidden_layers
    assert 2 * 32 <= INT_PATH_MAX_TOKENS       # so the prefill stays on K8 here
    assert expected["quick start generator"] == {
        "int_group_matmul": 7 * n_l * 4, "decode_attention_stacked": n_l * 3}
    assert expected["quick start dequant prefill"] == {"dual_path_matmul": 7 * n_l}
    assert metrics["prefill_compute"] == "int" and "dequant_prefill" in metrics
    assert 0.0 <= metrics["vs_fp"]["top1_agree"] <= 1.0
    assert metrics["launches_per_decode_step"] == {"int_group_matmul": 7 * n_l,
                                                   "decode_attention_stacked": n_l}


def test_sim_path_rehearsal_on_cpu(monkeypatch):
    """chip_smoke's simulated-path phases on the CPU at a small size (2
    layers of hidden 512, bf16; the quick start's calibration on 2
    sequences of 32; the quantizer grid at 256-1024 wide shapes, the
    packed check over 32 tokens, perplexity over 4 windows of 32): every
    quantizer "on the card" against itself on the CPU, the small-model
    reference check, quantize_model for both recipes, the W8A8 pack against
    the simulated forward and the perplexities; the launch check stubbed,
    its expectation recorded."""
    import dataclasses
    import math

    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from smoothquant_tpu_torch.models import llama

    for name, value in dict(SIM_WEIGHT_SHAPES=((256, 512), (1024, 512), (512, 1024)),
                            SIM_ACT_SHAPES=((64, 512), (64, 1024)), SIM_PACKED_TOKENS=32,
                            SIM_PPL_WINDOWS=4, SIM_PPL_WINDOW=32).items():
        monkeypatch.setattr(cs, name, value)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda *a, **k: 0)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a, **k: None)
    expected = {}
    monkeypatch.setattr(cs, "_check_launches",
                        lambda path, launches, expect: expected.setdefault(path, expect))
    printed = []
    monkeypatch.setattr(cs, "emit", printed.append)

    cfg = dataclasses.replace(llama.LlamaConfig.tiny(vocab_size=512), hidden_size=512,
                              intermediate_size=1024, num_attention_heads=4,
                              num_key_value_heads=4, dtype="bfloat16")
    cpu = torch.device("cpu")
    fp = llama.init_params(torch.Generator().manual_seed(0), cfg, cpu)
    _, _, calib = cs.build_quickstart(fp, cfg, cpu, n_samples=2, seq_len=32)
    used = cs.run_sim(fp, calib, cfg, cpu, "card")
    n_l = cfg.num_hidden_layers
    assert used == {} and expected == {"sim_vs_packed": {"int8_prefill_matmul": 7 * n_l}}
    phases = {}
    for line in printed:
        phases.setdefault(line["phase"], []).append(line)
    assert list(phases) == ["sim_quantizers", "sim_reference", "sim_model", "sim_vs_packed",
                            "sim_ppl"]
    q = phases["sim_quantizers"][0]
    assert q["cases"] == 80 == len(set(q["grid"])) and q["bit_exact"]
    assert {c.split("-")[-1] for c in q["grid"]} == {"256x512", "1024x512", "512x1024",
                                                     "64x512", "64x1024"}
    assert [s["num_salient"] for s in q["quantize_linear_params"]] == [25, 51]
    ref = phases["sim_reference"][0]
    assert {k for k in ref if k not in ("phase", "seconds")} == {
        f"{a}_{r}" for a in ("llama", "opt") for r in ("w8a8_smoothquant", "w4a4_g64_5pct")}
    assert all(v["rel_norm_err"] == 0.0 for k, v in ref.items() if isinstance(v, dict))
    assert [m["salient_linears"] for m in phases["sim_model"]] == [0, 7 * n_l]
    svp = phases["sim_vs_packed"][0]
    assert svp["rel_norm_err"] <= svp["quant_effect"] and 0.0 <= svp["top1_agree"] <= 1.0
    ppl = phases["sim_ppl"][0]
    for name in ("fp", "w8a8_smoothquant", "w4a4_g64_5pct"):
        assert math.isfinite(ppl[name]["ppl"]) and len(ppl[name]["seconds_per_window"]) == 4


def test_reference_check_rehearsal_on_cpu(monkeypatch):
    """chip_smoke's Llama reference check with both paths on the CPU: every
    part reads 0, and the per-layer parts expect their kernels — W4A8's
    "auto" K9 at its 2 × 129-row prefill and K8 at decode, each forced mode
    its kernel at both, W4A4 at 2 × 12 rows in "int" and "dequant"."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    expected = {}
    monkeypatch.setattr(cs, "_check_launches",
                        lambda path, launches, expect: expected.setdefault(path, expect))
    out = cs.reference_check(torch.device("cpu"))
    for dtype_name in ("float32", "bfloat16"):
        parts = out[dtype_name]
        assert {p for p in parts if p.startswith("per_layer")} == {
            "per_layer_w4a8_int", "per_layer_w4a8_dequant", "per_layer_w4a8_auto",
            "per_layer_w4a4_int", "per_layer_w4a4_dequant"}
        assert all(r.get("rel_norm_err", r.get("max_abs_err")) == 0 for r in parts.values())
    n_l = 2
    # the first expectation recorded is float32's: its K11 calls take the
    # flash body (f32 queries), counted under their own key
    k11 = cs.k11_key(torch.float32, 64, 256)
    assert k11 == "decode_attention_stacked_flash"
    assert cs.k11_key(torch.bfloat16, 64, 256) == "decode_attention_stacked"
    assert expected["reference check per_layer_w4a8_auto"] == {
        "dual_path_matmul": 7 * n_l, "int_group_matmul": 7 * n_l, k11: n_l}
    for recipe in ("w4a8", "w4a4"):
        assert expected[f"reference check per_layer_{recipe}_int"] == {
            "int_group_matmul": 14 * n_l, k11: n_l}
        assert expected[f"reference check per_layer_{recipe}_dequant"] == {
            "dual_path_matmul": 14 * n_l, k11: n_l}


@pytest.mark.parametrize("recipe,rows,compute", [
    ("w4a4", 12, "int"), ("w4a4", 12, "dequant"), ("w4a4", 129, "int"),
    ("w4a4", 129, "dequant"), ("w4a8", 129, "int"), ("w4a8", 129, "dequant")])
def test_per_layer_parts_under_last_bit_noise(recipe, rows, compute, monkeypatch):
    """Why the reference check holds its per-layer parts where it does
    (chip_smoke.PER_LAYER_PARTS).  The small model of the check in f32, a
    prefill of 2 × rows and one decode step, run twice: as it is, and with
    noise of 2e-7 relative (about an f32 ulp: a sum taken in another order)
    on every linear's output.  At each recipe's own rows the logits stay
    within the part's f32 bound.  Under W4A4 over 2 × 129 rows they do not:
    the noise moves a few int4 codes of one linear's input (at most 16 of
    its 132 096), attention spreads the change to every later row, and the
    second layer's inputs move by the thousand — so no bound near a kernel's own error holds
    there, and W4A4 is checked over 2 × 12 rows instead."""
    import dataclasses

    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from smoothquant_tpu_torch.kernels.pack import PackedLinear, quantize_activations_packed_int
    from smoothquant_tpu_torch.models import common, llama
    from smoothquant_tpu_torch.models.common import ForwardContext, QuantKVCache
    from smoothquant_tpu_torch.models.registry import pack_model
    from smoothquant_tpu_torch.quant.config import w4a4_group, w4a8_group

    cfg = dataclasses.replace(
        llama.LlamaConfig.tiny(), hidden_size=512, intermediate_size=512,
        num_attention_heads=8, num_key_value_heads=8, num_hidden_layers=2, dtype="float32")
    fp = llama.init_params(torch.Generator().manual_seed(cs.SEED), cfg, "cpu")
    qcfg = {"w4a4": w4a4_group, "w4a8": w4a8_group}[recipe](group_size=64, salient_prop=0.05)
    tree = pack_model("llama", fp, cfg, qcfg, input_feat=cs._recipe(cfg, cs.SEED, 64)[2])
    prompt = torch.randint(0, cfg.vocab_size, (2, rows),
                           generator=torch.Generator().manual_seed(cs.SEED + 1))
    ctx = ForwardContext(compute=compute)
    linear = common._linear

    def run(noise):
        codes, gen = [], torch.Generator().manual_seed(7)

        def noisy(params, x, *args):
            if isinstance(params, PackedLinear):
                codes.append(quantize_activations_packed_int(
                    x.reshape(-1, x.shape[-1]), params.meta)[0])
            y = linear(params, x, *args)
            return y + y * noise * torch.randn(y.shape, generator=gen) if noise else y

        monkeypatch.setattr(common, "_linear", noisy)
        caches = [QuantKVCache.create(2, 256, cfg.num_key_value_heads, cfg.head_dim,
                                      device="cpu") for _ in range(2)]
        pre, caches = llama.forward(tree, prompt, cfg, caches=caches, ctx=ctx)
        step, _ = llama.forward(tree, prompt[:, -1:], cfg, caches=caches, ctx=ctx)
        return torch.cat([pre, step], dim=1), codes

    ref, ref_codes = run(0.0)
    got, got_codes = run(2e-7)
    rel = float((got - ref).norm() / ref.norm())
    own_rows, _, bound = cs.PER_LAYER_PARTS[recipe]
    if rows == own_rows:
        assert rel <= bound["float32"], rel
        return
    moved = [int((a != b).sum()) for a, b in zip(ref_codes, got_codes) if a.shape[0] > 2]
    first = next(m for m in moved if m)
    assert first <= 16 and max(moved) >= 100 * first, moved
    assert rel > bound["float32"], rel


def test_bloom_path_rehearsal_on_cpu(monkeypatch):
    """chip_smoke's Bloom phases end to end on the CPU at a small size (2
    layers of hidden 256, 4 heads of 64, vocab 512, bf16; calibration on 2
    sequences of 32; 2 prompts of 40 and 4 new tokens over caches of 256;
    B = 2 and 40 in place of 4 and 64; K4's raw-x cases cut to small
    shapes): the K11 ALiBi, K7b and K4 raw-x phases (the wrappers take their
    plain versions here), the reference check (both paths on the CPU: every
    kernel-against-plain part reads 0, the one-code control reads above its
    bound), the build, the Generator, K6, K1, K7a, K5 and K10 (rotary off)
    on the Bloom trees' own linears, K7b + K5 against K1 and the stacked
    decode; timing and the launch checks are stubbed, the launch counts each
    path expects recorded."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from smoothquant_tpu_torch.kernels import kv_write
    from smoothquant_tpu_torch.models.bloom import BloomConfig

    # K10's block-size sweep launches the row body itself, which the CPU has not
    monkeypatch.setattr(kv_write, "launch_rows", lambda *a, **k: None)
    for name, value in dict(BLOOM_SAMPLES=2, BLOOM_LEN=32, BLOOM_BATCH=2, BLOOM_PROMPT=40,
                            BLOOM_NEW=4, BLOOM_MAX_LEN=256, BLOOM_SLOT_BATCH=40,
                            SERVE_REQUESTS=3, SERVE_NEW=4, SERVE_PROMPT=(10, 40),
                            K4_RAWX_CASES=(("gate@64", (64, 512, 384)), ("ragged@33", (33, 512, 384)),
                                           ("one_k_step", (16, 64, 128)))).items():
        monkeypatch.setattr(cs, name, value)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda *a, **k: 0)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a, **k: None)
    monkeypatch.setattr(cs, "device_ms", lambda fn, n_iter, reps=5: (fn(0), 0.0)[1])
    monkeypatch.setattr(cs, "profile", lambda fn, steps: (
        fn(), {"idle_share": 0.5, "busy_ms_per_step": 1.0})[1])
    monkeypatch.setattr(cs, "_launched", lambda key, fn: fn())   # plain versions count nothing
    expected = {}
    monkeypatch.setattr(cs, "_check_launches",
                        lambda path, launches, expect: expected.setdefault(path, expect))
    printed = []
    monkeypatch.setattr(cs, "emit", printed.append)

    cfg = BloomConfig(vocab_size=512, hidden_size=256, num_hidden_layers=2,
                      num_attention_heads=4, dtype="bfloat16")
    rows, launches = cs.run_bloom(torch.device("cpu"), cfg, "card")
    assert sum(launches.values()) == 0
    sites = {}
    for r in rows:
        sites.setdefault(r["kernel"], []).append(r["site"])
        assert r["max_err"] == 0
    assert sites["decode_attention_stacked"] == [
        "alibi_bf16@B2", "alibi_int8@B2", "alibi_bf16@B40", "alibi_int8@B40"]
    assert len(sites["norm_quantize_acts_t"]) == 16
    assert sites["int8_prefill_matmul"] == ["raw_x_gate@64", "raw_x_ragged@33",
                                            "raw_x_one_k_step"]
    assert all(r["identical_to_prequantized"] for r in rows if r["kernel"] == "int8_prefill_matmul")
    k7b = [r for r in rows if r["kernel"] == "norm_quantize_acts_t"]
    # no path runs K7b at Bloom's widths: its rows stay out of the sums
    assert not any(r["in_sum"] for r in k7b)
    assert all("old_body_ms" in r for r in k7b if "kernel_ms" in r)
    assert all(r["n_diff"] == 0 and r["scale_ulps"] == 0 for r in k7b)
    linears = ["bloom_qkv", "bloom_dense", "bloom_h_to_4h", "bloom_4h_to_h"]
    assert sites["int4_group_matmul"] == [f"{s}@{n}" for n in (80, 2) for s in linears]
    assert sites["int4_group_matmul_stacked_rawx"] == [f"{s}@2" for s in linears]
    assert sites["quantize_acts_grouped_t"] == sites["int4_group_matmul_stacked"] == linears
    assert sites["write_quant_cache_stacked"] == ["bloom_rotary_off@B2", "bloom_rotary_off@B40"]
    bloom_rows = [r for r in rows if r["site"].startswith("bloom_")]
    assert len(bloom_rows) == 22 and not any(r["in_sum"] for r in bloom_rows)
    assert all(r["mode"] == "gather" for r in bloom_rows
               if r["kernel"] == "int4_group_matmul_stacked_rawx")
    assert not any(r["rotary"] for r in bloom_rows if r["kernel"] == "write_quant_cache_stacked")

    n_l = 2
    assert expected["bloom generator"] == {"int4_group_matmul": 4 * n_l * 4,
                                           "decode_attention_stacked_alibi": n_l * 3}
    assert expected["bloom decode step B=2"] == {
        "int4_group_matmul_stacked_rawx": 4 * n_l, "write_quant_cache_stacked": n_l,
        "decode_attention_stacked_alibi": n_l}
    assert expected["bloom decode step B=40"] == {
        "quantize_acts_grouped_t": 4 * n_l, "int4_group_matmul_stacked": 4 * n_l,
        "write_quant_cache_stacked": n_l, "decode_attention_stacked_alibi": n_l}
    # the first expectation recorded is float32's: K11's flash ALiBi body
    # and K1's dp4a body
    assert expected["bloom reference check stacked_int8"] == {
        "int4_group_matmul_stacked_rawx_dp4a": 4 * n_l,
        "decode_attention_stacked_flash_alibi": n_l, "write_quant_cache_stacked": n_l}
    phases = {p["phase"]: p for p in printed if "phase" in p}
    for dtype_name in ("float32", "bfloat16"):
        parts = phases["bloom_reference_check"][dtype_name]
        assert set(parts) == {"per_layer_fp", "stacked_fp", "per_layer_int8", "stacked_int8",
                              "stacked_vs_per_layer_fp", "stacked_vs_per_layer_int8",
                              "control_one_code_moved"}
        tol, fp_pair_tol, int8_pair_tol = cs.BLOOM_REF_TOL[dtype_name]
        assert parts["stacked_vs_per_layer_fp"]["tolerance_rel_norm"] == fp_pair_tol
        assert parts["stacked_vs_per_layer_int8"]["tolerance_rel_norm"] == int8_pair_tol
        assert parts["control_one_code_moved"]["rel_norm_err"] > 10 * tol
        for part, r in parts.items():   # kernel against plain: both plain here
            if part.startswith("stacked_vs"):
                assert r["rel_norm_err"] <= r["tolerance_rel_norm"], (dtype_name, part, r)
            elif part != "control_one_code_moved":
                assert r["rel_norm_err"] == 0 and r["tolerance_rel_norm"] == tol
    assert set(phases["bloom_model"]) >= {"act_scales", "calib_feat", "smooth_lm", "pack_model"}
    g = phases["bloom_generator"]
    assert 0.0 <= g["vs_fp"]["top1_agree"] <= 1.0 and g["launches_per_decode_step"] == {
        "int4_group_matmul": 4 * n_l, "decode_attention_stacked_alibi": n_l}
    k5_k1 = {k: v for k, v in phases["k7b_k5_vs_k1"].items() if k != "phase"}
    assert set(k5_k1) == {"query_key_value", "dense_h_to_4h"}
    assert max(r["max_rel_err"] for r in k5_k1.values()) < 1e-5
    for b in (2, 40):
        # position 448, two warm-up steps and the counted one, three windows of 8, the profile
        assert phases[f"bloom_decode_b{b}"]["positions"] == [448, 448 + 3 + 24 + 4]
    # Bloom's fp stacked tree through the batcher: the per-layer body over
    # the stack for the prefill and each step, no kernel, tokens held
    assert expected["serve_families bloom"] == {}
    fam = phases["serve_families"]
    assert fam["family"] == "bloom" and fam["tree"] == "stacked fp"
    assert fam["tokens"]["requests"] == 3


def test_wgmma_edge_checks_rehearsal_on_cpu(monkeypatch):
    """chip_smoke's edge checks of K6's and K9's bodies (check_wg_edges: 1,
    65 and 333 rows, ragged column tiles, both weight-copy paths, group
    sizes, salient blocks, scale and output dtypes) on the CPU, where the
    wrappers take their plain versions: every case reads 0 and each body the
    shape rules reach is named; and the per-group scaling floors it prints
    beside K5's, K6's and K8's bounds."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    worst = cs.check_wg_edges(torch.device("cpu"))
    assert worst == {"int4_group_matmul/wgmma": 0.0, "int4_group_matmul/tiles": 0.0,
                     "dual_path_matmul/wgmma": 0.0, "dual_path_matmul/fma": 0.0,
                     "dual_path_matmul/wgmma, weight by cp.async": 0.0}
    # and the stream body K8 and K5 share, with the tiles body where the
    # rules send a shape; every stream call is repeated and compared
    edges = cs.check_stream_edges(torch.device("cpu"))
    assert edges["max_rel_err"] == {"int_group_matmul/stream": 0.0,
                                    "int_group_matmul/tiles": 0.0,
                                    "int4_group_matmul_stacked/stream": 0.0,
                                    "int4_group_matmul_stacked/tiles": 0.0}
    assert edges["repeated_calls_identical"] == 5 * (4 * 2 * 4 + 3 * 2 * 4 * 2)
    rows = [dict(kernel="int4_group_matmul", site="qkv", kernel_ms=1.0, bound_ms=0.06,
                 scalings=[1024, 12288, 3968, 64]),
            dict(kernel="fp_matmul_stacked", site="qkv", kernel_ms=0.1, bound_ms=0.05)]
    floors = cs.add_scaling_floors(rows, 1980.0)
    assert [f["site"] for f in floors] == ["qkv"]
    assert floors[0]["scaling_floor_ms"] == rows[0]["scaling_floor_ms"]
    assert 0.069 < rows[0]["scaling_floor_ms"] < 0.071 and "scaling_floor_ms" not in rows[1]
    one = dict(max_err=0.0, kernel_ms=0.1, plain_ms=1.0, bound_ms=0.01, bound_by="bytes",
               library_ms=None)
    line = cs.kernels_line([dict(rows[0], max_err=0.0, plain_ms=1.0, bound_by="operations",
                                 library_ms=0.1)]
                           + [dict(one, kernel=k) for k in cs.SOURCES if k != "int4_group_matmul"],
                           {})
    by = {k["name"]: k for k in line["kernels"]}
    assert len(by) == 18
    # the kernels line holds measured numbers and bound_ms only: the floors
    # stay on the scaling_floors line
    assert all("scaling_floor_ms" not in k and "before_ms" not in k for k in by.values())


def test_k4_k15a_edge_checks_rehearsal_on_cpu(monkeypatch):
    """chip_smoke's edge checks of K4's and K15a's bodies on the CPU at a
    few of their shapes, where the wrappers take their plain versions:
    k4_edges (every k_s of K4_EDGE_KS, bf16 and f32 out, each call
    repeated) and k15a_edges (f32 with and without bias, int8 with ReLU,
    sums past 2^24), each case named by the body its rule picks; and the
    refusals check_no_fallback holds the new bodies to."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(cs, "_launched", lambda key, fn: fn())   # plain versions count nothing
    monkeypatch.setattr(cs, "K4_EDGE_SHAPES", ((33, 200, 72), (130, 128, 264)))
    monkeypatch.setattr(cs, "K15A_EDGE_SHAPES", ((1, 1088, 40), (64, 208, 77), (130, 64, 136)))
    cpu = torch.device("cpu")
    k4 = cs.check_k4_edges(cpu)
    assert k4 == {"cases": 2 * len(cs.K4_EDGE_KS) * 2,
                  "max_rel_err": {"bfloat16": 0.0, "float32": 0.0}}
    k15a = cs.check_k15a_edges(cpu)
    assert k15a["bit_exact_cases"] == {"stream": 6, "wg": 3}
    assert k15a["above_2_24"] and k15a["max_abs_acc"] == 127 * 127 * 1088


def test_attn_edge_checks_rehearsal_on_cpu(monkeypatch):
    """chip_smoke's edge checks of K11's split body (check_k11_edges: S =
    128 / 640 / 1024, D = 64 / 128, rep 1-8, both caches, ALiBi, masked and
    one-position slots, every cluster size) and of K15b's bodies
    (check_k15b_edges: K = 64-512, ragged M and N, both outputs, every body
    the rule reaches and every kn rank count) on the CPU, where the wrappers
    take their plain versions: every case holds, each call repeats with
    identical bits, and each body of the rule is named."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    edges = cs.check_k11_edges(torch.device("cpu"))
    assert edges["max_rel_err"] == 0.0
    assert edges["cases"] == 3 * 2 * 5 * 2 * 4
    assert edges["repeated_calls_identical"] == 2 * edges["cases"] + 400
    bodies = cs.check_k15b_edges(torch.device("cpu"))
    assert set(bodies) == {"qk", "tiles", "pv", "kn_gemv", "nk_gemv", "gemv"}
    assert bodies["qk"] == 3 * 4 and bodies["tiles"] == 4 * 4 + 4
    assert bodies["pv"] == 4 * 8 + 1


def test_k11_phases_rehearsal_on_cpu(monkeypatch):
    """chip_smoke's K11 phase over the head-major caches on the CPU at a
    small size: Llama's B = 4 rows (bf16, int8; in the kernels line's sum)
    and the per-slot int8 pool's B = 64 row (out of it), each with the
    split the planner picks and the flash body timed beside."""
    import dataclasses

    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from smoothquant_tpu_torch.models.llama import LlamaConfig

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(cs, "device_ms", lambda fn, n_iter, reps=5: (fn(0), 0.0)[1])
    monkeypatch.setattr(cs, "_launched", lambda key, fn: fn())   # plain versions count nothing
    monkeypatch.setattr(cs, "emit", lambda obj: None)
    cfg = dataclasses.replace(LlamaConfig.tiny(vocab_size=512), hidden_size=512,
                              num_attention_heads=4, num_key_value_heads=4,
                              num_hidden_layers=2)
    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(3)
    rows = cs.check_decode_attention_hm(cfg, cpu, gen)
    rows += cs.check_decode_attention_hm(
        cfg, cpu, gen, b=64, bodies=("int8",), main=False,
        pos=torch.randint(100, cs.MAX_LEN, (64,), generator=gen))
    assert [(r["site"], r["in_sum"], r["split"]) for r in rows] == [
        ("bf16", True, 8), ("int8", True, 8), ("int8@B64", False, 2)]
    assert all(r["max_err"] == 0 and "flash_ms" in r for r in rows)


def test_k3_k12_phases_rehearsal_on_cpu(monkeypatch):
    """chip_smoke's K3 phase (B = 4 ragged, in the kernels line's sum; B =
    SLOT_BATCH from DECODE_POS and S = 2·MAX_LEN, out of it; each with the
    split the planner picks and the flash body timed beside) and the edge
    checks of K3's and K12's split bodies (check_k3_edges: S = 128 / 640 /
    1024, D = 64 / 128, rep 1-8, holes, masked, one-position and last-tile
    slots, every cluster size; check_k12_edges: the three bodies at pos 0,
    9 and S − 1, the write body's cache against the plain version's) on the
    CPU at a small size, where the wrappers take their plain versions:
    every case holds and every call repeats with identical bits."""
    import dataclasses

    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from smoothquant_tpu_torch.models.llama import LlamaConfig

    for name, value in dict(MAX_LEN=128, DECODE_POS=100, SLOT_BATCH=8).items():
        monkeypatch.setattr(cs, name, value)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(cs, "device_ms", lambda fn, n_iter, reps=5: (fn(0), 0.0)[1])
    monkeypatch.setattr(cs, "_launched", lambda key, fn: fn())   # plain versions count nothing
    monkeypatch.setattr(cs, "emit", lambda obj: None)
    cfg = dataclasses.replace(LlamaConfig.tiny(vocab_size=512), hidden_size=512,
                              num_attention_heads=4, num_key_value_heads=4,
                              num_hidden_layers=2)
    cpu = torch.device("cpu")
    rows = cs.check_decode_attention(cfg, cpu, torch.Generator().manual_seed(3))
    assert [(r["site"], r["in_sum"], r["split"], r["shape"][3]) for r in rows] == [
        ("ragged", True, 2, 128), ("new_row@B8", False, 2, 128), ("ragged@S256", False, 4, 256)]
    assert all(r["max_err"] == 0 and "flash_ms" in r for r in rows)
    for edges, cases in ((cs.check_k3_edges(cpu), 3 * 2 * 4 * 4),
                         (cs.check_k12_edges(cpu), 3 * 2 * 7 * 3 * 4)):
        assert edges["max_rel_err"] == 0.0 and edges["cases"] == cases
        assert edges["repeated_calls_identical"] == 2 * cases + 400


def test_k13_k1_edge_checks_rehearsal_on_cpu(monkeypatch):
    """chip_smoke's edge checks of K13's and K1's stream bodies on the CPU,
    where the wrappers take their plain versions: k13_edges (1-8 rows,
    ragged K and O, bf16 and f32) and k1_edges (1-32 rows, ragged O, every
    mode, both scale dtypes, group sizes 64 / 32 / 16, bf16 and f32 x)
    hold every case, repeat each stream call with identical bits, hold the
    stream K1 bit for bit to K5's stream body on the plain codes, and name
    the body each case's shape rule picks."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(cs, "_launched", lambda key, fn: fn())   # plain versions count nothing
    cpu = torch.device("cpu")
    k13 = cs.check_k13_edges(cpu)
    assert k13 == {"max_rel_err": {"stream": 0.0, "ldg": 0.0}, "cases": 7 * 5 * 2,
                   "repeated_calls_identical": 7 * 5 * 2}
    k1 = cs.check_k1_edges(cpu)
    stream = 8 * 3 * 2 * 3 * 2          # rows, shapes, O taking the stream body, modes, scales
    assert k1["max_rel_err"] == {"stream": 0.0, "dp4a": 0.0}
    assert k1["cases"] == 8 * 3 * 3 * 3 * 2 + 3 * 3 * 3 * 2   # and f32 x at 4 rows
    assert k1["repeated_calls_identical"] == k1["held_to_k5_bitwise"] == stream


def test_k14_k16_edge_checks_rehearsal_on_cpu(monkeypatch):
    """chip_smoke's k14_edges and k16_edges phases on the CPU (the wrappers
    take their plain versions here): every K14 edge shape goes to the body
    its rule picks — the stream body on bf16 x at group sizes 16 / 32 / 64,
    the cooperative body at group size 128, at O2 = 200, at an intermediate
    width of 200 and on f32 x — and
    the K16 cases run at every row count and width (rows cut to keep the
    CPU run short)."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(cs, "_launched", lambda key, fn: fn())   # plain versions count nothing
    monkeypatch.setattr(cs, "K16_EDGE_ROWS", (1, 3, 5, 64))
    cpu = torch.device("cpu")
    k14 = cs.check_k14_edges(cpu)
    assert k14["cases"] == {"stream": 80, "coop": 5}
    assert k14["max_rel_err"] == {"stream": 0.0, "coop": 0.0}
    assert k14["repeated_calls_identical"] == 80 and "unchained_identical" not in k14
    k16 = cs.check_k16_edges(cpu)
    assert k16["cases"] == 4 * len(cs.K16_EDGE_C) * 2 * 2
    assert k16["n_diff"] == 0 and k16["n_diff_block_body"] == 0
    assert k16["max_share"] == 0.0 and k16["max_share_block_body"] == 0.0


def test_kv_write_phases_rehearsal_on_cpu(monkeypatch):
    """chip_smoke's phases of K2 / K10's row body on the CPU at a small
    size, where the wrappers take their plain versions: K2 at B = 4 and K10
    at B = 8 (Llama's rows, q rotated) and with rotary off (Bloom's
    interleaved rows, no q), each row with its timings beside (block sizes,
    k / v alone, the first design, the route it replaces); and
    kv_write_edges over both layouts, both dtypes, both qkv layouts, rows
    off 16 bytes, per-slot and aligned positions, every call repeated."""
    import dataclasses

    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from smoothquant_tpu_torch.kernels import kv_write
    from smoothquant_tpu_torch.models.llama import LlamaConfig

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(cs, "device_ms", lambda fn, n_iter, reps=5: (fn(0), 0.0)[1])
    monkeypatch.setattr(cs, "emit", lambda obj: None)
    # the block-size sweep launches the row body itself, which the CPU has not
    swept = []
    monkeypatch.setattr(kv_write, "launch_rows",
                        lambda *a, threads=None, **k: swept.append(threads))
    for name, value in dict(MAX_LEN=128, KV_EDGE_DIMS=(64, 128), KV_EDGE_SLOTS=(1, 5),
                            KV_EDGE_HEADS=((1, 4), (8, 1))).items():
        monkeypatch.setattr(cs, name, value)
    cfg = dataclasses.replace(LlamaConfig.tiny(vocab_size=512), hidden_size=512,
                              num_attention_heads=8, num_key_value_heads=2,
                              num_hidden_layers=2)
    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(5)
    rows = (cs.check_write_cache(cfg, cpu, gen)
            + cs.check_write_cache_hm(cpu, gen, 8, 2, 64, n_q=8)
            + cs.check_write_cache_hm(cpu, gen, 4, 4, 64, rotary=False, site="bloom"))
    assert [(r["kernel"], r["shape"][:2]) for r in rows] == [
        ("write_quant_cache_smajor", [4, 8]), ("write_quant_cache_stacked", [8, 8]),
        ("write_quant_cache_stacked", [4, 0])]
    assert swept == [64, 128, 256, 512, 1024] * 3
    for r in rows:
        assert r["max_err"] == 0 and r["scale_ulps"] == 0
        assert set(r["threads_ms"]) == {64, 128, 256, 512, 1024}
        assert {"kv_only_ms", "old_body_ms"} <= set(r)
        assert ("old_route_ms" in r) == (r["shape"][1] > 0)
    assert rows[2]["in_sum"] is False and rows[2]["bound_ms"] < rows[1]["bound_ms"]
    edges = cs.check_kv_write_edges(cpu)
    # two layouts, two dtypes, 2 head_dims, 2 head shapes, 2 slot counts;
    # Llama's rows aligned and off 16 bytes, Bloom's where a kv head takes one q head
    assert edges["cases"] == 2 * 2 * 2 * 2 * (2 + 2 + 1)
    assert edges["repeated_calls_identical"] == 2 * edges["cases"]


def test_serving_layer_rehearsal_on_cpu(monkeypatch):
    """chip_smoke's serving-layer phases on the CPU at a small size (2 layers
    of hidden 512, 4 heads of 128, vocab 512, bf16; 3 requests of 10-40
    prompt tokens, 4 new): tied_and_unfused, serve_per_layer (the int8
    head-major pool on the nibble and the promoted prefill, the S-major
    pool), the Generator's compute modes on the quick start's pack,
    serve_fp_pool (the stacked bf16 tree, the per-layer one under
    attn="kernel"), and the Mistral phases on a 2-layer twin (window 64,
    from position 200 in caches of 256: the window binds); timing and the
    launch checks are stubbed, the launch counts each path expects
    recorded, the token checks strict."""
    import dataclasses

    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from smoothquant_tpu_torch.kernels import kv_write
    from smoothquant_tpu_torch.models import llama

    monkeypatch.setattr(kv_write, "launch_rows", lambda *a, **k: None)
    for name, value in dict(SERVE_REQUESTS=3, SERVE_NEW=4, SERVE_PROMPT=(10, 40),
                            GEN_COMPUTE_NEW=3, GEN_PROMPT=24, QS_BATCH=2, QS_MAX_LEN=128,
                            MISTRAL_POS=200, MISTRAL_LEN=256, MISTRAL_SAMPLES=2,
                            MISTRAL_CALIB_LEN=32, SLOT_BATCH=40).items():
        monkeypatch.setattr(cs, name, value)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda *a, **k: 0)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a, **k: None)
    monkeypatch.setattr(cs, "device_ms", lambda fn, n_iter, reps=5: (fn(0), 0.0)[1])
    monkeypatch.setattr(cs, "profile", lambda fn, steps: (
        fn(), {"idle_share": 0.5, "busy_ms_per_step": 1.0})[1])
    monkeypatch.setattr(cs, "_launched", lambda key, fn: fn())   # plain versions count nothing
    expected = {}
    monkeypatch.setattr(cs, "_check_launches",
                        lambda path, launches, expect: expected.setdefault(path, expect))
    printed = []
    monkeypatch.setattr(cs, "emit", printed.append)

    cfg = dataclasses.replace(llama.LlamaConfig.tiny(vocab_size=512), hidden_size=512,
                              intermediate_size=1024, num_attention_heads=4,
                              num_key_value_heads=4, dtype="bfloat16")
    cpu = torch.device("cpu")
    n_l = cfg.num_hidden_layers
    fp, packed, _ = cs.build_model(cfg, cpu, cs.SEED, align_o=256)
    tu = cs.tied_and_unfused(fp, packed, cfg, cpu, "card")
    assert tu["tied_bit_exact"] and tu["rel_norm_vs_fused"] <= tu["tolerance_rel_norm"]
    assert expected["unfused shared-basis prefill"] == {"int4_group_matmul": 7 * n_l,
                                                        "int8_prefill_matmul": 1}
    promoted = cs.build_promoted(fp, cfg, cs.SEED)
    assert sum(cs.serve_per_layer(packed, promoted, cfg, cpu, "card").values()) == 0
    qs_packed, _, _ = cs.build_quickstart(fp, cfg, cpu, n_samples=2, seq_len=32)
    cs.serve_generator_compute(qs_packed, cfg, cpu, "card")
    cs.serve_fp_pool(fp, cs.build_bf16(fp, cfg), cfg, cpu, "card")
    mcfg = dataclasses.replace(llama.LlamaConfig.mistral_7b(), vocab_size=512,
                               hidden_size=512, intermediate_size=1792,
                               num_hidden_layers=2, num_attention_heads=4,
                               num_key_value_heads=2, sliding_window=64)
    rows, launches = cs.run_mistral(cpu, "card", mcfg)
    assert sum(launches.values()) == 0

    by_phase = {}
    for p in printed:
        by_phase.setdefault(p.get("phase"), []).append(p)
    for p in by_phase["serve_per_layer"] + by_phase["serve_fp_pool"]:
        t = p["tokens"]
        assert t["requests"] in (2, 3), p
    assert [(p["pool"], p["prefill_tree"]) for p in by_phase["serve_per_layer"][:3]] == [
        ("int8 head-major", "nibble"), ("int8 head-major", "promoted"),
        ("int8 S-major", "nibble")]
    assert [p["compute"] for p in by_phase["serve_per_layer"][3:]] == ["int", "dequant"]
    assert [p["tree"] for p in by_phase["serve_fp_pool"]] == ["stacked", "per_layer"]
    steps = {p["tree"]: p["decode_steps"] for p in by_phase["serve_fp_pool"]}
    assert expected["serve_fp_pool stacked"] == {"fp_matmul_stacked": 4 * n_l * steps["stacked"],
                                                 "decode_attention_stacked": n_l * steps["stacked"]}
    assert expected["serve_fp_pool per_layer"] == {
        "decode_attention_stacked": n_l * steps["per_layer"]}
    hm = by_phase["serve_per_layer"][0]
    want = {"int4_group_matmul": 4 * n_l * (hm["decode_steps"] + len(hm["prefill_rows"])),
            "decode_attention_stacked": n_l * hm["decode_steps"],
            "int8_prefill_matmul": hm["decode_steps"] + sum(n >= 4 for n in hm["prefill_seqs"])}
    assert expected["serve_per_layer int8 head-major nibble"] == want
    assert expected["generator compute=int"] == {"int_group_matmul": 7 * n_l * 3,
                                                 "decode_attention_stacked": n_l * 2}
    assert expected["generator compute=dequant"] == {"dual_path_matmul": 7 * n_l * 3,
                                                     "decode_attention_stacked": n_l * 2}
    # Mistral: K1, K7 + K5, K14 and K10 at its widths, out of the kernels
    # line's sums (so printed too); the window binds; the decode over both pools
    assert rows and all(not r["in_sum"] and r["site"].startswith("mistral_") for r in rows)
    printed_rows = [p for p in printed if p.get("site", "").startswith("mistral_")]
    assert len(printed_rows) >= len(rows) and not any(p["in_sum"] for p in printed_rows)
    assert {r["kernel"] for r in rows} >= {"int4_group_matmul_stacked_rawx",
                                           "int4_group_matmul_stacked",
                                           "mlp_swiglu_fused_stacked",
                                           "write_quant_cache_stacked"}
    win = {p["pool"]: p for p in by_phase["mistral_window"]}
    assert set(win) == {"s_major", "head_major"}
    for p in win.values():
        assert (p["bf16_rel_norm_vs_einsum"] <= p["tolerance_rel_norm"]
                < p["bf16_rel_norm_without_window"])
        assert p["attention_max_err"] <= p["attention_tol"] < p["attention_min_err_without_window"]
        assert p["positions"] == [200, 200 + 3 + 24 + 4]
    assert expected["mistral s_major decode step"] == {
        "int4_group_matmul_stacked_rawx": 4 * n_l, "write_quant_cache_smajor": n_l,
        "decode_attention_smajor_stacked": n_l, "int8_prefill_matmul": 1}
    assert expected["mistral head_major decode step"] == {
        "int4_group_matmul_stacked_rawx": 4 * n_l, "write_quant_cache_stacked": n_l,
        "decode_attention_stacked": n_l, "int8_prefill_matmul": 1}


def test_io_phases_rehearsal_on_cpu(monkeypatch):
    """chip_smoke's Llama I/O phases on the CPU at a small size (2 layers of
    hidden 512, 4 heads of 128, vocab 512, bf16): hf_import (the tree
    through two safetensors shards and load_model bit for bit),
    cli_llama_ppl (ppl_eval on that directory equal to the same calls in
    process; a window of 64), host_pack (one layer and the lm_head, bit for
    bit the device pack), packed_checkpoint (both trees saved and loaded,
    3 requests of 10-40 tokens, 4 new: tokens identical, the launches the
    in-memory run expects); timing and the launch checks stubbed, the temp
    directory removed."""
    import dataclasses
    import tempfile

    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from smoothquant_tpu_torch.kernels import kv_write
    from smoothquant_tpu_torch.models import llama

    monkeypatch.setattr(kv_write, "launch_rows", lambda *a, **k: None)
    for name, value in dict(SERVE_REQUESTS=3, SERVE_NEW=4, SERVE_PROMPT=(10, 40),
                            HOST_PACK_LAYERS=1, DECODE_POS=100, LLAMA_PPL=dict(
                                group_size=64, salient_prop=0.05, calib_samples=2,
                                calib_seq_len=32, window=64)).items():
        monkeypatch.setattr(cs, name, value)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a, **k: None)
    expected = {}
    monkeypatch.setattr(cs, "_check_launches",
                        lambda path, launches, expect: expected.setdefault(path, expect))
    printed = []
    monkeypatch.setattr(cs, "emit", printed.append)
    made = []
    real_mkdtemp = tempfile.mkdtemp
    monkeypatch.setattr(tempfile, "mkdtemp", lambda **k: made.append(real_mkdtemp(**k)) or made[-1])

    cfg = dataclasses.replace(llama.LlamaConfig.tiny(vocab_size=512), hidden_size=512,
                              intermediate_size=1024, num_attention_heads=4,
                              num_key_value_heads=4, dtype="bfloat16")
    cpu = torch.device("cpu")
    fp, packed, stacked = cs.build_model(cfg, cpu, cs.SEED, align_o=256)
    launches = cs.run_io(fp, packed, stacked, cfg, cpu, "card")
    assert sum(launches.values()) == 0
    assert made and not any(os.path.exists(d) for d in made)
    phases = {p["phase"]: p for p in printed if "phase" in p}
    hf = phases["hf_import"]
    assert hf["tensors"] == 2 + 9 * cfg.num_hidden_layers + 1 and hf["shards"] == 2
    assert not hf["published_config"]
    assert phases["cli_llama_ppl"]["bit_equal"]
    assert set(phases["cli_llama_ppl"]["cli_json"]["seconds"]) == {
        "load", "smooth", "calibrate", "quantize", "evaluate"}
    hp = phases["host_pack"]
    assert hp["layers"] == 1 and hp["tensors_bit_equal"] > 10
    pc = phases["packed_checkpoint"]
    assert pc["tokens_identical"] and set(pc["file_bytes"]) == {"stacked", "per_layer"}
    n_l = cfg.num_hidden_layers
    steps = pc["decode_steps"]
    assert expected["packed_checkpoint memory"] == expected["packed_checkpoint loaded"]
    got = expected["packed_checkpoint loaded"]
    assert got["int4_group_matmul_stacked_rawx"] == 4 * n_l * steps
    assert got["write_quant_cache_smajor"] == got["decode_attention_smajor_stacked"] == n_l * steps
    assert got["int4_group_matmul"] == 4 * n_l * len(pc["prefill_rows"])
    assert got["int8_prefill_matmul"] >= steps
    assert set(pc["decode_ms_per_step_time_steps"]) == {"memory", "loaded"}


def test_hf_state_dict_names_are_the_importers():
    """chip_smoke's HF names are the ones each family's importer reads:
    params_from_hf_state_dict of hf_state_dict gives the tree back."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from smoothquant_tpu_torch.models import llama, opt

    for mod, cfg, arch in ((llama, llama.LlamaConfig.tiny(), "llama"),
                           (opt, opt.OPTConfig.tiny(), "opt")):
        params = mod.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
        state = cs.hf_state_dict(arch, params, cfg)
        back = mod.params_from_hf_state_dict(state, cfg, device="cpu")
        assert cs._assert_trees_equal(arch, back, params) == len(state)
    assert cs.llama_hf_config(llama.LlamaConfig.llama2_7b()) == cs.LLAMA_HF_CONFIG
    assert cs.opt_hf_config(opt.OPTConfig.opt_1_3b()) == cs.OPT_HF_CONFIG


def test_first_layers_cuts_per_layer_and_stacked_trees():
    """chip_smoke.first_layers: a per-layer tree keeps its first n layers, a
    stacked tree (PackedLinear and fp leaves) the first n along its layer
    axis as views, the config n layers; the rest of the tree untouched."""
    import dataclasses

    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from smoothquant_tpu_torch.models import llama

    cfg = dataclasses.replace(llama.LlamaConfig.tiny(), num_hidden_layers=3)
    fp, packed, stacked = cs.build_model(cfg, torch.device("cpu"), cs.SEED, align_o=128)
    cut, cut_cfg = cs.first_layers(packed, cfg, 2)
    assert cut_cfg.num_hidden_layers == 2 and sorted(cut["layers"]) == ["0", "1"]
    assert cut["lm_head"] is packed["lm_head"] and cut["layers"]["1"] is packed["layers"]["1"]
    st, _ = cs.first_layers(stacked, cfg, 2)
    q, ref = st["layers"]["stacked"]["self_attn"]["qkv_proj"], \
        stacked["layers"]["stacked"]["self_attn"]["qkv_proj"]
    assert q.meta == ref.meta and q.w_qt.shape[0] == 2
    assert q.w_qt.data_ptr() == ref.w_qt.data_ptr() and torch.equal(q.perm, ref.perm[:2])
    norm = st["layers"]["stacked"]["input_layernorm"]["weight"]
    assert norm.shape[0] == 2
    assert cs.first_layers(fp, cfg, 8)[1].num_hidden_layers == 3
