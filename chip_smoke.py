#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (smoothquant_tpu_torch) on one GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit, builds the port's kernels from
   csrc/ with nvcc (sm_90a, one process per source) and prints ptxas'
   register / spill summary; holds the SASS of K6's and K9's wgmma bodies
   to IGMMA / HGMMA, K6's, the stream body's (K5, K8, K13's bf16 kind,
   K1's raw-x kind), the split kernels' of K11, K3 and K12 and K15b's qk
   body's to no I2F, the stream body and K3's split kernels to TMA loads
   and the other split kernels to bulk copies, and the fourteen s8
   kernels of K4 and K15a to IGMMA (K4's salient ones HGMMA too), TMA
   loads, no I2F and no spills, K14's six gate_up kernels to TMA loads and
   they and K16's sixteen row kernels, K7's sixteen and the eight of K2 /
   K10's row body to no I2F, no local memory and no spills (cuobjdump,
   run in the background while the OPT path runs: the `sass` line follows
   the OPT path's); reads the SM clock the per-group scaling floors take.
The real-INT8 OPT path, at OPT-1.3B width and depth (24 layers, hidden
2048, random bf16 weights from seed 0):
   a. the export pipeline of export_int8_model.py:48-76 on the card:
      calibration on 8 random 512-token sequences (the one cut: the CLI
      takes 512), smooth_lm (α = 0.5), static scales, opt_int8.from_float;
   b. K15a at the six linears (2048 rows on its s8 wgmma body, 4 on the
      stream body's (O, K) int8 kind; PR 3's kernels timed beside), K15b at QKᵀ and PV
      (prefill S = 512, decode over a 1024-position cache; bit for bit, the
      body its shape takes and K15a's kernel timed beside) and K16 (2048
      and 4 rows; its row body, the one-block-a-row body timed beside) against
      their plain versions: f32 outputs within 1e-6 of
      the largest magnitude, int8 outputs identical or off by one code in
      under 1e-4 of the elements; K15b's bodies bit for bit at their edges
      (k15b_edges); K15a's two bodies bit for bit at their edges
      (k15a_edges, sums past 2^24) and against each other at 1-64 rows
      (k15a_row_crossover, which int8.STREAM_MAX_ROWS follows); K16's row
      body at 1-2048 rows, C = 8 to 8192, both dtypes and norms, codes
      identical or one off with n_diff counted (k16_edges);
   c. the kernel path against the plain path (the CPU) on a small int8 OPT;
   d. the int8 logits against the smoothed fp model's on a 512-token
      prompt; the int8 prefill of 4 × 512 tokens beside the bf16 fp
      forward; the Generator over int8 caches (4 prompts of 512, 32 new,
      max_len 1024) with its decode ms/step and launches per step.
Then the Llama-2-7B paths:
2. Builds the full-width 32-layer Llama-2-7B from a seeded generator on the
   card and packs it with the serving recipe (W4A4 g64, 5 % salient, bf16
   scales, fused qkv / gate_up over a shared residual basis, identity
   o_proj, int8 lm_head), then stacks the decode tree.
3. Holds every kernel against its plain PyTorch version at the main paths'
   shapes (one JSON line per kernel and shape): K1 in its three modes at
   the four decode linears (N = 4, and 16 and 32; its stream body, the
   dp4a body timed beside as old_body_ms), K6 at the four prefill
   linears (N = 1024), K2's row body at B = 4, S = 512 (q / k / v read as
   views into the qkv rows, q rotated in the same launch; q's bits, codes
   and scales identical to the plain version's; timed beside it by block
   size, without q, the first design alone and the route it replaces:
   apply_rotary's torch ops on q, then the first design copying k / v),
   K3 at B = 4 over 512 ragged
   positions, at B = 64 from DECODE_POS and at B = 4 over 1024 positions
   (its flash body timed beside its split body), K11 over bf16 and int8
   head-major caches at B = 4, S = 512, each permuted site's activation
   prep at N = 64 (one launch of K7's row body: K7b "rms_round" at qkv /
   gate_up, K7a with the salient split at down; the route before, torch's
   RMSNorm and pads around the groups body, timed beside as old_route_ms)
   and at 8 and 32 rows (K7b "rms", the groups body as old_body_ms), K5
   at the four decode linears (N = 64 and 33; K5 in both input modes, the
   tiles body timed beside the stream body), K10's row body at
   B = 64, S = 512 as K2's (per-slot positions, one past the end, then an
   aligned one with one shared table row); K12 over random head-major int8
   caches of 512 positions from
   position 448 (its flash design timed beside its split body): its flat
   body at B = 4 and B = 64, its write body at
   B = 4 (rows and scales identical to K10's), its stacked body at B = 4
   over 8 of the 32 heads' worth of kv heads (Meta-Llama-3-8B's attention
   shape); K14 at the serving pack's gate_up + down, N = 4 and 8 (its
   stream body's two launches; the cooperative body timed beside as
   old_body_ms); after the
   promoted tree is built, K4 at its four prefill linears and the lm_head
   (N = 1024; its s8 wgmma body, PR 2's tiles timed beside); after the bf16 tree is built, K13 at the four decode linears
   (N = 4; its stream body, the __ldg body timed beside as old_body_ms).  Times come from CUDA events around launches queued behind a
   busy-wait, so they are device time.  K8 and K9 are also held to their
   plain versions over every group layout, dtype and ragged row count they
   take (kernel_variants), K6 and K9 over the edges of their wgmma bodies
   and the shapes their rules send elsewhere (wg_edges), K8 and K5 over
   the edges of their stream body, each call made twice for identical
   bits (stream_edges), K13 and K1 at the edges of theirs (k13_edges: 1-8
   rows, ragged K and O, both dtypes; k1_edges: 1-32 rows, ragged O, every
   mode, both scale dtypes, group sizes 16 / 32 / 64, each stream call
   repeated for identical bits and held bit for bit to K5's stream body on
   the plain version's codes); K14's two bodies at their edges (k14_edges:
   1-8 rows, group sizes 16 / 32 / 64, salient blocks and none, the norm on
   and off, both scale dtypes, the shapes that stay on the cooperative
   body); K7's row body at its edges (k7_edges: 1-2048 rows, C = 8 to
   16384 and one not a multiple of 8, group sizes 16 / 32 / 64 / 128 and
   256, no salient channels and 5 %, every norm mode, bf16 and f32 x and
   x_sal, rows that start off 16 bytes, each call repeated for identical
   bits, the groups body beside; K7a at rounding edges bit for bit); the
   prep + K5 pair at qkv, 32 and 64 rows, against K5 alone (k7_k5_chain);
   K1 against K7b / K7a + K5 at 1-32 rows
   (k1_vs_k5, which real_linear.K1_MAX_TOKENS follows); K4's wgmma body at
   its edges (k4_edges: N = 256 / 333 / 800 / 1024, k_s 0 / 16 / 208 /
   640, bf16 and f32 out, ragged K and O, each call repeated).  K11 also over Llama's
   per-slot int8 pool at B = 64 (positions 100-511), the flash body timed
   beside the split body at each K11 shape, and the split body at its
   edges (k11_edges: S, D, rep, both caches, ALiBi, masked slots, every
   cluster size; one call repeated 400 times for identical bits), and the
   split bodies of K3 and K12 at theirs (k3_edges: S, D, rep, ragged and
   masked slots; k12_edges: the three bodies, pos 0, 9 and S − 1, the write
   body's cache; every cluster size, repeated calls identical), and K2 /
   K10's row body at its edges (kv_write_edges: both layouts and dtypes,
   D = 64 / 128 / 256, n_kv 1 / 8 / 32 at 1 and 4 query heads a kv head,
   1-130 slots, per-slot and aligned positions at 0, S − 1 and past S,
   Llama's and Bloom's qkv rows, rows off 16 bytes on its scalar form;
   bit for bit, every call repeated).  Beside no_fallback, the stacked
   path over a salient block stored in another dtype than the rows, bit
   for bit against the block in the rows' dtype, the prep and K5 the only
   launches of a call (salient_block_in_another_dtype).
4. Checks the kernel path against the plain path (the CPU) on a small
   model, f32 and bf16: the S-major prefill and one stacked decode step;
   a promoted prefill over head-major int8 caches and one Generator decode
   step; one stacked bf16-baseline decode step; one stacked decode step
   of 40 and of 16 rows over a head-major per-slot int8 pool; one aligned
   head-major decode step in each ForwardContext composition (fuse_attn
   "auto", "fused", "off", "auto" with fuse_mlp), and "auto" on a GQA twin.
5. Serves requests through ContinuousBatcher(max_batch=4, max_len=512,
   quant_kv=True, smajor=True) prefilling on the nibble tree.  Then the
   aligned stacked head-major int8 decode at B = 4 from position 448 in
   its four compositions ("auto": K1 128, K12 32, K10 32 a step; "fused":
   K1 128, K12 32; "off": K1 128, K10 32, K11 32; "auto" + fuse_mlp: K1 64,
   K14 64 (32 gate_up and 32 down launches), K12 32, K10 32), window by
   window with the S-major W4A4 step:
   ms/step, device busy, idle share, launches per step.
6. Promotes a plain nibble pack of the same weights to int8
   (promote_model_int8): a 1024-token prompt through the 32-layer promoted
   tree with no cache (prefill tokens/s), the Generator (4 prompts of 200
   tokens, 32 new, promoted prefill, nibble decode over int8 head-major
   caches), and the serving run again with the promoted prefill twin.
   The 64-slot slice: ContinuousBatcher(max_batch=64, max_len=512,
   quant_kv=True) at its default head-major pool with the promoted twin, a
   warm wave, then 96 requests (100-240 prompt tokens, 32 new, chunk 8):
   tokens/s, decode ms/step and device busy share of a steady window,
   launches per step (K7b 64, K7a 32, K5 128, K10 32, K11 32, K1 none); then B = 64
   decode from position 448 over the head-major and the S-major pool with
   the same tree and over the aligned head-major cache in "auto", window
   by window (K10 + K11 and K12 + K10 against K2 + K3; the aligned step
   launches K7b 64, K7a 32, K5 128, K12 32, K10 32; the head-major step
   profiled once more on the prep's route before), and B = 32 over the
   head-major pool in windows, by host clock and device busy (K7b 64, K7a
   32, K5 128 a step: above K1_MAX_TOKENS rows the linears take K5 on
   activations made as K1 makes them; the route before profiled beside).
   The identity-int8 forward's switch (PREFILL_KERNEL_MIN_TOKENS) is timed
   on both sides, K4 against torch._int_mm, at 4 to 1024 rows.
7. The README quick start on the same fp weights: calibration
   (get_act_scales, get_calib_feat) on 4 random sequences of 512 tokens
   (the one cut: the JAX CLI takes 512), smooth_lm (α = 0.85), pack_model
   with its defaults (per-layer int8-container packs, W4A4 g64, 5 %
   salient); K8 at q / gate / down (N = 1, 4, 16 and 64, the stream body
   with the tiles body timed beside it) and at single-group packs (G = 1,
   N = 4 and 512), K9's four bodies at N = 512 and 2048, each call on the
   next layer's weights (cold, as a decode step finds them);
   real_quant_linear timed cold in "int" (K8) and "dequant" (K9) at N = 4
   to 2048 on gate_proj and down_proj (the crossover that
   INT_PATH_MAX_TOKENS holds); then Generator(quant_kv=True), 4 prompts of
   512 tokens and 32 new: prefill tokens/s, decode ms/step (host clock and
   device busy), launches (K8 7·L and K11 L a decode step, the prefill's
   7·L on K9 above the crossover, else a second prefill forced to
   "dequant"), and the packed logits against the fp model's.
   Then the simulated (fake-quant) path, on the quick start's smoothed
   weights and calibration vectors (run_sim): every weight and activation
   quantizer (sim_cases: per-channel / per-token, per-tensor, per-group
   unsorted and sorted by "max", "mean_std" and "argmax"; groups of 64 and
   128; 4 and 8 bits; f32 and bf16) at the 7B's weight and prefill
   activation shapes, and quantize_linear_params with 5 % salient
   channels, on the card bit for bit against the same call on a CPU copy
   (sim_quantizers); a 2-layer simulated Llama and OPT (BMM inputs
   quantized) on the card against the CPU (sim_reference);
   quantize_model("llama") for W8A8_SMOOTHQUANT and W4A4 g64 with 5 %
   salient channels (sim_model: seconds, GiB); the W8A8 per-channel /
   per-token simulated forward against the forward of pack_model's default
   W8A8 pack (K4 7·L launches) over 1 × 512 tokens (sim_vs_packed:
   relative norm error, top-1 agreement); perplexity of fp, W8A8 and W4A4
   through Evaluator over 4 random windows of 2048 tokens, seconds a
   window (sim_ppl; random weights: no measure of quality).
8. The bf16 baseline: pack_fp_decode + stack_layers of the same weights,
   decoded at B = 4, cache 512, from position 448 over a bf16 head-major
   cache, and the W4A4 stacked tree over the S-major cache at the same
   point, taking turns window by window; vs_bf16 is the bf16 ms/step over
   the W4A4 one, by host clock and by device busy time.
9. The Bloom path at BLOOM-7b1 width and depth (bloom_7b1(): 30 layers,
   hidden 4096, 32 heads of 128, vocab 250880, tied embeddings; random
   bf16 weights from seed 0), after the Llama trees are freed:
   a. K11's ALiBi body against its plain version at B = 4 over 640
      positions and B = 64 over 512, bf16 and int8 bodies; K7b at the
      pack's C = 4096 and 16384 inputs (g64, 5 % salient) at 1, 4, 5 and
      130 rows with and without its RMSNorm; K4's raw-x mode against its
      pre-quantized mode on the same bytes, bit for bit, at (1024,
      4096→11008) with 5 % salient channels, at N = 333 and at one K step;
   b. the reference check: a small Bloom's kernel path (card) against its
      plain path (CPU), per-layer and stacked decode over fp and int8
      caches, and the stacked step against the per-layer one on the card,
      each within BLOOM_REF_TOL, and a control (one weight code moved by
      one step) that must read above the kernel-against-plain bound;
   c. calibration on 4 random 512-token sequences (the one cut, as the
      quick start's), smooth_lm("bloom", α = 0.5), pack_model("bloom",
      W4A4 g64, 5 % salient, nibble, k groups aligned to 8, O to 256);
   d. the Generator over per-layer int8 caches of 640 (4 prompts of 512,
      32 new: K6 at the 2048-row prefill, K6 and K11's ALiBi body a decode
      step), the tied unembedding's device time, the packed logits against
      the fp model's; K6 against its plain version on the pack's four
      linears at 2048 and 4 rows, the input gathered;
   e. stack_layers of the pack: K1 at 4 rows and K7a + K5 at 64 against
      their plain versions on its four linears, the input gathered; K10
      with rotary off at B = 4 and 64; K7b + K5 against K1 on layer 0; then
      the stacked decode over a stacked head-major int8 cache from
      position 448 at B = 4 (the input gathered, K1, K10 with rotary off,
      K11's ALiBi body) and B = 64 (K7a + K5 in place of K1), three
      windows of 8 steps each, beside the decode byte bound.
Every path runs with the launch counts reset just before it and read just
after, and fails unless each kernel launched as often as the path implies.
The W4A4 S-major step at B = 4, the head-major steps at 64 and 32 rows and
Bloom's two steps are profiled once more with each layer's cache write on
the route before K2 / K10's row body (old_write_route: apply_rotary's torch
ops on q in the layer loop, the first design copying k / v): busy time and
kernels a step beside the path's own.
The serving layer on every tree and pool (each request's tokens held to
its own greedy Generator run, its prompt alone at the pool's width, up to
the first step whose top-2 logit gap falls below SERVE_GAP_TOL of
|logits|∞, SMAJOR_EINSUM_GAP_TOL over the S-major pool; the launches
checked; each on the first SERVE_LAYERS = 8 layers of its trees, the
cut that keeps the run inside its limit):
   - tied_and_unfused (after the reference check): a tied twin of the fp
     7B gives the untied twin's 1 × 512 logits bit for bit; the unfused
     pack_model(shared_residual_basis, fold_perms) within half the
     quantization's own effect of the fused serving pack;
   - serve_per_layer (after the promoted tree is built): the serving pack
     kept per-layer through ContinuousBatcher over per-slot per-layer
     pools — int8 head-major (K6, K11, K4's lm_head) prefilled on the pack
     and on its promoted twin (K4), S-major (the einsum); after the quick
     start, its pack through the Generator under compute "int" (K8) and
     "dequant" (K9);
   - serve_fp_pool (after the bf16 phases): the JAX batcher's default fp
     pool, the bf16 stacked tree (K13, K11) and the per-layer bf16 tree
     under attn="kernel" (K11, no einsum in a step);
   - serve_families: OPT-1.3B's fp per-layer tree (after its prefill) and
     BLOOM-7b1's fp stacked tree through the per-layer body over the stack
     (after its Generator), no kernel launched;
   - Mistral-7B (run_mistral, after the Llama trees are freed: the JAX
     package's mistral_7b preset at 8 of its 32 layers, random bf16
     weights from seed 0, calibration on 4 random 512-token sequences, the
     serving pack): K1,
     K7 + K5, K14 and K10 against their plain versions at its GQA widths
     (out of the kernels line's sums), then the stacked decode at B = 4
     from position 4600 in caches of 5120 (keys 0-504 outside the 4096
     window) over the S-major pool (K2, K3) and the head-major one with
     per-slot positions ("off": K10, K11): each layer's attention against
     the einsum over the same dequantized cache with and without the
     window, the step's logits against the einsum step and the windowless
     step, three windows of 8 steps.
The serving tier and the repairs of PR 21:
   - k3_edges and k12_edges also run K3 and K12 past 8 query rows a kv head
     (groups of 8 rows, grid z) and at a caller's softmax scale
     (ATTN_ANY_REP_CASES: rep 16 and 12 over 2 kv heads at D = 128, S = 512,
     B = 4 and 64; rep 16 at D = 256 on the flash body; sm_scale 1.0; K12's
     stacked and write bodies, the write's cache bit for bit), every call's
     bits repeated; rep 16 and 12 at B = 4 timed beside SDPA over the kv
     heads expanded (rows out of the kernels line's sums);
   - llama_rep16_decode (after the edges): Llama-2-7B's width at 32 query
     heads over 2 kv heads, 2 layers, and its small f32 twin: the stacked
     decode through Llama's gate over the S-major cache and the aligned
     head-major one ("auto", "fused") from DECODE_POS, each step's launches
     checked, against the per-layer step layer by layer (the twin's S-major
     layers held to STACKED_VS_PER_LAYER_TOL, the rest reported);
   - cluster (after serve_per_layer): ClusterFrontend over 1 and 2
     replicas of the serving pack's first SERVE_LAYERS layers on the card,
     12 requests, tokens identical across the two runs, per-host and
     cluster tokens/s; cluster_sim: scaling_efficiency on
     skewed_trace(48, seed=3) at 2 and 4 hosts under the cost model the
     1-host run measured (simulated, labeled so);
   - falcon_serving: Falcon-7B's stacked tree through the batcher's
     per-slot stacked pool, and serve_bloom_slots (the end of run_bloom):
     BLOOM-7b1's stacked tree at SERVE_LAYERS layers, 8 requests, 16 new;
     each request held to the stacked tree's own greedy decode
     (stacked_reference) up to the first near-tie, every decode step the
     stacked decode's launches (no K6);
   - examples (after the Bloom path): the three examples' main in this
     process on the card.
I/O and the CLI (files under a temporary directory, removed at the end
of their phase; file reads warm, just written):
   - cli_opt (at the end of the OPT path): the weights export_opt draws
     written as an HF directory (facebook/opt-1.3b's config.json, two
     bf16 safetensors shards) beside the export's random token stream;
     generate_act_scales as `python -m` in a child process (its scales
     those of get_act_scales here, bit for bit), export_int8_model
     --act_scales_path, load_int8_opt: the int8 model bit for bit
     export_opt's; the Generator over it gives opt_generator's tokens with
     its launches; ppl_eval --smooth --quantize over one window of 2048
     and run_experiments over 2 group sizes × 2 salient shares; each CLI's
     seconds and JSON;
   - hf_import (after the kernel checks of the Llama path): the fp 7B as
     an HF directory (Llama-2-7b-hf's config.json, two bf16 safetensors
     shards, 13.5 GB) and load_model back, bit for bit; bytes, seconds,
     GB/s, the disk's free space;
   - cli_llama_ppl: ppl_eval on that directory (W4A4 g64, 5 % salient,
     calibration 4 × 512, one window of 2048), its perplexity equal to the
     same calls in this process bit for bit; seconds by stage;
   - host_pack: pack_model(host_pack=True) with the serving recipe on 4 of
     the 32 layers and the lm_head (the cut), bit for bit the device pack
     of the same tree, leaf by leaf; the seconds of each;
   - packed_checkpoint: the stacked decode tree and the per-layer prefill
     tree saved and loaded (bytes, seconds), then 8 requests through
     ContinuousBatcher (4 slots, S-major int8 pool, cache 512) on the
     loaded trees: tokens identical to the trees' in memory, the same
     launches (K1, K2, K3, K4 a step, K6 a prefill); a decode step timed
     on both by utils.benchtools.time_steps.
10. Prints each K5, K6 and K8 row's per-group scaling floor beside its
   bound (scaling_floors), the `kernels` JSON line (all eighteen kernels,
   K4's raw-x and K11's ALiBi bodies named by their sites and counted
   apart), the card line, then the `ok` line last.

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
# the 64-slot serving slice: the batcher's default head-major int8 pool, 96
# requests; the largest row count the JAX package's rawx branch takes (K1
# up to real_linear.K1_MAX_TOKENS rows, above them K7b / K7a + K5)
SLOT_BATCH, SLOT_REQUESTS, MID_BATCH = 64, 96, 32
DECODE_POS = 448             # the bench's aligned decode position (bench.py:179-180)
# K12's stacked body: Meta-Llama-3-8B's attention shape (config.json: 32
# query heads over 8 kv heads), as a share of the model's heads
GQA_SHARE = 4
# the aligned head-major decode's compositions: (name, fuse_attn, fuse_mlp)
COMPOSITIONS = (("auto", "auto", False), ("fused", "fused", False), ("off", "off", False),
                ("auto_mlp", "auto", True))
ALIGNED_ROWS = 8             # the reference check's aligned steps: K14's largest N
GEN_PROMPT, GEN_NEW, GEN_MAX_LEN = 200, 32, 256
# the real-INT8 OPT path: calibration on 8 of the export CLI's 512 samples
# (export_int8_model.py:20), 512-token sequences; 4 prompts of 512, 32 new
# tokens over int8 caches of 1024 positions
CALIB_SAMPLES, CALIB_LEN = 8, 512
OPT_BATCH, OPT_PROMPT, OPT_NEW, OPT_MAX_LEN = 4, 512, 32, 1024
# the README quick start on Llama-2-7B: calibration on 4 random sequences of
# 512 tokens (the one cut: the JAX CLI takes 512 samples,
# cli/generate_act_scales.py:18-19), smooth_lm at α = 0.85, the default
# pack; the Generator over 4 prompts of 512 tokens, 32 new; the rows at
# which the int (K8) and dequant (K9) paths are timed against each other
QS_SAMPLES, QS_LEN, QS_ALPHA = 4, 512, 0.85
QS_BATCH, QS_PROMPT, QS_NEW = 4, 512, 32
QS_MAX_LEN = 640             # the caches' length: a multiple of 128, so K11 tiles it
QS_PROFILE_NEW = 4           # tokens of the profiled generate (decode busy time)
# the reference check's per-layer parts, by recipe: (prompt rows a sequence,
# compute modes, relative-norm bound in f32 and in bf16).  W4A8 over more
# rows than INT_PATH_MAX_TOKENS takes "auto" through K9 at prefill and K8 at
# decode; W4A4, the quick start's recipe, at the rows where last-bit noise
# moves no int4 code (tests/test_torch_chip_smoke.py holds both choices).
PER_LAYER_PARTS = {
    "w4a8": (129, ("int", "dequant", "auto"), {"float32": 5e-2, "bfloat16": 1e-1}),
    "w4a4": (12, ("int", "dequant"), {"float32": 1e-2, "bfloat16": 1e-1}),
}
CROSSOVER_N = (4, 16, 64, 128, 256, 512, 1024, 2048)
# the Bloom path at BLOOM-7b1 width and depth: calibration on 4 random
# sequences of 512 tokens (the one cut, as the quick start's), smooth_lm at
# SmoothQuant's α = 0.5; the Generator over 4 prompts of 512, 32 new, int8
# caches of 640 (a multiple of 128, so K11 tiles it); the stacked decode at
# B = 4 and 64 over MAX_LEN positions from DECODE_POS
BLOOM_SAMPLES, BLOOM_LEN, BLOOM_ALPHA = 4, 512, 0.5
BLOOM_BATCH, BLOOM_PROMPT, BLOOM_NEW, BLOOM_MAX_LEN = 4, 512, 32, 640
BLOOM_SLOT_BATCH = 64
# serve_bloom_slots: the stacked tree's first SERVE_LAYERS layers through the
# batcher's per-slot stacked pool, SERVE_REQUESTS prompts, this many new tokens
BLOOM_SERVE_NEW = 16
BLOOM_PACK = dict(nibble=True, align_k_groups=8, align_o=256)   # the stacked decode's layout
# K4's raw-x mode against its pre-quantized mode: (site, (N, K, O)) — Llama-2-7B's
# promoted gate_proj at the prefill's rows (timed), a ragged N, one K step
# the small-Bloom reference check's bounds on the logits' relative norm
# error, by dtype: (kernel path against plain, stacked step against
# per-layer over the fp cache, the same over the int8 cache) — see
# bloom_reference_check for the readings they were set from
BLOOM_REF_TOL = {"float32": (1e-5, 2e-4, 1e-6), "bfloat16": (1e-5, 1.5e-1, 1e-6)}
# K3's and K12's query rows above 8 a kv head (groups of 8, grid z) and a
# caller's softmax scale, over S = 512 with 2 kv heads: (rep, B, head_dim,
# sm_scale); the B = 4 cases at D = 128 and the rule's scale are timed
ATTN_ANY_REP_CASES = ((16, 4, 128, None), (12, 4, 128, None), (16, 64, 128, None),
                      (12, 64, 128, None), (16, 4, 256, None), (16, 4, 128, 1.0))
ATTN_ANY_REP_KV, ATTN_ANY_REP_S = 2, 512
# kv_write_edges: head_dims, (kv heads, query heads a kv head), slots
KV_EDGE_DIMS = (64, 128, 256)
KV_EDGE_HEADS = ((1, 1), (1, 4), (8, 1), (8, 4), (32, 1), (32, 4))
KV_EDGE_SLOTS = (1, 5, 64, 130)
K4_RAWX_CASES = (("gate@1024", (PREFILL_N, 4096, 11008)), ("ragged@333", (333, 4096, 11008)),
                 ("one_k_step", (256, 64, 512)))
# the simulated (fake-quant) path on the quick start's smoothed 7B: the
# quantizers at Llama-2-7B's weight (O, K) and prefill activation (N, C)
# shapes, the W8A8 simulated forward against its pack over 1 × 512 tokens,
# perplexity over 4 windows of 2048 tokens (the reference evaluates
# WikiText-2 in windows of 2048, ppl_eval.py:32-62)
SIM_WEIGHT_SHAPES = ((4096, 4096), (11008, 4096), (4096, 11008))
SIM_ACT_SHAPES = ((2048, 4096), (2048, 11008))
SIM_PACKED_TOKENS = 512
SIM_PPL_WINDOWS, SIM_PPL_WINDOW = 4, 2048


def _die(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


_T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line carries t_s, the seconds since start."""
    if "phase" in obj:
        obj = {**obj, "t_s": round(time.perf_counter() - _T0, 1)}
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def sm_clock_mhz() -> float:
    """The card's highest SM clock (MHz), which the per-group scaling floor
    takes."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return float(out.splitlines()[0])


# ---------------------------------------------------------------- timing


# caps device_ms's repetitions while set (the rows of the Mistral, Falcon,
# Mixtral and Bloom paths at those models' own shapes, off the kernels line's
# sums: the run's 1200 s limit)
_MAX_REPS = None


def device_ms(fn, n_iter: int, reps: int = 5) -> float:
    """Median device ms of one fn(i) call: the launches are queued behind a
    busy-wait kernel, so host enqueue gaps do not enter the events."""
    import torch

    if _MAX_REPS is not None:
        reps = min(reps, _MAX_REPS)
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


def _codes_close(name, got, ref, max_share=1e-4):
    """int8 outputs: identical, or off by one code in under max_share of the
    elements; returns (max |diff|, the count of codes that differ)."""
    d = (got.int() - ref.int()).abs()
    err, n_diff = int(d.max()), int((d != 0).sum())
    if err > 1 or n_diff >= max_share * d.numel():
        raise AssertionError(f"{name}: {n_diff} of {d.numel()} codes differ, "
                             f"by up to {err}")
    return err, n_diff


# ---------------------------------------------------------------- model


def _recipe(cfg, seed, group_size):
    """(W4A4 recipe, int8 lm_head recipe, salience vectors) of the bench."""
    import dataclasses

    import numpy as np

    from smoothquant_tpu_torch.models import llama
    from smoothquant_tpu_torch.quant.config import QuantConfig, w4a4_group

    qcfg = dataclasses.replace(w4a4_group(group_size=group_size, salient_prop=0.05),
                               scale_dtype="bfloat16")
    head = QuantConfig(weight_quant="per_channel", act_quant="per_token",
                       quant_bits=8)
    rng = np.random.default_rng(seed)
    feat = {key: rng.uniform(0.1, 1.0, size=(
        cfg.intermediate_size if "down_proj" in key else cfg.hidden_size,))
        for _, key, _ in llama.quantizable_linears(cfg)}
    return qcfg, head, feat


def build_model(cfg, dev, seed, group_size=64, align_o=2048):
    """Random Llama and its serving packs: (fp params, per-layer tree,
    stacked decode tree)."""
    import torch

    from smoothquant_tpu_torch.models import llama
    from smoothquant_tpu_torch.models.registry import pack_model

    qcfg, head, feat = _recipe(cfg, seed, group_size)
    gen = torch.Generator(device=dev).manual_seed(seed)
    fp = llama.init_params(gen, cfg, dev)
    packed = pack_model(
        "llama", fp, cfg, qcfg, input_feat=feat, nibble=True, lm_head_qcfg=head,
        align_k_groups=8, align_o=align_o, fuse=True, fold_perms=True,
        shared_residual_basis=True, identity_keys=("o_proj",))
    return fp, packed, llama.stack_layers(packed, cfg)


def build_promoted(fp, cfg, seed, group_size=64):
    """The prefill twin, as bench.py:266-312 builds it: a plain fused nibble
    pack of the same weights (no shared basis, fold or identity layout,
    which promote_int8 refuses), promoted to int8 per column."""
    from smoothquant_tpu_torch.kernels.pack import promote_model_int8
    from smoothquant_tpu_torch.models.registry import pack_model

    qcfg, head, feat = _recipe(cfg, seed, group_size)
    return promote_model_int8(pack_model("llama", fp, cfg, qcfg, input_feat=feat,
                                         nibble=True, lm_head_qcfg=head, fuse=True))


def build_bf16(fp, cfg):
    """The bf16 baseline tree: pack_fp_decode + stack_layers (one copy)."""
    from smoothquant_tpu_torch.models import llama

    return llama.stack_layers(llama.pack_fp_decode(fp, cfg), cfg)


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
    "int4_group_matmul_stacked": (
        "smoothquant_tpu_torch/kernels/csrc/int4_group_matmul.cu",
        "smoothquant_tpu/kernels/int4_group_matmul.py:807"),
    "quantize_acts_grouped_t": (
        "smoothquant_tpu_torch/kernels/csrc/act_prep.cu",
        "smoothquant_tpu/kernels/act_prep.py:66"),
    "norm_quantize_acts_t": (
        "smoothquant_tpu_torch/kernels/csrc/act_prep.cu",
        "smoothquant_tpu/kernels/act_prep.py:182"),
    "write_quant_cache_stacked": (
        "smoothquant_tpu_torch/kernels/csrc/cache_write.cu",
        "smoothquant_tpu/kernels/cache_write.py:114"),
    "write_quant_cache_smajor": (
        "smoothquant_tpu_torch/kernels/csrc/attn_smajor.cu",
        "smoothquant_tpu/kernels/attn_smajor.py:340"),
    "decode_attention_smajor_stacked": (
        "smoothquant_tpu_torch/kernels/csrc/attn_smajor.cu",
        "smoothquant_tpu/kernels/attn_smajor.py:213"),
    "int8_prefill_matmul": (
        "smoothquant_tpu_torch/kernels/csrc/int8_wg.cu",
        "smoothquant_tpu/kernels/int8_prefill.py:282"),
    "decode_attention_stacked": (
        "smoothquant_tpu_torch/kernels/csrc/decode_attention.cu",
        "smoothquant_tpu/kernels/decode_attention.py:306"),
    "fp_matmul_stacked": (
        "smoothquant_tpu_torch/kernels/csrc/fp_matmul.cu",
        "smoothquant_tpu/kernels/fp_matmul.py:77"),
    "int8_linear": (
        "smoothquant_tpu_torch/kernels/csrc/int8_wg.cu",
        "smoothquant_tpu/kernels/int8.py:105"),
    "int8_bmm": (
        "smoothquant_tpu_torch/kernels/csrc/int8.cu",
        "smoothquant_tpu/kernels/int8.py:162"),
    "norm_quant": (
        "smoothquant_tpu_torch/kernels/csrc/norm_quant.cu",
        "smoothquant_tpu/kernels/norm_quant.py:61"),
    "fused_attn": (
        "smoothquant_tpu_torch/kernels/csrc/attn_fused.cu",
        "smoothquant_tpu/kernels/attn_fused.py:345"),
    "mlp_swiglu_fused_stacked": (
        "smoothquant_tpu_torch/kernels/csrc/mlp_fused.cu",
        "smoothquant_tpu/kernels/mlp_fused.py:534"),
    "int_group_matmul": (
        "smoothquant_tpu_torch/kernels/csrc/int_group_matmul.cu",
        "smoothquant_tpu/kernels/int_group_matmul.py:157"),
    "dual_path_matmul": (
        "smoothquant_tpu_torch/kernels/csrc/quant_matmul.cu",
        "smoothquant_tpu/kernels/quant_matmul.py:248"),
}


def _sites(layer):
    """(site, linear, mode) of one layer's linears, per-layer or stacked:
    Llama's four (mode "rms", the RMSNorm fused in; "mask", the identity
    layout; None, a pre-permuted input); Bloom's and Falcon-7B's four,
    named bloom_* / falcon_*, and Mixtral's q and k (v and o repeat their
    shapes), router and expert w1 / w3 / w2, named mixtral_* — a stacked
    tree's experts viewed
    as the (L·E, ...) stacks the stacked decode indexes, a per-layer one's
    expert 0 (mode "gather": the input in the original channel order,
    gathered by the layer's perm first, as the path does; no norm fuses)."""
    if "block_sparse_moe" in layer:
        from smoothquant_tpu_torch.models.mixtral import _flatten_le

        sa, moe = layer["self_attn"], layer["block_sparse_moe"]
        ex = moe["experts"]
        ex = _flatten_le(ex["stacked"]) if "stacked" in ex else ex["0"]
        return tuple((f"mixtral_{name}", lin, "gather") for name, lin in (
            ("q", sa["q_proj"]), ("k", sa["k_proj"]), ("router", moe["gate"]),
            ("w1", ex["w1"]), ("w3", ex["w3"]), ("w2", ex["w2"])))
    if "self_attention" in layer:
        sa, mlp = layer["self_attention"], layer["mlp"]
        fam = "bloom" if "post_attention_layernorm" in layer else "falcon"
        return tuple((f"{fam}_{name}", lin, "gather") for name, lin in (
            ("qkv", sa["query_key_value"]), ("dense", sa["dense"]),
            ("h_to_4h", mlp["dense_h_to_4h"]), ("4h_to_h", mlp["dense_4h_to_h"])))
    sa, mlp = layer["self_attn"], layer["mlp"]
    return (("qkv", sa["qkv_proj"], "rms"), ("o", sa["o_proj"], "mask"),
            ("gate_up", mlp["gate_up_proj"], "rms"), ("down", mlp["down_proj"], None))


def check_rawx(stacked, dev, gen, n=MAX_BATCH):
    """K1 vs plain at the four decode linears of the stacked tree, N rows
    (Llama: 4, the B = 4 paths; 16 and 32; Bloom: 4, each layer's input
    gathered by its perm), on the body its rule picks (the stream body at
    these shapes) with the __dp4a body timed beside it (old_body_ms), each
    call on the next layer's weights.  Bloom's rows stay out of the kernels
    line's sums."""
    import torch

    from smoothquant_tpu_torch.kernels import int4_group_matmul as k1
    from smoothquant_tpu_torch.kernels.real_linear import _salient_gather
    from smoothquant_tpu_torch.utils import roofline

    rows = []
    for site, lin, mode in _sites(stacked["layers"]["stacked"]):
        m = lin.meta
        n_layers, half, o = lin.w_qt.shape
        c = m.in_features
        x = torch.randn((n, c), generator=gen, device=dev).to(torch.bfloat16)
        norm = None
        x_in = [x] * n_layers
        x_sal = [None] * n_layers
        if mode == "rms":
            norm = (torch.rand((n_layers, c), generator=gen, device=dev) + 0.5
                    ).to(torch.bfloat16).float()
        elif mode == "mask":
            norm = lin.ns_mask
            x_sal = [_salient_gather(lin, x, lin.perm[i]) for i in range(n_layers)]
        elif mode == "gather":
            x_in = [x.index_select(1, lin.perm[i]) for i in range(n_layers)]
        kernel_mode = None if mode == "gather" else mode
        kw = dict(group_size=m.group_size, act_bits=m.act_bits,
                  num_salient=m.num_salient, eps=1e-5, norm_kind=kernel_mode)
        args = lambda i: (i % n_layers, x_in[i % n_layers], norm, lin.w_qt, lin.w_scales_t,
                          lin.w_sal_t, x_sal[i % n_layers])
        got = k1.int4_group_matmul_stacked_rawx(*args(3), **kw)
        ref = k1.rawx_plain(*args(3), **kw)
        torch.cuda.synchronize()
        err = _close(f"K1 {site}", got, ref, 1e-2)
        body = k1.rawx_body(n, c, o, 2 * half, m.group_size, lin.w_sal_t.shape[1], x.dtype)
        w_lib = [torch.randn((c, o), generator=gen, device=dev).to(torch.bfloat16)
                 for _ in range(4)]
        n_bytes, ops = roofline.rawx_cost(n, c, o, 2 * half, m.group_size,
                                          lin.w_sal_t.shape[1], norm=kernel_mode is not None,
                                          x_sal_external=mode == "mask")
        b_ms, b_by = roofline.bound_ms(n_bytes, ops)
        rows.append(dict(
            kernel="int4_group_matmul_stacked_rawx",
            site=site if n == MAX_BATCH else f"{site}@{n}", mode=mode or "raw", body=body,
            shape=[n, c, o], max_err=err, in_sum=n == MAX_BATCH and mode != "gather",
            kernel_ms=device_ms(lambda i: k1.int4_group_matmul_stacked_rawx(*args(i), **kw),
                                n_layers),
            old_body_ms=device_ms(lambda i: k1.int4_group_matmul_stacked_rawx(
                *args(i), **kw, body="dp4a"), n_layers),
            plain_ms=device_ms(lambda i: k1.rawx_plain(*args(i), **kw), 4, reps=3),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=device_ms(lambda i: x @ w_lib[i % 4], 16),
            library="torch.matmul bf16 (N, C) @ (C, O), yardstick only"))
        del w_lib
        emit(rows[-1])
    return rows


def check_gmm(packed, cfg, dev, gen, n=PREFILL_N):
    """K6 vs plain at the four linears of the per-layer tree, N rows (Llama:
    the prefill's 1024; Bloom: the Generator's prefill and decode rows, the
    input gathered by the layer's perm as the path does, out of the kernels
    line's sums)."""
    import torch

    from smoothquant_tpu_torch.kernels import int4_group_matmul as k6
    from smoothquant_tpu_torch.kernels.pack import quantize_activations_packed_int
    from smoothquant_tpu_torch.kernels.real_linear import _identity_nibble_quantize
    from smoothquant_tpu_torch.utils import roofline

    n_layers = cfg.num_hidden_layers
    rows = []
    for site_i, (site, _, _) in enumerate(_sites(packed["layers"]["0"])):
        lins = [_sites(packed["layers"][str(i)])[site_i][1] for i in range(n_layers)]
        m = lins[0].meta
        x = torch.randn((n, m.in_features), generator=gen, device=dev).to(torch.bfloat16)
        if m.layout != "identity" and not m.pre_permuted:
            x = x.index_select(1, lins[0].perm)
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
        n_bytes, ops = roofline.gmm_cost(n, o, 2 * half, m.group_size,
                                         lins[0].w_sal_t.shape[0])
        b_ms, b_by = roofline.bound_ms(n_bytes, ops)
        name = site if n == PREFILL_N else f"{site}@{n}"
        rows.append(dict(
            kernel="int4_group_matmul", site=name, body=k6.gmm_body(o, m.group_size, x_sal.dtype),
            shape=[n, c, o], scalings=[n, o, 2 * half, m.group_size],
            max_err=err, in_sum=not site.startswith("bloom_"),
            kernel_ms=device_ms(lambda i: k6.int4_group_matmul(*args(i), **kw), 8),
            plain_ms=device_ms(lambda i: k6.int4_group_matmul_plain(*args(i), **kw), 2,
                               reps=3),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=device_ms(lambda i: x @ w_lib[i % 2], 8),
            library="torch.matmul bf16 (N, C) @ (C, O), yardstick only"))
        del w_lib
        emit(rows[-1])
    return rows


def _random_cache(cfg, dev, gen, b=MAX_BATCH, s=MAX_LEN, n_layers=None):
    """A stacked S-major int8 cache of random codes and scales (every layer
    of cfg's by default)."""
    import torch

    from smoothquant_tpu_torch.models.common import SMajorQuantKVCache

    c = SMajorQuantKVCache.create(b, s, cfg.num_key_value_heads, cfg.head_dim, dev,
                                  n_layers=n_layers or cfg.num_hidden_layers)
    for t in (c.k_q, c.v_q):
        t.copy_(torch.randint(-127, 128, t.shape, generator=gen, device=dev,
                              dtype=torch.int8))
    for t in (c.k_scale, c.v_scale):
        t.copy_(torch.rand(t.shape, generator=gen, device=dev) * 0.02 + 0.005)
    return c


def _qkv_parts(b, n_q, n_kv, d, dtype, gen, dev, layout="llama", offset=0):
    """One decode position's qkv rows as the qkv linear leaves them, (B, F)
    in `dtype` starting `offset` elements into their buffer (1: rows that
    start off 16 bytes), every head scaled apart: Llama's [q | k | v] heads
    or Bloom's interleaved (nh, 3, D).  Returns (rows, (q, k, v)), q / k /
    v (B, heads, D) views into the rows."""
    import torch

    n_heads = n_q + 2 * n_kv
    heads = (torch.randn((b, n_heads, d), generator=gen, device=dev)
             * (torch.rand((b, n_heads, 1), generator=gen, device=dev) * 8 + 0.1))
    if layout == "bloom":
        heads = torch.stack([heads[:, :n_q], heads[:, n_q:n_q + n_kv],
                             heads[:, n_q + n_kv:]], dim=2)
    buf = torch.zeros((offset + heads.numel(),), dtype=dtype, device=dev)
    rows = buf[offset:].view(b, -1)
    rows.copy_(heads.reshape(b, -1))
    if layout == "bloom":
        r = rows.view(b, n_q, 3, d)
        return rows, (r[:, :, 0], r[:, :, 1], r[:, :, 2])
    return rows, (rows[:, :n_q * d].view(b, n_q, d),
                  rows[:, n_q * d:(n_q + n_kv) * d].view(b, n_kv, d),
                  rows[:, (n_q + n_kv) * d:].view(b, n_kv, d))


def _same_bits(name, got, ref):
    """Raise unless two tensors (or cache tuples) hold the same bits."""
    import torch

    for g, r in zip(got, ref) if isinstance(got, (tuple, list)) else ((got, ref),):
        if g.dtype != r.dtype or g.shape != r.shape:
            raise AssertionError(f"{name}: {g.dtype} {tuple(g.shape)} != {r.dtype} "
                                 f"{tuple(r.shape)}")
        view = {torch.bfloat16: torch.int16, torch.float32: torch.int32}.get(g.dtype)
        if not torch.equal(g.view(view) if view else g, r.view(view) if view else r):
            raise AssertionError(f"{name}: the bits differ")


def _write_errs(name, got_q, ref_q, got, ref):
    """A writer call against its plain version, after _same_bits has held
    them equal: (the largest |difference| of the k / v codes and of q's
    values, the scales' largest distance in ulps)."""
    err = max(int((g.int() - r.int()).abs().max()) for g, r in zip(got[:2], ref[:2]))
    if got_q is not None:
        err = max(err, float((got_q.float() - ref_q.float()).abs().max()))
    ulps = max(_scale_ulps(name, g, r) for g, r in zip(got[2:], ref[2:]))
    return float(err), ulps


def _old_write_route(write, q, k, v, cos_q, sin_q, cos, sin, bufs, i):
    """The route the row body replaces: q's rotary by apply_rotary (tables
    already in q's dtype, as the layer loop held them), then the first
    design (body="warps", k / v copied contiguous first)."""
    from smoothquant_tpu_torch.kernels.kv_write import apply_rotary

    q_rot = apply_rotary(q[:, None], cos_q, sin_q)[:, 0]
    write(i, *bufs[0], k, v, cos, sin, *bufs[1], body="warps")
    return q_rot


def _writer_timings(smajor, write, args, q, k, v, cos, sin, pos, bufs, n_l):
    """Device ms of the fused launch by block size (threads_ms: the row
    body's launch, kv_write.launch_rows, at 64-1024 threads), k / v alone
    on the row body (kv_only_ms), the first design alone on contiguous k / v
    (old_body_ms, the kernel as the old call launched it after its copies)
    and the route the launch replaces (old_route_ms: apply_rotary's torch
    ops on q, then the first design copying the strided k / v); each call on
    the next of n_l layers."""
    from smoothquant_tpu_torch.kernels.kv_write import launch_rows

    cos_q, sin_q = (None, None) if q is None else (cos.to(q.dtype), sin.to(q.dtype))
    rotary = cos is not None
    kc, vc = k.contiguous(), v.contiguous()
    out = dict(
        threads_ms={t: device_ms(lambda i: launch_rows(smajor, i % n_l, *args, *bufs,
                                                       rotary=rotary, body=None, threads=t), 16)
                    for t in (64, 128, 256, 512, 1024)},
        kv_only_ms=device_ms(lambda i: write(i % n_l, pos, k, v, cos, sin, *bufs,
                                             rotary=rotary), 16),
        old_body_ms=device_ms(lambda i: write(i % n_l, pos, kc, vc, cos, sin, *bufs,
                                              rotary=rotary, body="warps"), 16))
    if q is not None:
        out["old_route_ms"] = device_ms(lambda i: _old_write_route(
            write, q, k, v, cos_q, sin_q, cos, sin, ((pos,), bufs), i % n_l), 16)
    return out


def check_write_cache(cfg, dev, gen):
    """K2 at the S-major step's shape (B = 4, S = 512): one launch of the
    row body (rope_q_write_cache_smajor) on q / k / v as views into bf16
    qkv rows, per-slot positions (one past S − 1), against its plain
    version (apply_rotary on q, then K2's plain write): q's bits, codes and
    scales identical.  Timed beside the plain version, by block size
    (threads_ms), without q (kv_only_ms), the first design alone
    (old_body_ms) and the route the launch replaces (old_route_ms: the
    rotary's torch ops on q, then the first design copying k / v)
    (_writer_timings)."""
    import torch

    from smoothquant_tpu_torch.kernels import attn_smajor as ka
    from smoothquant_tpu_torch.models.common import rotary_cos_sin
    from smoothquant_tpu_torch.utils import roofline

    nh, h, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    pos = torch.tensor([100, MAX_LEN - 1, MAX_LEN + 88, 0], device=dev, dtype=torch.int32)
    _, (q, k, v) = _qkv_parts(MAX_BATCH, nh, h, d, torch.bfloat16, gen, dev)
    cos, sin = rotary_cos_sin(pos.long()[:, None], d)
    a = _random_cache(cfg, dev, gen)
    b = type(a)(a.k_q.clone(), a.v_q.clone(), a.k_scale.clone(), a.v_scale.clone(), a.pos)
    bufs = lambda c: (c.k_q, c.v_q, c.k_scale, c.v_scale)
    last = cfg.num_hidden_layers - 1
    got_q = ka.rope_q_write_cache_smajor(last, pos, q, k, v, cos, sin, *bufs(a))
    ref_q = ka.rope_q_write_cache_smajor_plain(last, pos, q, k, v, cos, sin, *bufs(b))
    torch.cuda.synchronize()
    _same_bits("K2 q", got_q, ref_q)
    _same_bits("K2 cache", bufs(a), bufs(b))
    err, ulps = _write_errs("K2", got_q, ref_q, bufs(a), bufs(b))
    n_layers = cfg.num_hidden_layers
    n_bytes, ops = roofline.write_cache_cost(MAX_BATCH, h, d, q_heads=nh)
    b_ms, b_by = roofline.bound_ms(n_bytes, ops)
    args = (pos, q, k, v, cos, sin)
    row = dict(
        kernel="write_quant_cache_smajor", shape=[MAX_BATCH, nh, h, d, MAX_LEN], max_err=err,
        scale_ulps=ulps,
        kernel_ms=device_ms(lambda i: ka.rope_q_write_cache_smajor(
            i % n_layers, *args, *bufs(a)), n_layers),
        plain_ms=device_ms(lambda i: ka.rope_q_write_cache_smajor_plain(
            i % n_layers, *args, *bufs(b)), 8, reps=3),
        **_writer_timings(True, ka.write_quant_cache_smajor, args,
                          q, k, v, cos, sin, pos, bufs(a), n_layers),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, library=None)
    emit(row)
    return [row]


def check_decode_attention(cfg, dev, gen):
    """K3 vs plain over random S-major caches: B = 4 with ragged valid
    lengths (the main row, in the kernels line's sums), B = SLOT_BATCH from
    DECODE_POS (every slot a new row) and B = 4 over 2·MAX_LEN positions
    (two 512-wide softmax tiles), within 1e-2 of the largest output; the
    flash body timed beside the split body the rule picks (kernel_ms /
    flash_ms); SDPA over the dequantized bf16 cache as the yardstick."""
    import torch
    import torch.nn.functional as F

    from smoothquant_tpu_torch.kernels import attn_smajor as ka
    from smoothquant_tpu_torch.kernels import decode_attention as k11
    from smoothquant_tpu_torch.models.common import decode_bias
    from smoothquant_tpu_torch.utils import roofline

    h, n_kv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    rows = []
    for site, b, s, pos, main in (
            ("ragged", MAX_BATCH, MAX_LEN, [100, 300, MAX_LEN - 1, 50], True),
            (f"new_row@B{SLOT_BATCH}", SLOT_BATCH, MAX_LEN, [DECODE_POS] * SLOT_BATCH, False),
            (f"ragged@S{2 * MAX_LEN}", MAX_BATCH, 2 * MAX_LEN,
             [100, MAX_LEN + 188, 2 * MAX_LEN - 1, 50], False)):
        n_layers = cfg.num_hidden_layers if main else min(4, cfg.num_hidden_layers)
        c = _random_cache(cfg, dev, gen, b, s, n_layers)
        bias = decode_bias(torch.tensor(pos, device=dev), b, s, None)
        q = torch.randn((b, h, d), generator=gen, device=dev).to(torch.bfloat16)
        args = lambda i, c=c, q=q, bias=bias: (i, q, c.k_q, c.v_q, bias, c.k_scale, c.v_scale)
        design, ranks = k11.plan("K3", q.dtype, b * n_kv, s, d, h // n_kv)
        got = _launched(ka.LAUNCH_KEYS[design],
                        lambda: ka.decode_attention_smajor_stacked(*args(n_layers - 1)))
        ref = ka.decode_attention_smajor_plain(*args(n_layers - 1))
        flash = ka.decode_attention_smajor_stacked(*args(n_layers - 1), body="flash")
        torch.cuda.synchronize()
        err = _close(f"K3 {site}", got, ref, 1e-2)
        _close(f"K3 flash body {site}", flash, ref, 1e-2)

        def deq(qv, sc, b=b, s=s):
            x = qv.reshape(b, s, n_kv, d).transpose(1, 2).float()
            return (x * sc[..., None]).to(torch.bfloat16).repeat_interleave(h // n_kv, dim=1)

        n_lib = min(4, n_layers)
        kd = [deq(c.k_q[i], c.k_scale[i]) for i in range(n_lib)]
        vd = [deq(c.v_q[i], c.v_scale[i]) for i in range(n_lib)]
        valid = (bias == 0)[:, None, None, :]
        n_bytes, ops = roofline.decode_attn_cost(b, h, n_kv, s, d, n_valid=int(valid.sum()))
        b_ms, b_by = roofline.bound_ms(n_bytes, ops)
        rows.append(dict(
            kernel="decode_attention_smajor_stacked", site=site, in_sum=main,
            shape=[b, h, n_kv, s, d], max_err=err, check_launches=1,
            max_rel_err=err / ref.float().abs().max().item(), split=ranks,
            kernel_ms=device_ms(lambda i: ka.decode_attention_smajor_stacked(
                *args(i % n_layers)), n_layers),
            flash_ms=device_ms(lambda i: ka.decode_attention_smajor_stacked(
                *args(i % n_layers), body="flash"), n_layers),
            plain_ms=device_ms(lambda i: ka.decode_attention_smajor_plain(
                *args(i % n_layers)), 4, reps=3),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=device_ms(lambda i: F.scaled_dot_product_attention(
                q[:, :, None], kd[i % n_lib], vd[i % n_lib], attn_mask=valid), 16),
            library="scaled_dot_product_attention over the dequantized bf16 cache, "
                    "yardstick only"))
        emit(rows[-1])
        del c, kd, vd
    return rows


def _prefill_sites(tree, cfg):
    """(site, per-layer packs) of the four prefill linears of a per-layer tree."""
    layers = [tree["layers"][str(i)] for i in range(cfg.num_hidden_layers)]
    return [(site, [lp[grp][name] for lp in layers]) for site, grp, name in (
        ("qkv", "self_attn", "qkv_proj"), ("o", "self_attn", "o_proj"),
        ("gate_up", "mlp", "gate_up_proj"), ("down", "mlp", "down_proj"))]


def check_int8_prefill(promoted, cfg, dev, gen):
    """K4 vs plain at the promoted tree's four prefill linears and its
    lm_head, N = 1024 rows of the identity prologue (the wgmma body, and
    PR 2's mma.sync tiles beside it as old_body_ms); the yardstick is
    torch._int_mm plus the f32 epilogue (and a bf16 matmul for the salient
    part)."""
    import torch

    from smoothquant_tpu_torch.kernels import int8_prefill as k4
    from smoothquant_tpu_torch.kernels.real_linear import identity_int8_quantize
    from smoothquant_tpu_torch.utils import roofline

    rows = []
    for site, lins in _prefill_sites(promoted, cfg) + [("lm_head", [promoted["lm_head"]])]:
        m = lins[0].meta
        x = torch.randn((PREFILL_N, m.in_features), generator=gen,
                        device=dev).to(torch.bfloat16)
        x_q, sx, x_sal, _ = identity_int8_quantize(lins[0], x)
        n_l = len(lins)
        args = lambda i: (x_q, sx, lins[i % n_l].w_qt,
                          lins[i % n_l].w_scales_t.float().reshape(1, -1), x_sal,
                          lins[i % n_l].w_sal_t[:x_sal.shape[1]])
        got = k4.int8_prefill_matmul(*args(0))
        ref = k4.int8_prefill_matmul_plain(*args(0))
        torch.cuda.synchronize()
        err = _close(f"K4 {site}", got, ref, 1e-2)

        def library(i):
            a = args(i)
            y = k4.int_mm(a[0], a[2]).float() * a[1] * a[3]
            if a[4].shape[1]:
                y = y + torch.matmul(a[4], a[5]).float()
            return y.to(torch.bfloat16)

        o, k_s = lins[0].w_qt.shape[1], x_sal.shape[1]
        n_bytes, ops = roofline.int8_prefill_cost(PREFILL_N, m.in_features, o, k_s)
        b_ms, b_by = roofline.bound_ms(n_bytes, ops)
        old = k4.int8_prefill_matmul(*args(0), body="tiles")
        torch.cuda.synchronize()
        _close(f"K4 {site} (tiles body)", old, ref, 1e-2)
        rows.append(dict(
            kernel="int8_prefill_matmul", site=site, shape=[PREFILL_N, m.in_features, o, k_s],
            body=k4.prefill_body(False, k_s, x_sal.dtype), max_err=err,
            kernel_ms=device_ms(lambda i: k4.int8_prefill_matmul(*args(i)), 8),
            old_body_ms=device_ms(lambda i: k4.int8_prefill_matmul(*args(i), body="tiles"), 8),
            plain_ms=device_ms(lambda i: k4.int8_prefill_matmul_plain(*args(i)), 2, reps=3),
            bound_ms=b_ms, bound_by=b_by, library_ms=device_ms(library, 8),
            library="torch._int_mm + f32 epilogue (+ bf16 salient matmul), yardstick only"))
        emit(rows[-1])
    return rows


def check_fp_matmul(bf16, dev, gen):
    """K13 vs plain at the bf16 tree's four decode linears (N = 4), on the
    body its rule picks (the stream body) with the __ldg body timed beside
    it (old_body_ms), each call on the next layer's slab."""
    import torch

    from smoothquant_tpu_torch.kernels import fp_matmul as k13
    from smoothquant_tpu_torch.utils import roofline

    st = bf16["layers"]["stacked"]
    rows = []
    for site, w in (("qkv", st["self_attn"]["qkv_proj"]["weight_t"]),
                    ("o", st["self_attn"]["o_proj"]["weight_t"]),
                    ("gate_up", st["mlp"]["gate_up_proj"]["weight_t"]),
                    ("down", st["mlp"]["down_proj"]["weight_t"])):
        n_layers, kk, o = w.shape
        x = torch.randn((MAX_BATCH, kk), generator=gen, device=dev).to(w.dtype)
        got = k13.fp_matmul_stacked(n_layers - 1, x, w)
        ref = k13.fp_matmul_stacked_plain(n_layers - 1, x, w)
        torch.cuda.synchronize()
        err = _close(f"K13 {site}", got, ref, 1e-2)
        n_bytes, ops = roofline.fp_matmul_cost(MAX_BATCH, kk, o)
        b_ms, b_by = roofline.bound_ms(n_bytes, ops)
        rows.append(dict(
            kernel="fp_matmul_stacked", site=site, shape=[MAX_BATCH, kk, o], max_err=err,
            body=k13.fp_body(MAX_BATCH, kk, o, x.dtype),
            kernel_ms=device_ms(lambda i: k13.fp_matmul_stacked(i % n_layers, x, w), n_layers),
            old_body_ms=device_ms(lambda i: k13.fp_matmul_stacked(i % n_layers, x, w, body="ldg"),
                                  n_layers),
            plain_ms=device_ms(lambda i: k13.fp_matmul_stacked_plain(i % n_layers, x, w), 4,
                               reps=3),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=device_ms(lambda i: torch.matmul(x, w[i % n_layers]), n_layers),
            library="torch.matmul bf16 (N, K) @ (K, O), yardstick only"))
        emit(rows[-1])
    return rows


def check_decode_attention_hm(cfg, dev, gen, b=MAX_BATCH, pos=None, bodies=("bf16", "int8"),
                               main=True, sm_scale=None, site=None):
    """K11 vs plain over random stacked head-major caches, bf16 and int8,
    with ragged valid lengths (as K3's phase); the flash body timed beside
    the split body the rule picks (kernel_ms / flash_ms); SDPA over the
    (dequantized) bf16 cache, its kv heads expanded to the query heads, as
    the yardstick.  With main=False (Llama's per-slot int8 pool at B = 64,
    positions as the pool leaves them; Falcon-7B's rep 71, OPT's sm_scale
    1.0, sites `site_body@B`) the rows stay out of the kernels line's sums.
    sm_scale: K11's score scale (default 1/√D)."""
    import torch
    import torch.nn.functional as F

    from smoothquant_tpu_torch.kernels import decode_attention as k11
    from smoothquant_tpu_torch.models.common import KVCache, QuantKVCache, decode_bias
    from smoothquant_tpu_torch.utils import roofline

    h, n_kv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    n_layers = cfg.num_hidden_layers if main else min(4, cfg.num_hidden_layers)
    pos = torch.tensor([100, 300, MAX_LEN - 1, 50], device=dev) if pos is None else pos
    rep = h // n_kv
    scale = {} if sm_scale is None else {"sm_scale": sm_scale}
    bias = decode_bias(pos, b, MAX_LEN, None)
    valid = (bias == 0)[:, None, None, :]
    q = torch.randn((b, h, d), generator=gen, device=dev).to(torch.bfloat16)
    rows = []
    for body in bodies:
        if body == "bf16":
            c = KVCache.create(b, MAX_LEN, n_kv, d, torch.bfloat16, dev,
                               n_layers=n_layers)
            for t in (c.k, c.v):
                t.copy_(torch.randn(t.shape, generator=gen, device=dev))
            bufs = (c.k, c.v)
            lib_kv = lambda i: (c.k[i], c.v[i])
        else:
            c = QuantKVCache.create(b, MAX_LEN, n_kv, d, device=dev,
                                    n_layers=n_layers)
            for t in (c.k_q, c.v_q):
                t.copy_(torch.randint(-127, 128, t.shape, generator=gen, device=dev,
                                      dtype=torch.int8))
            for t in (c.k_scale, c.v_scale):
                t.copy_(torch.rand(t.shape, generator=gen, device=dev) * 0.02 + 0.005)
            bufs = (c.k_q, c.v_q, c.k_scale, c.v_scale)
            deq = lambda qv, sc: (qv.float() * sc[..., None]).to(torch.bfloat16)
            n_lib = min(4, n_layers)
            kd = [deq(c.k_q[i], c.k_scale[i]) for i in range(n_lib)]
            vd = [deq(c.v_q[i], c.v_scale[i]) for i in range(n_lib)]
            lib_kv = lambda i: (kd[i % n_lib], vd[i % n_lib])
        k_, v_ = bufs[:2]
        scales = bufs[2:]
        args = lambda i: (i, q, k_, v_, bias, *scales)
        got = _launched("decode_attention_stacked",
                        lambda: k11.decode_attention_stacked(*args(n_layers - 1), **scale))
        ref = k11.decode_attention_stacked_plain(*args(n_layers - 1), **scale)
        flash = k11.decode_attention_stacked(*args(n_layers - 1), body="flash", **scale)
        torch.cuda.synchronize()
        err = _close(f"K11 {body} B={b}", got, ref, 1e-2)
        _close(f"K11 flash body {body} B={b}", flash, ref, 1e-2)
        n_bytes, ops = roofline.decode_attn_cost(
            b, h, n_kv, MAX_LEN, d, n_valid=int(valid.sum()),
            value_bytes=2 if body == "bf16" else 1, scale_bytes=0 if body == "bf16" else 4)
        b_ms, b_by = roofline.bound_ms(n_bytes, ops)
        lib_in = ([lib_kv(i) for i in range(n_layers)] if rep == 1 else
                  [tuple(t.repeat_interleave(rep, dim=1) for t in lib_kv(i))
                   for i in range(min(4, n_layers))])
        name = body if main else f"{body}@B{b}"
        rows.append(dict(
            kernel="decode_attention_stacked",
            site=name if site is None else f"{site}_{name}", in_sum=main,
            shape=[b, h, n_kv, MAX_LEN, d], rep=rep, sm_scale=sm_scale, max_err=err,
            check_launches=1, max_rel_err=err / ref.float().abs().max().item(),
            split=k11.plan("K11", q.dtype, b * n_kv, MAX_LEN, d, rep)[1],
            groups=k11.rep_groups(rep),
            kernel_ms=device_ms(lambda i: k11.decode_attention_stacked(
                *args(i % n_layers), **scale), n_layers),
            flash_ms=device_ms(lambda i: k11.decode_attention_stacked(
                *args(i % n_layers), body="flash", **scale), n_layers),
            plain_ms=device_ms(lambda i: k11.decode_attention_stacked_plain(
                *args(i % n_layers), **scale), 4, reps=3),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=device_ms(lambda i: F.scaled_dot_product_attention(
                q[:, :, None], *lib_in[i % len(lib_in)], attn_mask=valid, **(
                    {} if sm_scale is None else {"scale": sm_scale})), 16),
            library="scaled_dot_product_attention over the (dequantized) bf16 cache, kv "
                    "heads expanded to the query heads, yardstick only"))
        emit(rows[-1])
        del c, bufs, lib_in
    return rows


def _scale_ulps(name, got, ref, max_ulps=1):
    """f32 scales: within max_ulps units in the last place (positive
    floats order like their bit patterns); returns the largest distance."""
    import torch

    d = int((got.float().view(torch.int32) - ref.float().view(torch.int32)).abs().max())
    if d > max_ulps:
        raise AssertionError(f"{name}: scales {d} ulps apart")
    return d


def _old_prep(lin, x, li, norm):
    """The stacked path's activation prep before K7's row body, on the
    groups body: at a fused-norm site above RAWX_MAX_N rows torch's RMSNorm
    rounded to x's dtype (models.common.rms_norm), then the slice-and-pad
    of the non-salient columns, K7a and the slice-and-pad of the salient
    tail; at or below RAWX_MAX_N rows one launch of K7b; without a norm the
    pads and K7a.  (x3, xs_t, x_sal (N, k_s))."""
    import torch
    import torch.nn.functional as F

    from smoothquant_tpu_torch.kernels import act_prep as k7
    from smoothquant_tpu_torch.kernels.int4_group_matmul import RAWX_MAX_N
    from smoothquant_tpu_torch.models.common import rms_norm

    m = lin.meta
    n = x.shape[0]
    if norm is not None and n <= RAWX_MAX_N:
        x3, xs_t, x_sal = k7.norm_quantize_acts_t(
            x, norm[0][li], group_size=m.group_size, act_bits=m.act_bits, k_ns=m.k_ns,
            num_salient=m.num_salient, k_s=m.k_s, eps=norm[1], norm_kind="rms",
            sal_dtype=x.dtype, body="groups")
        return x3, xs_t, x_sal[:n]
    if norm is not None:
        x = rms_norm({"weight": norm[0][li]}, x, norm[1])
    k_ns_raw = m.in_features - m.num_salient
    x3, xs_t = k7.quantize_acts_grouped_t(F.pad(x[:, :k_ns_raw], (0, m.k_ns - k_ns_raw)),
                                          group_size=m.group_size, act_bits=m.act_bits,
                                          body="groups")
    return x3, xs_t, F.pad(x[:, k_ns_raw:], (0, m.k_s - m.num_salient))


def _old_route_profile(step, steps=4):
    """profile() of `steps` decode steps with each stacked site's activation
    prep on the route before K7's row body (_old_prep: the groups body, and
    above RAWX_MAX_N rows torch's RMSNorm and the pads around K7a): the
    steps' busy time and kernel count before, beside the path's own."""
    from smoothquant_tpu_torch.kernels import real_linear as rl

    saved = rl.k1_rows_operands, rl.many_rows_operands

    def old(packed, x2d, layer_idx, norm=None):
        if packed.meta.layout == "identity":
            return saved[1](packed, x2d, layer_idx, norm)
        return (*_old_prep(packed, x2d, layer_idx, norm), x2d.shape[0])

    rl.k1_rows_operands = rl.many_rows_operands = old
    try:
        return profile(lambda: step(steps), steps)
    finally:
        rl.k1_rows_operands, rl.many_rows_operands = saved


def _old_write_profile(step, steps=4):
    """profile() of `steps` decode steps with each layer's cache write on
    the route before the row body: q's rotary by apply_rotary in the layer
    loop (its tables cast to q's dtype once a step), then the first design
    (body="warps"), which copies k / v contiguous first.  The steps' busy
    time and kernel count before, beside the path's own."""
    import functools

    from smoothquant_tpu_torch.kernels.kv_write import apply_rotary
    from smoothquant_tpu_torch.models import common, llama

    saved = (llama.stacked_cache_append_fused, common.write_quant_cache_smajor,
             common.write_quant_cache_stacked)
    tabs = {}

    def old_append(cache, i, k, v, cos, sin, rotate_k=True, q=None):
        if q is None:
            return saved[0](cache, i, k, v, cos, sin, rotate_k)
        if tabs.get("src") is not cos:
            tabs.update(src=cos, q=(cos.to(q.dtype), sin.to(q.dtype)))
        q = apply_rotary(q, *tabs["q"])[:, 0]
        saved[0](cache, i, k, v, cos, sin, rotate_k)
        return q

    llama.stacked_cache_append_fused = old_append
    common.write_quant_cache_smajor = functools.partial(saved[1], body="warps")
    common.write_quant_cache_stacked = functools.partial(saved[2], body="warps")
    try:
        return profile(lambda: step(steps), steps)
    finally:
        (llama.stacked_cache_append_fused, common.write_quant_cache_smajor,
         common.write_quant_cache_stacked) = saved


def check_act_prep(stacked, dev, gen, n=None, main=True):
    """The activation prep of each permuted stacked site at N rows, from the
    layer's rows to K5's operands, one launch of K7's row body
    (real_linear.k1_rows_operands up to RAWX_MAX_N rows, many_rows_operands
    above): Llama's qkv and gate_up on K7b with the RMSNorm fused ("rms",
    "rms_round" above RAWX_MAX_N), its down and Bloom's four sites (input
    gathered by the last layer's perm, out of the kernels line's sums) on
    K7a with the salient split; bf16 rows, the norm rows bf16 values held
    in f32.  Against the plain version: codes identical or off by one in
    under 1e-4 of them, scales within one ulp, x_sal within a bf16
    rounding; the route before (_old_prep, the groups body) held to the
    same plain version and timed beside it (old_route_ms), and the groups
    body alone (old_body_ms: K7b at or below RAWX_MAX_N rows, K7a on the
    padded slice).  Each call on the next layer's norm row.  main=False
    marks another row count (sites `site@rows`, out of the sums).  No single
    PyTorch call computes it."""
    import torch
    import torch.nn.functional as F

    from smoothquant_tpu_torch.kernels import act_prep as k7
    from smoothquant_tpu_torch.kernels.int4_group_matmul import RAWX_MAX_N
    from smoothquant_tpu_torch.kernels.real_linear import k1_rows_operands, many_rows_operands
    from smoothquant_tpu_torch.utils import roofline

    n = SLOT_BATCH if n is None else n
    prep = k1_rows_operands if n <= RAWX_MAX_N else many_rows_operands
    rows = []
    for site, lin, mode in _sites(stacked["layers"]["stacked"]):
        if mode == "mask":
            continue
        m = lin.meta
        n_layers, c = lin.w_qt.shape[0], m.in_features
        norm = None
        if mode == "rms":
            norm = ((torch.rand((n_layers, c), generator=gen, device=dev) + 0.5
                     ).to(torch.bfloat16).float(), 1e-5, "rms")
        xs = []
        for i in range(4):
            x = (torch.randn((n, c), generator=gen, device=dev) * (1 + 4 * i)).to(torch.bfloat16)
            xs.append(x.index_select(1, lin.perm[-1]) if mode == "gather" else x)
        kind = None if norm is None else ("rms" if n <= RAWX_MAX_N else "rms_round")
        key = "quantize_acts_grouped_t" if norm is None else "norm_quantize_acts_t"
        got = prep(lin, xs[0], n_layers - 1, norm)
        old = _old_prep(lin, xs[0], n_layers - 1, norm)
        ref = k7.norm_quantize_acts_t_plain(
            xs[0], None if norm is None else norm[0][-1], group_size=m.group_size,
            act_bits=m.act_bits, k_ns=m.k_ns, num_salient=m.num_salient, k_s=m.k_s, eps=1e-5,
            norm_kind=kind, sal_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        name = f"K7 {site}@{n} {kind}"
        err, n_diff = _codes_close(name, got[0], ref[0])
        ulps = _scale_ulps(name, got[1], ref[1])
        sal_d = (got[2].float() - ref[2][:n].float()).abs()
        if got[3] != n or not bool((sal_d <= ref[2][:n].float().abs() * 2.0 ** -8).all()):
            raise AssertionError(f"{name}: x_sal off by {sal_d.max().item()}")
        _, n_diff_old = _codes_close(f"{name} old route", old[0], ref[0])
        _scale_ulps(f"{name} old route", old[1], ref[1])
        k_s = m.k_s
        n_bytes, ops = roofline.norm_quant_acts_cost(n, c, m.k_ns, m.group_size, k_s,
                                                     norm_row=norm is not None)
        b_ms, b_by = roofline.bound_ms(n_bytes, ops)
        li = lambda i: i % n_layers
        row = dict(
            kernel=key, site=site if main else f"{site}@{n}",
            norm_kind=kind, shape=[n, c, m.k_ns, k_s], max_err=err, n_diff=n_diff,
            n_diff_old_route=n_diff_old, scale_ulps=ulps,
            in_sum=main and mode != "gather",
            kernel_ms=device_ms(lambda i: prep(lin, xs[i % 4], li(i), norm), 16),
            old_route_ms=device_ms(lambda i: _old_prep(lin, xs[i % 4], li(i), norm), 16),
            plain_ms=device_ms(lambda i: k7.norm_quantize_acts_t_plain(
                xs[i % 4], None if norm is None else norm[0][li(i)], group_size=m.group_size,
                act_bits=m.act_bits, k_ns=m.k_ns, num_salient=m.num_salient, k_s=k_s,
                eps=1e-5, norm_kind=kind, sal_dtype=torch.bfloat16), 4, reps=3),
            bound_ms=b_ms, bound_by=b_by, library_ms=None, library=None)
        if norm is not None and n <= RAWX_MAX_N:
            row["old_body_ms"] = row["old_route_ms"]   # the route was one launch of K7b
        elif norm is None:
            k_ns_raw = c - m.num_salient
            x_ns = [F.pad(x[:, :k_ns_raw], (0, m.k_ns - k_ns_raw)) for x in xs]
            qa = dict(group_size=m.group_size, act_bits=m.act_bits)
            row["k7a_entry_ms"] = device_ms(
                lambda i: k7.quantize_acts_grouped_t(x_ns[i % 4], **qa), 16)
            row["old_body_ms"] = device_ms(
                lambda i: k7.quantize_acts_grouped_t(x_ns[i % 4], **qa, body="groups"), 16)
        rows.append(row)
        emit(row)
    return rows


def check_k7_k5_chain(stacked, dev, gen, rows=(MID_BATCH, SLOT_BATCH)):
    """The prep + K5 pair at Llama-2-7B's qkv (K7b's row body, then K5's
    stream kind as its programmatic dependent, as real_linear._stacked_linear
    launches them) against K5 alone on the same operands, N rows, each call
    on the next layer's weights (cold): pair_ms − k5_ms is what the prep
    adds to the linear.  Off every kernel row's sums."""
    import torch

    from smoothquant_tpu_torch.kernels.int4_group_matmul import (
        RAWX_MAX_N,
        int4_group_matmul_stacked,
    )
    from smoothquant_tpu_torch.kernels.real_linear import k1_rows_operands, many_rows_operands

    site, lin, _ = _sites(stacked["layers"]["stacked"])[0]
    m = lin.meta
    n_layers, c = lin.w_qt.shape[0], m.in_features
    norm = ((torch.rand((n_layers, c), generator=gen, device=dev) + 0.5
             ).to(torch.bfloat16).float(), 1e-5, "rms")
    out = {}
    for n in rows:
        prep = k1_rows_operands if n <= RAWX_MAX_N else many_rows_operands
        x = torch.randn((n, c), generator=gen, device=dev).to(torch.bfloat16)
        ops = prep(lin, x, 0, norm)
        kw = dict(group_size=m.group_size, out_dtype=torch.bfloat16)

        def k5(i, ops):
            return int4_group_matmul_stacked(i % n_layers, *ops[:2], lin.w_qt, lin.w_scales_t,
                                             ops[2], lin.w_sal_t, pre_laid=ops[3], **kw)

        pair_ms = device_ms(lambda i: k5(i, prep(lin, x, i % n_layers, norm)), n_layers)
        k5_ms = device_ms(lambda i: k5(i, ops), n_layers)
        prep_ms = device_ms(lambda i: prep(lin, x, i % n_layers, norm), n_layers)
        out[n] = dict(site=site, pair_ms=pair_ms, k5_ms=k5_ms, prep_ms=prep_ms,
                      exposed_prep_us=1e3 * (pair_ms - k5_ms))
    return out


def check_gmm_stacked(stacked, dev, gen, n=None, main=True):
    """K5 vs plain at the four decode linears, N rows, each in the input
    mode the path gives it (K7a's layout; row-major codes at Llama's o_proj;
    Bloom's input gathered by the last layer's perm first, its rows out of
    the kernels line's sums) and Llama's qkv once more with row-major
    codes: the f32 instantiation within
    1e-5 of the largest magnitude, the path's bf16 one within 1e-2 (one
    bf16 rounding of sums taken in another order).  Yardstick: a bf16
    torch.matmul at the same shape.  main=False marks a call at another row
    count (sites named `site@rows`, out of the sums, no yardsticks)."""
    import torch

    from smoothquant_tpu_torch.kernels import int4_group_matmul as k5
    from smoothquant_tpu_torch.kernels.int4_group_matmul import _row_major
    from smoothquant_tpu_torch.kernels.real_linear import many_rows_operands
    from smoothquant_tpu_torch.utils import roofline

    n = SLOT_BATCH if n is None else n
    rows = []
    sites = _sites(stacked["layers"]["stacked"])
    bloom = sites[0][2] == "gather"
    cases = [(site, lin, False) for site, lin, _ in sites]
    if not bloom:
        cases.append(("qkv", cases[0][1], True))
    for site, lin, to_rows in cases:
        m = lin.meta
        n_layers, half, o = lin.w_qt.shape
        c, k_s, last = m.in_features, lin.w_sal_t.shape[1], n_layers - 1
        x = torch.randn((n, c), generator=gen, device=dev).to(torch.bfloat16)
        x_in = x.index_select(1, lin.perm[last]) if bloom else x
        x_q, x_s, x_sal, pre = many_rows_operands(lin, x_in, last)
        if to_rows:
            x_q, x_s = (t.contiguous() for t in _row_major(x_q, x_s, pre))
            pre = None
        kw = dict(group_size=m.group_size, pre_laid=pre)
        one = lambda t: t[last:last + 1]
        # K5 reads its weights before it waits for the kernel launched just
        # before it (its programmatic dependence): cast them first
        w_sal32 = one(lin.w_sal_t).float()
        f32 = (x_q, x_s, one(lin.w_qt), one(lin.w_scales_t), x_sal.float(), w_sal32)
        got = k5.int4_group_matmul_stacked(0, *f32, out_dtype=torch.float32, **kw)
        ref = k5.int4_group_matmul_stacked_plain(0, *f32, out_dtype=torch.float32, **kw)
        torch.cuda.synchronize()
        err = _close(f"K5 {site} f32", got, ref, 1e-5)
        args = lambda i: (i % n_layers, x_q, x_s, lin.w_qt, lin.w_scales_t, x_sal, lin.w_sal_t)
        kwb = dict(kw, out_dtype=torch.bfloat16)
        got = k5.int4_group_matmul_stacked(*args(last), **kwb)
        ref = k5.int4_group_matmul_stacked_plain(*args(last), **kwb)
        torch.cuda.synchronize()
        err_bf16 = _close(f"K5 {site} bf16", got, ref, 1e-2)
        w_lib = [torch.randn((c, o), generator=gen, device=dev).to(torch.bfloat16)
                 for _ in range(4)]
        n_bytes, ops = roofline.gmm_cost(n, o, 2 * half, m.group_size, k_s)
        b_ms, b_by = roofline.bound_ms(n_bytes, ops)
        name = (f"{site}@rows" if to_rows else site) + ("" if main else f"@{n}")
        body = k5.stacked_body(n, o, m.group_size)
        timed = lambda b: device_ms(
            lambda i: k5.int4_group_matmul_stacked(*args(i), **kwb, body=b), n_layers)
        rows.append(dict(
            kernel="int4_group_matmul_stacked", site=name, body=body,
            mode="rows" if pre is None else "pre_laid", shape=[n, c, o],
            scalings=[n, o, 2 * half, m.group_size],
            max_err=err,
            max_err_bf16=err_bf16, in_sum=main and not (to_rows or bloom),
            kernel_ms=timed(body),
            **({"tiles_ms": timed("tiles")} if body == "stream" else {}),
            bound_ms=b_ms, bound_by=b_by))
        if main:
            rows[-1].update(
                plain_ms=device_ms(
                    lambda i: k5.int4_group_matmul_stacked_plain(*args(i), **kwb), 2, reps=3),
                library_ms=device_ms(lambda i: x @ w_lib[i % 4], 16),
                library="torch.matmul bf16 (N, C) @ (C, O), yardstick only")
        del w_lib
        emit(rows[-1])
    return rows


def k1_vs_k5(stacked, dev, gen, rows=(1, 4, 8, 16, MID_BATCH)):
    """The stacked decode linears' two routes at K1's row counts: K1
    (RMSNorm, mask and quantize fused in; on the body its rule picks, the
    dp4a body timed beside) against the activations made as K1 makes them
    (real_linear.k1_rows_operands: K7b for the fused-norm sites, K7a or the
    identity layout's quantize for the others) then K5 on its stream body,
    at Llama-2-7B's four sites, activation prep included, each call on the
    next layer's weights.  Device ms per site and summed, K1's body per
    site, and the row counts at which the K5 route wins on the sum."""
    import torch

    from smoothquant_tpu_torch.kernels.int4_group_matmul import (
        int4_group_matmul_stacked,
        int4_group_matmul_stacked_rawx,
        rawx_body,
    )
    from smoothquant_tpu_torch.kernels.real_linear import _salient_gather, k1_rows_operands

    sites = _sites(stacked["layers"]["stacked"])
    out = {}
    for n in rows:
        ms, bodies = {}, {}
        for site, lin, mode in sites:
            m = lin.meta
            n_layers = lin.w_qt.shape[0]
            x = torch.randn((n, m.in_features), generator=gen, device=dev).to(torch.bfloat16)
            norm = None
            if mode == "rms":
                norm = ((torch.rand((n_layers, m.in_features), generator=gen, device=dev) + 0.5
                         ).to(torch.bfloat16).float(), 1e-5, "rms")
            w_sal = lin.w_sal_t.to(torch.bfloat16)
            kw1 = dict(group_size=m.group_size, act_bits=m.act_bits, num_salient=m.num_salient,
                       out_dtype=torch.bfloat16)

            def k1_route(i, body=None):
                li = i % n_layers
                if mode == "mask":
                    return int4_group_matmul_stacked_rawx(
                        li, x, lin.ns_mask, lin.w_qt, lin.w_scales_t, w_sal,
                        _salient_gather(lin, x, lin.perm[li]), norm_kind="mask", body=body,
                        **kw1)
                return int4_group_matmul_stacked_rawx(
                    li, x, norm[0] if norm else None, lin.w_qt, lin.w_scales_t, w_sal,
                    eps=1e-5, norm_kind="rms" if norm else None, body=body, **kw1)

            def k5_route(i):
                x_q, x_s, x_sal, pre = k1_rows_operands(lin, x, i % n_layers, norm)
                return int4_group_matmul_stacked(
                    i % n_layers, x_q, x_s, lin.w_qt, lin.w_scales_t, x_sal, w_sal,
                    group_size=m.group_size, out_dtype=torch.bfloat16, pre_laid=pre)

            ms[site] = {"k1": device_ms(k1_route, n_layers, reps=3),
                        "k1_dp4a": device_ms(lambda i: k1_route(i, "dp4a"), n_layers, reps=3),
                        "k5": device_ms(k5_route, n_layers, reps=3)}
            bodies[site] = rawx_body(n, m.in_features, lin.w_qt.shape[2], 2 * lin.w_qt.shape[1],
                                     m.group_size, lin.w_sal_t.shape[1], torch.bfloat16)
        out[n] = {"ms": ms, "k1_body": bodies,
                  "sum": {r: sum(v[r] for v in ms.values()) for r in ("k1", "k1_dp4a", "k5")}}
    return {"rows": list(rows), "by_rows": out,
            "k5_wins_at": [n for n in rows if out[n]["sum"]["k5"] < out[n]["sum"]["k1"]]}


def check_write_cache_hm(dev, gen, b, h, d, rotary=True, site=None, n_q=None):
    """K10 at B slots of H kv heads of D, S = MAX_LEN: one launch of the row
    body (rope_q_write_cache_stacked) on views into bf16 qkv rows — Llama's
    with n_q query heads rotated in the same launch, or with rotary off
    Bloom's interleaved (nh, 3, D) rows, no q and no tables — against its
    plain version: per-slot positions (one past the end, the last row, the
    first), then one aligned position with one shared table row; q's bits,
    codes and scales identical, the other layer untouched.  Timed as
    check_write_cache times K2.  A named site stays out of the kernels
    line's sums."""
    import functools

    import torch

    from smoothquant_tpu_torch.kernels import cache_write as k10
    from smoothquant_tpu_torch.models.common import QuantKVCache, rotary_cos_sin
    from smoothquant_tpu_torch.utils import roofline

    n_l = 2
    n_q = (n_q or h) if rotary else 0
    tables = lambda p: (rotary_cos_sin(p.long().reshape(-1, 1)[:b], d) if rotary
                        else (None, None))
    c = QuantKVCache.create(b, MAX_LEN, h, d, device=dev, per_slot=True, n_layers=n_l)
    for t in (c.k_q, c.v_q):
        t.copy_(torch.randint(-127, 128, t.shape, generator=gen, device=dev, dtype=torch.int8))
    for t in (c.k_scale, c.v_scale):
        t.copy_(torch.rand(t.shape, generator=gen, device=dev) * 0.02 + 0.005)
    pos = torch.randint(0, MAX_LEN, (b,), generator=gen, device=dev, dtype=torch.int32)
    pos[:3] = torch.tensor([MAX_LEN + 88, MAX_LEN - 1, 0], device=dev)[:b]
    _, (q, k, v) = _qkv_parts(b, n_q if rotary else h, h, d, torch.bfloat16, gen, dev,
                              layout="llama" if rotary else "bloom")
    q = q if rotary else None
    bufs = lambda x: (x.k_q, x.v_q, x.k_scale, x.v_scale)
    err, ulps = 0.0, 0
    for p in (pos, torch.tensor(200, device=dev, dtype=torch.int32)):
        cos, sin = tables(p)
        a = QuantKVCache(*(t.clone() for t in bufs(c)), c.pos)
        ref = QuantKVCache(*(t.clone() for t in bufs(c)), c.pos)
        got_q = k10.rope_q_write_cache_stacked(n_l - 1, p, q, k, v, cos, sin, *bufs(a),
                                               rotary=rotary)
        ref_q = k10.rope_q_write_cache_stacked_plain(n_l - 1, p, q, k, v, cos, sin,
                                                     *bufs(ref), rotary=rotary)
        torch.cuda.synchronize()
        if rotary:
            _same_bits("K10 q", got_q, ref_q)
        _same_bits("K10 cache", bufs(a), bufs(ref))
        e, u = _write_errs("K10", got_q if rotary else None, ref_q, bufs(a), bufs(ref))
        err, ulps = max(err, e), max(ulps, u)
        if not torch.equal(a.k_q[0], c.k_q[0]):
            raise AssertionError("K10 wrote outside its layer")
        del a, ref
    cos, sin = tables(pos)
    n_bytes, ops = roofline.write_cache_cost(b, h, d, rotary=rotary, q_heads=n_q)
    b_ms, b_by = roofline.bound_ms(n_bytes, ops)
    args = (pos, q, k, v, cos, sin)
    fused = functools.partial(k10.rope_q_write_cache_stacked, rotary=rotary)
    row = dict(
        kernel="write_quant_cache_stacked", shape=[b, n_q, h, d, MAX_LEN], max_err=err,
        scale_ulps=ulps, rotary=rotary,
        kernel_ms=device_ms(lambda i: fused(i % n_l, *args, *bufs(c)), 16),
        plain_ms=device_ms(lambda i: k10.rope_q_write_cache_stacked_plain(
            i % n_l, *args, *bufs(c), rotary=rotary), 8, reps=3),
        **_writer_timings(False, k10.write_quant_cache_stacked, args, q, k, v, cos, sin,
                          pos, bufs(c), n_l),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, library=None)
    if site is not None:
        row.update(site=site, in_sum=False)
    emit(row)
    return [row]


def _random_hm_cache(b, n_kv, d, n_l, dev, gen):
    """A stacked head-major int8 cache of random codes and scales, (L,)
    aligned positions."""
    import torch

    from smoothquant_tpu_torch.models.common import QuantKVCache

    c = QuantKVCache.create(b, MAX_LEN, n_kv, d, device=dev, n_layers=n_l, pos=DECODE_POS)
    for t in (c.k_q, c.v_q):
        t.copy_(torch.randint(-127, 128, t.shape, generator=gen, device=dev, dtype=torch.int8))
    for t in (c.k_scale, c.v_scale):
        t.copy_(torch.rand(t.shape, generator=gen, device=dev) * 0.02 + 0.005)
    return c


def check_fused_attn(cfg, dev, gen):
    """K12 vs plain over random stacked head-major int8 caches of MAX_LEN
    positions at aligned position DECODE_POS: the flat body (MHA, the
    model's heads) at B = MAX_BATCH and B = SLOT_BATCH, the write body at
    B = MAX_BATCH (its rows and scales identical to K10's from the same
    k / v, and to the plain version's), the stacked body at B = MAX_BATCH
    over a quarter of the heads as kv heads (GQA_SHARE).  bf16 attention
    within 1e-2 of the largest magnitude (p is rounded to bf16 before PV on
    both sides; sums in another order); the flash design timed beside the
    split body the rule picks (kernel_ms / flash_ms).  Yardstick: SDPA over
    the dequantized bf16 cache, the same positions valid."""
    import torch
    import torch.nn.functional as F

    from smoothquant_tpu_torch.kernels import attn_fused as k12
    from smoothquant_tpu_torch.kernels import cache_write as k10
    from smoothquant_tpu_torch.kernels import decode_attention as k11
    from smoothquant_tpu_torch.models.common import rotary_cos_sin
    from smoothquant_tpu_torch.utils import roofline

    h, d = cfg.num_attention_heads, cfg.head_dim
    pos = torch.tensor(DECODE_POS, dtype=torch.int32, device=dev)
    cos, sin = rotary_cos_sin(pos.long().reshape(1, 1), d)
    bufs = lambda c: (c.k_q, c.v_q, c.k_scale, c.v_scale)
    clone = lambda c: type(c)(*(t.clone() for t in bufs(c)), c.pos)
    rows = []
    for body, b, n_kv in (("flat", MAX_BATCH, h), ("flat", SLOT_BATCH, h),
                          ("write", MAX_BATCH, h), ("gqa", MAX_BATCH, max(1, h // GQA_SHARE))):
        n_l = cfg.num_hidden_layers if b == MAX_BATCH else 2
        c = _random_hm_cache(b, n_kv, d, n_l, dev, gen)
        q = torch.randn((b, h, d), generator=gen, device=dev).to(torch.bfloat16)
        k = torch.randn((b, n_kv, d), generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn((b, n_kv, d), generator=gen, device=dev).to(torch.bfloat16)
        flat, write = body == "flat", body == "write"
        if flat:
            q = q.reshape(b, 1, h * d)
            fn = k12.fused_virtual_attn_flat
        else:
            fn = k12.fused_rope_write_attn_stacked if write else k12.fused_virtual_attn_stacked
        args = lambda i, c=c: (i, pos, q, k, v, cos, sin, *bufs(c))
        last = n_l - 1
        ref_c = clone(c) if write else c
        got_c = clone(c) if write else c
        design, ranks = k11.plan("K12", q.dtype, b * n_kv, MAX_LEN, d, h // n_kv)
        got = _launched(k12.LAUNCH_KEYS[design], lambda: fn(*args(last, got_c)))
        ref = k12.fused_attn_plain(*args(last, ref_c), flat=flat, write_cache=write)
        flash_c = clone(c) if write else c
        flash = fn(*args(last, flash_c), body="flash")
        row = dict(kernel="fused_attn", site=body if b == MAX_BATCH else f"{body}@{b}",
                   shape=[b, h, n_kv, MAX_LEN, d], pos=DECODE_POS, in_sum=flat and b == MAX_BATCH,
                   check_launches=1, split=ranks)
        if write:
            k10_c = clone(c)
            k10.write_quant_cache_stacked(last, pos, k, v, cos, sin, *bufs(k10_c))
            torch.cuda.synchronize()
            for name, x, y, z, f in zip(("k_q", "v_q", "k_scale", "v_scale"), bufs(got_c),
                                        bufs(k10_c), bufs(ref_c), bufs(flash_c)):
                if not (torch.equal(x, y) and torch.equal(x, z) and torch.equal(x, f)):
                    raise AssertionError(f"K12 write body: {name} differs from K10's, the "
                                         "plain version's or the flash design's")
            row["cache_identical_to_k10"] = True
            del k10_c, ref_c, flash_c
        torch.cuda.synchronize()
        row["max_err"] = _close(f"K12 {body} B={b}", got, ref, 1e-2)
        _close(f"K12 flash design {body} B={b}", flash, ref, 1e-2)
        n_lib = min(4, n_l)
        valid = (torch.arange(MAX_LEN, device=dev) <= DECODE_POS)[None, None, None, :]

        def deq(qv, sc):
            x = (qv.float() * sc[..., None]).to(torch.bfloat16)
            return x.repeat_interleave(h // n_kv, dim=1)

        kd = [deq(c.k_q[i], c.k_scale[i]) for i in range(n_lib)]
        vd = [deq(c.v_q[i], c.v_scale[i]) for i in range(n_lib)]
        q4 = q.reshape(b, h, 1, d)
        n_bytes, ops = roofline.fused_attn_cost(b, h, n_kv, MAX_LEN, d, DECODE_POS, write=write)
        b_ms, b_by = roofline.bound_ms(n_bytes, ops)
        row.update(
            kernel_ms=device_ms(lambda i: fn(*args(i % n_l, got_c)), n_l),
            flash_ms=device_ms(lambda i: fn(*args(i % n_l, got_c), body="flash"), n_l),
            plain_ms=device_ms(lambda i: k12.fused_attn_plain(
                *args(i % n_l, got_c), flat=flat, write_cache=write), 4, reps=3),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=device_ms(lambda i: F.scaled_dot_product_attention(
                q4, kd[i % n_lib], vd[i % n_lib], attn_mask=valid), 16),
            library="scaled_dot_product_attention over the dequantized bf16 cache, "
                    "yardstick only")
        rows.append(row)
        emit(row)
        del c, got_c, kd, vd
    return rows


def check_mlp_fused(stacked, dev, gen):
    """K14 vs plain at the serving pack's gate_up + down with the RMSNorm
    fused, N = MAX_BATCH and 8 rows (its largest): the bf16 output within
    1e-2 of the largest magnitude (K1's bound; the same chain twice), on the
    body its rule picks (the stream body's two launches at these shapes),
    with the cooperative body timed beside it (old_body_ms; coop_grid_blocks
    is the grid the card holds for it).  Yardsticks: the two bf16 torch.matmuls with SiLU·up between
    them (library_ms), and the unfused path's K1 pair with SiLU·up between
    them (unfused_ms)."""
    import torch

    from smoothquant_tpu_torch.kernels import _build
    from smoothquant_tpu_torch.kernels import int4_group_matmul as k1
    from smoothquant_tpu_torch.kernels import mlp_fused as k14
    from smoothquant_tpu_torch.utils import roofline

    st = stacked["layers"]["stacked"]
    gu, dn = st["mlp"]["gate_up_proj"], st["mlp"]["down_proj"]
    n_l, half1, o1 = gu.w_qt.shape
    _, half2, o2 = dn.w_qt.shape
    c, inter, gs = gu.meta.in_features, dn.meta.in_features, gu.meta.group_size
    kw = dict(group_size=gs, act_bits=gu.meta.act_bits, n_sal1=gu.meta.num_salient,
              n_sal2=dn.meta.num_salient, gu_out_true=gu.meta.out_features,
              dn_out_true=dn.meta.out_features, eps=1e-5)
    norm = (torch.rand((n_l, c), generator=gen, device=dev) + 0.5).to(torch.bfloat16).float()
    w1 = torch.randn((c, 2 * inter), generator=gen, device=dev).to(torch.bfloat16)
    w2 = torch.randn((inter, c), generator=gen, device=dev).to(torch.bfloat16)
    k1_kw = dict(group_size=gs, act_bits=gu.meta.act_bits)
    rows = []
    for n in (MAX_BATCH, 8):
        x = torch.randn((n, c), generator=gen, device=dev).to(torch.bfloat16)
        args = lambda i: (i % n_l, x, norm[i % n_l], gu.w_qt, gu.w_scales_t, gu.w_sal_t,
                          dn.w_qt, dn.w_scales_t, dn.w_sal_t)
        body = k14.mlp_body(n, c, o1, 2 * half1, gu.w_sal_t.shape[1], o2, inter, gs, x.dtype)
        got = _launched(k14.LAUNCH_KEYS[body][0],
                        lambda: k14.mlp_swiglu_fused_stacked(*args(n_l - 1), **kw))
        ref = k14.mlp_swiglu_fused_stacked_plain(*args(n_l - 1), **kw)
        torch.cuda.synchronize()
        err = _close(f"K14 N={n}", got, ref, 1e-2)
        old = k14.mlp_swiglu_fused_stacked(*args(n_l - 1), **kw, body="coop")
        torch.cuda.synchronize()
        _close(f"K14 N={n} cooperative body", old, ref, 1e-2)

        def unfused(i):
            y = k1.int4_group_matmul_stacked_rawx(
                i % n_l, x, norm, gu.w_qt, gu.w_scales_t, gu.w_sal_t, eps=1e-5,
                num_salient=gu.meta.num_salient, norm_kind="rms", **k1_kw)
            hid = torch.nn.functional.silu(y[:, :inter]) * y[:, inter:2 * inter]
            return k1.int4_group_matmul_stacked_rawx(
                i % n_l, hid, None, dn.w_qt, dn.w_scales_t, dn.w_sal_t,
                num_salient=dn.meta.num_salient, norm_kind=None, **k1_kw)

        def library(i):
            y = x @ w1
            return (torch.nn.functional.silu(y[:, :inter]) * y[:, inter:]) @ w2

        n_bytes, ops = roofline.mlp_fused_cost(n, c, o1, 2 * half1, gu.w_sal_t.shape[1], o2,
                                               2 * half2, dn.w_sal_t.shape[1], gs)
        b_ms, b_by = roofline.bound_ms(n_bytes, ops)
        rows.append(dict(
            kernel="mlp_swiglu_fused_stacked", site="mlp" if n == MAX_BATCH else f"mlp@{n}",
            shape=[n, c, o1, inter, o2], body=body, max_err=err, in_sum=n == MAX_BATCH,
            check_launches=1,
            coop_grid_blocks=(_build.lib().sq_mlp_fused_grid_blocks(
                n, _build.dt_code(gu.w_scales_t), _build.dt_code(x)) if x.is_cuda else None),
            kernel_ms=device_ms(lambda i: k14.mlp_swiglu_fused_stacked(*args(i), **kw), n_l),
            old_body_ms=device_ms(lambda i: k14.mlp_swiglu_fused_stacked(
                *args(i), **kw, body="coop"), n_l),
            plain_ms=device_ms(lambda i: k14.mlp_swiglu_fused_stacked_plain(*args(i), **kw),
                               4, reps=3),
            unfused_ms=device_ms(unfused, n_l),
            bound_ms=b_ms, bound_by=b_by, library_ms=device_ms(library, 16),
            library="two bf16 torch.matmuls with SiLU·up between them, yardstick only"))
        emit(rows[-1])
    del w1, w2
    return rows


# ---------------------------------------------------------------- OPT kernels

OPT_LINEARS = (  # (site, Int8OPTLayerParams field, ReLU, int8 output)
    ("q", "q_proj", False, True), ("k", "k_proj", False, True),
    ("v", "v_proj", False, True), ("out", "out_proj", False, False),
    ("fc1", "fc1", True, True), ("fc2", "fc2", False, False))


def _i8_like_acts(shape, gen, dev, spread=30.0):
    """int8 activations of a calibrated spread (|x| ~ spread, clipped)."""
    import torch

    x = torch.randn(shape, generator=gen, device=dev) * spread
    return torch.round(x).clamp(-127, 127).to(torch.int8)


def _compare(name, got, ref):
    """f32 outputs within 1e-6 of the largest magnitude; int8 outputs
    identical or off by one code in under 1e-4 of them.  (max error, the
    count of elements that differ)."""
    import torch

    if got.dtype == torch.int8:
        return _codes_close(name, got, ref)
    return _close(name, got, ref, 1e-6), int((got != ref).sum())


def check_int8_linear(int8_tree, dev, gen):
    """K15a vs plain at the six linears of the int8 OPT, prefill (4 × 512
    rows: the wgmma body) and decode (4 rows: the stream body), each site
    cycling through every layer's weight, bit for bit; PR 3's kernels
    ("tiles", "gemv") timed beside as old_body_ms; the yardstick is
    torch._int_mm plus the f32 epilogue."""
    import torch

    from smoothquant_tpu_torch.kernels import int8 as k15
    from smoothquant_tpu_torch.kernels.int8_prefill import int_mm
    from smoothquant_tpu_torch.utils import roofline

    layers = int8_tree["int8_layers"]
    n_l = len(layers)
    rows = []
    for n in (OPT_BATCH * OPT_PROMPT, OPT_BATCH):
        for site, field, relu, to_int8 in OPT_LINEARS:
            lins = [getattr(lp, field) for lp in layers]
            o, kk = lins[0].w_q.shape
            x = _i8_like_acts((n, kk), gen, dev)
            out_dtype = torch.int8 if to_int8 else torch.float32
            kw = dict(relu=relu, out_dtype=out_dtype)
            args = lambda i: (x, lins[i % n_l].w_q, lins[i % n_l].alpha, lins[i % n_l].bias)
            got = k15.int8_linear(*args(0), **kw)
            ref = k15.int8_linear_plain(*args(0), **kw)
            old_body = "gemv" if n <= k15.MAX_GEMV_ROWS else "tiles"
            old = k15.int8_linear(*args(0), **kw, body=old_body)
            torch.cuda.synchronize()
            err, n_diff = _compare(f"K15a {site} N={n}", got, ref)
            _compare(f"K15a {site} N={n} ({old_body} body)", old, ref)
            if n_diff:
                raise AssertionError(f"K15a {site} N={n}: {n_diff} outputs differ from the "
                                     "plain version's")

            def library(i):
                a = args(i)
                y = int_mm(a[0], a[1].t()).float() * a[2] + a[3]
                if relu:
                    y = y.clamp_min(0.0)
                return torch.round(y).clamp(-127, 127).to(torch.int8) if to_int8 else y

            n_bytes, ops = roofline.int8_linear_cost(n, o, kk, out_bytes=1 if to_int8 else 4)
            b_ms, b_by = roofline.bound_ms(n_bytes, ops)
            rows.append(dict(
                kernel="int8_linear", site=f"{site}@{n}", shape=[n, kk, o],
                out=str(out_dtype).replace("torch.", ""), body=k15.linear_body(n),
                max_err=err, n_diff=n_diff,
                kernel_ms=device_ms(lambda i: k15.int8_linear(*args(i), **kw), n_l),
                old_body=old_body,
                old_body_ms=device_ms(lambda i: k15.int8_linear(*args(i), **kw, body=old_body),
                                      n_l),
                plain_ms=device_ms(lambda i: k15.int8_linear_plain(*args(i), **kw), 2,
                                   reps=3),
                bound_ms=b_ms, bound_by=b_by, library_ms=device_ms(library, n_l),
                library="torch._int_mm + f32 epilogue, yardstick only"))
            emit(rows[-1])
    return rows


def check_int8_bmm(int8_tree, cfg, dev, gen):
    """K15b vs plain at the attention products of the int8 OPT: QKᵀ (f32
    out) and PV (int8 out, v in its (Sk, d) layout) at the no-cache prefill
    (S = 512) and at decode (one query over a 1024-position cache); the
    yardstick is a bf16 torch.bmm on the same values."""
    import torch

    from smoothquant_tpu_torch.kernels import int8 as k15
    from smoothquant_tpu_torch.utils import roofline

    sc = int8_tree["int8_layers"][0].scales
    alpha_qk = sc["q_output_scale"] * sc["k_output_scale"]
    alpha_pv = (1.0 / 127.0) * sc["v_output_scale"] / sc["out_input_scale"]
    bh, d = OPT_BATCH * cfg.num_attention_heads, cfg.head_dim
    n_buf = 4                    # distinct operands, so the timing does not sit in L2
    rows = []
    for phase, sq, sk in (("prefill", OPT_PROMPT, OPT_PROMPT), ("decode", 1, OPT_MAX_LEN)):
        q = [_i8_like_acts((bh, sq, d), gen, dev) for _ in range(n_buf)]
        k = [_i8_like_acts((bh, sk, d), gen, dev) for _ in range(n_buf)]
        v = [_i8_like_acts((bh, sk, d), gen, dev) for _ in range(n_buf)]
        logits = torch.randn((bh, sq, sk), generator=gen, device=dev) * 3
        probs8 = torch.round(torch.softmax(logits, dim=-1) * 127).to(torch.int8)
        del logits
        for site, a, b, alpha, out_dtype, b_kn in (
                ("qk", q, k, alpha_qk, torch.float32, False),
                ("pv", [probs8] * n_buf, v, alpha_pv, torch.int8, True)):
            args = lambda i: (a[i % n_buf], b[i % n_buf], alpha)
            kw = dict(out_dtype=out_dtype, b_kn=b_kn)
            m, kk = a[0].shape[1:]
            n = b[0].shape[2] if b_kn else b[0].shape[1]
            body = k15.bmm_body(m, n, kk, b_kn, out_dtype)
            old = "gemv" if m <= k15.MAX_GEMV_ROWS else "tiles"   # K15a's kernels
            got = k15.int8_bmm(*args(0), **kw)
            ref = k15.int8_bmm_plain(*args(0), **kw)
            got_old = k15.int8_bmm(*args(0), **kw, body=old)
            torch.cuda.synchronize()
            err, n_diff = _compare(f"K15b {site} {phase}", got, ref)
            if not (torch.equal(got, ref) and torch.equal(got_old, ref)):
                raise AssertionError(f"K15b {site} {phase}: not bit-exact against the plain "
                                     "version")
            a16 = [t.to(torch.bfloat16) for t in a[:2]]
            b16 = [(t if b_kn else t.transpose(1, 2)).to(torch.bfloat16) for t in b[:2]]
            n_bytes, ops = roofline.int8_bmm_cost(bh, m, n, kk,
                                                  out_bytes=1 if b_kn else 4)
            b_ms, b_by = roofline.bound_ms(n_bytes, ops)
            rows.append(dict(
                kernel="int8_bmm", site=f"{site}@{phase}", shape=[bh, m, n, kk],
                out=str(out_dtype).replace("torch.", ""), max_err=err, n_diff=n_diff,
                body=body,
                kernel_ms=device_ms(lambda i: k15.int8_bmm(*args(i), **kw), 8),
                old_body=old,
                old_ms=device_ms(lambda i: k15.int8_bmm(*args(i), **kw, body=old), 8),
                plain_ms=device_ms(lambda i: k15.int8_bmm_plain(*args(i), **kw), 2, reps=3),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=device_ms(lambda i: torch.bmm(a16[i % 2], b16[i % 2]), 8),
                library="torch.bmm bf16 on the same values, yardstick only"))
            emit(rows[-1])
            del a16, b16
    return rows


def check_norm_quant(int8_tree, cfg, dev, gen):
    """K16 vs plain: the f32 residual stream's LayerNorm → int8 at the
    prefill (4 × 512 rows) and decode (4 rows), C = hidden, each layer's
    γ / β and static scale, on the row body with the one-block-a-row body
    timed beside it (old_body_ms); the yardstick is F.layer_norm."""
    import torch
    import torch.nn.functional as F

    from smoothquant_tpu_torch.kernels import norm_quant as k16
    from smoothquant_tpu_torch.utils import roofline

    layers = int8_tree["int8_layers"]
    n_l, c, eps = len(layers), cfg.hidden_size, cfg.layer_norm_eps
    rows = []
    for n in (OPT_BATCH * OPT_PROMPT, OPT_BATCH):
        xs = [torch.randn((n, c), generator=gen, device=dev) * 2 + 0.3 for _ in range(4)]
        args = lambda i: (xs[i % 4], layers[i % n_l].ln_attn_gamma, layers[i % n_l].ln_attn_beta,
                          layers[i % n_l].scales["attn_input_scale"])
        got = _launched("norm_quant", lambda: k16.layer_norm_q(*args(0), eps=eps))
        ref = k16.norm_quant_plain(*args(0), eps=eps)
        old = k16.norm_quant(*args(0), eps=eps, body="block")
        torch.cuda.synchronize()
        err, n_diff = _compare(f"K16 N={n}", got, ref)
        _compare(f"K16 N={n} block body", old, ref)
        g32 = [lp.ln_attn_gamma.float() for lp in layers]
        b32 = [lp.ln_attn_beta.float() for lp in layers]
        n_bytes, ops = roofline.norm_quant_cost(n, c, x_bytes=4)
        b_ms, b_by = roofline.bound_ms(n_bytes, ops)
        rows.append(dict(
            kernel="norm_quant", site=f"ln@{n}", shape=[n, c], max_err=err, n_diff=n_diff,
            plan=list(k16.k16_plan(n, c)), check_launches=1,
            kernel_ms=device_ms(lambda i: k16.layer_norm_q(*args(i), eps=eps), n_l),
            old_body_ms=device_ms(lambda i: k16.norm_quant(*args(i), eps=eps, body="block"), n_l),
            plain_ms=device_ms(lambda i: k16.norm_quant_plain(*args(i), eps=eps), 4, reps=3),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=device_ms(lambda i: F.layer_norm(xs[i % 4], (c,), g32[i % n_l],
                                                        b32[i % n_l], eps), n_l),
            library="F.layer_norm f32 (no quantize), yardstick only"))
        emit(rows[-1])
    return rows


# ---------------------------------------------------------------- quick start


def quickstart_recipe():
    """The README quick start's recipe: W4A4 g64, 5 % salient channels."""
    from smoothquant_tpu_torch.quant.config import w4a4_group

    return w4a4_group(group_size=64, salient_prop=0.05)


def build_quickstart(fp, cfg, dev, n_samples=QS_SAMPLES, seq_len=QS_LEN):
    """The README quick start on `dev` from the fp tree: calibration
    (get_act_scales, get_calib_feat over the tapped per-layer forward, on
    n_samples random sequences of seq_len tokens), smooth_lm (α = QS_ALPHA),
    pack_model with its defaults (per-layer int8-container packs).  Returns
    (packed tree, seconds of each step, {"smoothed": the smoothed fp tree,
    "feat": the calibration vectors}) — the simulated path's phases reuse
    the last two."""
    import numpy as np
    import torch

    from smoothquant_tpu_torch.models import llama
    from smoothquant_tpu_torch.models.common import ForwardContext
    from smoothquant_tpu_torch.models.registry import pack_model, smooth_lm
    from smoothquant_tpu_torch.quant.calibrate import get_act_scales, get_calib_feat

    rng = np.random.default_rng(SEED + 31)
    batches = [rng.integers(0, cfg.vocab_size, size=(1, seq_len)) for _ in range(n_samples)]

    def fwd(p, ids, col):
        return llama.forward(p, torch.as_tensor(ids, device=dev), cfg,
                             ctx=ForwardContext(taps=col))

    seconds = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        return r

    scales = timed("act_scales", lambda: get_act_scales(fwd, fp, batches))
    feat = timed("calib_feat", lambda: get_calib_feat(fwd, fp, batches))
    smoothed = timed("smooth_lm", lambda: smooth_lm("llama", fp, cfg, scales, alpha=QS_ALPHA))
    packed = timed("pack_model", lambda: pack_model("llama", smoothed, cfg, quickstart_recipe(),
                                                    input_feat=feat, act_scales=scales))
    return packed, seconds, {"smoothed": smoothed, "feat": feat}


def single_group_packs(fp):
    """Single-group (G = 1) int8-container packs of layer 0's gate_proj and
    down_proj, per-channel int4 weights: gate under per-token int8
    activations with 5 % salient channels (one group of 3892), down under
    per-token int4 ones with none (one group of all 11008; int8 ones
    without salient channels would make the identity-int8 layout, K4's)."""
    import numpy as np

    from smoothquant_tpu_torch.kernels.pack import pack_linear
    from smoothquant_tpu_torch.quant.config import QuantConfig

    mlp = fp["layers"]["0"]["mlp"]
    out = {}
    for site, lin, prop, bits in (("gate_g1", mlp["gate_proj"], 0.05, 8),
                                  ("down_g1", mlp["down_proj"], 0.0, 4)):
        c = lin["weight"].shape[1]
        qcfg = QuantConfig(weight_quant="per_channel", act_quant="per_token", quant_bits=4,
                           act_bits=bits, salient_prop=prop)
        imp = np.random.default_rng(SEED + c).uniform(0.1, 1.0, size=(c,))
        out[site] = pack_linear(lin, qcfg, importance=imp)
    return out


def _qs_sites(packed, layer=0):
    lp = packed["layers"][str(layer)]
    return {"q": lp["self_attn"]["q_proj"], "gate": lp["mlp"]["gate_proj"],
            "down": lp["mlp"]["down_proj"]}


def _qs_layers(packed, site):
    """The site's linear in every layer of the quick start's pack: a timed
    call cycles over them, so each finds its weight cold in L2, as a decode
    step that reads each layer once does."""
    return [_qs_sites(packed, i)[site] for i in range(len(packed["layers"]))]


def _bf16_weights(c, o, gen, dev, cold_bytes=150 * 2 ** 20):
    """bf16 (C, O) weights for a timed yardstick to cycle over: enough of
    them that together they pass the 50 MB L2, so each call reads cold."""
    import torch

    k = max(2, -(-cold_bytes // (2 * c * o)))
    return [torch.randn((c, o), generator=gen, device=dev).to(torch.bfloat16) for _ in range(k)]


def _no_salient(lin):
    """The pack with its salient block cut away (the kernels' no-salient bodies)."""
    import dataclasses

    return dataclasses.replace(lin, w_sal_t=lin.w_sal_t[:0])


def _true_widths(m, sal: bool):
    """(non-salient, salient) channels a packed linear's function needs: its
    true widths, without the pack's padding to whole groups and to 128
    salient rows (roofline costs count these)."""
    k_s = m.num_salient if sal else 0
    return m.in_features - m.num_salient, k_s


def check_int_group_matmul(packed, single, dev, gen):
    """K8 vs plain at layer 0's q / gate / down of the quick start's pack
    (k_ns 3904 or 10496, k_s 256 or 640) with the salient block at N = 1,
    4, 16 and 64 and without it at 4 and 64, and at the single-group packs
    (G = 1, K 3892 with salient and 11008 without), N = 4 and 512; bf16
    activations and output.  Timed cold: each call takes the next layer's
    weight of the same site (a decode step reads each layer's once).  Where
    the shape rule picks the stream body, the tiles body is timed beside
    it at the same shape (tiles_ms).  At the kernels line's sites (q /
    gate / down with the salient block, N = 4) also the plain version's
    time and a bf16 torch.matmul of the same (N, C, O) over weights cycled
    past the L2."""
    import torch

    from smoothquant_tpu_torch.kernels import int_group_matmul as k8
    from smoothquant_tpu_torch.kernels.pack import quantize_activations_packed_int
    from smoothquant_tpu_torch.utils import roofline

    cases = [(site, _qs_layers(packed, site), n, sal) for site in ("q", "gate", "down")
             for n, sal in ((1, True), (4, True), (4, False), (16, True), (64, True),
                            (64, False))]
    cases += [(site, [lin], n, lin.meta.num_salient > 0) for site, lin in single.items()
              for n in (4, 512)]
    rows = []
    for site, lins, n, sal in cases:
        if not sal:
            lins = [_no_salient(lin) for lin in lins]
        lin = lins[0]
        m = lin.meta
        c, o = m.in_features, m.out_features
        x = torch.randn((n, c), generator=gen, device=dev).to(torch.bfloat16)
        x_q, x_s, x_sal = quantize_activations_packed_int(x, m)
        w_sal = [t.w_sal_t.to(torch.bfloat16) for t in lins]
        x_sal = x_sal[:, :w_sal[0].shape[0]]
        kw = dict(group_size=m.group_size, out_dtype=torch.bfloat16)
        args = lambda i: (x_q, x_s, lins[i % len(lins)].w_qt, lins[i % len(lins)].w_scales_t,
                          x_sal, w_sal[i % len(lins)])
        got = k8.int_group_matmul(*args(0), **kw)
        ref = k8.int_group_matmul_plain(*args(0), **kw)
        torch.cuda.synchronize()
        name = f"{site}{'' if sal else '_nosal'}@{n}"
        err = _close(f"K8 {name}", got, ref, 1e-2)
        k_ns, k_s = _true_widths(m, sal)
        n_bytes, ops = roofline.int_group_matmul_cost(n, o, k_ns, m.group_size, k_s)
        b_ms, b_by = roofline.bound_ms(n_bytes, ops)
        in_sum = sal and n == 4 and site in ("q", "gate", "down")
        body = k8.int_gmm_body(n, o, m.k_ns, m.group_size)
        timed = lambda b: device_ms(lambda i: k8.int_group_matmul(*args(i), **kw, body=b),
                                    len(lins), reps=3)
        rows.append(dict(
            kernel="int_group_matmul", site=name, body=body,
            shape=[n, c, o, m.k_ns, m.group_size, w_sal[0].shape[0]],
            scalings=[n, o, k_ns, m.group_size],
            max_err=err, in_sum=in_sum, bound_ms=b_ms, bound_by=b_by,
            kernel_ms=timed(body)))
        if body == "stream":
            rows[-1]["tiles_ms"] = timed("tiles")
        if in_sum:   # the yardsticks of the kernels line's sites
            w_lib = _bf16_weights(c, o, gen, dev)
            rows[-1].update(
                plain_ms=device_ms(lambda i: k8.int_group_matmul_plain(*args(i), **kw), 2,
                                   reps=3),
                library_ms=device_ms(lambda i: x @ w_lib[i % len(w_lib)], 2 * len(w_lib),
                                     reps=3),
                library="torch.matmul bf16 (N, C) @ (C, O) over weights cycled past the L2, "
                        "yardstick only")
            del w_lib
        emit(rows[-1])
    return rows


def check_dual_path_matmul(packed, single, dev, gen):
    """K9's four bodies vs plain at N = 512 and 2048: grouped with and
    without the salient block (layer 0's gate_proj of the quick start's
    pack), single group with it (gate, G = 1) and without (down, G = 1);
    bf16.  At the kernels line's site (grouped, N = 2048) also the plain
    version's time and two yardsticks: a bf16 torch.matmul of the same
    (N, C, O), and torch.matmul over the weight dequantized once (plus the
    salient dot)."""
    import torch

    from smoothquant_tpu_torch.kernels import quant_matmul as k9
    from smoothquant_tpu_torch.kernels.pack import quantize_activations_packed
    from smoothquant_tpu_torch.utils import roofline

    gates = _qs_layers(packed, "gate")
    cases = [("grouped", gates), ("grouped_nosal", [_no_salient(g) for g in gates]),
             ("colscale", [single["gate_g1"]]), ("colscale_nosal", [single["down_g1"]])]
    rows = []
    for body, lins in cases:
        lin = lins[0]
        m = lin.meta
        c, o = m.in_features, m.out_features
        w_sal = lin.w_sal_t.to(torch.bfloat16)
        w_deq = None
        for n in (512, 2048):
            x = torch.randn((n, c), generator=gen, device=dev).to(torch.bfloat16)
            x_ns, x_sal = quantize_activations_packed(x, m)
            x_sal = x_sal[:, :w_sal.shape[0]]
            kw = dict(group_size=m.group_size, out_dtype=torch.bfloat16)
            args = (x_ns, x_sal, lin.w_qt, lin.w_scales_t, w_sal)
            # timed cold, as K8: the next layer's gate_proj each call
            cyc = lambda i: (x_ns, x_sal, lins[i % len(lins)].w_qt,
                             lins[i % len(lins)].w_scales_t,
                             lins[i % len(lins)].w_sal_t.to(torch.bfloat16))
            got = k9.dual_path_matmul(*args, **kw)
            ref = k9.dual_path_matmul_plain(*args, **kw)
            torch.cuda.synchronize()
            err = _close(f"K9 {body}@{n}", got, ref, 1e-2)
            if w_deq is None:
                s = lin.w_scales_t.float()
                if s.shape[0] > 1:
                    s = s.repeat_interleave(m.group_size, dim=0)
                w_deq = (lin.w_qt.float() * s).to(torch.bfloat16)
            k_ns, k_s = _true_widths(m, w_sal.shape[0] > 0)
            n_bytes, ops = roofline.dual_path_matmul_cost(n, o, k_ns, m.group_size, k_s)
            b_ms, b_by = roofline.bound_ms(n_bytes, ops)
            in_sum = body == "grouped" and n == 2048
            rows.append(dict(
                kernel="dual_path_matmul", site=f"{body}@{n}",
                shape=[n, c, o, m.k_ns, m.group_size, w_sal.shape[0]],
                max_err=err,
                in_sum=in_sum, bound_ms=b_ms, bound_by=b_by,
                kernel_ms=device_ms(lambda i: k9.dual_path_matmul(*cyc(i), **kw),
                                    max(4, len(lins)), reps=3)))
            if in_sum:   # the yardsticks of the kernels line's site
                w_lib = _bf16_weights(c, o, gen, dev)

                def deq_once(i):
                    y = x_ns @ w_deq
                    return y + x_sal @ w_sal if w_sal.shape[0] else y

                rows[-1].update(
                    plain_ms=device_ms(lambda i: k9.dual_path_matmul_plain(*args, **kw), 2,
                                       reps=3),
                    library_ms=device_ms(lambda i: x @ w_lib[i % len(w_lib)],
                                         2 * len(w_lib), reps=3),
                    library="torch.matmul bf16 (N, C) @ (C, O) over weights cycled past the "
                            "L2, yardstick only",
                    dequant_once_ms=device_ms(deq_once, 4, reps=3))
                del w_lib
            emit(rows[-1])
        del w_deq
    return rows


def int_path_crossover(packed, dev, gen):
    """real_quant_linear on gate_proj (4096 → 11008) and down_proj (11008 →
    4096) of the quick start's pack in "int" (K8) and "dequant" (K9) mode,
    activation prep included, at each of CROSSOVER_N rows, each call on the
    next layer's linear (cold, as a forward finds them); the smallest N
    from which the dequant path wins on both (None: the int path wins at
    every N measured)."""
    import torch

    from smoothquant_tpu_torch.kernels.real_linear import real_quant_linear

    sites = {site: _qs_layers(packed, site) for site in ("gate", "down")}
    times = {site: {} for site in sites}
    for n in CROSSOVER_N:
        for site, lins in sites.items():
            x = torch.randn((n, lins[0].meta.in_features), generator=gen,
                            device=dev).to(torch.bfloat16)
            times[site][n] = {mode: device_ms(
                lambda i: real_quant_linear(lins[i % len(lins)], x, compute=mode), len(lins),
                reps=2) for mode in ("int", "dequant")}
    wins = [n for n in CROSSOVER_N
            if all(t[n]["dequant"] < t[n]["int"] for t in times.values())]
    above = [n for n in CROSSOVER_N if all(w in wins for w in CROSSOVER_N if w >= n)]
    return dict(rows=list(CROSSOVER_N), ms=times, dequant_wins_at=wins,
                dequant_wins_from=above[0] if above else None)


def prefill_kernel_crossover(promoted, cfg, dev, gen):
    """The identity-int8 forward's two sides — K4, or torch._int_mm with the
    f32 epilogue — after the shared prologue, at layer 0's gate_up (4096 →
    22016) and down (11008 → 4096) of the promoted tree and N of 4 to 1024;
    the smallest N from which K4 wins on both, and from which it wins on
    the two together."""
    import torch

    from smoothquant_tpu_torch.kernels import real_linear

    def side(lin, x, k4: bool):
        """The identity-int8 forward with its switch set to one side."""
        saved = real_linear.PREFILL_KERNEL_MIN_TOKENS
        real_linear.PREFILL_KERNEL_MIN_TOKENS = 0 if k4 else x.shape[0] + 1
        try:
            return real_linear._identity_int8_forward(lin, x, torch.bfloat16)
        finally:
            real_linear.PREFILL_KERNEL_MIN_TOKENS = saved

    lp = promoted["layers"]["0"]
    sites = {"gate_up": lp["mlp"]["gate_up_proj"], "down": lp["mlp"]["down_proj"]}
    rows = [n for n in CROSSOVER_N if n <= PREFILL_N]
    times = {site: {} for site in sites}
    for n in rows:
        for site, lin in sites.items():
            x = torch.randn((n, lin.meta.in_features), generator=gen,
                            device=dev).to(torch.bfloat16)
            times[site][n] = {name: device_ms(lambda i: side(lin, x, k4), 4, reps=2)
                              for name, k4 in (("k4", True), ("int_mm", False))}
    wins = [n for n in rows if all(t[n]["k4"] < t[n]["int_mm"] for t in times.values())]
    above = [n for n in rows if all(w in wins for w in rows if w >= n)]
    total = lambda n, side: sum(t[n][side] for t in times.values())
    sum_wins = [n for n in rows if total(n, "k4") < total(n, "int_mm")]
    sum_above = [n for n in rows if all(w in sum_wins for w in rows if w >= n)]
    return dict(rows=rows, ms=times, k4_wins_at=wins, k4_wins_from=above[0] if above else None,
                k4_sum_wins_from=sum_above[0] if sum_above else None)


def k11_key(dtype, head_dim: int, s: int, rep: int = 1, alibi: bool = False) -> str:
    """The launch counter of the K11 body a call takes (the split body for
    bf16 queries, the flash body for f32 ones: decode_attention.attn_body)."""
    from smoothquant_tpu_torch.kernels import decode_attention as k11

    return k11.LAUNCH_KEYS[k11.attn_body(dtype, head_dim, s, rep), alibi]


def rawx_launches(layer, n: int, dtype, n_layers: int) -> dict:
    """K1's launches by body (the counter each takes) over a stacked layer's
    four linears at n rows, one decode step of n_layers layers: the stream
    body's under the kernel's name for bf16, the dp4a body's for f32."""
    from collections import Counter

    from smoothquant_tpu_torch.kernels import int4_group_matmul as k1

    out = Counter()
    for _, lin, _ in _sites(layer):
        _, half, o = lin.w_qt.shape
        body = k1.rawx_body(n, lin.meta.in_features, o, 2 * half, lin.meta.group_size,
                            lin.w_sal_t.shape[1], dtype)
        out[k1.RAWX_LAUNCH_KEYS[body]] += n_layers
    return dict(out)


def quickstart_launches(meta, n_layers: int, rows: int, steps: int = 0,
                        k11_counter: str = "decode_attention_stacked") -> dict:
    """Kernel launches over the quick start's per-layer pack (its recipe in
    `meta`): with steps = 0 a prefill of `rows` rows, whose seven linears a
    layer take K8 or K9 as real_linear picks them for its rows; otherwise
    `steps` decode steps of `rows` rows, their linears picked the same way
    and K11 once a layer a step (counted under `k11_counter`, the body's)."""
    from smoothquant_tpu_torch.kernels.real_linear import choose_compute

    kernel = {"int": "int_group_matmul",
              "dequant": "dual_path_matmul"}[choose_compute(meta, rows)]
    if not steps:
        return {kernel: 7 * n_layers}
    return {kernel: 7 * n_layers * steps, k11_counter: n_layers * steps}


def quickstart(fp, packed, cfg, dev, card):
    """The quick start's serving end: Generator(quant_kv=True) over the
    packed tree, QS_BATCH prompts of QS_PROMPT random tokens and QS_NEW new
    ones over per-layer int8 caches.  Prefill tokens/s (a prefill-only
    run), decode ms/step by host clock and by device busy time (a full run
    less the prefill-only one, under torch.profiler), launches (K8 7·L and
    K11 L a decode step; the prefill's 7·L on K8 or K9 as the crossover
    puts its QS_BATCH·QS_PROMPT rows).  When those rows stay on the int
    path, a no-cache prefill forced to "dequant" keeps K9 on the path.
    Also the packed model's logits against the fp model's on one prompt
    (top-1 agreement, relative norm error).  Returns (metrics, launches)."""
    from collections import Counter

    import numpy as np
    import torch

    from smoothquant_tpu_torch.kernels.real_linear import choose_compute
    from smoothquant_tpu_torch.models import llama
    from smoothquant_tpu_torch.models.common import ForwardContext
    from smoothquant_tpu_torch.serve.generate import GenerationConfig, Generator

    n_l, steps, rows = cfg.num_hidden_layers, QS_NEW - 1, QS_BATCH * QS_PROMPT
    meta = _qs_sites(packed)["q"].meta
    prompts = np.random.default_rng(SEED + 37).integers(0, cfg.vocab_size,
                                                        size=(QS_BATCH, QS_PROMPT))
    gen = Generator(llama, packed, cfg, max_len=QS_MAX_LEN, quant_kv=True, device=dev)
    gen.generate(prompts[:, :16], GenerationConfig(max_new_tokens=2))      # warm-up

    def run(new):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = gen.generate(prompts, GenerationConfig(max_new_tokens=new))
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    prefill_s = statistics.median(run(1)[1] for _ in range(3))
    (out, wall), launches = _path_launches(lambda: run(QS_NEW))
    expect = Counter(quickstart_launches(meta, n_l, rows))
    expect.update(quickstart_launches(meta, n_l, QS_BATCH, steps))
    _check_launches("quick start generator", launches, dict(expect))
    new = out[:, QS_PROMPT:]
    if not (out.shape == (QS_BATCH, QS_PROMPT + QS_NEW) and (out[:, :QS_PROMPT] == prompts).all()
            and ((0 <= new) & (new < cfg.vocab_size)).all()):
        raise AssertionError("quick start generator: misshapen output or token out of range")
    # device time: a run of QS_PROFILE_NEW tokens less the prefill-only one
    # (a short window: the profiler's own cost grows with the events)
    busy_short = profile(lambda: run(QS_PROFILE_NEW), 1)
    busy_prefill = profile(lambda: run(1), 1)
    res = dict(batch=QS_BATCH, prompt=QS_PROMPT, new_tokens=QS_NEW,
               prefill_compute=choose_compute(meta, rows), prefill_ms=1e3 * prefill_s,
               prefill_tokens_per_s=rows / prefill_s,
               decode_ms_per_step=1e3 * (wall - prefill_s) / steps,
               decode_busy_ms_per_step=(busy_short["busy_ms_per_step"]
                                        - busy_prefill["busy_ms_per_step"]) / (QS_PROFILE_NEW - 1),
               wall_s=wall, tokens_per_s=QS_BATCH * QS_NEW / wall, launches=launches,
               launches_per_decode_step=quickstart_launches(meta, n_l, QS_BATCH, 1),
               prefill_trace=busy_prefill, trace=busy_short)
    ids = torch.as_tensor(prompts, device=dev)
    if res["prefill_compute"] != "dequant":
        fwd = torch.no_grad()(lambda: llama.forward(
            packed, ids, cfg, ctx=ForwardContext(compute="dequant"))[0])
        fwd()                                                    # warm-up
        _, used = _path_launches(fwd)
        _check_launches("quick start dequant prefill", used, {"dual_path_matmul": 7 * n_l})
        launches = dict(Counter(launches) + Counter(used))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fwd()
        torch.cuda.synchronize()
        res["dequant_prefill"] = dict(ms=1e3 * (time.perf_counter() - t0), launches=used)
    with torch.no_grad():
        q_logits = llama.forward(packed, ids[:1], cfg)[0][0]
        f_logits = llama.forward(fp, ids[:1], cfg)[0][0]
    if not (torch.isfinite(q_logits).all() and q_logits.shape == (QS_PROMPT, cfg.vocab_size)):
        raise AssertionError("quick start: non-finite or misshapen logits")
    res["vs_fp"] = dict(
        top1_agree=float((q_logits.argmax(-1) == f_logits.argmax(-1)).float().mean()),
        rel_norm_err=float((q_logits - f_logits).norm() / f_logits.norm()))
    return res, launches


# ---------------------------------------------------------------- simulated path


def sim_cases(act: bool):
    """The quantizer grid: (granularity, sort key or None, group size or
    None, bits, dtype name) — every granularity ("per_group" sorted by each
    key), group sizes 64 and 128, 4 and 8 bits, f32 and bf16."""
    kinds = [("per_token" if act else "per_channel", None), ("per_tensor", None),
             ("per_group_unsorted", None), ("per_group", "max"), ("per_group", "mean_std"),
             ("per_group", "argmax")]
    return [(name, strat, gs, bits, dt) for name, strat in kinds
            for gs in ((64, 128) if name.startswith("per_group") else (None,))
            for bits in (4, 8) for dt in ("float32", "bfloat16")]


def _outlier_rows(shape, gen, dev, dtype):
    """Rows of mixed magnitude, 16 outlier columns and a dead one (a tie
    under every sort key)."""
    import torch

    n, c = shape
    x = torch.randn(shape, generator=gen, device=dev)
    x *= torch.rand((n, 1), generator=gen, device=dev) * 2.8 + 0.2
    x[:, torch.randperm(c, generator=gen, device=dev)[:16]] *= 20.0
    x[:, 5] = 0.0
    return x.to(dtype)


def check_sim_quantizers(dev, gen):
    """Every weight and activation quantizer of the grid (sim_cases) on the
    card against the same function on a CPU copy of its input, bit for
    bit: the weight cases cycle through SIM_WEIGHT_SHAPES, the activation
    cases through SIM_ACT_SHAPES, so each granularity meets every shape;
    then quantize_linear_params with 5 % salient channels (W4A4 g64 sorted
    at gate_proj's shape, W8A8 per-channel at down_proj's): the weight, the
    salient permutations.  The quantizers are written device-independent
    (the mean_std key's sums in f64, stable sorts, the exact division by a
    tensor), so any differing bit fails — after every case has run, the
    failures listed.  Returns the phase's record."""
    import dataclasses

    import numpy as np
    import torch

    from smoothquant_tpu_torch.quant import core
    from smoothquant_tpu_torch.quant.config import W8A8_SMOOTHQUANT, w4a4_group
    from smoothquant_tpu_torch.quant.linear import quantize_linear_params

    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    card_s = cpu_s = 0.0
    names, failed = [], []
    for act, shapes in ((False, SIM_WEIGHT_SHAPES), (True, SIM_ACT_SHAPES)):
        get = core.get_act_quantizer if act else core.get_weight_quantizer
        for i, (name, strat, gs, bits, dt) in enumerate(sim_cases(act)):
            shape = shapes[i % len(shapes)]
            fn = get(name, bits, group_size=gs or 128, sort_strategy=strat or "max")
            x = _outlier_rows(shape, gen, dev, dtypes[dt])
            x_cpu = x.cpu()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = fn(x)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            ref = fn(x_cpu)
            t2 = time.perf_counter()
            card_s, cpu_s = card_s + t1 - t0, cpu_s + t2 - t1
            case = "-".join(str(v) for v in ("act" if act else "weight", name, strat, gs,
                                             f"{bits}b", dt, "x".join(map(str, shape)))
                            if v is not None)
            try:
                _same_bits(case, got.cpu(), ref)
            except AssertionError as e:
                failed.append(str(e))
            names.append(case)
    salient = []
    for qcfg, (o, c) in ((w4a4_group(64, 0.05), SIM_WEIGHT_SHAPES[1]),
                         (dataclasses.replace(W8A8_SMOOTHQUANT, salient_prop=0.05),
                          SIM_WEIGHT_SHAPES[2])):
        w = _outlier_rows((o, c), gen, dev, torch.bfloat16)
        imp = np.random.default_rng(SEED + c).uniform(0.1, 1.0, size=(c,))
        bias = torch.randn((o,), generator=gen, device=dev).to(torch.bfloat16)
        got = quantize_linear_params({"weight": w, "bias": bias}, qcfg, imp)
        ref = quantize_linear_params({"weight": w.cpu(), "bias": bias.cpu()}, qcfg, imp)
        case = f"quantize_linear_params-{qcfg.weight_quant}-{qcfg.quant_bits}b-{o}x{c}"
        if set(got) != set(ref) or "sal_perm" not in got:
            raise AssertionError(f"sim_quantizers {case}: leaves {sorted(got)}")
        for k in ref:
            if ref[k] is not None:
                try:
                    _same_bits(f"{case} {k}", got[k].cpu(), ref[k])
                except AssertionError as e:
                    failed.append(str(e))
        salient.append(dict(case=case, num_salient=int(got["salient_indices"].numel())))
    if failed:
        raise AssertionError(f"sim_quantizers: {len(failed)} cases differ: {failed}")
    return dict(cases=len(names), bit_exact=True, grid=names, quantize_linear_params=salient,
                card_seconds=card_s, cpu_seconds=cpu_s)


def _sim_logits(tree, ids, cfg, mod, qcfg):
    """Logits of a simulated (or fp, qcfg None) forward."""
    import torch

    from smoothquant_tpu_torch.models.common import ForwardContext

    with torch.no_grad():
        return mod.forward(tree, ids, cfg, ctx=ForwardContext(quant=qcfg))[0]


def sim_reference_check(dev):
    """The simulated path on the card against the same code on the CPU, on a
    2-layer Llama (hidden 512, 4 heads of 128) and a 2-layer OPT (hidden
    512, 8 heads of 64), f32, quantize_bmm_input on: W8A8_SMOOTHQUANT and
    W4A4 g64 with 5 % salient channels (importance from a seed).  Each
    device quantizes its own copy of the weights — the leaves must agree
    bit for bit — then runs a 2 × 64-token forward.  The card's f32 sums
    run in another order, and a per-token or per-group code at a rounding
    edge then moves and spreads through the later rows and layer, so the
    logits are held to 1e-5 of their norm or, where a code moved, to half
    the quantization's own effect on the CPU (its quantized logits less
    its fp ones: 2e-2 to 5e-1 on the test models) — a wrong path misses by
    the effect itself or more."""
    import dataclasses

    import numpy as np
    import torch

    from smoothquant_tpu_torch.models import llama, opt
    from smoothquant_tpu_torch.models.registry import quantize_model
    from smoothquant_tpu_torch.quant.config import W8A8_SMOOTHQUANT, w4a4_group
    from smoothquant_tpu_torch.quant.smooth import _get_path

    models = {
        "llama": (llama, dataclasses.replace(
            llama.LlamaConfig.tiny(vocab_size=512), hidden_size=512, intermediate_size=1024,
            num_attention_heads=4, num_key_value_heads=4)),
        "opt": (opt, dataclasses.replace(opt.OPTConfig.tiny(vocab_size=512), hidden_size=512,
                                         ffn_dim=1024, num_attention_heads=8)),
    }
    recipes = {"w8a8_smoothquant": W8A8_SMOOTHQUANT,
               "w4a4_g64_5pct": w4a4_group(64, 0.05, quantize_bmm_input=True)}
    out = {}
    for arch, (mod, cfg) in models.items():
        fp = mod.init_params(torch.Generator().manual_seed(SEED + 43), cfg, "cpu")
        rng = np.random.default_rng(SEED + 43)
        feat = {key: rng.uniform(0.1, 1.0, size=(_get_path(fp, path)["weight"].shape[1],))
                for path, key, _ in mod.quantizable_linears(cfg)}
        ids = torch.randint(0, cfg.vocab_size, (2, 64), generator=torch.Generator().manual_seed(
            SEED + 44))
        fp_logits = _sim_logits(fp, ids, cfg, mod, None)
        for rname, qcfg in recipes.items():
            ref_tree = quantize_model(arch, fp, cfg, qcfg, feat)
            got_tree = quantize_model(arch, tree_to(fp, dev), cfg, qcfg, feat)
            for path, _, _ in mod.quantizable_linears(cfg):
                r, g = _get_path(ref_tree, path), _get_path(got_tree, path)
                for k in r:
                    if r[k] is not None:
                        _same_bits(f"sim_reference {arch} {rname} {path} {k}", g[k].cpu(), r[k])
            ref = _sim_logits(ref_tree, ids, cfg, mod, qcfg)
            got = _sim_logits(got_tree, ids.to(dev), cfg, mod, qcfg).cpu()
            if not (torch.isfinite(got).all() and got.shape == ref.shape):
                raise AssertionError(f"sim_reference {arch} {rname}: non-finite or misshapen")
            rel = float((got - ref).norm() / ref.norm())
            effect = float((ref - fp_logits).norm() / fp_logits.norm())
            tol = max(1e-5, 0.5 * effect)
            if not rel <= tol:
                raise AssertionError(f"sim_reference {arch} {rname}: relative norm error {rel} "
                                     f"> {tol} (quantization effect {effect})")
            out[f"{arch}_{rname}"] = dict(
                rel_norm_err=rel, quant_effect=effect, tolerance_rel_norm=tol,
                argmax_agree=float((got.argmax(-1) == ref.argmax(-1)).float().mean()))
    return out


def sim_model(smoothed, feat, cfg, recipe_name, qcfg):
    """quantize_model("llama", ...) on the card: (the simulated tree, its
    phase record: seconds, GiB allocated after, linears with salient
    channels)."""
    import torch

    from smoothquant_tpu_torch.models import llama
    from smoothquant_tpu_torch.models.registry import quantize_model
    from smoothquant_tpu_torch.quant.smooth import _get_path

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tree = quantize_model("llama", smoothed, cfg, qcfg, feat if qcfg.salient_prop else None)
    torch.cuda.synchronize()
    n_sal = sum("sal_perm" in _get_path(tree, path)
                for path, _, _ in llama.quantizable_linears(cfg))
    return tree, dict(recipe=recipe_name, seconds=time.perf_counter() - t0,
                      gib_allocated=torch.cuda.memory_allocated() / 2 ** 30,
                      salient_linears=n_sal)


def sim_vs_packed(smoothed, sim_w8a8, cfg, dev):
    """The JAX package's own cross-check (tests/test_packed_model.py:34-49)
    at full size: the W8A8 per-channel / per-token simulated forward
    against the forward of pack_model's default W8A8 pack (per-layer
    identity-int8 linears: K4 from PREFILL_KERNEL_MIN_TOKENS rows) of the
    same smoothed weights, over 1 × SIM_PACKED_TOKENS tokens, BMM inputs
    unquantized on both.  The simulated path rounds each dequantized
    activation and weight to bf16 (qdq casts back to x's dtype, as JAX's
    does) where K4 multiplies the int8 codes exactly, and the two divide
    the weight scales by other rules: codes at rounding edges move and
    spread through 32 layers, so the logits are held to the quantization's
    own effect (the simulated logits' distance from the fp model's) — a
    wrong kernel misses by the whole norm.  Returns (record, the packed
    forward's launches)."""
    import dataclasses

    import numpy as np
    import torch

    from smoothquant_tpu_torch.models import llama
    from smoothquant_tpu_torch.models.common import ForwardContext
    from smoothquant_tpu_torch.models.registry import pack_model
    from smoothquant_tpu_torch.quant.config import W8A8_SMOOTHQUANT

    qcfg = dataclasses.replace(W8A8_SMOOTHQUANT, quantize_bmm_input=False)
    t0 = time.perf_counter()
    packed = pack_model("llama", smoothed, cfg, qcfg)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    ids = torch.as_tensor(np.random.default_rng(SEED + 47).integers(
        0, cfg.vocab_size, size=(1, SIM_PACKED_TOKENS)), device=dev)
    fp = _sim_logits(smoothed, ids, cfg, llama, None)
    sim = _sim_logits(sim_w8a8, ids, cfg, llama, qcfg)
    effect = float((sim - fp).norm() / fp.norm())
    real, used = _path_launches(lambda: _sim_logits(packed, ids, cfg, llama, qcfg))
    packed_effect = float((real - fp).norm() / fp.norm())
    del fp
    _check_launches("sim_vs_packed", used, {"int8_prefill_matmul": 7 * cfg.num_hidden_layers})
    ms = {}
    for name, tree in (("sim", sim_w8a8), ("packed", packed)):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _sim_logits(tree, ids, cfg, llama, qcfg)
        torch.cuda.synchronize()
        ms[name] = 1e3 * (time.perf_counter() - t1)
    del packed
    if not (torch.isfinite(real).all() and real.shape == sim.shape):
        raise AssertionError("sim_vs_packed: non-finite or misshapen logits")
    rel = float((real - sim).norm() / sim.norm())
    if not rel <= effect:
        raise AssertionError(f"sim_vs_packed: relative norm error {rel} > the quantization's "
                             f"effect {effect}")
    return dict(tokens=SIM_PACKED_TOKENS, recipe="W8A8 per-channel / per-token",
                rel_norm_err=rel, quant_effect=effect, packed_effect=packed_effect,
                tolerance_rel_norm=effect,
                top1_agree=float((real.argmax(-1) == sim.argmax(-1)).float().mean()),
                pack_seconds=pack_s, forward_ms=ms, packed_launches=used,
                kernel="K4 (int8_prefill_matmul, s8 wgmma body)"), used


def sim_ppl(trees, cfg, dev):
    """Perplexity through Evaluator over SIM_PPL_WINDOWS windows of
    SIM_PPL_WINDOW random tokens (numpy seed) for each (name, tree, recipe)
    of `trees`, with each window's seconds.  On random weights these
    numbers say nothing of quality: they show the pipeline runs end to end
    at full size, and what a window costs."""
    import numpy as np
    import torch

    from smoothquant_tpu_torch.eval import Evaluator
    from smoothquant_tpu_torch.models import llama

    tokens = np.random.default_rng(SEED + 53).integers(
        0, cfg.vocab_size, size=(SIM_PPL_WINDOWS * SIM_PPL_WINDOW,))
    ev = Evaluator(tokens, SIM_PPL_WINDOWS, SIM_PPL_WINDOW, device=dev)
    out = {}
    for name, tree, qcfg in trees:
        seconds = []

        def logits_fn(ids):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = _sim_logits(tree, ids, cfg, llama, qcfg)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            return y

        ppl = ev.evaluate(logits_fn)
        if not (np.isfinite(ppl) and ppl > 1.0):
            raise AssertionError(f"sim_ppl {name}: perplexity {ppl}")
        out[name] = dict(ppl=ppl, seconds_per_window=seconds)
    return out


def run_sim(fp, calib, cfg, dev, card):
    """The simulated-path phases on the quick start's smoothed 7B and its
    calibration vectors (calib: build_quickstart's "smoothed" / "feat"):
    sim_quantizers, sim_reference, sim_model (W8A8_SMOOTHQUANT, then W4A4
    g64 with 5 % salient channels), sim_vs_packed, sim_ppl.  Returns the
    launches of the path that ran a kernel (the W8A8 pack's forward)."""
    import torch

    from smoothquant_tpu_torch.quant.config import W8A8_SMOOTHQUANT, w4a4_group

    gen = torch.Generator(device=dev).manual_seed(SEED + 59)
    t0 = time.perf_counter()
    emit({"phase": "sim_quantizers", "card": card, **check_sim_quantizers(dev, gen),
          "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    emit({"phase": "sim_reference", **sim_reference_check(dev),
          "seconds": time.perf_counter() - t0})
    smoothed, feat = calib["smoothed"], calib["feat"]
    w4a4 = w4a4_group(64, 0.05)
    sim8, rec = sim_model(smoothed, feat, cfg, "W8A8_SMOOTHQUANT", W8A8_SMOOTHQUANT)
    emit({"phase": "sim_model", "card": card, **rec})
    t0 = time.perf_counter()
    res, used = sim_vs_packed(smoothed, sim8, cfg, dev)
    torch.cuda.empty_cache()
    emit({"phase": "sim_vs_packed", "card": card, **res, "seconds": time.perf_counter() - t0})
    sim4, rec = sim_model(smoothed, feat, cfg, "w4a4_group(64, 0.05)", w4a4)
    emit({"phase": "sim_model", "card": card, **rec})
    t0 = time.perf_counter()
    ppl = sim_ppl((("fp", fp, None), ("w8a8_smoothquant", sim8, W8A8_SMOOTHQUANT),
                   ("w4a4_g64_5pct", sim4, w4a4)), cfg, dev)
    emit({"phase": "sim_ppl", "card": card, "windows": [SIM_PPL_WINDOWS, SIM_PPL_WINDOW],
          "random_weights": "perplexity of random weights on random tokens: no measure of "
                            "quality", **ppl, "seconds": time.perf_counter() - t0})
    del sim8, sim4
    torch.cuda.empty_cache()
    return used


# ---------------------------------------------------------------- end to end


def check_kernel_variants(dev):
    """K8 and K9 against their plain versions off the main paths' shapes:
    every group layout K8 takes (pairs of 16- and 32-channel groups, an odd
    group count, 48-channel groups, two 64-channel halves of 128-channel
    groups, one group over a ragged K), f32 and bf16 scales and outputs;
    K9's grouped and single-group bodies at group sizes 16 to 128, bf16 and
    f32 (its CUDA-core body); 1, 5 and 130 rows (ragged tiles).  Tolerance:
    1e-5 of the largest output in f32 (sum order), 1e-2 in bf16 (one
    rounding).  Returns the largest relative error of each kernel."""
    import torch

    from smoothquant_tpu_torch.kernels import int_group_matmul as k8
    from smoothquant_tpu_torch.kernels import quant_matmul as k9

    gen = torch.Generator(device=dev).manual_seed(SEED + 41)
    o, k_s = 200, 128

    def rnd(*shape, lo=-1.0, hi=1.0):
        return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo

    def codes(*shape, q=7):
        return torch.randint(-q, q + 1, shape, generator=gen, device=dev, dtype=torch.int8)

    worst = {"int_group_matmul": 0.0, "dual_path_matmul": 0.0}
    for gs, k in ((16, 16 * 9), (32, 32 * 6), (48, 48 * 4), (64, 64 * 5), (128, 128 * 3),
                  (1100, 1100)):
        g = k // gs
        for n in (1, 5, 130):
            for s_dt, out_dt in ((torch.float32, torch.float32),
                                 (torch.bfloat16, torch.bfloat16)):
                for sal in (k_s, 0):
                    args = (codes(n, k), rnd(n, g, lo=0.01, hi=0.2), codes(k, o),
                            rnd(g, o, lo=0.01, hi=0.2).to(s_dt), rnd(n, sal).to(out_dt),
                            rnd(sal, o).to(out_dt))
                    kw = dict(group_size=gs, out_dtype=out_dt)
                    got = k8.int_group_matmul(*args, **kw)
                    ref = k8.int_group_matmul_plain(*args, **kw)
                    tol = 1e-5 if out_dt == torch.float32 else 1e-2
                    err = _close(f"K8 gs={gs} k={k} n={n} {out_dt} sal={sal}", got, ref, tol)
                    worst["int_group_matmul"] = max(worst["int_group_matmul"],
                                                    err / ref.float().abs().max().item())
    for gs, k in ((16, 16 * 8), (32, 32 * 6), (128, 128 * 3), (None, 1000)):
        for n in (1, 5, 130):
            for dt in (torch.float32, torch.bfloat16):
                for sal in (k_s, 0):
                    g = 1 if gs is None else k // gs
                    w = codes(k, o, q=7 if gs else 127)
                    args = (rnd(n, k).to(dt), rnd(n, sal).to(dt), w,
                            rnd(g, o, lo=0.001, hi=0.05), rnd(sal, o).to(dt))
                    kw = dict(group_size=gs or k, out_dtype=dt)
                    got = k9.dual_path_matmul(*args, **kw)
                    ref = k9.dual_path_matmul_plain(*args, **kw)
                    tol = 1e-5 if dt == torch.float32 else 1e-2
                    err = _close(f"K9 gs={gs} k={k} n={n} {dt} sal={sal}", got, ref, tol)
                    worst["dual_path_matmul"] = max(worst["dual_path_matmul"],
                                                    err / ref.float().abs().max().item())
    torch.cuda.synchronize()
    return worst


def check_wg_edges(dev):
    """The wgmma bodies of K6 and K9 (and the bodies their shape rules still
    send shapes to) against their plain versions at the edges: 1, 65 and 333
    rows (ragged row tiles), O a multiple of the 128-column tile, O = 336
    (a ragged column tile, whole 16-byte weight rows: TMA) and O = 200 (K6:
    the tiles body; K9: the weight rows by cp.async), group sizes 32 and 64
    (K6; 48, the tiles body) and 2 (the most scale rows a stage holds), 32,
    64 and one group (K9), with and without a salient block (40 columns,
    padded to a stage, or 128), f32 and bf16 scales; bf16 outputs (the
    wgmma bodies) and f32 ones (K6's tiles, K9's CUDA-core body).
    Tolerance: 1e-2 of the largest output in bf16 (one rounding), 1e-5 in
    f32 (sum order).  Returns the largest relative error of each (kernel,
    body)."""
    import torch

    from smoothquant_tpu_torch.kernels import int4_group_matmul as k6
    from smoothquant_tpu_torch.kernels import quant_matmul as k9

    gen = torch.Generator(device=dev).manual_seed(SEED + 43)

    def rnd(*shape, lo=-1.0, hi=1.0):
        return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo

    def codes(*shape, q=7):
        return torch.randint(-q, q + 1, shape, generator=gen, device=dev, dtype=torch.int8)

    worst = {}

    def hold(name, kernel, body, got, ref, dt):
        tol = 1e-5 if dt == torch.float32 else 1e-2
        err = _close(name, got, ref, tol)
        key = f"{kernel}/{body}"
        worst[key] = max(worst.get(key, 0.0), err / ref.float().abs().max().item())

    for n in (1, 65, 333):
        for gs, kk, o in ((64, 512, 384), (32, 768, 336), (64, 512, 200), (48, 384, 128)):
            for k_s in (0, 40, 128):
                for s_dt in (torch.float32, torch.bfloat16):
                    for dt in (torch.bfloat16, torch.float32):
                        args = (codes(n, kk), rnd(n, kk // gs, lo=0.01, hi=0.2),
                                torch.randint(-128, 128, (kk // 2, o), generator=gen,
                                              device=dev, dtype=torch.int8),
                                rnd(kk // gs, o, lo=0.01, hi=0.2).to(s_dt), rnd(n, k_s).to(dt),
                                rnd(k_s, o).to(dt))
                        got = k6.int4_group_matmul(*args, group_size=gs)
                        ref = k6.int4_group_matmul_plain(*args, group_size=gs)
                        hold(f"K6 n={n} gs={gs} o={o} k_s={k_s} {s_dt} {dt}",
                             "int4_group_matmul", k6.gmm_body(o, gs, dt), got, ref, dt)
        for gs, k, o in ((64, 384, 384), (32, 256, 336), (None, 1000, 384), (64, 384, 200),
                         (2, 322, 384)):
            for k_s in (0, 128):
                for s_dt in (torch.float32, torch.bfloat16):
                    for dt in (torch.bfloat16, torch.float32):
                        g = 1 if gs is None else k // gs
                        args = (rnd(n, k).to(dt), rnd(n, k_s).to(dt),
                                codes(k, o, q=7 if gs else 127),
                                rnd(g, o, lo=0.001, hi=0.05).to(s_dt), rnd(k_s, o).to(dt))
                        kw = dict(group_size=gs or k, out_dtype=dt)
                        got = k9.dual_path_matmul(*args, **kw)
                        ref = k9.dual_path_matmul_plain(*args, **kw)
                        body = k9.dual_path_body(dt)
                        if body == "wgmma" and o % 16:
                            body = "wgmma, weight by cp.async"
                        hold(f"K9 n={n} gs={gs} o={o} k_s={k_s} {s_dt} {dt}",
                             "dual_path_matmul", body, got, ref, dt)
    torch.cuda.synchronize()
    return worst


def check_stream_edges(dev):
    """The stream body K8 and K5 share (and the tiles body where their shape
    rules send a shape) against the plain versions at the edges: 1, 4, 7
    (a ragged n8 tile), 33 and 64 rows; O a multiple of the 128-column tile,
    O = 336 (a ragged tile, whole 16-byte weight rows) and O = 200 (the
    tiles body); group sizes 16, 32, 64 and 128 (K8) and 16, 32 and 64 (K5,
    both input layouts); f32 and bf16 scales; f32 and bf16 outputs; with a
    40-column salient block and without.  Tolerance: 1e-5 of the largest
    output in f32 (sum order), 1e-2 in bf16 (one rounding).  Every stream
    call is made twice and must give the same bits (the split's reduce is
    in a fixed order).  Returns the largest relative error of each (kernel,
    body) and the number of repeated calls."""
    import torch

    from smoothquant_tpu_torch.kernels import int4_group_matmul as k5
    from smoothquant_tpu_torch.kernels import int_group_matmul as k8
    from smoothquant_tpu_torch.kernels.act_prep import quantize_acts_grouped_t

    gen = torch.Generator(device=dev).manual_seed(SEED + 45)

    def rnd(*shape, lo=-1.0, hi=1.0):
        return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo

    def codes(*shape, q=7):
        return torch.randint(-q, q + 1, shape, generator=gen, device=dev, dtype=torch.int8)

    worst, repeats = {}, 0

    def hold(name, kernel, body, fn, ref, dt):
        nonlocal repeats
        got = fn()
        if body == "stream":
            again = fn()
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"{name}: two calls gave different bits")
            repeats += 1
        tol = 1e-5 if dt == torch.float32 else 1e-2
        err = _close(name, got, ref, tol)
        key = f"{kernel}/{body}"
        worst[key] = max(worst.get(key, 0.0), err / ref.float().abs().max().item())

    dtypes = ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
              (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32))
    for n in (1, 4, 7, 33, 64):
        for gs, kk, o in ((16, 144, 384), (32, 192, 336), (64, 320, 384), (128, 384, 256),
                          (64, 320, 200)):
            for k_s in (0, 40):
                for s_dt, dt in dtypes:
                    args = (codes(n, kk, q=127), rnd(n, kk // gs, lo=0.01, hi=0.2),
                            codes(kk, o, q=127), rnd(kk // gs, o, lo=0.01, hi=0.2).to(s_dt),
                            rnd(n, k_s).to(dt), rnd(k_s, o).to(dt))
                    kw = dict(group_size=gs, out_dtype=dt)
                    hold(f"K8 n={n} gs={gs} o={o} k_s={k_s} {s_dt} {dt}", "int_group_matmul",
                         k8.int_gmm_body(n, o, kk, gs), lambda: k8.int_group_matmul(*args, **kw),
                         k8.int_group_matmul_plain(*args, **kw), dt)
        for gs, kk, o in ((16, 256, 384), (32, 512, 336), (64, 512, 384), (64, 512, 200)):
            for k_s in (0, 40):
                for s_dt, dt in dtypes:
                    for pre in (False, True):
                        w = (torch.randint(-128, 128, (2, kk // 2, o), generator=gen, device=dev,
                                           dtype=torch.int8),
                             rnd(2, kk // gs, o, lo=0.01, hi=0.2).to(s_dt))
                        if pre:
                            xq, xs = quantize_acts_grouped_t(rnd(n, kk), group_size=gs,
                                                             act_bits=4)
                        else:
                            xq, xs = codes(n, kk, q=8), rnd(n, kk // gs, lo=0.01, hi=0.2)
                        args = (1, xq, xs, *w, rnd(n, k_s).to(dt), rnd(2, k_s, o).to(dt))
                        kw = dict(group_size=gs, out_dtype=dt, pre_laid=n if pre else None)
                        hold(f"K5 n={n} gs={gs} o={o} k_s={k_s} pre={pre} {s_dt} {dt}",
                             "int4_group_matmul_stacked", k5.stacked_body(n, o, gs),
                             lambda: k5.int4_group_matmul_stacked(*args, **kw),
                             k5.int4_group_matmul_stacked_plain(*args, **kw), dt)
    torch.cuda.synchronize()
    return {"max_rel_err": worst, "repeated_calls_identical": repeats}


def check_k13_edges(dev):
    """K13's bodies against the plain version at the stream body's edges: 1
    to 8 rows (every padding of the n8 tile), O a multiple of the
    128-column tile and ragged (200, 136: 8-column runs), K a multiple of
    the 64-row stage and ragged (200, 72), split over 1 to 8 ranks as the
    planner picks; bf16 (the stream body: one bf16 rounding of f32 sums
    taken in another order, 1e-2 of the largest output) and f32 (the __ldg
    body, 1e-5).  Every call is made twice and must give the same bits.
    Returns the largest relative error of each body, the cases and the
    repeated calls."""
    import torch

    from smoothquant_tpu_torch.kernels import fp_matmul as k13

    gen = torch.Generator(device=dev).manual_seed(SEED + 61)
    worst, cases, repeats = {}, 0, 0
    for n in (1, 2, 3, 4, 5, 7, 8):
        for kk, o in ((256, 384), (200, 200), (4096, 1024), (72, 136), (1024, 4096)):
            for dt in (torch.bfloat16, torch.float32):
                x = (torch.rand((n, kk), generator=gen, device=dev) * 2 - 1).to(dt)
                w = (torch.rand((2, kk, o), generator=gen, device=dev) * 2 - 1).to(dt)
                body = k13.fp_body(n, kk, o, dt)
                got = _launched(k13.LAUNCH_KEYS[body], lambda: k13.fp_matmul_stacked(1, x, w))
                again = k13.fp_matmul_stacked(1, x, w)
                ref = k13.fp_matmul_stacked_plain(1, x, w)
                torch.cuda.synchronize()
                if not torch.equal(got, again):
                    raise AssertionError(f"K13 n={n} K={kk} O={o} {dt}: two calls gave "
                                         "different bits")
                repeats += 1
                err = _close(f"K13 n={n} K={kk} O={o} {dt}", got, ref,
                             1e-2 if dt == torch.bfloat16 else 1e-5)
                worst[body] = max(worst.get(body, 0.0), err / ref.float().abs().max().item())
                cases += 1
    return {"max_rel_err": worst, "cases": cases, "repeated_calls_identical": repeats}


# K1's edge shapes: (group size, C, salient channels, K of the nibbles, k_s)
K1_EDGE_SHAPES = ((64, 1000, 40, 1024, 48),   # tail split, the channels past k_ns_raw masked
                  (32, 520, 8, 512, 8),       # one salient stage, no masked channel
                  (16, 256, 0, 256, 0))       # no salient block


def check_k1_edges(dev):
    """K1's bodies against the plain version at the stream body's edges: 1
    to 32 rows (1, 3, 4, 8, 9, 16, 17, 32: every n8 padding of one, two and
    four tiles), O a multiple of the 128-column tile (384) and ragged (336;
    200, which the dp4a body takes), every mode — "rms" (fused RMSNorm, the
    tail salient split, the channels past k_ns_raw masked), "raw" (no norm),
    "mask" (0/1 mask, external x_sal) — with bf16 and f32 group scales over
    K1_EDGE_SHAPES (group sizes 64, 32, 16; with salient channels and
    without); bf16 x (1e-2 of the largest output: one bf16 rounding of sums
    in another order) and, at 4 rows, f32 x (the dp4a body, 1e-5).  Every
    stream call is made twice (bit for bit) and held bit for bit to K5's
    stream body on rawx_quantize_plain's codes, scales and salient
    activations wherever the two split alike: the codes and scales the
    stream body makes in shared memory are the plain version's exactly.
    Returns the largest relative error of each body, the cases, the
    repeated calls and the calls held to K5."""
    import torch

    from smoothquant_tpu_torch.kernels import int4_group_matmul as k1
    from smoothquant_tpu_torch.kernels import stream_gmm

    gen = torch.Generator(device=dev).manual_seed(SEED + 67)
    worst, cases, repeats, held = {}, 0, 0, 0
    for n in (1, 3, 4, 8, 9, 16, 17, 32):
        for gs, c, n_sal, kk, k_s in K1_EDGE_SHAPES:
            for o in (384, 336, 200):
                for mode in ("rms", "raw", "mask"):
                    for s_dt in (torch.bfloat16, torch.float32):
                        for dt in ((torch.bfloat16, torch.float32) if n == 4 else
                                   (torch.bfloat16,)):
                            x = (torch.randn((n, c), generator=gen, device=dev) * 2).to(dt)
                            x[:, 3] *= 20.0
                            w = (torch.randint(-128, 128, (2, kk // 2, o), generator=gen,
                                               device=dev, dtype=torch.int8),
                                 (torch.rand((2, kk // gs, o), generator=gen, device=dev)
                                  * 0.2 + 0.01).to(s_dt),
                                 (torch.rand((2, k_s, o), generator=gen, device=dev)
                                  * 2 - 1).to(dt))
                            norm, x_sal = None, None
                            if mode == "rms":
                                norm = (torch.rand((2, c), generator=gen, device=dev)
                                        + 0.5).to(torch.bfloat16).float()
                            elif mode == "mask":
                                norm = (torch.rand((2, c), generator=gen, device=dev)
                                        > 0.1).float()
                                x_sal = (torch.randn((n, k_s), generator=gen, device=dev)
                                         ).to(dt)
                            kw = dict(group_size=gs, act_bits=4, num_salient=n_sal, eps=1e-5,
                                      norm_kind=None if mode == "raw" else mode)
                            args = (1, x, norm, *w, x_sal)
                            body = k1.rawx_body(n, c, o, kk, gs, k_s, dt)
                            name = f"K1 n={n} gs={gs} o={o} {mode} {s_dt} {dt}"
                            got = _launched(k1.RAWX_LAUNCH_KEYS[body],
                                            lambda: k1.int4_group_matmul_stacked_rawx(*args, **kw))
                            ref = k1.rawx_plain(*args, **kw)
                            torch.cuda.synchronize()
                            err = _close(name, got, ref, 1e-2 if dt == torch.bfloat16 else 1e-5)
                            worst[body] = max(worst.get(body, 0.0),
                                              err / ref.float().abs().max().item())
                            cases += 1
                            if body != "stream":
                                continue
                            again = k1.int4_group_matmul_stacked_rawx(*args, **kw)
                            torch.cuda.synchronize()
                            if not torch.equal(got, again):
                                raise AssertionError(f"{name}: two calls gave different bits")
                            repeats += 1
                            stages = stream_gmm.k5_stages(kk, gs, k_s, True)
                            if (stream_gmm.k1_split(o, stages, n, gs, -(-k_s // 32))
                                    != stream_gmm.split(o, stages)):
                                continue
                            x_q, x_s, xs = k1.rawx_quantize_plain(
                                x, None if norm is None else norm[1], x_sal, kk=kk, k_s=k_s,
                                group_size=gs, act_bits=4, num_salient=n_sal, eps=1e-5,
                                norm_kind=kw["norm_kind"], sal_dtype=dt)
                            k5 = k1.int4_group_matmul_stacked(
                                1, x_q, x_s, *w[:2], xs.to(dt), w[2], group_size=gs,
                                out_dtype=dt, body="stream")
                            torch.cuda.synchronize()
                            if not torch.equal(got, k5):
                                d = (got.float() - k5.float()).abs().max().item()
                                raise AssertionError(f"{name}: differs from K5's stream body on "
                                                     f"the plain codes by up to {d}")
                            held += 1
    return {"max_rel_err": worst, "cases": cases, "repeated_calls_identical": repeats,
            "held_to_k5_bitwise": held}


# K14's edges: (group size, C, inter, n_sal1, k_s1, kk1, n_sal2, k_s2, kk2, O1,
# O2) — salient blocks on both linears (down's pad channels masked, its
# last tile covering zero groups past inter), none, an intermediate width
# that is no multiple of 64 (the last tile's gate half runs into up's
# columns; kk2 past inter), O1 padded past 2·inter and a ragged O2
K14_EDGE_SHAPES = ((64, 512, 704, 26, 32, 512, 35, 40, 768, 1536, 512),
                   (64, 512, 704, 0, 0, 512, 0, 0, 768, 1408, 336),
                   (32, 256, 208, 13, 16, 256, 10, 16, 256, 416, 256),
                   (16, 256, 192, 0, 0, 256, 10, 16, 192, 384, 256))
# shapes that stay on the cooperative body: group size 128, O2 % 16 != 0,
# an intermediate width that is no multiple of 16
K14_COOP_SHAPES = ((128, 512, 768, 0, 0, 512, 0, 0, 768, 1536, 512),
                   (64, 512, 704, 0, 0, 512, 0, 0, 768, 1408, 200),
                   (32, 256, 200, 13, 16, 256, 10, 16, 192, 400, 256))


def _k14_operands(shape, n, s_dt, dt, norm, gen, dev):
    """Random stacked packs (2 layers) of a K14_EDGE_SHAPES shape, x (N, C)
    in dt, the norm row or None, and the wrapper's keywords."""
    import torch

    gs, c, inter, n_sal1, k_s1, kk1, n_sal2, k_s2, kk2, o1, o2 = shape
    pack = lambda kk, k_s, o: (
        torch.randint(-128, 128, (2, kk // 2, o), generator=gen, device=dev, dtype=torch.int8),
        (torch.rand((2, kk // gs, o), generator=gen, device=dev) * 0.05 + 0.005).to(s_dt),
        (torch.rand((2, k_s, o), generator=gen, device=dev) * 0.2 - 0.1).to(dt))
    x = (torch.randn((n, c), generator=gen, device=dev) * 2).to(dt)
    x[:, 3] *= 20.0
    nw = (torch.rand(c, generator=gen, device=dev) + 0.5).to(torch.bfloat16).float() \
        if norm else None
    kw = dict(group_size=gs, act_bits=4, n_sal1=n_sal1, n_sal2=n_sal2, gu_out_true=2 * inter,
              dn_out_true=o2, eps=1e-5 if norm else 0.0)
    return (1, x, nw, *pack(kk1, k_s1, o1), *pack(kk2, k_s2, o2)), kw


def check_k14_edges(dev):
    """K14's bodies against the plain version at their edges: the stream
    body over K14_EDGE_SHAPES at 1, 3, 4, 5 and 8 rows (one n8 tile, ragged),
    the RMSNorm on and off, f32 and bf16 group scales, bf16 x; the
    cooperative body at K14_COOP_SHAPES and on f32 x, which its rule keeps
    there (an intermediate width of 200 among them: the stream body's up
    boxes would start off a 16-byte boundary, which TMA does not take).  Every output within 1e-2 of the largest magnitude of the plain
    version's (K1's bound: two int4 group matmuls whose per-token codes may
    move at a rounding edge when f32 sums run in another order); every
    stream call made twice for identical bits.  Returns the largest
    relative error of each body and the cases."""
    import torch

    from smoothquant_tpu_torch.kernels import mlp_fused as k14

    gen = torch.Generator(device=dev).manual_seed(SEED + 71)
    worst, cases, repeats = {}, {}, 0
    plan = ([(shape, n, norm, s_dt, torch.bfloat16) for shape in K14_EDGE_SHAPES
             for n in (1, 3, 4, 5, 8) for norm in (True, False)
             for s_dt in (torch.float32, torch.bfloat16)]
            + [(shape, 4, True, torch.bfloat16, torch.bfloat16) for shape in K14_COOP_SHAPES]
            + [(K14_EDGE_SHAPES[0], 4, True, torch.float32, torch.float32),
               (K14_EDGE_SHAPES[2], 8, False, torch.float32, torch.float32)])
    for shape, n, norm, s_dt, dt in plan:
        args, kw = _k14_operands(shape, n, s_dt, dt, norm, gen, dev)
        gs, c, inter, _, k_s1, kk1, _, _, _, o1, o2 = shape
        body = k14.mlp_body(n, c, o1, kk1, k_s1, o2, inter, gs, dt)
        if (body == "stream") != (shape in K14_EDGE_SHAPES and dt == torch.bfloat16):
            raise AssertionError(f"K14 {shape} N={n} {dt}: the rule picked {body}")
        name = f"K14 {body} gs={gs} C={c} inter={inter} O2={o2} N={n} norm={norm} {s_dt} {dt}"
        got = _launched(k14.LAUNCH_KEYS[body][0], lambda: k14.mlp_swiglu_fused_stacked(*args, **kw))
        ref = k14.mlp_swiglu_fused_stacked_plain(*args, **kw)
        torch.cuda.synchronize()
        err = _close(name, got, ref, 1e-2)
        worst[body] = max(worst.get(body, 0.0), err / ref.float().abs().max().item())
        cases[body] = cases.get(body, 0) + 1
        if body != "stream":
            continue
        again = k14.mlp_swiglu_fused_stacked(*args, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"{name}: two calls gave different bits")
        repeats += 1
    return {"max_rel_err": worst, "cases": cases, "repeated_calls_identical": repeats}


K16_EDGE_ROWS = (1, 3, 4, 5, 64, 2048)
K16_EDGE_C = (8, 1000, 2048, 4096, 8192)


def check_k16_edges(dev):
    """K16's row body against the plain version at K16_EDGE_ROWS ×
    K16_EDGE_C (one warp a row up to eight, a single chunk, a ragged last
    chunk), f32 and bf16 x (γ and β in x's dtype), LayerNorm and RMSNorm:
    every code identical or one off in under 1e-4 of a case's codes (the
    main path's limit, _codes_close: the sums run in another order than
    torch's, so a value at a .5 edge may round the other way), the row body
    and the block body each against the same plain version.  Returns the
    cases, the codes that moved by one (row body, block body) and their
    largest share in a case."""
    import torch

    from smoothquant_tpu_torch.kernels import norm_quant as k16

    gen = torch.Generator(device=dev).manual_seed(SEED + 73)
    cases, n_diff, n_diff_block, share, share_block, codes = 0, 0, 0, 0.0, 0.0, 0
    for c in K16_EDGE_C:
        gamma = torch.rand(c, generator=gen, device=dev) + 0.5
        beta = torch.randn(c, generator=gen, device=dev) * 0.1
        for n in K16_EDGE_ROWS:
            for dt in (torch.float32, torch.bfloat16):
                x = (torch.randn((n, c), generator=gen, device=dev)
                     * (torch.rand((n, 1), generator=gen, device=dev) * 2.5 + 0.5) + 0.3).to(dt)
                g, b = gamma.to(dt), beta.to(dt)    # bf16 rows read as stored
                for rms in (False, True):
                    scale = 4.0 / 127
                    got = _launched("norm_quant", lambda: k16.norm_quant(
                        x, g, b, scale, eps=1e-5, rms=rms))
                    old = k16.norm_quant(x, g, b, scale, eps=1e-5, rms=rms, body="block")
                    ref = k16.norm_quant_plain(x, g, b, scale, eps=1e-5, rms=rms)
                    torch.cuda.synchronize()
                    name = f"K16 N={n} C={c} {dt} {'rms' if rms else 'ln'}"
                    _, nd = _codes_close(name, got, ref)
                    _, nd_old = _codes_close(f"{name} block body", old, ref)
                    cases += 1
                    n_diff += nd
                    n_diff_block += nd_old
                    share = max(share, nd / (n * c))
                    share_block = max(share_block, nd_old / (n * c))
                    codes += n * c
    return {"cases": cases, "codes": codes, "n_diff": n_diff, "n_diff_block_body": n_diff_block,
            "max_share": share, "max_share_block_body": share_block}


# K7's edges: (C, group size, k_s of a 5 % salient tail: "pack" rounds it up
# to 128 as the pack pads it, "odd" leaves it ragged) — one chunk, a C that
# is no multiple of 8, the serving widths of qkv / gate_up (4096), down
# (11008) and Bloom's dense_4h_to_h (16384), every group size
K7_EDGE_SHAPES = ((8, 16, "pack"), (100, 32, "odd"), (1000, 64, "odd"), (4096, 64, "pack"),
                  (4096, 128, "pack"), (4097, 16, "odd"), (11008, 64, "pack"),
                  (16384, 64, "pack"))
K7_EDGE_ROWS = (1, 5, 32, 64, 133, 2048)
K7_MODES = ("rms", "rms_round", "none_w", "none")   # none_w: no norm, a norm row's weights


def check_k7_edges(dev):
    """K7's row body (K7b's "rms" / "rms_round" / no norm with its weights,
    K7a's quantize with the salient split) against the plain version at
    K7_EDGE_SHAPES × K7_EDGE_ROWS (2048 rows up to C = 4096), no salient
    channels and 5 %, bf16 and f32 x and x_sal (the dtype pairs taken in
    turn), and for C = 1000 rows 1002 elements apart from an odd start (no
    16-byte loads): codes identical or one off in under 1e-4 of them
    (_codes_close), scales within one ulp, x_sal within a bf16 rounding of
    the plain version's value, every call repeated bit for bit; the groups
    body beside it where it takes the case (a norm row, group size up to
    128, not "rms_round"), held to the same plain version; then K7a at
    rounding edges (values y with y / scale on or one f32 step off a tie),
    both bodies bit for bit.  Returns the cases, the codes, the one-code
    moves of each body and their largest share in a case."""
    import torch

    from smoothquant_tpu_torch.kernels import act_prep as k7
    from smoothquant_tpu_torch.quant.core import f32_reciprocal, qmax

    gen = torch.Generator(device=dev).manual_seed(SEED + 77)
    pairs = ((torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
             (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16))
    out = {"cases": 0, "codes": 0, "n_diff": 0, "n_diff_groups_body": 0, "max_share": 0.0,
           "groups_body_cases": 0, "repeated_calls_identical": 0}
    turn = 0
    for c, gs, sal_pad in K7_EDGE_SHAPES:
        w = torch.rand(c, generator=gen, device=dev) + 0.5
        for sal in (0, max(1, c // 20)):
            k_s = 0 if not sal else (-(-sal // 128) * 128 if sal_pad == "pack" else sal + 3)
            k_ns = -(-(c - sal) // gs) * gs
            for n in K7_EDGE_ROWS:
                if n == 2048 and c > 4096:
                    continue
                for mode in K7_MODES:
                    x_dt, s_dt = pairs[turn % 4]
                    turn += 1
                    full = (torch.randn((n, c + 2), generator=gen, device=dev)
                            * (torch.rand((n, 1), generator=gen, device=dev) * 3 + 0.25)).to(x_dt)
                    x = full[:, 1:c + 1] if c == 1000 else full[:, :c].contiguous()
                    kw = dict(group_size=gs, act_bits=4, k_ns=k_ns, num_salient=sal, k_s=k_s,
                              sal_dtype=s_dt)
                    nw = None if mode == "none" else w
                    norm = dict(eps=1e-5, norm_kind=mode if mode.startswith("rms") else None)
                    if nw is None:
                        key = "quantize_acts_grouped_t"
                        call = lambda body="rows": k7.quantize_acts_split_t(x, **kw)
                    else:
                        key = "norm_quantize_acts_t"
                        call = lambda body="rows": k7.norm_quantize_acts_t(x, nw, **kw, **norm,
                                                                          body=body)
                    got = _launched(key, call)
                    again = call()
                    ref = k7.norm_quantize_acts_t_plain(x, nw, **kw, **(norm if nw is not None
                                                                         else {"norm_kind": None}))
                    torch.cuda.synchronize()
                    name = f"K7 N={n} C={c} gs={gs} sal={sal} {mode} {x_dt} {s_dt}"
                    if not all(torch.equal(a, b) for a, b in zip(got, again)):
                        raise AssertionError(f"{name}: two calls gave different bits")
                    _, nd = _codes_close(name, got[0], ref[0])
                    _scale_ulps(name, got[1], ref[1])
                    sal_d = (got[2].float() - ref[2].float()).abs()
                    if not bool((sal_d <= ref[2].float().abs() * 2.0 ** -8 + 1e-30).all()):
                        raise AssertionError(f"{name}: x_sal off by {sal_d.max().item()}")
                    out["cases"] += 1
                    out["repeated_calls_identical"] += 1
                    out["codes"] += got[0].numel()
                    out["n_diff"] += nd
                    out["max_share"] = max(out["max_share"], nd / got[0].numel())
                    if mode == "none":   # K7a's own entry on x_ns, both bodies
                        x_ns = torch.nn.functional.pad(x[:, :c - sal], (0, k_ns - c + sal))
                        qa = dict(group_size=gs, act_bits=4)
                        ref_a = k7.quantize_acts_grouped_t_plain(x_ns, **qa)
                        bodies = ("rows", "groups") if gs <= 128 else ("rows",)
                        for body in bodies:
                            got_a = _launched(k7.LAUNCH_KEYS["quantize_acts_grouped_t"][body],
                                              lambda: k7.quantize_acts_grouped_t(
                                                  x_ns, **qa, body=body))
                            torch.cuda.synchronize()
                            _, nd_a = _codes_close(f"{name} K7a {body}", got_a[0], ref_a[0])
                            _scale_ulps(f"{name} K7a {body}", got_a[1], ref_a[1])
                            out["n_diff" if body == "rows" else "n_diff_groups_body"] += nd_a
                        out["groups_body_cases"] += len(bodies) - 1
                    if nw is not None and gs <= 128 and mode != "rms_round":
                        old = _launched("norm_quantize_acts_t_groups", lambda: call("groups"))
                        torch.cuda.synchronize()
                        _, nd_old = _codes_close(f"{name} groups body", old[0], ref[0])
                        _scale_ulps(f"{name} groups body", old[1], ref[1])
                        out["n_diff_groups_body"] += nd_old
                        out["groups_body_cases"] += 1
    # rounding edges: f32 rows whose values are (k + 0.5)·scale of their
    # group, or its f32 neighbours, so y / scale lands on or next to a tie:
    # K7a's codes identical to the plain version's true division, both bodies
    n, g, gs = 256, 64, 64
    amax = torch.rand((n, g, 1), generator=gen, device=dev) * 10 + 0.01
    scale = amax * f32_reciprocal(qmax(4))
    k = torch.randint(-7, 7, (n, g, gs), generator=gen, device=dev).float() + 0.5
    x = k * scale
    for step in (-1, 1):
        pick = torch.rand((n, g, gs), generator=gen, device=dev) < 0.3
        x = torch.where(pick, torch.nextafter(x, x + step), x)
    x[:, :, 0] = amax[:, :, 0]
    x = x.reshape(n, g * gs)
    ref = k7.quantize_acts_grouped_t_plain(x, group_size=gs, act_bits=4)
    for body in ("rows", "groups"):
        got = k7.quantize_acts_grouped_t(x, group_size=gs, act_bits=4, body=body)
        torch.cuda.synchronize()
        if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
            raise AssertionError(f"K7a {body} body at rounding edges: "
                                 f"{int((got[0] != ref[0]).sum())} codes differ")
    out["tie_codes_identical"] = x.numel()
    return out


def check_k11_edges(dev):
    """K11's split body against the plain version at its edges: S = 128, 640
    (five 128-wide softmax tiles) and 1024 (two of 512); D = 64 and 128; GQA
    rep 1, 2, 4 and 8; bf16 and int8 caches; ALiBi on and off (MHA); in
    every call a slot over the whole cache, a fully masked slot, a slot
    with one valid position and one whose valid positions all lie in the
    last tile; every cluster size the planner can pick (1, 2, 4, 8 ranks
    where S chunks into them).  Tolerance 1e-2 of the largest output (as
    the K11 phases).  Every call is made twice for identical bits, and one
    (Llama's shape, int8, 8 ranks) 400 times.  Then the query rows above 8
    a kv head (rep 9, 16 and Falcon-7B's 71: groups of 8 rows) and OPT's
    sm_scale 1.0 beside the default, over S = 640: the split body in every
    cluster size and the flash body (bf16 queries forced onto it, and f32
    queries, D = 256 at rep 12).  Returns the largest relative error, the
    cases and the repeated calls (rep 1-8), and the same of the any-rep
    cases."""
    import torch

    from smoothquant_tpu_torch.kernels import decode_attention as k11
    from smoothquant_tpu_torch.models import bloom
    from smoothquant_tpu_torch.models.common import decode_bias

    gen = torch.Generator(device=dev).manual_seed(SEED + 46)
    worst, n_cases, repeats = 0.0, 0, 0
    for s in (128, 640, 1024):
        bias = decode_bias(torch.tensor([s - 1, 0, 0, s - 1], device=dev), 4, s, None)
        bias[1] = -1e30                              # a fully masked slot
        bias[3, : s - 20] = -1e30                    # valid only in the last tile
        for d in (64, 128):
            for rep, alibi in ((1, False), (1, True), (2, False), (4, False), (8, False)):
                n_kv = 2 if rep == 8 else 4
                h = n_kv * rep
                q = torch.randn((4, h, d), generator=gen, device=dev).to(torch.bfloat16)
                slopes = (torch.as_tensor(bloom.alibi_slopes(h), device=dev) if alibi
                          else None)
                for kind in ("bf16", "int8"):
                    shape = (1, 4, n_kv, s, d)
                    if kind == "int8":
                        kv = [torch.randint(-127, 128, shape, generator=gen, device=dev,
                                            dtype=torch.int8) for _ in range(2)]
                        kv += [torch.rand(shape[:4], generator=gen, device=dev) * 0.02 + 0.005
                               for _ in range(2)]
                    else:
                        kv = [torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
                              for _ in range(2)] + [None, None]
                    args = (0, q, *kv[:2], bias, *kv[2:], slopes)
                    ref = k11.decode_attention_stacked_plain(*args)
                    for c in k11.SPLITS:
                        if not k11._split_fits(s, c):
                            continue
                        name = f"K11 edge S={s} D={d} rep={rep} alibi={alibi} {kind} ranks={c}"
                        got = k11.decode_attention_stacked(*args, split=c)
                        again = k11.decode_attention_stacked(*args, split=c)
                        torch.cuda.synchronize()
                        if not torch.equal(got, again):
                            raise AssertionError(f"{name}: two calls gave different bits")
                        if got[1].abs().max().item() != 0:
                            raise AssertionError(f"{name}: a fully masked slot is not 0")
                        err = _close(name, got, ref, 1e-2)
                        worst = max(worst, err / ref.float().abs().max().item())
                        n_cases += 1
                        repeats += 2
    b, h, d, s = MAX_BATCH, 32, 128, MAX_LEN
    shape = (1, b, h, s, d)
    kv = [torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
          for _ in range(2)]
    kv += [torch.rand(shape[:4], generator=gen, device=dev) * 0.02 + 0.005 for _ in range(2)]
    q = torch.randn((b, h, d), generator=gen, device=dev).to(torch.bfloat16)
    bias = decode_bias(torch.tensor([100, 300, s - 1, 50], device=dev), b, s, None)
    args = (0, q, *kv[:2], bias, *kv[2:])
    first = k11.decode_attention_stacked(*args, split=8)
    for _ in range(399):
        if not torch.equal(k11.decode_attention_stacked(*args, split=8), first):
            raise AssertionError("K11 split body: 400 calls did not give identical bits")
    repeats += 400
    s = 640
    bias = decode_bias(torch.tensor([s - 1, 0, 0, s - 1], device=dev), 4, s, None)
    bias[1] = -1e30
    bias[3, : s - 20] = -1e30
    any_worst, any_cases = 0.0, 0
    for rep, n_kv, d in ((9, 2, 64), (16, 1, 128), (71, 1, 64), (12, 1, 256)):
        for kind in ("bf16", "int8"):
            shape = (1, 4, n_kv, s, d)
            if kind == "int8":
                kv = [torch.randint(-127, 128, shape, generator=gen, device=dev,
                                    dtype=torch.int8) for _ in range(2)]
                kv += [torch.rand(shape[:4], generator=gen, device=dev) * 0.02 + 0.005
                       for _ in range(2)]
            else:
                kv = [torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
                      for _ in range(2)] + [None, None]
            for q_dt in (torch.bfloat16, torch.float32):
                q = torch.randn((4, n_kv * rep, d), generator=gen, device=dev).to(q_dt)
                if kind == "bf16" and q_dt == torch.float32:
                    continue                         # an fp cache holds q's dtype
                for scale in (None, 1.0):
                    args = (0, q, *kv[:2], bias, *kv[2:])
                    ref = k11.decode_attention_stacked_plain(*args, sm_scale=scale)
                    forced = [dict(body="flash")]
                    if q_dt == torch.bfloat16 and d in k11.SPLIT_DIMS:
                        forced += [dict(split=c) for c in k11.SPLITS if k11._split_fits(s, c)]
                    for kw in forced:
                        name = (f"K11 edge rep={rep} D={d} {kind} q={q_dt} scale={scale} "
                                f"{kw}")
                        got = k11.decode_attention_stacked(*args, sm_scale=scale, **kw)
                        again = k11.decode_attention_stacked(*args, sm_scale=scale, **kw)
                        torch.cuda.synchronize()
                        if not torch.equal(got, again):
                            raise AssertionError(f"{name}: two calls gave different bits")
                        if got[1].abs().max().item() != 0:
                            raise AssertionError(f"{name}: a fully masked slot is not 0")
                        err = _close(name, got, ref, 1e-2)
                        any_worst = max(any_worst, err / ref.float().abs().max().item())
                        any_cases += 1
    return {"max_rel_err": worst, "cases": n_cases, "repeated_calls_identical": repeats,
            "any_rep_max_rel_err": any_worst, "any_rep_cases": any_cases}


def check_k3_edges(dev):
    """K3's split body against the plain version at its edges: S = 128, 640
    (five 128-wide softmax tiles) and 1024 (two of 512); D = 64 and 128; GQA
    rep 1, 2, 4 and 8; in every call a slot over the whole cache with
    random holes, a fully masked slot, a slot with one valid position and
    one whose valid positions all lie in the last tile; every cluster size
    that chunks S.  Tolerance 1e-2 of the largest output (as the K3 phase).
    Every call is made twice for identical bits, and one (Llama's shape, B =
    4 over MAX_LEN, 4 ranks) 400 times.  Returns the largest relative error,
    the cases and the repeated calls."""
    import torch

    from smoothquant_tpu_torch.kernels import attn_smajor as ka
    from smoothquant_tpu_torch.kernels import decode_attention as k11
    from smoothquant_tpu_torch.models.common import decode_bias

    gen = torch.Generator(device=dev).manual_seed(SEED + 47)

    def cache(b, s, n_kv, d):
        shape = (1, b, s, n_kv * d)
        kv = [torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
              for _ in range(2)]
        return kv + [torch.rand((1, b, n_kv, s), generator=gen, device=dev) * 0.02 + 0.005
                     for _ in range(2)]

    worst, n_cases, repeats = 0.0, 0, 0
    for s in (128, 640, 1024):
        bias = decode_bias(torch.tensor([s - 1, 0, 0, s - 1], device=dev), 4, s, None)
        bias[0, torch.rand(s, generator=gen, device=dev) < 0.2] = -1e30   # holes
        bias[1] = -1e30                              # a fully masked slot
        bias[3, : s - 20] = -1e30                    # valid only in the last tile
        for d in (64, 128):
            for rep in (1, 2, 4, 8):
                n_kv = 2 if rep == 8 else 4
                q = torch.randn((4, n_kv * rep, d), generator=gen, device=dev).to(torch.bfloat16)
                kq, vq, ks, vs = cache(4, s, n_kv, d)
                args = (0, q, kq, vq, bias, ks, vs)
                ref = ka.decode_attention_smajor_plain(*args)
                for c in k11.SPLITS:
                    if not k11._split_fits(s, c):
                        continue
                    name = f"K3 edge S={s} D={d} rep={rep} ranks={c}"
                    got = ka.decode_attention_smajor_stacked(*args, split=c)
                    again = ka.decode_attention_smajor_stacked(*args, split=c)
                    torch.cuda.synchronize()
                    if not torch.equal(got, again):
                        raise AssertionError(f"{name}: two calls gave different bits")
                    if got[1].abs().max().item() != 0:
                        raise AssertionError(f"{name}: a fully masked slot is not 0")
                    err = _close(name, got, ref, 1e-2)
                    worst = max(worst, err / ref.float().abs().max().item())
                    n_cases += 1
                    repeats += 2
    kq, vq, ks, vs = cache(MAX_BATCH, MAX_LEN, 32, 128)
    q = torch.randn((MAX_BATCH, 32, 128), generator=gen, device=dev).to(torch.bfloat16)
    bias = decode_bias(torch.tensor([100, 300, MAX_LEN - 1, 50], device=dev), MAX_BATCH,
                       MAX_LEN, None)
    args = (0, q, kq, vq, bias, ks, vs)
    first = ka.decode_attention_smajor_stacked(*args, split=4)
    for _ in range(399):
        if not torch.equal(ka.decode_attention_smajor_stacked(*args, split=4), first):
            raise AssertionError("K3 split body: 400 calls did not give identical bits")
    repeats += 400
    return {"max_rel_err": worst, "cases": n_cases, "repeated_calls_identical": repeats,
            **_k3_any_rep(dev, gen, cache)}


def _any_rep_forced(q_dtype, d, rep):
    """The bodies an any-rep edge case holds: every cluster size of the split
    body that chunks S and the flash body forced, where the split body takes
    the shape; else the flash body the rule picks."""
    from smoothquant_tpu_torch.kernels import decode_attention as k11

    s = ATTN_ANY_REP_S
    if k11.attn_body(q_dtype, d, s, rep) != "split":
        return [{}]
    return [dict(split=c) for c in k11.SPLITS if k11._split_fits(s, c)] + [dict(body="flash")]


def _any_rep_row(kernel, site, shape, err, ref, kernel_fn, plain_fn, lib_fn, cost):
    """A timed row of an any-rep case at B = 4 (out of the kernels line's
    sums): the kernel, its plain version and SDPA over the dequantized cache
    with its kv heads expanded to the query heads, 2 repetitions each."""
    from smoothquant_tpu_torch.utils import roofline

    b_ms, b_by = roofline.bound_ms(*cost)
    row = dict(kernel=kernel, site=site, in_sum=False, shape=shape, max_err=err,
               max_rel_err=err / ref.float().abs().max().item(), check_launches=1,
               kernel_ms=device_ms(kernel_fn, 8, reps=2),
               plain_ms=device_ms(plain_fn, 2, reps=2),
               bound_ms=b_ms, bound_by=b_by, library_ms=device_ms(lib_fn, 8, reps=2),
               library="scaled_dot_product_attention over the dequantized bf16 cache, kv "
                       "heads expanded to the query heads, yardstick only")
    emit(row)
    return row


def _k3_any_rep(dev, gen, cache):
    """K3 at the ATTN_ANY_REP_CASES (2 kv heads, S = 512): B = 4 with the
    edges' four slots (holes, fully masked, one position, the last tile
    only), B = 64 at random positions; every body of _any_rep_forced, each
    call twice for identical bits, within 1e-2 of the largest output; the
    B = 4 cases at D = 128 and the default scale timed (_any_rep_row)."""
    import torch
    import torch.nn.functional as F

    from smoothquant_tpu_torch.kernels import attn_smajor as ka
    from smoothquant_tpu_torch.models.common import decode_bias
    from smoothquant_tpu_torch.utils import roofline

    s, n_kv = ATTN_ANY_REP_S, ATTN_ANY_REP_KV
    worst, n_cases, repeats, rows = 0.0, 0, 0, []
    for rep, b, d, scale in ATTN_ANY_REP_CASES:
        if b == 4:
            bias = decode_bias(torch.tensor([s - 1, 0, 0, s - 1], device=dev), 4, s, None)
            bias[0, torch.rand(s, generator=gen, device=dev) < 0.2] = -1e30
            bias[1] = -1e30
            bias[3, : s - 20] = -1e30
        else:
            bias = decode_bias(torch.randint(0, s, (b,), generator=gen, device=dev), b, s, None)
        q = torch.randn((b, n_kv * rep, d), generator=gen, device=dev).to(torch.bfloat16)
        kq, vq, ks, vs = cache(b, s, n_kv, d)
        args = (0, q, kq, vq, bias, ks, vs)
        ref = ka.decode_attention_smajor_plain(*args, sm_scale=scale)
        for kw in _any_rep_forced(q.dtype, d, rep):
            name = f"K3 any-rep edge rep={rep} B={b} D={d} scale={scale} {kw}"
            got = ka.decode_attention_smajor_stacked(*args, sm_scale=scale, **kw)
            again = ka.decode_attention_smajor_stacked(*args, sm_scale=scale, **kw)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"{name}: two calls gave different bits")
            err = _close(name, got, ref, 1e-2)
            worst = max(worst, err / ref.float().abs().max().item())
            n_cases += 1
            repeats += 2
        if b == 4 and d == 128 and scale is None:
            h = n_kv * rep
            deq = [(t[0].reshape(b, s, n_kv, d).transpose(1, 2).float() * sc[0][..., None])
                   .to(torch.bfloat16).repeat_interleave(rep, dim=1)
                   for t, sc in ((kq, ks), (vq, vs))]
            valid = (bias == 0)[:, None, None, :]
            err = _close(f"K3 rep={rep} B=4", ka.decode_attention_smajor_stacked(*args), ref,
                         1e-2)
            rows.append(_any_rep_row(
                "decode_attention_smajor_stacked", f"rep{rep}@B4", [b, h, n_kv, s, d], err,
                ref, lambda i: ka.decode_attention_smajor_stacked(*args),
                lambda i: ka.decode_attention_smajor_plain(*args),
                lambda i: F.scaled_dot_product_attention(q[:, :, None], *deq,
                                                         attn_mask=valid),
                roofline.decode_attn_cost(b, h, n_kv, s, d, n_valid=int(valid.sum()))))
    return {"any_rep_max_rel_err": worst, "any_rep_cases": n_cases,
            "any_rep_repeated_calls_identical": repeats, "any_rep_rows": rows}


def check_k12_edges(dev):
    """K12's split bodies against the plain version at their edges: S = 128,
    640 and 1024; D = 64 and 128; the flat body (MHA), the stacked body at
    rep 1, 2, 4 and 8 and the write body at rep 1 and 4; pos 0 (only the
    new row), 9 (inside the first tile) and S − 1; one rotary row for every
    slot, and at S = 640 a row a slot; every cluster size that chunks S.
    Attention within 1e-2 of the largest output; the write
    body's cache identical to the plain version's.  Every call is made
    twice for identical bits, and one (Llama's flat body, B = 4 over
    MAX_LEN at DECODE_POS, 4 ranks) 400 times.  Returns the largest
    relative error, the cases and the repeated calls."""
    import torch

    from smoothquant_tpu_torch.kernels import attn_fused as k12
    from smoothquant_tpu_torch.kernels import decode_attention as k11
    from smoothquant_tpu_torch.models.common import rotary_cos_sin

    gen = torch.Generator(device=dev).manual_seed(SEED + 48)
    fns = {"flat": k12.fused_virtual_attn_flat, "stacked": k12.fused_virtual_attn_stacked,
           "write": k12.fused_rope_write_attn_stacked}

    def case(b, h, n_kv, s, d, pos, flat):
        shape = (1, b, n_kv, s, d)
        cache = [torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
                 for _ in range(2)]
        cache += [torch.rand(shape[:4], generator=gen, device=dev) * 0.02 + 0.005
                  for _ in range(2)]
        new = [torch.randn((b, n_kv, d), generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(2)]
        q = torch.randn((b, h, d), generator=gen, device=dev).to(torch.bfloat16)
        if flat:
            q = q.reshape(b, 1, h * d)
        p = torch.tensor(pos, dtype=torch.int32, device=dev)
        # one rotary row for every slot, as the aligned decode passes them;
        # at S = 640 a row a slot (the kernels' other table stride)
        rows = torch.arange(b if s == 640 else 1, device=dev).reshape(-1, 1)
        cos, sin = rotary_cos_sin(p.long() + rows, d)
        return (0, p, q, *new, cos, sin), cache

    worst, n_cases, repeats = 0.0, 0, 0
    for s in (128, 640, 1024):
        for d in (64, 128):
            for body, rep in (("flat", 1), ("stacked", 1), ("stacked", 2), ("stacked", 4),
                              ("stacked", 8), ("write", 1), ("write", 4)):
                n_kv = 2 if rep == 8 else 4
                for pos in (0, 9, s - 1):
                    head, cache = case(2, n_kv * rep, n_kv, s, d, pos, body == "flat")
                    ref_c = [t.clone() for t in cache]
                    ref = k12.fused_attn_plain(*head, *ref_c, flat=body == "flat",
                                               write_cache=body == "write")
                    for c in k11.SPLITS:
                        if not k11._split_fits(s, c):
                            continue
                        name = f"K12 edge {body} S={s} D={d} rep={rep} pos={pos} ranks={c}"
                        got_c, again_c = [t.clone() for t in cache], [t.clone() for t in cache]
                        got = fns[body](*head, *got_c, split=c)
                        again = fns[body](*head, *again_c, split=c)
                        torch.cuda.synchronize()
                        if not (torch.equal(got, again) and all(
                                torch.equal(x, y) for x, y in zip(got_c, again_c))):
                            raise AssertionError(f"{name}: two calls gave different bits")
                        if not all(torch.equal(x, y) for x, y in zip(got_c, ref_c)):
                            raise AssertionError(f"{name}: the cache differs from the plain "
                                                 "version's")
                        err = _close(name, got, ref, 1e-2)
                        worst = max(worst, err / ref.float().abs().max().item())
                        n_cases += 1
                        repeats += 2
    head, cache = case(MAX_BATCH, 32, 32, MAX_LEN, 128, DECODE_POS, True)
    first = k12.fused_virtual_attn_flat(*head, *cache, split=4)
    for _ in range(399):
        if not torch.equal(k12.fused_virtual_attn_flat(*head, *cache, split=4), first):
            raise AssertionError("K12 split body: 400 calls did not give identical bits")
    repeats += 400
    return {"max_rel_err": worst, "cases": n_cases, "repeated_calls_identical": repeats,
            **_k12_any_rep(dev, case, fns)}


def _k12_any_rep(dev, case, fns):
    """K12's stacked and write bodies at the ATTN_ANY_REP_CASES (2 kv
    heads, S = 512): B = 4 at pos 0, DECODE_POS and S − 1, B = 64 at
    DECODE_POS; every body of _any_rep_forced, each call twice for
    identical bits (attention and cache), within 1e-2 of the largest
    output; the write body's cache identical to the plain version's (one
    group writes the row, every group folds it in).  The stacked body at
    B = 4, DECODE_POS, D = 128 and the default scale is timed
    (_any_rep_row)."""
    import torch
    import torch.nn.functional as F

    from smoothquant_tpu_torch.kernels import attn_fused as k12
    from smoothquant_tpu_torch.utils import roofline

    s, n_kv = ATTN_ANY_REP_S, ATTN_ANY_REP_KV
    worst, n_cases, repeats, rows = 0.0, 0, 0, []
    for rep, b, d, scale in ATTN_ANY_REP_CASES:
        for pos in ((0, DECODE_POS, s - 1) if b == 4 else (DECODE_POS,)):
            head, cache = case(b, n_kv * rep, n_kv, s, d, pos, False)
            for body in ("stacked", "write"):
                ref_c = [t.clone() for t in cache]
                ref = k12.fused_attn_plain(*head, *ref_c, write_cache=body == "write",
                                           sm_scale=scale)
                for kw in _any_rep_forced(head[2].dtype, d, rep):
                    name = (f"K12 any-rep edge {body} rep={rep} B={b} D={d} pos={pos} "
                            f"scale={scale} {kw}")
                    got_c, again_c = [t.clone() for t in cache], [t.clone() for t in cache]
                    got = fns[body](*head, *got_c, sm_scale=scale, **kw)
                    again = fns[body](*head, *again_c, sm_scale=scale, **kw)
                    torch.cuda.synchronize()
                    if not (torch.equal(got, again) and all(
                            torch.equal(x, y) for x, y in zip(got_c, again_c))):
                        raise AssertionError(f"{name}: two calls gave different bits")
                    if not all(torch.equal(x, y) for x, y in zip(got_c, ref_c)):
                        raise AssertionError(f"{name}: the cache differs from the plain "
                                             "version's")
                    err = _close(name, got, ref, 1e-2)
                    worst = max(worst, err / ref.float().abs().max().item())
                    n_cases += 1
                    repeats += 2
            if b == 4 and d == 128 and scale is None and pos == DECODE_POS:
                h = n_kv * rep
                q = head[2]
                deq = [(qv[0].float() * sc[0][..., None]).to(torch.bfloat16)
                       .repeat_interleave(rep, dim=1)
                       for qv, sc in ((cache[0], cache[2]), (cache[1], cache[3]))]
                valid = (torch.arange(s, device=dev) < pos)[None, None, None, :]
                ref = k12.fused_attn_plain(*head, *cache)
                err = _close(f"K12 rep={rep} B=4", fns["stacked"](*head, *cache), ref, 1e-2)
                rows.append(_any_rep_row(
                    "fused_attn", f"stacked_rep{rep}@B4", [b, h, n_kv, s, d], err, ref,
                    lambda i: fns["stacked"](*head, *cache),
                    lambda i: k12.fused_attn_plain(*head, *cache),
                    lambda i: F.scaled_dot_product_attention(q[:, :, None], *deq,
                                                             attn_mask=valid),
                    roofline.fused_attn_cost(b, h, n_kv, s, d, pos)))
    return {"any_rep_max_rel_err": worst, "any_rep_cases": n_cases,
            "any_rep_repeated_calls_identical": repeats, "any_rep_rows": rows}


def check_kv_write_edges(dev):
    """The row body of K2 and K10 against their plain versions at its edges:
    both cache layouts, bf16 and f32 rows, D = 64 / 128 / 256, n_kv = 1 / 8
    / 32 with 1 and 4 query heads a kv head, B = 1, 5, 64 and 130 slots;
    per-slot positions (0, S − 1, past S, the rest random) with a table row a
    slot, and one aligned position (0, S − 1 or past S) with one shared
    row; Llama's [q | k | v] rows with q rotated, Bloom's interleaved rows
    with rotary off (no q, no tables); rows that start 16-byte aligned (the
    vector form) and one element off (the scalar form).  q's bits, codes and
    scales identical to the plain version's, the other layer untouched, and
    every call made twice for identical bits.  Returns the cases, the
    repeated calls and the launches by body."""
    import torch

    from smoothquant_tpu_torch.kernels import _build
    from smoothquant_tpu_torch.kernels import attn_smajor as ka
    from smoothquant_tpu_torch.kernels import cache_write as k10
    from smoothquant_tpu_torch.models.common import rotary_cos_sin

    gen = torch.Generator(device=dev).manual_seed(SEED + 61)
    s, n_l = 40, 2
    fns = {True: (ka.rope_q_write_cache_smajor, ka.rope_q_write_cache_smajor_plain),
           False: (k10.rope_q_write_cache_stacked, k10.rope_q_write_cache_stacked_plain)}
    before = dict(_build.LAUNCHES)
    n_cases = repeats = 0
    for smajor in (True, False):
        for dtype in (torch.bfloat16, torch.float32):
            for d in KV_EDGE_DIMS:
                for n_kv, rep in KV_EDGE_HEADS:
                    for b in KV_EDGE_SLOTS:
                        layouts = [("llama", 0, True), ("llama", 1, False)]
                        if rep == 1:
                            layouts.append(("bloom", 0, b % 2 == 0))
                        for layout, offset, per_slot in layouts:
                            rotary = layout == "llama"
                            n_q = n_kv * rep if rotary else n_kv
                            _, (q, k, v) = _qkv_parts(b, n_q, n_kv, d, dtype, gen, dev,
                                                      layout, offset)
                            if per_slot:
                                pos = torch.randint(0, s + 9, (b,), generator=gen,
                                                    device=dev, dtype=torch.int32)
                                pos[:3] = torch.tensor([0, s - 1, s + 7], device=dev)[:b]
                            else:
                                pos = torch.tensor((0, s - 1, s + 7)[n_cases % 3],
                                                   device=dev, dtype=torch.int32)
                            cos, sin = ((None, None) if not rotary else rotary_cos_sin(
                                pos.long().reshape(-1, 1), d))
                            shape = ((n_l, b, s, n_kv * d) if smajor else
                                     (n_l, b, n_kv, s, d))
                            cache = [torch.randint(-127, 128, shape, generator=gen, device=dev,
                                                   dtype=torch.int8) for _ in range(2)]
                            cache += [torch.rand((n_l, b, n_kv, s), generator=gen,
                                                 device=dev) + 0.01 for _ in range(2)]
                            got, again, ref = ([t.clone() for t in cache] for _ in range(3))
                            qa = q if rotary else None
                            fn, plain = fns[smajor]
                            name = (f"kv_write_edges {'smajor' if smajor else 'head_major'} "
                                    f"{dtype} D={d} n_kv={n_kv} rep={rep} B={b} {layout} "
                                    f"offset={offset} per_slot={per_slot}")
                            got_q = fn(1, pos, qa, k, v, cos, sin, *got, rotary=rotary)
                            again_q = fn(1, pos, qa, k, v, cos, sin, *again, rotary=rotary)
                            ref_q = plain(1, pos, qa, k, v, cos, sin, *ref, rotary=rotary)
                            torch.cuda.synchronize()
                            _same_bits(f"{name}: two calls", got, again)
                            _same_bits(f"{name}: against the plain version", got, ref)
                            if rotary:
                                _same_bits(f"{name}: two calls q", got_q, again_q)
                                _same_bits(f"{name}: q", got_q, ref_q)
                            if not torch.equal(got[0][0], cache[0][0]):
                                raise AssertionError(f"{name}: wrote outside its layer")
                            n_cases += 1
                            repeats += 2
    launched = {key: n - before.get(key, 0) for key, n in _build.LAUNCHES.items()
                if key.startswith("write_quant_cache") and n != before.get(key, 0)}
    if dev.type == "cuda" and not (launched.get("write_quant_cache_smajor_scalar")
                                   and launched.get("write_quant_cache_stacked_scalar")):
        raise AssertionError(f"kv_write_edges: no scalar-form launch ({launched})")
    return {"cases": n_cases, "repeated_calls_identical": repeats,
            "launches_by_body": launched}


# aten ops that launch no kernel: views, shapes, allocations
_NO_KERNEL_OPS = ("empty", "view", "_unsafe_view", "reshape", "slice", "select", "t",
                  "transpose", "alias", "as_strided", "expand", "detach", "unsqueeze",
                  "squeeze", "is_contiguous", "stride", "size", "sym_size", "sym_stride",
                  "sym_numel", "numel", "dim")


def check_salient_dtype(stacked, dev, gen):
    """The stacked path with the salient block stored in another dtype than
    the rows, at 8 and 64 rows (K7's row body, then K5 as its programmatic
    dependent): bf16 rows over qkv's block held in f32, and f32 rows over
    its block in bf16.  Each call's output equals, bit for bit, the same
    call over the block stored in the rows' dtype (the cast is exact
    either way), both first made queued behind ~1 ms of torch.cuda._sleep
    so K5 is launched while the prep waits and can start inside it (on an
    idle card the prep ends before the host launches K5, and a read K5
    made too early would not show: scripts/k5_pdl_race.py); and a second
    call launches the prep and K5 once each
    (their counters) and no torch op that runs a kernel (every aten op it
    dispatches, logged by a TorchDispatchMode, is a view, a shape query or
    an allocation) — the block was cast once, before the step."""
    import dataclasses

    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from smoothquant_tpu_torch.kernels import _build
    from smoothquant_tpu_torch.kernels.real_linear import real_quant_linear

    class AtenOps(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    lin = stacked["layers"]["stacked"]["self_attn"]["qkv_proj"]
    n_layers, c = lin.w_qt.shape[0], lin.meta.in_features
    norm_row = (torch.rand((n_layers, c), generator=gen, device=dev) + 0.5).to(torch.bfloat16)
    out = {}
    for rows_dt in (torch.bfloat16, torch.float32):
        other = torch.float32 if rows_dt == torch.bfloat16 else torch.bfloat16
        mixed = dataclasses.replace(lin, w_sal_t=lin.w_sal_t.to(other))
        native = dataclasses.replace(lin, w_sal_t=lin.w_sal_t.to(rows_dt))
        norm = (norm_row.to(rows_dt).float(), 1e-5, "rms")
        for n in (8, SLOT_BATCH):
            x = (torch.randn((n, c), generator=gen, device=dev) * 3).to(rows_dt)
            call = lambda p: real_quant_linear(p, x, layer_idx=1, norm=norm)
            torch.cuda.synchronize()
            torch.cuda._sleep(2_000_000)
            got, ref = call(mixed), call(native)
            torch.cuda.synchronize()
            name = f"salient block {other} under {rows_dt} rows, {n} rows"
            _same_bits(name, got, ref)
            before = dict(_build.LAUNCHES)
            with AtenOps() as mode:
                call(mixed)
            torch.cuda.synchronize()
            launched = {k: v - before.get(k, 0) for k, v in _build.LAUNCHES.items()
                        if v != before.get(k, 0)}
            kernel_ops = [op for op in mode.ops if op not in _NO_KERNEL_OPS]
            if kernel_ops or sum(launched.values()) != 2 or not any(
                    k.startswith("int4_group_matmul_stacked") for k in launched):
                raise AssertionError(f"{name}: the call ran {kernel_ops} beside the "
                                     f"launches {launched}")
            out[f"{str(rows_dt)[6:]}_rows@{n}"] = {"launches": launched,
                                                  "aten_ops": sorted(set(mode.ops))}
    return out


def check_k15b_edges(dev):
    """K15b's bodies against the plain version, bit for bit, at K = 64, 128,
    256 and 512 (and 1024 for PV): QKᵀ-shaped products (b (N, K)) at ragged
    M and N with f32 out (the qk body up to K = 256, K15a's tiles above)
    and int8 out (tiles); PV-shaped ones (b (K, N)) at ragged M and N, f32
    and int8 out (the pv body); one to eight query rows over (K, N) (the kn
    GEMV at every rank count that splits K) and over (N, K) (the nk GEMV up
    to K = 256, K15a's GEMV above).  Returns the cases per body."""
    import torch

    from smoothquant_tpu_torch.kernels import int8 as k15

    gen = torch.Generator(device=dev).manual_seed(SEED + 47)
    i8 = lambda *sh: torch.randint(-128, 128, sh, generator=gen, device=dev, dtype=torch.int8)
    bodies = {}

    def hold(a, b, b_kn, out, body=None, ranks=None):
        kw = dict(out_dtype=out, b_kn=b_kn)
        got = k15.int8_bmm(a, b, 0.0123, **kw, body=body, ranks=ranks)
        ref = k15.int8_bmm_plain(a, b, 0.0123, **kw)
        torch.cuda.synchronize()
        m, kk = a.shape[1:]
        n = b.shape[2] if b_kn else b.shape[1]
        name = body or k15.bmm_body(m, n, kk, b_kn, out)
        if not torch.equal(got, ref):
            raise AssertionError(f"K15b {name} a {tuple(a.shape)} b {tuple(b.shape)} "
                                 f"b_kn={b_kn} {out}: {int((got != ref).sum())} outputs differ")
        bodies[name] = bodies.get(name, 0) + 1

    for kk in (64, 128, 256, 512):
        for m, n in ((9, 1), (130, 77), (257, 128), (128, 300)):
            for out in (torch.float32, torch.int8):
                hold(i8(3, m, kk), i8(3, n, kk), False, out)
        for m, n in ((9, 16), (130, 64), (200, 80), (128, 128)):
            for out in (torch.float32, torch.int8):
                hold(i8(3, m, kk), i8(3, kk, n), True, out)
        for m in (1, 3, 8):
            for n in (16, 64, 80):
                for c in k15.KN_SPLITS:
                    if kk % (16 * c) == 0:
                        hold(i8(3, m, kk), i8(3, kk, n), True, torch.int8, "kn_gemv", c)
                hold(i8(3, m, kk), i8(3, kk, n), True, torch.float32)
            hold(i8(3, m, kk), i8(3, 77, kk), False, torch.float32)
    hold(i8(2, 130, 1024), i8(2, 1024, 64), True, torch.int8)
    hold(i8(2, 1, 4096), i8(2, 4096, 64), True, torch.int8)
    return bodies


# K4's wgmma body at its edges: (N, K, O) at the prefill buckets (a whole
# tile, ragged rows, several row tiles), ragged O (a part column tile), K
# of one stage, ragged K (padded to 16) and Llama-2-7B's down (86 stages)
K4_EDGE_SHAPES = ((256, 512, 264), (333, 200, 520), (800, 128, 1024), (1024, 1024, 136),
                  (333, 11008, 384))
K4_EDGE_KS = (0, 16, 208, 640)
# K15a's bodies at their edges: (N, K, O) — the stream body at 1-64 rows over
# each cluster size its split plans, the wgmma body above; K = 8192 at
# |acc| > 2^24; ragged K and O
K15A_EDGE_SHAPES = ((1, 2048, 2048), (3, 208, 77), (4, 8192, 2048), (5, 2048, 8192),
                    (7, 1024, 130), (8, 2048, 1000), (16, 512, 256), (33, 2048, 384),
                    (64, 8192, 256), (65, 200, 77), (333, 2048, 1000), (2048, 8192, 2048),
                    (800, 1024, 130))


def check_k4_edges(dev):
    """K4's wgmma body against its plain version at K4_EDGE_SHAPES × k_s of
    K4_EDGE_KS (bf16 salient operands; 0, one 16-wide stage, a ragged 208,
    down's 640) in bf16 and f32 out: bf16 within 1e-2 of the largest output
    (as the site checks), f32 within 1e-4 (the salient dot's f32 sums in
    another order, rounded by the tensor cores); each call made twice for
    identical bits.  Returns the
    worst relative error per output dtype and the cases."""
    import torch

    from smoothquant_tpu_torch.kernels import int8_prefill as k4
    from smoothquant_tpu_torch.kernels.pack import k_major

    gen = torch.Generator(device=dev).manual_seed(SEED + 53)
    worst, cases = {}, 0
    for n, kk, o in K4_EDGE_SHAPES:
        x = torch.randint(-127, 128, (n, kk), generator=gen, device=dev, dtype=torch.int8)
        w = k_major(torch.randint(-127, 128, (kk, o), generator=gen, device=dev,
                                  dtype=torch.int8))
        sx = torch.rand((n, 1), generator=gen, device=dev) * 0.02 + 1e-3
        sw = torch.rand((1, o), generator=gen, device=dev) * 0.02 + 1e-3
        for k_s in K4_EDGE_KS:
            x_sal = torch.randn((n, k_s), generator=gen, device=dev).to(torch.bfloat16)
            w_sal = (torch.randn((k_s, o), generator=gen, device=dev) * 4).to(torch.bfloat16)
            for out, rel in ((torch.bfloat16, 1e-2), (torch.float32, 1e-4)):
                args = (x, sx, w, sw, x_sal, w_sal)
                got = _launched("int8_prefill_matmul",
                                lambda: k4.int8_prefill_matmul(*args, out_dtype=out))
                again = k4.int8_prefill_matmul(*args, out_dtype=out)
                ref = k4.int8_prefill_matmul_plain(*args, out_dtype=out)
                torch.cuda.synchronize()
                name = f"K4 wg N={n} K={kk} O={o} k_s={k_s} {out}"
                err = _close(name, got, ref, rel)
                if not torch.equal(got, again):
                    raise AssertionError(f"{name}: two calls differ")
                key = str(out).replace("torch.", "")
                worst[key] = max(worst.get(key, 0.0), err / ref.float().abs().max().item())
                cases += 1
    return {"cases": cases, "max_rel_err": worst}


def check_k15a_edges(dev):
    """K15a's stream and wgmma bodies against the plain version, bit for
    bit, at K15A_EDGE_SHAPES: f32 out with and without bias, int8 out with
    bias and ReLU; the operands ±127 with x's signs repeated down w's rows,
    so that |acc| reaches 127²·K (> 2^24 from K = 1041) where f32(acc)
    rounds.  Returns the cases per body and the largest |acc|."""
    import torch

    from smoothquant_tpu_torch.kernels import int8 as k15

    gen = torch.Generator(device=dev).manual_seed(SEED + 59)
    bodies, acc_max = {}, 0
    for n, kk, o in K15A_EDGE_SHAPES:
        sign = lambda *sh: torch.randint(0, 2, sh, generator=gen, device=dev) * 2 - 1
        xs = sign(n, kk)
        x = (xs * 127).to(torch.int8)
        # row o of w: x's row o % n with its signs flipped on a random half
        # of the k, or on none (|acc| = 127²·K)
        keep = torch.rand((o, 1), generator=gen, device=dev) < 0.25
        flips = torch.where(keep, torch.ones_like(xs[:1]), sign(o, kk))
        w = (xs[torch.arange(o, device=dev) % n] * flips * 127).to(torch.int8)
        acc = torch.matmul(x.double(), w.double().t())
        acc_max = max(acc_max, int(acc.abs().max()))
        alpha = 150.0 / float(acc.abs().max())
        bias = torch.randn(o, generator=gen, device=dev) * 3
        for b, relu, out in ((None, False, torch.float32), (bias, False, torch.float32),
                             (bias, True, torch.int8)):
            kw = dict(relu=relu, out_dtype=out)
            got = _launched("int8_linear", lambda: k15.int8_linear(x, w, alpha, b, **kw))
            ref = k15.int8_linear_plain(x, w, alpha, b, **kw)
            torch.cuda.synchronize()
            name = k15.linear_body(n)
            if not torch.equal(got, ref):
                raise AssertionError(f"K15a {name} N={n} K={kk} O={o} {out} relu={relu}: "
                                     f"{int((got != ref).sum())} outputs differ")
            bodies[name] = bodies.get(name, 0) + 1
    return {"bit_exact_cases": bodies, "max_abs_acc": acc_max, "above_2_24": acc_max > 2 ** 24}


K15A_CROSSOVER_N = (1, 4, 8, 16, 32, 64)


def k15a_row_crossover(int8_tree, dev, gen):
    """K15a's two bodies at the int8 OPT's six linears, each cycling through
    every layer's weight (cold, as a step finds them), at K15A_CROSSOVER_N
    rows: ms summed over the six sites, and the largest row count up to
    which the stream body wins (int8.STREAM_MAX_ROWS follows it)."""
    import torch

    from smoothquant_tpu_torch.kernels import int8 as k15

    layers = int8_tree["int8_layers"]
    n_l = len(layers)
    ms = {}
    for n in K15A_CROSSOVER_N:
        tot = {"stream": 0.0, "wg": 0.0}
        for site, field, relu, to_int8 in OPT_LINEARS:
            lins = [getattr(lp, field) for lp in layers]
            x = _i8_like_acts((n, lins[0].w_q.shape[1]), gen, dev)
            kw = dict(relu=relu, out_dtype=torch.int8 if to_int8 else torch.float32)
            for body in tot:
                tot[body] += device_ms(lambda i: k15.int8_linear(
                    x, lins[i % n_l].w_q, lins[i % n_l].alpha, lins[i % n_l].bias, **kw,
                    body=body), n_l)
        ms[n] = tot
    wins = [n for n in K15A_CROSSOVER_N if ms[n]["stream"] < ms[n]["wg"]]
    below = [n for n in K15A_CROSSOVER_N if all(w in wins for w in K15A_CROSSOVER_N if w <= n)]
    return dict(rows=list(K15A_CROSSOVER_N), ms=ms, stream_wins_at=wins,
                stream_wins_up_to=below[-1] if below else None)


def host_us(fn, calls: int = 200, reps: int = 3) -> float:
    """Least host µs one fn() call takes to return, over `reps` runs of
    `calls` calls queued back to back (no synchronize between them, so the
    card's time does not enter while the queue has room)."""
    import torch

    fn()
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return min(out)


def k6_host_us(dev):
    """Host µs per K6 call at a BLOOM-7b1 4h_to_h linear (K 16384 less 896
    salient, O 4096, g64, bf16 scales) at 4 rows (the Generator's decode)
    and 2048 (its prefill): the wrapper (its shape rule takes the wgmma
    body), and each body's C entry called directly with the same operands —
    the wgmma body's encodes its TMA tensor maps on every call, the tiles
    body has none, so their difference bounds what the maps cost."""
    import torch

    from smoothquant_tpu_torch.kernels import _build
    from smoothquant_tpu_torch.kernels import int4_group_matmul as k6

    gen = torch.Generator(device=dev).manual_seed(SEED + 44)
    kk, o, gs, k_s = 15616, 4096, 64, 896
    w = torch.randint(-128, 128, (kk // 2, o), generator=gen, device=dev, dtype=torch.int8)
    ws = (torch.rand((kk // gs, o), generator=gen, device=dev) * 0.1).to(torch.bfloat16)
    w_sal = torch.randn((k_s, o), generator=gen, device=dev).to(torch.bfloat16)
    lib = _build.lib()
    out = {}
    for n in (4, 2048):
        x_q = torch.randint(-7, 8, (n, kk), generator=gen, device=dev, dtype=torch.int8)
        x_s = torch.rand((n, kk // gs), generator=gen, device=dev) * 0.1
        x_sal = torch.randn((n, k_s), generator=gen, device=dev).to(torch.bfloat16)
        y = torch.empty((n, o), dtype=torch.bfloat16, device=dev)
        ptrs = [t.data_ptr() for t in (x_q, x_s, w, ws, x_sal, w_sal, y)]
        dt_s, st = _build.dt_code(ws), _build.stream_ptr(x_q)
        rc = []

        def wg():
            rc.append(lib.sq_int4_gmm_wg(*ptrs, n, o, kk, gs, k_s, dt_s, st))

        def tiles():
            rc.append(lib.sq_int4_gmm(*ptrs, n, o, kk, gs, k_s, dt_s, _build.dt_code(y), st))

        out[n] = {"body": k6.gmm_body(o, gs, torch.bfloat16),
                  "wrapper": host_us(lambda: k6.int4_group_matmul(
                      x_q, x_s, w, ws, x_sal, w_sal, group_size=gs)),
                  "wgmma_entry": host_us(wg), "tiles_entry": host_us(tiles)}
        for r in set(rc):
            _build.check(r, "K6 host timing")
    return out


# split_decode.cuh's modes (its MODE template), by the kernel each serves
SPLIT_MODES = ("K11 split", "K3 split", "K12 stacked", "K12 flat", "K12 write")
OUT_CODE = {"13__nv_bfloat16": "bf16", "f": "f32", "a": "int8"}   # mangled output types


def sass_dump_start():
    """`cuobjdump -sass` of the built library, started in the background
    into a temporary file, so the dump overlaps the phases after the build:
    (the process, the file's path) for sass_check."""
    import os
    import shutil
    import tempfile

    from smoothquant_tpu_torch.kernels import _build

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    fd, path = tempfile.mkstemp(prefix="chip_smoke_sass_", suffix=".txt")
    with os.fdopen(fd, "w") as f:
        proc = subprocess.Popen([tool, "-sass", _build.build()], stdout=f,
                                stderr=subprocess.PIPE, text=True)
    return proc, path


def sass_check(dump=None):
    """What the build made of the wgmma bodies and of the stream body K8 and
    K5 share: per kernel, the IGMMA / HGMMA instructions of its main loop
    and any I2F (int → float through the conversion unit, which the
    per-group scalings of K6 and the stream body are written to avoid) in
    `cuobjdump -sass`, and ptxas' register, spill and serialization notes;
    for the stream kernels (K8's and K5's, K13's bf16 and K1's raw-x
    kinds), how the weight arrives: TMA copies (UTMALDG) and 128-bit global
    loads (LDG.E.128).  Fails unless each K6 body issues
    IGMMA and has no I2F, each K9 body issues HGMMA, and each stream kernel
    has no I2F and loads by TMA (spills and serialization notes are
    reported, not held); and unless each split kernel of K11, K3 and K12
    has no I2F (int8 bytes and ALiBi positions convert by the exact f32 add)
    and copies its rows by bulk copies (UBLKCP; K3's by TMA boxes, UTMALDG),
    and K15b's qk body has no I2F (its accumulators convert by the same
    add); and unless each s8 wgmma kernel of K4 and K15a issues IGMMA (K4's
    HGMMA too, for its salient stages), loads by TMA and has no I2F, each
    of K15a's stream kernels issues IMMA, loads by TMA and has no I2F, and
    none of those fourteen spills; and unless K14's six gate_up kernels
    (stream_swiglu_kernel) load by TMA, and they and K16's sixteen row
    kernels have no I2F, no local loads or stores (LDL / STL), no spill
    and no stack frame; and unless K7's sixteen row kernels have no I2F, no
    LDL / STL and no spill (their codes' division is IEEE's: MUFU.RCP, the
    fix-up and the slow path's CALL are counted, and k7_edges holds the
    codes to torch's true division); and unless the eight kernels of K2 /
    K10's row body (two layouts, two dtypes, the vector and the scalar form)
    have no I2F, no LDL / STL, no spill and no stack frame."""
    import os
    import re

    from smoothquant_tpu_torch.kernels import _build

    proc, path = dump or sass_dump_start()
    try:
        _, err = proc.communicate(timeout=600)
        if proc.returncode:
            raise RuntimeError(f"cuobjdump -sass failed ({proc.returncode}): {err}")
        with open(path) as f:
            sass = f.read()
    finally:
        os.remove(path)
    out, stream, attn, s8, new, k7, kv = {}, {}, {}, {}, {}, {}, {}
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        name = fn.split("\n", 1)[0]
        m = re.search(r"split_decode_kernelI(13__nv_bfloat16|a)Li(\d+)ELi(\d+)ELb\dELi(\d)E",
                      name)
        if m or "qk_tile_kernel" in name:
            ops = {op: len(re.findall(r"\b" + op + r"\b", fn))
                   for op in ("I2F", "UBLKCP", "UTMALDG", "IMMA")}
            # K3's rows come as TMA boxes, every other mode's by bulk copies
            rows_op = "UTMALDG" if m and m.group(4) == "1" else "UBLKCP"
            if ops["I2F"] or (m and not ops[rows_op]) or (not m and not ops["IMMA"]):
                raise AssertionError(f"{name}: SASS {ops}")
            key = (f"{SPLIT_MODES[int(m.group(4))]} {'int8' if m.group(1) == 'a' else 'bf16'} "
                   f"D={m.group(2)} rep={m.group(3)}" if m else "K15b qk")
            attn[key] = ops
            continue
        m = (re.search(r"stream_rawx_kernelILi(\d+)ELi(\d+)E(13__nv_bfloat16|f)E", name)
             or re.search(r"stream_bf16_kernelILi(\d+)E", name))
        if m:
            ops = {op: len(re.findall(r"\b" + op + r"\b", fn))
                   for op in ("I2F", "UTMALDG", "IMMA", "HMMA")}
            ops["LDG.E.128"] = len(re.findall(r"LDG\.E\.128\b", fn))
            if ops["I2F"] or not ops["UTMALDG"]:
                raise AssertionError(f"stream {name}: SASS {ops}")
            stream[f"K1 gs={m.group(1)} nt={m.group(2)} {'f32' if m.group(3) == 'f' else 'bf16'}"
                   f" scales" if "rawx" in name else f"K13 kb={m.group(1)}"] = ops
            continue
        m = (re.search(r"stream_swiglu_kernelILi(\d+)E(13__nv_bfloat16|f)E", name)
             or re.search(r"norm_quant_rows_kernelI(13__nv_bfloat16|f)Li(\d)ELb(\d)E", name))
        if m:   # K14's gate_up launch, K16's row body
            ops = {op: len(re.findall(r"\b" + op + r"\b", fn))
                   for op in ("I2F", "UTMALDG", "IMMA", "LDL", "STL")}
            k14 = "swiglu" in name
            if ops["I2F"] or ops["LDL"] or ops["STL"] or (k14 and not ops["UTMALDG"]):
                raise AssertionError(f"{name}: SASS {ops}")
            new[f"K14 gate_up gs={m.group(1)} {'f32' if m.group(2) == 'f' else 'bf16'} scales"
                if k14 else f"K16 rows {'f32' if m.group(1) == 'f' else 'bf16'} "
                            f"W={m.group(2)}{' early' if m.group(3) == '1' else ''}"] = ops
            continue
        m = re.search(r"act_rows_kernelI(\w+?)Li(\d)ELb(\d)E", name)
        if m:   # K7's row body: no I2F, no local memory; its division the IEEE one
            ops = {op: len(re.findall(r"\b" + op + r"\b", fn))
                   for op in ("I2F", "LDL", "STL", "MUFU.RCP")}
            ops["CALL"] = len(re.findall(r"\bCALL\.", fn))
            ops["LDG.E.128"] = len(re.findall(r"LDG\.E\.(?:CONSTANT\.)?128\b", fn))
            if ops["I2F"] or ops["LDL"] or ops["STL"]:
                raise AssertionError(f"{name}: SASS {ops}")
            k7[f"K7 rows {m.group(1)} ch={m.group(2)}{' early' if m.group(3) == '1' else ''}"] = ops
            continue
        m = re.search(r"kv_rows_kernelI(13__nv_bfloat16|f)Lb(\d)ELb(\d)E", name)
        if m:   # K2 / K10's row body: no I2F, no local memory
            ops = {op: len(re.findall(r"\b" + op + r"\b", fn))
                   for op in ("I2F", "LDL", "STL", "SHFL.BFLY", "MUFU.RCP")}
            ops["LDG.E.128"] = len(re.findall(r"LDG\.E\.(?:CONSTANT\.)?128\b", fn))
            ops["STG.E.128"] = len(re.findall(r"STG\.E\.128\b", fn))
            if ops["I2F"] or ops["LDL"] or ops["STL"]:
                raise AssertionError(f"{name}: SASS {ops}")
            kv[f"kv rows {'smajor' if m.group(2) == '1' else 'head_major'} "
               f"{'f32' if m.group(1) == 'f' else 'bf16'} "
               f"{'vec' if m.group(3) == '1' else 'scalar'}"] = ops
            continue
        m = re.search(r"stream_gmm_kernelILb(\d)ELi(\d+)ELi(\d+)", name)
        if m:
            ops = {op: len(re.findall(r"\b" + op + r"\b", fn))
                   for op in ("I2F", "UTMALDG", "IMMA", "HMMA")}
            ops["LDG.E.128"] = len(re.findall(r"LDG\.E\.128\b", fn))
            if ops["I2F"] or not ops["UTMALDG"]:
                raise AssertionError(f"stream {name}: SASS {ops}")
            stream[f"{'K5' if m.group(1) == '1' else 'K8'} gs={m.group(2)} nt={m.group(3)}"] = ops
            continue
        m = re.search(r"s8_gemm_kernelILi(\d+)ELi(\d+)ELb(\d)ELi(\d)E(13__nv_bfloat16|f|a)E",
                      name)
        if m:
            ops = {op: len(re.findall(r"\b" + op + r"\b", fn))
                   for op in ("IGMMA", "HGMMA", "I2F", "UTMALDG")}
            if (not ops["IGMMA"] or ops["I2F"] or not ops["UTMALDG"]
                    or (m.group(3) == "1") != (ops["HGMMA"] > 0)):
                raise AssertionError(f"s8 wgmma {name}: SASS {ops}")
            s8[f"{'K4' if m.group(4) == '0' else 'K15a'} wg bn={m.group(1)} "
               f"stages={m.group(2)} out={OUT_CODE[m.group(5)]}"] = ops
            continue
        m = re.search(r"stream_s8_kernelILi(\d+)E(f|a)E", name)
        if m:
            ops = {op: len(re.findall(r"\b" + op + r"\b", fn))
                   for op in ("I2F", "UTMALDG", "IMMA")}
            if ops["I2F"] or not ops["UTMALDG"] or not ops["IMMA"]:
                raise AssertionError(f"stream {name}: SASS {ops}")
            s8[f"K15a stream nt={m.group(1)} out={OUT_CODE[m.group(2)]}"] = ops
            continue
        kind = ("K6" if "wg_gmm_kernel" in name else
                "K9" if "dual_path_wg_kernel" in name else None)
        if kind is None:
            continue
        ops = {op: len(re.findall(r"\b" + op + r"\b", fn)) for op in ("IGMMA", "HGMMA", "I2F")}
        if (kind == "K6" and (ops["IGMMA"] == 0 or ops["I2F"])) or (
                kind == "K9" and ops["HGMMA"] == 0):
            raise AssertionError(f"{kind} {name}: SASS {ops}")
        short = name[name.find("wg_gmm_kernel" if kind == "K6" else "dual_path_wg_kernel"):]
        out[f"{kind} {short[:60]}"] = ops
    log = _build.build_log.splitlines()
    notes = {}
    for i, ln in enumerate(log):
        if "Compiling entry" in ln and any(k in ln for k in (
                "wg_gmm_kernel", "dual_path_wg_kernel", "stream_gmm_kernel",
                "stream_bf16_kernel", "stream_rawx_kernel",
                "split_decode_kernel", "qk_tile_kernel", "pv_tile_kernel", "kn_gemv_kernel")):
            block = " ".join(log[i:i + 4])
            regs = re.search(r"Used (\d+) registers", block)
            spill = re.search(r"(\d+) bytes spill stores", block)
            notes[re.search(r"(wg_gmm_kernel|dual_path_wg_kernel|stream_gmm_kernel|"
                            r"stream_bf16_kernel|stream_rawx_kernel|"
                            r"split_decode_kernel|qk_tile_kernel|pv_tile_kernel|kn_gemv_kernel)"
                            r"\w{0,40}", ln).group(0)] = [
                int(regs.group(1)) if regs else None, int(spill.group(1)) if spill else None]
    serialized = sum(1 for ln in log if "serialized" in ln)
    s8_spills = {}
    for i, ln in enumerate(log):
        m = re.search(r"(s8_gemm_kernel|stream_s8_kernel)\w*", ln)
        if "Compiling entry" in ln and m:
            spill = re.search(r"(\d+) bytes spill stores", " ".join(log[i:i + 4]))
            s8_spills[m.group(0)[:60]] = int(spill.group(1)) if spill else None
    if len(s8) != 14 or any(v != 0 for v in s8_spills.values()) or len(s8_spills) != 14:
        raise AssertionError(f"the s8 bodies of K4 and K15a: {len(s8)} kernels in the SASS "
                             f"(14 expected), spill stores {s8_spills}")
    new_spills = {}
    for i, ln in enumerate(log):
        m = re.search(r"(stream_swiglu_kernel|norm_quant_rows_kernel)\w*", ln)
        if "Compiling entry" in ln and m:
            block = " ".join(log[i:i + 4])
            spill = re.search(r"(\d+) bytes spill stores", block)
            stack = re.search(r"(\d+) bytes stack frame", block)
            new_spills[m.group(0)[:60]] = [int(spill.group(1)) if spill else None,
                                           int(stack.group(1)) if stack else None]
    if (len(new) != 22 or len(new_spills) != 22
            or any(v != [0, 0] for v in new_spills.values())):
        raise AssertionError(f"the new bodies of K14 and K16: {len(new)} kernels in the SASS "
                             f"(22 expected: 6 K14, 16 K16), spill stores / stack frame "
                             f"{new_spills}")
    k7_spills = {}
    for i, ln in enumerate(log):
        m = re.search(r"act_rows_kernel\w*", ln)
        if "Compiling entry" in ln and m:
            block = " ".join(log[i:i + 4])
            regs = re.search(r"Used (\d+) registers", block)
            spill = re.search(r"(\d+) bytes spill stores", block)
            stack = re.search(r"(\d+) bytes stack frame", block)
            k7_spills[m.group(0)[:70]] = [int(regs.group(1)) if regs else None,
                                          int(spill.group(1)) if spill else None,
                                          int(stack.group(1)) if stack else None]
    if len(k7) != 16 or len(k7_spills) != 16 or any(v[1] != 0 for v in k7_spills.values()):
        raise AssertionError(f"K7's row body: {len(k7)} kernels in the SASS (16 expected), "
                             f"registers / spill stores / stack frame {k7_spills}")
    kv_spills = {}
    for i, ln in enumerate(log):
        m = re.search(r"kv_rows_kernel\w*", ln)
        if "Compiling entry" in ln and m:
            block = " ".join(log[i:i + 4])
            regs = re.search(r"Used (\d+) registers", block)
            spill = re.search(r"(\d+) bytes spill stores", block)
            stack = re.search(r"(\d+) bytes stack frame", block)
            kv_spills[m.group(0)[:70]] = [int(regs.group(1)) if regs else None,
                                          int(spill.group(1)) if spill else None,
                                          int(stack.group(1)) if stack else None]
    if (len(kv) != 8 or len(kv_spills) != 8
            or any(v[1] != 0 or v[2] != 0 for v in kv_spills.values())):
        raise AssertionError(f"K2 / K10's row body: {len(kv)} kernels in the SASS (8 "
                             f"expected), registers / spill stores / stack frame {kv_spills}")
    n_k1 = sum(k.startswith("K1 ") for k in stream)
    if (not out or not stream or len(attn) != 43 or n_k1 != 18
            or not {"K13 kb=64", "K13 kb=32"} <= set(stream)):
        raise AssertionError("the build holds no wgmma body, no stream body, not K13's and "
                             "K1's 18 stream kernels or not the 42 split kernels (K11 16, K3 "
                             "8, K12 18) and K15b's qk body")
    return {"sass": out, "stream_sass": stream, "attn_sass": attn, "s8_sass": s8,
            "k14_k16_sass": new, "k14_k16_spills_stack": new_spills,
            "k7_sass": k7, "k7_registers_spills_stack": k7_spills,
            "kv_rows_sass": kv, "kv_rows_registers_spills_stack": kv_spills,
            "registers_spills": notes, "ptxas_serialized_notes": serialized}


def add_scaling_floors(rows, clock_mhz):
    """Each K5, K6 and K8 row's per-group scaling floor beside its bound
    (roofline.group_scaling_floor_ms at the card's highest SM clock)."""
    from smoothquant_tpu_torch.utils import roofline

    for r in rows:
        if "scalings" in r:
            r["scaling_floor_ms"] = roofline.group_scaling_floor_ms(*r["scalings"], clock_mhz)
    return [dict(kernel=r["kernel"], site=r["site"], ms=r["kernel_ms"], bound_ms=r["bound_ms"],
                 scaling_floor_ms=r["scaling_floor_ms"])
            for r in rows if "scalings" in r]


def check_no_fallback(dev):
    """On CUDA tensors a wrapper launches its kernel or raises: shapes and
    options the kernels do not take raise instead of running a plain
    version.  K11's ALiBi body and K4's raw-x mode run (their phases);
    what they still refuse, and int8_dots (K11, K12), raises here, as does
    each shape the split bodies of K11, K3 and K12 and the stream bodies of
    K13, K1 and K14 refuse when forced on them, what K16's row body
    does not take (every shape the wrapper accepts is its), what K7's two
    bodies do not take, and the calls the KV writers' row body does not
    take (a q it cannot rotate, a forced 16-byte form on rows off 16 bytes;
    check_salient_dtype runs beside it the stacked path over a salient
    block in another dtype, which K5 once refused)."""
    import torch

    from smoothquant_tpu_torch.kernels import act_prep as k7
    from smoothquant_tpu_torch.kernels import attn_fused as k12
    from smoothquant_tpu_torch.kernels import attn_smajor as k3
    from smoothquant_tpu_torch.kernels import cache_write as k10
    from smoothquant_tpu_torch.kernels import decode_attention as k11
    from smoothquant_tpu_torch.kernels import fp_matmul as k13
    from smoothquant_tpu_torch.kernels import int4_group_matmul as k1
    from smoothquant_tpu_torch.kernels import int8 as k15
    from smoothquant_tpu_torch.kernels import int8_prefill as k4
    from smoothquant_tpu_torch.kernels import int_group_matmul as k8
    from smoothquant_tpu_torch.kernels import mlp_fused as k14
    from smoothquant_tpu_torch.kernels import norm_quant as k16
    from smoothquant_tpu_torch.kernels import quant_matmul as k9

    z8 = torch.zeros((64, 64), dtype=torch.int8, device=dev)
    w4 = torch.zeros((1, 128, 256), dtype=torch.int8, device=dev)      # K = 256
    f32 = lambda *shape: torch.zeros(shape, device=dev)
    bf = lambda *shape: torch.zeros(shape, device=dev, dtype=torch.bfloat16)
    kv = (f32(2, 4, 64),) * 2 + (f32(2, 1, 64),) * 2
    kv_bf = (bf(2, 4, 64),) * 2 + (f32(2, 1, 64),) * 2
    hm8 = (torch.zeros((1, 2, 4, 128, 64), dtype=torch.int8, device=dev),) * 2
    sm8 = lambda s, d: (torch.zeros((1, 1, s, 4 * d), dtype=torch.int8, device=dev),) * 2
    sm_sc = lambda s: (f32(1, 1, 4, s),) * 2
    one = torch.ones((64, 1), device=dev)
    no_sal = (torch.zeros((64, 0), device=dev), torch.zeros((0, 64), device=dev))
    k14_kw = dict(group_size=64, act_bits=4, n_sal1=0, n_sal2=0, gu_out_true=256,
                  dn_out_true=256)
    cases = {  # name: (call, the exception it must raise)
        "K4 weight not K-major": (lambda: k4.int8_prefill_matmul(
            z8, one, z8, one.t(), *no_sal), ValueError),
        "K4 raw-x with int8 codes": (lambda: k4.int8_prefill_matmul(
            z8, one, z8.t().contiguous().t(), one.t(), *no_sal, one.t()), TypeError),
        "K4 raw-x mask not (1, K)": (lambda: k4.int8_prefill_matmul(
            f32(64, 64), one, z8.t().contiguous().t(), one.t(), *no_sal, one.t()[:, :32]),
            ValueError),
        "K11 head_dim 96": (lambda: k11.decode_attention(
            torch.zeros((1, 4, 96), device=dev), torch.zeros((1, 4, 128, 96), device=dev),
            torch.zeros((1, 4, 128, 96), device=dev), torch.zeros((1, 128), device=dev)),
            ValueError),
        "K11 ALiBi over GQA": (lambda: k11.decode_attention(
            torch.zeros((1, 4, 64), device=dev), torch.zeros((1, 2, 128, 64), device=dev),
            torch.zeros((1, 2, 128, 64), device=dev), torch.zeros((1, 128), device=dev),
            alibi_slopes=torch.ones(4, device=dev)), ValueError),
        "K11 int8_dots": (lambda: k11.decode_attention(
            torch.zeros((1, 4, 64), device=dev), *(torch.zeros((1, 4, 128, 64), device=dev,
                                                              dtype=torch.int8),) * 2,
            torch.zeros((1, 128), device=dev), *(torch.ones((1, 4, 128), device=dev),) * 2,
            int8_dots=True), NotImplementedError),
        "K11 split body for f32 queries": (lambda: k11.decode_attention_stacked(
            0, torch.zeros((1, 4, 64), device=dev), *(torch.zeros((1, 1, 4, 128, 64),
                                                                  device=dev),) * 2,
            torch.zeros((1, 128), device=dev), body="split"), ValueError),
        "K11 split body in 16 ranks": (lambda: k11.decode_attention_stacked(
            0, torch.zeros((1, 4, 64), device=dev, dtype=torch.bfloat16),
            *(torch.zeros((1, 1, 4, 512, 64), device=dev, dtype=torch.bfloat16),) * 2,
            torch.zeros((1, 512), device=dev), split=16), ValueError),
        "K11 split body at D = 256": (lambda: k11.decode_attention_stacked(
            0, torch.zeros((1, 4, 256), device=dev, dtype=torch.bfloat16),
            *(torch.zeros((1, 1, 4, 128, 256), device=dev, dtype=torch.bfloat16),) * 2,
            torch.zeros((1, 128), device=dev), body="split"), ValueError),
        "K3 split body for f32 queries": (lambda: k3.decode_attention_smajor_stacked(
            0, f32(1, 4, 64), *sm8(128, 64), f32(1, 128), *sm_sc(128), body="split"),
            ValueError),
        "K3 split body at D = 256": (lambda: k3.decode_attention_smajor_stacked(
            0, bf(1, 4, 256), *sm8(128, 256), f32(1, 128), *sm_sc(128), body="split"),
            ValueError),
        "K3 split body in 16 ranks": (lambda: k3.decode_attention_smajor_stacked(
            0, bf(1, 4, 64), *sm8(512, 64), f32(1, 512), *sm_sc(512), split=16), ValueError),
        "K3 S = 100": (lambda: k3.decode_attention_smajor_stacked(
            0, bf(1, 4, 64), *sm8(100, 64), f32(1, 100), *sm_sc(100)), ValueError),
        "K12 split body for f32 queries": (lambda: k12.fused_virtual_attn_stacked(
            0, 5, f32(2, 4, 64), *kv, *hm8, f32(1, 2, 4, 128), f32(1, 2, 4, 128),
            body="split"), ValueError),
        "K12 split body in 16 ranks": (lambda: k12.fused_virtual_attn_stacked(
            0, 5, bf(2, 4, 64), *kv_bf, *hm8, f32(1, 2, 4, 128), f32(1, 2, 4, 128), split=16),
            ValueError),
        "K12 flat body over GQA": (lambda: k12.fused_virtual_attn_flat(
            0, 5, bf(2, 1, 8 * 64), *kv_bf, *hm8, f32(1, 2, 4, 128), f32(1, 2, 4, 128)),
            ValueError),
        "K12 int8_dots": (lambda: k12.fused_virtual_attn_stacked(
            0, 5, f32(2, 4, 64), *kv, *(torch.zeros((1, 2, 4, 128, 64), dtype=torch.int8,
                                                   device=dev),) * 2,
            f32(1, 2, 4, 128), f32(1, 2, 4, 128), int8_dots=True), NotImplementedError),
        "K7b group size 48": (lambda: k7.norm_quantize_acts_t(
            f32(8, 480), torch.ones(480, device=dev), group_size=48, act_bits=4, k_ns=480,
            num_salient=0, k_s=0, eps=1e-5), ValueError),
        "K7b groups body in rms_round": (lambda: k7.norm_quantize_acts_t(
            f32(8, 512), torch.ones(512, device=dev), group_size=64, act_bits=4, k_ns=512,
            num_salient=0, k_s=0, eps=1e-5, norm_kind="rms_round", body="groups"), ValueError),
        "K7b groups body at group size 256": (lambda: k7.norm_quantize_acts_t(
            f32(8, 512), torch.ones(512, device=dev), group_size=256, act_bits=4, k_ns=512,
            num_salient=0, k_s=0, eps=1e-5, body="groups"), ValueError),
        "K2 row body at head_dim 96 with q": (lambda: k3.rope_q_write_cache_smajor(
            0, torch.zeros(2, dtype=torch.int32, device=dev), bf(2, 4, 96), bf(2, 1, 96),
            bf(2, 1, 96), f32(2, 1, 96), f32(2, 1, 96), *(torch.zeros(
                (1, 2, 8, 96), dtype=torch.int8, device=dev),) * 2,
            f32(1, 2, 1, 8), f32(1, 2, 1, 8)), ValueError),
        "K10 row body forced on rows off 16 bytes": (lambda: k10.write_quant_cache_stacked(
            0, torch.zeros(2, dtype=torch.int32, device=dev), bf(2 * 4 * 64 + 1)[1:].view(
                2, 4, 64), bf(2, 4, 64), f32(2, 1, 64), f32(2, 1, 64), *hm8,
            f32(1, 2, 4, 128), f32(1, 2, 4, 128), body="rows"), ValueError),
        "K10 q with rotary off": (lambda: k10.rope_q_write_cache_stacked(
            0, torch.zeros(2, dtype=torch.int32, device=dev), bf(2, 4, 64), bf(2, 4, 64),
            bf(2, 4, 64), None, None, *hm8, f32(1, 2, 4, 128), f32(1, 2, 4, 128),
            rotary=False), ValueError),
        "K13 nine rows": (lambda: k13.fp_matmul_stacked(
            0, torch.zeros((9, 64), device=dev), torch.zeros((1, 64, 64), device=dev)),
            ValueError),
        "K13 stream body for f32 x": (lambda: k13.fp_matmul_stacked(
            0, f32(4, 64), f32(1, 64, 64), body="stream"), ValueError),
        "K13 stream body at K = 12": (lambda: k13.fp_matmul_stacked(
            0, bf(4, 12), bf(1, 12, 64), body="stream"), ValueError),
        "K13 unknown body": (lambda: k13.fp_matmul_stacked(
            0, bf(4, 64), bf(1, 64, 64), body="tiles"), ValueError),
        "K1 stream body for f32 x": (lambda: k1.int4_group_matmul_stacked_rawx(
            0, f32(4, 256), None, w4, f32(1, 4, 256), f32(1, 0, 256), group_size=64,
            act_bits=4, num_salient=0, norm_kind=None, body="stream"), ValueError),
        "K1 stream body at group size 128": (lambda: k1.int4_group_matmul_stacked_rawx(
            0, bf(4, 256), None, w4, bf(1, 2, 256), bf(1, 0, 256), group_size=128,
            act_bits=4, num_salient=0, norm_kind=None, body="stream"), ValueError),
        "K1 stream body at O = 200": (lambda: k1.int4_group_matmul_stacked_rawx(
            0, bf(4, 256), None, torch.zeros((1, 128, 200), dtype=torch.int8, device=dev),
            bf(1, 4, 200), bf(1, 0, 200), group_size=64, act_bits=4, num_salient=0,
            norm_kind=None, body="stream"), ValueError),
        "K15a float32 x": (lambda: k15.int8_linear(torch.zeros((4, 64), device=dev), z8, 1.0),
                           TypeError),
        "K15a bf16 out": (lambda: k15.int8_linear(z8, z8, 1.0, out_dtype=torch.bfloat16),
                          TypeError),
        "K4 wgmma body with f32 salient operands": (lambda: k4.int8_prefill_matmul(
            z8, one, z8.t().contiguous().t(), one.t(), f32(64, 16), f32(16, 64), body="wg"),
            ValueError),
        "K4 wgmma body in the raw-x mode": (lambda: k4.int8_prefill_matmul(
            bf(64, 64), one, z8.t().contiguous().t(), one.t(), bf(64, 0), bf(0, 64), one.t(),
            body="wg"), ValueError),
        "K15a stream body at 65 rows": (lambda: k15.int8_linear(
            torch.zeros((65, 64), dtype=torch.int8, device=dev), z8, 1.0, body="stream"),
            ValueError),
        "K15a gemv body at 9 rows": (lambda: k15.int8_linear(z8[:9], z8, 1.0, body="gemv"),
                                     ValueError),
        "K15a tiles body at 4 rows": (lambda: k15.int8_linear(z8[:4], z8, 1.0, body="tiles"),
                                      ValueError),
        "K15a unknown body": (lambda: k15.int8_linear(z8, z8, 1.0, body="pv"), ValueError),
        "K15b K mismatch": (lambda: k15.int8_bmm(z8[None], z8[None, :, :32], 1.0),
                            ValueError),
        "K15b qk body with int8 out": (lambda: k15.int8_bmm(
            z8[None], z8[None], 1.0, out_dtype=torch.int8, body="qk"), ValueError),
        "K15b qk body at K = 512": (lambda: k15.int8_bmm(
            torch.zeros((1, 64, 512), dtype=torch.int8, device=dev),
            torch.zeros((1, 64, 512), dtype=torch.int8, device=dev), 1.0, body="qk"),
            ValueError),
        "K15b pv body at K = 2048": (lambda: k15.int8_bmm(
            torch.zeros((1, 64, 2048), dtype=torch.int8, device=dev),
            torch.zeros((1, 2048, 64), dtype=torch.int8, device=dev), 1.0, b_kn=True,
            body="pv"), ValueError),
        "K15b nk GEMV at K = 512": (lambda: k15.int8_bmm(
            torch.zeros((1, 1, 512), dtype=torch.int8, device=dev),
            torch.zeros((1, 64, 512), dtype=torch.int8, device=dev), 1.0, body="nk_gemv"),
            ValueError),
        "K15b kn GEMV at 9 rows": (lambda: k15.int8_bmm(
            z8[None, :9], z8[None], 1.0, b_kn=True, body="kn_gemv"), ValueError),
        "K15b kn GEMV in 16 ranks": (lambda: k15.int8_bmm(
            z8[None, :1], z8[None], 1.0, b_kn=True, body="kn_gemv", ranks=16), ValueError),
        "K16 C = 100": (lambda: k16.layer_norm_q(torch.zeros((4, 100), device=dev),
                                                 *(torch.ones(100, device=dev),) * 2, 1.0),
                        ValueError),
        "K16 int8 x": (lambda: k16.layer_norm_q(z8, *(torch.ones(64, device=dev),) * 2, 1.0),
                       TypeError),
        "K1 33 rows": (lambda: k1.int4_group_matmul_stacked_rawx(
            0, f32(33, 256), None, w4, f32(1, 4, 256), f32(1, 0, 256), group_size=64,
            act_bits=4, num_salient=0, norm_kind=None), NotImplementedError),
        "K5 group size 128": (lambda: k1.int4_group_matmul_stacked(
            0, z8[:, :1].expand(64, 256).contiguous(), f32(64, 2), w4, f32(1, 2, 256),
            f32(64, 0), f32(1, 0, 256), group_size=128), ValueError),
        "K5 float codes": (lambda: k1.int4_group_matmul_stacked(
            0, f32(4, 8, 64), f32(4, 8), w4, f32(1, 4, 256), f32(8, 0), f32(1, 0, 256),
            group_size=64, pre_laid=8), TypeError),
        "K7a group size 512": (lambda: k7.quantize_acts_grouped_t(
            f32(8, 512), group_size=512, act_bits=4), ValueError),
        "K7a wider than the row body": (lambda: k7.quantize_acts_grouped_t(
            f32(2, 300032), group_size=64, act_bits=4), ValueError),
        "K10 float cache": (lambda: k10.write_quant_cache_stacked(
            0, torch.zeros(2, dtype=torch.int32, device=dev), *kv, f32(1, 2, 4, 8, 64),
            f32(1, 2, 4, 8, 64), f32(1, 2, 4, 8), f32(1, 2, 4, 8)), TypeError),
        "K12 S = 100": (lambda: k12.fused_virtual_attn_stacked(
            0, 5, f32(2, 4, 64), *kv, torch.zeros((1, 2, 4, 100, 64), dtype=torch.int8,
                                                  device=dev),
            torch.zeros((1, 2, 4, 100, 64), dtype=torch.int8, device=dev), f32(1, 2, 4, 100),
            f32(1, 2, 4, 100)), ValueError),
        "K14 stream body for f32 x": (lambda: k14.mlp_swiglu_fused_stacked(
            0, f32(4, 256), None, w4, f32(1, 4, 256), f32(1, 0, 256), w4, f32(1, 4, 256),
            f32(1, 0, 256), **k14_kw, body="stream"), ValueError),
        "K14 stream body at group size 128": (lambda: k14.mlp_swiglu_fused_stacked(
            0, bf(4, 256), None, w4, bf(1, 2, 256), bf(1, 0, 256), w4, bf(1, 2, 256),
            bf(1, 0, 256), **{**k14_kw, "group_size": 128}, body="stream"), ValueError),
        "K14 stream body at O2 = 200": (lambda: k14.mlp_swiglu_fused_stacked(
            0, bf(4, 256), None, w4, bf(1, 4, 256), bf(1, 0, 256),
            torch.zeros((1, 128, 200), dtype=torch.int8, device=dev), bf(1, 4, 200),
            bf(1, 0, 200), **{**k14_kw, "dn_out_true": 200}, body="stream"), ValueError),
        "K14 unknown body": (lambda: k14.mlp_swiglu_fused_stacked(
            0, bf(4, 256), None, w4, bf(1, 4, 256), bf(1, 0, 256), w4, bf(1, 4, 256),
            bf(1, 0, 256), **k14_kw, body="tiles"), ValueError),
        "K16 C = 8200": (lambda: k16.layer_norm_q(torch.zeros((4, 8200), device=dev),
                                                  *(torch.ones(8200, device=dev),) * 2, 1.0),
                         ValueError),
        "K16 unknown body": (lambda: k16.norm_quant(
            torch.zeros((4, 64), device=dev), *(torch.ones(64, device=dev),) * 2, 1.0,
            body="tiles"), ValueError),
        "K14 nine rows": (lambda: k14.mlp_swiglu_fused_stacked(
            0, f32(9, 256), None, w4, f32(1, 4, 256), f32(1, 0, 256), w4, f32(1, 4, 256),
            f32(1, 0, 256), group_size=64, act_bits=4, n_sal1=0, n_sal2=0, gu_out_true=256,
            dn_out_true=256), NotImplementedError),
        "K8 group size 24": (lambda: k8.int_group_matmul(
            z8[:4, :48].contiguous(), f32(4, 2), z8[:48], f32(2, 64), f32(4, 0), f32(0, 64),
            group_size=24), ValueError),
        "K8 O = 6": (lambda: k8.int_group_matmul(
            z8[:4], f32(4, 1), z8[:, :6].contiguous(), f32(1, 6), f32(4, 0), f32(0, 6),
            group_size=64), ValueError),
        "K8 stream body at O = 200": (lambda: k8.int_group_matmul(
            z8[:4], f32(4, 2), torch.zeros((64, 200), dtype=torch.int8, device=dev),
            f32(2, 200), f32(4, 0), f32(0, 200), group_size=32, body="stream"), ValueError),
        "K8 stream body at 65 rows": (lambda: k8.int_group_matmul(
            torch.zeros((65, 64), dtype=torch.int8, device=dev), f32(65, 2), z8, f32(2, 64),
            f32(65, 0), f32(0, 64), group_size=32, body="stream"), ValueError),
        "K5 stream body at 65 rows": (lambda: k1.int4_group_matmul_stacked(
            0, torch.zeros((65, 256), dtype=torch.int8, device=dev), f32(65, 4), w4,
            f32(1, 4, 256), f32(65, 0), f32(1, 0, 256), group_size=64, body="stream"),
            ValueError),
        "K8 float codes": (lambda: k8.int_group_matmul(
            f32(4, 64), f32(4, 1), z8, f32(1, 64), f32(4, 0), f32(0, 64), group_size=64),
            TypeError),
        "K9 float16 x": (lambda: k9.dual_path_matmul(
            f32(4, 64).half(), f32(4, 0).half(), z8, f32(1, 64), f32(0, 64).half(),
            group_size=64, out_dtype=torch.float16), TypeError),
        "K9 bf16 out of f32 x": (lambda: k9.dual_path_matmul(
            f32(4, 64), f32(4, 0), z8, f32(2, 64), f32(0, 64), group_size=32,
            out_dtype=torch.bfloat16), TypeError),
        "K9 O = 12": (lambda: k9.dual_path_matmul(
            f32(4, 64), f32(4, 0), z8[:, :12].contiguous(), f32(1, 12), f32(0, 12),
            group_size=64), ValueError),
        "K9 odd group size": (lambda: k9.dual_path_matmul(
            f32(4, 63), f32(4, 0), z8[:63], f32(21, 64), f32(0, 64), group_size=3),
            ValueError),
    }
    raised = {}
    for name, (fn, expected) in cases.items():
        try:
            fn()
        except expected as e:
            raised[name] = f"{type(e).__name__}: {e}"[:100]
            continue
        raise AssertionError(f"{name}: the wrapper ran instead of raising")
    return raised


def reference_check(dev):
    """Kernel path (card) vs plain path (CPU) on a small model with the
    same weights, f32 and bf16, logits compared:
      * smajor: a batched prefill into S-major caches and one stacked
        decode step (K6, K1, K2, K3);
      * generator: a 256-row prefill on the promoted tree over head-major
        int8 caches and one decode step on the per-layer nibble tree (K4,
        K6, K11);
      * bf16_baseline: one stacked pack_fp_decode step over a stacked fp
        head-major cache (K13, K11);
      * head_major_b40 / head_major_b16: one stacked decode step of 40 and
        16 rows over a random head-major int8 pool with per-slot positions
        and a key mask (K7a + K5, or K1; K10, K11);
      * aligned_<composition>: one stacked decode step of ALIGNED_ROWS rows
        over a random head-major int8 cache at aligned (L,) positions in each of
        COMPOSITIONS (K1 with K12's flat body + K10, K12's write body, K10 +
        K11, K14 + K12 + K10), and aligned_auto_gqa: "auto" on a GQA twin
        of the model (4 kv heads: K12's stacked body);
      * per_layer_<recipe>_<compute>: pack_model's default tree (per-layer
        int8-container linears, 4-bit g64 weights, 5 % salient) over
        per-layer head-major int8 caches, a prefill and one decode step in
        ForwardContext(compute=) "int" (K8), "dequant" (K9) and "auto" (K9
        at prefill, K8 at decode), with K11 in the step; the kernel path's
        launches checked.  Under 8-bit per-group activations (W4A8) over
        2 × 129 rows, and under the quick start's W4A4 over 2 × 12
        (PER_LAYER_PARTS).
    Tolerances, relative to the largest logit: 2e-2 in f32 and 5e-2 in bf16
    for the S-major path, 1e-3 / 2e-2 for the unquantized bf16
    baseline (f32 sums in another order).  The generator path's 256-row
    prefill quantizes every row's activations to int8 per token, and the
    last-bit differences of another sum order move a few codes across a
    rounding edge, which attention spreads to later rows (bf16 activations
    round coarser, so more codes move); its logits are held to 5e-2 (f32)
    and 1.5e-1 (bf16) of their norm instead — a wrong kernel misses by
    their whole norm.  So are the head-major and aligned steps: at 40 and
    16 rows a per-token int4 code on a rounding edge moves a row's logits
    (2 of 40 rows by up to 0.17 between the plain path and the JAX
    package).  The aligned steps (ALIGNED_ROWS rows) are held to 1e-2 of
    the norm in f32 (they read 1e-7 to 2e-6 on the H100) and 1e-1 in bf16:
    with one RMSNorm rule on both devices (quant.core.rms_factor: Σx² in
    f64, 1/√v correctly rounded) "auto", "fused" and "off" read 0 and the
    K14 and GQA steps 0.04 and 0.06 (bf16 roundings of f32 sums taken in
    another order); before it, K1's rsqrtf and the two devices' torch sums
    moved codes in most rows (0.09-0.17).  The
    per-layer parts quantize every row's activations per group.  Under
    W4A4 over 2 × 129 rows, noise of 2e-7 on every linear's f32 output
    (another sum order) moves a couple of int4 codes in the first layer;
    attention spreads them to thousands in the second, and the logits move
    0.12-0.13 of their norm.  Over 2 × 12 rows the same noise moves no
    code (5e-7), and under W4A8 over 2 × 129 rows, whose codes step 18×
    finer, 0.008-0.009 (tests/test_torch_chip_smoke.py,
    test_per_layer_parts_under_last_bit_noise).  So W4A4 is held to 1e-2
    in f32 at 2 × 12 rows, W4A8 to 5e-2 at 2 × 129, both to 1e-1 in bf16,
    whose roundings of f32 sums taken in another order move more codes."""
    import dataclasses
    from collections import Counter

    import torch

    from smoothquant_tpu_torch.models import llama
    from smoothquant_tpu_torch.models.common import (
        ForwardContext,
        KVCache,
        QuantKVCache,
        SMajorQuantKVCache,
    )
    from smoothquant_tpu_torch.models.registry import pack_model
    from smoothquant_tpu_torch.quant.config import w4a4_group, w4a8_group

    out, failed = {}, []
    aligned = [f"aligned_{name}" for name, _, _ in COMPOSITIONS] + ["aligned_auto_gqa"]
    per_layer = {f"per_layer_{r}_{c}": tol for r, (_, modes, tol) in PER_LAYER_PARTS.items()
                 for c in modes}
    for dtype_name, tol in (
            ("float32", {"smajor": 2e-2, "generator": 5e-2, "bf16_baseline": 1e-3,
                         "head_major_b40": 5e-2, "head_major_b16": 5e-2,
                         **{a: 1e-2 for a in aligned},
                         **{p: t["float32"] for p, t in per_layer.items()}}),
            ("bfloat16", {"smajor": 5e-2, "generator": 1.5e-1, "bf16_baseline": 2e-2,
                          "head_major_b40": 1.5e-1, "head_major_b16": 1.5e-1,
                          **{a: 1e-1 for a in aligned},
                          **{p: t["bfloat16"] for p, t in per_layer.items()}})):
        cfg = dataclasses.replace(
            llama.LlamaConfig.tiny(), hidden_size=512, intermediate_size=512,
            num_attention_heads=8, num_key_value_heads=8, num_hidden_layers=2,
            dtype=dtype_name)
        n_l, n_kv, hd = cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.head_dim
        fp, packed, stacked = build_model(cfg, "cpu", SEED, group_size=16, align_o=256)
        promoted = build_promoted(fp, cfg, SEED, group_size=16)
        bf16 = build_bf16(fp, cfg)
        gqa_cfg = dataclasses.replace(cfg, num_key_value_heads=4)
        gqa = build_model(gqa_cfg, "cpu", SEED, group_size=16, align_o=256)[2]
        feat = _recipe(cfg, SEED, 64)[2]
        qs = {r: pack_model("llama", fp, cfg, recipe(group_size=64, salient_prop=0.05),
                            input_feat=feat)
              for r, recipe in (("w4a8", w4a8_group), ("w4a4", w4a4_group))}
        gen = torch.Generator().manual_seed(SEED + 1)
        prompt = torch.randint(0, cfg.vocab_size, (2, 12), generator=gen)
        long_prompt = torch.randint(0, cfg.vocab_size, (2, 128), generator=gen)
        pools = {b: _random_pool(cfg, b, 128, gen) for b in (40, 16)}
        aligned_pools = {m: _random_pool(c, ALIGNED_ROWS, 128, gen)
                         for m, c in (("mha", cfg), ("gqa", gqa_cfg))}
        per_layer_prompts = {r: torch.randint(0, cfg.vocab_size, (2, rows), generator=gen)
                             for r, (rows, _, _) in PER_LAYER_PARTS.items()}
        logits = {}
        for name, d in (("plain", "cpu"), ("kernel", dev)):
            p, s = tree_to(packed, d), tree_to(stacked, d)
            cache = SMajorQuantKVCache.create(2, 128, n_kv, hd, d, n_layers=n_l)
            h, _ = llama.forward_hidden(p, prompt.to(d), cfg, caches=[
                cache.layer(i) for i in range(n_l)])
            pre = llama.lm_head_logits(p, h[:, -1:], cfg)
            cache.pos[:] = prompt.shape[1]
            mask = torch.zeros((2, 128), dtype=torch.bool, device=d)
            mask[:, :prompt.shape[1] + 1] = True
            step, _ = llama.forward(s, prompt[:, -1:].to(d), cfg, caches=cache,
                                    attn_mask=mask)
            qc = [QuantKVCache.create(2, 256, n_kv, hd, device=d) for _ in range(n_l)]
            g_pre, qc = llama.forward(tree_to(promoted, d), long_prompt.to(d), cfg, caches=qc)
            g_step, _ = llama.forward(p, long_prompt[:, -1:].to(d), cfg, caches=qc)
            fc = KVCache.create(2, 128, n_kv, hd, cfg.torch_dtype, d, n_layers=n_l)
            llama.forward(tree_to(fp, d), prompt.to(d), cfg, caches=[
                KVCache(fc.k[i], fc.v[i], 0) for i in range(n_l)])
            fc.pos[:] = prompt.shape[1]
            b_step, _ = llama.forward(tree_to(bf16, d), prompt[:, -1:].to(d), cfg, caches=fc)
            logits[name] = {"smajor": torch.cat([pre, step], dim=1),
                            "generator": torch.cat([g_pre[:, -1:], g_step], dim=1),
                            "bf16_baseline": b_step}
            for b, (pool, tok, pos, mask) in pools.items():
                hm = QuantKVCache(*(t.clone().to(d) for t in pool), pos.clone().to(d))
                logits[name][f"head_major_b{b}"], _ = llama.forward(
                    s, tok.to(d), cfg, caches=hm, positions=pos[0, :, None].to(d),
                    attn_mask=mask.to(d))
            for part, model, (fuse_attn, fuse_mlp) in (
                    [(f"aligned_{n}", "mha", (fa, fm)) for n, fa, fm in COMPOSITIONS]
                    + [("aligned_auto_gqa", "gqa", ("auto", False))]):
                pool, tok, pos, _ = aligned_pools[model]
                hm = QuantKVCache(*(t.clone().to(d) for t in pool), pos[:, 0].clone().to(d))
                tree, c = (s, cfg) if model == "mha" else (tree_to(gqa, d), gqa_cfg)
                logits[name][part], _ = llama.forward(
                    tree, tok.to(d), c, caches=hm,
                    ctx=ForwardContext(fuse_attn=fuse_attn, fuse_mlp=fuse_mlp))
            for recipe, (_, modes, _) in PER_LAYER_PARTS.items():
                q_tree, q_prompt = tree_to(qs[recipe], d), per_layer_prompts[recipe].to(d)
                for compute in modes:
                    ctx = ForwardContext(compute=compute)

                    def per_layer_run():
                        qc = [QuantKVCache.create(2, 256, n_kv, hd, device=d) for _ in range(n_l)]
                        pre, qc = llama.forward(q_tree, q_prompt, cfg, caches=qc, ctx=ctx)
                        step, _ = llama.forward(q_tree, q_prompt[:, -1:], cfg, caches=qc, ctx=ctx)
                        return torch.cat([pre, step], dim=1)

                    part = f"per_layer_{recipe}_{compute}"
                    if name == "plain":
                        logits[name][part] = per_layer_run()
                        continue
                    logits[name][part], used = _path_launches(per_layer_run)
                    k11_counter = k11_key(cfg.torch_dtype, hd, 256)
                    if compute == "auto":
                        meta = qs[recipe]["layers"]["0"]["self_attn"]["q_proj"].meta
                        expect = Counter(quickstart_launches(meta, n_l, q_prompt.numel()))
                        expect.update(quickstart_launches(meta, n_l, 2, 1, k11_counter))
                    else:   # a forced mode runs its kernel at every row count
                        kern = {"int": "int_group_matmul", "dequant": "dual_path_matmul"}[compute]
                        expect = Counter({kern: 14 * n_l, k11_counter: n_l})
                    _check_launches(f"reference check {part}", used, dict(expect))
            logits[name] = {k: v.cpu() for k, v in logits[name].items()}
        res = out[dtype_name] = {}
        for part, ref in logits["plain"].items():
            got = logits["kernel"][part]
            if not (torch.isfinite(got).all() and got.shape == ref.shape
                    and got.shape[-1] == cfg.vocab_size):
                raise AssertionError(f"reference check {part}: non-finite or misshapen logits")
            name = f"reference check {dtype_name} {part}"
            res[part] = dict(argmax_agree=float((got.argmax(-1) == ref.argmax(-1)).float().mean()))
            if part == "generator" or part.startswith(("head_major", "aligned", "per_layer")):
                rel_norm = float((got.float() - ref.float()).norm() / ref.float().norm())
                res[part].update(rel_norm_err=rel_norm, tolerance_rel_norm=tol[part],
                                 max_abs_err=(got.float() - ref.float()).abs().max().item())
                if not rel_norm <= tol[part]:
                    failed.append(f"{name}: relative norm error {rel_norm} > {tol[part]}")
            else:
                try:
                    res[part].update(max_abs_err=_close(name, got, ref, tol[part]),
                                     tolerance_rel_to_max=tol[part])
                except AssertionError as e:
                    failed.append(str(e))
    if failed:
        emit({"phase": "reference_check", "failed": failed, **out})
        raise AssertionError("; ".join(failed))
    return out


def _random_pool(cfg, b, s, gen):
    """A stacked head-major int8 pool of random codes and scales on the CPU,
    with ragged per-slot positions, a key mask with holes and a token per
    slot: ((k_q, v_q, k_scale, v_scale), tok, (L, B) pos, mask)."""
    import torch

    shape = (cfg.num_hidden_layers, b, cfg.num_key_value_heads, s, cfg.head_dim)
    vals = [torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8) for _ in range(2)]
    scales = [torch.rand(shape[:4], generator=gen) * 0.015 + 0.005 for _ in range(2)]
    pos = torch.randint(2, s - 8, (b,), generator=gen, dtype=torch.int32)
    mask = (torch.arange(s)[None, :] <= pos[:, None]) & (torch.rand((b, s), generator=gen) > 0.1)
    mask[torch.arange(b), pos.long()] = True
    tok = torch.randint(0, cfg.vocab_size, (b, 1), generator=gen)
    return (*vals, *scales), tok, pos[None].expand(cfg.num_hidden_layers, b).contiguous(), mask


def _path_launches(fn):
    """Run fn with the launch counts reset just before and read just after:
    (fn's result, the launches of this run)."""
    import torch

    from smoothquant_tpu_torch.kernels import _build

    torch.cuda.synchronize()
    _build.reset_launches()
    r = fn()
    torch.cuda.synchronize()
    return r, dict(_build.LAUNCHES)


def _check_launches(path, launches, expect):
    if launches != expect:
        raise AssertionError(f"{path}: launch counts {launches} != expected {expect}")


def step_launches(cfg, batch, attn, fuse_mlp=False):
    """Kernel launches of one stacked W4A4 decode step of `batch` rows: the
    four linears a layer (two of them and K14's two launches with fuse_mlp) on K1 up to
    K1_MAX_TOKENS rows, above on one launch of K7's row body a site — K7b
    at qkv and gate_up ("rms" up to RAWX_MAX_N rows, "rms_round" above), K7a
    at down — each followed by K5 (o_proj's codes come from torch ops, no
    K7 launch); the cache write and
    attention by `attn`: "smajor" K2 + K3 over the S-major pool, "off" K10 +
    K11 over the head-major one, "auto" K12 + K10 and "fused" K12 alone over
    the aligned head-major cache; and the int8 lm_head on K4 from
    PREFILL_KERNEL_MIN_TOKENS rows (torch._int_mm below)."""
    from smoothquant_tpu_torch.kernels.real_linear import (
        K1_MAX_TOKENS,
        PREFILL_KERNEL_MIN_TOKENS,
    )

    n_l = cfg.num_hidden_layers
    n_lin = 2 if fuse_mlp else 4
    if batch <= K1_MAX_TOKENS:
        out = {"int4_group_matmul_stacked_rawx": n_lin * n_l}
    else:
        out = {"norm_quantize_acts_t": (1 if fuse_mlp else 2) * n_l,
               "int4_group_matmul_stacked": n_lin * n_l}
        if not fuse_mlp:
            out["quantize_acts_grouped_t"] = n_l
    if fuse_mlp:   # K14's stream body: its gate_up and its down launch
        out["mlp_swiglu_fused_stacked"] = n_l
        out["mlp_swiglu_fused_stacked_down"] = n_l
    if attn == "smajor":
        out.update(write_quant_cache_smajor=n_l, decode_attention_smajor_stacked=n_l)
    elif attn == "off":
        out.update(write_quant_cache_stacked=n_l, decode_attention_stacked=n_l)
    else:
        out["fused_attn"] = n_l
        if attn == "auto":
            out["write_quant_cache_stacked"] = n_l
    if batch >= PREFILL_KERNEL_MIN_TOKENS:
        out["int8_prefill_matmul"] = 1
    return out


def serve(prefill_tree, stacked, cfg, dev, *, promoted: bool, batch=MAX_BATCH,
          smajor=True, n_requests=8, decode_window=None):
    """Serve requests through ContinuousBatcher(max_batch=batch, quant_kv=True,
    smajor), prefilling on `prefill_tree` (the nibble tree, or its promoted
    int8 twin): a warm wave, then n_requests of 100-240 prompt tokens and 32
    new, chunk 8.  Returns metrics and the launches of the measured run,
    checked against what the path implies; with decode_window (default: the
    nibble prefill), also decode ms/step over a steady decode-only window and
    its device busy time."""
    import numpy as np
    import torch

    from smoothquant_tpu_torch.kernels.real_linear import PREFILL_KERNEL_MIN_TOKENS
    from smoothquant_tpu_torch.models import llama
    from smoothquant_tpu_torch.serve.batching import ContinuousBatcher, Request

    batcher = ContinuousBatcher(llama, stacked, cfg, max_batch=batch,
                                max_len=MAX_LEN, quant_kv=True,
                                prefill_params=prefill_tree, smajor=smajor, device=dev)
    prefill = {"rows": [], "seqs": [], "tokens": 0, "s": 0.0}
    inner = batcher._prefill

    def timed_prefill(ids, lens):
        t0 = time.perf_counter()
        r = inner(ids, lens)
        torch.cuda.synchronize()
        prefill["s"] += time.perf_counter() - t0
        prefill["rows"].append(ids.shape[0] * ids.shape[1])
        prefill["seqs"].append(ids.shape[0])
        prefill["tokens"] += int(np.minimum(lens, ids.shape[1]).sum())
        return r

    batcher._prefill = timed_prefill
    rng = np.random.default_rng(SEED + 42)

    def make(n, uid0, new):
        return [Request(uid=uid0 + i, prompt=rng.integers(
            0, cfg.vocab_size, size=(int(rng.integers(100, 240)),)),
            max_new_tokens=new) for i in range(n)]

    for r in make(batch, 1000, 8):                 # warm-up wave
        batcher.submit(r)
    batcher.run_to_completion(chunk=8)
    torch.cuda.synchronize()

    reqs = make(n_requests, 0, 32)
    for r in reqs:
        batcher.submit(r)
    prefill.update(rows=[], seqs=[], tokens=0, s=0.0)
    steps0 = batcher._steps
    t0 = time.perf_counter()
    _, launches = _path_launches(lambda: batcher.run_to_completion(chunk=8))
    wall = time.perf_counter() - t0
    steps = batcher._steps - steps0
    toks = [t for r in reqs for t in r.generated]
    if not (all(r.done and len(r.generated) == 32 for r in reqs)
            and all(0 <= t < cfg.vocab_size for t in toks)):
        raise AssertionError("serving: unfinished request or token out of range")
    n_l = cfg.num_hidden_layers
    per_step = step_launches(cfg, batch, "smajor" if smajor else "off")
    expect = {k: v * steps for k, v in per_step.items()}
    # K4 runs the promoted prefill's linears of rows × bucket at or above
    # PREFILL_KERNEL_MIN_TOKENS, and the int8 lm_head of a prefill (each
    # row's last position only) or a decode step from that many rows
    k4 = expect.get("int8_prefill_matmul", 0) + sum(
        n >= PREFILL_KERNEL_MIN_TOKENS for n in prefill["seqs"])
    if promoted:
        k4 += 4 * n_l * sum(n >= PREFILL_KERNEL_MIN_TOKENS for n in prefill["rows"])
    else:
        expect["int4_group_matmul"] = 4 * n_l * len(prefill["rows"])
    if k4:
        expect["int8_prefill_matmul"] = k4
    _check_launches("serving", launches, expect)
    metrics = dict(
        prefill_tree="promoted int8" if promoted else "nibble",
        pool="S-major" if smajor else "head-major", max_batch=batch,
        requests=len(reqs), generated_tokens=len(toks), decode_steps=steps,
        launches_per_step=per_step, prefill_rows=prefill["rows"], serving_wall_s=wall,
        serving_tokens_per_s=len(toks) / wall,
        prefill_tokens_per_s=prefill["tokens"] / prefill["s"])
    if decode_window if decode_window is not None else not promoted:
        steady = make(batch, 2000, 64)             # decode-only window
        for r in steady:
            batcher.submit(r)
        batcher.step_chunk(8)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(4):
            batcher.step_chunk(8)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t1
        trace = profile(lambda: batcher.step_chunk(4), 4)
        metrics.update(decode_ms_per_step=1e3 * decode_s / 32,
                       decode_tokens_per_s=32 * batch / decode_s,
                       busy_share=1.0 - trace["idle_share"], decode_trace=trace)
    batcher.run_to_completion(chunk=8)
    return metrics, launches


def profile(fn, steps: int) -> dict:
    """Device time of fn (`steps` decode steps) under torch.profiler: busy
    ms per step (the device events' durations summed), beside it the union
    of their spans (busy_union_ms_per_step: a kernel launched as a
    programmatic dependent starts before its primary ends, and the sum
    counts that overlap twice), the device events per step (every kernel
    the step launched, torch's included), the idle share of the wall time
    (by the sum), and the kernels that take the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name: dict = {}
    spans = []
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.time_range.elapsed_us()
            spans.append((ev.time_range.start, ev.time_range.end))
    union_us, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            union_us += b - a
            end = b
        elif b > end:
            union_us += b - end
            end = b
    busy_ms = sum(by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return dict(steps=steps, wall_ms_per_step=1e3 * wall / steps,
                busy_ms_per_step=busy_ms / steps, busy_union_ms_per_step=union_us / 1e3 / steps,
                kernels_per_step=len(spans) / steps,
                idle_share=1.0 - busy_ms / (1e3 * wall),
                top_ms_per_step=[[name[:60], us / 1e3 / steps] for name, us in top])


def aligned_decoder(tree, cache, cfg, dev, path: str, expect_per_step: dict, ctx=None):
    """A decode step of the cache's B rows over a stacked cache filled to
    the bench's aligned position (in the composition ctx names): warmed up,
    its launches checked; returns (step(n), the launches of one step)."""
    import torch

    from smoothquant_tpu_torch.models import llama

    b = (cache.k if hasattr(cache, "k") else cache.k_q).shape[1]
    tok = torch.randint(0, cfg.vocab_size, (b, 1), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(SEED + 5))

    @torch.no_grad()
    def step(n=1):
        nonlocal tok
        for _ in range(n):
            h, _ = llama.forward_hidden(tree, tok, cfg, caches=cache, ctx=ctx)
            tok = torch.argmax(llama.lm_head_logits(tree, h, cfg)[:, -1], dim=-1)[:, None]
        if not (0 <= int(tok.min()) and int(tok.max()) < cfg.vocab_size):
            raise AssertionError(f"{path}: token out of range")

    step(2)                                        # warm-up
    _, launches = _path_launches(step)
    _check_launches(path, launches, expect_per_step)
    return step, launches


def decode_windows(steps: dict, n_windows=3, window=8, batch=MAX_BATCH) -> dict:
    """ms/step of each decoder over `window` steps, the decoders taking
    turns window by window (host clock, which moves between runs of one
    tree), then each one's device busy time under torch.profiler."""
    import torch

    out = {name: {"windows_ms_per_step": []} for name in steps}
    for _ in range(n_windows):
        for name, step in steps.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(window)
            torch.cuda.synchronize()
            out[name]["windows_ms_per_step"].append(1e3 * (time.perf_counter() - t0) / window)
    for name, step in steps.items():
        ms = statistics.median(out[name]["windows_ms_per_step"])
        trace = profile(lambda: step(4), 4)
        out[name].update(ms_per_step=ms, tokens_per_s=batch * 1e3 / ms,
                         busy_ms_per_step=trace["busy_ms_per_step"],
                         kernels_per_step=trace.get("kernels_per_step"), trace=trace)
    return out


def slot_decode(stacked, cfg, dev, card):
    """B = SLOT_BATCH decode steps from DECODE_POS with the same tree over
    the head-major pool (per-slot positions: K10 + K11), the S-major one
    (K2 + K3) and the aligned head-major cache ((L,) positions, fuse_attn
    "auto": K12's flat body + K10), taking turns window by window; then a
    few steps of MID_BATCH rows over the head-major pool, whose linears take
    K7b / K7a + K5 (K1's codes).  The caches are freed before the next is
    made; the MID_BATCH steps by host clock over windows and by device busy
    (summed and as the union of spans), as the others.  The head-major
    SLOT_BATCH step and the MID_BATCH one are profiled once more on the
    activation prep's route before (_old_route_profile), and on the cache
    write's route before (_old_write_profile).  Returns the launches of the
    counted steps."""
    from collections import Counter

    import torch

    from smoothquant_tpu_torch.models import llama
    from smoothquant_tpu_torch.models.common import ForwardContext

    launches = Counter()
    steps = {}
    caches = {}
    for name, smajor, attn in (("head_major", False, "off"), ("s_major", True, "smajor"),
                               ("aligned_head_major", False, "auto")):
        caches[name] = llama.stacked_caches(cfg, SLOT_BATCH, MAX_LEN, pos=DECODE_POS,
                                            quant_kv=True, smajor=smajor,
                                            per_slot=attn != "auto", device=dev)
        steps[name], used = aligned_decoder(
            stacked, caches[name], cfg, dev, f"{name} decode step B={SLOT_BATCH}",
            step_launches(cfg, SLOT_BATCH, attn), ctx=ForwardContext(fuse_attn="auto"))
        launches.update(used)
    dec = decode_windows(steps, batch=SLOT_BATCH)
    for name, cache in caches.items():
        emit({"phase": f"slot_{name}_decode", "card": card, "batch": SLOT_BATCH,
              "cache": MAX_LEN, "positions": [DECODE_POS, int(cache.pos.flatten()[0])],
              **dec[name]})
    for name in ("head_major", "aligned_head_major"):
        emit({"phase": f"slot_{name}_vs_s_major", "card": card,
              "host_clock": dec[name]["ms_per_step"] / dec["s_major"]["ms_per_step"],
              "device_busy": (dec[name]["busy_ms_per_step"]
                              / dec["s_major"]["busy_ms_per_step"])})
    emit({"phase": "slot_head_major_old_route", "card": card, "batch": SLOT_BATCH,
          "new_route": dec["head_major"]["trace"],
          "old_route": _old_route_profile(steps["head_major"]),
          "old_write_route": _old_write_profile(steps["head_major"])})
    del steps, caches, dec
    torch.cuda.empty_cache()
    mid = llama.stacked_caches(cfg, MID_BATCH, MAX_LEN, pos=DECODE_POS, quant_kv=True,
                               smajor=False, per_slot=True, device=dev)
    step, used = aligned_decoder(stacked, mid, cfg, dev, f"head-major decode step "
                                 f"B={MID_BATCH}", step_launches(cfg, MID_BATCH, "off"))
    launches.update(used)
    dec = decode_windows({"mid": step}, batch=MID_BATCH)["mid"]
    emit({"phase": "mid_decode", "card": card, "batch": MID_BATCH, "cache": MAX_LEN,
          "launches_per_step": used, "positions": [DECODE_POS, int(mid.pos.flatten()[0])],
          **dec, "old_route": _old_route_profile(step),
          "old_write_route": _old_write_profile(step)})
    return launches


def aligned_decode(stacked, w4a4_step, cfg, dev, card):
    """The aligned stacked head-major int8 decode at B = MAX_BATCH from
    DECODE_POS in each of COMPOSITIONS ("auto": K12's flat body + K10;
    "fused": K12's write body; "off": K10 + K11; "auto" with fuse_mlp: K14
    in place of the MLP's two K1 launches and SiLU·up), taking turns window
    by window with the S-major W4A4 step (K2 + K3): ms/step by host clock,
    device busy ms, idle share and launches per step of each; then each
    composition against "off".  Returns the launches of the counted steps."""
    from collections import Counter

    from smoothquant_tpu_torch.models import llama
    from smoothquant_tpu_torch.models.common import ForwardContext

    launches = Counter()
    steps = {"s_major": w4a4_step}
    caches, per_step = {}, {}
    for name, fuse_attn, fuse_mlp in COMPOSITIONS:
        caches[name] = llama.stacked_caches(cfg, MAX_BATCH, MAX_LEN, pos=DECODE_POS,
                                            quant_kv=True, smajor=False, device=dev)
        steps[name], per_step[name] = aligned_decoder(
            stacked, caches[name], cfg, dev, f"aligned {name} decode step",
            step_launches(cfg, MAX_BATCH, fuse_attn, fuse_mlp),
            ctx=ForwardContext(fuse_attn=fuse_attn, fuse_mlp=fuse_mlp))
        launches.update(per_step[name])
    dec = decode_windows(steps)
    for name, cache in caches.items():
        emit({"phase": f"aligned_{name}_decode", "card": card, "batch": MAX_BATCH,
              "cache": MAX_LEN, "positions": [DECODE_POS, int(cache.pos.flatten()[0])],
              "launches_per_step": per_step[name], **dec[name]})
    off = dec["off"]
    emit({"phase": "aligned_vs_off", "card": card, "s_major": {
        "ms_per_step": dec["s_major"]["ms_per_step"],
        "busy_ms_per_step": dec["s_major"]["busy_ms_per_step"],
        "idle_share": dec["s_major"]["trace"]["idle_share"]}, **{name: {
            "launches_per_step": sum(per_step[name].values()),
            "host_clock_vs_off": dec[name]["ms_per_step"] / off["ms_per_step"],
            "device_busy_vs_off": dec[name]["busy_ms_per_step"] / off["busy_ms_per_step"],
            "idle_share": dec[name]["trace"]["idle_share"]} for name in caches}})
    return launches


def full_prefill(promoted, cfg, dev):
    """One 1024-token prompt through the promoted tree with no cache,
    logits for every position (bench.py:256-331): tokens/s, launches, and
    one prefill under torch.profiler."""
    import torch

    from smoothquant_tpu_torch.models import llama

    ids = torch.randint(0, cfg.vocab_size, (1, PREFILL_N), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(SEED + 11))
    run = torch.no_grad()(lambda: llama.forward(promoted, ids, cfg)[0])
    logits = run()                                 # warm-up
    logits, launches = _path_launches(run)
    _check_launches("full-model prefill", launches,
                    {"int8_prefill_matmul": 4 * cfg.num_hidden_layers + 1})
    if not (logits.shape == (1, PREFILL_N, cfg.vocab_size) and torch.isfinite(logits).all()):
        raise AssertionError("full-model prefill: non-finite or misshapen logits")
    del logits
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    s = statistics.median(times)
    return dict(tokens=PREFILL_N, layers=cfg.num_hidden_layers, ms=1e3 * s,
                prefill_tokens_per_s=PREFILL_N / s, runs_ms=[1e3 * t for t in times],
                trace=profile(run, 1)), launches


def generator(packed, promoted, cfg, dev):
    """The Generator: 4 prompts of 200 tokens, 32 new, prefill on the
    promoted tree, decode on the per-layer nibble tree over head-major int8
    caches; tokens/s and the launches checked."""
    import numpy as np
    import torch

    from smoothquant_tpu_torch.kernels.real_linear import PREFILL_KERNEL_MIN_TOKENS
    from smoothquant_tpu_torch.models import llama
    from smoothquant_tpu_torch.serve.generate import GenerationConfig, Generator

    gen = Generator(llama, packed, cfg, max_len=GEN_MAX_LEN, quant_kv=True,
                    prefill_params=promoted, device=dev)
    prompts = np.random.default_rng(SEED + 3).integers(0, cfg.vocab_size,
                                                       size=(MAX_BATCH, GEN_PROMPT))
    gen.generate(prompts[:, :16], GenerationConfig(max_new_tokens=2))    # warm-up
    t0 = time.perf_counter()
    out, launches = _path_launches(
        lambda: gen.generate(prompts, GenerationConfig(max_new_tokens=GEN_NEW)))
    wall = time.perf_counter() - t0
    n_l, steps = cfg.num_hidden_layers, GEN_NEW - 1
    # the prefill's lm_head runs on all 800 rows (K4), decode's on 4 (K4 from
    # PREFILL_KERNEL_MIN_TOKENS rows)
    _check_launches("generator", launches, {
        "int8_prefill_matmul": 4 * n_l + 1 + steps * (MAX_BATCH >= PREFILL_KERNEL_MIN_TOKENS),
        "int4_group_matmul": 4 * n_l * steps, "decode_attention_stacked": n_l * steps})
    new = out[:, GEN_PROMPT:]
    if not (out.shape == (MAX_BATCH, GEN_PROMPT + GEN_NEW)
            and (out[:, :GEN_PROMPT] == prompts).all()
            and ((0 <= new) & (new < cfg.vocab_size)).all()):
        raise AssertionError("generator: misshapen output or token out of range")
    return dict(batch=MAX_BATCH, prompt=GEN_PROMPT, new_tokens=GEN_NEW, wall_s=wall,
                tokens_per_s=MAX_BATCH * GEN_NEW / wall), launches


# ---------------------------------------------------------------- OPT path


def _opt_per_forward(cfg, rows: int, keys: int) -> dict:
    """Kernel launches of one int8 OPT forward of `rows` query rows over
    `keys` key positions (the prompt, or a whole cache): per layer two K16,
    six K15a and two K15b, QKᵀ and PV each counted under the body
    int8.bmm_body takes for it (the glue between them is plain PyTorch)."""
    from collections import Counter

    import torch

    from smoothquant_tpu_torch.kernels import int8 as k15

    n_l, d = cfg.num_hidden_layers, cfg.head_dim
    out = Counter({"norm_quant": 2 * n_l, "int8_linear": 6 * n_l})
    out[k15.BMM_LAUNCH_KEYS[k15.bmm_body(rows, keys, d, False, torch.float32)]] += n_l
    out[k15.BMM_LAUNCH_KEYS[k15.bmm_body(rows, d, keys, True, torch.int8)]] += n_l
    return dict(out)


def export_opt(cfg, dev, n_samples, seq_len):
    """The export pipeline of export_int8_model.py:48-76 on a random OPT
    built on `dev` from SEED: calibration (per-channel absmax) → smooth_lm
    (α = 0.5) → static per-tensor absmax → the seven scales a layer →
    opt_int8.from_float.  Returns (smoothed fp params, int8 params, timings)."""
    import numpy as np
    import torch

    from smoothquant_tpu_torch.models import opt, opt_int8
    from smoothquant_tpu_torch.models.common import ForwardContext
    from smoothquant_tpu_torch.models.registry import smooth_lm
    from smoothquant_tpu_torch.quant import calibrate as cal

    t = {}
    t0 = time.perf_counter()
    fp = opt.init_params(torch.Generator(device=dev).manual_seed(SEED), cfg, dev)
    stream = np.random.default_rng(SEED + 21).integers(0, cfg.vocab_size,
                                                       size=n_samples * seq_len)
    batches = [torch.as_tensor(b, device=dev)
               for b in cal.make_calib_batches(stream, n_samples, seq_len)]

    def fwd(p, ids, col):
        opt.forward(p, ids, cfg, ctx=ForwardContext(taps=col))

    torch.cuda.synchronize()
    t["init_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    act_scales = cal.get_act_scales(fwd, fp, batches)
    t["act_scales_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    smoothed = smooth_lm("opt", fp, cfg, act_scales, alpha=0.5)
    del fp
    act_dict = cal.get_static_act_dict(fwd, smoothed, batches)
    scales = cal.get_static_decoder_layer_scales_opt(act_dict, cfg.num_hidden_layers)
    t["smooth_static_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    int8 = opt_int8.from_float(smoothed, cfg, scales)
    torch.cuda.synchronize()
    t["from_float_s"] = time.perf_counter() - t0
    t["calib_samples"], t["calib_len"] = len(batches), seq_len
    return smoothed, int8, t


def opt_int8_to(tree, dev):
    """An int8 OPT tree (opt_int8.from_float's) on `dev`."""
    import dataclasses

    from smoothquant_tpu_torch.models.opt_int8 import Int8Linear

    def to(node):
        if isinstance(node, Int8Linear):
            return dataclasses.replace(node, w_q=node.w_q.to(dev), bias=node.bias.to(dev))
        return node.to(dev) if hasattr(node, "to") else node

    out = tree_to({k: v for k, v in tree.items() if k != "int8_layers"}, dev)
    out["int8_layers"] = [dataclasses.replace(lp, **{f.name: to(getattr(lp, f.name))
                                                     for f in dataclasses.fields(lp)})
                          for lp in tree["int8_layers"]]
    return out


def opt_reference_check(dev):
    """The int8 OPT's kernel path (card) vs its plain path (CPU) on a small
    model exported once on the CPU (hidden 512, 8 heads of 64, 2 layers),
    from bf16 and from f32 weights: a 48-token prefill of two rows into
    int8 caches, then one decode step, logits compared.  The kernels are
    exact against their plain versions but for K16's rare one-code moves,
    and the glue's exp differs in the last bit between the CPU and the
    card; a moved code spreads through attention, so the logits are held
    to 5e-2 of their norm — a wrong kernel misses by the whole norm."""
    import dataclasses

    import torch

    from smoothquant_tpu_torch.models import opt, opt_int8
    from smoothquant_tpu_torch.models.common import KVCache

    out = {}
    for dtype_name in ("bfloat16", "float32"):
        cfg = dataclasses.replace(opt.OPTConfig.tiny(vocab_size=512), hidden_size=512,
                                  ffn_dim=1024, num_attention_heads=8, dtype=dtype_name)
        _, int8, _ = export_opt(cfg, "cpu", 2, 64)
        gen = torch.Generator().manual_seed(SEED + 31)
        prompt = torch.randint(0, cfg.vocab_size, (2, 48), generator=gen)
        logits = {}
        for name, d in (("plain", "cpu"), ("kernel", dev)):
            tree = opt_int8_to(int8, d)
            caches = [KVCache.create(2, 64, cfg.num_attention_heads, cfg.head_dim,
                                     torch.int8, d) for _ in range(cfg.num_hidden_layers)]
            pre, caches = opt_int8.forward(tree, prompt.to(d), cfg, caches=caches)
            step, _ = opt_int8.forward(tree, prompt[:, -1:].to(d), cfg, caches=caches)
            logits[name] = torch.cat([pre[:, -1:], step], dim=1).cpu()
        got, ref = logits["kernel"], logits["plain"]
        if not (torch.isfinite(got).all() and got.shape == ref.shape == (2, 2, cfg.vocab_size)):
            raise AssertionError("OPT reference check: non-finite or misshapen logits")
        rel = float((got - ref).norm() / ref.norm())
        if not rel <= 5e-2:
            raise AssertionError(f"OPT reference check {dtype_name}: relative norm error "
                                 f"{rel} > 5e-2")
        out[dtype_name] = dict(rel_norm_err=rel, tolerance_rel_norm=5e-2,
                               argmax_agree=float((got.argmax(-1) == ref.argmax(-1))
                                                  .float().mean()))
    return out


def opt_accuracy(smoothed, int8, cfg, dev):
    """The reference demo's check: the int8 model's logits against the
    smoothed fp model's on one prompt of OPT_PROMPT tokens — top-1
    agreement and relative norm error of the logits — and the same on the
    prompt's first 32 tokens.  (With random weights attention is nearly
    uniform, so over S keys p ≈ 1/S and round(p·127) is mostly 0 at S =
    512: the int8 probabilities of the reference's design lose it.)"""
    import torch

    from smoothquant_tpu_torch.models import opt, opt_int8

    ids = torch.randint(0, cfg.vocab_size, (1, OPT_PROMPT), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(SEED + 13))
    out = {}
    for s in (OPT_PROMPT, 32):
        with torch.no_grad():
            fp = opt.forward(smoothed, ids[:, :s], cfg)[0]
            q, launches = _path_launches(lambda: opt_int8.forward(int8, ids[:, :s], cfg)[0])
        _check_launches("int8 OPT forward", launches, _opt_per_forward(cfg, s, s))
        if not (q.shape == fp.shape == (1, s, cfg.vocab_size)
                and torch.isfinite(q).all() and torch.isfinite(fp).all()):
            raise AssertionError("int8 OPT forward: non-finite or misshapen logits")
        out[f"tokens_{s}"] = dict(
            top1_agree=float((q.argmax(-1) == fp.argmax(-1)).float().mean()),
            rel_norm_err=float((q - fp).norm() / fp.norm()))
    return out


def opt_prefill(smoothed, int8, cfg, dev):
    """The int8 prefill of OPT_BATCH × OPT_PROMPT tokens with no cache
    (tokens/s by host clock, device busy share under the profiler), and the
    bf16 fp forward of the same batch as the yardstick."""
    import torch

    from smoothquant_tpu_torch.models import opt, opt_int8

    ids = torch.randint(0, cfg.vocab_size, (OPT_BATCH, OPT_PROMPT), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(SEED + 17))
    runs = {"int8": torch.no_grad()(lambda: opt_int8.forward(int8, ids, cfg)[0]),
            "fp_bf16": torch.no_grad()(lambda: opt.forward(smoothed, ids, cfg)[0])}
    runs["int8"]()                                       # warm-up
    logits, launches = _path_launches(runs["int8"])
    _check_launches("int8 OPT prefill", launches, _opt_per_forward(cfg, OPT_PROMPT, OPT_PROMPT))
    if not (logits.shape == (OPT_BATCH, OPT_PROMPT, cfg.vocab_size)
            and torch.isfinite(logits).all()):
        raise AssertionError("int8 OPT prefill: non-finite or misshapen logits")
    del logits
    out = {}
    for name, run in runs.items():
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        s = statistics.median(times)
        trace = profile(run, 1)
        out[name] = dict(ms=1e3 * s, runs_ms=[1e3 * t for t in times],
                         tokens_per_s=OPT_BATCH * OPT_PROMPT / s,
                         busy_share=1.0 - trace["idle_share"], trace=trace)
    return dict(batch=OPT_BATCH, prompt=OPT_PROMPT, layers=cfg.num_hidden_layers,
                **out), launches


def opt_generator(int8, cfg, dev):
    """Generator(kv_dtype=int8) over the int8 OPT: OPT_BATCH prompts of
    OPT_PROMPT tokens, OPT_NEW new, caches of OPT_MAX_LEN; tokens/s of the
    whole generate call, then decode ms/step of the Generator's own step by
    host clock over windows and by device busy time, and one step's
    launches."""
    from collections import Counter

    import numpy as np
    import torch

    from smoothquant_tpu_torch.models import opt_int8
    from smoothquant_tpu_torch.serve.generate import GenerationConfig, Generator
    from smoothquant_tpu_torch.utils import roofline

    g = Generator(opt_int8, int8, cfg, kv_dtype=torch.int8, max_len=OPT_MAX_LEN, device=dev)
    prompts = np.random.default_rng(SEED + 19).integers(0, cfg.vocab_size,
                                                        size=(OPT_BATCH, OPT_PROMPT))
    g.generate(prompts[:, :16], GenerationConfig(max_new_tokens=2))       # warm-up
    t0 = time.perf_counter()
    out, launches = _path_launches(
        lambda: g.generate(prompts, GenerationConfig(max_new_tokens=OPT_NEW)))
    wall = time.perf_counter() - t0
    expect = Counter(_opt_per_forward(cfg, OPT_PROMPT, OPT_MAX_LEN))
    for k, v in _opt_per_forward(cfg, 1, OPT_MAX_LEN).items():
        expect[k] += v * (OPT_NEW - 1)
    _check_launches("int8 OPT generator", launches, dict(expect))
    new = out[:, OPT_PROMPT:]
    if not (out.shape == (OPT_BATCH, OPT_PROMPT + OPT_NEW)
            and (out[:, :OPT_PROMPT] == prompts).all()
            and ((0 <= new) & (new < cfg.vocab_size)).all()):
        raise AssertionError("int8 OPT generator: misshapen output or token out of range")

    caches = g._new_caches(OPT_BATCH)
    tok, caches = g._step(g.params, torch.as_tensor(prompts, device=dev), caches, 0.0, None)

    def step(n=1):
        nonlocal tok, caches
        for _ in range(n):
            tok, caches = g._step(g.params, tok[:, None], caches, 0.0, None)

    step(2)                                                               # warm-up
    _, per_step = _path_launches(step)
    _check_launches("int8 OPT decode step", per_step, _opt_per_forward(cfg, 1, OPT_MAX_LEN))
    windows = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        step(8)
        torch.cuda.synchronize()
        windows.append(1e3 * (time.perf_counter() - t1) / 8)
    trace = profile(lambda: step(4), 4)
    ms = statistics.median(windows)
    bound = roofline.opt_int8_decode_step_bytes(cfg, OPT_BATCH, OPT_MAX_LEN)
    return dict(batch=OPT_BATCH, prompt=OPT_PROMPT, new_tokens=OPT_NEW, tokens=out,
                max_len=OPT_MAX_LEN, generate_wall_s=wall,
                generate_tokens_per_s=OPT_BATCH * OPT_NEW / wall,
                decode_ms_per_step=ms, decode_windows_ms_per_step=windows,
                decode_tokens_per_s=OPT_BATCH * 1e3 / ms,
                busy_ms_per_step=trace["busy_ms_per_step"], trace=trace,
                launches_per_step=per_step, step_bytes=bound["total"],
                step_bound_ms=bound["bound_ms"],
                position_after=int(caches[0].pos)), launches


def run_opt(dev, cfg, card: str):
    """The real-INT8 OPT path at the size of `cfg`: export, the kernel
    phases at its shapes, the accuracy check, the int8 prefill, the
    smoothed tree's serving (the fp batcher; the W4A4 serving pack's
    stacked decode and per-layer Generator, opt_stacked) and the int8
    Generator.  Returns (kernel rows, the main path's launches)."""
    from collections import Counter

    import torch

    from smoothquant_tpu_torch.kernels import int8 as k15
    from smoothquant_tpu_torch.utils import roofline

    t0 = time.perf_counter()
    smoothed, int8, timings = export_opt(cfg, dev, CALIB_SAMPLES, CALIB_LEN)
    emit({"phase": "opt_export", "seconds": time.perf_counter() - t0, **timings,
          "layers": cfg.num_hidden_layers, "hidden": cfg.hidden_size,
          "gib_allocated": torch.cuda.memory_allocated() / 2 ** 30,
          "decode_step_bytes": roofline.opt_int8_decode_step_bytes(cfg, OPT_BATCH,
                                                                   OPT_MAX_LEN)})
    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    rows = (check_int8_linear(int8, dev, gen) + check_int8_bmm(int8, cfg, dev, gen)
            + check_norm_quant(int8, cfg, dev, gen))
    emit({"phase": "k15b_edges", "bit_exact_cases": check_k15b_edges(dev)})
    emit({"phase": "k15a_edges", **check_k15a_edges(dev)})
    emit({"phase": "k16_edges", **check_k16_edges(dev)})
    emit({"phase": "k15a_row_crossover", "card": card,
          "stream_max_rows": k15.STREAM_MAX_ROWS, **k15a_row_crossover(int8, dev, gen)})
    emit({"phase": "opt_reference_check", **opt_reference_check(dev)})
    emit({"phase": "opt_accuracy", "card": card, **opt_accuracy(smoothed, int8, cfg, dev)})

    launches = Counter()
    pf, used = opt_prefill(smoothed, int8, cfg, dev)
    launches.update(used)
    emit({"phase": "opt_prefill", "card": card, **pf, "launches": used})
    from smoothquant_tpu_torch.models import opt

    sp_tree, sp_cfg = first_layers(smoothed, cfg)
    serve_family("opt", opt, sp_tree, sp_tree, sp_cfg, dev, card, max_len=OPT_SERVE_LEN)
    del sp_tree
    more_rows, used = opt_stacked(smoothed, cfg, dev, card)
    rows += more_rows
    launches.update(used)
    del smoothed
    torch.cuda.empty_cache()
    g, used = opt_generator(int8, cfg, dev)
    gen_tokens = g.pop("tokens")
    launches.update(used)
    emit({"phase": "opt_generator", "card": card, **g, "launches": used})
    launches.update(cli_opt(int8, gen_tokens, cfg, dev, card))
    return rows, launches


# ---------------------------------------------------------------- Bloom path


def bloom_7b1():
    """BLOOM-7b1 at its published widths and depth (bigscience/bloom-7b1
    config.json: n_embed 4096, n_layer 30, n_head 32, vocab 250880,
    layer_norm_epsilon 1e-5, tied embeddings); nothing cut."""
    from smoothquant_tpu_torch.models.bloom import BloomConfig

    return BloomConfig(hidden_size=4096, num_hidden_layers=30, num_attention_heads=32)


def bloom_recipe():
    """The Bloom path's pack: W4A4 g64, 5 % salient channels (f32 scales)."""
    from smoothquant_tpu_torch.quant.config import w4a4_group

    return w4a4_group(group_size=64, salient_prop=0.05)


def _launched(key, fn):
    """fn() — a wrapper call that must add exactly one launch to `key`."""
    from smoothquant_tpu_torch.kernels import _build

    before = _build.LAUNCHES[key]
    out = fn()
    if _build.LAUNCHES[key] != before + 1:
        raise AssertionError(f"{key}: the counter moved {_build.LAUNCHES[key] - before}, not 1")
    return out


def build_bloom(cfg, dev, n_samples=BLOOM_SAMPLES, seq_len=BLOOM_LEN):
    """The Bloom path's model on `dev`: random fp weights (seed SEED), the
    calibration taps (get_act_scales, get_calib_feat on n_samples random
    sequences of seq_len tokens), smooth_lm("bloom", α = BLOOM_ALPHA) and
    pack_model("bloom", bloom_recipe(), nibble, k groups aligned to 8, O to
    256).  Returns (fp tree, packed tree, seconds of each step)."""
    import numpy as np
    import torch

    from smoothquant_tpu_torch.models import bloom
    from smoothquant_tpu_torch.models.common import ForwardContext
    from smoothquant_tpu_torch.models.registry import pack_model, smooth_lm
    from smoothquant_tpu_torch.quant.calibrate import get_act_scales, get_calib_feat

    seconds = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        return r

    fp = timed("init", lambda: bloom.init_params(torch.Generator(device=dev).manual_seed(SEED),
                                                 cfg, dev))
    rng = np.random.default_rng(SEED + 43)
    batches = [rng.integers(0, cfg.vocab_size, size=(1, seq_len)) for _ in range(n_samples)]

    def fwd(p, ids, col):
        return bloom.forward(p, torch.as_tensor(ids, device=dev), cfg,
                             ctx=ForwardContext(taps=col))

    scales = timed("act_scales", lambda: get_act_scales(fwd, fp, batches))
    feat = timed("calib_feat", lambda: get_calib_feat(fwd, fp, batches))
    smoothed = timed("smooth_lm", lambda: smooth_lm("bloom", fp, cfg, scales, alpha=BLOOM_ALPHA))
    packed = timed("pack_model", lambda: pack_model(
        "bloom", smoothed, cfg, bloom_recipe(), input_feat=feat, act_scales=scales,
        **BLOOM_PACK))
    return fp, packed, seconds


def bloom_step_launches(cfg, batch):
    """Kernel launches of one stacked Bloom decode step of `batch` rows: the
    four linears a layer (their input gathered, no fused norm) on K1 up to
    K1_MAX_TOKENS rows, above on K7a's row body (the salient split and the
    quantize in one launch) + K5; K10 (rotary off) and K11's ALiBi body a
    layer."""
    from smoothquant_tpu_torch.kernels.real_linear import K1_MAX_TOKENS

    n_l = cfg.num_hidden_layers
    if batch <= K1_MAX_TOKENS:
        out = {"int4_group_matmul_stacked_rawx": 4 * n_l}
    else:
        out = {"quantize_acts_grouped_t": 4 * n_l, "int4_group_matmul_stacked": 4 * n_l}
    out.update(write_quant_cache_stacked=n_l, decode_attention_stacked_alibi=n_l)
    return out


def check_decode_attention_alibi(cfg, dev, gen):
    """K11's ALiBi body vs its plain version at the Bloom path's shapes:
    B = BLOOM_BATCH over BLOOM_MAX_LEN positions (five 128-wide tiles) and
    B = BLOOM_SLOT_BATCH over MAX_LEN, the bf16 and the int8 body, slopes of
    the model's heads, positions near the end (where slope·position is
    largest: ~0.7 × 639 for head 0).  Tolerance 1e-2 of the largest output
    (a bf16 output; the q·k sums in another order move the ~450-sized
    scores by an ulp of their magnitude).  Yardstick: SDPA over the
    (dequantized) bf16 cache with the slope term and validity as its
    additive float mask."""
    import torch
    import torch.nn.functional as F

    from smoothquant_tpu_torch.kernels import decode_attention as k11
    from smoothquant_tpu_torch.models import bloom
    from smoothquant_tpu_torch.models.common import KVCache, QuantKVCache, decode_bias
    from smoothquant_tpu_torch.utils import roofline

    h, d, n_l = cfg.num_attention_heads, cfg.head_dim, 4
    slopes = torch.as_tensor(bloom.alibi_slopes(h), device=dev)
    rows = []
    for b, s in ((BLOOM_BATCH, BLOOM_MAX_LEN), (BLOOM_SLOT_BATCH, MAX_LEN)):
        pos = torch.randint(s - 64, s, (b,), generator=gen, device=dev)
        pos[0] = s - 1
        bias = decode_bias(pos, b, s, None)
        valid = (bias == 0)[:, None, None, :]
        alibi = slopes[None, :, None, None] * torch.arange(s, device=dev).float()
        lib_mask = torch.where(valid, alibi, float("-inf")).to(torch.bfloat16)
        q = torch.randn((b, h, d), generator=gen, device=dev).to(torch.bfloat16)
        for body in ("bf16", "int8"):
            if body == "bf16":
                c = KVCache.create(b, s, h, d, torch.bfloat16, dev, n_layers=n_l)
                for t in (c.k, c.v):
                    t.copy_(torch.randn(t.shape, generator=gen, device=dev))
                bufs = (c.k, c.v)
                lib_kv = lambda i: (c.k[i % 2], c.v[i % 2])
            else:
                c = QuantKVCache.create(b, s, h, d, device=dev, n_layers=n_l)
                for t in (c.k_q, c.v_q):
                    t.copy_(torch.randint(-127, 128, t.shape, generator=gen, device=dev,
                                          dtype=torch.int8))
                for t in (c.k_scale, c.v_scale):
                    t.copy_(torch.rand(t.shape, generator=gen, device=dev) * 0.02 + 0.005)
                bufs = (c.k_q, c.v_q, c.k_scale, c.v_scale)
                deq = [(c.k_q[i].float() * c.k_scale[i][..., None]).to(torch.bfloat16)
                       for i in range(2)]
                deqv = [(c.v_q[i].float() * c.v_scale[i][..., None]).to(torch.bfloat16)
                        for i in range(2)]
                lib_kv = lambda i: (deq[i % 2], deqv[i % 2])
            k_, v_ = bufs[:2]
            scales = bufs[2:] if body == "int8" else (None, None)
            args = lambda i: (i, q, k_, v_, bias, *scales, slopes)
            got = _launched("decode_attention_stacked_alibi",
                            lambda: k11.decode_attention_stacked(*args(n_l - 1)))
            ref = k11.decode_attention_stacked_plain(*args(n_l - 1))
            torch.cuda.synchronize()
            err = _close(f"K11 alibi {body} B={b}", got, ref, 1e-2)
            n_bytes, ops = roofline.decode_attn_cost(
                b, h, h, s, d, n_valid=int(valid.sum()), value_bytes=2 if body == "bf16" else 1,
                scale_bytes=0 if body == "bf16" else 4)
            b_ms, b_by = roofline.bound_ms(n_bytes, ops)
            flash = k11.decode_attention_stacked(*args(n_l - 1), body="flash")
            torch.cuda.synchronize()
            _close(f"K11 alibi flash body {body} B={b}", flash, ref, 1e-2)
            rows.append(dict(
                kernel="decode_attention_stacked", site=f"alibi_{body}@B{b}", in_sum=False,
                shape=[b, h, h, s, d], max_err=err,
                max_rel_err=err / ref.float().abs().max().item(), check_launches=1,
                split=k11.split_ranks(b * h, s),
                kernel_ms=device_ms(lambda i: k11.decode_attention_stacked(*args(i % n_l)),
                                    n_l),
                flash_ms=device_ms(lambda i: k11.decode_attention_stacked(
                    *args(i % n_l), body="flash"), n_l),
                plain_ms=device_ms(lambda i: k11.decode_attention_stacked_plain(
                    *args(i % n_l)), 4, reps=3),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=device_ms(lambda i: F.scaled_dot_product_attention(
                    q[:, :, None], *lib_kv(i), attn_mask=lib_mask), 16),
                library="scaled_dot_product_attention over the (dequantized) bf16 cache, "
                        "the slope term and validity as its float mask; yardstick only"))
            emit(rows[-1])
            del c, bufs
    torch.cuda.empty_cache()
    return rows


def check_norm_quantize_acts(cfg, dev, gen):
    """K7b vs its plain version at the widths of the Bloom pack's
    query_key_value (C = hidden) and dense_4h_to_h (C = 4·hidden) inputs,
    g64, 5 % salient, k_ns and k_s as the pack pads them; 1, 4, 5 and 130
    rows of bf16; the RMSNorm and no norm.  Codes identical or off by one
    in under 1e-4 of them, scales within one ulp, the salient block within
    a bf16 rounding.  Times at 4 and 130 rows, the groups body beside the
    row body (old_body_ms); off the kernels line's sums (no path runs K7b
    at Bloom's widths: check_act_prep times it at Llama's sites); no single
    PyTorch call computes it."""
    import torch

    from smoothquant_tpu_torch.kernels import act_prep as k7
    from smoothquant_tpu_torch.utils import roofline

    rows = []
    shapes = roofline.bloom_pack_shapes(cfg)
    for site in ("query_key_value", "dense_4h_to_h"):
        c, _, _, kk, _, k_s, n_sal = shapes[site]
        w = (torch.rand(c, generator=gen, device=dev) * 0.5 + 0.75)
        for n in (1, 4, 5, 130):
            xs = [(torch.randn((n, c), generator=gen, device=dev) * (1 + 3 * i)).to(torch.bfloat16)
                  for i in range(4)]
            for kind in ("rms", None):
                kw = dict(group_size=64, act_bits=4, k_ns=kk, num_salient=n_sal, k_s=k_s,
                          eps=cfg.layer_norm_epsilon, norm_kind=kind, sal_dtype=torch.bfloat16)
                got = _launched("norm_quantize_acts_t",
                                lambda: k7.norm_quantize_acts_t(xs[0], w, **kw))
                ref = k7.norm_quantize_acts_t_plain(xs[0], w, **kw)
                torch.cuda.synchronize()
                name = f"K7b {site} N={n} {kind}"
                err, n_diff = _codes_close(name, got[0], ref[0])
                ulps = _scale_ulps(name, got[1], ref[1])
                sal_err = _close(name + " x_sal", got[2], ref[2], 1e-2)
                row = dict(kernel="norm_quantize_acts_t", site=f"{site}@{n}_{kind or 'none'}",
                           in_sum=False, shape=[n, c, kk, k_s], max_err=err, n_diff=n_diff,
                           scale_ulps=ulps, sal_err=sal_err,
                           sal_rel_err=sal_err / max(ref[2].float().abs().max().item(), 1e-30),
                           check_launches=1, library_ms=None, library=None)
                if n in (4, 130):
                    n_bytes, ops = roofline.norm_quant_acts_cost(n, c, kk, 64, k_s)
                    row["bound_ms"], row["bound_by"] = roofline.bound_ms(n_bytes, ops)
                    row["kernel_ms"] = device_ms(
                        lambda i: k7.norm_quantize_acts_t(xs[i % 4], w, **kw), 16)
                    row["old_body_ms"] = device_ms(
                        lambda i: k7.norm_quantize_acts_t(xs[i % 4], w, **kw, body="groups"), 16)
                    row["plain_ms"] = device_ms(
                        lambda i: k7.norm_quantize_acts_t_plain(xs[i % 4], w, **kw), 4, reps=3)
                rows.append(row)
                emit(row)
    return rows


def check_k7b_k5_vs_k1(stacked, cfg, dev, gen, n=BLOOM_BATCH):
    """K7b followed by K5 against K1 on layer 0 of the stacked Bloom tree
    (query_key_value and dense_h_to_4h), both fusing an RMSNorm of the same
    row into the same `n` rows of f32 activations in the pack's channel
    order, the salient block in f32: the same codes by the same factor
    rule, so the outputs agree within f32 sums taken in another order
    (1e-5 of the largest).  A check of K7b's layout feeding K5; off every
    path."""
    import torch

    from smoothquant_tpu_torch.kernels import act_prep as k7
    from smoothquant_tpu_torch.kernels import int4_group_matmul as k1

    st = stacked["layers"]["stacked"]
    out = {}
    for site, lin in (("query_key_value", st["self_attention"]["query_key_value"]),
                      ("dense_h_to_4h", st["mlp"]["dense_h_to_4h"])):
        m = lin.meta
        c = m.in_features
        x = torch.randn((n, c), generator=gen, device=dev) * 2
        nw = (torch.rand((1, c), generator=gen, device=dev) + 0.5).to(torch.bfloat16).float()
        w_qt, w_sc, w_sal = lin.w_qt[:1], lin.w_scales_t[:1], lin.w_sal_t[:1].float()
        eps = cfg.layer_norm_epsilon
        fused = k1.int4_group_matmul_stacked_rawx(
            0, x, nw, w_qt, w_sc, w_sal, group_size=m.group_size, act_bits=m.act_bits,
            num_salient=m.num_salient, eps=eps, norm_kind="rms", out_dtype=torch.float32)
        x3, xs_t, x_sal = _launched("norm_quantize_acts_t", lambda: k7.norm_quantize_acts_t(
            x, nw[0], group_size=m.group_size, act_bits=m.act_bits, k_ns=m.k_ns,
            num_salient=m.num_salient, k_s=m.k_s, eps=eps, norm_kind="rms",
            sal_dtype=torch.float32))
        two = k1.int4_group_matmul_stacked(0, x3, xs_t, w_qt, w_sc, x_sal[:n], w_sal,
                                           group_size=m.group_size, out_dtype=torch.float32,
                                           pre_laid=n)
        torch.cuda.synchronize()
        err = _close(f"K7b + K5 vs K1 {site}", two, fused, 1e-5)
        out[site] = dict(rows=n, max_err=err, max_rel_err=err / fused.abs().max().item())
    return out


def check_int8_prefill_rawx(dev, gen):
    """K4's raw-x mode against its pre-quantized mode on the same bytes —
    the codes quantize_raw_x gives (the torch prologue), through the same
    mma.sync tiles — bit for bit, and
    against its plain version (1e-2 of the largest bf16 output): at
    (1024, 4096→11008), Llama-2-7B's promoted gate_proj shape, with 5 %
    salient channels masked out of the int8 part and carried in bf16, at a
    ragged N of 333, and at a single K step (K = 64).  Times at 1024 rows:
    the kernel, its plain version, the pre-quantized mode with the torch
    prologue, and torch._int_mm with the prologue, epilogue and salient
    matmul (the yardstick)."""
    import torch

    from smoothquant_tpu_torch.kernels import int8_prefill as k4
    from smoothquant_tpu_torch.kernels.pack import k_major
    from smoothquant_tpu_torch.quant.core import compute_scale
    from smoothquant_tpu_torch.utils import roofline

    rows = []
    for site, (n, kk, o) in K4_RAWX_CASES:
        n_sal = int(0.05 * kk)
        sal_idx = torch.randperm(kk, generator=gen, device=dev)[:n_sal]
        mask = torch.ones((1, kk), device=dev)
        mask[0, sal_idx] = 0.0
        x = (torch.randn((n, kk), generator=gen, device=dev) * 2).to(torch.bfloat16)
        x_sal = x[:, sal_idx].contiguous()
        sx = compute_scale((x.float() * mask).abs().amax(dim=-1, keepdim=True), 8)
        w = k_major(torch.randint(-127, 128, (kk, o), generator=gen, device=dev,
                                  dtype=torch.int8))
        sw = torch.rand((1, o), generator=gen, device=dev) * 0.01 + 0.001
        w_sal = (torch.randn((n_sal, o), generator=gen, device=dev) * 0.05).to(torch.bfloat16)
        rest = (sx, w, sw, x_sal, w_sal)
        raw = _launched("int8_prefill_matmul_rawx",
                        lambda: k4.int8_prefill_matmul(x, *rest, mask))
        pre = k4.int8_prefill_matmul(k4.quantize_raw_x(x, mask, sx), *rest, body="tiles")
        ref = k4.int8_prefill_matmul_plain(x, *rest, mask)
        torch.cuda.synchronize()
        if not torch.equal(raw, pre):
            n_diff = int((raw != pre).sum())
            raise AssertionError(f"K4 raw-x {site}: {n_diff} outputs differ from the "
                                 "pre-quantized mode's")
        err = _close(f"K4 raw-x {site}", raw, ref, 1e-2)
        row = dict(kernel="int8_prefill_matmul", site=f"raw_x_{site}", in_sum=False,
                   shape=[n, kk, o, n_sal], max_err=err,
                   max_rel_err=err / ref.float().abs().max().item(),
                   identical_to_prequantized=True, check_launches=1)
        if site == K4_RAWX_CASES[0][0]:
            def library(i):
                xq = k4.quantize_raw_x(x, mask, sx)
                return k4.scale_epilogue(k4.int_mm(xq, w), sx, sw,
                                         torch.matmul(x_sal, w_sal)).to(torch.bfloat16)

            n_bytes, ops = roofline.int8_prefill_rawx_cost(n, kk, o, n_sal, n_masked=n_sal)
            row.update(
                kernel_ms=device_ms(lambda i: k4.int8_prefill_matmul(x, *rest, mask), 8),
                plain_ms=device_ms(lambda i: k4.int8_prefill_matmul_plain(x, *rest, mask), 2,
                                   reps=3),
                prequantized_with_prologue_ms=device_ms(lambda i: k4.int8_prefill_matmul(
                    k4.quantize_raw_x(x, mask, sx), *rest), 8),
                library_ms=device_ms(library, 8),
                library="quantize_raw_x + torch._int_mm + the f32 epilogue + the salient "
                        "matmul; yardstick only",
                **dict(zip(("bound_ms", "bound_by"), roofline.bound_ms(n_bytes, ops))))
        rows.append(row)
        emit(row)
    torch.cuda.empty_cache()
    return rows


def bloom_generator(packed, fp, cfg, dev, card):
    """Generator(quant_kv=True) over the packed per-layer Bloom tree,
    BLOOM_BATCH prompts of BLOOM_PROMPT random tokens and BLOOM_NEW new
    ones over per-layer int8 caches of BLOOM_MAX_LEN: prefill tokens/s (a
    prefill-only run), decode ms/step by host clock and by device busy time
    (a run of QS_PROFILE_NEW tokens less the prefill-only one), launches (K6
    4·L at the prefill; K6 4·L and K11's ALiBi body L a decode step), the
    tied unembedding's device time at BLOOM_BATCH rows beside the step, and
    the packed logits against the fp model's on one prompt.  Returns
    (metrics, launches)."""
    import numpy as np
    import torch

    from smoothquant_tpu_torch.models import bloom
    from smoothquant_tpu_torch.models.common import unembed
    from smoothquant_tpu_torch.serve.generate import GenerationConfig, Generator

    n_l, steps = cfg.num_hidden_layers, BLOOM_NEW - 1
    prompts = np.random.default_rng(SEED + 47).integers(0, cfg.vocab_size,
                                                        size=(BLOOM_BATCH, BLOOM_PROMPT))
    gen = Generator(bloom, packed, cfg, max_len=BLOOM_MAX_LEN, quant_kv=True, device=dev)
    gen.generate(prompts[:, :16], GenerationConfig(max_new_tokens=2))      # warm-up

    def run(new):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = gen.generate(prompts, GenerationConfig(max_new_tokens=new))
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    prefill_s = statistics.median(run(1)[1] for _ in range(3))
    (out, wall), launches = _path_launches(lambda: run(BLOOM_NEW))
    _check_launches("bloom generator", launches, {
        "int4_group_matmul": 4 * n_l * (1 + steps),
        "decode_attention_stacked_alibi": n_l * steps})
    new = out[:, BLOOM_PROMPT:]
    if not (out.shape == (BLOOM_BATCH, BLOOM_PROMPT + BLOOM_NEW)
            and (out[:, :BLOOM_PROMPT] == prompts).all()
            and ((0 <= new) & (new < cfg.vocab_size)).all()):
        raise AssertionError("bloom generator: misshapen output or token out of range")
    busy_short = profile(lambda: run(QS_PROFILE_NEW), 1)
    busy_prefill = profile(lambda: run(1), 1)
    emb = packed["word_embeddings"]["weight"]
    h = torch.randn((BLOOM_BATCH, 1, cfg.hidden_size), device=dev).to(emb.dtype)
    res = dict(batch=BLOOM_BATCH, prompt=BLOOM_PROMPT, new_tokens=BLOOM_NEW,
               max_len=BLOOM_MAX_LEN, prefill_ms=1e3 * prefill_s,
               prefill_tokens_per_s=BLOOM_BATCH * BLOOM_PROMPT / prefill_s,
               decode_ms_per_step=1e3 * (wall - prefill_s) / steps,
               decode_busy_ms_per_step=(busy_short["busy_ms_per_step"]
                                        - busy_prefill["busy_ms_per_step"]) / (QS_PROFILE_NEW - 1),
               wall_s=wall, launches=launches,
               launches_per_decode_step={"int4_group_matmul": 4 * n_l,
                                         "decode_attention_stacked_alibi": n_l},
               unembed_ms=device_ms(lambda i: unembed(h, emb), 8),
               prefill_trace=busy_prefill, trace=busy_short)
    ids = torch.as_tensor(prompts[:1], device=dev)
    with torch.no_grad():
        q_logits = bloom.forward(packed, ids, cfg)[0][0]
        f_logits = bloom.forward(fp, ids, cfg)[0][0]
    if not (torch.isfinite(q_logits).all() and q_logits.shape == (BLOOM_PROMPT, cfg.vocab_size)):
        raise AssertionError("bloom: non-finite or misshapen logits")
    res["vs_fp"] = dict(
        top1_agree=float((q_logits.argmax(-1) == f_logits.argmax(-1)).float().mean()),
        rel_norm_err=float((q_logits - f_logits).norm() / f_logits.norm()))
    return res, launches


def bloom_stacked_decode(stacked, cfg, dev, card):
    """stack_layers' Bloom tree over a stacked head-major int8 cache of
    MAX_LEN positions from DECODE_POS: B = BLOOM_BATCH (K1 over the gathered
    input, K10 with rotary off, K11's ALiBi body) and B = BLOOM_SLOT_BATCH
    (K7a + K5 in place of K1), each in three windows of 8 steps: ms/step by
    host clock and device busy time, launches per step, memory and the
    decode byte bound; at B = BLOOM_SLOT_BATCH also the steps' busy time and
    kernel count on the activation prep's route before (old_route), and at
    both the steps' on the cache write's route before (old_write_route).
    Returns the launches of the counted steps."""
    from collections import Counter

    import torch

    from smoothquant_tpu_torch.models import bloom
    from smoothquant_tpu_torch.utils import roofline

    launches = Counter()
    for b in (BLOOM_BATCH, BLOOM_SLOT_BATCH):
        cache = bloom.stacked_caches(cfg, b, MAX_LEN, pos=DECODE_POS, quant_kv=True, device=dev)
        step, used = family_decoder(bloom, stacked, cache, cfg, dev,
                                    f"bloom decode step B={b}", bloom_step_launches(cfg, b))
        launches.update(used)
        dec = decode_windows({"step": step}, batch=b)["step"]
        emit({"phase": f"bloom_decode_b{b}", "card": card, "batch": b, "cache": MAX_LEN,
              "positions": [DECODE_POS, int(cache.pos[0])], "launches_per_step": used,
              "gib_allocated": torch.cuda.memory_allocated() / 2 ** 30,
              "decode_step_bytes": roofline.bloom_decode_step_bytes(cfg, batch=b,
                                                                    max_len=MAX_LEN),
              **dec, "old_write_route": _old_write_profile(step),
              **({"old_route": _old_route_profile(step)} if b > BLOOM_BATCH else {})})
        del cache, step
        torch.cuda.empty_cache()
    return launches


def _one_code_moved(packed, layer: str, block: str, site: str):
    """A copy of the per-layer tree whose one linear has its first int4
    weight code moved by one step (the low nibble of its first byte, XOR
    1); every other tensor shared."""
    import dataclasses

    lin = packed["layers"][layer][block][site]
    w = lin.w_qt.clone()
    w.view(-1)[0] ^= 1
    blk = {**packed["layers"][layer][block], site: dataclasses.replace(lin, w_qt=w)}
    lay = {**packed["layers"][layer], block: blk}
    return {**packed, "layers": {**packed["layers"], layer: lay}}


def bloom_reference_check(dev):
    """Kernel path (card) vs plain path (CPU) on a small Bloom (2 layers,
    hidden 256, 4 heads of 64, vocab 256; W4A4 g16, 5 % salient, the
    nibble pack of the path), f32 and bf16, from one 5-token prefill into
    per-layer caches of 128: one decode step through the per-layer tree
    (K6; K11's ALiBi body over the int8 cache, the einsum over the fp one)
    and through stack_layers' tree over the stacked copy of those caches
    (the input gathered, K1; K10 with rotary off over the int8 cache; K11's
    ALiBi body over both), each part's logits compared (per_layer_*: the
    prefill's last position and the step; stacked_*: the step), and on the
    card the stacked step against the per-layer one, as the JAX package's
    test_bloom_prefetch_matches_per_layer holds it.  Bounds (BLOOM_REF_TOL),
    relative to the logits' norm, from this check's readings on an NVIDIA
    H100 80GB HBM3 at 700 W: kernel against plain 1e-5 in both dtypes (it
    reads 6.5e-8 to 2.3e-7); stacked against per-layer over the fp cache
    2e-4 in f32 (the JAX test's bound; it reads 1.9e-7) and 1.5e-1 in bf16
    (it reads 0.091: the per-layer step takes the einsum and the stacked
    one K11, which round the probabilities to bf16 before and after
    normalizing them, and the bf16 attention outputs that move move int4
    codes downstream); over the int8 cache 1e-6 (both steps take K11 on
    the same codes: 1.9e-7 in f32, 0 in bf16).  The control: the kernel
    path's per-layer int8 run with one int4 weight code of layer 1's
    dense moved by one step (the smallest fault the CPU run of the plain
    path found: 3.0e-4 in f32, 5.2e-4 in bf16) must read above the
    kernel-against-plain bound, or the check fails."""
    import dataclasses

    import numpy as np
    import torch

    from smoothquant_tpu_torch.models import bloom
    from smoothquant_tpu_torch.models.common import KVCache, QuantKVCache
    from smoothquant_tpu_torch.models.registry import pack_model
    from smoothquant_tpu_torch.quant.config import w4a4_group

    def rel(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    def per_layer_int8(p, d):
        caches = [QuantKVCache.create(2, 128, nh, hd, cfg.torch_dtype, d) for _ in range(n_l)]
        pre, caches = bloom.forward(p, prompt.to(d), cfg, caches=caches)
        step, _ = bloom.forward(p, tok.to(d), cfg, caches=caches)
        return torch.cat([pre[:, -1:], step], dim=1).cpu()

    out, failed = {}, []
    for dtype_name, (tol, fp_pair_tol, int8_pair_tol) in BLOOM_REF_TOL.items():
        cfg = bloom.BloomConfig(vocab_size=256, hidden_size=256, num_hidden_layers=2,
                                num_attention_heads=4, dtype=dtype_name)
        n_l, nh, hd = cfg.num_hidden_layers, cfg.num_attention_heads, cfg.head_dim
        fp = bloom.init_params(torch.Generator().manual_seed(SEED), cfg, "cpu")
        rng = np.random.default_rng(SEED)
        feat = {key: rng.uniform(0.1, 1.0, size=(4 * cfg.hidden_size if "4h_to_h" in key
                                                 else cfg.hidden_size,))
                for _, key, _ in bloom.quantizable_linears(cfg)}
        packed = pack_model("bloom", fp, cfg, w4a4_group(group_size=16, salient_prop=0.05),
                            input_feat=feat, **BLOOM_PACK)
        stacked = bloom.stack_layers(packed, cfg)
        gen = torch.Generator().manual_seed(SEED + 1)
        prompt = torch.randint(0, cfg.vocab_size, (2, 5), generator=gen)
        tok = torch.randint(0, cfg.vocab_size, (2, 1), generator=gen)
        logits = {}
        for name, d in (("plain", "cpu"), ("kernel", dev)):
            p, s = tree_to(packed, d), tree_to(stacked, d)
            logits[name] = {}
            for kind, cls in (("fp", KVCache), ("int8", QuantKVCache)):
                caches = [cls.create(2, 128, nh, hd, cfg.torch_dtype, d) for _ in range(n_l)]
                pre, caches = bloom.forward(p, prompt.to(d), cfg, caches=caches)
                st = bloom.stacked_caches(cfg, 2, 128, pos=prompt.shape[1],
                                          quant_kv=kind == "int8", device=d)
                fields = ("k_q", "v_q", "k_scale", "v_scale") if kind == "int8" else ("k", "v")
                for i, c in enumerate(caches):
                    for f in fields:
                        getattr(st, f)[i].copy_(getattr(c, f))
                step, _ = bloom.forward(p, tok.to(d), cfg, caches=caches)
                expect = {**rawx_launches(stacked["layers"]["stacked"], 2, cfg.torch_dtype, n_l),
                          k11_key(cfg.torch_dtype, hd, 128, alibi=True): n_l}
                if kind == "int8":
                    expect["write_quant_cache_stacked"] = n_l
                if name == "kernel":
                    (s_step, _), used = _path_launches(
                        lambda: bloom.forward(s, tok.to(d), cfg, caches=st))
                    _check_launches(f"bloom reference check stacked_{kind}", used, expect)
                else:
                    s_step, _ = bloom.forward(s, tok.to(d), cfg, caches=st)
                logits[name][f"per_layer_{kind}"] = torch.cat([pre[:, -1:], step], dim=1).cpu()
                logits[name][f"stacked_{kind}"] = s_step.cpu()
        res = out[dtype_name] = {}
        for part, ref in logits["plain"].items():
            got = logits["kernel"][part]
            if not (torch.isfinite(got).all() and got.shape == ref.shape):
                raise AssertionError(f"bloom reference check {part}: non-finite or misshapen")
            res[part] = dict(rel_norm_err=rel(got, ref), tolerance_rel_norm=tol,
                             argmax_agree=float((got.argmax(-1) == ref.argmax(-1))
                                                .float().mean()))
            if not res[part]["rel_norm_err"] <= tol:
                failed.append(f"bloom reference check {dtype_name} {part}: "
                              f"{res[part]['rel_norm_err']} > {tol}")
        for kind, pair_tol in (("fp", fp_pair_tol), ("int8", int8_pair_tol)):
            r = rel(logits["kernel"][f"stacked_{kind}"],
                    logits["kernel"][f"per_layer_{kind}"][:, -1:])
            res[f"stacked_vs_per_layer_{kind}"] = dict(rel_norm_err=r,
                                                       tolerance_rel_norm=pair_tol)
            if not r <= pair_tol:
                failed.append(f"bloom reference check {dtype_name} stacked vs per-layer "
                              f"{kind}: {r} > {pair_tol}")
        ctrl = rel(per_layer_int8(tree_to(_one_code_moved(packed, "1", "self_attention",
                                                          "dense"), dev), dev),
                   logits["plain"]["per_layer_int8"])
        res["control_one_code_moved"] = dict(rel_norm_err=ctrl, must_exceed=tol)
        if not ctrl > tol:
            failed.append(f"bloom reference check {dtype_name}: one code moved reads {ctrl}, "
                          f"within the bound {tol}")
    if failed:
        emit({"phase": "bloom_reference_check", "failed": failed, **out})
        raise AssertionError("; ".join(failed))
    return out


def run_bloom(dev, cfg, card: str):
    """Every Bloom phase on `dev` at the size of `cfg`: the kernel checks of
    this slice (K11's ALiBi body, K7b, K4's raw-x mode), the small-model
    reference check, the model build (calibration, smooth_lm, the nibble
    pack), the Generator, each kernel of the path against its plain version
    on the Bloom trees' own linears (K6 at the Generator's prefill and
    decode rows on the per-layer pack; K1 at BLOOM_BATCH rows and K7a + K5
    at BLOOM_SLOT_BATCH on the stacked layer, the input gathered; K10 with
    rotary off at both batches), K7b + K5 against K1 on the stacked layer,
    the stacked decode at B = 4 and 64, and the stacked tree's first
    SERVE_LAYERS layers served through the batcher's per-slot stacked pool
    (serve_bloom_slots: K1, K10 with rotary off and K11's ALiBi body a layer
    a step, no K6 in a decode step).  Returns (kernel rows, the main
    paths' launches)."""
    from collections import Counter

    import torch

    from smoothquant_tpu_torch.models import bloom
    from smoothquant_tpu_torch.utils import roofline

    gen = torch.Generator(device=dev).manual_seed(SEED + 53)
    rows = (check_decode_attention_alibi(cfg, dev, gen) + check_norm_quantize_acts(cfg, dev, gen)
            + check_int8_prefill_rawx(dev, gen))
    emit({"phase": "bloom_reference_check", **bloom_reference_check(dev)})

    t0 = time.perf_counter()
    fp, packed, seconds = build_bloom(cfg, dev)
    torch.cuda.synchronize()
    emit({"phase": "bloom_model", "seconds": time.perf_counter() - t0, **seconds,
          "layers": cfg.num_hidden_layers, "hidden": cfg.hidden_size,
          "heads": cfg.num_attention_heads, "vocab": cfg.vocab_size,
          "calibration": [BLOOM_SAMPLES, BLOOM_LEN], "alpha": BLOOM_ALPHA,
          "gib_allocated": torch.cuda.memory_allocated() / 2 ** 30,
          "decode_step_bytes": roofline.bloom_decode_step_bytes(cfg)})
    launches = Counter()
    metrics, used = bloom_generator(packed, fp, cfg, dev, card)
    launches.update(used)
    emit({"phase": "bloom_generator", "card": card, **metrics})
    sp_fp, sp_cfg = first_layers(fp, cfg)
    serve_family("bloom", bloom, bloom.stack_layers(sp_fp, sp_cfg), sp_fp, sp_cfg, dev, card,
                 max_len=MAX_LEN)
    del fp, sp_fp
    torch.cuda.empty_cache()
    # the Bloom linears' and K10's rows (off the kernels line's sums) time
    # with 2 repetitions since PR 20: the run's 1200 s limit
    rows += _few_reps(lambda: check_gmm(packed, cfg, dev, gen, BLOOM_BATCH * BLOOM_PROMPT)
                      + check_gmm(packed, cfg, dev, gen, BLOOM_BATCH))
    stacked = bloom.stack_layers(packed, cfg)
    del packed
    torch.cuda.empty_cache()
    rows += _few_reps(lambda: check_rawx(stacked, dev, gen, BLOOM_BATCH)
                      + check_act_prep(stacked, dev, gen, BLOOM_SLOT_BATCH)
                      + check_gmm_stacked(stacked, dev, gen, BLOOM_SLOT_BATCH)
                      + [r for b in (BLOOM_BATCH, BLOOM_SLOT_BATCH) for r in check_write_cache_hm(
                          dev, gen, b, cfg.num_attention_heads, cfg.head_dim, rotary=False,
                          site=f"bloom_rotary_off@B{b}")])
    torch.cuda.empty_cache()
    emit({"phase": "k7b_k5_vs_k1", **check_k7b_k5_vs_k1(stacked, cfg, dev, gen)})
    launches.update(bloom_stacked_decode(stacked, cfg, dev, card))
    sp_st, sp_cfg = first_layers(stacked, cfg)
    launches.update(serve_stacked("serve_bloom_slots", bloom, sp_st, sp_cfg, dev, card,
                                  SERVE_REQUESTS, BLOOM_SERVE_NEW, SEED + 113,
                                  bloom_step_launches(sp_cfg, MAX_BATCH)))
    return rows, launches


def rms_norm_rule_cost(h, cfg, dev):
    """common.rms_norm on one decode step's rows (Σx² in f64, as the fused
    kernels take it on the card) against the same norm with an f32 Σx² and
    torch.rsqrt, timed only: device ms of each, and what the f64 rule adds
    to a step of the per-layer or stacked bf16 path (two norms a layer and
    the final one)."""
    import torch

    from smoothquant_tpu_torch.models.common import rms_norm
    from smoothquant_tpu_torch.quant.core import f32_reciprocal

    norm = {"weight": torch.ones(cfg.hidden_size, dtype=h.dtype, device=dev)}
    eps = cfg.rms_norm_eps

    def f32_rsqrt(i):
        xf = h.float()
        ms = (xf * xf).sum(dim=-1, keepdim=True) * f32_reciprocal(xf.shape[-1])
        return (xf * torch.rsqrt(ms + eps) * norm["weight"].float()).to(h.dtype)

    f64 = device_ms(lambda i: rms_norm(norm, h, eps), 64)
    f32 = device_ms(f32_rsqrt, 64)
    per_step = 2 * cfg.num_hidden_layers + 1
    return {"shape": list(h.shape), "f64_sum_ms": f64, "f32_rsqrt_ms": f32,
            "norms_per_step": per_step, "step_cost_ms": per_step * (f64 - f32)}


# the launch counters of a kernel's other bodies (each wrapper counts a
# launch once, under the body it ran)
BODY_COUNTERS = {"fp_matmul_stacked": {"ldg": "fp_matmul_stacked_ldg"},
                 "write_quant_cache_smajor": {"scalar": "write_quant_cache_smajor_scalar",
                                              "warps": "write_quant_cache_smajor_warps"},
                 "write_quant_cache_stacked": {"scalar": "write_quant_cache_stacked_scalar",
                                               "warps": "write_quant_cache_stacked_warps"},
                 "mlp_swiglu_fused_stacked": {"down": "mlp_swiglu_fused_stacked_down",
                                              "coop": "mlp_swiglu_fused_stacked_coop"},
                 "norm_quant": {"block": "norm_quant_block"},
                 "quantize_acts_grouped_t": {"groups": "quantize_acts_grouped_t_groups"},
                 "norm_quantize_acts_t": {"groups": "norm_quantize_acts_t_groups"},
                 "int4_group_matmul_stacked_rawx": {"dp4a": "int4_group_matmul_stacked_rawx_dp4a"},
                 "decode_attention_stacked": {"alibi": "decode_attention_stacked_alibi",
                                              "flash": "decode_attention_stacked_flash",
                                              "flash_alibi": "decode_attention_stacked_flash_alibi"},
                 "decode_attention_smajor_stacked": {
                     "flash": "decode_attention_smajor_stacked_flash"},
                 "fused_attn": {"flash": "fused_attn_flash"},
                 "int8_bmm": {"qk": "int8_bmm_qk", "pv": "int8_bmm_pv",
                              "kn_gemv": "int8_bmm_kn", "nk_gemv": "int8_bmm_nk"},
                 "int8_prefill_matmul": {"raw_x": "int8_prefill_matmul_rawx",
                                         "tiles": "int8_prefill_matmul_tiles"},
                 "int8_linear": {"gemv": "int8_linear_gemv", "tiles": "int8_linear_tiles"}}


def _by_kernel(launches):
    """Launch counts with each body's key (BODY_COUNTERS) folded into its
    kernel's."""
    base = {key: name for name, bodies in BODY_COUNTERS.items() for key in bodies.values()}
    out = {}
    for key, n in launches.items():
        out[base.get(key, key)] = out.get(base.get(key, key), 0) + n
    return out


def kernels_line(rows, launches):
    """One entry per kernel: the call sites of one layer's worth of work
    summed (K1 at N = 4, K5, K6, K4 with the lm_head, K13; K7a at down
    and K7b at qkv and gate_up, 64 rows; K11 its bf16 and int8 bodies; K15a its six linears, K15b its two
    products and K16 its LayerNorm, each at the prefill and at the decode
    size; K12 its flat body at B = 4, K14 at N = 4; K8 its q, gate and down
    sites with the salient block at N = 4, K9 its grouped body at gate_proj,
    N = 2048; rows
    marked in_sum=False — Bloom's rows of K1, K5, K6, K7a and K10 (its
    rotary-off body), K1 at 16 and 32 rows, K5's extra row-major qkv,
    K12's other bodies and B = 64, K14 at 8 rows, K8's and K9's other
    bodies and row counts, K11's ALiBi body, K4's raw-x mode, K7a's and
    K7b's other row counts and Bloom's widths — are reported on their own
    lines only), the errors the
    largest seen; launches are the main paths' runs summed over every body
    (launches_by_body splits them; check_launches counts the checks'
    launches, which the main paths' counts leave out)."""
    out = []
    for name, (src, replaces) in SOURCES.items():
        every = [r for r in rows if r["kernel"] == name]
        rs = [r for r in every if r.get("in_sum", True)]
        lib = [r["library_ms"] for r in rs]
        bound = sum(r["bound_ms"] for r in rs)
        by_body = {"default": launches.get(name, 0),
                   **{body: launches.get(key, 0)
                      for body, key in BODY_COUNTERS.get(name, {}).items()}}
        out.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=sum(by_body.values()), launches_by_body=by_body,
            check_launches=sum(r.get("check_launches", 0) for r in every),
            max_abs_err=max(r["max_err"] for r in every),
            ms=sum(r["kernel_ms"] for r in rs), plain_ms=sum(r["plain_ms"] for r in rs),
            bound_ms=bound,
            bound_by=max(rs, key=lambda r: r["bound_ms"])["bound_by"],
            library_ms=None if None in lib else sum(lib),
            sites=[r.get("site", "all") for r in every]))
    return {"kernels": out}


# ---------------------------------------------------------------- serving layer

# the serving phases' requests: prompts of 100-240 tokens, 32 new, chunks of 8
SERVE_REQUESTS, SERVE_NEW, SERVE_PROMPT = 8, 32, (100, 240)
GEN_COMPUTE_NEW = 16        # the Generator's compute modes: new tokens a prompt
OPT_SERVE_LEN = 1024
# a request's tokens are held to its per-request greedy Generator run up to
# the first step at which that run's top-2 logit gap falls below this share
# of its |logits|∞ (a near-tie, where another shape's sum order may pick the
# other token); over the S-major pool the batcher's einsum reads the cache
# in another layout than its reference's, the bits differ, and W4A4 codes at
# rounding edges move and spread, so its near-ties reach further
SERVE_GAP_TOL, SMAJOR_EINSUM_GAP_TOL = 1e-2, 5e-2
# the serving-layer phases (serve_per_layer, serve_fp_pool, serve_families)
# and the Mistral path run the first SERVE_LAYERS layers of their trees (the
# cut: each checks the serving logic or the window, not the depth, and at
# full depth they took ~280 s of the run's 1200 s limit)
SERVE_LAYERS = 8
# Mistral-7B's windowed decode: B = 4 from position 4600 in a cache of 5120,
# so keys 0-504 lie outside the 4096 window.  Each layer's attention is held
# to the einsum over the same dequantized cache and bias (a share of the
# largest output: bf16 outputs, p rounded to bf16 before PV), and must sit
# farther than that from the windowless einsum; the bf16 tree's step
# logits to the same step with the einsum as its attention (relative norm:
# bf16 roundings of the attention's last-bit differences carried through
# 32 layers), which the windowless step must exceed
MISTRAL_BATCH, MISTRAL_POS, MISTRAL_LEN = 4, 4600, 5120
MISTRAL_SAMPLES, MISTRAL_CALIB_LEN = 4, 512
MISTRAL_ATTN_TOL, MISTRAL_LOGIT_TOL = 1e-2, 0.1


def first_layers(tree, cfg, n=None, start=0):
    """(tree, cfg) cut to the first n (default SERVE_LAYERS) layers from
    layer `start`: a per-layer tree keeps layers start .. start + n − 1 as
    "0" .. n − 1, a stacked tree those along its layer axis (views); the
    rest of the tree as it is."""
    import dataclasses

    from smoothquant_tpu_torch.kernels.pack import PackedLinear

    n = min(n or SERVE_LAYERS, cfg.num_hidden_layers - start)

    def cut(node):
        if isinstance(node, PackedLinear):
            return dataclasses.replace(node, **{
                f: None if getattr(node, f) is None else getattr(node, f)[start:start + n]
                for f in ("w_qt", "w_scales_t", "w_sal_t", "bias", "perm", "ns_mask")})
        if isinstance(node, dict):
            return {k: cut(v) for k, v in node.items()}
        return None if node is None else node[start:start + n]

    layers = tree["layers"]
    layers = ({"stacked": cut(layers["stacked"])} if "stacked" in layers
              else {str(i): layers[str(start + i)] for i in range(n)})
    return {**tree, "layers": layers}, dataclasses.replace(cfg, num_hidden_layers=n)


def serve_prompts(cfg, n, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=(int(rng.integers(*SERVE_PROMPT)),))
            for _ in range(n)]


def greedy_reference(mod, tree, cfg, prompt, new, dev, *, max_len, prefill_tree=None,
                     quant_kv=False, copies=None, **ctx):
    """One request through a Generator of its own (greedy), run step by step
    so each step's logits are read: its tokens, and each step's top-2 logit
    gap over |logits|∞.  The request runs alone, its prompt replicated to
    `copies` rows (default MAX_BATCH, the pool's slots; the rows never
    mix), so every decode kernel takes the shape the batcher gives it: the
    same K11 split, the lm_head on K4."""
    import numpy as np
    import torch

    from smoothquant_tpu_torch.serve.generate import Generator

    copies = copies or MAX_BATCH
    g = Generator(mod, tree, cfg, max_len=max_len, quant_kv=quant_kv,
                  prefill_params=prefill_tree, device=dev, **ctx)
    caches = g._new_caches(copies)
    ids = torch.as_tensor(np.asarray(prompt)[None], device=dev).repeat(copies, 1)
    params, toks, gaps = g.prefill_params, [], []
    with torch.no_grad():
        for _ in range(new):
            logits, caches = mod.forward(params, ids, cfg, ctx=g.ctx, caches=caches)
            last = logits[0, -1].float()
            top = torch.topk(last, 2).values
            toks.append(int(torch.argmax(last)))
            gaps.append(float((top[0] - top[1]) / last.abs().max()))
            ids = torch.full((copies, 1), toks[-1], device=dev)
            params = g.params
    return {"tokens": toks, "gaps": gaps}


def stacked_reference(mod, stacked, cfg, prompt, new, dev, *, max_len, copies=None,
                      quant_kv=True):
    """One request through a stacked tree's own greedy decode at the pool's
    width, step by step, with no batcher: the prompt, padded to its bucket
    as the batcher pads it and copied to every row (the other rows dummies
    of the request), prefilled on the stacked tree into a stacked batch
    cache; its rows copied into a stacked per-slot pool of `copies` rows
    (default MAX_BATCH; (L, B) positions, head-major, int8 with quant_kv);
    then each step one token through the stacked decode at each row's true
    position under the key-validity mask the batcher keeps.  So every
    kernel takes the shape and the route the batcher's step gives it.  Its
    tokens, and each step's top-2 logit gap over |logits|∞."""
    import numpy as np
    import torch

    from smoothquant_tpu_torch.models.common import ForwardContext, KVCache, QuantKVCache
    from smoothquant_tpu_torch.serve.batching import _bucket, _fields
    from smoothquant_tpu_torch.serve.generate import cache_kv_heads

    copies = copies or MAX_BATCH
    n_l, n_kv, d = cfg.num_hidden_layers, cache_kv_heads(cfg), cfg.head_dim
    cls = QuantKVCache if quant_kv else KVCache
    s = len(prompt)
    bucket = _bucket(s)
    ids = np.zeros((copies, bucket), np.int64)
    ids[:, :s] = np.asarray(prompt)
    ctx = ForwardContext()
    toks, gaps = [], []
    with torch.no_grad():
        batch = cls.create(copies, bucket, n_kv, d, cfg.torch_dtype, dev, n_layers=n_l)
        h, _ = mod.forward_hidden(stacked, torch.as_tensor(ids, device=dev), cfg,
                                  caches=batch, ctx=ctx)
        logits = mod.lm_head_logits(stacked, h[:, s - 1:s], cfg, ctx)
        pool = cls.create(copies, max_len, n_kv, d, cfg.torch_dtype, dev, per_slot=True,
                          n_layers=n_l)
        n = min(bucket, max_len)
        for name in _fields(pool):       # every field's S axis is 3 (head-major, stacked)
            getattr(pool, name).narrow(3, 0, n).copy_(getattr(batch, name).narrow(3, 0, n))
        pool.pos.fill_(s)
        del batch
        key_valid = torch.zeros((copies, max_len), dtype=torch.bool, device=dev)
        key_valid[:, :s] = True
        for t in range(new):
            last = logits[0, -1].float()
            top = torch.topk(last, 2).values
            toks.append(int(torch.argmax(last)))
            gaps.append(float((top[0] - top[1]) / last.abs().max()))
            if t == new - 1:
                break
            key_valid[:, s + t] = True
            tok = torch.full((copies, 1), toks[-1], device=dev)
            pos = torch.full((copies, 1), s + t, device=dev)
            h, pool = mod.forward_hidden(stacked, tok, cfg, caches=pool, positions=pos,
                                         attn_mask=key_valid, ctx=ctx)
            logits = mod.lm_head_logits(stacked, h, cfg, ctx)
    return {"tokens": toks, "gaps": gaps}


def hold_tokens(path, got, refs, tol):
    """Each request's tokens identical to its reference's up to the first
    step whose reference gap is below `tol`; raises otherwise.  Returns the
    counts, the smallest gap held, and where each request first differs
    (step, the reference's gap there, its smallest gap up to there)."""
    near = compared = identical = 0
    first_diff, bad = [], []
    held_gaps = []
    for g, r in zip(got, refs):
        diff = next((t for t, (a, b) in enumerate(zip(g, r["tokens"])) if a != b), None)
        first_diff.append(None if diff is None else
                          [diff, r["gaps"][diff], min(r["gaps"][:diff + 1])])
        identical += diff is None and len(g) == len(r["tokens"])
        for t, (a, b, gap) in enumerate(zip(g, r["tokens"], r["gaps"])):
            if gap < tol:
                near += 1
                break
            if a != b:
                bad.append((t, gap))
                break
            compared += 1
            held_gaps.append(gap)
    out = dict(requests=len(got), identical_requests=identical, near_tie_requests=near,
               steps_held=compared, gap_tol=tol, first_diff=first_diff,
               min_gap_held=min(held_gaps, default=None))
    if bad:
        raise AssertionError(f"{path}: tokens differ from the per-request Generator before any "
                             f"near-tie (step, gap): {bad}; {out}")
    return out


def serve_batch(mod, tree, cfg, dev, prompts, *, batch=MAX_BATCH, max_len=MAX_LEN,
                new=None, chunk=8, **kw):
    """prompts through ContinuousBatcher(mod, tree, cfg, max_batch=batch,
    max_len, **kw), chunks of `chunk`: (tokens per request, launches,
    metrics: decode steps, prefill rows and sequences, wall seconds,
    tokens/s; einsum calls, the einsum attention's calls counted)."""
    import numpy as np
    import torch

    from smoothquant_tpu_torch.models import common
    from smoothquant_tpu_torch.serve.batching import ContinuousBatcher, Request

    new = new or SERVE_NEW
    b = ContinuousBatcher(mod, tree, cfg, max_batch=batch, max_len=max_len, device=dev, **kw)
    pre = {"rows": [], "seqs": []}
    inner = b._prefill

    def counted_prefill(ids, lens):
        pre["rows"].append(ids.shape[0] * ids.shape[1])
        pre["seqs"].append(ids.shape[0])
        return inner(ids, lens)

    b._prefill = counted_prefill
    einsum = {"calls": 0}
    real = common.attention

    def counted(*a, **k):
        einsum["calls"] += 1
        return real(*a, **k)

    reqs = [Request(uid=i, prompt=np.asarray(p), max_new_tokens=new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        b.submit(r)
    common.attention = counted
    try:
        t0 = time.perf_counter()
        _, launches = _path_launches(lambda: b.run_to_completion(chunk=chunk))
        wall = time.perf_counter() - t0
    finally:
        common.attention = real
    toks = [r.generated for r in reqs]
    if not (all(r.done and len(r.generated) == new for r in reqs)
            and all(0 <= t < cfg.vocab_size for g in toks for t in g)):
        raise AssertionError("serving: unfinished request or token out of range")
    return toks, launches, dict(decode_steps=b._steps, prefill_rows=pre["rows"],
                                prefill_seqs=pre["seqs"], wall_s=wall,
                                tokens_per_s=len(reqs) * new / wall,
                                einsum_attention_calls=einsum["calls"])


def _prefill_k4(rows, seqs, n_l, promoted):
    """K4's launches of a batcher's prefills: the int8 lm_head on each row's
    last position from PREFILL_KERNEL_MIN_TOKENS rows, and with a promoted
    prefill tree its four linears a layer over rows × bucket."""
    from smoothquant_tpu_torch.kernels.real_linear import PREFILL_KERNEL_MIN_TOKENS

    k4 = sum(n >= PREFILL_KERNEL_MIN_TOKENS for n in seqs)
    if promoted:
        k4 += 4 * n_l * sum(n >= PREFILL_KERNEL_MIN_TOKENS for n in rows)
    return k4


def serve_fp_pool(fp, bf16, cfg, dev, card):
    """The JAX batcher's default pool (quant_kv=False) at Llama-2-7B: the
    bf16 stacked tree (K13 4·L + K11 L a step, the stacked fp pool) and then
    the per-layer bf16 tree over per-layer per-slot fp caches under
    attn="kernel" (K11 L a step, its linears torch matmuls; no einsum
    attention in a decode step), both prefilled on the per-layer tree,
    SERVE_REQUESTS requests at MAX_BATCH slots; tokens held to each
    request's per-layer greedy Generator (attn="kernel").  Returns the
    launches."""
    from collections import Counter

    from smoothquant_tpu_torch.models import llama

    n_l = cfg.num_hidden_layers
    prompts = serve_prompts(cfg, SERVE_REQUESTS, SEED + 71)
    refs = [greedy_reference(llama, fp, cfg, p, SERVE_NEW, dev, max_len=MAX_LEN, attn="kernel")
            for p in prompts]
    launches = Counter()
    for tree_name, tree, kw, per_step in (
            ("stacked", bf16, {}, {"fp_matmul_stacked": 4 * n_l,
                                   "decode_attention_stacked": n_l}),
            ("per_layer", fp, {"attn": "kernel"}, {"decode_attention_stacked": n_l})):
        toks, used, m = serve_batch(llama, tree, cfg, dev, prompts, prefill_params=fp, **kw)
        _check_launches(f"serve_fp_pool {tree_name}", used,
                        {k: v * m["decode_steps"] for k, v in per_step.items()})
        if m["einsum_attention_calls"] != n_l * len(m["prefill_rows"]):
            raise AssertionError(f"serve_fp_pool {tree_name}: {m['einsum_attention_calls']} "
                                 "einsum attentions, only the prefills' expected")
        launches.update(used)
        emit({"phase": "serve_fp_pool", "card": card, "tree": tree_name, "pool": "fp",
              "layers": n_l,
              "max_batch": MAX_BATCH, "cache": MAX_LEN, **m, "launches_per_step": per_step,
              "launches": used, "tokens": hold_tokens(f"serve_fp_pool {tree_name}", toks, refs,
                                                      SERVE_GAP_TOL)})
    return launches


def serve_per_layer(packed, promoted, cfg, dev, card):
    """The serving pack kept per-layer, through the batcher over per-layer
    per-slot pools at MAX_BATCH slots: the int8 head-major pool (K6 4·L,
    K11 L and the int8 lm_head's K4 a step), prefilled on the pack (K6) and
    then on its promoted twin (K4); the S-major pool (the einsum attention
    over its dequantized view, as in JAX).  Tokens held to each request's
    greedy Generator over int8 caches with the same prefill tree and the
    pool's attention (K11, or the einsum under attn="einsum").  Returns the
    launches."""
    from collections import Counter

    from smoothquant_tpu_torch.kernels.real_linear import PREFILL_KERNEL_MIN_TOKENS
    from smoothquant_tpu_torch.models import llama

    n_l = cfg.num_hidden_layers
    prompts = serve_prompts(cfg, SERVE_REQUESTS, SEED + 73)
    launches = Counter()
    lm = int(MAX_BATCH >= PREFILL_KERNEL_MIN_TOKENS)
    for pool, pre, smajor in (("int8 head-major", "nibble", False),
                              ("int8 head-major", "promoted", False),
                              ("int8 S-major", "nibble", True)):
        tree = promoted if pre == "promoted" else packed
        # the reference's attention is the pool's: K11 over int8 caches, or
        # the einsum over their dequantized view, as the S-major pool's
        refs = [greedy_reference(llama, packed, cfg, p, SERVE_NEW, dev, max_len=MAX_LEN,
                                 quant_kv=True, prefill_tree=tree,
                                 attn="einsum" if smajor else "auto") for p in prompts]
        toks, used, m = serve_batch(llama, packed, cfg, dev, prompts, quant_kv=True,
                                    smajor=smajor, prefill_params=tree)
        per_step = {"int4_group_matmul": 4 * n_l, "int8_prefill_matmul": lm}
        if not smajor:
            per_step["decode_attention_stacked"] = n_l
        expect = {k: v * m["decode_steps"] for k, v in per_step.items()}
        expect["int8_prefill_matmul"] += _prefill_k4(m["prefill_rows"], m["prefill_seqs"], n_l,
                                                     pre == "promoted")
        if pre == "nibble":
            expect["int4_group_matmul"] += 4 * n_l * len(m["prefill_rows"])
        _check_launches(f"serve_per_layer {pool} {pre}", used, expect)
        calls = n_l * (len(m["prefill_rows"]) + (m["decode_steps"] if smajor else 0))
        if m["einsum_attention_calls"] != calls:
            raise AssertionError(f"serve_per_layer {pool}: {m['einsum_attention_calls']} einsum "
                                 f"attentions, {calls} expected")
        launches.update(used)
        emit({"phase": "serve_per_layer", "card": card, "layers": cfg.num_hidden_layers,
              "tree": "W4A4 serving pack, per-layer",
              "pool": pool, "prefill_tree": pre, "max_batch": MAX_BATCH, "cache": MAX_LEN, **m,
              "launches_per_step": per_step, "launches": used,
              "tokens": hold_tokens(f"serve_per_layer {pool} {pre}", toks, refs,
                                    SMAJOR_EINSUM_GAP_TOL if smajor else SERVE_GAP_TOL)})
    return launches


def serve_generator_compute(packed, cfg, dev, card):
    """The quick start's per-layer int8-container pack through the Generator
    under compute="int" (K8 only) and "dequant" (K9 only): QS_BATCH prompts
    of 200 tokens, GEN_COMPUTE_NEW new, int8 caches (K11); each prompt's tokens held to
    its own greedy Generator in the same mode.  Returns the launches."""
    from collections import Counter

    import numpy as np

    from smoothquant_tpu_torch.models import llama
    from smoothquant_tpu_torch.serve.generate import GenerationConfig, Generator

    n_l = cfg.num_hidden_layers
    prompts = np.random.default_rng(SEED + 75).integers(0, cfg.vocab_size,
                                                        size=(QS_BATCH, GEN_PROMPT))
    launches = Counter()
    for compute, kernel in (("int", "int_group_matmul"), ("dequant", "dual_path_matmul")):
        refs = [greedy_reference(llama, packed, cfg, p, GEN_COMPUTE_NEW, dev, max_len=QS_MAX_LEN,
                                 quant_kv=True, compute=compute, copies=QS_BATCH)
                for p in prompts]
        g = Generator(llama, packed, cfg, max_len=QS_MAX_LEN, quant_kv=True, compute=compute,
                      device=dev)
        t0 = time.perf_counter()
        out, used = _path_launches(
            lambda: g.generate(prompts, GenerationConfig(max_new_tokens=GEN_COMPUTE_NEW)))
        wall = time.perf_counter() - t0
        steps = GEN_COMPUTE_NEW - 1
        _check_launches(f"generator compute={compute}", used, {
            kernel: 7 * n_l * (1 + steps), "decode_attention_stacked": n_l * steps})
        launches.update(used)
        emit({"phase": "serve_per_layer", "card": card, "layers": cfg.num_hidden_layers,
              "tree": "quick start pack",
              "generator": True, "compute": compute, "batch": QS_BATCH, "prompt": GEN_PROMPT,
              "new_tokens": GEN_COMPUTE_NEW, "wall_s": wall,
              "tokens_per_s": QS_BATCH * GEN_COMPUTE_NEW / wall,
              "launches_per_step": {kernel: 7 * n_l, "decode_attention_stacked": n_l},
              "launches": used,
              "tokens": hold_tokens(f"generator compute={compute}",
                                    [list(r[GEN_PROMPT:]) for r in out], refs,
                                    SERVE_GAP_TOL)})
    return launches


def serve_stacked(phase, mod, stacked, cfg, dev, card, n_requests, new, seed, per_step):
    """A family's stacked W4A4 tree through the batcher over its per-slot
    stacked int8 pool ((L, B) positions) at MAX_BATCH slots, cache MAX_LEN:
    n_requests prompts of SERVE_PROMPT tokens, `new` new ones, prefilled on
    the stacked tree (its per-layer body over the stack: K6 four linears a
    layer) and decoded by the stacked decode (per_step: the launches of one
    step, so a decode that fell back to the per-layer body, K6 and all,
    fails the count).  Each request's tokens held to the stacked tree's own
    greedy decode (stacked_reference) up to the first near-tie.  Returns
    the launches.  The phase line is named `phase`."""
    n_l = cfg.num_hidden_layers
    prompts = serve_prompts(cfg, n_requests, seed)
    refs = [stacked_reference(mod, stacked, cfg, p, new, dev, max_len=MAX_LEN)
            for p in prompts]
    toks, used, m = serve_batch(mod, stacked, cfg, dev, prompts, new=new, quant_kv=True)
    expect = {k: v * m["decode_steps"] for k, v in per_step.items()}
    expect["int4_group_matmul"] = 4 * n_l * len(m["prefill_seqs"])
    _check_launches(phase.replace("_", " "), used, expect)
    emit({"phase": phase, "card": card, "layers": n_l, "tree": "stacked W4A4",
          "pool": "per-slot stacked head-major int8", "reference": "stacked_reference",
          "max_batch": MAX_BATCH, "cache": MAX_LEN, **m, "launches_per_step": per_step,
          "launches": used,
          "tokens": hold_tokens(phase, toks, refs, SERVE_GAP_TOL)})
    return used


def serve_family(name, mod, tree, ref_tree, cfg, dev, card, *, max_len, batch=MAX_BATCH):
    """An fp tree of another family through the batcher over the fp pool,
    prefilled and decoded on that tree (OPT: the per-layer tree, learned
    positions from each slot's sequence position; Bloom: the stacked tree,
    which the stacked decode declines, so the per-layer body runs over its
    layers for the prefill and every step), held to the per-request greedy
    Generator on the per-layer tree `ref_tree`.  The fp path runs no
    kernel: the launches must be none."""
    prompts = serve_prompts(cfg, SERVE_REQUESTS, SEED + 77)
    refs = [greedy_reference(mod, ref_tree, cfg, p, SERVE_NEW, dev, max_len=max_len,
                             copies=batch) for p in prompts]
    toks, used, m = serve_batch(mod, tree, cfg, dev, prompts, batch=batch, max_len=max_len)
    _check_launches(f"serve_families {name}", used, {})
    emit({"phase": "serve_families", "card": card, "family": name,
          "layers": cfg.num_hidden_layers,
          "tree": "stacked fp" if "stacked" in tree["layers"] else "per-layer fp",
          "pool": "fp", "max_batch": batch, "cache": max_len, **m,
          "tokens": hold_tokens(f"serve_families {name}", toks, refs, SERVE_GAP_TOL)})


def tied_and_unfused(fp, packed, cfg, dev, card):
    """At Llama-2-7B width: a tied twin (no lm_head, tie_word_embeddings,
    embed_tokens the untied tree's lm_head weight, which the untied twin
    also embeds with) gives the untied twin's 1 × 512 prefill logits bit for
    bit; and the unfused pack_model(shared_residual_basis=True,
    fold_perms=True) of the serving recipe, given the statistics the fused
    pack keys by q_proj and gate_proj (each normed activation once in the
    shared key), gives per-layer 1 × 512 logits within half the
    quantization's own effect (the fused serving pack's logits less the fp
    model's, by relative norm) of the fused pack's; perms_as_fused reports
    whether its perms are the fused pack's."""
    import dataclasses

    import torch

    from smoothquant_tpu_torch.models import llama
    from smoothquant_tpu_torch.models.registry import pack_model

    ids = torch.randint(0, cfg.vocab_size, (1, MAX_LEN), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(SEED + 79))
    lm_w = fp["lm_head"]["weight"]
    untied = dict(fp, embed_tokens={"weight": lm_w})
    tied = {k: v for k, v in untied.items() if k != "lm_head"}
    with torch.no_grad():
        a = llama.forward(untied, ids, cfg)[0]
        b = llama.forward(tied, ids, dataclasses.replace(cfg, tie_word_embeddings=True))[0]
    if not (torch.isfinite(a).all() and torch.equal(a, b)):
        raise AssertionError("tied_and_unfused: the tied twin's logits differ from the untied")
    del a, b
    qcfg, head, feat = _recipe(cfg, SEED, 64)
    # the fused listing keys a fusion by its first part (q_proj, gate_proj),
    # so each normed activation enters the shared key once: the unfused pack
    # gets the same statistics, the other parts' summing to nothing
    feat = {k: 0.0 * v if k.endswith(("k_proj", "v_proj", "up_proj")) else v
            for k, v in feat.items()}
    t0 = time.perf_counter()
    unfused = pack_model("llama", fp, cfg, qcfg, input_feat=feat, nibble=True,
                         lm_head_qcfg=head, align_k_groups=8, align_o=2048, fold_perms=True,
                         shared_residual_basis=True, identity_keys=("o_proj",))
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    with torch.no_grad():
        lf = llama.forward(fp, ids, cfg)[0].float()
        lq = llama.forward(packed, ids, cfg)[0].float()
        _, used = _path_launches(lambda: llama.forward(unfused, ids, cfg))
        lu = llama.forward(unfused, ids, cfg)[0].float()
    n_l = cfg.num_hidden_layers
    _check_launches("unfused shared-basis prefill", used,
                    {"int4_group_matmul": 7 * n_l, "int8_prefill_matmul": 1})
    effect = float((lq - lf).norm() / lf.norm())
    rel = float((lu - lq).norm() / lq.norm())
    tol = 0.5 * effect
    if not (torch.isfinite(lu).all() and rel <= tol):
        raise AssertionError(f"tied_and_unfused: unfused pack {rel} from the fused one > {tol}")
    same_perms = all(
        torch.equal(unfused["layers"][str(i)][blk][a].perm, packed["layers"][str(i)][blk][b].perm)
        for i in range(n_l) for blk, a, b in (("self_attn", "q_proj", "qkv_proj"),
                                              ("self_attn", "v_proj", "qkv_proj"),
                                              ("mlp", "up_proj", "gate_up_proj"),
                                              ("mlp", "down_proj", "down_proj")))
    del unfused
    torch.cuda.empty_cache()
    return dict(tied_bit_exact=True, unfused_pack_s=pack_s, perms_as_fused=same_perms,
                rel_norm_vs_fused=rel,
                fused_quant_effect=effect, tolerance_rel_norm=tol,
                unfused_quant_effect=float((lu - lf).norm() / lf.norm()),
                top1_vs_fused=float((lu.argmax(-1) == lq.argmax(-1)).float().mean()),
                launches=used)


def build_mistral(cfg, dev):
    """Mistral-7B (the JAX package's mistral_7b preset) from seed SEED:
    random bf16 weights, calibration (get_act_scales, get_calib_feat) on
    MISTRAL_SAMPLES random sequences of MISTRAL_CALIB_LEN tokens, the serving
    pack (W4A4 g64, 5 % salient, bf16 scales, fused qkv / gate_up over the
    shared residual basis, identity o_proj, folded down_proj input, int8
    lm_head) and its stack, and the bf16 tree (pack_fp_decode +
    stack_layers); the fp tree is freed.  Returns (stacked W4A4 tree, bf16
    tree, seconds of each step)."""
    import numpy as np
    import torch

    from smoothquant_tpu_torch.models import llama
    from smoothquant_tpu_torch.models.common import ForwardContext
    from smoothquant_tpu_torch.models.registry import pack_model
    from smoothquant_tpu_torch.quant.calibrate import get_act_scales, get_calib_feat

    seconds = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        return r

    fp = timed("init", lambda: llama.init_params(
        torch.Generator(device=dev).manual_seed(SEED), cfg, dev))
    rng = np.random.default_rng(SEED + 81)
    batches = [rng.integers(0, cfg.vocab_size, size=(1, MISTRAL_CALIB_LEN))
               for _ in range(MISTRAL_SAMPLES)]

    def fwd(p, ids, col):
        return llama.forward(p, torch.as_tensor(ids, device=dev), cfg,
                             ctx=ForwardContext(taps=col))

    scales = timed("act_scales", lambda: get_act_scales(fwd, fp, batches))
    feat = timed("calib_feat", lambda: get_calib_feat(fwd, fp, batches))
    qcfg, head, _ = _recipe(cfg, SEED, 64)
    packed = timed("pack_model", lambda: pack_model(
        "mistral", fp, cfg, qcfg, input_feat=feat, act_scales=scales, nibble=True,
        lm_head_qcfg=head, align_k_groups=8, align_o=2048, fuse=True, fold_perms=True,
        shared_residual_basis=True, identity_keys=("o_proj",)))
    bf16 = timed("bf16_tree", lambda: build_bf16(fp, cfg))
    del fp
    stacked = timed("stack_layers", lambda: llama.stack_layers(packed, cfg))
    return stacked, bf16, seconds


def _einsum_decode_attention(cache, i, q, bias):
    """Layer i's single-query attention over a stacked int8 cache (S-major
    or head-major) as the plain einsum: the cache dequantized in f32, the
    (B, S) bias (the window in it) added to the f32 scores, softmax, PV."""
    import torch

    from smoothquant_tpu_torch.models.common import SMajorQuantKVCache

    b, h, d = q.shape
    if isinstance(cache, SMajorQuantKVCache):
        n_kv = cache.k_scale.shape[2]
        k = cache.k_q[i].view(b, -1, n_kv, d).transpose(1, 2)
        v = cache.v_q[i].view(b, -1, n_kv, d).transpose(1, 2)
    else:
        k, v = cache.k_q[i], cache.v_q[i]
        n_kv = k.shape[1]
    k = (k.float() * cache.k_scale[i][..., None]).repeat_interleave(h // n_kv, dim=1)
    v = (v.float() * cache.v_scale[i][..., None]).repeat_interleave(h // n_kv, dim=1)
    s = torch.einsum("bhd,bhsd->bhs", q.float(), k) / d ** 0.5 + bias[:, None, :]
    return torch.einsum("bhs,bhsd->bhd", torch.softmax(s, dim=-1), v).to(q.dtype)


def mistral_window(stacked, bf16, cfg, dev, card):
    """The stacked W4A4 decode of Mistral-7B at B = MISTRAL_BATCH from
    position MISTRAL_POS in caches of MISTRAL_LEN (random codes and scales
    in [0, MISTRAL_POS)), so keys 0-504 lie outside the 4096 window: over
    the S-major pool (K1, K2, K3, the window in K3's bias) and the
    head-major pool with per-slot positions ("off": K10 + K11, which the
    window forces).  Per pool, from one copy of the cache, one step of the
    W4A4 tree and of the bf16 tree (K13, the same attention kernels): each
    layer's attention held to the einsum over the same dequantized cache
    with the window mask (max error over the largest output, within
    MISTRAL_ATTN_TOL) and off by more than that from the windowless einsum
    at every layer; the bf16 step's logits against the same step with that
    einsum as its attention (relative norm within MISTRAL_LOGIT_TOL) and
    the same step with sliding_window=None off by more than that (the W4A4
    step's logits move with every last-bit difference: a code at a rounding
    edge flips and spreads through 32 layers, so its logits are not held
    to another attention's); then 3 windows of 8 W4A4 steps (ms/step by
    host clock, device busy).  Returns the launches of the counted steps."""
    import dataclasses
    from collections import Counter

    import torch

    from smoothquant_tpu_torch.models import llama
    from smoothquant_tpu_torch.models.common import decode_bias

    gen = torch.Generator(device=dev).manual_seed(SEED + 83)
    launches = Counter()
    steps, out = {}, {}
    tok = torch.randint(0, cfg.vocab_size, (MISTRAL_BATCH, 1), generator=gen, device=dev)
    for name, smajor, attn in (("s_major", True, "smajor"), ("head_major", False, "off")):
        cache = llama.stacked_caches(cfg, MISTRAL_BATCH, MISTRAL_LEN, pos=MISTRAL_POS,
                                     quant_kv=True, smajor=smajor, per_slot=True, device=dev)
        for f in ("k_q", "v_q"):
            getattr(cache, f).copy_(torch.randint(-127, 128, getattr(cache, f).shape,
                                                  generator=gen, device=dev, dtype=torch.int8))
        for f in ("k_scale", "v_scale"):
            t = getattr(cache, f)
            t.copy_(torch.rand(t.shape, generator=gen, device=dev) * 0.015 + 0.005)
        pristine = {f: getattr(cache, f).clone() for f in ("k_q", "v_q", "k_scale", "v_scale",
                                                           "pos")}
        attend = "stacked_smajor_attention" if smajor else "stacked_flash_attention"
        real = getattr(llama, attend)
        errs = {"w4a4": ([], []), "bf16": ([], [])}

        def checked(tree_errs):
            def attention(c, i, q, bias, *a, **k):
                o = real(c, i, q, bias, *a, **k).float()
                for out_errs, b in zip(tree_errs, (bias, decode_bias(
                        c.pos[i], q.shape[0], MISTRAL_LEN, None))):
                    ref = _einsum_decode_attention(c, i, q, b).float()
                    out_errs.append(float((o - ref).abs().max() / ref.abs().max()))
                return o.to(q.dtype)
            return attention

        def step_logits(tree, attention=None, window=True):
            for f, t in pristine.items():
                getattr(cache, f).copy_(t)
            step_cfg = cfg if window else dataclasses.replace(cfg, sliding_window=None)
            if attention is not None:
                setattr(llama, attend, attention)
            try:
                with torch.no_grad():
                    h, _ = llama.forward_hidden(tree, tok, step_cfg, caches=cache)
                    return llama.lm_head_logits(tree, h, step_cfg).float()
            finally:
                setattr(llama, attend, real)

        w4a4 = step_logits(stacked, checked(errs["w4a4"]))
        kernel = step_logits(bf16, checked(errs["bf16"]))
        einsum = step_logits(bf16, lambda c, i, q, bias, *a, **k:
                             _einsum_decode_attention(c, i, q, bias))
        no_window = step_logits(bf16, window=False)
        for f, t in pristine.items():
            getattr(cache, f).copy_(t)
        rel = float((kernel - einsum).norm() / einsum.norm())
        rel_nw = float((no_window - kernel).norm() / kernel.norm())
        attn_err = max(max(e[0]) for e in errs.values())
        attn_nw = min(min(e[1]) for e in errs.values())
        if not (torch.isfinite(w4a4).all() and torch.isfinite(kernel).all()
                and attn_err <= MISTRAL_ATTN_TOL < attn_nw
                and rel <= MISTRAL_LOGIT_TOL < rel_nw):
            raise AssertionError(
                f"mistral_window {name}: attention {attn_err} (bound {MISTRAL_ATTN_TOL}), "
                f"{attn_nw} from the windowless one; bf16 logits {rel} against the einsum "
                f"(bound {MISTRAL_LOGIT_TOL}), without the window {rel_nw}")
        out[name] = dict(attention_max_err=attn_err, attention_tol=MISTRAL_ATTN_TOL,
                         attention_min_err_without_window=attn_nw,
                         attention_errs={k: v[0] for k, v in errs.items()},
                         attention_errs_without_window={k: v[1] for k, v in errs.items()},
                         bf16_rel_norm_vs_einsum=rel, bf16_rel_norm_without_window=rel_nw,
                         tolerance_rel_norm=MISTRAL_LOGIT_TOL,
                         bf16_top1_vs_einsum=float((kernel.argmax(-1) == einsum.argmax(-1))
                                                   .float().mean()),
                         w4a4_rel_norm_vs_bf16=float((w4a4 - kernel).norm() / kernel.norm()))
        del w4a4, kernel, einsum, no_window
        steps[name], used = aligned_decoder(stacked, cache, cfg, dev,
                                            f"mistral {name} decode step",
                                            step_launches(cfg, MISTRAL_BATCH, attn))
        launches.update(used)
        out[name]["cache"] = cache
    dec = decode_windows(steps, batch=MISTRAL_BATCH)
    for name, res in out.items():
        cache = res.pop("cache")
        emit({"phase": "mistral_window", "card": card, "pool": name, "batch": MISTRAL_BATCH,
              "cache": MISTRAL_LEN, "window": cfg.sliding_window,
              "positions": [MISTRAL_POS, int(cache.pos.flatten()[0])], **res,
              "launches_per_step": step_launches(cfg, MISTRAL_BATCH,
                                                 "smajor" if name == "s_major" else "off"),
              **dec[name]})
    return launches


def _few_reps(fn, reps=2):
    """fn() with device_ms taking at most `reps` repetitions."""
    global _MAX_REPS
    _MAX_REPS = reps
    try:
        return fn()
    finally:
        _MAX_REPS = None


def _off_the_sums(rows, prefix):
    """Kernel rows of another model's shapes: sites prefixed (once), out of
    the kernels line's sums."""
    for r in rows:
        site = r.get("site", "all")
        r["site"] = site if site.startswith(f"{prefix}_") else f"{prefix}_{site}"
        r["in_sum"] = False
    return rows


def _emitted_off_the_sums(prefix, fn):
    """fn() with every kernel row it emits passed through _off_the_sums."""
    global emit
    real = emit
    emit = lambda obj: real(_off_the_sums([obj], prefix)[0] if "kernel" in obj else obj)
    try:
        return fn()
    finally:
        emit = real


# ---------------------------------------------------------------- I/O and the CLI

# meta-llama/Llama-2-7b-hf and facebook/opt-1.3b config.json, field for
# field but torch_dtype (the shards hold the tree's own bf16); the size
# fields are taken from the config the phase runs (the published values at
# full size, llama_hf_config / opt_hf_config check it)
LLAMA_HF_CONFIG = {
    "_name_or_path": "meta-llama/Llama-2-7b-hf", "architectures": ["LlamaForCausalLM"],
    "bos_token_id": 1, "eos_token_id": 2, "hidden_act": "silu", "hidden_size": 4096,
    "initializer_range": 0.02, "intermediate_size": 11008, "max_position_embeddings": 4096,
    "model_type": "llama", "num_attention_heads": 32, "num_hidden_layers": 32,
    "num_key_value_heads": 32, "pretraining_tp": 1, "rms_norm_eps": 1e-05,
    "rope_scaling": None, "tie_word_embeddings": False, "torch_dtype": "bfloat16",
    "transformers_version": "4.31.0.dev0", "use_cache": True, "vocab_size": 32000}
OPT_HF_CONFIG = {
    "_name_or_path": "facebook/opt-1.3b", "activation_dropout": 0.0,
    "activation_function": "relu", "architectures": ["OPTForCausalLM"],
    "attention_dropout": 0.0, "bos_token_id": 2, "do_layer_norm_before": True,
    "dropout": 0.1, "eos_token_id": 2, "ffn_dim": 8192, "hidden_size": 2048,
    "init_std": 0.02, "layerdrop": 0.0, "max_position_embeddings": 2048,
    "model_type": "opt", "num_attention_heads": 32, "num_hidden_layers": 24,
    "pad_token_id": 1, "prefix": "</s>", "torch_dtype": "bfloat16",
    "transformers_version": "4.21.0.dev0", "use_cache": True, "vocab_size": 50272,
    "word_embed_proj_dim": 2048}
# the host pack at Llama-2-7B width: HOST_PACK_LAYERS of the 32 layers and
# the lm_head (the cut: the host library packs ~1.2 s a layer on the
# card's 8 host cores, ~40 s for all 32)
HOST_PACK_LAYERS = 4
# cli_llama_ppl: ppl_eval on the HF directory, W4A4 g64 with 5 % salient
# channels calibrated on 4 sequences of 512, one window of 2048
LLAMA_PPL = dict(group_size=64, salient_prop=0.05, calib_samples=4, calib_seq_len=512,
                 window=2048)
# cli_opt: ppl_eval --smooth --quantize over one window of OPT_IO_WINDOW,
# and the run_experiments sweep (group sizes 64 and 128 × 0 and 5 % salient
# channels, one window, calibration on the export's sequences)
OPT_IO_WINDOW = 2048
OPT_SWEEP = (("64", "128"), ("0", "0.05"))


def _hf_config(base, cfg, fields):
    out = dict(base)
    out.update({hf: getattr(cfg, ours) for hf, ours in fields})
    return out


def llama_hf_config(cfg) -> dict:
    return _hf_config(LLAMA_HF_CONFIG, cfg, [(k, k) for k in (
        "hidden_size", "intermediate_size", "max_position_embeddings", "num_attention_heads",
        "num_hidden_layers", "num_key_value_heads", "rms_norm_eps", "vocab_size")])


def opt_hf_config(cfg) -> dict:
    return _hf_config(OPT_HF_CONFIG, cfg, [(k, k) for k in (
        "ffn_dim", "hidden_size", "max_position_embeddings", "num_attention_heads",
        "num_hidden_layers", "vocab_size")] + [("word_embed_proj_dim", "embed_dim")])


def hf_state_dict(arch, params, cfg) -> dict:
    """The port's fp tree under the HF module names its family's
    params_from_hf_state_dict reads (the tensors themselves, not copies)."""
    out = {}

    def put(prefix, node):
        for k, v in node.items():
            if v is not None:
                out[f"{prefix}.{k}"] = v

    layers = params["layers"]
    if arch == "llama":
        put("model.embed_tokens", params["embed_tokens"])
        for i in range(cfg.num_hidden_layers):
            lp, p = layers[str(i)], f"model.layers.{i}"
            for n in ("input_layernorm", "post_attention_layernorm"):
                put(f"{p}.{n}", lp[n])
            for blk in ("self_attn", "mlp"):
                for n, lin in lp[blk].items():
                    put(f"{p}.{blk}.{n}", lin)
        put("model.norm", params["norm"])
        if "lm_head" in params:
            put("lm_head", params["lm_head"])
    elif arch == "opt":
        d = "model.decoder"
        for n in ("embed_tokens", "embed_positions", "final_layer_norm", "project_in",
                  "project_out"):
            if n in params:
                put(f"{d}.{n}", params[n])
        for i in range(cfg.num_hidden_layers):
            lp, p = layers[str(i)], f"{d}.layers.{i}"
            for n in ("self_attn_layer_norm", "final_layer_norm", "fc1", "fc2"):
                put(f"{p}.{n}", lp[n])
            for n, lin in lp["self_attn"].items():
                put(f"{p}.self_attn.{n}", lin)
    else:
        raise ValueError(f"no HF names for {arch}")
    return out


def write_hf_dir(path, arch, params, cfg, config: dict, n_shards: int = 2) -> int:
    """An HF checkpoint directory of `params`: config.json, n_shards
    safetensors shards (model-0000i-of-0000n.safetensors, the tensors in
    order, split by bytes) and model.safetensors.index.json.  Returns the
    bytes of the shards."""
    import os

    from smoothquant_tpu_torch.utils.hf_import import write_safetensors

    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    state = hf_state_dict(arch, params, cfg)
    total = sum(t.numel() * t.element_size() for t in state.values())
    shards, cur, acc = [], {}, 0
    for name, t in state.items():
        cur[name] = t
        acc += t.numel() * t.element_size()
        if acc >= total * (len(shards) + 1) / n_shards and len(shards) < n_shards - 1:
            shards.append(cur)
            cur = {}
    shards.append(cur)
    weight_map, written = {}, 0
    for i, shard in enumerate(shards):
        fname = f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
        written += write_safetensors(shard, os.path.join(path, fname), {"format": "pt"})
        weight_map.update({k: fname for k in shard})
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f)
    return written


def _assert_trees_equal(path, got, ref) -> int:
    """The same keys, and every tensor (PackedLinear fields too) of the
    same dtype, shape and bits; returns the tensors compared."""
    import dataclasses

    import torch

    from smoothquant_tpu_torch.kernels.pack import PackedLinear

    if isinstance(ref, PackedLinear):
        if not isinstance(got, PackedLinear) or got.meta != ref.meta:
            raise AssertionError(f"{path}: packed meta differs")
        return sum(_assert_trees_equal(f"{path}/{f.name}", getattr(got, f.name),
                                       getattr(ref, f.name))
                   for f in dataclasses.fields(ref) if f.name not in ("meta", "_sal_cast"))
    if isinstance(ref, dict):
        if not isinstance(got, dict) or sorted(got) != sorted(ref):
            raise AssertionError(f"{path}: keys {sorted(got) if isinstance(got, dict) else got}"
                                 f" != {sorted(ref)}")
        return sum(_assert_trees_equal(f"{path}/{k}", got[k], ref[k]) for k in ref)
    if ref is None:
        if got is not None:
            raise AssertionError(f"{path}: expected None")
        return 0
    if not (isinstance(got, torch.Tensor) and got.dtype == ref.dtype
            and got.shape == ref.shape and torch.equal(got, ref)):
        raise AssertionError(f"{path}: differs ({getattr(got, 'dtype', got)} vs {ref.dtype})")
    return 1


def _sync():
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _disk(path) -> dict:
    import shutil

    u = shutil.disk_usage(path)
    return {"disk_free_gb": u.free / 1e9, "disk_total_gb": u.total / 1e9}


def run_cli(name, argv, dev, subprocess_run=False):
    """A CLI of the port on `dev` (its --device), in this process through
    main(argv) with its standard output captured, or as `python -m
    smoothquant_tpu_torch.cli.<name>` in a child process from this
    checkout: (wall seconds, its output lines, the last line's JSON or
    None)."""
    import contextlib
    import importlib
    import io
    import os

    argv = [*argv, "--device", dev.type]
    t0 = time.perf_counter()
    if subprocess_run:
        out = subprocess.run([sys.executable, "-m", f"smoothquant_tpu_torch.cli.{name}", *argv],
                             cwd=os.path.dirname(os.path.abspath(__file__)), check=True,
                             capture_output=True, text=True, timeout=600).stdout
    else:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            importlib.import_module(f"smoothquant_tpu_torch.cli.{name}").main(argv)
        _sync()
        out = buf.getvalue()
    lines = out.strip().splitlines()
    last = json.loads(lines[-1]) if lines and lines[-1].startswith("{") else None
    return time.perf_counter() - t0, lines, last


def hf_import_phase(fp, cfg, dev, card, root):
    """The fp Llama tree as an HF directory (config.json of Llama-2-7b-hf,
    two safetensors shards under HF names, bf16 as drawn) and back through
    load_model: the tree bit for bit.  Returns the directory."""
    import os

    import torch

    from smoothquant_tpu_torch.utils.hf_import import load_model

    path = os.path.join(root, "Llama-2-7b-hf")
    disk = _disk(root)
    _sync()
    t0 = time.perf_counter()
    nbytes = write_hf_dir(path, "llama", fp, cfg, llama_hf_config(cfg))
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    arch, got_cfg, got = load_model(path, device=dev)
    _sync()
    load_s = time.perf_counter() - t0
    if arch != "llama" or got_cfg != cfg:
        raise AssertionError(f"hf_import: read back {arch} {got_cfg}, not {cfg}")
    n = _assert_trees_equal("hf_import", got, fp)
    del got
    torch.cuda.empty_cache()
    emit({"phase": "hf_import", "card": card, "model": "Llama-2-7b-hf", "layers":
          cfg.num_hidden_layers, "published_config": cfg == type(cfg).llama2_7b(),
          "tensors": n, "shards": 2, "bytes": nbytes, "write_s": write_s, "load_s": load_s,
          "load_gb_per_s": nbytes / load_s / 1e9, "write_gb_per_s": nbytes / write_s / 1e9,
          "read_warm": True, **disk})
    return path


def cli_llama_ppl(fp, cfg, dev, card, model_dir, root):
    """ppl_eval on the Llama HF directory (W4A4 g64, 5 % salient,
    calibration on 4 × 512, one window of 2048): its perplexity equals the
    same calls in this process on the fp tree (get_calib_feat,
    quantize_model, Evaluator) bit for bit."""
    import functools
    import os

    import numpy as np

    from smoothquant_tpu_torch.cli.common import calib_batches, forward_fn
    from smoothquant_tpu_torch.eval import Evaluator
    from smoothquant_tpu_torch.models.registry import quantize_model
    from smoothquant_tpu_torch.quant import QuantConfig
    from smoothquant_tpu_torch.quant.calibrate import get_calib_feat

    a = LLAMA_PPL
    tokens = np.random.default_rng(SEED + 61).integers(
        0, cfg.vocab_size, size=(max(a["window"], a["calib_samples"] * a["calib_seq_len"]),))
    tok_path = os.path.join(root, "llama_tokens.npy")
    np.save(tok_path, tokens.astype(np.int32))
    args = ["--quantize", "--weight_quant", "per_group", "--act_quant", "per_group",
            "--group_size", str(a["group_size"]), "--salient_prop", str(a["salient_prop"]),
            "--calib_samples", str(a["calib_samples"]), "--calib_seq_len",
            str(a["calib_seq_len"]), "--n_samples", "1", "--window", str(a["window"])]
    seconds, _, out = run_cli("ppl_eval", ["--model_path", model_dir, "--tokens_path",
                                           tok_path, "--json", *args], dev)
    t0 = time.perf_counter()
    qcfg = QuantConfig(weight_quant="per_group", act_quant="per_group", quantize_bmm_input=False,
                       salient_prop=a["salient_prop"], quant_bits=4, group_size=a["group_size"])
    _, tapped = forward_fn("llama", cfg)
    feat = get_calib_feat(tapped, fp, calib_batches(tokens.astype(np.int32), a["calib_samples"],
                                                    a["calib_seq_len"], dev))
    tree = quantize_model("llama", fp, cfg, qcfg, input_feat=feat)
    logits_fn, _ = forward_fn("llama", cfg, quant=qcfg)
    ppl = Evaluator(tokens, n_samples=1, window=a["window"], device=dev).evaluate(
        functools.partial(logits_fn, tree))
    in_process_s = time.perf_counter() - t0
    del tree
    if not (np.isfinite(ppl) and out["ppl"] == ppl):
        raise AssertionError(f"cli_llama_ppl: the CLI's perplexity {out['ppl']} != "
                             f"in-process {ppl}")
    emit({"phase": "cli_llama_ppl", "card": card, "cli_s": seconds, "in_process_s": in_process_s,
          "args": args, "ppl": ppl, "bit_equal": True, "cli_json": out})


def host_pack_phase(fp, cfg, dev, card):
    """pack_model(..., host_pack=True) with the serving recipe on the first
    HOST_PACK_LAYERS layers of the fp 7B and its lm_head, against the
    device pack of the same tree: bit for bit, leaf by leaf; the seconds of
    each."""
    import dataclasses

    import torch

    from smoothquant_tpu_torch.models.registry import pack_model
    from smoothquant_tpu_torch.utils import native

    n = min(HOST_PACK_LAYERS, cfg.num_hidden_layers)
    cut = dataclasses.replace(cfg, num_hidden_layers=n)
    tree = {**fp, "layers": {str(i): fp["layers"][str(i)] for i in range(n)}}
    qcfg, head, feat = _recipe(cut, SEED, 64)
    kw = dict(input_feat=feat, nibble=True, lm_head_qcfg=head, align_k_groups=8,
              align_o=2048, fuse=True, fold_perms=True, shared_residual_basis=True,
              identity_keys=("o_proj",))
    t0 = time.perf_counter()
    native.lib()
    build_s = time.perf_counter() - t0
    out = {}
    for name, host in (("device", False), ("host", True), ("device", False)):
        _sync()
        t0 = time.perf_counter()
        packed = pack_model("llama", tree, cut, qcfg, host_pack=host, **kw)
        _sync()
        out[f"{name}_s"] = time.perf_counter() - t0       # the device pack's second run
        out[name] = packed
    leaves = _assert_trees_equal("host_pack", out.pop("host"), out.pop("device"))
    torch.cuda.empty_cache()
    emit({"phase": "host_pack", "card": card, "layers": n, "of_layers": cfg.num_hidden_layers,
          "lm_head": True, "tensors_bit_equal": leaves, "build_s": build_s,
          "threads": torch.get_num_threads(), **out,
          "cut": f"{n} of {cfg.num_hidden_layers} layers and the lm_head"})


def packed_checkpoint(packed, stacked, cfg, dev, card, root):
    """save_packed_model / load_packed_model of the serving pack's stacked
    decode tree and its per-layer prefill tree, then SERVE_REQUESTS
    requests through ContinuousBatcher(MAX_BATCH slots, S-major int8 pool,
    cache MAX_LEN) on the loaded trees: tokens identical to the trees in
    memory, the same launches (K1, K2, K3 and K4 a step, K6 in each
    prefill); a decode step timed on both by utils.benchtools.time_steps.
    Returns the launches of the loaded trees' run."""
    import os

    import torch

    from smoothquant_tpu_torch.kernels.real_linear import PREFILL_KERNEL_MIN_TOKENS
    from smoothquant_tpu_torch.models import llama
    from smoothquant_tpu_torch.utils.benchtools import time_steps
    from smoothquant_tpu_torch.utils.checkpoint import load_packed_model, save_packed_model

    n_l = cfg.num_hidden_layers
    files, sizes, save_s, load_s, loaded = {}, {}, {}, {}, {}
    for name, tree in (("stacked", stacked), ("per_layer", packed)):
        files[name] = os.path.join(root, f"{name}.npz")
        _sync()
        t0 = time.perf_counter()
        save_packed_model(tree, files[name])
        save_s[name] = time.perf_counter() - t0
        sizes[name] = os.path.getsize(files[name])
        t0 = time.perf_counter()
        loaded[name] = load_packed_model(files[name], device=dev)
        _sync()
        load_s[name] = time.perf_counter() - t0
        os.remove(files[name])
        _assert_trees_equal(f"packed_checkpoint {name}", loaded[name], tree)
    prompts = serve_prompts(cfg, SERVE_REQUESTS, SEED + 79)
    runs = {}
    for name, (st, pl) in (("memory", (stacked, packed)),
                           ("loaded", (loaded["stacked"], loaded["per_layer"]))):
        runs[name] = serve_batch(llama, st, cfg, dev, prompts, quant_kv=True, smajor=True,
                                 prefill_params=pl)
    (toks, used, m), (ref_toks, ref_used, ref_m) = runs["loaded"], runs["memory"]
    per_step = step_launches(cfg, MAX_BATCH, "smajor")
    expect = {k: v * m["decode_steps"] for k, v in per_step.items()}
    expect["int4_group_matmul"] = 4 * n_l * len(m["prefill_rows"])
    expect["int8_prefill_matmul"] = (expect.get("int8_prefill_matmul", 0) + sum(
        s >= PREFILL_KERNEL_MIN_TOKENS for s in m["prefill_seqs"]))
    _check_launches("packed_checkpoint memory", ref_used, expect)
    _check_launches("packed_checkpoint loaded", used, expect)
    if toks != ref_toks:
        raise AssertionError("packed_checkpoint: the loaded trees' tokens differ from the "
                             "trees' in memory")

    def decode_s(tree):
        cache = llama.stacked_caches(cfg, MAX_BATCH, MAX_LEN, pos=DECODE_POS, quant_kv=True,
                                     smajor=True, device=dev)
        tok = torch.randint(0, cfg.vocab_size, (MAX_BATCH, 1), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(SEED + 83))
        with torch.no_grad():
            return time_steps(lambda t, c: llama.forward(tree, t, cfg, caches=c), (tok, cache),
                              iters=8, baseline_iters=2, repeats=3, stateful=True)

    ms = {name: 1e3 * decode_s(st) for name, st in (("memory", stacked),
                                                    ("loaded", loaded["stacked"]))}
    del loaded
    torch.cuda.empty_cache()
    emit({"phase": "packed_checkpoint", "card": card, "file_bytes": sizes, "save_s": save_s,
          "load_s": load_s, "load_gb_per_s": {k: sizes[k] / load_s[k] / 1e9 for k in sizes},
          "read_warm": True, "requests": len(prompts), "decode_steps": m["decode_steps"],
          "prefill_rows": m["prefill_rows"],
          "tokens_identical": True, "launches_per_step": per_step, "launches": used,
          "serve_wall_s": {"memory": ref_m["wall_s"], "loaded": m["wall_s"]},
          "decode_ms_per_step_time_steps": ms})
    return used


def cli_opt(int8, ref_tokens, cfg, dev, card):
    """The four CLIs on OPT-1.3B: the weights export_opt draws written as an
    HF directory (config.json of facebook/opt-1.3b) beside the export's
    random token stream; generate_act_scales (as `python -m`, a child
    process) → export_int8_model --act_scales_path --dtype bfloat16 →
    load_int8_opt: the int8 model bit for bit export_opt's; the Generator
    over it (OPT_BATCH prompts of OPT_PROMPT, OPT_NEW new, caches of
    OPT_MAX_LEN) gives opt_generator's tokens with its launches; then
    ppl_eval --smooth --quantize over one window and run_experiments over a
    2 × 2 sweep (the weights in the tree's dtype throughout).  Returns the
    Generator's launches."""
    import dataclasses
    import os
    import shutil
    import tempfile
    from collections import Counter

    import numpy as np
    import torch

    from smoothquant_tpu_torch.models import opt, opt_int8
    from smoothquant_tpu_torch.models.common import ForwardContext
    from smoothquant_tpu_torch.quant import calibrate as cal
    from smoothquant_tpu_torch.serve.generate import GenerationConfig, Generator
    from smoothquant_tpu_torch.utils.checkpoint import load_int8_opt
    from smoothquant_tpu_torch.utils.hf_import import load_act_scales

    root = tempfile.mkdtemp(prefix="chip_smoke_opt_")
    try:
        fp = opt.init_params(torch.Generator(device=dev).manual_seed(SEED), cfg, dev)
        stream = np.random.default_rng(SEED + 21).integers(0, cfg.vocab_size,
                                                           size=CALIB_SAMPLES * CALIB_LEN)
        model_dir, tok_path = os.path.join(root, "opt-1.3b"), os.path.join(root, "tokens.npy")
        np.save(tok_path, stream.astype(np.int32))
        _sync()
        t0 = time.perf_counter()
        nbytes = write_hf_dir(model_dir, "opt", fp, cfg, opt_hf_config(cfg))
        write_s = time.perf_counter() - t0
        src = ["--model_path", model_dir, "--tokens_path", tok_path]
        calib = ["--num_samples", str(CALIB_SAMPLES), "--seq_len", str(CALIB_LEN),
                 "--dtype", cfg.dtype]
        scales_path, int8_path = os.path.join(root, "act_scales.npz"), os.path.join(root,
                                                                                    "int8.npz")
        clis = {}
        clis["generate_act_scales"] = run_cli("generate_act_scales", src + calib + [
            "--output_path", scales_path], dev, subprocess_run=True)
        batches = [torch.as_tensor(b.astype(np.int64), device=dev)
                   for b in cal.make_calib_batches(stream, CALIB_SAMPLES, CALIB_LEN)]

        def fwd(p, ids, col):
            opt.forward(p, ids, cfg, ctx=ForwardContext(taps=col))

        ref_scales = cal.get_act_scales(fwd, fp, batches)
        got_scales = load_act_scales(scales_path)
        if sorted(got_scales) != sorted(ref_scales) or not all(
                np.array_equal(got_scales[k], ref_scales[k]) for k in ref_scales):
            raise AssertionError("cli_opt: generate_act_scales' scales differ from "
                                 "get_act_scales in this process")
        del fp
        clis["export_int8_model"] = run_cli("export_int8_model", src + calib + [
            "--act_scales_path", scales_path, "--output_path", int8_path], dev)
        t0 = time.perf_counter()
        got_cfg, got = load_int8_opt(int8_path, device=dev)
        _sync()
        load_s = time.perf_counter() - t0
        if dataclasses.replace(got_cfg, dtype=cfg.dtype) != cfg:
            raise AssertionError(f"cli_opt: exported config {got_cfg} != {cfg}")
        _assert_int8_equal(got, int8)
        g = Generator(opt_int8, got, cfg, kv_dtype=torch.int8, max_len=OPT_MAX_LEN, device=dev)
        prompts = np.random.default_rng(SEED + 19).integers(0, cfg.vocab_size,
                                                            size=(OPT_BATCH, OPT_PROMPT))
        out, launches = _path_launches(
            lambda: g.generate(prompts, GenerationConfig(max_new_tokens=OPT_NEW)))
        expect = Counter(_opt_per_forward(cfg, OPT_PROMPT, OPT_MAX_LEN))
        for k, v in _opt_per_forward(cfg, 1, OPT_MAX_LEN).items():
            expect[k] += v * (OPT_NEW - 1)
        _check_launches("cli_opt generator", launches, dict(expect))
        if not np.array_equal(np.asarray(out), np.asarray(ref_tokens)):
            raise AssertionError("cli_opt: the Generator over the exported file gives other "
                                 "tokens than over export_opt's model")
        del g, got
        torch.cuda.empty_cache()
        window = ["--n_samples", "1", "--window", str(OPT_IO_WINDOW), "--dtype", cfg.dtype]
        clis["ppl_eval"] = run_cli("ppl_eval", src + window + [
            "--smooth", "--act_scales_path", scales_path, "--quantize", "--json"], dev)
        sweep_dir = os.path.join(root, "sweep")
        clis["run_experiments"] = run_cli("run_experiments", src + window + [
            "--group_sizes", *OPT_SWEEP[0], "--salient_props", *OPT_SWEEP[1],
            "--calib_samples", str(CALIB_SAMPLES), "--calib_seq_len", str(CALIB_LEN),
            "--output_dir", sweep_dir], dev)
        with open(os.path.join(sweep_dir, "results.json")) as f:
            results = json.load(f)
        cells = len(OPT_SWEEP[0]) * len(OPT_SWEEP[1])
        if len(results["results"]) != cells or not all(np.isfinite(r["ppl"])
                                                       for r in results["results"]):
            raise AssertionError(f"cli_opt: run_experiments rows {results}")
        if not np.isfinite(clis["ppl_eval"][2]["ppl"]):
            raise AssertionError("cli_opt: ppl_eval's perplexity is not finite")
        emit({"phase": "cli_opt", "card": card, "model": "facebook/opt-1.3b",
              "hf_dir_bytes": nbytes, "write_s": write_s, "load_int8_s": load_s,
              "int8_bit_equal": True, "generator_tokens_identical": True,
              "launches": launches, "cli_s": {k: v[0] for k, v in clis.items()},
              "cli_out": {k: v[1][-1] for k, v in clis.items() if v[2] is None},
              "cli_json": {k: v[2] for k, v in clis.items() if v[2] is not None},
              "results": results["results"]})
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _assert_int8_equal(got, ref):
    """An int8 OPT tree bit for bit another: every layer's int8 weights,
    biases, α and static scales, its norms, and the fp entries."""
    import torch

    if len(got["int8_layers"]) != len(ref["int8_layers"]):
        raise AssertionError("cli_opt: layer count differs")
    for i, (a, b) in enumerate(zip(got["int8_layers"], ref["int8_layers"])):
        if a.scales != b.scales:
            raise AssertionError(f"cli_opt: layer {i} static scales differ")
        for f in ("ln_attn_gamma", "ln_attn_beta", "ln_fc_gamma", "ln_fc_beta"):
            if not torch.equal(getattr(a, f), getattr(b, f)):
                raise AssertionError(f"cli_opt: layer {i} {f} differs")
        for p in ("q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2"):
            la, lb = getattr(a, p), getattr(b, p)
            if not (torch.equal(la.w_q, lb.w_q) and torch.equal(la.bias, lb.bias)
                    and la.alpha == lb.alpha):
                raise AssertionError(f"cli_opt: layer {i} {p} differs")
    _assert_trees_equal("cli_opt", {k: v for k, v in got.items() if k != "int8_layers"},
                        {k: v for k, v in ref.items() if k != "int8_layers"})


def run_io(fp, packed, stacked, cfg, dev, card):
    """The Llama I/O phases: hf_import, cli_llama_ppl on its directory,
    host_pack, packed_checkpoint; every file under one temporary directory,
    removed at the end.  Returns the launches of packed_checkpoint's run."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="chip_smoke_io_")
    try:
        model_dir = hf_import_phase(fp, cfg, dev, card, root)
        cli_llama_ppl(fp, cfg, dev, card, model_dir, root)
        shutil.rmtree(model_dir)
        host_pack_phase(fp, cfg, dev, card)
        return packed_checkpoint(packed, stacked, cfg, dev, card, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------- Falcon, Mixtral, OPT stacked

# Falcon-7B (tiiuae/falcon-7b config.json: hidden 4544, 71 heads of 64 over
# one kv head, 32 layers, vocab 65024, parallel attention, tied
# embeddings) and Mixtral-8x7B (mistralai/Mixtral-8x7B-v0.1: hidden 4096,
# 32 heads over 8 kv heads, 8 experts of 14336, top-2, vocab 32000) at full
# width, random bf16 weights from SEED; the cuts: SERVE_LAYERS of Falcon's
# 32 layers and MIXTRAL_LAYERS of Mixtral's 32 (its bf16 weights ~12 GB),
# calibration on FAMILY_SAMPLES random sequences of FAMILY_CALIB_LEN tokens
FAMILY_SAMPLES, FAMILY_CALIB_LEN, FAMILY_ALPHA = 4, 512, 0.5
FAMILY_PACK = dict(nibble=True, align_k_groups=8, align_o=256)   # the stacked decode's layout
FAMILY_PROMPT, FAMILY_NEW, FAMILY_MAX_LEN = 512, 32, 640
MIXTRAL_LAYERS, MIXTRAL_NEW = 4, 8
FAMILY_SERVE_REQUESTS, FAMILY_SERVE_NEW = 4, 16
# OPT-1.3B's stacked decode: calibration for the serving pack, the per-layer
# Generator's prompts (K11 at sm_scale 1.0 each step)
OPT_STACKED_SAMPLES, OPT_GEN_PROMPT, OPT_GEN_NEW = 2, 128, 8
# the stacked step against the per-layer step from the same cache, the whole
# model and each layer alone: held in f32 on a small twin of each family
# (2 layers, heads of 64) to the JAX package's own bound for these stacked
# decodes (tests/test_prefetch_scan_archs.py, _mixtral.py,
# test_opt_prefetch.py); at full width in bf16 reported only — K1 beside K6
# sums in another order and K10 rotates k in f32 where the per-layer path
# rounds it to bf16 first (as in JAX), so int4 activation codes at rounding
# edges move, and each W4A4 linear multiplies the difference (a 0.05 %
# difference of o_proj's input reads 1.3 % at its output and ~13 % after
# Mixtral's experts, on the CPU's plain versions too)
STACKED_VS_PER_LAYER_TOL = 2e-4


def _timed(seconds, name, fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = fn()
    torch.cuda.synchronize()
    seconds[name] = time.perf_counter() - t0
    return r


def build_family(arch, mod, cfg, dev, seed):
    """A family's serving model on `dev`: random bf16 weights (seed), the
    calibration taps on FAMILY_SAMPLES random sequences of FAMILY_CALIB_LEN
    tokens, smooth_lm(arch, α = FAMILY_ALPHA) and pack_model(arch, W4A4 g64,
    5 % salient, nibble, k groups aligned to 8, O to 256); the fp tree
    freed.  Returns (per-layer packed tree, seconds of each step)."""
    import numpy as np
    import torch

    from smoothquant_tpu_torch.models.common import ForwardContext
    from smoothquant_tpu_torch.models.registry import pack_model, smooth_lm
    from smoothquant_tpu_torch.quant.calibrate import get_act_scales, get_calib_feat

    seconds = {}
    fp = _timed(seconds, "init", lambda: mod.init_params(
        torch.Generator(device=dev).manual_seed(SEED), cfg, dev))
    rng = np.random.default_rng(seed)
    batches = [rng.integers(0, cfg.vocab_size, size=(1, FAMILY_CALIB_LEN))
               for _ in range(FAMILY_SAMPLES)]

    def fwd(p, ids, col):
        return mod.forward(p, torch.as_tensor(ids, device=dev), cfg,
                           ctx=ForwardContext(taps=col))

    scales = _timed(seconds, "act_scales", lambda: get_act_scales(fwd, fp, batches))
    feat = _timed(seconds, "calib_feat", lambda: get_calib_feat(fwd, fp, batches))
    smoothed = _timed(seconds, "smooth_lm", lambda: smooth_lm(arch, fp, cfg, scales,
                                                              alpha=FAMILY_ALPHA))
    del fp
    packed = _timed(seconds, "pack_model", lambda: pack_model(
        arch, smoothed, cfg, bloom_recipe(), input_feat=feat, act_scales=scales,
        **FAMILY_PACK))
    return packed, seconds


def _packed_bytes(node) -> int:
    """Bytes of every tensor of a tree (PackedLinear fields included)."""
    import dataclasses

    import torch

    from smoothquant_tpu_torch.kernels.pack import PackedLinear

    if isinstance(node, PackedLinear):
        return sum(_packed_bytes(getattr(node, f.name)) for f in dataclasses.fields(node)
                   if f.name != "meta")
    if isinstance(node, dict):
        return sum(_packed_bytes(v) for v in node.values())
    return node.numel() * node.element_size() if isinstance(node, torch.Tensor) else 0


def tree_step_bytes(stacked, cache, unembed_bytes: int) -> dict:
    """The bytes a stacked decode step must stream, from the tree and cache
    as stored: every layer tensor of the stack (padded packs as padded;
    every expert's, which dense and sparse dispatch both run), the whole
    int8 cache with its scales, and the unembedding's matrix."""
    from smoothquant_tpu_torch.utils import roofline

    layers = _packed_bytes(stacked["layers"]["stacked"])
    kv = sum(t.numel() * t.element_size()
             for t in (cache.k_q, cache.v_q, cache.k_scale, cache.v_scale))
    total = layers + kv + unembed_bytes
    return {"layers": layers, "kv": kv, "unembed": unembed_bytes, "total": total,
            "bound_ms": roofline.bound_ms(total, {})[0]}


def family_step_launches(cfg, batch, n_lin):
    """Kernel launches of one stacked decode step of a Falcon, Mixtral or
    OPT tree at `batch` rows: its n_lin linears a layer (the input gathered,
    no fused norm) on K1 up to K1_MAX_TOKENS rows, above on K7a's row body +
    K5 (Mixtral's sparse buffers take the rule at their capacity's rows);
    K10 (rotary off for OPT; over the int8 cache q rotated in the same
    launch for the rotary families) and K11 a layer."""
    from smoothquant_tpu_torch.kernels.real_linear import K1_MAX_TOKENS

    n_l = cfg.num_hidden_layers
    if batch <= K1_MAX_TOKENS:
        out = {"int4_group_matmul_stacked_rawx": n_lin * n_l}
    else:
        out = {"quantize_acts_grouped_t": n_lin * n_l, "int4_group_matmul_stacked": n_lin * n_l}
    out.update(write_quant_cache_stacked=n_l, decode_attention_stacked=n_l)
    return out


def family_decoder(mod, tree, cache, cfg, dev, path: str, expect_per_step: dict, ctx=None):
    """A stacked decode step of the cache's B rows (greedy, its own tokens fed
    back) of a family module (Bloom, Falcon, Mixtral, OPT): warmed up, its
    launches checked; returns (step(n), the launches of one step)."""
    import torch

    b = cache.k_q.shape[1]
    tok = torch.randint(0, cfg.vocab_size, (b, 1), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(SEED + 5))

    @torch.no_grad()
    def step(n=1):
        nonlocal tok
        for _ in range(n):
            logits, _ = mod.forward(tree, tok, cfg, ctx=ctx, caches=cache)
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        if not (0 <= int(tok.min()) and int(tok.max()) < cfg.vocab_size):
            raise AssertionError(f"{path}: token out of range")

    step(2)                                        # warm-up
    _, launches = _path_launches(step)
    _check_launches(path, launches, expect_per_step)
    return step, launches


def family_stacked_decode(name, mod, stacked, cfg, dev, card, batch, n_lin, unembed_bytes,
                          ctx=None, tag=""):
    """stack_layers' tree over a stacked head-major int8 cache of MAX_LEN
    positions from DECODE_POS at `batch` rows: three windows of 8 steps,
    ms/step by host clock and device busy time, launches per step (checked),
    the step's byte bound.  Returns the launches of the counted step."""
    import torch

    cache = mod.stacked_caches(cfg, batch, MAX_LEN, pos=DECODE_POS, quant_kv=True, device=dev)
    step, used = family_decoder(mod, stacked, cache, cfg, dev, f"{name}{tag} decode B={batch}",
                                family_step_launches(cfg, batch, n_lin), ctx)
    dec = decode_windows({"step": step}, batch=batch)["step"]
    emit({"phase": f"{name}{tag}_decode_b{batch}", "card": card, "batch": batch,
          "cache": MAX_LEN, "positions": [DECODE_POS, int(cache.pos[0])],
          "launches_per_step": used,
          "launches_per_layer": {k: v / cfg.num_hidden_layers for k, v in used.items()},
          "gib_allocated": torch.cuda.memory_allocated() / 2 ** 30,
          "decode_step_bytes": tree_step_bytes(stacked, cache, unembed_bytes), **dec})
    del cache, step
    torch.cuda.empty_cache()
    return used


def stacked_vs_per_layer(mod, packed, stacked, cfg, dev, gen, batch, n_lin, ctx=None,
                         seen=None, base=None, expect=None, per_layer_base=None):
    """One decode step from DECODE_POS over a random int8 cache through the
    stacked tree (the stacked decode) and through the per-layer tree (K6,
    K11 per layer) over per-layer views of a copy of the same cache, the
    same tokens — the whole model, then each layer alone as a one-layer
    model (first_layers from that layer) over its layer of the cache:
    ([(stacked run), (per-layer run)] of the whole model, the same of each
    layer), a run being (last-position logits, what a recorder filled into
    `seen` during it).  The whole model's stacked run must launch K1 (either
    body) n_lin times a layer and K11 (either body) once: it took the
    stacked decode, not the per-layer body over the stack; given `expect`
    (one step's launches), exactly those, each body's count under its
    kernel's key (_by_kernel: an f32 twin's K1 takes its dp4a body, K3 and
    K12 their flash bodies).  `base`: the cache (default a
    random head-major int8 one from DECODE_POS); `per_layer_base`: the same
    contents in the per-layer side's layout (default `base`)."""
    import dataclasses

    import torch

    from smoothquant_tpu_torch.serve.generate import cache_kv_heads

    if base is None:
        base = _random_hm_cache(batch, cache_kv_heads(cfg), cfg.head_dim,
                                cfg.num_hidden_layers, dev, gen)
    tok = torch.randint(0, cfg.vocab_size, (batch, 1), generator=gen, device=dev)
    fields = ("k_q", "v_q", "k_scale", "v_scale")

    def copy(lo, n, src=base):
        return dataclasses.replace(src, pos=src.pos[lo:lo + n].clone(), **{
            f: getattr(src, f)[lo:lo + n].clone() for f in fields})

    def run(tree, caches, c):
        if seen is not None:
            seen.clear()
        logits = mod.forward(tree, tok, c, ctx=ctx, caches=caches)[0][:, -1].float()
        return logits, [] if seen is None else list(seen)

    def pair(lo, n):
        """([stacked run, per-layer run], the stacked run's launches)."""
        st, c = first_layers(stacked, cfg, n, lo)
        pl, _ = first_layers(packed, cfg, n, lo)
        twin, st_cache = copy(lo, n, per_layer_base or base), copy(lo, n)
        got, used = _path_launches(lambda: run(st, st_cache, c))
        return [got, run(pl, [twin.layer(i, DECODE_POS) for i in range(n)], c)], used

    with torch.no_grad():
        whole, used = pair(0, cfg.num_hidden_layers)
        n_l = cfg.num_hidden_layers
        path = f"{mod.__name__.rsplit('.', 1)[-1]} stacked against per-layer"
        if expect is not None:
            _check_launches(path, _by_kernel(used), expect)
        else:
            by_kernel = {k: sum(v for key, v in used.items() if key.startswith(k))
                         for k in ("int4_group_matmul_stacked_rawx", "decode_attention_stacked")}
            _check_launches(path, by_kernel, {"int4_group_matmul_stacked_rawx": n_lin * n_l,
                                              "decode_attention_stacked": n_l})
        parts = [pair(i, 1)[0] for i in range(cfg.num_hidden_layers)]
    del base
    torch.cuda.empty_cache()
    return whole, parts


def _logit_agreement(path, got, ref, rows=None, tol=None):
    """Relative norm error and argmax agreement of two logit sets (over
    `rows`, all by default); raises on non-finite logits or, given `tol`,
    an error above it."""
    import torch

    if rows is not None:
        got, ref = got[rows], ref[rows]
    if not (torch.isfinite(got).all() and torch.isfinite(ref).all()):
        raise AssertionError(f"{path}: non-finite logits")
    out = dict(rows=int(got.shape[0]),
               rel_norm_err=float((got - ref).norm() / ref.norm()) if got.numel() else 0.0,
               top1_agree=float((got.argmax(-1) == ref.argmax(-1)).float().mean())
               if got.numel() else None, tol=tol)
    if tol is not None and out["rel_norm_err"] > tol:
        raise AssertionError(f"{path}: stacked against per-layer logits {out}")
    return out


def stacked_vs_per_layer_phase(name, runs, card, route_k=None, tol=None, whole_tol=...,
                               **extra):
    """The emitted comparison of stacked_vs_per_layer's runs: the whole model
    and each layer's part, held to `tol` when given (else reported; the
    whole model to `whole_tol`, by default `tol`; `extra` joins the line);
    with
    route_k (Mixtral) the experts each path chose compared first and only
    the rows where every layer chose the same compared by their logits."""
    whole, parts = runs

    def agree(tag, pair, tol):
        (g, g_seen), (r, r_seen) = pair
        out = {}
        rows = None
        if route_k is not None:
            if len(g_seen) != len(r_seen) or not g_seen:
                raise AssertionError(f"{name} {tag}: {len(g_seen)} against {len(r_seen)} "
                                     "routings")
            rows, parted = mixtral_route_compare(g_seen, r_seen, route_k)
            out.update(route_parted=parted, rows_all_same=int(rows.sum()))
        return {**out, **_logit_agreement(f"{name} {tag}", g, r, rows, tol)}

    parts_out = [agree(f"layer {i}", p, tol) for i, p in enumerate(parts)]
    emit({"phase": f"{name}_stacked_vs_per_layer", "card": card, **extra,
          "whole_model": agree("whole model", whole, tol if whole_tol is ... else whole_tol),
          "layer_parts": parts_out,
          "max_layer_rel_norm_err": max(p["rel_norm_err"] for p in parts_out), "tol": tol})


def small_f32_twin(name, arch, mod, cfg, dev, card, n_lin, route_k=None, ctxs=(None,)):
    """A small f32 twin of a family (cfg: 2 layers, heads of 64) built as the
    path builds its model (build_family), its stacked step held to its
    per-layer step, whole and layer by layer, within
    STACKED_VS_PER_LAYER_TOL (in each context of `ctxs`: Mixtral's two
    dispatches)."""
    import torch

    packed, _ = build_family(arch, mod, cfg, dev, SEED + 107)
    stacked = mod.stack_layers(packed, cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED + 109)
    for ctx in ctxs:
        tag = "" if ctx is None else f"_{ctx.moe_dispatch}"
        seen, restore = (_route_recorder() if route_k is not None else ([], lambda: None))
        try:
            runs = stacked_vs_per_layer(mod, packed, stacked, cfg, dev, gen, MAX_BATCH, n_lin,
                                        ctx, seen if route_k is not None else None)
        finally:
            restore()
        stacked_vs_per_layer_phase(f"{name}{tag}_f32_small", runs, card, route_k,
                                   STACKED_VS_PER_LAYER_TOL)
    del packed, stacked
    torch.cuda.empty_cache()


def family_generator(name, mod, packed, cfg, dev, card, n_lin, prompt, new, ctx_kw=None):
    """Generator(quant_kv=True) over a family's packed per-layer tree,
    4 prompts of `prompt` random tokens and `new` new ones over per-layer
    int8 caches of FAMILY_MAX_LEN (or the smallest multiple of 128 above the
    run): prefill tokens/s (a prefill-only run), decode ms/step, launches
    checked (K6 n_lin·L at the prefill; K6 n_lin·L and K11 L a decode
    step).  Returns (metrics, launches)."""
    import numpy as np
    import torch

    from smoothquant_tpu_torch.models.common import ForwardContext
    from smoothquant_tpu_torch.serve.generate import GenerationConfig, Generator

    n_l, steps, b = cfg.num_hidden_layers, new - 1, MAX_BATCH
    max_len = max(FAMILY_MAX_LEN, -(-(prompt + new) // 128) * 128)
    prompts = np.random.default_rng(SEED + 91).integers(0, cfg.vocab_size, size=(b, prompt))
    gen = Generator(mod, packed, cfg, max_len=max_len, quant_kv=True, device=dev)
    if ctx_kw:
        gen.ctx = ForwardContext(**ctx_kw)
    gen.generate(prompts[:, :16], GenerationConfig(max_new_tokens=2))      # warm-up

    def run(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = gen.generate(prompts, GenerationConfig(max_new_tokens=n))
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    prefill_s = statistics.median(run(1)[1] for _ in range(2))
    (out, wall), launches = _path_launches(lambda: run(new))
    _check_launches(f"{name} generator", launches, {
        "int4_group_matmul": n_lin * n_l * (1 + steps), "decode_attention_stacked": n_l * steps})
    toks = out[:, prompt:]
    if not (out.shape == (b, prompt + new) and (out[:, :prompt] == prompts).all()
            and ((0 <= toks) & (toks < cfg.vocab_size)).all()):
        raise AssertionError(f"{name} generator: misshapen output or token out of range")
    emit({"phase": f"{name}_generator", "card": card, "batch": b, "prompt": prompt,
          "new_tokens": new, "max_len": max_len, "prefill_ms": 1e3 * prefill_s,
          "prefill_tokens_per_s": b * prompt / prefill_s,
          "decode_ms_per_step": 1e3 * (wall - prefill_s) / steps, "wall_s": wall,
          "launches": launches,
          "launches_per_decode_step": {"int4_group_matmul": n_lin * n_l,
                                       "decode_attention_stacked": n_l}})
    return launches


def run_falcon(dev, card: str, cfg=None):
    """Falcon-7B (FalconConfig(): 71 query heads of 64 over one kv head,
    hidden 4544, qkv 4672, MLP 18176, vocab 65024) at SERVE_LAYERS of its 32
    layers, after every Llama tree is freed: the build (calibration,
    smooth_lm, the aligned nibble pack), K11 at rep 71 against its plain
    version (bf16 and int8 caches, B = 4 and 64, S = 512, ragged), K10 with
    one kv head and 71 query heads rotated in its launch (bit for bit), K6
    at the prefill's rows, K1 (B = 4) and K7a + K5 (B = 64) at its widths,
    the Generator over per-layer int8 caches, the stacked decode at B = 4
    from DECODE_POS, the stacked step against the per-layer step, and a
    few requests through the batcher on the stacked tree (its stacked
    decode over the per-slot stacked int8 pool of one kv head: K1, K10, K11
    at rep 71; the prefill on K6) held to the stacked tree's own greedy
    decode (serve_stacked).  (A per-layer tree is no reference for it: on
    these random weights each layer's 0.2 % difference between the two
    paths spreads to ~0.2 of the logits' norm through 8 layers, far past
    the near-ties SERVE_GAP_TOL names.)  Returns (kernel rows, launches)."""
    import dataclasses
    import types
    from collections import Counter

    import torch

    from smoothquant_tpu_torch.models import falcon

    cfg = cfg or dataclasses.replace(falcon.FalconConfig.falcon_7b(),
                                     num_hidden_layers=SERVE_LAYERS)
    t0 = time.perf_counter()
    packed, seconds = build_family("falcon", falcon, cfg, dev, SEED + 93)
    emit({"phase": "falcon_model", "seconds": time.perf_counter() - t0, **seconds,
          "layers": cfg.num_hidden_layers, "hidden": cfg.hidden_size,
          "heads": cfg.num_attention_heads, "kv_heads": cfg.effective_kv_heads,
          "calibration": [FAMILY_SAMPLES, FAMILY_CALIB_LEN], "alpha": FAMILY_ALPHA,
          "gib_allocated": torch.cuda.memory_allocated() / 2 ** 30})
    gen = torch.Generator(device=dev).manual_seed(SEED + 95)
    ns = types.SimpleNamespace(num_attention_heads=cfg.num_attention_heads,
                               num_key_value_heads=cfg.effective_kv_heads,
                               head_dim=cfg.head_dim, num_hidden_layers=cfg.num_hidden_layers)
    slot_pos = torch.randint(100, MAX_LEN, (SLOT_BATCH,), generator=gen, device=dev)
    stacked = falcon.stack_layers(packed, cfg)
    rows = _off_the_sums(_emitted_off_the_sums("falcon", lambda: _few_reps(lambda: (
        check_decode_attention_hm(ns, dev, gen, main=False, site="rep71")
        + check_decode_attention_hm(ns, dev, gen, b=SLOT_BATCH, pos=slot_pos, main=False,
                                    site="rep71")
        + check_write_cache_hm(dev, gen, MAX_BATCH, cfg.effective_kv_heads, cfg.head_dim,
                               site="mqa71", n_q=cfg.num_attention_heads)
        + check_gmm(packed, cfg, dev, gen, MAX_BATCH * FAMILY_PROMPT)
        + check_rawx(stacked, dev, gen, MAX_BATCH)
        + check_act_prep(stacked, dev, gen, SLOT_BATCH, False)
        + check_gmm_stacked(stacked, dev, gen, SLOT_BATCH, main=False)))), "falcon")
    launches = Counter()
    launches.update(family_generator("falcon", falcon, packed, cfg, dev, card, 4,
                                     FAMILY_PROMPT, FAMILY_NEW))
    emb_bytes = packed["word_embeddings"]["weight"].numel() * 2
    launches.update(family_stacked_decode("falcon", falcon, stacked, cfg, dev, card, MAX_BATCH,
                                          4, emb_bytes))
    stacked_vs_per_layer_phase("falcon", stacked_vs_per_layer(
        falcon, packed, stacked, cfg, dev, gen, MAX_BATCH, 4), card)
    small_f32_twin("falcon", "falcon", falcon, falcon.FalconConfig(
        vocab_size=512, hidden_size=576, num_hidden_layers=2, num_attention_heads=9,
        dtype="float32"), dev, card, 4)
    launches.update(serve_stacked("falcon_serving", falcon, stacked, cfg, dev, card,
                                  FAMILY_SERVE_REQUESTS, FAMILY_SERVE_NEW, SEED + 97,
                                  family_step_launches(cfg, MAX_BATCH, 4)))
    del packed, stacked
    torch.cuda.empty_cache()
    return rows, launches


def _route_recorder():
    """Patch models.mixtral.top_k (the router's choice) to record each
    layer's routing probabilities (B·S, E) and experts (B·S, k) in call
    order; returns (the list it fills, a function that restores it)."""
    from smoothquant_tpu_torch.models import mixtral

    real, seen = mixtral.top_k, []

    def recording(x, k):
        vals, idx = real(x, k)
        seen.append((x.reshape(-1, x.shape[-1]), idx.reshape(-1, k)))
        return vals, idx

    mixtral.top_k = recording
    return seen, lambda: setattr(mixtral, "top_k", real)


def mixtral_route_compare(stacked_run, per_layer_run, k):
    """The experts each path chose, layer by layer and row by row: (a mask of
    the rows where every layer chose the same k experts, whose logits are
    then compared; [layer, row, gap] where the two parted, the gap the
    per-layer path's k-th routing probability less its (k+1)-th there — a
    near-tie, where the two paths' last-bit differences reorder near-equal
    probabilities)."""
    import torch

    parted, same = [], None
    for layer, ((_, gi), (pr, ri)) in enumerate(zip(stacked_run, per_layer_run)):
        agree = (gi.sort(-1).values == ri.sort(-1).values).all(-1)
        same = agree if same is None else same & agree
        top = pr.sort(-1, descending=True).values
        for r in torch.nonzero(~agree).flatten().tolist():
            parted.append([layer, r, float(top[r, k - 1] - top[r, k])])
    if len(stacked_run) != len(per_layer_run):
        raise AssertionError("mixtral: the two paths routed a different number of layers")
    return same, parted


def run_mixtral(dev, card: str, cfg=None):
    """Mixtral-8x7B (MixtralConfig(): hidden 4096, 32 heads of 128 over 8 kv
    heads, 8 experts of 14336, top-2, vocab 32000) at MIXTRAL_LAYERS of its
    32 layers, after every Llama tree is freed: the build (calibration,
    smooth_lm, the aligned nibble pack: 29 linears a layer, the router's 8
    outputs padded to 256), K6 at the Generator's prefill rows (expert 0
    standing for the experts), K1 (B = 4) and K7a + K5 (32 rows, a sparse
    expert buffer at B = 64) on its linears with the experts as the (L·E,
    ...) stacks the stacked decode indexes, K11 at rep 4, the stacked decode
    in "dense" and "sparse" dispatch at B = 4 and 64 from DECODE_POS, the
    stacked step against the per-layer step (the experts each chose, then
    the logits of the rows where they chose the same), and the Generator
    over per-layer int8 caches.  Returns (kernel rows, launches)."""
    import dataclasses
    from collections import Counter

    import torch

    from smoothquant_tpu_torch.models import mixtral
    from smoothquant_tpu_torch.models.common import ForwardContext

    cfg = cfg or dataclasses.replace(mixtral.MixtralConfig(), num_hidden_layers=MIXTRAL_LAYERS)
    n_lin = 5 + 3 * cfg.num_local_experts
    t0 = time.perf_counter()
    packed, seconds = build_family("mixtral", mixtral, cfg, dev, SEED + 99)
    emit({"phase": "mixtral_model", "seconds": time.perf_counter() - t0, **seconds,
          "layers": cfg.num_hidden_layers, "hidden": cfg.hidden_size,
          "experts": cfg.num_local_experts, "intermediate": cfg.intermediate_size,
          "linears_per_layer": n_lin, "calibration": [FAMILY_SAMPLES, FAMILY_CALIB_LEN],
          "alpha": FAMILY_ALPHA, "gib_allocated": torch.cuda.memory_allocated() / 2 ** 30})
    gen = torch.Generator(device=dev).manual_seed(SEED + 101)
    stacked = mixtral.stack_layers(packed, cfg)
    cap = mixtral.moe_capacity(SLOT_BATCH, cfg, ForwardContext().moe_capacity_factor)
    rows = _off_the_sums(_emitted_off_the_sums("mixtral", lambda: _few_reps(lambda: (
        check_decode_attention_hm(cfg, dev, gen, main=False, site="rep4")
        + check_gmm(packed, cfg, dev, gen, MAX_BATCH * FAMILY_PROMPT)
        + check_rawx(stacked, dev, gen, MAX_BATCH)
        + check_act_prep(stacked, dev, gen, cap, False)
        + check_gmm_stacked(stacked, dev, gen, cap, main=False)))), "mixtral")
    launches = Counter()
    lm_bytes = packed["lm_head"]["weight"].numel() * 2
    for dispatch in ("dense", "sparse"):
        ctx = ForwardContext(moe_dispatch=dispatch)
        for b in (MAX_BATCH, SLOT_BATCH):
            launches.update(family_stacked_decode("mixtral", mixtral, stacked, cfg, dev, card,
                                                  b, n_lin, lm_bytes, ctx, f"_{dispatch}"))
        seen, restore = _route_recorder()
        try:
            runs = stacked_vs_per_layer(mixtral, packed, stacked, cfg, dev, gen, MAX_BATCH,
                                        n_lin, ctx, seen)
        finally:
            restore()
        stacked_vs_per_layer_phase(f"mixtral_{dispatch}", runs, card, cfg.num_experts_per_tok)
    small_f32_twin("mixtral", "mixtral", mixtral, dataclasses.replace(
        cfg, vocab_size=512, hidden_size=256, intermediate_size=256, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, num_local_experts=4, dtype="float32"),
        dev, card, 5 + 3 * 4, cfg.num_experts_per_tok,
        tuple(ForwardContext(moe_dispatch=d) for d in ("dense", "sparse")))
    launches.update(family_generator("mixtral", mixtral, packed, cfg, dev, card, n_lin,
                                     FAMILY_PROMPT, MIXTRAL_NEW))
    del packed, stacked
    torch.cuda.empty_cache()
    return rows, launches


def opt_stacked(smoothed, cfg, dev, card):
    """OPT's stacked decode on the OPT path's smoothed OPT-1.3B weights, all
    24 layers: calibration statistics on OPT_STACKED_SAMPLES random
    sequences of CALIB_LEN, pack_model("opt", W4A4 g64, 5 % salient,
    nibble, fuse=True, fold_perms=True, aligned) and its stack; K11 at
    sm_scale 1.0 against its plain version (bf16 and int8 caches, B = 4);
    the stacked decode at B = 4 from DECODE_POS (per layer K1 ×4, K10
    rotary off, K11 at sm_scale 1.0); its step against the per-layer
    step's from the same cache; the per-layer Generator over int8 caches
    (K6 and K11 at sm_scale 1.0 each step, no einsum).  Returns (kernel
    rows, launches)."""
    import types
    from collections import Counter

    import numpy as np
    import torch

    from smoothquant_tpu_torch.models import opt
    from smoothquant_tpu_torch.models.common import ForwardContext
    from smoothquant_tpu_torch.models.registry import pack_model
    from smoothquant_tpu_torch.quant.calibrate import get_act_scales, get_calib_feat

    seconds = {}
    rng = np.random.default_rng(SEED + 103)
    batches = [rng.integers(0, cfg.vocab_size, size=(1, CALIB_LEN))
               for _ in range(OPT_STACKED_SAMPLES)]

    def fwd(p, ids, col):
        return opt.forward(p, torch.as_tensor(ids, device=dev), cfg,
                           ctx=ForwardContext(taps=col))

    scales = _timed(seconds, "act_scales", lambda: get_act_scales(fwd, smoothed, batches))
    feat = _timed(seconds, "calib_feat", lambda: get_calib_feat(fwd, smoothed, batches))
    packed = _timed(seconds, "pack_model", lambda: pack_model(
        "opt", smoothed, cfg, bloom_recipe(), input_feat=feat, act_scales=scales, fuse=True,
        fold_perms=True, **FAMILY_PACK))
    stacked = _timed(seconds, "stack_layers", lambda: opt.stack_layers(packed, cfg))
    emit({"phase": "opt_stacked_model", "seconds": seconds, "layers": cfg.num_hidden_layers,
          "calibration": [OPT_STACKED_SAMPLES, CALIB_LEN],
          "gib_allocated": torch.cuda.memory_allocated() / 2 ** 30})
    gen = torch.Generator(device=dev).manual_seed(SEED + 105)
    ns = types.SimpleNamespace(num_attention_heads=cfg.num_attention_heads,
                               num_key_value_heads=cfg.num_attention_heads,
                               head_dim=cfg.head_dim, num_hidden_layers=cfg.num_hidden_layers)
    rows = _off_the_sums(_emitted_off_the_sums("opt", lambda: _few_reps(
        lambda: check_decode_attention_hm(ns, dev, gen, main=False, sm_scale=1.0,
                                          site="scale1"))), "opt")
    launches = Counter()
    emb_bytes = packed["embed_tokens"]["weight"].numel() * 2
    launches.update(family_stacked_decode("opt", opt, stacked, cfg, dev, card, MAX_BATCH, 4,
                                          emb_bytes, tag="_stacked"))
    stacked_vs_per_layer_phase("opt", stacked_vs_per_layer(
        opt, packed, stacked, cfg, dev, gen, MAX_BATCH, 4), card)
    small_f32_twin("opt", "opt", opt, opt.OPTConfig(
        vocab_size=512, hidden_size=256, ffn_dim=512, num_hidden_layers=2,
        num_attention_heads=4, dtype="float32"), dev, card, 6)
    launches.update(family_generator("opt_per_layer_int8", opt, packed, cfg, dev, card, 4,
                                     OPT_GEN_PROMPT, OPT_GEN_NEW))
    del packed, stacked
    torch.cuda.empty_cache()
    return rows, launches


def run_mistral(dev, card: str, cfg=None):
    """Mistral-7B (mistral_7b(): hidden 4096, 32 heads over 8 kv heads,
    intermediate 14336, vocab 32000, window 4096; random bf16 weights from
    seed 0; the cuts: SERVE_LAYERS of its 32 layers, calibration on
    MISTRAL_SAMPLES random sequences of MISTRAL_CALIB_LEN tokens), after
    every Llama tree is freed:
    K1 (N = 4), K7 + K5 (N = 64), K14 (N = 4 and 8) and K10 (B = 4, 8 kv
    heads, q rotated) against their plain versions at its widths (out of the
    kernels line's sums), then the windowed decode.  Returns (kernel rows,
    launches)."""
    import dataclasses

    import torch

    from smoothquant_tpu_torch.models.llama import LlamaConfig
    from smoothquant_tpu_torch.utils import roofline

    cfg = cfg or dataclasses.replace(LlamaConfig.mistral_7b(), num_hidden_layers=SERVE_LAYERS)
    t0 = time.perf_counter()
    stacked, bf16, seconds = build_mistral(cfg, dev)
    torch.cuda.synchronize()
    emit({"phase": "mistral_model", "seconds": time.perf_counter() - t0, **seconds,
          "layers": cfg.num_hidden_layers, "hidden": cfg.hidden_size,
          "kv_heads": cfg.num_key_value_heads, "intermediate": cfg.intermediate_size,
          "window": cfg.sliding_window, "rope_theta": cfg.rope_theta,
          "calibration": [MISTRAL_SAMPLES, MISTRAL_CALIB_LEN],
          "gib_allocated": torch.cuda.memory_allocated() / 2 ** 30,
          "decode_step_bytes": roofline.llama_decode_step_bytes(
              cfg, batch=MISTRAL_BATCH, max_len=MISTRAL_LEN)})
    gen = torch.Generator(device=dev).manual_seed(SEED + 85)
    rows = _off_the_sums(_emitted_off_the_sums("mistral", lambda: _few_reps(lambda: (
        check_rawx(stacked, dev, gen)
        + check_gmm_stacked(stacked, dev, gen, n=SLOT_BATCH, main=False)
        + check_mlp_fused(stacked, dev, gen)
        + check_write_cache_hm(dev, gen, MISTRAL_BATCH, cfg.num_key_value_heads, cfg.head_dim,
                               site="gqa8", n_q=cfg.num_attention_heads)))), "mistral")
    launches = mistral_window(stacked, bf16, cfg, dev, card)
    return rows, launches


# the rep-16 Llama stacked decode: Llama-2-7B's width with its 32 query heads
# over 2 kv heads (rep 16, past the 8 rows a kv head K3 and K12 once took),
# REP16_LAYERS layers of the serving pack, B = MAX_BATCH from DECODE_POS; its
# small f32 twin (16 query heads of 64 over one kv head, hidden 1024), its
# S-major step held layer by layer
REP16_KV_HEADS, REP16_LAYERS = 2, 2


def rep16_twin_config():
    """The rep-16 phase's small f32 twin: rep 16 at head_dim 64 (f32
    queries: K3's and K12's flash bodies, in two groups of 8 rows).  At
    head_dim 128 the f32 roundings of K12 beside K11 moved an int4 code of
    o_proj's input on the CPU's plain versions (0.034 of the logits' norm),
    as W4A4 over random weights does at rounding edges."""
    import dataclasses

    from smoothquant_tpu_torch.models import llama

    return dataclasses.replace(llama.LlamaConfig.llama2_7b(), vocab_size=512,
                               hidden_size=1024, intermediate_size=1024,
                               num_attention_heads=16, num_key_value_heads=1,
                               num_hidden_layers=REP16_LAYERS, dtype="float32")


def llama_rep16_decode(dev, card, cfg=None, twin_cfg=None):
    """A Llama of Llama-2-7B's width at 32 query heads over REP16_KV_HEADS
    kv heads and REP16_LAYERS layers (cfg; bf16), and its small f32 twin
    (twin_cfg, rep16_twin_config), each packed as the serving pack
    (build_model): the stacked decode through Llama's gate at B = MAX_BATCH
    from DECODE_POS over a random S-major int8 cache (K2 + K3) and over the
    same codes and scales head-major, aligned, in fuse_attn "auto" (K12's
    stacked body + K10) and "fused" (K12's write body), each step's
    launches exactly step_launches' (so the gate admitted the shape and no
    kernel raised), against the same tree's per-layer step (K6, K11 over
    the head-major codes: the per-layer body's einsum over an S-major cache
    reads it dequantized to bf16, other numerics than K3's), the whole
    model and each layer alone (stacked_vs_per_layer): the twin's S-major
    layers each held to STACKED_VS_PER_LAYER_TOL, the rest reported: the
    twin's whole model, its "auto" / "fused" steps (K12 folds the new row in
    last, and that f32 reorder's last bits move int4 codes at rounding
    edges, which W4A4 spreads: on the card the twin's S-major layers read
    1-3e-7 and its two layers 3.7e-4, its "auto" layer 0 4.4e-4 in one run
    and its "fused" layer 0 0.084 in another), and the bf16 model (layers
    0.27-0.31, as the CPU's plain versions read them)."""
    import dataclasses

    import torch

    from smoothquant_tpu_torch.models import llama
    from smoothquant_tpu_torch.models.common import ForwardContext

    cfg = cfg or dataclasses.replace(llama.LlamaConfig.llama2_7b(),
                                     num_key_value_heads=REP16_KV_HEADS,
                                     num_hidden_layers=REP16_LAYERS)
    for tag, c in (("", cfg), ("_f32_small", twin_cfg or rep16_twin_config())):
        t0 = time.perf_counter()
        _, packed, stacked = build_model(c, dev, SEED + 115)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        gen = torch.Generator(device=dev).manual_seed(SEED + 117)
        n_kv, d, n_l = c.num_key_value_heads, c.head_dim, c.num_hidden_layers
        for mode in ("smajor", "auto", "fused"):
            base = _random_hm_cache(MAX_BATCH, n_kv, d, n_l, dev, gen)
            per_layer, ctx = base, None if mode == "smajor" else ForwardContext(fuse_attn=mode)
            if mode == "smajor":
                base = dataclasses.replace(
                    _random_cache(c, dev, gen, MAX_BATCH, MAX_LEN, n_l),
                    k_scale=per_layer.k_scale.clone(), v_scale=per_layer.v_scale.clone(),
                    pos=torch.full((n_l, MAX_BATCH), DECODE_POS, device=dev))
                for f in ("k_q", "v_q"):
                    t = getattr(per_layer, f)                       # (L, B, H_kv, S, D)
                    getattr(base, f).copy_(t.transpose(2, 3).reshape(getattr(base, f).shape))
            if not llama._prefetch_capable(stacked, c, ctx, base, 1):
                raise AssertionError(f"llama rep16{tag} {mode}: the stacked decode's gate "
                                     "declines")
            expect = step_launches(c, MAX_BATCH, mode)
            # the twin's layers over the S-major cache: K2 + K3 against K10 +
            # K11 is one function, held to STACKED_VS_PER_LAYER_TOL.  K12 folds
            # the new row in last, an f32 reorder whose last bits move int4
            # codes of random weights, which W4A4 spreads: JAX pins its own
            # parity test to fuse_attn "off" for it (tests/test_prefetch_scan.py:
            # 41-45), so "auto" and "fused" are reported (k12_edges holds K12
            # at rep 16 against its plain version)
            tol = STACKED_VS_PER_LAYER_TOL if tag and mode == "smajor" else None
            runs = stacked_vs_per_layer(llama, packed, stacked, c, dev, gen, MAX_BATCH, 4, ctx,
                                        base=base, expect=expect, per_layer_base=per_layer)
            stacked_vs_per_layer_phase(
                f"llama_rep16_{mode}{tag}", runs, card, tol=tol, whole_tol=None, dtype=c.dtype,
                heads=[c.num_attention_heads, n_kv, d], rep=c.num_attention_heads // n_kv,
                layers=n_l, batch=MAX_BATCH, position=DECODE_POS, build_s=build_s,
                launches_per_step=expect)
            del base, per_layer, runs
        del packed, stacked
        torch.cuda.empty_cache()


# the cluster phase: ClusterFrontend over CLUSTER_HOSTS replicas of the
# serving pack's first SERVE_LAYERS layers on the one card (MAX_BATCH slots
# each, S-major int8 pools), CLUSTER_REQUESTS prompts of SERVE_PROMPT tokens
# and CLUSTER_NEW new ones, against the same requests on one host; then the
# simulator (serve/sim.py) on skewed_trace(CLUSTER_SIM_TRACE, seed=
# CLUSTER_SIM_SEED) at CLUSTER_SIM_HOSTS hosts under the measured costs
CLUSTER_HOSTS, CLUSTER_REQUESTS, CLUSTER_NEW = 2, 12, 16
CLUSTER_SIM_TRACE, CLUSTER_SIM_SEED, CLUSTER_SIM_HOSTS = 48, 3, (2, 4)


def cluster_phase(prefill_tree, stacked, cfg, dev, card):
    """The multi-host serving tier on the card: ClusterFrontend over 1 and
    then CLUSTER_HOSTS replicas of ContinuousBatcher(stacked, prefill on
    prefill_tree, MAX_BATCH slots, S-major int8 pool), the same requests on
    each; every request's tokens identical across the two runs, each run's
    launches those of its prefills and decode steps (K1, K2, K3 and the
    int8 lm_head's K4 a step; K6 and K4 a prefill).  The replicas share the
    card and step in turn, each one's busy time kept apart: cluster
    tokens/s is total tokens over the busiest replica's busy time (what
    hosts stepping concurrently would give).  A CostModel from the 1-host
    run's measured decode-step and prefill-per-token seconds then drives
    scaling_efficiency on the skewed trace at CLUSTER_SIM_HOSTS hosts:
    simulated numbers, labeled so.  Returns the launches of both runs."""
    from collections import Counter

    import numpy as np
    import torch

    from smoothquant_tpu_torch.kernels.real_linear import PREFILL_KERNEL_MIN_TOKENS
    from smoothquant_tpu_torch.models import llama
    from smoothquant_tpu_torch.serve import (
        ClusterFrontend,
        ContinuousBatcher,
        CostModel,
        Request,
        scaling_efficiency,
        skewed_trace,
    )

    n_l = cfg.num_hidden_layers
    prompts = serve_prompts(cfg, CLUSTER_REQUESTS, SEED + 119)
    launches, runs = Counter(), {}
    for n_hosts in (1, CLUSTER_HOSTS):
        cost = {"prefill_s": 0.0, "prefill_rows": 0, "prefill_seqs": [], "decode_s": 0.0,
                "decode_steps": 0}

        def make_batcher(host_id, cost=cost):
            b = ContinuousBatcher(llama, stacked, cfg, max_batch=MAX_BATCH, max_len=MAX_LEN,
                                  quant_kv=True, smajor=True, prefill_params=prefill_tree,
                                  device=dev)
            prefill, decode = b._prefill, b._decode

            def timed_prefill(ids, lens):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r = prefill(ids, lens)          # its first tokens come back to the host
                cost["prefill_s"] += time.perf_counter() - t0
                cost["prefill_rows"] += ids.shape[0] * ids.shape[1]
                cost["prefill_seqs"].append(ids.shape[0])
                return r

            def timed_decode(*a):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r = decode(*a)
                torch.cuda.synchronize()
                cost["decode_s"] += time.perf_counter() - t0
                cost["decode_steps"] += 1
                return r

            b._prefill, b._decode = timed_prefill, timed_decode
            return b

        front = ClusterFrontend(make_batcher, n_hosts)
        reqs = [Request(uid=i, prompt=np.asarray(p), max_new_tokens=CLUSTER_NEW)
                for i, p in enumerate(prompts)]
        for r in reqs:
            front.submit(r)
        routed = [len(rep.requests) for rep in front.replicas]
        t0 = time.perf_counter()
        done, used = _path_launches(front.run_to_completion)
        wall = time.perf_counter() - t0
        if not (len(done) == len(reqs) and all(r.done and len(r.generated) == CLUSTER_NEW
                                               and all(0 <= t < cfg.vocab_size
                                                       for t in r.generated) for r in reqs)):
            raise AssertionError(f"cluster {n_hosts} hosts: unfinished request or token "
                                 "out of range")
        steps = cost["decode_steps"]
        expect = {k: v * steps for k, v in step_launches(cfg, MAX_BATCH, "smajor").items()}
        expect["int4_group_matmul"] = 4 * n_l * len(cost["prefill_seqs"])
        expect["int8_prefill_matmul"] = expect.get("int8_prefill_matmul", 0) + sum(
            n >= PREFILL_KERNEL_MIN_TOKENS for n in cost["prefill_seqs"])
        _check_launches(f"cluster {n_hosts} hosts", used, expect)
        launches.update(used)
        runs[n_hosts] = dict(front=front, reqs=reqs, cost=cost, wall=wall, routed=routed,
                             launches=used)
    one, many = runs[1], runs[CLUSTER_HOSTS]
    differ = [r1.uid for r1, r2 in zip(one["reqs"], many["reqs"]) if r1.generated != r2.generated]
    if differ:
        raise AssertionError(f"cluster: requests {differ} gave other tokens on "
                             f"{CLUSTER_HOSTS} hosts than on one")
    base = one["front"].stats()
    c = one["cost"]
    model = CostModel(decode_step_s=c["decode_s"] / c["decode_steps"],
                      prefill_s_per_token=c["prefill_s"] / c["prefill_rows"])
    emit({"phase": "cluster", "card": card, "layers": n_l, "tree": "W4A4 serving pack, stacked",
          "pool": "S-major int8", "max_batch": MAX_BATCH, "cache": MAX_LEN,
          "requests": CLUSTER_REQUESTS, "new_tokens": CLUSTER_NEW,
          "tokens_identical_to_one_host": True,
          "replicas": "one card, stepped in turn; each replica's busy time its own",
          **{f"hosts_{n}": dict(r["front"].stats(
              baseline_tokens_per_s=None if n == 1 else base["cluster_tokens_per_s"]),
              routed=r["routed"], wall_s=r["wall"], decode_steps=r["cost"]["decode_steps"],
              prefill_seqs=r["cost"]["prefill_seqs"], launches=r["launches"])
             for n, r in runs.items()},
          "cost_model": dict(decode_step_s=model.decode_step_s,
                             prefill_s_per_token=model.prefill_s_per_token,
                             prefill_base_s=model.prefill_base_s,
                             measured="the 1-host run's decode steps and prefills, host "
                                      "clock after synchronize")})
    trace = skewed_trace(CLUSTER_SIM_TRACE, seed=CLUSTER_SIM_SEED)
    sims = {}
    for n in CLUSTER_SIM_HOSTS:
        r = scaling_efficiency(trace, model, n)
        sims[f"hosts_{n}"] = dict(
            scaling_efficiency=r["scaling_efficiency"],
            routing_imbalance=r["routing_imbalance"],
            admission_occupancy=r["admission_occupancy"],
            tokens_per_s=r["n_host"]["tokens_per_s"],
            one_host_tokens_per_s=r["one_host"]["tokens_per_s"],
            makespan_s=r["n_host"]["makespan_s"])
    emit({"phase": "cluster_sim", "simulated": True, "card": card,
          "trace": f"skewed_trace({CLUSTER_SIM_TRACE}, seed={CLUSTER_SIM_SEED})",
          "cost_model_from": "the cluster phase's 1-host run", **sims})
    return launches


def run_examples(dev, card):
    """The port's three examples in this process at their tiny sizes on
    `dev` (serving_demo, opt_demo --random, cluster_demo; `--device cuda` on
    the card),
    their printed lines kept out of this script's output: every request
    finished with its tokens in range, the perplexities finite."""
    import contextlib
    import io
    import math

    from smoothquant_tpu_torch.examples import cluster_demo, opt_demo, serving_demo

    out, seconds = {}, {}
    where = ["--device", dev.type]
    for name, fn in (("serving_demo", lambda: serving_demo.main(where)),
                     ("opt_demo", lambda: opt_demo.main(["--random", *where])),
                     ("cluster_demo", lambda: cluster_demo.main(where))):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            out[name] = fn()
        seconds[name] = time.perf_counter() - t0
        seconds[f"{name}_lines"] = len(buf.getvalue().splitlines())
    served = out["serving_demo"] + out["cluster_demo"]["requests"]
    if not (len(out["serving_demo"]) == 4 and len(out["cluster_demo"]["requests"]) == 8
            and all(r.done and len(r.generated) == 6 and all(0 <= t < 256 for t in r.generated)
                    for r in served)
            and out["cluster_demo"]["stats"]["requests_done"] == 8
            and all(math.isfinite(v) and v > 1 for v in out["opt_demo"].values())):
        raise AssertionError(f"examples: unexpected results {out}")
    emit({"phase": "examples", "card": card, "seconds": seconds,
          "serving_demo_tokens": [r.generated for r in out["serving_demo"]],
          "opt_demo_ppl": out["opt_demo"],
          "cluster_demo_tokens_per_s": out["cluster_demo"]["stats"]["cluster_tokens_per_s"]})


def run(dev, cfg, card: str):
    """Every Llama phase on `dev` at the size of `cfg`; returns (kernel rows,
    the main paths' launches)."""
    from collections import Counter

    import torch

    from smoothquant_tpu_torch.kernels.int4_group_matmul import RAWX_MAX_N
    from smoothquant_tpu_torch.kernels.real_linear import (
        INT_PATH_MAX_TOKENS,
        PREFILL_KERNEL_MIN_TOKENS,
    )
    from smoothquant_tpu_torch.models import llama
    from smoothquant_tpu_torch.utils import roofline

    n_l = cfg.num_hidden_layers
    t0 = time.perf_counter()
    fp, packed, stacked = build_model(cfg, dev, SEED)
    torch.cuda.synchronize()
    emit({"phase": "model", "seconds": time.perf_counter() - t0, "layers": n_l,
          "gib_allocated": torch.cuda.memory_allocated() / 2 ** 30,
          "decode_step_bytes": roofline.llama_decode_step_bytes(cfg)})

    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    rows = (check_rawx(stacked, dev, gen) + check_gmm(packed, cfg, dev, gen)
            + check_write_cache(cfg, dev, gen) + check_decode_attention(cfg, dev, gen)
            + check_decode_attention_hm(cfg, dev, gen))
    # the rows out of the kernels line's sums time with 2 repetitions since
    # PR 21 (_few_reps): the run's 1200 s limit
    rows += _few_reps(lambda: check_decode_attention_hm(
        cfg, dev, gen, b=SLOT_BATCH, bodies=("int8",), main=False,
        pos=torch.randint(100, MAX_LEN, (SLOT_BATCH,), generator=gen, device=dev))
        + [r for n in (16, MID_BATCH) for r in check_rawx(stacked, dev, gen, n)])
    rows += check_act_prep(stacked, dev, gen)
    rows += _few_reps(lambda: check_act_prep(stacked, dev, gen, 8, False)
                      + check_act_prep(stacked, dev, gen, MID_BATCH, False))
    rows += (check_gmm_stacked(stacked, dev, gen)
             + _few_reps(lambda: check_gmm_stacked(stacked, dev, gen, n=33, main=False))
             + check_write_cache_hm(dev, gen, SLOT_BATCH, cfg.num_key_value_heads, cfg.head_dim)
             + check_fused_attn(cfg, dev, gen)
             + check_mlp_fused(stacked, dev, gen))

    emit({"phase": "no_fallback", "raised": check_no_fallback(dev),
          "salient_block_in_another_dtype": check_salient_dtype(stacked, dev, gen)})
    emit({"phase": "kernel_variants", "max_rel_err": check_kernel_variants(dev)})
    emit({"phase": "wg_edges", "max_rel_err": check_wg_edges(dev)})
    emit({"phase": "k4_edges", **check_k4_edges(dev)})
    emit({"phase": "stream_edges", **check_stream_edges(dev)})
    emit({"phase": "k13_edges", **check_k13_edges(dev)})
    emit({"phase": "k1_edges", **check_k1_edges(dev)})
    emit({"phase": "k14_edges", **check_k14_edges(dev)})
    emit({"phase": "k7_edges", **check_k7_edges(dev)})
    emit({"phase": "k7_k5_chain", "card": card, **check_k7_k5_chain(stacked, dev, gen)})
    emit({"phase": "k11_edges", **check_k11_edges(dev)})
    for name, check in (("k3_edges", check_k3_edges), ("k12_edges", check_k12_edges)):
        edges = check(dev)
        rows += edges.pop("any_rep_rows")
        emit({"phase": name, **edges})
    llama_rep16_decode(dev, card)
    emit({"phase": "kv_write_edges", **check_kv_write_edges(dev)})
    emit({"phase": "k1_vs_k5", "card": card, "rawx_max_n": RAWX_MAX_N,
          **k1_vs_k5(stacked, dev, gen)})
    emit({"phase": "k6_host_us", "card": card, "us_per_call": k6_host_us(dev)})
    emit({"phase": "reference_check", **reference_check(dev)})
    emit({"phase": "tied_and_unfused", "card": card, **tied_and_unfused(fp, packed, cfg, dev,
                                                                        card)})

    launches = Counter()
    launches.update(run_io(fp, packed, stacked, cfg, dev, card))
    metrics, used = serve(packed, stacked, cfg, dev, promoted=False)
    launches.update(used)
    emit({"phase": "serving", "card": card, **metrics, "launches": used})

    w4a4_cache = llama.stacked_caches(cfg, MAX_BATCH, MAX_LEN, pos=DECODE_POS, quant_kv=True,
                                      smajor=True, device=dev)
    w4a4_step, used = aligned_decoder(stacked, w4a4_cache, cfg, dev, "w4a4 decode step",
                                      step_launches(cfg, MAX_BATCH, "smajor"))
    launches.update(used)
    launches.update(aligned_decode(stacked, w4a4_step, cfg, dev, card))

    t0 = time.perf_counter()
    promoted = build_promoted(fp, cfg, SEED)
    torch.cuda.synchronize()
    emit({"phase": "promoted_model", "seconds": time.perf_counter() - t0,
          "gib_allocated": torch.cuda.memory_allocated() / 2 ** 30})
    rows += check_int8_prefill(promoted, cfg, dev, gen)
    emit({"phase": "prefill_kernel_crossover", "card": card,
          "prefill_kernel_min_tokens": PREFILL_KERNEL_MIN_TOKENS,
          **prefill_kernel_crossover(promoted, cfg, dev, gen)})

    pf, used = full_prefill(promoted, cfg, dev)
    launches.update(used)
    emit({"phase": "prefill", "card": card, "tree": "promoted int8", **pf, "launches": used})

    g, used = generator(packed, promoted, cfg, dev)
    launches.update(used)
    emit({"phase": "generator", "card": card, **g, "launches": used})

    metrics, used = serve(promoted, stacked, cfg, dev, promoted=True)
    launches.update(used)
    emit({"phase": "serving", "card": card, **metrics, "launches": used})
    sp_packed, sp_cfg = first_layers(packed, cfg)
    launches.update(serve_per_layer(sp_packed, first_layers(promoted, cfg)[0], sp_cfg, dev,
                                    card))
    launches.update(cluster_phase(sp_packed, first_layers(stacked, cfg)[0], sp_cfg, dev, card))
    del sp_packed

    del packed
    torch.cuda.empty_cache()
    metrics, used = serve(promoted, stacked, cfg, dev, promoted=True, batch=SLOT_BATCH,
                          smajor=False, n_requests=SLOT_REQUESTS, decode_window=True)
    launches.update(used)
    emit({"phase": "slot_serving", "card": card, **metrics, "launches": used,
          "decode_step_bytes": roofline.llama_decode_step_bytes(cfg, batch=SLOT_BATCH)})
    del promoted
    torch.cuda.empty_cache()
    launches.update(slot_decode(stacked, cfg, dev, card))

    t0 = time.perf_counter()
    qs_packed, seconds, calib = build_quickstart(fp, cfg, dev)
    torch.cuda.synchronize()
    emit({"phase": "quickstart_model", "seconds": time.perf_counter() - t0, **seconds,
          "calibration": [QS_SAMPLES, QS_LEN], "alpha": QS_ALPHA,
          "gib_allocated": torch.cuda.memory_allocated() / 2 ** 30})
    t0 = time.perf_counter()
    single = single_group_packs(fp)
    rows += (check_int_group_matmul(qs_packed, single, dev, gen)
             + check_dual_path_matmul(qs_packed, single, dev, gen))
    del single
    t1 = time.perf_counter()
    emit({"phase": "int_path_crossover", "card": card,
          "int_path_max_tokens": INT_PATH_MAX_TOKENS, "kernel_phases_seconds": t1 - t0,
          **int_path_crossover(qs_packed, dev, gen), "seconds": time.perf_counter() - t1})
    t0 = time.perf_counter()
    metrics, used = quickstart(fp, qs_packed, cfg, dev, card)
    launches.update(used)
    emit({"phase": "quickstart", "card": card, "seconds": time.perf_counter() - t0, **metrics})
    launches.update(serve_generator_compute(*first_layers(qs_packed, cfg), dev, card))
    del qs_packed
    torch.cuda.empty_cache()
    launches.update(run_sim(fp, calib, cfg, dev, card))
    del calib
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    bf16 = build_bf16(fp, cfg)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    emit({"phase": "bf16_model", "seconds": time.perf_counter() - t0,
          "gib_allocated": torch.cuda.memory_allocated() / 2 ** 30,
          "decode_step_bytes": roofline.llama_bf16_decode_step_bytes(cfg)})
    rows += check_fp_matmul(bf16, dev, gen)

    bf16_cache = llama.stacked_caches(cfg, MAX_BATCH, MAX_LEN, torch.bfloat16, pos=DECODE_POS,
                                      quant_kv=False, smajor=False, device=dev)
    bf16_step, used = aligned_decoder(
        bf16, bf16_cache, cfg, dev, "bf16 decode step",
        {"fp_matmul_stacked": 4 * n_l, "decode_attention_stacked": n_l})
    launches.update(used)
    dec = decode_windows({"w4a4": w4a4_step, "bf16": bf16_step})
    dec["w4a4"]["old_write_route"] = _old_write_profile(w4a4_step)
    for name, cache in (("w4a4", w4a4_cache), ("bf16", bf16_cache)):
        emit({"phase": f"{name}_decode", "card": card, "batch": MAX_BATCH, "cache": MAX_LEN,
              "positions": [DECODE_POS, int(cache.pos.flatten()[0])], **dec[name]})
    from smoothquant_tpu_torch.models.common import unembed

    lm = bf16["lm_head"]["weight"]
    h = torch.randn((MAX_BATCH, 1, cfg.hidden_size), generator=gen, device=dev).to(lm.dtype)
    emit({"phase": "fp_lm_head", "card": card, "shape": [MAX_BATCH, *lm.shape],
          "f32_unembed_ms": device_ms(lambda i: unembed(h, lm), 8),
          "bf16_matmul_ms": device_ms(lambda i: torch.matmul(h, lm.t()).float(), 8),
          "bf16_step_busy_ms": dec["bf16"]["busy_ms_per_step"]})
    emit({"phase": "rms_norm_rule", "card": card, **rms_norm_rule_cost(h, cfg, dev),
          "bf16_step_busy_ms": dec["bf16"]["busy_ms_per_step"]})
    w, b = dec["w4a4"], dec["bf16"]
    emit({"phase": "vs_bf16", "card": card,
          "host_clock": b["ms_per_step"] / w["ms_per_step"],
          "host_clock_windows": [bw / ww for bw, ww in zip(b["windows_ms_per_step"],
                                                           w["windows_ms_per_step"])],
          "device_busy": b["busy_ms_per_step"] / w["busy_ms_per_step"],
          "bound": (roofline.llama_bf16_decode_step_bytes(cfg)["bound_ms"]
                    / roofline.llama_decode_step_bytes(cfg)["bound_ms"])})
    sp_fp, sp_cfg = first_layers(fp, cfg)
    launches.update(serve_fp_pool(sp_fp, first_layers(bf16, cfg)[0], sp_cfg, dev, card))
    return rows, launches


def main() -> int:
    try:
        import torch
    except ImportError:
        _die("torch is not installed")
    if not torch.cuda.is_available():
        _die("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    try:
        from smoothquant_tpu_torch.kernels import _build
        from smoothquant_tpu_torch.models import llama, opt
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
    dump = sass_dump_start()          # checked after the OPT path, which it overlaps
    try:
        rows, launches = run_opt(dev, opt.OPTConfig.opt_1_3b(), card)
        emit({"phase": "sass", **sass_check(dump)})
    finally:
        dump[0].kill()
    clock = sm_clock_mhz()
    torch.cuda.empty_cache()
    more_rows, more = run(dev, llama.LlamaConfig.llama2_7b(), card)
    torch.cuda.empty_cache()
    mistral_rows, mistral = run_mistral(dev, card)
    torch.cuda.empty_cache()
    falcon_rows, falcon_launches = run_falcon(dev, card)
    torch.cuda.empty_cache()
    mixtral_rows, mixtral_launches = run_mixtral(dev, card)
    torch.cuda.empty_cache()
    bloom_rows, bloom_launches = run_bloom(dev, bloom_7b1(), card)
    torch.cuda.empty_cache()
    run_examples(dev, card)
    rows = rows + more_rows + mistral_rows + falcon_rows + mixtral_rows + bloom_rows
    emit({"phase": "scaling_floors", "card": card, "sm_clock_mhz": clock,
          "rows": add_scaling_floors(rows, clock)})
    emit(kernels_line(rows, launches + more + mistral + falcon_launches + mixtral_launches
                      + bloom_launches))
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
